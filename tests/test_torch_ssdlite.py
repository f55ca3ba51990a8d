"""SSDlite320-MobileNetV3-Large parity: the port (plain PyTorch paths on
the CPU) against the JAX package (JAX on the CPU through its plain NMS),
with the same seeded variables (``torch_det_cases.py``, kernels of
variance 1 over the fan in: He-normal ones grow this trunk's activations
to ~1e4 at C5, where ReLU6 then turns the round-off of the extra blocks'
inputs into 1e-3 of their outputs), on two 160x160 images (maps 10x10 to
1x1; at 320 px the whole-model checks take JAX's f64 run too, 25 s
longer), 5 classes (4 x 300 NMS candidates), the JAX side jitted once per
function in module fixtures.

Tolerances:
- eval-mode head outputs and the six maps: 1e-5 of the largest;
- default boxes: exactly equal;
- postprocess, on the same head outputs (JAX's): valid rows and labels
  exactly equal, scores 1e-6, boxes 1e-4 px;
- ``compute_loss`` on the same head outputs (``Matcher`` with low-quality
  matches, hard negatives): 1e-5 relative; its gradients 1e-5 of the
  largest;
- one train step of the whole model (batch statistics): losses 1e-5
  relative; every gradient together within 1e-3 of JAX's by relative
  Frobenius norm; the running statistics the step leaves within 1e-5 of
  each tensor's largest value (at least 1e-3); where JAX's own f32 result
  is not that sharp, the port's no further from JAX's f64 one than twice
  JAX's f32 result is (``torch_zoo_cases.py``'s rule). The extra blocks'
  and the last head levels' batch norms normalise 1x1 maps over two
  images, two values a channel, and the trunk's ReLU6 and hardswish have
  kinks: at 320 px and image seeds 3-9 the port's f32 gradients lay 1.2e-3
  to 6.2e-3 from JAX's f32 ones, and its statistics up to 1.4e-4, at batch
  4 and 8 alike, while both libraries' f32 results lie about as far from
  f64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.models.detection.ssdlite import SSDLite as JaxSSDLite
from vision_tpu_torch._jax_convert import jax_placements
from vision_tpu_torch.models import get_model, list_models
from vision_tpu_torch.models.detection.ssdlite import SSDLite
from vision_tpu_torch.ops.misc import BatchNorm2d
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)
from torch_det_cases import (
    check_detections,
    check_grads,
    in_x64,
    jax_grads_by_name,
    nchw,
    one_stage_step,
    port_with,
    rel,
    seeded_variables,
    tensors,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

S = 160
CLASSES = 5
GT_BOXES = np.array([
    [[5, 6, 30, 35], [15, 20, 100, 110], [75, 3, 155, 75]],
    [[3, 3, 70, 65], [25, 80, 113, 155], [0, 0, 0, 0]],
], np.float32)
GT_LABELS = np.array([[1, 2, 4], [3, 4, 0]], np.int32)
GT_VALID = np.array([[1, 1, 1], [1, 1, 0]], bool)
MAPS = [(10, 10), (5, 5), (3, 3), (2, 2), (1, 1), (1, 1)]
# the builders' settings (``ssdlite.py:310`` in the JAX package)
BUILDER = dict(score_thresh=0.001, nms_thresh=0.55, detections_per_img=300,
               topk_candidates=300)


def _gt_torch():
    return (torch.from_numpy(GT_BOXES), torch.from_numpy(GT_LABELS).long(),
            torch.from_numpy(GT_VALID))


def _gt_jax():
    return jnp.asarray(GT_BOXES), jnp.asarray(GT_LABELS), jnp.asarray(GT_VALID)


def _stats(port):
    return {f"{mn}.{bn}": b.clone() for mn, m in port.named_modules()
            if isinstance(m, BatchNorm2d)
            for bn, b in m.named_buffers(recurse=False) if "running" in bn}


@pytest.fixture(scope="module")
def pair():
    jm = JaxSSDLite(num_classes=CLASSES, **BUILDER)
    x = np.random.RandomState(3).rand(2, S, S, 3).astype(np.float32)
    variables = seeded_variables(jm, x[:1], gain=1.0)
    port = port_with(lambda: SSDLite(num_classes=CLASSES, **BUILDER), variables)
    heads, feats = jax.jit(lambda v, x: jm.apply(v, x, return_features=True))(
        variables, jnp.asarray(x))

    def loss_fn(params, stats, x):
        v = {"params": params, "batch_stats": stats}
        outs, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
        losses = jm.apply(v, *outs, *_gt_jax(),
                          method=lambda m, *a: m.compute_loss(*a))
        return sum(losses.values()), (losses, mut)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (losses, mut)), grads = grad_fn(variables["params"],
                                        variables["batch_stats"], jnp.asarray(x))

    def placed_stats(mut):
        return jax_placements(port, {**variables, **jax.tree_util.tree_map(
            np.asarray, mut)})

    @functools.lru_cache(None)
    def in_f64():
        """JAX's gradients and running statistics in f64 (run at most
        once, where the f32 ones are not sharp enough)."""
        (_, (_, mut64)), g = in_x64(grad_fn, variables["params"],
                                    variables["batch_stats"], x)
        return jax_grads_by_name(g, variables, port), placed_stats(mut64)

    return dict(jm=jm, variables=variables, port=port, x=x, heads=heads,
                feats=feats, losses={k: float(v) for k, v in losses.items()},
                grads=jax_grads_by_name(grads, variables, port),
                stats=placed_stats(mut), in_f64=in_f64)


@pytest.fixture(scope="module")
def port_out(pair):
    with torch.no_grad():
        return pair["port"](nchw(pair["x"]), return_features=True)


@pytest.fixture(scope="module")
def port_step(pair):
    """One train step (lr 0): its losses and gradients, and the running
    statistics it leaves (then the loaded ones are put back)."""
    port = pair["port"]
    before = _stats(port)
    losses, grads = one_stage_step(port, nchw(pair["x"]), *_gt_torch())
    after = _stats(port)
    with torch.no_grad():
        for n, b in port.named_buffers():
            if n in before:
                b.copy_(before[n])
    port.eval()
    return dict(losses=losses, grads=grads, before=before, after=after)


@pytest.mark.parametrize("i", [0, 1], ids=["cls_logits", "bbox_reg"])
def test_head_outputs(pair, port_out, i):
    (heads, _) = port_out
    assert rel(heads[i].numpy(), pair["heads"][i]) <= 1e-5
    assert heads[i].shape[1] == 6 * sum(h * w for h, w in MAPS)


def test_maps_and_anchors(pair, port_out):
    (heads, feats) = port_out
    assert [tuple(f.shape[-2:]) for f in feats.values()] == MAPS
    assert [f.shape[1] for f in feats.values()] == [672, 480, 512, 256, 256, 128]
    for k, f in pair["feats"].items():
        assert rel(feats[k].numpy(), np.asarray(f).transpose(0, 3, 1, 2)) <= 1e-5, k
    np.testing.assert_array_equal(heads[2].numpy(), np.asarray(pair["heads"][2]))


def test_postprocess_detections(pair):
    jm = pair["jm"]
    want = jax.jit(lambda *h: jm.apply(
        {}, *h, (S, S), method=lambda m, *a: m.postprocess_detections(*a)))(
            *pair["heads"])
    got = pair["port"].postprocess_detections(*tensors(pair["heads"]), (S, S))
    check_detections(got, want)
    assert got.boxes.shape == (2, 300, 4)


def test_compute_loss_and_its_gradient(pair):
    jm, heads = pair["jm"], pair["heads"]

    def jloss(c, r):
        out = jm.apply({}, c, r, heads[2], *_gt_jax(),
                       method=lambda m, *a: m.compute_loss(*a))
        return sum(out.values()), out

    (_, want), (gc, gr) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(*heads[:2])
    c, r = (t.requires_grad_() for t in tensors(heads[:2]))
    got = pair["port"].compute_loss(c, r, tensors(heads[2]), *_gt_torch())
    sum(got.values()).backward()
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5)
    assert rel(c.grad.numpy(), gc) <= 1e-5
    assert rel(r.grad.numpy(), gr) <= 1e-5


def test_whole_model_loss_and_gradients(pair, port_step):
    for k, want in pair["losses"].items():
        np.testing.assert_allclose(port_step["losses"][k], want, rtol=1e-5)
    check_grads(port_step["grads"], pair["grads"], lambda: pair["in_f64"]()[0])


@pytest.mark.parametrize("part", ["backbone.features.0.", "backbone.features.1.",
                                  "backbone.extra.", "head."])
def test_updated_batch_statistics(pair, port_step, part):
    """The running statistics one train step leaves, by part of the model;
    every one of them moved."""
    names = [n for n in port_step["after"] if n.startswith(part)]
    assert names

    def err(got, want):
        return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-3)

    for n in names:
        got = port_step["after"][n].numpy()
        assert not torch.equal(port_step["after"][n], port_step["before"][n]), n
        if err(got, pair["stats"][n]) <= 1e-5:
            continue
        exact = pair["in_f64"]()[1][n]
        assert err(got, exact) <= 2.0 * err(pair["stats"][n], exact), n


def test_amp_step_keeps_f32_statistics(pair):
    """The amp step: losses within 5e-2 of the f32 step's, the running
    statistics f32 and updated."""
    port = pair["port"]
    before = _stats(port)
    f32, _ = one_stage_step(port, nchw(pair["x"]), *_gt_torch())
    amp, _ = one_stage_step(port, nchw(pair["x"]), *_gt_torch(),
                            dtype=torch.bfloat16)
    after = _stats(port)
    with torch.no_grad():
        for n, b in port.named_buffers():
            if n in before:
                b.copy_(before[n])
    port.eval()
    for k in f32:
        assert abs(amp[k] - f32[k]) <= 5e-2 * abs(f32[k]), k
    assert all(b.dtype == torch.float32 for b in after.values())
    assert all(not torch.equal(after[n], before[n]) for n in after)


def test_builder_and_names():
    """torchvision's parameter count and names (the C4 block's second half
    under ``features.1.0.{1,2,3}``), eps 1e-3 and momentum 0.03."""
    assert "ssdlite320_mobilenet_v3_large" in list_models()
    model = get_model("ssdlite320_mobilenet_v3_large", device="cpu")
    assert not model.training
    assert {k: getattr(model, k) for k in BUILDER} == BUILDER
    assert sum(p.numel() for p in model.parameters()) == 3_440_060
    sd = model.state_dict()
    for name in ("backbone.features.0.13.1.running_var",
                 "backbone.features.1.0.1.0.weight",
                 "backbone.features.1.0.2.fc1.weight",
                 "backbone.features.1.0.3.1.weight",
                 "backbone.features.1.3.0.weight",
                 "backbone.extra.3.1.0.weight",
                 "head.classification_head.module_list.5.0.0.weight",
                 "head.regression_head.module_list.0.1.bias"):
        assert name in sd, name
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert norms and all(m.eps == 1e-3 and m.momentum == 0.03 for m in norms)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model("ssdlite320_mobilenet_v3_large")
    frozen = get_model("ssdlite320_mobilenet_v3_large", device="cpu",
                       trainable_backbone_layers=2)
    fixed = {n.split(".")[2] + "." + n.split(".")[3]
             for n, p in frozen.named_parameters() if not p.requires_grad}
    assert fixed == {f"0.{i}" for i in range(13)}
