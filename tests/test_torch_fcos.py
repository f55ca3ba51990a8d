"""FCOS parity: the port (``vision_tpu_torch``, plain PyTorch paths on the
CPU) against the JAX package (``vision_tpu``, JAX on the CPU through its
plain NMS), with the same seeded variables (``torch_det_cases.py``).

The model is a ResNet-18 FCOS of 5 classes on two 128x160 images, the
JAX side jitted once per function in module fixtures.

Tolerances:
- head outputs: 1e-5 of the largest (f32 sums in another order);
- anchors: exactly equal;
- postprocess, on the same head outputs (JAX's): valid rows and labels
  exactly equal, scores 1e-6, boxes 1e-4 px;
- ``compute_loss`` on the same head outputs: 1e-5 relative; its gradients
  1e-5 of the largest;
- one train step of the whole model: losses 1e-5 relative, every
  gradient together within 1e-3 by relative Frobenius norm (f32 backward
  passes of a deep net in another order);
- ``BoxLinearCoder``: the JAX coder's results within 1e-6 relative; decode
  after encode gives the boxes back within 1e-4 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.models.detection import _utils as jutils
from vision_tpu.models.detection.anchor_utils import (
    AnchorGenerator as JaxAnchorGenerator,
)
from vision_tpu.models.detection.fcos import FCOS as JaxFCOS
from vision_tpu_torch.models import get_model, list_models
from vision_tpu_torch.models.detection import _utils as tutils
from vision_tpu_torch.models.detection.fcos import FCOS, _upgrade_state_dict
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)
from torch_det_cases import (
    check_detections,
    check_grads,
    jax_grads_by_name,
    nchw,
    one_stage_step,
    port_with,
    rel,
    seeded_variables,
    tensors,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

H, W = 128, 160
CFG = dict(backbone_depth=18, num_classes=5)
GT_BOXES = np.array([
    [[10, 12, 60, 70], [30, 40, 100, 120], [70, 5, 150, 50]],
    [[5, 5, 40, 30], [50, 60, 127, 110], [0, 0, 0, 0]],
], np.float32)
GT_LABELS = np.array([[1, 2, 4], [3, 4, 0]], np.int32)
GT_VALID = np.array([[1, 1, 1], [1, 1, 0]], bool)
LEVEL_SIZES = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]


def _jax_anchorgen():
    """The JAX FCOS's anchor generator (``fcos.py:120``)."""
    return JaxAnchorGenerator(((8,), (16,), (32,), (64,), (128,)), ((1.0,),) * 5)


def _gt_torch():
    return (torch.from_numpy(GT_BOXES), torch.from_numpy(GT_LABELS).long(),
            torch.from_numpy(GT_VALID))


def _gt_jax():
    return jnp.asarray(GT_BOXES), jnp.asarray(GT_LABELS), jnp.asarray(GT_VALID)


@pytest.fixture(scope="module")
def pair():
    """The JAX model, its variables, the port carrying them, the images,
    the JAX forward and the JAX train-step loss and gradients."""
    jm = JaxFCOS(**CFG)
    x = np.random.RandomState(4).rand(2, H, W, 3).astype(np.float32)
    variables = seeded_variables(jm, x[:1])
    port = port_with(lambda: FCOS(**CFG), variables)
    heads = jax.jit(lambda v, x: jm.apply(v, x))(variables, jnp.asarray(x))

    def loss_fn(params, rest, x):
        v = {"params": params, **rest}
        outs = jm.apply(v, x, train=True)
        losses = jm.apply(v, *outs, *_gt_jax(),
                          method=lambda m, *a: m.compute_loss(*a))
        return sum(losses.values()), losses

    rest = {k: v for k, v in variables.items() if k != "params"}
    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], rest, jnp.asarray(x))
    return dict(jm=jm, variables=variables, port=port, x=x, heads=heads,
                losses={k: float(v) for k, v in losses.items()},
                grads=jax_grads_by_name(grads, variables, port))


@pytest.fixture(scope="module")
def port_heads(pair):
    with torch.no_grad():
        return pair["port"](nchw(pair["x"]))


@pytest.mark.parametrize("i,name", [(0, "cls_logits"), (1, "bbox_reg"),
                                    (2, "bbox_ctrness")])
def test_head_outputs(pair, port_heads, i, name):
    for got, want in zip(port_heads[i], pair["heads"][i]):
        assert rel(got.numpy(), want) <= 1e-5, name
    assert (port_heads[1][0] >= 0).all()  # the box branch ends in a ReLU


@pytest.mark.parametrize("image,sizes", [
    ((H, W), LEVEL_SIZES),
    ((1344, 1344), [(168, 168), (84, 84), (42, 42), (21, 21), (11, 11)]),
], ids=["128x160", "1344"])
def test_anchors(pair, port_heads, image, sizes):
    want = _jax_anchorgen()(image, sizes)
    got = FCOS(**CFG).anchor_generator(image, sizes, torch.device("cpu"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if image == (H, W):
        for a, b in zip(port_heads[3], pair["heads"][3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _seeded_heads(num_classes, seed):
    """Per-level head outputs at 128x160, about the score threshold, and
    the anchors."""
    rs = np.random.RandomState(seed)
    anchors = [np.asarray(a) for a in _jax_anchorgen()((H, W), LEVEL_SIZES)]
    cls = [(rs.randn(2, a.shape[0], num_classes) * 2 - 2).astype(np.float32)
           for a in anchors]
    reg = [np.abs(rs.randn(2, a.shape[0], 4) * 2).astype(np.float32)
           for a in anchors]
    ctr = [rs.randn(2, a.shape[0], 1).astype(np.float32) for a in anchors]
    return cls, reg, ctr, anchors


@pytest.mark.parametrize("source", ["model", "seeded5", "seeded91"])
def test_postprocess_detections(pair, source):
    if source == "model":
        heads, num_classes = pair["heads"], CFG["num_classes"]
    else:
        num_classes = int(source[6:])
        heads = _seeded_heads(num_classes, num_classes)
    jm = JaxFCOS(backbone_depth=18, num_classes=num_classes)
    want = jax.jit(lambda *h: jm.apply(
        {}, *h, (H, W), method=lambda m, *a: m.postprocess_detections(*a)))(
            *heads)
    port = FCOS(backbone_depth=18, num_classes=num_classes)
    got = port.postprocess_detections(*tensors(heads), (H, W))
    check_detections(got, want)
    assert got.boxes.shape == (2, 100, 4)
    assert (np.asarray(want.valid).sum(1) > 5).all()


@pytest.mark.parametrize("source", ["model", "seeded5"])
def test_compute_loss_and_its_gradient(pair, source):
    heads = pair["heads"] if source == "model" else _seeded_heads(5, 9)
    jm = JaxFCOS(**CFG)

    def jloss(c, r, t):
        out = jm.apply({}, c, r, t, heads[3], *_gt_jax(),
                       method=lambda m, *a: m.compute_loss(*a))
        return sum(out.values()), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(*heads[:3])
    inputs = [[t.requires_grad_() for t in tensors(h)] for h in heads[:3]]
    got = pair["port"].compute_loss(*inputs, tensors(heads[3]), *_gt_torch())
    sum(got.values()).backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5)
        assert float(want[k]) > 0
    for ts, js in zip(inputs, jgrads):
        for t, j in zip(ts, js):
            if np.abs(np.asarray(j)).max() > 0:
                assert rel(t.grad.numpy(), j) <= 1e-5


def test_match_holds_the_jax_rule_at_the_1344_canvas():
    """At FCOS's 37,606 locations of the 1344 canvas: foreground locations
    lie inside their gt, at most ``center_sampling_radius`` strides from
    its centre and within their level's range, and each takes the least
    area of the gts that hold it."""
    port = FCOS(**CFG)
    sizes = [(168, 168), (84, 84), (42, 42), (21, 21), (11, 11)]
    anchors = port.anchor_generator((1344, 1344), sizes, torch.device("cpu"))
    rs = np.random.RandomState(7)
    xy = rs.rand(2, 8, 2) * 1000
    gt = np.concatenate([xy, xy + 20 + rs.rand(2, 8, 2) * 300], -1).astype(np.float32)
    valid = np.ones((2, 8), bool)
    valid[1, 5:] = False
    all_anchors = torch.cat(anchors)
    matched = port.match(all_anchors, [a.shape[0] for a in anchors],
                         torch.from_numpy(gt), torch.from_numpy(valid))
    assert matched.shape == (2, 37_606)
    fg = matched >= 0
    assert int(fg.sum()) > 100
    m = matched.clamp(min=0).numpy()
    assert valid[np.arange(2)[:, None], m][fg.numpy()].all()
    centres = ((all_anchors[:, :2] + all_anchors[:, 2:]) / 2).numpy()
    for i in range(2):
        rows = np.nonzero(fg[i].numpy())[0]
        b = gt[i, m[i, rows]]
        c = centres[rows]
        assert ((c > b[:, :2]) & (c < b[:, 2:])).all()
        stride = (all_anchors[rows, 2] - all_anchors[rows, 0]).numpy()
        gc = (b[:, :2] + b[:, 2:]) / 2
        assert (np.abs(c - gc).max(1) < 1.5 * stride).all()


def test_whole_model_train_step(pair):
    """``make_detection_train_step(one_stage=True)`` on the whole model:
    losses 1e-5 relative, every gradient together 1e-3 (Frobenius)."""
    losses, grads = one_stage_step(pair["port"], nchw(pair["x"]), *_gt_torch())
    for k, want in pair["losses"].items():
        np.testing.assert_allclose(losses[k], want, rtol=1e-5)
    np.testing.assert_allclose(losses["loss"], sum(pair["losses"].values()),
                               rtol=1e-5)
    check_grads(grads, pair["grads"])
    for name in ("head.classification_head.cls_logits.weight",
                 "head.regression_head.bbox_ctrness.weight",
                 "backbone.fpn.extra_blocks.p6.weight",
                 "backbone.body.layer1.0.conv1.weight"):
        assert rel(grads[name].numpy(), pair["grads"][name]) <= 1e-3, name


def test_amp_step_against_f32(pair):
    """The amp step (bf16 parameters and image, f32 losses) within 5e-2
    of the f32 step's losses."""
    f32, _ = one_stage_step(pair["port"], nchw(pair["x"]), *_gt_torch())
    amp, grads = one_stage_step(pair["port"], nchw(pair["x"]), *_gt_torch(),
                                dtype=torch.bfloat16)
    for k in f32:
        assert abs(amp[k] - f32[k]) <= 5e-2 * abs(f32[k]), k
    assert all(g.dtype == torch.float32 for g in grads.values())


@pytest.mark.parametrize("normalize", [True, False])
def test_box_linear_coder(normalize):
    rs = np.random.RandomState(11)
    xy = rs.rand(50, 2) * 100
    anchors = np.concatenate([xy, xy + 4 + rs.rand(50, 2) * 60], 1).astype(np.float32)
    centre = (anchors[:, :2] + anchors[:, 2:]) / 2
    lt = centre - 1 - rs.rand(50, 2) * 40
    boxes = np.concatenate([lt, centre + 1 + rs.rand(50, 2) * 40], 1).astype(np.float32)
    port = tutils.BoxLinearCoder(normalize)
    jax_coder = jutils.BoxLinearCoder(normalize)
    codes = port.encode(torch.from_numpy(boxes), torch.from_numpy(anchors))
    np.testing.assert_allclose(codes.numpy(), np.asarray(jax_coder.encode(
        jnp.asarray(boxes), jnp.asarray(anchors))), rtol=1e-6, atol=1e-6)
    back = port.decode(codes, torch.from_numpy(anchors))
    np.testing.assert_allclose(back.numpy(), boxes, rtol=0, atol=1e-4)
    np.testing.assert_allclose(back.numpy(), np.asarray(jax_coder.decode(
        jnp.asarray(codes.numpy()), jnp.asarray(anchors))), rtol=1e-6, atol=1e-5)
    assert port.decode(codes.bfloat16(), torch.from_numpy(anchors)).dtype == torch.float32
    assert (codes > 0).all()


def test_builder_and_state_dict():
    """On the CPU with ``device="cpu"``, torchvision's parameter count and
    names; the default device is the card; a checkpoint's anchors buffer
    and pre-0.12 FPN names load through ``_upgrade_state_dict``."""
    assert "fcos_resnet50_fpn" in list_models()
    model = get_model("fcos_resnet50_fpn", device="cpu")
    assert not model.training
    assert sum(p.numel() for p in model.parameters()) == 32_269_600
    sd = model.state_dict()
    assert "head.regression_head.bbox_ctrness.weight" in sd
    assert "head.classification_head.conv.1.weight" in sd  # GroupNorm
    assert "backbone.fpn.extra_blocks.p7.weight" in sd
    old = {k.replace("inner_blocks.0.0.", "inner_blocks.0."): v
           for k, v in sd.items()}
    old["anchor_generator.anchors"] = torch.zeros(1)
    assert set(_upgrade_state_dict(old)) == set(sd)
    bias = model.head.classification_head.cls_logits.bias
    assert float(bias[0].detach()) == pytest.approx(-np.log(99.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model("fcos_resnet50_fpn")
    frozen = get_model("fcos_resnet50_fpn", device="cpu",
                       trainable_backbone_layers=2)
    trainable = {n.split(".")[2] for n, p in frozen.named_parameters()
                 if p.requires_grad and n.startswith("backbone.body")}
    assert trainable == {"layer3", "layer4"}
