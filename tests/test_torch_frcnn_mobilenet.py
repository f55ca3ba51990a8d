"""MobileNet Faster R-CNN parity (``fasterrcnn_mobilenet_v3_large_fpn``,
``_320_fpn``): the port (plain PyTorch paths on the CPU, the windowed
pooler) against the JAX package (JAX on the CPU, its plain NMS and dense
pooler), with the same seeded variables (``torch_det_cases.py``, kernels
of variance 1 over the fan in), 5 classes, the 320 variant's RPN settings
(score threshold 0.05, top-n 150), two 160x192 images, the JAX side jitted
once per function in module fixtures.

The FPN trunk taps ``body.13`` and ``body.16``, both at stride 32, so the
box pooler's two levels have one scale and every RoI maps to level "0"
(``LevelMapper(5, 5)``). ``jax.random`` cannot be reproduced in torch, so
the train-step test hands the port's two samplers the masks that JAX's
samplers draw (``JaxSampler``, as ``test_torch_detection_train.py``
does).

Tolerances:
- FPN maps and RPN head outputs: 1e-5 of the largest;
- anchors: exactly equal;
- proposals from the same RPN outputs (JAX's): the same valid rows,
  boxes within 1e-4 px;
- pooled box features from the same maps and proposals: 1e-5 of the
  largest;
- detections of the whole model: the same valid rows and labels, scores
  within 1e-6, boxes within 1e-4 px;
- losses 1e-5 relative; every gradient together within 1e-3 by relative
  Frobenius norm.
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
from vision_tpu.models.detection.faster_rcnn import FasterRCNN as JaxFasterRCNN
from vision_tpu.models.detection.rpn import RegionProposalNetwork as JaxRPN
from vision_tpu.ops.poolers import MultiScaleRoIAlign as JaxPooler
from vision_tpu_torch.models import get_model, list_models
from vision_tpu_torch.models.detection.backbone_utils import (
    MobileNetV3FPNBackbone,
)
from vision_tpu_torch.models.detection.faster_rcnn import FasterRCNN
from vision_tpu_torch.ops.misc import BatchNorm2d, FrozenBatchNorm2d
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)
from torch_det_cases import (
    check_grads,
    jax_grads_by_name,
    nchw,
    port_with,
    rel,
    seeded_variables,
    tensors,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

H, W = 160, 192
CFG = dict(backbone_type="mobilenet_v3_large", num_classes=5,
           rpn_score_thresh=0.05, rpn_pre_nms_top_n=150, rpn_post_nms_top_n=150)
GT_BOXES = np.array([
    [[10, 12, 60, 70], [30, 40, 150, 140], [70, 5, 190, 80], [0, 0, 0, 0]],
    [[5, 5, 90, 60], [50, 60, 187, 158], [0, 0, 0, 0], [0, 0, 0, 0]],
], np.float32)
GT_LABELS = np.array([[1, 2, 4, 0], [3, 4, 0, 0]], np.int32)
GT_VALID = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
KEY = 3
ANCHOR_SIZES = ((32, 64, 128, 256, 512),) * 3


def _gt_torch():
    return (torch.from_numpy(GT_BOXES), torch.from_numpy(GT_LABELS).long(),
            torch.from_numpy(GT_VALID))


def _gt_jax():
    return jnp.asarray(GT_BOXES), jnp.asarray(GT_LABELS), jnp.asarray(GT_VALID)


class JaxSampler:
    """Stands in for a port sampler: per image the masks that the JAX
    sampler draws from ``jax.random.split(key, N)[i]`` for the matches the
    port computed."""

    def __init__(self, sampler, key):
        self.sampler = sampler
        self.key = key

    def __call__(self, matched, generator):
        keys = jax.random.split(self.key, matched.shape[0])
        pos, neg = jax.jit(jax.vmap(self.sampler))(
            jnp.asarray(matched.numpy().astype(np.int32)), keys)
        return torch.from_numpy(np.array(pos)), torch.from_numpy(np.array(neg))


@pytest.fixture(scope="module")
def pair():
    jm = JaxFasterRCNN(**CFG)
    x = np.random.RandomState(1).rand(2, H, W, 3).astype(np.float32)
    variables = seeded_variables(jm, x[:1], gain=1.0)
    port = port_with(lambda: FasterRCNN(**CFG), variables)

    def stages(v, x):
        feats, obj, deltas, anchors = jm.apply(
            v, x, method=lambda m, x: m._features_and_rpn(x))
        props = JaxRPN(pre_nms_top_n=150, post_nms_top_n=150,
                       score_thresh=0.05).filter_proposals(obj, deltas, anchors,
                                                           (H, W))
        return feats, obj, deltas, anchors, props

    def loss_fn(params, v, x, key):
        losses = jm.apply({**v, "params": params}, x, *_gt_jax(), key,
                          method="compute_loss")
        return sum(losses.values()), losses

    feats, obj, deltas, anchors, props = jax.jit(stages)(variables,
                                                          jnp.asarray(x))
    dets = jax.jit(lambda v, x: jm.apply(v, x))(variables, jnp.asarray(x))
    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables, jnp.asarray(x), jax.random.PRNGKey(KEY))
    return dict(jm=jm, variables=variables, port=port, x=x, feats=feats,
                obj=obj, deltas=deltas, anchors=anchors, props=props, dets=dets,
                losses={k: float(v) for k, v in losses.items()},
                grads=jax_grads_by_name(grads, variables, port))


@pytest.fixture(scope="module")
def port_stages(pair):
    with torch.no_grad():
        return pair["port"].features_and_rpn(nchw(pair["x"]))


@pytest.mark.parametrize("what", ["fpn", "objectness", "deltas"])
def test_fpn_and_rpn_head(pair, port_stages, what):
    feats, obj, deltas, _ = port_stages
    if what == "fpn":
        assert list(feats) == ["0", "1", "pool"]
        assert [tuple(f.shape[-2:]) for f in feats.values()] == [(5, 6), (5, 6),
                                                                 (3, 3)]
        for k, f in pair["feats"].items():
            assert rel(feats[k].numpy(), np.asarray(f).transpose(0, 3, 1, 2)) <= 1e-5, k
        return
    got, want = (obj, pair["obj"]) if what == "objectness" else (deltas, pair["deltas"])
    assert len(got) == 3
    for a, b in zip(got, want):
        assert rel(a.numpy(), b) <= 1e-5


@pytest.mark.parametrize("image,sizes", [
    ((H, W), [(5, 6), (5, 6), (3, 3)]),
    ((1344, 1344), [(42, 42), (42, 42), (21, 21)]),
], ids=["160x192", "1344"])
def test_anchors(pair, port_stages, image, sizes):
    want = JaxAnchorGenerator(ANCHOR_SIZES, ((0.5, 1.0, 2.0),) * 3)(image, sizes)
    gen = pair["port"].rpn.anchor_generator
    assert gen.num_anchors_per_location() == [15] * 3
    got = gen(image, sizes, torch.device("cpu"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if image == (H, W):
        for a, b in zip(port_stages[3], pair["anchors"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_filter_proposals(pair):
    props = pair["port"].rpn.filter_proposals(
        tensors(pair["obj"]), tensors(pair["deltas"]), tensors(pair["anchors"]),
        (H, W))
    want = pair["props"]
    valid = np.asarray(want.valid)
    assert valid.sum(1).min() > 10
    np.testing.assert_array_equal(props.valid.numpy(), valid)
    np.testing.assert_allclose(props.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], rtol=0, atol=1e-4)


def test_box_pooler_over_two_levels_of_one_scale(pair):
    """The windowed pooler over "0" and "1" (both 1/32) against JAX's
    dense one, on the same maps and proposals."""
    props = pair["props"]
    n, p = props.boxes.shape[:2]
    boxes = np.asarray(props.boxes).reshape(-1, 4)
    rois = np.concatenate([np.repeat(np.arange(n, dtype=np.float32), p)[:, None],
                           boxes], 1)
    maps = {k: pair["feats"][k] for k in ("0", "1")}
    want = JaxPooler(["0", "1"], output_size=7, sampling_ratio=2)(
        maps, jnp.asarray(rois), (H, W))
    got = pair["port"].roi_heads.box_roi_pool(
        {k: nchw(v) for k, v in maps.items()}, torch.from_numpy(rois), (H, W))
    assert rel(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2)) <= 1e-5


def test_whole_model_detections(pair):
    with torch.no_grad():
        got = pair["port"](nchw(pair["x"]))
    want = pair["dets"]
    valid = np.asarray(want.valid)
    assert valid.sum(1).min() > 0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy()[valid],
                                  np.asarray(want.labels)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def port_loss(pair):
    """The port's ``compute_loss`` with both samplers handed the JAX masks,
    and the gradients of the summed losses."""
    port = pair["port"]
    k1, k2 = jax.random.split(jax.random.PRNGKey(KEY))
    samplers = port.rpn.sampler, port.roi_heads.sampler
    port.rpn.sampler = JaxSampler(
        jutils.BalancedPositiveNegativeSampler(256, 0.5), k1)
    port.roi_heads.sampler = JaxSampler(
        jutils.BalancedPositiveNegativeSampler(512, 0.25), k2)
    try:
        port.train()
        losses = port.compute_loss(nchw(pair["x"]), *_gt_torch(), None)
        sum(losses.values()).backward()
    finally:
        port.rpn.sampler, port.roi_heads.sampler = samplers
        port.eval()
    grads = {n: p.grad.clone() for n, p in port.named_parameters()
             if p.grad is not None}
    port.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


@pytest.mark.parametrize("name", ["loss_objectness", "loss_rpn_box_reg",
                                  "loss_classifier", "loss_box_reg"])
def test_losses(pair, port_loss, name):
    np.testing.assert_allclose(port_loss[0][name], pair["losses"][name],
                               rtol=1e-5)
    assert pair["losses"][name] > 0


def test_gradients(pair, port_loss):
    check_grads(port_loss[1], pair["grads"])
    assert "backbone.body.0.0.weight" in port_loss[1]


@pytest.mark.parametrize("name,size,top_n", [
    ("fasterrcnn_mobilenet_v3_large_fpn", 1344, 1000),
    ("fasterrcnn_mobilenet_v3_large_320_fpn", 640, 150)])
def test_builders(name, size, top_n):
    """torchvision's parameter count and names, frozen batch norm in the
    trunk, the builders' RPN settings; the default device is the card."""
    assert name in list_models()
    model = get_model(name, device="cpu")
    assert not model.training
    assert sum(p.numel() for p in model.parameters()) == 19_386_354
    assert isinstance(model.backbone, MobileNetV3FPNBackbone)
    assert model.featmap_names == ["0", "1"]
    assert (model.rpn.pre_nms_top_n, model.rpn.post_nms_top_n,
            model.rpn.score_thresh) == (top_n, top_n, 0.05)
    sd = model.state_dict()
    for key in ("backbone.body.0.1.running_var", "backbone.body.13.block.2.fc1.weight",
                "backbone.body.16.0.weight", "backbone.fpn.inner_blocks.0.0.weight",
                "rpn.head.cls_logits.weight", "roi_heads.box_head.fc6.weight"):
        assert key in sd, key
    assert model.rpn.head.cls_logits.out_channels == 15
    kinds = {type(m) for m in model.backbone.body.modules()}
    assert FrozenBatchNorm2d in kinds and BatchNorm2d not in kinds
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model(name)
    with torch.no_grad():
        feats = model.backbone(torch.zeros(1, 3, size, size))
    assert [tuple(f.shape[-2:]) for f in feats.values()] == [
        (size // 32,) * 2, (size // 32,) * 2, (-(-size // 64),) * 2]


@pytest.mark.parametrize("layers,frozen_upto", [(0, 17), (3, 7), (6, 0)])
def test_trainable_backbone_layers(layers, frozen_upto):
    """torchvision's stages of the MobileNet trunk (0, 2, 4, 7, 13, 16):
    the layers before the first trainable stage freeze, all at 0."""
    model = get_model("fasterrcnn_mobilenet_v3_large_fpn", device="cpu",
                      trainable_backbone_layers=layers)
    frozen = {int(n.split(".")[2]) for n, p in model.named_parameters()
              if n.startswith("backbone.body") and not p.requires_grad}
    assert frozen == set(range(frozen_upto))
    assert all(p.requires_grad for n, p in model.named_parameters()
               if not n.startswith("backbone.body"))
    with pytest.raises(ValueError, match="trainable_layers"):
        get_model("fasterrcnn_mobilenet_v3_large_fpn", device="cpu",
                  trainable_backbone_layers=7)
