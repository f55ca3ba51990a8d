"""v2 Faster and Mask R-CNN parity: the port (plain PyTorch paths on the
CPU) against the JAX package (JAX on the CPU), module by module and whole,
with the same inputs and weights.

Inputs come from numpy seeds. The whole-model weights are the port's
seeded init with every batch norm's affine terms and statistics moved away
from the identity, converted to flax variables by the JAX package's own
converter (``convert_torch_state_dict`` with ``_frcnn_hooks``) and loaded
back into a fresh port model with ``load_jax_variables``, so both sides
run JAX's variables. The whole models are ResNet-18 v2 detectors (JAX's
``backbone_depth=18``), 5 classes, RPN top-n 200/50, 10 detections an
image, two 128x160 images, G = 3 gt rows with a padding row; the JAX side
is jitted once per model in a module fixture, and the port's samplers are
handed the JAX samplers' draws (``JaxSampler``).

The three batch-norm rules of the JAX v2 models, held here: the FPN's norm
normalises by its running statistics in training too and never updates
them; in ``compute_loss`` the trunk's and the box head's batch norms use
batch statistics and update the running ones; the mask head's uses its
running statistics and leaves them.

Tolerances, each against the largest magnitude of the compared tensor:
- modules (FPN with norm, ``RPNHead(conv_depth=2)``, ``FastRCNNConvFCHead``
  with its fc reorder, ``MaskRCNNHeads(use_norm=True)``), eval and
  training mode, their input gradients against ``jax.vjp`` of the same
  cotangent, and their updated statistics: 1e-5;
- whole models, eval: valid rows and labels exactly equal, boxes within
  1e-3 px, scores within 1e-4, masks of the valid rows within 1e-4;
- ``compute_loss``: each loss within 1e-4 relative; the updated running
  statistics within 1e-4; each compared gradient within 2e-2 of the JAX
  gradient by relative Frobenius norm (``|g - g_jax| / |g_jax|``). In f32
  these gradients are not sharper than that in either library: through
  the two batch norms in training mode, either library's f32 gradients of
  the trunk, FPN and box head convolutions lie some 1e-3 to 1e-2 (by that
  norm) from an f64 evaluation of the same step, and up to 1e-1 by
  largest element. The module tests above hold the batch norms'
  gradients sharply.
"""

import functools

import flax.linen as fnn
from flax import traverse_util
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_detection_train import JaxSampler
from vision_tpu._torch_convert import convert_torch_state_dict
from vision_tpu.models.detection import _utils as jutils
from vision_tpu.models.detection.faster_rcnn import FasterRCNN as JaxFasterRCNN
from vision_tpu.models.detection.faster_rcnn import _frcnn_hooks
from vision_tpu.models.detection.mask_rcnn import MaskRCNN as JaxMaskRCNN
from vision_tpu.models.detection.roi_heads import FastRCNNConvFCHead as JaxBoxHead
from vision_tpu.models.detection.roi_heads import MaskRCNNHeads as JaxMaskHead
from vision_tpu.models.detection.rpn import RPNHead as JaxRPNHead
from vision_tpu.ops.feature_pyramid_network import FeaturePyramidNetwork as JaxFPN
from vision_tpu_torch._jax_convert import (
    _leaves,
    _to_torch_layout,
    _torch_name,
    load_jax_variables,
)
from vision_tpu_torch.models import get_model, list_models
from vision_tpu_torch.models.detection import (
    FasterRCNN_ResNet50_FPN_V2_Weights,
    MaskRCNN_ResNet50_FPN_V2_Weights,
)
from vision_tpu_torch.models.detection.faster_rcnn import (
    FasterRCNN,
    _upgrade_state_dict,
    init_weights,
)
from vision_tpu_torch.models.detection.mask_rcnn import MaskRCNN
from vision_tpu_torch.models.detection.roi_heads import (
    FastRCNNConvFCHead,
    MaskRCNNHeads,
)
from vision_tpu_torch.models.detection.rpn import RPNHead
from vision_tpu_torch.ops.feature_pyramid_network import FeaturePyramidNetwork
from vision_tpu_torch.ops.misc import BatchNorm2d
from vision_tpu_torch.ops.poolers import MultiScaleRoIAlign
from vision_tpu_torch.tools.detection_request import ellipse_masks
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

H, W = 128, 160
CFG = dict(backbone_depth=18, num_classes=5, rpn_pre_nms_top_n=200,
           rpn_post_nms_top_n=50, box_detections_per_img=10, v2=True)
GT_BOXES = np.array([
    [[10, 12, 60, 70], [30, 40, 100, 120], [70, 5, 150, 50]],
    [[5, 5, 40, 30], [50, 60, 127, 110], [0, 0, 0, 0]],
], np.float32)
GT_LABELS = np.array([[1, 2, 4], [3, 4, 0]], np.int32)
GT_VALID = np.array([[1, 1, 1], [1, 1, 0]], bool)
KEY = 3
IMAGE_SEED = 0
CLS_SCALE = 4.0  # cls_score's weight, so that detections pass 0.05
# the gradients compared, the only ones either side computes: a last-stage
# conv and norm, an FPN lateral conv and a smoothing norm, the RPN's second
# conv, the box head's first conv and norm and its fc, and the mask head's
# first conv and last norm
GRADS = ("backbone.body.layer4.1.bn2.weight", "backbone.body.layer4.1.conv2.weight",
         "backbone.fpn.inner_blocks.1.0.weight",
         "backbone.fpn.layer_blocks.2.1.weight", "rpn.head.conv.1.0.weight",
         "roi_heads.box_head.0.0.weight", "roi_heads.box_head.0.1.weight",
         "roi_heads.box_head.5.weight")
MASK_GRADS = ("roi_heads.mask_head.0.0.weight", "roi_heads.mask_head.3.1.bias")


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{err} > {rel}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _spread(variables, seed):
    """Every batch norm's affine terms and statistics away from the
    identity; the rest as it is."""
    rs = np.random.RandomState(seed)

    def move(path, v):
        v = np.asarray(v)
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if "norm" in name or ".1" in name or "bn" in name or "batch_stats" in name:
            if name.endswith("var"):
                return rs.uniform(0.5, 1.5, v.shape).astype(v.dtype)
            if name.endswith(("mean", "bias")):
                return (v + rs.randn(*v.shape) * 0.1).astype(v.dtype)
            if name.endswith("scale"):
                return rs.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        return v

    return jax.tree_util.tree_map_with_path(move, variables)


def _stats(module):
    return {f"{mn}.{bn}": b.clone() for mn, m in module.named_modules()
            if isinstance(m, BatchNorm2d)
            for bn, b in m.named_buffers(recurse=False) if "running" in bn}


# ------------------------------------------------------------------ modules

def test_fpn_with_norm():
    """The v2 FPN: bias-free convolutions, each followed by a batch norm on
    its running statistics, in training mode too (no update)."""
    rs = np.random.RandomState(1)
    chans = (8, 16, 32)
    feats = {str(i): rs.randn(2, s, s + 2, c).astype(np.float32)
             for i, (s, c) in enumerate(zip((16, 8, 4), chans))}
    norm = functools.partial(fnn.BatchNorm, use_running_average=True,
                             momentum=0.9, epsilon=1e-5)
    jm = JaxFPN(out_channels=16, norm_layer=norm)
    variables = _spread(jax.jit(jm.init)(jax.random.PRNGKey(0), feats), 2)
    apply = jax.jit(jm.apply)
    want = apply(variables, feats)
    port = FeaturePyramidNetwork(
        list(chans), 16,
        norm_layer=functools.partial(BatchNorm2d, use_running_average=True))
    load_jax_variables(port, variables)
    assert port.inner_blocks[0][0].bias is None
    assert sum(p.numel() for p in port.parameters()) == sum(
        np.size(v) for v in jax.tree_util.tree_leaves(variables["params"]))
    stats0 = _stats(port)
    cot = {k: rs.randn(*v.shape).astype(np.float32) for k, v in want.items()}
    _, vjp = jax.vjp(lambda f: apply(variables, f), feats)
    (jgrad,) = vjp(cot)
    for train in (False, True):
        port.train(train)
        inputs = {k: _nchw(v).requires_grad_() for k, v in feats.items()}
        got = port(inputs)
        assert list(got) == ["0", "1", "2", "pool"]
        for k in ("0", "1", "2"):
            _close(_nhwc(got[k]), want[k], 1e-5)
        sum((got[k] * _nchw(cot[k])).sum() for k in cot).backward()
        for k in feats:
            _close(_nhwc(inputs[k].grad), jgrad[k], 1e-5)
    assert all(torch.equal(v, stats0[k]) for k, v in _stats(port).items())


def test_rpn_head_conv_depth_2():
    rs = np.random.RandomState(3)
    feats = [rs.randn(2, s, s + 1, 16).astype(np.float32) for s in (8, 4, 2)]
    jm = JaxRPNHead(num_anchors=3, conv_depth=2)
    variables = jm.init(jax.random.PRNGKey(0), feats)
    jo, jd = jm.apply(variables, feats)
    port = RPNHead(16, 3, conv_depth=2)
    load_jax_variables(port, jax.tree_util.tree_map(np.asarray, variables))
    assert [n for n, _ in port.named_parameters()][:4] == [
        "conv.0.0.weight", "conv.0.0.bias", "conv.1.0.weight", "conv.1.0.bias"]
    with torch.no_grad():
        to, td = port([_nchw(f) for f in feats])
    for a, b in zip(to + td, list(jo) + list(jd)):
        _close(a.numpy(), b, 1e-5)


class _BoxHolder(torch.nn.Module):
    """The box head where the converter finds it
    (``roi_heads.box_head``, beside the 7x7 ``box_roi_pool``)."""

    def __init__(self):
        super().__init__()
        self.roi_heads = torch.nn.Module()
        self.roi_heads.box_head = FastRCNNConvFCHead()
        self.roi_heads.box_roi_pool = MultiScaleRoIAlign(["0"], 7, 2)


@pytest.mark.parametrize("head", ["box", "mask"])
def test_v2_roi_heads(head):
    """``FastRCNNConvFCHead`` (its fc ``5`` reordered from JAX's HWC
    flatten to torch's CHW one) and ``MaskRCNNHeads(use_norm=True)``, in
    eval and training mode, and their updated statistics."""
    rs = np.random.RandomState(4)
    size = 7 if head == "box" else 14
    x = rs.randn(3, size, size, 256).astype(np.float32)
    jm = JaxBoxHead() if head == "box" else JaxMaskHead(use_norm=True)
    variables = _spread(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    if head == "box":
        holder = _BoxHolder()
        load_jax_variables(holder, {c: {"roi_heads.box_head": t}
                                    for c, t in variables.items()})
        port = holder.roi_heads.box_head
        assert [n for n, _ in port.named_parameters()][-2:] == ["5.weight", "5.bias"]
    else:
        port = MaskRCNNHeads(256, 4, 256, use_norm=True)
        load_jax_variables(port, variables)
    assert port[0][0].bias is None if head == "box" else port._modules["0"][0].bias is None
    port.eval()
    with torch.no_grad():
        got = port(_nchw(x))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    _close(got.numpy() if head == "box" else _nhwc(got), want, 1e-5)
    port.train()
    xt = _nchw(x).requires_grad_()
    got = port(xt)
    want, vjp, mut = jax.vjp(jax.jit(lambda a: jm.apply(
        variables, a, train=True, mutable=["batch_stats"])), jnp.asarray(x),
        has_aux=True)
    _close(got.detach().numpy() if head == "box" else _nhwc(got), want, 1e-5)
    cot = rs.randn(*want.shape).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot) if head == "box" else _nchw(cot))
    _close(_nhwc(xt.grad), jgrad, 1e-5)
    got_stats = _stats(port)
    for i in range(4):
        for leaf, name in (("mean", "running_mean"), ("var", "running_var")):
            _close(got_stats[f"{i}.1.{name}"].numpy(),
                   mut["batch_stats"][f"{i}.1"][leaf], 1e-5)


# ------------------------------------------------------------- whole models

def _gt_torch():
    boxes, valid = torch.from_numpy(GT_BOXES), torch.from_numpy(GT_VALID)
    return (boxes, torch.from_numpy(GT_LABELS).long(), valid,
            ellipse_masks(boxes, valid, (H, W)))


def _sampled_loss(port, x, mask):
    """The port's ``compute_loss`` in training mode, its samplers handed the
    JAX samplers' draws from ``KEY``, and its backward pass: the losses,
    the gradients and the running statistics after it."""
    boxes, labels, valid, masks = _gt_torch()
    k1, k2 = jax.random.split(jax.random.PRNGKey(KEY))
    port.rpn.sampler = JaxSampler(jutils.BalancedPositiveNegativeSampler(256, 0.5), k1)
    port.roi_heads.sampler = JaxSampler(
        jutils.BalancedPositiveNegativeSampler(512, 0.25), k2)
    port.train()
    wanted = GRADS + (MASK_GRADS if mask else ())
    for n, p in port.named_parameters():
        p.requires_grad_(n in wanted)
    losses = port.compute_loss(x, boxes, labels, valid, None,
                               **({"gt_masks": masks.to(x.dtype)} if mask else {}))
    sum(losses.values()).backward()
    if mask:  # the loss left the mask head in training mode
        assert port.roi_heads.mask_head.training
    named = dict(port.named_parameters())
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: named[n].grad.clone() for n in wanted}, _stats(port))


@pytest.fixture(scope="module", params=["faster", "mask"])
def whole(request):
    """Both models on the same variables: the forward, and ``compute_loss``
    in training mode with its gradient and new statistics."""
    mask = request.param == "mask"
    jm = (JaxMaskRCNN if mask else JaxFasterRCNN)(**CFG)
    cls = MaskRCNN if mask else FasterRCNN
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    src = cls(**CFG)
    init_weights(src, torch.Generator().manual_seed(0))
    with torch.no_grad():
        src.roi_heads.box_predictor.cls_score.weight.mul_(CLS_SCALE)
        if mask:  # mask logits of RMS ~3 rather than saturated
            src.roi_heads.mask_predictor.mask_fcn_logits.weight.mul_(0.05)
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    variables = _spread(jax.tree_util.tree_map(
        np.asarray, convert_torch_state_dict(sd, shapes, hooks=_frcnn_hooks)), 6)
    port = cls(**CFG).eval()
    load_jax_variables(port, variables)
    x = np.random.RandomState(IMAGE_SEED).rand(2, H, W, 3).astype(np.float32)
    gt = [t.numpy() for t in _gt_torch()]

    # the gradient of the compared parameters only, so that XLA drops the
    # rest of the backward pass
    flat = traverse_util.flatten_dict(variables["params"])
    wanted = GRADS + (MASK_GRADS if mask else ())
    paths = [k for k in flat if _torch_name("params", k) in wanted]

    def loss_fn(sel, v, x, key):
        params = traverse_util.unflatten_dict({**flat, **dict(zip(paths, sel))})
        extra = {"gt_masks": jnp.asarray(gt[3], x.dtype)} if mask else {}
        losses, mut = jm.apply({**v, "params": params}, x,
                               *map(jnp.asarray, gt[:3]), key,
                               method="compute_loss", mutable=["batch_stats"],
                               **extra)
        return sum(losses.values()), (losses, mut)

    dets = jax.jit(jm.apply)(variables, jnp.asarray(x))
    (_, (losses, mut)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        [flat[k] for k in paths], variables, jnp.asarray(x), jax.random.PRNGKey(KEY))
    losses = {k: float(v) for k, v in losses.items()}
    grads = {_torch_name("params", k): np.asarray(g) for k, g in zip(paths, grads)}
    assert set(grads) == set(wanted)
    stats = {_torch_name("batch_stats", path): np.asarray(leaf)
             for path, leaf in _leaves(mut["batch_stats"])}
    xt = _nchw(x)
    with torch.no_grad():
        got_dets = port(xt)
    stats0 = _stats(port)
    got_losses, grads32, got_stats = _sampled_loss(port, xt, mask)
    return dict(mask=mask, port=port, dets=dets, got_dets=got_dets,
                losses=losses, got_losses=got_losses, grads=grads,
                got_grads=grads32, stats=stats, stats0=stats0,
                got_stats=got_stats)


def test_whole_v2_forward(whole):
    want, got = whole["dets"], whole["got_dets"]
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() >= 4
    np.testing.assert_array_equal(got.labels.numpy()[valid],
                                  np.asarray(want.labels)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], rtol=0, atol=1e-3)
    if whole["mask"]:
        assert got.masks.shape == (2, 10, 28, 28)
        np.testing.assert_allclose(got.masks.numpy()[valid],
                                   np.asarray(want.masks)[valid], rtol=0, atol=1e-4)


def test_whole_v2_compute_loss(whole):
    want = whole["losses"]
    assert set(whole["got_losses"]) == set(want)
    assert ("loss_mask" in want) == whole["mask"]
    for k, v in want.items():
        np.testing.assert_allclose(whole["got_losses"][k], v, rtol=1e-4, err_msg=k)


def test_whole_v2_gradients(whole):
    """The gradients of ``GRADS`` (and ``MASK_GRADS``) by relative
    Frobenius norm (module docstring)."""
    port = whole["port"]
    named = dict(port.named_parameters())
    for name in GRADS + (MASK_GRADS if whole["mask"] else ()):
        want = _to_torch_layout(name, whole["grads"][name], named[name], port)
        got = whole["got_grads"][name].numpy()
        assert np.abs(want).max() > 0, name
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 2e-2, (name, err)


def test_whole_v2_running_statistics(whole):
    """The trunk's and the box head's statistics move as JAX's do; the
    FPN's and the mask head's stay."""
    got, before, want = whole["got_stats"], whole["stats0"], whole["stats"]
    assert set(got) == set(want)
    frozen = ("backbone.fpn.", "roi_heads.mask_head.")
    for name, value in got.items():
        _close(value.numpy(), want[name], 1e-4)
        moved = not torch.equal(value, before[name])
        assert moved != name.startswith(frozen), name
    assert any(n.startswith("roi_heads.box_head.") for n in got)
    assert any(n.startswith("backbone.fpn.") for n in got)


# ---------------------------------------------------------------- builders

@pytest.mark.parametrize("name,params", [("fasterrcnn_resnet50_fpn_v2", 43_712_278),
                                         ("maskrcnn_resnet50_fpn_v2", 46_359_409)])
def test_builders(name, params):
    assert name in list_models()
    model = get_model(name, device="cpu")
    assert not model.training and model.v2
    assert sum(p.numel() for p in model.parameters()) == params
    enum = (FasterRCNN_ResNet50_FPN_V2_Weights if name.startswith("faster")
            else MaskRCNN_ResNet50_FPN_V2_Weights)
    assert enum.COCO_V1.meta["num_params"] == params
    assert enum.COCO_V1.value.url.endswith(("fasterrcnn_resnet50_fpn_v2_coco-dd69338a.pth",
                                      "maskrcnn_resnet50_fpn_v2_coco-73cbd019.pth"))
    sd = model.state_dict()
    assert _upgrade_state_dict(sd).keys() == sd.keys()


def test_v2_refuses_deform_stages():
    with pytest.raises(ValueError, match="frozen-BN v1 trunk"):
        FasterRCNN(backbone_depth=50, v2=True, deform_stages=(2, 3, 4))


def test_load_jax_variables_round_trips_the_v2_mask_rcnn():
    """Every leaf of the JAX v2 Mask R-CNN (ResNet-18, 91 classes) has a
    target in the port's and every port tensor a source; the port's state
    dict goes back through ``convert_torch_state_dict`` with
    ``_frcnn_hooks`` to the same leaves (``rpn.head.conv.1.0``,
    ``box_head.{i}.0/1``, ``box_head.5``, ``mask_head.{i}.0/1``, the FPN's
    ``inner_norm_{i}`` / ``layer_norm_{i}``)."""
    jm = JaxMaskRCNN(backbone_depth=18, v2=True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rs = np.random.RandomState(7)
    variables = jax.tree_util.tree_map(
        lambda s: rs.randn(*s.shape).astype(s.dtype), shapes)
    port = MaskRCNN(backbone_depth=18, v2=True)
    load_jax_variables(port, variables)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_torch_state_dict(sd, shapes, hooks=_frcnn_hooks)
    flat_back = dict(_leaves(jax.tree_util.tree_map(np.asarray, back)))
    flat = dict(_leaves(variables))
    assert flat_back.keys() == flat.keys()
    # conv5_mask: load_jax_variables flips the transposed convolution's
    # kernel (``_jax_convert``'s docstring), the JAX converter does not
    # (a fault of the JAX package, ROADMAP.md section 3)
    bad = [k for k, v in flat.items() if not np.array_equal(flat_back[k], v)]
    assert bad == [("params", "roi_heads.mask_predictor", "conv5_mask", "kernel")]
    assert "inner_norm_0" in variables["params"]["backbone"]["fpn"]
