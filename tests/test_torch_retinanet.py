"""RetinaNet parity: the port (``vision_tpu_torch``, plain PyTorch paths on
the CPU) against the JAX package (``vision_tpu``, JAX on the CPU), module
by module and whole, v1 and v2, with the same inputs and weights.

Inputs come from numpy seeds. The whole-model weights are drawn by the
port's seeded init, converted to flax variables by the JAX package's own
converter (``convert_torch_state_dict`` with ``_retinanet_hooks``) and
loaded back into a fresh port model with ``load_jax_variables``, so both
sides run JAX's variables. The whole models are ResNet-18 RetinaNets (5
classes, two 128x160 images, the JAX side jitted once per function in
module fixtures); one ResNet-50 v2 forward in training mode holds the
live-BN bottleneck trunk and its statistics.

Tolerances, each against the largest magnitude of the compared tensor
unless said otherwise:
- modules (P6/P7, the towers, GroupNorm in them): 1e-5 (f32 sums in
  another order);
- anchors and top-k indices: exactly equal; top-k values exactly equal;
- losses of ``ops/losses.py``: 1e-6 relative, 1e-7 absolute (elementwise
  f32);
- postprocess: valid masks and labels exactly equal, scores 1e-6, boxes
  1e-3 px (f32 decoding through ``exp``);
- ``compute_loss`` on the same head outputs: 1e-5 relative; its gradients
  1e-5;
- whole models: head outputs 1e-4 (a deep f32 net); losses 1e-4
  relative; running statistics 1e-4; the port's f32 gradients within
  1e-4 of the JAX function's gradients evaluated in f64 (under
  ``jax.enable_x64``). An f32 gradient of a randomly initialised net is
  not a sharp reference here: a pre-activation within f32 round-off of a
  ReLU kink, and v2's batch norm over two small maps, move it. At image
  seeds 0-7 the port's own f32 gradients of the v2 model lay 3.7e-4 to
  5.5e-2 from its f64 ones, but at seed 4, the one taken, within 1e-5;
  there JAX's f32 gradients lie 1.5e-3 from the f64 ones, and the two
  f64 evaluations within 5e-6 of each other;
- the ResNet-50 v2 forward in training mode: head outputs 1e-3, running
  statistics 1e-4. Its batch norm over one 128x160 image (20 values a
  channel at C5) leaves the port's own f32 outputs 1.7e-4 to 3.3e-4 from
  its f64 ones at seeds 0-4;
- the amp (bf16) step against the f32 step: each loss and gradient within
  twice the JAX amp step's own distance from the JAX f32 step (plus 1e-3
  of the f32 value, for a distance that happens to be small on the JAX
  side). The port computes the focal loss in f32 where the JAX amp step
  takes the sigmoid and ``log1p(exp)`` of the bf16 logits in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu._torch_convert import convert_torch_state_dict
from vision_tpu.models.detection import _utils as jutils
from vision_tpu.models.detection.retinanet import RetinaNet as JaxRetinaNet
from vision_tpu.models.detection.retinanet import RetinaNetHead as JaxHead
from vision_tpu.models.detection.retinanet import _default_anchorgen as jax_anchorgen
from vision_tpu.models.detection.retinanet import _retinanet_hooks
from vision_tpu.ops import _topk as jtopk
from vision_tpu.ops import losses as jlosses
from vision_tpu.ops.boxes import box_iou as jax_box_iou
from vision_tpu.ops.feature_pyramid_network import LastLevelP6P7 as JaxP6P7
from vision_tpu_torch._jax_convert import (
    _leaves,
    _to_torch_layout,
    _torch_name,
    load_jax_variables,
)
from vision_tpu_torch.models import get_model
from vision_tpu_torch.models.detection import _utils as tutils
from vision_tpu_torch.models.detection.retinanet import (
    RetinaNet,
    RetinaNetHead,
    _default_anchorgen,
    _upgrade_state_dict,
    init_retinanet_weights,
)
from vision_tpu_torch.ops import losses as tlosses
from vision_tpu_torch.ops._topk import top_k, top_k_2d
from vision_tpu_torch.ops.boxes import box_iou
from vision_tpu_torch.ops.feature_pyramid_network import LastLevelP6P7
from vision_tpu_torch.ops.misc import BatchNorm2d
from vision_tpu_torch.parallel import make_detection_train_step
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

H, W = 128, 160
CLASSES = 5
# two images, G = 3, padding rows (zeros, invalid) last
GT_BOXES = np.array([
    [[10, 12, 60, 70], [30, 40, 100, 120], [70, 5, 150, 50]],
    [[5, 5, 40, 30], [50, 60, 127, 110], [0, 0, 0, 0]],
], np.float32)
GT_LABELS = np.array([[1, 2, 4], [3, 4, 0]], np.int32)
GT_VALID = np.array([[1, 1, 1], [1, 1, 0]], bool)
# the gradients compared: a tower conv of each head, each predictor, an FPN
# lateral conv, P6, and a conv of the first and last trunk stages
GRADS = ("head.classification_head.conv.0.0.weight",
         "head.classification_head.cls_logits.weight",
         "head.regression_head.conv.3.0.weight",
         "head.regression_head.bbox_reg.weight",
         "backbone.fpn.inner_blocks.1.0.weight",
         "backbone.fpn.extra_blocks.p6.weight",
         "backbone.body.layer1.0.conv1.weight",
         "backbone.body.layer4.1.conv2.weight")


def _close(got, want, rel):
    """``got`` within ``rel`` of the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{err} > {rel}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _gt_torch():
    return (torch.from_numpy(GT_BOXES), torch.from_numpy(GT_LABELS).long(),
            torch.from_numpy(GT_VALID))


def _gt_jax():
    return jnp.asarray(GT_BOXES), jnp.asarray(GT_LABELS), jnp.asarray(GT_VALID)


# ------------------------------------------------------------------ modules

@pytest.mark.parametrize("use_p5", [True, False], ids=["p5", "c5"])
def test_last_level_p6p7(use_p5):
    rs = np.random.RandomState(1)
    out_c, c5_c = 16, 32
    results = [rs.randn(2, s, s + 2, out_c).astype(np.float32) for s in (16, 8, 4)]
    x = [rs.randn(2, s, s + 2, c).astype(np.float32)
         for s, c in ((16, 8), (8, 16), (4, c5_c))]
    jm = JaxP6P7(out_channels=out_c, use_P5=use_p5)
    variables = jm.init(jax.random.PRNGKey(0), list(results), list(x), ["0", "1", "2"])
    jout, jnames = jm.apply(variables, list(results), list(x), ["0", "1", "2"])
    port = LastLevelP6P7(out_c if use_p5 else c5_c, out_c)
    assert port.use_P5 == use_p5
    load_jax_variables(port, jax.tree_util.tree_map(np.asarray, variables))
    with torch.no_grad():
        tout, tnames = port([_nchw(r) for r in results], [_nchw(a) for a in x],
                            ["0", "1", "2"])
    assert tnames == jnames == ["0", "1", "2", "p6", "p7"]
    assert tuple(tout[-1].shape[-2:]) == (1, 2)
    for a, b in zip(tout[3:], jout[3:]):
        _close(a.permute(0, 2, 3, 1).numpy(), b, 1e-5)


@pytest.mark.parametrize("use_norm", [False, True], ids=["v1", "v2"])
def test_head(use_norm):
    rs = np.random.RandomState(2)
    ch = 64  # GroupNorm(32) needs channels in multiples of 32
    feats = [rs.randn(2, s, s + 1, ch).astype(np.float32) for s in (8, 4, 2, 1)]
    jm = JaxHead(num_anchors=9, num_classes=CLASSES, use_norm=use_norm)
    variables = jm.init(jax.random.PRNGKey(0), feats)
    # spread the GroupNorm affine terms away from their identity init
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: v + rs.randn(*v.shape).astype(np.float32) * 0.3
        if ".1" in str(p[-2]) else np.asarray(v), variables)
    jc, jr = jm.apply(variables, feats)
    port = RetinaNetHead(ch, 9, CLASSES, use_norm=use_norm)
    load_jax_variables(port, jax.tree_util.tree_map(np.asarray, variables))
    assert sum(p.numel() for p in port.parameters()) == sum(
        v.size for v in jax.tree_util.tree_leaves(variables))
    with torch.no_grad():
        tc, tr = port([_nchw(f) for f in feats])
    for a, b in zip(tc + tr, list(jc) + list(jr)):
        _close(a.numpy(), b, 1e-5)


@pytest.mark.parametrize("image,sizes", [
    ((H, W), [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]),
    ((1344, 1344), [(168, 168), (84, 84), (42, 42), (21, 21), (11, 11)]),
], ids=["128x160", "1344"])
def test_anchor_generator(image, sizes):
    want = jax_anchorgen()(image, sizes)
    got = _default_anchorgen()(image, sizes, torch.device("cpu"))
    assert _default_anchorgen().num_anchors_per_location() == [9] * 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if image == (1344, 1344):
        assert sum(a.shape[0] for a in got) == 338_454


@pytest.mark.parametrize("shape,k,ties", [
    ((300, 7), 50, True),     # rows decomposed, many exact ties
    ((300, 7), 299, True),
    ((300, 7), 20, False),    # distinct values: the JAX indices exactly
    ((40, 91), 1000, False),  # k >= R: the full top-k
    ((200, 1), 30, True),     # K == 1
], ids=["ties", "ties_k_near_r", "distinct", "k_ge_r", "one_column"])
def test_top_k_2d(shape, k, ties):
    rs = np.random.RandomState(3)
    if ties:
        x = (rs.randint(0, 6, shape) / 5.0).astype(np.float32)
    else:
        x = rs.rand(*shape).astype(np.float32)
    vals, idx = top_k_2d(torch.from_numpy(x), k)
    fv, fi = top_k(torch.from_numpy(x).reshape(-1), k)
    # the port's contract: the flat top-k's values and indices, ties by index
    assert torch.equal(vals, fv) and torch.equal(idx, fi)
    # batched over a leading dim: each row as alone
    xb = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    bv, bi = top_k_2d(xb, k)
    for i in range(2):
        rv, ri = top_k(xb[i].reshape(-1), k)
        assert torch.equal(bv[i], rv) and torch.equal(bi[i], ri)
    jv, ji = jtopk.top_k_2d(jnp.asarray(x), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(x.reshape(-1)[idx.numpy()], vals.numpy())
    if not ties:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


# ------------------------------------------------------------------- losses

def _loss_inputs():
    rs = np.random.RandomState(4)
    logits = (rs.randn(6, 11) * 3).astype(np.float32)
    targets = (rs.rand(6, 11) < 0.3).astype(np.float32)

    def boxes(n):
        xy = rs.rand(n, 2) * 50
        return np.concatenate([xy, xy + 1 + rs.rand(n, 2) * 40], 1).astype(np.float32)

    return logits, targets, boxes(12).reshape(3, 4, 4), boxes(12).reshape(3, 4, 4)


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("name", ["sigmoid_focal_loss", "generalized_box_iou_loss",
                                  "complete_box_iou_loss", "distance_box_iou_loss"])
def test_losses(name, reduction):
    logits, targets, b1, b2 = _loss_inputs()
    args = (logits, targets) if name == "sigmoid_focal_loss" else (b1, b2)
    got = getattr(tlosses, name)(*map(torch.from_numpy, args), reduction=reduction)
    want = getattr(jlosses, name)(*map(jnp.asarray, args), reduction=reduction)
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_focal_loss_promotes_bf16_logits_to_f32():
    logits, targets, _, _ = _loss_inputs()
    got = tlosses.sigmoid_focal_loss(torch.from_numpy(logits).bfloat16(),
                                     torch.from_numpy(targets))
    assert got.dtype == torch.float32
    with pytest.raises(ValueError, match="invalid reduction"):
        tlosses.sigmoid_focal_loss(torch.from_numpy(logits),
                                   torch.from_numpy(targets), reduction="max")


# -------------------------------------------------- postprocess and the loss

def _head_outputs(num_classes, seed):
    """Seeded per-level head outputs at 128x160 (logits around the score
    threshold's log-odds, so that some hundreds of candidates pass) and
    the anchors."""
    rs = np.random.RandomState(seed)
    sizes = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
    anchors = [np.asarray(a) for a in jax_anchorgen()((H, W), sizes)]
    cls = [(rs.randn(2, a.shape[0], num_classes) - 5.0).astype(np.float32)
           for a in anchors]
    reg = [(rs.randn(2, a.shape[0], 4) * 0.3).astype(np.float32) for a in anchors]
    return cls, reg, anchors


@pytest.fixture(scope="module")
def small_jax():
    """A JAX ResNet-18 RetinaNet's variables, for the methods that use
    none of them."""
    jm = JaxRetinaNet(backbone_depth=18, num_classes=CLASSES)
    return jm, jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, H, W, 3)))


@pytest.mark.parametrize("num_classes", [CLASSES, 91])
def test_postprocess_detections(num_classes):
    cls, reg, anchors = _head_outputs(num_classes, 5)
    jm = JaxRetinaNet(backbone_depth=18, num_classes=num_classes)
    want = jax.jit(lambda c, r, a: jm.apply(
        {}, c, r, a, (H, W), method=lambda m, *xs: m.postprocess_detections(*xs)))(
            cls, reg, anchors)
    port = RetinaNet(backbone_depth=18, num_classes=num_classes)
    got = port.postprocess_detections(
        [torch.from_numpy(c) for c in cls], [torch.from_numpy(r) for r in reg],
        [torch.tensor(a) for a in anchors], (H, W))
    valid = np.asarray(want.valid)
    assert valid.sum(1).min() > 50
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy()[valid],
                                  np.asarray(want.labels)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], rtol=0, atol=1e-3)
    assert got.boxes.shape == (2, 300, 4) and got.boxes.dtype == torch.float32


@pytest.mark.parametrize("num_classes", [CLASSES, 91])
def test_compute_loss_and_its_gradient(num_classes):
    cls, reg, anchors = _head_outputs(num_classes, 6)
    jm = JaxRetinaNet(backbone_depth=18, num_classes=num_classes)

    def jloss(c, r):
        out = jm.apply({}, c, r, anchors, *_gt_jax(),
                       method=lambda m, *xs: m.compute_loss(*xs))
        return out["classification"] + out["bbox_regression"], out

    (_, want), (gc, gr) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                     has_aux=True))(cls, reg)
    port = RetinaNet(backbone_depth=18, num_classes=num_classes)
    tc = [torch.from_numpy(c).requires_grad_() for c in cls]
    tr = [torch.from_numpy(r).requires_grad_() for r in reg]
    got = port.compute_loss(tc, tr, [torch.tensor(a) for a in anchors],
                            *_gt_torch())
    (got["classification"] + got["bbox_regression"]).backward()
    for k in ("classification", "bbox_regression"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5)
    for a, b in zip(tc + tr, list(gc) + list(gr)):
        _close(a.grad.numpy(), b, 1e-5)


def test_matcher_and_coder_at_the_1344_canvas():
    """``Matcher(0.5, 0.4, allow_low_quality_matches=True)`` and
    ``BoxCoder((1, 1, 1, 1))`` at RetinaNet's 338,454 anchors an image:
    the same matches from the same IoU matrix, exactly; the port's IoU
    within 1e-6 of JAX's; the foreground anchors' deltas within 1e-5
    relative."""
    sizes = [(168, 168), (84, 84), (42, 42), (21, 21), (11, 11)]
    anchors = np.concatenate([np.asarray(a) for a in jax_anchorgen()((1344, 1344), sizes)])
    rs = np.random.RandomState(7)
    xy = rs.rand(2, 8, 2) * 1000
    gt = np.concatenate([xy, xy + 20 + rs.rand(2, 8, 2) * 300], -1).astype(np.float32)
    valid = np.ones((2, 8), bool)
    valid[1, 5:] = False
    gt[~valid] = 0
    iou = box_iou(torch.from_numpy(gt), torch.from_numpy(anchors))
    jiou = jax.vmap(lambda b: jax_box_iou(b, jnp.asarray(anchors)))(jnp.asarray(gt))
    _close(iou.numpy(), jiou, 1e-6)
    tm = tutils.Matcher(0.5, 0.4, allow_low_quality_matches=True)(
        iou, valid_gt=torch.from_numpy(valid))
    jmatch = jax.vmap(jutils.Matcher(0.5, 0.4, allow_low_quality_matches=True))(
        jnp.asarray(iou.numpy()), valid_gt=jnp.asarray(valid))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jmatch))
    fg = tm >= 0
    assert int(fg.sum()) > 0 and int((tm == tutils.BETWEEN_THRESHOLDS).sum()) > 0
    matched = np.take_along_axis(gt, tm.clamp(min=0).numpy()[..., None], 1)
    coder = tutils.BoxCoder((1.0, 1.0, 1.0, 1.0))
    got = coder.encode(torch.from_numpy(matched),
                       torch.from_numpy(anchors).expand(2, -1, -1))[fg]
    want = np.asarray(jutils.BoxCoder((1.0, 1.0, 1.0, 1.0)).encode(
        jnp.asarray(matched), jnp.asarray(anchors)))[fg.numpy()]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- whole models

def _pair(v2, depth=18, num_classes=CLASSES):
    """A JAX RetinaNet and a port model with the same variables."""
    cfg = dict(backbone_depth=depth, num_classes=num_classes)
    jm = JaxRetinaNet(**cfg, use_head_norm=v2, use_p5_for_p6=not v2,
                      frozen_backbone_bn=not v2)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    src = RetinaNet(**cfg, v2=v2)
    init_retinanet_weights(src, torch.Generator().manual_seed(0))
    with torch.no_grad():  # running statistics away from the identity
        for name, b in src.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(len(name)))
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(len(name)))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    variables = jax.tree_util.tree_map(
        np.asarray, convert_torch_state_dict(sd, shapes, hooks=_retinanet_hooks))
    port = RetinaNet(**cfg, v2=v2).eval()
    load_jax_variables(port, variables)
    return jm, variables, port


def _images(seed=4, n=2):
    return np.random.RandomState(seed).rand(n, H, W, 3).astype(np.float32)


def _jax_steps(jm, variables, x, v2):
    """The JAX forward in eval mode, and the summed train-mode loss, the
    losses and the gradients, in f32 and in the recipe's amp (parameters,
    frozen constants and image cast to bf16, batch statistics f32; the new
    statistics of the f32 train-mode forward); and the gradients in f64."""
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}

    def cast(tree, dtype):
        return jax.tree_util.tree_map(lambda a: a.astype(dtype), tree)

    def loss_fn(p, rest, x):
        v = {"params": p, **rest}
        if v2:
            outs, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
        else:
            outs, mut = jm.apply(v, x, train=True), {}
        losses = jm.apply(v, *outs, *_gt_jax(),
                          method=lambda m, *xs: m.compute_loss(*xs))
        return sum(l.astype(jnp.float32) for l in losses.values()), (losses, mut)

    grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (losses, mut)), grads = grad(params, rest, jnp.asarray(x))
    amp_rest = {k: (v if k == "batch_stats" else cast(v, jnp.bfloat16))
                for k, v in rest.items()}
    (_, (losses16, _)), grads16 = grad(cast(params, jnp.bfloat16), amp_rest,
                                       jnp.asarray(x, jnp.bfloat16))
    heads = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    with jax.enable_x64(True):
        _, grads64 = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            cast(params, jnp.float64), cast(rest, jnp.float64),
            jnp.asarray(x, jnp.float64))
        grads64 = jax.tree_util.tree_map(np.asarray, grads64)
    return dict(heads=heads, losses=losses, grads=grads, stats=mut,
                losses16=losses16, grads16=grads16, grads64=grads64)


def _by_torch_name(tree, collection="params"):
    """A flax collection's leaves under the port's names (the mapping of
    ``load_jax_variables``)."""
    return {_torch_name(collection, path): np.asarray(v, np.float32)
            for path, v in _leaves(tree)}


def _jax_grad(grads, name, port):
    """The JAX gradient of port parameter ``name``, in the port's layout."""
    g = _by_torch_name(grads)[name]
    return _to_torch_layout(name, g, dict(port.named_parameters())[name], port)


def _port_step(port, x, dtype=None):
    """One port train step (lr 0, so the weights stay) through
    ``make_detection_train_step(one_stage=True)``: its losses and the
    gradients of ``GRADS``."""
    params = [p for p in port.parameters() if p.requires_grad]
    step = make_detection_train_step(port, torch.optim.SGD(params, lr=0.0),
                                     compute_dtype=dtype, one_stage=True)
    boxes, labels, valid = _gt_torch()
    out = step({"image": _nchw(x), "boxes": boxes, "labels": labels,
                "valid": valid})
    named = dict(port.named_parameters())
    return ({k: float(v) for k, v in out.items()},
            {n: named[n].grad.clone() for n in GRADS})


def _live_stats(port):
    """Copies of the running statistics of the live batch norms."""
    return {f"{mn}.{bn}": b.clone() for mn, m in port.named_modules()
            if isinstance(m, BatchNorm2d)
            for bn, b in m.named_buffers(recurse=False) if "running" in bn}


@pytest.fixture(scope="module", params=[False, True], ids=["v1", "v2"])
def whole(request):
    v2 = request.param
    jm, variables, port = _pair(v2)
    x = _images()
    want = _jax_steps(jm, variables, x, v2)
    with torch.no_grad():
        heads = port(_nchw(x))
    stats0 = _live_stats(port)
    losses, grads = _port_step(port, x)
    stats = _live_stats(port)
    with torch.no_grad():  # back to the loaded statistics
        for n, b in port.named_buffers():
            if n in stats0:
                b.copy_(stats0[n])
    losses16, grads16 = _port_step(port, x, torch.bfloat16)
    return dict(v2=v2, want=want, heads=heads, losses=losses, grads=grads,
                stats0=stats0, stats=stats, losses16=losses16, grads16=grads16,
                port=port)


def test_whole_model_forward(whole):
    jc, jr, ja = whole["want"]["heads"]
    tc, tr, ta = whole["heads"]
    for a, b in zip(tc + tr, list(jc) + list(jr)):
        _close(a.numpy(), b, 1e-4)
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_whole_model_loss_and_gradient(whole):
    want = whole["want"]
    for k in ("classification", "bbox_regression"):
        np.testing.assert_allclose(whole["losses"][k], float(want["losses"][k]),
                                   rtol=1e-4)
    for n in GRADS:
        _close(whole["grads"][n].numpy(),
               _jax_grad(want["grads64"], n, whole["port"]), 1e-4)


def test_whole_model_batch_statistics(whole):
    """v2: the train step's forward updates every running statistic, in
    the frozen stages too, as JAX's train-mode forward does; v1 has
    none."""
    if not whole["v2"]:
        assert not whole["stats"]
        return
    want = _by_torch_name(whole["want"]["stats"]["batch_stats"], "batch_stats")
    assert set(want) == set(whole["stats"])
    for name, got in whole["stats"].items():
        _close(got.numpy(), want[name], 1e-4)
        assert not torch.equal(got, whole["stats0"][name])


def test_amp_step_against_f32_step(whole):
    """The port's bf16 step against its f32 step, within twice the JAX amp
    step's distance from the JAX f32 step (plus 1e-3)."""
    want = whole["want"]
    for k in ("classification", "bbox_regression"):
        jax_dist = abs(float(want["losses16"][k]) - float(want["losses"][k]))
        tol = 2 * jax_dist + 1e-3 * abs(float(want["losses"][k]))
        assert abs(whole["losses16"][k] - whole["losses"][k]) <= tol, k
    for n in GRADS:
        j32 = _jax_grad(want["grads"], n, whole["port"])
        j16 = _jax_grad(want["grads16"], n, whole["port"])
        scale = np.abs(j32).max()
        jax_dist = np.abs(j16 - j32).max() / scale
        dist = np.abs(whole["grads16"][n].numpy() - whole["grads"][n].numpy()).max() / scale
        assert dist <= 2 * jax_dist + 1e-3, (n, dist, jax_dist)


def test_v2_resnet50_train_forward_and_statistics():
    """The ResNet-50 v2 trunk (``models/resnet.py``'s bottlenecks with live
    batch norm) in training mode: the head outputs of one image and the
    updated running statistics against JAX's."""
    jm, variables, port = _pair(True, depth=50)
    x = _images(0, n=1)
    (jc, jr, _), mut = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    port.train()
    with torch.no_grad():
        tc, tr, _ = port(_nchw(x))
    for a, b in zip(tc + tr, list(jc) + list(jr)):
        _close(a.numpy(), b, 1e-3)
    got = port.backbone.body.layer3[5].bn3.running_var.numpy()
    _close(got, mut["batch_stats"]["backbone"]["body"]["layer3"]["5"]["bn3"]["var"],
           1e-4)


def test_builders_and_state_dicts():
    """Both builders on the CPU; torchvision's v1 head layout loads through
    ``_upgrade_state_dict``; the parameter counts are torchvision's."""
    v1 = get_model("retinanet_resnet50_fpn", device="cpu")
    v2 = get_model("retinanet_resnet50_fpn_v2", device="cpu")
    assert not v1.training and not v2.training
    assert sum(p.numel() for p in v1.parameters()) == 34_014_999
    assert sum(p.numel() for p in v2.parameters()) == 38_198_935
    sd = v1.state_dict()
    old = {}
    for k, v in sd.items():  # the pre-0.13 layout, and an anchors buffer
        k = k.replace(".conv.2.0.", ".conv.2.")
        old[k] = v
    old["anchor_generator.anchors"] = torch.zeros(3)
    assert "head.classification_head.conv.2.weight" in old
    up = _upgrade_state_dict(old)
    assert set(up) == set(sd)
    fresh = RetinaNet()
    fresh.load_state_dict(up)
    assert torch.equal(fresh.head.classification_head.conv[2][0].weight,
                       v1.head.classification_head.conv[2][0].weight)
    assert "backbone.fpn.extra_blocks.p6.weight" in sd
    assert "head.classification_head.conv.0.1.weight" in v2.state_dict()
    assert float(v1.head.classification_head.cls_logits.bias[0].detach()) == pytest.approx(
        -np.log(99.0))
