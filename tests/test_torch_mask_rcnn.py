"""Mask R-CNN parity: the port's mask head and predictor, the transposed
convolution's weight mapping, ``paste_masks_in_image``, ``maskrcnn_loss``
and the whole model (plain PyTorch paths on the CPU) against the JAX
package.

The heads run as modules at narrow widths (2 layers of 16 features, a
7x7 input) with seeded weights whose transposed-convolution kernels are
not symmetric, so that a transposed or unflipped mapping shows. The whole
model is the small detector of ``test_torch_detection_train.py`` (ResNet-18
FPN, 6 classes, a 128x128 canvas, batch 2, G = 4 gt rows with padding
rows) with RPN top-n 200/10 and 5 detections an image, so that few RoIs
reach the 256-wide mask head; its weights are the port's seeded init
converted by the JAX package's own converter and loaded back with
``load_jax_variables``, so both sides run the same JAX variables (that
converter's mapping of the transposed convolution does not matter there,
and is pinned on its own below). The JAX side runs under ``jit``; its
sampler's masks are handed to the port (``JaxSampler``).

Tolerances: modules and ``paste_masks_in_image`` 1e-5 relative to the
largest value; losses 1e-5 relative (sums in another order); eval masks
of the valid rows 1e-4 absolute (probabilities, after the trunk, FPN and
heads in another summation order); gradients within 1e-3 of each
tensor's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_detection_train import GT_BOXES, GT_VALID, JaxSampler
from vision_tpu._torch_convert import convert_torch_state_dict
from vision_tpu.models.detection import _utils as jutils
from vision_tpu.models.detection import roi_heads as jheads
from vision_tpu.models.detection.faster_rcnn import _frcnn_hooks
from vision_tpu.models.detection.mask_rcnn import MaskRCNN as JaxMaskRCNN
from vision_tpu_torch._jax_convert import (
    _leaves,
    _to_torch_layout,
    _torch_name,
    load_jax_variables,
)
from vision_tpu_torch.models import get_model
from vision_tpu_torch.models.detection import (
    GeneralizedRCNNTransform,
    MaskRCNN_ResNet50_FPN_Weights,
)
from vision_tpu_torch.models.detection import roi_heads as theads
from vision_tpu_torch.models.detection.faster_rcnn import (
    _upgrade_state_dict,
    init_weights,
)
from vision_tpu_torch.models.detection.mask_rcnn import MaskRCNN
from vision_tpu_torch.models.detection.roi_heads import SampledProposals
from vision_tpu_torch.parallel import make_detection_train_step
from vision_tpu_torch.tools.detection_request import (
    ellipse_masks,
    raw_images,
    train_batch,
)

CFG = dict(backbone_depth=18, num_classes=6, rpn_pre_nms_top_n=200,
           rpn_post_nms_top_n=10, box_detections_per_img=5)
SIZE = 128
GT_LABELS = np.array([[1, 2, 5, 0], [3, 4, 0, 0]], np.int32)
KEY = 3
GRADS = ("roi_heads.mask_head.mask_fcn1.weight",
         "roi_heads.mask_head.mask_fcn4.weight",
         "roi_heads.mask_predictor.conv5_mask.weight",
         "roi_heads.mask_predictor.mask_fcn_logits.weight",
         "backbone.fpn.inner_blocks.0.0.weight")


def _rel_close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _random_variables(module, x, seed):
    """``module``'s flax parameters drawn from a seeded normal (biases
    too), as numpy arrays."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.2).astype(np.float32), shapes)


def _module_pair(jax_module, port_module, x, seed):
    variables = _random_variables(jax_module, jnp.asarray(x), seed)
    load_jax_variables(port_module, variables)
    want = np.asarray(jax.jit(jax_module.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port_module(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got.permute(0, 2, 3, 1).numpy(), want, variables


# ---------------------------------------------------------------- modules


def test_mask_head_matches_jax():
    x = np.random.RandomState(0).randn(5, 7, 7, 8).astype(np.float32)
    got, want, _ = _module_pair(jheads.MaskRCNNHeads(layers=2, features=16),
                                theads.MaskRCNNHeads(8, 2, 16), x, 1)
    assert got.shape == (5, 7, 7, 16)
    _rel_close(got, want, 1e-5)


def test_mask_predictor_matches_jax():
    """The 2x2 stride-2 transposed convolution (a kernel that is not
    symmetric in any axis) and the 1x1 logits: within 1e-5."""
    x = np.random.RandomState(2).randn(5, 7, 7, 16).astype(np.float32)
    port = theads.MaskRCNNPredictor(16, 256, 6)
    got, want, variables = _module_pair(jheads.MaskRCNNPredictor(6), port, x, 3)
    kernel = variables["params"]["conv5_mask"]["kernel"]
    assert not np.allclose(kernel, kernel[::-1]) and not np.allclose(
        kernel, kernel[:, ::-1])
    assert got.shape == (5, 14, 14, 6)
    _rel_close(got, want, 1e-5)


def test_jax_converter_maps_torch_conv5_mask_wrongly():
    """The JAX package's converter maps every 4-D torch weight as a
    convolution, OIHW -> HWIO (``vision_tpu/_torch_convert.py:76-77``). A
    ``torch.nn.ConvTranspose2d`` weight is ``(in, out, kh, kw)`` and flax
    applies its kernel unflipped, so a converted ``conv5_mask`` swaps in
    and out and drops the spatial flip: the flax predictor then computes
    another function than the torch one it was converted from (a published
    Mask R-CNN checkpoint loads wrongly into the JAX package). The mapping
    of ``load_jax_variables``, inverted, gives the torch function."""
    torch.manual_seed(0)
    port = theads.MaskRCNNPredictor(256, 256, 6)
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    x = np.random.RandomState(4).randn(3, 7, 7, 256).astype(np.float32)
    jm = jheads.MaskRCNNPredictor(6)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    converted = convert_torch_state_dict(sd, shapes)
    with torch.no_grad():
        want = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = want.numpy()
    got = np.asarray(jax.jit(jm.apply)(converted, jnp.asarray(x)))
    assert np.abs(got - want).max() > 0.1 * np.abs(want).max()
    w = sd["conv5_mask.weight"]  # (in, out, kh, kw) -> (kh, kw, in, out)
    fixed = jax.tree_util.tree_map(np.asarray, converted)
    fixed["params"]["conv5_mask"]["kernel"] = np.ascontiguousarray(
        w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
    right = np.asarray(jax.jit(jm.apply)(fixed, jnp.asarray(x)))
    _rel_close(right, want, 1e-5)


def test_mask_head_checkpoint_rename():
    """torchvision's ``mask_head.{i}.0`` names of a norm-free head go back
    to ``mask_fcn{i+1}``; the v2 head (norm keys ``{i}.1``) keeps them."""
    v1 = {"roi_heads.mask_head.0.0.weight": 1, "roi_heads.mask_head.3.0.bias": 2,
          "roi_heads.mask_predictor.conv5_mask.weight": 3}
    assert set(_upgrade_state_dict(v1)) == {
        "roi_heads.mask_head.mask_fcn1.weight",
        "roi_heads.mask_head.mask_fcn4.bias",
        "roi_heads.mask_predictor.conv5_mask.weight"}
    v2 = {"roi_heads.mask_head.0.0.weight": 1,
          "roi_heads.mask_head.0.1.weight": 2}
    assert set(_upgrade_state_dict(v2)) == set(v2)


# ---------------------------------------------------------------- paste


def test_paste_masks_in_image_matches_jax():
    """Boxes partly outside the image, under a pixel, with edges on integer
    coordinates, one degenerate: within 1e-5."""
    rng = np.random.RandomState(5)
    masks = rng.rand(8, 28, 28).astype(np.float32)
    boxes = np.array([
        [10.3, 5.7, 60.2, 40.9],  # inside
        [-15.0, -8.0, 30.0, 25.0],  # past the top left, integer edges
        [70.0, 50.0, 110.5, 90.0],  # past the bottom right
        [20.2, 20.4, 20.9, 21.1],  # under a pixel
        [33.0, 12.0, 34.0, 13.0],  # one pixel, integer edges
        [40.0, 40.0, 40.0, 40.0],  # degenerate
        [0.0, 0.0, 96.0, 72.0],  # the whole image
        [5.5, 60.0, 90.25, 71.75],
    ], np.float32)
    want = np.asarray(jax.jit(jheads.paste_masks_in_image,
                              static_argnums=(2, 3))(
        jnp.asarray(masks), jnp.asarray(boxes), 72, 96))
    got = theads.paste_masks_in_image(torch.from_numpy(masks),
                                      torch.from_numpy(boxes), 72, 96)
    assert got.shape == (8, 72, 96) and got.dtype == torch.float32
    _rel_close(got.numpy(), want, 1e-5)
    assert (want[3] > 0).any() and (want[1] > 0).any()


# ---------------------------------------------------------------- loss


def _sampled(rng, n=2, s=12, g=4):
    """Sampled proposals around the gt boxes (some the gt boxes
    themselves), positives matched to valid gt rows, negatives and padding
    rows matched to row 0, as ``select_training_samples`` gives them."""
    matched = rng.randint(0, 2, (n, s))
    matched[:, :2] = [0, 1]
    boxes = GT_BOXES[np.arange(n)[:, None], matched] + rng.uniform(
        -6, 6, (n, s, 4)).astype(np.float32)
    boxes[:, :2] = GT_BOXES[:, :2]
    pos = np.zeros((n, s), bool)
    pos[:, :5] = True
    valid = np.zeros((n, s), bool)
    valid[:, :9] = True
    matched = np.where(pos, matched, 0)
    labels = np.where(pos, GT_LABELS[np.arange(n)[:, None], matched], 0)
    targets = np.zeros((n, s, 4), np.float32)
    return boxes.astype(np.float32), labels, targets, pos, valid, matched


def test_maskrcnn_loss_matches_jax():
    """Seeded logits, sampled proposals and 0/1 gt masks with padded gt
    rows (zeros): within 1e-5 relative."""
    rng = np.random.RandomState(6)
    arrays = _sampled(rng)
    logits = (rng.randn(2, 12, 28, 28, 6) * 2).astype(np.float32)
    gt_masks = (rng.rand(2, 4, SIZE, SIZE) > 0.5).astype(np.float32)
    gt_masks[~GT_VALID] = 0.0
    want = jax.jit(jheads.RoIHeadsLogic().maskrcnn_loss)(
        jnp.asarray(logits), jheads.SampledProposals(*map(jnp.asarray, arrays)),
        jnp.asarray(gt_masks))
    t = [torch.from_numpy(np.asarray(a)) for a in arrays]
    sampled = SampledProposals(t[0], t[1].long(), t[2], t[3], t[4], t[5].long())
    got = theads.maskrcnn_loss(
        torch.from_numpy(logits).permute(0, 1, 4, 2, 3), sampled,
        torch.from_numpy(gt_masks))
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------- model


def _gt():
    boxes = torch.from_numpy(GT_BOXES)
    valid = torch.from_numpy(GT_VALID)
    return (boxes, torch.from_numpy(GT_LABELS).long(), valid,
            ellipse_masks(boxes, valid, (SIZE, SIZE)))


@pytest.fixture(scope="module")
def pair():
    jm = JaxMaskRCNN(**CFG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    src = MaskRCNN(**CFG)
    init_weights(src, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    variables = jax.tree_util.tree_map(
        np.asarray, convert_torch_state_dict(sd, shapes, hooks=_frcnn_hooks))
    port = MaskRCNN(**CFG).eval()
    load_jax_variables(port, variables)
    x = np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32)
    gt = [jnp.asarray(np.asarray(t)) for t in _gt()]

    def loss_fn(params, v, x, key):
        losses = jm.apply({**v, "params": params}, x, *gt[:3], key,
                          gt_masks=gt[3], method="compute_loss")
        return sum(losses.values()), losses

    dets = jax.jit(jm.apply)(variables, jnp.asarray(x))
    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables, jnp.asarray(x),
        jax.random.PRNGKey(KEY))
    grads = {_torch_name("params", path): leaf
             for path, leaf in _leaves(jax.tree_util.tree_map(np.asarray, grads))}
    return dict(port=port, x=torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                dets=dets, losses=losses, grads=grads)


def test_eval_matches_jax(pair):
    """Detections and the masks of the valid rows; every row, padding
    included, gets a finite mask."""
    want = pair["dets"]
    with torch.no_grad():
        got = pair["port"](pair["x"])
    assert got.masks.shape == (2, 5, 28, 28)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 4
    np.testing.assert_array_equal(got.labels.numpy()[valid],
                                  np.asarray(want.labels)[valid])
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], atol=1e-4)
    np.testing.assert_allclose(got.masks.numpy()[valid],
                               np.asarray(want.masks)[valid], rtol=0, atol=1e-4)
    assert torch.isfinite(got.masks).all()


def test_padding_rows_reach_the_mask_pooler_inside_the_pyramid(pair,
                                                               monkeypatch):
    """With a score threshold that leaves fewer valid detections than rows,
    the padding rows still carry boxes inside the canvas (candidates
    clipped to it, or zeros), so their windows pass the window pool's
    bounds check (the plain version raises on a window outside the
    pyramid, the kernel traps), and their masks are finite."""
    port = pair["port"]
    with torch.no_grad():
        scores = port(pair["x"]).scores
    monkeypatch.setattr(port.roi_heads, "score_thresh",
                        float(scores[0].sort().values[-2]) - 1e-6)
    with torch.no_grad():
        got = port(pair["x"])
    n_valid = got.valid.sum(1)
    assert 0 < int(n_valid[0]) < 5 and int(n_valid.sum()) < 10
    pad = ~got.valid
    assert (got.boxes[pad] >= 0).all() and (got.boxes[pad] <= SIZE).all()
    assert torch.isfinite(got.masks).all()


def losses_and_grads(port, x, gt, key, **extra):
    """The port's ``compute_loss`` with both samplers handed the masks the
    JAX samplers draw from ``key`` (split as ``compute_loss`` splits it),
    and the gradients of the summed losses."""
    k1, k2 = jax.random.split(key)
    port.zero_grad(set_to_none=True)
    samplers = port.rpn.sampler, port.roi_heads.sampler
    port.rpn.sampler = JaxSampler(
        jutils.BalancedPositiveNegativeSampler(256, 0.5), k1)
    port.roi_heads.sampler = JaxSampler(
        jutils.BalancedPositiveNegativeSampler(512, 0.25), k2)
    try:
        losses = port.compute_loss(x, *gt, None, **extra)
        sum(losses.values()).backward()
    finally:
        port.rpn.sampler, port.roi_heads.sampler = samplers
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    port.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


@pytest.fixture(scope="module")
def port_run(pair):
    boxes, labels, valid, masks = _gt()
    return losses_and_grads(pair["port"], pair["x"], (boxes, labels, valid),
                            jax.random.PRNGKey(KEY), gt_masks=masks)


def test_compute_loss_matches_jax(pair, port_run):
    losses, _ = port_run
    assert set(losses) == set(pair["losses"]) and "loss_mask" in losses
    for k, want in pair["losses"].items():
        np.testing.assert_allclose(losses[k], float(want), rtol=1e-5, err_msg=k)
    assert all(v > 0 for v in losses.values())


@pytest.mark.parametrize("name", GRADS)
def test_one_backward_matches_jax_grad(pair, port_run, name):
    """Within 1e-3 of the largest value of each gradient."""
    _, grads = port_run
    port = pair["port"]
    target = dict(port.named_parameters())[name]
    want = _to_torch_layout(name, pair["grads"][name], target, port)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(grads[name].numpy(), want, rtol=0,
                               atol=1e-3 * scale)


def test_load_jax_variables_covers_the_full_jax_model():
    """Every leaf of the JAX ``maskrcnn_resnet50_fpn`` module (ResNet-50,
    91 classes) has a target in the port's, of its shape, and every port
    tensor a source; the port has torchvision's 44,401,393 parameters."""
    shapes = jax.eval_shape(JaxMaskRCNN().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                       shapes)
    port = MaskRCNN()
    load_jax_variables(port, variables)
    assert sum(p.numel() for p in port.parameters()) == 44_401_393


def test_get_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("maskrcnn_resnet50_fpn")


def test_detection_train_step_takes_masks():
    """``train_batch(..., masks=True)`` (ellipses inscribed in the gt boxes,
    zero padding rows) through ``make_detection_train_step``: the five
    losses, finite, summed into ``loss``, and the mask head updated."""
    raw = raw_images(((48, 64), (43, 64)))
    transform = GeneralizedRCNNTransform(80, 133, device="cpu")
    with torch.no_grad():
        batch = train_batch(MaskRCNN_ResNet50_FPN_Weights.COCO_V1.transforms(
            device="cpu"), transform, raw, num_classes=6, masks=True)
    masks, valid = batch["masks"], batch["valid"]
    assert masks.shape == (2, 8, 160, 160)
    assert (masks.sum((2, 3)) > 0).eq(valid).all() and (masks <= 1).all()
    model = MaskRCNN(**CFG)
    init_weights(model, torch.Generator().manual_seed(0))
    before = model.roi_heads.mask_head.mask_fcn1.weight.detach().clone()
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    out = make_detection_train_step(model, opt)(batch, torch.Generator().manual_seed(0))
    assert set(out) == {"loss", "loss_objectness", "loss_rpn_box_reg",
                        "loss_classifier", "loss_box_reg", "loss_mask"}
    assert all(torch.isfinite(v) for v in out.values())
    torch.testing.assert_close(out["loss"], sum(v for k, v in out.items()
                                                if k != "loss"))
    assert not torch.equal(before, model.roi_heads.mask_head.mask_fcn1.weight)
