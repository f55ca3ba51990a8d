"""Keypoint R-CNN parity: the port's keypoint head and predictor, the
transposed convolution's weight mapping, ``keypointrcnn_loss``, both
``heatmaps_to_keypoints`` rules and the whole model (plain PyTorch paths
on the CPU) against the JAX package.

As in ``test_torch_mask_rcnn.py``: the heads as modules at narrow widths
(2 layers of 16 features) with seeded, not symmetric transposed-convolution
kernels; the whole model on the small detector (ResNet-18 FPN, 2 classes,
17 keypoints, a 128x128 canvas, batch 2, G = 4 gt rows with padding rows,
RPN top-n 200/10 and 5 detections an image, so that few RoIs reach the
eight 512-wide convolutions), the JAX side under ``jit``, its sampler's
masks handed to the port.

Tolerances: modules 1e-5 relative to the largest value; the loss 1e-5
relative; ``heatmaps_to_keypoints`` on given heatmaps: keypoints within
1e-4 px and scores equal; the exact rule: keypoints within 1e-4 px, scores
within 1e-5 of the largest; eval keypoints of the valid rows within 1e-3
px of a 128 px canvas (the same argmax cells, mapped by a box 1e-4 px
apart) and their scores (heatmap logits) within 1e-4 of the largest;
gradients within 1e-3 of each tensor's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_detection_train import GT_BOXES, GT_VALID
from tests.test_torch_mask_rcnn import _module_pair, _rel_close, losses_and_grads
from vision_tpu._torch_convert import convert_torch_state_dict
from vision_tpu.models.detection import keypoint_rcnn as jkp
from vision_tpu.models.detection import roi_heads as jheads
from vision_tpu.models.detection.faster_rcnn import _frcnn_hooks
from vision_tpu_torch._jax_convert import (
    _leaves,
    _to_torch_layout,
    _torch_name,
    load_jax_variables,
)
from vision_tpu_torch.models import get_model
from vision_tpu_torch.models.detection import (
    GeneralizedRCNNTransform,
    KeypointRCNN_ResNet50_FPN_Weights,
)
from vision_tpu_torch.models.detection import keypoint_rcnn as tkp
from vision_tpu_torch.models.detection import roi_heads as theads
from vision_tpu_torch.models.detection.faster_rcnn import init_weights
from vision_tpu_torch.models.detection.roi_heads import SampledProposals
from vision_tpu_torch.parallel import make_detection_train_step
from vision_tpu_torch.tools.detection_request import (
    raw_images,
    seeded_keypoints,
    train_batch,
)

CFG = dict(backbone_depth=18, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=10,
           box_detections_per_img=5)
SIZE = 128
KEY = 3
# The image's seed. On seed 0, two pre-activations of the fifth conv of
# the keypoint head lie within f32 round-off of 0, and their ReLUs flip
# between two correct f32 paths: the port's f32 gradient of
# ``keypoint_head.0`` reads 1.2e-3 of its largest value from the same
# model in f64 (two flipped signs of 2.8 million), the JAX package's
# 1.1e-6. An instance without such a tie is chosen; the tolerance stays.
X_SEED = 1
GRADS = ("roi_heads.keypoint_head.0.weight",
         "roi_heads.keypoint_head.14.weight",
         "roi_heads.keypoint_predictor.kps_score_lowres.weight",
         "backbone.fpn.inner_blocks.0.0.weight")


# ---------------------------------------------------------------- modules


def test_keypoint_head_matches_jax():
    x = np.random.RandomState(0).randn(5, 7, 7, 8).astype(np.float32)
    port = theads.KeypointRCNNHeads(8, 2, 16)
    got, want, _ = _module_pair(jheads.KeypointRCNNHeads(layers=2, features=16),
                                port, x, 1)
    assert [n for n, _ in port.named_parameters()] == [
        "0.weight", "0.bias", "2.weight", "2.bias"]
    assert got.shape == (5, 7, 7, 16)
    _rel_close(got, want, 1e-5)


def test_keypoint_predictor_matches_jax():
    """The 4x4 stride-2 transposed convolution with flax's ``"SAME"``
    padding (torch's ``padding=1``), a kernel that is not symmetric, then
    the 2x bilinear upsample: within 1e-5."""
    x = np.random.RandomState(2).randn(5, 7, 7, 16).astype(np.float32)
    got, want, variables = _module_pair(jheads.KeypointRCNNPredictor(5),
                                        theads.KeypointRCNNPredictor(16, 5), x, 3)
    kernel = variables["params"]["kps_score_lowres"]["kernel"]
    assert not np.allclose(kernel, kernel[::-1]) and not np.allclose(
        kernel, kernel[:, ::-1])
    assert got.shape == (5, 28, 28, 5)
    _rel_close(got, want, 1e-5)


def test_jax_converter_maps_torch_kps_score_lowres_wrongly():
    """The JAX package's converter takes a torch ``ConvTranspose2d``
    weight ``(in, out, kh, kw)`` as OIHW and transposes it to ``(kh, kw,
    out, in)``; for ``kps_score_lowres`` (512 -> 17) that shape differs
    from flax's ``(kh, kw, in, out)``, and the converter reshapes it into
    place (``vision_tpu/_torch_convert.py:85-87``): the flax predictor
    computes another function than the torch one (a published Keypoint
    R-CNN checkpoint loads wrongly into the JAX package)."""
    torch.manual_seed(0)
    port = theads.KeypointRCNNPredictor(512, 17)
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    x = np.random.RandomState(4).randn(2, 7, 7, 512).astype(np.float32)
    jm = jheads.KeypointRCNNPredictor(17)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    converted = convert_torch_state_dict(sd, shapes)
    with torch.no_grad():
        want = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = want.numpy()
    got = np.asarray(jax.jit(jm.apply)(converted, jnp.asarray(x)))
    assert np.abs(got - want).max() > 0.1 * np.abs(want).max()
    w = sd["kps_score_lowres.weight"]
    fixed = jax.tree_util.tree_map(np.asarray, converted)
    fixed["params"]["kps_score_lowres"]["kernel"] = np.ascontiguousarray(
        w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
    right = np.asarray(jax.jit(jm.apply)(fixed, jnp.asarray(x)))
    _rel_close(right, want, 1e-5)


# ---------------------------------------------------------------- loss


def test_keypointrcnn_loss_matches_jax():
    """Seeded heatmap logits; sampled proposals that are the gt boxes
    themselves or around them; keypoints exactly on a box's right and
    bottom edges, invisible ones, ones outside the box; padded gt rows:
    within 1e-5 relative."""
    rng = np.random.RandomState(6)
    n, s, g, k, hm = 2, 10, 4, 17, 56
    matched = rng.randint(0, 2, (n, s))
    matched[:, :2] = [0, 1]
    boxes = GT_BOXES[np.arange(n)[:, None], matched] + rng.uniform(
        -6, 6, (n, s, 4)).astype(np.float32)
    boxes[:, :2] = GT_BOXES[:, :2]
    pos = np.zeros((n, s), bool)
    pos[:, :6] = True
    valid = np.zeros((n, s), bool)
    valid[:, :8] = True
    matched = np.where(pos, matched, 0)
    labels = pos.astype(np.int32)
    kp = seeded_keypoints(torch.from_numpy(GT_BOXES), torch.from_numpy(GT_VALID),
                          torch.Generator().manual_seed(0)).numpy()
    kp[:, :, 1, 1] = GT_BOXES[:, :, 3]  # on the bottom edge
    kp[:, :, 2, 0] = GT_BOXES[:, :, 0] - 3.0  # left of the box
    kp[:, :, 3, 1] = GT_BOXES[:, :, 3] + 2.0  # below it
    assert (kp[..., 2] == 0).any() and (kp[..., 2] > 0).any()
    logits = (rng.randn(n, s, hm, hm, k) * 2).astype(np.float32)
    arrays = (boxes.astype(np.float32), labels, np.zeros((n, s, 4), np.float32),
              pos, valid, matched)
    want = jax.jit(jheads.RoIHeadsLogic().keypointrcnn_loss)(
        jnp.asarray(logits), jheads.SampledProposals(*map(jnp.asarray, arrays)),
        jnp.asarray(kp))
    t = [torch.from_numpy(np.asarray(a)) for a in arrays]
    sampled = SampledProposals(t[0], t[1].long(), t[2], t[3], t[4], t[5].long())
    got = theads.keypointrcnn_loss(
        torch.from_numpy(logits).permute(0, 1, 4, 2, 3), sampled,
        torch.from_numpy(kp))
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------- heatmaps


def _heatmap_case(rng, d=6, k=17, hm=56):
    maps = rng.randn(d, hm, hm, k).astype(np.float32)
    xy = rng.uniform(-5, 100, (d, 2))
    wh = rng.uniform(0.3, 90, (d, 2))
    wh[0] = [0.5, 0.2]  # under a pixel: widths and heights clamp to 1
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return maps, boxes


def test_heatmaps_to_keypoints_matches_jax():
    maps, boxes = _heatmap_case(np.random.RandomState(7))
    want_kp, want_s = jax.jit(jkp.heatmaps_to_keypoints)(jnp.asarray(maps),
                                                         jnp.asarray(boxes))
    got_kp, got_s = tkp.heatmaps_to_keypoints(
        torch.from_numpy(maps).permute(0, 3, 1, 2), torch.from_numpy(boxes))
    assert got_kp.shape == (6, 17, 3) and got_s.shape == (6, 17)
    np.testing.assert_allclose(got_kp.numpy(), np.asarray(want_kp), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_heatmaps_to_keypoints_exact_matches_jax():
    maps, boxes = _heatmap_case(np.random.RandomState(8))
    want_kp, want_s = jkp.heatmaps_to_keypoints_exact(maps, boxes)
    got_kp, got_s = tkp.heatmaps_to_keypoints_exact(
        torch.from_numpy(maps).permute(0, 3, 1, 2), boxes)
    np.testing.assert_allclose(got_kp, want_kp, rtol=0, atol=1e-4)
    _rel_close(got_s, want_s, 1e-5)


# ---------------------------------------------------------------- model


def _gt():
    boxes = torch.from_numpy(GT_BOXES)
    valid = torch.from_numpy(GT_VALID)
    kp = seeded_keypoints(boxes, valid, torch.Generator().manual_seed(1))
    return boxes, valid.long(), valid, kp


@pytest.fixture(scope="module")
def pair():
    jm = jkp.KeypointRCNN(num_classes=2, **CFG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    src = tkp.KeypointRCNN(**CFG)
    init_weights(src, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    variables = jax.tree_util.tree_map(
        np.asarray, convert_torch_state_dict(sd, shapes, hooks=_frcnn_hooks))
    port = tkp.KeypointRCNN(**CFG).eval()
    load_jax_variables(port, variables)
    x = np.random.RandomState(X_SEED).rand(2, SIZE, SIZE, 3).astype(np.float32)
    gt = [jnp.asarray(np.asarray(t)) for t in _gt()]

    def loss_fn(params, v, x, key):
        losses = jm.apply({**v, "params": params}, x, *gt[:3], key,
                          gt_keypoints=gt[3], method="compute_loss")
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
    want = pair["dets"]
    with torch.no_grad():
        got = pair["port"](pair["x"])
    assert got.keypoints.shape == (2, 5, 17, 3)
    assert got.keypoints_scores.shape == (2, 5, 17)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 4
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], atol=1e-4)
    np.testing.assert_allclose(got.keypoints.numpy()[valid],
                               np.asarray(want.keypoints)[valid], rtol=0,
                               atol=1e-3)
    _rel_close(got.keypoints_scores.numpy()[valid],
               np.asarray(want.keypoints_scores)[valid], 1e-4)
    assert torch.isfinite(got.keypoints).all()


@pytest.fixture(scope="module")
def port_run(pair):
    boxes, labels, valid, kp = _gt()
    return losses_and_grads(pair["port"], pair["x"], (boxes, labels, valid),
                            jax.random.PRNGKey(KEY), gt_keypoints=kp)


def test_compute_loss_matches_jax(pair, port_run):
    losses, _ = port_run
    assert set(losses) == set(pair["losses"]) and "loss_keypoint" in losses
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
    """Every leaf of the JAX ``keypointrcnn_resnet50_fpn`` module
    (ResNet-50, 2 classes, 17 keypoints) has a target in the port's, of its
    shape, and every port tensor a source; the port has torchvision's
    59,137,258 parameters."""
    shapes = jax.eval_shape(jkp.KeypointRCNN(num_classes=2).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                       shapes)
    port = tkp.KeypointRCNN()
    load_jax_variables(port, variables)
    assert sum(p.numel() for p in port.parameters()) == 59_137_258


def test_get_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("keypointrcnn_resnet50_fpn")


def test_predictor_trains_after_an_inference_forward():
    """The upsample's resampling matrix is cached per size and device; one
    made under ``torch.inference_mode`` (a served request) must not be an
    inference tensor, or the next training step cannot save it for its
    backward pass."""
    port = theads.KeypointRCNNPredictor(8, 3)
    x = torch.rand(2, 8, 5, 5)
    with torch.inference_mode():
        served = port(x)
    out = port(x)
    out.sum().backward()
    torch.testing.assert_close(out.detach(), served)
    assert port.kps_score_lowres.weight.grad is not None


def test_detection_train_step_takes_keypoints():
    """``train_batch(..., keypoints=True)``: 17 keypoints inside each gt box
    (keypoint 0 on its right edge, some invisible), zero padding rows;
    through ``make_detection_train_step`` the five losses, finite, summed
    into ``loss``."""
    raw = raw_images(((48, 64), (43, 64)))
    transform = GeneralizedRCNNTransform(80, 133, device="cpu")
    with torch.no_grad():
        batch = train_batch(KeypointRCNN_ResNet50_FPN_Weights.COCO_V1.transforms(
            device="cpu"), transform, raw, num_classes=2, keypoints=True)
    kp, boxes, valid = batch["keypoints"], batch["boxes"], batch["valid"]
    assert kp.shape == (2, 8, 17, 3) and (batch["labels"][valid] == 1).all()
    assert not kp[~valid].any()
    inside = ((kp[..., 0] >= boxes[..., None, 0]) & (kp[..., 0] <= boxes[..., None, 2])
              & (kp[..., 1] >= boxes[..., None, 1]) & (kp[..., 1] <= boxes[..., None, 3]))
    assert inside[valid].all()
    assert (kp[..., 0, 0] == boxes[..., 2])[valid].all()
    assert (kp[..., 2][valid] == 0).any() and (kp[..., 2][valid] == 2).any()
    model = tkp.KeypointRCNN(**CFG)
    init_weights(model, torch.Generator().manual_seed(0))
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    out = make_detection_train_step(model, opt)(batch, torch.Generator().manual_seed(0))
    assert "loss_keypoint" in out and len(out) == 6
    assert all(torch.isfinite(v) for v in out.values())
    torch.testing.assert_close(out["loss"], sum(v for k, v in out.items()
                                                if k != "loss"))


def test_amp_train_step_matches_the_f32_step_on_the_same_samples():
    """The Keypoint R-CNN amp step (``compute_dtype=torch.bfloat16``) on
    ``train_batch(..., keypoints=True)``, its RoI head handed the f32 step's
    own samples (bf16 moves the proposals, and a proposal that moves changes
    the samples), both at lr 0 from the same weights and generator: the six
    losses within 3e-2 relative of the f32 step's (each layer rounds to bf16,
    2**-9, over some twenty layers; ``test_torch_detection_train.py`` derives
    the same bound), the gradients of ``GRADS`` f32 and within 0.25 of each
    one's largest value (bf16 carries a deep gradient some 0.1 of it from
    f32 in ``test_torch_detection_train.py``; a step that computed another
    function would lie at the order of the gradient itself), and not equal
    to the f32 step's: the step ran in bf16."""
    raw = raw_images(((48, 64), (43, 64)))
    transform = GeneralizedRCNNTransform(80, 133, device="cpu")
    with torch.no_grad():
        batch = train_batch(KeypointRCNN_ResNet50_FPN_Weights.COCO_V1.transforms(
            device="cpu"), transform, raw, num_classes=2, keypoints=True)
    model = tkp.KeypointRCNN(**CFG)
    init_weights(model, torch.Generator().manual_seed(0))
    heads = model.roi_heads
    select = heads.select_training_samples
    samples = []

    def once(*args):
        if not samples:
            samples.append(select(*args))
        return samples[0]

    heads.select_training_samples = once
    runs = []
    try:
        for dtype in (None, torch.bfloat16):
            opt = torch.optim.SGD(model.parameters(), lr=0.0)
            out = make_detection_train_step(model, opt, compute_dtype=dtype)(
                batch, torch.Generator().manual_seed(0))
            named = dict(model.named_parameters())
            runs.append(({k: float(v) for k, v in out.items()},
                         {n: named[n].grad.clone() for n in GRADS}))
    finally:
        del heads.select_training_samples
    (f32, g32), (bf16, g16) = runs
    assert "loss_keypoint" in bf16 and len(bf16) == 6
    assert all(np.isfinite(v) for v in bf16.values())
    for k, v in f32.items():
        _rel_close(bf16[k], v, 3e-2)
    assert any(bf16[k] != f32[k] for k in f32)
    for name in GRADS:
        assert g16[name].dtype == torch.float32
        scale = float(g32[name].abs().max())
        assert scale > 0
        assert float((g16[name] - g32[name]).abs().max()) <= 0.25 * scale
