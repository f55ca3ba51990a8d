"""``maskrcnn_resnet50_fpn_deform`` parity: the port's deformable-trunk Mask
R-CNN (plain PyTorch paths on the CPU) against the JAX package's, served
and one train step, with offsets that are not zero.

The model is ResNet-50-FPN with deformable 3x3s in C3-C5 (13 of them), 5
classes, a 128x128 canvas, batch 2, G = 4 gt rows with padding rows, RPN
top-n 200/10 and 5 detections an image. Its weights are the port's seeded
init with every offset predictor drawn by ``seed_offsets`` (offsets of RMS
about 1 px on the test images) and the mask logits' weight scaled by
``MASK_LOGIT_SCALE`` (at this random init the logits' RMS is ~60, so the
probabilities saturate), converted by the JAX package's own
converter and loaded back with ``load_jax_variables``, so both sides run
the same JAX variables. The JAX side runs under ``jit``, once a module;
its samplers' masks are handed to the port (``JaxSampler``).

Tolerances: detections' boxes within 1e-3 px and scores within 1e-4, the
masks of the valid rows within 1e-4 (probabilities, after a trunk whose
sample positions move with its own round-off); losses within 1e-5
relative; gradients within 1e-3 of each tensor's largest value (f32
backward passes of a deep net in another order), and the port's f32
gradients within 1e-4 of its own f64 ones.

The test images are chosen (``IMAGE_SEED``). A randomly initialised
ResNet-50 with the identity for its batch norms has, on most inputs, some
pre-activation within f32 round-off of a ReLU's kink (at image seed 1, one
at 2.2e-8 of its layer's largest value), where either library's f32
arithmetic may take the other side: the gradient of every stage below it
then moves by 1e-3 to 9e-3 of its largest value (image seeds 0, 1, 3, 4
and 6; at seed 0 the port's own gradient moved by 3e-3 under a 1e-6
perturbation of the images, and at seed 1 the JAX gradient lay 1.9e-3 from
the port's f64 one while the port's f32 one lay 5e-6 from it). At those
seeds the op itself, fed each of the 13 calls' inputs and output gradients
as the port recorded them, agreed with ``jax.vjp`` within 1e-6. At seed 5
nothing sits that close to a kink.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_detection_train import GT_BOXES, GT_VALID, JaxSampler
from vision_tpu._torch_convert import convert_torch_state_dict
from vision_tpu.models.detection import _utils as jutils
from vision_tpu.models.detection.faster_rcnn import _frcnn_hooks
from vision_tpu.models.detection.mask_rcnn import MaskRCNN as JaxMaskRCNN
from vision_tpu_torch._jax_convert import (
    _leaves,
    _to_torch_layout,
    _torch_name,
    load_jax_variables,
)
from vision_tpu_torch.models import get_model, list_models
from vision_tpu_torch.models.detection import (
    MaskRCNN_ResNet50_FPN_Weights,
    maskrcnn_resnet50_fpn_deform,
)
from vision_tpu_torch.models.detection.faster_rcnn import init_weights
from vision_tpu_torch.models.detection.mask_rcnn import MaskRCNN
from vision_tpu_torch.models._api import Weights
from vision_tpu_torch.tools.detection_request import ellipse_masks, seed_offsets
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

CFG = dict(backbone_depth=50, num_classes=5, rpn_pre_nms_top_n=200,
           rpn_post_nms_top_n=10, box_detections_per_img=5,
           deform_stages=(2, 3, 4))
SIZE = 128
GT_LABELS = np.array([[1, 2, 4, 0], [3, 4, 0, 0]], np.int32)
KEY = 3
MASK_LOGIT_SCALE = 0.05
IMAGE_SEED = 5
# the deformable conv and its offset predictor in one block of each stage
GRADS = tuple(f"backbone.body.{blk}.{name}.weight"
              for blk in ("layer2.0", "layer3.1", "layer4.2")
              for name in ("conv2", "conv2_offset"))


def _gt():
    boxes = torch.from_numpy(GT_BOXES)
    valid = torch.from_numpy(GT_VALID)
    return (boxes, torch.from_numpy(GT_LABELS).long(), valid,
            ellipse_masks(boxes, valid, (SIZE, SIZE)))


@pytest.fixture(scope="module")
def pair():
    x = np.random.RandomState(IMAGE_SEED).rand(2, SIZE, SIZE, 3).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    src = MaskRCNN(**CFG)
    init_weights(src, torch.Generator().manual_seed(0))
    offset_rms = seed_offsets(src, xt, rms=1.0)
    with torch.no_grad():
        # mask logits of RMS ~3, not ~60: probabilities spread over (0, 1)
        # rather than saturated, where the masks say something about the
        # trunk's features
        src.roi_heads.mask_predictor.mask_fcn_logits.weight.mul_(MASK_LOGIT_SCALE)
    jm = JaxMaskRCNN(**CFG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    variables = jax.tree_util.tree_map(
        np.asarray, convert_torch_state_dict(sd, shapes, hooks=_frcnn_hooks))
    port = MaskRCNN(**CFG).eval()
    load_jax_variables(port, variables)
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
    return dict(port=port, x=xt, dets=dets, losses=losses, grads=grads,
                offset_rms=offset_rms)


def test_offsets_are_real(pair):
    """13 offset predictors, each giving offsets of RMS about 1 px."""
    rms = pair["offset_rms"]
    assert len(rms) == 13
    assert all(0.5 < r < 2.0 for r in rms), rms


def test_eval_matches_jax(pair):
    want = pair["dets"]
    with torch.no_grad():
        got = pair["port"](pair["x"])
    assert got.masks.shape == (2, 5, 28, 28)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 4
    np.testing.assert_array_equal(got.labels.numpy()[valid],
                                  np.asarray(want.labels)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], atol=1e-3)
    np.testing.assert_allclose(got.masks.numpy()[valid],
                               np.asarray(want.masks)[valid], rtol=0, atol=1e-4)


def _losses_and_grads(pair):
    """The port's ``compute_loss`` with both samplers handed the masks the
    JAX samplers draw from ``KEY``, and the gradients of the summed
    losses."""
    port, (boxes, labels, valid, masks) = pair["port"], _gt()
    k1, k2 = jax.random.split(jax.random.PRNGKey(KEY))
    port.zero_grad(set_to_none=True)
    samplers = port.rpn.sampler, port.roi_heads.sampler
    port.rpn.sampler = JaxSampler(
        jutils.BalancedPositiveNegativeSampler(256, 0.5), k1)
    port.roi_heads.sampler = JaxSampler(
        jutils.BalancedPositiveNegativeSampler(512, 0.25), k2)
    try:
        losses = port.compute_loss(pair["x"], boxes, labels, valid, None,
                                   gt_masks=masks.to(pair["x"].dtype))
        sum(losses.values()).backward()
    finally:
        port.rpn.sampler, port.roi_heads.sampler = samplers
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    port.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


@pytest.fixture(scope="module")
def port_run(pair):
    return _losses_and_grads(pair)


def test_compute_loss_matches_jax(pair, port_run):
    losses, _ = port_run
    assert set(losses) == set(pair["losses"]) and "loss_mask" in losses
    for k, want in pair["losses"].items():
        np.testing.assert_allclose(losses[k], float(want), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", GRADS)
def test_deform_gradients_match_jax(pair, port_run, name):
    """The gradients of each stage's deformable conv and offset predictor,
    within 1e-3 of each one's largest value."""
    _, grads = port_run
    port = pair["port"]
    target = dict(port.named_parameters())[name]
    want = _to_torch_layout(name, pair["grads"][name], target, port)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(grads[name].numpy(), want, rtol=0,
                               atol=1e-3 * scale)


def test_builder_is_registered_and_extends_the_plain_model():
    """``maskrcnn_resnet50_fpn_deform`` is registered; its parameters are
    the plain model's of the same seed plus 13 zero offset predictors
    (580,842 parameters: 18 x 9 x planes + 18 a block)."""
    assert "maskrcnn_resnet50_fpn_deform" in list_models()
    deform = get_model("maskrcnn_resnet50_fpn_deform", device="cpu")
    plain = get_model("maskrcnn_resnet50_fpn", device="cpu")
    sd_d, sd_p = deform.state_dict(), plain.state_dict()
    extra = sorted(set(sd_d) - set(sd_p))
    assert len(extra) == 26 and all(".conv2_offset." in k for k in extra)
    assert all(torch.equal(sd_d[k], sd_p[k]) for k in sd_p)
    assert all(not sd_d[k].any() for k in extra)
    assert (sum(p.numel() for p in deform.parameters())
            == 44_401_393 + 580_842)


def test_plain_checkpoint_loads_with_zero_offset_predictors(tmp_path):
    """A plain Mask R-CNN checkpoint (no ``conv2_offset``) loads into the
    deform builder, whose offset predictors stay zero; one that lacks any
    other tensor is refused."""
    plain = get_model("maskrcnn_resnet50_fpn", device="cpu", seed=5)
    path = tmp_path / "plain.pth"
    torch.save(plain.state_dict(), path)
    weights = Weights(url=MaskRCNN_ResNet50_FPN_Weights.COCO_V1.value.url,
                      path=str(path))
    model = maskrcnn_resnet50_fpn_deform(weights=weights, device="cpu")
    sd = model.state_dict()
    for k, v in plain.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert not any(v.any() for k, v in sd.items() if ".conv2_offset." in k)
    broken = {k: v for k, v in plain.state_dict().items()
              if k != "backbone.body.layer2.0.conv2.weight"}
    torch.save(broken, path)
    with pytest.raises(RuntimeError, match="layer2.0.conv2.weight"):
        maskrcnn_resnet50_fpn_deform(weights=weights, device="cpu")


def test_load_jax_variables_covers_the_deform_model():
    """Every leaf of the JAX ``maskrcnn_resnet50_fpn_deform`` module (91
    classes, DCNv2) has a target in the port's, and every port tensor a
    source: ``conv2/kernel`` HWIO -> ``conv2.weight`` OIHW, ``conv2_offset``
    as a convolution with its bias (27 channels)."""
    jm = JaxMaskRCNN(deform_stages=(2, 3, 4), deform_modulated=True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                       shapes)
    port = MaskRCNN(deform_stages=(2, 3, 4), deform_modulated=True)
    load_jax_variables(port, variables)
    assert port.backbone.body.layer3[0].conv2_offset.weight.shape == (27, 256, 3, 3)


def test_trainable_layers_train_the_offset_predictors():
    """``trainable_backbone_layers=3`` trains exactly the deformable stages:
    every ``conv2_offset`` and deformable ``conv2`` trains, and nothing of
    ``layer1`` or the stem does."""
    model = maskrcnn_resnet50_fpn_deform(device="cpu", trainable_backbone_layers=3)
    body = dict(model.backbone.body.named_parameters())
    deform = {n for n in body if "conv2_offset" in n or (
        n.endswith("conv2.weight") and not n.startswith("layer1"))}
    assert len(deform) == 39
    assert all(body[n].requires_grad for n in deform)
    assert not any(p.requires_grad for n, p in body.items()
                   if n.startswith(("layer1", "conv1")))


def test_gradients_match_f64(pair, port_run):
    """The port's f32 train step against the same step in f64 (the model
    and images in f64; sample positions stay f32, as in the JAX function):
    the deformable layers' gradients within 1e-4 of each one's largest
    value."""
    _, grads = port_run
    p64 = dict(pair, port=copy.deepcopy(pair["port"]).double(),
               x=pair["x"].double())
    _, grads64 = _losses_and_grads(p64)
    for name in GRADS:
        want = grads64[name]
        assert float((grads[name].double() - want).abs().max()) <= 1e-4 * float(
            want.abs().max()), name
