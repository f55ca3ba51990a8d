"""The detection input path: the port's ``GeneralizedRCNNTransform`` and
``postprocess_boxes`` (``vision_tpu_torch.models.detection.transform``)
against the JAX package's, and the whole request path, raw uint8 images ->
``ObjectDetection`` -> transform -> Faster R-CNN -> ``postprocess_boxes``,
through the small model of ``tests/test_torch_faster_rcnn.py`` (ResNet-18
FPN, 6 classes, RPN top-n 200/100) with the same weights on both sides.

Tolerances: the canvas within 1e-5 of its largest value (the resize's two
products sum in another order); sizes equal; boxes mapped back within
1e-4 px. End to end, those of ``tests/test_torch_faster_rcnn.py``: valid
rows and labels equal, scores within 1e-5, boxes within 1e-4 px on the
128-px canvas (scaled back to the original image: within 1e-4 times the
largest scale factor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu._torch_convert import convert_torch_state_dict
from vision_tpu.models.detection import transform as jtransform
from vision_tpu.models.detection.faster_rcnn import FasterRCNN as JaxFasterRCNN
from vision_tpu.models.detection.faster_rcnn import _frcnn_hooks
from vision_tpu.transforms._presets import ObjectDetection as JaxObjectDetection
from vision_tpu_torch._jax_convert import load_jax_variables
from vision_tpu_torch.models.detection import (
    FasterRCNN_ResNet50_FPN_Weights,
    GeneralizedRCNNTransform,
    ImageList,
    resize_boxes,
    resize_keypoints,
)
from vision_tpu_torch.models.detection.faster_rcnn import FasterRCNN, init_weights
from vision_tpu_torch.tools.detection_request import raw_images, serve
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

CFG = dict(backbone_depth=18, num_classes=6, rpn_pre_nms_top_n=200,
           rpn_post_nms_top_n=100)
SMALL = dict(min_size=96, max_size=128)  # a 128x128 canvas
SIZE_PAIRS = [((60, 80), (100, 70)), ((128, 96), (33, 200)),
              ((96, 96), (40, 130))]


def _images(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in sizes]


def _chw(img):
    return torch.from_numpy(img).permute(2, 0, 1)


@pytest.mark.parametrize("hw,want", [((480, 640), (800, 1067)),
                                     ((427, 640), (800, 1199)),
                                     ((640, 480), (1067, 800)),
                                     ((500, 2000), (333, 1333)),
                                     ((801, 801), (800, 800))])
def test_default_target_sizes_and_canvas(hw, want):
    """min 800 / max 1333 with ``round`` (torchvision floors: 1066 and
    1198 for the first two); the canvas is 1344 square."""
    t = GeneralizedRCNNTransform(device="cpu")
    assert t._target_size(*hw) == want
    assert jtransform.GeneralizedRCNNTransform()._target_size(*hw) == want
    assert t.fixed_size == (1344, 1344)


@pytest.mark.parametrize("sizes", SIZE_PAIRS)
def test_transform_matches_jax(sizes):
    imgs = [i.astype(np.float32) / 255 for i in _images(sizes)]
    want = jtransform.GeneralizedRCNNTransform(**SMALL)(
        [jnp.asarray(i) for i in imgs])
    got = GeneralizedRCNNTransform(**SMALL, device="cpu")(
        [_chw(i) for i in imgs])
    assert isinstance(got, ImageList)
    assert got.image_sizes == want.image_sizes
    assert got.tensors.shape == (2, 3, 128, 128)
    assert got.tensors.dtype == torch.float32
    w = np.asarray(want.tensors)
    np.testing.assert_allclose(got.tensors.permute(0, 2, 3, 1).numpy(), w,
                               rtol=0, atol=1e-5 * np.abs(w).max())
    for i, (nh, nw) in enumerate(got.image_sizes):  # zero padding
        assert not got.tensors[i, :, nh:].any() and not got.tensors[i, :, :, nw:].any()


@pytest.mark.parametrize("sizes", SIZE_PAIRS)
def test_postprocess_boxes_matches_jax(sizes):
    rng = np.random.RandomState(1)
    t = GeneralizedRCNNTransform(**SMALL, device="cpu")
    jt = jtransform.GeneralizedRCNNTransform(**SMALL)
    for hw in sizes:
        resized = t._target_size(*hw)
        xy = rng.uniform(0, 120, (50, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0, 30, (50, 2))], 1)
        boxes = boxes.astype(np.float32)
        want = np.asarray(jt.postprocess_boxes(jnp.asarray(boxes), resized, hw))
        got = t.postprocess_boxes(torch.from_numpy(boxes), resized, hw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_resize_boxes_and_keypoints_match_jax():
    rng = np.random.RandomState(2)
    boxes = rng.uniform(0, 100, (2, 7, 4)).astype(np.float32)
    kp = rng.uniform(0, 100, (3, 5, 3)).astype(np.float32)
    for a, b in (((100, 80), (37, 50)), ((13, 200), (130, 20))):
        np.testing.assert_array_equal(
            resize_boxes(torch.from_numpy(boxes), a, b).numpy(),
            np.asarray(jtransform.resize_boxes(jnp.asarray(boxes), a, b)))
        for k in (kp, kp[..., :2]):
            np.testing.assert_array_equal(
                resize_keypoints(torch.from_numpy(k), a, b).numpy(),
                np.asarray(jtransform.resize_keypoints(jnp.asarray(k), a, b)))


def test_transform_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GeneralizedRCNNTransform()


@pytest.fixture(scope="module")
def models():
    jm = JaxFasterRCNN(**CFG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    src = FasterRCNN(**CFG)
    init_weights(src, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    variables = jax.tree_util.tree_map(
        np.asarray, convert_torch_state_dict(sd, shapes, hooks=_frcnn_hooks))
    port = FasterRCNN(**CFG).eval()
    load_jax_variables(port, variables)
    return jm, variables, port


def _request_against_jax(models, raw):
    """Raw uint8 ``[3, H, W]`` images through the preset, the transform at a
    128 canvas, the model and ``postprocess_boxes`` (the port's side by
    ``tools/detection_request.serve``), on both sides."""
    jm, variables, port = models
    hwc = [r.permute(1, 2, 0).numpy() for r in raw]

    jpre, jt = JaxObjectDetection(), jtransform.GeneralizedRCNNTransform(**SMALL)
    jbatch = jt([jpre(jnp.asarray(i)) for i in hwc])
    want = jax.jit(lambda v, x: jm.apply(v, x))(variables, jbatch.tensors)

    pre = FasterRCNN_ResNet50_FPN_Weights.COCO_V1.transforms(device="cpu")
    t = GeneralizedRCNNTransform(**SMALL, device="cpu")
    with torch.no_grad():
        batch, got, boxes = serve(port, pre, t, raw)
    assert batch.image_sizes == jbatch.image_sizes

    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum(1).min() > 10
    np.testing.assert_array_equal(got.labels.numpy()[valid],
                                  np.asarray(want.labels)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], atol=1e-5)
    for i, img in enumerate(hwc):
        hw, resized = img.shape[:2], batch.image_sizes[i]
        w = np.asarray(jt.postprocess_boxes(want.boxes[i], resized, hw))
        scale = max(hw[0] / resized[0], hw[1] / resized[1])
        np.testing.assert_allclose(boxes[i].numpy()[valid[i]], w[valid[i]],
                                   rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("sizes", SIZE_PAIRS)
def test_request_path_end_to_end(models, sizes):
    _request_against_jax(models, [_chw(i) for i in _images(sizes, seed=3)])


def test_request_of_the_card_smoke_run_end_to_end(models):
    """The two seeded COCO-sized images that ``chip_smoke.py`` and
    ``profile_faster_rcnn`` serve (480x640, 427x640), here at the 128
    canvas."""
    raw = raw_images()
    assert [tuple(r.shape) for r in raw] == [(3, 480, 640), (3, 427, 640)]
    assert all(r.dtype == torch.uint8 for r in raw)
    _request_against_jax(models, raw)
