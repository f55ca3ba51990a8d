"""Image transforms: the port (``vision_tpu_torch.transforms``, CHW) against
the JAX package (``vision_tpu.transforms``, HWC) on the same seeded numpy
images, on the CPU.

Tolerances: ``resample_matrix`` bit-equal (the port's is a numpy copy);
``resize_2d`` in f32 within 1e-5 of the largest value (the two products
sum in another order: 2e-7 seen). In uint8 both round those f32 sums half
to even, and they are equal except at near-ties: where the exact value
(the same matrices applied in float64) lies within 1e-4 of a rounding
boundary, the f32 round-off of the two summation orders (up to ~2e-5 at
255) can fall on either side, and the two may differ by one level there
(seen: values 5.6e-6 from the boundary). The other functionals are
exactly equal; the presets within 1e-5 of the largest value, and by one
uint8 level over ``std`` at the resize's near-ties.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.models import resnet as jresnet
from vision_tpu.transforms import _presets as jpresets
from vision_tpu.transforms.v2.functional import _geometry as jgeo
from vision_tpu.transforms.v2.functional import _misc as jmisc
from vision_tpu.transforms.v2.functional import _resample as jres
from vision_tpu_torch.models import resnet as tresnet
from vision_tpu_torch.models.detection import FasterRCNN_ResNet50_FPN_Weights
from vision_tpu_torch.transforms import ImageClassification, ObjectDetection
from vision_tpu_torch.transforms.v2 import functional as TF
from vision_tpu_torch.transforms.v2.functional import _geometry as tgeo


def _hwc(x):
    return torch.from_numpy(np.array(x)).permute(2, 0, 1)


def _chw_to_np(t):
    return t.permute(1, 2, 0).numpy()


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30))


def _near_ties(img, size, mode="bilinear", antialias=True):
    """[H', W', C] bool: the uint8 resize's pixels whose exact value lies
    within 1e-4 of a rounding boundary."""
    h, w = img.shape[:2]
    wh = TF.resample_matrix(h, size[0], mode, antialias).astype(np.float64)
    ww = TF.resample_matrix(w, size[1], mode, antialias).astype(np.float64)
    exact = np.einsum("ij,jkc->ikc", wh, img.astype(np.float64))
    exact = np.einsum("lk,ikc->ilc", ww, exact)
    return np.abs(exact - np.floor(exact) - 0.5) < 1e-4


def _uint8_equal_but_near_ties(got, want, ties):
    diff = got.astype(np.int64) - np.asarray(want).astype(np.int64)
    assert not diff[~ties].any()
    assert np.abs(diff).max(initial=0) <= 1


def _image(seed, h, w, dtype):
    rng = np.random.RandomState(seed)
    if dtype == "uint8":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return rng.rand(h, w, 3).astype(np.float32)


@pytest.mark.parametrize("mode,antialias,align_corners", [
    ("nearest", False, False), ("nearest-exact", False, False),
    ("bilinear", True, False), ("bilinear", False, False),
    ("bilinear", False, True), ("bicubic", True, False),
    ("bicubic", False, False), ("bicubic", False, True), ("area", False, False),
])
@pytest.mark.parametrize("in_size,out_size", [(37, 20), (20, 37), (64, 64),
                                              (5, 1)])
def test_resample_matrix_is_bit_equal(in_size, out_size, mode, antialias,
                                      align_corners):
    got = TF.resample_matrix(in_size, out_size, mode, antialias, align_corners)
    want = jres.resample_matrix(in_size, out_size, mode, antialias,
                                align_corners)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("size", [(23, 31), (61, 77)])
@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_resize_2d_matches_jax(mode, antialias, size, dtype):
    """Down (40x50 -> 23x31) and up (-> 61x77)."""
    img = _image(0, 40, 50, dtype)
    want = np.asarray(jres.resize_2d(jnp.asarray(img), size, mode=mode,
                                     antialias=antialias))
    got = TF.resize_2d(_hwc(img), size, mode=mode, antialias=antialias)
    assert got.dtype == _hwc(img).dtype and got.shape == (3, *size)
    if dtype == "uint8":
        _uint8_equal_but_near_ties(_chw_to_np(got), want,
                                   _near_ties(img, size, mode, antialias))
    else:
        _close(_chw_to_np(got), want)


def test_resize_2d_takes_a_batch_and_keeps_the_matrices():
    """``(N, C, H, W)`` resizes each image alike; the matrix of a (sizes,
    mode, device) is built once."""
    imgs = torch.from_numpy(np.stack([_image(i, 30, 40, "float32")
                                      for i in range(3)])).permute(0, 3, 1, 2)
    out = TF.resize_2d(imgs, (17, 25))
    for i in range(3):
        torch.testing.assert_close(out[i], TF.resize_2d(imgs[i], (17, 25)),
                                   rtol=0, atol=0)
    from vision_tpu_torch.transforms.v2.functional import _resample
    info = _resample._device_matrix.cache_info()
    TF.resize_2d(imgs, (17, 25))
    assert _resample._device_matrix.cache_info().hits == info.hits + 2


@pytest.mark.parametrize("conv", [
    ("uint8", "float32", True), ("float32", "uint8", True),
    ("uint8", "int16", True), ("int16", "uint8", True),
    ("uint8", "float32", False), ("float32", "float32", True),
])
def test_to_dtype_image_matches_jax(conv):
    src, dst, scale = conv
    img = _image(1, 9, 11, "uint8" if src != "float32" else "float32")
    if src == "int16":
        img = img.astype(np.int16) * 97
    elif src != "float32":
        img = img.astype(src)
    want = np.asarray(jmisc.to_dtype_image(jnp.asarray(img), jnp.dtype(dst),
                                           scale=scale))
    got = TF.to_dtype_image(_hwc(img), getattr(torch, dst), scale=scale)
    assert str(got.dtype) == f"torch.{dst}"
    np.testing.assert_array_equal(_chw_to_np(got), want)


def test_to_dtype_image_refuses_f32_to_int32():
    with pytest.raises(RuntimeError, match="safely"):
        TF.to_dtype_image(torch.zeros(3, 2, 2), torch.int32, scale=True)


def test_normalize_image_matches_jax():
    img = _image(2, 13, 7, "float32")
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    want = jmisc.normalize_image(jnp.asarray(img), mean, std)
    got = TF.normalize_image(_hwc(img), mean, std)
    np.testing.assert_array_equal(_chw_to_np(got), np.asarray(want))
    with pytest.raises(TypeError):
        TF.normalize_image(_hwc(_image(2, 4, 4, "uint8")), mean, std)


@pytest.mark.parametrize("size,max_size", [(20, None), ([25], None),
                                           ((18, 40), None), (20, 30),
                                           (33, None)])
@pytest.mark.parametrize("hw", [(30, 45), (45, 30)])
def test_resize_image_matches_jax(hw, size, max_size):
    img = _image(3, *hw, "uint8")
    out_size = tgeo._compute_resized_output_size(hw, size, max_size)
    assert out_size == jgeo._compute_resized_output_size(hw, size, max_size)
    want = np.asarray(jgeo.resize_image(jnp.asarray(img), size,
                                        max_size=max_size))
    got = TF.resize_image(_hwc(img), size, max_size=max_size)
    _uint8_equal_but_near_ties(_chw_to_np(got), want, _near_ties(img, out_size))


@pytest.mark.parametrize("crop", [8, (10, 5), [12], (40, 31), (21, 20)])
@pytest.mark.parametrize("hw", [(20, 30), (21, 20)])
def test_center_crop_image_matches_jax(hw, crop):
    """Crops inside the image, larger than it (zero padding), odd offsets."""
    img = _image(4, *hw, "uint8")
    want = np.asarray(jgeo.center_crop_image(jnp.asarray(img), crop))
    got = TF.center_crop_image(_hwc(img), crop)
    np.testing.assert_array_equal(_chw_to_np(got), want)


@pytest.mark.parametrize("box", [(2, 3, 5, 7), (-3, -2, 10, 12), (15, 20, 9, 9)])
def test_crop_image_matches_jax(box):
    img = _image(5, 20, 24, "float32")
    want = np.asarray(jgeo.crop_image(jnp.asarray(img), *box))
    got = TF.crop_image(_hwc(img), *box)
    np.testing.assert_array_equal(_chw_to_np(got), want)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("hw,crop,resize", [((375, 500), 224, 256),
                                            ((300, 200), 224, 232),
                                            ((90, 120), 224, 100)])
def test_image_classification_matches_jax(hw, crop, resize, dtype):
    """Non-square images; the last is smaller than the crop after its
    resize (the crop pads with zeros, then normalises them)."""
    img = _image(6, *hw, dtype)
    want = np.asarray(jpresets.ImageClassification(
        crop_size=crop, resize_size=resize)(jnp.asarray(img)))
    preset = ImageClassification(crop_size=crop, resize_size=resize,
                                 device="cpu")
    got = _chw_to_np(preset(_hwc(img)))
    assert got.shape == (crop, crop, 3) and got.dtype == np.float32
    off = np.abs(got - want) > 1e-5 * np.abs(want).max()
    if dtype == "uint8":
        # a near-tie of the resize rounds to the neighbouring level
        size = tgeo._compute_resized_output_size(hw, resize)
        ties = np.asarray(jgeo.center_crop_image(
            jnp.asarray(_near_ties(img, size).astype(np.uint8)), crop)) > 0
        assert not (off & ~ties).any()
        level = 1.0 / (255.0 * np.asarray(preset.std, np.float32))
        np.testing.assert_allclose(np.abs(got - want)[off],
                                   np.broadcast_to(level, got.shape)[off],
                                   rtol=1e-4)
    else:
        assert not off.any()


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_object_detection_matches_jax(dtype):
    img = _image(7, 48, 64, dtype)
    want = jpresets.ObjectDetection()(jnp.asarray(img))
    got = ObjectDetection(device="cpu")(_hwc(img))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_chw_to_np(got), np.asarray(want))


def test_presets_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ObjectDetection()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tresnet.ResNet50_Weights.DEFAULT.transforms()


_WEIGHTS = [(cls, m.name) for cls in (
    "ResNet18_Weights", "ResNet34_Weights", "ResNet50_Weights",
    "ResNet101_Weights", "ResNet152_Weights", "ResNeXt50_32X4D_Weights",
    "ResNeXt101_32X8D_Weights", "ResNeXt101_64X4D_Weights",
    "Wide_ResNet50_2_Weights", "Wide_ResNet101_2_Weights")
    for m in getattr(tresnet, cls)]


@pytest.mark.parametrize("cls,member", _WEIGHTS)
def test_resnet_weights_carry_the_jax_preset(cls, member):
    got = getattr(tresnet, cls)[member].transforms
    want = getattr(jresnet, cls)[member].transforms
    assert isinstance(got, functools.partial) and got.func is ImageClassification
    assert got.keywords == want.keywords


def test_faster_rcnn_weights_carry_object_detection():
    assert FasterRCNN_ResNet50_FPN_Weights.COCO_V1.transforms is ObjectDetection
