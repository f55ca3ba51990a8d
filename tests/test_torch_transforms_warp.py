"""The warp, blur, noise and JPEG functionals of
``vision_tpu_torch.transforms.v2.functional`` against the JAX package's on
the CPU, over every type each takes: images (uint8 and f32, nearest and
bilinear, with and without ``fill`` and ``center``), masks (uint8 and
bool), boxes in XYXY, XYWH and CXCYWH, and keypoints (with COCO's
visibility channel), on numpy-seeded 48x64 samples (``torch_sample_cases``).
The port's ``[..., C, H, W]`` is held against JAX's ``(..., H, W, C)``.

Tolerances:
* nearest images, masks, crops and ``resized_crop_dynamic``: exact;
* bilinear images: uint8 at most one level apart on at most
  ``LEVEL_SHARE`` (0.1%) of the values, f32 within ``FLOAT_TOL`` (1e-6) of
  the largest value. The samplers compute the source points, the corner
  weights and their sum in the JAX package's f32 order, and every case here
  agrees exactly; the bound is for a near-tie landing on the other side
  of a rounding boundary, and each test counts the values that differ;
* boxes and keypoints, and the expanded canvases: within ``COORD_TOL``
  (1e-6) of the largest coordinate (one f32 ulp seen: the JAX package
  transforms points by a matrix product, the port by the same products
  and sums written out); canvases equal;
* the gaussian blur (a depthwise ``conv2d`` where JAX runs
  ``conv_general_dilated``: the taps' f32 sum in another order): f32
  within ``FLOAT_TOL``, uint8 one level on at most ``LEVEL_SHARE``;
* the gaussian noise on JAX's own normals: uint8 exact, f32 within 1e-6
  (the same f32 arithmetic);
* JPEG: the port's round trip equals its own codec's (``io/_codecs.py``)
  bit for bit. It is not JAX's: the JAX package encodes and decodes with
  libjpeg, the port with its own baseline codec. Their quantisation tables
  and sampling are the same; the encoders' quantised coefficients differ
  by one step on 0.1-8% of the coefficients (the forward DCT's rounding:
  ``JPEG_COEF_SHARE`` bounds it at 10%), and each decoder reads a stream
  within ``JPEG_DECODE_LEVELS`` (2) levels of the other. A step of a
  coarse coefficient moves a block's pixels by up to some 40 levels at
  quality 50, so the round trips are held to a mean distance of
  ``JPEG_MEAN_LEVELS`` (3) levels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu import tv_tensors as jtv
from vision_tpu.io import decode_jpeg as jdecode_jpeg
from vision_tpu.io import encode_jpeg as jencode_jpeg
from vision_tpu.transforms.v2 import functional as JF
from vision_tpu_torch import tv_tensors as tv
from vision_tpu_torch.io import _codecs
from vision_tpu_torch.transforms.v2 import functional as F

from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)
from torch_sample_cases import boxes, image, keypoints, masks

pytestmark = pytest.mark.usefixtures("few_torch_threads")

H, W = 48, 64
COORD_TOL = 1e-6
FLOAT_TOL = 1e-6
LEVEL_SHARE = 1e-3
JPEG_COEF_SHARE = 0.1
JPEG_DECODE_LEVELS = 2
JPEG_MEAN_LEVELS = 3.0

AFFINE = (17.0, [3, -2], 1.2, [10.0, -5.0])
START = [[0, 0], [W - 1, 0], [W - 1, H - 1], [0, H - 1]]
END = [[3, 5], [W - 6, 2], [W - 2, H - 7], [4, H - 3]]
CENTER = [10.0, 7.5]


def chw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def hwc(t):
    return np.moveaxis(t.as_subclass(torch.Tensor).numpy(), -3, -1)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not got.size:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def displacement(seed=0, h=H, w=W):
    rng = np.random.default_rng(seed + 400)
    return ((rng.random((1, h, w, 2)) - 0.5) * 0.2).astype(np.float32)


def source(dtype):
    img = image(0)
    return img if dtype == "uint8" else img.astype(np.float32) / 255.0


def fill_for(dtype, on):
    if not on:
        return None
    return [9.0, 0.0, 200.0] if dtype == "uint8" else [0.1, 0.5, 0.9]


def check_image(got, want, interpolation):
    """``got`` (port, CHW) against ``want`` (JAX, HWC) at the module's
    tolerances; returns the share of values that differ."""
    g, w = hwc(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
    diff = np.abs(g.astype(np.float64) - w.astype(np.float64))
    share = float((diff > 0).mean())
    if interpolation == "nearest":
        assert share == 0.0
    elif g.dtype == np.uint8:
        assert diff.max() <= 1 and share <= LEVEL_SHARE, (diff.max(), share)
    else:
        assert diff.max() <= FLOAT_TOL * np.abs(w).max()
    return share


@pytest.mark.parametrize("center", [None, CENTER])
@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("interpolation", ["nearest", "bilinear"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_affine_image_matches_jax(dtype, interpolation, fill, center):
    x, f = source(dtype), fill_for(dtype, fill)
    got = F.affine(tv.Image(chw(x)), *AFFINE, interpolation=interpolation,
                   fill=f, center=center)
    want = JF.affine(jtv.Image(x), *AFFINE, interpolation=interpolation,
                     fill=f, center=center)
    assert isinstance(got, tv.Image)
    check_image(got, want.data, interpolation)


@pytest.mark.parametrize("center", [None, CENTER])
@pytest.mark.parametrize("expand", [False, True])
@pytest.mark.parametrize("interpolation", ["nearest", "bilinear"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_rotate_image_matches_jax(dtype, interpolation, expand, center):
    x, f = source(dtype), fill_for(dtype, center is not None)
    got = F.rotate(tv.Image(chw(x)), 33.0, interpolation, expand, center, f)
    want = JF.rotate(jtv.Image(x), 33.0, interpolation, expand, center, f)
    if expand:
        assert got.shape[-2:] != (H, W)
    check_image(got, want.data, interpolation)


@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("interpolation", ["nearest", "bilinear"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_perspective_image_matches_jax(dtype, interpolation, fill):
    x, f = source(dtype), fill_for(dtype, fill)
    got = F.perspective(tv.Image(chw(x)), START, END, interpolation, f)
    want = JF.perspective(jtv.Image(x), START, END, interpolation, f)
    check_image(got, want.data, interpolation)
    coeffs = JF._geometry._perspective_coeffs(START, END)
    assert F._geometry._perspective_coeffs(START, END) == coeffs
    again = F.perspective_image(chw(x), interpolation=interpolation, fill=f,
                                coefficients=coeffs)
    assert torch.equal(again, got.as_tensor())


@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("interpolation", ["nearest", "bilinear"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_elastic_image_matches_jax(dtype, interpolation, fill):
    x, f, d = source(dtype), fill_for(dtype, fill), displacement()
    got = F.elastic(tv.Image(chw(x)), torch.from_numpy(d), interpolation, f)
    want = JF.elastic(jtv.Image(x), jnp.asarray(d), interpolation, f)
    check_image(got, want.data, interpolation)


def test_warps_of_a_video_match_jax():
    """A ``Video``'s frames warp as images, the canvas grown with them."""
    vid = np.stack([image(i, 32, 40) for i in range(3)])
    got = F.rotate(tv.Video(chw(vid)), -21.0, "bilinear", True)
    want = JF.rotate(jtv.Video(vid), -21.0, "bilinear", True)
    assert isinstance(got, tv.Video)
    check_image(got, want.data, "bilinear")
    got = F.affine_video(tv.Video(chw(vid)), *AFFINE)
    check_image(got, JF.affine_video(jtv.Video(vid), *AFFINE).data, "nearest")


WARPS = {
    "affine": (lambda x: F.affine(x, *AFFINE), lambda x: JF.affine(x, *AFFINE)),
    "affine_center": (lambda x: F.affine(x, *AFFINE, center=CENTER),
                      lambda x: JF.affine(x, *AFFINE, center=CENTER)),
    "rotate": (lambda x: F.rotate(x, 33.0), lambda x: JF.rotate(x, 33.0)),
    "rotate_expand": (lambda x: F.rotate(x, 33.0, expand=True),
                      lambda x: JF.rotate(x, 33.0, expand=True)),
    "rotate_expand_center": (
        lambda x: F.rotate(x, -71.0, expand=True, center=CENTER),
        lambda x: JF.rotate(x, -71.0, expand=True, center=CENTER)),
    "perspective": (lambda x: F.perspective(x, START, END),
                    lambda x: JF.perspective(x, START, END)),
    "elastic": (lambda x: F.elastic(x, torch.from_numpy(displacement())),
                lambda x: JF.elastic(x, jnp.asarray(displacement()))),
}


@pytest.mark.parametrize("op", sorted(WARPS))
@pytest.mark.parametrize("dtype", ["uint8", "bool"])
def test_mask_warps_match_jax(op, dtype):
    m = masks(0).astype(dtype)
    ours, theirs = WARPS[op]
    got, want = ours(tv.Mask(torch.from_numpy(m))), theirs(jtv.Mask(m))
    assert isinstance(got, tv.Mask)
    np.testing.assert_array_equal(got.as_tensor().numpy(), np.asarray(want.data))


@pytest.mark.parametrize("op", sorted(WARPS))
@pytest.mark.parametrize("fmt", ["XYXY", "XYWH", "CXCYWH"])
def test_box_warps_match_jax(op, fmt):
    base = np.array(JF.convert_bounding_box_format(
        boxes(2), old_format="XYXY", new_format=fmt))
    ours, theirs = WARPS[op]
    got = ours(tv.BoundingBoxes(torch.from_numpy(base), format=fmt,
                                canvas_size=(H, W)))
    want = theirs(jtv.BoundingBoxes(base, format=fmt, canvas_size=(H, W)))
    assert isinstance(got, tv.BoundingBoxes) and got.format.value == fmt
    assert got.canvas_size == tuple(want.canvas_size)
    assert rel(got.as_tensor().numpy(), want.data) <= COORD_TOL


@pytest.mark.parametrize("op", sorted(WARPS))
def test_keypoint_warps_match_jax(op):
    k = keypoints(3)
    ours, theirs = WARPS[op]
    got = ours(tv.KeyPoints(torch.from_numpy(k), canvas_size=(H, W)))
    want = theirs(jtv.KeyPoints(k, canvas_size=(H, W)))
    assert isinstance(got, tv.KeyPoints)
    assert got.canvas_size == tuple(want.canvas_size)
    assert rel(got.as_tensor().numpy(), want.data) <= COORD_TOL
    # the visibility channel rides along
    np.testing.assert_array_equal(got.as_tensor().numpy()[..., 2], k[..., 2])


@pytest.mark.parametrize("mode", ["soft", None])
def test_plain_box_and_keypoint_kernels_match_jax(mode):
    """The kernels on plain tensors, as JAX returns them: ``(boxes,
    canvas)`` of rotate, boxes alone of affine, ``(keypoints, canvas)``."""
    b, k = boxes(4), keypoints(4)
    got, cs = F.rotate_bounding_boxes(torch.from_numpy(b), "XYXY", (H, W), 50.0,
                                      True, clamping_mode=mode)
    want, jcs = JF.rotate_bounding_boxes(jnp.asarray(b), jtv.BoundingBoxFormat.XYXY,
                                         (H, W), 50.0, True, clamping_mode=mode)
    assert cs == tuple(jcs) and rel(got.numpy(), want) <= COORD_TOL
    got = F.affine_bounding_boxes(torch.from_numpy(b), "XYXY", (H, W), *AFFINE,
                                  clamping_mode=mode)
    want = JF.affine_bounding_boxes(jnp.asarray(b), jtv.BoundingBoxFormat.XYXY,
                                    (H, W), *AFFINE, clamping_mode=mode)
    assert rel(got.numpy(), want) <= COORD_TOL
    got = F.elastic_bounding_boxes(torch.from_numpy(b), "XYXY", (H, W),
                                   torch.from_numpy(displacement()), mode)
    want = JF.elastic_bounding_boxes(jnp.asarray(b), jtv.BoundingBoxFormat.XYXY,
                                     (H, W), jnp.asarray(displacement()), mode)
    assert rel(got.numpy(), want) <= COORD_TOL
    got = F.perspective_bounding_boxes(torch.from_numpy(b), "XYXY", (H, W),
                                       START, END)
    want = JF.perspective_bounding_boxes(jnp.asarray(b), jtv.BoundingBoxFormat.XYXY,
                                         (H, W), START, END)
    assert rel(got.numpy(), want) <= COORD_TOL
    (got, cs), (want, jcs) = (
        F.affine_keypoints(torch.from_numpy(k), (H, W), *AFFINE),
        JF.affine_keypoints(jnp.asarray(k), (H, W), *AFFINE))
    assert cs == tuple(jcs) and rel(got.numpy(), want) <= COORD_TOL
    got = F.perspective_keypoints(torch.from_numpy(k), (H, W), START, END)
    want = JF.perspective_keypoints(jnp.asarray(k), (H, W), START, END)
    assert rel(got.numpy(), want) <= COORD_TOL
    got = F.elastic_keypoints(torch.from_numpy(k), (H, W),
                              torch.from_numpy(displacement()))
    want = JF.elastic_keypoints(jnp.asarray(k), (H, W), jnp.asarray(displacement()))
    assert rel(got.numpy(), want) <= COORD_TOL


def test_expanded_canvases_of_images_and_points_follow_jax():
    """An image's expanded canvas comes from the matrix about the centred
    frame, the boxes' and keypoints' from the one about the absolute
    centre (torchvision's kernels, which the JAX package follows): at 33
    degrees on 48x64 the two differ by a column."""
    img = F.rotate(tv.Image(chw(image(0))), 33.0, expand=True)
    kp = F.rotate(tv.KeyPoints(torch.from_numpy(keypoints(0)), canvas_size=(H, W)),
                  33.0, expand=True)
    assert tuple(img.shape[-2:]) == (76, 80) and kp.canvas_size == (76, 81)
    jkp = JF.rotate(jtv.KeyPoints(keypoints(0), canvas_size=(H, W)), 33.0,
                    expand=True)
    assert tuple(jkp.canvas_size) == kp.canvas_size


@pytest.mark.parametrize("vertical", [False, True])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_five_and_ten_crop_match_jax(dtype, vertical):
    x = source(dtype)
    five = F.five_crop(tv.Image(chw(x)), [20, 30])
    jfive = JF.five_crop(jtv.Image(x), [20, 30])
    ten = F.ten_crop(tv.Image(chw(x)), 24, vertical)
    jten = JF.ten_crop(jtv.Image(x), 24, vertical)
    assert len(five) == 5 and len(ten) == 10
    for got, want in zip(five + ten, jfive + jten):
        assert isinstance(got, tv.Image)
        np.testing.assert_array_equal(hwc(got), np.asarray(want.data))
    with pytest.raises(ValueError):
        F.five_crop(chw(x), 65)


@pytest.mark.parametrize("as_tensors", [False, True])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_resized_crop_dynamic_matches_jax(dtype, as_tensors):
    x = source(dtype)
    rect = (3.5, 7.25, 30.0, 41.0)
    args = tuple(torch.tensor(v) for v in rect) if as_tensors else rect
    got = F.resized_crop_dynamic(chw(x), *args, (20, 28))
    want = JF.resized_crop_dynamic(jnp.asarray(x), *rect, (20, 28))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(hwc(got), np.asarray(want))


@pytest.mark.parametrize("kernel_size,sigma", [
    (3, None), (5, 1.3), ((7, 3), (2.0, 0.7)), (41, 5.0)])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_gaussian_blur_matches_jax(dtype, kernel_size, sigma):
    """41 taps at sigma 5 is ElasticTransform's default field blur; its
    pad is wider than the 48-row image's reflection period allows in one
    step (numpy reflects again)."""
    x = source(dtype)
    got = F.gaussian_blur(tv.Image(chw(x)), kernel_size, sigma)
    want = JF.gaussian_blur(jtv.Image(x), kernel_size, sigma)
    assert isinstance(got, tv.Image)
    check_image(got, want.data, "bilinear")


def test_gaussian_blur_leaves_masks_boxes_and_keypoints():
    m = tv.Mask(torch.from_numpy(masks(0)))
    b = tv.BoundingBoxes(torch.from_numpy(boxes(0)), format="XYXY",
                         canvas_size=(H, W))
    for x in (m, b):
        assert F.gaussian_blur(x, 5) is x
    with pytest.raises(ValueError):
        F.gaussian_blur_image(chw(image(0)), 4)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_gaussian_noise_on_jax_normals_matches_jax(dtype, clip):
    """The port given JAX's standard normals: the arithmetic alone (uint8:
    ``255 (mean + sigma z)`` truncated to int16, added, clamped)."""
    import jax

    x = source(dtype)
    key = jax.random.PRNGKey(7)
    z = np.asarray(jax.random.normal(key, x.shape, dtype=jnp.float32))
    want = JF.gaussian_noise(jtv.Image(x), 0.05, 0.2, clip, key=key)
    got = F.gaussian_noise(tv.Image(chw(x)), 0.05, 0.2, clip,
                           normals=chw(z))
    g, w = hwc(got), np.asarray(want.data)
    if dtype == "uint8":
        np.testing.assert_array_equal(g, w)
    else:
        assert np.abs(g - w).max() <= 1e-6
    with pytest.raises(ValueError):
        F.gaussian_noise(chw(x), sigma=-1.0)
    with pytest.raises(ValueError):
        F.gaussian_noise(chw(x).to(torch.int32))


def test_gaussian_noise_draws_from_the_generator():
    x = chw(source("float32"))
    a = F.gaussian_noise(x, 0.0, 0.1, False,
                         generator=torch.Generator().manual_seed(3))
    b = F.gaussian_noise(x, 0.0, 0.1, False,
                         generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    noise = (a - x).double()
    assert abs(float(noise.mean())) < 0.01 and abs(float(noise.std()) - 0.1) < 0.01


@pytest.mark.parametrize("quality", [50, 95])
def test_jpeg_is_the_codec_round_trip(quality):
    x = image(1)
    got = F.jpeg(tv.Image(chw(x)), quality)
    assert isinstance(got, tv.Image) and got.dtype == torch.uint8
    want = _codecs.decode_jpeg_native(_codecs.encode_jpeg_native(x, quality))
    np.testing.assert_array_equal(hwc(got), want)
    batch = F.jpeg_image(torch.stack([chw(x), chw(image(2))]), quality)
    assert torch.equal(batch[0], got.as_tensor())
    assert F.jpeg(tv.Mask(torch.zeros(2, 4, 4)), quality).shape == (2, 4, 4)
    with pytest.raises(ValueError):
        F.jpeg(chw(x).float(), quality)


@pytest.mark.parametrize("quality", [50, 95])
def test_jpeg_against_jaxs_libjpeg(quality):
    """How far the port's codec is from libjpeg (the module docstring)."""
    x = image(2)
    ours = _codecs.encode_jpeg_native(x, quality)
    theirs = bytes(jencode_jpeg(x, quality=quality))
    (c1, q1, s1, _), (c2, q2, s2, _) = (_codecs.jpeg_coefficients_native(d)
                                        for d in (ours, theirs))
    assert s1 == s2 and all(np.array_equal(a, b) for a, b in zip(q1, q2))
    for a, b in zip(c1, c2):
        step = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert step.max() <= 1 and (step > 0).mean() <= JPEG_COEF_SHARE
    for data in (ours, theirs):
        a = _codecs.decode_jpeg_native(data).astype(np.int32)
        b = np.asarray(jdecode_jpeg(data)).astype(np.int32)
        assert np.abs(a - b).max() <= JPEG_DECODE_LEVELS
    got = hwc(F.jpeg(tv.Image(chw(x)), quality)).astype(np.int32)
    want = np.asarray(JF.jpeg(jtv.Image(x), quality).data).astype(np.int32)
    assert np.abs(got - want).mean() <= JPEG_MEAN_LEVELS
