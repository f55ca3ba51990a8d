"""The per-sample functionals (``vision_tpu_torch.transforms.v2.functional``)
against the JAX package's on the same numpy-seeded images, videos, masks,
boxes and keypoints, on the CPU (the port's ``[..., C, H, W]`` against
JAX's ``(..., H, W, C)``).

Tolerances: flips, crops, pads and nearest mask resizes exact, in every
type; boxes and keypoints (f32 arithmetic in both) within 1e-6 of the
largest coordinate; a float image resize within 1e-5 of the largest value
(the two products sum in another order); a uint8 resize exact but at
near-ties, where one level is allowed (``tests/test_torch_transforms.py``
says why); the colour ops of integer arithmetic exact in uint8, those that
round or truncate an f32 value (the two libraries' f32 sums and products
may land on either side of a boundary) one level apart on at most 0.1% of
the pixels (sharpness: 1%, ``SHARPNESS_SHARE``), and every colour op in
float within 1e-6.
"""

import numpy as np
import pytest
import torch

from vision_tpu import tv_tensors as jtv
from vision_tpu.transforms.v2 import functional as JF
from vision_tpu_torch import tv_tensors as tv
from vision_tpu_torch.transforms.v2 import functional as F

from torch_sample_cases import boxes, image, keypoints, masks

H, W = 48, 64
COORD_TOL = 1e-6
FLOAT_TOL = 1e-5
COLOUR_FLOAT_TOL = 1e-6
ROUNDED_SHARE = 1e-3  # uint8 pixels a float colour op may put one level apart
# the sharpness blur of integers over 13 lands on an integer for ~1/13 of
# the pixels, where either library's f32 sum decides the floor: 0.35% seen
SHARPNESS_SHARE = 1e-2
INTEGER_OPS = ("equalize", "grayscale_to_rgb", "invert", "permute_channels",
               "posterize", "solarize")


def chw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def hwc(t):
    return np.moveaxis(t.as_subclass(torch.Tensor).numpy(), -3, -1)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def video(seed=0, t=4):
    return np.stack([image(seed + i, 32, 40) for i in range(t)])


def samples(seed=0):
    """The port's image, video, mask, boxes and keypoints, and JAX's."""
    img, vid, m, b, k = (image(seed), video(seed), masks(seed), boxes(seed),
                         keypoints(seed))
    port = (tv.Image(chw(img)), tv.Video(chw(vid)), tv.Mask(torch.from_numpy(m)),
            tv.BoundingBoxes(torch.from_numpy(b), format="XYXY",
                             canvas_size=(H, W)),
            tv.KeyPoints(torch.from_numpy(k), canvas_size=(H, W)))
    jax = (jtv.Image(img), jtv.Video(vid), jtv.Mask(m),
           jtv.BoundingBoxes(b, format="XYXY", canvas_size=(H, W)),
           jtv.KeyPoints(k, canvas_size=(H, W)))
    return port, jax


def check(got, want):
    """``got`` (port) against ``want`` (JAX) by type: exact for pixels and
    masks, ``COORD_TOL`` for coordinates, with the metadata."""
    assert type(got).__name__ == type(want).__name__
    if isinstance(want, (jtv.Image, jtv.Video)):
        assert str(got.dtype).split('.')[-1] == str(np.asarray(want.data).dtype)
        np.testing.assert_array_equal(hwc(got), np.asarray(want.data))
    elif isinstance(want, jtv.Mask):
        np.testing.assert_array_equal(got.as_tensor().numpy(),
                                      np.asarray(want.data))
    else:
        assert got.canvas_size == want.canvas_size
        assert rel(got.as_tensor().numpy(), want.data) <= COORD_TOL
        if isinstance(want, jtv.BoundingBoxes):
            assert got.format.value == want.format.value


GEOMETRY = {
    "hflip": (lambda x: F.horizontal_flip(x), lambda x: JF.horizontal_flip(x)),
    "vflip": (lambda x: F.vertical_flip(x), lambda x: JF.vertical_flip(x)),
    "crop_inside": (lambda x: F.crop(x, 5, 7, 30, 40),
                    lambda x: JF.crop(x, 5, 7, 30, 40)),
    "crop_past_the_edges": (lambda x: F.crop(x, -6, 20, 60, 50),
                            lambda x: JF.crop(x, -6, 20, 60, 50)),
    "center_crop": (lambda x: F.center_crop(x, [30, 36]),
                    lambda x: JF.center_crop(x, [30, 36])),
    "center_crop_larger": (lambda x: F.center_crop(x, 70),
                           lambda x: JF.center_crop(x, 70)),
    "pad": (lambda x: F.pad(x, [3, 4, 5, 6], fill=7),
            lambda x: JF.pad(x, [3, 4, 5, 6], fill=7)),
    "pad_fill_per_channel": (lambda x: F.pad(x, [9, 2], fill=[123.0, 117.0, 104.0]),
                             lambda x: JF.pad(x, [9, 2], fill=[123.0, 117.0, 104.0])),
    "pad_edge": (lambda x: F.pad(x, 5, padding_mode="edge"),
                 lambda x: JF.pad(x, 5, padding_mode="edge")),
    "pad_reflect": (lambda x: F.pad(x, [4, 3], padding_mode="reflect"),
                    lambda x: JF.pad(x, [4, 3], padding_mode="reflect")),
    "pad_symmetric": (lambda x: F.pad(x, [4, 3, 2, 1], padding_mode="symmetric"),
                      lambda x: JF.pad(x, [4, 3, 2, 1], padding_mode="symmetric")),
    "resize_nearest": (lambda x: F.resize(x, [31, 45], "nearest"),
                       lambda x: JF.resize(x, [31, 45], "nearest")),
}


@pytest.mark.parametrize("op", sorted(GEOMETRY))
@pytest.mark.parametrize("kind", ["image", "video", "mask", "boxes", "keypoints"])
def test_geometry_kernels_match_jax(op, kind):
    port, jax = samples()
    i = ["image", "video", "mask", "boxes", "keypoints"].index(kind)
    ours, theirs = GEOMETRY[op]
    check(ours(port[i]), theirs(jax[i]))


@pytest.mark.parametrize("fmt", ["XYXY", "XYWH", "CXCYWH", "XYWHR", "CXCYWHR",
                                 "XYXYXYXY"])
@pytest.mark.parametrize("op", ["hflip", "vflip", "crop_inside", "pad",
                                "resize_to"])
def test_box_kernels_match_jax_in_every_format(fmt, op):
    base = boxes(1)
    if fmt in ("XYWHR", "CXCYWHR", "XYXYXYXY"):
        angle = np.linspace(-40, 40, len(base), dtype=np.float32)[:, None]
        base = np.array(JF.convert_bounding_box_format(
            np.concatenate([base[:, :2], base[:, 2:] - base[:, :2], angle], 1),
            old_format="XYWHR", new_format=fmt))
    else:
        base = np.array(JF.convert_bounding_box_format(base, old_format="XYXY",
                                                       new_format=fmt))
    port = tv.BoundingBoxes(torch.from_numpy(base), format=fmt,
                            canvas_size=(H, W), clamping_mode=None)
    jax = jtv.BoundingBoxes(base, format=fmt, canvas_size=(H, W),
                            clamping_mode=None)
    ours, theirs = {
        "hflip": (F.horizontal_flip, JF.horizontal_flip),
        "vflip": (F.vertical_flip, JF.vertical_flip),
        "crop_inside": (lambda x: F.crop(x, 5, 7, 30, 40),
                        lambda x: JF.crop(x, 5, 7, 30, 40)),
        "pad": (lambda x: F.pad(x, [3, 4, 5, 6]), lambda x: JF.pad(x, [3, 4, 5, 6])),
        "resize_to": (lambda x: F.resize(x, [30, 50]),
                      lambda x: JF.resize(x, [30, 50])),
    }[op]
    check(ours(port), theirs(jax))


def test_keypoint_flip_indices_swap_the_joints():
    """``horizontal_flip(keypoints, flip_indices)`` is the JAX mirror
    followed by the JAX ``RandomHorizontalFlip``'s re-indexing."""
    k = keypoints(2)
    flip = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)
    got = F.horizontal_flip(tv.KeyPoints(torch.from_numpy(k), canvas_size=(H, W)),
                            keypoint_flip_indices=flip)
    want = np.asarray(JF.horizontal_flip(
        jtv.KeyPoints(k, canvas_size=(H, W))).data)[..., list(flip), :]
    assert rel(got.as_tensor().numpy(), want) <= COORD_TOL
    assert np.array_equal(got.as_tensor().numpy()[..., 2], k[..., list(flip), 2])


@pytest.mark.parametrize("size,max_size", [([30, 50], None), (40, None),
                                           (32, 50), ([60, 90], None)])
@pytest.mark.parametrize("antialias", [True, False])
def test_resize_matches_jax(size, max_size, antialias):
    port, jax = samples(3)
    for i in (2, 3, 4):  # masks (nearest), boxes, keypoints
        check(F.resize(port[i], size, max_size=max_size, antialias=antialias),
              JF.resize(jax[i], size, max_size=max_size, antialias=antialias))
    img = image(3).astype(np.float32)
    got = F.resize(tv.Image(chw(img)), size, max_size=max_size,
                   antialias=antialias)
    want = JF.resize(jtv.Image(img), size, max_size=max_size,
                     antialias=antialias)
    assert isinstance(got, tv.Image)
    assert rel(hwc(got), want.data) <= FLOAT_TOL
    vid = video(3).astype(np.float32)
    got = F.resize(tv.Video(chw(vid)), size, max_size=max_size,
                   antialias=antialias)
    want = JF.resize(jtv.Video(vid), size, max_size=max_size,
                     antialias=antialias)
    assert isinstance(got, tv.Video)
    assert rel(hwc(got), want.data) <= FLOAT_TOL


def _uint8_resize_exact(img, size, antialias):
    h, w = img.shape[:2]
    wh = F.resample_matrix(h, size[0], "bilinear", antialias).astype(np.float64)
    ww = F.resample_matrix(w, size[1], "bilinear", antialias).astype(np.float64)
    return np.einsum("lk,ikc->ilc", ww, np.einsum("ij,jkc->ikc", wh,
                                                  img.astype(np.float64)))


def test_uint8_resized_crop_matches_jax_but_at_near_ties():
    img = image(4)
    got = hwc(F.resized_crop(tv.Image(chw(img)), 3, 5, 40, 50, [24, 30]))
    want = np.asarray(JF.resized_crop(jtv.Image(img), 3, 5, 40, 50, [24, 30]).data)
    exact = _uint8_resize_exact(img[3:43, 5:55], (24, 30), True)
    tie = np.abs(exact - np.floor(exact) - 0.5) < 1e-4
    diff = np.abs(got.astype(int) - want.astype(int))
    assert int(diff[~tie].max()) == 0 and int(diff.max()) <= 1


def _colour_cases():
    return {
        "hue_up": (lambda x: F.adjust_hue(x, 0.2), lambda x: JF.adjust_hue(x, 0.2)),
        "hue_down": (lambda x: F.adjust_hue(x, -0.45),
                     lambda x: JF.adjust_hue(x, -0.45)),
        "gamma": (lambda x: F.adjust_gamma(x, 0.7, 1.1),
                  lambda x: JF.adjust_gamma(x, 0.7, 1.1)),
        "invert": (F.invert, JF.invert),
        "permute_channels": (lambda x: F.permute_channels(x, [2, 0, 1]),
                             lambda x: JF.permute_channels(x, [2, 0, 1])),
        "grayscale_to_rgb": (lambda x: F.grayscale_to_rgb(F.rgb_to_grayscale(x)),
                             lambda x: JF.grayscale_to_rgb(JF.rgb_to_grayscale(x))),
        "brightness": (lambda x: F.adjust_brightness(x, 1.3),
                       lambda x: JF.adjust_brightness(x, 1.3)),
        "contrast": (lambda x: F.adjust_contrast(x, 0.6),
                     lambda x: JF.adjust_contrast(x, 0.6)),
        "saturation": (lambda x: F.adjust_saturation(x, 1.4),
                       lambda x: JF.adjust_saturation(x, 1.4)),
        "sharpness": (lambda x: F.adjust_sharpness(x, 1.7),
                      lambda x: JF.adjust_sharpness(x, 1.7)),
        "posterize": (lambda x: F.posterize(x, 3), lambda x: JF.posterize(x, 3)),
        "solarize": (lambda x: F.solarize(x, 0.5 if x.is_floating_point() else 128),
                     lambda x: JF.solarize(x, 0.5 if np.issubdtype(
                         np.asarray(x.data).dtype, np.floating) else 128)),
        "autocontrast": (F.autocontrast, JF.autocontrast),
        "equalize": (F.equalize, JF.equalize),
    }


# clips share the images' kernels: a few ops hold the leading T axis
VIDEO_OPS = ("autocontrast", "equalize", "hue_up", "invert", "sharpness")


@pytest.mark.parametrize("op,kind", [
    (op, kind) for op in sorted(_colour_cases())
    for kind in ("uint8_image", "float_image", "uint8_video")
    if kind != "uint8_video" or op in VIDEO_OPS])
def test_colour_ops_match_jax_on_images_and_videos(op, kind):
    ours, theirs = _colour_cases()[op]
    x = video(5) if kind == "uint8_video" else image(5)
    if kind == "float_image":
        x = x.astype(np.float32) / 255.0
    cls, jcls = ((tv.Video, jtv.Video) if kind == "uint8_video"
                 else (tv.Image, jtv.Image))
    got = ours(cls(chw(x)))
    want = np.asarray(theirs(jcls(x)).data)
    assert isinstance(got, cls)
    got = hwc(got)
    if kind == "float_image":
        assert np.abs(got - want).max() <= COLOUR_FLOAT_TOL
        return
    diff = np.abs(got.astype(int) - want.astype(int))
    if op in INTEGER_OPS:
        assert not diff.any()
    else:
        share = SHARPNESS_SHARE if op == "sharpness" else ROUNDED_SHARE
        assert int(diff.max()) <= 1 and diff.mean() <= share


def test_colour_ops_refuse_masks_and_keep_plain_tensors_plain():
    with pytest.raises(TypeError):
        F.adjust_brightness(tv.Mask(torch.zeros(4, 4)), 1.2)
    out = F.invert(torch.zeros(3, 4, 4, dtype=torch.uint8))
    assert type(out) is torch.Tensor and int(out.max()) == 255


def test_to_dtype_normalize_and_sanitize_match_jax():
    port, jax = samples(6)
    got = F.to_dtype(port[0], torch.float32, scale=True)
    want = JF.to_dtype(jax[0], np.float32, scale=True)
    assert isinstance(got, tv.Image)
    np.testing.assert_array_equal(hwc(got), np.asarray(want.data))
    got_m = F.to_dtype(port[2], torch.float32, scale=True)
    assert isinstance(got_m, tv.Mask) and float(got_m.max()) == 1.0
    got_n = F.normalize(got, [0.4, 0.5, 0.6], [0.2, 0.3, 0.4])
    want_n = JF.normalize(want, [0.4, 0.5, 0.6], [0.2, 0.3, 0.4])
    assert rel(hwc(got_n), want_n.data) <= COLOUR_FLOAT_TOL
    b = boxes(6)
    b[1] = [-3.0, 2.0, 10.0, 9.0]  # sticks out
    b[2] = [5.0, 5.0, 5.5, 30.0]  # narrow
    _, valid = F.sanitize_bounding_boxes(tv.BoundingBoxes(
        torch.from_numpy(b), format="XYXY", canvas_size=(H, W)))
    _, jvalid = JF.sanitize_bounding_boxes(jtv.BoundingBoxes(
        b, format="XYXY", canvas_size=(H, W)))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    _, plain = F.sanitize_bounding_boxes(torch.from_numpy(b), format="XYXY",
                                         canvas_size=(H, W), min_size=3.0)
    _, jplain = JF.sanitize_bounding_boxes(b, format="XYXY",
                                           canvas_size=(H, W), min_size=3.0)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jplain))
