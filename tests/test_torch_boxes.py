"""Box operations: the port (``vision_tpu_torch.ops.boxes``) against the
JAX package (``vision_tpu.ops.boxes``) on the same seeded numpy boxes,
random and degenerate ones (zero width or height, identical boxes, points).

Tolerances: bit-equal where both sides run the same f32 operations in the
same order (the axis-aligned conversions, areas, IoU, clipping, the
small-box mask, ``masks_to_boxes``); 1e-6 of the largest value compared
where a transcendental function is involved (the rotated conversions go
through sin and cos, CIoU through atan, and the two libraries' versions
of those differ in the last place), and NaN where both give NaN (0 / 0 for
two empty boxes). Rotated IoU, through the same sin and cos, is held to
1e-6 of the largest IoU of a random set and to 1e-6 absolute (IoU is a
ratio in [0, 1]) at single pairs, whose round-off near zero can be a few
1e-8 on either side; and to the exact value within 1e-4, as the JAX
package's own tests hold it.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.ops import boxes as jboxes
from vision_tpu.ops._box_iou_rotated import box_iou_rotated as jbox_iou_rotated
from vision_tpu_torch import ops as tops
from vision_tpu_torch.ops import boxes as tboxes

AXIS = ("xyxy", "xywh", "cxcywh")
ROTATED = ("xywhr", "cxcywhr", "xyxyxyxy")


def _xyxy(seed, n=40):
    """Random boxes, then degenerate rows: zero width, zero height, a
    point, two identical boxes, a box inside another."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-20, 200, (n, 2))
    wh = rng.uniform(0.5, 80, (n, 2))
    b = np.concatenate([xy, xy + wh], 1)
    b[0, 2] = b[0, 0]
    b[1, 3] = b[1, 1]
    b[2, 2:] = b[2, :2]
    b[4] = b[3]
    b[5] = [b[6, 0] + 1, b[6, 1] + 1, b[6, 2] - 1, b[6, 3] - 1]
    return b.astype(np.float32)


def _xywhr(seed, n=40):
    rng = np.random.RandomState(seed)
    b = np.concatenate([rng.uniform(-20, 200, (n, 2)),
                        rng.uniform(0.5, 80, (n, 2)),
                        rng.uniform(-89, 89, (n, 1))], 1)
    b[0, 2] = 0.0  # zero width
    b[1, 3] = 0.0  # zero height
    b[2, 4] = 0.0  # not rotated
    b[3, 4] = -45.0
    return b.astype(np.float32)


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close(got, want, rel=1e-6):
    want = np.asarray(want)
    finite = want[np.isfinite(want)]
    scale = max(float(np.abs(finite).max()) if finite.size else 0.0, 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=rel, atol=rel * scale)


def _boxes_in(fmt, seed):
    if fmt in AXIS:
        b = _xyxy(seed)
        return np.array(jboxes.box_convert(jnp.asarray(b), "xyxy", fmt))
    b = _xywhr(seed)
    return np.array(jboxes.box_convert(jnp.asarray(b), "xywhr", fmt))


@pytest.mark.parametrize("in_fmt,out_fmt",
                         list(itertools.product(AXIS, AXIS))
                         + list(itertools.product(ROTATED, ROTATED)))
def test_box_convert_matches_jax(in_fmt, out_fmt):
    b = _boxes_in(in_fmt, 0)
    want = jboxes.box_convert(jnp.asarray(b), in_fmt, out_fmt)
    got = tboxes.box_convert(torch.from_numpy(b), in_fmt, out_fmt)
    if in_fmt in AXIS:
        _same(got, want)
    else:
        _close(got, want)


@pytest.mark.parametrize("fmt", ["cxcywhr", "xyxyxyxy"])
def test_rotated_round_trip(fmt):
    """xywhr -> fmt -> xywhr gives the boxes back (f32 trigonometry), as the
    JAX package's round trip does; the boxes here have positive sides (a
    zero side loses its angle in xyxyxyxy)."""
    b = np.abs(_xywhr(1)) + np.array([0, 0, 1, 1, 0], np.float32)
    b[:, 4] = _xywhr(1)[:, 4]
    t = torch.from_numpy(b)
    back = tboxes.box_convert(tboxes.box_convert(t, "xywhr", fmt), fmt, "xywhr")
    jback = jboxes.box_convert(jboxes.box_convert(jnp.asarray(b), "xywhr", fmt),
                               fmt, "xywhr")
    np.testing.assert_allclose(back.numpy(), b, rtol=0, atol=1e-3)
    _close(back, jback)


@pytest.mark.parametrize("bad", [("xyxy", "xywhr"), ("xyxyxyxy", "cxcywh"),
                                 ("xyxy", "yxyx")])
def test_box_convert_refuses_mixed_or_unknown_formats(bad):
    with pytest.raises(ValueError):
        tboxes.box_convert(torch.zeros(2, 5), *bad)


@pytest.mark.parametrize("fmt", ["xyxy", "xywhr", "cxcywhr", "xyxyxyxy"])
def test_box_area_matches_jax(fmt):
    b = _boxes_in(fmt, 2)
    want = jboxes.box_area(jnp.asarray(b), fmt)
    got = tboxes.box_area(torch.from_numpy(b), fmt)
    if fmt == "xyxyxyxy":
        _close(got, want)
    else:
        _same(got, want)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32", "int8",
                                   "int16", "int32", "uint8"])
def test_upcast_matches_jax(dtype):
    """Floats below 32 bits go to f32, int8 and int16 to int32; the rest
    stay. An int16 box's area does not overflow."""
    b = np.array([[0, 0, 200, 300], [10, 20, 30, 40]], np.float32)
    j = jnp.asarray(b).astype(dtype)
    t = torch.from_numpy(b).to(getattr(torch, dtype))
    assert str(tboxes._upcast(t).dtype) == "torch." + str(jboxes._upcast(j).dtype)
    if dtype in ("int16", "int32", "float32"):
        np.testing.assert_array_equal(tboxes.box_area(t).numpy(),
                                      np.asarray(jboxes.box_area(j)))


@pytest.mark.parametrize("name", ["box_iou", "generalized_box_iou",
                                  "complete_box_iou", "distance_box_iou"])
@pytest.mark.parametrize("batched", [False, True])
def test_pairwise_iou_matches_jax(name, batched):
    b1, b2 = _xyxy(3, 30), _xyxy(4, 20)
    if batched:
        b1, b2 = np.stack([b1, _xyxy(5, 30)]), np.stack([b2, _xyxy(6, 20)])
    want = np.asarray(getattr(jboxes, name)(jnp.asarray(b1), jnp.asarray(b2)))
    got = getattr(tboxes, name)(torch.from_numpy(b1), torch.from_numpy(b2))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isfinite(want).sum() > 0.9 * want.size
    if name == "box_iou":
        _same(got, want)
    else:
        _close(got, want)


def test_pairwise_iou_of_identical_and_empty_boxes():
    """IoU 1 of a box with itself; NaN (0 / 0) for two empty boxes, on both
    sides."""
    b = _xyxy(7)[:6]
    got = tboxes.box_iou(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    want = np.asarray(jboxes.box_iou(jnp.asarray(b), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    assert got[3, 4] == 1.0 and got[6 - 1, 6 - 1] == 1.0
    assert np.isnan(got[2, 2]) and np.isnan(want[2, 2])


@pytest.mark.parametrize("fmt", ROTATED)
@pytest.mark.parametrize("seeds", [(8, 9), (10, 10)])
def test_rotated_box_iou_matches_jax(fmt, seeds):
    """``box_iou`` of rotated boxes in each format, random and degenerate
    ones (zero width, zero height, unrotated, -45 degrees), and a set
    against itself; the JAX side under ``jit``."""
    b1, b2 = (_boxes_in(fmt, s)[:n] for s, n in zip(seeds, (30, 20)))
    want = np.asarray(jax.jit(lambda a, b: jboxes.box_iou(a, b, fmt))(
        jnp.asarray(b1), jnp.asarray(b2)))
    got = tboxes.box_iou(torch.from_numpy(b1), torch.from_numpy(b2), fmt)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (want > 0).sum() >= 10  # overlapping pairs, not only zeros
    _close(got, want)


# (cxcywhr a, cxcywhr b, IoU): the JAX package's own rotated-IoU cases
_ROTATED_CASES = {
    "identity": ([10, 10, 8, 4, 30], [10, 10, 8, 4, 30], 1.0),
    "square_turned_90": ([5, 5, 4, 4, 0], [5, 5, 4, 4, 90], 1.0),
    "disjoint": ([0, 0, 2, 2, 15], [100, 100, 2, 2, 40], 0.0),
    # a unit square and itself turned 45 degrees: a regular octagon of
    # area 2 (sqrt(2) - 1) over a union of 2 - that area
    "octagon": ([0, 0, 1, 1, 0], [0, 0, 1, 1, 45],
                2 * (2 ** 0.5 - 1) / (2 - 2 * (2 ** 0.5 - 1))),
    "axis_aligned": ([10, 10, 8, 6, 0], [13, 11, 8, 6, 0], 5 * 5 / (96 - 25)),
    "zero_width": ([10, 10, 0, 6, 20], [10, 10, 8, 6, 20], 0.0),
}


@pytest.mark.parametrize("case", sorted(_ROTATED_CASES))
def test_box_iou_rotated_known_values(case):
    a, b, iou = _ROTATED_CASES[case]
    a, b = np.array([a], np.float32), np.array([b], np.float32)
    got = tops.box_iou_rotated(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jax.jit(jbox_iou_rotated)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), iou, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [(100, 150), (37, 300)])
@pytest.mark.parametrize("batched", [False, True])
def test_clip_boxes_to_image_matches_jax(size, batched):
    b = _xyxy(8) if not batched else np.stack([_xyxy(8), _xyxy(9)])
    want = jboxes.clip_boxes_to_image(jnp.asarray(b), size)
    got = tboxes.clip_boxes_to_image(torch.from_numpy(b), size)
    _same(got, want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("min_size", [0.0, 1.0, 5.0, 1e3])
def test_remove_small_boxes_matches_jax(min_size):
    b = _xyxy(10)
    want = jboxes.remove_small_boxes(jnp.asarray(b), min_size)
    got = tboxes.remove_small_boxes(torch.from_numpy(b), min_size)
    _same(got, want)


@pytest.mark.parametrize("shape", [(5, 12, 9), (3, 1, 1), (2, 40, 64)])
def test_masks_to_boxes_matches_jax(shape):
    """Random sparse masks, one of them empty (zeros), one a single pixel."""
    rng = np.random.RandomState(shape[1])
    m = (rng.rand(*shape) > 0.9).astype(np.uint8)
    m[0] = 0
    if shape[0] > 1:
        m[1] = 0
        m[1, -1, -1] = 7
    want = jboxes.masks_to_boxes(jnp.asarray(m))
    got = tboxes.masks_to_boxes(torch.from_numpy(m))
    _same(got, want)
    assert not got[0].any()


def test_box_ops_are_exported_from_ops():
    for name in ("box_convert", "box_area", "box_iou", "generalized_box_iou",
                 "complete_box_iou", "distance_box_iou", "clip_boxes_to_image",
                 "remove_small_boxes", "masks_to_boxes", "box_iou_rotated"):
        assert getattr(tops, name) is getattr(tboxes, name)
