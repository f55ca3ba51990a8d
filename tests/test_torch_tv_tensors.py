"""``vision_tpu_torch.tv_tensors`` against ``vision_tpu.tv_tensors`` and the
metadata functionals against JAX's (``functional/_meta.py``), on the CPU.

The containers: the types, the metadata, an operation's result a plain
tensor (torchvision's rule, which the JAX containers follow through
``__jax_array__``), ``clone`` / ``to`` / ``detach`` keeping type and
metadata, ``wrap``, copies and pickles. Every box format to every format
it converts to, numpy-seeded boxes through the port and JAX, within 1e-5
of the largest coordinate (the rotated formats go through sines and
cosines, which the two libraries round apart), and back to where they
started within 1e-4; the clamps of every format (rotated: soft and hard)
within 1e-4, the keypoint clamp exactly.
"""

import copy
import pickle

import numpy as np
import pytest
import torch

from vision_tpu import tv_tensors as jtv
from vision_tpu.transforms.v2 import functional as JF
from vision_tpu_torch import tv_tensors as tv
from vision_tpu_torch.transforms.v2 import functional as F

FORMATS = ("XYXY", "XYWH", "CXCYWH")
ROTATED = ("XYWHR", "CXCYWHR", "XYXYXYXY")
CANVAS = (48, 64)
CONVERT_TOL = 1e-5
ROUND_TRIP_TOL = 1e-4
CLAMP_TOL = 1e-4


def xyxy_boxes(n=12, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.random((n, 2)) * np.array([80.0, 60.0]) - 10.0
    wh = rng.random((n, 2)) * 30.0 + 1.0
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def xywhr_boxes(n=12, seed=0):
    rng = np.random.default_rng(seed + 1)
    xy = rng.random((n, 2)) * np.array([80.0, 60.0]) - 10.0
    wh = rng.random((n, 2)) * 30.0 + 1.0
    r = rng.random((n, 1)) * 180.0 - 90.0
    return np.concatenate([xy, wh, r], 1).astype(np.float32)


def boxes_in(fmt):
    if fmt in FORMATS:
        return np.array(JF.convert_bounding_box_format(
            xyxy_boxes(), old_format="XYXY", new_format=fmt))
    return np.array(JF.convert_bounding_box_format(
        xywhr_boxes(), old_format="XYWHR", new_format=fmt))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_containers_and_their_metadata():
    img = tv.Image(torch.zeros(5, 7, dtype=torch.uint8))
    assert img.shape == (1, 5, 7) and isinstance(img, tv.Image)
    with pytest.raises(ValueError):
        tv.Video(torch.zeros(3, 5, 7))
    boxes = tv.BoundingBoxes([[1.0, 2.0, 3.0, 4.0]], format="cxcywh",
                             canvas_size=(10, 20))
    assert boxes.format is tv.BoundingBoxFormat.CXCYWH
    assert boxes.canvas_size == (10, 20) and boxes.clamping_mode == "soft"
    assert not boxes.is_rotated
    assert tv.BoundingBoxes(torch.zeros(1, 5), format="xywhr",
                            canvas_size=(1, 1)).is_rotated
    kp = tv.KeyPoints(torch.zeros(2, 17, 3), canvas_size=[10, 20])
    assert kp.canvas_size == (10, 20)
    with pytest.raises(ValueError):
        tv.BoundingBoxes([[0.0] * 4], format="XYXY", canvas_size=(1, 1),
                         clamping_mode="sometimes")


def test_operations_unwrap_and_the_copies_keep_the_type():
    boxes = tv.BoundingBoxes([[1.0, 2.0, 3.0, 4.0]], format="XYXY",
                             canvas_size=(10, 20))
    for out in (boxes + 1, boxes[0], boxes * boxes, torch.stack([boxes]),
                boxes.flip(-1), boxes.float()):
        assert type(out) is torch.Tensor
    for out in (boxes.clone(), boxes.to(torch.float64), boxes.detach(),
                copy.deepcopy(boxes), pickle.loads(pickle.dumps(boxes))):
        assert isinstance(out, tv.BoundingBoxes)
        assert out.canvas_size == (10, 20) and out.format == boxes.format
    video = tv.Video(torch.zeros(2, 3, 4, 5))
    assert type(video.clone()) is tv.Video and type(video.sum()) is torch.Tensor
    assert torch.equal(boxes.as_tensor(), torch.tensor([[1.0, 2.0, 3.0, 4.0]]))


def test_wrap_takes_the_type_and_metadata_and_overrides():
    boxes = tv.BoundingBoxes([[1.0, 2.0, 3.0, 4.0]], format="XYXY",
                             canvas_size=(10, 20), clamping_mode=None)
    out = tv.wrap(torch.ones(1, 4), like=boxes, canvas_size=(5, 6))
    assert isinstance(out, tv.BoundingBoxes)
    assert (out.canvas_size, out.format, out.clamping_mode) == (
        (5, 6), tv.BoundingBoxFormat.XYXY, None)
    mask = tv.wrap(torch.zeros(2, 2), like=tv.Mask(torch.ones(2, 2)))
    assert type(mask) is tv.Mask


def test_register_kernel_dispatches_a_type_of_the_callers():
    class Heat(tv.TVTensor):
        pass

    seen = []

    @F.register_kernel(F.horizontal_flip, Heat)
    def flip_heat(inpt):
        seen.append(type(inpt))
        return inpt

    heat = Heat._wrap(torch.zeros(2, 3))
    assert F.horizontal_flip(heat) is heat and seen == [Heat]
    assert F.is_pure_tensor(torch.zeros(1))
    assert not F.is_pure_tensor(heat)
    with pytest.raises(ValueError):
        F.register_kernel(F.horizontal_flip, torch.Tensor)


@pytest.mark.parametrize("src,dst",
                         [(a, b) for a in FORMATS for b in FORMATS]
                         + [(a, b) for a in ROTATED for b in ROTATED])
def test_box_format_conversion_matches_jax_and_round_trips(src, dst):
    data = boxes_in(src)
    want = JF.convert_bounding_box_format(
        jtv.BoundingBoxes(data, format=src, canvas_size=CANVAS),
        new_format=dst)
    got = F.convert_bounding_box_format(
        tv.BoundingBoxes(torch.from_numpy(data), format=src,
                         canvas_size=CANVAS), new_format=dst)
    assert isinstance(got, tv.BoundingBoxes) and got.format.value == dst
    assert got.canvas_size == CANVAS
    assert rel(got.as_tensor().numpy(), want.data) <= CONVERT_TOL
    back = F.convert_bounding_box_format(got, new_format=src)
    assert rel(back.as_tensor().numpy(), data) <= ROUND_TRIP_TOL
    plain = F.convert_bounding_box_format(torch.from_numpy(data),
                                          old_format=src, new_format=dst)
    assert type(plain) is torch.Tensor


@pytest.mark.parametrize("fmt,mode", [(f, "soft") for f in FORMATS]
                         + [(f, m) for f in ROTATED for m in ("soft", "hard")])
def test_clamp_bounding_boxes_matches_jax(fmt, mode):
    data = boxes_in(fmt)
    want = JF.clamp_bounding_boxes(
        jtv.BoundingBoxes(data, format=fmt, canvas_size=CANVAS,
                          clamping_mode=mode))
    got = F.clamp_bounding_boxes(
        tv.BoundingBoxes(torch.from_numpy(data), format=fmt,
                         canvas_size=CANVAS, clamping_mode=mode))
    want = np.asarray(want.data)
    got = got.as_tensor().numpy()
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    assert rel(got[finite], want[finite]) <= CLAMP_TOL
    same = F.clamp_bounding_boxes(
        tv.BoundingBoxes(torch.from_numpy(data), format=fmt,
                         canvas_size=CANVAS, clamping_mode=None))
    assert np.array_equal(same.as_tensor().numpy(), data)


def test_clamp_keypoints_and_sizes_match_jax():
    kp = (np.random.default_rng(3).random((4, 17, 3)) * 90 - 10).astype(
        np.float32)
    want = JF.clamp_keypoints(jtv.KeyPoints(kp, canvas_size=CANVAS))
    got = F.clamp_keypoints(tv.KeyPoints(torch.from_numpy(kp),
                                         canvas_size=CANVAS))
    assert np.array_equal(got.as_tensor().numpy(), np.asarray(want.data))
    img = tv.Image(torch.zeros(3, 48, 64))
    assert F.get_size(img) == [48, 64] == JF.get_size(
        jtv.Image(np.zeros((48, 64, 3))))
    assert F.get_num_channels(img) == 3
    assert F.get_size(tv.Mask(torch.zeros(2, 5, 6))) == [5, 6]
    assert F.get_num_frames(tv.Video(torch.zeros(7, 3, 4, 4))) == 7
    assert F.get_size(tv.BoundingBoxes(torch.zeros(0, 4), format="XYXY",
                                       canvas_size=(9, 8))) == [9, 8]
