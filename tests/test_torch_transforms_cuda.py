"""The warps, the blur, the noise and JPEG on the card against the same
calls on CPU tensors, and the host synchronisations they make. Marked
``cuda``; every test skips where no CUDA device is present (decided inside
the fixture). Run on a GPU host with:

    python -m pytest tests/test_torch_transforms_cuda.py -m cuda --noconftest

Tolerances: nearest images and masks exact; bilinear uint8 images one
level at most on at most 0.1% of the values (an f32 product or sum on
the card may land a near-tie on the other side), f32 within 1e-6 of the
largest value; boxes and keypoints within 1e-6 of the largest coordinate;
the blur in f32 within 1e-6 (cuDNN's depthwise convolution sums the taps
in its own order); JPEG bit for bit (the host codec on both sides).
"""

import numpy as np
import pytest
import torch

from vision_tpu_torch import tv_tensors as tv
from vision_tpu_torch.transforms import v2 as T
from vision_tpu_torch.transforms.v2 import functional as F

pytestmark = pytest.mark.cuda

H, W = 96, 128
COORD_TOL = 1e-6
FLOAT_TOL = 1e-6
LEVEL_SHARE = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def sample(seed=0):
    g = torch.Generator().manual_seed(seed)
    img = torch.randint(0, 256, (3, H, W), dtype=torch.uint8, generator=g)
    xy = torch.rand(6, 2, generator=g) * torch.tensor([W * 0.6, H * 0.6])
    boxes = torch.cat([xy, xy + 10 + torch.rand(6, 2, generator=g) * 30], 1)
    kp = torch.cat([torch.rand(6, 17, 2, generator=g) * torch.tensor([W - 1.0, H - 1.0]),
                    torch.full((6, 17, 1), 2.0)], -1)
    masks = (torch.rand(6, H, W, generator=g) < 0.4).to(torch.uint8)
    return {"image": tv.Image(img), "float": tv.Image(img.float() / 255),
            "masks": tv.Mask(masks),
            "boxes": tv.BoundingBoxes(boxes, format="XYXY", canvas_size=(H, W)),
            "keypoints": tv.KeyPoints(kp, canvas_size=(H, W))}


def field(seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(1, H, W, 2, generator=g) - 0.5) * 0.2


WARPS = {
    "affine": lambda x, d: F.affine(x, 17.0, [5, -3], 1.1, [8.0, -4.0],
                                    interpolation=d["interp"], fill=d["fill"]),
    "rotate_expand": lambda x, d: F.rotate(x, 33.0, d["interp"], True, None,
                                           d["fill"]),
    "perspective": lambda x, d: F.perspective(
        x, [[0, 0], [W - 1, 0], [W - 1, H - 1], [0, H - 1]],
        [[5, 7], [W - 9, 3], [W - 4, H - 10], [6, H - 4]], d["interp"],
        d["fill"]),
    "elastic": lambda x, d: F.elastic(x, field().to(x.device), d["interp"],
                                      d["fill"]),
}


def check(got, want, interp):
    assert type(got) is type(want)
    g, w = got.as_subclass(torch.Tensor).cpu(), want.as_subclass(torch.Tensor)
    assert g.shape == w.shape and g.dtype == w.dtype
    if isinstance(want, (tv.BoundingBoxes, tv.KeyPoints)):
        assert got.canvas_size == want.canvas_size
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= COORD_TOL * scale
    elif isinstance(want, tv.Mask) or interp == "nearest":
        assert torch.equal(g, w)
    elif g.dtype == torch.uint8:
        diff = (g.int() - w.int()).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= LEVEL_SHARE
    else:
        assert float((g - w).abs().max()) <= FLOAT_TOL * float(w.abs().max())


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("op", sorted(WARPS))
def test_warps_on_the_card_match_the_cpu(dev, op, interp):
    s = sample()
    d = {"interp": interp, "fill": [10.0, 20.0, 30.0]}
    for kind in ("image", "float", "masks", "boxes", "keypoints"):
        x = s[kind]
        check(WARPS[op](x.to(dev), d), WARPS[op](x, d), interp)


def _syncs(fn) -> int:
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


@pytest.mark.parametrize("name,syncs", [
    ("RandomAffine", 0), ("RandomRotation", 0), ("RandomPerspective", 0),
    ("ElasticTransform", 0), ("GaussianBlur", 0), ("GaussianNoise", 0),
    ("TenCrop", 0), ("ClampKeyPoints", 0), ("JPEG", 1),
    ("SanitizeKeyPoints", 1)])
def test_sample_classes_on_the_card_match_the_cpu(dev, name, syncs):
    """The card's sample against the CPU's on the card's draws, and the
    host synchronisations of one call (after a first, warm one)."""
    t = {"RandomAffine": T.RandomAffine(20, (0.1, 0.1), (0.8, 1.2), 8),
         "RandomRotation": T.RandomRotation(30, expand=True),
         "RandomPerspective": T.RandomPerspective(0.3, p=1.0),
         "ElasticTransform": T.ElasticTransform(),
         "GaussianBlur": T.GaussianBlur(7),
         "GaussianNoise": T.GaussianNoise(),
         "TenCrop": T.TenCrop(64),
         "ClampKeyPoints": T.ClampKeyPoints(),
         "JPEG": T.JPEG((50, 90)),
         "SanitizeKeyPoints": T.SanitizeKeyPoints()}[name]
    s = sample(2)
    cpu = (s["image"], {k: s[k] for k in ("masks", "boxes", "keypoints")})
    card = torch.utils._pytree.tree_map(lambda x: x.to(dev), cpu)
    rec = T.Record(torch.Generator().manual_seed(4))
    got = t(card, rec)
    if name != "GaussianNoise":  # the card's normals are its own
        want = t(cpu, T.Replay(rec.params))
        for g, w in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(want)):
            check(g, w, "bilinear")
    assert _syncs(lambda: t(card, torch.Generator().manual_seed(5))) == syncs
