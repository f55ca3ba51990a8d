"""The v1 surface of ``vision_tpu_torch.transforms`` and the port's public
names against the JAX package's, on the CPU: every public name of
``vision_tpu.transforms``, ``.v2``, ``.v2.functional`` and ``tv_tensors``
resolves in the port's; ``transforms.functional``, ``transforms.transforms``
and ``transforms.autoaugment`` import; ``ToTensor`` gives CHW where JAX's
keeps HWC; the v1 functionals (``to_tensor``, ``get_dimensions``,
``convert_image_dtype``, ...) against JAX's. Then the two card paths of
the slice on one CPU sample: ``chip_smoke.py``'s ``keypoint_warp_train``
chain (``tools/warp_train.py``) against the same chain built from JAX's
classes with JAX's draws, and the ten-crop eval of
``v1_tencrop_eval`` through the v1 classes against JAX's.

Tolerances: pixels of crops, flips and nearest warps, masks and labels
exact; the perspective warp's bilinear pixels and a uint8 resize one
level at most on at most 1% of the values (near-ties,
``tests/test_torch_transforms.py``); float images, boxes and keypoints
within 1e-6 of the largest value.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu.transforms as JTv1
import vision_tpu.tv_tensors as jtv
from vision_tpu.transforms import v2 as JT
from vision_tpu.transforms.v2 import functional as JF
import vision_tpu_torch.transforms as Tv1
from vision_tpu_torch import tv_tensors as tv
from vision_tpu_torch.tools.warp_train import keypoint_warp_chain
from vision_tpu_torch.transforms import v2 as T
from vision_tpu_torch.transforms.v2 import functional as F

from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)
from torch_sample_cases import (
    detection_sample,
    image,
    key,
    leaves_match,
    port_log,
    spy,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

FLOAT_TOL = 1e-6
LEVEL_SHARE = 1e-2


def public(module):
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), types.ModuleType)}


@pytest.mark.parametrize("jax_mod,port_mod", [
    (JTv1, Tv1), (JT, T), (JF, F), (jtv, tv)],
    ids=["transforms", "v2", "v2.functional", "tv_tensors"])
def test_every_public_name_of_jax_resolves_in_the_port(jax_mod, port_mod):
    missing = sorted(public(jax_mod) - public(port_mod))
    assert not missing, missing


def test_v1_module_paths_import():
    import vision_tpu_torch.transforms.functional as v1f
    from vision_tpu_torch.transforms import autoaugment, transforms

    assert v1f is F and Tv1.functional is F
    assert transforms.Compose is T.Compose and transforms.ToTensor is Tv1.ToTensor
    assert autoaugment.AutoAugmentPolicy is T.AutoAugmentPolicy
    for name in ("Compose", "TenCrop", "RandomAffine", "Normalize", "Resize"):
        assert getattr(Tv1, name) is getattr(T, name)
    assert Tv1.InterpolationMode is F.InterpolationMode is T.InterpolationMode
    assert [m.value for m in Tv1.InterpolationMode] == [
        m.value for m in JTv1.InterpolationMode]
    assert Tv1.InterpolationMode.BILINEAR == "bilinear"
    assert str(Tv1.InterpolationMode.NEAREST_EXACT) == "nearest-exact"
    assert tv.is_rotated_bounding_format("xywhr")
    assert tv.is_rotated_bounding_format(tv.BoundingBoxFormat.XYXYXYXY)
    assert not tv.is_rotated_bounding_format("CXCYWH")
    for fmt in ("XYWHR", "cxcywh"):
        assert tv.is_rotated_bounding_format(fmt) == jtv.is_rotated_bounding_format(fmt)
    with pytest.raises(ValueError):
        tv.is_rotated_bounding_format(3)


def test_set_return_type():
    """Plain data by default (the JAX package's containers, always); under
    ``"TVTensor"`` an op keeps its first argument's type and metadata;
    the context restores the choice before it."""
    img = tv.Image(torch.zeros(3, 4, 4))
    boxes = tv.BoundingBoxes(torch.ones(2, 4), format="XYXY", canvas_size=(4, 4))
    assert type(img + 1) is torch.Tensor
    with tv.set_return_type("TVTensor"):
        assert type(img + 1) is tv.Image
        doubled = boxes * 2
        assert type(doubled) is tv.BoundingBoxes and doubled.canvas_size == (4, 4)
        assert type(torch.zeros(2) + 1) is torch.Tensor
    assert type(img + 1) is torch.Tensor
    with jtv.set_return_type("TVTensor"), tv.set_return_type("tensor"):
        assert type(img * 2) is torch.Tensor
    for bad in ("image", "Array"):
        with pytest.raises(ValueError):
            tv.set_return_type(bad)
        with pytest.raises(ValueError):
            with jtv.set_return_type(bad):
                pass


def test_to_tensor_gives_chw_where_jax_keeps_hwc():
    img = image(1)
    got = Tv1.ToTensor()(img)
    want = np.asarray(JTv1.ToTensor()(img))
    assert got.shape == (3, 48, 64) and got.dtype == torch.float32
    assert want.shape == (48, 64, 3)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 0, -1), want, rtol=0,
                               atol=FLOAT_TOL)
    grey = F.to_tensor(img[..., 0])
    assert grey.shape == (1, 48, 64)
    with pytest.raises(TypeError):
        F.to_tensor(torch.zeros(3, 4, 4))
    pil = pytest.importorskip("PIL.Image")
    assert torch.equal(F.to_tensor(pil.fromarray(img)), got)


def test_v1_functionals_match_jax():
    img = image(2)
    x = tv.Image(torch.from_numpy(img.transpose(2, 0, 1).copy()))
    jx = jtv.Image(img)
    assert F.get_dimensions(x) == [3, 48, 64]
    assert F.get_image_size(x) == JF.get_image_size(jx) == [64, 48]
    assert F.get_image_num_channels(x) == JF.get_image_num_channels(jx) == 3
    assert F.get_dimensions_video(tv.Video(torch.zeros(2, 3, 5, 6))) == [3, 5, 6]
    assert F.get_size_mask(tv.Mask(torch.zeros(2, 5, 6))) == [5, 6]
    for ours, theirs in ((F.convert_image_dtype(x), JF.convert_image_dtype(jx)),
                         (F.to_grayscale(x, 3), JF.to_grayscale(jx, 3)),
                         (F.hflip(x), JF.hflip(jx)), (F.vflip(x), JF.vflip(jx)),
                         (F.grayscale_to_rgb_image(F.to_grayscale(x)),
                          JF.grayscale_to_rgb_image(JF.to_grayscale(jx)))):
        assert isinstance(ours, tv.Image)
        g = np.moveaxis(ours.as_tensor().numpy(), 0, -1)
        w = np.asarray(theirs.data)
        assert g.dtype == w.dtype and np.abs(g - w).max() <= FLOAT_TOL
    vid = np.stack([image(i, 8, 10) for i in range(7)])
    for n in (1, 3, 4, 7):
        got = F.uniform_temporal_subsample(
            torch.from_numpy(vid.transpose(0, 3, 1, 2).copy()), n)
        want = np.asarray(JF.uniform_temporal_subsample(jnp.asarray(vid), n))
        np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    img_t = F.to_image(img)
    assert isinstance(img_t, tv.Image) and torch.equal(img_t, x)
    assert F.to_image(x) is x


def test_per_type_names_dispatch():
    """``<op>_<type>`` is the functional: a ``Video`` through
    ``affine_video``, boxes through ``pad_bounding_boxes``."""
    vid = tv.Video(torch.zeros(2, 3, 8, 10, dtype=torch.uint8))
    out = F.affine_video(vid, 10.0, [1, 0], 1.0, [0.0, 0.0])
    assert isinstance(out, tv.Video) and out.shape == vid.shape
    boxes = tv.BoundingBoxes(torch.tensor([[1.0, 1.0, 4.0, 4.0]]), format="XYXY",
                             canvas_size=(8, 10))
    padded = F.pad_bounding_boxes(boxes, [2, 3])
    assert padded.canvas_size == (14, 14)
    assert F.five_crop_image is F.five_crop and F.rotate_keypoints is not F.rotate


def test_convert_image_dtype_class_on_a_batch_and_a_sample():
    b = torch.from_numpy(np.stack([image(i) for i in range(2)]).transpose(0, 3, 1, 2)
                         .copy())
    out = Tv1.ConvertImageDtype(torch.float32)(b)
    assert out.dtype == torch.float32 and float(out.max()) <= 1.0
    port, _ = detection_sample(1)
    out = Tv1.ConvertImageDtype()(port)
    assert out[0].dtype == torch.float32 and out[1]["boxes"].dtype == torch.float32


def compare(got, want, exact=False):
    for g, w in leaves_match(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if g.dtype == np.uint8 and g.ndim == 3 and g.shape[0] == 3:
            diff = np.abs(g.astype(int) - w.astype(int))
            assert int(diff.max()) <= (0 if exact else 1)
            assert (diff > 0).mean() <= LEVEL_SHARE
        elif np.issubdtype(g.dtype, np.floating):
            scale = max(float(np.abs(w).max()), 1.0)
            assert float(np.abs(g - w).max()) <= FLOAT_TOL * scale
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_keypoint_warp_chain_matches_jax(seed):
    """``keypoint_warp_train``'s chain on one sample: JAX's classes with
    their draws captured, the port's on those draws."""
    port, jx = detection_sample(seed)
    log = []
    want = spy(keypoint_warp_chain(JT), log)(jx, key=key(seed))
    replay = T.Replay(port_log(log))
    got = keypoint_warp_chain()(port, replay)
    assert replay.exhausted and len(log) == 3
    compare(got, want)
    assert got[1]["keypoints"].shape[1:] == (17, 3)
    assert len(got[1]["boxes"]) == len(got[1]["labels"]) == len(got[1]["keypoints"])


def test_v1_ten_crop_eval_matches_jax():
    """``v1_tencrop_eval`` at a small size: ``Compose([Resize, TenCrop])``
    of the v1 surface on a plain 4-d batch (one call for all images), the
    crops stacked and normalised, against JAX's v1 classes and against
    the v2 functionals image by image."""
    imgs = np.stack([image(i) for i in range(3)])
    batch = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()).float() / 255.0
    crops = Tv1.Compose([Tv1.Resize(40), Tv1.TenCrop(32)])(batch)
    assert len(crops) == 10 and crops[0].shape == (3, 3, 32, 32)
    stacked = torch.stack(crops, 1)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    normed = Tv1.Normalize(mean, std)(stacked.flatten(0, 1))
    jcrops = JTv1.Compose([JTv1.Resize(40), JTv1.TenCrop(32)])(
        jnp.asarray(imgs.astype(np.float32) / 255.0))
    jstacked = np.stack([np.asarray(c) for c in jcrops], 1)
    assert np.abs(stacked.numpy() - jstacked.transpose(0, 1, 4, 2, 3)).max() <= 1e-5
    for i in range(len(imgs)):
        want = torch.stack(F.ten_crop(F.resize(batch[i], 40), 32))
        assert torch.equal(want, stacked[i])
    one = F.normalize(stacked[1], mean, std)
    assert torch.allclose(one, normed.view(3, 10, 3, 32, 32)[1], rtol=0, atol=1e-6)
