"""The transform classes this port's last slice of ``transforms/`` adds,
against the JAX package's on the CPU: each JAX transform runs on a
numpy-seeded detection sample (image, boxes, labels, masks, 17 keypoints)
and on a plain 4-d batch, its draws are captured
(``torch_sample_cases.Spy``) and handed to the port through ``Replay``, and
every leaf of the two outputs is compared. On a plain 4-d tensor both draw
once for every image of it. Then the port's own draws: ``Record`` /
``Replay`` give the same output again, the draws stay in their ranges.

Tolerances: pixels of nearest warps, crops, masks, labels exact; bilinear
warps and the blur in uint8 one level at most on at most ``LEVEL_SHARE``
(0.1%) of the values (every case here is exact; the bound is
``tests/test_torch_transforms_warp.py``'s), in float within 1e-6 of the
largest value; boxes and keypoints within 1e-6 of the largest coordinate;
``LinearTransformation`` (a product of 144 terms, summed in another order)
within 1e-5 of the largest value. ``GaussianNoise`` draws torch's normals:
its arithmetic is held on JAX's normals in the warp file, and here the
class against its functional on the same seed, and the noise's mean and
standard deviation within 0.01 of ``mean`` and ``sigma`` over 9,216
values. ``JPEG`` is held to the port's codec bit for bit and to JAX's
libjpeg as the warp file bounds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu import tv_tensors as jtv
from vision_tpu.transforms import v2 as JT
from vision_tpu.transforms.v2 import functional as JF
from vision_tpu_torch import tv_tensors as tv
from vision_tpu_torch.transforms import v2 as T
from vision_tpu_torch.transforms.v2 import functional as F

from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)
from torch_sample_cases import (
    detection_sample,
    image,
    key,
    keypoints,
    leaves_match,
    port_log,
    spy,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

H, W = 48, 64
FLOAT_TOL = 1e-6
LEVEL_SHARE = 1e-3
LINEAR_TOL = 1e-5
NOISE_TOL = 1e-2


def compare(got, want, exact_pixels=True):
    for g, w in leaves_match(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if g.dtype == np.uint8 and g.ndim >= 3 and g.shape[-3] in (1, 3):
            diff = np.abs(g.astype(int) - w.astype(int))
            if exact_pixels:
                assert not diff.any()
            else:
                assert int(diff.max()) <= 1 and (diff > 0).mean() <= LEVEL_SHARE
        elif np.issubdtype(g.dtype, np.floating):
            scale = max(float(np.abs(w).max()), 1.0)
            assert float(np.abs(g - w).max()) <= FLOAT_TOL * scale
        else:
            np.testing.assert_array_equal(g, w)


def batch(seed=0, n=3):
    imgs = np.stack([image(seed + i) for i in range(n)])
    return torch.from_numpy(np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))), imgs


def run_both(port_t, jax_t, seed=0, sample="detection", exact_pixels=True):
    """``jax_t`` on the JAX sample (its draws captured), ``port_t`` on the
    port's with those draws; the outputs compared. ``sample="batch"``: a
    plain 4-d uint8 tensor of three images."""
    if sample == "detection":
        port, jx = detection_sample(seed)
    else:
        port, jx = batch(seed)
        jx = jnp.asarray(jx)
    log = []
    want = spy(jax_t, log)(jx, key=key(seed))
    replay = T.Replay(port_log(log))
    got = port_t(port, replay)
    assert replay.exhausted
    if sample == "batch":
        got = tuple(got) if isinstance(got, tuple) else got
        want = jax.tree_util.tree_map(
            lambda a: np.moveaxis(np.asarray(a), -1, -3), want)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert not isinstance(g, tv.TVTensor)
            compare(tv.Image(g), jtv.Image(np.moveaxis(w, -3, -1)), exact_pixels)
    else:
        compare(got, want, exact_pixels)
    return log


CLASSES = {
    "RandomAffine": (
        lambda: T.RandomAffine(25, translate=(0.1, 0.2), scale=(0.8, 1.2),
                               shear=(-5, 10, -3, 3)),
        lambda: JT.RandomAffine(25, translate=(0.1, 0.2), scale=(0.8, 1.2),
                                shear=(-5, 10, -3, 3)), True),
    "RandomAffine_bilinear_fill": (
        lambda: T.RandomAffine(15, shear=8, interpolation="bilinear",
                               fill=[123.0, 117.0, 104.0], center=[20, 10]),
        lambda: JT.RandomAffine(15, shear=8, interpolation="bilinear",
                                fill=[123.0, 117.0, 104.0], center=[20, 10]),
        False),
    "RandomRotation": (lambda: T.RandomRotation(40),
                       lambda: JT.RandomRotation(40), True),
    "RandomRotation_expand": (
        lambda: T.RandomRotation((10, 60), "bilinear", expand=True),
        lambda: JT.RandomRotation((10, 60), "bilinear", expand=True), False),
    "RandomPerspective": (lambda: T.RandomPerspective(0.4, p=1.0),
                          lambda: JT.RandomPerspective(0.4, p=1.0), False),
    "RandomPerspective_nearest": (
        lambda: T.RandomPerspective(0.3, p=1.0, interpolation="nearest", fill=5),
        lambda: JT.RandomPerspective(0.3, p=1.0, interpolation="nearest", fill=5),
        True),
    "ElasticTransform": (lambda: T.ElasticTransform(alpha=30.0, sigma=3.0),
                         lambda: JT.ElasticTransform(alpha=30.0, sigma=3.0), False),
    "FiveCrop": (lambda: T.FiveCrop([20, 30]), lambda: JT.FiveCrop([20, 30]), True),
    "TenCrop": (lambda: T.TenCrop(24, vertical_flip=True),
                lambda: JT.TenCrop(24, vertical_flip=True), True),
    "GaussianBlur": (lambda: T.GaussianBlur(5, (0.5, 2.0)),
                     lambda: JT.GaussianBlur(5, (0.5, 2.0)), False),
    "ClampKeyPoints": (lambda: T.ClampKeyPoints(), lambda: JT.ClampKeyPoints(),
                       True),
    "SetClampingMode": (lambda: T.SetClampingMode("hard"),
                        lambda: JT.SetClampingMode("hard"), True),
}
BATCHED = ("RandomAffine", "RandomAffine_bilinear_fill", "RandomRotation",
           "RandomRotation_expand", "RandomPerspective", "ElasticTransform",
           "FiveCrop", "TenCrop", "GaussianBlur")


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_class_on_a_sample_matches_jax(name):
    ours, theirs, exact = CLASSES[name]
    for seed in (0, 1):
        run_both(ours(), theirs(), seed, exact_pixels=exact)


@pytest.mark.parametrize("name", BATCHED)
def test_class_on_a_plain_4d_tensor_draws_once_as_jax(name):
    """One draw for the three images, as the JAX package's eager call and
    torchvision make it (no "batch form" needed)."""
    ours, theirs, exact = CLASSES[name]
    log = run_both(ours(), theirs(), 2, sample="batch", exact_pixels=exact)
    assert len(log) == (0 if name in ("FiveCrop", "TenCrop") else 1)


@pytest.mark.parametrize("name", ["RandomAffine", "RandomRotation_expand",
                                  "RandomPerspective", "ElasticTransform",
                                  "GaussianBlur", "JPEG", "GaussianNoise"])
def test_record_then_replay_gives_the_same_sample(name):
    make = {"JPEG": lambda: T.JPEG((40, 90)),
            "GaussianNoise": lambda: T.GaussianNoise(0.0, 0.1)}.get(
        name, CLASSES.get(name, (None,))[0])
    port, _ = detection_sample(3)
    t = make()
    rec = T.Record(torch.Generator().manual_seed(5))
    first = t(port, rec)
    again = t(port, T.Replay(rec.params))
    for a, b in zip(torch.utils._pytree.tree_leaves(first),
                    torch.utils._pytree.tree_leaves(again)):
        assert torch.equal(a.as_subclass(torch.Tensor), b.as_subclass(torch.Tensor))
    assert len(rec.params) == 1


def test_draws_stay_in_their_ranges():
    gen = torch.Generator().manual_seed(0)
    flat = [tv.Image(torch.zeros(3, H, W, dtype=torch.uint8))]
    affine = T.RandomAffine((-10, 20), translate=(0.1, 0.25), scale=(0.5, 0.9),
                            shear=[-4, 4, 1, 2])
    for _ in range(200):
        p = affine.make_params(flat, gen)
        assert -10 <= p["angle"] < 20 and 0.5 <= p["scale"] < 0.9
        assert abs(p["translate"][0]) <= round(0.1 * W)
        assert abs(p["translate"][1]) <= round(0.25 * H)
        assert -4 <= p["shear"][0] < 4 and 1 <= p["shear"][1] < 2
        q = T.JPEG((30, 32)).make_params(flat, gen)["quality"]
        assert 30 <= q <= 32
        sigma = T.GaussianBlur(3, (0.2, 0.4)).make_params(flat, gen)["sigma"]
        assert sigma[0] == sigma[1] and 0.2 <= sigma[0] < 0.4
        ends = T.RandomPerspective(0.5).make_params(flat, gen)["endpoints"]
        assert all(0 <= x < W and 0 <= y < H for x, y in ends)
    d = T.ElasticTransform().make_params(flat, gen)["displacement"]
    assert d.shape == (1, H, W, 2) and d.device.type == "cpu"
    assert {tuple(T.JPEG(70).make_params(flat, gen).values())} == {(70,)}


def test_jpeg_class_is_the_codec_round_trip():
    port, jx = detection_sample(4)
    out = T.JPEG(60)(port, T.Replay([{"quality": 60}]))
    np.testing.assert_array_equal(out[0].as_tensor().numpy(),
                                  F.jpeg_image(port[0].as_tensor(), 60).numpy())
    for a, b in zip(torch.utils._pytree.tree_leaves(out[1]),
                    torch.utils._pytree.tree_leaves(port[1])):
        assert torch.equal(a.as_subclass(torch.Tensor), b.as_subclass(torch.Tensor))
    want = np.asarray(JT.JPEG(60)(jx, key=key(0))[0].data).astype(np.int32)
    got = np.moveaxis(out[0].as_tensor().numpy(), 0, -1).astype(np.int32)
    assert np.abs(got - want).mean() <= 3.0
    with pytest.raises(ValueError):
        T.JPEG([90, 10])


def test_gaussian_noise_class_draws_its_normals_from_the_seed():
    port, _ = detection_sample(5)
    img = tv.Image(port[0].as_tensor().float() / 255.0)
    out = T.GaussianNoise(0.02, 0.1, clip=False)(
        (img, port[1]), T.Replay([{"seed": 1234}]))
    want = F.gaussian_noise(img, 0.02, 0.1, False,
                            generator=torch.Generator().manual_seed(1234))
    assert isinstance(out[0], tv.Image) and torch.equal(out[0], want)
    noise = (out[0].as_tensor() - img.as_tensor()).double()
    assert noise.numel() == 9216
    assert abs(float(noise.mean()) - 0.02) <= NOISE_TOL
    assert abs(float(noise.std()) - 0.1) <= NOISE_TOL
    assert torch.equal(out[1]["masks"], port[1]["masks"])
    u8 = T.GaussianNoise(sigma=0.2)(port[0], T.Replay([{"seed": 9}]))
    assert u8.dtype == torch.uint8 and (u8 != port[0]).any()


def test_linear_transformation_matches_jax_on_the_permuted_matrix():
    """The port flattens ``C, H, W`` (torchvision); the JAX package ``H, W,
    C``. With ``perm`` the CHW index of each HWC position, JAX's matrix is
    ``M[perm][:, perm]`` and its mean ``mean[perm]``."""
    c, h, w = 3, 6, 8
    d = c * h * w
    rng = np.random.default_rng(11)
    m = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    mean = rng.random(d).astype(np.float32)
    x = rng.random((2, c, h, w)).astype(np.float32)
    perm = np.arange(d).reshape(c, h, w).transpose(1, 2, 0).reshape(-1)
    got = T.LinearTransformation(torch.from_numpy(m), torch.from_numpy(mean))(
        tv.Image(torch.from_numpy(x)))
    want = JT.LinearTransformation(m[perm][:, perm], mean[perm])(
        jtv.Image(x.transpose(0, 2, 3, 1)))
    assert isinstance(got, tv.Image)
    g = np.moveaxis(got.as_tensor().numpy(), 1, -1)
    assert np.abs(g - np.asarray(want.data)).max() <= LINEAR_TOL * np.abs(g).max()
    plain = T.LinearTransformation(torch.from_numpy(m), torch.from_numpy(mean))(
        torch.from_numpy(x))
    assert torch.equal(plain, got.as_tensor())
    with pytest.raises(ValueError):
        T.LinearTransformation(torch.zeros(3, 4), torch.zeros(3))
    with pytest.raises(ValueError):
        T.LinearTransformation(torch.eye(4), torch.zeros(4))(torch.zeros(1, 2, 2, 2))


def _outside_keypoints(seed):
    """Detection samples whose keypoint groups 1 and 4 have a point outside
    the canvas (one at x = W, one at y = -0.5)."""
    port, jx = detection_sample(seed)
    k = keypoints(seed).copy()
    k[1, 3, 0] = W
    k[4, 0, 1] = -0.5
    port[1]["keypoints"] = tv.KeyPoints(torch.from_numpy(k), canvas_size=(H, W))
    jx[1]["keypoints"] = jtv.KeyPoints(k, canvas_size=(H, W))
    return port, jx


@pytest.mark.parametrize("labels_getter", [None, "default"])
def test_sanitize_keypoints_matches_jax_and_leaves_the_boxes(labels_getter):
    """A group goes when any of its points is outside, its label with it
    where ``labels_getter`` names the labels (none by default); the boxes
    and masks stay as they were, as the JAX package leaves them."""
    port, jx = _outside_keypoints(6)
    got = T.SanitizeKeyPoints(labels_getter)(port)
    want = JT.SanitizeKeyPoints(labels_getter)(jx)
    compare(got, want)
    assert got[1]["keypoints"].shape[0] == 4
    assert got[1]["boxes"].shape[0] == 6 and got[1]["masks"].shape[0] == 6
    assert got[1]["labels"].shape[0] == (4 if labels_getter else 6)
    _, valid = F.sanitize_keypoints(port[1]["keypoints"])
    assert valid.tolist() == [True, False, True, True, False, True]
    _, jvalid = JF.sanitize_keypoints(jx[1]["keypoints"])
    assert np.asarray(jvalid).tolist() == valid.tolist()


def test_clamp_keypoints_and_clamping_mode_on_outside_points():
    port, jx = _outside_keypoints(7)
    run = lambda t, s: t(s)  # noqa: E731
    compare(run(T.ClampKeyPoints(), port), run(JT.ClampKeyPoints(), jx))
    got = T.SetClampingMode(None)(port)
    assert got[1]["boxes"].clamping_mode is None
    assert torch.equal(got[1]["boxes"].as_tensor(), port[1]["boxes"].as_tensor())
    with pytest.raises(ValueError):
        T.SetClampingMode("loose")


def test_type_conversions_match_jax():
    img = image(8)
    got = T.ToImage()(img)
    want = JT.ToImage()(img)
    assert isinstance(got, tv.Image) and got.shape == (3, H, W)
    np.testing.assert_array_equal(np.moveaxis(got.as_tensor().numpy(), 0, -1),
                                  np.asarray(want.data))
    port, _ = detection_sample(8)
    pure = T.ToPureTensor()(port)
    for leaf in torch.utils._pytree.tree_leaves(pure):
        assert type(leaf) is torch.Tensor
    plain = torch.from_numpy(img.transpose(2, 0, 1).copy())
    typed = T.ToImage()((plain, {"labels": torch.arange(3)}))
    assert isinstance(typed[0], tv.Image) and type(typed[1]["labels"]) is torch.Tensor
    assert T.ToImage()(port)[0] is port[0]


def test_pil_conversions_match_jax():
    pil = pytest.importorskip("PIL.Image")
    img = image(9)
    pic = pil.fromarray(img)
    got = T.PILToTensor()(pic)
    assert type(got) is torch.Tensor and got.shape == (3, H, W)
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), 0, -1),
                                  np.asarray(JT.PILToTensor()(pic)))
    np.testing.assert_array_equal(
        np.moveaxis(T.ToImage()(pic).as_tensor().numpy(), 0, -1),
        np.asarray(JT.ToImage()(pic).data))
    for x in (img, img.astype(np.float32) / 255.0):
        back = T.ToPILImage()(torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(x, -1, 0))))
        np.testing.assert_array_equal(np.asarray(back),
                                      np.asarray(JT.ToPILImage()(jnp.asarray(x))))
    np.testing.assert_array_equal(np.asarray(F.to_pil_image(got)), img)


def test_pil_is_imported_at_the_call_and_named_when_missing(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "PIL.Image", None)
    with pytest.raises(ModuleNotFoundError, match="ToPILImage"):
        T.ToPILImage()(torch.zeros(3, 4, 4, dtype=torch.uint8))
    with pytest.raises(ModuleNotFoundError, match="to_pil_image"):
        F.to_pil_image(torch.zeros(3, 4, 4, dtype=torch.uint8))
    # nothing else needs it
    assert T.ToImage()(np.zeros((4, 4, 3), np.uint8)).shape == (3, 4, 4)
