"""The train-time augmentation of the port against ``vision_tpu`` on the CPU:
the same seeded uint8 images (numpy), the port's draws handed to the JAX
functionals, channels moved between NCHW and NHWC.

Tolerances (uint8 counts): the geometric ops through nearest sampling,
Posterize, Solarize, Equalize, Identity and AutoContrast equal bit for bit;
bilinear sampling and the blend ops (Brightness, Color, Contrast,
Sharpness) within 1, as the JAX engine's own bound for its blend ops
(``_batch_augment.py:24-40``); RandomResizedCrop + flip within 1 of
``resized_crop_flip_batch(precision="highest")``. ToDtype + Normalize,
RandomErasing, MixUp and CutMix, images and labels: 1e-6.

Each RandAugment op is held against the JAX package's per-sample
``_apply_op`` (Rotate against ``F.rotate``: the port's engine computes it
exactly, where the JAX engine's three-shear approximates it within one
source pixel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.transforms import v2 as JT
from vision_tpu.transforms.v2 import functional as JF
from vision_tpu_torch.parallel import make_device_augment
from vision_tpu_torch.transforms import v2 as T
from vision_tpu_torch.transforms.v2 import functional as TF

N, H, W = 4, 24, 32
RA_MAG = 9
NAMES = list(JT.RandAugment()._augmentation_space(31, (H, W)))
GEOMETRIC = ("ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate")
BLEND = ("Brightness", "Color", "Contrast", "Sharpness")
SIGNED = GEOMETRIC + BLEND


def _images(seed=0, n=N, h=H, w=W):
    return np.random.RandomState(seed).randint(0, 256, (n, 3, h, w)).astype(np.uint8)


def _nhwc(x):
    return jnp.asarray(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1)))


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def _max_diff(got, want):
    return int(np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32)).max())


def _cases():
    for name in NAMES:
        for sign in ((1, -1) if name in SIGNED else (1,)):
            for interp in (("nearest", "bilinear") if name in GEOMETRIC
                           else ("nearest",)):
                yield name, sign, interp


@pytest.mark.parametrize("name,sign,interp", list(_cases()))
def test_randaugment_op_matches_jax_per_sample(name, sign, interp):
    imgs = _images(NAMES.index(name))
    ra = T.RandAugment(magnitude=RA_MAG, interpolation=interp)
    mag, signed = ra.magnitudes((H, W))[name]
    mag = mag * sign if signed else mag
    got = T.apply_ops_batched(
        torch.from_numpy(imgs), torch.full((N,), NAMES.index(name)),
        torch.full((N,), mag, dtype=torch.float64), NAMES, interp).numpy()
    jra = JT.RandAugment(magnitude=RA_MAG, interpolation=interp)
    want = np.stack([np.asarray(jra._apply_op(_nhwc(imgs[i:i + 1])[0], name, mag))
                     for i in range(N)])
    tol = 1 if name in BLEND or interp == "bilinear" else 0
    assert _max_diff(got, _nchw(want)) <= tol
    if name != "Identity":
        assert (got != imgs).any()


@pytest.mark.parametrize("fn,args", [
    ("affine_image", (15.0, [3.0, -2.0], 1.2, [10.0, -5.0])),
    ("rotate_image", (-33.0,)),
])
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_affine_and_rotate_match_jax(fn, args, interp):
    img = _images(7)[0]
    center = [10.0, 7.5]
    got = getattr(TF, fn)(torch.from_numpy(img), *args, interpolation=interp,
                          center=center, fill=[9.0, 0.0, 200.0]).numpy()
    want = getattr(JF, fn)(_nhwc(img[None])[0], *args, interpolation=interp,
                           center=center, fill=[9.0, 0.0, 200.0])
    assert _max_diff(got, np.asarray(want).transpose(2, 0, 1)) <= (
        0 if interp == "nearest" else 1)


def test_randaugment_batched_matches_jax_on_the_same_draws():
    """Two ops an image from the port's draws; each op held on the same
    input, the port's result of the op before."""
    imgs = _images(3, n=16)
    ra = T.RandAugment(magnitude=RA_MAG, interpolation="bilinear")
    draws = ra.draw(imgs.shape, torch.Generator().manual_seed(3))
    jra = JT.RandAugment(magnitude=RA_MAG, interpolation="bilinear")
    table = ra.magnitudes((H, W))
    x = torch.from_numpy(imgs)
    for s in range(ra.num_ops):
        one = T.RandAugment(num_ops=1, magnitude=RA_MAG, interpolation="bilinear")
        got = one.transform(x, {k: v[:, s:s + 1] for k, v in draws.items()})
        for i in range(len(imgs)):
            name = NAMES[int(draws["op"][i, s])]
            mag, signed = table[name]
            mag = mag * float(draws["sign"][i, s]) if signed else mag
            want = jra._apply_op(_nhwc(x[i:i + 1].numpy())[0], name, mag)
            tol = 1 if name in BLEND or name in GEOMETRIC else 0
            assert _max_diff(got[i].numpy(), np.asarray(want).transpose(2, 0, 1)) <= tol
        x = got
    whole = ra.batched(torch.from_numpy(imgs), torch.Generator().manual_seed(3))
    assert torch.equal(whole, x)


def test_randaugment_draws():
    ra = T.RandAugment()
    g = torch.Generator().manual_seed(0)
    d = ra.draw((512, 3, H, W), g)
    assert d["op"].shape == (512, 2) and d["op"].min() == 0 and d["op"].max() == 13
    assert set(d["sign"].unique().tolist()) == {-1.0, 1.0}
    again = ra.draw((512, 3, H, W), torch.Generator().manual_seed(0))
    assert all(torch.equal(d[k], again[k]) for k in d)


def test_resized_crop_flip_matches_jax():
    imgs = _images(1, n=6, h=40, w=56)
    rrc = T.RandomResizedCrop((24, 20))
    draws = rrc.draw(imgs.shape, torch.Generator().manual_seed(2), flip_p=0.5)
    got = rrc.batched(torch.from_numpy(imgs), torch.Generator().manual_seed(2),
                      flip_p=0.5).numpy()
    want = JF.resized_crop_flip_batch(
        _nhwc(imgs), *(jnp.asarray(draws[k].numpy())
                       for k in ("top", "left", "height", "width")),
        (24, 20), flip=jnp.asarray(draws["flip"].numpy()), precision="highest")
    assert got.shape == (6, 3, 24, 20)
    assert _max_diff(got, _nchw(want)) <= 1
    assert draws["flip"].any() and not draws["flip"].all()


def test_resized_crop_draws_bounds_and_determinism():
    rrc = T.RandomResizedCrop(16)
    shape = (4096, 3, 60, 90)
    d = rrc.draw(shape, torch.Generator().manual_seed(5), flip_p=0.5)
    h, w, top, left = d["height"], d["width"], d["top"], d["left"]
    assert (h >= 1).all() and (w >= 1).all()
    assert (top >= 0).all() and (left >= 0).all()
    assert (top + h <= 60).all() and (left + w <= 90).all()
    assert torch.equal(top, top.round()) and torch.equal(h, h.round())
    area = h * w / (60 * 90)
    assert area.min() >= 0.08 - 0.01 and area.max() <= 1.0
    aspect = w / h
    assert aspect.min() > 0.7 and aspect.max() < 1.45
    assert 0.45 < d["flip"].float().mean() < 0.55
    again = rrc.draw(shape, torch.Generator().manual_seed(5), flip_p=0.5)
    assert all(torch.equal(d[k], again[k]) for k in d)
    other = rrc.draw(shape, torch.Generator().manual_seed(6), flip_p=0.5)
    assert not torch.equal(d["top"], other["top"])


@pytest.mark.parametrize("hw,want_hw", [((30, 90), (30, 40)),
                                        ((90, 30), (40, 30)),
                                        ((40, 50), (40, 50))])
def test_resized_crop_falls_back_to_the_centre_crop(hw, want_hw):
    """No candidate fits (a scale above the whole image): the centre crop
    at the nearest aspect in range, as the JAX traced draw takes it."""
    rrc = T.RandomResizedCrop(8, scale=(2.0, 3.0))
    d = rrc.draw((3, 3, *hw), torch.Generator().manual_seed(0))
    assert d["height"].tolist() == [want_hw[0]] * 3
    assert d["width"].tolist() == [want_hw[1]] * 3
    assert d["top"].tolist() == [(hw[0] - want_hw[0]) // 2] * 3
    assert d["left"].tolist() == [(hw[1] - want_hw[1]) // 2] * 3


def test_to_dtype_normalize_erase_match_jax():
    imgs = _images(2)
    post = T.Compose([T.ToDtype(torch.float32, scale=True),
                      T.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
                      T.RandomErasing(p=0.7)])
    draws = post.draw(imgs.shape, torch.Generator().manual_seed(2))
    got = post.apply(torch.from_numpy(imgs), draws).numpy()
    jpost = JT.Compose([JT.ToDtype(jnp.float32, scale=True),
                        JT.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])])
    erase = draws[2]
    assert erase["applied"].any() and (erase["h"] > 0).any()
    for i in range(N):
        want = jpost.transforms[1](jpost.transforms[0](_nhwc(imgs[i:i + 1])[0]))
        if erase["applied"][i]:
            want = JT.RandomErasing().transform(want, {
                "traced": True, "i": float(erase["i"][i]), "j": float(erase["j"][i]),
                "h": float(erase["h"][i]), "w": float(erase["w"][i]),
                "v": jnp.zeros((H, W, 3))})
        np.testing.assert_allclose(got[i], np.asarray(want).transpose(2, 0, 1),
                                   rtol=0, atol=1e-6)


def test_random_horizontal_flip_mirrors_the_picked_images():
    imgs = torch.from_numpy(_images(6, n=64))
    flip = T.RandomHorizontalFlip(p=0.3)
    d = flip.draw(imgs.shape, torch.Generator().manual_seed(6))
    out = flip.apply(imgs, d)
    assert 5 < int(d["applied"].sum()) < 35
    assert torch.equal(out[d["applied"]], imgs[d["applied"]].flip(-1))
    assert torch.equal(out[~d["applied"]], imgs[~d["applied"]])


def test_random_erasing_draws_fit_inside():
    d = T.RandomErasing(p=0.5).draw((2048, 3, 20, 30),
                                    torch.Generator().manual_seed(4))
    h, w, i, j = d["h"], d["w"], d["i"], d["j"]
    assert (h < 20).all() and (w < 30).all() and (h > 0).any()
    assert (i >= 0).all() and (i + h <= 20).all() and (j + w <= 30).all()
    assert 0.45 < d["applied"].float().mean() < 0.55


@pytest.mark.parametrize("labels", ["int", "soft"])
def test_mixup_and_cutmix_match_jax(labels):
    rng = np.random.RandomState(9)
    imgs = rng.randn(N, 3, H, W).astype(np.float32)
    if labels == "int":
        lab = rng.randint(0, 10, N)
        jlab = np.eye(10, dtype=np.float32)[lab]
    else:
        lab = jlab = rng.dirichlet(np.ones(10), N).astype(np.float32)
    g = torch.Generator().manual_seed(1)
    for mixer, jmixer in ((T.MixUp(0.2, num_classes=10), JT.MixUp(0.2, 10)),
                          (T.CutMix(1.0, num_classes=10), JT.CutMix(1.0, 10))):
        d = mixer.draw(imgs.shape, g)
        got_img, got_lab = mixer.apply((torch.from_numpy(imgs),
                                        torch.from_numpy(lab)), d)
        if isinstance(mixer, T.MixUp):
            params = {"lam": float(d["lam"]), "lam_adjusted": float(d["lam"])}
        else:
            x1, y1, x2, y2 = (int(v) for v in d["box"])
            assert 0 <= x1 <= x2 <= W and 0 <= y1 <= y2 <= H
            area = (x2 - x1) * (y2 - y1) / (H * W)
            assert float(d["lam_adjusted"]) == pytest.approx(1.0 - area, abs=1e-7)
            params = {"box": (x1, y1, x2, y2), "size": (H, W),
                      "lam_adjusted": float(d["lam_adjusted"])}
        want_img = jmixer._mix_image(_nhwc(imgs), params)
        want_lab = jmixer._mix_label(jnp.asarray(jlab), params)
        np.testing.assert_allclose(got_img.numpy(), _nchw(want_img), atol=1e-6)
        np.testing.assert_allclose(got_lab.numpy(), np.asarray(want_lab), atol=1e-6)
        assert np.allclose(got_lab.numpy().sum(1), 1.0, atol=1e-6)


def test_random_choice_picks_each_transform():
    mix = T.RandomChoice([T.MixUp(0.2, num_classes=5), T.CutMix(1.0, num_classes=5)])
    g = torch.Generator().manual_seed(0)
    picks = [int(mix.draw((2, 3, 8, 8), g)["choice"]) for _ in range(400)]
    assert set(picks) == {0, 1} and 150 < sum(picks) < 250
    imgs = torch.rand(2, 3, 8, 8)
    lab = torch.tensor([1, 3])
    for _ in range(4):
        d = mix.draw(imgs.shape, g)
        out = mix.apply((imgs, lab), d)
        want = mix.transforms[int(d["choice"])].apply((imgs, lab),
                                                      d["params"][int(d["choice"])])
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


def test_device_augment_matches_the_jax_stages():
    """The recipe's pipeline on the port's draws against the JAX functionals
    stage by stage, each on the port's input of that stage."""
    imgs = _images(11, n=8, h=40, w=48)
    labels = np.random.RandomState(11).randint(0, 10, 8)
    aug = make_device_augment(crop_size=32, auto_augment="ra",
                              mixup_alpha=0.2, cutmix_alpha=1.0, num_classes=10,
                              random_erase=0.5)
    draws = aug.draw(imgs.shape, torch.Generator().manual_seed(11))
    out = aug.apply({"image": torch.from_numpy(imgs),
                     "label": torch.from_numpy(labels)}, draws)
    assert out["image"].shape == (8, 3, 32, 32) and out["label"].shape == (8, 10)

    crop = draws["crop"]
    cropped = aug.crop.apply(torch.from_numpy(imgs), crop)
    want = JF.resized_crop_flip_batch(
        _nhwc(imgs), *(jnp.asarray(crop[k].numpy())
                       for k in ("top", "left", "height", "width")),
        32, flip=jnp.asarray(crop["flip"].numpy()), precision="highest")
    assert _max_diff(cropped.numpy(), _nchw(want)) <= 1
    ra = aug.auto_augment.apply(cropped, draws["auto_augment"])
    post = aug.post.apply(ra, draws["post"])
    np.testing.assert_allclose(
        post.numpy()[~draws["post"][2]["applied"].numpy()],
        _nchw(JT.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])(
            JT.ToDtype(jnp.float32, scale=True)(_nhwc(ra.numpy()))))[
            ~draws["post"][2]["applied"].numpy()], atol=1e-6)
    mixed = aug.mix.apply((post, torch.from_numpy(labels)), draws["mix"])
    assert torch.equal(mixed[0], out["image"]) and torch.equal(mixed[1], out["label"])


def test_equalize_and_autocontrast_edge_cases():
    """A constant channel (step 0 / max == min) is kept; a two-level image
    equalises as the JAX functional does."""
    img = np.zeros((2, 3, 8, 8), np.uint8)
    img[0, 0] = 77
    img[1, 1, :4] = 10
    img[1, 1, 4:] = 200
    for fn in ("equalize", "autocontrast"):
        got = getattr(TF, fn)(torch.from_numpy(img)).numpy()
        want = np.stack([np.asarray(getattr(JF, fn)(_nhwc(img[i:i + 1])[0]))
                         for i in range(2)])
        assert _max_diff(got, _nchw(want)) == 0, fn


def test_rotate_is_exact_where_the_jax_engine_approximates():
    """On a coordinate image, the port's batched Rotate is the direct warp
    (``F.rotate``) to the bit, nearest, where the JAX engine's three-shear
    lands within one source pixel of it."""
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = np.broadcast_to(np.stack([ii, jj, np.full_like(ii, 7)])[None],
                          (N, 3, H, W)).astype(np.uint8)
    got = T.apply_ops_batched(torch.from_numpy(img.copy()),
                              torch.full((N,), NAMES.index("Rotate")),
                              torch.full((N,), 9.0, dtype=torch.float64), NAMES)
    want = np.asarray(JF.rotate(_nhwc(img[:1])[0], 9.0, "nearest"))
    for i in range(N):
        assert _max_diff(got[i].numpy(), want.transpose(2, 0, 1)) == 0
    assert (got[0] != torch.from_numpy(img[0])).any()
