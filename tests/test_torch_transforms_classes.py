"""The per-sample transform classes (``vision_tpu_torch.transforms.v2``)
against the JAX package's, on the CPU: each JAX transform runs on a
numpy-seeded detection sample (image, boxes, labels, masks, keypoints) or
an image or a clip, its draws are captured (``torch_sample_cases.Spy``:
its ``make_params``, its gate, or the ops an auto-augment policy applied)
and handed to the port through ``Replay``, and every leaf of the two
outputs is compared. Then the port's own draws: each gate fires at its
``p`` (a binomial check, four standard deviations), the crops and
canvases stay in their ranges, and ``Record`` / ``Replay`` give the same
output again.

Tolerances: geometry (flips, crops, pads, zoom-out) exact in uint8, boxes
and keypoints within 1e-6 of the largest coordinate; a resize in uint8
exact but one level at most on at most 1% of the pixels (near-ties, as in
``tests/test_torch_transforms.py``); the colour transforms on uint8 one
level at most on at most 1% of the pixels (an f32 blend or blur landing
on a truncation boundary, ``tests/test_torch_transforms_sample.py``), on
float within 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu import tv_tensors as jtv
from vision_tpu.transforms import v2 as JT
from vision_tpu_torch import tv_tensors as tv
from vision_tpu_torch.transforms import v2 as T
from vision_tpu_torch.transforms.v2._transform import host_generator

from torch_sample_cases import (
    detection_sample,
    image,
    key,
    leaves_match,
    port_log,
    spy,
)

FLOAT_TOL = 1e-6  # of the largest value (at least 1): pixels, boxes, keypoints
LEVEL_SHARE = 1e-2


def compare(got, want, exact_pixels=True):
    for g, w in leaves_match(got, want):
        if g.dtype == np.uint8:
            diff = np.abs(g.astype(int) - w.astype(int))
            if exact_pixels:
                assert not diff.any()
            else:
                assert int(diff.max()) <= 1 and diff.mean() <= LEVEL_SHARE
        elif np.issubdtype(g.dtype, np.floating):
            scale = max(float(np.abs(w).max()), 1.0)
            assert float(np.abs(g - w).max()) <= FLOAT_TOL * scale
        else:
            np.testing.assert_array_equal(g, w)


def run_both(port_t, jax_t, seed=0, sample="detection", exact_pixels=True):
    """``jax_t`` on the JAX sample (its draws captured), ``port_t`` on the
    port's with those draws; the two outputs compared."""
    if sample == "detection":
        port, jx = detection_sample(seed)
    else:
        img = image(seed)
        port = tv.Image(torch.from_numpy(img.transpose(2, 0, 1).copy()))
        jx = jtv.Image(img)
    log = []
    want = spy(jax_t, log)(jx, key=key(seed))
    replay = T.Replay(port_log(log))
    got = port_t(port, replay)
    assert replay.exhausted
    compare(got, want, exact_pixels)
    return log


GEOMETRY = {
    "Resize": (lambda: T.Resize([30, 50]), lambda: JT.Resize([30, 50]), False),
    "Resize_short_side": (lambda: T.Resize(40, max_size=60),
                          lambda: JT.Resize(40, max_size=60), False),
    "CenterCrop": (lambda: T.CenterCrop([30, 40]),
                   lambda: JT.CenterCrop([30, 40]), True),
    "RandomCrop": (lambda: T.RandomCrop([30, 40]),
                   lambda: JT.RandomCrop([30, 40]), True),
    "RandomCrop_pad_if_needed": (
        lambda: T.RandomCrop([56, 70], pad_if_needed=True, fill=3),
        lambda: JT.RandomCrop([56, 70], pad_if_needed=True, fill=3), True),
    "RandomCrop_padding": (lambda: T.RandomCrop(40, padding=[2, 3]),
                           lambda: JT.RandomCrop(40, padding=[2, 3]), True),
    "Pad": (lambda: T.Pad([1, 2, 3, 4], fill=9), lambda: JT.Pad([1, 2, 3, 4], fill=9),
            True),
    "RandomVerticalFlip": (lambda: T.RandomVerticalFlip(1.0),
                           lambda: JT.RandomVerticalFlip(1.0), True),
    "RandomHorizontalFlip": (
        lambda: T.RandomHorizontalFlip(1.0, keypoint_flip_indices=[
            0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]),
        lambda: JT.RandomHorizontalFlip(1.0, keypoint_flip_indices=[
            0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]), True),
    "RandomShortestSize": (lambda: T.RandomShortestSize([30, 36, 40], 70),
                           lambda: JT.RandomShortestSize([30, 36, 40], 70), False),
    "RandomResize": (lambda: T.RandomResize(24, 60), lambda: JT.RandomResize(24, 60),
                     False),
    "ScaleJitter": (lambda: T.ScaleJitter((64, 64)), lambda: JT.ScaleJitter((64, 64)),
                    False),
    "RandomZoomOut": (lambda: T.RandomZoomOut(fill=[123.0, 117.0, 104.0], p=1.0),
                      lambda: JT.RandomZoomOut(fill=[123.0, 117.0, 104.0], p=1.0),
                      True),
    "RandomIoUCrop": (lambda: T.RandomIoUCrop(), lambda: JT.RandomIoUCrop(), True),
    "RandomResizedCrop": (lambda: T.RandomResizedCrop([24, 30]),
                          lambda: JT.RandomResizedCrop([24, 30]), False),
    "ConvertBoundingBoxFormat": (lambda: T.ConvertBoundingBoxFormat("CXCYWH"),
                                 lambda: JT.ConvertBoundingBoxFormat("CXCYWH"), True),
    "ClampBoundingBoxes": (lambda: T.ClampBoundingBoxes(),
                           lambda: JT.ClampBoundingBoxes(), True),
    "SanitizeBoundingBoxes": (lambda: T.SanitizeBoundingBoxes(min_size=4.0),
                              lambda: JT.SanitizeBoundingBoxes(min_size=4.0), True),
    "ToDtype": (lambda: T.ToDtype(torch.float32, scale=True),
                lambda: JT.ToDtype(jnp.float32, scale=True), True),
    "ToDtype_dict": (
        lambda: T.ToDtype({tv.Image: torch.float32, tv.Mask: torch.int64,
                           "others": None}, scale=True),
        lambda: JT.ToDtype({jtv.Image: jnp.float32, jtv.Mask: jnp.int32,
                            "others": None}, scale=True), True),
    "Identity": (lambda: T.Identity(), lambda: JT.Identity(), True),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
@pytest.mark.parametrize("seed", [0])
def test_geometry_and_misc_classes_match_jax(name, seed):
    port_t, jax_t, exact = GEOMETRY[name]
    if name == "ToDtype_dict":
        # JAX casts masks to its int32 (x64 off): compare values, not types
        port, jx = detection_sample(seed)
        got = port_t()(port)
        want = jax_t()(jx, key=key(seed))
        assert got[1]["masks"].dtype == torch.int64
        assert got[0].dtype == torch.float32
        np.testing.assert_array_equal(got[1]["masks"].as_tensor().numpy(),
                                      np.asarray(want[1]["masks"].data))
        return
    run_both(port_t(), jax_t(), seed, exact_pixels=exact)


COLOUR = {
    "ColorJitter": (lambda: T.ColorJitter(0.4, 0.4, 0.4, 0.1),
                    lambda: JT.ColorJitter(0.4, 0.4, 0.4, 0.1)),
    "RandomPhotometricDistort": (lambda: T.RandomPhotometricDistort(p=0.7),
                                 lambda: JT.RandomPhotometricDistort(p=0.7)),
    "Grayscale": (lambda: T.Grayscale(3), lambda: JT.Grayscale(3)),
    "RandomGrayscale": (lambda: T.RandomGrayscale(1.0), lambda: JT.RandomGrayscale(1.0)),
    "RGB": (lambda: T.RGB(), lambda: JT.RGB()),
    "RandomEqualize": (lambda: T.RandomEqualize(1.0), lambda: JT.RandomEqualize(1.0)),
    "RandomPosterize": (lambda: T.RandomPosterize(3, 1.0),
                        lambda: JT.RandomPosterize(3, 1.0)),
    "RandomSolarize": (lambda: T.RandomSolarize(100, 1.0),
                       lambda: JT.RandomSolarize(100, 1.0)),
    "RandomAutocontrast": (lambda: T.RandomAutocontrast(1.0),
                           lambda: JT.RandomAutocontrast(1.0)),
    "RandomAdjustSharpness": (lambda: T.RandomAdjustSharpness(2.0, 1.0),
                              lambda: JT.RandomAdjustSharpness(2.0, 1.0)),
    "RandomInvert": (lambda: T.RandomInvert(1.0), lambda: JT.RandomInvert(1.0)),
    "RandomChannelPermutation": (lambda: T.RandomChannelPermutation(),
                                 lambda: JT.RandomChannelPermutation()),
}


@pytest.mark.parametrize("name", sorted(COLOUR))
@pytest.mark.parametrize("seed", [1])
def test_colour_classes_match_jax(name, seed):
    port_t, jax_t = COLOUR[name]
    run_both(port_t(), jax_t(), seed, sample="image", exact_pixels=False)
    # and in a detection sample, where boxes, masks and keypoints pass
    run_both(port_t(), jax_t(), seed, exact_pixels=False)


AUTO = {
    "AutoAugment_imagenet": (lambda: T.AutoAugment("imagenet"),
                             lambda: JT.AutoAugment("imagenet")),
    "AutoAugment_cifar10": (lambda: T.AutoAugment("cifar10"),
                            lambda: JT.AutoAugment("cifar10")),
    "AutoAugment_svhn": (lambda: T.AutoAugment("svhn"), lambda: JT.AutoAugment("svhn")),
    "TrivialAugmentWide": (lambda: T.TrivialAugmentWide(),
                           lambda: JT.TrivialAugmentWide()),
    "RandAugment": (lambda: T.RandAugment(magnitude=9),
                    lambda: JT.RandAugment(magnitude=9)),
}


@pytest.mark.parametrize("name", sorted(AUTO))
@pytest.mark.parametrize("seed", range(2))
def test_auto_augment_policies_match_jax(name, seed):
    port_t, jax_t = AUTO[name]
    log = run_both(port_t(), jax_t(), seed, sample="image", exact_pixels=False)
    assert len(log) == 1


def test_augmix_matches_jax():
    """AugMix's draws: the ops come from JAX's run, its Beta and Dirichlet
    weights and chain depths from the same key, split as it splits it
    (``torch_sample_cases.augmix_params``)."""
    for seed in range(3):
        img = image(seed)
        log = []
        want = spy(JT.AugMix(severity=3), log)(jtv.Image(img), key=key(seed))
        got = T.AugMix(severity=3)(
            tv.Image(torch.from_numpy(img.transpose(2, 0, 1).copy())),
            T.Replay(port_log(log, augmix=True)))
        compare(got, want, exact_pixels=False)


def test_random_erasing_matches_jax():
    for seed in range(3):
        img = image(seed).astype(np.float32) / 255.0
        port = tv.Image(torch.from_numpy(img.transpose(2, 0, 1).copy()))
        for value in (0.0, [0.1, 0.2, 0.3]):
            log = []
            want = spy(JT.RandomErasing(p=1.0, value=value), log)(
                jtv.Image(img), key=key(seed))
            log[0]["v"] = log[0]["v"].permute(2, 0, 1)  # JAX's fill is HWC
            got = T.RandomErasing(p=1.0, value=value)(port, T.Replay(log))
            compare(got, want)


def test_containers_match_jax():
    """Compose splits the key; RandomChoice picks with ``jax.random.choice``,
    RandomApply gates, RandomOrder permutes: the picks from the same keys,
    as JAX splits them, handed across with the inner draws."""
    port, jx = detection_sample(2)
    inner = (lambda: [T.RandomVerticalFlip(1.0), T.Pad(3), T.RandomCrop(40)],
             lambda: [JT.RandomVerticalFlip(1.0), JT.Pad(3), JT.RandomCrop(40)])
    for seed in range(4):
        k = key(seed)
        # RandomChoice
        log = []
        jc = JT.RandomChoice(inner[1](), p=[0.2, 0.3, 0.5])
        jc.transforms = [spy(t, log) for t in jc.transforms]
        want = jc(jx, key=k)
        pick, _ = jax.random.split(k)
        idx = int(jax.random.choice(pick, 3, p=jnp.asarray(jc.p)))
        got = T.RandomChoice(inner[0](), p=[0.2, 0.3, 0.5])(
            port, T.Replay([{"choice": idx}] + log))
        compare(got, want)
        # RandomApply
        log = []
        ja = JT.RandomApply(inner[1](), p=0.5)
        ja.transforms = [spy(t, log) for t in ja.transforms]
        want = ja(jx, key=k)
        gate, _ = jax.random.split(k)
        applied = float(jax.random.uniform(gate)) < 0.5
        got = T.RandomApply(inner[0](), p=0.5)(
            port, T.Replay([{"applied": applied}] + log))
        compare(got, want)
        # RandomOrder
        log = []
        jo = JT.RandomOrder(inner[1]())
        jo.transforms = [spy(t, log) for t in jo.transforms]
        want = jo(jx, key=k)
        perm, _ = jax.random.split(k)
        order = np.asarray(jax.random.permutation(perm, 3)).tolist()
        got = T.RandomOrder(inner[0]())(port, T.Replay([{"order": order}] + log))
        compare(got, want)
    # Compose: its members in turn, the draws theirs
    log = []
    want = spy(JT.Compose(inner[1]()), log)(jx, key=key(9))
    compare(T.Compose(inner[0]())(port, T.Replay(log)), want)


def test_uniform_temporal_subsample_matches_jax():
    clip = np.random.default_rng(0).integers(0, 256, (16, 8, 10, 3), np.uint8)
    for n in (1, 4, 8, 16):
        want = JT.UniformTemporalSubsample(n)(jtv.Video(clip))
        got = T.UniformTemporalSubsample(n)(
            tv.Video(torch.from_numpy(clip.transpose(0, 3, 1, 2).copy())))
        assert isinstance(got, tv.Video)
        np.testing.assert_array_equal(got.as_tensor().numpy(),
                                      np.asarray(want.data).transpose(0, 3, 1, 2))


def test_lambda_and_the_sample_rule():
    port, _ = detection_sample(0)
    out = T.Lambda(lambda x: x.flip(-1), tv.Mask)(port)
    assert torch.equal(out[1]["masks"], port[1]["masks"].flip(-1))
    assert torch.equal(out[0], port[0])
    # a plain tensor beside an Image passes through; alone it is the image
    labels = port[1]["labels"]
    assert T.RandomVerticalFlip(1.0)((port[0], labels))[1] is labels
    plain = torch.arange(12.0).view(1, 3, 4)
    assert torch.equal(T.RandomVerticalFlip(1.0)(plain), plain.flip(-2))
    assert T.is_batch(torch.zeros(2, 3, 4, 4))
    assert T.is_batch((torch.zeros(2, 3, 4, 4), torch.zeros(2)))
    assert not T.is_batch(tv.Image(torch.zeros(2, 3, 4, 4)))
    assert not T.is_batch((torch.zeros(2, 3, 4, 4), {"labels": torch.zeros(2)}))
    assert not T.is_batch(torch.zeros(3, 4, 4))
    with pytest.raises(ValueError, match="CPU generator"):
        host_generator(_OnTheCard())


class _OnTheCard:
    """Stands for a CUDA generator: the CPU tests have no card."""

    device = torch.device("cuda")


def binomial_ok(count, n, p):
    return abs(count - n * p) <= 4.0 * math.sqrt(n * p * (1.0 - p))


@pytest.mark.parametrize("cls,p", [(T.RandomHorizontalFlip, 0.5),
                                   (T.RandomVerticalFlip, 0.3),
                                   (T.RandomZoomOut, 0.5),
                                   (T.RandomEqualize, 0.2),
                                   (T.RandomGrayscale, 0.1),
                                   (T.RandomErasing, 0.5)])
def test_the_port_draws_each_gate_at_its_p(cls, p):
    t = cls(p=p)
    g = torch.Generator().manual_seed(0)
    flat = [tv.Image(torch.zeros(3, 8, 8, dtype=torch.uint8))]
    n = 2000
    fired = sum(t._draw_sample(flat, g)["applied"] for _ in range(n))
    assert binomial_ok(fired, n, p)


def test_the_port_draws_stay_in_their_ranges_and_replay():
    g = torch.Generator().manual_seed(1)
    port, _ = detection_sample(3)
    zoom, crop = T.RandomZoomOut(p=1.0), T.RandomIoUCrop()
    rrc = T.RandomResizedCrop(16)
    for _ in range(50):
        rec = T.Record(g)
        out = T.Compose([zoom, crop, rrc])(port, rec)
        left, top, right, bottom = rec.params[0]["padding"]
        assert min(left, top, right, bottom) >= 0
        assert 1.0 <= (64 + left + right) / 64 <= 4.0
        if rec.params[1]:
            c = rec.params[1]
            assert 0.3 * (64 + left + right) - 1 <= c["width"] <= 64 + left + right
            assert 0.5 <= c["width"] / c["height"] <= 2.0
        assert out[0].shape == (3, 16, 16)
        again = T.Compose([zoom, crop, rrc])(port, T.Replay(rec.params))
        assert torch.equal(again[0], out[0])
        assert torch.equal(again[1]["boxes"], out[1]["boxes"])
    picks = [T.RandomChoice([T.Identity()] * 3, p=[0.2, 0.3, 0.5])
             .make_params([], g)["choice"] for _ in range(3000)]
    for k, p in enumerate((0.2, 0.3, 0.5)):
        assert binomial_ok(picks.count(k), 3000, p)
