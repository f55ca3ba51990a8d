"""The reference recipes' presets (``vision_tpu_torch.parallel.presets``)
against the JAX package's (``references/detection/presets.py``,
``references/classification/presets.py``,
``references/video_classification/presets.py``) on the CPU, each JAX
preset's draws handed to the port (``torch_sample_cases.Spy``, or the
video preset's numpy ``RandomState`` played again), and
``collate_detection``.

Tolerances: boxes, labels, masks and keypoints exact (boxes and keypoints
within 1e-6 of the largest coordinate); detection images (f32 in [0, 1])
within 1e-6 but at most one uint8 level (1/255) on at most 1% of the
pixels, where a uint8 resize sits on a near-tie or a uint8 colour op on a
truncation boundary (``tests/test_torch_transforms_sample.py``);
classification outputs (normalised) within 1e-5 of the largest value but
at most one uint8 level over ``std`` on at most 2% of the values (one
level earlier moves an equalised or auto-contrasted pixel's neighbours);
the video preset within 1e-5 (``jax.image.resize``'s weights, which the
port computes in the same f32 arithmetic, summed in another order).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu import tv_tensors as jtv
from vision_tpu.transforms.v2 import functional as JF
from vision_tpu_torch import tv_tensors as tv
from vision_tpu_torch.models.detection import GeneralizedRCNNTransform
from vision_tpu_torch.models.detection.transform import resize_boxes
from vision_tpu_torch.parallel import presets as P
from vision_tpu_torch.transforms import v2 as T
from vision_tpu_torch.transforms.v2.functional import resize_2d

from torch_sample_cases import (
    detection_sample,
    image,
    key,
    leaves_match,
    port_log,
    spy,
)

ROOT = Path(__file__).resolve().parent.parent
COORD_TOL = 1e-6
LEVEL = 1.0 / 255.0
LEVEL_SHARE = 1e-2
NORM_TOL = 1e-5
NORM_LEVEL_SHARE = 2e-2
VIDEO_TOL = 1e-5


def reference(task):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{task}_presets", ROOT / "references" / task / "presets.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JDET, JCLS, JVID = (reference(t) for t in ("detection", "classification",
                                           "video_classification"))


def test_the_flip_indices_are_the_jax_recipes():
    assert P.COCO_PERSON_KEYPOINT_FLIP_INDICES == \
        JDET.COCO_PERSON_KEYPOINT_FLIP_INDICES
    assert P.KINETICS_MEAN == JVID.KINETICS_MEAN
    assert P.KINETICS_STD == JVID.KINETICS_STD


@pytest.mark.parametrize("policy", ["hflip", "lsj", "multiscale", "ssd",
                                    "ssdlite"])
@pytest.mark.parametrize("seed", [0, 1])
def test_detection_preset_matches_jax(policy, seed):
    flip = P.COCO_PERSON_KEYPOINT_FLIP_INDICES
    port, jx = detection_sample(seed)
    jpreset = JDET.DetectionPresetTrain(data_augmentation=policy,
                                        keypoint_flip_indices=flip)
    log = []
    spy(jpreset.transforms, log)
    want = jpreset(jx, key(seed))
    preset = P.DetectionPresetTrain(data_augmentation=policy,
                                    keypoint_flip_indices=flip, device="cpu")
    replay = T.Replay(port_log(log))
    got = preset(port, replay)
    assert replay.exhausted
    assert isinstance(got[0], tv.Image) and got[0].dtype == torch.float32
    assert got[1]["boxes"].format is tv.BoundingBoxFormat.XYXY
    pairs = leaves_match(got, want)
    (img, jimg), others = pairs[0], pairs[1:]
    diff = np.abs(img - jimg)
    assert float(diff.max()) <= LEVEL + COORD_TOL
    assert float((diff > COORD_TOL).mean()) <= LEVEL_SHARE
    for g, w in others:
        if np.issubdtype(g.dtype, np.floating):
            scale = max(float(np.abs(w).max()), 1.0)
            assert float(np.abs(g - w).max()) <= COORD_TOL * scale
        else:
            np.testing.assert_array_equal(g, w)


def test_detection_eval_preset_matches_jax():
    port, jx = detection_sample(4)
    got = P.DetectionPresetEval(device="cpu")(port)
    want = JDET.DetectionPresetEval()(jx)
    for g, w in leaves_match(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("policy", ["ra", "ta_wide", "augmix", "imagenet"])
@pytest.mark.parametrize("seed", [0, 1])
def test_classification_preset_matches_jax(policy, seed):
    img = image(seed, 56, 72)
    kw = dict(crop_size=32, auto_augment_policy=policy, random_erase_prob=0.5)
    jpreset = JCLS.ClassificationPresetTrain(**kw)
    log = []
    spy(jpreset.transforms, log)
    want = np.asarray(jpreset(jtv.Image(img), key=key(seed)).data)
    for entry in log:
        if "v" in entry and isinstance(entry["v"], torch.Tensor):
            entry["v"] = entry["v"].permute(2, 0, 1)  # JAX's erase fill: HWC
    replay = T.Replay(port_log(log, augmix=policy == "augmix"))
    got = P.ClassificationPresetTrain(**kw, device="cpu")(
        torch.from_numpy(img.transpose(2, 0, 1).copy()), replay)
    assert replay.exhausted
    got = got.numpy().transpose(1, 2, 0)
    level = LEVEL / np.asarray([0.229, 0.224, 0.225])
    diff = np.abs(got - want)
    assert bool((diff <= level + NORM_TOL * np.abs(want).max()).all())
    assert float((diff > NORM_TOL * np.abs(want).max()).mean()) <= \
        NORM_LEVEL_SHARE


def test_classification_eval_preset_matches_jax():
    img = image(3, 60, 80)
    want = np.asarray(JCLS.ClassificationPresetEval(crop_size=32, resize_size=40)(
        jnp.asarray(img)))
    got = P.ClassificationPresetEval(crop_size=32, resize_size=40, device="cpu")(
        torch.from_numpy(img.transpose(2, 0, 1).copy()))
    level = LEVEL / np.asarray([0.229, 0.224, 0.225])
    assert bool((np.abs(got.numpy().transpose(1, 2, 0) - want)
                 <= level + NORM_TOL).all())


def clip(seed=0, t=4, h=32, w=40):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), np.uint8)


def numpy_draws(seed, clip_hw, crop, resize):
    """The JAX video preset's draws (``rng.rand()``, then two
    ``rng.randint``s) played again from the same ``RandomState``."""
    rng = np.random.RandomState(seed)
    h, w = P._short_side_size(*clip_hw, resize)
    flip = rng.rand() < 0.5
    return {"flip": bool(flip), "top": int(rng.randint(0, h - crop + 1)),
            "left": int(rng.randint(0, w - crop + 1))}


@pytest.mark.parametrize("crop,resize", [(16, 20), (24, 28)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_video_preset_matches_jax(crop, resize, seed):
    x = clip(seed)
    want = JVID.VideoClassificationPresetTrain(crop_size=crop, resize_size=resize)(
        x, np.random.RandomState(seed))
    got = P.VideoClassificationPresetTrain(
        crop_size=crop, resize_size=resize, device="cpu")(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        T.Replay([numpy_draws(seed, x.shape[1:3], crop, resize)]))
    assert got.shape == (3, 4, crop, crop) and got.dtype == torch.float32
    want = want.transpose(3, 0, 1, 2)
    assert float(np.abs(got.numpy() - want).max()) <= VIDEO_TOL * np.abs(want).max()
    want_eval = JVID.VideoClassificationPresetEval(
        crop_size=crop, resize_size=resize)(x)
    got_eval = P.VideoClassificationPresetEval(
        crop_size=crop, resize_size=resize, device="cpu")(
        tv.Video(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())))
    assert float(np.abs(got_eval.numpy() - want_eval.transpose(3, 0, 1, 2)).max()
                 ) <= VIDEO_TOL * np.abs(want_eval).max()


def test_video_preset_antialiases_as_the_jax_preset_does():
    """The JAX preset says "antialias off" but calls ``jax.image.resize``,
    whose ``antialias`` defaults to True: an 8-row stripe resized to 4
    rows reads [0.571, 0.5, 0.5, 0.429], not the 0.5s of antialias off.
    The port's default ``resize_2d`` (antialiased bilinear) gives the same."""
    stripe = np.zeros((8, 1, 1), np.float32)
    stripe[::2] = 1.0
    default = np.asarray(jax.image.resize(stripe, (4, 1, 1), "bilinear")).ravel()
    off = np.asarray(jax.image.resize(stripe, (4, 1, 1), "bilinear",
                                      antialias=False)).ravel()
    np.testing.assert_allclose(default, [4 / 7, 0.5, 0.5, 3 / 7], atol=1e-6)
    np.testing.assert_allclose(off, [0.5] * 4, atol=1e-6)
    got = resize_2d(torch.from_numpy(stripe[:, :, 0]).T[None], (1, 4)
                    ).ravel().numpy()
    np.testing.assert_allclose(got, default, atol=1e-6)
    x = clip(5, t=2, h=40, w=48)
    want = JVID.VideoClassificationPresetEval(crop_size=16, resize_size=20)(x)
    got = P.VideoClassificationPresetEval(crop_size=16, resize_size=20,
                                          device="cpu")(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert float(np.abs(got.numpy() - want.transpose(3, 0, 1, 2)).max()) <= \
        VIDEO_TOL * np.abs(want).max()


def collate_reference(samples, transform, rows):
    """``references/detection/train.py:289-321`` on the port's preset
    outputs: boxes mapped to the canvas, the rows with x2 > x1 + 1 and
    y2 > y1 + 1, the first ``rows``, zero-padded; each kept mask resized as
    ``train.py:258-268`` resizes it (the JAX package's nearest ``resize``)
    and placed at the canvas's top left; in numpy."""
    out = {"boxes": [], "labels": [], "valid": [], "keypoints": [],
           "masks": []}
    canvas = transform.fixed_size
    for img, target in samples:
        size = transform._target_size(*img.shape[-2:])
        b = resize_boxes(target["boxes"].as_tensor(), tuple(img.shape[-2:]),
                         size).numpy()
        keep = (b[:, 2] > b[:, 0] + 1) & (b[:, 3] > b[:, 1] + 1)
        sel = np.nonzero(keep)[0][:rows]
        boxes = np.zeros((rows, 4), np.float32)
        labels = np.zeros((rows,), np.int64)
        valid = np.zeros((rows,), bool)
        boxes[:len(sel)] = b[sel]
        labels[:len(sel)] = target["labels"].numpy()[sel]
        valid[:len(sel)] = True
        k = target["keypoints"].as_tensor().numpy()
        scale = np.array([size[1] / img.shape[-1], size[0] / img.shape[-2], 1.0],
                         np.float32)
        kp = np.zeros((rows, *k.shape[1:]), np.float32)
        kp[:len(sel)] = (k * scale)[sel]
        m = target["masks"].as_tensor().numpy()
        masks = np.zeros((rows, *canvas), np.float32)
        for row, i in enumerate(sel):
            masks[row, :size[0], :size[1]] = np.asarray(JF.resize(
                m[i][..., None].astype(np.uint8), size,
                interpolation="nearest"))[..., 0]
        for name, v in (("boxes", boxes), ("labels", labels), ("valid", valid),
                        ("keypoints", kp), ("masks", masks)):
            out[name].append(v)
    return {k: np.stack(v) for k, v in out.items()}


@pytest.mark.parametrize("policy", ["multiscale", "ssd", "ssdlite"])
@pytest.mark.parametrize("rows", [3, 8])
def test_collate_detection_batches_samples_of_mixed_sizes(policy, rows):
    preset = P.DetectionPresetTrain(data_augmentation=policy, device="cpu")
    g = torch.Generator().manual_seed(7)
    samples = [preset(detection_sample(seed, h=40 + 8 * seed, w=64)[0], g)
               for seed in range(4)]
    sizes = {tuple(img.shape[-2:]) for img, _ in samples}
    transform = GeneralizedRCNNTransform(min_size=96, max_size=128,
                                         device="cpu")
    batch = P.collate_detection(samples, transform, max_boxes=rows)
    n = len(samples)
    assert batch["image"].shape == (n, 3, 128, 128)
    assert batch["masks"].shape == (n, rows, 128, 128)
    want = collate_reference(samples, transform, rows)
    np.testing.assert_allclose(batch["boxes"].numpy(), want["boxes"],
                               rtol=0, atol=COORD_TOL * 128)
    np.testing.assert_array_equal(batch["labels"].numpy(), want["labels"])
    np.testing.assert_array_equal(batch["valid"].numpy(), want["valid"])
    np.testing.assert_allclose(batch["keypoints"].numpy(), want["keypoints"],
                               rtol=0, atol=COORD_TOL * 128)
    assert want["masks"].any()
    np.testing.assert_array_equal(batch["masks"].numpy(), want["masks"])
    if policy != "multiscale":
        assert len(sizes) > 1, sizes


def test_presets_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda d: P.DetectionPresetTrain(data_augmentation="ssd",
                                                  device=d),
                 lambda d: P.DetectionPresetEval(device=d),
                 lambda d: P.ClassificationPresetTrain(crop_size=8, device=d),
                 lambda d: P.ClassificationPresetEval(crop_size=8, device=d),
                 lambda d: P.VideoClassificationPresetTrain(
                     crop_size=8, resize_size=10, device=d),
                 lambda d: P.VideoClassificationPresetEval(
                     crop_size=8, resize_size=10, device=d)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(None)
        make("cpu")
