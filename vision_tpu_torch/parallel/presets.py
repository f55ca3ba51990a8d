"""The reference recipes' train-side presets and the detection collation
(counterparts of ``references/detection/presets.py``,
``references/classification/presets.py``,
``references/segmentation/presets.py`` and
``references/video_classification/presets.py``, and of the batching in
``references/detection/train.py:289-321``).

Each preset takes one sample, moves its tensors to the preset's device
(the card unless the caller passes ``device="cpu"``; without waiting when
they lie in pinned memory, as a loader with ``pin_memory=True`` gives
them) and runs the per-sample transforms there
(``transforms/v2/_transform.py``); its draws come from the CPU generator
it is given (a ``Record`` or ``Replay`` too), as Python numbers. A
detection sample costs the card one host synchronisation
(``SanitizeBoundingBoxes``), two with ``RandomIoUCrop`` (``ssd``,
``ssdlite``); a classification or segmentation sample or a clip none. A detection sample is ``(Image, {"boxes":
BoundingBoxes, "labels": tensor[, "masks": Mask][, "keypoints":
KeyPoints]})``.

``collate_detection`` batches the preset's outputs of any sizes through
the detector's own ``GeneralizedRCNNTransform``, as
``tools/detection_request.py:train_batch`` batches raw images. The JAX
recipe instead pastes each image on one canvas *before* the preset
(``train.py:240-246``), so that the policies that change a sample's size
(``multiscale``, ``ssd``, ``ssdlite``) give ``np.stack`` mismatched shapes
(``train.py:318``); here every policy batches.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.models._api import resolve_device
from vision_tpu_torch.models.detection.transform import (
    GeneralizedRCNNTransform,
    resize_boxes,
    resize_keypoints,
)
from vision_tpu_torch.transforms import ImageClassification
from vision_tpu_torch.transforms import v2 as T
from vision_tpu_torch.transforms.v2 import functional as F
from vision_tpu_torch.transforms.v2._transform import (
    SampleGenerator,
    randint,
    uniform,
)

__all__ = [
    "COCO_PERSON_KEYPOINT_FLIP_INDICES",
    "ClassificationPresetEval",
    "ClassificationPresetTrain",
    "DetectionPresetEval",
    "DetectionPresetTrain",
    "KINETICS_MEAN",
    "KINETICS_STD",
    "SegmentationPresetEval",
    "SegmentationPresetTrain",
    "VideoClassificationPresetEval",
    "VideoClassificationPresetTrain",
    "collate_detection",
]

Device = Union[str, torch.device, None]

# COCO person keypoints (nose, left/right eye, ear, shoulder, elbow, wrist,
# hip, knee, ankle): a mirror swaps each left/right pair
COCO_PERSON_KEYPOINT_FLIP_INDICES = (
    0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15,
)
KINETICS_MEAN = (0.43216, 0.394666, 0.37645)
KINETICS_STD = (0.22803, 0.22145, 0.216989)
MULTISCALE_SIZES = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)


def _to(sample: Any, device: torch.device) -> Any:
    """The sample's tensors on ``device``; from pinned host memory without
    waiting (a copy from pageable memory is a host synchronisation)."""
    def move(x):
        if not isinstance(x, torch.Tensor) or x.device == device:
            return x
        return x.to(device, non_blocking=x.device.type == "cpu"
                    and device.type == "cuda" and x.is_pinned())

    return pytree.tree_map(move, sample)


class _Preset:
    def __init__(self, transforms: Sequence[Any], device: Device):
        self.transforms = T.Compose(list(transforms))
        self.device = resolve_device(device)

    def __call__(self, sample: Any, generator: SampleGenerator = None) -> Any:
        return self.transforms(_to(sample, self.device), generator)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.transforms!r})"


class DetectionPresetTrain(_Preset):
    """``references/detection/presets.py:31-86``: ``data_augmentation`` one
    of ``"hflip"`` (the R-CNNs), ``"lsj"`` (scale jitter to 1024 and a
    1024 crop, padded where short), ``"multiscale"`` (short side one of
    480-800, long side at most 1333), ``"ssd"`` (photometric distortion,
    zoom-out on a canvas of ``mean``, IoU crop) and ``"ssdlite"`` (IoU
    crop); each then mirrors with ``hflip_prob`` (keypoints re-ordered by
    ``keypoint_flip_indices``), scales to f32 in [0, 1], converts the boxes
    to XYXY and drops the degenerate ones with their labels, masks and
    keypoints."""

    def __init__(self, *, data_augmentation: str, hflip_prob: float = 0.5,
                 mean: Tuple[float, ...] = (123.0, 117.0, 104.0),
                 keypoint_flip_indices: Optional[Sequence[int]] = None,
                 device: Device = None):
        hflip = T.RandomHorizontalFlip(
            hflip_prob, keypoint_flip_indices=keypoint_flip_indices)
        policies = {
            "hflip": lambda: [hflip],
            "lsj": lambda: [T.ScaleJitter(target_size=(1024, 1024),
                                          antialias=True),
                            T.RandomCrop((1024, 1024), pad_if_needed=True,
                                         fill=0), hflip],
            "multiscale": lambda: [T.RandomShortestSize(
                min_size=MULTISCALE_SIZES, max_size=1333), hflip],
            "ssd": lambda: [T.RandomPhotometricDistort(),
                            T.RandomZoomOut(fill=list(mean)),
                            T.RandomIoUCrop(), hflip],
            "ssdlite": lambda: [T.RandomIoUCrop(), hflip],
        }
        if data_augmentation not in policies:
            raise ValueError(f'Unknown data augmentation policy '
                             f'"{data_augmentation}"')
        self.data_augmentation = data_augmentation
        super().__init__(policies[data_augmentation]() + [
            T.ToDtype(torch.float32, scale=True),
            T.ConvertBoundingBoxFormat("XYXY"),
            T.SanitizeBoundingBoxes()], device)


class DetectionPresetEval(_Preset):
    """``references/detection/presets.py:91``: to f32 in [0, 1]."""

    def __init__(self, device: Device = None):
        super().__init__([T.ToDtype(torch.float32, scale=True)], device)


class ClassificationPresetTrain(_Preset):
    """``references/classification/presets.py:13-57``: RandomResizedCrop
    (antialiased), a mirror with ``hflip_prob``, the ``auto_augment_policy``
    (``"ra"``, ``"ta_wide"``, ``"augmix"``, or an AutoAugment policy:
    ``"imagenet"``, ``"cifar10"``, ``"svhn"``), to f32, normalise, and
    RandomErasing with ``random_erase_prob``, on one uint8 ``[C, H, W]``
    image."""

    def __init__(self, *, crop_size: int,
                 mean: Sequence[float] = (0.485, 0.456, 0.406),
                 std: Sequence[float] = (0.229, 0.224, 0.225),
                 interpolation: str = "bilinear", hflip_prob: float = 0.5,
                 auto_augment_policy: Optional[str] = None,
                 ra_magnitude: int = 9, augmix_severity: int = 3,
                 random_erase_prob: float = 0.0, device: Device = None):
        transforms: List[Any] = [T.RandomResizedCrop(
            crop_size, interpolation=interpolation, antialias=True)]
        if hflip_prob > 0:
            transforms.append(T.RandomHorizontalFlip(hflip_prob))
        if auto_augment_policy == "ra":
            transforms.append(T.RandAugment(interpolation=interpolation,
                                            magnitude=ra_magnitude))
        elif auto_augment_policy == "ta_wide":
            transforms.append(T.TrivialAugmentWide(interpolation=interpolation))
        elif auto_augment_policy == "augmix":
            transforms.append(T.AugMix(severity=augmix_severity))
        elif auto_augment_policy is not None:
            transforms.append(T.AutoAugment(policy=auto_augment_policy,
                                            interpolation=interpolation))
        transforms += [T.ToDtype(torch.float32, scale=True),
                       T.Normalize(mean=list(mean), std=list(std))]
        if random_erase_prob > 0:
            transforms.append(T.RandomErasing(p=random_erase_prob))
        super().__init__(transforms, device)


class ClassificationPresetEval:
    """``references/classification/presets.py:60``: the weights' inference
    preset (``ImageClassification``)."""

    def __init__(self, *, crop_size: int, resize_size: int = 256,
                 mean: Sequence[float] = (0.485, 0.456, 0.406),
                 std: Sequence[float] = (0.229, 0.224, 0.225),
                 interpolation: str = "bilinear", device: Device = None):
        self._preset = ImageClassification(
            crop_size=crop_size, resize_size=resize_size, mean=mean, std=std,
            interpolation=interpolation, device=device)

    def __call__(self, img: torch.Tensor, generator=None) -> torch.Tensor:
        return self._preset(img)


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _round_size(h: int, w: int, short: int) -> Tuple[int, int]:
    scale = short / min(h, w)
    return int(round(h * scale)), int(round(w * scale))


def _nearest_rows(m: int, n: int, device) -> torch.Tensor:
    """The source index of each of ``n`` outputs from ``m`` inputs that
    ``jax.image.resize(..., "nearest")`` takes on the CPU: ``floor((i +
    0.5) * (m * (1 / n)))`` in f32, the order XLA evaluates its ``(i + 0.5)
    * m / n`` in (exact ties such as 2.5 * 30 / 25 fall to the row below;
    held against JAX over every ``m`` in 1-199 and ``n`` in 1-399 by
    steps of 3 and 7)."""
    f32 = np.float32
    scale = f32(m) * f32(1.0 / n)
    idx = np.floor((np.arange(n, dtype=f32) + f32(0.5)) * scale)
    return torch.from_numpy(np.minimum(idx, m - 1).astype(np.int64)).to(device)


class _Segmentation(T.Transform):
    """The segmentation recipe on one ``(Image, Mask)`` sample: the image
    resized (bilinear, antialiased where it shrinks, in f32 with no
    rounding, ``jax.image.resize``'s weights) so that its short side is
    ``size``, its mask by the nearest pixel centre (``jax.image.resize``'s
    ``"nearest"``); with ``train``, mirrored with ``hflip_prob``, padded at
    the bottom and right to ``crop_size`` (image 0, mask 255) and cropped
    to ``crop_size`` at a uniform corner; the image scaled to [0, 1] and
    normalised (f32), the mask int64. Params: ``size``, ``flip``, ``top``,
    ``left`` (``size`` drawn in ``[base / 2, 2 base]`` when training)."""

    _transformed_types = (tv_tensors.Image, tv_tensors.Mask)

    def __init__(self, base_size: int, crop_size: Optional[int], mean, std,
                 hflip_prob: float, train: bool):
        self.base_size = base_size
        self.crop_size = crop_size
        self.mean = [float(m) for m in mean]
        self.std = [float(v) for v in std]
        self.hflip_prob = hflip_prob
        self.train = train

    def make_params(self, flat_inputs, generator):
        img = next(x for x in flat_inputs if isinstance(x, tv_tensors.Image))
        h, w = img.shape[-2:]
        if not self.train:
            return dict(size=self.base_size, flip=False, top=0, left=0)
        size = randint(generator, int(0.5 * self.base_size),
                       int(2.0 * self.base_size) + 1)
        flip = uniform(generator) < self.hflip_prob
        nh, nw = _round_size(h, w, size)
        c = self.crop_size
        return dict(size=size, flip=flip,
                    top=randint(generator, 0, max(nh, c) - c + 1),
                    left=randint(generator, 0, max(nw, c) - c + 1))

    def transform_sample(self, inpt, params):
        is_mask = isinstance(inpt, tv_tensors.Mask)
        x = inpt.as_subclass(torch.Tensor)
        size = _round_size(*x.shape[-2:], params["size"])
        if is_mask:
            x = x.index_select(-2, _nearest_rows(x.shape[-2], size[0], x.device))
            x = x.index_select(-1, _nearest_rows(x.shape[-1], size[1], x.device))
        else:
            x = F.resize_2d(x.float(), size)
        if params["flip"]:
            x = x.flip(-1)
        if self.train:
            c = self.crop_size
            ph, pw = max(0, c - x.shape[-2]), max(0, c - x.shape[-1])
            if ph or pw:
                x = torch.nn.functional.pad(x, (0, pw, 0, ph),
                                            value=255 if is_mask else 0)
            top, left = params["top"], params["left"]
            x = x[..., top:top + c, left:left + c]
        if is_mask:
            return x.long()
        return F.normalize_image(x / 255.0, self.mean, self.std)


class _SegmentationPreset(_Preset):
    def __call__(self, sample, generator: SampleGenerator = None):
        img, target = sample
        if not isinstance(img, tv_tensors.Image):
            img = tv_tensors.Image(img)
        if not isinstance(target, tv_tensors.Mask):
            target = tv_tensors.Mask(target)
        img, target = super().__call__((img, target), generator)
        return img.as_subclass(torch.Tensor), target.as_subclass(torch.Tensor)


class SegmentationPresetTrain(_SegmentationPreset):
    """``references/segmentation/presets.py`` (the JAX recipe's): on one
    ``(image uint8 [3, H, W], mask [H, W])`` sample, the short side
    resized to a uniform integer in ``[base_size / 2, 2 base_size]``, a
    mirror with ``hflip_prob``, padding to ``crop_size`` (mask 255), a
    uniform ``crop_size`` crop, to [0, 1] and normalised. Returns f32 ``[3,
    crop, crop]`` and int64 ``[crop, crop]`` on the preset's device."""

    def __init__(self, *, base_size: int, crop_size: int, hflip_prob: float = 0.5,
                 mean=_IMAGENET_MEAN, std=_IMAGENET_STD, device: Device = None):
        super().__init__([_Segmentation(base_size, crop_size, mean, std,
                                        hflip_prob, train=True)], device)


class SegmentationPresetEval(_SegmentationPreset):
    """``references/segmentation/presets.py``: the short side resized to
    ``base_size``, to [0, 1] and normalised; nothing drawn."""

    def __init__(self, *, base_size: int, mean=_IMAGENET_MEAN,
                 std=_IMAGENET_STD, device: Device = None):
        super().__init__([_Segmentation(base_size, None, mean, std, 0.0,
                                        train=False)], device)


def _short_side_size(h: int, w: int, size: int) -> Tuple[int, int]:
    scale = size / min(h, w)
    return int(round(h * scale)), int(round(w * scale))


class _VideoClip(T.Transform):
    """The Kinetics recipe on one clip ``[T, C, H, W]``: bilinear resize of
    the short side to ``resize_size``, antialiased when it shrinks, as the
    JAX preset's ``jax.image.resize`` call is, whatever its docstring says
    (``resize_2d``'s default weights are that call's), to [0, 1],
    mirror (``train``: with ``hflip_prob``), normalise, ``crop_size`` crop
    (``train``: at a uniform corner; else central); returns f32 ``[C, T,
    crop, crop]``. Params: ``flip``, ``top``, ``left``."""

    _transformed_types = (tv_tensors.Video, torch.Tensor)

    def __init__(self, crop_size: int, resize_size: int, mean, std,
                 hflip_prob: float, train: bool):
        self.crop_size = crop_size
        self.resize_size = resize_size
        self.mean = [float(m) for m in mean]
        self.std = [float(s) for s in std]
        self.hflip_prob = hflip_prob
        self.train = train

    def _resized(self, flat_inputs) -> Tuple[int, int]:
        clip = next(x for x in flat_inputs if isinstance(x, torch.Tensor))
        return _short_side_size(*clip.shape[-2:], self.resize_size)

    def make_params(self, flat_inputs, generator):
        h, w = self._resized(flat_inputs)
        c = self.crop_size
        if not self.train:
            return dict(flip=False, top=(h - c) // 2, left=(w - c) // 2)
        flip = uniform(generator) < self.hflip_prob
        return dict(flip=flip, top=randint(generator, 0, h - c + 1),
                    left=randint(generator, 0, w - c + 1))

    def transform_sample(self, inpt, params):
        clip = inpt.as_subclass(torch.Tensor)
        scale = 1.0 / 255.0 if clip.dtype == torch.uint8 else 1.0
        size = _short_side_size(*clip.shape[-2:], self.resize_size)
        x = F.resize_2d(clip.float(), size) * scale
        if params["flip"]:
            x = x.flip(-1)
        x = F.normalize_image(x, self.mean, self.std)
        c, top, left = self.crop_size, params["top"], params["left"]
        return x[..., top:top + c, left:left + c].transpose(-4, -3)


class _VideoPreset(_Preset):
    def __call__(self, clip: torch.Tensor, generator: SampleGenerator = None
                 ) -> torch.Tensor:
        if not isinstance(clip, tv_tensors.Video):
            clip = tv_tensors.Video(clip)  # a plain 4-d tensor is a batch
        return super().__call__(clip, generator)


class VideoClassificationPresetTrain(_VideoPreset):
    """``references/video_classification/presets.py:38-62`` on one uint8
    clip ``[T, C, H, W]`` (a ``Video`` or a plain tensor): ``_VideoClip``
    with a random mirror and crop. Returns f32 ``[C, T, crop, crop]``."""

    def __init__(self, *, crop_size: int, resize_size: int,
                 mean=KINETICS_MEAN, std=KINETICS_STD, hflip_prob: float = 0.5,
                 device: Device = None):
        super().__init__([_VideoClip(crop_size, resize_size, mean, std,
                                     hflip_prob, train=True)], device)


class VideoClassificationPresetEval(_VideoPreset):
    """``references/video_classification/presets.py:65-81``: the centre
    crop, no mirror."""

    def __init__(self, *, crop_size: int, resize_size: int,
                 mean=KINETICS_MEAN, std=KINETICS_STD, device: Device = None):
        super().__init__([_VideoClip(crop_size, resize_size, mean, std, 0.0,
                                     train=False)], device)


def _rows(values: torch.Tensor, keep: torch.Tensor, rows: int) -> torch.Tensor:
    """The kept rows of ``values`` in order, in ``rows`` rows padded with
    zeros (the first ``rows`` kept ones), on the device, with no host
    synchronisation: each kept row goes to its rank, the others to a row
    past the end that is dropped."""
    rank = keep.long().cumsum(0) - 1
    slot = torch.where(keep & (rank < rows), rank, torch.full_like(rank, rows))
    out = values.new_zeros((rows + 1, *values.shape[1:]))
    out.index_copy_(0, slot, values)
    return out[:rows]


def collate_detection(samples: Sequence[Tuple[Any, dict]],
                      transform: GeneralizedRCNNTransform,
                      max_boxes: int = 100) -> dict:
    """The train batch of ``samples`` (``DetectionPresetTrain`` outputs, f32
    images in [0, 1] of any sizes): the images through ``transform``
    (normalised, resized, padded to its canvas, on its device), each
    sample's XYXY boxes mapped to its resized image (``resize_boxes``),
    the rows with ``x2 > x1 + 1`` and ``y2 > y1 + 1`` kept, the first
    ``max_boxes`` of them, padded with zeros to ``max_boxes``
    (``references/detection/train.py:289-321``): ``{"image", "boxes",
    "labels", "valid"}``, and ``"masks"`` (f32 ``[N, max_boxes, H, W]``,
    nearest-resized, on the canvas) and ``"keypoints"`` (``[N, max_boxes,
    K, 3]``) where the samples carry them. No host synchronisation."""
    images = [img.as_subclass(torch.Tensor) for img, _ in samples]
    batch = transform(images)
    dev = batch.tensors.device
    canvas = tuple(batch.tensors.shape[-2:])
    out = {"image": batch.tensors, "boxes": [], "labels": [], "valid": []}
    for (img, target), size in zip(samples, batch.image_sizes):
        hw = tuple(img.shape[-2:])
        boxes = resize_boxes(target["boxes"].as_subclass(torch.Tensor)
                             .to(dev, torch.float32), hw, size)
        keep = ((boxes[:, 2] > boxes[:, 0] + 1)
                & (boxes[:, 3] > boxes[:, 1] + 1))
        out["boxes"].append(_rows(boxes, keep, max_boxes))
        out["labels"].append(_rows(target["labels"].to(dev).long(), keep,
                                   max_boxes))
        out["valid"].append(_rows(keep, keep, max_boxes))
        if "masks" in target:
            masks = F.resize_mask(target["masks"].as_subclass(torch.Tensor)
                                  .to(dev), list(size))
            masks = F.pad_image(masks.float().unsqueeze(-3),
                                [0, 0, canvas[1] - size[1],
                                 canvas[0] - size[0]]).squeeze(-3)
            out.setdefault("masks", []).append(_rows(masks, keep, max_boxes))
        if "keypoints" in target:
            kp = resize_keypoints(target["keypoints"].as_subclass(torch.Tensor)
                                  .to(dev, torch.float32), hw, size)
            out.setdefault("keypoints", []).append(_rows(kp, keep, max_boxes))
    return {k: v if k == "image" else torch.stack(v) for k, v in out.items()}
