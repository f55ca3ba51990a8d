"""Dataset -> typed-tensor bridge (reference
``torchvision/tv_tensors/_dataset_wrapper.py``
``wrap_dataset_for_transforms_v2``; the port's copy of
``vision_tpu/tv_tensors/_dataset_wrapper.py``): a view of a dataset whose
images come out as ``Image`` and whose detection and segmentation targets
as ``BoundingBoxes``, ``Mask`` and label tensors, which the per-sample
transforms dispatch on.

The factories are the reference's registry (``:19-449``), matched by
class name along the dataset's MRO: classification datasets unchanged
(Caltech101/256, CIFAR10/100, ImageNet, MNIST, FashionMNIST, GTSRB,
DatasetFolder, ImageFolder, Imagenette, CocoCaptions); segmentation
(VOCSegmentation, SBDataset) a ``Mask``; video (HMDB51, Kinetics,
UCF101) a ``Video``; CocoDetection ``{"image_id", "boxes", "labels"}``
(and ``"masks"``, decoded by the detection recipe's ``coco_utils``: the
port's RLE decode and polygon fill, where the JAX package calls
``pycocotools``), VOCDetection, CelebA, Kitti, OxfordIIITPet,
Cityscapes, WIDERFace. Images are CHW, as the port's datasets give them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from vision_tpu_torch.tv_tensors._tv_tensor import (
    BoundingBoxes,
    Image,
    Mask,
    Video,
)

__all__ = ["wrap_dataset_for_transforms_v2"]

_WRAPPER_FACTORIES: Dict[str, Callable] = {}


def _register(*names):
    def deco(factory):
        for n in names:
            _WRAPPER_FACTORIES[n] = factory
        return factory

    return deco


def _canvas_size(img) -> tuple:
    return tuple(int(s) for s in img.shape[-2:])


def _parse_target_keys(target_keys, available, default):
    if target_keys is None:
        keys = available if default == "all" else default
    elif target_keys == "all":
        keys = available
    else:
        keys = set(target_keys)
        extra = keys - set(available)
        if extra:
            raise ValueError(f"unknown target keys {sorted(extra)}")
    return set(keys)


def _list_of_dicts_to_dict_of_lists(list_of_dicts):
    out: Dict = {}
    for d in list_of_dicts:
        for k, v in d.items():
            out.setdefault(k, []).append(v)
    return out


def _xywh_to_xyxy_boxes(xywh, canvas_size) -> BoundingBoxes:
    xywh = torch.as_tensor(np.asarray(xywh, np.float32)).reshape(-1, 4)
    xyxy = torch.cat([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], dim=1)
    return BoundingBoxes(xyxy, format="XYXY", canvas_size=canvas_size)


def _raise_not_supported(description):
    raise RuntimeError(
        f"{description} is currently not supported by this wrapper. If this "
        "would be helpful for you, please open an issue.")


def _identity_factory(dataset, target_keys):
    return lambda idx, img, target: (img, target)


for _n in ("Caltech256", "CIFAR10", "CIFAR100", "ImageNet", "MNIST",
           "FashionMNIST", "GTSRB", "DatasetFolder", "ImageFolder", "Imagenette",
           "CocoCaptions"):
    _register(_n)(_identity_factory)


@_register("Caltech101")
def _caltech101_factory(dataset, target_keys):
    if "annotation" in getattr(dataset, "target_type", []):
        _raise_not_supported(
            "Caltech101 dataset with `target_type=['annotation', ...]`")
    return _identity_factory(dataset, target_keys)


def _segmentation_factory(dataset, target_keys):
    return lambda idx, img, mask: (img, Mask(torch.as_tensor(np.asarray(mask))))


_register("VOCSegmentation")(_segmentation_factory)


@_register("SBDataset")
def _sbd_factory(dataset, target_keys):
    if getattr(dataset, "mode", "segmentation") == "boundaries":
        _raise_not_supported("SBDataset with mode='boundaries'")
    return _segmentation_factory(dataset, target_keys)


def _video_factory(dataset, target_keys):
    def wrapper(idx, video, rest):
        return (Video(torch.as_tensor(np.asarray(video))),) + tuple(rest)

    return wrapper


for _n in ("HMDB51", "Kinetics", "UCF101"):
    _register(_n)(_video_factory)


def _coco_mask(segmentation, canvas_size) -> np.ndarray:
    """One annotation's mask (``pycocotools``' ``frPyObjects`` + ``merge``
    + ``decode`` in the reference): an RLE decoded, a polygon list filled
    and merged."""
    from vision_tpu_torch.references.detection.coco_utils import (
        _rasterize_polygons,
        decode_rle,
    )

    if isinstance(segmentation, dict):
        return decode_rle(segmentation)
    if isinstance(segmentation, list):
        return _rasterize_polygons(segmentation, *canvas_size)
    raise ValueError("COCO segmentation expected to be a dict or a list, got "
                     f"{type(segmentation)}")


@_register("CocoDetection")
def _coco_factory(dataset, target_keys):
    target_keys = _parse_target_keys(
        target_keys,
        available={"segmentation", "area", "iscrowd", "image_id", "bbox",
                   "category_id", "boxes", "masks", "labels"},
        default={"image_id", "boxes", "labels"})

    def wrapper(idx, img, target_list):
        canvas = _canvas_size(img)
        image_id = (dataset.ids[idx] if hasattr(dataset, "ids")
                    else (target_list[0].get("image_id") if target_list else None))
        if not target_list:
            return img, dict(image_id=image_id)
        batched = _list_of_dicts_to_dict_of_lists(target_list)
        target = {}
        if "image_id" in target_keys:
            target["image_id"] = image_id
        if "boxes" in target_keys:
            target["boxes"] = _xywh_to_xyxy_boxes(batched["bbox"], canvas)
        if "masks" in target_keys:
            target["masks"] = Mask(torch.from_numpy(np.stack(
                [_coco_mask(s, canvas) for s in batched["segmentation"]])))
        if "labels" in target_keys:
            target["labels"] = torch.tensor(batched["category_id"], dtype=torch.int64)
        for k in target_keys - {"image_id", "boxes", "masks", "labels"}:
            if k in batched:
                target[k] = batched[k]
        return img, target

    return wrapper


_VOC_CATEGORIES = (
    "__background__", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor")
_VOC_CATEGORY_TO_IDX = {n: i for i, n in enumerate(_VOC_CATEGORIES)}


@_register("VOCDetection")
def _voc_detection_factory(dataset, target_keys):
    target_keys = _parse_target_keys(
        target_keys, available={"annotation", "boxes", "labels"},
        default={"annotation", "boxes", "labels"})

    def wrapper(idx, img, target):
        objects = target.get("annotation", {}).get("object", [])
        if isinstance(objects, dict):
            objects = [objects]
        boxes = [[float(o["bndbox"][k]) for k in ("xmin", "ymin", "xmax", "ymax")]
                 for o in objects]
        out = dict(target) if "annotation" in target_keys else {}
        if "boxes" in target_keys:
            out["boxes"] = BoundingBoxes(
                torch.tensor(boxes, dtype=torch.float32).reshape(-1, 4),
                format="XYXY", canvas_size=_canvas_size(img))
        if "labels" in target_keys:
            out["labels"] = torch.tensor(
                [_VOC_CATEGORY_TO_IDX.get(o["name"], 0) for o in objects],
                dtype=torch.int64)
        return img, out

    return wrapper


@_register("CelebA")
def _celeba_factory(dataset, target_keys):
    if any(t in dataset.target_type for t in ("attr", "landmarks")):
        _raise_not_supported(
            "`CelebA` dataset with `target_type=['attr', 'landmarks', ...]`")

    def wrap_one(ttype, item, canvas):
        return _xywh_to_xyxy_boxes(item, canvas) if ttype == "bbox" else item

    def wrapper(idx, img, target):
        canvas = _canvas_size(img)
        types = dataset.target_type
        if len(types) == 1:
            return img, wrap_one(types[0], target, canvas)
        return img, tuple(wrap_one(t, item, canvas)
                          for t, item in zip(types, target))

    return wrapper


_KITTI_CATEGORIES = ("Car", "Van", "Truck", "Pedestrian", "Person_sitting",
                     "Cyclist", "Tram", "Misc", "DontCare")
_KITTI_CATEGORY_TO_IDX = {n: i for i, n in enumerate(_KITTI_CATEGORIES)}


@_register("Kitti")
def _kitti_factory(dataset, target_keys):
    target_keys = _parse_target_keys(
        target_keys,
        available={"type", "truncated", "occluded", "alpha", "bbox",
                   "dimensions", "location", "rotation_y", "boxes", "labels"},
        default={"boxes", "labels"})

    def wrapper(idx, img, target):
        if target is None:
            return img, target
        batched = _list_of_dicts_to_dict_of_lists(target)
        out = {}
        if "boxes" in target_keys:
            out["boxes"] = BoundingBoxes(
                torch.as_tensor(np.asarray(batched["bbox"], np.float32)).reshape(-1, 4),
                format="XYXY", canvas_size=_canvas_size(img))
        if "labels" in target_keys:
            out["labels"] = torch.tensor(
                [_KITTI_CATEGORY_TO_IDX[c] for c in batched["type"]],
                dtype=torch.int64)
        for k in target_keys - {"boxes", "labels"}:
            if k in batched:
                out[k] = batched[k]
        return img, out

    return wrapper


@_register("OxfordIIITPet")
def _pet_factory(dataset, target_keys):
    def wrapper(idx, img, target):
        types = getattr(dataset, "_target_types", ["category"])
        if target is None:
            return img, target

        def wrap_one(t, item):
            return Mask(torch.as_tensor(np.asarray(item))) if t == "segmentation" else item

        if len(types) == 1:
            return img, wrap_one(types[0], target)
        return img, tuple(wrap_one(t, i) for t, i in zip(types, target))

    return wrapper


@_register("Cityscapes")
def _cityscapes_factory(dataset, target_keys):
    if any(t in dataset.target_type for t in ("polygon", "color")):
        _raise_not_supported(
            "`Cityscapes` dataset with `target_type=['polygon', 'color', ...]`")

    def instance_wrapper(mask):
        # cityscapesScripts json2instanceImg: ids >= 1000 are instances
        # (label id * 1000 + instance)
        data = torch.as_tensor(np.asarray(mask))
        ids = torch.unique(data)
        return dict(masks=Mask(torch.stack([data == i for i in ids])),
                    labels=torch.tensor([int(i) // 1000 if i >= 1000 else int(i)
                                         for i in ids], dtype=torch.int64))

    def wrap_one(t, item):
        if t == "instance":
            return instance_wrapper(item)
        if t == "semantic":
            return Mask(torch.as_tensor(np.asarray(item)))
        return item

    def wrapper(idx, img, target):
        types = dataset.target_type
        if len(types) == 1:
            return img, wrap_one(types[0], target)
        return img, tuple(wrap_one(t, i) for t, i in zip(types, target))

    return wrapper


@_register("WIDERFace")
def _widerface_factory(dataset, target_keys):
    target_keys = _parse_target_keys(
        target_keys,
        available={"bbox", "blur", "expression", "illumination", "occlusion",
                   "pose", "invalid"},
        default="all")

    def wrapper(idx, img, target):
        if target is None:
            return img, target
        out = {k: target[k] for k in target_keys if k in target}
        if "bbox" in out:
            out["bbox"] = _xywh_to_xyxy_boxes(out["bbox"], _canvas_size(img))
        return img, out

    return wrapper


_TARGET_KEYS = (_coco_factory, _voc_detection_factory, _kitti_factory,
                _widerface_factory)


class _WrappedDataset:
    def __init__(self, dataset, target_keys):
        self._dataset = dataset
        factory = next((_WRAPPER_FACTORIES[cls.__name__]
                        for cls in type(dataset).__mro__
                        if cls.__name__ in _WRAPPER_FACTORIES), None)
        if target_keys is not None and factory not in _TARGET_KEYS:
            raise ValueError("target_keys is currently only supported for "
                             "CocoDetection, VOCDetection, Kitti and WIDERFace")
        factory = factory or _identity_factory
        self._wrapper = factory(dataset, target_keys)
        self._is_video = factory is _video_factory

    def __len__(self):
        return len(self._dataset)

    def __getattr__(self, name):
        return getattr(self._dataset, name)

    def __getitem__(self, idx):
        sample = self._dataset[idx]
        if self._is_video:
            return self._wrapper(idx, sample[0], sample[1:])
        if not isinstance(sample, tuple) or len(sample) < 2:
            return sample
        img_w, target_w = self._wrapper(idx, sample[0], sample[1])
        return (Image(torch.as_tensor(np.asarray(img_w))), target_w) + tuple(sample[2:])


def wrap_dataset_for_transforms_v2(dataset,
                                   target_keys: Optional[Sequence[str]] = None):
    """reference ``_dataset_wrapper.py:19``: a view of ``dataset`` whose
    samples are typed for the per-sample transforms (the module
    docstring's registry). ``target_keys`` selects the target's entries of
    CocoDetection, VOCDetection, Kitti and WIDERFace, and raises for any
    other dataset."""
    return _WrappedDataset(dataset, target_keys)
