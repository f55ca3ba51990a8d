"""COCO datasets (reference ``torchvision/datasets/coco.py``; the port's
copy of ``vision_tpu/datasets/coco.py``). The reference wraps
``pycocotools``; the port, which has none, indexes the annotation JSON in
pure Python (``COCOIndex``: the ``pycocotools.COCO`` surface the datasets
and the detection recipe use). Images load through the port's own codecs
on the CPU (``read_image``, RGB), as ``folder.default_loader`` does: CHW
uint8 tensors."""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from vision_tpu_torch.datasets.vision import VisionDataset

__all__ = ["COCOIndex", "CocoCaptions", "CocoDetection"]


def _ids(ids) -> list:
    return [ids] if isinstance(ids, int) else list(ids)


class COCOIndex:
    """An annotation file indexed by id: ``imgs``, ``anns``, ``cats`` and
    each image's annotation ids (``img_to_anns``), in file order."""

    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            self.dataset = json.load(f)
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[int]] = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann["id"])
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    def getImgIds(self) -> List[int]:
        return list(self.imgs.keys())

    def getAnnIds(self, imgIds=None) -> List[int]:
        if imgIds is None:
            return list(self.anns.keys())
        return [a for i in _ids(imgIds) for a in self.img_to_anns[i]]

    def getCatIds(self) -> List[int]:
        return list(self.cats.keys())

    def loadAnns(self, ids) -> List[dict]:
        return [self.anns[i] for i in _ids(ids)]

    def loadImgs(self, ids) -> List[dict]:
        return [self.imgs[i] for i in _ids(ids)]

    def loadCats(self, ids) -> List[dict]:
        return [self.cats[i] for i in _ids(ids)]


class CocoDetection(VisionDataset):
    """reference ``coco.py:10``: ``(image, list of annotation dicts)``, the
    images in the order of their sorted ids."""

    def __init__(self, root: str, annFile: str,
                 transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None,
                 transforms: Optional[Callable] = None):
        super().__init__(root, transforms, transform, target_transform)
        self.coco = COCOIndex(annFile)
        self.ids = sorted(self.coco.imgs.keys())

    def _load_image(self, id: int) -> torch.Tensor:
        from vision_tpu_torch.io.image import ImageReadMode, read_image

        path = self.coco.loadImgs(id)[0]["file_name"]
        return read_image(os.path.join(self.root, path), ImageReadMode.RGB,
                          device="cpu")

    def _load_target(self, id: int) -> List[Any]:
        return self.coco.loadAnns(self.coco.getAnnIds(imgIds=id))

    def __getitem__(self, index: int) -> Tuple[Any, Any]:
        id = self.ids[index]
        image = self._load_image(id)
        target = self._load_target(id)
        if self.transforms is not None:
            image, target = self.transforms(image, target)
        return image, target

    def __len__(self) -> int:
        return len(self.ids)


class CocoCaptions(CocoDetection):
    """reference ``coco.py`` CocoCaptions: the target is the image's
    caption strings."""

    def _load_target(self, id: int) -> List[str]:
        return [ann["caption"] for ann in super()._load_target(id)]
