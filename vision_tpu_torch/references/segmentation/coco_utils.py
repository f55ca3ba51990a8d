"""COCO as VOC for the segmentation recipe (the port's copy of the repo's
``references/segmentation/coco_utils.py``; reference
``references/segmentation/coco_utils.py``): the 20 VOC categories kept and
numbered 1-20, each image's instances merged into one ``[H, W]`` uint8
class map (255 where instances overlap), training images with 1,000
annotated pixels or fewer dropped. The masks come from the detection
recipe's ``coco_utils`` (the port's RLE decode and polygon fill)."""

from __future__ import annotations

import copy
import os
from typing import List

import numpy as np
import torch

from vision_tpu_torch.references.detection.coco_utils import (
    convert_coco_poly_to_mask,
)

__all__ = ["CAT_LIST", "ConvertCocoPolysToMask", "FilterAndRemapCocoCategories",
           "coco_remove_images_without_annotations", "get_coco"]

# the VOC categories' COCO ids, background first (reference CAT_LIST)
CAT_LIST = [0, 5, 2, 16, 9, 44, 6, 3, 17, 62, 21, 67, 18, 19, 4, 1, 64, 20,
            63, 7, 72]


class FilterAndRemapCocoCategories:
    """reference ``coco_utils.py:12``: the annotations of ``categories``,
    their ids replaced by their index there (with ``remap``)."""

    def __init__(self, categories: List[int], remap: bool = True):
        self.categories = categories
        self.remap = remap

    def __call__(self, image, anno):
        anno = [o for o in anno if o["category_id"] in self.categories]
        if not self.remap:
            return image, anno
        anno = copy.deepcopy(anno)
        for o in anno:
            o["category_id"] = self.categories.index(o["category_id"])
        return image, anno


class ConvertCocoPolysToMask:
    """reference ``coco_utils.py:43``: the instances -> one ``[H, W]``
    uint8 class map of the CHW image's size (the largest class id where
    instances meet, 255 where more than one covers a pixel)."""

    def __call__(self, image, anno):
        h, w = image.shape[-2:]
        segs = [o["segmentation"] for o in anno]
        cats = np.asarray([o["category_id"] for o in anno], np.uint8)
        if segs:
            masks = convert_coco_poly_to_mask(segs, h, w)
            target = (masks * cats[:, None, None]).max(axis=0)
            target[masks.sum(axis=0) > 1] = 255
        else:
            target = np.zeros((h, w), np.uint8)
        return image, torch.from_numpy(np.ascontiguousarray(target))


def coco_remove_images_without_annotations(dataset, cat_list=None) -> List[int]:
    """reference ``coco_utils.py:63``: the indices of the images whose
    annotations (of ``cat_list``) cover more than 1,000 pixels."""
    ids = []
    for i in range(len(dataset)):
        anno = dataset._load_target(dataset.ids[i])
        if cat_list:
            anno = [o for o in anno if o["category_id"] in cat_list]
        if anno and sum(o["area"] for o in anno) > 1000:
            ids.append(i)
    return ids


class _CocoSegmentation:
    """``CocoDetection`` + the category filter + the mask merge (+
    ``transforms``)."""

    def __init__(self, img_folder, ann_file, transforms=None):
        from vision_tpu_torch.datasets.coco import CocoDetection

        self.base = CocoDetection(img_folder, ann_file)
        self.ids = self.base.ids
        self.filter = FilterAndRemapCocoCategories(CAT_LIST, remap=True)
        self.convert = ConvertCocoPolysToMask()
        self.transforms = transforms

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        img, anno = self.base[idx]
        img, anno = self.filter(img, anno)
        img, target = self.convert(img, anno)
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target


def get_coco(root, image_set: str, transforms=None):
    """reference ``coco_utils.py:84``."""
    ann = os.path.join("annotations", "instances_{}2017.json")
    img_folder, ann_file = {"train": ("train2017", ann.format("train")),
                            "val": ("val2017", ann.format("val"))}[image_set]
    ds = _CocoSegmentation(os.path.join(root, img_folder),
                           os.path.join(root, ann_file), transforms=transforms)
    if image_set == "train":
        keep = coco_remove_images_without_annotations(ds.base, CAT_LIST)
        ds.ids = [ds.ids[i] for i in keep]
        ds.base.ids = ds.ids
    return ds
