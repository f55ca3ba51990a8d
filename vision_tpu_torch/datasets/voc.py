"""Pascal VOC (reference ``torchvision/datasets/voc.py``; the port's copy
of ``vision_tpu/datasets/voc.py``). Images load through the port's codecs
on the CPU (``read_image``, RGB: CHW uint8); a segmentation mask is read
as its palette indices (``[H, W]`` uint8: the classes, 255 on the
borders), through the codec's private palette-index read, which Pillow's
``"P"`` mode is in the JAX package; an annotation's XML is parsed with
``xml.etree.ElementTree`` (the JAX package takes ``defusedxml``'s, which
the card's machine lacks) into the same nested dict."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from vision_tpu_torch.datasets.utils import (
    download_and_extract_archive,
    verify_str_arg,
)
from vision_tpu_torch.datasets.vision import VisionDataset

__all__ = ["VOCDetection", "VOCSegmentation"]

DATASET_YEAR_DICT = {
    "2012": {
        "url": "http://host.robots.ox.ac.uk/pascal/VOC/voc2012/VOCtrainval_11-May-2012.tar",
        "filename": "VOCtrainval_11-May-2012.tar",
        "md5": "6cd6e144f989b92b3379bac3b3de84fd",
        "base_dir": os.path.join("VOCdevkit", "VOC2012"),
    },
    "2007": {
        "url": "http://host.robots.ox.ac.uk/pascal/VOC/voc2007/VOCtrainval_06-Nov-2007.tar",
        "filename": "VOCtrainval_06-Nov-2007.tar",
        "md5": "c52e279531787c972589f7e41ab4ae64",
        "base_dir": os.path.join("VOCdevkit", "VOC2007"),
    },
}


def _read_rgb(path: str) -> torch.Tensor:
    from vision_tpu_torch.io.image import ImageReadMode, read_image

    return read_image(path, ImageReadMode.RGB, device="cpu")


class _VOCBase(VisionDataset):
    _SPLITS_DIR: str
    _TARGET_DIR: str
    _TARGET_FILE_EXT: str

    def __init__(self, root: str, year: str = "2012", image_set: str = "train",
                 download: bool = False, transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None,
                 transforms: Optional[Callable] = None):
        super().__init__(root, transforms, transform, target_transform)
        self.year = verify_str_arg(year, "year", DATASET_YEAR_DICT.keys())
        self.image_set = verify_str_arg(image_set, "image_set",
                                        ("train", "trainval", "val"))
        dataset_dict = DATASET_YEAR_DICT[year]
        voc_root = os.path.join(self.root, dataset_dict["base_dir"])
        if download:
            download_and_extract_archive(dataset_dict["url"], self.root,
                                         filename=dataset_dict["filename"],
                                         md5=dataset_dict["md5"])
        if not os.path.isdir(voc_root):
            raise RuntimeError("Dataset not found. Use download=True")
        splits_dir = os.path.join(voc_root, "ImageSets", self._SPLITS_DIR)
        with open(os.path.join(splits_dir, image_set + ".txt")) as f:
            file_names = [x.strip() for x in f.readlines()]
        image_dir = os.path.join(voc_root, "JPEGImages")
        self.images = [os.path.join(image_dir, x + ".jpg") for x in file_names]
        target_dir = os.path.join(voc_root, self._TARGET_DIR)
        self.targets = [os.path.join(target_dir, x + self._TARGET_FILE_EXT)
                        for x in file_names]

    def __len__(self) -> int:
        return len(self.images)


class VOCSegmentation(_VOCBase):
    """reference VOCSegmentation: ``(image, class mask)``."""

    _SPLITS_DIR = "Segmentation"
    _TARGET_DIR = "SegmentationClass"
    _TARGET_FILE_EXT = ".png"

    def __getitem__(self, index: int) -> Tuple[Any, Any]:
        from vision_tpu_torch.io._image_codecs import decode_png_indices_native

        img = _read_rgb(self.images[index])
        with open(self.targets[index], "rb") as f:
            target = torch.from_numpy(decode_png_indices_native(f.read()))
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target


class VOCDetection(_VOCBase):
    """reference VOCDetection: ``(image, the parsed annotation XML)``."""

    _SPLITS_DIR = "Main"
    _TARGET_DIR = "Annotations"
    _TARGET_FILE_EXT = ".xml"

    def __getitem__(self, index: int) -> Tuple[Any, Any]:
        img = _read_rgb(self.images[index])
        target = self.parse_voc_xml(self.targets[index])
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target

    @staticmethod
    def parse_voc_xml(path: str) -> Dict[str, Any]:
        """``{root tag: node}``, a node being its text where it has no
        children, else a dict of its children by tag, the ``object``
        children gathered in a list."""
        def node_to_dict(node):
            children = list(node)
            if not children:
                return node.text
            d: Dict[str, Any] = {}
            for child in children:
                val = node_to_dict(child)
                if child.tag == "object":
                    d.setdefault("object", []).append(val)
                else:
                    d[child.tag] = val
            return d

        root = ET.parse(path).getroot()
        return {root.tag: node_to_dict(root)}
