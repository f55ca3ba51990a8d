"""Folder datasets (reference ``torchvision/datasets/folder.py:36-287``;
the port's copy of ``vision_tpu/datasets/folder.py``). Images load through
the port's own codecs on the CPU (``read_image``); the port has no PIL."""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple, cast

import torch

from vision_tpu_torch.datasets.vision import VisionDataset

__all__ = [
    "IMG_EXTENSIONS",
    "DatasetFolder",
    "ImageFolder",
    "default_loader",
    "find_classes",
    "has_file_allowed_extension",
    "is_image_file",
    "make_dataset",
    "pil_loader",
]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def has_file_allowed_extension(filename: str, extensions) -> bool:
    return filename.lower().endswith(
        extensions if isinstance(extensions, str) else tuple(extensions))


def is_image_file(filename: str) -> bool:
    return has_file_allowed_extension(filename, IMG_EXTENSIONS)


def find_classes(directory: str) -> Tuple[List[str], Dict[str, int]]:
    """reference ``folder.py:36``: the sorted class folders and their
    indices."""
    classes = sorted(entry.name for entry in os.scandir(directory) if entry.is_dir())
    if not classes:
        raise FileNotFoundError(f"Couldn't find any class folder in {directory}.")
    return classes, {cls_name: i for i, cls_name in enumerate(classes)}


def make_dataset(directory: str, class_to_idx: Optional[Dict[str, int]] = None,
                 extensions=None,
                 is_valid_file: Optional[Callable[[str], bool]] = None,
                 allow_empty: bool = False) -> List[Tuple[str, int]]:
    """reference ``folder.py:80``: ``(path, class index)`` of every valid
    file, classes and files in sorted order."""
    directory = os.path.expanduser(directory)
    if class_to_idx is None:
        _, class_to_idx = find_classes(directory)
    if (extensions is None) == (is_valid_file is None):
        raise ValueError("Both extensions and is_valid_file cannot be None or "
                         "not None at the same time")
    if extensions is not None:
        def is_valid_file(x: str) -> bool:
            return has_file_allowed_extension(x, extensions)
    is_valid_file = cast(Callable[[str], bool], is_valid_file)
    instances = []
    available = set()
    for target_class in sorted(class_to_idx.keys()):
        class_index = class_to_idx[target_class]
        target_dir = os.path.join(directory, target_class)
        if not os.path.isdir(target_dir):
            continue
        for root, _, fnames in sorted(os.walk(target_dir, followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(root, fname)
                if is_valid_file(path):
                    instances.append((path, class_index))
                    available.add(target_class)
    empty = set(class_to_idx.keys()) - available
    if empty and not allow_empty:
        raise FileNotFoundError(
            f"Found no valid file for the classes {', '.join(sorted(empty))}.")
    return instances


def pil_loader(path: str):
    """The reference's PIL loader: the port has no PIL, so this raises;
    :func:`default_loader` reads every format the port decodes."""
    raise RuntimeError("pil_loader: the port does not use PIL; use "
                       "default_loader (read_image through the port's codecs)")


def default_loader(path: str) -> torch.Tensor:
    """``read_image(path, RGB)`` on the CPU: a ``[3, H, W]`` uint8 tensor
    (the reference's default is PIL's RGB image; ``vision_tpu``'s is the
    same read as an HWC array)."""
    from vision_tpu_torch.io.image import ImageReadMode, read_image

    return read_image(path, ImageReadMode.RGB, device="cpu")


class DatasetFolder(VisionDataset):
    """reference ``folder.py:120``: ``root/<class>/**/<file>`` samples."""

    def __init__(self, root: str, loader: Callable[[str], Any] = default_loader,
                 extensions=IMG_EXTENSIONS,
                 transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None,
                 is_valid_file: Optional[Callable[[str], bool]] = None,
                 allow_empty: bool = False):
        super().__init__(root, transform=transform,
                         target_transform=target_transform)
        classes, class_to_idx = self.find_classes(self.root)
        samples = self.make_dataset(
            self.root, class_to_idx,
            extensions if is_valid_file is None else None, is_valid_file,
            allow_empty)
        self.loader = loader
        self.extensions = extensions
        self.classes = classes
        self.class_to_idx = class_to_idx
        self.samples = samples
        self.targets = [s[1] for s in samples]

    @staticmethod
    def make_dataset(directory, class_to_idx, extensions=None,
                     is_valid_file=None, allow_empty=False):
        return make_dataset(directory, class_to_idx, extensions, is_valid_file,
                            allow_empty)

    def find_classes(self, directory: str):
        return find_classes(directory)

    def __getitem__(self, index: int) -> Tuple[Any, Any]:
        path, target = self.samples[index]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return sample, target

    def __len__(self) -> int:
        return len(self.samples)


class ImageFolder(DatasetFolder):
    """reference ``folder.py:246``: a :class:`DatasetFolder` of image files."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None,
                 loader: Callable[[str], Any] = default_loader,
                 is_valid_file: Optional[Callable[[str], bool]] = None,
                 allow_empty: bool = False):
        super().__init__(root, loader,
                         IMG_EXTENSIONS if is_valid_file is None else None,
                         transform=transform, target_transform=target_transform,
                         is_valid_file=is_valid_file, allow_empty=allow_empty)
        self.imgs = self.samples
