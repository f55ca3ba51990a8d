"""Dataset base classes (reference ``torchvision/datasets/vision.py``; the
port's copy of ``vision_tpu/datasets/vision.py``, on
``torch.utils.data.Dataset``)."""

from __future__ import annotations

import os
from typing import Any, Callable, Optional, Tuple

import torch.utils.data

__all__ = ["StandardTransform", "VisionDataset"]


class StandardTransform:
    """reference ``vision.py:90``: applies separate input/target transforms."""

    def __init__(self, transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None):
        self.transform = transform
        self.target_transform = target_transform

    def __call__(self, inpt: Any, target: Any) -> Tuple[Any, Any]:
        if self.transform is not None:
            inpt = self.transform(inpt)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return inpt, target

    def __repr__(self) -> str:
        return f"StandardTransform({self.transform}, {self.target_transform})"


class VisionDataset(torch.utils.data.Dataset):
    """reference ``vision.py:12``: a root, and either ``transform`` /
    ``target_transform`` or one joint ``transforms`` callable."""

    _repr_indent = 4

    def __init__(self, root: Optional[str] = None,
                 transforms: Optional[Callable] = None,
                 transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None):
        self.root = os.path.expanduser(root) if isinstance(root, str) else root
        has_transforms = transforms is not None
        has_separate = transform is not None or target_transform is not None
        if has_transforms and has_separate:
            raise ValueError(
                "Only transforms or transform/target_transform can be passed")
        self.transform = transform
        self.target_transform = target_transform
        if not has_transforms:
            transforms = StandardTransform(transform, target_transform)
        self.transforms = transforms

    def __getitem__(self, index: int) -> Any:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def __repr__(self) -> str:
        head = f"Dataset {self.__class__.__name__}"
        body = [f"Number of datapoints: {len(self)}"]
        if self.root is not None:
            body.append(f"Root location: {self.root}")
        return "\n".join([head] + [" " * self._repr_indent + line for line in body])
