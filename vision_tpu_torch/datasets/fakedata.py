"""FakeData (reference ``torchvision/datasets/fakedata.py``; the port's copy
of ``vision_tpu/datasets/fakedata.py``): random images for smoke tests and
benchmarks, drawn as ``vision_tpu`` draws them, so both give one image for
one index."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from vision_tpu_torch.datasets.vision import VisionDataset

__all__ = ["FakeData"]


class FakeData(VisionDataset):
    """``size`` samples of ``image_size`` ``(H, W, C)`` (``vision_tpu``'s
    order; the reference's is ``(C, H, W)``): sample ``i`` draws its image
    and then its target from ``numpy.random.RandomState(i +
    random_offset)``, and is returned as a ``[C, H, W]`` uint8 tensor."""

    def __init__(self, size: int = 1000,
                 image_size: Tuple[int, int, int] = (224, 224, 3),
                 num_classes: int = 10, transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None,
                 random_offset: int = 0):
        super().__init__(None, transform=transform, target_transform=target_transform)
        self.size = size
        self.num_classes = num_classes
        self.image_size = image_size
        self.random_offset = random_offset

    def __getitem__(self, index: int) -> Tuple[Any, Any]:
        if index >= len(self):
            raise IndexError(f"{index} >= {len(self)}")
        rng = np.random.RandomState(index + self.random_offset)
        img = (rng.rand(*self.image_size) * 255).astype(np.uint8)
        target = rng.randint(0, self.num_classes)
        img = torch.from_numpy(img).movedim(-1, 0).contiguous()
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target

    def __len__(self) -> int:
        return self.size
