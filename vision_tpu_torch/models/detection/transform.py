"""GeneralizedRCNNTransform (counterpart of
``vision_tpu/models/detection/transform.py``): normalise, resize to
``min_size`` / ``max_size``, pad every image to one fixed canvas; and map
boxes back to each original image.

As in the JAX package, and unlike torchvision, the target size is rounded
(``round``, where torchvision floors), and every batch pads to the fixed
canvas, ``ceil(max_size / 32) * 32`` square by default, not to its largest
image, so that the model always sees one shape.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from vision_tpu_torch.models._api import resolve_device
from vision_tpu_torch.models.detection.image_list import ImageList
from vision_tpu_torch.transforms.v2.functional._resample import resize_2d

__all__ = ["GeneralizedRCNNTransform", "resize_boxes", "resize_keypoints"]


def resize_boxes(boxes: torch.Tensor, original_size: Tuple[int, int],
                 new_size: Tuple[int, int]) -> torch.Tensor:
    """Scale xyxy boxes from an image of ``original_size`` (h, w) to one of
    ``new_size``."""
    rh = new_size[0] / original_size[0]
    rw = new_size[1] / original_size[1]
    return torch.stack([boxes[..., 0] * rw, boxes[..., 1] * rh,
                        boxes[..., 2] * rw, boxes[..., 3] * rh], dim=-1)


def resize_keypoints(kp: torch.Tensor, original_size: Tuple[int, int],
                     new_size: Tuple[int, int]) -> torch.Tensor:
    """Scale ``(..., K, 2 or 3)`` keypoints (x, y[, visibility])."""
    rh = new_size[0] / original_size[0]
    rw = new_size[1] / original_size[1]
    rest = [kp[..., 2]] if kp.shape[-1] == 3 else []
    return torch.stack([kp[..., 0] * rw, kp[..., 1] * rh, *rest], dim=-1)


class GeneralizedRCNNTransform:
    """``__call__(images)``: a list of ``[C, H, W]`` float images in
    [0, 1] of any sizes -> an f32 ``ImageList`` on the transform's device
    (the card unless ``device="cpu"``). Each image is normalised, resized
    (bilinear, no antialias) so that its short side is ``min_size`` unless
    its long side would pass ``max_size``, and padded with zeros at the
    bottom and right to ``fixed_size``."""

    def __init__(
        self,
        min_size: int = 800,
        max_size: int = 1333,
        image_mean: Sequence[float] = (0.485, 0.456, 0.406),
        image_std: Sequence[float] = (0.229, 0.224, 0.225),
        size_divisible: int = 32,
        fixed_size: Optional[Tuple[int, int]] = None,
        device: Union[str, torch.device, None] = None,
    ):
        self.min_size = min_size
        self.max_size = max_size
        self.image_mean = list(image_mean)
        self.image_std = list(image_std)
        self.size_divisible = size_divisible
        if fixed_size is None:
            canvas = int(math.ceil(max_size / size_divisible) * size_divisible)
            fixed_size = (canvas, canvas)
        self.fixed_size = tuple(fixed_size)
        self.device = resolve_device(device)

    def _target_size(self, h: int, w: int) -> Tuple[int, int]:
        scale = min(self.min_size / min(h, w), self.max_size / max(h, w))
        return int(round(h * scale)), int(round(w * scale))

    def __call__(self, images: List[torch.Tensor]) -> ImageList:
        canvas_h, canvas_w = self.fixed_size
        mean = torch.tensor(self.image_mean, device=self.device)[:, None, None]
        std = torch.tensor(self.image_std, device=self.device)[:, None, None]
        batched = torch.zeros(len(images), len(self.image_mean), canvas_h,
                              canvas_w, device=self.device)
        sizes = []
        for i, img in enumerate(images):
            h, w = img.shape[-2:]
            nh, nw = self._target_size(h, w)
            x = (img.to(self.device, torch.float32) - mean) / std
            batched[i, :, :nh, :nw] = resize_2d(x, (nh, nw), mode="bilinear",
                                                antialias=False)
            sizes.append((nh, nw))
        return ImageList(batched, sizes)

    def postprocess_boxes(self, boxes: torch.Tensor,
                          image_size: Tuple[int, int],
                          original_size: Tuple[int, int]) -> torch.Tensor:
        """Boxes of the resized image of ``image_size`` back to the
        original image's coordinates."""
        return resize_boxes(boxes, image_size, original_size)
