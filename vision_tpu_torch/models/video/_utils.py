"""The Kinetics-400 checkpoint entry shared by the video builders."""

from __future__ import annotations

import functools
from typing import Tuple

from vision_tpu_torch.models._api import Weights
from vision_tpu_torch.transforms._presets import VideoClassification

__all__ = ["clip_size", "video_weights"]

_URL = "https://download.pytorch.org/models/"


def video_weights(file: str, acc1: float, acc5: float, num_params: int,
                  ops: float, crop: Tuple[int, int] = (224, 224),
                  resize: Tuple[int, int] = (256, 256)) -> Weights:
    """A Kinetics-400 checkpoint under torchvision's URL: its accuracies,
    parameter count, GMACs a 16-frame clip at its crop (``_ops``) and its
    ``VideoClassification`` preset."""
    return Weights(url=_URL + file, transforms=functools.partial(
        VideoClassification, crop_size=crop, resize_size=resize), meta={
        "num_params": num_params, "_ops": ops,
        "_metrics": {"Kinetics-400": {"acc@1": acc1, "acc@5": acc5}},
    })


def clip_size(weights) -> Tuple[int, int]:
    """The ``(H, W)`` crop a checkpoint was evaluated at (its preset's)."""
    return tuple(weights.transforms.keywords["crop_size"])
