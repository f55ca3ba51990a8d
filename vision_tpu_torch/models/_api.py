"""Model registry and weights (counterpart of ``vision_tpu/models/_api.py``,
minimal): ``register_model`` / ``get_model`` / ``list_models``, and
``Weights`` that load from a local file only."""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Any, Callable, Dict, List, Optional, Union

import torch

__all__ = [
    "Weights",
    "WeightsEnum",
    "get_model",
    "list_models",
    "register_model",
    "resolve_device",
]

_MODELS: Dict[str, Callable[..., Any]] = {}


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises: the
    port never falls back to the CPU unless the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


@dataclasses.dataclass(frozen=True)
class Weights:
    """A checkpoint: ``url`` names where it is published, ``path`` the
    local ``.pth`` file it loads from. Nothing is downloaded.
    ``transforms`` builds the inference preset the checkpoint was evaluated
    with (``weights.transforms()``)."""

    url: str
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict, hash=False,
                                              compare=False)
    path: str = ""
    transforms: Optional[Callable[..., Any]] = dataclasses.field(
        default=None, hash=False, compare=False)

    def get_state_dict(self) -> Dict[str, torch.Tensor]:
        if not self.path or not os.path.isfile(self.path):
            raise FileNotFoundError(
                f"no local checkpoint for {self.url}: downloads are refused; "
                "put the .pth file on disk and pass Weights(url, path=...)"
            )
        return torch.load(self.path, map_location="cpu", weights_only=True)


class WeightsEnum(enum.Enum):
    @classmethod
    def verify(cls, obj: Any) -> Any:
        if obj is None or isinstance(obj, (cls, Weights)):
            return obj
        if isinstance(obj, str):
            return cls[obj.replace(cls.__name__ + ".", "")]
        raise TypeError(f"expected {cls.__name__}, got {type(obj).__name__}")

    def get_state_dict(self) -> Dict[str, torch.Tensor]:
        return self.value.get_state_dict()

    @property
    def meta(self) -> Dict[str, Any]:
        return self.value.meta

    @property
    def transforms(self) -> Optional[Callable[..., Any]]:
        return self.value.transforms


def register_model(name: str = None):
    def wrap(fn):
        _MODELS[name or fn.__name__] = fn
        return fn

    return wrap


def get_model(name: str, **config: Any):
    return _MODELS[name.lower()](**config)


def list_models() -> List[str]:
    return sorted(_MODELS)
