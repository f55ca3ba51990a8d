"""Typed tensors (counterpart of ``vision_tpu/tv_tensors/_containers.py``).

The JAX package could only make pytree dataclasses around an array; here,
as in torchvision's ``_tv_tensor.py``, each type is a ``torch.Tensor``
subclass. An operation on one returns a plain tensor (``__torch_function__``
runs every op with the subclass disabled): what comes out of arithmetic, an
index or a view is data, not an image or boxes, until ``wrap(out, like=x)``
gives it a type and metadata again (or, under
``set_return_type("TVTensor")``, the first argument's type and metadata).
``clone``, ``to``, ``detach``, ``requires_grad_`` and ``pin_memory`` keep
the type and the metadata, as torchvision's do.

Layouts are torchvision's: ``Image`` ``[..., C, H, W]``, ``Video`` ``[...,
T, C, H, W]``, ``Mask`` ``[..., H, W]``, ``BoundingBoxes`` ``[N, 4]`` (5 or
8 for the rotated formats) with ``format`` and ``canvas_size`` (H, W),
``KeyPoints`` ``[..., K, 2]`` (x, y) with ``canvas_size``. As in the JAX
package, channels past (x, y), COCO's visibility as ``[..., K, 3]``, ride
along every geometry kernel untouched.
"""

from __future__ import annotations

import enum
from typing import Any, Optional, Tuple, Union

import torch
import torch.utils._pytree as pytree

__all__ = [
    "BoundingBoxFormat",
    "BoundingBoxes",
    "Image",
    "KeyPoints",
    "Mask",
    "TVTensor",
    "Video",
    "is_rotated_bounding_format",
    "set_return_type",
    "wrap",
]


class BoundingBoxFormat(enum.Enum):
    """The coordinate format of ``BoundingBoxes``, the rotated ones too."""

    XYXY = "XYXY"
    XYWH = "XYWH"
    CXCYWH = "CXCYWH"
    XYWHR = "XYWHR"
    CXCYWHR = "CXCYWHR"
    XYXYXYXY = "XYXYXYXY"


_ROTATED = (BoundingBoxFormat.XYWHR, BoundingBoxFormat.CXCYWHR,
            BoundingBoxFormat.XYXYXYXY)


def is_rotated_bounding_format(format) -> bool:
    """Whether ``format`` (a ``BoundingBoxFormat`` or its name, any case) is
    one of the rotated ones."""
    if isinstance(format, BoundingBoxFormat):
        return format in _ROTATED
    if isinstance(format, str):
        return format.upper() in ("XYWHR", "CXCYWHR", "XYXYXYXY")
    raise ValueError(f"format should be str or BoundingBoxFormat, got "
                     f"{type(format)}")


# what an op on a typed tensor returns: "tensor" (plain data, the default)
# or "tvtensor" (the first argument's type and metadata)
_return_type = "tensor"


class set_return_type:
    """Set what an operation on a typed tensor returns: ``"Tensor"`` (plain
    data, the default) or ``"TVTensor"`` (the type and metadata of its
    first argument, where that is a typed tensor). Called, it sets the
    choice; as a context manager it restores the one before on exit
    (torchvision's ``set_return_type``; the JAX package takes the same
    names, and its containers always return plain data)."""

    def __init__(self, return_type: str):
        if return_type.lower() not in ("tensor", "tvtensor"):
            raise ValueError(f"unknown return_type {return_type!r}")
        global _return_type
        self._before = _return_type
        _return_type = return_type.lower()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _return_type
        _return_type = self._before


def _as_tensor(data: Any, dtype=None, device=None,
               requires_grad: Optional[bool] = None) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        t = data.as_subclass(torch.Tensor)
        if dtype is not None or device is not None:
            t = t.to(device=device, dtype=dtype)
    else:
        t = torch.as_tensor(data, dtype=dtype, device=device)
    if requires_grad is not None:
        t = t.requires_grad_(requires_grad)
    return t


# the ops whose output keeps the input's type and metadata
_KEEP_TYPE = {torch.Tensor.clone, torch.Tensor.to, torch.Tensor.detach,
              torch.Tensor.requires_grad_, torch.Tensor.pin_memory,
              torch.Tensor.cpu, torch.Tensor.cuda}


class TVTensor(torch.Tensor):
    """The base type. Subclasses keep their metadata in ``_meta()`` and are
    made again by ``_from_meta(tensor, meta)``."""

    def _meta(self) -> Tuple:
        return ()

    @classmethod
    def _from_meta(cls, tensor: torch.Tensor, meta: Tuple) -> "TVTensor":
        return cls._wrap(tensor)

    @classmethod
    def _wrap(cls, tensor: torch.Tensor):
        return tensor.as_subclass(cls)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **(kwargs or {}))
        first = args[0] if args else None
        if (func in _KEEP_TYPE and isinstance(first, TVTensor)
                and isinstance(out, torch.Tensor)):
            return type(first)._from_meta(out, first._meta())
        if _return_type == "tvtensor" and isinstance(first, cls):
            return pytree.tree_map_only(
                torch.Tensor, lambda t: type(first)._from_meta(
                    t.as_subclass(torch.Tensor), first._meta()), out)
        if isinstance(out, TVTensor):
            # an op that returns its input itself (``.float()`` of an f32
            # tensor, an in-place op) still returns plain data
            return out.as_subclass(torch.Tensor)
        return out

    def as_tensor(self) -> torch.Tensor:
        """The data as a plain tensor (no copy)."""
        return self.as_subclass(torch.Tensor)

    def __deepcopy__(self, memo):
        return type(self)._from_meta(self.as_tensor().clone(), self._meta())

    def __reduce_ex__(self, protocol):
        return (_rebuild, (type(self), self.as_tensor().detach().cpu()
                           .clone(), self._meta(), self.device))

    def __repr__(self) -> str:
        meta = self._meta()
        body = repr(self.as_tensor())
        return (f"{type(self).__name__}({body}"
                + (f", meta={meta}" if meta else "") + ")")


def _rebuild(cls, tensor, meta, device):
    return cls._from_meta(tensor.to(device), meta)


class Image(TVTensor):
    """An image ``[..., C, H, W]``; a 2-d tensor is taken as one channel."""

    def __new__(cls, data: Any, *, dtype=None, device=None,
                requires_grad: Optional[bool] = None):
        t = _as_tensor(data, dtype, device, requires_grad)
        if t.ndim < 2:
            raise ValueError(f"Image needs >= 2 dims, got shape {tuple(t.shape)}")
        if t.ndim == 2:
            t = t.unsqueeze(0)
        return t.as_subclass(cls)


class Video(TVTensor):
    """A video ``[..., T, C, H, W]``."""

    def __new__(cls, data: Any, *, dtype=None, device=None,
                requires_grad: Optional[bool] = None):
        t = _as_tensor(data, dtype, device, requires_grad)
        if t.ndim < 4:
            raise ValueError(f"Video needs >= 4 dims (T, C, H, W), got "
                             f"shape {tuple(t.shape)}")
        return t.as_subclass(cls)


class Mask(TVTensor):
    """Segmentation or instance masks ``[..., H, W]``."""

    def __new__(cls, data: Any, *, dtype=None, device=None,
                requires_grad: Optional[bool] = None):
        return _as_tensor(data, dtype, device, requires_grad).as_subclass(cls)


class BoundingBoxes(TVTensor):
    """Boxes ``[N, 4]`` (``[N, 5]`` or ``[N, 8]`` rotated) in ``format`` on a
    canvas of ``canvas_size`` (H, W); ``clamping_mode`` is ``"soft"``,
    ``"hard"`` or None."""

    format: BoundingBoxFormat
    canvas_size: Tuple[int, int]
    clamping_mode: Optional[str]

    def __new__(cls, data: Any, *, format: Union[BoundingBoxFormat, str],
                canvas_size: Tuple[int, int], clamping_mode: Optional[str] = "soft",
                dtype=None, device=None, requires_grad: Optional[bool] = None):
        t = _as_tensor(data, dtype, device, requires_grad)
        return cls._make(t, format, canvas_size, clamping_mode)

    @classmethod
    def _make(cls, tensor, format, canvas_size, clamping_mode):
        if isinstance(format, str):
            format = BoundingBoxFormat(format.upper())
        if clamping_mode not in ("soft", "hard", None):
            raise ValueError(f"invalid clamping_mode {clamping_mode!r}")
        out = tensor.as_subclass(cls)
        out.format = format
        out.canvas_size = tuple(int(s) for s in canvas_size)
        out.clamping_mode = clamping_mode
        return out

    @property
    def is_rotated(self) -> bool:
        return self.format in _ROTATED

    def _meta(self) -> Tuple:
        return (self.format, self.canvas_size, self.clamping_mode)

    @classmethod
    def _from_meta(cls, tensor, meta):
        return cls._make(tensor, *meta)


class KeyPoints(TVTensor):
    """Keypoints ``[..., K, 2]`` (x, y), or with channels after (x, y) that
    every kernel carries through, on a canvas of ``canvas_size`` (H, W)."""

    canvas_size: Tuple[int, int]

    def __new__(cls, data: Any, *, canvas_size: Tuple[int, int], dtype=None,
                device=None, requires_grad: Optional[bool] = None):
        t = _as_tensor(data, dtype, device, requires_grad)
        return cls._make(t, canvas_size)

    @classmethod
    def _make(cls, tensor, canvas_size):
        out = tensor.as_subclass(cls)
        out.canvas_size = tuple(int(s) for s in canvas_size)
        return out

    def _meta(self) -> Tuple:
        return (self.canvas_size,)

    @classmethod
    def _from_meta(cls, tensor, meta):
        return cls._make(tensor, *meta)


def wrap(data: Any, *, like: TVTensor, **kwargs) -> TVTensor:
    """``data`` with the type and metadata of ``like``; ``kwargs`` (``format``,
    ``canvas_size``, ``clamping_mode``) replace metadata."""
    t = _as_tensor(data)
    if isinstance(like, BoundingBoxes):
        return BoundingBoxes._make(
            t, kwargs.get("format", like.format),
            kwargs.get("canvas_size", like.canvas_size),
            kwargs.get("clamping_mode", like.clamping_mode))
    if isinstance(like, KeyPoints):
        return KeyPoints._make(t, kwargs.get("canvas_size", like.canvas_size))
    return type(like)._wrap(t)
