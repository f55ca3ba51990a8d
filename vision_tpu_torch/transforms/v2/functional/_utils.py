"""The type -> kernel table each functional dispatches through (counterpart
of ``vision_tpu/transforms/v2/functional/_utils.py``, torchvision's
``functional/_utils.py``).

``table[functional][input_type]`` is the kernel; a lookup walks the input's
class's MRO, so a plain tensor (an image, as the reference takes it) finds
the ``torch.Tensor`` entry and a subclass of ``Image`` finds ``Image``'s.
A kernel registered internally for a ``TVTensor`` type takes and returns
plain tensors, and is wrapped to unwrap the input and give the output the
input's type and metadata; one registered with ``tv_tensor_wrapper=False``
(the box and keypoint kernels, which read and change the metadata) takes the
typed tensor itself, as do kernels registered through ``register_kernel``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Type

import torch

from vision_tpu_torch import tv_tensors

__all__ = ["is_pure_tensor", "register_kernel"]

_KERNEL_REGISTRY: Dict[Callable, Dict[Type, Callable]] = {}


def is_pure_tensor(inpt: Any) -> bool:
    return isinstance(inpt, torch.Tensor) and not isinstance(
        inpt, tv_tensors.TVTensor)


def _unwrap_rewrap(kernel: Callable) -> Callable:
    @functools.wraps(kernel)
    def wrapper(inpt, *args, **kwargs):
        out = kernel(inpt.as_tensor(), *args, **kwargs)
        return tv_tensors.wrap(out, like=inpt)

    return wrapper


def _register_kernel_internal(functional: Callable, input_type: Type, *,
                              tv_tensor_wrapper: bool = True):
    registry = _KERNEL_REGISTRY.setdefault(functional, {})

    def decorator(kernel):
        wrapped = kernel
        if (tv_tensor_wrapper and issubclass(input_type, tv_tensors.TVTensor)
                and input_type is not tv_tensors.TVTensor):
            wrapped = _unwrap_rewrap(kernel)
        registry[input_type] = wrapped
        return kernel

    return decorator


def register_kernel(functional: Callable, tv_tensor_cls: Type):
    """Register the decorated kernel as ``functional``'s for ``tv_tensor_cls``
    (a ``TVTensor`` subclass of the caller's); the kernel receives the typed
    tensor and returns what the functional should."""
    if not (isinstance(tv_tensor_cls, type)
            and issubclass(tv_tensor_cls, tv_tensors.TVTensor)):
        raise ValueError(f"register_kernel takes a TVTensor subclass, got "
                         f"{tv_tensor_cls}")
    return _register_kernel_internal(functional, tv_tensor_cls,
                                     tv_tensor_wrapper=False)


def _get_kernel(functional: Callable, input_type: Type) -> Callable:
    registry = _KERNEL_REGISTRY.get(functional)
    if registry is None:
        raise TypeError(f"no kernels registered for {functional.__name__}")
    for cls in input_type.__mro__:
        if cls in registry:
            return registry[cls]
    raise TypeError(f"{functional.__name__} got unsupported input type "
                    f"{input_type.__name__}")


def _call_kernel(functional: Callable, inpt: Any, *args, **kwargs):
    return _get_kernel(functional, type(inpt))(inpt, *args, **kwargs)
