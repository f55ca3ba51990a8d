"""Transform base classes (counterpart of
``vision_tpu/transforms/v2/_transform.py``): one class, two ways in, one
rule to choose.

**The rule** (``is_batch``). The inputs are a *batch* when they are a plain
4-d tensor ``[N, C, H, W]``, or a tuple or list whose first element is one
(``(images, labels)``), and hold no typed tensor (``tv_tensors``) and no
dict. Anything else is a *sample*: a typed tensor, a tuple such as
``(Image, {"boxes": BoundingBoxes, "labels": tensor})``, a dict, or a plain
tensor of another rank (a ``[C, H, W]`` image). A video is a sample only
as a ``Video``: a plain 4-d tensor is always a batch.

**A batch** splits its work in two:

* ``draw(shape, generator)``: every random draw the call needs, from the
  explicit ``torch.Generator``, as tensors on the generator's device, one
  value a sample where the draw is per sample. ``shape`` is the batch's
  ``(N, C, H, W)``; no pixel is read.
* ``apply(inputs, params)``: the pixels, from those tensors alone. The draws
  may come from another device: ``to_device`` moves them, so that one
  batch's draws made on the card can be applied on the CPU, or handed to
  another library's functionals.

``__call__(inputs, generator)`` is ``apply(inputs, draw(shape,
generator))``. Nothing reads a drawn value on the host, so a call makes no
host synchronisation. This is the JAX package's split between its traced
``make_params`` and ``transform`` (and ``_auto_augment.py``'s ``draws`` and
``apply_ops_batched``); the draws are other numbers than JAX's, from the
same distributions.

**A sample** is flattened with ``torch.utils._pytree`` (dicts, lists and
tuples are nodes, tensors leaves), the transform draws once
(``make_params(flat_inputs, generator)``, a dict of Python numbers) and
transforms each leaf by its type (``transform_sample(inpt, params)``),
which is the JAX package's eager ``Transform.__call__``
(``_transform.py:31-134``) and torchvision's. Leaves of types outside
``_transformed_types`` pass through; a plain tensor is taken as the image
only when the sample holds no ``Image`` or ``Video``, and only the first
plain tensor, so that labels beside an ``Image`` pass through.

**A transform with no batch form** (no ``transform``, ``apply`` or
``transform_all`` of its own: the geometry of samples, the warps, the
blur and the noise, JPEG, the type conversions) takes a plain 4-d tensor
as one sample: one draw for every image of it, as the JAX package's eager
call (its ``make_params`` runs once a call) and torchvision do.

A sample's draws decide output shapes (crop and canvas sizes,
``RandomIoUCrop``'s trials), so they are Python numbers by nature: they
come from a CPU ``torch.Generator`` (the ``generator`` argument; None is
torch's default one), and a CUDA generator is refused, since each draw
would wait for the card. The draws cost no host synchronisation; a
transform that reads a sample's data on the host costs one a call:
``RandomIoUCrop`` (the boxes) and ``SanitizeBoundingBoxes`` (its keep
mask). Nothing else waits for the card.

``Record(generator)`` in place of the generator keeps the params of every
transform of a call that draws (one with a ``make_params`` of its own, or
a gate), in call order (``.params``); ``Replay(params)`` hands them back
in place of drawing: one sample's draws made for the card are applied
again on the CPU, or the JAX package's ``make_params`` output is handed
across.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.utils._pytree as pytree

from vision_tpu_torch import tv_tensors

__all__ = ["Record", "Replay", "Transform", "is_batch", "rand", "to_device"]

Shape = Tuple[int, ...]


def rand(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Uniform [0, 1) f32 draws on the generator's device."""
    return torch.rand(tuple(shape), generator=generator, device=generator.device)


def to_device(params: Any, device) -> Any:
    """``params`` (tensors in nested dicts, lists and tuples) on ``device``."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(to_device(v, device) for v in params)
    return params


def _images(inputs: Any) -> torch.Tensor:
    return inputs[0] if isinstance(inputs, (tuple, list)) else inputs


def is_batch(inputs: Any) -> bool:
    """The rule of the module docstring."""
    first = _images(inputs)
    if not (isinstance(first, torch.Tensor)
            and not isinstance(first, tv_tensors.TVTensor) and first.ndim == 4):
        return False
    leaves, _ = pytree.tree_flatten(inputs)
    return not any(isinstance(x, tv_tensors.TVTensor) for x in leaves) and (
        not _has_dict(inputs))


def _has_dict(x: Any) -> bool:
    if isinstance(x, dict):
        return True
    if isinstance(x, (tuple, list)):
        return any(_has_dict(v) for v in x)
    return False


class Record:
    """A generator that keeps every transform's params, in call order."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator
        self.params: List[Dict[str, Any]] = []


class Replay:
    """Hands back ``params`` (a ``Record``'s, or any list in call order) in
    place of drawing."""

    def __init__(self, params: Sequence[Dict[str, Any]]):
        self._params = list(params)
        self._next = 0

    def next(self, transform: "Transform") -> Dict[str, Any]:
        if self._next >= len(self._params):
            raise RuntimeError(f"no params left to replay for {transform!r}")
        self._next += 1
        return self._params[self._next - 1]

    @property
    def exhausted(self) -> bool:
        return self._next == len(self._params)


SampleGenerator = Union[None, torch.Generator, Record, Replay]


def host_generator(generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
    if generator is not None and generator.device.type != "cpu":
        raise ValueError("a sample's draws come from a CPU generator (each "
                         f"draw on {generator.device} would wait for it)")
    return generator


def uniform(generator: Optional[torch.Generator], low: float = 0.0,
            high: float = 1.0) -> float:
    """One uniform draw in [low, high), a Python float (f64 arithmetic)."""
    u = float(torch.rand((), generator=generator, dtype=torch.float64))
    return low + u * (high - low)


def randint(generator: Optional[torch.Generator], low: int, high: int) -> int:
    """One integer in [low, high)."""
    return int(torch.randint(low, high, (), generator=generator))


def permutation(generator: Optional[torch.Generator], n: int) -> List[int]:
    return torch.randperm(n, generator=generator).tolist()


_TENSOR = torch.Tensor


class Transform:
    """Base class. A batch transform implements ``transform(images,
    params)`` and, if it is random, ``draw(shape, generator)``, and one
    that changes the images' size says so in ``output_shape``. A sample
    transform implements ``transform_sample(inpt, params)`` and, if it is
    random, ``make_params(flat_inputs, generator)``."""

    # the types a sample transform changes; a plain tensor only as the image
    _transformed_types: Tuple[type, ...] = (tv_tensors.TVTensor, _TENSOR)

    # -- batches ----------------------------------------------------------
    def output_shape(self, shape: Shape) -> Shape:
        return tuple(shape)

    def draw(self, shape: Shape, generator: torch.Generator) -> Dict[str, Any]:
        return {}

    def transform(self, images: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} has no batch form")

    def apply(self, inputs: Any, params: Dict[str, Any]) -> Any:
        if isinstance(inputs, (tuple, list)):
            return (self.transform(inputs[0], params), *inputs[1:])
        return self.transform(inputs, params)

    # -- samples ----------------------------------------------------------
    def check_inputs(self, flat_inputs: List[Any]) -> None:
        pass

    def make_params(self, flat_inputs: List[Any],
                    generator: Optional[torch.Generator]) -> Dict[str, Any]:
        return {}

    def transform_sample(self, inpt: Any, params: Dict[str, Any]) -> Any:
        raise NotImplementedError(f"{type(self).__name__} has no sample form")

    def _draw_sample(self, flat_inputs, generator) -> Dict[str, Any]:
        return self.make_params(flat_inputs, generator)

    def sample_params(self, flat_inputs: List[Any],
                      generator: SampleGenerator) -> Dict[str, Any]:
        """``make_params`` from ``generator``, or the next params of a
        ``Replay``; a ``Record`` keeps them. A transform that draws nothing
        (no ``make_params`` of its own, no gate) neither records nor
        replays."""
        if not self._draws():
            return {}
        if isinstance(generator, Replay):
            return generator.next(self)
        inner = generator.generator if isinstance(generator, Record) else generator
        params = self._draw_sample(flat_inputs, host_generator(inner))
        if isinstance(generator, Record):
            generator.params.append(params)
        return params

    def _draws(self) -> bool:
        return type(self).make_params is not Transform.make_params

    def _transforms(self, x: Any, types: Tuple[type, ...]) -> bool:
        if isinstance(x, tv_tensors.TVTensor):
            return any(isinstance(x, t) for t in types if t is not _TENSOR)
        return False

    def _needs_transform_list(self, flat_inputs: List[Any]) -> List[bool]:
        has_image = any(isinstance(x, (tv_tensors.Image, tv_tensors.Video))
                        for x in flat_inputs)
        plain = _TENSOR in self._transformed_types
        needs, seen_plain = [], False
        for x in flat_inputs:
            if isinstance(x, tv_tensors.TVTensor):
                needs.append(self._transforms(x, self._transformed_types))
            elif isinstance(x, torch.Tensor):
                needs.append(plain and not has_image and not seen_plain)
                seen_plain = True
            else:
                needs.append(False)
        return needs

    def forward_sample(self, sample: Any, generator: SampleGenerator) -> Any:
        flat, spec = pytree.tree_flatten(sample)
        self.check_inputs(flat)
        params = self.sample_params(flat, generator)
        if not params.get("applied", True):
            return sample
        needs = self._needs_transform_list(flat)
        params = self.prepare(params, [x for x, n in zip(flat, needs) if n])
        out = [self.transform_sample(x, params) if n else x
               for x, n in zip(flat, needs)]
        return pytree.tree_unflatten(out, spec)

    def prepare(self, params: Dict[str, Any], flat_inputs: List[Any]
                ) -> Dict[str, Any]:
        """The params the leaves are transformed with: ``params`` as drawn
        (a transform whose params hold a tensor moves it to the sample's
        device here, once a call)."""
        return params

    # -- either -----------------------------------------------------------
    def batch_form(self) -> bool:
        """Whether a batch goes through ``draw`` and ``apply`` (else a plain
        4-d tensor is one sample)."""
        return (type(self).transform is not Transform.transform
                or type(self).apply is not Transform.apply)

    def __call__(self, inputs: Any, generator: SampleGenerator = None) -> Any:
        if is_batch(inputs) and self.batch_form():
            return self.apply(inputs, self.draw(tuple(_images(inputs).shape),
                                                generator))
        return self.forward_sample(inputs, generator)

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class _RandomApplyTransform(Transform):
    """Applied with probability ``p``. A batch's draws add ``"applied"``
    (``[N]`` bool, drawn first), and the images that were not picked come
    back as they were. A sample draws the gate first (none for ``p`` 1;
    ``p`` 0 draws nothing), then, if applied, ``make_params``: its params
    are ``{"applied": bool, **make_params}``."""

    def __init__(self, p: float = 0.5):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.p = p

    def draw_params(self, shape: Shape, generator: torch.Generator) -> Dict[str, Any]:
        return {}

    def draw(self, shape: Shape, generator: torch.Generator) -> Dict[str, Any]:
        applied = rand((shape[0],), generator) < self.p
        return {"applied": applied, **self.draw_params(shape, generator)}

    def transform(self, images: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
        out = self.transform_all(images, params)
        applied = params["applied"].to(images.device).view(-1, 1, 1, 1)
        return torch.where(applied, out, images)

    def transform_all(self, images: torch.Tensor,
                      params: Dict[str, Any]) -> torch.Tensor:
        """The transform applied to every image of the batch."""
        raise NotImplementedError

    def batch_form(self) -> bool:
        return type(self).transform_all is not _RandomApplyTransform.transform_all

    def _draws(self) -> bool:
        return True

    def _draw_sample(self, flat_inputs, generator) -> Dict[str, Any]:
        if self.p == 0.0 or (self.p < 1.0 and uniform(generator) >= self.p):
            return {"applied": False}
        return {"applied": True, **self.make_params(flat_inputs, generator)}
