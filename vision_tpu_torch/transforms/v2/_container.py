"""Container transforms (counterpart of
``vision_tpu/transforms/v2/_container.py``): ``Compose`` and
``RandomChoice`` for batches (where every member has a batch form; else
a plain 4-d tensor is one sample) and samples (``_transform.py``);
``RandomApply`` and ``RandomOrder`` for samples. A container passes the
sample's generator (a ``Record`` or ``Replay`` too) to each transform it
runs, in turn; its own draw (the pick, the gate, the order) comes first.
A member that is not a ``Transform`` is called on the sample alone."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.utils._pytree as pytree

from vision_tpu_torch.transforms.v2._transform import (
    Shape,
    Transform,
    permutation,
    rand,
    uniform,
)

__all__ = ["Compose", "RandomApply", "RandomChoice", "RandomOrder"]


def _run(t: Callable, sample: Any, generator) -> Any:
    return t(sample, generator) if isinstance(t, Transform) else t(sample)


def _flat(sample: Any) -> List[Any]:
    return pytree.tree_flatten(sample)[0]


class Compose(Transform):
    """The transforms in turn; its draws are theirs, in a list, each made for
    the shape its transform will see."""

    def __init__(self, transforms: Sequence[Transform]):
        if not transforms:
            raise ValueError("transforms must not be empty")
        self.transforms = list(transforms)

    def batch_form(self) -> bool:
        return all(isinstance(t, Transform) and t.batch_form()
                   for t in self.transforms)

    def output_shape(self, shape: Shape) -> Shape:
        for t in self.transforms:
            shape = t.output_shape(shape)
        return shape

    def draw(self, shape: Shape, generator: torch.Generator) -> List[Any]:
        params = []
        for t in self.transforms:
            params.append(t.draw(shape, generator))
            shape = t.output_shape(shape)
        return params

    def apply(self, inputs: Any, params: List[Any]) -> Any:
        for t, p in zip(self.transforms, params):
            inputs = t.apply(inputs, p)
        return inputs

    def forward_sample(self, sample: Any, generator=None) -> Any:
        for t in self.transforms:
            sample = _run(t, sample, generator)
        return sample

    def __repr__(self) -> str:
        return f"Compose([{', '.join(repr(t) for t in self.transforms)}])"


class RandomChoice(Transform):
    """One of ``transforms`` for the whole batch, picked with probabilities
    ``p`` (equal by default). The pick is a tensor, and so that nothing
    waits for it on the host, ``apply`` runs every transform and selects
    the picked one's output element by element: the transforms must give
    outputs of the same shapes."""

    def __init__(self, transforms: Sequence[Transform],
                 p: Optional[Sequence[float]] = None):
        self.transforms = list(transforms)
        if p is None:
            p = [1.0] * len(self.transforms)
        elif len(p) != len(self.transforms):
            raise ValueError("length of p must match transforms")
        total = float(sum(p))
        self.p = [float(x) / total for x in p]

    def batch_form(self) -> bool:
        return all(t.batch_form() for t in self.transforms)

    def output_shape(self, shape: Shape) -> Shape:
        return self.transforms[0].output_shape(shape)

    def draw(self, shape: Shape, generator: torch.Generator) -> Dict[str, Any]:
        u = rand((), generator)
        choice = torch.zeros((), dtype=torch.int64, device=u.device)
        edge = 0.0
        for p in self.p[:-1]:  # host numbers: no copy to the device
            edge += p
            choice += u >= edge
        return {"choice": choice,
                "params": [t.draw(shape, generator) for t in self.transforms]}

    def apply(self, inputs: Any, params: Dict[str, Any]) -> Any:
        outs = [t.apply(inputs, p) for t, p in zip(self.transforms, params["params"])]
        choice = params["choice"]

        def pick(*options):
            if isinstance(options[0], (tuple, list)):
                return type(options[0])(pick(*o) for o in zip(*options))
            out = options[-1]
            for k in range(len(options) - 2, -1, -1):
                out = torch.where(choice.to(out.device) == k, options[k], out)
            return out

        return pick(*outs)

    def make_params(self, flat_inputs, generator):
        u, edge = uniform(generator), 0.0
        for k, p in enumerate(self.p[:-1]):
            edge += p
            if u < edge:
                return {"choice": k}
        return {"choice": len(self.p) - 1}

    def forward_sample(self, sample: Any, generator=None) -> Any:
        params = self.sample_params(_flat(sample), generator)
        return _run(self.transforms[params["choice"]], sample, generator)

    def __repr__(self) -> str:
        return f"RandomChoice([{', '.join(repr(t) for t in self.transforms)}])"


class RandomApply(Transform):
    """The whole list, in turn, with probability ``p``."""

    def __init__(self, transforms: Sequence[Callable], p: float = 0.5):
        self.transforms = list(transforms)
        self.p = p

    def make_params(self, flat_inputs, generator):
        return {"applied": uniform(generator) < self.p}

    def forward_sample(self, sample: Any, generator=None) -> Any:
        if self.sample_params(_flat(sample), generator)["applied"]:
            for t in self.transforms:
                sample = _run(t, sample, generator)
        return sample


class RandomOrder(Transform):
    """Every transform, in a uniformly random order."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def make_params(self, flat_inputs, generator):
        return {"order": permutation(generator, len(self.transforms))}

    def forward_sample(self, sample: Any, generator=None) -> Any:
        for i in self.sample_params(_flat(sample), generator)["order"]:
            sample = _run(self.transforms[i], sample, generator)
        return sample
