"""Container transforms (counterpart of
``vision_tpu/transforms/v2/_container.py``): ``Compose`` and
``RandomChoice``, for batch transforms (``_transform.py``)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from vision_tpu_torch.transforms.v2._transform import Shape, Transform, rand

__all__ = ["Compose", "RandomChoice"]


class Compose(Transform):
    """The transforms in turn; its draws are theirs, in a list, each made for
    the shape its transform will see."""

    def __init__(self, transforms: Sequence[Transform]):
        if not transforms:
            raise ValueError("transforms must not be empty")
        self.transforms = list(transforms)

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

    def __repr__(self) -> str:
        return f"RandomChoice([{', '.join(repr(t) for t in self.transforms)}])"
