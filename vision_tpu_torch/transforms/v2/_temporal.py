"""Temporal transforms (counterpart of
``vision_tpu/transforms/v2/_temporal.py``)."""

from __future__ import annotations

import torch

from vision_tpu_torch import tv_tensors
from vision_tpu_torch.transforms.v2._transform import Transform

__all__ = ["UniformTemporalSubsample"]


class UniformTemporalSubsample(Transform):
    """``num_samples`` frames evenly spaced over the T axis of a video
    ``[..., T, C, H, W]``: frame ``floor((T - 1) i / (n - 1))``, in exact
    integer arithmetic. The JAX package truncates ``jnp.linspace``'s f32
    points, which XLA rounds just below an integer at a few (T, n) (3 of
    the 69 n < 70 at T = 6, e.g. n = 26) and so takes the frame before
    there; the two agree at every other (T, n) up to T = 129, n = 69."""

    _transformed_types = (tv_tensors.Video, torch.Tensor)

    def __init__(self, num_samples: int):
        self.num_samples = num_samples

    def transform_sample(self, inpt, params):
        t, n = inpt.shape[-4], self.num_samples
        index = (torch.zeros(1, dtype=torch.int64) if n == 1
                 else (t - 1) * torch.arange(n) // (n - 1))
        out = inpt.as_subclass(torch.Tensor).index_select(
            -4, index.to(inpt.device))
        if isinstance(inpt, tv_tensors.TVTensor):
            return tv_tensors.wrap(out, like=inpt)
        return out
