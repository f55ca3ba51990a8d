"""Transforms v2 (counterpart of ``vision_tpu/transforms/v2``; the
functionals only)."""

from vision_tpu_torch.transforms.v2 import functional

__all__ = ["functional"]
