"""vision_tpu_torch — the PyTorch/CUDA port of ``vision_tpu``.

The package imports ``torch`` and ``numpy`` only. Public functions take
NCHW tensors, as torchvision's do. The kernels that ``vision_tpu`` wrote
in Pallas for the TPU are CUDA C++ kernels here (``csrc/``), built with
``nvcc`` on first use on the card; each has a plain PyTorch version
beside it, which runs for tensors on the CPU.
"""

from vision_tpu_torch import models, ops, transforms

__all__ = ["models", "ops", "transforms"]
