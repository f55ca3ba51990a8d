"""The v1 module path ``transforms.transforms`` (counterpart of
``vision_tpu/transforms/transforms.py``): the v1 classes, which live on the
package."""

from vision_tpu_torch.transforms import *  # noqa: F401,F403
from vision_tpu_torch.transforms import (  # noqa: F401
    ConvertImageDtype,
    InterpolationMode,
    ToTensor,
)
