"""Image functionals (counterpart of
``vision_tpu/transforms/v2/functional``; the ones the presets call)."""

from vision_tpu_torch.transforms.v2.functional._geometry import (
    center_crop_image,
    crop_image,
    resize_image,
)
from vision_tpu_torch.transforms.v2.functional._misc import (
    normalize_image,
    to_dtype_image,
)
from vision_tpu_torch.transforms.v2.functional._resample import (
    resample_matrix,
    resize_2d,
    resize_plane,
)

__all__ = [
    "center_crop_image",
    "crop_image",
    "normalize_image",
    "resample_matrix",
    "resize_2d",
    "resize_image",
    "resize_plane",
    "to_dtype_image",
]
