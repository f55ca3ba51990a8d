"""Image functionals (counterpart of
``vision_tpu/transforms/v2/functional``): those of the presets and those
of the train-time augmentation."""

from vision_tpu_torch.transforms.v2.functional._augment import erase
from vision_tpu_torch.transforms.v2.functional._color import (
    adjust_brightness,
    adjust_contrast,
    adjust_saturation,
    adjust_sharpness,
    autocontrast,
    equalize,
    posterize,
    rgb_to_grayscale,
    solarize,
)
from vision_tpu_torch.transforms.v2.functional._geometry import (
    affine_grid_sample,
    affine_image,
    center_crop_image,
    crop_image,
    horizontal_flip_image,
    inverse_affine_matrix,
    resize_image,
    resized_crop_flip_batch,
    rotate_image,
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
    "adjust_brightness",
    "adjust_contrast",
    "adjust_saturation",
    "adjust_sharpness",
    "affine_grid_sample",
    "affine_image",
    "autocontrast",
    "center_crop_image",
    "crop_image",
    "equalize",
    "erase",
    "horizontal_flip_image",
    "inverse_affine_matrix",
    "normalize_image",
    "posterize",
    "resample_matrix",
    "resize_2d",
    "resize_image",
    "resize_plane",
    "resized_crop_flip_batch",
    "rgb_to_grayscale",
    "rotate_image",
    "solarize",
    "to_dtype_image",
]
