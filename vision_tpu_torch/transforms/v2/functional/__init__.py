"""Functionals (counterpart of ``vision_tpu/transforms/v2/functional``):
the image kernels of the presets and the batch augmentation, and the
per-sample kernels of images, videos, masks, boxes and keypoints with the
functionals that pick one by the input's type (``register_kernel``); the
v1 names and the per-type names (``_aliases.py``); ``InterpolationMode``."""

from vision_tpu_torch.transforms.v2.functional._augment import (
    erase,
    jpeg,
    jpeg_image,
)
from vision_tpu_torch.transforms.v2.functional._color import (
    adjust_brightness,
    adjust_contrast,
    adjust_gamma,
    adjust_hue,
    adjust_saturation,
    adjust_sharpness,
    autocontrast,
    equalize,
    grayscale_to_rgb,
    invert,
    permute_channels,
    posterize,
    rgb_to_grayscale,
    solarize,
)
from vision_tpu_torch.transforms.v2.functional._geometry import (
    affine,
    affine_bounding_boxes,
    affine_grid_sample,
    affine_image,
    affine_keypoints,
    affine_mask,
    center_crop,
    center_crop_image,
    crop,
    crop_bounding_boxes,
    crop_image,
    crop_keypoints,
    crop_mask,
    elastic,
    elastic_bounding_boxes,
    elastic_image,
    elastic_keypoints,
    elastic_mask,
    five_crop,
    horizontal_flip,
    horizontal_flip_bounding_boxes,
    horizontal_flip_image,
    horizontal_flip_keypoints,
    horizontal_flip_mask,
    inverse_affine_matrix,
    pad,
    pad_image,
    pad_mask,
    perspective,
    perspective_bounding_boxes,
    perspective_image,
    perspective_keypoints,
    perspective_mask,
    resize,
    resize_bounding_boxes,
    resize_image,
    resize_keypoints,
    resize_mask,
    resized_crop,
    resized_crop_dynamic,
    resized_crop_flip_batch,
    resized_crop_image,
    rotate,
    rotate_bounding_boxes,
    rotate_image,
    rotate_keypoints,
    rotate_mask,
    ten_crop,
    vertical_flip,
    vertical_flip_bounding_boxes,
    vertical_flip_image,
    vertical_flip_keypoints,
    vertical_flip_mask,
)
from vision_tpu_torch.transforms.v2.functional._meta import (
    clamp_bounding_boxes,
    clamp_keypoints,
    convert_bounding_box_format,
    get_num_channels,
    get_num_frames,
    get_size,
)
from vision_tpu_torch.transforms.v2.functional._misc import (
    gaussian_blur,
    gaussian_blur_image,
    gaussian_noise,
    normalize,
    normalize_image,
    sanitize_bounding_boxes,
    to_dtype,
    to_dtype_image,
)
from vision_tpu_torch.transforms.v2.functional._resample import (
    resample_matrix,
    resize_2d,
    resize_plane,
)
from vision_tpu_torch.transforms.v2.functional._utils import (
    is_pure_tensor,
    register_kernel,
)

from vision_tpu_torch.transforms.v2.functional._aliases import (  # noqa: E402
    convert_image_dtype,
    elastic_transform,
    get_dimensions,
    get_image_num_channels,
    get_image_size,
    grayscale_to_rgb_image,
    hflip,
    pil_to_tensor,
    sanitize_keypoints,
    to_grayscale,
    to_image,
    to_pil_image,
    to_tensor,
    uniform_temporal_subsample,
    uniform_temporal_subsample_video,
    vflip,
)
from vision_tpu_torch.transforms._compat import InterpolationMode  # noqa: E402
from vision_tpu_torch.transforms.v2.functional import _aliases  # noqa: E402

__all__ = sorted(
    [n for n in globals() if not n.startswith("_") and n not in (
        "annotations",)]
    + _aliases.add_aliases(globals()))
del _aliases
