"""Transforms v2 (counterpart of ``vision_tpu/transforms/v2``): the batch
transforms of the classification training recipe, the per-sample
transforms of the reference recipes (images, videos, masks, boxes and
keypoints moved together; ``_transform.py`` says which inputs are a batch
and which a sample), the type conversions, the queries over a sample
(``_utils.py``), the v1-only ``ToTensor``, ``ConvertImageDtype`` and
``InterpolationMode``, and the functionals."""

from vision_tpu_torch.transforms.v2 import functional
from vision_tpu_torch.transforms.v2._augment import JPEG, CutMix, MixUp, RandomErasing
from vision_tpu_torch.transforms.v2._auto_augment import (
    AugMix,
    AutoAugment,
    AutoAugmentPolicy,
    RandAugment,
    TrivialAugmentWide,
)
from vision_tpu_torch.transforms.v2._batch_augment import apply_ops_batched
from vision_tpu_torch.transforms.v2._color import (
    RGB,
    ColorJitter,
    GaussianBlur,
    GaussianNoise,
    Grayscale,
    RandomAdjustSharpness,
    RandomAutocontrast,
    RandomChannelPermutation,
    RandomEqualize,
    RandomGrayscale,
    RandomInvert,
    RandomPhotometricDistort,
    RandomPosterize,
    RandomSolarize,
)
from vision_tpu_torch.transforms.v2._container import (
    Compose,
    RandomApply,
    RandomChoice,
    RandomOrder,
)
from vision_tpu_torch.transforms.v2._geometry import (
    CenterCrop,
    ElasticTransform,
    FiveCrop,
    Pad,
    RandomAffine,
    RandomCrop,
    RandomHorizontalFlip,
    RandomIoUCrop,
    RandomPerspective,
    RandomResize,
    RandomResizedCrop,
    RandomRotation,
    RandomShortestSize,
    RandomVerticalFlip,
    RandomZoomOut,
    Resize,
    ScaleJitter,
    TenCrop,
)
from vision_tpu_torch.transforms.v2._misc import (
    ClampBoundingBoxes,
    ClampKeyPoints,
    ConvertBoundingBoxFormat,
    Identity,
    Lambda,
    LinearTransformation,
    Normalize,
    SanitizeBoundingBoxes,
    SanitizeKeyPoints,
    SetClampingMode,
    ToDtype,
)
from vision_tpu_torch.transforms.v2._temporal import UniformTemporalSubsample
from vision_tpu_torch.transforms.v2._transform import (
    Record,
    Replay,
    Transform,
    is_batch,
    to_device,
)

from vision_tpu_torch.transforms.v2._type_conversion import (
    PILToTensor,
    ToImage,
    ToPILImage,
    ToPureTensor,
)
from vision_tpu_torch.transforms.v2._utils import (
    check_type,
    get_bounding_boxes,
    get_keypoints,
    has_all,
    has_any,
    query_chw,
    query_size,
)
from vision_tpu_torch.transforms._compat import (  # noqa: E402
    ConvertImageDtype,
    InterpolationMode,
    ToTensor,
)

__all__ = sorted(n for n in globals() if not n.startswith("_")
                 and n != "annotations")
