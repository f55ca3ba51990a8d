"""Datasets of the port (counterpart of ``vision_tpu/datasets``): the
folder datasets, ImageNet, COCO, Pascal VOC, the sampler, collation, the
threaded loader and ``wrap_dataset_for_transforms_v2``. The other
datasets wait (``ROADMAP.md``, queue 1)."""

from vision_tpu_torch.datasets.coco import COCOIndex, CocoCaptions, CocoDetection
from vision_tpu_torch.datasets.folder import (
    IMG_EXTENSIONS,
    DatasetFolder,
    ImageFolder,
    default_loader,
    find_classes,
    has_file_allowed_extension,
    is_image_file,
    make_dataset,
    pil_loader,
)
from vision_tpu_torch.datasets.imagenet import ImageNet, parse_devkit_meta
from vision_tpu_torch.datasets.samplers import (
    DataLoader,
    DistributedSampler,
    default_collate,
)
from vision_tpu_torch.datasets.utils import (
    check_integrity,
    download_and_extract_archive,
    download_url,
    extract_archive,
    verify_str_arg,
)
from vision_tpu_torch.datasets.vision import StandardTransform, VisionDataset
from vision_tpu_torch.datasets.voc import VOCDetection, VOCSegmentation
from vision_tpu_torch.tv_tensors._dataset_wrapper import wrap_dataset_for_transforms_v2

__all__ = [
    "COCOIndex",
    "CocoCaptions",
    "CocoDetection",
    "IMG_EXTENSIONS",
    "DataLoader",
    "DatasetFolder",
    "DistributedSampler",
    "ImageFolder",
    "ImageNet",
    "StandardTransform",
    "VOCDetection",
    "VOCSegmentation",
    "VisionDataset",
    "check_integrity",
    "default_collate",
    "default_loader",
    "download_and_extract_archive",
    "download_url",
    "extract_archive",
    "find_classes",
    "has_file_allowed_extension",
    "is_image_file",
    "make_dataset",
    "parse_devkit_meta",
    "pil_loader",
    "verify_str_arg",
    "wrap_dataset_for_transforms_v2",
]
