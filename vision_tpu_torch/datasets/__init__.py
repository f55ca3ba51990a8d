"""Datasets of the port (counterpart of ``vision_tpu/datasets``): the
folder datasets, ImageNet, the sampler, collation and the threaded
loader. The other datasets wait (``ROADMAP.md``, queue 1)."""

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

__all__ = [
    "IMG_EXTENSIONS",
    "DataLoader",
    "DatasetFolder",
    "DistributedSampler",
    "ImageFolder",
    "ImageNet",
    "StandardTransform",
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
]
