"""Datasets of the port (counterpart of ``vision_tpu/datasets``): the
folder datasets, ImageNet, COCO, Pascal VOC, CIFAR-10/100, the MNIST
family, FakeData, the classification datasets of ``_small.py`` (DTD,
Flowers102, Food101, GTSRB, EuroSAT, STL10, SVHN, OxfordIIITPet,
Country211, FGVCAircraft, Imagenette, RenderedSST2, SUN397, Caltech101/256,
USPS, SEMEION), the sampler, collation, the threaded loader and
``wrap_dataset_for_transforms_v2``. Images are ``[C, H, W]`` uint8 tensors.
The other datasets wait (``ROADMAP.md``, queue 1)."""

from vision_tpu_torch.datasets._small import (
    DTD,
    GTSRB,
    SEMEION,
    STL10,
    SUN397,
    SVHN,
    USPS,
    Caltech101,
    Caltech256,
    Country211,
    EuroSAT,
    FGVCAircraft,
    Flowers102,
    Food101,
    Imagenette,
    OxfordIIITPet,
    RenderedSST2,
)
from vision_tpu_torch.datasets.cifar import CIFAR10, CIFAR100
from vision_tpu_torch.datasets.coco import COCOIndex, CocoCaptions, CocoDetection
from vision_tpu_torch.datasets.fakedata import FakeData
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
from vision_tpu_torch.datasets.mnist import (
    EMNIST,
    KMNIST,
    MNIST,
    QMNIST,
    FashionMNIST,
    read_idx_file,
)
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
    "CIFAR10",
    "CIFAR100",
    "COCOIndex",
    "Caltech101",
    "Caltech256",
    "CocoCaptions",
    "CocoDetection",
    "Country211",
    "DTD",
    "DataLoader",
    "DatasetFolder",
    "DistributedSampler",
    "EMNIST",
    "EuroSAT",
    "FGVCAircraft",
    "FakeData",
    "FashionMNIST",
    "Flowers102",
    "Food101",
    "GTSRB",
    "IMG_EXTENSIONS",
    "ImageFolder",
    "ImageNet",
    "Imagenette",
    "KMNIST",
    "MNIST",
    "OxfordIIITPet",
    "QMNIST",
    "RenderedSST2",
    "SEMEION",
    "STL10",
    "SUN397",
    "SVHN",
    "StandardTransform",
    "USPS",
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
    "read_idx_file",
    "verify_str_arg",
    "wrap_dataset_for_transforms_v2",
]
