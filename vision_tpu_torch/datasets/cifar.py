"""CIFAR-10/100 (reference ``torchvision/datasets/cifar.py``; the port's
copy of ``vision_tpu/datasets/cifar.py``). The pickled batches of
``cifar-10-batches-py`` / ``cifar-100-python`` are read whole; ``data`` is
one ``[N, 3, 32, 32]`` uint8 tensor, as the batches store the rows, and a
sample is its ``[3, 32, 32]`` slice (``vision_tpu`` returns HWC arrays)."""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from vision_tpu_torch.datasets.utils import check_integrity, download_and_extract_archive
from vision_tpu_torch.datasets.vision import VisionDataset

__all__ = ["CIFAR10", "CIFAR100"]


class CIFAR10(VisionDataset):
    """reference ``cifar.py`` CIFAR10: ``root/cifar-10-batches-py``, its
    digests checked; CHW uint8 images and int targets."""

    base_folder = "cifar-10-batches-py"
    url = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
    filename = "cifar-10-python.tar.gz"
    tgz_md5 = "c58f30108f718f92721af3b95e74349a"
    train_list = [
        ["data_batch_1", "c99cafc152244af753f735de768cd75f"],
        ["data_batch_2", "d4bba439e000b95fd0a9bffe97cbabec"],
        ["data_batch_3", "54ebc095f3ab1f0389bbae665268c751"],
        ["data_batch_4", "634d18415352ddfa80567beed471001a"],
        ["data_batch_5", "482c414d41f54cd18b22e5b47cb7c3cb"],
    ]
    test_list = [["test_batch", "40351d587109b95175f43aff81a1287e"]]
    meta = {
        "filename": "batches.meta",
        "key": "label_names",
        "md5": "5ff9c542aee3614f3951f8cda6e48888",
    }

    def __init__(self, root: str, train: bool = True,
                 transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None,
                 download: bool = False):
        super().__init__(root, transform=transform, target_transform=target_transform)
        self.train = train
        if download:
            self.download()
        if not self._check_integrity():
            raise RuntimeError("Dataset not found or corrupted. Use download=True")
        rows, self.targets = [], []
        for file_name, _ in (self.train_list if train else self.test_list):
            with open(os.path.join(self.root, self.base_folder, file_name), "rb") as f:
                entry = pickle.load(f, encoding="latin1")
            rows.append(entry["data"])
            self.targets.extend(entry.get("labels", entry.get("fine_labels")))
        self.data = torch.from_numpy(
            np.ascontiguousarray(np.vstack(rows), dtype=np.uint8).reshape(-1, 3, 32, 32))
        self._load_meta()

    def _load_meta(self) -> None:
        path = os.path.join(self.root, self.base_folder, self.meta["filename"])
        if os.path.exists(path):
            with open(path, "rb") as f:
                data = pickle.load(f, encoding="latin1")
            self.classes = data[self.meta["key"]]
            self.class_to_idx = {c: i for i, c in enumerate(self.classes)}

    def _check_integrity(self) -> bool:
        return all(check_integrity(os.path.join(self.root, self.base_folder, name), md5)
                   for name, md5 in self.train_list + self.test_list)

    def download(self) -> None:
        if self._check_integrity():
            return
        download_and_extract_archive(self.url, self.root, filename=self.filename,
                                     md5=self.tgz_md5)

    def __getitem__(self, index: int) -> Tuple[Any, Any]:
        img, target = self.data[index], self.targets[index]
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target

    def __len__(self) -> int:
        return len(self.data)


class CIFAR100(CIFAR10):
    """reference ``cifar.py`` CIFAR100: the fine labels."""

    base_folder = "cifar-100-python"
    url = "https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz"
    filename = "cifar-100-python.tar.gz"
    tgz_md5 = "eb9058c3a382ffc7106e4002c42a8d85"
    train_list = [["train", "16019d7e3df5f24257cddd939b257f8d"]]
    test_list = [["test", "f0ef6b0ae62326f3e7ffdfab6717acfc"]]
    meta = {
        "filename": "meta",
        "key": "fine_label_names",
        "md5": "7973b15100ade9c7d40fb424638fde48",
    }
