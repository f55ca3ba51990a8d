"""The MNIST family (reference ``torchvision/datasets/mnist.py``; the port's
copy of ``vision_tpu/datasets/mnist.py``): the raw IDX files under
``root/<Class>/raw``. ``data`` is a ``[N, 28, 28]`` uint8 tensor and
``targets`` a tensor, as the reference keeps them; a sample is a
``[1, 28, 28]`` uint8 tensor and an int (``vision_tpu`` returns HWC
arrays)."""

from __future__ import annotations

import os
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from vision_tpu_torch.datasets.utils import download_and_extract_archive
from vision_tpu_torch.datasets.vision import VisionDataset

__all__ = ["EMNIST", "FashionMNIST", "KMNIST", "MNIST", "QMNIST", "read_idx_file"]

_IDX_DTYPES = {
    8: np.uint8,
    9: np.int8,
    11: np.dtype(">i2"),
    12: np.dtype(">i4"),
    13: np.dtype(">f4"),
    14: np.dtype(">f8"),
}


def read_idx_file(path: str) -> torch.Tensor:
    """An IDX file as a tensor in host byte order (reference ``mnist.py``
    ``read_sn3_pascalvincent_tensor``): its magic number's type byte gives
    the dtype and its low byte the number of dimensions (1 to 3)."""
    with open(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    nd, ty = magic % 256, magic // 256
    if ty not in _IDX_DTYPES or not 1 <= nd <= 3:
        raise ValueError(f"invalid IDX magic {magic}")
    sizes = [int.from_bytes(data[4 * (i + 1):4 * (i + 2)], "big") for i in range(nd)]
    arr = np.frombuffer(data, dtype=_IDX_DTYPES[ty], offset=4 * (nd + 1))
    arr = arr.reshape(sizes).astype(arr.dtype.newbyteorder("="))
    return torch.from_numpy(np.ascontiguousarray(arr))


class MNIST(VisionDataset):
    """reference ``mnist.py`` MNIST: ``{train,t10k}-{images-idx3,labels-idx1}
    -ubyte`` in ``raw_folder``."""

    mirrors = ["https://ossci-datasets.s3.amazonaws.com/mnist/"]
    resources = [
        ("train-images-idx3-ubyte.gz", "f68b3c2dcbeaaa9fbdd348bbdeb94873"),
        ("train-labels-idx1-ubyte.gz", "d53e105ee54ea40749a09fcbcd1e9432"),
        ("t10k-images-idx3-ubyte.gz", "9fb629c4189551a2d022fa330f9573f3"),
        ("t10k-labels-idx1-ubyte.gz", "ec29112dd5afa0611ce80d1b7f02629c"),
    ]
    classes = [
        "0 - zero", "1 - one", "2 - two", "3 - three", "4 - four",
        "5 - five", "6 - six", "7 - seven", "8 - eight", "9 - nine",
    ]

    def __init__(self, root: str, train: bool = True,
                 transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None,
                 download: bool = False):
        super().__init__(root, transform=transform, target_transform=target_transform)
        self.train = train
        if download:
            self.download()
        if not self._check_exists():
            raise RuntimeError("Dataset not found. Use download=True to download it")
        split = "train" if train else "t10k"
        self.data = read_idx_file(os.path.join(self.raw_folder, f"{split}-images-idx3-ubyte"))
        self.targets = read_idx_file(os.path.join(self.raw_folder, f"{split}-labels-idx1-ubyte"))

    @property
    def raw_folder(self) -> str:
        return os.path.join(self.root, self.__class__.__name__, "raw")

    def _check_exists(self) -> bool:
        return all(os.path.exists(os.path.join(self.raw_folder, f.removesuffix(".gz")))
                   for f, _ in self.resources)

    def download(self) -> None:
        if self._check_exists():
            return
        os.makedirs(self.raw_folder, exist_ok=True)
        for filename, md5 in self.resources:
            for mirror in self.mirrors:
                try:
                    download_and_extract_archive(mirror + filename, self.raw_folder,
                                                 filename=filename, md5=md5)
                    break
                except RuntimeError:
                    continue
            else:
                raise RuntimeError(f"Error downloading {filename}")

    def __getitem__(self, index: int) -> Tuple[Any, Any]:
        img = self.data[index].unsqueeze(0)  # [1, H, W] uint8
        target = int(self.targets[index])
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target

    def __len__(self) -> int:
        return len(self.data)


class FashionMNIST(MNIST):
    mirrors = ["http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/"]
    resources = [
        ("train-images-idx3-ubyte.gz", "8d4fb7e6c68d591d4c3dfef9ec88bf0d"),
        ("train-labels-idx1-ubyte.gz", "25c81989df183df01b3e8a0aad5dffbe"),
        ("t10k-images-idx3-ubyte.gz", "bef4ecab320f06d8554ea6380940ec79"),
        ("t10k-labels-idx1-ubyte.gz", "bb300cfdad3c16e7a12a480ee83cd310"),
    ]
    classes = [
        "T-shirt/top", "Trouser", "Pullover", "Dress", "Coat", "Sandal",
        "Shirt", "Sneaker", "Bag", "Ankle boot",
    ]


class KMNIST(MNIST):
    mirrors = ["http://codh.rois.ac.jp/kmnist/dataset/kmnist/"]
    resources = [
        ("train-images-idx3-ubyte.gz", "bdb82020997e1d708af4cf47b453dcf7"),
        ("train-labels-idx1-ubyte.gz", "e144d726b3acfaa3e44228e80efcd344"),
        ("t10k-images-idx3-ubyte.gz", "5c965bf0a639b31b8f53240b1b52f4d7"),
        ("t10k-labels-idx1-ubyte.gz", "7320c461ea6c1c855c0b718fb2a4b134"),
    ]
    classes = ["o", "ki", "su", "tsu", "na", "ha", "ma", "ya", "re", "wo"]


class EMNIST(MNIST):
    """reference ``mnist.py`` EMNIST: ``emnist-<split>-{train,test}-*`` IDX
    files in ``root/EMNIST/raw``; the stored images are transposed (column
    scans) and are turned back on load."""

    splits = ("byclass", "bymerge", "balanced", "letters", "digits", "mnist")

    def __init__(self, root, split, train=True, transform=None,
                 target_transform=None, download=False):
        if split not in self.splits:
            raise ValueError(f"split must be one of {self.splits}")
        self.split = split
        suffix = "train" if train else "test"
        self.resources = [
            (f"emnist-{split}-{suffix}-images-idx3-ubyte.gz", None),
            (f"emnist-{split}-{suffix}-labels-idx1-ubyte.gz", None),
        ]
        VisionDataset.__init__(self, root, transform=transform,
                               target_transform=target_transform)
        self.train = train
        if not self._check_exists():
            raise RuntimeError(
                f"EMNIST files not found in {self.raw_folder} (auto-download "
                "of the NIST zip-of-gzips is not supported; extract manually)")
        self.data = read_idx_file(os.path.join(
            self.raw_folder, f"emnist-{split}-{suffix}-images-idx3-ubyte")
        ).transpose(1, 2).contiguous()
        self.targets = read_idx_file(os.path.join(
            self.raw_folder, f"emnist-{split}-{suffix}-labels-idx1-ubyte"))

    @property
    def raw_folder(self):
        return os.path.join(self.root, "EMNIST", "raw")


class QMNIST(MNIST):
    """reference ``mnist.py`` QMNIST: the labels are an idx2 int32 matrix
    ``(N, 8)`` whose column 0 is the class; ``test10k`` / ``test50k`` are
    the first 10,000 and the rest of the test set."""

    subsets = {"train": "train", "test": "test", "test10k": "test",
               "test50k": "test", "nist": "nist"}

    def __init__(self, root, what="train", train=True, transform=None,
                 target_transform=None, download=False):
        if what is None:
            what = "train" if train else "test"
        if what not in self.subsets:
            raise ValueError(f"what must be one of {tuple(self.subsets)}")
        self.what = what
        subset = self.subsets[what]
        self.resources = [
            (f"qmnist-{subset}-images-idx3-ubyte.gz", None),
            (f"qmnist-{subset}-labels-idx2-int.gz", None),
        ]
        VisionDataset.__init__(self, root, transform=transform,
                               target_transform=target_transform)
        self.train = what == "train"
        if not self._check_exists():
            raise RuntimeError(f"QMNIST files not found in {self.raw_folder}")
        self.data = read_idx_file(os.path.join(self.raw_folder,
                                               f"qmnist-{subset}-images-idx3-ubyte"))
        full_targets = read_idx_file(os.path.join(self.raw_folder,
                                                  f"qmnist-{subset}-labels-idx2-int"))
        if what == "test10k":
            self.data, full_targets = self.data[:10000], full_targets[:10000]
        elif what == "test50k":
            self.data, full_targets = self.data[10000:], full_targets[10000:]
        self.targets = full_targets[:, 0].contiguous()

    @property
    def raw_folder(self):
        return os.path.join(self.root, "QMNIST", "raw")
