"""Additional classification datasets (reference one-file-per-dataset in
``torchvision/datasets/``; the port's copy of ``vision_tpu/datasets/
_small.py``): DTD, Flowers102, Food101, GTSRB, EuroSAT, STL10, SVHN,
OxfordIIITPet, Country211, FGVCAircraft, Imagenette, RenderedSST2, SUN397,
Caltech101/256, USPS, SEMEION.

Each reads the reference's on-disk layout; downloads use the reference
URLs where direct HTTP is available. Images are ``[C, H, W]`` uint8 tensors
(``vision_tpu`` returns HWC arrays): files read through the port's codecs
on the CPU as RGB, the array datasets (STL10, SVHN, USPS, SEMEION) kept as
one ``[N, C, H, W]`` tensor. GTSRB's archive holds ``.ppm`` files, which
neither ``vision_tpu``'s ``decode_image`` nor the port's reads: both raise
on them, and read the ``.png`` and ``.jpg`` files it also accepts."""

from __future__ import annotations

import csv
import os
import pathlib
from typing import List, Tuple

import numpy as np
import torch

from vision_tpu_torch.datasets.folder import ImageFolder
from vision_tpu_torch.datasets.utils import (
    download_and_extract_archive,
    download_url,
    verify_str_arg,
)
from vision_tpu_torch.datasets.vision import VisionDataset

__all__ = [
    "DTD",
    "Flowers102",
    "Food101",
    "GTSRB",
    "EuroSAT",
    "STL10",
    "SVHN",
    "OxfordIIITPet",
    "Country211",
    "FGVCAircraft",
    "Imagenette",
    "RenderedSST2",
    "SUN397",
    "Caltech101",
    "Caltech256",
    "USPS",
    "SEMEION",
]


def _load_image(path) -> torch.Tensor:
    from vision_tpu_torch.io.image import ImageReadMode, read_image

    return read_image(str(path), ImageReadMode.RGB, device="cpu")


def _chw(arr: np.ndarray) -> torch.Tensor:
    """``(N, H, W, C)`` numpy -> ``[N, C, H, W]`` contiguous uint8 tensor."""
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(0, 3, 1, 2), np.uint8))


class _ListDataset(VisionDataset):
    """Common base: a list of (path, label)."""

    def __init__(self, root, transform=None, target_transform=None):
        super().__init__(
            root, transform=transform, target_transform=target_transform
        )
        self._samples: List[Tuple[str, int]] = []

    def __len__(self):
        return len(self._samples)

    def __getitem__(self, idx):
        path, label = self._samples[idx]
        img = _load_image(path)
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            label = self.target_transform(label)
        return img, label


class DTD(_ListDataset):
    """reference ``dtd.py``: describable textures, split files in
    labels/{split}{partition}.txt."""

    _URL = "https://www.robots.ox.ac.uk/~vgg/data/dtd/download/dtd-r1.0.1.tar.gz"
    _MD5 = "fff73e5086ae6bdbea199a49dfb8a4c1"

    def __init__(self, root, split="train", partition=1, transform=None,
                 target_transform=None, download=False):
        super().__init__(root, transform, target_transform)
        self._split = verify_str_arg(split, "split", ("train", "val", "test"))
        base = pathlib.Path(self.root) / "dtd"
        if download and not base.exists():
            download_and_extract_archive(self._URL, self.root, md5=self._MD5)
        if not base.exists():
            raise RuntimeError("Dataset not found; use download=True")
        img_dir = base / "dtd" / "images" if (base / "dtd").exists() else base / "images"
        lbl_dir = img_dir.parent / "labels"
        with open(lbl_dir / f"{split}{partition}.txt") as f:
            names = [line.strip() for line in f if line.strip()]
        self.classes = sorted({n.split("/")[0] for n in names})
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self._samples = [
            (str(img_dir / n), self.class_to_idx[n.split("/")[0]]) for n in names
        ]


class Flowers102(_ListDataset):
    """reference ``flowers102.py``: .mat labels + setid splits (scipy)."""

    _BASE = "https://www.robots.ox.ac.uk/~vgg/data/flowers/102/"

    def __init__(self, root, split="train", transform=None,
                 target_transform=None, download=False):
        super().__init__(root, transform, target_transform)
        split = verify_str_arg(split, "split", ("train", "val", "test"))
        base = pathlib.Path(self.root) / "flowers-102"
        if download and not base.exists():
            os.makedirs(base, exist_ok=True)
            download_and_extract_archive(
                self._BASE + "102flowers.tgz", str(base)
            )
            download_url(self._BASE + "imagelabels.mat", str(base))
            download_url(self._BASE + "setid.mat", str(base))
        if not base.exists():
            raise RuntimeError("Dataset not found; use download=True")
        import scipy.io as sio

        set_ids = sio.loadmat(str(base / "setid.mat"), squeeze_me=True)
        key = {"train": "trnid", "val": "valid", "test": "tstid"}[split]
        ids = set_ids[key]
        labels = sio.loadmat(str(base / "imagelabels.mat"), squeeze_me=True)[
            "labels"
        ]
        img_dir = base / "jpg"
        self._samples = [
            (str(img_dir / f"image_{i:05d}.jpg"), int(labels[i - 1]) - 1)
            for i in ids
        ]


class Food101(_ListDataset):
    """reference ``food101.py``: meta/{split}.txt listing class/img ids."""

    _URL = "http://data.vision.ee.ethz.ch/cvl/food-101.tar.gz"
    _MD5 = "85eeb15f3717b99a5da872d97d918f87"

    def __init__(self, root, split="train", transform=None,
                 target_transform=None, download=False):
        super().__init__(root, transform, target_transform)
        split = verify_str_arg(split, "split", ("train", "test"))
        base = pathlib.Path(self.root) / "food-101"
        if download and not base.exists():
            download_and_extract_archive(self._URL, self.root, md5=self._MD5)
        if not base.exists():
            raise RuntimeError("Dataset not found; use download=True")
        with open(base / "meta" / f"{split}.txt") as f:
            names = [line.strip() for line in f if line.strip()]
        self.classes = sorted({n.split("/")[0] for n in names})
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self._samples = [
            (
                str(base / "images" / f"{n}.jpg"),
                self.class_to_idx[n.split("/")[0]],
            )
            for n in names
        ]


class GTSRB(_ListDataset):
    """reference ``gtsrb.py``: train = class folders of .ppm; test = CSV."""

    _BASE_URL = (
        "https://sid.erda.dk/public/archives/"
        "daaeac0d7ce1152aea9b61d9f1e19370/"
    )

    def __init__(self, root, split="train", transform=None,
                 target_transform=None, download=False):
        super().__init__(root, transform, target_transform)
        split = verify_str_arg(split, "split", ("train", "test"))
        base = pathlib.Path(self.root) / "gtsrb"
        if download and not base.exists():
            if split == "train":
                download_and_extract_archive(
                    self._BASE_URL + "GTSRB-Training_fixed.zip", str(base),
                    md5="513f3c79a4c5141765e10e952eaa2478",
                )
            else:
                download_and_extract_archive(
                    self._BASE_URL + "GTSRB_Final_Test_Images.zip", str(base),
                    md5="c7e4e6327067d32654124b0fe9e82185",
                )
                download_and_extract_archive(
                    self._BASE_URL + "GTSRB_Final_Test_GT.zip", str(base),
                    md5="fe31e9c9270bbcd7b84b7f21a9d9d9e5",
                )
        if not base.exists():
            raise RuntimeError("Dataset not found; use download=True")
        if split == "train":
            folder = base / "GTSRB" / "Training"
            # class id is the integer folder name (e.g. 00007 -> 7)
            self._samples = [
                (str(p), int(p.parent.name))
                for p in sorted(folder.rglob("*"))
                if p.suffix.lower() in (".ppm", ".png", ".jpg")
            ]
        else:
            with open(base / "GT-final_test.csv") as f:
                self._samples = [
                    (
                        str(base / "GTSRB" / "Final_Test" / "Images" / row["Filename"]),
                        int(row["ClassId"]),
                    )
                    for row in csv.DictReader(f, delimiter=";")
                ]


class EuroSAT(ImageFolder):
    """reference ``eurosat.py``: plain ImageFolder under root/eurosat."""

    def __init__(self, root, transform=None, target_transform=None,
                 download=False):
        self._base = os.path.join(os.path.expanduser(root), "eurosat", "2750")
        if download and not os.path.exists(self._base):
            download_and_extract_archive(
                "https://madm.dfki.de/files/sentinel/EuroSAT.zip",
                os.path.join(root, "eurosat"),
            )
        if not os.path.exists(self._base):
            raise RuntimeError("Dataset not found; use download=True")
        super().__init__(
            self._base, transform=transform, target_transform=target_transform
        )


class STL10(VisionDataset):
    """reference ``stl10.py``: binary uint8 blobs, 96x96x3 column-major."""

    base_folder = "stl10_binary"
    url = "http://ai.stanford.edu/~acoates/stl10/stl10_binary.tar.gz"
    tgz_md5 = "91f7769df0f17e558f3565bffb0c7dfb"

    def __init__(self, root, split="train", transform=None,
                 target_transform=None, download=False):
        super().__init__(root, transform=transform, target_transform=target_transform)
        split = verify_str_arg(split, "split", ("train", "test", "unlabeled"))
        base = pathlib.Path(self.root) / self.base_folder
        if download and not base.exists():
            download_and_extract_archive(self.url, self.root, md5=self.tgz_md5)
        if not base.exists():
            raise RuntimeError("Dataset not found; use download=True")
        if split == "unlabeled":
            self.data = self._read_images(base / "unlabeled_X.bin")
            self.labels = np.full(len(self.data), -1)
        else:
            self.data = self._read_images(base / f"{split}_X.bin")
            with open(base / f"{split}_y.bin", "rb") as f:
                self.labels = np.frombuffer(f.read(), np.uint8).astype(np.int64) - 1

    @staticmethod
    def _read_images(path) -> torch.Tensor:
        with open(path, "rb") as f:
            raw = np.frombuffer(f.read(), np.uint8)
        # stored as (N, 3, 96, 96), each plane column-major
        imgs = raw.reshape(-1, 3, 96, 96).transpose(0, 1, 3, 2)
        return torch.from_numpy(np.ascontiguousarray(imgs))  # [N, C, H, W]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        img, target = self.data[idx], int(self.labels[idx])
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target


class SVHN(VisionDataset):
    """reference ``svhn.py``: .mat blobs (scipy)."""

    _files = {
        "train": ("train_32x32.mat", "e26dedcc434d2e4c54c9b2d4a06d8373"),
        "test": ("test_32x32.mat", "eb5a983be6a315427106f1b164d9cef3"),
        "extra": ("extra_32x32.mat", "a93ce644f1a588dc4d68dda5feec44a7"),
    }
    _url = "http://ufldl.stanford.edu/housenumbers/"

    def __init__(self, root, split="train", transform=None,
                 target_transform=None, download=False):
        super().__init__(root, transform=transform, target_transform=target_transform)
        split = verify_str_arg(split, "split", tuple(self._files))
        fname, md5 = self._files[split]
        path = os.path.join(self.root, fname)
        if download and not os.path.exists(path):
            download_url(self._url + fname, self.root, md5=md5)
        if not os.path.exists(path):
            raise RuntimeError("Dataset not found; use download=True")
        import scipy.io as sio

        mat = sio.loadmat(path)
        self.data = _chw(mat["X"].transpose(3, 0, 1, 2))  # [N, C, H, W]
        self.labels = mat["y"].astype(np.int64).squeeze() % 10

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        img, target = self.data[idx], int(self.labels[idx])
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target


class OxfordIIITPet(_ListDataset):
    """reference ``oxford_iiit_pet.py``: annotations/{trainval,test}.txt."""

    _URLS = (
        "https://thor.robots.ox.ac.uk/~vgg/data/pets/images.tar.gz",
        "https://thor.robots.ox.ac.uk/~vgg/data/pets/annotations.tar.gz",
    )

    def __init__(self, root, split="trainval", target_types="category",
                 transform=None, target_transform=None, download=False):
        super().__init__(root, transform, target_transform)
        split = verify_str_arg(split, "split", ("trainval", "test"))
        self._target_types = (
            [target_types]
            if isinstance(target_types, str)
            else list(target_types)
        )
        for t in self._target_types:
            verify_str_arg(t, "target_types", ("category", "segmentation"))
        base = pathlib.Path(self.root) / "oxford-iiit-pet"
        if download and not base.exists():
            for url in self._URLS:
                download_and_extract_archive(url, str(base))
        if not base.exists():
            raise RuntimeError("Dataset not found; use download=True")
        with open(base / "annotations" / f"{split}.txt") as f:
            rows = [line.split() for line in f if not line.startswith("#")]
        self._samples = [
            (str(base / "images" / f"{r[0]}.jpg"), int(r[1]) - 1) for r in rows
        ]
        self._segs = [
            str(base / "annotations" / "trimaps" / f"{r[0]}.png") for r in rows
        ]
        names = sorted(
            {"_".join(r[0].split("_")[:-1]).lower() for r in rows}
        )
        self.classes = names

    def __getitem__(self, idx):
        path, label = self._samples[idx]
        img = _load_image(path)
        targets = []
        for t in self._target_types:
            if t == "category":
                targets.append(label)
            else:  # segmentation: trimap png (1=fg, 2=bg, 3=boundary), [1, H, W]
                from vision_tpu_torch.io.image import read_image

                targets.append(read_image(self._segs[idx], device="cpu"))
        target = targets[0] if len(targets) == 1 else tuple(targets)
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target


class Country211(ImageFolder):
    """reference ``country211.py``: folder-per-country under split dirs."""

    _URL = "https://openaipublic.azureedge.net/clip/data/country211.tgz"

    def __init__(self, root, split="train", transform=None,
                 target_transform=None, download=False):
        split = verify_str_arg(split, "split", ("train", "valid", "test"))
        base = os.path.join(os.path.expanduser(root), "country211")
        if download and not os.path.exists(base):
            download_and_extract_archive(self._URL, root)
        if not os.path.exists(base):
            raise RuntimeError("Dataset not found; use download=True")
        super().__init__(
            os.path.join(base, split), transform=transform,
            target_transform=target_transform,
        )


class FGVCAircraft(_ListDataset):
    """reference ``fgvc_aircraft.py``: images_{level}_{split}.txt."""

    _URL = (
        "https://www.robots.ox.ac.uk/~vgg/data/fgvc-aircraft/archives/"
        "fgvc-aircraft-2013b.tar.gz"
    )

    def __init__(self, root, split="trainval", annotation_level="variant",
                 transform=None, target_transform=None, download=False):
        super().__init__(root, transform, target_transform)
        split = verify_str_arg(split, "split", ("train", "val", "trainval", "test"))
        annotation_level = verify_str_arg(
            annotation_level, "annotation_level",
            ("variant", "family", "manufacturer"),
        )
        base = pathlib.Path(self.root) / "fgvc-aircraft-2013b"
        if download and not base.exists():
            download_and_extract_archive(self._URL, self.root)
        if not base.exists():
            raise RuntimeError("Dataset not found; use download=True")
        data = base / "data"
        classes_file = {
            "variant": "variants.txt",
            "family": "families.txt",
            "manufacturer": "manufacturers.txt",
        }[annotation_level]
        with open(data / classes_file) as f:
            self.classes = [line.strip() for line in f if line.strip()]
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        with open(data / f"images_{annotation_level}_{split}.txt") as f:
            rows = [line.strip().split(" ", 1) for line in f if line.strip()]
        self._samples = [
            (str(data / "images" / f"{img_id}.jpg"), self.class_to_idx[label])
            for img_id, label in rows
        ]


class Imagenette(ImageFolder):
    """reference ``imagenette.py``: ImageFolder over train/val."""

    _URL = "https://s3.amazonaws.com/fast-ai-imageclas/imagenette2.tgz"

    def __init__(self, root, split="train", size="full", transform=None,
                 target_transform=None, download=False):
        split = verify_str_arg(split, "split", ("train", "val"))
        base = os.path.join(os.path.expanduser(root), "imagenette2")
        if download and not os.path.exists(base):
            download_and_extract_archive(self._URL, root)
        if not os.path.exists(base):
            raise RuntimeError("Dataset not found; use download=True")
        super().__init__(
            os.path.join(base, split), transform=transform,
            target_transform=target_transform,
        )


class RenderedSST2(ImageFolder):
    """reference ``rendered_sst2.py``."""

    _URL = "https://openaipublic.azureedge.net/clip/data/rendered-sst2.tgz"

    def __init__(self, root, split="train", transform=None,
                 target_transform=None, download=False):
        split = verify_str_arg(split, "split", ("train", "valid", "test"))
        base = os.path.join(os.path.expanduser(root), "rendered-sst2")
        if download and not os.path.exists(base):
            download_and_extract_archive(self._URL, root)
        if not os.path.exists(base):
            raise RuntimeError("Dataset not found; use download=True")
        super().__init__(
            os.path.join(base, split), transform=transform,
            target_transform=target_transform,
        )


class SUN397(_ListDataset):
    """reference ``sun397.py``: ClassName.txt hierarchy."""

    _URL = "http://vision.princeton.edu/projects/2010/SUN/SUN397.tar.gz"

    def __init__(self, root, transform=None, target_transform=None,
                 download=False):
        super().__init__(root, transform, target_transform)
        base = pathlib.Path(self.root) / "SUN397"
        if download and not base.exists():
            download_and_extract_archive(self._URL, self.root)
        if not base.exists():
            raise RuntimeError("Dataset not found; use download=True")
        with open(base / "ClassName.txt") as f:
            self.classes = [c.strip() for c in f if c.strip()]
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self._samples = [
            (str(p), self.class_to_idx["/" + str(p.relative_to(base).parent)])
            for c in self.classes
            for p in sorted((base / c[1:]).rglob("*.jpg"))
        ]


class Caltech101(_ListDataset):
    """reference ``caltech.py`` Caltech101 (category targets)."""

    def __init__(self, root, transform=None, target_transform=None,
                 download=False):
        super().__init__(root, transform, target_transform)
        base = pathlib.Path(self.root) / "caltech101" / "101_ObjectCategories"
        if not base.exists():
            raise RuntimeError(
                "Dataset not found (Caltech101 requires manual download)"
            )
        self.categories = sorted(
            d.name for d in base.iterdir()
            if d.is_dir() and d.name != "BACKGROUND_Google"
        )
        self.class_to_idx = {c: i for i, c in enumerate(self.categories)}
        self._samples = [
            (str(p), self.class_to_idx[c])
            for c in self.categories
            for p in sorted((base / c).glob("*.jpg"))
        ]


class Caltech256(_ListDataset):
    """reference ``caltech.py`` Caltech256."""

    def __init__(self, root, transform=None, target_transform=None,
                 download=False):
        super().__init__(root, transform, target_transform)
        base = pathlib.Path(self.root) / "caltech256" / "256_ObjectCategories"
        if not base.exists():
            raise RuntimeError(
                "Dataset not found (Caltech256 requires manual download)"
            )
        self.categories = sorted(d.name for d in base.iterdir() if d.is_dir())
        self._samples = [
            (str(p), int(c.split(".")[0]) - 1)
            for c in self.categories
            for p in sorted((base / c).glob("*.jpg"))
        ]


class USPS(VisionDataset):
    """reference ``usps.py``: bzip2'd libsvm-format digits."""

    _files = {
        "train": (
            "https://www.csie.ntu.edu.tw/~cjlin/libsvmtools/datasets/multiclass/usps.bz2",
            "usps.bz2",
        ),
        "test": (
            "https://www.csie.ntu.edu.tw/~cjlin/libsvmtools/datasets/multiclass/usps.t.bz2",
            "usps.t.bz2",
        ),
    }

    def __init__(self, root, train=True, transform=None,
                 target_transform=None, download=False):
        super().__init__(root, transform=transform, target_transform=target_transform)
        url, fname = self._files["train" if train else "test"]
        path = os.path.join(self.root, fname)
        if download and not os.path.exists(path):
            download_url(url, self.root, fname)
        if not os.path.exists(path):
            raise RuntimeError("Dataset not found; use download=True")
        import bz2

        with bz2.open(path) as f:
            raw = [line.decode().split() for line in f]
        imgs = np.asarray(
            [[float(v.split(":")[-1]) for v in row[1:]] for row in raw],
            np.float32,
        )
        self.data = _chw(
            ((imgs + 1) / 2 * 255).round().astype(np.uint8).reshape(-1, 16, 16, 1))
        self.targets = [int(row[0]) - 1 for row in raw]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        img, target = self.data[idx], self.targets[idx]
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target


class SEMEION(VisionDataset):
    """reference ``semeion.py``: whitespace digits file."""

    _URL = "http://archive.ics.uci.edu/ml/machine-learning-databases/semeion/semeion.data"

    def __init__(self, root, transform=None, target_transform=None,
                 download=False):
        super().__init__(root, transform=transform, target_transform=target_transform)
        path = os.path.join(self.root, "semeion.data")
        if download and not os.path.exists(path):
            download_url(self._URL, self.root)
        if not os.path.exists(path):
            raise RuntimeError("Dataset not found; use download=True")
        raw = np.loadtxt(path)
        self.data = _chw((raw[:, :256] * 255).astype(np.uint8).reshape(-1, 16, 16, 1))
        self.labels = np.nonzero(raw[:, 256:])[1]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        img, target = self.data[idx], int(self.labels[idx])
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target
