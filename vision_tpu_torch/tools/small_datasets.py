"""On-disk trees of the small classification datasets, written from seeded
arrays in each dataset's own layout, and the WebP folder: shared by
``chip_smoke.py`` (phases ``webp_folder_eval``, ``cifar_train`` and
``small_datasets``) and the CPU tests.

    python -m vision_tpu_torch.tools.small_datasets ROOT   # every tree

* :func:`write_cifar10`: ``cifar-10-batches-py`` at the published size by
  default (five training batches of 10,000 images, ``test_batch``,
  ``batches.meta``; ~180 MB), pickled as the archive's dicts, each image
  its class's colour over seeded noise so that a trainer can learn it;
* :func:`write_all`: a few samples for each of the other 23 datasets,
  files through the port's own JPEG and PNG encoders, and the
  constructors that read them (:data:`READERS`);
* :func:`write_webp_folder`: an ``ImageFolder`` tree mixing the committed
  WebP fixtures of ``tests/torch_io_data`` (the port has no WebP encoder)
  with JPEG and PNG files.

The trees' digests are not the archives': a reader whose class checks
digests (CIFAR) is given the tree's own (:func:`cifar10_class`).
"""

from __future__ import annotations

import bz2
import hashlib
import pickle
import shutil
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vision_tpu_torch.io.image import encode_jpeg, encode_png
from vision_tpu_torch.tools.imagenet_folder import FIXTURES, photo

__all__ = [
    "CIFAR10_CLASSES",
    "IMAGE_HW",
    "READERS",
    "cifar10_class",
    "cifar_images",
    "make_dataset",
    "write_all",
    "write_cifar10",
    "write_cifar100",
    "write_webp_folder",
]

CIFAR10_CLASSES = ["airplane", "automobile", "bird", "cat", "deer", "dog",
                   "frog", "horse", "ship", "truck"]
IMAGE_HW = (40, 52)  # every image file of write_all: one batch a dataset
PER_DATASET = 4


def _md5(path: Path) -> str:
    return hashlib.md5(path.read_bytes(), usedforsecurity=False).hexdigest()


def cifar_images(n: int, num_classes: int, seed: int) -> Tuple[np.ndarray, List[int]]:
    """``n`` rows of 3,072 bytes (R, G, B planes of 32x32, the archive's
    layout) and their labels: each image its class's colour plus seeded
    noise of +-48 levels."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n)
    colours = np.random.RandomState(1000 + num_classes).randint(48, 208, (num_classes, 3))
    rows = rng.randint(0, 97, (n, 3, 1024), dtype=np.int16)
    rows += (colours[labels] - 48).astype(np.int16)[:, :, None]
    return rows.astype(np.uint8).reshape(n, 3072), labels.tolist()


def write_cifar10(root, per_batch: int = 10_000, test: int = 10_000,
                  seed: int = 0) -> Dict[str, List[List[str]]]:
    """``root/cifar-10-batches-py``: ``data_batch_1..5`` of ``per_batch``
    images, ``test_batch`` of ``test``, ``batches.meta``. Returns the
    tree's ``train_list`` / ``test_list`` with their digests."""
    base = Path(root) / "cifar-10-batches-py"
    base.mkdir(parents=True, exist_ok=True)
    lists: Dict[str, List[List[str]]] = {"train_list": [], "test_list": []}
    files = [(f"data_batch_{k}", per_batch, f"training batch {k} of 5", "train_list")
             for k in range(1, 6)] + [("test_batch", test, "testing batch 1 of 1", "test_list")]
    for k, (name, n, label, which) in enumerate(files):
        data, labels = cifar_images(n, 10, seed + k)
        entry = {"batch_label": label, "labels": labels, "data": data,
                 "filenames": [f"seeded_{seed}_{k}_{i}.png" for i in range(n)]}
        with open(base / name, "wb") as f:
            pickle.dump(entry, f, protocol=2)
        lists[which].append([name, _md5(base / name)])
    with open(base / "batches.meta", "wb") as f:
        pickle.dump({"num_cases_per_batch": per_batch, "label_names": CIFAR10_CLASSES,
                     "num_vis": 3072}, f, protocol=2)
    return lists


def write_cifar100(root, train: int = PER_DATASET, test: int = PER_DATASET,
                   seed: int = 0) -> Dict[str, List[List[str]]]:
    """``root/cifar-100-python``: ``train``, ``test`` (fine and coarse
    labels) and ``meta``."""
    base = Path(root) / "cifar-100-python"
    base.mkdir(parents=True, exist_ok=True)
    lists: Dict[str, List[List[str]]] = {"train_list": [], "test_list": []}
    for k, (name, n, which) in enumerate((("train", train, "train_list"),
                                          ("test", test, "test_list"))):
        data, fine = cifar_images(n, 100, seed + k)
        entry = {"batch_label": name, "fine_labels": fine,
                 "coarse_labels": [f // 5 for f in fine], "data": data,
                 "filenames": [f"seeded_{i}.png" for i in range(n)]}
        with open(base / name, "wb") as f:
            pickle.dump(entry, f, protocol=2)
        lists[which].append([name, _md5(base / name)])
    with open(base / "meta", "wb") as f:
        pickle.dump({"fine_label_names": [f"fine_{i}" for i in range(100)],
                     "coarse_label_names": [f"coarse_{i}" for i in range(20)]}, f, protocol=2)
    return lists


def cifar10_class(lists: Dict[str, List[List[str]]], base=None):
    """A reader of ``base`` (the port's ``CIFAR10`` by default) whose digest
    lists are a written tree's: its integrity check then runs as it is."""
    if base is None:
        from vision_tpu_torch.datasets import CIFAR10 as base
    return type(f"Seeded{base.__name__}", (base,), {
        "train_list": lists["train_list"], "test_list": lists["test_list"]})


# ------------------------------------------------------------- files

def _jpg(path: Path, seed: int, hw: Tuple[int, int] = IMAGE_HW) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    img = torch.from_numpy(photo(*hw, seed=seed)).permute(2, 0, 1)
    path.write_bytes(encode_jpeg(img, 90))


def _png(path: Path, seed: int, hw: Tuple[int, int] = IMAGE_HW) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    img = torch.from_numpy(photo(*hw, seed=seed)).permute(2, 0, 1)
    path.write_bytes(encode_png(img))


def _write_idx(path: Path, arr: np.ndarray) -> None:
    """An IDX file (uint8 or int32), big-endian."""
    path.parent.mkdir(parents=True, exist_ok=True)
    ty = {np.uint8: 8, np.int32: 12}[arr.dtype.type]
    head = (ty * 256 + arr.ndim).to_bytes(4, "big")
    head += b"".join(s.to_bytes(4, "big") for s in arr.shape)
    path.write_bytes(head + arr.astype(arr.dtype.newbyteorder(">")).tobytes())


def _digits(rng, n: int, hw=(28, 28)) -> np.ndarray:
    return rng.randint(0, 256, (n, *hw)).astype(np.uint8)


def _mnist_like(root: Path, folder: str, rng) -> None:
    raw = root / folder / "raw"
    for split in ("train", "t10k"):
        _write_idx(raw / f"{split}-images-idx3-ubyte", _digits(rng, PER_DATASET))
        _write_idx(raw / f"{split}-labels-idx1-ubyte",
                   rng.randint(0, 10, PER_DATASET).astype(np.uint8))


def _class_folders(base: Path, classes, seed: int, per_class: int = 2) -> None:
    for c, cls in enumerate(classes):
        for i in range(per_class):
            _jpg(base / cls / f"{cls}_{i}.jpg", seed + 10 * c + i)


def write_all(root, seed: int = 0) -> Dict[str, dict]:
    """Every tree but CIFAR-10's full one, ``PER_DATASET`` samples or so
    each; returns ``{name: constructor kwargs}`` (:data:`READERS` names the
    class of each)."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    out: Dict[str, dict] = {}

    lists = write_cifar100(root, seed=seed)
    out["CIFAR100"] = {"train": True, "_lists": lists}
    for name in ("MNIST", "FashionMNIST", "KMNIST"):
        _mnist_like(root, name, rng)
        out[name] = {"train": True}
    for suffix in ("train", "test"):
        _write_idx(root / "EMNIST" / "raw" / f"emnist-letters-{suffix}-images-idx3-ubyte",
                   _digits(rng, PER_DATASET))
        _write_idx(root / "EMNIST" / "raw" / f"emnist-letters-{suffix}-labels-idx1-ubyte",
                   rng.randint(1, 27, PER_DATASET).astype(np.uint8))
    out["EMNIST"] = {"split": "letters", "train": True}
    _write_idx(root / "QMNIST" / "raw" / "qmnist-test-images-idx3-ubyte",
               _digits(rng, PER_DATASET))
    _write_idx(root / "QMNIST" / "raw" / "qmnist-test-labels-idx2-int",
               rng.randint(0, 10, (PER_DATASET, 8)).astype(np.int32))
    out["QMNIST"] = {"what": "test"}

    # DTD: images/<class>/*.jpg, labels/{split}{partition}.txt
    names = []
    for c, cls in enumerate(("banded", "woven")):
        for i in range(2):
            _jpg(root / "dtd" / "images" / cls / f"{cls}_{i:04d}.jpg", seed + 100 + 2 * c + i)
            names.append(f"{cls}/{cls}_{i:04d}.jpg")
    (root / "dtd" / "labels").mkdir(parents=True, exist_ok=True)
    (root / "dtd" / "labels" / "train1.txt").write_text("\n".join(names) + "\n")
    out["DTD"] = {"split": "train", "partition": 1}

    # Flowers102: jpg/image_%05d.jpg, imagelabels.mat, setid.mat
    import scipy.io as sio

    base = root / "flowers-102"
    for i in range(1, 7):
        _jpg(base / "jpg" / f"image_{i:05d}.jpg", seed + 200 + i)
    sio.savemat(base / "imagelabels.mat", {"labels": np.array([[5, 1, 102, 7, 7, 3]])})
    sio.savemat(base / "setid.mat", {"trnid": np.array([[1, 3, 5, 6]]),
                                     "valid": np.array([[2]]), "tstid": np.array([[4]])})
    out["Flowers102"] = {"split": "train"}

    # Food101: images/<class>/<id>.jpg, meta/{split}.txt
    base = root / "food-101"
    ids = []
    for c, cls in enumerate(("pizza", "sushi")):
        for i in range(2):
            _jpg(base / "images" / cls / f"{100 + i}.jpg", seed + 300 + 2 * c + i)
            ids.append(f"{cls}/{100 + i}")
    (base / "meta").mkdir(parents=True, exist_ok=True)
    (base / "meta" / "train.txt").write_text("\n".join(ids) + "\n")
    out["Food101"] = {"split": "train"}

    # GTSRB: train folders of integer class ids (PNG: no PPM reader), and
    # the test CSV
    base = root / "gtsrb"
    for c in (0, 7):
        for i in range(2):
            _png(base / "GTSRB" / "Training" / f"{c:05d}" / f"00000_{i:05d}.png",
                 seed + 400 + c + i)
    out["GTSRB"] = {"split": "train"}

    # EuroSAT, Country211, Imagenette, RenderedSST2: ImageFolders
    _class_folders(root / "eurosat" / "2750", ("Forest", "River"), seed + 500)
    out["EuroSAT"] = {}
    _class_folders(root / "country211" / "train", ("AD", "ZW"), seed + 520)
    out["Country211"] = {"split": "train"}
    _class_folders(root / "imagenette2" / "train", ("n01440764", "n02102040"), seed + 540)
    out["Imagenette"] = {"split": "train"}
    _class_folders(root / "rendered-sst2" / "train", ("negative", "positive"), seed + 560)
    out["RenderedSST2"] = {"split": "train"}

    # STL10: train_X.bin (N, 3, 96, 96) column-major planes, train_y.bin 1-based
    base = root / "stl10_binary"
    base.mkdir(parents=True, exist_ok=True)
    rng.randint(0, 256, (PER_DATASET, 3, 96, 96)).astype(np.uint8).tofile(base / "train_X.bin")
    rng.randint(1, 11, PER_DATASET).astype(np.uint8).tofile(base / "train_y.bin")
    out["STL10"] = {"split": "train"}

    # SVHN: train_32x32.mat, X (32, 32, 3, N), y in 1..10 (10: the digit 0)
    sio.savemat(root / "train_32x32.mat", {
        "X": rng.randint(0, 256, (32, 32, 3, PER_DATASET)).astype(np.uint8),
        "y": np.array([[10], [1], [5], [9]], np.uint8)})
    out["SVHN"] = {"split": "train"}

    # OxfordIIITPet: images/*.jpg, annotations/trainval.txt and trimaps/*.png
    base = root / "oxford-iiit-pet"
    rows = [("Abyssinian_1", 1, 1, 1), ("Bengal_2", 6, 1, 6),
            ("yorkshire_terrier_3", 37, 2, 25), ("pug_4", 27, 2, 20)]
    for k, (stem, *_rest) in enumerate(rows):
        _jpg(base / "images" / f"{stem}.jpg", seed + 600 + k)
        trimap = torch.from_numpy(rng.randint(1, 4, (1, *IMAGE_HW)).astype(np.uint8))
        (base / "annotations" / "trimaps").mkdir(parents=True, exist_ok=True)
        (base / "annotations" / "trimaps" / f"{stem}.png").write_bytes(encode_png(trimap))
    (base / "annotations" / "trainval.txt").write_text(
        "".join(" ".join(map(str, r)) + "\n" for r in rows))
    out["OxfordIIITPet"] = {"split": "trainval", "target_types": ["category", "segmentation"]}

    # FGVCAircraft: data/images/<id>.jpg, variants.txt, images_variant_<split>.txt
    data = root / "fgvc-aircraft-2013b" / "data"
    variants = ["707-320", "A300B4", "Boeing 717"]
    lines = []
    for k in range(PER_DATASET):
        img_id = f"{34309 + k:07d}"
        _jpg(data / "images" / f"{img_id}.jpg", seed + 700 + k)
        lines.append(f"{img_id} {variants[k % 3]}")
    (data / "variants.txt").write_text("\n".join(variants) + "\n")
    (data / "images_variant_trainval.txt").write_text("\n".join(lines) + "\n")
    out["FGVCAircraft"] = {"split": "trainval"}

    # SUN397: ClassName.txt, <letter>/<class>/*.jpg
    base = root / "SUN397"
    classes = ["/a/abbey", "/a/airplane_cabin", "/b/beach"]
    base.mkdir(parents=True, exist_ok=True)
    (base / "ClassName.txt").write_text("\n".join(classes) + "\n")
    for c, cls in enumerate(classes):
        _jpg(base / cls[1:] / f"sun_{c:04d}.jpg", seed + 800 + c)
    out["SUN397"] = {}

    # Caltech101 (BACKGROUND_Google left out) and Caltech256
    for c, cls in enumerate(("BACKGROUND_Google", "accordion", "watch")):
        for i in range(2):
            _jpg(root / "caltech101" / "101_ObjectCategories" / cls / f"image_{i + 1:04d}.jpg",
                 seed + 900 + 2 * c + i)
    out["Caltech101"] = {}
    for c, cls in enumerate(("001.ak47", "257.clutter")):
        for i in range(2):
            _jpg(root / "caltech256" / "256_ObjectCategories" / cls
                 / f"{cls.split('.')[0]}_{i + 1:04d}.jpg", seed + 950 + 2 * c + i)
    out["Caltech256"] = {}

    # USPS: bzip2'd libsvm rows "label 1:v ... 256:v", v in [-1, 1]
    lines = []
    for k in range(PER_DATASET):
        vals = rng.uniform(-1, 1, 256)
        lines.append(f"{k % 10 + 1} " + " ".join(f"{i + 1}:{v:.6f}" for i, v in enumerate(vals)))
    with bz2.open(root / "usps.bz2", "wt") as f:
        f.write("\n".join(lines) + "\n")
    out["USPS"] = {"train": True}

    # SEMEION: 256 binary pixels and a one-hot digit a row
    pix = rng.randint(0, 2, (PER_DATASET, 256))
    onehot = np.zeros((PER_DATASET, 10))
    onehot[np.arange(PER_DATASET), rng.randint(0, 10, PER_DATASET)] = 1
    np.savetxt(root / "semeion.data", np.hstack([pix, onehot]), fmt="%.4f")
    out["SEMEION"] = {}

    out["FakeData"] = {"size": PER_DATASET, "image_size": (*IMAGE_HW, 3),
                       "random_offset": seed}
    return out


# the datasets of write_all, with whether a sample's image is RGB (the
# others are grey or one-channel)
READERS: Dict[str, bool] = {
    "CIFAR100": True, "MNIST": False, "FashionMNIST": False, "KMNIST": False,
    "EMNIST": False, "QMNIST": False, "DTD": True, "Flowers102": True,
    "Food101": True, "GTSRB": True, "EuroSAT": True, "Country211": True,
    "Imagenette": True, "RenderedSST2": True, "STL10": True, "SVHN": True,
    "OxfordIIITPet": True, "FGVCAircraft": True, "SUN397": True,
    "Caltech101": True, "Caltech256": True, "USPS": False, "SEMEION": False,
    "FakeData": True,
}


def make_dataset(module, name: str, root, kwargs: dict):
    """The dataset ``name`` of ``module`` (the port's
    ``vision_tpu_torch.datasets`` or ``vision_tpu.datasets``) over a tree
    of :func:`write_all`; a class that checks digests gets the tree's."""
    kwargs = dict(kwargs)
    lists = kwargs.pop("_lists", None)
    cls = getattr(module, name)
    if lists is not None:
        cls = cifar10_class(lists, cls)
    if name == "FakeData":
        return cls(**kwargs)
    return cls(str(root), **kwargs)


# --------------------------------------------------------- WebP folder

def write_webp_folder(root, fixtures: Path = FIXTURES, classes: int = 4,
                      per_class: int = 8, seed: int = 0) -> Dict[str, int]:
    """``root/<class>/*``: the committed WebP fixtures (lossy, lossless,
    alpha, extended, animated) spread over the classes, and the port's
    baseline JPEGs and PNGs of a few sizes for the rest; returns the files
    by kind."""
    root = Path(root)
    webps = sorted(p for p in Path(fixtures).iterdir() if p.suffix == ".webp")
    kinds = {"webp": 0, "jpeg": 0, "png": 0}
    k = 0
    for c in range(classes):
        folder = root / f"class_{c}"
        folder.mkdir(parents=True, exist_ok=True)
        for i in range(per_class):
            if k < len(webps):
                shutil.copyfile(webps[k], folder / f"{i:03d}_{webps[k].name}")
                kinds["webp"] += 1
            elif k % 2:
                _jpg(folder / f"{i:03d}.jpg", seed + k, (90 + 7 * k, 120))
                kinds["jpeg"] += 1
            else:
                _png(folder / f"{i:03d}.png", seed + k, (100, 80 + 5 * k))
                kinds["png"] += 1
            k += 1
    return kinds


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m vision_tpu_torch.tools.small_datasets ROOT")
        return 2
    root = Path(argv[0])
    write_cifar10(root)
    write_all(root)
    write_webp_folder(root / "webp_folder")
    print(f"wrote {sum(1 for _ in root.rglob('*'))} entries under {root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
