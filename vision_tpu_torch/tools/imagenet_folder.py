"""An ImageNet-layout tree of image files, and the two lanes that read it
on the card. Shared by ``chip_smoke.py`` (phases ``image_io`` and
``imagenet_folder``) and the CPU tests.

    root/train/<wnid>/<wnid>_<k>.JPEG   mostly the port's baseline encodes
                                        at ImageNet's sizes, and copies of
                                        the progressive, EXIF-rotated and
                                        CMYK fixtures
    root/val/<wnid>/...                 the same kinds, and PNGs

The fixtures are the committed files of ``tests/torch_io_data`` (made with
Pillow, which the card's machine does not have).

* the device lane: ``ImageFolder(...).samples`` -> ``DeviceJpegLoader``
  (entropy decode on host threads, the rest of the decode, the crop, the
  flip and the normalisation on the card) -> the model;
* the host lane: ``ImageFolder`` (``read_image`` on the CPU, every format
  the port reads) + a transform -> ``DataLoader`` on threads -> the card.
"""

from __future__ import annotations

import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from vision_tpu_torch.io.image import encode_jpeg

__all__ = [
    "BASELINE_SIZES",
    "FIXTURES",
    "TRAIN_FIXTURES",
    "VAL_FIXTURES",
    "baseline_jpegs",
    "host_ms",
    "photo",
    "write_tree",
]

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "torch_io_data"
# (H, W): ImageNet's common shapes, 500x375, 375x500, 500x333, 640x427,
# 333x500 as width x height
BASELINE_SIZES = ((375, 500), (500, 375), (333, 500), (427, 640), (500, 333))
# the fixtures each class of train/ holds one copy of
TRAIN_FIXTURES = ("prog_420.jpg", "prog_444.jpg", "prog_grey.jpg",
                  "prog_restart.jpg", "exif_rot6.jpg", "cmyk.jpg")
# the fixtures of val/: each class one progressive stream, one CMYK and
# two PNGs, the PNG kinds in turn
VAL_FIXTURES = ("prog_optimize.jpg", "cmyk.jpg")
VAL_PNGS = ("rgb.png", "rgba.png", "grey_alpha.png", "palette_trns.png",
            "bit1.png", "grey16.png", "rgb16.png", "adam7.png")


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """A photograph-like HWC uint8 image (smooth structure, some noise)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 128 + 60 * np.sin(xx / (13 + seed % 7)) * np.cos(yy / (19 + seed % 5))
    img = base[..., None] + np.linspace(-20, 20, 3) + rng.randn(h, w, 3) * 12
    return np.clip(img, 0, 255).astype(np.uint8)


def baseline_jpegs(sizes: Sequence[Tuple[int, int]] = BASELINE_SIZES,
                   variants: int = 4, quality: int = 85) -> List[bytes]:
    """``variants`` baseline JPEGs of each size, by the port's encoder."""
    out = []
    for i, (h, w) in enumerate(sizes):
        for v in range(variants):
            img = torch.from_numpy(photo(h, w, seed=7 * i + v))
            out.append(encode_jpeg(img.permute(2, 0, 1), quality))
    return out


def write_tree(root, classes: int = 8, train_per_class: int = 40,
               val_per_class: int = 16,
               sizes: Sequence[Tuple[int, int]] = BASELINE_SIZES,
               fixtures: Path = FIXTURES) -> Dict[str, Dict[str, int]]:
    """Write ``root/train`` and ``root/val``; returns the files of each
    split by kind (``baseline``, ``progressive``, ``exif``, ``cmyk``,
    ``png``) and in all."""
    root = Path(root)
    pool = baseline_jpegs(sizes)
    fixture = {p.name: p for p in Path(fixtures).iterdir()}
    kinds = {"train": dict.fromkeys(("baseline", "progressive", "exif", "cmyk", "png"), 0)}
    kinds["val"] = dict(kinds["train"])

    def kind_of(name: str) -> str:
        if name.endswith(".png"):
            return "png"
        return {"exif_rot6.jpg": "exif", "cmyk.jpg": "cmyk"}.get(name, "progressive")

    k_base = 0
    for split, per_class in (("train", train_per_class), ("val", val_per_class)):
        for c in range(classes):
            wnid = f"n{1440764 + 1000 * c:08d}"
            folder = root / split / wnid
            folder.mkdir(parents=True, exist_ok=True)
            names = list(TRAIN_FIXTURES if split == "train" else VAL_FIXTURES)
            if split == "val":
                names += [VAL_PNGS[(2 * c + j) % len(VAL_PNGS)] for j in range(2)]
            names = names[:per_class]
            for j, name in enumerate(names):
                ext = ".png" if name.endswith(".png") else ".JPEG"
                shutil.copyfile(fixture[name], folder / f"{wnid}_{j:05d}{ext}")
                kinds[split][kind_of(name)] += 1
            for j in range(len(names), per_class):
                (folder / f"{wnid}_{j:05d}.JPEG").write_bytes(pool[k_base % len(pool)])
                k_base += 1
                kinds[split]["baseline"] += 1
    for split in kinds:
        kinds[split]["files"] = sum(kinds[split].values())
    return kinds


def host_ms(fn: Callable[[bytes], object], streams: Sequence[bytes],
            threads: int = 1, reps: int = 3) -> float:
    """Host milliseconds an image of ``fn`` over ``streams`` on ``threads``
    threads: wall time over the images, each thread given four of them at
    least (``streams`` repeated), the best of ``reps`` runs."""
    work = list(streams) * -(-4 * threads // len(streams))
    best = float("inf")
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(fn, work[:threads]))  # warm each thread's scratch
        for _ in range(reps):
            t0 = time.perf_counter()
            list(pool.map(fn, work))
            best = min(best, (time.perf_counter() - t0) * 1e3 / len(work))
    return best
