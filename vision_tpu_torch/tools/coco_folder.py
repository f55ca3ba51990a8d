"""A COCO-layout and a VOC-layout tree of files, written from a seed with
the port's own encoders. Shared by ``chip_smoke.py`` (phases
``coco_folder_*`` and ``voc_folder_*``) and the CPU tests.

    root/train2017/<id>.jpg, root/val2017/<id>.jpg
    root/annotations/instances_{train,val}2017.json
        COCO's image sizes, ~7 objects an image on COCO's non-contiguous
        category ids (1-90, 80 of them), polygons of 1-3 parts and 8-60
        vertices, about one image in ten with a crowd object in compressed
        RLE, and two training images without annotations (which
        ``get_coco`` drops)
    root/VOCdevkit/VOC2012/{JPEGImages,SegmentationClass,Annotations}
    root/VOCdevkit/VOC2012/ImageSets/{Segmentation,Main}/{train,val}.txt
        VOC's image sizes, 1-4 objects an image of the 20 classes (4 in
        val, every class in five images), palette class masks (VOC's colour
        map) with 255 on each object's border

    python -m vision_tpu_torch.tools.coco_folder ROOT [--seed 0]
"""

from __future__ import annotations

import argparse
import functools
import json
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from vision_tpu_torch.io.image import encode_jpeg
from vision_tpu_torch.tools.imagenet_folder import photo

__all__ = ["COCO_CATEGORY_IDS", "COCO_SIZES", "VOC_CLASSES", "VOC_SIZES",
           "encode_palette_png", "encode_rle", "voc_palette", "write_coco_tree",
           "write_voc_tree"]

# (H, W): 640x480, 640x427, 480x640, 427x640, 640x360, 500x375 as W x H
COCO_SIZES = ((480, 640), (427, 640), (640, 480), (640, 427), (360, 640),
              (375, 500))
COCO_CATEGORY_IDS = tuple(i for i in range(1, 91) if i not in (
    12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
VOC_SIZES = ((375, 500), (500, 375), (333, 500), (500, 333), (375, 500),
             (281, 500))
VOC_CLASSES = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor")


@functools.lru_cache(maxsize=16)
def _base(h: int, w: int) -> np.ndarray:
    return photo(h, w, seed=7 * h + w)


def _image(h: int, w: int, rng: np.random.RandomState) -> np.ndarray:
    """A photograph-like image: the size's base photo, rolled and tinted
    (one ``photo`` a size, since it takes ~0.1 s at COCO's sizes)."""
    img = np.roll(_base(h, w), (rng.randint(h), rng.randint(w)), (0, 1))
    lut = np.clip(np.arange(256)[:, None] + rng.randint(-40, 41, 3), 0, 255)
    return lut.astype(np.uint8)[img, np.arange(3)]


def _write_jpegs(jobs) -> None:
    """Encode and write ``(path, HWC image)`` pairs on threads (the
    encoder releases the interpreter lock)."""
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: job[0].write_bytes(_jpeg(job[1])), jobs))


def _jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    return encode_jpeg(torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1),
                       quality)


def encode_rle(mask: np.ndarray) -> dict:
    """COCO's compressed RLE of an ``(h, w)`` 0/1 mask (``pycocotools``'
    ``rleToString``): column-major runs from a run of zeros, each from the
    third on a delta from the run two before, in 5-bit groups."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    edges = np.concatenate([[0], np.flatnonzero(np.diff(flat)) + 1, [flat.size]])
    runs = np.diff(edges).tolist()
    if flat.size and flat[0]:
        runs = [0] + runs
    out = []
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return {"size": [h, w], "counts": "".join(out)}


def voc_palette() -> bytes:
    """VOC's colour map: index i's bits spread over R, G, B, high bit
    first."""
    out = []
    for i in range(256):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= (c & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        out += [r, g, b]
    return bytes(out)


def encode_palette_png(indices: np.ndarray, palette: bytes) -> bytes:
    """An 8-bit palette PNG of ``(H, W)`` uint8 indices, unfiltered rows."""
    h, w = indices.shape
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = indices

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", palette)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def _polygon(rng: np.random.RandomState, cx: float, cy: float, r: float,
             h: int, w: int) -> List[float]:
    """A star-shaped part of 8-60 vertices around (cx, cy), COCO's two
    decimals, inside the image."""
    n = rng.randint(8, 61)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = r * rng.uniform(0.6, 1.0, n)
    xs = np.clip(cx + rad * np.cos(ang), 0, w - 0.01)
    ys = np.clip(cy + rad * np.sin(ang), 0, h - 0.01)
    return np.stack([xs, ys], 1).reshape(-1).round(2).tolist()


def _shoelace(poly: Sequence[float]) -> float:
    x, y = np.asarray(poly[0::2]), np.asarray(poly[1::2])
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2)


def _objects(rng, img_id: int, h: int, w: int, next_id: int,
             crowd: bool) -> List[dict]:
    anns = []
    for _ in range(int(np.clip(rng.poisson(7.3), 1, 20))):
        r = rng.uniform(10, min(h, w) / 5)
        cx, cy = rng.uniform(r, w - r), rng.uniform(r, h - r)
        parts = [_polygon(rng, cx + rng.uniform(-r, r) * (k > 0),
                          cy + rng.uniform(-r, r) * (k > 0),
                          r / (1 + k), h, w) for k in range(rng.randint(1, 4))]
        xs = np.concatenate([p[0::2] for p in parts])
        ys = np.concatenate([p[1::2] for p in parts])
        x0, y0 = float(xs.min()), float(ys.min())
        anns.append({"id": next_id + len(anns), "image_id": img_id,
                     "category_id": int(rng.choice(COCO_CATEGORY_IDS)),
                     "segmentation": parts, "iscrowd": 0,
                     "area": round(sum(_shoelace(p) for p in parts), 2),
                     "bbox": [round(x0, 2), round(y0, 2),
                              round(float(xs.max()) - x0, 2),
                              round(float(ys.max()) - y0, 2)]})
    if crowd:
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        bh, bw = rng.randint(h // 6, h // 2), rng.randint(w // 6, w // 2)
        yy, xx = np.mgrid[:h, :w]
        m = (((yy - y0 - bh / 2) / (bh / 2)) ** 2
             + ((xx - x0 - bw / 2) / (bw / 2)) ** 2 <= 1).astype(np.uint8)
        ys, xs = np.nonzero(m)
        anns.append({"id": next_id + len(anns), "image_id": img_id,
                     "category_id": int(rng.choice(COCO_CATEGORY_IDS)),
                     "segmentation": encode_rle(m), "iscrowd": 1,
                     "area": float(m.sum()),
                     "bbox": [float(xs.min()), float(ys.min()),
                              float(xs.max() - xs.min() + 1),
                              float(ys.max() - ys.min() + 1)]})
    return anns


def write_coco_tree(root, train: int = 64, val: int = 32, seed: int = 0,
                    sizes: Sequence[Tuple[int, int]] = COCO_SIZES,
                    empty: Sequence[int] = (5, 17)) -> Dict[str, dict]:
    """Write the COCO tree under ``root``; ``empty``: the training images
    left without annotations. Returns each split's ``images``,
    ``annotations``, ``crowd`` and ``empty`` counts."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    cats = [{"id": c, "name": f"category_{c}", "supercategory": "thing"}
            for c in COCO_CATEGORY_IDS]
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    info, jobs = {}, []
    next_ann = 1
    for split, count in (("train", train), ("val", val)):
        folder = root / f"{split}2017"
        folder.mkdir(parents=True, exist_ok=True)
        images, anns = [], []
        for k in range(count):
            h, w = sizes[k % len(sizes)]
            img_id = (1 if split == "train" else 500_000) + 7 * k
            name = f"{img_id:012d}.jpg"
            jobs.append((folder / name, _image(h, w, rng)))
            images.append({"id": img_id, "file_name": name, "height": h,
                           "width": w})
            if split == "train" and k in empty:
                continue
            new = _objects(rng, img_id, h, w, next_ann, crowd=k % 10 == 3)
            next_ann += len(new)
            anns += new
        (root / "annotations" / f"instances_{split}2017.json").write_text(
            json.dumps({"images": images, "annotations": anns,
                        "categories": cats}))
        info[split] = {"images": count, "annotations": len(anns),
                       "crowd": sum(a["iscrowd"] for a in anns),
                       "empty": len(empty) if split == "train" else 0}
    _write_jpegs(jobs)
    return info


def _voc_xml(name: str, h: int, w: int, objects) -> str:
    objs = "".join(
        f"<object><name>{VOC_CLASSES[c]}</name><pose>Unspecified</pose>"
        f"<truncated>0</truncated><difficult>0</difficult><bndbox>"
        f"<xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax>"
        f"</bndbox></object>" for c, (x0, y0, x1, y1) in objects)
    return (f"<annotation><folder>VOC2012</folder><filename>{name}.jpg</filename>"
            f"<size><width>{w}</width><height>{h}</height><depth>3</depth></size>"
            f"<segmented>1</segmented>{objs}</annotation>")


def write_voc_tree(root, train: int = 48, val: int = 16, seed: int = 0,
                   sizes: Sequence[Tuple[int, int]] = VOC_SIZES) -> Dict[str, dict]:
    """Write ``root/VOCdevkit/VOC2012``. Returns each split's ``images``
    and the classes its masks hold."""
    base = Path(root) / "VOCdevkit" / "VOC2012"
    dirs = {d: base / d for d in ("JPEGImages", "SegmentationClass", "Annotations")}
    for d in (*dirs.values(), base / "ImageSets" / "Segmentation",
              base / "ImageSets" / "Main"):
        d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed + 1)
    palette = voc_palette()
    pal = np.frombuffer(palette, np.uint8).reshape(256, 3).astype(np.float32)
    info, k_all, jobs = {}, 0, []
    for split, count in (("train", train), ("val", val)):
        names, classes = [], set()
        for k in range(count):
            h, w = sizes[k_all % len(sizes)]
            name = f"2012_{k_all:06d}"
            k_all += 1
            img = _image(h, w, rng).astype(np.float32)
            mask = np.zeros((h, w), np.uint8)
            objects = []
            # one object a quadrant at most, so that none hides another;
            # val's images four each, its classes in turn (five images hold
            # all twenty)
            quads = rng.permutation(4)[:4 if split == "val" else rng.randint(1, 5)]
            for j, q in enumerate(quads):
                c = (4 * k + j) % 20 + 1 if split == "val" else rng.randint(1, 21)
                ry, rx = rng.uniform(h / 12, h / 5), rng.uniform(w / 12, w / 5)
                cy = (q // 2) * h / 2 + rng.uniform(ry + 3, h / 2 - ry - 3)
                cx = (q % 2) * w / 2 + rng.uniform(rx + 3, w / 2 - rx - 3)
                y0, x0 = int(cy - ry - 3), int(cx - rx - 3)
                yy, xx = np.mgrid[y0:int(cy + ry + 4), x0:int(cx + rx + 4)]
                d = np.hypot((yy - cy) / ry, (xx - cx) / rx)
                inside = d <= 1
                border = (d > 1) & (d <= 1 + 2.5 / min(ry, rx))
                win = mask[y0:y0 + d.shape[0], x0:x0 + d.shape[1]]
                win[inside] = c
                win[border] = 255
                part = img[y0:y0 + d.shape[0], x0:x0 + d.shape[1]]
                part[inside] = 0.5 * part[inside] + 0.5 * pal[c]
                ys, xs = np.nonzero(inside)
                objects.append((c, (x0 + int(xs.min()) + 1, y0 + int(ys.min()) + 1,
                                    x0 + int(xs.max()) + 1, y0 + int(ys.max()) + 1)))
            classes.update(int(c) for c in np.unique(mask) if c != 255)
            jobs.append((dirs["JPEGImages"] / f"{name}.jpg",
                         np.clip(img, 0, 255).astype(np.uint8)))
            (dirs["SegmentationClass"] / f"{name}.png").write_bytes(
                encode_palette_png(mask, palette))
            (dirs["Annotations"] / f"{name}.xml").write_text(_voc_xml(name, h, w, objects))
            names.append(name)
        for sub in ("Segmentation", "Main"):
            (base / "ImageSets" / sub / f"{split}.txt").write_text(
                "\n".join(names) + "\n")
        info[split] = {"images": count, "classes": sorted(classes)}
    _write_jpegs(jobs)
    return info


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("root")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    print(json.dumps({"coco": write_coco_tree(args.root, seed=args.seed),
                      "voc": write_voc_tree(args.root, seed=args.seed)}))


if __name__ == "__main__":
    main()
