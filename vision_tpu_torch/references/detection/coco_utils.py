"""COCO plumbing of the detection recipe (the port's copy of the repo's
``references/detection/coco_utils.py``, whose reference wraps
``pycocotools``; the port has neither it nor PIL).

* ``decode_rle`` / ``convert_coco_poly_to_mask``: a segmentation (RLE,
  compressed or not, column-major; or a list of polygons) -> ``(N, H, W)``
  uint8 masks. Polygons are filled by ``fill_polygon``, the port's own
  scanline fill, which repeats Pillow's ``ImageDraw.polygon(outline=1,
  fill=1)``, the JAX package's rasteriser: vertices truncated to integers,
  f32 edge slopes and crossings, Pillow's rounding of each span's ends and
  its widening of corners that would leave a gap between rows.
* ``ConvertCocoPolysToMask``: an annotation list -> the training target
  (XYXY boxes clamped to the image, labels, masks, keypoints, area,
  iscrowd), crowd annotations and degenerate boxes dropped; torch tensors.
* ``coco_remove_images_without_annotations``, ``convert_to_coco_api``,
  ``get_coco_api_from_dataset``, ``get_coco``.

The masks are host work (numpy); a target's tensors are on the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

__all__ = [
    "ConvertCocoPolysToMask",
    "coco_remove_images_without_annotations",
    "convert_coco_poly_to_mask",
    "convert_to_coco_api",
    "decode_rle",
    "fill_polygon",
    "get_coco",
    "get_coco_api_from_dataset",
]

_F32 = np.float32


def _uncompress_rle_counts(counts: str) -> List[int]:
    """COCO's compressed RLE string -> run lengths: 5-bit groups with a
    continuation bit, sign-extended, each run from the third on a delta
    from the run two before."""
    out: List[int] = []
    pos = 0
    while pos < len(counts):
        x = k = 0
        more = True
        while more:
            c = ord(counts[pos]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            pos += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)
            k += 1
        if len(out) > 2:
            x += out[-2]
        out.append(x)
    return out


def decode_rle(rle: dict) -> np.ndarray:
    """``{"size": [h, w], "counts": str | bytes | list}`` -> ``(h, w)``
    uint8; the runs alternate 0 and 1 from 0, in column-major order."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    if isinstance(counts, str):
        counts = _uncompress_rle_counts(counts)
    runs = np.asarray(counts, np.int64)
    flat = np.repeat((np.arange(len(runs)) % 2).astype(np.uint8),
                     np.maximum(runs, 0))[:h * w]
    flat = np.concatenate([flat, np.zeros(h * w - len(flat), np.uint8)])
    return flat.reshape(w, h).T


def _round_up(x: np.ndarray) -> np.ndarray:
    """Pillow's ``ROUND_UP`` of f32 crossings: ``floor(x + 0.5f)`` in f32
    (half away from zero for negatives)."""
    pos = np.floor((x + _F32(0.5)).astype(_F32))
    neg = -np.floor(np.abs(x.astype(np.float64)) + 0.5)
    return np.where(x >= 0, pos, neg)


def _round_down(x: np.ndarray) -> np.ndarray:
    """Pillow's ``ROUND_DOWN``: ``ceil(x - 0.5f)``."""
    pos = np.ceil((x - _F32(0.5)).astype(_F32))
    neg = -np.ceil(np.abs(x.astype(np.float64)) - 0.5)
    return np.where(x >= 0, pos, neg)


def _roundf(x: float) -> float:
    return float(np.floor(x + 0.5)) if x >= 0 else -float(np.floor(-x + 0.5))


def _edges(v: List[int]) -> List[List[float]]:
    """Pillow's edge list of a closed polygon of integer vertices
    ``[x0, y0, x1, y1, ...]``: ``[xmin, xmax, ymin, ymax, x0, y0, dx]``
    each, a horizontal edge that continues one in the same direction
    merged into it, the closing edge added unless the path is closed."""
    n = len(v) // 2

    def edge(x0, y0, x1, y1):
        dx = 0.0 if y0 == y1 else float(_F32(x1 - x0) / _F32(y1 - y0))
        return [min(x0, x1), max(x0, x1), min(y0, y1), max(y0, y1), x0, y0, dx]

    out: List[List[float]] = []
    for i in range(n - 1):
        x0, y0, x1, y1 = v[2 * i:2 * i + 4]
        if y0 == y1 and i != 0 and y0 == v[2 * i - 1]:
            if x1 > x0 > v[2 * i - 2]:
                out[-1][1] = x1
                continue
            if x1 < x0 < v[2 * i - 2]:
                out[-1][0] = x1
                continue
        out.append(edge(x0, y0, x1, y1))
    if v[2 * n - 2] != v[0] or v[2 * n - 1] != v[1]:
        out.append(edge(v[2 * n - 2], v[2 * n - 1], v[0], v[1]))
    return out


def fill_polygon(mask: np.ndarray, xy: Sequence[float]) -> None:
    """Set to 1 the pixels of ``mask`` (``(H, W)`` uint8) that Pillow's
    ``ImageDraw.polygon(xy, outline=1, fill=1)`` draws, for ``xy`` =
    ``[x0, y0, x1, y1, ...]`` (3 vertices or more).

    Each row y between the polygon's extremes, clipped to the image
    (``ymax`` to its height), crosses each sloped edge that spans it at
    ``f32((y - y0) * dx) + x0``, twice at the edge's lower end when that
    is not the last row. A crossing at a whole number of a sloped edge
    that meets an earlier edge of the same slope sign there (a corner) is
    moved to one past the next row's crossings (the previous row's at the
    edge's lower end) where it lies more than one past both, so that the
    rows of a sharp corner touch. The sorted crossings pair up into spans
    ``[ROUND_UP(a), ROUND_DOWN(b)]``; horizontal edges are spans of their
    own. Vertices are truncated to integers first, as Pillow's C side
    casts them."""
    h, w = mask.shape
    v = [int(c) for c in xy]
    edges = _edges(v)
    if not edges:
        return
    e = np.asarray(edges, np.float64)
    ymin = int(min(h - 1, e[:, 2].min()))
    ymax = int(max(0, e[:, 3].max()))
    rows, lo, hi = [], [], []
    flat = e[:, 2] == e[:, 3]
    for xmin, xmax, y in e[flat][:, [0, 1, 2]].astype(np.int64):
        rows.append(np.array([y]))
        lo.append(np.array([xmin]))
        hi.append(np.array([xmax]))
    t = e[~flat]
    ymin, ymax = max(ymin, 0), min(ymax, h)
    if len(t) and ymin <= ymax:
        ys = np.arange(ymin, ymax + 1)
        t_ymin, t_ymax = t[:, 2].astype(np.int64), t[:, 3].astype(np.int64)
        x0, y0 = t[:, 4].astype(np.int64), t[:, 5].astype(np.int64)
        dx = t[:, 6].astype(_F32)

        def line_x(y, k):
            return _F32(_F32(y - y0[k]) * dx[k]) + _F32(x0[k])

        cross = (((ys[:, None] - y0[None]).astype(_F32) * dx[None]).astype(_F32)
                 + x0[None].astype(_F32)).astype(_F32)
        active = (ys[:, None] >= t_ymin[None]) & (ys[:, None] <= t_ymax[None])
        dup = active & (ys[:, None] == t_ymax[None]) & (ys[:, None] < ymax)
        corner = (active & ~dup & (dx[None] != 0)
                  & (np.floor(cross) == cross))
        moved = cross.copy()
        for r, i in zip(*np.nonzero(corner)):
            y, x = int(ys[r]), cross[r, i]
            same_sign = (dx[:i] > 0) if dx[i] > 0 else (dx[:i] < 0)
            off = -1 if y == t_ymax[i] else 1
            near = (same_sign & active[r, :i] & (cross[r, :i] == x)
                    & (t_ymin[:i] <= y + off) & (y + off <= t_ymax[:i]))
            if not near.any():
                continue
            k = int(np.argmax(near))
            adj, adj_k = line_x(y + off, i), line_x(y + off, k)
            if x > adj + _F32(1) and x > adj_k + _F32(1):
                moved[r, i] = _roundf(max(adj, adj_k)) + 1
            elif x < adj - _F32(1) and x < adj_k - _F32(1):
                moved[r, i] = _roundf(min(adj, adj_k)) - 1
        xs = np.concatenate([np.where(active, moved, np.inf),
                             np.where(dup, moved, np.inf)], 1)
        xs.sort(1)
        count = active.sum(1) + dup.sum(1)
        for p in range(0, xs.shape[1] - 1, 2):
            ok = p + 1 < count
            if not ok.any():
                break
            a = _round_up(xs[ok, p].astype(_F32))
            b = _round_down(xs[ok, p + 1].astype(_F32))
            rows.append(ys[ok])
            lo.append(a.astype(np.int64))
            hi.append(b.astype(np.int64))
    if not rows:
        return
    y = np.concatenate(rows)
    a = np.concatenate(lo)
    b = np.concatenate(hi)
    a = np.maximum(a, 0)
    b = np.minimum(b, w - 1)
    keep = (y >= 0) & (y < h) & (a < w) & (b >= 0) & (a <= b)
    y, a, b = y[keep], a[keep], b[keep]
    if not len(y):
        return
    # the spans' union, by a running sum over their bounding window
    y_lo, x_lo, x_hi = y.min(), a.min(), b.max()
    diff = np.zeros((y.max() - y_lo + 1, x_hi - x_lo + 2), np.int32)
    np.add.at(diff, (y - y_lo, a - x_lo), 1)
    np.add.at(diff, (y - y_lo, b + 1 - x_lo), -1)
    window = mask[y_lo:y.max() + 1, x_lo:x_hi + 1]
    window[np.cumsum(diff[:, :-1], 1) > 0] = 1


def _rasterize_polygons(polygons, height: int, width: int) -> np.ndarray:
    """The union of ``polygons`` (each ``[x0, y0, x1, y1, ...]``; fewer than
    3 vertices draw nothing) as ``(height, width)`` uint8."""
    out = np.zeros((height, width), np.uint8)
    for poly in polygons:
        if len(poly) // 2 >= 3:
            fill_polygon(out, [float(c) for c in poly[:len(poly) // 2 * 2]])
    return out


def convert_coco_poly_to_mask(segmentations, height: int,
                              width: int) -> np.ndarray:
    """One ``(height, width)`` uint8 mask an annotation (empty or None ->
    zeros, a dict -> its RLE, a list -> its polygons' union) ->
    ``(N, height, width)``."""
    masks = []
    for seg in segmentations:
        if seg is None or (isinstance(seg, list) and len(seg) == 0):
            masks.append(np.zeros((height, width), np.uint8))
        elif isinstance(seg, dict):
            masks.append(decode_rle(seg))
        else:
            masks.append(_rasterize_polygons(seg, height, width))
    if not masks:
        return np.zeros((0, height, width), np.uint8)
    return np.stack(masks)


class ConvertCocoPolysToMask:
    """reference ``coco_utils.py:28``: ``(image, {"image_id",
    "annotations"})`` -> ``(image, target)``, the target's ``boxes`` (f32
    XYXY, clamped to the CHW image), ``labels`` (int64), ``area`` (f32),
    ``iscrowd`` (zeros), ``masks`` (uint8 ``[K, H, W]``, with
    ``with_masks``) and ``keypoints`` (f32 ``[K, P, 3]``, where the
    annotations have them) as tensors, of the K non-crowd annotations whose
    box has area; ``image_id`` as given."""

    def __init__(self, with_masks: bool = True):
        self.with_masks = with_masks

    def __call__(self, image, target):
        h, w = image.shape[-2:]
        anno = [o for o in target["annotations"] if o.get("iscrowd", 0) == 0]
        boxes = np.asarray([o["bbox"] for o in anno], _F32).reshape(-1, 4)
        boxes[:, 2:] += boxes[:, :2]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
        keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
        out = {
            "image_id": target["image_id"],
            "boxes": torch.from_numpy(boxes[keep]),
            "labels": torch.from_numpy(np.asarray(
                [o["category_id"] for o in anno], np.int64)[keep]),
            "area": torch.from_numpy(np.asarray(
                [o["area"] for o in anno], _F32)[keep]),
            "iscrowd": torch.zeros(int(keep.sum()), dtype=torch.int64),
        }
        if self.with_masks:
            kept = [o.get("segmentation") for o, k in zip(anno, keep) if k]
            out["masks"] = torch.from_numpy(
                convert_coco_poly_to_mask(kept, h, w))
        if anno and "keypoints" in anno[0]:
            kp = np.asarray([o["keypoints"] for o in anno], _F32)
            out["keypoints"] = torch.from_numpy(
                kp.reshape(len(anno), -1, 3)[keep])
        return image, out


def coco_remove_images_without_annotations(dataset, cat_list=None) -> List[int]:
    """reference ``coco_utils.py:83``: the indices of the images with a
    usable annotation: a box of more than 1 px a side, and, for keypoint
    annotations, 10 visible keypoints in all. Reads the index only."""

    def has_valid(anno):
        if not anno:
            return False
        if all(any(c <= 1 for c in o["bbox"][2:]) for o in anno):
            return False
        if "keypoints" not in anno[0]:
            return True
        return sum(sum(1 for v in o["keypoints"][2::3] if v > 0)
                   for o in anno) >= 10

    ids = []
    for i in range(len(dataset)):
        anno = dataset._load_target(dataset.ids[i])
        if cat_list is not None:
            anno = [o for o in anno if o["category_id"] in cat_list]
        if has_valid(anno):
            ids.append(i)
    return ids


def convert_to_coco_api(ds) -> Dict[int, dict]:
    """reference ``coco_utils.py:122``: every ``(image, target)`` of ``ds``
    -> ``{image_id: {"boxes" (f32 XYXY numpy), "labels", "iscrowd"}}``, the
    ground truths ``coco_eval.CocoEvaluator`` takes."""
    gts: Dict[int, dict] = {}
    for idx in range(len(ds)):
        _, t = ds[idx]
        labels = np.asarray(t["labels"], np.int64).reshape(-1)
        crowd = t.get("iscrowd", np.zeros(len(labels)))
        gts[int(np.asarray(t["image_id"]))] = {
            "boxes": np.asarray(t["boxes"], np.float32).reshape(-1, 4),
            "labels": labels,
            "iscrowd": np.asarray(crowd, bool).reshape(-1),
        }
    return gts


def get_coco_api_from_dataset(dataset) -> Dict[int, dict]:
    """reference ``coco_utils.py:174``, through wrappers that hold a
    ``dataset``."""
    while hasattr(dataset, "dataset"):
        dataset = dataset.dataset
    return convert_to_coco_api(dataset)


class _CocoDetectionForRefs:
    """``CocoDetection`` + ``ConvertCocoPolysToMask`` (+ ``transforms``):
    ``(image, target)`` (reference ``coco_utils.py:186``). ``coco`` and
    ``ids`` are the base dataset's, so that the aspect-ratio groups read
    the index."""

    def __init__(self, img_folder, ann_file, transforms=None, with_masks=True):
        from vision_tpu_torch.datasets.coco import CocoDetection

        self.base = CocoDetection(img_folder, ann_file)
        self.ids = self.base.ids
        self.convert = ConvertCocoPolysToMask(with_masks=with_masks)
        self.transforms = transforms

    @property
    def coco(self):
        return self.base.coco

    def _load_target(self, id):
        return self.base._load_target(id)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        img, anno = self.base[idx]
        img, target = self.convert(
            img, {"image_id": self.ids[idx], "annotations": anno})
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target


def get_coco(root, image_set: str, transforms=None, mode: str = "instances",
             with_masks: bool = False):
    """reference ``coco_utils.py:200``: ``train2017/`` or ``val2017/`` with
    ``annotations/{mode}_{train,val}2017.json``; the training split drops
    the images without a usable annotation."""
    ann = os.path.join("annotations", f"{mode}_{{}}2017.json")
    img_folder, ann_file = {"train": ("train2017", ann.format("train")),
                            "val": ("val2017", ann.format("val"))}[image_set]
    ds = _CocoDetectionForRefs(os.path.join(root, img_folder),
                               os.path.join(root, ann_file),
                               transforms=transforms, with_masks=with_masks)
    if image_set == "train":
        keep = coco_remove_images_without_annotations(ds.base)
        ds.ids = [ds.ids[i] for i in keep]
        ds.base.ids = ds.ids
    return ds
