"""Shared pieces of the port's recipe tests (``test_torch_coco_voc.py``,
``test_torch_coco_eval.py``, ``test_torch_dataset_wrapper.py``,
``test_torch_references_det_seg.py``): the repo's ``references/`` modules
loaded by path under names of their own (their bare names, ``utils``,
``engine``, ``presets``, recur across the recipes), and PIL's polygon
outline, where the port's polygon fill may part from PIL's fill."""

import importlib.util
import os
import sys

import numpy as np
from PIL import Image, ImageDraw

REFS = os.path.join(os.path.dirname(__file__), "..", "references")


def load_reference(subdir: str, name: str):
    """``references/<subdir>/<name>.py`` as module ``_ref_<subdir>_<name>``,
    with ``references/classification`` and the module's folder on
    ``sys.path`` (as the recipes run)."""
    key = f"_ref_{subdir}_{name}"
    if key in sys.modules:
        return sys.modules[key]
    for d in (os.path.join(REFS, "classification"), os.path.join(REFS, subdir)):
        if d not in sys.path:
            sys.path.insert(0, d)
    spec = importlib.util.spec_from_file_location(
        key, os.path.join(REFS, subdir, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def pil_outline(polygons, h: int, w: int) -> np.ndarray:
    """The pixels of PIL's ``ImageDraw.polygon(outline=1)`` of each
    polygon, ``(h, w)`` bool."""
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for p in polygons:
        pts = [(float(p[i]), float(p[i + 1])) for i in range(0, len(p) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1)
    return np.asarray(img) > 0


def masks_off_outline(got, want, segmentations, h: int, w: int):
    """The pixels where ``got`` and ``want`` (``(N, h, w)`` masks of
    ``segmentations``) differ, and how many of them lie off PIL's outline
    of their polygons (an RLE has none: all its differences count)."""
    got, want = np.asarray(got), np.asarray(want)
    differ = off = 0
    for g, wm, seg in zip(got, want, segmentations):
        d = g != wm
        if not d.any():
            continue
        differ += int(d.sum())
        if isinstance(seg, list):
            d &= ~pil_outline(seg, h, w)
        off += int(d.sum())
    return differ, off
