"""Time other versions of the NMS, RoIAlign and window-pool kernels, of
the two pooler backward kernels, of the deformable convolution's two
libraries and of the flash-attention forward and backward, against the
package's own, in one process on one card, on the inputs that
``chip_smoke.py``'s paths give them.

    python -m vision_tpu_torch.tools.compare_kernel_versions OTHER_DIR [OTHER_DIR ...]

``OTHER_DIR`` holds some of ``nms.cu``, ``roi_align.cu``,
``nms_rowscan.cu``, ``window_pool.cu``, ``window_pool_backward.cu``,
``roi_align_backward.cu``, ``deform_conv.cu`` and
``deform_conv_backward.cu`` (these two with their ``deform_sample.cuh``)
and ``flash_attention.cu`` and ``flash_attention_backward.cu`` (with the
headers they include: ``flash_common.cuh``, and ``sm90_common.cuh``
where they use it); for example the files of an earlier commit, unpacked
with ``git archive``. Each kernel whose source is there is compared.
They are built with the package's own ``nvcc`` flags into
``OTHER_DIR/build``, all in parallel. Several directories are compared
in turn with the package's kernels on the same recorded inputs, each
after a line ``{"other_dir": ...}``. The forward kernels keep the
package's C entry points; a backward source may also have the f32-only
entry points without the ``bf16`` flag (and, for RoIAlign, without the
scratch function) that the backward kernels had before their bf16
variants, told apart by the source's own text.
A deformable-convolution source may have the first
design's entry points (a channels-last input, no tile plan; keys without
records), also told apart by its text: it then runs with that design's
wrapper work (the input's channels-last copy; the keys, the sort and the
int64 ranges), and a source with the package's entry points runs under
the package's own wrappers.

The forward inputs: the model (seeded random weights, ``cls_score`` x30,
one seeded 832x832 image, TF32 off) runs once as it is, recording the
inputs of the bitmask NMS, RoIAlign and window-pool wrappers, and once
under ``VISION_TPU_NMS_KERNEL=rowscan``, recording the row-serial NMS's.
RoIAlign gets two more cases on the P2 call's map and RoIs:
``aligned=True``, and the adaptive grid (``sampling_ratio=0``). The backward
inputs: one f32 train step of Faster R-CNN (the 7x7 box pooler) and one of
Mask R-CNN (7x7 and the 14x14 mask pooler) on ``chip_smoke.py``'s training
batch (two seeded images on the 1344 canvas, seeded gt boxes and masks),
recording every call of the two backward wrappers.

For each recorded call, the two versions' outputs are compared (NMS masks
bit for bit, the others within 1e-5 of the largest value) and each
version's device time is taken in turns (package, other, other, package):
20 calls queued behind a spin kernel, over 20; a backward call's time
includes its wrapper's device work (the sort of the window origins), the
same for both versions. Each NMS kernel is also timed on the same boxes at
thresholds -1 (every box after a row's first is suppressed: what the chain
costs with no tests left) and 2 (every valid box is kept: the most tests),
and the bitmask NMS's and the backward kernels' device time is split by
kernel (the NMS mask pass and scan; the backward passes' describe, sum and
other kernels, and the wrapper's sort) with ``torch.profiler``.

The deformable convolution's inputs: ``maskrcnn_resnet50_fpn_deform``
(seeded weights and offset predictors, ``seed_offsets``) serves one
request of ``chip_smoke.py``'s two raw images in f32 and one in bf16,
recording the 13 calls of the column kernel in each, and takes one train
step in f32 and one in bf16 (``compute_dtype``) on its training batch,
recording the 13 calls of the backward in each. Each call's two outputs
agree (the columns bit for bit; the backward's gradients within 1e-5 of
the largest value, the bf16 input's gradient within a bf16 step of it);
each version's device time, its wrapper's work included, is taken in
turns, and the backward's is split by kernel (keys, record pass, sort,
input sum, offsets, other). Then a line sums each request's and each
step's calls for both versions.

The flash-attention inputs: ViT-B/16 at 384 px (``tools/vit_train.py``:
``seeded_vit``, ``RecipeStep`` at batch 64 from the 448x448 frames,
``chip_smoke.py``'s ``vit_b16_384_train*`` cells) takes one recipe step in
f32 and one in amp, recording the arguments of the 12 forward and the 12
dK/dV calls of each, laid out as they lie (the head views of the packed
projection); the dQ kernel takes the dK/dV calls' arguments. For the
forward, ViT-L/16 at 512 px (``chip_smoke.py``'s ``vit_l16_512_forward*``
cells: seeded, one batch of 32 seeded images) serves one batch in f32 and
one in bf16, recording its 24 forward calls each. Each forward call's two
outputs agree (``o`` within ``FLASH_FWD_TOL`` of the other version's
largest value, ``lse`` within 1e-5 of max(1, its largest)), ``same_bits``
says whether they are equal bit for bit, each version's device time is
taken in turns, and a line a path sums the calls. Each backward call's
outputs agree (f32 within 1e-4 of the other version's largest value: two
f32 designs sum in other orders, the FP32 units or three TF32 products;
bf16 within 2e-2), ``same_bits`` says whether they are equal bit for bit,
and each version's device time, the package's wrappers
around it, is taken in turns for the dK/dV and the dQ kernel alone, and a
line a path sums the step's calls. Then the f32 round-off at a few keys,
``[2, 3, S, D]`` unit normals at S = 1 (one key), 2 and 16 over
``ROUND_OFF_SEEDS`` seeds, each version against the plain version: the
forward's ``o`` (the largest difference over the largest plain value) and
``lse`` (the largest difference), and where the gradients of q and k
vanish (at S = 1 dq and dk are 0 in exact arithmetic) dq, dk, dv in the
card tests' measure (the largest difference over max(the largest plain
value, 1e-2)); a line a shape and kernel. One JSON line per call, then the
card's name and power limit. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import json
import os
import re
import subprocess
import sys
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from vision_tpu_torch import _kernels
from vision_tpu_torch.models import get_model

SPIN_CYCLES = 30_000_000  # ~17 ms: the timed calls queue behind it
CLS_SCALE = 30.0
SIZE = 832
KERNELS = ("nms", "roi_align", "nms_rowscan", "window_pool",
           "window_pool_backward", "roi_align_backward", "deform_conv",
           "deform_conv_backward", "flash_attention", "flash_attention_backward")
BACKWARD = ("window_pool_backward", "roi_align_backward")
DEFORM = ("deform_conv", "deform_conv_backward")
FLASH = ("flash_attention", "flash_attention_backward")
FLASH_BF16_TOL = 2e-2  # of the largest value: p and ds rounded otherwise
FLASH_F32_TOL = 1e-4  # of the largest value: sums in other orders
# the forward's o, of the largest value (chip_smoke.py's FLASH_TOL); lse
# within FLASH_LSE_TOL of max(1, its largest)
FLASH_FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FLASH_LSE_TOL = 1e-5
ROUND_OFF_SEEDS = 20
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the deformable convolution's first entry points: a channels-last input
# and no tile plan; keys without records, int64 ranges
_FIRST_DEFORM = {
    "deform_conv": {"vt_deform_im2col": [_P] * 4 + [_I] * 15 + [_I, _P]},
    "deform_conv_backward": {
        "vt_deform_scatter_keys": [_P] * 2 + [_I] * 15 + [_P],
        "vt_deform_backward": [_P] * 9 + [_I] * 15 + [_I, _P]},
}
# the backward kernels' f32-only C entry points, before the bf16 flag
_F32_ONLY = {
    "window_pool_backward": {
        "vt_window_pool_backward": [_P] * 9 + [_I] * 8 + [_F, _P],
        "vt_window_pool_backward_scratch": [_I, _I]},
    "roi_align_backward": {
        "vt_roi_align_backward": [_P] * 4 + [_I] * 7 + [_F, _I, _I, _P]},
}


def device_ms(fn, launches: int = 20, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def kernel_split_ms(fn, calls: int = 20) -> dict:
    """Device ms a call of each CUDA kernel that ``fn`` launches, by name,
    from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = 0.0
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                us = float(getattr(e, attr))
                break
        found = re.search(r"(\w+)(?:<[^>]*>)?\(", e.key)
        name = found.group(1) if found else e.key
        split[name] += us / calls / 1e3
    return dict(split)


def f32_only(name: str, source: Path) -> bool:
    """Whether a backward source has the entry points without the bf16
    flag."""
    if name not in BACKWARD:
        return False
    found = re.search(r"extern \"C\" int vt_%s\((.*?)\)" % name,
                      source.read_text(), re.S)
    return found is not None and "bf16" not in found.group(1)


def first_deform(name: str, source: Path) -> bool:
    """Whether a deformable-convolution source has the first design's
    entry points (no tile plan in the forward's, no records in the
    backward's)."""
    if name not in DEFORM:
        return False
    entry = "vt_deform_im2col" if name == "deform_conv" else "vt_deform_backward"
    found = re.search(r"extern \"C\" int %s\((.*?)\)" % entry,
                      source.read_text(), re.S)
    return found is not None and not re.search(r"\b(th|recs)\b", found.group(1))


def build_other(name: str, other: Path) -> ctypes.CDLL:
    source, extra, functions = _kernels._KERNELS[name]
    out = other / "build" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_kernels._nvcc(), *_kernels._NVCC_FLAGS, *extra, "-o",
                    str(out), str(other / source)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.f32_only = f32_only(name, other / source)
    lib.first_deform = first_deform(name, other / source)
    if lib.f32_only:
        functions = _F32_ONLY[name]
    if lib.first_deform:
        functions = _FIRST_DEFORM[name]
    for fn, argtypes in functions.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def nms(lib, boxes, valid, thr):
    b, n = valid.shape
    mask = torch.empty(b, n, -(-n // 64), dtype=torch.int64, device=boxes.device)
    keep = torch.empty(b, n, dtype=torch.bool, device=boxes.device)
    _kernels.check(lib.vt_nms_keep(
        boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(), keep.data_ptr(),
        b, n, float(thr), _kernels.stream_handle(boxes)), "nms")
    return keep


def rowscan(lib, boxes, valid, thr):
    keep = torch.empty(valid.shape, dtype=torch.bool, device=boxes.device)
    _kernels.check(lib.vt_nms_rowscan(
        boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), valid.shape[0],
        valid.shape[1], float(thr), _kernels.stream_handle(boxes)), "rowscan")
    return keep


def roi_align(lib, inp, rois, size, scale, sr, aligned):
    ph, pw = (size, size) if isinstance(size, int) else size
    n, c, h, w = inp.shape
    out = torch.empty(rois.shape[0], c, ph, pw, dtype=inp.dtype,
                      device=inp.device)
    _kernels.check(lib.vt_roi_align_forward(
        inp.data_ptr(), rois.data_ptr(), out.data_ptr(), n, c, h, w,
        rois.shape[0], ph, pw, float(scale), int(sr), int(bool(aligned)),
        int(inp.dtype == torch.bfloat16), _kernels.stream_handle(inp)),
        "roi_align")
    return out


def window_pool(lib, stacked, row0, x0, w_y, w_x, div):
    k, ph, winy = w_y.shape
    _, pw, winx = w_x.shape
    r_rows, wmax, c = stacked.shape
    out = torch.empty(k, c, ph, pw, dtype=stacked.dtype, device=stacked.device)
    _kernels.check(lib.vt_window_pool(
        stacked.data_ptr(), row0.data_ptr(), x0.data_ptr(), w_y.data_ptr(),
        w_x.data_ptr(), out.data_ptr(), r_rows, wmax, c, k, ph, pw, winy,
        winx, float(div), int(stacked.dtype == torch.bfloat16),
        _kernels.stream_handle(stacked)), "window_pool")
    return out


def window_pool_backward(lib, grad, row0, x0, w_y, w_x, size, div):
    """``window_pool_backward_cuda``'s work on ``lib``'s kernel."""
    k, c, ph, pw = grad.shape
    r_rows, wmax = size
    sorted_row0, order = torch.sort(row0, stable=True)
    order = order.to(torch.int32)
    out = torch.empty(r_rows, wmax, c, dtype=grad.dtype, device=grad.device)
    scratch = torch.empty(lib.vt_window_pool_backward_scratch(k, r_rows),
                          dtype=torch.int32, device=grad.device)
    args = [grad.data_ptr(), sorted_row0.data_ptr(), order.data_ptr(),
            row0.data_ptr(), x0.data_ptr(), w_y.data_ptr(), w_x.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), r_rows, wmax, c, k, ph, pw,
            w_y.shape[2], w_x.shape[2], float(div)]
    if not getattr(lib, "f32_only", False):
        args.append(int(grad.dtype == torch.bfloat16))
    _kernels.check(lib.vt_window_pool_backward(
        *args, _kernels.stream_handle(grad)), "window_pool_backward")
    return out


def roi_align_backward(lib, grad, rois, shape, size, scale, sr, aligned):
    """``roi_align_backward_cuda``'s work on ``lib``'s kernel."""
    ph, pw = (size, size) if isinstance(size, int) else size
    n, c, h, w = shape
    k = rois.shape[0]
    out = torch.empty(shape, dtype=grad.dtype, device=grad.device)
    if getattr(lib, "f32_only", False):
        scratch = torch.empty(k, 16, dtype=torch.int32, device=grad.device)
        tail = []
    else:
        scratch = torch.empty(lib.vt_roi_align_backward_scratch(
            n, c, h, w, k, ph, pw), dtype=torch.float32, device=grad.device)
        tail = [int(grad.dtype == torch.bfloat16)]
    _kernels.check(lib.vt_roi_align_backward(
        grad.data_ptr(), rois.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        n, c, h, w, k, ph, pw, float(scale), int(sr), int(bool(aligned)),
        *tail, _kernels.stream_handle(grad)), "roi_align_backward")
    return out


@contextlib.contextmanager
def _library(name: str, lib):
    """The package's wrappers, with ``lib`` as kernel library ``name``."""
    _kernels.load(name)
    saved = _kernels._libs[name]
    _kernels._libs[name] = lib
    try:
        yield
    finally:
        _kernels._libs[name] = saved


def _deform_module():
    return importlib.import_module("vision_tpu_torch.ops.deform_conv")


def deform_conv(lib, x, off, mask, k, stride, pad, dil):
    """``deform_im2col_cuda``'s work on ``lib``: the package's wrapper, or
    for the first design's entry points its wrapper's (a channels-last copy
    of the input)."""
    dc = _deform_module()
    if not getattr(lib, "first_deform", False):
        with _library("deform_conv", lib):
            return dc.deform_im2col_cuda(x, off, mask, k, stride, pad, dil)
    geo, (stride, pad, dil), xx, o, m = dc._kernel_args(
        x, off, mask, k, stride, pad, dil, "deform_conv")
    n, c, h, w, kh, kw, oh, ow, og = geo
    cols = torch.empty(n, oh, ow, kh * kw, c, dtype=torch.float32,
                       device=x.device)
    _kernels.check(lib.vt_deform_im2col(
        xx.permute(0, 2, 3, 1).contiguous().data_ptr(), o.data_ptr(),
        0 if m is None else m.data_ptr(), cols.data_ptr(), n, c, h, w, kh, kw,
        oh, ow, og, *stride, *pad, *dil, int(x.dtype == torch.bfloat16),
        _kernels.stream_handle(x)), "deform_conv")
    return cols


def deform_conv_backward(lib, x, off, mask, g_cols, k, stride, pad, dil):
    """``deform_conv_backward_cuda``'s work on ``lib``: the package's
    wrapper, or for the first design's entry points its wrapper's (a
    channels-last copy of the input, the keys, their stable sort and int64
    ranges)."""
    dc = _deform_module()
    if not getattr(lib, "first_deform", False):
        with _library("deform_conv_backward", lib):
            return dc.deform_conv_backward_cuda(x, off, mask, g_cols, k, stride,
                                                pad, dil)
    geo, (stride, pad, dil), xx, o, m = dc._kernel_args(
        x, off, mask, k, stride, pad, dil, "deform_conv_backward")
    n, c, h, w, kh, kw, oh, ow, og = geo
    dev, stream = x.device, _kernels.stream_handle(x)
    geometry = (n, c, h, w, kh, kw, oh, ow, og, *stride, *pad, *dil)
    keys = torch.empty(4 * n * og * kh * kw * oh * ow, dtype=torch.int32,
                       device=dev)
    _kernels.check(lib.vt_deform_scatter_keys(o.data_ptr(), keys.data_ptr(),
                                              *geometry, stream), "keys")
    sorted_keys, order = torch.sort(keys, stable=True)
    starts = torch.searchsorted(sorted_keys, torch.arange(
        n * og * h * w + 1, dtype=torch.int32, device=dev))
    gi = torch.empty(n, c, h, w, dtype=x.dtype, device=dev)
    go = torch.empty(o.shape, dtype=torch.float32, device=dev)
    gm = None if m is None else torch.empty(m.shape, dtype=torch.float32,
                                            device=dev)
    _kernels.check(lib.vt_deform_backward(
        xx.permute(0, 2, 3, 1).contiguous().data_ptr(), o.data_ptr(),
        0 if m is None else m.data_ptr(), g_cols.contiguous().data_ptr(),
        order.data_ptr(), starts.data_ptr(), gi.data_ptr(), go.data_ptr(),
        0 if gm is None else gm.data_ptr(), *geometry,
        int(x.dtype == torch.bfloat16), stream), "deform_conv_backward")
    return gi, go, gm


RUNNERS = {"nms": nms, "roi_align": roi_align, "nms_rowscan": rowscan,
           "window_pool": window_pool,
           "window_pool_backward": window_pool_backward,
           "roi_align_backward": roi_align_backward,
           "deform_conv": deform_conv,
           "deform_conv_backward": deform_conv_backward}


def window_stats(stacked, row0, x0, w_y, w_x, div) -> dict:
    """What the windows ask of a kernel: the cells of every RoI's bounding
    range of non-zero rows and columns (what the package's kernel stages),
    the cells of its non-zero rows and columns, and those ranges' bytes."""
    ynz, xnz = (w_y != 0).any(1), (w_x != 0).any(1)  # [K, win]

    def extent(nz):
        idx = torch.arange(nz.shape[1], device=nz.device)
        lo = torch.where(nz, idx, nz.shape[1]).amin(1)
        hi = torch.where(nz, idx + 1, 0).amax(1)
        return (hi - lo).clamp(min=0)

    ny, nx = extent(ynz), extent(xnz)
    cells = int((ny * nx).sum())
    c = stacked.shape[2]
    return {"rois": int(ny.numel()), "channels": c,
            "range_cells": cells, "range_bytes": cells * c * 4,
            "nonzero_cells": int((ynz.sum(1) * xnz.sum(1)).sum()),
            "mean_rows": float(ny.float().mean()),
            "mean_cols": float(nx.float().mean()),
            "rois_over_16_cols": int((nx > 16).sum())}


def record_inputs() -> dict:
    """The arguments of every kernel call of the two forwards, as the
    kernels receive them (contiguous, int32 window origins)."""
    nms_mod = importlib.import_module("vision_tpu_torch.ops.nms")
    poolers = importlib.import_module("vision_tpu_torch.ops.poolers")
    roi_mod = importlib.import_module("vision_tpu_torch.ops.roi_align")
    calls = {name: [] for name in KERNELS}
    slots = {"nms": (nms_mod, "nms_keep_sorted_cuda"),
             "nms_rowscan": (nms_mod, "nms_keep_sorted_rowscan_cuda"),
             "window_pool": (poolers, "window_pool_cuda"),
             "roi_align": (roi_mod, "roi_align_cuda")}
    wrappers = {name: getattr(mod, attr) for name, (mod, attr) in slots.items()}

    def recorder(name):
        def rec(*args):
            if name == "window_pool":
                stacked, row0, x0, w_y, w_x = args[:5]
                saved = (stacked.contiguous().clone(),
                         row0.to(torch.int32).contiguous(),
                         x0.to(torch.int32).contiguous(),
                         w_y.contiguous().clone(), w_x.contiguous().clone(),
                         args[5] if len(args) > 5 else 1.0)
            else:
                saved = tuple(a.contiguous().clone() if torch.is_tensor(a) else a
                              for a in args)
            calls[name].append(saved)
            return wrappers[name](*args)
        return rec

    model = get_model("fasterrcnn_resnet50_fpn", seed=0)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.weight.mul_(CLS_SCALE)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(1, 3, SIZE, SIZE, generator=gen).cuda()
    for name, (mod, attr) in slots.items():
        setattr(mod, attr, recorder(name))
    try:
        with torch.inference_mode():
            model(images)
            first = {name: len(c) for name, c in calls.items()}
            os.environ["VISION_TPU_NMS_KERNEL"] = "rowscan"
            model(images)
        torch.cuda.synchronize()
    finally:
        for name, (mod, attr) in slots.items():
            setattr(mod, attr, wrappers[name])
        os.environ.pop("VISION_TPU_NMS_KERNEL", None)
    # of the rowscan forward, only the rowscan calls are new
    for name in ("nms", "roi_align", "window_pool"):
        calls[name] = calls[name][: first[name]]
    inp, rois, size, scale = calls["roi_align"][0][:4]
    calls["roi_align"] += [(inp, rois, size, scale, 2, True),
                           (inp, rois, size, scale, 0, False)]
    return calls


def record_backward_inputs() -> dict:
    """The arguments of every call of the two backward wrappers in one f32
    train step of Faster R-CNN and one of Mask R-CNN (``chip_smoke.py``'s
    batch and optimizer), as the kernels receive them, each tagged with its
    step and pooled size."""
    from vision_tpu_torch.models.detection import (
        FasterRCNN_ResNet50_FPN_Weights,
        GeneralizedRCNNTransform,
    )
    from vision_tpu_torch.parallel import make_detection_train_step
    from vision_tpu_torch.tools.detection_request import (
        raw_images,
        recipe_optimizer,
        train_batch,
    )

    poolers = importlib.import_module("vision_tpu_torch.ops.poolers")
    roi_mod = importlib.import_module("vision_tpu_torch.ops.roi_align")
    slots = {"window_pool_backward": (poolers, "window_pool_backward_cuda"),
             "roi_align_backward": (roi_mod, "roi_align_backward_cuda")}
    wrappers = {name: getattr(mod, attr) for name, (mod, attr) in slots.items()}
    calls = {name: [] for name in BACKWARD}
    step_name = ""

    def recorder(name):
        def rec(*args):
            if name == "window_pool_backward":
                grad, row0, x0, w_y, w_x, size = args[:6]
                saved = (grad.contiguous().clone(),
                         row0.to(torch.int32).contiguous(),
                         x0.to(torch.int32).contiguous(),
                         w_y.contiguous().clone(), w_x.contiguous().clone(),
                         tuple(size), args[6] if len(args) > 6 else 1.0)
            else:
                saved = tuple(a.contiguous().clone() if torch.is_tensor(a) else a
                              for a in args)
            calls[name].append((f"{step_name} {args[0].shape[2]}x"
                                f"{args[0].shape[3]}", saved))
            return wrappers[name](*args)
        return rec

    raw = raw_images()
    for name, extras in (("fasterrcnn_resnet50_fpn", {}),
                         ("maskrcnn_resnet50_fpn", {"masks": True})):
        step_name = name.split("_")[0]
        with torch.no_grad():
            batch = train_batch(
                FasterRCNN_ResNet50_FPN_Weights.COCO_V1.transforms(),
                GeneralizedRCNNTransform(), raw, **extras)
        model = get_model(name, seed=0, trainable_backbone_layers=3)
        optimizer, _ = recipe_optimizer(model)
        step = make_detection_train_step(model, optimizer)
        for n, (mod, attr) in slots.items():
            setattr(mod, attr, recorder(n))
        try:
            step(batch, torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
        finally:
            for n, (mod, attr) in slots.items():
                setattr(mod, attr, wrappers[n])
        del model, optimizer, step, batch
        torch.cuda.empty_cache()
    return calls


def record_deform_inputs() -> dict:
    """The arguments of the column kernel's 13 calls in one request of
    ``maskrcnn_resnet50_fpn_deform`` in f32 and one in bf16, and of the
    backward's 13 in one f32 and one bf16 train step (``chip_smoke.py``'s
    images, batch and optimizer; seeded offset predictors), each tagged
    with its path."""
    from vision_tpu_torch.models.detection import (
        FasterRCNN_ResNet50_FPN_Weights,
        GeneralizedRCNNTransform,
    )
    from vision_tpu_torch.parallel import make_detection_train_step
    from vision_tpu_torch.tools.detection_request import (
        raw_images,
        recipe_optimizer,
        seed_offsets,
        serve,
        train_batch,
    )

    dc = _deform_module()
    attrs = {"deform_conv": "deform_im2col_cuda",
             "deform_conv_backward": "deform_conv_backward_cuda"}
    wrappers = {name: getattr(dc, attr) for name, attr in attrs.items()}
    calls = {name: [] for name in DEFORM}
    where = {"tag": "", "record": ""}

    def recorder(name):
        def rec(*args):
            if name == where["record"]:
                calls[name].append((where["tag"], tuple(
                    a.contiguous().clone() if torch.is_tensor(a) else a
                    for a in args)))
            return wrappers[name](*args)
        return rec

    raw = raw_images()
    preset = FasterRCNN_ResNet50_FPN_Weights.COCO_V1.transforms()
    transform = GeneralizedRCNNTransform()
    for name, attr in attrs.items():
        setattr(dc, attr, recorder(name))
    try:
        model = get_model("maskrcnn_resnet50_fpn_deform", seed=0)
        with torch.no_grad():
            seed_offsets(model, transform([preset(r) for r in raw]).tensors)
        where["record"] = "deform_conv"
        for dtype in (torch.float32, torch.bfloat16):
            where["tag"] = f"request {str(dtype)[6:]}"
            model.to(dtype)
            with torch.inference_mode():
                serve(model, preset, transform, raw, dtype)
        del model
        with torch.no_grad():
            batch = train_batch(preset, transform, raw, masks=True)
        where["record"] = "deform_conv_backward"
        for dtype in (None, torch.bfloat16):
            model = get_model("maskrcnn_resnet50_fpn_deform", seed=0,
                              trainable_backbone_layers=3)
            with torch.no_grad():
                seed_offsets(model, batch["image"])
            optimizer, _ = recipe_optimizer(model)
            step = make_detection_train_step(model, optimizer,
                                             compute_dtype=dtype)
            where["tag"] = "train " + ("bf16" if dtype else "float32")
            step(batch, torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
            del model, optimizer, step
            torch.cuda.empty_cache()
    finally:
        for name, attr in attrs.items():
            setattr(dc, attr, wrappers[name])
    return calls


def laid_copies(tensors):
    """Copies of ``tensors`` on new storage, laid out as they lie: tensors
    that share a storage (the head views of one projection) share one copy
    of it, at their own offsets and strides."""
    copies, out = {}, []
    for t in tensors:
        if not torch.is_tensor(t):
            out.append(t)
            continue
        storage = t.untyped_storage()
        key = (storage.data_ptr(), t.dtype)
        if key not in copies:
            whole = torch.empty(0, dtype=t.dtype, device=t.device)
            whole.set_(storage)
            copies[key] = whole.clone()
        out.append(copies[key].as_strided(t.shape, t.stride(),
                                          t.storage_offset()))
    return tuple(out)


def record_flash_inputs(names) -> dict:
    """The arguments of the 12 forward and the 12 dK/dV calls in one
    ViT-B/16 384 recipe step at batch 64 in f32 and one in amp
    (``chip_smoke.py``'s model, frames and step) and, where the forward is
    compared, of the 24 forward calls of one ViT-L/16 512 batch of 32 in
    f32 and one in bf16, laid out as they lie, each tagged with its path;
    keyed by the sources in ``names``."""
    from vision_tpu_torch.tools.vit_train import (
        CROP_384,
        FRAME_384,
        SERVE_BATCH_512,
        TRAIN_BATCH_384,
        RecipeStep,
        frames,
        seeded_vit,
    )

    attention = _attention()
    slots = {"flash_attention": "flash_attention_forward_cuda",
             "flash_attention_backward": "flash_attention_dkv_cuda"}
    wrappers = {n: getattr(attention, attr) for n, attr in slots.items()}
    calls = {n: [] for n in slots}
    where = {"tag": ""}

    def recorder(name):
        def rec(*args):
            if name in names:
                calls[name].append((where["tag"], laid_copies(args)))
            return wrappers[name](*args)
        return rec

    for n, attr in slots.items():
        setattr(attention, attr, recorder(n))
    try:
        raw = frames(TRAIN_BATCH_384, FRAME_384)
        for dtype in (None, torch.bfloat16):
            model = seeded_vit(image_size=CROP_384)
            run = RecipeStep(model, dtype, batch_size=TRAIN_BATCH_384,
                             crop_size=CROP_384)
            where["tag"] = "train384 " + ("bf16" if dtype else "float32")
            run(raw, torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
            del model, run
            torch.cuda.empty_cache()
        if "flash_attention" in names:
            model = seeded_vit(name="vit_l_16", image_size=512)
            x = torch.randn(SERVE_BATCH_512, 3, 512, 512,
                            generator=torch.Generator().manual_seed(0)).cuda()
            for dtype in (torch.float32, torch.bfloat16):
                where["tag"] = f"serve512 {str(dtype)[6:]}"
                model.to(dtype)
                with torch.inference_mode():
                    model(x.to(dtype))
                torch.cuda.synchronize()
            del model, x
            torch.cuda.empty_cache()
    finally:
        for n, attr in slots.items():
            setattr(attention, attr, wrappers[n])
    return {n: c for n, c in calls.items() if n in names}


def _attention():
    return importlib.import_module("vision_tpu_torch.ops.attention")


def flash_forward(lib, *args):
    """``flash_attention_forward_cuda``'s work on ``lib``'s kernel."""
    with _library("flash_attention", lib):
        return _attention().flash_attention_forward_cuda(*args)


def flash_dkv(lib, *args):
    """``flash_attention_dkv_cuda``'s work on ``lib``'s kernel."""
    with _library("flash_attention_backward", lib):
        return _attention().flash_attention_dkv_cuda(*args)


def flash_dq(lib, *args):
    """``flash_attention_dq_cuda``'s work on ``lib``'s kernel."""
    with _library("flash_attention_backward", lib):
        return _attention().flash_attention_dq_cuda(*args)


def _flash_line(kernel, where, args, run, ours, theirs, totals, **meta):
    """Device ms of ``run`` on both libraries in turns (package, other,
    other, package), printed with ``meta`` and added to ``totals``."""
    turns = [device_ms(lambda lib=lib: run(lib, *args))
             for lib in (ours, theirs, theirs, ours)]
    line = {"kernel": kernel, "path": where, "dtype": str(args[0].dtype)[6:],
            "shape": list(args[0].shape),
            "strides": [list(t.stride()) for t in args if torch.is_tensor(t)
                        and t.dim() == 4],
            "device_ms": (turns[0] + turns[3]) / 2,
            "other_device_ms": (turns[1] + turns[2]) / 2,
            "turns_ms": turns, **meta}
    line["factor"] = line["other_device_ms"] / line["device_ms"]
    t = totals[(kernel, where)]
    t["calls"] += 1
    t["device_ms"] += line["device_ms"]
    t["other_device_ms"] += line["other_device_ms"]
    print(json.dumps(line), flush=True)


def _print_totals(totals) -> None:
    for (kernel, where), t in totals.items():
        print(json.dumps({"kernel": kernel, "path": where, "summed_over_calls": {
            **t, "factor": t["other_device_ms"] / t["device_ms"]}}), flush=True)


def compare_flash_forward(ours, theirs, calls) -> bool:
    """One line per recorded forward call (agreement of o and lse, device
    ms in turns), then one a path summing its calls, then the f32
    round-off sweep. Returns whether every call agreed."""
    totals = defaultdict(lambda: defaultdict(float))
    ok_all = True
    for where, args in calls:
        (o, lse), (o2, lse2) = flash_forward(ours, *args), flash_forward(
            theirs, *args)
        torch.cuda.synchronize()
        err = float((o.float() - o2.float()).abs().max()
                    / o2.float().abs().max().clamp(min=1e-30))
        lse_err = float((lse - lse2).abs().max())
        lse_tol = FLASH_LSE_TOL * max(1.0, float(lse2.abs().max()))
        tol = FLASH_FWD_TOL[args[0].dtype]
        ok = err <= tol and lse_err <= lse_tol
        same = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
        del o, lse, o2, lse2
        _flash_line("flash_attention", where, args, flash_forward, ours,
                    theirs, totals, max_rel_err=err, tol=tol,
                    lse_max_abs_err=lse_err, lse_tol=lse_tol, same_bits=same,
                    agree=ok)
        ok_all &= ok
    _print_totals(totals)
    flash_forward_round_off(ours, theirs)
    return ok_all


def flash_forward_round_off(ours, theirs) -> None:
    """The two versions' f32 o and lse against the plain version at one key
    and at a few, over ``ROUND_OFF_SEEDS`` seeds (the module's docstring);
    one line a shape: the worst and median over the seeds and how many
    exceed the card tests' 1e-5."""
    attention = _attention()
    for s, d in ((1, 64), (1, 128), (2, 64), (16, 64)):
        errs = {tag: {"o": [], "lse": []} for tag in ("device", "other")}
        for seed in range(ROUND_OFF_SEEDS):
            g = torch.Generator().manual_seed(seed)
            q, k, v = (torch.randn(2, 3, s, d, generator=g).cuda()
                       for _ in range(3))
            want_o, want_lse = attention.flash_attention_plain(q, k, v)
            for tag, lib in (("device", ours), ("other", theirs)):
                o, lse = flash_forward(lib, q, k, v)
                errs[tag]["o"].append(float((o - want_o).abs().max())
                                      / float(want_o.abs().max()))
                errs[tag]["lse"].append(float((lse - want_lse).abs().max()))
        print(json.dumps({"kernel": "flash_attention", "round_off": {
            "s": s, "d": d, "seeds": ROUND_OFF_SEEDS, **{
                tag: {k: {"max": max(v), "median": sorted(v)[len(v) // 2],
                          "over_1e-5": sum(x > 1e-5 for x in v)}
                      for k, v in e.items()}
                for tag, e in errs.items()}}}), flush=True)


def compare_flash(ours, theirs, calls) -> bool:
    """One line per recorded call and backward kernel (agreement, device ms
    in turns), then one a path and kernel summing its calls, then the f32
    round-off sweep. Returns whether every call agreed."""
    totals = defaultdict(lambda: defaultdict(float))
    ok_all = True
    for where, args in calls:
        for kernel, run in (("dkv", flash_dkv), ("dq", flash_dq)):
            got, want = run(ours, *args), run(theirs, *args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            bf16 = args[0].dtype == torch.bfloat16
            err = max(float((a.float() - b.float()).abs().max()
                            / b.float().abs().max().clamp(min=1e-30))
                      for a, b in zip(got, want))
            tol = FLASH_BF16_TOL if bf16 else FLASH_F32_TOL
            ok = err <= tol
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            del got, want
            _flash_line(f"flash_attention_backward_{kernel}", where, args, run,
                        ours, theirs, totals, max_rel_err=err, tol=tol,
                        same_bits=same, agree=ok)
            ok_all &= ok
    _print_totals(totals)
    flash_round_off(ours, theirs)
    return ok_all


def flash_round_off(ours, theirs) -> None:
    """The two versions' f32 dq, dk, dv against the plain version at one
    key and at a few, over ``ROUND_OFF_SEEDS`` seeds (the module's
    docstring); one line a shape: the worst and median over the seeds and
    how many exceed the card tests' 1e-4."""
    attention = _attention()
    for s, d in ((1, 64), (1, 128), (2, 64), (16, 64)):
        worst = {"device": [], "other": []}
        for seed in range(ROUND_OFF_SEEDS):
            g = torch.Generator().manual_seed(seed)
            q, k, v, do = (torch.randn(2, 3, s, d, generator=g).cuda()
                           for _ in range(4))
            o, lse = attention.flash_attention_plain(q, k, v)
            di = attention._di(o, do)
            want = (attention.flash_attention_dq_plain(q, k, v, do, lse, di),
                    *attention.flash_attention_dkv_plain(q, k, v, do, lse, di))
            for tag, lib in (("device", ours), ("other", theirs)):
                got = (flash_dq(lib, q, k, v, do, lse, di),
                       *flash_dkv(lib, q, k, v, do, lse, di))
                worst[tag].append(max(
                    float((a - b).abs().max()) / max(float(b.abs().max()), 1e-2)
                    for a, b in zip(got, want)))
        print(json.dumps({"kernel": "flash_attention_backward", "round_off": {
            "s": s, "d": d, "seeds": ROUND_OFF_SEEDS, **{
                tag: {"max": max(v), "median": sorted(v)[len(v) // 2],
                      "over_1e-4": sum(x > 1e-4 for x in v)}
                for tag, v in worst.items()}}}), flush=True)


def deform_split(split: dict) -> dict:
    """A deformable backward's device ms by pass: keys, record pass, sort
    (and the ranges' search), input sum, offsets (with the splits' sum),
    other."""
    out = defaultdict(float)
    for kernel, ms in split.items():
        if kernel == "keys_kernel":
            group = "keys"
        elif kernel == "sort_records_kernel":
            group = "record pass"
        elif kernel.startswith("input_grad_kernel"):
            group = "input sum"
        elif kernel.startswith(("offset_grad_kernel", "finish_kernel")):
            group = "offsets"
        elif re.search(r"sort|Sort|radix|Radix|searchsorted", kernel):
            group = "sort"
        else:
            group = "other"
        out[group] += ms
    return dict(out)


def compare_deform(name: str, ours, theirs, calls) -> bool:
    """One line per recorded call (agreement, device ms in turns, the
    backward's split), then one a path summing its calls. Returns whether
    every call agreed."""
    run = RUNNERS[name]
    totals = defaultdict(lambda: defaultdict(float))
    ok_all = True
    for where, args in calls:
        got, want = run(ours, *args), run(theirs, *args)
        torch.cuda.synchronize()
        if name == "deform_conv":
            ok = bool(torch.equal(got, want))
            err = float((got - want).abs().max())
        else:
            errs = {}
            for label, a, b in zip(("input", "offset", "mask"), got, want):
                if b is not None:
                    errs[label] = float((a.float() - b.float()).abs().max()
                                        / b.float().abs().max().clamp(min=1e-30))
            tol = {k: 2.0 ** -7 if k == "input" and args[0].dtype == torch.bfloat16
                   else 1e-5 for k in errs}
            ok = all(errs[k] <= tol[k] for k in errs)
            err = errs
        del got, want
        turns = [device_ms(lambda lib=lib: run(lib, *args))
                 for lib in (ours, theirs, theirs, ours)]
        line = {"kernel": name, "path": where, "dtype": str(args[0].dtype)[6:],
                "other_first_design": theirs.first_deform,
                "shape": [list(args[0].shape), list(args[1].shape)],
                "stride": args[4] if name == "deform_conv" else args[5],
                "mask": args[2] is not None,
                "device_ms": (turns[0] + turns[3]) / 2,
                "other_device_ms": (turns[1] + turns[2]) / 2,
                "turns_ms": turns, "max_err": err, "agree": ok}
        line["factor"] = line["other_device_ms"] / line["device_ms"]
        t = totals[where]
        t["calls"] += 1
        t["device_ms"] += line["device_ms"]
        t["other_device_ms"] += line["other_device_ms"]
        t["slowest_factor"] = min(t.get("slowest_factor", 1e9), line["factor"])
        if name == "deform_conv_backward":
            line["split_ms"] = deform_split(kernel_split_ms(lambda: run(ours, *args)))
            line["other_split_ms"] = deform_split(
                kernel_split_ms(lambda: run(theirs, *args)))
            for tag in ("split_ms", "other_split_ms"):
                for k, v in line[tag].items():
                    t[f"{tag}:{k}"] += v
        print(json.dumps(line), flush=True)
        ok_all &= ok
    for where, t in totals.items():
        print(json.dumps({"kernel": name, "path": where, "summed_over_calls": {
            **t, "factor": t["other_device_ms"] / t["device_ms"]}}), flush=True)
    return ok_all


def compare_dir(names, our_libs, their_libs, calls) -> bool:
    """Every kernel in ``names`` against the other version in
    ``their_libs``, on the recorded ``calls``; one JSON line per call.
    Returns whether every call agreed."""
    failed = False
    for name in names:
        ours, theirs = our_libs[name], their_libs[name]
        if name in FLASH:
            compare = (compare_flash_forward if name == "flash_attention"
                       else compare_flash)
            failed |= not compare(ours, theirs, calls[name])
            continue
        run = RUNNERS[name]
        if name in DEFORM:
            failed |= not compare_deform(name, ours, theirs, calls[name])
            continue
        for i, (where, args) in enumerate(calls[name]):
            got, want = run(ours, *args), run(theirs, *args)
            torch.cuda.synchronize()
            if name in ("nms", "nms_rowscan"):
                err = float((got.int() - want.int()).abs().max())
                ok = err == 0
            else:
                err = float((got - want).abs().max()
                            / want.abs().max().clamp(min=1e-30))
                ok = err <= 1e-5
            turns = [device_ms(lambda lib=lib: run(lib, *args))
                     for lib in (ours, theirs, theirs, ours)]
            extra = {}
            if name in BACKWARD:
                extra = {"path": where, "dtype": str(args[0].dtype)[6:],
                         "kernels_ms": kernel_split_ms(lambda: run(ours, *args)),
                         "other_kernels_ms": kernel_split_ms(
                             lambda: run(theirs, *args))}
                if name == "roi_align_backward":
                    extra.update(map=list(args[2]), rois=args[1].shape[0],
                                 call=i)
                else:
                    extra.update(rois=args[0].shape[0], pyramid=list(args[5]))
            elif name == "window_pool":
                extra = window_stats(*args)
            elif name == "roi_align":
                extra = {"map": list(args[0].shape), "rois": args[1].shape[0],
                         "sampling_ratio": args[4], "aligned": args[5],
                         "case": f"level {i}" if i < len(calls[name]) - 2
                         else "extra"}
            else:
                for tag, lib in (("", ours), ("other_", theirs)):
                    for t in (-1.0, 2.0):
                        extra[f"{tag}device_ms_thr_{t:g}"] = device_ms(
                            lambda t=t, lib=lib: run(lib, args[0], args[1], t))
                if name == "nms":
                    extra["kernels_ms"] = kernel_split_ms(
                        lambda: run(ours, *args))
                    extra["other_kernels_ms"] = kernel_split_ms(
                        lambda: run(theirs, *args))
            print(json.dumps({
                "kernel": name, "other_f32_only": theirs.f32_only,
                "shape": [list(a.shape) for a in args[:2]],
                "device_ms": (turns[0] + turns[3]) / 2,
                "other_device_ms": (turns[1] + turns[2]) / 2,
                "turns_ms": turns, "max_err": err, "agree": ok, **extra}),
                flush=True)
            failed |= not ok
    return not failed


def main() -> int:
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    others = [Path(a).resolve() for a in sys.argv[1:]]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    by_dir = {o: [n for n in KERNELS if (o / _kernels._KERNELS[n][0]).exists()]
              for o in others}
    empty = [str(o) for o, ns in by_dir.items() if not ns]
    if empty:
        print(f"no kernel source in {empty}", file=sys.stderr)
        return 2
    names = [n for n in KERNELS if any(n in ns for ns in by_dir.values())]
    ours = {n: _kernels.load(n) for n in names}
    pairs = [(o, n) for o, ns in by_dir.items() for n in ns]
    with ThreadPoolExecutor(len(pairs)) as pool:
        built = dict(zip(pairs, pool.map(lambda p: build_other(p[1], p[0]),
                                         pairs)))
    calls = {}
    if any(n not in BACKWARD + DEFORM + FLASH for n in names):
        calls.update({n: [("forward", a) for a in c]
                      for n, c in record_inputs().items()})
    if any(n in BACKWARD for n in names):
        calls.update(record_backward_inputs())
    if any(n in DEFORM for n in names):
        calls.update(record_deform_inputs())
    if any(n in FLASH for n in names):
        calls.update(record_flash_inputs(names))
    failed = False
    for other, dir_names in by_dir.items():
        print(json.dumps({"other_dir": str(other)}), flush=True)
        failed |= not compare_dir(dir_names, ours, {n: built[other, n]
                                                    for n in dir_names}, calls)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
