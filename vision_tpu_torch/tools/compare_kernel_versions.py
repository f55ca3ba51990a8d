"""Time another version of the NMS, RoIAlign and window-pool kernels, and
of the two backward kernels, against the package's own, in one process on
one card, on the inputs that ``chip_smoke.py``'s paths give them.

    python -m vision_tpu_torch.tools.compare_kernel_versions OTHER_DIR

``OTHER_DIR`` holds some of ``nms.cu``, ``roi_align.cu``, ``nms_rowscan.cu``,
``window_pool.cu``, ``window_pool_backward.cu`` and ``roi_align_backward.cu``
(for example the files of an earlier commit, unpacked with ``git
archive``); each kernel whose source is there is compared. They are built
with the package's own ``nvcc`` flags into ``OTHER_DIR/build``. The forward
kernels keep the package's C entry points; a backward source may also have
the f32-only entry points without the ``bf16`` flag (and, for RoIAlign,
without the scratch function) that the backward kernels had before their
bf16 variants, told apart by the source's own text.

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
other kernels, and the wrapper's sort) with ``torch.profiler``. One JSON
line per call, then the card's name and power limit. Needs a CUDA device
and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import re
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch

from vision_tpu_torch import _kernels
from vision_tpu_torch.models import get_model

SPIN_CYCLES = 30_000_000  # ~17 ms: the timed calls queue behind it
CLS_SCALE = 30.0
SIZE = 832
KERNELS = ("nms", "roi_align", "nms_rowscan", "window_pool",
           "window_pool_backward", "roi_align_backward")
BACKWARD = ("window_pool_backward", "roi_align_backward")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
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


def build_other(name: str, other: Path) -> ctypes.CDLL:
    source, extra, functions = _kernels._KERNELS[name]
    out = other / "build" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_kernels._nvcc(), *_kernels._NVCC_FLAGS, *extra, "-o",
                    str(out), str(other / source)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.f32_only = f32_only(name, other / source)
    if lib.f32_only:
        functions = _F32_ONLY[name]
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


RUNNERS = {"nms": nms, "roi_align": roi_align, "nms_rowscan": rowscan,
           "window_pool": window_pool,
           "window_pool_backward": window_pool_backward,
           "roi_align_backward": roi_align_backward}


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


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = [n for n in KERNELS if (other / _kernels._KERNELS[n][0]).exists()]
    if not names:
        print(f"no kernel source in {other}", file=sys.stderr)
        return 2
    libs = {n: (_kernels.load(n), build_other(n, other)) for n in names}
    calls = {}
    if any(n not in BACKWARD for n in names):
        calls.update({n: [("forward", a) for a in c]
                      for n, c in record_inputs().items()})
    if any(n in BACKWARD for n in names):
        calls.update(record_backward_inputs())
    failed = False
    for name in names:
        run = RUNNERS[name]
        ours, theirs = libs[name]
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
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
