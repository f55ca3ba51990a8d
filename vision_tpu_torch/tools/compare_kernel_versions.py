"""Time another version of the NMS, RoIAlign and window-pool kernels against
the package's own, in one process on one card, on the inputs that the
Faster R-CNN forward of ``chip_smoke.py`` gives them.

    python -m vision_tpu_torch.tools.compare_kernel_versions OTHER_DIR

``OTHER_DIR`` holds some of ``nms.cu``, ``roi_align.cu``, ``nms_rowscan.cu``
and ``window_pool.cu``, with the same C entry points as ``csrc/`` (for
example the files of an earlier commit, unpacked with ``git archive``);
each kernel whose source is there is compared. They are built with the
package's own ``nvcc`` flags into ``OTHER_DIR/build``. The model (seeded
random weights, ``cls_score`` x30, one seeded 832x832 image, TF32 off)
runs once as it is, recording the inputs of the bitmask NMS, RoIAlign and
window-pool wrappers, and once under ``VISION_TPU_NMS_KERNEL=rowscan``,
recording the row-serial NMS's. RoIAlign gets two more cases on the P2
call's map and RoIs: ``aligned=True``, and the adaptive grid
(``sampling_ratio=0``).

For each recorded call, the two versions' outputs are compared (NMS masks
bit for bit, RoIAlign and the window pool within 1e-5 of the largest
value) and each version's device time is taken in turns (package, other,
other, package): 20 calls queued behind a spin kernel, over 20. Each NMS
kernel is also timed on the same boxes at thresholds -1 (every box after
a row's first is suppressed: what the chain costs with no tests left) and
2 (every valid box is kept: the most tests), and the bitmask NMS's device
time is split by kernel (its mask pass and its scan) with
``torch.profiler``. One JSON line per call, then the card's name and power
limit. Needs a CUDA device and ``nvcc``.
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
KERNELS = ("nms", "roi_align", "nms_rowscan", "window_pool")


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


def build_other(name: str, other: Path) -> ctypes.CDLL:
    source, extra, functions = _kernels._KERNELS[name]
    out = other / "build" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_kernels._nvcc(), *_kernels._NVCC_FLAGS, *extra, "-o",
                    str(out), str(other / source)], check=True)
    lib = ctypes.CDLL(str(out))
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


RUNNERS = {"nms": nms, "roi_align": roi_align, "nms_rowscan": rowscan,
           "window_pool": window_pool}


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
    calls = record_inputs()
    failed = False
    for name in names:
        run = RUNNERS[name]
        ours, theirs = libs[name]
        for i, args in enumerate(calls[name]):
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
            if name == "window_pool":
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
                "kernel": name, "shape": [list(a.shape) for a in args[:2]],
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
