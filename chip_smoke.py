#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``vision_tpu_torch`` from ``csrc/``, runs
Faster R-CNN ResNet-50-FPN inference (91 classes, seeded random weights,
one 832x832 f32 image, TF32 off) through ``fasterrcnn_resnet50_fpn``,
holds every kernel against its plain PyTorch version on the card at the
inputs the model gave it, and holds the model's detections against a
run of the same model through the plain versions.

Each phase prints one JSON line as it ends. Then come the card's name and
power limit as ``nvidia-smi`` reports them, the per-kernel JSON line, and
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that last line; so does a machine without CUDA, or a directory
without the package.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIZE = 832
TIMED_FORWARDS = 5
# The random box predictor gives near-uniform softmax over 91 classes
# (~0.011 < the 0.05 score threshold); scaling cls_score spreads the
# scores so that some detections pass and the comparison is not vacuous.
CLS_SCALE = 30.0
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
NMS_OPS_PER_PAIR = 14  # 2x(min, max, sub, max0), mul, add, sub, >0, div, >thr


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` single calls, CUDA events around each."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Kernels:
    """The three kernel wrappers of the main path, their plain versions,
    and a way to record their inputs or swap the plain versions in."""

    def __init__(self):
        # import_module: ``vision_tpu_torch.ops`` re-exports functions
        # named ``nms`` and ``roi_align`` over their module names
        nms = importlib.import_module("vision_tpu_torch.ops.nms")
        poolers = importlib.import_module("vision_tpu_torch.ops.poolers")
        roi_align = importlib.import_module("vision_tpu_torch.ops.roi_align")

        # name -> (module, wrapper attribute, plain version)
        self.table = {
            "nms": (nms, "nms_keep_sorted_cuda", nms.nms_keep_sorted_plain),
            "window_pool": (poolers, "window_pool_cuda",
                            poolers.window_pool_plain),
            "roi_align": (roi_align, "roi_align_cuda",
                          roi_align.roi_align_plain),
        }
        self.cuda = {n: getattr(m, a) for n, (m, a, _) in self.table.items()}
        self.plain = {n: p for n, (_, _, p) in self.table.items()}

    def reset(self) -> None:
        for fn in self.cuda.values():
            fn.launches = 0

    def launches(self) -> dict:
        return {n: fn.launches for n, fn in self.cuda.items()}

    @contextlib.contextmanager
    def swapped(self, make):
        """Replace each wrapper, where the path looks it up, by
        ``make(name, wrapper)``."""
        try:
            for n, (mod, attr, _) in self.table.items():
                setattr(mod, attr, make(n, self.cuda[n]))
            yield
        finally:
            for n, (mod, attr, _) in self.table.items():
                setattr(mod, attr, self.cuda[n])

    def recording(self, calls: dict):
        """Record (a copy of) the positional arguments of every call."""
        def make(name, fn):
            def rec(*args):
                calls.setdefault(name, []).append(
                    [a.clone() if hasattr(a, "clone") else a for a in args])
                return fn(*args)
            return rec
        return self.swapped(make)

    def plain_versions(self):
        return self.swapped(lambda name, fn: self.plain[name])


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def nms_work(args):
    boxes, valid, _ = args
    b, n = valid.shape
    pairs = b * n * (n - 1) / 2
    return boxes.numel() * 4 + valid.numel() + valid.numel(), (
        pairs * NMS_OPS_PER_PAIR + 3 * b * n)


def window_work(args):
    """Bytes: the pyramid cells some window reads (rows and columns with a
    non-zero weight), the weights and origins, the output. Operations:
    the multiply-adds over those rows and columns, then over the window
    width."""
    import torch

    stacked, row0, x0, w_y, w_x = args[:5]
    k, ph, winy = w_y.shape
    _, pw, winx = w_x.shape
    r_rows, wmax, c = stacked.shape
    ynz = (w_y != 0).any(1)  # [K, winy]
    xnz = (w_x != 0).any(1)  # [K, winx]
    rows = torch.zeros(k, r_rows, dtype=torch.bool, device=stacked.device)
    cols = torch.zeros(k, wmax, dtype=torch.bool, device=stacked.device)
    rows.scatter_(1, row0.long()[:, None] + torch.arange(winy, device=rows.device), ynz)
    cols.scatter_(1, x0.long()[:, None] + torch.arange(winx, device=cols.device), xnz)
    cells = int((rows[:, :, None] & cols[:, None, :]).any(0).sum())
    nbytes = (cells * c * 4 + row0.numel() * 4 + x0.numel() * 4
              + w_y.numel() * 4 + w_x.numel() * 4 + k * c * ph * pw * 4)
    nzy = ynz.sum(1).double()
    nzx = xnz.sum(1).double()
    ops = 2 * c * float(torch.sum(ph * nzy * nzx + ph * pw * winx))
    return nbytes, ops


def _sample_lines(start, length, pooled, grid, gmax, size):
    """[K, size] bool: the rows (or columns) that some sample of each RoI
    reads, corners included, samples outside [-1, size] excluded."""
    import torch

    dev = start.device
    p = torch.arange(pooled, device=dev, dtype=torch.float32)
    i = torch.arange(gmax, device=dev, dtype=torch.float32)
    bin_ = length / pooled
    coord = (start[:, None, None] + p[None, :, None] * bin_[:, None, None]
             + (i[None, None, :] + 0.5) * (bin_ / grid)[:, None, None])
    ok = (i[None, None, :] < grid[:, None, None]) & (coord >= -1) & (coord <= size)
    c = coord.clamp(min=0)
    lo = c.long().clamp(max=size - 1)
    hi = torch.where(lo >= size - 1, lo, lo + 1)
    hits = torch.zeros(start.shape[0], size, dtype=torch.int32, device=dev)
    hits.scatter_add_(1, lo.flatten(1), ok.flatten(1).int())
    hits.scatter_add_(1, hi.flatten(1), ok.flatten(1).int())
    return hits > 0


def roi_work(args):
    """Bytes: the input pixels some sample reads (all channels), the RoIs,
    the output. Operations: per sample and channel 4 corner weights, 4
    products, 4 adds; one divide per output."""
    import torch

    inp, rois, size, scale, sr, aligned = args
    ph, pw = (size, size) if isinstance(size, int) else size
    n, c, h, w = inp.shape
    k = rois.shape[0]
    off = 0.5 if aligned else 0.0
    sw = rois[:, 1] * scale - off
    sh = rois[:, 2] * scale - off
    rw = rois[:, 3] * scale - off - sw
    rh = rois[:, 4] * scale - off - sh
    if not aligned:
        rw, rh = rw.clamp(min=1.0), rh.clamp(min=1.0)
    if sr > 0:
        gh = torch.full_like(rh, float(sr))
        gw = gh
    else:
        gh, gw = torch.ceil(rh / ph), torch.ceil(rw / pw)
    gmax_h = max(int(gh.max()), 1)
    gmax_w = max(int(gw.max()), 1)
    ys = _sample_lines(sh, rh, ph, gh, gmax_h, h)
    xs = _sample_lines(sw, rw, pw, gw, gmax_w, w)
    touched = torch.zeros(n, h, w, dtype=torch.bool, device=inp.device)
    b = rois[:, 0].long()
    for img in range(n):
        sel = b == img
        if sel.any():
            touched[img] = (ys[sel][:, :, None] & xs[sel][:, None, :]).any(0)
    nbytes = int(touched.sum()) * c * 4 + rois.numel() * 4 + k * c * ph * pw * 4
    samples = float((gh * gw).sum()) * ph * pw
    return nbytes, c * samples * 12 + k * c * ph * pw


def compare_kernel(fn, plain, args, exact=False):
    """Kernel against plain version on the same inputs: (max abs error,
    that error relative to the largest plain value, kernel ms, plain ms)."""
    import torch

    got = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    if exact:
        err = float((got.int() - want.int()).abs().max())
        rel = err
    else:
        err = float((got - want).abs().max()) if got.numel() else 0.0
        rel = err / max(float(want.abs().max()), 1e-30) if got.numel() else 0.0
    ms = cuda_ms(lambda: fn(*args))
    plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
    return err, rel, ms, plain_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "vision_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no vision_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    from vision_tpu_torch import _kernels
    from vision_tpu_torch.models import get_model

    smi = nvidia_smi()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    t0 = time.perf_counter()
    build_s = _kernels.build_all()
    emit("build", seconds=build_s, wall_s=time.perf_counter() - t0,
         dir=str(_kernels.build_dir()))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda")
    model = get_model("fasterrcnn_resnet50_fpn", seed=0)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.weight.mul_(CLS_SCALE)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(1, 3, SIZE, SIZE, generator=gen).to(dev)
    emit("model", name="fasterrcnn_resnet50_fpn", classes=91,
         params=sum(p.numel() for p in model.parameters()), input=[1, 3, SIZE, SIZE],
         dtype="float32", seed=0, cls_scale=CLS_SCALE,
         matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_tf32=torch.backends.cudnn.allow_tf32)

    kernels = Kernels()
    calls: dict = {}
    with torch.inference_mode():
        with kernels.recording(calls):
            model(images)  # warm-up; records every kernel's inputs
        torch.cuda.synchronize()
        kernels.reset()
        times = []
        for _ in range(TIMED_FORWARDS):
            t = time.perf_counter()
            dets = model(images)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        launches = kernels.launches()
        emit("faster_rcnn", ms_per_img_median=statistics.median(times),
             ms_per_img_all=times, forwards=TIMED_FORWARDS,
             launches=launches)
        missing = [n for n, c in launches.items() if c == 0]
        if missing:
            raise RuntimeError(f"kernels not launched on the main path: {missing}")

        with kernels.plain_versions():
            ref = model(images)
        torch.cuda.synchronize()
        check_detections(dets, ref)

        rows = kernel_phases(kernels, calls, launches)

    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def check_detections(dets, ref) -> None:
    import torch

    for t in dets:
        if not torch.isfinite(t.float()).all():
            raise RuntimeError("non-finite detections")
    if tuple(dets.boxes.shape) != (1, 100, 4) or tuple(dets.valid.shape) != (1, 100):
        raise RuntimeError(f"bad Detections shapes {tuple(dets.boxes.shape)}")
    valid = dets.valid
    n_valid = int(valid.sum())
    same_valid = bool(torch.equal(valid, ref.valid))
    label_ok = bool(torch.equal(dets.labels[valid], ref.labels[valid]))
    score_err = float((dets.scores[valid] - ref.scores[valid]).abs().max()) if n_valid else 0.0
    box_err = float((dets.boxes[valid] - ref.boxes[valid]).abs().max()) if n_valid else 0.0
    emit("detections_vs_plain", valid=n_valid, same_valid=same_valid,
         labels_equal=label_ok, max_score_err=score_err, score_tol=1e-4,
         max_box_err=box_err, box_tol=1e-2)
    if n_valid == 0:
        raise RuntimeError("no valid detections: the comparison is vacuous")
    if not (same_valid and label_ok and score_err <= 1e-4 and box_err <= 1e-2):
        raise RuntimeError("kernel path disagrees with the plain path")


def kernel_phases(kernels, calls, launches):
    """Each kernel against its plain version on the main path's recorded
    inputs, plus the extra RoIAlign cases (aligned, adaptive grid)."""
    rows = []
    meta = {
        "nms": ("vision_tpu_torch/csrc/nms.cu",
                "vision_tpu/ops/_pallas/nms.py:186"),
        "window_pool": ("vision_tpu_torch/csrc/window_pool.cu",
                        "vision_tpu/ops/_pallas/window_pool.py:122"),
        "roi_align": ("vision_tpu_torch/csrc/roi_align.cu",
                      "vision_tpu/ops/_pallas/roi_align.py:116"),
    }
    # relative to the largest plain value: f32 sums in another order
    tolerance = {"nms": 0.0, "window_pool": 1e-5, "roi_align": 1e-5}
    for name in ("nms", "window_pool", "roi_align"):
        fn, plain = kernels.cuda[name], kernels.plain[name]
        cases = []
        for args in calls[name]:
            if name == "nms":
                work = nms_work(args)
                shape = list(args[1].shape)
            elif name == "window_pool":
                work = window_work(args)
                shape = [list(args[3].shape), list(args[0].shape)]
            else:
                work = roi_work(args)
                shape = [list(args[0].shape), list(args[1].shape)]
            err, rel, ms, plain_ms = compare_kernel(fn, plain, args,
                                                    exact=name == "nms")
            b_ms, b_by = bound_ms(*work)
            case = dict(kernel=name, shape=shape, max_abs_err=err,
                        max_rel_err=rel, rel_tol=tolerance[name], ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            emit("kernel_case", **case)
            cases.append(case)
            if rel > tolerance[name]:
                raise RuntimeError(f"{name} disagrees with its plain version: "
                                   f"{rel} > {tolerance[name]} (relative)")
        if name == "roi_align":
            cases += roi_align_extra_cases(fn, plain, calls, tolerance[name])
        rows.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["ms"] for c in cases[: len(calls[name])]),
            "plain_ms": sum(c["plain_ms"] for c in cases[: len(calls[name])]),
            "bound_ms": sum(c["bound_ms"] for c in cases[: len(calls[name])]),
            "bound_by": cases[0]["bound_by"],
            "library_ms": None,
            "calls_per_forward": len(calls[name]),
        })
    return rows


def roi_align_extra_cases(fn, plain, calls, tol):
    """aligned=True, and the adaptive grid, on the main path's P2 map and
    RoIs."""
    out = []
    args = calls["roi_align"][0]
    inp, rois, size, scale = args[:4]
    for sr, aligned in ((2, True), (0, False)):
        a = (inp, rois, size, scale, sr, aligned)
        err, rel, ms, plain_ms = compare_kernel(fn, plain, a)
        b_ms, b_by = bound_ms(*roi_work(a))
        case = dict(kernel="roi_align", shape=[list(inp.shape), list(rois.shape)],
                    sampling_ratio=sr, aligned=aligned, max_abs_err=err,
                    max_rel_err=rel, rel_tol=tol, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by)
        emit("kernel_case", **case)
        out.append(case)
        if rel > tol:
            raise RuntimeError(f"roi_align (sr={sr}, aligned={aligned}) "
                               f"disagrees with its plain version: {err}")
    return out


if __name__ == "__main__":
    sys.exit(main())
