#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the seven CUDA kernels of ``vision_tpu_torch`` from ``csrc/`` and
drives the port's two main paths at full width, TF32 off, seeded random
weights:

* Faster R-CNN ResNet-50-FPN inference (91 classes, one 832x832 f32 image)
  through ``fasterrcnn_resnet50_fpn``: the bitmask NMS, window-pool and
  RoIAlign kernels; once more with ``VISION_TPU_NMS_KERNEL=rowscan``, which
  must give the same detections through the row-serial NMS kernel;
* ResNet-50 classification (1000 classes, a batch of 32 224x224 images):
  one eval batch, then SGD steps of ``get_model("resnet50", fused_bn=True)``
  under ``make_train_step`` in f32 and in bf16, through the ``matmul_stats``
  kernels (36 launches a forward): the pipelined FP32 kernel in f32, the
  ``wgmma`` kernel in bf16, and never the guarded general kernel, which one
  more f32 step drives with its wrapper swapped in.

Every kernel is held against its plain PyTorch version on the card at the
inputs the model gave it, and each path's result against a run of the same
model through the plain versions. The counts of launches are set to 0 just
before each path is driven and read just after; a kernel that its path did
not launch fails the run.

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
import math
import os
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
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
BATCH = 32  # ResNet-50 phases: [BATCH, 3, 224, 224]
LR = 0.1  # SGD, momentum 0.9, weight decay 1e-4
# The first step's loss, logits and statistics are held to 1e-3 and 1e-4.
# The later losses follow an SGD update, and the f32 gradient of this model
# at its random initialisation is itself 2-3% away from a float64 gradient
# on every path, the standard cuDNN one included
# (vision_tpu_torch/tools/grad_noise_resnet.py), so two correct f32 paths
# part by up to ~1% in loss after one update at this learning rate.
LATER_LOSS_TOL = 5e-2
MM_CALLS_PER_FORWARD = 36  # 2 per Bottleneck + 4 downsamples
SPIN_CYCLES = 30_000_000  # ~17 ms of a spin kernel, see device_ms
NMS_OPS_PER_PAIR = 14  # 2x(min, max, sub, max0), mul, add, sub, >0, div, >thr


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(nbytes: float, ops: float, peak_flops: float = PEAK_F32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, launches: int = 20, warmup: int = 2) -> float:
    """Device time of one call: CUDA events around ``launches`` calls that
    run back to back, over their number. The calls are queued while the
    card is held busy by a spin kernel of some 17 ms, so the host's
    share of a call (Python, allocation, launch latency) stays outside the
    events even where it is longer than the kernel."""
    import torch

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
    """The kernel wrappers of the main paths, their plain versions, and a
    way to record their inputs or swap the plain versions in.
    ``matmul_stats`` is the wrapper that chooses among three kernels; each
    of the three is counted under its own name as well."""

    def __init__(self):
        # import_module: ``vision_tpu_torch.ops`` re-exports functions
        # named ``nms`` and ``roi_align`` over their module names
        nms = importlib.import_module("vision_tpu_torch.ops.nms")
        poolers = importlib.import_module("vision_tpu_torch.ops.poolers")
        roi_align = importlib.import_module("vision_tpu_torch.ops.roi_align")
        conv1x1 = importlib.import_module("vision_tpu_torch.ops._conv1x1_bn")

        # name -> (module, wrapper attribute, plain version)
        self.table = {
            "nms": (nms, "nms_keep_sorted_cuda", nms.nms_keep_sorted_plain),
            "window_pool": (poolers, "window_pool_cuda",
                            poolers.window_pool_plain),
            "roi_align": (roi_align, "roi_align_cuda",
                          roi_align.roi_align_plain),
            "matmul_stats": (conv1x1, "matmul_stats_cuda",
                             conv1x1.matmul_stats_plain),
            "nms_rowscan": (nms, "nms_keep_sorted_rowscan_cuda",
                            nms.nms_keep_sorted_plain),
        }
        self.cuda = {n: getattr(m, a) for n, (m, a, _) in self.table.items()}
        self.plain = {n: p for n, (_, _, p) in self.table.items()}
        self.counted = dict(
            self.cuda,
            matmul_stats_fma=conv1x1.matmul_stats_fma_cuda,
            matmul_stats_wgmma=conv1x1.matmul_stats_wgmma_cuda,
            matmul_stats_general=conv1x1.matmul_stats_general_cuda)

    def reset(self) -> None:
        for fn in self.counted.values():
            fn.launches = 0

    def launches(self) -> dict:
        return {n: fn.launches for n, fn in self.counted.items()}

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

    def recording(self, calls: dict, counts: dict = None):
        """Record (a copy of) the positional arguments of every call. Of
        ``matmul_stats`` only the first call of each distinct (shapes,
        prologue, type) is kept, and ``counts`` says how often each came."""
        def make(name, fn):
            def rec(*args):
                if name == "matmul_stats":
                    key = matmul_key(args)
                    counts[key] = counts.get(key, 0) + 1
                    if counts[key] > 1:
                        return fn(*args)
                calls.setdefault(name, []).append(
                    [a.clone() if hasattr(a, "clone") else a for a in args])
                return fn(*args)
            return rec
        return self.swapped(make)

    def plain_versions(self):
        return self.swapped(lambda name, fn: self.plain[name])


def matmul_key(args):
    x, w = args[:2]
    prologue = len(args) > 2 and args[2] is not None
    return (tuple(x.shape), tuple(w.shape), prologue, str(x.dtype))


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


def matmul_work(args):
    """Bytes: x, w (and scale, shift) read once, y, s1, s2 written once.
    Operations: 2*M*K*N, against the peak of the operands' type."""
    import torch

    x, w = args[:2]
    m, k = x.shape
    n = w.shape[1]
    nbytes = (m * k + k * n + m * n) * x.element_size() + 2 * n * 4
    if matmul_key(args)[2]:
        nbytes += 2 * k * 4
    peak = PEAK_BF16_FLOPS if x.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    return nbytes, 2.0 * m * k * n, peak


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
    # the plain bf16 products keep their f32 sums whole, as the kernel does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    os.environ.pop("VISION_TPU_NMS_KERNEL", None)

    kernels = Kernels()
    rows = faster_rcnn_phases(kernels)
    rows += resnet50_phases(kernels)

    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def require_launched(launches: dict, names, path: str) -> None:
    missing = [n for n in names if launches[n] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the {path} path: {missing}")


def faster_rcnn_phases(kernels):
    """Faster R-CNN inference through the bitmask NMS, window-pool and
    RoIAlign kernels, then once more through the row-serial NMS kernel."""
    import torch

    from vision_tpu_torch.models import get_model

    model = get_model("fasterrcnn_resnet50_fpn", seed=0)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.weight.mul_(CLS_SCALE)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(1, 3, SIZE, SIZE, generator=gen).cuda()
    emit("model", name="fasterrcnn_resnet50_fpn", classes=91,
         params=sum(p.numel() for p in model.parameters()), input=[1, 3, SIZE, SIZE],
         dtype="float32", seed=0, cls_scale=CLS_SCALE,
         matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_tf32=torch.backends.cudnn.allow_tf32)

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
        require_launched(launches, ("nms", "window_pool", "roi_align"),
                         "Faster R-CNN")

        with kernels.plain_versions():
            ref = model(images)
        torch.cuda.synchronize()
        check_detections(dets, ref)

        rows = kernel_phases(kernels, calls, launches)
        rows.append(rowscan_phase(kernels, model, images, dets))
    return rows


def rowscan_phase(kernels, model, images, dets):
    """The same forward with ``VISION_TPU_NMS_KERNEL=rowscan``: the same
    detections to the last bit, through ``nms_rowscan``."""
    import torch

    calls: dict = {}
    os.environ["VISION_TPU_NMS_KERNEL"] = "rowscan"
    try:
        kernels.reset()
        with kernels.recording(calls):
            t = time.perf_counter()
            got = model(images)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        launches = kernels.launches()
    finally:
        del os.environ["VISION_TPU_NMS_KERNEL"]
    valid = dets.valid
    same = {
        "valid": bool(torch.equal(got.valid, valid)),
        "labels": bool(torch.equal(got.labels[valid], dets.labels[valid])),
        "scores": bool(torch.equal(got.scores[valid], dets.scores[valid])),
        "boxes": bool(torch.equal(got.boxes[valid], dets.boxes[valid])),
    }
    emit("faster_rcnn_rowscan", ms_per_img=ms, launches=launches,
         valid=int(valid.sum()), equal_to_bitmask_run=same, tol=0.0)
    require_launched(launches, ("nms_rowscan", "window_pool", "roi_align"),
                     "Faster R-CNN (rowscan)")
    if launches["nms_rowscan"] != 2 or launches["nms"] != 0:
        raise RuntimeError(f"rowscan forward launched {launches}: expected 2 "
                           "nms_rowscan and no bitmask nms")
    if not all(same.values()):
        raise RuntimeError(f"rowscan detections differ from the bitmask run's: {same}")

    fn, plain = kernels.cuda["nms_rowscan"], kernels.plain["nms_rowscan"]
    cases = []
    for args in calls["nms_rowscan"]:
        err, rel, k_ms, plain_ms = compare_kernel(fn, plain, args, exact=True)
        b_ms, b_by = bound_ms(*nms_work(args))
        case = dict(kernel="nms_rowscan", shape=list(args[1].shape),
                    max_abs_err=err, max_rel_err=rel, rel_tol=0.0, ms=k_ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        emit("kernel_case", **case)
        cases.append(case)
        if err > 0:
            raise RuntimeError("nms_rowscan disagrees with its plain version")
    return {
        "name": "nms_rowscan", "route": "cuda",
        "source": "vision_tpu_torch/csrc/nms_rowscan.cu",
        "replaces": "vision_tpu/ops/_pallas/nms.py:252",
        "launches": launches["nms_rowscan"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": sum(c["ms"] for c in cases),
        "plain_ms": sum(c["plain_ms"] for c in cases),
        "bound_ms": sum(c["bound_ms"] for c in cases),
        "bound_by": cases[0]["bound_by"],
        "library_ms": None,
        "calls_per_forward": len(cases),
    }


def train_steps(batch, *, fused, dtype, steps, first_step=None, lr=LR):
    """A fresh seeded ResNet-50 and ``steps`` SGD steps on ``batch``. Returns
    the losses, the first step's logits, the running statistics after the
    first step, and each step's wall ms (the loss is read back, so a step
    ends when the device has finished it)."""
    import torch

    from vision_tpu_torch.models import get_model
    from vision_tpu_torch.parallel import make_train_step

    model = get_model("resnet50", fused_bn=fused, seed=0)
    optimizer = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9,
                                weight_decay=1e-4)
    step = make_train_step(model, optimizer, compute_dtype=dtype)
    logits = []
    hook = model.register_forward_hook(
        lambda mod, args, out: logits.append(out.detach().float().clone()))
    out = {"losses": [], "ms": [], "fused": fused,
           "dtype": "float32" if dtype is None else str(dtype)[6:]}
    for i in range(steps):
        ctx = first_step() if i == 0 and first_step else contextlib.nullcontext()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with ctx:
            loss = float(step(batch)["loss"])
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["losses"].append(loss)
        if i == 0:
            out["stats"] = {n: b.clone() for n, b in model.named_buffers()
                            if "running" in n}
    hook.remove()
    out["logits"] = logits[0]
    out["ms_per_step"] = statistics.median(out["ms"][1:]) if steps > 1 else None
    return out


def speed(run) -> dict:
    ms = run["ms_per_step"]
    return {"fused_bn": run["fused"], "dtype": run["dtype"], "ms_per_step": ms,
            "images_per_s": BATCH / ms * 1e3, "ms_all": run["ms"]}


def resnet50_phases(kernels):
    """ResNet-50: one eval batch; three f32 SGD steps with ``fused_bn=True``
    through the FP32 ``matmul_stats`` kernel against the same steps through
    the plain version (first step: loss and logits within 1e-3, running
    statistics within 1e-4 of each tensor's largest value; later losses
    within ``LATER_LOSS_TOL``); one f32 step through the general kernel; the
    bf16 step timed, through the ``wgmma`` kernel, its first loss within
    2e-2 of the plain path's; the kernels' cases."""
    import torch

    from vision_tpu_torch.models import get_model

    gen = torch.Generator().manual_seed(2)
    batch = {
        "image": torch.randn(BATCH, 3, 224, 224, generator=gen).cuda(),
        "label": torch.randint(0, 1000, (BATCH,), generator=gen).cuda(),
    }

    model = get_model("resnet50", seed=0)
    params = sum(p.numel() for p in model.parameters())
    times = []
    with torch.inference_mode():
        for _ in range(1 + TIMED_FORWARDS):
            t = time.perf_counter()
            logits = model(batch["image"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    finite = bool(torch.isfinite(logits).all())
    emit("resnet50_eval", params=params, input=[BATCH, 3, 224, 224],
         dtype="float32", shape=list(logits.shape), finite=finite,
         ms_per_batch_median=statistics.median(times[1:]), ms_all=times)
    if params != 25_557_032 or tuple(logits.shape) != (BATCH, 1000) or not finite:
        raise RuntimeError("resnet50 eval: wrong parameter count, shape or "
                           "non-finite logits")
    del model, logits

    # f32: the kernel path against the plain path, step by step
    calls, counts = {}, {}
    kernels.reset()
    run = train_steps(batch, fused=True, dtype=None, steps=3,
                      first_step=lambda: kernels.recording(calls, counts))
    launches = kernels.launches()
    with kernels.plain_versions():
        ref = train_steps(batch, fused=True, dtype=None, steps=3)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"])]
    logit_rel = float((run["logits"] - ref["logits"]).abs().max()
                      / ref["logits"].abs().max())
    stats_rel = max(
        float((run["stats"][n] - r).abs().max() / r.abs().max().clamp(min=1e-30))
        for n, r in ref["stats"].items())
    emit("resnet50_train_f32", steps=3, batch=BATCH, lr=LR,
         losses=run["losses"], plain_losses=ref["losses"],
         loss_rel_err=loss_rel, first_loss_tol=1e-3,
         later_loss_tol=LATER_LOSS_TOL,
         first_logits_rel_err=logit_rel, logits_tol=1e-3,
         running_stats_rel_err=stats_rel, stats_tol=1e-4,
         launches=launches, matmul_stats_calls_per_forward=sum(counts.values()))
    require_launched(launches, ("matmul_stats", "matmul_stats_fma"),
                     "ResNet-50 train (f32)")
    require_only(launches, "matmul_stats_fma", 3 * MM_CALLS_PER_FORWARD,
                 "3 f32 steps")
    if not all(math.isfinite(v) for v in run["losses"]):
        raise RuntimeError(f"non-finite loss: {run['losses']}")
    if run["losses"][2] == run["losses"][0]:
        raise RuntimeError("the third loss equals the first: no update happened")
    if (loss_rel[0] > 1e-3 or max(loss_rel[1:]) > LATER_LOSS_TOL
            or logit_rel > 1e-3 or stats_rel > 1e-4):
        raise RuntimeError("the kernel train path disagrees with the plain path")
    first_loss = run["losses"][0]
    del run, ref
    torch.cuda.empty_cache()
    launches_general = general_kernel_phase(kernels, batch, first_loss)

    # bf16: the timed step, and its first loss against the plain path's
    calls16, counts16 = {}, {}
    kernels.reset()
    run16 = train_steps(batch, fused=True, dtype=torch.bfloat16,
                        steps=1 + TIMED_FORWARDS,
                        first_step=lambda: kernels.recording(calls16, counts16))
    launches16 = kernels.launches()
    with kernels.plain_versions():
        ref16 = train_steps(batch, fused=True, dtype=torch.bfloat16, steps=1)
    rel16 = abs(run16["losses"][0] - ref16["losses"][0]) / abs(ref16["losses"][0])
    emit("resnet50_train_bf16", batch=BATCH, lr=LR, **speed(run16),
         losses=run16["losses"], plain_first_loss=ref16["losses"][0],
         first_loss_rel_err=rel16, loss_tol=2e-2, launches=launches16)
    require_launched(launches16, ("matmul_stats", "matmul_stats_wgmma"),
                     "ResNet-50 train (bf16)")
    require_only(launches16, "matmul_stats_wgmma",
                 (1 + TIMED_FORWARDS) * MM_CALLS_PER_FORWARD,
                 f"{1 + TIMED_FORWARDS} bf16 steps")
    if not all(math.isfinite(v) for v in run16["losses"]) or rel16 > 2e-2:
        raise RuntimeError("bf16 train path: non-finite loss or first loss "
                           "away from the plain path's")
    del run16, ref16
    torch.cuda.empty_cache()

    # the step's speed in the other three settings, for the record
    for fused, dtype in ((False, torch.bfloat16), (True, None), (False, None)):
        emit("resnet50_train_speed", batch=BATCH, **speed(train_steps(
            batch, fused=fused, dtype=dtype, steps=1 + TIMED_FORWARDS)))
        torch.cuda.empty_cache()

    return matmul_stats_rows(kernels, calls, counts, calls16, counts16,
                             {"fma": launches["matmul_stats_fma"],
                              "wgmma": launches16["matmul_stats_wgmma"],
                              "general": launches_general})


def require_only(launches: dict, name: str, want: int, what: str) -> None:
    """Every ``matmul_stats`` call of the run went to kernel ``name``."""
    got = {n: launches[n] for n in ("matmul_stats", "matmul_stats_fma",
                                    "matmul_stats_wgmma", "matmul_stats_general")}
    if got["matmul_stats"] != want or got[name] != want:
        raise RuntimeError(f"{what}: expected {want} matmul_stats launches, "
                           f"all through {name}, got {got}")
    if got["matmul_stats_general"] != 0:
        raise RuntimeError(f"{what}: the ResNet-50 path launched the general "
                           f"kernel: {got}")


def general_kernel_phase(kernels, batch, first_loss) -> int:
    """One f32 SGD step with the general kernel's wrapper in the place of
    the choosing one: all 36 products through the guarded kernel of
    ``matmul_stats.cu``, the loss within 1e-3 of the default path's first."""
    general = kernels.counted["matmul_stats_general"]
    kernels.reset()
    with kernels.swapped(lambda name, fn: general if name == "matmul_stats" else fn):
        run = train_steps(batch, fused=True, dtype=None, steps=1)
    launches = kernels.launches()
    rel = abs(run["losses"][0] - first_loss) / abs(first_loss)
    emit("resnet50_train_general_kernel", steps=1, batch=BATCH,
         loss=run["losses"][0], default_path_loss=first_loss, loss_rel_err=rel,
         loss_tol=1e-3, launches=launches)
    require_launched(launches, ("matmul_stats_general",),
                     "ResNet-50 train (general kernel)")
    if (launches["matmul_stats_general"] != MM_CALLS_PER_FORWARD
            or launches["matmul_stats_fma"] or launches["matmul_stats_wgmma"]):
        raise RuntimeError(f"the forced general step launched {launches}")
    if not rel <= 1e-3:
        raise RuntimeError("the general kernel's step disagrees with the "
                           "default path's")
    return launches["matmul_stats_general"]


def rel_errs(got, want):
    return [float((g.float() - w.float()).abs().max()
                  / w.float().abs().max().clamp(min=1e-30))
            for g, w in zip(got, want)]


def matmul_stats_rows(kernels, calls, counts, calls16, counts16, launches):
    """The three ``matmul_stats`` kernels against the plain version at every
    distinct (shapes, prologue, type) the two train runs gave the wrapper:
    the f32 cases through the FP32 kernel, the bf16 cases through the
    ``wgmma`` kernel, and the general kernel at all of them. ``y`` within
    1e-4 of its largest value in f32 and within one bf16 step in bf16 (a
    step is 2**-8 to 2**-7 of the value it rounds, so 2**-7 of the largest);
    the sums within 1e-4 of their largest; a second call on the same inputs
    equal to the first bit for bit.

    Times per forward: each case's time multiplied by its calls in one
    forward. ``ms`` is the median of single wrapper calls (Python, the
    allocations and the launch latency included), ``device_ms`` a run of 20
    calls back to back over 20, taken in turns with the general kernel's
    (new, general, general, new). ``product_ms`` is one ``torch.matmul`` of
    the same operands: a reference that computes less (no prologue, no
    sums), so it is no ``library_ms``."""
    import torch

    from vision_tpu_torch.ops._conv1x1_bn import choose_kernel

    plain = kernels.plain["matmul_stats"]
    general = kernels.counted["matmul_stats_general"]
    keys = ("ms", "device_ms", "general_ms", "general_device_ms", "plain_ms",
            "product_ms", "bound_ms", "bytes", "operations")
    totals = {}
    worst = {"fma": 0.0, "wgmma": 0.0, "general_f32": 0.0, "general_bf16": 0.0}
    slower = []
    for tag, name, recorded, count in (("f32", "fma", calls, counts),
                                       ("bf16", "wgmma", calls16, counts16)):
        fn = kernels.counted[f"matmul_stats_{name}"]
        y_tol = 1e-4 if tag == "f32" else 2.0 ** -7
        sums = dict.fromkeys(keys, 0.0)
        for args in recorded["matmul_stats"]:
            key = matmul_key(args)
            x, w = args[:2]
            chosen = choose_kernel(x.shape[0], x.shape[1], w.shape[1], x.dtype,
                                   w.stride())
            if chosen != name:
                raise RuntimeError(f"matmul_stats {key} goes to {chosen}")
            got, again, want = fn(*args), fn(*args), plain(*args)
            got_g = general(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            rel, rel_g = rel_errs(got, want), rel_errs(got_g, want)
            err = float((got[0].float() - want[0].float()).abs().max())
            err_g = float((got_g[0].float() - want[0].float()).abs().max())
            t = dict(
                ms=cuda_ms(lambda: fn(*args)),
                general_ms=cuda_ms(lambda: general(*args)),
                plain_ms=cuda_ms(lambda: plain(*args), reps=5, warmup=1),
                product_ms=device_ms(lambda: torch.matmul(x, w)))
            turns = [device_ms(f) for f in (
                lambda: fn(*args), lambda: general(*args),
                lambda: general(*args), lambda: fn(*args))]
            t["device_ms"] = (turns[0] + turns[3]) / 2
            t["general_device_ms"] = (turns[1] + turns[2]) / 2
            b_ms, b_by = bound_ms(*matmul_work(args))
            emit("kernel_case", kernel=f"matmul_stats_{name}", x=list(key[0]),
                 w=list(key[1]), w_strides=list(w.stride()), prologue=key[2],
                 dtype=tag, calls_per_forward=count[key], max_abs_err=err,
                 y_rel_err=rel[0], y_tol=y_tol, s1_rel_err=rel[1],
                 s2_rel_err=rel[2], s_tol=1e-4, same_bits_twice=same,
                 general_y_rel_err=rel_g[0], general_s1_rel_err=rel_g[1],
                 general_s2_rel_err=rel_g[2], **t, bound_ms=b_ms,
                 bound_by=b_by)
            if rel[0] > y_tol or max(rel[1:]) > 1e-4:
                raise RuntimeError(f"matmul_stats_{name} {key} disagrees with "
                                   f"its plain version: {rel}")
            if rel_g[0] > y_tol or max(rel_g[1:]) > 1e-4:
                raise RuntimeError(f"the general matmul_stats kernel {key} "
                                   f"disagrees with its plain version: {rel_g}")
            if not same:
                raise RuntimeError(f"matmul_stats_{name} {key}: two calls on "
                                   "the same inputs differ")
            if t["device_ms"] > 1.1 * t["general_device_ms"]:
                slower.append([tag, list(key[0]), list(key[1])])
            worst[name] = max(worst[name], err)
            worst[f"general_{tag}"] = max(worst[f"general_{tag}"], err_g)
            for k, v in t.items():
                sums[k] += count[key] * v
            sums["bound_ms"] += count[key] * b_ms
            sums[b_by] += count[key] * b_ms
        totals[tag] = sums
    f32, bf16 = totals["f32"], totals["bf16"]
    emit("matmul_stats_totals", per_forward_ms=totals,
         cases_over_10pct_slower_than_general=slower)
    if bf16["device_ms"] >= bf16["general_device_ms"]:
        raise RuntimeError("the wgmma kernel is no faster than the general one")
    if f32["device_ms"] >= f32["general_device_ms"]:
        raise RuntimeError("the FP32 kernel is no faster than the general one")

    def row(name, source, sums, n_launches, err, **extra):
        by = "bytes" if sums["bytes"] >= sums["operations"] else "operations"
        return {
            "name": name, "route": "cuda",
            "source": f"vision_tpu_torch/csrc/{source}",
            "replaces": "vision_tpu/ops/_pallas/conv1x1_bn.py:134",
            "launches": n_launches, "max_abs_err": err,
            "ms": sums["ms"], "plain_ms": sums["plain_ms"],
            "bound_ms": sums["bound_ms"], "bound_by": by, "library_ms": None,
            "device_ms": sums["device_ms"], "product_ms": sums["product_ms"],
            "calls_per_forward": sum(counts.values()), **extra,
        }

    general_f32 = dict(f32, ms=f32["general_ms"],
                       device_ms=f32["general_device_ms"])
    return [
        row("matmul_stats_fma", "matmul_stats_fma.cu", f32, launches["fma"],
            worst["fma"], dtype="float32", general_ms=f32["general_ms"],
            general_device_ms=f32["general_device_ms"],
            distinct_cases=len(calls["matmul_stats"])),
        row("matmul_stats_wgmma", "matmul_stats_wgmma.cu", bf16,
            launches["wgmma"], worst["wgmma"], dtype="bfloat16",
            general_ms=bf16["general_ms"],
            general_device_ms=bf16["general_device_ms"],
            distinct_cases=len(calls16["matmul_stats"])),
        # the guarded kernel, at the f32 cases (its bf16 times beside them)
        row("matmul_stats", "matmul_stats.cu", general_f32,
            launches["general"], worst["general_f32"], dtype="float32",
            max_abs_err_bf16=worst["general_bf16"],
            ms_bf16=bf16["general_ms"], device_ms_bf16=bf16["general_device_ms"],
            plain_ms_bf16=bf16["plain_ms"], bound_ms_bf16=bf16["bound_ms"]),
    ]


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
