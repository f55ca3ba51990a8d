#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the eleven CUDA kernels of ``vision_tpu_torch`` from ``csrc/`` and
drives the port's main paths at full width, TF32 off, seeded random
weights:

* Faster R-CNN ResNet-50-FPN inference (91 classes, one 832x832 f32 image)
  through ``fasterrcnn_resnet50_fpn``: the bitmask NMS, window-pool and
  RoIAlign kernels; once more with ``VISION_TPU_NMS_KERNEL=rowscan``, which
  must give the same detections through the row-serial NMS kernel;
* the same model served from raw images: two seeded uint8 images of
  480x640 and 427x640 through the weights' ``ObjectDetection`` preset,
  ``GeneralizedRCNNTransform`` (800 / 1333, a 1344x1344 canvas, batch 2),
  the model and ``postprocess_boxes``, all on the card; in f32, then with
  ``model.to(torch.bfloat16)`` and a bf16 canvas (amp), through the bf16
  variants of the window-pool and RoIAlign kernels, its FPN maps and RPN
  head outputs held against the f32 request's;
* Faster R-CNN training on the same two images (batch 2, the 1344 canvas,
  seeded gt boxes of 4 and 7 rows padded to 8): SGD steps of
  ``make_detection_train_step`` with ``trainable_backbone_layers=3``,
  through the NMS, window-pool and RoIAlign kernels forward and the
  window-pool and RoIAlign backward kernels, held step by step against the
  same steps through the plain versions, then timed; then the same in bf16
  (``compute_dtype=torch.bfloat16``, the amp step), through the bf16
  variants of all four pooler kernels, held against the same bf16 steps
  through the plain versions and its first losses against the f32 step's;
* Mask R-CNN ResNet-50-FPN (``maskrcnn_resnet50_fpn``) served from the same
  two images in f32 and in bf16, its masks pasted into each image, and
  trained with gt masks, in f32 and in bf16; Keypoint R-CNN ResNet-50-FPN
  (``keypointrcnn_resnet50_fpn``) served in f32 and trained with gt
  keypoints: the window pool, its backward and RoIAlign at the 14x14 head
  shapes, and RoIAlign at the one-channel 28x28 mask targets;
* the deform-trunk Mask R-CNN (``maskrcnn_resnet50_fpn_deform``, deformable
  3x3s in C3-C5, 13 a forward) served from the same two images in f32 and
  in bf16 and trained in f32 and in bf16, with its offset predictors drawn
  from a seeded normal (offsets of RMS ~1.5 px, some samples outside their
  maps): the deformable convolution's column kernel and its backward
  kernels, at each distinct shape of the path;
* ResNet-50 classification (1000 classes, a batch of 32 224x224 images):
  one eval batch, one batch of 8 uint8 375x500 images through the weights'
  ``ImageClassification`` preset against the CPU, then SGD steps of
  ``get_model("resnet50", fused_bn=True)`` under ``make_train_step`` in f32
  and in bf16, through the ``matmul_stats`` kernels (36 launches a
  forward): the pipelined FP32 kernel in f32, the ``wgmma`` kernel in bf16,
  and never the guarded general kernel, which one more f32 step drives
  with its wrapper swapped in.

Every kernel is held against its plain PyTorch version on the card at the
inputs the model gave it, and each path's result against a run of the same
model through the plain versions. The counts of launches are set to 0 just
before each path is driven and read just after; a kernel that its path did
not launch fails the run.

Each phase prints one JSON line as it ends; every kernel case carries its
wrapper-clock ``ms`` (median of single calls) and its ``device_ms`` (20
calls queued behind a spin kernel, over 20). Then come the card's name and
power limit as ``nvidia-smi`` reports them, the per-kernel JSON line, and
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that last line; so does a machine without CUDA, or a directory
without the package.
"""

from __future__ import annotations

import contextlib
import copy
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
# The request path's phases: the two seeded uint8 images of
# ``tools/detection_request.py`` (480x640, 427x640), which the transform
# (800 / 1333, round) takes to these sizes on its 1344x1344 canvas.
RESIZED = [(800, 1067), (800, 1199)]
# bf16 kernel path against bf16 plain path, end to end: a pooled value
# that rounds to the neighbouring bf16 value moves a score by ~1e-3 and a
# box by a fraction of a pixel
AMP_SCORE_TOL = 1e-2
AMP_BOX_TOL = 1.0
# bf16 request against f32 request: each FPN map and RPN head output
# within this share of its largest f32 value. Each layer rounds its output
# to bf16 (2**-9 relative) over some sixty layers; the same full-width
# model on a 2x192x192 canvas on the CPU read 1.1e-2 to 2.5e-2. A layer
# that computes the wrong thing in bf16 is off by the order of the map.
AMP_VS_F32_TOL = 5e-2
# Faster R-CNN training (phase faster_rcnn_train): the recipe's SGD (lr
# 0.02 with its warmup, tools/detection_request.py:recipe_optimizer); the
# gradients held against the plain path's: the box head's first layer, the
# RPN head's conv, an FPN lateral conv and a conv of the last trunk stage
DET_STEPS = 3
DET_GRADS = ("roi_heads.box_head.fc6.weight", "rpn.head.conv.0.0.weight",
             "backbone.fpn.inner_blocks.2.0.weight",
             "backbone.body.layer4.1.conv2.weight")
# The amp train phases (compute_dtype=torch.bfloat16) against the same
# bf16 steps through the plain versions: the two paths part only where a
# pooler kernel's f32 sum, taken in another order, rounds to the
# neighbouring bf16 value (a step, 2**-8 of a pooled value) and that
# difference runs through the bf16 heads and, backward, the bf16 trunk, as
# the served bf16 scores (AMP_SCORE_TOL) do: step 1's losses and the later
# steps' summed losses within 1e-2 relative, the gradients within 5e-2 of
# each one's largest value (a gradient rounds in bf16 forward and
# backward). Step 1 against the f32 step: the RPN's two losses (on the
# same anchors and gt) and the summed loss within AMP_VS_F32_TOL; the RoI
# head's losses follow samples drawn from proposals that bf16 moves, and
# are printed.
AMP_FIRST_LOSS_TOL = 1e-2
AMP_GRAD_TOL = 5e-2
AMP_VS_F32_GATED = ("loss_objectness", "loss_rpn_box_reg", "loss")
# Mask R-CNN and Keypoint R-CNN training: those four and the new heads'
# first layers
MASK_GRADS = DET_GRADS + ("roi_heads.mask_head.mask_fcn1.weight",
                          "roi_heads.mask_predictor.conv5_mask.weight")
KEYPOINT_GRADS = DET_GRADS + (
    "roi_heads.keypoint_head.0.weight",
    "roi_heads.keypoint_predictor.kps_score_lowres.weight")
# Served masks, kernel path against plain path on the same boxes: f32
# probabilities (28x28 and pasted) within MASK_TOL. In bf16 a pooled value
# that rounds to the neighbouring bf16 value moves a logit of the four bf16
# convs and the deconvolution by bf16 steps of the terms it sums, which
# can be a large share of a logit near 0 (where the sigmoid is steepest):
# there the gate is how far bf16 arithmetic itself moves the masks, the
# plain bf16 path against the f32 model at the same boxes
MASK_TOL = 1e-4
# The deform-trunk Mask R-CNN (maskrcnn_resnet50_fpn_deform): its offset
# predictors are zero at init, where the model is the plain one, so each
# phase first draws them from a seeded normal scaled to give offsets of
# OFFSET_RMS px on its own images (tools/detection_request.py:seed_offsets);
# a phase fails if the offsets' RMS is under OFFSET_RMS_MIN or no sample
# falls outside its map. Its train phases also hold these gradients: each
# stage's deformable conv and offset predictors
OFFSET_RMS_MIN = 0.25
DEFORM_PARAMS = 44_982_235  # 44,401,393 + 13 offset predictors (580,842)
DEFORM_GRADS = MASK_GRADS + ("backbone.body.layer2.0.conv2.weight",
                             "backbone.body.layer2.0.conv2_offset.weight",
                             "backbone.body.layer3.1.conv2_offset.weight",
                             "backbone.body.layer4.2.conv2_offset.weight")
# Served keypoints: a heatmap whose largest cell leads the next by less
# than this share of the heatmaps' largest magnitude is a near-tie, where
# the two paths' f32 round-off may pick the other cell
NEAR_TIE = 1e-4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(nbytes: float, ops: float, peak: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
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
        deform = importlib.import_module("vision_tpu_torch.ops.deform_conv")

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
            "window_pool_backward": (poolers, "window_pool_backward_cuda",
                                     poolers.window_pool_backward_plain),
            "roi_align_backward": (roi_align, "roi_align_backward_cuda",
                                   roi_align.roi_align_backward_plain),
            "deform_conv": (deform, "deform_im2col_cuda",
                            deform.deform_im2col_plain),
            "deform_conv_backward": (deform, "deform_conv_backward_cuda",
                                     deform.deform_conv_backward_plain),
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
            fn.launches_by_dtype = {}

    def launches(self) -> dict:
        """Each wrapper's count, and the window pool's and RoIAlign's, the
        deformable convolution's, and their backward kernels', split by
        variant: ``<name>_f32`` and ``<name>_bf16``."""
        out = {n: fn.launches for n, fn in self.counted.items()}
        for n in ("window_pool", "roi_align", "window_pool_backward",
                  "roi_align_backward", "deform_conv", "deform_conv_backward"):
            by = self.counted[n].launches_by_dtype
            out[f"{n}_f32"] = by.get("float32", 0)
            out[f"{n}_bf16"] = by.get("bfloat16", 0)
        return out

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


def peak_flops(t) -> float:
    """The card's peak rate of operations on ``t``'s element type."""
    import torch

    return PEAK_BF16_FLOPS if t.dtype == torch.bfloat16 else PEAK_F32_FLOPS


def nms_work(args):
    """Bytes: boxes and valid read, keep written. Operations: the IoU test
    of every pair of the upper triangle, in f32."""
    boxes, valid, _ = args
    b, n = valid.shape
    pairs = b * n * (n - 1) / 2
    return boxes.numel() * 4 + valid.numel() + valid.numel(), (
        pairs * NMS_OPS_PER_PAIR + 3 * b * n), PEAK_F32_FLOPS


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
    return nbytes, 2.0 * m * k * n, peak_flops(x)


def window_work(args):
    """Bytes: the pyramid cells some window reads (rows and columns with a
    non-zero weight), the weights and origins, the output. Operations:
    the multiply-adds over those rows and columns, then over those columns
    again, against the peak of the pyramid's type."""
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
    elem = stacked.element_size()  # the pyramid's and the output's type
    nbytes = (cells * c * elem + row0.numel() * 4 + x0.numel() * 4
              + w_y.numel() * 4 + w_x.numel() * 4 + k * c * ph * pw * elem)
    nzy = ynz.sum(1).double()
    nzx = xnz.sum(1).double()
    ops = 2 * c * float(torch.sum(ph * nzy * nzx + ph * pw * nzx))
    return nbytes, ops, peak_flops(stacked)


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


def _roi_grid(rois, ph, pw, scale, sr, aligned):
    """Per RoI the start, extent and sample grid of each axis, as the
    kernels compute them."""
    import torch

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
    return sh, sw, rh, rw, gh, gw


def roi_work(args):
    """Bytes: the input pixels some sample reads (all channels), the RoIs,
    the output. Operations: per sample and channel 4 corner weights, 4
    products, 4 adds; one divide per output; against the peak of the
    input's type."""
    import torch

    inp, rois, size, scale, sr, aligned = args
    ph, pw = (size, size) if isinstance(size, int) else size
    n, c, h, w = inp.shape
    k = rois.shape[0]
    sh, sw, rh, rw, gh, gw = _roi_grid(rois, ph, pw, scale, sr, aligned)
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
    elem = inp.element_size()  # the input's and the output's type
    nbytes = (int(touched.sum()) * c * elem + rois.numel() * 4
              + k * c * ph * pw * elem)
    samples = float((gh * gw).sum()) * ph * pw
    return nbytes, c * samples * 12 + k * c * ph * pw, peak_flops(inp)


def roi_backward_work(args):
    """Bytes: the output gradient and the RoIs read, the whole input
    gradient written (zeros included), each in its own type. Operations:
    the forward's, each sample's corner weights and products now scattering
    the gradient; in f32 (the sums are f32 in both variants)."""
    grad, rois, (n, c, h, w), size, scale, sr, aligned = args
    ph, pw = (size, size) if isinstance(size, int) else size
    gh, gw = _roi_grid(rois, ph, pw, scale, sr, aligned)[4:]
    samples = float((gh.clamp(min=0) * gw.clamp(min=0)).sum()) * ph * pw
    elem = grad.element_size()  # the gradient's type, in and out
    nbytes = (grad.numel() + n * c * h * w) * elem + rois.numel() * 4
    return nbytes, c * samples * 12 + grad.numel(), PEAK_F32_FLOPS


def window_backward_work(args):
    """Bytes: the output gradient, the weights and origins read, the whole
    pyramid gradient written (zeros included), the gradients in their own
    type. Operations: per RoI the cheaper of the two contraction orders
    over its non-zero rows and columns, ``w_x`` first (PH PW nx + PH ny nx)
    or ``w_y`` first (PH PW ny + PW ny nx), so that the bound does not
    depend on the order a design takes; in f32 (the sums are f32 in both
    variants)."""
    import torch

    grad, row0, x0, w_y, w_x, (r_rows, wmax) = args[:6]
    k, c, ph, pw = grad.shape
    nzy = (w_y != 0).any(1).sum(1).double()
    nzx = (w_x != 0).any(1).sum(1).double()
    elem = grad.element_size()
    nbytes = ((grad.numel() + r_rows * wmax * c) * elem
              + (w_y.numel() + w_x.numel() + row0.numel() + x0.numel()) * 4)
    x_first = ph * pw * nzx + ph * nzy * nzx
    y_first = ph * pw * nzy + pw * nzy * nzx
    ops = 2 * c * float(torch.minimum(x_first, y_first).sum())
    return nbytes, ops, PEAK_F32_FLOPS


def compare_kernel(fn, plain, args, exact=False, on_cpu=False):
    """Kernel against plain version on the same inputs (with ``on_cpu``,
    the plain version on the CPU): (max abs error, that error relative to
    the largest plain value, kernel ms by the wrapper clock, kernel
    ``device_ms``, plain ms on the card). For a bf16 output the second is
    the largest error in bf16 steps: |got - want| over 2**-7 |want| + 1e-5
    max |want| (one step of the element's magnitude, plus the f32
    round-off of sums taken in another order)."""
    import torch

    got = fn(*args)
    if on_cpu:
        got = got.cpu()
        want = plain(*[a.cpu() if torch.is_tensor(a) else a for a in args])
    else:
        want = plain(*args)
    torch.cuda.synchronize()
    if exact:
        err = float((got.int() - want.int()).abs().max())
        rel = err
    elif got.dtype == torch.bfloat16:
        diff = (got.float() - want.float()).abs()
        scale = 2.0 ** -7 * want.float().abs() + 1e-5 * want.float().abs().max()
        err = float(diff.max()) if got.numel() else 0.0
        rel = float((diff / scale.clamp(min=1e-30)).max()) if got.numel() else 0.0
    else:
        err = float((got - want).abs().max()) if got.numel() else 0.0
        rel = err / max(float(want.abs().max()), 1e-30) if got.numel() else 0.0
    ms = cuda_ms(lambda: fn(*args))
    dev_ms = device_ms(lambda: fn(*args))
    plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
    return err, rel, ms, dev_ms, plain_ms


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
    t_phases = time.perf_counter()
    rows, model = faster_rcnn_phases(kernels)
    rows += faster_rcnn_image_phases(kernels, model)
    del model
    torch.cuda.empty_cache()
    rows += faster_rcnn_train_phase(kernels)
    torch.cuda.empty_cache()
    rows += mask_rcnn_image_phases(kernels)
    rows += mask_rcnn_train_phase(kernels)
    torch.cuda.empty_cache()
    rows += mask_rcnn_deform_phases(kernels)
    torch.cuda.empty_cache()
    keypoint_rcnn_phases(kernels)
    torch.cuda.empty_cache()
    rows += resnet50_phases(kernels)
    emit("done", build_s=build_s, phases_s=time.perf_counter() - t_phases,
         total_s=time.perf_counter() - t0)

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

    model = scaled_detector("fasterrcnn_resnet50_fpn")
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
    return rows, model


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

    cases = [kernel_case(kernels, "nms_rowscan", args, "faster_rcnn_rowscan")
             for args in calls["nms_rowscan"]]
    return kernel_row("nms_rowscan", cases, launches["nms_rowscan"])


def serve_phase(kernels, model, preset, transform, raw, dtype, calls,
                request=None):
    """A warm-up request that records the kernels' inputs, ``TIMED_FORWARDS``
    timed requests (ms per image: host clock around a request that ends in
    ``torch.cuda.synchronize()``, over the images), the launch counts of
    those, one request through the plain versions, and the FPN maps and
    RPN head outputs of the request's canvas. ``request`` is
    ``detection_request.serve`` unless given (same arguments; its first
    result the ``ImageList``)."""
    import torch

    from vision_tpu_torch.tools.detection_request import serve

    request = request or serve
    with torch.inference_mode():
        with kernels.recording(calls):
            request(model, preset, transform, raw, dtype)
        torch.cuda.synchronize()
        kernels.reset()
        times = []
        for _ in range(TIMED_FORWARDS):
            t = time.perf_counter()
            out = request(model, preset, transform, raw, dtype)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3 / len(raw))
        launches = kernels.launches()
        with kernels.plain_versions():
            ref = request(model, preset, transform, raw, dtype)
        feats, objectness, deltas, _ = model.features_and_rpn(
            out[0].tensors.to(dtype))
        torch.cuda.synchronize()
    return out, ref, times, launches, (list(feats.values()), objectness, deltas)


def faster_rcnn_image_phases(kernels, model):
    """Faster R-CNN served from raw images, in f32 (``faster_rcnn_images``)
    and in bf16 (``faster_rcnn_amp``: ``model.to(torch.bfloat16)`` and a bf16
    canvas), each against the same request through the plain versions, and
    the bf16 request's FPN maps and RPN head outputs against the f32 ones;
    then the bf16 window-pool and RoIAlign variants against their plain
    bf16 versions at the amp request's inputs, with the f32 kernels timed
    at the f32 request's inputs beside them."""
    import torch

    from vision_tpu_torch.models.detection import (
        FasterRCNN_ResNet50_FPN_Weights,
        GeneralizedRCNNTransform,
    )
    from vision_tpu_torch.tools.detection_request import SEED, raw_images

    raw = raw_images()
    preset = FasterRCNN_ResNet50_FPN_Weights.COCO_V1.transforms()
    transform = GeneralizedRCNNTransform()

    calls32: dict = {}
    (batch, dets, boxes), (_, ref, _), times, launches, rpn32 = serve_phase(
        kernels, model, preset, transform, raw, torch.float32, calls32)
    emit("faster_rcnn_images", dtype="float32", images=[list(r.shape) for r in raw],
         seed=SEED, canvas=list(transform.fixed_size), batch=len(raw),
         image_sizes=batch.image_sizes, expected_image_sizes=RESIZED,
         ms_per_img_median=statistics.median(times), ms_per_img_all=times,
         requests=TIMED_FORWARDS, launches=launches)
    if batch.image_sizes != RESIZED:
        raise RuntimeError(f"image sizes {batch.image_sizes}, expected {RESIZED}")
    require_launched(launches, ("nms", "window_pool_f32", "roi_align_f32"),
                     "Faster R-CNN from images (f32)")
    check_detections(dets, ref, batch=len(raw), phase="faster_rcnn_images")
    check_mapped_boxes(boxes, raw)

    model.to(torch.bfloat16)
    calls16: dict = {}
    (batch16, dets16, boxes16), (_, ref16, _), times16, launches16, rpn16 = (
        serve_phase(kernels, model, preset, transform, raw, torch.bfloat16,
                    calls16))
    b = dets16.boxes
    s32 = dets.scores.flatten().sort().values[-5:]
    s16 = dets16.scores.float().flatten().sort().values[-5:]
    top5_err = float((s16 - s32).abs().max())
    inside = bool(((b >= -1e-3) & (b <= max(transform.fixed_size) + 1e-3)).all())
    vs_f32 = {k: rel_errs(g, w) for k, g, w in zip(
        ("fpn", "objectness", "deltas"), rpn16, rpn32)}
    vs_f32_max = max(max(v) for v in vs_f32.values())
    emit("faster_rcnn_amp", dtype="bfloat16", boxes_dtype=str(b.dtype)[6:],
         scores_dtype=str(dets16.scores.dtype)[6:],
         image_sizes=batch16.image_sizes, ms_per_img_median=statistics.median(times16),
         ms_per_img_all=times16, requests=TIMED_FORWARDS, launches=launches16,
         top5_scores_f32=s32.tolist(), top5_scores_bf16=s16.tolist(),
         top5_max_err=top5_err, top5_tol=0.05, boxes_inside_canvas=inside,
         rel_err_vs_f32=vs_f32, rel_err_vs_f32_tol=AMP_VS_F32_TOL,
         f32_ms_per_img_median=statistics.median(times))
    if b.dtype != torch.float32 or not bool(torch.isfinite(b).all()) or not inside:
        raise RuntimeError("amp: boxes not f32, not finite or outside the canvas")
    if top5_err > 0.05:
        raise RuntimeError("amp: the top 5 scores are not within 0.05 of the "
                           "f32 run's")
    if not vs_f32_max <= AMP_VS_F32_TOL:
        raise RuntimeError(f"amp: FPN maps or RPN head outputs {vs_f32_max} of "
                           f"their largest value away from f32's")
    require_launched(launches16, ("nms", "window_pool_bf16", "roi_align_bf16"),
                     "Faster R-CNN from images (bf16)")
    if launches16["window_pool_f32"] or launches16["roi_align_f32"]:
        raise RuntimeError(f"the amp path launched an f32 pooler kernel: {launches16}")
    check_detections(dets16, ref16, batch=len(raw), score_tol=AMP_SCORE_TOL,
                     box_tol=AMP_BOX_TOL, phase="faster_rcnn_amp")
    check_mapped_boxes(boxes16, raw)

    rows = []
    for name in ("window_pool", "roi_align"):
        f32 = summed([kernel_case(kernels, name, args, "faster_rcnn_images")
                      for args in calls32[name]])
        bf16 = [kernel_case(kernels, name, args, "faster_rcnn_amp")
                for args in calls16[name]]
        rows.append(kernel_row(
            name, bf16, launches16[f"{name}_bf16"], row_name=f"{name}_bf16",
            dtype="bfloat16", path="faster_rcnn_amp (1344x1344, batch 2)",
            f32_same_path={k: f32[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "bytes_bound_ms", "operations_bound_ms", "max_abs_err")}))
    return rows


def det_train_steps(batch, steps, first_step=None, timed=0,
                    name="fasterrcnn_resnet50_fpn", grads=DET_GRADS,
                    dtype=None, setup=None, twin=None):
    """A fresh seeded detector ``name`` (R50-FPN,
    ``trainable_backbone_layers=3``; ``setup(model)`` called on it first,
    where given) and ``steps`` SGD steps of
    ``make_detection_train_step`` (``compute_dtype=dtype``) on ``batch``,
    the samplers drawing from a
    generator on its device seeded with 0; then ``timed`` more steps.
    Returns each step's losses, the gradients of ``grads`` after the first
    step, and the timed steps' wall ms (host clock around a step whose loss
    is read back), and the peak memory allocated over the timed steps; with
    ``twin``, also ``twin(model, generator)``'s result from just before
    each of the ``steps`` steps."""
    import torch

    from vision_tpu_torch.models import get_model
    from vision_tpu_torch.parallel import make_detection_train_step
    from vision_tpu_torch.tools.detection_request import recipe_optimizer

    model = get_model(name, seed=0, trainable_backbone_layers=3)
    if setup is not None:
        setup(model)
    optimizer, scheduler = recipe_optimizer(model)
    step = make_detection_train_step(model, optimizer, compute_dtype=dtype)
    gen = torch.Generator(device=batch["image"].device).manual_seed(0)
    named = dict(model.named_parameters())
    out = {"losses": [], "ms": [], "lr": [],
           "trainable_params": sum(p.numel() for p in model.parameters()
                                   if p.requires_grad),
           "params": sum(p.numel() for p in model.parameters())}
    out["twin"] = []
    for i in range(steps + timed):
        if twin is not None and i < steps:
            out["twin"].append(twin(model, gen))
        if i == steps:
            torch.cuda.reset_peak_memory_stats()
        ctx = first_step() if i == 0 and first_step else contextlib.nullcontext()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with ctx:
            losses = step(batch, gen)
            loss = float(losses["loss"])
        if i >= steps:
            out["ms"].append((time.perf_counter() - t) * 1e3)
        out["lr"].append(optimizer.param_groups[0]["lr"])
        scheduler.step()
        out["losses"].append({k: float(v) for k, v in losses.items()})
        if i == 0:
            out["grads"] = {n: named[n].grad.clone() for n in grads}
        if not math.isfinite(loss):
            raise RuntimeError(f"{name} train: loss {loss} at step {i}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def plain_twin_step(kernels, model, gen, batch, dtype, grads):
    """One train step through the plain versions from ``model``'s weights
    and ``gen``'s state, on copies of both (the two are left as they were):
    its losses and the gradients of ``grads``."""
    import torch

    from vision_tpu_torch.parallel import make_detection_train_step

    twin = copy.deepcopy(model)
    params = [p for p in twin.parameters() if p.requires_grad]
    step = make_detection_train_step(twin, torch.optim.SGD(params, lr=0.0),
                                     compute_dtype=dtype)
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    with kernels.plain_versions():
        losses = step(batch, g)
    named = dict(twin.named_parameters())
    out = ({k: float(v) for k, v in losses.items()},
           {n: named[n].grad.clone() for n in grads})
    del twin, step, params
    return out


def det_train_phase(kernels, phase, name="fasterrcnn_resnet50_fpn",
                    grads=DET_GRADS, num_classes=91, f32_first=None,
                    prepare=None, require=(), **extras):
    """A detector trained on the request's two images (batch 2, the 1344
    canvas, seeded gt boxes; with ``extras`` the gt masks or keypoints of
    ``train_batch``): ``DET_STEPS`` SGD steps through the kernels (the
    first recording every kernel's inputs; the launches counted over all of
    them), each against one step through the plain versions from the same
    weights and generator state (``plain_twin_step``). Step 1: each loss
    within 1e-4 relative, the gradients of ``grads`` within 1e-3 of each
    one's largest value (the same samples: the forward up to the pooler is
    the same, NMS to the bit); the later steps' summed loss within 1e-4
    (each part is printed). Then 5 timed steps after a warm-up.

    Each plain step starts where the kernel path stands, not from the plain
    path's own last step: three steps apart the two trajectories part by
    more than their round-off, since after an update a RoI whose box sits
    on a pooler level's or window's edge switches with the last bit, and at
    this random init a mask RoI's binary cross-entropy is some 18 a pixel,
    so one RoI moves the mask loss by percents (the deform model's plain
    path, whose gathers scatter their gradients with atomics, read step-2
    mask losses of 14.63 and 14.39 in two runs of the same code, the kernel
    path 14.63 in both).

    With ``f32_first`` (the f32 phase's step 1 losses) the steps are the amp
    steps (``compute_dtype=torch.bfloat16``), held against the same bf16
    steps through the plain versions: each step's losses within
    ``AMP_FIRST_LOSS_TOL`` (step 1 each loss, later steps the sum), the
    gradients within ``AMP_GRAD_TOL``; and step 1's losses against the f32
    step's: the RPN's two and the sum within ``AMP_VS_F32_TOL`` (the RoI
    head's part on samples drawn from other proposals, printed). Every
    pooler kernel launch must be a bf16 one, but RoIAlign's at the f32
    mask targets. ``prepare(model, images)`` readies each fresh model (the
    deform model's offset predictors), outside the counted launches; the
    kernels of ``require`` must launch too (in the step's type). Returns
    the recorded calls, the launches and step 1's losses."""
    import torch

    from vision_tpu_torch.models.detection import (
        FasterRCNN_ResNet50_FPN_Weights,
        GeneralizedRCNNTransform,
    )
    from vision_tpu_torch.tools.detection_request import (
        GT_COUNTS,
        GT_ROWS,
        raw_images,
        train_batch,
    )

    raw = raw_images()
    with torch.no_grad():
        batch = train_batch(FasterRCNN_ResNet50_FPN_Weights.COCO_V1.transforms(),
                            GeneralizedRCNNTransform(), raw,
                            num_classes=num_classes, **extras)
    calls: dict = {}
    kernels.reset()
    amp = f32_first is not None
    dtype = torch.bfloat16 if amp else None

    def setup(model):
        if prepare is not None:
            prepare(model, batch["image"])
        kernels.reset()

    def twin(model, gen):
        return plain_twin_step(kernels, model, gen, batch, dtype, grads)

    run = det_train_steps(batch, DET_STEPS,
                          first_step=lambda: kernels.recording(calls),
                          timed=1 + TIMED_FORWARDS, name=name, grads=grads,
                          dtype=dtype, setup=setup, twin=twin)
    launches = kernels.launches()
    ref = {"losses": [t[0] for t in run["twin"]], "grads": run["twin"][0][1]}
    names = list(run["losses"][0])
    loss_rel = [{k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in names}
                for a, b in zip(run["losses"], ref["losses"])]
    grad_rel = {n: rel_errs([run["grads"][n]], [ref["grads"][n]])[0]
                for n in grads}
    ms = statistics.median(run["ms"][1:])
    first_tol, grad_tol = (AMP_FIRST_LOSS_TOL, AMP_GRAD_TOL) if amp else (
        1e-4, 1e-3)
    fields = {}
    if amp:
        vs_f32 = {k: abs(run["losses"][0][k] - f32_first[k])
                  / max(abs(f32_first[k]), 1e-30) for k in names}
        fields = dict(f32_first_losses=f32_first,
                      first_loss_rel_err_vs_f32=vs_f32,
                      vs_f32_tol=AMP_VS_F32_TOL,
                      vs_f32_gated=list(AMP_VS_F32_GATED))
    emit(phase, model=name, params=run["params"],
         trainable_params=run["trainable_params"],
         trainable_backbone_layers=3, input=list(batch["image"].shape),
         gt_boxes=list(GT_COUNTS), gt_rows=GT_ROWS,
         gt_extras={k: list(batch[k].shape) for k in extras},
         dtype="bfloat16" if amp else "float32",
         optimizer="SGD lr 0.02 momentum 0.9 weight_decay 1e-4, linear "
                   "warmup from 1e-3 over 1000 steps", lr_per_step=run["lr"],
         steps_compared=DET_STEPS, losses=run["losses"][:DET_STEPS],
         plain_losses=ref["losses"], loss_rel_err=loss_rel,
         loss_tol=first_tol, grad_rel_err=grad_rel, grad_tol=grad_tol,
         ms_per_step_median=ms,
         images_per_s=len(raw) / ms * 1e3, ms_all=run["ms"],
         timed_steps=TIMED_FORWARDS, peak_memory_gb=run["peak_gb"],
         recorded_inputs_gb=sum(a.numel() * a.element_size()
                                for args in calls.values() for call in args
                                for a in call if torch.is_tensor(a)) / 1e9,
         launches=launches, **fields)
    tag = "bf16" if amp else "f32"
    require_launched(launches, ("nms", f"window_pool_{tag}",
                                f"window_pool_backward_{tag}",
                                f"roi_align_{tag}", f"roi_align_backward_{tag}",
                                *(f"{n}_{tag}" for n in require)),
                     phase)
    if amp and (launches["window_pool_f32"]
                or launches["window_pool_backward_f32"]
                or launches["roi_align_backward_f32"]
                or any(launches[f"{n}_f32"] for n in require)):
        raise RuntimeError(f"{phase} launched an f32 pooler or deform kernel: "
                           f"{launches}")
    if amp and max(vs_f32[k] for k in AMP_VS_F32_GATED) > AMP_VS_F32_TOL:
        raise RuntimeError(f"{phase}: step 1's losses lie too far from the f32 "
                           f"step's: {vs_f32}")
    if (max(loss_rel[0].values()) > first_tol
            or max(r["loss"] for r in loss_rel[1:]) > first_tol
            or max(grad_rel.values()) > grad_tol):
        raise RuntimeError(f"{phase}: the kernel train path disagrees with "
                           "the plain path")
    first, last = run["losses"][0]["loss"], run["losses"][DET_STEPS - 1]["loss"]
    if first == last:
        raise RuntimeError(f"{phase}: the last compared loss equals the "
                           "first: no update")
    first_losses = run["losses"][0]
    del run, ref, batch
    torch.cuda.empty_cache()
    return calls, launches, first_losses


def backward_rows(kernels, calls, launches, phase, size, suffix=""):
    """The two backward kernels against their plain versions at the
    recorded calls of pooled size ``size``, a row each, named
    ``<kernel><suffix>``, its launches those of the calls' type."""
    rows = []
    for name in ("window_pool_backward", "roi_align_backward"):
        cases = [kernel_case(kernels, name, args, phase)
                 for args in at_size(calls, name, size)]
        tag = "bf16" if cases[0]["dtype"] == "bfloat16" else "f32"
        rows.append(kernel_row(
            name, cases, launches[f"{name}_{tag}"], row_name=name + suffix,
            dtype=cases[0]["dtype"], path=f"{phase} (1344x1344, batch 2)",
            calls_per_step=len(cases), counterpart="XLA VJP, no pallas_call",
            same_bits_twice=all(c["same_bits_twice"] for c in cases)))
    return rows


def faster_rcnn_train_phase(kernels):
    """Faster R-CNN training (``det_train_phase``), then the backward
    kernels against their plain versions at the recorded inputs; the same
    in bf16 (``faster_rcnn_train_amp``), through the backward kernels' bf16
    variants."""
    calls, launches, first = det_train_phase(kernels, "faster_rcnn_train")
    rows = backward_rows(kernels, calls, launches, "faster_rcnn_train", 7)
    del calls
    calls, launches, _ = det_train_phase(kernels, "faster_rcnn_train_amp",
                                         f32_first=first)
    return rows + backward_rows(kernels, calls, launches,
                                "faster_rcnn_train_amp", 7, "_bf16")


def serve_masks(model, preset, transform, raw, dtype):
    """The served Mask R-CNN request: ``detection_request.serve``, then
    each image's masks pasted at its own size (``paste_masks``)."""
    from vision_tpu_torch.tools.detection_request import paste_masks, serve

    batch, dets, boxes = serve(model, preset, transform, raw, dtype)
    return batch, dets, boxes, paste_masks(dets, boxes, raw)


def scaled_detector(name):
    """Detector ``name`` with seeded weights and ``cls_score`` scaled by
    ``CLS_SCALE``, so that detections pass the score threshold."""
    import torch

    from vision_tpu_torch.models import get_model

    model = get_model(name, seed=0)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.weight.mul_(CLS_SCALE)
    return model


def at_size(calls, name, size):
    """The recorded calls of kernel ``name`` whose pooled output is ``size``
    on a side (7 for the box pooler, 14 for the mask and keypoint poolers,
    28 for the mask targets)."""
    def out_size(args):
        if name.endswith("_backward"):
            return args[0].shape[2]
        if name == "window_pool":
            return args[3].shape[1]
        return args[2] if isinstance(args[2], int) else args[2][0]
    return [a for a in calls.get(name, []) if out_size(a) == size]


def mask_rcnn_image_phases(kernels):
    """Mask R-CNN served from the two raw images (``serve_mask_phases``),
    then the window pool and the dense fallback's RoIAlign at 14x14 against
    their plain versions at the requests' inputs."""
    import torch

    calls, launches_by = serve_mask_phases(
        kernels, "maskrcnn_resnet50_fpn", ("mask_rcnn_images", "mask_rcnn_amp"))
    rows = []
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for name in ("window_pool", "roi_align"):
            cases = [kernel_case(kernels, name, args, f"mask_rcnn ({tag}, 14x14)")
                     for args in at_size(calls[dtype], name, 14)]
            rows.append(kernel_row(
                name, cases, launches_by[tag][f"{name}_{tag}"],
                row_name=f"{name}_14x14" + ("_bf16" if tag == "bf16" else ""),
                dtype=str(dtype)[6:],
                path=f"mask_rcnn_{'amp' if tag == 'bf16' else 'images'} "
                     "(1344x1344, batch 2; the mask pooler)"))
    return rows


def serve_mask_phases(kernels, name, phases, num_params=None, prepare=None,
                      require=()):
    """A Mask R-CNN ``name`` served from the two raw images, in f32
    (``phases[0]``) and in bf16 (``phases[1]``): the request of
    ``faster_rcnn_images`` with the 28x28 masks of every detection and the
    masks pasted into each image at its own size, each against the same
    request through the plain versions: detections as ``check_detections``
    holds them; the mask branch through the plain versions on the same
    detections' boxes: 28x28 and pasted masks within ``MASK_TOL`` in f32;
    in bf16 no further from the plain bf16 masks than those lie from the
    f32 model's masks at the same boxes (bf16 arithmetic's own reach; the
    masks of the whole plain request are printed beside them).
    ``prepare(model, canvas)`` readies the f32 model on the request's
    canvas first; the kernels of ``require`` must launch too. The model
    has ``num_params`` parameters (the published Mask R-CNN's when None).
    Returns the recorded calls of each type and the launches."""
    import torch

    from vision_tpu_torch.models.detection import (
        GeneralizedRCNNTransform,
        MaskRCNN_ResNet50_FPN_Weights,
    )
    from vision_tpu_torch.tools.detection_request import paste_masks, raw_images

    raw = raw_images()
    preset = MaskRCNN_ResNet50_FPN_Weights.COCO_V1.transforms()
    transform = GeneralizedRCNNTransform()
    model = scaled_detector(name)
    if prepare is not None:
        with torch.no_grad():
            prepare(model, transform([preset(r) for r in raw]).tensors)
    params = sum(p.numel() for p in model.parameters())
    num_params = num_params or MaskRCNN_ResNet50_FPN_Weights.COCO_V1.meta[
        "num_params"]
    launches_by = {}
    calls = {}
    for dtype, phase in zip((torch.float32, torch.bfloat16), phases):
        if dtype == torch.bfloat16:
            model32 = copy.deepcopy(model)
        model.to(dtype)
        calls[dtype] = {}
        (batch, dets, boxes, pasted), (_, ref, _, _), times, launches, _ = (
            serve_phase(kernels, model, preset, transform, raw, dtype,
                        calls[dtype], request=serve_masks))
        bf16 = dtype == torch.bfloat16
        tag = "bf16" if bf16 else "f32"
        check_detections(dets, ref, batch=len(raw), phase=phase,
                         score_tol=AMP_SCORE_TOL if bf16 else 1e-4,
                         box_tol=AMP_BOX_TOL if bf16 else 1e-2)
        valid = dets.valid
        tol = MASK_TOL
        # the mask branch through the plain versions on this request's own
        # detections: the two paths' boxes differ by round-off (check_detections),
        # and a box moved by 5e-4 px moves its mask by ~1e-4 on its own
        with torch.inference_mode(), kernels.plain_versions():
            feats = model.backbone(batch.tensors.to(dtype))
            same_boxes = dets._replace(masks=model.masks(
                feats, dets.boxes, dets.labels, tuple(batch.tensors.shape[-2:])))
            same_pasted = paste_masks(same_boxes, boxes, raw)
        mask_err = float((dets.masks[valid].float()
                          - same_boxes.masks[valid].float()).abs().max())
        pasted_err = max(float((a[v].float() - b[v].float()).abs().max())
                         for a, b, v in zip(pasted, same_pasted, valid))
        ref_err = float((dets.masks[valid].float()
                         - ref.masks[valid].float()).abs().max())
        shapes_ok = (tuple(dets.masks.shape) == (len(raw), 100, 28, 28) and all(
            tuple(p.shape) == (100, *r.shape[-2:]) for p, r in zip(pasted, raw)))
        finite = bool(torch.isfinite(dets.masks.float()).all()) and all(
            bool(torch.isfinite(p.float()).all()) for p in pasted)
        fields = {}
        if bf16:
            # the f32 model's masks at the bf16 request's own boxes: how far
            # bf16 arithmetic alone moves them, the gate of the bf16 check
            with torch.inference_mode():
                m32 = model32.masks(model32.backbone(batch.tensors), dets.boxes,
                                    dets.labels, tuple(batch.tensors.shape[-2:]))
            tol = float((same_boxes.masks[valid].float() - m32[valid]).abs().max())
            fields = dict(masks_vs_f32_max_abs_err=float(
                (dets.masks[valid].float() - m32[valid]).abs().max()),
                plain_masks_vs_f32_max_abs_err=tol,
                mask_mean_abs_err=float((dets.masks[valid].float()
                                         - same_boxes.masks[valid].float()).abs().mean()))
            del model32
        emit(phase, model=name, params=params,
             dtype=str(dtype)[6:], masks_dtype=str(dets.masks.dtype)[6:],
             images=[list(r.shape) for r in raw], canvas=list(transform.fixed_size),
             image_sizes=batch.image_sizes, ms_per_img_median=statistics.median(times),
             ms_per_img_all=times, requests=TIMED_FORWARDS, launches=launches,
             mask_max_abs_err=mask_err, pasted_max_abs_err=pasted_err,
             mask_tol=tol, mask_max_abs_err_vs_plain_request=ref_err,
             shapes_ok=shapes_ok, finite=finite, **fields)
        if params != num_params or not shapes_ok or not finite:
            raise RuntimeError(f"{phase}: wrong parameter count, mask shapes or "
                               "non-finite masks")
        require_launched(launches, ("nms", f"window_pool_{tag}",
                                    f"roi_align_{tag}",
                                    *(f"{n}_{tag}" for n in require)), phase)
        if bf16 and (launches["window_pool_f32"] or launches["roi_align_f32"]
                     or any(launches[f"{n}_f32"] for n in require)):
            raise RuntimeError(f"{phase} launched an f32 pooler or deform "
                               f"kernel: {launches}")
        if not (mask_err <= tol and pasted_err <= tol):
            raise RuntimeError(f"{phase}: masks differ from the plain path's")
        check_mapped_boxes(boxes, raw)
        launches_by[tag] = launches
    del model
    torch.cuda.empty_cache()
    return calls, launches_by


def mask_rcnn_train_phase(kernels):
    """Mask R-CNN training (``det_train_phase`` with the gt masks: the
    ellipse inscribed in each gt box), its five losses and the gradients of
    ``MASK_GRADS``; then the kernels at the shapes only this path gives
    them against their plain versions: the window pool and its backward at
    14x14 over 1,024 RoIs, RoIAlign's backward at 14x14 (the dense
    fallback), and RoIAlign at the mask targets (one channel, 28x28, scale
    1, the gt masks on the 1344 canvas); then the amp step
    (``mask_rcnn_train_amp``) and both backward kernels' bf16 variants at
    14x14."""
    calls, launches, first = det_train_phase(
        kernels, "mask_rcnn_train", name="maskrcnn_resnet50_fpn",
        grads=MASK_GRADS, masks=True)
    if not at_size(calls, "roi_align", 28):
        raise RuntimeError("mask_rcnn_train: no RoIAlign launch at the mask targets")
    path = "mask_rcnn_train (1344x1344, batch 2)"
    rows = []
    for name, size, row_name in (
            ("window_pool", 14, "window_pool_14x14_train"),
            ("roi_align", 28, "roi_align_mask_targets")):
        cases = [kernel_case(kernels, name, args, f"{path}, {row_name}")
                 for args in at_size(calls, name, size)]
        rows.append(kernel_row(name, cases, launches[name], row_name=row_name,
                               dtype="float32", path=path,
                               calls_per_step=len(cases)))
    rows += backward_rows(kernels, calls, launches, "mask_rcnn_train", 14,
                          "_14x14")
    del calls
    calls, launches, _ = det_train_phase(
        kernels, "mask_rcnn_train_amp", name="maskrcnn_resnet50_fpn",
        grads=MASK_GRADS, f32_first=first, masks=True)
    return rows + backward_rows(kernels, calls, launches,
                                "mask_rcnn_train_amp", 14, "_14x14_bf16")


def keypoint_check(dets, ref, maps, ref_maps, phase) -> dict:
    """Keypoint R-CNN kernel path against plain path on the valid rows: each
    keypoint's heatmap cell equal wherever the plain heatmap's largest cell
    leads the next by more than ``NEAR_TIE`` of the heatmaps' largest
    magnitude, its position then within the boxes' 1e-2 px, and the
    keypoint scores within ``NEAR_TIE`` of that magnitude."""
    import torch

    valid = dets.valid.flatten()
    flat = ref_maps.float().flatten(2)[valid]  # [V, K, HM*HM]
    scale = float(flat.abs().max())
    top2 = flat.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > NEAR_TIE * scale
    same_cell = maps.float().flatten(2)[valid].argmax(-1) == flat.argmax(-1)
    pos_err = (dets.keypoints.flatten(0, 1)[valid]
               - ref.keypoints.flatten(0, 1)[valid]).abs().amax(-1)
    score_err = float((dets.keypoints_scores.flatten(0, 1)[valid]
                       - ref.keypoints_scores.flatten(0, 1)[valid]).abs().max())
    out = dict(keypoints_compared=int(clear.numel()), near_ties=int((~clear).sum()),
               other_cell=int((~same_cell).sum()),
               other_cell_without_near_tie=int((~same_cell & clear).sum()),
               same_cell_max_pos_err=float(pos_err[same_cell].max()),
               pos_tol=1e-2, score_max_abs_err=score_err,
               score_tol=NEAR_TIE * scale, heatmap_scale=scale)
    if (out["other_cell_without_near_tie"] or out["same_cell_max_pos_err"] > 1e-2
            or not score_err <= NEAR_TIE * scale):
        raise RuntimeError(f"{phase}: keypoints differ from the plain path's: {out}")
    if not bool(torch.isfinite(dets.keypoints).all()):
        raise RuntimeError(f"{phase}: non-finite keypoints")
    return out


def keypoint_rcnn_phases(kernels):
    """Keypoint R-CNN (2 classes, 17 keypoints) served from the two raw
    images in f32 (``keypoint_rcnn_images``: ``keypoint_check`` on the
    valid rows, the detections as ``check_detections`` holds them), then
    trained (``keypoint_rcnn_train``: ``det_train_phase`` with seeded gt
    keypoints, the gradients of ``KEYPOINT_GRADS``). Its kernels run at the
    shapes of the Mask R-CNN phases, whose rows they share."""
    import torch

    from vision_tpu_torch.models.detection import (
        GeneralizedRCNNTransform,
        KeypointRCNN_ResNet50_FPN_Weights,
    )
    from vision_tpu_torch.tools.detection_request import raw_images

    raw = raw_images()
    model = scaled_detector("keypointrcnn_resnet50_fpn")
    params = sum(p.numel() for p in model.parameters())
    maps = []
    hook = model.roi_heads.keypoint_predictor.register_forward_hook(
        lambda mod, args, out: maps.append(out))
    transform = GeneralizedRCNNTransform()
    (batch, dets, boxes), (_, ref, _), times, launches, _ = serve_phase(
        kernels, model, KeypointRCNN_ResNet50_FPN_Weights.COCO_V1.transforms(),
        transform, raw, torch.float32, {})
    hook.remove()
    check_detections(dets, ref, batch=len(raw), phase="keypoint_rcnn_images")
    # the hook saw: the recorded request, the timed ones, the plain one
    check = keypoint_check(dets, ref, maps[-2], maps[-1], "keypoint_rcnn_images")
    emit("keypoint_rcnn_images", model="keypointrcnn_resnet50_fpn",
         params=params, classes=2, num_keypoints=17, dtype="float32",
         image_sizes=batch.image_sizes, ms_per_img_median=statistics.median(times),
         ms_per_img_all=times, requests=TIMED_FORWARDS, launches=launches,
         keypoints_shape=list(dets.keypoints.shape), **check)
    if (params != KeypointRCNN_ResNet50_FPN_Weights.COCO_V1.meta["num_params"]
            or tuple(dets.keypoints.shape) != (len(raw), 100, 17, 3)):
        raise RuntimeError("keypoint_rcnn_images: wrong parameter count or shape")
    require_launched(launches, ("nms", "window_pool_f32", "roi_align_f32"),
                     "keypoint_rcnn_images")
    check_mapped_boxes(boxes, raw)
    del model, maps
    torch.cuda.empty_cache()
    det_train_phase(kernels, "keypoint_rcnn_train",
                    name="keypointrcnn_resnet50_fpn", grads=KEYPOINT_GRADS,
                    num_classes=2, keypoints=True)


def seed_deform_offsets(model, images) -> None:
    """``seed_offsets`` on ``images``, its per-predictor RMS printed."""
    from vision_tpu_torch.tools.detection_request import OFFSET_RMS, seed_offsets

    rms = seed_offsets(model, images, rms=OFFSET_RMS)
    emit("deform_offsets_seeded", target_rms=OFFSET_RMS, predictors=len(rms),
         rms_per_predictor=rms, images=list(images.shape))


def offset_stats(calls, phase) -> dict:
    """Over the recorded deformable-conv calls of one forward: the offsets'
    RMS (px), the share of samples outside their map (not strictly inside
    (-1, H) x (-1, W)) and the share of corners that are invalid (of the
    samples' four corners, those outside the map, the outside samples'
    included). Fails the phase if the RMS is under ``OFFSET_RMS_MIN`` or no
    sample falls outside its map."""
    import torch

    from vision_tpu_torch.ops.deform_conv import sample_positions

    sq = n_off = outside = samples = bad = 0.0
    for x, off, _mask, k, stride, pad, dil in calls:
        h, w = x.shape[-2:]
        y, xx = sample_positions(off, k, stride, pad, dil)
        ins = (y > -1) & (y < h) & (xx > -1) & (xx < w)
        yl, xl = torch.floor(y), torch.floor(xx)
        vy = [(yl >= 0), (yl + 1 <= h - 1)]
        vx = [(xl >= 0), (xl + 1 <= w - 1)]
        valid = sum((ins & a & b).sum() for a in vy for b in vx)
        sq += float(off.float().pow(2).sum())
        n_off += off.numel()
        outside += float((~ins).sum())
        samples += ins.numel()
        bad += 4 * ins.numel() - float(valid)
    out = dict(offset_rms=math.sqrt(sq / n_off), samples_outside=outside / samples,
               corners_invalid=bad / (4 * samples), calls=len(calls),
               rms_min=OFFSET_RMS_MIN)
    emit("deform_offsets", path=phase, **out)
    if out["offset_rms"] < OFFSET_RMS_MIN or outside == 0:
        raise RuntimeError(f"{phase}: the offsets are not real: {out}")
    return out


def deform_key(args):
    """A deformable-conv call's shape: its input's and its offsets' (which
    give the stride)."""
    return (tuple(args[0].shape), tuple(args[1].shape))


def distinct(calls):
    """The first call of each distinct shape, and how often each came."""
    first, count = {}, {}
    for args in calls:
        key = deform_key(args)
        first.setdefault(key, args)
        count[key] = count.get(key, 0) + 1
    return [(first[k], count[k]) for k in first]


def deform_work(args):
    """Bytes: the input, the offsets (and mask) read once, the f32 columns
    written once. Operations: per column element the four products, three
    sums (and the mask's product), in f32."""
    x, off, mask, k = args[:4]
    n, _, oh, ow = off.shape
    cols = n * oh * ow * k[0] * k[1] * x.shape[1]
    nbytes = (x.numel() * x.element_size() + off.numel() * off.element_size()
              + (0 if mask is None else mask.numel() * mask.element_size())
              + cols * 4)
    return nbytes, cols * (8 if mask is not None else 7), PEAK_F32_FLOPS


def deform_backward_work(args):
    """Bytes: the input, the offsets (and mask) and ``g_cols`` read once,
    the input's gradient (its type) and the offsets' (and mask's) gradients
    (f32) written once. Operations, per column element: the input's
    gradient (two products and a sum a corner: 12), the offsets'
    (four differences, four products, two sums and the two running sums:
    12) and the mask's (8), in f32."""
    x, off, mask, g_cols = args[:4]
    nbytes = (2 * x.numel() * x.element_size() + off.numel() * (
        off.element_size() + 4) + g_cols.numel() * 4
        + (0 if mask is None else mask.numel() * (mask.element_size() + 4)))
    return nbytes, g_cols.numel() * (32 if mask is not None else 24), PEAK_F32_FLOPS


def deform_case(kernels, args, path, count, **meta):
    """The column kernel against its plain version on the card at one
    recorded call: within 1e-5 of the largest plain value in f32 and with a
    bf16 input (the columns are f32 in both: a bf16 input is widened
    exactly), its bits compared and printed; ``ms``, ``device_ms`` and the
    plain version's ms of one call, ``count`` calls a forward."""
    import torch

    got = kernels.cuda["deform_conv"](*args)
    want = kernels.plain["deform_conv"](*args)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want))
    del got, want
    err, rel, ms, dev_ms, plain_ms = compare_kernel(
        kernels.cuda["deform_conv"], kernels.plain["deform_conv"], args)
    nbytes, ops, peak = deform_work(args)
    b_ms, b_by = bound_ms(nbytes, ops, peak)
    case = dict(kernel="deform_conv", path=path, dtype=str(args[0].dtype)[6:],
                shape=[list(args[0].shape), list(args[1].shape)],
                stride=args[4], mask=args[2] is not None, calls_per_forward=count,
                **meta, same_bits=same, max_abs_err=err, max_rel_err=rel,
                tol=1e-5, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                bytes_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                operations_bound_ms=ops / peak * 1e3)
    emit("kernel_case", **case)
    if rel > 1e-5:
        raise RuntimeError(f"deform_conv ({path}) disagrees with its plain "
                           f"version: {rel} > 1e-5")
    return case


def deform_backward_case(kernels, args, path, count, **meta):
    """The backward kernels at one recorded call: the same bits on a second
    call, and against the plain version in f64 on the card (sample
    positions f32, as always): each gradient in f32 within 1e-5 of the
    largest sum of its terms' magnitudes (its f32 sum's error scales with
    that, not with the result); the bf16 input's gradient within one bf16
    step of the exact value plus that. Times as ``deform_case``."""
    import torch

    cuda, plain = kernels.cuda["deform_conv_backward"], kernels.plain[
        "deform_conv_backward"]
    first, again = cuda(*args), cuda(*args)
    torch.cuda.synchronize()
    same = all((a is None and b is None) or bool(torch.equal(a, b))
               for a, b in zip(first, again))
    del again
    x, off, mask, g = args[:4]
    rest = args[4:]
    exact = plain(x.double(), off, None if mask is None else mask.double(),
                  g.double(), *rest)
    mags = deform_backward_magnitudes(x, off, mask, g, *rest)
    names = ("input", "offset", "mask")
    errs, gates = {}, {}
    for nm, got, want, mag in zip(names, first, exact, mags):
        if want is None:
            continue
        diff = (got.double() - want).abs()
        m = float(mag.max())
        errs[nm] = float(diff.max())
        if nm == "input" and got.dtype == torch.bfloat16:
            step = 2.0 ** -7 * want.abs() + 1e-5 * m
            gates[nm] = float((diff / step.clamp(min=1e-30)).max())
        else:
            gates[nm] = float(diff.max()) / max(m, 1e-30)
    del first, exact, mags
    bf16 = x.dtype == torch.bfloat16
    ms = cuda_ms(lambda: cuda(*args))
    dev_ms = device_ms(lambda: cuda(*args))
    plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
    nbytes, ops, peak = deform_backward_work(args)
    b_ms, b_by = bound_ms(nbytes, ops, peak)
    tols = {nm: (1.0 if nm == "input" and bf16 else 1e-5) for nm in gates}
    case = dict(kernel="deform_conv_backward", path=path,
                dtype=str(x.dtype)[6:], shape=[list(x.shape), list(off.shape)],
                stride=args[5], mask=mask is not None, calls_per_step=count,
                **meta, same_bits_twice=same, max_abs_err_vs_f64=errs,
                gate=gates, gate_tol=tols,
                max_abs_err=max(errs.values()), ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bytes_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                operations_bound_ms=ops / peak * 1e3)
    emit("kernel_case", **case)
    if not same:
        raise RuntimeError(f"deform_conv_backward ({path}): two calls on the "
                           "same inputs differ")
    if any(gates[nm] > tols[nm] for nm in gates):
        raise RuntimeError(f"deform_conv_backward ({path}) disagrees with its "
                           f"plain version: {gates}")
    return case


def deform_backward_magnitudes(x, off, mask, g, k, stride, pad, dil):
    """In f64, per gradient element the sum of its terms' magnitudes: the
    input's, |g| m w scattered (the plain backward of |g|); the offsets',
    sum over the channels of |g| m (hx |v1| + lx |v2| + hx |v3| + lx |v4|)
    in y and (hy |v1| + hy |v2| + ly |v3| + ly |v4|) in x; the mask's, sum
    of |g| (w1 |v1| + ... + w4 |v4|)."""
    import torch

    from vision_tpu_torch.ops.deform_conv import (
        _corners,
        deform_conv_backward_plain,
    )

    m64 = None if mask is None else mask.double()
    gi = deform_conv_backward_plain(x.double(), off, m64, g.double().abs(), k,
                                    stride, pad, dil)[0]
    (v1, v2, v3, v4), (hy, ly, hx, lx) = _corners(x.double().abs(), off, k,
                                                  stride, pad, dil)
    n, og, k2, oh, ow, cg = v1.shape
    ga = g.double().abs().reshape(n, oh, ow, k2, og, cg).permute(0, 4, 3, 1, 2, 5)
    mm = 1.0 if mask is None else m64.reshape(n, og, k2, oh, ow)
    my = (ga * (hx[..., None] * (v1 + v3) + lx[..., None] * (v2 + v4))).sum(-1) * mm
    mx = (ga * (hy[..., None] * (v1 + v2) + ly[..., None] * (v3 + v4))).sum(-1) * mm
    go = torch.stack([my, mx], 3).reshape(off.shape)
    gm = None
    if mask is not None:
        gm = (ga * ((hy * hx)[..., None] * v1 + (hy * lx)[..., None] * v2
                    + (ly * hx)[..., None] * v3 + (ly * lx)[..., None] * v4)
              ).sum(-1).reshape(mask.shape)
    return gi, go, gm


def deform_rows(kernels, calls, launches, phase, row_name, backward=False,
                modulated=None):
    """The deformable convolution's row (or its backward's) at the recorded
    calls of one forward (one step): a case a distinct shape, its times
    weighted by its calls; with ``modulated`` also one case at that call
    with a seeded mask (in the row's error, not its times)."""
    import torch

    case_fn = deform_backward_case if backward else deform_case
    name = "deform_conv_backward" if backward else "deform_conv"
    cases, weighted = [], []
    for args, count in distinct(calls):
        c = case_fn(kernels, args, phase, count)
        cases.append(c)
        weighted.append(dict(c, **{k: c[k] * count for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bytes_bound_ms",
            "operations_bound_ms")}))
    extra = {}
    if modulated is not None:
        args = list(modulated)
        x, off = args[:2]
        gen = torch.Generator(device=x.device).manual_seed(7)
        n, _, oh, ow = off.shape
        args[2] = torch.rand(n, off.shape[1] // 2, oh, ow, device=x.device,
                             generator=gen).to(off.dtype)
        c = case_fn(kernels, tuple(args), phase + " (seeded DCNv2 mask)", 0,
                    modulated=True)
        extra = dict(modulated_case=dict(
            max_abs_err=c["max_abs_err"], ms=c["ms"], device_ms=c["device_ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            shape=c["shape"]))
    row = kernel_row(name, weighted, launches, row_name=row_name,
                     dtype=cases[0]["dtype"], path=f"{phase} (1344x1344, batch 2)",
                     distinct_shapes=len(cases), calls=len(calls),
                     **{"calls_per_step" if backward else "calls_per_forward":
                        len(calls)}, **extra)
    if modulated is not None:
        row["max_abs_err"] = max(row["max_abs_err"], extra["modulated_case"][
            "max_abs_err"])
    if backward:
        row["same_bits_twice"] = all(c["same_bits_twice"] for c in cases)
    return row


def mask_rcnn_deform_phases(kernels):
    """``maskrcnn_resnet50_fpn_deform`` (DCNv1 in C3-C5, 13 deformable 3x3s
    a forward) with its offset predictors seeded (``seed_deform_offsets``):
    served from the two raw images in f32 (``mask_rcnn_deform_images``) and
    bf16 (``mask_rcnn_deform_amp``), as ``serve_mask_phases`` holds the
    Mask R-CNN requests, and trained in f32 (``mask_rcnn_deform_train``)
    and bf16 (``mask_rcnn_deform_train_amp``), as ``det_train_phase`` holds
    the train steps, with the gradients of ``DEFORM_GRADS``; each phase
    through both deform kernels; the offsets' statistics of the request and
    of the train step. Then the column kernel at each distinct shape of the
    requests (f32 and bf16 input; one C4 call again with a seeded DCNv2
    mask), and the backward kernels at each of the train steps'."""
    import torch

    calls, launches = serve_mask_phases(
        kernels, "maskrcnn_resnet50_fpn_deform",
        ("mask_rcnn_deform_images", "mask_rcnn_deform_amp"),
        num_params=DEFORM_PARAMS, prepare=seed_deform_offsets,
        require=("deform_conv",))
    per_forward = [a for a in calls[torch.float32]["deform_conv"]][:13]
    offset_stats(per_forward, "mask_rcnn_deform_images")
    c4 = [a for a in per_forward if a[0].shape[1] == 256][1]
    rows = [
        deform_rows(kernels, per_forward, launches["f32"]["deform_conv_f32"],
                    "mask_rcnn_deform_images", "deform_conv", modulated=c4),
        deform_rows(kernels, calls[torch.bfloat16]["deform_conv"][:13],
                    launches["bf16"]["deform_conv_bf16"],
                    "mask_rcnn_deform_amp", "deform_conv_bf16"),
    ]
    del calls, per_forward, c4
    torch.cuda.empty_cache()

    train, tlaunches, first = det_train_phase(
        kernels, "mask_rcnn_deform_train", name="maskrcnn_resnet50_fpn_deform",
        grads=DEFORM_GRADS, masks=True, prepare=seed_deform_offsets,
        require=("deform_conv", "deform_conv_backward"))
    offset_stats(train["deform_conv"][:13], "mask_rcnn_deform_train")
    bwd = train["deform_conv_backward"]
    c4 = [a for a in bwd if a[0].shape[1] == 256][1]
    rows.append(deform_rows(kernels, bwd, tlaunches["deform_conv_backward_f32"],
                            "mask_rcnn_deform_train", "deform_conv_backward",
                            backward=True, modulated=c4))
    del train, bwd, c4
    torch.cuda.empty_cache()
    train, tlaunches, _ = det_train_phase(
        kernels, "mask_rcnn_deform_train_amp",
        name="maskrcnn_resnet50_fpn_deform", grads=DEFORM_GRADS,
        f32_first=first, masks=True, prepare=seed_deform_offsets,
        require=("deform_conv", "deform_conv_backward"))
    rows.append(deform_rows(kernels, train["deform_conv_backward"],
                            tlaunches["deform_conv_backward_bf16"],
                            "mask_rcnn_deform_train_amp",
                            "deform_conv_backward_bf16", backward=True))
    return rows


def check_mapped_boxes(boxes, raw) -> None:
    """``postprocess_boxes`` gave each image [100, 4] finite f32 boxes."""
    import torch

    for bx, r in zip(boxes, raw):
        if tuple(bx.shape) != (100, 4) or bx.dtype != torch.float32 or not bool(
                torch.isfinite(bx).all()):
            raise RuntimeError(f"boxes mapped to a {tuple(r.shape)} image: "
                               f"{tuple(bx.shape)} {bx.dtype}")


# name -> (source, the TPU kernel it replaces)
SOURCES = {
    "nms": ("vision_tpu_torch/csrc/nms.cu", "vision_tpu/ops/_pallas/nms.py:186"),
    "nms_rowscan": ("vision_tpu_torch/csrc/nms_rowscan.cu",
                    "vision_tpu/ops/_pallas/nms.py:252"),
    "window_pool": ("vision_tpu_torch/csrc/window_pool.cu",
                    "vision_tpu/ops/_pallas/window_pool.py:122"),
    "roi_align": ("vision_tpu_torch/csrc/roi_align.cu",
                  "vision_tpu/ops/_pallas/roi_align.py:116"),
    # no pallas_call: the JAX package differentiates both through XLA
    "window_pool_backward": ("vision_tpu_torch/csrc/window_pool_backward.cu",
                             "vision_tpu/ops/poolers.py:82"),
    "roi_align_backward": ("vision_tpu_torch/csrc/roi_align_backward.cu",
                           "vision_tpu/ops/roi_align.py:420"),
    # no pallas_call: XLA gathers and an einsum, differentiated by XLA
    "deform_conv": ("vision_tpu_torch/csrc/deform_conv.cu",
                    "vision_tpu/ops/deform_conv.py:88"),
    "deform_conv_backward": ("vision_tpu_torch/csrc/deform_conv_backward.cu",
                             "vision_tpu/ops/deform_conv.py:88"),
}
WORK = {"nms": nms_work, "nms_rowscan": nms_work, "window_pool": window_work,
        "roi_align": roi_work, "window_pool_backward": window_backward_work,
        "roi_align_backward": roi_backward_work}


def kernel_case(kernels, name, args, path, **meta):
    """One recorded call of kernel ``name`` against its plain version on
    the card (RoIAlign's on the CPU): NMS keep masks bit for bit; f32 pools within 1e-5 of the
    largest plain value (f32 sums in another order); bf16 pools within one
    bf16 step of each element (plus 1e-5 of the largest value); the
    backward kernels the same bits on a second call and, against their
    plain version in f64 on the CPU, in f32 within 1e-5 of the largest sum
    of the summed terms' magnitudes, in bf16 within one bf16 step of each
    element plus that. Prints the case, with its times and bound, and
    returns it."""
    import torch

    exact = name.startswith("nms")
    bf16 = args[0].dtype == torch.bfloat16
    rel_gate = None
    if name.endswith("_backward"):
        # deterministic: the same bits again. Each gradient element sums
        # many terms of both signs, so an f32 sum's error scales with the
        # sum of the terms' magnitudes, not with the result: the kernel is
        # held against the plain version evaluated in f64 (exact weights)
        # on the CPU, within 1e-5 of the largest such sum (the plain
        # version in f64 of |grad|, the weights being non-negative); the
        # error over the largest result is printed beside it, and the f32
        # plain version's on the card. (On the card PyTorch divides by a
        # scalar as a product with its reciprocal, so the plain RoIAlign
        # puts its samples up to an ulp away from the CPU's and the
        # kernels', which divide.)
        first, again = kernels.cuda[name](*args), kernels.cuda[name](*args)
        plain32 = kernels.plain[name](*args)
        torch.cuda.synchronize()
        meta["same_bits_twice"] = bool(torch.equal(first, again))
        cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
        exact64 = kernels.plain[name](cpu[0].double(), *cpu[1:])
        magnitude = float(kernels.plain[name](cpu[0].double().abs(),
                                              *cpu[1:]).max())
        scale64 = max(float(exact64.abs().max()), 1e-30)
        err64 = float((first.cpu().double() - exact64).abs().max())
        plain_err64 = float((plain32.cpu().double() - exact64).abs().max())
        rel_gate = err64 / max(magnitude, 1e-30)
        if bf16:
            # rounded once from an f32 sum: within one bf16 step of the
            # exact value (2**-7 of its magnitude), plus the f32 round-off
            # of the sum, 1e-5 of the largest sum of term magnitudes
            step = 2.0 ** -7 * exact64.abs() + 1e-5 * magnitude
            rel_gate = float(((first.cpu().double() - exact64).abs()
                              / step.clamp(min=1e-30)).max())
            meta["max_err_vs_f64_in_bf16_steps"] = rel_gate
        meta.update(err_vs_f64_over_term_sum=err64 / max(magnitude, 1e-30),
                    plain_err_vs_f64_over_term_sum=plain_err64 / max(
                        magnitude, 1e-30),
                    max_rel_err_vs_f64=err64 / scale64,
                    plain_max_rel_err_vs_f64=plain_err64 / scale64)
        del first, again, exact64, plain32
        if not meta["same_bits_twice"]:
            raise RuntimeError(f"{name} ({path}): two calls on the same "
                               "inputs differ")
    # RoIAlign against its plain version on the CPU: on the card PyTorch
    # divides by a scalar as a product with its reciprocal, which moves the
    # plain version's samples by up to an ulp (1.2e-4 px at 1344 px, 3.7e-5
    # of a 0/1 mask target), where the kernel and the CPU divide
    err, rel, ms, dev_ms, plain_ms = compare_kernel(
        kernels.cuda[name], kernels.plain[name], args, exact=exact,
        on_cpu=name == "roi_align")
    nbytes, ops, peak = WORK[name](args)
    b_ms, b_by = bound_ms(nbytes, ops, peak)
    tol = 0.0 if exact else 1.0 if bf16 else 1e-5
    if name == "window_pool":
        shape = [list(args[3].shape), list(args[0].shape)]
    elif name == "window_pool_backward":  # grad, w_y, pyramid
        shape = [list(args[0].shape), list(args[3].shape), list(args[5])]
    elif name == "roi_align_backward":  # grad, RoIs, input
        shape = [list(args[0].shape), list(args[1].shape), list(args[2])]
    else:
        shape = [list(args[0].shape), list(args[1].shape)]
    case = dict(kernel=name, path=path, dtype=str(args[0].dtype)[6:],
                shape=shape, **meta, max_abs_err=err,
                **{"max_err_in_bf16_steps" if bf16 else "max_rel_err": rel},
                tol=tol, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                bytes_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                operations_bound_ms=ops / peak * 1e3)
    emit("kernel_case", **case)
    if (rel if rel_gate is None else rel_gate) > tol:
        raise RuntimeError(f"{name} ({path}, {meta}) disagrees with its plain "
                           f"version: {rel} > {tol}")
    return case


def summed(cases) -> dict:
    """The cases' times and bounds summed: one forward or request."""
    out = {k: sum(c[k] for c in cases) for k in (
        "ms", "device_ms", "plain_ms", "bound_ms", "bytes_bound_ms",
        "operations_bound_ms")}
    by_bytes = out["bytes_bound_ms"] >= out["operations_bound_ms"]
    return dict(out, max_abs_err=max(c["max_abs_err"] for c in cases),
                bound_by="bytes" if by_bytes else "operations",
                calls=len(cases))


def kernel_row(name, cases, launches, row_name=None, **extra) -> dict:
    """The ``kernels`` line's row of ``name`` at ``cases``."""
    source, replaces = SOURCES[name]
    return {"name": row_name or name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, **summed(cases),
            "library_ms": None, **extra}


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
    resnet50_preset_check(model)
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


def resnet50_preset_check(model) -> None:
    """A seeded batch of 8 uint8 375x500 images through the weights'
    ``ImageClassification`` preset (resize 232, crop 224) and the eval
    model on the card, against the same on the CPU: logits within 1e-3 of
    the largest. (The uint8 resize of each side may round a near-tie the
    other way: one level of one pixel.)"""
    import torch

    from vision_tpu_torch.models import ResNet50_Weights, get_model

    gen = torch.Generator().manual_seed(3)
    raw = torch.randint(0, 256, (8, 3, 375, 500), dtype=torch.uint8, generator=gen)
    weights = ResNet50_Weights.DEFAULT
    with torch.inference_mode():
        x = torch.stack([weights.transforms()(r) for r in raw])
        logits = model(x).cpu()
        cpu_preset = weights.transforms(device="cpu")
        x_cpu = torch.stack([cpu_preset(r) for r in raw])
        want = get_model("resnet50", seed=0, device="cpu")(x_cpu)
    rel = float((logits - want).abs().max() / want.abs().max())
    input_err = float((x.cpu() - x_cpu).abs().max())
    emit("resnet50_preset", images=list(raw.shape), preset=repr(weights.transforms(
        device="cpu")), input=list(x.shape), input_device=str(x.device),
        max_input_err=input_err, logits_rel_err=rel, tol=1e-3)
    if tuple(x.shape) != (8, 3, 224, 224) or not rel <= 1e-3:
        raise RuntimeError("ResNet-50 through its preset on the card disagrees "
                           "with the CPU")


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


def check_detections(dets, ref, batch=1, score_tol=1e-4, box_tol=1e-2,
                     phase="faster_rcnn") -> None:
    import torch

    for t in dets:
        if not torch.isfinite(t.float()).all():
            raise RuntimeError("non-finite detections")
    if (tuple(dets.boxes.shape) != (batch, 100, 4)
            or tuple(dets.valid.shape) != (batch, 100)):
        raise RuntimeError(f"bad Detections shapes {tuple(dets.boxes.shape)}")
    valid = dets.valid
    n_valid = int(valid.sum())
    same_valid = bool(torch.equal(valid, ref.valid))
    label_ok = bool(torch.equal(dets.labels[valid], ref.labels[valid]))
    score_err = float((dets.scores[valid] - ref.scores[valid]).abs().max()) if n_valid else 0.0
    box_err = float((dets.boxes[valid] - ref.boxes[valid]).abs().max()) if n_valid else 0.0
    emit("detections_vs_plain", path=phase, valid=n_valid,
         valid_per_image=valid.sum(1).tolist(), same_valid=same_valid,
         labels_equal=label_ok, max_score_err=score_err, score_tol=score_tol,
         max_box_err=box_err, box_tol=box_tol)
    if int(valid.sum(1).min()) == 0:
        raise RuntimeError("an image without valid detections: the comparison "
                           "is vacuous")
    if not (same_valid and label_ok and score_err <= score_tol
            and box_err <= box_tol):
        raise RuntimeError(f"{phase}: kernel path disagrees with the plain path")


def kernel_phases(kernels, calls, launches):
    """Each kernel against its plain version on the main path's recorded
    inputs, plus the extra RoIAlign cases (aligned, adaptive grid) on its
    P2 map and RoIs, which count in the row's error and not in its times."""
    rows = []
    for name in ("nms", "window_pool", "roi_align"):
        cases = [kernel_case(kernels, name, args, "faster_rcnn")
                 for args in calls[name]]
        extra = {}
        if name == "roi_align":
            inp, rois, size, scale = calls[name][0][:4]
            worst = max(kernel_case(kernels, name, (inp, rois, size, scale, sr,
                                                    aligned), "faster_rcnn",
                                    sampling_ratio=sr, aligned=aligned)["max_abs_err"]
                        for sr, aligned in ((2, True), (0, False)))
            extra["max_abs_err"] = max(worst, summed(cases)["max_abs_err"])
        if name in ("nms", "roi_align"):
            extra["redesigned"] = "PR 5"
        rows.append(kernel_row(name, cases, launches[name], **extra))
    return rows


if __name__ == "__main__":
    sys.exit(main())
