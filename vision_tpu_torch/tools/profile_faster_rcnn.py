"""Where the time of one Faster R-CNN ResNet-50-FPN forward goes, on the card.

    python -m vision_tpu_torch.tools.profile_faster_rcnn [--steps 3]

Same model and input as ``chip_smoke.py`` (seeded random weights with
``cls_score`` scaled x30, one 832x832 f32 image, TF32 off). Runs
``--steps`` forwards under ``torch.profiler`` after two warm-up forwards
and prints JSON lines: per step the host wall time
and the summed device kernel time (their ratio is the device's busy
share), the device time by kernel group, and the top kernels by device
time. The Chrome trace goes to ``--trace``.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from vision_tpu_torch.models import get_model

# kernel-name fragments -> group, first match wins
_GROUPS = (
    ("nms_", "nms kernel"),
    ("window_pool", "window-pool kernel"),
    ("roi_align", "roi_align kernel"),
    ("fprop", "convolution"),
    ("conv", "convolution"),
    ("cudnn", "convolution"),
    ("gemm", "matmul"),
    ("sort", "sort"),
    ("Sort", "sort"),
    ("radix", "sort"),
    ("elementwise", "elementwise"),
    ("reduce", "reduction"),
)


def _group(name: str) -> str:
    for frag, group in _GROUPS:
        if frag in name:
            return group
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default="build/profile/faster_rcnn_trace.json")
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = get_model("fasterrcnn_resnet50_fpn", seed=0)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.weight.mul_(30.0)
    images = torch.randn(1, 3, 832, 832,
                         generator=torch.Generator().manual_seed(1)).cuda()
    with torch.inference_mode():
        for _ in range(2):
            model(images)
        torch.cuda.synchronize()
        walls = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                t0 = time.perf_counter()
                model(images)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    groups = defaultdict(float)
    for e in kernels:
        groups[_group(e.key)] += _device_us(e) / 1e3 / args.steps
    device_ms = sum(groups.values())
    wall_ms = sum(walls) / len(walls)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "size": 832,
        "wall_ms_per_step": walls, "device_ms_per_step": device_ms,
        "busy_share": device_ms / wall_ms,
        "kernel_launches_per_step": sum(e.count for e in kernels) / args.steps,
    }))
    print(json.dumps({"device_ms_by_group": dict(
        sorted(groups.items(), key=lambda kv: -kv[1]))}))
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    print(json.dumps({"top_kernels": [
        {"name": e.key[:90], "ms_per_step": _device_us(e) / 1e3 / args.steps,
         "calls_per_step": e.count / args.steps} for e in top]}))
    Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
