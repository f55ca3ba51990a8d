"""Where the time of one ResNet-50 train step goes, on the card.

    python -m vision_tpu_torch.tools.profile_resnet_train \\
        [--dtype bf16|f32] [--no-fused] [--batch 32] [--steps 3]

Same model, batch and optimizer as ``chip_smoke.py``'s train phases
(``get_model("resnet50", fused_bn=True, seed=0)``, a seeded normal batch of
224x224 images with seeded labels, SGD lr 0.1 momentum 0.9 weight decay
1e-4, TF32 off). Runs ``--steps`` steps under ``torch.profiler`` after two
warm-up steps and prints JSON lines: per step the host wall time and the
summed device kernel time (their ratio is the device's busy share), how
many of the fused blocks' ``[N*H*W, C]`` row matrices were views of a
channels-last tensor and how many had to be copied, the device time by
kernel group, and the top kernels by device time. The Chrome trace goes to
``--trace``.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from vision_tpu_torch.models import get_model, resnet
from vision_tpu_torch.parallel import make_train_step
from vision_tpu_torch.tools.profile_faster_rcnn import _device_us

# kernel-name fragments -> group, first match wins
_GROUPS = (
    ("matmul_stats", "matmul_stats kernel"),
    ("column_sums", "matmul_stats kernel"),
    ("dgrad", "convolution"),
    ("wgrad", "convolution"),
    ("fprop", "convolution"),
    ("conv", "convolution"),
    ("cudnn", "convolution"),
    ("nchwToNhwc", "layout copy"),
    ("nhwcToNchw", "layout copy"),
    ("gemm", "matmul"),
    ("gemv", "matmul"),
    ("cutlass", "matmul"),
    ("max_pool", "pooling"),
    ("multi_tensor", "optimizer"),
    ("elementwise", "elementwise"),
    ("reduce", "reduction"),
    ("softmax", "loss"),
    ("nll", "loss"),
)


def _group(name: str) -> str:
    for frag, group in _GROUPS:
        if frag in name:
            return group
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--no-fused", action="store_true",
                    help="the standard conv -> BN -> ReLU path")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default="build/profile/resnet_train_trace.json")
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = get_model("resnet50", fused_bn=not args.no_fused, seed=0)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9,
                                weight_decay=1e-4)
    step = make_train_step(
        model, optimizer,
        compute_dtype=torch.bfloat16 if args.dtype == "bf16" else None)
    gen = torch.Generator().manual_seed(1)
    batch = {
        "image": torch.randn(args.batch, 3, 224, 224, generator=gen).cuda(),
        "label": torch.randint(0, 1000, (args.batch,), generator=gen).cuda(),
    }
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()

    rows = {"views": 0, "copies": 0}
    make_rows = resnet._rows

    def counted_rows(x):
        out = make_rows(x)
        same = out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
        rows["views" if same else "copies"] += 1
        return out

    resnet._rows = counted_rows
    step(batch)
    resnet._rows = make_rows
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step(batch)
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
        "device": torch.cuda.get_device_name(0), "model": "resnet50",
        "fused_bn": not args.no_fused, "dtype": args.dtype,
        "batch": args.batch, "size": 224,
        "wall_ms_per_step": walls, "device_ms_per_step": device_ms,
        "busy_share": device_ms / wall_ms,
        "images_per_s": args.batch / wall_ms * 1e3,
        "kernel_launches_per_step": sum(e.count for e in kernels) / args.steps,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "row_matrices_per_forward": rows,
        "direct_copy": {
            "launches_per_step": sum(
                e.count for e in kernels if "direct_copy" in e.key) / args.steps,
            "ms_per_step": sum(
                _device_us(e) for e in kernels
                if "direct_copy" in e.key) / 1e3 / args.steps,
        },
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
