"""Where the time of the classification zoo's cells goes on the card.

    python -m vision_tpu_torch.tools.profile_zoo [--cell NAME ...]
        [--mode serve_f32 serve_bf16 train_amp] [--steps 3] [--trace DIR]

The cells of ``chip_smoke.py``'s zoo phases (``tools/zoo.py``: the JAX
bench's EfficientNet-V2-S at 384 px, batch 32; ConvNeXt-T and Swin-T at
224 px, batch 64; seeded weights, calibrated batch norms, TF32 off,
cuDNN's deterministic algorithms): served in f32 and in bf16
(``to_bf16``), and the amp SGD step at batch 32
(the default stochastic depth and dropout drawn from a CUDA generator).
For each cell and mode, one JSON line: ``--steps`` batches or steps after
two warm-up ones under ``torch.profiler``: the wall ms of each (ended by a
host read), the summed device kernel time a call (their ratio is the busy
share), the launches a call, img/s, peak memory, the device ms by kernel
group (convolution, matmul, layer norm, elementwise, reduction, softmax,
copy, rest) and the top kernels; served, also the norms' and
activations' device ms (elementwise, layer norm, reduction) beside the
least time their bytes take (``elementwise_bound_ms``). Chrome traces go
to ``--trace``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from vision_tpu_torch.ops.misc import BatchNorm2d
from vision_tpu_torch.tools import zoo
from vision_tpu_torch.tools.profile_faster_rcnn import _device_us

MODES = ("serve_f32", "serve_bf16", "train_amp")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

# kernel-name fragments -> group, first match wins; cuDNN's convolutions
# on Hopper are ``sm90_xmma_fprop`` / ``dgrad`` / ``wgrad`` kernels, which
# must match before the products' ``xmma``
_GROUPS = (
    ("conv", "convolution"),
    ("fprop", "convolution"),
    ("dgrad", "convolution"),
    ("wgrad", "convolution"),
    ("implicit", "convolution"),
    ("winograd", "convolution"),
    ("depthwise", "convolution"),
    ("gemm", "matmul"),
    ("gemv", "matmul"),
    ("nvjet", "matmul"),
    ("cutlass", "matmul"),
    ("xmma", "matmul"),
    ("layer_norm", "layer norm"),
    ("softmax", "softmax"),
    ("reduce", "reduction"),
    ("elementwise", "elementwise"),
    ("copy", "copy"),
    ("cat", "copy"),
)


def group(name: str) -> str:
    low = name.lower()
    for frag, grp in _GROUPS:
        if frag in low:
            return grp
    return "rest"


def _kernels(prof) -> list:
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("Optimizer.")]


def profiled(fn, steps: int, trace: Path) -> dict:
    """``steps`` calls of ``fn`` under ``torch.profiler``: wall ms, device
    ms by group, launches, top kernels."""
    torch.cuda.reset_peak_memory_stats()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
    kernels = _kernels(prof)
    groups = defaultdict(float)
    for e in kernels:
        groups[group(e.key)] += _device_us(e) / 1e3 / steps
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    device_ms = sum(groups.values())
    wall_ms = statistics.median(walls)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    return {
        "wall_ms": walls, "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "launches": sum(e.count for e in kernels) / steps,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device_ms_by_group": dict(sorted(groups.items(),
                                          key=lambda kv: -kv[1])),
        "top_kernels": [{"name": e.key[:90],
                         "ms_per_call": _device_us(e) / 1e3 / steps,
                         "launches_per_call": e.count / steps} for e in top],
    }


# the layers whose work is elementwise: read the input once, write the
# output once
_ELEMENTWISE = (BatchNorm2d, torch.nn.LayerNorm, torch.nn.SiLU, torch.nn.GELU,
                torch.nn.ReLU, torch.nn.ReLU6, torch.nn.Hardswish,
                torch.nn.Hardsigmoid, torch.nn.Sigmoid)


def elementwise_bound_ms(model: torch.nn.Module, x: torch.Tensor) -> float:
    """The least device time of one forward's norms and activations: the
    bytes of their inputs and outputs (each read or written once) over the
    card's memory rate. The residual adds, the squeeze-excitation's scaling
    and Swin's window shuffles are not counted."""
    total = 0

    def hook(module, inputs, output):
        nonlocal total
        total += sum(t.numel() * t.element_size() for t in (inputs[0], output))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, _ELEMENTWISE)]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return total / PEAK_BYTES_PER_S * 1e3


def run_cell(name: str, mode: str, steps: int, trace_dir: Path) -> dict:
    size, batch, _ = zoo.CELLS[name]
    model = zoo.seeded_model(name, size)
    if mode == "train_amp":
        batch = zoo.TRAIN_BATCH
        data = zoo.batch_of(batch, size, 2)
        step = zoo.sgd_step(model, torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def call():
            return float(step(data, gen)["loss"])
    else:
        x = zoo.images(batch, size)
        if mode == "serve_bf16":
            model, x = zoo.to_bf16(model), x.to(torch.bfloat16)

        def call():
            with torch.inference_mode():
                return float(model(x)[0, 0])
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    out = profiled(call, steps, trace_dir / f"zoo_{name}_{mode}.json")
    if mode != "train_amp":
        groups = out["device_ms_by_group"]
        out["elementwise_bound_ms"] = elementwise_bound_ms(model, x)
        out["elementwise_device_ms"] = sum(groups.get(g, 0.0) for g in (
            "elementwise", "layer norm", "reduction"))
    out = {"device": torch.cuda.get_device_name(0), "model": name,
           "mode": mode, "image_size": size, "batch": batch,
           "images_per_s": batch / statistics.median(out["wall_ms"]) * 1e3,
           **out}
    del model
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", nargs="+", choices=sorted(zoo.CELLS),
                    default=list(zoo.CELLS))
    ap.add_argument("--mode", nargs="+", choices=MODES, default=list(MODES))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default="build/profile")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("profile_zoo: no CUDA device")
    # as chip_smoke.py runs: TF32 off, cuDNN's deterministic algorithms
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    for name in args.cell:
        for mode in args.mode:
            print(json.dumps(run_cell(name, mode, args.steps,
                                      Path(args.trace))), flush=True)


if __name__ == "__main__":
    main()
