"""Where the time of the zoo's cells goes on the card.

    python -m vision_tpu_torch.tools.profile_zoo [--cell NAME ...]
        [--mode serve_f32 serve_bf16 train_amp train_f32] [--steps 3]
        [--trace DIR]

The cells of ``chip_smoke.py``'s zoo phases (``tools/zoo.py``: the JAX
bench's EfficientNet-V2-S at 384 px, batch 32; ConvNeXt-T and Swin-T at
224 px, batch 64; seeded weights, calibrated batch norms, TF32 off,
cuDNN's deterministic algorithms): served in f32 and in bf16
(``to_bf16``), and the amp SGD step at batch 32
(the default stochastic depth and dropout drawn from a CUDA generator);
and of its dense phases (``tools/dense.py``: DeepLabV3-ResNet-50 at 520,
batch 4; RAFT-large on 512x512 pairs, batch 2, 12 flow updates; MViT-V2-S
and Swin3D-T on 16x224x224 clips, batch 4): served in f32 and bf16,
DeepLabV3's segmentation step at the recipe's 480x480, batch 8, in amp
(``train_amp``) and f32 (``train_f32``), RAFT's flow step at 368x496,
batch 2, in f32 (``train_f32``). A cell runs the asked modes it has.
For each cell and mode, one JSON line: ``--steps`` batches or steps after
two warm-up ones under ``torch.profiler``: the wall ms of each (ended by a
host read), the summed device kernel time a call (their ratio is the busy
share), the launches a call, img/s (a classifier's ``images_per_s`` at
``image_size``; a dense cell's ``samples_per_s``, of images, pairs or
clips, at ``size``), peak memory, the device ms by kernel
group (convolution, matmul, layer norm, elementwise, reduction, softmax,
copy, rest) and the top kernels; served, also the norms' and
activations' device ms (elementwise, layer norm, reduction) beside the
least time their bytes take (``elementwise_bound_ms``), and where the
model has depthwise convolutions their bytes' least time
(``depthwise_conv_bound_ms``). Chrome traces go to ``--trace``.
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
from vision_tpu_torch.tools import dense, zoo
from vision_tpu_torch.tools.profile_faster_rcnn import _device_us

MODES = ("serve_f32", "serve_bf16", "train_amp", "train_f32")
CELLS = sorted(zoo.CELLS) + sorted(dense.CELLS)
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


def _depthwise(m: torch.nn.Module) -> bool:
    return isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)) and \
        m.groups > 1 and m.groups == m.in_channels


def _elementwise(m: torch.nn.Module) -> bool:
    return isinstance(m, _ELEMENTWISE)


def bound_ms(model: torch.nn.Module, *args, pick=_elementwise) -> float:
    """The least device time of one forward's modules that ``pick``
    accepts: the bytes of their inputs and outputs (each read or written
    once) over the card's memory rate. The default, the norms and
    activations, leaves out the residual adds, the squeeze-excitation's
    scaling and Swin's window shuffles."""
    total = 0

    def hook(module, inputs, output):
        nonlocal total
        total += sum(t.numel() * t.element_size() for t in (inputs[0], output))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if pick(m)]
    try:
        with torch.inference_mode():
            model(*args)
    finally:
        for h in handles:
            h.remove()
    return total / PEAK_BYTES_PER_S * 1e3


def has_mode(name: str, mode: str) -> bool:
    if mode.startswith("serve"):
        return True
    if name in zoo.CELLS:
        return mode == "train_amp"
    k = dense.kind(name)
    return k == "segmentation" or (k == "flow" and mode == "train_f32")


def _zoo_call(name: str, mode: str):
    """(model, the serving call's inputs or None, the call, batch,
    size)."""
    size, batch = zoo.CELLS[name]
    model = zoo.seeded_model(name, size)
    if mode == "train_amp":
        data = zoo.batch_of(zoo.TRAIN_BATCH, size, 2)
        step = zoo.sgd_step(model, torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(0)
        return (model, None, lambda: float(step(data, gen)["loss"]),
                zoo.TRAIN_BATCH, size)
    x = zoo.images(batch, size)
    if mode == "serve_bf16":
        model, x = zoo.to_bf16(model), x.to(torch.bfloat16)

    def call():
        with torch.inference_mode():
            return float(model(x)[0, 0])
    return model, (x,), call, batch, size


def _dense_call(name: str, mode: str):
    size, batch = dense.CELLS[name]
    train = None if mode.startswith("serve") else (
        torch.bfloat16 if mode == "train_amp" else torch.float32)
    if train is None:
        model = dense.seeded_model(name, size)
        args = dense.inputs(name, batch, size)
        if mode == "serve_bf16":
            model = dense.to_bf16(model)
            args = tuple(a.to(torch.bfloat16) for a in args)

        def call():
            with torch.inference_mode():
                return float(dense.serve(model, name, args).flatten()[0])
        return model, args, call, batch, size
    if dense.kind(name) == "flow":
        size, batch = dense.FLOW_TRAIN
        model = dense.seeded_model(name, size)
        data = dense.flow_batch(batch, size, 2)
        step = dense.flow_step(model)
        return model, None, lambda: float(step(data)["loss"]), batch, size
    size, batch = dense.SEG_TRAIN
    model = dense.seeded_model(name, size)
    data = dense.seg_batch(batch, size, 2)
    step = dense.seg_step(model, None if train == torch.float32 else train)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return model, None, lambda: float(step(data, gen)["loss"]), batch, size


def run_cell(name: str, mode: str, steps: int, trace_dir: Path) -> dict:
    model, args, call, batch, size = (
        _zoo_call if name in zoo.CELLS else _dense_call)(name, mode)
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    out = profiled(call, steps, trace_dir / f"zoo_{name}_{mode}.json")
    if args is not None:
        groups = out["device_ms_by_group"]
        out["elementwise_bound_ms"] = bound_ms(model, *args)
        if any(_depthwise(m) for m in model.modules()):
            # depthwise convolutions (MViT's pooling, EfficientNet's)
            out["depthwise_conv_bound_ms"] = bound_ms(model, *args,
                                                      pick=_depthwise)
        out["elementwise_device_ms"] = sum(groups.get(g, 0.0) for g in (
            "elementwise", "layer norm", "reduction"))
    rate = batch / statistics.median(out["wall_ms"]) * 1e3
    # the classifiers keep their keys; a dense cell's size may be (T, H)
    shape = ({"image_size": size, "images_per_s": rate} if name in zoo.CELLS
             else {"size": size, "samples_per_s": rate})
    out = {"device": torch.cuda.get_device_name(0), "model": name,
           "mode": mode, **shape, "batch": batch, **out}
    del model
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", nargs="+", choices=CELLS, default=list(zoo.CELLS))
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
            if has_mode(name, mode):
                print(json.dumps(run_cell(name, mode, args.steps,
                                          Path(args.trace))), flush=True)


if __name__ == "__main__":
    main()
