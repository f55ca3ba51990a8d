"""Where the time of one ViT-B/16 recipe step goes, on the card.

    python -m vision_tpu_torch.tools.profile_vit_train \\
        [--dtype bf16|f32] [--steps 3] [--trace PATH]

The cell of ``chip_smoke.py``'s ``vit_b16_train_amp`` / ``vit_b16_train``
(``tools/vit_train.py``: ``seeded_vit``, the seeded 256x256 uint8 frames,
``RecipeStep``; TF32 off). Prints JSON lines:

* ``stages``: the device ms of each stage of a step, each queued behind a
  spin kernel so that the host's launch time stays outside its CUDA
  events, the median of three: the augmentation's crop + flip,
  RandAugment, ToDtype + Normalize, MixUp/CutMix; the forward with the
  loss, the backward, clipping + AdamW + the schedule, the EMA update
  (the step's pieces as ``make_train_step`` runs them);
* ``randaugment_top_kernels``: one RandAugment call (the largest stage)
  under ``torch.profiler``, its kernels by device time;
* ``profile``: ``--steps`` whole steps after two warm-up steps under
  ``torch.profiler``: the wall ms a step, the summed device kernel time
  (their ratio is the busy share), the launches a step, img/s and peak
  memory; then the device ms by kernel group and the top kernels. The
  Chrome trace goes to ``--trace``.
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

from vision_tpu_torch.parallel import VIT_B_16_RECIPE, cross_entropy_loss
from vision_tpu_torch.tools.profile_faster_rcnn import _device_us
from vision_tpu_torch.tools.vit_train import (
    TRAIN_BATCH,
    RecipeStep,
    frames,
    seeded_vit,
)

SPIN_CYCLES = 60_000_000  # ~35 ms: longer than the host takes to queue a stage

# kernel-name fragments -> group, first match wins
_GROUPS = (
    ("flash", "attention"),
    ("fmha", "attention"),
    ("attention", "attention"),
    ("gemm", "matmul"),
    ("gemv", "matmul"),
    ("nvjet", "matmul"),  # cuBLAS's Hopper kernels
    ("cutlass", "matmul"),
    ("sm90_xmma", "matmul"),
    ("layer_norm", "layer norm"),
    ("multi_tensor", "optimizer"),
    ("foreach", "optimizer"),
    ("softmax", "softmax, loss"),
    ("nll", "softmax, loss"),
    ("conv", "convolution"),
    ("index", "gather, scatter"),
    ("gather", "gather, scatter"),
    ("scatter", "gather, scatter"),
    ("elementwise", "elementwise"),
    ("reduce", "reduction"),
    ("copy", "copy"),
    ("cat", "copy"),
)


def _group(name: str) -> str:
    low = name.lower()
    for frag, group in _GROUPS:
        if frag in low:
            return group
    return "other"


def queued_ms(fn) -> tuple:
    """(device ms of ``fn``'s work, ``fn``'s result), the work queued behind
    a spin kernel."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def stage_ms(run: RecipeStep, raw, gen, compute_dtype) -> dict:
    """One step split into its stages, each timed on the device."""
    aug, model = run.augment, run.model
    times = defaultdict(list)
    for _ in range(3):
        draws = aug.draw(raw["image"].shape, gen)
        t, x = queued_ms(lambda: aug.crop.apply(raw["image"], draws["crop"]))
        times["crop_flip"].append(t)
        t, x = queued_ms(lambda: aug.auto_augment.apply(x, draws["auto_augment"]))
        times["randaugment"].append(t)
        t, x = queued_ms(lambda: aug.post.apply(x, draws["post"]))
        times["normalize"].append(t)
        t, (x, y) = queued_ms(lambda: aug.mix.apply((x, raw["label"]),
                                                     draws["mix"]))
        times["mixup_cutmix"].append(t)

        model.train()
        run.optimizer.zero_grad(set_to_none=True)

        def forward():
            if compute_dtype is None:
                logits = model(x)
            else:
                cast = {n: p.to(compute_dtype)
                        for n, p in model.named_parameters()}
                logits = torch.func.functional_call(
                    model, cast, (x.to(compute_dtype),))
            return cross_entropy_loss(logits, y,
                                      VIT_B_16_RECIPE["label_smoothing"])

        t, loss = queued_ms(forward)
        times["forward_loss"].append(t)
        t, _ = queued_ms(loss.backward)
        times["backward"].append(t)

        def update():
            torch.nn.utils.clip_grad_norm_(model.parameters(),
                                           VIT_B_16_RECIPE["clip_grad_norm"])
            run.optimizer.step()
            run.scheduler.step()

        t, _ = queued_ms(update)
        times["clip_adamw"].append(t)
        t, _ = queued_ms(lambda: run.ema.update(model))
        times["ema"].append(t)
    return {k: statistics.median(v) for k, v in times.items()}


def _kernels(prof) -> list:
    """The kernels' events: the optimizer's ``record_function`` range
    (``Optimizer.step#AdamW.step``) shows as a device event spanning its
    kernels, and is left out."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("Optimizer.")]


def _top(prof, calls: int, k: int) -> list:
    top = sorted(_kernels(prof), key=_device_us, reverse=True)[:k]
    return [{"name": e.key[:90], "ms_per_call": _device_us(e) / 1e3 / calls,
             "launches_per_call": e.count / calls} for e in top]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default="build/profile/vit_train_trace.json")
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    compute_dtype = torch.bfloat16 if args.dtype == "bf16" else None
    model = seeded_vit()
    run = RecipeStep(model, compute_dtype)
    raw = frames()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):
        run(raw, gen)
    torch.cuda.synchronize()
    stages = stage_ms(run, raw, gen, compute_dtype)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "model": "vit_b_16",
                      "dtype": args.dtype, "batch": TRAIN_BATCH,
                      "stages_device_ms": stages,
                      "stages_sum_ms": sum(stages.values())}), flush=True)

    aug = run.augment
    draws = aug.draw(raw["image"].shape, gen)
    crop = aug.crop.apply(raw["image"], draws["crop"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        aug.auto_augment.apply(crop, draws["auto_augment"])
        torch.cuda.synchronize()
    print(json.dumps({"randaugment_top_kernels": _top(prof, 1, 12)}), flush=True)

    torch.cuda.reset_peak_memory_stats()
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            float(run(raw, gen)["loss"])
            walls.append((time.perf_counter() - t0) * 1e3)
    kernels = _kernels(prof)
    groups = defaultdict(float)
    for e in kernels:
        groups[_group(e.key)] += _device_us(e) / 1e3 / args.steps
    device_ms = sum(groups.values())
    wall_ms = statistics.median(walls)
    print(json.dumps({
        "wall_ms_per_step": walls, "device_ms_per_step": device_ms,
        "busy_share": device_ms / wall_ms,
        "images_per_s": TRAIN_BATCH / wall_ms * 1e3,
        "kernel_launches_per_step": sum(e.count for e in kernels) / args.steps,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }), flush=True)
    print(json.dumps({"device_ms_by_group": dict(
        sorted(groups.items(), key=lambda kv: -kv[1]))}), flush=True)
    print(json.dumps({"top_kernels": _top(prof, args.steps, 15)}), flush=True)
    Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
