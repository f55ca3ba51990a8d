"""Where the time of one ViT recipe step, or one served batch, goes on the
card.

    python -m vision_tpu_torch.tools.profile_vit_train \\
        [--cell train224|train384|serve512] [--dtype bf16|f32] [--steps 3]
        [--trace PATH]

The cells of ``chip_smoke.py`` (``tools/vit_train.py``: ``seeded_vit``, the
seeded uint8 frames, ``RecipeStep``; TF32 off): ``train224`` is
``vit_b16_train_amp`` / ``vit_b16_train`` (ViT-B/16, 256x256 frames, batch
128); ``train384`` is ``vit_b16_384_train_amp`` / ``vit_b16_384_train``
(ViT-B/16 at 384 px, 448x448 frames, batch 64); ``serve512`` is
``vit_l16_512_forward_amp`` / ``vit_l16_512_forward`` (ViT-L/16 at 512 px,
a batch of 32 images; its lines are ``forward_device_ms`` and
``profile``). The device time of the flash-attention kernels is split into
``flash forward``, ``flash backward dk, dv`` and ``flash backward dq``;
PyTorch's own fused attention (below the gate) counts as ``attention``.
A train cell prints JSON lines:

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
    CROP,
    CROP_384,
    FRAME,
    FRAME_384,
    SERVE_BATCH_512,
    TRAIN_BATCH,
    TRAIN_BATCH_384,
    RecipeStep,
    frames,
    seeded_vit,
)

SPIN_CYCLES = 60_000_000  # ~35 ms: longer than the host takes to queue a stage

# cell -> (model, image size, batch, frame, train)
CELLS = {
    "train224": ("vit_b_16", CROP, TRAIN_BATCH, FRAME, True),
    "train384": ("vit_b_16", CROP_384, TRAIN_BATCH_384, FRAME_384, True),
    "serve512": ("vit_l_16", 512, SERVE_BATCH_512, None, False),
}

# kernel-name fragments -> group, first match wins
_GROUPS = (
    ("vt_flash_fwd", "flash forward"),
    ("vt_flash_dkv", "flash backward dk, dv"),
    ("vt_flash_dq", "flash backward dq"),
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


def profile_steps(fn, steps: int, trace: str) -> tuple:
    """``steps`` calls of ``fn`` (each ending in a host read) under
    ``torch.profiler``: the wall ms of each, the summed device ms a call by
    kernel group, the launches a call, and the profile."""
    torch.cuda.reset_peak_memory_stats()
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
    kernels = _kernels(prof)
    groups = defaultdict(float)
    for e in kernels:
        groups[_group(e.key)] += _device_us(e) / 1e3 / steps
    Path(trace).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(trace)
    return walls, groups, sum(e.count for e in kernels) / steps, prof


def report(walls, groups, launches, prof, steps, batch, unit) -> None:
    device_ms = sum(groups.values())
    wall_ms = statistics.median(walls)
    print(json.dumps({
        f"wall_ms_per_{unit}": walls, f"device_ms_per_{unit}": device_ms,
        "busy_share": device_ms / wall_ms,
        "images_per_s": batch / wall_ms * 1e3,
        f"kernel_launches_per_{unit}": launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }), flush=True)
    print(json.dumps({"device_ms_by_group": dict(
        sorted(groups.items(), key=lambda kv: -kv[1]))}), flush=True)
    print(json.dumps({"top_kernels": _top(prof, steps, 15)}), flush=True)


def serve_cell(name, size, batch, dtype, steps, trace) -> None:
    """Batches of seeded images through the model in inference mode."""
    model = seeded_vit(name=name, image_size=size)
    x = torch.randn(batch, 3, size, size,
                    generator=torch.Generator().manual_seed(0)).cuda()
    if dtype is not None:
        model, x = model.to(dtype), x.to(dtype)
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        ms = statistics.median(queued_ms(lambda: model(x))[0] for _ in range(3))
        print(json.dumps({"device": torch.cuda.get_device_name(0), "model": name,
                          "image_size": size, "batch": batch,
                          "dtype": "f32" if dtype is None else "bf16",
                          "forward_device_ms": ms}), flush=True)
        walls, groups, launches, prof = profile_steps(
            lambda: float(model(x)[0, 0]), steps, trace)
    report(walls, groups, launches, prof, steps, batch, "batch")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=sorted(CELLS), default="train224")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default="build/profile/vit_train_trace.json")
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    compute_dtype = torch.bfloat16 if args.dtype == "bf16" else None
    name, size, batch, frame, train = CELLS[args.cell]
    if not train:
        serve_cell(name, size, batch, compute_dtype, args.steps, args.trace)
        return
    model = seeded_vit(name=name, image_size=size)
    run = RecipeStep(model, compute_dtype, batch_size=batch, crop_size=size)
    raw = frames(batch, frame)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):
        run(raw, gen)
    torch.cuda.synchronize()
    stages = stage_ms(run, raw, gen, compute_dtype)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "model": name,
                      "image_size": size, "dtype": args.dtype, "batch": batch,
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

    walls, groups, launches, prof = profile_steps(
        lambda: float(run(raw, gen)["loss"]), args.steps, args.trace)
    report(walls, groups, launches, prof, args.steps, batch, "step")


if __name__ == "__main__":
    main()
