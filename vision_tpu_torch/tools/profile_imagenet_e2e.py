"""Where the time of the ImageNet eval pipelines from encoded JPEGs goes.

    python -m vision_tpu_torch.tools.profile_imagenet_e2e
        [--pipeline host | device | device_input | resnet18 | all]
        [--batch 64] [--batches 4] [--threads N] [--trace DIR]

The pipelines of ``chip_smoke.py``'s ``resnet50_e2e_images`` (``host``),
``resnet50_e2e_device_decode`` (``device``), ``resnet50_e2e_device_input``
and ``resnet18_e2e_images`` (``tools/imagenet_e2e.py``; seeded weights,
TF32 off, the JPEGs of ``make_jpegs``). Prints JSON lines:

* ``host_decode``: ms an image of the whole host decode and of the
  Huffman pass alone, on one thread and, through the batch decoders of
  ``io.jpeg_device``, on ``--threads`` (default ``decode_threads()``: every
  core the process may use but one);
* per pipeline, ``feed``: the rate at which the host side alone (decode
  threads -> ``prefetch_to_device``, no model) lands batches on the card;
  and ``profile``: ``--batches`` batches after a warm-up under
  ``torch.profiler``, the wall ms a batch, the device ms a batch by range
  (``decode``: dequantise, IDCT, upsampling and colour; ``preprocess``:
  resize, crop, normalise; ``forward``) and by kernel group (convolution,
  elementwise, ...), the busy share (device kernel time over wall time)
  and the launches a batch. The Chrome trace of each goes to ``--trace``.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from vision_tpu_torch.io import prefetch_to_device
from vision_tpu_torch.io.jpeg_device import decode_threads
from vision_tpu_torch.models import ResNet18_Weights, get_model
from vision_tpu_torch.models._api import resolve_device
from vision_tpu_torch.tools import imagenet_e2e as e2e
from vision_tpu_torch.tools.profile_faster_rcnn import _device_us

_PIPELINES = ("host", "device", "device_input", "resnet18")
_RANGES = ("decode", "preprocess", "forward")

# kernel-name fragments -> group, first match wins
_GROUPS = (
    ("fprop", "convolution"),
    ("conv", "convolution"),
    ("cudnn", "convolution"),
    ("nchwToNhwc", "layout copy"),
    ("nhwcToNchw", "layout copy"),
    ("gemm", "matmul"),
    ("cutlass", "matmul"),
    ("max_pool", "pooling"),
    ("avg_pool", "pooling"),
    ("cat", "copy"),
    ("copy", "copy"),
    ("elementwise", "elementwise"),
    ("reduce", "reduction"),
)


def _group(name: str) -> str:
    for frag, group in _GROUPS:
        if frag in name:
            return group
    return "other"


def host_decode(jpegs, threads, batch, batches=4):
    """ms an image on one thread and, through the library's batch decoders
    (``e2e.host_decode_batches`` and ``e2e.coef_batches``), on
    ``threads``, whole and Huffman."""
    full1, huff1 = e2e.host_decode_ms(jpegs[:16], 64)
    out = {"threads": threads, "full_ms_1_thread": full1,
           "huffman_ms_1_thread": huff1}
    with ThreadPoolExecutor(threads) as pool:
        for name, make in (("full", e2e.host_decode_batches),
                           ("huffman", e2e.coef_batches)):
            for _ in make(jpegs, batch, 1, pool):
                pass
            t0 = time.perf_counter()
            for _ in make(jpegs, batch, batches, pool):
                pass
            out[f"{name}_ms_{threads}_threads"] = (
                (time.perf_counter() - t0) / (batch * batches) * 1e3)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pipeline", choices=_PIPELINES + ("all",), default="all")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--threads", type=int, default=decode_threads())
    ap.add_argument("--trace", default="build/profile")
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(None)  # the card; raises without one
    pin = device.type == "cuda"
    jpegs = e2e.make_jpegs()
    print(json.dumps({"device": torch.cuda.get_device_name(device),
                      "host_decode": host_decode(jpegs, args.threads,
                                                 args.batch)}),
          flush=True)
    pipelines = _PIPELINES if args.pipeline == "all" else (args.pipeline,)
    with torch.inference_mode(), ThreadPoolExecutor(args.threads) as pool:
        model50 = get_model("resnet50", seed=0).to(torch.bfloat16)
        frames = next(e2e.host_decode_batches(jpegs, args.batch, 1, pool)).to(device)
        for name in pipelines:
            if name == "resnet18":
                model = get_model("resnet18", seed=0)
                preset = ResNet18_Weights.DEFAULT.transforms()

                def step(raw, model=model, preset=preset):
                    with record_function("preprocess"):
                        x = preset(raw.permute(0, 3, 1, 2))
                    with record_function("forward"):
                        return model(x)
            elif name == "device":
                def step(coefs):
                    with record_function("decode"):
                        img = e2e.decode_on_device(coefs)
                    with record_function("preprocess"):
                        x = e2e.preprocess(img, nhwc=False)
                    with record_function("forward"):
                        return model50(x)
            else:
                def step(raw):
                    with record_function("preprocess"):
                        x = e2e.preprocess(raw)
                    with record_function("forward"):
                        return model50(x)

            def batches(count, name=name):
                if name == "device_input":
                    return iter([frames] * count)
                if name == "device":
                    return prefetch_to_device(e2e.coef_batches(
                        jpegs, args.batch, count, pool, pin=pin), device=device,
                        donate_pinned=True)
                return prefetch_to_device(e2e.host_decode_batches(
                    jpegs, args.batch, count, pool, pin=pin), device=device,
                    donate_pinned=True)

            feed = None
            if name != "device_input":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in batches(args.batches):
                    pass
                torch.cuda.synchronize()
                feed = args.batch * args.batches / (time.perf_counter() - t0)
            for x in batches(1):
                step(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for x in batches(args.batches):
                    step(x)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / args.batches
            # the ranges' own spans are listed as device events too
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.key not in _RANGES]
            groups = defaultdict(float)
            for e in kernels:
                groups[_group(e.key)] += _device_us(e) / 1e3 / args.batches
            ranges = {r: sum(e.device_time_total for e in prof.events()
                             if e.name == r and e.device_type
                             == torch.autograd.DeviceType.CPU) / 1e3 / args.batches
                      for r in _RANGES}
            device_ms = sum(groups.values())
            print(json.dumps({"pipeline": name, "batch": args.batch,
                              "feed_images_per_s": feed, "profile": {
                                  "wall_ms_per_batch": wall,
                                  "images_per_s": args.batch / wall * 1e3,
                                  "device_ms_per_batch": device_ms,
                                  "busy_share": device_ms / wall,
                                  "launches_per_batch": sum(
                                      e.count for e in kernels) / args.batches,
                                  "device_ms_by_range": ranges,
                                  "device_ms_by_group": dict(sorted(
                                      groups.items(), key=lambda kv: -kv[1]))}}),
                  flush=True)
            trace = Path(args.trace) / f"imagenet_e2e_{name}.json"
            trace.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace))


if __name__ == "__main__":
    main()
