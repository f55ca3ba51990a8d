"""How far the f32 gradient of a freshly initialised ResNet-50 is from a
float64 gradient, on the card, for each way the port can run the train
step's forward and backward.

    python -m vision_tpu_torch.tools.grad_noise_resnet [--batch 32]

Same model and batch as ``chip_smoke.py``'s train phases (seed 0, a seeded
normal batch of 224x224 images with seeded labels, TF32 off). Prints one
JSON line per path (``fused_bn=True`` through the ``matmul_stats`` kernel,
the same through its plain version, ``fused_bn=False``): the relative L2
error of the whole gradient, of ``conv1.weight`` and of ``fc.weight``
against the float64 gradient of the standard path. The error is the noise
floor under which two f32 paths cannot be told apart after an SGD step: it
is why ``chip_smoke.py`` holds the later steps' losses of the kernel path
and the plain path together only loosely.

The float64 reference runs the batch norm's statistics in float64 too, by
replacing ``Tensor.float`` while it runs; nothing else in the package does
that.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math

import torch

from vision_tpu_torch.models import get_model
from vision_tpu_torch.ops import _conv1x1_bn
from vision_tpu_torch.parallel import cross_entropy_loss


@contextlib.contextmanager
def _plain_matmul_stats():
    kernel = _conv1x1_bn.matmul_stats_cuda
    _conv1x1_bn.matmul_stats_cuda = _conv1x1_bn.matmul_stats_plain
    try:
        yield
    finally:
        _conv1x1_bn.matmul_stats_cuda = kernel


@contextlib.contextmanager
def _float_is_double():
    original = torch.Tensor.float
    torch.Tensor.float = lambda self: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = original


def _gradient(images, labels, fused: bool, double: bool = False):
    model = get_model("resnet50", fused_bn=fused, seed=0).train()
    if double:
        model, images = model.double(), images.double()
    cross_entropy_loss(model(images), labels).backward()
    return {n: p.grad.double() for n, p in model.named_parameters()}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    gen = torch.Generator().manual_seed(2)
    images = torch.randn(args.batch, 3, 224, 224, generator=gen).cuda()
    labels = torch.randint(0, 1000, (args.batch,), generator=gen).cuda()

    with _float_is_double():
        ref = _gradient(images, labels, fused=False, double=True)
    ref_norm = math.sqrt(sum(float(g.norm()) ** 2 for g in ref.values()))
    paths = (
        ("fused_bn, matmul_stats kernel", True, contextlib.nullcontext()),
        ("fused_bn, plain matmul_stats", True, _plain_matmul_stats()),
        ("standard (fused_bn=False)", False, contextlib.nullcontext()),
    )
    for name, fused, ctx in paths:
        with ctx:
            grad = _gradient(images, labels, fused)
        err = math.sqrt(sum(float((grad[n] - ref[n]).norm()) ** 2 for n in ref))
        print(json.dumps({
            "device": torch.cuda.get_device_name(0), "batch": args.batch,
            "path": name, "dtype": "float32",
            "gradient_rel_err_vs_float64": err / ref_norm,
            "conv1_weight_rel_err": _rel(grad["conv1.weight"], ref["conv1.weight"]),
            "fc_weight_rel_err": _rel(grad["fc.weight"], ref["fc.weight"]),
        }))


if __name__ == "__main__":
    main()
