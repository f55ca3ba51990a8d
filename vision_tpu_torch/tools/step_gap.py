"""How far DeepLabV3-ResNet-50's f32 train step lies from its f64 one on
the CPU, and why.

    python -m vision_tpu_torch.tools.step_gap [--size 128] [--batch 2 8]
        [--detach-pool]

For each batch, one JSON line: step 1 (``tools/dense.py:seg_step``,
dropout off, seeded ``seg_batch``, full width) in f32 and in f64 from the
same weights: the loss's relative distance, all gradients' by relative
Frobenius norm, the same with the f64 step taking each ReLU to the side
the f32 step took (``tools/zoo.py:step_against_cpu``'s replay), the ReLU
inputs whose side differs, and, by module down the trunk, the f32 output's
and its gradient's relative distance from f64 (Frobenius).
``--detach-pool`` stops the gradient at the input of ASPP's pooling
branch (its 1x1 convolution on the mean over the map), in every step.
"""

from __future__ import annotations

import argparse
import copy
import json

import torch

from vision_tpu_torch.tools import dense
from vision_tpu_torch.tools.zoo import relu_sides

# where the error is read, from the stem to the head
TRACE = ("backbone.conv1", "backbone.layer1", "backbone.layer2",
         "backbone.layer3", "backbone.layer4", "classifier.0",
         "classifier.1", "classifier")


def _step(model, batch, sides, switched):
    """Gradients and the traced modules' (output, output gradient)."""
    acts = {}

    def keep(name):
        def hook(module, inputs, output):
            output.retain_grad()
            acts[name] = output
        return hook

    handles = [model.get_submodule(n).register_forward_hook(keep(n))
               for n in TRACE]
    try:
        with relu_sides(sides, switched):
            loss = float(dense.seg_step(model)(batch)["loss"])
    finally:
        for h in handles:
            h.remove()
    grads = torch.cat([p.grad.double().ravel() for p in model.parameters()
                       if p.grad is not None])
    return loss, grads, {n: (a.detach().double(), a.grad.double())
                         for n, a in acts.items()}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


# the pooling branch's convolution (DeepLabV3's ASPP)
POOL_CONV = "classifier.0.convs.4.1"


def gap(size: int, batch: int, detach_pool: bool = False) -> dict:
    model = dense.seeded_model("deeplabv3_resnet50", size, device="cpu",
                               aspp_dropout=0.0, head_dropout=0.0)
    if detach_pool:
        model.get_submodule(POOL_CONV).register_forward_pre_hook(
            lambda module, inputs: (inputs[0].detach(),))
    b32 = dense.seg_batch(batch, size, 1, "cpu")
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in b32.items()}
    sides, switched = [], [0]
    loss32, g32, t32 = _step(copy.deepcopy(model), b32, sides, None)
    loss64, g64, t64 = _step(copy.deepcopy(model).double(), b64, [], None)
    _, g64r, _ = _step(copy.deepcopy(model).double(), b64, sides, switched)
    return {"size": size, "batch": batch,
            "detach_pool": detach_pool,
            "loss_rel_err": abs(loss32 - loss64) / abs(loss64),
            "grads_frobenius_rel_err": _rel(g32, g64),
            "grads_on_f32_relu_sides_frobenius_rel_err": _rel(g32, g64r),
            "relu_switched": switched[0],
            "relu_outputs": sum(s.numel() for s in sides),
            "by_module": {n: {"output": _rel(t32[n][0], t64[n][0]),
                              "grad": _rel(t32[n][1], t64[n][1])}
                          for n in TRACE}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--batch", type=int, nargs="+", default=[2, 8])
    ap.add_argument("--detach-pool", action="store_true")
    args = ap.parse_args()
    for batch in args.batch:
        print(json.dumps(gap(args.size, batch, args.detach_pool)),
              flush=True)


if __name__ == "__main__":
    main()
