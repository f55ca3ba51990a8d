"""Segmentation, optical flow and video on the card: the four dense and
video cells' f32 forward on the card against the CPU at batch 1
(``tools/dense.py``: DeepLabV3-ResNet-50 at 520x520, RAFT-large on 512x512
pairs with 12 updates, MViT-V2-S and Swin3D-T on 16x224x224 clips), and
one step of ``make_segmentation_train_step`` (DeepLabV3-ResNet-50, 240x240,
batch 8, dropout off) and of ``make_flow_train_step`` (RAFT-large, 256x320
pairs, batch 2, 12 updates) on the card against the CPU; the amp
segmentation step's loss against the f32 one. Marked ``cuda``; every test
skips where no CUDA device is present (decided inside the fixture). Run on
a GPU host with:

    python -m pytest tests/test_torch_dense_cuda.py -m cuda --noconftest

Tolerances (TF32 off, cuDNN's deterministic algorithms), those of
``chip_smoke.py``'s dense phases: the f32 output within 1e-4 of the
largest CPU value; a step's loss within 1e-4 relative and its gradients
within 1e-3 by relative Frobenius norm, the CPU's step taking each ReLU
to the side the card's took, and at most 1e-4 of the ReLU inputs on the
other side of 0 on the CPU (``tools/zoo.py:step_against_cpu``: a randomly
initialised ResNet-50 trained on batch statistics amplifies f32 rounding
until ~1e-5 of its ReLUs switch side, which moves its gradients by
~3e-2 on either device against f64); the amp loss within 5e-2 of the f32
one.
"""

import copy

import pytest
import torch

from vision_tpu_torch.tools import dense, zoo

pytestmark = pytest.mark.cuda

CELLS = list(dense.CELLS)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", CELLS)
def test_cell_forward_matches_cpu(dev, name):
    size, _ = dense.CELLS[name]
    model = dense.seeded_model(name, size, device=dev)
    cpu_model = copy.deepcopy(model).cpu()
    args = dense.inputs(name, 1, size, 5, dev)
    with torch.inference_mode():
        got = dense.serve(model, name, args)
        want = dense.serve(cpu_model, name, tuple(a.cpu() for a in args))
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 1e-4


def _check(make, step_of, batch_of):
    check = zoo.step_against_cpu(make, step_of, batch_of)
    assert check["loss_vs_cpu_rel_err"] <= 1e-4
    assert check["grads_vs_cpu_frobenius_rel_err"] <= 1e-3
    assert check["relu_switched_share"] <= 1e-4


def test_segmentation_step_matches_cpu(dev):
    """At 240x240, batch 8: at batch 2 ASPP's pooled map, normalised over
    the batch, is +-1 whatever its input, and its gradient is rounding."""
    _check(lambda: dense.seeded_model("deeplabv3_resnet50", 240, device=dev,
                                      aspp_dropout=0.0, head_dropout=0.0),
           dense.seg_step, lambda d: dense.seg_batch(8, 240, 1, d))


def test_flow_step_matches_cpu(dev):
    _check(lambda: dense.seeded_model("raft_large", (256, 320), device=dev),
           dense.flow_step, lambda d: dense.flow_batch(2, (256, 320), 1, d))


def test_amp_segmentation_step_is_near_f32(dev):
    size, _ = dense.SEG_TRAIN
    batch = dense.seg_batch(2, size, 2, dev)
    losses = []
    for dtype in (None, torch.bfloat16):
        model = dense.seeded_model("deeplabv3_resnet50", size, device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        losses.append(float(dense.seg_step(model, dtype)(batch, gen)["loss"]))
    assert abs(losses[1] - losses[0]) <= 5e-2 * abs(losses[0])
