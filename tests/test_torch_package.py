"""The port's package boundary: importing ``vision_tpu_torch`` pulls in
neither JAX nor ``vision_tpu``; entry points refuse to run without a card
unless asked for the CPU; CPU tensors take the plain PyTorch versions and
never count a kernel launch; the CUDA wrappers refuse CPU tensors."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vision_tpu_torch
from vision_tpu_torch.models import get_model
from vision_tpu_torch.models.detection import fasterrcnn_resnet50_fpn
from vision_tpu_torch.ops._conv1x1_bn import matmul_stats, matmul_stats_cuda
from vision_tpu_torch.ops.nms import (
    nms_keep_sorted,
    nms_keep_sorted_cuda,
    nms_keep_sorted_rowscan_cuda,
)
from vision_tpu_torch.ops.poolers import (
    window_pool,
    window_pool_backward_cuda,
    window_pool_cuda,
)
from vision_tpu_torch.ops.roi_align import (
    roi_align,
    roi_align_backward_cuda,
    roi_align_cuda,
)

PKG = Path(vision_tpu_torch.__file__).parent


def test_import_pulls_in_no_jax():
    code = (
        "import sys, vision_tpu_torch, vision_tpu_torch.models.detection, "
        "vision_tpu_torch._jax_convert, vision_tpu_torch.parallel, "
        "vision_tpu_torch.tools.profile_resnet_train, "
        "vision_tpu_torch.transforms.v2.functional, "
        "vision_tpu_torch.models.detection.transform, "
        "vision_tpu_torch.ops.boxes, vision_tpu_torch.ops.poolers, "
        "vision_tpu_torch.ops.roi_align, "
        "vision_tpu_torch.models.detection._utils, "
        "vision_tpu_torch.models.detection.rpn, "
        "vision_tpu_torch.models.detection.roi_heads, "
        "vision_tpu_torch.models.detection.backbone_utils, "
        "vision_tpu_torch.tools.profile_faster_rcnn\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'vision_tpu')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=PKG.parent)
    assert out.stdout.strip() == "[]"


def test_no_source_imports_jax_or_vision_tpu():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|vision_tpu)\b(?!_)", re.M
    )
    sources = list(PKG.rglob("*.py"))
    assert len(sources) > 10
    assert PKG / "transforms" / "v2" / "functional" / "_resample.py" in sources
    for src in sources:
        assert not pattern.search(src.read_text()), src


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fasterrcnn_resnet50_fpn()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("fasterrcnn_resnet50_fpn", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("resnet50", fused_bn=True)


def test_cpu_tensors_take_the_plain_path():
    wrappers = (nms_keep_sorted_cuda, roi_align_cuda, window_pool_cuda,
                nms_keep_sorted_rowscan_cuda, matmul_stats_cuda)
    counts = [w.launches for w in wrappers]
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 50, (1, 20, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + 10], -1).astype(np.float32))
    keep = nms_keep_sorted(boxes, torch.ones(1, 20, dtype=torch.bool), 0.5)
    assert keep.dtype == torch.bool and keep[0, 0]
    feat = torch.rand(1, 3, 8, 8)
    rois = torch.tensor([[0.0, 1.0, 1.0, 6.0, 6.0]])
    assert roi_align(feat, rois, 2, 1.0, 2).shape == (1, 3, 2, 2)
    out = window_pool(torch.rand(8, 8, 3), torch.tensor([0]), torch.tensor([0]),
                      torch.rand(1, 2, 4), torch.rand(1, 2, 4))
    assert out.shape == (1, 3, 2, 2)
    y, s1, s2 = matmul_stats(torch.rand(6, 4), torch.rand(4, 3))
    assert y.shape == (6, 3) and s1.shape == s2.shape == (3,)
    assert counts == [w.launches for w in wrappers]


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        nms_keep_sorted_cuda(torch.zeros(1, 2, 4), torch.ones(1, 2, dtype=torch.bool),
                             0.5)
    with pytest.raises(ValueError, match="CUDA"):
        nms_keep_sorted_rowscan_cuda(torch.zeros(1, 2, 4),
                                     torch.ones(1, 2, dtype=torch.bool), 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        matmul_stats_cuda(torch.zeros(4, 2), torch.zeros(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_cuda(torch.zeros(1, 1, 4, 4), torch.zeros(1, 5), 2)
    with pytest.raises(ValueError, match="CUDA"):
        window_pool_cuda(torch.zeros(4, 4, 1), torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), torch.zeros(1, 1, 2),
                         torch.zeros(1, 1, 2))


def test_bf16_cpu_tensors_take_the_plain_path():
    """The amp path's pooler calls on the CPU: the plain versions, in bf16,
    and no kernel launch."""
    counts = (roi_align_cuda.launches, window_pool_cuda.launches)
    feat = torch.rand(1, 3, 8, 8).bfloat16()
    rois = torch.tensor([[0.0, 1.0, 1.0, 6.0, 6.0]])
    out = roi_align(feat, rois, 2, 1.0, 2)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 3, 2, 2)
    out = window_pool(torch.rand(8, 8, 3).bfloat16(), torch.tensor([0]),
                      torch.tensor([0]), torch.rand(1, 2, 4), torch.rand(1, 2, 4))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 3, 2, 2)
    assert counts == (roi_align_cuda.launches, window_pool_cuda.launches)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_pooler_kernel_wrappers_refuse_other_types(dtype):
    """f32 and bf16 only: f16 and f64 are refused before the device is
    looked at, so no CUDA tensor is needed to see it."""
    with pytest.raises(ValueError, match="f32 or bf16"):
        roi_align_cuda(torch.zeros(1, 1, 4, 4, dtype=dtype), torch.zeros(1, 5), 2)
    with pytest.raises(ValueError, match="f32 or bf16"):
        window_pool_cuda(torch.zeros(4, 4, 1, dtype=dtype),
                         torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, 1, 2), torch.zeros(1, 1, 2))


def test_pooler_kernel_wrappers_refuse_non_f32_weights_and_boxes():
    with pytest.raises(ValueError, match="f32 or bf16"):
        roi_align_cuda(torch.zeros(1, 1, 4, 4), torch.zeros(1, 5).bfloat16(), 2)
    with pytest.raises(ValueError, match="f32 or bf16"):
        window_pool_cuda(torch.zeros(4, 4, 1).bfloat16(),
                         torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, 1, 2).bfloat16(), torch.zeros(1, 1, 2))


def test_cpu_backward_takes_the_plain_path():
    """The backward passes of the window pool and RoIAlign on CPU tensors:
    the plain versions, and no kernel launch."""
    wrappers = (window_pool_backward_cuda, roi_align_backward_cuda,
                window_pool_cuda, roi_align_cuda)
    counts = [w.launches for w in wrappers]
    st = torch.rand(8, 8, 3, requires_grad=True)
    window_pool(st, torch.tensor([0]), torch.tensor([1]), torch.rand(1, 2, 4),
                torch.rand(1, 2, 4)).sum().backward()
    feat = torch.rand(1, 3, 8, 8, requires_grad=True)
    roi_align(feat, torch.tensor([[0.0, 1.0, 1.0, 6.0, 6.0]]), 2, 1.0,
              2).sum().backward()
    assert st.grad.shape == st.shape and feat.grad.shape == feat.shape
    assert st.grad.abs().sum() > 0 and feat.grad.abs().sum() > 0
    assert counts == [w.launches for w in wrappers]


def test_backward_cuda_wrappers_refuse_what_they_do_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        window_pool_backward_cuda(
            torch.zeros(1, 1, 1, 2), torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), torch.zeros(1, 1, 2),
            torch.zeros(1, 2, 2), (4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_backward_cuda(torch.zeros(1, 1, 2, 2), torch.zeros(1, 5),
                                (1, 1, 4, 4), 2)
    with pytest.raises(ValueError, match="f32"):
        window_pool_backward_cuda(
            torch.zeros(1, 1, 1, 2).bfloat16(), torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), torch.zeros(1, 1, 2),
            torch.zeros(1, 2, 2), (4, 4))
    with pytest.raises(ValueError, match="f32"):
        roi_align_backward_cuda(torch.zeros(1, 1, 2, 2, dtype=torch.float64),
                                torch.zeros(1, 5), (1, 1, 4, 4), 2)
