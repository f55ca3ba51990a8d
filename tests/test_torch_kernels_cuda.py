"""Each CUDA kernel of ``vision_tpu_torch`` against its plain PyTorch
version, on the card, at small shapes. Marked ``cuda``; every test skips
where no CUDA device is present (the decision is made inside the fixture,
never at import). Run on a GPU host with:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerances: NMS keep masks exactly equal (both kernels); RoIAlign 1e-5
absolute (at the pyramid shapes 1e-5 of the largest plain value) and the
window pool 1e-4 absolute (and 1e-5 relative) on inputs of order 1 (sums in another order);
``matmul_stats`` in f32 within 1e-4 of the largest value of ``y`` and of
each sum, in bf16 ``y`` within one bf16 step of the largest (a step is
2**-8 to 2**-7 of the value it rounds) and the sums within 2e-3 (a flipped
rounding of one ``y`` moves a sum by a bf16 step of that value); at the
ResNet-50 cases, where thousands of rows average such flips out, the sums
within 1e-4 in both types. The bf16 variants of the window pool and of
RoIAlign against their plain bf16 versions: within one bf16 step of each
element (2**-7 of its magnitude: the f32 sums, taken in another order, can
round to the neighbouring bf16 value) plus the f32 tolerance of the same
kernel, absolute. Where the divisor (the sample count) is not a power of
two, within two steps (2**-6): both round the sum to bf16 before they
divide, so a sum rounded the other way moves the quotient by a step before
its own rounding.

The backward kernels of the window pool and of RoIAlign against their
plain versions: in f32 within 1e-5 of the largest plain value (sums in
another order); in bf16 (a bf16 output gradient, f32 sums, the gradient
rounded once) within one bf16 step of the plain version's f32 sum rounded
to bf16, plus 1e-5 of the largest value; in both, bit-identical across
calls on the same inputs.

The deformable convolution's column kernel against its plain version: the
same bits in f32 and in bf16 (a bf16 input is widened exactly, and the
kernel, built with -fmad=false, rounds each product and sum as the plain
version does). Its backward kernels: the same bits on a second call; the
input's gradient in f32 within 1e-5 of the largest plain value, in bf16
within one bf16 step of the plain f32 sum rounded to bf16 plus 1e-5 of the
largest value; the offsets' and the mask's gradients (f32 sums over the
channels in another order) within 1e-5 of their largest plain value.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vision_tpu_torch.ops._conv1x1_bn import (
    choose_kernel,
    matmul_stats,
    matmul_stats_cuda,
    matmul_stats_fma_cuda,
    matmul_stats_general_cuda,
    matmul_stats_plain,
    matmul_stats_wgmma_cuda,
)
from vision_tpu_torch.ops.nms import (
    nms_keep_sorted_cuda,
    nms_keep_sorted_plain,
    nms_keep_sorted_rowscan_cuda,
    nms_mask,
)
from vision_tpu_torch.ops.poolers import (
    MultiScaleRoIAlign,
    window_pool_backward_cuda,
    window_pool_backward_plain,
    window_pool_cuda,
    window_pool_plain,
)
from vision_tpu_torch.models.detection import GeneralizedRCNNTransform
from vision_tpu_torch.ops.deform_conv import (
    deform_conv2d,
    deform_conv_backward_cuda,
    deform_conv_backward_plain,
    deform_im2col_cuda,
    deform_im2col_plain,
)
from vision_tpu_torch.ops.roi_align import (
    roi_align_backward_cuda,
    roi_align_backward_plain,
    roi_align_cuda,
    roi_align_plain,
)
from vision_tpu_torch.transforms import ImageClassification

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires a CUDA device")
    return torch.device("cuda")


def _sorted_boxes(rng, b, n):
    xy = rng.uniform(0, 200, (b, n, 2))
    wh = rng.uniform(2, 60, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, :2, 2:] = boxes[:, :2, :2]  # degenerate rows
    valid = rng.rand(b, n) > 0.2
    boxes[~valid] = 0.0
    return torch.from_numpy(boxes), torch.from_numpy(valid)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 300, 1000])
@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_nms_kernel_equals_plain(dev, n, thr):
    boxes, valid = _sorted_boxes(np.random.RandomState(n), 3, n)
    want = nms_keep_sorted_plain(boxes, valid, thr)
    before = nms_keep_sorted_cuda.launches
    got = nms_keep_sorted_cuda(boxes.to(dev), valid.to(dev), thr)
    torch.cuda.synchronize()
    assert nms_keep_sorted_cuda.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("thr", [-0.25, 0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 1025, 11068, 20000])
def test_nms_kernel_equals_plain_up_to_20000(dev, b, n, thr):
    """The bitmask kernel's scan over rows of up to 313 words, where its
    helpers OR kept rows into words far ahead of the chain. The plain
    version builds an N x N matrix, so it runs row by row."""
    boxes, valid = _sorted_boxes(np.random.RandomState(2 * n + b), b, n)
    boxes, valid = boxes.to(dev), valid.to(dev)
    before = nms_keep_sorted_cuda.launches
    got = nms_keep_sorted_cuda(boxes, valid, thr)
    torch.cuda.synchronize()
    assert nms_keep_sorted_cuda.launches == before + 1
    assert got.dtype == torch.bool and not got[~valid].any()
    want = torch.cat([nms_keep_sorted_plain(boxes[i:i + 1], valid[i:i + 1], thr)
                      for i in range(b)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [33, 1000, 14257])
def test_nms_kernel_all_or_nothing(dev, n):
    _check_all_or_nothing(nms_keep_sorted_cuda, dev, n)


def test_nms_kernel_takes_unaligned_boxes(dev):
    _check_unaligned_boxes(nms_keep_sorted_cuda, dev)


def test_nms_mask_on_card_equals_cpu(dev):
    rng = np.random.RandomState(1)
    boxes, _ = _sorted_boxes(rng, 1, 500)
    scores = torch.from_numpy(rng.rand(500).astype(np.float32))
    valid = torch.from_numpy(rng.rand(500) > 0.1)
    want = nms_mask(boxes[0], scores, 0.5, valid=valid)
    got = nms_mask(boxes[0].to(dev), scores.to(dev), 0.5, valid=valid.to(dev))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("sr", [2, 0])
def test_roi_align_kernel_matches_plain(dev, aligned, sr):
    rng = np.random.RandomState(2)
    feat = torch.from_numpy(rng.rand(2, 16, 40, 50).astype(np.float32))
    xy = rng.uniform(-10, 180, (64, 2))
    wh = rng.uniform(1, 120, (64, 2))
    b = rng.randint(0, 2, (64, 1))
    rois = torch.from_numpy(np.concatenate([b, xy, xy + wh], 1).astype(np.float32))
    want = roi_align_plain(feat, rois, 7, 0.25, sr, aligned)
    got = roi_align_cuda(feat.to(dev), rois.to(dev), 7, 0.25, sr, aligned)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


def _pyramid_case(rng, size, k, c=256):
    """One level of the 832x832 forward's pyramid (``size`` = 208, 104,
    52 or 26) and ``k`` RoIs of 8 to 400 px in image coordinates, some
    reaching past the image's edges."""
    feat = torch.from_numpy(rng.randn(1, c, size, size).astype(np.float32))
    xy = rng.uniform(-20, 832, (k, 2))
    wh = rng.uniform(8, 400, (k, 2))
    rois = np.concatenate([np.zeros((k, 1)), xy, xy + wh], 1)
    return feat, torch.from_numpy(rois.astype(np.float32))


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("sr", [2, 0])
@pytest.mark.parametrize("k", [64, 1000])
@pytest.mark.parametrize("size", [208, 104, 52, 26])
def test_roi_align_kernel_at_pyramid_shapes(dev, size, k, sr, aligned):
    """The four levels of the Faster R-CNN forward (C = 256, scale
    size / 832), within 1e-5 of the largest plain value. The plain version
    runs on the CPU: on the card, its own result strays further than that
    on these signed inputs (4.3e-5 at a largest value of 2.1 at P2, where
    the kernel is within 3e-7 of the CPU's). It runs 100 RoIs at a time:
    at the adaptive grid it holds every RoI's largest grid at once."""
    feat, rois = _pyramid_case(np.random.RandomState(size + k + sr), size, k)
    scale = size / 832
    before = roi_align_cuda.launches
    got = roi_align_cuda(feat.to(dev), rois.to(dev), 7, scale, sr, aligned).cpu()
    assert roi_align_cuda.launches == before + 1
    want = torch.cat([roi_align_plain(feat, rois[i:i + 100], 7, scale, sr, aligned)
                      for i in range(0, k, 100)])
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


def _window_case(rng, k, c, ph, winy, winx, r_rows=200, wmax=64):
    """Windows at random origins, the first four touching the last row
    and the last column of ``stacked``; weights that are zero outside a
    range with a gap inside it, all zero for one RoI, and non-zero over
    every column for some (more than one group of 16 columns)."""
    stacked = torch.from_numpy(rng.randn(r_rows, wmax, c).astype(np.float32))
    row0 = rng.randint(0, r_rows - winy + 1, k)
    x0 = rng.randint(0, wmax - winx + 1, k)
    row0[:2], x0[1:4] = r_rows - winy, wmax - winx
    w_y = rng.rand(k, ph, winy).astype(np.float32)
    w_x = rng.rand(k, ph, winx).astype(np.float32)
    w_y[:, :, : winy // 8] = 0.0  # rows before the range
    w_y[:, :, winy // 2: winy // 2 + 3] = 0.0  # a gap inside it
    w_y[4:, :, winy - winy // 4:] = 0.0  # rows after it, but not where
    w_x[k // 2:, :, winx // 2 + 1:] = 0.0  # windows touch the last row
    w_x[5, :, :] = 0.0  # nothing to read
    return (stacked, torch.from_numpy(row0.astype(np.int32)),
            torch.from_numpy(x0.astype(np.int32)), torch.from_numpy(w_y),
            torch.from_numpy(w_x))


@pytest.mark.parametrize("winy,winx", [(32, 32), (20, 40)])
@pytest.mark.parametrize("ph", [7, 14])
@pytest.mark.parametrize("c", [1, 33, 64, 256])
def test_window_pool_kernel_matches_plain(dev, c, ph, winy, winx):
    rng = np.random.RandomState(3 + c + ph + winx)
    args = _window_case(rng, 50, c, ph, winy, winx)
    want = window_pool_plain(*args, 4.0)
    before = window_pool_cuda.launches
    got = window_pool_cuda(*(t.to(dev) for t in args), 4.0)
    torch.cuda.synchronize()
    assert window_pool_cuda.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-5)
    assert not got[5].any()


def _run_trapping(script):
    """Run ``script`` in a process of its own: it must return from the call,
    then fail at the synchronisation with a CUDA error."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "returned" in proc.stdout and "synchronised" not in proc.stdout
    assert "CUDA error" in proc.stderr, proc.stderr[-2000:]


def test_window_pool_kernel_fails_on_a_window_outside_the_pyramid(dev):
    """The bounds check runs on the card: the call returns, and the launch
    fails at the next synchronisation. The CUDA context does not survive
    that, so it runs in a process of its own."""
    _run_trapping("""if True:
        import numpy as np, torch
        from vision_tpu_torch.ops.poolers import window_pool_cuda
        st = torch.zeros(20, 10, 4, device="cuda")
        w = torch.ones(1, 2, 8, device="cuda")
        row0 = torch.tensor([13], device="cuda")
        window_pool_cuda(st, row0, torch.tensor([0], device="cuda"), w, w)
        print("returned", flush=True)
        torch.cuda.synchronize()
        print("synchronised", flush=True)
    """)


def _bf16_step_close(got, want, atol, steps=1):
    """Each element within ``steps`` bf16 steps of its magnitude (a step is
    at most 2**-7 of it) plus ``atol``."""
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               rtol=steps * 2.0 ** -7, atol=atol)


@pytest.mark.parametrize("winy,winx", [(32, 32), (20, 40)])
@pytest.mark.parametrize("ph", [7, 14])
@pytest.mark.parametrize("c", [1, 33, 64, 256])
def test_window_pool_bf16_kernel_matches_plain(dev, c, ph, winy, winx):
    """The bf16 pyramid: one 8-byte copy a thread where C % 4 == 0, loads
    and stores element by element for C = 1 and 33; the edge windows of
    ``_window_case``; sr 2 (div 4) and sr 3 (div 9, where the bf16 sum's
    rounding shows)."""
    rng = np.random.RandomState(30 + c + ph + winx)
    args = list(_window_case(rng, 50, c, ph, winy, winx))
    args[0] = args[0].bfloat16()
    before = window_pool_cuda.launches
    for div in (4.0, 9.0):
        want = window_pool_plain(*args, div)
        got = window_pool_cuda(*(t.to(dev) for t in args), div)
        torch.cuda.synchronize()
        _bf16_step_close(got, want, 1e-4, steps=1 if div == 4.0 else 2)
        assert not got[5].any()
    assert window_pool_cuda.launches == before + 2


def test_window_pool_bf16_kernel_fails_on_a_window_outside_the_pyramid(dev):
    _run_trapping("""if True:
        import torch
        from vision_tpu_torch.ops.poolers import window_pool_cuda
        st = torch.zeros(20, 10, 4, device="cuda", dtype=torch.bfloat16)
        w = torch.ones(1, 2, 8, device="cuda")
        row0 = torch.tensor([13], device="cuda")
        window_pool_cuda(st, row0, torch.tensor([0], device="cuda"), w, w)
        print("returned", flush=True)
        torch.cuda.synchronize()
        print("synchronised", flush=True)
    """)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch_index", ["2.0", "-1.0", "float('nan')"])
def test_roi_align_kernel_fails_on_a_batch_index_outside_the_input(
        dev, batch_index, dtype):
    """An input of N = 2 images and one RoI whose batch index is N, -1 or
    NaN: the kernel checks it on the card and stops the launch, which fails
    at the next synchronisation (in a process of its own: the CUDA context
    does not survive it). Indices in (-1, N) truncate into range and pass."""
    _run_trapping(f"""if True:
        import torch
        from vision_tpu_torch.ops.roi_align import roi_align_cuda
        feat = torch.ones(2, 3, 8, 8, device="cuda", dtype=torch.{dtype})
        ok = torch.tensor([[-0.5, 0, 0, 4, 4], [1.9, 0, 0, 4, 4]],
                          device="cuda")
        out = roi_align_cuda(feat, ok, 2, 1.0, 2)
        torch.cuda.synchronize()
        assert bool((out == 1).all()), out
        rois = torch.tensor([[{batch_index}, 0, 0, 4, 4]], device="cuda")
        roi_align_cuda(feat, rois, 2, 1.0, 2)
        print("returned", flush=True)
        torch.cuda.synchronize()
        print("synchronised", flush=True)
    """)


@pytest.mark.parametrize("sr", [2, 0])
@pytest.mark.parametrize("k", [64, 1000])
@pytest.mark.parametrize("size", [208, 104, 52, 26])
def test_roi_align_bf16_kernel_at_pyramid_shapes(dev, size, k, sr):
    """The bf16 input at the four levels of the Faster R-CNN forward (C =
    256), at sampling_ratio 2 and at the adaptive grid (sample counts that
    are not powers of two: two steps), against the plain bf16 version on the
    CPU, 100 RoIs at a time."""
    feat, rois = _pyramid_case(np.random.RandomState(size + k + sr + 1), size, k)
    feat = feat.bfloat16()
    scale = size / 832
    before = roi_align_cuda.launches
    got = roi_align_cuda(feat.to(dev), rois.to(dev), 7, scale, sr, False)
    assert roi_align_cuda.launches == before + 1
    assert got.dtype == torch.bfloat16
    want = torch.cat([roi_align_plain(feat, rois[i:i + 100], 7, scale, sr)
                      for i in range(0, k, 100)])
    _bf16_step_close(got, want, 1e-5 * float(want.float().abs().max()),
                     steps=1 if sr == 2 else 2)


def test_kernels_make_no_host_synchronisation(dev):
    """Under the sync debug mode "error", any PyTorch operation that waits
    for the card raises; no wrapper does, in f32 or in bf16 (the deformable
    convolution's backward with its sort and search included)."""
    rng = np.random.RandomState(5)
    args = [t.to(dev) for t in _window_case(rng, 20, 64, 7, 32, 32)]
    args16 = [args[0].bfloat16(), *args[1:]]
    boxes, valid = (t.to(dev) for t in _sorted_boxes(rng, 2, 300))
    feat, rois = (t.to(dev) for t in _pyramid_case(rng, 52, 64, 16))
    feat16 = feat.bfloat16()
    gw = torch.randn(20, 64, 7, 7, device=dev)
    gr = torch.randn(64, 16, 7, 7, device=dev)
    dc = [t.to(dev) for t in _deform_case(rng, 2, 8, 9, 11, 1, 2, 1, 1, True)]
    dc16 = [dc[0].bfloat16(), *dc[1:]]
    gc = torch.randn(2, 9, 11, 9, 8, device=dev)
    deform_im2col_cuda(*dc, 3, 1, 1, 1)
    deform_conv_backward_cuda(*dc, gc, 3, 1, 1, 1)
    window_pool_cuda(*args)  # builds the kernels outside the checked region
    window_pool_cuda(*args16)
    nms_keep_sorted_rowscan_cuda(boxes, valid, 0.5)
    nms_keep_sorted_cuda(boxes, valid, 0.5)
    roi_align_cuda(feat, rois, 7, 1 / 16, 2, False)
    roi_align_cuda(feat16, rois, 7, 1 / 16, 2, False)
    window_pool_backward_cuda(gw, *args[1:], tuple(args[0].shape[:2]))
    roi_align_backward_cuda(gr, rois, tuple(feat.shape), 7, 1 / 16, 2, False)
    window_pool_backward_cuda(gw.bfloat16(), *args[1:], tuple(args[0].shape[:2]))
    roi_align_backward_cuda(gr.bfloat16(), rois, tuple(feat.shape), 7, 1 / 16,
                            2, False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        window_pool_cuda(*args)
        window_pool_cuda(*args16)
        nms_keep_sorted_rowscan_cuda(boxes, valid, 0.5)
        nms_keep_sorted_cuda(boxes, valid, 0.5)
        roi_align_cuda(feat, rois, 7, 1 / 16, 2, False)
        roi_align_cuda(feat16, rois, 7, 1 / 16, 2, False)
        window_pool_backward_cuda(gw, *args[1:], tuple(args[0].shape[:2]))
        roi_align_backward_cuda(gr, rois, tuple(feat.shape), 7, 1 / 16, 2,
                                False)
        window_pool_backward_cuda(gw.bfloat16(), *args[1:],
                                  tuple(args[0].shape[:2]))
        roi_align_backward_cuda(gr.bfloat16(), rois, tuple(feat.shape), 7,
                                1 / 16, 2, False)
        deform_im2col_cuda(*dc, 3, 1, 1, 1)
        deform_im2col_cuda(*dc16, 3, 1, 1, 1)
        deform_conv_backward_cuda(*dc, gc, 3, 1, 1, 1)
        deform_conv_backward_cuda(*dc16, gc, 3, 1, 1, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_multiscale_pooler_on_card_matches_cpu(dev):
    rng = np.random.RandomState(4)
    names = ["0", "1", "2", "3"]
    feats = {n: torch.from_numpy(rng.rand(1, 32, 64 >> i, 64 >> i)
                                 .astype(np.float32))
             for i, n in enumerate(names)}
    xy = rng.uniform(0, 200, (100, 2))
    wh = rng.uniform(4, 150, (100, 2))
    rois = torch.from_numpy(np.concatenate(
        [np.zeros((100, 1)), xy, xy + wh], 1).astype(np.float32))
    pooler = MultiScaleRoIAlign(names, 7, 2, window=8)
    want = pooler(feats, rois, (256, 256))
    got = pooler({k: v.to(dev) for k, v in feats.items()}, rois.to(dev),
                 (256, 256))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sr", [2, 3])
def test_multiscale_pooler_bf16_on_card_matches_cpu(dev, sr):
    """The amp path's pooler: bf16 features through the bf16 window-pool
    and RoIAlign kernels (the dense recompute), against the CPU."""
    rng = np.random.RandomState(40 + sr)
    names = ["0", "1", "2", "3"]
    feats = {n: torch.from_numpy(rng.rand(1, 32, 64 >> i, 64 >> i)
                                 .astype(np.float32)).bfloat16()
             for i, n in enumerate(names)}
    xy = rng.uniform(0, 200, (100, 2))
    wh = rng.uniform(4, 150, (100, 2))
    rois = torch.from_numpy(np.concatenate(
        [np.zeros((100, 1)), xy, xy + wh], 1).astype(np.float32))
    pooler = MultiScaleRoIAlign(names, 7, sr, window=8)
    want = pooler(feats, rois, (256, 256))
    counts = (window_pool_cuda.launches, roi_align_cuda.launches)
    got = pooler({k: v.to(dev) for k, v in feats.items()}, rois.to(dev),
                 (256, 256))
    assert window_pool_cuda.launches == counts[0] + 1
    assert roi_align_cuda.launches == counts[1] + 4
    _bf16_step_close(got, want, 1e-5, steps=1 if sr == 2 else 2)


@pytest.mark.parametrize("thr", [0.0, 0.5, 0.9])
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 1000, 1024, 1025, 11068,
                               11069, 14256, 14257, 20000])
def test_nms_rowscan_kernel_equals_plain(dev, b, n, thr):
    """Rows above 14,256 boxes keep their coordinates in global memory. The
    plain version builds an N x N matrix, so it runs row by row."""
    boxes, valid = _sorted_boxes(np.random.RandomState(n + b), b, n)
    boxes, valid = boxes.to(dev), valid.to(dev)
    before = nms_keep_sorted_rowscan_cuda.launches
    got = nms_keep_sorted_rowscan_cuda(boxes, valid, thr)
    torch.cuda.synchronize()
    assert nms_keep_sorted_rowscan_cuda.launches == before + 1
    assert got.dtype == torch.bool and not got[~valid].any()
    want = torch.cat([nms_keep_sorted_plain(boxes[i:i + 1], valid[i:i + 1], thr)
                      for i in range(b)])
    assert torch.equal(got, want)
    assert torch.equal(got, nms_keep_sorted_cuda(boxes, valid, thr))


@pytest.mark.parametrize("thr", [
    -0.25, 1 / 3, 1.0, float(np.array(71363, np.uint32).view(np.float32)),
])
def test_nms_rowscan_kernel_threshold_edges(dev, thr):
    """Thresholds where the rowscan kernel's division-free comparison takes
    its other branches: below 0, not a short binary fraction, 1, and an odd
    subnormal (where a quotient can tie the rounding boundary)."""
    boxes, valid = _sorted_boxes(np.random.RandomState(7), 2, 1000)
    boxes, valid = boxes.to(dev), valid.to(dev)
    got = nms_keep_sorted_rowscan_cuda(boxes, valid, thr)
    assert torch.equal(got, nms_keep_sorted_plain(boxes, valid, thr))
    assert torch.equal(got, nms_keep_sorted_cuda(boxes, valid, thr))


def _check_unaligned_boxes(kernel, dev):
    """A view whose data does not start on 16 bytes (the kernels read each
    box as one float4): the wrapper copies it."""
    boxes, valid = _sorted_boxes(np.random.RandomState(8), 2, 300)
    flat = torch.zeros(2 * 300 * 4 + 1, device=dev)
    flat[1:] = boxes.flatten().to(dev)
    view = flat[1:].view(2, 300, 4)
    assert view.data_ptr() % 16 != 0
    got = kernel(view, valid.to(dev), 0.5)
    assert torch.equal(got.cpu(), nms_keep_sorted_plain(boxes, valid, 0.5))


def _check_all_or_nothing(kernel, dev, n):
    """A row of disjoint boxes keeps every valid box; a row of copies of
    one box keeps box 0 alone."""
    ij = np.stack(np.divmod(np.arange(n), 128), 1).astype(np.float32) * 10
    disjoint = np.concatenate([ij, ij + 5], 1)
    copies = np.tile(np.array([[10, 10, 60, 60]], np.float32), (n, 1))
    boxes = torch.from_numpy(np.stack([disjoint, copies])).to(dev)
    valid = torch.ones(2, n, dtype=torch.bool, device=dev)
    valid[0, 1::7] = False
    boxes[0][~valid[0]] = 0.0
    got = kernel(boxes, valid, 0.5)
    assert torch.equal(got[0], valid[0])
    assert torch.equal(got[1], torch.arange(n, device=dev) == 0)


def test_nms_rowscan_kernel_takes_unaligned_boxes(dev):
    _check_unaligned_boxes(nms_keep_sorted_rowscan_cuda, dev)


@pytest.mark.parametrize("n", [33, 1000, 14257])
def test_nms_rowscan_kernel_all_or_nothing(dev, n):
    _check_all_or_nothing(nms_keep_sorted_rowscan_cuda, dev, n)


def test_nms_rowscan_switch_on_card(dev, monkeypatch):
    rng = np.random.RandomState(1)
    boxes, _ = _sorted_boxes(rng, 1, 500)
    scores = torch.from_numpy(rng.rand(500).astype(np.float32))
    want = nms_mask(boxes[0], scores, 0.5)
    monkeypatch.setenv("VISION_TPU_NMS_KERNEL", "rowscan")
    counts = (nms_keep_sorted_cuda.launches,
              nms_keep_sorted_rowscan_cuda.launches)
    got = nms_mask(boxes[0].to(dev), scores.to(dev), 0.5)
    assert (nms_keep_sorted_cuda.launches,
            nms_keep_sorted_rowscan_cuda.launches) == (counts[0], counts[1] + 1)
    assert torch.equal(got.cpu(), want)


def _mm_inputs(seed, m, k, n, dtype, dev):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.randn(k, n) * 0.05).astype(np.float32)).to(dev, dtype)
    sc = torch.from_numpy((rng.rand(k) + 0.5).astype(np.float32)).to(dev)
    sh = torch.from_numpy((rng.randn(k) * 0.1).astype(np.float32)).to(dev)
    return x, w, sc, sh


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("m,k,n", [
    (224, 256, 128), (128, 16, 64), (1, 1, 1), (203, 77, 45), (130, 0, 5),
    (1000, 130, 260), (64, 300, 2048),
])
def test_matmul_stats_kernel_matches_plain(dev, m, k, n, prologue, dtype):
    x, w, sc, sh = _mm_inputs(m + k + n, m, k, n, dtype, dev)
    args = (x, w, sc, sh) if prologue else (x, w)
    before = matmul_stats_cuda.launches
    y, s1, s2 = matmul_stats_cuda(*args)
    torch.cuda.synchronize()
    assert matmul_stats_cuda.launches == before + 1
    yr, s1r, s2r = matmul_stats_plain(*args)
    assert y.dtype == dtype and s1.dtype == s2.dtype == torch.float32
    y_tol, s_tol = (1e-4, 1e-4) if dtype == torch.float32 else (2.0 ** -7, 2e-3)
    for got, want, tol in ((y, yr, y_tol), (s1, s1r, s_tol), (s2, s2r, s_tol)):
        scale = max(float(want.float().abs().max()), 1e-6)
        assert float((got.float() - want.float()).abs().max()) <= tol * scale
    again = matmul_stats_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))


# (M at a batch of 2, K, N, prologue) of a ResNet-50 forward's products
_RESNET50_CASES = [
    (6272, 64, 64, False), (6272, 64, 256, True), (6272, 64, 256, False),
    (6272, 256, 64, False), (6272, 256, 128, False),
    (1568, 128, 512, True), (1568, 256, 512, False), (1568, 512, 128, False),
    (1568, 512, 256, False),
    (392, 256, 1024, True), (392, 512, 1024, False), (392, 1024, 256, False),
    (392, 1024, 512, False),
    (98, 512, 2048, True), (98, 1024, 2048, False), (98, 2048, 512, False),
]
# M that no tile divides, with 16-byte rows; tiles of every shape
_RAGGED_CASES = [
    (203, 72, 40, False), (203, 72, 40, True), (1568, 512, 2048, True),
    (300, 8, 8, True), (65, 200, 136, True), (20000, 96, 72, True),
]
_KERNELS = {"fma": matmul_stats_fma_cuda, "wgmma": matmul_stats_wgmma_cuda,
            "general": matmul_stats_general_cuda}


@pytest.mark.parametrize("kernel", ["fast", "general"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_major", ["K", "N"])
@pytest.mark.parametrize("m,k,n,prologue", _RESNET50_CASES + _RAGGED_CASES)
def test_each_matmul_stats_kernel_matches_plain(dev, m, k, n, prologue,
                                                w_major, dtype, kernel):
    """Each of the three kernels called directly: the fast kernel of the
    type (``wgmma`` for bf16, ``fma`` for f32) and the general kernel, with
    ``w`` as the transposed view of an ``[N, K]`` weight (K-major) and as a
    contiguous ``[K, N]`` matrix (N-major). The statistics are those of the
    cast ``y``: the kernel's own ``y`` summed in f64 gives its sums."""
    x, w, sc, sh = _mm_inputs(m + k + n, m, k, n, dtype, dev)
    if w_major == "K":
        w = w.t().contiguous().t()
        assert w.stride() == (1, k)
    args = (x, w, sc, sh) if prologue else (x, w)
    fast = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert choose_kernel(m, k, n, dtype, w.stride()) == fast
    fn = _KERNELS[fast if kernel == "fast" else "general"]
    before = fn.launches
    y, s1, s2 = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    yr, s1r, s2r = matmul_stats_plain(*args)
    assert y.dtype == dtype and s1.dtype == s2.dtype == torch.float32
    y_tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    # the general kernel adds its products in another order than cuBLAS, so
    # in bf16 some of its y round the other way: 2e-3 there, as above
    s_tol = 2e-3 if (dtype, kernel) == (torch.bfloat16, "general") else 1e-4
    for got, want, tol in ((y, yr, y_tol), (s1, s1r, s_tol), (s2, s2r, s_tol)):
        scale = max(float(want.float().abs().max()), 1e-6)
        assert float((got.float() - want.float()).abs().max()) <= tol * scale
    yd = y.double()
    for got, own in ((s1, yd.sum(0)), (s2, (yd * yd).sum(0))):
        scale = max(float(own.abs().max()), 1e-6)
        assert float((got.double() - own).abs().max()) <= 1e-5 * scale
    again = fn(*args)
    assert all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_stats_wrapper_follows_choose_kernel(dev, dtype):
    """The wrapper launches the kernel ``choose_kernel`` names, and only
    that one; a view of ``w`` with an offset off the 16-byte grid goes to
    the general kernel."""
    fast = "wgmma" if dtype == torch.bfloat16 else "fma"
    for (m, k, n), want in (((203, 72, 40), fast), ((203, 77, 45), "general")):
        x, w, _, _ = _mm_inputs(1, m, k, n, dtype, dev)
        before = {name: fn.launches for name, fn in _KERNELS.items()}
        matmul_stats_cuda(x, w)
        after = {name: fn.launches for name, fn in _KERNELS.items()}
        assert {name: after[name] - before[name] for name in after} == {
            name: int(name == want) for name in after}
    x, w, _, _ = _mm_inputs(2, 64, 72, 41, dtype, dev)
    w_off = w[:, 1:]  # [72, 40], strides (41, 1), data pointer off the grid
    before = matmul_stats_general_cuda.launches
    got = matmul_stats_cuda(x, w_off)
    assert matmul_stats_general_cuda.launches == before + 1
    want = matmul_stats_plain(x, w_off)
    assert float((got[0].float() - want[0].float()).abs().max()) <= 2.0 ** -7 * \
        float(want[0].float().abs().max())


def test_fast_matmul_stats_kernels_refuse_other_shapes(dev):
    x, w, _, _ = _mm_inputs(0, 16, 77, 45, torch.float32, dev)
    with pytest.raises(ValueError, match="does not take"):
        matmul_stats_fma_cuda(x, w)
    with pytest.raises(ValueError, match="does not take"):
        matmul_stats_wgmma_cuda(x.bfloat16(), w.bfloat16())
    x, w, _, _ = _mm_inputs(0, 16, 72, 40, torch.float32, dev)
    with pytest.raises(ValueError, match="does not take"):
        matmul_stats_wgmma_cuda(x, w)  # f32 goes to the fma kernel


def test_matmul_stats_kernel_refuses_what_it_does_not_take(dev):
    x, w, sc, sh = _mm_inputs(0, 8, 4, 3, torch.float32, dev)
    with pytest.raises(TypeError, match="both f32 or both bf16"):
        matmul_stats_cuda(x.bfloat16(), w)
    with pytest.raises(TypeError, match="both f32 or both bf16"):
        matmul_stats_cuda(x.half(), w.half())
    with pytest.raises(ValueError, match="come together"):
        matmul_stats_cuda(x, w, sc)
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        matmul_stats_cuda(x, w.t())


@pytest.mark.parametrize("prologue", [False, True])
def test_matmul_stats_backward_on_card_matches_autograd_of_plain(dev, prologue):
    """The Function's hand-written backward (forward through the kernel)
    against autograd through the plain version: rtol 1e-4, atol 1e-4 of
    gradients of order 1 (f32; TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays = _mm_inputs(7, 203, 77, 45, torch.float32, dev)
    arrays = arrays if prologue else arrays[:2]

    def loss(y, s1, s2):
        k = torch.arange(s1.shape[0], dtype=torch.float32, device=dev)
        return ((y ** 2).sum() * 1e-2 + (s1 * k).sum()
                + torch.sqrt(s2 + 1.0).sum())

    grads = []
    for fn in (matmul_stats, matmul_stats_plain):
        leaves = [a.clone().requires_grad_() for a in arrays]
        loss(*fn(*leaves)).backward()
        grads.append([leaf.grad for leaf in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_detection_transform_on_card_matches_cpu(dev):
    """The request path's transform at its defaults (800 / 1333, a 1344
    canvas) on two COCO-sized images: the same sizes, and the canvas within
    1e-5 of its largest value (the resize products in f32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(50)
    imgs = [torch.from_numpy(rng.rand(3, h, w).astype(np.float32))
            for h, w in ((480, 640), (427, 640))]
    want = GeneralizedRCNNTransform(device="cpu")(imgs)
    got = GeneralizedRCNNTransform()(imgs)
    assert got.tensors.device.type == "cuda"
    assert got.image_sizes == want.image_sizes == [(800, 1067), (800, 1199)]
    tol = 1e-5 * float(want.tensors.abs().max())
    assert float((got.tensors.cpu() - want.tensors).abs().max()) <= tol


def test_image_classification_on_card_matches_cpu(dev):
    """The ResNet preset (resize 232, crop 224) on uint8 375x500 images.
    Each side rounds its f32 resize half to even; where the exact value is
    a near-tie the two may round apart, one uint8 level (1 / (255 std))."""
    torch.backends.cuda.matmul.allow_tf32 = False
    raw = torch.from_numpy(np.random.RandomState(51).randint(
        0, 256, (4, 3, 375, 500)).astype(np.uint8))
    preset = ImageClassification(crop_size=224, resize_size=232)
    want = ImageClassification(crop_size=224, resize_size=232,
                               device="cpu")(raw)
    got = preset(raw)
    assert got.device.type == "cuda" and got.shape == (4, 3, 224, 224)
    diff = (got.cpu() - want).abs()
    level = 1.0 / (255.0 * torch.tensor(preset.std))[:, None, None]
    assert bool((diff <= level * (1 + 1e-4) + 1e-5).all())
    assert float((diff > 1e-5).float().mean()) < 1e-3


# ---------------------------------------------------------------- backward


def _window_backward_case(rng, k, c, ph, winy, winx, r_rows=200, wmax=64):
    """``_window_case``'s windows and weights (edge windows, gaps, a RoI
    with all-zero weights), a third of them at one shared origin, and a
    seeded output gradient."""
    _, row0, x0, w_y, w_x = _window_case(rng, k, c, ph, winy, winx, r_rows,
                                         wmax)
    row0[k // 3: 2 * k // 3] = row0[k // 3]
    x0[k // 3: 2 * k // 3] = x0[k // 3]
    g = torch.from_numpy(rng.randn(k, c, ph, ph).astype(np.float32))
    return g, row0, x0, w_y, w_x, (r_rows, wmax)


def _same_bits_twice(fn, *args):
    first = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    return first


@pytest.mark.parametrize("winy,winx", [(32, 32), (20, 40)])
@pytest.mark.parametrize("ph", [7, 14])
@pytest.mark.parametrize("c", [1, 33, 64, 256])
def test_window_pool_backward_kernel_matches_plain(dev, c, ph, winy, winx):
    """Overlapping windows, C not a multiple of 4 or of the 32-channel
    slab, PH above 8: within 1e-5 of the largest plain value, the same
    bits on a second call."""
    rng = np.random.RandomState(60 + c + ph + winx)
    g, row0, x0, w_y, w_x, size = _window_backward_case(rng, 50, c, ph, winy,
                                                        winx)
    want = window_pool_backward_plain(g, row0, x0, w_y, w_x, size, 4.0)
    before = window_pool_backward_cuda.launches
    got = _same_bits_twice(window_pool_backward_cuda, g.to(dev), row0.to(dev),
                           x0.to(dev), w_y.to(dev), w_x.to(dev), size, 4.0)
    assert window_pool_backward_cuda.launches == before + 2
    assert got.shape == (*size, c) and got.dtype == torch.float32
    tol = 1e-5 * float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= tol


def test_window_pool_backward_kernel_at_the_training_shape(dev):
    """K = 1024 RoIs, 7x7, C = 256, 32x32 windows on a 1,292 x 336 pyramid,
    origins drawn where a 1344 canvas's levels lie: the same bits twice,
    within 1e-5 of the largest plain value (computed on the card)."""
    rng = np.random.RandomState(61)
    k, winy = 1024, 32
    row0 = rng.randint(0, 1292 - winy + 1, k).astype(np.int32)
    x0 = rng.randint(0, 336 - 32 + 1, k).astype(np.int32)
    w_y = rng.rand(k, 7, winy).astype(np.float32)
    w_x = rng.rand(k, 7, 32).astype(np.float32)
    w_y[:, :, 12:] = 0.0  # ~11 non-zero rows, as the box head's
    w_x[:, :, 24:] = 0.0
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.randn(k, 256, 7, 7).astype(np.float32), row0, x0, w_y, w_x)]
    got = _same_bits_twice(window_pool_backward_cuda, *args, (1292, 336), 4.0)
    want = window_pool_backward_plain(*args, (1292, 336), 4.0)
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


def test_window_pool_backward_kernel_without_rois(dev):
    g = torch.zeros(0, 8, 7, 7, device=dev)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    got = window_pool_backward_cuda(g, empty, empty,
                                    torch.zeros(0, 7, 32, device=dev),
                                    torch.zeros(0, 7, 32, device=dev), (40, 50))
    torch.cuda.synchronize()
    assert got.shape == (40, 50, 8) and not got.any()


def _bf16_backward_close(got, want):
    """``got`` (the bf16 kernel) within one bf16 step of ``want`` (the plain
    version's f32 sum) rounded to bf16, plus 1e-5 of the largest value."""
    want = want.cpu()
    _bf16_step_close(got, want.bfloat16(), 1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("winy,winx", [(32, 32), (20, 40)])
@pytest.mark.parametrize("ph", [7, 14])
@pytest.mark.parametrize("c", [1, 33, 64, 256])
def test_window_pool_backward_bf16_kernel_matches_plain(dev, c, ph, winy, winx):
    """The cases of the f32 test with a bf16 output gradient: a bf16
    gradient in the pyramid, the same bits on a second call."""
    rng = np.random.RandomState(160 + c + ph + winx)
    g, row0, x0, w_y, w_x, size = _window_backward_case(rng, 50, c, ph, winy,
                                                        winx)
    g = g.bfloat16()
    want = window_pool_backward_plain(g, row0, x0, w_y, w_x, size, 4.0)
    before = window_pool_backward_cuda.launches_by_dtype.get("bfloat16", 0)
    got = _same_bits_twice(window_pool_backward_cuda, g.to(dev), row0.to(dev),
                           x0.to(dev), w_y.to(dev), w_x.to(dev), size, 4.0)
    assert window_pool_backward_cuda.launches_by_dtype["bfloat16"] == before + 2
    assert got.shape == (*size, c) and got.dtype == torch.bfloat16
    _bf16_backward_close(got, want)


@pytest.mark.parametrize("ph", [7, 14])
def test_window_pool_backward_bf16_kernel_at_the_training_shapes(dev, ph):
    """K = 1,024 RoIs on the 1,292 x 336 pyramid of a 1344 canvas, C = 256,
    at the box head's 7x7 and the mask head's 14x14, a bf16 output
    gradient: the same bits twice, within one bf16 step (the plain version
    computed on the card)."""
    rng = np.random.RandomState(170 + ph)
    _, row0, x0, w_y, w_x = _mask_head_window_case(rng, 1024)
    w_y, w_x = w_y[:, :ph].contiguous(), w_x[:, :ph].contiguous()
    g = torch.from_numpy(rng.randn(1024, 256, ph, ph).astype(np.float32))
    args = [t.to(dev) for t in (g.bfloat16(), row0, x0, w_y, w_x)]
    got = _same_bits_twice(window_pool_backward_cuda, *args, (1292, 336), 4.0)
    want = window_pool_backward_plain(*args, (1292, 336), 4.0)
    _bf16_backward_close(got, want)


def test_window_pool_backward_kernel_fails_on_a_window_outside_the_pyramid(dev):
    _run_trapping("""if True:
        import torch
        from vision_tpu_torch.ops.poolers import window_pool_backward_cuda
        g = torch.ones(1, 4, 2, 2, device="cuda")
        w = torch.ones(1, 2, 8, device="cuda")
        row0 = torch.tensor([13], device="cuda")
        window_pool_backward_cuda(g, row0, torch.tensor([0], device="cuda"),
                                  w, w, (20, 10))
        print("returned", flush=True)
        torch.cuda.synchronize()
        print("synchronised", flush=True)
    """)


def _roi_backward_case(rng, k, c, size=7, n=2, h=40, w=50):
    """``k`` RoIs on both images of a batch of ``n`` (some past the map's
    edges, some sub-pixel), a seeded output gradient."""
    xy = rng.uniform(-10, 180, (k, 2))
    wh = rng.uniform(1, 120, (k, 2))
    wh[: k // 8] = rng.uniform(0.1, 3, (k // 8, 2))
    b = rng.randint(0, n, (k, 1))
    b[:2] = n - 1
    rois = torch.from_numpy(np.concatenate([b, xy, xy + wh], 1).astype(np.float32))
    g = torch.from_numpy(rng.randn(k, c, size, size).astype(np.float32))
    return g, rois, (n, c, h, w)


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("sr", [2, 0])
@pytest.mark.parametrize("c", [1, 16, 33])
def test_roi_align_backward_kernel_matches_plain(dev, c, sr, aligned):
    """Both images, a fixed and the adaptive grid, aligned both ways, C
    below, at and past the 16-channel slab: within 1e-5 of the largest
    plain value, the same bits on a second call."""
    rng = np.random.RandomState(70 + c + sr + aligned)
    g, rois, shape = _roi_backward_case(rng, 64, c)
    want = roi_align_backward_plain(g, rois, shape, 7, 0.25, sr, aligned)
    before = roi_align_backward_cuda.launches
    got = _same_bits_twice(roi_align_backward_cuda, g.to(dev), rois.to(dev),
                           shape, 7, 0.25, sr, aligned)
    assert roi_align_backward_cuda.launches == before + 2
    assert got.shape == shape and got.dtype == torch.float32
    tol = 1e-5 * float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= tol


@pytest.mark.parametrize("sr", [2, 0])
def test_roi_align_backward_kernel_at_the_training_shape(dev, sr):
    """The dense fallback's call at P2 of a 1344 canvas, batch 2: 64 RoIs,
    C = 256, 336x336: the same bits twice, within 1e-5 of the largest plain
    value (computed on the CPU)."""
    rng = np.random.RandomState(80 + sr)
    xy = rng.uniform(-20, 1344, (64, 2))
    wh = rng.uniform(8, 600, (64, 2))
    b = rng.randint(0, 2, (64, 1))
    rois = torch.from_numpy(np.concatenate([b, xy, xy + wh], 1).astype(np.float32))
    g = torch.from_numpy(rng.randn(64, 256, 7, 7).astype(np.float32))
    shape = (2, 256, 336, 336)
    got = _same_bits_twice(roi_align_backward_cuda, g.to(dev), rois.to(dev),
                           shape, 7, 0.25, sr, False).cpu()
    want = roi_align_backward_plain(g, rois, shape, 7, 0.25, sr, False)
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("sr", [2, 0])
@pytest.mark.parametrize("c", [1, 16, 33, 65])
def test_roi_align_backward_bf16_kernel_matches_plain(dev, c, sr, aligned):
    """The cases of the f32 test with a bf16 output gradient (and C past
    the 64-channel block): a bf16 gradient, the same bits on a second
    call."""
    rng = np.random.RandomState(180 + c + sr + aligned)
    g, rois, shape = _roi_backward_case(rng, 64, c)
    g = g.bfloat16()
    want = roi_align_backward_plain(g, rois, shape, 7, 0.25, sr, aligned)
    before = roi_align_backward_cuda.launches_by_dtype.get("bfloat16", 0)
    got = _same_bits_twice(roi_align_backward_cuda, g.to(dev), rois.to(dev),
                           shape, 7, 0.25, sr, aligned)
    assert roi_align_backward_cuda.launches_by_dtype["bfloat16"] == before + 2
    assert got.shape == shape and got.dtype == torch.bfloat16
    _bf16_backward_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", [7, 14])
def test_roi_align_backward_kernel_splits_a_small_map(dev, size, dtype):
    """The dense fallback at P5 of a 1344 canvas, batch 2: 64 large RoIs
    (the ones that overflow their windows) covering all of a 42x42 map,
    where the tiles are few and each RoI's sum is split into chunks added
    in order: the same bits twice, within 1e-5 of the largest plain value
    (f32) or one bf16 step (bf16), the plain version on the CPU."""
    rng = np.random.RandomState(190 + size)
    xy = rng.uniform(-40, 200, (64, 2))
    wh = rng.uniform(1100, 1400, (64, 2))
    b = rng.randint(0, 2, (64, 1))
    rois = torch.from_numpy(np.concatenate([b, xy, xy + wh], 1).astype(np.float32))
    g = torch.from_numpy(rng.randn(64, 256, size, size).astype(np.float32))
    g = g.to(dtype)
    shape = (2, 256, 42, 42)
    got = _same_bits_twice(roi_align_backward_cuda, g.to(dev), rois.to(dev),
                           shape, size, 1 / 32, 2, False).cpu()
    want = roi_align_backward_plain(g, rois, shape, size, 1 / 32, 2, False)
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        _bf16_backward_close(got, want)
    else:
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("sr", [2, 0])
def test_roi_align_backward_bf16_kernel_at_the_training_shape(dev, sr):
    """The f32 training-shape case (P2 of a 1344 canvas, batch 2, 64 RoIs,
    C = 256, 14x14) with a bf16 output gradient: the same bits twice,
    within one bf16 step of the plain version on the CPU."""
    rng = np.random.RandomState(200 + sr)
    xy = rng.uniform(-20, 1344, (64, 2))
    wh = rng.uniform(8, 600, (64, 2))
    b = rng.randint(0, 2, (64, 1))
    rois = torch.from_numpy(np.concatenate([b, xy, xy + wh], 1).astype(np.float32))
    g = torch.from_numpy(rng.randn(64, 256, 14, 14).astype(np.float32)).bfloat16()
    shape = (2, 256, 336, 336)
    got = _same_bits_twice(roi_align_backward_cuda, g.to(dev), rois.to(dev),
                           shape, 14, 0.25, sr, False).cpu()
    want = roi_align_backward_plain(g, rois, shape, 14, 0.25, sr, False)
    _bf16_backward_close(got, want)


def test_roi_align_backward_kernel_without_rois(dev):
    got = roi_align_backward_cuda(torch.zeros(0, 4, 7, 7, device=dev),
                                  torch.zeros(0, 5, device=dev), (2, 4, 9, 10),
                                  7, 0.5, 2, False)
    torch.cuda.synchronize()
    assert got.shape == (2, 4, 9, 10) and not got.any()


@pytest.mark.parametrize("batch_index", ["2.0", "-1.0", "float('nan')"])
def test_roi_align_backward_kernel_fails_on_a_batch_index_outside_the_input(
        dev, batch_index):
    _run_trapping(f"""if True:
        import torch
        from vision_tpu_torch.ops.roi_align import roi_align_backward_cuda
        g = torch.ones(1, 3, 2, 2, device="cuda")
        rois = torch.tensor([[{batch_index}, 0, 0, 4, 4]], device="cuda")
        roi_align_backward_cuda(g, rois, (2, 3, 8, 8), 2, 1.0, 2)
        print("returned", flush=True)
        torch.cuda.synchronize()
        print("synchronised", flush=True)
    """)


def test_multiscale_pooler_backward_on_card_matches_cpu(dev):
    """The pooler's gradient in each level, through the window-pool
    backward kernel and the RoIAlign backward kernel (the dense recompute of
    the RoIs that overflow a window of 8), against the CPU's plain path."""
    rng = np.random.RandomState(90)
    names = ["0", "1", "2", "3"]
    feats = {n: rng.rand(2, 32, 64 >> i, 64 >> i).astype(np.float32)
             for i, n in enumerate(names)}
    xy = rng.uniform(0, 200, (100, 2))
    wh = rng.uniform(4, 150, (100, 2))
    b = rng.randint(0, 2, (100, 1))
    rois = torch.from_numpy(np.concatenate([b, xy, xy + wh], 1).astype(np.float32))
    g = torch.from_numpy(rng.randn(100, 32, 7, 7).astype(np.float32))
    pooler = MultiScaleRoIAlign(names, 7, 2, window=8)
    grads = []
    counts = (window_pool_backward_cuda.launches, roi_align_backward_cuda.launches)
    for device in ("cpu", dev):
        x = {k: torch.from_numpy(v).to(device).requires_grad_()
             for k, v in feats.items()}
        pooler(x, rois.to(device), (256, 256)).backward(g.to(device))
        grads.append({k: v.grad.cpu() for k, v in x.items()})
    assert window_pool_backward_cuda.launches == counts[0] + 1
    assert roi_align_backward_cuda.launches == counts[1] + 4
    for k in names:
        want = grads[0][k]
        torch.testing.assert_close(grads[1][k], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


# ------------------------------------------- the Mask and Keypoint R-CNN shapes


def _mask_head_window_case(rng, k, dtype=torch.float32):
    """The 14x14 poolers' window pool on the pyramid of a 1344 canvas,
    batch 2 (1,292 x 336 rows and columns, C = 256): ``k`` RoIs (200
    detections served, 1,024 samples trained), 32x32 windows with ~11
    non-zero rows and ~23 columns, as a RoI's 14 x 2 samples cover them."""
    stacked = torch.from_numpy(rng.randn(1292, 336, 256).astype(np.float32))
    row0 = rng.randint(0, 1292 - 32 + 1, k).astype(np.int32)
    x0 = rng.randint(0, 336 - 32 + 1, k).astype(np.int32)
    w_y = rng.rand(k, 14, 32).astype(np.float32)
    w_x = rng.rand(k, 14, 32).astype(np.float32)
    w_y[:, :, 12:] = 0.0
    w_x[:, :, 24:] = 0.0
    return (stacked.to(dtype), torch.from_numpy(row0), torch.from_numpy(x0),
            torch.from_numpy(w_y), torch.from_numpy(w_x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [200, 1024])
def test_window_pool_kernel_at_the_mask_head_shape(dev, k, dtype):
    """14x14 (PH above 8: the 16-row register tile, 186 KB of shared memory
    a block in f32), against the plain version on the card: f32 within 1e-5
    of the largest plain value, bf16 within one bf16 step."""
    args = [t.to(dev) for t in _mask_head_window_case(
        np.random.RandomState(100 + k), k, dtype)]
    before = window_pool_cuda.launches
    got = window_pool_cuda(*args, 4.0)
    want = window_pool_plain(*args, 4.0)
    torch.cuda.synchronize()
    assert window_pool_cuda.launches == before + 1
    assert got.shape == (k, 256, 14, 14) and got.dtype == dtype
    if dtype == torch.bfloat16:
        _bf16_step_close(got, want.cpu(), 1e-5 * float(want.float().abs().max()))
    else:
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_window_pool_backward_kernel_at_the_mask_head_shape(dev):
    """K = 1,024 trained RoIs at 14x14 (a [32 ch, 14, 14] gradient slab a
    RoI, the 16-row template): the same bits twice, within 1e-5 of the
    largest plain value (computed on the card)."""
    rng = np.random.RandomState(110)
    _, row0, x0, w_y, w_x = _mask_head_window_case(rng, 1024)
    g = torch.from_numpy(rng.randn(1024, 256, 14, 14).astype(np.float32))
    args = [t.to(dev) for t in (g, row0, x0, w_y, w_x)]
    got = _same_bits_twice(window_pool_backward_cuda, *args, (1292, 336), 4.0)
    want = window_pool_backward_plain(*args, (1292, 336), 4.0)
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


def test_roi_align_kernel_at_the_mask_target_shape(dev):
    """Mask R-CNN's targets: 1,024 sampled boxes (8 px to the whole 1344
    canvas, some past its edges) pooled from 16 one-channel 0/1 gt masks
    at 28x28, sampling ratio 2, scale 1 (a block of 16 channels holds one):
    within 1e-5 of the largest plain value (on the CPU, 128 RoIs at a
    time)."""
    rng = np.random.RandomState(120)
    masks = torch.from_numpy((rng.rand(16, 1, 1344, 1344) > 0.5).astype(np.float32))
    xy = rng.uniform(-20, 1300, (1024, 2))
    wh = rng.uniform(8, 1344, (1024, 2))
    b = rng.randint(0, 16, (1024, 1))
    rois = torch.from_numpy(np.concatenate([b, xy, xy + wh], 1).astype(np.float32))
    before = roi_align_cuda.launches
    got = roi_align_cuda(masks.to(dev), rois.to(dev), 28, 1.0, 2).cpu()
    assert roi_align_cuda.launches == before + 1
    want = torch.cat([roi_align_plain(masks, rois[i:i + 128], 28, 1.0, 2)
                      for i in range(0, 1024, 128)])
    assert got.shape == (1024, 1, 28, 28)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ---------------------------------------------------------------- deform


def _deform_case(rng, n, c, h, w, stride, og, pad, dil, with_mask, k=3,
                 spread=1.5):
    """A seeded input ``[n, c, h, w]``, offsets of RMS ``spread`` px with
    one in 20 sent 3 maps away (outside the map) and one in 20 on an exact
    integer, and a mask in (0, 1) (or None)."""
    oh = (h + 2 * pad - (dil * (k - 1) + 1)) // stride + 1
    ow = (w + 2 * pad - (dil * (k - 1) + 1)) // stride + 1
    x = rng.randn(n, c, h, w).astype(np.float32)
    off = (rng.randn(n, 2 * og * k * k, oh, ow) * spread).astype(np.float32)
    pick = rng.rand(*off.shape)
    off[pick < 0.05] = 3.0 * max(h, w) * np.sign(off[pick < 0.05])
    off[pick > 0.95] = np.round(off[pick > 0.95])
    mask = rng.rand(n, og * k * k, oh, ow).astype(np.float32) if with_mask else None
    return (torch.from_numpy(x), torch.from_numpy(off),
            None if mask is None else torch.from_numpy(mask))


# (n, c, h, w, stride, og, pad, dil, mask): small maps with samples outside
# them, C not a multiple of 4, two offset groups, stride 2, dilation; then
# the C3 shapes of Mask R-CNN on the 1344 canvas, batch 2 (the first block's
# stride-2 call on the 336x336 map, and the others' on 168x168)
DEFORM_CASES = [
    (2, 8, 9, 11, 1, 1, 1, 1, False),
    (1, 6, 10, 7, 2, 2, 1, 1, True),
    (2, 5, 8, 8, 1, 1, 2, 2, True),
    (1, 64, 20, 24, 2, 1, 1, 1, False),
    (2, 128, 336, 336, 2, 1, 1, 1, False),
    (2, 128, 168, 168, 1, 1, 1, 1, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DEFORM_CASES)
def test_deform_im2col_kernel_matches_plain(dev, case, dtype):
    """The columns, every element written: the plain version's bits (f32,
    and bf16 widened), for both input types."""
    n, c, h, w, stride, og, pad, dil, with_mask = case
    rng = np.random.RandomState(200 + c + h)
    x, off, mask = (None if t is None else t.to(dev)
                    for t in _deform_case(rng, *case))
    x = x.to(dtype)
    before = deform_im2col_cuda.launches
    got = deform_im2col_cuda(x, off, mask, 3, stride, pad, dil)
    want = deform_im2col_plain(x, off, mask, 3, stride, pad, dil)
    torch.cuda.synchronize()
    assert deform_im2col_cuda.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want), float((got - want).abs().max())
    # samples outside the map give zero columns
    assert bool((got == 0).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DEFORM_CASES)
def test_deform_backward_kernel_matches_plain(dev, case, dtype):
    """The input's, the offsets' and the mask's gradients: the same bits
    twice, against the plain version's (autograd of the plain columns) on
    the card."""
    n, c, h, w, stride, og, pad, dil, with_mask = case
    rng = np.random.RandomState(300 + c + h)
    x, off, mask = (None if t is None else t.to(dev)
                    for t in _deform_case(rng, *case))
    x = x.to(dtype)
    oh, ow = off.shape[-2:]
    g = torch.randn(n, oh, ow, 9, c, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(c))
    before = deform_conv_backward_cuda.launches
    first = deform_conv_backward_cuda(x, off, mask, g, 3, stride, pad, dil)
    again = deform_conv_backward_cuda(x, off, mask, g, 3, stride, pad, dil)
    want = deform_conv_backward_plain(x, off, mask, g, 3, stride, pad, dil)
    torch.cuda.synchronize()
    assert deform_conv_backward_cuda.launches == before + 2
    for a, b in zip(first, again):
        assert (a is None and b is None) or torch.equal(a, b)
    gi, go, gm = first
    assert gi.dtype == dtype and gi.shape == x.shape
    assert go.dtype == torch.float32 and go.shape == off.shape
    assert (gm is None) == (mask is None)
    if dtype == torch.bfloat16:
        _bf16_backward_close(gi, want[0])
    else:
        assert float((gi - want[0]).abs().max()) <= 1e-5 * float(
            want[0].abs().max())
    for got_t, want_t in zip(first[1:], want[1:]):
        if want_t is not None:
            assert float((got_t - want_t).abs().max()) <= 1e-5 * float(
                want_t.abs().max())
    # samples outside the map carry no offset gradient
    assert bool((go == 0).any())


def test_deform_conv2d_routes_by_device(dev):
    """A CUDA tensor launches the kernels (forward, and backward once a
    gradient is asked for) and never the plain versions' path; the same
    call on CPU tensors launches nothing."""
    rng = np.random.RandomState(7)
    x, off, mask = _deform_case(rng, 1, 8, 9, 9, 1, 1, 1, 1, True)
    weight = torch.from_numpy(rng.randn(4, 8, 3, 3).astype(np.float32))
    counts = (deform_im2col_cuda.launches, deform_conv_backward_cuda.launches)
    deform_conv2d(x, off, weight, None, 1, 1, 1, mask)
    assert counts == (deform_im2col_cuda.launches,
                      deform_conv_backward_cuda.launches)
    xd = x.to(dev).requires_grad_(True)
    out = deform_conv2d(xd, off.to(dev), weight.to(dev), None, 1, 1, 1,
                        mask.to(dev))
    out.sum().backward()
    torch.cuda.synchronize()
    assert (deform_im2col_cuda.launches, deform_conv_backward_cuda.launches
            ) == (counts[0] + 1, counts[1] + 1)
    want = deform_conv2d(x, off, weight, None, 1, 1, 1, mask)
    assert float((out.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
