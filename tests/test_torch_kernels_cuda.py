"""Each CUDA kernel of ``vision_tpu_torch`` against its plain PyTorch
version, on the card, at small shapes. Marked ``cuda``; every test skips
where no CUDA device is present (the decision is made inside the fixture,
never at import). Run on a GPU host with:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerances: NMS keep masks exactly equal (both kernels); RoIAlign 1e-5 and
the window pool 1e-4 absolute on inputs of order 1 (sums in another order);
``matmul_stats`` in f32 within 1e-4 of the largest value of ``y`` and of
each sum, in bf16 ``y`` within one bf16 step of the largest (a step is
2**-8 to 2**-7 of the value it rounds) and the sums within 2e-3 (a flipped
rounding of one ``y`` moves a sum by a bf16 step of that value); at the
ResNet-50 cases, where thousands of rows average such flips out, the sums
within 1e-4 in both types.
"""

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
    window_pool_cuda,
    window_pool_plain,
)
from vision_tpu_torch.ops.roi_align import roi_align_cuda, roi_align_plain

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


@pytest.mark.parametrize("c,ph", [(256, 7), (40, 14)])
def test_window_pool_kernel_matches_plain(dev, c, ph):
    rng = np.random.RandomState(3)
    k, winy, winx, r_rows, wmax = 50, 32, 32, 200, 64
    stacked = torch.from_numpy(rng.randn(r_rows, wmax, c).astype(np.float32))
    row0 = torch.from_numpy(rng.randint(0, r_rows - winy + 1, k).astype(np.int32))
    x0 = torch.from_numpy(rng.randint(0, wmax - winx + 1, k).astype(np.int32))
    w_y = rng.rand(k, ph, winy).astype(np.float32)
    w_y[:, :, 20:] = 0.0  # rows the kernel skips
    w_y = torch.from_numpy(w_y)
    w_x = torch.from_numpy(rng.rand(k, ph, winx).astype(np.float32))
    want = window_pool_plain(stacked, row0, x0, w_y, w_x, 4.0)
    got = window_pool_cuda(*(t.to(dev) for t in (stacked, row0, x0, w_y, w_x)),
                           4.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-5)
    with pytest.raises(ValueError, match="leaves the pyramid"):
        window_pool_cuda(stacked.to(dev), (row0 + r_rows).to(dev), x0.to(dev),
                         w_y.to(dev), w_x.to(dev))


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


@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("n", [1, 63, 1000, 20000])
def test_nms_rowscan_kernel_equals_plain(dev, b, n):
    """N = 20000 does not fit in shared memory: the global-memory form.
    The plain version builds an N x N matrix, so it runs row by row there."""
    boxes, valid = _sorted_boxes(np.random.RandomState(n + b), b, n)
    boxes, valid = boxes.to(dev), valid.to(dev)
    before = nms_keep_sorted_rowscan_cuda.launches
    got = nms_keep_sorted_rowscan_cuda(boxes, valid, 0.5)
    torch.cuda.synchronize()
    assert nms_keep_sorted_rowscan_cuda.launches == before + 1
    assert got.dtype == torch.bool and not got[~valid].any()
    want = torch.cat([nms_keep_sorted_plain(boxes[i:i + 1], valid[i:i + 1], 0.5)
                      for i in range(b)])
    assert torch.equal(got, want)
    assert torch.equal(got, nms_keep_sorted_cuda(boxes, valid, 0.5))


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
