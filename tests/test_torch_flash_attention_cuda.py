"""The flash-attention kernels on the card (``csrc/flash_attention.cu``,
``csrc/flash_attention_backward.cu``) against their plain versions on the
same card tensors (TF32 off): the forward (``o`` and ``lse``), the dK/dV
and the dQ kernels, at S = 1, 197, 577 and 1,025 (ragged against every
tile), D = 64 and 128, f32 and bf16, at more heads than one grid holds
and at strided views of a packed q, k, v projection; the bf16 backward
kernels (128-row work items, 64-row tiles, a narrow last tile) also at
S = 63, 64, 65, 80, 81, 127, 128 and 129, and the f32 backward kernels
(3xTF32 products; 64 fixed rows a block, 16 a warp, walked tiles of 32
rows, 16 at D = 128) at S = 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127,
128 and 129; the forward (bf16: 128- or 192-row work items on persistent
blocks, 128-key tiles, a narrow last tile as 80, 64 or 16 keys; f32: 64
rows a block, 32-key tiles, 16 at D = 128) at S = 1, 15, 16, 17, 31, 32, 33, 63,
64, 65, 127, 128, 129, 191, 192, 193, 577 and 1,025, and at more work
items than the card holds blocks at once; the forward and the backward
kernels give the same bits on two calls; rows
past S are never read (views of longer buffers holding 1e4 there give the
bits of contiguous copies); the forward and backward make no host
synchronisation; an unsupported head dim is refused. Marked ``cuda``;
every test skips where no CUDA device is present (decided inside the
fixture). Run on a GPU host with:

    python -m pytest tests/test_torch_flash_attention_cuda.py -m cuda --noconftest

Tolerances, of the largest plain value: f32 1e-5 for ``o`` and 1e-4 for the
gradients (sums of S terms of both signs, taken in another order; ``exp2``
with log2 e folded into the scale; the f32 backward's products as three
TF32 products, ~2^-21 of each); ``lse`` 1e-5 absolute; bf16 2e-2 (the
kernel rounds ``p`` to bf16 against the running maximum of its key tile,
the plain version against the row's maximum; each output is one bf16
rounding of an f32 sum). A gradient's largest value is taken as at least
1e-2 (the inputs are unit normals): at S = 1 the softmax is constant, and
dq and dk are round-off on both sides.
"""

import pytest
import torch

from vision_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
GRAD_FLOOR = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _rel(got, want, floor=0.0):
    return float((got.float() - want.float()).abs().max()
                 / max(float(want.float().abs().max()), floor))


def _inputs(dev, dtype, s, d, b=2, h=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, s, d, generator=g).to(dev, dtype)
            for _ in range(4)]


def _check(q, k, v, do):
    dtype = q.dtype
    tol_o, tol_g = TOL[dtype]
    o, lse = A.flash_attention_forward_cuda(q, k, v)
    want_o, want_lse = A.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape and lse.dtype == torch.float32
    assert bool(torch.isfinite(o).all())
    assert _rel(o, want_o) <= tol_o
    assert float((lse - want_lse).abs().max()) <= 1e-5 * max(
        1.0, float(want_lse.abs().max()))
    di = A._di(want_o, do)
    dk, dv = A.flash_attention_dkv_cuda(q, k, v, do, want_lse, di)
    dq = A.flash_attention_dq_cuda(q, k, v, do, want_lse, di)
    want_dk, want_dv = A.flash_attention_dkv_plain(q, k, v, do, want_lse, di)
    want_dq = A.flash_attention_dq_plain(q, k, v, do, want_lse, di)
    torch.cuda.synchronize()
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype and got.shape == q.shape
        assert _rel(got, want, GRAD_FLOOR) <= tol_g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 197, 577, 1025])
def test_kernels_match_the_plain_versions(dev, s, d, dtype):
    _check(*_inputs(dev, dtype, s, d))


def _check_backward(dev, dtype, s, d, seed):
    """The dK/dV and dQ kernels against their plain versions at one shape:
    finite, within the type's gradient tolerance."""
    q, k, v, do = _inputs(dev, dtype, s, d, seed=seed)
    want_o, lse = A.flash_attention_plain(q, k, v)
    di = A._di(want_o, do)
    dk, dv = A.flash_attention_dkv_cuda(q, k, v, do, lse, di)
    dq = A.flash_attention_dq_cuda(q, k, v, do, lse, di)
    want_dk, want_dv = A.flash_attention_dkv_plain(q, k, v, do, lse, di)
    want_dq = A.flash_attention_dq_plain(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype and got.shape == q.shape
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want, GRAD_FLOOR) <= TOL[dtype][1]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 80, 81, 127, 128, 129, 577,
                               1025])
def test_bf16_backward_at_the_tile_edges(dev, s, d):
    """The bf16 dK/dV and dQ kernels own 128 rows a work item and walk
    64-row tiles, a last tile of at most 16 valid rows as 16: S on either
    side of each (80 leaves 16 in the last tile, 81 leaves 17)."""
    _check_backward(dev, torch.bfloat16, s, d, seed=6)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127,
                               128, 129])
def test_f32_backward_at_the_tile_edges(dev, s, d):
    """The f32 dK/dV and dQ kernels give a block 64 fixed rows, a warp 16
    of them, and walk 32-row tiles (16 at d = 128): S on either side of
    each edge. Every product is three TF32 products, held to the plain f32
    versions (TF32 off) at the f32 tolerance."""
    _check_backward(dev, torch.float32, s, d, seed=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [65, 577])
def test_rows_past_the_sequence_are_never_read(dev, s, dtype):
    """q, k, v and do as ``[:, :, :S]`` views of longer buffers whose rows
    past S hold 1e4: the kernels give the bits they give on contiguous
    copies."""
    b, h, d, extra = 2, 3, 64, 70
    g = torch.Generator().manual_seed(7)
    bufs = [torch.randn(b, h, s + extra, d, generator=g) for _ in range(4)]
    for t in bufs:
        t[:, :, s:] = 1e4
    views = [t.to(dev, dtype)[:, :, :s] for t in bufs]
    copies = [t.contiguous() for t in views]
    assert all(A._readable(t) is t for t in views)
    q, k, v, do = views
    o, lse = A.flash_attention_forward_cuda(q, k, v)
    o2, lse2 = A.flash_attention_forward_cuda(*copies[:3])
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    di = A._di(o, do)
    got = A.flash_attention_dkv_cuda(q, k, v, do, lse, di) + (
        A.flash_attention_dq_cuda(q, k, v, do, lse, di),)
    want = A.flash_attention_dkv_cuda(*copies, lse, di) + (
        A.flash_attention_dq_cuda(*copies, lse, di),)
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert all(bool(torch.isfinite(a).all()) for a in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_read_views_of_a_packed_projection(dev, dtype):
    """ViT's layout: q, k, v are head views of one ``[B, S, 3 H D]``
    projection (row stride 3 H D), read where they lie; ``do`` a transposed
    view."""
    b, s, h, d = 2, 577, 4, 64
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(b, s, 3 * h * d, generator=g).to(dev, dtype)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.chunk(3, -1))
    do = torch.randn(b, s, h, d, generator=g).to(dev, dtype).transpose(1, 2)
    for t in (q, k, v, do):
        assert not t.is_contiguous() and A._readable(t) is t
    _check(q, k, v, do)
    o, _ = A.flash_attention_forward_cuda(q, k, v)
    o2, _ = A.flash_attention_forward_cuda(*(t.contiguous() for t in (q, k, v)))
    assert torch.equal(o, o2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_more_heads_than_one_grid_holds(dev, dtype):
    """B H = 65,600 (batch x heads) passes the grid's 65,535 rows: the
    kernels launch again for the rest."""
    _check(*_inputs(dev, dtype, 9, 64, b=65_600, h=1, seed=5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_gives_the_same_bits_twice(dev, dtype):
    q, k, v, do = _inputs(dev, dtype, 1025, 64, b=1, h=4, seed=2)
    _, lse = A.flash_attention_forward_cuda(q, k, v)
    o = A.flash_attention_plain(q, k, v)[0]
    di = A._di(o, do)
    first = A.flash_attention_dkv_cuda(q, k, v, do, lse, di) + (
        A.flash_attention_dq_cuda(q, k, v, do, lse, di),)
    again = A.flash_attention_dkv_cuda(q, k, v, do, lse, di) + (
        A.flash_attention_dq_cuda(q, k, v, do, lse, di),)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_the_gate_matches_the_plain_gradients(dev, dtype):
    """``scaled_dot_product_attention`` past the gate: the kernels, each
    counted once a call, against autograd of the plain forward."""
    q, k, v, do = _inputs(dev, dtype, 577, 64, b=2, h=2, seed=3)
    counts = [A.flash_attention_forward_cuda.launches,
              A.flash_attention_dkv_cuda.launches,
              A.flash_attention_dq_cuda.launches]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = A.scaled_dot_product_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    assert [A.flash_attention_forward_cuda.launches - counts[0],
            A.flash_attention_dkv_cuda.launches - counts[1],
            A.flash_attention_dq_cuda.launches - counts[2]] == [1, 1, 1]
    o, lse = A.flash_attention_plain(q, k, v)
    want = A.flash_attention_backward_plain(q, k, v, o, do, lse)
    tol_o, tol_g = TOL[dtype]
    assert _rel(out.detach(), o) <= tol_o
    for got, w in zip(grads, want):
        assert _rel(got, w, GRAD_FLOOR) <= tol_g


def _check_forward(q, k, v):
    """The forward kernel against its plain version: finite, ``o`` within
    the type's tolerance, ``lse`` within 1e-5 of max(1, its largest)."""
    o, lse = A.flash_attention_forward_cuda(q, k, v)
    want_o, want_lse = A.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert o.dtype == q.dtype and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    assert _rel(o, want_o) <= TOL[q.dtype][0]
    assert float((lse - want_lse).abs().max()) <= 1e-5 * max(
        1.0, float(want_lse.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127,
                               128, 129, 191, 192, 193, 577, 1025])
def test_forward_at_the_tile_edges(dev, s, d, dtype):
    """The bf16 forward owns 64 query rows a warpgroup, two or three
    warpgroups a work item (three at d = 64 where they leave no more of
    them without a row than two: S = 129, 191, 192 and 1,025 take three,
    65, 193 and 577 two), and walks 128-key tiles, a last tile as 80, 64
    or 16 keys when those cover its valid ones; the f32 forward owns 64
    rows a block (16 a warp) and walks 32-key tiles (16 at d = 128): S on
    either side of each edge."""
    _check_forward(*_inputs(dev, dtype, s, d, seed=9)[:3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_with_more_work_items_than_blocks(dev, dtype):
    """4 x 32 heads of 300 rows: 256 bf16 work items of 192 rows, more than
    the persistent blocks the card holds at once (one an SM), so each block
    walks several and reuses its q buffers."""
    _check_forward(*_inputs(dev, dtype, 300, 64, b=4, h=32, seed=10)[:3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [577, 1025])
def test_forward_gives_the_same_bits_twice(dev, s, dtype):
    q, k, v = _inputs(dev, dtype, s, 64, b=2, h=8, seed=11)[:3]
    o, lse = A.flash_attention_forward_cuda(q, k, v)
    o2, lse2 = A.flash_attention_forward_cuda(q, k, v)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_forward_and_backward_make_no_host_synchronisation(dev):
    q, k, v, do = _inputs(dev, torch.bfloat16, 577, 64, b=2, h=2, seed=4)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def step():
        out = A.flash_attention(*leaves)
        return torch.autograd.grad(out, leaves, do)

    step()  # the libraries load outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("d", [32, 80, 256])
def test_an_unsupported_head_dim_is_refused(dev, d):
    q, k, v, do = _inputs(dev, torch.bfloat16, 600, d, b=1, h=1)
    with pytest.raises(ValueError, match=r"\(64, 128\)"):
        A.flash_attention_forward_cuda(q, k, v)
    with pytest.raises(ValueError, match=r"\(64, 128\)"):
        A.flash_attention(q, k, v)
    lse = torch.zeros(1, 1, 600, device=dev)
    with pytest.raises(ValueError, match=r"\(64, 128\)"):
        A.flash_attention_dkv_cuda(q, k, v, do, lse, lse)
    with pytest.raises(ValueError, match=r"\(64, 128\)"):
        A.flash_attention_dq_cuda(q, k, v, do, lse, lse)


def test_vit_384_amp_step_makes_no_host_synchronisation(dev):
    """A small ViT at 384 px (head dim 64, 577 tokens: past the gate)
    through the whole recipe step in bf16, the augmentation cropping to
    384: forward and backward through the flash kernels."""
    from vision_tpu_torch.models import vision_transformer as tvit
    from vision_tpu_torch.tools.vit_train import RecipeStep, frames

    model = tvit.VisionTransformer(384, 16, 2, 2, 128, 256).to(dev)
    run = RecipeStep(model, torch.bfloat16, batch_size=4, crop_size=384)
    raw = frames(4, 448, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    run(raw, gen)  # optimizer state, cached tables
    counts = A.flash_attention_dq_cuda.launches_by_dtype.get("bfloat16", 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = run(raw, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    assert A.flash_attention_dq_cuda.launches_by_dtype["bfloat16"] == counts + 2
