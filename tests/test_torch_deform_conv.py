"""Deformable convolution parity: the port's ``deform_conv2d`` (the plain
PyTorch paths on the CPU) and its gradients against the JAX package's
``vision_tpu.ops.deform_conv2d`` and ``jax.vjp``; the port's
``DeformFrozenBottleneck`` against ``_DeformFrozenBottleneck``; the JAX
tests' two properties of the block at init; and the op's routing (CPU
tensors take the plain versions and launch no kernel).

Inputs are seeded numpy arrays: offsets of RMS 1.5 px with one in 20 sent
three maps away (samples outside the map) and one in 20 rounded to an
integer (samples on exact integer positions, where a corner's weight is
0), weights that are not symmetric in any axis, so that a tap or channel
order that differs from the JAX ``[.., K², C_in]`` columns shows.

Tolerances: the op in f32 within 1e-5 of the largest JAX value (sums in
another order); with bf16 inputs (the amp path: bf16 input, offsets,
mask, weight and bias; f32 sampling and product; the result rounded once)
each element within one bf16 step of its magnitude plus 1e-5 of the
largest value; gradients within 1e-5 of each one's largest JAX value.
The block: outputs within 1e-5 and gradients within 1e-4 of the largest
value (a 3-conv stack whose offsets come from a conv in another order).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.models.detection.backbone_utils import (
    _DeformFrozenBottleneck,
    _FrozenBottleneck,
)
from vision_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from vision_tpu_torch._jax_convert import (
    _leaves,
    _to_torch_layout,
    _torch_name,
    load_jax_variables,
)
from vision_tpu_torch.models.detection.backbone_utils import (
    DeformFrozenBottleneck,
    FrozenBottleneck,
    ResNetTrunk,
)
from vision_tpu_torch.ops import DeformConv2d, deform_conv2d
from vision_tpu_torch.ops.deform_conv import (
    MARGIN,
    SMEM_LIMIT,
    deform_conv2d_plain,
    deform_conv_backward_cuda,
    deform_conv_backward_plain,
    deform_corner_records_plain,
    deform_im2col_cuda,
    deform_im2col_plain,
    deform_records_input_grad_plain,
    deform_tile_codes_plain,
    sample_positions,
    sort_corners,
    tile_plan,
)
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

# (n, c_in, h, w, c_out, (kh, kw), stride, pad, dil, groups, og, mask, bias)
CASES = [
    (2, 4, 9, 11, 6, (3, 3), 1, 1, 1, 1, 1, False, True),
    (1, 6, 10, 7, 4, (3, 3), 2, 1, 1, 1, 2, True, False),
    (2, 4, 8, 8, 4, (3, 3), 1, 2, 2, 2, 1, True, True),
    (1, 8, 7, 9, 6, (3, 3), 2, 0, 1, 2, 2, False, True),
    (1, 5, 9, 8, 3, (3, 2), 1, 1, 1, 1, 1, True, True),
]
IDS = ["s1", "s2-og2-mask", "dil2-groups2", "pad0-groups2-og2", "k3x2"]


def _case(case, seed):
    """numpy NHWC / HWIO arrays of a case, as the JAX function takes them."""
    n, c, h, w, co, (kh, kw), stride, pad, dil, groups, og, with_mask, with_bias = case
    rng = np.random.RandomState(seed)
    oh = (h + 2 * pad - (dil * (kh - 1) + 1)) // stride + 1
    ow = (w + 2 * pad - (dil * (kw - 1) + 1)) // stride + 1
    x = rng.randn(n, h, w, c).astype(np.float32)
    off = (rng.randn(n, oh, ow, 2 * og * kh * kw) * 1.5).astype(np.float32)
    pick = rng.rand(*off.shape)
    off[pick < 0.05] = 3.0 * max(h, w) * np.sign(off[pick < 0.05])
    off[pick > 0.95] = np.round(off[pick > 0.95])
    weight = rng.randn(kh, kw, c // groups, co).astype(np.float32)
    mask = rng.rand(n, oh, ow, og * kh * kw).astype(np.float32) if with_mask else None
    bias = rng.randn(co).astype(np.float32) if with_bias else None
    return dict(x=x, off=off, weight=weight, mask=mask, bias=bias,
                geometry=((stride, stride), (pad, pad), (dil, dil)))


def _nchw(a):
    return None if a is None else torch.from_numpy(
        np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _port_args(arrays, dtype=torch.float32):
    t = [_nchw(arrays["x"]), _nchw(arrays["off"]),
         torch.from_numpy(np.ascontiguousarray(arrays["weight"].transpose(3, 2, 0, 1))),
         None if arrays["bias"] is None else torch.from_numpy(arrays["bias"]),
         _nchw(arrays["mask"])]
    return [None if a is None else a.to(dtype) for a in t]


def _jax_fn(arrays):
    stride, pad, dil = arrays["geometry"]
    has_mask, has_bias = arrays["mask"] is not None, arrays["bias"] is not None

    def fn(x, off, weight, bias, mask):
        return jax_deform_conv2d(x, off, weight, bias if has_bias else None,
                                 stride, pad, dil, mask if has_mask else None)
    return fn


def _jax_inputs(arrays, dtype=jnp.float32):
    return [jnp.zeros(()) if arrays[k] is None else jnp.asarray(arrays[k], dtype)
            for k in ("x", "off", "weight", "bias", "mask")]


def _rel_close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_deform_conv2d_matches_jax(case):
    arrays = _case(case, 1)
    want = np.asarray(_jax_fn(arrays)(*_jax_inputs(arrays)))
    stride, pad, dil = arrays["geometry"]
    x, off, weight, bias, mask = _port_args(arrays)
    got = deform_conv2d(x, off, weight, bias, stride, pad, dil, mask)
    assert got.dtype == torch.float32
    _rel_close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)
    # some samples fall outside the map, some on exact integers
    y, xs = sample_positions(off, weight.shape[-2:], stride, pad, dil)
    h, w = x.shape[-2:]
    outside = (y <= -1) | (y >= h) | (xs <= -1) | (xs >= w)
    assert bool(outside.any()) and bool((~outside).any())
    assert bool((y == torch.round(y)).any())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_deform_conv2d_bf16_matches_jax(case):
    """bf16 input, offsets, mask, weight and bias: f32 sampling and product,
    the result rounded to bf16 once, as the JAX function does."""
    arrays = _case(case, 2)
    want = _jax_fn(arrays)(*_jax_inputs(arrays, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    stride, pad, dil = arrays["geometry"]
    x, off, weight, bias, mask = _port_args(arrays, torch.bfloat16)
    got = deform_conv2d(x, off, weight, bias, stride, pad, dil, mask)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_deform_conv2d_gradients_match_jax_vjp(case):
    """The input's, the offsets', the mask's, the weight's and the bias's
    gradients through the op's autograd (plain backward on the CPU)
    against ``jax.vjp``."""
    arrays = _case(case, 3)
    out, vjp = jax.vjp(_jax_fn(arrays), *_jax_inputs(arrays))
    g = np.random.RandomState(4).randn(*out.shape).astype(np.float32)
    want = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    stride, pad, dil = arrays["geometry"]
    args = _port_args(arrays)
    for a in args:
        if a is not None:
            a.requires_grad_(True)
    x, off, weight, bias, mask = args
    deform_conv2d(x, off, weight, bias, stride, pad, dil, mask).backward(_nchw(g))
    layouts = [(0, 2, 3, 1), (0, 2, 3, 1), (2, 3, 1, 0), None, (0, 2, 3, 1)]
    for name, a, w, perm in zip(("input", "offset", "weight", "bias", "mask"),
                                args, want, layouts):
        if a is None:
            continue
        got = a.grad.numpy()
        got = got.transpose(*perm) if perm else got
        assert np.abs(w).max() > 0, name
        _rel_close(got, w, 1e-5)


def test_the_function_gives_the_plain_op_gradients():
    """The op's ``autograd.Function`` (the columns saved, ``g_cols`` and the
    weight's gradient by ``torch.matmul``, the backward's plain version on
    the CPU) against autograd of the whole op in plain PyTorch."""
    arrays = _case(CASES[1], 5)
    stride, pad, dil = arrays["geometry"]
    a = [t.requires_grad_(True) if t is not None else None
         for t in _port_args(arrays)]
    b = [t.detach().clone().requires_grad_(True) if t is not None else None
         for t in a]
    g = torch.randn(1, 4, 5, 4, generator=torch.Generator().manual_seed(0))
    deform_conv2d(a[0], a[1], a[2], a[3], stride, pad, dil, a[4]).backward(g)
    deform_conv2d_plain(b[0], b[1], b[2], b[3], stride, pad, dil, b[4]).backward(g)
    for ta, tb in zip(a, b):
        if ta is not None:
            torch.testing.assert_close(ta.grad, tb.grad, rtol=1e-5, atol=1e-6)


def test_columns_are_laid_out_as_the_jax_columns():
    """``deform_im2col_plain`` is ``[N, OH, OW, K², C]``: at zero offsets,
    unit stride and no padding, column ``(tap i*kw + j, channel c)`` of
    output (oy, ox) is the input at (oy + i, ox + j) in channel c."""
    x = torch.randn(1, 3, 5, 6, generator=torch.Generator().manual_seed(1))
    off = torch.zeros(1, 2 * 6, 4, 4)
    cols = deform_im2col_plain(x, off, None, (2, 3))
    assert cols.shape == (1, 4, 4, 6, 3)
    for i in range(2):
        for j in range(3):
            torch.testing.assert_close(cols[0, :, :, i * 3 + j, :],
                                       x[0, :, i:i + 4, j:j + 4].permute(1, 2, 0),
                                       rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_path():
    """Forward and backward on CPU tensors, f32 and bf16: the plain
    versions, and no kernel launch."""
    counts = (deform_im2col_cuda.launches, deform_conv_backward_cuda.launches)
    arrays = _case(CASES[1], 6)
    stride, pad, dil = arrays["geometry"]
    for dtype in (torch.float32, torch.bfloat16):
        x, off, weight, bias, mask = _port_args(arrays, dtype)
        x.requires_grad_(True)
        out = deform_conv2d(x, off, weight, bias, stride, pad, dil, mask)
        assert out.dtype == dtype
        out.float().sum().backward()
        assert x.grad.dtype == dtype and x.grad.abs().sum() > 0
    assert counts == (deform_im2col_cuda.launches,
                      deform_conv_backward_cuda.launches)


def test_cuda_wrappers_refuse_what_they_do_not_take():
    x, off = torch.zeros(1, 2, 4, 4), torch.zeros(1, 18, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        deform_im2col_cuda(x, off, None, 3, 1, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        deform_conv_backward_cuda(x, off, None, torch.zeros(1, 4, 4, 9, 2), 3,
                                  1, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        deform_im2col_cuda(x.bfloat16(), off, None, 3, 1, 1, 1)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="f32 or bf16"):
            deform_im2col_cuda(x.to(dtype), off, None, 3, 1, 1, 1)
        with pytest.raises(ValueError, match="f32 or bf16"):
            deform_conv_backward_cuda(x.to(dtype), off, None,
                                      torch.zeros(1, 4, 4, 9, 2), 3, 1, 1, 1)
    with pytest.raises(ValueError, match="offset shape"):
        deform_conv2d(x, torch.zeros(1, 18, 3, 3), torch.zeros(2, 2, 3, 3),
                      padding=1)


# ---------------------------------------------------------------- the kernels' bookkeeping


def _pile_up(n=1, c=4, size=32, seed=0):
    """A 32x32 map whose every tap of every output position (3x3, stride 1,
    padding 1) samples within one pixel of the centre: one pixel's range
    of corners runs to thousands."""
    rng = np.random.RandomState(seed)
    base = np.arange(size)[None, :] - 1 + np.arange(3)[:, None]  # [3, OH]
    centre = (size - 1) / 2.0
    dy = centre - base[:, None, :, None] + rng.uniform(-1, 1, (3, 3, size, size))
    dx = centre - base[None, :, None, :] + rng.uniform(-1, 1, (3, 3, size, size))
    off = np.stack([dy, dx], 2).reshape(1, 18, size, size)
    off = np.repeat(off, n, 0).astype(np.float32)
    x = rng.randn(n, c, size, size)
    return torch.from_numpy(x), torch.from_numpy(off)


def _records_case(case, seed):
    """An f64 input, f32 offsets, an f64 mask (or None) and f64 g_cols of a
    ``CASES`` entry, NCHW, and its geometry."""
    arrays = _case(case, seed)
    stride, pad, dil = arrays["geometry"]
    x, off, weight, _, mask = _port_args(arrays)
    kernel = tuple(weight.shape[-2:])
    og = off.shape[1] // (2 * kernel[0] * kernel[1])
    g = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        x.shape[0], *off.shape[-2:], kernel[0] * kernel[1], x.shape[1]))
    return (x.double(), off, None if mask is None else mask.double(), g,
            (kernel, stride, pad, dil), og)


@pytest.mark.parametrize("case", CASES + ["pile-up"], ids=IDS + ["pile-up"])
def test_corner_records_sum_to_the_input_gradient(case):
    """The backward's records (a row and weight times mask a corner), put
    in sorted order and each pixel's range summed, in f64: the plain
    backward's input gradient within 1e-12."""
    if case == "pile-up":
        x, off = _pile_up(n=2)
        mask, og, geometry = None, 1, (3, 1, 1, 1)
        g = torch.from_numpy(np.random.RandomState(3).randn(2, 32, 32, 9, 4))
    else:
        x, off, mask, g, geometry, og = _records_case(case, 11)
    keys, rows, weights = deform_corner_records_plain(
        off, mask, *geometry, x.shape[-2:], dtype=torch.float64)
    got = deform_records_input_grad_plain(keys, rows, weights, g, x.shape, og)
    want = deform_conv_backward_plain(x, off, mask, g, *geometry)[0]
    assert got.dtype == torch.float64 and got.shape == x.shape
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    # the ranges the kernel walks: each pixel's count of corners
    buckets = x.shape[0] * og * x.shape[2] * x.shape[3]
    _, starts = sort_corners(keys, buckets)
    counts = torch.bincount(keys, minlength=buckets + 1)
    assert torch.equal(starts[1:].long() - starts[:-1].long(), counts[:-1])
    if case == "pile-up":
        counts = torch.bincount(keys)[:-1]
        assert int(counts.max()) > 1000, int(counts.max())


def test_corner_records_layout():
    """Corner ``t = 4 (((b og + g) K² + tap) L + pos) + k``: its key is the
    pixel it reads, or ``N og H W`` where invalid; its row the sample's
    g_cols row; its f32 weight the fractions' product times the mask, both
    0 where invalid."""
    x, off, mask, _, (kernel, stride, pad, dil), og = _records_case(CASES[1], 12)
    mask = mask.float()
    n, _, h, w = x.shape
    keys, rows, weights = deform_corner_records_plain(
        off, mask, kernel, stride, pad, dil, (h, w))
    assert keys.dtype == rows.dtype == torch.int64
    assert weights.dtype == torch.float32
    y, xs = sample_positions(off, kernel, stride, pad, dil)
    _, _, k2, oh, ow = y.shape
    assert keys.numel() == 4 * n * og * k2 * oh * ow
    none = n * og * h * w
    checked = 0
    for b, g, tap, oy, ox in np.ndindex(n, og, k2, oh, ow):
        s = ((b * og + g) * k2 + tap) * oh * ow + oy * ow + ox
        yy, xx = y[b, g, tap, oy, ox], xs[b, g, tap, oy, ox]
        inside = -1 < float(yy) < h and -1 < float(xx) < w
        yl, xl = torch.floor(yy), torch.floor(xx)
        ly, lx = yy - yl, xx - xl
        for k in range(4):
            cy, cx = int(yl) + (k >> 1), int(xl) + (k & 1)
            valid = inside and 0 <= cy < h and 0 <= cx < w
            t = 4 * s + k
            if not valid:
                assert (int(keys[t]), int(rows[t]), float(weights[t])) == (none, 0, 0.0)
                continue
            wt = ((1 - ly) if k < 2 else ly) * (lx if k & 1 else (1 - lx))
            assert int(keys[t]) == (b * og + g) * h * w + cy * w + cx
            assert int(rows[t]) == (b * oh * ow + oy * ow + ox) * k2 + tap
            assert torch.equal(weights[t], wt * mask[b, g * k2 + tap, oy, ox])
            checked += 1
    assert checked > 0 and int((keys == none).sum()) > 0


def test_sort_corners_gives_each_pixel_its_range():
    """The stable sort keeps a pixel's corners in corner order, and the
    starts bracket each pixel's range, the invalid corners last."""
    keys = torch.tensor([3, 1, 5, 3, 0, 5, 1, 3], dtype=torch.int32)  # 5: invalid
    order, starts = sort_corners(keys, 5)
    assert order.tolist() == [4, 1, 6, 0, 3, 7, 2, 5]
    assert starts.dtype == torch.int32
    assert starts.tolist() == [0, 1, 3, 3, 6, 6]


def _staged_columns(x, off, mask, geometry, plan):
    """The columns as the forward kernel forms them under ``plan``: each
    corner's value read from its tile's staged window (decoded back to the
    map's pixel, which must lie inside the map), from the window's zero
    pixel, or from the map; the four summed in the plain version's order,
    times the mask."""
    kernel, stride, pad, dil = geometry
    n, c, h, w = x.shape
    codes = deform_tile_codes_plain(off, kernel, stride, pad, dil, (h, w), plan)
    _, og, k2, oh, ow, _ = codes.shape
    cg = c // og
    zero_pixel = plan.wr * plan.wc
    wy0 = ((torch.arange(oh) // plan.th) * plan.th * stride - pad
           - plan.margin)[:, None]
    wx0 = ((torch.arange(ow) // plan.tw) * plan.tw * stride - pad
           - plan.margin)[None, :]
    y, xs = sample_positions(off, kernel, stride, pad, dil)
    ly, lx = y - torch.floor(y), xs - torch.floor(xs)
    inside = (y > -1) & (y < h) & (xs > -1) & (xs < w)
    hy, hx = 1.0 - ly, 1.0 - lx
    zero = torch.zeros(())
    fr = [torch.where(inside, t, zero) for t in (hy, ly, hx, lx)]
    weights = (fr[0] * fr[2], fr[0] * fr[3], fr[1] * fr[2], fr[1] * fr[3])
    planes = x.reshape(n, og, cg, h * w)
    values = []
    for k in range(4):
        code = codes[..., k]
        staged = (code >= 0) & (code < zero_pixel)
        r = code.clamp(min=0) // max(plan.wc, 1)
        cc = code.clamp(min=0) % max(plan.wc, 1)
        pix = torch.where(staged, (wy0 + r) * w + (wx0 + cc), -1 - code)
        assert bool(((wy0 + r)[staged] >= 0).all() & ((wy0 + r)[staged] < h).all())
        assert bool(((wx0 + cc)[staged] >= 0).all() & ((wx0 + cc)[staged] < w).all())
        pix = torch.where(code == zero_pixel, torch.zeros_like(pix), pix)
        v = torch.gather(planes, 3, pix.reshape(n, og, 1, -1).expand(-1, -1, cg, -1))
        v = v.reshape(n, og, cg, k2, oh, ow).permute(0, 1, 3, 4, 5, 2)
        values.append(torch.where((code == zero_pixel)[..., None], zero, v))
    cols = weights[0][..., None] * values[0]
    for k in range(1, 4):
        cols = cols + weights[k][..., None] * values[k]
    if mask is not None:
        cols = cols * mask.reshape(n, og, k2, oh, ow)[..., None]
    return cols.permute(0, 3, 4, 2, 1, 5).reshape(n, oh, ow, k2, c), codes


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tile_windows_give_the_plain_columns(case):
    """The forward's tiles: with offsets of RMS 3 px (some beyond the
    margin) and a few sent outside the map, each corner decoded from its
    tile's window, or read from the map, gives the plain columns' bits;
    the same with no window at all (every corner from the map)."""
    arrays = _case(case, 13)
    arrays["off"] = arrays["off"] * 2.0
    stride, pad, dil = (v[0] for v in arrays["geometry"])
    x, off, weight, _, mask = _port_args(arrays)
    kernel = tuple(weight.shape[-2:])
    n, c = x.shape[:2]
    og = off.shape[1] // (2 * kernel[0] * kernel[1])
    plan = tile_plan("forward", n, c, og, off.shape[-2:], kernel, stride, dil)
    assert plan.margin == MARGIN and plan.smem <= SMEM_LIMIT
    want = deform_im2col_plain(x, off, mask, kernel, stride, pad, dil)
    geometry = (kernel, stride, pad, dil)
    got, codes = _staged_columns(x, off, mask, geometry, plan)
    assert torch.equal(got, want)
    zero_pixel = plan.wr * plan.wc
    assert bool(((codes >= 0) & (codes < zero_pixel)).any())
    assert bool((codes == zero_pixel).any())
    empty = plan._replace(margin=0, wr=0, wc=0)
    got, codes = _staged_columns(x, off, mask, geometry, empty)
    assert torch.equal(got, want) and not bool((codes > 0).any())


def test_tile_windows_cover_offsets_within_the_margin():
    """Every valid corner of a sample whose offsets lie within ``MARGIN``
    px is staged (forward and backward tiles, stride 1 and 2, at the
    model's C3 widths); beyond it some are read from the map."""
    rng = np.random.RandomState(14)
    for stride, size in ((1, 40), (2, 80)):
        oh = (size + 2 - 3) // stride + 1
        x = torch.randn(1, 4, size, size)
        for spread, staged_all in ((MARGIN - 1e-3, True), (3.0 * MARGIN, False)):
            off = torch.from_numpy(rng.uniform(-spread, spread, (1, 18, oh, oh))
                                   .astype(np.float32))
            for kind in ("forward", "backward"):
                plan = tile_plan(kind, 1, 128, 1, (oh, oh), 3, stride, 1)
                codes = deform_tile_codes_plain(off, 3, stride, 1, 1, (size, size), plan)
                assert bool((codes < 0).any()) != staged_all, (kind, stride)
                assert bool(((codes >= 0) & (codes < plan.wr * plan.wc)).any())


def test_tile_plan_fits_shared_memory():
    """The model's shapes keep the full margin in both tiles; the forward
    splits the channels where its tiles alone would not fill the card; a
    window too large for shared memory shrinks its margin, and then goes,
    and a kernel whose records do not fit at all is refused."""
    # a 4 x 8 tile of a 3x3 kernel: (th - 1) s + 2 + 2 margin + 1 rows,
    # (tw - 1) s + 2 + 2 margin + 1 columns
    c3 = tile_plan("forward", 2, 128, 1, (168, 168), 3, 1, 1)
    assert (c3.th, c3.tw, c3.margin, c3.wr, c3.wc, c3.splits) == (
        4, 8, MARGIN, 6 + 2 * MARGIN, 10 + 2 * MARGIN, 1)
    # C5's 132 tiles a call split into 8 (the 16 chunks of 512 channels)
    c5 = tile_plan("forward", 2, 512, 1, (42, 42), 3, 1, 1)
    assert c5.splits == 8
    back = tile_plan("backward", 2, 256, 1, (84, 84), 3, 2, 1)
    assert (back.th, back.tw, back.margin, back.wr, back.wc) == (
        4, 8, MARGIN, 9 + 2 * MARGIN, 17 + 2 * MARGIN)
    # the backward's blocks are twice as wide: C4's 462 split in 2
    assert tile_plan("backward", 2, 256, 1, (84, 84), 3, 1, 1).splits == 2
    assert tile_plan("backward", 2, 128, 1, (168, 168), 3, 1, 1).splits == 1
    for kind in ("forward", "backward"):
        for dil, margin in ((1, MARGIN), (40, 0)):
            plan = tile_plan(kind, 1, 64, 1, (32, 32), 3, 1, dil)
            assert plan.smem <= SMEM_LIMIT and plan.margin <= margin
        wide = tile_plan(kind, 1, 64, 1, (32, 32), 7, 1, 60)
        assert (wide.margin, wide.wr, wide.wc) == (0, 0, 0)
    big = tile_plan("forward", 1, 8, 1, (8, 8), 41, 1, 1)
    assert big.th * big.tw < 32 and big.smem <= SMEM_LIMIT
    with pytest.raises(ValueError, match="do not fit"):
        tile_plan("forward", 1, 8, 1, (8, 8), 80, 1, 1)
    with pytest.raises(ValueError, match="kind"):
        tile_plan("sideways", 1, 8, 1, (8, 8), 3, 1, 1)


# ---------------------------------------------------------------- block


def _block_variables(module, x, seed, offset_scale):
    """Seeded variables of a JAX block: conv kernels N(0, 1/fan_in), the
    offset predictor's kernel scaled by ``offset_scale`` and its bias
    N(0, 0.1), frozen batch norms near the identity."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict(jax.tree_util.tree_map(
        lambda s: s, shapes))
    out = {}
    for path, s in flat.items():
        if path[-1] == "kernel":
            v = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
            if "conv2_offset" in path:
                v *= offset_scale
        elif path[-1] == "running_var":
            v = 0.5 + rng.rand(*s.shape)
        elif path[-1] == "weight":
            v = 1.0 + 0.1 * rng.randn(*s.shape)
        else:
            v = 0.1 * rng.randn(*s.shape)
        out[path] = v.astype(np.float32)
    return flax.traverse_util.unflatten_dict(out)


@pytest.mark.parametrize("stride,modulated", [(1, False), (2, False), (1, True),
                                              (2, True)])
def test_deform_bottleneck_matches_jax(stride, modulated):
    """``DeformFrozenBottleneck`` (256 -> 64 -> 256 channels, a downsample,
    a 12x12 map) with offset predictors that give offsets of RMS ~1-2 px:
    output and the gradients of the input, ``conv2_offset``, ``conv2`` and
    ``conv1`` against ``jax.vjp`` of ``_DeformFrozenBottleneck``."""
    x = np.random.RandomState(10 + stride).randn(2, 12, 12, 256).astype(np.float32)
    jm = _DeformFrozenBottleneck(planes=64, stride=stride, downsample=True,
                                 modulated=modulated)
    variables = _block_variables(jm, jnp.asarray(x), 20 + stride, 1.5)
    port = DeformFrozenBottleneck(256, 64, stride, True, modulated)
    load_jax_variables(port, variables)

    def fn(params, x):
        return jm.apply({**variables, "params": params}, x)

    out, vjp = jax.vjp(fn, variables["params"], jnp.asarray(x))
    g = np.random.RandomState(30).randn(*out.shape).astype(np.float32)
    grads, gx = vjp(jnp.asarray(g))
    xt = _nchw(x).requires_grad_(True)
    got = port(xt)
    _rel_close(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(out), 1e-5)
    got.backward(_nchw(g))
    _rel_close(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx), 1e-4)
    want = {_torch_name("params", p): np.asarray(v)
            for p, v in _leaves(jax.tree_util.tree_map(np.asarray, grads))}
    named = dict(port.named_parameters())
    for name in ("conv2_offset.weight", "conv2_offset.bias", "conv2.weight",
                 "conv1.weight"):
        w = _to_torch_layout(name, want[name], named[name], port)
        _rel_close(named[name].grad.numpy(), w, 1e-4)
    # the offsets are real: RMS ~1-2 px, some samples outside the map
    with torch.no_grad():
        pred = port.conv2_offset(torch.relu(port.bn1(port.conv1(_nchw(x)))))
    rms = float(pred[:, :18].pow(2).mean().sqrt())
    assert 0.5 < rms < 4.0, rms


def _copy_shared(plain: torch.nn.Module, deform: torch.nn.Module) -> None:
    sd = plain.state_dict()
    missing, unexpected = deform.load_state_dict(sd, strict=False)
    assert not unexpected and all("conv2_offset" in k for k in missing)
    with torch.no_grad():
        deform.conv2_offset.weight.zero_()
        deform.conv2_offset.bias.zero_()


def test_deform_bottleneck_equals_plain_at_zero_offsets():
    """Zero-initialised offset predictors: the block is ``FrozenBottleneck``
    with the same weights (integer sample positions, each column the input
    pixel itself), within 1e-5 of the largest value."""
    torch.manual_seed(0)
    plain = FrozenBottleneck(256, 64, 2, True)
    deform = DeformFrozenBottleneck(256, 64, 2, True)
    _copy_shared(plain, deform)
    x = torch.randn(1, 256, 16, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, got = plain(x), deform(x)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_dcnv2_block_halves_its_branch_at_init():
    """DCNv2 at zero init: the mask is sigmoid(0) = 1/2 everywhere, so the
    block is the plain one with its conv2 weight halved (and differs from
    the plain one with the full weight)."""
    torch.manual_seed(0)
    plain = FrozenBottleneck(256, 64, 1, True)
    deform = DeformFrozenBottleneck(256, 64, 1, True, modulated=True)
    _copy_shared(plain, deform)
    x = torch.randn(1, 256, 8, 8, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        full = plain(x)
        plain.conv2.weight.mul_(0.5)
        half, got = plain(x), deform(x)
    tol = 1e-5 * float(half.abs().max())
    torch.testing.assert_close(got, half, rtol=0, atol=tol)
    assert float((got - full).abs().max()) > 100 * tol


def test_trunk_deform_stages():
    """``deform_stages=(2, 3, 4)`` makes the 13 bottlenecks of C3-C5
    deformable; a BasicBlock trunk refuses it, as the JAX trunk does."""
    trunk = ResNetTrunk(50, deform_stages=(2, 3, 4))
    blocks = [m for m in trunk.modules() if isinstance(m, DeformFrozenBottleneck)]
    assert len(blocks) == 13
    assert not any(isinstance(m, DeformFrozenBottleneck) for m in trunk.layer1.modules())
    assert isinstance(trunk.layer2[0].conv2, DeformConv2d)
    assert trunk.layer2[0].conv2_offset.stride == (2, 2)
    with pytest.raises(ValueError, match="Bottleneck"):
        ResNetTrunk(18, deform_stages=(2,))
