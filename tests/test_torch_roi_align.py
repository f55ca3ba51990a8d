"""RoIAlign parity: the port's ``roi_align`` (plain PyTorch path on the CPU,
NCHW) against the JAX package's Pallas kernel in interpret mode and its
gather path, which ``vision_tpu.ops.roi_align.roi_align`` runs off the
TPU (NHWC); and its backward pass in the input against the JAX VJPs.
Tolerance 2e-5 absolute on inputs in [0, 1): the formulations sum the
same samples in different orders; gradients within 1e-5 of their largest
value; ``gradcheck`` in float64 at its defaults."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.ops._pallas.roi_align import roi_align_pallas
from vision_tpu.ops.roi_align import _roi_align_gather, roi_align_mxu
from vision_tpu.ops.roi_align import roi_align as jax_roi_align
from vision_tpu_torch.ops.roi_align import roi_align, roi_align_backward_plain
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

ATOL = 2e-5


def _rois(rng, k, n_images, lo=-5.0, hi=35.0):
    xy = rng.uniform(lo, hi, (k, 2)).astype(np.float32)
    wh = np.abs(rng.uniform(lo, hi, (k, 2))).astype(np.float32)
    b = rng.randint(0, n_images, (k, 1)).astype(np.float32)
    return np.concatenate([b, xy, xy + wh], 1)


def _port(feat_nhwc, rois, size, scale, sr, aligned):
    out = roi_align(torch.from_numpy(feat_nhwc).permute(0, 3, 1, 2),
                    torch.from_numpy(rois), size, scale, sr, aligned)
    return out.permute(0, 2, 3, 1).numpy()  # -> [K, PH, PW, C]


@pytest.mark.parametrize("aligned", [False, True])
def test_batched_matches_pallas_interpret_and_gather(aligned):
    rng = np.random.RandomState(0)
    feat = rng.rand(2, 25, 31, 8).astype(np.float32)
    rois = _rois(rng, 40, 2)
    got = _port(feat, rois, (7, 7), 0.5, 2, aligned)
    kernel = np.asarray(roi_align_pallas(jnp.asarray(feat), jnp.asarray(rois),
                                         (7, 7), 0.5, 2, aligned,
                                         interpret=True))
    gather = np.asarray(jax_roi_align(jnp.asarray(feat), jnp.asarray(rois),
                                      (7, 7), 0.5, 2, aligned))
    np.testing.assert_allclose(got, kernel, atol=ATOL)
    np.testing.assert_allclose(got, gather, atol=ATOL)


def test_rect_pool_matches_gather():
    rng = np.random.RandomState(2)
    feat = rng.rand(1, 50, 64, 16).astype(np.float32)
    rois = _rois(rng, 5, 1, 0.0, 150.0)
    got = _port(feat, rois, (14, 7), 0.25, 2, True)
    want = np.asarray(_roi_align_gather(jnp.asarray(feat), jnp.asarray(rois),
                                        (14, 7), 0.25, 2, True))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("sr", [0, -1])
@pytest.mark.parametrize("aligned", [False, True])
def test_adaptive_grid_matches_gather(sr, aligned):
    rng = np.random.RandomState(3)
    feat = rng.rand(2, 20, 24, 4).astype(np.float32)
    rois = _rois(rng, 12, 2, -5.0, 60.0)
    got = _port(feat, rois, (3, 4), 0.5, sr, aligned)
    want = np.asarray(_roi_align_gather(jnp.asarray(feat), jnp.asarray(rois),
                                        (3, 4), 0.5, sr, aligned))
    np.testing.assert_allclose(got, want, atol=ATOL)


def _samples(s0, s1, grid, start, bin_, step, size):
    """Samples s0 .. s1-1 of one axis (sample s: bin s // grid, point
    s % grid) as the kernel stages them: low and high corner lines and
    weights, weights 0 outside [-1, size], and each sample's bin. The
    positions are the plain version's float32 expressions."""
    s = torch.arange(s0, s1)
    p, i = s // grid, s % grid
    x = start + p.float() * bin_
    x = x + (i.float() + 0.5) * step
    ok = ~((x < -1.0) | (x > size))
    x = x.clamp(min=0.0)
    lo = x.to(torch.int64)
    edge = lo >= size - 1
    hi = torch.where(edge, size - 1, lo + 1)
    lo = lo.clamp(max=size - 1)
    x = torch.where(edge, lo.float(), x)
    frac = x - lo
    return lo, hi, torch.where(ok, 1.0 - frac, 0.0), torch.where(ok, frac, 0.0), p


def _roi_align_row_column(input, rois, size, scale, sr, aligned, chunk):
    """A PyTorch model of ``csrc/roi_align.cu`` (NCHW). Per RoI, the sample
    weights of each axis are staged ``chunk`` samples at a time (the
    kernel: 256; a smaller chunk carries the sums across chunks, as large
    adaptive grids do); per output, the columns' corners of its bin are
    contracted with w_x first, then the rows' with w_y. The same chunk is
    also contracted in the dense form of the JAX kernel, rows = w_y @ V,
    out += rows @ w_x^T, over the distinct rows and columns it touches
    with their summed weights; the two must agree. Returns both and the
    number of chunk pairs."""
    ph, pw = size
    k, c, h, w = rois.shape[0], input.shape[1], input.shape[2], input.shape[3]
    out = torch.zeros(k, c, ph, pw)
    dense = torch.zeros(k, c, ph, pw)
    pairs = 0
    for r in range(k):
        roi = rois[r]
        b = int(roi[0])
        off = 0.5 if aligned else 0.0
        sw, sh = roi[1] * scale - off, roi[2] * scale - off
        rw, rh = roi[3] * scale - off - sw, roi[4] * scale - off - sh
        if not aligned:
            rw, rh = rw.clamp(min=1.0), rh.clamp(min=1.0)
        bh, bw = rh / ph, rw / pw
        gh = sr if sr > 0 else int(torch.ceil(rh / ph))
        gw = sr if sr > 0 else int(torch.ceil(rw / pw))
        count = max(float(gh * gw), 1.0)
        ny, nx = ph * max(gh, 0), pw * max(gw, 0)
        feat = input[b]
        for y0 in range(0, ny, chunk):
            ylo, yhi, wylo, wyhi, py = _samples(y0, min(y0 + chunk, ny), gh, sh,
                                                 bh, bh / gh, h)
            for x0 in range(0, nx, chunk):
                xlo, xhi, wxlo, wxhi, qx = _samples(x0, min(x0 + chunk, nx), gw,
                                                     sw, bw, bw / gw, w)
                pairs += 1
                # per output: w_x over its columns' corners, then w_y
                for rr, wr in ((ylo, wylo), (yhi, wyhi)):
                    v = feat[:, rr][:, :, xlo] * wxlo + feat[:, rr][:, :, xhi] * wxhi
                    t = v * wr[None, :, None]  # [C, y samples, x samples]
                    by_q = torch.zeros(c, t.shape[1], pw).index_add_(2, qx, t)
                    out[r] += torch.zeros(c, ph, pw).index_add_(1, py, by_q)
                # dense: distinct lines with summed weights
                rows = torch.unique(torch.cat([ylo, yhi]))
                cols = torch.unique(torch.cat([xlo, xhi]))
                wy = torch.zeros(ph, rows.numel())
                wx = torch.zeros(pw, cols.numel())
                for lines, wgt, bins, mat, tab in (
                        ((ylo, yhi), (wylo, wyhi), py, wy, rows),
                        ((xlo, xhi), (wxlo, wxhi), qx, wx, cols)):
                    for ln, wt in zip(lines, wgt):
                        mat.index_put_((bins, torch.searchsorted(tab, ln)), wt,
                                       accumulate=True)
                dense[r] += wy @ feat[:, rows][:, :, cols] @ wx.T
        out[r] /= count
        dense[r] /= count
    return out, dense, pairs


@pytest.mark.parametrize("kind", ["partly_outside", "sub_pixel"])
@pytest.mark.parametrize("sr,size", [(2, (7, 5)), (9, (2, 3)), (0, (3, 4))])
@pytest.mark.parametrize("aligned", [False, True])
def test_row_column_form_matches_plain_and_jax(aligned, sr, size, kind):
    """The kernel's decomposition, modelled in PyTorch with the kernel's
    chunk of 256 samples and with chunks of 5 (sums carried across chunks),
    against the port's plain version and the JAX package (its Pallas
    kernel in interpret mode for a fixed grid, its gather path for the
    adaptive one): within 1e-5 of the largest value. RoIs reach 5 px past
    the map's top-left corner, or are narrower than a feature pixel."""
    rng = np.random.RandomState(10 + sr + aligned)
    feat = rng.rand(2, 40, 48, 4).astype(np.float32)
    rois = _rois(rng, 12, 2, -5.0, 60.0)
    if kind == "sub_pixel":
        rois[:, 3:] = rois[:, 1:3] + rng.uniform(0, 1.6, (12, 2)).astype(np.float32)
    nchw = torch.from_numpy(feat).permute(0, 3, 1, 2).contiguous()
    want = roi_align(nchw, torch.from_numpy(rois), size, 0.5, sr, aligned)
    scale = float(want.abs().max())
    assert scale > 0
    if sr > 0:
        jax_out = roi_align_pallas(jnp.asarray(feat), jnp.asarray(rois), size,
                                   0.5, sr, aligned, interpret=True)
    else:
        jax_out = _roi_align_gather(jnp.asarray(feat), jnp.asarray(rois), size,
                                    0.5, sr, aligned)
    jax_nchw = torch.from_numpy(np.array(jax_out)).permute(0, 3, 1, 2)
    for chunk in (256, 5):
        got, dense, pairs = _roi_align_row_column(
            nchw, torch.from_numpy(rois), size, 0.5, sr, aligned, chunk)
        for form in (got, dense):
            torch.testing.assert_close(form, want, atol=1e-5 * scale, rtol=0)
            torch.testing.assert_close(form, jax_nchw, atol=1e-5 * scale, rtol=0)
        if chunk == 256:
            assert pairs <= 12  # one chunk pair a RoI at most
        elif kind == "partly_outside":
            assert pairs > 12  # sums carried across chunks


def _jax_grad(fn, feat, rois, g, *args):
    _, vjp = jax.vjp(lambda f: fn(f, jnp.asarray(rois), *args), jnp.asarray(feat))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _backward_case(rng, size=(7, 5)):
    feat = rng.rand(2, 20, 24, 3).astype(np.float32)
    rois = _rois(rng, 16, 2, -5.0, 60.0)
    g = rng.randn(16, *size, 3).astype(np.float32)
    return feat, rois, g


def _scaled_close(got, want, rel=1e-5):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("sr", [2, 0])
@pytest.mark.parametrize("aligned", [False, True])
def test_backward_plain_matches_jax_vjp(sr, aligned):
    """Against ``jax.vjp`` of ``vision_tpu.ops.roi_align.roi_align`` (the
    gather path off the TPU), at a fixed grid and the adaptive one."""
    feat, rois, g = _backward_case(np.random.RandomState(30 + sr + aligned))
    want = _jax_grad(jax_roi_align, feat, rois, g, (7, 5), 0.5, sr, aligned)
    got = roi_align_backward_plain(
        torch.from_numpy(g).permute(0, 3, 1, 2), torch.from_numpy(rois),
        (2, 3, 20, 24), (7, 5), 0.5, sr, aligned)
    assert got.shape == (2, 3, 20, 24) and got.dtype == torch.float32
    _scaled_close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("aligned", [False, True])
def test_autograd_matches_jax_mxu_vjp(aligned):
    """``roi_align`` differentiated by autograd on the CPU against the VJP of
    the JAX package's ``roi_align_mxu`` (its TPU backward) at sr = 2."""
    feat, rois, g = _backward_case(np.random.RandomState(40 + aligned))
    want = _jax_grad(roi_align_mxu, feat, rois, g, (7, 5), 0.5, 2, aligned,
                     "highest")
    x = torch.from_numpy(feat).permute(0, 3, 1, 2).requires_grad_()
    b = torch.from_numpy(rois).requires_grad_()
    roi_align(x, b, (7, 5), 0.5, 2, aligned).backward(
        torch.from_numpy(g).permute(0, 3, 1, 2))
    _scaled_close(x.grad.permute(0, 2, 3, 1).numpy(), want)
    assert b.grad is None  # torchvision's contract; JAX returns zeros


@pytest.mark.parametrize("aligned", [False, True])
def test_backward_bf16_matches_jax_mxu_vjp(aligned):
    """A bf16 input and output gradient at sr = 2: the port's gradient (the
    plain version's f32 sum rounded once to bf16, as ``_RoIAlign.backward``
    casts it) against ``jax.vjp`` of ``roi_align_mxu`` on the same bf16
    values, which also sums in f32 and rounds once: within one bf16 step of
    each element (2**-7 of its magnitude: f32 sums in another order may
    round to the neighbouring value) plus 1e-5 of the largest value."""
    feat, rois, g = _backward_case(np.random.RandomState(44 + aligned))
    x16 = torch.from_numpy(feat).permute(0, 3, 1, 2).bfloat16()
    g16 = torch.from_numpy(g).permute(0, 3, 1, 2).bfloat16()
    want = _jax_grad(roi_align_mxu, x16.float().permute(0, 2, 3, 1).numpy()
                     .astype(jnp.bfloat16), rois,
                     g16.float().permute(0, 2, 3, 1).numpy().astype(jnp.bfloat16),
                     (7, 5), 0.5, 2, aligned).astype(np.float32)
    x = x16.clone().requires_grad_()
    roi_align(x, torch.from_numpy(rois), (7, 5), 0.5, 2, aligned).backward(g16)
    assert x.grad.dtype == torch.bfloat16
    plain = roi_align_backward_plain(g16, torch.from_numpy(rois), tuple(x.shape),
                                     (7, 5), 0.5, 2, aligned)
    assert plain.dtype == torch.float32
    assert torch.equal(x.grad, plain.bfloat16())
    got = x.grad.float().permute(0, 2, 3, 1).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("sr", [2, 0])
@pytest.mark.parametrize("aligned", [False, True])
def test_gradcheck_float64(sr, aligned):
    rng = np.random.RandomState(50 + sr + aligned)
    feat = torch.from_numpy(rng.rand(2, 2, 9, 11)).requires_grad_()
    rois = torch.from_numpy(_rois(rng, 4, 2, -2.0, 14.0))
    assert torch.autograd.gradcheck(
        lambda f: roi_align(f, rois, (3, 2), 0.7, sr, aligned), (feat,))


def test_saves_nothing_without_grad():
    feat = torch.rand(1, 2, 8, 8, requires_grad=True)
    rois = torch.tensor([[0.0, 1.0, 1.0, 6.0, 6.0]])
    with torch.no_grad():
        assert roi_align(feat, rois, 2, 1.0, 2).grad_fn is None
    assert roi_align(feat.detach(), rois, 2, 1.0, 2).grad_fn is None
