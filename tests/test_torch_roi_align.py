"""RoIAlign parity: the port's ``roi_align`` (plain PyTorch path on the CPU,
NCHW) against the JAX package's Pallas kernel in interpret mode and its
gather path, which ``vision_tpu.ops.roi_align.roi_align`` runs off the
TPU (NHWC). Tolerance 2e-5 absolute on inputs in [0, 1): the
formulations sum the same samples in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.ops._pallas.roi_align import roi_align_pallas
from vision_tpu.ops.roi_align import _roi_align_gather
from vision_tpu.ops.roi_align import roi_align as jax_roi_align
from vision_tpu_torch.ops.roi_align import roi_align

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
