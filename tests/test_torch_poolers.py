"""Pooler parity: the port's window pool (plain PyTorch path on the CPU)
against the JAX package's Pallas window-pool kernel in interpret mode, and
the port's ``MultiScaleRoIAlign`` (window backend, overflowing RoIs
included, and dense backend) against JAX's ``backend="dense"``; and their
backward passes in the features against the JAX VJPs.
Tolerances: 2e-4 for the window contraction of random weights (the
Pallas test's own), 2e-5 for pooling features in [0, 1); gradients within
1e-5 of their largest value (sums in another order); ``gradcheck`` in
float64 at its defaults."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.ops._pallas.window_pool import window_pool_pallas
from vision_tpu.ops.poolers import MultiScaleRoIAlign as JaxPooler
from vision_tpu.ops.poolers import _window_pool_xla
from vision_tpu_torch.ops.poolers import (
    MultiScaleRoIAlign,
    window_pool,
    window_pool_backward_plain,
)


def test_window_pool_matches_pallas_interpret():
    """The tiny config of tests/test_window_pool_pallas.py."""
    rng = np.random.RandomState(0)
    k, ph, pw, winy, winx, r_rows, wmax, c = 5, 2, 3, 16, 8, 48, 16, 128
    stacked = rng.randn(r_rows, wmax, c).astype(np.float32)
    row0 = (rng.randint(0, (r_rows - winy) // 8, k) * 8).astype(np.int32)
    x0 = rng.randint(0, wmax - winx + 1, k).astype(np.int32)
    w_y = rng.rand(k, ph, winy).astype(np.float32)
    w_x = rng.rand(k, pw, winx).astype(np.float32)
    got = window_pool(*map(torch.from_numpy, (stacked, row0, x0, w_y, w_x)))
    want = np.asarray(window_pool_pallas(
        *map(jnp.asarray, (stacked, row0, x0, w_y, w_x)), interpret=True))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=2e-4, rtol=2e-4)


def test_window_pool_rejects_windows_outside_the_pyramid():
    stacked = torch.zeros(20, 10, 4)
    w_y = torch.ones(1, 2, 8)
    w_x = torch.ones(1, 2, 8)
    with pytest.raises(ValueError, match="leaves the pyramid"):
        window_pool(stacked, torch.tensor([13]), torch.tensor([0]), w_y, w_x)
    with pytest.raises(ValueError, match="leaves the pyramid"):
        window_pool(stacked, torch.tensor([0]), torch.tensor([3]), w_y, w_x)


def _pyramid(rng, n, c, size=128):
    names = ["0", "1", "2", "3"]
    feats = {
        name: rng.rand(n, size // 2 ** (i + 2), size // 2 ** (i + 2), c)
        .astype(np.float32)
        for i, name in enumerate(names)
    }
    return names, feats


def _rois(rng, k, n, size=128):
    xy = rng.uniform(-4, size - 8, (k, 2))
    wh = rng.uniform(4, size * 0.7, (k, 2))
    wh[: k // 4, 0] *= 0.1  # thin boxes: samples spread past small windows
    b = rng.randint(0, n, (k, 1))
    return np.concatenate([b, xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("window", [32, 6])
def test_multiscale_window_matches_jax_dense(window):
    """window=6 makes many RoIs overflow; with the capacity above their
    count every one is recomputed densely, so the result equals dense."""
    rng = np.random.RandomState(window)
    names, feats = _pyramid(rng, 2, 8)
    rois = _rois(rng, 40, 2)
    want = np.asarray(JaxPooler(names, 7, 2, backend="dense")(
        {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(rois),
        (128, 128)))
    pooler = MultiScaleRoIAlign(names, 7, 2, window=window,
                                overflow_capacity=40)
    tfeats = {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()}
    got = pooler(tfeats, torch.from_numpy(rois), (128, 128))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=2e-5)
    dense = MultiScaleRoIAlign(names, 7, 2, backend="dense")(
        tfeats, torch.from_numpy(rois), (128, 128))
    np.testing.assert_allclose(dense.permute(0, 2, 3, 1).numpy(), want,
                               atol=2e-5)


def _scaled_close(got, want, rel=1e-5):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale)


def _overlapping_windows(rng, k=12, ph=7, pw=7, winy=16, winx=12, r_rows=60,
                         wmax=30, c=5):
    """Windows that overlap (several at one origin), weights zero outside a
    range, a seeded output gradient."""
    stacked = rng.randn(r_rows, wmax, c).astype(np.float32)
    row0 = rng.randint(0, r_rows - winy + 1, k).astype(np.int32)
    x0 = rng.randint(0, wmax - winx + 1, k).astype(np.int32)
    row0[:3], x0[:3] = row0[3], x0[3]
    w_y = rng.rand(k, ph, winy).astype(np.float32)
    w_x = rng.rand(k, pw, winx).astype(np.float32)
    w_y[:, :, winy - 4:] = 0.0
    w_x[:, :, :2] = 0.0
    g = rng.randn(k, c, ph, pw).astype(np.float32)
    return stacked, row0, x0, w_y, w_x, g


def test_window_pool_backward_plain_matches_jax_vjp():
    """The gradient in the pyramid against ``jax.vjp`` of the JAX package's
    ``_window_pool_xla`` (which does not divide: div = 1)."""
    stacked, row0, x0, w_y, w_x, g = _overlapping_windows(np.random.RandomState(7))
    _, vjp = jax.vjp(lambda s: _window_pool_xla(s, jnp.asarray(row0),
                                                jnp.asarray(x0), jnp.asarray(w_y),
                                                jnp.asarray(w_x)),
                     jnp.asarray(stacked))
    (want,) = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))
    got = window_pool_backward_plain(
        *map(torch.from_numpy, (g, row0, x0, w_y, w_x)), stacked.shape[:2])
    assert got.shape == stacked.shape and got.dtype == torch.float32
    _scaled_close(got.numpy(), want)


def test_window_pool_autograd_matches_jax_vjp_with_div():
    """``window_pool`` differentiated by autograd on the CPU: the VJP of
    ``_window_pool_xla`` / div."""
    stacked, row0, x0, w_y, w_x, g = _overlapping_windows(np.random.RandomState(8))
    _, vjp = jax.vjp(lambda s: _window_pool_xla(s, jnp.asarray(row0),
                                                jnp.asarray(x0), jnp.asarray(w_y),
                                                jnp.asarray(w_x)) / 4.0,
                     jnp.asarray(stacked))
    (want,) = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))
    st = torch.from_numpy(stacked).requires_grad_()
    out = window_pool(st, *map(torch.from_numpy, (row0, x0, w_y, w_x)), 4.0)
    out.backward(torch.from_numpy(g))
    _scaled_close(st.grad.numpy(), want)


def test_window_pool_gradcheck_float64():
    rng = np.random.RandomState(9)
    stacked, row0, x0, w_y, w_x, _ = _overlapping_windows(
        rng, k=4, ph=2, pw=3, winy=5, winx=4, r_rows=12, wmax=9, c=2)
    st = torch.from_numpy(stacked).double().requires_grad_()
    wy, wx = (torch.from_numpy(w).double() for w in (w_y, w_x))
    r0, c0 = torch.from_numpy(row0), torch.from_numpy(x0)
    assert torch.autograd.gradcheck(
        lambda s: window_pool(s, r0, c0, wy, wx, 4.0), (st,))


def test_window_pool_refuses_a_gradient_of_the_weights():
    st = torch.rand(8, 8, 3, requires_grad=True)
    w_y = torch.rand(1, 2, 4, requires_grad=True)
    out = window_pool(st, torch.tensor([0]), torch.tensor([0]), w_y,
                      torch.rand(1, 2, 4))
    with pytest.raises(NotImplementedError, match="w_y or w_x"):
        out.sum().backward()


def test_window_pool_saves_nothing_without_grad():
    st = torch.rand(8, 8, 3, requires_grad=True)
    args = (torch.tensor([0]), torch.tensor([0]), torch.rand(1, 2, 4),
            torch.rand(1, 2, 4))
    with torch.no_grad():
        assert window_pool(st, *args).grad_fn is None
    assert window_pool(st.detach(), *args).grad_fn is None
    assert window_pool(st, *args).grad_fn is not None


@pytest.mark.parametrize("window", [32, 6])
def test_multiscale_gradient_matches_jax_dense(window):
    """The gradient of each FPN level through the port's pooler (the
    pyramid built by in-place copies, overflow rows patched in place;
    window=6 makes many RoIs overflow into the dense recompute) against the
    VJP of JAX's ``backend="dense"`` pooler, on a 512 canvas whose RoIs
    reach every level."""
    rng = np.random.RandomState(20 + window)
    names, feats = _pyramid(rng, 2, 4, size=512)
    rois = _rois(rng, 40, 2, size=512)
    rois[:3, 3:] = rois[:3, 1:3] + 470.0  # large enough for the last level
    g = rng.randn(40, 7, 7, 4).astype(np.float32)
    jpool = JaxPooler(names, 7, 2, backend="dense")
    _, vjp = jax.vjp(lambda f: jpool(f, jnp.asarray(rois), (512, 512)),
                     {k: jnp.asarray(v) for k, v in feats.items()})
    (want,) = vjp(jnp.asarray(g))
    tfeats = {k: torch.from_numpy(v).permute(0, 3, 1, 2).requires_grad_()
              for k, v in feats.items()}
    pooler = MultiScaleRoIAlign(names, 7, 2, window=window, overflow_capacity=40)
    out = pooler(tfeats, torch.from_numpy(rois), (512, 512))
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    scale = max(float(np.abs(want[k]).max()) for k in names)
    for k in names:  # a level that no RoI maps to gets a zero gradient
        np.testing.assert_allclose(tfeats[k].grad.permute(0, 2, 3, 1).numpy(),
                                   want[k], rtol=0, atol=1e-5 * scale)
    assert all(np.abs(want[k]).max() > 0 for k in names)
