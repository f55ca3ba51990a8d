"""Pooler parity: the port's window pool (plain PyTorch path on the CPU)
against the JAX package's Pallas window-pool kernel in interpret mode, and
the port's ``MultiScaleRoIAlign`` (window backend, overflowing RoIs
included, and dense backend) against JAX's ``backend="dense"``.
Tolerances: 2e-4 for the window contraction of random weights (the
Pallas test's own), 2e-5 for pooling features in [0, 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.ops._pallas.window_pool import window_pool_pallas
from vision_tpu.ops.poolers import MultiScaleRoIAlign as JaxPooler
from vision_tpu_torch.ops.poolers import MultiScaleRoIAlign, window_pool


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
