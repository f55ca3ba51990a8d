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
