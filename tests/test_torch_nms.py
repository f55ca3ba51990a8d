"""NMS parity: the port (``vision_tpu_torch.ops.nms``, plain PyTorch path on
the CPU) against the JAX package's Pallas bitmask kernel in interpret mode
and against ``vision_tpu.ops.nms``. Tolerance: none — keep masks must be
exactly equal, since the kernel and the plain version compute IoU with the
same float operations in the same order."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.ops._pallas.nms import (
    nms_pallas_bitmask_sorted,
    nms_pallas_sorted,
)

# the packages re-export a function named ``nms`` over the module name
jnms = importlib.import_module("vision_tpu.ops.nms")
tnms = importlib.import_module("vision_tpu_torch.ops.nms")


def _boxes(rng, n, degenerate=0):
    xy = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    wh = rng.uniform(2, 40, (n, 2)).astype(np.float32)
    b = np.concatenate([xy, xy + wh], 1)
    if degenerate:  # zero-area rows: union 0 against each other
        b[:degenerate, 2:] = b[:degenerate, :2]
    return b


def _case(seed, n, ties=False):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, n, degenerate=min(3, n // 4))
    scores = rng.rand(n).astype(np.float32)
    if ties:  # few score levels: the stable tie order decides
        scores = np.round(scores * 4) / 4
    valid = rng.rand(n) > 0.2
    return boxes, scores, valid


@pytest.mark.parametrize("thr", [0.5, 0.7])
@pytest.mark.parametrize("n", [1, 130, 300])
def test_presorted_matches_pallas_interpret_and_jax(n, thr):
    boxes, scores, valid = _case(n, n)
    order = np.argsort(-scores, kind="stable")
    boxes, scores, valid = boxes[order], scores[order], valid[order]

    got = tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                        valid=torch.from_numpy(valid), presorted=True).numpy()
    want = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                    thr, valid=jnp.asarray(valid),
                                    presorted=True))
    sboxes = np.where(valid[:, None], boxes, 0.0).astype(np.float32)
    kernel = np.asarray(nms_pallas_bitmask_sorted(
        jnp.asarray(sboxes), jnp.asarray(valid), thr, interpret=True)) & valid
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, kernel)
    assert not got[~valid].any()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", [1, 130, 300])
def test_unsorted_matches_jax(n, ties):
    boxes, scores, valid = _case(100 + n, n, ties=ties)
    for v in (None, valid):
        got = tnms.nms_mask(
            torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
            valid=None if v is None else torch.from_numpy(v)).numpy()
        want = np.asarray(jnms.nms_mask(
            jnp.asarray(boxes), jnp.asarray(scores), 0.5,
            valid=None if v is None else jnp.asarray(v)))
        np.testing.assert_array_equal(got, want)


def test_batched_rows_match_per_row_jax():
    """The [B, N] entry (the RPN's per-level NMS) is B independent NMS."""
    rows = [_case(7 + b, 130) for b in range(3)]
    boxes = np.stack([r[0] for r in rows])
    scores = np.stack([r[1] for r in rows])
    valid = np.stack([r[2] for r in rows])
    for presorted in (False, True):
        if presorted:
            order = np.argsort(-scores, axis=1, kind="stable")
            boxes = np.take_along_axis(boxes, order[..., None], 1)
            scores = np.take_along_axis(scores, order, 1)
            valid = np.take_along_axis(valid, order, 1)
        got = tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                            0.7, valid=torch.from_numpy(valid),
                            presorted=presorted).numpy()
        for b in range(3):
            want = np.asarray(jnms.nms_mask(
                jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.7,
                valid=jnp.asarray(valid[b]), presorted=presorted))
            np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize("n", [130, 300])
def test_batched_nms_mask_offsets_match_jax(n):
    boxes, scores, valid = _case(200 + n, n)
    rng = np.random.RandomState(n)
    idxs = rng.randint(1, 6, n).astype(np.int32)
    # padding rows with huge coordinates must not move the offsets
    boxes[~valid] = 1e6
    got = tnms.batched_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                                torch.from_numpy(idxs), 0.5,
                                valid=torch.from_numpy(valid)).numpy()
    want = np.asarray(jnms.batched_nms_mask(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(idxs), 0.5,
        valid=jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)

    # the [B, N] form offsets each row by its own valid max
    got2 = tnms.batched_nms_mask(
        torch.from_numpy(np.stack([boxes, boxes * 0.5])),
        torch.from_numpy(np.stack([scores, scores])),
        torch.from_numpy(np.stack([idxs, idxs])), 0.5,
        valid=torch.from_numpy(np.stack([valid, valid]))).numpy()
    np.testing.assert_array_equal(got2[0], want)
    want_half = np.asarray(jnms.batched_nms_mask(
        jnp.asarray(boxes * 0.5), jnp.asarray(scores), jnp.asarray(idxs), 0.5,
        valid=jnp.asarray(valid)))
    np.testing.assert_array_equal(got2[1], want_half)


def test_index_apis_match_jax():
    boxes, scores, _ = _case(5, 130)
    idxs = np.random.RandomState(5).randint(0, 4, 130).astype(np.int32)
    got = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5).numpy()
    want = np.asarray(jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5))
    np.testing.assert_array_equal(got, want)
    got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(idxs), 0.5).numpy()
    want = np.asarray(jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                       jnp.asarray(idxs), 0.5))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thr", [0.5, 0.7])
@pytest.mark.parametrize("n", [1, 130, 300])
def test_rowscan_switch_matches_pallas_rowscan_interpret(n, thr, monkeypatch):
    """``VISION_TPU_NMS_KERNEL=rowscan`` selects another kernel on the card,
    never another answer: on the CPU the plain version still runs, and its
    mask equals the JAX row-scan kernel's (interpret mode) exactly."""
    monkeypatch.setenv("VISION_TPU_NMS_KERNEL", "rowscan")
    boxes, scores, valid = _case(300 + n, n)
    order = np.argsort(-scores, kind="stable")
    boxes, scores, valid = boxes[order], scores[order], valid[order]
    before = (tnms.nms_keep_sorted_cuda.launches,
              tnms.nms_keep_sorted_rowscan_cuda.launches)
    got = tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                        valid=torch.from_numpy(valid), presorted=True).numpy()
    assert before == (tnms.nms_keep_sorted_cuda.launches,
                      tnms.nms_keep_sorted_rowscan_cuda.launches)
    sboxes = np.where(valid[:, None], boxes, 0.0).astype(np.float32)
    kernel = np.asarray(nms_pallas_sorted(
        jnp.asarray(sboxes), jnp.asarray(valid), thr, interpret=True)) & valid
    np.testing.assert_array_equal(got, kernel)
    monkeypatch.delenv("VISION_TPU_NMS_KERNEL")
    same = tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                         valid=torch.from_numpy(valid), presorted=True).numpy()
    np.testing.assert_array_equal(got, same)


def test_rowscan_switch_is_read_at_every_call(monkeypatch):
    """The dispatcher picks the wrapper by the environment at call time."""
    picked = []
    monkeypatch.setattr(tnms, "nms_keep_sorted_cuda",
                        lambda *a: picked.append("bitmask"))
    monkeypatch.setattr(tnms, "nms_keep_sorted_rowscan_cuda",
                        lambda *a: picked.append("rowscan"))
    boxes = torch.zeros(1, 2, 4, device="meta")
    valid = torch.ones(1, 2, dtype=torch.bool, device="meta")
    tnms.nms_keep_sorted(boxes, valid, 0.5)
    monkeypatch.setenv("VISION_TPU_NMS_KERNEL", "rowscan")
    tnms.nms_keep_sorted(boxes, valid, 0.5)
    monkeypatch.setenv("VISION_TPU_NMS_KERNEL", "bitmask")
    tnms.nms_keep_sorted(boxes, valid, 0.5)
    assert picked == ["bitmask", "rowscan", "bitmask"]
