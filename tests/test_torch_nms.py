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
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

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


def _chunked_rowscan(above, valid):
    """A model of the chunked schedule of ``csrc/nms_rowscan.cu`` over a
    boolean ``above[i, j]`` (IoU of i and j above the threshold): removed
    bits in words of 32 boxes; per word, each live box's bits of the later
    live boxes it would suppress, resolved in greedy order (the next live
    box by lowest set bit); then every later live box tested against the
    word's kept boxes only."""
    n = valid.shape[0]
    words = -(-n // 32)
    removed = np.ones(words * 32, bool)
    removed[:n] = ~valid
    for c in range(words):
        lo = 32 * c
        live = ~removed[lo:lo + 32]
        sup = np.zeros((32, 32), bool)  # lane i: the later bits it clears
        for i in np.flatnonzero(live):
            for l in np.flatnonzero(live[i + 1:]) + i + 1:
                sup[i, l] = above[lo + i, lo + l]
        alive, kept = live.copy(), np.zeros(32, bool)
        while alive.any():
            l = int(np.argmax(alive))
            kept[l], alive[l] = True, False
            alive &= ~sup[l]
        removed[lo:lo + 32] = ~kept
        if kept.any() and lo + 32 < n:
            rest = np.arange(lo + 32, n)
            hit = above[np.ix_(lo + np.flatnonzero(kept), rest)].any(0)
            removed[rest] |= hit & ~removed[rest]
    return ~removed[:n]


def _schedule_case(kind, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "random":
        boxes = _boxes(rng, n, degenerate=min(3, n // 4))
        valid = rng.rand(n) > 0.2
    elif kind == "all_survive":  # a grid of disjoint boxes
        ij = np.stack(np.divmod(np.arange(n), 16), 1).astype(np.float32) * 10
        boxes = np.concatenate([ij, ij + 5], 1)
        valid = np.ones(n, bool)
    else:  # "first_suppresses_all": copies of one box, slightly shifted
        base = np.array([10, 10, 60, 60], np.float32)
        boxes = base + rng.uniform(0, 1e-3, (n, 1)).astype(np.float32)
        valid = np.ones(n, bool)
    return np.where(valid[:, None], boxes, 0.0).astype(np.float32), valid


@pytest.mark.parametrize("kind", ["random", "all_survive", "first_suppresses_all"])
@pytest.mark.parametrize("thr", [0.0, 0.3, 0.5, 0.9])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 200])
def test_chunked_rowscan_schedule_matches_plain_and_pallas(n, thr, kind):
    """The schedule of the card's row-serial kernel gives the greedy mask
    bit for bit: against the port's plain version and, on random rows, the
    JAX row-serial kernel in interpret mode."""
    boxes, valid = _schedule_case(kind, n, 400 + n)
    tboxes = torch.from_numpy(boxes)
    above = (tnms._iou_matrix(tboxes) > thr).numpy()
    got = _chunked_rowscan(above, valid)
    want = tnms.nms_keep_sorted_plain(
        tboxes[None], torch.from_numpy(valid)[None], thr)[0].numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "all_survive":
        np.testing.assert_array_equal(got, valid)
    elif kind == "first_suppresses_all":
        np.testing.assert_array_equal(got, np.arange(n) == 0)
    if kind == "random":
        kernel = np.asarray(nms_pallas_sorted(
            jnp.asarray(boxes), jnp.asarray(valid), thr, interpret=True)) & valid
        np.testing.assert_array_equal(got, kernel)


def _above_without_division(inter, uni, thr):
    """The rule of ``csrc/nms_iou.cuh`` (both NMS kernels) for
    ``fl(inter / uni) > thr``:
    compare ``inter`` with ``mid * uni`` in float64, ``mid`` the midpoint
    between ``thr`` and the next float32 above it; a tie rounds to the even
    neighbour."""
    thr = np.float32(thr)
    zero_above = np.float32(0) > thr
    if np.isnan(thr) or thr == np.inf:
        mid, odd = np.nan if np.isnan(thr) else np.inf, False
    elif thr < 0:
        mid, odd = -np.inf, False
    else:
        _, e = np.frexp(np.float64(thr))
        tiny = np.finfo(np.float32).tiny
        ulp = 2.0 ** (int(e) - 24) if thr >= tiny else 2.0 ** -149
        mid, odd = np.float64(thr) + ulp / 2, bool(thr.view(np.uint32) & 1)
    x = inter.astype(np.float64)
    with np.errstate(invalid="ignore"):
        p = mid * uni.astype(np.float64)
    return np.where(uni > 0, (x > p) | (odd & (x == p)), zero_above)


@pytest.mark.parametrize("thr", [
    0.0, 0.3, 0.5, 0.7, 0.9, 1.0, 1 / 3, 0.7000000476837158, -0.25, np.inf,
    np.nan, 1e-40,
    float(np.array(71363, np.uint32).view(np.float32)),  # odd, subnormal
])
def test_threshold_rule_equals_rounded_division(thr):
    """Quotients on both sides of the threshold: ``inter`` is the float32
    product ``thr * uni`` and its neighbours, so ``fl(inter / uni)`` lands
    on ``thr`` or next to it; and random pairs. An exact tie needs a
    threshold of fewer than 24 significant bits, a subnormal one: the last
    two cases."""
    rng = np.random.RandomState(11)
    uni = np.concatenate([
        rng.uniform(1e-3, 1e4, 4000), rng.uniform(0.5, 2, 4000),
        2.0 ** rng.randint(-20, 20, 200), [0.0, -1.0, 1e-45, 3.0],
    ]).astype(np.float32)
    t = np.float32(thr) if np.isfinite(thr) and thr >= 0 else np.float32(0.5)
    with np.errstate(over="ignore", invalid="ignore"):
        base = (uni * t).astype(np.float32)
        inter = np.concatenate([base + np.float32(0)] + [
            np.nextafter(base, np.float32(s * np.inf)) for s in (-1, 1)
        ] + [rng.uniform(0, 1e4, uni.size).astype(np.float32)]).astype(np.float32)
    uni = np.tile(uni, 4)
    inter = np.abs(inter)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        iou = np.where(uni > 0, inter / uni, np.float32(0)).astype(np.float32)
    want = iou > np.float32(thr)
    np.testing.assert_array_equal(_above_without_division(inter, uni, thr), want)


def _band_scan(above, valid, band, helpers=7, seed=0):
    """A model of the scan of ``csrc/nms.cu`` over the mask words of a
    boolean ``above[i, j]`` (IoU of i and j above the threshold): chunks of
    64 rows, Python ints as 64-bit words.

    The chain resolves chunk c from its removed word and the band of its
    rows' words c .. c+band-1 only: the greedy kept set as the fixpoint of
    "live and not suppressed by a kept row" (one OR over the kept rows'
    diagonal words a round, from kept = live), then the kept rows' words
    c+1 .. c+band-1, ORed, ride on to the next chunks. Helper ``c %
    helpers`` ORs the kept rows' words c+band .. into the removed words at
    a moment drawn at random before the chain reaches chunk c+band, which
    waits for it; word w is read only when every chunk up to w-band has
    been applied. Returns the keep mask and the largest number of fixpoint
    rounds a chunk took."""
    rng = np.random.RandomState(seed)
    n = valid.shape[0]
    words = -(-n // 64)
    mask = [[0] * words for _ in range(n)]  # row i, word w: bits of later rows
    for i in range(n):
        for j in (np.flatnonzero(above[i, i + 1:]) + i + 1).tolist():
            mask[i][j // 64] |= 1 << (j % 64)
    removed = [0] * words
    for r in range(words * 64):
        if r >= n or not valid[r]:
            removed[r // 64] |= 1 << (r % 64)
    full = (1 << 64) - 1
    pend = [0] * (band - 1)  # the chain's ORs into words c .. c+band-2
    queued = {}  # chain step at which a helper applies its chunk -> chunks
    applied = set()
    kept_words, rounds = [], 0

    def rows_of(c, kept):
        return [c * 64 + i for i in range(64) if kept >> i & 1]

    def helper(c):
        for w in rng.permutation(np.arange(c + band, words)).tolist():
            for row in rows_of(c, kept_words[c]):
                removed[w] |= mask[row][w]
        applied.add(c)

    for c in range(words):
        for h in queued.pop(c, []):
            helper(h)
        assert all(h in applied for h in range(c - band + 1)), "word not complete"
        band_words = [[mask[r][w] if r < n and w < words else 0
                       for w in range(c, c + band)] for r in range(c * 64, c * 64 + 64)]
        live = ~(removed[c] | (pend[0] if pend else 0)) & full
        kept, k = live, 0
        while True:
            k += 1
            s = 0
            for i in range(64):
                if kept >> i & 1:
                    s |= band_words[i][0]
            nxt = live & ~s
            if nxt == kept:
                break
            kept = nxt
        rounds = max(rounds, k)
        kept_words.append(kept)
        removed[c] = ~kept & full
        ors = [0] * band
        for i in range(64):
            if kept >> i & 1:
                for k in range(1, band):
                    ors[k] |= band_words[i][k]
        pend = [(pend[k] if k < band - 1 else 0) | ors[k] for k in range(1, band)]
        if c + band < words:  # due before the chain reaches chunk c+band
            queued.setdefault(int(rng.randint(c + 1, c + band + 1)), []).append(c)
    return np.array([not (removed[r // 64] >> (r % 64) & 1) for r in range(n)],
                    bool), rounds


@pytest.mark.parametrize("kind", ["random", "all_survive", "first_suppresses_all"])
@pytest.mark.parametrize("thr", [0.0, 0.5, 0.9])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 128, 130, 300])
def test_band_scan_schedule_matches_plain_and_pallas(n, thr, kind):
    """The scan of the card's bitmask kernel gives the greedy mask bit for
    bit, whatever the moment each helper's ORs land: the band of the
    kernel (4 words) and narrower ones, against the port's plain version
    and the JAX bitmask kernel in interpret mode."""
    boxes, valid = _schedule_case(kind, n, 500 + n)
    tboxes = torch.from_numpy(boxes)
    above = (tnms._iou_matrix(tboxes) > thr).numpy()
    want = tnms.nms_keep_sorted_plain(
        tboxes[None], torch.from_numpy(valid)[None], thr)[0].numpy()
    kernel = np.asarray(nms_pallas_bitmask_sorted(
        jnp.asarray(boxes), jnp.asarray(valid), thr, interpret=True)) & valid
    np.testing.assert_array_equal(want, kernel)
    for band in (4, 2, 1):
        got, rounds = _band_scan(above, valid, band, seed=n + band)
        np.testing.assert_array_equal(got, want)
        assert rounds <= 65
    if kind == "all_survive":
        np.testing.assert_array_equal(got, valid)
    elif kind == "first_suppresses_all":
        np.testing.assert_array_equal(got, np.arange(n) == 0)
