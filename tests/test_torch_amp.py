"""bf16 (amp) detection eval: the port against the JAX package on the CPU.

The switch is the JAX package's own (``bench.py:amp_vars``,
``tests/test_detection_amp.py``): the model's floating parameters and the
canvas in bf16, the box arithmetic in f32. Here: ``model.to(bfloat16)``
and a bf16 canvas on the port's side, ``amp_vars``-cast variables and a
bf16 input on the JAX side, the same weights (ResNet-18 FPN, 6 classes,
RPN top-n 200/100, a 128x128 canvas, batch 2).

Tolerances, stated before they were read:
- the multi-scale pooler and RoIAlign in bf16 against the JAX CPU path:
  within one bf16 step of each element (2**-7 of its magnitude: f32 sums
  taken in another order may round to the neighbouring value) plus 1e-5 of
  the largest value where the divisor is a power of two (``sr = 2``), and
  within two steps at ``sr = 3``: both sides round the f32 sum to bf16
  before they divide by 9, so a sum rounded the other way moves the
  quotient by a step before its own rounding;
- the box coder and NMS: as the JAX file's (decoded boxes f32, within 2 px
  of the f32 run); keep masks equal to the f32 run of the same values;
- the two models' bf16 features and RPN head outputs within 3e-2 of each
  map's largest value: each layer rounds its output to bf16 (2**-9
  relative), the two libraries at other places and with other sums, over
  some twenty layers; the proposals from the same head outputs: valid
  rows and scores equal, boxes within 1e-5 px; the pooled features from
  the same features and proposals within one bf16 step;
- end to end, the JAX amp test's checks: boxes f32, finite and inside the
  canvas, the top 5 scores within 0.05 of the f32 run's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu._torch_convert import convert_torch_state_dict
from vision_tpu.models.detection._utils import BoxCoder as JaxBoxCoder
from vision_tpu.models.detection.faster_rcnn import FasterRCNN as JaxFasterRCNN
from vision_tpu.models.detection.faster_rcnn import _frcnn_hooks
from vision_tpu.models.detection.rpn import RegionProposalNetwork as JaxRPN
from vision_tpu.ops.poolers import MultiScaleRoIAlign as JaxPooler
from vision_tpu_torch._jax_convert import load_jax_variables
from vision_tpu_torch.models.detection._utils import BoxCoder
from vision_tpu_torch.models.detection.faster_rcnn import FasterRCNN, init_weights
from vision_tpu_torch.ops.poolers import MultiScaleRoIAlign, window_pool_plain
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

CFG = dict(backbone_depth=18, num_classes=6, rpn_pre_nms_top_n=200,
           rpn_post_nms_top_n=100)
SIZE = 128
NAMES = ["0", "1", "2", "3"]
STEP = 2.0 ** -7
# the packages re-export functions named ``nms`` over their modules' names
jnms = importlib.import_module("vision_tpu.ops.nms")
tnms = importlib.import_module("vision_tpu_torch.ops.nms")


def _bf16_close(got, want, steps=1, atol_rel=1e-5):
    """``got`` (torch, NCHW or any) and ``want`` (numpy f32, same layout)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=steps * STEP,
                               atol=atol_rel * np.abs(want).max())


def _rand_boxes(rng, n, lo=0.0, hi=800.0):
    x1 = rng.rand(n) * (hi - lo - 50) + lo
    y1 = rng.rand(n) * (hi - lo - 50) + lo
    w = rng.rand(n) * 200 + 4
    h = rng.rand(n) * 200 + 4
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def _pooler_case(seed, c=16):
    """A pyramid of four levels for a 256x256 image (bf16 values) and 60
    RoIs of 4 to 150 px, over two images: fewer than the pooler's overflow
    capacity (64), so every RoI that leaves its window is recomputed on
    both sides, whose windows differ (``ROADMAP.md`` §3)."""
    rng = np.random.RandomState(seed)
    feats = {n: rng.randn(2, 64 >> i, 64 >> i, c).astype(np.float32)
             for i, n in enumerate(NAMES)}
    feats = {n: np.asarray(jnp.asarray(f).astype(jnp.bfloat16))
             for n, f in feats.items()}
    xy = rng.uniform(0, 200, (60, 2))
    wh = rng.uniform(4, 150, (60, 2))
    b = rng.randint(0, 2, (60, 1))
    rois = np.concatenate([b, xy, xy + wh], 1).astype(np.float32)
    return feats, rois


@pytest.mark.parametrize("sr", [2, 3])
@pytest.mark.parametrize("backend", ["dense", "window"])
def test_multiscale_pooler_bf16_matches_jax(backend, sr):
    """The port's window backend against the JAX package's XLA window path
    (``window_xla``), and dense against dense."""
    feats, rois = _pooler_case(10 + sr)
    jpool = JaxPooler(NAMES, 7, sr, window=8,
                      backend="dense" if backend == "dense" else "window_xla")
    want = jpool({k: jnp.asarray(v) for k, v in feats.items()},
                 jnp.asarray(rois), (256, 256))
    assert want.dtype == jnp.bfloat16
    pool = MultiScaleRoIAlign(NAMES, 7, sr, backend=backend, window=8)
    got = pool({k: torch.from_numpy(v.astype(np.float32)).bfloat16()
                .permute(0, 3, 1, 2) for k, v in feats.items()},
               torch.from_numpy(rois), (256, 256))
    assert got.dtype == torch.bfloat16
    _bf16_close(got.permute(0, 2, 3, 1), want, steps=1 if sr == 2 else 2)


@pytest.mark.parametrize("sr", [2, 3])
def test_window_pool_bf16_rounds_the_sum_before_dividing(sr):
    """As the JAX package (``poolers.py:62,273``): the f32 sum is rounded to
    bf16, then divided by sr**2 in f32 and rounded again. At sr = 2 the
    division is exact, so it is the same as one rounding of sum / 4; at
    sr = 3 it is not, and some elements differ from one rounding."""
    rng = np.random.RandomState(20 + sr)
    stacked = torch.from_numpy(rng.randn(64, 40, 16).astype(np.float32)).bfloat16()
    row0 = torch.from_numpy(rng.randint(0, 64 - 8, 50))
    x0 = torch.from_numpy(rng.randint(0, 40 - 8, 50))
    w_y = torch.from_numpy(rng.rand(50, 7, 8).astype(np.float32))
    w_x = torch.from_numpy(rng.rand(50, 7, 8).astype(np.float32))
    div = float(sr * sr)
    total = window_pool_plain(stacked.float(), row0, x0, w_y, w_x)  # f32 sum
    twice = (total.bfloat16().float() / div).bfloat16()
    once = (total / div).bfloat16()
    got = window_pool_plain(stacked, row0, x0, w_y, w_x, div)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, twice)
    assert torch.equal(once, twice) == (sr == 2)


def test_box_coder_decode_promotes_bf16_to_f32():
    """The JAX file's first test, on the port, and the port's decode of bf16
    deltas against the JAX package's."""
    rng = np.random.RandomState(0)
    coder = BoxCoder((1.0, 1.0, 1.0, 1.0))
    anchors = torch.from_numpy(_rand_boxes(rng, 64))
    deltas32 = torch.from_numpy(rng.randn(64, 4).astype(np.float32) * 0.3)
    out32 = coder.decode(deltas32, anchors)
    out16 = coder.decode(deltas32.bfloat16(), anchors)
    assert out32.dtype == out16.dtype == torch.float32
    np.testing.assert_allclose(out16.numpy(), out32.numpy(), atol=2.0)
    assert coder.decode(deltas32, anchors.bfloat16()).dtype == torch.float32
    want = JaxBoxCoder((1.0, 1.0, 1.0, 1.0)).decode(
        jnp.asarray(deltas32.numpy()).astype(jnp.bfloat16),
        jnp.asarray(anchors.numpy()))
    np.testing.assert_allclose(out16.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize("entry", ["nms_mask", "batched_nms_mask", "nms",
                                   "batched_nms"])
def test_nms_entries_promote_bf16_to_f32(entry):
    """bf16 boxes and scores give what f32 boxes and scores of the same
    values give, and what the JAX package's entry gives on bf16."""
    rng = np.random.RandomState(1)
    boxes = torch.from_numpy(_rand_boxes(rng, 300)).bfloat16()
    scores = torch.from_numpy(rng.rand(300).astype(np.float32)).bfloat16()
    labels = torch.from_numpy(rng.randint(0, 4, 300))
    extra = (labels,) if entry.startswith("batched") else ()
    fn = getattr(tnms, entry)
    got = fn(boxes, scores, *extra, 0.5)
    assert torch.equal(got, fn(boxes.float(), scores.float(), *extra, 0.5))
    jextra = (jnp.asarray(labels.numpy()),) if extra else ()
    want = getattr(jnms, entry)(
        jnp.asarray(boxes.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(scores.float().numpy()).astype(jnp.bfloat16), *jextra, 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _amp_vars(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16)
        if hasattr(a, "dtype") and a.dtype == jnp.float32 else a, tree)


@pytest.fixture(scope="module")
def amp():
    """Both models in f32 and in bf16, one seeded batch of two images."""
    jm = JaxFasterRCNN(**CFG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    src = FasterRCNN(**CFG)
    init_weights(src, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    variables = jax.tree_util.tree_map(
        np.asarray, convert_torch_state_dict(sd, shapes, hooks=_frcnn_hooks))
    port = FasterRCNN(**CFG).eval()
    load_jax_variables(port, variables)
    port16 = FasterRCNN(**CFG).eval()
    load_jax_variables(port16, variables)
    port16 = port16.to(torch.bfloat16)
    x = np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    v16 = _amp_vars(variables)
    jfeats = jax.jit(lambda v, x: jm.apply(
        v, x, method=lambda m, x: m._features_and_rpn(x)))(v16, x16)
    rpn = JaxRPN(pre_nms_top_n=200, post_nms_top_n=100)
    props = jax.jit(lambda o, d, a: rpn.filter_proposals(o, d, a, (SIZE, SIZE)))(
        *jfeats[1:])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        tfeats = port16.features_and_rpn(xt.bfloat16())
        dets32, dets16 = port(xt), port16(xt.bfloat16())
    return dict(jfeats=jfeats, jprops=props, tfeats=tfeats, port16=port16,
                dets32=dets32, dets16=dets16)


def test_bf16_features_and_rpn_head_match_jax(amp):
    feats, obj, deltas, anchors = amp["jfeats"]
    tfeats, tobj, tdeltas, tanchors = amp["tfeats"]
    for k in feats:
        assert tfeats[k].dtype == torch.bfloat16
        want = np.asarray(feats[k], np.float32)
        np.testing.assert_allclose(
            tfeats[k].permute(0, 2, 3, 1).float().numpy(), want, rtol=0,
            atol=3e-2 * np.abs(want).max())
    for a, b in list(zip(tobj, obj)) + list(zip(tdeltas, deltas)):
        assert a.dtype == torch.bfloat16
        want = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), want, rtol=0,
                                   atol=3e-2 * np.abs(want).max())
    for a, b in zip(tanchors, anchors):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bf16_filter_proposals_same_inputs(amp):
    """The RPN's top-k over bf16 objectness (with its ties) and its decode
    of bf16 deltas, on the JAX run's own head outputs."""
    _, obj, deltas, anchors = amp["jfeats"]
    want = amp["jprops"]

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()

    got = amp["port16"].rpn.filter_proposals(
        [bf16(o) for o in obj], [bf16(d) for d in deltas],
        [torch.from_numpy(np.array(a)) for a in anchors], (SIZE, SIZE))
    assert got.boxes.dtype == torch.float32 and got.scores.dtype == torch.bfloat16
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 100
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.scores.float().numpy()[valid],
                                  np.asarray(want.scores, np.float32)[valid])


@pytest.mark.parametrize("backend", ["dense", "window"])
def test_bf16_pooled_features_same_inputs(amp, backend):
    """The box pooler (sr = 2) on the JAX run's bf16 features and its
    proposals."""
    feats = amp["jfeats"][0]
    boxes = np.asarray(amp["jprops"].boxes)
    rois = np.concatenate([np.repeat(np.arange(2, dtype=np.float32), 100)[:, None],
                           boxes.reshape(-1, 4)], 1)
    jpool = JaxPooler(NAMES, 7, 2, backend="dense" if backend == "dense"
                      else "window_xla")
    want = jpool({k: feats[k] for k in NAMES}, jnp.asarray(rois), (SIZE, SIZE))
    pool = MultiScaleRoIAlign(NAMES, 7, 2, backend=backend)
    got = pool({k: torch.from_numpy(np.asarray(feats[k], np.float32)).bfloat16()
                .permute(0, 3, 1, 2) for k in NAMES},
               torch.from_numpy(rois), (SIZE, SIZE))
    assert got.dtype == torch.bfloat16
    _bf16_close(got.permute(0, 2, 3, 1), want)


def test_frcnn_bf16_eval_end_to_end(amp):
    """The JAX amp test's checks on the port's bf16 forward."""
    det16, det32 = amp["dets16"], amp["dets32"]
    assert det16.boxes.dtype == torch.float32
    b = det16.boxes.numpy()
    assert np.isfinite(b).all()
    assert (b >= -1e-3).all() and (b <= SIZE + 1e-3).all()
    assert int(det16.valid.sum()) > 20
    s32 = np.sort(det32.scores.numpy().ravel())[-5:]
    s16 = np.sort(det16.scores.float().numpy().ravel())[-5:]
    np.testing.assert_allclose(s16, s32, atol=0.05)
