"""RAFT, the port against ``vision_tpu`` on the CPU, the JAX variables
(seeded by numpy in ``jax.eval_shape``'s shapes) carried across by
``load_jax_variables``: a narrow RAFT (feature and context widths 8-32,
hidden 16) on 64x64 pairs with 3 updates, ``raft_large``'s widths with 2
updates, and ``raft_small``'s (bottleneck blocks, no norm in the context
encoder, radius 3, one 3x3 GRU, no mask predictor) with 2.

Tolerances (``tests/torch_zoo_cases.py``'s): every flow prediction within
1e-5 of the largest JAX value; ``CorrBlock.build_pyramid`` (odd sizes
floored), ``index_pyramid`` (windows partly outside the map) and
``upsample_flow`` (with and without the mask) alone within 1e-5; one step
of ``make_flow_train_step`` against ``jax.value_and_grad`` of a copy of
``references/optical_flow/train.py``'s ``sequence_loss`` with its
elementwise clip: the loss within 1e-5 relative, the clipped gradients
within 1e-3 by relative Frobenius norm (AdamW's first update is the sign
of the gradient, so the update is not compared), and the context
encoder's running statistics within 1e-5.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.models import get_model_weights as jweights
from vision_tpu.models.optical_flow import raft as J
from vision_tpu.transforms._presets import OpticalFlow as JPreset
from vision_tpu_torch._jax_convert import jax_placements, load_jax_variables
from vision_tpu_torch.models import get_model, get_model_weights
from vision_tpu_torch.parallel import make_flow_train_step, sequence_loss
from vision_tpu_torch.transforms import OpticalFlow

from torch_zoo_cases import LOGITS_TOL, LOSS_TOL, UPDATE_TOL, _err, nchw, rel
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

T = importlib.import_module("vision_tpu_torch.models.optical_flow.raft")

NARROW = dict(feature_layers=(8, 8, 12, 16, 32),
              context_layers=(8, 8, 12, 16, 32), hidden_state_size=16,
              corr_layers=(16, 12), flow_layers=(8, 4), motion_out=16,
              flow_head_hidden=24)
SMALL = T._SMALL  # raft_small's fields, the JAX builder's
CASES = {"narrow": (NARROW, 3), "large": ({}, 2), "small": (SMALL, 2)}

RNG = np.random.RandomState(0)
X1 = RNG.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
X2 = RNG.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)


def seeded(shapes, seed=0):
    """``torch_zoo_cases.random_variables``'s draws for given shapes."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf in ("scale", "var"):
            return rng.random(s.shape, np.float32) + np.float32(0.5)
        std = (1.0 / np.sqrt(np.prod(s.shape[:-1])) if leaf == "kernel"
               else 0.1)
        return rng.standard_normal(s.shape, np.float32) * np.float32(std)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(None)
def case(name):
    fields, n = CASES[name]
    jm = J.RAFT(num_flow_updates=n, **fields)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(X1[:1]), jnp.asarray(X2[:1]),
        num_flow_updates=1))
    return jm, seeded(shapes), (lambda: T.RAFT(num_flow_updates=n, **fields))


def port_of(make, variables):
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device="cpu")
    load_jax_variables(model, variables)
    return model.eval()


@pytest.mark.parametrize("name", list(CASES))
def test_every_flow_prediction_matches_jax(name):
    jm, variables, make = case(name)
    want = jax.jit(jm.apply)(variables, jnp.asarray(X1), jnp.asarray(X2))
    with torch.no_grad():
        got = port_of(make, variables)(nchw(X1), nchw(X2))
    assert len(got) == len(want) == CASES[name][1]
    for g, w in zip(got, want):
        assert g.shape == (2, 2, 64, 64) and g.dtype == torch.float32
        assert rel(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) <= \
            LOGITS_TOL


def test_pyramid_and_lookup_match_jax():
    """A 15x13 map (odd sizes, floored by the 2x2 pools), radius 3,
    coordinates up to 5 px off the grid (windows partly outside)."""
    rng = np.random.RandomState(1)
    f1 = rng.randn(2, 15, 13, 8).astype(np.float32)
    f2 = rng.randn(2, 15, 13, 8).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(15), np.arange(13), indexing="ij")
    coords = np.stack([xs, ys], -1)[None].astype(np.float32)
    coords = coords + rng.uniform(-5, 5, (2, 15, 13, 2)).astype(np.float32)
    jcb, tcb = J.CorrBlock(radius=3), T.CorrBlock(radius=3)
    jpyr = jcb.build_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    tpyr = tcb.build_pyramid(nchw(f1), nchw(f2))
    assert [tuple(p.shape) for p in tpyr] == [tuple(p.shape[:3]) for p in jpyr]
    for t, j in zip(tpyr, jpyr):
        assert rel(t.numpy(), np.asarray(j)[..., 0]) <= LOGITS_TOL
    want = np.asarray(jcb.index_pyramid(jpyr, jnp.asarray(coords)))
    got = tcb.index_pyramid(tpyr, nchw(coords))
    assert got.shape == (2, 4 * 49, 15, 13)
    assert rel(got.numpy(), want.transpose(0, 3, 1, 2)) <= LOGITS_TOL


def test_bf16_features_give_an_f32_volume():
    rng = np.random.RandomState(2)
    f = [torch.from_numpy(rng.randn(1, 8, 16, 16).astype(np.float32))
         for _ in range(2)]
    pyr = T.CorrBlock().build_pyramid(f[0].bfloat16(), f[1].bfloat16())
    want = T.CorrBlock().build_pyramid(f[0].bfloat16().float(),
                                       f[1].bfloat16().float())
    assert all(p.dtype == torch.float32 for p in pyr)
    assert all(torch.equal(p, q) for p, q in zip(pyr, want))


@pytest.mark.parametrize("with_mask", [True, False])
def test_upsample_flow_matches_jax(with_mask):
    rng = np.random.RandomState(3)
    flow = rng.randn(2, 5, 7, 2).astype(np.float32)
    mask = rng.randn(2, 5, 7, 576).astype(np.float32) if with_mask else None
    want = np.asarray(J.upsample_flow(
        jnp.asarray(flow), None if mask is None else jnp.asarray(mask)))
    got = T.upsample_flow(nchw(flow), None if mask is None else nchw(mask))
    assert got.shape == (2, 2, 40, 56)
    assert rel(got.numpy(), want.transpose(0, 3, 1, 2)) <= LOGITS_TOL


def jax_sequence_loss(flow_preds, flow_gt, valid_mask=None, gamma=0.8,
                      max_flow=400.0):
    """``references/optical_flow/train.py:sequence_loss``, copied."""
    mag = jnp.sqrt(jnp.sum(flow_gt**2, axis=-1))
    valid = mag < max_flow
    if valid_mask is not None:
        valid = valid & valid_mask
    n = len(flow_preds)
    total = 0.0
    for i, pred in enumerate(flow_preds):
        w = gamma ** (n - 1 - i)
        l1 = jnp.sum(jnp.abs(pred - flow_gt), axis=-1)
        total = total + w * jnp.sum(l1 * valid) / jnp.maximum(jnp.sum(valid), 1)
    return total


def _flow_gt(seed=4):
    flow = (np.random.RandomState(seed).randn(2, 64, 64, 2) * 3).astype(
        np.float32)
    flow[0, :4, :4] = 500.0  # past the 400 px mask
    return flow


def test_sequence_loss_matches_jax_and_masks_large_flows():
    rng = np.random.RandomState(5)
    flow = _flow_gt()
    preds = [rng.randn(2, 64, 64, 2).astype(np.float32) for _ in range(3)]
    want = float(jax_sequence_loss([jnp.asarray(p) for p in preds],
                                   jnp.asarray(flow)))
    got = sequence_loss([nchw(p) for p in preds], nchw(flow))
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    moved = [p.copy() for p in preds]
    for p in moved:
        p[0, :4, :4] += 1e3  # where the gt is masked: no change
    again = sequence_loss([nchw(p) for p in moved], nchw(flow))
    assert float(again) == pytest.approx(float(got), rel=1e-6)
    # where it is not: the last prediction weighs 1, over the valid pixels
    before = np.abs(moved[-1][1, 10, 10] - flow[1, 10, 10]).sum()
    moved[-1][1, 10, 10] = flow[1, 10, 10] + 5.0
    third = sequence_loss([nchw(p) for p in moved], nchw(flow))
    count = 2 * 64 * 64 - 16
    assert float(third) - float(got) == pytest.approx(
        (10.0 - before) / count, rel=1e-2)


def test_flow_train_step_matches_jax():
    jm, variables, make = case("narrow")
    n = CASES["narrow"][1]
    flow = _flow_gt()

    def jstep(v, a, b, f):
        def loss_fn(p):
            preds, mut = jm.apply(
                {"params": p, "batch_stats": v["batch_stats"]}, a, b,
                train=True, num_flow_updates=n, mutable=["batch_stats"])
            return jax_sequence_loss(preds, f), mut
        (loss, mut), g = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
        g = jax.tree_util.tree_map(lambda t: jnp.clip(t, -1.0, 1.0), g)
        return loss, {"params": g, "batch_stats": mut["batch_stats"]}

    loss, tree = jax.tree_util.tree_map(
        np.asarray, jax.jit(jstep)(variables, X1, X2, flow))
    model = port_of(make, variables)
    opt = torch.optim.AdamW(model.parameters(), lr=4e-4, weight_decay=1e-4)
    got = make_flow_train_step(model, opt, num_flow_updates=n)(
        {"image1": nchw(X1), "image2": nchw(X2), "flow": nchw(flow)})
    assert abs(float(got["loss"]) - loss) <= LOSS_TOL * abs(loss)
    want = jax_placements(model, tree)
    names = [name for name, _ in model.named_parameters()]
    have = np.concatenate([p.grad.numpy().ravel()
                           for p in model.parameters()])
    assert float(np.abs(have).max()) <= 1.0  # clipped
    assert _err(have, np.concatenate([want[k].ravel() for k in names]), 0.0,
                norm=True) <= UPDATE_TOL
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert _err(buf.numpy(), want[name], 1e-3) <= 1e-5, name


def test_bf16_model_promotes_its_update_block_to_f32():
    """As flax promotes: the encoders compute in bf16, the volume, the
    lookup, the coordinates, the update block and the flows in f32; the
    flows within 2e-2 of the f32 model's."""
    _, variables, make = case("narrow")
    model = port_of(make, variables)
    with torch.no_grad():
        want = model(nchw(X1), nchw(X2))[-1]
        model16 = model.to(torch.bfloat16)
        feats = model16.feature_encoder(nchw(X1).bfloat16())
        got = model16(nchw(X1).bfloat16(), nchw(X2).bfloat16())[-1]
    assert feats.dtype == torch.bfloat16 and got.dtype == torch.float32
    assert rel(got.numpy(), want.numpy()) <= 2e-2


def test_preset_matches_jax():
    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, 256, (3, 20, 30), np.uint8) for _ in range(2))
    want = JPreset()(jnp.asarray(a.transpose(1, 2, 0)),
                     jnp.asarray(b.transpose(1, 2, 0)))
    got = OpticalFlow(device="cpu")(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(2, 0, 1),
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["raft_large", "raft_small"])
def test_builder_matches_jax_weights_and_parameter_count(name):
    model = get_model(name, device="meta")
    want = jweights(name)
    assert sum(p.numel() for p in model.parameters()) == \
        want.DEFAULT.meta["num_params"]
    got = get_model_weights(name)
    assert list(got.__members__) == list(want.__members__)
    for member in want.__members__:
        w, g = want[member], got[member]
        assert g.value.url == w.url
        for key in ("num_params", "_metrics", "_ops"):
            assert g.meta[key] == w.meta[key], key
        assert g.transforms is OpticalFlow and w.transforms is JPreset


def test_builders_run_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")  # never here: the CPU suite
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("raft_small")
    model = get_model("raft_small", device="cpu")
    assert not model.training and model.mask_predictor is None
    with torch.no_grad():
        flows = model(torch.rand(1, 3, 64, 64) * 2 - 1,
                      torch.rand(1, 3, 64, 64) * 2 - 1, num_flow_updates=2)
    assert len(flows) == 2 and flows[-1].shape == (1, 2, 64, 64)
