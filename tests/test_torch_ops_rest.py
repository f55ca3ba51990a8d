"""The rest of ``ops/`` in the port (``roi_pool``, ``ps_roi_align``,
``ps_roi_pool``, ``drop_block2d/3d``, ``stochastic_depth``, the misc layers
and the module wrappers) against the JAX package's functions on the CPU,
with the same seeded numpy inputs (NHWC on the JAX side, NCHW in the port)
and, for the layers, the same weights through ``load_jax_variables``.

Tolerances:
- ``roi_pool``, ``ps_roi_align`` (sampling ratios 0, 1 and 2, RoIs partly
  off the map, RoIs smaller than a bin, one whose adaptive grid is taller
  than the map) and ``ps_roi_pool``: forward within 1e-5 of the largest
  output, the input gradient against ``jax.vjp`` of the same cotangent
  within 1e-5 of its largest value (f32 sums in another order);
- ``drop_block2d``, ``drop_block3d`` and ``stochastic_depth`` with JAX's
  draws handed across: exactly equal. Their own draws from a
  ``torch.Generator``: the keep (or seed) count of ``n`` draws within 5
  standard deviations of the binomial mean, ``|k - n q| <= 5 sqrt(n q (1 -
  q))``;
- the misc layers and the wrappers: 1e-5 of the largest output; updated
  running statistics 1e-5 of their largest value;
- the argument checks raise ``ValueError`` where JAX's do.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.ops import _wrappers as jwrap
from vision_tpu.ops import misc as jmisc
from vision_tpu.ops.drop_block import drop_block2d as jdrop2d
from vision_tpu.ops.drop_block import drop_block3d as jdrop3d
from vision_tpu.ops.ps_roi_align import ps_roi_align as jps_align
from vision_tpu.ops.ps_roi_pool import ps_roi_pool as jps_pool
from vision_tpu.ops.roi_pool import roi_pool as jroi_pool
from vision_tpu.ops.stochastic_depth import stochastic_depth as jsd
from vision_tpu_torch import ops
from vision_tpu_torch._jax_convert import load_jax_variables
from vision_tpu_torch.ops.drop_block import drop_block_seeds
from vision_tpu_torch.ops.misc import BatchNorm2d, BatchNorm3d
from vision_tpu_torch.ops.stochastic_depth import stochastic_depth_keep

H, W = 12, 15
SCALE = 0.5
# (batch, x1, y1, x2, y2) in image coordinates (the map is 2x smaller):
# inside, partly off the map on each side, smaller than a bin, the whole
# map, and one whose adaptive grid (sampling ratio <= 0) is taller and
# wider than the map
FIXED_ROIS = np.array([
    [0, 2.0, 3.0, 20.0, 18.0],
    [1, -6.0, -4.0, 10.0, 9.0],
    [0, 20.0, 14.0, 40.0, 33.0],
    [1, 7.3, 5.1, 8.1, 6.2],
    [0, 0.0, 0.0, 29.0, 23.0],
    [1, -150.0, -120.0, 250.0, 200.0],
], np.float32)


def _rois(seed=0, n=10):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(-4, 26, (n, 2))
    wh = rs.uniform(0.5, 16, (n, 2))
    rand = np.concatenate([rs.randint(0, 2, (n, 1)), xy, xy + wh], 1)
    return np.concatenate([FIXED_ROIS, rand.astype(np.float32)])


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{err} > {rel}"


def _nchw(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(a, -1, 1) if a.ndim >= 3 else a))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


# ------------------------------------------------------------ RoI poolers

POOLERS = {
    "roi_pool": (ops.roi_pool, jroi_pool, {}),
    "ps_roi_pool": (ops.ps_roi_pool, jps_pool, {}),
    "ps_roi_align_sr0": (ops.ps_roi_align, jps_align, {"sampling_ratio": 0}),
    "ps_roi_align_sr1": (ops.ps_roi_align, jps_align, {"sampling_ratio": 1}),
    "ps_roi_align_sr2": (ops.ps_roi_align, jps_align, {"sampling_ratio": 2}),
}


@pytest.mark.parametrize("name", list(POOLERS))
def test_pooler_forward_and_gradient(name):
    port_fn, jax_fn, kw = POOLERS[name]
    size = (3, 2) if name.startswith("ps") else (4, 3)
    channels = 2 * size[0] * size[1] if name.startswith("ps") else 5
    rs = np.random.RandomState(1)
    x = rs.randn(2, H, W, channels).astype(np.float32)
    rois = _rois()
    want, vjp = jax.vjp(jax.jit(
        lambda a: jax_fn(a, jnp.asarray(rois), size, SCALE, **kw)), jnp.asarray(x))
    cot = rs.randn(*want.shape).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(cot))
    xt = _nchw(x).requires_grad_()
    got = port_fn(xt, torch.from_numpy(rois), size, SCALE, **kw)
    assert tuple(got.shape) == (len(rois), want.shape[-1], *size)
    _close(_nhwc(got), want, 1e-5)
    got.backward(_nchw(cot))
    _close(_nhwc(xt.grad), jgrad, 1e-5)
    assert np.abs(np.asarray(want)).max() > 0 and np.abs(np.asarray(jgrad)).max() > 0


@pytest.mark.parametrize("name", ["roi_pool", "ps_roi_pool", "ps_roi_align_sr2"])
def test_pooler_keeps_bf16_and_computes_in_f32(name):
    port_fn, _, kw = POOLERS[name]
    size = (3, 2) if name.startswith("ps") else (4, 3)
    channels = 2 * size[0] * size[1] if name.startswith("ps") else 5
    x = torch.from_numpy(np.random.RandomState(2).randn(2, channels, H, W)
                         .astype(np.float32))
    rois = torch.from_numpy(_rois())
    got = port_fn(x.bfloat16(), rois, size, SCALE, **kw)
    want = port_fn(x.bfloat16().float(), rois, size, SCALE, **kw)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


def test_ps_roi_align_reads_the_position_sensitive_channels():
    """Output channel ``c`` at bin ``(ph, pw)`` reads input channel ``(c PH +
    ph) PW + pw``: a map whose channel ``i`` is the constant ``i`` pools to
    that index at every bin of a RoI inside the map."""
    ph, pw, c_out = 3, 2, 2
    x = torch.arange(c_out * ph * pw, dtype=torch.float32)[None, :, None, None]
    x = x.expand(1, -1, H, W).contiguous()
    rois = torch.tensor([[0, 4.0, 4.0, 20.0, 16.0]])
    for fn in (ops.ps_roi_align, ops.ps_roi_pool):
        out = fn(x, rois, (ph, pw), SCALE)
        idx = (torch.arange(c_out)[:, None, None] * ph
               + torch.arange(ph)[None, :, None]) * pw + torch.arange(pw)
        torch.testing.assert_close(out[0], idx.float(), rtol=0, atol=1e-6)


# ----------------------------------------------------- the random ops

def _jax_bernoulli(key, q, shape_nhwc):
    return np.asarray(jax.random.bernoulli(key, q, shape_nhwc))


@pytest.mark.parametrize("block,p", [(3, 0.2), (4, 0.3), (20, 0.1)],
                         ids=["odd", "even", "larger_than_the_map"])
def test_drop_block2d_with_jax_seeds_is_exact(block, p):
    x = np.random.RandomState(3).randn(2, H, W, 4).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jdrop2d(jnp.asarray(x), p, block, key=key))
    bs = min(block, H, W)
    gamma = (p * H * W) / ((bs ** 2) * ((H - bs + 1) * (W - bs + 1)))
    seeds = _jax_bernoulli(key, gamma, (2, H - bs + 1, W - bs + 1, 4))
    assert seeds.any()
    got = ops.drop_block2d(_nchw(x), p, block, seeds=_nchw(seeds))
    np.testing.assert_array_equal(_nhwc(got), want)
    # in place: the same bits, in the input's storage
    xt = _nchw(x)
    out = ops.drop_block2d(xt, p, block, inplace=True, seeds=_nchw(seeds))
    assert out.data_ptr() == xt.data_ptr()
    np.testing.assert_array_equal(_nhwc(xt), want)


@pytest.mark.parametrize("block", [3, 2])
def test_drop_block3d_with_jax_seeds_is_exact(block):
    t, p = 5, 0.25
    x = np.random.RandomState(4).randn(2, t, 6, 7, 3).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = np.asarray(jdrop3d(jnp.asarray(x), p, block, key=key))
    bs = min(block, t, 6, 7)
    gamma = (p * t * 6 * 7) / ((bs ** 3) * ((t - bs + 1) * (6 - bs + 1) * (7 - bs + 1)))
    seeds = _jax_bernoulli(key, gamma, (2, t - bs + 1, 6 - bs + 1, 7 - bs + 1, 3))
    assert seeds.any()
    got = ops.drop_block3d(_nchw(x), p, block, seeds=_nchw(seeds))
    np.testing.assert_array_equal(_nhwc(got), want)


@pytest.mark.parametrize("mode", ["row", "batch"])
@pytest.mark.parametrize("p", [0.3, 1.0])
def test_stochastic_depth_with_jax_draws_is_exact(mode, p):
    x = np.random.RandomState(5).randn(16, 3, 4, 5).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jsd(jnp.asarray(x), p, mode, key=key))
    size = (16, 1, 1, 1) if mode == "row" else (1, 1, 1, 1)
    keep = _jax_bernoulli(key, 1.0 - p, size)
    got = ops.stochastic_depth(torch.from_numpy(x), p, mode,
                               keep=torch.from_numpy(keep.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


def _binomial_ok(k, n, q):
    return abs(k - n * q) <= 5 * np.sqrt(n * q * (1 - q))


def test_stochastic_depth_keep_rate():
    g = torch.Generator().manual_seed(0)
    n, p = 40_000, 0.3
    keep = stochastic_depth_keep((n, 2, 3), p, "row", g)
    assert keep.shape == (n, 1, 1)
    assert _binomial_ok(int(keep.sum()), n, 1 - p)
    coins = [bool(stochastic_depth_keep((4, 3), p, "batch", g)) for _ in range(2000)]
    assert _binomial_ok(sum(coins), 2000, 1 - p)
    # the function draws the same mask from the same generator state
    x = torch.randn(64, 3, 2, 2, generator=g)
    state = g.get_state()
    got = ops.stochastic_depth(x, p, "row", generator=g)
    g.set_state(state)
    keep = stochastic_depth_keep(x.shape, p, "row", g)
    torch.testing.assert_close(got, x * (keep.float() / (1 - p)), rtol=0,
                               atol=0)


def test_drop_block_seed_rate():
    g = torch.Generator().manual_seed(1)
    p, block = 0.1, 7
    shape = (32, 16, 56, 56)
    seeds = drop_block_seeds(shape, p, block, g)
    assert seeds.shape == (32, 16, 50, 50)
    gamma = (p * 56 * 56) / (block ** 2 * 50 * 50)
    assert _binomial_ok(int(seeds.sum()), seeds.numel(), gamma)
    x = torch.randn(shape, generator=g)
    out = ops.drop_block2d(x, p, block, generator=g)
    dropped = float((out == 0).float().mean())
    # the seeds' blocks overlap, so a little under p of the map is dropped
    assert 0.07 < dropped < p, dropped


# ----------------------------------------------------------- misc layers

def _spread(variables, seed):
    """The variables moved away from their identity init (batch norms'
    affine terms and statistics included), as numpy."""
    rs = np.random.RandomState(seed)

    def move(path, v):
        v = np.asarray(v)
        if str(path[-1]) in ("['var']",):
            return rs.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        return (v + rs.randn(*v.shape) * 0.2).astype(v.dtype)

    return jax.tree_util.tree_map_with_path(move, variables)


def test_conv2d_norm_activation_eval_and_train():
    rs = np.random.RandomState(6)
    x = rs.randn(2, 9, 11, 6).astype(np.float32)
    jm = jmisc.Conv2dNormActivation(out_channels=8, kernel_size=3, stride=2,
                                    groups=2, dilation=2)
    variables = _spread(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    port = ops.Conv2dNormActivation(6, 8, 3, stride=2, groups=2, dilation=2)
    load_jax_variables(port, variables)
    assert [type(m) for m in port] == [torch.nn.Conv2d, BatchNorm2d, torch.nn.ReLU]
    assert port[0].bias is None
    port.eval()
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), jm.apply(variables, jnp.asarray(x)), 1e-5)
    want, mut = jm.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), want, 1e-5)
    _close(port[1].running_mean.numpy(), mut["batch_stats"]["1"]["mean"], 1e-5)
    _close(port[1].running_var.numpy(), mut["batch_stats"]["1"]["var"], 1e-5)


def test_conv3d_norm_activation():
    x = np.random.RandomState(7).randn(2, 4, 6, 7, 3).astype(np.float32)
    jm = jmisc.Conv3dNormActivation(out_channels=5, kernel_size=3, stride=(1, 2, 2))
    variables = _spread(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    port = ops.Conv3dNormActivation(3, 5, 3, stride=(1, 2, 2))
    load_jax_variables(port, variables)
    assert isinstance(port[1], BatchNorm3d)
    port.eval()
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), jm.apply(variables, jnp.asarray(x)), 1e-5)
    want, mut = jm.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), want, 1e-5)
    _close(port[1].running_var.numpy(), mut["batch_stats"]["1"]["var"], 1e-5)


def test_squeeze_excitation():
    x = np.random.RandomState(8).randn(2, 5, 6, 12).astype(np.float32)
    jm = jmisc.SqueezeExcitation(input_channels=12, squeeze_channels=4)
    variables = _spread(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    port = ops.SqueezeExcitation(12, 4)
    load_jax_variables(port, variables)
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), jm.apply(variables, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("norm", [False, True], ids=["plain", "batch_norm"])
def test_mlp(norm):
    x = np.random.RandomState(9).randn(6, 10).astype(np.float32)
    jnorm = (functools.partial(fnn.BatchNorm, use_running_average=True)
             if norm else None)
    jm = jmisc.MLP(hidden_channels=(16, 12, 7), norm_layer=jnorm, dropout=0.5)
    variables = _spread(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    port = ops.MLP(10, (16, 12, 7), norm_layer=BatchNorm2d if norm else None,
                   dropout=0.5).eval()
    load_jax_variables(port, variables)
    linear = [n for n, m in port.named_children() if isinstance(m, torch.nn.Linear)]
    # torchvision's indices: Linear, [norm], activation, Dropout per layer
    assert linear == (["0", "4", "8"] if norm else ["0", "3", "6"])
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(), jm.apply(variables, jnp.asarray(x)),
               1e-5)
    port.train()
    with pytest.raises(ValueError, match="generator"):
        port(torch.from_numpy(x))
    out = port(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert out.shape == (6, 7)


def test_permute():
    x = np.random.RandomState(10).randn(2, 3, 4, 5).astype(np.float32)
    want = jmisc.Permute(dims=(0, 2, 3, 1)).apply({}, jnp.asarray(x))
    got = ops.Permute([0, 2, 3, 1])(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------- wrappers

@pytest.mark.parametrize("name", ["RoIAlign", "RoIPool", "PSRoIAlign", "PSRoIPool"])
def test_roi_wrappers(name):
    ps = name.startswith("PS")
    size = (3, 2)
    x = np.random.RandomState(11).randn(2, H, W, 12 if ps else 5).astype(np.float32)
    rois = _rois(1)
    args = {"RoIAlign": (size, SCALE, 2, True), "RoIPool": (size, SCALE),
            "PSRoIAlign": (size, SCALE, 0), "PSRoIPool": (size, SCALE)}[name]
    want = jax.jit(getattr(jwrap, name)(*args))(jnp.asarray(x), jnp.asarray(rois))
    module = getattr(ops, name)(*args)
    assert isinstance(module, torch.nn.Module)
    assert not list(module.parameters())
    with torch.no_grad():
        got = module(_nchw(x), torch.from_numpy(rois))
    _close(_nhwc(got), want, 1e-5)


def test_random_wrappers():
    x = torch.randn(8, 4, 9, 9, generator=torch.Generator().manual_seed(2))
    for module, fn, args in (
            (ops.StochasticDepth(0.4, "row"), ops.stochastic_depth, (0.4, "row")),
            (ops.DropBlock2d(0.3, 3), ops.drop_block2d, (0.3, 3))):
        module.eval()
        assert module(x) is x
        module.train()
        with pytest.raises(ValueError, match="generator"):
            module(x)
        got = module(x, generator=torch.Generator().manual_seed(3))
        want = fn(x, *args, generator=torch.Generator().manual_seed(3))
        assert torch.equal(got, want) and not torch.equal(got, x)
    x3 = torch.randn(2, 3, 5, 6, 7, generator=torch.Generator().manual_seed(4))
    got = ops.DropBlock3d(0.3, 2)(x3, generator=torch.Generator().manual_seed(5))
    want = ops.drop_block3d(x3, 0.3, 2, generator=torch.Generator().manual_seed(5))
    assert torch.equal(got, want)


# ----------------------------------------------------- argument checks

def _both_raise(port_call, jax_call, match):
    with pytest.raises(ValueError, match=match):
        port_call()
    with pytest.raises(ValueError, match=match):
        jax_call()


def test_argument_errors():
    x4 = np.zeros((2, 6, 7, 12), np.float32)
    x5 = np.zeros((2, 3, 6, 7, 2), np.float32)
    key = jax.random.PRNGKey(0)
    rois = _rois()[:3]
    t4, t5 = _nchw(x4), _nchw(x5)
    g = torch.Generator()
    for p in (-0.1, 1.5):
        _both_raise(lambda: ops.stochastic_depth(t4, p, "row", generator=g),
                    lambda: jsd(jnp.asarray(x4), p, "row", key=key),
                    "drop probability")
        _both_raise(lambda: ops.drop_block2d(t4, p, 3, generator=g),
                    lambda: jdrop2d(jnp.asarray(x4), p, 3, key=key),
                    "drop probability")
    _both_raise(lambda: ops.stochastic_depth(t4, 0.2, "col", generator=g),
                lambda: jsd(jnp.asarray(x4), 0.2, "col", key=key), "mode")
    _both_raise(lambda: ops.stochastic_depth(t4, 0.2, "row"),
                lambda: jsd(jnp.asarray(x4), 0.2, "row"), "requires a")
    _both_raise(lambda: ops.drop_block2d(t5, 0.2, 3, generator=g),
                lambda: jdrop2d(jnp.asarray(x5), 0.2, 3, key=key), "expected 4D")
    _both_raise(lambda: ops.drop_block3d(t4, 0.2, 3, generator=g),
                lambda: jdrop3d(jnp.asarray(x4), 0.2, 3, key=key), "expected 5D")
    _both_raise(lambda: ops.drop_block2d(t4, 0.2, 3),
                lambda: jdrop2d(jnp.asarray(x4), 0.2, 3), "requires a")
    _both_raise(lambda: ops.ps_roi_align(t4, torch.from_numpy(rois), (5, 5)),
                lambda: jps_align(jnp.asarray(x4), jnp.asarray(rois), (5, 5)),
                "not divisible")
    _both_raise(lambda: ops.ps_roi_pool(t4, torch.from_numpy(rois), (5, 5)),
                lambda: jps_pool(jnp.asarray(x4), jnp.asarray(rois), (5, 5)),
                "not divisible")
    # evaluation mode and p = 0 return the input untouched, drawing nothing
    assert ops.stochastic_depth(t4, 0.5, "row", training=False) is t4
    assert ops.drop_block2d(t4, 0.0, 3) is t4
    with pytest.raises(ValueError, match="shape"):
        ops.stochastic_depth(t4, 0.2, "row", keep=torch.ones(1, 1, 1, 1))
    with pytest.raises(ValueError, match="shape"):
        ops.drop_block2d(t4, 0.2, 3, seeds=torch.ones(2, 12, 6, 7))


def test_port_exports_every_jax_op():
    import vision_tpu.ops as jops

    missing = set(jops.__all__) - set(ops.__all__)
    assert missing == {"qnms", "qroi_align"}
    for name in ops.__all__:
        assert getattr(ops, name) is not None
