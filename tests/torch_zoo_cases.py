"""Shared pieces of the classification-zoo parity tests
(``tests/test_torch_zoo_*.py``): a JAX module with seeded numpy variables
and the port's model carrying them, and the checks every family runs.

Tolerances: eval-mode f32 logits and every named feature within 1e-5 of
the largest JAX value; bf16 logits within 2e-2 of the largest JAX bf16
logit, or, where JAX's own bf16 logits lie further than that from its f32
ones (VGG-11 with batch norm: 2.5e-2), no further from those than twice
JAX's distance. Training mode: a train-mode forward's logits within 1e-5 of the
largest and its updated running statistics within 1e-5 of each tensor's
largest value (at least 1e-3); one SGD step (no stochastic depth, no
dropout): the loss within 1e-5 relative, the update of all parameters
together (the gradient times the learning rate) within 1e-3 by relative
Frobenius norm, and the running statistics within 1e-5 -- of JAX's f32
result, or else no further from JAX's same function run in f64
(``jax.enable_x64``) than twice JAX's f32 result is. Batch statistics
over a small batch and a small map amplify f32 round-off in either
library (a deep MobileNetV2 at 32x32 and batch 4: JAX's f32 train-mode
logits lie 8e-4 from f64), so the f32 reference is only that sharp; and a
deep randomly initialised network has pre-activations within round-off
of a ReLU's kink, whose flips move single gradients of Inception v3 by up
to 40% of their largest value in JAX's f32 step (where the port's lie
within 3e-4 of f64), so the update is held as a whole, by norm, as the
v2 detectors' gradients are.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision_tpu.parallel import train as jtrain
from vision_tpu_torch._jax_convert import (
    _leaves,
    _torch_name,
    jax_placements,
    load_jax_variables,
)
from vision_tpu_torch.parallel import make_train_step

LOGITS_TOL = 1e-5
BF16_TOL = 2e-2
STATS_TOL = 1e-5
LOSS_TOL = 1e-5
UPDATE_TOL = 1e-3
LR = 0.1


def random_variables(module, x, seed: int = 0) -> Dict:
    """Seeded numpy values in the shapes of ``module.init`` (traced, not
    run): kernels N(0, 1/fan_in), norm scales and variances in [0.5,
    1.5), every other leaf N(0, 0.1^2)."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf in ("scale", "var"):
            return rng.random(s.shape, np.float32) + np.float32(0.5)
        std = (1.0 / np.sqrt(np.prod(s.shape[:-1])) if leaf == "kernel"
               else 0.1)
        return rng.standard_normal(s.shape, np.float32) * np.float32(std)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def images(n: int, h: int, w: Optional[int] = None, seed: int = 0):
    return np.random.RandomState(seed).randn(n, h, w or h, 3).astype(np.float32)


def as_port(feature, channels_last: bool = False) -> np.ndarray:
    """A JAX feature (NHWC) in the port's layout: NCHW, unless the port's
    is channels-last too (Swin)."""
    feature = np.asarray(feature)
    if feature.ndim == 4 and not channels_last:
        feature = feature.transpose(0, 3, 1, 2)
    return feature


class Pair:
    """``module`` (flax) with seeded variables for inputs like ``x``, and
    ``make_port()`` carrying them in eval mode; ``channels_last``: the
    port's features are NHWC (Swin), else NCHW."""

    def __init__(self, module, make_port: Callable[[], torch.nn.Module],
                 x: np.ndarray, seed: int = 0, channels_last: bool = False):
        self.module = module
        self.channels_last = channels_last
        self.make_port = make_port
        self.variables = random_variables(module, jnp.asarray(x[:1]), seed)
        self.port = self.fresh()
        self.has_stats = "batch_stats" in self.variables
        self.features = "return_features" in inspect.signature(
            module.__call__).parameters

    def fresh(self, dtype=torch.float32) -> torch.nn.Module:
        with torch.device("meta"):  # no initialisation: the load sets all
            port = self.make_port()
        port = port.to_empty(device="cpu")
        load_jax_variables(port, self.variables)
        return port.eval().to(dtype)


def check_forward(pair: Pair, x: np.ndarray) -> None:
    """f32 logits and every named feature against JAX's eval forward."""
    kw = {"return_features": True} if pair.features else {}
    out = jax.jit(lambda v, t: pair.module.apply(v, t, **kw))(
        pair.variables, jnp.asarray(x))
    with torch.no_grad():
        got = pair.port(nchw(x), **kw)
    if not pair.features:
        assert rel(got.numpy(), out) <= LOGITS_TOL
        return
    (want, jfeats), (got, feats) = out, got
    assert rel(got.numpy(), want) <= LOGITS_TOL
    assert sorted(feats) == sorted(jfeats)  # jit sorts a dict's keys
    for name, f in jfeats.items():
        want = as_port(f, pair.channels_last)
        assert rel(feats[name].numpy(), want) <= LOGITS_TOL, name


def check_bf16(pair: Pair, x: np.ndarray) -> None:
    """The model cast to bf16 against JAX's variables cast to bf16; or, where
    JAX's bf16 logits lie further than that from its f32 ones, the port's
    no further from them than twice as far."""
    cast = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  pair.variables)
    want = jax.jit(pair.module.apply)(cast, jnp.asarray(x, jnp.bfloat16))
    want = np.asarray(want, np.float32)
    port = pair.fresh(torch.bfloat16)
    with torch.no_grad():
        got = port(nchw(x).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    if rel(got, want) <= BF16_TOL:
        return
    f32 = jax.jit(pair.module.apply)(pair.variables, jnp.asarray(x))
    assert rel(got, f32) <= 2.0 * rel(want, f32)


def _in_x64(fn, *trees):
    """``fn(*trees)`` with every float leaf in f64, under JAX's x64 mode;
    the result as numpy arrays."""
    with jax.enable_x64(True):
        trees = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if np.issubdtype(np.asarray(a).dtype, np.floating) else a, trees)
        return jax.tree_util.tree_map(np.asarray, fn(*trees))


def _err(got, want, floor: float, norm: bool = False) -> float:
    """The largest difference over the largest value (at least ``floor``),
    or with ``norm`` the relative Frobenius norm of the difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if norm:
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  floor)


def _as_sharp(got, f32, f64, tol: float, floor: float, what: str,
              norm: bool = False) -> None:
    """``got`` (the port, f32) within ``tol`` of JAX's f32 result, or no
    further from the f64 reference (``f64()``, run only here) than twice
    JAX's f32 result is."""
    if _err(got, f32, floor, norm) <= tol:
        return
    f64 = f64()
    assert _err(got, f64, floor, norm) <= 2.0 * _err(f32, f64, floor, norm), what


def _train_forward(module, has_stats):
    mutable = ["batch_stats"] if has_stats else False
    return jax.jit(lambda v, t: module.apply(v, t, train=True,
                                             mutable=mutable))


def check_train_forward(pair: Pair, x: np.ndarray) -> None:
    """A train-mode forward (batch statistics, no stochastic layer drawn):
    the logits, and the running statistics it leaves."""
    port = pair.fresh().train()
    with torch.no_grad():
        got = port(nchw(x))
    fn = _train_forward(pair.module, pair.has_stats)
    f32 = jax.tree_util.tree_map(np.asarray, fn(pair.variables, x))
    f64 = functools.lru_cache(None)(lambda: _in_x64(fn, pair.variables, x))
    if not pair.has_stats:
        _as_sharp(got.numpy(), f32, f64, LOGITS_TOL, 1e-30, "logits")
        return
    if isinstance(got, tuple):  # the auxiliary heads' named tuple
        assert type(got).__name__ == type(f32[0]).__name__
        assert got._fields == f32[0]._fields
        for i, field in enumerate(got._fields):
            _as_sharp(got[i].numpy(), f32[0][i], lambda i=i: f64()[0][i],
                      LOGITS_TOL, 1e-30, field)
    else:
        _as_sharp(got.numpy(), f32[0], lambda: f64()[0], LOGITS_TOL, 1e-30,
                  "logits")
    buffers = dict(port.named_buffers())
    for i, (path, want) in enumerate(_leaves(f32[1]["batch_stats"])):
        name = _torch_name("batch_stats", path)
        _as_sharp(buffers[name].numpy(), want,
                  lambda i=i: list(_leaves(f64()[1]["batch_stats"]))[i][1],
                  STATS_TOL, 1e-3, name)


def check_sgd_step(pair: Pair, x: np.ndarray, labels: np.ndarray) -> None:
    """One SGD step of ``make_train_step`` against JAX's: the loss, each
    parameter's update and the running statistics."""
    tx = optax.sgd(LR)
    module = pair.module
    if pair.has_stats:
        apply = module.apply
    else:
        def apply(v, images, train, rngs, mutable):
            # JAX's step passes mutable=[] without batch statistics, where
            # flax returns (logits, {}) and the step expects the logits
            return module.apply(v, images, train=train, rngs=rngs)
    jstep = jtrain.make_train_step(apply, tx, has_batch_stats=pair.has_stats,
                                   donate=False)

    def step(variables, images):
        params = variables["params"]
        state = jtrain.TrainState(params, variables.get("batch_stats", {}),
                                  tx.init(params), jnp.zeros((), jnp.int32))
        state, metrics = jstep(state, {"image": images,
                                       "label": jnp.asarray(labels)},
                               jax.random.PRNGKey(0))
        after = {"params": state.params, "batch_stats": state.batch_stats}
        return ({k: v for k, v in after.items() if k in variables},
                metrics["loss"])

    f32 = jax.tree_util.tree_map(np.asarray, step(pair.variables, x))
    f64 = functools.lru_cache(None)(lambda: _in_x64(step, pair.variables, x))

    port = pair.fresh()
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = torch.optim.SGD(port.parameters(), lr=LR)
    got = make_train_step(port, opt)({"image": nchw(x),
                                      "label": torch.from_numpy(labels).long()})
    _as_sharp(float(got["loss"]), f32[1], lambda: f64()[1], LOSS_TOL, 1e-30,
              "loss")

    old = jax_placements(port, pair.variables)
    new32 = jax_placements(port, f32[0])
    new64 = functools.lru_cache(None)(lambda: jax_placements(port, f64()[0]))

    def update(tensors):
        return np.concatenate([(tensors[n] - old[n]).ravel() for n in before])

    have = np.concatenate([(p.detach() - before[n]).numpy().ravel()
                           for n, p in port.named_parameters()])
    _as_sharp(have, update(new32), lambda: update(new64()), UPDATE_TOL, 0.0,
              "update", norm=True)
    buffers = dict(port.named_buffers())
    for name in set(old) - set(before):
        _as_sharp(buffers[name].numpy(), new32[name],
                  lambda name=name: new64()[name], STATS_TOL, 1e-3, name)


def check_loads_shapes(jax_name: str, port_name: str) -> None:
    """The JAX builder's variables (shapes only, no init) place onto the
    port builder's model on the meta device, leaf for leaf, nothing left
    over, and the port's parameter count is the JAX meta's."""
    from vision_tpu.models import get_model as jget, get_model_weights
    from vision_tpu.models._utils import abstract_init
    from vision_tpu_torch.models import get_model

    with abstract_init():
        shapes = jget(jax_name).variables
    zeros = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)), shapes)
    port = get_model(port_name, device="meta")
    jax_placements(port, zeros)
    want = get_model_weights(jax_name).DEFAULT.meta["num_params"]
    assert sum(p.numel() for p in port.parameters()) == want


# One builder of each structural variant loads its JAX variables in the
# default run; the others (the same modules at other widths and depths,
# their parameter counts checked in ``test_torch_zoo_registry.py``) are
# ``slow``, as ``tests/test_models_golden.py``'s sweep is: tracing a JAX
# builder's init for its shapes takes 1-4 s.
REPRESENTATIVES = {
    "efficientnet_b0", "efficientnet_v2_s", "convnext_tiny", "swin_t",
    "swin_v2_t", "maxvit_t", "mobilenet_v2", "mobilenet_v3_large",
    "mobilenet_v3_small", "mnasnet0_5", "shufflenet_v2_x0_5", "squeezenet1_0",
    "squeezenet1_1", "regnet_y_400mf", "regnet_x_400mf", "alexnet", "vgg11",
    "vgg11_bn", "densenet121", "googlenet", "inception_v3",
}


def sweep(names):
    return [pytest.param(n, marks=() if n in REPRESENTATIVES
                         else pytest.mark.slow) for n in names]
