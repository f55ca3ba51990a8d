"""Shared pieces of the one-stage and MobileNet detector parity tests
(``tests/test_torch_fcos.py``, ``test_torch_ssd.py``,
``test_torch_ssdlite.py``, ``test_torch_frcnn_mobilenet.py``): seeded
numpy variables for a JAX detector, the port's model carrying them, and
the comparisons.

The variables are drawn by numpy in the shapes of ``module.init`` (traced
by ``jax.eval_shape``, not run): kernels normal of variance ``gain`` (2:
He-normal) over the fan in, norm
scales and variances (``scale``, ``var``, and the frozen batch norms'
``weight`` and ``running_var``) in [0.5, 1.5), every other leaf N(0,
0.1^2). They reach the port through ``_jax_convert.load_jax_variables``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vision_tpu_torch._jax_convert import jax_placements, load_jax_variables

_ONE_ISH = ("scale", "var", "weight", "running_var")


def seeded_variables(module, x: np.ndarray, seed: int = 0, gain: float = 2.0,
                     **init_kw) -> Dict:
    """Numpy variables of ``module`` for inputs like ``x`` (module
    docstring), kernels of variance ``gain`` over the fan in."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x), **init_kw))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf in _ONE_ISH and len(s.shape) == 1:
            return rng.random(s.shape, np.float32) + np.float32(0.5)
        if leaf == "kernel":
            std = np.sqrt(gain / np.prod(s.shape[:-1]))
        else:
            std = 0.1
        return rng.standard_normal(s.shape, np.float32) * np.float32(std)

    return jax.tree_util.tree_map(
        np.asarray, jax.tree_util.tree_map_with_path(draw, shapes))


def port_with(make: Callable[[], torch.nn.Module], variables) -> torch.nn.Module:
    """``make()`` (eval mode) carrying the JAX ``variables``."""
    port = make()
    load_jax_variables(port, variables)
    return port.eval()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def rel(got, want) -> float:
    """The largest difference over the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def fro(got, want) -> float:
    """The relative Frobenius norm of the difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def tensors(tree):
    """A pytree of arrays as torch tensors (lists and tuples kept)."""
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def jax_grads_by_name(grads, variables, port: torch.nn.Module
                      ) -> Dict[str, np.ndarray]:
    """JAX gradients (a ``params`` tree) under the port's parameter names,
    in the port's layouts (``jax_placements`` with ``variables``' other
    collections)."""
    placed = jax_placements(port, {**variables, "params": grads})
    return {n: placed[n] for n, _ in port.named_parameters()}


def check_detections(got, want, box_tol: float = 1e-4) -> None:
    """The same valid rows, labels and scores (1e-6) and boxes within
    ``box_tol`` px on them; some rows valid."""
    valid = np.asarray(want.valid)
    assert valid.sum(1).min() > 0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy()[valid],
                                  np.asarray(want.labels)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], rtol=0,
                               atol=box_tol)
    assert got.boxes.dtype == torch.float32


def one_stage_step(port: torch.nn.Module, x: torch.Tensor, boxes, labels,
                   valid, dtype=None):
    """One ``make_detection_train_step(one_stage=True)`` step at lr 0: its
    losses and every gradient, by name."""
    from vision_tpu_torch.parallel import make_detection_train_step

    params = [p for p in port.parameters() if p.requires_grad]
    step = make_detection_train_step(port, torch.optim.SGD(params, lr=0.0),
                                     compute_dtype=dtype, one_stage=True)
    out = step({"image": x, "boxes": boxes, "labels": labels, "valid": valid})
    grads = {n: p.grad.clone() for n, p in port.named_parameters()
             if p.grad is not None}
    port.zero_grad(set_to_none=True)
    return {k: float(v) for k, v in out.items()}, grads


def in_x64(fn, *trees):
    """``fn(*trees)`` with every float leaf in f64, under JAX's x64 mode;
    the result as numpy arrays."""
    with jax.enable_x64(True):
        trees = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if np.issubdtype(np.asarray(a).dtype, np.floating) else a, trees)
        return jax.tree_util.tree_map(np.asarray, fn(*trees))


def check_grads(got: Dict[str, torch.Tensor], want: Dict[str, np.ndarray],
                f64: Optional[Callable[[], Dict[str, np.ndarray]]] = None,
                tol: float = 1e-3) -> float:
    """Every gradient together within ``tol`` of JAX's f32 ones by relative
    Frobenius norm; or, where JAX's f32 gradient is not that sharp (a
    pre-activation within f32 round-off of a ReLU's kink), no further from
    JAX's same function in f64 (``f64()``, run only then) than twice JAX's
    f32 gradient is, the rule of ``torch_zoo_cases.py``. Returns the error
    against the reference used."""
    assert set(got) == set(want), set(got) ^ set(want)
    names = sorted(want)

    def flat(d):
        return np.concatenate([np.asarray(d[n], np.float64).ravel()
                               for n in names])

    mine = flat({n: got[n].numpy() for n in names})
    err = fro(mine, flat(want))
    if err <= tol or f64 is None:
        assert err <= tol, err
        return err
    exact = flat(f64())
    err, jax_err = fro(mine, exact), fro(flat(want), exact)
    assert err <= 2.0 * jax_err, (err, jax_err)
    return err
