"""Shared pieces of the per-sample transform parity tests
(``tests/test_torch_tv_tensors.py``, ``test_torch_transforms_sample.py``,
``test_torch_transforms_classes.py``, ``test_torch_recipe_presets.py``):
numpy-seeded samples, their JAX twins (channels last: an image ``[C, H,
W]`` is ``(H, W, C)`` there, a video ``[T, C, H, W]`` is ``(T, H, W,
C)``), and the capture of the draws a JAX transform made, to hand to the
port through ``Replay``."""

from __future__ import annotations

from typing import Any, Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vision_tpu import tv_tensors as jtv
from vision_tpu.transforms.v2 import _transform as jtransform
from vision_tpu_torch import tv_tensors as tv

H, W = 48, 64
KEYPOINTS = 17


def image(seed: int = 0, h: int = H, w: int = W, c: int = 3) -> np.ndarray:
    """uint8 ``(H, W, C)``: smooth gradients plus noise, so that resizes and
    colour ops see structure rather than pure noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy[..., None] * 3 + xx[..., None] * 2 + np.arange(c) * 40) % 200
    noise = rng.integers(0, 56, (h, w, c))
    return (base + noise).astype(np.uint8)


def boxes(seed: int = 0, n: int = 6, h: int = H, w: int = W) -> np.ndarray:
    """f32 XYXY boxes inside an ``h x w`` canvas, one of them degenerate
    (under a pixel wide)."""
    rng = np.random.default_rng(seed + 100)
    xy = rng.random((n, 2)) * np.array([w * 0.7, h * 0.7])
    wh = rng.random((n, 2)) * np.array([w * 0.5, h * 0.5]) + 2.0
    b = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1)
    b[0, 2] = b[0, 0] + 0.5
    return b.astype(np.float32)


def masks(seed: int = 0, n: int = 6, h: int = H, w: int = W) -> np.ndarray:
    rng = np.random.default_rng(seed + 200)
    return (rng.random((n, h, w)) < 0.4).astype(np.uint8)


def keypoints(seed: int = 0, n: int = 6, h: int = H, w: int = W) -> np.ndarray:
    """f32 ``(n, 17, 3)``: (x, y) inside the canvas, visibility 0 or 2."""
    rng = np.random.default_rng(seed + 300)
    xy = rng.random((n, KEYPOINTS, 2)) * np.array([w - 1, h - 1])
    vis = np.where(rng.random((n, KEYPOINTS, 1)) < 0.25, 0.0, 2.0)
    return np.concatenate([xy, vis], -1).astype(np.float32)


def detection_sample(seed: int = 0, h: int = H, w: int = W, n: int = 6,
                     with_masks: bool = True, with_keypoints: bool = True):
    """The port's ``(Image, target)`` and the JAX twin."""
    img, b = image(seed, h, w), boxes(seed, n, h, w)
    labels = np.arange(1, n + 1, dtype=np.int64)
    port_t: Dict[str, Any] = {
        "boxes": tv.BoundingBoxes(torch.from_numpy(b), format="XYXY",
                                  canvas_size=(h, w)),
        "labels": torch.from_numpy(labels)}
    jax_t: Dict[str, Any] = {
        "boxes": jtv.BoundingBoxes(b, format="XYXY", canvas_size=(h, w)),
        "labels": labels}
    if with_masks:
        m = masks(seed, n, h, w)
        port_t["masks"] = tv.Mask(torch.from_numpy(m))
        jax_t["masks"] = jtv.Mask(m)
    if with_keypoints:
        k = keypoints(seed, n, h, w)
        port_t["keypoints"] = tv.KeyPoints(torch.from_numpy(k), canvas_size=(h, w))
        jax_t["keypoints"] = jtv.KeyPoints(k, canvas_size=(h, w))
    port = (tv.Image(torch.from_numpy(img.transpose(2, 0, 1).copy())), port_t)
    return port, (jtv.Image(img), jax_t)


def to_numpy_port_layout(x: Any) -> np.ndarray:
    """A JAX leaf in the port's layout, as numpy."""
    if isinstance(x, jtv.TVTensor):
        arr = np.asarray(x.data)
        if isinstance(x, (jtv.Image, jtv.Video)):
            return np.moveaxis(arr, -1, -3)
        return arr
    return np.asarray(x)


def port_numpy(x: Any) -> np.ndarray:
    return x.as_subclass(torch.Tensor).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def leaves_match(got: Any, want: Any) -> List[tuple]:
    """(port leaf, JAX leaf in the port's layout) pairs of two samples of
    one structure, the metadata checked on the way."""
    # both flattened by jax.tree_util: dict keys sorted alike
    got_leaves = jax.tree_util.tree_flatten(got)[0]
    want_leaves = jax.tree_util.tree_flatten(
        want, is_leaf=lambda x: isinstance(x, jtv.TVTensor))[0]
    assert len(got_leaves) == len(want_leaves)
    pairs = []
    for g, w in zip(got_leaves, want_leaves):
        if isinstance(w, jtv.BoundingBoxes):
            assert isinstance(g, tv.BoundingBoxes)
            assert g.format.value == w.format.value
            assert g.canvas_size == w.canvas_size
        if isinstance(w, jtv.KeyPoints):
            assert isinstance(g, tv.KeyPoints) and g.canvas_size == w.canvas_size
        for jt, pt in ((jtv.Image, tv.Image), (jtv.Mask, tv.Mask),
                       (jtv.Video, tv.Video)):
            if isinstance(w, jt):
                assert isinstance(g, pt), (type(g), type(w))
        pairs.append((port_numpy(g), to_numpy_port_layout(w)))
    return pairs


def from_jax_params(params: Any) -> Any:
    """A JAX ``make_params`` result for the port: arrays as tensors, the
    rest as it is."""
    if isinstance(params, dict):
        return {k: from_jax_params(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(from_jax_params(v) for v in params)
    if isinstance(params, (jax.Array, np.ndarray)):
        arr = np.asarray(params)
        return torch.from_numpy(arr.copy()) if arr.ndim else arr.item()
    return params


def draws(t) -> bool:
    """Whether the port's counterpart of JAX transform ``t`` draws (and so
    takes an entry of a ``Replay``)."""
    return (isinstance(t, jtransform._RandomApplyTransform)
            or hasattr(t, "_apply_op")
            or type(t).make_params is not jtransform.Transform.make_params)


class Spy(jtransform.Transform):
    """JAX transform ``inner``, its draws appended to ``log`` as the port's
    params: the ``make_params`` result, a gated transform's ``{"applied":
    bool, **params}``, an auto-augment policy's applied ops ``{"ops":
    [(name, magnitude), ...], "key": its key}``."""

    def __init__(self, inner, log: List[Dict[str, Any]]):
        self.inner, self.log = inner, log
        if hasattr(inner, "_apply_op"):
            op = type(inner)._apply_op

            def apply_op(img, name, mag):
                self.log[-1]["ops"].append((name, float(mag)))
                return op(inner, img, name, mag)

            inner._apply_op = apply_op
        else:
            make = type(inner).make_params

            def make_params(flat, k):
                params = make(inner, flat, k)
                self.log.append(from_jax_params(params))
                return params

            inner.make_params = make_params

    def __call__(self, *inputs, key=None):
        at = len(self.log)
        if hasattr(self.inner, "_apply_op"):
            self.log.append({"ops": [], "key": key})
        out = self.inner(*inputs, key=key)
        if isinstance(self.inner, jtransform._RandomApplyTransform):
            if len(self.log) > at:
                self.log[at] = {"applied": True, **self.log[at]}
            else:
                self.log.append({"applied": False})
        return out


def spy(t, log: List[Dict[str, Any]]):
    """``t``, or a JAX ``Compose``'s transforms, wrapped in ``Spy`` where
    they draw."""
    if hasattr(t, "transforms"):
        t.transforms = [spy(u, log) for u in t.transforms]
        return t
    return Spy(t, log) if draws(t) else t


def key(seed: int) -> jax.Array:
    return jax.random.PRNGKey(seed)



def augmix_params(entry: Dict[str, Any], severity_ops: List = None,
                  width: int = 3, alpha: float = 1.0) -> Dict[str, Any]:
    """A JAX AugMix call's draws as the port's params: the ops it applied
    (``entry["ops"]``), and its Beta and Dirichlet weights and chain
    depths drawn again from its key (``entry["key"]``), split as
    ``vision_tpu/transforms/v2/_auto_augment.py`` splits it."""
    k = entry["key"]
    kd, km = jax.random.split(k)
    weights = np.asarray(jax.random.dirichlet(
        km, jnp.array([alpha] * width, jnp.float32))).tolist()
    mix_weight = float(jax.random.beta(kd, alpha, alpha))
    chains, kk, at, ops = [], k, 0, entry["ops"]
    for _ in range(width):
        kk, kc = jax.random.split(kk)
        kd_i, _ = jax.random.split(kc)
        depth = int(jax.random.randint(kd_i, (), 1, 4))
        chains.append(ops[at:at + depth])
        at += depth
    assert at == len(ops)
    return {"mix_weight": mix_weight, "weights": weights, "chains": chains}


def port_log(log: List[Dict[str, Any]], augmix: bool = False):
    """``Spy``'s log for ``Replay``: the keys dropped, an AugMix entry made
    whole (``augmix_params``)."""
    out = []
    for entry in log:
        if "key" in entry:
            entry = (augmix_params(entry) if augmix
                     else {"ops": entry["ops"]})
        out.append(entry)
    return out
