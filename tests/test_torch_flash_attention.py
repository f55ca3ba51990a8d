"""The flash-attention branch of the port against the JAX package's on the
CPU: ``flash_attention_plain`` and the two backward plain versions against
``vision_tpu.ops.attention.scaled_dot_product_attention`` with the flash
branch forced (``VISION_TPU_FLASH_ATTENTION=1``) and JAX's library kernels
run in interpret mode (``pallas_call(..., interpret=True)``, patched for
this file only), forward and ``jax.vjp``; the port's gate against JAX's
``_flash_supported`` with the backend taken for a TPU; the routing of
``scaled_dot_product_attention`` on CPU tensors, at head dims past 128
too (256 and 384: the gate says flash, and the plain versions take any
head dim, forward and, at 256, ``jax.vjp``); the f32 backward kernels'
arithmetic, every product as three TF32 products, emulated in torch and
held against ``jax.vjp`` at the f32 tolerance; the f32 forward kernel's
arithmetic, its two products as three TF32 products, emulated the same way
and held against JAX's flash output and the plain version's ``lse``.

Tolerances, of the largest JAX value: f32 1e-5 (measured ~1e-6: sums in
another order, the library's per-block renormalisation); bf16 1e-2
(measured ~4e-3: one bf16 step at the largest output, since the library
rounds ``p`` to bf16 against the running maximum of each 128-key block and
the plain version against the row's maximum).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jflash

from vision_tpu.ops import attention as jattention
from vision_tpu_torch.ops import attention as A

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = [(2, 2, 577, 64), (1, 2, 300, 128)]


@pytest.fixture(scope="module")
def jax_flash():
    """The JAX package's flash branch, forced, with the library's
    ``pallas_call`` in interpret mode; undone after this file's tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VISION_TPU_FLASH_ATTENTION", "1")
        mp.setattr(jflash.pl, "pallas_call",
                   functools.partial(jflash.pl.pallas_call, interpret=True))
        yield jattention.scaled_dot_product_attention


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=[(s, dt) for s in SHAPES
                                        for dt in ("float32", "bfloat16")],
                ids=lambda p: f"{'x'.join(map(str, p[0]))}-{p[1]}")
def case(request, jax_flash):
    """Seeded q, k, v, do; JAX's flash output and ``vjp`` through its
    dK/dV and dQ kernels, once per shape and type."""
    shape, dt = request.param
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(t, JDT[dt]) for t in (q, k, v, do))
    out, vjp = jax.vjp(jax_flash, jq, jk, jv)
    grads = vjp(jdo)
    to_np = lambda t: np.asarray(t.astype(jnp.float32))  # noqa: E731
    torch_in = [torch.from_numpy(t).to(TDT[dt]) for t in (q, k, v, do)]
    return dt, torch_in, to_np(out), [to_np(g) for g in grads]


def test_forward_plain_matches_the_jax_flash_branch(case):
    dt, (q, k, v, _), want, _ = case
    o, lse = A.flash_attention_plain(q, k, v)
    assert o.dtype == TDT[dt] and lse.dtype == torch.float32
    assert lse.shape == q.shape[:3]
    assert _rel(o.float().numpy(), want) <= TOL[dt]


def test_backward_plain_matches_jax_grad_through_the_flash_kernels(case):
    dt, (q, k, v, do), _, want = case
    o, lse = A.flash_attention_plain(q, k, v)
    got = A.flash_attention_backward_plain(q, k, v, o, do, lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == TDT[dt] and g.shape == q.shape
        assert _rel(g.float().numpy(), w) <= TOL[dt], name


def test_lse_is_the_log_of_the_softmax_normaliser():
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 40, 64)) for _ in range(3))
    _, lse = A.flash_attention_plain(q, k, v)
    s = q.double() @ k.double().transpose(-2, -1) / 8.0
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 256])
def test_gate_matches_jax_on_a_tpu(monkeypatch, d):
    """Every (s, d) of a grid around the gate's edges, JAX's backend taken
    for a TPU and its env override unset."""
    monkeypatch.delenv("VISION_TPU_FLASH_ATTENTION", raising=False)
    monkeypatch.setattr(jattention.jax, "default_backend", lambda: "tpu")
    for s in (1, 17, 197, 256, 511, 512, 577, 1025, 1370):
        want = jattention._flash_supported(np.zeros((1, 1, s, d), np.float32))
        got = A._flash_supported(torch.empty(1, 1, s, d, device="meta"))
        assert got == want, (s, d)


def test_routing_on_the_cpu_takes_the_plain_versions():
    counts = [A.flash_attention_forward_cuda.launches,
              A.flash_attention_dkv_cuda.launches,
              A.flash_attention_dq_cuda.launches]
    rng = np.random.RandomState(2)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, 577, 64).astype(np.float32))
                   for _ in range(4))
    assert torch.equal(A.scaled_dot_product_attention(q, k, v),
                       A.flash_attention_plain(q, k, v)[0])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = A.scaled_dot_product_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    o, lse = A.flash_attention_plain(q, k, v)
    want = A.flash_attention_backward_plain(q, k, v, o, do, lse)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    # below the gate: the einsum path's arithmetic
    short = [t[:, :, :197] for t in (q, k, v)]
    assert torch.equal(A.scaled_dot_product_attention(*short),
                       A.attention_plain(*short))
    assert counts == [A.flash_attention_forward_cuda.launches,
                      A.flash_attention_dkv_cuda.launches,
                      A.flash_attention_dq_cuda.launches]


WIDE = [((1, 2, 40, 256), "float32"), ((1, 2, 40, 256), "bfloat16"),
        ((1, 1, 40, 384), "float32")]


def _wide(jax_flash, shape, dt, seed, grads):
    """Seeded q, k, v, do as torch tensors of type ``dt``; JAX's flash
    output, and with ``grads`` its ``vjp``, as f32 numpy arrays."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(*shape).astype(np.float32) for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(t, JDT[dt]) for t in arrays)
    to_np = lambda t: np.asarray(t.astype(jnp.float32))  # noqa: E731
    if grads:
        out, vjp = jax.vjp(jax_flash, jq, jk, jv)
        want_grads = [to_np(g) for g in vjp(jdo)]
    else:
        out, want_grads = jax_flash(jq, jk, jv), None
    torch_in = [torch.from_numpy(t).to(TDT[dt]) for t in arrays]
    return torch_in, to_np(out), want_grads


@pytest.mark.parametrize("shape,dt", WIDE,
                         ids=[f"d{s[-1]}-{dt}" for s, dt in WIDE])
def test_a_head_dim_past_128_takes_the_plain_versions_on_the_cpu(
        jax_flash, shape, dt):
    """256 and 384 are multiples of 128: the gate says flash, and on CPU
    tensors the plain versions take any head dim, as JAX's CPU path does
    (no kernel is built for them; the card refuses them,
    ``test_torch_flash_attention_cuda.py``)."""
    (q, k, v, _), want, _ = _wide(jax_flash, shape, dt, 3, grads=False)
    assert A._flash_supported(q)
    out = A.scaled_dot_product_attention(q, k, v)
    assert out.dtype == TDT[dt] and out.shape == q.shape
    assert torch.equal(out, A.flash_attention_plain(q, k, v)[0])
    assert _rel(out.float().numpy(), want) <= TOL[dt]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_a_head_dim_past_128_has_jax_gradients_on_the_cpu(jax_flash, dt):
    """``[1, 2, 40, 256]`` through autograd of the port's
    ``scaled_dot_product_attention`` against ``jax.vjp`` through JAX's
    dK/dV and dQ kernels in interpret mode."""
    (q, k, v, do), _, want = _wide(jax_flash, (1, 2, 40, 256), dt, 4,
                                   grads=True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(A.scaled_dot_product_attention(*leaves),
                                leaves, do)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.dtype == TDT[dt] and g.shape == q.shape
        assert _rel(g.float().numpy(), w) <= TOL[dt], name


def _tf32(x):
    """f32 rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero, on the int32 view (``cvt.rna.tf32.f32``'s rounding, which the
    kernels do on the bits)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """f32 with its low 13 bits dropped: how the tensor core reads a tf32
    operand that holds more bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """``a @ b`` as the f32 backward kernels take it on the tensor cores:
    ``x = hi + lo``, ``hi = tf32(x)``, ``lo = x - hi`` (read truncated to
    tf32), and ``a_hi b_lo + a_lo b_hi + a_hi b_hi`` summed in f32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32_truncated(a - a_hi), _tf32_truncated(b - b_hi)
    return a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi


def _mm_tf32(a, b):
    """``a @ b`` as one TF32 product (the operands rounded once)."""
    return _tf32(a) @ _tf32(b)


def _backward_emulated(mm, q, k, v, do, lse, di, scale):
    """``(dq, dk, dv)`` in the f32 dK/dV and dQ kernels' arithmetic, every
    product taken by ``mm``: ``p = exp(scale q k^T - lse)``, ``dv = p^T
    do``, ``ds = p (do v^T - di) scale``, ``dk = ds^T q``, ``dq = ds k``."""
    p = torch.exp(mm(q, k.transpose(-2, -1)) * scale - lse[..., None])
    dv = mm(p.transpose(-2, -1), do)
    ds = p * (mm(do, v.transpose(-2, -1)) - di[..., None]) * scale
    return mm(ds, k), mm(ds.transpose(-2, -1), q), dv


@pytest.mark.parametrize("case", [(s, "float32") for s in SHAPES],
                         indirect=True,
                         ids=[f"{'x'.join(map(str, s))}-float32"
                              for s in SHAPES])
def test_3xtf32_backward_arithmetic_matches_jax_grad(case):
    """The f32 kernels' products as three TF32 products stay within the
    f32 tolerance of ``jax.vjp`` through JAX's dK/dV and dQ kernels; the
    same arithmetic with one TF32 product a product does not, so the check
    tells the two apart."""
    dt, (q, k, v, do), _, want = case
    o, lse = A.flash_attention_plain(q, k, v)
    di = A._di(o, do)
    scale = 1.0 / q.shape[-1] ** 0.5
    got = _backward_emulated(_mm_3xtf32, q, k, v, do, lse, di, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == q.shape
        assert _rel(g.numpy(), w) <= TOL[dt], name
    one = _backward_emulated(_mm_tf32, q, k, v, do, lse, di, scale)
    assert min(_rel(g.numpy(), w) for g, w in zip(one, want)) > TOL[dt]


def _forward_emulated(mm, q, k, v, scale):
    """``(o, lse)`` in the f32 forward kernel's arithmetic, both products
    taken by ``mm``: ``s = scale q k^T``, ``p = exp(s - m)``, ``o = p v /
    l``, ``lse = m + log(l)``."""
    s = mm(q, k.transpose(-2, -1)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return mm(p, v) / l, (m + torch.log(l)).squeeze(-1)


@pytest.mark.parametrize("case", [(s, "float32") for s in SHAPES],
                         indirect=True,
                         ids=[f"{'x'.join(map(str, s))}-float32"
                              for s in SHAPES])
def test_3xtf32_forward_arithmetic_matches_jax_flash(case):
    """The f32 forward kernel's products as three TF32 products stay within
    the f32 tolerance of JAX's flash output, and its ``lse`` within 1e-5 of
    the plain version's; one TF32 product a product misses both, so the
    check tells the two apart."""
    dt, (q, k, v, _), want, _ = case
    _, want_lse = A.flash_attention_plain(q, k, v)
    scale = 1.0 / q.shape[-1] ** 0.5
    o, lse = _forward_emulated(_mm_3xtf32, q, k, v, scale)
    assert o.dtype == torch.float32 and o.shape == q.shape
    assert _rel(o.numpy(), want) <= TOL[dt]
    assert float((lse - want_lse).abs().max()) <= 1e-5
    o, lse = _forward_emulated(_mm_tf32, q, k, v, scale)
    assert _rel(o.numpy(), want) > TOL[dt]
    assert float((lse - want_lse).abs().max()) > 1e-5
