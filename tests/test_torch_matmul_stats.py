"""``matmul_stats`` parity: the port's plain PyTorch version and its
``autograd.Function`` (``vision_tpu_torch.ops._conv1x1_bn``, CPU path)
against the JAX package's Pallas kernel in interpret mode, its reference
implementation, and ``jax.grad`` of its custom VJP.

Tolerances. f32: ``y`` within 1e-5 of the largest ``|y|`` and the sums
within 1e-5 of the largest sum (the products add up in another order).
bf16: ``y`` within one bf16 step of the largest ``|y|`` (each side rounds
once an f32 sum that differs in its last places; a step is 2**-8 to 2**-7
of the value it rounds), the sums within
2e-3 of the largest (a flipped rounding of one ``y`` moves a sum by up to
2**-8 of that value). Gradients: rtol 1e-4, atol 1e-3, as the JAX
package's own test of the VJP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.ops._pallas.conv1x1_bn import _reference_impl
from vision_tpu.ops._pallas.conv1x1_bn import matmul_stats as jax_matmul_stats
from vision_tpu_torch.ops._conv1x1_bn import (
    choose_kernel,
    matmul_stats,
    matmul_stats_cuda,
    matmul_stats_plain,
)

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, m, k, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            (rng.randn(k, n) * 0.05).astype(np.float32),
            (rng.rand(k) + 0.5).astype(np.float32),
            (rng.randn(k) * 0.1).astype(np.float32))


def _check(got, want, dtype):
    y, s1, s2 = (t.float().numpy() for t in got)
    yr, s1r, s2r = (np.asarray(a, np.float32) for a in want)
    y_tol, s_tol = (1e-5, 1e-5) if dtype == "float32" else (2.0 ** -7, 2e-3)
    assert got[0].dtype == _TDT[dtype]
    assert got[1].dtype == got[2].dtype == torch.float32
    assert np.abs(y - yr).max() <= y_tol * np.abs(yr).max()
    assert np.abs(s1 - s1r).max() <= s_tol * np.abs(s1r).max()
    assert np.abs(s2 - s2r).max() <= s_tol * np.abs(s2r).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", [False, True])
def test_plain_matches_pallas_interpret(dtype, prologue):
    x, w, sc, sh = _inputs(0, 224, 256, 128)
    jargs = (jnp.asarray(sc), jnp.asarray(sh)) if prologue else ()
    want = jax_matmul_stats(jnp.asarray(x, _JDT[dtype]),
                            jnp.asarray(w, _JDT[dtype]), *jargs,
                            interpret=True)
    targs = (torch.from_numpy(sc), torch.from_numpy(sh)) if prologue else ()
    got = matmul_stats_plain(torch.from_numpy(x).to(_TDT[dtype]),
                             torch.from_numpy(w).to(_TDT[dtype]), *targs)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", [False, True])
def test_plain_matches_reference_at_a_ragged_shape(dtype, prologue):
    """M, K, N that no tile divides: the JAX wrapper itself gives way to
    its reference there."""
    x, w, sc, sh = _inputs(1, 203, 77, 45)
    jargs = (jnp.asarray(sc), jnp.asarray(sh)) if prologue else (None, None)
    want = _reference_impl(jnp.asarray(x, _JDT[dtype]),
                           jnp.asarray(w, _JDT[dtype]), *jargs)
    targs = (torch.from_numpy(sc), torch.from_numpy(sh)) if prologue else ()
    got = matmul_stats(torch.from_numpy(x).to(_TDT[dtype]),
                       torch.from_numpy(w).to(_TDT[dtype]), *targs)
    _check(got, want, dtype)


def test_statistics_are_those_of_the_rounded_output():
    x, w, _, _ = _inputs(2, 64, 32, 16)
    y, s1, s2 = matmul_stats_plain(torch.from_numpy(x).bfloat16(),
                                   torch.from_numpy(w).bfloat16())
    assert torch.equal(s1, y.float().sum(0))
    assert torch.equal(s2, (y.float() ** 2).sum(0))


def _loss_jax(fn):
    def inner(*args):
        y, s1, s2 = fn(*args)
        k = jnp.arange(s1.shape[0], dtype=jnp.float32)
        return (jnp.sum(y.astype(jnp.float32) ** 2) * 1e-2
                + jnp.sum(s1 * k) + jnp.sum(jnp.sqrt(s2 + 1.0)))
    return inner


def _loss_torch(y, s1, s2):
    k = torch.arange(s1.shape[0], dtype=torch.float32)
    return ((y.float() ** 2).sum() * 1e-2 + (s1 * k).sum()
            + torch.sqrt(s2 + 1.0).sum())


@pytest.mark.parametrize("prologue", [False, True])
def test_function_gradients_match_jax_grad(prologue):
    x, w, sc, sh = _inputs(3, 128, 64, 32)
    w = w * 2.0
    arrays = (x, w, sc, sh) if prologue else (x, w)
    want = jax.grad(
        _loss_jax(lambda *a: jax_matmul_stats(*a, interpret=True)),
        argnums=tuple(range(len(arrays))),
    )(*(jnp.asarray(a) for a in arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    _loss_torch(*matmul_stats(*leaves)).backward()
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-3)


def test_function_backward_matches_autograd_of_the_plain_version():
    """The hand-written backward against autograd through
    ``matmul_stats_plain``: rtol 1e-4, atol 1e-4 (f32, same products)."""
    x, w, sc, sh = _inputs(4, 96, 40, 24)
    grads = []
    for fn in (matmul_stats, matmul_stats_plain):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, sc, sh)]
        _loss_torch(*fn(*leaves)).backward()
        grads.append([leaf.grad for leaf in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_an_unused_sum_counts_as_a_zero_gradient():
    x, w, _, _ = _inputs(5, 32, 16, 8)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y, _, _ = matmul_stats(xt, wt)
    y.sum().backward()
    torch.testing.assert_close(xt.grad, torch.from_numpy(w).sum(1).expand(32, 16))
    torch.testing.assert_close(wt.grad, torch.from_numpy(x).sum(0)[:, None].expand(16, 8))


def test_cpu_tensors_never_reach_the_kernel():
    x, w, sc, sh = (torch.from_numpy(a) for a in _inputs(6, 16, 8, 4))
    before = matmul_stats_cuda.launches
    matmul_stats(x, w, sc, sh)
    assert matmul_stats_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        matmul_stats_cuda(x, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", [False, True])
def test_a_transposed_view_of_w_gives_what_its_copy_gives(dtype, prologue):
    """``w`` as the ``.t()`` view of a ``[N, K]`` weight against its
    contiguous copy: the same values reach the same products, so ``y``, the
    sums and every gradient are equal bit for bit, in both types."""
    x, w, sc, sh = _inputs(7, 96, 40, 24)
    grads, outs = [], []
    for as_view in (True, False):
        xt = torch.from_numpy(x).to(_TDT[dtype]).requires_grad_()
        wt = torch.from_numpy(np.ascontiguousarray(w.T)).to(_TDT[dtype])
        wt.requires_grad_()  # the [N, K] weight, as a conv holds it
        wm = wt.t() if as_view else wt.t().contiguous()
        assert wm.is_contiguous() != as_view
        leaves = [xt, wt]
        args = [xt, wm]
        if prologue:
            leaves += [torch.from_numpy(a).requires_grad_() for a in (sc, sh)]
            args += leaves[2:]
        out = matmul_stats(*args)
        _loss_torch(*out).backward()
        outs.append([o.detach() for o in out])
        grads.append([leaf.grad for leaf in leaves])
    for a, b in zip(outs[0] + grads[0], outs[1] + grads[1]):
        assert torch.equal(a, b)


# (M, K, N, prologue) of the 36 products of a ResNet-50 forward at batch 32
_RESNET50_CASES = [
    (100352, 64, 64, False), (100352, 64, 256, True), (100352, 64, 256, False),
    (100352, 256, 64, False), (100352, 256, 128, False),
    (25088, 128, 512, True), (25088, 256, 512, False), (25088, 512, 128, False),
    (25088, 512, 256, False),
    (6272, 256, 1024, True), (6272, 512, 1024, False), (6272, 1024, 256, False),
    (6272, 1024, 512, False),
    (1568, 512, 2048, True), (1568, 1024, 2048, False), (1568, 2048, 512, False),
]


@pytest.mark.parametrize("dtype,want", [(torch.float32, "fma"),
                                        (torch.bfloat16, "wgmma")])
@pytest.mark.parametrize("m,k,n,prologue", _RESNET50_CASES)
def test_resnet50_products_never_take_the_general_kernel(m, k, n, prologue,
                                                         dtype, want):
    """Both as the transposed view of the conv weight (strides ``(1, K)``)
    and as a contiguous ``[K, N]`` matrix (strides ``(N, 1)``)."""
    assert choose_kernel(m, k, n, dtype, (1, k)) == want
    assert choose_kernel(m, k, n, dtype, (n, 1)) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,w_strides,aligned", [
    (203, 77, 45, (45, 1), True),     # nothing divides
    (203, 77, 48, (48, 1), True),     # K is not a whole number of 16 bytes
    (203, 72, 45, (1, 72), True),     # N is not
    (130, 0, 8, (8, 1), True),        # K = 0
    (1, 1, 1, (1, 1), True),
    (64, 64, 64, (128, 2), True),     # no unit stride
    (64, 64, 64, (1, 65), True),      # rows of w off the 16-byte grid
    (64, 64, 64, (64, 1), False),     # a pointer off the 16-byte grid
    (1000, 130, 260, (260, 1), True),
])
def test_unaligned_products_always_take_the_general_kernel(m, k, n, w_strides,
                                                           aligned, dtype):
    assert choose_kernel(m, k, n, dtype, w_strides, aligned) == "general"


@pytest.mark.parametrize("m,k,n,w_strides,want32,want16", [
    (203, 72, 40, (40, 1), "fma", "wgmma"),   # ragged M, 16-byte rows
    (203, 72, 40, (1, 72), "fma", "wgmma"),
    (50, 36, 44, (44, 1), "fma", "general"),  # 16-byte rows in f32 only
    (50, 4, 4, (1, 4), "fma", "general"),
])
def test_the_choice_follows_the_16_byte_unit_of_the_type(m, k, n, w_strides,
                                                         want32, want16):
    assert choose_kernel(m, k, n, torch.float32, w_strides) == want32
    assert choose_kernel(m, k, n, torch.bfloat16, w_strides) == want16


def test_the_resnet_weight_matrix_is_a_view():
    from vision_tpu_torch.models.resnet import _matrix

    conv = torch.nn.Conv2d(24, 40, 1, bias=False)
    wm = _matrix(conv)
    assert wm.shape == (24, 40) and wm.stride() == (1, 24)
    assert wm.data_ptr() == conv.weight.data_ptr()
