"""The long-sequence ViT, the port against ``vision_tpu`` on the CPU: a
2-layer ViT at 384 px (patch 16, hidden 128, 2 heads: head dim 64 and 577
tokens, past the flash-attention gate) with JAX's seeded flax weights
carried across by ``load_jax_variables``; the JAX side takes its flash
branch (``VISION_TPU_FLASH_ATTENTION=1``, the library's ``pallas_call`` in
interpret mode, both for this file only), the port its flash plain
versions. Also the parameter counts of the two SWAG configurations on the
meta device.

Tolerances: logits and every layer's features 1e-5 of the largest (f32);
bf16 logits 2e-2 of the largest JAX bf16 logit, and no further from f32
than twice JAX's own bf16 run; one step (label smoothing 0.11, soft
labels): the loss and the gradient norm 1e-5, each gradient 1e-4 of its
largest value (at least 1e-3), the key bias's rows left out (its gradient
is round-off on both sides, ``tests/test_torch_vit.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jflash

from vision_tpu.models import vision_transformer as jvit
from vision_tpu.parallel import train as jtrain
from vision_tpu_torch._jax_convert import load_jax_variables
from vision_tpu_torch.models import vision_transformer as tvit
from vision_tpu_torch.ops import attention as A
from vision_tpu_torch.parallel import cross_entropy_loss

LONG = dict(image_size=384, patch_size=16, num_layers=2, num_heads=2,
            hidden_dim=128, mlp_dim=256, num_classes=10)
SMOOTHING = 0.11


@pytest.fixture(scope="module")
def vit():
    """JAX's model with its flash branch forced and interpreted, its seeded
    variables, and the port carrying them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VISION_TPU_FLASH_ATTENTION", "1")
        mp.setattr(jflash.pl, "pallas_call",
                   functools.partial(jflash.pl.pallas_call, interpret=True))
        module = jvit.VisionTransformer(**LONG)
        x = jnp.zeros((1, 384, 384, 3))
        variables = jax.jit(module.init)(jax.random.PRNGKey(0), x)
        variables = jax.tree_util.tree_map(np.asarray, variables)
        port = tvit.VisionTransformer(**LONG)
        load_jax_variables(port, variables)
        yield module, variables, port.eval()


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).randn(2, 384, 384, 3).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_the_path_is_past_the_gate(vit):
    _, _, port = vit
    block = port.encoder.layers[0].self_attention
    assert port.encoder.pos_embedding.shape == (1, 577, 128)
    assert A._flash_supported(torch.empty(1, block.num_heads, 577, 64,
                                          device="meta"))


def test_load_jax_variables_carries_the_384_model(vit):
    _, variables, port = vit
    np.testing.assert_array_equal(
        port.encoder.pos_embedding.detach().numpy(),
        variables["params"]["encoder.pos_embedding"])
    kernel = variables["params"]["encoder.layers.encoder_layer_1"][
        "self_attention"]["in_proj"]["kernel"]
    np.testing.assert_array_equal(
        port.encoder.layers.encoder_layer_1.self_attention.in_proj_weight
        .detach().numpy(), kernel.T)


def test_forward_matches_jax_flash(vit, images):
    module, variables, port = vit
    want, jfeats = jax.jit(lambda v, x: module.apply(
        v, x, return_features=True))(variables, jnp.asarray(images))
    with torch.no_grad():
        got, feats = port(_nchw(images), return_features=True)
    assert _rel(got.numpy(), want) <= 1e-5
    assert set(feats) == set(jfeats)
    for name in jfeats:
        assert _rel(feats[name].numpy(), jfeats[name]) <= 1e-5, name


def test_bf16_forward_matches_jax_flash(vit, images):
    module, variables, _ = vit
    cast = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  variables)
    want = np.asarray(module.apply(cast, jnp.asarray(images, jnp.bfloat16)),
                      np.float32)
    want32 = module.apply(variables, jnp.asarray(images))
    port16 = tvit.VisionTransformer(**LONG)
    load_jax_variables(port16, variables)
    port16 = port16.eval().to(torch.bfloat16)
    with torch.no_grad():
        got = port16(_nchw(images).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= 2e-2
    assert _rel(got.float().numpy(), want32) <= 2 * max(_rel(want, want32), 1e-3)


def test_one_step_matches_jax_grad(vit, images):
    module, variables, _ = vit
    rng = np.random.RandomState(3)
    soft = rng.dirichlet(np.ones(10), 2).astype(np.float32)

    def jloss(p):
        logits = module.apply({"params": p}, jnp.asarray(images))
        return jtrain.cross_entropy_loss(logits, jnp.asarray(soft), SMOOTHING)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        variables["params"])
    want_norm = float(optax.global_norm(want_grads))

    port = tvit.VisionTransformer(**LONG)
    load_jax_variables(port, variables)
    port.train()
    loss = cross_entropy_loss(port(_nchw(images)), torch.from_numpy(soft),
                              SMOOTHING)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                for p in port.parameters())))
    assert norm == pytest.approx(want_norm, rel=1e-5)

    ref = tvit.VisionTransformer(**LONG)
    load_jax_variables(ref, {"params": jax.tree_util.tree_map(np.asarray,
                                                              want_grads)})
    grads = dict(port.named_parameters())
    for name, want in ref.named_parameters():
        want = want.detach().numpy()
        have = grads[name].grad.numpy()
        if name.endswith("in_proj_bias"):
            want, have = (np.concatenate([t[:128], t[256:]]) for t in (want, have))
        scale = max(float(np.abs(want).max()), 1e-3)
        assert float(np.abs(have - want).max()) / scale <= 1e-4, name


@pytest.mark.parametrize("cfg,enum", [
    ((384, 16, 12, 12, 768, 3072), "ViT_B_16_Weights"),
    ((512, 16, 24, 16, 1024, 4096), "ViT_L_16_Weights"),
])
def test_swag_parameter_counts(cfg, enum):
    want = getattr(jvit, enum).IMAGENET1K_SWAG_E2E_V1.meta["num_params"]
    assert want == {"ViT_B_16_Weights": 86_859_496,
                    "ViT_L_16_Weights": 305_174_504}[enum]
    with torch.device("meta"):
        model = tvit.VisionTransformer(*cfg)
    assert sum(p.numel() for p in model.parameters()) == want
