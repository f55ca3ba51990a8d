"""ViT and its training recipe, the port against ``vision_tpu`` on the CPU:
a tiny ViT (2 layers, width 64, 4 heads, patch 8, 32x32 images, 10
classes) with JAX's seeded flax weights carried across by
``load_jax_variables``, the same numpy inputs on both sides.

Tolerances: attention 1e-6 (f32), two bf16 roundings in bf16; the forward
1e-5 of the largest logit, through the resized position embedding too; in
bf16 2e-2 of the largest. The recipe: two AdamW steps (warmup + cosine
schedule, global-norm clipping at 1, label smoothing 0.11, MixUp soft
labels) against JAX's ``make_train_step`` with the recipe's
``make_optimizer`` chain: losses 1e-5, the step-1 gradient norm 1e-5,
parameters and the EMA shadow after step 2 1e-4 of each tensor's largest
value (Adam's first steps take ``g / |g|``, which amplifies round-off
where a gradient is near zero).
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision_tpu.models import vision_transformer as jvit
from vision_tpu.ops.attention import scaled_dot_product_attention as jsdpa
from vision_tpu.parallel import train as jtrain
from vision_tpu.transforms import v2 as JT
from vision_tpu_torch._jax_convert import load_jax_variables
from vision_tpu_torch.models import get_model
from vision_tpu_torch.models import vision_transformer as tvit
from vision_tpu_torch.ops.attention import (
    attention_plain,
    scaled_dot_product_attention,
)
from vision_tpu_torch.parallel import (
    ExponentialMovingAverage,
    decay_groups,
    ema_decay,
    lr_schedule,
    make_lr_scheduler,
    make_optimizer,
    make_train_step,
)
from vision_tpu_torch.transforms import v2 as T

_REF = os.path.join(os.path.dirname(__file__), "..", "references",
                    "classification")
TINY = dict(image_size=32, patch_size=8, num_layers=2, num_heads=4,
            hidden_dim=64, mlp_dim=128, num_classes=10)


def _load_cls_train():
    import importlib.util

    sys.path.insert(0, _REF)
    spec = importlib.util.spec_from_file_location(
        "_cls_train", os.path.join(_REF, "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_vit(**kw):
    cfg = {**TINY, **kw}
    module = jvit.VisionTransformer(**cfg)
    x = jnp.zeros((1, cfg["image_size"], cfg["image_size"], 3))
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), x)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = tvit.VisionTransformer(**cfg)
    load_jax_variables(port, variables)
    return module, variables, port.eval()


@pytest.fixture(scope="module")
def tiny():
    return _jax_vit()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-2)])
def test_attention_matches_jax_einsum_path(dtype, tol):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 3, 17, 16).astype(np.float32) for _ in range(3))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jsdpa(*(jnp.asarray(t, jdt) for t in (q, k, v)))
    got = scaled_dot_product_attention(
        *(torch.from_numpy(t).to(dtype) for t in (q, k, v)))
    assert got.dtype == dtype
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= tol
    assert torch.equal(got, attention_plain(
        *(torch.from_numpy(t).to(dtype) for t in (q, k, v))))


@pytest.mark.parametrize("size", [32, 48])
def test_forward_matches_jax(tiny, size):
    """32: the trained grid; 48: the position embedding's 4x4 grid resized
    bicubically to 6x6."""
    module, variables, port = tiny
    x = np.random.RandomState(size).randn(3, size, size, 3).astype(np.float32)
    want, jfeats = jax.jit(lambda v, x: module.apply(
        v, x, return_features=True))(variables, jnp.asarray(x))
    with torch.no_grad():
        got, feats = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                          return_features=True)
    assert _rel(got.numpy(), want) <= 1e-5
    assert set(feats) == set(jfeats)
    for name in jfeats:
        assert _rel(feats[name].numpy(), jfeats[name]) <= 1e-5, name


def test_representation_size_gives_tanh_pre_logits():
    module, variables, port = _jax_vit(representation_size=24)
    assert isinstance(port.heads.act, torch.nn.Tanh)
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    want = module.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert _rel(got.numpy(), want) <= 1e-5


def test_bf16_forward_matches_jax(tiny):
    module, variables, port = tiny
    x = np.random.RandomState(2).randn(3, 32, 32, 3).astype(np.float32)
    cast = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), variables)
    want = module.apply(cast, jnp.asarray(x, jnp.bfloat16))
    want32 = module.apply(variables, jnp.asarray(x))
    port16 = tvit.VisionTransformer(**TINY)
    load_jax_variables(port16, variables)
    port16 = port16.eval().to(torch.bfloat16)
    with torch.no_grad():
        got = port16(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= 2e-2
    # and no further from f32 than JAX's own bf16 run, with room for two
    # independent roundings
    assert _rel(got.float().numpy(), want32) <= 2 * max(
        _rel(np.asarray(want, np.float32), want32), 1e-3)


def test_load_jax_variables_names(tiny):
    """Every flax leaf has a target and every port tensor a source (the
    loader raises otherwise); the packed projection's rows are q, k, v."""
    _, variables, port = tiny
    layer = variables["params"]["encoder.layers.encoder_layer_1"]
    kernel = layer["self_attention"]["in_proj"]["kernel"]  # [D, 3D]
    got = port.encoder.layers.encoder_layer_1.self_attention.in_proj_weight
    np.testing.assert_array_equal(got.detach().numpy(), kernel.T)
    np.testing.assert_array_equal(port.class_token.detach().numpy(),
                                  variables["params"]["class_token"])
    np.testing.assert_array_equal(
        port.encoder.pos_embedding.detach().numpy(),
        variables["params"]["encoder.pos_embedding"])
    assert {k for k, _ in port.named_parameters()} >= {
        "encoder.layers.encoder_layer_0.mlp.0.weight",
        "encoder.layers.encoder_layer_0.mlp.3.bias", "heads.head.weight",
        "encoder.ln.weight", "conv_proj.weight"}


_ENUMS = [("vit_b_16", "ViT_B_16_Weights", m) for m in
          ("IMAGENET1K_V1", "IMAGENET1K_SWAG_E2E_V1", "IMAGENET1K_SWAG_LINEAR_V1")]
_ENUMS += [("vit_b_32", "ViT_B_32_Weights", "IMAGENET1K_V1"),
           ("vit_l_16", "ViT_L_16_Weights", "IMAGENET1K_V1"),
           ("vit_l_16", "ViT_L_16_Weights", "IMAGENET1K_SWAG_E2E_V1"),
           ("vit_l_32", "ViT_L_32_Weights", "IMAGENET1K_V1"),
           ("vit_h_14", "ViT_H_14_Weights", "IMAGENET1K_SWAG_E2E_V1"),
           ("vit_h_14", "ViT_H_14_Weights", "IMAGENET1K_SWAG_LINEAR_V1")]


@pytest.mark.parametrize("builder,enum,member", _ENUMS)
def test_parameter_counts_match_jax_meta(builder, enum, member):
    """Built on the meta device, at the image size of each checkpoint (its
    crop), against the JAX weights' ``meta["num_params"]``; the port's
    enums carry the same numbers."""
    want = getattr(jvit, enum)[member].meta["num_params"]
    assert getattr(tvit, enum)[member].meta["num_params"] == want
    model = get_model(builder, device="meta")
    crop = getattr(tvit, enum)[member].meta["min_size"][0]
    if crop != model.image_size:
        with torch.device("meta"):
            model = tvit.VisionTransformer(
                crop, model.patch_size, len(model.encoder.layers),
                model.encoder.layers[0].self_attention.num_heads,
                model.hidden_dim, model.encoder.layers[0].mlp[0].out_features)
    assert sum(p.numel() for p in model.parameters()) == want


def test_builder_defaults():
    model = get_model("vit_b_16", device="cpu")
    assert not model.training and model.image_size == 224
    assert not model.heads.head.weight.any()  # zero, as published
    assert float(model.encoder.pos_embedding.detach().std()) == pytest.approx(
        0.02, rel=0.05)
    again = get_model("vit_b_16", device="cpu")
    assert torch.equal(model.conv_proj.weight, again.conv_proj.weight)


def test_dropout_draws_from_the_generator():
    model = tvit.VisionTransformer(**TINY, dropout=0.1, attention_dropout=0.1)
    tvit.init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.heads.head.weight.normal_(0.0, 0.1)
    x = torch.randn(2, 3, 32, 32)
    model.eval()
    with torch.no_grad():
        ref = model(x)
    model.train()
    with pytest.raises(ValueError, match="generator"):
        model(x)
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(0))
        b = model(x, generator=torch.Generator().manual_seed(0))
        c = model(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, ref)


def _recipe_args(**kw):
    args = dict(opt="adamw", lr=0.003, weight_decay=0.3, momentum=0.9,
                lr_scheduler="cosineannealinglr", lr_min=0.0,
                lr_warmup_epochs=1, lr_warmup_method="linear",
                lr_warmup_decay=0.033, epochs=3, lr_step_size=30,
                lr_gamma=0.1, clip_grad_norm=1.0, norm_weight_decay=None,
                bias_weight_decay=None, transformer_embedding_decay=None)
    args.update(kw)
    return types.SimpleNamespace(**args)


@pytest.mark.parametrize("kw", [
    {},
    {"lr_min": 1e-4, "lr_warmup_epochs": 2, "lr_warmup_decay": 0.25},
    {"lr_warmup_epochs": 0},
])
def test_lr_schedule_matches_optax(kw):
    """Read off the JAX recipe's optax schedule through plain SGD (gradient
    1, no decay, no momentum): the update is ``-lr(count)``."""
    train = _load_cls_train()
    args = _recipe_args(opt="sgd", momentum=0.0, weight_decay=0.0,
                        clip_grad_norm=None, epochs=6, **kw)
    tx = train.make_optimizer(args, steps_per_epoch=4)
    p = {"w": jnp.ones(())}
    st = tx.init(p)
    sched = lr_schedule(args.lr, args.epochs, 4, args.lr_min,
                        args.lr_warmup_epochs, args.lr_warmup_decay)
    for count in range(30):
        upd, st = tx.update({"w": jnp.ones(())}, st, p)
        assert sched(count) == pytest.approx(-float(upd["w"]), rel=2e-6, abs=1e-9)


def test_decay_groups_follow_the_jax_labels(tiny):
    """``--norm-weight-decay 0 --bias-weight-decay 0.1``: the port's groups
    against JAX's ``_wd_label_tree`` on the same model."""
    train = _load_cls_train()
    _, variables, port = tiny
    labels = train._wd_label_tree(variables["params"])
    want = {"main": 0.3, "norm": 0.0, "bias": 0.1, "embed": 0.3}
    groups = decay_groups(port, 0.3, norm_weight_decay=0.0, bias_weight_decay=0.1)
    by_id = {id(p): g["weight_decay"] for g in groups for p in g["params"]}
    ref = tvit.VisionTransformer(**TINY)
    wanted = {}
    for path, label in jax.tree_util.tree_leaves_with_path(labels):
        keys = tuple(k.key for k in path)
        from vision_tpu_torch._jax_convert import _torch_name
        wanted[_torch_name("params", keys)] = want[label]
    got = {n: by_id[id(p)] for n, p in port.named_parameters()}
    assert got == wanted and len(got) == len(list(ref.parameters()))
    assert got["encoder.layers.encoder_layer_0.self_attention.in_proj_bias"] == 0.1
    assert got["encoder.ln.weight"] == 0.0 and got["class_token"] == 0.3


def test_two_recipe_steps_match_jax(tiny):
    train = _load_cls_train()
    import utils as ref_utils  # references/classification/utils.py

    module, variables, _ = tiny
    rng = np.random.RandomState(5)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, 8)
    mix = T.MixUp(0.2, num_classes=10)
    draws = mix.draw((8, 3, 32, 32), torch.Generator().manual_seed(5))
    images, soft = mix.apply((torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                              torch.from_numpy(labels)), draws)
    lam = float(draws["lam"])
    jmix = JT.MixUp(0.2, 10)
    params = {"lam": lam, "lam_adjusted": lam}
    jbatch = {"image": jmix._mix_image(jnp.asarray(x), params),
              "label": jmix._mix_label(jax.nn.one_hot(labels, 10), params)}
    np.testing.assert_allclose(soft.numpy(), jbatch["label"], atol=1e-6)

    args = _recipe_args()
    decay = ema_decay(0.99998, 8, 32, 3)
    assert decay == pytest.approx(1.0 - 2e-5 * 8 * 32 / 3)
    tx = train.make_optimizer(args, steps_per_epoch=1)

    def apply(v, images, train, rngs, mutable):
        # JAX's step passes mutable=[] without batch statistics, where flax
        # returns (logits, {}) and the step expects the logits alone
        return module.apply(v, images, train=train, rngs=rngs)

    jstep = jtrain.make_train_step(apply, tx, label_smoothing=0.11,
                                   has_batch_stats=False, donate=False)
    state = jtrain.TrainState(variables["params"], {},
                              tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    jema = ref_utils.ExponentialMovingAverage(state.params, decay)

    def jloss(p):
        logits = module.apply({"params": p}, jbatch["image"])
        return jtrain.cross_entropy_loss(logits, jbatch["label"], 0.11)

    want_norm = float(optax.global_norm(jax.jit(jax.grad(jloss))(state.params)))
    want_losses = []
    for _ in range(2):
        state, metrics = jstep(state, jbatch, jax.random.PRNGKey(0))
        jema.update(state.params)
        want_losses.append(float(metrics["loss"]))

    port = tvit.VisionTransformer(**TINY)
    load_jax_variables(port, variables)
    opt = make_optimizer(port, lr=args.lr, weight_decay=args.weight_decay)
    sched = make_lr_scheduler(opt, lr_schedule(
        args.lr, args.epochs, 1, args.lr_min, args.lr_warmup_epochs,
        args.lr_warmup_decay))
    step = make_train_step(port, opt, label_smoothing=0.11, clip_grad_norm=1.0)
    ema = ExponentialMovingAverage(port, decay)
    for i in range(2):
        got = step({"image": images, "label": soft})
        sched.step()
        ema.update(port)
        assert float(got["loss"]) == pytest.approx(want_losses[i], rel=1e-5)
        if i == 0:
            assert float(got["grad_norm"]) == pytest.approx(want_norm, rel=1e-5)
            assert want_norm > 1.0  # the clip is active
            largest = max(float(p.grad.abs().max()) for p in port.parameters())
            for block in port.encoder.layers:
                k_bias = block.self_attention.in_proj_bias.grad[64:128]
                assert float(k_bias.abs().max()) <= 1e-6 * largest
    assert want_losses[1] != want_losses[0]

    # The key projection's bias moves every score of a query row alike, so
    # the softmax takes no gradient from it: what either library computes
    # there is round-off, which Adam's g / |g| turns into steps of the
    # learning rate's size. Those rows are left out of the comparison.
    for tree, tensors in ((state.params, dict(port.named_parameters())),
                          (jema.shadow, ema.state_dict())):
        ref = tvit.VisionTransformer(**TINY)
        load_jax_variables(ref, {"params": jax.tree_util.tree_map(np.asarray, tree)})
        for name, want in ref.named_parameters():
            want = want.detach().numpy()
            have = tensors[name].detach().numpy()
            if name.endswith("in_proj_bias"):
                want, have = (np.concatenate([t[:64], t[128:]]) for t in (want, have))
            scale = max(float(np.abs(want).max()), 1e-3)
            assert float(np.abs(have - want).max()) / scale <= 1e-4, name
