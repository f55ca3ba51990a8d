"""ResNet parity: the port (``vision_tpu_torch.models.resnet``, CPU path,
NCHW) against the JAX package (``vision_tpu.models.resnet``, NHWC), the
same seeded numpy weights carried across with ``load_jax_variables``.

The JAX side runs under ``jit``; its fused path reaches the Pallas kernel's
reference implementation, as it does in the JAX package's own CPU tests.
Tolerances are relative to the largest value of the tensor compared: 1e-4
for one block and for eval logits (f32 sums in another order through a few
layers), 2e-3 for the fused four-stage net in training mode (the bound of
``tests/test_fused_bn.py``: batch statistics over 2 to 8 values amplify
round-off).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.models import resnet as jresnet
from vision_tpu_torch._jax_convert import load_jax_variables
from vision_tpu_torch.models import get_model, list_models
from vision_tpu_torch.models import resnet as tresnet
from vision_tpu_torch.ops._conv1x1_bn import matmul_stats_cuda
from vision_tpu_torch.ops.misc import BatchNorm2d


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _random_variables(module, x, seed, **kwargs):
    """Seeded numpy values in the shapes of ``module.init`` (traced, not
    run): kernels N(0, 1/fan_in), BN scale in [0.5, 1.5), small biases and
    means, variances in [0.5, 1.5)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x,
                                                **kwargs))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if leaf in ("scale", "var"):
            return (rng.rand(*s.shape) + 0.5).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _torch_named(tree):
    """JAX ``params``-shaped tree -> {torch name: array in torch layout}."""
    out = {}
    for path, v in _leaves(tree):
        leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
        v = np.asarray(v)
        if v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 2:
            v = v.T
        out[".".join(path[:-1] + (leaf,))] = v
    return out


def _torch_stats(tree):
    names = {"mean": "running_mean", "var": "running_var"}
    return {".".join(p[:-1] + (names[p[-1]],)): np.asarray(v)
            for p, v in _leaves(tree)}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-3)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err} > {tol}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------- block


@pytest.fixture(scope="module")
def block_case():
    x = np.random.RandomState(0).rand(2, 16, 16, 64).astype(np.float32)
    std = jresnet.Bottleneck(planes=32, stride=2, downsample=True)
    variables = _random_variables(std, jnp.asarray(x), 1, train=True)
    return x, variables


@pytest.mark.parametrize("fused", [False, True])
def test_bottleneck_train_forward_stats_and_grads(block_case, fused):
    x, variables = block_case
    jmod = jresnet.Bottleneck(planes=32, stride=2, downsample=True,
                              fused_bn=fused)

    @jax.jit
    def run(params, stats, x):
        def loss(p):
            out, upd = jmod.apply({"params": p, "batch_stats": stats}, x,
                                  train=True, mutable=["batch_stats"])
            return jnp.sum(out ** 2), (out, upd["batch_stats"])
        (_, (out, new_stats)), grads = jax.value_and_grad(
            loss, has_aux=True)(params)
        return out, new_stats, grads

    out, new_stats, grads = run(variables["params"], variables["batch_stats"],
                                jnp.asarray(x))

    block = tresnet.Bottleneck(64, 32, stride=2, downsample=True,
                               fused_bn=fused)
    load_jax_variables(block, variables)
    block.train()
    before = matmul_stats_cuda.launches
    got = block(_nchw(x))
    (got ** 2).sum().backward()
    assert matmul_stats_cuda.launches == before  # CPU: the plain version

    _close(got.detach().permute(0, 2, 3, 1).numpy(), out, 1e-4, "output")
    buffers = dict(block.named_buffers())
    for name, want in _torch_stats(new_stats).items():
        _close(buffers[name].numpy(), want, 1e-4, name)
    params = dict(block.named_parameters())
    wanted = _torch_named(grads)
    assert wanted.keys() == params.keys()
    for name, want in wanted.items():
        _close(params[name].grad.numpy(), want, 1e-4, name)
    assert int(block.bn1.num_batches_tracked) == 1


def test_running_variance_is_the_biased_one():
    """flax's update, not ``torch.nn.BatchNorm2d``'s: no M/(M-1) factor."""
    x = torch.from_numpy(
        np.random.RandomState(2).randn(2, 3, 4, 4).astype(np.float32))
    bn = BatchNorm2d(3).train()
    bn(x)
    biased = x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased,
                               rtol=1e-5, atol=1e-6)
    ref = torch.nn.BatchNorm2d(3).train()
    ref(x)
    assert not torch.allclose(bn.running_var, ref.running_var, rtol=1e-3)
    torch.testing.assert_close(bn.running_mean, ref.running_mean,
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- tiny net


@pytest.fixture(scope="module")
def tiny_case():
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    jmod = jresnet.ResNet(block=jresnet.Bottleneck, layers=(1, 1, 1, 1),
                          num_classes=10)
    return x, _random_variables(jmod, jnp.asarray(x), 3)


def _tiny_port(variables, fused):
    port = tresnet.ResNet(tresnet.Bottleneck, (1, 1, 1, 1), num_classes=10,
                          fused_bn=fused)
    load_jax_variables(port, variables)
    return port


def test_tiny_resnet_eval_logits_and_features(tiny_case):
    x, variables = tiny_case
    jmod = jresnet.ResNet(block=jresnet.Bottleneck, layers=(1, 1, 1, 1),
                          num_classes=10)
    want, feats = jax.jit(
        lambda v, x: jmod.apply(v, x, train=False, return_features=True)
    )(variables, jnp.asarray(x))
    port = _tiny_port(variables, fused=True).eval()
    with torch.no_grad():
        got, got_feats = port(_nchw(x), return_features=True)
    _close(got.numpy(), want, 1e-4, "logits")
    assert list(got_feats) == ["layer1", "layer2", "layer3", "layer4"]
    for name, f in got_feats.items():
        _close(f.permute(0, 2, 3, 1).numpy(), feats[name], 1e-4, name)
    # eval after (or without) fused training is the standard path
    with torch.no_grad():
        same = _tiny_port(variables, fused=False).eval()(_nchw(x))
    assert torch.equal(got, same)


def test_tiny_resnet_fused_train_logits_and_stats(tiny_case):
    x, variables = tiny_case
    jmod = jresnet.ResNet(block=jresnet.Bottleneck, layers=(1, 1, 1, 1),
                          num_classes=10, fused_bn=True)
    want, upd = jax.jit(
        lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"])
    )(variables, jnp.asarray(x))
    port = _tiny_port(variables, fused=True).train()
    with torch.no_grad():
        got = port(_nchw(x))
    _close(got.numpy(), want, 2e-3, "logits")
    buffers = dict(port.named_buffers())
    for name, ref in _torch_stats(upd["batch_stats"]).items():
        _close(buffers[name].numpy(), ref, 2e-3, name)


@pytest.mark.parametrize("name,block,layers,kwargs", [
    ("resnet18", "BasicBlock", (2, 2, 2, 2), {}),
    ("resnext50_32x4d", "Bottleneck", (3, 4, 6, 3),
     {"groups": 32, "width_per_group": 4}),
])
def test_registered_model_eval_matches_jax(name, block, layers, kwargs):
    x = np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32)
    jmod = jresnet.ResNet(block=getattr(jresnet, block), layers=layers,
                          num_classes=10, **kwargs)
    variables = _random_variables(jmod, jnp.asarray(x), 5)
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    port = get_model(name, device="cpu", num_classes=10, fused_bn=True)
    assert not port.training
    load_jax_variables(port, variables)
    with torch.no_grad():
        got = port(_nchw(x))
    _close(got.numpy(), want, 1e-4, name)


def test_replace_stride_with_dilation_keeps_the_resolution():
    x = np.random.RandomState(6).rand(1, 32, 32, 3).astype(np.float32)
    flags = (False, True, True)
    jmod = jresnet.ResNet(block=jresnet.Bottleneck, layers=(1, 1, 1, 1),
                          num_classes=10, replace_stride_with_dilation=flags)
    variables = _random_variables(jmod, jnp.asarray(x), 7)
    want, feats = jax.jit(
        lambda v, x: jmod.apply(v, x, train=False, return_features=True)
    )(variables, jnp.asarray(x))
    port = tresnet.ResNet(tresnet.Bottleneck, (1, 1, 1, 1), num_classes=10,
                          replace_stride_with_dilation=flags).eval()
    load_jax_variables(port, variables)
    with torch.no_grad():
        got, got_feats = port(_nchw(x), return_features=True)
    assert got_feats["layer4"].shape[-2:] == got_feats["layer2"].shape[-2:]
    _close(got.numpy(), want, 1e-4, "logits")
    _close(got_feats["layer4"].permute(0, 2, 3, 1).numpy(), feats["layer4"],
           1e-4, "layer4")


# ---------------------------------------------------------------- registry

_MODELS = [
    ("resnet18", "ResNet18_Weights"), ("resnet34", "ResNet34_Weights"),
    ("resnet50", "ResNet50_Weights"), ("resnet101", "ResNet101_Weights"),
    ("resnet152", "ResNet152_Weights"),
    ("resnext50_32x4d", "ResNeXt50_32X4D_Weights"),
    ("resnext101_32x8d", "ResNeXt101_32X8D_Weights"),
    ("resnext101_64x4d", "ResNeXt101_64X4D_Weights"),
    ("wide_resnet50_2", "Wide_ResNet50_2_Weights"),
    ("wide_resnet101_2", "Wide_ResNet101_2_Weights"),
]


@pytest.mark.parametrize("name,enum", _MODELS)
def test_parameter_count_matches_the_published_one(name, enum, monkeypatch):
    """Built on the meta device: nothing is allocated or initialised."""
    monkeypatch.setattr(tresnet, "init_weights", lambda model, generator: None)
    assert name in list_models()
    with torch.device("meta"):
        model = get_model(name, device="meta")
    count = sum(p.numel() for p in model.parameters())
    weights = getattr(tresnet, enum)
    jweights = getattr(jresnet, enum)
    assert [w.name for w in weights] == [w.name for w in jweights]
    for w, jw in zip(weights, jweights):
        assert w.meta["num_params"] == count
        assert w.value.url == jw.value.url
        assert w.meta["_metrics"] == jw.meta["_metrics"]
    with pytest.raises(FileNotFoundError, match="downloads are refused"):
        weights.DEFAULT.get_state_dict()


def test_state_dict_names_are_torchvision():
    with torch.device("meta"):
        keys = tresnet.ResNet(tresnet.Bottleneck, (3, 4, 6, 3)).state_dict().keys()
    for k in ("conv1.weight", "bn1.running_var", "bn1.num_batches_tracked",
              "layer1.0.conv3.weight", "layer1.0.downsample.0.weight",
              "layer1.0.downsample.1.running_mean", "layer4.2.bn3.bias",
              "fc.weight", "fc.bias"):
        assert k in keys, k
    assert len(keys) == 320  # torchvision's resnet50 state dict


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("resnet50", fused_bn=True)


def test_seed_fixes_the_initialisation():
    a = get_model("resnet18", device="cpu", seed=3, num_classes=4)
    b = get_model("resnet18", device="cpu", seed=3, num_classes=4)
    c = get_model("resnet18", device="cpu", seed=4, num_classes=4)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.fc.weight, c.fc.weight)
    conv = a.layer1[0].conv1.weight
    assert abs(float(conv.detach().std()) - (2.0 / (64 * 9)) ** 0.5) < 5e-3
    assert float(a.bn1.weight.detach().min()) == 1.0
    assert float(a.bn1.bias.detach().abs().max()) == 0.0
