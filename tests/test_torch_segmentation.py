"""Semantic segmentation, the port against ``vision_tpu`` on the CPU, the
JAX variables (seeded by numpy in ``jax.eval_shape``'s shapes) carried
across by ``load_jax_variables``: DeepLabV3 and FCN on a dilated ResNet of
one Bottleneck a stage (``layers=(1, 1, 1, 1)``, 5 classes) at 64x64, and
DeepLabV3 and LR-ASPP on the full-width dilated MobileNetV3-Large at 64x64.

Tolerances (``tests/torch_zoo_cases.py``'s): eval ``out`` and ``aux``
within 1e-5 of the largest JAX value; a train-mode forward at batch 1 (where
ASPP's pooling branch normalises one value a channel and gives its bias)
within 1e-5; one step of ``make_segmentation_train_step`` against
``jax.value_and_grad`` of a copy of ``references/segmentation/train.py``'s
``criterion`` and the recipe's optax SGD: the loss within 1e-5 relative,
the update within 1e-3 by relative Frobenius norm, or no further from
JAX's x64 step than twice JAX's f32 step is (batch statistics over a
small batch leave JAX's own f32 update 4e-3 from x64 at this model), and
the running statistics it leaves within 1e-5 of each tensor's largest
value (at least 1e-3), or as sharp as JAX's by the same rule. The
port's step runs on ATen's CPU convolutions and products, oneDNN off:
with oneDNN the port's f32 update lies 1.5e-2 from x64, without it 6e-4
(its convolutions' gradients part from ATen's by 1e-4 at the head, and
a pre-activation of ASPP's projection then crosses a ReLU's kink). The
heads' dropout keep-masks are drawn here and handed to both: to JAX by
intercepting ``nn.Dropout``, to the port by patching
``vision_tpu_torch.ops.misc.dropout``.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision_tpu.models import get_model_weights as jweights
from vision_tpu.models.segmentation.deeplabv3 import DeepLabV3 as JDeepLabV3
from vision_tpu.models.segmentation.fcn import FCN as JFCN
from vision_tpu.models.segmentation.lraspp import LRASPP as JLRASPP
from vision_tpu.transforms._presets import SemanticSegmentation as JPreset
from vision_tpu_torch._jax_convert import jax_placements, load_jax_variables
from vision_tpu_torch.models import get_model, get_model_weights
from vision_tpu_torch.models.segmentation import FCN, LRASPP, DeepLabV3
from vision_tpu_torch.ops import misc
from vision_tpu_torch.parallel import (
    make_segmentation_train_step,
    segmentation_criterion,
)
from vision_tpu_torch.transforms import SemanticSegmentation

from torch_zoo_cases import (
    LOGITS_TOL,
    LOSS_TOL,
    STATS_TOL,
    UPDATE_TOL,
    _as_sharp,
    _in_x64,
    images,
    nchw,
    random_variables,
    rel,
)
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

BUILDERS = ("deeplabv3_mobilenet_v3_large", "deeplabv3_resnet50",
            "deeplabv3_resnet101", "fcn_resnet50", "fcn_resnet101",
            "lraspp_mobilenet_v3_large")
CLASSES = 5
LR = 0.01


def jax_criterion(outputs, target, num_classes, ignore_index=255):
    """``references/segmentation/train.py:criterion``, copied."""
    losses = {}
    for name, logits in outputs.items():
        valid = target != ignore_index
        tgt = jnp.where(valid, target, 0)
        one_hot = jax.nn.one_hot(tgt, num_classes)
        ce = -jnp.sum(one_hot * jax.nn.log_softmax(logits, axis=-1), axis=-1)
        losses[name] = jnp.sum(ce * valid) / jnp.maximum(jnp.sum(valid), 1)
    if "aux" in losses:
        return losses["out"] + 0.5 * losses["aux"]
    return losses["out"]


def nhwc_out(out):
    return {k: np.asarray(v).transpose(0, 3, 1, 2) for k, v in out.items()}


def port_of(make, variables):
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device="cpu")
    load_jax_variables(model, variables)
    return model.eval()


X = images(2, 64, seed=1)


@functools.lru_cache(None)
def case(name):
    """(JAX module, seeded variables, a maker of the port's model)."""
    jm, make = {
        "deeplabv3": (JDeepLabV3(layers=(1, 1, 1, 1), num_classes=CLASSES),
                      lambda: DeepLabV3(layers=(1, 1, 1, 1),
                                        num_classes=CLASSES)),
        "fcn": (JFCN(layers=(1, 1, 1, 1), num_classes=CLASSES),
                lambda: FCN(layers=(1, 1, 1, 1), num_classes=CLASSES)),
        "deeplabv3_mobilenet": (
            JDeepLabV3(backbone_type="mobilenet", num_classes=CLASSES),
            lambda: DeepLabV3("mobilenet", num_classes=CLASSES)),
        "lraspp": (JLRASPP(num_classes=CLASSES),
                   lambda: LRASPP(num_classes=CLASSES)),
    }[name]
    return jm, random_variables(jm, jnp.asarray(X[:1])), make


@pytest.mark.parametrize("name", ["deeplabv3", "fcn", "deeplabv3_mobilenet",
                                  "lraspp"])
def test_eval_outputs_match_jax(name):
    jm, variables, make = case(name)
    want = nhwc_out(jax.jit(jm.apply)(variables, jnp.asarray(X)))
    with torch.no_grad():
        got = port_of(make, variables)(nchw(X))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == (2, CLASSES, 64, 64)
        assert rel(got[k].numpy(), want[k]) <= LOGITS_TOL, k


def _masks(rng, batch):
    """Keep-masks of the two dropouts at 64x64 (an 8x8 map), NHWC, in call
    order: ASPP's (p 0.5), then the auxiliary head's (p 0.1)."""
    return [rng.random((batch, 8, 8, 256)) >= 0.5,
            rng.random((batch, 8, 8, 256)) >= 0.1]


def _jax_with_masks(fn, masks):
    """``fn`` with every ``nn.Dropout`` call replaced by the next mask."""
    def run(*args):
        queue = list(masks)

        def interceptor(next_fun, a, kw, context):
            if isinstance(context.module, nn.Dropout) and \
                    context.method_name == "__call__":
                keep = jnp.asarray(queue.pop(0), a[0].dtype)
                return a[0] * keep / (1.0 - context.module.rate)
            return next_fun(*a, **kw)

        with nn.intercept_methods(interceptor):
            return fn(*args)
    return run


@pytest.fixture
def port_masks(monkeypatch):
    """Hands the port's dropouts the masks put in the returned list."""
    queue = []

    def dropout(x, p, training, generator):
        if not training or p == 0.0:
            return x
        keep = torch.from_numpy(queue.pop(0).transpose(0, 3, 1, 2).copy())
        return x * keep.to(x.dtype) / (1.0 - p)

    monkeypatch.setattr(misc, "dropout", dropout)
    return queue


def test_train_forward_at_batch_one_matches_jax(port_masks):
    """At batch 1 ASPP's pooled map is one value a channel: its batch norm
    in training sees a variance of 0 and gives its bias (``torch.nn.
    BatchNorm2d`` raises)."""
    jm, variables, make = case("deeplabv3")
    x = X[:1]
    masks = _masks(np.random.default_rng(4), 1)
    fn = jax.jit(_jax_with_masks(lambda v, t: jm.apply(
        v, t, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}), masks))
    f32 = jax.tree_util.tree_map(np.asarray, fn(variables, x))
    model = port_of(make, variables).train()
    port_masks.extend(masks)
    with torch.no_grad():
        got = model(nchw(x))
    for k in ("out", "aux"):
        _as_sharp(got[k].numpy(), f32[0][k].transpose(0, 3, 1, 2),
                  lambda k=k: _in_x64(fn, variables, x)[0][k].transpose(
                      0, 3, 1, 2), LOGITS_TOL, 1e-30, k)
    pooled_bn = model.classifier[0].convs[4][2]
    want = f32[1]["batch_stats"]["classifier"]["0"]["convs.4.2"]
    np.testing.assert_allclose(pooled_bn.running_mean.numpy(), want["mean"],
                               rtol=1e-5, atol=1e-6)


def test_segmentation_train_step_matches_jax(port_masks):
    jm, variables, make = case("deeplabv3")
    rng = np.random.default_rng(3)
    target = rng.integers(0, CLASSES, (2, 64, 64))
    target[0, :10] = 255
    masks = _masks(rng, 2)
    tx = optax.chain(optax.add_decayed_weights(1e-4),
                     optax.sgd(LR, momentum=0.9))

    def jstep(v, img, tgt):
        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                                img, train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
            return jax_criterion(out, tgt, CLASSES), mut
        (loss, mut), g = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
        upd, _ = tx.update(g, tx.init(v["params"]), v["params"])
        return loss, {"params": upd, "batch_stats": mut["batch_stats"]}

    fn = jax.jit(_jax_with_masks(jstep, masks))
    f32 = jax.tree_util.tree_map(np.asarray, fn(variables, X, target))
    f64 = functools.lru_cache(None)(lambda: _in_x64(fn, variables, X, target))

    model = port_of(make, variables)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    port_masks.extend(masks)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9,
                          weight_decay=1e-4)
    with torch.backends.mkldnn.flags(enabled=False):
        got = make_segmentation_train_step(model, opt)(
            {"image": nchw(X), "target": torch.from_numpy(target)})
    _as_sharp(float(got["loss"]), f32[0], lambda: f64()[0], LOSS_TOL, 1e-30,
              "loss")

    def update(tree):
        placed = jax_placements(model, tree)
        return np.concatenate([placed[n].ravel() for n in before])

    have = np.concatenate([(p.detach() - before[n]).numpy().ravel()
                           for n, p in model.named_parameters()])
    _as_sharp(have, update(f32[1]), lambda: update(f64()[1]), UPDATE_TOL, 0.0,
              "update", norm=True)
    stats32 = jax_placements(model, f32[1])
    stats64 = functools.lru_cache(None)(lambda: jax_placements(model,
                                                               f64()[1]))
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _as_sharp(buf.numpy(), stats32[name],
                      lambda name=name: stats64()[name], STATS_TOL, 1e-3,
                      name)


def test_amp_step_is_near_the_f32_step():
    """The amp step (parameters and image in bf16, statistics and outputs
    f32) gives step 1's loss within 5e-2 of the f32 step's from the same
    weights and dropout draws, and keeps the statistics f32."""
    _, variables, make = case("deeplabv3")
    target = torch.from_numpy(np.random.default_rng(5).integers(
        0, CLASSES, (2, 64, 64)))
    losses = []
    for dtype in (None, torch.bfloat16):
        model = port_of(make, variables)
        opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
        step = make_segmentation_train_step(model, opt, dtype)
        losses.append(float(step({"image": nchw(X), "target": target},
                                 torch.Generator().manual_seed(0))["loss"]))
        assert all(b.dtype in (torch.float32, torch.int64)
                   for b in model.buffers())
    assert abs(losses[1] - losses[0]) <= 5e-2 * abs(losses[0])


def test_criterion_matches_the_reference_and_ignores_255():
    rng = np.random.default_rng(6)
    out = {"out": rng.standard_normal((2, 64, 64, CLASSES), np.float32),
           "aux": rng.standard_normal((2, 64, 64, CLASSES), np.float32)}
    target = rng.integers(0, CLASSES, (2, 64, 64))
    target[rng.random(target.shape) < 0.3] = 255
    want = float(jax_criterion({k: jnp.asarray(v) for k, v in out.items()},
                               jnp.asarray(target), CLASSES))
    got = segmentation_criterion(
        {k: nchw(v) for k, v in out.items()}, torch.from_numpy(target))
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    # an ignored pixel's logits do not count
    moved = {k: v.copy() for k, v in out.items()}
    moved["out"][target == 255] += 100.0
    again = segmentation_criterion({k: nchw(v) for k, v in moved.items()},
                                   torch.from_numpy(target))
    assert float(again) == pytest.approx(float(got), rel=1e-6)


def test_criterion_of_an_all_ignored_batch_is_zero():
    """``F.cross_entropy(ignore_index=255)`` gives NaN here; the recipe's
    mean over at least one pixel gives 0, and so does its gradient."""
    logits = torch.randn(2, CLASSES, 8, 8, requires_grad=True)
    target = torch.full((2, 8, 8), 255)
    loss = segmentation_criterion({"out": logits, "aux": logits}, target)
    loss.backward()
    assert float(loss) == 0.0 and float(logits.grad.abs().max()) == 0.0


def test_preset_matches_jax():
    img = np.random.default_rng(7).integers(0, 256, (3, 90, 70), np.uint8)
    want = np.asarray(JPreset(resize_size=52)(jnp.asarray(img.transpose(
        1, 2, 0))))
    got = SemanticSegmentation(resize_size=52, device="cpu")(
        torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == (3, 66, 52)
    np.testing.assert_allclose(got.numpy(), want.transpose(2, 0, 1),
                               atol=2e-5)


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_matches_jax_weights_and_parameter_count(name):
    """The parameter count on the meta device is the JAX weights'
    ``num_params`` (the auxiliary head always built); the weights enum
    carries JAX's checkpoints, metrics, GMACs and preset."""
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
        assert g.transforms.keywords == w.transforms.keywords


def test_builders_run_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")  # never here: the CPU suite
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("lraspp_mobilenet_v3_large")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SemanticSegmentation(resize_size=520)
    model = get_model("lraspp_mobilenet_v3_large", device="cpu")
    assert not model.training
    with torch.no_grad():
        out = model(torch.randn(1, 3, 64, 64))
    assert list(out) == ["out"] and out["out"].shape == (1, 21, 64, 64)


@pytest.mark.slow
@pytest.mark.parametrize("name", BUILDERS)
def test_builder_loads_its_jax_variables(name):
    """The JAX builder's variables (shapes only) place onto the port's
    model on the meta device, leaf for leaf."""
    from vision_tpu.models import get_model as jget
    from vision_tpu.models._utils import abstract_init

    with abstract_init():
        shapes = jget(name).variables
    zeros = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)), shapes)
    jax_placements(get_model(name, device="meta"), zeros)
