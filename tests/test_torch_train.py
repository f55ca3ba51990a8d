"""Train-step parity: ``vision_tpu_torch.parallel.train`` on the CPU
against ``vision_tpu.parallel.train`` (jitted), the same seeded numpy
weights, images and labels on both sides.

Tolerances: the loss functions within 1e-6 (one f32 log-softmax); two SGD
steps of a tiny fused-BN ResNet: losses within 1e-4 relative, parameters
and running statistics after step 2 within 1e-3 of each tensor's largest
value (step 2 runs on parameters that already differ by f32 round-off).
Batch statistics over a handful of values can amplify f32 round-off a
thousandfold (a channel that is nearly constant over the batch divides by
``sqrt(var + eps)`` with ``var`` lost in cancellation), on either side; the
batch of 16 below is an instance where they do not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision_tpu.models import resnet as jresnet
from vision_tpu.parallel import train as jtrain
from vision_tpu_torch._jax_convert import load_jax_variables
from vision_tpu_torch.models import resnet as tresnet
from vision_tpu_torch.parallel.train import cross_entropy_loss, make_train_step

from test_torch_resnet import _random_variables, _torch_named, _torch_stats


@pytest.mark.parametrize("kind,smoothing", [
    ("integer", 0.0), ("integer", 0.1), ("soft", 0.0), ("soft", 0.1),
])
def test_cross_entropy_matches_jax(kind, smoothing):
    rng = np.random.RandomState(0)
    logits = (rng.randn(6, 11) * 3).astype(np.float32)
    if kind == "integer":
        labels = rng.randint(0, 11, 6).astype(np.int32)
    else:
        labels = rng.dirichlet(np.ones(11), 6).astype(np.float32)
    want = jtrain.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                     smoothing)
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_cross_entropy_of_bf16_logits_is_computed_in_f32():
    logits = torch.from_numpy(
        np.random.RandomState(1).randn(4, 7).astype(np.float32)).bfloat16()
    labels = torch.tensor([0, 3, 6, 2])
    got = cross_entropy_loss(logits, labels)
    assert got.dtype == torch.float32
    want = torch.nn.functional.cross_entropy(logits.float(), labels)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def sgd_case():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, 16).astype(np.int32)
    jmod = jresnet.ResNet(block=jresnet.Bottleneck, layers=(1, 1, 1, 1),
                          num_classes=10, fused_bn=True)
    variables = _random_variables(jmod, jnp.asarray(x[:1]), 1)
    return jmod, variables, x, labels


def test_two_sgd_steps_match_jax(sgd_case):
    jmod, variables, x, labels = sgd_case
    tx = optax.chain(optax.add_decayed_weights(1e-4),
                     optax.sgd(0.1, momentum=0.9))
    jstep = jtrain.make_train_step(jmod.apply, tx, label_smoothing=0.1,
                                   donate=False)
    state = jtrain.TrainState(variables["params"], variables["batch_stats"],
                              tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    jbatch = {"image": jnp.asarray(x), "label": jnp.asarray(labels)}
    want = []
    for _ in range(2):
        state, metrics = jstep(state, jbatch, jax.random.PRNGKey(0))
        want.append({k: float(v) for k, v in metrics.items()})

    port = tresnet.ResNet(tresnet.Bottleneck, (1, 1, 1, 1), num_classes=10,
                          fused_bn=True)
    load_jax_variables(port, variables)
    opt = torch.optim.SGD(port.parameters(), lr=0.1, momentum=0.9,
                          weight_decay=1e-4)
    step = make_train_step(port, opt, label_smoothing=0.1)
    batch = {"image": torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
             "label": torch.from_numpy(labels).long()}
    for i in range(2):
        got = step(batch)
        assert set(got) == {"loss", "accuracy"}
        np.testing.assert_allclose(float(got["loss"]), want[i]["loss"],
                                   rtol=1e-4)
        assert float(got["accuracy"]) == pytest.approx(want[i]["accuracy"])
    assert want[1]["loss"] != want[0]["loss"]
    assert port.training

    tensors = dict(port.named_parameters())
    tensors.update(port.named_buffers())
    wanted = _torch_named(state.params)
    wanted.update(_torch_stats(state.batch_stats))
    assert len(wanted) == len(tensors) - sum(
        n.endswith("num_batches_tracked") for n in tensors)
    for name, ref in wanted.items():
        got = tensors[name].detach().numpy()
        scale = max(float(np.abs(ref).max()), 1e-3)
        assert np.abs(got - ref).max() / scale <= 1e-3, name


def test_bf16_step_keeps_f32_master_state(sgd_case):
    """``compute_dtype=torch.bfloat16``: bf16 forward and backward, f32
    parameters, gradients, running statistics and loss; the first loss is
    within 2e-2 relative of the f32 step's (bf16 keeps 8 bits)."""
    _, variables, x, labels = sgd_case
    batch = {"image": torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
             "label": torch.from_numpy(labels).long()}
    losses = {}
    for dtype in (None, torch.bfloat16):
        port = tresnet.ResNet(tresnet.Bottleneck, (1, 1, 1, 1), num_classes=10,
                              fused_bn=True)
        load_jax_variables(port, variables)
        seen = []
        port.layer1[0].conv2.register_forward_hook(
            lambda mod, args, out: seen.append((args[0].dtype, out.dtype)))
        opt = torch.optim.SGD(port.parameters(), lr=0.01)
        before = port.bn1.running_mean.clone()
        metrics = make_train_step(port, opt, compute_dtype=dtype)(batch)
        losses[dtype] = float(metrics["loss"])
        want = torch.float32 if dtype is None else dtype
        assert seen == [(want, want)]
        assert metrics["loss"].dtype == torch.float32
        for p in port.parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        for b in port.buffers():
            assert b.dtype in (torch.float32, torch.long)
        assert not torch.equal(port.bn1.running_mean, before)
    assert abs(losses[torch.bfloat16] - losses[None]) <= 2e-2 * abs(losses[None])
