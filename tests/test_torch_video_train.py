"""The video classification recipe's step on the port
(``make_train_step`` on ``[N, 3, T, H, W]`` clips with
``parallel.video.video_recipe_optimizer``) against the JAX recipe's
(``references/video_classification/train.py:132-211``: one-hot
cross-entropy on f32 logits, ``optax.add_decayed_weights`` then ``sgd``
with momentum, the warm-up joined to the milestone schedule, ``--amp``
casting parameters and clips to bf16 and keeping batch statistics f32),
on the CPU, from the same numpy-seeded variables and 4x32x32 clips: an
R(2+1)D with one block a stage and a three-block MViT v2, one step each
(at the warm-up's first rate, the decay added). Also the schedule and
``VideoAccuracy`` against JAX's.

Tolerances (``tests/torch_zoo_cases.py``'s): the f32 loss within 1e-5
relative; the parameters' change within 1e-3 by relative Frobenius norm,
or else no further from JAX's step run in f64 than twice JAX's f32 step
is (batch statistics over four clips of a random R(2+1)D leave its f32
update only ~5e-3 sharp in either library); the running statistics within
1e-5 of each tensor's largest value (at least 1e-3). amp: the port's bf16
step against JAX's bf16 step: the loss within 1e-2 relative, the change
no further from JAX's than twice JAX's own amp distance from its f32
change (R(2+1)D: 0.41, MViT: 0.05), the running statistics within 1e-2;
and, as bf16 blurs R(2+1)D's update that much in either library, the
scale of each library's amp change along its own f32 change
(``<amp, f32> / <f32, f32>``: 0.92 for R(2+1)D in both, 1.0 for MViT)
within 0.05 of JAX's, which an update off by a tenth or more fails. The
optimizer alone (decay, momentum, schedule) is held against the optax
chain over a few steps within 1e-6, at a decay large enough to show. The
port runs
with oneDNN off (``torch.backends.mkldnn.flags``): its bf16 Conv3d on
the CPU gives run-to-run different sums and, now and then, non-finite
values in MViT's pooling (seen at step 2), which no card path takes.
"""

import importlib
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision_tpu_torch._jax_convert import load_jax_variables
from vision_tpu_torch.parallel import make_train_step
from vision_tpu_torch.parallel.video import (
    VideoAccuracy,
    video_lr_lambda,
    video_recipe_optimizer,
)

from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)
from torch_zoo_cases import random_variables

pytestmark = pytest.mark.usefixtures("few_torch_threads")

ROOT = Path(__file__).resolve().parent.parent
JR, JM = (importlib.import_module(f"vision_tpu.models.video.{m}")
          for m in ("resnet", "mvit"))
TR, TM = (importlib.import_module(f"vision_tpu_torch.models.video.{m}")
          for m in ("resnet", "mvit"))

NUM_CLASSES = 10
LR, MOMENTUM, WD = 0.05, 0.9, 1e-4
STEPS_PER_EPOCH, WARMUP_EPOCHS, WARMUP_DECAY = 2, 1, 0.1
MILESTONES, GAMMA = (1,), 0.1
LOSS_TOL = 1e-5
UPDATE_TOL = 1e-3
STATS_TOL = 1e-5
AMP_LOSS_TOL = 1e-2
AMP_STATS_TOL = 1e-2
AMP_SCALE_TOL = 0.05


def _mvit():
    cfg = dict(num_heads=[1, 2, 2], input_channels=[8, 8, 16],
               output_channels=[8, 16, 16], kernel_kv=[[3, 3, 3]] * 3,
               stride_kv=[[1, 4, 4], [1, 2, 2], [1, 1, 1]],
               kernel_q=[[3, 3, 3]] * 3,
               stride_q=[[1, 1, 1], [1, 2, 2], [1, 1, 1]])
    flags = dict(residual_pool=True, rel_pos_embed=True, proj_after_attn=True,
                 stochastic_depth_prob=0.0, dropout=0.0,
                 num_classes=NUM_CLASSES)
    return (JM.MViT(block_setting=JM._mk_config(cfg), **flags),
            lambda: TM.MViT(TM._mk_config(cfg), spatial_size=(32, 32),
                            temporal_size=4, **flags))


def _r2plus1d():
    conv = ("2plus1d",) * 4
    return (JR.VideoResNet(conv_makers=conv, layers=(1, 1, 1, 1),
                           stem_type="r2plus1d", num_classes=NUM_CLASSES),
            lambda: TR.VideoResNet(conv, layers=(1, 1, 1, 1),
                                   stem_type="r2plus1d",
                                   num_classes=NUM_CLASSES))


MODELS = {"r2plus1d": _r2plus1d, "mvit_v2": _mvit}


def clips(seed=0, n=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES, n).astype(np.int32)
    return x, labels


def jax_schedule():
    """``train.py:132-145``."""
    sched = optax.piecewise_constant_schedule(
        LR, {m * STEPS_PER_EPOCH: GAMMA for m in MILESTONES})
    warm = optax.linear_schedule(LR * WARMUP_DECAY, LR,
                                 WARMUP_EPOCHS * STEPS_PER_EPOCH)
    return optax.join_schedules([warm, sched], [WARMUP_EPOCHS * STEPS_PER_EPOCH])


def jax_steps(module, variables, x, labels, amp, steps=1):
    """The JAX recipe's ``train_step`` (``train.py:169-211``), ``steps``
    times on the same clips: the losses and the variables after."""
    tx = optax.chain(optax.add_decayed_weights(WD),
                     optax.sgd(jax_schedule(), momentum=MOMENTUM))
    params = variables["params"]
    bs = variables.get("batch_stats", {})
    opt_state = tx.init(params)

    def cast(tree):
        if not amp:
            return tree
        return jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)

    @jax.jit
    def step(params, bs, opt_state):
        def loss_fn(p):
            varz = {"params": cast(p)}
            video = cast(jnp.asarray(x))
            if bs:
                varz["batch_stats"] = bs
                logits, mutated = module.apply(varz, video, train=True,
                                               mutable=["batch_stats"])
                new_bs = jax.tree_util.tree_map(
                    lambda n, o: n.astype(o.dtype), mutated["batch_stats"], bs)
            else:
                logits, new_bs = module.apply(varz, video, train=True), bs
            logits = logits.astype(jnp.float32)
            one_hot = jax.nn.one_hot(jnp.asarray(labels), NUM_CLASSES)
            loss = -jnp.mean(jnp.sum(one_hot * jax.nn.log_softmax(logits), -1))
            return loss, new_bs

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_bs, opt_state, loss

    losses = []
    for _ in range(steps):
        params, bs, opt_state, loss = step(params, bs, opt_state)
        losses.append(float(loss))
    after = {"params": params}
    if bs:
        after["batch_stats"] = bs
    return losses, jax.tree_util.tree_map(np.asarray, after)


def port_steps(make, variables, x, labels, amp, steps=1):
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device="cpu")
    # a copy: the load may share the arrays' memory, which the steps change
    load_jax_variables(model, jax.tree_util.tree_map(np.array, variables))
    optimizer, scheduler = video_recipe_optimizer(
        model, lr=LR, momentum=MOMENTUM, weight_decay=WD,
        steps_per_epoch=STEPS_PER_EPOCH, milestones=MILESTONES, gamma=GAMMA,
        warmup_epochs=WARMUP_EPOCHS, warmup_decay=WARMUP_DECAY)
    step = make_train_step(model, optimizer,
                           compute_dtype=torch.bfloat16 if amp else None)
    batch = {"image": torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()),
             "label": torch.from_numpy(labels).long()}
    losses = []
    for _ in range(steps):
        losses.append(float(step(batch)["loss"]))
        scheduler.step()
    return losses, model


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    jm, make = MODELS[request.param]()
    x, labels = clips()
    variables = random_variables(jm, jnp.asarray(x[:1]))
    runs = {amp: jax_steps(jm, variables, x, labels, amp)
            for amp in (False, True)}

    def x64():
        """The f32 recipe step in f64 (``jax.enable_x64``): the sharp
        reference where f32 is not (batch statistics of four clips)."""
        with jax.enable_x64(True):
            v64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64)
                if np.issubdtype(np.asarray(a).dtype, np.floating) else a,
                variables)
            return jax_steps(jm, v64, x.astype(np.float64), labels, False)[1]

    return make, variables, x, labels, runs, x64


def port_state(make, variables):
    """JAX ``variables`` in the port's layout: name -> f64 array, the
    parameters and the running statistics."""
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device="cpu")
    load_jax_variables(model, jax.tree_util.tree_map(np.array, variables))
    return {n: t.detach().double().numpy()
            for n, t in list(model.named_parameters()) + list(
                model.named_buffers()) if t.is_floating_point()}


def change(after, before, names):
    return np.concatenate([(after[n] - before[n]).ravel() for n in names])


def update_gap(make, variables, after, want) -> float:
    """The relative Frobenius distance of JAX run ``after``'s change of the
    parameters from run ``want``'s."""
    start, a, w = (port_state(make, v) for v in (variables, after, want))
    names = [n for n in start if "running" not in n]
    ca, cw = change(a, start, names), change(w, start, names)
    return float(np.linalg.norm(ca - cw) / np.linalg.norm(cw))


def scale_along(after, f32, start, names) -> float:
    """How far run ``after`` changed the parameters along run ``f32``'s
    change, in units of that change."""
    ca, cf = change(after, start, names), change(f32, start, names)
    return float(ca @ cf / (cf @ cf))


def model_state(model):
    return {n: t.detach().double().numpy()
            for n, t in list(model.named_parameters()) + list(
                model.named_buffers()) if t.is_floating_point()}


def results(make, variables, model, want, f32=None):
    """The port's loss-independent results against JAX's: the parameters'
    change and the running statistics."""
    start = port_state(make, variables)
    ref = port_state(make, want)
    got = model_state(model)
    params = [n for n, _ in model.named_parameters()]
    got_change = change(got, start, params)
    want_change = change(ref, start, params)
    out = {"update": float(np.linalg.norm(got_change - want_change)
                           / np.linalg.norm(want_change)),
           "stats": max([float(np.abs(got[n] - ref[n]).max())
                         / max(float(np.abs(ref[n]).max()), 1e-3)
                         for n in got if "running" in n], default=0.0)}
    if f32 is not None:
        f32_change = change(port_state(make, f32), start, params)
        out["jax_amp_gap"] = float(np.linalg.norm(want_change - f32_change)
                                   / np.linalg.norm(f32_change))
    return out


def test_f32_step_matches_the_jax_recipe(case):
    make, variables, x, labels, runs, x64 = case
    (want_loss,), want = runs[False]
    with torch.backends.mkldnn.flags(enabled=False):
        (loss,), model = port_steps(make, variables, x, labels, amp=False)
    assert abs(loss - want_loss) / abs(want_loss) <= LOSS_TOL
    got = results(make, variables, model, want)
    assert got["stats"] <= STATS_TOL
    if got["update"] > UPDATE_TOL:
        sharp = x64()
        assert results(make, variables, model, sharp)["update"] <= 2.0 * (
            update_gap(make, variables, want, sharp))


def test_amp_step_matches_the_jax_recipe(case):
    make, variables, x, labels, runs, _ = case
    (_, f32), ((want_loss,), want) = runs[False], runs[True]
    with torch.backends.mkldnn.flags(enabled=False):
        (loss,), model = port_steps(make, variables, x, labels, amp=True)
    assert abs(loss - want_loss) / abs(want_loss) <= AMP_LOSS_TOL
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for n, b in model.named_buffers()
               if "running" in n)
    got = results(make, variables, model, want, f32)
    assert got["update"] <= max(2.0 * got["jax_amp_gap"], UPDATE_TOL)
    assert got["stats"] <= AMP_STATS_TOL
    with torch.backends.mkldnn.flags(enabled=False):
        _, model_f32 = port_steps(make, variables, x, labels, amp=False)
    start = port_state(make, variables)
    names = [n for n, _ in model.named_parameters()]
    jax_scale = scale_along(port_state(make, want), port_state(make, f32),
                            start, names)
    port_scale = scale_along(model_state(model), model_state(model_f32),
                             start, names)
    assert abs(port_scale - jax_scale) <= AMP_SCALE_TOL, (port_scale, jax_scale)


def test_the_recipe_optimizer_matches_the_optax_chain():
    """``video_recipe_optimizer`` against ``add_decayed_weights`` then
    ``sgd(schedule, momentum)``: five updates from fixed gradients across
    the warm-up and a milestone, at a decay of 0.5 so that its share of
    each update is large."""
    wd = 0.5
    rng = np.random.RandomState(4)
    w0 = rng.randn(3, 5).astype(np.float32)
    grads = rng.randn(5, 3, 5).astype(np.float32)
    model = torch.nn.Linear(5, 3, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w0))
    optimizer, scheduler = video_recipe_optimizer(
        model, lr=LR, momentum=MOMENTUM, weight_decay=wd,
        steps_per_epoch=STEPS_PER_EPOCH, milestones=MILESTONES, gamma=GAMMA,
        warmup_epochs=WARMUP_EPOCHS, warmup_decay=WARMUP_DECAY)
    tx = optax.chain(optax.add_decayed_weights(wd),
                     optax.sgd(jax_schedule(), momentum=MOMENTUM))
    want = jnp.asarray(w0)
    state = tx.init(want)
    for g in grads:
        model.weight.grad = torch.from_numpy(g.copy())
        optimizer.step()
        scheduler.step()
        updates, state = tx.update(jnp.asarray(g), state, want)
        want = optax.apply_updates(want, updates)
        np.testing.assert_allclose(model.weight.detach().numpy(),
                                   np.asarray(want), rtol=0, atol=1e-6)


def test_schedule_matches_optax():
    sched = jax_schedule()
    factor = video_lr_lambda(STEPS_PER_EPOCH, MILESTONES, GAMMA, WARMUP_EPOCHS,
                             WARMUP_DECAY)
    for step in range(12):
        assert abs(LR * factor(step) - float(sched(step))) <= 1e-7
    plain = video_lr_lambda(100)  # the recipe's defaults: no warm-up
    assert plain(0) == 1.0 and plain(2000) == pytest.approx(0.1)
    assert plain(3000) == pytest.approx(0.01)


def _jax_video_accuracy():
    spec = importlib.util.spec_from_file_location(
        "_ref_video_train", ROOT / "references" / "video_classification" / "train.py")
    sys.path.insert(0, str(ROOT / "references" / "classification"))
    try:
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(ROOT / "references" / "classification"))
    return module.VideoAccuracy


def test_video_accuracy_matches_jax():
    rng = np.random.RandomState(3)
    want, got = _jax_video_accuracy()(NUM_CLASSES), VideoAccuracy(NUM_CLASSES)
    for _ in range(3):
        ids = rng.randint(0, 5, 6)
        probs = rng.dirichlet(np.ones(NUM_CLASSES), 6).astype(np.float32)
        labels = (ids * 3) % NUM_CLASSES
        want.update(ids, probs, labels)
        got.update(torch.from_numpy(ids), torch.from_numpy(probs),
                   torch.from_numpy(labels))
    assert got.compute() == want.compute()
    assert VideoAccuracy(3).compute() == 0.0


def test_the_train_step_refuses_a_clip_of_another_rank():
    model = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.LazyLinear(3))
    step = make_train_step(model, torch.optim.SGD([torch.zeros(1)], lr=0.1))
    with pytest.raises(ValueError, match="N, 3, T, H, W"):
        step({"image": torch.zeros(2, 3, 4, 4, 4, 4), "label": torch.zeros(2)})
