"""Faster R-CNN training parity: the port's matcher, box encoding, sampler,
RPN loss, training samples, box-head loss, whole ``compute_loss`` and one
backward pass (plain PyTorch paths on the CPU) against the JAX package on
the small model of ``test_torch_faster_rcnn.py`` (ResNet-18 FPN, 6
classes, RPN top-n 200/100, a 128x128 canvas), batch 2, G = 4 gt rows with
padding rows, the same weights on both sides.

``jax.random`` cannot be reproduced in torch, so where the port samples,
its sampler object is replaced by one that returns the masks the JAX
sampler draws from the keys ``compute_loss`` gives it
(``faster_rcnn.py:230``, ``rpn.py:204``, ``roi_heads.py:257``, and the
sampler's own split, ``_utils.py:242``), for the matches the port
computed; the sampler's own rule is tested on its own. The JAX side runs
under ``jit``; off the TPU its pooler is the dense one and the port's the
windowed one, which on this canvas has no overflowing RoI.

Tolerances: matches, labels and masks exactly equal; encoded deltas within
1e-6 relative; losses within 1e-5 relative (sums in another order);
gradients within 1e-3 of each tensor's largest value (f32 backward passes
of a deep net in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu._torch_convert import convert_torch_state_dict
from vision_tpu.models.detection import _utils as jutils
from vision_tpu.models.detection.faster_rcnn import FasterRCNN as JaxFasterRCNN
from vision_tpu.models.detection.faster_rcnn import _frcnn_hooks
from vision_tpu.models.detection.roi_heads import RoIHeadsLogic
from vision_tpu.models.detection.rpn import RegionProposalNetwork as JaxRPN
from vision_tpu_torch._jax_convert import (
    _leaves,
    _to_torch_layout,
    _torch_name,
    load_jax_variables,
)
from vision_tpu_torch.models.detection import _utils as tutils
from vision_tpu_torch.models.detection.backbone_utils import freeze_trunk_layers
from vision_tpu_torch.models.detection.faster_rcnn import FasterRCNN, init_weights
from vision_tpu_torch.models.detection.roi_heads import SampledProposals
from vision_tpu_torch.parallel import make_detection_train_step
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

CFG = dict(backbone_depth=18, num_classes=6, rpn_pre_nms_top_n=200,
           rpn_post_nms_top_n=100)
SIZE = 128
# two images, G = 4, padding rows (zeros, invalid) last
GT_BOXES = np.array([
    [[10, 12, 60, 70], [30, 40, 100, 120], [70, 5, 126, 50], [0, 0, 0, 0]],
    [[5, 5, 40, 30], [50, 60, 127, 110], [0, 0, 0, 0], [0, 0, 0, 0]],
], np.float32)
GT_LABELS = np.array([[1, 2, 5, 0], [3, 4, 0, 0]], np.int32)
GT_VALID = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
KEY = 3
# the gradients compared: the box head's first layer, the RPN head's conv,
# an FPN lateral conv and a conv of the last trunk stage
GRADS = ("roi_heads.box_head.fc6.weight", "rpn.head.conv.0.0.weight",
         "backbone.fpn.inner_blocks.2.0.weight",
         "backbone.body.layer4.1.conv2.weight")


def _rel_close(got, want, rel):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rel,
                               atol=0)


def _gt_torch():
    return (torch.from_numpy(GT_BOXES), torch.from_numpy(GT_LABELS).long(),
            torch.from_numpy(GT_VALID))


def _gt_jax():
    return jnp.asarray(GT_BOXES), jnp.asarray(GT_LABELS), jnp.asarray(GT_VALID)


class JaxSampler:
    """Stands in for the port's sampler: per image the masks that the JAX
    sampler draws from ``jax.random.split(key, N)[i]`` for the matches the
    port computed, which it keeps in ``self.matched``."""

    def __init__(self, sampler, key):
        self.sampler = sampler
        self.key = key

    def __call__(self, matched, generator):
        self.matched = matched.clone()
        keys = jax.random.split(self.key, matched.shape[0])
        pos, neg = jax.jit(jax.vmap(self.sampler))(
            jnp.asarray(matched.numpy().astype(np.int32)), keys)
        return torch.from_numpy(np.array(pos)), torch.from_numpy(np.array(neg))


@pytest.fixture(scope="module")
def pair():
    jm = JaxFasterRCNN(**CFG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    src = FasterRCNN(**CFG)
    init_weights(src, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    variables = jax.tree_util.tree_map(
        np.asarray, convert_torch_state_dict(sd, shapes, hooks=_frcnn_hooks))
    port = FasterRCNN(**CFG)
    load_jax_variables(port, variables)
    x = np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(KEY))

    def stages(v, x):
        feats, obj, deltas, anchors = jm.apply(
            v, x, method=lambda m, x: m._features_and_rpn(x))
        props = JaxRPN(pre_nms_top_n=200, post_nms_top_n=100).filter_proposals(
            obj, deltas, anchors, (SIZE, SIZE))
        return obj, deltas, anchors, props

    def loss_fn(params, v, x, key):
        losses = jm.apply({**v, "params": params}, x, *_gt_jax(), key,
                          method="compute_loss")
        return sum(losses.values()), losses

    obj, deltas, anchors, props = jax.jit(stages)(variables, jnp.asarray(x))
    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables, jnp.asarray(x),
        jax.random.PRNGKey(KEY))
    grads = {_torch_name("params", path): leaf
             for path, leaf in _leaves(jax.tree_util.tree_map(np.asarray, grads))}
    return dict(port=port, x=torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                k1=k1, k2=k2, obj=obj, deltas=deltas, anchors=anchors,
                props=props, losses=losses, grads=grads, jm=jm,
                variables=variables, x_nhwc=x)


def _tensors(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------- utils


@pytest.mark.parametrize("low_quality", [False, True])
@pytest.mark.parametrize("thresholds", [(0.7, 0.3), (0.5, 0.5)])
def test_matcher_matches_jax(thresholds, low_quality):
    """Qualities on a grid of 0.1 (exact ties between gt rows, between
    predictions and at the thresholds), invalid gt rows, an image with no
    valid gt row: the same matches as the JAX matcher, exactly."""
    rng = np.random.RandomState(1)
    quality = (rng.randint(0, 11, (3, 5, 40)) / 10.0).astype(np.float32)
    valid = rng.rand(3, 5) > 0.3
    valid[2] = False
    jm = jutils.Matcher(*thresholds, allow_low_quality_matches=low_quality)
    tm = tutils.Matcher(*thresholds, allow_low_quality_matches=low_quality)
    want = np.stack([np.asarray(jm(jnp.asarray(q), jnp.asarray(v)))
                     for q, v in zip(quality, valid)])
    got = tm(torch.from_numpy(quality), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == jutils.BELOW_LOW_THRESHOLD).any() and (want >= 0).any()
    assert (want[2] == jutils.BELOW_LOW_THRESHOLD).all()


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_encode_matches_jax(weights):
    """Within 1e-6 relative, and decode undoes it."""
    rng = np.random.RandomState(2)
    xy = rng.uniform(0, 100, (2, 50, 2))
    ref = np.concatenate([xy, xy + rng.uniform(1, 60, (2, 50, 2))], -1)
    prop = np.concatenate([xy + 3, xy + 3 + rng.uniform(1, 60, (2, 50, 2))], -1)
    ref, prop = ref.astype(np.float32), prop.astype(np.float32)
    want = np.asarray(jutils.BoxCoder(weights).encode(jnp.asarray(ref),
                                                      jnp.asarray(prop)))
    coder = tutils.BoxCoder(weights)
    got = coder.encode(torch.from_numpy(ref), torch.from_numpy(prop))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    back = coder.decode(got, torch.from_numpy(prop))[..., 0, :]
    np.testing.assert_allclose(back.numpy(), ref, atol=1e-3)


def test_sampler_rule():
    """Per row: min(#pos, 128) positives and min(#neg, 256 - that)
    negatives, subsets of their candidates and disjoint; the same masks
    from the same seed, other masks from another."""
    rng = np.random.RandomState(3)
    matched = rng.choice([-2, -1, 0, 3], size=(4, 1000), p=[0.2, 0.4, 0.2, 0.2])
    matched[1, :] = -2  # nothing to sample
    matched[2, 10:] = -1  # 10 positives at most
    matched[3, :] = rng.choice([0, -2], 1000)  # positives only
    m = torch.from_numpy(matched)
    sampler = tutils.BalancedPositiveNegativeSampler(256, 0.5)
    pos, neg = sampler(m, torch.Generator().manual_seed(0))
    n_pos = (m >= 0).sum(1)
    n_neg = (m == -1).sum(1)
    want_pos = n_pos.clamp(max=128)
    torch.testing.assert_close(pos.sum(1), want_pos)
    torch.testing.assert_close(neg.sum(1), torch.minimum(n_neg, 256 - want_pos))
    assert pos.sum(1)[2] == min(10, int(n_pos[2])) and neg.sum(1)[1] == 0
    assert not (pos & ~(m >= 0)).any() and not (neg & ~(m == -1)).any()
    assert not (pos & neg).any()
    again = sampler(m, torch.Generator().manual_seed(0))
    other = sampler(m, torch.Generator().manual_seed(1))
    assert torch.equal(again[0], pos) and torch.equal(again[1], neg)
    assert not torch.equal(other[0], pos)


def test_sampler_draws_in_a_fixed_order_from_the_generator():
    """Two calls on one generator continue its stream: the second call's
    masks are those of a generator advanced by the first call's draws."""
    m = torch.from_numpy(np.random.RandomState(4).choice([-1, 0], (2, 300)))
    sampler = tutils.BalancedPositiveNegativeSampler(64, 0.25)
    g = torch.Generator().manual_seed(7)
    sampler(m, g)
    second = sampler(m, g)
    g2 = torch.Generator().manual_seed(7)
    torch.rand(m.shape, generator=g2)
    torch.rand(m.shape, generator=g2)
    assert torch.equal(sampler(m, g2)[0], second[0])


# ---------------------------------------------------------------- stages


def test_rpn_compute_loss_matches_jax(pair, monkeypatch):
    """The JAX RPN head outputs and anchors into both losses, with the JAX
    sampler's masks: the same matches, losses within 1e-5 relative."""
    rpn = pair["port"].rpn
    fake = JaxSampler(jutils.BalancedPositiveNegativeSampler(256, 0.5),
                      pair["k1"])
    monkeypatch.setattr(rpn, "sampler", fake)
    got = rpn.compute_loss(_tensors(pair["obj"]), _tensors(pair["deltas"]),
                           _tensors(pair["anchors"]), *_gt_torch()[::2], None)
    want = jax.jit(lambda o, d, a, b, v, k: JaxRPN().compute_loss(o, d, a, b, v, k))(
        pair["obj"], pair["deltas"], pair["anchors"], jnp.asarray(GT_BOXES),
        jnp.asarray(GT_VALID), pair["k1"])
    for k in want:
        _rel_close(float(got[k]), float(want[k]), 1e-5)
    assert float(want["loss_rpn_box_reg"]) > 0
    anchors = jnp.concatenate(pair["anchors"], 0)
    from vision_tpu.ops.boxes import box_iou

    matcher = jutils.Matcher(0.7, 0.3, allow_low_quality_matches=True)
    jmatched = np.stack([np.asarray(matcher(box_iou(jnp.asarray(b), anchors),
                                            jnp.asarray(v)))
                         for b, v in zip(GT_BOXES, GT_VALID)])
    np.testing.assert_array_equal(fake.matched.numpy(), jmatched)


def _jax_sampled(pair):
    props = pair["props"]
    return jax.jit(lambda p, pv, b, l, v, k: RoIHeadsLogic().select_training_samples(
        p, pv, b, l, v, k))(props.boxes, props.valid, *_gt_jax(), pair["k2"])


def test_select_training_samples_matches_jax(pair, monkeypatch):
    """The JAX proposals into both, with the JAX sampler's masks: the same
    rows (boxes, labels, masks, matched gt) in the same order, targets
    within 1e-6 relative to their largest value."""
    heads = pair["port"].roi_heads
    monkeypatch.setattr(heads, "sampler", JaxSampler(
        jutils.BalancedPositiveNegativeSampler(512, 0.25), pair["k2"]))
    props = pair["props"]
    got = heads.select_training_samples(
        *_tensors((props.boxes, props.valid)), *_gt_torch(), None)
    want = _jax_sampled(pair)
    assert isinstance(got, SampledProposals)
    for name in ("boxes", "labels", "pos_mask", "valid", "matched_gt"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    targets = np.asarray(want.reg_targets)
    np.testing.assert_allclose(got.reg_targets.numpy(), targets, rtol=0,
                               atol=1e-6 * np.abs(targets).max())
    assert got.pos_mask.sum() > 4 and got.valid.sum() > got.pos_mask.sum()


def test_fastrcnn_loss_matches_jax(pair):
    """The JAX samples and seeded logits into both: within 1e-5 relative."""
    want_s = _jax_sampled(pair)
    n, s = want_s.labels.shape
    rng = np.random.RandomState(5)
    logits = (rng.randn(n, s, 6) * 2).astype(np.float32)
    reg = (rng.randn(n, s, 24) * 0.5).astype(np.float32)
    want = jax.jit(RoIHeadsLogic().fastrcnn_loss)(
        jnp.asarray(logits), jnp.asarray(reg), want_s)
    sampled = SampledProposals(*_tensors(want_s))
    sampled = sampled._replace(labels=sampled.labels.long())
    got = pair["port"].roi_heads.fastrcnn_loss(
        torch.from_numpy(logits), torch.from_numpy(reg), sampled)
    for k in want:
        _rel_close(float(got[k]), float(want[k]), 1e-5)


# ---------------------------------------------------------------- whole


@pytest.fixture(scope="module")
def port_run(pair):
    """The port's ``compute_loss`` with both samplers handed the JAX masks,
    and the gradients of the summed losses."""
    port = pair["port"]
    port.zero_grad(set_to_none=True)
    rpn_sampler, head_sampler = port.rpn.sampler, port.roi_heads.sampler
    port.rpn.sampler = JaxSampler(
        jutils.BalancedPositiveNegativeSampler(256, 0.5), pair["k1"])
    port.roi_heads.sampler = JaxSampler(
        jutils.BalancedPositiveNegativeSampler(512, 0.25), pair["k2"])
    try:
        losses = port.compute_loss(pair["x"], *_gt_torch(), None)
        sum(losses.values()).backward()
    finally:
        port.rpn.sampler, port.roi_heads.sampler = rpn_sampler, head_sampler
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    port.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def test_compute_loss_matches_jax(pair, port_run):
    losses, _ = port_run
    assert set(losses) == set(pair["losses"])
    for k, want in pair["losses"].items():
        _rel_close(losses[k], float(want), 1e-5)
    assert all(v > 0 for v in losses.values())


@pytest.mark.parametrize("name", GRADS)
def test_one_backward_matches_jax_grad(pair, port_run, name):
    """Within 1e-3 of the largest value of each gradient."""
    _, grads = port_run
    port = pair["port"]
    target = dict(port.named_parameters())[name]
    want = _to_torch_layout(name, pair["grads"][name], target, port)
    got = grads[name].numpy()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)


# ---------------------------------------------------------------- repairs


def test_rpn_loss_is_finite_for_an_image_without_gt():
    """Image 0 has no valid gt box; image 1's padding row comes first. The
    port encodes the anchors that are not positive against a unit box, so
    its losses and their gradients are finite. The JAX package encodes them
    against gt row 0, a zero box, and its ``loss_rpn_box_reg`` has a NaN
    gradient there (``rpn.py:196-200``): a difference by design."""
    rng = np.random.RandomState(6)
    anchors = np.concatenate([rng.uniform(0, 60, (50, 2)),
                              rng.uniform(70, 120, (50, 2))], 1).astype(np.float32)
    obj = rng.randn(2, 50).astype(np.float32)
    deltas = (rng.randn(2, 50, 4) * 0.1).astype(np.float32)
    boxes = np.zeros((2, 3, 4), np.float32)
    boxes[1, 1:] = anchors[:2] + 1.0
    valid = np.array([[0, 0, 0], [0, 1, 1]], bool)

    jrpn = JaxRPN()
    def jax_box_loss(d):
        return jrpn.compute_loss([jnp.asarray(obj)], [d], [jnp.asarray(anchors)],
                                 jnp.asarray(boxes), jnp.asarray(valid),
                                 jax.random.PRNGKey(0))["loss_rpn_box_reg"]
    jgrad = np.asarray(jax.jit(jax.grad(jax_box_loss))(jnp.asarray(deltas)))
    assert np.isnan(jgrad).any()

    rpn = FasterRCNN(**CFG).rpn
    o = torch.from_numpy(obj).requires_grad_()
    d = torch.from_numpy(deltas).requires_grad_()
    losses = rpn.compute_loss([o], [d], [torch.from_numpy(anchors)],
                              torch.from_numpy(boxes), torch.from_numpy(valid),
                              torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    for v in (*losses.values(), o.grad, d.grad):
        assert torch.isfinite(v).all()
    assert float(losses["loss_rpn_box_reg"].detach()) > 0
    assert not d.grad[0].any()  # no positives in image 0


def test_proposals_carry_no_gradient(pair):
    port = pair["port"]
    with torch.enable_grad():
        _, obj, deltas, anchors = port.features_and_rpn(pair["x"][:1])
        props = port.rpn.filter_proposals(obj, deltas, anchors, (SIZE, SIZE))
    assert obj[0].requires_grad and not props.boxes.requires_grad


# ---------------------------------------------------------------- step


def test_freeze_trunk_layers():
    model = FasterRCNN(**CFG)
    freeze_trunk_layers(model.backbone.body, 3)
    for name, p in model.named_parameters():
        frozen = name.startswith(("backbone.body.conv1", "backbone.body.layer1"))
        assert p.requires_grad != frozen, name
    freeze_trunk_layers(model.backbone.body, 5)
    assert all(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="trainable_layers"):
        freeze_trunk_layers(model.backbone.body, 6)


def test_detection_train_step():
    """Three SGD steps on the CPU: finite losses that sum to ``loss``, the
    trained parameters updated, the frozen stages untouched, the model in
    training mode. From the same weights and seed, the first step's losses
    again to the bit; the later ones within 1e-5 relative, since PyTorch's
    CPU backward passes (the plain versions' scatter-adds among them) sum
    in an order that can change with their threads."""
    def run():
        model = FasterRCNN(**CFG)
        init_weights(model, torch.Generator().manual_seed(0))
        freeze_trunk_layers(model.backbone.body, 3)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                              lr=0.02, momentum=0.9, weight_decay=1e-4)
        step = make_detection_train_step(model.eval(), opt)
        boxes, labels, valid = _gt_torch()
        x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, SIZE, SIZE)
                             .astype(np.float32))
        g = torch.Generator().manual_seed(0)
        outs = [step({"image": x, "boxes": boxes, "labels": labels,
                      "valid": valid}, g) for _ in range(3)]
        return model, before, outs

    model, before, outs = run()
    assert model.training
    for out in outs:
        assert set(out) == {"loss", "loss_objectness", "loss_rpn_box_reg",
                            "loss_classifier", "loss_box_reg"}
        assert all(torch.isfinite(v) and v.dim() == 0 for v in out.values())
        parts = sum(v for k, v in out.items() if k != "loss")
        torch.testing.assert_close(out["loss"], parts)
    assert float(outs[2]["loss"]) != float(outs[0]["loss"])
    for name, p in model.named_parameters():
        changed = not torch.equal(p.detach(), before[name])
        assert changed == p.requires_grad, name
    _, _, again = run()
    assert all(torch.equal(outs[0][k], again[0][k]) for k in outs[0])
    for a, b in zip(outs[1:], again[1:]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=0)


# ---------------------------------------------------------------- amp


# The bf16 step against the JAX recipe's amp step (``references/detection/
# engine.py:24-37``: the variables and the image cast to bf16, the gt f32),
# the RoI head handed the JAX run's own samples (in bf16 the two libraries'
# proposals part by round-off, and a proposal that moves changes the
# samples, as NMS and top-k on bf16 scores break ties by other rules), the
# RPN sampler the JAX masks as above. Tolerances: each layer rounds its
# output to bf16 (2**-9 relative), the two libraries at other places and
# with other sums, over some twenty layers of trunk, FPN and heads, which
# ``test_torch_amp.py`` holds to 3e-2 of
# each map's largest value; the losses are smooth functions of those
# outputs taken in f32: within 3e-2 relative. A gradient passes the chain
# twice, the activations and the cotangents each rounded in bf16, and deep
# in the trunk a ReLU whose pre-activation lies within bf16 round-off of 0
# takes the other branch in one library and not the other: two bf16 paths
# may each lie as far from the f32 gradient as bf16 arithmetic carries it.
# So a gradient is held to twice how far the JAX amp step's own gradient
# lies from the f32 gradient (each relative to the f32 gradient's largest
# value), which itself must stay under AMP_NOISE_MAX: a path that computed
# another function would lie at the order of the gradient itself.
AMP_LOSS_TOL = 3e-2
AMP_NOISE_MAX = 0.25


def _bf16(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


@pytest.fixture(scope="module")
def amp_pair(pair):
    """The JAX amp step's losses, gradients and samples, and one bf16 step
    of ``make_detection_train_step`` (SGD at lr 0) on the port with those
    samples: its losses and gradients."""
    jm, variables = pair["jm"], pair["variables"]
    image = jnp.asarray(pair["x_nhwc"]).astype(jnp.bfloat16)

    def loss_fn(params):
        losses, (_, sampled, _) = jm.apply(
            {**_bf16(variables), "params": _bf16(params)}, image, *_gt_jax(),
            jax.random.PRNGKey(KEY), method="compute_loss",
            _return_internals=True)
        return sum(v.astype(jnp.float32) for v in losses.values()), (
            losses, sampled)

    (_, (losses, sampled)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    grads = {_torch_name("params", path): leaf for path, leaf in _leaves(
        jax.tree_util.tree_map(np.asarray, grads))}
    samples = SampledProposals(*_tensors(sampled))
    samples = samples._replace(labels=samples.labels.long())

    port = pair["port"]
    heads = port.roi_heads
    rpn_sampler = port.rpn.sampler
    port.rpn.sampler = JaxSampler(
        jutils.BalancedPositiveNegativeSampler(256, 0.5), pair["k1"])
    heads.select_training_samples = lambda *args: samples
    was_training = port.training
    try:
        opt = torch.optim.SGD(port.parameters(), lr=0.0)
        step = make_detection_train_step(port, opt,
                                         compute_dtype=torch.bfloat16)
        boxes, labels, valid = _gt_torch()
        out = step({"image": pair["x"], "boxes": boxes, "labels": labels,
                    "valid": valid}, None)
    finally:
        port.rpn.sampler = rpn_sampler
        del heads.select_training_samples
        port.train(was_training)
    port_grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    port.zero_grad(set_to_none=True)
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads=grads, port_losses={k: float(v) for k, v in out.items()},
                port_grads=port_grads)


def test_amp_step_losses_match_jax(pair, amp_pair):
    """The four losses within ``AMP_LOSS_TOL`` of the JAX amp step's, summed
    into ``loss``; and not the f32 step's: the step ran in bf16."""
    got, want = amp_pair["port_losses"], amp_pair["losses"]
    assert set(got) == set(want) | {"loss"}
    for k, v in want.items():
        _rel_close(got[k], v, AMP_LOSS_TOL)
    np.testing.assert_allclose(got["loss"], sum(got[k] for k in want),
                               rtol=1e-6)
    f32 = {k: float(v) for k, v in pair["losses"].items()}
    assert max(abs(got[k] - f32[k]) / abs(f32[k]) for k in want) > 1e-5


@pytest.mark.parametrize("name", GRADS)
def test_amp_step_gradients_match_jax(pair, amp_pair, name):
    """f32 master gradients (through the cast) within twice the JAX amp
    step's own distance from the JAX f32 gradient, relative to the f32
    gradient's largest value."""
    port = pair["port"]
    target = dict(port.named_parameters())[name]
    want = _to_torch_layout(name, amp_pair["grads"][name], target, port)
    f32 = _to_torch_layout(name, pair["grads"][name], target, port)
    got = amp_pair["port_grads"][name]
    assert got.dtype == torch.float32
    scale = np.abs(f32).max()
    noise = np.abs(want - f32).max() / scale
    assert 0 < noise < AMP_NOISE_MAX  # the JAX step ran in bf16, and near f32
    assert np.abs(got.numpy() - want).max() <= 2 * noise * scale


def test_amp_step_trains_in_bf16_with_f32_masters():
    """Three bf16 steps on the CPU: finite losses, the parameters and the
    momentum buffers f32 and updated, the pooler's backward passes taken in
    bf16 (its plain versions, on the CPU), the first step's losses again to
    the bit from the same weights and seed."""
    poolers = importlib.import_module("vision_tpu_torch.ops.poolers")
    roi_mod = importlib.import_module("vision_tpu_torch.ops.roi_align")
    seen = []

    def spy(fn):
        def call(grad, *args):
            seen.append(grad.dtype)
            return fn(grad, *args)
        return call

    def run():
        model = FasterRCNN(**CFG)
        init_weights(model, torch.Generator().manual_seed(0))
        freeze_trunk_layers(model.backbone.body, 3)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                              lr=0.02, momentum=0.9, weight_decay=1e-4)
        step = make_detection_train_step(model, opt,
                                         compute_dtype=torch.bfloat16)
        boxes, labels, valid = _gt_torch()
        x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, SIZE, SIZE)
                             .astype(np.float32))
        g = torch.Generator().manual_seed(0)
        outs = [step({"image": x, "boxes": boxes, "labels": labels,
                      "valid": valid}, g) for _ in range(3)]
        return model, opt, before, outs

    saved = (poolers.window_pool_backward_plain, roi_mod.roi_align_backward_plain)
    poolers.window_pool_backward_plain = spy(saved[0])
    roi_mod.roi_align_backward_plain = spy(saved[1])
    try:
        model, opt, before, outs = run()
    finally:
        poolers.window_pool_backward_plain, roi_mod.roi_align_backward_plain = saved
    assert seen and set(seen) == {torch.bfloat16}
    for out in outs:
        assert all(torch.isfinite(v) and v.dtype == torch.float32
                   for v in out.values())
        torch.testing.assert_close(out["loss"], sum(
            v for k, v in out.items() if k != "loss"))
    assert float(outs[2]["loss"]) != float(outs[0]["loss"])
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert (not torch.equal(p.detach(), before[name])) == p.requires_grad
    assert all(s["momentum_buffer"].dtype == torch.float32
               for s in opt.state.values())
    _, _, _, again = run()
    assert all(torch.equal(outs[0][k], again[0][k]) for k in outs[0])
