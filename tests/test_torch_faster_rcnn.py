"""Faster R-CNN parity, stage by stage: the port (``vision_tpu_torch``,
plain PyTorch paths on the CPU) against the JAX package on one small
model (ResNet-18 FPN, 6 classes, RPN top-n 200/100, 128x128 input) with
the same weights.

The weights are drawn by the port's seeded init, converted to flax
variables by the JAX package's own converter (``convert_torch_state_dict``
with ``_frcnn_hooks``), and loaded back into a fresh port model with
``load_jax_variables``, so both sides run JAX's variables. Padding rows
(scores -inf in the RPN, -1 in the postprocess) are arbitrary ties and are
never compared.

Tolerances: features 1e-4 relative to the largest value (conv sums in
another order); boxes 1e-4 absolute on a 128-px canvas; scores 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu._torch_convert import convert_torch_state_dict
from vision_tpu.models.detection.faster_rcnn import FasterRCNN as JaxFasterRCNN
from vision_tpu.models.detection.faster_rcnn import _frcnn_hooks
from vision_tpu.models.detection.roi_heads import RoIHeadsLogic
from vision_tpu.models.detection.rpn import RegionProposalNetwork as JaxRPN
from vision_tpu_torch._jax_convert import load_jax_variables
from vision_tpu_torch.models.detection.faster_rcnn import FasterRCNN, init_weights

CFG = dict(backbone_depth=18, num_classes=6, rpn_pre_nms_top_n=200,
           rpn_post_nms_top_n=100)
SIZE = 128


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-6))


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
    port = FasterRCNN(**CFG).eval()
    load_jax_variables(port, variables)
    x = np.random.RandomState(0).rand(1, SIZE, SIZE, 3).astype(np.float32)
    feats, obj, deltas, anchors = jax.jit(
        lambda v, x: jm.apply(v, x, method=lambda m, x: m._features_and_rpn(x))
    )(variables, jnp.asarray(x))
    with torch.no_grad():
        tout = port.features_and_rpn(torch.from_numpy(x).permute(0, 3, 1, 2))
    return dict(jm=jm, variables=variables, port=port, x=x,
                jax=(feats, obj, deltas, anchors), torch=tout)


def test_fpn_features_and_rpn_head(pair):
    feats, obj, deltas, anchors = pair["jax"]
    tfeats, tobj, tdeltas, tanchors = pair["torch"]
    assert list(tfeats) == list(feats)
    for k in feats:
        _close(tfeats[k].permute(0, 2, 3, 1).numpy(), feats[k])
    for a, b in zip(tobj, obj):
        _close(a.numpy(), b)
    for a, b in zip(tdeltas, deltas):
        _close(a.numpy(), b)
    for a, b in zip(tanchors, anchors):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _jax_proposals(pair):
    _, obj, deltas, anchors = pair["jax"]
    rpn = JaxRPN(pre_nms_top_n=200, post_nms_top_n=100)
    return jax.jit(lambda o, d, a: rpn.filter_proposals(o, d, a, (SIZE, SIZE)))(
        obj, deltas, anchors)


def test_filter_proposals_same_inputs(pair):
    _, obj, deltas, anchors = pair["jax"]
    want = _jax_proposals(pair)
    got = pair["port"].rpn.filter_proposals(
        [torch.from_numpy(np.array(o)) for o in obj],
        [torch.from_numpy(np.array(d)) for d in deltas],
        [torch.from_numpy(np.array(a)) for a in anchors], (SIZE, SIZE))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 50
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], atol=1e-5)
    np.testing.assert_array_equal(got.scores.numpy()[valid],
                                  np.asarray(want.scores)[valid])


def test_postprocess_same_logits(pair):
    props = _jax_proposals(pair)
    rng = np.random.RandomState(1)
    logits = (rng.randn(1, 100, 6) * 2).astype(np.float32)
    reg = (rng.randn(1, 100, 24) * 0.5).astype(np.float32)
    want = jax.jit(lambda *a: RoIHeadsLogic().postprocess_detections(
        *a, (SIZE, SIZE)))(jnp.asarray(logits), jnp.asarray(reg),
                           props.boxes, props.valid)
    got = pair["port"].roi_heads.postprocess_detections(
        torch.from_numpy(logits), torch.from_numpy(reg),
        torch.from_numpy(np.array(props.boxes)),
        torch.from_numpy(np.array(props.valid)), (SIZE, SIZE))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got.labels.numpy()[valid],
                                  np.asarray(want.labels)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], atol=1e-4)


def test_end_to_end_valid_rows(pair):
    want = jax.jit(lambda v, x: pair["jm"].apply(v, x))(
        pair["variables"], jnp.asarray(pair["x"]))
    with torch.no_grad():
        got = pair["port"](torch.from_numpy(pair["x"]).permute(0, 3, 1, 2))
    assert got.boxes.shape == (1, 100, 4) and got.valid.shape == (1, 100)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got.labels.numpy()[valid],
                                  np.asarray(want.labels)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], atol=1e-4)
