"""Weights of the port: torchvision's parameter count, and
``load_jax_variables`` carrying every leaf of a JAX Faster R-CNN's
variables into the port and back (through the JAX package's own
``convert_torch_state_dict``) unchanged."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu._torch_convert import convert_torch_state_dict
from vision_tpu.models.detection.faster_rcnn import FasterRCNN as JaxFasterRCNN
from vision_tpu.models.detection.faster_rcnn import _frcnn_hooks
from vision_tpu_torch._jax_convert import load_jax_variables
from vision_tpu_torch.models import get_model
from vision_tpu_torch.models._api import Weights
from vision_tpu_torch.models.detection.faster_rcnn import (
    FasterRCNN,
    FasterRCNN_ResNet50_FPN_Weights,
    fasterrcnn_resnet50_fpn,
    init_weights,
)


def test_resnet50_fpn_parameter_count():
    model = get_model("fasterrcnn_resnet50_fpn", device="cpu")
    count = sum(p.numel() for p in model.parameters())
    assert count == 41_755_286
    assert count == FasterRCNN_ResNet50_FPN_Weights.COCO_V1.meta["num_params"]
    assert not model.training


def test_local_checkpoint_with_old_torchvision_names_loads(tmp_path):
    """Checkpoints written before torchvision wrapped the RPN and FPN convs
    in ``Conv2dNormActivation`` (the published COCO_V1 one among them)
    name them without the inner ``.0``."""
    src = FasterRCNN(backbone_depth=50)
    init_weights(src, torch.Generator().manual_seed(3))
    old = {}
    for k, v in src.state_dict().items():
        k = k.replace("rpn.head.conv.0.0.", "rpn.head.conv.")
        for blk in ("inner_blocks", "layer_blocks"):
            k = re.sub(rf"(fpn\.{blk}\.\d+)\.0\.", r"\1.", k)
        old[k] = v
    assert "backbone.fpn.inner_blocks.0.weight" in old
    path = tmp_path / "frcnn.pth"
    torch.save(old, path)
    model = fasterrcnn_resnet50_fpn(
        weights=Weights(FasterRCNN_ResNet50_FPN_Weights.COCO_V1.value.url,
                        path=str(path)),
        device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_state_dict_names_are_torchvision():
    keys = FasterRCNN(backbone_depth=50).state_dict().keys()
    for k in ("backbone.body.layer1.0.conv1.weight",
              "backbone.body.layer1.0.bn1.running_var",
              "backbone.body.layer1.0.downsample.1.weight",
              "backbone.fpn.inner_blocks.0.0.weight",
              "backbone.fpn.layer_blocks.3.0.bias",
              "rpn.head.conv.0.0.weight", "rpn.head.cls_logits.weight",
              "rpn.head.bbox_pred.bias", "roi_heads.box_head.fc6.weight",
              "roi_heads.box_predictor.cls_score.weight",
              "roi_heads.box_predictor.bbox_pred.weight"):
        assert k in keys, k


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def shapes():
    """Shapes of the JAX ResNet-50 FasterRCNN's variables (traced, not
    run)."""
    jm = JaxFasterRCNN(backbone_depth=50, num_classes=5)
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)))


def test_load_jax_variables_round_trips_every_leaf(shapes):
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    port = FasterRCNN(backbone_depth=50, num_classes=5)
    load_jax_variables(port, variables)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_torch_state_dict(sd, shapes, hooks=_frcnn_hooks)
    want = dict(_leaves(variables))
    got = dict(_leaves(jax.tree_util.tree_map(np.asarray, back)))
    assert got.keys() == want.keys()
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))


def test_load_jax_variables_rejects_a_missing_leaf(shapes):
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                       shapes)
    del variables["params"]["roi_heads.box_head"]["fc7"]
    with pytest.raises(KeyError, match="fc7"):
        load_jax_variables(FasterRCNN(backbone_depth=50, num_classes=5),
                           variables)


def test_published_weights_are_never_downloaded():
    with pytest.raises(FileNotFoundError, match="downloads are refused"):
        FasterRCNN_ResNet50_FPN_Weights.COCO_V1.get_state_dict()
