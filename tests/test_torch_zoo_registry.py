"""The classification zoo's registry, weights, builders, stochastic
layers and feature extraction, the port against ``vision_tpu`` on the
CPU: ``list_models()`` holds every JAX classification builder of the
fifteen families; each builder's parameter count on the meta device is
its JAX weights' ``num_params``, and its weights enum carries JAX's
checkpoints, accuracies and presets; builders run on the card unless asked
for the CPU; stochastic depth and dropout draw from the generator handed
to the model or to ``make_train_step``; ``create_feature_extractor``
returns JAX's names and values (1e-5 of the largest).
"""

import importlib

import jax.numpy as jnp
import pytest
import torch

from vision_tpu.models import get_model_builder as jbuilder
from vision_tpu.models import get_model_weights as jweights
from vision_tpu.models import list_models as jlist
from vision_tpu.models._utils import VisionModel
from vision_tpu.models import feature_extraction as jfx
from vision_tpu_torch.models import feature_extraction as tfx
from vision_tpu_torch.models import get_model, get_model_weights, list_models
from vision_tpu_torch.models._utils import eval_size
from vision_tpu_torch.parallel import make_train_step

from torch_zoo_cases import Pair, as_port, images, nchw, rel

FAMILIES = ("efficientnet", "convnext", "swin_transformer", "mobilenetv2",
            "mobilenetv3", "mnasnet", "regnet", "maxvit", "shufflenetv2",
            "squeezenet", "alexnet", "vgg", "densenet", "googlenet",
            "inception")
BUILDERS = sorted(n for n in jlist() if jbuilder(n).__module__ in
                  {f"vision_tpu.models.{f}" for f in FAMILIES})


def test_list_models_holds_every_jax_classification_builder():
    assert len(BUILDERS) == 65
    assert set(BUILDERS) <= set(list_models())


@pytest.mark.parametrize("name", BUILDERS)
def test_parameter_count_and_weights_match_jax(name):
    model = get_model(name, device="meta")
    want = jweights(name)
    assert sum(p.numel() for p in model.parameters()) == \
        want.DEFAULT.meta["num_params"]
    got = get_model_weights(name)
    assert list(got.__members__) == list(want.__members__)
    assert got.DEFAULT.name == want.DEFAULT.name
    for member in want.__members__:
        w, g = want[member], got[member]
        assert g.value.url == w.url
        assert g.meta["num_params"] == w.meta["num_params"]
        assert g.meta["_metrics"] == w.meta["_metrics"]
        assert g.meta["_ops"] == w.meta["_ops"]
        assert g.transforms.keywords == {
            "crop_size": 224, "resize_size": 256, "interpolation": "bilinear",
            **w.transforms.keywords}


def test_builders_run_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")  # never here: the CPU suite
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("mobilenet_v3_small")
    model = get_model("mobilenet_v3_small", device="cpu")
    again = get_model("mobilenet_v3_small", device="cpu")
    assert not model.training
    for (n, p), q in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(p, q) and bool(torch.isfinite(p.float()).all()), n
    other = get_model("mobilenet_v3_small", device="cpu", seed=1)
    assert not torch.equal(model.features[0][0].weight,
                           other.features[0][0].weight)
    assert eval_size(get_model_weights("inception_v3").DEFAULT) == 299


def _stochastic_effnet():
    m = importlib.import_module("vision_tpu_torch.models.efficientnet")
    setting = [m.fusedconf(1, 3, 1, 8, 8, 2), m.mbconf(4, 3, 1, 8, 8, 2)]
    model = m.EfficientNet(setting, 0.5, stochastic_depth_prob=0.5,
                           num_classes=10)
    m.init_weights(model, torch.Generator().manual_seed(0))
    return model


def test_stochastic_layers_draw_from_the_generator():
    model = _stochastic_effnet().train()
    x = torch.randn(4, 3, 16, 16)
    with pytest.raises(ValueError, match="generator"):
        model(x)
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(0))
        b = model(x, generator=torch.Generator().manual_seed(0))
        c = model(x, generator=torch.Generator().manual_seed(1))
        model.eval()
        d = model(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, d)


def test_train_step_hands_its_generator_to_the_model():
    """The same seed gives the same step; another seed another; without a
    generator a model with stochastic depth cannot train."""
    x = torch.randn(4, 3, 16, 16)
    batch = {"image": x, "label": torch.tensor([1, 2, 3, 4])}
    losses = []
    for seed in (0, 0, 1):
        model = _stochastic_effnet()
        step = make_train_step(model, torch.optim.SGD(model.parameters(),
                                                      lr=0.1))
        losses.append(float(step(batch, torch.Generator().manual_seed(seed))
                            ["loss"]))
    assert losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="generator"):
        step(batch)


def test_zoo_builders_are_exported():
    models = importlib.import_module("vision_tpu_torch.models")
    for name in BUILDERS:
        assert name in models.__all__ and callable(getattr(models, name))
    assert {"create_feature_extractor", "get_graph_node_names"} <= set(
        models.__all__)


@pytest.fixture(scope="module")
def mobilenet():
    jm = importlib.import_module("vision_tpu.models.mobilenetv3")
    tm = importlib.import_module("vision_tpu_torch.models.mobilenetv3")
    conf = [(8, 3, 8, 8, False, False, 1, 1),
            (8, 3, 24, 12, True, True, 2, 1)]
    module = jm.MobileNetV3(setting=tuple(jm.IRConf(*c) for c in conf),
                            last_channel=32, num_classes=10)
    x = images(2, 64, seed=9)
    return Pair(module, lambda: tm.MobileNetV3(
        [tm.IRConf(*c) for c in conf], 32, num_classes=10), x), x


def test_feature_extraction_matches_jax(mobilenet):
    pair, x = mobilenet
    jmodel = VisionModel(pair.module, pair.variables)
    assert tfx.get_graph_node_names(pair.port) == \
        jfx.get_graph_node_names(jmodel)
    nodes = {"features.1": "low", "features.3": "high"}
    want = jfx.create_feature_extractor(jmodel, nodes)(jnp.asarray(x))
    extractor = tfx.create_feature_extractor(pair.port, nodes)
    with torch.no_grad():
        got = extractor(nchw(x))
    assert list(got) == ["low", "high"]
    for k in got:
        assert rel(got[k].numpy(), as_port(want[k])) <= 1e-5, k
    everything = tfx.create_feature_extractor(pair.port, list(nodes))(nchw(x))
    assert list(everything) == list(nodes)
    with pytest.raises(KeyError, match="features.9"):
        tfx.create_feature_extractor(pair.port, ["features.9"])(nchw(x))


def test_feature_extraction_covers_resnet_and_vit():
    """The port's earlier models already return their features."""
    resnet = get_model("resnet18", device="cpu")
    assert tfx.get_graph_node_names(resnet) == ["layer1", "layer2", "layer3",
                                                "layer4"]
    vit = importlib.import_module("vision_tpu_torch.models.vision_transformer")
    model = vit.VisionTransformer(32, 8, 2, 2, 16, 32, num_classes=10).eval()
    names = tfx.get_graph_node_names(model, torch.zeros(1, 3, 32, 32))
    assert names == ["encoder.layers.encoder_layer_0",
                     "encoder.layers.encoder_layer_1", "encoder.ln"]
    extractor = tfx.create_feature_extractor(model, {"encoder.ln": "out"})
    gen = torch.Generator().manual_seed(0)
    assert extractor(torch.zeros(2, 3, 32, 32), gen)["out"].shape == (2, 17, 16)
    with pytest.raises(ValueError, match="return_features"):
        tfx.create_feature_extractor(torch.nn.Linear(2, 2))


def test_checkpoint_hooks():
    """torchvision's state dicts as the port loads them: Swin's computed
    buffers dropped and v2's key bias zeroed, MaxViT's index dropped, old
    DenseNet names renamed, GoogLeNet's auxiliary heads dropped."""
    swin = importlib.import_module("vision_tpu_torch.models.swin_transformer")
    state = {"features.1.0.attn.qkv.bias": torch.ones(6),
             "features.1.0.attn.logit_scale": torch.zeros(2, 1, 1),
             "features.1.0.attn.relative_coords_table": torch.zeros(1),
             "features.1.0.attn.relative_position_index": torch.zeros(1)}
    out = swin._checkpoint_hook(state)
    assert set(out) == {"features.1.0.attn.qkv.bias",
                        "features.1.0.attn.logit_scale"}
    assert out["features.1.0.attn.qkv.bias"].tolist() == [1, 1, 0, 0, 1, 1]
    assert state["features.1.0.attn.qkv.bias"].tolist() == [1] * 6
    dense = importlib.import_module("vision_tpu_torch.models.densenet")
    assert list(dense._checkpoint_hook(
        {"features.denseblock1.denselayer1.norm.1.weight": 0})) == [
        "features.denseblock1.denselayer1.norm1.weight"]
    goog = importlib.import_module("vision_tpu_torch.models.googlenet")
    assert list(goog._checkpoint_hook({"aux1.fc1.weight": 0, "fc.bias": 1})) \
        == ["fc.bias"]
    maxvit = importlib.import_module("vision_tpu_torch.models.maxvit")
    assert maxvit._checkpoint_hook({"a.relative_position_index": 0}) == {}
