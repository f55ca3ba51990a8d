"""The classification zoo on the card: each family's forward on the card
against the CPU at small sizes, in f32 and bf16, and
``make_train_step(generator=...)`` on the card giving the same loss twice
for the same seed (and another for another). Marked ``cuda``; every test
skips where no CUDA device is present (decided inside the fixture). Run on
a GPU host with:

    python -m pytest tests/test_torch_zoo_cuda.py -m cuda --noconftest

Tolerances (TF32 off): f32 logits within 1e-4 of the largest CPU logit;
bf16 (``tools/zoo.py:to_bf16``: batch-norm statistics kept f32) within
2e-2 of the largest logit of the same bf16 model on the CPU, or no further
from the f32 logits than twice the CPU's bf16 ones are (Swin v2's cosine
attention leaves the CPU's own bf16 logits 2.8e-2 from f32 here).
"""

import copy
import importlib

import pytest
import torch

from vision_tpu_torch.tools import zoo

pytestmark = pytest.mark.cuda

# module, class, arguments, image size: one small model a family
FAMILIES = {
    "efficientnet": ("efficientnet", "EfficientNet", lambda m: (
        [m.fusedconf(1, 3, 1, 8, 8, 2), m.fusedconf(4, 3, 2, 8, 16, 1),
         m.mbconf(4, 3, 2, 16, 24, 2)], 0.2), {"num_classes": 10}, 32),
    "convnext": ("convnext", "ConvNeXt", lambda m: (
        [m.CNBlockConfig(16, 32, 2), m.CNBlockConfig(32, None, 2)],),
        {"num_classes": 10, "stochastic_depth_prob": 0.5, "layer_scale": 1.0},
        32),
    "swin": ("swin_transformer", "SwinTransformer", lambda m: (
        (2, 2), 16, (2, 2), (2, 4), (4, 4)), {"num_classes": 10}, 36),
    "swin_v2": ("swin_transformer", "SwinTransformer", lambda m: (
        (2, 2), 16, (2, 2), (2, 4), (4, 4)), {"num_classes": 10, "v2": True},
        36),
    "maxvit": ("maxvit", "MaxVit", lambda m: (), dict(
        stem_channels=8, block_channels=(8, 16), block_layers=(1, 1),
        head_dim=4, partition_size=2, mlp_ratio=2, num_classes=10), 32),
    "mobilenet_v2": ("mobilenetv2", "MobileNetV2", lambda m: (),
                     {"num_classes": 10}, 32),
    "mobilenet_v3": ("mobilenetv3", "MobileNetV3", lambda m: (
        [m.IRConf(8, 3, 8, 8, False, False, 1, 1),
         m.IRConf(8, 3, 24, 12, True, True, 2, 1)], 32), {"num_classes": 10},
        32),
    "mnasnet": ("mnasnet", "MNASNet", lambda m: (0.5,), {"num_classes": 10}, 64),
    "regnet": ("regnet", "RegNet", lambda m: (
        ((16, 2, 1, 8, 1.0), (24, 2, 2, 8, 1.0)), 0.25),
        {"stem_width": 8, "num_classes": 10}, 32),
    "shufflenet": ("shufflenetv2", "ShuffleNetV2", lambda m: (
        (1, 2, 1), (24, 48, 96, 192, 1024)), {"num_classes": 10}, 64),
    "squeezenet": ("squeezenet", "SqueezeNet", lambda m: ("1_1",),
                   {"num_classes": 10}, 69),
    "alexnet": ("alexnet", "AlexNet", lambda m: (), {"num_classes": 10}, 195),
    "vgg": ("vgg", "VGG", lambda m: ("A", True), {"num_classes": 10}, 112),
    "densenet": ("densenet", "DenseNet", lambda m: (), dict(
        growth_rate=8, block_config=(2, 3, 2, 2), num_init_features=16,
        bn_size=2, num_classes=10), 64),
    "googlenet": ("googlenet", "GoogLeNet", lambda m: (),
                  {"num_classes": 10}, 97),
    "inception": ("inception", "Inception3", lambda m: (),
                  {"num_classes": 10, "aux_logits": False}, 107),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(family: str) -> torch.nn.Module:
    module, cls, args, kwargs, _ = FAMILIES[family]
    mod = importlib.import_module(f"vision_tpu_torch.models.{module}")
    model = getattr(mod, cls)(*args(mod), **kwargs)
    mod.init_weights(model, torch.Generator().manual_seed(0))
    # the initial identity statistics: at these sizes statistics of a few
    # images leave the eval-mode network ill-conditioned in bf16
    return model.eval()


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_on_the_card_matches_the_cpu(dev, family):
    model = _model(family)
    size = FAMILIES[family][4]
    x = zoo.images(2, size, 1, "cpu")
    with torch.inference_mode():
        want = model(x)
        card = copy.deepcopy(model).to(dev)
        got = card(x.to(dev))
        assert _rel(got, want) <= 1e-4
        want16 = zoo.to_bf16(model)(x.bfloat16()).float()
        got16 = zoo.to_bf16(card)(x.to(dev, torch.bfloat16))
    assert got16.dtype == torch.bfloat16
    got16 = got16.float()
    if _rel(got16, want16) > 2e-2:  # as close to f32 as the CPU's bf16
        assert _rel(got16, want) <= 2 * _rel(want16, want)


@pytest.mark.parametrize("family", ["efficientnet", "convnext", "swin"])
def test_train_step_on_the_card_repeats_for_a_seed(dev, family):
    model = _model(family).to(dev)
    size = FAMILIES[family][4]
    batch = {"image": zoo.images(4, size, 2, dev),
             "label": torch.arange(4, device=dev)}
    losses = []
    for seed in (0, 0, 1):
        twin = copy.deepcopy(model)
        step = zoo.sgd_step(twin)
        gen = torch.Generator(device=dev).manual_seed(seed)
        step(batch, gen)
        losses.append(float(step(batch, gen)["loss"]))
    assert losses[0] == losses[1] != losses[2]
