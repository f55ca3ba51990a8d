"""RegNet, AlexNet, VGG and DenseNet, the port against ``vision_tpu`` on
the CPU, the JAX variables carried across by ``load_jax_variables``: a
two-stage RegNet with squeeze-excitation (``tests/test_models_oracle2.py``'s)
at 32x32; AlexNet at 195x195 (its last map 5x5, pooled to 6x6 over
overlapping windows); VGG-11 at 112x112 (3x3, pooled to 7x7; VGG's batch
norm is the port's ``BatchNorm2d``, held in the other families, its
names in the builders' loads); a DenseNet of growth 8 and blocks of 2, 3,
2, 2 layers at 64x64. AlexNet's and VGG's first Linear read an HWC
flatten in JAX: the forwards hold the loader's reordering. Forward in f32
with every named feature and in bf16, a train-mode forward, one SGD step;
every builder's JAX variables placed onto the port's model on the meta
device. GoogLeNet and Inception v3: ``tests/test_torch_zoo_inception.py``.
Tolerances: ``tests/torch_zoo_cases.py``.
"""

import importlib

import numpy as np
import pytest

from torch_zoo_cases import (
    Pair,
    check_bf16,
    check_forward,
    check_loads_shapes,
    check_sgd_step,
    check_train_forward,
    images,
    sweep,
)
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

jreg, jalex, jvgg, jdense = (
    importlib.import_module(f"vision_tpu.models.{m}") for m in (
        "regnet", "alexnet", "vgg", "densenet"))
treg = importlib.import_module("vision_tpu_torch.models.regnet")
talex = importlib.import_module("vision_tpu_torch.models.alexnet")
tvgg = importlib.import_module("vision_tpu_torch.models.vgg")
tdense = importlib.import_module("vision_tpu_torch.models.densenet")

REGNET = ((16, 2, 1, 8, 1.0), (24, 2, 2, 8, 1.0))
DENSENET = dict(growth_rate=8, block_config=(2, 3, 2, 2), num_init_features=16,
                bn_size=2, num_classes=10)

CASES = {
    "regnet": (lambda: jreg.RegNet(stage_params=REGNET, se_ratio=0.25,
                                   stem_width=8, num_classes=10),
               lambda: treg.RegNet(REGNET, 0.25, stem_width=8, num_classes=10),
               32, 4),
    "alexnet": (lambda: jalex.AlexNet(num_classes=10, dropout=0.0),
                lambda: talex.AlexNet(num_classes=10, dropout=0.0), 195, 2),
    "vgg11": (lambda: jvgg.VGG(cfg="A", num_classes=10, dropout=0.0),
              lambda: tvgg.VGG("A", num_classes=10, dropout=0.0), 112, 2),
    "densenet": (lambda: jdense.DenseNet(**DENSENET),
                 lambda: tdense.DenseNet(**DENSENET), 64, 4),
}


@pytest.fixture(scope="module")
def cases():
    """Each case's pair and images, built on first use."""
    built = {}

    def get(name):
        if name not in built:
            jax_module, port, size, n = CASES[name]
            x = images(n, size, seed=len(name))
            built[name] = Pair(jax_module(), port, x), x
        return built[name]

    return get


EVAL = list(CASES)


@pytest.mark.parametrize("name", EVAL)
def test_forward_matches_jax(cases, name):
    check_forward(*cases(name))


@pytest.mark.parametrize("name", EVAL)
def test_bf16_forward_matches_jax(cases, name):
    check_bf16(*cases(name))


@pytest.mark.parametrize("name", EVAL)
def test_train_forward_matches_jax(cases, name):
    check_train_forward(*cases(name))


@pytest.mark.parametrize("name", EVAL)
def test_sgd_step_matches_jax(cases, name):
    pair, x = cases(name)
    labels = np.random.RandomState(6).randint(0, 10, len(x)).astype(np.int32)
    check_sgd_step(pair, x, labels)


def test_the_first_linear_is_reordered_from_hwc(cases):
    """A JAX kernel row of (h, w, c) lands on the port's input column
    ``c * h_out * w_out + h * w_out + w``."""
    pair, _ = cases("alexnet")
    kernel = pair.variables["params"]["classifier.1"]["kernel"]  # [9216, 4096]
    got = pair.port.classifier[1].weight.detach().numpy()  # [4096, 9216]
    h, w, c = 2, 5, 17
    np.testing.assert_array_equal(got[:, c * 36 + h * 6 + w],
                                  kernel[(h * 6 + w) * 256 + c])


@pytest.mark.parametrize("name", sweep([
    "regnet_y_400mf", "regnet_y_800mf", "regnet_y_1_6gf", "regnet_y_3_2gf",
    "regnet_y_8gf", "regnet_y_16gf", "regnet_y_32gf", "regnet_y_128gf",
    "regnet_x_400mf", "regnet_x_800mf", "regnet_x_1_6gf", "regnet_x_3_2gf",
    "regnet_x_8gf", "regnet_x_16gf", "regnet_x_32gf", "alexnet", "vgg11",
    "vgg11_bn", "vgg13", "vgg13_bn", "vgg16", "vgg16_bn", "vgg19", "vgg19_bn",
    "densenet121", "densenet161", "densenet169", "densenet201",
]))
def test_builder_loads_its_jax_variables(name):
    check_loads_shapes(name, name)
