"""MobileNetV2, MobileNetV3, MNASNet, ShuffleNetV2 and SqueezeNet, the
port against ``vision_tpu`` on the CPU, the JAX variables carried across
by ``load_jax_variables``: MobileNetV2 (10 classes) at 32x32, a
three-block MobileNetV3 (``tests/test_models_oracle2.py``'s: ReLU and
hardswish blocks, the expansion skipped, the hardsigmoid
squeeze-excitation) at 32x32, MNASNet 0.5 and ShuffleNetV2 x0.5 (stages
of 1, 2, 1 blocks) at 64x64, SqueezeNet 1.0 and 1.1 at 69x69, where the
ceil-mode pools keep partial windows. Forward in f32 with every named feature and in bf16, a
train-mode forward with the running statistics it leaves, one SGD step;
every builder's JAX variables placed onto the port's model on the meta
device. Tolerances: ``tests/torch_zoo_cases.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from vision_tpu.models import mnasnet as jmnas
from vision_tpu.models import mobilenetv2 as jmv2
from vision_tpu.models import mobilenetv3 as jmv3
from vision_tpu.models import shufflenetv2 as jshuf
from vision_tpu.models import squeezenet as jsq

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

tmv2 = importlib.import_module("vision_tpu_torch.models.mobilenetv2")
tmv3 = importlib.import_module("vision_tpu_torch.models.mobilenetv3")
tmnas = importlib.import_module("vision_tpu_torch.models.mnasnet")
tshuf = importlib.import_module("vision_tpu_torch.models.shufflenetv2")
tsq = importlib.import_module("vision_tpu_torch.models.squeezenet")

MV3 = [(8, 3, 8, 8, False, False, 1, 1), (8, 3, 24, 12, False, True, 2, 1),
       (12, 5, 36, 12, True, True, 1, 1)]

CASES = {
    "mobilenet_v2": (lambda: jmv2.MobileNetV2(num_classes=10, dropout=0.0),
                     lambda: tmv2.MobileNetV2(num_classes=10, dropout=0.0), 32),
    "mobilenet_v3": (
        lambda: jmv3.MobileNetV3(setting=tuple(jmv3.IRConf(*c) for c in MV3),
                                 last_channel=32, num_classes=10, dropout=0.0),
        lambda: tmv3.MobileNetV3([tmv3.IRConf(*c) for c in MV3], 32,
                                 num_classes=10, dropout=0.0), 32),
    "mnasnet": (lambda: jmnas.MNASNet(alpha=0.5, num_classes=10, dropout=0.0),
                lambda: tmnas.MNASNet(0.5, num_classes=10, dropout=0.0), 64),
    "shufflenet": (
        lambda: jshuf.ShuffleNetV2(stages_repeats=(1, 2, 1),
                                   stages_out_channels=(24, 48, 96, 192, 1024),
                                   num_classes=10),
        lambda: tshuf.ShuffleNetV2((1, 2, 1), (24, 48, 96, 192, 1024),
                                   num_classes=10), 64),
    "squeezenet1_0": (lambda: jsq.SqueezeNet("1_0", num_classes=10, dropout=0.0),
                      lambda: tsq.SqueezeNet("1_0", num_classes=10, dropout=0.0),
                      69),
    "squeezenet1_1": (lambda: jsq.SqueezeNet("1_1", num_classes=10, dropout=0.0),
                      lambda: tsq.SqueezeNet("1_1", num_classes=10, dropout=0.0),
                      69),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    jax_module, port, size = CASES[request.param]
    x = images(4, size, seed=len(request.param))
    return Pair(jax_module(), port, x), x


def test_forward_matches_jax(case):
    check_forward(*case)


def test_bf16_forward_matches_jax(case):
    check_bf16(*case)


def test_train_forward_matches_jax(case):
    check_train_forward(*case)


def test_sgd_step_matches_jax(case):
    pair, x = case
    labels = np.random.RandomState(5).randint(0, 10, len(x)).astype(np.int32)
    check_sgd_step(pair, x, labels)


def test_ceil_mode_pools_keep_the_partial_window():
    """At 69 px SqueezeNet 1.0's first map is 32 wide: its ceil-mode pools
    give 16, 8 and 4, where floor pools would give 15, 7 and 3 (the
    parity tests run at 69 px)."""
    model = tsq.SqueezeNet("1_0", num_classes=10)
    sizes = []
    x = torch.zeros(1, 3, 69, 69)
    for layer in model.features:
        x = layer(x)
        if isinstance(layer, torch.nn.MaxPool2d):
            sizes.append(x.shape[-1])
    assert sizes == [16, 8, 4]


@pytest.mark.parametrize("name", sweep([
    "mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small", "mnasnet0_5",
    "mnasnet0_75", "mnasnet1_0", "mnasnet1_3", "shufflenet_v2_x0_5",
    "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
    "squeezenet1_0", "squeezenet1_1",
]))
def test_builder_loads_its_jax_variables(name):
    check_loads_shapes(name, name)
