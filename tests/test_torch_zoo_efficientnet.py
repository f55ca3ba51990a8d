"""EfficientNet and ConvNeXt, the port against ``vision_tpu`` on the CPU
at small sizes, the JAX variables carried across by
``load_jax_variables``: EfficientNet with four stages (a FusedMBConv stage
without expansion, one with, an MBConv stage with expansion and one
without), ConvNeXt with two stages of two blocks (``tests/
test_models_oracle2.py``'s), 32x32 images. Forward in f32 with every named
feature and in bf16, a train-mode forward with the running statistics it
leaves, one SGD step; every builder's JAX variables placed onto the port's
model on the meta device. Tolerances: ``tests/torch_zoo_cases.py``.
"""

import importlib

import numpy as np
import pytest

from vision_tpu.models import convnext as jconv
from vision_tpu.models import efficientnet as jeff

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

teff = importlib.import_module("vision_tpu_torch.models.efficientnet")
tconv = importlib.import_module("vision_tpu_torch.models.convnext")

STAGES = [("fused", 1, 3, 1, 8, 8, 2), ("fused", 4, 3, 2, 8, 16, 1),
          ("mb", 4, 3, 2, 16, 24, 2), ("mb", 1, 3, 1, 24, 24, 1)]


def _setting(lib):
    conf = {"fused": getattr(lib, "_fusedconf", None) or lib.fusedconf,
            "mb": getattr(lib, "_mbconf", None) or lib.mbconf}
    return [conf[kind](*args) for kind, *args in STAGES]


@pytest.fixture(scope="module")
def eff():
    x = images(4, 32)
    module = jeff.EfficientNet(setting=tuple(_setting(jeff)), dropout=0.0,
                               stochastic_depth_prob=0.0, num_classes=10,
                               bn_eps=1e-3)
    return Pair(module, lambda: teff.EfficientNet(
        _setting(teff), 0.0, stochastic_depth_prob=0.0, num_classes=10,
        bn_eps=1e-3), x), x


@pytest.fixture(scope="module")
def convnext():
    x = images(4, 32, seed=1)
    setting = [(16, 32, 2), (32, None, 2)]
    module = jconv.ConvNeXt(
        block_setting=tuple(jconv.CNBlockConfig(*c) for c in setting),
        num_classes=10)
    return Pair(module, lambda: tconv.ConvNeXt(
        [tconv.CNBlockConfig(*c) for c in setting], num_classes=10), x), x


@pytest.fixture(params=["eff", "convnext"])
def case(request):
    return request.getfixturevalue(request.param)


def test_forward_matches_jax(case):
    check_forward(*case)


def test_bf16_forward_matches_jax(case):
    check_bf16(*case)


def test_train_forward_matches_jax(case):
    check_train_forward(*case)


def test_sgd_step_matches_jax(case):
    pair, x = case
    labels = np.random.RandomState(3).randint(0, 10, len(x)).astype(np.int32)
    check_sgd_step(pair, x, labels)


def test_blocks_skip_expansion_and_keep_residuals(eff):
    """The blocks of each stage kind, as the JAX module builds them."""
    port = eff[0].port
    kinds = [[type(b).__name__, len(b.block), b.use_res]
             for stage in port.features[1:-1] for b in stage]
    assert kinds == [["FusedMBConv", 1, True], ["FusedMBConv", 1, True],
                     ["FusedMBConv", 2, False], ["MBConv", 4, False],
                     ["MBConv", 4, True], ["MBConv", 3, True]]


def test_layer_scale_takes_torchvisions_shape(convnext):
    """JAX's ``(dim,)`` layer scale is reshaped to ``(dim, 1, 1)``; without
    the rule the loader refuses the leaf."""
    pair, _ = convnext
    port = pair.port
    want = pair.variables["params"]["features.1.0"]["layer_scale"]
    got = port.features[1][0].layer_scale
    assert got.shape == (16, 1, 1)
    np.testing.assert_array_equal(got.detach().numpy().ravel(), want)


def test_efficientnet_stochastic_depth_schedule():
    """``p * block_id / total_blocks``, and ConvNeXt's over ``total - 1``."""
    model = teff.efficientnet_b0(device="meta")
    probs = [b.sd_prob for stage in model.features[1:-1] for b in stage]
    assert probs == [0.2 * i / 16 for i in range(16)]
    model = tconv.convnext_tiny(device="meta")
    probs = [b.sd_prob for stage in model.features for b in stage
             if isinstance(b, tconv.CNBlock)]
    assert probs == [0.1 * i / 17.0 for i in range(18)]


def test_bn_eps_and_momentum_follow_the_builders():
    for name, eps, momentum in (("efficientnet_b0", 1e-5, 0.1),
                                ("efficientnet_b5", 1e-3, 0.01),
                                ("efficientnet_v2_s", 1e-3, 0.1)):
        bn = getattr(teff, name)(device="meta").features[0][1]
        assert (bn.eps, bn.momentum) == (eps, momentum), name


@pytest.mark.parametrize("name", sweep([
    "efficientnet_b0", "efficientnet_b1", "efficientnet_b2", "efficientnet_b3",
    "efficientnet_b4", "efficientnet_b5", "efficientnet_b6", "efficientnet_b7",
    "efficientnet_v2_s", "efficientnet_v2_m", "efficientnet_v2_l",
    "convnext_tiny", "convnext_small", "convnext_base", "convnext_large",
]))
def test_builder_loads_its_jax_variables(name):
    check_loads_shapes(name, name)
