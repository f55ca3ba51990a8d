"""Swin v1 and v2 and MaxViT, the port against ``vision_tpu`` on the CPU
at small sizes (``tests/test_models_oracle2.py``'s configurations), the
JAX variables carried across by ``load_jax_variables``: Swin with patch 2,
width 16, depths (2, 2), heads (2, 4), window 4, at 32x32 (shifted
windows), 36x36 (padded to whole windows) and 12x36 (the second stage's
3 rows padded to one window: no shift on that axis); MaxViT with two
blocks of one layer, head width 4, partition 2, at 32x32. Forward in f32
with every named feature and in bf16, a train-mode forward, one SGD step;
every builder's JAX variables placed onto the port's model on the meta
device. Tolerances: ``tests/torch_zoo_cases.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from vision_tpu.models import maxvit as jmaxvit
from vision_tpu.models import swin_transformer as jswin

from torch_zoo_cases import (
    Pair,
    check_bf16,
    check_forward,
    check_loads_shapes,
    check_sgd_step,
    check_train_forward,
    images,
    nchw,
    sweep,
)
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

tswin = importlib.import_module("vision_tpu_torch.models.swin_transformer")
tmaxvit = importlib.import_module("vision_tpu_torch.models.maxvit")

MINI = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), mlp_ratio=2.0,
            num_classes=10, stochastic_depth_prob=0.0)


def _swin(v2):
    x = images(4, 32, seed=int(v2))
    module = jswin.SwinTransformer(patch_size=(2, 2), window_size=(4, 4),
                                   v2=v2, **MINI)
    return Pair(module, lambda: tswin.SwinTransformer(
        (2, 2), window_size=(4, 4), v2=v2, **MINI), x,
        channels_last=True), x


@pytest.fixture(scope="module")
def swin():
    return _swin(False)


@pytest.fixture(scope="module")
def swin_v2():
    return _swin(True)


@pytest.fixture(scope="module")
def maxvit():
    x = images(4, 32, seed=2)
    kw = dict(stem_channels=8, block_channels=(8, 16), block_layers=(1, 1),
              head_dim=4, partition_size=2, mlp_ratio=2, num_classes=10,
              stochastic_depth_prob=0.0)
    return Pair(jmaxvit.MaxVit(**kw), lambda: tmaxvit.MaxVit(**kw), x), x


@pytest.fixture(params=["swin", "swin_v2", "maxvit"])
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
    labels = np.random.RandomState(4).randint(0, 10, len(x)).astype(np.int32)
    check_sgd_step(pair, x, labels)


@pytest.mark.parametrize("fixture", ["swin", "swin_v2"])
@pytest.mark.parametrize("hw", [(36, 36), (12, 36)])
def test_padding_and_the_lost_shift_match_jax(request, fixture, hw):
    pair, _ = request.getfixturevalue(fixture)
    x = images(2, *hw, seed=5)
    check_forward(pair, x)


def test_the_shift_is_dropped_on_a_short_axis():
    """12x36 at patch 2: stage 2 is 3x9, padded to 4x12; the window (4)
    covers the padded height, so the rows keep no shift and the columns
    do. The attention gives the same with and without the shift asked for
    on that axis, and not without it on the other."""
    torch.manual_seed(0)
    attn = tswin.ShiftedWindowAttention(16, (4, 4), (2, 2), 2)
    x = torch.randn(1, 3, 9, 16)
    with torch.no_grad():
        bias = attn.relative_position_bias()
        run = lambda shift: tswin.shifted_window_attention(
            x, attn.qkv, attn.proj, bias, (4, 4), 2, shift)
        assert torch.equal(run((2, 2)), run((0, 2)))
        assert not torch.allclose(run((2, 2)), run((0, 0)))


def test_v2_key_bias_learns_as_in_jax(swin_v2):
    """torchvision zeroes v2's key bias at every forward; the JAX reference
    (and the port) only start it at zero: a nonzero k slice changes the
    output, and its gradient is not zero."""
    pair, x = swin_v2
    port = pair.fresh()
    qkv = port.features[1][0].attn.qkv
    assert float(qkv.bias.detach()[16:32].abs().max()) > 0  # seeded
    out = port(nchw(x))
    out.sum().backward()
    assert float(qkv.bias.grad[16:32].abs().max()) > 0


def test_bias_tables_are_not_transposed(swin, maxvit):
    """The ``relative_position_bias_table`` leaves ``[offsets, heads]`` are
    not Dense kernels: they cross as they are."""
    for pair, path, module in (
            (swin[0], ("features.1.0", "attn"),
             lambda p: p.features[1][0].attn),
            (maxvit[0], ("blocks.0.layers.0.layers.window_attention",
                         "attn_layer.1"),
             lambda p: p.blocks[0].layers[0].layers.window_attention
             .attn_layer[1])):
        tree = pair.variables["params"]
        for key in path:
            tree = tree[key]
        want = tree["relative_position_bias_table"]
        got = module(pair.port).relative_position_bias_table
        np.testing.assert_array_equal(got.detach().numpy(), want)


def test_masks_and_indices_are_built_once_a_device(swin):
    pair, x = swin
    tswin.on_device.cache_clear()
    with torch.no_grad():
        pair.port(nchw(x))
        info = tswin.on_device.cache_info()
        pair.port(nchw(x))
    assert tswin.on_device.cache_info().misses == info.misses
    assert info.misses <= 4  # one index, and a mask a padded shape


@pytest.mark.parametrize("name", sweep([
    "swin_t", "swin_s", "swin_b", "swin_v2_t", "swin_v2_s", "swin_v2_b",
    "maxvit_t",
]))
def test_builder_loads_its_jax_variables(name):
    check_loads_shapes(name, name)
