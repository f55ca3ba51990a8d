"""Video classification, the port against ``vision_tpu`` on the CPU, the JAX
variables (seeded by numpy in ``jax.eval_shape``'s shapes) carried across
by ``load_jax_variables``, clips ``[N, C, T, H, W]`` in the port and ``(N,
T, H, W, C)`` in JAX: the three video ResNets with one block a stage on
4x32x32 clips, S3D at full width on 8x32x32, a narrow video Swin (embed
16, depths 2 and 2, window 2x7x7) on 8x48x48, where the first stage's
windows shift and the second's shrink to the map and lose their shift,
and MViT v1- and v2-style configurations of three blocks (q and kv
pooling, a channel change, v2's relative positions and residual pooling)
on 4x32x32. Eval logits within 1e-5 of the largest JAX value
(``tests/torch_zoo_cases.py``); the ``VideoClassification`` preset
through the layout change; the builders' parameter counts and weights
against JAX's.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.models import get_model_weights as jweights
from vision_tpu.transforms._presets import VideoClassification as JPreset
from vision_tpu_torch._jax_convert import load_jax_variables
from vision_tpu_torch.models import get_model, get_model_weights
from vision_tpu_torch.transforms import VideoClassification
from vision_tpu_torch.transforms.v2.functional._resample import resize_2d

from torch_zoo_cases import LOGITS_TOL, random_variables, rel
from test_torch_threads import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

JR, JS, JW, JM = (importlib.import_module(f"vision_tpu.models.video.{m}")
                  for m in ("resnet", "s3d", "swin_transformer", "mvit"))
TR, TS, TW, TM = (importlib.import_module(f"vision_tpu_torch.models.video.{m}")
                  for m in ("resnet", "s3d", "swin_transformer", "mvit"))

BUILDERS = ("mc3_18", "mvit_v1_b", "mvit_v2_s", "r2plus1d_18", "r3d_18",
            "s3d", "swin3d_b", "swin3d_s", "swin3d_t")
SWIN = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4),
            window_size=(2, 7, 7), num_classes=10)


def clip(n, t, h, seed=0):
    return np.random.RandomState(seed).randn(n, t, h, h, 3).astype(np.float32)


def ncthw(x):
    return torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy())


def _mvit_config(v2):
    cfg = dict(num_heads=[1, 2, 2], input_channels=[8, 8, 16],
               output_channels=[8, 16, 16], kernel_kv=[[3, 3, 3]] * 3,
               stride_kv=[[1, 4, 4], [1, 2, 2], [1, 1, 1]])
    if v2:
        cfg.update(kernel_q=[[3, 3, 3]] * 3,
                   stride_q=[[1, 1, 1], [1, 2, 2], [1, 1, 1]])
    else:
        cfg.update(kernel_q=[[], [3, 3, 3], []], stride_q=[[], [1, 2, 2], []])
    flags = dict(residual_pool=v2, rel_pos_embed=v2, proj_after_attn=v2)
    return (JM.MViT(block_setting=JM._mk_config(cfg), num_classes=10, **flags),
            lambda: TM.MViT(TM._mk_config(cfg), spatial_size=(32, 32),
                            temporal_size=4, num_classes=10, **flags))


@functools.lru_cache(None)
def case(name):
    """(JAX module, a maker of the port's model, the clips)."""
    conv = {"r3d": ("3d",) * 4, "mc3": ("3d",) + ("no_temporal",) * 3,
            "r2plus1d": ("2plus1d",) * 4}
    if name in conv:
        stem = "r2plus1d" if name == "r2plus1d" else "basic"
        return (JR.VideoResNet(conv_makers=conv[name], layers=(1, 1, 1, 1),
                               stem_type=stem, num_classes=10),
                lambda: TR.VideoResNet(conv[name], layers=(1, 1, 1, 1),
                                       stem_type=stem, num_classes=10),
                clip(2, 4, 32))
    if name == "s3d":
        return (JS.S3D(num_classes=10), lambda: TS.S3D(num_classes=10),
                clip(2, 8, 32))
    if name == "swin3d":
        return (JW.SwinTransformer3d(**SWIN),
                lambda: TW.SwinTransformer3d(**SWIN), clip(2, 8, 48))
    jm, make = _mvit_config(name == "mvit_v2")
    return jm, make, clip(2, 4, 32)


def port_of(make, variables):
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device="cpu")
    load_jax_variables(model, variables)
    return model.eval()


@pytest.mark.parametrize("name", ["r3d", "mc3", "r2plus1d", "s3d", "swin3d",
                                  "mvit_v1", "mvit_v2"])
def test_logits_match_jax(name):
    jm, make, x = case(name)
    variables = random_variables(jm, jnp.asarray(x[:1]))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port_of(make, variables)(ncthw(x))
    assert got.shape == (2, 10)
    assert rel(got.numpy(), want) <= LOGITS_TOL


def test_swin_case_shifts_then_shrinks_its_windows():
    """The Swin case's token maps: (4, 12, 12) in stage 1 (windows 2x7x7,
    shifted by 1x3x3; padded to 14) and (4, 6, 6) in stage 2 (the window
    cut to 6x6, no shift there, the bias the full window's prefix)."""
    window, shift = (2, 7, 7), (1, 3, 3)
    assert TW._adjust_window((4, 12, 12), window, shift) == (window, shift)
    assert TW._adjust_window((4, 6, 6), window, shift) == ((2, 6, 6),
                                                           (1, 0, 0))
    assert JW._adjust_window((4, 6, 6), window, shift) == ([2, 6, 6],
                                                           [1, 0, 0])
    np.testing.assert_array_equal(TW._shift_mask_3d((4, 14, 14), window, shift)
                                  .shape, (8, 98, 98))


def test_mvit_pooled_sizes_match_the_parameters():
    """The tables are sized from the build size as torchvision sizes them;
    at the clips the JAX model sees, they are the shapes JAX gives."""
    jm, make, x = case("mvit_v2")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x[:1])))
    params = shapes["params"]
    with torch.device("meta"):
        port = make()
    for i in range(3):
        for t in ("h", "w", "t"):
            assert tuple(getattr(port.blocks[i].attn, f"rel_pos_{t}").shape) \
                == params[f"blocks.{i}"]["attn"][f"rel_pos_{t}"].shape


def test_preset_matches_jax():
    """torchvision's ``[..., T, C, H, W]`` uint8 clip in, ``[..., C, T, H,
    W]`` out; JAX works on ``(..., T, H, W, C)``. The uint8 resize rounds
    a near-tie (within 1e-3 of .5 before rounding) to either level, as the
    port's image transforms may (``tests/test_torch_transforms.py``): one
    level apart is allowed there and nowhere else."""
    vid = np.random.default_rng(8).integers(0, 256, (2, 4, 3, 40, 52),
                                            np.uint8)
    kw = dict(crop_size=(24, 28), resize_size=(30, 36))
    want = np.asarray(JPreset(**kw)(jnp.asarray(vid.transpose(0, 1, 3, 4, 2))))
    want = want.transpose(0, 4, 1, 2, 3)
    got = VideoClassification(device="cpu", **kw)(torch.from_numpy(vid))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 4, 24, 28)
    exact = resize_2d(torch.from_numpy(vid).float(), (30, 36),
                      antialias=False)[..., 3:27, 4:32].transpose(1, 2)
    tie = (exact - exact.floor() - 0.5).abs().numpy() < 1e-3
    level = 1.0 / 255.0 / np.asarray(JPreset(**kw).std)[:, None, None, None]
    diff = np.abs(got.numpy() - want)
    assert float(diff[~tie].max()) <= 2e-5
    assert bool((diff <= np.broadcast_to(level, diff.shape) + 2e-5).all())


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_matches_jax_weights_and_parameter_count(name):
    model = get_model(name, device="meta")
    want = jweights(name)
    assert sum(p.numel() for p in model.parameters()) == \
        want.DEFAULT.meta["num_params"]
    got = get_model_weights(name)
    assert list(got.__members__) == list(want.__members__)
    for member in want.__members__:
        w, g = want[member], got[member]
        assert g.value.url == w.url
        for key in ("num_params", "_metrics", "_ops"):
            assert g.meta[key] == w.meta[key], key
        assert g.transforms.keywords == w.transforms.keywords


def test_builders_run_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")  # never here: the CPU suite
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("r3d_18")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VideoClassification(crop_size=(112, 112), resize_size=(128, 171))
    model = get_model("r3d_18", device="cpu")
    assert not model.training
    with torch.no_grad():
        assert model(torch.randn(1, 3, 4, 32, 32)).shape == (1, 400)


@pytest.mark.slow
@pytest.mark.parametrize("name", BUILDERS)
def test_builder_loads_its_jax_variables(name):
    """The JAX builder's variables (shapes only) place onto the port's
    model on the meta device, leaf for leaf."""
    from vision_tpu.models import get_model as jget
    from vision_tpu.models._utils import abstract_init
    from vision_tpu_torch._jax_convert import jax_placements

    with abstract_init():
        shapes = jget(name).variables
    zeros = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)), shapes)
    jax_placements(get_model(name, device="meta"), zeros)
