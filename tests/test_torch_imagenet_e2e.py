"""The ImageNet eval slice as a whole, on the CPU: encoded JPEGs -> decode
-> ResNet-18's ``ImageClassification`` preset -> ResNet-18, the port
(``vision_tpu_torch``) against the JAX package (``vision_tpu``) with the
same seeded weights (``load_jax_variables``); and the pipeline helpers of
``vision_tpu_torch/tools/imagenet_e2e.py`` that ``chip_smoke.py`` drives
on the card.

Tolerances: decoded pixels within one count (the port's host decode and
JAX's ``decode_jpeg(device="tpu")`` compute the same float arithmetic in
another order); logits within 1e-4 of the largest when the port's preset
and model are handed JAX's pixels (f32 sums in another order through
eighteen layers, as ``tests/test_torch_resnet.py`` bounds a forward).
"""

import importlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu.io._codecs as jcodecs
from vision_tpu.io import image as jimage
from vision_tpu.models import resnet as jresnet
from vision_tpu.transforms import _presets as jpresets
from vision_tpu_torch._jax_convert import load_jax_variables
from vision_tpu_torch.io import _codecs, decode_jpeg
from vision_tpu_torch.models import ResNet18_Weights, resnet18
from vision_tpu_torch.tools import imagenet_e2e as e2e
from vision_tpu_torch.transforms.v2 import functional as F


def jax_codecs():
    """``vision_tpu.io._codecs`` with its native shim loaded (see
    ``tests/test_torch_jpeg_codec.py``: it may be half-built in a worker)."""
    if not jcodecs.has_native():
        importlib.reload(jcodecs)
    if not jcodecs.has_native():
        pytest.fail("vision_tpu's native codec shim did not load")
    return jcodecs


def random_variables(module, x, seed):
    """Seeded numpy values in the shapes of ``module.init``: kernels
    N(0, 1/fan_in), BN scales and variances in [0.5, 1.5), small biases
    and means."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x,
                                                train=False))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if leaf in ("scale", "var"):
            return (rng.rand(*s.shape) + 0.5).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def jpegs():
    """Four seeded photo-like JPEGs of ``make_jpegs`` (the port's encoder)
    at 96x128."""
    return e2e.make_jpegs(4, 96, 128, quality=75)


def test_four_jpegs_through_resnet18_match_jax(jpegs):
    jax_codecs()
    got_px = decode_jpeg(jpegs, device="cpu")
    want_px = jimage.decode_jpeg(list(jpegs), device="tpu")
    for g, w in zip(got_px, want_px):
        assert g.shape == (3, 96, 128)
        d = np.abs(g.permute(1, 2, 0).numpy().astype(int) - np.asarray(w).astype(int))
        assert d.max() <= 1

    jpreset = jpresets.ImageClassification(crop_size=224, resize_size=256)
    jx = jnp.stack([jpreset(jnp.asarray(w)) for w in want_px])
    jmod = jresnet.ResNet(block=jresnet.BasicBlock, layers=(2, 2, 2, 2),
                          num_classes=1000)
    variables = random_variables(jmod, jx, 11)
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        variables, jx))

    preset = ResNet18_Weights.DEFAULT.transforms(device="cpu")
    model = resnet18(device="cpu")
    load_jax_variables(model, variables)
    with torch.inference_mode():
        x = torch.stack([preset(torch.from_numpy(np.array(w)).permute(2, 0, 1))
                         for w in want_px])
        got = model(x).numpy()
    assert got.shape == want.shape == (4, 1000)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-4 * scale
    # the port's own pixels through the same preset and model: finite, and
    # the same top class as JAX's where JAX's top two stand apart
    with torch.inference_mode():
        own = model(torch.stack([preset(p) for p in got_px])).numpy()
    assert np.isfinite(own).all()
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3 * scale
    assert (own.argmax(1) == want.argmax(1))[clear].all()


def test_pipeline_helpers_on_the_cpu(jpegs):
    """``host_decode_batches`` and ``coef_batches`` (the library's
    ``host_decode_batch`` and ``host_entropy_decode_batch``) fill each
    batch with the streams in order (``(b * batch + i) % len``), decoded as
    one by one; the coefficient batch decoded by ``decode_on_device``
    equals the host
    decode at 5/8 within one count; ``preprocess`` is resize 232x309,
    crop 224 and normalise, in the type asked for."""
    with ThreadPoolExecutor(3) as pool:
        host = list(e2e.host_decode_batches(jpegs, 3, 2, pool))
        coefs = list(e2e.coef_batches(jpegs, 3, 2, pool))
    order = [0, 1, 2, 3, 0, 1]
    for b in range(2):
        assert host[b].shape == (3, 96, 128, 3) and host[b].dtype == torch.uint8
        for i in range(3):
            want = _codecs.decode_jpeg_native(jpegs[order[3 * b + i]])
            np.testing.assert_array_equal(host[b][i].numpy(), want)
    assert coefs[1][2] == [(2, 2), (1, 1), (1, 1)] and coefs[1][3] == (96, 128)
    imgs = e2e.decode_on_device(coefs[1])
    assert imgs.shape == (3, 3, 60, 80)
    for i in range(3):
        want = decode_jpeg(jpegs[order[3 + i]], device="cpu", scale=(5, 8))
        assert int((imgs[i].int() - want.int()).abs().max()) <= 1

    x = e2e.preprocess(host[0], torch.float32)
    ref = F.resize_image(host[0].permute(0, 3, 1, 2).float(), [232, 309])
    ref = F.center_crop_image(ref, 224)
    ref = F.normalize_image(ref, [123.675, 116.28, 103.53], [58.395, 57.12, 57.375])
    assert x.shape == (3, 3, 224, 224)
    torch.testing.assert_close(x, ref, rtol=1e-6, atol=1e-5)
    assert e2e.preprocess(imgs, nhwc=False).dtype == torch.bfloat16


def test_coef_batches_refuse_a_stream_of_another_geometry(jpegs):
    other = e2e.make_jpegs(1, 64, 64)[0]
    with ThreadPoolExecutor(2) as pool, pytest.raises(ValueError,
                                                      match="another size"):
        list(e2e.coef_batches([jpegs[0], other], 2, 1, pool))


def test_make_jpegs_is_seeded_and_photo_like():
    """The same streams on every call; 4:2:0 at quality 75, as
    ``bench.py:_make_jpegs`` encodes them through libjpeg's defaults."""
    a, b = e2e.make_jpegs(2, 40, 56), e2e.make_jpegs(2, 40, 56)
    assert a == b and a[0] != a[1]
    _, qtabs, samp, hw = _codecs.jpeg_coefficients_native(a[0])
    assert hw == (40, 56) and samp == [(2, 2), (1, 1), (1, 1)]
    assert int(qtabs[0][0]) == 8  # (16 * 50 + 50) // 100 at quality 75
