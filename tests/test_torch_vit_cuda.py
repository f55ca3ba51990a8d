"""ViT-B/16's path on the card: the recipe's augmentation and one amp step
make no host synchronisation; attention through PyTorch's fused
``scaled_dot_product_attention`` against the JAX einsum path's arithmetic
(``attention_plain``) on the same card tensors; the augmentation on the
card against the CPU on the same draws. Marked ``cuda``; every test skips
where no CUDA device is present (decided inside the fixture). Run on a GPU
host with:

    python -m pytest tests/test_torch_vit_cuda.py -m cuda --noconftest

Tolerances: attention 1e-5 of the largest output in f32 (TF32 off), 2e-2 in
bf16; the augmentation's crop within 1 count, the rest of it within 1
count (uint8) or 1e-6 (after normalisation).
"""

import pytest
import torch

from vision_tpu_torch.models import vision_transformer as tvit
from vision_tpu_torch.ops.attention import (
    attention_plain,
    scaled_dot_product_attention,
)
from vision_tpu_torch.tools.vit_train import RecipeStep, frames, recipe_augment
from vision_tpu_torch.transforms import v2 as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _no_sync(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


def test_augment_makes_no_host_synchronisation(dev):
    raw = frames(32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    aug = recipe_augment(random_erase=0.5)
    aug(raw, gen)  # the cached tables reach the card outside the check
    out = _no_sync(lambda: aug(raw, gen))
    assert out["image"].shape == (32, 3, 224, 224)
    assert out["label"].shape == (32, 1000)
    assert bool(torch.isfinite(out["image"]).all())


def test_amp_step_makes_no_host_synchronisation(dev):
    """A small ViT at 224 px through the whole recipe step in bf16:
    augmentation, forward, backward, clipping, AdamW, the schedule, EMA."""
    model = tvit.VisionTransformer(224, 32, 2, 4, 64, 128).to(dev)
    run = RecipeStep(model, torch.bfloat16, batch_size=8)
    raw = frames(8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    run(raw, gen)  # optimizer state, cached tables
    metrics = _no_sync(lambda: run(raw, gen))
    assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_fused_attention_matches_the_plain_version(dev, dtype, tol):
    """ViT-B/16's shape: 12 heads, 197 tokens, head dim 64."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, 12, 197, 64, generator=g).to(dev, dtype)
               for _ in range(3))
    got = scaled_dot_product_attention(q, k, v).float()
    want = attention_plain(q, k, v).float()
    assert float((got - want).abs().max() / want.abs().max()) <= tol


def test_augment_on_the_card_matches_the_cpu(dev):
    raw = frames(16, size=96, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    aug = recipe_augment(random_erase=0.5)
    aug.crop.size = (64, 64)
    draws = aug.draw(raw["image"].shape, gen)
    cpu = T.to_device(draws, "cpu")
    crop = aug.crop.apply(raw["image"], draws["crop"])
    crop_cpu = aug.crop.apply(raw["image"].cpu(), cpu["crop"])
    assert int((crop.cpu().int() - crop_cpu.int()).abs().max()) <= 1
    ra = aug.auto_augment.apply(crop, draws["auto_augment"])
    ra_cpu = aug.auto_augment.apply(crop.cpu(), cpu["auto_augment"])
    assert int((ra.cpu().int() - ra_cpu.int()).abs().max()) <= 1
    post = aug.post.apply(ra, draws["post"])
    post_cpu = aug.post.apply(ra.cpu(), cpu["post"])
    assert float((post.cpu() - post_cpu).abs().max()) <= 1e-6
    mixed = aug.mix.apply((post, raw["label"]), draws["mix"])
    mixed_cpu = aug.mix.apply((post.cpu(), raw["label"].cpu()), cpu["mix"])
    for a, b in zip(mixed, mixed_cpu):
        assert float((a.cpu() - b).abs().max()) <= 1e-6
