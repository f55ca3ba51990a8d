"""The dense and video cells on the card: the JAX bench's last four zoo
cells (``bench.py:_bench_zoo_fwd``: DeepLabV3-ResNet-50 at 520x520, batch
4; RAFT-large on 512x512 pairs, batch 2, 12 flow updates; MViT-V2-S and
Swin3D-T on 16x224x224 clips, batch 4), their seeded models and inputs,
and the segmentation and flow train steps at the JAX recipes' settings,
shared by ``chip_smoke.py``'s dense phases and ``tools/profile_zoo.py``.

A model is built from its seed with torchvision's initialisation. Where
that leaves its eval-mode output at the heads' biases (the MobileNetV3
trunks and S3D: their activations shrink through every block under the
initial identity statistics), its batch norms' running statistics are set
from one seeded batch in training mode (``zoo.calibrate_norms``), as
``tools/zoo.py`` does for the classifiers. The ResNet trunks keep the
identity statistics: calibrated to batch statistics, a randomly
initialised ResNet-50 becomes chaotic (on the CPU, DeepLabV3-ResNet-50's
f32 logits at 520 lie 1.5e-4 of the largest from f64, and bf16's 0.76;
with the identity statistics 1.3e-6 and 1.7e-2). The GMACs of a cell are
its weights' ``_ops`` (the JAX bench's figure).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from vision_tpu_torch.models import get_model, get_model_weights
from vision_tpu_torch.models._api import resolve_device
from vision_tpu_torch.models.video._utils import clip_size
from vision_tpu_torch.parallel import (
    make_flow_train_step,
    make_segmentation_train_step,
)
from vision_tpu_torch.tools.zoo import calibrate_norms, gmacs, images, to_bf16

__all__ = ["CALIBRATED", "CELLS", "FLOW_TRAIN", "SEG_TRAIN", "clips",
           "default_size", "flow_batch", "flow_step", "gmacs", "inputs",
           "kind", "pair", "seeded_model", "seg_batch", "seg_step", "serve",
           "to_bf16"]

Device = Union[str, torch.device, None]

# name -> (input size: H = W for images and pairs, (T, H) for clips, batch)
CELLS = {
    "deeplabv3_resnet50": (520, 4),
    "raft_large": (512, 2),
    "mvit_v2_s": ((16, 224), 4),
    "swin3d_t": ((16, 224), 4),
}
# the builders whose seeded models are calibrated (see the docstring)
CALIBRATED = ("deeplabv3_mobilenet_v3_large", "lraspp_mobilenet_v3_large",
              "s3d")
CALIBRATION_BATCH = 2
FLOW_UPDATES = 12  # the bench's and the recipe's
CLIP_FRAMES = 16  # the frames of a clip (the GMACs' and the bench's)
NUM_CLASSES = 21  # VOC labels
IGNORE = 255
# the recipes' training sizes: segmentation 480x480 crops, batch 8
# (references/segmentation/train.py); flow on FlyingChairs' 368x496 crop,
# batch 2 (torchvision's recipe)
SEG_TRAIN = (480, 8)
FLOW_TRAIN = ((368, 496), 2)
SEG_LR = 0.01  # SGD, momentum 0.9, weight decay 1e-4 (the recipe's)
FLOW_LR = 4e-4  # AdamW, weight decay 1e-4 (the recipe's)


def kind(name: str) -> str:
    """``"segmentation"``, ``"flow"`` or ``"video"``, by the builder's
    package."""
    module = get_model_weights(name).__module__
    for k, pkg in (("segmentation", ".segmentation."),
                   ("flow", ".optical_flow."), ("video", ".video.")):
        if pkg in module:
            return k
    raise ValueError(f"{name}: not a dense or video builder")


def default_size(name: str):
    """The size a builder is served at: 520 for segmentation, 512 for
    flow, ``(16, crop)`` for video with its preset's crop."""
    k = kind(name)
    if k == "segmentation":
        return 520
    if k == "flow":
        return 512
    return (CLIP_FRAMES, clip_size(get_model_weights(name).DEFAULT)[0])


def clips(batch: int, frames: int, size: int, seed: int = 0,
          device: Device = None) -> torch.Tensor:
    """Seeded normal ``[batch, 3, frames, size, size]`` clips, drawn on the
    CPU and moved to ``device``."""
    x = torch.randn(batch, 3, frames, size, size,
                    generator=torch.Generator().manual_seed(seed))
    return x.to(resolve_device(device))


def pair(batch: int, size, seed: int = 0, device: Device = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two seeded ``[batch, 3, H, W]`` images in [-1, 1] (the
    ``OpticalFlow`` preset's range): smooth noise, and the same shifted by
    (3, 5) pixels with a little noise of its own."""
    h, w = (size, size) if isinstance(size, int) else size
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand(batch, 3, h // 8 + 2, w // 8 + 2, generator=g)
    img1 = torch.nn.functional.interpolate(coarse, scale_factor=8,
                                           mode="bilinear")[..., :h, :w]
    img2 = torch.roll(img1, (3, 5), (2, 3))
    img2 = img2 + 0.02 * torch.randn(img2.shape, generator=g)
    dev = resolve_device(device)
    return ((img1 * 2 - 1).clamp(-1, 1).to(dev),
            (img2 * 2 - 1).clamp(-1, 1).to(dev))


def inputs(name: str, batch: int, size=None, seed: int = 0,
           device: Device = None) -> tuple:
    """The positional inputs of one call of ``name`` at ``size`` (its
    default when None)."""
    size = default_size(name) if size is None else size
    k = kind(name)
    if k == "segmentation":
        return (images(batch, size, seed, device),)
    if k == "flow":
        return pair(batch, size, seed, device)
    frames, side = size
    return (clips(batch, frames, side, seed, device),)


def serve(model: torch.nn.Module, name: str, args: tuple):
    """One eval-mode call: the segmentation ``out`` logits, the last flow
    (``FLOW_UPDATES`` updates), or the video logits."""
    k = kind(name)
    if k == "flow":
        return model(*args, num_flow_updates=FLOW_UPDATES)[-1]
    out = model(*args)
    return out["out"] if k == "segmentation" else out


def seeded_model(name: str, size=None, device: Device = None, seed: int = 0,
                 **kwargs) -> torch.nn.Module:
    """``get_model(name, seed=seed, **kwargs)`` on ``device``; a builder of
    ``CALIBRATED`` has its batch norms calibrated on ``CALIBRATION_BATCH``
    seeded samples (seed 100) at ``size``, its dropout drawn from a
    generator seeded 0."""
    model = get_model(name, device=device, seed=seed, **kwargs)
    if name in CALIBRATED:
        dev = next(model.parameters()).device
        args = inputs(name, CALIBRATION_BATCH, size, 100, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        calibrate_norms(model, lambda: model(*args, generator=gen))
    return model


def seg_batch(batch: int, size: int, seed: int = 0,
              device: Device = None) -> Dict[str, torch.Tensor]:
    """Seeded images and ``[batch, size, size]`` targets in ``[0, 21)``,
    blocks of 8x8 pixels, a tenth of the blocks and each image's last 16
    rows ``IGNORE``."""
    g = torch.Generator().manual_seed(seed + 1)
    cells = -(-size // 8)
    labels = torch.randint(0, NUM_CLASSES, (batch, cells, cells), generator=g)
    labels[torch.rand(labels.shape, generator=g) < 0.1] = IGNORE
    target = labels.repeat_interleave(8, 1).repeat_interleave(8, 2)
    target = target[:, :size, :size].clone()
    target[:, -16:] = IGNORE
    dev = resolve_device(device)
    return {"image": images(batch, size, seed, dev), "target": target.to(dev)}


def flow_batch(batch: int, size, seed: int = 0,
               device: Device = None) -> Dict[str, torch.Tensor]:
    """A seeded pair and a ``[batch, 2, H, W]`` gt flow: the pair's shift
    (5, 3) plus smooth noise, some pixels past the loss's 400 px mask."""
    h, w = (size, size) if isinstance(size, int) else size
    img1, img2 = pair(batch, (h, w), seed, device)
    g = torch.Generator().manual_seed(seed + 1)
    flow = torch.tensor([5.0, 3.0])[None, :, None, None] + torch.randn(
        batch, 2, h, w, generator=g)
    flow[:, :, :4, :4] = 500.0
    return {"image1": img1, "image2": img2, "flow": flow.to(img1.device)}


def seg_step(model: torch.nn.Module,
             compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """``make_segmentation_train_step`` with the recipe's SGD."""
    opt = torch.optim.SGD(model.parameters(), lr=SEG_LR, momentum=0.9,
                          weight_decay=1e-4)
    return make_segmentation_train_step(model, opt, compute_dtype)


def flow_step(model: torch.nn.Module) -> Callable:
    """``make_flow_train_step`` with the recipe's AdamW and
    ``FLOW_UPDATES`` updates."""
    opt = torch.optim.AdamW(model.parameters(), lr=FLOW_LR, weight_decay=1e-4)
    return make_flow_train_step(model, opt, FLOW_UPDATES)
