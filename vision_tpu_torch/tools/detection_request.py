"""The served detection request that ``chip_smoke.py`` (phases
``faster_rcnn_images``, ``faster_rcnn_amp``, ``mask_rcnn_images``,
``mask_rcnn_amp``, ``keypoint_rcnn_images``) and ``profile_faster_rcnn``
(the ``request_*`` cells) drive: two seeded uint8 images of COCO's two
most common sizes through the weights' preset, the transform, the model
and ``postprocess_boxes``, and for Mask R-CNN ``paste_masks``; and the
training batch of the same images, with gt masks and keypoints where the
model takes them (phases ``*_train``, cells ``*train``); and the seeded
offset predictors of a deformable trunk (``seed_offsets``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from vision_tpu_torch.models.detection.roi_heads import paste_masks_in_image
from vision_tpu_torch.models.detection.transform import resize_boxes

IMAGE_SIZES = ((480, 640), (427, 640))
SEED = 0
GT_COUNTS = (4, 7)  # gt boxes of each image
GT_ROWS = 8  # padded to
NUM_KEYPOINTS = 17
# the detection recipe's optimizer (references/detection/train.py: SGD,
# torchvision's lr for 2 images a card, and its linear warmup from 1/1000
# of the lr over the first 1000 steps, line 34)
LR = 0.02
WARMUP_FACTOR = 1e-3
WARMUP_ITERS = 1000
# the offsets' RMS (px) that ``seed_offsets`` gives a deformable trunk
OFFSET_RMS = 1.5


def raw_images(sizes: Sequence[Tuple[int, int]] = IMAGE_SIZES,
               seed: int = SEED) -> List[torch.Tensor]:
    """Uniform uint8 ``[3, H, W]`` images on the CPU, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (3, h, w), dtype=torch.uint8, generator=gen)
            for h, w in sizes]


def serve(model, preset, transform, raw, dtype=torch.float32):
    """One request: raw uint8 images -> ``preset`` -> ``transform`` -> the
    model with the canvas in ``dtype`` -> each image's boxes mapped back to
    its own size. Returns the ``ImageList``, the ``Detections`` and the
    mapped boxes."""
    batch = transform([preset(r) for r in raw])
    dets = model(batch.tensors.to(dtype))
    boxes = [transform.postprocess_boxes(dets.boxes[i], size, tuple(r.shape[-2:]))
             for i, (r, size) in enumerate(zip(raw, batch.image_sizes))]
    return batch, dets, boxes


def paste_masks(dets, boxes, raw) -> List[torch.Tensor]:
    """Each image's ``[D, H, W]`` mask probabilities at its own size: the
    model's 28x28 masks pasted at the boxes ``serve`` mapped back, as
    torchvision's ``transform.postprocess`` composes them."""
    return [paste_masks_in_image(dets.masks[i], b, *r.shape[-2:])
            for i, (b, r) in enumerate(zip(boxes, raw))]


def ellipse_masks(boxes: torch.Tensor, valid: torch.Tensor,
                  size: Tuple[int, int]) -> torch.Tensor:
    """``[N, G, H, W]`` f32 0/1 masks on a canvas of ``size``: the filled
    ellipse inscribed in each valid box (pixel centres inside it), zeros
    for the padding rows; on the boxes' device."""
    h, w = size
    dev = boxes.device
    cx = (boxes[..., 0] + boxes[..., 2])[..., None, None] / 2
    cy = (boxes[..., 1] + boxes[..., 3])[..., None, None] / 2
    rx = ((boxes[..., 2] - boxes[..., 0]) / 2).clamp(min=1e-6)[..., None, None]
    ry = ((boxes[..., 3] - boxes[..., 1]) / 2).clamp(min=1e-6)[..., None, None]
    px = torch.arange(w, device=dev, dtype=torch.float32) + 0.5
    py = torch.arange(h, device=dev, dtype=torch.float32)[:, None] + 0.5
    inside = ((px - cx) / rx) ** 2 + ((py - cy) / ry) ** 2 <= 1.0
    return (inside & valid[..., None, None]).float()


def seeded_keypoints(boxes: torch.Tensor, valid: torch.Tensor,
                     gen: torch.Generator) -> torch.Tensor:
    """``[N, G, NUM_KEYPOINTS, 3]`` keypoints (x, y, visibility) drawn
    inside each valid box, about a quarter of them with visibility 0 (not
    labelled), keypoint 0 of each box exactly on its right edge; zeros for
    the padding rows."""
    n, g = valid.shape
    u = torch.rand(n, g, NUM_KEYPOINTS, 2, generator=gen)
    lo, hi = boxes[..., None, :2], boxes[..., None, 2:]
    xy = lo + u * (hi - lo)
    xy[:, :, 0, 0] = boxes[..., 2]
    vis = torch.where(torch.rand(n, g, NUM_KEYPOINTS, generator=gen) < 0.25,
                      0.0, 2.0)
    return torch.cat([xy, vis[..., None]], -1) * valid[..., None, None]


def train_batch(preset, transform, raw, seed: int = SEED, num_classes: int = 91,
                masks: bool = False, keypoints: bool = False):
    """The batch a detection train step takes for ``raw``: the canvas of
    ``transform``, and per image ``GT_COUNTS`` seeded gt boxes (16 px to
    half the image plus 16 on a side, inside the original image), mapped
    to the resized image with ``resize_boxes``, labels in [1,
    ``num_classes``), padded to ``GT_ROWS`` rows; with ``masks`` the
    ``ellipse_masks`` of the boxes on the canvas, with ``keypoints`` the
    ``seeded_keypoints`` (from another generator, so that the boxes are the
    same either way). Everything on the canvas's device."""
    batch = transform([preset(r) for r in raw])
    gen = torch.Generator().manual_seed(seed + 1)
    n = len(raw)
    boxes = torch.zeros(n, GT_ROWS, 4)
    labels = torch.zeros(n, GT_ROWS, dtype=torch.int64)
    valid = torch.zeros(n, GT_ROWS, dtype=torch.bool)
    for i, (r, size, count) in enumerate(zip(raw, batch.image_sizes, GT_COUNTS)):
        h, w = r.shape[-2:]
        extent = torch.tensor([float(w), float(h)])
        wh = torch.rand(count, 2, generator=gen) * extent / 2 + 16
        xy = torch.rand(count, 2, generator=gen) * (extent - wh)
        boxes[i, :count] = resize_boxes(torch.cat([xy, xy + wh], 1), (h, w), size)
        labels[i, :count] = torch.randint(1, num_classes, (count,), generator=gen)
        valid[i, :count] = True
    dev = batch.tensors.device
    out = {"image": batch.tensors, "boxes": boxes.to(dev),
           "labels": labels.to(dev), "valid": valid.to(dev)}
    if masks:
        out["masks"] = ellipse_masks(out["boxes"], out["valid"],
                                     tuple(batch.tensors.shape[-2:]))
    if keypoints:
        out["keypoints"] = seeded_keypoints(
            boxes, valid, torch.Generator().manual_seed(seed + 2)).to(dev)
    return out


@torch.no_grad()
def seed_offsets(model, images: torch.Tensor, rms: float = OFFSET_RMS,
                 seed: int = SEED) -> List[float]:
    """Give every ``conv2_offset`` of a deformable trunk seeded normal
    weights (zero bias), scaled block by block so that what it predicts on
    ``images`` has an RMS of about ``rms`` (px for the offsets; the DCNv2
    mask logits alike): at init they are zero and the deform model is the
    plain one. The predictors are drawn in trunk order, each scaled by the
    RMS of its own input with the earlier ones already drawn, in one pass
    of the backbone; the weights come from a CPU generator, so every device
    gets the same numbers. Returns each predictor's offset RMS on
    ``images``."""
    gen = torch.Generator().manual_seed(seed)
    read: List[float] = []

    def draw(mod, args):
        x = args[0].float()
        fan_in = mod.weight[0].numel()
        std = rms / (float(x.pow(2).mean().sqrt()) * fan_in ** 0.5)
        w = torch.randn(mod.weight.shape, generator=gen) * std
        mod.weight.copy_(w)
        mod.bias.zero_()

    def measure(mod, args, out):
        read.append(float(out[:, :18].float().pow(2).mean().sqrt()))

    hooks = []
    for name, mod in model.named_modules():
        if name.endswith("conv2_offset"):
            hooks += [mod.register_forward_pre_hook(draw),
                      mod.register_forward_hook(measure)]
    if not hooks:
        raise ValueError("the model has no conv2_offset to seed")
    try:
        model.backbone(images)
    finally:
        for h in hooks:
            h.remove()
    return read


def recipe_optimizer(model):
    """SGD over the trainable parameters of ``model`` (lr ``LR``, momentum
    0.9, weight decay 1e-4) and the recipe's warmup schedule, stepped once
    after each train step. The warmup is what keeps the first steps of a
    randomly initialised model finite: at the full lr a Faster R-CNN whose
    frozen batch norms are the identity diverges at its second step."""
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = torch.optim.SGD(params, lr=LR, momentum=0.9, weight_decay=1e-4)
    scheduler = torch.optim.lr_scheduler.LinearLR(
        optimizer, start_factor=WARMUP_FACTOR, total_iters=WARMUP_ITERS)
    return optimizer, scheduler
