"""The served Faster R-CNN request that ``chip_smoke.py`` (phases
``faster_rcnn_images`` and ``faster_rcnn_amp``) and ``profile_faster_rcnn``
(cells ``request_f32`` and ``request_bf16``) drive: two seeded uint8
images of COCO's two most common sizes through the weights' preset, the
transform, the model and ``postprocess_boxes``; and the training batch of
the same images (phase ``faster_rcnn_train``, cell ``train``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from vision_tpu_torch.models.detection.transform import resize_boxes

IMAGE_SIZES = ((480, 640), (427, 640))
SEED = 0
GT_COUNTS = (4, 7)  # gt boxes of each image
GT_ROWS = 8  # padded to
# the detection recipe's optimizer (references/detection/train.py: SGD,
# torchvision's lr for 2 images a card, and its linear warmup from 1/1000
# of the lr over the first 1000 steps, line 34)
LR = 0.02
WARMUP_FACTOR = 1e-3
WARMUP_ITERS = 1000


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


def train_batch(preset, transform, raw, seed: int = SEED):
    """The batch a detection train step takes for ``raw``: the canvas of
    ``transform``, and per image ``GT_COUNTS`` seeded gt boxes (16 px to
    half the image plus 16 on a side, inside the original image), mapped
    to the resized image with ``resize_boxes``, labels in [1, 90], padded
    to ``GT_ROWS`` rows. Everything on the canvas's device."""
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
        labels[i, :count] = torch.randint(1, 91, (count,), generator=gen)
        valid[i, :count] = True
    dev = batch.tensors.device
    return {"image": batch.tensors, "boxes": boxes.to(dev),
            "labels": labels.to(dev), "valid": valid.to(dev)}


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
