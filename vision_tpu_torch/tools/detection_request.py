"""The served Faster R-CNN request that ``chip_smoke.py`` (phases
``faster_rcnn_images`` and ``faster_rcnn_amp``) and ``profile_faster_rcnn``
(cells ``request_f32`` and ``request_bf16``) drive: two seeded uint8
images of COCO's two most common sizes through the weights' preset, the
transform, the model and ``postprocess_boxes``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

IMAGE_SIZES = ((480, 640), (427, 640))
SEED = 0


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
