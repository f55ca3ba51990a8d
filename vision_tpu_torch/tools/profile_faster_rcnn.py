"""Where the time of one Faster R-CNN, Mask R-CNN, Keypoint R-CNN or
RetinaNet ResNet-50-FPN request (or train step) goes, on the card.

    python -m vision_tpu_torch.tools.profile_faster_rcnn [--steps 3]
        [--cell 832 | request_f32 | request_bf16 | train | train_amp
         | mask_request_f32 | mask_request_bf16 | mask_train | mask_train_amp
         | keypoint_request_f32 | keypoint_train | deform_request_f32
         | deform_request_bf16 | deform_train | deform_train_amp
         | retinanet_request_f32 | retinanet_request_bf16 | retinanet_train
         | retinanet_train_amp]

Same model and inputs as ``chip_smoke.py`` (seeded random weights with
``cls_score`` scaled x30, TF32 off). ``--cell 832``: one 832x832 f32 image
(phase ``faster_rcnn``); ``request_f32`` / ``request_bf16``: a request of
two seeded uint8 images of 480x640 and 427x640 through the preset, the
transform (a 1344x1344 canvas, batch 2), the model (in bf16 for
``request_bf16``: ``model.to(torch.bfloat16)`` and a bf16 canvas) and
``postprocess_boxes`` (phases ``faster_rcnn_images`` and
``faster_rcnn_amp``). ``train``: one SGD step of
``make_detection_train_step`` on the training batch of the same two images
(phase ``faster_rcnn_train``: ``trainable_backbone_layers=3``, the
recipe's SGD with its warmup, no ``cls_score`` scaling), its loss read
back; ``train_amp`` the same step with ``compute_dtype=torch.bfloat16``
(phase ``faster_rcnn_train_amp``). The ``mask_*`` and ``keypoint_*`` cells are the same for
``maskrcnn_resnet50_fpn`` (its request pastes the masks into each image,
``paste_masks``; its batch carries the gt masks) and
``keypointrcnn_resnet50_fpn`` (its batch carries gt keypoints, labels in
[1, 2)), as ``chip_smoke.py``'s phases of those names drive them; the
``deform_*`` cells are the ``mask_*`` ones for
``maskrcnn_resnet50_fpn_deform`` with its offset predictors seeded
(``seed_offsets``, offsets of RMS ~1.5 px on the cell's canvas), as
``chip_smoke.py``'s ``mask_rcnn_deform_*`` phases drive it, and also
print the device time of the deformable convolution's products
(``torch.matmul``, the ``deform_conv2d.product`` ranges); the
``retinanet_*`` cells are the request and train cells for
``retinanet_resnet50_fpn``, as ``chip_smoke.py``'s ``retinanet_images``,
``retinanet_images_amp``, ``retinanet_train`` and ``retinanet_train_amp``
drive it (``cls_logits``' weight scaled x4 when served; its postprocess
through ``serve_one_stage``; trained by the one-stage convention). Runs
``--steps`` steps under ``torch.profiler``
after two warm-up steps and prints JSON lines: per step the host wall
time and the summed device kernel time (their ratio is the device's busy
share), the device time by kernel group, and the top kernels by device
time. The Chrome trace goes to ``--trace``.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from vision_tpu_torch.models import get_model
from vision_tpu_torch.models.detection import (
    FasterRCNN_ResNet50_FPN_Weights,
    GeneralizedRCNNTransform,
)
from vision_tpu_torch.parallel import make_detection_train_step
from vision_tpu_torch.tools.detection_request import (
    paste_masks,
    raw_images,
    recipe_optimizer,
    seed_offsets,
    serve,
    serve_one_stage,
    train_batch,
)

# cell prefix -> (model, its number of classes, gt extras of its batch)
_MODELS = {"": ("fasterrcnn_resnet50_fpn", 91, {}),
           "mask_": ("maskrcnn_resnet50_fpn", 91, {"masks": True}),
           "keypoint_": ("keypointrcnn_resnet50_fpn", 2, {"keypoints": True}),
           "deform_": ("maskrcnn_resnet50_fpn_deform", 91, {"masks": True}),
           "retinanet_": ("retinanet_resnet50_fpn", 91, {})}
_CELLS = ("832", "request_f32", "request_bf16", "train", "train_amp",
          "mask_request_f32", "mask_request_bf16", "mask_train",
          "mask_train_amp", "keypoint_request_f32", "keypoint_train",
          "deform_request_f32", "deform_request_bf16", "deform_train",
          "deform_train_amp", "retinanet_request_f32", "retinanet_request_bf16",
          "retinanet_train", "retinanet_train_amp")

# kernel-name fragments -> group, first match wins
_GROUPS = (
    ("nms_", "nms kernel"),
    ("im2col_kernel", "deform kernel"),
    ("input_grad_kernel", "deform backward kernel"),
    ("offset_grad_kernel", "deform backward kernel"),
    ("keys_kernel", "deform backward kernel"),
    ("sort_records_kernel", "deform backward kernel"),
    ("finish_kernel", "deform backward kernel"),
    ("window_pool_backward", "window-pool backward kernel"),
    ("window_pool", "window-pool kernel"),
    ("roi_align_backward", "roi_align backward kernel"),
    ("roi_align", "roi_align kernel"),
    ("fprop", "convolution"),
    ("conv", "convolution"),
    ("cudnn", "convolution"),
    ("gemm", "matmul"),
    ("sort", "sort"),
    ("Sort", "sort"),
    ("radix", "sort"),
    ("elementwise", "elementwise"),
    ("reduce", "reduction"),
)


def _group(name: str) -> str:
    for frag, group in _GROUPS:
        if frag in name:
            return group
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _scaled_model(name="fasterrcnn_resnet50_fpn"):
    """The served model as ``chip_smoke.py`` builds it: ``cls_score``
    scaled x30 (RetinaNet's ``cls_logits`` x4) so that detections pass the
    score threshold."""
    model = get_model(name, seed=0)
    with torch.no_grad():
        if name.startswith("retinanet"):
            model.head.classification_head.cls_logits.weight.mul_(4.0)
        else:
            model.roi_heads.box_predictor.cls_score.weight.mul_(30.0)
    return model


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--cell", default="832", choices=_CELLS)
    ap.add_argument("--trace", default=None,
                    help="default build/profile/faster_rcnn_<cell>_trace.json")
    args = ap.parse_args()
    trace = args.trace or f"build/profile/faster_rcnn_{args.cell}_trace.json"

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prefix = next(p for p in ("mask_", "keypoint_", "deform_", "retinanet_",
                              "") if args.cell.startswith(p))
    name, classes, extras = _MODELS[prefix]
    training = "train" in args.cell
    if training:
        model = get_model(name, seed=0, trainable_backbone_layers=3)
        optimizer, scheduler = recipe_optimizer(model)
        train_step = make_detection_train_step(
            model, optimizer, compute_dtype=torch.bfloat16
            if args.cell.endswith("_amp") else None,
            one_stage=prefix == "retinanet_")
        with torch.no_grad():
            batch = train_batch(FasterRCNN_ResNet50_FPN_Weights.COCO_V1.transforms(),
                                GeneralizedRCNNTransform(), raw_images(),
                                num_classes=classes, **extras)
        if prefix == "deform_":
            seed_offsets(model, batch["image"])
        gen = torch.Generator(device="cuda").manual_seed(0)

        def step():
            float(train_step(batch, gen)["loss"])
            scheduler.step()
    elif args.cell == "832":
        model = _scaled_model()
        images = torch.randn(1, 3, 832, 832,
                             generator=torch.Generator().manual_seed(1)).cuda()

        def step():
            model(images)
    else:
        dtype = torch.bfloat16 if args.cell.endswith("bf16") else torch.float32
        model = _scaled_model(name)
        raw = raw_images()
        preset = FasterRCNN_ResNet50_FPN_Weights.COCO_V1.transforms()
        transform = GeneralizedRCNNTransform()
        if prefix == "deform_":
            with torch.no_grad():
                seed_offsets(model, transform([preset(r) for r in raw]).tensors)
        model.to(dtype)

        request = serve_one_stage if prefix == "retinanet_" else serve

        def step():
            _, dets, boxes = request(model, preset, transform, raw, dtype)
            if prefix in ("mask_", "deform_"):
                paste_masks(dets, boxes, raw)

    mode = torch.enable_grad if training else torch.inference_mode
    with mode():
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        walls = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    groups = defaultdict(float)
    for e in kernels:
        groups[_group(e.key)] += _device_us(e) / 1e3 / args.steps
    device_ms = sum(groups.values())
    wall_ms = sum(walls) / len(walls)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "cell": args.cell,
        "wall_ms_per_step": walls, "device_ms_per_step": device_ms,
        "busy_share": device_ms / wall_ms,
        "kernel_launches_per_step": sum(e.count for e in kernels) / args.steps,
    }))
    print(json.dumps({"device_ms_by_group": dict(
        sorted(groups.items(), key=lambda kv: -kv[1]))}))
    if prefix == "deform_":
        # the ranges as the host opened them (the trace also carries each
        # as a device-side annotation of the same name): their kernels'
        # device time
        products = [e for e in prof.events() if e.name == "deform_conv2d.product"
                    and e.device_type == torch.autograd.DeviceType.CPU]
        print(json.dumps({"deform_product": {
            "device_ms_per_step": sum(e.device_time_total for e in products)
            / 1e3 / args.steps,
            "calls_per_step": len(products) / args.steps}}))
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    print(json.dumps({"top_kernels": [
        {"name": e.key[:90], "ms_per_step": _device_us(e) / 1e3 / args.steps,
         "calls_per_step": e.count / args.steps} for e in top]}))
    Path(trace).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(trace)


if __name__ == "__main__":
    main()
