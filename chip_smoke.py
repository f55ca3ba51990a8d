#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the thirteen CUDA kernel libraries of ``vision_tpu_torch`` from
``csrc/`` (``nvcc``) and its JPEG, PNG / GIF and WebP codecs
(``csrc/jpeg_codec.cpp``, ``csrc/image_codecs.cpp``,
``csrc/webp_codec.cpp``, ``g++``, no library), all at once, and drives the
port's main paths at full width, TF32 off, seeded random weights:

* Faster R-CNN ResNet-50-FPN inference (91 classes, one 832x832 f32 image)
  through ``fasterrcnn_resnet50_fpn``: the bitmask NMS, window-pool and
  RoIAlign kernels; once more with ``VISION_TPU_NMS_KERNEL=rowscan``, which
  must give the same detections through the row-serial NMS kernel;
* the same model served from raw images: two seeded uint8 images of
  480x640 and 427x640 through the weights' ``ObjectDetection`` preset,
  ``GeneralizedRCNNTransform`` (800 / 1333, a 1344x1344 canvas, batch 2),
  the model and ``postprocess_boxes``, all on the card; in f32, then with
  ``model.to(torch.bfloat16)`` and a bf16 canvas (amp), through the bf16
  variants of the window-pool and RoIAlign kernels, its FPN maps and RPN
  head outputs held against the f32 request's;
* Faster R-CNN training on the same two images (batch 2, the 1344 canvas,
  seeded gt boxes of 4 and 7 rows padded to 8): SGD steps of
  ``make_detection_train_step`` with ``trainable_backbone_layers=3``,
  through the NMS, window-pool and RoIAlign kernels forward and the
  window-pool and RoIAlign backward kernels, held step by step against the
  same steps through the plain versions, then timed; then the same in bf16
  (``compute_dtype=torch.bfloat16``, the amp step), through the bf16
  variants of all four pooler kernels, held against the same bf16 steps
  through the plain versions and its first losses against the f32 step's;
* Mask R-CNN ResNet-50-FPN (``maskrcnn_resnet50_fpn``) served from the same
  two images in f32 and in bf16, its masks pasted into each image, and
  trained with gt masks, in f32 and in bf16; Keypoint R-CNN ResNet-50-FPN
  (``keypointrcnn_resnet50_fpn``) served in f32 and trained with gt
  keypoints, in f32 and in bf16: the window pool, its backward and RoIAlign at the 14x14 head
  shapes, and RoIAlign at the one-channel 28x28 mask targets;
* the v2 detectors, ``fasterrcnn_resnet50_fpn_v2`` and
  ``maskrcnn_resnet50_fpn_v2`` (live batch norm in the trunk and the box
  head, an FPN with batch norm, two RPN convs, v2's mask head with batch
  norm), served from the same two images in f32 and bf16 and trained in
  f32 and bf16, each step 1 in lockstep with the plain twin, the trunk's
  and box head's running statistics required to move and the FPN's and
  mask head's to stay: the NMS, window-pool and RoIAlign kernels and both
  backward kernels (rows ``*_v2``);
* ``ops_rest``: ``roi_pool``, ``ps_roi_align``, ``ps_roi_pool``,
  ``drop_block2d`` and ``stochastic_depth`` (torch composites, no kernel of
  the repo's) at R-FCN's, Fast R-CNN's and a ResNet stage's sizes against
  the same calls on CPU tensors, forward and gradient, device ms beside a
  bytes bound;
* the deform-trunk Mask R-CNN (``maskrcnn_resnet50_fpn_deform``, deformable
  3x3s in C3-C5, 13 a forward) served from the same two images in f32 and
  in bf16 and trained in f32 and in bf16, with its offset predictors drawn
  from a seeded normal (offsets of RMS ~1.5 px, some samples outside their
  maps): the deformable convolution's column kernel and its backward
  kernels, at each distinct shape of the path; and its DCNv2 variant
  (``deform_modulated=True``, the seeded predictors also giving each
  sample's mask) served in f32 and trained in bf16;
* RetinaNet ResNet-50-FPN (``retinanet_resnet50_fpn``: P3-P7, 9 anchors a
  location, 91 classes) served from the same two images in f32 and in
  bf16 and trained in f32 and in bf16, and its v2
  (``retinanet_resnet50_fpn_v2``: live batch norm in the trunk, GroupNorm
  in the head) served in f32 and trained in bf16: one bitmask NMS an image
  over P3-P7's 5,000 candidates, 91 labels apart by offsets (row
  ``nms_retinanet``); each train phase ends with the trained model's
  detections through that kernel; the per-level top-k timed three ways
  (line ``topk_retinanet``);
* the last five detectors, served f32 and bf16 and trained f32 and amp
  (``detection_zoo_phases``): FCOS ResNet-50-FPN (two images on the 1344
  canvas, batch 2; one NMS an image over 5,000 candidates), the
  MobileNetV3-Large FPN Faster R-CNN (the same images and batch; the NMS,
  window-pool and RoIAlign kernels and both backwards, its frozen norms
  scaled from the request's canvas) and its 320 variant on the 640 canvas
  (f32), SSD300-VGG16 (32 images on its 300 canvas, one NMS an image over
  36,000 candidates; trained at 32) and SSDlite320 (32 images, 27,000;
  trained at 192): each f32 request's maps and head outputs against the
  same model on the CPU, its detections against the same head outputs
  through the plain versions (the SSDs' on one image: the plain NMS's
  N x N matrix), each one-stage step 1 against the CPU on the card's ReLU
  sides; rows ``nms_fcos``, ``nms_ssd``, ``nms_ssdlite`` and
  ``window_pool_mobilenet`` (with the RoIs that overflow its window);
* ViT-B/16 (``vit_b_16``, BASELINE config 2; its head drawn from a seeded
  normal, since torchvision's starts at zero): served at batch 64 in f32
  and bf16 (the f32 logits of 4 images against the CPU, bf16 against f32);
  the recipe's augmentation alone on 128 seeded uint8 256x256 frames
  (RandomResizedCrop + flip, RandAugment, normalise, MixUp / CutMix), one
  batch's card draws applied again on the CPU stage by stage, one more with
  RandomErasing, the draws' frequencies; and trained at batch 128 behind
  it (AdamW, warmup + cosine, clipping at 1, label smoothing, the EMA
  update every step) in f32 and bf16 (``--amp``), step 1 held against the
  CPU (f32) or the f32 step (amp). No kernel of the repo's is on this path;
* the long-sequence ViTs, past the flash-attention gate (head dim 64 at
  512 tokens and more), through the flash-attention kernels: ViT-L/16 at
  512 px (1,025 tokens) served at batch 32 in f32 and bf16 (the f32
  logits of one image against the CPU, bf16 against f32; the forward
  kernel 24 launches a forward), and ViT-B/16 at 384 px (577 tokens)
  trained by the recipe's step at batch 64 behind the augmentation
  cropping to 384, in f32 and bf16 (forward, dK/dV and dQ kernels 12
  launches a step each); each kernel held against its plain version at
  the path's first call, its row beside PyTorch's fused attention on the
  same inputs; the whole backward (``di``, dK/dV and dQ) timed beside the
  fused attention's whole backward (``flash_backward_pair``);
* ResNet-50 classification (1000 classes, a batch of 32 224x224 images):
  one eval batch, one batch of 8 uint8 375x500 images through the weights'
  ``ImageClassification`` preset against the CPU, then SGD steps of
  ``get_model("resnet50", fused_bn=True)`` under ``make_train_step`` in f32
  and in bf16, through the ``matmul_stats`` kernels (36 launches a
  forward): the pipelined FP32 kernel in f32, the ``wgmma`` kernel in bf16,
  and never the guarded general kernel, which one more f32 step drives
  with its wrapper swapped in;
* ImageNet eval from encoded JPEGs (``tools/imagenet_e2e.py``, the cells of
  ``bench.py``'s ``_bench_e2e*``: 32 seeded 375x500 JPEGs at quality 75,
  encoded by the port's codec, batch 64, 12 batches, one synchronisation
  at the end): the codec itself (host decode against the card's, the
  encoder's tables against IJG's, host ms an image); ResNet-50 in bf16
  from JPEGs decoded on host threads through the pinned
  ``prefetch_to_device`` queue, from the Huffman pass alone with the rest
  of the decode on the card (coefficient limit 5), and from decoded frames
  already on the card; ResNet-18 in f32 through its weights' preset
  (BASELINE config 1). Each first batch is held against the CPU;
* ImageNet from files on disk (``tools/imagenet_folder.py``): the
  fixtures of ``tests/torch_io_data`` (progressive, CMYK and EXIF JPEGs,
  JPEGs of sampling factors 3 and 4, PNGs of every kind, an animated GIF,
  WebPs lossy, lossless, with alpha, extended and animated) decoded on the
  card's host against their manifest's digests, on the card against the
  host, host ms an image by stream kind (``image_io``); a tree of 8 classes (train/ 320 JPEGs, val/ 128 files
  with PNGs) written to a temporary directory and read through
  ``ImageFolder`` and ``DeviceJpegLoader`` into an epoch of ResNet-50 amp
  steps through the ``matmul_stats`` ``wgmma`` kernel, step 1 against the
  plain path (``imagenet_folder_train``), into the bf16 model, a batch
  against the same loader on the CPU (``imagenet_folder_eval``), and
  through ``ImageFolder`` + ``DataLoader`` + the weights' preset
  (``imagenet_folder_host``); every lane counted, nothing dropped;
* the classification zoo (``tools/zoo.py``, the JAX bench's zoo cells,
  seeded weights, batch norms calibrated on one seeded batch):
  EfficientNet-V2-S at 384 px (batch 32), ConvNeXt-T and Swin-T at 224 px
  (batch 64) served in f32 and bf16 (the f32 logits of 2 images against
  the CPU, bf16 against f32, TFLOP/s from the cell's GMACs) and trained
  by SGD at batch 32 in f32 and bf16 (step 1 with no stochastic layer
  against the CPU, whose step takes each ReLU to the card's side, the
  default stochastic depth and dropout drawn from a
  CUDA generator, the same seed giving the same loss twice); then every
  other builder of the fifteen families once at its eval size, one a
  family against the CPU. No kernel of the repo's is on these paths;
* segmentation, optical flow and video (``tools/dense.py``, the JAX
  bench's last four zoo cells): DeepLabV3-ResNet-50 at 520x520 (batch 4),
  RAFT-large on 512x512 pairs (batch 2, 12 flow updates), MViT-V2-S and
  Swin3D-T on 16x224x224 clips (batch 4) served in f32 and bf16 (one
  sample's f32 output against the CPU, bf16 against f32, TFLOP/s from the
  cell's GMACs, the busy share and the kernels a forward); DeepLabV3
  trained at the JAX recipe's 480x480 crops, batch 8, in f32 and bf16
  (step 1 without dropout against the CPU at 240x240, batch 8, as the
  zoo's) and RAFT-large at 368x496,
  batch 2, in f32 (step 1 against the CPU on 256x320 pairs); then every
  other builder of the three once, one a kind against the CPU. No kernel
  of the repo's is on these paths;
* the reference recipes' train side (``parallel/presets.py``, last): the
  five detection policies on 32 seeded COCO-like samples (boxes, masks,
  17 keypoints), the four classification policies at 224 on 64 images
  and the video preset on 8 clips of 16x256x340, each sample on the card
  held against the same preset on the CPU with the card's draws handed
  across (``recipe_transforms``: ms and host synchronisations a sample,
  boxes kept, the gates' binomial checks); SSD300 trained at batch 32
  from the ``ssd`` policy through ``collate_detection`` and Mask R-CNN at
  batch 2 from ``hflip`` with masks (``det_recipe_train``, the latter
  against the plain versions and through the window-pool and RoIAlign
  kernels); R3D-18 (16x112, batch 8) and MViT-V2-S (16x224, batch 4)
  trained from the video preset in f32 and amp (``video_train``, step 1
  against the CPU);
* detection and segmentation from files on disk (``tools/coco_folder.py``,
  last): a COCO-layout tree (64 training images at COCO's sizes, two
  without annotations, ~7 objects an image as polygons of 1-3 parts and
  crowds in RLE; 32 val) and a VOC-layout tree (48 + 16 images, palette
  class masks) written to a temporary directory; Mask R-CNN R50-FPN
  trained for an epoch through the port's detection trainer
  (``references/detection/train.py``: ``get_coco``, the ``hflip`` preset,
  aspect-ratio groups, ``collate_detection``, the amp step), step 1
  against the plain path, through the NMS, window-pool and RoIAlign
  kernels and both backward kernels (``coco_folder_train``), then
  evaluated over val through ``--test-only --resume`` and
  ``CocoEvaluator``, which must read mAP 1.0 on the ground truth
  (``coco_folder_eval``); DeepLabV3-R50 trained for an epoch at 480x480,
  batch 8, through the segmentation trainer and evaluated on val
  (``voc_folder_train``, ``voc_folder_eval``; the confusion matrix of the
  ground truth must read 1.0);
* the rest of ``transforms/`` (``transforms_rest_phases``, last): each new
  sample class (the affine, rotation, perspective and elastic warps over
  images, masks, boxes and keypoints, five and ten crops, blur, noise,
  JPEG, the keypoint clamp, sanitize and clamping mode) on the 32 seeded
  COCO-like samples on the card, 4 of them against the CPU on the card's
  draws (``warp_transforms``: ms and host synchronisations a sample);
  Keypoint R-CNN R50-FPN trained for 8 amp steps at batch 2 on samples
  warped on the card by ``tools/warp_train.py``'s chain, step 1 against
  the plain path, through the NMS, window-pool and RoIAlign kernels and
  both backward kernels (``keypoint_warp_train``: ms a step, ms a sample
  of the chain, the card's busy share); ResNet-50 served from 8 f32
  images through the v1 surface alone, ``Compose([Resize(256),
  TenCrop(224)])`` and ``Normalize``, the logits averaged over the ten
  crops, against the same images through the functionals on the CPU
  (``v1_tencrop_eval``);
* WebP and the small classification datasets (``small_data_phases``,
  last; ``tools/small_datasets.py``, trees in a temporary directory): an
  ``ImageFolder`` of every WebP fixture and the port's JPEGs and PNGs
  through ``ClassificationPresetEval`` into ResNet-50 f32 at batch 32
  against the CPU, and ``DeviceJpegLoader`` over it dropping nothing
  (``webp_folder_eval``); CIFAR-10 at its published size (50,000 training
  images in five pickled batches, seeded) through ``CIFAR10``, the v2
  CIFAR recipe and ``DataLoader`` into 32 ResNet-50 (10 classes,
  ``fused_bn``) amp steps at batch 128 through the ``matmul_stats``
  ``wgmma`` kernel, step 1 against the plain path (``cifar_train``:
  samples/s from files, ms a step, the card's idle share); the 24 other
  readers (CIFAR-100, the MNIST family, FakeData, the 17 of ``_small.py``)
  over their few-sample trees, each collated batch on the card against
  the CPU's and the RGB ones through ResNet-50 against the CPU
  (``small_datasets``).

Every kernel is held against its plain PyTorch version on the card at the
inputs the model gave it, and each path's result against a run of the same
model through the plain versions. The counts of launches are set to 0 just
before each path is driven and read just after; a kernel that its path did
not launch fails the run.

Each phase prints one JSON line as it ends; every kernel case carries its
wrapper-clock ``ms`` (median of single calls) and its ``device_ms`` (20
calls queued behind a spin kernel, over 20). Then come the card's name and
power limit as ``nvidia-smi`` reports them, the per-kernel JSON line, and
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that last line; so does a machine without CUDA, or a directory
without the package.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIZE = 832
TIMED_FORWARDS = 5
# The random box predictor gives near-uniform softmax over 91 classes
# (~0.011 < the 0.05 score threshold); scaling cls_score spreads the
# scores so that some detections pass and the comparison is not vacuous.
CLS_SCALE = 30.0
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores
BATCH = 32  # ResNet-50 phases: [BATCH, 3, 224, 224]
LR = 0.1  # SGD, momentum 0.9, weight decay 1e-4
# The first step's loss, logits and statistics are held to 1e-3 and 1e-4.
# The later losses follow an SGD update, and the f32 gradient of this model
# at its random initialisation is itself 2-3% away from a float64 gradient
# on every path, the standard cuDNN one included
# (vision_tpu_torch/tools/grad_noise_resnet.py), so two correct f32 paths
# part by up to ~1% in loss after one update at this learning rate.
LATER_LOSS_TOL = 5e-2
MM_CALLS_PER_FORWARD = 36  # 2 per Bottleneck + 4 downsamples
SPIN_CYCLES = 30_000_000  # ~17 ms of a spin kernel, see device_ms
NMS_OPS_PER_PAIR = 14  # 2x(min, max, sub, max0), mul, add, sub, >0, div, >thr
# The request path's phases: the two seeded uint8 images of
# ``tools/detection_request.py`` (480x640, 427x640), which the transform
# (800 / 1333, round) takes to these sizes on its 1344x1344 canvas.
RESIZED = [(800, 1067), (800, 1199)]
# bf16 kernel path against bf16 plain path, end to end: a pooled value
# that rounds to the neighbouring bf16 value moves a score by ~1e-3 and a
# box by a fraction of a pixel
AMP_SCORE_TOL = 1e-2
AMP_BOX_TOL = 1.0
# bf16 request against f32 request: each FPN map and RPN head output
# within this share of its largest f32 value. Each layer rounds its output
# to bf16 (2**-9 relative) over some sixty layers; the same full-width
# model on a 2x192x192 canvas on the CPU read 1.1e-2 to 2.5e-2. A layer
# that computes the wrong thing in bf16 is off by the order of the map.
AMP_VS_F32_TOL = 5e-2
# Faster R-CNN training (phase faster_rcnn_train): the recipe's SGD (lr
# 0.02 with its warmup, tools/detection_request.py:recipe_optimizer); the
# gradients held against the plain path's: the box head's first layer, the
# RPN head's conv, an FPN lateral conv and a conv of the last trunk stage
DET_STEPS = 3
DET_GRADS = ("roi_heads.box_head.fc6.weight", "rpn.head.conv.0.0.weight",
             "backbone.fpn.inner_blocks.2.0.weight",
             "backbone.body.layer4.1.conv2.weight")
# The amp train phases (compute_dtype=torch.bfloat16) against the same
# bf16 steps through the plain versions: the two paths part only where a
# pooler kernel's f32 sum, taken in another order, rounds to the
# neighbouring bf16 value (a step, 2**-8 of a pooled value) and that
# difference runs through the bf16 heads and, backward, the bf16 trunk, as
# the served bf16 scores (AMP_SCORE_TOL) do: step 1's losses and the later
# steps' summed losses within 1e-2 relative, the gradients within 5e-2 of
# each one's largest value (a gradient rounds in bf16 forward and
# backward). Step 1 against the f32 step: the RPN's two losses (on the
# same anchors and gt) and the summed loss within AMP_VS_F32_TOL; the RoI
# head's losses follow samples drawn from proposals that bf16 moves, and
# are printed.
AMP_FIRST_LOSS_TOL = 1e-2
AMP_GRAD_TOL = 5e-2
AMP_VS_F32_GATED = ("loss_objectness", "loss_rpn_box_reg", "loss")
# Mask R-CNN and Keypoint R-CNN training: those four and the new heads'
# first layers
MASK_GRADS = DET_GRADS + ("roi_heads.mask_head.mask_fcn1.weight",
                          "roi_heads.mask_predictor.conv5_mask.weight")
KEYPOINT_GRADS = DET_GRADS + (
    "roi_heads.keypoint_head.0.weight",
    "roi_heads.keypoint_predictor.kps_score_lowres.weight")
# Served masks, kernel path against plain path on the same boxes: f32
# probabilities (28x28 and pasted) within MASK_TOL. In bf16 a pooled value
# that rounds to the neighbouring bf16 value moves a logit of the four bf16
# convs and the deconvolution by bf16 steps of the terms it sums, which
# can be a large share of a logit near 0 (where the sigmoid is steepest):
# there the gate is how far bf16 arithmetic itself moves the masks, the
# plain bf16 path against the f32 model at the same boxes
MASK_TOL = 1e-4
# The deform-trunk Mask R-CNN (maskrcnn_resnet50_fpn_deform): its offset
# predictors are zero at init, where the model is the plain one, so each
# phase first draws them from a seeded normal scaled to give offsets of
# OFFSET_RMS px on its own images (tools/detection_request.py:seed_offsets);
# a phase fails if the offsets' RMS is under OFFSET_RMS_MIN or no sample
# falls outside its map. Its train phases also hold these gradients: each
# stage's deformable conv and offset predictors
OFFSET_RMS_MIN = 0.25
DEFORM_PARAMS = 44_982_235  # 44,401,393 + 13 offset predictors (580,842)
# DCNv2 (deform_modulated=True): the 13 predictors also give the mask
# logits, 27 channels each (871,263 parameters)
DEFORM_V2_PARAMS = 45_272_656
DEFORM_V2 = {"deform_modulated": True}
DEFORM_GRADS = MASK_GRADS + ("backbone.body.layer2.0.conv2.weight",
                             "backbone.body.layer2.0.conv2_offset.weight",
                             "backbone.body.layer3.1.conv2_offset.weight",
                             "backbone.body.layer4.2.conv2_offset.weight")
# Served keypoints: a heatmap whose largest cell leads the next by less
# than this share of the heatmaps' largest magnitude is a near-tie, where
# the two paths' f32 round-off may pick the other cell
NEAR_TIE = 1e-4
# RetinaNet (retinanet_resnet50_fpn, _v2): at the seeded init the
# classification bias's prior (0.01) keeps every score under the 0.05
# threshold; cls_logits' weight scaled x4 spreads the logits (std ~0.27
# -> ~1.1 on a 666 canvas on the CPU), so that detections pass. Each image
# sends P3-P7's top 1,000 candidates each to one NMS: [2, 5,000] boxes.
RETINA_CLS_SCALE = 4.0
RETINA_CANDIDATES = 5000
RETINA_DETECTIONS = 300
# its trained gradients: both predictors, P6, an FPN lateral conv and a
# conv of the last trunk stage
RETINA_GRADS = ("head.classification_head.cls_logits.weight",
                "head.regression_head.bbox_reg.weight",
                "backbone.fpn.extra_blocks.p6.weight",
                "backbone.fpn.inner_blocks.2.0.weight",
                "backbone.body.layer4.1.conv2.weight")
# The v2 detectors (fasterrcnn_resnet50_fpn_v2, maskrcnn_resnet50_fpn_v2):
# torchvision's parameter counts, and the trained gradients held against
# the plain twin's: the box head's fc and last norm, the RPN head's second
# conv, an FPN smoothing norm, a last-stage conv (and the mask head's first
# conv and last norm)
FASTER_V2_PARAMS = 43_712_278
# v2's box head ends in batch norm, ReLU and an fc of 1,024: at the seeded
# init its class scores already spread over (0.4, 1) on a 320 canvas on
# the CPU (x30 would saturate most at 1.0), so cls_score is left as drawn
V2_CLS_SCALE = 1.0
# bf16 boxes of the v2 request against the plain bf16 path: AMP_BOX_TOL plus
# 2**-7 of the box's extent. A pooled value one bf16 step away passes four
# bf16 convs and the fc of v2's head, and a box regression output rounded
# the other way moves an edge by a share of the box's extent, not by a
# fixed length: on an H100 80GB HBM3 at 700 W the v2 bf16 request's rows
# read up to 4.09 px, on boxes some 1,000 px tall (under 0.4% of the
# extent; one bf16 step is 2**-8 of a value), with the scores within 9.1e-6
V2_AMP_BOX_REL = 2.0 ** -7
MASK_V2_PARAMS = 46_359_409
V2_GRADS = ("roi_heads.box_head.5.weight", "roi_heads.box_head.3.1.weight",
            "rpn.head.conv.1.0.weight", "backbone.fpn.layer_blocks.0.1.weight",
            "backbone.body.layer4.2.conv3.weight")
V2_MASK_GRADS = V2_GRADS + ("roi_heads.mask_head.0.0.weight",
                            "roi_heads.mask_head.3.1.weight")
# Their step-1 gradients against the plain twin's by relative Frobenius
# norm (1e-3 f32, 5e-2 amp, as v1's by largest element): the batch norms in
# training mode (trunk, box head) make single elements ill-conditioned. The
# f32 step (H100 80GB HBM3, 700 W) whose losses agreed within 5e-7 read,
# by largest element, 1.6e-3 at the box head's fc and 3.7e-3 at a
# last-stage conv (v1: 1e-7 to 5e-6), as the CPU test of the v2 models
# finds for either library's f32 gradients against f64
# (tests/test_torch_rcnn_v2.py)
V2_GRAD_NORM = "fro"
# Below the box head's training-mode batch norm, whose backward subtracts
# per-channel sums that nearly cancel, the f32 pooler gradient's round-off
# (same card) moved the FPN smoothing norm's gradient by 6.2e-4 and a last-stage
# conv's by 1.3e-3 (Frobenius; the box head's 1.0e-4 and 1.1e-4): those two
# are held at 1e-2 in f32
V2_GRAD_TOLS = {"backbone.fpn.layer_blocks.0.1.weight": 1e-2,
                "backbone.body.layer4.2.conv3.weight": 1e-2}
# the v2 batch norms whose running statistics a train step moves (trunk,
# box head) and leaves (the FPN's, always on its running statistics; the
# mask head's, which the loss runs on its running statistics)
V2_MOVING = ("backbone.body.", "roi_heads.box_head.")
V2_FIXED = ("backbone.fpn.", "roi_heads.mask_head.")
# ops_rest: each op without a pallas_call counterpart on the card against
# the same call on CPU tensors, forward and gradient, within this share of
# the largest CPU value
OPS_REST_TOL = 1e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(nbytes: float, ops: float, peak: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, launches: int = 20, warmup: int = 2) -> float:
    """Device time of one call: CUDA events around ``launches`` calls that
    run back to back, over their number. The calls are queued while the
    card is held busy by a spin kernel of some 17 ms, so the host's
    share of a call (Python, allocation, launch latency) stays outside the
    events even where it is longer than the kernel."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` single calls, CUDA events around each."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Kernels:
    """The kernel wrappers of the main paths, their plain versions, and a
    way to record their inputs or swap the plain versions in.
    ``matmul_stats`` is the wrapper that chooses among three kernels; each
    of the three is counted under its own name as well."""

    def __init__(self):
        # import_module: ``vision_tpu_torch.ops`` re-exports functions
        # named ``nms`` and ``roi_align`` over their module names
        nms = importlib.import_module("vision_tpu_torch.ops.nms")
        poolers = importlib.import_module("vision_tpu_torch.ops.poolers")
        roi_align = importlib.import_module("vision_tpu_torch.ops.roi_align")
        conv1x1 = importlib.import_module("vision_tpu_torch.ops._conv1x1_bn")
        deform = importlib.import_module("vision_tpu_torch.ops.deform_conv")
        attention = importlib.import_module("vision_tpu_torch.ops.attention")

        # name -> (module, wrapper attribute, plain version)
        self.table = {
            "nms": (nms, "nms_keep_sorted_cuda", nms.nms_keep_sorted_plain),
            "window_pool": (poolers, "window_pool_cuda",
                            poolers.window_pool_plain),
            "roi_align": (roi_align, "roi_align_cuda",
                          roi_align.roi_align_plain),
            "matmul_stats": (conv1x1, "matmul_stats_cuda",
                             conv1x1.matmul_stats_plain),
            "nms_rowscan": (nms, "nms_keep_sorted_rowscan_cuda",
                            nms.nms_keep_sorted_plain),
            "window_pool_backward": (poolers, "window_pool_backward_cuda",
                                     poolers.window_pool_backward_plain),
            "roi_align_backward": (roi_align, "roi_align_backward_cuda",
                                   roi_align.roi_align_backward_plain),
            "deform_conv": (deform, "deform_im2col_cuda",
                            deform.deform_im2col_plain),
            "deform_conv_backward": (deform, "deform_conv_backward_cuda",
                                     deform.deform_conv_backward_plain),
            "flash_attention": (attention, "flash_attention_forward_cuda",
                                attention.flash_attention_plain),
            "flash_attention_backward_dkv": (
                attention, "flash_attention_dkv_cuda",
                attention.flash_attention_dkv_plain),
            "flash_attention_backward_dq": (
                attention, "flash_attention_dq_cuda",
                attention.flash_attention_dq_plain),
        }
        self.cuda = {n: getattr(m, a) for n, (m, a, _) in self.table.items()}
        self.plain = {n: p for n, (_, _, p) in self.table.items()}
        self.counted = dict(
            self.cuda,
            matmul_stats_fma=conv1x1.matmul_stats_fma_cuda,
            matmul_stats_wgmma=conv1x1.matmul_stats_wgmma_cuda,
            matmul_stats_general=conv1x1.matmul_stats_general_cuda)

    def reset(self) -> None:
        for fn in self.counted.values():
            fn.launches = 0
            fn.launches_by_dtype = {}

    def launches(self) -> dict:
        """Each wrapper's count, and the window pool's and RoIAlign's, the
        deformable convolution's, the flash attention's, and their backward
        kernels', split by variant: ``<name>_f32`` and ``<name>_bf16``."""
        out = {n: fn.launches for n, fn in self.counted.items()}
        for n in ("window_pool", "roi_align", "window_pool_backward",
                  "roi_align_backward", "deform_conv", "deform_conv_backward",
                  "flash_attention", "flash_attention_backward_dkv",
                  "flash_attention_backward_dq"):
            by = self.counted[n].launches_by_dtype
            out[f"{n}_f32"] = by.get("float32", 0)
            out[f"{n}_bf16"] = by.get("bfloat16", 0)
        return out

    @contextlib.contextmanager
    def swapped(self, make):
        """Replace each wrapper, where the path looks it up, by
        ``make(name, wrapper)``."""
        try:
            for n, (mod, attr, _) in self.table.items():
                setattr(mod, attr, make(n, self.cuda[n]))
            yield
        finally:
            for n, (mod, attr, _) in self.table.items():
                setattr(mod, attr, self.cuda[n])

    def recording(self, calls: dict, counts: dict = None, plain: bool = False):
        """Record (a copy of) the positional arguments of every call. Of
        ``matmul_stats`` only the first call of each distinct (shapes,
        prologue, type) is kept, and ``counts`` says how often each came.
        With ``plain`` the calls go to the plain versions."""
        def make(name, fn):
            if plain:
                fn = self.plain[name]

            def rec(*args):
                if name == "matmul_stats":
                    key = matmul_key(args)
                    counts[key] = counts.get(key, 0) + 1
                    if counts[key] > 1:
                        return fn(*args)
                calls.setdefault(name, []).append(
                    [a.clone() if hasattr(a, "clone") else a for a in args])
                return fn(*args)
            return rec
        return self.swapped(make)

    def plain_versions(self):
        return self.swapped(lambda name, fn: self.plain[name])


def matmul_key(args):
    x, w = args[:2]
    prologue = len(args) > 2 and args[2] is not None
    return (tuple(x.shape), tuple(w.shape), prologue, str(x.dtype))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def peak_flops(t) -> float:
    """The card's peak rate of operations on ``t``'s element type."""
    import torch

    return PEAK_BF16_FLOPS if t.dtype == torch.bfloat16 else PEAK_F32_FLOPS


def product_peak(t):
    """``(rate, by)``: the card's peak rate of matrix-product operations on
    ``t``'s element type. bf16 on the tensor cores (``"bf16"``); f32 the
    faster of the FP32 units (``"fp32_units"``) and the tensor cores taking
    each product as three TF32 products at f32 accuracy (``"3xtf32"``,
    495 / 3 TFLOP/s). Elementwise and gather work stays at
    :func:`peak_flops`."""
    import torch

    if t.dtype == torch.bfloat16:
        return PEAK_BF16_FLOPS, "bf16"
    tf32 = PEAK_TF32_FLOPS / 3
    return (tf32, "3xtf32") if tf32 > PEAK_F32_FLOPS else (
        PEAK_F32_FLOPS, "fp32_units")


def nms_work(args):
    """Bytes: boxes and valid read, keep written. Operations: the IoU test
    of every pair of valid rows (an invalid row is tested against none),
    in f32."""
    boxes, valid, _ = args
    b, n = valid.shape
    v = valid.sum(1).double()
    pairs = float((v * (v - 1) / 2).sum())
    return boxes.numel() * 4 + valid.numel() + valid.numel(), (
        pairs * NMS_OPS_PER_PAIR + 3 * b * n), PEAK_F32_FLOPS


def matmul_work(args):
    """Bytes: x, w (and scale, shift) read once, y, s1, s2 written once.
    Operations: 2*M*K*N, against the peak of a product on the operands'
    type (:func:`product_peak`)."""
    import torch

    x, w = args[:2]
    m, k = x.shape
    n = w.shape[1]
    nbytes = (m * k + k * n + m * n) * x.element_size() + 2 * n * 4
    if matmul_key(args)[2]:
        nbytes += 2 * k * 4
    return nbytes, 2.0 * m * k * n, product_peak(x)[0]


def window_work(args):
    """Bytes: the pyramid cells some window reads (rows and columns with a
    non-zero weight), the weights and origins, the output. Operations:
    the multiply-adds over those rows and columns, then over those columns
    again, against the peak of the pyramid's type."""
    import torch

    stacked, row0, x0, w_y, w_x = args[:5]
    k, ph, winy = w_y.shape
    _, pw, winx = w_x.shape
    r_rows, wmax, c = stacked.shape
    ynz = (w_y != 0).any(1)  # [K, winy]
    xnz = (w_x != 0).any(1)  # [K, winx]
    rows = torch.zeros(k, r_rows, dtype=torch.bool, device=stacked.device)
    cols = torch.zeros(k, wmax, dtype=torch.bool, device=stacked.device)
    rows.scatter_(1, row0.long()[:, None] + torch.arange(winy, device=rows.device), ynz)
    cols.scatter_(1, x0.long()[:, None] + torch.arange(winx, device=cols.device), xnz)
    cells = int((rows[:, :, None] & cols[:, None, :]).any(0).sum())
    elem = stacked.element_size()  # the pyramid's and the output's type
    nbytes = (cells * c * elem + row0.numel() * 4 + x0.numel() * 4
              + w_y.numel() * 4 + w_x.numel() * 4 + k * c * ph * pw * elem)
    nzy = ynz.sum(1).double()
    nzx = xnz.sum(1).double()
    ops = 2 * c * float(torch.sum(ph * nzy * nzx + ph * pw * nzx))
    return nbytes, ops, peak_flops(stacked)


def _sample_lines(start, length, pooled, grid, gmax, size):
    """[K, size] bool: the rows (or columns) that some sample of each RoI
    reads, corners included, samples outside [-1, size] excluded."""
    import torch

    dev = start.device
    p = torch.arange(pooled, device=dev, dtype=torch.float32)
    i = torch.arange(gmax, device=dev, dtype=torch.float32)
    bin_ = length / pooled
    coord = (start[:, None, None] + p[None, :, None] * bin_[:, None, None]
             + (i[None, None, :] + 0.5) * (bin_ / grid)[:, None, None])
    ok = (i[None, None, :] < grid[:, None, None]) & (coord >= -1) & (coord <= size)
    c = coord.clamp(min=0)
    lo = c.long().clamp(max=size - 1)
    hi = torch.where(lo >= size - 1, lo, lo + 1)
    hits = torch.zeros(start.shape[0], size, dtype=torch.int32, device=dev)
    hits.scatter_add_(1, lo.flatten(1), ok.flatten(1).int())
    hits.scatter_add_(1, hi.flatten(1), ok.flatten(1).int())
    return hits > 0


def _roi_grid(rois, ph, pw, scale, sr, aligned):
    """Per RoI the start, extent and sample grid of each axis, as the
    kernels compute them."""
    import torch

    off = 0.5 if aligned else 0.0
    sw = rois[:, 1] * scale - off
    sh = rois[:, 2] * scale - off
    rw = rois[:, 3] * scale - off - sw
    rh = rois[:, 4] * scale - off - sh
    if not aligned:
        rw, rh = rw.clamp(min=1.0), rh.clamp(min=1.0)
    if sr > 0:
        gh = torch.full_like(rh, float(sr))
        gw = gh
    else:
        gh, gw = torch.ceil(rh / ph), torch.ceil(rw / pw)
    return sh, sw, rh, rw, gh, gw


def roi_work(args):
    """Bytes: the input pixels some sample reads (all channels), the RoIs,
    the output. Operations: per sample and channel 4 corner weights, 4
    products, 4 adds; one divide per output; against the peak of the
    input's type."""
    import torch

    inp, rois, size, scale, sr, aligned = args
    ph, pw = (size, size) if isinstance(size, int) else size
    n, c, h, w = inp.shape
    k = rois.shape[0]
    sh, sw, rh, rw, gh, gw = _roi_grid(rois, ph, pw, scale, sr, aligned)
    gmax_h = max(int(gh.max()), 1)
    gmax_w = max(int(gw.max()), 1)
    ys = _sample_lines(sh, rh, ph, gh, gmax_h, h)
    xs = _sample_lines(sw, rw, pw, gw, gmax_w, w)
    touched = torch.zeros(n, h, w, dtype=torch.bool, device=inp.device)
    b = rois[:, 0].long()
    for img in range(n):
        sel = b == img
        if sel.any():
            touched[img] = (ys[sel][:, :, None] & xs[sel][:, None, :]).any(0)
    elem = inp.element_size()  # the input's and the output's type
    nbytes = (int(touched.sum()) * c * elem + rois.numel() * 4
              + k * c * ph * pw * elem)
    samples = float((gh * gw).sum()) * ph * pw
    return nbytes, c * samples * 12 + k * c * ph * pw, peak_flops(inp)


def roi_backward_work(args):
    """Bytes: the output gradient and the RoIs read, the whole input
    gradient written (zeros included), each in its own type. Operations:
    the forward's, each sample's corner weights and products now scattering
    the gradient; in f32 (the sums are f32 in both variants)."""
    grad, rois, (n, c, h, w), size, scale, sr, aligned = args
    ph, pw = (size, size) if isinstance(size, int) else size
    gh, gw = _roi_grid(rois, ph, pw, scale, sr, aligned)[4:]
    samples = float((gh.clamp(min=0) * gw.clamp(min=0)).sum()) * ph * pw
    elem = grad.element_size()  # the gradient's type, in and out
    nbytes = (grad.numel() + n * c * h * w) * elem + rois.numel() * 4
    return nbytes, c * samples * 12 + grad.numel(), PEAK_F32_FLOPS


def window_backward_work(args):
    """Bytes: the output gradient, the weights and origins read, the whole
    pyramid gradient written (zeros included), the gradients in their own
    type. Operations: per RoI the cheaper of the two contraction orders
    over its non-zero rows and columns, ``w_x`` first (PH PW nx + PH ny nx)
    or ``w_y`` first (PH PW ny + PW ny nx), so that the bound does not
    depend on the order a design takes; in f32 (the sums are f32 in both
    variants)."""
    import torch

    grad, row0, x0, w_y, w_x, (r_rows, wmax) = args[:6]
    k, c, ph, pw = grad.shape
    nzy = (w_y != 0).any(1).sum(1).double()
    nzx = (w_x != 0).any(1).sum(1).double()
    elem = grad.element_size()
    nbytes = ((grad.numel() + r_rows * wmax * c) * elem
              + (w_y.numel() + w_x.numel() + row0.numel() + x0.numel()) * 4)
    x_first = ph * pw * nzx + ph * nzy * nzx
    y_first = ph * pw * nzy + pw * nzy * nzx
    ops = 2 * c * float(torch.minimum(x_first, y_first).sum())
    return nbytes, ops, PEAK_F32_FLOPS


def compare_kernel(fn, plain, args, exact=False, on_cpu=False):
    """Kernel against plain version on the same inputs (with ``on_cpu``,
    the plain version on the CPU): (max abs error, that error relative to
    the largest plain value, kernel ms by the wrapper clock, kernel
    ``device_ms``, plain ms on the card). For a bf16 output the second is
    the largest error in bf16 steps: |got - want| over 2**-7 |want| + 1e-5
    max |want| (one step of the element's magnitude, plus the f32
    round-off of sums taken in another order)."""
    import torch

    got = fn(*args)
    if on_cpu:
        got = got.cpu()
        want = plain(*[a.cpu() if torch.is_tensor(a) else a for a in args])
    else:
        want = plain(*args)
    torch.cuda.synchronize()
    if exact:
        err = float((got.int() - want.int()).abs().max())
        rel = err
    elif got.dtype == torch.bfloat16:
        diff = (got.float() - want.float()).abs()
        scale = 2.0 ** -7 * want.float().abs() + 1e-5 * want.float().abs().max()
        err = float(diff.max()) if got.numel() else 0.0
        rel = float((diff / scale.clamp(min=1e-30)).max()) if got.numel() else 0.0
    else:
        err = float((got - want).abs().max()) if got.numel() else 0.0
        rel = err / max(float(want.abs().max()), 1e-30) if got.numel() else 0.0
    ms = cuda_ms(lambda: fn(*args))
    dev_ms = device_ms(lambda: fn(*args))
    plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
    return err, rel, ms, dev_ms, plain_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "vision_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no vision_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    from vision_tpu_torch import _kernels
    from vision_tpu_torch.io import _codecs

    smi = nvidia_smi()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc processes
        codec = pool.submit(_codecs.build)
        build_s = _kernels.build_all()
        codec_s = codec.result()
    emit("build", seconds=build_s, codec_seconds=codec_s,
         wall_s=time.perf_counter() - t0, dir=str(_kernels.build_dir()))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    # the plain bf16 products keep their f32 sums whole, as the kernel does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    os.environ.pop("VISION_TPU_NMS_KERNEL", None)

    kernels = Kernels()
    t_phases = time.perf_counter()
    rows, model = faster_rcnn_phases(kernels)
    rows += faster_rcnn_image_phases(kernels, model)
    del model
    torch.cuda.empty_cache()
    rows += faster_rcnn_train_phase(kernels)
    torch.cuda.empty_cache()
    rows += mask_rcnn_image_phases(kernels)
    rows += mask_rcnn_train_phase(kernels)
    torch.cuda.empty_cache()
    rows += faster_rcnn_v2_image_phases(kernels)
    rows += mask_rcnn_v2_image_phases(kernels)
    torch.cuda.empty_cache()
    rows += rcnn_v2_train_phases(kernels)
    torch.cuda.empty_cache()
    ops_rest_phase()
    torch.cuda.empty_cache()
    rows += mask_rcnn_deform_phases(kernels)
    torch.cuda.empty_cache()
    rows += mask_rcnn_deform_v2_phases(kernels)
    torch.cuda.empty_cache()
    keypoint_rcnn_phases(kernels)
    torch.cuda.empty_cache()
    rows += retinanet_phases(kernels)
    torch.cuda.empty_cache()
    t_det = time.perf_counter()
    rows += detection_zoo_phases(kernels)
    det_s = time.perf_counter() - t_det
    torch.cuda.empty_cache()
    vit_phases(kernels)
    torch.cuda.empty_cache()
    rows += vit_long_phases(kernels)
    torch.cuda.empty_cache()
    rows += resnet50_phases(kernels)
    torch.cuda.empty_cache()
    imagenet_e2e_phases()
    torch.cuda.empty_cache()
    t_folder = time.perf_counter()
    imagenet_folder_phases(kernels)
    folder_s = time.perf_counter() - t_folder
    torch.cuda.empty_cache()
    t_zoo = time.perf_counter()
    zoo_phases(kernels)
    zoo_s = time.perf_counter() - t_zoo
    torch.cuda.empty_cache()
    t_dense = time.perf_counter()
    dense_phases(kernels)
    dense_s = time.perf_counter() - t_dense
    torch.cuda.empty_cache()
    t_recipe = time.perf_counter()
    recipe_phases(kernels)
    recipe_s = time.perf_counter() - t_recipe
    torch.cuda.empty_cache()
    t_coco_voc = time.perf_counter()
    coco_voc_folder_phases(kernels, rows)
    coco_voc_s = time.perf_counter() - t_coco_voc
    torch.cuda.empty_cache()
    t_rest = time.perf_counter()
    transforms_rest_phases(kernels, rows)
    transforms_rest_s = time.perf_counter() - t_rest
    torch.cuda.empty_cache()
    t_small = time.perf_counter()
    small_data_phases(kernels, rows)
    small_data_s = time.perf_counter() - t_small
    emit("done", build_s=build_s, phases_s=time.perf_counter() - t_phases,
         detection_zoo_s=det_s, folder_s=folder_s, zoo_s=zoo_s, dense_s=dense_s,
         recipe_s=recipe_s, coco_voc_s=coco_voc_s,
         transforms_rest_s=transforms_rest_s, small_data_s=small_data_s,
         total_s=time.perf_counter() - t0)

    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def require_launched(launches: dict, names, path: str) -> None:
    missing = [n for n in names if launches[n] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the {path} path: {missing}")


def faster_rcnn_phases(kernels):
    """Faster R-CNN inference through the bitmask NMS, window-pool and
    RoIAlign kernels, then once more through the row-serial NMS kernel."""
    import torch

    model = scaled_detector("fasterrcnn_resnet50_fpn")
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(1, 3, SIZE, SIZE, generator=gen).cuda()
    emit("model", name="fasterrcnn_resnet50_fpn", classes=91,
         params=sum(p.numel() for p in model.parameters()), input=[1, 3, SIZE, SIZE],
         dtype="float32", seed=0, cls_scale=CLS_SCALE,
         matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_tf32=torch.backends.cudnn.allow_tf32)

    calls: dict = {}
    with torch.inference_mode():
        with kernels.recording(calls):
            model(images)  # warm-up; records every kernel's inputs
        torch.cuda.synchronize()
        kernels.reset()
        times = []
        for _ in range(TIMED_FORWARDS):
            t = time.perf_counter()
            dets = model(images)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        launches = kernels.launches()
        emit("faster_rcnn", ms_per_img_median=statistics.median(times),
             ms_per_img_all=times, forwards=TIMED_FORWARDS,
             launches=launches)
        require_launched(launches, ("nms", "window_pool", "roi_align"),
                         "Faster R-CNN")

        with kernels.plain_versions():
            ref = model(images)
        torch.cuda.synchronize()
        check_detections(dets, ref)

        rows = kernel_phases(kernels, calls, launches)
        rows.append(rowscan_phase(kernels, model, images, dets))
    return rows, model


def rowscan_phase(kernels, model, images, dets):
    """The same forward with ``VISION_TPU_NMS_KERNEL=rowscan``: the same
    detections to the last bit, through ``nms_rowscan``."""
    import torch

    calls: dict = {}
    os.environ["VISION_TPU_NMS_KERNEL"] = "rowscan"
    try:
        kernels.reset()
        with kernels.recording(calls):
            t = time.perf_counter()
            got = model(images)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        launches = kernels.launches()
    finally:
        del os.environ["VISION_TPU_NMS_KERNEL"]
    valid = dets.valid
    same = {
        "valid": bool(torch.equal(got.valid, valid)),
        "labels": bool(torch.equal(got.labels[valid], dets.labels[valid])),
        "scores": bool(torch.equal(got.scores[valid], dets.scores[valid])),
        "boxes": bool(torch.equal(got.boxes[valid], dets.boxes[valid])),
    }
    emit("faster_rcnn_rowscan", ms_per_img=ms, launches=launches,
         valid=int(valid.sum()), equal_to_bitmask_run=same, tol=0.0)
    require_launched(launches, ("nms_rowscan", "window_pool", "roi_align"),
                     "Faster R-CNN (rowscan)")
    if launches["nms_rowscan"] != 2 or launches["nms"] != 0:
        raise RuntimeError(f"rowscan forward launched {launches}: expected 2 "
                           "nms_rowscan and no bitmask nms")
    if not all(same.values()):
        raise RuntimeError(f"rowscan detections differ from the bitmask run's: {same}")

    cases = [kernel_case(kernels, "nms_rowscan", args, "faster_rcnn_rowscan")
             for args in calls["nms_rowscan"]]
    return kernel_row("nms_rowscan", cases, launches["nms_rowscan"])


def rpn_internals(model, canvas):
    """The FPN maps and RPN head outputs of an R-CNN on ``canvas``."""
    feats, objectness, deltas, _ = model.features_and_rpn(canvas)
    return list(feats.values()), objectness, deltas


def serve_phase(kernels, model, preset, transform, raw, dtype, calls,
                request=None, internals=rpn_internals):
    """A warm-up request that records the kernels' inputs, ``TIMED_FORWARDS``
    timed requests (ms per image: host clock around a request that ends in
    ``torch.cuda.synchronize()``, over the images), the launch counts of
    those, one request through the plain versions, and ``internals(model,
    canvas)`` of the request's canvas (the FPN maps and RPN head outputs
    unless given). ``request`` is ``detection_request.serve`` unless given
    (same arguments; its first result the ``ImageList``)."""
    import torch

    from vision_tpu_torch.tools.detection_request import serve

    request = request or serve
    with torch.inference_mode():
        with kernels.recording(calls):
            request(model, preset, transform, raw, dtype)
        torch.cuda.synchronize()
        kernels.reset()
        times = []
        for _ in range(TIMED_FORWARDS):
            t = time.perf_counter()
            out = request(model, preset, transform, raw, dtype)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3 / len(raw))
        launches = kernels.launches()
        with kernels.plain_versions():
            ref = request(model, preset, transform, raw, dtype)
        inner = internals(model, out[0].tensors.to(dtype))
        torch.cuda.synchronize()
    return out, ref, times, launches, inner


def faster_rcnn_image_phases(kernels, model):
    """Faster R-CNN served from raw images, in f32 (``faster_rcnn_images``)
    and in bf16 (``faster_rcnn_amp``: ``model.to(torch.bfloat16)`` and a bf16
    canvas), each against the same request through the plain versions, and
    the bf16 request's FPN maps and RPN head outputs against the f32 ones;
    then the bf16 window-pool and RoIAlign variants against their plain
    bf16 versions at the amp request's inputs, with the f32 kernels timed
    at the f32 request's inputs beside them."""
    import torch

    from vision_tpu_torch.models.detection import (
        FasterRCNN_ResNet50_FPN_Weights,
        GeneralizedRCNNTransform,
    )
    from vision_tpu_torch.tools.detection_request import SEED, raw_images

    raw = raw_images()
    preset = FasterRCNN_ResNet50_FPN_Weights.COCO_V1.transforms()
    transform = GeneralizedRCNNTransform()

    calls32: dict = {}
    (batch, dets, boxes), (_, ref, _), times, launches, rpn32 = serve_phase(
        kernels, model, preset, transform, raw, torch.float32, calls32)
    emit("faster_rcnn_images", dtype="float32", images=[list(r.shape) for r in raw],
         seed=SEED, canvas=list(transform.fixed_size), batch=len(raw),
         image_sizes=batch.image_sizes, expected_image_sizes=RESIZED,
         ms_per_img_median=statistics.median(times), ms_per_img_all=times,
         requests=TIMED_FORWARDS, launches=launches)
    if batch.image_sizes != RESIZED:
        raise RuntimeError(f"image sizes {batch.image_sizes}, expected {RESIZED}")
    require_launched(launches, ("nms", "window_pool_f32", "roi_align_f32"),
                     "Faster R-CNN from images (f32)")
    check_detections(dets, ref, batch=len(raw), phase="faster_rcnn_images")
    check_mapped_boxes(boxes, raw)

    model.to(torch.bfloat16)
    calls16: dict = {}
    (batch16, dets16, boxes16), (_, ref16, _), times16, launches16, rpn16 = (
        serve_phase(kernels, model, preset, transform, raw, torch.bfloat16,
                    calls16))
    b = dets16.boxes
    s32 = dets.scores.flatten().sort().values[-5:]
    s16 = dets16.scores.float().flatten().sort().values[-5:]
    top5_err = float((s16 - s32).abs().max())
    inside = bool(((b >= -1e-3) & (b <= max(transform.fixed_size) + 1e-3)).all())
    vs_f32 = {k: rel_errs(g, w) for k, g, w in zip(
        ("fpn", "objectness", "deltas"), rpn16, rpn32)}
    vs_f32_max = max(max(v) for v in vs_f32.values())
    emit("faster_rcnn_amp", dtype="bfloat16", boxes_dtype=str(b.dtype)[6:],
         scores_dtype=str(dets16.scores.dtype)[6:],
         image_sizes=batch16.image_sizes, ms_per_img_median=statistics.median(times16),
         ms_per_img_all=times16, requests=TIMED_FORWARDS, launches=launches16,
         top5_scores_f32=s32.tolist(), top5_scores_bf16=s16.tolist(),
         top5_max_err=top5_err, top5_tol=0.05, boxes_inside_canvas=inside,
         rel_err_vs_f32=vs_f32, rel_err_vs_f32_tol=AMP_VS_F32_TOL,
         f32_ms_per_img_median=statistics.median(times))
    if b.dtype != torch.float32 or not bool(torch.isfinite(b).all()) or not inside:
        raise RuntimeError("amp: boxes not f32, not finite or outside the canvas")
    if top5_err > 0.05:
        raise RuntimeError("amp: the top 5 scores are not within 0.05 of the "
                           "f32 run's")
    if not vs_f32_max <= AMP_VS_F32_TOL:
        raise RuntimeError(f"amp: FPN maps or RPN head outputs {vs_f32_max} of "
                           f"their largest value away from f32's")
    require_launched(launches16, ("nms", "window_pool_bf16", "roi_align_bf16"),
                     "Faster R-CNN from images (bf16)")
    if launches16["window_pool_f32"] or launches16["roi_align_f32"]:
        raise RuntimeError(f"the amp path launched an f32 pooler kernel: {launches16}")
    check_detections(dets16, ref16, batch=len(raw), score_tol=AMP_SCORE_TOL,
                     box_tol=AMP_BOX_TOL, phase="faster_rcnn_amp")
    check_mapped_boxes(boxes16, raw)

    rows = []
    for name in ("window_pool", "roi_align"):
        f32 = summed([kernel_case(kernels, name, args, "faster_rcnn_images")
                      for args in calls32[name]])
        bf16 = [kernel_case(kernels, name, args, "faster_rcnn_amp")
                for args in calls16[name]]
        rows.append(kernel_row(
            name, bf16, launches16[f"{name}_bf16"], row_name=f"{name}_bf16",
            dtype="bfloat16", path="faster_rcnn_amp (1344x1344, batch 2)",
            f32_same_path={k: f32[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "bytes_bound_ms", "operations_bound_ms", "max_abs_err")}))
    return rows


def det_train_steps(batch, steps, first_step=None, timed=0,
                    name="fasterrcnn_resnet50_fpn", grads=DET_GRADS,
                    dtype=None, setup=None, twin=None, model_kwargs=None,
                    after=None):
    """A fresh seeded detector ``name`` (R50-FPN,
    ``trainable_backbone_layers=3``, and ``model_kwargs`` for its builder;
    ``setup(model)`` called on it first, where given) and ``steps`` SGD
    steps of
    ``make_detection_train_step`` (``compute_dtype=dtype``) on ``batch``,
    the samplers drawing from a
    generator on its device seeded with 0; then ``timed`` more steps.
    Returns each step's losses, the gradients of ``grads`` after the first
    step, and the timed steps' wall ms (host clock around a step whose loss
    is read back), and the peak memory allocated over the timed steps; with
    ``twin``, also ``twin(model, generator)``'s result from just before
    each of the ``steps`` steps; with ``after``, ``after(model)``'s result
    once the steps are done. A RetinaNet trains by the one-stage
    convention (``one_stage=True``)."""
    import torch

    from vision_tpu_torch.models import get_model
    from vision_tpu_torch.parallel import make_detection_train_step
    from vision_tpu_torch.tools.detection_request import recipe_optimizer

    model = get_model(name, seed=0, trainable_backbone_layers=3,
                      **(model_kwargs or {}))
    if setup is not None:
        setup(model)
    optimizer, scheduler = recipe_optimizer(model)
    step = make_detection_train_step(model, optimizer, compute_dtype=dtype,
                                     one_stage=one_stage(name))
    gen = torch.Generator(device=batch["image"].device).manual_seed(0)
    named = dict(model.named_parameters())
    out = {"losses": [], "ms": [], "lr": [],
           "trainable_params": sum(p.numel() for p in model.parameters()
                                   if p.requires_grad),
           "params": sum(p.numel() for p in model.parameters())}
    out["twin"] = []
    for i in range(steps + timed):
        if twin is not None and i < steps:
            out["twin"].append(twin(model, gen))
        if i == steps:
            torch.cuda.reset_peak_memory_stats()
        ctx = first_step() if i == 0 and first_step else contextlib.nullcontext()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with ctx:
            losses = step(batch, gen)
            loss = float(losses["loss"])
        if i >= steps:
            out["ms"].append((time.perf_counter() - t) * 1e3)
        out["lr"].append(optimizer.param_groups[0]["lr"])
        scheduler.step()
        out["losses"].append({k: float(v) for k, v in losses.items()})
        if i == 0:
            out["grads"] = {n: named[n].grad.clone() for n in grads}
        if not math.isfinite(loss):
            raise RuntimeError(f"{name} train: loss {loss} at step {i}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if after is not None:
        out["after"] = after(model)
    return out


def one_stage(name: str) -> bool:
    """Whether detector ``name`` trains by the one-stage convention."""
    return name.startswith("retinanet")


def plain_twin_step(kernels, model, gen, batch, dtype, grads, name=""):
    """One train step through the plain versions from ``model``'s weights
    and ``gen``'s state, on copies of both (the two are left as they were):
    its losses and the gradients of ``grads``."""
    import torch

    from vision_tpu_torch.parallel import make_detection_train_step

    twin = copy.deepcopy(model)
    params = [p for p in twin.parameters() if p.requires_grad]
    step = make_detection_train_step(twin, torch.optim.SGD(params, lr=0.0),
                                     compute_dtype=dtype,
                                     one_stage=one_stage(name))
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    with kernels.plain_versions():
        losses = step(batch, g)
    named = dict(twin.named_parameters())
    out = ({k: float(v) for k, v in losses.items()},
           {n: named[n].grad.clone() for n in grads})
    del twin, step, params
    return out


def det_train_phase(kernels, phase, name="fasterrcnn_resnet50_fpn",
                    grads=DET_GRADS, num_classes=91, f32_first=None,
                    prepare=None, require=(), model_kwargs=None,
                    evaluate=None, grad_norm="max", grad_tols=None,
                    batch=None, **extras):
    """A detector trained on the request's two images (batch 2, the 1344
    canvas, seeded gt boxes; with ``extras`` the gt masks or keypoints of
    ``train_batch``), or on ``batch`` where given: ``DET_STEPS`` SGD steps through the kernels (the
    first recording every kernel's inputs; the launches counted over all of
    them), each against one step through the plain versions from the same
    weights and generator state (``plain_twin_step``). Step 1: each loss
    within 1e-4 relative, the gradients of ``grads`` within 1e-3 of each
    one's largest value (the same samples: the forward up to the pooler is
    the same, NMS to the bit); the later steps' summed loss within 1e-4
    (each part is printed). Then 5 timed steps after a warm-up.

    Each plain step starts where the kernel path stands, not from the plain
    path's own last step: three steps apart the two trajectories part by
    more than their round-off, since after an update a RoI whose box sits
    on a pooler level's or window's edge switches with the last bit, and at
    this random init a mask RoI's binary cross-entropy is some 18 a pixel,
    so one RoI moves the mask loss by percents (the deform model's plain
    path, whose gathers scatter their gradients with atomics, read step-2
    mask losses of 14.63 and 14.39 in two runs of the same code, the kernel
    path 14.63 in both).

    With ``f32_first`` (the f32 phase's step 1 losses) the steps are the amp
    steps (``compute_dtype=torch.bfloat16``), held against the same bf16
    steps through the plain versions: each step's losses within
    ``AMP_FIRST_LOSS_TOL`` (step 1 each loss, later steps the sum), the
    gradients within ``AMP_GRAD_TOL``; and step 1's losses against the f32
    step's: the RPN's two and the sum within ``AMP_VS_F32_TOL`` (the RoI
    head's part on samples drawn from other proposals, printed). Every
    pooler kernel launch must be a bf16 one, but RoIAlign's at the f32
    mask targets. ``prepare(model, images)`` readies each fresh model (the
    deform model's offset predictors), outside the counted launches; the
    kernels of ``require`` must launch too (in the step's type).
    ``model_kwargs`` go to the model's builder. A one-stage detector
    (RetinaNet) runs no pooler: every loss is gated against the f32 step
    (on the same anchors and gt), and its kernel is the NMS of
    ``evaluate(model, batch, dtype)``, which the phase runs on the trained
    model after its steps, inside the counted window. ``grad_norm="fro"``
    gates each gradient by its relative Frobenius norm, not its largest
    element (the v2 detectors: ``V2_GRAD_NORM``); ``grad_tols`` raises
    the named gradients' tolerances (``V2_GRAD_TOLS``). Returns the recorded
    calls, the launches and step 1's losses."""
    import torch

    from vision_tpu_torch.models.detection import (
        FasterRCNN_ResNet50_FPN_Weights,
        GeneralizedRCNNTransform,
    )
    from vision_tpu_torch.tools.detection_request import raw_images, train_batch

    if batch is None:
        with torch.no_grad():
            batch = train_batch(
                FasterRCNN_ResNet50_FPN_Weights.COCO_V1.transforms(),
                GeneralizedRCNNTransform(), raw_images(),
                num_classes=num_classes, **extras)
    calls: dict = {}
    kernels.reset()
    amp = f32_first is not None
    dtype = torch.bfloat16 if amp else None

    def setup(model):
        if prepare is not None:
            prepare(model, batch["image"])
        kernels.reset()

    def twin(model, gen):
        return plain_twin_step(kernels, model, gen, batch, dtype, grads, name)

    run = det_train_steps(batch, DET_STEPS,
                          first_step=lambda: kernels.recording(calls),
                          timed=1 + TIMED_FORWARDS, name=name, grads=grads,
                          dtype=dtype, setup=setup, twin=twin,
                          model_kwargs=model_kwargs,
                          after=evaluate and (lambda m: evaluate(m, batch, dtype)))
    launches = kernels.launches()
    ref = {"losses": [t[0] for t in run["twin"]], "grads": run["twin"][0][1]}
    names = list(run["losses"][0])
    loss_rel = [{k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in names}
                for a, b in zip(run["losses"], ref["losses"])]
    grad_rel = {n: rel_errs([run["grads"][n]], [ref["grads"][n]])[0]
                for n in grads}
    grad_fro = {n: fro_errs(run["grads"][n], ref["grads"][n]) for n in grads}
    gated_grads = grad_fro if grad_norm == "fro" else grad_rel
    ms = statistics.median(run["ms"][1:])
    first_tol, grad_tol = (AMP_FIRST_LOSS_TOL, AMP_GRAD_TOL) if amp else (
        1e-4, 1e-3)
    tols = {n: max(grad_tol, (grad_tols or {}).get(n, 0.0)) for n in grads}
    gated = names if one_stage(name) else list(AMP_VS_F32_GATED)
    fields = {"evaluation": run["after"]} if evaluate else {}
    if amp:
        vs_f32 = {k: abs(run["losses"][0][k] - f32_first[k])
                  / max(abs(f32_first[k]), 1e-30) for k in names}
        fields.update(f32_first_losses=f32_first,
                      first_loss_rel_err_vs_f32=vs_f32,
                      vs_f32_tol=AMP_VS_F32_TOL, vs_f32_gated=gated)
    emit(phase, model=name, params=run["params"],
         trainable_params=run["trainable_params"],
         trainable_backbone_layers=3, input=list(batch["image"].shape),
         gt_boxes=batch["valid"].sum(1).tolist(),
         gt_rows=batch["valid"].shape[1],
         gt_extras={k: list(batch[k].shape) for k in ("masks", "keypoints")
                    if k in batch},
         dtype="bfloat16" if amp else "float32",
         optimizer="SGD lr 0.02 momentum 0.9 weight_decay 1e-4, linear "
                   "warmup from 1e-3 over 1000 steps", lr_per_step=run["lr"],
         steps_compared=DET_STEPS, losses=run["losses"][:DET_STEPS],
         plain_losses=ref["losses"], loss_rel_err=loss_rel,
         loss_tol=first_tol, grad_rel_err=grad_rel, grad_fro_rel_err=grad_fro,
         grad_gate=grad_norm, grad_tol=grad_tol, grad_tols=tols,
         ms_per_step_median=ms,
         images_per_s=len(batch["image"]) / ms * 1e3, ms_all=run["ms"],
         timed_steps=TIMED_FORWARDS, peak_memory_gb=run["peak_gb"],
         recorded_inputs_gb=sum(a.numel() * a.element_size()
                                for args in calls.values() for call in args
                                for a in call if torch.is_tensor(a)) / 1e9,
         launches=launches, **fields)
    tag = "bf16" if amp else "f32"
    poolers = () if one_stage(name) else (
        f"window_pool_{tag}", f"window_pool_backward_{tag}", f"roi_align_{tag}",
        f"roi_align_backward_{tag}")
    require_launched(launches, ("nms", *poolers,
                                *(f"{n}_{tag}" for n in require)), phase)
    if amp and (launches["window_pool_f32"]
                or launches["window_pool_backward_f32"]
                or launches["roi_align_backward_f32"]
                or any(launches[f"{n}_f32"] for n in require)):
        raise RuntimeError(f"{phase} launched an f32 pooler or deform kernel: "
                           f"{launches}")
    if amp and max(vs_f32[k] for k in gated) > AMP_VS_F32_TOL:
        raise RuntimeError(f"{phase}: step 1's losses lie too far from the f32 "
                           f"step's: {vs_f32}")
    if (max(loss_rel[0].values()) > first_tol
            or max(r["loss"] for r in loss_rel[1:]) > first_tol
            or any(gated_grads[n] > tols[n] for n in grads)):
        raise RuntimeError(f"{phase}: the kernel train path disagrees with "
                           "the plain path")
    first, last = run["losses"][0]["loss"], run["losses"][DET_STEPS - 1]["loss"]
    if first == last:
        raise RuntimeError(f"{phase}: the last compared loss equals the "
                           "first: no update")
    first_losses = run["losses"][0]
    del run, ref, batch
    torch.cuda.empty_cache()
    return calls, launches, first_losses


def backward_rows(kernels, calls, launches, phase, size, suffix=""):
    """The two backward kernels against their plain versions at the
    recorded calls of pooled size ``size``, a row each, named
    ``<kernel><suffix>``, its launches those of the calls' type."""
    rows = []
    for name in ("window_pool_backward", "roi_align_backward"):
        cases = [kernel_case(kernels, name, args, phase)
                 for args in at_size(calls, name, size)]
        tag = "bf16" if cases[0]["dtype"] == "bfloat16" else "f32"
        rows.append(kernel_row(
            name, cases, launches[f"{name}_{tag}"], row_name=name + suffix,
            dtype=cases[0]["dtype"], path=f"{phase} (1344x1344, batch 2)",
            calls_per_step=len(cases), counterpart="XLA VJP, no pallas_call",
            same_bits_twice=all(c["same_bits_twice"] for c in cases)))
    return rows


def faster_rcnn_train_phase(kernels):
    """Faster R-CNN training (``det_train_phase``), then the backward
    kernels against their plain versions at the recorded inputs; the same
    in bf16 (``faster_rcnn_train_amp``), through the backward kernels' bf16
    variants."""
    calls, launches, first = det_train_phase(kernels, "faster_rcnn_train")
    rows = backward_rows(kernels, calls, launches, "faster_rcnn_train", 7)
    del calls
    calls, launches, _ = det_train_phase(kernels, "faster_rcnn_train_amp",
                                         f32_first=first)
    return rows + backward_rows(kernels, calls, launches,
                                "faster_rcnn_train_amp", 7, "_bf16")


def serve_masks(model, preset, transform, raw, dtype):
    """The served Mask R-CNN request: ``detection_request.serve``, then
    each image's masks pasted at its own size (``paste_masks``)."""
    from vision_tpu_torch.tools.detection_request import paste_masks, serve

    batch, dets, boxes = serve(model, preset, transform, raw, dtype)
    return batch, dets, boxes, paste_masks(dets, boxes, raw)


def scaled_detector(name, cls_scale=CLS_SCALE, **model_kwargs):
    """Detector ``name`` (``model_kwargs`` to its builder) with seeded
    weights and ``cls_score`` scaled by ``cls_scale``, so that detections
    pass the score threshold."""
    import torch

    from vision_tpu_torch.models import get_model

    model = get_model(name, seed=0, **model_kwargs)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.weight.mul_(cls_scale)
    return model


def at_size(calls, name, size):
    """The recorded calls of kernel ``name`` whose pooled output is ``size``
    on a side (7 for the box pooler, 14 for the mask and keypoint poolers,
    28 for the mask targets)."""
    def out_size(args):
        if name.endswith("_backward"):
            return args[0].shape[2]
        if name == "window_pool":
            return args[3].shape[1]
        return args[2] if isinstance(args[2], int) else args[2][0]
    return [a for a in calls.get(name, []) if out_size(a) == size]


def mask_rcnn_image_phases(kernels):
    """Mask R-CNN served from the two raw images (``serve_mask_phases``),
    then the window pool and the dense fallback's RoIAlign at 14x14 against
    their plain versions at the requests' inputs."""
    import torch

    calls, launches_by = serve_mask_phases(
        kernels, "maskrcnn_resnet50_fpn", ("mask_rcnn_images", "mask_rcnn_amp"))
    rows = []
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for name in ("window_pool", "roi_align"):
            cases = [kernel_case(kernels, name, args, f"mask_rcnn ({tag}, 14x14)")
                     for args in at_size(calls[dtype], name, 14)]
            rows.append(kernel_row(
                name, cases, launches_by[tag][f"{name}_{tag}"],
                row_name=f"{name}_14x14" + ("_bf16" if tag == "bf16" else ""),
                dtype=str(dtype)[6:],
                path=f"mask_rcnn_{'amp' if tag == 'bf16' else 'images'} "
                     "(1344x1344, batch 2; the mask pooler)"))
    return rows


def serve_mask_phases(kernels, name, phases, num_params=None, prepare=None,
                      require=(), model_kwargs=None, cls_scale=CLS_SCALE,
                      box_rel_tol=0.0):
    """A Mask R-CNN ``name`` (``model_kwargs`` to its builder) served from
    the two raw images, in f32 (``phases[0]``) and, where ``phases`` names
    a second, in bf16 (``phases[1]``): the request of
    ``faster_rcnn_images`` with the 28x28 masks of every detection and the
    masks pasted into each image at its own size, each against the same
    request through the plain versions: detections as ``check_detections``
    holds them; the mask branch through the plain versions on the same
    detections' boxes: 28x28 and pasted masks within ``MASK_TOL`` in f32;
    in bf16 no further from the plain bf16 masks than those lie from the
    f32 model's masks at the same boxes (bf16 arithmetic's own reach; the
    masks of the whole plain request are printed beside them).
    ``prepare(model, canvas)`` readies the f32 model on the request's
    canvas first; the kernels of ``require`` must launch too. The model
    has ``num_params`` parameters (the published Mask R-CNN's when None),
    its ``cls_score`` scaled by ``cls_scale``; ``box_rel_tol`` goes to
    ``check_detections`` in bf16.
    Returns the recorded calls of each type and the launches."""
    import torch

    from vision_tpu_torch.models.detection import (
        GeneralizedRCNNTransform,
        MaskRCNN_ResNet50_FPN_Weights,
    )
    from vision_tpu_torch.tools.detection_request import paste_masks, raw_images

    raw = raw_images()
    preset = MaskRCNN_ResNet50_FPN_Weights.COCO_V1.transforms()
    transform = GeneralizedRCNNTransform()
    model = scaled_detector(name, cls_scale, **(model_kwargs or {}))
    if prepare is not None:
        with torch.no_grad():
            prepare(model, transform([preset(r) for r in raw]).tensors)
    params = sum(p.numel() for p in model.parameters())
    num_params = num_params or MaskRCNN_ResNet50_FPN_Weights.COCO_V1.meta[
        "num_params"]
    launches_by = {}
    calls = {}
    for dtype, phase in zip((torch.float32, torch.bfloat16), phases):
        if dtype == torch.bfloat16:
            model32 = copy.deepcopy(model)
        model.to(dtype)
        calls[dtype] = {}
        (batch, dets, boxes, pasted), (_, ref, _, _), times, launches, _ = (
            serve_phase(kernels, model, preset, transform, raw, dtype,
                        calls[dtype], request=serve_masks))
        bf16 = dtype == torch.bfloat16
        tag = "bf16" if bf16 else "f32"
        check_detections(dets, ref, batch=len(raw), phase=phase,
                         score_tol=AMP_SCORE_TOL if bf16 else 1e-4,
                         box_tol=AMP_BOX_TOL if bf16 else 1e-2,
                         box_rel_tol=box_rel_tol if bf16 else 0.0)
        valid = dets.valid
        tol = MASK_TOL
        # the mask branch through the plain versions on this request's own
        # detections: the two paths' boxes differ by round-off (check_detections),
        # and a box moved by 5e-4 px moves its mask by ~1e-4 on its own
        with torch.inference_mode(), kernels.plain_versions():
            feats = model.backbone(batch.tensors.to(dtype))
            same_boxes = dets._replace(masks=model.masks(
                feats, dets.boxes, dets.labels, tuple(batch.tensors.shape[-2:])))
            same_pasted = paste_masks(same_boxes, boxes, raw)
        mask_err = float((dets.masks[valid].float()
                          - same_boxes.masks[valid].float()).abs().max())
        pasted_err = max(float((a[v].float() - b[v].float()).abs().max())
                         for a, b, v in zip(pasted, same_pasted, valid))
        ref_err = float((dets.masks[valid].float()
                         - ref.masks[valid].float()).abs().max())
        shapes_ok = (tuple(dets.masks.shape) == (len(raw), 100, 28, 28) and all(
            tuple(p.shape) == (100, *r.shape[-2:]) for p, r in zip(pasted, raw)))
        finite = bool(torch.isfinite(dets.masks.float()).all()) and all(
            bool(torch.isfinite(p.float()).all()) for p in pasted)
        fields = {}
        if bf16:
            # the f32 model's masks at the bf16 request's own boxes: how far
            # bf16 arithmetic alone moves them, the gate of the bf16 check
            with torch.inference_mode():
                m32 = model32.masks(model32.backbone(batch.tensors), dets.boxes,
                                    dets.labels, tuple(batch.tensors.shape[-2:]))
            tol = float((same_boxes.masks[valid].float() - m32[valid]).abs().max())
            fields = dict(masks_vs_f32_max_abs_err=float(
                (dets.masks[valid].float() - m32[valid]).abs().max()),
                plain_masks_vs_f32_max_abs_err=tol,
                mask_mean_abs_err=float((dets.masks[valid].float()
                                         - same_boxes.masks[valid].float()).abs().mean()))
            del model32
        emit(phase, model=name, params=params,
             dtype=str(dtype)[6:], masks_dtype=str(dets.masks.dtype)[6:],
             images=[list(r.shape) for r in raw], canvas=list(transform.fixed_size),
             image_sizes=batch.image_sizes, ms_per_img_median=statistics.median(times),
             ms_per_img_all=times, requests=TIMED_FORWARDS, launches=launches,
             mask_max_abs_err=mask_err, pasted_max_abs_err=pasted_err,
             mask_tol=tol, mask_max_abs_err_vs_plain_request=ref_err,
             shapes_ok=shapes_ok, finite=finite, **fields)
        if params != num_params or not shapes_ok or not finite:
            raise RuntimeError(f"{phase}: wrong parameter count, mask shapes or "
                               "non-finite masks")
        require_launched(launches, ("nms", f"window_pool_{tag}",
                                    f"roi_align_{tag}",
                                    *(f"{n}_{tag}" for n in require)), phase)
        if bf16 and (launches["window_pool_f32"] or launches["roi_align_f32"]
                     or any(launches[f"{n}_f32"] for n in require)):
            raise RuntimeError(f"{phase} launched an f32 pooler or deform "
                               f"kernel: {launches}")
        if not (mask_err <= tol and pasted_err <= tol):
            raise RuntimeError(f"{phase}: masks differ from the plain path's")
        check_mapped_boxes(boxes, raw)
        launches_by[tag] = launches
    del model
    torch.cuda.empty_cache()
    return calls, launches_by


def mask_rcnn_train_phase(kernels):
    """Mask R-CNN training (``det_train_phase`` with the gt masks: the
    ellipse inscribed in each gt box), its five losses and the gradients of
    ``MASK_GRADS``; then the kernels at the shapes only this path gives
    them against their plain versions: the window pool and its backward at
    14x14 over 1,024 RoIs, RoIAlign's backward at 14x14 (the dense
    fallback), and RoIAlign at the mask targets (one channel, 28x28, scale
    1, the gt masks on the 1344 canvas); then the amp step
    (``mask_rcnn_train_amp``) and both backward kernels' bf16 variants at
    14x14."""
    calls, launches, first = det_train_phase(
        kernels, "mask_rcnn_train", name="maskrcnn_resnet50_fpn",
        grads=MASK_GRADS, masks=True)
    if not at_size(calls, "roi_align", 28):
        raise RuntimeError("mask_rcnn_train: no RoIAlign launch at the mask targets")
    path = "mask_rcnn_train (1344x1344, batch 2)"
    rows = []
    for name, size, row_name in (
            ("window_pool", 14, "window_pool_14x14_train"),
            ("roi_align", 28, "roi_align_mask_targets")):
        cases = [kernel_case(kernels, name, args, f"{path}, {row_name}")
                 for args in at_size(calls, name, size)]
        rows.append(kernel_row(name, cases, launches[name], row_name=row_name,
                               dtype="float32", path=path,
                               calls_per_step=len(cases)))
    rows += backward_rows(kernels, calls, launches, "mask_rcnn_train", 14,
                          "_14x14")
    del calls
    calls, launches, _ = det_train_phase(
        kernels, "mask_rcnn_train_amp", name="maskrcnn_resnet50_fpn",
        grads=MASK_GRADS, f32_first=first, masks=True)
    return rows + backward_rows(kernels, calls, launches,
                                "mask_rcnn_train_amp", 14, "_14x14_bf16")


def faster_rcnn_v2_image_phases(kernels):
    """``fasterrcnn_resnet50_fpn_v2`` served from the two raw images in f32
    (``faster_rcnn_v2_images``) and bf16 (``faster_rcnn_v2_amp``), each
    against the same request through the plain versions at the v1 phases'
    tolerances; then the NMS, window-pool and RoIAlign kernels against
    their plain versions at the requests' inputs (rows ``*_v2``,
    ``*_v2_bf16``)."""
    import torch

    from vision_tpu_torch.models.detection import (
        FasterRCNN_ResNet50_FPN_V2_Weights,
        GeneralizedRCNNTransform,
    )
    from vision_tpu_torch.tools.detection_request import raw_images

    raw = raw_images()
    preset = FasterRCNN_ResNet50_FPN_V2_Weights.COCO_V1.transforms()
    transform = GeneralizedRCNNTransform()
    model = scaled_detector("fasterrcnn_resnet50_fpn_v2", V2_CLS_SCALE)
    params = sum(p.numel() for p in model.parameters())
    if params != FASTER_V2_PARAMS:
        raise RuntimeError(f"fasterrcnn_resnet50_fpn_v2: {params} parameters")
    rows = []
    for dtype, phase in ((torch.float32, "faster_rcnn_v2_images"),
                         (torch.bfloat16, "faster_rcnn_v2_amp")):
        bf16 = dtype == torch.bfloat16
        tag = "bf16" if bf16 else "f32"
        model.to(dtype)
        calls: dict = {}
        (batch, dets, boxes), (_, ref, _), times, launches, _ = serve_phase(
            kernels, model, preset, transform, raw, dtype, calls)
        emit(phase, model="fasterrcnn_resnet50_fpn_v2", params=params,
             dtype=str(dtype)[6:], images=[list(r.shape) for r in raw],
             canvas=list(transform.fixed_size), image_sizes=batch.image_sizes,
             ms_per_img_median=statistics.median(times), ms_per_img_all=times,
             requests=TIMED_FORWARDS, launches=launches)
        require_launched(launches, ("nms", f"window_pool_{tag}",
                                    f"roi_align_{tag}"), phase)
        if bf16 and (launches["window_pool_f32"] or launches["roi_align_f32"]):
            raise RuntimeError(f"{phase} launched an f32 pooler kernel: "
                               f"{launches}")
        check_detections(dets, ref, batch=len(raw), phase=phase,
                         score_tol=AMP_SCORE_TOL if bf16 else 1e-4,
                         box_tol=AMP_BOX_TOL if bf16 else 1e-2,
                         box_rel_tol=V2_AMP_BOX_REL if bf16 else 0.0)
        check_mapped_boxes(boxes, raw)
        for name in ("nms", "window_pool", "roi_align"):
            cases = [kernel_case(kernels, name, args, phase)
                     for args in calls[name]]
            rows.append(kernel_row(
                name, cases,
                launches[name if name == "nms" else f"{name}_{tag}"],
                row_name=f"{name}_v2" + ("_bf16" if bf16 else ""),
                dtype=cases[0]["dtype"], path=f"{phase} (1344x1344, batch 2)"))
    del model
    torch.cuda.empty_cache()
    return rows


def mask_rcnn_v2_image_phases(kernels):
    """``maskrcnn_resnet50_fpn_v2`` served from the two raw images in f32
    and bf16 (``serve_mask_phases``), then the window pool and the dense
    fallback's RoIAlign at 14x14 against their plain versions at the
    requests' inputs."""
    import torch

    calls, launches_by = serve_mask_phases(
        kernels, "maskrcnn_resnet50_fpn_v2",
        ("mask_rcnn_v2_images", "mask_rcnn_v2_amp"), num_params=MASK_V2_PARAMS,
        cls_scale=V2_CLS_SCALE, box_rel_tol=V2_AMP_BOX_REL)
    rows = []
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for name in ("window_pool", "roi_align"):
            cases = [kernel_case(kernels, name, args, f"mask_rcnn_v2 ({tag}, 14x14)")
                     for args in at_size(calls[dtype], name, 14)]
            rows.append(kernel_row(
                name, cases, launches_by[tag][f"{name}_{tag}"],
                row_name=f"{name}_14x14_v2" + ("_bf16" if tag == "bf16" else ""),
                dtype=str(dtype)[6:],
                path=f"mask_rcnn_v2_{'amp' if tag == 'bf16' else 'images'} "
                     "(1344x1344, batch 2; the mask pooler)"))
    return rows


def v2_statistics(phase):
    """``prepare`` and ``evaluate`` hooks of ``det_train_phase`` for a v2
    detector: the first keeps the fresh model's running statistics, the
    second, after the steps, requires every one of ``V2_MOVING`` to have
    moved and every one of ``V2_FIXED`` (the FPN's, and a mask head's) to
    be as it was, and returns the counts."""
    from vision_tpu_torch.ops.misc import BatchNorm2d

    before = {}

    def stats(model):
        return {f"{mn}.{bn}": b.detach().clone()
                for mn, m in model.named_modules() if isinstance(m, BatchNorm2d)
                for bn, b in m.named_buffers(recurse=False) if "running" in bn}

    def prepare(model, images):
        before.update(stats(model))

    def evaluate(model, batch, dtype):
        import torch

        after = stats(model)
        moved = {n for n, v in after.items() if not torch.equal(v, before[n])}
        wrong = sorted(n for n in after if (n in moved) != n.startswith(V2_MOVING))
        out = {"running_statistics": len(after), "moved": len(moved),
               "moved_by_group": {g: sum(n.startswith(g) for n in moved)
                                  for g in V2_MOVING + V2_FIXED},
               "wrong": wrong[:10]}
        if wrong or not all(any(n.startswith(g) for n in after)
                            for g in V2_MOVING + V2_FIXED[:1]):
            raise RuntimeError(f"{phase}: running statistics broke the v2 "
                               f"rules: {out}")
        return out

    return prepare, evaluate


def rcnn_v2_train_phases(kernels):
    """Both v2 detectors trained at batch 2 (``det_train_phase``: step 1 in
    lockstep with the plain twin, then timed), in f32 and amp, the
    trunk's and the box head's running statistics required to move and the
    FPN's and the mask head's to stay (``v2_statistics``); then the two
    backward kernels against their plain versions at the recorded inputs
    (rows ``*_v2``, ``*_14x14_v2`` and their ``_bf16``)."""
    rows = []
    for name, phase, grads, extras, size, suffix in (
            ("fasterrcnn_resnet50_fpn_v2", "faster_rcnn_v2_train", V2_GRADS,
             {}, 7, "_v2"),
            ("maskrcnn_resnet50_fpn_v2", "mask_rcnn_v2_train", V2_MASK_GRADS,
             {"masks": True}, 14, "_14x14_v2")):
        first = None
        for amp in (False, True):
            tag = phase + ("_amp" if amp else "")
            prepare, evaluate = v2_statistics(tag)
            calls, launches, losses = det_train_phase(
                kernels, tag, name=name, grads=grads, f32_first=first,
                prepare=prepare, evaluate=evaluate, grad_norm=V2_GRAD_NORM,
                grad_tols=V2_GRAD_TOLS, **extras)
            rows += backward_rows(kernels, calls, launches, tag, size,
                                  suffix + ("_bf16" if amp else ""))
            del calls
            first = losses
    return rows


def ops_rest_inputs(generator):
    """The realistic inputs of ``ops_rest_phase``, on the CPU: R-FCN's COCO
    head (an 800x1344 image at stride 16, 81 classes x 7 x 7 score maps,
    300 RoIs), Fast R-CNN's VGG-16 head (2 images, 512 channels, 128 RoIs
    an image) and a ResNet stage's activations ([32, 256, 56, 56])."""
    import torch

    def rois(n, images):
        side = torch.exp(torch.empty(n, 2).uniform_(math.log(32), math.log(512),
                                                    generator=generator))
        xy = torch.rand(n, 2, generator=generator) * (torch.tensor([1344.0, 800.0])
                                                      - side).clamp(min=0)
        b = torch.arange(images).repeat_interleave(n // images).float()
        return torch.cat([b[:, None], xy, xy + side], 1)

    return {
        "rfcn": (torch.randn(1, 81 * 7 * 7, 50, 84, generator=generator),
                 rois(300, 1)),
        "vgg": (torch.randn(2, 512, 50, 84, generator=generator), rois(256, 2)),
        "stage": torch.randn(32, 256, 56, 56, generator=generator),
    }


def ops_rest_phase(dev="cuda") -> list:
    """``roi_pool``, ``ps_roi_align``, ``ps_roi_pool``, ``drop_block2d`` and
    ``stochastic_depth`` (torch composites; the JAX package has no
    ``pallas_call`` for them) on the card at realistic sizes, each against
    the same call on CPU tensors (the random ones handed the card's draws),
    forward and input gradient within ``OPS_REST_TOL`` of the largest CPU
    value; the card's gradient twice for the same bits; host
    synchronisations counted (PyTorch's sync debug mode); the device time
    of the forward and of the backward (``device_ms``) beside each one's
    bytes bound (inputs read once, output written once), and the CUDA
    kernels each launches (``torch.profiler``). Returns one line a op."""
    import warnings

    import torch

    from vision_tpu_torch import ops
    from vision_tpu_torch.ops.drop_block import drop_block_seeds
    from vision_tpu_torch.ops.stochastic_depth import stochastic_depth_keep

    gen = torch.Generator().manual_seed(19)
    inputs = ops_rest_inputs(gen)
    dev = torch.device(dev)
    cuda_gen = torch.Generator(device=dev).manual_seed(19)
    stage = inputs["stage"]
    seeds = drop_block_seeds(stage.shape, 0.1, 7, cuda_gen, dev)
    keep = stochastic_depth_keep(stage.shape, 0.1, "row", cuda_gen, dev)
    cases = {
        "ps_roi_align": (lambda x, r, d: ops.ps_roi_align(x, r, 7, 1 / 16, 2),
                         *inputs["rfcn"], "R-FCN COCO head: [1, 3969, 50, 84], "
                         "300 RoIs, 7x7, scale 1/16, sr 2"),
        "ps_roi_pool": (lambda x, r, d: ops.ps_roi_pool(x, r, 7, 1 / 16),
                        *inputs["rfcn"], "R-FCN COCO head: [1, 3969, 50, 84], "
                        "300 RoIs, 7x7, scale 1/16"),
        "roi_pool": (lambda x, r, d: ops.roi_pool(x, r, 7, 1 / 16),
                     *inputs["vgg"], "Fast R-CNN VGG-16 head: [2, 512, 50, 84], "
                     "128 RoIs an image, 7x7, scale 1/16"),
        "drop_block2d": (lambda x, r, d: ops.drop_block2d(
            x, 0.1, 7, seeds=seeds.to(d)), stage, None,
            "p 0.1, block 7 on [32, 256, 56, 56] (seeds drawn on the card)"),
        "stochastic_depth": (lambda x, r, d: ops.stochastic_depth(
            x, 0.1, "row", keep=keep.to(d)), stage, None,
            "row, p 0.1 on [32, 256, 56, 56] (keep drawn on the card)"),
    }
    lines = []
    for name, (fn, x, r, shape) in cases.items():
        xc = x.detach().clone().requires_grad_()
        out_cpu = fn(xc, r, "cpu")
        cot = torch.randn(out_cpu.shape, generator=gen)
        out_cpu.backward(cot)
        xd = x.to(dev, copy=True).requires_grad_()
        rd = r.to(dev) if r is not None else None
        cot_d = cot.to(dev)
        out = fn(xd, rd, dev)
        out.backward(cot_d)
        grad1 = xd.grad.clone()
        xd.grad = None
        fn(xd, rd, dev).backward(cot_d)
        same_bits = bool(torch.equal(grad1, xd.grad))
        scale = float(out_cpu.abs().max())
        gscale = float(xc.grad.abs().max())
        err = float((out.detach().cpu() - out_cpu.detach()).abs().max()) / scale
        gerr = float((grad1.cpu() - xc.grad).abs().max()) / gscale
        xd.grad = None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn(xd.detach(), rd, dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("called a synchronizing" in str(w.message) for w in caught)
        with torch.no_grad():
            fwd_ms = device_ms(lambda: fn(xd, rd, dev))

        def fwd_bwd():
            xd.grad = None
            fn(xd, rd, dev).backward(cot_d)

        step_ms = device_ms(fwd_bwd, launches=10)
        with torch.no_grad():
            fwd_kernels = cuda_trace(lambda: fn(xd, rd, dev))["kernels"]
        nbytes = x.numel() * 4 + out.numel() * 4 + (
            r.numel() * 4 if r is not None else 0)
        grad_bytes = out.numel() * 4 + x.numel() * 4 + (
            r.numel() * 4 if r is not None else 0)
        fwd_bound = nbytes / PEAK_BYTES_PER_S * 1e3
        bwd_bound = grad_bytes / PEAK_BYTES_PER_S * 1e3
        line = dict(op=name, shape=shape, dtype="float32",
                    max_rel_err=err, grad_max_rel_err=gerr, tol=OPS_REST_TOL,
                    grad_same_bits_twice=same_bits, host_syncs=syncs,
                    device_ms=fwd_ms, bound_ms=fwd_bound, bound_by="bytes",
                    over_bound=fwd_ms / fwd_bound,
                    backward_device_ms=step_ms - fwd_ms, backward_bound_ms=bwd_bound,
                    backward_over_bound=(step_ms - fwd_ms) / bwd_bound,
                    forward_backward_device_ms=step_ms,
                    forward_kernel_launches=fwd_kernels)
        emit("ops_rest", **line)
        if not (err <= OPS_REST_TOL and gerr <= OPS_REST_TOL):
            raise RuntimeError(f"ops_rest: {name} on the card disagrees with "
                               f"the CPU: {err}, {gerr}")
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"ops_rest: {name} gave non-finite values")
        lines.append(line)
        del xc, xd, out, out_cpu, grad1
        torch.cuda.empty_cache()
    return lines


def keypoint_check(dets, ref, maps, ref_maps, phase) -> dict:
    """Keypoint R-CNN kernel path against plain path on the valid rows: each
    keypoint's heatmap cell equal wherever the plain heatmap's largest cell
    leads the next by more than ``NEAR_TIE`` of the heatmaps' largest
    magnitude, its position then within the boxes' 1e-2 px, and the
    keypoint scores within ``NEAR_TIE`` of that magnitude."""
    import torch

    valid = dets.valid.flatten()
    flat = ref_maps.float().flatten(2)[valid]  # [V, K, HM*HM]
    scale = float(flat.abs().max())
    top2 = flat.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > NEAR_TIE * scale
    same_cell = maps.float().flatten(2)[valid].argmax(-1) == flat.argmax(-1)
    pos_err = (dets.keypoints.flatten(0, 1)[valid]
               - ref.keypoints.flatten(0, 1)[valid]).abs().amax(-1)
    score_err = float((dets.keypoints_scores.flatten(0, 1)[valid]
                       - ref.keypoints_scores.flatten(0, 1)[valid]).abs().max())
    out = dict(keypoints_compared=int(clear.numel()), near_ties=int((~clear).sum()),
               other_cell=int((~same_cell).sum()),
               other_cell_without_near_tie=int((~same_cell & clear).sum()),
               same_cell_max_pos_err=float(pos_err[same_cell].max()),
               pos_tol=1e-2, score_max_abs_err=score_err,
               score_tol=NEAR_TIE * scale, heatmap_scale=scale)
    if (out["other_cell_without_near_tie"] or out["same_cell_max_pos_err"] > 1e-2
            or not score_err <= NEAR_TIE * scale):
        raise RuntimeError(f"{phase}: keypoints differ from the plain path's: {out}")
    if not bool(torch.isfinite(dets.keypoints).all()):
        raise RuntimeError(f"{phase}: non-finite keypoints")
    return out


def keypoint_rcnn_phases(kernels):
    """Keypoint R-CNN (2 classes, 17 keypoints) served from the two raw
    images in f32 (``keypoint_rcnn_images``: ``keypoint_check`` on the
    valid rows, the detections as ``check_detections`` holds them), then
    trained (``keypoint_rcnn_train``: ``det_train_phase`` with seeded gt
    keypoints, the gradients of ``KEYPOINT_GRADS``), and trained in amp
    (``keypoint_rcnn_train_amp``: held as ``mask_rcnn_train_amp`` is, step
    1 against a plain bf16 step from the kernel path's weights at losses
    1e-2 and gradients 5e-2, its RPN losses and sum within 5e-2 of the f32
    step's). Its kernels run at the shapes of the Mask R-CNN phases, whose
    rows they share."""
    import torch

    from vision_tpu_torch.models.detection import (
        GeneralizedRCNNTransform,
        KeypointRCNN_ResNet50_FPN_Weights,
    )
    from vision_tpu_torch.tools.detection_request import raw_images

    raw = raw_images()
    model = scaled_detector("keypointrcnn_resnet50_fpn")
    params = sum(p.numel() for p in model.parameters())
    maps = []
    hook = model.roi_heads.keypoint_predictor.register_forward_hook(
        lambda mod, args, out: maps.append(out))
    transform = GeneralizedRCNNTransform()
    (batch, dets, boxes), (_, ref, _), times, launches, _ = serve_phase(
        kernels, model, KeypointRCNN_ResNet50_FPN_Weights.COCO_V1.transforms(),
        transform, raw, torch.float32, {})
    hook.remove()
    check_detections(dets, ref, batch=len(raw), phase="keypoint_rcnn_images")
    # the hook saw: the recorded request, the timed ones, the plain one
    check = keypoint_check(dets, ref, maps[-2], maps[-1], "keypoint_rcnn_images")
    emit("keypoint_rcnn_images", model="keypointrcnn_resnet50_fpn",
         params=params, classes=2, num_keypoints=17, dtype="float32",
         image_sizes=batch.image_sizes, ms_per_img_median=statistics.median(times),
         ms_per_img_all=times, requests=TIMED_FORWARDS, launches=launches,
         keypoints_shape=list(dets.keypoints.shape), **check)
    if (params != KeypointRCNN_ResNet50_FPN_Weights.COCO_V1.meta["num_params"]
            or tuple(dets.keypoints.shape) != (len(raw), 100, 17, 3)):
        raise RuntimeError("keypoint_rcnn_images: wrong parameter count or shape")
    require_launched(launches, ("nms", "window_pool_f32", "roi_align_f32"),
                     "keypoint_rcnn_images")
    check_mapped_boxes(boxes, raw)
    del model, maps
    torch.cuda.empty_cache()
    _, _, first = det_train_phase(kernels, "keypoint_rcnn_train",
                                  name="keypointrcnn_resnet50_fpn",
                                  grads=KEYPOINT_GRADS, num_classes=2,
                                  keypoints=True)
    torch.cuda.empty_cache()
    det_train_phase(kernels, "keypoint_rcnn_train_amp",
                    name="keypointrcnn_resnet50_fpn", grads=KEYPOINT_GRADS,
                    num_classes=2, f32_first=first, keypoints=True)


def seed_deform_offsets(model, images) -> None:
    """``seed_offsets`` on ``images``, its per-predictor RMS printed."""
    from vision_tpu_torch.tools.detection_request import OFFSET_RMS, seed_offsets

    rms = seed_offsets(model, images, rms=OFFSET_RMS)
    emit("deform_offsets_seeded", target_rms=OFFSET_RMS, predictors=len(rms),
         rms_per_predictor=rms, images=list(images.shape))


def offset_stats(calls, phase) -> dict:
    """Over the recorded deformable-conv calls of one forward: the offsets'
    RMS (px), the share of samples outside their map (not strictly inside
    (-1, H) x (-1, W)) and the share of corners that are invalid (of the
    samples' four corners, those outside the map, the outside samples'
    included); for DCNv2 calls, the masks' mean and range. Fails the phase
    if the RMS is under ``OFFSET_RMS_MIN`` or no sample falls outside its
    map."""
    import torch

    from vision_tpu_torch.ops.deform_conv import sample_positions

    sq = n_off = outside = samples = bad = 0.0
    masks = []
    for x, off, mask, k, stride, pad, dil in calls:
        if mask is not None:
            masks.append(mask.float().flatten())
        h, w = x.shape[-2:]
        y, xx = sample_positions(off, k, stride, pad, dil)
        ins = (y > -1) & (y < h) & (xx > -1) & (xx < w)
        yl, xl = torch.floor(y), torch.floor(xx)
        vy = [(yl >= 0), (yl + 1 <= h - 1)]
        vx = [(xl >= 0), (xl + 1 <= w - 1)]
        valid = sum((ins & a & b).sum() for a in vy for b in vx)
        sq += float(off.float().pow(2).sum())
        n_off += off.numel()
        outside += float((~ins).sum())
        samples += ins.numel()
        bad += 4 * ins.numel() - float(valid)
    out = dict(offset_rms=math.sqrt(sq / n_off), samples_outside=outside / samples,
               corners_invalid=bad / (4 * samples), calls=len(calls),
               rms_min=OFFSET_RMS_MIN)
    if masks:
        m = torch.cat(masks)
        out.update(modulated_calls=len(masks), mask_mean=float(m.mean()),
                   mask_min=float(m.min()), mask_max=float(m.max()))
    emit("deform_offsets", path=phase, **out)
    if out["offset_rms"] < OFFSET_RMS_MIN or outside == 0:
        raise RuntimeError(f"{phase}: the offsets are not real: {out}")
    return out


def deform_key(args):
    """A deformable-conv call's shape: its input's and its offsets' (which
    give the stride)."""
    return (tuple(args[0].shape), tuple(args[1].shape))


def distinct(calls):
    """The first call of each distinct shape, and how often each came."""
    first, count = {}, {}
    for args in calls:
        key = deform_key(args)
        first.setdefault(key, args)
        count[key] = count.get(key, 0) + 1
    return [(first[k], count[k]) for k in first]


def deform_work(args):
    """Bytes: the input, the offsets (and mask) read once, the f32 columns
    written once. Operations: per column element the four products, three
    sums (and the mask's product), in f32."""
    x, off, mask, k = args[:4]
    n, _, oh, ow = off.shape
    cols = n * oh * ow * k[0] * k[1] * x.shape[1]
    nbytes = (x.numel() * x.element_size() + off.numel() * off.element_size()
              + (0 if mask is None else mask.numel() * mask.element_size())
              + cols * 4)
    return nbytes, cols * (8 if mask is not None else 7), PEAK_F32_FLOPS


def deform_backward_work(args):
    """Bytes: the input, the offsets (and mask) and ``g_cols`` read once,
    the input's gradient (its type) and the offsets' (and mask's) gradients
    (f32) written once. Operations, per column element: the input's
    gradient (two products and a sum a corner: 12), the offsets'
    (four differences, four products, two sums and the two running sums:
    12) and the mask's (8), in f32."""
    x, off, mask, g_cols = args[:4]
    nbytes = (2 * x.numel() * x.element_size() + off.numel() * (
        off.element_size() + 4) + g_cols.numel() * 4
        + (0 if mask is None else mask.numel() * (mask.element_size() + 4)))
    return nbytes, g_cols.numel() * (32 if mask is not None else 24), PEAK_F32_FLOPS


def deform_case(kernels, args, path, count, **meta):
    """The column kernel against its plain version on the card at one
    recorded call: the same bits in f32 and with a bf16 input (the columns
    are f32 in both: a bf16 input is widened exactly, and both round each
    product and sum on its own); ``ms``, ``device_ms`` and the plain
    version's ms of one call, ``count`` calls a forward."""
    import torch

    got = kernels.cuda["deform_conv"](*args)
    want = kernels.plain["deform_conv"](*args)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want))
    del got, want
    err, rel, ms, dev_ms, plain_ms = compare_kernel(
        kernels.cuda["deform_conv"], kernels.plain["deform_conv"], args)
    nbytes, ops, peak = deform_work(args)
    b_ms, b_by = bound_ms(nbytes, ops, peak)
    case = dict(kernel="deform_conv", path=path, dtype=str(args[0].dtype)[6:],
                shape=[list(args[0].shape), list(args[1].shape)],
                stride=args[4], mask=args[2] is not None, calls_per_forward=count,
                **meta, same_bits=same, max_abs_err=err, max_rel_err=rel,
                tol="same bits", ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                bytes_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                operations_bound_ms=ops / peak * 1e3)
    emit("kernel_case", **case)
    if not same:
        raise RuntimeError(f"deform_conv ({path}) is not its plain version's "
                           f"bits: {err} off")
    return case


def deform_backward_case(kernels, args, path, count, **meta):
    """The backward kernels at one recorded call: the same bits on a second
    call, and against the plain version in f64 on the card (sample
    positions f32, as always): each gradient in f32 within 1e-5 of the
    largest sum of its terms' magnitudes (its f32 sum's error scales with
    that, not with the result); the bf16 input's gradient within one bf16
    step of the exact value plus that. Times as ``deform_case``."""
    import torch

    cuda, plain = kernels.cuda["deform_conv_backward"], kernels.plain[
        "deform_conv_backward"]
    first, again = cuda(*args), cuda(*args)
    torch.cuda.synchronize()
    same = all((a is None and b is None) or bool(torch.equal(a, b))
               for a, b in zip(first, again))
    del again
    x, off, mask, g = args[:4]
    rest = args[4:]
    exact = plain(x.double(), off, None if mask is None else mask.double(),
                  g.double(), *rest)
    mags = deform_backward_magnitudes(x, off, mask, g, *rest)
    names = ("input", "offset", "mask")
    errs, gates = {}, {}
    for nm, got, want, mag in zip(names, first, exact, mags):
        if want is None:
            continue
        diff = (got.double() - want).abs()
        m = float(mag.max())
        errs[nm] = float(diff.max())
        if nm == "input" and got.dtype == torch.bfloat16:
            step = 2.0 ** -7 * want.abs() + 1e-5 * m
            gates[nm] = float((diff / step.clamp(min=1e-30)).max())
        else:
            gates[nm] = float(diff.max()) / max(m, 1e-30)
    del first, exact, mags
    bf16 = x.dtype == torch.bfloat16
    ms = cuda_ms(lambda: cuda(*args))
    dev_ms = device_ms(lambda: cuda(*args))
    plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
    nbytes, ops, peak = deform_backward_work(args)
    b_ms, b_by = bound_ms(nbytes, ops, peak)
    tols = {nm: (1.0 if nm == "input" and bf16 else 1e-5) for nm in gates}
    case = dict(kernel="deform_conv_backward", path=path,
                dtype=str(x.dtype)[6:], shape=[list(x.shape), list(off.shape)],
                stride=args[5], mask=mask is not None, calls_per_step=count,
                **meta, same_bits_twice=same, max_abs_err_vs_f64=errs,
                gate=gates, gate_tol=tols,
                max_abs_err=max(errs.values()), ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bytes_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                operations_bound_ms=ops / peak * 1e3)
    emit("kernel_case", **case)
    if not same:
        raise RuntimeError(f"deform_conv_backward ({path}): two calls on the "
                           "same inputs differ")
    if any(gates[nm] > tols[nm] for nm in gates):
        raise RuntimeError(f"deform_conv_backward ({path}) disagrees with its "
                           f"plain version: {gates}")
    return case


def deform_backward_magnitudes(x, off, mask, g, k, stride, pad, dil):
    """In f64, per gradient element the sum of its terms' magnitudes: the
    input's, |g| m w scattered (the plain backward of |g|); the offsets',
    sum over the channels of |g| m (hx |v1| + lx |v2| + hx |v3| + lx |v4|)
    in y and (hy |v1| + hy |v2| + ly |v3| + ly |v4|) in x; the mask's, sum
    of |g| (w1 |v1| + ... + w4 |v4|)."""
    import torch

    from vision_tpu_torch.ops.deform_conv import (
        _corners,
        deform_conv_backward_plain,
    )

    m64 = None if mask is None else mask.double()
    gi = deform_conv_backward_plain(x.double(), off, m64, g.double().abs(), k,
                                    stride, pad, dil)[0]
    (v1, v2, v3, v4), (hy, ly, hx, lx) = _corners(x.double().abs(), off, k,
                                                  stride, pad, dil)
    n, og, k2, oh, ow, cg = v1.shape
    ga = g.double().abs().reshape(n, oh, ow, k2, og, cg).permute(0, 4, 3, 1, 2, 5)
    mm = 1.0 if mask is None else m64.reshape(n, og, k2, oh, ow)
    my = (ga * (hx[..., None] * (v1 + v3) + lx[..., None] * (v2 + v4))).sum(-1) * mm
    mx = (ga * (hy[..., None] * (v1 + v2) + ly[..., None] * (v3 + v4))).sum(-1) * mm
    go = torch.stack([my, mx], 3).reshape(off.shape)
    gm = None
    if mask is not None:
        gm = (ga * ((hy * hx)[..., None] * v1 + (hy * lx)[..., None] * v2
                    + (ly * hx)[..., None] * v3 + (ly * lx)[..., None] * v4)
              ).sum(-1).reshape(mask.shape)
    return gi, go, gm


def deform_rows(kernels, calls, launches, phase, row_name, backward=False,
                modulated=None):
    """The deformable convolution's row (or its backward's) at the recorded
    calls of one forward (one step): a case a distinct shape, its times
    weighted by its calls; with ``modulated`` also one case at that call
    with a seeded mask (in the row's error, not its times)."""
    import torch

    case_fn = deform_backward_case if backward else deform_case
    name = "deform_conv_backward" if backward else "deform_conv"
    cases, weighted = [], []
    for args, count in distinct(calls):
        c = case_fn(kernels, args, phase, count)
        cases.append(c)
        weighted.append(dict(c, **{k: c[k] * count for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bytes_bound_ms",
            "operations_bound_ms")}))
    extra = {}
    if modulated is not None:
        args = list(modulated)
        x, off = args[:2]
        gen = torch.Generator(device=x.device).manual_seed(7)
        n, _, oh, ow = off.shape
        args[2] = torch.rand(n, off.shape[1] // 2, oh, ow, device=x.device,
                             generator=gen).to(off.dtype)
        c = case_fn(kernels, tuple(args), phase + " (seeded DCNv2 mask)", 0,
                    modulated=True)
        extra = dict(modulated_case=dict(
            max_abs_err=c["max_abs_err"], ms=c["ms"], device_ms=c["device_ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            shape=c["shape"]))
    row = kernel_row(name, weighted, launches, row_name=row_name,
                     dtype=cases[0]["dtype"], path=f"{phase} (1344x1344, batch 2)",
                     distinct_shapes=len(cases), calls=len(calls),
                     **{"calls_per_step" if backward else "calls_per_forward":
                        len(calls)}, **extra)
    if modulated is not None:
        row["max_abs_err"] = max(row["max_abs_err"], extra["modulated_case"][
            "max_abs_err"])
    if backward:
        row["same_bits_twice"] = all(c["same_bits_twice"] for c in cases)
    return row


def mask_rcnn_deform_phases(kernels):
    """``maskrcnn_resnet50_fpn_deform`` (DCNv1 in C3-C5, 13 deformable 3x3s
    a forward) with its offset predictors seeded (``seed_deform_offsets``):
    served from the two raw images in f32 (``mask_rcnn_deform_images``) and
    bf16 (``mask_rcnn_deform_amp``), as ``serve_mask_phases`` holds the
    Mask R-CNN requests, and trained in f32 (``mask_rcnn_deform_train``)
    and bf16 (``mask_rcnn_deform_train_amp``), as ``det_train_phase`` holds
    the train steps, with the gradients of ``DEFORM_GRADS``; each phase
    through both deform kernels; the offsets' statistics of the request and
    of the train step. Then the column kernel at each distinct shape of the
    requests (f32 and bf16 input; one C4 call again with a seeded DCNv2
    mask), and the backward kernels at each of the train steps'."""
    import torch

    calls, launches = serve_mask_phases(
        kernels, "maskrcnn_resnet50_fpn_deform",
        ("mask_rcnn_deform_images", "mask_rcnn_deform_amp"),
        num_params=DEFORM_PARAMS, prepare=seed_deform_offsets,
        require=("deform_conv",))
    per_forward = [a for a in calls[torch.float32]["deform_conv"]][:13]
    offset_stats(per_forward, "mask_rcnn_deform_images")
    c4 = [a for a in per_forward if a[0].shape[1] == 256][1]
    rows = [
        deform_rows(kernels, per_forward, launches["f32"]["deform_conv_f32"],
                    "mask_rcnn_deform_images", "deform_conv", modulated=c4),
        deform_rows(kernels, calls[torch.bfloat16]["deform_conv"][:13],
                    launches["bf16"]["deform_conv_bf16"],
                    "mask_rcnn_deform_amp", "deform_conv_bf16"),
    ]
    del calls, per_forward, c4
    torch.cuda.empty_cache()

    train, tlaunches, first = det_train_phase(
        kernels, "mask_rcnn_deform_train", name="maskrcnn_resnet50_fpn_deform",
        grads=DEFORM_GRADS, masks=True, prepare=seed_deform_offsets,
        require=("deform_conv", "deform_conv_backward"))
    offset_stats(train["deform_conv"][:13], "mask_rcnn_deform_train")
    bwd = train["deform_conv_backward"]
    c4 = [a for a in bwd if a[0].shape[1] == 256][1]
    rows.append(deform_rows(kernels, bwd, tlaunches["deform_conv_backward_f32"],
                            "mask_rcnn_deform_train", "deform_conv_backward",
                            backward=True, modulated=c4))
    del train, bwd, c4
    torch.cuda.empty_cache()
    train, tlaunches, _ = det_train_phase(
        kernels, "mask_rcnn_deform_train_amp",
        name="maskrcnn_resnet50_fpn_deform", grads=DEFORM_GRADS,
        f32_first=first, masks=True, prepare=seed_deform_offsets,
        require=("deform_conv", "deform_conv_backward"))
    rows.append(deform_rows(kernels, train["deform_conv_backward"],
                            tlaunches["deform_conv_backward_bf16"],
                            "mask_rcnn_deform_train_amp",
                            "deform_conv_backward_bf16", backward=True))
    return rows


def mask_rcnn_deform_v2_phases(kernels):
    """The DCNv2 deform trunk (``maskrcnn_resnet50_fpn_deform(
    deform_modulated=True)``: each predictor also gives the 9 mask logits
    of its deformable conv, which multiplies each sample by their sigmoid),
    its predictors seeded (``seed_deform_offsets``: mask logits of RMS
    ~1.5 too): served from the two raw images in f32
    (``mask_rcnn_deform_v2_images``, held as ``mask_rcnn_deform_images``)
    and trained in bf16 (``mask_rcnn_deform_v2_train_amp``, held as
    ``mask_rcnn_deform_train_amp``, its step 1 against one f32 step of the
    same model through the kernels); every deformable call must carry a
    mask. Then the column kernel at each distinct shape of the request and
    the backward kernels at each of the amp step's, with their masks."""
    import torch

    from vision_tpu_torch.models.detection import (
        FasterRCNN_ResNet50_FPN_Weights,
        GeneralizedRCNNTransform,
    )
    from vision_tpu_torch.tools.detection_request import raw_images, train_batch

    name = "maskrcnn_resnet50_fpn_deform"
    calls, launches = serve_mask_phases(
        kernels, name, ("mask_rcnn_deform_v2_images",),
        num_params=DEFORM_V2_PARAMS, prepare=seed_deform_offsets,
        require=("deform_conv",), model_kwargs=DEFORM_V2)
    per_forward = calls[torch.float32]["deform_conv"][:13]
    offset_stats(per_forward, "mask_rcnn_deform_v2_images")
    if any(a[2] is None for a in per_forward):
        raise RuntimeError("mask_rcnn_deform_v2_images: a deformable call "
                           "without a mask")
    rows = [deform_rows(kernels, per_forward, launches["f32"]["deform_conv_f32"],
                        "mask_rcnn_deform_v2_images", "deform_conv_v2")]
    del calls, per_forward
    torch.cuda.empty_cache()

    with torch.no_grad():
        batch = train_batch(FasterRCNN_ResNet50_FPN_Weights.COCO_V1.transforms(),
                            GeneralizedRCNNTransform(), raw_images(), masks=True)
    first = det_train_steps(
        batch, 1, name=name, grads=DEFORM_GRADS, model_kwargs=DEFORM_V2,
        setup=lambda model: seed_deform_offsets(model, batch["image"]))[
            "losses"][0]
    del batch
    torch.cuda.empty_cache()
    train, tlaunches, _ = det_train_phase(
        kernels, "mask_rcnn_deform_v2_train_amp", name=name,
        grads=DEFORM_GRADS, f32_first=first, masks=True,
        prepare=seed_deform_offsets, require=("deform_conv",
                                              "deform_conv_backward"),
        model_kwargs=DEFORM_V2)
    bwd = train["deform_conv_backward"]
    if any(a[2] is None for a in bwd):
        raise RuntimeError("mask_rcnn_deform_v2_train_amp: a deformable "
                           "backward call without a mask")
    rows.append(deform_rows(kernels, bwd, tlaunches["deform_conv_backward_bf16"],
                            "mask_rcnn_deform_v2_train_amp",
                            "deform_conv_backward_v2_bf16", backward=True))
    return rows


def check_mapped_boxes(boxes, raw, per_image=100) -> None:
    """``postprocess_boxes`` gave each image [per_image, 4] finite f32
    boxes."""
    import torch

    for bx, r in zip(boxes, raw):
        if tuple(bx.shape) != (per_image, 4) or bx.dtype != torch.float32 or not bool(
                torch.isfinite(bx).all()):
            raise RuntimeError(f"boxes mapped to a {tuple(r.shape)} image: "
                               f"{tuple(bx.shape)} {bx.dtype}")


def scaled_retinanet(name):
    """RetinaNet ``name`` with seeded weights and ``cls_logits``' weight
    scaled by ``RETINA_CLS_SCALE``, so that detections pass the score
    threshold."""
    import torch

    from vision_tpu_torch.models import get_model

    model = get_model(name, seed=0)
    with torch.no_grad():
        model.head.classification_head.cls_logits.weight.mul_(RETINA_CLS_SCALE)
    return model


def one_stage_internals(model, canvas):
    """A one-stage detector's feature maps and head outputs on ``canvas``,
    each a list of tensors (RetinaNet's and FCOS's per level, SSD's
    concatenated over its maps)."""
    outs, feats = model(canvas, return_features=True)
    return [list(feats.values())] + [o if isinstance(o, list) else [o]
                                     for o in outs[:-1]]


def top_k_keys(x, k):
    """``ops/_topk.py:top_k`` of f32 ``x [..., N]`` (N < 2**32, no NaN)
    through one ``torch.topk`` of int64 keys: the value's bits, mapped to a
    signed integer of the same order, above the index's complement, so that
    every key is unique and a larger key is a larger value or, at an equal
    value, a lower index (-0.0 ranks below 0.0, which a sort holds equal; a
    sigmoid gives no -0.0)."""
    import torch

    low32 = (1 << 32) - 1
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, ~bits - (1 << 31))
    idx = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
    top = torch.topk(ordered * (1 << 32) + (low32 - idx), k, dim=-1).values
    indices = low32 - (top & low32)
    return torch.gather(x, -1, indices), indices


def topk_line(scores, k=1000) -> None:
    """The per-level candidate selection at P3 (``scores [N, R, K]``, the
    request's sigmoid scores): ``top_k_2d`` (the row-max decomposition the
    postprocess takes), ``top_k_keys`` (one ``torch.topk`` over unique
    int64 keys) and ``top_k`` (a stable sort of all the scores), the same
    values and indices, timed in turns."""
    import torch

    from vision_tpu_torch.ops._topk import top_k, top_k_2d

    flat = scores.flatten(1)
    ways = {"top_k_2d": lambda: top_k_2d(scores, k),
            "top_k_keys": lambda: top_k_keys(flat, k),
            "top_k_sort": lambda: top_k(flat, k)}
    outs = {n: fn() for n, fn in ways.items()}
    ref = outs["top_k_sort"]
    equal = {n: bool(torch.equal(o[0], ref[0]) and torch.equal(o[1], ref[1]))
             for n, o in outs.items()}
    ms = {n: cuda_ms(fn, reps=10) for n, fn in ways.items()}
    dev = {n: device_ms(fn, launches=10) for n, fn in ways.items()}
    emit("topk_retinanet", shape=list(scores.shape), k=k, equal=equal, ms=ms,
         device_ms=dev, taken="top_k_2d")
    if not all(equal.values()):
        raise RuntimeError(f"topk_retinanet: the three top-k differ: {equal}")


def first_images(outs, k):
    """A one-stage detector's outputs (lists over levels or tensors,
    anchors last) cut to the first ``k`` images."""
    return [[t[:k] for t in o] if isinstance(o, list) else o[:k]
            for o in outs[:-1]] + [outs[-1]]


def bf16_gate(inner16, inner32, cpu_model, internals, canvas, images):
    """The bf16 request's maps and head outputs (``inner16``, groups of
    tensors) against the f32 request's (``inner32``): each group within
    ``AMP_VS_F32_TOL`` of its largest value; where a group lies further,
    on the first ``images`` images within twice as far as the same model
    in bf16 lies from itself in f32 on the CPU on them (run only then, from
    ``cpu_model``, the f32 model's CPU copy): a randomly initialised deep
    trunk amplifies each layer's bf16 rounding (the MobileNet FPN trunk's
    maps on a 320 canvas on the CPU: 1.1e-2 after its stem, 1.7e-1 after
    its last layer), and bf16 arithmetic is then held to itself. Returns
    ``(ok, errors by group, the fields to print)``."""
    from vision_tpu_torch.tools import zoo

    vs_f32 = [max(rel_errs(g, w)) for g, w in zip(inner16, inner32)]
    if max(vs_f32) <= AMP_VS_F32_TOL or cpu_model is None:
        return max(vs_f32) <= AMP_VS_F32_TOL, vs_f32, {}
    import torch

    x = canvas[:images].float().cpu()
    with torch.inference_mode():
        want = internals(cpu_model, x)
        got = internals(zoo.to_bf16(copy.deepcopy(cpu_model)), x.bfloat16())
    cpu = [max(rel_errs(g, w)) for g, w in zip(got, want)]
    card = [max(rel_errs([t[:images] for t in g], [t[:images] for t in w]))
            for g, w in zip(inner16, inner32)]
    ok = all(e <= AMP_VS_F32_TOL or c <= max(AMP_VS_F32_TOL, 2.0 * p)
             for e, c, p in zip(vs_f32, card, cpu))
    return ok, vs_f32, dict(bf16_vs_f32_first_images=card,
                            cpu_bf16_vs_f32_first_images=cpu,
                            bf16_gate_images=images)


def one_stage_serve_phases(kernels, name, phases, model, raw, transform,
                           candidates, per_image, plain_images=None,
                           cpu_images=0, expected_sizes=None, **fields):
    """A one-stage detector ``model`` (builder ``name``) served from the
    raw images ``raw`` through its weights' preset, ``transform`` and
    ``detection_request.serve_one_stage``, in f32 (``phases[0]``) and,
    where ``phases`` names a second, in bf16 (``phases[1]``,
    ``zoo.to_bf16``: live batch norms keep f32 statistics): ms a batch
    (and an image), images/s and peak GB over ``TIMED_FORWARDS`` requests
    after a warm-up that records the kernels' inputs; every image's NMS
    takes ``candidates`` boxes; the detections (``per_image`` rows) against
    the same head outputs through the plain versions (``check_detections``)
    on the first ``plain_images`` images (all when None: the plain NMS
    builds an N x N matrix an image); with ``cpu_images`` the f32 maps and
    head outputs of that many images against the same model on the CPU,
    within ``DET_CPU_MAPS_TOL`` and ``DET_CPU_TOL``. The bf16 request's boxes and scores are f32,
    its top 5 scores within 0.05 of the f32 request's and its maps and head
    outputs within ``AMP_VS_F32_TOL`` of theirs (``bf16_gate``, which with
    ``cpu_images`` holds a group further than that to the CPU's own bf16
    arithmetic). ``fields`` go to each phase's line. Returns the f32
    request's recorded calls and each type's launches."""
    import torch

    from vision_tpu_torch.models import get_model_weights
    from vision_tpu_torch.models.detection.roi_heads import Detections
    from vision_tpu_torch.tools import zoo
    from vision_tpu_torch.tools.detection_request import SEED, serve_one_stage

    weights = get_model_weights(name).COCO_V1
    preset = weights.transforms()
    params = sum(p.numel() for p in model.parameters())
    n = len(raw)
    k = n if plain_images is None else plain_images
    launches_by, calls32, cpu_model = {}, None, None
    for dtype, phase in zip((torch.float32, torch.bfloat16), phases):
        bf16 = dtype == torch.bfloat16
        tag = "bf16" if bf16 else "f32"
        if bf16:
            zoo.to_bf16(model)
        calls: dict = {}
        with torch.inference_mode():
            with kernels.recording(calls):
                serve_one_stage(model, preset, transform, raw, dtype)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset()
            times = []
            for _ in range(TIMED_FORWARDS):
                t = time.perf_counter()
                batch, dets, boxes = serve_one_stage(model, preset, transform,
                                                     raw, dtype)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            launches = kernels.launches()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            canvas = batch.tensors.to(dtype)
            size = tuple(canvas.shape[-2:])
            # the request's own head outputs (the whole batch: a bf16
            # forward of fewer images takes other algorithms and roundings)
            outs = first_images(model(canvas), k)
            with kernels.plain_versions():
                ref = model.postprocess_detections(*outs, size)
            del outs
            inner = one_stage_internals(model, canvas)
            torch.cuda.synchronize()
        shapes = [list(c[0].shape) for c in calls["nms"]]
        ms = statistics.median(times)
        out = dict(model=name, params=params, dtype=str(dtype)[6:],
                   images=len(raw), seed=SEED, canvas=list(canvas.shape[-2:]),
                   batch=n, ms_per_batch_median=ms,
                   ms_per_img_median=ms / n, images_per_s=n / ms * 1e3,
                   ms_all=times, peak_memory_gb=peak_gb,
                   image_sizes=batch.image_sizes,
                   requests=TIMED_FORWARDS, launches=launches,
                   nms_boxes=shapes,
                   nms_valid_per_row=calls["nms"][0][1].sum(1).tolist(),
                   valid_per_image=dets.valid.sum(1).tolist(),
                   plain_images=k, **fields)
        if bf16:
            s16 = dets.scores.flatten().sort().values[-5:]
            top5_err = float((s16 - s32).abs().max())
            amp_ok, vs_f32, gate = bf16_gate(inner, inner32, cpu_model,
                                             one_stage_internals, canvas,
                                             cpu_images)
            out.update(top5_scores_f32=s32.tolist(),
                       top5_scores_bf16=s16.tolist(), top5_max_err=top5_err,
                       top5_tol=0.05, rel_err_vs_f32=vs_f32,
                       rel_err_vs_f32_tol=AMP_VS_F32_TOL,
                       boxes_dtype=str(dets.boxes.dtype)[6:],
                       scores_dtype=str(dets.scores.dtype)[6:], **gate)
        elif cpu_images:
            cpu_model = copy.deepcopy(model).cpu()
            with torch.inference_mode():
                want = one_stage_internals(cpu_model, canvas[:cpu_images].cpu())
            vs_cpu = [max(rel_errs([g[:cpu_images].cpu() for g in got], w))
                      for got, w in zip(inner, want)]
            out.update(vs_cpu_rel_err=vs_cpu, vs_cpu_images=cpu_images,
                       vs_cpu_tol=DET_CPU_TOL, vs_cpu_maps_tol=DET_CPU_MAPS_TOL)
            del want
        emit(phase, **out)
        if params != weights.meta["num_params"]:
            raise RuntimeError(f"{phase}: {params} parameters, not torchvision's")
        if expected_sizes is not None and batch.image_sizes != expected_sizes:
            raise RuntimeError(f"image sizes {batch.image_sizes}, expected "
                               f"{expected_sizes}")
        if shapes != [[n, candidates, 4]]:
            raise RuntimeError(f"{phase}: NMS over {shapes}, expected "
                               f"[{n}, {candidates}, 4]")
        require_launched(launches, ("nms",), phase)
        check_detections(Detections(*(t[:k] for t in dets)), ref, batch=k,
                         phase=phase, per_image=per_image,
                         score_tol=AMP_SCORE_TOL if bf16 else 1e-4,
                         box_tol=AMP_BOX_TOL if bf16 else 1e-2)
        check_mapped_boxes(boxes, raw, per_image=per_image)
        if bf16:
            if dets.boxes.dtype != torch.float32 or dets.scores.dtype != torch.float32:
                raise RuntimeError(f"{phase}: boxes or scores not f32")
            if top5_err > 0.05:
                raise RuntimeError(f"{phase}: the top 5 scores are not within "
                                   "0.05 of the f32 request's")
            if not amp_ok:
                raise RuntimeError(f"{phase}: maps or head outputs too far "
                                   f"from the f32 request's: {vs_f32}")
        else:
            if cpu_images and (vs_cpu[0] > DET_CPU_MAPS_TOL
                               or max(vs_cpu[1:]) > DET_CPU_TOL):
                raise RuntimeError(f"{phase}: maps or head outputs too far "
                                   f"from the CPU's: {vs_cpu}")
            calls32 = calls
            s32 = dets.scores.flatten().sort().values[-5:]
            inner32 = inner
            if phases[0] == "retinanet_images":
                with torch.inference_mode():
                    topk_line(torch.sigmoid(inner[1][0].float()))
        launches_by[tag] = launches
        del dets, ref, inner, batch, canvas
    del inner32, cpu_model
    torch.cuda.empty_cache()
    return calls32, launches_by


def retinanet_serve_phases(kernels, name, phases):
    """RetinaNet ``name`` (``scaled_retinanet``) served from the two raw
    images on the 1344 canvas (``one_stage_serve_phases``): [2, 5,000]
    NMS candidates, 300 rows an image, every image against the plain
    path."""
    from vision_tpu_torch.models.detection import GeneralizedRCNNTransform
    from vision_tpu_torch.tools.detection_request import raw_images

    model = scaled_retinanet(name)
    out = one_stage_serve_phases(
        kernels, name, phases, model, raw_images(), GeneralizedRCNNTransform(),
        RETINA_CANDIDATES, RETINA_DETECTIONS, expected_sizes=RESIZED,
        cls_scale=RETINA_CLS_SCALE)
    del model
    return out


def retinanet_train_hooks(kernels, phase, v2):
    """``prepare`` and ``evaluate`` of a RetinaNet train phase. ``prepare``
    keeps the fresh model's running statistics; ``evaluate`` checks that
    the steps moved every one of a live batch norm's (v2: in the frozen
    stages too) and none of a frozen one's (v1), then runs the trained
    model's detections on the batch's canvas in the step's type through the
    NMS kernel against the plain path, at a score threshold of 0: after
    some steps at the warmup's learning rate no score of this seeded model
    reaches 0.05, and at 0 each image's NMS takes all 5,000 candidates."""
    import torch

    from vision_tpu_torch.ops.misc import BatchNorm2d

    kept = {}

    def live(model):
        return {f"{mn}.{bn}": b for mn, m in model.named_modules()
                for bn, b in m.named_buffers(recurse=False) if "running" in bn
                and isinstance(m, BatchNorm2d) == v2}

    def prepare(model, images):
        kept.update((n, b.clone()) for n, b in live(model).items())

    def evaluate(model, batch, dtype):
        moved = sum(not torch.equal(b, kept[n]) for n, b in live(model).items())
        net = copy.deepcopy(model).to(dtype or torch.float32).eval()
        net.score_thresh = 0.0
        canvas = batch["image"].to(dtype or torch.float32)
        size = tuple(canvas.shape[-2:])
        with torch.inference_mode():
            dets = net.postprocess_detections(*net(canvas), size)
            with kernels.plain_versions():
                ref = net.postprocess_detections(*net(canvas), size)
        amp = dtype is not None
        check_detections(dets, ref, batch=canvas.shape[0],
                         per_image=RETINA_DETECTIONS,
                         phase=f"{phase} (the trained model, score threshold 0)",
                         score_tol=AMP_SCORE_TOL if amp else 1e-4,
                         box_tol=AMP_BOX_TOL if amp else 1e-2)
        want = len(kept) if v2 else 0
        if moved != want:
            raise RuntimeError(f"{phase}: {moved} of {len(kept)} running "
                               f"statistics moved, expected {want}")
        del net
        return {"running_statistics": len(kept), "moved": moved,
                "score_thresh": 0.0,
                "valid_per_image": dets.valid.sum(1).tolist()}

    return prepare, evaluate


def retinanet_phases(kernels):
    """RetinaNet R50-FPN v1 served in f32 and bf16 (``retinanet_images``,
    ``retinanet_images_amp``) and trained in f32 and bf16
    (``retinanet_train``, ``retinanet_train_amp``), v2 served in f32
    (``retinanet_v2_images``) and trained in bf16
    (``retinanet_v2_train_amp``, step 1 against one f32 step of the same
    model); then the bitmask NMS kernel at the f32 request's cross-level
    input against its plain version (row ``nms_retinanet``)."""
    import torch

    from vision_tpu_torch.models.detection import (
        GeneralizedRCNNTransform,
        RetinaNet_ResNet50_FPN_Weights,
    )
    from vision_tpu_torch.tools.detection_request import raw_images, train_batch

    v1, v2 = "retinanet_resnet50_fpn", "retinanet_resnet50_fpn_v2"
    calls, launches_by = retinanet_serve_phases(
        kernels, v1, ("retinanet_images", "retinanet_images_amp"))
    cases = [kernel_case(kernels, "nms", args, "retinanet_images",
                         valid_per_row=args[1].sum(1).tolist())
             for args in calls["nms"]]
    rows = [kernel_row(
        "nms", cases, launches_by["f32"]["nms"], row_name="nms_retinanet",
        path="retinanet_images (1344x1344, batch 2): one NMS an image over "
             "P3-P7's 5,000 candidates, 91 labels apart by offsets")]
    del calls

    def train(phase, name, v2_model, f32_first=None):
        prepare, evaluate = retinanet_train_hooks(kernels, phase, v2_model)
        return det_train_phase(kernels, phase, name=name, grads=RETINA_GRADS,
                               f32_first=f32_first, prepare=prepare,
                               evaluate=evaluate)[2]

    first = train("retinanet_train", v1, False)
    train("retinanet_train_amp", v1, False, first)
    retinanet_serve_phases(kernels, v2, ("retinanet_v2_images",))
    with torch.no_grad():
        batch = train_batch(RetinaNet_ResNet50_FPN_Weights.COCO_V1.transforms(),
                            GeneralizedRCNNTransform(), raw_images())
    first = det_train_steps(batch, 1, name=v2, grads=RETINA_GRADS)["losses"][0]
    del batch
    torch.cuda.empty_cache()
    train("retinanet_v2_train_amp", v2, True, first)
    return rows


# The last five detectors of the JAX package (fcos_resnet50_fpn, the
# MobileNetV3-Large FPN Faster R-CNNs, ssd300_vgg16,
# ssdlite320_mobilenet_v3_large). FCOS: at the seeded init the
# classification bias's prior (0.01) and a centre-ness near 0.5 give scores
# sqrt(0.01 * 0.5) ~ 0.07, under the 0.2 threshold; cls_logits' weight
# scaled by FCOS_CLS_SCALE spreads the logits so that some pass. Each image
# sends P3-P7's top 1,000 (location, class) candidates to one NMS: [2,
# 5,000] boxes. SSD and SSDlite: a softmax over 91 classes at the seeded
# init gives each class ~0.011, just above SSD's 0.01 threshold (SSDlite's
# is 0.001), so every candidate would be valid; in SSD's padding, where
# the bias-free VGG's maps are 0, every class stays at 1/91. The
# classification predictors' weights scaled spread the scores, and SSD's
# background bias raised by SSD_BACKGROUND (to 1/(e^3 + 90) = 0.009 a
# class in the padding) favours the background as a trained model's does:
# on the CPU on the two request images some 15,000 of SSD's 36,000
# candidates were valid; at SSDlite's 0.001 all 27,000 stay valid at any
# scale up to x128 (21,000-27,000 at x256). Their requests
# are 32 raw images (detection_request's two sizes, 16 of each) on their
# fixed canvases, and each image sends the top 400 (SSDlite 300) boxes of
# each of 90 classes to one NMS: [32, 36,000] and [32, 27,000] boxes.
FCOS_CLS_SCALE = 8.0
FCOS_CANDIDATES = 5000
SSD_CLS_SCALE = 8.0
SSD_BACKGROUND = 3.0
# torchvision's init zeroes the VGG's biases, so on the canvas's zero
# padding conv4_3's map is exactly 0 on the CPU and the round-off of the
# card's convolution algorithms elsewhere, which SSD's L2 normalisation
# divides by sqrt(sum x^2 + 1e-12): on an H100 the normalised map read
# 0.98 of its largest value away from the CPU's there (every layer
# before it within 3.5e-6). Seeded N(0, SSD_BIAS_STD^2) biases in the
# backbone keep the padding's maps away from 0, as a trained VGG's do.
SSD_BIAS_STD = 0.01
SSDLITE_CLS_SCALE = 32.0
SSD_CANDIDATES = 36_000
SSDLITE_CANDIDATES = 27_000
ONE_STAGE_SERVE_BATCH = 32
# the torchvision recipes' global batches on one card: 8 x 4 and 8 x 24
# (references/detection/README.md)
SSD_TRAIN_BATCH = 32
SSDLITE_TRAIN_BATCH = 192
# the plain NMS builds an N x N IoU matrix (5.2 GB an image at 36,000,
# its intermediates some 35 GB): the SSDs' kernel keep masks and
# detections are held against it on this many images of the request
PLAIN_NMS_IMAGES = 1
# f32 maps and head outputs (RPN outputs for the R-CNNs) on the card
# against the same model on the CPU, of each tensor's largest value, on
# this many images (TF32 off on the card)
DET_CPU_IMAGES = 1
DET_CPU_TOL = 1e-4
# the feature maps' own gate: SSD's conv4_3 map is L2-normalised over the
# channels at each location, which multiplies the convolutions' round-off
# (~3e-6 of the largest value, every layer before it on an H100) where a
# location's norm is small: 1.8e-4 of the map's largest value on an H100
# 80GB HBM3 (700 W), the head outputs on it 3.8e-5 and 5.2e-5
DET_CPU_MAPS_TOL = 1e-3
# step 1 of a one-stage train step held against the CPU (``step_check``):
# on the first two images of the request, FCOS's at a 512 canvas
ONE_STAGE_CPU_IMAGES = 2
FCOS_CPU_TRANSFORM = dict(min_size=384, max_size=512)
# the MobileNet Faster R-CNN's trained gradients held against the plain
# twin's: the box head's first layer, the RPN head's conv, an FPN lateral
# conv and the trunk's last convolution (trainable at 3 stages)
MOBILE_RCNN_GRADS = ("roi_heads.box_head.fc6.weight", "rpn.head.conv.0.0.weight",
                     "backbone.fpn.inner_blocks.1.0.weight",
                     "backbone.body.16.0.weight")


def scaled_one_stage(name, scale, background=0.0):
    """One-stage detector ``name`` with seeded weights, its classification
    predictors' weights scaled by ``scale`` and, in an SSD's, the
    background class's bias raised by ``background``; SSD300's backbone
    biases drawn N(0, ``SSD_BIAS_STD``^2) from a CPU generator of seed 1;
    SSDlite's batch norms scaled on 8 seeded images at its canvas
    (``detection_request.scale_norms``), as a trained model's keep its
    activations of order 1."""
    import torch

    from vision_tpu_torch.models import get_model
    from vision_tpu_torch.tools import zoo
    from vision_tpu_torch.tools.detection_request import scale_norms, transform_for

    model = get_model(name, seed=0)
    head = model.head.classification_head
    preds = ([head.cls_logits] if hasattr(head, "cls_logits") else
             [m if isinstance(m, torch.nn.Conv2d) else m[-1]
              for m in head.module_list])
    with torch.no_grad():
        for m in preds:
            m.weight.mul_(scale)
            if background:  # channel a * K + 0: anchor a's background
                m.bias[::model.num_classes] += background
        if name == "ssd300_vgg16":
            gen = torch.Generator().manual_seed(1)
            for m in model.backbone.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.bias.copy_(torch.randn(m.bias.shape, generator=gen)
                                 * SSD_BIAS_STD)
    if name.startswith("ssdlite"):
        with torch.inference_mode():
            scale_norms(model, zoo.images(zoo.CALIBRATION_BATCH,
                                          transform_for(name).fixed_size[0], 100))
    return model


def nms_case(kernels, args, path, images=None):
    """The bitmask NMS kernel at a recorded call against its plain version
    (``kernel_case``), with each row's valid count. With ``images`` only
    the first ``images`` rows' keep masks are held against the plain
    version, whose N x N matrix does not fit a whole request of 36,000
    candidates an image; its ``plain_ms`` is of those rows, beside the
    kernel's own time on them (``ms_on_plain_rows``); ``ms``,
    ``device_ms`` and the bound are of the whole call."""
    import torch

    valid = args[1].sum(1).tolist()
    if images is None:
        return kernel_case(kernels, "nms", args, path, valid_per_row=valid)
    fn, plain = kernels.cuda["nms"], kernels.plain["nms"]
    boxes, ok, thr = args
    rows = (boxes[:images], ok[:images], thr)
    got = fn(*args)[:images]
    want = plain(*rows)
    torch.cuda.synchronize()
    err = float((got.int() - want.int()).abs().max())
    del got, want
    nbytes, ops, peak = nms_work(args)
    b_ms, b_by = bound_ms(nbytes, ops, peak)
    case = dict(kernel="nms", path=path, dtype="float32",
                shape=[list(boxes.shape), list(ok.shape)], valid_per_row=valid,
                plain_rows=images, max_abs_err=err, max_rel_err=err, tol=0.0,
                ms=cuda_ms(lambda: fn(*args)),
                device_ms=device_ms(lambda: fn(*args)),
                plain_ms=cuda_ms(lambda: plain(*rows), reps=2, warmup=0),
                ms_on_plain_rows=cuda_ms(lambda: fn(*rows)),
                bound_ms=b_ms, bound_by=b_by,
                bytes_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                operations_bound_ms=ops / peak * 1e3)
    emit("kernel_case", **case)
    if err > 0:
        raise RuntimeError(f"nms ({path}): the keep mask of the first "
                           f"{images} rows differs from the plain version's")
    return case


def one_stage_train_phases(kernels, name, phases, batch_size, scale,
                           background=0.0, cpu_transform=None):
    """One-stage detector ``name`` (``scaled_one_stage``) trained by the
    detection recipe's SGD (``recipe_optimizer``) through
    ``make_detection_train_step(one_stage=True)`` on ``batch_size`` raw
    images (``detection_request``'s two sizes in turn) at its transform,
    with seeded gt boxes: step 1 on the first ``ONE_STAGE_CPU_IMAGES``
    images (through ``cpu_transform`` where given) held against the CPU on
    the card's ReLU sides (``step_check``); then in f32 (``phases[0]``) and
    bf16 (``phases[1]``, the amp step) from the same weights, step 1 and
    ``ZOO_STEPS`` timed steps: ms a step, images/s, peak GB; the amp step
    1 loss within ``ZOO_AMP_LOSS_TOL`` of the f32 one. No kernel of the
    repo's runs in these steps (NMS serves only): the launches are printed
    and must read 0."""
    import torch

    from vision_tpu_torch.models import get_model_weights
    from vision_tpu_torch.models.detection import GeneralizedRCNNTransform
    from vision_tpu_torch.parallel import make_detection_train_step
    from vision_tpu_torch.tools.detection_request import (
        IMAGE_SIZES,
        raw_images,
        recipe_optimizer,
        train_batch,
        transform_for,
    )

    preset = get_model_weights(name).COCO_V1.transforms()
    raw = raw_images(IMAGE_SIZES * (batch_size // len(IMAGE_SIZES)))
    with torch.no_grad():
        small = train_batch(
            preset, GeneralizedRCNNTransform(**cpu_transform, device="cpu")
            if cpu_transform else transform_for(name, "cpu"),
            raw[:ONE_STAGE_CPU_IMAGES])
        batch = train_batch(preset, transform_for(name), raw)

    def lr0_step(model):
        params = [p for p in model.parameters() if p.requires_grad]
        return make_detection_train_step(model, torch.optim.SGD(params, lr=0.0),
                                         one_stage=True)

    check = step_check(lambda: scaled_one_stage(name, scale, background),
                       lr0_step,
                       lambda dev: {k: v.to(dev) for k, v in small.items()})
    device = torch.cuda.get_device_name(0)
    f32_loss = None
    kernels.reset()
    for phase, dtype in zip(phases, (None, torch.bfloat16)):
        model = scaled_one_stage(name, scale, background)
        optimizer, scheduler = recipe_optimizer(model)
        step = make_detection_train_step(model, optimizer, compute_dtype=dtype,
                                         one_stage=True)
        torch.cuda.reset_peak_memory_stats()

        def call():
            out = step(batch)
            scheduler.step()
            return out["loss"]

        loss1, times, losses = timed_steps(call)
        ms = statistics.median(times)
        fields = dict(model=name, device=device,
                      dtype="float32" if dtype is None else "bfloat16",
                      batch=batch_size, input=list(batch["image"].shape),
                      ms_per_step=ms, images_per_s=batch_size / ms * 1e3,
                      ms_all=times, step1_loss=loss1, losses=losses,
                      peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                      cls_scale=scale, background_bias=background)
        ok = all(math.isfinite(v) for v in [loss1] + losses) and losses[-1] != loss1
        if dtype is None:
            fields.update(check, cpu_images=ONE_STAGE_CPU_IMAGES,
                          cpu_input=list(small["image"].shape))
            ok = ok and check["ok"]
            f32_loss = loss1
        else:
            err = abs(loss1 - f32_loss) / abs(f32_loss)
            fields.update(loss_vs_f32_rel_err=err, loss_tol=ZOO_AMP_LOSS_TOL)
            ok = ok and err <= ZOO_AMP_LOSS_TOL
        emit(phase, **fields)
        if not ok:
            raise RuntimeError(f"{phase}: step 1 off its reference, a loss not "
                               "finite, or no update")
        del model, step, optimizer
        torch.cuda.empty_cache()
    launches = kernels.launches()
    emit(f"{phases[0]}_launches", launches=launches)
    if any(launches.values()):
        raise RuntimeError(f"{phases[0]}: a kernel launched in a one-stage "
                           f"train step: {launches}")


def count_window_overflow(model, canvas):
    """(RoIs whose bilinear corners leave the pooler's window, RoIs) of one
    forward of an R-CNN on ``canvas``: the flags of
    ``ops/poolers.py:_local_weights``, its two calls a pooling (rows, then
    columns), counted by wrapping it for that forward."""
    import torch

    poolers = importlib.import_module("vision_tpu_torch.ops.poolers")
    plain, flags = poolers._local_weights, []

    def record(*args):
        out = plain(*args)
        flags.append(out[1])
        return out

    poolers._local_weights = record
    try:
        with torch.inference_mode():
            model(canvas)
    finally:
        poolers._local_weights = plain
    over = [fy | fx for fy, fx in zip(flags[0::2], flags[1::2])]
    return int(sum(int(o.sum()) for o in over)), sum(o.numel() for o in over)


def mobile_rcnn_serve_phases(kernels, name, phases, transform):
    """A MobileNet Faster R-CNN (``scaled_detector``, its frozen batch
    norms set from the request's canvas: ``scale_norms``) served
    from the two raw images through ``transform`` (``serve_phase``), in
    f32 and, where
    ``phases`` names a second, in bf16: ms a batch, images/s and peak GB;
    the detections against the same request through the plain versions;
    the f32 FPN maps and RPN outputs of ``DET_CPU_IMAGES`` against the CPU;
    bf16's top 5 scores within 0.05 and its maps and RPN outputs within
    ``AMP_VS_F32_TOL`` of the f32 request's (``bf16_gate``: or within twice
    the CPU's own bf16 distance); the pooler's window overflow
    counted. Returns the f32 request's recorded calls, launches and the
    overflow count."""
    import torch

    from vision_tpu_torch.models import get_model_weights
    from vision_tpu_torch.tools import zoo
    from vision_tpu_torch.tools.detection_request import (
        SEED,
        scale_norms,
        raw_images,
    )

    raw = raw_images()
    preset = get_model_weights(name).COCO_V1.transforms()
    model = scaled_detector(name)
    with torch.inference_mode():
        scale_norms(model, transform([preset(r) for r in raw]).tensors)
    params = sum(p.numel() for p in model.parameters())
    out32 = None
    for dtype, phase in zip((torch.float32, torch.bfloat16), phases):
        bf16 = dtype == torch.bfloat16
        tag = "bf16" if bf16 else "f32"
        if bf16:
            zoo.to_bf16(model)
        calls: dict = {}
        torch.cuda.reset_peak_memory_stats()
        (batch, dets, boxes), (_, ref, _), times, launches, inner = serve_phase(
            kernels, model, preset, transform, raw, dtype, calls)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        canvas = batch.tensors.to(dtype)
        ms = statistics.median(times) * len(raw)
        fields = dict(model=name, params=params, dtype=str(dtype)[6:],
                      seed=SEED, canvas=list(transform.fixed_size),
                      batch=len(raw), image_sizes=batch.image_sizes,
                      ms_per_batch_median=ms, ms_per_img_median=ms / len(raw),
                      images_per_s=len(raw) / ms * 1e3, peak_memory_gb=peak_gb,
                      requests=TIMED_FORWARDS, launches=launches,
                      valid_per_image=dets.valid.sum(1).tolist(),
                      cls_scale=CLS_SCALE)
        if bf16:
            s16 = dets.scores.flatten().sort().values[-5:]
            top5_err = float((s16 - s32).abs().max())
            amp_ok, vs_f32, gate = bf16_gate(inner, inner32, cpu_model,
                                             rpn_internals, canvas,
                                             DET_CPU_IMAGES)
            fields.update(top5_scores_f32=s32.tolist(),
                          top5_scores_bf16=s16.tolist(), top5_max_err=top5_err,
                          rel_err_vs_f32=vs_f32,
                          rel_err_vs_f32_tol=AMP_VS_F32_TOL, **gate)
        else:
            cpu_model = copy.deepcopy(model).cpu()
            with torch.inference_mode():
                want = rpn_internals(cpu_model, canvas[:DET_CPU_IMAGES].cpu())
            vs_cpu = [max(rel_errs([g[:DET_CPU_IMAGES].cpu() for g in got], w))
                      for got, w in zip(inner, want)]
            overflow, rois = count_window_overflow(model, canvas)
            fields.update(vs_cpu_rel_err=vs_cpu, vs_cpu_images=DET_CPU_IMAGES,
                          vs_cpu_tol=DET_CPU_TOL,
                          vs_cpu_maps_tol=DET_CPU_MAPS_TOL,
                          window_overflow_rois=overflow,
                          pooled_rois=rois)
            del want
        emit(phase, **fields)
        if params != get_model_weights(name).COCO_V1.meta["num_params"]:
            raise RuntimeError(f"{phase}: {params} parameters, not torchvision's")
        require_launched(launches, ("nms", f"window_pool_{tag}",
                                    f"roi_align_{tag}"), phase)
        check_detections(dets, ref, batch=len(raw), phase=phase,
                         score_tol=AMP_SCORE_TOL if bf16 else 1e-4,
                         box_tol=AMP_BOX_TOL if bf16 else 1e-2)
        check_mapped_boxes(boxes, raw)
        if bf16:
            if top5_err > 0.05 or not amp_ok:
                raise RuntimeError(f"{phase}: top 5 scores or maps too far from "
                                   f"the f32 request's: {top5_err}, {vs_f32}")
        else:
            if vs_cpu[0] > DET_CPU_MAPS_TOL or max(vs_cpu[1:]) > DET_CPU_TOL:
                raise RuntimeError(f"{phase}: maps or RPN outputs too far from "
                                   f"the CPU's: {vs_cpu}")
            out32 = (calls, launches, overflow, rois)
            s32 = dets.scores.flatten().sort().values[-5:]
            inner32 = inner
        del dets, ref, inner, batch, canvas
    del model, cpu_model
    torch.cuda.empty_cache()
    return out32


def detection_zoo_phases(kernels):
    """The last five detectors, each at full width with seeded weights:
    FCOS ResNet-50-FPN (``fcos_images``, ``_amp``: two raw images on the
    1344 canvas; ``fcos_train``, ``_amp``: batch 2), the MobileNetV3-Large
    FPN Faster R-CNN (``frcnn_mobilenet_images``, ``_amp`` on the 1344
    canvas; ``frcnn_mobilenet_train``, ``_amp``: batch 2 through
    ``det_train_phase``, the pooler kernels and their backwards), its 320
    variant served on the 640 canvas in f32 (``frcnn_mobilenet_320_images``),
    SSD300-VGG16 (``ssd_images``, ``_amp``: 32 raw images; ``ssd_train``,
    ``_amp``: batch 32) and SSDlite320 (``ssdlite_images``, ``_amp``: 32
    raw images; ``ssdlite_train``, ``_amp``: batch 192). Rows
    ``nms_fcos``, ``nms_ssd``, ``nms_ssdlite`` (the bitmask NMS kernel at
    each f32 request's input, the SSDs' held against the plain version on
    ``PLAIN_NMS_IMAGES`` image) and ``window_pool_mobilenet`` (the window
    pool over the MobileNet FPN's two levels, both at stride 32, with the
    RoIs that overflow its window)."""
    import torch

    from vision_tpu_torch.models.detection import GeneralizedRCNNTransform
    from vision_tpu_torch.tools.detection_request import (
        IMAGE_SIZES,
        scale_norms,
        raw_images,
        transform_for,
    )

    rows = []
    fcos = "fcos_resnet50_fpn"
    calls, launches = one_stage_serve_phases(
        kernels, fcos, ("fcos_images", "fcos_images_amp"),
        scaled_one_stage(fcos, FCOS_CLS_SCALE), raw_images(),
        GeneralizedRCNNTransform(), FCOS_CANDIDATES, 100,
        cpu_images=DET_CPU_IMAGES, expected_sizes=RESIZED,
        cls_scale=FCOS_CLS_SCALE)
    cases = [nms_case(kernels, a, "fcos_images") for a in calls["nms"]]
    rows.append(kernel_row(
        "nms", cases, launches["f32"]["nms"], row_name="nms_fcos",
        valid_per_row=cases[0]["valid_per_row"],
        path="fcos_images (1344x1344, batch 2): one NMS an image over "
             "P3-P7's 5,000 candidates at 0.6, 91 labels apart by offsets"))
    del calls
    torch.cuda.empty_cache()
    one_stage_train_phases(kernels, fcos, ("fcos_train", "fcos_train_amp"), 2,
                           FCOS_CLS_SCALE, cpu_transform=FCOS_CPU_TRANSFORM)

    mobile = "fasterrcnn_mobilenet_v3_large_fpn"
    calls, launches, overflow, rois = mobile_rcnn_serve_phases(
        kernels, mobile, ("frcnn_mobilenet_images", "frcnn_mobilenet_images_amp"),
        GeneralizedRCNNTransform())
    rows.append(kernel_row(
        "window_pool", [kernel_case(kernels, "window_pool", a,
                                    "frcnn_mobilenet_images")
                        for a in calls["window_pool"]],
        launches["window_pool_f32"], row_name="window_pool_mobilenet",
        path="frcnn_mobilenet_images (1344x1344, batch 2): levels '0' and "
             "'1', both 42x42 (stride 32), 256 channels",
        window_overflow_rois=overflow, pooled_rois=rois))
    del calls
    first = det_train_phase(kernels, "frcnn_mobilenet_train", name=mobile,
                            grads=MOBILE_RCNN_GRADS,
                            prepare=scale_norms)[2]
    det_train_phase(kernels, "frcnn_mobilenet_train_amp", name=mobile,
                    grads=MOBILE_RCNN_GRADS, f32_first=first,
                    prepare=scale_norms)
    mobile_rcnn_serve_phases(
        kernels, "fasterrcnn_mobilenet_v3_large_320_fpn",
        ("frcnn_mobilenet_320_images",),
        transform_for("fasterrcnn_mobilenet_v3_large_320_fpn"))

    many = raw_images(IMAGE_SIZES * (ONE_STAGE_SERVE_BATCH // len(IMAGE_SIZES)))
    for name, tag, scale, background, candidates, per_image, train_size in (
            ("ssd300_vgg16", "ssd", SSD_CLS_SCALE, SSD_BACKGROUND,
             SSD_CANDIDATES, 200, SSD_TRAIN_BATCH),
            ("ssdlite320_mobilenet_v3_large", "ssdlite", SSDLITE_CLS_SCALE, 0.0,
             SSDLITE_CANDIDATES, 300, SSDLITE_TRAIN_BATCH)):
        calls, launches = one_stage_serve_phases(
            kernels, name, (f"{tag}_images", f"{tag}_images_amp"),
            scaled_one_stage(name, scale, background), many,
            transform_for(name), candidates, per_image,
            plain_images=PLAIN_NMS_IMAGES, cpu_images=DET_CPU_IMAGES,
            cls_scale=scale, background_bias=background)
        cases = [nms_case(kernels, a, f"{tag}_images", PLAIN_NMS_IMAGES)
                 for a in calls["nms"]]
        rows.append(kernel_row(
            "nms", cases, launches["f32"]["nms"], row_name=f"nms_{tag}",
            valid_per_row=cases[0]["valid_per_row"],
            plain_rows=PLAIN_NMS_IMAGES,
            ms_on_plain_rows=cases[0]["ms_on_plain_rows"],
            path=f"{tag}_images ({transform_for(name).fixed_size[0]} canvas, "
                 f"batch {ONE_STAGE_SERVE_BATCH}): one NMS an image over "
                 f"{candidates:,} candidates (top {candidates // 90} of each "
                 "of 90 classes)"))
        del calls
        torch.cuda.empty_cache()
        one_stage_train_phases(kernels, name, (f"{tag}_train", f"{tag}_train_amp"),
                               train_size, scale, background)
    return rows


VIT_PARAMS = 86_567_656
VIT_CPU_BATCH = 4  # the images held against the CPU
VIT_LOGITS_TOL = 1e-4  # f32 logits on the card against the CPU's, of the largest
VIT_AMP_LOGITS_TOL = 2e-2  # bf16 logits against f32, of the largest
VIT_TIMED = 5  # timed batches or steps after a warm-up, the median kept
VIT_LOSS_TOL = 1e-4  # step 1 on the card against the CPU, relative
VIT_GRAD_TOL = 1e-3  # a gradient against the CPU's, of its largest value
VIT_AMP_LOSS_TOL = 5e-2  # amp step 1's loss against the f32 step's
VIT_NORM_TOL = 1e-6  # normalise and mix stages against the CPU, absolute
VIT_FREQ_BATCHES = 32  # batches of draws for the frequency checks
VIT_CHOICE_DRAWS = 400  # MixUp / CutMix picks for the frequency check
VIT_GRADS = ("conv_proj.weight", "class_token", "encoder.pos_embedding",
             "encoder.layers.encoder_layer_0.self_attention.in_proj_weight",
             "encoder.layers.encoder_layer_11.mlp.3.weight",
             "encoder.ln.weight", "heads.head.weight")
# RandAugment ops whose uint8 result is integer arithmetic; the others
# (bilinear geometry, blends) may round one count apart
VIT_EXACT_OPS = ("Identity", "Posterize", "Solarize", "AutoContrast",
                 "Equalize")


def host_ms(fn, reps: int = VIT_TIMED) -> tuple:
    """(median ms, all ms) of ``fn()`` followed by a synchronisation, over
    ``reps`` calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), times


def binomial_ok(count: int, n: int, p: float) -> bool:
    return abs(count - n * p) <= 4.0 * math.sqrt(n * p * (1.0 - p))


def vit_forward_phases() -> None:
    """``vit_b16_forward`` / ``_amp``: ViT-B/16 at batch 64 of 224x224, f32
    and bf16 (``bench.py:1124-1135``'s cell): ms a batch, img/s; the f32
    logits of 4 images against the same model on the CPU, the bf16 logits
    against the f32 ones."""
    import torch

    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.tools.vit_train import SERVE_BATCH, seeded_vit

    model = seeded_vit()
    cpu_model = seeded_vit(device="cpu")
    params = sum(p.numel() for p in model.parameters())
    x = torch.randn(SERVE_BATCH, 3, 224, 224,
                    generator=torch.Generator().manual_seed(0))
    x_card = x.to(resolve_device(None))
    with torch.inference_mode():
        logits = model(x_card)
        want = cpu_model(x[:VIT_CPU_BATCH])
        err = float((logits[:VIT_CPU_BATCH].cpu() - want).abs().max()
                    / want.abs().max())
        ms, ms_all = host_ms(lambda: model(x_card))
        emit("vit_b16_forward", model="vit_b_16", params=params,
             dtype="float32", batch=SERVE_BATCH, ms_per_batch=ms,
             images_per_s=SERVE_BATCH / ms * 1e3, ms_all=ms_all,
             logits_vs_cpu_rel_err=err, tol=VIT_LOGITS_TOL,
             logits_std=float(logits.std()))
        if params != VIT_PARAMS or not err <= VIT_LOGITS_TOL or not bool(
                torch.isfinite(logits).all()):
            raise RuntimeError("vit_b16_forward: wrong parameter count, or the "
                               "logits are off the CPU's or not finite")
        model16 = model.to(torch.bfloat16)
        x16 = x_card.to(torch.bfloat16)
        l16 = model16(x16).float()
        err16 = float((l16 - logits).abs().max() / logits.abs().max())
        ms, ms_all = host_ms(lambda: model16(x16))
        emit("vit_b16_forward_amp", model="vit_b_16", dtype="bfloat16",
             batch=SERVE_BATCH, ms_per_batch=ms,
             images_per_s=SERVE_BATCH / ms * 1e3, ms_all=ms_all,
             logits_vs_f32_rel_err=err16, tol=VIT_AMP_LOGITS_TOL)
        if not err16 <= VIT_AMP_LOGITS_TOL:
            raise RuntimeError("vit_b16_forward_amp: bf16 logits off the f32 ones")


def vit_augment_check(aug, raw, gen, phase) -> dict:
    """One batch through ``aug`` on the card, stage by stage, each stage
    applied again on the CPU to the card's input of that stage with the
    card's draws moved there: the crop within 1 count; each RandAugment
    slot equal where its op is integer arithmetic, else within 1 count;
    normalise (and erasing) and the mix within ``VIT_NORM_TOL``."""
    import torch

    from vision_tpu_torch.transforms import v2 as T

    draws = aug.draw(raw["image"].shape, gen)
    cpu = T.to_device(draws, "cpu")
    crop = aug.crop.apply(raw["image"], draws["crop"])
    crop_err = int((aug.crop.apply(raw["image"].cpu(), cpu["crop"]).int()
                    - crop.cpu().int()).abs().max())
    ra = aug.auto_augment
    names = list(ra.magnitudes(crop.shape[-2:]))
    exact = torch.tensor([n in VIT_EXACT_OPS for n in names])
    x, ra_err = crop, {"exact": 0, "rounded": 0}
    for s in range(ra.num_ops):
        one = T.RandAugment(num_ops=1, magnitude=ra.magnitude,
                            interpolation=ra.interpolation)
        slot = {k: v[:, s:s + 1] for k, v in draws["auto_augment"].items()}
        y = one.apply(x, slot)
        y_cpu = one.apply(x.cpu(), T.to_device(slot, "cpu"))
        diff = (y.cpu().int() - y_cpu.int()).abs().amax((1, 2, 3))
        is_exact = exact[cpu["auto_augment"]["op"][:, s]]
        for key, pick in (("exact", is_exact), ("rounded", ~is_exact)):
            if pick.any():
                ra_err[key] = max(ra_err[key], int(diff[pick].max()))
        x = y
    whole = ra.apply(crop, draws["auto_augment"])
    post = aug.post.apply(x, draws["post"])
    post_err = float((aug.post.apply(x.cpu(), cpu["post"]) - post.cpu()).abs().max())
    mixed = aug.mix.apply((post, raw["label"]), draws["mix"])
    mixed_cpu = aug.mix.apply((post.cpu(), raw["label"].cpu()), cpu["mix"])
    mix_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(mixed, mixed_cpu))
    out = aug.apply(raw, draws)
    out_err = max(float((a - b).abs().max()) for a, b in zip(
        (out["image"], out["label"]), mixed))
    result = {"crop_max_abs_err": crop_err,
              "randaugment_exact_ops_max_abs_err": ra_err["exact"],
              "randaugment_rounded_ops_max_abs_err": ra_err["rounded"],
              "randaugment_slots_equal_whole": bool(torch.equal(whole, x)),
              "normalize_max_abs_err": post_err, "mix_max_abs_err": mix_err,
              "pipeline_vs_stages_max_abs_err": out_err,
              "mix_choice": int(draws["mix"]["choice"]),
              "tol": {"crop": 1, "exact_ops": 0, "rounded_ops": 1,
                      "normalize_mix": VIT_NORM_TOL}}
    if (crop_err > 1 or ra_err["exact"] or ra_err["rounded"] > 1
            or not result["randaugment_slots_equal_whole"]
            or not post_err <= VIT_NORM_TOL or not mix_err <= VIT_NORM_TOL
            or not out_err <= VIT_NORM_TOL
            or not bool(torch.isfinite(out["image"]).all())):
        raise RuntimeError(f"{phase}: the card's augmentation is off the CPU's: "
                           f"{result}")
    return result


def vit_augment_phase() -> None:
    """``vit_b16_augment``: the recipe's pipeline alone on 128 seeded uint8
    256x256 frames (``bench.py:474-476``): img/s, the device ms of each
    stage; one batch held against the CPU (``vit_augment_check``), one more
    at ``random_erase=0.1`` (``bench.py:409``); the draws' frequencies over
    ``VIT_FREQ_BATCHES`` batches (ops uniform over the 14, the flips, MixUp
    against CutMix over ``VIT_CHOICE_DRAWS`` picks), each within a 4-sigma
    binomial bound; the stages' device ms each one call queued behind a
    spin kernel (``profile_vit_train.queued_ms``), the median of three."""
    import torch

    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.tools.profile_vit_train import queued_ms
    from vision_tpu_torch.tools.vit_train import frames, recipe_augment

    card = resolve_device(None)
    raw = frames()
    gen = torch.Generator(device=card).manual_seed(0)
    aug = recipe_augment()
    ms, ms_all = host_ms(lambda: aug(raw, gen))
    n = raw["image"].shape[0]
    draws = aug.draw(raw["image"].shape, gen)
    crop = aug.crop.apply(raw["image"], draws["crop"])
    ra = aug.auto_augment.apply(crop, draws["auto_augment"])
    post = aug.post.apply(ra, draws["post"])
    stages = {
        "crop_flip": lambda: aug.crop.apply(raw["image"], draws["crop"]),
        "randaugment": lambda: aug.auto_augment.apply(crop, draws["auto_augment"]),
        "normalize": lambda: aug.post.apply(ra, draws["post"]),
        "mixup_cutmix": lambda: aug.mix.apply((post, raw["label"]), draws["mix"]),
    }
    stages = {k: statistics.median(queued_ms(fn)[0] for _ in range(3))
              for k, fn in stages.items()}
    check = vit_augment_check(aug, raw, gen, "vit_b16_augment")
    erase = recipe_augment(random_erase=0.1)
    erase_check = vit_augment_check(erase, raw, gen, "vit_b16_augment")

    ops = torch.zeros(14, dtype=torch.int64, device=card)
    flips = torch.zeros((), dtype=torch.int64, device=card)
    for _ in range(VIT_FREQ_BATCHES):
        d = aug.draw(raw["image"].shape, gen)
        ops += torch.bincount(d["auto_augment"]["op"].flatten(), minlength=14)
        flips += d["crop"]["flip"].sum()
    picks = sum(int(aug.mix.draw((n, 3, 224, 224), gen)["choice"])
                for _ in range(VIT_CHOICE_DRAWS))
    ops = ops.tolist()
    op_draws = VIT_FREQ_BATCHES * n * aug.auto_augment.num_ops
    flip_draws = VIT_FREQ_BATCHES * n
    freq = {"op_counts": ops, "op_draws": op_draws, "flips": int(flips),
            "flip_draws": flip_draws, "cutmix_picks": picks,
            "mix_draws": VIT_CHOICE_DRAWS}
    emit("vit_b16_augment", batch=n, frame=list(raw["image"].shape[1:]),
         crop=224, images_per_s=n / ms * 1e3, ms_per_batch=ms, ms_all=ms_all,
         stages_device_ms=stages, check=check, random_erase_0_1=erase_check,
         frequencies=freq)
    if not (all(binomial_ok(c, op_draws, 1 / 14) for c in ops)
            and binomial_ok(int(flips), flip_draws, 0.5)
            and binomial_ok(picks, VIT_CHOICE_DRAWS, 0.5)):
        raise RuntimeError(f"vit_b16_augment: draw frequencies off: {freq}")


def vit_step_check(model, batch, compute_dtype, crop_size):
    """One recipe step (clipping, AdamW) at batch ``VIT_CPU_BATCH`` from
    ``model``'s weights on a copy of it: loss, the gradient norm and every
    parameter's (clipped) gradient, on the card and, in f32, on the CPU."""
    import torch

    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.tools.vit_train import RecipeStep

    out = {}
    for device in ("card", "cpu"):
        if device == "cpu" and compute_dtype is not None:
            break
        dev = resolve_device(None if device == "card" else device)
        twin = copy.deepcopy(model).to(dev)
        run = RecipeStep(twin, compute_dtype, crop_size=crop_size)
        small = {k: v[:VIT_CPU_BATCH].to(dev) for k, v in batch.items()}
        metrics = run.train_step(small)
        out[device] = {"loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "grads": {} if compute_dtype is not None else {
                           n: p.grad.float().cpu()
                           for n, p in twin.named_parameters()}}
        del twin, run
    return out


def vit_train_phase(phase: str, compute_dtype, f32_loss=None, size=224,
                    batch_size=128, frame=256,
                    first_step=contextlib.nullcontext) -> float:
    """``vit_b16_train`` (f32) / ``vit_b16_train_amp`` (``--amp``): the
    recipe's step at batch 128 from the seeded frames, augmentation,
    clipping, AdamW, the schedule and the EMA update every step, timed
    (ms/step with the loss read back, img/s, peak GB); step 1 at batch 4 on
    one augmented batch held against the CPU (f32: loss ``VIT_LOSS_TOL``,
    the gradient norm and every parameter's gradient, of its largest
    value, ``VIT_GRAD_TOL``; ``VIT_GRADS`` printed) or against the f32 step
    (amp: loss ``VIT_AMP_LOSS_TOL``). Returns step 1's loss. ``size``,
    ``batch_size`` and ``frame`` give another cell of ViT-B/16 (the model
    at ``size`` px, cropped to it); the first step at ``batch_size`` runs
    inside ``first_step()``."""
    import torch

    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.tools.vit_train import RecipeStep, frames, seeded_vit

    model = seeded_vit(image_size=size)
    raw = frames(batch_size, frame)
    gen = torch.Generator(device=resolve_device(None)).manual_seed(1)
    run = RecipeStep(model, compute_dtype, batch_size=batch_size,
                     crop_size=size)
    with torch.no_grad():
        batch = run.augment(raw, gen)
    first = vit_step_check(model, batch, compute_dtype, size)
    card = first["card"]
    check = {"step1_loss": card["loss"], "step1_grad_norm": card["grad_norm"]}
    ok = math.isfinite(card["loss"]) and card["grad_norm"] > 0
    if compute_dtype is None:
        cpu = first["cpu"]
        # the key bias's gradient is round-off on both sides (every score of
        # a query row moves alike; tests/test_torch_vit.py): left out
        grad_err = {n: float((card["grads"][n] - g).abs().max() / g.abs().max())
                    for n, g in cpu["grads"].items()
                    if not n.endswith("in_proj_bias")}
        worst = max(grad_err, key=grad_err.get)
        check.update(
            loss_vs_cpu_rel_err=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
            grad_norm_vs_cpu_rel_err=abs(card["grad_norm"] - cpu["grad_norm"])
            / cpu["grad_norm"],
            grads_vs_cpu_rel_err={n: grad_err[n] for n in VIT_GRADS},
            grads_vs_cpu_worst=[worst, grad_err[worst]],
            grads_compared=len(grad_err), loss_tol=VIT_LOSS_TOL,
            grad_tol=VIT_GRAD_TOL)
        ok = ok and (check["loss_vs_cpu_rel_err"] <= VIT_LOSS_TOL
                     and check["grad_norm_vs_cpu_rel_err"] <= VIT_GRAD_TOL
                     and grad_err[worst] <= VIT_GRAD_TOL)
    else:
        check.update(loss_vs_f32_rel_err=abs(card["loss"] - f32_loss) / abs(f32_loss),
                     loss_tol=VIT_AMP_LOSS_TOL)
        ok = ok and check["loss_vs_f32_rel_err"] <= VIT_AMP_LOSS_TOL
    del first

    losses = []
    with first_step():
        losses.append(float(run(raw, gen)["loss"]))
    losses.append(float(run(raw, gen)["loss"]))  # warm-up, with the one above
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(VIT_TIMED):
        t = time.perf_counter()
        losses.append(float(run(raw, gen)["loss"]))
        times.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(times)
    n = raw["image"].shape[0]
    emit(phase, model="vit_b_16", image_size=size,
         dtype="float32" if compute_dtype is None else "bfloat16", batch=n,
         ms_per_step=ms, images_per_s=n / ms * 1e3, ms_all=times,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9, losses=losses,
         lr_last=run.optimizer.param_groups[0]["lr"],
         ema_decay=run.ema.decay, **check)
    ok = ok and all(math.isfinite(v) for v in losses)
    if not ok:
        raise RuntimeError(f"{phase}: step 1 off its reference, or a loss not "
                           "finite")
    del model, run
    torch.cuda.empty_cache()
    return card["loss"]


def vit_phases(kernels) -> None:
    """ViT-B/16 (BASELINE config 2), served and trained behind the recipe's
    augmentation. No kernel of the repo's is on this path: the launch
    counts, set to 0 before it, are printed after it."""
    import torch

    kernels.reset()
    vit_forward_phases()
    vit_augment_phase()
    f32_loss = vit_train_phase("vit_b16_train", None)
    vit_train_phase("vit_b16_train_amp", torch.bfloat16, f32_loss)
    emit("vit_b16_launches", launches=kernels.launches())


VIT_L_PARAMS = 305_174_504  # ViT_L_16_Weights.IMAGENET1K_SWAG_E2E_V1
VIT_L_LAYERS = 24
VIT_B_LAYERS = 12
# bf16 logits against f32, of the largest: 24 layers, twice ViT-B/16's depth
# (whose bf16 logits read 1.3e-2 from f32 at 224 px, PR 14)
VIT_L_AMP_LOGITS_TOL = 5e-2
EXP_PER_S = 3.9e12  # H100 SXM: 16 SFU results a clock an SM, 132 SMs, 1.83 GHz
# of the largest plain value: (forward, backward); f32 sums in another
# order and exp2 with log2 e folded into the scale; in bf16, p rounded
# against another running maximum (tests/test_torch_flash_attention_cuda.py)
FLASH_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
FLASH_LSE_TOL = 1e-5  # of max(1, the largest |lse|), absolute


def flash_work(name, q):
    """(bytes, products, exponentials) of one call of flash kernel ``name``
    on ``q``'s shape ``[B, H, S, D]``. Bytes: each input read once, each
    output written once (the forward: q, k, v in, o and lse out; dk/dv: q,
    k, v, do, lse, di in, dk, dv out; dq: the same in, dq out).
    Operations: the products the function needs, 2 S^2 D a head each
    (forward q k^T and p v; dk/dv q k^T, do v^T, p^T do, ds^T q; dq q k^T,
    do v^T, ds k), and one exponential a score."""
    b, h, s, d = q.shape
    rows, e = b * h * s, q.element_size()
    tensors, stats, products = {
        "flash_attention": (4, 1, 2),
        "flash_attention_backward_dkv": (6, 2, 4),
        "flash_attention_backward_dq": (5, 2, 3),
    }[name]
    product = 2.0 * b * h * s * s * d
    return (tensors * rows * d * e + stats * rows * 4, products * product,
            float(b * h * s * s))


def flash_bound(name, q) -> dict:
    """The least time of one call: the larger of the bytes over the memory
    rate and the operations, which are the larger of the products over the
    peak of a product on q's type (``products_by``, :func:`product_peak`:
    in f32, three TF32 products on the tensor cores) and the exponentials
    over the SFUs' rate."""
    nbytes, products, exps = flash_work(name, q)
    rate, products_by = product_peak(q)
    t = {"bytes_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
         "products_bound_ms": products / rate * 1e3,
         "products_by": products_by,
         "exp_bound_ms": exps / EXP_PER_S * 1e3}
    ops = max(t["products_bound_ms"], t["exp_bound_ms"])
    by_bytes = t["bytes_bound_ms"] >= ops
    return dict(t, operations_bound_ms=ops,
                bound_ms=t["bytes_bound_ms"] if by_bytes else ops,
                bound_by="bytes" if by_bytes else "operations")


@contextlib.contextmanager
def first_calls(kernels, names, store):
    """Keep a copy of the positional arguments of the first call of each
    kernel in ``names`` (into ``store``); every call still runs and counts."""
    import torch

    def make(name):
        fn = kernels.cuda[name]

        def rec(*args):
            if name not in store:
                store[name] = [a.clone() if torch.is_tensor(a) else a
                               for a in args]
            return fn(*args)
        return rec

    try:
        for n in names:
            mod, attr, _ = kernels.table[n]
            setattr(mod, attr, make(n))
        yield
    finally:
        for n in names:
            mod, attr, _ = kernels.table[n]
            setattr(mod, attr, kernels.cuda[n])


def path_layout(args):
    """The recorded ``q, k, v`` (and ``do``) laid out as the ViT hands them
    over: head views of one packed ``[B, S, 3 H D]`` projection, ``do`` a
    head view of ``[B, S, H, D]``."""
    import torch

    q = args[0]
    b, h, s, d = q.shape
    packed = torch.empty(b, s, 3 * h * d, dtype=q.dtype, device=q.device)
    views = [t.reshape(b, s, h, d).transpose(1, 2) for t in packed.chunk(3, -1)]
    for view, t in zip(views, args[:3]):
        view.copy_(t)
    out = views + list(args[3:])
    if len(args) > 4:  # the backward's do
        do = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
        do = do.transpose(1, 2)
        do.copy_(args[3])
        out[3] = do
    return out


def flash_case(kernels, name, args, path) -> dict:
    """One call of flash kernel ``name`` at a recorded call's inputs, laid
    out as the path lays them: against its plain version on the card
    (``FLASH_TOL`` of the largest plain value; the forward's ``lse`` within
    ``FLASH_LSE_TOL``; every kernel the same bits on a second call),
    timed (``ms`` the wrapper clock, ``device_ms`` behind a spin kernel),
    beside its plain version's ms, its bound and PyTorch's fused
    attention on the same inputs (``library_ms``, the forward; for the
    backward kernels ``sdpa_backward_ms``, the whole backward of that call,
    which computes dq, dk and dv together). Prints the case and returns
    it."""
    import torch
    import torch.nn.functional as F

    args = path_layout(args)
    fn, plain = kernels.cuda[name], kernels.plain[name]
    q, k, v = args[:3]
    dtype = str(q.dtype)[6:]
    forward = name == "flash_attention"
    got, want = fn(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    meta = {}
    if forward:
        lse_err = float((got[1] - want[1]).abs().max())
        meta.update(lse_max_abs_err=lse_err, lse_tol=FLASH_LSE_TOL * max(
            1.0, float(want[1].abs().max())))
    again = fn(*args)
    again = again if isinstance(again, tuple) else (again,)
    meta["same_bits_twice"] = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    if forward:
        got, want = got[:1], want[:1]
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    rel = max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
              for g, w in zip(got, want))
    del got, want
    tol = FLASH_TOL[dtype][0 if forward else 1]
    ms = cuda_ms(lambda: fn(*args))
    dev_ms = device_ms(lambda: fn(*args))
    plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
    scale = args[-1]
    if forward:
        def library():
            return F.scaled_dot_product_attention(q, k, v, scale=scale)
    else:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=scale)

        def library():
            return torch.autograd.grad(out, leaves, args[3], retain_graph=True)
    key = "library" if forward else "sdpa_backward"
    meta.update({f"{key}_ms": cuda_ms(library),
                 f"{key}_device_ms": device_ms(library)})
    meta.setdefault("library_ms", None)
    case = dict(kernel=name, path=path, dtype=dtype, shape=list(q.shape),
                strides=[list(t.stride()) for t in args[:4] if torch.is_tensor(t)],
                max_abs_err=err, max_rel_err=rel, tol=tol, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, **meta,
                **flash_bound(name, q))
    emit("kernel_case", **case)
    if not rel <= tol or not meta["same_bits_twice"] or (
            forward and not meta["lse_max_abs_err"] <= meta["lse_tol"]):
        raise RuntimeError(f"{name} ({path}) disagrees with its plain version "
                           f"or with itself: {rel} > {tol}, {meta}")
    return case


def flash_backward_pair(kernels, args, path) -> dict:
    """The port's whole attention backward at a recorded dK/dV call (laid
    out as the path lays it): the ``di`` reduction alone, then ``di``, the
    dK/dV and the dQ kernels together, beside PyTorch's fused attention's
    whole backward (dq, dk and dv in one call) on the same inputs; device
    ms behind a spin kernel. Prints the line and returns it."""
    import torch
    import torch.nn.functional as F

    from vision_tpu_torch.ops import attention

    q, k, v, do, lse, _, scale = path_layout(args)
    o = kernels.cuda["flash_attention"](q, k, v, scale)[0]
    dkv = kernels.cuda["flash_attention_backward_dkv"]
    dq = kernels.cuda["flash_attention_backward_dq"]

    def pair():
        di = attention._di(o, do)
        return dkv(q, k, v, do, lse, di, scale), dq(q, k, v, do, lse, di, scale)

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, scale=scale)
    line = dict(path=path, dtype=str(q.dtype)[6:], shape=list(q.shape),
                di_device_ms=device_ms(lambda: attention._di(o, do)),
                pair_with_di_device_ms=device_ms(pair),
                sdpa_backward_device_ms=device_ms(lambda: torch.autograd.grad(
                    out, leaves, do, retain_graph=True)))
    line["factor_to_sdpa"] = (line["pair_with_di_device_ms"]
                              / line["sdpa_backward_device_ms"])
    emit("flash_backward_pair", **line)
    return line


# the PR that redesigned each flash kernel, by (kernel, type)
FLASH_REDESIGNED = {
    ("flash_attention", "float32"): "PR 18",
    ("flash_attention", "bfloat16"): "PR 18",
    ("flash_attention_backward_dkv", "float32"): "PR 17",
    ("flash_attention_backward_dkv", "bfloat16"): "PR 16",
    ("flash_attention_backward_dq", "float32"): "PR 17",
    ("flash_attention_backward_dq", "bfloat16"): "PR 16",
}


def flash_row(case, launches, row_name) -> dict:
    """The ``kernels`` line's row of a flash kernel at one path call."""
    source, replaces = SOURCES[case["kernel"]]
    keep = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_rel_err", "tol", "dtype", "path",
            "shape", "bytes_bound_ms", "products_bound_ms", "products_by",
            "exp_bound_ms",
            "operations_bound_ms", "library_device_ms", "sdpa_backward_ms",
            "sdpa_backward_device_ms", "same_bits_twice", "lse_max_abs_err")
    return {"name": row_name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "calls": 1,
            "redesigned": FLASH_REDESIGNED[case["kernel"], case["dtype"]],
            **{k: case[k] for k in keep if k in case}}


def require_exactly(launches: dict, want: dict, path: str) -> None:
    off = {n: (launches[n], c) for n, c in want.items() if launches[n] != c}
    if off:
        raise RuntimeError(f"kernel launches on the {path} path, "
                           f"(counted, expected): {off}")


def vit_l16_512_phases(kernels) -> list:
    """``vit_l16_512_forward`` / ``_amp``: ViT-L/16 at 512 px
    (``ViT_L_16_Weights.IMAGENET1K_SWAG_E2E_V1``'s shape, 1,025 tokens,
    head dim 64: past the flash gate), seeded, served at batch 32 in f32 and
    bf16: ms a batch, img/s; the f32 logits of one image against the same
    model on the CPU (``VIT_LOGITS_TOL``), the bf16 logits against the f32
    ones (``VIT_L_AMP_LOGITS_TOL``); the flash forward launched 24 times a
    forward, in the phase's type. Then the forward kernel's rows at the
    first call's inputs."""
    import torch

    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.tools.vit_train import SERVE_BATCH_512, seeded_vit

    cpu_model = seeded_vit(device="cpu", name="vit_l_16", image_size=512)
    params = sum(p.numel() for p in cpu_model.parameters())
    x = torch.randn(SERVE_BATCH_512, 3, 512, 512,
                    generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        want = cpu_model(x[:1])
    model = cpu_model.to(resolve_device(None))
    del cpu_model
    x_card = x.to(resolve_device(None))
    forwards = 2 + VIT_TIMED  # the checked one, host_ms's warm-up, the timed
    rows, logits = [], None
    for phase, dtype in (("vit_l16_512_forward", torch.float32),
                         ("vit_l16_512_forward_amp", torch.bfloat16)):
        key = "f32" if dtype == torch.float32 else "bf16"
        model = model.to(dtype)
        xd = x_card.to(dtype)
        calls = {}
        kernels.reset()
        with torch.inference_mode():
            with first_calls(kernels, ["flash_attention"], calls):
                out = model(xd).float()
            ms, ms_all = host_ms(lambda: model(xd))
        launches = kernels.launches()
        require_exactly(launches, {f"flash_attention_{key}":
                                   VIT_L_LAYERS * forwards}, phase)
        fields = dict(model="vit_l_16", image_size=512, params=params,
                      dtype=str(dtype)[6:], batch=SERVE_BATCH_512,
                      ms_per_batch=ms, images_per_s=SERVE_BATCH_512 / ms * 1e3,
                      ms_all=ms_all, flash_launches=launches["flash_attention"],
                      flash_launches_per_forward=launches["flash_attention"]
                      / forwards, logits_std=float(out.std()))
        if dtype == torch.float32:
            logits = out
            err = float((out[:1].cpu() - want).abs().max() / want.abs().max())
            fields.update(logits_vs_cpu_rel_err=err, tol=VIT_LOGITS_TOL)
            ok = params == VIT_L_PARAMS and err <= VIT_LOGITS_TOL
        else:
            err = float((out - logits).abs().max() / logits.abs().max())
            fields.update(logits_vs_f32_rel_err=err, tol=VIT_L_AMP_LOGITS_TOL)
            ok = err <= VIT_L_AMP_LOGITS_TOL
        emit(phase, **fields)
        if not ok or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{phase}: wrong parameter count, or the logits "
                               "are off their reference or not finite")
        case = flash_case(kernels, "flash_attention", calls["flash_attention"],
                          f"{phase} (batch {SERVE_BATCH_512})")
        suffix = "" if dtype == torch.float32 else "_bf16"
        rows.append(flash_row(case, launches[f"flash_attention_{key}"],
                              "flash_attention_vit_l16_512" + suffix))
        del calls, out
    del model, x_card
    torch.cuda.empty_cache()
    return rows


FLASH_NAMES = ("flash_attention", "flash_attention_backward_dkv",
               "flash_attention_backward_dq")


def vit_b16_384_phases(kernels) -> list:
    """``vit_b16_384_train`` / ``_amp``: ViT-B/16 at 384 px
    (``ViT_B_16_Weights.IMAGENET1K_SWAG_E2E_V1``'s shape, 577 tokens, head
    dim 64: past the flash gate), trained by the recipe's step at batch 64
    behind the augmentation cropping to 384 (``--train-crop-size``) from
    448x448 frames, as ``vit_train_phase`` holds ViT-B/16 at 224 (step 1
    against the CPU in f32, against the f32 step in amp); every flash kernel
    launched 12 times a step (the checked step 1 and 7 steps at batch 64),
    in the phase's type. Then the three kernels' rows at the first batch-64
    step's calls."""
    import torch

    from vision_tpu_torch.tools.vit_train import (
        CROP_384,
        FRAME_384,
        TRAIN_BATCH_384,
    )

    rows, f32_loss = [], None
    for phase, dtype in (("vit_b16_384_train", None),
                         ("vit_b16_384_train_amp", torch.bfloat16)):
        key = "f32" if dtype is None else "bf16"
        calls = {}
        kernels.reset()
        loss = vit_train_phase(
            phase, dtype, f32_loss, size=CROP_384, batch_size=TRAIN_BATCH_384,
            frame=FRAME_384,
            first_step=lambda: first_calls(kernels, FLASH_NAMES, calls))
        f32_loss = loss if dtype is None else f32_loss
        launches = kernels.launches()
        steps = 1 + 2 + VIT_TIMED
        require_exactly(launches, {f"{n}_{key}": VIT_B_LAYERS * steps
                                   for n in FLASH_NAMES}, phase)
        emit(phase + "_launches", launches={n: launches[n] for n in FLASH_NAMES},
             steps=steps)
        suffix = "" if dtype is None else "_bf16"
        path = f"{phase} (batch {TRAIN_BATCH_384})"
        for name, row in (("flash_attention", "flash_attention_vit_b16_384"),
                          ("flash_attention_backward_dkv",
                           "flash_attention_backward_dkv"),
                          ("flash_attention_backward_dq",
                           "flash_attention_backward_dq")):
            case = flash_case(kernels, name, calls[name], path)
            rows.append(flash_row(case, launches[f"{name}_{key}"], row + suffix))
        flash_backward_pair(kernels, calls["flash_attention_backward_dkv"], path)
        del calls
        torch.cuda.empty_cache()
    return rows


def vit_long_phases(kernels) -> list:
    """The long-sequence ViTs, through the flash-attention kernels: ViT-L/16
    at 512 served, ViT-B/16 at 384 trained."""
    rows = vit_l16_512_phases(kernels)
    return rows + vit_b16_384_phases(kernels)


# name -> (source, the TPU kernel it replaces)
SOURCES = {
    "nms": ("vision_tpu_torch/csrc/nms.cu", "vision_tpu/ops/_pallas/nms.py:186"),
    "nms_rowscan": ("vision_tpu_torch/csrc/nms_rowscan.cu",
                    "vision_tpu/ops/_pallas/nms.py:252"),
    "window_pool": ("vision_tpu_torch/csrc/window_pool.cu",
                    "vision_tpu/ops/_pallas/window_pool.py:122"),
    "roi_align": ("vision_tpu_torch/csrc/roi_align.cu",
                  "vision_tpu/ops/_pallas/roi_align.py:116"),
    # no pallas_call: the JAX package differentiates both through XLA
    "window_pool_backward": ("vision_tpu_torch/csrc/window_pool_backward.cu",
                             "vision_tpu/ops/poolers.py:82"),
    "roi_align_backward": ("vision_tpu_torch/csrc/roi_align_backward.cu",
                           "vision_tpu/ops/roi_align.py:420"),
    # no pallas_call: XLA gathers and an einsum, differentiated by XLA
    "deform_conv": ("vision_tpu_torch/csrc/deform_conv.cu",
                    "vision_tpu/ops/deform_conv.py:88"),
    "deform_conv_backward": ("vision_tpu_torch/csrc/deform_conv_backward.cu",
                             "vision_tpu/ops/deform_conv.py:88"),
    # JAX's library kernels, reached from vision_tpu/ops/attention.py:80
    "flash_attention": (
        "vision_tpu_torch/csrc/flash_attention.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:758"),
    "flash_attention_backward_dkv": (
        "vision_tpu_torch/csrc/flash_attention_backward.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"),
    "flash_attention_backward_dq": (
        "vision_tpu_torch/csrc/flash_attention_backward.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1456"),
}
WORK = {"nms": nms_work, "nms_rowscan": nms_work, "window_pool": window_work,
        "roi_align": roi_work, "window_pool_backward": window_backward_work,
        "roi_align_backward": roi_backward_work}


def kernel_case(kernels, name, args, path, **meta):
    """One recorded call of kernel ``name`` against its plain version on
    the card (RoIAlign's on the CPU): NMS keep masks bit for bit; f32 pools within 1e-5 of the
    largest plain value (f32 sums in another order); bf16 pools within one
    bf16 step of each element (plus 1e-5 of the largest value); the
    backward kernels the same bits on a second call and, against their
    plain version in f64 on the CPU, in f32 within 1e-5 of the largest sum
    of the summed terms' magnitudes, in bf16 within one bf16 step of each
    element plus that. Prints the case, with its times and bound, and
    returns it."""
    import torch

    exact = name.startswith("nms")
    bf16 = args[0].dtype == torch.bfloat16
    rel_gate = None
    if name.endswith("_backward"):
        # deterministic: the same bits again. Each gradient element sums
        # many terms of both signs, so an f32 sum's error scales with the
        # sum of the terms' magnitudes, not with the result: the kernel is
        # held against the plain version evaluated in f64 (exact weights)
        # on the CPU, within 1e-5 of the largest such sum (the plain
        # version in f64 of |grad|, the weights being non-negative); the
        # error over the largest result is printed beside it, and the f32
        # plain version's on the card. (On the card PyTorch divides by a
        # scalar as a product with its reciprocal, so the plain RoIAlign
        # puts its samples up to an ulp away from the CPU's and the
        # kernels', which divide.)
        first, again = kernels.cuda[name](*args), kernels.cuda[name](*args)
        plain32 = kernels.plain[name](*args)
        torch.cuda.synchronize()
        meta["same_bits_twice"] = bool(torch.equal(first, again))
        cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
        exact64 = kernels.plain[name](cpu[0].double(), *cpu[1:])
        magnitude = float(kernels.plain[name](cpu[0].double().abs(),
                                              *cpu[1:]).max())
        scale64 = max(float(exact64.abs().max()), 1e-30)
        err64 = float((first.cpu().double() - exact64).abs().max())
        plain_err64 = float((plain32.cpu().double() - exact64).abs().max())
        rel_gate = err64 / max(magnitude, 1e-30)
        if bf16:
            # rounded once from an f32 sum: within one bf16 step of the
            # exact value (2**-7 of its magnitude), plus the f32 round-off
            # of the sum, 1e-5 of the largest sum of term magnitudes
            step = 2.0 ** -7 * exact64.abs() + 1e-5 * magnitude
            rel_gate = float(((first.cpu().double() - exact64).abs()
                              / step.clamp(min=1e-30)).max())
            meta["max_err_vs_f64_in_bf16_steps"] = rel_gate
        meta.update(err_vs_f64_over_term_sum=err64 / max(magnitude, 1e-30),
                    plain_err_vs_f64_over_term_sum=plain_err64 / max(
                        magnitude, 1e-30),
                    max_rel_err_vs_f64=err64 / scale64,
                    plain_max_rel_err_vs_f64=plain_err64 / scale64)
        del first, again, exact64, plain32
        if not meta["same_bits_twice"]:
            raise RuntimeError(f"{name} ({path}): two calls on the same "
                               "inputs differ")
    # RoIAlign against its plain version on the CPU: on the card PyTorch
    # divides by a scalar as a product with its reciprocal, which moves the
    # plain version's samples by up to an ulp (1.2e-4 px at 1344 px, 3.7e-5
    # of a 0/1 mask target), where the kernel and the CPU divide
    err, rel, ms, dev_ms, plain_ms = compare_kernel(
        kernels.cuda[name], kernels.plain[name], args, exact=exact,
        on_cpu=name == "roi_align")
    nbytes, ops, peak = WORK[name](args)
    b_ms, b_by = bound_ms(nbytes, ops, peak)
    tol = 0.0 if exact else 1.0 if bf16 else 1e-5
    if name == "window_pool":
        shape = [list(args[3].shape), list(args[0].shape)]
    elif name == "window_pool_backward":  # grad, w_y, pyramid
        shape = [list(args[0].shape), list(args[3].shape), list(args[5])]
    elif name == "roi_align_backward":  # grad, RoIs, input
        shape = [list(args[0].shape), list(args[1].shape), list(args[2])]
    else:
        shape = [list(args[0].shape), list(args[1].shape)]
    case = dict(kernel=name, path=path, dtype=str(args[0].dtype)[6:],
                shape=shape, **meta, max_abs_err=err,
                **{"max_err_in_bf16_steps" if bf16 else "max_rel_err": rel},
                tol=tol, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                bytes_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                operations_bound_ms=ops / peak * 1e3)
    emit("kernel_case", **case)
    if (rel if rel_gate is None else rel_gate) > tol:
        raise RuntimeError(f"{name} ({path}, {meta}) disagrees with its plain "
                           f"version: {rel} > {tol}")
    return case


def summed(cases) -> dict:
    """The cases' times and bounds summed: one forward or request."""
    out = {k: sum(c[k] for c in cases) for k in (
        "ms", "device_ms", "plain_ms", "bound_ms", "bytes_bound_ms",
        "operations_bound_ms")}
    by_bytes = out["bytes_bound_ms"] >= out["operations_bound_ms"]
    return dict(out, max_abs_err=max(c["max_abs_err"] for c in cases),
                bound_by="bytes" if by_bytes else "operations",
                calls=len(cases))


def kernel_row(name, cases, launches, row_name=None, **extra) -> dict:
    """The ``kernels`` line's row of ``name`` at ``cases``."""
    source, replaces = SOURCES[name]
    return {"name": row_name or name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, **summed(cases),
            "library_ms": None, **extra}


def train_steps(batch, *, fused, dtype, steps, first_step=None, lr=LR):
    """A fresh seeded ResNet-50 and ``steps`` SGD steps on ``batch``. Returns
    the losses, the first step's logits, the running statistics after the
    first step, and each step's wall ms (the loss is read back, so a step
    ends when the device has finished it)."""
    import torch

    from vision_tpu_torch.models import get_model
    from vision_tpu_torch.parallel import make_train_step

    model = get_model("resnet50", fused_bn=fused, seed=0)
    optimizer = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9,
                                weight_decay=1e-4)
    step = make_train_step(model, optimizer, compute_dtype=dtype)
    logits = []
    hook = model.register_forward_hook(
        lambda mod, args, out: logits.append(out.detach().float().clone()))
    out = {"losses": [], "ms": [], "fused": fused,
           "dtype": "float32" if dtype is None else str(dtype)[6:]}
    for i in range(steps):
        ctx = first_step() if i == 0 and first_step else contextlib.nullcontext()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with ctx:
            loss = float(step(batch)["loss"])
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["losses"].append(loss)
        if i == 0:
            out["stats"] = {n: b.clone() for n, b in model.named_buffers()
                            if "running" in n}
    hook.remove()
    out["logits"] = logits[0]
    out["ms_per_step"] = statistics.median(out["ms"][1:]) if steps > 1 else None
    return out


def speed(run) -> dict:
    ms = run["ms_per_step"]
    return {"fused_bn": run["fused"], "dtype": run["dtype"], "ms_per_step": ms,
            "images_per_s": BATCH / ms * 1e3, "ms_all": run["ms"]}


def resnet50_phases(kernels):
    """ResNet-50: one eval batch; three f32 SGD steps with ``fused_bn=True``
    through the FP32 ``matmul_stats`` kernel against the same steps through
    the plain version (first step: loss and logits within 1e-3, running
    statistics within 1e-4 of each tensor's largest value; later losses
    within ``LATER_LOSS_TOL``); one f32 step through the general kernel; the
    bf16 step timed, through the ``wgmma`` kernel, its first loss within
    2e-2 of the plain path's; the kernels' cases."""
    import torch

    from vision_tpu_torch.models import get_model

    gen = torch.Generator().manual_seed(2)
    batch = {
        "image": torch.randn(BATCH, 3, 224, 224, generator=gen).cuda(),
        "label": torch.randint(0, 1000, (BATCH,), generator=gen).cuda(),
    }

    model = get_model("resnet50", seed=0)
    params = sum(p.numel() for p in model.parameters())
    times = []
    with torch.inference_mode():
        for _ in range(1 + TIMED_FORWARDS):
            t = time.perf_counter()
            logits = model(batch["image"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    finite = bool(torch.isfinite(logits).all())
    emit("resnet50_eval", params=params, input=[BATCH, 3, 224, 224],
         dtype="float32", shape=list(logits.shape), finite=finite,
         ms_per_batch_median=statistics.median(times[1:]), ms_all=times)
    if params != 25_557_032 or tuple(logits.shape) != (BATCH, 1000) or not finite:
        raise RuntimeError("resnet50 eval: wrong parameter count, shape or "
                           "non-finite logits")
    resnet50_preset_check(model)
    del model, logits

    # f32: the kernel path against the plain path, step by step
    calls, counts = {}, {}
    kernels.reset()
    run = train_steps(batch, fused=True, dtype=None, steps=3,
                      first_step=lambda: kernels.recording(calls, counts))
    launches = kernels.launches()
    with kernels.plain_versions():
        ref = train_steps(batch, fused=True, dtype=None, steps=3)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"])]
    logit_rel = float((run["logits"] - ref["logits"]).abs().max()
                      / ref["logits"].abs().max())
    stats_rel = max(
        float((run["stats"][n] - r).abs().max() / r.abs().max().clamp(min=1e-30))
        for n, r in ref["stats"].items())
    emit("resnet50_train_f32", steps=3, batch=BATCH, lr=LR,
         losses=run["losses"], plain_losses=ref["losses"],
         loss_rel_err=loss_rel, first_loss_tol=1e-3,
         later_loss_tol=LATER_LOSS_TOL,
         first_logits_rel_err=logit_rel, logits_tol=1e-3,
         running_stats_rel_err=stats_rel, stats_tol=1e-4,
         launches=launches, matmul_stats_calls_per_forward=sum(counts.values()))
    require_launched(launches, ("matmul_stats", "matmul_stats_fma"),
                     "ResNet-50 train (f32)")
    require_only(launches, "matmul_stats_fma", 3 * MM_CALLS_PER_FORWARD,
                 "3 f32 steps")
    if not all(math.isfinite(v) for v in run["losses"]):
        raise RuntimeError(f"non-finite loss: {run['losses']}")
    if run["losses"][2] == run["losses"][0]:
        raise RuntimeError("the third loss equals the first: no update happened")
    if (loss_rel[0] > 1e-3 or max(loss_rel[1:]) > LATER_LOSS_TOL
            or logit_rel > 1e-3 or stats_rel > 1e-4):
        raise RuntimeError("the kernel train path disagrees with the plain path")
    first_loss = run["losses"][0]
    del run, ref
    torch.cuda.empty_cache()
    launches_general = general_kernel_phase(kernels, batch, first_loss)

    # bf16: the timed step, and its first loss against the plain path's
    calls16, counts16 = {}, {}
    kernels.reset()
    run16 = train_steps(batch, fused=True, dtype=torch.bfloat16,
                        steps=1 + TIMED_FORWARDS,
                        first_step=lambda: kernels.recording(calls16, counts16))
    launches16 = kernels.launches()
    with kernels.plain_versions():
        ref16 = train_steps(batch, fused=True, dtype=torch.bfloat16, steps=1)
    rel16 = abs(run16["losses"][0] - ref16["losses"][0]) / abs(ref16["losses"][0])
    emit("resnet50_train_bf16", batch=BATCH, lr=LR, **speed(run16),
         losses=run16["losses"], plain_first_loss=ref16["losses"][0],
         first_loss_rel_err=rel16, loss_tol=2e-2, launches=launches16)
    require_launched(launches16, ("matmul_stats", "matmul_stats_wgmma"),
                     "ResNet-50 train (bf16)")
    require_only(launches16, "matmul_stats_wgmma",
                 (1 + TIMED_FORWARDS) * MM_CALLS_PER_FORWARD,
                 f"{1 + TIMED_FORWARDS} bf16 steps")
    if not all(math.isfinite(v) for v in run16["losses"]) or rel16 > 2e-2:
        raise RuntimeError("bf16 train path: non-finite loss or first loss "
                           "away from the plain path's")
    del run16, ref16
    torch.cuda.empty_cache()

    # the step's speed in the other three settings, for the record
    for fused, dtype in ((False, torch.bfloat16), (True, None), (False, None)):
        emit("resnet50_train_speed", batch=BATCH, **speed(train_steps(
            batch, fused=fused, dtype=dtype, steps=1 + TIMED_FORWARDS)))
        torch.cuda.empty_cache()

    return matmul_stats_rows(kernels, calls, counts, calls16, counts16,
                             {"fma": launches["matmul_stats_fma"],
                              "wgmma": launches16["matmul_stats_wgmma"],
                              "general": launches_general})


def resnet50_preset_check(model) -> None:
    """A seeded batch of 8 uint8 375x500 images through the weights'
    ``ImageClassification`` preset (resize 232, crop 224) and the eval
    model on the card, against the same on the CPU: logits within 1e-3 of
    the largest. (The uint8 resize of each side may round a near-tie the
    other way: one level of one pixel.)"""
    import torch

    from vision_tpu_torch.models import ResNet50_Weights, get_model

    gen = torch.Generator().manual_seed(3)
    raw = torch.randint(0, 256, (8, 3, 375, 500), dtype=torch.uint8, generator=gen)
    weights = ResNet50_Weights.DEFAULT
    with torch.inference_mode():
        x = torch.stack([weights.transforms()(r) for r in raw])
        logits = model(x).cpu()
        cpu_preset = weights.transforms(device="cpu")
        x_cpu = torch.stack([cpu_preset(r) for r in raw])
        want = get_model("resnet50", seed=0, device="cpu")(x_cpu)
    rel = float((logits - want).abs().max() / want.abs().max())
    input_err = float((x.cpu() - x_cpu).abs().max())
    emit("resnet50_preset", images=list(raw.shape), preset=repr(weights.transforms(
        device="cpu")), input=list(x.shape), input_device=str(x.device),
        max_input_err=input_err, logits_rel_err=rel, tol=1e-3)
    if tuple(x.shape) != (8, 3, 224, 224) or not rel <= 1e-3:
        raise RuntimeError("ResNet-50 through its preset on the card disagrees "
                           "with the CPU")


# ImageNet eval from encoded JPEGs (bench.py:_bench_e2e and neighbours)
E2E_BATCH = 64
E2E_BATCHES = 12
E2E_DEVICE_INPUT_ITERS = 20
E2E_CHECKED = 8  # images of the first batch held against the CPU
E2E_INPUT_TOL = 1e-4  # preprocessed f32 input, card against CPU, absolute
AMP_LOGITS_TOL = 5e-2  # bf16 logits against f32, of the largest
# the timed batches' logits against the checked batch's on the card (the
# same images), of the largest: f32, bf16
TIMED_LOGITS_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
RESNET18_PARAMS = 11_689_512
# Annex K tables, natural order (libjpeg's jcparam.c std_*_quant_tbl)
ANNEX_K = (
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32,
)


def ijg_table(basic, quality: int) -> list:
    """libjpeg's ``jpeg_set_quality``: the table scaled by
    ``jpeg_quality_scaling``, rounded, clamped to 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [min(max((v * scale + 50) // 100, 1), 255) for v in basic]


def jpeg_codec_phase(jpegs) -> None:
    """The port's codec on the card's host: the 32 JPEGs of ``make_jpegs``
    (encoded there by the port's encoder) decoded on the host and on the
    card (coefficient limit 8), at most 1 count apart; the encoder's
    quantisation tables against the IJG formula at five qualities; host
    ms an image on one core, the whole decode and the Huffman pass alone
    (``bench.py:521-545``), and the decode rate on all the host's cores
    through the library's batch decoder."""
    import numpy as np
    import torch

    from vision_tpu_torch.io import _codecs, decode_jpeg, encode_jpeg
    from vision_tpu_torch.io.jpeg_device import host_decode_batch
    from vision_tpu_torch.tools import imagenet_e2e as e2e

    host = decode_jpeg(jpegs, device="cpu")
    dev = [d.cpu() for d in decode_jpeg(jpegs)]
    diff = [(h.int() - d.int()).abs() for h, d in zip(host, dev)]
    max_err = max(int(d.max()) for d in diff)
    share = sum(int((d > 0).sum()) for d in diff) / sum(d.numel() for d in diff)
    img = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (3, 40, 56), dtype=np.uint8))
    tables_ok = {}
    for q in (10, 50, 75, 95, 100):
        _, qt, samp, _ = _codecs.jpeg_coefficients_native(encode_jpeg(img, q))
        tables_ok[q] = (samp == [(2, 2), (1, 1), (1, 1)] and all(
            t.tolist() == ijg_table(ANNEX_K[min(ci, 1)], q)
            for ci, t in enumerate(qt)))
    full_ms, huff_ms = e2e.host_decode_ms(jpegs[:16], 64)
    threads = len(os.sched_getaffinity(0))
    with ThreadPoolExecutor(threads) as pool:
        host_decode_batch(jpegs, pool=pool)
        t0 = time.perf_counter()
        host_decode_batch(jpegs * 8, pool=pool)
        rate = len(jpegs) * 8 / (time.perf_counter() - t0)
    emit("jpeg_codec", jpegs=len(jpegs), shape=list(host[0].shape),
         bytes_mean=sum(map(len, jpegs)) / len(jpegs),
         host_vs_device_max_abs_err=max_err, differing_share=share,
         tol=1, tables_match_ijg=tables_ok, host_full_ms_per_img=full_ms,
         host_huffman_ms_per_img=huff_ms, host_threads=threads,
         host_decode_img_per_s=rate)
    if (max_err > 1 or not all(tables_ok.values())
            or tuple(host[0].shape) != (3, 375, 500)):
        raise RuntimeError("jpeg_codec: host and card decodes disagree, or the "
                           "encoder's tables are not IJG's")


def e2e_rate(batches, step, device):
    """Images a second of ``step`` over ``batches`` (a callable of the
    batch count, whose pinned batches the queue takes over) through
    ``prefetch_to_device``, one synchronisation at the end, after one
    warm-up batch; and the logits of each timed batch."""
    import torch

    from vision_tpu_torch.io import prefetch_to_device

    for x in prefetch_to_device(batches(1), device=device, donate_pinned=True):
        step(x)
    torch.cuda.synchronize()
    outs = []
    t0 = time.perf_counter()
    for x in prefetch_to_device(batches(E2E_BATCHES), depth=2, device=device,
                                donate_pinned=True):
        outs.append(step(x))
    torch.cuda.synchronize()
    return E2E_BATCH * E2E_BATCHES / (time.perf_counter() - t0), outs


def check_timed(phase, outs, ref) -> dict:
    """Every timed batch holds the images of the checked batch (``bench.py``
    cycles through 32 streams, batch 64), so its logits must be the checked
    batch's, ``ref``, computed on the card outside the queue: within
    ``TIMED_LOGITS_TOL`` of the largest. A batch the queue landed late,
    twice or torn shows here."""
    tol = TIMED_LOGITS_TOL[str(ref.dtype).removeprefix("torch.")]
    ref = ref.float()
    err = max(float((o.float() - ref).abs().max()) for o in outs)
    err /= float(ref.abs().max())
    total = sum(float(o.float().sum()) for o in outs)
    if not err <= tol or not math.isfinite(total):
        raise RuntimeError(f"{phase}: a timed batch's logits are off the "
                           f"checked batch's by {err} (tol {tol}), or not "
                           "finite")
    return {"timed_batches_vs_checked_rel_err": err, "timed_tol": tol,
            "logits_sum": total}


def check_logits(phase, x_card, x_cpu, model, cpu_model, model16=None) -> dict:
    """The f32 model's logits on the card against the CPU's within 1e-3 of
    the largest (``resnet50_preset_check``'s tolerance), and with
    ``model16`` the bf16 model's on the same input against those within
    ``AMP_LOGITS_TOL``."""
    import torch

    logits = model(x_card).cpu()
    want = cpu_model(x_cpu)
    out = {"logits_rel_err": float((logits - want).abs().max() / want.abs().max()),
           "logits_tol": 1e-3}
    if model16 is not None:
        l16 = model16(x_card.to(torch.bfloat16)).float().cpu()
        out.update(bf16_logits_rel_err=float(
            (l16 - logits).abs().max() / logits.abs().max()),
            bf16_logits_tol=AMP_LOGITS_TOL)
    if not out["logits_rel_err"] <= 1e-3 or not out.get(
            "bf16_logits_rel_err", 0.0) <= AMP_LOGITS_TOL:
        raise RuntimeError(f"{phase}: logits disagree: {out}")
    return out


def imagenet_e2e_phases() -> None:
    """ResNet eval from encoded JPEGs (``tools/imagenet_e2e.py``), batch 64,
    12 timed batches, one synchronisation at the end: ``jpeg_codec``;
    ResNet-50 in bf16 from host-decoded images (``resnet50_e2e_images``),
    from the Huffman pass with the rest of the decode on the card
    (``resnet50_e2e_device_decode``, coefficient limit 5) and from decoded
    frames already on the card (``resnet50_e2e_device_input``); ResNet-18
    in f32 through its weights' preset (``resnet18_e2e_images``, BASELINE
    config 1). A checked batch of each, decoded by the same library call
    but not pinned and moved outside the queue: 8 images' preprocessed f32
    input against the CPU's, their logits against the CPU model's, the
    bf16 logits against the f32 ones on the card; the device decode's
    pixels against the host decode at the same scale. Every timed batch
    holds the checked batch's images, and its logits are held against the
    checked batch's (``check_timed``)."""
    import torch

    from vision_tpu_torch.io import decode_jpeg
    from vision_tpu_torch.io.jpeg_device import decode_threads
    from vision_tpu_torch.models import ResNet18_Weights, get_model
    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.tools import imagenet_e2e as e2e

    t0 = time.perf_counter()
    jpegs = e2e.make_jpegs()
    encode_s = time.perf_counter() - t0
    jpeg_codec_phase(jpegs)
    if E2E_BATCH % len(jpegs):
        raise RuntimeError("check_timed needs every batch to hold the same "
                           "images: a batch of a multiple of the streams")
    threads = decode_threads()
    cuda = resolve_device(None)
    pin = cuda.type == "cuda"
    n = E2E_CHECKED
    with torch.inference_mode(), ThreadPoolExecutor(threads) as pool:
        model32 = get_model("resnet50", seed=0)
        model16 = get_model("resnet50", seed=0).to(torch.bfloat16)
        cpu50 = get_model("resnet50", seed=0, device="cpu")

        def host_batches(count):
            return e2e.host_decode_batches(jpegs, E2E_BATCH, count, pool, pin=pin)

        def step50(raw):
            return model16(e2e.preprocess(raw))

        first = next(e2e.host_decode_batches(jpegs, E2E_BATCH, 1, pool))
        frames = first.to(cuda)
        x_card = e2e.preprocess(frames[:n], torch.float32)
        x_cpu = e2e.preprocess(first[:n], torch.float32)
        input_err = float((x_card.cpu() - x_cpu).abs().max())
        check = check_logits("resnet50_e2e_images", x_card, x_cpu, model32,
                             cpu50, model16)
        ref50 = step50(frames)
        rate, outs = e2e_rate(host_batches, step50, cuda)
        timed = check_timed("resnet50_e2e_images", outs, ref50)
        emit("resnet50_e2e_images", model="resnet50", dtype="bfloat16",
             batch=E2E_BATCH, batches=E2E_BATCHES, image=list(first.shape[1:]),
             jpeg_encode_s=encode_s, host_threads=threads,
             input_max_abs_err=input_err, input_tol=E2E_INPUT_TOL,
             images_per_s=rate, **timed, **check)
        if not input_err <= E2E_INPUT_TOL:
            raise RuntimeError("resnet50_e2e_images: input off the CPU's")

        coefs = next(e2e.coef_batches(jpegs, E2E_BATCH, 1, pool))
        coefs_card = [[t.to(cuda) for t in coefs[0]],
                      [t.to(cuda) for t in coefs[1]], *coefs[2:]]
        imgs = e2e.decode_on_device(coefs_card)
        ref = torch.stack(decode_jpeg(
            [jpegs[i % len(jpegs)] for i in range(E2E_BATCH)], device="cpu",
            scale=(e2e.COEF_LIMIT, 8)))
        pix_err = int((imgs.cpu().int() - ref.int()).abs().max())
        pix_share = float(((imgs.cpu() != ref).sum()) / imgs.numel())

        def coef_batches(count):
            return e2e.coef_batches(jpegs, E2E_BATCH, count, pool, pin=pin)

        ref_dd = model16(e2e.preprocess(imgs, nhwc=False))
        rate, outs = e2e_rate(coef_batches, lambda c: model16(e2e.preprocess(
            e2e.decode_on_device(c), nhwc=False)), cuda)
        timed = check_timed("resnet50_e2e_device_decode", outs, ref_dd)
        emit("resnet50_e2e_device_decode", model="resnet50", dtype="bfloat16",
             batch=E2E_BATCH, batches=E2E_BATCHES, coef_limit=e2e.COEF_LIMIT,
             image=list(imgs.shape[1:]),
             coef_bytes_per_img=sum(c[0].numel() * 2 for c in coefs[0]),
             pixels_vs_host_max_abs_err=pix_err, pixels_differing_share=pix_share,
             pixel_tol=1, host_threads=threads, images_per_s=rate, **timed)
        if pix_err > 1 or tuple(imgs.shape[1:]) != (3, 235, 313):
            raise RuntimeError("resnet50_e2e_device_decode: card decode off the "
                               "host's, or wrong size")

        step50(frames)
        torch.cuda.synchronize()
        outs = []
        t0 = time.perf_counter()
        for _ in range(E2E_DEVICE_INPUT_ITERS):
            outs.append(step50(frames))
        torch.cuda.synchronize()
        rate = E2E_BATCH * E2E_DEVICE_INPUT_ITERS / (time.perf_counter() - t0)
        timed = check_timed("resnet50_e2e_device_input", outs, ref50)
        emit("resnet50_e2e_device_input", model="resnet50", dtype="bfloat16",
             batch=E2E_BATCH, iters=E2E_DEVICE_INPUT_ITERS,
             image=list(frames.shape[1:]), images_per_s=rate, **timed)
        del model32, model16, cpu50, frames, outs, ref50, ref_dd, imgs
        torch.cuda.empty_cache()

        model18 = get_model("resnet18", seed=0)
        params = sum(p.numel() for p in model18.parameters())
        preset = ResNet18_Weights.DEFAULT.transforms()
        cpu_preset = ResNet18_Weights.DEFAULT.transforms(device="cpu")

        def step18(raw):
            return model18(preset(raw.permute(0, 3, 1, 2)))

        nchw = first[:n].permute(0, 3, 1, 2)
        x_card, x_cpu = preset(nchw.to(cuda)), cpu_preset(nchw)
        input_err = float((x_card.cpu() - x_cpu).abs().max())
        check = check_logits("resnet18_e2e_images", x_card, x_cpu, model18,
                             get_model("resnet18", seed=0, device="cpu"))
        ref18 = step18(first.to(cuda))
        rate, outs = e2e_rate(host_batches, step18, cuda)
        timed = check_timed("resnet18_e2e_images", outs, ref18)
        emit("resnet18_e2e_images", model="resnet18", params=params,
             dtype="float32", preset=repr(preset), batch=E2E_BATCH,
             batches=E2E_BATCHES, host_threads=threads,
             input_max_abs_err=input_err, input_tol=E2E_INPUT_TOL,
             images_per_s=rate, **timed, **check)
        if params != RESNET18_PARAMS or not input_err <= E2E_INPUT_TOL:
            raise RuntimeError("resnet18_e2e_images: wrong parameter count, or "
                               "input off the CPU's")


# ImageNet from files on disk (tools/imagenet_folder.py)
FOLDER_BATCH = 32
FOLDER_CROP = 224
FOLDER_CLASSES = 8
FOLDER_TRAIN_PER_CLASS = 40
FOLDER_VAL_PER_CLASS = 16
FOLDER_FIRST_LOSS_TOL = 2e-2  # amp step 1 against the plain path's, relative
FOLDER_CHECKED = 8  # images of the eval batch held against the CPU
# normalised input, card against CPU, absolute: one uint8 level over the
# smallest ImageNet std (the card's and the CPU's decodes of one stream
# differ by a level at most; a uint8 resize may round a near-tie the other
# way, resnet50_preset_check)
PRESET_INPUT_TOL = 1.0 / (255.0 * 0.224) + 1e-5
FOLDER_IO_REPS = 3


def image_io_phase() -> dict:
    """The port's codecs on the card's host against the fixtures of
    ``tests/torch_io_data`` (Pillow, libwebp and libjpeg streams; the
    card's machine has none of them): every fixture's decoded pixels, and
    each JPEG fixture's coefficients at limits 8 and 5, against the SHA-256
    digests its manifest recorded from libjpeg, libpng, libwebp (Pillow
    for the animation) and ``vision_tpu``'s GIF decoder (a JPEG's pixels
    from the port's own host decode there, beside their distance from
    libjpeg's); the progressive fixtures and the JPEGs of sampling factors
    3 and 4 decoded on the card within one level of the host (WebP has no
    card stage: its decode is the host's, copied); then
    host ms an image at 500x375 for baseline, progressive and CMYK JPEG
    streams (the whole decode and the Huffman pass alone), for lossy,
    lossless and lossy + alpha WebP, and for PNG decode and encode, on one
    thread and on ``decode_threads()``. Returns the host ms by stream
    kind."""
    import hashlib

    import numpy as np

    from vision_tpu_torch.io import (
        _codecs,
        _image_codecs,
        decode_jpeg,
        decode_png,
    )
    from vision_tpu_torch.io.jpeg_device import decode_threads
    from vision_tpu_torch.tools import imagenet_folder as folder

    manifest = json.loads((folder.FIXTURES / "manifest.json").read_text())

    def digest(arrs) -> str:
        h = hashlib.sha256()
        for a in arrs:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    streams = {n: (folder.FIXTURES / n).read_bytes() for n in manifest}
    bad = []
    for name, want in sorted(manifest.items()):
        data = streams[name]
        if want["kind"] == "jpeg":
            px = _codecs.decode_jpeg_native(data)
            for m in (8, 5):
                key = f"coefs_sha256_m{m}"
                if key in want:
                    coefs = _codecs.jpeg_coefficients_native(data, m % 8)[0]
                    if digest(coefs) != want[key]:
                        bad.append(f"{name} {key}")
        elif want["kind"] == "png":
            px = _image_codecs.decode_png_native(data)
            if "pixels16_sha256" in want and digest(
                    [_image_codecs.decode_png_native(data, wide=True)]) != want["pixels16_sha256"]:
                bad.append(f"{name} pixels16")
        elif want["kind"] == "webp":
            px = _image_codecs.decode_webp_native(data)
        else:
            px = _image_codecs.decode_gif_native(data)
        if list(px.shape) != want["shape"] or digest([px]) != want["pixels_sha256"]:
            bad.append(f"{name} pixels")
    progressive = [streams[n] for n in sorted(streams) if n.startswith("prog_")]
    host = decode_jpeg(progressive, device="cpu")
    card = decode_jpeg(progressive)
    card_err = max(int((h.expand_as(c).int() - c.cpu().int()).abs().max())
                   for h, c in zip(host, card))
    png_card = all(bool((decode_png(streams[n]).cpu() == decode_png(streams[n], device="cpu")).all())
                   for n in streams if n.endswith(".png"))
    webps = sorted(n for n in streams if manifest[n]["kind"] == "webp")
    sampled = [streams[n] for n in sorted(streams) if n.startswith("samp_")]
    samp_err = max(int((h.expand(3, -1, -1).int() - c.cpu().int()).abs().max())
                   for h, c in zip(decode_jpeg(sampled, device="cpu"), decode_jpeg(sampled)))

    threads = decode_threads()
    base = folder.baseline_jpegs(sizes=[folder.BASELINE_SIZES[0]], variants=8, quality=75)
    kinds = {"baseline": base, "progressive": [streams["prog_420.jpg"]] * 8,
             "cmyk": [streams["cmyk.jpg"]] * 8}
    ms = {}
    for kind, batch in kinds.items():
        for t in (1, threads):
            ms[f"{kind}_decode_ms_t{t}"] = folder.host_ms(
                _codecs.decode_jpeg_native, batch, t, FOLDER_IO_REPS)
            if kind != "cmyk":
                ms[f"{kind}_huffman_ms_t{t}"] = folder.host_ms(
                    _codecs.jpeg_coefficients_native, batch, t, FOLDER_IO_REPS)
    for kind in ("lossy", "lossless", "alpha"):
        batch = [streams[f"webp_{kind}_500x375.webp"]] * 8
        for t in (1, threads):
            ms[f"webp_{kind}_decode_ms_t{t}"] = folder.host_ms(
                _image_codecs.decode_webp_native, batch, t, FOLDER_IO_REPS)
    h, w = folder.BASELINE_SIZES[0]
    pngs = [_image_codecs.encode_png_native(folder.photo(h, w, seed=s)) for s in range(8)]
    imgs = [folder.photo(h, w, seed=s) for s in range(8)]
    for t in (1, threads):
        ms[f"png_decode_ms_t{t}"] = folder.host_ms(
            _image_codecs.decode_png_native, pngs, t, FOLDER_IO_REPS)
        ms[f"png_encode_ms_t{t}"] = folder.host_ms(
            _image_codecs.encode_png_native, imgs, t, FOLDER_IO_REPS)
    emit("image_io", fixtures=len(manifest), digest_mismatches=bad,
         progressive_card_vs_host_max_abs_err=card_err, card_tol=1,
         sampling_3_4_card_vs_host_max_abs_err=samp_err, sampling_streams=len(sampled),
         png_card_equals_host=png_card, webp_fixtures=len(webps),
         host_threads=threads, image=[h, w],
         png_bytes_mean=sum(map(len, pngs)) / len(pngs), **ms)
    if bad or card_err > 1 or samp_err > 1 or not png_card:
        raise RuntimeError(f"image_io: digests off the manifest's {bad}, or the "
                           "card's decode off the host's")
    return ms


def folder_epoch(loader, step=None):
    """One epoch of ``loader``, with ``step`` on each batch: the wall
    seconds with one synchronisation at the end, the batches, the images,
    and each step's loss (read after the epoch)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, n, batches = [], 0, 0
    for batch in loader:
        n += batch["label"].shape[0]
        batches += 1
        if step is not None:
            losses.append(step(batch)["loss"])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, batches, n, [float(v) for v in losses]


def imagenet_folder_phases(kernels) -> None:
    """ImageNet from files on disk: a tree of 8 classes in a temporary
    directory (``tools/imagenet_folder.py``: train/ 8 x 40 JPEGs, mostly
    the port's baseline encodes at five ImageNet sizes, one copy a class of
    the progressive 4:2:0, 4:4:4, grey and restart, EXIF-rotated and CMYK
    fixtures; val/ 8 x 16, with a progressive, a CMYK and two PNGs a
    class). ``imagenet_folder_train``: ``ImageFolder`` -> ``DeviceJpegLoader``
    (train, batch 32 at 224, EXIF applied) alone for an epoch, then feeding
    ResNet-50 ``fused_bn=True`` amp steps for one epoch through the
    ``matmul_stats`` ``wgmma`` kernel, step 1's loss against the plain
    path's on the same batch; the loader's per-bucket program timed on the
    card. ``imagenet_folder_eval``: the loader (eval) feeding ResNet-50 in
    bf16, one batch's input against the same loader on the CPU and its
    logits against the CPU's f32 model. ``imagenet_folder_host``:
    ``ImageFolder`` + ``DataLoader`` (threads) + ``read_image`` + the
    weights' ``ImageClassification`` preset over val/, PNGs included.
    Every epoch's ``stats`` must show nothing dropped and every CMYK (and
    PNG) file in the re-encode lane."""
    import tempfile

    import torch

    from vision_tpu_torch.datasets import DataLoader, ImageFolder
    from vision_tpu_torch.io import DeviceJpegLoader
    from vision_tpu_torch.io.jpeg_device import decode_threads
    from vision_tpu_torch.models import ResNet50_Weights, get_model
    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.parallel import make_train_step
    from vision_tpu_torch.tools import imagenet_folder as folder

    cuda = resolve_device(None)
    io_ms = image_io_phase()
    tmp = tempfile.TemporaryDirectory(prefix="imagenet_folder_")
    try:
        t0 = time.perf_counter()
        kinds = folder.write_tree(tmp.name, FOLDER_CLASSES, FOLDER_TRAIN_PER_CLASS,
                                  FOLDER_VAL_PER_CLASS)
        tree_s = time.perf_counter() - t0
        train_ds = ImageFolder(os.path.join(tmp.name, "train"))
        val_ds = ImageFolder(os.path.join(tmp.name, "val"))
        if len(train_ds) != kinds["train"]["files"] or len(val_ds) != kinds["val"]["files"]:
            raise RuntimeError(f"imagenet_folder: ImageFolder found {len(train_ds)} / "
                               f"{len(val_ds)} files of {kinds}")

        # (a) the loader alone, then feeding the amp step
        loader = DeviceJpegLoader(train_ds.samples, FOLDER_BATCH, FOLDER_CROP,
                                  train=True, apply_exif_orientation=True, seed=0)
        # the first epoch faults in the recycled coefficient arrays; the
        # second, the same samples, runs warm
        cold_s, batches, n, _ = folder_epoch(loader)
        alone_s, _, _, _ = folder_epoch(loader)
        stats_alone, buckets = dict(loader.stats), list(loader.buckets)
        model = get_model("resnet50", fused_bn=True, seed=0)
        optimizer = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9,
                                    weight_decay=1e-4)
        step = make_train_step(model, optimizer, compute_dtype=torch.bfloat16)
        first = next(iter(loader))
        first = {k: v.clone() for k, v in first.items()}
        with kernels.plain_versions():
            ref = train_steps(first, fused=True, dtype=torch.bfloat16, steps=1)
        kernels.reset()
        loss1 = float(step(first)["loss"])
        launches = kernels.launches()
        rel = abs(loss1 - ref["losses"][0]) / abs(ref["losses"][0])
        # the step alone on one batch already on the card, for the idle share
        step(first)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            loss = step(first)["loss"]
        float(loss)
        step_ms = (time.perf_counter() - t) * 1e3 / 3
        loader.set_epoch(1)
        kernels.reset()
        with_s, steps, n_step, losses = folder_epoch(loader, step)
        launches_epoch = kernels.launches()
        stats = dict(loader.stats)
        # the per-bucket program on the first bucket to fill
        by_bucket = {}
        for i in range(len(train_ds)):
            lane, r, label = loader._coefficients(i)
            if lane == "offload":
                bk = loader._bucket_key([c.shape for c in r[0]], r[2])
                items = by_bucket.setdefault(bk, [])
                items.append((r[0], r[1], r[3], label))
                if len(items) == FOLDER_BATCH:
                    break
        staged = loader.stage(bk, items)
        boxes, flips = loader._draws(torch.Generator().manual_seed(0), staged[2])
        program_ms = device_ms(lambda: loader.device_batch(*staged, boxes, flips, bk),
                               launches=5)
        idle = max(0.0, 1.0 - steps * step_ms / (with_s * 1e3))
        emit("imagenet_folder_train", tree=kinds, tree_s=tree_s, batch=FOLDER_BATCH,
             crop=FOLDER_CROP, batches=batches, images=n,
             buckets_per_epoch=len(buckets), buckets=[list(map(str, b)) for b in buckets],
             stats=stats_alone, stats_epoch_1=stats, stats_total=loader.stats_total,
             offload_hit_rate=loader.offload_hit_rate,
             loader_images_per_s=n / alone_s, loader_s=alone_s,
             loader_first_epoch_images_per_s=n / cold_s,
             with_step_images_per_s=n_step / with_s, with_step_s=with_s, steps=steps,
             step_ms_on_card_input=step_ms, input_idle_share=idle,
             losses=losses, first_loss=loss1, plain_first_loss=ref["losses"][0],
             first_loss_rel_err=rel, loss_tol=FOLDER_FIRST_LOSS_TOL,
             launches=launches, launches_epoch=launches_epoch,
             bucket_program_device_ms=program_ms, bucket_program=str(bk),
             host_ms=io_ms)
        require_launched(launches, ("matmul_stats", "matmul_stats_wgmma"),
                         "ImageNet folder train (amp)")
        require_launched(launches_epoch, ("matmul_stats", "matmul_stats_wgmma"),
                         "ImageNet folder train epoch (amp)")
        want_stats = {"offload": kinds["train"]["files"] - kinds["train"]["cmyk"]
                      - kinds["train"]["exif"], "reencode_fallback": kinds["train"]["cmyk"],
                      "exif_reorient": kinds["train"]["exif"], "dropped": 0}
        if (stats_alone != want_stats or stats != want_stats
                or n != kinds["train"]["files"] or n_step != n
                or not all(math.isfinite(v) for v in losses) or rel > FOLDER_FIRST_LOSS_TOL):
            raise RuntimeError(f"imagenet_folder_train: stats {stats} (want {want_stats}), "
                               f"{n} images, losses {losses}, first loss off by {rel}")
        del model, optimizer, step, ref, first
        torch.cuda.empty_cache()

        # (b) the loader (eval) feeding the bf16 model
        model32 = get_model("resnet50", seed=0)
        model16 = get_model("resnet50", seed=0).to(torch.bfloat16)
        cpu50 = get_model("resnet50", seed=0, device="cpu")
        eval_loader = DeviceJpegLoader(val_ds.samples, FOLDER_BATCH, FOLDER_CROP,
                                       train=False)
        cpu_loader = DeviceJpegLoader(val_ds.samples, FOLDER_BATCH, FOLDER_CROP,
                                      train=False, device="cpu")
        with torch.inference_mode():
            card_first = next(iter(eval_loader))
            cpu_first = next(iter(cpu_loader))
            input_err = float((card_first["image"].cpu() - cpu_first["image"]).abs().max())
            input_tol = PRESET_INPUT_TOL
            x = card_first["image"][:FOLDER_CHECKED]
            check = check_logits("imagenet_folder_eval", x, x.cpu(), model32, cpu50,
                                 model16)
            outs = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in eval_loader:
                outs.append(model16(b["image"].to(torch.bfloat16)))
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            n_eval, eval_batches = sum(o.shape[0] for o in outs), len(outs)
        val_want = kinds["val"]["cmyk"] + kinds["val"]["png"]
        emit("imagenet_folder_eval", batch=FOLDER_BATCH, images=n_eval,
             batches=eval_batches, buckets_per_epoch=len(eval_loader.buckets),
             stats=eval_loader.stats, images_per_s=n_eval / eval_s,
             input_vs_cpu_loader_max_abs_err=input_err, input_tol=input_tol,
             labels_equal=bool((card_first["label"].cpu() == cpu_first["label"]).all()),
             logits_finite=all(bool(torch.isfinite(o).all()) for o in outs), **check)
        if (input_err > input_tol or eval_loader.stats["dropped"]
                or eval_loader.stats["reencode_fallback"] != val_want
                or n_eval != kinds["val"]["files"]
                or not all(bool(torch.isfinite(o).all()) for o in outs)):
            raise RuntimeError(f"imagenet_folder_eval: input off the CPU loader's by "
                               f"{input_err}, stats {eval_loader.stats}, {n_eval} images")
        del cpu50, model32

        # (c) ImageFolder + DataLoader + read_image + the preset, on threads
        weights = ResNet50_Weights.DEFAULT
        host_ds = ImageFolder(os.path.join(tmp.name, "val"),
                              transform=weights.transforms(device="cpu"))
        dl = DataLoader(host_ds, batch_size=FOLDER_BATCH, num_workers=decode_threads())
        t0 = time.perf_counter()
        n_host, finite, first_x = 0, True, None
        with torch.inference_mode():
            for xb, yb in dl:
                logits = model16(xb.to(cuda, non_blocking=True).to(torch.bfloat16))
                finite = finite and bool(torch.isfinite(logits).all())
                n_host += yb.shape[0]
                if first_x is None:
                    first_x = xb
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            raw = [read_image_card(p) for p, _ in host_ds.samples[:FOLDER_CHECKED]]
            x_card = torch.stack([weights.transforms()(r) for r in raw]).cpu()
        preset_err = float((x_card - first_x[:FOLDER_CHECKED]).abs().max())
        emit("imagenet_folder_host", images=n_host, png=kinds["val"]["png"],
             images_per_s=n_host / host_s, workers=decode_threads(),
             card_preset_vs_cpu_preset_max_abs_err=preset_err, logits_finite=finite)
        if n_host != kinds["val"]["files"] or not finite or not preset_err <= PRESET_INPUT_TOL:
            raise RuntimeError(f"imagenet_folder_host: {n_host} images, finite {finite}, "
                               f"the card's preset off the CPU's by {preset_err}")
    finally:
        tmp.cleanup()




def read_image_card(path):
    """The file decoded on the host (CMYK streams decode there only), on
    the card."""
    from vision_tpu_torch.io import ImageReadMode, read_image
    from vision_tpu_torch.models._api import resolve_device

    return read_image(path, ImageReadMode.RGB, device="cpu").to(resolve_device(None))


def require_only(launches: dict, name: str, want: int, what: str) -> None:
    """Every ``matmul_stats`` call of the run went to kernel ``name``."""
    got = {n: launches[n] for n in ("matmul_stats", "matmul_stats_fma",
                                    "matmul_stats_wgmma", "matmul_stats_general")}
    if got["matmul_stats"] != want or got[name] != want:
        raise RuntimeError(f"{what}: expected {want} matmul_stats launches, "
                           f"all through {name}, got {got}")
    if got["matmul_stats_general"] != 0:
        raise RuntimeError(f"{what}: the ResNet-50 path launched the general "
                           f"kernel: {got}")


def general_kernel_phase(kernels, batch, first_loss) -> int:
    """One f32 SGD step with the general kernel's wrapper in the place of
    the choosing one: all 36 products through the guarded kernel of
    ``matmul_stats.cu``, the loss within 1e-3 of the default path's first."""
    general = kernels.counted["matmul_stats_general"]
    kernels.reset()
    with kernels.swapped(lambda name, fn: general if name == "matmul_stats" else fn):
        run = train_steps(batch, fused=True, dtype=None, steps=1)
    launches = kernels.launches()
    rel = abs(run["losses"][0] - first_loss) / abs(first_loss)
    emit("resnet50_train_general_kernel", steps=1, batch=BATCH,
         loss=run["losses"][0], default_path_loss=first_loss, loss_rel_err=rel,
         loss_tol=1e-3, launches=launches)
    require_launched(launches, ("matmul_stats_general",),
                     "ResNet-50 train (general kernel)")
    if (launches["matmul_stats_general"] != MM_CALLS_PER_FORWARD
            or launches["matmul_stats_fma"] or launches["matmul_stats_wgmma"]):
        raise RuntimeError(f"the forced general step launched {launches}")
    if not rel <= 1e-3:
        raise RuntimeError("the general kernel's step disagrees with the "
                           "default path's")
    return launches["matmul_stats_general"]


def fro_errs(got, want) -> float:
    """``|got - want| / |want|`` in the Frobenius norm, in f64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-300))


def rel_errs(got, want):
    return [float((g.float() - w.float()).abs().max()
                  / w.float().abs().max().clamp(min=1e-30))
            for g, w in zip(got, want)]


def matmul_stats_rows(kernels, calls, counts, calls16, counts16, launches):
    """The three ``matmul_stats`` kernels against the plain version at every
    distinct (shapes, prologue, type) the two train runs gave the wrapper:
    the f32 cases through the FP32 kernel, the bf16 cases through the
    ``wgmma`` kernel, and the general kernel at all of them. ``y`` within
    1e-4 of its largest value in f32 and within one bf16 step in bf16 (a
    step is 2**-8 to 2**-7 of the value it rounds, so 2**-7 of the largest);
    the sums within 1e-4 of their largest; a second call on the same inputs
    equal to the first bit for bit.

    Times per forward: each case's time multiplied by its calls in one
    forward. ``ms`` is the median of single wrapper calls (Python, the
    allocations and the launch latency included), ``device_ms`` a run of 20
    calls back to back over 20, taken in turns with the general kernel's
    (new, general, general, new). ``product_ms`` is one ``torch.matmul`` of
    the same operands: a reference that computes less (no prologue, no
    sums), so it is no ``library_ms``."""
    import torch

    from vision_tpu_torch.ops._conv1x1_bn import choose_kernel

    plain = kernels.plain["matmul_stats"]
    general = kernels.counted["matmul_stats_general"]
    keys = ("ms", "device_ms", "general_ms", "general_device_ms", "plain_ms",
            "product_ms", "bound_ms", "bytes", "operations")
    totals = {}
    worst = {"fma": 0.0, "wgmma": 0.0, "general_f32": 0.0, "general_bf16": 0.0}
    slower = []
    for tag, name, recorded, count in (("f32", "fma", calls, counts),
                                       ("bf16", "wgmma", calls16, counts16)):
        fn = kernels.counted[f"matmul_stats_{name}"]
        y_tol = 1e-4 if tag == "f32" else 2.0 ** -7
        sums = dict.fromkeys(keys, 0.0)
        for args in recorded["matmul_stats"]:
            key = matmul_key(args)
            x, w = args[:2]
            chosen = choose_kernel(x.shape[0], x.shape[1], w.shape[1], x.dtype,
                                   w.stride())
            if chosen != name:
                raise RuntimeError(f"matmul_stats {key} goes to {chosen}")
            got, again, want = fn(*args), fn(*args), plain(*args)
            got_g = general(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            rel, rel_g = rel_errs(got, want), rel_errs(got_g, want)
            err = float((got[0].float() - want[0].float()).abs().max())
            err_g = float((got_g[0].float() - want[0].float()).abs().max())
            t = dict(
                ms=cuda_ms(lambda: fn(*args)),
                general_ms=cuda_ms(lambda: general(*args)),
                plain_ms=cuda_ms(lambda: plain(*args), reps=5, warmup=1),
                product_ms=device_ms(lambda: torch.matmul(x, w)))
            turns = [device_ms(f) for f in (
                lambda: fn(*args), lambda: general(*args),
                lambda: general(*args), lambda: fn(*args))]
            t["device_ms"] = (turns[0] + turns[3]) / 2
            t["general_device_ms"] = (turns[1] + turns[2]) / 2
            b_ms, b_by = bound_ms(*matmul_work(args))
            emit("kernel_case", kernel=f"matmul_stats_{name}", x=list(key[0]),
                 w=list(key[1]), w_strides=list(w.stride()), prologue=key[2],
                 dtype=tag, calls_per_forward=count[key], max_abs_err=err,
                 y_rel_err=rel[0], y_tol=y_tol, s1_rel_err=rel[1],
                 s2_rel_err=rel[2], s_tol=1e-4, same_bits_twice=same,
                 general_y_rel_err=rel_g[0], general_s1_rel_err=rel_g[1],
                 general_s2_rel_err=rel_g[2], **t, bound_ms=b_ms,
                 bound_by=b_by, products_by=product_peak(x)[1])
            if rel[0] > y_tol or max(rel[1:]) > 1e-4:
                raise RuntimeError(f"matmul_stats_{name} {key} disagrees with "
                                   f"its plain version: {rel}")
            if rel_g[0] > y_tol or max(rel_g[1:]) > 1e-4:
                raise RuntimeError(f"the general matmul_stats kernel {key} "
                                   f"disagrees with its plain version: {rel_g}")
            if not same:
                raise RuntimeError(f"matmul_stats_{name} {key}: two calls on "
                                   "the same inputs differ")
            if t["device_ms"] > 1.1 * t["general_device_ms"]:
                slower.append([tag, list(key[0]), list(key[1])])
            worst[name] = max(worst[name], err)
            worst[f"general_{tag}"] = max(worst[f"general_{tag}"], err_g)
            for k, v in t.items():
                sums[k] += count[key] * v
            sums["bound_ms"] += count[key] * b_ms
            sums[b_by] += count[key] * b_ms
        totals[tag] = sums
    f32, bf16 = totals["f32"], totals["bf16"]
    emit("matmul_stats_totals", per_forward_ms=totals,
         cases_over_10pct_slower_than_general=slower)
    if bf16["device_ms"] >= bf16["general_device_ms"]:
        raise RuntimeError("the wgmma kernel is no faster than the general one")
    if f32["device_ms"] >= f32["general_device_ms"]:
        raise RuntimeError("the FP32 kernel is no faster than the general one")

    def row(name, source, sums, n_launches, err, **extra):
        by = "bytes" if sums["bytes"] >= sums["operations"] else "operations"
        return {
            "name": name, "route": "cuda",
            "source": f"vision_tpu_torch/csrc/{source}",
            "replaces": "vision_tpu/ops/_pallas/conv1x1_bn.py:134",
            "launches": n_launches, "max_abs_err": err,
            "ms": sums["ms"], "plain_ms": sums["plain_ms"],
            "bound_ms": sums["bound_ms"], "bound_by": by, "library_ms": None,
            "device_ms": sums["device_ms"], "product_ms": sums["product_ms"],
            "calls_per_forward": sum(counts.values()), **extra,
        }

    general_f32 = dict(f32, ms=f32["general_ms"],
                       device_ms=f32["general_device_ms"])
    f32_by = product_peak(torch.empty(0))[1]
    return [
        row("matmul_stats_fma", "matmul_stats_fma.cu", f32, launches["fma"],
            worst["fma"], dtype="float32", products_by=f32_by,
            general_ms=f32["general_ms"],
            general_device_ms=f32["general_device_ms"],
            distinct_cases=len(calls["matmul_stats"])),
        row("matmul_stats_wgmma", "matmul_stats_wgmma.cu", bf16,
            launches["wgmma"], worst["wgmma"], dtype="bfloat16",
            general_ms=bf16["general_ms"],
            general_device_ms=bf16["general_device_ms"],
            distinct_cases=len(calls16["matmul_stats"])),
        # the guarded kernel, at the f32 cases (its bf16 times beside them)
        row("matmul_stats", "matmul_stats.cu", general_f32,
            launches["general"], worst["general_f32"], dtype="float32",
            products_by=f32_by,
            max_abs_err_bf16=worst["general_bf16"],
            ms_bf16=bf16["general_ms"], device_ms_bf16=bf16["general_device_ms"],
            plain_ms_bf16=bf16["plain_ms"], bound_ms_bf16=bf16["bound_ms"]),
    ]


def check_detections(dets, ref, batch=1, score_tol=1e-4, box_tol=1e-2,
                     phase="faster_rcnn", per_image=100,
                     box_rel_tol=0.0) -> None:
    """``dets`` against ``ref`` row by row: the same valid rows and labels,
    scores within ``score_tol``, each box coordinate within ``box_tol``
    plus ``box_rel_tol`` of the reference box's extent along its axis."""
    import torch

    for t in dets:
        if not torch.isfinite(t.float()).all():
            raise RuntimeError("non-finite detections")
    if (tuple(dets.boxes.shape) != (batch, per_image, 4)
            or tuple(dets.valid.shape) != (batch, per_image)):
        raise RuntimeError(f"bad Detections shapes {tuple(dets.boxes.shape)}")
    valid = dets.valid
    n_valid = int(valid.sum())
    same_valid = bool(torch.equal(valid, ref.valid))
    label_ok = bool(torch.equal(dets.labels[valid], ref.labels[valid]))
    score_err = float((dets.scores[valid] - ref.scores[valid]).abs().max()) if n_valid else 0.0
    box_err = float((dets.boxes[valid] - ref.boxes[valid]).abs().max()) if n_valid else 0.0
    fields = {}
    if box_rel_tol and n_valid:
        rb = ref.boxes[valid].float()
        extent = (rb[:, 2:] - rb[:, :2]).repeat(1, 2)  # w, h, w, h
        allowed = box_tol + box_rel_tol * extent
        ratio = float(((dets.boxes[valid].float() - rb).abs() / allowed).max())
        fields = dict(box_rel_tol=box_rel_tol, max_box_err_over_allowed=ratio)
        box_err, box_tol = ratio, 1.0
    emit("detections_vs_plain", path=phase, valid=n_valid,
         valid_per_image=valid.sum(1).tolist(), same_valid=same_valid,
         labels_equal=label_ok, max_score_err=score_err, score_tol=score_tol,
         max_box_err=box_err, box_tol=box_tol, **fields)
    if int(valid.sum(1).min()) == 0:
        raise RuntimeError("an image without valid detections: the comparison "
                           "is vacuous")
    if not (same_valid and label_ok and score_err <= score_tol
            and box_err <= box_tol):
        raise RuntimeError(f"{phase}: kernel path disagrees with the plain path")


ZOO_CPU_IMAGES = 2  # the images held against the CPU
ZOO_LOGITS_TOL = 1e-4  # f32 logits on the card against the CPU's, of the largest
ZOO_AMP_LOGITS_TOL = 2e-2  # bf16 logits against f32, of the largest
ZOO_CPU_BATCH = 4  # the f32 step held against the CPU
ZOO_LOSS_TOL = 1e-4  # step 1's loss on the card against the CPU, relative
ZOO_GRAD_TOL = 1e-3  # all gradients together, by relative Frobenius norm
# step 1's ReLU inputs on the other side of 0 on the CPU than on the card
# (the CPU's step takes the card's sides: tools/zoo.py:step_against_cpu)
ZOO_RELU_SWITCHED_TOL = 1e-4
ZOO_AMP_LOSS_TOL = 5e-2  # amp step 1's loss against the f32 step's
ZOO_STEPS = 3  # timed steps after the first
ZOO_SEED = 7  # the CUDA generator's seed for the stochastic layers
# no stochastic layer: the f32 step held against the CPU
ZOO_QUIET = {"efficientnet_v2_s": {"stochastic_depth_prob": 0.0, "dropout": 0.0},
             "convnext_tiny": {"stochastic_depth_prob": 0.0},
             "swin_t": {"stochastic_depth_prob": 0.0}}
ZOO_SWEEP_BATCH = 8
ZOO_SWEEP_CPU_TOL = 1e-4  # one image on the card against the CPU, of the largest
# one builder a family held against the CPU (tests/test_models_golden.py's
# families, and the others)
ZOO_SWEEP_CPU = ("mobilenet_v3_small", "efficientnet_b0", "shufflenet_v2_x0_5",
                 "squeezenet1_1", "densenet121", "regnet_y_400mf", "alexnet",
                 "vgg11_bn", "googlenet", "inception_v3", "mnasnet0_5",
                 "mobilenet_v2", "maxvit_t")
ZOO_FAMILIES = ("efficientnet", "convnext", "swin_transformer", "mobilenetv2",
                "mobilenetv3", "mnasnet", "regnet", "maxvit", "shufflenetv2",
                "squeezenet", "alexnet", "vgg", "densenet", "googlenet",
                "inception")


def rel_err(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def num_params(name: str) -> int:
    """The default weights' parameter count (JAX's meta)."""
    from vision_tpu_torch.models import get_model_weights

    return get_model_weights(name).DEFAULT.meta["num_params"]


def zoo_forward_phases() -> None:
    """``zoo_forward`` / ``_amp``: the JAX bench's zoo cells
    (``bench.py:_bench_zoo_fwd``) served at full width in f32 and bf16 (the
    batch norms' statistics kept f32, ``tools/zoo.py:to_bf16``):
    ms a batch and img/s (median of 5 after a warm-up), the f32 logits of 2
    images against the same model on the CPU, the bf16 logits against the
    f32 ones, the achieved TFLOP/s from the cell's GMACs beside the card's
    dense peak for the type."""
    import torch

    from vision_tpu_torch.tools import zoo

    device = torch.cuda.get_device_name(0)
    for name, (size, batch) in zoo.CELLS.items():
        model = zoo.seeded_model(name, size)
        params = sum(p.numel() for p in model.parameters())
        cpu_model = copy.deepcopy(model).cpu()
        x = zoo.images(batch, size)
        flops = 2 * zoo.gmacs(name) * 1e9 * batch
        with torch.inference_mode():
            logits = model(x)
            err = rel_err(logits[:ZOO_CPU_IMAGES],
                          cpu_model(x[:ZOO_CPU_IMAGES].cpu()))
            del cpu_model
            ms, ms_all = host_ms(lambda: model(x))
            emit("zoo_forward", model=name, device=device, params=params,
                 dtype="float32", batch=batch, image_size=size,
                 ms_per_batch=ms, images_per_s=batch / ms * 1e3, ms_all=ms_all,
                 logits_vs_cpu_rel_err=err, tol=ZOO_LOGITS_TOL,
                 tflops=flops / ms / 1e9, peak_tflops=PEAK_F32_FLOPS / 1e12,
                 logits_std=float(logits.std()))
            if params != num_params(name) or not err <= ZOO_LOGITS_TOL or not \
                    bool(torch.isfinite(logits).all()):
                raise RuntimeError(f"zoo_forward {name}: wrong parameter "
                                   "count, or logits off the CPU's or not "
                                   "finite")
            model16, x16 = zoo.to_bf16(model), x.to(torch.bfloat16)
            err16 = rel_err(model16(x16).float(), logits)
            ms, ms_all = host_ms(lambda: model16(x16))
            emit("zoo_forward_amp", model=name, device=device,
                 dtype="bfloat16", batch=batch, image_size=size,
                 ms_per_batch=ms, images_per_s=batch / ms * 1e3, ms_all=ms_all,
                 logits_vs_f32_rel_err=err16, tol=ZOO_AMP_LOGITS_TOL,
                 tflops=flops / ms / 1e9, peak_tflops=PEAK_BF16_FLOPS / 1e12)
            if not err16 <= ZOO_AMP_LOGITS_TOL:
                raise RuntimeError(f"zoo_forward_amp {name}: bf16 logits off "
                                   "the f32 ones")
        del model, model16, x, x16, logits
        torch.cuda.empty_cache()


def step_check(make, step_of, batch_of) -> dict:
    """``tools/zoo.py:step_against_cpu`` with its tolerances: step 1's loss
    ``ZOO_LOSS_TOL``, all gradients ``ZOO_GRAD_TOL`` by relative Frobenius
    norm, the CPU's ReLU inputs on the other side of 0 from the card's at
    most ``ZOO_RELU_SWITCHED_TOL`` of them; ``ok`` if all hold."""
    from vision_tpu_torch.tools import zoo

    check = zoo.step_against_cpu(make, step_of, batch_of)
    check.update(loss_tol=ZOO_LOSS_TOL, grad_tol=ZOO_GRAD_TOL,
                 relu_switched_tol=ZOO_RELU_SWITCHED_TOL)
    check["ok"] = (check["loss_vs_cpu_rel_err"] <= ZOO_LOSS_TOL
                   and check["grads_vs_cpu_frobenius_rel_err"] <= ZOO_GRAD_TOL
                   and check["relu_switched_share"] <= ZOO_RELU_SWITCHED_TOL)
    return check


def timed_steps(call) -> tuple:
    """Step 1 (``call()``, a loss), then ``ZOO_STEPS`` steps: step 1's
    loss, the steps' wall ms (each with its loss read back) and losses."""
    import torch

    loss1 = float(call())
    torch.cuda.synchronize()
    times, losses = [], []
    for _ in range(ZOO_STEPS):
        t = time.perf_counter()
        losses.append(float(call()))
        times.append((time.perf_counter() - t) * 1e3)
    return loss1, times, losses


def zoo_train_phases() -> None:
    """``zoo_train`` / ``_amp``: the same three models trained by SGD at
    batch 32 at their sizes. f32: step 1 with no stochastic layer held
    against the CPU (at batch 4, ``step_check``); then the default
    stochastic depth and dropout, drawn from a CUDA generator: the same
    seed gives the same step-1 loss twice; 3 timed steps (ms/step, img/s,
    peak GB). amp: the same from the same weights and seed in bf16, its
    step-1 loss within ``ZOO_AMP_LOSS_TOL`` of the f32 one."""
    import torch

    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.tools import zoo

    device = torch.cuda.get_device_name(0)
    card = resolve_device(None)
    for name, (size, _) in zoo.CELLS.items():
        check = step_check(
            lambda: zoo.seeded_model(name, size, **ZOO_QUIET[name]),
            zoo.sgd_step, lambda dev: zoo.batch_of(ZOO_CPU_BATCH, size, 1, dev))
        torch.cuda.empty_cache()
        batch = zoo.batch_of(zoo.TRAIN_BATCH, size, 2)
        f32_loss = None
        for phase, dtype in (("zoo_train", None),
                             ("zoo_train_amp", torch.bfloat16)):
            model = zoo.seeded_model(name, size)
            twin = copy.deepcopy(model) if dtype is None else None
            torch.cuda.reset_peak_memory_stats()
            step = zoo.sgd_step(model, dtype)
            gen = torch.Generator(device=card).manual_seed(ZOO_SEED)
            loss1, times, losses = timed_steps(
                lambda: step(batch, gen)["loss"])
            ms = statistics.median(times)
            fields = dict(model=name, device=device, image_size=size,
                          dtype="float32" if dtype is None else "bfloat16",
                          batch=zoo.TRAIN_BATCH, ms_per_step=ms,
                          images_per_s=zoo.TRAIN_BATCH / ms * 1e3,
                          ms_all=times, step1_loss=loss1, losses=losses,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            ok = all(math.isfinite(v) for v in [loss1] + losses)
            if dtype is None:
                again = float(zoo.sgd_step(twin)(batch, torch.Generator(
                    device=card).manual_seed(ZOO_SEED))["loss"])
                fields.update(check, step1_loss_same_seed_again=again)
                ok = ok and again == loss1 and check["ok"]
                f32_loss = loss1
            else:
                err = abs(loss1 - f32_loss) / abs(f32_loss)
                fields.update(loss_vs_f32_rel_err=err, loss_tol=ZOO_AMP_LOSS_TOL)
                ok = ok and err <= ZOO_AMP_LOSS_TOL
            emit(phase, **fields)
            if not ok:
                raise RuntimeError(f"{phase} {name}: step 1 off its reference, "
                                   "not the same for the same seed, or a loss "
                                   "not finite")
            del model, twin, step
            torch.cuda.empty_cache()


def zoo_sweep_phase() -> None:
    """``zoo_sweep``: every other builder of the fifteen families, built on
    the card at full width (its parameter count its meta's), its batch
    norms calibrated, a batch of 8 at its eval size in f32: finite logits;
    one builder a family (``ZOO_SWEEP_CPU``) held against the CPU on one
    image. Each model is freed before the next."""
    import torch

    from vision_tpu_torch.models import get_model_weights, list_models
    from vision_tpu_torch.models._api import _MODELS
    from vision_tpu_torch.models._utils import eval_size
    from vision_tpu_torch.tools import zoo

    device = torch.cuda.get_device_name(0)
    families = {f"vision_tpu_torch.models.{f}" for f in ZOO_FAMILIES}
    names = [n for n in list_models() if n not in zoo.CELLS and
             _MODELS[n].__module__ in families]
    failed = []
    for name in names:
        t0 = time.perf_counter()
        weights = get_model_weights(name).DEFAULT
        size = eval_size(weights)
        model = zoo.seeded_model(name, size)
        params = sum(p.numel() for p in model.parameters())
        x = zoo.images(ZOO_SWEEP_BATCH, size, 3)
        with torch.inference_mode():
            logits = model(x)
            fields = dict(model=name, device=device, image_size=size,
                          batch=ZOO_SWEEP_BATCH, params=params,
                          finite=bool(torch.isfinite(logits).all()),
                          shape=list(logits.shape))
            ok = (params == weights.meta["num_params"] and fields["finite"]
                  and fields["shape"] == [ZOO_SWEEP_BATCH, 1000])
            if name in ZOO_SWEEP_CPU:
                cpu_model = copy.deepcopy(model).cpu()
                err = rel_err(logits[:1], cpu_model(x[:1].cpu()))
                fields.update(logits_vs_cpu_rel_err=err, tol=ZOO_SWEEP_CPU_TOL)
                ok = ok and err <= ZOO_SWEEP_CPU_TOL
                del cpu_model
        emit("zoo_sweep", seconds=time.perf_counter() - t0, ok=ok, **fields)
        if not ok:
            failed.append(name)
        del model, x, logits
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f"zoo_sweep: wrong parameter count, logits not "
                           f"finite or off the CPU's: {failed}")
    emit("zoo_sweep_done", builders=len(names))


def zoo_phases(kernels) -> None:
    """The classification zoo: the JAX bench's three zoo cells served and
    trained, then every other builder of the families once. No kernel of
    the repo's is on these paths: the launch counts, set to 0 before them,
    are printed after them and must still read 0."""
    kernels.reset()
    zoo_forward_phases()
    zoo_train_phases()
    zoo_sweep_phase()
    launches = kernels.launches()
    emit("zoo_launches", launches=launches)
    if any(launches.values()):
        raise RuntimeError(f"zoo: kernels launched on a path that has none: "
                           f"{launches}")


# the segmentation step held against the CPU: crop, batch (at batch 2,
# ASPP's pooled 1x1 map normalised over the batch is +-1 whatever its
# input, and rounding alone sets its gradient: 1.2e-3 of the whole on the
# CPU against f64, 8e-5 at batch 8; tools/step_gap.py)
DENSE_SEG_CPU = (240, 8)
DENSE_FLOW_CPU_SIZE = (256, 320)  # the flow step held against the CPU
DENSE_SWEEP_BATCH = 2
# one builder a kind held against the CPU
DENSE_SWEEP_CPU = ("lraspp_mobilenet_v3_large", "raft_small", "r2plus1d_18")
DENSE_FAMILIES = ("segmentation", "optical_flow", "video")


def cuda_trace(fn, reps: int = 1) -> dict:
    """``reps`` calls of ``fn`` under ``torch.profiler`` (CUDA activity):
    the CUDA kernels launched, their summed device ms, and the wall ms
    (the trace's own cost counts in it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"kernels": sum(e.count for e in cuda), "wall_ms": wall,
            "device_ms": sum(float(getattr(e, "self_device_time_total", 0.0))
                             for e in cuda) / 1e3}


def dense_forward_phases() -> None:
    """``dense_forward`` / ``_amp``: the JAX bench's dense and video cells
    (``bench.py:_bench_zoo_fwd``) served at full width in f32 and bf16 (the
    batch norms' statistics kept f32): DeepLabV3-ResNet-50 at 520x520 batch
    4 (its ``out`` logits), RAFT-large on 512x512 pairs batch 2 with 12 flow
    updates (the last flow), MViT-V2-S and Swin3D-T on 16x224x224 clips
    batch 4. ms a batch and samples a second (median of 5 after a warm-up),
    TFLOP/s from the cell's GMACs beside the card's peak, f32 device ms a
    batch (queued behind a spin kernel), the busy share (device over wall)
    and the kernels a forward; the f32 output of one sample against the
    same model on the CPU, bf16 against f32."""
    import torch

    from vision_tpu_torch.tools import dense

    device = torch.cuda.get_device_name(0)
    for name, (size, batch) in dense.CELLS.items():
        model = dense.seeded_model(name, size)
        params = sum(p.numel() for p in model.parameters())
        cpu_model = copy.deepcopy(model).cpu()
        args = dense.inputs(name, batch, size)
        flops = 2 * dense.gmacs(name) * 1e9 * batch
        with torch.inference_mode():
            out = dense.serve(model, name, args)
            err = rel_err(out[:1], dense.serve(cpu_model, name, tuple(
                a[:1].cpu() for a in args)))
            del cpu_model
            ms, ms_all = host_ms(lambda: dense.serve(model, name, args))
            dev_ms = device_ms(lambda: dense.serve(model, name, args),
                               launches=3, warmup=1)
            launches = cuda_trace(
                lambda: dense.serve(model, name, args))["kernels"]
            emit("dense_forward", model=name, device=device, params=params,
                 jax_num_params=num_params(name), dtype="float32",
                 batch=batch, size=size, ms_per_batch=ms,
                 samples_per_s=batch / ms * 1e3, ms_all=ms_all,
                 device_ms_per_batch=dev_ms, busy_share=dev_ms / ms,
                 kernel_launches_per_batch=launches,
                 out_vs_cpu_rel_err=err, tol=ZOO_LOGITS_TOL,
                 tflops=flops / ms / 1e9, peak_tflops=PEAK_F32_FLOPS / 1e12,
                 out_std=float(out.float().std()))
            if params != num_params(name) or not err <= ZOO_LOGITS_TOL \
                    or not bool(torch.isfinite(out).all()):
                raise RuntimeError(f"dense_forward {name}: wrong parameter "
                                   "count, or output off the CPU's or not "
                                   "finite")
            model16 = dense.to_bf16(model)
            args16 = tuple(a.to(torch.bfloat16) for a in args)
            err16 = rel_err(dense.serve(model16, name, args16).float(), out)
            ms, ms_all = host_ms(lambda: dense.serve(model16, name, args16))
            dev_ms = device_ms(lambda: dense.serve(model16, name, args16),
                               launches=3, warmup=1)
            emit("dense_forward_amp", model=name, device=device,
                 dtype="bfloat16", batch=batch, size=size, ms_per_batch=ms,
                 samples_per_s=batch / ms * 1e3, ms_all=ms_all,
                 device_ms_per_batch=dev_ms, busy_share=dev_ms / ms,
                 out_vs_f32_rel_err=err16, tol=ZOO_AMP_LOGITS_TOL,
                 tflops=flops / ms / 1e9, peak_tflops=PEAK_BF16_FLOPS / 1e12)
            if not err16 <= ZOO_AMP_LOGITS_TOL:
                raise RuntimeError(f"dense_forward_amp {name}: bf16 output "
                                   "off the f32 one")
        del model, model16, args, args16, out
        torch.cuda.empty_cache()


def dense_train_line(phase, name, call, size, batch, check=None,
                     f32_loss=None) -> float:
    """``timed_steps(call)``; one line with ms a step, samples a second and
    the peak memory; ``check`` (``step_check``) or ``f32_loss`` (the amp
    step 1's reference, within ``ZOO_AMP_LOSS_TOL``) gate it. Returns step
    1's loss."""
    import torch

    loss1, times, losses = timed_steps(call)
    ms = statistics.median(times)
    fields = dict(model=name, device=torch.cuda.get_device_name(0),
                  size=size, batch=batch, ms_per_step=ms,
                  samples_per_s=batch / ms * 1e3, ms_all=times,
                  step1_loss=loss1, losses=losses,
                  peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    ok = all(math.isfinite(v) for v in [loss1] + losses)
    if check is not None:
        fields.update(check)
        ok = ok and check["ok"]
    if f32_loss is not None:
        err = abs(loss1 - f32_loss) / abs(f32_loss)
        fields.update(loss_vs_f32_rel_err=err, loss_tol=ZOO_AMP_LOSS_TOL)
        ok = ok and err <= ZOO_AMP_LOSS_TOL
    emit(phase, **fields)
    if not ok:
        raise RuntimeError(f"{phase} {name}: step 1 off its reference or a "
                           "loss not finite")
    return loss1


def dense_train_phases() -> None:
    """``seg_train`` / ``_amp``: DeepLabV3-ResNet-50 trained at the JAX
    recipe's size (480x480 crops, batch 8, 21 classes, seeded targets with
    255-ignored pixels; SGD lr 0.01, momentum 0.9, weight decay 1e-4), f32
    then bf16 amp; step 1 with the heads' dropout off held against the CPU
    on ``DENSE_SEG_CPU`` (240x240 crops, batch 8; ``step_check``), the
    dropout then drawn from a CUDA generator, the amp step 1's loss within
    ``ZOO_AMP_LOSS_TOL`` of the f32 one. ``raft_train``: RAFT-large at
    batch 2, 12 flow updates, on 368x496 pairs (torchvision's FlyingChairs
    crop), AdamW lr 4e-4, weight decay 1e-4, every gradient clipped to
    [-1, 1], f32; step 1 held against the CPU on 256x320 pairs."""
    import torch

    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.tools import dense

    card = resolve_device(None)
    name = "deeplabv3_resnet50"
    size, batch = dense.SEG_TRAIN
    check = step_check(
        lambda: dense.seeded_model(name, size, aspp_dropout=0.0,
                                   head_dropout=0.0),
        dense.seg_step, lambda dev: dense.seg_batch(
            DENSE_SEG_CPU[1], DENSE_SEG_CPU[0], 1, dev))
    torch.cuda.empty_cache()
    data = dense.seg_batch(batch, size, 2)
    f32_loss = None
    for phase, dtype in (("seg_train", None), ("seg_train_amp", torch.bfloat16)):
        model = dense.seeded_model(name, size)
        torch.cuda.reset_peak_memory_stats()
        step = dense.seg_step(model, dtype)
        gen = torch.Generator(device=card).manual_seed(ZOO_SEED)
        loss1 = dense_train_line(
            phase, name, lambda: step(data, gen)["loss"], size, batch,
            check=check if dtype is None else None, f32_loss=f32_loss)
        f32_loss = loss1 if dtype is None else f32_loss
        del model, step
        torch.cuda.empty_cache()
    del data

    name = "raft_large"
    size, batch = dense.FLOW_TRAIN
    check = step_check(
        lambda: dense.seeded_model(name, size), dense.flow_step,
        lambda dev: dense.flow_batch(batch, DENSE_FLOW_CPU_SIZE, 1, dev))
    torch.cuda.empty_cache()
    data = dense.flow_batch(batch, size, 2)
    model = dense.seeded_model(name, size)
    torch.cuda.reset_peak_memory_stats()
    step = dense.flow_step(model)
    dense_train_line("raft_train", name, lambda: step(data)["loss"],
                     list(size), batch, check=check)
    del model, step, data
    torch.cuda.empty_cache()


def dense_sweep_phase() -> None:
    """``dense_sweep``: every other builder of segmentation, optical flow
    and video, built on the card at full width (its parameter count its
    meta's), served once in f32 at batch 2: segmentation at 520x520, RAFT
    on 512x512 pairs (12 updates), video on 16-frame clips at its preset's
    crop; the output finite and of its shape; ``DENSE_SWEEP_CPU`` held
    against the CPU on one sample. Each model is freed before the next."""
    import torch

    from vision_tpu_torch.models import list_models
    from vision_tpu_torch.models._api import _MODELS
    from vision_tpu_torch.tools import dense

    device = torch.cuda.get_device_name(0)
    names = [n for n in list_models() if n not in dense.CELLS and
             _MODELS[n].__module__.split(".")[2] in DENSE_FAMILIES]
    failed = []
    for name in names:
        t0 = time.perf_counter()
        size = dense.default_size(name)
        model = dense.seeded_model(name, size)
        params = sum(p.numel() for p in model.parameters())
        args = dense.inputs(name, DENSE_SWEEP_BATCH, size, 3)
        kind = dense.kind(name)
        side = size if kind != "video" else size[1]
        want_shape = {"segmentation": [DENSE_SWEEP_BATCH, 21, side, side],
                      "flow": [DENSE_SWEEP_BATCH, 2, side, side],
                      "video": [DENSE_SWEEP_BATCH, 400]}[kind]
        with torch.inference_mode():
            out = dense.serve(model, name, args)
            fields = dict(model=name, device=device, size=size,
                          batch=DENSE_SWEEP_BATCH, params=params,
                          finite=bool(torch.isfinite(out).all()),
                          shape=list(out.shape))
            ok = (params == num_params(name) and fields["finite"]
                  and fields["shape"] == want_shape)
            if name in DENSE_SWEEP_CPU:
                cpu_model = copy.deepcopy(model).cpu()
                err = rel_err(out[:1], dense.serve(cpu_model, name, tuple(
                    a[:1].cpu() for a in args)))
                fields.update(out_vs_cpu_rel_err=err, tol=ZOO_LOGITS_TOL)
                ok = ok and err <= ZOO_LOGITS_TOL
                del cpu_model
        emit("dense_sweep", seconds=time.perf_counter() - t0, ok=ok, **fields)
        if not ok:
            failed.append(name)
        del model, args, out
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f"dense_sweep: wrong parameter count, output not "
                           f"finite, of the wrong shape or off the CPU's: "
                           f"{failed}")
    emit("dense_sweep_done", builders=len(names))


def dense_phases(kernels) -> None:
    """Segmentation, optical flow and video: the JAX bench's last four zoo
    cells served, DeepLabV3 and RAFT trained, then every other builder of
    the three once. No kernel of the repo's is on these paths: the launch
    counts, set to 0 before them, are printed after them and must still
    read 0."""
    kernels.reset()
    dense_forward_phases()
    dense_train_phases()
    dense_sweep_phase()
    launches = kernels.launches()
    emit("dense_launches", launches=launches)
    if any(launches.values()):
        raise RuntimeError(f"dense: kernels launched on a path that has none: "
                           f"{launches}")


RECIPE_SIZES = ((480, 640), (427, 640), (640, 480), (612, 612))  # COCO-like
RECIPE_SAMPLES = 32  # detection samples a policy
RECIPE_MAX_BOXES = 12
RECIPE_CLS_IMAGES = 64
RECIPE_CLS_SIZES = ((375, 500), (500, 375), (333, 500), (480, 640))
RECIPE_CLIPS = 8
RECIPE_CLIP = (16, 256, 340)  # frames, height, width
RECIPE_COORD_TOL = 1e-6  # boxes and keypoints, of the largest coordinate
RECIPE_LEVEL_SHARE = 1e-2  # float pixels one uint8 level apart, at most
RECIPE_NORM_TOL = 1e-5  # normalised pixels, of the largest value
RECIPE_NORM_LEVEL_SHARE = 2e-2
RECIPE_VIDEO_TOL = 1e-5  # the video preset, of the largest value
RECIPE_GATE_DRAWS = 4000  # draws of each gate for the binomial check
DET_POLICIES = ("hflip", "lsj", "multiscale", "ssd", "ssdlite")
GEOMETRY_ONLY = ("hflip", "ssdlite")  # no resize, no colour op: exact
CLS_POLICIES = ("ra", "ta_wide", "augmix", "imagenet")
RECIPE_SSD_BATCH = 32
RECIPE_MASK_BATCH = 2
VIDEO_TRAIN = {"r3d_18": (16, 112, 8), "mvit_v2_s": (16, 224, 4)}
VIDEO_CPU_BATCH = {"r3d_18": 2, "mvit_v2_s": 1}
VIDEO_STEPS = 3


def recipe_samples(count, seed=0, sizes=RECIPE_SIZES, keypoints=True):
    """Seeded detection samples on the CPU, in pinned memory (as a loader
    with ``pin_memory=True`` hands them over): a uint8 ``Image`` of each
    of ``sizes`` in turn, 2-12 boxes (16 px to half the image a side),
    their ellipse masks, with ``keypoints`` 17 keypoints each
    (``detection_request``'s), labels in [1, 91)."""
    import torch

    from vision_tpu_torch import tv_tensors as tv
    from vision_tpu_torch.tools.detection_request import (
        ellipse_masks,
        seeded_keypoints,
    )

    gen = torch.Generator().manual_seed(seed)
    out = []
    for i in range(count):
        h, w = sizes[i % len(sizes)]
        n = int(torch.randint(2, RECIPE_MAX_BOXES + 1, (), generator=gen))
        img = torch.randint(0, 256, (3, h, w), dtype=torch.uint8, generator=gen)
        extent = torch.tensor([float(w), float(h)])
        wh = torch.rand(n, 2, generator=gen) * (extent / 2 - 16) + 16
        xy = torch.rand(n, 2, generator=gen) * (extent - wh)
        boxes = torch.cat([xy, xy + wh], 1)
        valid = torch.ones(1, n, dtype=torch.bool)
        masks = ellipse_masks(boxes[None], valid, (h, w))[0].to(torch.uint8)
        kps = seeded_keypoints(boxes[None], valid, gen)[0]
        target = {"boxes": tv.BoundingBoxes(boxes, format="XYXY",
                                            canvas_size=(h, w)),
                  "labels": torch.randint(1, 91, (n,), generator=gen),
                  "masks": tv.Mask(masks)}
        if keypoints:
            target["keypoints"] = tv.KeyPoints(kps, canvas_size=(h, w))
        sample = (tv.Image(img), target)
        out.append(_pinned(sample))
    return out


def _pinned(sample):
    import torch
    import torch.utils._pytree as pytree

    return pytree.tree_map(
        lambda x: x.pin_memory() if isinstance(x, torch.Tensor) else x, sample)


def _cpu(sample):
    import torch
    import torch.utils._pytree as pytree

    return pytree.tree_map(
        lambda x: x.to("cpu") if isinstance(x, torch.Tensor) else x, sample)


def _card(sample):
    """``sample`` on the card; pinned leaves copied without a wait."""
    import torch
    import torch.utils._pytree as pytree

    return pytree.tree_map(
        lambda x: x.to("cuda", non_blocking=True) if isinstance(x, torch.Tensor)
        else x, sample)


def sample_errors(card, cpu):
    """Leaf by leaf, the card's sample against the CPU's (same structure):
    the image's largest difference and the share of its pixels that
    differ at all; the largest box / keypoint difference of the largest
    coordinate; whether the labels and masks are equal."""
    import torch
    import torch.utils._pytree as pytree

    from vision_tpu_torch import tv_tensors as tv

    out = {"image_max": 0.0, "image_share": 0.0, "coord": 0.0,
           "exact_equal": True}
    for a, b in zip(pytree.tree_flatten(card)[0], pytree.tree_flatten(cpu)[0]):
        a = a.as_subclass(torch.Tensor).cpu() if isinstance(a, torch.Tensor) else a
        was = b
        b = b.as_subclass(torch.Tensor) if isinstance(b, torch.Tensor) else b
        if not isinstance(a, torch.Tensor):
            continue
        if a.shape != b.shape:
            out["exact_equal"] = False
            out["coord"] = float("inf")
            continue
        if isinstance(was, (tv.Image, tv.Video)) or (
                a.is_floating_point() and a.ndim == 3):
            diff = (a.float() - b.float()).abs()
            out["image_max"] = max(out["image_max"], float(diff.max()))
            out["image_share"] = max(out["image_share"],
                                     float((diff > 1e-6).float().mean()))
        elif isinstance(was, (tv.BoundingBoxes, tv.KeyPoints)):
            if a.numel():
                scale = max(float(b.abs().max()), 1.0)
                out["coord"] = max(out["coord"],
                                   float((a - b).abs().max()) / scale)
        else:
            out["exact_equal"] &= bool(torch.equal(a, b))
    return out


def count_syncs(fn) -> int:
    """The host synchronisations ``fn()`` makes (PyTorch's sync debug
    mode's warnings)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


def run_preset(card, cpu, samples, seed, policy):
    """Every sample through ``card`` (draws recorded from a CPU generator
    seeded ``seed``) and again through ``cpu`` on the card's draws; then
    the card's pass again, timed (ms a sample) and again with the host
    synchronisations counted. Returns the outputs, the worst errors and
    the figures."""
    import torch

    from vision_tpu_torch.transforms import v2 as T

    gen = torch.Generator().manual_seed(seed)
    outs, worst = [], {"image_max": 0.0, "image_share": 0.0, "coord": 0.0,
                       "exact_equal": True}
    for sample in samples:
        rec = T.Record(gen)
        out = card(sample, rec)
        replay = T.Replay(rec.params)
        want = cpu(_cpu(sample), replay)
        if not replay.exhausted:
            raise RuntimeError(f"{policy}: the CPU took fewer draws than the card")
        err = sample_errors(out, want)
        for k in ("image_max", "image_share", "coord"):
            worst[k] = max(worst[k], err[k])
        worst["exact_equal"] &= err["exact_equal"]
        outs.append(out)

    def one_pass():
        g = torch.Generator().manual_seed(seed)
        for sample in samples:
            card(sample, g)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t = time.perf_counter()
    one_pass()
    ms = (time.perf_counter() - t) * 1e3 / len(samples)
    syncs = count_syncs(one_pass) / len(samples)
    return outs, worst, {"ms_per_sample": ms, "host_syncs_per_sample": syncs}


def recipe_gate_checks() -> dict:
    """Each random-apply draw of the presets' transforms fires at its ``p``
    over ``RECIPE_GATE_DRAWS`` draws from a CPU generator (four standard
    deviations), and RandomPhotometricDistort's five ``p`` draws and its
    even contrast order too."""
    import torch

    from vision_tpu_torch import tv_tensors as tv
    from vision_tpu_torch.transforms import v2 as T

    flat = [tv.Image(torch.zeros(3, 8, 8, dtype=torch.uint8))]
    gen = torch.Generator().manual_seed(5)
    n = RECIPE_GATE_DRAWS
    gates = {"RandomHorizontalFlip(0.5)": (T.RandomHorizontalFlip(0.5), 0.5),
             "RandomZoomOut(0.5)": (T.RandomZoomOut(p=0.5), 0.5),
             "RandomErasing(0.25)": (T.RandomErasing(p=0.25), 0.25)}
    out = {}
    for name, (t, p) in gates.items():
        count = sum(t._draw_sample(flat, gen)["applied"] for _ in range(n))
        out[name] = {"fired": count, "draws": n, "p": p,
                     "ok": binomial_ok(count, n, p)}
    distort = T.RandomPhotometricDistort()
    draws = [distort.make_params(flat, gen) for _ in range(n)]
    for key in ("brightness_factor", "contrast_factor", "saturation_factor",
                "hue_factor", "channel_permutation"):
        count = sum(d[key] is not None for d in draws)
        out[f"RandomPhotometricDistort.{key}"] = {
            "fired": count, "draws": n, "p": 0.5, "ok": binomial_ok(count, n, 0.5)}
    count = sum(d["contrast_before"] for d in draws)
    out["RandomPhotometricDistort.contrast_before"] = {
        "fired": count, "draws": n, "p": 0.5, "ok": binomial_ok(count, n, 0.5)}
    return out


def recipe_transforms_phase():
    """``recipe_transforms``: the reference recipes' train-side presets on
    the card, each sample held against the same preset on the CPU with the
    card's draws handed across (``Record`` / ``Replay``). The five
    detection policies on ``RECIPE_SAMPLES`` seeded COCO-like samples
    (2-12 boxes, masks, 17 keypoints; keypoints mirrored with COCO's flip
    indices): the geometry-only policies exact, the others' images at most
    one uint8 level apart on at most ``RECIPE_LEVEL_SHARE`` of the pixels,
    boxes and keypoints within ``RECIPE_COORD_TOL``, labels and masks
    equal. The four classification policies at 224 on
    ``RECIPE_CLS_IMAGES`` ImageNet-like images (normalised outputs within
    ``RECIPE_NORM_TOL``, one level over std on at most
    ``RECIPE_NORM_LEVEL_SHARE`` of the values); the video preset on
    ``RECIPE_CLIPS`` clips of 16 frames at 256x340, crop 112 and 224,
    within ``RECIPE_VIDEO_TOL``. Per policy: ms a sample, host
    synchronisations a sample, the share of boxes ``SanitizeBoundingBoxes``
    kept; and the gates' binomial checks. Returns the ``ssd`` policy's
    outputs (the SSD train phase's batch) and their ms a sample."""
    import torch

    from vision_tpu_torch.parallel import presets as P
    from vision_tpu_torch.transforms import v2 as T

    t0 = time.perf_counter()
    device = torch.cuda.get_device_name(0)
    samples = recipe_samples(RECIPE_SAMPLES)
    boxes_in = sum(len(s[1]["boxes"]) for s in samples)
    flip = P.COCO_PERSON_KEYPOINT_FLIP_INDICES
    lines, ssd = {}, None
    for i, policy in enumerate(DET_POLICIES):
        card = P.DetectionPresetTrain(data_augmentation=policy,
                                      keypoint_flip_indices=flip)
        cpu = P.DetectionPresetTrain(data_augmentation=policy,
                                     keypoint_flip_indices=flip, device="cpu")
        outs, err, fig = run_preset(card, cpu, samples, 100 + i, policy)
        kept = sum(len(o[1]["boxes"]) for o in outs)
        exact = policy in GEOMETRY_ONLY
        ok = (err["exact_equal"] and err["coord"] <= RECIPE_COORD_TOL
              and (err["image_max"] == 0.0 if exact else
                   (err["image_max"] <= 1.0 / 255.0 + 1e-6
                    and err["image_share"] <= RECIPE_LEVEL_SHARE)))
        lines[policy] = dict(fig, samples=len(samples),
                             sanitize_kept_share=kept / boxes_in,
                             boxes_in=boxes_in, boxes_kept=kept,
                             image_vs_cpu_max_abs_err=err["image_max"],
                             image_vs_cpu_differing_share=err["image_share"],
                             coord_vs_cpu_rel_err=err["coord"],
                             labels_masks_equal=err["exact_equal"],
                             gate="exact" if exact else "one level",
                             output_sizes=sorted({tuple(o[0].shape[-2:])
                                                  for o in outs})[:6], ok=ok)
        if policy == "ssd":
            ssd = (outs, fig["ms_per_sample"])
        if not ok:
            emit("recipe_transforms", failed=policy, **lines[policy])
            raise RuntimeError(f"recipe_transforms {policy}: the card's "
                               "samples are off the CPU's")
    gen_cls = torch.Generator().manual_seed(1)
    images = [torch.randint(0, 256, (3, h, w), dtype=torch.uint8,
                            generator=gen_cls).pin_memory()
              for h, w in (RECIPE_CLS_SIZES[k % len(RECIPE_CLS_SIZES)]
                           for k in range(RECIPE_CLS_IMAGES))]
    level = torch.tensor([1 / 255 / s for s in (0.229, 0.224, 0.225)])
    for i, policy in enumerate(CLS_POLICIES):
        kw = dict(crop_size=224, auto_augment_policy=policy)
        card = P.ClassificationPresetTrain(**kw)
        cpu = P.ClassificationPresetTrain(**kw, device="cpu")
        gen = torch.Generator().manual_seed(200 + i)
        worst, share = 0.0, 0.0
        for img in images:
            rec = T.Record(gen)
            got = card(img, rec).cpu()
            want = cpu(img.cpu(), T.Replay(rec.params))
            diff = (got - want).abs()
            scale = float(want.abs().max())
            worst = max(worst, float((diff - level[:, None, None]).max()) / scale)
            share = max(share, float((diff > RECIPE_NORM_TOL * scale)
                                     .float().mean()))

        def one_pass(seed=200 + i):
            g = torch.Generator().manual_seed(seed)
            for img in images:
                card(img, g)
            torch.cuda.synchronize()

        torch.cuda.synchronize()
        t = time.perf_counter()
        one_pass()
        ms = (time.perf_counter() - t) * 1e3 / len(images)
        syncs = count_syncs(one_pass) / len(images)
        ok = worst <= RECIPE_NORM_TOL and share <= RECIPE_NORM_LEVEL_SHARE
        lines[f"cls_{policy}"] = dict(samples=len(images), ms_per_sample=ms,
                                      host_syncs_per_sample=syncs,
                                      beyond_one_level_rel=worst,
                                      differing_share=share, ok=ok)
        if not ok:
            raise RuntimeError(f"recipe_transforms {policy}: the card's images "
                               "are off the CPU's")
    gen_clip = torch.Generator().manual_seed(2)
    frames, h, w = RECIPE_CLIP
    clips = [torch.randint(0, 256, (frames, 3, h, w), dtype=torch.uint8,
                           generator=gen_clip).pin_memory()
             for _ in range(RECIPE_CLIPS)]
    for crop in (112, 224):
        resize = int(round(crop * 8 / 7))
        card = P.VideoClassificationPresetTrain(crop_size=crop,
                                                resize_size=resize)
        cpu = P.VideoClassificationPresetTrain(crop_size=crop,
                                               resize_size=resize, device="cpu")
        gen = torch.Generator().manual_seed(300 + crop)
        worst = 0.0
        for clip in clips:
            rec = T.Record(gen)
            got = card(clip, rec).cpu()
            want = cpu(clip.cpu(), T.Replay(rec.params))
            worst = max(worst, float((got - want).abs().max()
                                     / want.abs().max()))

        def one_pass(seed=300 + crop):
            g = torch.Generator().manual_seed(seed)
            for clip in clips:
                card(clip, g)
            torch.cuda.synchronize()

        torch.cuda.synchronize()
        t = time.perf_counter()
        one_pass()
        ms = (time.perf_counter() - t) * 1e3 / len(clips)
        syncs = count_syncs(one_pass) / len(clips)
        ok = worst <= RECIPE_VIDEO_TOL
        lines[f"video_{crop}"] = dict(clips=len(clips), clip=list(RECIPE_CLIP),
                                      resize_size=resize, ms_per_clip=ms,
                                      host_syncs_per_clip=syncs,
                                      vs_cpu_rel_err=worst, ok=ok)
        if not ok:
            raise RuntimeError(f"recipe_transforms video {crop}: the card's "
                               "clips are off the CPU's")
    gates = recipe_gate_checks()
    emit("recipe_transforms", device=device, policies=lines, gates=gates,
         tol={"coord": RECIPE_COORD_TOL, "level_share": RECIPE_LEVEL_SHARE,
              "norm": RECIPE_NORM_TOL, "norm_level_share": RECIPE_NORM_LEVEL_SHARE,
              "video": RECIPE_VIDEO_TOL},
         seconds=time.perf_counter() - t0)
    if not all(g["ok"] for g in gates.values()):
        raise RuntimeError(f"recipe_transforms: a gate fires off its p: {gates}")
    return ssd


def det_recipe_train_phase(kernels, ssd):
    """``det_recipe_train``: detectors trained from the recipes' presets
    through ``collate_detection``. SSD300-VGG16 at batch
    ``RECIPE_SSD_BATCH`` from the ``ssd`` policy's samples
    (``recipe_transforms``'), on its 300 canvas: ``DET_STEPS`` steps in f32
    and in amp (recipe SGD, one-stage step), the amp step 1's loss within
    ``ZOO_AMP_LOSS_TOL`` of the f32 one, no kernel of the repo's launched.
    Mask R-CNN ResNet-50-FPN at batch ``RECIPE_MASK_BATCH`` from the
    ``hflip`` policy with masks on the 1344 canvas: ``det_train_phase``
    (each step against one through the plain versions), the window-pool and
    RoIAlign kernels required. ms a step beside the preset's ms."""
    import torch

    from vision_tpu_torch.models.detection import GeneralizedRCNNTransform
    from vision_tpu_torch.parallel import (
        DetectionPresetTrain,
        collate_detection,
        make_detection_train_step,
    )
    from vision_tpu_torch.tools.detection_request import (
        GT_ROWS,
        recipe_optimizer,
        transform_for,
    )

    outs, preset_ms = ssd
    name = "ssd300_vgg16"
    torch.cuda.synchronize()
    t = time.perf_counter()
    batch = collate_detection(outs[:RECIPE_SSD_BATCH], transform_for(name),
                              max_boxes=RECIPE_MAX_BOXES)
    torch.cuda.synchronize()
    collate_ms = (time.perf_counter() - t) * 1e3
    lines = {}
    kernels.reset()
    f32_loss = None
    for dtype in (None, torch.bfloat16):
        model = scaled_one_stage(name, SSD_CLS_SCALE, SSD_BACKGROUND)
        optimizer, scheduler = recipe_optimizer(model)
        step = make_detection_train_step(model, optimizer, compute_dtype=dtype,
                                         one_stage=True)
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for i in range(DET_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(step(batch)["loss"]))
            times.append((time.perf_counter() - t) * 1e3)
            scheduler.step()
        tag = "f32" if dtype is None else "amp"
        ok = all(math.isfinite(v) for v in losses) and losses[-1] != losses[0]
        line = dict(losses=losses, ms_all=times,
                    ms_per_step=statistics.median(times[1:]),
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if dtype is None:
            f32_loss = losses[0]
        else:
            err = abs(losses[0] - f32_loss) / abs(f32_loss)
            line.update(loss_vs_f32_rel_err=err, loss_tol=ZOO_AMP_LOSS_TOL)
            ok = ok and err <= ZOO_AMP_LOSS_TOL
        lines[f"ssd_{tag}"] = line
        del model, step, optimizer
        torch.cuda.empty_cache()
        if not ok:
            emit("det_recipe_train", failed=f"ssd_{tag}", **line)
            raise RuntimeError(f"det_recipe_train ssd {tag}: a loss not finite, "
                               "no update, or amp off f32")
    launches = kernels.launches()
    if any(launches.values()):
        raise RuntimeError(f"det_recipe_train ssd: a kernel launched: {launches}")
    emit("det_recipe_train", model=name, batch=RECIPE_SSD_BATCH,
         input=list(batch["image"].shape), gt_rows=RECIPE_MAX_BOXES,
         gt_boxes=batch["valid"].sum(1).tolist(),
         preset_ms_per_sample=preset_ms,
         preset_ms_per_batch=preset_ms * RECIPE_SSD_BATCH,
         collate_ms=collate_ms, **lines,
         device=torch.cuda.get_device_name(0))
    del batch
    torch.cuda.empty_cache()

    samples = recipe_samples(RECIPE_MASK_BATCH, seed=9,
                             sizes=((480, 640), (427, 640)), keypoints=False)
    preset = DetectionPresetTrain(data_augmentation="hflip")
    gen = torch.Generator().manual_seed(11)
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = [preset(s, gen) for s in samples]
    batch = collate_detection(outs, GeneralizedRCNNTransform(),
                              max_boxes=GT_ROWS)
    torch.cuda.synchronize()
    preset_ms = (time.perf_counter() - t) * 1e3
    emit("det_recipe_train_mask_batch", policy="hflip",
         preset_and_collate_ms=preset_ms, input=list(batch["image"].shape),
         masks=list(batch["masks"].shape),
         gt_boxes=batch["valid"].sum(1).tolist())
    det_train_phase(kernels, "det_recipe_train_mask", name="maskrcnn_resnet50_fpn",
                    grads=MASK_GRADS, batch=batch)
    del batch
    torch.cuda.empty_cache()


def video_train_phase():
    """``video_train``: the video recipe from uint8 clips through
    ``VideoClassificationPresetTrain`` on the card (16 frames of 256x340,
    crop 112 with resize 128 for R3D-18 at batch 8, crop 224 with resize
    256 for MViT-V2-S at batch 4; 400 classes), ``make_train_step`` with
    the recipe's SGD (``video_recipe_optimizer``), f32 and amp,
    ``VIDEO_STEPS`` steps each; step 1 (stochastic depth and dropout off)
    held against the CPU's at ``VIDEO_CPU_BATCH`` (``step_check``), the amp
    step 1's loss within ``ZOO_AMP_LOSS_TOL`` of the f32 one. ms a step,
    clips/s, peak GB, the preset's ms a clip."""
    import torch

    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.parallel import (
        VideoClassificationPresetTrain,
        make_train_step,
        video_recipe_optimizer,
    )
    from vision_tpu_torch.tools import dense

    card = resolve_device(None)
    for name, (frames, crop, batch_size) in VIDEO_TRAIN.items():
        gen_clip = torch.Generator().manual_seed(3)
        raw = [torch.randint(0, 256, (frames, 3, *RECIPE_CLIP[1:]),
                             dtype=torch.uint8, generator=gen_clip).pin_memory()
               for _ in range(batch_size)]
        labels = torch.randint(0, 400, (batch_size,), generator=gen_clip)
        preset = VideoClassificationPresetTrain(
            crop_size=crop, resize_size=int(round(crop * 8 / 7)))
        gen = torch.Generator().manual_seed(4)
        torch.cuda.synchronize()
        t = time.perf_counter()
        clips = torch.stack([preset(c, gen) for c in raw])
        torch.cuda.synchronize()
        preset_ms = (time.perf_counter() - t) * 1e3 / batch_size
        batch = {"image": clips, "label": labels.to(card)}
        quiet = ({"stochastic_depth_prob": 0.0, "dropout": 0.0}
                 if name.startswith("mvit") else {})
        cpu_n = VIDEO_CPU_BATCH[name]

        def lr0_step(model):
            return make_train_step(model, torch.optim.SGD(model.parameters(),
                                                          lr=0.0))

        check = step_check(
            lambda: dense.seeded_model(name, **quiet), lr0_step,
            lambda dev: {"image": clips[:cpu_n].to(dev),
                         "label": batch["label"][:cpu_n].to(dev)})
        torch.cuda.empty_cache()
        f32_loss = None
        for dtype in (None, torch.bfloat16):
            tag = "video_train" if dtype is None else "video_train_amp"
            model = dense.seeded_model(name)
            optimizer, scheduler = video_recipe_optimizer(model)
            step = make_train_step(model, optimizer, compute_dtype=dtype)
            g = torch.Generator(device=card).manual_seed(ZOO_SEED)
            torch.cuda.reset_peak_memory_stats()

            def call():
                out = step(batch, g)
                scheduler.step()
                return out["loss"]

            loss1, times, losses = timed_steps(call)
            ms = statistics.median(times)
            fields = dict(model=name, device=torch.cuda.get_device_name(0),
                          dtype="float32" if dtype is None else "bfloat16",
                          clip=[frames, crop, crop], batch=batch_size,
                          raw_clip=[frames, *RECIPE_CLIP[1:]],
                          preset_ms_per_clip=preset_ms, ms_per_step=ms,
                          clips_per_s=batch_size / ms * 1e3, ms_all=times,
                          step1_loss=loss1, losses=losses,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          optimizer="SGD lr 0.01 momentum 0.9 weight_decay 1e-4")
            ok = all(math.isfinite(v) for v in [loss1] + losses)
            if dtype is None:
                fields.update(check, cpu_batch=cpu_n)
                ok = ok and check["ok"]
                f32_loss = loss1
            else:
                err = abs(loss1 - f32_loss) / abs(f32_loss)
                fields.update(loss_vs_f32_rel_err=err, loss_tol=ZOO_AMP_LOSS_TOL)
                ok = ok and err <= ZOO_AMP_LOSS_TOL
            emit(tag, **fields)
            if not ok:
                raise RuntimeError(f"{tag} {name}: step 1 off its reference or "
                                   "a loss not finite")
            del model, step, optimizer
            torch.cuda.empty_cache()
        del batch, clips


def recipe_phases(kernels) -> None:
    """The reference recipes' train side: ``recipe_transforms``,
    ``det_recipe_train`` and ``video_train``. Of the repo's kernels only
    the Mask R-CNN steps launch any (the window pool and RoIAlign, which
    ``det_train_phase`` requires)."""
    import torch

    ssd = recipe_transforms_phase()
    torch.cuda.empty_cache()
    det_recipe_train_phase(kernels, ssd)
    torch.cuda.empty_cache()
    kernels.reset()
    video_train_phase()
    launches = kernels.launches()
    emit("video_train_launches", launches=launches)
    if any(launches.values()):
        raise RuntimeError(f"video_train: a kernel launched: {launches}")


COCO_FOLDER_TRAIN = 64  # images of train2017/ (two without annotations)
COCO_FOLDER_VAL = 32
VOC_FOLDER_TRAIN = 48
VOC_FOLDER_VAL = 16
COCO_FOLDER_MODEL = "maskrcnn_resnet50_fpn"
VOC_FOLDER_MODEL = "deeplabv3_resnet50"
VOC_FOLDER_SIZE = 480  # PR 21's seg_train cell: 480x480 crops, batch 8
VOC_FOLDER_BATCH = 8
# the rows of the kernels line each phase's launches join, by counter
COCO_FOLDER_ROWS = {
    "coco_folder_train": {"nms": "nms", "window_pool_bf16": "window_pool_bf16",
                          "window_pool_backward_bf16": "window_pool_backward_bf16",
                          "roi_align_bf16": "roi_align_bf16",
                          "roi_align_backward_bf16": "roi_align_backward_bf16",
                          "roi_align_mask_targets": "roi_align_f32"},
    "coco_folder_eval": {"nms": "nms", "window_pool": "window_pool_f32",
                         "roi_align": "roi_align_f32"},
}


def coco_folder_train_phase(kernels, root, tree, tree_s) -> dict:
    """``coco_folder_train``: Mask R-CNN R50-FPN trained for one epoch from
    the COCO tree through the detection trainer's ``main`` (``--with-masks
    --amp``, its defaults otherwise: batch 2, ``hflip``, aspect-ratio
    groups of factor 3, short side 640, SGD with warmup), the checkpoint
    written. Step 1 is held against the same step through the plain
    versions from the same weights and generator state
    (``plain_twin_step``: losses within ``AMP_FIRST_LOSS_TOL``, gradients
    within ``AMP_GRAD_TOL``); the NMS, window-pool, RoIAlign and both
    backward kernels must launch in the epoch. Returns the launches and
    the checkpoint's path."""
    import torch

    from vision_tpu_torch.references.detection import train as det

    out_dir = os.path.join(root, "checkpoints")
    args = det.get_args_parser().parse_args([
        "--data-path", root, "--model", COCO_FOLDER_MODEL, "--with-masks", "--amp",
        "--epochs", "1", "--output-dir", out_dir, "--print-freq", "8"])
    first = {}

    def before_first(model, batch, generator):
        t = time.perf_counter()
        first["batch"] = [list(batch["image"].shape), batch["valid"].sum(1).tolist()]
        first["plain"] = plain_twin_step(kernels, model, generator, batch,
                                         torch.bfloat16, MASK_GRADS, COCO_FOLDER_MODEL)
        kernels.reset()  # the counts of the epoch's own steps
        first["plain_s"] = time.perf_counter() - t

    def after_first(model):
        named = dict(model.named_parameters())
        first["grads"] = {n: named[n].grad.clone() for n in MASK_GRADS}

    kernels.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = det.main(args, hooks={"before_first": before_first, "after_first": after_first})
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    epoch_s = run["epoch_s"][0] - first["plain_s"]  # the plain step apart
    launches = kernels.launches()
    plain_losses, plain_grads = first["plain"]
    losses = [s["losses"] for s in run["steps"]]
    loss_rel = {k: abs(losses[0][k] - plain_losses[k]) / max(abs(plain_losses[k]), 1e-30)
                for k in plain_losses}
    grad_rel = dict(zip(MASK_GRADS, rel_errs([first["grads"][n] for n in MASK_GRADS],
                                             [plain_grads[n] for n in MASK_GRADS])))
    ms = [s["ms"] for s in run["steps"]]
    host = run["host"]
    kept = tree["train"]["images"] - tree["train"]["empty"]
    emit("coco_folder_train", model=COCO_FOLDER_MODEL, tree=tree, tree_s=tree_s,
         args={k: v for k, v in vars(args).items() if k != "data_path"},
         images_kept=run["images_kept"], images_kept_want=kept, steps=len(ms),
         first_batch=first["batch"], first_losses=losses[0], plain_first_losses=plain_losses,
         first_loss_rel_err=loss_rel, loss_tol=AMP_FIRST_LOSS_TOL,
         grad_rel_err=grad_rel, grad_tol=AMP_GRAD_TOL,
         last_losses=losses[-1], ms_per_step_median=statistics.median(ms[1:]),
         ms_all=ms, epoch_s=epoch_s, epoch_ms_per_step=epoch_s / len(ms) * 1e3,
         plain_step_s=first["plain_s"], main_s=main_s,
         host_ms_per_sample={k: host[k] / host["samples"] * 1e3
                             for k in ("decode", "rasterise", "preset")},
         collate_ms_per_batch=host["collate"] / len(ms) * 1e3,
         samples=host["samples"], images_per_s=host["samples"] / epoch_s,
         launches=launches, device=torch.cuda.get_device_name(0))
    require_launched(launches, COCO_FOLDER_ROWS["coco_folder_train"].values(),
                     "COCO folder train (amp)")
    if (run["images_kept"] != kept or host["samples"] != 2 * len(ms)
            or len(ms) != kept // 2
            or not all(math.isfinite(v["loss"]) for v in losses)
            or max(loss_rel.values()) > AMP_FIRST_LOSS_TOL
            or max(grad_rel.values()) > AMP_GRAD_TOL):
        raise RuntimeError("coco_folder_train: images kept, steps, a loss not finite, "
                           "or step 1 off the plain path")
    return {"launches": launches, "checkpoint": os.path.join(out_dir, "checkpoint_0.pth")}


def coco_folder_eval_phase(kernels, root, checkpoint) -> dict:
    """``coco_folder_eval``: the trained Mask R-CNN evaluated over val2017/
    through the detection trainer's ``--test-only --resume`` (f32, batch
    2, ``CocoEvaluator``): ms an image, mAP; the NMS, window-pool and
    RoIAlign kernels must launch. Then ``CocoEvaluator`` fed the val ground
    truths themselves as detections (crowds at a lower score) must read
    mAP 1.0."""
    import numpy as np
    import torch

    from vision_tpu_torch.datasets import CocoDetection
    from vision_tpu_torch.references.detection import train as det
    from vision_tpu_torch.references.detection.coco_eval import CocoEvaluator

    args = det.get_args_parser().parse_args([
        "--data-path", root, "--model", COCO_FOLDER_MODEL, "--test-only",
        "--resume", checkpoint])
    kernels.reset()
    metrics = det.main(args)["metrics"]
    launches = kernels.launches()
    val = CocoDetection(os.path.join(root, "val2017"),
                        os.path.join(root, "annotations", "instances_val2017.json"))
    gts = det.coco_ground_truths(val)
    evaluator = CocoEvaluator(gts)
    evaluator.update({i: {"boxes": g["boxes"], "labels": g["labels"],
                          "scores": np.where(g["iscrowd"] > 0, 0.5, 1.0)}
                      for i, g in gts.items()})
    truth = evaluator.summarize()
    emit("coco_folder_eval", model=COCO_FOLDER_MODEL, metrics=metrics,
         ms_per_image=metrics["seconds"] / metrics["images"] * 1e3,
         ground_truth_map=truth, launches=launches,
         device=torch.cuda.get_device_name(0))
    require_launched(launches, COCO_FOLDER_ROWS["coco_folder_eval"].values(),
                     "COCO folder eval")
    if (metrics["images"] != COCO_FOLDER_VAL or truth["map"] != 1.0
            or not 0.0 <= metrics["map"] <= 1.0):
        raise RuntimeError(f"coco_folder_eval: {metrics['images']} images, mAP "
                           f"{metrics['map']}, the ground truth's {truth['map']}")
    return {"launches": launches}


def voc_folder_phases(kernels, root, tree) -> None:
    """``voc_folder_train``: DeepLabV3-R50 trained for one epoch from the VOC
    tree through the segmentation trainer's ``main`` (480x480 crops, batch
    8, f32, its other defaults), evaluated on val after it
    (``voc_folder_eval``: mean IoU, ms an image); ``ConfusionMatrix`` of
    val's ground truth against itself must read 1.0 (every class is in
    val). No kernel of the repo's is on this path."""
    import torch

    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.references.segmentation import train as seg

    args = seg.get_args_parser().parse_args([
        "--data-path", root, "--model", VOC_FOLDER_MODEL, "--epochs", "1",
        "--size", str(VOC_FOLDER_SIZE), "--batch-size", str(VOC_FOLDER_BATCH),
        "--print-freq", "2"])
    kernels.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = seg.main(args)
    wall_s = time.perf_counter() - t0
    launches = kernels.launches()
    ms = [s["ms"] for s in run["steps"]]
    losses = [s["loss"] for s in run["steps"]]
    host = run["host"]
    emit("voc_folder_train", model=VOC_FOLDER_MODEL, tree=tree,
         size=VOC_FOLDER_SIZE, batch=VOC_FOLDER_BATCH, steps=len(ms), losses=losses,
         lr=[s["lr"] for s in run["steps"]], ms_per_step_median=statistics.median(ms[1:]),
         ms_all=ms, epoch_s=run["epoch_s"][0],
         epoch_ms_per_step=run["epoch_s"][0] / len(ms) * 1e3,
         images_per_s=host["samples"] / run["epoch_s"][0], wall_s=wall_s,
         host_ms_per_sample={k: host[k] / host["samples"] * 1e3 for k in ("read", "preset")},
         samples=host["samples"], launches=launches,
         device=torch.cuda.get_device_name(0))
    confmat = seg.ConfusionMatrix(args.num_classes)
    for batch in seg._voc_batches(args, "val", False, resolve_device(None)):
        confmat.update(batch["target"], batch["target"])
    acc, _, iou = confmat.compute()
    ev = {k: v for k, v in run["eval"].items() if k != "confmat"}
    emit("voc_folder_eval", model=VOC_FOLDER_MODEL, **ev,
         ms_per_image=ev["seconds"] / ev["images"] * 1e3,
         ground_truth={"acc_global": float(acc), "mean_iou": float(iou.mean())},
         device=torch.cuda.get_device_name(0))
    if any(launches.values()):
        raise RuntimeError(f"voc_folder_train: a kernel launched: {launches}")
    if (len(ms) != VOC_FOLDER_TRAIN // VOC_FOLDER_BATCH or ev["images"] != VOC_FOLDER_VAL
            or not all(math.isfinite(v) for v in losses) or losses[0] == losses[-1]
            or not 0.0 <= ev["mean_iou"] <= 1.0 or acc != 1.0 or iou.mean() != 1.0):
        raise RuntimeError(f"voc_folder: {len(ms)} steps, {ev['images']} images, losses "
                           f"{losses}, the ground truth's accuracy {acc} and mean IoU "
                           f"{iou.mean()}")


def coco_voc_folder_phases(kernels, rows) -> None:
    """Detection and segmentation from COCO- and VOC-layout trees on disk
    (``tools/coco_folder.py``, written to a temporary directory:
    ``COCO_FOLDER_TRAIN`` / ``_VAL`` COCO images, ``VOC_FOLDER_TRAIN`` /
    ``_VAL`` VOC ones): ``coco_folder_train``, ``coco_folder_eval``,
    ``voc_folder_train``, ``voc_folder_eval``. The COCO phases' launches
    join the kernels line's rows (``COCO_FOLDER_ROWS``) as
    ``launches_<phase>``."""
    import tempfile

    import torch

    from vision_tpu_torch.tools import coco_folder

    tmp = tempfile.TemporaryDirectory(prefix="coco_voc_folder_")
    try:
        t0 = time.perf_counter()
        coco = coco_folder.write_coco_tree(tmp.name, COCO_FOLDER_TRAIN, COCO_FOLDER_VAL)
        voc = coco_folder.write_voc_tree(tmp.name, VOC_FOLDER_TRAIN, VOC_FOLDER_VAL)
        tree_s = time.perf_counter() - t0
        train = coco_folder_train_phase(kernels, tmp.name, coco, tree_s)
        torch.cuda.empty_cache()
        ev = coco_folder_eval_phase(kernels, tmp.name, train["checkpoint"])
        torch.cuda.empty_cache()
        voc_folder_phases(kernels, tmp.name, voc)
    finally:
        tmp.cleanup()
    by_name = {r["name"]: r for r in rows}
    for phase, launches in (("coco_folder_train", train["launches"]),
                            ("coco_folder_eval", ev["launches"])):
        for row, counter in COCO_FOLDER_ROWS[phase].items():
            by_name[row][f"launches_{phase}"] = launches[counter]


# The rest of transforms/ on the card (transforms_rest_phases, last)
WARP_SAMPLES = 16  # of recipe_samples; each one timed and held against the CPU
WARP_LEVEL_SHARE = 1e-3  # bilinear uint8 values one level apart, at most
WARP_NOISE_TOL = 1e-3  # the noise's mean and std against mean and sigma
WARP_NOISE_SIGMA = 0.1
KEYPOINT_WARP_MODEL = "keypointrcnn_resnet50_fpn"
KEYPOINT_WARP_STEPS = 8
KEYPOINT_WARP_BATCH = 2
KEYPOINT_WARP_PROFILED = 3  # the last steps, traced for the busy share
TENCROP_IMAGES = 8
TENCROP_SIZE = (375, 500)
# the rows of the kernels line the keypoint_warp_train launches join
KEYPOINT_WARP_ROWS = {"nms": "nms", "window_pool_bf16": "window_pool_bf16",
                      "window_pool_backward_bf16": "window_pool_backward_bf16",
                      "roi_align_bf16": "roi_align_bf16",
                      "roi_align_backward_bf16": "roi_align_backward_bf16"}


def warp_classes():
    """name -> (transform, gate): each new sample class of the slice, the
    keypoint ones behind a rotation that moves points out of the canvas.
    ``"exact"``: every pixel equal; ``"level"``: uint8 pixels one level
    apart at most, on at most ``WARP_LEVEL_SHARE`` of them."""
    from vision_tpu_torch.transforms import v2 as T

    return {
        "RandomAffine": (T.RandomAffine(15, translate=(0.1, 0.1),
                                        scale=(0.75, 1.25), shear=8), "exact"),
        "RandomAffine_bilinear": (T.RandomAffine(
            15, translate=(0.1, 0.1), scale=(0.75, 1.25), shear=8,
            interpolation="bilinear", fill=[124, 116, 104]), "level"),
        "RandomRotation": (T.RandomRotation(30), "exact"),
        "RandomRotation_expand": (T.RandomRotation(30, "bilinear", expand=True),
                                  "level"),
        "RandomPerspective": (T.RandomPerspective(0.3, p=1.0), "level"),
        "ElasticTransform": (T.ElasticTransform(), "level"),
        "FiveCrop": (T.FiveCrop(224), "exact"),
        "TenCrop": (T.TenCrop(224), "exact"),
        "GaussianBlur": (T.GaussianBlur(9, (0.1, 2.0)), "level"),
        "JPEG": (T.JPEG((50, 95)), "exact"),
        "ClampKeyPoints": (T.Compose([T.RandomRotation(30),
                                      T.ClampKeyPoints()]), "exact"),
        "SanitizeKeyPoints": (T.Compose([T.RandomRotation(30),
                                         T.SanitizeKeyPoints("default")]), "exact"),
        "SetClampingMode": (T.Compose([T.SetClampingMode("hard"),
                                       T.RandomRotation(30)]), "exact"),
    }


def warp_transforms_phase() -> dict:
    """``warp_transforms``: each new sample class (``warp_classes``) on the
    ``WARP_SAMPLES`` seeded COCO-like samples on the card (2-12 boxes,
    masks, 17 keypoints), every sample held against the same class on the
    CPU with the card's draws handed across (``run_preset``): masks, labels and the ``"exact"`` classes'
    pixels equal, the ``"level"`` classes' one level apart on at most
    ``WARP_LEVEL_SHARE``, boxes and keypoints within ``RECIPE_COORD_TOL``;
    ``JPEG`` bit for bit (the same host codec). ``GaussianNoise``: the
    card's uint8 output against the CPU's arithmetic on the card's normals
    (drawn again from the recorded seed), exact; the noise of f32 images
    (no clip) within ``WARP_NOISE_TOL`` of ``mean`` 0 and ``sigma``. Per
    class: ms and host synchronisations a sample. Returns the lines."""
    import torch

    from vision_tpu_torch.transforms import v2 as T
    from vision_tpu_torch.transforms.v2 import functional as F

    t0 = time.perf_counter()
    samples = recipe_samples(WARP_SAMPLES)
    lines = {}
    for i, (name, (t, gate)) in enumerate(warp_classes().items()):
        outs, err, fig = run_preset(lambda s, g, t=t: t(_card(s), g),
                                    lambda s, g, t=t: t(s, g),
                                    samples, 400 + i, name)
        ok = (err["exact_equal"] and err["coord"] <= RECIPE_COORD_TOL
              and (err["image_max"] == 0.0 if gate == "exact" else
                   (err["image_max"] <= 1.0
                    and err["image_share"] <= WARP_LEVEL_SHARE)))
        lines[name] = dict(fig, samples=len(samples), gate=gate,
                           image_vs_cpu_max_abs_err=err["image_max"],
                           image_vs_cpu_differing_share=err["image_share"],
                           coord_vs_cpu_rel_err=err["coord"],
                           labels_masks_equal=err["exact_equal"],
                           output_sizes=sorted({tuple(x.shape[-2:]) for x in
                                                torch.utils._pytree.tree_leaves(
                                                    [o[0] for o in outs])})[:4],
                           keypoint_groups=[sum(len(o[1]["keypoints"]) for o in outs),
                                            sum(len(s[1]["keypoints"]) for s in samples)],
                           ok=ok)
        if not ok:
            emit("warp_transforms", failed=name, **lines[name])
            raise RuntimeError(f"warp_transforms {name}: the card's samples are "
                               "off the CPU's")

    noise = T.GaussianNoise(0.0, WARP_NOISE_SIGMA)

    def noise_cpu(sample, replay):
        """The CPU's arithmetic on the card's normals, from the recorded
        seed."""
        seed = replay.next(noise)["seed"]
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        img = sample[0]
        z = torch.randn(img.shape, generator=g, device="cuda").cpu()
        return (F.gaussian_noise(img, 0.0, WARP_NOISE_SIGMA, True, normals=z),
                sample[1])

    _, err, fig = run_preset(lambda s, g: noise(_card(s), g), noise_cpu,
                             samples, 499, "GaussianNoise")
    gen = torch.Generator().manual_seed(498)
    floats = T.GaussianNoise(0.0, WARP_NOISE_SIGMA, clip=False)
    diffs = []
    for sample in samples:
        img = F.to_dtype(_card(sample[0]), torch.float32, scale=True)
        diffs.append((floats(img, gen) - img).double().flatten())
    diffs = torch.cat(diffs)
    mean, std = float(diffs.mean()), float(diffs.std())
    ok = (err["image_max"] == 0.0 and err["exact_equal"]
          and abs(mean) <= WARP_NOISE_TOL
          and abs(std - WARP_NOISE_SIGMA) <= WARP_NOISE_TOL)
    lines["GaussianNoise"] = dict(
        fig, samples=len(samples), gate="cpu arithmetic on the card's normals "
        "exact; f32 noise mean and std",
        image_vs_cpu_max_abs_err=err["image_max"], noise_values=diffs.numel(),
        noise_mean=mean, noise_std=std, sigma=WARP_NOISE_SIGMA,
        noise_tol=WARP_NOISE_TOL, ok=ok)
    emit("warp_transforms", device=torch.cuda.get_device_name(0), classes=lines,
         tol={"coord": RECIPE_COORD_TOL, "level_share": WARP_LEVEL_SHARE,
              "noise": WARP_NOISE_TOL},
         seconds=time.perf_counter() - t0)
    if not ok:
        raise RuntimeError("warp_transforms GaussianNoise: the arithmetic or the "
                           "noise's statistics are off")
    return lines


def keypoint_warp_train_phase(kernels) -> dict:
    """``keypoint_warp_train``: Keypoint R-CNN R50-FPN (full width, two
    classes) trained for ``KEYPOINT_WARP_STEPS`` amp steps at batch
    ``KEYPOINT_WARP_BATCH`` on warped samples: seeded COCO-like samples (``recipe_samples``) through
    ``tools/warp_train.py:keypoint_warp_chain`` on the card (random affine,
    perspective half the time, flip with COCO's keypoint map, clamps,
    ``SanitizeBoundingBoxes``), ``collate_detection`` onto the 1344 canvas,
    ``make_detection_train_step(..., compute_dtype=torch.bfloat16)``. Step
    1 against the plain path from the same weights and generator state
    (``plain_twin_step``: losses within ``AMP_FIRST_LOSS_TOL``, gradients
    within ``AMP_GRAD_TOL``); the NMS, window-pool, RoIAlign and both
    backward kernels must launch. ms a step (steps 2 to the first traced
    one), ms a sample of the chain, the card's busy share over the last
    ``KEYPOINT_WARP_PROFILED`` whole iterations (chain, collate, step).
    Returns the launches."""
    import torch

    from vision_tpu_torch.models import get_model
    from vision_tpu_torch.models.detection import GeneralizedRCNNTransform
    from vision_tpu_torch.parallel import collate_detection, make_detection_train_step
    from vision_tpu_torch.tools.detection_request import recipe_optimizer
    from vision_tpu_torch.tools.warp_train import (
        keypoint_warp_chain,
        to_float_samples,
    )

    t0 = time.perf_counter()
    steps = KEYPOINT_WARP_STEPS
    samples = recipe_samples(steps * KEYPOINT_WARP_BATCH, seed=13)
    chain = keypoint_warp_chain()
    chain_gen = torch.Generator().manual_seed(17)
    transform = GeneralizedRCNNTransform()
    model = get_model(KEYPOINT_WARP_MODEL, seed=0, trainable_backbone_layers=3)
    optimizer, scheduler = recipe_optimizer(model)
    step = make_detection_train_step(model, optimizer,
                                     compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    named = dict(model.named_parameters())
    chain_ms, batch_ms, step_ms, losses, kept = [], [], [], [], []

    def iteration(i, first=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = [chain(_card(s), chain_gen) for s in
                samples[i * KEYPOINT_WARP_BATCH:(i + 1) * KEYPOINT_WARP_BATCH]]
        torch.cuda.synchronize()
        chain_ms.append((time.perf_counter() - t) * 1e3 / len(outs))
        kept.append([len(o[1]["boxes"]) for o in outs])
        batch = collate_detection(to_float_samples(outs), transform,
                                  max_boxes=RECIPE_MAX_BOXES)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t) * 1e3)
        if first is not None:
            first(batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(batch, gen)
        losses.append({k: float(v) for k, v in out.items()})
        step_ms.append((time.perf_counter() - t) * 1e3)
        scheduler.step()
        return batch

    plain = {}

    def before_first(batch):
        plain["ref"] = plain_twin_step(kernels, model, gen, batch, torch.bfloat16,
                                       KEYPOINT_GRADS, KEYPOINT_WARP_MODEL)
        plain["shape"] = list(batch["image"].shape)
        plain["keypoints"] = list(batch["keypoints"].shape)
        kernels.reset()

    kernels.reset()
    iteration(0, before_first)
    grads = {n: named[n].grad.clone() for n in KEYPOINT_GRADS}
    timed = steps - KEYPOINT_WARP_PROFILED
    for i in range(1, timed):
        iteration(i)
    at = [timed]

    def traced():
        iteration(at[0])
        at[0] += 1

    trace = cuda_trace(traced, KEYPOINT_WARP_PROFILED)
    launches = kernels.launches()
    plain_losses, plain_grads = plain["ref"]
    loss_rel = {k: abs(losses[0][k] - plain_losses[k]) / max(abs(plain_losses[k]), 1e-30)
                for k in plain_losses}
    grad_rel = dict(zip(KEYPOINT_GRADS, rel_errs(
        [grads[n] for n in KEYPOINT_GRADS], [plain_grads[n] for n in KEYPOINT_GRADS])))
    emit("keypoint_warp_train", model=KEYPOINT_WARP_MODEL, steps=steps,
         batch=KEYPOINT_WARP_BATCH, dtype="bfloat16 (amp)",
         chain=repr(chain), first_input=plain["shape"],
         first_keypoints=plain["keypoints"], boxes_kept=kept,
         boxes_in=[len(s[1]["boxes"]) for s in samples],
         first_losses=losses[0], plain_first_losses=plain_losses,
         first_loss_rel_err=loss_rel, loss_tol=AMP_FIRST_LOSS_TOL,
         grad_rel_err=grad_rel, grad_tol=AMP_GRAD_TOL, last_losses=losses[-1],
         ms_per_step=statistics.median(step_ms[1:timed]), ms_all=step_ms,
         chain_ms_per_sample=statistics.median(chain_ms),
         chain_ms_all=chain_ms, chain_and_collate_ms_per_batch=statistics.median(
             batch_ms), traced_iterations=KEYPOINT_WARP_PROFILED,
         wall_ms=trace["wall_ms"], device_ms=trace["device_ms"],
         busy_share=trace["device_ms"] / trace["wall_ms"],
         launches=launches, seconds=time.perf_counter() - t0,
         device=torch.cuda.get_device_name(0))
    require_launched(launches, KEYPOINT_WARP_ROWS.values(), "keypoint_warp_train")
    if (not all(math.isfinite(v["loss"]) for v in losses)
            or max(loss_rel.values()) > AMP_FIRST_LOSS_TOL
            or max(grad_rel.values()) > AMP_GRAD_TOL
            or losses[0]["loss"] == losses[-1]["loss"]):
        raise RuntimeError("keypoint_warp_train: a loss not finite, no update, or "
                           "step 1 off the plain path")
    del model, step, optimizer
    return launches


def v1_tencrop_eval_phase() -> dict:
    """``v1_tencrop_eval``: ResNet-50 served through the v1 surface alone:
    ``transforms.Compose([Resize(256), TenCrop(224)])`` on a plain 4-d f32
    batch of ``TENCROP_IMAGES`` seeded 375x500 images on the card (one
    call), ``transforms.Normalize`` on the stacked crops, the logits
    averaged over the ten crops. Held against the same images through
    ``transforms.functional`` calls (``resize``, ``ten_crop``,
    ``normalize``) and the same model on the CPU: crops within 1e-5, logits
    within ``ZOO_LOGITS_TOL`` of the largest (the f32 zoo checks')."""
    import torch

    import vision_tpu_torch.transforms as Tv1
    import vision_tpu_torch.transforms.functional as F1
    from vision_tpu_torch.models import get_model

    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    images = TENCROP_IMAGES
    gen = torch.Generator().manual_seed(21)
    raw = torch.randint(0, 256, (images, 3, *TENCROP_SIZE), dtype=torch.uint8,
                        generator=gen)
    tencrop = Tv1.Compose([Tv1.Resize(256), Tv1.TenCrop(224)])
    normalize = Tv1.Normalize(mean, std)
    model = get_model("resnet50", seed=0)

    def serve(x):
        crops = torch.stack(tencrop(x), 1)
        logits = model(normalize(crops.flatten(0, 1)))
        return logits.view(len(x), 10, -1).mean(1), crops

    with torch.inference_mode():
        x = raw.to("cuda").float() / 255.0
        logits, crops = serve(x)
        times = []
        for _ in range(TIMED_FORWARDS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            serve(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        x_cpu = raw.float() / 255.0
        want_crops = torch.stack([torch.stack(F1.ten_crop(F1.resize(img, 256), 224))
                                  for img in x_cpu])
        cpu_model = get_model("resnet50", seed=0, device="cpu")
        want = cpu_model(F1.normalize(want_crops.flatten(0, 1), mean, std))
        want = want.view(images, 10, -1).mean(1)
    crop_err = float((crops.cpu() - want_crops).abs().max())
    rel = float((logits.cpu() - want).abs().max() / want.abs().max())
    ms = statistics.median(times)
    emit("v1_tencrop_eval", model="resnet50", images=[images, 3, *TENCROP_SIZE],
         crops=list(crops.shape), transforms=repr(tencrop), dtype="float32",
         crop_max_abs_err=crop_err, logits_rel_err=rel, tol=ZOO_LOGITS_TOL,
         ms_per_batch=ms, ms_per_image=ms / images, ms_all=times,
         device=torch.cuda.get_device_name(0))
    if (tuple(crops.shape) != (images, 10, 3, 224, 224) or not crop_err <= 1e-5
            or not rel <= ZOO_LOGITS_TOL):
        raise RuntimeError("v1_tencrop_eval: the v1 path on the card disagrees with "
                           "the functionals on the CPU")
    return {"ms_per_image": ms / images}


def transforms_rest_phases(kernels, rows) -> None:
    """The rest of ``transforms/``: ``warp_transforms``,
    ``keypoint_warp_train``, ``v1_tencrop_eval``. The Keypoint R-CNN
    steps' launches join the kernels line's rows (``KEYPOINT_WARP_ROWS``) as
    ``launches_keypoint_warp_train``."""
    import torch

    warp_transforms_phase()
    torch.cuda.empty_cache()
    launches = keypoint_warp_train_phase(kernels)
    torch.cuda.empty_cache()
    kernels.reset()
    v1_tencrop_eval_phase()
    emit("v1_tencrop_eval_launches", launches=kernels.launches())
    by_name = {r["name"]: r for r in rows}
    for row, counter in KEYPOINT_WARP_ROWS.items():
        by_name[row]["launches_keypoint_warp_train"] = launches[counter]


# WebP, the small classification datasets and CIFAR-10 training on the
# card (small_data_phases, last)
WEBP_FOLDER_BATCH = 32  # every file of the WebP folder, one batch
WEBP_LOGITS_TOL = 1e-4  # f32 logits on the card against the CPU's, of the largest
CIFAR_BATCH = 128
CIFAR_STEPS = 32
CIFAR_FIRST_LOSS_TOL = 2e-2  # amp step 1 against the plain path's, relative
CIFAR_PROFILED = 4  # the last steps from files, traced for the card's busy share
# Step 1's gradients of these against the plain path's are printed, not
# gated: at random init the training-mode batch norms (layer4's over 1x1
# maps) amplify a forward's round-off into the gradients (the docstring of
# tests/test_torch_train.py), so two bf16 paths part by O(1) below fc
# whatever the kernel; the kernel is held at each of the step's calls
CIFAR_GRADS = ("conv1.weight", "layer1.0.conv1.weight", "layer2.3.conv3.weight",
               "layer3.5.bn3.weight", "layer4.2.conv3.weight", "fc.weight")
# SGD from random weights at 32x32 (the ImageNet stem leaves layer4 1x1):
# at LR the losses of the first steps reach ~40; at this rate they stay
# finite and fall back by step 10 (seeded CIFAR rows, batch 64, on the CPU)
CIFAR_LR = 0.02
CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2470, 0.2435, 0.2616)
SMALL_EVAL_SIZE = 64  # the RGB datasets' samples resized for one ResNet-50 batch


def webp_folder_eval_phase(root) -> dict:
    """``webp_folder_eval``: an ``ImageFolder`` tree of every WebP fixture
    (lossy, lossless, alpha, extended, animated) and the port's JPEGs and
    PNGs (``tools/small_datasets.py:write_webp_folder``) through
    ``default_loader``, ``ClassificationPresetEval(crop_size=224)`` and
    ``DataLoader`` (threads) into ResNet-50 f32 at batch 32 on the card,
    the logits against the same batch through a CPU copy within
    ``WEBP_LOGITS_TOL`` of the largest; then ``DeviceJpegLoader`` over the
    same files, which must drop none (WebP and PNG ride its re-encode
    lane)."""
    import torch

    from vision_tpu_torch.datasets import DataLoader, ImageFolder
    from vision_tpu_torch.io import DeviceJpegLoader
    from vision_tpu_torch.io.jpeg_device import decode_threads
    from vision_tpu_torch.models import get_model
    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.parallel.presets import ClassificationPresetEval
    from vision_tpu_torch.tools import small_datasets

    dev = resolve_device(None)
    t0 = time.perf_counter()
    kinds = small_datasets.write_webp_folder(root)
    ds = ImageFolder(str(root), transform=ClassificationPresetEval(crop_size=224,
                                                                   device="cpu"))
    dl = DataLoader(ds, batch_size=WEBP_FOLDER_BATCH, num_workers=decode_threads())
    model = get_model("resnet50", seed=0)
    cpu_model = get_model("resnet50", seed=0, device="cpu")
    torch.cuda.synchronize()
    t = time.perf_counter()
    x, y = next(iter(dl))
    load_ms = (time.perf_counter() - t) * 1e3
    with torch.inference_mode():
        logits = model(x.to(dev)).cpu()
        want = cpu_model(x)
    rel = float((logits - want).abs().max() / want.abs().max())
    loader = DeviceJpegLoader(ds.samples, WEBP_FOLDER_BATCH, 224, train=False,
                              device=dev)
    n = sum(b["label"].shape[0] for b in loader)
    emit("webp_folder_eval", files=kinds, batch=list(x.shape), labels=y.tolist(),
         host_load_ms_per_image=load_ms / len(ds), logits_rel_err=rel,
         logits_tol=WEBP_LOGITS_TOL, device_loader_images=n,
         device_loader_stats=dict(loader.stats), seconds=time.perf_counter() - t0,
         device=torch.cuda.get_device_name(0))
    if (len(ds) != sum(kinds.values()) or x.shape[0] != len(ds)
            or not rel <= WEBP_LOGITS_TOL or loader.stats["dropped"] or n != len(ds)
            or loader.stats["reencode_fallback"] != kinds["webp"] + kinds["png"]):
        raise RuntimeError(f"webp_folder_eval: logits off the CPU's by {rel}, or the "
                           f"device loader's stats {loader.stats}")
    return {"logits_rel_err": rel}


def cifar_train_phase(kernels, root) -> dict:
    """``cifar_train``: CIFAR-10 at its published size (five batches of
    10,000 and a test batch, written from seeded arrays by
    ``tools/small_datasets.py:write_cifar10``, its digests handed to the
    reader) through ``CIFAR10(train=True)`` and the per-sample v2 CIFAR
    recipe (``RandomCrop(32, padding=4)``, ``RandomHorizontalFlip``,
    ``ToDtype(float32, scale=True)``, ``Normalize``), ``DataLoader``
    (threads, batch ``CIFAR_BATCH``, shuffled), into ``get_model("resnet50",
    num_classes=10, fused_bn=True)`` amp steps (SGD at ``CIFAR_LR``) for
    ``CIFAR_STEPS`` steps at 32x32 through the ``matmul_stats`` ``wgmma``
    kernel. Step 1 against one step through the plain versions on the card
    from the same weights and batch: the loss within
    ``CIFAR_FIRST_LOSS_TOL`` (the gradients of ``CIFAR_GRADS`` printed
    beside it); and the kernel at every distinct call of that plain step
    (its CIFAR shapes, down to layer4's 1x1) against the plain version,
    ``y`` within one bf16 step of its largest value and the sums within
    1e-4 (``matmul_stats_rows``' gates).
    Samples/s from the files over steps 2 to the first traced one, the
    card's busy share over the last ``CIFAR_PROFILED`` steps from files
    (``cuda_trace``: loader, copy and step), then, with the loader's pool
    joined, ms a step on a batch already on the card. Returns the
    ``wgmma`` kernel's launches and its largest error at the CIFAR calls."""
    import torch

    import vision_tpu_torch.transforms.v2 as T
    from vision_tpu_torch.datasets import DataLoader
    from vision_tpu_torch.io.jpeg_device import decode_threads
    from vision_tpu_torch.models import get_model
    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.ops._conv1x1_bn import choose_kernel
    from vision_tpu_torch.parallel import make_train_step
    from vision_tpu_torch.tools import small_datasets

    dev = resolve_device(None)
    t0 = time.perf_counter()
    lists = small_datasets.write_cifar10(root)
    tree_s = time.perf_counter() - t0
    recipe = T.Compose([T.RandomCrop(32, padding=4), T.RandomHorizontalFlip(),
                        T.ToDtype(torch.float32, scale=True),
                        T.Normalize(list(CIFAR_MEAN), list(CIFAR_STD))])
    t = time.perf_counter()
    ds = small_datasets.cifar10_class(lists)(str(root), train=True, transform=recipe)
    open_s = time.perf_counter() - t
    dl = DataLoader(ds, batch_size=CIFAR_BATCH, shuffle=True, drop_last=True,
                    num_workers=decode_threads(), seed=0)
    torch.manual_seed(0)

    def build():
        model = get_model("resnet50", num_classes=10, fused_bn=True, seed=0)
        opt = torch.optim.SGD(model.parameters(), lr=CIFAR_LR, momentum=0.9,
                              weight_decay=1e-4)
        return model, make_train_step(model, opt, compute_dtype=torch.bfloat16)

    def on_card(batch):
        return {"image": batch[0].to(dev, non_blocking=True),
                "label": batch[1].to(dev, non_blocking=True)}

    def grads_of(model):
        named = dict(model.named_parameters())
        return {n: named[n].grad.clone() for n in CIFAR_GRADS}

    batches = iter(dl)
    first = on_card(next(batches))
    calls, counts = {}, {}
    with kernels.recording(calls, counts, plain=True):
        plain_model, plain_step = build()
        plain_loss = float(plain_step(first)["loss"])
    plain_grads = grads_of(plain_model)
    del plain_model, plain_step
    model, step = build()
    kernels.reset()
    losses = [step(first)["loss"]]
    grads = grads_of(model)
    timed = CIFAR_STEPS - 1 - CIFAR_PROFILED
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(timed):
        losses.append(step(on_card(next(batches)))["loss"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    trace = cuda_trace(lambda: losses.append(step(on_card(next(batches)))["loss"]),
                       CIFAR_PROFILED)
    launches = kernels.launches()
    batches.close()  # joins the pool, whose next batch is under way
    losses = [float(v) for v in losses]
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    grad_rel = dict(zip(CIFAR_GRADS, rel_errs([grads[n] for n in CIFAR_GRADS],
                                              [plain_grads[n] for n in CIFAR_GRADS])))
    step(first)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        loss = step(first)["loss"]
    float(loss)
    step_ms = (time.perf_counter() - t) * 1e3 / 3
    wgmma, plain = kernels.counted["matmul_stats_wgmma"], kernels.plain["matmul_stats"]
    cases, off = [], []
    for args in calls.get("matmul_stats", []):
        x, w = args[:2]
        chosen = choose_kernel(x.shape[0], x.shape[1], w.shape[1], x.dtype, w.stride())
        got, want = wgmma(*args), plain(*args)
        case_rel = rel_errs(got, want)
        cases.append({"key": [list(k) if isinstance(k, tuple) else k
                              for k in matmul_key(args)],
                      "calls": counts[matmul_key(args)], "kernel": chosen,
                      "y_rel_err": case_rel[0], "s_rel_err": max(case_rel[1:]),
                      "max_abs_err": float((got[0].float() - want[0].float())
                                           .abs().max())})
        if chosen != "wgmma" or case_rel[0] > 2.0 ** -7 or max(case_rel[1:]) > 1e-4:
            off.append(cases[-1])
    busy = trace["device_ms"] / trace["wall_ms"]
    emit("cifar_train", model="resnet50", num_classes=10, fused_bn=True,
         dtype="bfloat16 (amp)", lr=CIFAR_LR, images=len(ds), tree_s=tree_s,
         open_s=open_s,
         recipe=repr(recipe), batch=CIFAR_BATCH, steps=CIFAR_STEPS,
         input=list(first["image"].shape), first_loss=losses[0],
         plain_first_loss=plain_loss, first_loss_rel_err=rel,
         loss_tol=CIFAR_FIRST_LOSS_TOL, grad_rel_err_not_gated=grad_rel,
         kernel_cases=cases, y_tol=2.0 ** -7, s_tol=1e-4,
         last_loss=losses[-1], losses=losses,
         samples_per_s_from_files=timed * CIFAR_BATCH / wall_s, timed_steps=timed,
         wall_s=wall_s, traced_steps=CIFAR_PROFILED, traced_wall_ms=trace["wall_ms"],
         traced_device_ms=trace["device_ms"], busy_share=busy, idle_share=1.0 - busy,
         step_ms_on_card_input=step_ms, launches=launches,
         workers=decode_threads(), device=torch.cuda.get_device_name(0))
    require_launched(launches, ("matmul_stats", "matmul_stats_wgmma"), "cifar_train")
    if (len(ds) != 50_000 or not all(math.isfinite(v) for v in losses)
            or rel > CIFAR_FIRST_LOSS_TOL or losses[0] == losses[-1]
            or off or not cases):
        raise RuntimeError(f"cifar_train: {len(ds)} images, losses {losses}, step 1 "
                           f"off the plain path's by {rel}, kernel cases off their "
                           f"plain version {off}")
    del model, step
    return {"launches": launches["matmul_stats_wgmma"],
            "max_abs_err": max(c["max_abs_err"] for c in cases)}


def small_datasets_phase(root) -> dict:
    """``small_datasets``: each of the 24 other readers (CIFAR-100, the MNIST
    family, FakeData and the 17 of ``_small.py``) over its few-sample tree
    (``tools/small_datasets.py:write_all``, seeded; no PIL on this
    machine): every sample read and the samples collated into uint8
    batches; then the first sample of each RGB reader, resized to
    ``SMALL_EVAL_SIZE`` and normalised, as one ResNet-50 f32 batch on the
    card against the CPU within ``ZOO_LOGITS_TOL`` of the largest. The
    trees are a few small samples each, so no time a sample is taken."""
    import torch
    import torch.nn.functional as TF

    import vision_tpu_torch.datasets as datasets
    from vision_tpu_torch.models import get_model
    from vision_tpu_torch.models._api import resolve_device
    from vision_tpu_torch.tools import small_datasets

    dev = resolve_device(None)
    t0 = time.perf_counter()
    specs = small_datasets.write_all(root)
    tree_s = time.perf_counter() - t0
    per, firsts, bad = {}, [], []
    for name, kwargs in specs.items():
        ds = small_datasets.make_dataset(datasets, name, root, kwargs)
        images = datasets.default_collate([ds[i] for i in range(len(ds))])[0]
        per[name] = {"samples": len(ds), "image": list(images.shape[1:])}
        if images.dtype != torch.uint8:
            bad.append(name)
        if small_datasets.READERS[name]:
            firsts.append(TF.interpolate(images[:1].float() / 255.0,
                                         size=(SMALL_EVAL_SIZE, SMALL_EVAL_SIZE),
                                         mode="bilinear", align_corners=False))
    mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    x = (torch.cat(firsts) - mean) / std
    with torch.inference_mode():
        logits = get_model("resnet50", seed=0)(x.to(dev)).cpu()
        want = get_model("resnet50", seed=0, device="cpu")(x)
    rel = float((logits - want).abs().max() / want.abs().max())
    emit("small_datasets", readers=len(specs), tree_s=tree_s, datasets=per,
         eval_batch=list(x.shape), logits_rel_err=rel, logits_tol=ZOO_LOGITS_TOL,
         not_uint8=bad, seconds=time.perf_counter() - t0,
         device=torch.cuda.get_device_name(0))
    if bad or len(specs) != 24 or not rel <= ZOO_LOGITS_TOL:
        raise RuntimeError(f"small_datasets: {bad} not uint8 batches, or the "
                           f"logits off by {rel}")
    return per


def small_data_phases(kernels, rows) -> None:
    """WebP, the small classification datasets and CIFAR-10 training, each
    tree in a temporary directory: ``webp_folder_eval``, ``cifar_train``,
    ``small_datasets`` (the fixtures' WebP and sampling-factor checks run in
    ``image_io``). The CIFAR steps' ``wgmma`` launches and the kernel's
    largest error at their calls join the kernels line's
    ``matmul_stats_wgmma`` row as ``launches_cifar_train`` and
    ``max_abs_err_cifar_train``."""
    import tempfile

    import torch

    tmp = tempfile.TemporaryDirectory(prefix="small_data_")
    try:
        webp_folder_eval_phase(Path(tmp.name) / "webp_folder")
        torch.cuda.empty_cache()
        cifar = cifar_train_phase(kernels, Path(tmp.name) / "cifar")
        torch.cuda.empty_cache()
        small_datasets_phase(Path(tmp.name) / "small")
    finally:
        tmp.cleanup()
    row = {r["name"]: r for r in rows}["matmul_stats_wgmma"]
    row["launches_cifar_train"] = cifar["launches"]
    row["max_abs_err_cifar_train"] = cifar["max_abs_err"]


def kernel_phases(kernels, calls, launches):
    """Each kernel against its plain version on the main path's recorded
    inputs, plus the extra RoIAlign cases (aligned, adaptive grid) on its
    P2 map and RoIs, which count in the row's error and not in its times."""
    rows = []
    for name in ("nms", "window_pool", "roi_align"):
        cases = [kernel_case(kernels, name, args, "faster_rcnn")
                 for args in calls[name]]
        extra = {}
        if name == "roi_align":
            inp, rois, size, scale = calls[name][0][:4]
            worst = max(kernel_case(kernels, name, (inp, rois, size, scale, sr,
                                                    aligned), "faster_rcnn",
                                    sampling_ratio=sr, aligned=aligned)["max_abs_err"]
                        for sr, aligned in ((2, True), (0, False)))
            extra["max_abs_err"] = max(worst, summed(cases)["max_abs_err"])
        if name in ("nms", "roi_align"):
            extra["redesigned"] = "PR 5"
        rows.append(kernel_row(name, cases, launches[name], **extra))
    return rows


if __name__ == "__main__":
    sys.exit(main())
