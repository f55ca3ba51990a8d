"""Keypoint R-CNN ResNet-50-FPN (counterpart of
``vision_tpu/models/detection/keypoint_rcnn.py``): Faster R-CNN and a
keypoint branch.

Eval: every detection row (padding rows too) pooled at 14x14 by the
windowed ``MultiScaleRoIAlign`` (the window-pool kernel on the card), the
eight-conv keypoint head and the predictor's ``[K, 56, 56]`` heatmaps,
then :func:`heatmaps_to_keypoints`, the argmax of each heatmap at its own
resolution mapped into the box (the JAX model's static-shape rule);
:func:`heatmaps_to_keypoints_exact` is the reference's per-RoI bicubic
rule, on the host.

Training: ``compute_loss(..., gt_keypoints=[N, G, K, 3])`` adds
``loss_keypoint``, the cross-entropy of each visible keypoint's cell.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from vision_tpu_torch.models._api import Weights, WeightsEnum, register_model
from vision_tpu_torch.models.detection.faster_rcnn import (
    _FEATMAPS,
    FasterRCNN,
    build_detector,
)
from vision_tpu_torch.models.detection.roi_heads import (
    KeypointRCNNHeads,
    KeypointRCNNPredictor,
    keypointrcnn_loss,
)
from vision_tpu_torch.ops.poolers import MultiScaleRoIAlign
from vision_tpu_torch.transforms._presets import ObjectDetection
from vision_tpu_torch.transforms.v2.functional._resample import resample_matrix

__all__ = ["KeypointDetections", "KeypointRCNN",
           "KeypointRCNN_ResNet50_FPN_Weights", "heatmaps_to_keypoints",
           "heatmaps_to_keypoints_exact", "keypointrcnn_resnet50_fpn"]


class KeypointDetections(NamedTuple):
    """``Detections``, ``keypoints [N, D, K, 3]`` (x, y, visibility 1) in
    the canvas's frame and ``keypoints_scores [N, D, K]`` (heatmap
    logits)."""

    boxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor
    keypoints: torch.Tensor
    keypoints_scores: torch.Tensor


def heatmaps_to_keypoints(maps: torch.Tensor, boxes: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``maps [D, K, HM, HM]``, ``boxes [D, 4]`` -> keypoints ``[D, K, 3]``
    and scores ``[D, K]``: each heatmap's first largest cell, its centre
    mapped into the box (widths and heights at least 1)."""
    d, k, hm, _ = maps.shape
    boxes = boxes.float()
    x0, y0 = boxes[:, 0:1], boxes[:, 1:2]
    ws = (boxes[:, 2:3] - x0).clamp(min=1.0)
    hs = (boxes[:, 3:4] - y0).clamp(min=1.0)
    flat = maps.float().reshape(d, k, hm * hm)
    scores, idx = flat.max(-1)
    ys = torch.div(idx, hm, rounding_mode="floor").float()
    xs = (idx % hm).float()
    x = (xs + 0.5) * (ws / hm) + x0
    y = (ys + 0.5) * (hs / hm) + y0
    return torch.stack([x, y, torch.ones_like(x)], -1), scores


def heatmaps_to_keypoints_exact(maps, boxes) -> Tuple[np.ndarray, np.ndarray]:
    """torchvision's rule, on the host: each RoI's heatmaps resized
    (bicubic) to the ceiling of its box's size, the argmax there mapped
    back with the width and height correction. ``maps [D, K, HM, HM]``,
    ``boxes [D, 4]`` (tensors or arrays) -> numpy keypoints ``[D, K, 3]``
    and scores ``[D, K]``."""
    maps = np.asarray(torch.as_tensor(maps).float().cpu(), np.float32)
    boxes = np.asarray(torch.as_tensor(boxes).float().cpu(), np.float32)
    d, k, hm, _ = maps.shape
    xy = np.zeros((d, k, 3), np.float32)
    scores = np.zeros((d, k), np.float32)
    for i in range(d):
        w = max(boxes[i, 2] - boxes[i, 0], 1.0)
        h = max(boxes[i, 3] - boxes[i, 1], 1.0)
        wc, hc = int(math.ceil(w)), int(math.ceil(h))
        wy = resample_matrix(hm, hc, "bicubic", antialias=False)
        wx = resample_matrix(hm, wc, "bicubic", antialias=False)
        up = np.einsum("ij,kjw->kiw", wy, maps[i])  # [K, hc, HM]
        up = np.einsum("ij,khj->khi", wx, up)  # [K, hc, wc]
        flat = up.reshape(k, hc * wc)
        idx = flat.argmax(axis=1)
        ys, xs = np.divmod(idx, wc)
        xy[i, :, 0] = (xs + 0.5) * (w / wc) + boxes[i, 0]
        xy[i, :, 1] = (ys + 0.5) * (h / hc) + boxes[i, 1]
        xy[i, :, 2] = 1.0
        scores[i] = flat[np.arange(k), idx]
    return xy, scores


class KeypointRCNN(FasterRCNN):
    """Faster R-CNN with ``roi_heads.keypoint_roi_pool`` (14x14, sampling
    ratio 2), ``roi_heads.keypoint_head`` (eight convs of 512) and
    ``roi_heads.keypoint_predictor``."""

    def __init__(self, *args, num_classes: int = 2, num_keypoints: int = 17,
                 **kwargs):
        super().__init__(*args, num_classes=num_classes, **kwargs)
        self.roi_heads.keypoint_roi_pool = MultiScaleRoIAlign(_FEATMAPS, 14, 2)
        self.roi_heads.keypoint_head = KeypointRCNNHeads(256, 8, 512)
        self.roi_heads.keypoint_predictor = KeypointRCNNPredictor(
            512, num_keypoints)

    def _heatmaps(self, feats, boxes, image_size) -> torch.Tensor:
        """``boxes [N, R, 4]`` -> heatmap logits ``[N, R, K, HM, HM]``."""
        n, r = boxes.shape[:2]
        heads = self.roi_heads
        pooled = heads.keypoint_roi_pool({k: feats[k] for k in _FEATMAPS},
                                         self.make_rois(boxes), image_size)
        maps = heads.keypoint_predictor(heads.keypoint_head(pooled))
        return maps.reshape(n, r, *maps.shape[1:])

    def forward(self, images: torch.Tensor, return_features: bool = False):
        image_size = tuple(images.shape[-2:])
        dets, feats = super().forward(images, return_features=True)
        maps = self._heatmaps(feats, dets.boxes, image_size)
        n, d, k = maps.shape[:3]
        kp, kp_scores = heatmaps_to_keypoints(maps.flatten(0, 1),
                                              dets.boxes.reshape(-1, 4))
        out = KeypointDetections(*dets, kp.reshape(n, d, k, 3),
                                 kp_scores.reshape(n, d, k))
        return (out, feats) if return_features else out

    def compute_loss(self, images, gt_boxes, gt_labels, gt_valid, generator,
                     gt_keypoints: Optional[torch.Tensor] = None,
                     return_internals: bool = False):
        """Faster R-CNN's losses and, given ``gt_keypoints [N, G, K, 3]``
        (canvas frame, visibility 0 for a keypoint that is not labelled),
        ``loss_keypoint``."""
        losses, internals = super().compute_loss(
            images, gt_boxes, gt_labels, gt_valid, generator,
            return_internals=True)
        if gt_keypoints is not None:
            feats, sampled, image_size = internals
            maps = self._heatmaps(feats, sampled.boxes, image_size)
            losses["loss_keypoint"] = keypointrcnn_loss(maps, sampled,
                                                        gt_keypoints)
        return (losses, internals) if return_internals else losses


def _coco(url: str, box_map: float, kp_map: float) -> Weights:
    return Weights(url=url, transforms=ObjectDetection,
                   meta={"num_params": 59137258, "_metrics": {
                       "COCO-val2017": {"box_map": box_map, "kp_map": kp_map}}})


class KeypointRCNN_ResNet50_FPN_Weights(WeightsEnum):
    COCO_LEGACY = _coco("https://download.pytorch.org/models/"
                        "keypointrcnn_resnet50_fpn_coco-9f466800.pth", 50.6, 61.1)
    COCO_V1 = _coco("https://download.pytorch.org/models/"
                    "keypointrcnn_resnet50_fpn_coco-fc266e95.pth", 54.6, 65.0)
    DEFAULT = COCO_V1


@register_model()
def keypointrcnn_resnet50_fpn(
    *,
    weights: Optional[Union[KeypointRCNN_ResNet50_FPN_Weights, Weights, str]] = None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trainable_backbone_layers: Optional[int] = None,
    num_classes: int = 2,
    num_keypoints: int = 17,
    **kwargs,
) -> KeypointRCNN:
    """Keypoint R-CNN ResNet-50-FPN, 2 classes and 17 keypoints
    (``faster_rcnn.build_detector``)."""
    return build_detector(KeypointRCNN, weights,
                          KeypointRCNN_ResNet50_FPN_Weights, device, seed,
                          trainable_backbone_layers, num_classes=num_classes,
                          num_keypoints=num_keypoints, **kwargs)
