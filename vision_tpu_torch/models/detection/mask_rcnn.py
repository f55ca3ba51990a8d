"""Mask R-CNN ResNet-50-FPN, v1 and v2 (counterpart of
``vision_tpu/models/detection/mask_rcnn.py``): Faster R-CNN and a mask
branch. v2's mask head has batch norm (``MaskRCNNHeads(use_norm=True)``).

Eval: the detections of the box path, then every one of their
``detections_per_img`` rows an image (the padding rows too, whose boxes
are candidates clipped to the canvas) pooled at 14x14 by the windowed
``MultiScaleRoIAlign`` (the window-pool kernel on the card), the mask
head and predictor, and the sigmoid's channel of each row's label:
``MaskDetections.masks [N, D, 28, 28]``, probabilities in each box's frame
(``roi_heads.paste_masks_in_image`` pastes them into an image).

Training: ``compute_loss(..., gt_masks=[N, G, H, W])`` adds
``loss_mask`` to Faster R-CNN's four losses: the sampled proposals pooled
at 14x14, and their targets pooled from the gt masks by ``roi_align`` at
28x28 and one channel (the RoIAlign kernel on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch

from vision_tpu_torch.models._api import Weights, WeightsEnum, register_model
from vision_tpu_torch.models.detection.faster_rcnn import (
    _FEATMAPS,
    FasterRCNN,
    build_detector,
)
from vision_tpu_torch.models.detection.roi_heads import (
    MaskRCNNHeads,
    MaskRCNNPredictor,
    maskrcnn_loss,
)
from vision_tpu_torch.ops.poolers import MultiScaleRoIAlign
from vision_tpu_torch.transforms._presets import ObjectDetection

__all__ = ["MaskDetections", "MaskRCNN", "MaskRCNN_ResNet50_FPN_V2_Weights",
           "MaskRCNN_ResNet50_FPN_Weights", "maskrcnn_resnet50_fpn",
           "maskrcnn_resnet50_fpn_deform", "maskrcnn_resnet50_fpn_v2"]


class MaskDetections(NamedTuple):
    """``Detections`` and ``masks [N, D, M, M]``, each row's probabilities
    in its box's frame."""

    boxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor
    masks: torch.Tensor


class MaskRCNN(FasterRCNN):
    """Faster R-CNN with ``roi_heads.mask_roi_pool`` (14x14, sampling ratio
    2), ``roi_heads.mask_head`` (four convs of 256, with batch norm in v2)
    and ``roi_heads.mask_predictor``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        num_classes = self.roi_heads.box_predictor.cls_score.out_features
        self.roi_heads.mask_roi_pool = MultiScaleRoIAlign(_FEATMAPS, 14, 2)
        self.roi_heads.mask_head = MaskRCNNHeads(256, 4, 256,
                                                 use_norm=self.v2)
        self.roi_heads.mask_predictor = MaskRCNNPredictor(256, 256, num_classes)

    def _mask_logits(self, feats, boxes, image_size) -> torch.Tensor:
        """``boxes [N, R, 4]`` -> mask logits ``[N, R, classes, M, M]``."""
        n, r = boxes.shape[:2]
        heads = self.roi_heads
        pooled = heads.mask_roi_pool({k: feats[k] for k in _FEATMAPS},
                                     self.make_rois(boxes), image_size)
        logits = heads.mask_predictor(heads.mask_head(pooled))
        return logits.reshape(n, r, *logits.shape[1:])

    def masks(self, feats, boxes, labels, image_size) -> torch.Tensor:
        """The mask probabilities ``[N, R, M, M]`` of ``boxes [N, R, 4]``:
        the sigmoid's channel of each row's label."""
        logits = self._mask_logits(feats, boxes, image_size)
        m = logits.shape[-1]
        idx = labels[:, :, None, None, None].expand(-1, -1, 1, m, m)
        return torch.gather(torch.sigmoid(logits), 2, idx)[:, :, 0]

    def forward(self, images: torch.Tensor, return_features: bool = False):
        image_size = tuple(images.shape[-2:])
        dets, feats = super().forward(images, return_features=True)
        out = MaskDetections(*dets, self.masks(feats, dets.boxes, dets.labels,
                                                image_size))
        return (out, feats) if return_features else out

    def compute_loss(self, images, gt_boxes, gt_labels, gt_valid, generator,
                     gt_masks: Optional[torch.Tensor] = None,
                     return_internals: bool = False):
        """Faster R-CNN's losses and, given ``gt_masks [N, G, H, W]``
        (canvas frame, 0/1, padding rows anything), ``loss_mask``."""
        losses, internals = super().compute_loss(
            images, gt_boxes, gt_labels, gt_valid, generator,
            return_internals=True)
        if gt_masks is not None:
            feats, sampled, image_size = internals
            head = self.roi_heads.mask_head
            training = head.training
            head.eval()  # v2: the running statistics, as in the JAX loss
            try:
                logits = self._mask_logits(feats, sampled.boxes, image_size)
            finally:
                head.train(training)
            losses["loss_mask"] = maskrcnn_loss(logits, sampled, gt_masks)
        return (losses, internals) if return_internals else losses


class MaskRCNN_ResNet50_FPN_Weights(WeightsEnum):
    COCO_V1 = Weights(
        url="https://download.pytorch.org/models/"
        "maskrcnn_resnet50_fpn_coco-bf2d0c1e.pth",
        transforms=ObjectDetection,
        meta={"num_params": 44401393,
              "_metrics": {"COCO-val2017": {"box_map": 37.9, "mask_map": 34.6}}},
    )
    DEFAULT = COCO_V1


@register_model()
def maskrcnn_resnet50_fpn(
    *,
    weights: Optional[Union[MaskRCNN_ResNet50_FPN_Weights, Weights, str]] = None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trainable_backbone_layers: Optional[int] = None,
    **kwargs,
) -> MaskRCNN:
    """Mask R-CNN ResNet-50-FPN v1 (``faster_rcnn.build_detector``)."""
    return build_detector(MaskRCNN, weights, MaskRCNN_ResNet50_FPN_Weights,
                          device, seed, trainable_backbone_layers, **kwargs)


class MaskRCNN_ResNet50_FPN_V2_Weights(WeightsEnum):
    COCO_V1 = Weights(
        url="https://download.pytorch.org/models/"
        "maskrcnn_resnet50_fpn_v2_coco-73cbd019.pth",
        transforms=ObjectDetection,
        meta={"num_params": 46359409,
              "_metrics": {"COCO-val2017": {"box_map": 47.4, "mask_map": 41.8}}},
    )
    DEFAULT = COCO_V1


@register_model()
def maskrcnn_resnet50_fpn_v2(
    *,
    weights: Optional[Union[MaskRCNN_ResNet50_FPN_V2_Weights, Weights, str]] = None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trainable_backbone_layers: Optional[int] = None,
    **kwargs,
) -> MaskRCNN:
    """Mask R-CNN ResNet-50-FPN v2 (``MaskRCNN(v2=True)``,
    ``faster_rcnn.build_detector``)."""
    return build_detector(MaskRCNN, weights, MaskRCNN_ResNet50_FPN_V2_Weights,
                          device, seed, trainable_backbone_layers, v2=True,
                          **kwargs)


@register_model()
def maskrcnn_resnet50_fpn_deform(
    *,
    weights: Optional[Union[MaskRCNN_ResNet50_FPN_Weights, Weights, str]] = None,
    deform_stages: Sequence[int] = (2, 3, 4),
    deform_modulated: bool = False,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trainable_backbone_layers: Optional[int] = None,
    **kwargs,
) -> MaskRCNN:
    """Mask R-CNN ResNet-50-FPN with deformable 3x3 convolutions in the
    trunk's C3-C5 bottlenecks (the JAX package's ``maskrcnn_resnet50_fpn_
    deform``, BASELINE config 5; DCNv2 with ``deform_modulated``). Its offset
    predictors start at zero, so that a plain ``MaskRCNN_ResNet50_FPN_Weights``
    checkpoint loads (they stay zero) and the model then computes what the
    plain one does; without weights every other parameter is the plain
    model's of the same seed."""
    return build_detector(MaskRCNN, weights, MaskRCNN_ResNet50_FPN_Weights,
                          device, seed, trainable_backbone_layers,
                          deform_stages=tuple(deform_stages),
                          deform_modulated=deform_modulated, **kwargs)
