"""FCOS ResNet-50-FPN (counterpart of
``vision_tpu/models/detection/fcos.py``): anchor-free detection with a
centre-ness branch and GIoU regression.

Backbone (the frozen-BN ResNet's C3-C5, an FPN of 256 channels, P6 and P7
of P5 through ``LastLevelP6P7``) -> the shared classification and
regression towers (four 3x3 convolutions, each followed by
``GroupNorm(32)`` and a ReLU) on every level -> per level ``(cls_logits
[N, H*W, K], bbox_reg [N, H*W, 4], bbox_ctrness [N, H*W, 1], anchors [H*W,
4])``, one anchor a location whose size is the level's stride. The box
branch ends in a ReLU: its outputs are the distances from the anchor's
centre to the box's edges over the anchor's size (``BoxLinearCoder``).

``postprocess_detections`` scores each (location, class) as
``sqrt(sigmoid(cls) * sigmoid(ctrness))``, keeps per image and level the
top ``topk_candidates`` (``ops/_topk.py:top_k_2d``), decodes and clips
their boxes and runs one class-aware NMS an image across the levels
(``batched_nms_mask``: on the card the bitmask kernel of ``csrc/nms.cu``),
as fixed-size ``Detections`` of ``detections_per_img`` rows.
``compute_loss`` matches each location to the smallest gt box whose
centre region (``center_sampling_radius`` anchor sizes) and scale range
(4 to 8 anchor sizes, open at the first and last levels) hold it, and gives
the sigmoid focal loss of the classes, the GIoU loss of the boxes and the
binary cross-entropy of the centre-ness, each summed over an image over
its number of foreground locations (at least 1), then averaged over the
images, in f32.

Amp (bf16) is the JAX package's switch: ``model.to(torch.bfloat16)`` and
a bf16 canvas; the scores, decoding, NMS and losses run in f32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models._api import Weights, WeightsEnum, register_model
from vision_tpu_torch.models.detection._utils import BoxLinearCoder
from vision_tpu_torch.models.detection.anchor_utils import AnchorGenerator
from vision_tpu_torch.models.detection.backbone_utils import BackboneWithFPN
from vision_tpu_torch.models.detection.faster_rcnn import (
    _upgrade_state_dict as _upgrade_fpn_state_dict,
    build_detector,
)
from vision_tpu_torch.models.detection.retinanet import (
    _LEVELS,
    init_retinanet_weights,
)
from vision_tpu_torch.models.detection.roi_heads import Detections
from vision_tpu_torch.ops._topk import top_k, top_k_2d
from vision_tpu_torch.ops.feature_pyramid_network import LastLevelP6P7
from vision_tpu_torch.ops.losses import (
    generalized_box_iou_loss,
    sigmoid_focal_loss,
)
from vision_tpu_torch.ops.misc import GroupNorm
from vision_tpu_torch.ops.nms import batched_nms_mask
from vision_tpu_torch.transforms._presets import ObjectDetection

__all__ = ["FCOS", "FCOSHead", "FCOS_ResNet50_FPN_Weights", "fcos_resnet50_fpn"]


def _tower(channels: int, num_convs: int) -> nn.Sequential:
    """torchvision's flat ``conv`` list: [Conv2d, GroupNorm(32), ReLU] a
    layer (``conv.{3i}``, ``conv.{3i+1}``)."""
    layers: List[nn.Module] = []
    for _ in range(num_convs):
        layers += [nn.Conv2d(channels, channels, 3, padding=1),
                   GroupNorm(32, channels), nn.ReLU()]
    return nn.Sequential(*layers)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` -> ``[N, H*W, C]``."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, c)


class _ClassificationHead(nn.Module):
    def __init__(self, channels: int, num_classes: int, num_convs: int):
        super().__init__()
        self.conv = _tower(channels, num_convs)
        self.cls_logits = nn.Conv2d(channels, num_classes, 3, padding=1)


class _RegressionHead(nn.Module):
    def __init__(self, channels: int, num_convs: int):
        super().__init__()
        self.conv = _tower(channels, num_convs)
        self.bbox_reg = nn.Conv2d(channels, 4, 3, padding=1)
        self.bbox_ctrness = nn.Conv2d(channels, 1, 3, padding=1)


class FCOSHead(nn.Module):
    """The classification tower (``classification_head.conv``,
    ``.cls_logits``) and the regression tower (``regression_head.conv``,
    ``.bbox_reg``, ``.bbox_ctrness``), torchvision's names, each shared by
    every level. Returns per level ``cls_logits [N, H*W, K]``, ``bbox_reg
    [N, H*W, 4]`` (after a ReLU) and ``bbox_ctrness [N, H*W, 1]``."""

    def __init__(self, in_channels: int, num_classes: int, num_convs: int = 4):
        super().__init__()
        self.classification_head = _ClassificationHead(in_channels, num_classes,
                                                       num_convs)
        self.regression_head = _RegressionHead(in_channels, num_convs)

    def forward(self, features: List[torch.Tensor]):
        cls_h, reg_h = self.classification_head, self.regression_head
        logits, reg, ctr = [], [], []
        for f in features:
            logits.append(_flat(cls_h.cls_logits(cls_h.conv(f))))
            t = reg_h.conv(f)
            reg.append(_flat(F.relu(reg_h.bbox_reg(t))))
            ctr.append(_flat(reg_h.bbox_ctrness(t)))
        return logits, reg, ctr


class FCOS(nn.Module):
    """FCOS on a padded NCHW canvas (``GeneralizedRCNNTransform``'s)."""

    def __init__(
        self,
        backbone_depth: int = 50,
        num_classes: int = 91,
        score_thresh: float = 0.2,
        nms_thresh: float = 0.6,
        detections_per_img: int = 100,
        topk_candidates: int = 1000,
        center_sampling_radius: float = 1.5,
    ):
        super().__init__()
        # P6 of P5: in_channels == out_channels
        self.backbone = BackboneWithFPN(
            backbone_depth, 256, returned_layers=(2, 3, 4),
            extra_blocks=LastLevelP6P7(256, 256))
        sizes = ((8,), (16,), (32,), (64,), (128,))
        self.anchor_generator = AnchorGenerator(sizes, ((1.0,),) * len(sizes))
        self.head = FCOSHead(256, num_classes)
        self.box_coder = BoxLinearCoder(normalize_by_size=True)
        self.num_classes = num_classes
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_img = detections_per_img
        self.topk_candidates = topk_candidates
        self.center_sampling_radius = center_sampling_radius

    def forward(self, images: torch.Tensor, return_features: bool = False):
        """``(cls_logits, bbox_reg, bbox_ctrness, anchors)``, each a list
        over P3-P7; with ``return_features`` also the FPN's feature
        dict."""
        feats = self.backbone(images)
        features = [feats[k] for k in _LEVELS]
        logits, reg, ctr = self.head(features)
        anchors = self.anchor_generator(
            tuple(images.shape[-2:]), [tuple(f.shape[-2:]) for f in features],
            images.device)
        out = (logits, reg, ctr, anchors)
        return (out, feats) if return_features else out

    def postprocess_detections(
        self,
        cls_logits: List[torch.Tensor],
        bbox_reg: List[torch.Tensor],
        bbox_ctrness: List[torch.Tensor],
        anchors: List[torch.Tensor],
        image_size: Tuple[int, int],
    ) -> Detections:
        """Per image and level the top ``topk_candidates`` scores
        ``sqrt(sigmoid(cls) * sigmoid(ctrness))`` over (location, class),
        above ``score_thresh``; their boxes decoded and clipped to
        ``image_size``; one class-aware NMS an image over every level's
        candidates; the top ``detections_per_img`` kept."""
        h, w = image_size
        boxes_l, scores_l, labels_l = [], [], []
        for lg, rg, ct, anch in zip(cls_logits, bbox_reg, bbox_ctrness, anchors):
            k_cls = lg.shape[-1]
            scores = torch.sqrt(torch.sigmoid(lg.float())
                                * torch.sigmoid(ct.float()))  # [N, R, K]
            k = min(self.topk_candidates, scores.shape[1] * k_cls)
            top_scores, top_idx = top_k_2d(scores, k)
            anchor_idx = top_idx // k_cls
            sel = torch.gather(rg, 1, anchor_idx[..., None].expand(-1, -1, 4))
            dec = self.box_coder.decode(sel, anch[anchor_idx])
            x = dec[..., 0::2].clamp(0, w)
            y = dec[..., 1::2].clamp(0, h)
            boxes_l.append(
                torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1))
            scores_l.append(top_scores)
            labels_l.append(top_idx % k_cls)
        boxes = torch.cat(boxes_l, 1)
        scores = torch.cat(scores_l, 1)
        labels = torch.cat(labels_l, 1)
        keep = batched_nms_mask(boxes, scores, labels, self.nms_thresh,
                                valid=scores > self.score_thresh)
        kept = torch.where(keep, scores, torch.full_like(scores, -1.0))
        top_scores, top_idx = top_k(
            kept, min(self.detections_per_img, kept.shape[1]))
        return Detections(
            torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
            torch.where(top_scores > 0, top_scores, torch.zeros_like(top_scores)),
            torch.gather(labels, 1, top_idx),
            top_scores > 0,
        )

    def match(self, all_anchors: torch.Tensor, sizes: List[int],
              gt_boxes: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
        """Each location's gt ``[N, R]`` (-1 for none): of the valid gts
        whose box holds the anchor's centre, whose centre lies within
        ``center_sampling_radius`` anchor sizes of it (Chebyshev) and whose
        farthest edge lies in the level's range (4 to 8 anchor sizes, from
        0 at the first level and without end at the last), the one of
        least area (the first on ties)."""
        r = all_anchors.shape[0]
        anchor_sizes = all_anchors[:, 2] - all_anchors[:, 0]
        lower = anchor_sizes * 4
        upper = anchor_sizes * 8
        lower[: sizes[0]] = 0.0
        upper[r - sizes[-1]:] = torch.inf
        centers = (all_anchors[:, :2] + all_anchors[:, 2:]) / 2  # [R, 2]
        gt_centers = (gt_boxes[..., :2] + gt_boxes[..., 2:]) / 2  # [N, G, 2]
        pm = ((centers[None, :, None] - gt_centers[:, None]).abs().amax(-1)
              < self.center_sampling_radius * anchor_sizes[None, :, None])
        x, y = centers[None, :, None, 0], centers[None, :, None, 1]
        b = gt_boxes[:, None]  # [N, 1, G, 4]
        dist = torch.stack([x - b[..., 0], y - b[..., 1], b[..., 2] - x,
                            b[..., 3] - y], -1)  # [N, R, G, 4]
        pm &= dist.amin(-1) > 0
        dmax = dist.amax(-1)
        pm &= (dmax > lower[None, :, None]) & (dmax < upper[None, :, None])
        pm &= gt_valid[:, None, :]
        areas = ((gt_boxes[..., 2] - gt_boxes[..., 0])
                 * (gt_boxes[..., 3] - gt_boxes[..., 1]))
        score = pm.float() * (1e8 - areas[:, None, :])
        return torch.where(score.amax(-1) < 1e-5, -1, score.argmax(-1))

    def compute_loss(
        self,
        cls_logits: List[torch.Tensor],
        bbox_reg: List[torch.Tensor],
        bbox_ctrness: List[torch.Tensor],
        anchors: List[torch.Tensor],
        gt_boxes: torch.Tensor,
        gt_labels: torch.Tensor,
        gt_valid: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        """``{"classification", "bbox_regression", "bbox_ctrness"}`` for
        ``gt_boxes [N, G, 4]`` (canvas frame), ``gt_labels [N, G]`` and
        ``gt_valid [N, G]`` (padding rows False), in f32 (``match`` gives
        each location's gt)."""
        logits = torch.cat(cls_logits, 1).float()  # [N, R, K]
        reg = torch.cat(bbox_reg, 1).float()
        ctr = torch.cat(bbox_ctrness, 1).float()[..., 0]
        all_anchors = torch.cat(anchors, 0)
        gt_boxes = gt_boxes.float()
        matched = self.match(all_anchors, [a.shape[0] for a in anchors],
                             gt_boxes, gt_valid)
        fg = matched >= 0
        fgf = fg.float()
        num_fg = fg.sum(1).clamp(min=1)
        idx = matched.clamp(min=0)
        labels = torch.gather(gt_labels.long(), 1, idx)
        gt_cls = torch.zeros_like(logits).scatter_(2, labels[..., None],
                                                   fgf[..., None])
        cls_loss = sigmoid_focal_loss(logits, gt_cls).sum((1, 2)) / num_fg

        gt_b = torch.gather(gt_boxes, 1, idx[..., None].expand(-1, -1, 4))
        pred = self.box_coder.decode(reg, all_anchors)
        giou = generalized_box_iou_loss(pred, gt_b, reduction="none")
        reg_loss = (giou * fgf).sum(1) / num_fg

        t = self.box_coder.encode(gt_b, all_anchors)
        lr, tb = t[..., 0::2], t[..., 1::2]
        ctr_t = torch.sqrt(
            (lr.amin(-1) / lr.amax(-1).clamp(min=1e-6)
             * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-6))).clamp(min=0.0))
        bce = ctr.clamp(min=0) - ctr * ctr_t + torch.log1p(torch.exp(-ctr.abs()))
        ctr_loss = (bce * fgf).sum(1) / num_fg
        return {"classification": cls_loss.mean(),
                "bbox_regression": reg_loss.mean(),
                "bbox_ctrness": ctr_loss.mean()}


class FCOS_ResNet50_FPN_Weights(WeightsEnum):
    COCO_V1 = Weights(
        url="https://download.pytorch.org/models/fcos_resnet50_fpn_coco-99b0c9b7.pth",
        transforms=ObjectDetection,
        meta={"num_params": 32269600,
              "_metrics": {"COCO-val2017": {"box_map": 39.2}}},
    )
    DEFAULT = COCO_V1


def _upgrade_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The FPN renames of ``faster_rcnn._upgrade_state_dict``; an anchors
    buffer is dropped (the JAX package's ``_fcos_hooks``)."""
    return {k: v for k, v in _upgrade_fpn_state_dict(sd).items()
            if ".anchors" not in k}


@register_model()
def fcos_resnet50_fpn(
    *,
    weights: Optional[Union[FCOS_ResNet50_FPN_Weights, Weights, str]] = None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trainable_backbone_layers: Optional[int] = None,
    **kwargs,
) -> FCOS:
    """FCOS ResNet-50-FPN (``build_detector``; initialised as RetinaNet
    is, the classification bias at the prior 0.01)."""
    return build_detector(FCOS, weights, FCOS_ResNet50_FPN_Weights, device,
                          seed, trainable_backbone_layers,
                          init=init_retinanet_weights,
                          upgrade=_upgrade_state_dict, **kwargs)
