"""RetinaNet ResNet-50-FPN, v1 and v2 (counterpart of
``vision_tpu/models/detection/retinanet.py``).

Backbone (C3-C5 of a ResNet-50, FPN of 256 channels, P6 and P7 from
``LastLevelP6P7``) -> the shared classification and regression towers on
every level -> ``(cls_logits, bbox_reg, anchors)``, per level, anchor-major
``[N, H*W*A, K]`` as the anchors lie. ``postprocess_detections`` keeps,
per image and level, the top ``topk_candidates`` (anchor, class) scores
(``ops/_topk.py:top_k_2d``), decodes and clips their boxes and runs one
class-aware NMS across all levels (``batched_nms_mask``: on the card the
bitmask kernel of ``csrc/nms.cu``), as fixed-size ``Detections`` of
``detections_per_img`` rows with a ``valid`` mask: no host
synchronisation. ``compute_loss`` gives the focal loss of the classes and
the L1 loss of the boxes, in f32.

v1: frozen batch norm in the trunk, plain convolutions with biases in the
towers, P6 from P5. v2: live batch norm in the trunk, bias-free
convolutions each followed by ``GroupNorm(32)`` in the towers, P6 from C5.

Amp (bf16) is the JAX package's switch: ``model.to(torch.bfloat16)`` and
a bf16 canvas for serving, ``compute_dtype=torch.bfloat16`` for training.
The scores' sigmoid, box decoding, NMS and both losses run in f32, so
boxes and scores come out f32.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from vision_tpu_torch.models._api import Weights, WeightsEnum, register_model
from vision_tpu_torch.models.detection._utils import (
    BETWEEN_THRESHOLDS,
    BoxCoder,
    Matcher,
    unit_box_where,
)
from vision_tpu_torch.models.detection.anchor_utils import AnchorGenerator
from vision_tpu_torch.models.detection.backbone_utils import (
    _DEPTHS,
    BackboneWithFPN,
)
from vision_tpu_torch.models.detection.faster_rcnn import (
    _upgrade_state_dict as _upgrade_fpn_state_dict,
    build_detector,
    init_weights,
)
from vision_tpu_torch.models.detection.roi_heads import Detections
from vision_tpu_torch.ops._topk import top_k, top_k_2d
from vision_tpu_torch.ops.boxes import box_iou
from vision_tpu_torch.ops.feature_pyramid_network import LastLevelP6P7
from vision_tpu_torch.ops.losses import sigmoid_focal_loss
from vision_tpu_torch.ops.misc import GroupNorm
from vision_tpu_torch.ops.nms import batched_nms_mask
from vision_tpu_torch.transforms._presets import ObjectDetection

__all__ = [
    "Detections",
    "RetinaNet",
    "RetinaNetHead",
    "RetinaNet_ResNet50_FPN_Weights",
    "RetinaNet_ResNet50_FPN_V2_Weights",
    "init_retinanet_weights",
    "retinanet_resnet50_fpn",
    "retinanet_resnet50_fpn_v2",
]

_LEVELS = ("0", "1", "2", "p6", "p7")
# the classification bias's prior probability of a foreground class
_PRIOR = 0.01


def _default_anchorgen() -> AnchorGenerator:
    """Three sizes an octave and three aspect ratios at each of P3-P7."""
    sizes = tuple((x, int(x * 2 ** (1.0 / 3)), int(x * 2 ** (2.0 / 3)))
                  for x in (32, 64, 128, 256, 512))
    return AnchorGenerator(sizes, ((0.5, 1.0, 2.0),) * len(sizes))


class _Tower(nn.Module):
    """Four 3x3 convolutions with ReLUs (v2: bias-free, each followed by
    ``GroupNorm(32)``), then the 3x3 predictor ``final`` of ``per_anchor``
    values an anchor. ``forward`` maps one level's NCHW map to ``[N,
    H*W*A, per_anchor]`` in the anchors' (h, w, a) order."""

    def __init__(self, channels: int, num_anchors: int, per_anchor: int,
                 final: str, use_norm: bool):
        super().__init__()
        self.conv = nn.Sequential(*[
            nn.Sequential(
                nn.Conv2d(channels, channels, 3, padding=1, bias=not use_norm),
                *([GroupNorm(32, channels)] if use_norm else []),
                nn.ReLU(inplace=True))
            for _ in range(4)])
        self.add_module(final, nn.Conv2d(channels, num_anchors * per_anchor, 3,
                                         padding=1))
        self.final = final
        self.num_anchors = num_anchors
        self.per_anchor = per_anchor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = getattr(self, self.final)(self.conv(x))  # [N, A*P, H, W]
        n, _, h, w = out.shape
        return out.view(n, self.num_anchors, self.per_anchor, h, w).permute(
            0, 3, 4, 1, 2).reshape(n, h * w * self.num_anchors, self.per_anchor)


class RetinaNetHead(nn.Module):
    """The classification tower (``classification_head.conv``,
    ``.cls_logits``) and the regression tower (``regression_head.conv``,
    ``.bbox_reg``), torchvision's names, each shared by every level.
    Returns per level ``cls_logits [N, H*W*A, K]`` and ``bbox_reg [N,
    H*W*A, 4]``."""

    def __init__(self, in_channels: int, num_anchors: int, num_classes: int,
                 use_norm: bool = False):
        super().__init__()
        self.classification_head = _Tower(in_channels, num_anchors,
                                          num_classes, "cls_logits", use_norm)
        self.regression_head = _Tower(in_channels, num_anchors, 4, "bbox_reg",
                                      use_norm)

    def forward(self, features: List[torch.Tensor]):
        return ([self.classification_head(f) for f in features],
                [self.regression_head(f) for f in features])


class RetinaNet(nn.Module):
    """RetinaNet on a padded NCHW canvas (``GeneralizedRCNNTransform``'s).
    ``v2`` sets what the JAX package's ``use_head_norm``, ``use_p5_for_p6``
    and ``frozen_backbone_bn`` set together: GroupNorm in the towers, P6
    of C5, live batch norm in the trunk."""

    def __init__(
        self,
        backbone_depth: int = 50,
        num_classes: int = 91,
        v2: bool = False,
        score_thresh: float = 0.05,
        nms_thresh: float = 0.5,
        detections_per_img: int = 300,
        topk_candidates: int = 1000,
        fg_iou_thresh: float = 0.5,
        bg_iou_thresh: float = 0.4,
    ):
        super().__init__()
        c5 = 512 * _DEPTHS[backbone_depth][0].expansion
        self.backbone = BackboneWithFPN(
            backbone_depth, 256, returned_layers=(2, 3, 4),
            extra_blocks=LastLevelP6P7(c5 if v2 else 256, 256),
            frozen_bn=not v2)
        self.anchor_generator = _default_anchorgen()
        self.head = RetinaNetHead(
            256, self.anchor_generator.num_anchors_per_location()[0],
            num_classes, use_norm=v2)
        self.box_coder = BoxCoder(weights=(1.0, 1.0, 1.0, 1.0))
        self.proposal_matcher = Matcher(fg_iou_thresh, bg_iou_thresh,
                                        allow_low_quality_matches=True)
        self.num_classes = num_classes
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_img = detections_per_img
        self.topk_candidates = topk_candidates

    def forward(self, images: torch.Tensor, return_features: bool = False):
        """``(cls_logits, bbox_reg, anchors)``, each a list over P3-P7;
        with ``return_features`` also the FPN's feature dict."""
        feats = self.backbone(images)
        features = [feats[k] for k in _LEVELS]
        cls_logits, bbox_reg = self.head(features)
        anchors = self.anchor_generator(
            tuple(images.shape[-2:]), [tuple(f.shape[-2:]) for f in features],
            images.device)
        out = (cls_logits, bbox_reg, anchors)
        return (out, feats) if return_features else out

    def postprocess_detections(
        self,
        cls_logits: List[torch.Tensor],
        bbox_reg: List[torch.Tensor],
        anchors: List[torch.Tensor],
        image_size: Tuple[int, int],
    ) -> Detections:
        """Per image and level the top ``topk_candidates`` sigmoid scores
        over (anchor, class), above ``score_thresh``; their boxes decoded
        and clipped to ``image_size``; one class-aware NMS per image over
        every level's candidates; the top ``detections_per_img`` kept."""
        h, w = image_size
        boxes_l, scores_l, labels_l = [], [], []
        for logits, reg, anch in zip(cls_logits, bbox_reg, anchors):
            k_cls = logits.shape[-1]
            scores = torch.sigmoid(logits.float())  # [N, R, K]
            k = min(self.topk_candidates, scores.shape[1] * k_cls)
            top_scores, top_idx = top_k_2d(scores, k)  # [N, k]
            anchor_idx = top_idx // k_cls
            sel = torch.gather(reg, 1, anchor_idx[..., None].expand(-1, -1, 4))
            dec = self.box_coder.decode(sel, anch[anchor_idx])[:, :, 0]
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

    def compute_loss(
        self,
        cls_logits: List[torch.Tensor],
        bbox_reg: List[torch.Tensor],
        anchors: List[torch.Tensor],
        gt_boxes: torch.Tensor,
        gt_labels: torch.Tensor,
        gt_valid: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        """``{"classification", "bbox_regression"}`` for ``gt_boxes [N, G,
        4]`` (canvas frame), ``gt_labels [N, G]`` and ``gt_valid [N, G]``
        (padding rows False): each anchor matched to its gt (IoU >= 0.5
        foreground, < 0.4 background, low-quality matches kept); the
        sigmoid focal loss over every class of the anchors that are not
        between the thresholds, and the L1 loss of the foreground anchors'
        deltas, each summed over an image over its number of foreground
        anchors (at least 1), then averaged over the images. Both in f32
        whatever the logits' type.

        Unlike the JAX package, anchors that are not foreground are encoded
        against a unit box, as ``rpn.py:compute_loss`` does: their matched
        gt can be a padding row of zeros, whose ``log(0)`` target would
        reach the masked loss as ``inf * 0``."""
        logits = torch.cat(cls_logits, 1).float()  # [N, R, K]
        reg = torch.cat(bbox_reg, 1).float()  # [N, R, 4]
        all_anchors = torch.cat(anchors, 0)  # [R, 4]
        matched = self.proposal_matcher(box_iou(gt_boxes.float(), all_anchors),
                                        valid_gt=gt_valid)  # [N, R]
        fg = matched >= 0
        num_fg = fg.sum(1).clamp(min=1)
        idx = matched.clamp(min=0)
        labels = torch.gather(gt_labels.long(), 1, idx)
        gt_cls = torch.zeros_like(logits).scatter_(
            2, labels[..., None], fg[..., None].to(logits.dtype))
        focal = sigmoid_focal_loss(logits, gt_cls)
        keep = (matched != BETWEEN_THRESHOLDS)[..., None]
        cls_loss = (focal * keep).sum((1, 2)) / num_fg

        matched_boxes = torch.gather(gt_boxes.float(), 1,
                                     idx[..., None].expand(-1, -1, 4))
        target = self.box_coder.encode(
            unit_box_where(fg, matched_boxes),
            unit_box_where(fg, all_anchors.expand_as(matched_boxes)))
        reg_loss = ((reg - target).abs().sum(-1) * fg).sum(1) / num_fg
        return {"classification": cls_loss.mean(),
                "bbox_regression": reg_loss.mean()}


@torch.no_grad()
def init_retinanet_weights(model: RetinaNet, generator: torch.Generator) -> None:
    """torchvision's initialisation (``init_weights``: the towers' and
    predictors' convolutions N(0, 0.01) with zero bias, P6 and P7 as the
    FPN's), with the classification predictor's bias at the prior
    probability: ``-log((1 - 0.01) / 0.01)``."""
    init_weights(model, generator)
    model.head.classification_head.cls_logits.bias.fill_(
        -math.log((1 - _PRIOR) / _PRIOR))


def _coco_weights(url: str, box_map: float, num_params: int) -> Weights:
    return Weights(url=url, transforms=ObjectDetection,
                   meta={"num_params": num_params,
                         "_metrics": {"COCO-val2017": {"box_map": box_map}}})


class RetinaNet_ResNet50_FPN_Weights(WeightsEnum):
    COCO_V1 = _coco_weights(
        "https://download.pytorch.org/models/"
        "retinanet_resnet50_fpn_coco-eeacb38b.pth", 36.4, 34014999)
    DEFAULT = COCO_V1


class RetinaNet_ResNet50_FPN_V2_Weights(WeightsEnum):
    COCO_V1 = _coco_weights(
        "https://download.pytorch.org/models/"
        "retinanet_resnet50_fpn_v2_coco-5905b1c5.pth", 41.5, 38198935)
    DEFAULT = COCO_V1


def _upgrade_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The FPN renames of ``faster_rcnn._upgrade_state_dict``; a v1 head
    saved before torchvision wrapped the towers' convolutions
    (``head.*.conv.{i}.weight``) goes to ``conv.{i}.0``; an anchors buffer
    is dropped (the JAX package's ``_retinanet_hooks``)."""
    out = {}
    for k, v in _upgrade_fpn_state_dict(sd).items():
        if ".anchors" in k:
            continue
        k = re.sub(r"^(head\.\w+_head\.conv\.\d+)\.(weight|bias)$", r"\1.0.\2", k)
        out[k] = v
    return out


def _build(weights, weights_enum, v2: bool, device, seed,
           trainable_backbone_layers, **kwargs) -> RetinaNet:
    return build_detector(
        RetinaNet, weights, weights_enum, device, seed,
        trainable_backbone_layers, init=init_retinanet_weights,
        upgrade=_upgrade_state_dict, v2=v2, **kwargs)


@register_model()
def retinanet_resnet50_fpn(
    *,
    weights: Optional[Union[RetinaNet_ResNet50_FPN_Weights, Weights, str]] = None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trainable_backbone_layers: Optional[int] = None,
    **kwargs,
) -> RetinaNet:
    """RetinaNet ResNet-50-FPN v1 (``build_detector``)."""
    return _build(weights, RetinaNet_ResNet50_FPN_Weights, False, device, seed,
                  trainable_backbone_layers, **kwargs)


@register_model()
def retinanet_resnet50_fpn_v2(
    *,
    weights: Optional[Union[RetinaNet_ResNet50_FPN_V2_Weights, Weights, str]] = None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trainable_backbone_layers: Optional[int] = None,
    **kwargs,
) -> RetinaNet:
    """RetinaNet ResNet-50-FPN v2: live batch norm in the trunk,
    ``GroupNorm`` in the towers, P6 from C5 (``build_detector``)."""
    return _build(weights, RetinaNet_ResNet50_FPN_V2_Weights, True, device,
                  seed, trainable_backbone_layers, **kwargs)
