"""SSD300-VGG16 (counterpart of ``vision_tpu/models/detection/ssd.py``).

``SSDFeatureExtractorVGG``: VGG16's convolutions up to conv4_3 (its third
pool in ceil mode), whose output is L2-normalised over the channels as
``x / sqrt(sum x^2 + 1e-12)`` and scaled by the learned ``scale_weight``
(20 at init); then conv5, a 3x3 stride-1 pool, the atrous FC6 (dilation 6)
and FC7, then four extra blocks (1x1 then a 3x3 of stride 2, twice, then
a VALID 3x3, twice): six maps, 38x38 to 1x1 on a 300x300 image (300 is the
least input that gives the last 1x1 map). ``SSDHead``: a 3x3 convolution a
map for the classes and one for the boxes; the outputs ``[N, H*W*A, K]``
and ``[N, H*W*A, 4]`` are concatenated over the maps, the ``A`` default
boxes a-major within a location as ``DefaultBoxGenerator`` lays them.

``SSD.forward`` gives ``(cls_logits, bbox_reg, anchors)``.
``postprocess_detections`` takes the softmax scores, keeps per class the
top ``topk_candidates`` above ``score_thresh`` (36,000 candidates an image
at 91 classes), decodes and clips their boxes (``BoxCoder(10, 10, 5, 5)``)
and runs one class-aware NMS an image (``batched_nms_mask``: on the card
the bitmask kernel of ``csrc/nms.cu``), as fixed-size ``Detections`` of
``detections_per_img`` rows. ``compute_loss`` matches the default boxes to
the gts (``SSDMatcher``: IoU >= 0.5, and each gt's best box forced to it),
then gives the smooth-L1 loss of the foreground boxes' deltas and the
cross-entropy of the foreground boxes and of the hardest negatives, three
a foreground box (ranked by a stable sort of their losses, ties by index
as the JAX package's double ``argsort`` ranks them), each over the image's
number of foreground boxes (at least 1), averaged over the images, in f32.

Module and state-dict names are torchvision's (``backbone.features.N``,
``backbone.extra.N``, ``backbone.scale_weight``,
``head.classification_head.module_list.N``). Amp (bf16) is the JAX
package's switch: ``model.to(torch.bfloat16)`` and a bf16 canvas; the
softmax, decoding, NMS and losses run in f32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vision_tpu_torch.models._api import Weights, WeightsEnum, register_model
from vision_tpu_torch.models.detection._utils import (
    BoxCoder,
    Matcher,
    SSDMatcher,
    unit_box_where,
)
from vision_tpu_torch.models.detection.anchor_utils import DefaultBoxGenerator
from vision_tpu_torch.models.detection.backbone_utils import freeze_layers_before
from vision_tpu_torch.models.detection.faster_rcnn import build_detector
from vision_tpu_torch.models.detection.roi_heads import Detections
from vision_tpu_torch.ops._topk import top_k
from vision_tpu_torch.ops.boxes import box_iou
from vision_tpu_torch.ops.nms import batched_nms_mask
from vision_tpu_torch.transforms._presets import ObjectDetection

__all__ = ["SSD", "SSD300_VGG16_Weights", "SSDFeatureExtractorVGG", "SSDHead",
           "ssd300_vgg16"]

# VGG16's layers up to conv4_3's ReLU: channels of each 3x3 convolution,
# "M" a 2x2 pool, "C" the 2x2 pool in ceil mode
_VGG16_TO_CONV4_3 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "C",
                     512, 512, 512)


def _relu_conv(cin: int, cout: int, k: int = 3, **kw) -> List[nn.Module]:
    return [nn.Conv2d(cin, cout, k, padding=kw.pop("padding", (k - 1) // 2),
                      **kw), nn.ReLU(inplace=True)]


class SSDFeatureExtractorVGG(nn.Module):
    """The six maps of SSD300 (module docstring)."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        cin = 3
        for v in _VGG16_TO_CONV4_3:
            if v in ("M", "C"):
                layers.append(nn.MaxPool2d(2, 2, ceil_mode=v == "C"))
            else:
                layers += _relu_conv(cin, v)
                cin = v
        self.features = nn.Sequential(*layers)
        self.scale_weight = nn.Parameter(torch.full((512,), 20.0))
        fc = nn.Sequential(
            nn.MaxPool2d(3, 1, 1),
            *_relu_conv(512, 1024, 3, padding=6, dilation=6),  # FC6, atrous
            *_relu_conv(1024, 1024, 1))  # FC7
        self.extra = nn.ModuleList([
            nn.Sequential(nn.MaxPool2d(2, 2), *_relu_conv(512, 512),
                          *_relu_conv(512, 512), *_relu_conv(512, 512), fc),
            nn.Sequential(*_relu_conv(1024, 256, 1),
                          *_relu_conv(256, 512, 3, stride=2)),
            nn.Sequential(*_relu_conv(512, 128, 1),
                          *_relu_conv(128, 256, 3, stride=2)),
            nn.Sequential(*_relu_conv(256, 128, 1),
                          *_relu_conv(128, 256, 3, padding=0)),
            nn.Sequential(*_relu_conv(256, 128, 1),
                          *_relu_conv(128, 256, 3, padding=0)),
        ])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.features(x)
        norm = torch.sqrt((x * x).sum(1, keepdim=True) + 1e-12)
        out = [x / norm * self.scale_weight[None, :, None, None]]
        for block in self.extra:
            x = block(x)
            out.append(x)
        return out


def _flat(x: torch.Tensor, per_anchor: int) -> torch.Tensor:
    """``[N, A*P, H, W]`` -> ``[N, H*W*A, P]``, a-major within a
    location."""
    n, _, h, w = x.shape
    return x.view(n, -1, per_anchor, h, w).permute(0, 3, 4, 1, 2).reshape(
        n, -1, per_anchor)


class SSDHead(nn.Module):
    """A classification and a regression predictor a map
    (``classification_head.module_list.{i}``,
    ``regression_head.module_list.{i}``): 3x3 convolutions unless
    ``make_predictor(in_channels, out_channels)`` builds another (SSDlite's).
    Returns ``cls_logits [N, R, K]`` and ``bbox_reg [N, R, 4]`` over all
    maps."""

    def __init__(self, in_channels: Sequence[int], num_anchors: Sequence[int],
                 num_classes: int, make_predictor=None):
        super().__init__()
        make = make_predictor or (
            lambda cin, cout: nn.Conv2d(cin, cout, 3, padding=1))
        self.num_classes = num_classes
        self.classification_head = nn.Module()
        self.classification_head.module_list = nn.ModuleList(
            make(c, a * num_classes) for c, a in zip(in_channels, num_anchors))
        self.regression_head = nn.Module()
        self.regression_head.module_list = nn.ModuleList(
            make(c, a * 4) for c, a in zip(in_channels, num_anchors))

    def forward(self, features: List[torch.Tensor]):
        cls = self.classification_head.module_list
        reg = self.regression_head.module_list
        return (torch.cat([_flat(m(f), self.num_classes)
                           for m, f in zip(cls, features)], 1),
                torch.cat([_flat(m(f), 4) for m, f in zip(reg, features)], 1))


class SSD(nn.Module):
    """SSD300-VGG16 on a 300x300 normalised batch (a fixed canvas of
    ``GeneralizedRCNNTransform``)."""

    def __init__(
        self,
        num_classes: int = 91,
        score_thresh: float = 0.01,
        nms_thresh: float = 0.45,
        detections_per_img: int = 200,
        topk_candidates: int = 400,
        iou_thresh: float = 0.5,
        neg_to_pos_ratio: int = 3,
    ):
        super().__init__()
        self.backbone = SSDFeatureExtractorVGG()
        self.anchor_generator = DefaultBoxGenerator(
            [[2], [2, 3], [2, 3], [2, 3], [2], [2]],
            scales=[0.07, 0.15, 0.33, 0.51, 0.69, 0.87, 1.05],
            steps=[8, 16, 32, 64, 100, 300])
        self.head = SSDHead([512, 1024, 512, 256, 256, 256],
                            self.anchor_generator.num_anchors_per_location(),
                            num_classes)
        self.proposal_matcher: Matcher = SSDMatcher(iou_thresh)
        self._setup(num_classes, score_thresh, nms_thresh, detections_per_img,
                    topk_candidates, neg_to_pos_ratio)

    def _setup(self, num_classes, score_thresh, nms_thresh, detections_per_img,
               topk_candidates, neg_to_pos_ratio) -> None:
        self.box_coder = BoxCoder(weights=(10.0, 10.0, 5.0, 5.0))
        self.num_classes = num_classes
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_img = detections_per_img
        self.topk_candidates = topk_candidates
        self.neg_to_pos_ratio = neg_to_pos_ratio

    def forward(self, images: torch.Tensor, return_features: bool = False):
        """``(cls_logits, bbox_reg, anchors)``; with ``return_features``
        also the maps, keyed "0".."5"."""
        feats = self.backbone(images)
        cls_logits, bbox_reg = self.head(feats)
        anchors = self.anchor_generator(
            tuple(images.shape[-2:]), [tuple(f.shape[-2:]) for f in feats],
            images.device)
        out = (cls_logits, bbox_reg, anchors)
        if return_features:
            return out, {str(i): f for i, f in enumerate(feats)}
        return out

    def postprocess_detections(
        self,
        cls_logits: torch.Tensor,
        bbox_reg: torch.Tensor,
        anchors: torch.Tensor,
        image_size: Tuple[int, int],
    ) -> Detections:
        """Softmax scores; per image and foreground class the top
        ``topk_candidates`` boxes above ``score_thresh`` (decoded, clipped
        to ``image_size``); one class-aware NMS an image over all of them;
        the top ``detections_per_img`` kept."""
        h, w = image_size
        n, r, c = cls_logits.shape
        scores = torch.softmax(cls_logits.float(), -1)  # [N, R, C]
        boxes = self.box_coder.decode(bbox_reg, anchors)[:, :, 0]  # [N, R, 4]
        x = boxes[..., 0::2].clamp(0, w)
        y = boxes[..., 1::2].clamp(0, h)
        boxes = torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)
        k = min(self.topk_candidates, r)
        fg = scores[..., 1:].transpose(1, 2)  # [N, C-1, R]
        masked = torch.where(fg > self.score_thresh, fg, torch.full_like(fg, -1.0))
        top_s, top_i = top_k(masked, k)  # [N, C-1, k]
        cand_scores = top_s.reshape(n, -1)
        cand_boxes = torch.gather(boxes, 1,
                                  top_i.reshape(n, -1, 1).expand(-1, -1, 4))
        cand_labels = torch.arange(1, c, device=boxes.device).repeat_interleave(
            k).expand(n, -1)
        keep = batched_nms_mask(cand_boxes, cand_scores, cand_labels,
                                self.nms_thresh, valid=cand_scores > 0)
        kept = torch.where(keep, cand_scores, torch.full_like(cand_scores, -1.0))
        top_scores, top_idx = top_k(kept, min(self.detections_per_img,
                                              kept.shape[1]))
        return Detections(
            torch.gather(cand_boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
            torch.where(top_scores > 0, top_scores, torch.zeros_like(top_scores)),
            torch.gather(cand_labels, 1, top_idx),
            top_scores > 0,
        )

    def hard_negatives(self, ce: torch.Tensor, fg: torch.Tensor,
                       num_fg: torch.Tensor) -> torch.Tensor:
        """The ``neg_to_pos_ratio * num_fg [N, 1]`` background boxes of
        highest cross-entropy ``ce [N, R]``: each box's rank in a stable
        ascending sort of minus its loss (foreground boxes last), equal
        losses in index order."""
        neg_loss = torch.where(fg, torch.full_like(ce, -math.inf), ce)
        order = torch.sort(-neg_loss, dim=-1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            -1, order, torch.arange(order.shape[-1], device=ce.device).expand_as(
                order))
        return (rank < self.neg_to_pos_ratio * num_fg) & ~fg

    def compute_loss(
        self,
        cls_logits: torch.Tensor,
        bbox_reg: torch.Tensor,
        anchors: torch.Tensor,
        gt_boxes: torch.Tensor,
        gt_labels: torch.Tensor,
        gt_valid: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        """``{"bbox_regression", "classification"}`` for ``gt_boxes [N, G,
        4]`` (canvas frame), ``gt_labels [N, G]`` and ``gt_valid [N, G]``
        (padding rows False), in f32 (module docstring). Boxes that are not
        foreground are encoded against a unit box, as ``rpn.py`` does: their
        matched gt may be a padding row of zeros, whose ``log(0)`` target
        would reach the masked loss as ``inf * 0``."""
        logits = cls_logits.float()
        reg = bbox_reg.float()
        gt_boxes = gt_boxes.float()
        matched = self.proposal_matcher(box_iou(gt_boxes, anchors),
                                        valid_gt=gt_valid)  # [N, R]
        fg = matched >= 0
        num_fg = fg.sum(1, keepdim=True).clamp(min=1)
        idx = matched.clamp(min=0)
        matched_boxes = torch.gather(gt_boxes, 1, idx[..., None].expand(-1, -1, 4))
        target = self.box_coder.encode(
            unit_box_where(fg, matched_boxes),
            unit_box_where(fg, anchors.expand_as(matched_boxes)))
        diff = (reg - target).abs()
        sl1 = torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5)
        bbox_loss = (sl1.sum(-1) * fg).sum(1, keepdim=True) / num_fg

        labels = torch.where(fg, torch.gather(gt_labels.long(), 1, idx), 0)
        ce = -torch.gather(torch.log_softmax(logits, -1), 2, labels[..., None])[..., 0]
        chosen = fg | self.hard_negatives(ce.detach(), fg, num_fg)
        cls_loss = (ce * chosen).sum(1, keepdim=True) / num_fg
        return {"bbox_regression": bbox_loss.mean(),
                "classification": cls_loss.mean()}


@torch.no_grad()
def init_ssd_weights(model: SSD, generator: torch.Generator) -> None:
    """torchvision's initialisation, drawn from ``generator``: VGG16's
    convolutions (``backbone.features`` and conv5, ``backbone.extra.0.1``
    to ``.5``) He-normal over the fan out, the rest (FC6, FC7, the extra
    blocks, the head) Xavier-uniform, all biases zero; ``scale_weight``
    20."""
    for name, m in model.named_modules():
        if not isinstance(m, nn.Conv2d):
            continue
        fan_in = m.weight[0].numel()
        fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
        if name.startswith("backbone.features") or name in (
                "backbone.extra.0.1", "backbone.extra.0.3", "backbone.extra.0.5"):
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
        else:
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            m.weight.uniform_(-bound, bound, generator=generator)
        m.bias.zero_()
    model.backbone.scale_weight.fill_(20.0)


class SSD300_VGG16_Weights(WeightsEnum):
    COCO_V1 = Weights(
        url="https://download.pytorch.org/models/ssd300_vgg16_coco-b556d3b4.pth",
        transforms=ObjectDetection,
        meta={"num_params": 35641826,
              "_metrics": {"COCO-val2017": {"box_map": 25.1}}},
    )
    DEFAULT = COCO_V1


# VGG16's layers as torchvision's ``_vgg_extractor`` counts its stages:
# conv4_3's features, then the pool and conv5 at the head of extra.0
_VGG_STAGE_STARTS = (0, 4, 9, 16, 23)


def _freeze_vgg(model: SSD, trainable_layers: int) -> None:
    """torchvision's rule for SSD's VGG16 (0-5 stages): its layers are
    ``features`` and the pool and conv5 at the head of ``extra.0``."""
    freeze_layers_before([*model.backbone.features, *model.backbone.extra[0][:7]],
                         _VGG_STAGE_STARTS, trainable_layers)


@register_model()
def ssd300_vgg16(
    *,
    weights: Optional[Union[SSD300_VGG16_Weights, Weights, str]] = None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trainable_backbone_layers: Optional[int] = None,
    **kwargs,
) -> SSD:
    """SSD300-VGG16 (``faster_rcnn.build_detector``; torchvision's
    checkpoint names as they stand)."""
    return build_detector(SSD, weights, SSD300_VGG16_Weights, device, seed,
                          trainable_backbone_layers, init=init_ssd_weights,
                          upgrade=dict, freeze=_freeze_vgg, **kwargs)
