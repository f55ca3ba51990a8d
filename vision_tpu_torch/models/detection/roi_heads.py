"""RoI heads (counterpart of ``vision_tpu/models/detection/roi_heads.py``):
the box branch (``TwoMLPHead``, v2's ``FastRCNNConvFCHead``,
``FastRCNNPredictor``,
``postprocess_detections`` with fixed-size results, and for training
``select_training_samples``, a fixed budget of sampled proposals an image,
and ``fastrcnn_loss``); the mask branch (``MaskRCNNHeads``, v1 and v2 with
batch norm, ``MaskRCNNPredictor``, ``maskrcnn_loss``,
``paste_masks_in_image``); and the keypoint branch (``KeypointRCNNHeads``,
``KeypointRCNNPredictor``, ``keypointrcnn_loss``).

The mask targets are pooled from the gt masks by ``roi_align`` (the CUDA
kernel on the card, at one channel); the heads are convolutions, and
``paste_masks_in_image`` and the keypoint predictor's 2x upsample are
products with separable weights, as in the JAX package (no Pallas kernel
there, so none is owed here)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vision_tpu_torch.models.detection._utils import (
    BELOW_LOW_THRESHOLD,
    BalancedPositiveNegativeSampler,
    BoxCoder,
    Matcher,
    smooth_l1,
    unit_box_where,
)
from vision_tpu_torch.ops._topk import top_k
from vision_tpu_torch.ops.boxes import box_iou
from vision_tpu_torch.ops.misc import BatchNorm2d, Conv2dNormActivation
from vision_tpu_torch.ops.nms import batched_nms_mask
from vision_tpu_torch.ops.poolers import MultiScaleRoIAlign
from vision_tpu_torch.ops.roi_align import roi_align
from vision_tpu_torch.transforms.v2.functional._resample import resize_2d

__all__ = ["Detections", "FastRCNNConvFCHead", "FastRCNNPredictor", "KeypointRCNNHeads",
           "KeypointRCNNPredictor", "MaskRCNNHeads", "MaskRCNNPredictor",
           "RoIHeads", "SampledProposals", "TwoMLPHead", "keypointrcnn_loss",
           "maskrcnn_loss", "paste_masks_in_image"]

SAMPLES_PER_IMAGE = 512  # torchvision's box_batch_size_per_image


class Detections(NamedTuple):
    """Fixed-size detections: ``boxes [N, D, 4]``, ``scores``/``labels``/
    ``valid [N, D]``; rows with ``valid`` False are padding."""

    boxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor


class SampledProposals(NamedTuple):
    """The proposals an image trains on, ``[N, S]`` rows: ``boxes [N, S,
    4]``, ``labels`` (0 = background), ``reg_targets [N, S, 4]``,
    ``pos_mask``, ``valid`` (sampled; the rest is padding) and
    ``matched_gt`` (the gt row of each, 0 where none)."""

    boxes: torch.Tensor
    labels: torch.Tensor
    reg_targets: torch.Tensor
    pos_mask: torch.Tensor
    valid: torch.Tensor
    matched_gt: torch.Tensor


class TwoMLPHead(nn.Module):
    """Flatten the pooled ``[K, C, 7, 7]`` in CHW order, then fc6, fc7.
    The JAX head flattens HWC: ``jax_hwc_inputs`` has the converters
    reorder ``fc6.weight``."""

    def __init__(self, in_channels: int, representation_size: int = 1024):
        super().__init__()
        self.fc6 = nn.Linear(in_channels, representation_size)
        self.fc7 = nn.Linear(representation_size, representation_size)
        self.jax_hwc_inputs = {"fc6": (7, 7)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.flatten(1)
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class FastRCNNConvFCHead(nn.Sequential):
    """v2 box head: four bias-free 3x3 convs of 256, each with its batch
    norm (the port's ``BatchNorm2d``: batch statistics in training mode)
    and a ReLU (children ``{i}.0``, ``{i}.1``), then the pooled ``[K, 256,
    7, 7]`` flattened in CHW order (``4``) and the fc ``5`` of
    ``representation_size`` with a ReLU. The JAX head flattens HWC: the
    converters reorder ``5.weight`` (``jax_hwc_inputs``)."""

    def __init__(self, input_size=(256, 7, 7), conv_layers=(256, 256, 256, 256),
                 representation_size: int = 1024):
        channels, height, width = input_size
        blocks = []
        for c in conv_layers:
            blocks.append(Conv2dNormActivation(channels, c, 3,
                                               norm_layer=BatchNorm2d))
            channels = c
        super().__init__(*blocks, nn.Flatten(),
                         nn.Linear(channels * height * width,
                                   representation_size),
                         nn.ReLU(inplace=True))
        self.jax_hwc_inputs = {"5": (height, width)}


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(in_channels, num_classes)
        self.bbox_pred = nn.Linear(in_channels, num_classes * 4)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x)


class MaskRCNNHeads(nn.Module):
    """Mask head: ``layers`` 3x3 convolutions of ``features`` channels, each
    followed by a ReLU. v1: biased, no norm, named ``mask_fcn1..``; v2
    (``use_norm``): bias-free, each with its batch norm (the port's
    ``BatchNorm2d``), named ``{i}.0`` and ``{i}.1``."""

    def __init__(self, in_channels: int, layers: int = 4, features: int = 256,
                 use_norm: bool = False):
        super().__init__()
        for i in range(layers):
            cin = in_channels if i == 0 else features
            if use_norm:
                self.add_module(str(i), Conv2dNormActivation(
                    cin, features, 3, norm_layer=BatchNorm2d))
            else:
                self.add_module(f"mask_fcn{i + 1}",
                                nn.Conv2d(cin, features, 3, padding=1))
        self.use_norm = use_norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x) if self.use_norm else F.relu(block(x))
        return x


class MaskRCNNPredictor(nn.Module):
    """``conv5_mask`` (a 2x2 stride-2 transposed convolution), ReLU, then
    the 1x1 ``mask_fcn_logits``: ``[K, C, M, M]`` -> ``[K, classes, 2M,
    2M]``."""

    def __init__(self, in_channels: int, dim_reduced: int, num_classes: int):
        super().__init__()
        self.conv5_mask = nn.ConvTranspose2d(in_channels, dim_reduced, 2, 2)
        self.mask_fcn_logits = nn.Conv2d(dim_reduced, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


class KeypointRCNNHeads(nn.Sequential):
    """``layers`` 3x3 convolutions of ``features`` channels, each followed
    by a ReLU; state-dict names ``0, 2, 4, ...``."""

    def __init__(self, in_channels: int, layers: int = 8, features: int = 512):
        mods = []
        for i in range(layers):
            mods += [nn.Conv2d(in_channels if i == 0 else features, features, 3,
                               padding=1), nn.ReLU()]
        super().__init__(*mods)


class KeypointRCNNPredictor(nn.Module):
    """``kps_score_lowres`` (a 4x4 stride-2 transposed convolution), then a
    2x bilinear upsample (``align_corners=False``): ``[K, C, M, M]`` ->
    ``[K, keypoints, 4M, 4M]`` heatmap logits."""

    def __init__(self, in_channels: int, num_keypoints: int):
        super().__init__()
        self.kps_score_lowres = nn.ConvTranspose2d(
            in_channels, num_keypoints, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.kps_score_lowres(x)
        size = (2 * x.shape[-2], 2 * x.shape[-1])
        return resize_2d(x, size, mode="bilinear", antialias=False,
                         align_corners=False)


def maskrcnn_loss(
    mask_logits: torch.Tensor,  # [N, S, C, M, M]
    sampled: SampledProposals,
    gt_masks: torch.Tensor,  # [N, G, H, W]
) -> torch.Tensor:
    """Each sampled proposal's matched gt mask (row ``clip(matched_gt,
    0)`` of its image) pooled into its box at ``M x M`` by ``roi_align``
    (scale 1, ``sampling_ratio=2``, as the JAX package does where
    torchvision's grid is adaptive), then BCE-with-logits on the channel
    of the proposal's label, averaged over the positives' pixels."""
    n, s, _, m, _ = mask_logits.shape
    g, h, w = gt_masks.shape[1:]
    flat = gt_masks.reshape(n * g, 1, h, w).float()
    gt_idx = torch.arange(n, device=flat.device)[:, None] * g + sampled.matched_gt
    rois = torch.cat([gt_idx.reshape(-1, 1).float(),
                      sampled.boxes.reshape(-1, 4).float()], 1)
    targets = roi_align(flat, rois, (m, m), 1.0, 2).reshape(n, s, m, m)
    sel = torch.gather(
        mask_logits.float(), 2,
        sampled.labels[:, :, None, None, None].expand(n, s, 1, m, m))[:, :, 0]
    bce = F.binary_cross_entropy_with_logits(sel, targets, reduction="none")
    pos = sampled.pos_mask
    denom = (pos.sum() * m * m).clamp(min=1)
    return (bce * pos[..., None, None]).sum() / denom


def keypointrcnn_loss(
    keypoint_logits: torch.Tensor,  # [N, S, K, HM, HM]
    sampled: SampledProposals,
    gt_keypoints: torch.Tensor,  # [N, G, K, 3] (x, y, visibility)
) -> torch.Tensor:
    """Each visible keypoint of a positive's matched gt, discretised into
    the proposal's ``HM x HM`` grid (one exactly on the box's right or
    bottom edge goes to the last cell; one outside the box is dropped), and
    the cross-entropy of the spatial softmax at that cell, averaged over
    those keypoints."""
    n, s, k, hm, _ = keypoint_logits.shape
    kp = torch.gather(gt_keypoints.float(), 1, sampled.matched_gt[
        :, :, None, None].expand(n, s, k, 3))  # [N, S, K, 3]
    boxes = sampled.boxes.float()
    x0, y0 = boxes[..., 0:1], boxes[..., 1:2]
    sx = hm / (boxes[..., 2:3] - x0).clamp(min=1e-6)
    sy = hm / (boxes[..., 3:4] - y0).clamp(min=1e-6)
    x, y = kp[..., 0], kp[..., 1]
    xi = torch.floor((x - x0) * sx).to(torch.int64)
    yi = torch.floor((y - y0) * sy).to(torch.int64)
    xi = torch.where(x == boxes[..., 2:3], hm - 1, xi)
    yi = torch.where(y == boxes[..., 3:4], hm - 1, yi)
    inside = (xi >= 0) & (yi >= 0) & (xi < hm) & (yi < hm)
    valid = inside & (kp[..., 2] > 0) & sampled.pos_mask[..., None]
    target = (yi * hm + xi).clamp(0, hm * hm - 1)
    logp = F.log_softmax(keypoint_logits.float().reshape(n, s, k, hm * hm), -1)
    ce = -torch.gather(logp, 3, target[..., None])[..., 0]
    return (ce * valid).sum() / valid.sum().clamp(min=1)


def _paste_weights(coords, b0, b1, mp):
    """``[K, size, mp]`` bilinear weights of one axis of the paste: torch's
    ``align_corners=False`` source index over the integer paste region
    ``[b0, b1]`` (extent ``b1 - b0 + 1``), clamped at 0 before the floor,
    zero outside the region."""
    extent = (b1 - b0 + 1.0).clamp(min=1.0)[:, None]
    g = ((coords[None, :] - b0[:, None] + 0.5) / extent * mp - 0.5).clamp(min=0.0)
    inside = (coords[None, :] >= b0[:, None]) & (coords[None, :] <= b1[:, None])
    i0 = torch.floor(g).to(torch.int64).clamp(max=mp - 1)
    i1 = (i0 + 1).clamp(max=mp - 1)
    frac = g - i0
    w = (F.one_hot(i0, mp) * (1.0 - frac)[..., None]
         + F.one_hot(i1, mp) * frac[..., None])
    return w * inside[..., None]


def paste_masks_in_image(masks: torch.Tensor, boxes: torch.Tensor,
                         img_h: int, img_w: int) -> torch.Tensor:
    """``masks [K, M, M]`` (probabilities in each box's frame) pasted into
    an ``img_h x img_w`` image at ``boxes [K, 4]`` -> ``[K, img_h, img_w]``
    in the masks' type. As torchvision: each box expanded by ``(M + 2) /
    M`` around its centre and truncated to integers, the mask padded by a
    pixel of zeros and resized bilinearly onto that region; zero outside
    it. The resize is two batched products with separable weights, in
    f32."""
    k, m, _ = masks.shape
    scale = (m + 2.0) / m
    boxes = boxes.float()
    cx = (boxes[:, 0] + boxes[:, 2]) * 0.5
    cy = (boxes[:, 1] + boxes[:, 3]) * 0.5
    bw = (boxes[:, 2] - boxes[:, 0]) * 0.5 * scale
    bh = (boxes[:, 3] - boxes[:, 1]) * 0.5 * scale
    padded = F.pad(masks.float(), (1, 1, 1, 1))
    dev = masks.device
    w_y = _paste_weights(torch.arange(img_h, dtype=torch.float32, device=dev),
                         torch.trunc(cy - bh), torch.trunc(cy + bh), m + 2)
    w_x = _paste_weights(torch.arange(img_w, dtype=torch.float32, device=dev),
                         torch.trunc(cx - bw), torch.trunc(cx + bw), m + 2)
    return torch.bmm(torch.bmm(w_y, padded), w_x.transpose(1, 2)).to(masks.dtype)


class RoIHeads(nn.Module):
    """``box_roi_pool`` -> ``box_head`` -> ``box_predictor``, the
    fixed-size postprocess, and the training samples and loss. Mask R-CNN
    adds ``mask_roi_pool``, ``mask_head`` and ``mask_predictor``, Keypoint
    R-CNN ``keypoint_roi_pool``, ``keypoint_head`` and
    ``keypoint_predictor`` (torchvision's names)."""

    def __init__(
        self,
        box_roi_pool: MultiScaleRoIAlign,
        box_head: nn.Module,
        box_predictor: nn.Module,
        bbox_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0),
        score_thresh: float = 0.05,
        nms_thresh: float = 0.5,
        detections_per_img: int = 100,
        topk_candidates: int = 1000,
    ):
        super().__init__()
        self.box_roi_pool = box_roi_pool
        self.box_head = box_head
        self.box_predictor = box_predictor
        self.box_coder = BoxCoder(weights=bbox_reg_weights)
        # torchvision's training defaults: IoU >= 0.5 positive, below
        # negative; a quarter of the samples positive at most
        self.proposal_matcher = Matcher(0.5, 0.5)
        self.sampler = BalancedPositiveNegativeSampler(SAMPLES_PER_IMAGE, 0.25)
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_img = detections_per_img
        self.topk_candidates = topk_candidates

    def select_training_samples(
        self,
        proposals: torch.Tensor,  # [N, P, 4]
        proposals_valid: torch.Tensor,  # [N, P]
        gt_boxes: torch.Tensor,  # [N, G, 4]
        gt_labels: torch.Tensor,  # [N, G]
        gt_valid: torch.Tensor,  # [N, G]
        generator: torch.Generator,
    ) -> SampledProposals:
        """Append the gt boxes to the proposals, match them to the gt
        (IoU >= 0.5 positive, below negative; invalid rows negative and
        never matched), sample (the sampler draws from ``generator``), and
        keep ``S = min(SAMPLES_PER_IMAGE, P + G)`` rows an image: the
        sampled positives first, then the sampled negatives, each in index
        order, then padding. Regression targets of rows that are not
        positive are those of a unit box."""
        proposals = proposals.detach()
        props = torch.cat([proposals, gt_boxes.to(proposals.dtype)], 1)
        pvalid = torch.cat([proposals_valid, gt_valid], 1)
        iou = box_iou(gt_boxes, props)  # [N, G, P + G]
        iou = torch.where(pvalid[:, None, :], iou, torch.full_like(iou, -1.0))
        matched = self.proposal_matcher(iou, valid_gt=gt_valid)
        matched = torch.where(pvalid, matched, BELOW_LOW_THRESHOLD)
        pos, neg = self.sampler(matched, generator)
        sampled = pos | neg

        s = min(SAMPLES_PER_IMAGE, props.shape[1])
        _, idx = top_k(sampled.float() + 0.5 * pos.float(), s)
        sel_boxes = torch.gather(props, 1, idx[..., None].expand(-1, -1, 4))
        sel_pos = torch.gather(pos, 1, idx)
        clamped = torch.gather(matched, 1, idx).clamp(min=0)
        sel_labels = torch.where(sel_pos, torch.gather(gt_labels.long(), 1,
                                                       clamped), 0)
        matched_boxes = torch.gather(gt_boxes.to(props.dtype), 1,
                                     clamped[..., None].expand(-1, -1, 4))
        reg_targets = self.box_coder.encode(unit_box_where(sel_pos, matched_boxes),
                                            unit_box_where(sel_pos, sel_boxes))
        return SampledProposals(sel_boxes, sel_labels, reg_targets, sel_pos,
                                torch.gather(sampled, 1, idx), clamped)

    def fastrcnn_loss(
        self,
        class_logits: torch.Tensor,  # [N, S, C]
        box_regression: torch.Tensor,  # [N, S, C*4]
        sampled: SampledProposals,
    ) -> Dict[str, torch.Tensor]:
        """Cross-entropy over the sampled rows, and smooth-L1 (beta 1/9)
        of the positives' deltas of their own class, each summed over the
        batch over its number of sampled rows."""
        n, s, c = class_logits.shape
        valid = sampled.valid
        num_valid = valid.sum().clamp(min=1)
        logp = F.log_softmax(class_logits.float(), dim=-1)
        ce = -torch.gather(logp, 2, sampled.labels[..., None])[..., 0]
        cls_loss = (ce * valid).sum() / num_valid
        reg = box_regression.float().reshape(n, s, c, 4)
        reg_sel = torch.gather(
            reg, 2, sampled.labels[..., None, None].expand(n, s, 1, 4))[:, :, 0]
        sl1 = smooth_l1(reg_sel - sampled.reg_targets).sum(-1)
        box_loss = (sl1 * sampled.pos_mask).sum() / num_valid
        return {"loss_classifier": cls_loss, "loss_box_reg": box_loss}

    def postprocess_detections(
        self,
        class_logits: torch.Tensor,  # [N, P, C]
        box_regression: torch.Tensor,  # [N, P, C*4]
        proposals: torch.Tensor,  # [N, P, 4]
        proposals_valid: torch.Tensor,  # [N, P]
        image_size: Tuple[int, int],
    ) -> Detections:
        """Softmax, decode and clip per class; drop the background class;
        mask low scores, invalid proposals and tiny boxes; keep the top
        ``topk_candidates`` (RoI, class) pairs; one class-aware NMS per
        image; the top ``detections_per_img`` kept."""
        h, w = image_size
        n, p, c = class_logits.shape
        scores = F.softmax(class_logits.float(), dim=-1)
        boxes = self.box_coder.decode(box_regression, proposals)  # [N,P,C,4]
        x = boxes[..., 0::2].clamp(0, w)
        y = boxes[..., 1::2].clamp(0, h)
        boxes = torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)

        fg_scores = scores[:, :, 1:].reshape(n, -1)
        fg_boxes = boxes[:, :, 1:].reshape(n, -1, 4)
        fg_labels = torch.arange(1, c, device=scores.device).repeat(p)
        valid = fg_scores > self.score_thresh
        valid &= proposals_valid.repeat_interleave(c - 1, dim=1)
        ws = fg_boxes[..., 2] - fg_boxes[..., 0]
        hs = fg_boxes[..., 3] - fg_boxes[..., 1]
        valid &= (ws >= 1e-2) & (hs >= 1e-2)

        kcap = min(self.topk_candidates, fg_scores.shape[1])
        cand_scores, cand_idx = top_k(
            torch.where(valid, fg_scores, torch.full_like(fg_scores, -1.0)),
            kcap,
        )
        fg_boxes = torch.gather(fg_boxes, 1, cand_idx[..., None].expand(-1, -1, 4))
        fg_scores = torch.gather(fg_scores, 1, cand_idx)
        fg_labels = fg_labels[cand_idx]
        valid = cand_scores > 0

        keep = batched_nms_mask(fg_boxes, fg_scores, fg_labels,
                                self.nms_thresh, valid=valid)
        kept = torch.where(keep, fg_scores, torch.full_like(fg_scores, -1.0))
        top_scores, top_idx = top_k(kept, self.detections_per_img)
        return Detections(
            torch.gather(fg_boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
            torch.where(top_scores > 0, top_scores, torch.zeros_like(top_scores)),
            torch.gather(fg_labels, 1, top_idx),
            top_scores > 0,
        )
