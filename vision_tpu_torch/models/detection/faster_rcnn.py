"""Faster R-CNN inference and training loss (counterpart of
``vision_tpu/models/detection/faster_rcnn.py``): the ResNet-50-FPN
variants, v1 and v2, and the MobileNetV3-Large FPN ones.

Backbone -> FPN -> RPN head -> fixed-size ``filter_proposals`` (top-k +
per-level NMS) -> windowed ``MultiScaleRoIAlign`` -> box head ->
fixed-size ``postprocess_detections`` (top-k + class-aware NMS). On the
card the NMS, window-pool and RoIAlign steps run the package's CUDA
kernels. Input: normalised, padded NCHW images, as
``transform.GeneralizedRCNNTransform`` builds them from raw images (whose
``postprocess_boxes`` maps the boxes back); output: ``Detections`` with
``detections_per_img`` rows per image, boxes in the canvas's frame.

Training: ``compute_loss(images, gt_boxes, gt_labels, gt_valid,
generator)`` gives the RPN's and the box head's losses, in f32; its
backward pass runs the window pool's and RoIAlign's backward kernels on
the card (``parallel.train.make_detection_train_step`` wraps it in an
optimizer step).

v2 (``FasterRCNN(v2=True)``, ``fasterrcnn_resnet50_fpn_v2``): the trunk's
batch norm is live (``models/resnet.py``'s blocks: batch statistics in
training mode, updating the running ones), the FPN's convolutions are
bias-free, each followed by a batch norm that always normalises by its
running statistics (the JAX model's ``use_running_average=True``, in
training too), the RPN head has two 3x3 convs, and the box head is
``FastRCNNConvFCHead`` (four conv + batch norm + ReLU, then one fc), whose
batch norm follows the training mode as the trunk's does.

MobileNet (``backbone_type="mobilenet_v3_large"``,
``fasterrcnn_mobilenet_v3_large_fpn`` and ``_320_fpn``): the frozen-BN
MobileNetV3-Large trunk tapped at ``body.13`` and ``body.16`` (both at
stride 32) under an FPN of 256 channels and "pool"; 15 anchors a location
(sizes 32-512 at ratios 0.5, 1, 2) on "0", "1" and "pool"; the box pooler
over "0" and "1".

Amp (bf16) eval is the JAX package's switch: ``model.to(torch.bfloat16)``
and a bf16 canvas. The trunk, the FPN, the heads and the pooled features
run in bf16 (the pooler's kernels take bf16); anchors, box decoding, NMS
and the final softmax run in f32, so boxes and scores come out f32.
"""

from __future__ import annotations

import functools
import math
import re
from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from vision_tpu_torch.models._api import (
    Weights,
    WeightsEnum,
    register_model,
    resolve_device,
)
from vision_tpu_torch.models.detection.anchor_utils import AnchorGenerator
from vision_tpu_torch.models.detection.backbone_utils import (
    BackboneWithFPN,
    MobileNetV3FPNBackbone,
    freeze_layers_before,
    freeze_trunk_layers,
)
from vision_tpu_torch.models.detection.roi_heads import (
    Detections,
    FastRCNNConvFCHead,
    FastRCNNPredictor,
    RoIHeads,
    TwoMLPHead,
)
from vision_tpu_torch.models.detection.rpn import RegionProposalNetwork, RPNHead
from vision_tpu_torch.ops.deform_conv import DeformConv2d
from vision_tpu_torch.ops.misc import BatchNorm2d
from vision_tpu_torch.ops.poolers import MultiScaleRoIAlign
from vision_tpu_torch.transforms._presets import ObjectDetection

__all__ = [
    "FasterRCNN",
    "build_detector",
    "FasterRCNN_MobileNet_V3_Large_320_FPN_Weights",
    "FasterRCNN_MobileNet_V3_Large_FPN_Weights",
    "FasterRCNN_ResNet50_FPN_V2_Weights",
    "FasterRCNN_ResNet50_FPN_Weights",
    "fasterrcnn_mobilenet_v3_large_320_fpn",
    "fasterrcnn_mobilenet_v3_large_fpn",
    "fasterrcnn_resnet50_fpn",
    "fasterrcnn_resnet50_fpn_v2",
    "init_weights",
]

_FEATMAPS = ["0", "1", "2", "3"]
# the modules whose convolutions torchvision initialises He-normal (fan out)
_HE_NORMAL = ("backbone.body", "roi_heads.box_head", "roi_heads.mask_",
              "roi_heads.keypoint_")


class FasterRCNN(nn.Module):
    """Faster R-CNN with a ResNet-FPN backbone, frozen-BN (v1) or, with
    ``v2``, the v2 model of the module docstring; with
    ``backbone_type="mobilenet_v3_large"`` the MobileNet FPN one (v1's
    heads). Module and state-dict names are torchvision's.
    ``deform_stages`` (1-based trunk stages, (2, 3, 4) = C3-C5) and
    ``deform_modulated`` make those stages' 3x3 convolutions deformable
    (``DeformFrozenBottleneck``; the v1 ResNet trunk only)."""

    def __init__(
        self,
        backbone_depth: int = 50,
        backbone_type: str = "resnet",
        num_classes: int = 91,
        rpn_pre_nms_top_n: int = 1000,
        rpn_post_nms_top_n: int = 1000,
        rpn_nms_thresh: float = 0.7,
        rpn_score_thresh: float = 0.0,
        box_score_thresh: float = 0.05,
        box_nms_thresh: float = 0.5,
        box_detections_per_img: int = 100,
        deform_stages: Sequence[int] = (),
        deform_modulated: bool = False,
        v2: bool = False,
    ):
        super().__init__()
        if deform_stages and (v2 or backbone_type != "resnet"):
            raise ValueError("deform_stages is only supported on the "
                             "frozen-BN v1 trunk")
        self.v2 = v2
        if backbone_type == "mobilenet_v3_large":
            if v2:
                raise ValueError("the MobileNet Faster R-CNN has no v2")
            self.backbone = MobileNetV3FPNBackbone(256)
            self.featmap_names = ["0", "1"]
            sizes = ((32, 64, 128, 256, 512),) * 3
        elif backbone_type == "resnet":
            self.backbone = BackboneWithFPN(
                backbone_depth, out_channels=256,
                deform_stages=tuple(deform_stages),
                deform_modulated=deform_modulated, frozen_bn=not v2,
                norm_layer=(functools.partial(BatchNorm2d,
                                              use_running_average=True)
                            if v2 else None))
            self.featmap_names = list(_FEATMAPS)
            sizes = ((32,), (64,), (128,), (256,), (512,))
        else:
            raise ValueError(f"unknown backbone_type {backbone_type!r}; "
                             "expected 'resnet' or 'mobilenet_v3_large'")
        anchor_generator = AnchorGenerator(sizes, ((0.5, 1.0, 2.0),) * len(sizes))
        self.rpn = RegionProposalNetwork(
            anchor_generator,
            RPNHead(256, anchor_generator.num_anchors_per_location()[0],
                    conv_depth=2 if v2 else 1),
            pre_nms_top_n=rpn_pre_nms_top_n,
            post_nms_top_n=rpn_post_nms_top_n,
            nms_thresh=rpn_nms_thresh,
            score_thresh=rpn_score_thresh,
        )
        pool = MultiScaleRoIAlign(self.featmap_names, 7, 2)
        self.roi_heads = RoIHeads(
            pool,
            FastRCNNConvFCHead() if v2 else TwoMLPHead(256 * 7 * 7, 1024),
            FastRCNNPredictor(1024, num_classes),
            score_thresh=box_score_thresh,
            nms_thresh=box_nms_thresh,
            detections_per_img=box_detections_per_img,
        )

    def features_and_rpn(self, images: torch.Tensor):
        """Backbone features, RPN head outputs and anchors."""
        feats = self.backbone(images)
        rpn_feats = [feats[k] for k in self.featmap_names + ["pool"]]
        objectness, deltas = self.rpn.head(rpn_feats)
        anchors = self.rpn.anchor_generator(
            tuple(images.shape[-2:]), [tuple(f.shape[-2:]) for f in rpn_feats],
            images.device,
        )
        return feats, objectness, deltas, anchors

    @staticmethod
    def make_rois(boxes: torch.Tensor) -> torch.Tensor:
        """[N, P, 4] -> [N*P, 5] rows of (batch index as f32, x1, y1, x2, y2)."""
        n, p = boxes.shape[:2]
        batch_idx = torch.arange(n, dtype=torch.float32, device=boxes.device)
        return torch.cat(
            [batch_idx.repeat_interleave(p)[:, None], boxes.reshape(-1, 4)], 1
        )

    def forward(self, images: torch.Tensor, return_features: bool = False):
        """``Detections`` of ``images``; with ``return_features`` also the
        FPN feature dict the box path computed (the mask and keypoint
        branches pool from it: no second backbone pass)."""
        image_size = tuple(images.shape[-2:])
        feats, objectness, deltas, anchors = self.features_and_rpn(images)
        proposals = self.rpn.filter_proposals(objectness, deltas, anchors,
                                              image_size)
        n, p = proposals.boxes.shape[:2]
        rois = self.make_rois(proposals.boxes)
        pooled = self.roi_heads.box_roi_pool(
            {k: feats[k] for k in self.featmap_names}, rois, image_size
        )
        class_logits, box_regression = self.roi_heads.box_predictor(
            self.roi_heads.box_head(pooled)
        )
        dets = self.roi_heads.postprocess_detections(
            class_logits.reshape(n, p, -1), box_regression.reshape(n, p, -1),
            proposals.boxes, proposals.valid, image_size,
        )
        return (dets, feats) if return_features else dets

    def compute_loss(
        self,
        images: torch.Tensor,
        gt_boxes: torch.Tensor,
        gt_labels: torch.Tensor,
        gt_valid: torch.Tensor,
        generator: torch.Generator,
        return_internals: bool = False,
    ):
        """The training losses ``{"loss_objectness", "loss_rpn_box_reg",
        "loss_classifier", "loss_box_reg"}`` of ``images [N, 3, H, W]`` with
        ``gt_boxes [N, G, 4]`` (canvas frame), ``gt_labels [N, G]`` and
        ``gt_valid [N, G]`` (padding rows False). The RPN's sampler draws
        from ``generator`` first, then the box head's; the proposals carry
        no gradient. With ``return_internals`` also ``(feats, sampled,
        image_size)``, which the mask and keypoint losses take."""
        image_size = tuple(images.shape[-2:])
        feats, objectness, deltas, anchors = self.features_and_rpn(images)
        rpn_losses = self.rpn.compute_loss(objectness, deltas, anchors,
                                           gt_boxes, gt_valid, generator)
        proposals = self.rpn.filter_proposals(objectness, deltas, anchors,
                                              image_size)
        sampled = self.roi_heads.select_training_samples(
            proposals.boxes, proposals.valid, gt_boxes, gt_labels, gt_valid,
            generator)
        n, s = sampled.boxes.shape[:2]
        pooled = self.roi_heads.box_roi_pool(
            {k: feats[k] for k in self.featmap_names},
            self.make_rois(sampled.boxes), image_size,
        )
        class_logits, box_regression = self.roi_heads.box_predictor(
            self.roi_heads.box_head(pooled)
        )
        losses = {**rpn_losses, **self.roi_heads.fastrcnn_loss(
            class_logits.reshape(n, s, -1), box_regression.reshape(n, s, -1),
            sampled)}
        if return_internals:
            return losses, (feats, sampled, image_size)
        return losses


@torch.no_grad()
def init_weights(model: FasterRCNN, generator: torch.Generator) -> None:
    """torchvision's initialisation, drawn from ``generator``: the trunk's
    convs, and the mask and keypoint heads' (transposed ones included),
    He-normal (fan out), as are v2's box head's, the FPN's He-uniform (a=1),
    the RPN head's N(0, 0.01), all with zero bias; the linear layers
    PyTorch's default uniform. Batch norms keep their identity values. A deformable trunk's
    offset predictors (``conv2_offset``) are zero, weight and bias, as the
    JAX package's are, and draw nothing, so that its other parameters are
    the plain model's of the same seed; its deformable ``conv2`` is drawn as
    the plain trunk's."""
    for name, m in model.named_modules():
        if name.endswith("conv2_offset"):
            m.weight.zero_()
            m.bias.zero_()
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, DeformConv2d)):
            fan_in = m.weight[0].numel()
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            if name.startswith(_HE_NORMAL):
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                 generator=generator)
            elif name.startswith("backbone.fpn"):
                bound = math.sqrt(3.0 / fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
            else:
                m.weight.normal_(0.0, 0.01, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)


class FasterRCNN_ResNet50_FPN_Weights(WeightsEnum):
    COCO_V1 = Weights(
        url="https://download.pytorch.org/models/"
        "fasterrcnn_resnet50_fpn_coco-258fb6c6.pth",
        transforms=ObjectDetection,
        meta={"num_params": 41755286,
              "_metrics": {"COCO-val2017": {"box_map": 37.0}}},
    )
    DEFAULT = COCO_V1


class FasterRCNN_ResNet50_FPN_V2_Weights(WeightsEnum):
    COCO_V1 = Weights(
        url="https://download.pytorch.org/models/"
        "fasterrcnn_resnet50_fpn_v2_coco-dd69338a.pth",
        transforms=ObjectDetection,
        meta={"num_params": 43712278,
              "_metrics": {"COCO-val2017": {"box_map": 46.7}}},
    )
    DEFAULT = COCO_V1


def _upgrade_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Checkpoints written before torchvision wrapped the RPN and FPN convs
    in ``Conv2dNormActivation`` name them without the inner ``.0``. A
    norm-free (v1) mask head that torchvision saved as a ``Sequential`` of
    ``Conv2dNormActivation`` (``mask_head.{i}.0``) goes back to the
    ``mask_fcn{i+1}`` names of the published checkpoints and of the JAX
    package (its ``_frcnn_hooks``). The v2 names (``rpn.head.conv.{i}.0``,
    ``box_head.{i}.0`` / ``.1``, ``box_head.5``, ``mask_head.{i}.0`` /
    ``.1``, the FPN's ``inner_blocks.{i}.1``) are the port's as they
    stand."""
    v1_mask = not any(re.match(r"^roi_heads\.mask_head\.\d+\.1\.", k) for k in sd)
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^rpn\.head\.conv\.(weight|bias)$", r"rpn.head.conv.0.0.\1", k)
        k = re.sub(r"^(backbone\.fpn\.(?:inner|layer)_blocks\.\d+)\.(weight|bias)$",
                   r"\1.0.\2", k)
        if v1_mask:
            k = re.sub(r"^roi_heads\.mask_head\.(\d+)\.0\.(weight|bias)$",
                       lambda m: f"roi_heads.mask_head.mask_fcn{int(m[1]) + 1}."
                                 f"{m[2]}", k)
        out[k] = v
    return out


def freeze_resnet_trunk(model: nn.Module, trainable_layers: int) -> None:
    """``freeze_trunk_layers`` of ``model.backbone.body``."""
    freeze_trunk_layers(model.backbone.body, trainable_layers)


def freeze_mobilenet_trunk(model: nn.Module, trainable_layers: int) -> None:
    """torchvision's rule for the MobileNet FPN trunk (0-6 stages)."""
    freeze_layers_before(model.backbone.body,
                         MobileNetV3FPNBackbone.stage_starts, trainable_layers)


def build_detector(
    cls,
    weights: Optional[Union[WeightsEnum, Weights, str]],
    weights_enum,
    device: Union[str, torch.device, None],
    seed: int,
    trainable_backbone_layers: Optional[int],
    init=None,
    upgrade=None,
    freeze=freeze_resnet_trunk,
    **kwargs,
) -> nn.Module:
    """A detector ``cls(**kwargs)`` in eval mode, on ``device`` (the card
    when None). Without ``weights`` the parameters are torchvision's
    initialisation (``init(model, generator)``, ``init_weights`` unless
    given) drawn from a CPU ``torch.Generator`` seeded with ``seed``, so
    every device gets the same numbers. ``trainable_backbone_layers``
    leaves only the last that many trunk stages trainable
    (``freeze(model, n)``: the ResNet trunk's 0-5 by default); None trains
    all, as the JAX recipe's default does. A checkpoint goes through
    ``upgrade`` (``_upgrade_state_dict`` unless given) and must hold every
    tensor of the model but a deformable trunk's offset predictors, which
    start at zero where it has none (a plain checkpoint in a deform
    model)."""
    device = resolve_device(device)
    weights = weights_enum.verify(weights)
    model = cls(**kwargs)
    if weights is not None:
        missing, unexpected = model.load_state_dict(
            (upgrade or _upgrade_state_dict)(weights.get_state_dict()),
            strict=False)
        if unexpected or any(".conv2_offset." not in k for k in missing):
            raise RuntimeError(f"checkpoint does not fit the model: missing "
                               f"{missing}, unexpected {unexpected}")
        with torch.no_grad():
            for k in missing:
                model.get_parameter(k).zero_()
    else:
        (init or init_weights)(model, torch.Generator().manual_seed(seed))
    if trainable_backbone_layers is not None:
        freeze(model, trainable_backbone_layers)
    return model.eval().to(device)


@register_model()
def fasterrcnn_resnet50_fpn(
    *,
    weights: Optional[Union[FasterRCNN_ResNet50_FPN_Weights, Weights, str]] = None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trainable_backbone_layers: Optional[int] = None,
    **kwargs,
) -> FasterRCNN:
    """Faster R-CNN ResNet-50-FPN (``build_detector``)."""
    return build_detector(FasterRCNN, weights, FasterRCNN_ResNet50_FPN_Weights,
                          device, seed, trainable_backbone_layers, **kwargs)


@register_model()
def fasterrcnn_resnet50_fpn_v2(
    *,
    weights: Optional[Union[FasterRCNN_ResNet50_FPN_V2_Weights, Weights, str]] = None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trainable_backbone_layers: Optional[int] = None,
    **kwargs,
) -> FasterRCNN:
    """Faster R-CNN ResNet-50-FPN v2 (``FasterRCNN(v2=True)``,
    ``build_detector``)."""
    return build_detector(FasterRCNN, weights,
                          FasterRCNN_ResNet50_FPN_V2_Weights, device, seed,
                          trainable_backbone_layers, v2=True, **kwargs)


class FasterRCNN_MobileNet_V3_Large_FPN_Weights(WeightsEnum):
    COCO_V1 = Weights(
        url="https://download.pytorch.org/models/"
        "fasterrcnn_mobilenet_v3_large_fpn-fb6a3cc7.pth",
        transforms=ObjectDetection,
        meta={"num_params": 19386354,
              "_metrics": {"COCO-val2017": {"box_map": 32.8}}},
    )
    DEFAULT = COCO_V1


class FasterRCNN_MobileNet_V3_Large_320_FPN_Weights(WeightsEnum):
    COCO_V1 = Weights(
        url="https://download.pytorch.org/models/"
        "fasterrcnn_mobilenet_v3_large_320_fpn-907ea3f9.pth",
        transforms=ObjectDetection,
        meta={"num_params": 19386354,
              "_metrics": {"COCO-val2017": {"box_map": 22.8}}},
    )
    DEFAULT = COCO_V1


@register_model()
def fasterrcnn_mobilenet_v3_large_fpn(
    *,
    weights: Optional[Union[FasterRCNN_MobileNet_V3_Large_FPN_Weights, Weights,
                            str]] = None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trainable_backbone_layers: Optional[int] = None,
    **kwargs,
) -> FasterRCNN:
    """Faster R-CNN MobileNetV3-Large FPN (``build_detector``; its trunk
    freezes by stage, 0-6): RPN score threshold 0.05; served at the
    transform's default 800 / 1333."""
    kwargs.setdefault("rpn_score_thresh", 0.05)
    return build_detector(FasterRCNN, weights,
                          FasterRCNN_MobileNet_V3_Large_FPN_Weights, device,
                          seed, trainable_backbone_layers,
                          freeze=freeze_mobilenet_trunk,
                          backbone_type="mobilenet_v3_large", **kwargs)


@register_model()
def fasterrcnn_mobilenet_v3_large_320_fpn(
    *,
    weights: Optional[Union[FasterRCNN_MobileNet_V3_Large_320_FPN_Weights,
                            Weights, str]] = None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    trainable_backbone_layers: Optional[int] = None,
    **kwargs,
) -> FasterRCNN:
    """The low-resolution MobileNet Faster R-CNN: as
    ``fasterrcnn_mobilenet_v3_large_fpn`` with the RPN's pre- and post-NMS
    top-n at 150; served at ``GeneralizedRCNNTransform(min_size=320,
    max_size=640)``."""
    kwargs.setdefault("rpn_score_thresh", 0.05)
    kwargs.setdefault("rpn_pre_nms_top_n", 150)
    kwargs.setdefault("rpn_post_nms_top_n", 150)
    return build_detector(FasterRCNN, weights,
                          FasterRCNN_MobileNet_V3_Large_320_FPN_Weights,
                          device, seed, trainable_backbone_layers,
                          freeze=freeze_mobilenet_trunk,
                          backbone_type="mobilenet_v3_large", **kwargs)
