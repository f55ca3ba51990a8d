"""Models (counterpart of ``vision_tpu/models``): the classification
families, ``detection``, ``segmentation``, ``optical_flow``, ``video`` and
``feature_extraction``."""

import importlib

from vision_tpu_torch.models import (
    alexnet,
    convnext,
    densenet,
    detection,
    efficientnet,
    feature_extraction,
    googlenet,
    inception,
    maxvit,
    mnasnet,
    mobilenetv2,
    mobilenetv3,
    optical_flow,
    regnet,
    resnet,
    segmentation,
    shufflenetv2,
    squeezenet,
    swin_transformer,
    vgg,
    video,
    vision_transformer,
)
from vision_tpu_torch.models._api import get_model, get_model_weights, list_models
from vision_tpu_torch.models.alexnet import *  # noqa: F401,F403
from vision_tpu_torch.models.convnext import *  # noqa: F401,F403
from vision_tpu_torch.models.densenet import *  # noqa: F401,F403
from vision_tpu_torch.models.efficientnet import *  # noqa: F401,F403
from vision_tpu_torch.models.googlenet import *  # noqa: F401,F403
from vision_tpu_torch.models.inception import *  # noqa: F401,F403
from vision_tpu_torch.models.maxvit import *  # noqa: F401,F403
from vision_tpu_torch.models.mnasnet import *  # noqa: F401,F403
from vision_tpu_torch.models.mobilenetv2 import *  # noqa: F401,F403
from vision_tpu_torch.models.mobilenetv3 import *  # noqa: F401,F403
from vision_tpu_torch.models.regnet import *  # noqa: F401,F403
from vision_tpu_torch.models.shufflenetv2 import *  # noqa: F401,F403
from vision_tpu_torch.models.squeezenet import *  # noqa: F401,F403
from vision_tpu_torch.models.swin_transformer import *  # noqa: F401,F403
from vision_tpu_torch.models.vgg import *  # noqa: F401,F403
from vision_tpu_torch.models.feature_extraction import (
    create_feature_extractor,
    get_graph_node_names,
)
from vision_tpu_torch.models.resnet import (
    ResNet,
    ResNet18_Weights,
    ResNet34_Weights,
    ResNet50_Weights,
    ResNet101_Weights,
    ResNet152_Weights,
    ResNeXt50_32X4D_Weights,
    ResNeXt101_32X8D_Weights,
    ResNeXt101_64X4D_Weights,
    Wide_ResNet50_2_Weights,
    Wide_ResNet101_2_Weights,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    resnext50_32x4d,
    resnext101_32x8d,
    resnext101_64x4d,
    wide_resnet50_2,
    wide_resnet101_2,
)
from vision_tpu_torch.models.vision_transformer import (
    ViT_B_16_Weights,
    ViT_B_32_Weights,
    ViT_H_14_Weights,
    ViT_L_16_Weights,
    ViT_L_32_Weights,
    VisionTransformer,
    vit_b_16,
    vit_b_32,
    vit_h_14,
    vit_l_16,
    vit_l_32,
)

__all__ = [
    "ResNet",
    "ResNet18_Weights",
    "ResNet34_Weights",
    "ResNet50_Weights",
    "ResNet101_Weights",
    "ResNet152_Weights",
    "ResNeXt50_32X4D_Weights",
    "ResNeXt101_32X8D_Weights",
    "ResNeXt101_64X4D_Weights",
    "Wide_ResNet50_2_Weights",
    "Wide_ResNet101_2_Weights",
    "ViT_B_16_Weights",
    "ViT_B_32_Weights",
    "ViT_H_14_Weights",
    "ViT_L_16_Weights",
    "ViT_L_32_Weights",
    "VisionTransformer",
    "detection",
    "get_model",
    "get_model_weights",
    "list_models",
    "resnet",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "resnext50_32x4d",
    "resnext101_32x8d",
    "resnext101_64x4d",
    "vision_transformer",
    "vit_b_16",
    "vit_b_32",
    "vit_h_14",
    "vit_l_16",
    "vit_l_32",
    "wide_resnet50_2",
    "wide_resnet101_2",
    "create_feature_extractor",
    "get_graph_node_names",
    "convnext",
    "densenet",
    "efficientnet",
    "inception",
    "maxvit",
    "mnasnet",
    "mobilenetv2",
    "mobilenetv3",
    "regnet",
    "shufflenetv2",
    "squeezenet",
    "swin_transformer",
    "vgg",
    "feature_extraction",
    "optical_flow",
    "segmentation",
    "video",
]

# the families' classes, weights and builders (each module's ``__all__``;
# the builders ``alexnet`` and ``googlenet`` shadow their modules here)
__all__ += [name for family in (
    "alexnet", "convnext", "densenet", "efficientnet", "googlenet",
    "inception", "maxvit", "mnasnet", "mobilenetv2", "mobilenetv3", "regnet",
    "shufflenetv2", "squeezenet", "swin_transformer", "vgg")
    for name in importlib.import_module(f"{__name__}.{family}").__all__]
