"""Video classification (counterpart of ``vision_tpu/models/video``): the
video ResNets, S3D, the video Swin Transformer and MViT. Input ``[N, C,
T, H, W]``."""

from vision_tpu_torch.models.video.mvit import (
    MViT,
    MViT_V1_B_Weights,
    MViT_V2_S_Weights,
    mvit_v1_b,
    mvit_v2_s,
)
from vision_tpu_torch.models.video.resnet import (
    MC3_18_Weights,
    R2Plus1D_18_Weights,
    R3D_18_Weights,
    VideoResNet,
    mc3_18,
    r2plus1d_18,
    r3d_18,
)
from vision_tpu_torch.models.video.s3d import S3D, S3D_Weights, s3d
from vision_tpu_torch.models.video.swin_transformer import (
    Swin3D_B_Weights,
    Swin3D_S_Weights,
    Swin3D_T_Weights,
    SwinTransformer3d,
    swin3d_b,
    swin3d_s,
    swin3d_t,
)

__all__ = [
    "MC3_18_Weights",
    "MViT",
    "MViT_V1_B_Weights",
    "MViT_V2_S_Weights",
    "R2Plus1D_18_Weights",
    "R3D_18_Weights",
    "S3D",
    "S3D_Weights",
    "Swin3D_B_Weights",
    "Swin3D_S_Weights",
    "Swin3D_T_Weights",
    "SwinTransformer3d",
    "VideoResNet",
    "mc3_18",
    "mvit_v1_b",
    "mvit_v2_s",
    "r2plus1d_18",
    "r3d_18",
    "s3d",
    "swin3d_b",
    "swin3d_s",
    "swin3d_t",
]
