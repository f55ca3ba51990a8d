"""Detection models (counterpart of ``vision_tpu/models/detection``)."""

from vision_tpu_torch.models.detection.faster_rcnn import (
    FasterRCNN,
    FasterRCNN_ResNet50_FPN_V2_Weights,
    FasterRCNN_ResNet50_FPN_Weights,
    fasterrcnn_resnet50_fpn,
    fasterrcnn_resnet50_fpn_v2,
)
from vision_tpu_torch.models.detection.image_list import ImageList
from vision_tpu_torch.models.detection.keypoint_rcnn import (
    KeypointDetections,
    KeypointRCNN,
    KeypointRCNN_ResNet50_FPN_Weights,
    keypointrcnn_resnet50_fpn,
)
from vision_tpu_torch.models.detection.mask_rcnn import (
    MaskDetections,
    MaskRCNN,
    MaskRCNN_ResNet50_FPN_V2_Weights,
    MaskRCNN_ResNet50_FPN_Weights,
    maskrcnn_resnet50_fpn,
    maskrcnn_resnet50_fpn_deform,
    maskrcnn_resnet50_fpn_v2,
)
from vision_tpu_torch.models.detection.retinanet import (
    RetinaNet,
    RetinaNet_ResNet50_FPN_V2_Weights,
    RetinaNet_ResNet50_FPN_Weights,
    retinanet_resnet50_fpn,
    retinanet_resnet50_fpn_v2,
)
from vision_tpu_torch.models.detection.roi_heads import (
    Detections,
    paste_masks_in_image,
)
from vision_tpu_torch.models.detection.transform import (
    GeneralizedRCNNTransform,
    resize_boxes,
    resize_keypoints,
)

__all__ = [
    "Detections",
    "FasterRCNN",
    "FasterRCNN_ResNet50_FPN_V2_Weights",
    "FasterRCNN_ResNet50_FPN_Weights",
    "GeneralizedRCNNTransform",
    "ImageList",
    "KeypointDetections",
    "KeypointRCNN",
    "KeypointRCNN_ResNet50_FPN_Weights",
    "MaskDetections",
    "MaskRCNN",
    "MaskRCNN_ResNet50_FPN_V2_Weights",
    "MaskRCNN_ResNet50_FPN_Weights",
    "RetinaNet",
    "RetinaNet_ResNet50_FPN_V2_Weights",
    "RetinaNet_ResNet50_FPN_Weights",
    "fasterrcnn_resnet50_fpn",
    "fasterrcnn_resnet50_fpn_v2",
    "keypointrcnn_resnet50_fpn",
    "maskrcnn_resnet50_fpn",
    "maskrcnn_resnet50_fpn_deform",
    "maskrcnn_resnet50_fpn_v2",
    "paste_masks_in_image",
    "resize_boxes",
    "resize_keypoints",
    "retinanet_resnet50_fpn",
    "retinanet_resnet50_fpn_v2",
]
