"""Detection models (counterpart of ``vision_tpu/models/detection``)."""

from vision_tpu_torch.models.detection.faster_rcnn import (
    FasterRCNN,
    FasterRCNN_MobileNet_V3_Large_320_FPN_Weights,
    FasterRCNN_MobileNet_V3_Large_FPN_Weights,
    FasterRCNN_ResNet50_FPN_V2_Weights,
    FasterRCNN_ResNet50_FPN_Weights,
    fasterrcnn_mobilenet_v3_large_320_fpn,
    fasterrcnn_mobilenet_v3_large_fpn,
    fasterrcnn_resnet50_fpn,
    fasterrcnn_resnet50_fpn_v2,
)
from vision_tpu_torch.models.detection.fcos import (
    FCOS,
    FCOS_ResNet50_FPN_Weights,
    fcos_resnet50_fpn,
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
from vision_tpu_torch.models.detection.ssd import (
    SSD,
    SSD300_VGG16_Weights,
    ssd300_vgg16,
)
from vision_tpu_torch.models.detection.ssdlite import (
    SSDLite,
    SSDLite320_MobileNet_V3_Large_Weights,
    ssdlite320_mobilenet_v3_large,
)
from vision_tpu_torch.models.detection.transform import (
    GeneralizedRCNNTransform,
    resize_boxes,
    resize_keypoints,
)

__all__ = [
    "Detections",
    "FCOS",
    "FCOS_ResNet50_FPN_Weights",
    "FasterRCNN",
    "FasterRCNN_MobileNet_V3_Large_320_FPN_Weights",
    "FasterRCNN_MobileNet_V3_Large_FPN_Weights",
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
    "SSD",
    "SSD300_VGG16_Weights",
    "SSDLite",
    "SSDLite320_MobileNet_V3_Large_Weights",
    "fasterrcnn_mobilenet_v3_large_320_fpn",
    "fasterrcnn_mobilenet_v3_large_fpn",
    "fasterrcnn_resnet50_fpn",
    "fasterrcnn_resnet50_fpn_v2",
    "fcos_resnet50_fpn",
    "keypointrcnn_resnet50_fpn",
    "maskrcnn_resnet50_fpn",
    "maskrcnn_resnet50_fpn_deform",
    "maskrcnn_resnet50_fpn_v2",
    "paste_masks_in_image",
    "resize_boxes",
    "resize_keypoints",
    "retinanet_resnet50_fpn",
    "retinanet_resnet50_fpn_v2",
    "ssd300_vgg16",
    "ssdlite320_mobilenet_v3_large",
]
