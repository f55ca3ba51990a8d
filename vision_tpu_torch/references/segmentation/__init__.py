"""The segmentation recipe: COCO-as-VOC plumbing and the trainer."""
