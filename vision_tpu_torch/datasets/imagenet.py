"""ImageNet (reference ``torchvision/datasets/imagenet.py``; the port's copy
of ``vision_tpu/datasets/imagenet.py``): an ImageFolder over a prepared
``root/{train,val}/<wnid>/*`` tree, the class names from ``root/meta.bin``
where it is there, and the devkit's metadata parsed through ``scipy.io``."""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Tuple

from vision_tpu_torch.datasets.folder import ImageFolder
from vision_tpu_torch.datasets.utils import verify_str_arg

__all__ = ["ARCHIVE_META", "META_FILE", "ImageNet", "parse_devkit_meta"]

ARCHIVE_META = {
    "train": ("ILSVRC2012_img_train.tar", "1d675b47d978889d74fa0da5fadfb00e"),
    "val": ("ILSVRC2012_img_val.tar", "29b22e2961454d5413ddabcf34fc5622"),
    "devkit": ("ILSVRC2012_devkit_t12.tar.gz", "fa75699e90414af021442c21a62c3abf"),
}

META_FILE = "meta.bin"


def parse_devkit_meta(devkit_root: str):
    """reference ``imagenet.py:109-206``: ``(wnid_to_classes, val_wnids)``
    from ``data/meta.mat`` (the leaf synsets) and the validation ground
    truth of an extracted devkit."""
    import scipy.io as sio

    metafile = os.path.join(devkit_root, "data", "meta.mat")
    meta = sio.loadmat(metafile, squeeze_me=True)["synsets"]
    nums_children = list(zip(*meta))[4]
    meta = [meta[idx] for idx, num_children in enumerate(nums_children)
            if num_children == 0]
    idcs, wnids, classes = list(zip(*meta))[:3]
    classes = [tuple(clss.split(", ")) for clss in classes]
    idx_to_wnid = dict(zip(idcs, wnids))
    wnid_to_classes = dict(zip(wnids, classes))
    vgt = os.path.join(devkit_root, "data",
                       "ILSVRC2012_validation_ground_truth.txt")
    with open(vgt) as f:
        val_idcs = [int(line) for line in f]
    val_wnids = [idx_to_wnid[idx] for idx in val_idcs]
    return wnid_to_classes, val_wnids


class ImageNet(ImageFolder):
    """reference ``imagenet.py:23`` over the extracted layout
    ``root/{train,val}/<wnid>/*.JPEG`` (and ``meta.bin``, a pickle of
    ``(wnid_to_classes, val_wnids)``, where it is there). ``classes`` are
    the class names, ``wnids`` the folder names."""

    def __init__(self, root: str, split: str = "train", **kwargs: Any):
        root = os.path.expanduser(root)
        self.split = verify_str_arg(split, "split", ("train", "val"))
        wnid_to_classes = self._load_meta(root)
        super().__init__(os.path.join(root, self.split), **kwargs)
        self.root = root
        self.wnids = self.classes
        self.wnid_to_idx = self.class_to_idx
        if wnid_to_classes:
            self.classes = [wnid_to_classes.get(w, (w,)) for w in self.wnids]
            self.class_to_idx = {cls: idx for idx, clss in enumerate(self.classes)
                                 for cls in clss}

    @staticmethod
    def _load_meta(root: str) -> Dict[str, Tuple[str, ...]]:
        meta_path = os.path.join(root, META_FILE)
        if os.path.exists(meta_path):
            with open(meta_path, "rb") as f:
                return pickle.load(f)[0]
        return {}
