"""``wrap_dataset_for_transforms_v2`` in the port
(``vision_tpu_torch/tv_tensors/_dataset_wrapper.py``) against
``vision_tpu``'s, on the CPU: the COCO and VOC datasets on a seeded tree
of ``tools/coco_folder.py``, and every other factory of the registry
through stand-in datasets of those class names (the port lacks CelebA,
Kitti, WIDERFace, OxfordIIITPet, Cityscapes and the video datasets), each
returning the same samples to both wrappers: HWC arrays to the JAX
package's, CHW tensors to the port's. The typed outputs are equal in type,
metadata and values. COCO ``"masks"``: the JAX wrapper calls
``pycocotools``, which this machine lacks (it raises
``ModuleNotFoundError``); the port's masks are held against JAX's
``convert_coco_poly_to_mask`` (PIL) under the rule of
``test_torch_coco_voc.py``."""

import numpy as np
import pytest
import torch

import vision_tpu.datasets as jd
from vision_tpu import tv_tensors as jtv
from vision_tpu.datasets import wrap_dataset_for_transforms_v2 as jwrap
from vision_tpu_torch import datasets as pd
from vision_tpu_torch import tv_tensors as ptv
from vision_tpu_torch.tv_tensors import wrap_dataset_for_transforms_v2 as pwrap
from vision_tpu_torch.tools import coco_folder
from torch_refs_cases import load_reference, masks_off_outline

jcu = load_reference("detection", "coco_utils")
JPEG_TOL = 8


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("wrapper")
    coco_folder.write_coco_tree(root, train=4, val=3, empty=(1,))
    coco_folder.write_voc_tree(root, train=3, val=5)
    return root


def value(x):
    """A typed output as ``(kind, metadata, numpy)``; lists, tuples and
    dicts element for element."""
    if isinstance(x, dict):
        return {k: value(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(value(v) for v in x)
    if isinstance(x, torch.Tensor):
        meta = (x.format.value, tuple(x.canvas_size)) if isinstance(
            x, ptv.BoundingBoxes) else None
        kind = type(x).__name__ if isinstance(x, ptv.TVTensor) else "array"
        return kind, meta, x.as_subclass(torch.Tensor).numpy()
    if isinstance(x, jtv.TVTensor):
        meta = (x.format.value, tuple(x.canvas_size)) if isinstance(
            x, jtv.BoundingBoxes) else None
        return type(x).__name__, meta, np.asarray(x.data)
    if isinstance(x, np.ndarray):
        return "array", None, x
    return x


def assert_same(got, want, image_tol=0):
    """Port output against JAX output: the same structure and kinds,
    images CHW against HWC within ``image_tol``, the rest exactly."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same(got[k], want[k], image_tol)
    elif isinstance(want, (list, tuple)) and not (
            len(want) == 3 and isinstance(want[0], str)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w, image_tol)
    elif isinstance(want, tuple):  # (kind, meta, array)
        assert got[:2] == want[:2]
        g, w = got[2], want[2]
        if got[0] in ("Image", "Video"):
            g = np.moveaxis(g, -3, -1)
            assert np.abs(g.astype(int) - w.astype(int)).max() <= image_tol
        else:
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype or (g.dtype.kind == w.dtype.kind == "f")
    else:
        assert got == want


def coco_pair(root, split="val"):
    args = (str(root / f"{split}2017"),
            str(root / "annotations" / f"instances_{split}2017.json"))
    return jd.CocoDetection(*args), pd.CocoDetection(*args)


@pytest.mark.parametrize("keys", [None, ["image_id", "boxes", "labels", "iscrowd"],
                                  "all_but_masks", ["bbox", "category_id", "area"]])
def test_coco_detection_equals_jax(tree, keys):
    j, p = coco_pair(tree, "train")
    if keys == "all_but_masks":
        keys = ["segmentation", "area", "iscrowd", "image_id", "bbox",
                "category_id", "boxes", "labels"]
    jw, pw = jwrap(j, target_keys=keys), pwrap(p, target_keys=keys)
    assert len(pw) == len(jw) == 4
    for i in range(len(pw)):
        (ji, jt), (pi, pt) = jw[i], pw[i]
        assert_same(value((pi, pt)), value((ji, jt)), JPEG_TOL)
    assert pw[1][1] == {"image_id": p.ids[1]}  # no annotations
    assert pw.coco is p.coco  # attributes pass through


def test_coco_masks_equal_jax_converter(tree):
    j, p = coco_pair(tree)
    with pytest.raises(ModuleNotFoundError, match="pycocotools"):
        jwrap(j, target_keys=["masks"])[0]
    pw = pwrap(p, target_keys=["masks", "segmentation", "boxes"])
    differ = off = 0
    for i in range(len(pw)):
        img, t = pw[i]
        h, w = img.shape[-2:]
        segs = t["segmentation"]
        assert isinstance(t["masks"], ptv.Mask) and t["masks"].shape == (len(segs), h, w)
        want = jcu.convert_coco_poly_to_mask(segs, h, w)
        d, o = masks_off_outline(t["masks"].as_subclass(torch.Tensor).numpy(), want,
                                 segs, h, w)
        differ, off = differ + d, off + o
    print(f"mask pixels unlike PIL's: {differ}, off its outline: {off}")
    assert off == 0 and differ <= 20
    with pytest.raises(ValueError, match="unknown target keys"):
        pwrap(p, target_keys=["boxes", "keypoints"])


@pytest.mark.parametrize("keys", [None, ["boxes", "labels"], ["annotation"]])
def test_voc_equals_jax(tree, keys):
    for split in ("train", "val"):
        jw = jwrap(jd.VOCDetection(str(tree), image_set=split), target_keys=keys)
        pw = pwrap(pd.VOCDetection(str(tree), image_set=split), target_keys=keys)
        for i in range(len(pw)):
            assert_same(value(pw[i]), value(jw[i]), JPEG_TOL)
    js = jwrap(jd.VOCSegmentation(str(tree), image_set="val"))
    ps = pwrap(pd.VOCSegmentation(str(tree), image_set="val"))
    for i in range(len(ps)):
        assert_same(value(ps[i]), value(js[i]), JPEG_TOL)
        assert isinstance(ps[i][1], ptv.Mask)


class _StandIn:
    """A dataset of canned samples; subclasses take the registry's names."""

    def __init__(self, samples, **attrs):
        self.samples = samples
        self.__dict__.update(attrs)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def stand_in(name, samples, **attrs):
    return type(name, (_StandIn,), {})(samples, **attrs)


def _images(rng, n=2, h=6, w=9):
    hwc = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(n)]
    return hwc, [torch.from_numpy(a).permute(2, 0, 1).contiguous() for a in hwc]


def _kitti(i):
    return [{"type": t, "truncated": 0.0, "occluded": 0, "alpha": -1.5,
             "bbox": [1.0 + i, 2.0, 5.5, 6.0 + i], "dimensions": [1.6, 1.7, 3.6],
             "location": [-0.6, 1.7, 46.7], "rotation_y": -1.6}
            for t in ("Car", "Pedestrian", "DontCare")[:i + 1]]


CASES = {
    # name: (targets, stand-in attributes, target_keys to try)
    "Kitti": ([_kitti(0), _kitti(2)], {}, [None, ["boxes", "type", "alpha"]]),
    "WIDERFace": ([{"bbox": np.array([[1, 2, 3, 4], [0, 0, 2, 2]], np.int64),
                    "blur": np.array([0, 1]), "expression": np.array([0, 0]),
                    "illumination": np.array([0, 1]), "occlusion": np.array([1, 0]),
                    "pose": np.array([0, 0]), "invalid": np.array([0, 0])}, None],
                  {}, [None, ["bbox", "pose"]]),
    "CelebA": ([np.array([1, 2, 3, 4]), np.array([0, 1, 5, 5])],
               {"target_type": ["bbox"]}, [None]),
    "CelebA_identity": ([(np.array([1, 2, 3, 4]), 7), (np.array([0, 1, 5, 5]), 9)],
                        {"target_type": ["bbox", "identity"]}, [None]),
    "OxfordIIITPet": ([(3, "MASK"), (1, "MASK")],
                      {"_target_types": ["category", "segmentation"]}, [None]),
    "Cityscapes": ([("SEM", "INST"), ("SEM", "INST")],
                   {"target_type": ["semantic", "instance"]}, [None]),
    "Caltech101": ([4, 5], {"target_type": ["category"]}, [None]),
    "SBDataset": (["MASK", "MASK"], {"mode": "segmentation"}, [None]),
    "GTSRB": ([1, 2], {}, [None]),
    "ImageFolder": ([0, 1], {}, [None]),
    "CocoCaptions": ([["a", "b"], ["c"]], {}, [None]),
    "SomethingElse": ([0, 1], {}, [None]),
}


def _fill(target, rng, h=6, w=9):
    """The placeholders of a case's target as arrays: ``"MASK"`` a class
    map, ``"SEM"`` a semantic map, ``"INST"`` instance ids (some >= 1000)."""
    if isinstance(target, str) and target in ("MASK", "SEM"):
        return rng.randint(0, 4, (h, w)).astype(np.uint8)
    if isinstance(target, str) and target == "INST":
        return rng.choice(np.array([0, 7, 26001, 26002], np.int32), (h, w))
    if isinstance(target, tuple):
        return tuple(_fill(t, rng, h, w) for t in target)
    return target


def _port(target):
    if isinstance(target, np.ndarray):
        return torch.from_numpy(target)
    if isinstance(target, tuple):
        return tuple(_port(t) for t in target)
    return target


@pytest.mark.parametrize("name", sorted(CASES))
def test_stand_in_factories_equal_jax(name):
    targets, attrs, key_sets = CASES[name]
    rng = np.random.RandomState(len(name))
    hwc, chw = _images(rng, len(targets))
    filled = [_fill(t, rng) for t in targets]
    cls = name.split("_")[0]
    for keys in key_sets:
        jw = jwrap(stand_in(cls, list(zip(hwc, filled)), **attrs), target_keys=keys)
        pw = pwrap(stand_in(cls, [(c, _port(t)) for c, t in zip(chw, filled)], **attrs),
                   target_keys=keys)
        for i in range(len(targets)):
            got, want = pw[i], jw[i]
            assert isinstance(got[0], ptv.Image)
            assert_same(value(got), value(want))


@pytest.mark.parametrize("name", ["HMDB51", "Kinetics", "UCF101"])
def test_video_stand_ins_equal_jax(name):
    rng = np.random.RandomState(1)
    clip = rng.randint(0, 256, (4, 6, 5, 3)).astype(np.uint8)
    audio = np.zeros((1, 0), np.float32)
    jw = jwrap(stand_in(name, [(clip, audio, 3)]))
    pw = pwrap(stand_in(name, [(torch.from_numpy(clip).permute(0, 3, 1, 2), audio, 3)]))
    (jv, ja, jl), (pv, pa, pl) = jw[0], pw[0]
    assert isinstance(pv, ptv.Video) and pl == jl == 3 and pa is audio
    np.testing.assert_array_equal(pv.as_subclass(torch.Tensor).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jv.data))


@pytest.mark.parametrize("name,attrs", [
    ("CelebA", {"target_type": ["attr"]}), ("CelebA", {"target_type": ["landmarks"]}),
    ("Cityscapes", {"target_type": ["color"]}), ("Cityscapes", {"target_type": ["polygon"]}),
    ("Caltech101", {"target_type": ["annotation"]}), ("SBDataset", {"mode": "boundaries"})])
def test_unsupported_targets_raise_as_jax(name, attrs):
    for wrap in (jwrap, pwrap):
        with pytest.raises(RuntimeError, match="not supported"):
            wrap(stand_in(name, [(None, None)], **attrs))[0]


@pytest.mark.parametrize("name", ["ImageFolder", "VOCSegmentation", "CelebA",
                                  "SomethingElse", "HMDB51"])
def test_target_keys_raise_as_jax(name):
    for wrap in (jwrap, pwrap):
        with pytest.raises(ValueError, match="target_keys"):
            wrap(stand_in(name, [], target_type=["bbox"]), target_keys=["boxes"])


def test_port_datasets_and_wrapper_are_exported():
    import vision_tpu_torch.datasets as d
    import vision_tpu_torch.tv_tensors as t

    for n in ("COCOIndex", "CocoCaptions", "CocoDetection", "VOCDetection",
              "VOCSegmentation", "wrap_dataset_for_transforms_v2"):
        assert n in d.__all__ and hasattr(d, n)
        assert n in jd.__all__
    assert "wrap_dataset_for_transforms_v2" in t.__all__
    assert d.wrap_dataset_for_transforms_v2 is t.wrap_dataset_for_transforms_v2
