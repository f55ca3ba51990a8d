"""COCO and Pascal VOC in the port (``vision_tpu_torch.datasets.coco``,
``.voc``, ``references/detection/coco_utils.py``,
``group_by_aspect_ratio.py`` and ``references/segmentation/
coco_utils.py`` inside the package) against ``vision_tpu.datasets`` and
the repo's ``references/``, on the CPU, on the same seeded trees of
``tools/coco_folder.py`` in a temporary directory.

Targets are equal exactly; RLE masks exactly; polygon masks pixel for
pixel against PIL's ``ImageDraw.polygon`` (the JAX package's rasteriser)
but for a few pixels where a polygon's truncated vertices make a sharp
spike, each of which must lie on PIL's outline of that polygon (the count
is printed and bounded); convex polygons exactly. Images decode within 8
of libjpeg (the port's decoder's stated bound). Samplers give the same
batches for the same order and group ids.
"""

import json

import numpy as np
import pytest
import torch

import vision_tpu.datasets as jd
from vision_tpu_torch import datasets as pd
from vision_tpu_torch.references.detection import coco_utils as pcu
from vision_tpu_torch.references.detection import group_by_aspect_ratio as pgba
from vision_tpu_torch.references.segmentation import coco_utils as pscu
from vision_tpu_torch.tools import coco_folder
from torch_refs_cases import load_reference, masks_off_outline, pil_outline

jcu = load_reference("detection", "coco_utils")
jgba = load_reference("detection", "group_by_aspect_ratio")
jscu = load_reference("segmentation", "coco_utils")

JPEG_TOL = 8  # the port's decoder against libjpeg, one sample
# polygon pixels that may differ from PIL's fill on the tree (all on PIL's
# outline); 5 of ~2,000,000 mask pixels at the default tree's seed
MAX_OUTLINE_PIXELS = 40


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_voc")
    info = coco_folder.write_coco_tree(root, train=12, val=4, empty=(2, 7))
    info["voc"] = coco_folder.write_voc_tree(root, train=4, val=5)
    return root, info


def ann_file(root, split):
    return str(root / "annotations" / f"instances_{split}2017.json")


def hwc(img):
    return img.permute(1, 2, 0).numpy()


def test_coco_index_and_detection_equal_jax(tree):
    root, info = tree
    j = jd.CocoDetection(str(root / "train2017"), ann_file(root, "train"))
    p = pd.CocoDetection(str(root / "train2017"), ann_file(root, "train"))
    assert p.ids == j.ids and len(p) == len(j) == 12
    assert p.coco.getImgIds() == j.coco.getImgIds()
    assert p.coco.getCatIds() == j.coco.getCatIds() and len(p.coco.cats) == 80
    assert p.coco.getAnnIds() == j.coco.getAnnIds()
    assert p.coco.getAnnIds(imgIds=p.ids[:3]) == j.coco.getAnnIds(imgIds=j.ids[:3])
    assert p.coco.loadCats(1) == j.coco.loadCats(1)
    for i in (0, 2, 5):
        (ji, jt), (pi, pt) = j[i], p[i]
        assert pt == jt
        assert pi.dtype == torch.uint8 and pi.shape[0] == 3
        err = np.abs(hwc(pi).astype(int) - np.asarray(ji).astype(int)).max()
        assert err <= JPEG_TOL
    assert p[2][1] == []  # an image left without annotations


def test_coco_captions_equal_jax(tree, tmp_path):
    root, _ = tree
    index = json.loads((root / "annotations" / "instances_val2017.json").read_text())
    caps = [{"id": k, "image_id": img["id"], "caption": f"caption {k}"}
            for k, img in enumerate(index["images"][:3] * 2)]
    path = tmp_path / "captions.json"
    path.write_text(json.dumps({"images": index["images"], "annotations": caps}))
    j = jd.CocoCaptions(str(root / "val2017"), str(path))
    p = pd.CocoCaptions(str(root / "val2017"), str(path))
    assert [p[i][1] for i in range(len(p))] == [j[i][1] for i in range(len(j))]
    assert p[0][1] == ["caption 0", "caption 3"]


@pytest.mark.parametrize("with_masks", [False, True])
def test_get_coco_targets_equal_jax(tree, with_masks):
    """``get_coco``'s training set: the two images without annotations
    dropped, every target equal; masks as the module docstring says."""
    root, info = tree
    j = jcu.get_coco(str(root), "train", with_masks=with_masks)
    p = pcu.get_coco(str(root), "train", with_masks=with_masks)
    assert p.ids == j.ids and len(p) == info["train"]["images"] - 2
    differ = off = 0
    for i in range(len(p)):
        (ji, jt), (pi, pt) = j[i], p[i]
        assert pt["image_id"] == jt["image_id"]
        for k in ("boxes", "labels", "area", "iscrowd"):
            assert pt[k].dtype == torch.from_numpy(np.asarray(jt[k])).dtype, k
            np.testing.assert_array_equal(pt[k].numpy(), jt[k], err_msg=k)
        assert ("masks" in pt) == with_masks
        if with_masks:
            anns = [a for a in p.base._load_target(p.ids[i]) if not a["iscrowd"]]
            kept = [a["segmentation"] for a, k in zip(anns, _kept(anns, pi))]
            d, o = masks_off_outline(pt["masks"], jt["masks"], kept, *pi.shape[-2:])
            differ, off = differ + d, off + o
    print(f"polygon mask pixels unlike PIL's: {differ}, off its outline: {off}")
    assert off == 0 and differ <= MAX_OUTLINE_PIXELS


def _kept(anns, img):
    h, w = img.shape[-2:]
    out = []
    for a in anns:
        x, y, bw, bh = np.asarray(a["bbox"], np.float32)
        x1, y1 = np.clip(x + bw, 0, w), np.clip(y + bh, 0, h)
        out.append(bool(x1 > np.clip(x, 0, w) and y1 > np.clip(y, 0, h)))
    return out


def test_rle_equals_jax(tree):
    """Compressed RLE (the tree's crowds, ``str`` and ``bytes``) and
    uncompressed counts, against JAX's ``decode_rle`` exactly; and the
    tree writer's encoder round-trips."""
    root, _ = tree
    anns = json.loads((root / "annotations" / "instances_train2017.json").read_text())
    crowds = [a["segmentation"] for a in anns["annotations"] if a["iscrowd"]]
    assert crowds
    rng = np.random.RandomState(3)
    for rle in crowds:
        np.testing.assert_array_equal(pcu.decode_rle(rle), jcu.decode_rle(rle))
        raw = dict(rle, counts=rle["counts"].encode())
        np.testing.assert_array_equal(pcu.decode_rle(raw), jcu.decode_rle(rle))
    for h, w in ((7, 5), (40, 31)):
        m = (rng.rand(h, w) > 0.6).astype(np.uint8)
        np.testing.assert_array_equal(pcu.decode_rle(coco_folder.encode_rle(m)), m)
        counts = coco_folder.encode_rle(m)
        flat = m.T.reshape(-1)
        runs = np.diff(np.concatenate([[0], np.flatnonzero(np.diff(flat)) + 1,
                                       [flat.size]])).tolist()
        plain = {"size": [h, w], "counts": ([0] if flat[0] else []) + runs}
        np.testing.assert_array_equal(pcu.decode_rle(plain), jcu.decode_rle(plain))
        np.testing.assert_array_equal(pcu.decode_rle(counts), jcu.decode_rle(counts))


@pytest.mark.parametrize("seed", range(4))
def test_convex_polygons_equal_pil(seed):
    """Convex polygons of 3-11 float vertices, unions of two, at the edge
    of the image and past it: JAX's (PIL's) fill pixel for pixel, but for
    a pixel at a sharp corner now and then, on PIL's outline (1 of ~70,000
    at these seeds)."""
    from scipy.spatial import ConvexHull

    rng = np.random.RandomState(seed)
    h, w = 57, 83
    differ = off = 0
    for _ in range(40):
        polys = []
        for _ in range(rng.randint(1, 3)):
            pts = rng.uniform(-5, [w + 5, h + 5], (rng.randint(3, 12), 2))
            hull = pts[ConvexHull(pts).vertices] if len(pts) > 3 else pts
            polys.append(np.clip(hull, 0, None).round(2).reshape(-1).tolist())
        got = pcu.convert_coco_poly_to_mask([polys], h, w)[0]
        want = jcu.convert_coco_poly_to_mask([polys], h, w)[0]
        d = got != want
        differ += int(d.sum())
        off += int((d & ~pil_outline(polys, h, w)).sum())
    print(f"convex polygon pixels unlike PIL's: {differ}, off its outline: {off}")
    assert off == 0 and differ <= 2


def test_convert_with_keypoints_and_degenerate_boxes_equals_jax():
    img = torch.zeros(3, 40, 50, dtype=torch.uint8)
    anno = [
        {"bbox": [1.5, 2.0, 10.0, 8.0], "category_id": 3, "area": 80.0,
         "segmentation": [[1.5, 2, 11.5, 2, 11.5, 10, 1.5, 10]],
         "keypoints": list(range(51)), "iscrowd": 0},
        {"bbox": [45.0, 30.0, 20.0, 20.0], "category_id": 7, "area": 400.0,
         "segmentation": [[45, 30, 60, 30, 60, 45]], "keypoints": [0] * 51},
        {"bbox": [60.0, 10.0, 5.0, 5.0], "category_id": 9, "area": 25.0,
         "segmentation": [[60, 10, 65, 10, 65, 15]], "keypoints": [1] * 51},
        {"bbox": [5.0, 5.0, 4.0, 4.0], "category_id": 2, "area": 16.0,
         "segmentation": {"size": [40, 50], "counts": [205, 4, 36, 4]},
         "iscrowd": 1, "keypoints": [0] * 51},
    ]
    target = {"image_id": 42, "annotations": anno}
    _, jt = jcu.ConvertCocoPolysToMask()(np.zeros((40, 50, 3), np.uint8), target)
    _, pt = pcu.ConvertCocoPolysToMask()(img, target)
    assert pt["image_id"] == 42 and len(pt["labels"]) == 2
    for k in ("boxes", "labels", "area", "iscrowd", "masks", "keypoints"):
        np.testing.assert_array_equal(pt[k].numpy(), jt[k], err_msg=k)


def test_remove_images_and_coco_api_equal_jax(tree):
    root, _ = tree
    jb = jd.CocoDetection(str(root / "train2017"), ann_file(root, "train"))
    pb = pd.CocoDetection(str(root / "train2017"), ann_file(root, "train"))
    for cats in (None, [1, 2, 3, 18, 44]):
        assert (pcu.coco_remove_images_without_annotations(pb, cats)
                == jcu.coco_remove_images_without_annotations(jb, cats))
    j = jcu.get_coco(str(root), "val")
    p = pcu.get_coco(str(root), "val")
    jg, pg = jcu.get_coco_api_from_dataset(j), pcu.get_coco_api_from_dataset(p)
    assert pg.keys() == jg.keys()
    for k in jg:
        for f in ("boxes", "labels", "iscrowd"):
            assert pg[k][f].dtype == jg[k][f].dtype
            np.testing.assert_array_equal(pg[k][f], jg[k][f])


def test_aspect_ratio_groups_and_sampler_equal_jax(tree):
    """Ratios from the index (no decode: the images are never read),
    groups, canvases; ``GroupedBatchSampler`` over random orders and
    groups, the tail refill included."""
    root, _ = tree
    p = pcu.get_coco(str(root), "train", with_masks=True)
    j = jd.CocoDetection(str(root / "train2017"), ann_file(root, "train"))
    j.ids = p.ids
    p.base._load_image = None  # a decode would fail
    assert pgba.compute_aspect_ratios(p) == jgba.compute_aspect_ratios(j)
    for k in (0, 1, 3):
        assert pgba.create_aspect_ratio_groups(p, k) == jgba.create_aspect_ratio_groups(j, k)
        assert pgba.group_canvas_sizes(k, 640, 1066) == jgba.group_canvas_sizes(k, 640, 1066)
    rng = np.random.RandomState(0)
    for n, groups, batch in ((10, 2, 2), (37, 5, 4), (64, 7, 2), (9, 1, 3)):
        order = rng.permutation(n).tolist()
        ids = rng.randint(0, groups, n).tolist()
        jb = list(jgba.GroupedBatchSampler(order, ids, batch))
        pb = list(pgba.GroupedBatchSampler(order, ids, batch))
        assert pb == jb and len(pb) == len(pgba.GroupedBatchSampler(order, ids, batch))


def test_voc_segmentation_equals_jax(tree):
    """The masks (palette indices, 255 borders) exactly, the images within
    the decoder's bound; every class in val."""
    root, info = tree
    for split in ("train", "val"):
        j = jd.VOCSegmentation(str(root), image_set=split)
        p = pd.VOCSegmentation(str(root), image_set=split)
        assert p.images == j.images and p.targets == j.targets
        for i in range(len(p)):
            (ji, jm), (pi, pm) = j[i], p[i]
            assert pm.dtype == torch.uint8 and (pm == 255).any()
            np.testing.assert_array_equal(pm.numpy(), jm)
            assert np.abs(hwc(pi).astype(int) - np.asarray(ji).astype(int)).max() <= JPEG_TOL
    assert info["voc"]["val"]["classes"] == list(range(21))


def test_voc_detection_equals_jax(tree):
    root, _ = tree
    j = jd.VOCDetection(str(root), image_set="train")
    p = pd.VOCDetection(str(root), image_set="train")
    for i in range(len(p)):
        assert p[i][1] == j[i][1]
    ann = p[0][1]["annotation"]
    assert ann["size"]["depth"] == "3" and isinstance(ann["object"], list)
    with pytest.raises(ValueError):
        pd.VOCDetection(str(root), image_set="test")


def test_segmentation_coco_utils_equal_jax(tree):
    """COCO as VOC: the category filter and remap, the merged class map
    (255 where instances overlap), the >1,000-pixel filter."""
    root, _ = tree
    j = jscu.get_coco(str(root), "train")
    p = pscu.get_coco(str(root), "train")
    assert p.ids == j.ids and len(p) > 0
    differ = 0
    for i in range(len(p)):
        (_, jt), (_, pt) = j[i], p[i]
        assert pt.dtype == torch.uint8
        differ += int((pt.numpy() != jt).sum())
    assert differ <= MAX_OUTLINE_PIXELS
    anno = p.base._load_target(p.ids[0])
    _, ja = jscu.FilterAndRemapCocoCategories(jscu.CAT_LIST)(None, anno)
    _, pa = pscu.FilterAndRemapCocoCategories(pscu.CAT_LIST)(None, anno)
    assert pa == ja
    _, jn = jscu.FilterAndRemapCocoCategories(jscu.CAT_LIST, remap=False)(None, anno)
    _, pn = pscu.FilterAndRemapCocoCategories(pscu.CAT_LIST, remap=False)(None, anno)
    assert pn == jn
    assert (pscu.coco_remove_images_without_annotations(p.base, pscu.CAT_LIST)
            == jscu.coco_remove_images_without_annotations(j.base, jscu.CAT_LIST))
