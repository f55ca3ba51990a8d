"""The port's COCO box evaluator
(``vision_tpu_torch/references/detection/coco_eval.py``) against the
repo's ``references/detection/coco_eval.py`` on the CPU: random detections
over 20 images within 1e-12 of every metric, and the cases of
``tests/test_coco_eval_semantics.py`` (each a rule of ``pycocotools``'
COCOeval) run against the port, one parametrised test."""

import inspect

import numpy as np
import pytest

import test_coco_eval_semantics as semantics
from vision_tpu_torch.references.detection import coco_eval as pce
from torch_refs_cases import load_reference

jce = load_reference("detection", "coco_eval")

CASES = sorted(name for name, fn in inspect.getmembers(semantics, inspect.isfunction)
               if name.startswith("test_"))


def random_case(seed, images=20, classes=6):
    """Ground truths (some crowd, every area bucket) and detections (near
    copies, duplicates, false positives, score ties) over ``images``."""
    rng = np.random.RandomState(seed)
    gts, preds = {}, {}
    for i in range(images):
        n = rng.randint(0, 8)
        xy = rng.uniform(0, 400, (n, 2))
        wh = np.exp(rng.uniform(np.log(8), np.log(200), (n, 2)))
        boxes = np.concatenate([xy, xy + wh], 1)
        labels = rng.randint(1, classes + 1, n)
        gts[i] = {"boxes": boxes, "labels": labels,
                  "iscrowd": (rng.rand(n) < 0.1).astype(np.int64)}
        jitter = boxes + rng.normal(0, 1, boxes.shape) * wh.repeat(2, 1) * 0.08
        hit = rng.rand(n) < 0.8
        extra = rng.randint(0, 6)
        fp_xy = rng.uniform(0, 400, (extra, 2))
        fp = np.concatenate([fp_xy, fp_xy + rng.uniform(10, 120, (extra, 2))], 1)
        k = rng.randint(0, n + 1)
        d_boxes = np.concatenate([jitter[hit], fp, jitter[:k]])
        d_labels = np.concatenate([labels[hit], rng.randint(1, classes + 1, extra),
                                   labels[:k]])
        wrong = rng.rand(len(d_labels)) < 0.1
        d_labels = np.where(wrong, rng.randint(1, classes + 1, len(d_labels)), d_labels)
        scores = np.round(rng.rand(len(d_boxes)), 2)  # ties
        if rng.rand() < 0.9:
            preds[i] = {"boxes": d_boxes, "scores": scores, "labels": d_labels}
    return preds, gts


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("max_dets", [100, 3])
def test_coco_map_matches_jax_on_random_detections(seed, max_dets):
    preds, gts = random_case(seed)
    got = pce.coco_map(preds, gts, max_dets=max_dets)
    want = jce.coco_map(preds, gts, max_dets=max_dets)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    assert 0.0 < want["map"] < 1.0


@pytest.mark.parametrize("case", CASES)
def test_coco_eval_semantics_hold_for_the_port(case, monkeypatch):
    """Each JAX case, with the module's ``coco_map`` and ``CocoEvaluator``
    the port's."""
    monkeypatch.setattr(semantics, "coco_map", pce.coco_map)
    monkeypatch.setattr(semantics, "CocoEvaluator", pce.CocoEvaluator)
    getattr(semantics, case)()


def test_evaluator_reads_one_on_its_ground_truths():
    """The ground truths fed back as detections (crowds at a lower score)
    read mAP 1.0, with the JAX evaluator's numbers."""
    _, gts = random_case(7)
    preds = {i: {"boxes": g["boxes"], "labels": g["labels"],
                 "scores": np.where(g["iscrowd"] > 0, 0.5, 1.0)}
             for i, g in gts.items()}
    ev = pce.CocoEvaluator(gts)
    ev.update(dict(list(preds.items())[:10]))
    ev.merge([dict(list(preds.items())[10:])])
    got = ev.summarize()
    assert got["map"] == 1.0 and got == jce.coco_map(preds, gts)
