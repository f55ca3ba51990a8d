"""The detection engine (the port's copy of the repo's
``references/detection/engine.py``; reference ``engine.py``:
``train_one_epoch`` :12, ``evaluate`` :76): an epoch of
``parallel.make_detection_train_step``'s steps, and the COCO evaluation of
a detector's detections through ``CocoEvaluator``."""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from vision_tpu_torch.references.classification import utils
from vision_tpu_torch.references.detection.coco_eval import CocoEvaluator

__all__ = ["evaluate_detection", "train_one_epoch"]


def train_one_epoch(step_fn: Callable, data_loader: Iterable, generator,
                    epoch: int, print_freq: int = 10, lr_scheduler=None,
                    hooks: Optional[Dict[str, Callable]] = None
                    ) -> List[dict]:
    """reference ``engine.py:12``: ``step_fn(batch, generator)`` on every
    batch, the loss read back after each (a non-finite loss ends the run,
    as the reference's ``sys.exit(1)``), ``lr_scheduler.step()`` after
    each. ``hooks["before_first"](batch, generator)`` and
    ``hooks["after_first"]()`` run around the first step. Returns each step's ``{"losses", "ms"}``,
    ``ms`` the wall time of the step and its read-back."""
    hooks = hooks or {}
    logger = utils.MetricLogger()
    records = []
    for i, batch in enumerate(logger.log_every(data_loader, print_freq,
                                               f"Epoch: [{epoch}]")):
        if i == 0 and "before_first" in hooks:
            hooks["before_first"](batch, generator)
        t0 = time.perf_counter()
        losses = step_fn(batch, generator)
        values = {k: float(v) for k, v in losses.items()}
        ms = (time.perf_counter() - t0) * 1e3
        if i == 0 and "after_first" in hooks:
            hooks["after_first"]()
        if not math.isfinite(values["loss"]):
            print(f"Loss is {values['loss']}, stopping training")
            sys.exit(1)
        logger.update(**values)
        records.append({"losses": values, "ms": ms})
        if lr_scheduler is not None:
            lr_scheduler.step()
    return records


def evaluate_detection(model: Callable, data_loader: Iterable,
                       ground_truths: Dict[int, dict],
                       postprocess: Optional[Callable] = None
                       ) -> Dict[str, float]:
    """reference ``engine.py:76``: each batch ``(image ids, canvas, image
    sizes, original sizes)`` through ``model`` (-> ``Detections``), each
    image's valid rows to the host, its boxes through ``postprocess(boxes,
    image size, original size)``, into ``CocoEvaluator``; its summary."""
    evaluator = CocoEvaluator(ground_truths)
    logger = utils.MetricLogger()
    for img_ids, batch, image_sizes, original_sizes in logger.log_every(
            data_loader, 10, "Test:"):
        dets = model(batch)
        boxes, scores, labels, valid = (t.cpu() for t in (
            dets.boxes.float(), dets.scores.float(), dets.labels, dets.valid))
        preds = {}
        for i, img_id in enumerate(img_ids):
            keep = valid[i]
            b = boxes[i][keep]
            if postprocess is not None:
                b = postprocess(b, image_sizes[i], original_sizes[i])
            preds[img_id] = {"boxes": np.asarray(b), "scores": scores[i][keep].numpy(),
                             "labels": labels[i][keep].numpy()}
        evaluator.update(preds)
    return evaluator.summarize()
