"""COCO box evaluation (the port's copy of the repo's
``references/detection/coco_eval.py``, whose reference wraps
``pycocotools``): the COCOeval bbox protocol in numpy, on the host. Ten
IoU thresholds .5:.05:.95, 101-point interpolated precision, the area
buckets by box area, ``max_dets`` a class and image; a crowd ground truth
matches any number of detections at the intersection over the
detection's area, and what matches it is ignored."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

__all__ = ["CocoEvaluator", "coco_map"]

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU for xywh boxes; crowd gt uses intersection/det_area
    (pycocotools semantics)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1[None])
    iy1 = np.maximum(dy1[:, None], gy1[None])
    ix2 = np.minimum(dx2[:, None], gx2[None])
    iy2 = np.minimum(dy2[:, None], gy2[None])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    d_area = dets[:, 2] * dets[:, 3]
    g_area = gts[:, 2] * gts[:, 3]
    union = d_area[:, None] + g_area[None] - inter
    union = np.where(iscrowd[None, :], d_area[:, None], union)
    return np.where(union > 0, inter / union, 0.0)


def _evaluate_img(dets, det_scores, gts, gt_crowd, area_rng, max_dets):
    """Match detections to gts for one (image, category); returns per-IoU
    match arrays + gt ignore flags (pycocotools evaluateImg)."""
    g_area = gts[:, 2] * gts[:, 3] if len(gts) else np.zeros(0)
    gt_ignore = gt_crowd | (g_area < area_rng[0]) | (g_area > area_rng[1])
    order_g = np.argsort(gt_ignore, kind="stable")  # non-ignored first
    gts = gts[order_g]
    gt_ignore = gt_ignore[order_g]
    gt_crowd_s = gt_crowd[order_g]

    order_d = np.argsort(-det_scores, kind="stable")[:max_dets]
    dets = dets[order_d]
    det_scores = det_scores[order_d]

    ious = _iou_xywh(dets, gts, gt_crowd_s)
    T, D, G = len(IOU_THRS), len(dets), len(gts)
    det_match = np.zeros((T, D), dtype=np.int64) - 1
    det_ignore = np.zeros((T, D), dtype=bool)
    gt_match = np.zeros((T, G), dtype=np.int64) - 1
    for ti, t in enumerate(IOU_THRS):
        for di in range(D):
            best_iou = min(t, 1 - 1e-10)
            best_g = -1
            for gi in range(G):
                if gt_match[ti, gi] >= 0 and not gt_crowd_s[gi]:
                    continue
                # non-ignored gts sorted first; stop upgrading to ignored
                # gt once matched to a non-ignored one
                if best_g >= 0 and not gt_ignore[best_g] and gt_ignore[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best_g = gi
            if best_g >= 0:
                det_match[ti, di] = best_g
                det_ignore[ti, di] = gt_ignore[best_g]
                gt_match[ti, best_g] = di
    # unmatched dets outside the area range are ignored
    d_area = dets[:, 2] * dets[:, 3] if D else np.zeros(0)
    d_out = (d_area < area_rng[0]) | (d_area > area_rng[1])
    det_ignore |= (det_match == -1) & d_out[None, :]
    return det_match, det_ignore, det_scores, gt_ignore


def coco_map(
    predictions: Dict[int, dict],
    ground_truths: Dict[int, dict],
    max_dets: int = 100,
) -> Dict[str, float]:
    """Compute COCO bbox AP.

    predictions[img_id] = {"boxes": [N,4] xyxy, "scores": [N], "labels": [N]}
    ground_truths[img_id] = {"boxes": [M,4] xyxy, "labels": [M],
                             "iscrowd": [M] optional}
    Returns {"map", "map_50", "map_75", "map_small", "map_medium",
             "map_large"}.
    """
    cats = set()
    for gt in ground_truths.values():
        cats.update(np.asarray(gt["labels"]).tolist())
    cats = sorted(cats)

    def to_xywh(b):
        b = np.asarray(b, np.float64).reshape(-1, 4)
        return np.stack(
            [b[:, 0], b[:, 1], b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1
        )

    results = {}
    for area_name, area_rng in AREA_RNG.items():
        ap_per_cat = []
        ap50_per_cat = []
        ap75_per_cat = []
        for cat in cats:
            matches, ignores, scores, n_gt = [], [], [], 0
            for img_id, gt in ground_truths.items():
                g_lbl = np.asarray(gt["labels"])
                g_sel = g_lbl == cat
                g_boxes = to_xywh(gt["boxes"])[g_sel]
                g_crowd = np.asarray(
                    gt.get("iscrowd", np.zeros(len(g_lbl)))
                ).astype(bool)[g_sel]
                pred = predictions.get(img_id, None)
                if pred is None:
                    d_boxes = np.zeros((0, 4))
                    d_scores = np.zeros(0)
                else:
                    p_lbl = np.asarray(pred["labels"])
                    p_sel = p_lbl == cat
                    d_boxes = to_xywh(pred["boxes"])[p_sel]
                    d_scores = np.asarray(pred["scores"])[p_sel]
                if len(g_boxes) == 0 and len(d_boxes) == 0:
                    continue
                dm, dig, ds, gig = _evaluate_img(
                    d_boxes, d_scores, g_boxes, g_crowd, area_rng, max_dets
                )
                matches.append(dm)
                ignores.append(dig)
                scores.append(ds)
                n_gt += int((~gig).sum())
            if n_gt == 0:
                continue
            if matches:
                dm = np.concatenate(matches, axis=1)
                dig = np.concatenate(ignores, axis=1)
                ds = np.concatenate(scores)
            else:
                dm = np.zeros((len(IOU_THRS), 0), np.int64)
                dig = np.zeros((len(IOU_THRS), 0), bool)
                ds = np.zeros(0)
            order = np.argsort(-ds, kind="mergesort")
            dm, dig = dm[:, order], dig[:, order]

            tps = (dm >= 0) & ~dig
            fps = (dm < 0) & ~dig
            tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
            ap_t = np.zeros(len(IOU_THRS))
            for ti in range(len(IOU_THRS)):
                tp, fp = tp_cum[ti], fp_cum[ti]
                rc = tp / n_gt
                pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                # monotone precision envelope
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                # 101-point interpolation
                idx = np.searchsorted(rc, REC_THRS, side="left")
                q = np.zeros(len(REC_THRS))
                valid = idx < len(pr)
                q[valid] = pr[idx[valid]]
                ap_t[ti] = q.mean()
            ap_per_cat.append(ap_t.mean())
            ap50_per_cat.append(ap_t[0])
            ap75_per_cat.append(ap_t[5])
        key = "map" if area_name == "all" else f"map_{area_name}"
        results[key] = float(np.mean(ap_per_cat)) if ap_per_cat else -1.0
        if area_name == "all":
            results["map_50"] = float(np.mean(ap50_per_cat)) if ap50_per_cat else -1.0
            results["map_75"] = float(np.mean(ap75_per_cat)) if ap75_per_cat else -1.0
    return results


class CocoEvaluator:
    """Accumulating evaluator (reference ``coco_eval.py:13``): feed
    per-image predictions, summarize at the end. Cross-host merge happens
    by gathering per-host predictions (the reference's all_gather merge,
    :157-189) before ``summarize``."""

    def __init__(self, ground_truths: Dict[int, dict]):
        self.ground_truths = ground_truths
        self.predictions: Dict[int, dict] = {}

    def update(self, predictions: Dict[int, dict]):
        self.predictions.update(predictions)

    def merge(self, other_predictions: Sequence[Dict[int, dict]]):
        for p in other_predictions:
            self.predictions.update(p)

    def summarize(self) -> Dict[str, float]:
        res = coco_map(self.predictions, self.ground_truths)
        print(
            " Average Precision (AP) @[ IoU=0.50:0.95 ] = {:.3f}\n"
            " Average Precision (AP) @[ IoU=0.50      ] = {:.3f}\n"
            " Average Precision (AP) @[ IoU=0.75      ] = {:.3f}".format(
                res["map"], res["map_50"], res["map_75"]
            )
        )
        return res
