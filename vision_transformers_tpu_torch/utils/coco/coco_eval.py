"""COCO-style detection evaluation (pycocotools-free), numpy only.

The port's own copy of ``vision_transformers_tpu/utils/coco/coco_eval.py``
(that module imports no JAX, but the port imports nothing of the JAX
package): the standard COCOeval bbox protocol — greedy score-ordered
matching per (image, category) at IoU thresholds 0.50:0.05:0.95, 101-point
interpolated precision, AP / AP50 / AP75 / AP_small/medium/large and
AR@{1,10,100}.

Inputs are plain dicts (no pycocotools types):
- ground truth: {image_id: {"boxes": (N,4) xyxy abs, "labels": (N,),
  optional "iscrowd": (N,)}} — crowd GTs are ignored (never TP/FP), may
  absorb multiple detections, and use intersection-over-detection-area IoU
  (pycocotools crowd semantics).
- predictions: {image_id: {"boxes": (M,4) xyxy abs, "labels": (M,),
  "scores": (M,)}}
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32 ** 2),
    "medium": (32 ** 2, 96 ** 2),
    "large": (96 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_matrix(pred: np.ndarray, gt: np.ndarray,
                gt_iscrowd: np.ndarray = None) -> np.ndarray:
    if len(pred) == 0 or len(gt) == 0:
        return np.zeros((len(pred), len(gt)))
    px0, py0, px1, py1 = pred.T
    gx0, gy0, gx1, gy1 = gt.T
    ix0 = np.maximum(px0[:, None], gx0[None])
    iy0 = np.maximum(py0[:, None], gy0[None])
    ix1 = np.minimum(px1[:, None], gx1[None])
    iy1 = np.minimum(py1[:, None], gy1[None])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
    pa = (px1 - px0) * (py1 - py0)
    ga = (gx1 - gx0) * (gy1 - gy0)
    union = pa[:, None] + ga[None] - inter
    if gt_iscrowd is not None and gt_iscrowd.any():
        # pycocotools crowd semantics: IoU against a crowd GT is
        # intersection over DETECTION area (maskUtils.iou iscrowd flag).
        union = np.where(gt_iscrowd[None, :], pa[:, None], union)
    return inter / np.maximum(union, 1e-9)


def _box_area(boxes: np.ndarray) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros(0)
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def _evaluate_img_cat(pred_boxes, pred_scores, gt_boxes, area_rng, max_det,
                      gt_iscrowd=None):
    """Greedy matching for one (image, category, area, maxdet) cell.

    Returns (tp (T, D) bool, scores (D,), n_gt) with D ≤ max_det; GTs
    outside the area range or marked iscrowd are 'ignored' — matches to
    them don't count as TP or FP (COCOeval semantics). A non-crowd GT
    matches at most one detection; only crowd GTs may absorb several."""
    order = np.argsort(-pred_scores, kind="stable")[:max_det]
    pred_boxes = pred_boxes[order]
    pred_scores = pred_scores[order]

    if gt_iscrowd is None:
        gt_iscrowd = np.zeros(len(gt_boxes), bool)
    else:
        gt_iscrowd = np.asarray(gt_iscrowd, bool)
    gt_area = _box_area(gt_boxes)
    # canonical bounds are CLOSED ([lo, hi], pycocotools evaluateImg uses
    # `a < lo or a > hi`): area == 32² counts as both small and medium
    gt_ignore = (
        (gt_area < area_rng[0]) | (gt_area > area_rng[1]) | gt_iscrowd
    )
    # sort GT: real first, ignored last (matching prefers real)
    gt_order = np.argsort(gt_ignore.astype(np.int8), kind="stable")
    gt_boxes = gt_boxes[gt_order]
    gt_ignore = gt_ignore[gt_order]
    gt_iscrowd = gt_iscrowd[gt_order]
    n_gt = int((~gt_ignore).sum())

    ious = _iou_matrix(pred_boxes, gt_boxes, gt_iscrowd)
    t_cnt = len(IOU_THRS)
    d_cnt = len(pred_boxes)
    tp = np.zeros((t_cnt, d_cnt), bool)
    ignored_det = np.zeros((t_cnt, d_cnt), bool)

    pred_area = _box_area(pred_boxes)
    det_out_of_range = (
        (pred_area < area_rng[0]) | (pred_area > area_rng[1])
    )

    for ti, thr in enumerate(IOU_THRS):
        taken = np.zeros(len(gt_boxes), bool)
        for di in range(d_cnt):
            best, best_iou = -1, thr
            for gi in range(len(gt_boxes)):
                if taken[gi] and not gt_iscrowd[gi]:
                    continue  # only crowd GTs may be re-matched
                if best >= 0 and gt_ignore[gi] and not gt_ignore[best]:
                    break  # already matched a real GT; ignored ones follow
                if ious[di, gi] >= best_iou:
                    best, best_iou = gi, ious[di, gi]
            if best >= 0:
                taken[best] = True
                if gt_ignore[best]:
                    ignored_det[ti, di] = True
                else:
                    tp[ti, di] = True
            elif det_out_of_range[di]:
                ignored_det[ti, di] = True  # unmatched out-of-range det

    return tp, ignored_det, pred_scores, n_gt


def evaluate_detections(groundtruths: Dict, predictions: Dict) -> Dict[str, float]:
    """COCO bbox metrics over {image_id: {...}} dicts."""
    cats = set()
    for g in groundtruths.values():
        cats.update(np.asarray(g["labels"]).tolist())
    cats = sorted(cats)

    stats = {}
    for area_name, area_rng in AREA_RANGES.items():
        for max_det in MAX_DETS:
            if area_name != "all" and max_det != 100:
                continue
            ap_per_cat, ar_per_cat = [], []
            for cat in cats:
                tps, igs, scores, total_gt = [], [], [], 0
                for img_id, gt in groundtruths.items():
                    g_mask = np.asarray(gt["labels"]) == cat
                    g_boxes = np.asarray(gt["boxes"], np.float64)[g_mask]
                    if "iscrowd" in gt:
                        g_crowd = np.asarray(gt["iscrowd"], bool)[g_mask]
                    else:
                        g_crowd = None
                    pred = predictions.get(img_id, None)
                    if pred is None:
                        p_boxes = np.zeros((0, 4))
                        p_scores = np.zeros(0)
                    else:
                        p_mask = np.asarray(pred["labels"]) == cat
                        p_boxes = np.asarray(pred["boxes"], np.float64)[p_mask]
                        p_scores = np.asarray(pred["scores"], np.float64)[p_mask]
                    tp, ig, sc, n_gt = _evaluate_img_cat(
                        p_boxes, p_scores, g_boxes, area_rng, max_det,
                        gt_iscrowd=g_crowd)
                    tps.append(tp)
                    igs.append(ig)
                    scores.append(sc)
                    total_gt += n_gt
                if total_gt == 0:
                    continue
                tp = np.concatenate(tps, axis=1)
                ig = np.concatenate(igs, axis=1)
                sc = np.concatenate(scores)
                order = np.argsort(-sc, kind="stable")
                tp, ig = tp[:, order], ig[:, order]

                aps, ars = [], []
                for ti in range(len(IOU_THRS)):
                    keep = ~ig[ti]
                    tpi = tp[ti][keep]
                    tp_cum = np.cumsum(tpi)
                    fp_cum = np.cumsum(~tpi)
                    recall = tp_cum / total_gt
                    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
                    # monotone precision envelope
                    for i in range(len(precision) - 1, 0, -1):
                        precision[i - 1] = max(precision[i - 1], precision[i])
                    # 101-point interpolation
                    if len(precision) == 0:
                        p_at = np.zeros_like(RECALL_THRS)
                    else:
                        idx = np.searchsorted(recall, RECALL_THRS, side="left")
                        p_at = np.where(
                            idx < len(precision),
                            precision[np.minimum(idx, len(precision) - 1)],
                            0.0)
                    aps.append(p_at.mean())
                    ars.append(recall[-1] if len(recall) else 0.0)
                ap_per_cat.append(aps)
                ar_per_cat.append(ars)

            if not ap_per_cat:
                continue
            ap = np.asarray(ap_per_cat)   # (C, T)
            ar = np.asarray(ar_per_cat)
            key = f"{area_name}@{max_det}"
            stats[key] = {
                "AP": float(ap.mean()),
                "AP50": float(ap[:, 0].mean()),
                "AP75": float(ap[:, 5].mean()),
                "AR": float(ar.mean()),
            }

    out = {
        "mAP": stats.get("all@100", {}).get("AP", 0.0),
        "AP50": stats.get("all@100", {}).get("AP50", 0.0),
        "AP75": stats.get("all@100", {}).get("AP75", 0.0),
        "AR@1": stats.get("all@1", {}).get("AR", 0.0),
        "AR@10": stats.get("all@10", {}).get("AR", 0.0),
        "AR@100": stats.get("all@100", {}).get("AR", 0.0),
        "AP_small": stats.get("small@100", {}).get("AP", 0.0),
        "AP_medium": stats.get("medium@100", {}).get("AP", 0.0),
        "AP_large": stats.get("large@100", {}).get("AP", 0.0),
    }
    return out
