"""COCO keypoint result writer + OKS-based AP evaluation.

Counterpart of reference ``write_val_results_coco`` / ``eval_coco_val_results``
(``datasets/hybrid_dataloader.py:1876-1915``), which delegate scoring to
pycocotools ``COCOeval(..., 'keypoints')``. pycocotools is not a
dependency, so this module re-implements COCOeval's keypoint protocol
faithfully and self-contained:

- OKS with the 17-keypoint sigmas (``e = d^2 / (2 * area * (2*sigma)^2)``),
  including the bbox-expanded fallback region for GTs with no labeled
  keypoints (cocoeval.py ``computeOks``).
- ignore semantics: ``iscrowd`` or ``num_keypoints == 0`` GTs are kept as
  *ignore regions* — detections matched to them are removed from scoring
  (neither TP nor FP), and crowd GTs may absorb multiple detections.
- greedy per-image matching by descending score that picks the BEST OKS
  match (not the first above threshold), never steals a matched non-crowd
  GT, and stops at ignore GTs once a real match exists
  (cocoeval.py ``evaluateImg``).
- ``maxDets`` truncation (20 for keypoints), area-range sweep
  (all / medium 32^2-96^2 / large 96^2-1e5^2), unmatched detections outside
  the area range ignored.
- accumulation with 101-point interpolated precision
  (``np.searchsorted(rec, recThrs, side='left')``) and AR = max recall,
  averaged over OKS thresholds 0.5:0.05:0.95 (cocoeval.py ``accumulate`` /
  ``summarize``).

The reference's writer also carries a known wart — it gates on a
``self.eval_coco`` attribute that is never set (``:1878``), which would
raise; that is intentionally not replicated.

The port's own copy of ``snipper_tpu/eval/coco_eval.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from snipper_tpu_torch.data.skeleton import JOINT15_TO_COCO

# standard COCO keypoint sigmas (17 kpts); k = 2*sigma per COCOeval
COCO_SIGMAS = np.array([
    .026, .025, .025, .035, .035, .079, .079, .072, .072, .062, .062,
    .107, .107, .087, .087, .089, .089]) * 2

OKS_THRESHOLDS = np.arange(0.5, 0.955, 0.05)
REC_THRS = np.linspace(0.0, 1.0, 101)

AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 20


def write_coco_results(results: Dict, output_dir: str) -> str:
    """``results``: {image_id: [(human_score [n], kpts2d [n, 15, 3]), ...]}
    -> COCO-format prediction JSON (17 keypoints, JOINT15 mapped through the
    19-joint intermediate as the reference does)."""
    os.makedirs(output_dir, exist_ok=True)
    anns = []
    for image_id, entries in results.items():
        human_score, kpts2d = entries[0][:2]
        for p in range(np.asarray(kpts2d).shape[0]):
            coco_kpt = np.zeros([19, 3])
            coco_kpt[JOINT15_TO_COCO] = np.asarray(kpts2d)[p]
            anns.append({
                "image_id": int(image_id),
                "category_id": 1,
                "keypoints": coco_kpt[2:].reshape(-1).tolist(),
                "score": float(np.asarray(human_score)[p]),
            })
    path = os.path.join(output_dir, "coco_val2017_predictions.json")
    with open(path, "w") as f:
        json.dump(anns, f)
    return path


def _dt_bbox_area(kpts: np.ndarray) -> Tuple[np.ndarray, float]:
    """Detection bbox/area from its keypoints, as pycocotools ``loadRes``
    computes them for keypoint results (coco.py loadRes)."""
    x, y = kpts[:, 0], kpts[:, 1]
    x0, x1, y0, y1 = x.min(), x.max(), y.min(), y.max()
    return np.array([x0, y0, x1 - x0, y1 - y0]), float((x1 - x0) * (y1 - y0))


def compute_oks(gt: dict, dt_kpts: np.ndarray,
                sigmas: np.ndarray = COCO_SIGMAS) -> float:
    """OKS between one GT annotation dict and one detection ``[K, 3]``
    (cocoeval.py ``computeOks``, including the k1==0 bbox fallback)."""
    g = np.asarray(gt["keypoints"], np.float64).reshape(-1, 3)
    xg, yg, vg = g[:, 0], g[:, 1], g[:, 2]
    xd, yd = dt_kpts[:, 0], dt_kpts[:, 1]
    k1 = int((vg > 0).sum())
    if k1 > 0:
        dx = xd - xg
        dy = yd - yg
    else:
        # no labeled keypoints: measure distance to the doubled bbox region
        x0, y0, w, h = np.asarray(gt["bbox"], np.float64)
        z = np.zeros_like(xd)
        dx = np.maximum(z, (x0 - w) - xd) + np.maximum(z, xd - (x0 + 2 * w))
        dy = np.maximum(z, (y0 - h) - yd) + np.maximum(z, yd - (y0 + 2 * h))
    var = sigmas ** 2
    e = (dx ** 2 + dy ** 2) / var / (gt.get("area", 1e9) + np.spacing(1)) / 2
    if k1 > 0:
        e = e[vg > 0]
    return float(np.sum(np.exp(-e)) / e.shape[0])


def _gt_ignore(g: dict) -> bool:
    return bool(g.get("ignore", 0)) or bool(g.get("iscrowd", 0)) \
        or int(g.get("num_keypoints", 1)) == 0


def _evaluate_img(gts: List[dict], dts: List[dict], area_rng, max_dets: int):
    """Single-image/threshold-sweep matching (cocoeval.py ``evaluateImg``).

    Returns ``(dt_scores, dtm [T, D], dt_ig [T, D], n_gt)`` for the non-
    ignore GT count within ``area_rng``.
    """
    if not gts and not dts:
        return np.zeros(0), np.zeros((len(OKS_THRESHOLDS), 0)), \
            np.zeros((len(OKS_THRESHOLDS), 0), bool), 0
    # pycocotools ignores area < lo OR area > hi — both bounds INCLUSIVE
    # (cocoeval.py evaluateImg), so e.g. area == 96^2 counts in both the
    # medium and large ranges
    gt_ig = np.array([
        1 if (_gt_ignore(g) or not (area_rng[0] <= g.get("area", 1e9)
                                    <= area_rng[1]))
        else 0 for g in gts])
    # sort: non-ignore GTs first (stable), as COCOeval does
    gorder = np.argsort(gt_ig, kind="stable")
    gts = [gts[i] for i in gorder]
    gt_ig = gt_ig[gorder]
    iscrowd = [int(g.get("iscrowd", 0)) for g in gts]

    dts = sorted(dts, key=lambda d: -d["score"])[:max_dets]
    dt_kpts = [np.asarray(d["keypoints"], np.float64).reshape(-1, 3)
               for d in dts]
    dt_areas = np.array([_dt_bbox_area(k)[1] for k in dt_kpts]) \
        if dts else np.zeros(0)

    ious = np.zeros((len(dts), len(gts)))
    for di, dk in enumerate(dt_kpts):
        for gi, g in enumerate(gts):
            ious[di, gi] = compute_oks(g, dk)

    T, D, G = len(OKS_THRESHOLDS), len(dts), len(gts)
    gtm = np.zeros((T, G))
    dtm = np.zeros((T, D))
    dt_ig = np.zeros((T, D), bool)
    for ti, t in enumerate(OKS_THRESHOLDS):
        for di in range(D):
            iou = min(t, 1 - 1e-10)
            m = -1
            for gi in range(G):
                if gtm[ti, gi] > 0 and not iscrowd[gi]:
                    continue
                # reached ignore GTs with a real match in hand: stop
                if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                    break
                if ious[di, gi] < iou:
                    continue
                iou = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dt_ig[ti, di] = bool(gt_ig[m])
            dtm[ti, di] = 1 + m
            gtm[ti, m] = 1 + di
    # unmatched detections outside the area range are ignored too
    a_out = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1])
    dt_ig = dt_ig | ((dtm == 0) & a_out[None, :])
    return (np.array([d["score"] for d in dts]), dtm, dt_ig,
            int((gt_ig == 0).sum()))


def _accumulate(per_img: List[tuple]) -> Dict[str, float]:
    """Precision/recall accumulation (cocoeval.py ``accumulate``)."""
    n_gt = sum(r[3] for r in per_img)
    if n_gt == 0:
        return {"AP": -1.0, "AP50": -1.0, "AP75": -1.0, "AR": -1.0}
    scores = np.concatenate([r[0] for r in per_img]) if per_img else \
        np.zeros(0)
    order = np.argsort(-scores, kind="mergesort")
    aps, ars = [], []
    for ti in range(len(OKS_THRESHOLDS)):
        dtm = np.concatenate([r[1][ti] for r in per_img])[order]
        dt_ig = np.concatenate([r[2][ti] for r in per_img])[order]
        tp = (dtm > 0) & ~dt_ig
        fp = (dtm == 0) & ~dt_ig
        ctp = np.cumsum(tp).astype(np.float64)
        cfp = np.cumsum(fp).astype(np.float64)
        rec = ctp / n_gt
        prec = ctp / np.maximum(ctp + cfp, np.spacing(1))
        # precision envelope + 101-point interpolation
        for i in range(len(prec) - 1, 0, -1):
            if prec[i] > prec[i - 1]:
                prec[i - 1] = prec[i]
        inds = np.searchsorted(rec, REC_THRS, side="left")
        q = np.zeros(len(REC_THRS))
        valid = inds < len(prec)
        q[valid] = prec[inds[valid]]
        aps.append(q.mean())
        ars.append(rec[-1] if len(rec) else 0.0)
    return {"AP": float(np.mean(aps)), "AP50": float(aps[0]),
            "AP75": float(aps[5]), "AR": float(np.mean(ars))}


def evaluate_coco_keypoints(gt_json_path: str, pred_json_path: str,
                            max_dets: int = MAX_DETS) -> Dict[str, float]:
    """COCOeval-keypoints metrics: AP/AP50/AP75/AP_medium/AP_large and
    AR/AR_medium/AR_large at ``maxDets`` (the keypoint summarize table,
    cocoeval.py ``summarize`` kp branch)."""
    with open(gt_json_path) as f:
        gt = json.load(f)
    with open(pred_json_path) as f:
        preds = json.load(f)

    gts_by_img: Dict[int, list] = {}
    img_ids = set()
    for img in gt.get("images", []):
        img_ids.add(img["id"])
    for a in gt.get("annotations", []):
        gts_by_img.setdefault(a["image_id"], []).append(a)
        img_ids.add(a["image_id"])
    dts_by_img: Dict[int, list] = {}
    for d in preds:
        dts_by_img.setdefault(d["image_id"], []).append(d)
        img_ids.add(d["image_id"])

    out: Dict[str, float] = {}
    for aname, arng in AREA_RANGES.items():
        per_img = [
            _evaluate_img(gts_by_img.get(i, []), dts_by_img.get(i, []),
                          arng, max_dets)
            for i in sorted(img_ids)
        ]
        m = _accumulate(per_img)
        if aname == "all":
            out.update(m)
        else:
            out[f"AP_{aname}"] = m["AP"]
            out[f"AR_{aname}"] = m["AR"]
    return out
