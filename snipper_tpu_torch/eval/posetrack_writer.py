"""PoseTrack18 result writer.

Counterpart of reference ``HybridData.write_val_results``
(``datasets/hybrid_dataloader.py:1789-1869``): per video, aggregate the
per-snippet matched predictions per frame (score-weighted average over
overlapping snippets), map JOINT15 -> the 18-joint PoseTrack layout, and
emit one JSON per video in the poseval-compatible schema. The port's own
copy of ``snipper_tpu/eval/posetrack_writer.py``.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, List

import numpy as np

from snipper_tpu_torch.data.skeleton import JOINT15_TO_POSETRACK
from snipper_tpu_torch.eval.metrics import transform_pts


def collect_posetrack_results(results: List[Dict], seq_len: int
                              ) -> Dict[str, List[Dict]]:
    """PostProcess results -> per-video frame entries (the bridge the
    reference builds in ``engine.py:354-443``): predictions are gathered at
    the criterion match indices so each GT trajectory has one prediction."""
    by_video: Dict[str, List[Dict]] = collections.defaultdict(list)
    for res in results:
        if res.get("dataset") != "posetrack":
            continue
        src_idx, tgt_idx = res["indices"]
        inv = res["inv_trans"]
        traj_ids = np.asarray(res["gt_traj_ids"])
        kpts = np.asarray(res["pred_kpts"])[src_idx]        # [m, T, K, 2]
        scores = np.asarray(res["pred_kpt_scores"])[src_idx]
        kpts = transform_pts(kpts, inv)
        for t in range(min(seq_len, kpts.shape[1])):
            by_video[res["video_name"]].append({
                "video_name": res["video_name"],
                "filename": res["filenames"][t],
                "traj_ids": traj_ids[tgt_idx],
                "pred_kpts": kpts[:, t],                    # [m, K, 2]
                "pred_kpt_scores": scores[:, t],            # [m, K, 1]
            })
    return by_video


def write_val_results(by_video: Dict[str, List[Dict]], posetrack_data: Dict,
                      output_dir: str):
    """``posetrack_data``: the val pickle (with 'categories' and per-video
    frame records carrying COCO-style 'info')."""
    os.makedirs(output_dir, exist_ok=True)
    categories = posetrack_data.get("categories", [])
    for video_name, entries in by_video.items():
        # filename -> traj_id -> [K, 3] predictions from each overlapping
        # snippet. The reference stacks positionally and takes the FIRST
        # snippet's traj_ids (hybrid_dataloader.py:1830-1833), which is
        # sound only under its invariant that every snippet of a video
        # carries the identical ordered person set; aligning by traj id
        # gives the same score-weighted average there and stays correct
        # when snippets observe different person subsets.
        tmp = collections.defaultdict(lambda: collections.defaultdict(list))
        for e in entries:
            k = np.concatenate([e["pred_kpts"], e["pred_kpt_scores"]], -1)
            for i, pid in enumerate(np.asarray(e["traj_ids"]).tolist()):
                tmp[e["filename"]][int(pid)].append(k[i])

        saved = {"categories": categories, "images": [], "annotations": []}
        for datum in posetrack_data[video_name]:
            info = datum.get("info", {"id": 0})
            saved["images"].append(info)
            fn = datum["filename"]
            if fn not in tmp:
                continue
            for pid in sorted(tmp[fn]):
                stack = np.stack(tmp[fn][pid])              # [l, K, 3]
                score = stack[:, :, 2:3].mean(0)
                ssum = stack[:, :, 2:3].sum(0)
                k = (stack[:, :, 0:2] * stack[:, :, 2:3]).sum(0) / (
                    ssum + (ssum == 0))
                pred = np.concatenate([k, score], -1)       # [K, 3]
                pt18 = np.zeros((18, 3))
                pt18[JOINT15_TO_POSETRACK] = pred
                saved["annotations"].append({
                    "bbox_head": [0, 0, 0, 0],
                    "keypoints": pt18[1:].reshape(-1).tolist(),
                    "track_id": int(pid),
                    "image_id": info.get("id", 0),
                    "bbox": [0, 0, 0, 0],
                    "scores": [],
                    "category_id": 1,
                    "id": info.get("id", 0),
                })
        out = os.path.join(output_dir, video_name)
        with open(out, "w") as f:
            json.dump(saved, f)
        print(out, flush=True)
