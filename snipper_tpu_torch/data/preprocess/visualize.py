"""Preprocessing debug visualization: renders preprocessed annotations
back onto frames so that a dataset's extraction can be checked by eye.

The port's own copy of ``snipper_tpu/data/preprocess/visualize.py``
(reference ``datasets/data_preprocess/dataset_util.py``:
``panoptic_visualization`` :6-63, ``posetrack_visualization`` :64-180, and
the JTA ``Pose``/``Joint`` classes :183-420 whose JOINT15 naming and limbs
live in ``data/skeleton.py``). cv2-free: drawing reuses the PIL primitives
of ``infer/visualize.py``; PIL and matplotlib are imported when a render
runs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from snipper_tpu_torch.data.skeleton import \
    SKELETON_EDGES  # noqa: F401 (re-export)
from snipper_tpu_torch.infer.visualize import (_rgb255, draw_skeleton_2d,
                                               pid_palette)

# JOINT15 names (reference dataset_util.py:215-230 JTA keypoint listing,
# remapped to the common set of hybrid_dataloader.py:15-44)
JOINT15_NAMES = [
    "root", "nose/head_top", "neck", "left_shoulder", "right_shoulder",
    "left_elbow", "right_elbow", "left_wrist", "right_wrist", "left_hip",
    "right_hip", "left_knee", "right_knee", "left_ankle", "right_ankle",
]


def render_annotation_frame(
    img: np.ndarray,
    kpts2d: np.ndarray,
    track_ids: Sequence[int],
    save_path: Optional[str] = None,
    all_pids: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Draw one frame's preprocessed annotations (reference
    ``panoptic_visualization``, dataset_util.py:6-63).

    Args:
      img: ``[H, W, 3]`` uint8 RGB.
      kpts2d: ``[n_persons, 15, 3]`` (x, y, vis).
      track_ids: per-person ids; colors are stable per id.
      all_pids: optional full id universe for a stable palette across frames
        (defaults to the ids present in this frame).
    """
    pids = sorted(set(all_pids if all_pids is not None else track_ids))
    colors = pid_palette(max(len(pids), 1))
    out = np.ascontiguousarray(img)
    for person, pid in zip(np.asarray(kpts2d), track_ids):
        color = _rgb255(colors[pids.index(pid) % len(colors)])
        out = draw_skeleton_2d(out, person, color, pid=int(pid))
    if save_path:
        from PIL import Image

        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        Image.fromarray(out).save(save_path)
    return out


def render_sequence(
    frames: List[Dict],
    images_root: str,
    save_dir: str,
    name: str = "seq",
    max_frames: int = 0,
) -> List[str]:
    """Render a preprocessed sequence's frames (reference
    ``posetrack_visualization``, dataset_util.py:64-180).

    ``frames``: list of per-frame records as produced by the preprocess
    extractors — dicts with ``filename`` (or ``image``), ``kpts2d``
    ``[n, 15, 3]``, and ``track_ids``. Returns the written paths.
    """
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    def _ids(fr, default=()):
        # posetrack extractor records store ids under 'track_id'
        # (preprocess/posetrack.py), jta/mupots under 'track_ids'
        return np.atleast_1d(fr.get("track_ids", fr.get("track_id", default)))

    # records without ids number their people in each frame; the palette
    # then follows each frame's own ids (the JAX package raises there)
    all_pids = sorted({int(t) for fr in frames for t in _ids(fr, [])}) \
        or None
    written = []
    for i, fr in enumerate(frames):
        if max_frames and i >= max_frames:
            break
        fname = fr.get("filename") or fr.get("image")
        img = np.asarray(Image.open(os.path.join(images_root, fname))
                         .convert("RGB"))
        kpts = np.asarray(fr.get("kpts2d", np.zeros((0, 15, 3))))
        if kpts.ndim == 3 and kpts.shape[1] == 18:
            # posetrack extractor records are [root + posetrack17] order
            # (preprocess/posetrack.py add_root_joint); remap to JOINT15 so
            # SKELETON_EDGES connect the right limbs
            from snipper_tpu_torch.data.skeleton import POSETRACK_TO_JOINT15

            kpts = kpts[:, POSETRACK_TO_JOINT15, :]
        tids = _ids(fr, np.arange(len(kpts)))
        path = os.path.join(save_dir, f"{name}_{i:08d}.jpg")
        render_annotation_frame(img, kpts, [int(t) for t in tids], path,
                                all_pids=all_pids)
        written.append(path)
    return written
