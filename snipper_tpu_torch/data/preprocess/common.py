"""Shared preprocessing helpers (the port's own copy of
``snipper_tpu/data/preprocess/common.py``)."""

from __future__ import annotations

import numpy as np


def image_size(path: str):
    """(height, width) without decoding the full image."""
    from PIL import Image

    with Image.open(path) as im:
        return im.height, im.width


def add_root_joint(kpts: np.ndarray, lhip: int, rhip: int) -> np.ndarray:
    """Prepend the pelvis midpoint as joint 0; visibility = lhip*rhip
    (reference posetrack.py:116-119, mscoco.py:95-97)."""
    root = (kpts[lhip:lhip + 1] + kpts[rhip:rhip + 1]) * 0.5
    root[:, 2] = kpts[lhip, 2] * kpts[rhip, 2]
    return np.concatenate([root, kpts], axis=0)
