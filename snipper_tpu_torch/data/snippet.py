"""Collation of snippet samples into a batch (the port's own copy of
``snipper_tpu/data/snippet.py::stack_batch`` for samples that carry
finished images; the raw-frame branch belongs to the device data path,
which is not ported yet)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def stack_batch(samples: List[Dict]) -> Dict:
    """Collate host samples into a batch dict of stacked numpy arrays:
    ``images [B, T, H, W, 3]`` and the padded ``targets`` (kpts2d, depth,
    valid); per-sample target dicts stay a list under ``meta``."""
    return {
        "images": np.stack([s["images"] for s in samples]),
        "targets": {
            k: np.stack([s["targets"][k] for s in samples])
            for k in ("kpts2d", "depth", "valid")
        },
        "meta": [s["targets"] for s in samples],
    }
