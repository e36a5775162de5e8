"""Decoding of model outputs to pixel/metric space (reference
``PostProcess``, ``models/model.py:548-615``); the port's own copy of
``snipper_tpu/infer/postprocess.py:21-43``."""

from __future__ import annotations

import numpy as np


def decode_predictions(logits: np.ndarray, kpts2d: np.ndarray,
                       depth: np.ndarray, max_depth: float, input_size):
    """Decode one sample's raw outputs: softmax human probability,
    ``joint = root + disp`` scaled to input pixels, ``joint_depth =
    (root + disp/max_depth) * max_depth`` in metres.

    Shapes: ``logits [n, T, 2]``, ``kpts2d [n, T, K, 3]``,
    ``depth [n, T, K, 1]``. Returns ``(human_prob [n, T], kpt_scores
    [n, T, K, 1], kpts_px [n, T, K, 2], depth_m [n, T, K, 1])``."""
    e = np.exp(logits - logits.max(-1, keepdims=True))
    human_prob = (e / e.sum(-1, keepdims=True))[..., 1]

    d = np.asarray(depth).copy()
    d[:, :, 1:] = d[:, :, 0:1] + d[:, :, 1:] / max_depth
    out_depth = max_depth * d

    score = np.asarray(kpts2d)[..., 2:3].copy()
    k2 = np.asarray(kpts2d)[..., 0:2].copy()
    k2[:, :, 1:] = k2[:, :, :1] + k2[:, :, 1:]
    k2 = k2 * np.asarray(input_size, np.float32)
    return human_prob, score, k2, out_depth
