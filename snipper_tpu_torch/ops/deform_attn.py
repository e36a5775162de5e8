"""Temporal multi-frame deformable sampling.

Counterpart of ``snipper_tpu/ops/deform_attn.py:1194-1324``. The reference
shares one offset/weight projection across the sampled frames, so sampling
locations and attention weights are the same for every sampled frame, and
by linearity

    sum_t2 MSDA(value[t2], loc, w)  ==  MSDA(sum_t2 value[t2], loc, w).

Neighbour-frame values are therefore summed once through a static
adjacency and each query frame is sampled once.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from snipper_tpu_torch.ops.msda import ms_deform_attn


def device_constant(values, like: torch.Tensor) -> torch.Tensor:
    """A small f32 host constant on ``like``'s device. On a CUDA device it
    is copied from pinned memory without blocking: a copy from pageable
    memory would wait for the stream to drain."""
    t = torch.as_tensor(np.asarray(values, np.float32))
    if like.device.type == "cuda":
        t = t.pin_memory().to(like.device, non_blocking=True)
    return t


def temporal_adjacency(n_frames: int, n_total: int) -> np.ndarray:
    """Static 0/1 adjacency ``[T1, T2]`` of which observed frames each query
    frame samples: observed query frame ``t1 < n_frames`` samples
    ``t2 in {t1-1, t1, t1+1}`` clipped to the observed range; future query
    frames sample all observed frames."""
    T2 = n_frames
    adj = np.zeros((n_total, T2), dtype=np.float32)
    for t1 in range(n_total):
        if t1 < n_frames:
            for t2 in (t1 - 1, t1, t1 + 1):
                if 0 <= t2 < T2:
                    adj[t1, t2] = 1.0
        else:
            adj[t1, :] = 1.0
    return adj


def temporal_deform_sample(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_logits: torch.Tensor,
    adjacency: np.ndarray,
) -> Tuple[torch.Tensor, int]:
    """Args:
      value: ``[B, T2, S, H, D]`` per observed frame.
      spatial_shapes: ``(h, w)`` per level.
      sampling_locations: ``[B, T1, Lq, H, L, P, 2]``.
      attention_logits: ``[B, T1, Lq, H, L, P]`` raw logits; softmaxed over
        ``(L, P)`` and divided by the count of sampled frames, which equals
        the reference's joint softmax over ``(L, P, frames)`` for shared
        projections.
      adjacency: ``[T1, T2]`` static 0/1 from :func:`temporal_adjacency`.

    Returns ``(out [B, T1, Lq, H*D], overflow)``. ``overflow`` is always 0:
    the sampling is an exact gather with no window that could drop taps.

    Gradients flow to all three inputs, through the softmax, the division
    by the frame count and the neighbour-frame sum. The softmax, the
    locations and the weights are f32 whatever the activation dtype (under
    autocast too): the kernels take only f32 ``loc``/``attn``; ``value``
    keeps its dtype (f32, or bf16 under autocast).
    """
    B, T1, Lq, nH, L, P = attention_logits.shape
    _, T2, S, _, D = value.shape

    attn = torch.softmax(
        attention_logits.float().reshape(B, T1, Lq, nH, L * P), -1)
    counts = np.asarray(adjacency).sum(axis=1)            # [T1] static
    attn = attn / device_constant(counts, attn)[None, :, None, None, None]
    attn = attn.reshape(B, T1, Lq, nH, L, P)

    # static unrolled adds over the tiny frame axis, in the JAX order
    adj = np.asarray(adjacency)
    v_agg = torch.stack(
        [sum(value[:, t2] for t2 in range(T2) if adj[t1, t2] > 0)
         for t1 in range(T1)], dim=1)                     # [B, T1, S, H, D]

    # fold T1 into the batch for one sampling call
    out = ms_deform_attn(
        v_agg.reshape(B * T1, S, nH, D), spatial_shapes,
        sampling_locations.float().reshape(B * T1, Lq, nH, L, P, 2)
        .contiguous(),
        attn.reshape(B * T1, Lq, nH, L, P).contiguous())
    return out.reshape(B, T1, Lq, nH * D), 0
