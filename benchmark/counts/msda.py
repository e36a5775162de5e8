"""The work of one multi-scale deformable sampling call, from shapes.

``value [N, S, H, D]`` (S tokens over the levels), ``loc [N, Lq, H, L, P,
2]``, ``attn [N, Lq, H, L, P]``, output ``[N, Lq, H * D]``.

Operations: per tap (one (n, q, h, l, p)) four corner weights and the
attention weight (8) and, per corner and channel, a multiply-add (8 D):
``forward_ops``, the counterpart of the program's flop formula. For the
roofline's bound the sampling kernel's own arithmetic counts, as
``chip_smoke.py``'s ``msda_bound_ms`` counts it: per tap and channel 4
corner and 1 attention multiply-adds plus about 20 operations per tap for
coordinates and weights (10 D + 20); the backward 8 multiply-adds per tap
and channel plus about 30 per tap (16 D + 30).

Bytes: ``loc`` and ``attn`` (f32) read once, the output written once, and
the value rows the taps reach read once. The rows reached are counted from
the shapes: per (n, h) and level, the level's h*w rows or the taps' four
corners each, whichever is fewer. A query grid over every token (the
encoder, Lq = S) reaches every row; the decoder's few queries reach at
most four rows a tap. The backward also reads the output's gradient and
writes the value's gradient whole in f32, and the gradients of ``loc`` and
``attn`` once.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def forward_ops(value_shape, loc_shape) -> float:
    N, Lq, H, L, P, _ = loc_shape
    return float(N * Lq * H * L * P * (8 * value_shape[-1] + 8))


def call_work(N: int, Lq: int, H: int, D: int, P: int,
              shapes: Sequence[Tuple[int, int]], value_bytes: int,
              backward: bool = False) -> Tuple[float, float]:
    """``(bytes, operations)`` of one call."""
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    taps = N * Lq * H * L * P
    rows = N * H * sum(min(h * w, 4 * Lq * P) for h, w in shapes)
    out = N * Lq * H * D * value_bytes
    nbytes = rows * D * value_bytes + taps * 2 * 4 + taps * 4 + out
    ops = taps * (10 * D + 20)
    if backward:
        nbytes += N * S * H * D * 4 + taps * 2 * 4 + taps * 4
        ops = taps * (16 * D + 30)
    return float(nbytes), float(ops)


def step_bound_s(cfg: dict, batch: int, value_bytes: int, backward: bool,
                 hbm_bytes_per_s: float, flop_per_s: float) -> float:
    """The least seconds of every sampling call of one pass over ``batch``
    snippets: each call at the larger of its bytes over the memory rate
    and its operations over the arithmetic rate, summed. The encoder's
    calls sample the observed frames' tokens (N = batch x T, Lq = S); the
    decoder's sample with every (frame, query) of T + Tf frames."""
    from benchmark.reference.model import shapes_of

    shapes = shapes_of(cfg)
    S = sum(h * w for h, w in shapes)
    H, D = cfg["nheads"], cfg["hidden_dim"] // cfg["nheads"]
    T, T1 = cfg["num_frames"], cfg["num_frames"] + cfg["num_future_frames"]
    calls = ([(batch * T, S, cfg["enc_n_points"])] * cfg["enc_layers"]
             + [(batch * T1, cfg["num_queries"], cfg["dec_n_points"])]
             * cfg["dec_layers"])
    total = 0.0
    for N, Lq, P in calls:
        nbytes, ops = call_work(N, Lq, H, D, P, shapes, value_bytes,
                                backward)
        total += max(nbytes / hbm_bytes_per_s, ops / flop_per_s)
    return total
