"""Temporal multi-frame deformable sampling, and the windowed sampling
formulations of the JAX package in plain PyTorch.

Temporal sampling is the counterpart of
``snipper_tpu/ops/deform_attn.py:1194-1324``. The reference shares one
offset/weight projection across the sampled frames, so sampling locations
and attention weights are the same for every sampled frame, and by
linearity

    sum_t2 MSDA(value[t2], loc, w)  ==  MSDA(sum_t2 value[t2], loc, w).

Neighbour-frame values are therefore summed once through a static
adjacency and each query frame is sampled once.

The windowed formulations (``ms_deform_attn_pmerged``,
``ms_deform_attn_windowed``, ``ms_deform_attn_pmerged2d``,
``ms_deform_attn_windowed2d`` and their plans, ``deform_attn.py:222-455``
and ``:743-982``) are XLA code in the JAX package, so they get no kernel
here. They compute the JAX functions: each query chunk or 2D query block
anchors a window of every level at its least live tap, drops the taps that
fall outside it and counts them in ``overflow``. The JAX package contracts
a weighted one-hot against the window on the MXU; here each tap is a row
gather and a weighted add (:func:`gather_taps`), so no one-hot or
``[.., C, 16, D]`` tensor is ever built, and the weights stay f32 where JAX
rounds them to a bf16 value's dtype before the MXU.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from snipper_tpu_torch.ops.msda import ms_deform_attn


_DEVICE_CONSTANTS = {}


def device_constant(values, like: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A small host constant in ``dtype`` on ``like``'s device. On a CUDA
    device it
    is copied once, from pinned memory without blocking (a copy from
    pageable memory would wait for the stream to drain), and kept: later
    calls with the same values reuse it, and ``torch.export`` takes the
    kept tensor into the program as a constant on the device, so that the
    program copies nothing when it runs. The kept tensor is made outside
    inference mode, so that autograd may save it later. The values are a
    model's level sizes and frame counts, so the store holds a few
    tensors per input resolution."""
    values = np.asarray(values, np.float32)
    if like.device.type != "cuda":
        return torch.as_tensor(values, device=like.device).to(dtype)
    key = (values.tobytes(), values.shape, like.device, dtype)
    t = _DEVICE_CONSTANTS.get(key)
    if t is None:
        if torch.compiler.is_compiling():
            # not seen eagerly first: a constant copied at each run
            return torch.as_tensor(values, device=like.device).to(dtype)
        with torch.inference_mode(False):
            t = torch.as_tensor(values).to(dtype).pin_memory().to(
                like.device, non_blocking=True)
        _DEVICE_CONSTANTS[key] = t
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
    impl: str = "xla",
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
      impl: ``cfg.deform_impl``. ``"skip"`` is JAX's profiling stand-in
        (``snipper_tpu/ops/deform_attn.py:1290-1295``): the mean of the
        aggregated value over S, broadcast to every query; it launches no
        kernel and is not exact. Every other name runs the exact
        ``ms_deform_attn`` (the kernel on CUDA, the plain version on the
        CPU).

    Returns ``(out [B, T1, Lq, H*D], overflow)``. ``overflow`` is always 0:
    the sampling is an exact gather with no window that could drop taps.

    Gradients flow to all three inputs, through the softmax, the division
    by the frame count and the neighbour-frame sum. The softmax and the
    division run in the logits' dtype, as JAX's (``deform_attn.py:
    1262-1266``): bf16 weights under the bf16 recipe. The sampling then
    takes ``loc`` and ``attn`` widened to f32, which is exact and is what
    JAX's exact sampling does with them (``deform_attn.py:130-145``); the
    kernels take only f32 ``loc``/``attn``, and autograd narrows their
    f32 gradients back to the inputs' dtypes. ``value`` keeps its dtype.
    """
    B, T1, Lq, nH, L, P = attention_logits.shape
    _, T2, S, _, D = value.shape

    attn = torch.softmax(attention_logits.reshape(B, T1, Lq, nH, L * P), -1)
    counts = np.asarray(adjacency).sum(axis=1)            # [T1] static
    attn = attn / device_constant(counts, attn, attn.dtype)[
        None, :, None, None, None]
    attn = attn.reshape(B, T1, Lq, nH, L, P)

    # static unrolled adds over the tiny frame axis, in the JAX order
    adj = np.asarray(adjacency)
    v_agg = torch.stack(
        [sum(value[:, t2] for t2 in range(T2) if adj[t1, t2] > 0)
         for t1 in range(T1)], dim=1)                     # [B, T1, S, H, D]

    if impl == "skip":
        v_flat = v_agg.reshape(B * T1, S, nH * D)
        out = v_flat.mean(1, keepdim=True).expand(B * T1, Lq, nH * D)
        return out.reshape(B, T1, Lq, nH * D), 0
    # fold T1 into the batch for one sampling call
    out = ms_deform_attn(
        v_agg.reshape(B * T1, S, nH, D), spatial_shapes,
        sampling_locations.float().reshape(B * T1, Lq, nH, L, P, 2)
        .contiguous(),
        attn.float().reshape(B * T1, Lq, nH, L, P).contiguous())
    return out.reshape(B, T1, Lq, nH * D), 0


# ---------------------------------------------------------------------------
# Windowed sampling (plain PyTorch)
# ---------------------------------------------------------------------------
def corner_taps(loc: torch.Tensor, attn: torch.Tensor, h: int, w: int):
    """Exact ``grid_sample`` corner decomposition of one level.

    ``loc [..., P, 2]`` normalized, ``attn [..., P]`` -> ``(ys, xs, wgt)``,
    each ``[..., P*4]``: tap ``p*4 + corner`` (corners (dy, dx) = (0, 0),
    (0, 1), (1, 0), (1, 1)) lies at the clipped pixel ``(ys, xs)`` (int64)
    with the weight bilinear corner weight x validity x attn (f32; off-map
    corners weigh exactly 0). The f32 steps are those of ``_corner_taps_1d``
    (``deform_attn.py:222``) and of the corner loops of
    ``ms_deform_attn_pmerged2d`` and ``_win2d_segment``, so the anchors and
    the overflow counts come out equal.
    """
    x = loc[..., 0].float() * w - 0.5
    y = loc[..., 1].float() * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    a = attn.float()
    ys, xs, wgt = [], [], []
    for dy in (0, 1):
        for dx in (0, 1):
            cw = (1.0 - torch.abs(fx - dx)) * (1.0 - torch.abs(fy - dy))
            valid = ((x0 + dx >= 0) & (x0 + dx < w)
                     & (y0 + dy >= 0) & (y0 + dy < h))
            xs.append(torch.clamp(x0 + dx, 0, w - 1).long())
            ys.append(torch.clamp(y0 + dy, 0, h - 1).long())
            wgt.append(cw * valid.float() * a)
    return tuple(torch.stack(t, -1).flatten(-2) for t in (ys, xs, wgt))


def gather_taps(rows: torch.Tensor, row_ids: torch.Tensor,
                wgt: torch.Tensor) -> torch.Tensor:
    """``sum_k wgt[..., k] * rows[row_ids[..., k]]`` -> ``[..., D]`` f32,
    one tap at a time (a row gather, then a weighted add), so nothing of
    size ``[..., K, D]`` is built. ``rows [R, D]``; ``row_ids`` int64 in
    ``[0, R)``."""
    out = None
    for k in range(row_ids.shape[-1]):
        g = rows.index_select(0, row_ids[..., k].reshape(-1)).float()
        term = wgt[..., k, None] * g.reshape(*row_ids.shape[:-1], -1)
        out = term if out is None else out + term
    return out


def _value_rows(ids: torch.Tensor, B: int, S: int, H: int, start: int):
    """Rows of ``value.reshape(B*S*H, D)`` for level pixels ``ids
    [B, Q, H, K]`` of the level that starts at pixel ``start``."""
    b = torch.arange(B, device=ids.device).view(B, 1, 1, 1)
    hh = torch.arange(H, device=ids.device).view(1, 1, H, 1)
    return (b * S + start + ids) * H + hh


def ms_deform_attn_pmerged(value: torch.Tensor,
                           spatial_shapes: Sequence[Tuple[int, int]],
                           sampling_locations: torch.Tensor,
                           attention_weights: torch.Tensor,
                           query_chunk: int | None = None,
                           window: Sequence[int] | None = None):
    """Counterpart of ``ms_deform_attn_pmerged`` (``deform_attn.py:260``).

    ``value [B, S, H, D]``, ``sampling_locations [B, Lq, H, L, P, 2]``,
    ``attention_weights [B, Lq, H, L, P]`` -> ``out [B, Lq, H*D]`` in the
    value's dtype. ``window``: per-level window widths in pixels (0, or a
    width not below the level's size, means the whole level). With a
    window, each chunk of ``query_chunk`` queries anchors level ``l`` at its
    least live pixel id, rounded down to a multiple of 8 and clipped; taps
    outside ``[anchor, anchor + window[l])`` are dropped and counted, and
    the result is ``(out, overflow)`` (a f32 scalar tensor)."""
    B, S, H, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    assert L == len(spatial_shapes), (L, spatial_shapes)
    assert S == sum(h * w for h, w in spatial_shapes)
    if query_chunk is None:
        query_chunk = max(256, (1024 * 4) // max(B, 1))
    win = list(window) if window is not None else [0] * L
    rows = value.reshape(B * S * H, D)
    out = torch.zeros(B, Lq, H, D, dtype=torch.float32, device=value.device)
    overflow = torch.zeros((), dtype=torch.float32, device=value.device)
    n_chunks = -(-Lq // query_chunk)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        Sl = h * w
        Ws = win[lvl] if (win[lvl] and win[lvl] < Sl) else 0
        ys, xs, wgt = corner_taps(sampling_locations[:, :, :, lvl],
                                  attention_weights[:, :, :, lvl], h, w)
        ids = ys * w + xs                                  # [B, Lq, H, 4P]
        if Ws:
            live = wgt > 0
            least = torch.where(live, ids, Sl).amin(dim=(0, 2, 3))   # [Lq]
            least = torch.nn.functional.pad(
                least, (0, n_chunks * query_chunk - Lq), value=Sl)
            lo = least.view(n_chunks, query_chunk).amin(1)
            lo = torch.clamp(torch.div(lo, 8, rounding_mode="floor") * 8,
                             0, max(Sl - Ws, 0))
            local = ids - lo.repeat_interleave(query_chunk)[:Lq, None, None]
            inside = (local >= 0) & (local < Ws)
            overflow = overflow + (live & ~inside).sum()
            wgt = torch.where(inside, wgt, 0.0)
        out += gather_taps(rows, _value_rows(ids, B, S, H, start), wgt)
        start += Sl
    out = out.reshape(B, Lq, H * D).to(value.dtype)
    return out if window is None else (out, overflow)


def windowed_sampling_plan(spatial_shapes: Sequence[Tuple[int, int]],
                           base_chunk: int = 512, margin_px: int = 8):
    """Counterpart of ``windowed_sampling_plan`` (``deform_attn.py:380``):
    ``(sizes, qcs, wins)``, the per-level query counts, per-segment chunk
    sizes and per-(segment, tap level) 1D window widths (0 = whole
    level, where a window would not cut at least 25%)."""
    sizes = [h * w for h, w in spatial_shapes]
    s0 = sizes[0]
    qcs = [max(64, min(base_chunk, ((base_chunk * s) // s0) // 64 * 64))
           for s in sizes]
    wins = []
    for seg, s_seg in enumerate(sizes):
        seg_wins = []
        for (h, w), st in zip(spatial_shapes, sizes):
            span = -(-qcs[seg] * st // s_seg)
            ws = int(-(-(span + 2 * margin_px * w + 128) // 128) * 128)
            seg_wins.append(0 if ws >= 0.75 * st else ws)
        wins.append(seg_wins)
    return sizes, qcs, wins


def ms_deform_attn_windowed(value: torch.Tensor,
                            spatial_shapes: Sequence[Tuple[int, int]],
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor,
                            query_segments: Sequence[int],
                            base_chunk: int = 512, margin_px: int = 8):
    """Counterpart of ``ms_deform_attn_windowed`` (``deform_attn.py:421``):
    each query segment through :func:`ms_deform_attn_pmerged` with its
    chunk size and windows from :func:`windowed_sampling_plan`. Returns
    ``(out, overflow)``."""
    assert sum(query_segments) == sampling_locations.shape[1], (
        query_segments, sampling_locations.shape)
    _, qcs, wins = windowed_sampling_plan(spatial_shapes, base_chunk,
                                          margin_px)
    outs = []
    overflow = torch.zeros((), dtype=torch.float32, device=value.device)
    q0 = 0
    for si, (seg, qc) in enumerate(zip(query_segments, qcs)):
        o, ov = ms_deform_attn_pmerged(
            value, spatial_shapes, sampling_locations[:, q0:q0 + seg],
            attention_weights[:, q0:q0 + seg], query_chunk=qc,
            window=wins[si])
        outs.append(o)
        overflow = overflow + ov
        q0 += seg
    return torch.cat(outs, 1), overflow


def windowed2d_plan(spatial_shapes: Sequence[Tuple[int, int]],
                    block_h: int = 8, block_w: int = 20, margin_px: int = 8):
    """Counterpart of ``windowed2d_plan`` (``deform_attn.py:743``):
    ``(blocks, wins)``, per query segment the query block ``(bh, bw)`` in
    segment pixels (scaled from the level-0 block and clamped), and per
    (segment, tap level) the 2D window ``(wy, wx)``, or ``(0, 0)`` for the
    whole level where a window would not cut at least 25%."""
    h0, w0 = spatial_shapes[0]
    blocks, wins = [], []
    for (hs, ws) in spatial_shapes:
        bh_s = max(2, min(hs, -(-block_h * hs // h0)))
        bw_s = max(2, min(ws, -(-block_w * ws // w0)))
        blocks.append((bh_s, bw_s))
        seg_wins = []
        for (ht, wt) in spatial_shapes:
            wy = -(-bh_s * ht // hs) + 2 * margin_px + 2
            wx = -(-bw_s * wt // ws) + 2 * margin_px + 2
            if wy * wx >= 0.75 * ht * wt:
                seg_wins.append((0, 0))
            else:
                seg_wins.append((min(wy, ht), min(wx, wt)))
        wins.append(seg_wins)
    return blocks, wins


def ms_deform_attn_pmerged2d(value: torch.Tensor,
                             spatial_shapes: Sequence[Tuple[int, int]],
                             sampling_locations: torch.Tensor,
                             attention_weights: torch.Tensor,
                             seg_shape: Tuple[int, int],
                             block: Tuple[int, int],
                             windows: Sequence[Tuple[int, int]]):
    """Counterpart of ``ms_deform_attn_pmerged2d`` (``deform_attn.py:788``).

    The queries are one segment's row-major pixel grid ``seg_shape``. Each
    ``block = (bh, bw)`` rectangle of them anchors tap level ``l``'s window
    ``windows[l] = (wy, wx)`` at the least row and the least column of its
    live taps over batch, queries, heads, points and corners, clipped into
    the level; taps outside are dropped and counted. ``(0, 0)`` samples
    the whole level. Returns ``(out [B, S_seg, H*D], overflow)``."""
    B, S, H, D = value.shape
    _, Sseg, _, L, P, _ = sampling_locations.shape
    hs, ws = seg_shape
    assert hs * ws == Sseg, (seg_shape, Sseg)
    # each query's block, numbered row-major over the block grid
    bh, bw = block
    nbx = -(-ws // bw)
    NB = -(-hs // bh) * nbx
    q = torch.arange(Sseg, device=value.device)
    blk = (q // ws) // bh * nbx + (q % ws) // bw
    rows = value.reshape(B * S * H, D)
    out = torch.zeros(B, Sseg, H, D, dtype=torch.float32, device=value.device)
    overflow = torch.zeros((), dtype=torch.float32, device=value.device)

    def anchor(coord, live, fill, hi):
        """Per query, its block's least live coordinate, clipped."""
        least = torch.where(live, coord, fill).amin(dim=(0, 2, 3))  # [Sseg]
        per_block = torch.full((NB,), fill, dtype=least.dtype,
                               device=least.device)
        per_block = per_block.scatter_reduce(0, blk, least, "amin")
        return torch.clamp(per_block, 0, hi)[blk][:, None, None]

    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        wy, wx = windows[lvl]
        ys, xs, wgt = corner_taps(sampling_locations[:, :, :, lvl],
                                  attention_weights[:, :, :, lvl], h, w)
        if wy:
            live = wgt > 0
            ly = ys - anchor(ys, live, h, max(h - wy, 0))
            lx = xs - anchor(xs, live, w, max(w - wx, 0))
            inside = (ly >= 0) & (ly < wy) & (lx >= 0) & (lx < wx)
            overflow = overflow + (live & ~inside).sum()
            wgt = torch.where(inside, wgt, 0.0)
        out += gather_taps(rows, _value_rows(ys * w + xs, B, S, H, start),
                           wgt)
        start += h * w
    return out.reshape(B, Sseg, H * D).to(value.dtype), overflow


def ms_deform_attn_windowed2d(value: torch.Tensor,
                              spatial_shapes: Sequence[Tuple[int, int]],
                              sampling_locations: torch.Tensor,
                              attention_weights: torch.Tensor,
                              query_segments: Sequence[int],
                              block_h: int = 8, block_w: int = 20,
                              margin_px: int = 8):
    """Counterpart of ``ms_deform_attn_windowed2d`` (``deform_attn.py:947``)
    and the plain version of the ``win2d_sample`` kernel's op
    (``ops/win2d.py``): each query segment (the encoder's per-level pixel
    grids) through :func:`ms_deform_attn_pmerged2d` with its block and
    windows from :func:`windowed2d_plan`. Returns ``(out, overflow)``."""
    assert sum(query_segments) == sampling_locations.shape[1], (
        query_segments, sampling_locations.shape)
    assert list(query_segments) == [h * w for h, w in spatial_shapes], (
        "windowed2d requires the encoder's pixel-grid query segments",
        query_segments, spatial_shapes)
    blocks, wins = windowed2d_plan(spatial_shapes, block_h, block_w,
                                   margin_px)
    outs = []
    overflow = torch.zeros((), dtype=torch.float32, device=value.device)
    q0 = 0
    for si, seg in enumerate(query_segments):
        o, ov = ms_deform_attn_pmerged2d(
            value, spatial_shapes, sampling_locations[:, q0:q0 + seg],
            attention_weights[:, q0:q0 + seg], spatial_shapes[si],
            blocks[si], wins[si])
        outs.append(o)
        overflow = overflow + ov
        q0 += seg
    return torch.cat(outs, 1), overflow
