"""Windowed sampling on the card: the host side of the ``win2d_sample``
kernel and the wrappers of ``win2d_contract`` and ``hier_gather``, each beside its
plain PyTorch version. The kernels are in ``ops/csrc/win2d.cu``.

Counterparts in the JAX package:

- :func:`ms_deform_attn_windowed2d_kernel` and :func:`segment_taps`:
  ``ms_deform_attn_windowed2d_pallas`` and ``_win2d_segment``
  (``snipper_tpu/ops/pallas_deform.py:221-384``), everything that JAX does
  outside its kernel (corner decomposition, weights, the per-block window
  anchor, window-local ids, the overflow count), in torch ops;
- :func:`win2d_sample`: that ``pl.pallas_call`` of ``_win2d_kernel_factory``
  (``pallas_deform.py:186``, call at ``:323``), which stages each level's
  window and contracts the taps against it;
- :func:`win2d_contract`: ``_onehot_reference``
  (``scripts/lanegather_probe.py:217``), K2's kernel body on windows staged
  beforehand; the kernel gathers each tap's window row directly;
- :func:`hier_gather`: ``hier_gather_sample`` (``lanegather_probe.py:164``),
  the same contraction on the transposed layout.

Each wrapper chooses by device alone: CPU tensors take the plain version
(``*_torch``), CUDA tensors launch the kernel (``*_cuda``) or the wrapper
raises; there is no fallback. ``<wrapper>.launches`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from snipper_tpu_torch.ops.deform_attn import (corner_taps, gather_taps,
                                               windowed2d_plan)

MAX_LEVELS = 8      # W2D_MAX_LEVELS in win2d.cu
MAX_TAPS = 16       # HG_MAX_TAPS: hier_gather's taps per query and level
INT32_LIMIT = 2 ** 31  # win2d_sample's value rows and queries are int32

_vp, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # value, anchors, out, ids[], wgts[], table, seg, L, K, S, H, D, C, NB,
    # BH, stream
    "win2d_sample_f32": [_vp] * 7 + [_i, _i, _i64] + [_i] * 5 + [_vp],
    "win2d_sample_bf16": [_vp] * 7 + [_i, _i, _i64] + [_i] * 5 + [_vp],
    # out, wins[], ids[], wgts[], table/widths, L, K, D, C or Cp, NB, BH,
    # stream
    "win2d_contract_f32": [_vp] * 5 + [_i] * 6 + [_vp],
    "hier_gather_f32": [_vp] * 5 + [_i] * 6 + [_vp],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load ``libwin2d.so``."""
    from snipper_tpu_torch.ops import _build

    lib = _build.load("win2d.cu", "libwin2d.so")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch(name, *args, device):
    """Call the C entry point ``name`` on ``device``'s current stream and
    raise if the launch failed."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check_cuda(name, tensors, device, dtypes):
    """Every tensor contiguous on ``device`` (a CUDA device), with its
    dtype in ``dtypes`` (one tuple of allowed dtypes per tensor)."""
    for t, allowed in zip(tensors, dtypes):
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: every tensor must lie on one CUDA "
                             f"device (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.dtype not in allowed:
            raise TypeError(f"{name}: got {t.dtype}, takes {allowed}")


# ------------------------------------------------------- K2's host side
class SegmentTaps(NamedTuple):
    """One query segment's input to ``win2d_sample``."""

    ids: Tuple[torch.Tensor, ...]   # per level [NB, BH, C, K] int32, local
    wgts: Tuple[torch.Tensor, ...]  # per level [NB, BH, C, K] f32
    anchors: torch.Tensor           # [L, NB, 2] int32: (y_lo, x_lo)
    windows: Tuple[Tuple[int, int], ...]  # per level (wy, wx)
    seg_shape: Tuple[int, int]      # (hs, ws) query pixel grid
    block: Tuple[int, int]          # (bh, bw) query block
    overflow: torch.Tensor          # f32 scalar: live taps dropped


def segment_taps(spatial_shapes: Sequence[Tuple[int, int]],
                 loc: torch.Tensor, attn: torch.Tensor,
                 seg_shape: Tuple[int, int], block: Tuple[int, int],
                 windows: Sequence[Tuple[int, int]]) -> SegmentTaps:
    """The torch part of ``_win2d_segment`` for ``loc [B, S_seg, H, L, P, 2]``
    and ``attn [B, S_seg, H, L, P]``: queries regrouped into ``block``
    rectangles (zero-padded, so padded queries weigh 0); per level, the
    window ``(wy, wx)`` (the whole level where the plan disabled it), the
    block's anchor (least live row and column over batch, queries, heads,
    points and corners, clipped into the level), window-local ids (``wy *
    wx`` for a tap outside the window) and weights (0 outside), and the
    count of live taps that fell outside."""
    B, Sseg, H, L, P, _ = loc.shape
    hs, ws = seg_shape
    bh, bw = block
    nby, nbx = -(-hs // bh), -(-ws // bw)
    NB, C = nby * nbx, bh * bw

    def to_blocks(a):
        """[B, S_seg, ...] -> [B, NB, C, ...], zero-padded."""
        a = a.reshape(B, hs, ws, *a.shape[2:])
        padded = a.new_zeros(B, nby * bh, nbx * bw, *a.shape[3:])
        padded[:, :hs, :ws] = a
        a = padded.reshape(B, nby, bh, nbx, bw, *a.shape[3:])
        a = a.permute(0, 1, 3, 2, 4, *range(5, a.ndim))
        return a.reshape(B, NB, C, *a.shape[5:])

    def fold(t):
        """[B, NB, C, H, K] -> [NB, B*H, C, K]."""
        return t.permute(1, 0, 3, 2, 4).reshape(NB, B * H, C, -1).contiguous()

    loc_b, attn_b = to_blocks(loc), to_blocks(attn)
    ids, wgts, anchors, wins = [], [], [], []
    overflow = torch.zeros((), dtype=torch.float32, device=loc.device)
    for lvl, (h, w) in enumerate(spatial_shapes):
        wy, wx = windows[lvl]
        if not wy:                  # disabled plan window: the whole level
            wy, wx = h, w
        wy, wx = min(wy, h), min(wx, w)
        ys, xs, wg = corner_taps(loc_b[:, :, :, :, lvl],
                                 attn_b[:, :, :, :, lvl], h, w)
        live = wg > 0                                   # [B, NB, C, H, 4P]
        y_lo = torch.clamp(torch.where(live, ys, h).amin(dim=(0, 2, 3, 4)),
                           0, max(h - wy, 0))           # [NB]
        x_lo = torch.clamp(torch.where(live, xs, w).amin(dim=(0, 2, 3, 4)),
                           0, max(w - wx, 0))
        ly = ys - y_lo[None, :, None, None, None]
        lx = xs - x_lo[None, :, None, None, None]
        inside = (ly >= 0) & (ly < wy) & (lx >= 0) & (lx < wx)
        overflow = overflow + (live & ~inside).sum()
        ids.append(fold(torch.where(inside, ly * wx + lx, wy * wx)).int())
        wgts.append(fold(torch.where(inside, wg, 0.0)))
        anchors.append(torch.stack([y_lo, x_lo], -1))
        wins.append((wy, wx))
    return SegmentTaps(tuple(ids), tuple(wgts),
                       torch.stack(anchors).int().contiguous(), tuple(wins),
                       tuple(seg_shape), tuple(block), overflow)


def ms_deform_attn_windowed2d_kernel(
        value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
        sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
        query_segments: Sequence[int], block_h: int = 8, block_w: int = 20,
        margin_px: int = 8):
    """2D-windowed sampling through :func:`win2d_sample`, one launch per
    query segment: the counterpart of ``ms_deform_attn_windowed2d_pallas``,
    with the contract of
    :func:`~snipper_tpu_torch.ops.deform_attn.ms_deform_attn_windowed2d`,
    its plain version: returns ``(out [B, Lq, H*D] in the value's dtype,
    overflow)``; taps outside their window are dropped and counted."""
    assert sum(query_segments) == sampling_locations.shape[1]
    assert list(query_segments) == [h * w for h, w in spatial_shapes]
    blocks, wins = windowed2d_plan(spatial_shapes, block_h, block_w,
                                   margin_px)
    outs = []
    overflow = torch.zeros((), dtype=torch.float32, device=value.device)
    q0 = 0
    for si, seg in enumerate(query_segments):
        taps = segment_taps(spatial_shapes,
                            sampling_locations[:, q0:q0 + seg],
                            attention_weights[:, q0:q0 + seg],
                            spatial_shapes[si], blocks[si], wins[si])
        outs.append(win2d_sample(value, spatial_shapes, taps))
        overflow = overflow + taps.overflow
        q0 += seg
    return torch.cat(outs, 1), overflow


# ---------------------------------------------------------------- K2 kernel
def _blocks_to_queries(acc, B, H, seg_shape, block):
    """[NB, B*H, C, D] -> [B, hs*ws, H*D], dropping padded queries."""
    hs, ws = seg_shape
    bh, bw = block
    nby, nbx = -(-hs // bh), -(-ws // bw)
    D = acc.shape[-1]
    o = acc.reshape(nby, nbx, B, H, bh, bw, D).permute(2, 0, 4, 1, 5, 3, 6)
    o = o.reshape(B, nby * bh, nbx * bw, H * D)[:, :hs, :ws]
    return o.reshape(B, hs * ws, H * D)


def window_rows(value_shape, spatial_shapes: Sequence[Tuple[int, int]],
                taps: SegmentTaps, lvl: int):
    """``(rows, in_win)`` of level ``lvl``'s taps, both ``[NB, BH, C, K]``:
    the row of ``value.reshape(-1, D)`` that each tap's window-local id
    names (the pixel at the block's anchor plus the id), and whether the
    id lies in the window (the others name the pad row and weigh 0)."""
    B, S, H, D = value_shape
    NB, BH = taps.ids[lvl].shape[:2]
    (h, w), (wy, wx) = spatial_shapes[lvl], taps.windows[lvl]
    start = sum(hh * ww for hh, ww in spatial_shapes[:lvl])
    ids = taps.ids[lvl].long()
    in_win = ids < wy * wx
    ids = torch.where(in_win, ids, 0)
    anchor = taps.anchors[lvl].long()
    y = anchor[:, 0].view(NB, 1, 1, 1) + ids // wx
    x = anchor[:, 1].view(NB, 1, 1, 1) + ids % wx
    bh = torch.arange(BH, device=ids.device).view(1, BH, 1, 1)
    return ((bh // H) * S + start + y * w + x) * H + bh % H, in_win


def win2d_sample_torch(value: torch.Tensor,
                       spatial_shapes: Sequence[Tuple[int, int]],
                       taps: SegmentTaps) -> torch.Tensor:
    """Plain version of the ``win2d_sample`` kernel: each tap's window row
    gathered and added with its weight, level by level, in f32;
    ``[B, hs*ws, H*D]`` in the value's dtype."""
    B, S, H, D = value.shape
    rows = value.reshape(B * S * H, D)
    acc = None
    for lvl in range(len(spatial_shapes)):
        r, in_win = window_rows(value.shape, spatial_shapes, taps, lvl)
        term = gather_taps(rows, r, torch.where(in_win, taps.wgts[lvl], 0.0))
        acc = term if acc is None else acc + term
    return _blocks_to_queries(acc, B, H, taps.seg_shape,
                              taps.block).to(value.dtype)


def win2d_sample_cuda(value: torch.Tensor,
                      spatial_shapes: Sequence[Tuple[int, int]],
                      taps: SegmentTaps) -> torch.Tensor:
    """Launch ``win2d_sample`` on the current stream: a group of threads
    per (query, b*h), any block size C and any D. Raises on anything the
    kernel does not take."""
    B, S, H, D = value.shape
    L = len(spatial_shapes)
    NB, BH, C, K = taps.ids[0].shape
    dev = value.device
    if not 1 <= L <= MAX_LEVELS or len(taps.ids) != L:
        raise ValueError(f"win2d_sample: need 1 <= L <= {MAX_LEVELS} levels "
                         f"of taps (got {L}, {len(taps.ids)})")
    hs, ws = taps.seg_shape
    bh, bw = taps.block
    if BH != B * H or C != bh * bw \
            or NB != -(-hs // bh) * -(-ws // bw) \
            or tuple(taps.anchors.shape) != (L, NB, 2) \
            or any(tuple(t.shape) != (NB, BH, C, K)
                   for t in taps.ids + taps.wgts):
        raise ValueError(f"win2d_sample: taps do not fit value "
                         f"{tuple(value.shape)} and blocks {taps.block} of "
                         f"{taps.seg_shape}")
    if B * S * H >= INT32_LIMIT or NB * BH * C >= INT32_LIMIT:
        raise ValueError(f"win2d_sample: {B * S * H} value rows or "
                         f"{NB * BH * C} queries exceed the kernel's int32 "
                         f"counts")
    f32, i32 = (torch.float32,), (torch.int32,)
    _check_cuda("win2d_sample", [value, taps.anchors, *taps.ids, *taps.wgts],
                dev, [(torch.float32, torch.bfloat16), i32]
                + [i32] * L + [f32] * L)
    kind = "f32" if value.dtype == torch.float32 else "bf16"
    out = torch.empty(B, hs * ws, H * D, dtype=value.dtype, device=dev)
    table, start = [], 0
    for (h, w), (wy, wx) in zip(spatial_shapes, taps.windows):
        table += [wy * wx, wx, h, w, start]
        start += h * w
    if start != S:
        raise ValueError(f"win2d_sample: value has S={S} pixels, "
                         f"spatial_shapes {spatial_shapes} another count")
    _launch(f"win2d_sample_{kind}", value.data_ptr(),
            taps.anchors.data_ptr(), out.data_ptr(), _pointers(taps.ids),
            _pointers(taps.wgts), (ctypes.c_int64 * (5 * L))(*table),
            (ctypes.c_int * 4)(hs, ws, bh, bw), L, K, S, H, D, C, NB, BH,
            device=dev)
    win2d_sample.launches += 1
    return out


def win2d_sample(value: torch.Tensor,
                 spatial_shapes: Sequence[Tuple[int, int]],
                 taps: SegmentTaps) -> torch.Tensor:
    """One query segment's windowed contraction, ``[B, hs*ws, H*D]`` in
    the value's dtype: the plain version for a CPU value, the kernel for
    a CUDA value."""
    if value.device.type == "cpu":
        return win2d_sample_torch(value, spatial_shapes, taps)
    return win2d_sample_cuda(value, spatial_shapes, taps)


# ------------------------------------------------------------- K5 and K4
def win2d_contract_torch(wins, ids, wgts) -> torch.Tensor:
    """Plain version of ``win2d_contract``: ``out[nb, bh, c] = sum_l sum_k
    wgts[l][nb, bh, c, k] * wins[l][nb, bh, ids[l][nb, bh, c, k]]`` (ids
    outside ``[0, Wd_l)`` add nothing), ``[NB, BH, C, D]`` f32."""
    NB, BH, C, K = ids[0].shape
    D = wins[0].shape[-1]
    blk = torch.arange(NB * BH, device=ids[0].device).view(NB, BH, 1, 1)
    acc = None
    for w, i, g in zip(wins, ids, wgts):
        Wd = w.shape[2]
        i = i.long()
        ok = (i >= 0) & (i < Wd)
        term = gather_taps(w.reshape(-1, D), blk * Wd + torch.where(ok, i, 0),
                           torch.where(ok, g, 0.0))
        acc = term if acc is None else acc + term
    return acc


def win2d_contract_cuda(wins, ids, wgts) -> torch.Tensor:
    """Launch ``win2d_contract``: ``wins[l] [NB, BH, Wd_l, D]`` f32,
    ``ids[l]`` int32 / ``wgts[l]`` f32 ``[NB, BH, C, K]`` -> ``[NB, BH, C, D]``
    f32; a group of threads per (query, b*h), any C, K and D."""
    L = len(wins)
    NB, BH, C, K = ids[0].shape
    D = wins[0].shape[-1]
    dev = wins[0].device
    if not 1 <= L <= MAX_LEVELS or len(ids) != L or len(wgts) != L \
            or any(w.shape[:2] != (NB, BH) or w.shape[3] != D for w in wins) \
            or any(tuple(t.shape) != (NB, BH, C, K) for t in ids + wgts):
        raise ValueError("win2d_contract: wins [NB, BH, Wd, D] and ids/wgts "
                         "[NB, BH, C, K] per level, 1 to 8 levels")
    f32, i32 = (torch.float32,), (torch.int32,)
    _check_cuda("win2d_contract", [*wins, *ids, *wgts], dev,
                [f32] * L + [i32] * L + [f32] * L)
    out = torch.empty(NB, BH, C, D, dtype=torch.float32, device=dev)
    table = [v for w in wins for v in (w.shape[2], 0, 0, 0, 0)]
    _launch("win2d_contract_f32", out.data_ptr(), _pointers(wins),
            _pointers(ids), _pointers(wgts),
            (ctypes.c_int64 * (5 * L))(*table), L, K, D, C, NB, BH,
            device=dev)
    win2d_contract.launches += 1
    return out


def win2d_contract(wins, ids, wgts) -> torch.Tensor:
    """K5: the windowed contraction on windows staged beforehand, in K2's
    layout; the plain version for CPU tensors, the kernel for CUDA ones."""
    if wins[0].device.type == "cpu":
        return win2d_contract_torch(wins, ids, wgts)
    return win2d_contract_cuda(wins, ids, wgts)


def hier_gather_torch(winsT, idsT, wgtsT) -> torch.Tensor:
    """Plain version of ``hier_gather``: :func:`win2d_contract_torch` on
    the transposed layout, ``[NB, BH, D, Cp]`` f32."""
    out = win2d_contract_torch([w.transpose(2, 3) for w in winsT],
                               [i.transpose(2, 3) for i in idsT],
                               [g.transpose(2, 3) for g in wgtsT])
    return out.transpose(2, 3).contiguous()


def hier_gather_cuda(winsT, idsT, wgtsT) -> torch.Tensor:
    """Launch ``hier_gather``: ``winsT[l] [NB, BH, D, Wd_l]`` f32,
    ``idsT[l]`` int32 / ``wgtsT[l]`` f32 ``[NB, BH, K, Cp]`` with
    ``K <= 16`` and ``Cp`` a multiple of 32 -> ``[NB, BH, D, Cp]`` f32."""
    L = len(winsT)
    NB, BH, K, Cp = idsT[0].shape
    D = winsT[0].shape[2]
    dev = winsT[0].device
    if not 1 <= L <= MAX_LEVELS or len(idsT) != L or len(wgtsT) != L \
            or any(w.shape[:3] != (NB, BH, D) for w in winsT) \
            or any(tuple(t.shape) != (NB, BH, K, Cp) for t in idsT + wgtsT) \
            or K > MAX_TAPS or Cp % 32:
        raise ValueError("hier_gather: winsT [NB, BH, D, Wd] and idsT/wgtsT "
                         "[NB, BH, K, Cp] per level, 1 to 8 levels, K <= 16, "
                         "Cp a multiple of 32")
    f32, i32 = (torch.float32,), (torch.int32,)
    _check_cuda("hier_gather", [*winsT, *idsT, *wgtsT], dev,
                [f32] * L + [i32] * L + [f32] * L)
    out = torch.empty(NB, BH, D, Cp, dtype=torch.float32, device=dev)
    _launch("hier_gather_f32", out.data_ptr(), _pointers(winsT),
            _pointers(idsT), _pointers(wgtsT),
            (ctypes.c_int64 * L)(*[w.shape[3] for w in winsT]), L, K, D, Cp,
            NB, BH, device=dev)
    hier_gather.launches += 1
    return out


def hier_gather(winsT, idsT, wgtsT) -> torch.Tensor:
    """K4: the windowed contraction on the transposed layout; the plain
    version for CPU tensors, the kernel for CUDA ones."""
    if winsT[0].device.type == "cpu":
        return hier_gather_torch(winsT, idsT, wgtsT)
    return hier_gather_cuda(winsT, idsT, wgtsT)


win2d_sample.launches = 0
win2d_contract.launches = 0
hier_gather.launches = 0
