"""``win2d_sample``'s per-tap row arithmetic, and the A/B driver's pieces
that run without a card.

The kernel (``ops/csrc/win2d.cu::win2d_sample_kernel``) flattens queries
over (nb, bh, c), works out per level and query the value row of the
window origin from the query's own anchor, and turns each tap into the
global row ``base + ((id // wx) * w + id % wx) * H``, or -1 for a zero
weight or the pad id ``wy * wx``. A torch model of that arithmetic is held
here against ``ops/win2d.py::window_rows``, which the plain version uses,
on taps that ``segment_taps`` makes from numpy inputs: exact integer
equality.
"""

import subprocess
import types

import numpy as np
import pytest
import torch

from snipper_tpu_torch.ops import _build, win2d
from snipper_tpu_torch.ops.deform_attn import windowed2d_plan
from snipper_tpu_torch.scripts import kernel_ab

SHAPES = [(24, 32), (12, 16), (6, 8)]


def _taps(block, margin, teleport, seed=5, B=2, H=3, P=2):
    """Each segment's taps for encoder-style grid queries (offsets up to
    3.9 pixels), with a quarter of the attention weights set to 0."""
    rng = np.random.default_rng(seed)
    sizes = [h * w for h, w in SHAPES]
    refs = []
    for (h, w) in SHAPES:
        gy, gx = np.meshgrid((np.arange(h) + 0.5) / h,
                             (np.arange(w) + 0.5) / w, indexing="ij")
        refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
    off = rng.uniform(-3.9, 3.9, (B, sum(sizes), H, len(SHAPES), P, 2))
    norm = np.array([(w, h) for h, w in SHAPES], np.float64)
    loc = (np.concatenate(refs, 0)[None, :, None, None, None, :]
           + off / norm[None, None, None, :, None, :]).astype(np.float32)
    if teleport:
        loc[1, 5, 1, 0, 0] = [0.97, 0.97]
    attn = rng.uniform(0, 1, (B, sum(sizes), H, len(SHAPES), P))
    attn[rng.uniform(size=attn.shape) < 0.25] = 0.0
    loc, attn = torch.from_numpy(loc), torch.from_numpy(attn.astype(np.float32))
    blocks, wins = windowed2d_plan(SHAPES, *block, margin)
    out, q0 = [], 0
    for si, seg in enumerate(sizes):
        out.append(win2d.segment_taps(SHAPES, loc[:, q0:q0 + seg],
                                      attn[:, q0:q0 + seg], SHAPES[si],
                                      blocks[si], wins[si]))
        q0 += seg
    return (B, sum(sizes), H, 4), out


def kernel_rows(value_shape, taps, lvl):
    """The kernel's table entry (row or -1) of every tap of level ``lvl``,
    ``[NB, BH, C, K]`` int64, computed as the kernel does: per flattened
    query q its block (nb, bh) and its window origin's row ``base``, then
    one division of the id by the window's width."""
    B, S, H, _ = value_shape
    NB, BH, C, K = taps.ids[lvl].shape
    (h, w), (wy, wx) = SHAPES[lvl], taps.windows[lvl]
    start = sum(hh * ww for hh, ww in SHAPES[:lvl])
    q = torch.arange(NB * BH * C)
    blk = q // C
    nb, bh = blk // BH, blk % BH
    b, hh = bh // H, bh % H
    anchor = taps.anchors[lvl].long()
    base = (b * S + start + anchor[nb, 0] * w + anchor[nb, 1]) * H + hh
    ids = taps.ids[lvl].long().reshape(-1, K)
    wgt = taps.wgts[lvl].reshape(-1, K)
    yy = ids // wx
    row = base[:, None] + (yy * w + ids - yy * wx) * H
    live = (wgt != 0) & (ids >= 0) & (ids < wy * wx) & (row >= 0) \
        & (row < B * S * H)
    return torch.where(live, row, -1).reshape(NB, BH, C, K)


@pytest.mark.parametrize("block,margin,teleport", [
    ((6, 8), 5, False), ((5, 7), 5, False), ((5, 9), 5, True),
    ((8, 20), 5, False), ((6, 8), 8, True), ((3, 4), 0, True)],
    ids=["6x8", "5x7_ragged", "5x9_straddle_teleport", "8x20",
         "disabled_windows", "3x4_margin0"])
def test_kernel_row_arithmetic_matches_window_rows(block, margin, teleport):
    value_shape, segments = _taps(block, margin, teleport)
    H = value_shape[2]
    n_pad = n_zero = n_live = 0
    for taps in segments:
        for lvl in range(len(SHAPES)):
            got = kernel_rows(value_shape, taps, lvl)
            rows, in_win = win2d.window_rows(value_shape, SHAPES, taps, lvl)
            live = in_win & (taps.wgts[lvl] != 0)
            assert torch.equal(got, torch.where(live, rows, -1))
            # each live row is a (pixel, head) row of the tap's own head
            bh = torch.arange(got.shape[1]).view(1, -1, 1, 1)
            assert torch.equal((got % H)[live], (bh % H).expand_as(got)[live])
            wy, wx = taps.windows[lvl]
            n_pad += int((taps.ids[lvl] == wy * wx).sum())
            n_zero += int((taps.wgts[lvl] == 0).sum())
            n_live += int(live.sum())
    assert n_live > 0 and n_zero > 0
    if teleport and margin != 8:  # margin 8 disables every window
        assert n_pad > 0           # the teleported tap left its window


def test_kernel_ab_needs_a_source_and_a_card(monkeypatch, capsys):
    with pytest.raises(SystemExit) as exc:
        kernel_ab.main([])
    assert exc.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_ab.main(["--lane_chain", "other.cu"]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


SASS = """
\tcode for sm_90a
\t\tFunction : _Z19chain_gather_kernelPKfPKiPfli
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   SHFL.IDX PT, R5, R4, R3, 0x1f ;
        /*0020*/              @!P0 BRA `(.L_x_1) ;
        /*0030*/                   FSEL R6, R5, RZ, P1 ;
        /*0040*/                   FADD R6, R6, 1 ;
\t\tFunction : _Z19chain_select_kernelPKfPKiPfli
        /*0000*/                   ISETP.NE.AND P0, PT, R2, R3, PT ;
        /*0010*/               @P0 FSEL R4, R4, RZ, !P0 ;
        /*0020*/                   STG.E desc[UR4][R2.64], R4 ;
"""


def test_sass_counts_reads_opcodes_per_kernel(monkeypatch, tmp_path):
    (tmp_path / "nvcc").write_text("")
    (tmp_path / "cuobjdump").write_text("")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(tmp_path / "nvcc"))
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(stdout=SASS, returncode=0)

    monkeypatch.setattr(subprocess, "run", run)
    counts = kernel_ab.sass_counts("lib.so")
    assert calls == [[str(tmp_path / "cuobjdump"), "-sass", "lib.so"]]
    gather = counts["_Z19chain_gather_kernelPKfPKiPfli"]
    select = counts["_Z19chain_select_kernelPKfPKiPfli"]
    assert (gather["all"], gather["SHFL"], gather["BRA"], gather["FSEL"],
            gather["FADD"]) == (5, 1, 1, 1, 1)
    assert (select["all"], select["ISETP"], select["FSEL"],
            select["STG"]) == (3, 1, 1, 1)
