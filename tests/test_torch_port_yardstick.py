"""``chip_smoke.py``'s library yardstick on the CPU: the arguments it builds
for one ``torch.nn.functional.embedding_bag(..., mode="sum")`` call
reproduce the plain versions of K5 (``win2d_contract_torch``), K4
(``hier_gather_torch``, up to the transpose), K2 (``win2d_sample_torch``
over an op call's query segments) and K1 (``ms_deform_attn_torch``, and
through the call's backward the plain VJP's d_value and d_attn) at tiny
fixtures. The port itself never calls ``embedding_bag``
(``test_torch_port_isolation.py``). This file imports nothing of JAX.
"""

import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from snipper_tpu_torch.ops import win2d
from snipper_tpu_torch.ops.deform_attn import (ms_deform_attn_windowed2d,
                                               windowed2d_plan)
from snipper_tpu_torch.ops.msda import (ms_deform_attn_torch,
                                        ms_deform_attn_torch_vjp)
from snipper_tpu_torch.scripts.lanegather_probe import _fixture

REPO = pathlib.Path(__file__).resolve().parent.parent
SHAPES = [(24, 32), (12, 16), (6, 8)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_imports_only_the_standard_library():
    """At module level chip_smoke.py imports no torch, numpy or port
    module: it must fail cleanly where they are missing."""
    code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
            "print(sorted(m for m in ('torch', 'numpy', 'snipper_tpu_torch')"
            " if m in sys.modules))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("outside", [False, True],
                         ids=["fixture", "ids_outside"])
def test_contract_bag_args_reproduce_k5_and_k4(outside):
    """One embedding_bag call over the levels' windows in one table gives
    ``win2d_contract_torch`` and, transposed, ``hier_gather_torch`` (its
    padded queries dropped), within 1e-5 of the output's largest value;
    ids outside ``[0, Wd)`` add nothing."""
    cs = _chip_smoke()
    wins, winsT, ids, idsT, wgts, wgtsT, Cp = _fixture(
        3, 70, (256, 128, 100), BH=4, D=16, device="cpu")
    if outside:
        rng = np.random.default_rng(3)
        for lvl, (i, iT) in enumerate(zip(ids, idsT)):
            bad = torch.from_numpy(rng.integers(-50, 400, i.shape)
                                   .astype(np.int32))
            keep = torch.from_numpy(rng.uniform(0, 1, i.shape) < 0.7)
            ids[lvl] = torch.where(keep, i, bad)
            iT[:, :, :, :70] = ids[lvl].transpose(2, 3)
    lib = cs.library_bag(*cs.contract_bag_args(wins, ids, wgts))
    want5 = win2d.win2d_contract_torch(wins, ids, wgts)
    want4 = win2d.hier_gather_torch(winsT, idsT, wgtsT)
    assert lib.shape == (3 * 4 * 70, 16)
    tol = 1e-5 * want5.abs().max().item()
    torch.testing.assert_close(lib.view(want5.shape), want5, rtol=0,
                               atol=tol)
    torch.testing.assert_close(lib.view(want5.shape),
                               want4.transpose(2, 3)[:, :, :70], rtol=0,
                               atol=tol)


def _segment_inputs(value_dtype, teleport):
    """Grid queries with offsets of up to 3.9 pixels on SHAPES; a
    teleported tap falls outside its window."""
    rng = np.random.default_rng(5)
    B, H, D, P, L = 2, 2, 8, 2, len(SHAPES)
    S = sum(h * w for h, w in SHAPES)
    refs = []
    for h, w in SHAPES:
        gy, gx = np.meshgrid((np.arange(h) + 0.5) / h,
                             (np.arange(w) + 0.5) / w, indexing="ij")
        refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
    norm = np.array([(w, h) for h, w in SHAPES], np.float64)
    off = rng.uniform(-3.9, 3.9, (B, S, H, L, P, 2))
    loc = (np.concatenate(refs, 0)[None, :, None, None, None, :]
           + off / norm[None, None, None, :, None, :]).astype(np.float32)
    if teleport:
        loc[1, 5, 1, 0, 0] = [0.97, 0.97]
    value = rng.standard_normal((B, S, H, D)).astype(np.float32)
    attn = rng.uniform(0, 1, (B, S, H, L, P)).astype(np.float32)
    return (torch.from_numpy(value).to(value_dtype), torch.from_numpy(loc),
            torch.from_numpy(attn))


@pytest.mark.parametrize("teleport", [False, True],
                         ids=["inside", "teleport"])
@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
def test_sample_bag_args_reproduce_k2(value_dtype, teleport):
    """One embedding_bag call over the value's global rows, the bags in
    the output's order, gives ``win2d_sample_torch`` over the three query
    segments (and the plain windowed2d op): f32 within 1e-5; with bf16
    rows and bf16 weights (as chip_smoke.py times it), within one bf16
    unit of the largest output."""
    cs = _chip_smoke()
    value, loc, attn = _segment_inputs(value_dtype, teleport)
    blocks, wins = windowed2d_plan(SHAPES, 6, 8, 5)
    segs = [h * w for h, w in SHAPES]
    taps, outs, q0 = [], [], 0
    for si, seg in enumerate(segs):
        taps.append(win2d.segment_taps(SHAPES, loc[:, q0:q0 + seg],
                                       attn[:, q0:q0 + seg], SHAPES[si],
                                       blocks[si], wins[si]))
        outs.append(win2d.win2d_sample_torch(value, SHAPES, taps[-1]))
        q0 += seg
    want = torch.cat(outs, 1)
    op, overflow = ms_deform_attn_windowed2d(value, SHAPES, loc, attn, segs,
                                             block_h=6, block_w=8,
                                             margin_px=5)
    assert (float(overflow) > 0) == teleport
    table, bags, wts = cs.sample_bag_args(value, SHAPES, taps)
    assert bags.dtype == torch.int32 and bags.shape == (2 * sum(segs) * 2,
                                                        3 * 4 * 2)
    lib = cs.library_bag(table, bags, wts.to(value.dtype)).view(want.shape)
    assert lib.dtype == value_dtype
    scale = max(1.0, want.float().abs().max().item())
    tol = 1e-5 if value_dtype == torch.float32 else 2.0 ** -7 * scale
    for ref in (want, op):
        assert (lib.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
def test_msda_bag_args_reproduce_k1(value_dtype):
    """One embedding_bag call over the value's rows, a bag of the L*P*4
    corner taps of each (n, q, h) with the corners off the map at weight
    0, gives ``ms_deform_attn_torch``: f32 within 1e-5; bf16 rows and
    weights (as chip_smoke.py times it) within 1e-2 of the largest output,
    its bf16 bar. The call's backward gives the plain VJP's d_value and,
    through the corner weights, its d_attn, within 1e-5 of each
    gradient's scale in f32 and 1e-2 in bf16."""
    cs = _chip_smoke()
    rng = np.random.default_rng(7)
    N, H, D, P, Lq, L = 2, 2, 8, 3, 11, len(SHAPES)
    S = sum(h * w for h, w in SHAPES)
    value = torch.from_numpy(rng.standard_normal((N, S, H, D)).astype(
        np.float32)).to(value_dtype)
    # locations in [-0.1, 1.1]: some corners fall off the map
    loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (N, Lq, H, L, P, 2))
                           .astype(np.float32))
    attn = torch.softmax(torch.from_numpy(rng.standard_normal(
        (N, Lq, H, L * P)).astype(np.float32)), -1).view(N, Lq, H, L, P)
    want = ms_deform_attn_torch(value, SHAPES, loc, attn)
    table, bags, wts = cs.msda_bag_args(value, SHAPES, loc, attn)
    assert bags.dtype == torch.int32 and bags.shape == (N * Lq * H,
                                                        L * P * 4)
    assert bool((wts == 0).any())
    bf16 = value_dtype == torch.bfloat16
    rel = 1e-2 if bf16 else 1e-5
    tbl = table.detach().requires_grad_(True)
    w = wts.to(value_dtype).detach().requires_grad_(True)
    lib = cs.library_bag(tbl, bags, w).view(want.shape)
    assert lib.dtype == value_dtype
    scale = max(1.0, want.float().abs().max().item())
    assert (lib.float() - want.float()).abs().max().item() <= rel * scale

    grad_out = torch.from_numpy(rng.standard_normal((N, Lq, H * D)).astype(
        np.float32)).to(value_dtype)
    d_value, _, d_attn = ms_deform_attn_torch_vjp(value, SHAPES, loc, attn,
                                                  grad_out)
    d_tbl, d_w = torch.autograd.grad(lib, (tbl, w), grad_out)
    for got, ref in ((d_tbl.view(value.shape), d_value),
                     (cs.msda_bag_attn_grad(d_w, SHAPES, loc), d_attn)):
        scale = max(1.0, ref.float().abs().max().item())
        assert (got.float() - ref.float()).abs().max().item() <= rel * scale
