"""Hierarchical lane-gather probe on the card: the port of
``scripts/lanegather_probe.py``.

The TPU probe asks whether Mosaic's in-tile lane gather retires elements
fast enough to beat the one-hot select formulation of windowed sampling.
This module asks the card the same question with its own gathers:

[1] ``probe_primitive``: a dependent chain of in-row gathers (the
    ``chain_gather`` kernel, a warp-shuffle gather) against the compare +
    select + add chain (``chain_select``), ns per element;
[2] ``probe_hier``: at the JAX probe's four kernel-only fixtures, the
    windowed contraction as a register-tile shuffle gather on the
    transposed layout (``hier_gather``, counterpart of
    ``hier_gather_sample``) against the same contraction gathering each
    tap's window row directly (``win2d_contract``, counterpart of the
    one-hot kernel ``_onehot_reference``), checked against each other to
    1e-5 of the output's scale.

The lines keep the JAX probe's labels and fields, with the card's kernel
named in brackets; every time printed is the card's. Fixtures are made
with numpy from a seed, as the JAX probe makes them.
"""

from __future__ import annotations

import numpy as np
import torch

from snipper_tpu_torch.ops.lane_chain import chain_gather, chain_select
from snipper_tpu_torch.ops.win2d import hier_gather, win2d_contract
from snipper_tpu_torch.scripts.probe import _fail, time_fn

LANE = 128
# probe_hier's fixtures (NB, C, widths), ``lanegather_probe.py:255-258``
HIER_FIXTURES = ((25, 304, (896, 512, 384)),
                 (100, 80, (512, 384, 256)),
                 (25, 128, (1664, 768, 512)),
                 (80, 128, (1664, 768, 512)))


# ------------------------------------------------------------ primitive cost
def probe_primitive(K: int = 8, R: int = 512, n: int = 64, grid: int = 64,
                    device="cuda") -> dict:
    """ns/elem of a dependent in-row gather chain vs the equivalent
    compare+select+add chain, [R, 128] f32 rows, ``grid`` independent
    blocks x ``n`` chained ops each; a failed kernel's entry is None."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((grid, R, LANE))).float() \
        .to(device)
    idx = torch.from_numpy(rng.integers(0, LANE, (grid, R, LANE))) \
        .to(device, torch.int32)

    results = {}
    for name, fn, kernel in (("gather", chain_gather, "warp shuffle"),
                             ("select(3op)", chain_select,
                              "compare/select/add")):
        try:
            ms = time_fn(fn, x, idx, n, K=K)
            elems = grid * R * LANE * n
            ns = ms * 1e6 / elems
            results[name] = ns
            print(f"  primitive {name:12s}: {ms:7.3f} ms / {n} chained ops "
                  f"on {grid}x[{R},128] = {ns:.6f} ns/elem "
                  f"[{fn.__name__}, {kernel}]", flush=True)
        except Exception as e:  # noqa: BLE001 - reported, counted
            results[name] = None
            _fail(f"  primitive {name:12s}", e)
    if results.get("gather") and results.get("select(3op)"):
        print(f"  gather/select per-elem ratio: "
              f"{results['gather'] / results['select(3op)']:.2f}x "
              f"(win threshold < {LANE / 48:.2f}x at D=48)", flush=True)
    return results


# ------------------------------------------------- hierarchical gather kernel
def hier_gather_sample(wins, ids, wgts) -> torch.Tensor:
    """Kernel-only hierarchical gather: ``wins[l] [NB, BH, D, Wd]``
    (transposed, pre-staged), ``ids[l]/wgts[l] [NB, BH, n_taps, Cp]`` ->
    ``[NB, BH, D, Cp]`` f32 with
    ``out[..., :, c] = sum_l sum_k wgts[l][..., k, c] * wins[l][..., :, ids]``
    (the ``hier_gather`` kernel)."""
    return hier_gather(wins, ids, wgts)


def _fixture(NB: int, C: int, widths, BH: int = 32, D: int = 48,
             n_taps: int = 16, dtype=torch.float32, seed: int = 0,
             device="cuda"):
    """The JAX probe's kernel-only fixture, in both layouts (one-hot
    ``[Wd, D]`` / ids ``[C, 16]``; hierarchical transposed ``[D, Wd]`` /
    ids ``[16, Cp]``, queries padded to ``Cp`` with weight 0)."""
    rng = np.random.default_rng(seed)
    Cp = -(-C // LANE) * LANE
    wins, winsT, ids, idsT, wgts, wgtsT = [], [], [], [], [], []
    for Wd in widths:
        w = torch.from_numpy(
            rng.standard_normal((NB, BH, Wd, D)).astype(np.float32))
        i = torch.from_numpy(
            rng.integers(0, Wd, (NB, BH, C, n_taps)).astype(np.int32))
        g = torch.from_numpy(
            rng.uniform(0, 1, (NB, BH, C, n_taps)).astype(np.float32))
        w, i, g = w.to(device, dtype), i.to(device), g.to(device)
        ip = torch.zeros(NB, BH, Cp, n_taps, dtype=torch.int32, device=device)
        gp = torch.zeros(NB, BH, Cp, n_taps, dtype=torch.float32,
                         device=device)
        ip[:, :, :C] = i
        gp[:, :, :C] = g
        wins.append(w)
        winsT.append(w.transpose(2, 3).contiguous())
        ids.append(i)
        idsT.append(ip.transpose(2, 3).contiguous())
        wgts.append(g)
        wgtsT.append(gp.transpose(2, 3).contiguous())
    return wins, winsT, ids, idsT, wgts, wgtsT, Cp


def _onehot_reference(wins, ids, wgts) -> torch.Tensor:
    """The one-hot kernel's counterpart on the same data: the
    ``win2d_contract`` kernel, ``[NB, BH, C, D]`` f32."""
    return win2d_contract(wins, ids, wgts)


def probe_hier(K: int = 8, device="cuda") -> int:
    """Time the hierarchical gather at the kernel-only fixtures and print
    it next to the one-hot kernel's counterpart timed in the same run.
    Returns the number of parts that failed."""
    failed = 0
    for (NB, C, widths) in HIER_FIXTURES:
        wins, winsT, ids, idsT, wgts, wgtsT, Cp = _fixture(NB, C, widths,
                                                           device=device)
        sel_g = 32 * NB * C * 16 * sum(widths) / 1e9
        gat_g = 32 * NB * Cp * 16 * sum(w // LANE for w in widths) \
            * 48 / 1e9
        label = f"NB={NB} C={C} widths={widths}"

        try:
            ms1 = time_fn(_onehot_reference, wins, ids, wgts, K=K)
            print(f"  one-hot MXU kernel   {label}: {ms1:7.2f} ms "
                  f"({sel_g:.2f} G select-elems) "
                  f"[win2d_contract, direct row gather]", flush=True)
        except Exception as e:  # noqa: BLE001 - reported, counted
            ms1 = None
            failed += 1
            _fail(f"  one-hot MXU kernel   {label}", e)

        try:
            out = hier_gather_sample(winsT, idsT, wgtsT)
            if ms1 is not None:
                ref = _onehot_reference(wins, ids, wgts)
                got = out.transpose(2, 3)[:, :, :C]
                err = ((got - ref).abs().max()
                       / ref.abs().max().clamp_min(1e-9)).item()
                if not err < 1e-5:
                    raise RuntimeError(f"hier kernel wrong: relerr "
                                       f"{err:.2e}")
            ms2 = time_fn(hier_gather_sample, winsT, idsT, wgtsT, K=K)
            note = f" ({ms2 / ms1:.2f}x one-hot)" if ms1 else ""
            print(f"  hierarchical gather  {label}: {ms2:7.2f} ms "
                  f"({gat_g:.2f} G gather-elems){note} "
                  f"[hier_gather, register tile + warp shuffle]", flush=True)
        except Exception as e:  # noqa: BLE001 - reported, counted
            failed += 1
            _fail(f"  hierarchical gather  {label}", e)
        del wins, winsT, ids, idsT, wgts, wgtsT
    return failed


def run(K: int = 8, device="cuda") -> int:
    """Both parts of the probe; returns the number of parts that failed."""
    where = (torch.cuda.get_device_name(device)
             if torch.device(device).type == "cuda" else "cpu")
    print(f"lane-gather probe on {where}", flush=True)
    print("[1] primitive per-element cost, in-row lane gather vs "
          "compare/select/add:", flush=True)
    prim = probe_primitive(K=K, device=device)
    print("[2] kernel-only encoder-scale fixtures:", flush=True)
    return sum(v is None for v in prim.values()) + probe_hier(K=K,
                                                              device=device)
