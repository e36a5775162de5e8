"""Sampling-op probes on the card: the port of ``scripts/probe.py``'s
``op`` and ``lanegather`` subcommands, which time the sampling formulations
and the TPU kernels' questions at the JAX probe's own sizes.

    python -m snipper_tpu_torch.scripts.probe op \\
        --impls windowed,windowed2d,windowed2d_pallas,pmerged,pallas,core
    python -m snipper_tpu_torch.scripts.probe lanegather

Each prints the JAX probe's lines with the card's times, then ``DONE``.
``op`` samples at encoder scale (canonical 600x800 level shapes, 4 folded
frames, 8 heads of 48 channels, 4 points, bf16 value) and keeps the JAX
probe's impl names, so that a TPU line and an H100 line can be set side by
side. What each runs here:

  core                ``ms_deform_attn_torch`` (plain, ``grid_sample``)
  pallas              ``ms_deform_attn``: the ``msda_forward`` kernel
  pmerged, windowed,  plain PyTorch (``ops/deform_attn.py``)
  windowed2d
  windowed2d_pallas   ``ms_deform_attn_windowed2d_kernel``: the
                      ``win2d_sample`` kernel (``ops/win2d.py``)

``lanegather`` runs ``scripts/lanegather_probe.py``'s counterpart
(``lanegather_probe.run``). Timing is the JAX probe's method
(``scripts/probe.py:45-56``): K enqueued calls, best of ``repeats`` passes,
between two CUDA events where the JAX probe reads back a scalar (on the
CPU, the host clock). Like the JAX probe, an impl that raises prints a
``FAIL`` line and the sweep goes on; the probe then exits non-zero after
``DONE``. ``--device`` is ``cuda`` unless the CPU is asked for, and the
probe raises without a card. The JAX probe's other subcommands (forward,
train, split, serve, fast, meshscale) are not yet ported and are refused.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
import traceback

import numpy as np
import torch

NOT_PORTED = ("forward", "train", "split", "serve", "fast", "meshscale")


# ---------------------------------------------------------------- timing
def time_fn(fn, *args, K: int = 8, repeats: int = 2) -> float:
    """ms/call, best of ``repeats`` passes of K enqueued calls: CUDA events
    around the K calls when ``fn`` returns CUDA tensors, else the host
    clock."""
    out = fn(*args)            # build + warm
    first = out[0] if isinstance(out, (tuple, list)) else out
    best = float("inf")
    for _ in range(repeats):
        if first.is_cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(K):
                fn(*args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / K
        else:
            t0 = time.perf_counter()
            for _ in range(K):
                fn(*args)
            ms = (time.perf_counter() - t0) / K * 1e3
        best = min(best, ms)
    return best


# ------------------------------------------------------- shared fixtures
def encoder_inputs(seed: int = 0, max_off_px: float = 6.0, device="cuda"):
    """Encoder-scale sampling-op inputs, as ``scripts/probe.py:61-86`` makes
    them with numpy: canonical 600x800 level shapes, B_fold=4 (=batch*T),
    H=8, D=48, P=4, bf16 value, grid reference points + uniform random
    offsets <= max_off_px, f32 locations and weights."""
    rng = np.random.default_rng(seed)
    shapes = [(75, 100), (38, 50), (19, 25)]
    S = sum(h * w for h, w in shapes)
    B, H, D, P = 4, 8, 48, 4
    value = torch.from_numpy(rng.standard_normal((B, S, H, D))) \
        .to(torch.bfloat16)
    refs = []
    for (h, w) in shapes:
        gy, gx = np.meshgrid((np.arange(h) + 0.5) / h,
                             (np.arange(w) + 0.5) / w, indexing="ij")
        refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
    ref = np.concatenate(refs, 0)
    off = rng.uniform(-max_off_px, max_off_px, (B, S, H, len(shapes), P, 2))
    norm = np.array([(w, h) for h, w in shapes], np.float64)
    loc = ref[None, :, None, None, None, :] + off / norm[None, None, None,
                                                         :, None, :]
    loc = torch.from_numpy(loc).float()
    attn = torch.from_numpy(
        rng.uniform(0, 1, (B, S, H, len(shapes), P))).float()
    attn = attn / attn.sum((-1, -2), keepdim=True)
    return value.to(device), shapes, loc.to(device), attn.to(device)


# ---------------------------------------------------------- subcommands
def _op_fn(impl, value, shapes, segs, bc, margin):
    """``(fn(loc, attn), unpack)`` for one impl name of the sweep;
    ``unpack``: fn returns ``(out, overflow)``."""
    from snipper_tpu_torch.ops.deform_attn import (ms_deform_attn_pmerged,
                                                   ms_deform_attn_windowed,
                                                   ms_deform_attn_windowed2d)
    from snipper_tpu_torch.ops.msda import (ms_deform_attn,
                                            ms_deform_attn_torch)
    from snipper_tpu_torch.ops.win2d import ms_deform_attn_windowed2d_kernel

    part = functools.partial
    if impl == "core":
        return part(ms_deform_attn_torch, value, shapes), False
    if impl == "pmerged":
        return part(ms_deform_attn_pmerged, value, shapes,
                    query_chunk=bc), False
    if impl == "windowed":
        return part(ms_deform_attn_windowed, value, shapes,
                    query_segments=segs, base_chunk=bc,
                    margin_px=margin), True
    if impl == "windowed2d":
        return part(ms_deform_attn_windowed2d, value, shapes,
                    query_segments=segs, margin_px=margin), True
    if impl == "windowed2d_pallas":
        return part(ms_deform_attn_windowed2d_kernel, value, shapes,
                    query_segments=segs, margin_px=margin), True
    if impl == "pallas":
        return part(ms_deform_attn, value, shapes), False
    raise ValueError(f"unknown op impl {impl!r}")


def _fail(label, e):
    traceback.print_exc()
    print(f"{label}: FAIL {type(e).__name__}: {e}"[:160], flush=True)


def cmd_op(args) -> int:
    """Encoder-scale sampling-op timing over formulation, base chunk and
    margin; returns the number of impls that failed."""
    from snipper_tpu_torch.models.snipper import resolve_device
    from snipper_tpu_torch.ops.deform_attn import windowed_sampling_plan
    from snipper_tpu_torch.ops.msda import ms_deform_attn_torch

    value, shapes, loc, attn = encoder_inputs(
        max_off_px=args.max_off_px, device=resolve_device(args.device))
    segs = tuple(h * w for h, w in shapes)
    ref = ms_deform_attn_torch(value, shapes, loc, attn).float()
    scale = ref.abs().max()

    def relerr(out):
        return ((out.float() - ref).abs().max() / scale).item()

    failed = 0
    for impl in args.impls.split(","):
        for bc in (int(b) for b in args.base_chunk.split(",")):
            for margin in (int(m) for m in args.margin.split(",")):
                label = f"{impl} bc={bc} m={margin}"
                try:
                    fn, unpack = _op_fn(impl, value, shapes, segs, bc, margin)
                    out = fn(loc, attn)
                    ovf = 0.0
                    if unpack:
                        out, ovf_t = out
                        ovf = float(ovf_t)
                    ms = time_fn(
                        lambda l, a: (fn(l, a)[0] if unpack else fn(l, a)),
                        loc, attn, K=args.K)
                    _, qcs, wins = windowed_sampling_plan(shapes, bc, margin)
                    print(f"{label:28s}: {ms:7.2f} ms/op-call  "
                          f"relerr {relerr(out):.2e} overflow={ovf} "
                          f"windows={wins if impl.startswith('win') else '-'}",
                          flush=True)
                except Exception as e:  # noqa: BLE001 - reported, counted
                    failed += 1
                    _fail(f"{label:28s}", e)
                if impl in ("core", "pallas", "pmerged"):
                    break  # margin is a no-op for exact impls
            if impl in ("core", "pallas"):
                break      # base_chunk too
    return failed


def cmd_lanegather(args) -> int:
    """Hierarchical gather probe: the lane-chain primitives, then the
    register-tile shuffle gather against the direct row-gather contraction;
    returns the number of parts that failed."""
    from snipper_tpu_torch.models.snipper import resolve_device
    from snipper_tpu_torch.scripts import lanegather_probe

    return lanegather_probe.run(K=args.K, device=resolve_device(args.device))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    o = sub.add_parser("op")
    o.add_argument("--impls", default="windowed,core")
    o.add_argument("--base_chunk", default="512")
    o.add_argument("--margin", default="5")
    o.add_argument("--max_off_px", type=float, default=4.0)
    o.add_argument("-K", type=int, default=8)
    o.add_argument("--device", default="cuda")
    o.set_defaults(fn=cmd_op)

    lg = sub.add_parser("lanegather")
    lg.add_argument("-K", type=int, default=8)
    lg.add_argument("--device", default="cuda")
    lg.set_defaults(fn=cmd_lanegather)

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        p.error(f"subcommand {argv[0]!r} is not yet ported to "
                f"snipper_tpu_torch (ROADMAP A9); the JAX probe "
                f"scripts/probe.py runs it")
    args = p.parse_args(argv)
    with torch.inference_mode():
        failed = args.fn(args)
    print("DONE", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
