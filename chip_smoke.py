#!/usr/bin/env python3
"""Smoke run of the PyTorch port (snipper_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from this checkout's sources (nvcc, one process
   per source, all started together); print each kernel's registers,
   static shared memory and spills from ptxas's report.
3. Hold each kernel against its plain PyTorch version on the card, TF32
   off, at a tiny shape with off-map locations and at the shapes the main
   paths give it (``msda_forward`` at the inference and the train shapes,
   ``msda_backward`` against the plain VJP at the train shapes), f32 and
   bf16 value; time both with CUDA events beside the kernel's bound, and
   print the per-shape times.
4. Drive the inference path: ``snipper_tpu_torch.cli.infer`` on
   canonical_t4 (full width and depth, 600x800, seeded random weights with
   perturbed sampling projections) over synthetic JPEG frames. Kernel
   launch counts are set to 0 just before and read just after. Then check
   the output: finite, expected shapes, and the same forward with the
   plain MSDA (and the tiny model on the CPU) agreeing within the stated
   tolerances. Then the same serving run with ``--device_preprocess``
   (uint8 frames uploaded from pinned memory, warped on the card), counts
   set to 0 just before and read just after; one snippet's host decode,
   host warp, upload and device warp timed apart; the card's warp held
   against the host warp and the port's CPU warp, and the forward on the
   device-warped input against the forward on the host-warped input.
   Then the serving profiles and the artifact: ``cli.infer --fast
   enc4,p2,r480 --device_preprocess`` (counts at 0 just before, read just
   after: 10 launches per snippet; snippets/s; the profile's forward
   against the same forward with the plain MSDA), ``probe fast`` with its
   default specs (exit 0, no FAIL), the f32 canonical_t4 export on the
   card saved and loaded in a subprocess that imports only torch and the
   MSDA operators (12 launches per call, the live model's outputs within
   1e-5), and the ``probe serve`` lines.
5. Drive the training path: ``snipper_tpu_torch.cli.train`` on
   canonical_t4_f2 (full width and depth), batch 2, bf16 mixed precision,
   a few steps over the synthetic dataset, then its checkpoint and its
   evaluation; counts set to 0 just before and read just after. Check the
   launches per step, the checkpoint and finite losses. Then drive
   ``snipper_tpu_torch.cli.eval`` on that checkpoint (4 synthetic batches
   of 2, ``--save_vis --write_posetrack``; counts at 0 just before, read
   just after): launches per batch, finite ``eval_stats.json``, the
   renders, ms per eval batch. Then the PoseTrack18 and COCO harnesses on
   perfect predictions: AP 100 and MOTA 100.
   Then training and eval from reference-format files: a PoseTrack18-format
   set (two videos, 1280x720 and 1920x1080) written and extracted with the
   port's ``preprocess.posetrack``; the card's train warp held against the
   host ``warp_patch`` on one loader batch and timed;
   ``cli.train --posetrack_dir --device_preprocess`` for a few steps and
   one eval (counts at 0 just before, read just after: launches per step
   and per eval batch, finite losses, the checkpoint, the busy share of
   one profiled step from raw frames), the same with the host warp (step
   time, the loader's host decode and warp), and ``cli.eval`` with the
   PoseTrack harness on the checkpoint (launches per batch, finite stats
   with the ``posetrack_ap_*`` keys, ms per batch). Then ``cli.train
   --profile_dir`` for 4 steps (counts at 0 just before, read just after;
   the trace's summary names both MSDA kernels with device time, and the
   matching's host span), and ``cli.dump_labels`` on the PoseTrack18-format
   val split (one pickle entry per sample, the ``--vis 2`` renders).
   Then the multi-GPU paths on this one card (right, not scaling): an f32
   canonical_t4_f2 step (dropout 0, TF32 off) on two gloo ranks of
   cuda:0, data-parallel (batch 1 a rank) and tensor-parallel (4 heads a
   rank), each against one process's batch-2 step on the same weights
   (loss, every gradient, the matching; 12 launches of each MSDA kernel
   per rank and step, counts at 0 just before and read just after), with
   each rank's step time and the gradient all-reduce's time;
   ``cli.train`` (3 bf16 steps and a checkpoint) and ``cli.infer
   --data_parallel`` through ``torchrun --standalone --nproc_per_node 1``
   (NCCL), the tracks against the first serving run's; ``cli.infer``'s
   serving function on two gloo ranks of cuda:0, the same tracks; ``probe
   meshscale`` (exit 0, no FAIL).
6. Hold one f32 train step (dropout 0) with the kernels against the same
   step with the plain MSDA forward and VJP on the card, TF32 off.
7. Hold the sampling probes' kernels against their plain versions on the
   card, TF32 off, at a tiny shape and at the JAX probe's full shapes:
   ``win2d_sample`` against the plain windowed2d (f32 and bf16 value at
   the encoder fixture, and a teleported tap, with equal overflow counts),
   ``win2d_contract`` and ``hier_gather`` at the four kernel-only
   fixtures, ``chain_gather`` and ``chain_select`` bitwise; time each
   kernel alone (per call and device time) beside its plain version and
   its bound, K2, K4 and K5 beside one ``embedding_bag`` call that
   computes their function (checked against the plain version), and K3
   beside the time its shuffles or instructions take at the SM clock that
   ``nvidia-smi`` reads while it runs.
8. Drive the probe path: ``snipper_tpu_torch.scripts.probe op`` (all six
   impls) and ``probe lanegather`` through ``main``, counts set to 0 just
   before each and read just after; check the exit code, that no line
   says FAIL, and the ``windowed2d_pallas`` line's overflow and error.
9. Print one JSON line of kernel numbers, then the card's name and power
   limit, then, as the last line, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and f32 rate off the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# Tolerances of the kernels against the plain versions. f32: 1e-5 (the
# kernels compute coordinates and corner weights in grid_sample's steps, so
# only the order of the f32 sums differs). bf16 value: the output is
# rounded once to bf16 (8 bits of mantissa): 1e-2 of the largest output.
TOL_F32 = 1e-5
TOL_BF16_REL = 1e-2
# msda_backward against the plain VJP, f32: each gradient within 1e-5 of
# the largest of that gradient (at least 1). d_value is summed with f32
# atomics in an order that changes from run to run, and d_loc carries the
# level's width (up to 100) as a factor, so the bound is relative. With a
# bf16 value, d_loc and d_attn are f32 sums of the same bf16 inputs (same
# bound); the kernel's d_value is f32, the plain VJP's is rounded once to
# bf16 (TOL_BF16_REL).
TOL_BWD_REL = 1e-5
# Full canonical_t4 forward, kernel vs plain MSDA on the card (TF32 off):
# f32 sums in another order through 12 layers.
TOL_FORWARD = 1e-3
# Tiny model: CUDA (kernel) vs CPU (plain), TF32 off.
TOL_TINY_MODEL = 1e-4
# The inference warp on the card against the numpy host warp (f64
# coordinates there, f32 here: the JAX package's test tolerance) and
# against the port's same warp on the CPU (f32 sums of the same terms).
TOL_WARP_HOST = 2e-3
TOL_WARP_CPU = 1e-5
# Kernels against plain versions that round one f32 sum once to bf16, in
# another order: one bf16 unit (2^-7 of a value's magnitude) of the
# largest output.
BF16_UNIT = 2.0 ** -7
# The probe's relerr of the bf16 windowed2d_pallas line against core: one
# bf16 unit of the largest output, plus f32 roundoff.
TOL_PROBE_RELERR = 8e-3
# The lane chains: bitwise (+1 and x + x round the same everywhere).
# win2d_contract and hier_gather: 1e-5 of the output's largest value (the
# JAX probe's bar).
TOL_CONTRACT_REL = 1e-5
PROBE_OP_IMPLS = "windowed,windowed2d,windowed2d_pallas,pmerged,pallas,core"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn()``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_report(build_log, nvcc):
    """Per kernel of an ``nvcc -Xptxas -v`` log: registers per thread,
    static shared memory bytes, spill stores and loads (bytes). Kernels
    are named by the CUDA toolkit's ``cu++filt`` beside ``nvcc``, or by
    their mangled names where the toolkit has none."""
    mangled = re.findall(r"Compiling entry function '(\w+)'", build_log)
    names = dict(zip(mangled, mangled))
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if mangled and os.path.exists(filt):
        proc = subprocess.run([filt, "-p", *mangled], capture_output=True,
                              text=True, timeout=60)
        out = proc.stdout.splitlines()
        if proc.returncode == 0 and len(out) == len(mangled):
            names.update(zip(mangled, out))
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out.setdefault(names[m.group(1)], {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def profiled_kernels(fn, reps=1, need=("",), tries=3):
    """The device kernels (torch.profiler's ``key_averages``, with time on
    the card) of ``reps`` calls of ``fn``. The profile is taken again when
    a name in ``need`` matches none of them, as happens when the profiler
    drops a run's device events; after ``tries`` profiles the check fails,
    so that no number is reported that the run did not measure."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # device-side kernels only: the host ops that launch them carry
        # the same time again, and so do user-annotated ranges on the
        # device (AdamW's "Optimizer.step") over kernels counted already
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.self_device_time_total > 0]
        missing = [n for n in need if not any(n in e.key for e in kernels)]
        if not missing:
            return kernels
    check(False, f"torch.profiler recorded no kernel named {missing} in "
          f"{tries} profiles")


def device_ms(fn, kernel, reps=10):
    """The device time of the kernels whose names hold ``kernel``, per call
    of ``fn`` (torch.profiler): the kernel alone, without the host's launch
    and allocation time that ``time_ms`` also sees at small shapes."""
    import torch

    fn()
    torch.cuda.synchronize()
    us = sum(e.self_device_time_total
             for e in profiled_kernels(fn, reps, need=(kernel,))
             if kernel in e.key)
    return us / 1e3 / reps


def sm_clock_mhz(fn, seconds=1.5):
    """The SM clock (MHz) that ``nvidia-smi`` reads every 100 ms while
    ``fn`` runs back to back for about ``seconds``: the median reading."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    readings = [float(v) for v in out.split() if re.fullmatch(r"[\d.]+", v)]
    check(readings, "nvidia-smi read no SM clock")
    return statistics.median(readings)


def set_tf32(enabled):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


# --------------------------------------------------------------- MSDA inputs
def msda_inputs(N, shapes, H, D, Lq, P, grid_queries, seed, off_px=4.0):
    """value [N, S, H, D], loc [N, Lq, H, L, P, 2], attn [N, Lq, H, L, P] on
    the card. ``grid_queries``: encoder-style queries on the pixel grid of
    every level with offsets of up to ``off_px`` pixels; otherwise uniform
    locations in [-0.1, 1.1] (corners fall off the map)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    value = torch.randn(N, S, H, D, device="cuda", generator=g)
    if grid_queries:
        refs = []
        for h, w in shapes:
            gy, gx = torch.meshgrid(
                (torch.arange(h, device="cuda") + 0.5) / h,
                (torch.arange(w, device="cuda") + 0.5) / w, indexing="ij")
            refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        ref = torch.cat(refs, 0)[:Lq]                          # [Lq, 2]
        norm = torch.tensor([[w, h] for h, w in shapes], device="cuda",
                            dtype=torch.float32)
        off = (torch.rand(N, Lq, H, L, P, 2, device="cuda", generator=g)
               * 2 - 1) * off_px
        loc = ref[None, :, None, None, None, :] + off / norm[:, None, :]
    else:
        loc = torch.rand(N, Lq, H, L, P, 2, device="cuda",
                         generator=g) * 1.2 - 0.1
    logits = torch.randn(N, Lq, H, L * P, device="cuda", generator=g)
    attn = (torch.softmax(logits, -1) / 3).reshape(N, Lq, H, L, P)
    return value, loc.contiguous(), attn.contiguous()


def msda_bound_ms(value, shapes, loc, attn, backward=False):
    """Least time for the work these inputs need: the bytes of the value
    rows the taps touch (distinct in-map corner rows), loc and attn read
    once and the output written once, over the HBM rate; and the
    operations (per tap and channel 4 corner and 1 attention multiply-adds,
    plus ~20 per tap for coordinates and weights) over the f32 rate.
    ``backward``: the VJP instead, which also reads grad_out [N, Lq, H*D]
    once and writes d_value [N, S, H, D] (f32) whole, d_loc and d_attn
    once, at per tap and channel 8 multiply-adds (the four corner dots
    v_c.g, from which d_attn and d_loc are per-tap combinations, and the
    four scatter products w_c*a*g; the atomic adds are memory traffic, in
    the bytes), plus ~30 per tap. Returns (ms, "bytes" or "operations",
    bytes, ops)."""
    import torch

    N, S, H, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    rows = []
    start = 0
    n_idx = torch.arange(N, device=loc.device)[:, None, None, None]
    h_idx = torch.arange(H, device=loc.device)[None, None, :, None]
    for lvl, (h, w) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0 = torch.floor(x).long()
        y0 = torch.floor(y).long()
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                r = ((n_idx * S + start + yi * w + xi) * H + h_idx)[ok]
                rows.append(r)
        start += h * w
    n_rows = torch.unique(torch.cat(rows)).numel()
    esize = value.element_size()
    nbytes = (n_rows * D * esize + loc.numel() * 4 + attn.numel() * 4
              + N * Lq * H * D * esize)
    taps = attn.numel()
    ops = taps * (10 * D + 20)
    if backward:
        # + d_value (whole, f32), d_loc, d_attn written
        nbytes += value.numel() * 4 + loc.numel() * 4 + attn.numel() * 4
        ops = taps * (16 * D + 30)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


CANONICAL = [(75, 100), (38, 50), (19, 25)]  # 600x800 at strides 8/16/32
# the shapes canonical_t4_f2 at batch 2 gives the kernels in training:
# encoder N = B*T = 8, decoder N = B*(T+Tf) = 12
TRAIN_CASES = [
    ("train_encoder", 8, CANONICAL, 8, 48, 9875, 4, True),
    ("train_decoder", 12, CANONICAL, 8, 48, 60, 4, False),
]
# the same steps with the heads cut over two ranks (cli.train --tp_size 2):
# each rank's kernels run H = 4 heads of 48 channels
TP2_CASES = [
    ("train_encoder_tp2", 8, CANONICAL, 4, 48, 9875, 4, True),
    ("train_decoder_tp2", 12, CANONICAL, 4, 48, 60, 4, False),
]


def phase_kernels():
    """msda_forward vs plain version at the tiny, inference encoder and
    decoder, and train encoder and decoder shapes, the last two also at
    the 4 heads of a tensor-parallel rank."""
    import torch

    from snipper_tpu_torch.ops.msda import ms_deform_attn_torch, msda_forward

    canonical = CANONICAL
    cases = [
        # name, N, shapes, H, D, Lq, P, grid queries
        ("tiny", 2, [(6, 9), (3, 5), (2, 2)], 4, 8, 37, 3, False),
        ("encoder", 4, canonical, 8, 48, 9875, 4, True),
        ("decoder", 4, canonical, 8, 48, 60, 4, False),
    ] + TRAIN_CASES + TP2_CASES
    set_tf32(False)
    res = {}
    tol = TOL_F32
    for i, (name, N, shapes, H, D, Lq, P, grid) in enumerate(cases):
        value, loc, attn = msda_inputs(N, shapes, H, D, Lq, P, grid, seed=i)
        got = msda_forward(value, shapes, loc, attn)
        want = ms_deform_attn_torch(value, shapes, loc, attn)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(math.isfinite(err) and err <= tol,
              f"msda_forward f32 {name}: max abs diff {err} > {tol}")
        vb = value.to(torch.bfloat16)
        got_b = msda_forward(vb, shapes, loc, attn)
        want_b = ms_deform_attn_torch(vb, shapes, loc, attn)
        err_b = (got_b.float() - want_b.float()).abs().max().item()
        tol_b = TOL_BF16_REL * max(1.0, want_b.float().abs().max().item())
        check(got_b.dtype == torch.bfloat16 and err_b <= tol_b,
              f"msda_forward bf16 {name}: max abs diff {err_b} > {tol_b}")
        ms = time_ms(lambda: msda_forward(value, shapes, loc, attn))
        plain_ms = time_ms(lambda: ms_deform_attn_torch(value, shapes, loc,
                                                        attn))
        ms_b = time_ms(lambda: msda_forward(vb, shapes, loc, attn))
        dev = device_ms(lambda: msda_forward(value, shapes, loc, attn),
                        "msda_forward")
        dev_b = device_ms(lambda: msda_forward(vb, shapes, loc, attn),
                          "msda_forward")
        bound, by, nbytes, ops = msda_bound_ms(value, shapes, loc, attn)
        bound_b = msda_bound_ms(vb, shapes, loc, attn)[0]
        res[name] = dict(N=N, Lq=Lq, H=H, D=D, L=len(shapes), P=P,
                         max_abs_err=err, tol=tol, bf16_max_abs_err=err_b,
                         bf16_tol=tol_b, ms=ms, plain_ms=plain_ms,
                         bf16_ms=ms_b, device_ms=dev, bf16_device_ms=dev_b,
                         bound_ms=bound, bound_by=by,
                         bf16_bound_ms=bound_b, bytes=nbytes, ops=ops)
        log(f"msda_forward {name}: N={N} Lq={Lq} H={H} D={D} L={len(shapes)}"
            f" P={P}: f32 max|diff| {err:.3e} (tol {tol:g}), bf16 max|diff|"
            f" {err_b:.3e} (tol {tol_b:.3g}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bf16 kernel {ms_b:.4f} ms (device time "
            f"alone {dev:.4f}, bf16 {dev_b:.4f} ms); bound "
            f"{bound * 1e3:.2f} us by {by} ({nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.3f} GFLOP); no single PyTorch call computes MSDA "
            f"(library_ms null)")
        del value, loc, attn, vb, got, want, got_b, want_b
    torch.cuda.empty_cache()
    return res


def _grad_errors(got, want, bf16=False):
    """Max |diff| of (d_value, d_loc, d_attn) and each one's tolerance."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(1.0, w.float().abs().max().item())
        tol = (TOL_BF16_REL if bf16 and i == 0 else TOL_BWD_REL) * scale
        out.append(((g.float() - w.float()).abs().max().item(), tol))
    return out


def phase_backward():
    """msda_backward vs the plain VJP at the tiny and the train shapes (8
    heads, and the 4 of a tensor-parallel rank), f32 and bf16 value;
    times of the kernel and of the plain backward (autograd through
    grid_sample, its graph built once)."""
    import torch

    from snipper_tpu_torch.ops.msda import (ms_deform_attn_torch,
                                            ms_deform_attn_torch_vjp,
                                            msda_backward)

    cases = [("tiny", 2, [(6, 9), (3, 5), (2, 2)], 4, 8, 37, 3, False)] \
        + TRAIN_CASES + TP2_CASES
    set_tf32(False)
    res = {}
    names = ("d_value", "d_loc", "d_attn")
    for i, (name, N, shapes, H, D, Lq, P, grid) in enumerate(cases):
        value, loc, attn = msda_inputs(N, shapes, H, D, Lq, P, grid,
                                       seed=10 + i)
        g = torch.Generator(device="cuda").manual_seed(20 + i)
        grad_out = torch.randn(N, Lq, H * D, device="cuda", generator=g)
        row = dict(N=N, Lq=Lq, H=H, D=D, L=len(shapes), P=P)
        for dt in (torch.float32, torch.bfloat16):
            v, go = value.to(dt), grad_out.to(dt)
            got = msda_backward(v, shapes, loc, attn, go)
            want = ms_deform_attn_torch_vjp(v, shapes, loc, attn, go)
            torch.cuda.synchronize()
            check(all(t.dtype == torch.float32 for t in got),
                  f"msda_backward {name}: output dtypes "
                  f"{[t.dtype for t in got]}")
            errs = _grad_errors(got, want, bf16=dt == torch.bfloat16)
            tag = "f32" if dt == torch.float32 else "bf16"
            for n_, (err, tol) in zip(names, errs):
                check(math.isfinite(err) and err <= tol,
                      f"msda_backward {tag} {name} {n_}: max abs diff "
                      f"{err} > {tol}")
            row[tag] = {n_: {"max_abs_err": e, "tol": t}
                        for n_, (e, t) in zip(names, errs)}
            row[f"{tag}_ms"] = time_ms(
                lambda: msda_backward(v, shapes, loc, attn, go))
            row[f"{tag}_device_ms"] = device_ms(
                lambda: msda_backward(v, shapes, loc, attn, go),
                "msda_backward")
            with torch.enable_grad():
                vr, lr, ar = (t.detach().requires_grad_(True)
                              for t in (v, loc, attn))
                out = ms_deform_attn_torch(vr, shapes, lr, ar)
                row[f"{tag}_plain_ms"] = time_ms(
                    lambda: torch.autograd.grad(out, (vr, lr, ar), go,
                                                retain_graph=True), reps=10)
            del out, vr, lr, ar
            bound, by, nbytes, ops = msda_bound_ms(v, shapes, loc, attn,
                                                   backward=True)
            row.update({f"{tag}_bound_ms": bound, f"{tag}_bound_by": by,
                        f"{tag}_bytes": nbytes, f"{tag}_ops": ops})
            log(f"msda_backward {name} {tag}: N={N} Lq={Lq} H={H} D={D} "
                f"L={len(shapes)} P={P}: max|diff| "
                + ", ".join(f"{n_} {e:.3e} (tol {t:.3g})"
                            for n_, (e, t) in zip(names, errs))
                + f"; kernel {row[f'{tag}_ms']:.4f} ms (device time alone "
                f"{row[f'{tag}_device_ms']:.4f} ms), plain backward "
                f"{row[f'{tag}_plain_ms']:.4f} ms; bound {bound * 1e3:.2f}"
                f" us by {by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} "
                f"GFLOP); no single PyTorch call computes the MSDA VJP "
                f"(library_ms null)")
            del got, want
        res[name] = row
        del value, loc, attn, grad_out
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------- the sampling probes' kernels
def _bound(nbytes, ops):
    """(ms, "bytes" or "operations") of the least time for ``nbytes`` over
    the HBM rate and ``ops`` over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def win2d_bound_ms(value, shapes, taps_list):
    """Least time for ``win2d_sample`` over a whole op call: each
    segment's ids, weights and anchors read once, the distinct value rows
    that live taps touch read once, the output written once; 2 flops per
    live tap and channel. Returns (ms, by, bytes, ops)."""
    import torch

    from snipper_tpu_torch.ops.win2d import window_rows

    B, S, H, D = value.shape
    rows, nbytes, live_taps = [], 0, 0
    for taps in taps_list:
        nbytes += sum(t.numel() * 4 for t in taps.ids + taps.wgts)
        nbytes += taps.anchors.numel() * 4
        for lvl in range(len(shapes)):
            r, in_win = window_rows(value.shape, shapes, taps, lvl)
            live = in_win & (taps.wgts[lvl] != 0)
            rows.append(r[live])
            live_taps += int(live.sum())
        hs, ws = taps.seg_shape
        nbytes += B * hs * ws * H * D * value.element_size()
    n_rows = torch.unique(torch.cat(rows)).numel()
    nbytes += n_rows * D * value.element_size()
    ops = 2 * D * live_taps
    return (*_bound(nbytes, ops), nbytes, ops)


def contract_bound_ms(ids, wgts, D, io_bytes):
    """Least time for ``win2d_contract`` or ``hier_gather`` on one fixture:
    the distinct window rows (D f32 channels each) that live taps touch,
    read once, plus ``io_bytes`` (ids and weights as the kernel takes them,
    and its output); 2 flops per live tap and channel. ``ids``/``wgts``
    per level in K5's layout [NB, BH, C, K]. Returns (ms, by, bytes,
    ops)."""
    import torch

    touched, live_taps = 0, 0
    for i, g in zip(ids, wgts):
        NB, BH = i.shape[:2]
        blk = torch.arange(NB * BH, device=i.device).view(NB, BH, 1, 1)
        live = g != 0
        touched += torch.unique((blk * (1 << 20) + i)[live]).numel()
        live_taps += int(live.sum())
    nbytes = touched * D * 4 + io_bytes
    ops = 2 * D * live_taps
    return (*_bound(nbytes, ops), nbytes, ops)


# ---- the library yardstick of K2, K4 and K5: one embedding_bag call
def contract_bag_args(wins, ids, wgts):
    """``embedding_bag``'s arguments for ``win2d_contract``'s function (and
    ``hier_gather``'s, up to the transpose): one table of every level's
    windows ``[sum_l NB*BH*Wd_l, D]``, and per query, in K5's
    ``[NB, BH, C]`` order, a bag of its ``L*K`` taps with ids offset by
    level and by (nb, bh); an id outside ``[0, Wd_l)`` names row 0 with
    weight 0. Returns ``(table, bags [NB*BH*C, L*K] int32, weights)``."""
    import torch

    NB, BH, C, _ = ids[0].shape
    D = wins[0].shape[-1]
    blk = torch.arange(NB * BH, device=ids[0].device).view(NB, BH, 1, 1)
    bags, weights, base = [], [], 0
    for w, i, g in zip(wins, ids, wgts):
        Wd = w.shape[2]
        ok = (i >= 0) & (i < Wd)
        bags.append(base + blk * Wd + torch.where(ok, i.long(), 0))
        weights.append(torch.where(ok, g, 0.0))
        base += NB * BH * Wd
    table = torch.cat([w.reshape(-1, D) for w in wins])
    return (table, torch.cat(bags, -1).reshape(NB * BH * C, -1).int(),
            torch.cat(weights, -1).reshape(NB * BH * C, -1))


def sample_bag_args(value, shapes, taps_list):
    """``embedding_bag``'s arguments for ``win2d_sample``'s function over
    the query segments of one op call: the table is the value's rows
    ``[B*S*H, D]``, each tap names its global row (``window_rows``) with
    weight 0 outside its window, and the bags (``L*K`` taps each) come in
    the output's ``[B, Lq, H]`` order, so that the call's ``[B*Lq*H, D]``
    is the op's ``[B, Lq, H*D]``. Returns ``(table, bags int32,
    weights)``."""
    import torch

    from snipper_tpu_torch.ops.win2d import _blocks_to_queries, window_rows

    B, S, H, D = value.shape
    bags, weights = [], []
    for taps in taps_list:
        rows, wgts = [], []
        for lvl in range(len(shapes)):
            r, in_win = window_rows(value.shape, shapes, taps, lvl)
            rows.append(r)
            wgts.append(torch.where(in_win, taps.wgts[lvl], 0.0))
        for out, parts in ((bags, rows), (weights, wgts)):
            t = torch.cat(parts, -1)                    # [NB, BH, C, L*K]
            t = _blocks_to_queries(t, B, H, taps.seg_shape, taps.block)
            out.append(t.reshape(B, -1, H, t.shape[-1] // H))
    LK = bags[0].shape[-1]
    return (value.reshape(-1, D), torch.cat(bags, 1).reshape(-1, LK).int(),
            torch.cat(weights, 1).reshape(-1, LK))


def library_bag(table, bags, weights):
    """The yardstick: one ``embedding_bag(..., mode="sum")`` call."""
    import torch.nn.functional as F

    return F.embedding_bag(bags, table, per_sample_weights=weights,
                           mode="sum")


def phase_windowed_kernels():
    """win2d_sample against the plain windowed2d (tiny grid fixture, the
    probe's encoder fixture with a bf16 and an f32 value, and a teleported
    tap), win2d_contract and hier_gather against the gather-and-sum of
    their definition at the four probe_hier fixtures, chain_gather and
    chain_select bitwise at the probe's 64 x [512, 128], n = 64. K2, K4
    and K5 are timed beside one ``embedding_bag`` call that computes their
    function, checked against the plain version within the kernel's
    tolerance."""
    import torch

    from snipper_tpu_torch.ops import lane_chain, win2d
    from snipper_tpu_torch.ops.deform_attn import (ms_deform_attn_windowed2d,
                                                   windowed2d_plan)
    from snipper_tpu_torch.scripts import lanegather_probe, probe

    set_tf32(False)
    res = {"win2d_sample": {}, "win2d_contract": {}, "hier_gather": {},
           "chain_gather": {}, "chain_select": {}}

    # ---- K2: the kernel path vs the plain windowed2d ---------------------
    tiny_shapes = [(24, 32), (12, 16), (6, 8)]
    tiny = msda_inputs(2, tiny_shapes, 2, 8, sum(h * w for h, w in
                                                 tiny_shapes), 2, True,
                       seed=30, off_px=3.9)
    enc_value, enc_shapes, enc_loc, enc_attn = probe.encoder_inputs(
        max_off_px=4.0, device="cuda")
    teleported = enc_loc.clone()
    teleported[0, 5, 0, 0, 0] = torch.tensor([0.97, 0.97])
    cases = [
        ("tiny", tiny[0], tiny_shapes, tiny[1], tiny[2], (6, 8)),
        ("encoder_bf16", enc_value, enc_shapes, enc_loc, enc_attn, (8, 20)),
        ("encoder_f32", enc_value.float(), enc_shapes, enc_loc, enc_attn,
         (8, 20)),
        ("encoder_teleported_tap", enc_value.float(), enc_shapes, teleported,
         enc_attn, (8, 20)),
    ]
    for name, value, shapes, loc, attn, block in cases:
        segs = [h * w for h, w in shapes]
        kw = dict(block_h=block[0], block_w=block[1], margin_px=5)
        got, got_ov = win2d.ms_deform_attn_windowed2d_kernel(
            value, shapes, loc, attn, segs, **kw)
        want, want_ov = ms_deform_attn_windowed2d(value, shapes, loc, attn,
                                                  segs, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        bf16 = value.dtype == torch.bfloat16
        tol = BF16_UNIT * scale if bf16 else TOL_F32
        check(got.dtype == value.dtype and math.isfinite(err) and err <= tol,
              f"win2d_sample {name}: max abs diff {err} > {tol}")
        check(float(got_ov) == float(want_ov),
              f"win2d_sample {name}: overflow {float(got_ov)} vs plain "
              f"{float(want_ov)}")
        check((float(got_ov) > 0) == (name == "encoder_teleported_tap"),
              f"win2d_sample {name}: overflow {float(got_ov)}")
        row = dict(dtype=str(value.dtype).replace("torch.", ""),
                   max_abs_err=err, tol=tol, overflow=float(got_ov),
                   plain_overflow=float(want_ov))
        if name.startswith("encoder_") and "teleported" not in name:
            blocks, wins = windowed2d_plan(shapes, *block, 5)
            taps, q0 = [], 0
            for si, seg in enumerate(segs):
                taps.append(win2d.segment_taps(
                    shapes, loc[:, q0:q0 + seg], attn[:, q0:q0 + seg],
                    shapes[si], blocks[si], wins[si]))
                q0 += seg
            row["ms"] = time_ms(lambda: [win2d.win2d_sample_cuda(
                value, shapes, t) for t in taps])
            row["device_ms"] = device_ms(lambda: [win2d.win2d_sample_cuda(
                value, shapes, t) for t in taps], "win2d_sample_kernel")
            # the yardstick, with the weights in the value's dtype, as
            # embedding_bag takes them (JAX rounds them to bf16 too)
            table, bags, wts = sample_bag_args(value, shapes, taps)
            wts = wts.to(value.dtype)
            lib = library_bag(table, bags, wts)
            lib_err = (lib.float().view(want.shape) - want.float()).abs() \
                .max().item()
            check(math.isfinite(lib_err) and lib_err <= tol,
                  f"embedding_bag yardstick of win2d_sample {name}: max abs "
                  f"diff {lib_err} > {tol}")
            row["library_max_abs_err"] = lib_err
            row["library_ms"] = time_ms(lambda: library_bag(table, bags,
                                                            wts))
            del table, bags, wts, lib
            row["op_call_ms"] = time_ms(
                lambda: win2d.ms_deform_attn_windowed2d_kernel(
                    value, shapes, loc, attn, segs, **kw))
            row["plain_ms"] = time_ms(
                lambda: ms_deform_attn_windowed2d(value, shapes, loc, attn,
                                                  segs, **kw), reps=10)
            (row["bound_ms"], row["bound_by"], row["bytes"],
             row["ops"]) = win2d_bound_ms(value, shapes, taps)
            row["launches_per_op_call"] = len(taps)
            del taps
        res["win2d_sample"][name] = row
        log(f"win2d_sample {name}: max|diff| {err:.3e} (tol {tol:.3g}), "
            f"overflow {float(got_ov)} (plain {float(want_ov)})"
            + (f"; kernel {row['ms']:.4f} ms per op call (3 launches; "
               f"device time alone {row['device_ms']:.4f} ms), taps + "
               f"kernel {row['op_call_ms']:.4f} ms, plain windowed2d"
               f" {row['plain_ms']:.4f} ms; bound "
               f"{row['bound_ms'] * 1e3:.2f} us by {row['bound_by']} "
               f"({row['bytes'] / 1e6:.1f} MB, {row['ops'] / 1e9:.3f} "
               f"GFLOP); embedding_bag on the global value rows "
               f"({row['dtype']} rows and weights) "
               f"{row['library_ms']:.4f} ms, max|diff| "
               f"{row['library_max_abs_err']:.3e}" if "ms" in row
               else ""))
        del got, want
    del enc_value, enc_loc, enc_attn, teleported, cases
    torch.cuda.empty_cache()

    # ---- K5 and K4 at the four probe_hier fixtures -----------------------
    for NB, C, widths in lanegather_probe.HIER_FIXTURES:
        wins, winsT, ids, idsT, wgts, wgtsT, Cp = lanegather_probe._fixture(
            NB, C, widths, device="cuda")
        D = wins[0].shape[-1]
        label = f"NB={NB} C={C} widths={widths}"
        # the yardstick of both: the same function in K5's layout
        bag_args = contract_bag_args(wins, ids, wgts)
        lib = library_bag(*bag_args).view(NB, 32, C, D)
        lib_ms = time_ms(lambda: library_bag(*bag_args))
        for name, fn, plain, args, out_shape, kernel in (
                ("win2d_contract", win2d.win2d_contract_cuda,
                 win2d.win2d_contract_torch, (wins, ids, wgts),
                 (NB, 32, C, D), "win2d_contract_kernel"),
                ("hier_gather", win2d.hier_gather_cuda,
                 win2d.hier_gather_torch, (winsT, idsT, wgtsT),
                 (NB, 32, D, Cp), "hier_gather_kernel")):
            got = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = TOL_CONTRACT_REL * want.abs().max().item()
            check(tuple(got.shape) == out_shape and math.isfinite(err)
                  and err <= tol,
                  f"{name} {label}: max abs diff {err} > {tol}")
            want_c = want if name == "win2d_contract" \
                else want.transpose(2, 3)[:, :, :C]
            lib_err = (lib - want_c).abs().max().item()
            check(math.isfinite(lib_err) and lib_err <= tol,
                  f"embedding_bag yardstick of {name} {label}: max abs "
                  f"diff {lib_err} > {tol}")
            io_bytes = sum(t.numel() * 4 for t in args[1] + args[2]) \
                + got.numel() * 4
            bound, by, nbytes, ops = contract_bound_ms(ids, wgts, D,
                                                       io_bytes)
            row = dict(max_abs_err=err, tol=tol, ms=time_ms(lambda: fn(*args)),
                       device_ms=device_ms(lambda: fn(*args), kernel),
                       plain_ms=time_ms(lambda: plain(*args), reps=10),
                       library_ms=lib_ms, library_max_abs_err=lib_err,
                       bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops)
            res[name][label] = row
            log(f"{name} {label}: max|diff| {err:.3e} (tol {tol:.3g}); "
                f"kernel {row['ms']:.4f} ms (device time alone "
                f"{row['device_ms']:.4f} ms), plain {row['plain_ms']:.4f} "
                f"ms; bound {bound * 1e3:.2f} us by {by} ({nbytes / 1e6:.1f}"
                f" MB, {ops / 1e9:.3f} GFLOP); embedding_bag over the "
                f"windows in K5's layout {lib_ms:.4f} ms, max|diff| "
                f"{lib_err:.3e}")
            del got, want, want_c
        del wins, winsT, ids, idsT, wgts, wgtsT, bag_args, lib
        torch.cuda.empty_cache()

    # ---- K3 at the probe's 64 x [512, 128], n = 64 -----------------------
    g = torch.Generator(device="cuda").manual_seed(40)
    x = torch.randn(64, 512, 128, device="cuda", generator=g)
    idx = torch.randint(0, 128, (64, 512, 128), device="cuda", generator=g,
                        dtype=torch.int32)
    n = 64
    warp_steps = x.numel() // 128 * n
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    for name, fn, plain, ops_per_elem, issue in (
            ("chain_gather", lane_chain.chain_gather_cuda,
             lane_chain.chain_gather_torch, 1,
             # 16 warp shuffles a step, one a clock per SM
             (16 * warp_steps, 1, "warp shuffles")),
            ("chain_select", lane_chain.chain_select_cuda,
             lane_chain.chain_select_torch, 3,
             # compare, select, add on 4 registers: 12 warp instructions a
             # step, 4 issued a clock per SM
             (12 * warp_steps, 4, "warp instructions"))):
        got = fn(x, idx, n)
        want = plain(x, idx, n)
        check(torch.equal(got, want), f"{name}: not bitwise equal to the "
              f"plain chain (max |diff| "
              f"{(got - want).abs().max().item()})")
        nbytes = 3 * x.numel() * 4
        ops = ops_per_elem * n * x.numel()
        bound, by = _bound(nbytes, ops)
        mhz = sm_clock_mhz(lambda: fn(x, idx, n))
        count, per_clock, what = issue
        row = dict(max_abs_err=0.0, tol=0.0, ms=time_ms(lambda: fn(x, idx, n)),
                   device_ms=device_ms(lambda: fn(x, idx, n), f"{name}_kernel"),
                   plain_ms=time_ms(lambda: plain(x, idx, n)),
                   bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops,
                   issue_count=count, issue_what=what, sm_clock_mhz=mhz,
                   issue_ms=count / (sms * per_clock * mhz * 1e6) * 1e3)
        row["ns_per_elem"] = row["ms"] * 1e6 / (x.numel() * n)
        res[name]["64x[512,128] n=64"] = row
        log(f"{name} 64x[512,128] n={n}: bitwise equal to the plain chain; "
            f"kernel {row['ms']:.4f} ms ({row['ns_per_elem']:.5f} ns/elem; "
            f"device time alone {row['device_ms']:.4f} ms), plain "
            f"{row['plain_ms']:.4f} ms; bound {bound * 1e3:.2f} us by {by} "
            f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G ops); issue "
            f"arithmetic {count / 1e6:.1f} M {what} over {sms} SMs at "
            f"{per_clock} a clock and {mhz:.0f} MHz: "
            f"{row['issue_ms']:.4f} ms; no single PyTorch call computes "
            f"the chain (library_ms null)")
    del x, idx
    torch.cuda.empty_cache()
    return res


def _run_probe(argv):
    """``snipper_tpu_torch.scripts.probe.main(argv)`` with its output
    captured (and logged); returns (exit code, output)."""
    from snipper_tpu_torch.scripts import probe

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = probe.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    return rc, out


def phase_probes():
    """The probe path: ``probe op`` over all six impls and ``probe
    lanegather``, each with the counts of the kernels it runs set to 0
    just before and read just after."""
    from snipper_tpu_torch.ops import lane_chain, win2d
    from snipper_tpu_torch.ops.msda import ms_deform_attn

    log("probe op (python -m snipper_tpu_torch.scripts.probe op --impls "
        f"{PROBE_OP_IMPLS}):")
    # ---- the op sweep, with its kernels' counts at 0 ---------------------
    win2d.win2d_sample.launches = 0
    ms_deform_attn.launches = 0
    rc, out = _run_probe(["op", "--impls", PROBE_OP_IMPLS, "--device",
                          "cuda"])
    op_launches = {"win2d_sample": win2d.win2d_sample.launches,
                   "msda_forward": ms_deform_attn.launches}
    # ----------------------------------------------------------------------
    check(rc == 0 and "FAIL" not in out and out.rstrip().endswith("DONE"),
          f"probe op exited {rc} or printed FAIL")
    lines = {ln.split(":")[0].split()[0]: ln for ln in out.splitlines()
             if "ms/op-call" in ln}
    check(sorted(lines) == sorted(PROBE_OP_IMPLS.split(",")),
          f"probe op printed lines for {sorted(lines)}")
    k2 = lines["windowed2d_pallas"]
    relerr = float(k2.split("relerr ")[1].split()[0])
    check("overflow=0.0" in k2 and relerr <= TOL_PROBE_RELERR,
          f"windowed2d_pallas line: {k2}")
    op_ms = {impl: float(ln.split(":")[1].split()[0])
             for impl, ln in lines.items()}

    log("probe lanegather (python -m snipper_tpu_torch.scripts.probe "
        "lanegather):")
    # ---- the lane-gather probe, with its kernels' counts at 0 ------------
    for fn in (lane_chain.chain_gather, lane_chain.chain_select,
               win2d.hier_gather, win2d.win2d_contract):
        fn.launches = 0
    rc2, out2 = _run_probe(["lanegather", "--device", "cuda"])
    lg_launches = {"chain_gather": lane_chain.chain_gather.launches,
                   "chain_select": lane_chain.chain_select.launches,
                   "hier_gather": win2d.hier_gather.launches,
                   "win2d_contract": win2d.win2d_contract.launches}
    # ----------------------------------------------------------------------
    check(rc2 == 0 and "FAIL" not in out2 and out2.rstrip().endswith("DONE"),
          f"probe lanegather exited {rc2} or printed FAIL")
    launches = {**op_launches, **lg_launches}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the probe path was not launched: {launches}")
    log(f"probe path: exit codes {rc}, {rc2}; launches {launches}")
    return dict(launches=launches, op_ms=op_ms, relerr=relerr,
                op_lines=list(lines.values()),
                lanegather_lines=[ln for ln in out2.splitlines()
                                  if ln.startswith("  ")])



# ------------------------------------------------------------- main path
def write_frames(frame_dir, n, width=800, height=600, seed=0):
    """Smooth synthetic JPEG frames (low-frequency colour fields)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(frame_dir, exist_ok=True)
    for i in range(n):
        small = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
        img = Image.fromarray(small).resize((width, height), Image.BILINEAR)
        img.save(os.path.join(frame_dir, f"{i:06d}.jpg"), quality=90)


def perturbed_model(cfg, seed=0):
    """canonical weights from a seed, with the sampling projections'
    weights perturbed so that queries sample different places."""
    import torch

    from snipper_tpu_torch.models.snipper import build_model

    model = build_model(cfg, device="cuda", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("sampling_offsets.weight",
                              "attention_weights.weight")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return model


def max_output_diff(a, b):
    keys = ("pred_logits", "pred_kpts2d", "pred_depth")
    diffs = {k: (a[k].float().cpu() - b[k].float().cpu()).abs().max().item()
             for k in keys}
    diffs["heatmaps"] = max(
        (x.float().cpu() - y.float().cpu()).abs().max().item()
        for x, y in zip(a["heatmaps"], b["heatmaps"]))
    return diffs


def forward_with_plain_msda(model, x):
    """The same forward with the plain MSDA substituted for the kernel's
    wrapper (a comparison on the card; the port itself never does this)."""
    import torch

    from snipper_tpu_torch.ops import deform_attn
    from snipper_tpu_torch.ops.msda import ms_deform_attn_torch

    wrapper = deform_attn.ms_deform_attn
    deform_attn.ms_deform_attn = ms_deform_attn_torch
    try:
        with torch.inference_mode():
            return model(x)
    finally:
        deform_attn.ms_deform_attn = wrapper


def breakdown(fn, top=8, reps=5, need=("msda_forward",)):
    """Device time of one call of ``fn`` by kernel (torch.profiler), its
    wall time (CUDA events, median of ``reps``) and the device's busy
    share of that wall time. ``need``: the kernels that ``fn`` launches
    whose times are reported apart."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    wall_ms = time_ms(fn, reps=reps, warmup=0)
    kernels = profiled_kernels(fn, need=need)
    total_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    msda_us = {name: sum(e.self_device_time_total for e in kernels
                         if name in e.key) / 1e3
               for name in ("msda_forward", "msda_backward")}
    rows = [(e.key[:60], e.self_device_time_total / 1e3, e.count)
            for e in kernels[:top]]
    return dict(wall_ms=wall_ms, device_ms=total_us / 1e3,
                busy_share=(total_us / 1e3) / wall_ms if wall_ms else None,
                msda_ms=msda_us["msda_forward"],
                msda_backward_ms=msda_us["msda_backward"], top=rows,
                kernel_launches=sum(e.count for e in kernels))


def forward_breakdown(model, x):
    import torch

    def fwd():
        with torch.inference_mode():
            model(x)

    return breakdown(fwd)


def phase_main_path(work, n_frames=31):
    import numpy as np
    import torch

    from snipper_tpu_torch.cli import infer as infer_cli
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.infer.pipeline import iter_snippet_samples
    from snipper_tpu_torch.ops.msda import ms_deform_attn

    cfg = Config.canonical_t4()
    frame_dir = os.path.join(work, "frames")
    write_frames(frame_dir, n_frames)
    model = perturbed_model(cfg)
    ckpt = os.path.join(work, "canonical_t4_seed0.pt")
    # the trainer's checkpoint format, which cli.infer --resume reads
    torch.save({"params": model.state_dict(), "step": 0}, ckpt)
    out_dir = os.path.join(work, "out")

    # PyTorch's defaults, which a user of the CLI gets: TF32 convolutions,
    # f32 matrix products
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path, with every kernel's count at 0 -------------------
    ms_deform_attn.launches = 0
    stats = infer_cli.main([
        "--preset", "canonical_t4", "--data_dir", frame_dir,
        "--output_dir", out_dir, "--seq_gap", "1", "--resume", ckpt,
        "--device", "cuda"])
    launches = {"msda_forward": ms_deform_attn.launches}
    # ----------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = stats["snippets"]
    check(n >= 2, f"need >= 2 snippets, got {n}")
    per_snippet = launches["msda_forward"] / n
    check(per_snippet == cfg.enc_layers + cfg.dec_layers,
          f"msda_forward launched {launches['msda_forward']} times for {n} "
          f"snippets, expected {cfg.enc_layers + cfg.dec_layers} per "
          f"snippet")
    tracks_path = os.path.join(out_dir, "tracks.pkl")
    check(os.path.exists(tracks_path), "tracks.pkl not written")
    with open(tracks_path, "rb") as f:
        tracks = pickle.load(f)
    check(set(tracks) == {"frames", "max_pid"}, "tracks.pkl keys")
    for pids, data in tracks["frames"].values():
        check(np.all(np.isfinite(data)), "non-finite values in tracks")
        check(data.ndim == 3 and data.shape[1:] == (cfg.num_kpts, 4)
              or data.shape[0] == 0, f"track data shape {data.shape}")
    done = stats["done_at"]
    steady = (n - 1) / (done[-1] - done[0])
    fwd_ms = statistics.median(stats["forward_ms"][1:])
    wait_ms = statistics.median(stats["wait_ms"][1:])
    log(f"main path: canonical_t4 600x800 enc6/dec6, {n} snippets of "
        f"{cfg.num_frames} frames; msda_forward launches "
        f"{launches['msda_forward']} ({per_snippet:g}/snippet); steady-state "
        f"{steady:.3f} snippets/s end to end (first snippet excluded); "
        f"per snippet (median, first excluded): forward + readback "
        f"{fwd_ms:.2f} ms, waiting for host decode + warp {wait_ms:.2f} ms;"
        f" {tracks['max_pid']} identities over {len(tracks['frames'])} "
        f"frames; peak device memory {peak_gb:.2f} GB "
        f"(cuDNN TF32 on, matmul TF32 off)")

    sample = next(iter_snippet_samples(frame_dir, cfg.num_frames, 1,
                                       cfg.input_shape))
    x = torch.from_numpy(sample["imgs"][None]).cuda()
    bd = forward_breakdown(model, x)
    log(f"one canonical_t4 forward (cuDNN TF32 on): wall {bd['wall_ms']:.2f}"
        f" ms (CUDA events), device kernels {bd['device_ms']:.2f} ms "
        f"(torch.profiler), busy share {bd['busy_share']:.3f}, msda_forward "
        f"{bd['msda_ms']:.3f} ms")
    for name, ms, count in bd["top"]:
        log(f"  {ms:9.3f} ms  x{count:<4d} {name}")

    # ---- is the output right? (TF32 off) ---------------------------------
    set_tf32(False)
    with torch.inference_mode():
        got = model(x)
    want = forward_with_plain_msda(model, x)
    check(tuple(got["pred_logits"].shape) == (1, cfg.num_queries,
                                              cfg.num_frames, 2),
          f"pred_logits shape {tuple(got['pred_logits'].shape)}")
    check(tuple(got["pred_kpts2d"].shape) == (1, cfg.num_queries,
                                              cfg.num_frames, cfg.num_kpts, 3),
          f"pred_kpts2d shape {tuple(got['pred_kpts2d'].shape)}")
    for k in ("pred_logits", "pred_kpts2d", "pred_depth"):
        check(bool(torch.isfinite(got[k]).all()), f"non-finite {k}")
    fwd_diff = max_output_diff(got, want)
    check(max(fwd_diff.values()) <= TOL_FORWARD,
          f"canonical forward kernel vs plain MSDA: {fwd_diff} > "
          f"{TOL_FORWARD}")
    log(f"canonical_t4 forward, kernel vs plain MSDA on the card (TF32 off):"
        f" max|diff| {json.dumps(fwd_diff)} (tol {TOL_FORWARD:g})")
    del model, got, want
    torch.cuda.empty_cache()

    tiny = Config.tiny()
    rng = np.random.default_rng(0)
    xt = torch.from_numpy(rng.uniform(0, 1, (1, tiny.num_frames,
                                             tiny.input_height,
                                             tiny.input_width, 3)
                                      ).astype(np.float32))
    m_gpu = perturbed_model(tiny)
    from snipper_tpu_torch.models.snipper import build_model
    m_cpu = build_model(tiny, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    with torch.inference_mode():
        tiny_diff = max_output_diff(m_gpu(xt.cuda()), m_cpu(xt))
    check(max(tiny_diff.values()) <= TOL_TINY_MODEL,
          f"tiny model CUDA vs CPU: {tiny_diff} > {TOL_TINY_MODEL}")
    log(f"tiny model, CUDA (kernel) vs CPU (plain), TF32 off: max|diff| "
        f"{json.dumps(tiny_diff)} (tol {TOL_TINY_MODEL:g})")
    return dict(snippets=n, launches=launches, per_snippet=per_snippet,
                steady_snippets_per_s=steady, forward_ms=fwd_ms,
                wait_ms=wait_ms, peak_gb=peak_gb, breakdown=bd,
                forward_diff=fwd_diff, tiny_diff=tiny_diff)


def host_ms(fn, reps=5):
    """Median host-clock ms of ``fn()`` over ``reps`` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_serving_device(work, host_res, card):
    """Serving with ``--device_preprocess`` on phase_main_path's frames and
    checkpoint; then one snippet's host decode, host warp, upload and
    device warp timed apart, the card's warp held against the host warp
    (TOL_WARP_HOST) and the port's warp on the CPU (TOL_WARP_CPU) on those
    frames and on 1280x720 frames (a resize with a zero border), and the
    canonical forward on the device-warped input against the forward on
    the host-warped input (TOL_FORWARD, TF32 off)."""
    import numpy as np
    import torch

    from snipper_tpu_torch.cli import infer as infer_cli
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.data.device_preprocess import (
        invert_axis_aligned, preprocess_snippet_device, warp_affine_device)
    from snipper_tpu_torch.data.transforms import (gen_trans_from_patch,
                                                   generate_patch_image)
    from snipper_tpu_torch.infer.pipeline import (_read_rgb,
                                                  iter_snippet_samples)
    from snipper_tpu_torch.models.snipper import build_model
    from snipper_tpu_torch.ops.msda import ms_deform_attn
    from snipper_tpu_torch.train.checkpoint import load_checkpoint

    cfg = Config.canonical_t4()
    frame_dir = os.path.join(work, "frames")
    ckpt = os.path.join(work, "canonical_t4_seed0.pt")
    out_dir = os.path.join(work, "out_device")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    # ---- the serving path with the warp on the card, counts at 0 ---------
    ms_deform_attn.launches = 0
    stats = infer_cli.main([
        "--preset", "canonical_t4", "--data_dir", frame_dir,
        "--output_dir", out_dir, "--seq_gap", "1", "--resume", ckpt,
        "--device_preprocess", "--device", "cuda"])
    launches = {"msda_forward": ms_deform_attn.launches}
    # ----------------------------------------------------------------------
    n = stats["snippets"]
    per_snippet = launches["msda_forward"] / n
    check(n == host_res["snippets"], f"{n} snippets, the host path served "
          f"{host_res['snippets']}")
    check(per_snippet == cfg.enc_layers + cfg.dec_layers,
          f"msda_forward launched {launches['msda_forward']} times for {n} "
          f"snippets with --device_preprocess, expected "
          f"{cfg.enc_layers + cfg.dec_layers} per snippet")
    with open(os.path.join(out_dir, "tracks.pkl"), "rb") as f:
        tracks = pickle.load(f)
    check(set(tracks) == {"frames", "max_pid"}, "tracks.pkl keys")
    with open(os.path.join(work, "out", "tracks.pkl"), "rb") as f:
        host_frames = set(pickle.load(f)["frames"])
    check(set(tracks["frames"]) == host_frames,
          "tracks.pkl covers other frames than the host path's")
    for pids, data in tracks["frames"].values():
        check(np.all(np.isfinite(data)), "non-finite values in tracks")
        check(data.ndim == 3 and data.shape[1:] == (cfg.num_kpts, 4)
              or data.shape[0] == 0, f"track data shape {data.shape}")
    done = stats["done_at"]
    steady = (n - 1) / (done[-1] - done[0])
    fwd_ms = statistics.median(stats["forward_ms"][1:])
    wait_ms = statistics.median(stats["wait_ms"][1:])
    log(f"serving --device_preprocess: {n} snippets, msda_forward launches "
        f"{launches['msda_forward']} ({per_snippet:g}/snippet); steady-state"
        f" {steady:.3f} snippets/s (host warp path "
        f"{host_res['steady_snippets_per_s']:.3f}); per snippet (median, "
        f"first excluded): waiting for host decode {wait_ms:.2f} ms (host "
        f"path: decode + warp {host_res['wait_ms']:.2f}), upload + warp + "
        f"forward + readback {fwd_ms:.2f} ms (host path: upload + forward +"
        f" readback {host_res['forward_ms']:.2f})")

    # ---- one snippet's input stages, apart -------------------------------
    sample = next(iter_snippet_samples(frame_dir, cfg.num_frames, 1,
                                       cfg.input_shape, warp_on_device=True))
    paths = [os.path.join(frame_dir, f) for f in sample["filenames"]]
    raw, trans = sample["raw_imgs"], sample["trans"]
    shape = cfg.input_shape

    def host_warp(frames):
        return np.stack([generate_patch_image(im, False, trans, shape)
                         for im in frames]).astype(np.float32)

    decode_ms = host_ms(lambda: [_read_rgb(p) for p in paths])
    host_warp_ms = host_ms(lambda: host_warp(raw), reps=3)
    pinned = torch.from_numpy(raw).pin_memory()
    raw_dev = pinned.cuda()
    inv = invert_axis_aligned(trans)
    upload_ms = time_ms(lambda: pinned.to("cuda", non_blocking=True))
    warp_ms = time_ms(lambda: warp_affine_device(raw_dev, inv, shape))
    warp_device_ms = device_ms(lambda: warp_affine_device(raw_dev, inv,
                                                          shape), "")
    upload_warp_ms = time_ms(lambda: preprocess_snippet_device(
        pinned, trans, shape, "cuda"))
    log(f"one snippet's input (4 frames of 800x600, {card}): host "
        f"decode (_read_rgb x4) {decode_ms:.2f} ms, host warp "
        f"{host_warp_ms:.2f} ms (host clock, median); upload of the uint8 "
        f"frames from pinned memory {upload_ms:.4f} ms, device warp "
        f"{warp_ms:.4f} ms (CUDA events), device warp kernels "
        f"{warp_device_ms:.4f} ms (torch.profiler), upload + warp "
        f"{upload_warp_ms:.4f} ms")

    # ---- is the card's warp right? ---------------------------------------
    set_tf32(False)
    rng = np.random.default_rng(5)
    big = rng.integers(0, 256, (cfg.num_frames, 720, 1280, 3), np.uint8)
    scale = max(1280 / shape[1], 720 / shape[0])
    big_trans = gen_trans_from_patch(640.0, 360.0, shape[1] * scale,
                                     shape[0] * scale, shape[1], shape[0],
                                     0.0)
    warp_err = {}
    for name, frames, t in (("800x600", raw, trans),
                            ("1280x720", big, big_trans)):
        got = preprocess_snippet_device(
            torch.from_numpy(frames).pin_memory(), t, shape, "cuda").cpu()
        cpu = preprocess_snippet_device(frames, t, shape).numpy()
        host = np.stack([generate_patch_image(im, False, t, shape)
                         for im in frames])
        warp_err[name] = {
            "host": float(np.abs(got.numpy() - host).max()),
            "cpu": float(np.abs(got.numpy() - cpu).max())}
        check(warp_err[name]["host"] <= TOL_WARP_HOST,
              f"device warp vs host warp at {name}: {warp_err[name]}")
        check(warp_err[name]["cpu"] <= TOL_WARP_CPU,
              f"device warp vs the port's CPU warp at {name}: "
              f"{warp_err[name]}")
    model = build_model(cfg, device="cuda")
    model.load_state_dict(load_checkpoint(ckpt)["params"])
    host_x = torch.from_numpy(host_warp(raw)[None]).cuda()
    dev_x = preprocess_snippet_device(pinned, trans, shape, "cuda")[None]
    with torch.inference_mode():
        fwd_diff = max_output_diff(model(dev_x), model(host_x))
    check(max(fwd_diff.values()) <= TOL_FORWARD,
          f"canonical forward on the device-warped input vs the host-warped"
          f" input: {fwd_diff} > {TOL_FORWARD}")
    log(f"device warp vs host warp (tol {TOL_WARP_HOST:g}) and vs the "
        f"port's warp on the CPU (tol {TOL_WARP_CPU:g}): max|diff| "
        f"{json.dumps(warp_err)}; canonical_t4 forward on the device-warped "
        f"vs the host-warped input (TF32 off): max|diff| "
        f"{json.dumps(fwd_diff)} (tol {TOL_FORWARD:g})")
    del model, host_x, dev_x, raw_dev
    torch.cuda.empty_cache()
    return dict(snippets=n, launches=launches, per_snippet=per_snippet,
                steady_snippets_per_s=steady, forward_ms=fwd_ms,
                wait_ms=wait_ms, decode_ms=decode_ms,
                host_warp_ms=host_warp_ms, upload_ms=upload_ms,
                warp_ms=warp_ms, warp_device_ms=warp_device_ms,
                upload_warp_ms=upload_warp_ms, warp_err=warp_err,
                forward_diff=fwd_diff)


# ------------------------------------------- serving profiles and export
FAST_SPEC = "enc4,p2,r480"
TOL_EXPORT = 1e-5

_EXPORT_LOADER = r"""
import json, sys, statistics
import torch
import snipper_tpu_torch.ops.msda as msda

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
program = torch.export.load(sys.argv[1]).module()
x = torch.load(sys.argv[2]).cuda()
with torch.inference_mode():
    msda.ms_deform_attn.launches = 0
    out = program(x)
    torch.cuda.synchronize()
    launches = msda.ms_deform_attn.launches
    times = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        program(x)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
torch.save({k: v.cpu() if torch.is_tensor(v) else [t.cpu() for t in v]
            for k, v in out.items()}, sys.argv[3])
print(json.dumps({"launches": launches, "ms": statistics.median(times),
                  "modules": sorted(m for m in sys.modules
                                    if m.startswith("snipper_tpu"))}))
"""


def phase_fast_export(work, card, main_res):
    """Serving profiles and the exported artifact at canonical_t4, on
    phase_main_path's frames and checkpoint: (a) ``cli.infer --fast
    enc4,p2,r480 --device_preprocess``, counts at 0 just before and read
    just after (10 launches per snippet), and the profile's forward against
    the same forward with the plain MSDA (TOL_FORWARD); (b) ``probe fast``
    with its default specs; (c) the f32 export on the card, saved and
    loaded in a subprocess that imports only torch and the MSDA operators:
    its outputs against the live model (TOL_EXPORT, TF32 off in both) and
    its launches per call, then the ``probe serve`` lines."""
    import numpy as np
    import torch

    from snipper_tpu_torch.cli import infer as infer_cli
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.infer.export import (export_forward,
                                                load_exported, save_exported)
    from snipper_tpu_torch.infer.fast import fast_profiles
    from snipper_tpu_torch.infer.pipeline import iter_snippet_samples
    from snipper_tpu_torch.models.snipper import build_model
    from snipper_tpu_torch.ops.msda import ms_deform_attn
    from snipper_tpu_torch.train.checkpoint import load_checkpoint

    base = Config.canonical_t4()
    cfg, transform = fast_profiles(base, FAST_SPEC)
    frame_dir = os.path.join(work, "frames")
    ckpt = os.path.join(work, "canonical_t4_seed0.pt")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    # ---- (a) serving a profile, counts at 0 ------------------------------
    ms_deform_attn.launches = 0
    stats = infer_cli.main([
        "--preset", "canonical_t4", "--data_dir", frame_dir,
        "--output_dir", os.path.join(work, "out_fast"), "--seq_gap", "1",
        "--resume", ckpt, "--fast", FAST_SPEC, "--device_preprocess",
        "--device", "cuda"])
    fast_launches = ms_deform_attn.launches
    # ----------------------------------------------------------------------
    n = stats["snippets"]
    per_snippet = fast_launches / n
    check(n == main_res["snippets"], f"--fast served {n} snippets")
    check(per_snippet == cfg.enc_layers + cfg.dec_layers,
          f"msda_forward launched {fast_launches} times for {n} snippets "
          f"with --fast {FAST_SPEC}, expected "
          f"{cfg.enc_layers + cfg.dec_layers} per snippet")
    done = stats["done_at"]
    steady = (n - 1) / (done[-1] - done[0])
    fwd_ms = statistics.median(stats["forward_ms"][1:])
    set_tf32(False)
    model = build_model(cfg, device="cuda")
    model.load_state_dict(transform(load_checkpoint(ckpt)["params"]))
    sample = next(iter_snippet_samples(frame_dir, cfg.num_frames, 1,
                                       cfg.input_shape))
    x = torch.from_numpy(sample["imgs"][None]).cuda()
    with torch.inference_mode():
        got = model(x)
    want = forward_with_plain_msda(model, x)
    for k in ("pred_logits", "pred_kpts2d", "pred_depth"):
        check(bool(torch.isfinite(got[k]).all()), f"--fast: non-finite {k}")
    fast_diff = max_output_diff(got, want)
    check(max(fast_diff.values()) <= TOL_FORWARD,
          f"--fast {FAST_SPEC} forward, kernel vs plain MSDA: {fast_diff}")
    log(f"serving --fast {FAST_SPEC} --device_preprocess ({card}): {n} "
        f"snippets at {cfg.input_height}x{cfg.input_width}, enc "
        f"{cfg.enc_layers}, {cfg.enc_n_points} points; msda_forward "
        f"launches {fast_launches} ({per_snippet:g}/snippet); steady-state "
        f"{steady:.3f} snippets/s (full model with --device_preprocess in "
        f"this run: see above); upload + warp + forward + readback "
        f"{fwd_ms:.2f} ms (median, first excluded); the profile's forward,"
        f" kernel vs plain MSDA (TF32 off): max|diff| "
        f"{json.dumps(fast_diff)} (tol {TOL_FORWARD:g})")
    del model, got, want

    # ---- (b) the fast-profile probe --------------------------------------
    log("probe fast (python -m snipper_tpu_torch.scripts.probe fast):")
    # PyTorch's defaults, which a user of the probe gets
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    rc, out = _run_probe(["fast", "--device", "cuda"])
    check(rc == 0 and "FAIL" not in out and out.rstrip().endswith("DONE"),
          f"probe fast exited {rc} or printed FAIL")
    fast_lines = [ln for ln in out.splitlines() if "snippets/s" in ln]
    check(len(fast_lines) == 7, f"probe fast printed {fast_lines}")
    probe_sps = {ln.split(":")[0].strip(): float(ln.split(":")[1].split()[0])
                 for ln in fast_lines}

    # ---- (c) the artifact, loaded without the model's modules ------------
    set_tf32(False)
    model = build_model(base, device="cuda")
    model.load_state_dict(load_checkpoint(ckpt)["params"])
    t0 = time.perf_counter()
    exported = export_forward(base, model.state_dict(), device="cuda")
    export_s = time.perf_counter() - t0
    path = os.path.join(work, "canonical_t4.pt2")
    size = save_exported(exported, path)
    nodes = sum("snipper_tpu_torch.msda_forward" in str(nd.target)
                for nd in exported.graph.nodes if nd.op == "call_function")
    sample = next(iter_snippet_samples(frame_dir, base.num_frames, 1,
                                       base.input_shape))
    x = torch.from_numpy(sample["imgs"][None])
    x_path, out_path = (os.path.join(work, f) for f in ("x.pt", "art.pt"))
    torch.save(x, x_path)
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [q for q in [env.get("PYTHONPATH")] if q])
    proc = subprocess.run([sys.executable, "-c", _EXPORT_LOADER, path,
                           x_path, out_path], capture_output=True,
                          text=True, timeout=600, env=env, cwd=root)
    check(proc.returncode == 0,
          f"loading the artifact failed: {proc.stderr[-2000:]}")
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    check(not [m for m in loaded["modules"]
               if m not in ("snipper_tpu_torch", "snipper_tpu_torch.ops",
                            "snipper_tpu_torch.ops.msda",
                            "snipper_tpu_torch.ops._build")],
          f"the loader imported {loaded['modules']}")
    per_call = base.enc_layers + base.dec_layers
    check(loaded["launches"] == per_call == nodes,
          f"the artifact launched msda_forward {loaded['launches']} times "
          f"per call ({nodes} nodes), expected {per_call}")
    art = torch.load(out_path)
    with torch.inference_mode():
        live = model(x.cuda())
    export_diff = max_output_diff(art, live)
    check(max(export_diff.values()) <= TOL_EXPORT,
          f"artifact vs live model: {export_diff} > {TOL_EXPORT}")
    check(int(art["sampling_overflow"]) == 0
          and art["sampling_overflow"].dtype == torch.int32,
          "artifact sampling_overflow")
    log(f"export of canonical_t4 f32 on the card ({card}): traced in "
        f"{export_s:.1f} s, {size / 1e6:.1f} MB, {nodes} msda_forward "
        f"nodes; loaded in a subprocess importing {loaded['modules']}: "
        f"{loaded['launches']} launches per call, {loaded['ms']:.2f} ms per"
        f" call (CUDA events, TF32 off), max|diff| vs the live model "
        f"{json.dumps(export_diff)} (tol {TOL_EXPORT:g})")
    # live and artifact in one process, in turns, as a user runs them
    # (cuDNN TF32 on): wall, device time and kernel launches of a call
    torch.backends.cudnn.allow_tf32 = True
    run = load_exported(path)
    xc = x.cuda()

    def live_fn():
        with torch.inference_mode():
            model(xc)

    turns = {"live": [], "artifact": []}
    for name, fn in (("live", live_fn), ("artifact", lambda: run(xc)),
                     ("artifact", lambda: run(xc)), ("live", live_fn)):
        turns[name].append(breakdown(fn, top=1, reps=10))

    def both(bds, key, fmt):
        return " / ".join(format(b[key], fmt) for b in bds)

    log("live forward vs artifact in turns (live, artifact, artifact, live;"
        " cuDNN TF32 on): " + "; ".join(
            f"{name}: wall {both(bds, 'wall_ms', '.2f')} ms, kernels "
            f"{both(bds, 'device_ms', '.2f')} ms, "
            f"{both(bds, 'kernel_launches', 'd')} kernel launches, busy "
            f"{both(bds, 'busy_share', '.3f')}"
            for name, bds in turns.items()))
    del model, live, exported, run
    torch.cuda.empty_cache()
    log("probe serve (python -m snipper_tpu_torch.scripts.probe serve):")
    torch.backends.cudnn.allow_tf32 = True
    rc, out = _run_probe(["serve", "--device", "cuda"])
    check(rc == 0 and out.rstrip().endswith("DONE"),
          f"probe serve exited {rc}")
    serve = {}
    for ln in out.splitlines():
        if ln.startswith("live forward"):
            serve["live_ms"] = float(ln.split(":")[1].split()[0])
        elif ln.startswith("artifact ("):
            serve["artifact_ms"] = float(ln.split(":")[1].split()[0])
            serve["ratio"] = float(ln.split("(")[-1].split("x")[0])
        elif ln.startswith("artifact:"):
            serve["mb"] = float(ln.split()[1])
    check(len(serve) == 4, f"probe serve printed {out}")
    return dict(fast_launches=fast_launches, fast_per_snippet=per_snippet,
                fast_steady_snippets_per_s=steady, fast_forward_ms=fwd_ms,
                fast_diff=fast_diff, probe_fast=probe_sps,
                export_launches=loaded["launches"], export_bytes=size,
                export_s=export_s, export_ms=loaded["ms"],
                export_diff=export_diff, serve=serve, turns=turns)


def phase_profile_labels(work, card, real_root, steps=4):
    """(a) ``cli.train --profile_dir`` on canonical_t4_f2 b2 bf16
    synthetic, ``steps`` steps with a 2-step window, counts at 0 just
    before and read just after: the trace exists and its summary names
    ``msda_forward`` and ``msda_backward`` with device time, and the
    matching's host span; taken again (up to three runs) when the profiler
    drops the run's device events. (b) ``cli.dump_labels`` on the
    PoseTrack18-format val split that phase_train_real wrote: one pickle
    entry per sample and the ``--vis 2`` renders."""
    import torch

    from snipper_tpu_torch.cli import dump_labels as dump_cli
    from snipper_tpu_torch.cli import train as train_cli
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.data.datasets import HybridDataset
    from snipper_tpu_torch.ops.msda import ms_deform_attn
    from snipper_tpu_torch.utils.profiling import host_spans, summarize_trace

    cfg = Config.canonical_t4_f2()
    per_pass = cfg.enc_layers + cfg.dec_layers
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    for attempt in range(3):
        prof = os.path.join(work, f"profile{attempt}")
        buf = io.StringIO()
        # ---- the profiled training run, counts at 0 ----------------------
        ms_deform_attn.launches = 0
        ms_deform_attn.backward_launches = 0
        with contextlib.redirect_stdout(buf):
            res = train_cli.main([
                "--preset", "canonical_t4_f2", "--synthetic",
                "--batch_size", "2", "--synthetic_distinct", "2",
                "--epochs", "1", "--steps_per_epoch", str(steps),
                "--eval_every", "5", "--profile_dir", prof,
                "--profile_steps", "2", "--output_dir",
                os.path.join(work, f"train_prof{attempt}"),
                "--device", "cuda"])
        launches = {"msda_forward": ms_deform_attn.launches,
                    "msda_backward": ms_deform_attn.backward_launches}
        # ------------------------------------------------------------------
        check(launches == {"msda_forward": per_pass * steps,
                           "msda_backward": per_pass * steps},
              f"profiled training launches {launches} in {steps} steps")
        top = summarize_trace(prof, top_k=10_000, n_iters=2)
        msda = {name: sum(ms for k, ms in top.items() if name in k)
                for name in ("msda_forward", "msda_backward")}
        if all(v > 0 for v in msda.values()):
            break
    check(all(v > 0 for v in msda.values()),
          f"the profiled steps' summary has no device time of {msda}")
    out = buf.getvalue()
    check("profile trace written to" in out, "no profile summary printed")
    summary = [ln for ln in out.splitlines() if " ms/step  " in ln]
    spans = host_spans(prof, n_iters=2)
    check(spans.get("match_layers", 0) > 0, f"host spans {spans}")
    trace_mb = sum(os.path.getsize(os.path.join(prof, f))
                   for f in os.listdir(prof)) / 1e6
    device_total = sum(summarize_trace(prof, top_k=10_000,
                                       n_iters=2).values())
    step_ms = statistics.median(h["seconds"]
                                for h in res["history"][2:]) * 1e3
    log(f"training with --profile_dir ({card}): canonical_t4_f2 b2 bf16, "
        f"{steps} steps, window of 2 from step 2 (run {attempt + 1}); trace"
        f" {trace_mb:.1f} MB; per step: device {device_total:.2f} ms, "
        f"msda_forward {msda['msda_forward']:.3f} ms, msda_backward "
        f"{msda['msda_backward']:.3f} ms, host span match_layers "
        f"{spans['match_layers']:.2f} ms; profiled steps' host time "
        f"{step_ms:.2f} ms (median); launches {launches}; the summary "
        f"printed:")
    for ln in summary:
        log(f"  | {ln[:150]}")

    # ---- (b) the label dump on the PoseTrack18-format val split ----------
    n_val = len(HybridDataset(cfg, "val", posetrack_dir=real_root))
    dump_dir = os.path.join(work, "labels")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as dbuf:
        dumped = dump_cli.main([
            "--preset", "canonical_t4_f2", "--posetrack_dir", real_root,
            "--mode", "val", "--out", os.path.join(dump_dir, "gt.pkl"),
            "--vis", "2", "--vis_dir", os.path.join(dump_dir, "vis")])
    dump_s = time.perf_counter() - t0
    with open(os.path.join(dump_dir, "gt.pkl"), "rb") as f:
        gt = pickle.load(f)
    renders = sorted(os.listdir(os.path.join(dump_dir, "vis")))
    want = [f"{i:04d}_aug_t{t}.jpg" for i in range(2)
            for t in range(cfg.num_frames)] + \
        [f"{i:04d}_aug_trans.jpg" for i in range(2)]
    check(len(gt) == dumped["samples"] == n_val > 0,
          f"dump_labels: {len(gt)} entries for {n_val} val samples")
    check(renders == sorted(want), f"dump_labels renders {renders}")
    stat_lines = [ln for ln in dbuf.getvalue().splitlines()
                  if ln.startswith(("persons/sample", "visible-joint",
                                    "mean normalized"))]
    log(f"dump_labels on the PoseTrack18-format val split: {len(gt)} "
        f"entries for {n_val} samples, {len(renders)} renders, "
        f"{dump_s:.1f} s; {'; '.join(stat_lines)}")
    return dict(launches=launches, msda_ms=msda, match_layers_ms=spans[
        "match_layers"], device_ms=device_total, trace_mb=trace_mb,
        summary=summary, dump_entries=len(gt), renders=len(renders))


def phase_train(work, steps=8):
    """The training path through the CLI a user calls: canonical_t4_f2,
    batch 2, bf16 mixed precision, ``steps`` steps over two distinct
    synthetic samples (a 600x800 render costs 1-2 s, so the set is small
    and cached), then the epoch's checkpoint and evaluation."""
    import torch

    from snipper_tpu_torch.cli import train as train_cli
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.ops.msda import ms_deform_attn

    cfg = Config.canonical_t4_f2()
    out_dir = os.path.join(work, "train")
    # PyTorch's defaults, which a user of the CLI gets
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    # ---- the training path, with every kernel's count at 0 ---------------
    ms_deform_attn.launches = 0
    ms_deform_attn.backward_launches = 0
    res = train_cli.main([
        "--preset", "canonical_t4_f2", "--synthetic", "--batch_size", "2",
        "--synthetic_distinct", "2", "--epochs", "1",
        "--steps_per_epoch", str(steps), "--output_dir", out_dir,
        "--device", "cuda"])
    launches = {"msda_forward": ms_deform_attn.launches,
                "msda_backward": ms_deform_attn.backward_launches}
    # ----------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res["history"]
    n_eval = res["eval"]["_batches"]
    per_layer_pass = cfg.enc_layers + cfg.dec_layers
    check(len(hist) == steps, f"{len(hist)} train steps, expected {steps}")
    # counted in this run: backward launches per step, forward launches
    # per forward pass (a train step or an eval batch)
    per_step = launches["msda_backward"] / steps
    per_forward = launches["msda_forward"] / (steps + n_eval)
    check(per_step == per_layer_pass,
          f"msda_backward launched {launches['msda_backward']} times in "
          f"{steps} steps, expected {per_layer_pass} per step")
    check(per_forward == per_layer_pass,
          f"msda_forward launched {launches['msda_forward']} times in "
          f"{steps} steps and {n_eval} eval batches, expected "
          f"{per_layer_pass} per step and per eval batch")
    losses = [h["loss_total"] for h in hist]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(res["checkpoint"] and os.path.exists(res["checkpoint"]),
          "no checkpoint written")
    with open(os.path.join(out_dir, "log.txt")) as f:
        logged = json.loads(f.readlines()[-1])
    bad = {k: v for k, v in logged.items()
           if k.startswith(("train_loss", "test_loss"))
           and not math.isfinite(v)}
    check(not bad and "test_loss_total" in logged,
          f"log.txt: non-finite or missing losses {bad}")
    # a step's ``seconds`` leaves out the wait for its batch, which holds
    # the batch's copy to the card: the period is the two together
    step_ms = statistics.median(h["seconds"] for h in hist[2:]) * 1e3
    period_ms = statistics.median(h["seconds"] + h["data_seconds"]
                                  for h in hist[2:]) * 1e3
    log(f"training path: canonical_t4_f2 600x800 enc6/dec6 batch 2 bf16 "
        f"mixed precision, {steps} steps + {n_eval} eval batches; "
        f"msda_forward {launches['msda_forward']} launches ({per_forward:g}"
        f" per step and per eval batch), msda_backward "
        f"{launches['msda_backward']} ({per_step:g} per step); steady-state "
        f"step {step_ms:.2f} ms, period {period_ms:.2f} ms "
        f"(median, first two steps excluded), {2e3 / period_ms:.3f} "
        f"samples/s;"
        f" peak device memory {peak_gb:.2f} GB; losses "
        f"{[round(x, 4) for x in losses]}; checkpoint "
        f"{os.path.basename(res['checkpoint'])}; eval "
        f"test_loss_total {logged['test_loss_total']:.4f} "
        f"(cuDNN TF32 on, matmul TF32 off)")
    return dict(steps=steps, eval_batches=n_eval, launches=launches,
                checkpoint=res["checkpoint"],
                per_step=per_step, per_forward=per_forward, step_ms=step_ms,
                period_ms=period_ms, samples_per_s=2e3 / period_ms,
                peak_gb=peak_gb, losses=losses,
                step_seconds=[h["seconds"] for h in hist])


def phase_eval(work, ckpt, samples=8):
    """The eval CLI a user calls on the checkpoint phase_train wrote:
    canonical_t4_f2 on ``samples`` synthetic samples (batches of 2), with
    ``--save_vis --write_posetrack``; counts set to 0 just before and read
    just after."""
    import torch

    from snipper_tpu_torch.cli import eval as eval_cli
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.ops.msda import ms_deform_attn

    cfg = Config.canonical_t4_f2()
    out_dir = os.path.join(work, "eval")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    # ---- the eval path, with every kernel's count at 0 -------------------
    ms_deform_attn.launches = 0
    res = eval_cli.main([
        "--preset", "canonical_t4_f2", "--synthetic", "--synthetic_samples",
        str(samples), "--resume", ckpt, "--save_vis", "--write_posetrack",
        "--output_dir", out_dir, "--device", "cuda"])
    launches = {"msda_forward": ms_deform_attn.launches}
    # ----------------------------------------------------------------------
    n = res["batches"]
    check(n == samples // cfg.batch_size, f"{n} eval batches")
    per_batch = launches["msda_forward"] / n
    check(per_batch == cfg.enc_layers + cfg.dec_layers,
          f"msda_forward launched {launches['msda_forward']} times in {n} "
          f"eval batches, expected {cfg.enc_layers + cfg.dec_layers} per "
          f"batch")
    with open(os.path.join(out_dir, "eval_stats.json")) as f:
        stats = json.load(f)
    bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
    # the 3D metrics need detections, which 8 train steps may not give
    check(stats and not bad and "loss_total" in stats,
          f"eval_stats.json: {stats}")
    renders = sorted(os.listdir(os.path.join(out_dir, "eval_vis")))
    check(any(r.startswith("eval_b0000_s") for r in renders)
          and all(r.endswith(".jpg") for r in renders),
          f"eval_vis renders: {renders}")
    check(os.path.isdir(os.path.join(out_dir, "posetrack_results")),
          "no posetrack_results directory")
    batch_ms = statistics.median(res["batch_ms"][1:])
    log(f"eval path: canonical_t4_f2 600x800 enc6/dec6, {n} batches of "
        f"{cfg.batch_size} (f32 forward + criterion + outputs on the host); "
        f"msda_forward launches {launches['msda_forward']} ({per_batch:g} "
        f"per batch); {batch_ms:.2f} ms per eval batch (median, first "
        f"excluded; all {[round(x, 2) for x in res['batch_ms']]}); eval loop"
        f" {res['seconds']:.2f} s; {len(stats)} finite stats "
        f"(loss_total {stats['loss_total']:.4f}, mpjpe_joint "
        f"{stats.get('mpjpe_joint', 'absent: no detection')}); renders "
        f"{renders} "
        f"(cuDNN TF32 on, matmul TF32 off)")
    return dict(batches=n, launches=launches, per_batch=per_batch,
                batch_ms=batch_ms, batch_ms_all=res["batch_ms"],
                seconds=res["seconds"], n_stats=len(stats), renders=renders)


POSETRACK_VIDEOS = (("000001_mpii_test", 1280, 720),
                    ("000002_mpii_test", 1920, 1080))


def write_posetrack_raw(root, n_frames=32, n_tracks=3, seed=0):
    """A PoseTrack18-format raw set under ``root``: each video of
    POSETRACK_VIDEOS as ``n_frames`` JPEG frames (a coarse seeded colour
    field, seeded noise, and ``n_tracks`` people drawn as joint squares
    moving across it) with one annotation JSON per video in
    ``annotations/train`` and ``annotations/val`` (the same frames):
    17 keypoints, a track id, a box and a head box per person."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    for vid_idx, (video, width, height) in enumerate(POSETRACK_VIDEOS):
        images, annotations = [], []
        start = rng.uniform([0.2 * width, 0.25 * height],
                            [0.8 * width, 0.6 * height], (n_tracks, 2))
        vel = rng.uniform(-4.0, 4.0, (n_tracks, 2)) * width / 1280
        body = rng.uniform([-0.06 * width, -0.2 * height],
                           [0.06 * width, 0.25 * height], (n_tracks, 17, 2))
        field = rng.integers(0, 256, (9, 16, 3), dtype=np.uint8)
        base = np.asarray(Image.fromarray(field).resize((width, height),
                                                         Image.BILINEAR))
        os.makedirs(os.path.join(root, "images", video), exist_ok=True)
        for i in range(n_frames):
            img = base.astype(np.int16) + rng.integers(
                -12, 13, (height, width, 3), dtype=np.int16)
            fn = f"images/{video}/{i:06d}.jpg"
            img_id = 10000 * (vid_idx + 1) + i
            images.append({"id": img_id, "file_name": fn,
                           "is_labeled": True, "vid_id": video,
                           "frame_id": i})
            for tid in range(n_tracks):
                k = start[tid] + vel[tid] * i + body[tid]
                k = np.clip(k, 8, [width - 9, height - 9])
                for x, y in k.astype(int):
                    img[y - 6:y + 7, x - 6:x + 7] = (255, 40 * tid, 0)
                x0, y0 = k.min(0)
                x1, y1 = k.max(0)
                annotations.append({
                    "image_id": img_id, "track_id": tid, "category_id": 1,
                    "id": img_id * 10 + tid,
                    "keypoints": np.concatenate(
                        [k, np.ones((17, 1))], 1).reshape(-1).tolist(),
                    "bbox": [float(x0), float(y0), float(x1 - x0),
                             float(y1 - y0)],
                    "bbox_head": [float(k[0, 0] - 20), float(k[0, 1] - 20),
                                  40.0, 40.0]})
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(root, fn), quality=90)
        for subset in ("train", "val"):
            ann_dir = os.path.join(root, "annotations", subset)
            os.makedirs(ann_dir, exist_ok=True)
            with open(os.path.join(ann_dir, f"{video}.json"), "w") as f:
                json.dump({"images": images, "annotations": annotations,
                           "categories": [{"id": 1, "name": "person"}]}, f)
    return os.path.join(root, "annotations", "val")


def phase_train_real(work, card, steps=8, host_steps=3):
    """Training and eval from reference-format files: a PoseTrack18 raw set
    (two videos, 1280x720 and 1920x1080, 32 frames, 3 people) run through
    the port's extractors; (a) the card's train warp against the host
    ``warp_patch`` on the loader's collation of one sample of each video
    (canonical_t4_f2, same seed), timed by CUDA events and by its kernels;
    (b) ``cli.train --posetrack_dir --device_preprocess`` for ``steps``
    steps and one eval, counts at 0 just before and read just after, and
    the busy share of one profiled step from raw frames; (c) the same run
    with the host warp for ``host_steps`` steps, with the loader's host
    time of one batch split into decode and warp; (d) ``cli.eval`` on (b)'s
    checkpoint with the PoseTrack harness, counts at 0 just before and
    read just after."""
    import numpy as np
    import torch

    from snipper_tpu_torch.cli import eval as eval_cli
    from snipper_tpu_torch.cli import train as train_cli
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.data.datasets import HybridDataset, _read_rgb
    from snipper_tpu_torch.data.device_preprocess import \
        warp_train_batch_device
    from snipper_tpu_torch.data.preprocess import posetrack as pt_pp
    from snipper_tpu_torch.data.snippet import stack_batch
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.models.snipper import build_model
    from snipper_tpu_torch.ops.msda import ms_deform_attn
    from snipper_tpu_torch.train.state import create_train_state
    from snipper_tpu_torch.train.step import batch_to_device, train_step

    cfg = Config.canonical_t4_f2()
    per_pass = cfg.enc_layers + cfg.dec_layers
    root = os.path.join(work, "posetrack_real")
    t0 = time.perf_counter()
    gt_dir = write_posetrack_raw(root)
    with contextlib.redirect_stdout(io.StringIO()):
        pt_pp.extract(root, root, "train")
        pt_pp.fillin(root, "train")
        pt_pp.extract(root, root, "val")
    write_s = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- (a) the card's train warp against the host warp -----------------
    ds_dev = HybridDataset(cfg, "train", posetrack_dir=root, seed=0,
                           device_preprocess=True)
    ds_host = HybridDataset(cfg, "train", posetrack_dir=root, seed=0)
    pick = (0, len(ds_dev) - 1)  # one sample of each video
    raw_batch = stack_batch([ds_dev[i] for i in pick])
    host_images = np.stack([ds_host[i]["images"] for i in pick])
    dev = batch_to_device(raw_batch, torch.device("cuda"))
    shape = cfg.input_shape

    def warp():
        return warp_train_batch_device(dev["raw_images"], dev["warp_inv"],
                                       dev["color_scale"], shape)

    warp_err = float(np.abs(warp().cpu().numpy() - host_images).max())
    check(warp_err <= TOL_WARP_HOST,
          f"train warp on the card vs the host warp_patch: {warp_err}")
    warp_ms = time_ms(warp)
    warp_device_ms = device_ms(warp, "")
    raw_shape = tuple(raw_batch["raw_images"].shape)
    log(f"train warp on the card (canonical_t4_f2, raw batch {raw_shape} "
        f"uint8 padded from 1280x720 and 1920x1080, {card}): max|diff| vs "
        f"the host warp_patch {warp_err:.3e} (tol {TOL_WARP_HOST:g}); "
        f"{warp_ms:.4f} ms (CUDA events), {warp_device_ms:.4f} ms of "
        f"kernels (torch.profiler); data written and extracted in "
        f"{write_s:.2f} s")

    # ---- (b) training with the device warp, counts at 0 ------------------
    out_dev = os.path.join(work, "train_real")
    ms_deform_attn.launches = 0
    ms_deform_attn.backward_launches = 0
    res = train_cli.main([
        "--preset", "canonical_t4_f2", "--batch_size", "2",
        "--posetrack_dir", root, "--device_preprocess", "--epochs", "1",
        "--steps_per_epoch", str(steps), "--output_dir", out_dev,
        "--device", "cuda"])
    train_launches = {"msda_forward": ms_deform_attn.launches,
                      "msda_backward": ms_deform_attn.backward_launches}
    # ----------------------------------------------------------------------
    hist = res["history"]
    n_eval = res["eval"]["_batches"]
    check(len(hist) == steps, f"{len(hist)} train steps, expected {steps}")
    check(train_launches["msda_backward"] == per_pass * steps,
          f"msda_backward launched {train_launches['msda_backward']} times "
          f"in {steps} steps from raw frames, expected {per_pass} per step")
    check(train_launches["msda_forward"] == per_pass * (steps + n_eval),
          f"msda_forward launched {train_launches['msda_forward']} times in"
          f" {steps} steps and {n_eval} eval batches, expected {per_pass} "
          f"per step and per eval batch")
    losses = [h["loss_total"] for h in hist]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(res["checkpoint"] and os.path.exists(res["checkpoint"]),
          "no checkpoint written")
    check(math.isfinite(res["eval"]["loss_total"]), "eval loss not finite")
    step_ms = statistics.median(h["seconds"] for h in hist[2:]) * 1e3
    period_ms = statistics.median(h["seconds"] + h["data_seconds"]
                                  for h in hist[2:]) * 1e3
    wait_ms = statistics.median(h["data_seconds"] for h in hist[2:]) * 1e3
    # one profiled bf16 step from the raw batch of (a): warp + forward +
    # criterion + backward + update
    model = build_model(cfg, device="cuda", seed=cfg.seed)
    state = create_train_state(cfg, model)
    crit, gen = SetCriterion(cfg), torch.Generator().manual_seed(0)
    bd = breakdown(lambda: train_step(state, crit, dev, gen), top=6,
                   need=("msda_forward", "msda_backward"))
    del model, state
    torch.cuda.empty_cache()
    log(f"training from PoseTrack18-format files with --device_preprocess "
        f"(canonical_t4_f2 b2 bf16, {card}): {steps} steps + {n_eval} eval "
        f"batches; msda_forward {train_launches['msda_forward']} launches, "
        f"msda_backward {train_launches['msda_backward']} ({per_pass} per "
        f"step); step {step_ms:.2f} ms, waiting for the batch {wait_ms:.2f}"
        f" ms, period {period_ms:.2f} ms, {2e3 / period_ms:.3f} samples/s "
        f"(median, first two steps excluded); losses "
        f"{[round(x, 4) for x in losses]}; one profiled step from raw "
        f"frames: wall {bd['wall_ms']:.2f} ms, kernels "
        f"{bd['device_ms']:.2f} ms, busy share {bd['busy_share']:.3f}")

    # ---- (c) training with the host warp --------------------------------
    res_host = train_cli.main([
        "--preset", "canonical_t4_f2", "--batch_size", "2",
        "--posetrack_dir", root, "--epochs", "1", "--eval_every", "5",
        "--steps_per_epoch", str(host_steps), "--output_dir",
        os.path.join(work, "train_real_host"), "--device", "cuda"])
    hh = res_host["history"]
    check(len(hh) == host_steps and all(
        math.isfinite(h["loss_total"]) for h in hh), "host-warp run")
    host_step_ms = statistics.median(h["seconds"] for h in hh[1:]) * 1e3
    host_period_ms = statistics.median(h["seconds"] + h["data_seconds"]
                                       for h in hh[1:]) * 1e3
    paths = [os.path.join(root, f) for i in pick
             for f in ds_host[i]["targets"]["filenames"][:cfg.num_frames]]
    decode_ms = host_ms(lambda: [_read_rgb(p) for p in paths], reps=3)
    raw_getter_ms = host_ms(lambda: [ds_dev[i] for i in pick], reps=3)
    host_getter_ms = host_ms(lambda: [ds_host[i] for i in pick], reps=3)
    log(f"training with the host warp ({card}): step {host_step_ms:.2f} ms,"
        f" period {host_period_ms:.2f} ms, {2e3 / host_period_ms:.3f} "
        f"samples/s (median, first step excluded; 2 decode threads); one "
        f"batch of 2 on one host thread: decode of its {len(paths)} frames "
        f"{decode_ms:.2f} ms, samples without the warp {raw_getter_ms:.2f} "
        f"ms, with the host warp {host_getter_ms:.2f} ms (warp "
        f"{host_getter_ms - raw_getter_ms:.2f} ms; host clock, median)")

    # ---- (d) eval on the files with the harness, counts at 0 ------------
    out_eval = os.path.join(work, "eval_real")
    ms_deform_attn.launches = 0
    ms_deform_attn.backward_launches = 0
    ev = eval_cli.main([
        "--preset", "canonical_t4_f2", "--batch_size", "2",
        "--posetrack_dir", root, "--posetrack_gt_dir", gt_dir,
        "--write_posetrack", "--resume", res["checkpoint"],
        "--output_dir", out_eval, "--device", "cuda"])
    eval_launches = {"msda_forward": ms_deform_attn.launches,
                     "msda_backward": ms_deform_attn.backward_launches}
    # ----------------------------------------------------------------------
    n = ev["batches"]
    check(n > 0 and eval_launches["msda_forward"] == per_pass * n
          and eval_launches["msda_backward"] == 0,
          f"eval launches {eval_launches} over {n} batches, expected "
          f"{per_pass} msda_forward per batch")
    with open(os.path.join(out_eval, "eval_stats.json")) as f:
        stats = json.load(f)
    bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
    ap_keys = sorted(k for k in stats if k.startswith("posetrack_ap_"))
    check(not bad and ap_keys and "loss_total" in stats,
          f"eval_stats.json: {stats}")
    eval_ms = statistics.median(ev["batch_ms"][1:])
    log(f"eval from PoseTrack18-format files ({card}): {n} batches of 2, "
        f"msda_forward {eval_launches['msda_forward']} launches ({per_pass}"
        f" per batch); {eval_ms:.2f} ms per batch (median, first excluded);"
        f" {len(stats)} finite stats, {len(ap_keys)} posetrack_ap_* keys "
        f"(posetrack_ap_ap {stats.get('posetrack_ap_ap')})")
    del dev
    torch.cuda.empty_cache()
    return dict(train_launches=train_launches, eval_launches=eval_launches,
                steps=steps, eval_batches=n_eval, warp_err=warp_err,
                warp_ms=warp_ms, warp_device_ms=warp_device_ms,
                step_ms=step_ms, period_ms=period_ms, wait_ms=wait_ms,
                samples_per_s=2e3 / period_ms, losses=losses,
                busy_share=bd["busy_share"], profiled_step=bd,
                host_step_ms=host_step_ms, host_period_ms=host_period_ms,
                decode_ms=decode_ms, raw_getter_ms=raw_getter_ms,
                host_getter_ms=host_getter_ms, eval_batches_real=n,
                eval_ms=eval_ms, posetrack_ap_keys=ap_keys, root=root)


def phase_harness(work, n_frames=4):
    """The PoseTrack18 and COCO harnesses on perfect predictions of a few
    frames written to ``work``: AP 100 and MOTA 100 (PoseTrack, percent),
    AP and AR 1.0 (COCO), as the JAX package's tests assert."""
    import numpy as np

    from snipper_tpu_torch.eval.coco_eval import evaluate_coco_keypoints
    from snipper_tpu_torch.eval.posetrack_eval import evaluate_posetrack18

    rng = np.random.default_rng(0)
    root = os.path.join(work, "harness")
    gt_dir, pred_dir = (os.path.join(root, d) for d in ("gt", "pred"))
    for d in (gt_dir, pred_dir):
        os.makedirs(d)
    # two people over n_frames frames, 15 joints, predictions = GT
    images = [{"id": i} for i in range(n_frames)]
    gt_anns, pred_anns = [], []
    for i in range(n_frames):
        for tid, (x, y) in enumerate(((100, 120), (420, 200))):
            k = np.zeros((15, 3))
            k[:, 0] = x + 3 * i + np.arange(15) * 4.0
            k[:, 1] = y + np.arange(15) % 5 * 12.0
            k[:, 2] = 1.0
            gt_anns.append({"image_id": i, "track_id": tid,
                            "keypoints": k.reshape(-1).tolist(),
                            "bbox_head": [x, y - 40, 30, 40]})
            k[:, 2] = 0.9
            pred_anns.append({"image_id": i, "track_id": 10 + tid,
                              "keypoints": k.reshape(-1).tolist()})
    for d, anns in ((gt_dir, gt_anns), (pred_dir, pred_anns)):
        with open(os.path.join(d, "seq.json"), "w") as f:
            json.dump({"images": images, "annotations": anns}, f)
    pt = evaluate_posetrack18(gt_dir, pred_dir)
    ap = float(pt["ap"]["ap"][-1])
    mota = float(pt["tracking"]["mota"][-1])
    check(abs(ap - 100.0) < 1e-9 and abs(mota - 100.0) < 1e-6,
          f"posetrack harness on perfect predictions: AP {ap}, MOTA {mota}")

    coco_gt = {"images": [{"id": i} for i in range(3)], "annotations": []}
    coco_pred = []
    for i in range(3):
        k = np.zeros((17, 3))
        k[:, 0:2] = rng.uniform(50, 400, (17, 2))
        k[:, 2] = 2
        coco_gt["annotations"].append({
            "image_id": i, "id": i + 1, "category_id": 1,
            "keypoints": k.reshape(-1).tolist(), "area": 5000.0,
            "num_keypoints": 17, "iscrowd": 0})
        coco_pred.append({"image_id": i, "category_id": 1,
                          "keypoints": k.reshape(-1).tolist(),
                          "score": 0.9})
    paths = []
    for name, data in (("coco_gt.json", coco_gt),
                       ("coco_pred.json", coco_pred)):
        paths.append(os.path.join(root, name))
        with open(paths[-1], "w") as f:
            json.dump(data, f)
    coco = evaluate_coco_keypoints(*paths)
    check(abs(coco["AP"] - 1.0) < 1e-9 and abs(coco["AR"] - 1.0) < 1e-9,
          f"coco harness on perfect predictions: {coco}")
    log(f"harness (host numpy, no JAX/motmetrics/pycocotools): PoseTrack18 "
        f"over {n_frames} frames x 2 people AP {ap:.4f}, MOTA {mota:.4f}, "
        f"PCKh {float(pt['pckh']['pckh'][-1]):.4f}; COCO over 3 images AP "
        f"{coco['AP']:.4f}, AR {coco['AR']:.4f}")
    return dict(posetrack_ap=ap, posetrack_mota=mota, coco_ap=coco["AP"],
                coco_ar=coco["AR"])


def phase_train_agreement(tol_loss=1e-4, tol_grad=1e-3):
    """One f32 train step's loss and gradients (canonical_t4_f2, batch 2,
    dropout 0, TF32 off) with the kernels against the same step with the
    plain MSDA forward and VJP on the card. Tolerances: the loss within
    ``tol_loss`` of its size; each gradient tensor within ``tol_grad`` of
    its largest entry (at least 1e-3 of the largest gradient anywhere):
    f32 sums in other orders through 12 layers, and d_value's atomics.
    Then a profiler breakdown of one bf16 train step on the same model."""
    import torch

    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.data.snippet import stack_batch
    from snipper_tpu_torch.data.synthetic import SyntheticDataset
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.ops import deform_attn
    from snipper_tpu_torch.ops.msda import ms_deform_attn_torch
    from snipper_tpu_torch.train.state import create_train_state, param_label
    from snipper_tpu_torch.train.step import (batch_to_device, forward_loss,
                                              train_step)

    set_tf32(False)
    cfg = Config.canonical_t4_f2().replace(dropout=0.0)
    model = perturbed_model(cfg, seed=3).train()
    named = []
    for n, p in model.named_parameters():
        p.requires_grad_(param_label(n) != "frozen")
        if p.requires_grad:
            named.append((n, p))
    ds = SyntheticDataset(cfg, n_samples=2, seed=0)
    batch = batch_to_device(stack_batch([ds[0], ds[1]]),
                            torch.device("cuda"))
    crit = SetCriterion(cfg)

    def step():
        total, _, _, src = forward_loss(model, crit, batch,
                                        mixed_precision=False)
        grads = torch.autograd.grad(total, [p for _, p in named])
        return total.item(), grads, src.cpu()

    loss_k, grads_k, src_k = step()
    wrapper = deform_attn.ms_deform_attn
    deform_attn.ms_deform_attn = ms_deform_attn_torch
    try:
        loss_p, grads_p, src_p = step()
    finally:
        deform_attn.ms_deform_attn = wrapper
    check(torch.equal(src_k, src_p), "the two steps matched differently")
    g_max = max(g.abs().max().item() for g in grads_p)
    worst = (0.0, "", 0.0)
    for (name, _), gk, gp in zip(named, grads_k, grads_p):
        err = (gk - gp).abs().max().item()
        scale = max(gp.abs().max().item(), 1e-3 * g_max)
        check(math.isfinite(err), f"non-finite gradient {name}")
        if err / scale > worst[0]:
            worst = (err / scale, name, err)
    loss_err = abs(loss_k - loss_p)
    check(loss_err <= tol_loss * max(1.0, abs(loss_p)),
          f"train step loss kernel {loss_k} vs plain {loss_p}")
    check(worst[0] <= tol_grad,
          f"train step gradients: {worst[1]} max|diff| {worst[2]} is "
          f"{worst[0]:.3e} of its scale > {tol_grad}")
    log(f"canonical_t4_f2 b2 f32 train step, kernels vs plain MSDA forward "
        f"and VJP on the card (TF32 off, dropout 0): loss {loss_k:.6f} vs "
        f"{loss_p:.6f} (|diff| {loss_err:.3e}, tol {tol_loss:g} relative); "
        f"{len(named)} gradient tensors, largest |grad| {g_max:.4e}, worst "
        f"{worst[1]} max|diff| {worst[2]:.3e} = {worst[0]:.3e} of its scale"
        f" (tol {tol_grad:g}); same matching")
    del grads_k, grads_p

    # where a bf16 train step's time goes (the CLI's step: forward,
    # criterion with the host matching, backward, clip, AdamW), with
    # PyTorch's default TF32 settings
    torch.backends.cudnn.allow_tf32 = True
    state = create_train_state(cfg, model)
    gen = torch.Generator().manual_seed(0)
    bd = breakdown(lambda: train_step(state, crit, batch, gen), top=10,
                   need=("msda_forward", "msda_backward"))
    log(f"one canonical_t4_f2 b2 bf16 train step (cuDNN TF32 on): wall "
        f"{bd['wall_ms']:.2f} ms (CUDA events), device kernels "
        f"{bd['device_ms']:.2f} ms (torch.profiler), busy share "
        f"{bd['busy_share']:.3f}, msda_forward {bd['msda_ms']:.3f} ms, "
        f"msda_backward {bd['msda_backward_ms']:.3f} ms")
    for name, ms, count in bd["top"]:
        log(f"  {ms:9.3f} ms  x{count:<4d} {name}")
    del model, batch, state
    torch.cuda.empty_cache()
    return dict(loss_kernel=loss_k, loss_plain=loss_p, loss_abs_diff=loss_err,
                grad_worst_rel=worst[0], grad_worst_param=worst[1],
                grad_worst_abs=worst[2], grad_max=g_max,
                n_grads=len(named), step_breakdown=bd)


# ------------------------------------------------------------- multi-GPU
# tracks of two serving runs of the same forward (the kernels against
# themselves, cuDNN's choices aside): TOL_FORWARD of the model's outputs,
# scaled to the 800-pixel frames the tracks are in
TOL_TRACKS = TOL_FORWARD * 800
# the decoded per-snippet outputs compared before association (the tracks
# keep only detections above the score threshold)
DECODED = ("human_score", "pred_kpt_scores", "pred_kpts", "pred_depth")


def _max_decoded_diff(got, want):
    """Worst |diff| of two runs' decoded snippet results, each key over
    the larger of 1 and its largest value in ``want``."""
    import numpy as np

    check(len(got) == len(want), f"{len(got)} vs {len(want)} snippets")
    worst = 0.0
    for g, w in zip(got, want):
        for k in DECODED:
            scale = max(1.0, float(np.abs(w[k]).max()))
            worst = max(worst, float(np.abs(g[k] - w[k]).max()) / scale)
    return worst


def _max_tracks_diff(a, b):
    """Max |diff| of two ``tracks.pkl`` dicts, which must hold the same
    identities on the same frames."""
    import numpy as np

    check(a["max_pid"] == b["max_pid"]
          and set(a["frames"]) == set(b["frames"]),
          f"tracks: {a['max_pid']} vs {b['max_pid']} identities, frames "
          f"differ: {set(a['frames']) ^ set(b['frames'])}")
    worst = 0.0
    for k, (pids, data) in a["frames"].items():
        check(list(b["frames"][k][0]) == list(pids),
              f"tracks: frame {k} identities {list(pids)} vs "
              f"{list(b['frames'][k][0])}")
        if data.size:
            worst = max(worst, float(np.abs(b["frames"][k][1] - data).max()))
    return worst


def _rank_phase(inp):
    """One of two gloo ranks on cuda:0 (phase_multi_gpu (a), (b), (d)): an
    f32 canonical_t4_f2 step with dropout 0 on a data-parallel mesh (batch
    1 a rank) and on a tensor-parallel one (the batch of 2, 4 heads a
    rank), then ``cli.infer``'s serving function over the two ranks. Each
    run's kernel counts are set to 0 just before it and read just after."""
    import numpy as np
    import torch

    from snipper_tpu_torch.cli.infer import serve_snippets
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.infer.pipeline import associate_snippets
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.models.snipper import build_model
    from snipper_tpu_torch.ops.msda import ms_deform_attn
    from snipper_tpu_torch.parallel import multihost
    from snipper_tpu_torch.parallel.mesh import gather, make_mesh, shard_model
    from snipper_tpu_torch.train.state import create_train_state
    from snipper_tpu_torch.train.step import (average_gradients,
                                              average_metrics,
                                              batch_to_device, forward_loss)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rank = multihost.process_index()
    cfg = Config.canonical_t4_f2().replace(dropout=0.0)
    weights = torch.load(inp["weights"], map_location=dev, weights_only=True)
    host = dict(np.load(inp["batch"]))
    out = {}
    for name, (dp, tp) in (("dp2", (2, 1)), ("tp2", (1, 2))):
        set_tf32(False)
        mesh = make_mesh(dp, tp)
        model = build_model(cfg, device=dev, seed=0)
        model.load_state_dict(weights)
        shard_model(model, mesh).train()
        state = create_train_state(cfg, model, mesh=mesh)
        crit = SetCriterion(cfg, mesh=mesh)
        per = 2 // dp
        rows = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
        batch = batch_to_device(
            {"images": host["images"][rows],
             "targets": {k: host[k][rows] for k in ("kpts2d", "depth",
                                                    "valid")}}, dev)
        step_ms, reduce_ms = [], []
        for i in range(3):
            torch.cuda.synchronize()
            if i == 0:
                # ---- this rank's step, with its kernels' counts at 0 ----
                ms_deform_attn.launches = 0
                ms_deform_attn.backward_launches = 0
            t0 = time.perf_counter()
            total, _, _, src = forward_loss(model, crit, batch, False)
            grads = torch.autograd.grad(total, state.params)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            grads = average_gradients(grads, mesh)
            ev[1].record()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            reduce_ms.append(ev[0].elapsed_time(ev[1]))
            if i == 0:
                launches = {"msda_forward": ms_deform_attn.launches,
                            "msda_backward": ms_deform_attn.backward_launches}
                # -------------------------------------------------------
        loss = average_metrics({"loss": total.detach()}, mesh)["loss"].item()
        names = {id(p): n for n, p in model.named_parameters()}
        full = {names[id(p)]: (g if getattr(p, "tp_spec", None) is None
                               else gather(g, p.tp_spec, mesh)).cpu()
                for p, g in zip(state.params, grads)}
        if rank == 0:
            torch.save(full, inp[f"grads_{name}"])
        out[name] = dict(loss=loss, src=src.cpu().numpy(), launches=launches,
                         heads=model.transformer.encoder_layer0.self_attn
                         .n_heads, step_ms=step_ms, allreduce_ms=reduce_ms,
                         flat_mb=sum(g.numel() for g in grads) * 4 / 1e6)
        del model, state, grads, full, batch, total
        torch.cuda.empty_cache()

    # (d) cli.infer's serving function on the two ranks, as phase 4 ran it
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    icfg = Config.canonical_t4()
    model = build_model(icfg, device=dev, seed=0)
    model.load_state_dict(torch.load(inp["infer_ckpt"], map_location=dev,
                                     weights_only=True)["params"])
    # ---- this rank's serving, with its kernel's count at 0 --------------
    ms_deform_attn.launches = 0
    served = serve_snippets(model, icfg, inp["frames"], 1, dev)
    launches = ms_deform_attn.launches
    # ----------------------------------------------------------------------
    out["serve"] = dict(snippets=served["snippets"], seconds=served["seconds"],
                        done_at=served["done_at"], launches=launches,
                        total=len(served["results"]))
    if rank == 0:
        frames, max_pid = associate_snippets(
            served["results"], *served["index"], icfg.num_frames, 1,
            icfg.max_depth)
        out["serve"]["tracks"] = {"frames": frames, "max_pid": max_pid}
        out["serve"]["results"] = [{k: r[k] for k in DECODED}
                                   for r in served["results"]]
    return out


def _torchrun(work, mode, argv):
    """``python -m torch.distributed.run --standalone --nproc_per_node 1
    chip_smoke.py --torchrun-cli MODE OUT.json ARGV``: the CLI ``mode``
    (train or infer) under torchrun's environment; returns what the child
    wrote (its launch counts and the CLI's result) and its output."""
    out_json = os.path.join(work, f"torchrun_{mode}.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__),
           "--torchrun-cli", mode, out_json, *argv]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in proc.stdout.splitlines()[-12:]:
        log(f"  | {line}")
    check(proc.returncode == 0,
          f"torchrun {mode} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    with open(out_json) as f:
        return json.load(f), proc.stdout


def torchrun_cli(mode, out_json, argv):
    """The child of :func:`_torchrun`: ``mode``'s CLI ``main(argv)`` with
    the kernels' counts set to 0 just before and read just after, written
    to ``out_json`` with the CLI's numbers."""
    from snipper_tpu_torch.ops.msda import ms_deform_attn

    if mode == "train":
        from snipper_tpu_torch.cli.train import main as cli_main
    else:
        from snipper_tpu_torch.cli.infer import main as cli_main
    # ---- the CLI, with every kernel's count at 0 -------------------------
    ms_deform_attn.launches = 0
    ms_deform_attn.backward_launches = 0
    res = cli_main(argv)
    launches = {"msda_forward": ms_deform_attn.launches,
                "msda_backward": ms_deform_attn.backward_launches}
    # ----------------------------------------------------------------------
    if mode == "train":
        keep = {"checkpoint": res["checkpoint"],
                "losses": [h["loss_total"] for h in res["history"]],
                "period_s": [h["seconds"] + h["data_seconds"]
                             for h in res["history"]]}
    else:
        keep = {k: res[k] for k in ("snippets", "seconds", "done_at",
                                    "forward_ms")}
    with open(out_json, "w") as f:
        json.dump({"launches": launches, **keep}, f)
    return 0


def phase_multi_gpu(work, card):
    """The multi-GPU paths on one card, which shows them right, not
    scaling: (a) an f32 canonical_t4_f2 step (dropout 0, TF32 off) on two
    gloo ranks of cuda:0, batch 1 each, against the single-process step of
    batch 2 on the same weights (its criterion at ``dp_size`` 2, as the
    JAX CLI's on that mesh): loss within 1e-4 relative, every gradient
    within 1e-3 of its scale, the same matching; (b) the same with the
    heads cut over the two ranks (tp2, the batch of 2 on both, against
    ``dp_size`` 1; 12 launches of each MSDA kernel per rank and step, at
    4 heads); (c) through
    ``torchrun --standalone --nproc_per_node 1`` (NCCL): ``cli.train`` for
    3 bf16 steps and its checkpoint, then ``cli.infer --data_parallel``
    over phase 4's frames, 12 launches per snippet, its tracks within
    TOL_TRACKS of phase 4's; (d) ``cli.infer``'s serving function on the
    two gloo ranks, the same tracks, and the decoded outputs of every
    snippet within TOL_FORWARD of one process's serving (the tracks keep
    only detections; random weights may have none); (e) ``probe
    meshscale``: exit 0, no FAIL. Step times by the host clock, the
    gradient all-reduce by CUDA events, serving rates by the CLI's
    timestamps."""
    import numpy as np
    import torch

    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.data.snippet import stack_batch
    from snipper_tpu_torch.data.synthetic import SyntheticDataset
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.ops.msda import ms_deform_attn
    from snipper_tpu_torch.parallel import multihost
    from snipper_tpu_torch.train.state import create_train_state
    from snipper_tpu_torch.train.step import batch_to_device, forward_loss

    res = {}
    per_pass = Config.canonical_t4_f2().enc_layers \
        + Config.canonical_t4_f2().dec_layers
    # ---- the single-process reference: one f32 step of batch 2 ----------
    set_tf32(False)
    cfg = Config.canonical_t4_f2().replace(dropout=0.0)
    model = perturbed_model(cfg, seed=3).train()
    state = create_train_state(cfg, model)
    ds = SyntheticDataset(cfg, n_samples=2, seed=0)
    host = stack_batch([ds[0], ds[1]])
    inp = {"weights": os.path.join(work, "mg_weights.pt"),
           "batch": os.path.join(work, "mg_batch.npz"),
           "grads_dp2": os.path.join(work, "mg_grads_dp2.pt"),
           "grads_tp2": os.path.join(work, "mg_grads_tp2.pt"),
           "infer_ckpt": os.path.join(work, "canonical_t4_seed0.pt"),
           "frames": os.path.join(work, "frames")}
    torch.save(model.state_dict(), inp["weights"])
    np.savez(inp["batch"], images=host["images"], **host["targets"])
    batch = batch_to_device(host, torch.device("cuda"))
    names = {id(p): n for n, p in model.named_parameters()}
    refs = {}
    # the ranks' criteria keep the heatmap's bare sum, so that their
    # average over a data axis of 2 is one process's at dp_size 2 (the
    # JAX CLI's); over a model axis the ranks share one batch: dp_size 1
    for name, dp_size in (("dp2", 2), ("tp2", 1)):
        total, _, _, src = forward_loss(model, SetCriterion(cfg, dp_size),
                                        batch, False)
        grads = torch.autograd.grad(total, state.params)
        refs[name] = ({names[id(p)]: g.cpu()
                       for p, g in zip(state.params, grads)},
                      total.item(), src.cpu().numpy())
    del model, state, batch, grads, total
    torch.cuda.empty_cache()

    # ...and one process's serving of phase 4's frames, to hold (d) to
    from snipper_tpu_torch.cli.infer import serve_snippets
    from snipper_tpu_torch.models.snipper import build_model

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    icfg = Config.canonical_t4()
    model = build_model(icfg, device="cuda", seed=0)
    model.load_state_dict(torch.load(inp["infer_ckpt"], weights_only=True)
                          ["params"])
    single = serve_snippets(model, icfg, inp["frames"], 1,
                            torch.device("cuda"))["results"]
    del model
    torch.cuda.empty_cache()

    # ---- (a), (b), (d): two gloo ranks on cuda:0 -------------------------
    t0 = time.perf_counter()
    ranks = multihost.spawn(_rank_phase, 2, (inp,), backend="gloo",
                            timeout_s=600)
    launch_s = time.perf_counter() - t0
    for name in ("dp2", "tp2"):
        want, want_loss, want_src = refs[name]
        g_max = max(g.abs().max().item() for g in want.values())
        got = torch.load(inp[f"grads_{name}"], weights_only=True)
        worst = (0.0, "", 0.0)
        for k, w in want.items():
            err = (got[k] - w).abs().max().item()
            scale = max(w.abs().max().item(), 1e-3 * g_max)
            check(math.isfinite(err), f"{name}: non-finite gradient {k}")
            if err / scale > worst[0]:
                worst = (err / scale, k, err)
        rows = [r[name] for r in ranks]
        per = 2 if name == "tp2" else 1
        for r, row in enumerate(rows):
            lo = 0 if per == 2 else r
            check(abs(row["loss"] - want_loss) <= 1e-4 * abs(want_loss),
                  f"{name} rank {r}: loss {row['loss']} vs the single "
                  f"process's {want_loss}")
            check(np.array_equal(row["src"], want_src[lo:lo + per]),
                  f"{name} rank {r} matched differently")
            check(row["launches"] == {"msda_forward": per_pass,
                                      "msda_backward": per_pass},
                  f"{name} rank {r}: launches {row['launches']} in a step, "
                  f"expected {per_pass} of each")
        check(worst[0] <= 1e-3,
              f"{name} gradients: {worst[1]} max|diff| {worst[2]:.3e} is "
              f"{worst[0]:.3e} of its scale > 1e-3")
        res[name] = dict(loss=rows[0]["loss"], want_loss=want_loss,
                         grad_worst_rel=worst[0], grad_worst_param=worst[1],
                         launches=[r["launches"] for r in rows],
                         heads=rows[0]["heads"],
                         step_ms=[statistics.median(r["step_ms"][1:])
                                  for r in rows],
                         allreduce_ms=[statistics.median(r["allreduce_ms"][1:])
                                       for r in rows],
                         flat_mb=rows[0]["flat_mb"])
        reduce = (f"gradient all-reduce of {rows[0]['flat_mb']:.1f} MB "
                  f"{res[name]['allreduce_ms']} ms (CUDA events; gloo "
                  f"through the host)" if name == "dp2" else
                  "no gradient all-reduce (a data axis of 1); the heads' "
                  "all-reduces run inside the forward and backward")
        log(f"multi-GPU ({name}, two gloo ranks on cuda:0, f32, TF32 off, "
            f"dropout 0; {card}): canonical_t4_f2 step, batch {per} a "
            f"rank, {rows[0]['heads']} heads a rank; loss "
            f"{rows[0]['loss']:.6f} vs one process's batch-2 step "
            f"{want_loss:.6f}; worst gradient {worst[1]} {worst[0]:.3e} of "
            f"its scale (tol 1e-3); same matching; launches per rank and "
            f"step {[r['launches'] for r in rows]}; step "
            f"{res[name]['step_ms']} ms per rank (host clock, median of 2 "
            f"after the first); {reduce}")
    serve = [r["serve"] for r in ranks]
    with open(os.path.join(work, "out", "tracks.pkl"), "rb") as f:
        phase4 = pickle.load(f)
    n_total = serve[0]["total"]
    check(sum(s["snippets"] for s in serve) == n_total and all(
          s["launches"] == per_pass * s["snippets"] for s in serve),
          "two-rank serving: snippets and launches "
          f"{[(s['snippets'], s['launches']) for s in serve]} over "
          f"{n_total}")
    diff_d = _max_tracks_diff(phase4, serve[0]["tracks"])
    check(diff_d <= TOL_TRACKS, f"two-rank serving tracks differ from "
          f"phase 4's by {diff_d} > {TOL_TRACKS}")
    dec_d = _max_decoded_diff(serve[0]["results"], single)
    check(dec_d <= TOL_FORWARD, f"two-rank serving's decoded outputs "
          f"differ from one process's by {dec_d} of scale > {TOL_FORWARD}")
    span = max(s["done_at"][-1] for s in serve) - min(s["done_at"][0]
                                                      for s in serve)
    # every rank's first snippet excluded, as phase 4's rate does
    res["serve_two_ranks"] = dict(
        snippets=[s["snippets"] for s in serve],
        launches=[s["launches"] for s in serve], tracks_diff=diff_d,
        decoded_diff=dec_d,
        snippets_per_s=(n_total - 2) / span if span > 0 else None,
        seconds=[s["seconds"] for s in serve], launch_s=launch_s)
    log(f"serving function on two gloo ranks of cuda:0 ({card}): "
        f"{res['serve_two_ranks']['snippets']} snippets and "
        f"{res['serve_two_ranks']['launches']} msda_forward launches per "
        f"rank ({per_pass} per snippet); tracks within {diff_d:.3e} of "
        f"phase 4's (tol {TOL_TRACKS:g}), decoded outputs (all 60 queries, "
        f"before the score threshold) within {dec_d:.3e} of one process's "
        f"(of scale; tol {TOL_FORWARD:g}); "
        f"{res['serve_two_ranks']['snippets_per_s']} snippets/s over both "
        f"ranks (first of each excluded), the two sharing one card")

    # ---- (c) torchrun at world size 1 (NCCL) -----------------------------
    tr, out = _torchrun(work, "train", [
        "--preset", "canonical_t4_f2", "--synthetic", "--batch_size", "2",
        "--synthetic_distinct", "2", "--epochs", "1", "--steps_per_epoch",
        "3", "--eval_every", "2", "--output_dir",
        os.path.join(work, "torchrun_train"), "--device", "cuda"])
    check("process group: nccl, world 1" in out,
          "torchrun cli.train: no NCCL process group line")
    check(tr["launches"] == {"msda_forward": 3 * per_pass,
                             "msda_backward": 3 * per_pass},
          f"torchrun cli.train launches {tr['launches']} in 3 steps")
    check(all(math.isfinite(x) for x in tr["losses"])
          and os.path.exists(tr["checkpoint"]),
          f"torchrun cli.train: losses {tr['losses']}, checkpoint "
          f"{tr['checkpoint']}")
    ti, out = _torchrun(work, "infer", [
        "--preset", "canonical_t4", "--data_dir", inp["frames"],
        "--output_dir", os.path.join(work, "torchrun_infer"), "--seq_gap",
        "1", "--resume", inp["infer_ckpt"], "--data_parallel", "--device",
        "cuda"])
    check("process group: nccl, world 1" in out,
          "torchrun cli.infer: no NCCL process group line")
    check(ti["launches"]["msda_forward"] == per_pass * ti["snippets"],
          f"torchrun cli.infer: {ti['launches']} launches for "
          f"{ti['snippets']} snippets")
    with open(os.path.join(work, "torchrun_infer", "tracks.pkl"), "rb") as f:
        diff_c = _max_tracks_diff(phase4, pickle.load(f))
    check(diff_c <= TOL_TRACKS, f"torchrun cli.infer tracks differ from "
          f"phase 4's by {diff_c} > {TOL_TRACKS}")
    done = ti["done_at"]
    res["torchrun"] = dict(
        train_launches=tr["launches"], train_losses=tr["losses"],
        train_period_ms=[x * 1e3 for x in tr["period_s"]],
        infer_launches=ti["launches"], infer_snippets=ti["snippets"],
        infer_snippets_per_s=(ti["snippets"] - 1) / (done[-1] - done[0]),
        infer_tracks_diff=diff_c)
    log(f"torchrun --standalone --nproc_per_node 1 (NCCL; {card}): "
        f"cli.train 3 bf16 steps, launches {tr['launches']}, periods "
        f"{[round(x, 2) for x in res['torchrun']['train_period_ms']]} ms, "
        f"losses {[round(x, 4) for x in tr['losses']]}, checkpoint "
        f"{os.path.basename(tr['checkpoint'])}; cli.infer --data_parallel "
        f"{ti['snippets']} snippets, {ti['launches']['msda_forward']} "
        f"msda_forward launches, {res['torchrun']['infer_snippets_per_s']:.3f}"
        f" snippets/s (first excluded), tracks within {diff_c:.3e} of "
        f"phase 4's (tol {TOL_TRACKS:g})")

    # ---- (e) probe meshscale ---------------------------------------------
    log("probe meshscale (python -m snipper_tpu_torch.scripts.probe "
        "meshscale):")
    ms_deform_attn.launches = 0
    rc, out = _run_probe(["meshscale", "--device", "cuda"])
    ms_launches = ms_deform_attn.launches
    check(rc == 0 and "FAIL" not in out and out.rstrip().endswith("DONE")
          and "n=1: " in out and ms_launches > 0,
          f"probe meshscale exited {rc}, printed FAIL, or launched "
          f"{ms_launches}")
    res["meshscale"] = dict(lines=[ln for ln in out.splitlines()
                                   if ln.startswith("n=")],
                            launches=ms_launches)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        import snipper_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    check(smi, "nvidia-smi printed nothing")
    card = smi[0].strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # 2. build
    from snipper_tpu_torch.ops import _build

    sources = ("msda_forward", "msda_backward", "win2d", "lane_chain")
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(
            lambda s: _build.build(f"{s}.cu", f"lib{s}.so"), sources))
    ptxas = {}
    for src, b in zip(sources, built):
        log(f"built {b['path'].name} in {b['seconds']:.2f} s")
        ptxas[src] = ptxas_report(b["log"], _build.find_nvcc())
        for kern, r in ptxas[src].items():
            log(f"  ptxas {kern}: {r.get('registers')} registers, "
                f"{r.get('smem_bytes')} B static shared memory, spills "
                f"{r.get('spill_stores')} B stored / {r.get('spill_loads')}"
                f" B loaded")

    # 3. kernels against their plain versions
    shapes_res = phase_kernels()
    bwd_res = phase_backward()
    log("msda per-shape times, ms per call f32 / bf16 value [device time "
        "alone f32 / bf16] (" + card + "): forward "
        + ", ".join(f"{k} {r['ms']:.4f} / {r['bf16_ms']:.4f} "
                    f"[{r['device_ms']:.4f} / {r['bf16_device_ms']:.4f}]"
                    for k, r in shapes_res.items())
        + "; backward "
        + ", ".join(f"{k} {r['f32_ms']:.4f} / {r['bf16_ms']:.4f} "
                    f"[{r['f32_device_ms']:.4f} / {r['bf16_device_ms']:.4f}]"
                    for k, r in bwd_res.items()))
    win_res = phase_windowed_kernels()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        # 4. the inference path, with the host warp, then the device warp
        main_res = phase_main_path(work)
        serve_res = phase_serving_device(work, main_res, card)
        # 4a. serving profiles and the exported artifact
        fast_res = phase_fast_export(work, card, main_res)
        # 5. the training path, then the eval CLI on its checkpoint
        train_res = phase_train(work)
        eval_res = phase_eval(work, train_res["checkpoint"])
        # 5a. training and eval from reference-format files
        real_res = phase_train_real(work, card)
        # 5b. the PoseTrack/COCO harness
        harness_res = phase_harness(work)
        # 5c. a profiled training run, the label dump
        prof_res = phase_profile_labels(work, card, real_res["root"])
        # 5d. the multi-GPU paths on this card
        mg_res = phase_multi_gpu(work, card)
    # 6. a train step, kernels against the plain MSDA
    agree_res = phase_train_agreement()
    # 8. the probe path
    probe_res = phase_probes()

    enc = shapes_res["encoder"]
    benc = bwd_res["train_encoder"]
    kernels = [{
        "name": "msda_forward",
        "route": "cuda",
        "source": "snipper_tpu_torch/ops/csrc/msda_forward.cu",
        "replaces": "snipper_tpu/ops/pallas_deform.py:43",
        "launches": main_res["launches"]["msda_forward"],
        "max_abs_err": max(r["max_abs_err"] for r in shapes_res.values()),
        "ms": enc["ms"],
        "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"],
        "library_ms": None,
        "library": "null: the corner decomposition from loc is part of its "
                   "work; no one PyTorch call",
        "at": "inference encoder shape, f32: N=4 Lq=9875 H=8 D=48 L=3 P=4",
        "ptxas": ptxas["msda_forward"],
        "per_snippet_launches": main_res["per_snippet"],
        "device_preprocess_serving_launches":
            serve_res["launches"]["msda_forward"],
        "fast_serving_launches": fast_res["fast_launches"],
        "export_launches": fast_res["export_launches"],
        "profiled_train_launches": prof_res["launches"]["msda_forward"],
        "train_launches": train_res["launches"]["msda_forward"],
        "per_train_forward_launches": train_res["per_forward"],
        "eval_launches": eval_res["launches"]["msda_forward"],
        "per_eval_batch_launches": eval_res["per_batch"],
        "real_train_launches": real_res["train_launches"]["msda_forward"],
        "real_eval_launches": real_res["eval_launches"]["msda_forward"],
        "dp2_step_launches_per_rank": [
            r["msda_forward"] for r in mg_res["dp2"]["launches"]],
        "tp2_step_launches_per_rank": [
            r["msda_forward"] for r in mg_res["tp2"]["launches"]],
        "two_rank_serving_launches": mg_res["serve_two_ranks"]["launches"],
        "torchrun_train_launches":
            mg_res["torchrun"]["train_launches"]["msda_forward"],
        "torchrun_infer_launches":
            mg_res["torchrun"]["infer_launches"]["msda_forward"],
        "shapes": shapes_res,
    }, {
        "name": "msda_backward",
        "route": "cuda",
        "source": "snipper_tpu_torch/ops/csrc/msda_backward.cu",
        "replaces": "snipper_tpu/ops/pallas_deform.py:390",
        "launches": train_res["launches"]["msda_backward"],
        "max_abs_err": max(e["max_abs_err"] for r in bwd_res.values()
                           for e in r["f32"].values()),
        "ms": benc["f32_ms"],
        "plain_ms": benc["f32_plain_ms"],
        "bound_ms": benc["f32_bound_ms"],
        "bound_by": benc["f32_bound_by"],
        "library_ms": None,
        "library": "null: the VJP of the corner decomposition; no one "
                   "PyTorch call",
        "at": "train encoder shape, f32: N=8 Lq=9875 H=8 D=48 L=3 P=4",
        "ptxas": ptxas["msda_backward"],
        "per_train_step_launches": train_res["per_step"],
        "profiled_train_launches": prof_res["launches"]["msda_backward"],
        "real_train_launches": real_res["train_launches"]["msda_backward"],
        "real_eval_launches": real_res["eval_launches"]["msda_backward"],
        "dp2_step_launches_per_rank": [
            r["msda_backward"] for r in mg_res["dp2"]["launches"]],
        "tp2_step_launches_per_rank": [
            r["msda_backward"] for r in mg_res["tp2"]["launches"]],
        "torchrun_train_launches":
            mg_res["torchrun"]["train_launches"]["msda_backward"],
        "shapes": bwd_res,
    }]
    k2 = win_res["win2d_sample"]
    kernels.append({
        "name": "win2d_sample",
        "route": "cuda",
        "source": "snipper_tpu_torch/ops/csrc/win2d.cu",
        "replaces": "snipper_tpu/ops/pallas_deform.py:186",
        "launches": probe_res["launches"]["win2d_sample"],
        "max_abs_err": max(r["max_abs_err"] for r in k2.values()
                           if r["dtype"] == "float32"),
        "ms": k2["encoder_bf16"]["ms"],
        "device_ms": k2["encoder_bf16"]["device_ms"],
        "plain_ms": k2["encoder_bf16"]["plain_ms"],
        "bound_ms": k2["encoder_bf16"]["bound_ms"],
        "bound_by": k2["encoder_bf16"]["bound_by"],
        "library_ms": k2["encoder_bf16"]["library_ms"],
        "library": "embedding_bag(mode='sum') over the value's global rows "
                   "(bf16 rows and weights), bags in the output's order",
        "at": "probe op encoder fixture, bf16 value, per op call (3 "
              "launches, one per query segment): B=4 S=9875 H=8 D=48 L=3 "
              "P=4, block 8x20, margin 5",
        "ptxas": {k: v for k, v in ptxas["win2d"].items()
                  if "win2d_sample_kernel" in k},
        "shapes": k2,
    })
    for name, replaces in (("win2d_contract", "scripts/lanegather_probe.py:217"),
                           ("hier_gather", "scripts/lanegather_probe.py:164"),
                           ("chain_gather", "scripts/lanegather_probe.py:69"),
                           ("chain_select", "scripts/lanegather_probe.py:78")):
        rows = win_res[name]
        head = rows[list(rows)[-1]]  # the full op-call scale fixture
        chain = name.startswith("chain")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "snipper_tpu_torch/ops/csrc/"
                      + ("lane_chain.cu" if chain else "win2d.cu"),
            "replaces": replaces,
            "launches": probe_res["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head.get("library_ms"),
            "library": "null: a chain of 64 dependent steps is no one "
                       "PyTorch call" if chain else
                       "embedding_bag(mode='sum') over one table of every "
                       "level's windows, bags in K5's [NB, BH, C] order",
            "at": list(rows)[-1],
            "shapes": rows,
        })
        kernels[-1]["device_ms"] = head["device_ms"]
        kernels[-1]["ptxas"] = {
            k: v for k, v in ptxas["lane_chain" if chain else "win2d"].items()
            if f"{name}_kernel" in k}
        if chain:
            kernels[-1]["issue_ms"] = head["issue_ms"]
            kernels[-1]["sm_clock_mhz"] = head["sm_clock_mhz"]
    log(f"card: {card}; inference path "
        f"{main_res['steady_snippets_per_s']:.3f} snippets/s (host warp), "
        f"{serve_res['steady_snippets_per_s']:.3f} (--device_preprocess), "
        f"{fast_res['fast_steady_snippets_per_s']:.3f} (--fast {FAST_SPEC}); "
        f"artifact {fast_res['serve']['ratio']:.3f}x live, "
        f"{fast_res['export_bytes'] / 1e6:.1f} MB; "
        f"eval {eval_res['batch_ms']:.2f} ms/batch; harness AP "
        f"{harness_res['posetrack_ap']:g} MOTA "
        f"{harness_res['posetrack_mota']:g}; training "
        f"path period {train_res['period_ms']:.2f} ms/step, "
        f"{train_res['samples_per_s']:.3f} samples/s, peak "
        f"{train_res['peak_gb']:.2f} GB; from PoseTrack18-format files "
        f"{real_res['period_ms']:.2f} ms/step with --device_preprocess, "
        f"{real_res['host_period_ms']:.2f} with the host warp; train step "
        f"kernels vs plain: "
        f"gradients within {agree_res['grad_worst_rel']:.3e} of scale; "
        f"probe op windowed2d_pallas {probe_res['op_ms']['windowed2d_pallas']}"
        f" ms/op-call (relerr {probe_res['relerr']:.2e}); multi-GPU on "
        f"one card: dp2 step {mg_res['dp2']['step_ms']} ms with a "
        f"{mg_res['dp2']['allreduce_ms']} ms gradient all-reduce (gloo), "
        f"tp2 step {mg_res['tp2']['step_ms']} ms, two-rank serving "
        f"{mg_res['serve_two_ranks']['snippets_per_s']} snippets/s, "
        f"torchrun cli.infer --data_parallel "
        f"{mg_res['torchrun']['infer_snippets_per_s']:.3f} snippets/s; "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--torchrun-cli"]:
        sys.exit(torchrun_cli(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
