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
   at K1's shapes (inference and train, encoder and decoder, and the
   train shapes of a tensor-parallel rank) one ``embedding_bag`` call of
   ``msda_forward``'s function, and at the train shapes that call's
   backward in f32 (its d_value and d_attn held against the plain
   VJP's); print the per-shape times.
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
   default specs (exit 0, no FAIL), the f32 canonical_t4 export (cut to
   two encoder and two decoder layers at full width) on the card saved
   and loaded in a subprocess that imports only torch and the
   MSDA operators (12 launches per call, the live model's outputs within
   1e-5), the bf16 export (JAX's bf16 recipe: bf16 weights only, about
   half the size, 12 launches per call, the live bf16 forward's outputs
   within one bf16 unit, JAX's output dtypes), each artifact against its
   live forward in turns, and the ``probe serve`` lines (bf16 weights, f32
   input).
   Then the host ops (``data/native_ops.py``, built by the host C++
   compiler in phase 2; its command and build seconds printed, the op
   required): ``warp_patch`` against the port's numpy path at 1920x1080
   and 1280x720 sources to 600x800 (rotation, flip, colour, a border off
   the frame), one frame timed native against numpy and four frames on four
   threads against one (host clock); ``lsa_pairs`` against scipy's optimal
   cost on eval-sized costs (60 queries, up to 20 targets).
5. Drive the training path: ``snipper_tpu_torch.cli.train`` on
   canonical_t4_f2 (full width and depth), batch 2, bf16 mixed precision
   (JAX's recipe: the forward on bf16 copies of the f32 weights), a few
   steps over the synthetic dataset, then its checkpoint and its
   evaluation; counts set to 0 just before and read just after. Check the
   launches per step, the checkpoint and finite losses. Then drive
   ``snipper_tpu_torch.cli.eval`` on that checkpoint (4 synthetic batches
   of 2, ``--save_vis --write_posetrack``; counts at 0 just before, read
   just after): launches per batch, finite ``eval_stats.json``, the
   renders, ms per eval batch. Then the PoseTrack18 and COCO harnesses on
   perfect predictions: AP 100 and MOTA 100.
   Then training to accuracy through ``cli.train`` and ``cli.eval``, bf16
   mixed precision, counts at 0 just before and read just after each run
   (launches per update and per eval batch): (a) the protocol of
   tests/test_train_accuracy.py at tiny (the random-init floor, 400
   updates of 8 over 8 fixed synthetic samples with the StepLR drop at
   epoch 10, the checkpoint's eval), held to that test's bars; (b)
   canonical_t4_f2 at full width cut to two encoder and two decoder
   layers, 1600 updates of 2 over 8 fixed samples, held to a halved
   loss, a halved pel-MPJPE and a 3DPCK 0.2 over the floor's, with JAX's
   bars reported; per leg the stats, the loss at
   updates 1, 100, 200, 300, 400 (and 800, 1200, 1600), ms per update,
   peak memory, seconds.
   Then training and eval from reference-format files: a PoseTrack18-format
   set (two videos, 1280x720 and 1920x1080) written and extracted with the
   port's ``preprocess.posetrack``; the card's train warp held against the
   host ``warp_patch`` on one loader batch and timed;
   ``cli.train --posetrack_dir --device_preprocess`` for a few steps and
   one eval (counts at 0 just before, read just after: launches per step
   and per eval batch, finite losses, the checkpoint, the busy share of
   one profiled step from raw frames), the same with the host warp (step
   time, the loader's host decode and warp; the host op's C++ warp, then a
   short leg with the op's numpy path for the numpy period in the same
   run), and ``cli.eval`` with the
   PoseTrack harness on the checkpoint (launches per batch, finite stats
   with the ``posetrack_ap_*`` keys, ms per batch). Then ``cli.train
   --profile_dir`` for 4 steps (counts at 0 just before, read just after;
   the trace's summary names both MSDA kernels with device time, and the
   matching's host span), and ``cli.dump_labels`` on the PoseTrack18-format
   val split (one pickle entry per sample, the ``--vis 2`` renders).
   Then the parity runbook (``scripts/parity_runbook.py``) on a
   reference-format canonical_t4 checkpoint of seeded weights: its
   ``torch_outputs.npz`` against the live forward (1e-5), and its
   ``cli.eval`` leg on the PoseTrack18-format set (finite stats).
   Then the multi-GPU paths on this one card (right, not scaling): an f32
   canonical_t4_f2 step cut to two encoder and two decoder layers at full
   width (dropout 0, TF32 off) on two gloo ranks of cuda:0,
   data-parallel (batch 1 a rank) and tensor-parallel (4 heads a rank),
   each against one process's batch-2 step on the same weights (loss,
   every gradient, the matching; 4 launches of each MSDA kernel and one
   ``lsa_rows`` per rank and step, counts at 0 just before and read just
   after), with each rank's step time and the gradient all-reduce's time;
   ``cli.train`` (3 bf16 steps at that depth and a checkpoint) and
   ``cli.infer
   --data_parallel`` through ``torchrun --standalone --nproc_per_node 1``
   (NCCL), the tracks against the first serving run's; ``cli.infer``'s
   serving function on two gloo ranks of cuda:0, the same tracks; ``probe
   meshscale`` (exit 0, no FAIL).
6. Hold one f32 train step (dropout 0) with the kernels against the same
   step with the plain MSDA forward and VJP and the plain assignment on
   the card, TF32 off: loss, gradients and every decoder layer's
   matching. Then the assignment kernel ``lsa_rows`` (JAX's
   Jonker-Volgenant solver) against its plain version on every slot of
   tied, continuous and edge-shape fixtures and of a real canonical_t4_f2
   b2 bf16 step's 12 problems, timed beside its bound, the plain version
   and the host scipy route; that step (forward, criterion, backward,
   update) runs under ``torch.cuda.set_sync_debug_mode("error")`` with
   one ``lsa_rows`` launch, its loss read after it.
   Between the two, the five presets that no other phase runs
   (canonical_t1, light_t4, light_t4_f2, jta_forecast at 540x960,
   panoptic at 540x960 with 20 queries), each at its own width, queries,
   frames and image size: the bench's bf16 b1 forward at full depth (one
   launch per layer; each MSDA call and the whole forward against the
   plain MSDA; shapes; ms a forward) and one f32 train step at two
   encoder and two decoder layers against the plain step (loss,
   gradients, every decoder layer's matching in one ``lsa_rows``
   launch); ``cli.infer`` of panoptic over 960x540 frames and of
   canonical_t1 (launches per snippet, finite tracks, every query scored
   a person); then ``deform_dtype="float32"``: the bench's canonical_t4
   forward (12 launches of the f32-value kernel, held against the plain
   MSDA, against the "auto" forward in bf16 units, ms and device time of
   both) and a bf16 canonical_t4_f2 step at two and two layers (4 + 4
   f32-value launches, held against the plain step beside the plain
   step with its levels summed in the other order; step ms of both).
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
   Then ``probe forward`` (canonical_t4 and light_t1, batch 1 and 4, bf16
   weights and input;
   one ``msda_forward`` launch per decoder and encoder layer and forward
   call), ``probe train -K 2`` (canonical_t4_f2, batch 2, mixed precision;
   12 forward and 12 backward launches per step) and ``probe split -K 3``
   (``deform_impl="skip"``: no launch), each with the counts at 0 just
   before and read just after, exit 0 and no FAIL line.
9. Drive the bench: ``python -m snipper_tpu_torch.bench`` in a fresh
   process (``chip_smoke.py --bench-child``, which runs the module as
   ``-m`` does with the counts set to 0 just before and read just after):
   exit 0, its one JSON line (logged) with no FAIL, ``sampling_overflow``
   0, numbers for every leg and the bound, its ``device`` naming this
   card, and one ``msda_forward`` launch per layer and forward call, one
   ``msda_backward`` per layer and train step. Then the bench's
   canonical_t4 b1 forward (bf16 weights cast once, a bf16 input; 12
   launches a forward): each MSDA call, kernel against plain on the
   inputs it received, within one bf16 rounding; the whole forward,
   kernel against plain MSDA, within the spread of the plain forward
   against itself with its levels summed in the other order; and that forward's kernel launches and busy share beside
   those of the bf16-autocast forward that the recipe replaced (1738 and
   0.337 on an H100).
10. Print one JSON line of kernel numbers, then the card's name and power
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
# the largest of that gradient (at least 1). d_value's sums run in another
# order than the plain VJP's (each row's hits in one fixed order, so the
# same bits on every run), and d_loc carries the level's width (up to 100)
# as a factor, so the bound is relative. With a bf16 value, d_loc and
# d_attn are f32 sums of the same bf16 inputs (same bound); d_value is an
# f32 sum rounded once to bf16 on both sides, in another order: one bf16
# unit (BF16_UNIT) of the largest entry.
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
# the host ops: C++ against the port's numpy warp (f32 arithmetic in another
# order) and against scipy's optimal assignment cost
TOL_NATIVE_WARP = 1e-5
TOL_LSA_COST = 1e-9
# the runbook's goldens against the live forward (the same f32 forward)
TOL_RUNBOOK = 1e-5
# the bench's bf16 forward (bf16 weights, norms and residuals in bf16),
# kernel against plain MSDA. Each MSDA call is held to TOL_BF16_REL on the
# inputs it received. The whole forward cannot be held to a fixed count of
# bf16 units at canonical depth: one bf16 rounding of an MSDA output in
# another place moves the 12-layer bf16 forward by several units (summing
# the plain MSDA's levels in the other order moved it 3.02 / 6.00 / 4.31
# units at 128x192 on a CPU), so its rms difference is held to twice
# that of the plain forward against itself with its levels reordered, in
# the same run, or to TOL_BENCH_RMS_UNITS (bf16 units of each output's
# scale) where that is smaller.
TOL_BENCH_RMS_UNITS = 1.0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def zero_counts():
    """Set the launch count of every kernel a training or eval path runs
    to 0: the two MSDA kernels and the assignment; and the train step's
    CUDA graph captures and replays."""
    from snipper_tpu_torch.ops.lsa import lsa_rows
    from snipper_tpu_torch.ops.msda import ms_deform_attn
    from snipper_tpu_torch.train.step import StepGraph

    ms_deform_attn.launches = 0
    ms_deform_attn.backward_launches = 0
    ms_deform_attn.launches_by_dtype.update(f32=0, bf16=0)
    ms_deform_attn.backward_launches_by_dtype.update(f32=0, bf16=0)
    lsa_rows.launches = 0
    StepGraph.captures = StepGraph.replays = 0


def graph_counts():
    """The train step's CUDA graph captures and replays since
    :func:`zero_counts` (``train/step.py::StepGraph``)."""
    from snipper_tpu_torch.train.step import StepGraph

    return {"captures": StepGraph.captures, "replays": StepGraph.replays}


def wrapper_steps(steps, graph):
    """Of ``steps`` train steps, those that called the kernels' wrappers,
    given their ``graph`` counts: the eager steps and the captures. A
    replay runs the kernels its capture recorded and calls no wrapper, so
    the wrappers' counts leave it out; the profiler counts its kernels
    (:func:`replay_launches`)."""
    return steps - graph["replays"] + graph["captures"]


# The kernel that counts one call of each wrapper on the card: the
# backward launches three kernels a call, counted by its taps kernel.
CALL_KERNEL = {"msda_forward": "msda_forward_kernel",
               "msda_backward": "msda_backward_taps_kernel",
               "lsa_rows": "lsa_rows_kernel"}


def replay_launches(fn):
    """The MSDA kernels (by the value's dtype) and the assignment kernels
    that one call of ``fn`` ran on the card, by torch.profiler's counts:
    what a train step that replays its CUDA graph launches."""
    kernels = profiled_kernels(fn, need=tuple(CALL_KERNEL.values()))

    def n(name):
        return sum(e.count for e in kernels if name in e.key)

    return {k: {"f32": n(f"{CALL_KERNEL[k]}<float"),
                "bf16": n(f"{CALL_KERNEL[k]}<__nv_bfloat16")}
            for k in ("msda_forward", "msda_backward")} | {
        "lsa_rows": n(CALL_KERNEL["lsa_rows"])}


def dtype_counts():
    """The MSDA kernels' launches since :func:`zero_counts`, by the
    value's dtype."""
    from snipper_tpu_torch.ops.msda import ms_deform_attn

    return {"msda_forward": dict(ms_deform_attn.launches_by_dtype),
            "msda_backward": dict(ms_deform_attn.backward_launches_by_dtype)}


def counts():
    """The launch counts that :func:`zero_counts` set to 0."""
    from snipper_tpu_torch.ops.lsa import lsa_rows
    from snipper_tpu_torch.ops.msda import ms_deform_attn

    return {"msda_forward": ms_deform_attn.launches,
            "msda_backward": ms_deform_attn.backward_launches,
            "lsa_rows": lsa_rows.launches}


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
    once and writes d_value [N, S, H, D] (in the value's type) whole,
    d_loc and d_attn once, at per tap and channel 8 multiply-adds (the
    four corner dots v_c.g, from which d_attn and d_loc are per-tap
    combinations, and the four products w_c*a*g summed into the corner
    rows), plus ~30 per tap. Returns (ms, "bytes" or "operations",
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
        # + d_value (whole), d_loc, d_attn written
        nbytes += (value.numel() * esize + loc.numel() * 4
                   + attn.numel() * 4)
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


# the shapes of K1's rows in PERF.md, timed beside one embedding_bag call
YARDSTICK_CASES = ("encoder", "decoder", "train_encoder", "train_decoder",
                   "train_encoder_tp2", "train_decoder_tp2")


def phase_kernels():
    """msda_forward vs plain version at the tiny, inference encoder and
    decoder, and train encoder and decoder shapes, the last two also at
    the 4 heads of a tensor-parallel rank; at the shapes of
    ``YARDSTICK_CASES`` (all but the tiny one) also one ``embedding_bag``
    call of its function (f32 and bf16 value), checked against the plain
    version."""
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
        lib_note = "no library time at this shape"
        if name in YARDSTICK_CASES:
            # the yardstick: one embedding_bag call, its arguments built
            # outside the timed region, the weights in the value's dtype
            # as embedding_bag takes them
            for tag, v, ref, t in (("", value, want, tol),
                                   ("bf16_", vb, want_b, tol_b)):
                table, bags, wts = msda_bag_args(v, shapes, loc, attn)
                wts = wts.to(v.dtype)
                lib = library_bag(table, bags, wts).view(ref.shape)
                lib_err = (lib.float() - ref.float()).abs().max().item()
                check(math.isfinite(lib_err) and lib_err <= t,
                      f"embedding_bag yardstick of msda_forward {tag}{name}:"
                      f" max abs diff {lib_err} > {t}")
                res[name][f"{tag}library_max_abs_err"] = lib_err
                res[name][f"{tag}library_ms"] = time_ms(
                    lambda: library_bag(table, bags, wts))
                del table, bags, wts, lib
            lib_note = (f"one embedding_bag call {res[name]['library_ms']:.4f}"
                        f" ms, bf16 {res[name]['bf16_library_ms']:.4f} ms "
                        f"(max|diff| {res[name]['library_max_abs_err']:.3e}"
                        f" / {res[name]['bf16_library_max_abs_err']:.3e})")
        log(f"msda_forward {name}: N={N} Lq={Lq} H={H} D={D} L={len(shapes)}"
            f" P={P}: f32 max|diff| {err:.3e} (tol {tol:g}), bf16 max|diff|"
            f" {err_b:.3e} (tol {tol_b:.3g}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bf16 kernel {ms_b:.4f} ms (device time "
            f"alone {dev:.4f}, bf16 {dev_b:.4f} ms); bound "
            f"{bound * 1e3:.2f} us by {by} ({nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.3f} GFLOP); {lib_note}")
        del value, loc, attn, vb, got, want, got_b, want_b
    torch.cuda.empty_cache()
    return res


def _grad_errors(got, want, bf16=False):
    """Max |diff| of (d_value, d_loc, d_attn) and each one's tolerance."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(1.0, w.float().abs().max().item())
        tol = (BF16_UNIT if bf16 and i == 0 else TOL_BWD_REL) * scale
        out.append(((g.float() - w.float()).abs().max().item(), tol))
    return out


def phase_backward():
    """msda_backward vs the plain VJP at the tiny and the train shapes (8
    heads, and the 4 of a tensor-parallel rank), f32 and bf16 value, and
    at a tiny shape whose first level has too many cells for the index
    kernel's shared counters (they live in global memory there); d_value
    of a second call bit-equal to the first's; times of the
    kernels, of the plain backward (autograd through grid_sample, its
    graph built once) and, at the train shapes in f32, of the backward of
    one ``embedding_bag`` call (its d_value and d_attn checked against the
    plain VJP's)."""
    import torch

    from snipper_tpu_torch.ops.msda import (ms_deform_attn_torch,
                                            ms_deform_attn_torch_vjp,
                                            msda_backward)

    cases = [("tiny", 2, [(6, 9), (3, 5), (2, 2)], 4, 8, 37, 3, False),
             ("tiny_global", 2, [(250, 200), (3, 5)], 2, 8, 37, 3, False)] \
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
            again = msda_backward(v, shapes, loc, attn, go)[0]
            want = ms_deform_attn_torch_vjp(v, shapes, loc, attn, go)
            torch.cuda.synchronize()
            check([t.dtype for t in got] == [dt] + [torch.float32] * 2,
                  f"msda_backward {name}: output dtypes "
                  f"{[t.dtype for t in got]}")
            check(torch.equal(got[0], again),
                  f"msda_backward {name}: two calls gave other d_value "
                  f"bits")
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
            lib_note = "no library time at this shape"
            if name in YARDSTICK_CASES and dt == torch.bfloat16:
                # embedding_bag's per-sample-weight backward has no bf16
                # CUDA kernel
                lib_note = ("no library time in bf16 (embedding_bag's "
                            "per-sample-weight backward takes no bf16 on "
                            "CUDA)")
            elif name in YARDSTICK_CASES:
                # the yardstick: the backward of one embedding_bag call,
                # which gives d_value and each tap's weight gradient, from
                # which d_loc and d_attn follow elementwise (d_attn is
                # checked)
                table, bags, wts = msda_bag_args(v, shapes, loc, attn)
                tbl = table.detach().requires_grad_(True)
                w = wts.detach().requires_grad_(True)
                g2 = go.reshape(-1, D)
                with torch.enable_grad():
                    lib_out = library_bag(tbl, bags, w)
                d_tbl, d_w = torch.autograd.grad(lib_out, (tbl, w), g2,
                                                 retain_graph=True)
                lib_errs = [
                    ((g_.float() - w_.float()).abs().max().item(),
                     TOL_BWD_REL * max(1.0, w_.float().abs().max().item()))
                    for g_, w_ in zip((d_tbl.view(v.shape),
                                       msda_bag_attn_grad(d_w, shapes, loc)),
                                      (want[0], want[2]))]
                for n_, (err, tol) in zip(("d_value", "d_attn"), lib_errs):
                    check(math.isfinite(err) and err <= tol,
                          f"embedding_bag yardstick of msda_backward {tag} "
                          f"{name} {n_}: max abs diff {err} > {tol}")
                row[f"{tag}_library_max_abs_err"] = {
                    n_: e for n_, (e, _) in zip(("d_value", "d_attn"),
                                                lib_errs)}
                row[f"{tag}_library_ms"] = time_ms(
                    lambda: torch.autograd.grad(lib_out, (tbl, w), g2,
                                                retain_graph=True), reps=10)
                lib_note = (f"backward of one embedding_bag call "
                            f"{row[f'{tag}_library_ms']:.4f} ms")
                del table, bags, wts, tbl, w, lib_out, d_tbl, d_w
            log(f"msda_backward {name} {tag}: N={N} Lq={Lq} H={H} D={D} "
                f"L={len(shapes)} P={P}: max|diff| "
                + ", ".join(f"{n_} {e:.3e} (tol {t:.3g})"
                            for n_, (e, t) in zip(names, errs))
                + f"; kernel {row[f'{tag}_ms']:.4f} ms (device time alone "
                f"{row[f'{tag}_device_ms']:.4f} ms), plain backward "
                f"{row[f'{tag}_plain_ms']:.4f} ms; bound {bound * 1e3:.2f}"
                f" us by {by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} "
                f"GFLOP); {lib_note}")
            del got, again, want
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


def msda_bag_args(value, shapes, loc, attn):
    """``embedding_bag``'s arguments for ``msda_forward``'s function (K1):
    the table is the value's rows ``[N*S*H, D]``; per (n, q, h), in the
    output's ``[N, Lq, H]`` order, a bag of its ``L*P*4`` corner taps
    (``ops/deform_attn.py::corner_taps``, grid_sample's corners), each
    weighted by its bilinear weight times its attention, a corner off the
    map naming a clipped row with weight 0. The call's ``[N*Lq*H, D]`` is
    the op's ``[N, Lq, H*D]``. Returns ``(table, bags int32, weights
    f32)``."""
    import torch

    from snipper_tpu_torch.ops.deform_attn import corner_taps

    N, S, H, D = value.shape
    n = torch.arange(N, device=value.device).view(N, 1, 1, 1)
    hh = torch.arange(H, device=value.device).view(1, 1, H, 1)
    bags, weights, start = [], [], 0
    for lvl, (h, w) in enumerate(shapes):
        ys, xs, wgt = corner_taps(loc[:, :, :, lvl], attn[:, :, :, lvl], h, w)
        bags.append((n * S + start + ys * w + xs) * H + hh)
        weights.append(wgt)
        start += h * w
    K = sum(b.shape[-1] for b in bags)
    return (value.reshape(-1, D), torch.cat(bags, -1).reshape(-1, K).int(),
            torch.cat(weights, -1).reshape(-1, K))


def msda_bag_attn_grad(d_weights, shapes, loc):
    """d_attn ``[N, Lq, H, L, P]`` from the yardstick's per-tap weight
    gradients (each the dot of grad_out with the tap's value row): each
    tap's weight is its corner weight times the attention, so d_attn sums
    the four corners' gradients times their corner weights."""
    import torch

    from snipper_tpu_torch.ops.deform_attn import corner_taps

    N, Lq, H, L, P, _ = loc.shape
    ones = torch.ones(N, Lq, H, P, device=loc.device)
    cw = torch.stack([corner_taps(loc[:, :, :, lvl], ones, h, w)[2]
                      for lvl, (h, w) in enumerate(shapes)], 3)
    return (d_weights.float().view(N, Lq, H, L, P, 4)
            * cw.view(N, Lq, H, L, P, 4)).sum(-1)


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
    model_res = probe_model_runs()
    return dict(launches=launches, op_ms=op_ms, relerr=relerr,
                op_lines=list(lines.values()),
                lanegather_lines=[ln for ln in out2.splitlines()
                                  if ln.startswith("  ")], **model_res)


def probe_model_runs(K=8, train_K=2, split_K=3):
    """``probe forward``, ``probe train`` and ``probe split`` through
    ``main``, each with the MSDA counts at 0 just before and read just
    after: one ``msda_forward`` launch per layer and forward call (the
    forward: the overflow read, the warm-up and 2 x K timed calls per
    point), 12 forward and 12 backward launches and one ``lsa_rows`` per
    train step that calls the wrappers (the first step and the capture of
    the CUDA graph that the K timed steps replay), none under
    ``deform_impl="skip"``."""
    from snipper_tpu_torch.config import Config

    def run(argv):
        log(f"probe {' '.join(argv)}:")
        zero_counts()
        rc, out = _run_probe(argv)
        n = counts()
        # ------------------------------------------------------------------
        check(rc == 0 and "FAIL" not in out
              and out.rstrip().endswith("DONE"),
              f"probe {argv[0]} exited {rc} or printed FAIL")
        return out, n

    presets, batches = ("canonical_t4", "light_t1"), (1, 4)
    out, fwd_n = run(["forward", "--presets", ",".join(presets),
                      "--batch", ",".join(map(str, batches)), "--dtype",
                      "bf16", "-K", str(K), "--device", "cuda"])
    fwd = fwd_n["msda_forward"]
    layers = {p: getattr(Config, p)().enc_layers
              + getattr(Config, p)().dec_layers for p in presets}
    calls = len(batches) * (2 + 2 * K)
    want = sum(n * calls for n in layers.values())
    check(fwd == want, f"probe forward: {fwd} msda_forward launches, "
          f"expected {want} ({layers} per call, {calls} calls per preset)")
    forward_lines = [ln for ln in out.splitlines() if "ms/snippet" in ln]
    check(len(forward_lines) == len(presets) * len(batches)
          and all("impl=kernel" in ln and "overflow=0.0" in ln
                  and "bf16 weights and input" in ln
                  for ln in forward_lines), f"probe forward: {out}")

    out, train_n = run(["train", "-K", str(train_K), "--device", "cuda"])
    graph = graph_counts()
    tf, tb, tl = train_n.values()
    per = Config.canonical_t4_f2().enc_layers \
        + Config.canonical_t4_f2().dec_layers
    # two warm steps (eager, capture) and K replays: the wrappers count
    # the first two
    steps = wrapper_steps(2 + train_K, graph)
    check(graph == {"captures": 1, "replays": 1 + train_K}
          and (tf, tb, tl) == (per * steps, per * steps, steps),
          f"probe train: {tf} + {tb} + {tl} launches in {steps} steps that "
          f"called the wrappers ({graph}), expected {per} + {per} + 1 per "
          f"step")
    train_line = [ln for ln in out.splitlines() if ln.startswith("train ")]

    out, split_n = run(["split", "-K", str(split_K), "--device", "cuda"])
    sf, sb, _ = split_n.values()
    check((sf, sb) == (0, 0), f"probe split: {sf} + {sb} MSDA launches "
          f"under deform_impl='skip', expected none")
    split_lines = [ln for ln in out.splitlines()
                   if ln.startswith(("enc=", "solved:"))]
    log(f"probe forward/train/split: msda_forward {fwd} launches over "
        f"{len(forward_lines)} points ({layers} per forward call), train "
        f"{tf} + {tb} (lsa_rows {tl}) over {steps} steps, split {sf}")
    return dict(forward_launches=fwd, forward_lines=forward_lines,
                train_launches=[tf, tb, tl], train_lines=train_line,
                split_launches=sf, split_lines=split_lines)



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


def max_output_diff(a, b, relative=False):
    """Max |a - b| of each prediction and over the heatmaps; ``relative``:
    each over the largest magnitude of ``b``'s (at least 1)."""
    def diff(x, y):
        x, y = x.float().cpu(), y.float().cpu()
        d = (x - y).abs().max().item()
        return d / max(1.0, y.abs().max().item()) if relative else d

    keys = ("pred_logits", "pred_kpts2d", "pred_depth")
    diffs = {k: diff(a[k], b[k]) for k in keys}
    diffs["heatmaps"] = max(diff(x, y)
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


def msda_levels_reversed(value, shapes, loc, attn):
    """The plain MSDA with its levels summed in the other order: the same
    function up to f32 roundoff before the one rounding to the value's
    dtype (a reference for how far a bf16 forward carries such a
    rounding; the port never calls it)."""
    from snipper_tpu_torch.ops.msda import ms_deform_attn_torch

    starts = [0]
    for h, w in shapes:
        starts.append(starts[-1] + h * w)
    out = None
    for lvl in reversed(range(len(shapes))):
        part = ms_deform_attn_torch(
            value[:, starts[lvl]:starts[lvl + 1]].float(), [shapes[lvl]],
            loc[:, :, :, lvl:lvl + 1], attn[:, :, :, lvl:lvl + 1])
        out = part if out is None else out + part
    return out.to(value.dtype)


def breakdown(fn, top=8, reps=5, need=("msda_forward",)):
    """Device time of one call of ``fn`` by kernel (torch.profiler), its
    wall time (CUDA events, median of ``reps``) and the device's busy
    share of that wall time. ``need``: the kernels that ``fn`` launches
    whose times are reported apart; their calls in the profiled call are
    counted by each one's ``CALL_KERNEL`` (``launches``)."""
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
                kernel_launches=sum(e.count for e in kernels),
                launches={name: sum(e.count for e in kernels
                                    if CALL_KERNEL.get(name, name) in e.key)
                          for name in need})


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
# the depth of the export, multi-GPU and canonical train-to-accuracy legs:
# two encoder and two decoder layers at full width show those paths right
# (the artifact's graph, the ranks' cuts and collectives, AdamW and the
# matching over 1600 updates) in a fraction of the full model's time
CUT_DEPTH = dict(enc_layers=2, dec_layers=2)
TOL_EXPORT = 1e-5
# the bf16 artifact against the live bf16 forward: the same operators on
# the same bf16 weights; one bf16 unit of each output's scale (they agree
# bit for bit on the CPU, tests/test_torch_port_export.py)
TOL_EXPORT_BF16_UNITS = 1

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
    with its default specs; (c) the f32 export on the card (canonical_t4
    cut to CUT_DEPTH, phase 4's weights of those layers), saved and
    loaded in a subprocess that imports only torch and the MSDA operators:
    its outputs against the live model (TOL_EXPORT, TF32 off in both) and
    its launches per call; (d) the bf16 export (JAX's bf16 recipe: bf16
    weights only, about half the size), loaded in this process, its
    launches per call (counts at 0 just before and read just after) and
    its outputs against the live bf16 forward (``ServingForward``,
    TOL_EXPORT_BF16_UNITS) with JAX's output dtypes; each artifact and its
    live forward in turns; then the ``probe serve`` lines (bf16 weights,
    f32 input, ``-K 5``)."""
    import numpy as np
    import torch

    from snipper_tpu_torch.cli import infer as infer_cli
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.infer.export import (ServingForward,
                                                export_forward,
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
    base = base.replace(**CUT_DEPTH)
    model = build_model(base, device="cuda")
    keep = model.state_dict()
    model.load_state_dict({k: v for k, v in load_checkpoint(ckpt)[
        "params"].items() if k in keep})
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
    log(f"export of canonical_t4 enc{base.enc_layers}/dec{base.dec_layers} "
        f"f32 on the card ({card}): traced in "
        f"{export_s:.1f} s, {size / 1e6:.1f} MB, {nodes} msda_forward "
        f"nodes; loaded in a subprocess importing {loaded['modules']}: "
        f"{loaded['launches']} launches per call, {loaded['ms']:.2f} ms per"
        f" call (CUDA events, TF32 off), max|diff| vs the live model "
        f"{json.dumps(export_diff)} (tol {TOL_EXPORT:g})")
    # ---- (d) the bf16 artifact: JAX's bf16 recipe, cast once -----------
    t0 = time.perf_counter()
    exported_b = export_forward(base, model.state_dict(), device="cuda",
                                param_dtype="bfloat16")
    export_b_s = time.perf_counter() - t0
    path_b = os.path.join(work, "canonical_t4_bf16.pt2")
    size_b = save_exported(exported_b, path_b)
    floats = [t for t in exported_b.state_dict.values()
              if t.is_floating_point()]
    weight_bytes = {name: sum(t.nbytes for t in ep.state_dict.values())
                    for name, ep in (("f32", exported), ("bf16", exported_b))}
    # half the weights' bytes, the rest of the file (the program and its
    # constants) as in the f32 artifact
    rest = (size - weight_bytes["f32"], size_b - weight_bytes["bf16"])
    check(floats and all(t.dtype == torch.bfloat16 for t in floats)
          and 2 * weight_bytes["bf16"] == weight_bytes["f32"]
          and abs(rest[0] - rest[1]) <= 0.01 * size,
          f"the bf16 artifact holds a weight that is not bf16, or its "
          f"weights ({weight_bytes['bf16']} B) are not half the f32 "
          f"artifact's ({weight_bytes['f32']} B), or the rest of its "
          f"{size_b} B differs from the f32 artifact's ({rest})")
    nodes_b = sum("snipper_tpu_torch.msda_forward" in str(nd.target)
                  for nd in exported_b.graph.nodes
                  if nd.op == "call_function")
    # loaded in this process (the f32 leg above shows that the loader
    # needs no model code): launches of one call, counts at 0 just before
    # and read just after, then ms per call (CUDA events, TF32 off)
    run_b = load_exported(path_b)
    xc = x.cuda()
    ms_deform_attn.launches = 0
    art_b = run_b(xc)
    torch.cuda.synchronize()
    launches_b = ms_deform_attn.launches
    check(launches_b == per_call == nodes_b,
          f"the bf16 artifact launched msda_forward {launches_b} times per "
          f"call ({nodes_b} nodes), expected {per_call}")
    ms_b = time_ms(lambda: run_b(xc), reps=10)
    model_b = build_model(base, device="cuda")
    model_b.load_state_dict(model.state_dict())
    serving_b = ServingForward(model_b, "bfloat16").eval()
    with torch.inference_mode():
        live_b = serving_b(xc)
    check(all(art_b[k].dtype == live_b[k].dtype == torch.bfloat16
              for k in ("pred_logits", "pred_kpts2d", "pred_depth"))
          and all(h.dtype == torch.float32 for h in art_b["heatmaps"]),
          "the bf16 artifact's output dtypes are not JAX's")
    units_b = {k: v / BF16_UNIT for k, v in max_output_diff(
        art_b, live_b, relative=True).items()}
    check(max(units_b.values()) <= TOL_EXPORT_BF16_UNITS,
          f"bf16 artifact vs the live bf16 forward: {units_b} bf16 units")
    log(f"export of canonical_t4 enc{base.enc_layers}/dec{base.dec_layers} "
        f"bf16 (JAX's recipe) on the card ({card}): "
        f"traced in {export_b_s:.1f} s, {size_b / 1e6:.1f} MB "
        f"({size_b / size:.3f} of the f32 artifact; weights "
        f"{weight_bytes['bf16'] / 1e6:.1f} MB against "
        f"{weight_bytes['f32'] / 1e6:.1f}), {nodes_b} "
        f"msda_forward nodes, {launches_b} launches per call, "
        f"{ms_b:.2f} ms per call (CUDA events, TF32 off); max|diff|"
        f" vs the live bf16 forward {json.dumps(units_b)} bf16 units of "
        f"scale (tol {TOL_EXPORT_BF16_UNITS})")
    del exported_b, art_b, live_b

    # live and artifact in one process, in turns, as a user runs them
    # (cuDNN TF32 on): wall, device time and kernel launches of a call,
    # f32 then bf16
    torch.backends.cudnn.allow_tf32 = True
    run = load_exported(path)

    def live_fn():
        with torch.inference_mode():
            model(xc)

    def live_b_fn():
        with torch.inference_mode():
            serving_b(xc)

    turns = {"live": [], "artifact": [], "live_bf16": [],
             "artifact_bf16": []}
    for name, fn in (("live", live_fn), ("artifact", lambda: run(xc)),
                     ("artifact", lambda: run(xc)), ("live", live_fn),
                     ("live_bf16", live_b_fn),
                     ("artifact_bf16", lambda: run_b(xc)),
                     ("artifact_bf16", lambda: run_b(xc)),
                     ("live_bf16", live_b_fn)):
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
    del model, live, exported, run, run_b, serving_b, model_b
    torch.cuda.empty_cache()
    log("probe serve (python -m snipper_tpu_torch.scripts.probe serve):")
    torch.backends.cudnn.allow_tf32 = True
    rc, out = _run_probe(["serve", "--device", "cuda", "-K", "5"])
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
                export_diff=export_diff, serve=serve, turns=turns,
                export_bf16=dict(bytes=size_b, s=export_b_s,
                                 launches=launches_b, ms=ms_b,
                                 units=units_b))


def phase_profile_labels(work, card, real_root, steps=4):
    """(a) ``cli.train --profile_dir`` on canonical_t4_f2 b2 bf16
    synthetic, ``steps`` steps with a 2-step window, counts at 0 just
    before and read just after: the trace exists and its summary names
    ``msda_forward`` and ``msda_backward`` with device time, and the
    matching's host span; taken again (up to three runs) when the profiler
    drops the run's device events. The step runs as a CUDA graph: the
    profiled steps are replays, so the span of their host time is
    ``train.replay`` (the matching's ``match_layers`` opens only on the
    eager first step and in the capture), and the wrappers count the
    eager step's and the capture's launches. (b) ``cli.dump_labels`` on the
    PoseTrack18-format val split that phase_train_real wrote: one pickle
    entry per sample and the ``--vis 2`` renders."""
    import torch

    from snipper_tpu_torch.cli import dump_labels as dump_cli
    from snipper_tpu_torch.cli import train as train_cli
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.data.datasets import HybridDataset
    from snipper_tpu_torch.utils.profiling import host_spans, summarize_trace

    cfg = Config.canonical_t4_f2()
    per_pass = cfg.enc_layers + cfg.dec_layers
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    for attempt in range(3):
        prof = os.path.join(work, f"profile{attempt}")
        buf = io.StringIO()
        # ---- the profiled training run, counts at 0 ----------------------
        zero_counts()
        with contextlib.redirect_stdout(buf):
            res = train_cli.main([
                "--preset", "canonical_t4_f2", "--synthetic",
                "--batch_size", "2", "--synthetic_distinct", "2",
                "--epochs", "1", "--steps_per_epoch", str(steps),
                "--eval_every", "5", "--profile_dir", prof,
                "--profile_steps", "2", "--output_dir",
                os.path.join(work, f"train_prof{attempt}"),
                "--device", "cuda"])
        launches, graph = counts(), graph_counts()
        # ------------------------------------------------------------------
        called = wrapper_steps(steps, graph)
        check(graph == {"captures": 1, "replays": steps - 1}
              and launches == {"msda_forward": per_pass * called,
                               "msda_backward": per_pass * called,
                               "lsa_rows": called},
              f"profiled training launches {launches} in {steps} steps, "
              f"{graph}")
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
    check(spans.get("train.replay", 0) > 0, f"host spans {spans}")
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
        f"{msda['msda_backward']:.3f} ms, host span train.replay "
        f"{spans['train.replay']:.2f} ms; profiled steps' host time "
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
    return dict(launches=launches, msda_ms=msda, replay_ms=spans[
        "train.replay"], device_ms=device_total, trace_mb=trace_mb,
        summary=summary, dump_entries=len(gt), renders=len(renders))


def numpy_host_ops():
    """The host ops' numpy and scipy paths for a block: a test-only seam
    (``data/native_ops.py``'s library handle set to "none"), never an
    environment switch. Host-bound numbers compare only within one call,
    so each numpy leg runs beside its native leg."""
    from unittest import mock

    from snipper_tpu_torch.data import native_ops

    return mock.patch.object(native_ops, "_lib", False)


def phase_native_ops(card, out_hw=(600, 800)):
    """The host ops built in phase 2 (``data/csrc/imageops.cpp``):
    ``warp_patch`` against the port's numpy path at 1920x1080 and 1280x720
    sources to 600x800 in four cases (rotation, flip, colour, a crop
    centred near the frame's corner so the border falls off it); one
    1920x1080 frame timed native against numpy, four frames on four
    threads against one (host clock, median); ``lsa_pairs`` against
    scipy's optimal cost on costs of 60 queries and 1-20 targets, both
    orientations, and one 60x20 assignment timed against scipy's; serving's
    ``warp_patch_exact`` equal bit for bit to the numpy
    ``generate_patch_image`` on every case's frame and affine, and one
    1280x720 frame of it timed against numpy."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    from snipper_tpu_torch.data import native_ops
    from snipper_tpu_torch.data.transforms import (gen_trans_from_patch,
                                                   generate_patch_image)

    check(native_ops.have_native(), "the host ops are not native")
    info = native_ops.build_info
    log(f"host ops: `{info['command']}` built {os.path.basename(info['path'])}"
        f" in {info['seconds']:.2f} s")
    out_h, out_w = out_hw
    rng = np.random.default_rng(0)
    cases = (("rotation", 17.0, False, (1.0, 1.0, 1.0), 0.5),
             ("flip", 0.0, True, (1.0, 1.0, 1.0), 0.5),
             ("colour", -8.0, False, (1.3, 0.7, 1.1), 0.5),
             ("border", 25.0, True, (0.9, 1.1, 1.0), 0.04))
    errs, jobs = {}, {}
    for w, h in ((1920, 1080), (1280, 720)):
        small = rng.integers(0, 256, (27, 48, 3), np.uint8)
        img = np.kron(small, np.ones((h // 27 + 1, w // 48 + 1, 1),
                                     np.uint8))[:h, :w].copy()
        img = (img + rng.integers(0, 16, img.shape)).astype(np.uint8)
        for name, rot, flip, color, centre in cases:
            s = max(w / out_w, h / out_h) * 0.9
            trans = gen_trans_from_patch(w * centre, h * centre, out_w * s,
                                         out_h * s, out_w, out_h, rot)
            args = (img, trans, (out_h, out_w), flip, color)
            jobs[f"{w}x{h} {name}"] = args
            got = native_ops.warp_patch(*args)
            with numpy_host_ops():
                want = native_ops.warp_patch(*args)
            check(got.shape == want.shape and np.isfinite(got).all(),
                  f"warp_patch {w}x{h} {name}: shape {got.shape}")
            errs[f"{w}x{h} {name}"] = float(np.abs(got - want).max())
    check(max(errs.values()) <= TOL_NATIVE_WARP,
          f"native warp_patch vs numpy: {errs}")
    border = jobs["1920x1080 border"]
    zero_share = float((native_ops.warp_patch(*border) == 0).mean())
    check(zero_share > 0.2, f"border case reads the frame: {zero_share}")

    def warp(args):
        return native_ops.warp_patch(*args)

    frame = jobs["1920x1080 rotation"]
    native_ms = host_ms(lambda: warp(frame), reps=9)
    with numpy_host_ops():
        numpy_ms = host_ms(lambda: warp(frame), reps=3)
    four = [jobs[f"1920x1080 {c[0]}"] for c in cases]
    one_thread_ms = host_ms(lambda: [warp(a) for a in four], reps=5)
    with ThreadPoolExecutor(4) as pool:
        four_threads_ms = host_ms(lambda: list(pool.map(warp, four)),
                                  reps=5)
    log(f"host warp_patch ({card}, host clock, median): C++ vs the numpy "
        f"path max|diff| {max(errs.values()):.3e} (tol "
        f"{TOL_NATIVE_WARP:g}) over {len(errs)} cases "
        f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} }; border case "
        f"{zero_share:.3f} zeros; one 1920x1080 -> {out_h}x{out_w} frame "
        f"{native_ms:.2f} ms C++, {numpy_ms:.2f} ms numpy "
        f"({numpy_ms / native_ms:.1f}x); four frames on one thread "
        f"{one_thread_ms:.2f} ms, on four threads {four_threads_ms:.2f} ms "
        f"({one_thread_ms / four_threads_ms:.2f}x)")

    exact_differ = {
        k: int((native_ops.warp_patch_exact(a[0], a[1], a[2])
                != generate_patch_image(a[0], False, a[1], a[2])).sum())
        for k, a in jobs.items()}
    check(not any(exact_differ.values()), f"warp_patch_exact vs the numpy "
          f"warp, values that differ: {exact_differ}")
    hd = jobs["1280x720 rotation"]
    exact_ms = host_ms(lambda: native_ops.warp_patch_exact(*hd[:3]), reps=9)
    numpy_exact_ms = host_ms(
        lambda: generate_patch_image(hd[0], False, hd[1], hd[2]), reps=3)
    log(f"host warp_patch_exact ({card}, host clock, median): equal to the "
        f"numpy warp bit for bit over {len(exact_differ)} frames; one "
        f"1280x720 -> {out_h}x{out_w} frame {exact_ms:.2f} ms C++, "
        f"{numpy_exact_ms:.2f} ms numpy ({numpy_exact_ms / exact_ms:.1f}x)")

    lsa_err, n_cases = 0.0, 0
    for n in (1, 3, 8, 15, 20):
        for tall in (True, False):
            cost = rng.uniform(0, 1, (60, n))
            cost = cost if tall else np.ascontiguousarray(cost.T)
            rows, cols = native_ops.lsa_pairs(cost)
            r, c = linear_sum_assignment(cost)
            check(len(set(rows.tolist())) == len(set(cols.tolist()))
                  == min(cost.shape), f"lsa_pairs {cost.shape}: not a "
                  f"matching")
            lsa_err = max(lsa_err, abs(cost[rows, cols].sum()
                                       - cost[r, c].sum()))
            n_cases += 1
    check(lsa_err <= TOL_LSA_COST, f"lsa_pairs cost vs scipy: {lsa_err}")
    cost = rng.uniform(0, 1, (60, 20))
    lsa_ms = host_ms(lambda: native_ops.lsa_pairs(cost), reps=21)
    scipy_ms = host_ms(lambda: linear_sum_assignment(cost), reps=21)
    log(f"host lsa_pairs ({card}): optimal cost within {lsa_err:.3e} of "
        f"scipy's (tol {TOL_LSA_COST:g}) over {n_cases} costs of 60 x 1-20;"
        f" 60x20 {lsa_ms:.4f} ms C++, {scipy_ms:.4f} ms scipy (host clock,"
        f" median)")
    return dict(build=dict(info), warp_errs=errs, zero_share=zero_share,
                native_ms=native_ms, numpy_ms=numpy_ms,
                one_thread_ms=one_thread_ms, four_threads_ms=four_threads_ms,
                exact_ms=exact_ms, numpy_exact_ms=numpy_exact_ms,
                lsa_err=lsa_err, lsa_ms=lsa_ms, scipy_ms=scipy_ms)


def phase_train(work, steps=8):
    """The training path through the CLI a user calls: canonical_t4_f2,
    batch 2, bf16 mixed precision, ``steps`` steps over two distinct
    synthetic samples (a 600x800 render costs 1-2 s, so the set is small
    and cached), then the epoch's checkpoint and evaluation."""
    import torch

    from snipper_tpu_torch.cli import train as train_cli
    from snipper_tpu_torch.config import Config

    cfg = Config.canonical_t4_f2()
    out_dir = os.path.join(work, "train")
    # PyTorch's defaults, which a user of the CLI gets
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    # ---- the training path, with every kernel's count at 0 ---------------
    zero_counts()
    res = train_cli.main([
        "--preset", "canonical_t4_f2", "--synthetic", "--batch_size", "2",
        "--synthetic_distinct", "2", "--epochs", "1",
        "--steps_per_epoch", str(steps), "--output_dir", out_dir,
        "--device", "cuda"])
    launches, graph = counts(), graph_counts()
    # ----------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res["history"]
    n_eval = res["eval"]["_batches"]
    per_layer_pass = cfg.enc_layers + cfg.dec_layers
    check(len(hist) == steps, f"{len(hist)} train steps, expected {steps}")
    # one card, one batch shape: the first step eager, the second
    # captured, each step from the second a replay
    check(graph == {"captures": 1, "replays": steps - 1},
          f"the train steps' CUDA graph: {graph} in {steps} steps, "
          f"expected one capture and {steps - 1} replays")
    # counted in this run, over the steps that called the kernels'
    # wrappers (the eager step and the capture): backward launches per
    # step, forward launches per forward pass (a train step or an eval
    # batch)
    called = wrapper_steps(steps, graph)
    per_step = launches["msda_backward"] / called
    per_forward = launches["msda_forward"] / (called + n_eval)
    check(per_step == per_layer_pass,
          f"msda_backward launched {launches['msda_backward']} times in "
          f"{called} steps, expected {per_layer_pass} per step")
    check(per_forward == per_layer_pass,
          f"msda_forward launched {launches['msda_forward']} times in "
          f"{called} steps and {n_eval} eval batches, expected "
          f"{per_layer_pass} per step and per eval batch")
    check(launches["lsa_rows"] == called + n_eval,
          f"lsa_rows launched {launches['lsa_rows']} times in {called} "
          f"steps and {n_eval} eval batches, expected one per step and per "
          f"eval batch")
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
        f"mixed precision, {steps} steps + {n_eval} eval batches, the "
        f"step a CUDA graph ({graph}); by the wrappers of the {called} "
        f"steps that called them (eager, capture) and the eval batches: "
        f"msda_forward {launches['msda_forward']} launches ({per_forward:g}"
        f" per step and per eval batch), msda_backward "
        f"{launches['msda_backward']} ({per_step:g} per step), lsa_rows "
        f"{launches['lsa_rows']} (one per step and eval batch); steady-state "
        f"step {step_ms:.2f} ms, period {period_ms:.2f} ms "
        f"(median, first two steps excluded), {2e3 / period_ms:.3f} "
        f"samples/s;"
        f" peak device memory {peak_gb:.2f} GB; losses "
        f"{[round(x, 4) for x in losses]}; checkpoint "
        f"{os.path.basename(res['checkpoint'])}; eval "
        f"test_loss_total {logged['test_loss_total']:.4f} "
        f"(cuDNN TF32 on, matmul TF32 off)")
    return dict(steps=steps, eval_batches=n_eval, launches=launches,
                graph=graph, checkpoint=res["checkpoint"],
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
    cfg = Config.canonical_t4_f2()
    out_dir = os.path.join(work, "eval")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    # ---- the eval path, with every kernel's count at 0 -------------------
    zero_counts()
    res = eval_cli.main([
        "--preset", "canonical_t4_f2", "--synthetic", "--synthetic_samples",
        str(samples), "--resume", ckpt, "--save_vis", "--write_posetrack",
        "--output_dir", out_dir, "--device", "cuda"])
    launches = counts()
    # ----------------------------------------------------------------------
    n = res["batches"]
    check(n == samples // cfg.batch_size, f"{n} eval batches")
    per_batch = launches["msda_forward"] / n
    check(per_batch == cfg.enc_layers + cfg.dec_layers,
          f"msda_forward launched {launches['msda_forward']} times in {n} "
          f"eval batches, expected {cfg.enc_layers + cfg.dec_layers} per "
          f"batch")
    check(launches["lsa_rows"] == n and launches["msda_backward"] == 0,
          f"eval launches {launches} in {n} batches, expected one lsa_rows "
          f"per batch and no msda_backward")
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


# the bars of tests/test_train_accuracy.py:54, :87-95 (the JAX package's
# train-to-accuracy test), held by phase_train_accuracy's tiny leg
JAX_FLOOR_3DPCK = 0.2
JAX_ACCURACY_BARS = (("3dpck", ">=", 0.70), ("future_3dpck", ">=", 0.70),
                     ("pel_mpjpe_joint", "<=", 0.12),
                     ("mpjpe_root", "<=", 0.25), ("mpjpe_joint", "<=", 0.30))
# the JAX recipe's rates (lr 1e-3, lr_backbone 5e-4, dropout 0) for both
# legs; each leg drops the lr 10x at 5/8 of its updates
ACCURACY_RECIPE = ["--lr", "0.001", "--lr_backbone", "0.0005",
                   "--dropout", "0.0"]
# at canonical width loss_is_human sits near 0.14 for hundreds of updates
# and no query is scored a person (so cli.eval writes no 3D metric) until
# the person score passes 0.5, some 600 to over 1000 updates in: the
# canonical leg trains 1600, and, as JAX's canonical overfit run did for
# the same plateau (NOTES_r5.md:116-134), with the heatmap term at weight
# 0.001
CANONICAL_UPDATES = 1600
CANONICAL_HEATMAP_COEF = ["--heatmap_loss_coef", "0.001"]
LOSS_AT_UPDATES = (1, 100, 200, 300, 400, 800, 1200, 1600)


def jax_accuracy_bars(stats, floor):
    """``{bar: passed}`` for every bar of tests/test_train_accuracy.py:87-95
    on trained ``stats`` against the random-init ``floor`` (a metric the
    eval did not write, for want of a detection, fails its bar)."""
    nan = float("nan")
    bars = {f"{k} {op} {v}": (stats.get(k, nan) >= v if op == ">="
                              else stats.get(k, nan) <= v)
            for k, op, v in JAX_ACCURACY_BARS}
    bars["3dpck > floor + 0.5"] = (stats.get("3dpck", nan)
                                   > floor.get("3dpck", nan) + 0.5)
    bars["pel_mpjpe_joint < 0.1 x floor"] = (
        stats.get("pel_mpjpe_joint", nan)
        < 0.1 * floor.get("pel_mpjpe_joint", nan))
    return bars


def _accuracy_cli(cli, argv, out_dir):
    """``cli.main(argv)`` (the module of ``cli.train`` or ``cli.eval``)
    with the MSDA counts at 0 just before and read just after: ``(result,
    {kernel: launches})``; an eval's result carries its
    ``eval_stats.json``."""
    from snipper_tpu_torch.cli import eval as eval_cli

    zero_counts()
    res = cli.main(argv + ["--output_dir", out_dir, "--device", "cuda"])
    launches = counts()
    if cli is eval_cli:
        with open(os.path.join(out_dir, "eval_stats.json")) as f:
            res["file_stats"] = json.load(f)
    return res, launches


def _accuracy_leg(work, name, preset, n_layers, train_argv, eval_argv,
                  updates, midway=None):
    """One leg of phase_train_accuracy: ``cli.eval`` from random init (the
    floor), ``cli.train`` for ``updates`` bf16 mixed-precision updates,
    ``cli.eval`` on its last checkpoint (and, reported alone, on the
    checkpoint ``midway = (epoch, updates by its end)``); the launches of
    each run checked
    (``n_layers`` of ``msda_forward`` per update and eval batch, of
    ``msda_backward`` per update, one ``lsa_rows`` per update and eval
    batch)."""
    import torch

    from snipper_tpu_torch.cli import eval as eval_cli
    from snipper_tpu_torch.cli import train as train_cli

    t0 = time.perf_counter()
    base = ["--preset", preset, "--synthetic", "--synthetic_distinct", "8",
            "--overfit"]
    floor_res, floor_n = _accuracy_cli(
        eval_cli, base + eval_argv, os.path.join(work, f"{name}_floor"))
    torch.cuda.reset_peak_memory_stats()
    train_dir = os.path.join(work, f"{name}_train")
    res, train_n = _accuracy_cli(train_cli, base + train_argv, train_dir)
    graph = graph_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trained_res, trained_n = _accuracy_cli(
        eval_cli, base + eval_argv + ["--resume", res["checkpoint"]],
        os.path.join(work, f"{name}_trained"))
    evals = [("floor", floor_res, floor_n), ("trained", trained_res,
                                              trained_n)]
    if midway is not None:
        epoch, at_update = midway
        ckpt = os.path.join(train_dir, "ckpts", f"checkpoint{epoch:04d}.pt")
        evals.append(("midway", *_accuracy_cli(
            eval_cli, base + eval_argv + ["--resume", ckpt],
            os.path.join(work, f"{name}_midway"))))
        midway = dict(update=at_update, stats=evals[-1][1]["file_stats"])
    seconds = time.perf_counter() - t0

    hist = res["history"]
    check(len(hist) == updates, f"{name}: {len(hist)} updates, expected "
          f"{updates}")
    n_eval = res["eval"]["_batches"] if res["eval"] else 0
    # the updates that called the kernels' wrappers: the eager ones and
    # the capture (a replay calls none)
    called = wrapper_steps(updates, graph)
    check(train_n == {"msda_forward": n_layers * (called + n_eval),
                      "msda_backward": n_layers * called,
                      "lsa_rows": called + n_eval},
          f"{name}: cli.train launched {train_n} in {called} updates that "
          f"called the wrappers (of {updates}, {graph}) and {n_eval} eval "
          f"batches, expected {n_layers} of each per update and {n_layers} "
          f"msda_forward per eval batch, one lsa_rows per update and eval "
          f"batch")
    for what, r, n in evals:
        check(n == {"msda_forward": n_layers * r["batches"],
                    "msda_backward": 0, "lsa_rows": r["batches"]},
              f"{name}: the {what} cli.eval launched {n} in {r['batches']}"
              f" batches, expected {n_layers} msda_forward per batch")
    losses = [h["loss_total"] for h in hist]
    check(all(math.isfinite(x) for x in losses), f"{name}: losses {losses}")
    with open(os.path.join(train_dir, "log.txt")) as f:
        logged = [json.loads(line) for line in f]
    floor, stats = floor_res["file_stats"], trained_res["file_stats"]
    bad = {k: v for s in (floor, stats) for k, v in s.items()
           if not math.isfinite(v)}
    check(not bad, f"{name}: non-finite eval stats {bad}")
    return dict(
        floor=floor, stats=stats, logged=logged, seconds=seconds,
        peak_gb=peak_gb, losses=losses,
        loss_at={u: losses[u - 1] for u in LOSS_AT_UPDATES
                 if u <= len(losses)},
        is_human_at={u: hist[u - 1]["loss_is_human"]
                     for u in LOSS_AT_UPDATES if u <= len(hist)},
        # a step's ``seconds`` leaves out the wait for its batch: the
        # period is the two together (host clock, as phase_train)
        step_ms=statistics.median(h["seconds"] for h in hist[2:]) * 1e3,
        period_ms=statistics.median(h["seconds"] + h["data_seconds"]
                                    for h in hist[2:]) * 1e3,
        launches={"train": train_n,
                  **{f"{what}_eval": n for what, _, n in evals}},
        graph=graph,
        eval_batches={"train": n_eval,
                      **{what: r["batches"] for what, r, _ in evals}},
        midway=midway, jax_bars=jax_accuracy_bars(stats, floor))


def _log_accuracy_leg(card, name, what, r):
    def brief(s):
        return {k: round(s[k], 4) for k in (
            "3dpck", "future_3dpck", "pel_mpjpe_joint", "mpjpe_root",
            "mpjpe_joint") if k in s}

    midway = r["midway"]
    log(f"train to accuracy, {name} ({what}): floor {brief(r['floor'])}; "
        f"trained {brief(r['stats'])}; "
        + (f"at update {midway['update']} {brief(midway['stats'])} (eval "
           f"loss_is_human {midway['stats']['loss_is_human']:.4f}); "
           if midway else "")
        + "loss_total at updates "
        + ", ".join(f"{u}: {x:.4f}" for u, x in r["loss_at"].items())
        + " (loss_is_human "
        + ", ".join(f"{x:.4f}" for x in r["is_human_at"].values())
        + f"); {r['period_ms']:.2f} ms per update (step {r['step_ms']:.2f};"
        f" host clock, median after the first two), peak device memory "
        f"{r['peak_gb']:.2f} GB, {r['seconds']:.1f} s for the leg; launches"
        f" {r['launches']} over eval batches {r['eval_batches']}; JAX's "
        "bars (tests/test_train_accuracy.py:87-95): "
        + ", ".join(f"{k} {'pass' if ok else 'FAIL'}"
                    for k, ok in r["jax_bars"].items())
        + f" ({card}; cuDNN TF32 on, matmul TF32 off)")


def phase_train_accuracy(work, card):
    """Training learns, through the CLIs a user calls, on the card with bf16
    mixed precision (the CLI's default).

    (a) tests/test_train_accuracy.py's protocol: tiny, 8 fixed synthetic
    samples, ``cli.eval`` from random init (its 3DPCK under 0.2), 400
    updates of 8 (25 an epoch, 16 epochs, StepLR 10x at epoch 10) with one
    eval at the end, ``cli.eval`` on the checkpoint: every bar of the JAX
    test, and ``test_3dpck`` in ``log.txt``.
    (b) canonical_t4_f2 at full width, cut to CUT_DEPTH (two encoder and
    two decoder layers; at enc6/dec6 the leg took 471-568 s of the
    script's 1200): 8 fixed samples, batch 2, 1600 updates (200 an epoch,
    8 epochs, the drop at epoch 5; the heatmap loss at weight 0.001, as
    in JAX's canonical overfit run), ``cli.eval`` from random init and on
    the checkpoint, batches of 8 (and, reported
    alone, on the checkpoint at update 600, which may score no person and
    so hold no 3D metric: at enc6/dec6 the person score lagged). Bars: the
    mean ``loss_total`` of the last 20 updates at most half that of the
    first 20, pel-MPJPE at most half the floor's, 3DPCK at least the
    floor's + 0.2; JAX's bars are reported, not required.
    """
    import torch

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = _accuracy_leg(
        work, "tiny", "tiny", 3,
        ["--synthetic_samples", "200", "--batch_size", "8", "--epochs", "16",
         "--lr_drop", "10", "--eval_every", "16"] + ACCURACY_RECIPE,
        ["--synthetic_samples", "8", "--batch_size", "8", "--dropout",
         "0.0"], updates=400)
    _log_accuracy_leg(card, "tiny", "the JAX test's protocol, batch 8",
                      tiny)
    check(tiny["floor"].get("3dpck", math.nan) < JAX_FLOOR_3DPCK,
          f"tiny: the random-init floor's 3dpck is not under "
          f"{JAX_FLOOR_3DPCK}: {tiny['floor']}")
    failed = [k for k, ok in tiny["jax_bars"].items() if not ok]
    check(not failed, f"tiny: JAX's bars failed: {failed} (trained "
          f"{tiny['stats']}, floor {tiny['floor']})")
    check([("test_3dpck" in line) for line in tiny["logged"]]
          == [False] * 15 + [True], "tiny: log.txt holds no test_3dpck line"
          " for the last epoch")

    # no eval inside cli.train here (its val set cycles the 8 samples over
    # 200 batches); cli.eval scores the checkpoint on the 8
    depth = [a for k, v in CUT_DEPTH.items() for a in (f"--{k}", str(v))]
    canon = _accuracy_leg(
        work, "canonical_t4_f2", "canonical_t4_f2", sum(CUT_DEPTH.values()),
        ["--synthetic_samples", str(CANONICAL_UPDATES // 4),
         "--batch_size", "2", "--epochs", "8", "--lr_drop", "5",
         "--eval_every", "9"] + ACCURACY_RECIPE + CANONICAL_HEATMAP_COEF
        + depth,
        ["--synthetic_samples", "8", "--batch_size", "8", "--dropout",
         "0.0", "--num_workers", "8"] + depth, updates=CANONICAL_UPDATES,
        midway=(2, 3 * CANONICAL_UPDATES // 8))
    _log_accuracy_leg(card, "canonical_t4_f2", "600x800 enc{enc_layers}/"
                      "dec{dec_layers}, batch 2".format(**CUT_DEPTH), canon)
    first, last = (statistics.fmean(canon["losses"][:20]),
                   statistics.fmean(canon["losses"][-20:]))
    floor, stats = canon["floor"], canon["stats"]
    check(last <= 0.5 * first, f"canonical_t4_f2: mean loss_total of the "
          f"last 20 updates {last:.4f} over half the first 20's {first:.4f}")
    for k in ("pel_mpjpe_joint", "3dpck"):
        check(k in floor and k in stats, f"canonical_t4_f2: no {k} (no "
              f"detection): floor {floor}, trained {stats}")
    check(stats["pel_mpjpe_joint"] <= 0.5 * floor["pel_mpjpe_joint"],
          f"canonical_t4_f2: pel_mpjpe_joint {stats['pel_mpjpe_joint']} over"
          f" half the floor's {floor['pel_mpjpe_joint']}")
    check(stats["3dpck"] >= floor["3dpck"] + 0.2,
          f"canonical_t4_f2: 3dpck {stats['3dpck']} under the floor's "
          f"{floor['3dpck']} + 0.2")
    canon.update(loss_first20=first, loss_last20=last)
    seconds = time.perf_counter() - t0
    log(f"train to accuracy: both legs' bars met; mean loss_total of the "
        f"first / last 20 updates at canonical_t4_f2 {first:.4f} / "
        f"{last:.4f}; phase {seconds:.1f} s ({card})")
    return dict(tiny=tiny, canonical=canon, seconds=seconds)


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
    zero_counts()
    res = train_cli.main([
        "--preset", "canonical_t4_f2", "--batch_size", "2",
        "--posetrack_dir", root, "--device_preprocess", "--epochs", "1",
        "--steps_per_epoch", str(steps), "--output_dir", out_dev,
        "--device", "cuda"])
    train_launches, graph = counts(), graph_counts()
    # ----------------------------------------------------------------------
    hist = res["history"]
    n_eval = res["eval"]["_batches"]
    check(len(hist) == steps, f"{len(hist)} train steps, expected {steps}")
    # the raw frames' padded size varies with the batch's videos: batches
    # of the graph's size replay it, the others run eagerly; the wrappers
    # count the eager steps and the capture
    called = wrapper_steps(steps, graph)
    check(train_launches["msda_backward"] == per_pass * called,
          f"msda_backward launched {train_launches['msda_backward']} times "
          f"in {called} steps from raw frames that called it ({graph}), "
          f"expected {per_pass} per step")
    check(train_launches["msda_forward"] == per_pass * (called + n_eval)
          and train_launches["lsa_rows"] == called + n_eval,
          f"launches {train_launches} in {called} steps and {n_eval} eval "
          f"batches, expected {per_pass} msda_forward and one lsa_rows per "
          f"step and per eval batch")
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
                   need=("msda_forward", "msda_backward", "lsa_rows"))
    check(state.graph is not None and state.graph.graph is not None
          and bd["launches"] == {"msda_forward": per_pass,
                                 "msda_backward": per_pass, "lsa_rows": 1},
          f"the profiled step from raw frames, a replay, ran "
          f"{bd['launches']}")
    del model, state
    torch.cuda.empty_cache()
    log(f"training from PoseTrack18-format files with --device_preprocess "
        f"(canonical_t4_f2 b2 bf16, {card}): {steps} steps + {n_eval} eval "
        f"batches, the step a CUDA graph ({graph}); by the wrappers of the "
        f"{called} steps that called them: msda_forward "
        f"{train_launches['msda_forward']} launches, msda_backward "
        f"{train_launches['msda_backward']} ({per_pass} per step); the "
        f"profiled replay's kernels {bd['launches']}; step {step_ms:.2f} ms, waiting for the batch {wait_ms:.2f}"
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
    # the same leg with the host op's numpy path, for the period beside
    with numpy_host_ops():
        res_np = train_cli.main([
            "--preset", "canonical_t4_f2", "--batch_size", "2",
            "--posetrack_dir", root, "--epochs", "1", "--eval_every", "5",
            "--steps_per_epoch", str(host_steps), "--output_dir",
            os.path.join(work, "train_real_numpy"), "--device", "cuda"])
    hn = res_np["history"]
    check(len(hn) == host_steps and all(
        math.isfinite(h["loss_total"]) for h in hn), "numpy-warp run")
    numpy_period_ms = statistics.median(h["seconds"] + h["data_seconds"]
                                        for h in hn[1:]) * 1e3
    paths = [os.path.join(root, f) for i in pick
             for f in ds_host[i]["targets"]["filenames"][:cfg.num_frames]]
    decode_ms = host_ms(lambda: [_read_rgb(p) for p in paths], reps=3)
    raw_getter_ms = host_ms(lambda: [ds_dev[i] for i in pick], reps=3)
    host_getter_ms = host_ms(lambda: [ds_host[i] for i in pick], reps=3)
    with numpy_host_ops():
        numpy_getter_ms = host_ms(lambda: [ds_host[i] for i in pick],
                                  reps=3)
    log(f"training with the host warp ({card}): step {host_step_ms:.2f} ms,"
        f" period {host_period_ms:.2f} ms, {2e3 / host_period_ms:.3f} "
        f"samples/s (median, first step excluded; 2 decode threads; the C++"
        f" warp); with the numpy warp period {numpy_period_ms:.2f} ms; one "
        f"batch of 2 on one host thread: decode of its {len(paths)} frames "
        f"{decode_ms:.2f} ms, samples without the warp {raw_getter_ms:.2f} "
        f"ms, with the C++ warp {host_getter_ms:.2f} ms (warp "
        f"{host_getter_ms - raw_getter_ms:.2f} ms), with the numpy warp "
        f"{numpy_getter_ms:.2f} ms (warp {numpy_getter_ms - raw_getter_ms:.2f}"
        f" ms; host clock, median)")

    # ---- (d) eval on the files with the harness, counts at 0 ------------
    out_eval = os.path.join(work, "eval_real")
    zero_counts()
    ev = eval_cli.main([
        "--preset", "canonical_t4_f2", "--batch_size", "2",
        "--posetrack_dir", root, "--posetrack_gt_dir", gt_dir,
        "--write_posetrack", "--resume", res["checkpoint"],
        "--output_dir", out_eval, "--device", "cuda"])
    eval_launches = counts()
    # ----------------------------------------------------------------------
    n = ev["batches"]
    check(n > 0 and eval_launches == {"msda_forward": per_pass * n,
                                      "msda_backward": 0, "lsa_rows": n},
          f"eval launches {eval_launches} over {n} batches, expected "
          f"{per_pass} msda_forward and one lsa_rows per batch")
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
    return dict(train_launches=train_launches, train_graph=graph,
                eval_launches=eval_launches,
                steps=steps, eval_batches=n_eval, warp_err=warp_err,
                warp_ms=warp_ms, warp_device_ms=warp_device_ms,
                step_ms=step_ms, period_ms=period_ms, wait_ms=wait_ms,
                samples_per_s=2e3 / period_ms, losses=losses,
                busy_share=bd["busy_share"], profiled_step=bd,
                host_step_ms=host_step_ms, host_period_ms=host_period_ms,
                numpy_period_ms=numpy_period_ms, decode_ms=decode_ms,
                raw_getter_ms=raw_getter_ms, host_getter_ms=host_getter_ms,
                numpy_getter_ms=numpy_getter_ms, eval_batches_real=n,
                eval_ms=eval_ms, posetrack_ap_keys=ap_keys, root=root,
                gt_dir=gt_dir)


def phase_parity_runbook(work, card, real):
    """``scripts/parity_runbook.py`` on the card: a reference-format
    canonical_t4 ``.pth`` of seeded weights (the port's state dict renamed
    by ``convert.reference_key_map``), its goldens against the live forward
    of the same weights (f32, TF32 off; ``msda_forward`` counts at 0 just
    before and read just after: 12 launches), and its ``cli.eval`` leg on
    ``phase_train_real``'s PoseTrack18-format set with the harness."""
    import numpy as np
    import torch

    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.convert import reference_key_map
    from snipper_tpu_torch.ops.msda import ms_deform_attn
    from snipper_tpu_torch.scripts import parity_runbook
    from snipper_tpu_torch.scripts.probe import tf32_off

    cfg = Config.canonical_t4()
    model = perturbed_model(cfg, seed=3)
    state = model.state_dict()
    ckpt = os.path.join(work, "runbook_reference.pth")
    torch.save({"model": {src: state[dst].cpu() for src, dst in
                          reference_key_map(cfg).items()}}, ckpt)
    out = os.path.join(work, "runbook")
    t0 = time.perf_counter()
    ms_deform_attn.launches = 0
    report = parity_runbook.main([
        "--checkpoint", ckpt, "--preset", "canonical_t4", "--output_dir",
        out, "--posetrack_dir", real["root"], "--posetrack_gt_dir",
        real["gt_dir"], "--device", "cuda"])
    launches = ms_deform_attn.launches
    # ----------------------------------------------------------------------
    seconds = time.perf_counter() - t0
    per_pass = cfg.enc_layers + cfg.dec_layers
    check(launches == per_pass, f"runbook forward: {launches} msda_forward "
          f"launches, expected {per_pass}")
    x = torch.from_numpy(parity_runbook.probe_input(cfg)).cuda()
    with tf32_off(), torch.inference_mode():
        live = model(x)
    want = {k: live[k].float().cpu().numpy()
            for k in parity_runbook.OUTPUTS}
    want.update({f"heatmap_{i}": h.float().cpu().numpy()
                 for i, h in enumerate(live["heatmaps"])})
    with np.load(os.path.join(out, "goldens", "torch_outputs.npz")) as got:
        check(sorted(got.files) == sorted(want), f"goldens {got.files}")
        diffs = parity_runbook.output_diffs(dict(got), want)
    worst = max(d["max_abs"] for d in diffs.values())
    check(worst <= TOL_RUNBOOK, f"runbook goldens vs the live forward: "
          f"{diffs}")
    stats = report.get("eval_posetrack", {})
    bad = {k: v for k, v in stats.items()
           if isinstance(v, float) and not math.isfinite(v)}
    check("error" not in stats and stats and not bad,
          f"runbook eval leg: {str(stats)[:2000]}")
    with open(os.path.join(out, "report.json")) as f:
        check(set(json.load(f)) >= {"checkpoint", "preset",
                                    "activation_parity", "eval_posetrack"},
              "report.json keys")
    log(f"parity runbook ({card}): canonical_t4 reference-format checkpoint;"
        f" {launches} msda_forward launches in its forward; goldens vs the "
        f"live forward worst max|diff| {worst:.3e} (tol {TOL_RUNBOOK:g}) "
        f"over {len(diffs)} outputs; cli.eval leg on the PoseTrack18-format "
        f"set: {len(stats)} finite stats (posetrack_ap_ap "
        f"{stats.get('posetrack_ap_ap')}); {seconds:.1f} s")
    del model, live
    torch.cuda.empty_cache()
    return dict(launches=launches, worst=worst, eval_keys=len(stats),
                seconds=seconds)


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


def train_fixture(cfg):
    """A train step's inputs at ``cfg`` on the card: the seeded model
    (sampling projections perturbed, seed 3) in train mode, its trained
    parameters by name (the frozen set excluded, as the optimizer excludes
    it), a batch of 2 synthetic samples and the criterion."""
    import torch

    from snipper_tpu_torch.data.snippet import stack_batch
    from snipper_tpu_torch.data.synthetic import SyntheticDataset
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.train.state import param_label
    from snipper_tpu_torch.train.step import batch_to_device

    model = perturbed_model(cfg, seed=3).train()
    named = []
    for n, p in model.named_parameters():
        p.requires_grad_(param_label(n) != "frozen")
        if p.requires_grad:
            named.append((n, p))
    ds = SyntheticDataset(cfg, n_samples=2, seed=0)
    batch = batch_to_device(stack_batch([ds[0], ds[1]]),
                            torch.device("cuda"))
    return model, named, batch, SetCriterion(cfg)


def phase_train_agreement(cfg=None, name="canonical_t4_f2", tol_loss=1e-4,
                          tol_grad=1e-3, profile=True):
    """One f32 train step's loss and gradients (``cfg``, canonical_t4_f2
    unless given, named ``name`` in the log; batch 2, dropout 0, TF32 off)
    with the kernels against the same step with the plain MSDA forward and
    VJP on the card. Tolerances: the loss within ``tol_loss`` of its size;
    each gradient tensor within ``tol_grad`` of its largest entry (at
    least 1e-3 of the largest gradient anywhere): f32 sums in other orders
    through every layer. The plain step also solves
    the matching with the plain ``lsa_rows``: every decoder layer's
    assignment must be the same, the kernel step's in one launch and one
    launch of each MSDA kernel per layer (counts at 0 just before the
    kernel step, read just after). Then, with ``profile``, a profiler
    breakdown of one bf16 train step on the same model."""
    import torch

    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.matching import matcher
    from snipper_tpu_torch.ops import deform_attn
    from snipper_tpu_torch.ops.lsa import lsa_rows_torch
    from snipper_tpu_torch.ops.msda import ms_deform_attn_torch
    from snipper_tpu_torch.train.state import create_train_state
    from snipper_tpu_torch.train.step import forward_loss, train_step

    set_tf32(False)
    cfg = (cfg or Config.canonical_t4_f2()).replace(dropout=0.0)
    n_layers = cfg.enc_layers + cfg.dec_layers
    model, named, batch, crit = train_fixture(cfg)

    def step():
        total, _, _, src = forward_loss(model, crit, batch,
                                        mixed_precision=False)
        grads = torch.autograd.grad(total, [p for _, p in named])
        return total.item(), grads, src.cpu()

    solved = []  # every layer's assignment of each step, [nl * B, M]

    def recorded(solve):
        def fn(cost):
            out = solve(cost)
            solved.append(out.cpu())
            return out
        return fn

    wrapper, solver = deform_attn.ms_deform_attn, matcher.lsa_rows
    matcher.lsa_rows = recorded(solver)
    # ---- the kernel step, with every kernel's count at 0 ----------------
    zero_counts()
    try:
        loss_k, grads_k, src_k = step()
    finally:
        matcher.lsa_rows = solver
    launches = counts()
    # ----------------------------------------------------------------------
    lsa_launches = launches["lsa_rows"]
    deform_attn.ms_deform_attn = ms_deform_attn_torch
    matcher.lsa_rows = recorded(lsa_rows_torch)
    try:
        loss_p, grads_p, src_p = step()
    finally:
        deform_attn.ms_deform_attn, matcher.lsa_rows = wrapper, solver
    check(lsa_launches == 1 and len(solved) == 2,
          f"the kernel step launched lsa_rows {lsa_launches} times")
    check(launches["msda_forward"] == launches["msda_backward"] == n_layers,
          f"{name}: the kernel step's MSDA launches {launches}, expected "
          f"{n_layers} of each")
    check(torch.equal(src_k, src_p) and torch.equal(*solved),
          "the two steps matched differently")
    g_max = max(g.abs().max().item() for g in grads_p)
    worst = (0.0, "", 0.0)
    for (pname, _), gk, gp in zip(named, grads_k, grads_p):
        err = (gk - gp).abs().max().item()
        scale = max(gp.abs().max().item(), 1e-3 * g_max)
        check(math.isfinite(err), f"non-finite gradient {pname}")
        if err / scale > worst[0]:
            worst = (err / scale, pname, err)
    loss_err = abs(loss_k - loss_p)
    check(loss_err <= tol_loss * max(1.0, abs(loss_p)),
          f"{name} train step loss kernel {loss_k} vs plain {loss_p}")
    check(worst[0] <= tol_grad,
          f"{name} train step gradients: {worst[1]} max|diff| {worst[2]} "
          f"is {worst[0]:.3e} of its scale > {tol_grad}")
    problems, slots = solved[0].shape
    log(f"{name} b2 f32 train step ({cfg.input_height}x{cfg.input_width} "
        f"enc{cfg.enc_layers}/dec{cfg.dec_layers}), kernels vs plain MSDA "
        f"forward "
        f"and VJP on the card (TF32 off, dropout 0): loss {loss_k:.6f} vs "
        f"{loss_p:.6f} (|diff| {loss_err:.3e}, tol {tol_loss:g} relative); "
        f"{len(named)} gradient tensors, largest |grad| {g_max:.4e}, worst "
        f"{worst[1]} max|diff| {worst[2]:.3e} = {worst[0]:.3e} of its scale"
        f" (tol {tol_grad:g}); the same matching on all "
        f"{problems} problems of M={slots} slots and N={cfg.num_queries} "
        f"queries (every decoder layer of each sample), the kernel step's "
        f"in {lsa_launches} lsa_rows launch; launches {launches}")
    del grads_k, grads_p
    res = dict(loss_kernel=loss_k, loss_plain=loss_p, loss_abs_diff=loss_err,
               grad_worst_rel=worst[0], grad_worst_param=worst[1],
               grad_worst_abs=worst[2], grad_max=g_max,
               n_grads=len(named), launches=launches, problems=problems,
               slots=slots, queries=cfg.num_queries)
    if not profile:
        del model, batch
        torch.cuda.empty_cache()
        return res

    # where a bf16 train step's time goes (the CLI's step: forward,
    # criterion with the matching on the card, backward, clip, AdamW), with
    # PyTorch's default TF32 settings
    torch.backends.cudnn.allow_tf32 = True
    state = create_train_state(cfg, model)
    gen = torch.Generator().manual_seed(0)
    # the step as a CUDA graph: the two warm-up calls run it eagerly and
    # capture it, the timed and the profiled calls replay it
    bd = breakdown(lambda: train_step(state, crit, batch, gen), top=10,
                   need=("msda_forward", "msda_backward", "lsa_rows"))
    check(state.graph is not None and state.graph.graph is not None
          and bd["launches"] == {"msda_forward": n_layers,
                                 "msda_backward": n_layers, "lsa_rows": 1},
          f"the profiled train step, a replay, ran {bd['launches']}, "
          f"expected {n_layers} of each MSDA kernel and one lsa_rows")
    log(f"one canonical_t4_f2 b2 bf16 train step, a CUDA graph's replay "
        f"(cuDNN TF32 on; its kernels by the profiler {bd['launches']}): "
        f"wall "
        f"{bd['wall_ms']:.2f} ms (CUDA events), device kernels "
        f"{bd['device_ms']:.2f} ms (torch.profiler), busy share "
        f"{bd['busy_share']:.3f}, msda_forward {bd['msda_ms']:.3f} ms, "
        f"msda_backward {bd['msda_backward_ms']:.3f} ms")
    for name, ms, count in bd["top"]:
        log(f"  {ms:9.3f} ms  x{count:<4d} {name}")
    del model, batch, state
    torch.cuda.empty_cache()
    return dict(res, step_breakdown=bd)


# ---------------------------------------------------------------- presets
# the presets no other phase runs, each at its own width, queries, frames
# and image size
PRESET_RUNS = ("canonical_t1", "light_t4", "light_t4_f2", "jta_forecast",
               "panoptic")
# cli.infer runs of two of them: (preset, frames, width, height); 10 frames
# make 3 snippets of 4, 7 frames 6 snippets of 1
PRESET_INFER = (("panoptic", 10, 960, 540), ("canonical_t1", 7, 800, 600))
# the person logit over the background one in those runs' weights, so that
# every query scores a person (0.98) and the postprocess and the
# association work on every query (seeded weights score none)
PERSON_LOGIT = 4.0


def level_shapes(cfg):
    """The three backbone levels' (h, w) at ``cfg``'s input: strides 8, 16
    and 32, rounded up as the strided convolutions round."""
    return [(-(-cfg.input_height // s), -(-cfg.input_width // s))
            for s in (8, 16, 32)]


def check_forward_shapes(cfg, out, label):
    """``pred_*`` and the heatmaps of a batch-1 forward of ``cfg``: shapes
    and finite values."""
    import torch

    q, t1, k = cfg.num_queries, cfg.total_frames, cfg.num_kpts
    want = {"pred_logits": (1, q, t1, 2), "pred_kpts2d": (1, q, t1, k, 3),
            "pred_depth": (1, q, t1, k, 1)}
    for key, shape in want.items():
        check(tuple(out[key].shape) == shape,
              f"{label}: {key} {tuple(out[key].shape)}, expected {shape}")
        check(bool(torch.isfinite(out[key]).all()),
              f"{label}: non-finite {key}")
    hm = [tuple(h.shape) for h in out["heatmaps"]]
    want_hm = [(1, cfg.num_frames, h, w, cfg.nheads, k)
               for h, w in level_shapes(cfg)]
    check(hm == want_hm, f"{label}: heatmaps {hm}, expected {want_hm}")
    check(all(bool(torch.isfinite(h).all()) for h in out["heatmaps"]),
          f"{label}: non-finite heatmaps")


def preset_infer(work, name, n_frames, width, height):
    """``cli.infer`` on ``name`` over ``n_frames`` synthetic JPEGs of
    ``width`` x ``height`` with seeded weights (sampling projections
    perturbed, every query a person), counts set to 0 just before and read
    just after: one ``msda_forward`` launch per layer and snippet, finite
    tracks of the preset's keypoints."""
    import numpy as np
    import torch

    from snipper_tpu_torch.cli import infer as infer_cli
    from snipper_tpu_torch.config import Config

    cfg = getattr(Config, name)()
    frame_dir = os.path.join(work, f"frames_{name}")
    write_frames(frame_dir, n_frames, width=width, height=height)
    model = perturbed_model(cfg)
    with torch.no_grad():
        model.class_embed.bias.copy_(torch.tensor([0.0, PERSON_LOGIT]))
    ckpt = os.path.join(work, f"{name}_seed0.pt")
    torch.save({"params": model.state_dict(), "step": 0}, ckpt)
    del model
    out_dir = os.path.join(work, f"out_{name}")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    # ---- cli.infer, with every kernel's count at 0 -----------------------
    zero_counts()
    stats = infer_cli.main([
        "--preset", name, "--data_dir", frame_dir, "--output_dir", out_dir,
        "--seq_gap", "1", "--resume", ckpt, "--device", "cuda"])
    launches = counts()
    # ----------------------------------------------------------------------
    n = stats["snippets"]
    n_layers = cfg.enc_layers + cfg.dec_layers
    check(n >= 2 and launches["msda_forward"] == n_layers * n,
          f"{name} cli.infer: {launches} over {n} snippets, expected "
          f"{n_layers} msda_forward launches per snippet")
    with open(os.path.join(out_dir, "tracks.pkl"), "rb") as f:
        tracks = pickle.load(f)
    per_frame = []
    for pids, data in tracks["frames"].values():
        check(data.ndim == 3 and data.shape[1:] == (cfg.num_kpts, 4)
              and len(pids) == data.shape[0],
              f"{name} cli.infer: track data shape {data.shape}")
        check(bool(np.all(np.isfinite(data))),
              f"{name} cli.infer: non-finite tracks")
        per_frame.append(data.shape[0])
    check(tracks["max_pid"] > 0 and per_frame and min(per_frame) > 0,
          f"{name} cli.infer: {tracks['max_pid']} identities, persons per "
          f"frame {per_frame}")
    fwd_ms = statistics.median(stats["forward_ms"][1:])
    log(f"{name} cli.infer ({width}x{height} frames, input "
        f"{cfg.input_width}x{cfg.input_height}, enc{cfg.enc_layers}/"
        f"dec{cfg.dec_layers}, {cfg.num_queries} queries, T="
        f"{cfg.num_frames}): {n} snippets, launches {launches} "
        f"({launches['msda_forward'] / n:g} msda_forward a snippet); "
        f"{tracks['max_pid']} identities over {len(per_frame)} frames, "
        f"{min(per_frame)}-{max(per_frame)} persons a frame, all finite; "
        f"forward + readback {fwd_ms:.2f} ms a snippet (median, first "
        f"excluded)")
    return dict(snippets=n, launches=launches, identities=tracks["max_pid"],
                frames=len(per_frame), persons=per_frame, forward_ms=fwd_ms)


def deform_f32_forward(card):
    """(d) The bench's bf16 canonical_t4 b1 forward on the same seeded
    weights (sampling projections perturbed) with ``deform_dtype`` "auto"
    and "float32": each held against the plain MSDA on the card
    (:func:`hold_bench_forward`), its 12 launches all of the bf16-value
    kernel under "auto" and of the f32-value kernel under "float32"; the
    two forwards' difference in bf16 units; ms a forward of each (CUDA
    events, alternating) and their device time by kernel (torch.profiler,
    ``breakdown``)."""
    import numpy as np
    import torch

    from snipper_tpu_torch import bench
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.models.transformer import TemporalDeformAttn

    set_tf32(False)
    cfg = Config.canonical_t4()
    n_layers = cfg.enc_layers + cfg.dec_layers
    state = perturbed_model(cfg).state_dict()
    x = bench.input_batch(np.random.default_rng(0), cfg, 1, "cuda")
    models, res = {}, {}
    for dd in ("auto", "float32"):
        c = cfg.replace(deform_dtype=dd)
        models[dd] = model = bench.bf16_net(c, "cuda", state)
        attns = [m for m in model.modules()
                 if isinstance(m, TemporalDeformAttn)]
        check(len(attns) == n_layers
              and all(m.sample_dtype == dd for m in attns),
              f"deform_dtype {dd} did not reach every sampling module")
        held = hold_bench_forward(model, x, n_layers,
                                  f"canonical_t4 bf16 forward ({dd})")
        kind = "f32" if dd == "float32" else "bf16"
        check(held["by_dtype"][kind] == n_layers
              and sum(held["by_dtype"].values()) == n_layers,
              f"canonical_t4 bf16 forward ({dd}): msda_forward launches by "
              f"value dtype {held['by_dtype']}, expected {n_layers} {kind}")
        check_forward_shapes(cfg, held["got"], f"canonical_t4 ({dd})")
        res[dd] = held
    del state
    diff = {}
    for k in ("pred_logits", "pred_kpts2d", "pred_depth"):
        a = res["float32"]["got"][k].float()
        b = res["auto"]["got"][k].float()
        scale = max(1.0, b.abs().max().item()) * BF16_UNIT
        diff[k] = dict(max=(a - b).abs().max().item() / scale,
                       rms=(a - b).pow(2).mean().sqrt().item() / scale)
    times = {"auto": [], "float32": []}
    for order in (("auto", "float32"), ("float32", "auto")):
        for dd in order:
            times[dd].append(time_ms(
                lambda: bench.forward(models[dd], x), reps=10))
    bds = {dd: breakdown(lambda: bench.forward(models[dd], x))
           for dd in ("auto", "float32")}
    ms = {dd: statistics.median(t) for dd, t in times.items()}
    log(f"canonical_t4 b1 bf16 forward (the bench's), deform_dtype float32"
        f" vs auto on the same weights and input (TF32 off): msda_forward "
        f"launches by value dtype {res['float32']['by_dtype']} / "
        f"{res['auto']['by_dtype']}; kernel vs plain MSDA per call within "
        f"{max(res['float32']['call_units']):.2e} / "
        f"{max(res['auto']['call_units']):.3f} bf16 units, whole forward "
        f"rms {json.dumps(res['float32']['rms'])} / "
        f"{json.dumps(res['auto']['rms'])}; float32 against auto "
        f"{json.dumps(diff)} bf16 units; {ms['float32']:.3f} / "
        f"{ms['auto']:.3f} ms a forward (CUDA events, {times}); device "
        f"{bds['float32']['device_ms']:.3f} / {bds['auto']['device_ms']:.3f}"
        f" ms of {bds['float32']['kernel_launches']} / "
        f"{bds['auto']['kernel_launches']} kernel launches, msda_forward "
        f"{bds['float32']['msda_ms']:.3f} / {bds['auto']['msda_ms']:.3f} "
        f"ms, busy {bds['float32']['busy_share']:.3f} / "
        f"{bds['auto']['busy_share']:.3f} ({card})")
    del models, res
    torch.cuda.empty_cache()
    return dict(launches_by_dtype={"msda_forward": {"f32": n_layers,
                                                    "bf16": 0}},
                diff_units=diff, ms=ms, times=times,
                device_ms={dd: b["device_ms"] for dd, b in bds.items()},
                msda_ms={dd: b["msda_ms"] for dd, b in bds.items()},
                kernel_launches={dd: b["kernel_launches"]
                                 for dd, b in bds.items()})


def _grad_gap(grads, ref):
    """``||grads - ref|| / ||ref||`` over all tensors."""
    num = sum((g - r).float().pow(2).sum().item() for g, r in zip(grads, ref))
    den = sum(r.float().pow(2).sum().item() for r in ref)
    return math.sqrt(num / den)


def deform_f32_step(card, tol_floor=1e-2):
    """(e) One bf16 mixed-precision canonical_t4_f2 step at CUT_DEPTH,
    batch 2 (dropout 0, TF32 off), with ``deform_dtype="float32"``: the
    kernel step (counts at 0 just before, read just after: one f32-value
    launch of each MSDA kernel per layer, no bf16 one) against the same
    step with the plain MSDA forward, its VJP and the plain assignment on
    the card, beside the plain step with its levels summed in the other
    order (how far a bf16 step carries an f32 rounding of one sampling
    output): the losses finite, the kernel step's loss and its gradients
    (``||g - g_plain|| / ||g_plain||`` over all tensors) within twice the
    reordered step's distance or ``tol_floor`` of their size, the same
    matching. Then the update step's ms (``train_step``, CUDA events) under
    "float32" and "auto" in turns, a CUDA graph's replays (the eager first
    step and the capture left out of the timing): the wrappers' launches
    by value dtype in the eager step and the capture, and each setting's
    replay's kernels by value dtype (torch.profiler)."""
    import torch

    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.matching import matcher
    from snipper_tpu_torch.ops import deform_attn
    from snipper_tpu_torch.ops.lsa import lsa_rows_torch
    from snipper_tpu_torch.ops.msda import ms_deform_attn_torch
    from snipper_tpu_torch.train.state import create_train_state
    from snipper_tpu_torch.train.step import forward_loss, train_step

    set_tf32(False)
    base = Config.canonical_t4_f2().replace(dropout=0.0, **CUT_DEPTH)
    n_layers = base.enc_layers + base.dec_layers
    cfg = base.replace(deform_dtype="float32")
    model, named, batch, crit = train_fixture(cfg)
    params = [p for _, p in named]

    def step():
        total, _, _, src = forward_loss(model, crit, batch,
                                        mixed_precision=True)
        return total.item(), torch.autograd.grad(total, params), src.cpu()

    wrapper, solver = deform_attn.ms_deform_attn, matcher.lsa_rows
    # ---- the kernel step, with every kernel's count at 0 ----------------
    zero_counts()
    loss_k, grads_k, src_k = step()
    launches, by_dtype = counts(), dtype_counts()
    # ----------------------------------------------------------------------
    runs = {}
    for name, fn in (("plain", ms_deform_attn_torch),
                     ("reordered", msda_levels_reversed)):
        deform_attn.ms_deform_attn, matcher.lsa_rows = fn, lsa_rows_torch
        try:
            runs[name] = step()
        finally:
            deform_attn.ms_deform_attn, matcher.lsa_rows = wrapper, solver
    want = {"f32": n_layers, "bf16": 0}
    check(by_dtype == {"msda_forward": want, "msda_backward": want}
          and launches["lsa_rows"] == 1,
          f"the float32 bf16 step's launches {launches}, by value dtype "
          f"{by_dtype}, expected {n_layers} f32 of each MSDA kernel")
    loss_p, grads_p, src_p = runs["plain"]
    loss_r, grads_r, src_r = runs["reordered"]
    check(all(math.isfinite(v) for v in (loss_k, loss_p, loss_r)),
          f"non-finite loss {loss_k} / {loss_p} / {loss_r}")
    gap_k, gap_r = _grad_gap(grads_k, grads_p), _grad_gap(grads_r, grads_p)
    loss_tol = max(2 * abs(loss_r - loss_p), tol_floor * abs(loss_p))
    grad_tol = max(2 * gap_r, tol_floor)
    check(math.isfinite(gap_k) and gap_k <= grad_tol
          and abs(loss_k - loss_p) <= loss_tol
          and torch.equal(src_k, src_p),
          f"the float32 bf16 step, kernels vs plain: loss {loss_k} vs "
          f"{loss_p} (reordered {loss_r}, tol {loss_tol}), gradient gap "
          f"{gap_k} (reordered {gap_r}, tol {grad_tol}), the same matching "
          f"{torch.equal(src_k, src_p)} (reordered "
          f"{torch.equal(src_r, src_p)})")
    del grads_k, grads_p, grads_r, runs
    # the update step under each setting, in turns
    states = {"float32": create_train_state(cfg, model)}
    auto = perturbed_model(base, seed=3)
    states["auto"] = create_train_state(base, auto)
    gen = torch.Generator().manual_seed(0)
    times, step_counts, replayed = {"auto": [], "float32": []}, {}, {}
    for order in (("float32", "auto"), ("auto", "float32")):
        for dd in order:
            zero_counts()
            times[dd].append(time_ms(
                lambda: train_step(states[dd], crit, batch, gen), reps=5,
                warmup=2))
            step_counts.setdefault(dd, []).append(
                (dtype_counts(), graph_counts()))
    for dd, state in states.items():
        replayed[dd] = replay_launches(
            lambda: train_step(state, crit, batch, gen))
    for dd, cs in step_counts.items():
        kind = "f32" if dd == "float32" else "bf16"
        other = "bf16" if kind == "f32" else "f32"
        # the first turn: the eager step and the capture call the
        # wrappers, its other 6 steps replay; the second turn replays
        want = [{k: {kind: 2 * n_layers, other: 0}
                 for k in ("msda_forward", "msda_backward")},
                {k: {kind: 0, other: 0}
                 for k in ("msda_forward", "msda_backward")}]
        check([c for c, _ in cs] == want
              and [g for _, g in cs] == [{"captures": 1, "replays": 6},
                                         {"captures": 0, "replays": 7}],
              f"timed {dd} steps: the wrappers' launches by value dtype "
              f"and the graph's counts {cs}")
        check(replayed[dd] == {"msda_forward": {kind: n_layers, other: 0},
                               "msda_backward": {kind: n_layers, other: 0},
                               "lsa_rows": 1},
              f"a replayed {dd} step ran {replayed[dd]}")
    ms = {dd: statistics.median(t) for dd, t in times.items()}
    log(f"canonical_t4_f2 b2 bf16 mixed-precision step at "
        f"enc{base.enc_layers}/dec{base.dec_layers} with deform_dtype "
        f"float32, kernels vs plain MSDA, VJP and assignment on the card "
        f"(TF32 off, dropout 0): launches {launches}, by value dtype "
        f"{by_dtype}; loss {loss_k:.6f} vs {loss_p:.6f} (reordered "
        f"{loss_r:.6f}); gradients {gap_k:.3e} of their norm from the plain"
        f" step's (reordered {gap_r:.3e}; tol {grad_tol:.3e}); the same "
        f"matching; a train step, a CUDA graph's replay, {ms['float32']:.2f}"
        f" ms with float32, {ms['auto']:.2f} with auto (CUDA events, "
        f"{times}), its kernels by the profiler {replayed} ({card})")
    del model, auto, states, batch
    torch.cuda.empty_cache()
    return dict(launches=launches, launches_by_dtype=by_dtype,
                loss_kernel=loss_k, loss_plain=loss_p, loss_reordered=loss_r,
                grad_gap=gap_k, grad_gap_reordered=gap_r, step_ms=ms,
                times=times, replay_launches=replayed)


def phase_presets(card):
    """The five presets that no other phase runs (``PRESET_RUNS``), each at
    its own width, queries, frames and image size: (a) the bench's bf16
    b1 forward at full depth on seeded weights with the sampling
    projections perturbed (:func:`hold_bench_forward`: ``enc + dec``
    launches, every call and the whole forward held against the plain
    MSDA on the card), its shapes and ms a forward (CUDA events); (b) one
    f32 train step at CUT_DEPTH, batch 2, against the plain step
    (:func:`phase_train_agreement`: loss, gradients, every decoder layer's
    matching in one ``lsa_rows`` launch). (c) ``cli.infer`` of panoptic at
    960x540 and of canonical_t1 (:func:`preset_infer`). Then
    ``deform_dtype="float32"`` on the card: (d) :func:`deform_f32_forward`,
    (e) :func:`deform_f32_step`."""
    import numpy as np
    import torch

    from snipper_tpu_torch import bench
    from snipper_tpu_torch.config import Config

    res = {"forward": {}, "train_step": {}, "infer": {}}
    for name in PRESET_RUNS:
        cfg = getattr(Config, name)()
        n_layers = cfg.enc_layers + cfg.dec_layers
        # (a) the bench's forward at full depth
        set_tf32(False)
        state = perturbed_model(cfg).state_dict()
        model = bench.bf16_net(cfg, "cuda", state)
        del state
        x = bench.input_batch(np.random.default_rng(0), cfg, 1, "cuda")
        held = hold_bench_forward(model, x, n_layers,
                                  f"{name} bf16 forward")
        check(held["by_dtype"] == {"f32": 0, "bf16": n_layers},
              f"{name}: msda_forward by value dtype {held['by_dtype']}")
        check_forward_shapes(cfg, held["got"], f"{name} bf16 forward")
        ms = time_ms(lambda: bench.forward(model, x), reps=10)
        del model, held["got"]
        torch.cuda.empty_cache()
        res["forward"][name] = dict(held, ms=ms)
        log(f"{name} b1 bf16 forward (the bench's; {cfg.input_width}x"
            f"{cfg.input_height}, levels {level_shapes(cfg)}, enc"
            f"{cfg.enc_layers}/dec{cfg.dec_layers}, {cfg.num_queries} "
            f"queries, T={cfg.num_frames}+{cfg.num_future_frames}): "
            f"{held['per_forward']} msda_forward launches a forward; kernel "
            f"vs plain MSDA per call within {max(held['call_units']):.3f} "
            f"bf16 units, whole forward rms {json.dumps(held['rms'])} (max "
            f"{json.dumps(held['units'])}); {ms:.3f} ms a forward (CUDA "
            f"events, TF32 off) ({card})")
        # (b) one f32 train step at CUT_DEPTH, kernels against plain
        res["train_step"][name] = phase_train_agreement(
            cfg.replace(**CUT_DEPTH), name=name, profile=False)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_presets_") as work:
        for name, n_frames, width, height in PRESET_INFER:
            res["infer"][name] = preset_infer(work, name, n_frames, width,
                                              height)
    res["f32_forward"] = deform_f32_forward(card)
    res["f32_step"] = deform_f32_step(card)
    return res


# ------------------------------------------------------------- matching
def lsa_fixtures(seed=0):
    """Assignment problems in the matcher's layout, ``(name, cost [P, N, M]
    f32)``, which tests/test_torch_port_cuda.py and
    tests/test_torch_port_lsa.py use too: (a) integer costs
    in {0..3} with 1..M valid slots and the padding columns zeroed (every
    dual an exact f32 integer, so only the algorithm's order breaks the
    ties), N in (8, 20, 60), M from 1 to N, 210 problems; (b) continuous
    costs; (c) M = N and M = 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for n, ms in ((8, range(1, 9)), (20, (1, 2, 5, 10, 15, 19, 20)),
                  (60, (1, 8, 20, 32, 59, 60))):
        for m in ms:
            c = rng.integers(0, 4, (10, n, m)).astype(np.float32)
            for p, nv in enumerate(rng.integers(1, m + 1, 10)):
                c[p, :, nv:] = 0.0
            out.append((f"tied_n{n}_m{m}", c))
    for n, m in ((8, 4), (60, 32)):
        out.append((f"continuous_n{n}_m{m}",
                    rng.standard_normal((10, n, m)).astype(np.float32)))
    for n, m in ((7, 7), (60, 60), (9, 1), (60, 1)):
        out.append((f"edge_n{n}_m{m}", rng.uniform(
            -1, 1, (5, n, m)).astype(np.float32)))
    return out


def lsa_bound_ms(P, M, N, steps):
    """Least time for ``lsa_rows`` on ``P`` problems of ``M`` x ``N`` that
    took ``steps`` Dijkstra steps in all: the costs read once and the
    indices written once, against, per step, N reduced costs (three adds
    and a compare each) and N compares of the argmin, and per row and
    problem the dual updates (M + N)."""
    return _bound(P * M * N * 4 + P * M * 8,
                  5 * N * steps + 2 * P * M * (M + N))


def phase_matching(card):
    """The ``lsa_rows`` kernel (JAX's Jonker-Volgenant solver) against the
    plain version: every slot of the fixtures of :func:`lsa_fixtures`, and
    of the 12 problems (6 decoder layers x batch 2) of a real
    canonical_t4_f2 b2 bf16 train step's costs, caught where the matcher
    solves them; the kernel's time per call (CUDA events) and alone
    (torch.profiler) beside its bound, the plain version on the card and
    the scipy route the port took before (the costs copied to the host, 12
    solves, the indices copied back). That step (forward, criterion,
    backward, clip and AdamW), run eagerly, runs under
    ``torch.cuda.set_sync_debug_mode("error")``, its counts at 0 just
    before and read just after (one ``lsa_rows`` launch); its loss is read
    after. Then the step as a CUDA graph: captured (which synchronises),
    then one replay under the same check, its wrappers' counts at 0 and
    one replay counted. Should a synchronising call raise, the step runs
    again in ``"warn"`` mode and every synchronising call's stack is
    logged."""
    import traceback
    import warnings

    import numpy as np
    import torch

    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.data.snippet import stack_batch
    from snipper_tpu_torch.data.synthetic import SyntheticDataset
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.matching import matcher
    from snipper_tpu_torch.ops.lsa import lsa_rows, lsa_rows_torch
    from snipper_tpu_torch.train.state import create_train_state
    from snipper_tpu_torch.train.step import batch_to_device, train_step

    # (a)-(c): the kernel against the plain version on every slot
    n_fix = 0
    for name, c in lsa_fixtures():
        cost = torch.from_numpy(c)
        before = lsa_rows.launches
        got = lsa_rows(cost.cuda().transpose(1, 2))
        check(lsa_rows.launches == before + 1, f"lsa_rows {name}: launches")
        want = lsa_rows_torch(cost.transpose(1, 2))
        torch.cuda.synchronize()
        check(torch.equal(got.cpu(), want),
              f"lsa_rows kernel vs plain on {name}: "
              f"{int((got.cpu() != want).sum())} slots differ")
        n_fix += len(c)

    # a real step: canonical_t4_f2 b2, bf16 mixed precision, the CLI's
    # TF32 settings; one step first (lazy initialisation), then the step
    # under the sync check with the costs caught where they are solved
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.canonical_t4_f2()
    model = perturbed_model(cfg, seed=4).train()
    state = create_train_state(cfg, model)
    # eager steps first: the step's second call would capture it as a
    # CUDA graph, which synchronises the device before it starts
    graphed, state.graphed = state.graphed, False
    crit = SetCriterion(cfg)
    ds = SyntheticDataset(cfg, n_samples=2, seed=1)
    batch = batch_to_device(stack_batch([ds[0], ds[1]]),
                            torch.device("cuda"))
    gen = torch.Generator().manual_seed(0)
    train_step(state, crit, batch, gen)
    torch.cuda.synchronize()
    caught = []
    solve = matcher.lsa_rows

    def catch(cost):
        caught.append(cost.clone())
        return solve(cost)

    def sync_step(mode):
        matcher.lsa_rows = catch
        torch.cuda.set_sync_debug_mode(mode)
        try:
            return train_step(state, crit, batch, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            matcher.lsa_rows = solve

    def sync_checked(what):
        """``sync_step("error")`` with every count at 0: its metrics and
        counts; should it raise, every synchronising call's stack is
        logged and the check fails."""
        # ---- the step under the sync check, with every count at 0 ------
        zero_counts()
        try:
            metrics = sync_step("error")
            raised = None
        except RuntimeError as e:
            raised = e
        launches, graph = counts(), graph_counts()
        # ------------------------------------------------------------------
        if raised is None:
            return metrics, launches, graph
        sites = []

        def keep(message, category, filename, lineno, file=None,
                 line=None):
            sites.append(f"{message}\n" + "".join(
                traceback.format_stack()[:-1][-12:]))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = keep
            sync_step("warn")
            torch.cuda.synchronize()
        for site in sites:
            log(f"synchronising call in the {what}: {site}")
        check(False, f"the {what} synchronised under "
              f"set_sync_debug_mode('error'): {raised}; {len(sites)} "
              f"synchronising calls logged above")

    metrics, launches, _ = sync_checked("eager train step")
    loss = metrics["loss_total"].item()
    check(math.isfinite(loss), f"the sync-checked step's loss {loss}")
    check(launches == {"msda_forward": cfg.enc_layers + cfg.dec_layers,
                       "msda_backward": cfg.enc_layers + cfg.dec_layers,
                       "lsa_rows": 1},
          f"the sync-checked step launched {launches}")
    cost = caught[-1]                                   # [12, 32, 60] view
    P, M, N = cost.shape
    got = lsa_rows(cost)
    want, steps = lsa_rows_torch(cost.cpu(), return_steps=True)
    check(torch.equal(got.cpu(), want),
          f"lsa_rows kernel vs plain on the step's {P} problems: "
          f"{int((got.cpu() != want).sum())} slots differ")
    n_steps = int(steps.sum())

    # the step as a CUDA graph: its first graphable call runs eagerly, its
    # second captures it (which synchronises); then one replay under the
    # sync check, which calls no kernel's wrapper
    state.graphed = graphed
    train_step(state, crit, batch, gen)
    train_step(state, crit, batch, gen)
    torch.cuda.synchronize()
    replayed, replay_counts, replay_graph = sync_checked(
        "replayed train step")
    replay_loss = replayed["loss_total"].item()
    check(graphed and math.isfinite(replay_loss)
          and replay_graph == {"captures": 0, "replays": 1}
          and replay_counts == {"msda_forward": 0, "msda_backward": 0,
                                "lsa_rows": 0},
          f"the sync-checked replay: loss {replay_loss}, graph "
          f"{replay_graph}, wrappers' launches {replay_counts}")

    # times: the kernel per call and alone, the plain version on the card,
    # the scipy route of the parent (host copy, P solves, copy back)
    ms = time_ms(lambda: lsa_rows(cost), reps=50)
    dev_ms = device_ms(lambda: lsa_rows(cost), "lsa_rows_kernel", reps=20)
    plain_ms = time_ms(lambda: lsa_rows_torch(cost), reps=3, warmup=1)
    costs_nm = cost.transpose(1, 2)                     # [P, N, M], as built

    def scipy_route():
        src = matcher.hungarian_scipy(costs_nm.cpu().numpy())
        return torch.from_numpy(src).pin_memory().cuda(non_blocking=True)

    # scipy breaks ties otherwise, but its assignment costs the same
    rows = torch.arange(M)
    totals = [float(cost.cpu()[p, rows, a[p].cpu()].sum())
              for a in (want, scipy_route().cpu()) for p in range(P)]
    check(np.allclose(totals[:P], totals[P:], rtol=1e-5, atol=1e-5),
          f"lsa_rows vs scipy's optimal cost on the step's problems: "
          f"{totals}")
    scipy_ms = time_ms(scipy_route, reps=20)
    bound, bound_by = lsa_bound_ms(P, M, N, n_steps)
    valid = batch["targets"]["valid"].sum().item()
    log(f"lsa_rows ({card}): the kernel equals the plain version on every "
        f"slot of {n_fix} fixture problems (tied integer, continuous, "
        f"M = N, M = 1) and of a canonical_t4_f2 b2 bf16 step's {P} "
        f"problems ({M} slots x {N} queries, {valid} valid targets, "
        f"{n_steps} Dijkstra steps in all, {max(steps.tolist())} at most "
        f"in one problem); {ms:.4f} ms per call (CUDA events), "
        f"{dev_ms:.4f} ms of device time alone (torch.profiler), "
        f"{dev_ms * 1e3 / max(steps.tolist()):.3f} us per dependent step "
        f"of the longest problem; bound {bound:.6f} ms ({bound_by}); plain "
        f"version on the card {plain_ms:.2f} ms; the scipy route (copy to "
        f"the host, {P} solves, copy back) {scipy_ms:.4f} ms. The step "
        f"(forward, criterion, backward, clip, AdamW) ran under "
        f"set_sync_debug_mode('error') without a synchronising call, "
        f"launches {launches}, loss {loss:.4f} read after it; so did a "
        f"replay of it as a CUDA graph ({replay_graph}), loss "
        f"{replay_loss:.4f}")
    del model, state, batch, caught, cost
    torch.cuda.empty_cache()
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                scipy_ms=scipy_ms, bound_ms=bound, bound_by=bound_by,
                problems=P, slots=M, queries=N, dijkstra_steps=n_steps,
                max_steps=max(steps.tolist()), fixture_problems=n_fix,
                step_launches=launches, max_abs_err=0)


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
    f32 canonical_t4_f2 step at CUT_DEPTH with dropout 0 on a data-parallel
    mesh (batch
    1 a rank) and on a tensor-parallel one (the batch of 2, 4 heads a
    rank; two steps each, the first counted, the second timed), then
    ``cli.infer``'s serving function over the two ranks. Each run's kernel
    counts are set to 0 just before it and read just after."""
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
    cfg = Config.canonical_t4_f2().replace(dropout=0.0, **CUT_DEPTH)
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
        # the first step counted, the second timed (a third cost 5-6 s of
        # gloo at tp2 and timed the same)
        for i in range(2):
            torch.cuda.synchronize()
            if i == 0:
                # ---- this rank's step, with its kernels' counts at 0 ----
                zero_counts()
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
                launches = counts()
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

    if mode == "train":
        from snipper_tpu_torch.cli.train import main as cli_main
    else:
        from snipper_tpu_torch.cli.infer import main as cli_main
    # ---- the CLI, with every kernel's count at 0 -------------------------
    zero_counts()
    res = cli_main(argv)
    launches, graph = counts(), graph_counts()
    # ----------------------------------------------------------------------
    if mode == "train":
        keep = {"checkpoint": res["checkpoint"], "graph": graph,
                "losses": [h["loss_total"] for h in res["history"]],
                "period_s": [h["seconds"] + h["data_seconds"]
                             for h in res["history"]]}
    else:
        keep = {k: res[k] for k in ("snippets", "seconds", "done_at",
                                    "forward_ms")}
    with open(out_json, "w") as f:
        json.dump({"launches": launches, **keep}, f)
    return 0


def bench_child(out_json):
    """The child of :func:`phase_bench`: ``snipper_tpu_torch.bench`` run as
    ``python -m`` runs it (``runpy``, ``__main__``, no arguments) with the
    kernels' counts set to 0 just before and read just after, written to
    ``out_json``; returns the bench's exit code."""
    import runpy


    sys.argv = ["snipper_tpu_torch.bench"]
    # ---- the bench, with every kernel's count at 0 -----------------------
    zero_counts()
    try:
        runpy.run_module("snipper_tpu_torch.bench", run_name="__main__",
                         alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    launches, graph = counts(), graph_counts()
    # ----------------------------------------------------------------------
    with open(out_json, "w") as f:
        json.dump({"launches": launches, "graph": graph}, f)
    return rc


def hold_bench_forward(model, x, n_layers, label):
    """The bench's forward (``bench.forward``) of ``model`` on ``x``, held
    against the plain MSDA on the card: (a) each of its MSDA calls, kernel
    against plain on the inputs that call received, within one rounding to
    the value's dtype (``TOL_BF16_REL`` of its scale for a bf16 value,
    ``TOL_F32`` of it for an f32 one); (b) the whole forward with the
    kernel against it with the plain MSDA, each ``pred_*``'s rms
    difference within twice that of the plain forward against itself with
    its levels summed in the other order (at least ``TOL_BENCH_RMS_UNITS``
    bf16 units of its scale). The counts are set to 0 just before the
    kernel's forward and read just after: ``n_layers`` launches. Returns
    that forward's outputs (``got``), its launches (``per_forward``, and
    ``by_dtype`` of the value) and the differences in bf16 units."""
    import torch

    from snipper_tpu_torch import bench
    from snipper_tpu_torch.ops import deform_attn
    from snipper_tpu_torch.ops.msda import ms_deform_attn, ms_deform_attn_torch

    # each MSDA call of the forward, its inputs kept
    calls = []
    wrapper = deform_attn.ms_deform_attn

    def keep(value, shapes, loc, attn):
        out = wrapper(value, shapes, loc, attn)
        calls.append((value.clone(), shapes, loc.clone(), attn.clone(),
                      out.clone()))
        return out

    deform_attn.ms_deform_attn = keep
    try:
        zero_counts()
        got = bench.forward(model, x)
        torch.cuda.synchronize()
        per_forward = ms_deform_attn.launches
        by_dtype = dict(ms_deform_attn.launches_by_dtype)
    finally:
        deform_attn.ms_deform_attn = wrapper
    check(per_forward == len(calls) == n_layers,
          f"{label} launched msda_forward {per_forward} times for "
          f"{len(calls)} sampling calls, expected {n_layers}")
    # (a) every call, kernel against plain on the inputs it received
    call_units = []
    for value, shapes, loc, attn, out in calls:
        ref = ms_deform_attn_torch(value, shapes, loc, attn).float()
        scale = max(1.0, ref.abs().max().item())
        err = (out.float() - ref).abs().max().item()
        tol = (TOL_F32 if value.dtype == torch.float32
               else TOL_BF16_REL) * scale
        check(out.dtype == value.dtype and math.isfinite(err) and err <= tol,
              f"{label}, MSDA call {len(call_units)} ({value.dtype}): "
              f"kernel vs plain max abs diff {err} > {tol}")
        call_units.append(err / scale / BF16_UNIT)
    del calls
    # (b) the whole forward, kernel against plain MSDA, beside the plain
    # forward against itself with its levels summed in the other order:
    # how far the bf16 model carries one bf16 rounding of an MSDA output
    outs = {}
    for name, fn in (("plain", ms_deform_attn_torch),
                     ("reordered", msda_levels_reversed)):
        deform_attn.ms_deform_attn = fn
        try:
            outs[name] = bench.forward(model, x)
        finally:
            deform_attn.ms_deform_attn = wrapper
    units, rms = {}, {}
    for pair, (a, b) in (("kernel", (got, outs["plain"])),
                         ("reordered", (outs["reordered"], outs["plain"]))):
        for k in ("pred_logits", "pred_kpts2d", "pred_depth"):
            check(bool(torch.isfinite(a[k]).all()),
                  f"{label} ({pair}): non-finite {k}")
            d = a[k].float() - b[k].float()
            scale = max(1.0, b[k].float().abs().max().item()) * BF16_UNIT
            units[f"{pair}/{k}"] = d.abs().max().item() / scale
            rms[f"{pair}/{k}"] = d.pow(2).mean().sqrt().item() / scale
    check(all(rms[f"kernel/{k}"] <= max(TOL_BENCH_RMS_UNITS,
                                        2 * rms[f"reordered/{k}"])
              for k in ("pred_logits", "pred_kpts2d", "pred_depth")),
          f"{label}, kernel vs plain MSDA: rms {rms} bf16 units (max "
          f"{units})")
    return dict(got=got, per_forward=per_forward, by_dtype=by_dtype,
                call_units=call_units, units=units, rms=rms)


def phase_bench(work, card):
    """The bench (``python -m snipper_tpu_torch.bench``) in a fresh process:
    exit 0, one JSON line with no FAIL, ``sampling_overflow`` 0, numbers
    for the four legs and the bound, a ``device`` naming this card, and
    one ``msda_forward`` launch per layer and forward call (one
    ``msda_backward`` per layer and train step), counted in the child.
    Then the bench's canonical_t4 b1 forward (JAX's bf16 recipe: seeded
    weights cast to bf16 once, its own bf16 input), 12 launches a
    forward: (a) each of its MSDA calls, kernel against plain on the
    inputs that call received, within ``TOL_BF16_REL`` of its scale; (b)
    the whole forward with the kernel against it with the plain MSDA,
    each ``pred_*``'s rms difference within twice that of the plain
    forward against itself with its levels summed in the other order (at
    least ``TOL_BENCH_RMS_UNITS``). Then that forward's wall time, kernel
    time, kernel launches and busy share (``breakdown``), beside the
    1738 launches and 0.337 busy share of the bf16-autocast forward that
    the recipe replaced (an H100 at 700 W)."""
    import numpy as np
    import torch

    from snipper_tpu_torch import bench
    from snipper_tpu_torch.config import Config

    log("bench (python -m snipper_tpu_torch.bench):")
    out_json = os.path.join(work, "bench_launches.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--bench-child",
         out_json], capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines,
          f"the bench exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    line = lines[-1]
    log(f"bench line: {line}")
    rec = json.loads(line)
    check("FAIL" not in line, "the bench recorded a FAIL")
    check(rec["sampling_overflow"] == 0,
          f"bench sampling_overflow {rec['sampling_overflow']}")
    dev = rec["device"]
    check(dev.get("platform") == "gpu"
          and f"{dev.get('name')}, {dev.get('power_limit')}" == card
          and dev.get("count") == torch.cuda.device_count(),
          f"the bench's device {dev} does not name the card {card!r}")
    legs = (rec["value"], rec["train_step_ms_T4F2_bf16mp_b2"],
            rec["configs_snippets_per_sec"]["light_t1_b4"],
            rec["fast_snippets_per_sec"]["p2,r480"], rec["analytic_tflop"],
            rec["analytic_hbm_gb"], rec["x_hbm_floor"])
    check(all(isinstance(v, float) and v > 0 for v in legs),
          f"a leg of the bench is not a positive number: {legs}")
    with open(out_json) as f:
        rec_counts = json.load(f)
    launches, graph = rec_counts["launches"], rec_counts["graph"]

    def layers(preset):
        cfg = getattr(Config, preset)()
        return cfg.enc_layers + cfg.dec_layers

    def calls(k):
        return 1 + bench.PASSES * k  # the warm-up, then the passes

    # p2,r480 keeps canonical_t4's layers
    want_fwd = (layers("canonical_t4") * (calls(bench.VALUE_K)
                                          + calls(bench.FAST_K))
                + layers("light_t1") * calls(bench.CONFIG_K))
    # the train leg: two warm steps (eager, capture of the step's CUDA
    # graph), then the passes' replays, which call no wrapper
    want_train = wrapper_steps(2 + bench.PASSES * bench.TRAIN_K, graph)
    want_fwd += layers("canonical_t4_f2") * want_train
    want_bwd = layers("canonical_t4_f2") * want_train
    check(graph == {"captures": 1,
                    "replays": 1 + bench.PASSES * bench.TRAIN_K}
          and launches == {"msda_forward": want_fwd,
                           "msda_backward": want_bwd,
                           "lsa_rows": want_train},
          f"bench launches {launches}, expected {want_fwd} + {want_bwd} + "
          f"{want_train} (one lsa_rows per train step that called the "
          f"wrappers, {graph})")

    # the bench's forward, kernel against plain MSDA
    set_tf32(False)
    cfg = Config.canonical_t4()
    model = bench.bf16_net(cfg, "cuda")
    x = bench.input_batch(np.random.default_rng(0), cfg, 1, "cuda")
    check(x.dtype == torch.bfloat16 and all(
        t.dtype == torch.bfloat16
        for t in (*model.parameters(), *model.buffers())),
        "the bench's forward holds a weight or input that is not bf16")
    held = hold_bench_forward(model, x, layers("canonical_t4"),
                              "the bench's forward")
    per_forward, call_units = held["per_forward"], held["call_units"]
    units, rms = held["units"], held["rms"]
    check(held["by_dtype"] == {"f32": 0, "bf16": per_forward},
          f"the bench's forward launched msda_forward {held['by_dtype']} "
          f"by value dtype")
    del held
    # where the bench's forward spends its time
    bd = breakdown(lambda: bench.forward(model, x))
    del model
    torch.cuda.empty_cache()
    log(f"bench: exit 0 in {seconds:.1f} s, launches {launches}; its "
        f"forward's MSDA calls, kernel vs plain on their inputs, within "
        f"{max(call_units):.3f} bf16 units; the whole forward, kernel vs "
        f"plain, max {json.dumps(units)} and rms {json.dumps(rms)} bf16 "
        f"units (\"reordered\": the plain forward with its levels summed in"
        f" the other order); {per_forward} "
        f"msda_forward launches a forward; one forward (bf16 weights and "
        f"input) {bd['wall_ms']:.2f} ms wall, {bd['device_ms']:.2f} ms of "
        f"{bd['kernel_launches']} kernel launches (the bf16-autocast "
        f"forward it replaced: 1738), busy {bd['busy_share']:.3f} (0.337), "
        f"msda_forward {bd['msda_ms']:.3f} ms; top {bd['top']} ({card})")
    return dict(line=rec, launches=launches, per_forward=per_forward,
                call_units=call_units, units=units, rms=rms,
                seconds=seconds, breakdown=bd)


def phase_multi_gpu(work, card):
    """The multi-GPU paths on one card, which shows them right, not scaling:
    (a) an f32 canonical_t4_f2 step at CUT_DEPTH (two encoder and two
    decoder layers at full width; dropout 0, TF32 off) on two gloo ranks of
    cuda:0, batch 1 each, against the single-process step of batch 2 on the
    same weights (its criterion at ``dp_size`` 2, as the JAX CLI's on that
    mesh): loss within 1e-4 relative, every gradient within 1e-3 of its
    scale, the same matching; (b) the same with the heads cut over the two
    ranks (tp2, the batch of 2 on both, against ``dp_size`` 1; 4 launches
    of each MSDA kernel and one ``lsa_rows`` per rank and step, at 4
    heads); (c) through ``torchrun --standalone --nproc_per_node 1``
    (NCCL): ``cli.train`` for 3 bf16 steps at CUT_DEPTH and its checkpoint,
    then ``cli.infer --data_parallel`` over phase 4's frames, 12 launches
    per snippet, its tracks within TOL_TRACKS of phase 4's; (d)
    ``cli.infer``'s serving function on the two gloo ranks, the same
    tracks, and the decoded outputs of every snippet within TOL_FORWARD of
    one process's serving (the tracks keep only detections; random weights
    may have none); (e) ``probe meshscale``: exit 0, no FAIL. Step times by
    the host clock, the gradient all-reduce by CUDA events, serving rates
    by the CLI's timestamps."""
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
    # serving runs canonical_t4's full depth, the steps CUT_DEPTH
    per_pass = Config.canonical_t4().enc_layers \
        + Config.canonical_t4().dec_layers
    per_step = CUT_DEPTH["enc_layers"] + CUT_DEPTH["dec_layers"]
    # ---- the single-process reference: one f32 step of batch 2 ----------
    set_tf32(False)
    cfg = Config.canonical_t4_f2().replace(dropout=0.0, **CUT_DEPTH)
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
            check(row["launches"] == {"msda_forward": per_step,
                                      "msda_backward": per_step,
                                      "lsa_rows": 1},
                  f"{name} rank {r}: launches {row['launches']} in a step, "
                  f"expected {per_step} of each MSDA kernel and one "
                  f"lsa_rows")
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
            f"dropout 0; {card}): canonical_t4_f2 enc{cfg.enc_layers}/dec"
            f"{cfg.dec_layers} step, batch {per} a "
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
        "3", "--eval_every", "2", "--enc_layers",
        str(CUT_DEPTH["enc_layers"]), "--dec_layers",
        str(CUT_DEPTH["dec_layers"]), "--output_dir",
        os.path.join(work, "torchrun_train"), "--device", "cuda"])
    check("process group: nccl, world 1" in out,
          "torchrun cli.train: no NCCL process group line")
    # a world of 1: the step a CUDA graph, eager, captured, replayed
    called = wrapper_steps(3, tr["graph"])
    check(tr["graph"] == {"captures": 1, "replays": 2}
          and tr["launches"] == {"msda_forward": called * per_step,
                                 "msda_backward": called * per_step,
                                 "lsa_rows": called},
          f"torchrun cli.train launches {tr['launches']} in 3 steps, "
          f"{tr['graph']}")
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

    from snipper_tpu_torch.data import native_ops

    sources = ("msda_forward", "msda_backward", "win2d", "lane_chain", "lsa")
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host_ops = pool.submit(native_ops.have_native)
        built = list(pool.map(
            lambda s: _build.build(f"{s}.cu", f"lib{s}.so"), sources))
        check(host_ops.result(), "the host ops did not build: no C++ "
              "compiler found")
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
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        log(f"phase {name}: {phase_s[name]} s")
        return res

    shapes_res = timed("kernels", phase_kernels)
    bwd_res = timed("backward", phase_backward)
    log("msda per-shape times, ms per call f32 / bf16 value [device time "
        "alone f32 / bf16] (" + card + "): forward "
        + ", ".join(f"{k} {r['ms']:.4f} / {r['bf16_ms']:.4f} "
                    f"[{r['device_ms']:.4f} / {r['bf16_device_ms']:.4f}]"
                    for k, r in shapes_res.items())
        + "; backward "
        + ", ".join(f"{k} {r['f32_ms']:.4f} / {r['bf16_ms']:.4f} "
                    f"[{r['f32_device_ms']:.4f} / {r['bf16_device_ms']:.4f}]"
                    for k, r in bwd_res.items()))
    win_res = timed("windowed_kernels", phase_windowed_kernels)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        # 4. the inference path, with the host warp, then the device warp
        main_res = timed("main_path", phase_main_path, work)
        serve_res = timed("serving_device", phase_serving_device, work,
                          main_res, card)
        # 4a. serving profiles and the exported artifact
        fast_res = timed("fast_export", phase_fast_export, work, card,
                         main_res)
        # 4b. the host ops
        native_res = timed("native_ops", phase_native_ops, card)
        # 5. the training path, then the eval CLI on its checkpoint
        train_res = timed("train", phase_train, work)
        eval_res = timed("eval", phase_eval, work, train_res["checkpoint"])
        # 5f. training learns: the JAX accuracy protocol, then full width
        acc_res = timed("train_accuracy", phase_train_accuracy, work, card)
        # 5a. training and eval from reference-format files
        real_res = timed("train_real", phase_train_real, work, card)
        # 5b. the PoseTrack/COCO harness
        harness_res = timed("harness", phase_harness, work)
        # 5c. a profiled training run, the label dump
        prof_res = timed("profile_labels", phase_profile_labels, work, card,
                         real_res["root"])
        # 5d. the parity runbook
        runbook_res = timed("parity_runbook", phase_parity_runbook, work,
                            card, real_res)
        # 5e. the multi-GPU paths on this card
        mg_res = timed("multi_gpu", phase_multi_gpu, work, card)
    # 6. a train step, kernels against the plain MSDA and matching
    agree_res = timed("train_agreement", phase_train_agreement)
    # 6b. the presets no other phase runs, and deform_dtype="float32"
    presets_res = timed("presets", phase_presets, card)
    # 6a. the assignment kernel, and a train step with no synchronisation
    match_res = timed("matching", phase_matching, card)
    # 8. the probe path
    probe_res = timed("probes", phase_probes)
    # 9. the bench
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as work:
        bench_res = timed("bench", phase_bench, work, card)

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
        "library_ms": enc["library_ms"],
        "library": "embedding_bag(mode='sum') over the value's rows, one "
                   "bag of L*P*4 corner taps per (n, q, h), weights "
                   "corner weight x attention (0 off the map); arguments "
                   "built outside the timed region",
        "at": "inference encoder shape, f32: N=4 Lq=9875 H=8 D=48 L=3 P=4",
        "ptxas": ptxas["msda_forward"],
        "per_snippet_launches": main_res["per_snippet"],
        "device_preprocess_serving_launches":
            serve_res["launches"]["msda_forward"],
        "fast_serving_launches": fast_res["fast_launches"],
        "export_launches": fast_res["export_launches"],
        "export_bf16_launches": fast_res["export_bf16"]["launches"],
        "profiled_train_launches": prof_res["launches"]["msda_forward"],
        "train_launches": train_res["launches"]["msda_forward"],
        "per_train_forward_launches": train_res["per_forward"],
        "eval_launches": eval_res["launches"]["msda_forward"],
        "per_eval_batch_launches": eval_res["per_batch"],
        "train_accuracy_launches": {
            leg: {run: n["msda_forward"]
                  for run, n in acc_res[leg]["launches"].items()}
            for leg in ("tiny", "canonical")},
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
        "probe_forward_launches": probe_res["forward_launches"],
        "probe_train_launches": probe_res["train_launches"][0],
        "probe_split_launches": probe_res["split_launches"],
        "runbook_launches": runbook_res["launches"],
        "bench_launches": bench_res["launches"]["msda_forward"],
        "bench_per_forward_launches": bench_res["per_forward"],
        "presets_launches": {
            name: {"bf16_forward": presets_res["forward"][name][
                       "per_forward"],
                   "f32_train_step": presets_res["train_step"][name][
                       "launches"]["msda_forward"],
                   **({"infer": presets_res["infer"][name]["launches"][
                       "msda_forward"]}
                      if name in presets_res["infer"] else {})}
            for name in PRESET_RUNS},
        "f32_value_launches": {
            "canonical_t4_bf16_forward_deform_float32":
                presets_res["f32_forward"]["launches_by_dtype"][
                    "msda_forward"]["f32"],
            "canonical_t4_f2_cut_bf16_step_deform_float32":
                presets_res["f32_step"]["launches_by_dtype"][
                    "msda_forward"]["f32"]},
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
        "library_ms": benc["f32_library_ms"],
        "library": "the backward of that one embedding_bag call (d_value "
                   "and the per-tap weight gradients, from which d_loc and "
                   "d_attn follow elementwise)",
        "at": "train encoder shape, f32: N=8 Lq=9875 H=8 D=48 L=3 P=4",
        "ptxas": ptxas["msda_backward"],
        "per_train_step_launches": train_res["per_step"],
        "train_accuracy_launches": {
            leg: acc_res[leg]["launches"]["train"]["msda_backward"]
            for leg in ("tiny", "canonical")},
        "profiled_train_launches": prof_res["launches"]["msda_backward"],
        "real_train_launches": real_res["train_launches"]["msda_backward"],
        "real_eval_launches": real_res["eval_launches"]["msda_backward"],
        "dp2_step_launches_per_rank": [
            r["msda_backward"] for r in mg_res["dp2"]["launches"]],
        "tp2_step_launches_per_rank": [
            r["msda_backward"] for r in mg_res["tp2"]["launches"]],
        "torchrun_train_launches":
            mg_res["torchrun"]["train_launches"]["msda_backward"],
        "probe_train_launches": probe_res["train_launches"][1],
        "bench_launches": bench_res["launches"]["msda_backward"],
        "presets_launches": {
            name: {"f32_train_step": presets_res["train_step"][name][
                "launches"]["msda_backward"]}
            for name in PRESET_RUNS},
        "f32_value_launches": {
            "canonical_t4_f2_cut_bf16_step_deform_float32":
                presets_res["f32_step"]["launches_by_dtype"][
                    "msda_backward"]["f32"]},
        "shapes": bwd_res,
    }]
    kernels.append({
        "name": "lsa_rows",
        "route": "cuda",
        "source": "snipper_tpu_torch/ops/csrc/lsa.cu",
        "replaces": "snipper_tpu/matching/matcher.py:103",
        "launches": train_res["launches"]["lsa_rows"],
        "max_abs_err": match_res["max_abs_err"],
        "ms": match_res["ms"],
        "device_ms": match_res["device_ms"],
        "plain_ms": match_res["plain_ms"],
        "bound_ms": match_res["bound_ms"],
        "bound_by": match_res["bound_by"],
        "library_ms": None,
        "library": "null: no PyTorch call solves an assignment; beside it "
                   "the parent's scipy route on the same costs (copy to "
                   "the host, one linear_sum_assignment a problem, copy "
                   "back)",
        "scipy_route_ms": match_res["scipy_ms"],
        "at": f"a canonical_t4_f2 b2 bf16 train step's costs: "
              f"P={match_res['problems']} M={match_res['slots']} "
              f"N={match_res['queries']} f32, "
              f"{match_res['dijkstra_steps']} Dijkstra steps in all",
        "ptxas": ptxas["lsa"],
        "per_train_step_launches": 1,
        "train_eval_batches": train_res["eval_batches"],
        "eval_launches": eval_res["launches"]["lsa_rows"],
        "train_accuracy_launches": {
            leg: {run: n["lsa_rows"]
                  for run, n in acc_res[leg]["launches"].items()}
            for leg in ("tiny", "canonical")},
        "profiled_train_launches": prof_res["launches"]["lsa_rows"],
        "real_train_launches": real_res["train_launches"]["lsa_rows"],
        "real_eval_launches": real_res["eval_launches"]["lsa_rows"],
        "dp2_step_launches_per_rank": [
            r["lsa_rows"] for r in mg_res["dp2"]["launches"]],
        "tp2_step_launches_per_rank": [
            r["lsa_rows"] for r in mg_res["tp2"]["launches"]],
        "torchrun_train_launches":
            mg_res["torchrun"]["train_launches"]["lsa_rows"],
        "probe_train_launches": probe_res["train_launches"][2],
        "bench_launches": bench_res["launches"]["lsa_rows"],
        "sync_checked_step_launches": match_res["step_launches"],
        "presets_launches": {
            name: {"f32_train_step": r["launches"]["lsa_rows"],
                   "problems": r["problems"], "M": r["slots"],
                   "N": r["queries"]}
            for name, r in presets_res["train_step"].items()},
        "deform_float32_step_launches":
            presets_res["f32_step"]["launches"]["lsa_rows"],
    })
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
    preset_ms = {k: round(v["ms"], 3)
                 for k, v in presets_res["forward"].items()}
    log(f"card: {card}; inference path "
        f"{main_res['steady_snippets_per_s']:.3f} snippets/s (host warp), "
        f"{serve_res['steady_snippets_per_s']:.3f} (--device_preprocess), "
        f"{fast_res['fast_steady_snippets_per_s']:.3f} (--fast {FAST_SPEC}); "
        f"bf16 artifact {fast_res['serve']['ratio']:.3f}x live (probe "
        f"serve), {fast_res['export_bf16']['ms']:.2f} ms per call, "
        f"{fast_res['export_bf16']['bytes'] / 1e6:.1f} MB (f32 "
        f"{fast_res['export_ms']:.2f} ms, "
        f"{fast_res['export_bytes'] / 1e6:.1f} MB); "
        f"eval {eval_res['batch_ms']:.2f} ms/batch; harness AP "
        f"{harness_res['posetrack_ap']:g} MOTA "
        f"{harness_res['posetrack_mota']:g}; training "
        f"path period {train_res['period_ms']:.2f} ms/step, "
        f"{train_res['samples_per_s']:.3f} samples/s, peak "
        f"{train_res['peak_gb']:.2f} GB; from PoseTrack18-format files "
        f"{real_res['period_ms']:.2f} ms/step with --device_preprocess, "
        f"{real_res['host_period_ms']:.2f} with the host warp; trained to "
        f"accuracy: tiny 3dpck {acc_res['tiny']['stats']['3dpck']:.4f} in "
        f"{acc_res['tiny']['period_ms']:.2f} ms/update, canonical_t4_f2 "
        f"3dpck {acc_res['canonical']['stats']['3dpck']:.4f} (floor "
        f"{acc_res['canonical']['floor']['3dpck']:.4f}) in "
        f"{acc_res['canonical']['period_ms']:.2f} ms/update, phase "
        f"{acc_res['seconds']:.1f} s; train step "
        f"kernels vs plain: "
        f"gradients within {agree_res['grad_worst_rel']:.3e} of scale; "
        f"lsa_rows {match_res['device_ms']:.4f} ms device time on a step's "
        f"{match_res['problems']} problems (scipy route "
        f"{match_res['scipy_ms']:.4f} ms), the step sync-free; "
        f"probe op windowed2d_pallas {probe_res['op_ms']['windowed2d_pallas']}"
        f" ms/op-call (relerr {probe_res['relerr']:.2e}); host warp "
        f"{native_res['native_ms']:.2f} ms a 1920x1080 frame in C++, "
        f"{native_res['numpy_ms']:.2f} in numpy; host-warp training "
        f"{real_res['numpy_period_ms']:.2f} ms/step with the numpy warp; "
        f"runbook goldens within {runbook_res['worst']:.2e}; multi-GPU on "
        f"one card: dp2 step {mg_res['dp2']['step_ms']} ms with a "
        f"{mg_res['dp2']['allreduce_ms']} ms gradient all-reduce (gloo), "
        f"tp2 step {mg_res['tp2']['step_ms']} ms, two-rank serving "
        f"{mg_res['serve_two_ranks']['snippets_per_s']} snippets/s, "
        f"torchrun cli.infer --data_parallel "
        f"{mg_res['torchrun']['infer_snippets_per_s']:.3f} snippets/s; "
        f"bench value {bench_res['line']['value']} snippets/s, train "
        f"{bench_res['line']['train_step_ms_T4F2_bf16mp_b2']} ms/step; "
        f"presets' bf16 forwards {json.dumps(preset_ms)} ms; deform_dtype "
        f"float32 / auto: canonical_t4 bf16 forward "
        f"{presets_res['f32_forward']['ms']['float32']:.3f} / "
        f"{presets_res['f32_forward']['ms']['auto']:.3f} ms, "
        f"canonical_t4_f2 enc2/dec2 bf16 step "
        f"{presets_res['f32_step']['step_ms']['float32']:.2f} / "
        f"{presets_res['f32_step']['step_ms']['auto']:.2f} ms; "
        f"phases {json.dumps(phase_s)} s; "
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
    if sys.argv[1:2] == ["--bench-child"]:
        sys.exit(bench_child(sys.argv[2]))
    sys.exit(main())
