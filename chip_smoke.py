#!/usr/bin/env python3
"""Smoke run of the PyTorch port (snipper_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from this checkout's sources (nvcc, one process
   per source, all started together).
3. Hold each kernel against its plain PyTorch version on the card, TF32
   off, at a tiny shape with off-map locations and at the shapes the main
   paths give it (``msda_forward`` at the inference and the train shapes,
   ``msda_backward`` against the plain VJP at the train shapes), f32 and
   bf16 value; time both with CUDA events beside the kernel's bound.
4. Drive the inference path: ``snipper_tpu_torch.cli.infer`` on
   canonical_t4 (full width and depth, 600x800, seeded random weights with
   perturbed sampling projections) over synthetic JPEG frames. Kernel
   launch counts are set to 0 just before and read just after. Then check
   the output: finite, expected shapes, and the same forward with the
   plain MSDA (and the tiny model on the CPU) agreeing within the stated
   tolerances.
5. Drive the training path: ``snipper_tpu_torch.cli.train`` on
   canonical_t4_f2 (full width and depth), batch 2, bf16 mixed precision,
   a few steps over the synthetic dataset, then its checkpoint and its
   evaluation; counts set to 0 just before and read just after. Check the
   launches per step, the checkpoint and finite losses.
6. Hold one f32 train step (dropout 0) with the kernels against the same
   step with the plain MSDA forward and VJP on the card, TF32 off.
7. Print one JSON line of kernel numbers, then the card's name and power
   limit, then, as the last line, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import pickle
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


def phase_kernels():
    """msda_forward vs plain version at the tiny, inference encoder and
    decoder, and train encoder and decoder shapes."""
    import torch

    from snipper_tpu_torch.ops.msda import ms_deform_attn_torch, msda_forward

    canonical = CANONICAL
    cases = [
        # name, N, shapes, H, D, Lq, P, grid queries
        ("tiny", 2, [(6, 9), (3, 5), (2, 2)], 4, 8, 37, 3, False),
        ("encoder", 4, canonical, 8, 48, 9875, 4, True),
        ("decoder", 4, canonical, 8, 48, 60, 4, False),
    ] + TRAIN_CASES
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
        bound, by, nbytes, ops = msda_bound_ms(value, shapes, loc, attn)
        bound_b = msda_bound_ms(vb, shapes, loc, attn)[0]
        res[name] = dict(N=N, Lq=Lq, H=H, D=D, L=len(shapes), P=P,
                         max_abs_err=err, tol=tol, bf16_max_abs_err=err_b,
                         bf16_tol=tol_b, ms=ms, plain_ms=plain_ms,
                         bf16_ms=ms_b, bound_ms=bound, bound_by=by,
                         bf16_bound_ms=bound_b, bytes=nbytes, ops=ops)
        log(f"msda_forward {name}: N={N} Lq={Lq} H={H} D={D} L={len(shapes)}"
            f" P={P}: f32 max|diff| {err:.3e} (tol {tol:g}), bf16 max|diff|"
            f" {err_b:.3e} (tol {tol_b:.3g}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bf16 kernel {ms_b:.4f} ms; bound "
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
    """msda_backward vs the plain VJP at the tiny and the train shapes, f32
    and bf16 value; times of the kernel and of the plain backward (autograd
    through grid_sample, its graph built once)."""
    import torch

    from snipper_tpu_torch.ops.msda import (ms_deform_attn_torch,
                                            ms_deform_attn_torch_vjp,
                                            msda_backward)

    cases = [("tiny", 2, [(6, 9), (3, 5), (2, 2)], 4, 8, 37, 3, False)] \
        + TRAIN_CASES
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
                + f"; kernel {row[f'{tag}_ms']:.4f} ms, plain backward "
                f"{row[f'{tag}_plain_ms']:.4f} ms; bound {bound * 1e3:.2f}"
                f" us by {by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} "
                f"GFLOP); no single PyTorch call computes the MSDA VJP "
                f"(library_ms null)")
            del got, want
        res[name] = row
        del value, loc, attn, grad_out
    torch.cuda.empty_cache()
    return res


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


def breakdown(fn, top=8, reps=5):
    """Device time of one call of ``fn`` by kernel (torch.profiler), its
    wall time (CUDA events, median of ``reps``) and the device's busy
    share of that wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    wall_ms = time_ms(fn, reps=reps, warmup=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side kernels only: the host ops that launch them carry the
    # same time again, and so do user-annotated ranges on the device
    # (AdamW's "Optimizer.step") over kernels that are counted already
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.self_device_time_total > 0]
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
                msda_backward_ms=msda_us["msda_backward"], top=rows)


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
    step_ms = statistics.median(h["seconds"] for h in hist[2:]) * 1e3
    log(f"training path: canonical_t4_f2 600x800 enc6/dec6 batch 2 bf16 "
        f"mixed precision, {steps} steps + {n_eval} eval batches; "
        f"msda_forward {launches['msda_forward']} launches ({per_forward:g}"
        f" per step and per eval batch), msda_backward "
        f"{launches['msda_backward']} ({per_step:g} per step); steady-state "
        f"step {step_ms:.2f} ms "
        f"(median, first two steps excluded), {2e3 / step_ms:.3f} samples/s;"
        f" peak device memory {peak_gb:.2f} GB; losses "
        f"{[round(x, 4) for x in losses]}; checkpoint "
        f"{os.path.basename(res['checkpoint'])}; eval "
        f"test_loss_total {logged['test_loss_total']:.4f} "
        f"(cuDNN TF32 on, matmul TF32 off)")
    return dict(steps=steps, eval_batches=n_eval, launches=launches,
                per_step=per_step, per_forward=per_forward, step_ms=step_ms,
                samples_per_s=2e3 / step_ms, peak_gb=peak_gb, losses=losses,
                step_seconds=[h["seconds"] for h in hist])


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
    bd = breakdown(lambda: train_step(state, crit, batch, gen), top=10)
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

    sources = ("msda_forward", "msda_backward")
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(
            lambda s: _build.build(f"{s}.cu", f"lib{s}.so"), sources))
    for b in built:
        log(f"built {b['path'].name} in {b['seconds']:.2f} s")
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    # 3. kernels against their plain versions
    shapes_res = phase_kernels()
    bwd_res = phase_backward()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        # 4. the inference path
        main_res = phase_main_path(work)
        # 5. the training path
        train_res = phase_train(work)
    # 6. a train step, kernels against the plain MSDA
    agree_res = phase_train_agreement()

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
        "at": "inference encoder shape, f32: N=4 Lq=9875 H=8 D=48 L=3 P=4",
        "per_snippet_launches": main_res["per_snippet"],
        "train_launches": train_res["launches"]["msda_forward"],
        "per_train_forward_launches": train_res["per_forward"],
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
        "at": "train encoder shape, f32: N=8 Lq=9875 H=8 D=48 L=3 P=4",
        "per_train_step_launches": train_res["per_step"],
        "shapes": bwd_res,
    }]
    log(f"card: {card}; inference path "
        f"{main_res['steady_snippets_per_s']:.3f} snippets/s; training "
        f"path {train_res['step_ms']:.2f} ms/step, "
        f"{train_res['samples_per_s']:.3f} samples/s, peak "
        f"{train_res['peak_gb']:.2f} GB; train step kernels vs plain: "
        f"gradients within {agree_res['grad_worst_rel']:.3e} of scale; "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
