"""Serving traffic: videos served one after another through the program's
serving loop, as a user runs ``cli.infer`` per video.

Each video is a directory of JPEG frames. For each, the loop calls
``cli/infer.py::serve_snippets`` (decode and warp in its prefetch thread,
or decode alone and the warp on the device; the forward; the readback;
``decode_predictions``) and then ``associate_snippets``. The window is
closed loop: the next video starts when the last one is associated; a
video running when the window closes runs to its end, and only snippets
decoded before the close count. The counts and times come from what
``serve_snippets`` returns (``done_at``, ``forward_ms``, ``wait_ms``,
``results``) and from the benchmark's own forward callable; only a traced
run wraps the program's functions, for the spans that label idle gaps.

``correct``: a sample of the window's snippets, drawn from the seed, is
decoded from its JPEG files, warped and run through the plain reference
(``reference/``) in f32 and decoded; ``decoded_gap`` is the widest gap
between the program's and the reference's decoded results (probabilities
and scores as they are, keypoints over the input size, depths over
``max_depth``). ``logit_gap`` is the widest gap between the class logits
that the window's forward produced for those snippets and the
reference's: the human probability saturates where the class bias is
large, its logit does not. ``tracks_mismatch`` counts the entries of
every video's tracks that differ from the reference association of the
program's own decoded results (0: equal, bit for bit).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import generate, harness, tracing
from benchmark.counts import flops as flop_counts
from benchmark.reference import model as ref_model
from benchmark.reference import postprocess as ref_post
from benchmark.reference.precision import Precision
from benchmark.weights import make_weights


def build_program(ctx, weights):
    from snipper_tpu_torch.config import Config
    from snipper_tpu_torch.models.snipper import Snipper

    cfg = Config(**ctx.cfg).validate()
    with torch.device("meta"):
        model = Snipper(cfg)
    model.to_empty(device=ctx.device)
    model.load_state_dict(weights)
    return cfg, model.eval()


def run(ctx) -> dict:
    from snipper_tpu_torch.cli import infer as cli_infer

    mix, c = ctx.mix, ctx.cfg
    gap, dev_warp = mix["seq_gap"], mix["device_preprocess"]
    weights = make_weights(c, ctx.seed, ctx.device,
                           ctx.cfg_doc["person_logit"])
    cfg, model = build_program(ctx, weights)
    del weights
    ctx.mark("weights")

    lo, hi = mix["snippets_per_video"]
    lengths = list(range(lo, hi + 1))
    library = generate.video_library(
        str(ctx.cache / "inputs"), mix["pool_frames"], mix["frame_width"],
        mix["frame_height"], sorted(set(lengths + [2])), c["num_frames"], gap,
        ctx.device)
    rounds = 1 + int(ctx.seconds * mix["max_snippets_per_s"]
                     / sum(lengths))
    plan = generate.video_plan(lo, hi, rounds, ctx.seed)
    ctx.mark("inputs")
    return _serve(ctx, cli_infer, cfg, model, library, plan, gap, dev_warp)


def _serve(ctx, cli_infer, cfg, model, library, plan, gap, dev_warp):
    mix, c = ctx.mix, ctx.cfg
    n_trace = mix["trace_snippets"]
    calls = []      # the window's forward calls: snippet groups started
    kept = []       # this video's class logits, as the forward made them

    def forward(imgs):
        if window_open:
            ctx.trace_tick(len(calls), 2, n_trace)
            calls.append(None)
        with ctx.span("forward"):
            out = model(imgs)
        kept.append(out["pred_logits"])
        return out

    def serve(vdir):
        kept.clear()
        out = cli_infer.serve_snippets(forward, cfg, vdir, gap, ctx.device,
                                       mix["snippet_batch"], dev_warp)
        t_back = time.perf_counter()
        with ctx.span("associate"):
            tracks = cli_infer.associate_snippets(
                out["results"], *out["index"], cfg.num_frames, gap,
                cfg.max_depth)
        out["associate_ms"] = (time.perf_counter() - t_back) * 1e3
        return out, tracks, list(kept), t_back

    window_open = False
    with harness.spans_around(ctx, [
            (cli_infer, "prefetched", "input_wait", True),
            (cli_infer, "to_device", "upload_warp", False),
            (cli_infer, "decode_predictions", "decode", False)]):
        serve(library[2])
        # an untraced run records the device's activity over the whole
        # window: the card time of every snippet it serves
        busy = tracing.DeviceBusy() if not ctx.trace \
            and ctx.device.type == "cuda" else None
        if busy is not None:
            busy.start()
        ctx.setup_done()
        window_open = True
        served = []
        t_open = time.perf_counter()
        close = t_open + ctx.seconds
        v = 0
        while time.perf_counter() < close:
            vdir = library[plan[v % len(plan)]]
            served.append((vdir,) + serve(vdir))
            v += 1
        window_open = False
        ctx.trace_close(len(calls))
    ctx.window_closed()
    card = busy.stop() if busy is not None else None
    del model
    ctx.free()

    # ---- the window's numbers ---------------------------------------------
    # per group of snippets (one forward call): its decoding ended when
    # the loop asked for the next group (that group's outputs on the host,
    # less its forward and its wait), the video's last when serve_snippets
    # returned
    waits, fwds, ends, sizes = [], [], [], []
    for _, o, _, _, t_back in served:
        w, f = np.asarray(o["wait_ms"]), np.asarray(o["forward_ms"])
        asked = np.asarray(o["done_at"]) - (w + f) / 1e3
        waits.append(w)
        fwds.append(f)
        ends.append(np.append(asked[1:], t_back))
        n, g = len(o["results"]), mix["snippet_batch"]
        sizes.append([min(g, n - k) for k in range(0, n, g)])
    waits, fwds, ends, sizes = map(np.concatenate,
                                   (waits, fwds, ends, sizes))
    done_at = np.concatenate([o["done_at"] for _, o, _, _, _ in served])
    inside = ends <= close
    untraced_in = inside & ~ctx.traced_mask(len(ends))
    n_in = int(sizes[inside].sum())
    ctx.data.update(
        wait_ms=waits[untraced_in].tolist(),
        forward_ms=fwds[untraced_in].tolist(),
        rate_untraced=harness.untraced_rate(int(sizes[untraced_in].sum()),
                                            ctx.seconds, ctx),
        flops_per_unit=flop_counts.model_flops(c, 1),
        unit_batch=1, precision=ctx.cfg_doc["precision"])
    # the card's busy time over every snippet of the window's videos (the
    # last one's included: it ran to its end under the same recording)
    n_all = sum(len(o["results"]) for _, o, _, _, _ in served)
    e2e = {"serve_device_ms_per_snippet":
           card and 1e3 * card["busy_s"] / n_all}

    persons = [int(np.sum(np.asarray(r["human_score"]).max(1) > 0.5))
               for _, o, _, _, _ in served for r in o["results"]]
    diag = {"snippets_per_s": n_in / ctx.seconds,
            "card": card, "wait_ms": float(np.mean(waits)),
            "forward_ms": float(np.mean(fwds)),
            "decode_ms": float(np.mean(ends - done_at) * 1e3),
            "associate_ms_per_video": float(np.mean(
                [o["associate_ms"] for _, o, _, _, _ in served])),
            "wait_ms_quartiles": np.percentile(waits, [25, 50, 75]).tolist(),
            "forward_ms_quartiles": np.percentile(fwds, [25, 50, 75]).tolist(),
            # snippets decoded in each fifth of the window: a stall shows
            # as one fifth short
            "snippets_by_fifth": np.bincount(
                np.minimum(((ends[inside] - t_open) / ctx.seconds * 5)
                           .astype(int), 4), weights=sizes[inside],
                minlength=5).tolist(),
            "videos": len(served), "persons_per_snippet": float(
                np.mean(persons)),
            "frame_kb": float(np.mean([
                os.path.getsize(os.path.join(library[2], f)) for f in
                os.listdir(library[2])]) / 1024)}

    # ---- correct ------------------------------------------------------------
    checks = _check(ctx, served, np.repeat(inside, sizes), gap)
    return {"attempted": n_in, "failed": 0, "e2e": e2e, "checks": checks,
            "diag": diag}


def _snippet_table(served):
    """(video dir, position in its video, the program's decoded result,
    its class logits) of every snippet served, in order."""
    rows = []
    for vdir, out, _, kept, _ in served:
        logits = torch.cat(kept)   # a padded tail's rows come last
        rows += [(vdir, k, res, logits[k])
                 for k, res in enumerate(out["results"])]
    return rows


def _starts(vdir, c, gap):
    """The reference's own snippet starts of a video directory."""
    return ref_post.snippet_starts(len(os.listdir(vdir)), c["num_frames"],
                                   gap)


def _check(ctx, served, inside, gap):
    c, mix = ctx.cfg, ctx.mix
    rows = _snippet_table(served)
    pick = np.random.default_rng(ctx.seed + 1).choice(
        np.flatnonzero(inside), size=min(mix["check_snippets"],
                                         int(inside.sum())), replace=False)
    P = make_weights(c, ctx.seed, ctx.device, ctx.cfg_doc["person_logit"])
    ref = _reference_decoded(ctx, P, [rows[i] for i in pick],
                             Precision("float32"))
    if ctx.control:
        got = _reference_decoded(ctx, P, [rows[i] for i in pick],
                                 Precision(ctx.control))
    else:
        got = [dict(rows[i][2], logits=rows[i][3].float().cpu().numpy())
               for i in pick]
    del P
    ctx.free()
    gap_v = max((decoded_gap(g, r, c) for g, r in zip(got, ref)),
                default=float("inf"))
    logit_v = max((logit_gap(g, r) for g, r in zip(got, ref)),
                  default=float("inf"))
    mismatch = 0
    for vdir, out, tracks, _, _ in served:
        starts = _starts(vdir, c, gap)
        mismatch += abs(len(starts) - len(out["results"]))
        want = ref_post.associate(out["results"], starts, c["num_frames"],
                                  gap, c["max_depth"])
        mismatch += ref_post.tracks_mismatch(tracks, want)
    lim = ctx.limits
    return {"decoded_gap": {"value": gap_v, "limit": lim["decoded_gap"]},
            "logit_gap": {"value": logit_v, "limit": lim["logit_gap"]},
            "tracks_mismatch": {"value": float(mismatch),
                                "limit": lim["tracks_mismatch"]}}


@torch.no_grad()
def _reference_decoded(ctx, P, rows, prec):
    """The reference's decoded result of each ``(video dir, position,
    _)``: its frames read, warped and run through the reference."""
    from PIL import Image

    c = ctx.cfg
    h, w = c["input_height"], c["input_width"]
    out = []
    for vdir, k, _, _ in rows:
        start = _starts(vdir, c, ctx.mix["seq_gap"])[k]
        frames = []
        for t in range(c["num_frames"]):
            path = os.path.join(vdir, f"{start + t * ctx.mix['seq_gap']:06d}"
                                ".jpg")
            img = np.asarray(Image.open(path).convert("RGB"))
            frames.append(ref_post.warp(img, h, w))
        x = torch.from_numpy(np.stack(frames))[None].to(ctx.device)
        o = ref_model.forward(P, x, c, prec)
        prob, score, kp, d = ref_post.decode(
            o["pred_logits"][0].cpu().numpy(),
            o["pred_kpts2d"][0].cpu().numpy(),
            o["pred_depth"][0].cpu().numpy(), c["max_depth"], (w, h))
        out.append({"human_score": prob, "pred_kpt_scores": score,
                    "pred_kpts": kp, "pred_depth": d,
                    "logits": o["pred_logits"][0].cpu().numpy()})
    return out


def logit_gap(got: dict, want: dict) -> float:
    """The widest gap between two snippets' class logits: the class head's
    output before the softmax, which at a saturated human probability
    still shows what the probability no longer can."""
    return float(np.max(np.abs(np.asarray(got["logits"], np.float64)
                               - np.asarray(want["logits"], np.float64))))


def decoded_gap(got: dict, want: dict, c: dict) -> float:
    """The widest gap between two decoded results, each field on its own
    scale."""
    scale = {"human_score": 1.0, "pred_kpt_scores": 1.0,
             "pred_kpts": float(max(c["input_width"], c["input_height"])),
             "pred_depth": float(c["max_depth"])}
    return max(float(np.max(np.abs(np.asarray(got[k], np.float64)
                                   - np.asarray(want[k], np.float64)))) / s
               for k, s in scale.items())
