"""Eval traffic: the program's scoring loop, ``train/engine.py::evaluate``,
in f32 as ``cli.eval`` runs it (forward, criterion with the matching on the
device, readback, ``postprocess``, the 3D metrics), over its
``DataLoader`` in order, the mix's distinct samples cycled. The loader is
wrapped so that it ends when the window closes; a batch counts when it
ended before the close (its postprocess and metrics done).

``correct``: the plain reference runs forward and criterion on each
distinct batch in f32. ``loss_gap``: each loss term's mean over the
window's batches against the reference's mean over the same batches, the
widest gap over the larger of the term and the median term.
``decoded_gap``: every result of the window against the reference's
decoded outputs of its sample (as the serving cells measure it);
``logit_gap``: the class logits of every sample of the window, as the
forward made them, against the reference's.
``matching_mismatch``: the real targets whose matched query differs from
the reference's optimal assignment.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generate, harness
from benchmark.counts import flops as flop_counts
from benchmark.drivers.serve import build_program, decoded_gap, logit_gap
from benchmark.drivers.train import _device_batch
from benchmark.reference import criterion as ref_crit
from benchmark.reference import model as ref_model
from benchmark.reference import postprocess as ref_post
from benchmark.reference.precision import Precision
from benchmark.weights import make_weights


class Until:
    """The loader's batches until ``close`` (host clock); each request's
    time is kept: batch i ended when batch i + 1 was asked for."""

    def __init__(self, loader, ctx, trace_batches):
        self.loader, self.ctx = loader, ctx
        self.trace_batches = trace_batches
        self.close = None
        self.asked = []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            now = time.perf_counter()
            self.asked.append(now)
            self.ctx.trace_tick(len(self.asked) - 1, 1, self.trace_batches)
            if self.close is not None and now >= self.close:
                return
            with self.ctx.span("input_wait"):
                b = next(it, None)
            if b is None:
                return
            yield b


class KeptLogits(torch.nn.Module):
    """The program's model, keeping the class logits of each call as its
    forward made them (on the device; read after the window)."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.logits = []

    def forward(self, *a, **k):
        out = self.model(*a, **k)
        self.logits.append(out["pred_logits"])
        return out


def run(ctx) -> dict:
    from snipper_tpu_torch.data.loader import DataLoader
    from snipper_tpu_torch.losses.criterion import SetCriterion
    from snipper_tpu_torch.train import engine

    mix, c = ctx.mix, ctx.cfg
    B, n = mix["batch"], mix["distinct_samples"]
    weights = make_weights(c, ctx.seed, ctx.device,
                           ctx.cfg_doc["person_logit"])
    cfg, model = build_program(ctx, weights)
    del weights
    ctx.mark("weights")
    samples = generate.samples(c, n, ctx.seed, ctx.device)
    ctx.mark("inputs")
    crit = SetCriterion(cfg)

    def loader(length):
        return DataLoader(generate.SampleSet(samples, length), B,
                          shuffle=False, drop_last=False)

    kept = KeptLogits(model)
    engine.evaluate(kept, crit, loader(2 * B), cfg, ctx.device,
                    collect_results=True)
    kept.logits.clear()
    until = Until(loader(mix["epoch_samples"]), ctx, mix["trace_batches"])
    with harness.spans_around(ctx, [
            (engine, "eval_step", "step", False),
            (engine, "_read_scalars", "read_scalars", False),
            (engine, "postprocess", "postprocess", False)]):
        ctx.setup_done()
        until.close = time.perf_counter() + ctx.seconds
        stats = engine.evaluate(kept, crit, until, cfg, ctx.device,
                                collect_results=True)
        ctx.trace_close(len(until.asked) - 1)
    ctx.window_closed()
    logits = [lg.float().cpu().numpy() for lg in kept.logits]
    del model, kept, crit
    ctx.free()

    asked = np.asarray(until.asked)
    ends = asked[1:len(stats["_batch_seconds"]) + 1]
    inside = ends <= until.close
    batches_in = int(inside.sum())
    traced = ctx.traced_mask(len(ends))
    ctx.data.update(
        rate_untraced=harness.untraced_rate(int((inside & ~traced).sum()),
                                            ctx.seconds, ctx),
        flops_per_unit=flop_counts.model_flops(c, B),
        unit_batch=B, precision=ctx.cfg_doc["precision"]["eval"])
    e2e = {"eval_samples_per_s": batches_in * B / ctx.seconds}

    checks = _check(ctx, samples, stats, logits,
                    len(stats["_batch_seconds"]))
    diag = {"batch_ms": float(np.mean(stats["_batch_seconds"]) * 1e3)}
    return {"attempted": batches_in * B, "failed": 0, "e2e": e2e,
            "checks": checks, "diag": diag}


@torch.no_grad()
def _reference(ctx, samples, P, prec, n_batches):
    """Per distinct batch: its loss terms, decoded results and the optimal
    matching of its real targets."""
    c, B, n = ctx.cfg, ctx.mix["batch"], len(samples)
    distinct = min(n_batches, n // B if n % B == 0 else n)
    out = []
    for j in range(distinct):
        idx = [(j * B + k) % n for k in range(B)]
        batch = _device_batch(samples, idx, ctx.device)
        o = ref_model.forward(P, batch["images"], c, prec)
        total, losses, srcs = ref_crit.criterion(o, batch["targets"], c)
        losses = dict(losses, loss_total=total)
        dec = []
        for b in range(B):
            prob, score, kp, d = ref_post.decode(
                o["pred_logits"][b].cpu().numpy(),
                o["pred_kpts2d"][b].cpu().numpy(),
                o["pred_depth"][b].cpu().numpy(), c["max_depth"],
                (c["input_width"], c["input_height"]))
            dec.append({"human_score": prob, "pred_kpt_scores": score,
                        "pred_kpts": kp, "pred_depth": d,
                        "logits": o["pred_logits"][b].cpu().numpy()})
        out.append({"losses": {k: float(v) for k, v in losses.items()},
                    "decoded": dec, "src": srcs[0]})
    return out


def _check(ctx, samples, stats, logits, n_batches):
    c, B = ctx.cfg, ctx.mix["batch"]
    P = make_weights(c, ctx.seed, ctx.device, ctx.cfg_doc["person_logit"])
    ref = _reference(ctx, samples, P, Precision("float32"), n_batches)
    period = len(ref)
    if ctx.control:
        low = _reference(ctx, samples, P, Precision(ctx.control), n_batches)
        got_losses = {k: np.mean([low[i % period]["losses"][k]
                                  for i in range(n_batches)])
                      for k in low[0]["losses"]}
        got_results = [dict(low[i // B % period]["decoded"][i % B],
                            indices=(low[i // B % period]["src"][i % B],))
                       for i in range(n_batches * B)]
    else:
        got_losses = {k: v for k, v in stats.items()
                      if k.startswith("loss")}
        got_results = [dict(r, logits=logits[i // B][i % B])
                       for i, r in enumerate(stats["_results"])]
    del P
    ctx.free()
    want_losses = {k: np.mean([ref[i % period]["losses"][k]
                               for i in range(n_batches)])
                   for k in ref[0]["losses"]}
    med = float(np.median(np.abs(list(want_losses.values()))))
    if set(got_losses) != set(want_losses):
        loss = float("inf")
    else:
        loss = max(abs(got_losses[k] - w) / max(abs(w), med)
                   for k, w in want_losses.items())
    dgap, lgap, mism = 0.0, 0.0, 0
    if len(got_results) != n_batches * B:
        dgap = lgap = float("inf")
    for i, res in enumerate(got_results):
        r = ref[i // B % period]
        dgap = max(dgap, decoded_gap(res, r["decoded"][i % B], c))
        lgap = max(lgap, logit_gap(res, r["decoded"][i % B]))
        want = np.asarray(r["src"][i % B])
        m = int((want >= 0).sum())
        got = np.asarray(res["indices"][0])[:m]
        mism += int(np.sum(got != want[:m])) + abs(len(got) - m)
    lim = ctx.limits
    return {"loss_gap": {"value": loss, "limit": lim["loss_gap"]},
            "decoded_gap": {"value": dgap, "limit": lim["decoded_gap"]},
            "logit_gap": {"value": lgap, "limit": lim["logit_gap"]},
            "matching_mismatch": {"value": float(mism),
                                  "limit": lim["matching_mismatch"]}}
