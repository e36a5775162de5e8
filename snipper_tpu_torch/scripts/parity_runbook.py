"""One-command accuracy-parity runbook of the port: the counterpart of the
JAX package's ``scripts/parity_runbook.py``.

Given a reference-format PyTorch checkpoint and whatever dataset
directories exist, one run emits what a parity claim needs:

1. **Golden activations.** The checkpoint is read through the serving
   CLIs' loader (``cli/common.py::load_state``), and the port's forward
   runs in f32 (TF32 off) on the JAX runbook's deterministic uint8-derived
   probe snippet. ``--against DIR`` (the ``--output_dir`` of a JAX runbook
   run on the same checkpoint and config) reports the max abs and rel
   difference of each output against that run's
   ``goldens/flax_outputs.npz``, and against its
   ``goldens/reference_outputs.npz`` (the reference code's outputs) where
   present.
2. **Metric tables.** ``snipper_tpu_torch.cli.eval`` runs in a subprocess
   per dataset directory given (MuPoTS via ``--muco_dir``, PoseTrack with
   its harness, COCO, JTA, Panoptic), and each ``eval_stats.json`` goes
   into the report.

Outputs in ``--output_dir``: ``report.json`` and ``report.md`` (the JAX
runbook's keys: ``checkpoint``, ``preset``, ``activation_parity`` with one
``{max_abs, max_rel}`` per output, ``eval_<dataset>``; plus
``reference_parity`` where the JAX run holds the reference's outputs),
and ``goldens/{probe_input,torch_outputs}.npz``.

    python -m snipper_tpu_torch.scripts.parity_runbook \\
        --checkpoint checkpoint0039.pth --preset canonical_t4 \\
        --against JAX_RUNBOOK_OUT --posetrack_dir ... \\
        --posetrack_gt_dir ... --output_dir parity_torch

The JAX runbook's third leg, the reference's own model code on the same
input, needs the reference's source tree, which the repository does not
hold; ``--against`` a JAX run that made it covers that cross-check.
``--device`` is ``cuda`` unless the CPU is asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

from snipper_tpu_torch.cli.common import (add_config_args, build_config,
                                          load_state)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# eval-dataset name -> the cli.eval flag that enables it (the MuPoTS eval
# rides --muco_dir, as in the JAX runbook)
_DATASET_FLAGS = {
    "mupots": "--muco_dir",
    "posetrack": "--posetrack_dir",
    "coco": "--coco_dir",
    "jta": "--jta_dir",
    "panoptic": "--panoptic_dir",
}
OUTPUTS = ("pred_logits", "pred_kpts2d", "pred_depth")


def probe_input(cfg, seed: int = 0) -> np.ndarray:
    """The JAX runbook's deterministic probe snippet: uint8 draws at the
    config's input size, / 255, ``[1, T, H, W, 3]`` f32."""
    rng = np.random.default_rng(seed)
    T, H, W = cfg.num_frames, cfg.input_height, cfg.input_width
    u8 = rng.integers(0, 256, (1, T, H, W, 3), dtype=np.uint8)
    return u8.astype(np.float32) / 255.0


def golden_outputs(model, imgs: np.ndarray, device) -> dict:
    """The runbook's outputs of one f32 forward (TF32 off): the three
    predictions and ``heatmap_<level>``, as numpy."""
    from snipper_tpu_torch.scripts.probe import tf32_off

    with tf32_off(), torch.inference_mode():
        out = model(torch.from_numpy(imgs).to(device))
    arrays = {k: out[k].float().cpu().numpy() for k in OUTPUTS}
    for lvl, hm in enumerate(out["heatmaps"]):
        arrays[f"heatmap_{lvl}"] = hm.float().cpu().numpy()
    return arrays


def output_diffs(got: dict, want) -> dict:
    """Per output of ``got``: max abs and max rel difference to ``want``."""
    diffs = {}
    for k, a in got.items():
        b = want[k]
        denom = np.maximum(np.abs(b), 1e-6)
        diffs[k] = {"max_abs": float(np.abs(a - b).max()),
                    "max_rel": float((np.abs(a - b) / denom).max())}
    return diffs


def _activation_leg(args, parser, cfg, report):
    from snipper_tpu_torch.models.snipper import build_model, resolve_device

    device = resolve_device(args.device)
    goldens = os.path.join(args.output_dir, "goldens")
    os.makedirs(goldens, exist_ok=True)
    ckpt = argparse.Namespace(pretrained_torch=args.checkpoint, resume=None)
    cfg, state = load_state(parser, ckpt, cfg)
    model = build_model(cfg, device=device)
    model.load_state_dict(state)
    imgs = probe_input(cfg)
    arrays = golden_outputs(model, imgs, device)
    np.savez(os.path.join(goldens, "torch_outputs.npz"), **arrays)
    # the reference's layout: [B, T*3, H, W]
    B, T, H, W, _ = imgs.shape
    x = imgs.transpose(0, 1, 4, 2, 3).reshape(B, T * 3, H, W)
    np.savez(os.path.join(goldens, "probe_input.npz"), x=x)
    print(f"torch goldens written to {goldens} ({device})", flush=True)

    if not args.against:
        report["activation_parity"] = "skipped (no --against run)"
        return
    theirs = os.path.join(args.against, "goldens")
    for key, name in (("activation_parity", "flax_outputs.npz"),
                      ("reference_parity", "reference_outputs.npz")):
        path = os.path.join(theirs, name)
        if not os.path.exists(path):
            report[key] = f"skipped (no {path})"
            continue
        with np.load(path) as want:
            report[key] = output_diffs(arrays, want)
        worst = max(d["max_abs"] for d in report[key].values())
        print(f"{key} vs {name}: worst max_abs {worst:.3e} over "
              f"{len(arrays)} outputs", flush=True)


def _cfg_flags(cfg):
    """The resolved config as CLI flags, so that the eval subprocesses run
    the model shape the checkpoint was read with (preset + overrides)."""
    out = []
    for f in dataclasses.fields(type(cfg)):
        v = getattr(cfg, f.name)
        out += [f"--{f.name}", str(v) if not isinstance(v, bool)
                else ("true" if v else "false")]
    return out


def _eval_leg(args, cfg, report):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for name, flag in _DATASET_FLAGS.items():
        d = getattr(args, f"{name}_dir", None)
        if not d:
            continue
        out_dir = os.path.join(args.output_dir, f"eval_{name}")
        cmd = [sys.executable, "-m", "snipper_tpu_torch.cli.eval",
               "--pretrained_torch", args.checkpoint, *_cfg_flags(cfg),
               flag, d, "--output_dir", out_dir, "--device", args.device]
        if name == "posetrack":
            cmd += ["--write_posetrack"]
            if args.posetrack_gt_dir:
                cmd += ["--posetrack_gt_dir", args.posetrack_gt_dir]
        if name == "coco" and args.coco_gt_json:
            cmd += ["--coco_gt_json", args.coco_gt_json]
        if name == "panoptic":
            cmd += ["--panoptic_protocol", str(args.panoptic_protocol)]
        print(f"[{name}] {' '.join(cmd)}", flush=True)
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=args.eval_timeout, env=env)
        stats_path = os.path.join(out_dir, "eval_stats.json")
        if proc.returncode == 0 and os.path.exists(stats_path):
            with open(stats_path) as f:
                report[f"eval_{name}"] = json.load(f)
            print(f"[{name}] OK", flush=True)
        else:
            report[f"eval_{name}"] = {"error": proc.stderr[-2000:]}
            print(f"[{name}] FAILED: {proc.stderr[-800:]}", flush=True)


def _write_report(args, report):
    with open(os.path.join(args.output_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2, default=str)
    lines = ["# Parity runbook report (snipper_tpu_torch)", "",
             f"checkpoint: `{args.checkpoint}`  preset: `{args.preset}`  "
             f"device: `{args.device}`", ""]
    for key, title in (("activation_parity", "torch vs the JAX runbook's "
                        "flax outputs"),
                       ("reference_parity", "torch vs the reference "
                        "code's outputs")):
        if key not in report:
            continue
        ap = report[key]
        lines += [f"## Activation parity ({title})", ""]
        if isinstance(ap, dict):
            lines += ["| output | max abs diff | max rel diff |",
                      "|---|---|---|"]
            for k, d in ap.items():
                lines.append(f"| {k} | {d['max_abs']:.3e} | "
                             f"{d['max_rel']:.3e} |")
        else:
            lines.append(f"{ap}")
        lines.append("")
    for key, val in report.items():
        if not key.startswith("eval_"):
            continue
        lines += [f"## {key}", ""]
        if "error" in val:
            lines += [f"FAILED: {val['error'][:500]}", ""]
            continue
        lines += ["| metric | value |", "|---|---|"]
        for k, v in sorted(val.items()):
            if isinstance(v, (int, float)):
                lines.append(f"| {k} | {v:.4f} |")
        lines.append("")
    path = os.path.join(args.output_dir, "report.md")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print(f"report written to {path}", flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("snipper_tpu_torch parity runbook")
    p.add_argument("--checkpoint", required=True,
                   help="reference-format .pth ({'model': state_dict}) or "
                        "a bare state-dict .pth")
    p.add_argument("--preset", default="canonical_t4")
    p.add_argument("--output_dir", default="./parity_out")
    add_config_args(p)  # every Config field, as in the CLIs
    p.add_argument("--against", default=None,
                   help="a JAX runbook's --output_dir: compare with its "
                        "goldens/flax_outputs.npz (and "
                        "reference_outputs.npz where present)")
    for name in _DATASET_FLAGS:
        p.add_argument(f"--{name}_dir", type=str, default=None)
    p.add_argument("--posetrack_gt_dir", type=str, default=None)
    p.add_argument("--coco_gt_json", type=str, default=None)
    p.add_argument("--panoptic_protocol", type=int, default=1)
    p.add_argument("--eval_timeout", type=int, default=24 * 3600)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = build_config(args)
    os.makedirs(args.output_dir, exist_ok=True)
    report = {"checkpoint": args.checkpoint, "preset": args.preset}
    _activation_leg(args, parser, cfg, report)
    _eval_leg(args, cfg, report)
    _write_report(args, report)
    return report


if __name__ == "__main__":
    main()
