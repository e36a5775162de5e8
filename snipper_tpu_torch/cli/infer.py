"""Video inference entry point (counterpart of ``snipper_tpu/cli/infer.py``):
snippet-wise forward over a frame directory and cross-snippet association,
written to ``{output_dir}/tracks.pkl``.

    python -m snipper_tpu_torch.cli.infer --preset canonical_t4 \\
        --data_dir FRAMES --output_dir OUT [--pretrained_torch CKPT.pth]

Runs on the GPU unless ``--device cpu`` is given. The forward runs in f32
under ``torch.inference_mode()``.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from snipper_tpu_torch.cli.common import add_config_args, build_config
from snipper_tpu_torch.infer.pipeline import (associate_snippets,
                                              iter_snippet_samples,
                                              prefetched, snippet_index)
from snipper_tpu_torch.infer.postprocess import decode_predictions
from snipper_tpu_torch.models.snipper import build_model, resolve_device

# flags of the JAX CLI that this port does not have yet
NOT_PORTED = ("fast", "data_parallel", "device_preprocess", "save_visuals",
              "vis_heatmap_frame_name")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("snipper_tpu_torch inference")
    add_config_args(parser)
    parser.add_argument("--data_dir", type=str, default=None,
                        help="directory of video frames")
    parser.add_argument("--video", type=str, default=None,
                        help="video file; frames are extracted to "
                             "{output_dir}/frames first")
    parser.add_argument("--output_dir", type=str, default="./demo_out")
    parser.add_argument("--resume", type=str, default=None,
                        help="a checkpoint of this port's trainer "
                             "(its 'params' are loaded)")
    parser.add_argument("--pretrained_torch", type=str, default=None,
                        help="a checkpoint of the original Snipper repo")
    parser.add_argument("--seq_gap", type=int, default=5)
    parser.add_argument("--snippet_batch", type=int, default=1,
                        help="snippets per forward call")
    parser.add_argument("--preset", type=str, default="canonical_t4")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    for name in NOT_PORTED:
        parser.add_argument(f"--{name}", nargs="?", const=True, default=None,
                            help="not yet ported (refused)")
    return parser


def main(argv=None) -> dict:
    """Run inference; returns ``{"snippets", "seconds", "done_at",
    "forward_ms", "wait_ms"}``: the snippet count, the wall time, the
    host-clock time each group of snippets finished (outputs on the host),
    each group's forward time including the copy of its outputs to the
    host, and the time each group waited for its decoded, warped frames."""
    parser = build_parser()
    args = parser.parse_args(argv)
    refused = [f"--{n}" for n in NOT_PORTED if getattr(args, n) is not None]
    if refused:
        parser.error(f"{', '.join(refused)}: not yet ported to "
                     f"snipper_tpu_torch")
    if args.snippet_batch < 1:
        parser.error("--snippet_batch must be >= 1")
    if bool(args.data_dir) == bool(args.video):
        parser.error("exactly one of --data_dir / --video is required")
    device = resolve_device(args.device)
    cfg = build_config(args)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.video:
        from snipper_tpu_torch.infer.pipeline import extract_video_frames

        args.data_dir = os.path.join(args.output_dir, "frames")
        n = extract_video_frames(args.video, args.data_dir)
        print(f"extracted {n} frames from {args.video} -> {args.data_dir}",
              flush=True)

    model = build_model(cfg, device=device, seed=0)
    if args.pretrained_torch:
        from snipper_tpu_torch.convert import load_reference_checkpoint

        model.load_state_dict(
            load_reference_checkpoint(args.pretrained_torch, cfg))
    elif args.resume:
        from snipper_tpu_torch.train.checkpoint import load_checkpoint

        # the trainer's checkpoint, as the JAX CLI reads its "params"
        model.load_state_dict(load_checkpoint(args.resume)["params"])

    frame_indices, all_files = snippet_index(args.data_dir, cfg.num_frames,
                                             args.seq_gap)
    # lazy decode + warp in a background thread, overlapping the forward
    sample_iter = prefetched(iter_snippet_samples(
        args.data_dir, cfg.num_frames, args.seq_gap, cfg.input_shape,
        index=(frame_indices, all_files)), depth=2)
    print(f"{len(frame_indices)} snippets over {len(all_files)} frames on "
          f"{device}", flush=True)

    w, h = float(cfg.input_width), float(cfg.input_height)
    gsz = args.snippet_batch
    results, done_at, forward_ms, wait_ms = [], [], [], []
    t_start = time.perf_counter()
    done = False
    while not done:
        group = []
        t_wait = time.perf_counter()
        for s in sample_iter:
            group.append(s)
            if len(group) == gsz:
                break
        else:
            done = True
        if not group:
            break
        imgs = np.stack([s["imgs"] for s in group])
        if imgs.shape[0] < gsz:  # pad the tail; padded outputs dropped
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[-1:], gsz - imgs.shape[0], 0)], 0)
        t0 = time.perf_counter()
        wait_ms.append((t0 - t_wait) * 1e3)
        with torch.inference_mode():
            out = model(torch.from_numpy(imgs).to(device))
            logits = out["pred_logits"].cpu().numpy()
            kpts = out["pred_kpts2d"].cpu().numpy()
            depth = out["pred_depth"].cpu().numpy()
        t1 = time.perf_counter()
        forward_ms.append((t1 - t0) * 1e3)
        done_at.append(t1)
        for b, s in enumerate(group):
            prob, score, k2, d = decode_predictions(
                logits[b], kpts[b], depth[b], cfg.max_depth, (w, h))
            results.append({
                "human_score": prob,
                "pred_kpt_scores": score,
                "pred_kpts": k2,
                "pred_depth": d,
                "inv_trans": s["inv_trans"],
                "img_size": s["img_size"],
                "filenames": s["filenames"],
            })
    seconds = time.perf_counter() - t_start

    frames, max_pid = associate_snippets(
        results, frame_indices, all_files, cfg.num_frames, args.seq_gap,
        cfg.max_depth)
    print(f"tracked {max_pid} identities over {len(frames)} frames; "
          f"{len(results)} snippets in {seconds:.3f} s", flush=True)
    with open(os.path.join(args.output_dir, "tracks.pkl"), "wb") as f:
        pickle.dump({"frames": frames, "max_pid": max_pid}, f)
    print(f"results written to {args.output_dir}", flush=True)
    return {"snippets": len(results), "seconds": seconds, "done_at": done_at,
            "forward_ms": forward_ms, "wait_ms": wait_ms}


if __name__ == "__main__":
    main()
