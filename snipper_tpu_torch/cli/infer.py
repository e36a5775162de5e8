"""Video inference entry point (counterpart of ``snipper_tpu/cli/infer.py``):
snippet-wise forward over a frame directory and cross-snippet association,
written to ``{output_dir}/tracks.pkl``, and with ``--save_visuals`` the
demo renders of ``infer/visualize.py``.

    python -m snipper_tpu_torch.cli.infer --preset canonical_t4 \\
        --data_dir FRAMES --output_dir OUT [--pretrained_torch CKPT.pth] \\
        [--device_preprocess] [--save_visuals] [--fast enc4,p2,r480]

Runs on the GPU unless ``--device cpu`` is given. The forward runs in f32
under ``torch.inference_mode()``. With ``--device_preprocess`` the host
only decodes: the uint8 frames are pinned in the prefetch thread, copied
without blocking and warped where the forward runs
(``data/device_preprocess.py``). ``--save_visuals`` needs matplotlib.
``--fast`` serves a profile (``infer/fast.py``): the checkpoint is read
under the preset's config and mapped to the profile's.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from snipper_tpu_torch.cli.common import (add_config_args, build_config,
                                          load_state)
from snipper_tpu_torch.data.device_preprocess import \
    preprocess_snippet_device
from snipper_tpu_torch.infer.fast import PROFILE_HELP
from snipper_tpu_torch.infer.pipeline import (associate_snippets,
                                              iter_snippet_samples,
                                              prefetched, snippet_index)
from snipper_tpu_torch.infer.postprocess import decode_predictions
from snipper_tpu_torch.models.snipper import build_model, resolve_device

# flags of the JAX CLI that this port does not have yet
NOT_PORTED = ("data_parallel",)


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
    parser.add_argument("--save_visuals", action="store_true")
    parser.add_argument("--vis_heatmap_frame_name", type=str, default=None,
                        help="render the heatmap overlay for THIS frame "
                             "(filename, e.g. 000012.jpg) instead of the "
                             "first snippet; errors if the frame is not "
                             "part of any predicted snippet")
    parser.add_argument("--device_preprocess", action="store_true",
                        help="warp/normalize frames on the device; the "
                             "host only decodes")
    parser.add_argument("--snippet_batch", type=int, default=1,
                        help="snippets per forward call")
    parser.add_argument("--preset", type=str, default="canonical_t4")
    parser.add_argument("--fast", type=str, default=None, help=PROFILE_HELP)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    for name in NOT_PORTED:
        parser.add_argument(f"--{name}", nargs="?", const=True, default=None,
                            help="not yet ported (refused)")
    return parser


def pinned(samples):
    """Pin each sample's uint8 frames (``raw_pinned``), so that the copy to
    the card does not block; run inside the prefetch thread."""
    for s in samples:
        yield dict(s, raw_pinned=torch.from_numpy(s["raw_imgs"]).pin_memory())


def main(argv=None) -> dict:
    """Run inference; returns ``{"snippets", "seconds", "done_at",
    "forward_ms", "wait_ms"}``: the snippet count, the wall time, the
    host-clock time each group of snippets finished (outputs on the host),
    each group's forward time including the copy of its inputs to the
    device (and, with ``--device_preprocess``, the warp) and of its outputs
    to the host, and the time each group waited for its decoded (and, on
    the host path, warped) frames."""
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
    if args.vis_heatmap_frame_name and not args.save_visuals:
        parser.error("--vis_heatmap_frame_name requires --save_visuals")
    device = resolve_device(args.device)
    # the checkpoint is read under the preset's config, then mapped to the
    # --fast profile's
    cfg, state = load_state(parser, args, build_config(args))
    if args.fast:
        print(f"fast profiles {args.fast}: input "
              f"{cfg.input_height}x{cfg.input_width}, enc {cfg.enc_layers}, "
              f"points {cfg.enc_n_points}/{cfg.dec_n_points}, margin "
              f"{cfg.sampling_margin}", flush=True)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.video:
        from snipper_tpu_torch.infer.pipeline import extract_video_frames

        args.data_dir = os.path.join(args.output_dir, "frames")
        n = extract_video_frames(args.video, args.data_dir)
        print(f"extracted {n} frames from {args.video} -> {args.data_dir}",
              flush=True)

    model = build_model(cfg, device=device, seed=0)
    if state is not None:
        model.load_state_dict(state)

    frame_indices, all_files = snippet_index(args.data_dir, cfg.num_frames,
                                             args.seq_gap)
    # lazy decode (+ host warp) in a background thread, overlapping the
    # forward
    samples = iter_snippet_samples(
        args.data_dir, cfg.num_frames, args.seq_gap, cfg.input_shape,
        warp_on_device=args.device_preprocess,
        index=(frame_indices, all_files))
    if args.device_preprocess and device.type == "cuda":
        samples = pinned(samples)
    sample_iter = prefetched(samples, depth=2)
    print(f"{len(frame_indices)} snippets over {len(all_files)} frames on "
          f"{device}", flush=True)

    def to_device(s):
        """One snippet's warped frames ``[T, h, w, 3]`` on the device."""
        if args.device_preprocess:
            return preprocess_snippet_device(
                s.get("raw_pinned", s["raw_imgs"]), s["trans"],
                cfg.input_shape, device)
        return torch.from_numpy(s["imgs"]).to(device)

    w, h = float(cfg.input_width), float(cfg.input_height)
    gsz = args.snippet_batch
    results, done_at, forward_ms, wait_ms = [], [], [], []
    first_sample = vis_sample = None
    t_start = time.perf_counter()
    done = False
    while not done:
        group = []
        t_wait = time.perf_counter()
        for s in sample_iter:
            if first_sample is None:
                first_sample = s
            if (vis_sample is None and args.vis_heatmap_frame_name
                    and args.vis_heatmap_frame_name in s["filenames"]):
                vis_sample = s
            group.append(s)
            if len(group) == gsz:
                break
        else:
            done = True
        if not group:
            break
        if args.device_preprocess:
            t0 = time.perf_counter()
            wait_ms.append((t0 - t_wait) * 1e3)
            # warped on the device, stacked there
            imgs = torch.stack([to_device(s) for s in group])
        else:
            # host-warped frames: stacked on the host, uploaded once
            host = np.stack([s["imgs"] for s in group])
            t0 = time.perf_counter()
            wait_ms.append((t0 - t_wait) * 1e3)
            imgs = torch.from_numpy(host).to(device)
        if imgs.shape[0] < gsz:  # pad the tail; padded outputs dropped
            imgs = torch.cat([imgs, imgs[-1:].expand(
                gsz - imgs.shape[0], *imgs.shape[1:])])
        with torch.inference_mode():
            out = model(imgs)
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

    if args.save_visuals and first_sample is not None:
        from snipper_tpu_torch.infer.visualize import (save_as_videos,
                                                       save_visual_results,
                                                       visualize_attention,
                                                       visualize_heatmaps)

        save_visual_results(frames, all_files, args.data_dir,
                            args.output_dir, max_pid, cfg.max_depth,
                            gap=args.seq_gap)
        save_as_videos(args.output_dir, sorted(frames.keys()), all_files)
        # heatmap + attention-sampling overlays from the first snippet, or
        # from the snippet holding --vis_heatmap_frame_name
        if args.vis_heatmap_frame_name and vis_sample is None:
            raise ValueError(f"frame {args.vis_heatmap_frame_name} is not "
                             "used for prediction")
        s0 = vis_sample if vis_sample is not None else first_sample
        with torch.inference_mode():
            x0 = to_device(s0)
            out0 = model(x0[None], return_attn=True)
        imgs0 = x0.cpu().numpy()
        hms = [hm.cpu().numpy() for hm in out0["heatmaps"]]
        hm_imgs, hm_names = imgs0, s0["filenames"]
        if args.vis_heatmap_frame_name:
            # only the requested frame
            t = s0["filenames"].index(args.vis_heatmap_frame_name)
            hms = [hm[:, t:t + 1] for hm in hms]
            hm_imgs, hm_names = imgs0[t:t + 1], [s0["filenames"][t]]
        visualize_heatmaps(hms, hm_imgs,
                           os.path.join(args.output_dir, "heatmaps"),
                           filenames=hm_names)
        prob0 = torch.softmax(out0["pred_logits"], -1)[0, :, :, 1].mean(-1)
        visualize_attention(
            [(loc.cpu().numpy(), attn.cpu().numpy())
             for loc, attn in out0["attn_data"]],
            imgs0, os.path.join(args.output_dir, "attention"),
            query_scores=prob0.cpu().numpy())
    print(f"results written to {args.output_dir}", flush=True)
    return {"snippets": len(results), "seconds": seconds, "done_at": done_at,
            "forward_ms": forward_ms, "wait_ms": wait_ms}


if __name__ == "__main__":
    main()
