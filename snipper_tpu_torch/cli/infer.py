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

On several GPUs, one process per GPU, the snippets sharded over them:

    torchrun --nproc_per_node N -m snipper_tpu_torch.cli.infer \
        --data_parallel --data_dir FRAMES --output_dir OUT ...
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch
from torch.profiler import record_function

from snipper_tpu_torch.cli.common import (add_config_args, build_config,
                                          load_state)
from snipper_tpu_torch.data.device_preprocess import \
    preprocess_snippet_device
from snipper_tpu_torch.infer.fast import PROFILE_HELP
from snipper_tpu_torch.infer.pipeline import (associate_snippets,
                                              host_warp,
                                              iter_snippet_samples,
                                              prefetched, snippet_index)
from snipper_tpu_torch.infer.postprocess import decode_predictions
from snipper_tpu_torch.models.snipper import build_model, resolve_device
from snipper_tpu_torch.parallel.multihost import (all_gather_objects,
                                                  barrier, distributed,
                                                  is_main_process, print0,
                                                  process_count,
                                                  process_index)


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
                        help="snippets per forward call (per rank with "
                             "--data_parallel)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="under torchrun, shard the snippets over the "
                             "ranks (one GPU each): rank r serves every "
                             "world-th group of --snippet_batch snippets "
                             "and rank 0 associates and writes; at world "
                             "size 1 the plain path")
    parser.add_argument("--preset", type=str, default="canonical_t4")
    parser.add_argument("--fast", type=str, default=None, help=PROFILE_HELP)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def pinned(samples):
    """Pin each sample's uint8 frames (``raw_pinned``), so that the copy to
    the card does not block; run inside the prefetch thread."""
    for s in samples:
        yield dict(s, raw_pinned=torch.from_numpy(s["raw_imgs"]).pin_memory())


def to_device(s, cfg, device, device_preprocess: bool) -> torch.Tensor:
    """One snippet's warped frames ``[T, h, w, 3]`` on ``device``."""
    if device_preprocess:
        return preprocess_snippet_device(
            s.get("raw_pinned", s["raw_imgs"]), s["trans"], cfg.input_shape,
            device)
    return torch.from_numpy(s["imgs"]).to(device)


def serve_snippets(model, cfg, data_dir: str, seq_gap: int,
                   device: torch.device, snippet_batch: int = 1,
                   device_preprocess: bool = False, group=None) -> dict:
    """The serving loop: every snippet of ``data_dir`` through ``model``
    in groups of ``snippet_batch`` (the last one padded; its padded
    outputs dropped), decoded on the host while the previous group runs.

    Over the ranks of the process group ``group`` (the default group when
    one exists), rank r serves groups r, r + world, ... on its ``device``;
    the forward issues no collective, and the decoded results reach every
    rank, each carrying its snippet index, through one
    ``all_gather_objects``. Returns ``{"results", "index", "snippets",
    "seconds", "done_at", "forward_ms", "wait_ms", "host_warp"}``: every
    snippet's decoded result in snippet order, the ``(frame_indices,
    all_files)`` listing they index, and this rank's count of snippets
    served, wall time, the host-clock time each of its groups finished
    (outputs on the host), each group's forward time including the copy of
    its inputs to the device (and, with ``device_preprocess``, the warp)
    and of its outputs to the host, the time each group waited for its decoded
    (and, on the host path, warped) frames, and where the frames were
    warped (:func:`~snipper_tpu_torch.infer.pipeline.host_warp`).

    Each group's phases are host spans (``record_function``, recorded
    when a profiler runs): ``serve.wait`` (the interval of ``wait_ms``),
    ``serve.upload``, the ``model`` call (the forward's own ``model.*``
    spans) and ``serve.readback`` (together the interval of
    ``forward_ms``), then ``serve.decode``."""
    frame_indices, all_files = snippet_index(data_dir, cfg.num_frames,
                                             seq_gap)
    world, rank = process_count(group), process_index(group)
    gsz = snippet_batch
    # builds and loads the host warp here, before the prefetch thread and
    # the first group's wait
    warp = host_warp(device_preprocess)
    mine = [i for i in range(len(frame_indices)) if (i // gsz) % world == rank]
    # lazy decode (+ host warp) in a background thread, overlapping the
    # forward
    samples = iter_snippet_samples(
        data_dir, cfg.num_frames, seq_gap, cfg.input_shape,
        warp_on_device=device_preprocess,
        index=([frame_indices[i] for i in mine], all_files))
    if device_preprocess and device.type == "cuda":
        samples = pinned(samples)
    sample_iter = prefetched(samples, depth=2)

    w, h = float(cfg.input_width), float(cfg.input_height)
    results, done_at, forward_ms, wait_ms = [], [], [], []
    t_start = time.perf_counter()
    for start in range(0, len(mine), gsz):
        group_idx = mine[start:start + gsz]
        with record_function("serve.wait"):
            t_wait = time.perf_counter()
            snippets = [next(sample_iter) for _ in group_idx]
            if not device_preprocess:
                # host-warped frames: stacked on the host, uploaded once
                host = np.stack([s["imgs"] for s in snippets])
            t0 = time.perf_counter()
        wait_ms.append((t0 - t_wait) * 1e3)
        with record_function("serve.upload"):
            if device_preprocess:
                # warped on the device, stacked there
                imgs = torch.stack([to_device(s, cfg, device, True)
                                    for s in snippets])
            else:
                imgs = torch.from_numpy(host).to(device)
            if imgs.shape[0] < gsz:  # pad the tail; padded outputs dropped
                imgs = torch.cat([imgs, imgs[-1:].expand(
                    gsz - imgs.shape[0], *imgs.shape[1:])])
        with torch.inference_mode():
            # no span of the loop's own around ``model``: a caller's
            # ``model`` may stop one profiler and start another, and a span
            # open across that switch has torch write its end into the
            # first profiler's freed events; the forward's ``model.*``
            # stages time the call
            out = model(imgs)
            with record_function("serve.readback"):
                logits = out["pred_logits"].cpu().numpy()
                kpts = out["pred_kpts2d"].cpu().numpy()
                depth = out["pred_depth"].cpu().numpy()
        t1 = time.perf_counter()
        forward_ms.append((t1 - t0) * 1e3)
        done_at.append(t1)
        with record_function("serve.decode"):
            for b, (i, s) in enumerate(zip(group_idx, snippets)):
                prob, score, k2, d = decode_predictions(
                    logits[b], kpts[b], depth[b], cfg.max_depth, (w, h))
                results.append((i, {
                    "human_score": prob,
                    "pred_kpt_scores": score,
                    "pred_kpts": k2,
                    "pred_depth": d,
                    "inv_trans": s["inv_trans"],
                    "img_size": s["img_size"],
                    "filenames": s["filenames"],
                }))
    seconds = time.perf_counter() - t_start
    merged = sorted((r for chunk in all_gather_objects(results, group)
                     for r in chunk), key=lambda r: r[0])
    return {"results": [r for _, r in merged],
            "index": (frame_indices, all_files), "snippets": len(results),
            "seconds": seconds, "done_at": done_at, "forward_ms": forward_ms,
            "wait_ms": wait_ms, "host_warp": warp}


def main(argv=None) -> dict:
    """Run inference; returns ``{"snippets", "seconds", "done_at",
    "forward_ms", "wait_ms"}``: the count of snippets served over all
    ranks, and this rank's wall time and per-group times
    (:func:`serve_snippets`)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.snippet_batch < 1:
        parser.error("--snippet_batch must be >= 1")
    if bool(args.data_dir) == bool(args.video):
        parser.error("exactly one of --data_dir / --video is required")
    if args.vis_heatmap_frame_name and not args.save_visuals:
        parser.error("--vis_heatmap_frame_name requires --save_visuals")
    if "RANK" in os.environ and not args.data_parallel:
        parser.error("under torchrun, pass --data_parallel (each rank "
                     "serves its share of the snippets)")
    with distributed(resolve_device(args.device)) as device:
        return infer(parser, args, device)


def infer(parser, args, device: torch.device) -> dict:
    """``main`` on this rank's ``device``, in the process group (if any)
    that ``main`` joined; rank 0 associates and writes."""
    main_rank = is_main_process()
    # the checkpoint is read under the preset's config, then mapped to the
    # --fast profile's
    cfg, state = load_state(parser, args, build_config(args))
    if args.fast:
        print0(f"fast profiles {args.fast}: input "
               f"{cfg.input_height}x{cfg.input_width}, enc {cfg.enc_layers},"
               f" points {cfg.enc_n_points}/{cfg.dec_n_points}, margin "
               f"{cfg.sampling_margin}")
    os.makedirs(args.output_dir, exist_ok=True)
    if args.video:
        from snipper_tpu_torch.infer.pipeline import extract_video_frames

        args.data_dir = os.path.join(args.output_dir, "frames")
        if main_rank:
            n = extract_video_frames(args.video, args.data_dir)
            print(f"extracted {n} frames from {args.video} -> "
                  f"{args.data_dir}", flush=True)
        barrier()

    model = build_model(cfg, device=device, seed=0)
    if state is not None:
        model.load_state_dict(state)

    world = process_count()
    print0(f"serving {args.data_dir} on {device}, warp "
           f"{host_warp(args.device_preprocess)}"
           + (f", data-parallel over {world} ranks" if world > 1 else ""))
    served = serve_snippets(model, cfg, args.data_dir, args.seq_gap, device,
                            args.snippet_batch, args.device_preprocess)
    results = served["results"]
    frame_indices, all_files = served["index"]
    stats = {k: served[k] for k in ("seconds", "done_at", "forward_ms",
                                    "wait_ms")}
    stats["snippets"] = len(results)
    if not main_rank:
        return stats

    frames, max_pid = associate_snippets(
        results, frame_indices, all_files, cfg.num_frames, args.seq_gap,
        cfg.max_depth)
    print(f"tracked {max_pid} identities over {len(frames)} frames; "
          f"{len(results)} snippets in {stats['seconds']:.3f} s", flush=True)
    with open(os.path.join(args.output_dir, "tracks.pkl"), "wb") as f:
        pickle.dump({"frames": frames, "max_pid": max_pid}, f)

    if args.save_visuals and results:
        from snipper_tpu_torch.infer.visualize import (save_as_videos,
                                                       save_visual_results,
                                                       visualize_attention,
                                                       visualize_heatmaps)

        save_visual_results(frames, all_files, args.data_dir,
                            args.output_dir, max_pid, cfg.max_depth,
                            gap=args.seq_gap)
        save_as_videos(args.output_dir, sorted(frames.keys()), all_files)
        # heatmap + attention-sampling overlays from the first snippet, or
        # from the first snippet holding --vis_heatmap_frame_name
        name = args.vis_heatmap_frame_name
        hits = [i for i, r in enumerate(results)
                if not name or name in r["filenames"]]
        if not hits:
            raise ValueError(f"frame {name} is not used for prediction")
        s0 = next(iter_snippet_samples(
            args.data_dir, cfg.num_frames, args.seq_gap, cfg.input_shape,
            warp_on_device=args.device_preprocess,
            index=([frame_indices[hits[0]]], all_files)))
        with torch.inference_mode():
            x0 = to_device(s0, cfg, device, args.device_preprocess)
            out0 = model(x0[None], return_attn=True)
        imgs0 = x0.cpu().numpy()
        hms = [hm.cpu().numpy() for hm in out0["heatmaps"]]
        hm_imgs, hm_names = imgs0, s0["filenames"]
        if name:
            # only the requested frame
            t = s0["filenames"].index(name)
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
    return stats


if __name__ == "__main__":
    main()
