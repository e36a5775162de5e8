"""Evaluation entry point (counterpart of ``snipper_tpu/cli/eval.py``,
reference ``eval.py``): loads a checkpoint, runs the eval loop, writes
``{output_dir}/eval_stats.json`` and, on request, the PoseTrack and COCO
result files and their scores.

    python -m snipper_tpu_torch.cli.eval --preset canonical_t4_f2 \\
        --posetrack_dir DIR [--muco_dir DIR --coco_dir DIR --jta_dir DIR \\
        --panoptic_dir DIR] --resume CKPT.pt --output_dir OUT \\
        [--save_vis] [--write_posetrack [--posetrack_gt_dir DIR]] \\
        [--coco_gt_json GT.json]

Runs on the GPU unless ``--device cpu`` is given; the forward runs in f32.
Data is the validation split of the reference-format directories given
(``--muco_dir`` evaluates MuPoTS), or the synthetic set when none is
(``--synthetic``). ``--fast`` evaluates a serving profile
(``infer/fast.py``): the checkpoint is read under the preset's config and
mapped to the profile's, and the data and the eval run under the
profile's config, so that the stats are the profile's.
``--deform_impl`` is accepted and ignored:
the port's model always samples with the exact ``msda_forward``.
``--save_vis`` writes ``{output_dir}/eval_vis/eval_b{batch}_s{i}.jpg``
for the first two batches.

On several GPUs, one process per GPU, the validation set sharded over
them (padded by wrap-around to a multiple of N, as the reference's
``DistributedSampler``; rank 0 renders, merges and writes):

    torchrun --nproc_per_node N -m snipper_tpu_torch.cli.eval ...
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from snipper_tpu_torch.cli.common import (add_config_args, add_data_args,
                                          build_config, build_dataset,
                                          load_state)
from snipper_tpu_torch.data.loader import DataLoader
from snipper_tpu_torch.infer.fast import PROFILE_HELP
from snipper_tpu_torch.losses.criterion import SetCriterion
from snipper_tpu_torch.models.snipper import build_model, resolve_device
from snipper_tpu_torch.parallel.mesh import batch_sharding, make_mesh
from snipper_tpu_torch.parallel.multihost import distributed, \
    is_main_process
from snipper_tpu_torch.train.engine import evaluate


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("snipper_tpu_torch evaluator")
    add_config_args(parser)
    add_data_args(parser)
    parser.add_argument("--write_posetrack", action="store_true")
    parser.add_argument("--posetrack_gt_dir", type=str, default=None,
                        help="GT annotation JSON dir; if given, run the "
                             "PoseTrack AP/MOT evaluation after writing")
    parser.add_argument("--coco_gt_json", type=str, default=None,
                        help="COCO keypoint GT json; if given, run OKS eval")
    parser.add_argument("--save_vis", action="store_true",
                        help="write GT-vs-prediction keypoint renders for "
                             "the first eval batches")
    parser.add_argument("--fast", type=str, default=None, help=PROFILE_HELP)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    """Evaluate; returns ``{"stats", "batches", "batch_ms", "seconds"}``:
    the stats written to ``eval_stats.json``, the batch count, each batch's
    host time in ms (forward, criterion and outputs on the host) and the
    wall time of the eval loop (the batches and times this rank's)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    with distributed(resolve_device(args.device)) as device:
        return run_eval(parser, args, device)


def run_eval(parser, args, device) -> dict:
    """``main`` on this rank's ``device``, in the process group (if any)
    that ``main`` joined."""
    # the checkpoint is read under the preset's config; with --fast the
    # data and the eval run under the profile's
    cfg, state = load_state(parser, args, build_config(args))
    mesh = make_mesh()
    main_rank = is_main_process()
    os.makedirs(args.output_dir, exist_ok=True)

    val_ds = build_dataset(cfg, args, "val")
    loader = DataLoader(val_ds, cfg.batch_size, shuffle=False,
                        drop_last=False, num_workers=args.num_workers,
                        **batch_sharding(mesh))

    model = build_model(cfg, device=device, seed=cfg.seed)
    if state is not None:
        model.load_state_dict(state)

    t0 = time.perf_counter()
    stats = evaluate(
        model, SetCriterion(cfg, mesh=mesh), loader, cfg, device,
        collect_results=True, mesh=mesh,
        save_vis_dir=(os.path.join(args.output_dir, "eval_vis")
                      if args.save_vis and main_rank else None))
    seconds = time.perf_counter() - t0
    results = stats.pop("_results")
    n_batches = stats.pop("_batches")
    batch_ms = [x * 1e3 for x in stats.pop("_batch_seconds")]
    if not main_rank:
        return {"stats": stats, "batches": n_batches, "batch_ms": batch_ms,
                "seconds": seconds}

    def dump_stats():
        with open(os.path.join(args.output_dir, "eval_stats.json"),
                  "w") as f:
            json.dump({k: v for k, v in stats.items()
                       if isinstance(v, (int, float))}, f, indent=2)

    # the loss/3D/PCKh stats go to disk before the harness legs, so a
    # harness failure (a malformed GT dir) cannot lose a long eval run
    dump_stats()

    if args.write_posetrack:
        from snipper_tpu_torch.eval.posetrack_writer import (
            collect_posetrack_results, write_val_results)

        by_video = collect_posetrack_results(results, cfg.num_frames)
        pred_dir = os.path.join(args.output_dir, "posetrack_results")
        write_val_results(by_video, getattr(val_ds, "posetrack_data", {}),
                          pred_dir)
        if args.posetrack_gt_dir:
            from snipper_tpu_torch.eval.posetrack_eval import \
                evaluate_posetrack18

            pt = evaluate_posetrack18(args.posetrack_gt_dir, pred_dir)
            for section, metrics in pt.items():
                for k, v in metrics.items():
                    stats[f"posetrack_{section}_{k}"] = float(
                        np.asarray(v)[-1])

    if args.coco_gt_json:
        from snipper_tpu_torch.eval.coco_eval import (evaluate_coco_keypoints,
                                                      write_coco_results)
        from snipper_tpu_torch.eval.metrics import transform_pts

        coco_results = {}
        for r in results:
            if r.get("dataset") == "coco":
                # predictions are in warped model-input space, the GT json
                # in the original image's pixels
                k = transform_pts(np.asarray(r["pred_kpts"])[:, 0],
                                  r["inv_trans"])
                coco_results.setdefault(r["image_id"], []).append(
                    (np.asarray(r["human_score"]).max(-1),
                     np.concatenate([k, r["pred_kpt_scores"][:, 0]], -1)))
        if coco_results:
            pred_json = write_coco_results(coco_results, args.output_dir)
            stats.update({f"coco_{k}": v for k, v in
                          evaluate_coco_keypoints(args.coco_gt_json,
                                                  pred_json).items()})

    # again, with the harness numbers (PoseTrack AP/PCKh/MOT, COCO OKS)
    dump_stats()
    print(json.dumps({k: round(v, 4) for k, v in stats.items()
                      if isinstance(v, float)}, indent=2))
    return {"stats": stats, "batches": n_batches, "batch_ms": batch_ms,
            "seconds": seconds}


if __name__ == "__main__":
    main()
