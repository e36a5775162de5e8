"""Ground-truth label dump and statistics tool (the port's own copy of
``snipper_tpu/cli/dump_labels.py``).

Counterpart of the reference's standalone JTA dataset variant
(``dataset_class.py``, a HybridData clone that loads annotations and
dumps GT pickles and label statistics from its ``__main__``,
``dataset_class.py:469-575``). Works for any configured source and runs
on the host alone: it reads samples through the dataset's getters (which
decode and warp the frames) and never touches a card.

    python -m snipper_tpu_torch.cli.dump_labels --preset canonical_t4_f2 \
        --posetrack_dir DIR --out gt.pkl [--mode val] [--limit N] \
        [--vis N --vis_dir DIR]
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from snipper_tpu_torch.cli.common import (add_config_args, add_data_args,
                                          build_config, build_dataset)


def _render_roundtrip(ds, args, n_vis: int):
    """Augmentation round-trip renders (reference ``vis=True``,
    ``hybrid_dataloader.py:389-441``): augmented keypoints on the augmented
    frames, and the inverse-transformed frame-0 keypoints on the original
    image (blank canvas when the original file cannot be located)."""
    import os

    from PIL import Image

    from snipper_tpu_torch.infer.visualize import (draw_skeleton_2d,
                                                   pid_palette)

    os.makedirs(args.vis_dir, exist_ok=True)
    roots = [d for d in (args.posetrack_dir, args.coco_dir, args.muco_dir,
                         args.jta_dir, args.panoptic_dir) if d]
    for i in range(n_vis):
        s = ds[i]
        t = s["targets"]
        m = int(t["valid"].sum())
        colors = [tuple(int(255 * v) for v in c[:3])
                  for c in pid_palette(max(m, 1))]
        imgs = (np.clip(s["images"], 0, 1) * 255).astype(np.uint8)
        T, h, w = imgs.shape[:3]
        for fr in range(T):
            vis_img = imgs[fr]
            for p in range(m):
                k = np.asarray(t["kpts2d"][p, fr], np.float64).copy()
                k[:, 0] *= w
                k[:, 1] *= h
                vis_img = draw_skeleton_2d(vis_img, k, colors[p],
                                           score_thresh=0.5)
            Image.fromarray(vis_img).save(
                os.path.join(args.vis_dir, f"{i:04d}_aug_t{fr}.jpg"))

        # inverse transform of frame-0 keypoints back to the original image
        inv = np.asarray(t["inv_trans"], np.float64)       # [2, 3]
        orig = None
        fn = (t.get("filenames") or [None])[0]
        for root in roots if fn else []:
            path = os.path.join(root, str(fn))
            if os.path.exists(path):
                orig = np.asarray(Image.open(path).convert("RGB"))
                break
        if orig is None:
            back = inv @ np.array([[0, w, 0, w], [0, 0, h, h],
                                   [1, 1, 1, 1]], np.float64)
            ow, oh = int(back[0].max()) + 1, int(back[1].max()) + 1
            orig = np.full((max(oh, 2), max(ow, 2), 3), 255, np.uint8)
        vis_img = orig
        for p in range(m):
            k = np.asarray(t["kpts2d"][p, 0], np.float64).copy()
            k[:, 0] *= w
            k[:, 1] *= h
            pts = np.concatenate([k[:, 0:2], np.ones((k.shape[0], 1))], -1)
            k[:, 0:2] = pts @ inv.T
            vis_img = draw_skeleton_2d(vis_img, k, colors[p],
                                       score_thresh=0.5)
        Image.fromarray(vis_img).save(
            os.path.join(args.vis_dir, f"{i:04d}_aug_trans.jpg"))
    print(f"round-trip renders in {args.vis_dir}", flush=True)


def main(argv=None) -> dict:
    """Dump the labels; returns ``{"samples", "dumps", "persons"}``: the
    sample count, the dumped records and the persons per sample."""
    parser = argparse.ArgumentParser("snipper_tpu_torch label dump")
    add_config_args(parser)
    add_data_args(parser)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--mode", type=str, default="val")
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--vis", type=int, default=0,
                        help="render the first N samples: augmented frames "
                             "with augmented keypoints + the inverse-"
                             "transformed frame-0 keypoints on the original "
                             "image (the reference's vis=True round-trip, "
                             "hybrid_dataloader.py:389-441; flip is only "
                             "invertible in-scope, so use --mode val)")
    parser.add_argument("--vis_dir", type=str, default="./label_vis")
    args = parser.parse_args(argv)
    cfg = build_config(args)

    ds = build_dataset(cfg, args, args.mode)
    n = len(ds) if not args.limit else min(args.limit, len(ds))
    print(f"{n} samples", flush=True)

    dumps = []
    person_counts, depth_vals, vis_fracs = [], [], []
    for i in range(n):
        # only the annotation path matters; monkey-free: getters decode
        # images, which is acceptable for the synthetic/small dumps this
        # tool is used for
        s = ds[i]
        t = s["targets"]
        m = int(t["valid"].sum())
        person_counts.append(m)
        if m:
            vis = t["kpts2d"][: m, ..., 2]
            vis_fracs.append(float(vis.mean()))
            d = t["depth"][: m]
            if d[..., 1].sum() > 0:
                depth_vals.append(float(
                    (d[..., 0][d[..., 1] > 0]).mean()))
        dumps.append({
            "kpts2d": t["kpts2d"][: m],
            "depth": t["depth"][: m],
            "track_ids": t["track_ids"][: m],
            "traj_ids": t["traj_ids"][: m],
            "kpts3d": t.get("kpts3d"),
            "dataset": t.get("dataset"),
            "filenames": t.get("filenames"),
        })

    if args.vis:
        _render_roundtrip(ds, args, min(args.vis, n))

    with open(args.out, "wb") as f:
        pickle.dump(dumps, f)
    print(f"wrote {args.out}")
    res = {"samples": n, "dumps": dumps, "persons": person_counts}
    if not person_counts:  # np.max on an empty list raises
        print("0 samples — nothing to summarize")
        return res
    print(f"persons/sample: mean {np.mean(person_counts):.2f} "
          f"max {np.max(person_counts)}")
    if vis_fracs:
        print(f"visible-joint fraction: {np.mean(vis_fracs):.3f}")
    if depth_vals:
        print(f"mean normalized depth: {np.mean(depth_vals):.3f}")
    return res


if __name__ == "__main__":
    main()
