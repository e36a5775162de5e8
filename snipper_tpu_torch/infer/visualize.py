"""Visualization: 2D tracking overlays, 3D pose plots, trajectory renders,
the composed board image/GIF, heatmap and attention-sampling overlays, and
the eval's GT-vs-prediction keypoint renders.

The port's own copy of ``snipper_tpu/infer/visualize.py`` (reference
``inference_utils.py:342-644``), on PIL + matplotlib, both imported inside
the functions so that importing the package needs neither. Artifact set
(the reference demo's):

- ``track2d/{frame}_track.jpg``: skeleton + padded bbox + id label
- ``track3d/{frame}_track3d.jpg`` and ``..._topdown.jpg``: two 3D views
- ``track3d/{frame}_trajectory3d.jpg`` and ``..._topdown.jpg``: per-joint
  trajectories with the latest pose of each identity
- ``static_img.jpg``: first/mid/last 2D frames + trajectory board
- ``pose_tracking.gif``: board + per-frame 2D/3D composition, 5 fps
- ``heatmaps/...`` and ``attention/...`` overlays
- ``eval_b{batch:04d}_s{sample}.jpg``: eval renders (``--save_vis``)
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np

from snipper_tpu_torch.data.skeleton import SKELETON_EDGES


def pid_palette(n: int):
    """Rainbow palette shuffled with the reference's fixed seed
    (``inference_utils.py:360-366``)."""
    import matplotlib.pyplot as plt

    cmap = plt.get_cmap("rainbow")
    colors = [cmap(x) for x in np.linspace(0, 1, max(n, 1))]
    random.Random(13).shuffle(colors)
    return colors


def _rgb255(c):
    return tuple(int(255 * v) for v in c[:3])


def bbox_2d_padded(pose: np.ndarray, h_inc: float = 0.15,
                   w_inc: float = 0.1):
    """Padded keypoint bbox (reference ``inference_utils.py:111-140``);
    ``pose [K, 4]`` with score in col 3. Returns (x, y, w, h) or None."""
    vis = pose[:, 3] > 0
    if vis.sum() < 2:
        return None
    kp = pose[vis, 0:2]
    x0, y0 = kp.min(0)
    x1, y1 = kp.max(0)
    dw = (x1 - x0) * w_inc / 2
    dh = (y1 - y0) * h_inc / 2
    return (x0 - dw, y0 - dh, (x1 - x0) + 2 * dw, (y1 - y0) + 2 * dh)


def draw_skeleton_2d(img: np.ndarray, kpts: np.ndarray, color,
                     score_thresh: float = 0.0,
                     pid: Optional[int] = None) -> np.ndarray:
    """Draw one person's skeleton (+ padded bbox and id label when ``pid``
    given, reference track2d rendering); ``kpts [K, >=3]`` with score in the
    last column."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(img)
    d = ImageDraw.Draw(im)
    score = kpts[:, -1]
    for a, b in SKELETON_EDGES:
        if score[a] > score_thresh and score[b] > score_thresh:
            d.line([tuple(kpts[a, :2]), tuple(kpts[b, :2])], fill=color,
                   width=4)
    for k in range(kpts.shape[0]):
        if score[k] > score_thresh:
            x, y = kpts[k, :2]
            d.ellipse([x - 4, y - 4, x + 4, y + 4], fill=color)
    if pid is not None:
        pose4 = np.concatenate([kpts[:, :2], np.zeros_like(kpts[:, :1]),
                                score[:, None]], -1)
        bbx = bbox_2d_padded(pose4)
        if bbx is not None:
            x, y, w, h = bbx
            d.rectangle([x, y, x + w, y + h], outline=color, width=3)
            d.text((x + w / 3, max(y - 14, 0)), f"{pid:02d}", fill=color)
    return np.asarray(im)


def render_pose3d(poses: Dict[int, np.ndarray], colors, max_depth: float,
                  img_w: int, img_h: int, path: str, elev=10, azim=-90,
                  path_topdown: Optional[str] = None,
                  scores: Optional[Dict[int, np.ndarray]] = None):
    """3D limb plot with (x, depth, -y) axes; optionally also saves the
    top-down view (elev 70, azim -90) like the reference track3d pass."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    for pid, kpt in poses.items():
        c = colors[pid % len(colors)][:3]
        sc = scores.get(pid) if scores else None
        for a, b in SKELETON_EDGES:
            if sc is not None and not (sc[a] > 0 and sc[b] > 0):
                continue
            ax.plot([kpt[a, 0], kpt[b, 0]], [kpt[a, 2], kpt[b, 2]],
                    [-kpt[a, 1], -kpt[b, 1]], color=c, linewidth=2)
    ax.set_xlim([0, img_w])
    ax.set_ylim([2, max_depth])
    ax.set_zlim([-img_h, 0])
    ax.set_xticklabels([])
    ax.set_yticklabels([])
    ax.set_zticklabels([])
    ax.view_init(elev, azim)
    fig.savefig(path, bbox_inches="tight")
    if path_topdown:
        ax.view_init(70, -90)
        fig.savefig(path_topdown, bbox_inches="tight")
    plt.close(fig)


def render_trajectory(all_frames: Dict[int, tuple], colors, gap: int,
                      max_depth: float, img_w: int, img_h: int,
                      path: str, path_topdown: str):
    """Trajectory plot (reference ``inference_utils.py:474-549``): walking
    backwards by ``gap`` from the last frame, draw each identity's most
    recent pose once, then per-joint lines linking its poses in consecutive
    gap-spaced frames."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    idxs = sorted(all_frames.keys())
    start, end = idxs[0], idxs[-1]
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(111, projection="3d")
    drawn = set()
    for frame_idx in range(end, start - 1, -gap):
        if frame_idx not in all_frames:
            continue
        pids, poses = all_frames[frame_idx]
        for p, pid in enumerate(pids):
            pid = int(pid)
            c = colors[pid % len(colors)][:3]
            if pid not in drawn:
                drawn.add(pid)
                k = poses[p]
                for a, b in SKELETON_EDGES:
                    ax.plot([k[a, 0], k[b, 0]], [k[a, 2], k[b, 2]],
                            [-k[a, 1], -k[b, 1]], color=c, linewidth=2)
        # trajectory segment to the next (later) gap frame
        nxt = frame_idx + gap
        if nxt > end or nxt not in all_frames:
            continue
        nxt_pids, nxt_poses = all_frames[nxt]
        nxt_pids = np.asarray(nxt_pids)
        for p, pid in enumerate(pids):
            hits = np.where(nxt_pids == pid)[0]
            if not hits.size:
                continue
            c = colors[int(pid) % len(colors)][:3]
            k0, k1 = poses[p], nxt_poses[hits[0]]
            for j in range(k0.shape[0]):
                ax.plot([k0[j, 0], k1[j, 0]], [k0[j, 2], k1[j, 2]],
                        [-k0[j, 1], -k1[j, 1]], color=c, linewidth=0.8)
    ax.set_xlim([0, img_w])
    ax.set_ylim([2, max_depth])
    ax.set_zlim([-img_h, 0])
    ax.set_xticklabels([])
    ax.set_yticklabels([])
    ax.set_zticklabels([])
    ax.view_init(20, -80)
    fig.savefig(path, bbox_inches="tight")
    ax.view_init(70, -90)
    fig.savefig(path_topdown, bbox_inches="tight")
    plt.close(fig)


def save_visual_results(all_frames: Dict[int, tuple],
                        all_filenames: List[str], data_dir: str,
                        save_dir: str, max_pid: int, max_depth: float,
                        gap: int = 5, save_3d: bool = True):
    """Reference demo artifact pass: track2d overlays, two-view track3d
    plots, trajectory renders (``inference_utils.py:342-549``)."""
    from PIL import Image

    os.makedirs(os.path.join(save_dir, "track2d"), exist_ok=True)
    if save_3d:
        os.makedirs(os.path.join(save_dir, "track3d"), exist_ok=True)
    colors = pid_palette(max_pid)
    img_w = img_h = None
    for frame_idx, (pids, data) in sorted(all_frames.items()):
        fn = all_filenames[frame_idx]
        name = os.path.splitext(fn)[0]
        img = np.asarray(Image.open(os.path.join(data_dir, fn))
                         .convert("RGB"))
        img_h, img_w = img.shape[:2]
        vis = img.copy()
        for i, pid in enumerate(pids):
            kpts = np.concatenate([data[i, :, 0:2], data[i, :, 3:4]], -1)
            vis = draw_skeleton_2d(vis, kpts,
                                   _rgb255(colors[int(pid) % len(colors)]),
                                   pid=int(pid))
        Image.fromarray(vis).save(
            os.path.join(save_dir, "track2d", f"{name}_track.jpg"))
        if save_3d:
            poses = {int(pid): data[i, :, 0:3]
                     for i, pid in enumerate(pids)}
            scores = {int(pid): data[i, :, 3]
                      for i, pid in enumerate(pids)}
            render_pose3d(
                poses, colors, max_depth, img_w, img_h,
                os.path.join(save_dir, "track3d", f"{name}_track3d.jpg"),
                path_topdown=os.path.join(
                    save_dir, "track3d", f"{name}_track3d_topdown.jpg"),
                scores=scores)
    if save_3d and all_frames:
        last = max(all_frames.keys())
        name = os.path.splitext(all_filenames[last])[0]
        render_trajectory(
            {k: (p, d[:, :, 0:3]) for k, (p, d) in all_frames.items()},
            colors, gap, max_depth, img_w, img_h,
            os.path.join(save_dir, "track3d", f"{name}_trajectory3d.jpg"),
            os.path.join(save_dir, "track3d",
                         f"{name}_trajectory3d_topdown.jpg"))


def save_as_videos(save_dir: str, all_frames_idx: List[int],
                   all_filenames: List[str], fps: int = 5):
    """Composed board image + tracking GIF (reference
    ``inference_utils.py:552-619``): a static board of first/mid/last 2D
    frames plus the two trajectory views, and a per-frame 2D/3D GIF."""
    from PIL import Image, ImageDraw

    def load(p, size=None):
        im = Image.open(p).convert("RGB")
        return im.resize(size) if size else im

    def track2d(i):
        name = os.path.splitext(all_filenames[all_frames_idx[i]])[0]
        return load(os.path.join(save_dir, "track2d", f"{name}_track.jpg"),
                    (960, 540))

    n = len(all_frames_idx)
    last = os.path.splitext(all_filenames[all_frames_idx[-1]])[0]
    traj = load(os.path.join(save_dir, "track3d",
                             f"{last}_trajectory3d.jpg"), (1560, 1560))
    traj_td = load(os.path.join(
        save_dir, "track3d", f"{last}_trajectory3d_topdown.jpg"),
        (1560, 1560))

    board = Image.new("RGB", (960 + 1560 + 1560, 1620), "white")
    board.paste(track2d(0), (0, 0))
    board.paste(track2d(n // 2), (0, 540))
    board.paste(track2d(n - 1), (0, 1080))
    board.paste(traj, (960, 30))
    board.paste(traj_td, (960 + 1560, 30))
    board = board.resize((2040, 810))
    d = ImageDraw.Draw(board)
    red = (255, 0, 0)
    d.text((10, 30), f"Frame {all_frames_idx[0]}", fill=red)
    d.text((10, 300), f"Frame {all_frames_idx[n // 2]}", fill=red)
    d.text((10, 570), f"Frame {all_frames_idx[-1]}", fill=red)
    d.text((650, 40), "Trajectory (camera view)", fill=red)
    d.text((1450, 40), "Trajectory (top-down view)", fill=red)
    board.save(os.path.join(save_dir, "static_img.jpg"))

    frames = []
    for frame_idx in all_frames_idx:
        name = os.path.splitext(all_filenames[frame_idx])[0]
        f2d = load(os.path.join(save_dir, "track2d", f"{name}_track.jpg"),
                   (960, 540))
        f3d = load(os.path.join(save_dir, "track3d", f"{name}_track3d.jpg"),
                   (1080, 1080))
        frame = Image.new("RGB", (2040, 1890), "white")
        frame.paste(board, (0, 0))
        frame.paste(f2d, (0, 810 + 270))
        frame.paste(f3d, (960, 810))
        d = ImageDraw.Draw(frame)
        d.text((400, 1000), "2D pose", fill=red)
        d.text((1400, 1000), "3D pose", fill=red)
        frames.append(frame)
    if frames:
        frames[0].save(os.path.join(save_dir, "pose_tracking.gif"),
                       save_all=True, append_images=frames[1:],
                       duration=int(1000 / fps), loop=0)


def save_as_gif(image_dir: str, out_path: str, fps: int = 5):
    """Assemble rendered frames into a GIF (reference writes at 5 fps,
    ``inference_utils.py:618``)."""
    from PIL import Image

    files = sorted(os.listdir(image_dir))
    if not files:
        return
    frames = [Image.open(os.path.join(image_dir, f)) for f in files]
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)


def visualize_heatmaps(heatmaps: List[np.ndarray], images: np.ndarray,
                       save_dir: str, level: int = 0, head: int = 0,
                       filenames: Optional[List[str]] = None):
    """Overlay encoder keypoint heatmaps on input frames (counterpart of
    ``inference_utils.py:622-644``). heatmaps: [(B, T, h, w, nhead, K)].

    ``filenames``: per-frame source names; when given, each render is named
    after its frame (``heatmap_{stem}.jpg``, the reference's
    frame-name-keyed outputs, ``inference_utils.py:643-644``) instead of
    the positional ``heatmap_t{t}.jpg``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_dir, exist_ok=True)
    hm = np.asarray(heatmaps[level])[0, :, :, :, head]  # [T, h, w, K]
    T = hm.shape[0]
    for t in range(T):
        fig, ax = plt.subplots(figsize=(8, 6))
        # bf16 round-trips can leave floats at 1 + 1ulp; clip to silence
        # matplotlib's per-image "Clipping input data" warning
        ax.imshow(np.clip(images[t], 0.0, 1.0))
        ax.imshow(hm[t].max(-1), alpha=0.5, cmap="jet",
                  extent=(0, images.shape[2], images.shape[1], 0))
        ax.axis("off")
        name = (f"heatmap_{os.path.splitext(filenames[t])[0]}"
                if filenames is not None else f"heatmap_t{t}")
        fig.savefig(os.path.join(save_dir, f"{name}.jpg"),
                    bbox_inches="tight")
        plt.close(fig)


def visualize_attention(attn_data, images: np.ndarray, save_dir: str,
                        query_scores: Optional[np.ndarray] = None,
                        layer: int = -1, top_k: int = 5):
    """Render decoder deformable-attention sampling locations — the consumer
    of the reference's attention plumbing (``ms_deform_attn.py:167-233`` →
    ``engine.py:136``), which the reference collects but never draws.

    ``attn_data``: the model's per-decoder-layer list of
    ``(sampling_locations [B, T1, Lq, H, L, P, 2] in [0,1],
       attention_weights [B, T1, Lq, H, L, P])``.
    ``images``: [T, H, W, 3] observed frames; one JPEG per frame with the
    top-k queries' sampling points, sized by attention weight and colored by
    query.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_dir, exist_ok=True)
    loc, attn = attn_data[layer]
    loc = np.asarray(loc)[0]      # [T1, Lq, H, L, P, 2]
    attn = np.asarray(attn)[0]    # [T1, Lq, H, L, P]
    T = images.shape[0]
    h_img, w_img = images.shape[1:3]
    Lq = loc.shape[1]
    if query_scores is None:
        # fall back to total attention mass per query
        query_scores = attn.sum((0, 2, 3, 4)) if attn.ndim == 5 else \
            np.ones(Lq)
    top = np.argsort(-np.asarray(query_scores))[:top_k]
    cmap = plt.get_cmap("tab10")
    for t in range(T):
        fig, ax = plt.subplots(figsize=(8, 6))
        ax.imshow(np.clip(images[t], 0.0, 1.0))
        for rank, q in enumerate(top):
            pts = loc[t, q].reshape(-1, 2)           # [H*L*P, 2]
            w = attn[t, q].reshape(-1)
            # sampling locations are normalized [0,1] -> frame pixels
            ax.scatter(pts[:, 0] * w_img,
                       pts[:, 1] * h_img,
                       s=5 + 200 * w / max(w.max(), 1e-6),
                       color=cmap(rank % 10), alpha=0.6,
                       label=f"query {int(q)}")
        ax.legend(loc="upper right", fontsize=8)
        ax.set_xlim([0, w_img])
        ax.set_ylim([h_img, 0])
        ax.axis("off")
        fig.savefig(os.path.join(save_dir, f"attention_t{t}.jpg"),
                    bbox_inches="tight")
        plt.close(fig)


def save_eval_keypoint_renders(results, images: np.ndarray, save_dir: str,
                               batch_idx: int = 0,
                               max_samples: int = 4) -> None:
    """GT-vs-prediction keypoint renders for one eval batch.

    Counterpart of the reference's eval-time visualization
    (``visualize_eval_kepts_pred``, reference ``engine.py:216`` called at
    ``:132-135`` under ``save_vis``): per sample, the observed frames are
    tiled horizontally with GT skeletons in green and the criterion-matched
    predictions in red, written as one JPEG per sample.
    """
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    imgs = np.asarray(images)
    green, red = (40, 200, 60), (230, 50, 40)
    for i, res in enumerate(results[:max_samples]):
        if i >= imgs.shape[0]:
            break
        T = imgs.shape[1]
        gt_k = np.asarray(res["gt_kpts"])           # [m, T1, K, 2]
        gt_v = np.asarray(res["gt_kpts_vis"])       # [m, T1, K, 1]
        pred_k = np.asarray(res["pred_kpts"])       # [n, T1, K, 2]
        pred_s = np.asarray(res["pred_kpt_scores"]) # [n, T1, K, 1]
        src_idx = tgt_idx = None
        if res.get("indices") is not None:
            src_idx, tgt_idx = (np.asarray(x) for x in res["indices"])
        panels = []
        for t in range(T):
            img = np.clip(imgs[i, t] * 255.0, 0, 255).astype(np.uint8)
            img = np.ascontiguousarray(img)
            for p in range(gt_k.shape[0]):
                kp = np.concatenate([gt_k[p, t], gt_v[p, t]], -1)
                img = draw_skeleton_2d(img, kp, green)
            if src_idx is not None and gt_k.shape[0]:
                for p in range(min(len(src_idx), gt_k.shape[0])):
                    kp = np.concatenate(
                        [pred_k[src_idx[p], t], pred_s[src_idx[p], t]], -1)
                    img = draw_skeleton_2d(img, kp, red)
            panels.append(img)
        board = np.concatenate(panels, axis=1)
        Image.fromarray(board).save(
            os.path.join(save_dir, f"eval_b{batch_idx:04d}_s{i}.jpg"))
