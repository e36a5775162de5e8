"""The one general generator of the traffic mixes' inputs, from a seed.

- ``video_library``: JPEG frames in the style of a camera's video (a
  smooth scene of large colour regions, texture at several scales, and
  sensor noise) and one directory per video length of links to them, made
  once per checkout under ``.bench_cache/inputs`` and reused: a link costs
  a file-system operation, and a library made anew in every run spends
  most of set-up on them and leaves the window listing cold directories.
  The frames do not depend on the seed, so concurrent runs share them.
- ``video_plan``: the videos' lengths in snippets. Every seed serves the
  same lengths (each of ``lo..hi`` once per round), in its own order.
- ``samples``: training samples, each a snippet of persons drawn as
  Gaussian blobs at their joints with their exact 2D, depth and 3D
  targets, rendered on the device. Sample i holds ``1 + i % 4`` persons, so
  every seed has the same number of persons.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

NUM_JOINTS = 15


def frame_pool(out_dir: str, n: int, width: int, height: int, seed: int,
               device) -> List[str]:
    """``n`` seeded ``width x height`` JPEG frames (quality 90) under
    ``out_dir``."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    paths = []
    for i in range(n):
        img = torch.zeros(3, height, width, device=device)
        for cells, amp in ((6, 90.0), (24, 40.0), (96, 18.0)):
            ch = max(cells * height // width, 1)
            field = torch.randn(1, 3, ch, cells, generator=gen,
                                device=device)
            img += amp * torch.nn.functional.interpolate(
                field, (height, width), mode="bicubic",
                align_corners=False)[0]
        img += 5.0 * torch.randn(3, height, width, generator=gen,
                                 device=device)
        img = (img + 128.0).clamp(0, 255).to(torch.uint8)
        path = os.path.join(out_dir, f"pool{i:03d}.jpg")
        Image.fromarray(img.permute(1, 2, 0).cpu().numpy()).save(
            path, quality=90)
        paths.append(path)
    return paths


def video_plan(lo: int, hi: int, rounds: int, seed: int) -> List[int]:
    """Snippet counts of the videos: ``rounds`` rounds, each every count of
    ``lo..hi`` once, shuffled by ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        out.extend(int(x) for x in rng.permutation(np.arange(lo, hi + 1)))
    return out


def video_frames(snippets: int, num_frames: int, gap: int) -> int:
    """Frames of a video with ``snippets`` snippets (the last one ends one
    frame short of the next start)."""
    skip = gap if num_frames == 1 else gap * (num_frames - 1)
    return skip * snippets + 1


def video_library(root: str, n_pool: int, width: int, height: int,
                  lengths: List[int], num_frames: int, gap: int,
                  device) -> Dict[int, str]:
    """``{snippets: directory}``: a video of each length, its frames
    links to a pool of ``n_pool`` frames (from a start that depends on the
    length, wrapping). Made once under ``root``; a run that finds it
    reuses it. Made in a temporary directory and renamed, so a run never
    sees half of it."""
    import shutil
    import tempfile

    name = f"videos_{width}x{height}_p{n_pool}_t{num_frames}_g{gap}"
    lib = os.path.join(root, name)
    if not os.path.isdir(lib):
        os.makedirs(root, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".{name}_", dir=root)
        frame_pool(os.path.join(tmp, "pool"), n_pool, width, height, 0,
                   device)
        for k in lengths:
            d = os.path.join(tmp, f"len{k:03d}")
            os.makedirs(d)
            for f in range(video_frames(k, num_frames, gap)):
                os.symlink(os.path.join(
                    "..", "pool", f"pool{(7 * k + f) % n_pool:03d}.jpg"),
                    os.path.join(d, f"{f:06d}.jpg"))
        try:
            os.rename(tmp, lib)
        except OSError:          # another run made it first
            shutil.rmtree(tmp, ignore_errors=True)
    return {k: os.path.join(lib, f"len{k:03d}") for k in lengths}


def samples(cfg: dict, n: int, seed: int, device) -> List[Dict]:
    """``n`` training samples of ``cfg``'s snippet: ``images [T, H, W, 3]``
    f32 in [0, 1] (host) and padded targets (``kpts2d [M, T1, K, 3]``,
    ``depth [M, T1, K, 2]``, ``valid [M]``, track and trajectory ids, the
    camera and 3D poses for the eval)."""
    T, Tf = cfg["num_frames"], cfg["num_future_frames"]
    T1, H, W, M = T + Tf, cfg["input_height"], cfg["input_width"], \
        cfg["max_persons"]
    rng = np.random.default_rng(seed)
    base = np.array([
        [0.0, 0.0], [0.0, -0.30], [0.0, -0.22], [0.06, -0.20],
        [-0.06, -0.20], [0.09, -0.10], [-0.09, -0.10], [0.10, 0.0],
        [-0.10, 0.0], [0.04, 0.02], [-0.04, 0.02], [0.05, 0.14],
        [-0.05, 0.14], [0.05, 0.26], [-0.05, 0.26]])
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    out = []
    for i in range(n):
        persons = min(1 + i % 4, M)
        kpts = np.zeros((M, T1, NUM_JOINTS, 3), np.float32)
        depth = np.zeros((M, T1, NUM_JOINTS, 2), np.float32)
        valid = np.zeros((M,), bool)
        track = np.zeros((M, T1), np.int32)
        sizes = np.zeros((M,), np.float32)
        colors = rng.uniform(0.4, 1.0, (persons, 3)).astype(np.float32)
        for p in range(persons):
            valid[p] = True
            track[p] = 1
            centre = rng.uniform([0.25, 0.3], [0.75, 0.7])
            vel = rng.uniform(-0.02, 0.02, 2)
            z = rng.uniform(2.5, 7.5)
            sizes[p] = 4.0 / z
            offs = base * rng.uniform(0.8, 1.2) * sizes[p]
            for t in range(T1):
                kpts[p, t, :, 0:2] = centre + vel * t + offs
                kpts[p, t, :, 2] = 1.0
                depth[p, t, :, 0] = z / cfg["max_depth"]
                depth[p, t, :, 1] = 1.0
        img = torch.full((T, H, W, 3), 0.1, device=device)
        k = torch.from_numpy(kpts[:persons, :T]).to(device)
        for p in range(persons):
            blob = 40.0 * float(sizes[p]) ** 2
            col = torch.from_numpy(colors[p]).to(device)
            for t in range(T):
                cx = k[p, t, :, 0, None, None] * W
                cy = k[p, t, :, 1, None, None] * H
                g = torch.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / blob)
                img[t] += g.sum(0)[..., None] * col
        img = img.clamp(0, 1).cpu().numpy()
        fx = fy = 0.5 * (W + H)
        k3 = np.zeros((M, T1, NUM_JOINTS, 3), np.float32)
        zz = depth[..., 0] * cfg["max_depth"]
        k3[..., 0] = (kpts[..., 0] * W - W / 2) / fx * zz
        k3[..., 1] = (kpts[..., 1] * H - H / 2) / fy * zz
        k3[..., 2] = zz
        targets = {
            "kpts2d": kpts, "depth": depth, "valid": valid,
            "track_ids": track,
            "traj_ids": np.arange(M, dtype=np.int32) * valid,
            "max_depth": np.float32(cfg["max_depth"]),
            "input_size": np.array([W, H], np.float32),
            "inv_trans": np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32),
            "cam_intr": np.array([fx, fy, W / 2, H / 2], np.float32),
            "dataset": "synthetic", "kpts3d": k3}
        out.append({"images": img, "targets": targets})
    return out


class SampleSet:
    """A map-style dataset of ``length`` items cycling over ``items``; it
    keeps the order in which items were read (``reads``)."""

    def __init__(self, items: List[Dict], length: int):
        self.items = items
        self.length = length
        self.reads: List[int] = []

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> Dict:
        j = int(idx) % len(self.items)
        self.reads.append(j)
        s = self.items[j]
        return dict(s, targets=dict(s["targets"]))
