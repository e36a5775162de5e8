"""Synthetic snippet dataset: procedurally generated multi-person sequences
with exact geometric ground truth, for tests and train smoke runs (no raw
datasets are distributed with the repository). The port's own copy of
``snipper_tpu/data/synthetic.py``: the same seeds give the same samples."""

from __future__ import annotations

from typing import Dict

import numpy as np

from snipper_tpu_torch.config import Config
from snipper_tpu_torch.data.skeleton import NUM_JOINTS


def _skeleton_offsets(rng) -> np.ndarray:
    """A plausible JOINT15 offset layout (normalized units)."""
    base = np.array([
        [0.0, 0.0], [0.0, -0.30], [0.0, -0.22], [0.06, -0.20], [-0.06, -0.20],
        [0.09, -0.10], [-0.09, -0.10], [0.10, 0.0], [-0.10, 0.0],
        [0.04, 0.02], [-0.04, 0.02], [0.05, 0.14], [-0.05, 0.14],
        [0.05, 0.26], [-0.05, 0.26],
    ])
    return base * rng.uniform(0.8, 1.2)


def make_sample(cfg: Config, rng: np.random.Generator,
                n_persons: int | None = None) -> Dict:
    """One snippet: images [T, H, W, 3] with rendered blobs at joints,
    padded targets, and eval metadata."""
    T, Tf = cfg.num_frames, cfg.num_future_frames
    T1 = T + Tf
    H, W = cfg.input_height, cfg.input_width
    M = cfg.max_persons
    n = n_persons if n_persons is not None else int(rng.integers(1, min(M, 4) + 1))

    kpts = np.zeros((M, T1, NUM_JOINTS, 3), np.float32)
    depth = np.zeros((M, T1, NUM_JOINTS, 2), np.float32)
    valid = np.zeros((M,), bool)
    track = np.zeros((M, T1), np.int32)

    sizes = np.zeros((M,), np.float32)
    for i in range(n):
        valid[i] = True
        track[i, :] = 1
        center = rng.uniform([0.25, 0.3], [0.75, 0.7])
        vel = rng.uniform(-0.02, 0.02, 2)
        z = rng.uniform(2.5, 7.5)
        # perspective: apparent skeleton size scales with 1/depth, so depth
        # is INFERABLE from the rendered image (a learnable 3D signal — the
        # train-to-accuracy tests rely on it; a fixed-size render would make
        # the depth head's target pure noise)
        sizes[i] = 4.0 / z
        offs = _skeleton_offsets(rng) * sizes[i]
        for t in range(T1):
            c = center + vel * t
            kpts[i, t, :, 0:2] = c + offs
            kpts[i, t, :, 2] = 1.0
            depth[i, t, :, 0] = z / cfg.max_depth
            depth[i, t, :, 1] = 1.0

    # render simple gaussians at joints over the observed frames
    imgs = np.full((T, H, W, 3), 0.1, np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(n):
        color = rng.uniform(0.4, 1.0, 3)
        # blob radius scales with apparent person size (see sizes above)
        blob = 40.0 * sizes[i] ** 2
        for t in range(T):
            for k in range(NUM_JOINTS):
                cx = kpts[i, t, k, 0] * W
                cy = kpts[i, t, k, 1] * H
                r2 = (xx - cx) ** 2 + (yy - cy) ** 2
                imgs[t] += color * np.exp(-r2 / blob)[..., None]
    imgs = np.clip(imgs, 0, 1)

    fx = fy = 0.5 * (W + H)
    targets = {
        "kpts2d": kpts, "depth": depth, "valid": valid,
        "track_ids": track,
        "traj_ids": np.arange(M, dtype=np.int32) * valid,
        "max_depth": np.float32(cfg.max_depth),
        "input_size": np.array([W, H], np.float32),
        "inv_trans": np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32),
        "cam_intr": np.array([fx, fy, W / 2, H / 2], np.float32),
        "dataset": "synthetic",
    }
    # camera-space 3D GT for eval tests
    k3 = np.zeros((M, T1, NUM_JOINTS, 3), np.float32)
    z = depth[..., 0] * cfg.max_depth
    k3[..., 0] = (kpts[..., 0] * W - W / 2) / fx * z
    k3[..., 1] = (kpts[..., 1] * H - H / 2) / fy * z
    k3[..., 2] = z
    targets["kpts3d"] = k3
    return {"images": imgs, "targets": targets}


class SyntheticDataset:
    """Map-style synthetic dataset (deterministic per index).

    ``distinct``: when set, only this many unique samples exist and indices
    cycle through them (``idx % distinct``) — an epoch of ``n_samples``
    then performs ``n_samples / distinct`` optimizer steps over a small
    fixed set, the overfit-training shape the train-to-accuracy tests use.
    """

    def __init__(self, cfg: Config, n_samples: int = 64, seed: int = 0,
                 distinct: int | None = None):
        self.cfg = cfg
        self.n = n_samples
        self.seed = seed
        self.distinct = distinct
        # overfit runs revisit the same few indices hundreds of times; the
        # full-grid gaussian render costs ~1-2 s/sample at canonical
        # 600x800, so cache the small fixed set (samples are deterministic
        # per index). A cached sample's arrays are read-only and each visit
        # gets its own dicts, so a consumer that wrote into one would raise
        # instead of changing every later visit.
        self._cache: Dict[int, Dict] | None = (
            {} if distinct and distinct <= 64 else None)

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int) -> Dict:
        if self.distinct:
            idx = idx % self.distinct
        sample = None if self._cache is None else self._cache.get(idx)
        if sample is None:
            rng = np.random.default_rng(self.seed * 100_003 + idx)
            sample = make_sample(self.cfg, rng)
            if self._cache is None:
                return sample
            for v in (sample["images"], *sample["targets"].values()):
                if isinstance(v, np.ndarray):
                    v.flags.writeable = False
            self._cache[idx] = sample
        return dict(sample, targets=dict(sample["targets"]))

