"""Hybrid multi-dataset snippet loader: the port's own copy of
``snipper_tpu/data/datasets.py``.

Counterpart of the reference ``datasets/hybrid_dataloader.py``
``HybridData``: it reads the same preprocessed pickles/JSONs the
reference's ``datasets/data_preprocess`` scripts emit (regenerated
cv2-free by ``snipper_tpu_torch/data/preprocess``), and one seed gives the
JAX package's sample list, augmentation and targets.

Differences from the reference, as in the JAX package:
- images come back NHWC ``[T, H, W, 3]`` float32 (not packed
  ``[T*3, H, W]``); with ``device_preprocess=True`` the raw uint8 frames,
  a folded inverse affine per frame and the color scale instead, warped
  inside the train step (``device_preprocess.py::warp_train_batch_device``)
- targets are padded to ``max_persons`` with a validity mask
  (``data/snippet.py::build_trajectories``)
- decode/warp is PIL + numpy (no cv2)

Sources and their reference getters:
- posetrack  (``hybrid_dataloader.py:118-303``)   video, 2D + track ids
- coco       (``:303-445``)  still -> fake camera-motion sequence
- muco       (``:445-644``)  still composite, 3D (depth), fake motion
- mupots     (``:644-901``)  video, 3D, eval only
- jta        (``:901-1212``) video game, 3D, forecasting
- panoptic   (``:1212-1450``) multi-camera studio  [see panoptic.py]
"""

from __future__ import annotations

import json
import os
import pickle
import threading
from typing import Dict, List, Optional

import numpy as np

from snipper_tpu_torch.config import Config
from snipper_tpu_torch.data.native_ops import warp_patch
from snipper_tpu_torch.data.skeleton import (COCO_TO_JOINT15, FLIP_JOINTS,
                                             JTA_TO_JOINT15, NUM_JOINTS,
                                             POSETRACK_TO_JOINT15)
from snipper_tpu_torch.data.snippet import (bbox_2d_padded_batch,
                                            build_trajectories,
                                            transform_frame_kpts)
from snipper_tpu_torch.data.transforms import (fold_flip_inverse,
                                               get_aug_config,
                                               get_aug_config_coco)


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


class HybridDataset:
    """Map-style dataset over mixed sources; index -> (images, targets)."""

    def __init__(self, cfg: Config, mode: str = "train",
                 posetrack_dir: Optional[str] = None,
                 coco_dir: Optional[str] = None,
                 muco_dir: Optional[str] = None,
                 jta_dir: Optional[str] = None,
                 panoptic_dir: Optional[str] = None,
                 panoptic_protocol: int = 1,
                 seed: int = 0,
                 device_preprocess: bool = False):
        self.cfg = cfg
        # device_preprocess: emit raw uint8 frames + per-frame folded
        # inverse affines + color scales instead of host-warped images;
        # the train step warps on the card (device_preprocess.py::
        # warp_train_batch_device) and the host stays decode-only
        self.device_preprocess = device_preprocess
        self.mode = mode
        self.seq_l = cfg.num_frames
        self.future_seq_l = cfg.num_future_frames
        self.t_total = cfg.total_frames
        self.input_shape = (cfg.input_height, cfg.input_width)
        self.max_depth = cfg.max_depth
        self.seq_min_gap = 1 if cfg.num_frames == 1 else cfg.seq_min_gap
        self.seq_max_gap = cfg.seq_max_gap
        # augmentation randomness is per-(seed, epoch, sample): derived in
        # __getitem__ and held in thread-local storage so the loader's
        # decode thread pool (num_workers > 0) never shares a Generator —
        # numpy Generators are not thread-safe — and every sample's
        # augmentation stream is reproducible independent of worker count
        # or iteration order
        self._seed = seed
        self._epoch = 0
        self._tls = threading.local()

        self.posetrack_dir = posetrack_dir
        self.coco_dir = coco_dir
        self.muco_dir = muco_dir
        self.jta_dir = jta_dir
        self.panoptic_dir = panoptic_dir
        self.panoptic_protocol = panoptic_protocol

        self.samples: List[tuple] = []
        self.posetrack_data: Dict = {}
        self.coco_data: List = []
        self.muco_data: Dict = {}
        self.mupots_data: Dict = {}
        self._build_sample_list()

    # ------------------------------------------------------------ listing
    def _build_sample_list(self):
        cfg = self.cfg
        train = self.mode == "train"
        if self.posetrack_dir:
            self._list_posetrack(train)
        if self.coco_dir:
            self._list_coco(train)
        if self.muco_dir and train:
            self._list_muco()
        if self.muco_dir and not train:
            self._list_mupots()
        if self.jta_dir:
            self._list_jta(train)
        if self.panoptic_dir:
            from snipper_tpu_torch.data.panoptic import list_panoptic

            self.panoptic_data, entries = list_panoptic(
                self.panoptic_dir, self.panoptic_protocol, self.mode,
                self.seq_l, self.future_seq_l, self.seq_min_gap,
                self.seq_max_gap)
            self.samples += entries

    def _list_posetrack(self, train: bool):
        """Reference ``get_labelled_seq`` posetrack branches
        (``hybrid_dataloader.py:1457-1484`` train, ``:1637-1664`` val)."""
        fname = os.path.join(self.posetrack_dir,
                             "train_filled.pkl" if train else "val.pkl")
        with open(fname, "rb") as f:
            self.posetrack_data = pickle.load(f)
        for fn, seq in self.posetrack_data.items():
            if fn == "categories":
                continue
            first = int(seq[0]["filename"].split("/")[-1].split(".")[0])
            last = int(seq[-1]["filename"].split("/")[-1].split(".")[0])
            n = last - first + 1
            if train:
                for i in range(n):
                    gap = self.seq_max_gap
                    while gap >= self.seq_min_gap:
                        if i + gap * self.t_total <= n:
                            self.samples.append(
                                ("posetrack", fn, i, gap, True))
                            break
                        gap -= 1
            else:
                val_gap = 1 if self.seq_l == 1 else 4
                for i in range(n):
                    if i + val_gap * self.t_total > n:
                        continue
                    if self.seq_l > 1:
                        if (i // self.seq_l) % self.seq_l == 0 and any(
                                seq[i + k * val_gap]["is_label"]
                                for k in range(self.seq_l)):
                            self.samples.append(
                                ("posetrack", fn, i, val_gap, False))
                    elif seq[i]["is_label"]:
                        self.samples.append(
                            ("posetrack", fn, i, val_gap, False))

    def _list_coco(self, train: bool = True):
        """Train: fake-motion augmented stills. Val: the COCO keypoint
        eval split (reference ``write_val_results_coco`` /
        ``hybrid_dataloader.py:1876-1915`` flow), unaugmented."""
        name = "coco_train.pkl" if train else "coco_val.pkl"
        path = os.path.join(self.coco_dir, name)
        if not train and not os.path.exists(path):
            return  # train-only COCO setup (the reference's common case)
        with open(path, "rb") as f:
            self.coco_data = pickle.load(f)
        if not train and self.coco_data and \
                "image_id" not in self.coco_data[0]:
            # the OKS harness matches predictions to GT by COCO image id;
            # silently falling back to enumeration indices would score ~0
            raise ValueError(
                f"{path} lacks 'image_id' fields — regenerate it with "
                "snipper_tpu_torch.data.preprocess.mscoco (the val-eval leg "
                "needs real COCO image ids)")
        for i in range(len(self.coco_data)):
            self.samples.append(("coco", i, train))

    def _list_muco(self):
        with open(os.path.join(self.muco_dir, "MuCo-3DHP.pkl"), "rb") as f:
            self.muco_data = pickle.load(f)
        for img_id in self.muco_data:
            self.samples.append(("muco", img_id, True))

    def _list_mupots(self):
        """Eval-only MuPoTS sequences (``hybrid_dataloader.py:1670-1700``)."""
        with open(os.path.join(self.muco_dir, "MuPoTS-3D.pkl"), "rb") as f:
            self.mupots_data = pickle.load(f)
        seq_g = (self.seq_max_gap + self.seq_min_gap) // 2 + 1
        img_ids = sorted(self.mupots_data.keys())
        step = max(seq_g * (self.seq_l - 1), 1)
        for img_id in range(img_ids[0], img_ids[-1], step):
            if img_id not in self.mupots_data:
                continue
            fn = self.mupots_data[img_id]["file_name"]
            if self.seq_l > 1:
                end_id = img_id + seq_g * (self.t_total - 1)
                if end_id not in self.mupots_data:
                    continue
                if fn.split("/")[0] != \
                        self.mupots_data[end_id]["file_name"].split("/")[0]:
                    continue
            self.samples.append(("mupots", img_id, False))

    def _list_jta(self, train: bool):
        with open(os.path.join(
                self.jta_dir,
                "jta_all_ann_files_no_moving_camera.json")) as f:
            subsets = json.load(f)
        subset = "train" if train else "test"
        seq_g = (self.seq_max_gap + self.seq_min_gap) // 2 + 1
        for seq, img_ids in subsets[subset].items():
            hi = len(img_ids) - (self.t_total + 1) * seq_g
            step = seq_g if train else max((self.seq_l - 1) * seq_g, seq_g)
            for idx in range(0, max(hi, 0), step):
                # augment=False even in train mode: the reference lists
                # every JTA sample with augmentation disabled
                # (hybrid_dataloader.py:1564-1565 train, :1718 test)
                self.samples.append(("jta", seq, idx, subset, False))

    # ------------------------------------------------------------ getters
    def __len__(self):
        return len(self.samples)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    @property
    def rng(self) -> np.random.Generator:
        """Per-(sample, thread) generator installed by ``__getitem__``."""
        rng = getattr(self._tls, "rng", None)
        if rng is None:  # direct getter calls outside __getitem__
            rng = np.random.default_rng(self._seed)
            self._tls.rng = rng
        return rng

    def __getitem__(self, idx: int) -> Dict:
        self._tls.rng = np.random.default_rng(
            np.random.SeedSequence([self._seed, self._epoch, idx]))
        s = self.samples[idx]
        getter = getattr(self, f"get_{s[0]}")
        return getter(s)

    # -- shared helpers -----------------------------------------------
    def _pixel_bbxes(self, tgt: Dict) -> np.ndarray:
        """[M, T1, 4] padded boxes in INPUT-PIXEL space from the normalized
        trajectory keypoints (the reference computes boxes pre-normalization,
        e.g. ``hybrid_dataloader.py:343``, so bbxes are pixel-unit
        everywhere)."""
        h, w = self.input_shape
        k = tgt["kpts2d"].copy()
        k[..., 0] *= w
        k[..., 1] *= h
        return np.stack([bbox_2d_padded_batch(k[:, t])
                         for t in range(self.t_total)], 1)

    def _warp_frames(self, frames: List[np.ndarray], trans_list,
                     do_flip: bool, color) -> object:
        """Host warp (default) or the raw-frame record consumed by the
        device warp path (``device_preprocess=True``)."""
        if not self.device_preprocess:
            return [warp_patch(f, tr, self.input_shape, do_flip, color)
                    for f, tr in zip(frames, trans_list)]
        src_w = frames[0].shape[1]
        return {
            "raw": np.stack([np.ascontiguousarray(f, dtype=np.uint8)
                             for f in frames]),
            "inv": np.stack([fold_flip_inverse(tr, do_flip, src_w)
                             for tr in trans_list]),
            "color": np.asarray(color, np.float32),
        }

    def _finalize(self, imgs: List[np.ndarray], tgt: Dict, inv_trans,
                  dataset: str, filenames, cam_intr=None, image_id=0,
                  video_name="", frame_indices=0) -> Dict:
        h, w = self.input_shape
        tgt.update({
            "max_depth": np.float32(self.max_depth),
            "input_size": np.array([w, h], np.float32),
            "inv_trans": np.asarray(inv_trans, np.float32),
            "dataset": dataset,
            "filenames": filenames,
            "image_id": image_id,
            "video_name": video_name,
            "frame_indices": frame_indices,
            "cam_intr": (np.asarray(cam_intr, np.float32)
                         if cam_intr is not None
                         else np.zeros((1,), np.float32)),
        })
        if "kpts3d" not in tgt:
            tgt["kpts3d"] = np.zeros((1,), np.float32)
        if "bbxes" not in tgt:
            tgt["bbxes"] = np.zeros((tgt["kpts2d"].shape[0],
                                     self.t_total, 4), np.float32)
        if "bbxes_head" not in tgt:
            tgt["bbxes_head"] = np.zeros_like(tgt["bbxes"])
        if isinstance(imgs, dict):  # device-preprocess raw record
            return {"raw_images": imgs["raw"], "warp_inv": imgs["inv"],
                    "color_scale": imgs["color"], "targets": tgt}
        return {"images": np.stack(imgs).astype(np.float32), "targets": tgt}

    # -- posetrack ------------------------------------------------------
    def get_posetrack(self, sample) -> Dict:
        _, fn, indice, max_gap, augment = sample
        gap = (int(self.rng.integers(self.seq_min_gap, max_gap + 1))
               if self.mode == "train" else 4)
        seq = self.posetrack_data[fn]

        frames, kpts, ids, heads, filenames = [], [], [], [], []
        for j in range(self.t_total):
            datum = seq[indice + j * gap]
            filenames.append(datum["filename"])
            if j < self.seq_l:
                frames.append(_read_rgb(os.path.join(self.posetrack_dir,
                                                     datum["filename"])))
            if isinstance(datum["kpts2d"], list) or len(datum["kpts2d"]) == 0:
                kpts.append(np.zeros((0, NUM_JOINTS, 3)))
                ids.append(np.zeros((0,), np.int64))
                heads.append(np.zeros((0, 4)))
            else:
                kpts.append(np.asarray(
                    datum["kpts2d"])[:, POSETRACK_TO_JOINT15, :])
                ids.append(np.asarray(datum["track_id"]))
                bh = datum.get("bboxes_head", [])
                heads.append(np.asarray(bh) if len(bh)
                             else np.zeros((kpts[-1].shape[0], 4)))

        img_h, img_w = frames[0].shape[:2]
        rot, do_flip, color, bbx, trans, inv_trans = get_aug_config(
            (img_w, img_h), self.input_shape, augment, self.rng)

        imgs = self._warp_frames(frames, [trans] * len(frames),
                                 do_flip, color)
        kpts_n = [transform_frame_kpts(k, do_flip, img_w, trans,
                                       self.input_shape) for k in kpts]
        tgt = build_trajectories(kpts_n, ids, self.seq_l,
                                 self.cfg.max_persons,
                                 extras={"bbxes_head": heads})
        tgt["bbxes"] = self._pixel_bbxes(tgt)
        return self._finalize(imgs, tgt, inv_trans, "posetrack", filenames,
                              video_name=fn, frame_indices=indice)

    # -- coco (fake motion from a still) --------------------------------
    def get_coco(self, sample) -> Dict:
        _, idx, augment = sample
        datum = self.coco_data[idx]
        kpts2d = np.asarray(datum["kpts2d"])[:, COCO_TO_JOINT15, :]
        img = _read_rgb(os.path.join(self.coco_dir, datum["filename"]))
        return self._fake_motion_sample(img, kpts2d, None, augment,
                                        "coco", datum["filename"],
                                        datum.get("image_id", idx))

    # -- muco (still composite with 3D) ---------------------------------
    def get_muco(self, sample) -> Dict:
        _, img_id, augment = sample
        datum = self.muco_data[img_id]
        kpts2d = np.asarray(datum["kpts2d"])
        depth_m = np.asarray(datum["kpts3d"])[:, :, 2] / 1000.0
        img = _read_rgb(os.path.join(self.muco_dir, datum["file_name"]))
        return self._fake_motion_sample(img, kpts2d, depth_m, augment,
                                        "muco", datum["file_name"], img_id)

    def _fake_motion_sample(self, img, kpts2d, depth_m, augment, name,
                            filename, image_id) -> Dict:
        """Shared coco/muco path: one still -> T1 interpolated crops
        (reference ``get_coco``/``get_muco``)."""
        img_h, img_w = img.shape[:2]
        n = kpts2d.shape[0]
        _, do_flip, color, _, trans_l, inv_l = get_aug_config_coco(
            (img_w, img_h), self.input_shape, self.t_total, augment, self.rng)
        if len(trans_l) == 1:
            trans_l = trans_l * self.t_total
            inv_l = inv_l * self.t_total

        imgs = self._warp_frames([img] * self.seq_l, trans_l[:self.seq_l],
                                 do_flip, color)
        kpts_list, depth_list = [], []
        for t in range(self.t_total):
            k = transform_frame_kpts(kpts2d, do_flip, img_w, trans_l[t],
                                     self.input_shape)
            kpts_list.append(k)
            if depth_m is not None:
                d = depth_m[:, FLIP_JOINTS] if do_flip else depth_m
                d = d / self.max_depth
                depth_list.append(np.stack([d, np.ones_like(d)], -1))

        kpts = np.stack(kpts_list, 1)          # [n, T1, K, 3]
        # keep persons visible for more than T1 joints in total
        # (reference ``exist_traj``, hybrid_dataloader.py:508)
        keep = kpts[..., 2].sum((1, 2)) > self.t_total
        ids = np.arange(n)[keep]
        kpts_list = [k[keep] for k in kpts_list]
        if depth_list:
            depth_list = [d[keep] for d in depth_list]

        extras = {"depth": depth_list} if depth_list else None
        tgt = build_trajectories(kpts_list, [ids] * self.t_total, self.seq_l,
                                 self.cfg.max_persons, extras=extras)
        tgt["bbxes"] = self._pixel_bbxes(tgt)
        return self._finalize(imgs, tgt, inv_l[0], name, [filename],
                              image_id=image_id)

    # -- mupots (eval, 3D sequences) ------------------------------------
    def get_mupots(self, sample) -> Dict:
        _, img_id, augment = sample
        gap = (self.seq_min_gap + self.seq_max_gap) // 2 + 1
        frames, kpts, k3s, ids, filenames = [], [], [], [], []
        cam_intr = None
        for i in range(self.t_total):
            datum = self.mupots_data[img_id + i * gap]
            filenames.append(datum["file_name"])
            if i == 0:
                cam_intr = np.asarray(datum["intrinsic"])
            if i < self.seq_l:
                frames.append(_read_rgb(os.path.join(
                    self.muco_dir, "MuPoTS-3D_images", datum["file_name"])))
            tid = np.asarray(datum["track_ids"])
            if tid.shape[0] == 0:
                kpts.append(np.zeros((0, NUM_JOINTS, 3)))
                k3s.append(np.zeros((0, NUM_JOINTS, 3)))
            else:
                kpts.append(np.asarray(datum["kpts2d"]))
                k3s.append(np.asarray(datum["kpts3d"]) / 1000.0)
            ids.append(tid)

        img_h, img_w = frames[0].shape[:2]
        rot, do_flip, color, bbx, trans, inv_trans = get_aug_config(
            (img_w, img_h), self.input_shape, augment, self.rng)
        imgs = self._warp_frames(frames, [trans] * len(frames),
                                 do_flip, color)
        kpts_n, depths, k3_l = [], [], []
        for k, k3 in zip(kpts, k3s):
            if do_flip:
                # keep the 3D GT joint order consistent with the flipped
                # 2D/depth targets (rebinding the loop variable would leave
                # the original unflipped list feeding the extras)
                k3 = k3[:, FLIP_JOINTS, :]
            kpts_n.append(transform_frame_kpts(k, do_flip, img_w, trans,
                                               self.input_shape))
            d = k3[:, :, 2] / self.max_depth
            depths.append(np.stack([d, np.ones_like(d)], -1))
            k3_l.append(k3)
        tgt = build_trajectories(kpts_n, ids, self.seq_l,
                                 self.cfg.max_persons,
                                 extras={"depth": depths, "kpts3d": k3_l})
        tgt["bbxes"] = self._pixel_bbxes(tgt)
        return self._finalize(imgs, tgt, inv_trans, "mupots", filenames,
                              cam_intr=cam_intr, image_id=img_id)

    # -- jta -------------------------------------------------------------
    def get_jta(self, sample) -> Dict:
        _, seq, img_idx, subset, augment = sample
        gap = (self.seq_min_gap + self.seq_max_gap) // 2
        idxs = img_idx + gap * np.arange(self.t_total)

        frames, kpts, k3s, ids, filenames = [], [], [], [], []
        for j, i in enumerate(idxs):
            filenames.append(f"{seq}/{i:03d}.jpg")
            if j < self.seq_l:
                frames.append(_read_rgb(os.path.join(
                    self.jta_dir, "images_half", subset, seq,
                    f"{i:03d}.jpg")))
            with open(os.path.join(self.jta_dir, "ann_split", subset, seq,
                                   f"{i:03d}.json")) as f:
                ann = json.load(f)
            tid = np.asarray(list(ann.keys()), np.int64)
            if tid.shape[0] == 0:
                k2 = np.zeros((0, NUM_JOINTS, 2))
                k3 = np.zeros((0, NUM_JOINTS, 3))
                occ = np.zeros((0, NUM_JOINTS, 2))
            else:
                k2, k3, occ = (np.asarray(a) for a in
                               zip(*list(ann.values())))
                k2 = k2.reshape(-1, 22, 2)[:, JTA_TO_JOINT15, :] / 2
                k3 = k3.reshape(-1, 22, 3)[:, JTA_TO_JOINT15, :]
                occ = occ.reshape(-1, 22, 2)[:, JTA_TO_JOINT15, :]
            # drop persons occluded in >= 75% of joints (reference :936)
            vis = occ[:, :, 0].sum(-1) < NUM_JOINTS * 0.75
            k2 = np.concatenate(
                [k2[vis], np.ones_like(k2[vis][..., :1])], -1)
            kpts.append(k2)
            k3s.append(k3[vis])
            ids.append(tid[vis])

        img_h, img_w = frames[0].shape[:2]
        rot, do_flip, color, bbx, trans, inv_trans = get_aug_config(
            (img_w, img_h), self.input_shape, augment, self.rng)
        imgs = self._warp_frames(frames, [trans] * len(frames),
                                 do_flip, color)

        kpts_n, k3_l, ids_l, depths, bbxs = [], [], [], [], []
        for k, k3, tid in zip(kpts, k3s, ids):
            kn = transform_frame_kpts(k, do_flip, img_w, trans,
                                      self.input_shape)
            if do_flip:
                k3 = k3[:, FLIP_JOINTS, :]
            # per-frame validity: root visible, box area, depth in range
            # (reference :985-996) — boxes computed in pixel space
            kn_px = kn.copy()
            kn_px[..., 0] *= self.input_shape[1]
            kn_px[..., 1] *= self.input_shape[0]
            boxes = bbox_2d_padded_batch(kn_px)
            valid = ((kn[:, 0, 2] > 0)
                     & (boxes[:, 2] * boxes[:, 3] > 10)
                     & (k3[:, 0, 2] < self.max_depth))
            kn, k3, tid, boxes = kn[valid], k3[valid], tid[valid], boxes[valid]
            d = k3[:, :, 2] / self.max_depth
            kpts_n.append(kn)
            k3_l.append(k3)
            ids_l.append(tid)
            depths.append(np.stack([d, np.ones_like(d)], -1))
            bbxs.append(boxes)

        tgt = build_trajectories(kpts_n, ids_l, self.seq_l,
                                 self.cfg.max_persons,
                                 extras={"depth": depths, "kpts3d": k3_l,
                                         "bbxes": bbxs})
        cam_intr = np.array([1158, 1158, 960, 540]) / 2
        return self._finalize(imgs, tgt, inv_trans, "jta", filenames,
                              cam_intr=cam_intr, image_id=img_idx)

    # -- panoptic --------------------------------------------------------
    def get_panoptic(self, sample) -> Dict:
        from snipper_tpu_torch.data.panoptic import get_panoptic_sample

        return get_panoptic_sample(self, sample)
