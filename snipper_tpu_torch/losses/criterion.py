"""Set criterion: Hungarian matching + the six Snipper losses over padded
targets, in f32 whatever the activation dtype.

Counterpart of ``snipper_tpu/losses/criterion.py:40-278`` term by term
(reference ``SetCriterion``, ``models/model.py:240-545``): ``is_human``
(CE with empty-class weight ``eos_coef``, averaged over all (query, frame)
cells), ``root``, ``joint``, ``joint_disp``, ``joint_cont`` and
``heatmap`` (MSE sum per level / nhead / dp_size), plus the aux losses of
every earlier decoder layer with their weights looked up by suffix. Every
per-target normalizer and ``num_traj`` reproduce the reference because
padded target rows carry zero visibility.

Over a data-parallel mesh each rank computes its own batch's loss with the
reference's normalizer (``models/model.py:521-526``): ``num_traj`` summed
over the data group and divided by its size, clamped to >= 1. The ranks'
losses, averaged as their gradients are, then equal the JAX package's
loss over the global batch; the heatmap's bare sum keeps ``dp_size`` 1 per
rank, since that average is JAX's ``/ dp_size`` of the global sum.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from snipper_tpu_torch.config import Config
from snipper_tpu_torch.data.skeleton import ROOT_JOINT_CONT
from snipper_tpu_torch.losses.heatmap import heatmap_targets
from snipper_tpu_torch.matching.matcher import match_layers
from snipper_tpu_torch.ops.deform_attn import device_constant

EPS = 1e-5


def loss_weight_dict(cfg: Config) -> Dict[str, float]:
    """Reference ``build_model`` weight_dict (``models/model.py:643-660``);
    ``max_depth == -1`` disables all depth terms (``:638-641``)."""
    depth_on = cfg.depth_enabled
    return {
        "loss_is_human": cfg.is_human_loss_coef,
        "loss_root": cfg.root_loss_coef,
        "loss_root_vis": cfg.root_vis_loss_coef,
        "loss_root_depth": cfg.root_depth_loss_coef if depth_on else 0.0,
        "loss_joint_disp": cfg.joint_disp_loss_coef,
        "loss_joint_depth_disp": (cfg.joint_disp_depth_loss_coef
                                  if depth_on else 0.0),
        "loss_joint": cfg.joint_loss_coef,
        "loss_joint_vis": cfg.joint_vis_loss_coef,
        "loss_joint_depth": cfg.joint_depth_loss_coef if depth_on else 0.0,
        "loss_cont": cfg.cont_loss_coef,
        "loss_heatmap": cfg.heatmap_loss_coef,
    }


def matcher_weight_dict(cfg: Config) -> Dict[str, float]:
    depth_on = cfg.depth_enabled
    return {
        "is_human": cfg.set_cost_is_human,
        "root": cfg.set_cost_root,
        "root_vis": cfg.set_cost_root_vis,
        "root_depth": cfg.set_cost_root_depth if depth_on else 0.0,
        "joint": cfg.set_cost_joint,
        "joint_vis": cfg.set_cost_joint_vis,
        "joint_depth": cfg.set_cost_joint_depth if depth_on else 0.0,
    }


def _gather_matched(pred: torch.Tensor, src_idx: torch.Tensor):
    """``pred [B, n, ...]`` gathered at ``src_idx [B, M]`` ->
    ``[B, M, ...]``."""
    idx = src_idx.reshape(src_idx.shape + (1,) * (pred.dim() - 2))
    idx = idx.expand(src_idx.shape + pred.shape[2:])
    return torch.gather(pred, 1, idx)


class SetCriterion:
    """Functional criterion; construct once from a Config."""

    def __init__(self, cfg: Config, dp_size: int = 1, mesh=None):
        """``mesh``: a ``parallel.mesh.Mesh``; its data group sums
        ``num_traj``."""
        self.cfg = cfg
        self.mesh = mesh
        self.weights = loss_weight_dict(cfg)
        self.match_weights = matcher_weight_dict(cfg)
        # the heatmap loss is a bare sum (reference model.py:441-443) that
        # DDP averages over ranks; a global-batch sum divides by dp_size
        self.dp_size = max(int(dp_size), 1)
        self.max_depth = cfg.max_depth

    # ---------------------------------------------------------------- losses
    def _loss_set(self, logits, kpts2d, depth, targets, src_idx,
                  num_traj) -> Dict[str, torch.Tensor]:
        f32 = torch.float32
        t_kpts = targets["kpts2d"].to(f32)      # [B, M, T, K, 3]
        t_depth = targets["depth"].to(f32)      # [B, M, T, K, 2]
        valid_b = targets["valid"].bool()       # [B, M]
        valid = valid_b.to(f32)
        B, n, T, _ = logits.shape

        p_kpts = _gather_matched(kpts2d, src_idx).to(f32)
        p_depth = _gather_matched(depth, src_idx).to(f32)

        losses = {}

        # ---- is_human (reference :266-286) --------------------------------
        tgt_vis_frame = (torch.sum(t_kpts[..., 2], 3) > 0).long()  # [B,M,T]
        onehot = ((src_idx[:, :, None]
                   == torch.arange(n, device=src_idx.device)[None, None])
                  & valid_b[:, :, None])                        # [B, M, n]
        target_classes = torch.sum(
            onehot[..., None].long() * tgt_vis_frame[:, :, None, :],
            1)                                                  # [B, n, T]
        logp = torch.log_softmax(logits.to(f32), -1)
        class_w = device_constant([self.cfg.eos_coef, 1.0], logp)
        picked = torch.gather(logp, -1, target_classes[..., None])[..., 0]
        losses["loss_is_human"] = torch.mean(-picked
                                             * class_w[target_classes])

        # ---- shared target slices -----------------------------------------
        t_root = t_kpts[:, :, :, :1]
        t_root_vis = t_root[..., 2:3]
        t_joint = t_kpts[:, :, :, 1:, 0:2]
        t_joint_vis = t_kpts[:, :, :, 1:, 2:3]
        t_root_d = t_depth[:, :, :, :1, 0:1]
        t_root_d_exist = t_depth[:, :, :, :1, 1:2]
        t_joint_d = t_depth[:, :, :, 1:, 0:1]
        t_joint_d_exist = t_depth[:, :, :, 1:, 1:2]

        p_root = p_kpts[:, :, :, :1]
        p_root_d = p_depth[:, :, :, :1]
        p_joint_vis = p_kpts[:, :, :, 1:, 2:3]
        p_joint = p_kpts[:, :, :, 1:, 0:2] + p_root[..., 0:2]
        p_joint_disp = p_kpts[:, :, :, 1:, 0:2]
        p_joint_d = p_root_d + p_depth[:, :, :, 1:] / self.max_depth
        p_joint_d_disp = p_depth[:, :, :, 1:]

        vmask = valid[:, :, None]  # [B, M, 1] for per-target [B, M, c] terms

        def norm_sum(err, w):
            # err, w: [B, M, T, J, c]; per-target normalize, sum, / num_traj
            per = (torch.sum(w * err, (-2, -3))
                   / (torch.sum(w, (-2, -3)) + EPS))          # [B, M, c]
            return torch.sum(per * vmask) / num_traj

        # ---- root (:288-324) ----------------------------------------------
        losses["loss_root"] = norm_sum(
            torch.abs(p_root[..., 0:2] - t_root[..., 0:2]), t_root_vis)
        losses["loss_root_depth"] = norm_sum(
            torch.abs(p_root_d - t_root_d), t_root_d_exist)
        losses["loss_root_vis"] = torch.sum(
            torch.mean((p_root[..., 2:3] - t_root_vis) ** 2, (-2, -3))
            * vmask) / num_traj

        # ---- joint (:326-362) ---------------------------------------------
        losses["loss_joint"] = norm_sum(
            torch.abs(p_joint - t_joint), t_joint_vis)
        losses["loss_joint_depth"] = norm_sum(
            torch.abs(p_joint_d - t_joint_d), t_joint_d_exist)
        losses["loss_joint_vis"] = torch.sum(
            torch.mean((p_joint_vis - t_joint_vis) ** 2, (-2, -3))
            * vmask) / num_traj

        # ---- joint displacement (:364-399) --------------------------------
        disp_vis = t_joint_vis * t_root_vis
        t_disp = t_joint - t_root[..., 0:2]
        losses["loss_joint_disp"] = norm_sum(
            torch.abs(p_joint_disp - t_disp), disp_vis)
        d_exist = t_joint_d_exist * t_root_d_exist
        t_d_disp = t_joint_d - t_root_d
        losses["loss_joint_depth_disp"] = norm_sum(
            torch.abs(p_joint_d_disp - t_d_disp), d_exist)

        # ---- temporal continuity (:401-427) -------------------------------
        d_abs = torch.cat([p_root_d, p_joint_d], 3)             # [B,M,T,K,1]
        kepts = torch.cat([p_kpts[..., 0:2], d_abs], -1)        # [B,M,T,K,3]
        root_sg = kepts[:, :, :, :1].detach()
        kepts = torch.cat([kepts[:, :, :, :1], kepts[:, :, :, 1:] - root_sg],
                          3)
        cont_vis = t_kpts[:, :, 1:, :, 2:3] * t_kpts[:, :, :-1, :, 2:3]
        cont_w = device_constant(
            ROOT_JOINT_CONT[: self.cfg.num_kpts], kepts)[:, None]  # [K, 1]
        err = cont_w * cont_vis * (kepts[:, :, 1:] - kepts[:, :, :-1]) ** 2
        per = (torch.sum(err, (-2, -3))
               / (torch.sum(cont_vis, (-2, -3)) + EPS))
        losses["loss_cont"] = torch.sum(per * vmask) / num_traj
        return losses

    def _loss_heatmap(self, heatmaps, targets) -> torch.Tensor:
        """Reference ``loss_heatmap`` (:429-446): per level, MSE *sum*
        against the blurred GT maps repeated per head, divided by nhead."""
        total = 0.0
        for hm in heatmaps:
            B, t, h, w, nhead, K = hm.shape
            tgt = heatmap_targets(targets["kpts2d"], targets["valid"], t, h,
                                  w)
            err = (hm.to(torch.float32) - tgt[:, :, :, :, None, :]) ** 2
            total = total + torch.sum(err) / nhead
        return total / self.dp_size

    # ---------------------------------------------------------------- call
    def __call__(
        self,
        outputs: Dict[str, torch.Tensor],
        targets: Dict[str, torch.Tensor],
        num_traj: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
        """Returns ``(total weighted loss, loss dict, src_idx of the final
        layer)``. ``num_traj``: an external normalizer used as it is (the
        accumulation window's ``max(total_valid / k, 1)``,
        ``train/engine.py::inject_window_num_traj``); by default the
        batch's valid count (over a mesh, the data group's mean count)
        clamped to >= 1."""
        if num_traj is None:
            num_traj = torch.sum(targets["valid"].to(torch.float32))
            group = None if self.mesh is None else self.mesh.data_group
            if group is not None:
                dist.all_reduce(num_traj, group=group)
                num_traj = num_traj / self.mesh.dp
            num_traj = torch.clamp(num_traj, min=1.0)
        else:
            num_traj = torch.as_tensor(num_traj, dtype=torch.float32,
                                       device=outputs["pred_logits"].device)

        layers = [(outputs["pred_logits"], outputs["pred_kpts2d"],
                   outputs["pred_depth"])]
        n_aux = (outputs["aux_logits"].shape[0]
                 if "aux_logits" in outputs else 0)
        layers += [(outputs["aux_logits"][i], outputs["aux_kpts2d"][i],
                    outputs["aux_depth"][i]) for i in range(n_aux)]
        src = match_layers(layers, targets, self.max_depth,
                           self.match_weights)

        losses = self._loss_set(*layers[0], targets, src[0], num_traj)
        if "heatmaps" in outputs:
            losses["loss_heatmap"] = self._loss_heatmap(outputs["heatmaps"],
                                                        targets)
        for i in range(n_aux):
            aux = self._loss_set(*layers[1 + i], targets, src[1 + i],
                                 num_traj)
            for k, v in aux.items():
                losses[f"{k}_{i}"] = v

        total = 0.0
        for k, v in losses.items():
            base = k.rsplit("_", 1)
            w = self.weights.get(k)
            if w is None and base[-1].isdigit():
                w = self.weights.get(base[0])
            total = total + (w if w is not None else 0.0) * v
        return total, losses, src[0]
