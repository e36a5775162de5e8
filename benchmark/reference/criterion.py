"""The plain reference of Snipper's training criterion (reference
``models/model.py:240-545``, ``models/matcher.py``): the Hungarian
trajectory matching and the losses, in f32.

The matching cost of a query against a target trajectory sums, over the
frames and joints the target shows, the class term and L1 terms of the
root, joints, depths and visibilities (weights ``set_cost_*``). The
assignment is scipy's ``linear_sum_assignment`` over the real targets of
each sample (the program's padding slots cost nothing and match leftover
queries; they enter no loss). The losses: ``is_human`` (cross-entropy with
the empty class weighted ``eos_coef``, over every (query, frame)), the root,
joint, displacement and depth L1 terms normalised per target and by the
batch's target count, the visibility MSEs, temporal continuity, and the
encoder heatmap MSE against Gaussian-blurred keypoint maps; the same terms
of every earlier decoder layer as auxiliary losses.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

EPS = 1e-5
ROOT_JOINT_CONT = (0, 0.2, 0.8, 0.8, 0.8, 0.2, 0.2, 0.1, 0.1, 0.8, 0.8, 0.2,
                   0.2, 0.1, 0.1)


def loss_weights(cfg: dict) -> Dict[str, float]:
    d = cfg["max_depth"] > 0
    return {
        "loss_is_human": cfg["is_human_loss_coef"],
        "loss_root": cfg["root_loss_coef"],
        "loss_root_vis": cfg["root_vis_loss_coef"],
        "loss_root_depth": cfg["root_depth_loss_coef"] if d else 0.0,
        "loss_joint_disp": cfg["joint_disp_loss_coef"],
        "loss_joint_depth_disp": cfg["joint_disp_depth_loss_coef"] if d
        else 0.0,
        "loss_joint": cfg["joint_loss_coef"],
        "loss_joint_vis": cfg["joint_vis_loss_coef"],
        "loss_joint_depth": cfg["joint_depth_loss_coef"] if d else 0.0,
        "loss_cont": cfg["cont_loss_coef"],
        "loss_heatmap": cfg["heatmap_loss_coef"],
    }


def cost_matrix(logits, kpts2d, depth, t_kpts, t_depth, cfg) -> torch.Tensor:
    """``[B, n_queries, M]`` matching cost, f32."""
    d = cfg["max_depth"] > 0
    prob = torch.softmax(logits.float(), -1)[..., 1]
    p_k = kpts2d.float()[:, :, None]
    p_d = depth.float()[:, :, None]
    p_root = p_k[..., :1, :]
    p_joint = p_k[..., 1:, 0:2] + p_root[..., 0:2]
    p_root_d = p_d[..., :1, :]
    p_joint_d = p_root_d + p_d[..., 1:, :] / cfg["max_depth"]
    t_k = t_kpts.float()[:, None]
    t_d = t_depth.float()[:, None]
    t_root = t_k[..., :1, :]
    t_root_vis = t_root[..., 2:3]
    t_joint_vis = t_k[..., 1:, 2:3]

    def l1(err, w):
        dims = (-1, -2, -3)
        return torch.sum(torch.abs(w * err), dims) / (torch.sum(w, dims)
                                                      + EPS)

    frame_vis = (torch.sum(t_joint_vis, (-2, -1)) > 0).float()
    c_class = -torch.sum(prob[:, :, None] * frame_vis, -1) / (
        torch.sum(frame_vis, -1) + EPS)
    cost = (cfg["set_cost_is_human"] * c_class
            + cfg["set_cost_root"] * l1(p_root[..., 0:2] - t_root[..., 0:2],
                                        t_root_vis)
            + cfg["set_cost_root_vis"] * torch.mean(
                (p_root[..., 2:3] - t_root_vis) ** 2, (-1, -2, -3))
            + cfg["set_cost_joint"] * l1(p_joint - t_k[..., 1:, 0:2],
                                         t_joint_vis)
            + cfg["set_cost_joint_vis"] * torch.mean(
                (p_k[..., 1:, 2:3] - t_joint_vis) ** 2, (-1, -2, -3)))
    if d:
        cost = cost + cfg["set_cost_root_depth"] * l1(
            p_root_d - t_d[..., :1, 0:1], t_d[..., :1, 1:2])
        cost = cost + cfg["set_cost_joint_depth"] * l1(
            p_joint_d - t_d[..., 1:, 0:1], t_d[..., 1:, 1:2])
    return cost


def assign(cost: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
    """``src [B, M]``: the query of each real target (scipy's optimal
    assignment over the real targets), -1 on a padding slot."""
    from scipy.optimize import linear_sum_assignment

    c = cost.detach().double().cpu().numpy()
    v = valid.bool().cpu().numpy()
    src = np.full(v.shape, -1, np.int64)
    for b in range(c.shape[0]):
        cols = np.flatnonzero(v[b])
        if cols.size:
            rows, tc = linear_sum_assignment(c[b][:, cols])
            src[b, cols[tc]] = rows
    return src


def _gather(pred, src):
    idx = src.reshape(src.shape + (1,) * (pred.dim() - 2))
    return torch.gather(pred, 1, idx.expand(src.shape + pred.shape[2:]))


def loss_set(logits, kpts2d, depth, targets, src, num_traj, cfg,
             share=1.0):
    """The losses of one decoder layer. ``share``: the share of the
    batch's rows that ``targets`` hold, which scales the class term's
    mean (the other terms are sums over ``num_traj``)."""
    t_k = targets["kpts2d"].float()
    t_d = targets["depth"].float()
    valid_b = targets["valid"].bool()
    valid = valid_b.float()
    B, n, T, _ = logits.shape
    src_c = src.clamp(min=0)
    p_k = _gather(kpts2d, src_c).float()
    p_d = _gather(depth, src_c).float()
    out = {}

    vis_frame = (torch.sum(t_k[..., 2], 3) > 0).long()
    onehot = ((src_c[:, :, None] == torch.arange(n, device=src.device)
               [None, None]) & valid_b[:, :, None])
    classes = torch.sum(onehot[..., None].long() * vis_frame[:, :, None, :],
                        1)
    logp = torch.log_softmax(logits.float(), -1)
    class_w = torch.tensor([cfg["eos_coef"], 1.0], device=logp.device)
    picked = torch.gather(logp, -1, classes[..., None])[..., 0]
    out["loss_is_human"] = torch.mean(-picked * class_w[classes]) * share

    t_root = t_k[:, :, :, :1]
    t_root_vis = t_root[..., 2:3]
    t_joint = t_k[:, :, :, 1:, 0:2]
    t_joint_vis = t_k[:, :, :, 1:, 2:3]
    t_root_d, t_root_de = t_d[:, :, :, :1, 0:1], t_d[:, :, :, :1, 1:2]
    t_joint_d, t_joint_de = t_d[:, :, :, 1:, 0:1], t_d[:, :, :, 1:, 1:2]
    p_root = p_k[:, :, :, :1]
    p_root_d = p_d[:, :, :, :1]
    p_joint_vis = p_k[:, :, :, 1:, 2:3]
    p_joint = p_k[:, :, :, 1:, 0:2] + p_root[..., 0:2]
    p_joint_disp = p_k[:, :, :, 1:, 0:2]
    p_joint_d = p_root_d + p_d[:, :, :, 1:] / cfg["max_depth"]
    p_joint_d_disp = p_d[:, :, :, 1:]
    vmask = valid[:, :, None]

    def norm_sum(err, w):
        per = torch.sum(w * err, (-2, -3)) / (torch.sum(w, (-2, -3)) + EPS)
        return torch.sum(per * vmask) / num_traj

    out["loss_root"] = norm_sum(torch.abs(p_root[..., 0:2]
                                          - t_root[..., 0:2]), t_root_vis)
    out["loss_root_depth"] = norm_sum(torch.abs(p_root_d - t_root_d),
                                      t_root_de)
    out["loss_root_vis"] = torch.sum(torch.mean(
        (p_root[..., 2:3] - t_root_vis) ** 2, (-2, -3)) * vmask) / num_traj
    out["loss_joint"] = norm_sum(torch.abs(p_joint - t_joint), t_joint_vis)
    out["loss_joint_depth"] = norm_sum(torch.abs(p_joint_d - t_joint_d),
                                       t_joint_de)
    out["loss_joint_vis"] = torch.sum(torch.mean(
        (p_joint_vis - t_joint_vis) ** 2, (-2, -3)) * vmask) / num_traj
    out["loss_joint_disp"] = norm_sum(
        torch.abs(p_joint_disp - (t_joint - t_root[..., 0:2])),
        t_joint_vis * t_root_vis)
    out["loss_joint_depth_disp"] = norm_sum(
        torch.abs(p_joint_d_disp - (t_joint_d - t_root_d)),
        t_joint_de * t_root_de)

    d_abs = torch.cat([p_root_d, p_joint_d], 3)
    k3 = torch.cat([p_k[..., 0:2], d_abs], -1)
    root_sg = k3[:, :, :, :1].detach()
    k3 = torch.cat([k3[:, :, :, :1], k3[:, :, :, 1:] - root_sg], 3)
    cont_vis = t_k[:, :, 1:, :, 2:3] * t_k[:, :, :-1, :, 2:3]
    cont_w = torch.tensor(ROOT_JOINT_CONT[:cfg["num_kpts"]],
                          device=k3.device)[:, None]
    err = cont_w * cont_vis * (k3[:, :, 1:] - k3[:, :, :-1]) ** 2
    per = torch.sum(err, (-2, -3)) / (torch.sum(cont_vis, (-2, -3)) + EPS)
    out["loss_cont"] = torch.sum(per * vmask) / num_traj
    return out


def blur_matrix(size: int, ksize: int) -> np.ndarray:
    """A reflect-padded 1D Gaussian blur as a ``[size, size]`` matrix
    (``torchvision`` ``gaussian_blur``'s kernel and sigma)."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) * 0.5
    x = np.linspace(-half, half, ksize)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    m = np.zeros((size, size), np.float32)
    period = max(2 * size - 2, 1)
    for i in range(size):
        for j in range(ksize):
            r = (i + j - ksize // 2) % period if size > 1 else 0
            r = r if r < size else period - r
            m[i, r] += k[j]
    return m


def heatmap_targets(kpts2d, valid, T, h, w):
    """``[B, T, h, w, K]``: 1 where a visible keypoint of a real target
    falls (coordinates truncated toward zero), blurred."""
    B, M, _, K, _ = kpts2d.shape
    k = kpts2d[:, :, :T].float()
    x = torch.trunc(k[..., 0] * w).long()
    y = torch.trunc(k[..., 1] * h).long()
    ok = ((k[..., 2] > 0) & valid[:, :, None, None].bool() & (x >= 0)
          & (x < w) & (y >= 0) & (y < h))
    maps = torch.zeros(B, T, h, w, K, device=kpts2d.device)
    b, m, t, j = torch.nonzero(ok, as_tuple=True)
    maps[b, t, y[b, m, t, j], x[b, m, t, j], j] = 1.0
    ks = max(max(h // 10 + (h // 10) % 2 - 1, w // 10 + (w // 10) % 2 - 1),
             1)
    by = torch.from_numpy(blur_matrix(h, ks)).to(maps.device)
    bx = torch.from_numpy(blur_matrix(w, ks)).to(maps.device)
    maps = torch.einsum("ij,btjwk->btiwk", by, maps)
    return torch.einsum("ij,btujk->btuik", bx, maps)


def criterion(out: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
              cfg: dict, batch_valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                         List[np.ndarray]]:
    """``(total, losses, src per layer, the last layer's first)``.

    ``batch_valid``: the whole batch's ``valid`` where ``out`` and
    ``targets`` are a block of its rows. The block's losses then take the
    whole batch's normalisers (``num_traj`` from the whole batch, the class
    term's mean scaled by the block's share of the rows; the heatmap term
    is a sum), so that the blocks' totals and gradients sum to the whole
    batch's. The matching is per sample, so blocks leave it as it is."""
    valid = targets["valid"]
    whole = valid if batch_valid is None else batch_valid
    num_traj = torch.clamp(torch.sum(whole.float()), min=1.0)
    share = valid.shape[0] / whole.shape[0]
    layers = [(out["pred_logits"], out["pred_kpts2d"], out["pred_depth"])]
    n_aux = out["aux_logits"].shape[0] if "aux_logits" in out else 0
    layers += [(out["aux_logits"][i], out["aux_kpts2d"][i],
                out["aux_depth"][i]) for i in range(n_aux)]
    srcs = []
    for lg, kp, dp in layers:
        with torch.no_grad():
            c = cost_matrix(lg, kp, dp, targets["kpts2d"], targets["depth"],
                            cfg)
        srcs.append(assign(c, valid))
    dev = valid.device
    losses = loss_set(*layers[0], targets, torch.from_numpy(srcs[0]).to(dev),
                      num_traj, cfg, share)
    hm = 0.0
    for m in out["heatmaps"]:
        B, T, h, w, nh, K = m.shape
        tgt = heatmap_targets(targets["kpts2d"], valid, T, h, w)
        hm = hm + torch.sum((m.float() - tgt[..., None, :]) ** 2) / nh
    losses["loss_heatmap"] = hm
    for i in range(n_aux):
        aux = loss_set(*layers[1 + i], targets,
                       torch.from_numpy(srcs[1 + i]).to(dev), num_traj, cfg,
                       share)
        losses.update({f"{k}_{i}": v for k, v in aux.items()})
    weights = loss_weights(cfg)
    total = 0.0
    for k, v in losses.items():
        base = k.rsplit("_", 1)
        w = weights.get(k)
        if w is None and base[-1].isdigit():
            w = weights.get(base[0])
        total = total + (w or 0.0) * v
    return total, losses, srcs
