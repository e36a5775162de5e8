"""Hungarian trajectory matching on the model's device: the cost matrix
in torch, the assignment by the ``lsa_rows`` kernel.

Counterpart of ``snipper_tpu/matching/matcher.py``. The cost is built term
by term as there (``cost_matrix``, ``:42-97``, the reference's
``HungarianMatcher.forward`` terms with eps = 1e-5), and padding columns
are zeroed by ``valid`` (``:228``) so that padding slots never compete
with real targets for queries. The JAX package solves the assignment on
the device with a Jonker-Volgenant solver in XLA loops (``_lsa_rows`` and
``hungarian``, ``:103-180``), so that its train step stays one program,
and keeps scipy as a host cross-check (``hungarian_scipy``, ``:183-195``).
The port does the same: :func:`match_layers` builds the costs of the final
and of every auxiliary decoder layer and, with ``solver="jax"`` (the
default), solves all of them in one launch of the ``lsa_rows`` kernel
(``ops/lsa.py``), JAX's algorithm step for step, so the indices are JAX's
on every slot, ties included, and stay on the device: the step has no host
round trip. ``solver="scipy"`` copies the costs to the host once and runs
``scipy.optimize.linear_sum_assignment`` per problem, as the original
Snipper does; it breaks ties another way.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from snipper_tpu_torch.ops.lsa import lsa_rows

EPS = 1e-5


def cost_matrix(
    pred_logits: torch.Tensor,   # [B, n, T, 2]
    pred_kpts2d: torch.Tensor,   # [B, n, T, K, 3]
    pred_depth: torch.Tensor,    # [B, n, T, K, 1]
    tgt_kpts2d: torch.Tensor,    # [B, m, T, K, 3]
    tgt_depth: torch.Tensor,     # [B, m, T, K, 2] (value, exists)
    max_depth: float,
    weights: Dict[str, float],
) -> torch.Tensor:
    """Batched matching cost ``[B, n, m]`` in f32."""
    f32 = torch.float32
    prob = torch.softmax(pred_logits.to(f32), -1)[..., 1]        # [B, n, T]

    # predictions expanded over targets: [B, n, 1, ...]
    p_kpts = pred_kpts2d.to(f32)[:, :, None]
    p_depth = pred_depth.to(f32)[:, :, None]
    p_root = p_kpts[:, :, :, :, :1]                    # [B,n,1,T,1,3]
    p_joint_vis = p_kpts[:, :, :, :, 1:, 2:3]
    p_joint = p_kpts[:, :, :, :, 1:, 0:2] + p_root[..., 0:2]
    p_root_d = p_depth[:, :, :, :, :1]
    p_joint_d = p_root_d + p_depth[:, :, :, :, 1:] / max_depth

    # targets expanded over predictions: [B, 1, m, ...]
    t_kpts = tgt_kpts2d.to(f32)[:, None]
    t_depth = tgt_depth.to(f32)[:, None]
    t_root = t_kpts[:, :, :, :, :1]
    t_root_vis = t_root[..., 2:3]
    t_joint = t_kpts[:, :, :, :, 1:, 0:2]
    t_joint_vis = t_kpts[:, :, :, :, 1:, 2:3]
    t_root_d = t_depth[:, :, :, :, :1, 0:1]
    t_root_d_exist = t_depth[:, :, :, :, :1, 1:2]
    t_joint_d = t_depth[:, :, :, :, 1:, 0:1]
    t_joint_d_exist = t_depth[:, :, :, :, 1:, 1:2]

    def norm_l1(err, w, dims=(-1, -2, -3)):
        return (torch.sum(torch.abs(w * err), dims)
                / (torch.sum(w, dims) + EPS))

    # class: -(prob * frame_vis).sum / frame_vis.sum
    frame_vis = (torch.sum(t_joint_vis, (-2, -1)) > 0).to(f32)  # [B,1,m,T]
    c_class = -torch.sum(prob[:, :, None] * frame_vis, -1) / (
        torch.sum(frame_vis, -1) + EPS)

    c_joint = norm_l1(p_joint - t_joint, t_joint_vis)
    c_joint_vis = torch.mean((p_joint_vis - t_joint_vis) ** 2, (-1, -2, -3))
    c_joint_d = norm_l1(p_joint_d - t_joint_d, t_joint_d_exist)
    c_root = norm_l1(p_root[..., 0:2] - t_root[..., 0:2], t_root_vis)
    c_root_vis = torch.mean((p_root[..., 2:3] - t_root_vis) ** 2,
                            (-1, -2, -3))
    c_root_d = norm_l1(p_root_d - t_root_d, t_root_d_exist)

    return (weights["is_human"] * c_class
            + weights["root"] * c_root
            + weights["root_vis"] * c_root_vis
            + weights["root_depth"] * c_root_d
            + weights["joint"] * c_joint
            + weights["joint_vis"] * c_joint_vis
            + weights["joint_depth"] * c_joint_d)


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """Batched LSAP on the cost's device: ``cost [B, n_queries, m_targets]``
    f32 (m <= n). Returns ``src_idx [B, m]`` int64, the query assigned to
    each target: rows are the targets, columns the queries (JAX's
    ``hungarian``, ``:176-180``), the transpose a view."""
    return lsa_rows(cost.transpose(1, 2))


def hungarian_scipy(cost: np.ndarray) -> np.ndarray:
    """Batched LSAP on the host: ``cost [B, n_queries, m_targets]``
    (m <= n). Returns ``src_idx [B, m]``, the query assigned to each
    target."""
    from scipy.optimize import linear_sum_assignment

    out = np.zeros(cost.shape[:1] + (cost.shape[2],), np.int64)
    for b in range(cost.shape[0]):
        rows, cols = linear_sum_assignment(cost[b])
        out[b, cols] = rows
    return out


def match_layers(
    layers: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    targets: Dict[str, torch.Tensor],
    max_depth: float,
    weights: Dict[str, float],
    solver: str = "jax",
) -> List[torch.Tensor]:
    """Match every decoder layer's predictions ``(logits, kpts2d, depth)``
    to the padded targets (``kpts2d [B, M, T, K, 3]``, ``depth
    [B, M, T, K, 2]``, ``valid [B, M]``). Returns one ``src_idx [B, M]``
    (int64, on the predictions' device) per layer: the query matched to
    each padded target slot. ``solver="jax"`` solves every layer's problems
    in one :func:`hungarian` call (one kernel launch on a card, nothing
    read back); ``"scipy"`` on the host, the costs of all layers in one
    copy. A ``torch.profiler`` trace shows the whole call as the host span
    ``match_layers``."""
    if solver not in ("jax", "scipy"):
        # a typo must not silently select the host path (it would add a
        # device->host sync to every step)
        raise ValueError(f"unknown solver {solver!r}; choose 'jax' "
                         "(on-device JV) or 'scipy' (host callback)")
    with torch.profiler.record_function("match_layers"):
        return _match_layers(layers, targets, max_depth, weights, solver)


def _match_layers(layers, targets, max_depth, weights, solver):
    with torch.no_grad():
        valid = targets["valid"].to(torch.float32)[:, None, :]
        cost = torch.stack([
            cost_matrix(lg, kp, dp, targets["kpts2d"], targets["depth"],
                        max_depth, weights) * valid
            for lg, kp, dp in layers])                  # [nl, B, n, M]
        if solver == "jax":
            nl, B, n, M = cost.shape
            return list(hungarian(cost.reshape(nl * B, n, M))
                        .view(nl, B, M).unbind(0))
        cost_np = cost.cpu().numpy()
    src = np.stack([hungarian_scipy(c) for c in cost_np])
    src_t = torch.from_numpy(src)
    device = layers[0][0].device
    if device.type == "cuda":
        src_t = src_t.pin_memory().to(device, non_blocking=True)
    return list(src_t.unbind(0))
