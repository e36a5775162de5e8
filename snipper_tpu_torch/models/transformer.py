"""Temporal deformable transformer (encoder/decoder).

Counterpart of ``snipper_tpu/models/transformer.py``, with the same module
and parameter names. Dropout sits at the JAX modules' ``nn.Dropout`` sites
(``transformer.py:169,205,211,214,242,253,259,262``) and is active only in
``module.train()``. The JAX package rematerializes each layer
(``nn.remat``) because its XLA sampling saves large one-hot intermediates;
the port's sampling kernel saves only its three inputs, so nothing here is
rematerialized.

With a mesh whose model axis is > 1 (``parallel/mesh.py::shard_model``),
each attention module keeps ``n_heads / tp`` heads and the FFN
``d_ffn / tp`` features: ``copy_to_model`` at each column-parallel input,
``row_parallel`` at each row-parallel output. ``mesh`` is None otherwise,
and the forward is the single-device one.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from snipper_tpu_torch.models.init import fill_, tag
from snipper_tpu_torch.ops.deform_attn import (device_constant,
                                               temporal_adjacency,
                                               temporal_deform_sample)
from snipper_tpu_torch.parallel.mesh import (copy_to_model, dropout_shard,
                                             row_parallel)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Matches reference ``util/misc.py:481-485``."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


def _offset_bias_init(n_heads: int, n_levels: int,
                      n_points: int) -> np.ndarray:
    """Initial sampling offsets uniformly distributed over head directions,
    scaled by point index (reference ``ms_deform_attn.py:78-90``)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)      # [H, 2]
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class TemporalDeformAttn(nn.Module):
    """Multi-scale temporal deformable attention: one offset/weight
    projection pair shared by the sampled frames.

    ``sample_dtype`` is ``cfg.deform_dtype``, JAX's field of that name
    (``snipper_tpu/models/transformer.py:67,113-122``): with
    ``"float32"`` the value, the locations and the logits are cast to f32
    before the sampling, so that under bf16 the neighbour-frame sum, the
    softmax, the division by the frame count and the sampling run in f32
    (the f32-value kernels on the card); the output is cast back to the
    query's dtype before ``output_proj``. ``"auto"`` samples in the
    value's own dtype."""

    def __init__(self, d_model: int, n_levels: int, n_heads: int,
                 n_points: int, n_frames: int, impl: str = "xla",
                 sample_dtype: str = "auto"):
        super().__init__()
        self.impl = impl  # cfg.deform_impl: "skip" elides the sampling
        self.sample_dtype = sample_dtype
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.head_dim = d_model // n_heads
        self.n_frames = n_frames
        self.mesh = None
        H, L, P = n_heads, n_levels, n_points
        self.value_proj = tag(nn.Linear(d_model, d_model), "xavier")
        self.sampling_offsets = tag(
            nn.Linear(d_model, H * L * P * 2), "zeros",
            _offset_bias_init(H, L, P))
        self.attention_weights = tag(nn.Linear(d_model, H * L * P), "zeros")
        self.output_proj = tag(nn.Linear(d_model, d_model), "xavier")

    def set_mesh(self, mesh):
        """Run this rank's ``n_heads / tp`` heads of the model group."""
        self.mesh = mesh
        self.n_heads //= mesh.tp

    def forward(self, query, reference_points, value_feats, spatial_shapes,
                padding_mask=None, return_attn=False):
        # query [B, T1, Lq, C]; reference_points [B, T1, Lq, L, 2];
        # value_feats [B, T2, S, C]; padding_mask [B, T2, S] True = pad
        B, T1, Lq, C = query.shape
        _, T2, S, _ = value_feats.shape
        H, L, P = self.n_heads, self.n_levels, self.n_points
        D = self.head_dim

        value = self.value_proj(copy_to_model(value_feats, self.mesh))
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        value = value.reshape(B, T2, S, H, D)

        # every input of the heads' region is a column-parallel input
        query = copy_to_model(query, self.mesh)
        reference_points = copy_to_model(reference_points, self.mesh)
        off = self.sampling_offsets(query).reshape(B, T1, Lq, H, L, P, 2)
        # offsets are divided by (w, h) per level, x then y
        normalizer = device_constant([[w, h] for h, w in spatial_shapes],
                                     query)
        loc = (reference_points[:, :, :, None, :, None, :]
               + off / normalizer[None, None, None, None, :, None, :])

        logits = self.attention_weights(query).reshape(B, T1, Lq, H, L, P)
        adjacency = temporal_adjacency(self.n_frames, T1)
        if self.sample_dtype == "float32":
            value, loc, logits = value.float(), loc.float(), logits.float()
        out, overflow = temporal_deform_sample(value, spatial_shapes, loc,
                                               logits, adjacency, self.impl)
        # a no-op unless the sampling ran in f32 under a bf16 query
        out = row_parallel(self.output_proj, out.to(query.dtype), self.mesh)
        if return_attn:
            attn = torch.softmax(logits.reshape(B, T1, Lq, H, L * P),
                                 -1).reshape(B, T1, Lq, H, L, P)
            return out, overflow, (loc, attn)
        return out, overflow


class TorchMultiheadAttention(nn.Module):
    """Multi-head attention with torch's packed qkv parameters
    (``in_proj_weight [3C, C]``)."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.0):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.head_dim = d_model // n_heads
        self.dropout = dropout
        self.mesh = None
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = tag(nn.Linear(d_model, d_model), "xavier")

    def init_own_weights(self, generator):
        fill_(self.in_proj_weight, "xavier", generator)
        fill_(self.in_proj_bias, "zeros", generator)

    def set_mesh(self, mesh):
        """Run this rank's ``n_heads / tp`` heads of the model group (q, k
        and v each cut by heads in ``in_proj``)."""
        self.mesh = mesh
        self.n_heads //= mesh.tp

    def forward(self, q, k, v):
        # q, k, v: [B, N, C]; C = H * D here (this rank's heads)
        H, D = self.n_heads, self.head_dim
        C = H * D
        w, b = self.in_proj_weight, self.in_proj_bias
        q_in = copy_to_model(q, self.mesh)
        k_in = q_in if k is q else copy_to_model(k, self.mesh)
        v_in = copy_to_model(v, self.mesh)
        qh = F.linear(q_in, w[:C], b[:C]).reshape(*q.shape[:-1], H, D)
        kh = F.linear(k_in, w[C:2 * C], b[C:2 * C]).reshape(*k.shape[:-1],
                                                            H, D)
        vh = F.linear(v_in, w[2 * C:], b[2 * C:]).reshape(*v.shape[:-1], H,
                                                          D)
        # f32 logits and softmax on bf16 q and k, then bf16 probabilities,
        # as JAX's preferred_element_type=f32 and astype(vh.dtype)
        # (transformer.py:163-170); in f32 the casts are no-ops
        logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(),
                              kh.float()) / math.sqrt(D)
        probs = dropout_shard(torch.softmax(logits, dim=-1), self.dropout,
                              self.training, 1, self.mesh)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vh.dtype), vh)
        return row_parallel(self.out_proj, out.reshape(*q.shape[:-1], C),
                            self.mesh)


class EncoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points, n_frames,
                 dropout=0.1, impl="xla", sample_dtype="auto"):
        super().__init__()
        self.dropout = dropout
        self.self_attn = TemporalDeformAttn(d_model, n_levels, n_heads,
                                            n_points, n_frames, impl,
                                            sample_dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = tag(nn.Linear(d_model, d_ffn), "xavier")
        self.linear2 = tag(nn.Linear(d_ffn, d_model), "xavier")
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.mesh = None

    def set_mesh(self, mesh):
        """Run this rank's ``d_ffn / tp`` FFN features."""
        self.mesh = mesh

    def forward(self, src, pos, reference_points, spatial_shapes,
                padding_mask=None):
        p, train = self.dropout, self.training
        src2, overflow = self.self_attn(src + pos, reference_points, src,
                                        spatial_shapes, padding_mask)
        src = self.norm1(src + F.dropout(src2, p, train))
        h = F.relu(self.linear1(copy_to_model(src, self.mesh)))
        h = row_parallel(self.linear2,
                         dropout_shard(h, p, train, -1, self.mesh),
                         self.mesh)
        return self.norm2(src + F.dropout(h, p, train)), overflow


class DecoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points, n_frames,
                 dropout=0.1, impl="xla", sample_dtype="auto"):
        super().__init__()
        self.dropout = dropout
        self.self_attn = TorchMultiheadAttention(d_model, n_heads, dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = TemporalDeformAttn(d_model, n_levels, n_heads,
                                             n_points, n_frames, impl,
                                             sample_dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = tag(nn.Linear(d_model, d_ffn), "xavier")
        self.linear2 = tag(nn.Linear(d_ffn, d_model), "xavier")
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.mesh = None

    def set_mesh(self, mesh):
        """Run this rank's ``d_ffn / tp`` FFN features."""
        self.mesh = mesh

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes,
                src_padding_mask=None, return_attn=False):
        B, T1, Lq, C = tgt.shape
        p, train = self.dropout, self.training
        # self-attention over all T1*Lq tokens: q = k = tgt + pos, v = tgt;
        # norm2 follows it (transformer.py:236-243)
        t2d = tgt.reshape(B, T1 * Lq, C)
        qk = t2d + query_pos.reshape(B, T1 * Lq, C)
        t2d = t2d + F.dropout(self.self_attn(qk, qk, t2d), p, train)
        tgt = self.norm2(t2d).reshape(B, T1, Lq, C)

        # temporal deformable cross-attention, then norm1 (:247-254)
        res = self.cross_attn(tgt + query_pos, reference_points, src,
                              spatial_shapes, src_padding_mask,
                              return_attn=return_attn)
        tgt = self.norm1(tgt + F.dropout(res[0], p, train))

        # ffn, then norm3 (:257-263)
        h = F.relu(self.linear1(copy_to_model(tgt, self.mesh)))
        h = row_parallel(self.linear2,
                         dropout_shard(h, p, train, -1, self.mesh),
                         self.mesh)
        attn_data = res[2] if return_attn else None
        return self.norm3(tgt + F.dropout(h, p, train)), attn_data


def encoder_reference_points(
    spatial_shapes: Sequence[Tuple[int, int]],
    valid_ratios: torch.Tensor,  # [B, L, 2] (w_ratio, h_ratio)
) -> torch.Tensor:
    """Per-pixel reference points (reference ``get_reference_points``,
    ``deformable_transformer.py:219-232``). Returns ``[B, S, L, 2]``."""
    refs = []
    dev = valid_ratios.device
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
        rx = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        gy = gy.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)
        gx = gx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack((gx, gy), -1))          # [B, hw, 2]
    ref = torch.cat(refs, 1)                            # [B, S, 2]
    return ref[:, :, None] * valid_ratios[:, None]      # [B, S, L, 2]


class DeformableTransformer(nn.Module):
    """Top-level transformer (reference ``DeformableTransformer:20-167``)."""

    def __init__(self, d_model, n_heads, num_encoder_layers,
                 num_decoder_layers, dim_feedforward, num_feature_levels,
                 enc_n_points, dec_n_points, n_frames, n_future_frames,
                 num_keypoints, dropout=0.1, impl="xla",
                 sample_dtype="auto"):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.num_feature_levels = num_feature_levels
        self.n_frames, self.n_future_frames = n_frames, n_future_frames
        self.num_keypoints = num_keypoints
        L = num_feature_levels
        t_total = n_frames + n_future_frames
        self.level_embed = nn.Parameter(torch.empty(L, d_model))
        self.temporal_embed = nn.Parameter(torch.empty(t_total, d_model))
        for i in range(num_encoder_layers):
            setattr(self, f"encoder_layer{i}", EncoderLayer(
                d_model, dim_feedforward, L, n_heads, enc_n_points, n_frames,
                dropout, impl, sample_dtype))
        for i in range(num_decoder_layers):
            setattr(self, f"decoder_layer{i}", DecoderLayer(
                d_model, dim_feedforward, L, n_heads, dec_n_points, n_frames,
                dropout, impl, sample_dtype))
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.reference_points = tag(nn.Linear(d_model, 2), "xavier")
        # shared root head, also used for iterative refinement (reference
        # models/model.py:95-104)
        self.root_embed = nn.Linear(d_model, 4)

    def init_own_weights(self, generator):
        fill_(self.level_embed, "normal", generator)
        fill_(self.temporal_embed, "xavier", generator)

    def forward(self, srcs: List[torch.Tensor],
                masks: Optional[List[torch.Tensor]],
                pos_embeds: List[torch.Tensor], query_embed: torch.Tensor,
                return_attn: bool = False):
        # srcs, pos_embeds: per level [B, T, h, w, C]; masks per level
        # [B, T, h, w] True = pad; query_embed [num_queries*(T+Tf), 2C]
        with record_function("model.encoder"):
            B, T, _, _, C = srcs[0].shape
            L = self.num_feature_levels
            spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
            t_total = self.n_frames + self.n_future_frames

            src_flat = torch.cat([s.reshape(B, T, -1, C) for s in srcs], 2)
            pos_flat = torch.cat(
                [(p + self.level_embed[lvl]).reshape(B, T, -1, C)
                 for lvl, p in enumerate(pos_embeds)], 2)
            if masks is not None:
                mask_flat = torch.cat([m.reshape(B, T, -1) for m in masks], 2)
                # valid ratios from frame 0 (transformer.py:344-347)
                valid_ratios = torch.stack(
                    [torch.stack([(~m[:, 0, 0, :]).sum(1) / m.shape[3],
                                  (~m[:, 0, :, 0]).sum(1) / m.shape[2]], -1)
                     for m in masks], 1).float()           # [B, L, 2]
            else:
                mask_flat = None
                valid_ratios = torch.ones(B, L, 2, device=src_flat.device)

            # ---- encoder ---------------------------------------------------
            enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
            enc_ref = enc_ref[:, None].expand(B, T, *enc_ref.shape[1:])
            memory = src_flat
            sampling_overflow = 0
            for i in range(self.num_encoder_layers):
                memory, ov = getattr(self, f"encoder_layer{i}")(
                    memory, pos_flat, enc_ref, spatial_shapes, mask_flat)
                sampling_overflow += ov

            # ---- heatmaps: first num_keypoints channels of each head ------
            heatmaps = []
            start = 0
            hd = self.d_model // self.n_heads
            for (h, w) in spatial_shapes:
                m = memory[:, :, start:start + h * w]
                start += h * w
                m = m.reshape(B, T, h, w, self.n_heads, hd)
                heatmaps.append(m[..., : self.num_keypoints])

        with record_function("model.decoder"):
            # ---- decoder ---------------------------------------------------
            # first half of query_embed is query_pos, second query_obj, both
            # time-major (transformer.py:390-396)
            n_query = query_embed.shape[0] // t_total
            query_pos, query_obj = torch.split(query_embed, C, dim=-1)
            query_pos = query_pos.reshape(t_total, n_query, C)[None].expand(
                B, -1, -1, -1)
            query_pos = query_pos + self.temporal_embed[None, :, None, :]
            query_obj = query_obj.reshape(t_total, n_query, C)[None].expand(
                B, -1, -1, -1)

            reference_points = torch.sigmoid(self.reference_points(query_pos))
            init_reference = reference_points

            hs, refs_in, roots_raw, attn_all = [], [], [], []
            output = query_obj
            for i in range(self.num_decoder_layers):
                ref_input = (reference_points[:, :, :, None, :]
                             * valid_ratios[:, None, None, :, :])
                output, attn_data = getattr(self, f"decoder_layer{i}")(
                    output, query_pos, ref_input, memory, spatial_shapes,
                    mask_flat, return_attn=return_attn)
                root4 = self.root_embed(output)                 # [B, T1, q, 4]
                xy_logit = root4[..., 0:2] + inverse_sigmoid(reference_points)
                hs.append(output)
                refs_in.append(reference_points)
                roots_raw.append(torch.cat([xy_logit, root4[..., 2:4]], -1))
                attn_all.append(attn_data)
                # iterative refinement with a detached sigmoid (:434)
                reference_points = torch.sigmoid(xy_logit).detach()

            out = {
                "hs": torch.stack(hs),                   # [nl, B, T1, q, C]
                "roots_raw": torch.stack(roots_raw),     # [nl, B, T1, q, 4]
                "heatmaps": heatmaps,
                "init_reference": init_reference,
                "references": torch.stack(refs_in),
                "sampling_overflow": sampling_overflow,
            }
        if return_attn:
            out["attn_data"] = attn_all
        return out
