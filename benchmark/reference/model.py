"""The plain reference of the Snipper model: the forward pass written out
from the published architecture in plain PyTorch, in f32, over a flat dict
of named tensors.

Snipper (reference repository, ``models/model.py``,
``models/deformable_transformer.py``, ``models/ms_deform_attn.py``): a
frozen-BN ResNet-50 over the T observed frames, its stride 8/16/32 taps
projected by a 1x1 conv and GroupNorm(32) to the hidden width, a 3D sine
position encoding plus level embeddings, ``enc_layers`` encoder layers of
temporal multi-scale deformable self-attention (each query frame samples
its neighbour frames t-1, t, t+1 at every level and point with one shared
offset and weight projection), ``dec_layers`` decoder layers (self-attention
over all (frame, query) tokens, temporal deformable cross-attention into the
encoder memory, an FFN; the shared root head refines the reference points
after each layer), and the class and joint heads. Post-norm throughout.

Nothing here imports the program under test. The sampling is the textbook
bilinear ``grid_sample`` per level. Every matrix product and convolution
takes its operands through ``prec.q`` (``precision.py``), so that the same
code computes the reference (f32) and the lower-precision controls.

The names of the tensors are those of the published state dict as the
program under test lays it out, so that one dict of weights made by the
benchmark feeds both sides.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

RESNET_LAYERS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                 "resnet_test": (1, 1, 1, 1)}
BACKBONE_CHANNELS = (512, 1024, 2048)

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# parameter list: (name, shape, init)
# --------------------------------------------------------------------------
def offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Initial sampling offsets (reference ``ms_deform_attn.py:78-90``):
    one direction per head on the unit square's border, the point's index
    + 1 as its length."""
    th = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(th), np.sin(th)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every tensor of the model: name, shape and how it is initialised
    (``lecun``, ``xavier``, ``normal``, ``zeros``, ``ones``, ``offsets``,
    ``perturb``: see ``benchmark/weights.py``)."""
    C, H = cfg["hidden_dim"], cfg["nheads"]
    L, T, Tf = cfg["num_feature_levels"], cfg["num_frames"], \
        cfg["num_future_frames"]
    spec = []

    def bn(prefix, n):
        spec.extend([(f"{prefix}.weight", (n,), "ones"),
                     (f"{prefix}.bias", (n,), "zeros"),
                     (f"{prefix}.running_mean", (n,), "zeros"),
                     (f"{prefix}.running_var", (n,), "ones")])

    def lin(prefix, cin, cout, w="lecun", b="zeros"):
        spec.extend([(f"{prefix}.weight", (cout, cin), w),
                     (f"{prefix}.bias", (cout,), b)])

    def ln(prefix, n):
        spec.extend([(f"{prefix}.weight", (n,), "ones"),
                     (f"{prefix}.bias", (n,), "zeros")])

    spec.append(("backbone.conv1.weight", (64, 3, 7, 7), "lecun"))
    bn("backbone.bn1", 64)
    cin = 64
    for s, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                        RESNET_LAYERS[cfg["backbone"]])):
        for b in range(n):
            p = f"backbone.layer{s + 1}_{b}"
            spec.append((f"{p}.conv1.weight", (planes, cin, 1, 1), "lecun"))
            bn(f"{p}.bn1", planes)
            spec.append((f"{p}.conv2.weight", (planes, planes, 3, 3),
                         "lecun"))
            bn(f"{p}.bn2", planes)
            spec.append((f"{p}.conv3.weight", (planes * 4, planes, 1, 1),
                         "lecun"))
            bn(f"{p}.bn3", planes * 4)
            if b == 0:
                spec.append((f"{p}.downsample_conv.weight",
                             (planes * 4, cin, 1, 1), "lecun"))
                bn(f"{p}.downsample_bn", planes * 4)
            cin = planes * 4
    for lvl in range(L):
        spec.extend([(f"input_proj{lvl}.conv.weight",
                      (C, BACKBONE_CHANNELS[lvl], 1, 1), "lecun"),
                     (f"input_proj{lvl}.conv.bias", (C,), "zeros")])
        ln(f"input_proj{lvl}.norm", C)
    spec.append(("query_embed", (cfg["num_queries"] * (T + Tf), 2 * C),
                 "normal"))
    spec.append(("transformer.level_embed", (L, C), "normal"))
    spec.append(("transformer.temporal_embed", (T + Tf, C), "xavier"))

    def deform(prefix, n_points):
        lin(f"{prefix}.value_proj", C, C, "xavier")
        lin(f"{prefix}.sampling_offsets", C, H * L * n_points * 2,
            "perturb", "offsets")
        lin(f"{prefix}.attention_weights", C, H * L * n_points, "perturb")
        lin(f"{prefix}.output_proj", C, C, "xavier")

    F_ = cfg["dim_feedforward"]
    for i in range(cfg["enc_layers"]):
        p = f"transformer.encoder_layer{i}"
        deform(f"{p}.self_attn", cfg["enc_n_points"])
        ln(f"{p}.norm1", C)
        lin(f"{p}.linear1", C, F_, "xavier")
        lin(f"{p}.linear2", F_, C, "xavier")
        ln(f"{p}.norm2", C)
    for i in range(cfg["dec_layers"]):
        p = f"transformer.decoder_layer{i}"
        spec.extend([(f"{p}.self_attn.in_proj_weight", (3 * C, C), "xavier"),
                     (f"{p}.self_attn.in_proj_bias", (3 * C,), "zeros")])
        lin(f"{p}.self_attn.out_proj", C, C, "xavier")
        ln(f"{p}.norm2", C)
        deform(f"{p}.cross_attn", cfg["dec_n_points"])
        ln(f"{p}.norm1", C)
        lin(f"{p}.linear1", C, F_, "xavier")
        lin(f"{p}.linear2", F_, C, "xavier")
        ln(f"{p}.norm3", C)
    lin("transformer.reference_points", C, 2, "xavier")
    lin("transformer.root_embed", C, 4)
    lin("class_embed", C, 2, "lecun", "person")
    for j in range(cfg["num_kpts"] - 1):
        lin(f"joint_embed{j}", C, 4)
    return spec


def frozen(name: str) -> bool:
    """The tensors training leaves as they are (reference
    ``models/backbone.py:71-73``): the stem, ``layer1`` and every frozen
    BatchNorm statistic and affine."""
    parts = name.split(".")
    if parts[0] != "backbone":
        return False
    if any(p.startswith("bn") or p == "downsample_bn" for p in parts):
        return True
    return parts[1] in ("conv1", "bn1") or parts[1].startswith("layer1_")


def lr_group(name: str) -> str:
    """``backbone`` (the trained backbone), ``proj`` (the reference-point
    and sampling-offset projections) or ``main``: reference
    ``main.py:201-222``."""
    parts = name.split(".")
    if parts[0] == "backbone":
        return "backbone"
    if any(p in ("sampling_offsets", "reference_points") for p in parts):
        return "proj"
    return "main"


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------
def linear(x, P, prefix, prec: Precision):
    w, b = P[f"{prefix}.weight"], P[f"{prefix}.bias"]
    return F.linear(prec.q(x), prec.q(w), b)


def conv(x, w, prec: Precision, bias=None, stride=1, padding=0):
    return F.conv2d(prec.q(x), prec.q(w), bias, stride, padding)


def frozen_bn(x, P, prefix, eps=1e-5):
    scale = P[f"{prefix}.weight"] * torch.rsqrt(P[f"{prefix}.running_var"]
                                                + eps)
    shift = P[f"{prefix}.bias"] - P[f"{prefix}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def layer_norm(x, P, prefix):
    return F.layer_norm(x, x.shape[-1:], P[f"{prefix}.weight"],
                        P[f"{prefix}.bias"], 1e-5)


def resnet(P, x, layers, prec):
    """The stride 8, 16 and 32 taps of a frozen-BN ResNet on NCHW ``x``."""
    x = F.relu(frozen_bn(conv(x, P["backbone.conv1.weight"], prec, None, 2,
                              3), P, "backbone.bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    taps = []
    for s, n in enumerate(layers):
        for b in range(n):
            p = f"backbone.layer{s + 1}_{b}"
            stride = 2 if (b == 0 and s > 0) else 1
            out = F.relu(frozen_bn(conv(x, P[f"{p}.conv1.weight"], prec),
                                   P, f"{p}.bn1"))
            out = F.relu(frozen_bn(conv(out, P[f"{p}.conv2.weight"], prec,
                                        None, stride, 1), P, f"{p}.bn2"))
            out = frozen_bn(conv(out, P[f"{p}.conv3.weight"], prec), P,
                            f"{p}.bn3")
            if b == 0:
                x = frozen_bn(conv(x, P[f"{p}.downsample_conv.weight"], prec,
                                   None, stride), P, f"{p}.downsample_bn")
            x = F.relu(out + x)
        if s >= 1:
            taps.append(x)
    return taps


def position_encoding_3d(B, T, h, w, num_feats, device,
                         temperature=10000.0):
    """The sine encoding over (frame, row, column) of an unpadded input,
    ``[B, T, h, w, 3 * num_feats]``, channels (z, y, x), each axis's
    cumulative position normalised to [0, 2 pi]."""
    ones = torch.ones(B, T, h, w, device=device)
    eps, scale = 1e-6, 2 * math.pi
    embeds = []
    for axis in (1, 2, 3):
        e = ones.cumsum(axis)
        last = e.select(axis, e.shape[axis] - 1).unsqueeze(axis)
        embeds.append(e / (last + eps) * scale)
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_feats)
    feats = []
    for e in embeds:
        p = e[..., None] / dim_t
        if p.shape[-1] % 2:
            p = F.pad(p, (0, 1))
        f = torch.stack((p[..., 0::2].sin(), p[..., 1::2].cos()), -1)
        feats.append(f.flatten(-2)[..., :num_feats])
    return torch.cat(feats, -1)


def ms_deform_attn(value, shapes, loc, attn):
    """Multi-scale deformable sampling by ``grid_sample``: ``value [N, S, H,
    D]``, ``loc [N, Lq, H, L, P, 2]`` (x, y in [0, 1]), ``attn [N, Lq, H, L,
    P]`` -> ``[N, Lq, H * D]``; bilinear, zero outside the map, pixel
    centres at half-integers (``align_corners=False``)."""
    N, S, H, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    vals = value.split([h * w for h, w in shapes], dim=1)
    out = torch.zeros(N, Lq, H, D, dtype=value.dtype, device=value.device)
    for lvl, (h, w) in enumerate(shapes):
        v = vals[lvl].permute(0, 2, 3, 1).reshape(N * H, D, h, w)
        g = (2 * loc[:, :, :, lvl] - 1).permute(0, 2, 1, 3, 4)
        s = F.grid_sample(v, g.reshape(N * H, Lq, P, 2), mode="bilinear",
                          padding_mode="zeros", align_corners=False)
        s = s.reshape(N, H, D, Lq, P)
        a = attn[:, :, :, lvl].permute(0, 2, 1, 3)
        out = out + torch.einsum("nhdqp,nhqp->nqhd", s, a)
    return out.reshape(N, Lq, H * D)


def adjacency(n_frames: int, n_total: int) -> np.ndarray:
    """``[T1, T2]``: observed query frame t samples observed frames t-1, t,
    t+1; a future query frame samples every observed frame."""
    adj = np.zeros((n_total, n_frames), np.float32)
    for t1 in range(n_total):
        if t1 < n_frames:
            for t2 in (t1 - 1, t1, t1 + 1):
                if 0 <= t2 < n_frames:
                    adj[t1, t2] = 1.0
        else:
            adj[t1, :] = 1.0
    return adj


def temporal_deform_attn(P, prefix, query, ref, value_feats, shapes, cfg,
                         n_points, prec, msda):
    """``query [B, T1, Lq, C]``, ``ref [B, T1, Lq, L, 2]``, ``value_feats
    [B, T2, S, C]``. The softmax over (level, point) divided by the number
    of sampled frames is the reference's joint softmax over (level, point,
    frame) for a projection shared by the frames; by linearity the frames'
    values are summed before one sampling."""
    B, T1, Lq, C = query.shape
    _, T2, S, _ = value_feats.shape
    H, L = cfg["nheads"], cfg["num_feature_levels"]
    D = C // H
    value = linear(value_feats, P, f"{prefix}.value_proj", prec)
    value = value.reshape(B, T2, S, H, D)
    off = linear(query, P, f"{prefix}.sampling_offsets", prec).reshape(
        B, T1, Lq, H, L, n_points, 2)
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=query.device)
    loc = ref[:, :, :, None, :, None, :] + off / norm[:, None, :]
    logits = linear(query, P, f"{prefix}.attention_weights", prec)
    attn = torch.softmax(logits.reshape(B, T1, Lq, H, L * n_points), -1)
    adj = adjacency(cfg["num_frames"], T1)
    counts = torch.tensor(adj.sum(1), dtype=torch.float32,
                          device=query.device)
    attn = (attn / counts[None, :, None, None, None]).reshape(
        B, T1, Lq, H, L, n_points)
    v_agg = torch.stack([sum(value[:, t2] for t2 in range(T2)
                             if adj[t1, t2] > 0) for t1 in range(T1)], 1)
    out = msda(v_agg.reshape(B * T1, S, H, D), shapes,
               loc.reshape(B * T1, Lq, H, L, n_points, 2),
               attn.reshape(B * T1, Lq, H, L, n_points))
    return linear(out.reshape(B, T1, Lq, C), P, f"{prefix}.output_proj",
                  prec)


def self_attention(P, prefix, qk, v, H, prec):
    """Packed-qkv multi-head attention over ``[B, N, C]`` tokens."""
    C = qk.shape[-1]
    D = C // H
    w, b = P[f"{prefix}.in_proj_weight"], P[f"{prefix}.in_proj_bias"]
    shape = qk.shape[:-1] + (H, D)
    qh = F.linear(prec.q(qk), prec.q(w[:C]), b[:C]).reshape(shape)
    kh = F.linear(prec.q(qk), prec.q(w[C:2 * C]), b[C:2 * C]).reshape(shape)
    vh = F.linear(prec.q(v), prec.q(w[2 * C:]), b[2 * C:]).reshape(shape)
    logits = torch.einsum("bqhd,bkhd->bhqk", prec.q(qh), prec.q(kh))
    probs = torch.softmax(logits / math.sqrt(D), -1)
    out = torch.einsum("bhqk,bkhd->bqhd", prec.q(probs), prec.q(vh))
    return linear(out.reshape(qk.shape), P, f"{prefix}.out_proj", prec)


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


# --------------------------------------------------------------------------
# the forward pass
# --------------------------------------------------------------------------
def forward(P: Params, images: torch.Tensor, cfg: dict,
            prec: Precision = Precision(),
            msda: Callable = ms_deform_attn) -> Dict[str, torch.Tensor]:
    """``images [B, T, H, W, 3]`` in [0, 1] -> the model's outputs:
    ``pred_logits [B, q, T1, 2]``, ``pred_kpts2d [B, q, T1, K, 3]``,
    ``pred_depth [B, q, T1, K, 1]`` of the last decoder layer, the same of
    the earlier layers under ``aux_*``, and the encoder's ``heatmaps``
    (per level ``[B, T, h, w, heads, K]``)."""
    B, T, Hi, Wi, _ = images.shape
    C, H, K = cfg["hidden_dim"], cfg["nheads"], cfg["num_kpts"]
    L = cfg["num_feature_levels"]
    if L != len(BACKBONE_CHANNELS):
        raise ValueError("the reference has the three backbone levels only")
    T1 = T + cfg["num_future_frames"]
    dev = images.device

    x = images.reshape(B * T, Hi, Wi, 3).permute(0, 3, 1, 2)
    taps = resnet(P, x, RESNET_LAYERS[cfg["backbone"]], prec)
    srcs, pos = [], []
    for lvl, tap in enumerate(taps):
        s = conv(tap, P[f"input_proj{lvl}.conv.weight"], prec,
                 P[f"input_proj{lvl}.conv.bias"])
        s = F.group_norm(s, 32, P[f"input_proj{lvl}.norm.weight"],
                         P[f"input_proj{lvl}.norm.bias"], 1e-5)
        s = s.permute(0, 2, 3, 1)
        h, w = s.shape[1:3]
        pe = position_encoding_3d(B, T, h, w, C // 3, dev)
        if pe.shape[-1] != C:
            pe = F.pad(pe, (0, C - pe.shape[-1]))
        srcs.append(s.reshape(B, T, h * w, C))
        pos.append((pe + P["transformer.level_embed"][lvl]).reshape(
            B, T, h * w, C))
    shapes = tuple((t.shape[2], t.shape[3]) for t in taps)
    src = torch.cat(srcs, 2)
    pos_flat = torch.cat(pos, 2)

    # encoder: every token is a query at its own pixel centre, at all levels
    refs = []
    for h, w in shapes:
        ry = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        rx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        refs.append(torch.stack((gx.reshape(-1), gy.reshape(-1)), -1))
    enc_ref = torch.cat(refs, 0)[None, None, :, None, :].expand(
        B, T, -1, L, 2)
    memory = src
    for i in range(cfg["enc_layers"]):
        p = f"transformer.encoder_layer{i}"
        a = temporal_deform_attn(P, f"{p}.self_attn", memory + pos_flat,
                                 enc_ref, memory, shapes, cfg,
                                 cfg["enc_n_points"], prec, msda)
        memory = layer_norm(memory + a, P, f"{p}.norm1")
        f = linear(F.relu(linear(memory, P, f"{p}.linear1", prec)), P,
                   f"{p}.linear2", prec)
        memory = layer_norm(memory + f, P, f"{p}.norm2")

    heatmaps, start = [], 0
    for h, w in shapes:
        m = memory[:, :, start:start + h * w].reshape(B, T, h, w, H, C // H)
        heatmaps.append(m[..., :K])
        start += h * w

    nq = cfg["num_queries"]
    query_pos, query_obj = torch.split(P["query_embed"], C, -1)
    query_pos = (query_pos.reshape(T1, nq, C)[None].expand(B, -1, -1, -1)
                 + P["transformer.temporal_embed"][None, :, None, :])
    tgt = query_obj.reshape(T1, nq, C)[None].expand(B, -1, -1, -1)
    ref_pts = torch.sigmoid(linear(query_pos, P,
                                   "transformer.reference_points", prec))
    hs, roots_raw = [], []
    for i in range(cfg["dec_layers"]):
        p = f"transformer.decoder_layer{i}"
        t2d = tgt.reshape(B, T1 * nq, C)
        qk = t2d + query_pos.reshape(B, T1 * nq, C)
        t2d = t2d + self_attention(P, f"{p}.self_attn", qk, t2d, H, prec)
        tgt = layer_norm(t2d, P, f"{p}.norm2").reshape(B, T1, nq, C)
        ref_in = ref_pts[:, :, :, None, :].expand(B, T1, nq, L, 2)
        a = temporal_deform_attn(P, f"{p}.cross_attn", tgt + query_pos,
                                 ref_in, memory, shapes, cfg,
                                 cfg["dec_n_points"], prec, msda)
        tgt = layer_norm(tgt + a, P, f"{p}.norm1")
        f = linear(F.relu(linear(tgt, P, f"{p}.linear1", prec)), P,
                   f"{p}.linear2", prec)
        tgt = layer_norm(tgt + f, P, f"{p}.norm3")
        root4 = linear(tgt, P, "transformer.root_embed", prec)
        xy = root4[..., 0:2] + inverse_sigmoid(ref_pts)
        hs.append(tgt)
        roots_raw.append(torch.cat([xy, root4[..., 2:4]], -1))
        ref_pts = torch.sigmoid(xy).detach()

    hs = torch.stack(hs)
    logits = linear(hs, P, "class_embed", prec).transpose(2, 3)
    roots = torch.sigmoid(torch.stack(roots_raw)).transpose(2, 3)[
        ..., None, :]
    joints = torch.stack([linear(hs, P, f"joint_embed{j}", prec)
                          for j in range(K - 1)], -2).transpose(2, 3)
    kpts = torch.cat([roots, joints], -2)
    out = {"pred_logits": logits[-1], "pred_kpts2d": kpts[-1, ..., 0:3],
           "pred_depth": kpts[-1, ..., 3:4], "heatmaps": heatmaps}
    if hs.shape[0] > 1:
        out["aux_logits"] = logits[:-1]
        out["aux_kpts2d"] = kpts[:-1, ..., 0:3]
        out["aux_depth"] = kpts[:-1, ..., 3:4]
    return out


def level_shapes(height: int, width: int) -> List[Tuple[int, int]]:
    """The three levels' (h, w) at an input size: the backbone's strided
    convolutions round up at strides 8, 16 and 32."""
    out = []
    for s in (8, 16, 32):
        out.append((-(-height // s), -(-width // s)))
    return out


def shapes_of(cfg: dict) -> Sequence[Tuple[int, int]]:
    return level_shapes(cfg["input_height"], cfg["input_width"])
