"""Serving profiles (``--fast``): speed for accuracy on a trained checkpoint,
without retraining.

The port's counterpart of ``snipper_tpu/infer/fast.py``: the same profile
names, bounds and error messages. Each profile changes the config and,
where the architecture changes, maps a state dict of the original config
to the profile's. Their measured speed on the card is in PERF.md.

Profiles (comma-separated, e.g. ``--fast enc4,p2,r480``):

- ``m{N}``   : the JAX package's windowed-sampling margin N. The port's
               sampling is an exact gather with no window, so this sets
               ``sampling_margin`` in the config and changes nothing else:
               the outputs equal the base model's, as JAX's do (its
               exactness guard re-runs any snippet whose window overflows).
- ``r{H}``   : input height H, width scaled by the config's aspect ratio.
               The checkpoint loads unchanged (sine position encodings and
               convolutions take any resolution); accuracy degrades away
               from the training resolution.
- ``enc{N}`` : keep the FIRST N encoder layers and drop the trained layers
               N..E-1 (the decoder, which produces the outputs, is kept
               whole).
- ``p{N}``   : keep the FIRST N of the P sampling points per (head, level)
               in every deformable-attention module; the attention weights
               renormalize through the softmax after the slice. The offset
               bias init orders points by reach (point i starts at (i+1)
               px, reference ``ms_deform_attn.py:78-90``), so the first
               points are the short-range taps.

A kind given twice (``p3,p2``) is refused: the second slice would read a
state dict that the first already cut.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Tuple

import torch

from snipper_tpu_torch.config import Config

_PROFILE_RE = re.compile(r"^(m|r|enc|p)(\d+)$")

PROFILE_HELP = (
    "comma-separated serving profiles applied to the config and the loaded "
    "checkpoint: m{N} (the JAX windowed margin N; the port's sampling is "
    "exact, so it changes nothing else), r{H} (input height H, width by "
    "aspect), enc{N} (first N encoder layers), p{N} (first N sampling "
    "points per head/level). Example: enc4,p2,r480. Measured speed on the "
    "card: PERF.md."
)

StateDict = Dict[str, torch.Tensor]

_ENC = "transformer.encoder_layer"


def _truncate_encoder(n: int) -> Callable[[StateDict], StateDict]:
    def t(sd: StateDict) -> StateDict:
        layers = {k[len(_ENC):].split(".", 1)[0] for k in sd
                  if k.startswith(_ENC)}
        drop = {i for i in layers if int(i) >= n}
        if not drop:
            raise ValueError(
                f"enc{n}: checkpoint has no encoder layers >= {n} to drop "
                f"(layers: {sorted(layers, key=int)})")
        return {k: v for k, v in sd.items()
                if not (k.startswith(_ENC)
                        and k[len(_ENC):].split(".", 1)[0] in drop)}

    return t


def _slice_points(orig: Config, p: int) -> Callable[[StateDict], StateDict]:
    """Slice the ``sampling_offsets`` / ``attention_weights`` projections
    of every deformable-attention module from P to the first ``p`` points.

    The ``nn.Linear`` output rows are ordered (head, level, point[, xy]):
    the module reshapes its output to ``[..., H, L, P, 2]`` /
    ``[..., H, L, P]`` (``models/transformer.py::TemporalDeformAttn``), so
    the weight's rows (dim 0, the transpose of flax's kernel columns) and
    the bias carry that order.
    """
    H, L = orig.nheads, orig.num_feature_levels
    modules = (("encoder_layer", "self_attn", orig.enc_n_points),
               ("decoder_layer", "cross_attn", orig.dec_n_points))

    def cut(t: torch.Tensor, P: int, xy: bool) -> torch.Tensor:
        tail = t.shape[1:]
        inner = (2,) if xy else ()
        v = t.reshape(H, L, P, *inner, *tail)[:, :, :p]
        return v.reshape(H * L * p * (2 if xy else 1), *tail).clone()

    def t(sd: StateDict) -> StateDict:
        out, hit = dict(sd), 0
        for key, v in sd.items():
            for layer, attn, P in modules:
                if not key.startswith(f"transformer.{layer}"):
                    continue
                for proj, xy in (("sampling_offsets", True),
                                 ("attention_weights", False)):
                    if f".{attn}.{proj}." in key:
                        out[key] = cut(v, P, xy)
                        hit += 1
        if not hit:
            raise ValueError("p-profile: no encoder/decoder layers found "
                             "in the state dict")
        return out

    return t


def fast_profiles(cfg: Config, spec: str
                  ) -> Tuple[Config, Callable[[StateDict], StateDict]]:
    """Parse ``spec`` (e.g. ``"enc4,p2,r480"``) against ``cfg``.

    Returns ``(new_cfg, transform)``: ``transform`` maps a state dict of
    the ORIGINAL config (a full trained checkpoint) to the new config's,
    without changing its argument. A model seeded under ``new_cfg`` is
    already profile-shaped and takes no transform.
    """
    orig = cfg
    transforms = []
    names = [s.strip() for s in spec.split(",") if s.strip()]
    if not names:
        raise ValueError(f"--fast: empty profile spec {spec!r}")
    seen = {}
    for name in names:
        m = _PROFILE_RE.match(name)
        if not m:
            raise ValueError(f"--fast: unknown profile {name!r} "
                             f"(expected m{{N}}/r{{H}}/enc{{N}}/p{{N}})")
        kind, n = m.group(1), int(m.group(2))
        if kind in seen:
            raise ValueError(f"--fast: profile kind {kind!r} given twice "
                             f"({seen[kind]!r} and {name!r})")
        seen[kind] = name
        if kind == "m":
            if n < 1:
                raise ValueError(f"--fast m{n}: margin must be >= 1")
            cfg = cfg.replace(sampling_margin=n)
        elif kind == "r":
            if n < 32:
                raise ValueError(f"--fast r{n}: input height too small")
            w = int(round(n * orig.input_width / orig.input_height / 2)) * 2
            cfg = cfg.replace(input_height=n, input_width=w)
        elif kind == "enc":
            if not 1 <= n < orig.enc_layers:
                raise ValueError(f"--fast enc{n}: need 1 <= N < "
                                 f"enc_layers ({orig.enc_layers})")
            cfg = cfg.replace(enc_layers=n)
            transforms.append(_truncate_encoder(n))
        elif kind == "p":
            if not 1 <= n < min(orig.enc_n_points, orig.dec_n_points):
                raise ValueError(
                    f"--fast p{n}: need 1 <= N < n_points "
                    f"(enc {orig.enc_n_points}, dec {orig.dec_n_points})")
            cfg = cfg.replace(enc_n_points=n, dec_n_points=n)
            transforms.append(_slice_points(orig, n))

    def transform(sd: StateDict) -> StateDict:
        for t in transforms:
            sd = t(sd)
        return sd

    return cfg, transform
