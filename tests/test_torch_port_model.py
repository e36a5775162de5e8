"""The port's modules against the JAX package's flax modules.

Parameters are drawn with numpy from a seed in the flax tree's shapes
(``jax.eval_shape`` of the init, no JAX init run), fed to the flax module
as they are and to the port module through ``convert.state_dict_from_jax``.
Inputs are numpy from the same seed. Everything runs in f32 on the CPU;
the JAX side samples with ``deform_impl="xla"``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snipper_tpu.config import Config as JaxConfig
from snipper_tpu.models import position_encoding as jpe
from snipper_tpu.models import resnet as jresnet
from snipper_tpu.models import snipper as jsnipper
from snipper_tpu.models import transformer as jtr
from snipper_tpu_torch.config import Config
from snipper_tpu_torch.convert import state_dict_from_jax
from snipper_tpu_torch.models import position_encoding as tpe
from snipper_tpu_torch.models import resnet as tresnet
from snipper_tpu_torch.models import snipper as tsnipper
from snipper_tpu_torch.models import transformer as ttr

TINY = dict(num_frames=2, num_future_frames=1, hidden_dim=96, nheads=4,
            enc_layers=1, dec_layers=2, dim_feedforward=128, num_queries=8,
            num_kpts=15, input_height=64, input_width=96, max_persons=4,
            backbone="resnet_test", dropout=0.0, deform_impl="xla")
SHAPES = ((8, 12), (4, 6), (2, 3))
RTOL, ATOL = 1e-3, 2e-4


def random_params(shapes_tree, seed):
    """numpy params in the shapes of a flax tree: kernels with variance
    1/fan_in, small random biases, norm scales and frozen-BN statistics
    around 1, and sampling projections that move the sampling points."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name, parent = path[-1], path[-2] if len(path) > 1 else ""
        if parent in ("sampling_offsets", "attention_weights"):
            scale = 0.05 if name == "kernel" else 1.0
            return rng.standard_normal(shape) * scale
        if name in ("scale", "weight", "running_var"):
            return rng.uniform(0.5, 1.5, shape)
        if name in ("bias", "running_mean"):
            return rng.standard_normal(shape) * 0.1
        if name in ("kernel", "in_proj_weight"):
            fan_in = (int(np.prod(shape[:-1])) if name == "kernel"
                      else shape[1])
            return rng.standard_normal(shape) / np.sqrt(fan_in)
        return rng.standard_normal(shape)   # embeddings

    def walk(node, path):
        return {k: (walk(v, path + (k,)) if isinstance(v, dict)
                    else leaf(path + (k,), v.shape).astype(np.float32))
                for k, v in node.items()}

    return walk(shapes_tree, ())


def flax_params(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kw))["params"]
    return random_params(shapes, seed)


def japply(module, params, *args, **kw):
    """The flax module's forward, jitted (one compile is much faster than
    op-by-op dispatch on the CPU); ``args`` are closed over."""
    return jax.jit(lambda p: module.apply({"params": p}, *args, **kw))(
        params)


def load(port_module, params):
    port_module.load_state_dict(state_dict_from_jax(params), strict=True)
    return port_module.eval()


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_backbone_resnet_test():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    jm = jresnet.ResNet(jresnet.RESNET_SPECS["resnet_test"])
    params = flax_params(jm, jnp.asarray(x))
    want = japply(jm, params, jnp.asarray(x))
    tm = load(tresnet.ResNet(tresnet.RESNET_SPECS["resnet_test"]), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 3
    for g, w in zip(got, want):
        close(g.permute(0, 2, 3, 1), w)


@pytest.mark.parametrize("feats", [32, 5])
def test_position_encoding(feats):
    """Masked input; odd F pads the sin/cos interleave."""
    mask = np.zeros((2, 3, 6, 7), bool)
    mask[0, :, :, 5:] = True
    mask[1, :, 4:, :] = True
    got = tpe.position_encoding_3d(torch.from_numpy(mask), feats)
    want = jpe.position_encoding_3d(jnp.asarray(mask), feats)
    assert tuple(got.shape) == (2, 3, 6, 7, 3 * feats)
    close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride2", [False, True])
def test_input_proj(stride2):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 10, 64)).astype(np.float32)
    jm = jsnipper.InputProj(32, stride2=stride2)
    params = flax_params(jm, jnp.asarray(x), seed=1)
    want = japply(jm, params, jnp.asarray(x))
    tm = load(tsnipper.InputProj(64, 32, stride2=stride2), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    close(got.permute(0, 2, 3, 1), want)


def _attn_inputs(seed, B=2, T1=3, T2=2, Lq=5, C=32, L=3, with_mask=True):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in SHAPES)
    q = rng.standard_normal((B, T1, Lq, C)).astype(np.float32)
    ref = rng.uniform(0, 1, (B, T1, Lq, L, 2)).astype(np.float32)
    src = rng.standard_normal((B, T2, S, C)).astype(np.float32)
    mask = None
    if with_mask:
        mask = rng.uniform(0, 1, (B, T2, S)) < 0.2
    return q, ref, src, mask


@pytest.mark.parametrize("with_mask", [False, True])
def test_temporal_deform_attn(with_mask):
    q, ref, src, mask = _attn_inputs(2, with_mask=with_mask)
    C = q.shape[-1]
    jm = jtr.TemporalDeformAttn(C, 3, 4, 2, n_frames=2, impl="xla")
    jargs = (jnp.asarray(q), jnp.asarray(ref), jnp.asarray(src), SHAPES,
             None if mask is None else jnp.asarray(mask))
    params = flax_params(jm, *jargs, seed=2)
    w_out, _, (w_loc, w_attn) = japply(jm, params, *jargs,
                                      return_attn=True)
    tm = load(ttr.TemporalDeformAttn(C, 3, 4, 2, n_frames=2), params)
    with torch.no_grad():
        out, overflow, (loc, attn) = tm(
            torch.from_numpy(q), torch.from_numpy(ref), torch.from_numpy(src),
            SHAPES, None if mask is None else torch.from_numpy(mask),
            return_attn=True)
    assert overflow == 0
    close(out, w_out)
    close(loc, w_loc, rtol=1e-5, atol=1e-6)
    close(attn, w_attn, rtol=1e-5, atol=1e-6)


def test_encoder_layer():
    q, ref, src, mask = _attn_inputs(3, T1=2, T2=2, Lq=sum(
        h * w for h, w in SHAPES))
    pos = np.random.default_rng(4).standard_normal(src.shape).astype(
        np.float32)
    C = q.shape[-1]
    jm = jtr.EncoderLayer(C, 64, 3, 4, 2, 2, dropout=0.0, impl="xla")
    jargs = (jnp.asarray(src), jnp.asarray(pos), jnp.asarray(ref), SHAPES,
             jnp.asarray(mask))
    params = flax_params(jm, *jargs, seed=3)
    want, _ = japply(jm, params, *jargs)
    tm = load(ttr.EncoderLayer(C, 64, 3, 4, 2, 2), params)
    with torch.no_grad():
        got, overflow = tm(torch.from_numpy(src), torch.from_numpy(pos),
                           torch.from_numpy(ref), SHAPES,
                           torch.from_numpy(mask))
    assert overflow == 0
    close(got, want)


def test_decoder_layer():
    """Self-attention over all T1*Lq tokens, then norm2; cross-attention,
    then norm1; FFN, then norm3."""
    tgt, ref, src, mask = _attn_inputs(5, T1=3, T2=2, Lq=6)
    qpos = np.random.default_rng(6).standard_normal(tgt.shape).astype(
        np.float32)
    C = tgt.shape[-1]
    jm = jtr.DecoderLayer(C, 64, 3, 4, 2, 2, dropout=0.0, impl="xla")
    jargs = (jnp.asarray(tgt), jnp.asarray(qpos), jnp.asarray(ref),
             jnp.asarray(src), SHAPES, jnp.asarray(mask))
    params = flax_params(jm, *jargs, seed=5)
    want, (w_loc, w_attn) = japply(jm, params, *jargs)
    tm = load(ttr.DecoderLayer(C, 64, 3, 4, 2, 2), params)
    with torch.no_grad():
        got, (loc, attn) = tm(torch.from_numpy(tgt), torch.from_numpy(qpos),
                              torch.from_numpy(ref), torch.from_numpy(src),
                              SHAPES, torch.from_numpy(mask),
                              return_attn=True)
    close(got, want)
    close(loc, w_loc, rtol=1e-5, atol=1e-6)


def test_inverse_sigmoid():
    x = np.array([-0.5, 0.0, 1e-7, 0.3, 0.5, 1.0 - 1e-7, 1.0, 1.5],
                 np.float32)
    close(ttr.inverse_sigmoid(torch.from_numpy(x)),
          jtr.inverse_sigmoid(jnp.asarray(x)), rtol=1e-6, atol=1e-6)


def test_encoder_reference_points():
    vr = np.random.default_rng(7).uniform(0.5, 1, (2, 3, 2)).astype(
        np.float32)
    close(ttr.encoder_reference_points(SHAPES, torch.from_numpy(vr)),
          jtr.encoder_reference_points(SHAPES, jnp.asarray(vr)),
          rtol=1e-6, atol=1e-6)


def snipper_pair(kw, seed, batch=2):
    """(flax model, flax params, port model) with the same weights."""
    jcfg = JaxConfig(**kw)
    jm = jsnipper.build_model(jcfg)
    x = jnp.zeros((batch, jcfg.num_frames, jcfg.input_height,
                   jcfg.input_width, 3), jnp.float32)
    params = flax_params(jm, x, seed=seed)
    tm = tsnipper.build_model(Config(**kw), device="cpu")
    load(tm, params)
    return jm, params, tm


def _masked_input(cfg_kw, rng):
    h, w = cfg_kw["input_height"], cfg_kw["input_width"]
    x = rng.uniform(0, 1, (2, cfg_kw["num_frames"], h, w, 3)).astype(
        np.float32)
    # ragged right/bottom padding, not aligned to the feature strides
    mask = np.zeros((2, cfg_kw["num_frames"], h, w), bool)
    mask[0, :, :, w - 27:] = True
    mask[0, :, h - 13:, :] = True
    mask[1, :, :, w - 5:] = True
    return np.where(mask[..., None], 0.0, x).astype(np.float32), mask


def run_snipper_parity(kw, with_mask, seed):
    jm, params, tm = snipper_pair(kw, seed)
    rng = np.random.default_rng(seed)
    if with_mask:
        x, mask = _masked_input(kw, rng)
    else:
        x = rng.uniform(0, 1, (2, kw["num_frames"], kw["input_height"],
                               kw["input_width"], 3)).astype(np.float32)
        mask = None
    want = japply(jm, params, jnp.asarray(x),
                  None if mask is None else jnp.asarray(mask))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x),
                 None if mask is None else torch.from_numpy(mask))
    assert set(got) == set(want)
    assert got["sampling_overflow"] == 0
    for k in ("pred_logits", "pred_kpts2d", "pred_depth", "aux_logits",
              "aux_kpts2d", "aux_depth", "init_reference", "references"):
        if k in want:
            close(got[k], want[k])
    assert len(got["heatmaps"]) == kw.get("num_feature_levels", 3)
    for g, w in zip(got["heatmaps"], want["heatmaps"]):
        close(g, w)


@pytest.mark.parametrize("name,extra,with_mask,seed", [
    ("tiny", {}, False, 0),
    ("masked_4levels", {"num_feature_levels": 4}, True, 1),
    ("t1", {"num_frames": 1, "num_future_frames": 0}, False, 2),
    ("masked_t4f2", {"num_frames": 4, "num_future_frames": 2}, True, 3),
    # hidden 64: 21 sine features per axis (odd F), zero-padded to 64
    ("hidden64", {"hidden_dim": 64}, False, 4),
])
def test_snipper_matches_flax(name, extra, with_mask, seed):
    """The four shapes of tests/test_torch_parity.py, and a hidden width
    not divisible by 3."""
    run_snipper_parity({**TINY, **extra}, with_mask, seed)


def test_build_model_is_seeded():
    cfg = Config(**TINY)
    a = tsnipper.build_model(cfg, device="cpu", seed=3).state_dict()
    b = tsnipper.build_model(cfg, device="cpu", seed=3).state_dict()
    c = tsnipper.build_model(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.isfinite(v).all() for v in a.values())
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_build_model_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsnipper.build_model(Config(**TINY))


@pytest.mark.slow
def test_snipper_matches_flax_canonical_t4():
    """canonical_t4 (hidden 384, enc6/dec6, 600x800), batch 1."""
    kw = dict(JaxConfig.canonical_t4().__dict__)
    kw.update(dropout=0.0, deform_impl="xla")
    jm, params, tm = snipper_pair(kw, seed=9, batch=1)
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (1, 4, 600, 800, 3)).astype(np.float32)
    want = japply(jm, params, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    for k in ("pred_logits", "pred_kpts2d", "pred_depth"):
        close(got[k], want[k])
