"""Weight conversion into the port: JAX params and original-repo
checkpoints.

The original-repo checkpoint comes from the independent PyTorch replica of
tests/test_torch_parity.py, which emits the reference's parameter names
(with the per-frame and per-layer aliases the reference saves).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snipper_tpu.config import Config as JaxConfig
from snipper_tpu.models.snipper import build_model as jax_build_model
from snipper_tpu.train.checkpoint import import_torch_state_dict
from snipper_tpu_torch.config import Config
from snipper_tpu_torch.convert import (load_reference_checkpoint,
                                       state_dict_from_jax,
                                       state_dict_from_reference)
from snipper_tpu_torch.models.snipper import Snipper, build_model
from test_torch_parity import TorchSnipper, _reference_state_dict
from test_torch_port_model import TINY, random_params


def _jax_param_shapes(kw):
    jcfg = JaxConfig(**kw)
    x = jnp.zeros((1, jcfg.num_frames, jcfg.input_height, jcfg.input_width,
                   3), jnp.float32)
    model = jax_build_model(jcfg)
    return jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x))["params"]


@pytest.mark.parametrize("extra", [{}, {"num_feature_levels": 4},
                                   {"num_frames": 4, "num_future_frames": 2}])
def test_state_dict_from_jax_loads_strict(extra):
    kw = {**TINY, **extra}
    params = random_params(_jax_param_shapes(kw), seed=0)
    sd = state_dict_from_jax(params)
    model = build_model(Config(**kw), device="cpu")
    model.load_state_dict(sd, strict=True)
    # layouts: a Dense kernel [in, out] -> [out, in], conv HWIO -> OIHW
    k = params["class_embed"]["kernel"]
    np.testing.assert_array_equal(
        model.class_embed.weight.detach().numpy(), k.T)
    c = params["backbone"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        model.backbone.conv1.weight.detach().numpy(), c.transpose(3, 2, 0, 1))


def test_state_dict_from_jax_covers_canonical_t4():
    """Every port key of canonical_t4 (ResNet-50, enc6/dec6), with the same
    shapes (built on the meta device: shapes only)."""
    kw = dict(JaxConfig.canonical_t4().__dict__)
    shapes = _jax_param_shapes(kw)
    empty = jax.tree_util.tree_map(lambda s: np.empty(s.shape, np.float32),
                                   shapes)
    keys = set(state_dict_from_jax(empty))
    with torch.device("meta"):
        model = Snipper(Config(**kw))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert keys == set(want)

    def flat(node, prefix=()):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), tuple(v.shape)

    for path, shape in flat(shapes):
        name = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
        key = ".".join(path[:-1] + (name,))
        port_shape = (shape[::-1] if len(shape) == 2 and path[-1] == "kernel"
                      else (shape[3], shape[2], shape[0], shape[1])
                      if len(shape) == 4 else shape)
        assert want[key] == port_shape, key


def _reference_sd(kw, seed):
    torch.manual_seed(seed)
    return _reference_state_dict(TorchSnipper(JaxConfig(**kw)).eval())


@pytest.mark.parametrize("extra", [{}, {"num_feature_levels": 4}])
def test_reference_checkpoint_matches_jax_import(tmp_path, extra):
    """An original-repo .pth gives the same tensors through
    state_dict_from_reference as through the JAX import followed by
    state_dict_from_jax."""
    kw = {**TINY, **extra}
    sd = _reference_sd(kw, seed=0)
    # aliases and buffers that the reference saves and the import skips
    sd["backbone.0.body.bn1.num_batches_tracked"] = np.zeros((), np.int64)
    sd["class_embed.1.weight"] = sd["class_embed.0.weight"]
    sd["transformer.decoder.class_embed.0.bias"] = sd["class_embed.0.bias"]
    path = tmp_path / "ref.pth"
    torch.save({"model": {k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()}}, path)

    got = load_reference_checkpoint(str(path), Config(**kw))
    want = state_dict_from_jax(import_torch_state_dict(sd, JaxConfig(**kw)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    build_model(Config(**kw), device="cpu").load_state_dict(got, strict=True)


def test_reference_checkpoint_forward_matches_replica():
    """The port loaded from the replica's reference-named weights gives the
    replica's outputs (an oracle independent of the JAX package)."""
    kw = {**TINY, "num_feature_levels": 4}
    torch.manual_seed(1)
    replica = TorchSnipper(JaxConfig(**kw)).eval()
    model = build_model(Config(**kw), device="cpu")
    model.load_state_dict(state_dict_from_reference(
        _reference_state_dict(replica), Config(**kw)))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, 2, 64, 96, 3)).astype(np.float32))
    with torch.inference_mode():
        r_logits, r_kpts, r_heat = replica(x)
        out = model(x)
    kpts = torch.cat([out["pred_kpts2d"], out["pred_depth"]], -1)
    torch.testing.assert_close(out["pred_logits"], r_logits, rtol=1e-3,
                               atol=2e-4)
    torch.testing.assert_close(kpts, r_kpts, rtol=1e-3, atol=2e-4)
    for got, want in zip(out["heatmaps"], r_heat):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-4)


def test_reference_import_is_strict():
    sd = _reference_sd(TINY, seed=2)
    cfg = Config(**TINY)
    with pytest.raises(KeyError, match="unmapped"):
        state_dict_from_reference({**sd, "transformer.bogus": sd[
            "query_embed.weight"]}, cfg)
    partial = dict(sd)
    del partial["query_embed.weight"]
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_reference(partial, cfg)
    out = state_dict_from_reference(partial, cfg, strict=False)
    assert "query_embed" not in out
