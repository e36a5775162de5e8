"""The port's serving profiles (``infer/fast.py``) against the JAX package's.

- Every spec of ``tests/test_fast_profiles.py``, valid or not, gives the
  same config fields, or the same error, in both packages.
- The port's state-dict transform, run through the port model, matches
  JAX's tree transform plus ``apply`` on the same numpy-seeded params
  (crossed by ``convert.state_dict_from_jax``) within the full-model bar
  of ``tests/test_torch_parity.py`` (rtol 1e-3, atol 2e-4), f32 on the CPU,
  JAX sampling with its exact ``xla`` impl.
- A kind given twice is refused by the port (JAX fails later in a reshape).
- ``cli.infer --fast`` and ``cli.eval --fast`` of both packages on one
  original-repo checkpoint: the same tracks (5e-3 px, as
  test_torch_port_infer), ``eval_stats.json`` within 1e-4 relative.
"""

import dataclasses
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snipper_tpu.config import Config as JaxConfig
from snipper_tpu.infer import fast as jfast
from snipper_tpu.models import snipper as jsnipper
from snipper_tpu_torch.config import Config
from snipper_tpu_torch.convert import state_dict_from_jax
from snipper_tpu_torch.infer import fast as tfast
from snipper_tpu_torch.models import snipper as tsnipper
from test_torch_port_model import TINY, close, flax_params, japply

VALID = ["m3", "r48", "enc1", "p2", "p1", "m3,enc1,p2,r48", "enc1,p2",
         " r48 , p3 "]
# tests/test_fast_profiles.py::test_invalid_specs_raise, against tiny
# (enc_layers 1, 4 points)
INVALID = ["", "x9", "enc0", "enc1", "p0", "p4", "r16", "m0"]


def _pair(**kw):
    """The same config in both packages: tiny (dropout 0, exact xla
    sampling) with ``kw``."""
    base = dict(TINY, **kw)
    return JaxConfig(**base), Config(**base)


@pytest.mark.parametrize("spec", VALID)
def test_profile_config_matches_jax(spec):
    jcfg, tcfg = _pair(enc_layers=2)
    jnew, _ = jfast.fast_profiles(jcfg, spec)
    tnew, _ = tfast.fast_profiles(tcfg, spec)
    assert dataclasses.asdict(tnew) == dataclasses.asdict(jnew)


@pytest.mark.parametrize("spec", INVALID)
def test_invalid_specs_raise_as_jax(spec):
    jcfg, tcfg = _pair()
    with pytest.raises(ValueError) as want:
        jfast.fast_profiles(jcfg, spec)
    with pytest.raises(ValueError) as got:
        tfast.fast_profiles(tcfg, spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["p3,p2", "enc1,enc1", "r48,r64", "m2,m3"])
def test_repeated_kind_raises(spec):
    _, tcfg = _pair(enc_layers=2)
    kind = spec.split(",")[0].rstrip("0123456789")
    with pytest.raises(ValueError, match=f"kind '{kind}' given twice"):
        tfast.fast_profiles(tcfg, spec)


def test_profile_help_quotes_no_tpu_figure():
    """The help points at PERF.md; JAX's points at a TPU table."""
    help_text = tfast.PROFILE_HELP + (tfast.__doc__ or "")
    assert "PERF.md" in tfast.PROFILE_HELP
    for word in ("TPU", "v5e", "BASELINE", "snippets/s"):
        assert word not in help_text, word


@pytest.fixture(scope="module")
def full_pair():
    """A tiny enc2 model's numpy-seeded flax params (the sampling
    projections move the points) and one input."""
    kw = dict(TINY, enc_layers=2)
    jm = jsnipper.Snipper(JaxConfig(**kw))
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (1, kw["num_frames"], kw["input_height"],
                           kw["input_width"], 3)).astype(np.float32)
    params = flax_params(jm, jnp.asarray(x), seed=7)
    return kw, params


@pytest.mark.parametrize("spec", ["p2", "enc1", "r48", "m3",
                                  "enc1,p2,r48"])
def test_transform_forward_matches_jax(full_pair, spec):
    kw, params = full_pair
    jcfg, tcfg = JaxConfig(**kw), Config(**kw)
    jnew, jtransform = jfast.fast_profiles(jcfg, spec)
    tnew, ttransform = tfast.fast_profiles(tcfg, spec)
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (1, jnew.num_frames, jnew.input_height,
                           jnew.input_width, 3)).astype(np.float32)
    want = japply(jsnipper.Snipper(jnew), jtransform(params), jnp.asarray(x))

    full = state_dict_from_jax(params)
    state = ttransform(full)
    assert set(full) == set(state_dict_from_jax(params))  # not mutated
    model = tsnipper.build_model(tnew, device="cpu")
    model.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    for k in ("pred_logits", "pred_kpts2d", "pred_depth"):
        close(got[k], want[k])
    for g, w in zip(got["heatmaps"], want["heatmaps"]):
        close(g, w)
    if "enc" in spec:
        assert not any(k.startswith("transformer.encoder_layer1.")
                       for k in state)
        assert any(k.startswith("transformer.encoder_layer1.")
                   for k in full)


def test_transform_slices_points_in_head_level_point_order(full_pair):
    """p2 keeps rows (h, l, p < 2[, xy]) of the projections, in order."""
    kw, params = full_pair
    H, L, P = kw["nheads"], 3, 4
    _, transform = tfast.fast_profiles(Config(**kw), "p2")
    full = state_dict_from_jax(params)
    state = transform(full)
    key = "transformer.decoder_layer1.cross_attn.sampling_offsets.weight"
    want = full[key].reshape(H, L, P, 2, -1)[:, :, :2].reshape(
        H * L * 2 * 2, -1)
    assert torch.equal(state[key], want)
    key = "transformer.encoder_layer0.self_attn.attention_weights.bias"
    assert torch.equal(state[key],
                       full[key].reshape(H, L, P)[:, :, :2].reshape(-1))


# ---------------------------------------------------------------- the CLIs
@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """An original-repo checkpoint of tiny with two encoder layers."""
    from test_torch_parity import TorchSnipper, _reference_state_dict

    torch.manual_seed(0)
    sd = _reference_state_dict(TorchSnipper(
        JaxConfig.tiny().replace(enc_layers=2)).eval())
    path = str(tmp_path_factory.mktemp("fast") / "ref.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    return path


FAST = "enc1,p2,r48"


def test_cli_infer_fast_matches_jax(ref_ckpt, tmp_path, monkeypatch,
                                    capsys):
    from snipper_tpu.cli import infer as jax_cli
    from snipper_tpu_torch.cli import infer as port_cli
    from test_torch_port_infer import _assert_tracks_equal, _frames_dir

    data_dir = _frames_dir(tmp_path, n=6)
    common = ["--preset", "tiny", "--enc_layers", "2", "--data_dir",
              data_dir, "--seq_gap", "1", "--pretrained_torch", ref_ckpt,
              "--fast", FAST]
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    port_cli.main(common + ["--output_dir", out_t, "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("fast profiles")]
    monkeypatch.setattr(sys, "argv", ["infer"] + common + [
        "--output_dir", out_j, "--deform_impl", "xla"])
    jax_cli.main()
    jline = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("fast profiles")]
    assert line == jline == [
        f"fast profiles {FAST}: input 48x72, enc 1, points 2/2, margin 5"]
    tracks = []
    for out in (out_t, out_j):
        with open(os.path.join(out, "tracks.pkl"), "rb") as f:
            tracks.append(pickle.load(f))
    _assert_tracks_equal(tracks[0], tracks[1], atol=5e-3)


def test_cli_eval_fast_matches_jax(ref_ckpt, tmp_path, monkeypatch):
    from snipper_tpu.cli import eval as jax_cli
    from snipper_tpu_torch.cli import eval as port_cli

    args = ["--preset", "tiny", "--enc_layers", "2", "--synthetic",
            "--synthetic_samples", "2", "--num_workers", "0",
            "--deform_impl", "xla", "--pretrained_torch", ref_ckpt,
            "--fast", FAST]
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    res = port_cli.main(args + ["--output_dir", out_t, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["eval"] + args + ["--output_dir",
                                                        out_j])
    jax_cli.main()
    stats = []
    for out in (out_t, out_j):
        with open(os.path.join(out, "eval_stats.json")) as f:
            stats.append(json.load(f))
    got, want = stats
    assert set(got) == set(want) and "loss_total" in got
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert res["batches"] == 2


def test_cli_refuses_a_bad_profile(tmp_path, capsys):
    from snipper_tpu_torch.cli import eval as port_cli

    with pytest.raises(SystemExit) as e:
        port_cli.main(["--preset", "tiny", "--synthetic", "--device", "cpu",
                       "--fast", "p3,p2", "--output_dir", str(tmp_path)])
    assert e.value.code == 2
    assert "given twice" in capsys.readouterr().err


def test_probe_fast_lines_and_fail(capsys, monkeypatch):
    """``probe fast`` on tiny on the CPU: one init cast to bf16 and a bf16
    input, as JAX's ``fast`` (``scripts/probe.py:454-466``), JAX's line
    per spec with the port's impl, a FAIL line for a spec that raises and
    exit 1 after DONE; the header names the device and quotes no TPU
    figure. The timer is a stand-in that runs each forward once."""
    from snipper_tpu_torch.scripts import probe

    monkeypatch.setattr(probe, "time_fn", lambda fn, x, **kw: (fn(x), 50.0)[1])

    rc = probe.main(["fast", "--preset", "tiny", "--device", "cpu", "-K",
                     "1", "--specs", "base|m3|p2|p3,p2"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == ("fast-profile probe on cpu: tiny, bf16 weights and "
                        "input, batch 1")
    assert rc == 1 and lines[-1] == "DONE"
    assert lines[1].startswith("base            : ")
    assert lines[1].endswith(
        ":  20.00 snippets/s  [ms_deform_attn_torch bf16 64x96 enc1 P=4/4]"
        "  1.00x base")
    assert lines[3].startswith("p2") and "P=2/2]" in lines[3]
    assert [ln for ln in lines if "FAIL" in ln] == [
        "p3,p2: FAIL ValueError: --fast: profile kind 'p' given twice "
        "('p3' and 'p2')"]
    assert "TPU" not in out and "v5e" not in out
