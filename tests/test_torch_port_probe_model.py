"""``deform_impl="skip"`` and the probe's ``forward``, ``train`` and
``split`` on the CPU.

The skip stand-in of the port's ``temporal_deform_sample`` and a tiny model
built with it are held against the JAX package's (its ``impl="skip"``
branch and ``apply``, jitted) in f32; every other impl name still runs the
exact sampling. The three probe subcommands run through ``main`` at the
tiny preset with ``--device cpu``, print the JAX probe's line formats and
``DONE``, and raise without ``--device cpu`` and a card.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snipper_tpu.ops.deform_attn import temporal_adjacency as jax_adjacency
from snipper_tpu.ops.deform_attn import \
    temporal_deform_sample as jax_temporal_deform_sample
from snipper_tpu_torch.ops import deform_attn
from snipper_tpu_torch.ops.deform_attn import (temporal_adjacency,
                                               temporal_deform_sample)
from snipper_tpu_torch.scripts import probe
from test_torch_port_model import TINY, close, japply, snipper_pair

SHAPES = [(6, 9), (3, 5), (2, 2)]
S = sum(h * w for h, w in SHAPES)

# the line formats of scripts/probe.py:134-139, :210-214 and :319-337
FORWARD_LINE = re.compile(
    r"^(\S+)\s+b(\d+):\s+([\d.]+) ms/snippet \(\s*([\d.]+) snippets/s\) "
    r"overflow=(\S+) \[(\d+)x(\d+) T=(\d+)\+(\d+) enc(\d+)/dec(\d+) "
    r"impl=(\S+)(?: [^\]]*)?\]$")
TRAIN_LINE = re.compile(
    r"^train (\S+) mp=(True|False) remat=(\S+) b(\d+): ([\d.]+) ms/step"
    r"( \(traced\))? \(compile \d+s, loss [-\d.]+->[-\d.]+, "
    r"overflow ([\d.]+)\)$")
SPLIT_LINE = re.compile(r"^enc=(\d) dec=(\d):\s+([\d.]+) ms$")
SOLVED_LINE = re.compile(r"^solved: c0=[-\d.]+ ms  ce=[-\d.]+ ms/enc-layer  "
                         r"cd=[-\d.]+ ms/dec-layer$")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tiny models' many small ops do not gain
    from more, and under a parallel test run the threads of several
    workers would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_sampling(monkeypatch):
    """Any call of the MSDA (kernel or plain) fails the test."""
    def refuse(*args, **kw):
        raise AssertionError("the sampling ran under deform_impl='skip'")

    monkeypatch.setattr(deform_attn, "ms_deform_attn", refuse)


def _sample_inputs(seed, T, Tf, B=2, NH=4, D=8, LQ=11, P=2):
    rng = np.random.default_rng(seed)
    T1, L = T + Tf, len(SHAPES)
    value = rng.standard_normal((B, T, S, NH, D)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, T1, LQ, NH, L, P, 2)).astype(np.float32)
    logits = rng.standard_normal((B, T1, LQ, NH, L, P)).astype(np.float32)
    return value, loc, logits


@pytest.mark.parametrize("T,Tf", [(4, 0), (4, 2), (1, 0)])
def test_skip_matches_jax(T, Tf, no_sampling):
    """The mean of the aggregated value over S, broadcast to every query,
    as JAX's ``impl="skip"``; no kernel and no plain MSDA runs."""
    value, loc, logits = _sample_inputs(T * 10 + Tf, T, Tf)
    got, overflow = temporal_deform_sample(
        torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
        torch.from_numpy(logits), temporal_adjacency(T, T + Tf),
        impl="skip")
    want, j_overflow = jax_temporal_deform_sample(
        jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(logits),
        jax_adjacency(T, T + Tf), impl="skip")
    assert overflow == 0 and float(j_overflow) == 0.0
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("impl", ["pmerged", "windowed2d", "pallas"])
def test_other_impls_run_the_exact_sampling(impl):
    """Any name but skip runs the exact MSDA: the default ``xla``'s output
    bit for bit (held against JAX's in ``test_torch_port_msda.py``)."""
    value, loc, logits = (torch.from_numpy(a)
                          for a in _sample_inputs(5, 4, 2))
    adj = temporal_adjacency(4, 6)
    got, _ = temporal_deform_sample(value, SHAPES, loc, logits, adj,
                                    impl=impl)
    want, _ = temporal_deform_sample(value, SHAPES, loc, logits, adj)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_skip_model_matches_jax(no_sampling):
    """A tiny model with ``deform_impl="skip"`` against JAX's ``apply`` on
    the same weights, within 1e-4."""
    kw = {**TINY, "deform_impl": "skip"}
    jm, params, tm = snipper_pair(kw, seed=6)
    x = np.random.default_rng(6).uniform(
        0, 1, (2, kw["num_frames"], kw["input_height"], kw["input_width"],
               3)).astype(np.float32)
    want = japply(jm, params, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    for k in ("pred_logits", "pred_kpts2d", "pred_depth", "references"):
        close(got[k], want[k], rtol=0, atol=1e-4)
    for g, w in zip(got["heatmaps"], want["heatmaps"]):
        close(g, w, rtol=0, atol=1e-4)


def test_probe_forward_on_cpu(capsys):
    assert probe.main(["forward", "--presets", "tiny", "--batch", "1,2",
                       "--dtype", "f32", "--device", "cpu", "-K", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "DONE"
    lines = [FORWARD_LINE.match(ln) for ln in out[:-1]]
    assert all(lines) and len(lines) == 2, out
    for m, batch in zip(lines, (1, 2)):
        assert m.group(1) == "tiny" and int(m.group(2)) == batch
        assert m.group(5) == "0.0" and m.group(12) == "plain"
        assert (m.group(6), m.group(7)) == ("64", "96")


def test_probe_forward_skip_and_bf16(capsys):
    """``--dtype bf16`` (the default) runs JAX's bf16 recipe, bf16
    weights and a bf16 input, and says so on its line; the bf16 forward
    itself is held to JAX's in tests/test_torch_port_bench.py within 4
    bf16 units, as JAX's own jitted and op-by-op bf16 forwards differ by
    up to 1.91."""
    assert probe.main(["forward", "--presets", "tiny", "--impl", "skip",
                       "--device", "cpu", "-K", "1"]) == 0
    line = capsys.readouterr().out.splitlines()[0]
    m = FORWARD_LINE.match(line)
    assert m and m.group(12) == "skip" and "bf16 weights and input" in line, \
        line


def test_probe_forward_failing_preset_exits_nonzero(capsys):
    """A preset that raises prints FAIL, the sweep goes on, and the probe
    exits non-zero after DONE."""
    rc = probe.main(["forward", "--presets", "no_such_preset,tiny",
                     "--dtype", "f32", "--device", "cpu", "-K", "1"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 1 and out[-1] == "DONE"
    assert out[0].startswith("no_such_preset b1: FAIL AttributeError")
    assert FORWARD_LINE.match(out[1])


def test_probe_train_on_cpu(capsys, tmp_path):
    """Both precisions, then a traced run whose line says so."""
    assert probe.main(["train", "--preset", "tiny", "--mp", "both", "-K",
                       "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "DONE"
    lines = [TRAIN_LINE.match(ln) for ln in out[:-1]]
    assert all(lines) and [m.group(2) for m in lines] == ["False", "True"]
    assert all(m.group(1) == "xla" and m.group(7) == "0.0" for m in lines)
    assert probe.main(["train", "--preset", "tiny", "-K", "1", "--device",
                       "cpu", "--profile_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "-- top device ops (ms/step, xla mp=True):"
    m = TRAIN_LINE.match([ln for ln in out if ln.startswith("train")][0])
    assert m and m.group(6) == " (traced)"


def test_probe_split_on_cpu(capsys, no_sampling):
    """Four skip forwards at (enc, dec) depths and the solved split; no
    sampling runs."""
    assert probe.main(["split", "--preset", "tiny", "-K", "1", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "DONE" and SOLVED_LINE.match(out[-2]), out
    pts = [SPLIT_LINE.match(ln) for ln in out[:-2]]
    assert [(m.group(1), m.group(2)) for m in pts] == [
        ("6", "6"), ("2", "6"), ("6", "2"), ("1", "1")]


@pytest.mark.parametrize("cmd", ["forward", "train", "split"])
def test_probe_subcommands_need_a_card(cmd, monkeypatch):
    """Without ``--device cpu`` and without a card each raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe.main([cmd, "--presets" if cmd == "forward" else "--preset",
                    "tiny"])
