"""The lane-gather probe's kernels against the JAX package's, and the
port's probe script (``snipper_tpu_torch.scripts.probe``) on the CPU.

The JAX kernels run in Pallas interpret mode at tiny sizes:
``_chain_gather_kernel`` and ``_chain_select_kernel`` wrapped in
``pl.pallas_call`` with ``probe_primitive``'s specs (which has no
interpret switch), ``hier_gather_sample(interpret=True)``, and
``_win2d_kernel_factory`` with ``_onehot_reference``'s specs. The JAX
probe's ``scripts/`` is no package, so its ``lanegather_probe.py`` is
imported by path. On the CPU the port's wrappers take the plain versions.

Tolerances: the chains bitwise (``+1`` and ``x + x`` round the same under
IEEE on both sides); the contractions within 1e-5 of the output's
largest value, the JAX probe's own bar (``lanegather_probe.py:280-283``).
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from snipper_tpu.ops.pallas_deform import _win2d_kernel_factory
from snipper_tpu_torch.ops import lane_chain, win2d
from snipper_tpu_torch.scripts import lanegather_probe, probe

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load_jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_lanegather_probe", REPO / "scripts" / "lanegather_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JLG = _load_jax_probe()
LANE = 128


def _jax_chain(kern, x, idx, n):
    """``probe_primitive``'s pallas_call of one chain kernel, in interpret
    mode."""
    grid, R, _ = x.shape
    spec = pl.BlockSpec((1, R, LANE), lambda i: (i, 0, 0),
                        memory_space=pltpu.VMEM)
    return pl.pallas_call(
        functools.partial(kern, n=n), grid=(grid,), in_specs=[spec, spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((grid, R, LANE), jnp.float32),
        interpret=True)(x, idx)


def _jax_onehot(wins, ids, wgts):
    """``_onehot_reference``'s pallas_call of ``_win2d_kernel_factory``, in
    interpret mode."""
    L = len(wins)
    NB, BH, _, D = wins[0].shape
    C, n_taps = ids[0].shape[2], ids[0].shape[3]
    in_specs = (
        [pl.BlockSpec((1, 1, w.shape[2], D), lambda i, j: (i, j, 0, 0),
                      memory_space=pltpu.VMEM) for w in wins]
        + [pl.BlockSpec((1, 1, C, n_taps), lambda i, j: (i, j, 0, 0),
                        memory_space=pltpu.VMEM)] * (2 * L))
    return pl.pallas_call(
        _win2d_kernel_factory(L), grid=(NB, BH), in_specs=in_specs,
        out_specs=pl.BlockSpec((1, 1, C, D), lambda i, j: (i, j, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((NB, BH, C, D), jnp.float32),
        interpret=True)(*wins, *ids, *wgts)


def _tiny_fixture():
    """``_fixture`` of both packages at NB=2, BH=2, D=8, 4 taps."""
    kw = dict(NB=2, C=5, widths=(256, 128), BH=2, D=8, n_taps=4, seed=3)
    return JLG._fixture(**kw), lanegather_probe._fixture(**kw, device="cpu")


@pytest.mark.parametrize("name", ["gather", "select"])
def test_chain_matches_jax_bitwise(name):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, LANE)).astype(np.float32)
    idx = rng.integers(0, LANE, (2, 8, LANE)).astype(np.int32)
    kern = {"gather": JLG._chain_gather_kernel,
            "select": JLG._chain_select_kernel}[name]
    want = np.asarray(_jax_chain(kern, jnp.asarray(x), jnp.asarray(idx), 4))
    fn = {"gather": lane_chain.chain_gather,
          "select": lane_chain.chain_select}[name]
    before = fn.launches
    got = fn(torch.from_numpy(x), torch.from_numpy(idx), 4)
    assert fn.launches == before          # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), want)


def test_fixtures_match_jax():
    (jw, jwT, ji, jiT, jg, jgT, jCp), (tw, twT, ti, tiT, tg, tgT, tCp) = \
        _tiny_fixture()
    assert jCp == tCp == LANE
    for j_list, t_list in ((jw, tw), (jwT, twT), (ji, ti), (jiT, tiT),
                           (jg, tg), (jgT, tgT)):
        for a, b in zip(j_list, t_list):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_contractions_match_jax():
    """K5 (``win2d_contract``) against the one-hot kernel and K4
    (``hier_gather``) against ``hier_gather_sample``, both in interpret
    mode, on the same fixture."""
    (jw, jwT, ji, jiT, jg, jgT, _), (tw, twT, ti, tiT, tg, tgT, _) = \
        _tiny_fixture()
    one = np.asarray(_jax_onehot(jw, ji, jg))
    hier = np.asarray(JLG.hier_gather_sample(jwT, jiT, jgT, interpret=True))
    before = (win2d.win2d_contract.launches, win2d.hier_gather.launches)
    got_one = lanegather_probe._onehot_reference(tw, ti, tg).numpy()
    got_hier = lanegather_probe.hier_gather_sample(twT, tiT, tgT).numpy()
    assert (win2d.win2d_contract.launches,
            win2d.hier_gather.launches) == before
    assert got_one.shape == one.shape and got_hier.shape == hier.shape
    for got, want in ((got_one, one), (got_hier, hier)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_lane_chain_kernels_refuse_cpu_tensors_and_bad_types():
    x = torch.zeros(2, 4, LANE)
    idx = torch.zeros(2, 4, LANE, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        lane_chain.chain_gather_cuda(x, idx, 2)
    with pytest.raises(ValueError, match="CUDA"):
        lane_chain.chain_select_cuda(x, idx, 2)


# ------------------------------------------------------- the probe script
def _tiny_encoder_inputs(seed=0, max_off_px=6.0, device="cpu"):
    """``encoder_inputs`` at small level shapes, batch, heads and points."""
    rng = np.random.default_rng(seed)
    shapes = [(12, 16), (6, 8), (3, 4)]
    S = sum(h * w for h, w in shapes)
    B, H, D, P = 2, 2, 4, 2
    value = torch.from_numpy(rng.standard_normal((B, S, H, D))) \
        .to(torch.bfloat16)
    refs = []
    for (h, w) in shapes:
        gy, gx = np.meshgrid((np.arange(h) + 0.5) / h,
                             (np.arange(w) + 0.5) / w, indexing="ij")
        refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
    off = rng.uniform(-max_off_px, max_off_px, (B, S, H, len(shapes), P, 2))
    norm = np.array([(w, h) for h, w in shapes], np.float64)
    loc = np.concatenate(refs, 0)[None, :, None, None, None, :] \
        + off / norm[None, None, None, :, None, :]
    attn = torch.from_numpy(rng.uniform(0, 1, (B, S, H, len(shapes), P)))
    attn = (attn / attn.sum((-1, -2), keepdim=True)).float()
    return (value.to(device), shapes, torch.from_numpy(loc).float().to(device),
            attn.to(device))


IMPLS = ("windowed", "windowed2d", "windowed2d_pallas", "pmerged", "pallas",
         "core")


def test_probe_op_sweep_on_cpu(monkeypatch, capsys):
    """Every impl prints its line with the JAX probe's fields; the windowed
    ones show the 1D plan in ``windows=`` (as the JAX probe does), no tap
    overflows at margin 5, and each agrees with ``core`` to the bf16
    value's rounding."""
    from snipper_tpu_torch.ops.deform_attn import windowed_sampling_plan

    monkeypatch.setattr(probe, "encoder_inputs", _tiny_encoder_inputs)
    rc = probe.main(["op", "--device", "cpu", "-K", "1",
                     "--impls", ",".join(IMPLS)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and lines[-1] == "DONE" and len(lines) == 7
    wins = str(windowed_sampling_plan([(12, 16), (6, 8), (3, 4)], 512, 5)[2])
    for impl, line in zip(IMPLS, lines):
        head, fields = line.split(": ", 1)
        assert head.strip() == f"{impl} bc=512 m=5"
        assert "ms/op-call" in fields and "overflow=0.0" in fields
        relerr = float(fields.split("relerr ")[1].split()[0])
        assert relerr <= 2.0 ** -7, line
        assert fields.endswith(
            f"windows={wins if impl.startswith('win') else '-'}"), line


def test_probe_op_exits_nonzero_when_an_impl_fails(monkeypatch, capsys):
    monkeypatch.setattr(probe, "encoder_inputs", _tiny_encoder_inputs)
    rc = probe.main(["op", "--device", "cpu", "-K", "1",
                     "--impls", "core,no_such_impl"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 1 and lines[-1] == "DONE"
    assert "FAIL ValueError: unknown op impl 'no_such_impl'" in lines[1]


def test_probe_lanegather_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(lanegather_probe, "HIER_FIXTURES",
                        ((2, 5, (256, 128)), (3, 40, (128,))))
    primitive = lanegather_probe.probe_primitive
    monkeypatch.setattr(
        lanegather_probe, "probe_primitive",
        lambda K, device: primitive(K=K, R=8, n=4, grid=2, device=device))
    rc = probe.main(["lanegather", "--device", "cpu", "-K", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and out.strip().splitlines()[-1] == "DONE"
    assert "FAIL" not in out
    assert out.count("ns/elem") == 2 and "gather/select per-elem ratio" in out
    assert out.count("one-hot MXU kernel") == 2
    assert out.count("x one-hot) [hier_gather") == 2


def test_probe_lanegather_prints_no_tpu_figure(monkeypatch, capsys):
    """The header names the device the probe ran on and no time: the JAX
    probe's TPU v5e figures are no measurement of the card."""
    monkeypatch.setattr(lanegather_probe, "HIER_FIXTURES",
                        ((2, 5, (256, 128)),))
    primitive = lanegather_probe.probe_primitive
    monkeypatch.setattr(
        lanegather_probe, "probe_primitive",
        lambda K, device: primitive(K=K, R=8, n=4, grid=2, device=device))
    assert probe.main(["lanegather", "--device", "cpu", "-K", "1"]) == 0
    out = capsys.readouterr().out
    header = out.splitlines()[0]
    assert header == "lane-gather probe on cpu"  # no figure, no TPU
    assert "TPU" not in out and "v5e" not in out


def test_probe_runs_on_cuda_by_default(monkeypatch):
    """Without a card the probe raises; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["op"], ["lanegather"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            probe.main(argv)
