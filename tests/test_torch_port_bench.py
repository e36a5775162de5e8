"""The port's bench (``snipper_tpu_torch/bench.py``) on the CPU.

- ``bench.main(["--device", "cpu"])`` with every preset cut to tiny
  widths prints one JSON line holding every key of the root ``bench.py``'s
  record (read from its source with ``ast``, neither imported nor run),
  with ``device`` ``{"platform": "cpu"}``, no leg at ``FAIL`` and none of
  the root bench's TPU figures; a leg that raises reads ``FAIL`` and the
  bench exits 1; ``SNIPPER_BENCH_PARAMS`` loads a trainer checkpoint;
  ``python -m`` answers ``--help`` with ``--device`` its one flag.
- The bench's forward (JAX's bf16 recipe: a bf16 copy of every f32
  weight made once, a bf16 input) against JAX's bf16-parameter ``apply``
  (the root bench's casts, exact ``pmerged`` sampling) on the same
  numpy-seeded weights and input: each output within 4 bf16 units
  (4 * 2^-7) of its largest magnitude, the bar of
  ``tests/test_torch_port_export.py``; and every forward the value,
  configs and fast legs time sees only bf16 weights and a bf16 input and
  casts no weight (counted below the dispatcher).
- The MSDA operation count: the operator's flop formula at a small shape,
  and the MSDA term of a tiny forward's count, against hand counts.
"""

import ast
import re
import subprocess
import sys
import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from snipper_tpu_torch import bench
from snipper_tpu_torch.config import Config
from snipper_tpu_torch.convert import state_dict_from_jax
from snipper_tpu_torch.models.snipper import bf16_params
from snipper_tpu_torch.ops.msda import msda_forward_flops
from test_torch_port_model import TINY, japply, snipper_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_UNITS = 4 * 2.0 ** -7
# the root bench's TPU figures (XLA cost analysis and the v5e HBM floor):
# none may reach the port's line
TPU_FIGURES = ("1.27", "50.7", "62.0", "819")
# tiny widths for every preset; each keeps its frame counts
TINY_WIDTHS = {k: v for k, v in TINY.items()
               if k not in ("num_frames", "num_future_frames", "deform_impl")}


def tiny_preset(name):
    """Preset ``name`` at tiny widths, for ``bench.make_cfg``."""
    return getattr(Config, name)().replace(**TINY_WIDTHS)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tiny models' small ops do not gain from
    more, and under a parallel run the workers' threads would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def root_bench_keys():
    """The keys of the ``rec`` dict in the root ``bench.py``'s ``main``."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "rec"
                for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py has no rec dict")


def test_bench_line_has_the_root_keys(monkeypatch, capsys):
    monkeypatch.setattr(bench, "make_cfg", tiny_preset)
    for name, k in (("VALUE_K", 2), ("TRAIN_K", 1), ("CONFIG_K", 1),
                    ("FAST_K", 1)):
        monkeypatch.setattr(bench, name, k)
    # r480 would blow the tiny input up to 480x720
    monkeypatch.setenv("SNIPPER_BENCH_FAST", "p2,r48")
    monkeypatch.delenv("SNIPPER_BENCH_CONFIGS", raising=False)
    monkeypatch.delenv("SNIPPER_BENCH_PARAMS", raising=False)
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    keys = root_bench_keys()
    assert len(keys) == 20 and "x_hbm_floor" in keys
    assert keys <= set(rec), sorted(keys - set(rec))
    assert set(rec) - keys == {"device"}
    assert rec["device"] == {"platform": "cpu"}
    assert "FAIL" not in lines[0]
    assert not any(f in lines[0] for f in TPU_FIGURES), lines[0]
    assert isinstance(rec["value"], float) and rec["value"] > 0
    assert len(rec["passes_snippets_per_sec"]) == 2
    assert rec["sampling_impl"] == "plain"
    assert rec["sampling_overflow"] == 0
    assert rec["dtype"] == "bfloat16"
    assert rec["weights"] == "init(seed 0)"
    assert rec["x_hbm_floor"] is None    # a CPU time against no bound
    assert rec["analytic_tflop"] > 0 and rec["analytic_hbm_gb"] > 0
    assert isinstance(rec["train_step_ms_T4F2_bf16mp_b2"], float)
    assert len(rec["train_step_passes_ms"]) == 2
    assert list(rec["configs_snippets_per_sec"]) == ["light_t1_b4"]
    assert list(rec["fast_snippets_per_sec"]) == ["p2,r48"]
    assert rec["baseline_bracket"] == [5.0, 14.0]


def test_bench_records_a_failed_leg_and_exits_nonzero(monkeypatch, capsys):
    """A leg that raises reads ``FAIL <ExcName>`` under its key, the other
    legs still run, and the bench exits non-zero after the line."""
    monkeypatch.setattr(bench, "make_cfg", tiny_preset)
    monkeypatch.setattr(bench, "value_leg", lambda *a: 1 / 0)
    monkeypatch.setattr(bench, "train_leg", lambda *a: [5.0, 4.0])
    monkeypatch.setattr(bench, "config_leg", lambda *a: 3.0)
    monkeypatch.setenv("SNIPPER_BENCH_FAST", "p2,r48")
    monkeypatch.delenv("SNIPPER_BENCH_CONFIGS", raising=False)
    assert bench.main(["--device", "cpu"]) == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["value"] == "FAIL ZeroDivisionError"
    assert rec["train_step_ms_T4F2_bf16mp_b2"] == 4.0
    assert rec["configs_snippets_per_sec"] == {"light_t1_b4": 3.0}
    # the fast leg maps the value leg's weights, which do not exist
    assert rec["fast_snippets_per_sec"] == {"p2,r48": "FAIL RuntimeError"}


def test_value_leg_takes_a_checkpoint(monkeypatch, tmp_path):
    """``SNIPPER_BENCH_PARAMS``: a trainer checkpoint's ``params`` are the
    value leg's weights (and the fast leg's), named in ``weights``; one of
    other shapes raises."""
    from snipper_tpu_torch.models.snipper import build_model
    from snipper_tpu_torch.train.checkpoint import save_checkpoint

    monkeypatch.setattr(bench, "make_cfg", tiny_preset)
    monkeypatch.setattr(bench, "VALUE_K", 1)
    params = build_model(tiny_preset("canonical_t4"), device="cpu",
                         seed=5).state_dict()
    path = save_checkpoint(str(tmp_path), {"params": params, "step": 0}, 0)
    monkeypatch.setenv("SNIPPER_BENCH_PARAMS", path)
    val = bench.value_leg(torch.device("cpu"), np.random.default_rng(0))
    assert val["weights"] == f"trained({path})"
    assert all(torch.equal(val["state"][k], v)
               for k, v in bf16_params(params).items())
    wide = build_model(tiny_preset("canonical_t4").replace(hidden_dim=192),
                       device="cpu").state_dict()
    path = save_checkpoint(str(tmp_path), {"params": wide, "step": 0}, 1)
    monkeypatch.setenv("SNIPPER_BENCH_PARAMS", path)
    with pytest.raises(RuntimeError, match="size mismatch"):
        bench.value_leg(torch.device("cpu"), np.random.default_rng(0))


def test_bench_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])


def test_bf16_forward_matches_jax_bf16_params():
    """The bench's forward (the model of ``bench.bf16_net`` on the input of
    ``bench.input_batch``) against JAX's forward on bf16 weights and a
    bf16 input (``bench.py:127-133``), exact sampling. Measured on the
    CPU: 2.07 / 2.19 / 1.90 bf16 units on the predictions and 0.88 / 1.38
    / 0.93 on the heatmaps; bf16 autocast on f32 weights, the bench's
    earlier recipe, gave 1.91 / 2.05 / 1.90 and 2.90 / 3.11 / 2.22. JAX's
    own jitted and op-by-op bf16 forwards differ by up to 1.91 units here,
    so the bar stays at 4."""
    kw = {**TINY, "deform_impl": "pmerged"}
    jm, params, _ = snipper_pair(kw, seed=3, batch=1)
    cfg = Config(**kw)
    tm = bench.bf16_net(cfg, "cpu", state=state_dict_from_jax(params))
    x = bench.input_batch(np.random.default_rng(0), cfg, 1, "cpu")
    assert x.dtype == torch.bfloat16
    got = bench.forward(tm, x)
    pb = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16)
        if a.dtype == np.float32 else a, params)
    want = japply(jm, pb, jnp.asarray(x.float().numpy(), jnp.bfloat16))
    assert want["pred_logits"].dtype == jnp.bfloat16
    assert got["pred_logits"].dtype == torch.bfloat16
    pairs = [(k, got[k], want[k])
             for k in ("pred_logits", "pred_kpts2d", "pred_depth")]
    pairs += [(f"heatmaps{i}", g, w)
              for i, (g, w) in enumerate(zip(got["heatmaps"],
                                             want["heatmaps"]))]
    for k, g, w in pairs:
        w = np.asarray(w, np.float32)
        tol = BF16_UNITS * max(1.0, np.abs(w).max())
        assert np.abs(g.float().numpy() - w).max() <= tol, k


class WeightCasts(TorchDispatchMode):
    """Counts the dtype conversions (``to``, ``_to_copy``, ``copy_``, ...)
    that read one of the given storages into another dtype, and every op,
    below autograd."""

    aten, prims = torch.ops.aten, torch.ops.prims
    CASTS = (aten.to, aten._to_copy, prims.convert_element_type,
             aten.copy_, aten.copy)

    def __init__(self, tensors):
        super().__init__()
        self.storages = {t.untyped_storage().data_ptr() for t in tensors}
        self.casts = self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in self.CASTS:
            copy = func.overloadpacket is self.aten.copy_
            src = args[1] if copy else args[0]
            dst = args[0] if copy else out
            if isinstance(src, torch.Tensor) and src.dtype != dst.dtype \
                    and src.untyped_storage().data_ptr() in self.storages:
                self.casts += 1
        return out


def test_timed_forwards_cast_no_weight(monkeypatch):
    """Every forward that the value, configs and fast legs time runs on
    bf16 parameters and buffers only, on a bf16 input, and converts none
    of them: the bf16 copy is made once, before the timing. The counter
    itself catches a weight cast inside a forward."""
    monkeypatch.setattr(bench, "make_cfg", tiny_preset)
    monkeypatch.setattr(bench, "VALUE_K", 1)
    monkeypatch.setattr(bench, "CONFIG_K", 1)
    monkeypatch.setattr(bench, "FAST_K", 1)
    monkeypatch.delenv("SNIPPER_BENCH_PARAMS", raising=False)
    lin = torch.nn.Linear(4, 4)
    for mode in (torch.no_grad, torch.inference_mode):
        with mode(), WeightCasts([lin.weight]) as probe:
            torch.nn.functional.linear(
                torch.ones(2, 4, dtype=torch.bfloat16),
                lin.weight.to(torch.bfloat16))
        assert probe.casts == 1

    calls = []
    forward = bench.forward

    def spy(model, x):
        weights = [*model.parameters(), *model.buffers()]
        with WeightCasts(weights) as mode:
            out = forward(model, x)
        calls.append(({t.dtype for t in weights}, x.dtype, mode.casts,
                      mode.ops))
        return out

    monkeypatch.setattr(bench, "forward", spy)
    dev, rng = torch.device("cpu"), np.random.default_rng(0)
    val = bench.value_leg(dev, rng)
    bench.config_leg("light_t1", 4, dev, rng)
    bench.fast_leg("p2,r48", bench.make_cfg("canonical_t4"), val["state"],
                   dev, rng)
    # each leg: a warm-up call, then two passes of one
    assert len(calls) == 9
    for dtypes, x_dtype, casts, ops in calls:
        assert dtypes == {torch.bfloat16} and x_dtype == torch.bfloat16
        assert casts == 0 and ops > 100


def test_msda_flop_formula_is_the_hand_count():
    """One ``msda_forward`` on meta tensors at N=2, Lq=5, H=3, L=2, P=4,
    D=8: per tap 4 corners x 8 channels x 2 (multiply-add) and 4 x 2 for
    the corner weights (bilinear product, attention scaling)."""
    shapes = [(4, 6), (2, 3)]
    S = sum(h * w for h, w in shapes)
    with torch.device("meta"):
        value = torch.empty(2, S, 3, 8)
        loc = torch.empty(2, 5, 3, 2, 4, 2)
        attn = torch.empty(2, 5, 3, 2, 4)
    op = torch.ops.snipper_tpu_torch.msda_forward
    counter = FlopCounterMode(display=False,
                              custom_mapping={op: msda_forward_flops})
    with counter:
        out = op(value, [4, 6, 2, 3], loc, attn)
    assert tuple(out.shape) == (2, 5, 24)
    taps = 2 * 5 * 3 * 2 * 4
    assert counter.get_total_flops() == taps * (4 * 8 * 2 + 4 * 2) == 17280


def test_forward_count_holds_every_msda_call():
    """The MSDA term of a tiny forward's count: each encoder layer samples
    the B*T frames' S pixels, each decoder layer the B*T1 frames' queries,
    H heads x L levels x P points each."""
    cfg = Config(**TINY)
    total, msda = bench.forward_flops(cfg)
    S = sum(h * w for h, w in ((8, 12), (4, 6), (2, 3)))  # 64x96 / 8,16,32
    H, L, D = cfg.nheads, cfg.num_feature_levels, cfg.hidden_dim // cfg.nheads
    per_tap = 8 * D + 8
    enc = cfg.num_frames * S * H * L * cfg.enc_n_points * per_tap
    dec = (cfg.num_frames + cfg.num_future_frames) * cfg.num_queries \
        * H * L * cfg.dec_n_points * per_tap
    assert msda == cfg.enc_layers * enc + cfg.dec_layers * dec
    assert total > msda


def test_bench_runs_as_a_module():
    """``python -m snipper_tpu_torch.bench --help`` answers, with
    ``--device`` its one flag."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-m", "snipper_tpu_torch.bench", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    flags = set(re.findall(r"--\w+", proc.stdout.split("options:")[-1]))
    assert flags == {"--help", "--device"}, flags
