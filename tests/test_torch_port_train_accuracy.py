"""The port's training against JAX's over many updates, and the port's
counterpart of tests/test_train_accuracy.py.

``test_train_cli_recovers_eval_accuracy`` (``slow``, as JAX's test is) runs
JAX's protocol through the port's ``cli.train`` and ``cli.eval`` on the CPU
in f32: the tiny preset overfit on 8 fixed synthetic samples for 400
updates with the StepLR drop at epoch 10, its checkpoint evaluated, under
JAX's bars.

The trajectory tests hold 12 f32 updates of the port's ``train_step``
against JAX's ``make_train_step``: the same seeded weights, the same 4
synthetic samples in batches of 2 in the same order, the accuracy recipe's
rates (lr 1e-3, lr_backbone 5e-4) with the StepLR drop after 8 updates
(``steps_per_epoch=4``, ``lr_drop=2``). They cover what one step cannot:
AdamW's moments, the drop, and the matching as the predictions move.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import snipper_tpu.losses.criterion as jcriterion
import snipper_tpu_torch.losses.criterion as tcriterion
from snipper_tpu.config import Config as JaxConfig
from snipper_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from snipper_tpu.losses.criterion import SetCriterion as JaxCriterion
from snipper_tpu.models import snipper as jsnipper
from snipper_tpu.train.state import create_train_state as jax_train_state
from snipper_tpu.train.state import step_lr
from snipper_tpu.train.step import make_train_step
from snipper_tpu_torch.config import Config
from snipper_tpu_torch.convert import state_dict_from_jax
from snipper_tpu_torch.data.loader import DataLoader
from snipper_tpu_torch.data.synthetic import SyntheticDataset
from snipper_tpu_torch.losses.criterion import SetCriterion
from snipper_tpu_torch.train.state import create_train_state, param_label
from snipper_tpu_torch.train.step import batch_to_device, train_step
from test_torch_port_train import _port_model, _random_params, _to_jax

CPU = torch.device("cpu")
RECIPE = dict(dropout=0.0, batch_size=2, lr=1e-3, lr_backbone=5e-4,
              lr_drop=2)
STEPS_PER_EPOCH, UPDATES = 4, 12

# 12 updates of two f32 implementations whose sums run in other orders:
# AdamW turns the roundoff of near-zero gradients into full-size steps, so
# the trajectories part by roundoff that grows with every update (measured
# at this seed: loss within 1.0e-5 relative, grad norm within 9.3e-5; the
# one-step test's bars are 1e-5 and 1e-4)
TOL_LOSS = 1e-4
TOL_GRAD_NORM = 1e-3
# after update 12, per trained tensor: the distance to JAX's parameters
# against the distance JAX's parameters moved (measured <= 0.0060), and the
# 99th percentile of the elementwise difference in AdamW steps at the
# group's current lr, 1e-4 main, 5e-5 backbone, 1e-5 sampling projections
# (measured <= 0.38 steps; the bar, 2, is a fifth of a step at the
# pre-drop lr)
TOL_UPDATE_REL = 0.05
TOL_Q99_STEPS = 2.0


@pytest.fixture(scope="module")
def trajectory():
    """Both packages through the same 12 updates. Each layer's assignment
    is caught where the criterion computes it: JAX's through a wrapper of
    ``match`` that sends the jitted step's result to the host, the port's
    through a wrapper of ``match_layers``."""
    jcfg = JaxConfig.tiny().replace(**RECIPE)
    cfg = Config.tiny().replace(**RECIPE)
    jm = jsnipper.build_model(jcfg)
    x = jnp.zeros((1, jcfg.num_frames, jcfg.input_height, jcfg.input_width,
                   3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x))["params"]
    params = _random_params(shapes, 5)
    loader = DataLoader(SyntheticDataset(cfg, n_samples=4, seed=0,
                                         distinct=4), 2, shuffle=True)
    batches = []
    for epoch in range(UPDATES // len(loader)):
        loader.set_epoch(epoch)
        batches += list(loader)

    j_match, t_match, layer_of_trace = {}, [], [0]
    match, match_layers = jcriterion.match, tcriterion.match_layers

    def j_spy(*args, **kwargs):
        src, valid = match(*args, **kwargs)
        layer = layer_of_trace[0]  # the criterion's order, final first
        layer_of_trace[0] += 1
        jax.debug.callback(
            lambda s: j_match.setdefault(layer, []).append(np.asarray(s)),
            src)
        return src, valid

    def t_spy(*args, **kwargs):
        src = match_layers(*args, **kwargs)
        t_match.append([s.numpy().copy() for s in src])
        return src

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcriterion, "match", j_spy)
        mp.setattr(tcriterion, "match_layers", t_spy)
        state, tx = jax_train_state(jcfg, _to_jax(params),
                                    steps_per_epoch=STEPS_PER_EPOCH)
        step = make_train_step(jm, JaxCriterion(jcfg), tx, donate=False,
                               mixed_precision=False)
        model = _port_model(cfg, params)
        tstate = create_train_state(cfg, model,
                                    steps_per_epoch=STEPS_PER_EPOCH)
        crit = SetCriterion(cfg)
        gen = torch.Generator().manual_seed(0)
        j_metrics, t_metrics, lrs = [], [], []
        for host in batches:
            state, jm_ = step(state, {"images": jnp.asarray(host["images"]),
                                      "targets": _to_jax(host["targets"])},
                              jax.random.PRNGKey(0))
            j_metrics.append({k: float(v)
                              for k, v in jax.device_get(jm_).items()})
            jax.effects_barrier()
            t_metrics.append({k: v.item() for k, v in train_step(
                tstate, crit, batch_to_device(host, CPU), gen,
                mixed_precision=False).items()})
            lrs.append([g["lr"] for g in tstate.optimizer.param_groups])
    return dict(
        cfg=cfg, batches=batches, j_metrics=j_metrics, t_metrics=t_metrics,
        j_match=[[j_match[layer][i] for layer in sorted(j_match)]
                 for i in range(len(batches))],
        t_match=t_match, lrs=lrs, init=state_dict_from_jax(params),
        j_params=state_dict_from_jax(jax.device_get(state.params)),
        t_params=model.state_dict(), tstate=tstate)


def test_trajectory_losses_and_grad_norms_match_jax(trajectory):
    """``loss_total`` and ``grad_norm`` of every update, and the learning
    rate each update took: JAX's StepLR per group, dropping 10x after
    update 8."""
    r = trajectory
    assert len(r["t_metrics"]) == UPDATES
    for i, (got, want) in enumerate(zip(r["t_metrics"], r["j_metrics"])):
        for key, tol in (("loss_total", TOL_LOSS),
                         ("grad_norm", TOL_GRAD_NORM)):
            assert abs(got[key] - want[key]) <= tol * abs(want[key]), \
                (i, key, got[key], want[key])
    cfg = r["cfg"]
    bases = (cfg.lr_backbone, cfg.lr * cfg.lr_linear_proj_mult, cfg.lr)
    for i, lrs in enumerate(r["lrs"]):
        want = [step_lr(b, cfg.lr_drop, STEPS_PER_EPOCH)(i) for b in bases]
        np.testing.assert_allclose(lrs, want, rtol=1e-12, err_msg=str(i))
    assert r["lrs"][7][-1] == cfg.lr and r["lrs"][8][-1] == cfg.lr * 0.1
    assert r["tstate"].updates == UPDATES
    losses = [m["loss_total"] for m in r["t_metrics"]]
    assert losses[-1] < 0.5 * losses[0], losses


def test_trajectory_matching_matches_jax(trajectory):
    """Every decoder layer's Hungarian assignment at every update equals
    JAX's on every target slot, padding included: the port solves with
    JAX's Jonker-Volgenant algorithm (``ops/lsa.py``), which breaks the
    ties of the all-zero padding columns as JAX's does."""
    r = trajectory
    n_layers = r["cfg"].dec_layers
    for i, host in enumerate(r["batches"]):
        valid = host["targets"]["valid"]
        assert valid.any()
        got, want = r["t_match"][i], r["j_match"][i]
        assert len(got) == len(want) == n_layers, (i, len(got), len(want))
        for layer, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w,
                                          err_msg=f"update {i} layer {layer}")


def test_trajectory_params_match_jax(trajectory):
    """Every parameter after update 12. The frozen set is untouched in
    both. Per trained tensor, the distance to JAX's parameters is within
    5% of the distance JAX's moved, and 99% of its elements are within two
    AdamW steps at the group's current lr. No elementwise maximum is set:
    a few elements of the deepest backbone convolutions, whose gradients
    are near zero, part by up to 18 steps at the current lr (1.8 at the
    pre-drop lr), each a roundoff that AdamW scaled to a full step."""
    r = trajectory
    cfg = r["cfg"]
    lr_now = {k: step_lr(b, cfg.lr_drop, STEPS_PER_EPOCH)(UPDATES - 1)
              for k, b in (("backbone", cfg.lr_backbone),
                           ("proj", cfg.lr * cfg.lr_linear_proj_mult),
                           ("main", cfg.lr))}
    n_moved = 0
    for name, got in r["t_params"].items():
        want, init = r["j_params"][name], r["init"][name]
        label = param_label(name)
        if label == "frozen":
            assert torch.equal(got, init) and torch.equal(want, init), name
            continue
        moved = (want - init).norm().item()
        if moved == 0.0:
            assert torch.equal(got, init), name
            continue
        n_moved += 1
        diff = (got - want).abs().flatten().double()
        assert diff.norm().item() <= TOL_UPDATE_REL * moved, \
            (name, diff.norm().item(), moved)
        q99 = torch.quantile(diff, 0.99).item() / lr_now[label]
        assert q99 <= TOL_Q99_STEPS, (name, q99, diff.max().item())
    assert n_moved > 100


def test_overfit_set_cache_is_read_only():
    """The overfit set's cache hands out JAX's samples, each visit in its
    own dicts over read-only arrays: a consumer that wrote into a cached
    sample would raise instead of changing every later visit (the
    synthetic set's cache returns one dict per index in JAX,
    ``snipper_tpu/data/synthetic.py``)."""
    cfg = Config.tiny()
    ds = SyntheticDataset(cfg, n_samples=6, distinct=3)
    want = JaxSynthetic(JaxConfig.tiny(), n_samples=6, distinct=3)[4]
    a, b = ds[1], ds[4]
    assert a is not b and a["targets"] is not b["targets"]
    np.testing.assert_array_equal(a["images"], want["images"])
    for k, v in want["targets"].items():
        np.testing.assert_array_equal(a["targets"][k], v, err_msg=k)
    with pytest.raises(ValueError, match="read-only"):
        a["images"][0, 0, 0, 0] = 0.0
    with pytest.raises(ValueError, match="read-only"):
        a["targets"]["kpts2d"][0] = 0.0
    a["targets"]["valid"] = None  # this visit's own dict
    assert ds[1]["targets"]["valid"] is not None
    assert np.shares_memory(ds[1]["images"], b["images"])
    # without ``distinct`` nothing is cached and samples stay writable
    assert SyntheticDataset(cfg, n_samples=2)[0]["images"].flags.writeable


# ------------------------------------------------ train-to-accuracy (slow)
def _run_eval(outdir, resume=None):
    from snipper_tpu_torch.cli import eval as eval_cli

    argv = ["--preset", "tiny", "--synthetic",
            "--synthetic_samples", "8", "--synthetic_distinct", "8",
            "--overfit", "--batch_size", "8", "--num_workers", "0",
            "--dropout", "0.0", "--device", "cpu", "--output_dir", outdir]
    if resume:
        argv += ["--resume", resume]
    eval_cli.main(argv)
    with open(os.path.join(outdir, "eval_stats.json")) as f:
        return json.load(f)


@pytest.mark.slow
def test_train_cli_recovers_eval_accuracy(tmp_path):
    """tests/test_train_accuracy.py through the port's CLIs: the random-
    init floor, 400 f32 updates of 8 (25 an epoch, 16 epochs, StepLR 10x
    at epoch 10, lr 1e-3, lr_backbone 5e-4), the checkpoint's eval, and
    JAX's bars (tests/test_train_accuracy.py:54, :87-95) unchanged."""
    from snipper_tpu_torch.cli import train as train_cli

    train_dir = str(tmp_path / "train")
    stats0 = _run_eval(str(tmp_path / "eval_init"))
    assert stats0["3dpck"] < 0.2, stats0

    res = train_cli.main([
        "--preset", "tiny", "--synthetic",
        "--synthetic_samples", "200", "--synthetic_distinct", "8",
        "--overfit", "--batch_size", "8", "--epochs", "16",
        "--lr_drop", "10", "--lr", "0.001", "--lr_backbone", "0.0005",
        "--dropout", "0.0", "--no-mixed_precision", "--num_workers", "0",
        "--eval_every", "16", "--device", "cpu", "--output_dir", train_dir])
    assert len(res["history"]) == 400
    ckpts = sorted(os.listdir(os.path.join(train_dir, "ckpts")))
    assert ckpts, "no checkpoint written"
    ckpt = os.path.join(train_dir, "ckpts", ckpts[-1])
    log_lines = [json.loads(line) for line in
                 open(os.path.join(train_dir, "log.txt"))]
    assert len(log_lines) == 16
    assert [("test_3dpck" in line) for line in log_lines] == \
        [False] * 15 + [True]

    stats = _run_eval(str(tmp_path / "eval_trained"), resume=ckpt)
    assert stats["3dpck"] >= 0.70, stats
    assert stats["future_3dpck"] >= 0.70, stats
    assert stats["pel_mpjpe_joint"] <= 0.12, stats
    assert stats["mpjpe_root"] <= 0.25, stats
    assert stats["mpjpe_joint"] <= 0.30, stats
    assert stats["3dpck"] > stats0["3dpck"] + 0.5, (stats0, stats)
    assert stats["pel_mpjpe_joint"] < stats0["pel_mpjpe_joint"] * 0.1, (
        stats0, stats)
    print("train-to-accuracy:", {k: round(v, 4) for k, v in stats.items()
                                 if not k.startswith("loss")})
