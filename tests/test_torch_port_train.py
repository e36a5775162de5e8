"""The port's training slice against the JAX package's: matcher, heatmap
targets, criterion, one train step, gradient accumulation, dropout and
mixed precision.

Inputs are numpy from a seed, fed to both packages; weights go from the
flax tree to the port through ``convert.state_dict_from_jax``. Everything
runs in f32 on the CPU with dropout 0, except the dropout check and the
mixed-precision checks: one holds the port's mixed precision (JAX's bf16
recipe: the forward on bf16 copies of the f32 weights and on bf16 images)
against its own f32 steps, the other against JAX's mixed-precision step,
both at the 5% bar of tests/test_train_step.py; a third checks what the
recipe's forward sees and what gradients the masters get.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snipper_tpu.config import Config as JaxConfig
from snipper_tpu.losses import heatmap as jheatmap
from snipper_tpu.losses.criterion import SetCriterion as JaxCriterion
from snipper_tpu.matching import matcher as jmatcher
from snipper_tpu.models import snipper as jsnipper
from snipper_tpu.train import engine as jengine
from snipper_tpu.train.state import create_train_state as jax_train_state
from snipper_tpu.train.state import mask_frozen_grads
from snipper_tpu.train.step import make_train_step
from snipper_tpu_torch.config import Config
from snipper_tpu_torch.convert import state_dict_from_jax
from snipper_tpu_torch.data.snippet import stack_batch
from snipper_tpu_torch.data.synthetic import SyntheticDataset
from snipper_tpu_torch.losses import heatmap as theatmap
from snipper_tpu_torch.losses.criterion import SetCriterion, loss_weight_dict
from snipper_tpu_torch.matching import matcher as tmatcher
from snipper_tpu_torch.models.snipper import build_model
from snipper_tpu_torch.train import engine as tengine
from snipper_tpu_torch.train.state import create_train_state, param_label
from snipper_tpu_torch.train.step import (batch_to_device, forward_loss,
                                          train_step)

CPU = torch.device("cpu")
B, NQ, T1, K, M = 2, 8, 3, 15, 4
MAXD = 15.0


def _problem(seed, n_layers=3, heatmap_shapes=((8, 12), (4, 6)), nq=NQ,
             m=M):
    """Random decoder outputs of ``n_layers`` layers (the last is final,
    the others aux) over ``nq`` queries, encoder heatmaps, and targets
    padded to ``m`` persons with 3 and 1 valid."""
    rng = np.random.default_rng(seed)

    def layer():
        return (rng.standard_normal((B, nq, T1, 2)).astype(np.float32),
                rng.uniform(0, 1, (B, nq, T1, K, 3)).astype(np.float32),
                rng.uniform(0, 1, (B, nq, T1, K, 1)).astype(np.float32))

    layers = [layer() for _ in range(n_layers)]
    outputs = {"pred_logits": layers[-1][0], "pred_kpts2d": layers[-1][1],
               "pred_depth": layers[-1][2]}
    if n_layers > 1:
        outputs["aux_logits"] = np.stack([lay[0] for lay in layers[:-1]])
        outputs["aux_kpts2d"] = np.stack([lay[1] for lay in layers[:-1]])
        outputs["aux_depth"] = np.stack([lay[2] for lay in layers[:-1]])
    t_obs = T1 - 1
    outputs["heatmaps"] = [
        rng.standard_normal((B, t_obs, h, w, 4, K)).astype(np.float32) * 0.1
        for h, w in heatmap_shapes]
    kpts = np.zeros((B, m, T1, K, 3), np.float32)
    depth = np.zeros((B, m, T1, K, 2), np.float32)
    valid = np.zeros((B, m), bool)
    for b, m in enumerate((3, 1)):
        kpts[b, :m] = rng.uniform(0, 1, (m, T1, K, 3))
        kpts[b, :m, ..., 2] = (kpts[b, :m, ..., 2] > 0.3).astype(np.float32)
        depth[b, :m] = rng.uniform(0, 1, (m, T1, K, 2))
        depth[b, :m, ..., 1] = (depth[b, :m, ..., 1] > 0.3).astype(
            np.float32)
        valid[b, :m] = True
    # a visible keypoint at x in (-1/w, 0): truncation puts it in column 0
    kpts[0, 0, 0, 3, :] = [-0.4 / 12, 0.5, 1.0]
    return outputs, {"kpts2d": kpts, "depth": depth, "valid": valid}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------- matcher
def test_cost_matrix_matches_jax():
    outputs, targets = _problem(0)
    w = JaxCriterion(JaxConfig()).match_weights
    args = (outputs["pred_logits"], outputs["pred_kpts2d"],
            outputs["pred_depth"], targets["kpts2d"], targets["depth"])
    got = tmatcher.cost_matrix(*_to_torch(list(args)), MAXD, w).numpy()
    want = np.asarray(jmatcher.cost_matrix(*_to_jax(list(args)), MAXD, w))
    assert got.shape == (B, NQ, M)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_match_src_idx_matches_jax_on_valid_slots():
    """The ``solver="scipy"`` cross-check on the host against the JAX
    device solver; padding columns are all zero, so the two may order them
    differently: only the valid slots are compared (the default solver is
    held on every slot in tests/test_torch_port_lsa.py)."""
    outputs, targets = _problem(1)
    w = JaxCriterion(JaxConfig()).match_weights
    tt = _to_torch(targets)
    layers = [(_to_torch(outputs["aux_logits"][i]),
               _to_torch(outputs["aux_kpts2d"][i]),
               _to_torch(outputs["aux_depth"][i])) for i in range(2)]
    layers.insert(0, tuple(_to_torch([outputs["pred_logits"],
                                      outputs["pred_kpts2d"],
                                      outputs["pred_depth"]])))
    got = tmatcher.match_layers(layers, tt, MAXD, w, solver="scipy")
    assert len(got) == 3
    for (lg, kp, dp), src in zip(layers, got):
        want, _ = jmatcher.match(
            {"pred_logits": jnp.asarray(lg.numpy()),
             "pred_kpts2d": jnp.asarray(kp.numpy()),
             "pred_depth": jnp.asarray(dp.numpy())},
            _to_jax(targets), MAXD, w, solver="jax")
        valid = targets["valid"]
        np.testing.assert_array_equal(src.numpy()[valid],
                                      np.asarray(want)[valid])


# ---------------------------------------------------------------- heatmaps
@pytest.mark.parametrize("h,w", [(8, 12), (30, 41)])
def test_heatmap_targets_match_jax(h, w):
    """Scatter (truncation toward zero: the keypoint at x in (-1, 0) of a
    pixel lands in column 0) and the reflect-padded blur."""
    _, targets = _problem(2)
    tk, tv = torch.from_numpy(targets["kpts2d"]), torch.from_numpy(
        targets["valid"])
    maps = theatmap.scatter_keypoint_maps(tk, tv, T1 - 1, h, w).numpy()
    want_maps = np.asarray(jheatmap.scatter_keypoint_maps(
        jnp.asarray(targets["kpts2d"]), jnp.asarray(targets["valid"]),
        T1 - 1, h, w))
    np.testing.assert_array_equal(maps, want_maps)
    if (h, w) == (8, 12):
        assert maps[0, 0, int(0.5 * h), 0, 3] == 1.0
    got = theatmap.heatmap_targets(tk, tv, T1 - 1, h, w).numpy()
    want = np.asarray(jheatmap.heatmap_targets(
        jnp.asarray(targets["kpts2d"]), jnp.asarray(targets["valid"]),
        T1 - 1, h, w))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- criterion
@pytest.mark.parametrize("num_traj,nq,m,max_depth", [
    pytest.param(None, NQ, M, MAXD, id="None"),
    pytest.param(2.5, NQ, M, MAXD, id="2.5"),
    # panoptic's square matching (num_queries == max_persons) at its depth
    # range, and jta_forecast's depth range
    pytest.param(None, M, M, 5.0, id="square-depth5"),
    pytest.param(2.5, NQ, M, 60.0, id="depth60")])
def test_criterion_matches_jax(num_traj, nq, m, max_depth):
    """Every loss of the final and the aux layers, the heatmap loss and
    the weighted total, to 1e-5 (relative for the heatmap sum)."""
    outputs, targets = _problem(3, nq=nq, m=m)
    kw = dict(num_kpts=K, max_persons=m, num_queries=nq,
              max_depth=max_depth)
    total, losses, src = SetCriterion(Config(**kw), dp_size=2)(
        _to_torch(outputs), _to_torch(targets),
        num_traj=None if num_traj is None else np.float32(num_traj))
    j_total, j_losses, j_src = JaxCriterion(JaxConfig(**kw), dp_size=2)(
        _to_jax(outputs), _to_jax(targets),
        num_traj=None if num_traj is None else jnp.float32(num_traj))
    assert set(losses) == set(j_losses)
    assert "loss_cont_1" in losses and "loss_heatmap" in losses
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(j_losses[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(total.item(), float(j_total), rtol=1e-5)
    valid = targets["valid"]
    np.testing.assert_array_equal(src.numpy()[valid],
                                  np.asarray(j_src)[valid])


def test_loss_weights_by_suffix():
    """An aux loss takes its base name's weight; depth terms are off with
    max_depth -1."""
    w = loss_weight_dict(Config(max_depth=-1.0))
    assert w["loss_root_depth"] == 0.0 and w["loss_root"] == 1.0
    outputs, targets = _problem(4, n_layers=2)
    cfg = Config(num_kpts=K, max_persons=M, num_queries=NQ)
    total, losses, _ = SetCriterion(cfg)(_to_torch(outputs),
                                         _to_torch(targets))
    weights = loss_weight_dict(cfg)
    want = sum(weights[k.rsplit("_", 1)[0] if k.endswith("_0") else k]
               * v.item() for k, v in losses.items())
    np.testing.assert_allclose(total.item(), want, rtol=1e-6)


# ------------------------------------------------------------- train step
TINY = dict(dropout=0.0, batch_size=2)


def _random_params(shapes_tree, seed):
    """numpy params in the shapes of a flax tree, with sampling
    projections that move the sampling points (as
    tests/test_torch_port_model.py draws them)."""
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
        return rng.standard_normal(shape)

    def walk(node, path):
        return {k: (walk(v, path + (k,)) if isinstance(v, dict)
                    else leaf(path + (k,), v.shape).astype(np.float32))
                for k, v in node.items()}

    return walk(shapes_tree, ())


@pytest.fixture(scope="module")
def tiny_pair():
    """(jax cfg, flax model, numpy params, port cfg, host batch of 2
    synthetic samples)."""
    jcfg = JaxConfig.tiny().replace(**TINY)
    cfg = Config.tiny().replace(**TINY)
    jm = jsnipper.build_model(jcfg)
    x = jnp.zeros((1, jcfg.num_frames, jcfg.input_height, jcfg.input_width,
                   3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x))["params"]
    params = _random_params(shapes, 5)
    ds = SyntheticDataset(cfg, n_samples=2, seed=0)
    return jcfg, jm, params, cfg, stack_batch([ds[0], ds[1]])


def _port_model(cfg, params):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return model


def test_train_step_matches_jax(tiny_pair):
    """One f32 step at tiny: the loss, the gradients of every trained
    parameter and every parameter after the clip + AdamW update against
    ``make_train_step``. Tolerances: loss rtol 1e-5; gradients rtol 1e-4,
    atol 1e-5 of the largest gradient (f32 sums in other orders through
    the network and the heatmap sums); updated parameters rtol 1e-4,
    atol 1e-6 (1% of the 1e-4 scale of one AdamW step at lr 1e-4, where
    Adam's g / sqrt(v) amplifies roundoff of near-zero gradients)."""
    jcfg, jm, params, cfg, host = tiny_pair
    jbatch = {"images": jnp.asarray(host["images"]),
              "targets": _to_jax(host["targets"])}
    jcrit = JaxCriterion(jcfg)

    def jloss(p):
        out = jm.apply({"params": p}, jbatch["images"])
        return jcrit(out, jbatch["targets"])[0]

    jparams = _to_jax(params)
    j_grads = mask_frozen_grads(jax.jit(jax.grad(jloss))(jparams))
    state, tx = jax_train_state(jcfg, jparams, steps_per_epoch=10)
    step = make_train_step(jm, jcrit, tx, donate=False,
                           mixed_precision=False)
    j_state, j_metrics = step(state, jbatch, jax.random.PRNGKey(0))

    model = _port_model(cfg, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tstate = create_train_state(cfg, model, steps_per_epoch=10)
    crit = SetCriterion(cfg)
    batch = batch_to_device(host, CPU)
    total, _, _, _ = forward_loss(model.train(), crit, batch, False)
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {names[id(p)]: g for p, g in zip(
        tstate.params, torch.autograd.grad(total, tstate.params))}
    metrics = train_step(tstate, crit, batch,
                         torch.Generator().manual_seed(0),
                         mixed_precision=False)

    np.testing.assert_allclose(metrics["loss_total"].item(),
                               float(j_metrics["loss_total"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(j_metrics["grad_norm"]), rtol=1e-4)
    want_grads = state_dict_from_jax(jax.device_get(j_grads))
    g_max = max(g.abs().max().item() for g in grads.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-5 * g_max,
                                   err_msg=name)
    want_params = state_dict_from_jax(jax.device_get(j_state.params))
    after = model.state_dict()
    n_frozen = n_changed = 0
    for name, v in after.items():
        np.testing.assert_allclose(v.numpy(), want_params[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        if param_label(name) == "frozen":
            assert torch.equal(v, before[name]), name
            n_frozen += 1
        elif not torch.equal(v, before[name]):
            n_changed += 1
    assert n_frozen > 10 and n_changed > 10


def test_frozen_set_is_out_of_the_optimizer_and_the_clip(tiny_pair):
    """The stem, layer1 and the FrozenBatchNorm statistics take no
    gradient: they are in no optimizer group, so the clip's norm (over
    ``state.params``) never includes them (``mask_frozen_grads``)."""
    _, _, params, cfg, _ = tiny_pair
    model = _port_model(cfg, params)
    state = create_train_state(cfg, model)
    ids = {id(p) for p in state.params}
    opt_ids = {id(p) for g in state.optimizer.param_groups
               for p in g["params"]}
    assert ids == opt_ids
    frozen = [n for n, p in model.named_parameters()
              if param_label(n) == "frozen"]
    assert "backbone.conv1.weight" in frozen
    assert any(n.startswith("backbone.layer1_") for n in frozen)
    for n, p in model.named_parameters():
        assert p.requires_grad == (n not in frozen), n
        assert (id(p) in ids) == (n not in frozen), n
    assert all(param_label(n) == "frozen" for n, _ in model.named_buffers()
               if n.startswith("backbone."))
    assert [len(g["params"]) > 0 for g in state.optimizer.param_groups] \
        == [True] * 3
    lrs = [g["lr"] for g in state.optimizer.param_groups]
    assert lrs == [cfg.lr_backbone, cfg.lr * cfg.lr_linear_proj_mult,
                   cfg.lr]


# ---------------------------------------------------------- accumulation
def _accum_batches(seed, counts):
    """4 samples with ``counts`` valid persons each, as two halves."""
    cfg = Config.tiny()
    rng = np.random.default_rng(seed)
    n = len(counts)
    imgs = rng.uniform(0, 1, (n, cfg.num_frames, cfg.input_height,
                              cfg.input_width, 3)).astype(np.float32)
    T, Kk, Mm = cfg.total_frames, cfg.num_kpts, cfg.max_persons
    kpts = np.zeros((n, Mm, T, Kk, 3), np.float32)
    depth = np.zeros((n, Mm, T, Kk, 2), np.float32)
    valid = np.zeros((n, Mm), bool)
    for b, m in enumerate(counts):
        kpts[b, :m, ..., 0:2] = rng.uniform(0.2, 0.8, (m, T, Kk, 2))
        kpts[b, :m, ..., 2] = 1.0
        depth[b, :m, ..., 0] = rng.uniform(0.1, 0.9, (m, T, Kk))
        depth[b, :m, ..., 1] = 1.0
        valid[b, :m] = True

    def sub(lo, hi):
        return {"images": imgs[lo:hi],
                "targets": {"kpts2d": kpts[lo:hi], "depth": depth[lo:hi],
                            "valid": valid[lo:hi]}}
    return sub


@pytest.mark.parametrize("counts,heatmap", [((1, 1, 1, 1), False),
                                            ((2, 1, 1, 0), True)])
def test_grad_accum_matches_big_batch(tiny_pair, counts, heatmap):
    """``grad_accum_steps=2`` over two microbatches of 2 equals one step
    on the batch of 4 (tests/test_train_step.py:258-402): the first
    microstep leaves the parameters alone. Equal person counts with the
    heatmap loss off; unequal counts with the window's ``num_traj``
    (``inject_window_num_traj``) and the heatmap sum over dp_size=2."""
    _, _, params, _, _ = tiny_pair
    base = Config.tiny().replace(dropout=0.0,
                                 heatmap_loss_coef=0.01 if heatmap else 0.0)
    sub = _accum_batches(7, counts)
    gen = torch.Generator().manual_seed(0)

    big = _port_model(base.replace(batch_size=4), params)
    s_big = create_train_state(base.replace(batch_size=4), big, 10)
    train_step(s_big, SetCriterion(base, dp_size=2 if heatmap else 1),
               batch_to_device(sub(0, 4), CPU), gen, mixed_precision=False)

    cfg_acc = base.replace(grad_accum_steps=2)
    acc = _port_model(cfg_acc, params)
    start = {k: v.clone() for k, v in acc.state_dict().items()}
    s_acc = create_train_state(cfg_acc, acc, 10)
    crit = SetCriterion(base)
    micro = list(tengine.inject_window_num_traj(iter([sub(0, 2),
                                                      sub(2, 4)]), 2))
    train_step(s_acc, crit, batch_to_device(micro[0], CPU), gen,
               mixed_precision=False)
    assert all(torch.equal(v, start[k])
               for k, v in acc.state_dict().items()), \
        "a non-final microstep must not update parameters"
    train_step(s_acc, crit, batch_to_device(micro[1], CPU), gen,
               mixed_precision=False)
    assert (s_acc.step, s_acc.updates) == (2, 1)
    want = big.state_dict()
    for k, v in acc.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=2e-5,
                                   atol=5e-6, err_msg=k)


def test_inject_window_num_traj_matches_jax():
    def b(n_valid, m=4):
        v = np.zeros((1, m), bool)
        v[0, :n_valid] = True
        return {"targets": {"valid": v}}

    seq = [b(3), b(1), b(0), b(0), b(2)]
    for k in (1, 2, 3):
        got = [float(x["num_traj"])
               for x in tengine.inject_window_num_traj(iter(seq), k)]
        want = [float(x["num_traj"])
                for x in jengine.inject_window_num_traj(iter(seq), k)]
        assert got == want, k


# ------------------------------------------------- dropout, mixed precision
def test_dropout_active_only_in_train_mode():
    cfg = Config.tiny().replace(dropout=0.5)
    model = build_model(cfg, device="cpu", seed=2)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, cfg.num_frames, cfg.input_height, cfg.input_width, 3)
    ).astype(np.float32))
    with torch.no_grad():
        e1 = model.eval()(x)["pred_logits"]
        e2 = model(x)["pred_logits"]
        torch.manual_seed(0)
        t1 = model.train()(x)["pred_logits"]
        torch.manual_seed(0)
        t2 = model(x)["pred_logits"]
        torch.manual_seed(1)
        t3 = model(x)["pred_logits"]
    assert torch.equal(e1, e2)
    assert torch.equal(t1, t2)
    assert not torch.allclose(t1, e1) and not torch.allclose(t1, t3)
    no_drop = build_model(cfg.replace(dropout=0.0), device="cpu", seed=2)
    with torch.no_grad():
        torch.testing.assert_close(no_drop.train()(x)["pred_logits"], e1)


def test_mixed_precision_tracks_f32_losses(tiny_pair):
    """Mixed precision (the forward on bf16 copies of the f32 masters)
    against full f32 over three steps on one batch: within 5%
    (tests/test_train_step.py:114), and the loss falls. No bf16 forward
    is held tighter: JAX's own jitted and op-by-op bf16 forwards differ
    by up to 1.91 bf16 units of each prediction's scale at the tiny
    fixture of tests/test_torch_port_bench.py."""
    _, _, params, cfg, host = tiny_pair
    batch = batch_to_device(host, CPU)
    traj = {}
    for mp in (False, True):
        model = _port_model(cfg, params)
        state = create_train_state(cfg, model, steps_per_epoch=10)
        crit = SetCriterion(cfg)
        gen = torch.Generator().manual_seed(0)
        traj[mp] = [train_step(state, crit, batch, gen,
                               mixed_precision=mp)["loss_total"].item()
                    for _ in range(3)]
    for a, b in zip(traj[False], traj[True]):
        assert abs(a - b) / max(abs(a), 1e-6) < 0.05, traj
    assert traj[True][-1] < traj[True][0]


@pytest.mark.parametrize("deform_dtype", ["auto", "float32"])
def test_mixed_precision_step_matches_jax(tiny_pair, deform_dtype):
    """The port's mixed precision against JAX's ``make_train_step(
    mixed_precision=True)``: both cast every f32 weight and the images to
    bf16 inside the step. The losses of two steps within 5% relative, the
    bar of tests/test_train_step.py:114. A bf16 forward cannot be held to
    an f32 tolerance: JAX's own jitted and op-by-op bf16 forwards differ
    by up to 1.91 bf16 units of each prediction's scale at the tiny
    fixture of tests/test_torch_port_bench.py. ``deform_dtype`` is set in
    both packages' configs: with ``"float32"`` the sampling runs in f32
    inside the bf16 step."""
    jcfg, jm, params, cfg, host = tiny_pair
    jcfg = jcfg.replace(deform_dtype=deform_dtype)
    cfg = cfg.replace(deform_dtype=deform_dtype)
    jm = jsnipper.build_model(jcfg)
    jbatch = {"images": jnp.asarray(host["images"]),
              "targets": _to_jax(host["targets"])}
    state, tx = jax_train_state(jcfg, _to_jax(params), steps_per_epoch=10)
    step = make_train_step(jm, JaxCriterion(jcfg), tx, donate=False,
                           mixed_precision=True)
    tstate = create_train_state(cfg, _port_model(cfg, params),
                                steps_per_epoch=10)
    crit, batch = SetCriterion(cfg), batch_to_device(host, CPU)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, j_metrics = step(state, jbatch, jax.random.PRNGKey(0))
        metrics = train_step(tstate, crit, batch, gen, mixed_precision=True)
        want = float(j_metrics["loss_total"])
        got = metrics["loss_total"].item()
        assert np.isfinite(got) and abs(got - want) / abs(want) < 0.05, \
            (got, want)


def test_mixed_precision_forward_sees_bf16_copies(tiny_pair):
    """Under mixed precision every module's forward sees bf16 weights (the
    frozen-BN buffers too) and the backbone a bf16 input, the master
    parameters stay f32 and receive f32 gradients through the casts, and
    the losses are f32. In f32 every module sees the masters themselves,
    and ``forward_loss`` is the criterion of ``model(images)`` bit for
    bit."""
    _, _, params, cfg, host = tiny_pair
    batch = batch_to_device(host, CPU)
    model = _port_model(cfg, params).train()
    crit = SetCriterion(cfg)
    masters = dict(model.named_parameters())
    seen = []   # (dtype, is a master) of each weight a forward holds
    n_params = []  # of which parameters (the rest buffers)

    def hook(mod, args):
        params = [t for t in mod._parameters.values() if t is not None]
        n_params.append(len(params))
        seen.extend((t.dtype, any(t is m for m in masters.values()))
                    for t in (*params, *mod._buffers.values())
                    if t is not None)

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if m._parameters or m._buffers]
    inputs = []
    handles.append(model.backbone.register_forward_pre_hook(
        lambda mod, args: inputs.append(args[0].dtype)))
    try:
        total, losses, out, _ = forward_loss(model, crit, batch, True)
        assert seen and all(dt == torch.bfloat16 and not is_master
                            for dt, is_master in seen)
        assert inputs == [torch.bfloat16]
        assert out["pred_logits"].dtype == torch.bfloat16
        assert total.dtype == torch.float32
        assert all(v.dtype == torch.float32 for v in losses.values())
        train = [p for p in masters.values() if p.requires_grad]
        grads = torch.autograd.grad(total, train)
        assert all(p.dtype == torch.float32 for p in masters.values())
        assert all(g.dtype == torch.float32 for g in grads)
        assert sum(float(g.abs().sum()) > 0 for g in grads) > len(grads) // 2

        seen.clear()
        n_params.clear()
        inputs.clear()
        torch.manual_seed(0)
        f32_total, _, _, _ = forward_loss(model, crit, batch, False)
        assert all(dt == torch.float32 for dt, _ in seen)
        assert sum(is_master for _, is_master in seen) == sum(n_params) > 0
        assert inputs == [torch.float32]
    finally:
        for h in handles:
            h.remove()
    torch.manual_seed(0)
    want, _, _ = crit(model(batch["images"]), batch["targets"])
    assert torch.equal(f32_total, want)


@pytest.mark.parametrize("process_index,process_count,shuffle",
                         [(0, 1, True), (1, 2, True), (0, 1, False)])
def test_loader_and_synthetic_match_jax(process_index, process_count,
                                        shuffle):
    """The port's DataLoader over its copy of the synthetic dataset gives
    the JAX loader's batches: the same shard, order, images and targets."""
    from snipper_tpu.data.loader import DataLoader as JaxLoader
    from snipper_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
    from snipper_tpu_torch.data.loader import DataLoader

    kw = dict(shuffle=shuffle, seed=3, process_index=process_index,
              process_count=process_count)
    got = DataLoader(SyntheticDataset(Config.tiny(), n_samples=5), 2, **kw)
    want = JaxLoader(JaxSynthetic(JaxConfig.tiny(), n_samples=5), 2, **kw)
    for loader in (got, want):
        loader.set_epoch(1)
    assert len(got) == len(want)
    pairs = list(zip(got, want))
    assert len(pairs) == len(want) > 0
    for g, w in pairs:
        np.testing.assert_array_equal(g["images"], w["images"])
        for k in ("kpts2d", "depth", "valid"):
            np.testing.assert_array_equal(g["targets"][k], w["targets"][k])
        assert len(g["meta"]) == len(w["meta"]) == 2
