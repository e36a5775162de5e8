"""The train step's shared body on the CPU, where it never runs as a
graph: the CPU, mesh and accumulation paths against the step as it was
written before the one-card step became a CUDA graph (kept below as
``_reference_train_step``), bit for bit over several steps; the StepLR
rates written into capturable AdamW's rate tensors; and checkpoints of the
host form loading into a capturable state and back. The graph itself runs
only on a card: ``tests/test_torch_port_cuda_graph.py``.
"""

import io
import types

import pytest
import torch
from torch.profiler import record_function

from snipper_tpu_torch.config import Config
from snipper_tpu_torch.data.snippet import stack_batch
from snipper_tpu_torch.data.synthetic import SyntheticDataset
from snipper_tpu_torch.losses.criterion import SetCriterion
from snipper_tpu_torch.models.snipper import build_model
from snipper_tpu_torch.train.state import create_train_state, make_capturable
from snipper_tpu_torch.train.step import (average_gradients, average_metrics,
                                          batch_to_device, dropout_seed,
                                          forward_loss, global_norm,
                                          train_step, write_rates)

CPU = torch.device("cpu")


def _reference_train_step(state, criterion, batch, generator,
                          mixed_precision=True):
    """The step as it was before it could run as a graph: the rates set
    inside the update, the backward and the update outside the generators'
    fork."""
    model, cfg, mesh = state.model, state.cfg, state.mesh
    model.train()
    seed = dropout_seed(generator, mesh)
    dev = batch["targets"]["valid"].device
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        total, losses, out, _ = forward_loss(model, criterion, batch,
                                             mixed_precision)
    with record_function("train.backward"):
        grads = torch.autograd.grad(total, state.params)
    k = max(cfg.grad_accum_steps, 1)
    if k == 1:
        grads = average_gradients(grads, mesh)
    norm = global_norm(grads, state.params, mesh)
    metrics = average_metrics(
        {"loss_total": total.detach(), "grad_norm": norm,
         **{name: v.detach() for name, v in losses.items()},
         "sampling_overflow": torch.zeros((), device=dev)}, mesh)
    micro = state.step % k
    state.step += 1
    if k > 1:
        if micro == 0:
            state.accum = [g.clone() for g in grads]
        else:
            for a, g in zip(state.accum, grads):
                a.add_((g - a) / (micro + 1))
        if micro < k - 1:
            return metrics
        grads = average_gradients(state.accum, mesh)
        state.accum = None
        norm = global_norm(grads, state.params, mesh)
    max_norm = cfg.clip_max_norm
    clipped = norm >= max_norm
    for p, g in zip(state.params, grads):
        p.grad = torch.where(clipped, g / norm * max_norm, g)
    for group, lr_fn in zip(state.optimizer.param_groups, state.lr_fns):
        group["lr"] = lr_fn(state.updates)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.updates += 1
    return metrics


# a data rank of 1 on a mesh without groups: the seed's fold runs, the
# collectives do not
ONE_RANK_MESH = types.SimpleNamespace(data_group=None, model_group=None,
                                      data_rank=1, dp=1, tp=1, model_rank=0)

PATHS = {"cpu": (dict(), None, 3),
         "accumulation": (dict(grad_accum_steps=2), None, 4),
         "mesh": (dict(), ONE_RANK_MESH, 3)}


def _batches(cfg, n):
    ds = SyntheticDataset(cfg, n_samples=n + 1, seed=0)
    return [batch_to_device(stack_batch([ds[i], ds[i + 1]]), CPU)
            for i in range(n)]


def _train(cfg, mesh, batches, step_fn, steps_per_epoch=2):
    model = build_model(cfg, device="cpu", seed=1)
    state = create_train_state(cfg, model, steps_per_epoch=steps_per_epoch,
                               mesh=mesh)
    crit, gen = SetCriterion(cfg), torch.Generator().manual_seed(3)
    metrics = [{k: v.item() for k, v in
                step_fn(state, crit, b, gen).items()} for b in batches]
    return state, metrics


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", list(PATHS))
def test_eager_paths_match_the_reference_step(path, two_threads):
    """dropout 0.1, bf16 recipe, a StepLR drop after the first epoch: the
    metrics, the parameters and AdamW's state bit for bit; none of these
    states runs a graph."""
    over, mesh, n = PATHS[path]
    cfg = Config.tiny().replace(batch_size=2, lr_drop=1, **over)
    batches = _batches(cfg, n)
    got, got_m = _train(cfg, mesh, batches, train_step)
    want, want_m = _train(cfg, mesh, batches, _reference_train_step)
    assert not got.graphed and got.graph is None
    assert got_m == want_m
    assert (got.step, got.updates) == (want.step, want.updates)
    for p, q in zip(got.params, want.params):
        assert torch.equal(p, q)
    a, b = got.optimizer.state_dict(), want.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, s in b["state"].items():
        for k, v in s.items():
            assert torch.equal(a["state"][i][k], v), (i, k)


def test_rates_written_into_rate_tensors_follow_lr_fns():
    """``make_capturable`` turns each group's rate into a tensor on its
    parameters' device; ``write_rates`` writes ``lr_fns`` at the state's
    update count into it, in place, across the StepLR drop; a float rate
    is set as a float."""
    cfg = Config.tiny().replace(lr_drop=2)
    state = create_train_state(cfg, build_model(cfg, device="cpu", seed=1),
                               steps_per_epoch=1)
    write_rates(state)
    assert [g["lr"] for g in state.optimizer.param_groups] == \
        [f(0) for f in state.lr_fns]
    make_capturable(state.optimizer)
    tensors = [g["lr"] for g in state.optimizer.param_groups]
    assert all(isinstance(t, torch.Tensor) and t.shape == () for t in tensors)
    assert all(g["capturable"] for g in state.optimizer.param_groups)
    for updates in range(5):
        state.updates = updates
        write_rates(state)
        for group, t, lr_fn in zip(state.optimizer.param_groups, tensors,
                                   state.lr_fns):
            assert group["lr"] is t
            assert t.item() == torch.tensor(lr_fn(updates)).item()
    assert state.lr_fns[0](4) == pytest.approx(state.lr_fns[0](0) / 100)


def test_host_form_checkpoint_loads_into_a_capturable_state(two_threads):
    """A checkpoint's ``opt_state`` in the host form, as the step wrote it
    before it could run as a graph (rates as floats, step counts on the
    host, not capturable): a plain state that loads it continues bit for
    bit as the one that wrote it; a capturable state that loads it holds
    the same moments, its rates as tensors and its step counts in f32
    beside the parameters, drops the graph it kept, and writes the same
    file back, its rates rounded to f32. The form follows the optimizer:
    that state's step runs no graph (``graphed`` unset), and it reads and
    writes as a graphed one does."""
    cfg = Config.tiny().replace(batch_size=2)
    batches = _batches(cfg, 3)
    writer, _ = _train(cfg, None, batches[:2], _reference_train_step)
    buf = io.BytesIO()
    torch.save({"adamw": writer.optimizer.state_dict(),
                "updates": writer.updates, "accum": None}, buf)
    buf.seek(0)
    file = torch.load(buf, weights_only=True)
    params = {k: v.clone() for k, v in writer.model.state_dict().items()}

    plain = create_train_state(cfg, build_model(cfg, device="cpu", seed=2))
    plain.model.load_state_dict(params)
    plain.load_state_dict(file, writer.step)
    gen = torch.Generator().manual_seed(5)
    crit = SetCriterion(cfg)
    a = train_step(plain, crit, batches[2], gen)
    b = _reference_train_step(writer, crit, batches[2],
                              torch.Generator().manual_seed(5))
    assert {k: v.item() for k, v in a.items()} == \
        {k: v.item() for k, v in b.items()}
    for p, q in zip(plain.params, writer.params):
        assert torch.equal(p, q)

    graphed = create_train_state(cfg, build_model(cfg, device="cpu", seed=2))
    graphed.graph = object()   # a graph of the moments the load replaces
    make_capturable(graphed.optimizer)
    assert not graphed.graphed
    graphed.load_state_dict(file, 2)
    assert graphed.graph is None
    assert (graphed.step, graphed.updates) == (2, 2)
    for group, saved in zip(graphed.optimizer.param_groups,
                            file["adamw"]["param_groups"]):
        assert group["capturable"] is True
        assert group["lr"].item() == torch.tensor(saved["lr"]).item()
    for p in graphed.params:
        s = graphed.optimizer.state[p]
        assert s["step"].dtype == torch.float32
        assert s["step"].device == p.device
    back = graphed.state_dict()
    for got, saved in zip(back["adamw"]["param_groups"],
                          file["adamw"]["param_groups"]):
        # the rate comes back as its f32 tensor held it
        assert got["lr"] == torch.tensor(saved["lr"]).item()
        assert dict(got, lr=None) == dict(saved, lr=None)
    assert back["updates"] == file["updates"] and back["accum"] is None
    for i, s in file["adamw"]["state"].items():
        for k, v in s.items():
            assert torch.equal(back["adamw"]["state"][i][k], v), (i, k)
