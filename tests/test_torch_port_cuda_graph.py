"""The one-card train step as a CUDA graph (``train/step.py::StepGraph``)
against the same step run eagerly, on a CUDA card: from the same weights,
batches and dropout seeds, over three steps, the metrics, the parameters
and AdamW's moments; with dropout; across a StepLR drop; with batches of
other signatures than the graph's, which run eagerly; after a checkpoint
round trip. A replay's kernels are counted by the profiler, as a replay
calls no kernel's wrapper. Without a card every test skips (the step's kernels have no
CPU mode).

This file imports nothing of JAX, so it runs on a GPU host without JAX
(tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda_graph.py
"""

import numpy as np
import pytest
import torch

from snipper_tpu_torch.config import Config
from snipper_tpu_torch.data.snippet import stack_batch
from snipper_tpu_torch.data.synthetic import SyntheticDataset
from snipper_tpu_torch.losses.criterion import SetCriterion
from snipper_tpu_torch.models.snipper import build_model
from snipper_tpu_torch.ops.lsa import lsa_rows
from snipper_tpu_torch.ops.msda import ms_deform_attn
from snipper_tpu_torch.train.state import create_train_state
from snipper_tpu_torch.train.step import StepGraph, batch_to_device, train_step

pytestmark = pytest.mark.cuda

# Each step runs twice from one state, one seed and one batch: eagerly,
# then on the graph's path; the run goes on from the graph's result, so
# the two never drift apart over the steps. The MSDA backward sums each
# value row in one fixed order, but torch's scatter-adds in the backward
# add with atomics, in an order that can change from run to run: two eager
# steps from one state can differ in the last bits of the gradients, and
# the bf16 recipe's casts can carry such a bit a bf16 unit further. So no
# step is held to bit equality: the graph's
# step is held to the eager step by ``GAP``, each tensor's gap in norm
# over the eager step's change of it (the parameters, the moments) or over
# the metric. Two eager steps read at most a tenth of it
# (``test_two_eager_steps_gap``; up to 6.3e-4 on an H100); a wrong rate
# reads 9 (a tenfold step), other dropout bits or another batch read
# tenths to ones.
GAP = 1e-2


@pytest.fixture
def cuda():
    """The CUDA device, with TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the step's kernels have no CPU "
                    "mode)")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


PRESETS = {"tiny": Config.tiny().replace(batch_size=2),
           "canonical_t4_f2_enc2_dec2": Config.canonical_t4_f2().replace(
               enc_layers=2, dec_layers=2, batch_size=2)}


def _batches(cfg, device, picks=((0, 1), (2, 3), (1, 2))):
    ds = SyntheticDataset(cfg, n_samples=4, seed=0)
    samples = [ds[i] for i in range(4)]
    return [batch_to_device(stack_batch([samples[i] for i in p]), device)
            for p in picks]


def _save(state, gen):
    """What a step changes: the parameters, AdamW's state, the counts and
    the dropout generator."""
    return {"params": [p.detach().clone() for p in state.params],
            "adamw": {p: {k: v.clone() for k, v in
                          state.optimizer.state[p].items()}
                      for p in state.params if p in state.optimizer.state},
            "counts": (state.step, state.updates),
            "gen": gen.get_state()}


def _restore(state, gen, saved):
    with torch.no_grad():
        for p, q in zip(state.params, saved["params"]):
            p.copy_(q)
    for p in state.params:
        if p in saved["adamw"]:
            for k, v in saved["adamw"][p].items():
                state.optimizer.state[p][k].copy_(v)
        else:
            state.optimizer.state.pop(p, None)
    state.step, state.updates = saved["counts"]
    gen.set_state(saved["gen"])


def _flat(state):
    """The parameters and the two moments (zeros before the first
    update), each one f32 vector."""
    def cat(ts):
        return torch.cat([t.detach().float().reshape(-1) for t in ts])

    moments = [state.optimizer.state.get(p, {}) for p in state.params]
    return {"params": cat(state.params),
            **{k: cat([m.get(k, torch.zeros_like(p))
                       for m, p in zip(moments, state.params)])
               for k in ("exp_avg", "exp_avg_sq")}}


def _gap(got, want, start):
    """Each tensor's gap in norm over the ``want`` step's change of it;
    the metrics' largest gap over the metric (at least 1e-3)."""
    g = {k: ((got[k] - want[k]).norm()
             / (want[k] - start[k]).norm()).item()
         for k in ("params", "exp_avg", "exp_avg_sq")}
    g["metrics"] = max(abs(got["m"][k] - want["m"][k])
                       / max(abs(want["m"][k]), 1e-3) for k in want["m"])
    return g


def _counts():
    return (ms_deform_attn.launches, ms_deform_attn.backward_launches,
            lsa_rows.launches, StepGraph.captures, StepGraph.replays)


def _paired_steps(cfg, device, batches, steps_per_epoch=100, seed=7,
                  second_eager=False, state=None):
    """Each batch's step run eagerly, then, from the same state and seed,
    on the graph's path (eagerly again with ``second_eager``). Returns the
    state and per step the two results' gaps and what the graph path
    counted: each kernel wrapper's launches, the captures, the
    replays."""
    if state is None:
        state = create_train_state(cfg, build_model(cfg, device=device,
                                                    seed=1),
                                   steps_per_epoch=steps_per_epoch)
    crit = SetCriterion(cfg)
    gen = torch.Generator().manual_seed(seed)
    gaps, launches = [], []
    for b in batches:
        saved, start = _save(state, gen), _flat(state)
        graphed, state.graphed = state.graphed, False
        m = train_step(state, crit, b, gen, mixed_precision=True)
        want = dict(_flat(state), m={k: v.item() for k, v in m.items()})
        state.graphed = graphed and not second_eager
        _restore(state, gen, saved)
        before = _counts()
        m = train_step(state, crit, b, gen, mixed_precision=True)
        got = dict(_flat(state), m={k: v.item() for k, v in m.items()})
        launches.append([a - c for a, c in zip(_counts(), before)])
        state.graphed = graphed
        gaps.append(_gap(got, want, start))
    return state, gaps, launches


def _assert_close(gaps, bar=GAP):
    print(gaps)
    for i, g in enumerate(gaps):
        assert all(v <= bar for v in g.values()), (i, g)


def _captured(state):
    return state.graph is not None and state.graph.graph is not None


def _replay_kernels(fn):
    """The MSDA and assignment kernels that one call of ``fn`` ran on the
    card, by name (torch.profiler's counts): the forward, the backward's
    three (taps, index, gather: each once per backward call on the gather
    path) and the assignment."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = ("msda_forward_kernel", "msda_backward_taps_kernel",
             "msda_backward_index_kernel", "msda_backward_gather_kernel",
             "lsa_rows_kernel")
    return [sum(e.count for e in prof.key_averages() if n in e.key)
            for n in names]


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_graphed_step_matches_eager(cuda, preset, dropout):
    """Three bf16-recipe steps: the first eager, the second captured and
    replayed, the third replayed, each against the eager step. The eager
    step and the capture call each kernel's wrapper once per layer (the
    assignment's once); the replay calls none, and a fourth step's replay
    runs those kernels on the card, by the profiler's count."""
    cfg = PRESETS[preset].replace(dropout=dropout)
    batches = _batches(cfg, cuda)
    state, gaps, launches = _paired_steps(cfg, cuda, batches)
    assert _captured(state)
    assert (state.step, state.updates) == (3, 3)
    n = cfg.enc_layers + cfg.dec_layers
    assert launches == [[n, n, 1, 0, 0], [n, n, 1, 1, 1], [0, 0, 0, 0, 1]]
    _assert_close(gaps)
    gen = torch.Generator().manual_seed(9)
    replays = StepGraph.replays
    kernels = _replay_kernels(lambda: train_step(
        state, state.graph.criterion, batches[0], gen,
        mixed_precision=True))
    assert StepGraph.replays == replays + 1
    assert kernels == [n, n, n, n, 1]


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_two_eager_steps_gap(cuda, preset, dropout):
    """Two eager steps from one state, for the record of ``GAP``: apart by
    the order of torch's atomics alone."""
    cfg = PRESETS[preset].replace(dropout=dropout)
    _, gaps, _ = _paired_steps(cfg, cuda, _batches(cfg, cuda),
                               second_eager=True)
    _assert_close(gaps, GAP / 10)


def test_rate_drop_reaches_replay(cuda):
    """StepLR drops tenfold after two updates (one step an epoch, a drop
    every two): the replays of updates three and four run at the dropped
    rate, as the eager steps do, and the rate tensors hold it."""
    cfg = PRESETS["tiny"].replace(lr_drop=2)
    batches = _batches(cfg, cuda, picks=((0, 1), (2, 3), (1, 2), (3, 0)))
    state, gaps, _ = _paired_steps(cfg, cuda, batches, steps_per_epoch=1)
    _assert_close(gaps)
    for group, lr_fn in zip(state.optimizer.param_groups, state.lr_fns):
        assert lr_fn(3) == pytest.approx(lr_fn(0) / 10)
        assert group["lr"].item() == np.float32(lr_fn(3))


def test_other_signatures_never_replay_the_wrong_graph(cuda):
    """Batches of 2, 1 and 3 samples in turn: the first signature, of 2,
    is captured at its second step and replayed after; batches of 1 and of
    3 always run eagerly. Every step against the eager step."""
    cfg = PRESETS["tiny"]
    picks = ((0, 1), (2,), (1, 2), (3,), (0, 3), (1, 2, 3), (2, 3),
             (0, 1, 2), (1,))
    state, gaps, counted = _paired_steps(cfg, cuda,
                                         _batches(cfg, cuda, picks))
    _assert_close(gaps)
    assert _captured(state)
    assert state.graph.key[2][0][1][0] == 2   # the images' batch dimension
    # captures and replays: the capture at (1, 2), its replays at (1, 2),
    # (0, 3) and (2, 3)
    assert [c[3:] for c in counted] == [[0, 0], [0, 0], [1, 1], [0, 0],
                                        [0, 1], [0, 0], [0, 1], [0, 0],
                                        [0, 0]]
    assert (state.step, state.updates) == (len(picks), len(picks))


def test_checkpoint_round_trip_keeps_the_graph_path(cuda):
    """A graphed state's ``state_dict`` after two steps holds the host
    form (rates as floats, step counts on the host, not capturable); a
    fresh state that loads it is capturable again, captures anew and
    steps as the eager step does."""
    cfg = PRESETS["tiny"]
    batches = _batches(cfg, cuda, picks=((0, 1), (2, 3), (1, 2), (3, 0)))
    half, _, _ = _paired_steps(cfg, cuda, batches[:2])
    assert _captured(half)
    opt_state = half.state_dict()
    for g in opt_state["adamw"]["param_groups"]:
        assert isinstance(g["lr"], float) and g["capturable"] is False
    for s in opt_state["adamw"]["state"].values():
        assert s["step"].device.type == "cpu"
    state = create_train_state(cfg, build_model(cfg, device=cuda, seed=3))
    state.model.load_state_dict(half.model.state_dict())
    state.load_state_dict(opt_state, 2)
    assert all(g["capturable"] for g in state.optimizer.param_groups)
    state, gaps, launches = _paired_steps(cfg, cuda, batches[2:] * 2,
                                          state=state)
    _assert_close(gaps)
    assert (state.step, state.updates) == (6, 6)
    assert _captured(state)


def test_graphed_in_one_process_only(cuda):
    """``create_train_state`` graphs the step on the card without a mesh
    and on a mesh of one rank (``cli.train`` in one process), and leaves it
    eager on a mesh of two ranks and with accumulation."""
    from snipper_tpu_torch.parallel.mesh import Mesh

    cfg = PRESETS["tiny"]
    model = build_model(cfg, device=cuda, seed=1)
    cases = {"no mesh": (cfg, None, True),
             "one rank": (cfg, Mesh(1, 1, 0), True),
             "two ranks": (cfg, Mesh(2, 1, 0), False),
             "accumulation": (cfg.replace(grad_accum_steps=2), None, False)}
    for name, (c, mesh, want) in cases.items():
        state = create_train_state(c, model, mesh=mesh)
        capturable = [g["capturable"] for g in state.optimizer.param_groups]
        assert state.graphed is want, name
        assert capturable == [want] * len(capturable), name
