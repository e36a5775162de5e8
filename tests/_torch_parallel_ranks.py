"""The ranks' side of ``tests/test_torch_port_parallel*.py``.

``snipper_tpu_torch.parallel.multihost.spawn`` runs these functions in
fresh processes joined into one gloo group; they import torch and the
port, never JAX. Each suite runs every scenario of its test module in one
launch and returns what the tests compare.
"""

import os

import numpy as np
import torch

from snipper_tpu_torch.config import Config
from snipper_tpu_torch.data.loader import DataLoader
from snipper_tpu_torch.data.synthetic import SyntheticDataset
from snipper_tpu_torch.losses.criterion import SetCriterion
from snipper_tpu_torch.models.snipper import build_model
from snipper_tpu_torch.parallel import multihost
from snipper_tpu_torch.parallel.mesh import (batch_sharding, gather,
                                             make_mesh, shard_model)
from snipper_tpu_torch.train.engine import evaluate, train_one_epoch
from snipper_tpu_torch.train.preemption import PreemptionGuard
from snipper_tpu_torch.train.state import create_train_state
from snipper_tpu_torch.train.step import (average_gradients, average_metrics,
                                          batch_to_device, forward_loss,
                                          global_norm, train_step)

CPU = torch.device("cpu")
TINY = dict(dropout=0.0, batch_size=2)


def _rows(batch, start, stop):
    """Rows ``[start, stop)`` of a stacked host batch."""
    out = {k: v[start:stop] for k, v in batch.items()
           if isinstance(v, np.ndarray)}
    out["targets"] = {k: v[start:stop] for k, v in batch["targets"].items()}
    return out


def _model(cfg, state_dict):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict)
    return model


def _named(state, tensors):
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: t for p, t in zip(state.params, tensors)}


def two_ranks(inp):
    """The two-rank scenarios: gathers, one data-parallel step, the eval
    merge, the stop flag, ``cli.infer --data_parallel`` and a tp2
    ``cli.train`` checkpoint."""
    torch.set_num_threads(2)
    rank = multihost.process_index()
    out = {}

    # payloads of unequal size, in rank order
    out["gather"] = multihost.all_gather_objects(
        {"rank": rank, "payload": list(range(1 + 700 * rank))})
    out["merged"] = multihost.merge_eval_results(
        [{"rank": rank, "i": i} for i in range(2 - rank)])
    out["broadcast"] = multihost.broadcast_object(
        {"from": rank} if rank == 0 else None)

    # one f32 step, each rank on its half of the global batch of 4
    cfg = Config.tiny().replace(**TINY)
    mesh = make_mesh()
    state = create_train_state(cfg, _model(cfg, inp["state_dict"]),
                               steps_per_epoch=10, mesh=mesh)
    crit = SetCriterion(cfg, mesh=mesh)
    batch = batch_to_device(_rows(inp["batch"], 2 * rank, 2 * rank + 2),
                            CPU)
    total, _, _, _ = forward_loss(state.model.train(), crit, batch, False)
    grads = average_gradients(torch.autograd.grad(total, state.params),
                              mesh)
    metrics = train_step(state, crit, batch,
                         torch.Generator().manual_seed(0),
                         mixed_precision=False)
    out["dp_step"] = {
        "loss": metrics["loss_total"].item(),
        "grad_norm": metrics["grad_norm"].item(),
        "grads": {k: v.numpy().copy()
                  for k, v in _named(state, grads).items()},
        "params": {k: v.numpy().copy() for k, v in
                   state.model.state_dict().items()}}

    # the stop flag: rank 1 alone sees the signal before the second step
    guard, polls = PreemptionGuard(), [0]

    def stop_flag():
        polls[0] += 1
        if rank == 1 and polls[0] == 2:
            guard.should_stop = True
        return guard.poll()

    try:
        loader = DataLoader(SyntheticDataset(cfg, n_samples=8, seed=0), 1,
                            shuffle=False, **batch_sharding(mesh))
        _, hist = train_one_epoch(state, crit, loader, 0,
                                  torch.Generator().manual_seed(0), CPU,
                                  mixed_precision=False, stop_flag=stop_flag)
    finally:
        guard.restore()
    out["stop"] = {"steps": len(hist), "should_stop": guard.should_stop,
                   "loader_len": len(loader)}

    # evaluate on two ranks of batch 1: the global batches of 2
    ecfg = Config.tiny().replace(dropout=0.0, batch_size=1)
    loader = DataLoader(SyntheticDataset(ecfg, n_samples=4, seed=1), 1,
                        shuffle=False, drop_last=False, num_workers=0,
                        **batch_sharding(mesh))
    stats = evaluate(_model(ecfg, inp["state_dict"]),
                     SetCriterion(ecfg, mesh=mesh), loader, ecfg, CPU,
                     collect_results=True, mesh=mesh)
    out["eval"] = {k: v for k, v in stats.items() if k != "_batch_seconds"}

    # the CLIs in this process group
    from snipper_tpu_torch.cli import infer as infer_cli
    from snipper_tpu_torch.cli import train as train_cli

    out["serve"] = {}
    for gsz in ("1", "2"):
        served = infer_cli.main(
            inp["infer_argv"] + ["--data_parallel", "--snippet_batch", gsz,
                                 "--output_dir",
                                 os.path.join(inp["out"], f"dp_b{gsz}")])
        out["serve"][gsz] = served["snippets"]
    res = train_cli.main(inp["train_argv"] + [
        "--tp_size", "2", "--output_dir", os.path.join(inp["out"], "tp2")])
    out["tp2_checkpoint"] = res["checkpoint"]
    out["tp2_loss"] = res["history"][0]["loss_total"]
    return out


def tp_ranks(inp):
    """Each mesh of ``inp["meshes"]`` over this world: the loss (averaged
    over the data group), the global grad norm and the full gradients of
    one f32 forward and backward, each data rank on its rows of the global
    batch; then the mesh map and the loader shards on a tp2 mesh."""
    torch.set_num_threads(1)
    cfg = Config.tiny().replace(**TINY)
    B = inp["batch"]["images"].shape[0]
    out = {"meshes": {}}
    for dp, tp in inp["meshes"]:
        mesh = make_mesh(dp, tp)
        if not mesh.contains:
            continue
        model = shard_model(_model(cfg, inp["state_dict"]), mesh)
        state = create_train_state(cfg, model, mesh=mesh)
        crit = SetCriterion(cfg, mesh=mesh)
        per = B // dp
        batch = batch_to_device(
            _rows(inp["batch"], mesh.data_rank * per,
                  (mesh.data_rank + 1) * per), CPU)
        total, _, _, _ = forward_loss(model.train(), crit, batch, False)
        grads = average_gradients(torch.autograd.grad(total, state.params),
                                  mesh)
        norm = global_norm(grads, state.params, mesh)
        loss = average_metrics({"loss": total.detach()}, mesh)["loss"]
        full = [g if getattr(p, "tp_spec", None) is None
                else gather(g, p.tp_spec, mesh)
                for p, g in zip(state.params, grads)]
        out["meshes"][f"dp{dp}_tp{tp}"] = {
            "loss": loss.item(), "grad_norm": norm.item(),
            "heads": model.transformer.encoder_layer0.self_attn.n_heads,
            "grads": ({k: v.numpy().copy()
                       for k, v in _named(state, full).items()}
                      if mesh.rank == 0 else None)}

    import torch.distributed as dist

    mesh = make_mesh(-1, 2)
    out["map"] = {
        "rank": mesh.rank, "data_rank": mesh.data_rank,
        "model_rank": mesh.model_rank,
        "data_group": dist.get_process_group_ranks(mesh.data_group),
        "model_group": dist.get_process_group_ranks(mesh.model_group)}
    loader = DataLoader(list(range(inp["n_items"])), 1, shuffle=True,
                        seed=3, **batch_sharding(mesh))
    out["shard"] = loader._indices().tolist()
    return out
