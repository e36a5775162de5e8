"""Process groups, object gathers and rank launches over ``torch.distributed``.

Counterpart of ``snipper_tpu/parallel/multihost.py``. The JAX package runs
one process per host over a device mesh, with a trivial single-process
fast path; the port runs one process per GPU, launched by ``torchrun``
(or :func:`spawn`), and joined into one process group:

- A CUDA device gets NCCL and a CPU device gets gloo. The backend can be
  given explicitly (two gloo ranks may share one card; NCCL refuses two
  ranks on one device), but it never changes silently.
- Without a process group, or at world size 1, nothing here issues a
  collective: each function takes its single-process path.

The reference aggregates eval results through a filesystem rendezvous
(reference ``main.py:291-322``); :func:`all_gather_objects` replaces it.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import queue
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# how long a rank waits in a collective (or a launch waits for its ranks)
# before it fails instead of hanging
TIMEOUT_S = 600.0


def process_count(group=None) -> int:
    """The ranks of ``group`` (the default group), 1 without a group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def process_index(group=None) -> int:
    """This process's rank in ``group`` (the default group), 0 without a
    group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def print0(*args, **kwargs):
    """``print`` on rank 0 only, flushed."""
    if is_main_process():
        print(*args, flush=True, **kwargs)


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def collective_device(group=None) -> torch.device:
    """Where a small tensor of a collective over ``group`` lives: the
    current card under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def init_process_group(device, backend: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None, store=None,
                       timeout_s: float = TIMEOUT_S):
    """Join the default process group: from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) unless
    ``store``, ``rank`` and ``world_size`` are given. ``backend`` defaults
    to :func:`default_backend` of ``device``."""
    backend = backend or default_backend(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    if store is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, timeout=timeout)


@contextlib.contextmanager
def distributed(device: torch.device):
    """The CLIs' process group. Under ``torchrun`` (its ``RANK`` and
    ``LOCAL_RANK`` in the environment) this joins the group, yields this
    rank's device (``cuda:LOCAL_RANK`` unless the CPU was asked for) and
    leaves the group at the end. A group the caller already made is used
    as it is, and left to the caller. Without either, this yields
    ``device`` and makes no group."""
    if dist.is_initialized() or "RANK" not in os.environ:
        yield device
        return
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    init_process_group(device)
    print0(f"process group: {dist.get_backend()}, world {process_count()}, "
           f"rank 0 on {device}")
    try:
        yield device
    finally:
        dist.destroy_process_group()


def barrier():
    if process_count() > 1:
        dist.barrier()


def all_gather_objects(obj: Any, group=None) -> List[Any]:
    """One picklable object from every rank of ``group``; the list in rank
    order, the same on every rank."""
    n = process_count(group)
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def merge_eval_results(local_results: List[dict], group=None) -> List[dict]:
    """Concatenate the ranks' eval result lists (rank order)."""
    out: List[dict] = []
    for chunk in all_gather_objects(local_results, group):
        out.extend(chunk)
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def any_process(flag: bool, group=None) -> bool:
    """True on every rank when ``flag`` is true on any (an all-reduce of
    the maximum), so that all ranks take a branch or none does."""
    if process_count(group) == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def broadcast_module(module: torch.nn.Module, src: int = 0):
    """Copy rank ``src``'s parameters and buffers into every rank's
    ``module`` in place."""
    if process_count() == 1:
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src)


# ------------------------------------------------------------ rank launch
def _rank_main(rank: int, world_size: int, port: int, backend: str,
               timeout_s: float, fn: Callable, args: Sequence,
               results: "multiprocessing.Queue"):
    try:
        store = dist.TCPStore("localhost", port, is_master=False,
                              timeout=datetime.timedelta(seconds=timeout_s))
        init_process_group(None, backend, rank, world_size, store, timeout_s)
        results.put((rank, None, fn(*args)))
    except BaseException:  # noqa: BLE001 - the launcher re-raises it
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Sequence = (),
          backend: str = "gloo", timeout_s: float = TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` in ``world_size`` new processes (``spawn``
    start), rank r in process r, joined into one process group of
    ``backend``; returns their results in rank order. ``fn`` and ``args``
    must pickle. This process hosts the group's store on a port the system
    picks, so concurrent launches do not collide. A rank that raises, dies
    or outlives ``timeout_s`` ends the launch: the other ranks are
    terminated and this raises ``RuntimeError``."""
    store = dist.TCPStore("localhost", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, store.port, backend, timeout_s,
                               fn, tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * world_size
    pending = set(range(world_size))
    deadline = time.monotonic() + timeout_s
    try:
        while pending:
            try:
                rank, err, res = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in pending if procs[r].exitcode is not None]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited with codes "
                                       f"{[procs[r].exitcode for r in dead]}"
                                       " and no result") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"ranks {sorted(pending)} did not "
                                       f"finish in {timeout_s:g} s") from None
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world_size} "
                                   f"failed:\n{err}")
            out[rank] = res
            pending.discard(rank)
    finally:
        for p in procs:
            p.join(timeout=0 if pending else 30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    return out
