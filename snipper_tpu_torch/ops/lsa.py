"""Linear sum assignment on the device: the plain PyTorch version of the
JAX package's Jonker-Volgenant solver and the wrapper of its Hopper kernel
``lsa_rows`` (``ops/csrc/lsa.cu``).

The JAX package solves the matcher's assignment on the device with a
shortest-augmenting-path (Jonker-Volgenant) solver written in XLA loops,
``_lsa_rows`` vmapped by ``hungarian`` (``snipper_tpu/matching/
matcher.py:103-180``), so that its train step stays one program. Both
versions here run that algorithm step for step in f32: the reduced costs
``minval + cost[i] - u[i] - v`` summed left to right, the strict
``red < sp`` over unscanned columns, the first minimal column of
``where(scanned, 1e30, sp)`` (``jnp.argmin``'s tie rule), the dual
updates with ``u[cur_row] += minval`` before the other scanned rows, and
the augmentation. They therefore give JAX's assignment on every row,
ties included, where scipy's solver breaks ties another way.

:func:`lsa_rows` chooses by device: a CPU tensor takes
:func:`lsa_rows_torch`, a CUDA tensor launches the kernel through the
registered operator ``torch.ops.snipper_tpu_torch.lsa_rows`` or raises.
There is no fallback to the plain version or to scipy.
``lsa_rows.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_INF = 1e30  # JAX's _INF, as f32
# shared memory a block can take on Hopper (the opt-in maximum)
MAX_SHARED_BYTES = 232448


def lsa_rows_torch(cost: torch.Tensor, return_steps: bool = False):
    """Plain version: ``cost [P, M, N]`` (M <= N), each of the P problems'
    rows assigned to a distinct column at the least total cost. Returns
    ``col4row [P, M]`` int64, and with ``return_steps`` also the number
    of Dijkstra steps (column scans) each problem took, ``[P]`` int64.

    The P problems run in lockstep, each frozen once its search or its
    augmentation is done, as ``vmap`` of JAX's ``while_loop`` runs them:
    about one pass of tensor ops per step of the slowest problem."""
    P, M, N = cost.shape
    if M > N:
        raise ValueError(f"lsa_rows: need rows <= columns (got M={M}, "
                         f"N={N})")
    f32, i64 = torch.float32, torch.int64
    dev = cost.device
    cost = cost.to(f32)
    inf = torch.tensor(_INF, dtype=f32, device=dev)
    u = torch.zeros(P, M, dtype=f32, device=dev)
    v = torch.zeros(P, N, dtype=f32, device=dev)
    col4row = torch.full((P, M), -1, dtype=i64, device=dev)
    row4col = torch.full((P, N), -1, dtype=i64, device=dev)
    steps = torch.zeros(P, dtype=i64, device=dev)
    rows = torch.arange(M, device=dev)
    for cur_row in range(M):
        sp = torch.full((P, N), _INF, dtype=f32, device=dev)
        path = torch.full((P, N), -1, dtype=i64, device=dev)
        SR = torch.zeros(P, M, dtype=torch.bool, device=dev)
        SC = torch.zeros(P, N, dtype=torch.bool, device=dev)
        i = torch.full((P,), cur_row, dtype=i64, device=dev)
        minval = torch.zeros(P, dtype=f32, device=dev)
        sink = torch.full((P,), -1, dtype=i64, device=dev)
        act = torch.arange(P, device=dev)  # problems still searching
        while act.numel():
            ia = i[act]
            SR[act, ia] = True
            red = (minval[act, None] + cost[act, ia] - u[act, ia][:, None]
                   - v[act])
            sc = SC[act]
            upd = (red < sp[act]) & ~sc
            sp_a = torch.where(upd, red, sp[act])
            sp[act] = sp_a
            path[act] = torch.where(upd, ia[:, None], path[act])
            masked = torch.where(sc, inf, sp_a)
            j = masked.argmin(1)  # the first minimal column, as jnp.argmin
            minval[act] = masked.gather(1, j[:, None])[:, 0]
            SC[act, j] = True
            r = row4col[act, j]
            free = r < 0
            sink[act[free]] = j[free]
            i[act] = torch.where(free, ia, r)
            steps[act] += 1
            act = act[~free]

        # dual updates (matcher.py:144-151)
        u[:, cur_row] += minval
        extra = torch.where(
            SR & (rows != cur_row),
            minval[:, None] - sp.gather(1, col4row.clamp(0, N - 1)), 0.0)
        u = u + extra
        v = torch.where(SC, v - (minval[:, None] - sp), v)

        # augment along the alternating path ending at each sink
        j = sink
        act = torch.arange(P, device=dev)
        while act.numel():
            ja = j[act]
            ia = path[act, ja]
            row4col[act, ja] = ia
            j[act] = col4row[act, ia]
            col4row[act, ia] = ja
            act = act[ia != cur_row]
    return (col4row, steps) if return_steps else col4row


def shared_bytes(M: int, N: int) -> int:
    """Dynamic shared memory of one ``lsa_rows`` block (``lsa.cu``): the
    costs, ``v``, ``sp``, ``u`` (f32), ``path``, ``row4col``, ``col4row``
    (int32) and the scanned flags (bytes)."""
    return 4 * (M * N + 2 * N + M) + 4 * (2 * N + M) + N + M


def _check(cost: torch.Tensor):
    """Shape, dtype and device the solver takes; returns ``(P, M, N)``."""
    if cost.dim() != 3:
        raise ValueError(f"lsa_rows: cost must be [P, M, N] (got "
                         f"{tuple(cost.shape)})")
    P, M, N = cost.shape
    if M > N:
        raise ValueError(f"lsa_rows: need rows <= columns (got M={M}, "
                         f"N={N})")
    if cost.dtype != torch.float32:
        raise TypeError(f"lsa_rows: cost must be float32 (got {cost.dtype})")
    if cost.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lsa_rows: cost must lie on the CPU or a CUDA "
                         f"device (got {cost.device})")
    return P, M, N


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load ``liblsa.so``."""
    from snipper_tpu_torch.ops import _build

    lib = _build.load("lsa.cu", "liblsa.so")
    # cost, out, P, M, N, three element strides of cost, stream
    lib.lsa_rows_f32.argtypes = ([ctypes.c_void_p] * 2
                                 + [ctypes.c_int64] * 6 + [ctypes.c_void_p])
    lib.lsa_rows_f32.restype = ctypes.c_int
    return lib


@torch.library.custom_op("snipper_tpu_torch::lsa_rows", mutates_args=(),
                         device_types="cuda")
def _lsa_rows_op(cost: torch.Tensor) -> torch.Tensor:
    """The operator's CUDA body: one launch, counted in
    ``lsa_rows.launches``. The cost is read through its strides, so a
    transposed view costs no copy."""
    P, M, N = _check(cost)
    out = torch.empty(P, M, dtype=torch.int64, device=cost.device)
    if P * M == 0:
        return out
    smem = shared_bytes(M, N)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"lsa_rows: an M={M} x N={N} problem needs {smem} "
                         f"bytes of shared memory, more than a block's "
                         f"{MAX_SHARED_BYTES}")
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().lsa_rows_f32(cost.data_ptr(), out.data_ptr(), P, M, N,
                                  *cost.stride(), stream)
    if err != 0:
        raise RuntimeError(f"lsa_rows launch failed: CUDA error {err}")
    lsa_rows.launches += 1
    return out


@_lsa_rows_op.register_fake
def _(cost):
    P, M, _ = cost.shape
    return cost.new_empty(P, M, dtype=torch.int64)


def lsa_rows(cost: torch.Tensor) -> torch.Tensor:
    """``col4row [P, M]`` int64 of ``cost [P, M, N]`` f32 (M <= N), by
    device: the plain version for a CPU tensor, the kernel for a CUDA
    tensor (any strides). Raises on anything else."""
    _check(cost)
    if cost.device.type == "cpu":
        return lsa_rows_torch(cost)
    return torch.ops.snipper_tpu_torch.lsa_rows(cost)


lsa_rows.launches = 0
