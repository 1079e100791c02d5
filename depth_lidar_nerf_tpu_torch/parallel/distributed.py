"""Process groups, multi-host ray tables and replicated state (port of
``parallel/distributed.py``).

JAX joins its processes with ``jax.distributed.initialize`` and builds one
global mesh over every process's devices. The port joins a
``torch.distributed`` process group, one process a device: NCCL on the
card, gloo on the CPU, rendezvous at ``tcp://host:port``. Under
``dist_coordinator`` (multi-host) each process keeps only its row slice of
the ray tables (:func:`shard_table_rows`, a :class:`RowShard`); a step's
batch rows are collected with :func:`gather_table_rows`, whose traffic is
the batch's, not the table's. Rank and world size always come from the
process group.

JAX's ``global_replicated`` and ``global_key`` place the state and a PRNG
key on every process. The port broadcasts rank 0's whole train state once
(``train/checkpoint.broadcast_state``), and needs no key: every rank seeds
the same ``torch.Generator`` from the config, so the draws agree without a
collective.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from depth_lidar_nerf_tpu_torch.device import resolve_device

# How long a collective waits for the other ranks before it raises.
TIMEOUT = datetime.timedelta(minutes=10)


def rank_device(rank: int, device_type: str) -> torch.device:
    """A rank's device: the CPU for ``cpu``, else ``cuda:(LOCAL_RANK or
    rank % device_count)``; no card raises, as :func:`resolve_device`."""
    if device_type == "cpu":
        return torch.device("cpu")
    resolve_device("cuda")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def init_distributed(coordinator_address: Optional[str],
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda",
                     timeout: datetime.timedelta = TIMEOUT,
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group (JAX ``init_distributed``) and return this
    rank's device. ``coordinator_address`` ``host:port`` is rank 0's
    rendezvous (``tcp://``); None reads ``MASTER_ADDR``/``MASTER_PORT``
    (``env://``, as torchrun sets them). ``num_processes`` and
    ``process_id`` None or negative read ``WORLD_SIZE`` and ``RANK``.
    ``device`` ``cuda`` joins over NCCL, ``cpu`` over gloo, unless
    ``backend`` names another (gloo on the card: ranks that share one)."""
    device_type = resolve_device(device).type

    def given_or_env(value, name):
        if value is not None and value >= 0:
            return int(value)
        if name not in os.environ:
            raise ValueError(f"no {name.lower()} given and {name} is not set "
                             "(pass dist_num_processes / dist_process_id, or "
                             "launch with torchrun)")
        return int(os.environ[name])

    world = given_or_env(num_processes, "WORLD_SIZE")
    rank = given_or_env(process_id, "RANK")
    dev = rank_device(rank, device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    method = (f"tcp://{coordinator_address}" if coordinator_address
              else "env://")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=method, world_size=world,
                            rank=rank, timeout=timeout)
    return dev


def free_port() -> int:
    """A TCP port free on this host now, for a local rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device_type, timeout, backend, fn, args):
    init_distributed(f"127.0.0.1:{port}", world, rank, device_type, timeout,
                     backend)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch_local(world: int, fn, args=(), rank0_args=None, device="cuda",
                 timeout: datetime.timedelta = TIMEOUT,
                 backend: Optional[str] = None):
    """Run ``fn(*args)`` on ``world`` ranks of this host: this process
    becomes rank 0 and starts ranks 1..world-1 (start method ``spawn``),
    all joined over ``tcp://127.0.0.1:<free port>``. Returns rank 0's result
    (``rank0_args`` in the place of ``args`` there, if given). The other
    ranks are joined after it; any that exits non-zero raises, and if rank
    0 raises the others are stopped. ``backend`` as for
    :func:`init_distributed`."""
    device_type = torch.device(device).type
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, device_type, timeout, backend,
                               fn, args))
             for r in range(1, world)]
    for p in procs:
        p.start()
    ok = False
    try:
        init_distributed(f"127.0.0.1:{port}", world, 0, device_type, timeout,
                         backend)
        try:
            out = fn(*(args if rank0_args is None else rank0_args))
        finally:
            dist.destroy_process_group()
        ok = True
    finally:
        for p in procs:
            if not ok:
                p.terminate()
            p.join()
    bad = [(r + 1, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError(f"ranks exited with errors (rank, code): {bad}")
    return out


def _process(group=None):
    """(rank, world size) of this process in ``group``; (0, 1) without a
    process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def process_row_slice(global_rows: int, shard_rows: bool = True, group=None):
    """This process's ``[lo, hi)`` rows of a ``global_rows``-row table,
    padded first to a multiple of the world size (:func:`pad_rows`): every
    process gets ``global_rows // world`` rows. With ``shard_rows=False``
    or one process, the full range."""
    pid, n = _process(group)
    if n == 1 or not shard_rows:
        return 0, global_rows
    assert global_rows % n == 0, (
        f"pad the table first: {global_rows} rows over {n} processes")
    per = global_rows // n
    return pid * per, (pid + 1) * per


def pad_rows(table, multiple: int):
    """Pad dim 0 of every field of ``table`` (a tuple of arrays or tensors,
    None entries kept) up to a multiple of ``multiple`` by repeating row 0;
    returns ``(table, rows)``. Batches are drawn with replacement, so a
    repeated row only moves that row's odds by ``O(pad / rows)``."""
    rows = next(x for x in table if x is not None).shape[0]
    pad = (-rows) % multiple
    if pad == 0:
        return table, rows

    def one(x):
        if x is None:
            return None
        if torch.is_tensor(x):
            return torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])
        reps = np.broadcast_to(x[:1], (pad,) + x.shape[1:])
        return np.concatenate([np.asarray(x), reps], axis=0)

    return type(table)(*(one(x) for x in table)), rows + pad


class RowShard(NamedTuple):
    """This process's rows ``lo : lo + len`` of a ``rows``-row table (or
    tensor) ``local`` whose other rows live in the other processes."""

    local: object  # a table tuple of tensors, or one tensor
    lo: int
    rows: int


def shard_table_rows(local_table, lo: int, global_rows: int,
                     device=None) -> RowShard:
    """This process's row slice ``local_table`` (a table tuple holding rows
    ``lo`` on of a ``global_rows``-row table) on ``device`` as a
    :class:`RowShard`."""
    return RowShard(type(local_table)(*(
        None if x is None else torch.as_tensor(x).to(device)
        for x in local_table)), lo, global_rows)


def table_rows(table) -> int:
    """The rows of a ray table, whole or a :class:`RowShard`."""
    return table.rows if isinstance(table, RowShard) else \
        table.origins.shape[0]


def gather_table_rows(local, lo: int, idx: torch.Tensor, group=None):
    """Rows ``idx`` (global indices) of a table held as row slices, on every
    rank: each rank puts the rows that fall in its slice ``lo : lo + len``
    and zeros elsewhere, and the ranks' buffers are summed. The sum is
    exact, since one rank alone contributes each row (a zero adds nothing;
    -0.0 comes back +0.0). Traffic is the batch's rows, ``O(len(idx))``."""
    def one(x):
        if x is None:
            return None
        n = x.shape[0]
        mine = (idx >= lo) & (idx < lo + n)
        rows = x[(idx - lo).clamp(0, max(n - 1, 0))]
        mask = mine.reshape((-1,) + (1,) * (x.dim() - 1))
        out = torch.where(mask, rows, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    if torch.is_tensor(local):
        return one(local)
    return type(local)(*(one(x) for x in local))


def take_rows(x, idx: torch.Tensor, group=None):
    """Rows ``idx`` of a tensor, or of a :class:`RowShard` of a table tuple
    or tensor (:func:`gather_table_rows`; a table comes back as a table of
    the batch's rows)."""
    if isinstance(x, RowShard):
        return gather_table_rows(x.local, x.lo, idx, group)
    return x[idx]


def broadcast_object(obj, mesh):
    """Global rank 0's ``obj`` (any picklable object; tensors on the CPU) on
    every rank of the mesh."""
    if mesh is None:
        return obj
    group = mesh.world_group
    src = 0 if group is None else dist.get_global_rank(group, 0)
    box = [obj if mesh.global_rank == 0 else None]
    dist.broadcast_object_list(box, src, group=group,
                               device=mesh.device if mesh.device.type == "cuda"
                               else None)
    return box[0]
