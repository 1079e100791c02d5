"""The ray mesh: which rank renders which rays (port of ``parallel/mesh.py``).

JAX lays its devices out on a ``jax.sharding.Mesh`` with a ``rays`` axis
(and optionally a ``model`` axis) and lets GSPMD split the batch. The port
runs one process a device, so a mesh is the process group with this rank's
place in it: :class:`RayMesh`. A batch of ``n`` rays is split into
contiguous shards whose sizes differ by at most one (:func:`ray_range`);
JAX falls back to its plain modules when ``n`` does not divide evenly, the
port keeps its kernels for any ``n``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """The ranks of a data-parallel run and this process's place in it.
    ``row_sliced``: each process holds only its row slice of the ray tables
    (multi-host, ``dist_coordinator``); else every rank holds all of them."""

    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None  # a torch.distributed ProcessGroup
    row_sliced: bool = False


def make_mesh(shape: Optional[Sequence[int]] = None, device=None, group=None,
              row_sliced: bool = False) -> RayMesh:
    """The ray mesh over the ranks of ``group`` (the default process group
    unless given), which must be set up (:func:`parallel.distributed.
    init_distributed`). ``shape`` ``[n]`` (or ``[n, 1]``) must name as many
    ranks as the group has; ``[dp, tp]`` with ``tp > 1`` is tensor
    parallelism, which is not ported (ROADMAP Queue 1). ``device``: this
    rank's device (its CUDA device unless given)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.init_distributed first")
    world = dist.get_world_size(group)
    n = world
    if shape is not None:
        n = 1
        for s in shape:
            n *= int(s)
        if n > world:
            raise ValueError(f"mesh_shape {list(shape)} needs {n} devices, "
                             f"have {world}")
    if shape is not None and len(shape) == 2 and shape[1] > 1:
        raise NotImplementedError(
            f"mesh_shape {list(shape)}: tensor parallelism (tp > 1) is not "
            "ported to PyTorch yet (ROADMAP Queue 1)")
    if n < world:
        raise ValueError(f"mesh_shape {list(shape)} names {n} of the {world} "
                         "ranks; one process drives one device, so the mesh "
                         "takes every rank")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return RayMesh(world, dist.get_rank(group), torch.device(device), group,
                   row_sliced)


def ray_range(n: int, mesh: Optional[RayMesh], chunk: int = 1):
    """This rank's rows ``[lo, hi)`` of an ``n``-row batch: contiguous
    shards in rank order, the first ``n % size`` one row longer; with
    ``chunk``, whole blocks of that many rows (a bake's chunks, so that
    each chunk is computed as one process computes it)."""
    if mesh is None:
        return 0, n
    return shard_bounds(n, mesh.size, mesh.rank, chunk)


def shard_bounds(n: int, size: int, rank: int, chunk: int = 1):
    """Rank ``rank``'s rows ``[lo, hi)`` of ``n`` over ``size`` ranks, in
    whole ``chunk``-row blocks (the last one ragged): contiguous, the block
    counts differing by at most one."""
    blocks = -(-n // chunk)
    base, extra = divmod(blocks, size)
    lo = rank * base + min(rank, extra)
    hi = lo + base + (1 if rank < extra else 0)
    return min(lo * chunk, n), min(hi * chunk, n)
