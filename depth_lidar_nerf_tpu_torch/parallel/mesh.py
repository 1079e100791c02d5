"""The mesh: which rank renders which rays and holds which columns (port of
``parallel/mesh.py``).

JAX lays its devices out on a ``jax.sharding.Mesh`` with a ``rays`` axis
and optionally a ``model`` axis, and lets GSPMD split the batch and the
weights. The port runs one process a device, so a mesh is the process
group with this rank's place in it: :class:`RayMesh`. A batch of ``n`` rays
is split over the ray axis into contiguous shards whose sizes differ by at
most one (:func:`ray_range`); JAX falls back to its plain modules when
``n`` does not divide evenly, the port keeps its kernels for any ``n``.

``[dp, tp]`` lays the ranks out row-major on a ``dp x tp`` grid, as JAX
lays out its devices, so that the ranks of a model group are contiguous:
rank ``d * tp + t`` has ray index ``d`` and model index ``t``. The ranks of
one model index form a ray group, over which the batch is split and the
gradients summed; the ranks of one ray index form a model group, over which
the MLPs' wide layers are split by columns (:func:`tp_spec`,
:mod:`parallel.tensor`). :attr:`RayMesh.size` and :attr:`RayMesh.rank` are
the ray axis's, so code that shards rays reads them unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """The ranks of a data-parallel run and this process's place in it.
    ``size``/``rank``/``group``: the ray axis (``group`` None: the whole
    default group). ``row_sliced``: each process holds only its row slice
    of the ray tables (multi-host, ``dist_coordinator``); else every rank
    holds all of them. ``tp``/``tp_rank``/``model_group``: the model axis
    (1, 0 and None without tensor parallelism). ``global_rank``: the rank in
    ``world_group``, the group the mesh was made over (None: the default
    group); global rank 0 alone prints and writes."""

    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None  # a torch.distributed ProcessGroup
    row_sliced: bool = False
    tp: int = 1
    tp_rank: int = 0
    model_group: Optional[object] = None
    global_rank: int = 0
    world_group: Optional[object] = None


def make_mesh(shape: Optional[Sequence[int]] = None, device=None, group=None,
              row_sliced: bool = False) -> RayMesh:
    """The mesh over the ranks of ``group`` (the default process group
    unless given), which must be set up (:func:`parallel.distributed.
    init_distributed`). ``shape`` ``[n]`` (or ``[n, 1]``) is a ray mesh;
    ``[dp, tp]`` a ``dp x tp`` grid (the module's note). Either must name as
    many ranks as the group has. Every rank makes the grid's subgroups in
    the same order (``torch.distributed.new_group`` is collective).
    ``device``: this rank's device (its CUDA device unless given)."""
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
    if n < world:
        raise ValueError(f"mesh_shape {list(shape)} names {n} of the {world} "
                         "ranks; one process drives one device, so the mesh "
                         "takes every rank")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    me = dist.get_rank(group)
    tp = int(shape[1]) if shape is not None and len(shape) == 2 else 1
    if tp <= 1:
        return RayMesh(world, me, torch.device(device), group, row_sliced,
                       global_rank=me, world_group=group)
    dp = world // tp

    def ranks(members):
        return [m if group is None else dist.get_global_rank(group, m)
                for m in members]

    ray_group = model_group = None
    for t in range(tp):  # one ray group a model index
        g = dist.new_group(ranks([d * tp + t for d in range(dp)]))
        if me % tp == t:
            ray_group = g
    for d in range(dp):  # one model group a ray index
        g = dist.new_group(ranks([d * tp + t for t in range(tp)]))
        if me // tp == d:
            model_group = g
    return RayMesh(dp, me // tp, torch.device(device), ray_group, row_sliced,
                   tp, me % tp, model_group, me, group)


def model_parallel_size(mesh: Optional[RayMesh]) -> int:
    """The mesh's tp degree (1 without a mesh or on a ray mesh)."""
    return 1 if mesh is None else mesh.tp


def is_rank0(mesh: Optional[RayMesh]) -> bool:
    """Whether this process prints and writes: no mesh, or global rank 0."""
    return mesh is None or mesh.global_rank == 0


def tp_spec(shape: Sequence[int], tp: int) -> Optional[int]:
    """JAX ``_tp_spec`` in torch's layout: the dimension of a tensor of
    ``shape`` that is split over the model axis, or None where it is
    replicated. JAX splits a 1-D or 2-D array whose last dimension (a Flax
    kernel's output) divides by ``tp`` and is at least ``4 * tp`` wide; an
    ``nn.Linear`` weight is ``[out, in]`` and its bias ``[out]``, so the
    output is dimension 0 of either."""
    if tp > 1 and len(shape) in (1, 2) and shape[0] % tp == 0 \
            and shape[0] >= 4 * tp:
        return 0
    return None


def shard_rows(x: torch.Tensor, tp: int, tp_rank: int) -> torch.Tensor:
    """Model rank ``tp_rank``'s rows of ``x`` where :func:`tp_spec` splits
    it, else ``x``."""
    if tp_spec(x.shape, tp) is None:
        return x
    n = x.shape[0] // tp
    return x[tp_rank * n:(tp_rank + 1) * n]


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
