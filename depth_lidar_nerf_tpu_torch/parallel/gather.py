"""The collectives of a data-parallel step: the per-ray outputs gathered,
the gradients summed (what GSPMD inserts around JAX's sharded step).

:func:`run_sharded` renders this rank's rows of a leg of rays and gathers
the outputs over the ranks in row order. Under autograd the gather's
backward hands this rank's rows of the incoming gradient back, with no
reduction: every rank computes the same loss on the same gathered tensor,
so the incoming gradient is the same on every rank, and each rank's
parameter gradient is its own rows' share of the whole. (``torch.
distributed.nn.functional.all_gather`` would sum the incoming gradients
over the ranks and scale them by the world size.) :func:`all_reduce_grads`
then sums the shares.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from depth_lidar_nerf_tpu_torch.ops.sampling import RowRange, base_generator
from depth_lidar_nerf_tpu_torch.parallel.mesh import RayMesh, shard_bounds


def _like(full: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``full`` laid out in memory in ``x``'s order of dimensions (a
    renderer's ``[N, 3]`` map is the transpose of a ``[3, N]`` one): a
    reduction over the gathered tensor then runs in one process's order."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    inverse = [order.index(d) for d in range(x.dim())]
    return full.permute(order).contiguous().permute(inverse)


def _all_gather_rows(x: torch.Tensor, n: int, mesh: RayMesh,
                     chunk: int = 1) -> torch.Tensor:
    """Every rank's rows (``shard_bounds`` of ``n``) of ``x``, concatenated
    in rank order: each rank's ``x`` padded to the longest shard, gathered,
    trimmed, laid out as ``x``."""
    bounds = [shard_bounds(n, mesh.size, r, chunk) for r in range(mesh.size)]
    m = max(hi - lo for lo, hi in bounds)
    pad = x.contiguous()
    if pad.shape[0] < m:
        pad = torch.cat([pad, pad.new_zeros((m - pad.shape[0],)
                                            + pad.shape[1:])])
    parts = [torch.empty_like(pad) for _ in range(mesh.size)]
    dist.all_gather(parts, pad, group=mesh.group)
    full = torch.cat([p[:hi - lo] for p, (lo, hi) in zip(parts, bounds)])
    return _like(full, x)


class _GatherRows(torch.autograd.Function):
    """:func:`_all_gather_rows` whose backward returns this rank's rows of
    the incoming gradient."""

    @staticmethod
    def forward(ctx, x, n, mesh, chunk):
        ctx.rows = shard_bounds(n, mesh.size, mesh.rank, chunk)
        return _all_gather_rows(x, n, mesh, chunk)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[lo:hi], None, None, None


def gather_rays(x: torch.Tensor, n: int, mesh: RayMesh,
                chunk: int = 1) -> torch.Tensor:
    """This rank's rows ``ray_range(n, mesh, chunk)`` of a per-ray tensor
    ``x`` gathered into all ``n`` rows; differentiable (the backward takes
    this rank's rows of the gradient, see the module's note)."""
    return _GatherRows.apply(x, n, mesh, chunk)


def run_sharded(mesh: Optional[RayMesh], n: int,
                fn: Callable[[int, int, object], Dict[str, torch.Tensor]],
                generator=None, keys=None) -> Dict[str, torch.Tensor]:
    """``fn(lo, hi, gen)`` on this rank's rows ``[lo, hi)`` of an ``n``-ray
    leg, its dict of per-ray outputs gathered into ``[n, ...]`` each
    (``keys`` only, when given). ``gen`` is a :class:`RowRange` of
    ``generator``, so the leg reads one process's stream. Without a mesh,
    ``fn(0, n, generator)`` as it is.

    A rank whose shard is empty (``n`` below the world size) renders the
    leg's last row and contributes no rows: its draws then advance its
    generator as the others' do, and the row's graph gets a zero gradient,
    so every rank's graph reaches the same parameters."""
    if mesh is None:
        return fn(0, n, generator)
    lo, hi = shard_bounds(n, mesh.size, mesh.rank)
    live = hi > lo
    if not live:
        lo, hi = n - 1, n
    out = fn(lo, hi, RowRange(base_generator(generator), lo, hi, n))
    return {k: gather_rays(v if live else v[:0], n, mesh)
            for k, v in out.items() if keys is None or k in keys}


def all_reduce_grads(params, mesh: Optional[RayMesh]) -> None:
    """Sum ``params``' gradients over the ranks (JAX's gradient ``psum``):
    one flat bucket per dtype in parameter order, so the sum is the same
    on every rank and from run to run. Every rank builds the same graph
    (:func:`run_sharded`), so the same parameters have a gradient on every
    rank; one without stays without (the optimizer then skips it as
    before)."""
    if mesh is None:
        return
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        off = 0
        for p in ps:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
