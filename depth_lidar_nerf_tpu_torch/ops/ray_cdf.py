"""Per-ray importance weights baked into the ray tables (port of
``ops/ray_cdf.py``, grid training).

Every ray the trainer can draw lives in a device-resident table
(``train/tables.py``). Past ``grid_train_after`` the driver bakes the live
fine field's compositing weights along every table ray on a fixed z-grid,
and a grid step gathers each drawn ray's row and inverts its CDF in place of
the coarse MLP pass (``train/step.py``). The bake is an eval render's coarse
pass at deterministic depths: on the card it runs kernel 1 over chunks of
table rays.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from depth_lidar_nerf_tpu_torch.ops.sampling import unit_linspace
from depth_lidar_nerf_tpu_torch.render.renderer import (RenderConfig, Rays,
                                                        _composite_from_z)


class RayCDF(NamedTuple):
    """Baked per-ray weights of the two tables. ``z`` is the shared bake
    z-grid ``[S]``; ``0.5 (z[1:] + z[:-1])`` are the inverse CDF's bins."""

    # [M_rgb, S] bfloat16 (a RowShard of it where the tables are row slices)
    w_rgb: torch.Tensor
    w_depth: Optional[torch.Tensor]  # [M_depth, S] bfloat16 or None
    z: torch.Tensor  # [S] float32


BAKE_CHUNK = 1 << 14  # rays a chunk of :func:`bake_table_weights`


def cdf_z_grid(rcfg: RenderConfig, S: int, device=None) -> torch.Tensor:
    """The bake depths: the unperturbed stratified grid
    (``ops.sampling.stratified_z_vals`` with ``perturb=False``) on
    ``[near, far]``, honouring ``lindisp``."""
    t = unit_linspace(S, device)
    near = torch.tensor(rcfg.near, dtype=torch.float32, device=device)
    far = torch.tensor(rcfg.far, dtype=torch.float32, device=device)
    if rcfg.lindisp:
        return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    return near * (1.0 - t) + far * t


@torch.no_grad()
def bake_table_weights(model, rcfg: RenderConfig, origins, directions,
                       viewdirs, S: int, chunk: int = BAKE_CHUNK) -> torch.Tensor:
    """The field's compositing weights along every table ray, ``[M, S]``
    bfloat16, in chunks of ``chunk`` rays (JAX pads the last chunk with zero
    rays; per-ray results do not depend on the others, so a ragged last
    chunk gives the same rows).

    Eval semantics: no jitter, no noise, no cull, no int8 and no semantic
    head (the CDF needs sigma only). With ``num_semantic_classes = 0`` a
    model with a semantic head takes the plain module, as in JAX: the rgb
    kernels refuse its topology."""
    rcfg_b = dataclasses.replace(rcfg.eval_mode(), cull_eps=0.0,
                                 num_semantic_classes=0, render_grid=0,
                                 render_int8=False)
    dev = origins.device
    z = cdf_z_grid(rcfg_b, S, dev)
    out = []
    for s in range(0, origins.shape[0], chunk):
        o, d, v = (x[s:s + chunk] for x in (origins, directions, viewdirs))
        n = o.shape[0]
        rays = Rays(o, d, v,
                    torch.full((n, 1), rcfg_b.near, dtype=torch.float32,
                               device=dev),
                    torch.full((n, 1), rcfg_b.far, dtype=torch.float32,
                               device=dev))
        comp = _composite_from_z(model, rays, z.expand(n, S), rcfg_b, None)
        out.append(comp.weights.to(torch.bfloat16))
    if not out:
        return torch.empty((0, S), dtype=torch.bfloat16, device=dev)
    return torch.cat(out)


def bake_ray_cdf(models, rcfg: RenderConfig, rgb_table, depth_table,
                 S: int, mesh=None) -> RayCDF:
    """Bake both tables' weights from the live fine model (the coarse one
    without a fine pass).

    With a ``mesh`` each rank bakes its share of the chunks of rows
    (``parallel.mesh.ray_range``) and the ranks gather them, so every rank
    holds all of them (JAX replicates the bake). A table held as row slices
    (:class:`~parallel.distributed.RowShard`, multi-host) gives weights
    held the same way: each process bakes its own slice, and a step
    collects its batch's rows with ``gather_table_rows``. The bake works
    row by row, so either way the rows equal one process's bake."""
    from depth_lidar_nerf_tpu_torch.parallel.distributed import RowShard
    from depth_lidar_nerf_tpu_torch.parallel.gather import gather_rays
    from depth_lidar_nerf_tpu_torch.parallel.mesh import ray_range

    model = models.fine if models.fine is not None else models.coarse

    def bake(table):
        if isinstance(table, RowShard):
            t = table.local
            return RowShard(bake_table_weights(
                model, rcfg, t.origins, t.directions, t.viewdirs, S),
                table.lo, table.rows)
        n = table.origins.shape[0]
        lo, hi = ray_range(n, mesh, BAKE_CHUNK)
        w = bake_table_weights(model, rcfg, table.origins[lo:hi],
                               table.directions[lo:hi],
                               table.viewdirs[lo:hi], S)
        return w if mesh is None else gather_rays(w, n, mesh, BAKE_CHUNK)

    dev = (rgb_table.local if isinstance(rgb_table, RowShard)
           else rgb_table).origins.device
    return RayCDF(bake(rgb_table),
                  bake(depth_table) if depth_table is not None else None,
                  cdf_z_grid(rcfg, S, dev))
