"""Data parallelism over rays with ``torch.distributed`` (port of
``parallel/``).

One process drives one device. Every rank holds the whole model (about 1-2
MB) and draws the same global batch from the same seeded generator; it
renders its contiguous shard of the batch's rays through the fused kernels,
the per-ray outputs are gathered (:mod:`parallel.gather`), every rank
computes the same losses on the gathered batch, and the gradients are summed
over the ranks before the optimizer's step. JAX gets the same from GSPMD: a
sharding constraint on the ray batch and a ``psum`` that XLA inserts.
Tensor parallelism (``mesh_shape=[dp, tp]`` with ``tp > 1``) is not ported.
"""

from depth_lidar_nerf_tpu_torch.parallel.mesh import (RayMesh, make_mesh,
                                                      ray_range)

__all__ = ["RayMesh", "make_mesh", "ray_range"]
