"""Data and tensor parallelism with ``torch.distributed`` (port of
``parallel/``).

One process drives one device. Every rank holds the whole model (about 1-2
MB) and draws the same global batch from the same seeded generator; it
renders its contiguous shard of the batch's rays through the fused kernels,
the per-ray outputs are gathered (:mod:`parallel.gather`), every rank
computes the same losses on the gathered batch, and the gradients are summed
over the ranks before the optimizer's step. JAX gets the same from GSPMD: a
sharding constraint on the ray batch and a ``psum`` that XLA inserts.
Tensor parallelism (``mesh_shape=[dp, tp]`` with ``tp > 1``) splits the
MLPs' wide layers by columns over each model group of a ``dp x tp`` grid
(:mod:`parallel.tensor`), as JAX's ``shard_params`` splits its kernels and
GSPMD inserts the collectives.
"""

from depth_lidar_nerf_tpu_torch.parallel.mesh import (RayMesh, make_mesh,
                                                      model_parallel_size,
                                                      ray_range, tp_spec)

__all__ = ["RayMesh", "make_mesh", "model_parallel_size", "ray_range",
           "tp_spec"]
