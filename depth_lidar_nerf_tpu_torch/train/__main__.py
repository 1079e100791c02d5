"""CLI entry: ``python -m depth_lidar_nerf_tpu_torch.train --config configs/x.txt``.

Same interface as the JAX package's ``python -m depth_lidar_nerf_tpu.train``
and the reference's ``python run_nerf.py --config ...``
(``run_nerf.py:2028-2031``): the config file plus ``--flag value``
overrides, parsed by the port's ``parse_args``. It runs on the card.

Data parallelism, one process a card: ``--mesh_shape N`` starts N ranks on
this host (or, under ``torchrun --nproc_per_node N``, joins torchrun's);
with ``--dist_coordinator host:port`` every participating process runs this
same command with its ``--dist_process_id`` (and ``--dist_num_processes``;
-1 reads torchrun's ``RANK`` and ``WORLD_SIZE``) and joins the group before
the trainer starts, as JAX's entry does. Tensor parallelism:
``--mesh_shape dp tp --use_fused_mlp False`` starts ``dp * tp`` ranks, the
MLPs' wide layers split over each ``tp`` consecutive ranks.
"""

from depth_lidar_nerf_tpu_torch.train.config import parse_args

if __name__ == "__main__":
    cfg = parse_args()
    if cfg.dist_coordinator:
        from depth_lidar_nerf_tpu_torch.parallel.distributed import \
            init_distributed

        init_distributed(cfg.dist_coordinator, cfg.dist_num_processes,
                         cfg.dist_process_id)
    from depth_lidar_nerf_tpu_torch.train.loop import train

    train(cfg)
    if cfg.dist_coordinator:
        import torch.distributed as dist

        dist.destroy_process_group()
