"""CLI entry: ``python -m depth_lidar_nerf_tpu_torch.train --config configs/x.txt``.

Same interface as the JAX package's ``python -m depth_lidar_nerf_tpu.train``
and the reference's ``python run_nerf.py --config ...``
(``run_nerf.py:2028-2031``): the config file plus ``--flag value``
overrides, parsed by the port's ``parse_args``. It runs on the card;
multi-host training (``--dist_coordinator``) is not ported yet.
"""

from depth_lidar_nerf_tpu_torch.train.config import parse_args

if __name__ == "__main__":
    cfg = parse_args()
    if cfg.dist_coordinator:
        raise NotImplementedError(
            "--dist_coordinator (multi-host training) is not ported to "
            "PyTorch yet (ROADMAP Queue 1)")
    from depth_lidar_nerf_tpu_torch.train.loop import train

    train(cfg)
