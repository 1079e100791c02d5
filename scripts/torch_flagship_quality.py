"""The flagship-config quality run on the PyTorch port (the port's counterpart
of ``scripts/flagship_quality.py``).

Writes the same deterministic synthetic scene with the port's own
``make_scene`` (20 views of 94 x 352, the KITTI-360 factor-4 frame, focal 88,
a textured backdrop, 8,000 LiDAR-style depth points a view, seed 1; with
``--hard`` the non-saturating scene) and trains ``configs/
flagship_synthetic.txt`` with the port's ``train()`` on the card: RGB + LiDAR
depth + inverse-depth smoothness + the VGG19 content loss (full-frame 94 x
352 patches every 10th iteration) + the semantic loss, 20,000 iterations.

    python scripts/torch_flagship_quality.py            # scene + train
    python scripts/torch_flagship_quality.py --scene    # scene only
    python scripts/torch_flagship_quality.py --N_iters 300 --i_testset 300

Other arguments go to the driver's command line after the config's. The
held-out metrics (PSNR, SSIM, LPIPS) are the ``[TEST]`` lines, every
``i_testset`` iterations. VGG19 and LPIPS weights are read from
``$VGG19_TORCH_WEIGHTS`` / ``<scene>/vgg19.pth`` and ``$LPIPS_TORCH_WEIGHTS``
where present, else drawn from seed 0.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene

    argv = sys.argv[1:] if argv is None else list(argv)
    hard = "--hard" in argv
    scene = os.path.join(ROOT, "runs",
                         "flagship_scene_hard" if hard else "flagship_scene")
    if not os.path.exists(os.path.join(scene, "poses_bounds.npy")):
        make_scene(scene, n_images=20, H=94, W=352, focal=88.0,
                   n_depth_points=8000, seed=1, backdrop=True, hard=hard)
        print(f"scene written to {scene}")
    if "--scene" in argv:
        return

    from depth_lidar_nerf_tpu_torch.train.config import parse_args
    from depth_lidar_nerf_tpu_torch.train.loop import train

    os.chdir(ROOT)
    extra = [a for a in argv if a != "--hard"]
    cfg = parse_args(["--config", "configs/flagship_synthetic.txt",
                      "--datadir", scene,
                      *(["--expname", "flagship_hard"] if hard else []),
                      *extra])
    train(cfg)


if __name__ == "__main__":
    main()
