"""CLI: generate a synthetic LLFF scene (the port's copy of
``depth_lidar_nerf_tpu/data/make_synthetic.py``).

``python -m depth_lidar_nerf_tpu_torch.data.make_synthetic <outdir> [n H W]``
"""

import sys

from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene

if __name__ == "__main__":
    outdir = sys.argv[1] if len(sys.argv) > 1 else "./train_data_synth"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    H = int(sys.argv[3]) if len(sys.argv) > 3 else 40
    W = int(sys.argv[4]) if len(sys.argv) > 4 else 52
    make_scene(outdir, n_images=n, H=H, W=W)
    print("wrote synthetic scene to", outdir)
