#!/usr/bin/env python3
"""Time a served frame and a training step of one checkout of the port, to
compare two checkouts on one card (run each in its own process, in turns:
parent, change, change, parent):

    python scripts/torch_frame_step_ab.py [--root CHECKOUT] [--reps 3]

The frame: ``configs/rgb_only.txt`` in bfloat16, ``chip_smoke.py`` phase
4's served field (seeded weights, density head scaled by 50 and offset by
-2, colour head scaled by 30), 3 spiral poses of 94 x 352 through
``render_path``, the host clock around each pass after a warm one. The
step: ``bench.py``'s ``two_mlp`` stack (phase 5: 16,384 rays, bfloat16,
``cull_eps`` 1e-4) on the in-memory synthetic scene, CUDA events over 20
steps after 5. Prints one JSON line with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

H, W, FOCAL, N_RAYS = 94, 352, 88.0, 16384


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_frame_step_ab: no CUDA device")
    from depth_lidar_nerf_tpu_torch.data.poses import generate_render_path
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         parse_args,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.loop import render_path
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step
    from depth_lidar_nerf_tpu_torch.train.tables import (build_depth_table,
                                                         build_rgb_table)

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    cfg = parse_args(["--config", "configs/rgb_only.txt",
                      "--compute_dtype", "bfloat16"])
    rcfg = render_config_from(cfg, 0, 0.0, 1.0)
    models = build_models(cfg, rcfg, device=dev)
    with torch.no_grad():
        for m in (models.coarse, models.fine):
            m.sigma.weight *= 50.0
            m.sigma.bias += -2.0
            m.rgb.weight *= 30.0
    base = np.stack([np.concatenate([np.eye(3), [[0.05 * k], [0.02 * k],
                                                 [0.0]]], axis=1)
                     for k in range(-2, 3)])
    poses = generate_render_path(base, FOCAL, N_views=30)[:3]
    render_path(models, poses, (H, W, FOCAL), rcfg, device=dev)
    frames = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.time()
        render_path(models, poses, (H, W, FOCAL), rcfg, device=dev)
        torch.cuda.synchronize()
        frames.append((time.time() - t0) * 1e3 / len(poses))
    del models
    torch.cuda.empty_cache()

    sc = draw_scene(n_images=4, H=H, W=W, focal=FOCAL, n_depth_points=8000,
                    backdrop=True)
    tcfg = TrainConfig(dataset_type="llff", N_rand=N_RAYS, N_samples=64,
                       N_importance=64, netdepth=4, netwidth=256,
                       netdepth_fine=4, netwidth_fine=256, use_viewdirs=True,
                       no_ndc=True, raw_noise_std=1.0, colmap_depth=True,
                       depth_loss=True, depth_lambda=0.01,
                       compute_dtype="bfloat16", cull_eps=1e-4, seed=0)
    trcfg = render_config_from(tcfg, 0, sc.near, sc.far)
    tm = build_models(tcfg, trcfg, device=dev)
    tables = (build_rgb_table(sc.images, sc.poses, range(4), *sc.hwf, trcfg,
                              device=dev),
              build_depth_table(sc.depth_gts, sc.poses, range(4), *sc.hwf,
                                trcfg, device=dev))
    state = init_train_state(tcfg, tm)
    step = make_train_step(tcfg, trcfg, tm, sc.hwf)
    gen = torch.Generator(device=dev).manual_seed(0)
    steps = []
    for _ in range(args.reps):
        for _ in range(5):
            step(state, *tables, gen)
        ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        ev0.record()
        for _ in range(20):
            step(state, *tables, gen)
        ev1.record()
        torch.cuda.synchronize()
        steps.append(ev0.elapsed_time(ev1) / 20)
    print(json.dumps({"root": root, "ms_per_frame": frames,
                      "ms_per_step": steps, "card": card}), flush=True)


if __name__ == "__main__":
    main()
