#!/usr/bin/env python3
"""Per-step float32 loss gaps of ``chip_smoke.py`` phase 6's trajectory over
generator seeds (run on a machine with a CUDA card, from the repository
root):

    python scripts/torch_traj_seeds.py [--seeds 7 8 9 10] [--fused]

For each seed: 5 ``two_mlp`` steps of ``TRAJ_N_RAYS`` rays in float32
through the kernels and through the plain path (plain modules and the
sampling twin), from the same weights and generator seed, as phase 6 runs
them; prints the relative loss gap of each step. ``--fused`` computes the
stratified depths with one rounded multiply-add on the card too (the CPU
form of ``ops.sampling.stratified_z_vals``). The gap is what
``TRAJ_TOL["float32"][0]`` limits to 6e-6 at seed 7.
"""

import argparse
import contextlib
import os
import sys
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="*", default=[7, 8, 9, 10])
    ap.add_argument("--fused", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_traj_seeds: no CUDA device")
    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.ops import _build
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as fmt
    from depth_lidar_nerf_tpu_torch.ops import sampling
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as sc
    from depth_lidar_nerf_tpu_torch.render import renderer
    from depth_lidar_nerf_tpu_torch.train import step as step_mod
    from depth_lidar_nerf_tpu_torch.train.state import init_train_state
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    _build.build_all([fmt.KERNEL, fmt.BWD_KERNEL, sc.KERNEL])
    for name, types in ((fmt.KERNEL, fmt.ARGTYPES),
                        (fmt.BWD_KERNEL, fmt.BWD_ARGTYPES),
                        (sc.KERNEL, sc.ARGTYPES)):
        _build.load(name, types)

    def plain_sampler(bins, weights, n, *, det=False, generator=None):
        u = sampling.pdf_uniforms(bins.shape[0], n, det=det,
                                  generator=generator, device=bins.device)
        return sc.inverse_cdf_plain(bins, weights, u)

    fused_mul_add = lambda a, b, c: (  # noqa: E731
        a.double() * b.double() + c.double()).float()
    patches = ([mock.patch.object(sampling, "_mul_add", fused_mul_add)]
               if args.fused else [])
    with contextlib.ExitStack() as outer:
        for p in patches:
            outer.enter_context(p)
        for seed in args.seeds:
            losses = {}
            for plain in (False, True):
                cfg, rcfg, models, tables, scene = cs.bench_stack(
                    dev, cs.TRAJ_N_RAYS, "float32", fused=not plain)
                state = init_train_state(cfg, models)
                step = make_train_step(cfg, rcfg, models, scene.hwf)
                gen = torch.Generator(device=dev).manual_seed(seed)
                with contextlib.ExitStack() as ctx:
                    if plain:
                        for mod in (renderer, step_mod):
                            ctx.enter_context(mock.patch.object(
                                mod, "sample_pdf_cuda", plain_sampler))
                    losses[plain] = np.array(
                        [step(state, *tables, gen)["loss"].item()
                         for _ in range(5)])
            gap = np.abs(losses[False] - losses[True]) / np.abs(losses[True])
            print(f"{'fused' if args.fused else 'port'} seed {seed}: per-step "
                  "relative loss gap " + " ".join(f"{g:.3g}" for g in gap)
                  + f"; max {gap.max():.3g} (TRAJ_TOL {cs.TRAJ_TOL['float32'][0]:g})",
                  flush=True)


if __name__ == "__main__":
    main()
