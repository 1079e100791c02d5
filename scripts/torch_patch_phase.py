"""Build the kernels and run ``chip_smoke.py``'s phases 14 and 15 alone, on
the card: the KITTI patch iteration, LPIPS and ``patch_ng_int8``, the grid
patch step (14a-c, ``patch``), the flagship driver (14d, ``flagship``), the
GAN iteration (15a, ``gan``), the GAN driver (15b, ``gan_driver``), and the
frozen-alpha fine-tunes and single-image batching (15c, ``alpha``; 15d,
``no_batching``), which train their source run first: phase 12's stack and
scene, ``--source_steps`` steps (default 100).

    python scripts/torch_patch_phase.py [patch] [flagship] [gan] \
        [gan_driver] [alpha] [no_batching] [--source_steps N]

The phase's own checks apply; it prints the phase's lines and one JSON
line of its numbers.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv):
    import torch

    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.ops import _build
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as fmt
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as sc
    from depth_lidar_nerf_tpu_torch.ops.sampling import pdf_uniforms
    from depth_lidar_nerf_tpu_torch.render import renderer

    if not torch.cuda.is_available():
        sys.exit("torch_patch_phase: no CUDA device")
    # As chip_smoke.py: plain versions are references, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    _build.build_all([fmt.KERNEL, fmt.BWD_KERNEL, fmt.Q8_KERNEL, fm.KERNEL,
                      sc.KERNEL])
    for name, types in ((fmt.KERNEL, fmt.ARGTYPES),
                        (fmt.BWD_KERNEL, fmt.BWD_ARGTYPES),
                        (fmt.Q8_KERNEL, fmt.Q8_ARGTYPES),
                        (fm.KERNEL, fm.ARGTYPES), (sc.KERNEL, sc.ARGTYPES)):
        _build.load(name, types)

    def plain_sampler(bins, weights, n, *, det=False, generator=None):
        u = pdf_uniforms(bins.shape[0], n, det=det, generator=generator,
                         device=bins.device)
        return sc.inverse_cdf_plain(bins, weights, u)

    dev = torch.device("cuda")
    source_steps = 100
    if "--source_steps" in argv:
        i = argv.index("--source_steps")
        source_steps = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    which = argv or ["patch", "flagship"]
    out = {}
    if "patch" in which:
        out["patch"], _ = cs.patch_phase(fmt, sc, renderer, dev, card,
                                         plain_sampler, cs.kernel_fns(),
                                         float("nan"))
    if "flagship" in which:
        out["flagship"], _ = cs.flagship_driver_phase(fmt, sc, dev, card,
                                                      cs.kernel_fns())
    if "gan" in which:
        out["gan"], _ = cs.gan_phase(fmt, sc, renderer, dev, card,
                                     plain_sampler, cs.kernel_fns())
    if "gan_driver" in which:
        out["gan_driver"], _ = cs.gan_driver_phase(fmt, sc, dev, card,
                                                   cs.kernel_fns())
    if "alpha" in which or "no_batching" in which:
        import tempfile

        from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene
        from depth_lidar_nerf_tpu_torch.train.config import parse_args

        tmp = tempfile.TemporaryDirectory(prefix="torch_patch_phase_")
        make_scene(os.path.join(tmp.name, "scene"), n_images=cs.DRIVER_VIEWS,
                   H=cs.H, W=cs.W, focal=cs.FOCAL,
                   n_depth_points=cs.DRIVER_DEPTH_POINTS, backdrop=True)
        cfg = parse_args(cs.driver_argv(tmp.name, "fresh", source_steps))
        cs.driver_run(cfg)
        kept = (tmp, cfg)
        if "alpha" in which:
            out["alpha"], _ = cs.alpha_phase(fmt, sc, dev, card,
                                             cs.kernel_fns(), kept)
        if "no_batching" in which:
            out["no_batching"], _ = cs.no_batching_phase(
                fmt, sc, dev, card, cs.kernel_fns(), kept,
                float("nan"))
        tmp.cleanup()
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main(sys.argv[1:])
