"""Build the kernels and run ``chip_smoke.py``'s phase 14 alone: the KITTI
patch iteration, LPIPS and ``patch_ng_int8``, the grid patch step (14a-c,
``patch``) and the flagship driver (14d, ``flagship``), on the card.

    python scripts/torch_patch_phase.py [patch] [flagship]

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
    which = argv or ["patch", "flagship"]
    out = {}
    if "patch" in which:
        out["patch"], _ = cs.patch_phase(fmt, sc, renderer, dev, card,
                                         plain_sampler, cs.kernel_fns(fmt, sc),
                                         float("nan"))
    if "flagship" in which:
        out["flagship"], _ = cs.flagship_driver_phase(fmt, sc, dev, card,
                                                      cs.kernel_fns(fmt, sc))
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main(sys.argv[1:])
