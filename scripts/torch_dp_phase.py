"""Build the kernels and run ``chip_smoke.py``'s phase 16 (ray data
parallelism) alone, on the card: phase 12's runs A (150 steps) and C (300)
on its scene first, which 16c holds the distributed CLI runs against.

    python scripts/torch_dp_phase.py

The phase's own checks apply; it prints the phase's lines and one JSON
line of its numbers.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import tempfile

    import torch

    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene
    from depth_lidar_nerf_tpu_torch.ops import _build
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as fmt
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as sc
    from depth_lidar_nerf_tpu_torch.train.config import parse_args

    if not torch.cuda.is_available():
        sys.exit("torch_dp_phase: no CUDA device")
    # As chip_smoke.py: plain versions are references, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.chdir(ROOT)
    card = cs.card_line()
    print(card, flush=True)
    _build.build_all([fmt.KERNEL, fmt.BWD_KERNEL, fmt.Q8_KERNEL, fm.KERNEL,
                      sc.KERNEL])
    for name, types in ((fmt.KERNEL, fmt.ARGTYPES),
                        (fmt.BWD_KERNEL, fmt.BWD_ARGTYPES),
                        (fmt.Q8_KERNEL, fmt.Q8_ARGTYPES),
                        (fm.KERNEL, fm.ARGTYPES), (sc.KERNEL, sc.ARGTYPES)):
        _build.load(name, types)
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="torch_dp_phase_")
    make_scene(os.path.join(tmp.name, "scene"), n_images=cs.DRIVER_VIEWS,
               H=cs.H, W=cs.W, focal=cs.FOCAL,
               n_depth_points=cs.DRIVER_DEPTH_POINTS, backdrop=True)
    cs.driver_run(parse_args(cs.driver_argv(tmp.name, "resumed",
                                            cs.DRIVER_STEPS[0])))
    cfg = parse_args(cs.driver_argv(tmp.name, "fresh", cs.DRIVER_STEPS[1]))
    cs.driver_run(cfg)
    out = cs.dp_phase(fmt, sc, dev, card, cs.kernel_fns(),
                      float("nan"), (tmp, cfg))
    tmp.cleanup()
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
