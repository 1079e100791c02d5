"""Build the kernels and run ``chip_smoke.py``'s phase 17 (tensor
parallelism) alone, on the card, on phase 12's scene (written first).

    python scripts/torch_tp_phase.py [--rays N] [--probe]

``--rays`` runs 17b at ``N`` rays a step instead of ``TP_N_RAYS`` (PERF.md
records its float32 gaps at 4,096); ``--probe`` first times a gloo
all-gather and all-reduce of CUDA tensors between two ranks on the card
(the transport of 17b-17d). The phase's own checks apply; it prints the
phase's lines and one JSON line of its numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROBE_MIB = (64, 256, 1024)  # the gathered tensor's size, MiB


def probe_rank():
    """Rank of the gloo probe: wall ms of an all-gather (to twice each of
    ``PROBE_MIB``) and of an all-reduce of each, bfloat16 CUDA tensors."""
    import torch
    import torch.distributed as dist

    out = {}
    for mib in PROBE_MIB:
        x = torch.ones(mib * 2**19, dtype=torch.bfloat16, device="cuda")
        parts = [torch.empty_like(x) for _ in range(2)]
        for op in ("all_gather", "all_reduce"):
            run = ((lambda: dist.all_gather(parts, x)) if op == "all_gather"
                   else (lambda: dist.all_reduce(x)))
            run()
            torch.cuda.synchronize()
            t = time.time()
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            out[f"{op} {mib} MiB"] = (time.time() - t) * 1e3 / 3
    return out


def main():
    import tempfile

    import torch

    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene
    from depth_lidar_nerf_tpu_torch.ops import _build
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as fmt
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as sc
    from depth_lidar_nerf_tpu_torch.parallel import distributed as pdist

    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=cs.TP_N_RAYS)
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_tp_phase: no CUDA device")
    # As chip_smoke.py: plain versions are references, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.chdir(ROOT)
    card = cs.card_line()
    print(card, flush=True)
    if args.probe:
        probe = pdist.launch_local(2, probe_rank, device="cuda",
                                   backend="gloo")
        print("gloo on one card, 2 ranks, wall ms: " + json.dumps(probe),
              flush=True)
    _build.build_all([fmt.KERNEL, fmt.BWD_KERNEL, fmt.Q8_KERNEL, fm.KERNEL,
                      sc.KERNEL])
    for name, types in ((fmt.KERNEL, fmt.ARGTYPES),
                        (fmt.BWD_KERNEL, fmt.BWD_ARGTYPES),
                        (fmt.Q8_KERNEL, fmt.Q8_ARGTYPES),
                        (fm.KERNEL, fm.ARGTYPES), (sc.KERNEL, sc.ARGTYPES)):
        _build.load(name, types)
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="torch_tp_phase_")
    make_scene(os.path.join(tmp.name, "scene"), n_images=cs.DRIVER_VIEWS,
               H=cs.H, W=cs.W, focal=cs.FOCAL,
               n_depth_points=cs.DRIVER_DEPTH_POINTS, backdrop=True)
    out, _ = cs.tp_phase(fmt, sc, dev, card, cs.kernel_fns(), (tmp,),
                         n_rays=args.rays)
    tmp.cleanup()
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
