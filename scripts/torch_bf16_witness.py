"""Accuracy of the port's bfloat16 forward tile against an exact witness.

Runs kernel 4 of the PyTorch port (the forward that saves its activations,
``fused_mlp_t.fused_nerf_fwd_acts``) in bfloat16 on seeded W=256 weights at
the coarse shape (D=4, S=64) and the fine one (D=8 skip@4, S=128), and
prints per layer the share of its activations that round otherwise than the
same layer recomputed in float64 from the kernel's own inputs, beside the
share for float32 products on those inputs
(``fused_mlp_t.bf16_product_witness``). Needs an NVIDIA GPU::

    python scripts/torch_bf16_witness.py

To measure the kernel of another checkout of the port (an earlier commit)
with this checkout's witness, save its activations first::

    python scripts/torch_bf16_witness.py --root OTHER --save acts.pt
    python scripts/torch_bf16_witness.py --acts acts.pt
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((4, 64, ()), (8, 128, (4,)))  # depth, samples a ray, skips
N_RAYS = 256


def inputs(NeRFMLP, depth, S, seed):
    import numpy as np
    import torch

    g = torch.Generator().manual_seed(seed)
    m = NeRFMLP(depth=depth, width=256, generator=g)
    with torch.no_grad():
        m.sigma.bias += 0.5
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, N_RAYS * S)).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(N_RAYS, 3)).astype(np.float32)), dim=-1).T.contiguous()
    return {k: v.detach() for k, v in m.named_parameters()}, pts, vd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose port runs the kernel (default: this one)")
    ap.add_argument("--save", help="write the inputs and activations here and stop")
    ap.add_argument("--acts", help="measure activations saved by --save")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    saved = torch.load(args.acts) if args.acts else {}
    out = {}
    for depth, S, skips in SHAPES:
        key = f"D={depth} S={S}"
        kw = dict(depth=depth, width=256, multires=10, multires_views=4, skips=skips)
        params, pts, vd, acts = saved.get(key) or (*inputs(NeRFMLP, depth, S, depth * S),
                                                   None)
        params = {k: v.to(dev) for k, v in params.items()}
        pts, vd = pts.to(dev), vd.to(dev)
        if acts is None:
            _, acts = f.fused_nerf_fwd_acts(params, pts, vd, S, dtype=torch.bfloat16, **kw)
        if args.save:
            out[key] = ({k: v.cpu() for k, v in params.items()}, pts.cpu(), vd.cpu(),
                        acts.cpu())
            continue
        out[key] = f.bf16_product_witness(params, pts, vd, acts.to(dev), S, **kw)
        print(f"{key} P={pts.shape[1]}: share of bfloat16 activations off the float64 "
              "witness per layer (trunk.., feature, view): kernel "
              + " ".join(f"{x:.3g}" for x in out[key]["kernel"]) + "; float32 products "
              + " ".join(f"{x:.3g}" for x in out[key]["float32"]), flush=True)
    if args.save:
        torch.save(out, args.save)
        return 0
    print(json.dumps({"bf16_product_witness": out,
                      "source": args.acts or os.path.abspath(args.root)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
