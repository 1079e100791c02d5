"""Kernel 8's bfloat16 gradients against its float32-product twin and against
a float64 chain.

Runs kernel 7 and kernel 8 of the PyTorch port (``fused_mlp_t``) in bfloat16
on seeded W=256 weights with a 19-class semantic head (chip_smoke.py's
semantic inputs: random biases, 4,096 rays) at the coarse shape (D=4, S=64)
and the fine one (D=8 skip@4, S=128): kernel 8 (its chain's input products
on FMA, in the twin's float32 order) and, given a checkout whose kernel 8
takes another route (``--root``), that one. For the trunk's large gradient
blocks it prints the max abs error over the mean abs of the kernel
and of the twin (``fused_nerf_bwd_acts_sem_plain``) against a float64
chain: every cotangent formed with float64 products of bfloat16 operands and
rounded once to bfloat16, every weight gradient a float64 product of those.
Needs an NVIDIA GPU::

    python scripts/torch_sem_bwd_gap.py [--root OTHER_CHECKOUT]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((4, 64), (8, 128))  # depth, samples a ray (skip@4)
N_RAYS, CLASSES, WIDTH = 4096, 19, 256


def inputs(NeRFMLP, dev, depth, S, seed):
    import numpy as np
    import torch

    g = torch.Generator().manual_seed(seed)
    m = NeRFMLP(depth=depth, width=WIDTH, num_semantic_classes=CLASSES, generator=g)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        m.sigma.bias += 0.5
    params = {k: v.detach().to(dev) for k, v in m.named_parameters()}
    rng = np.random.default_rng(seed)
    P = N_RAYS * S
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, P)).astype(np.float32)).to(dev)
    vd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(N_RAYS, 3)).astype(np.float32)), dim=-1).T.contiguous().to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gt = torch.randn((4, P), device=dev, generator=gen)
    gsem = torch.randn((N_RAYS, CLASSES), device=dev, generator=gen)
    gsem[N_RAYS // 2:] = 0.0
    return params, pts, vd, gt, gsem


def float64_chain(f, params, pts, vd, g, acts, dfeat_ray, S, depth):
    """The trunk's large gradient blocks (``grad_blocks`` names) from
    cotangents each formed with float64 products and rounded once."""
    import torch

    bf = torch.bfloat16
    ls = f.live_skips(depth, (4,))
    P = pts.shape[1]
    w, _ = f._plain_weights(params, bf)
    hs = [a.double() for a in f.split_acts(acts, P, depth, WIDTH)]
    enc, _ = f._plain_encodings(pts, vd, 10, 4, bf)
    enc = enc.double()
    gb = g.float().to(bf).double()

    def lin(x, wl, gate=None, extra=None):
        z = x @ wl.double()
        if extra is not None:
            z = z + extra
        if gate is not None:
            z = torch.where(gate > 0, z, 0.0)
        return z.float().to(bf).double()

    dhv = lin(gb[:3].T, w("rgb"), hs[depth + 1])
    dfeat = lin(dhv, w("views_0")[:, :WIDTH], None,
                dfeat_ray.double().repeat_interleave(S, 0))
    out = {"feature.weight": dfeat.T @ hs[depth - 1],
           "views_0.weight[feat]": dhv.T @ hs[depth]}
    x = lin(dfeat, w("feature"), hs[depth - 1], gb[3][:, None] * w("sigma").double())
    for l in range(depth - 1, -1, -1):
        if l < depth - 1:
            wl = w(f"trunk_{l + 1}")
            x = lin(x, wl[:, 63:] if l in ls else wl, hs[l])
        out[f"trunk_{l}.bias"] = x.sum(0)
        if l == 0:
            out["trunk_0.weight"] = x.T @ enc
        elif (l - 1) in ls:
            out[f"trunk_{l}.weight[enc]"] = x.T @ enc
            out[f"trunk_{l}.weight[trunk]"] = x.T @ hs[l - 1]
        else:
            out[f"trunk_{l}.weight"] = x.T @ hs[l - 1]
    return out


def gaps(got, ref):
    """Per block, max abs error over the mean abs of ``ref``."""
    return {k: ((got[k].double() - r).abs().max() / r.abs().mean()).item()
            for k, r in ref.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose port runs the kernels (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    if not torch.cuda.is_available():
        print("torch_sem_bwd_gap: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    bf = torch.bfloat16
    result = {"root": os.path.abspath(args.root), "card": torch.cuda.get_device_name(0)}
    for depth, S in SHAPES:
        params, pts, vd, g, gsem = inputs(NeRFMLP, dev, depth, S, depth * 100 + S)
        kw = dict(depth=depth, width=WIDTH, multires=10, multires_views=4, dtype=bf,
                  skips=(4,))
        _, acts, _, sem_acts = f.fused_nerf_fwd_acts_sem(params, pts, vd, S, **kw)
        routes = {"kernel": f.fused_nerf_bwd_acts_sem(params, pts, vd, g, gsem, acts,
                                                      sem_acts, S, **kw)}
        twin = f.fused_nerf_bwd_acts_sem_plain(params, pts, vd, g, gsem, acts,
                                               sem_acts, S, **kw)
        _, dfeat_ray = f.sem_head_bwd_plain(gsem, sem_acts, f.pack_sem(params, bf, dev), S)
        exact = float64_chain(f, params, pts, vd, g, acts, dfeat_ray, S, depth)
        blocks = {k: f.grad_blocks(v, depth, WIDTH, 10, (4,))
                  for k, v in {**routes, "twin": twin}.items()}
        shape = {"against float64": {k: gaps(b, exact) for k, b in blocks.items()},
                 "against the twin": {k: gaps(blocks[k], {n: blocks["twin"][n].double()
                                                          for n in exact})
                                      for k in routes}}
        result[f"D={depth} S={S}"] = shape
        for what, per in shape.items():
            for route, e in per.items():
                worst = sorted(e.items(), key=lambda kv: -kv[1])[:3]
                print(f"D={depth} S={S} {route} {what}: worst "
                      + ", ".join(f"{k} {v:.3g}" for k, v in worst), flush=True)
        del acts, routes, twin
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
