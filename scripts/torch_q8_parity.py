"""Kernels 10 and 11 of two checkouts of the port, bit for bit.

Runs the int8 serving kernels (``fused_mlp_t.fused_nerf_fwd_q8`` and
``fused_nerf_fwd_q8_sem``) on the seeded inputs of ``chip_smoke.py``'s phase
3 (W=256, 19 classes, D=4 and D=8 skip@4, 4,096 and 32,768 rays x S=64 and
128, float32 and bfloat16) and compares their raw and logits with those
that another checkout saved, element by element. Needs an NVIDIA GPU::

    python scripts/torch_q8_parity.py --root OTHER --save q8.pt
    python scripts/torch_q8_parity.py --against q8.pt

Each checkout runs in its own process: two builds of one source loaded into
one process may launch each other's kernels. The inputs come from this
checkout's ``chip_smoke.sem_inputs`` in both runs. Prints one line a case
(equal, or the number of elements that differ and the largest difference)
and a JSON summary last; exits 1 if ``--against`` found a difference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTHS = (4, 8)
SHAPES = ((4096, 64), (4096, 128), (32768, 64), (32768, 128))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose port runs the kernels (default: this one)")
    ap.add_argument("--save", help="write the outputs here")
    ap.add_argument("--against", help="compare with outputs written by --save")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke  # the inputs: this checkout's phase-3 generator

    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("depth_lidar_nerf_tpu_torch")]:
        del sys.modules[name]
    import torch

    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    assert f.__file__.startswith(os.path.abspath(args.root)), f.__file__
    dev = torch.device("cuda")
    ref = torch.load(args.against) if args.against else None
    saved, summary = {}, {}
    for depth in DEPTHS:
        for n_rays, S in SHAPES:
            params, pts, vd, _, _ = chip_smoke.sem_inputs(NeRFMLP, dev, depth, n_rays, S,
                                                          depth * 10 + S)
            trunk = {k: v for k, v in params.items() if not k.startswith("semantic_")}
            for dtype in (torch.float32, torch.bfloat16):
                key = f"D={depth} N={n_rays} S={S} {str(dtype)[6:]}"
                kw = dict(depth=depth, width=256, multires=10, multires_views=4,
                          dtype=dtype, skips=(4,))
                n0 = (f.fused_nerf_fwd_q8.launches, f.fused_nerf_fwd_q8_sem.launches)
                with torch.no_grad():
                    pk = f.pack_params_q8(params, depth, dtype, dev, (4,))
                    raw10 = f.fused_nerf_fwd_q8(trunk, pts, vd, S, packed=pk, **kw)
                    raw11, logits = f.fused_nerf_fwd_q8_sem(params, pts, vd, S, packed=pk,
                                                            **kw)
                    torch.cuda.synchronize()
                assert (f.fused_nerf_fwd_q8.launches, f.fused_nerf_fwd_q8_sem.launches) \
                    == (n0[0] + 1, n0[1] + 1), "a kernel did not launch"
                out = {"raw10": raw10.cpu(), "raw11": raw11.cpu(), "logits": logits.cpu()}
                if args.save:
                    saved[key] = out
                if ref is not None:
                    res = {}
                    for name, got in out.items():
                        want = ref[key][name]
                        d = (got.double() - want.double()).abs()
                        res[name] = {"equal": bool(torch.equal(got, want)),
                                     "n_diff": int((got != want).sum()),
                                     "max_abs_diff": float(d.max())}
                    summary[key] = res
                    print(f"{key}: " + ", ".join(
                        f"{n} {'equal' if r['equal'] else 'DIFFERS'} ({r['n_diff']} "
                        f"elements, max {r['max_abs_diff']:.3g})" for n, r in res.items()),
                        flush=True)
                del raw10, raw11, logits, pk
            del params, trunk, pts, vd
            torch.cuda.empty_cache()
    if args.save:
        torch.save(saved, args.save)
        print(f"saved {len(saved)} cases to {args.save}")
    if ref is not None:
        print(json.dumps({"q8_parity": summary}))
        return 0 if all(r["equal"] for c in summary.values() for r in c.values()) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
