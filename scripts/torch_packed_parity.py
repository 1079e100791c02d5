"""Kernels 12 and 13 of two checkouts of the port: float32 bit for bit, and
each bfloat16 kernel's gap to its own twin.

Runs the packed-lane kernels (``fused_mlp.fused_packed_fwd`` and
``fused_packed_bwd``) on the seeded inputs of ``chip_smoke.py``'s phase 3
(W=256, D=4 and D=2, 8,192 rays x S=64 and 1,000 rays x S=8 padded to 1,024,
float32 and bfloat16), and compares their raw output and gradients with
those that another checkout saved, element by element. Needs an NVIDIA GPU::

    python scripts/torch_packed_parity.py --root OTHER --save packed.pt
    python scripts/torch_packed_parity.py --against packed.pt

Each checkout runs in its own process: two builds of one source loaded into
one process may launch each other's kernels. The inputs come from this
checkout's ``chip_smoke.packed_inputs`` in both runs. Prints one line a case:
in float32 whether the two checkouts' outputs are equal (or how many
elements differ and by how much); in bfloat16 each checkout's gap to its own
twin, as PACKED_TOL measures it (raw max over max; gradients max over mean
and mean over mean). A JSON summary comes last; exits 1 if ``--against``
found a float32 difference.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTHS = (4, 2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose port runs the kernels (default: this one)")
    ap.add_argument("--save", help="write the outputs here")
    ap.add_argument("--against", help="compare with outputs written by --save")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke  # the inputs and metrics: this checkout's phase 3

    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("depth_lidar_nerf_tpu_torch")]:
        del sys.modules[name]
    import torch

    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as fmt

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    assert fm.__file__.startswith(os.path.abspath(args.root)), fm.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    # the twins of checkouts before the tensor-core route take no e_p, e_v
    enc = {"e_p": 63, "e_v": 27} \
        if "e_p" in inspect.signature(fm.fused_packed_fwd_plain).parameters else {}
    ref = torch.load(args.against) if args.against else None
    saved, summary = {}, {}
    for depth in DEPTHS:
        for n_rays, S in chip_smoke.PACKED_SHAPES:
            params, pts, vd, gt = chip_smoke.packed_inputs(NeRFMLP, fm, dev, depth,
                                                           n_rays, S)
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype)[6:]
                key = f"D={depth} N={n_rays} S={S} {name}"
                kw = dict(depth=depth, e_p=63, e_v=27, dtype=dtype)
                x = fm.pack_encoding(pts, vd, 10, 4, dtype)
                ws = fm.pack_params(params, depth, 63, 27, dtype, dev)
                n0 = (fm.fused_packed_fwd.launches, fm.fused_packed_bwd.launches)
                with torch.no_grad():
                    raw = fm.fused_packed_fwd(ws, x, **kw)
                    dws = fm.fused_packed_bwd(ws, x, gt, **kw)
                    torch.cuda.synchronize()
                assert (fm.fused_packed_fwd.launches, fm.fused_packed_bwd.launches) \
                    == (n0[0] + 1, n0[1] + 1), "a kernel did not launch"
                out = {"raw": raw.cpu(),
                       "grads": torch.cat([d.reshape(-1) for d in dws]).cpu()}
                twin = fm.fused_packed_fwd_plain(ws, x, depth, dtype, **enc)
                twin_d = fm.fused_packed_bwd_plain(ws, x, gt, depth, dtype, **enc)
                e12, mx, mn, _ = chip_smoke.packed_gaps(fmt, fm, params, depth, raw, twin,
                                                        dws, twin_d)
                out["twin_gap"] = [e12[1], mx, mn]
                if args.save:
                    saved[key] = out
                if ref is not None:
                    res = {"twin_gap": out["twin_gap"],
                           "other_twin_gap": ref[key]["twin_gap"]}
                    for part in ("raw", "grads"):
                        got, want = out[part], ref[key][part]
                        d = (got.double() - want.double()).abs()
                        res[part] = {"equal": bool(torch.equal(got, want)),
                                     "n_diff": int((got != want).sum()),
                                     "max_abs_diff": float(d.max())}
                    summary[key] = res
                    line = ", ".join(
                        f"{p} {'equal' if res[p]['equal'] else 'DIFFERS'} "
                        f"({res[p]['n_diff']} elements, max {res[p]['max_abs_diff']:.3g})"
                        for p in ("raw", "grads"))
                    gaps = " ".join(f"{v:.3g}" for v in out["twin_gap"])
                    other = " ".join(f"{v:.3g}" for v in ref[key]["twin_gap"])
                    print(f"{key}: {line}; gap to its twin (raw, grad max/mean, "
                          f"mean/mean) here {gaps}, other {other} (PACKED_TOL "
                          f"{chip_smoke.PACKED_TOL[name]})", flush=True)
                del raw, dws, twin, twin_d, x, ws
            del params, pts, vd, gt
            torch.cuda.empty_cache()
    if args.save:
        torch.save(saved, args.save)
        print(f"saved {len(saved)} cases to {args.save}")
    if ref is not None:
        print(json.dumps({"packed_parity": summary}))
        f32 = [r for k, r in summary.items() if k.endswith("float32")]
        return 0 if all(r[p]["equal"] for r in f32 for p in ("raw", "grads")) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
