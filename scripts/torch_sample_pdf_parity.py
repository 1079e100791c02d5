"""Kernel 14 (inverse-CDF sampling) of two checkouts of the port: float32
output bit for bit, and, with ``--time``, each checkout's times.

Runs ``sampling_cuda.inverse_cdf`` at the card tests' shapes (every N of
``chip_smoke.SAMPLE_PDF_NS`` x B of ``SAMPLE_PDF_BS`` x V of
``SAMPLE_PDF_VS``, deterministic and random draws, in the renderer's layout:
the weights a slice with row stride B + 1, det's draws an ``expand`` with
row stride 0), and at V = 64 with draws u = 1 where the sequential CDF ends
above 1.0 (``sample_pdf_inputs(..., u_one=True)``), and compares the outputs
with those another checkout saved, element by element. Needs an NVIDIA GPU::

    python scripts/torch_sample_pdf_parity.py --root OTHER --save build/pdf.pt --time
    python scripts/torch_sample_pdf_parity.py --against build/pdf.pt --time

Each checkout runs in its own process: two builds of one source loaded into
one process may launch each other's kernels. The inputs come from this
checkout's ``chip_smoke.sample_pdf_inputs`` in both runs. ``--time`` prints
``chip_smoke.sample_pdf_times`` of the checkout's wrapper for a 94 x 352
frame (tiles of 32,768 and 320 rays, det) and a training step (16,384 rays,
random draws), B = 63, V = 64, as a ``{"sample_pdf_times": ...}`` line. A
``{"sample_pdf_parity": ...}`` summary comes last; exits 1 if ``--against``
found a difference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cases(cs):
    """(key, N, B, V, det, u_one) of every case."""
    for N in cs.SAMPLE_PDF_NS:
        for B in cs.SAMPLE_PDF_BS:
            for V in cs.SAMPLE_PDF_VS:
                for det in (True, False):
                    yield f"N={N} B={B} V={V} det={det}", N, B, V, det, False
            if B > 2:
                for det in (True, False):
                    yield f"N={N} B={B} V=64 det={det} u=1", N, B, 64, det, True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose port runs the kernel (default: this one)")
    ap.add_argument("--save", help="write the outputs here")
    ap.add_argument("--against", help="compare with outputs written by --save")
    ap.add_argument("--time", action="store_true",
                    help="also time the kernel at a frame's and a step's shapes")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke as cs  # the inputs and the timing: this checkout's

    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("depth_lidar_nerf_tpu_torch")]:
        del sys.modules[name]
    import torch

    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as sc

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    assert sc.__file__.startswith(os.path.abspath(args.root)), sc.__file__
    dev = torch.device("cuda")
    ref = torch.load(args.against) if args.against else None
    saved, summary = {}, {}
    for key, N, B, V, det, u_one in cases(cs):
        bins, w, u = cs.sample_pdf_inputs(dev, N, B, V, det, "renderer",
                                          seed=N + B + V + det, u_one=u_one)
        n0 = sc.inverse_cdf.launches
        out = sc.inverse_cdf(bins, w, u)
        torch.cuda.synchronize()
        assert sc.inverse_cdf.launches == n0 + 1, "the kernel did not launch"
        out = out.cpu()
        if args.save:
            saved[key] = out
        if ref is not None:
            want = ref[key]
            d = (out.double() - want.double()).abs()
            summary[key] = {"equal": bool(torch.equal(out, want)),
                            "n_diff": int((out != want).sum()),
                            "max_abs_diff": float(d.max())}
            if not summary[key]["equal"]:
                print(f"{key}: DIFFERS ({summary[key]['n_diff']} elements, max "
                      f"{summary[key]['max_abs_diff']:.3g})", flush=True)
    if args.time:
        card = cs.card_line()
        times = {}
        for label, tiles, det in (("frame", (32768, cs.H * cs.W - 32768), True),
                                  ("step", (cs.TRAIN_N_RAYS,), False)):
            n = sum(tiles)
            sets = cs.sample_pdf_sets(dev, tiles, det)
            t = cs.sample_pdf_times(sc, sets)
            t["bound_ms"] = cs.sample_pdf_bound_ms(sets[0])
            times[label] = t
            print(f"{label} ({n} rays): device {t['device_ms']:.5f} ms by "
                  f"{t['device_by']} (every "
                  f"kernel {t['device_all_ms']:.5f}), events {t['events_ms']:.5f} "
                  f"ms, host {t['host_us_per_call']:.2f} us a call, plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms on {card}",
                  flush=True)
        print(json.dumps({"sample_pdf_times": {"root": os.path.abspath(args.root),
                                               "card": card, **times}}))
    if args.save:
        torch.save(saved, args.save)
        print(f"saved {len(saved)} cases to {args.save}")
    if ref is not None:
        n_equal = sum(r["equal"] for r in summary.values())
        print(json.dumps({"sample_pdf_parity": {
            "cases": len(summary), "equal": n_equal,
            "differ": [k for k, r in summary.items() if not r["equal"]]}}))
        return 0 if n_equal == len(summary) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
