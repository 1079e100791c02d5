"""Where kernel 10's time goes: the int8 tile timed with one part taken out.

Times kernel 10 of the port (``fused_mlp_t.fused_nerf_fwd_q8``, bfloat16,
weights packed once) over the two passes of a 94 x 352 serving frame
(coarse D=4 at 64 samples and fine D=8 skip@4 at 128, W=256, seeded weights
and rays, each pass one launch as in ``chip_smoke.py``'s phase 7), built
from ``csrc/fused_nerf_q8.cu`` as it is and from copies of it with one part
removed:

- ``products``: the int8 mma loops of ``tc_q8_mma`` (their A and B loads
  and the IMMAs);
- ``quantization``: ``quantize_frag`` but for each thread's own maximum
  over its values (which keeps the epilogues live): the shuffles, the
  maxima across warps, the division, the packing, the stores of ``qa``
  and one of its two barriers;
- ``side products``: the bfloat16 first layer and the skip's encoding
  product (``tc_layer``, ``skip_product``);
- ``L2 weight reads``: every k-step of ``tc_q8_mma`` reads the B words of
  its first k-step again, so the int8 weights come from L1 instead of L2.

A variant computes garbage and is timed only; the time a part takes is the
full kernel's less the variant's. Each build runs in a process of its own
(two builds of one source loaded into one process may launch each other's
kernels), the full kernel first and last. Needs an NVIDIA GPU and ``nvcc``::

    python scripts/torch_q8_split.py
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS = 94 * 352
PASSES = ((4, 64), (8, 128))  # (depth, samples a ray): coarse, fine

# The edits that take one part out (each old text must occur exactly once).
VARIANTS = {
    "products": (("  for (int k4 = 0; k4 < K4; k4 += 8) {",
                  "  for (int k4 = 0; k4 < K4 && K4 < 0; k4 += 8) {"),),
    "quantization": (("  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, "
                      "w = threadIdx.x >> 5;",
                      "  if (NT > 0) {\n"
                      "    for (int mt = 0; mt < kMT; ++mt)\n"
                      "      for (int h = 0; h < 2; ++h) {\n"
                      "        float mx = 0.f;\n"
                      "        for (int nt = 0; nt < NT; ++nt)\n"
                      "          mx = fmaxf(mx, fmaxf(fabsf(v[mt][nt][2 * h]), "
                      "fabsf(v[mt][nt][2 * h + 1])));\n"
                      "        ms[mt][h] = mx;\n"
                      "      }\n"
                      "    __syncthreads();\n"
                      "    return;\n"
                      "  }\n"
                      "  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, "
                      "w = threadIdx.x >> 5;"),),
    "side products": (("    tc_layer<W / 64>(b + net.boff[0], s.enc,",
                       "    if (D < 0) tc_layer<W / 64>(b + net.boff[0], s.enc,"),
                      ("  const int e_p = 3 + 6 * net.n_p;\n  if constexpr",
                       "  if (net.depth > 0) return;\n"
                       "  const int e_p = 3 + 6 * net.n_p;\n  if constexpr")),
    "L2 weight reads": (("__ldg(bp + (size_t)kn * N + 8 * nt)", "__ldg(bp + 8 * nt)"),
                        ("__ldg(bp + (size_t)(kn + 4) * N + 8 * nt)",
                         "__ldg(bp + 4 * N + 8 * nt)")),
}


def build_variants(_build) -> dict:
    """Every variant's library, compiled in parallel: {name: path}."""
    src = (_build.CSRC / "fused_nerf_q8.cu").read_text()
    procs, out = [], {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"the source no longer has: {old.strip()}")
            text = text.replace(old, new)
        d = _build.BUILD_DIR / "q8_split"
        d.mkdir(parents=True, exist_ok=True)
        cu, so = d / f"variant{i}.cu", d / f"libfused_nerf_q8_variant{i}.so"
        cu.write_text(text)
        cmd = _build._command("fused_nerf_q8", so)
        cmd[-1:] = ["-I", str(_build.CSRC), str(cu)]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
        out[name] = str(so)
    for name, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
    return out


def run(lib_path: str | None) -> float:
    """Kernel 10 over the frame's two passes: mean ms over 5 runs."""
    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import _build
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    if lib_path:
        lib = ctypes.CDLL(lib_path)
        for fn, types in f.Q8_ARGTYPES.items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = list(types)
        lib.fused_nerf_q8_error_string.restype = ctypes.c_char_p
        lib.fused_nerf_q8_error_string.argtypes = [ctypes.c_int]
        _build._loaded[f.Q8_KERNEL] = lib
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    work = []
    for depth, S in PASSES:
        m = NeRFMLP(depth=depth, width=256, generator=torch.Generator().manual_seed(depth))
        params = {k: v.detach().to(dev) for k, v in m.named_parameters()}
        ro = rng.normal(size=(N_RAYS, 3))
        rd = rng.normal(size=(N_RAYS, 3))
        rd /= np.linalg.norm(rd, axis=1, keepdims=True)
        z = np.sort(rng.uniform(0, 1, (N_RAYS, S)), 1)
        pts = (ro.T[:, :, None] + rd.T[:, :, None] * z[None]).reshape(3, -1)
        work.append((params, torch.from_numpy(pts.astype(np.float32)).to(dev),
                     torch.from_numpy(rd.T.astype(np.float32)).contiguous().to(dev), S, depth,
                     f.pack_params_q8(params, depth, torch.bfloat16, dev, (4,))))

    def frame():
        for params, pts, vd, S, depth, pk in work:
            f.fused_nerf_fwd_q8(params, pts, vd, S, depth=depth, width=256, multires=10,
                                multires_views=4, dtype=torch.bfloat16, skips=(4,), packed=pk)

    with torch.no_grad():
        for _ in range(2):
            frame()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            frame()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", help="time this build in this process and print its ms")
    ap.add_argument("--full", action="store_true", help="time the kernel as it is, likewise")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("torch_q8_split: needs a CUDA device", file=sys.stderr)
        return 2
    if args.lib or args.full:
        print(json.dumps({"ms": run(args.lib)}))
        return 0
    from depth_lidar_nerf_tpu_torch.ops import _build
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    _build.build_all([f.Q8_KERNEL])
    libs = build_variants(_build)

    def timed(extra):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), *extra],
                             capture_output=True, text=True, check=True).stdout
        return json.loads(out.strip().splitlines()[-1])["ms"]

    full = [timed(["--full"])]
    ms = {name: timed(["--lib", path]) for name, path in libs.items()}
    full.append(timed(["--full"]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    base = sum(full) / 2
    print(f"kernel 10, a 94x352 frame (coarse D=4 S=64 + fine D=8 skip@4 S=128, bf16): "
          f"{full[0]:.3f} and {full[1]:.3f} ms as it is, on {card}")
    for name, t in ms.items():
        print(f"  without the {name}: {t:.3f} ms, so they take {base - t:.3f} ms "
              f"({100 * (base - t) / base:.1f}%)")
    print(json.dumps({"card": card, "full_ms": full, "without_ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
