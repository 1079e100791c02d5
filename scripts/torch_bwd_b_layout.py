"""Phase 1 of kernel 5's split backward with its tensor-core B operand read
two ways.

The chain's input products (``tc_mac_in`` in csrc/fused_nerf_bwd.cu) read
their B operand from ``pack_params``' ``weights_ip``: the ``[in, out]``
weights with each 16-k run of a row permuted as ``fused_mlp_t.TC_KPERM``,
so that a lane reads its four bfloat16 values of a k-step (k = 2t, 2t + 1,
2t + 8, 2t + 9) as one 8-byte load. This script times phase 1
(``fused_mlp_t.fused_nerf_bwd_chain``, every chunk) as it is and with a
variant of the source whose lane reads the four as two 4-byte loads from the
natural ``[in, out]`` rows (``weights``), over the ``two_mlp`` step's fine
pass (D=4, W=256, 16,384 rays x 128 samples, bfloat16, seeded weights and
cotangent), in the order permuted, natural, natural, permuted, each run in a
process of its own (two builds of one source loaded into one process may
launch each other's kernels), and checks that both write the same
cotangents bit for bit. Needs an NVIDIA GPU and ``nvcc``::

    python scripts/torch_bwd_b_layout.py
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH, WIDTH, N_RAYS, S = 4, 256, 16384, 128
ROUTES = ("permuted rows, one 8-byte load", "natural rows, two 4-byte loads")

# The edits that make the variant: two 4-byte loads at 2t and 2t + 8 of the run.
EDITS = (("  const uint2* bp = reinterpret_cast<const uint2*>(w + (size_t)(n0 + g) * ldk) + t;",
          "  const unsigned* bp = reinterpret_cast<const unsigned*>(w + (size_t)(n0 + g) * ldk)"
          " + t;"),
         ("  for (int nt = 0; nt < NT; ++nt) b[nt] = __ldg(bp + (size_t)nt * 2 * ldk);",
          "  for (int nt = 0; nt < NT; ++nt)\n"
          "    b[nt] = make_uint2(__ldg(bp + (size_t)nt * 4 * ldk),"
          " __ldg(bp + (size_t)nt * 4 * ldk + 4));"),
         ("    for (int nt = 0; nt < NT; ++nt) bn[nt] = __ldg(bp + (size_t)nt * 2 * ldk + kn / 4);",
          "    for (int nt = 0; nt < NT; ++nt)\n"
          "      bn[nt] = make_uint2(__ldg(bp + (size_t)nt * 4 * ldk + kn / 2),"
          " __ldg(bp + (size_t)nt * 4 * ldk + kn / 2 + 4));"))


def variant_lib(_build, f):
    """The backward's library built from the edited source, bound as
    ``_build.load`` binds the original."""
    src = (_build.CSRC / "fused_nerf_bwd.cu").read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"the source no longer has: {old.strip()}")
        src = src.replace(old, new)
    d = _build.BUILD_DIR / "b_layout"
    d.mkdir(parents=True, exist_ok=True)
    cu, so = d / "fused_nerf_bwd.cu", d / "libfused_nerf_bwd_natural.so"
    cu.write_text(src)
    cmd = _build._command("fused_nerf_bwd", so)
    cmd[-1:] = ["-I", str(_build.CSRC), str(cu)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for fn, types in f.BWD_ARGTYPES.items():
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = list(types)
    lib.fused_nerf_bwd_error_string.restype = ctypes.c_char_p
    lib.fused_nerf_bwd_error_string.argtypes = [ctypes.c_int]
    return lib


def run_route(route: int) -> dict:
    """Phase 1 over the fine pass through one route: its mean ms over 5
    runs and a digest of the first chunk's cotangents."""
    import hashlib

    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import _build
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as f

    dev = torch.device("cuda")
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(0)
    m = NeRFMLP(depth=DEPTH, width=WIDTH, generator=g).to(dev)
    with torch.no_grad():
        m.sigma.bias += 0.5
    params = {k: v.detach() for k, v in m.named_parameters()}
    rng = np.random.default_rng(0)
    P = N_RAYS * S
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, P)).astype(np.float32)).to(dev)
    vd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(N_RAYS, 3)).astype(np.float32)), dim=-1).T.contiguous().to(dev)
    gt = torch.randn((4, P), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    kw = dict(depth=DEPTH, width=WIDTH, multires=10, multires_views=4, dtype=bf, skips=(4,))
    _, acts = f.fused_nerf_fwd_acts(params, pts, vd, S, **kw)
    pk = f.pack_params(params, DEPTH, bf, dev)
    if route == 1:
        _build._loaded[f.BWD_KERNEL] = variant_lib(_build, f)
        pk = pk._replace(weights_ip=pk.weights)
    chunks = [(c, min(f.BWD_CHUNK, P - c)) for c in range(0, P, f.BWD_CHUNK)]
    stride = -(-(pk.weights.numel() + pk.biases.numel()) // 4) * 4
    part = torch.zeros((f._grid(dev, 1 << 30), stride), device=dev)
    cot = torch.empty((f.cot_numel(f.BWD_CHUNK, DEPTH, WIDTH, 10),), dtype=bf, device=dev)
    first = f.fused_nerf_bwd_chain(params, pts, vd, gt, acts, S, 0, chunks[0][1], part,
                                   packed=pk, **kw)
    digest = hashlib.sha1(first.view(torch.int16).cpu().numpy().tobytes()).hexdigest()

    def chain():
        for c, n in chunks:
            f.fused_nerf_bwd_chain(params, pts, vd, gt, acts, S, c, n, part,
                                   packed=pk, cot=cot, **kw)

    for _ in range(2):
        chain()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        chain()
    end.record()
    torch.cuda.synchronize()
    return {"ms": start.elapsed_time(end) / 5, "cot_sha1": digest, "chunks": len(chunks)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--route", type=int, choices=(0, 1),
                    help="run one route in this process and print its JSON")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_b_layout: needs a CUDA device", file=sys.stderr)
        return 2
    if args.route is not None:
        print(json.dumps(run_route(args.route)))
        return 0
    runs = {r: [] for r in ROUTES}
    for i in (0, 1, 1, 0):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--route", str(i)],
                             capture_output=True, text=True, check=True).stdout
        runs[ROUTES[i]].append(json.loads(out.strip().splitlines()[-1]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    ms = {k: [r["ms"] for r in v] for k, v in runs.items()}
    same = len({r["cot_sha1"] for v in runs.values() for r in v}) == 1
    for k, v in ms.items():
        print(f"phase 1 of kernel 5, B from {k}: {', '.join(f'{x:.3f}' for x in v)} ms "
              f"(two_mlp fine pass, {N_RAYS * S} points, {runs[k][0]['chunks']} chunks) "
              f"on {card}")
    print(f"cotangents of the first chunk bit-identical: {same}")
    print(json.dumps({"card": card, "points": N_RAYS * S, "ms": ms, "cotangents_equal": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
