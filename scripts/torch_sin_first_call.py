"""How often a process's first float32 ``sin`` on the CPU comes back wrong.

Each of ``--runs`` fresh processes (8 at a time) runs JAX's jitted
positional encoding, as a test worker would, then the port's
``ops/embedding.py:positional_encoding`` twice on the inputs of
``tests/test_torch_port_packed_mlp_f32.py::test_pack_encoding_bitwise``
(``raw_inputs(20, 64, seed=3)`` padded to 32 rays, multires 10), with
``--warm`` after one ``sin`` and ``cos`` of 8 zeros on one thread. It counts
the calls whose result differs from the most common one and prints their
largest gap to JAX's encoding. torch's CPU ``sin`` calls MKL's vector math
slice by slice over the OpenMP threads.

    python scripts/torch_sin_first_call.py [--runs 160] [--warm]
        [--capability default]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import hashlib, json, os, sys
sys.path.insert(0, ROOT)
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import torch
from depth_lidar_nerf_tpu.ops.embedding import positional_encoding as jpe
from depth_lidar_nerf_tpu_torch.ops.embedding import positional_encoding
# tests/torch_port_packed_helpers.py:raw_inputs(20, 64, seed=3), whose
# module's import would make the one-thread call itself.
pts = np.random.default_rng(3).uniform(-1.5, 1.5, (20, 64, 3)).astype(np.float32)
x = np.pad(pts, ((0, 12), (0, 0), (0, 0)))
ref = np.asarray(jax.jit(jpe, static_argnums=1)(jnp.asarray(x), 10))
if WARM:
    torch.sin(torch.zeros(8)); torch.cos(torch.zeros(8))
out = []
for _ in range(2):
    got = positional_encoding(torch.from_numpy(x), 10).numpy()
    out.append([hashlib.md5(got.tobytes()).hexdigest()[:8],
                float(np.abs(got.astype(np.float64) - ref).max())])
print(json.dumps(out))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=160)
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--capability", default=None,
                    help="ATEN_CPU_CAPABILITY for the processes")
    args = ap.parse_args()
    env = dict(os.environ)
    if args.capability:
        env["ATEN_CPU_CAPABILITY"] = args.capability
    code = CHILD.replace("ROOT", repr(ROOT)).replace("WARM", repr(args.warm))
    results = []
    for start in range(0, args.runs, 8):
        procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.DEVNULL, text=True)
                 for _ in range(min(8, args.runs - start))]
        for p in procs:
            out, _ = p.communicate(timeout=600)
            results.append(json.loads(out.strip().splitlines()[-1]))
    steady = collections.Counter(r[1][0] for r in results).most_common(1)[0][0]
    for call in (0, 1):
        odd = [r[call] for r in results if r[call][0] != steady]
        print(f"call {call + 1}: {len(odd)} of {len(results)} differ from the "
              f"common result; largest gap to JAX "
              f"{max((g for _, g in odd), default=0.0):.3g} (common result's "
              f"{max(r[call][1] for r in results if r[call][0] == steady):.3g})")


if __name__ == "__main__":
    main()
