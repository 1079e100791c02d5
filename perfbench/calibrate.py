"""Read what the limits of a cell's correctness check are set from, at the
cell's own size, over many seeds in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 3 ... \
        [--sides ...] [--out F]

Each seed and side gives one reading of every number the check compares
(``yardstick/check.py``) against the plain float32 reference. Training
sides: ``program`` (the configuration's precision: a sound run's set-up
and first steps), ``program_f32`` (the program in float32: the
reference's witness), ``control`` (the reference with its dense layers'
operands rounded to float8 e4m3, the precision below bfloat16),
``control_bf16`` (the same in bfloat16) and the faults planted in the
reference, ``fault:half_batch``, ``fault:unchanged``,
``fault:depth_shifted`` and ``fault:no_depth`` (see
``reference.train_steps``). Serving sides:
``program``, ``control`` (the program's own int8 path, ``render_int8``)
and ``control_fp8`` (the reference with float8 operands). Each reading is
printed as a JSON line and, with ``--out``, written to that file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    ap.add_argument("--sides", nargs="+",
                    default=["program", "control", "fault:half_batch"],
                    help="the readings to take (see above)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE.parent))
    import run

    os.environ.update(run.cache_dirs(HERE.parent))
    import numpy as np
    import torch

    from yardstick import cell, check, reference, run_common

    bench = cell.load_benchmark(HERE.parent)
    w = cell.workload(bench, args.workload)
    config = cell.config(bench, w["config"], HERE.parent)
    traffic = cell.traffic(w["traffic"], HERE.parent)
    if traffic.get("mesh_shape"):
        raise SystemExit("a data-parallel cell's program readings come from its runs")
    lines = []

    def emit(d):
        d = dict(d, workload=args.workload)
        print(json.dumps(d), flush=True)
        lines.append(d)

    for seed in args.seeds:
        t = time.time()
        plain = cell.plain(config)
        spec = run_common.RunSpec(args.workload, config, plain, traffic, seed,
                                  0.0, False, t, args.device)
        dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
        if traffic["kind"] == "train":
            from yardstick import train

            def program(dtype):
                sp = spec._replace(config=dict(config, compute_dtype=dtype))
                sess = train.Session(sp, dev)
                got = sess.first_steps(traffic["checked_steps"])
                data, init, pl = sess.data, sess.init, sess.plain
                sess.free()
                return got, data, init, pl

            prog, data, init, pl = program(config["compute_dtype"])
            kw = dict(n_steps=traffic["checked_steps"],
                      block=traffic["check_block_rays"])
            ref = reference.train_steps(pl, data, init, seed, **kw)
            for side in args.sides:
                if side == "program":
                    got = prog
                elif side == "program_f32":
                    got = program("float32")[0]
                elif side == "control":
                    got = reference.train_steps(pl, data, init, seed,
                                                mm_dtype=reference.fp8(), **kw)
                elif side == "control_bf16":
                    got = reference.train_steps(pl, data, init, seed,
                                                mm_dtype=torch.bfloat16, **kw)
                else:
                    got = reference.train_steps(pl, data, init, seed,
                                                fault=side.split(":", 1)[1], **kw)
                emit({"seed": seed, "side": side,
                      **check.train_numbers(got, ref)})
        else:
            from yardstick import serve

            # As a run checks them: drawn from the seed over the path.
            frames = serve.checked_frames(seed, traffic["poses"],
                                          traffic["checked_frames"])
            got = {}
            for side in args.sides:
                if side == "control_fp8":
                    continue
                srv = serve.Server(spec, dev, render_int8=side == "control")
                got[side] = [srv.frame(f) for f in frames]
                init, poses = srv.init, srv.poses
                srv.free()
            refs = serve.reference_frames(spec, init, poses, frames)
            if "control_fp8" in args.sides:
                got["control_fp8"] = [tuple(x.cpu().numpy() for x in reference.render_frame(
                    plain, init, poses[f], block=traffic["check_block_rays"],
                    mm_dtype=reference.fp8())) for f in frames]
            for side, outs in got.items():
                emit({"seed": seed, "side": side,
                      **check.frame_numbers(outs, refs),
                      "nonfinite": sum(int((~np.isfinite(o[1])).sum()) for o in outs)})
        emit({"seed": seed, "side": "seconds", "value": time.time() - t})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(d) + "\n" for d in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
