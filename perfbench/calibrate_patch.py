"""Read what the limits of a patch cell's correctness check are set from:
the plain float32 reference against itself under each control and fault,
at the cell's own size, over many seeds in one process.

    python3 perfbench/calibrate_patch.py --workload <name> --seeds 1 2 3 ... \
        [--sides ...] [--out F]

Sides (``yardstick/reference_patch.py``): ``control`` (the MLPs'
operands rounded to float8 e4m3, the precision below bfloat16),
``vgg_bf16`` (VGG19's operands rounded to bfloat16, below the TF32 the
configuration states) and ``fault:<name>`` for each of
``reference_patch.FAULTS``; the ``program`` side (a sound run's checked
steps, and its last step again from the reference's state before it, as a
run reads them) is read on every seed. Every side's last step's gradient
and terms are taken at the plain reference's parameters before that
step. Each reading is
printed as a JSON line and, with ``--out``, written to that file.
(``calibrate.py`` reads the base training and serving cells.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SIDES = (["control", "vgg_bf16"]
         + [f"fault:{f}" for f in ("no_feature", "no_feature0", "no_smooth",
                                   "grad_shifted", "unchanged", "no_depth",
                                   "half_batch")])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    ap.add_argument("--sides", nargs="+", default=SIDES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE.parent))
    import run

    os.environ.update(run.cache_dirs(HERE.parent))
    import torch

    from yardstick import (cell, check_patch, reference, reference_patch,
                           run_common, train_patch)

    bench = cell.load_benchmark(HERE.parent)
    w = cell.workload(bench, args.workload)
    config = cell.config(bench, w["config"], HERE.parent)
    traffic = cell.traffic(w["traffic"], HERE.parent)
    plain = cell.plain(config)
    n = traffic["checked_steps"]
    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    variants = {"reference": {}}
    for side in args.sides:
        if side == "control":
            variants[side] = {"mm_dtype": reference.fp8()}
        elif side == "vgg_bf16":
            variants[side] = {"vgg_dtype": torch.bfloat16}
        elif side.startswith("fault:"):
            variants[side] = {"fault": side.split(":", 1)[1]}
    lines = []

    def emit(d):
        d = dict(d, workload=args.workload)
        print(json.dumps(d), flush=True)
        lines.append(d)

    for seed in args.seeds:
        t = time.time()
        spec = run_common.RunSpec(args.workload, config, plain, traffic, seed,
                                  0.0, False, t, args.device)
        sess = train_patch.PatchSession(spec, dev)
        prog = sess.first_steps(n)
        vgg = sess.vgg
        got, before = reference_patch.train_steps(plain, sess.data, sess.init, vgg,
                                                  seed, n, traffic["check_block_rays"],
                                                  sess.ng_tile, variants)
        ref = got.pop("reference")
        got["program"] = sess.step_at(prog, before, n)
        ng_tile = sess.ng_tile
        sess.free()
        for side, r in got.items():
            emit({"seed": seed, "side": side,
                  **check_patch.numbers(r, ref, vgg, plain["vgg_layers"])})
        emit({"seed": seed, "side": "seconds", "value": time.time() - t,
              "ng_tile": ng_tile})
        del got, ref, before, sess
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(d) + "\n" for d in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
