"""Where ``chip_smoke.py`` phase 17b's float32 gap comes from: 17b's
one-process plain run against the same run with every layer that a
two-way model split cuts computed as the two model ranks compute it
(``parallel.tensor.column_parallel_linear``'s arithmetic, in one process):
the forward by halves of the output, the input gradient from the whole
weight, the weight and bias gradients by halves (``split``); and the same
with the bias gradient summed over the whole output gradient
(``split_whole_bias``). Run on a machine with a CUDA card, from the
repository root:

    python scripts/torch_tp_split_order.py [--rays 1024 4096]

For each ray count and variant it prints the 5-step float32 loss and
update gaps to the plain run (``chip_smoke.update_gaps``, the measures
17b holds to ``TRAJ_TOL``), then one JSON line of them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def split_dense(whole_bias):
    """``NeRFMLP._dense`` with each layer that ``tp_spec`` splits two ways
    computed by halves, as two model ranks compute it."""
    import torch
    import torch.nn.functional as F

    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.parallel.mesh import tp_spec

    class Split(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, weight, bias):
            n = weight.shape[0] // 2
            ctx.save_for_backward(x, weight)
            return torch.cat([F.linear(x, weight[t * n:(t + 1) * n],
                                       bias[t * n:(t + 1) * n])
                              for t in range(2)], dim=-1)

        @staticmethod
        def backward(ctx, g):
            x, weight = ctx.saved_tensors
            n = weight.shape[0] // 2
            g2 = g.reshape(-1, g.shape[-1])
            x2 = x.reshape(-1, x.shape[-1])
            parts = [g2[:, t * n:(t + 1) * n] for t in range(2)]
            dx = g2.mm(weight).view(x.shape) if ctx.needs_input_grad[0] \
                else None
            dw = torch.cat([p.t().mm(x2) for p in parts])
            db = g2.sum(0) if whole_bias else torch.cat([p.sum(0)
                                                         for p in parts])
            return dx, dw, db

    plain = NeRFMLP._dense

    def dense(self, name, x):
        layer = getattr(self, name)
        if tp_spec(layer.weight.shape, 2) is None:
            return plain(self, name, x)
        return Split.apply(x, layer.weight.to(self.dtype),
                           layer.bias.to(self.dtype))

    return dense


def main():
    import torch

    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import _build
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as sc

    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, nargs="*", default=[1024, 4096])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_tp_split_order: no CUDA device")
    # As chip_smoke.py: plain versions are references, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.chdir(ROOT)
    card = cs.card_line()
    print(card, flush=True)
    _build.build_all([sc.KERNEL])
    _build.load(sc.KERNEL, sc.ARGTYPES)
    dev = torch.device("cuda")

    def last(r):
        return {"metrics": r["metrics"], "state": r["params"][-1]}

    out = {"card": card}
    for n in args.rays:
        plain = cs.tp_run(dev, None, n, "float32", cs.TP_STEPS)
        for variant, whole_bias in (("split", False),
                                    ("split_whole_bias", True)):
            with mock.patch.object(NeRFMLP, "_dense", split_dense(whole_bias)):
                run = cs.tp_run(dev, None, n, "float32", cs.TP_STEPS)
            loss, upd = cs.update_gaps(last(run), last(plain), plain["init"])
            out[f"{n} {variant}"] = {"loss_gap": loss, "update_gap": upd}
            print(f"{n} rays, {variant} against plain, {cs.TP_STEPS} float32 "
                  f"steps: loss gap {loss!r}, update gap {upd!r} on {card}",
                  flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
