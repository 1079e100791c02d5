"""Is the port's patch iteration reproducible run to run on the card?

Runs the KITTI patch stack of ``chip_smoke.py`` phase 14 (its
``kitti_stack``: ``configs/kitti360_full.txt`` on the in-memory 94x352
scene) twice from one seed for each case, and prints how many parameter
tensors differ between the two copies: base steps, smoothness-only patch
steps, feature-loss patch steps as shipped (``train/step.py`` runs them
under ``torch.backends.cudnn.deterministic``), and feature-loss steps with
that scoped flag taken out (cuDNN's default algorithms).

    python scripts/torch_patch_determinism.py    # on a machine with a card
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    import chip_smoke as cs
    from depth_lidar_nerf_tpu_torch.ops import _build
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as fmt
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as sc
    from depth_lidar_nerf_tpu_torch.train import step as step_mod
    from depth_lidar_nerf_tpu_torch.train.state import init_train_state

    if not torch.cuda.is_available():
        sys.exit("torch_patch_determinism: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all([fmt.KERNEL, fmt.BWD_KERNEL, fmt.Q8_KERNEL, fm.KERNEL,
                      sc.KERNEL])
    for name, types in ((fmt.KERNEL, fmt.ARGTYPES),
                        (fmt.BWD_KERNEL, fmt.BWD_ARGTYPES),
                        (fmt.Q8_KERNEL, fmt.Q8_ARGTYPES),
                        (fm.KERNEL, fm.ARGTYPES), (sc.KERNEL, sc.ARGTYPES)):
        _build.load(name, types)
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)

    def run(variant, n, scoped, root):
        cfg, rcfg, m, tabs, scn, src = cs.kitti_stack(dev, root)
        st = init_train_state(cfg, m)
        with contextlib.ExitStack() as ctx:
            if not scoped:
                ctx.enter_context(mock_attr(step_mod, "_deterministic_cudnn",
                                            contextlib.nullcontext))
            step = step_mod.make_train_step(cfg, rcfg, m, scn.hwf, **variant)
            for i in range(n):
                gen = torch.Generator(device=dev).manual_seed(i)
                step(st, *tabs, gen, patch=src if variant else None)
        torch.cuda.synchronize()
        return cs.net_params(m, clone=True)

    with tempfile.TemporaryDirectory() as root:
        for label, variant, n, scoped in (
                ("base steps", {}, 10, True),
                ("smoothness patch steps", dict(smooth_on=True), 5, True),
                ("feature patch steps, as shipped", dict(feature_on=True), 5,
                 True),
                ("feature patch steps, cuDNN defaults", dict(feature_on=True),
                 5, False)):
            a, b = (run(variant, n, scoped, root) for _ in range(2))
            bad = [k for k in a if not torch.equal(a[k], b[k])]
            print(f"{label} x{n}: {len(bad)} of {len(a)} tensors differ "
                  f"between two runs from one seed {bad[:3]}", flush=True)


@contextlib.contextmanager
def mock_attr(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


if __name__ == "__main__":
    main()
