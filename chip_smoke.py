#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Run from the root of a checkout. It imports nothing of JAX. Phases, each of
which raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build both CUDA kernels from ``depth_lidar_nerf_tpu_torch/csrc`` with
   nvcc for ``sm_90a``, in parallel;
3. each kernel against its plain PyTorch version on the card: the fused
   NeRF MLP forward at W=256 (coarse D=4, fine D=8 skip@4; float32 and
   bfloat16; S=64 and 128; 4,096 rays and the serving tiles of 32,768 and
   320 rays) and inverse-CDF sampling at N=33,088, B=63, V=64
   (deterministic and random draws);
4. serving: ``configs/rgb_only.txt`` as shipped, at full width in bfloat16,
   seeded weights with scaled heads, ``render_path`` over 3 spiral poses of
   94 x 352 (focal 88). Asserts finite outputs of the right shapes and the
   launch counts of both kernels, prints ms/frame and rays/s, and profiles
   one frame (device time by kernel, busy share). Then, on a sparser field
   whose opacity spreads across the frame, renders frame 0 through the
   kernels and through the plain versions (bfloat16, and float32 for scale)
   and compares;
5. each kernel's time at the serving shapes beside its plain version's and
   its bound, as one ``{"kernels": [...]}`` JSON line (and kernel 1's time
   with float32 operands, printed).

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
H, W, FOCAL = 94, 352, 88.0  # the flagship frame (scripts/flagship_quality.py)
N_FRAMES = 3
# Served field: seeded weights with the density head scaled and offset and
# the colour head scaled (phase 4); the frame comparison lowers the density
# offset further.
SIGMA_SCALE, SIGMA_OFFSET, RGB_SCALE = 50.0, -2.0, 30.0
COMPARE_OFFSET = -5.0
# Frame 0, kernel path against plain path, per map: max and mean abs in
# float32; mean abs in bfloat16.
# Each is about 3x the gap measured on an H100 (PERF.md); in bfloat16 it also
# stays below the gap between the plain path in bfloat16 and in float32.
F32_TOL_MAX, F32_TOL_MEAN, BF16_TOL_MEAN = 3e-3, 1e-6, 2.5e-3
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bytes/s and FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds per call, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mlp_macs(depth, width, e_p, e_v, live_skips, S):
    """Multiply-adds per point of the fused forward (per-ray view term
    spread over the ray's S points)."""
    m = e_p * width + (depth - 1) * width * width + len(live_skips) * e_p * width
    m += width + width * width + width * (width // 2) + (width // 2) * 3
    return m + e_v * (width // 2) / S


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "depth_lidar_nerf_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    # Plain versions are references: full float32 products, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from depth_lidar_nerf_tpu_torch.data.poses import generate_render_path
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.ops import _build
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as fmt
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as sc
    from depth_lidar_nerf_tpu_torch.ops.sampling import pdf_uniforms
    from depth_lidar_nerf_tpu_torch.render import renderer
    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train.config import (parse_args,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.loop import render_path
    from depth_lidar_nerf_tpu_torch.train.state import build_models

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {kind}", flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.time()
    logs = _build.build_all([fmt.KERNEL, sc.KERNEL])
    for mod in (fmt, sc):
        _build.load(mod.KERNEL, mod.ARGTYPES)
    print(f"build: {time.time() - t0:.1f} s (nvcc {' '.join(_build.ARCH_FLAGS)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 3. kernels against their plain versions ----------------------------
    # Kernel 1 at 4,096 rays and at the serving path's own tiles of a
    # 94 x 352 frame: 32,768 rays (chunk) and the ragged 320.
    err = {fmt.KERNEL: 0.0, sc.KERNEL: 0.0}
    rng = np.random.default_rng(0)
    for depth in (4, 8):
        gen = torch.Generator().manual_seed(depth)
        params = {k: v.detach() for k, v in
                  NeRFMLP(depth=depth, width=256, generator=gen)
                  .to(dev).named_parameters()}
        for S in (64, 128):
            for n_rays in (4096, 32768, H * W - 32768):
                pts = torch.from_numpy(rng.uniform(
                    -1, 1, (3, n_rays * S)).astype(np.float32)).to(dev)
                vd = torch.nn.functional.normalize(torch.from_numpy(
                    rng.normal(size=(n_rays, 3)).astype(np.float32)),
                    dim=-1).T.to(dev)
                for dtype, rel in ((torch.float32, 1e-4),
                                   (torch.bfloat16, 2e-2)):
                    kw = dict(depth=depth, width=256, multires=10,
                              multires_views=4, dtype=dtype, skips=(4,))
                    got = fmt.fused_nerf_fwd(params, pts, vd, S, **kw)
                    torch.cuda.synchronize()
                    ref = fmt.fused_nerf_fwd_plain(params, pts, vd, S, **kw)
                    e = (got - ref).abs().max().item()
                    scale = ref.abs().max().item()
                    del got, ref
                    print(f"kernel fused_nerf_fwd D={depth} S={S} N={n_rays} "
                          f"{str(dtype)[6:]}: max abs err {e:.3g}, scale "
                          f"{scale:.3g}, tolerance {rel:g} x scale")
                    check(np.isfinite(e) and e <= rel * scale,
                          f"fused_nerf_fwd D={depth} S={S} N={n_rays} {dtype}")
                    err[fmt.KERNEL] = max(err[fmt.KERNEL], e)
                del pts, vd
    torch.cuda.empty_cache()

    N, B, V = H * W, 63, 64
    g = torch.Generator(device=dev).manual_seed(1)
    bins = torch.sort(torch.rand((N, B), device=dev, generator=g), -1).values
    wts = torch.rand((N, B - 1), device=dev, generator=g) ** 3
    for det in (True, False):
        u = pdf_uniforms(N, V, det=det, generator=g, device=dev)
        got = sc.inverse_cdf(bins, wts, u)
        torch.cuda.synchronize()
        ref = sc.inverse_cdf_plain(bins, wts, u)
        e = (got - ref).abs().max().item()
        # The plain version repeats the kernel's float32 operations in its
        # order, so the two should agree to the last bit.
        print(f"kernel sample_pdf N={N} B={B} V={V} det={det}: "
              f"max abs err {e:.3g}, tolerance 1e-6")
        check(np.isfinite(e) and e <= 1e-6, f"sample_pdf det={det}")
        err[sc.KERNEL] = max(err[sc.KERNEL], e)

    # ---- 4. serving -----------------------------------------------------
    # The config as shipped: on the card both kernels run whatever its
    # use_fused_mlp / use_pallas_sampling say.
    cfg = parse_args(["--config", "configs/rgb_only.txt",
                      "--compute_dtype", "bfloat16"])
    rcfg = render_config_from(cfg, 0, 0.0, 1.0)
    check(rcfg.ndc and cfg.netdepth == 4 and cfg.netdepth_fine == 8
          and cfg.netwidth == cfg.netwidth_fine == 256
          and rcfg.N_samples == rcfg.N_importance == 64, "rgb_only topology")
    models = build_models(cfg, rcfg, device=dev)
    with torch.no_grad():
        # Scaled heads and a density offset make the seeded field vary in
        # density and colour across the frame, with no empty ray (where the
        # reference's disparity is 0/0).
        for m in models:
            m.sigma.weight *= SIGMA_SCALE
            m.sigma.bias += SIGMA_OFFSET
            m.rgb.weight *= RGB_SCALE
    check(models.coarse.supports_rays_path(rcfg)
          and models.fine.supports_rays_path(rcfg), "fused path covers rgb_only")
    base = np.stack([np.concatenate([np.eye(3), [[0.05 * k], [0.02 * k], [0.0]]],
                                    axis=1) for k in range(-2, 3)])
    poses = generate_render_path(base, FOCAL, N_views=30)[:N_FRAMES]
    n_tiles = -(-H * W // rcfg.render_tile(fused=True))

    fmt.fused_nerf_fwd.launches = 0
    sc.inverse_cdf.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    rgbs, disps = render_path(models, poses, (H, W, FOCAL), rcfg, device=dev)
    torch.cuda.synchronize()
    t_first = time.time() - t0
    launches = {fmt.KERNEL: fmt.fused_nerf_fwd.launches,
                sc.KERNEL: sc.inverse_cdf.launches}
    print(f"serving: {N_FRAMES} frames {H}x{W} in {t_first:.3f} s "
          f"(first call included), launches {launches}, tiles/frame {n_tiles}")
    check(rgbs.shape == (N_FRAMES, H, W, 3) and disps.shape == (N_FRAMES, H, W),
          "output shapes")
    check(np.isfinite(rgbs).all() and np.isfinite(disps).all(), "finite outputs")
    check(launches[fmt.KERNEL] == 2 * n_tiles * N_FRAMES, "MLP launch count")
    check(launches[sc.KERNEL] == n_tiles * N_FRAMES, "sampling launch count")

    torch.cuda.synchronize()
    t0 = time.time()
    render_path(models, poses, (H, W, FOCAL), rcfg, device=dev)
    torch.cuda.synchronize()
    ms_frame = (time.time() - t0) * 1e3 / N_FRAMES
    print(f"serving steady: {ms_frame:.1f} ms/frame, "
          f"{H * W * 1e3 / ms_frame:,.0f} rays/s on {card}")

    # One frame under torch.profiler: device time by kernel and busy share.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        render_image(models.coarse, models.fine, H, W, FOCAL, poses[1], rcfg,
                     device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # Kernel events only: an aten op's self device time repeats its kernels'.
    by_name = sorted(((e.self_device_time_total / 1e3, e.key)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    dev_ms = sum(t for t, _ in by_name)
    print(f"profiled frame: wall {wall_ms:.1f} ms, device busy {dev_ms:.1f} ms "
          f"({100 * dev_ms / wall_ms:.1f}%), idle {wall_ms - dev_ms:.1f} ms")
    for t, name in by_name[:8]:
        print(f"  {t:9.3f} ms  {name[:90]}")

    # The kernel path against the plain path on a sparser field, whose
    # opacity spreads across the frame (it leaves a few rays empty, where the
    # reference's disparity is 0/0).
    with torch.no_grad():
        for m in models:
            m.sigma.bias += COMPARE_OFFSET - SIGMA_OFFSET
    # Frame 0 through the kernels and through the plain versions, in float32
    # and in bfloat16, with the same weights. The plain path is plain NeRFMLP
    # modules (built on the CPU, where the config's use_fused_mlp=False is
    # honoured, then moved) and the sampling kernel's twin in place of the
    # renderer's wrapper; neither kernel may launch in it.
    def path_models(dtype, plain):
        pm = build_models(cfg.replace(use_fused_mlp=not plain,
                                      compute_dtype=dtype), rcfg,
                          device="cpu" if plain else dev)
        pm.coarse.load_state_dict(models.coarse.state_dict())
        pm.fine.load_state_dict(models.fine.state_dict())
        return pm.coarse.to(dev), pm.fine.to(dev)

    def plain_sampler(bins, weights, n, *, det=False, generator=None):
        u = pdf_uniforms(bins.shape[0], n, det=det, generator=generator,
                         device=bins.device)
        return sc.inverse_cdf_plain(bins, weights, u)

    dtypes = ("float32", "bfloat16")
    frames = {("kernel", d): render_image(*path_models(d, False), H, W, FOCAL,
                                          poses[0], rcfg, device=dev)
              for d in dtypes}
    n_before = (fmt.fused_nerf_fwd.launches, sc.inverse_cdf.launches)
    with mock.patch.object(renderer, "sample_pdf_cuda", plain_sampler):
        for d in dtypes:
            frames["plain", d] = render_image(*path_models(d, True), H, W,
                                              FOCAL, poses[0], rcfg, device=dev)
    check((fmt.fused_nerf_fwd.launches, sc.inverse_cdf.launches) == n_before,
          "the plain render launched a kernel")
    acc = frames["plain", "float32"]["acc_map"].flatten()
    qs = torch.quantile(acc, torch.tensor([0.0, 0.1, 0.5, 0.9, 1.0],
                                          device=dev)).tolist()
    print("frame 0 acc quantiles 0/10/50/90/100%: "
          + " ".join(f"{q:.3f}" for q in qs)
          + f", share of rays with acc > 0.9999 "
          f"{(acc > 0.9999).float().mean().item():.3f}, empty rays "
          f"{int((acc == 0).sum().item())}")

    def gap(a, b, key):
        d = (frames[a][key].float() - frames[b][key].float()).abs()
        # A ray whose last sample's sigma is near 0 flips between empty and
        # opaque (its interval is 1e10): count such jumps.
        return d.max().item(), d.mean().item(), int((d > 0.1).sum().item())

    render_err = {}
    for key in ("rgb_map", "depth_map", "acc_map"):
        e32 = gap(("kernel", "float32"), ("plain", "float32"), key)
        e16 = gap(("kernel", "bfloat16"), ("plain", "bfloat16"), key)
        low = gap(("plain", "bfloat16"), ("plain", "float32"), key)
        render_err[key] = {"float32": e32, "bfloat16": e16,
                           "plain_bf16_vs_f32": low}
        print(f"frame 0 {key}, kernel vs plain: float32 max abs {e32[0]:.3g} "
              f"mean {e32[1]:.3g} (tolerance max {F32_TOL_MAX:g}, mean "
              f"{F32_TOL_MEAN:g}); bfloat16 max abs {e16[0]:.3g} mean "
              f"{e16[1]:.3g} (tolerance mean {BF16_TOL_MEAN:g}), rays off "
              f"by > 0.1: {e16[2]}; for scale, plain bfloat16 vs plain "
              f"float32 max abs {low[0]:.3g} mean {low[1]:.3g}, rays off by "
              f"> 0.1: {low[2]}")
        check(e32[0] <= F32_TOL_MAX and e32[1] <= F32_TOL_MEAN,
              f"frame 0 {key} kernel vs plain, float32")
        check(e16[1] <= BF16_TOL_MEAN,
              f"frame 0 {key} kernel vs plain, bfloat16")
    del frames

    # ---- 5. kernel times at the serving shapes ----------------------------
    ro = torch.randn((N, 3), device=dev, generator=g)
    vd = torch.nn.functional.normalize(torch.randn((N, 3), device=dev,
                                                   generator=g), dim=-1)
    work = []  # (params, pts_t, S, depth) for the coarse and fine passes
    for m, S in ((models.coarse, rcfg.N_samples),
                 (models.fine, rcfg.N_samples + rcfg.N_importance)):
        z = torch.sort(torch.rand((N, S), device=dev, generator=g), -1).values
        pts = (ro.T[:, :, None] + vd.T[:, :, None] * z[None]).reshape(3, N * S)
        work.append(({k: v.detach() for k, v in m.named_parameters()},
                     pts.contiguous(), S, m.depth))
    vdt = vd.T.contiguous()

    def mlp(fn, dtype=torch.bfloat16):
        # The kernel gets its weights packed once, as on the serving path.
        packs = [fmt.pack_params(params, depth, dtype, dev)
                 if fn is fmt.fused_nerf_fwd else None
                 for params, _, _, depth in work]

        def run():
            for (params, pts, S, depth), packed in zip(work, packs):
                kw = {} if packed is None else {"packed": packed}
                fn(params, pts, vdt, S, depth=depth, width=256, multires=10,
                   multires_views=4, dtype=dtype, skips=(4,), **kw)
        return run

    with torch.no_grad():
        mlp_ms = cuda_ms(mlp(fmt.fused_nerf_fwd), reps=5)
        mlp_plain_ms = cuda_ms(mlp(fmt.fused_nerf_fwd_plain), reps=3, warmup=1)
        mlp_f32_ms = cuda_ms(mlp(fmt.fused_nerf_fwd, torch.float32), reps=3,
                             warmup=1)
    print(f"fused_nerf_fwd per frame in float32 operands: {mlp_f32_ms:.3f} ms")
    flops = bytes_ = 0
    for params, pts, S, depth in work:
        n_w = sum(v.numel() for v in params.values())
        flops += 2 * mlp_macs(depth, 256, 63, 27,
                              fmt.live_skips(depth, (4,)), S) * N * S
        bytes_ += (3 * N * S + 3 * N + 4 * N * S) * 4 + n_w * 2
    mlp_bound = max(bytes_ / PEAK_BYTES, flops / PEAK_FLOPS["bfloat16"]) * 1e3
    mlp_by = "operations" if flops / PEAK_FLOPS["bfloat16"] > \
        bytes_ / PEAK_BYTES else "bytes"
    print(f"fused_nerf_fwd per frame (coarse + fine, bf16): {mlp_ms:.3f} ms, "
          f"plain {mlp_plain_ms:.3f} ms, {flops / mlp_ms / 1e9:.1f} TFLOP/s, "
          f"bound {mlp_bound:.3f} ms ({mlp_by}) on {card}")

    u = pdf_uniforms(N, V, det=False, generator=g, device=dev)
    sp_ms = cuda_ms(lambda: sc.inverse_cdf(bins, wts, u), reps=50)
    sp_plain_ms = cuda_ms(lambda: sc.inverse_cdf_plain(bins, wts, u), reps=20)
    sp_bytes = (N * B + N * (B - 1) + 2 * N * V) * 4
    sp_bound = sp_bytes / PEAK_BYTES * 1e3
    print(f"sample_pdf per frame: {sp_ms:.4f} ms, plain {sp_plain_ms:.4f} ms, "
          f"bound {sp_bound:.4f} ms (bytes) on {card}")

    kernels = [
        {"name": fmt.KERNEL, "route": "cuda",
         "source": "depth_lidar_nerf_tpu_torch/csrc/fused_nerf_fwd.cu",
         "replaces": "depth_lidar_nerf_tpu/ops/fused_mlp_t.py:249",
         "launches": launches[fmt.KERNEL], "max_abs_err": err[fmt.KERNEL],
         "ms": mlp_ms, "plain_ms": mlp_plain_ms, "bound_ms": mlp_bound,
         "bound_by": mlp_by, "library_ms": None},
        {"name": sc.KERNEL, "route": "cuda",
         "source": "depth_lidar_nerf_tpu_torch/csrc/sample_pdf.cu",
         "replaces": "depth_lidar_nerf_tpu/ops/sampling_pallas.py:41",
         "launches": launches[sc.KERNEL], "max_abs_err": err[sc.KERNEL],
         "ms": sp_ms, "plain_ms": sp_plain_ms, "bound_ms": sp_bound,
         "bound_by": "bytes", "library_ms": None},
    ]
    print(json.dumps({"serving": {"ms_per_frame": ms_frame,
                                  "rays_per_s": H * W * 1e3 / ms_frame,
                                  "frame0_kernel_vs_plain": render_err,
                                  "card": card}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
