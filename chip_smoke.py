#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Run from the root of a checkout. It imports nothing of JAX. Phases, each of
which raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA sources of ``depth_lidar_nerf_tpu_torch/csrc`` with nvcc
   for ``sm_90a``, one nvcc each, in parallel; ``cuobjdump --dump-sass``
   shows tensor-core HMMA instructions in every bfloat16 instantiation of
   the forward tile (kernels 1, 4, 6, 7, 9 and the recompute of 2-3) and
   none in the float32 ones, and integer tensor-core IMMA and no IDP4A in
   every instantiation of the int8 tile (kernels 10, 11), HMMA in its
   bfloat16 ones (the side products) and none in its float32 ones, and HMMA
   in the bfloat16 instantiations of kernel 12 and of kernel 13's chain and
   none in the packed-lane kernels' float32 ones;
3. each kernel against its plain PyTorch version on the card: the fused
   NeRF MLP forward at W=256 (coarse D=4, fine D=8 skip@4; float32 and
   bfloat16; S=64 and 128; 4,096 rays and the serving tiles of 32,768 and
   320 rays) and inverse-CDF sampling at the main path's tiles (32,768,
   320 and 16,384 rays, B=63, V=64; deterministic and random draws;
   contiguous and in the renderer's strided layout; draws u = 1 where the
   sequential CDF ends above 1.0), equal to its twin to the last bit; then
   the training kernels (the
   activation-saving forward, the dense, culled and saved-activation
   backwards) at W=256, D=4 and D=8 skip@4, float32 and bfloat16, 4,096 and
   16,384 rays x S=64 and 128, on cotangents with per-ray zero suffixes
   (the backwards against the plain backward on the forward kernel's
   activations); the culled backward also against the dense one; the
   bfloat16 tile's activations at 4,096 rays against a float64 witness
   (no more rounded the wrong way than by float32 products); the split
   backward of kernel 5 in bfloat16: bit for bit run to run, its cotangents
   against the float64 witness of the backward's products at D=4 S=64 and
   D=8 S=128, and each phase alone against its twin on a fine pass's first
   chunk of 2^18 points (phase 2 on phase 1's cotangents); then the
   semantic kernels (phase 8); then the int8 serving kernels 10 and 11
   (kernel 11 with the semantic head kernel) at W=256, D=4 and D=8 skip@4,
   float32 and bfloat16, 4,096 and 32,768 rays x S=64 and 128, 19 classes,
   on three numbers (max over max, mean over mean, share of elements off by
   more than 1e-5 of the scale); then the packed-lane kernels 12 and 13 at
   W=256, D=4 and D=2, float32 and bfloat16, 8,192 rays x S=64 and 1,000
   rays x S=8 (padded to 1,024), against their twins, and in bfloat16 at
   8,192 x 64 kernel 12's tile and kernel 13's chain against their float64
   witnesses and kernel 13's phase 2 against its twin; then the
   early-terminating forward, kernel 9, on an occluding field (16,384 and
   4,000 rays x 128 samples, scrambled key): live raw equal to kernel 1's
   bit for bit, the twin's skipped blocks, the skipped share, and the
   composited outputs and weight gradients of its route against the dense
   route; so that a faulty kernel stops the run early;
4. serving: ``configs/rgb_only.txt`` as shipped, at full width in bfloat16,
   seeded weights with scaled heads, ``render_path`` over 3 spiral poses of
   94 x 352 (focal 88). Asserts finite outputs of the right shapes and the
   launch counts of both kernels, prints ms/frame and rays/s, and profiles
   one frame (device time by kernel, busy share). Then, on a sparser field
   whose opacity spreads across the frame, renders frame 0 through the
   kernels and through the plain versions (bfloat16, and float32 for scale)
   and compares;
4b. int8 serving: the same config with ``render_int8`` set through
   ``eval_render_config``, 3 frames through ``render_path`` (kernel 10 on
   both passes of each tile, kernel 1 never), ms/frame and rays/s beside
   phase 4's, one profiled frame; frame 0 of the comparison field against
   the bf16 kernel frame (PSNR; rgb mean abs gap within JAX's 0.03); then
   one frame each of ``render_fine_only``, ``render_fine_only`` + int8 and
   ``render_coarse_downsample=2`` + int8, with their launch counts;
5. training: the ``two_mlp`` stack of ``bench.py`` (coarse and fine D=4 /
   W=256, 64 + 64 samples, 16,384 rays half RGB half LiDAR depth,
   ``raw_noise_std`` 1, depth loss 0.01, bfloat16, ``cull_eps`` 1e-4, Adam)
   on the in-memory synthetic scene (4 images of 94 x 352, 8,000 depth
   points each), seeded weights: 5 warm-up steps, 20 timed steps, 3 steps at
   ``cull_eps`` 0. Asserts finite losses, the exact launch counts of every
   kernel, and a falling loss (mean of the last 10 of the first 25 steps
   below the mean of the first 10); prints ms/step and rays/s and profiles
   one step;
5b. sigma-loss training: the same stack with ``sigma_loss`` (lambda 0.1):
   5 warm-up steps, 10 timed. Asserts finite losses, the exact launch counts
   (kernels 12 and 13 once a step beside phase 5's, kernel 13's chain and
   phase 2 once a 2^18-point chunk, one more gradient reduction), that the
   total and the sigma loss fall; prints ms/step and rays/s beside phase
   5's, the device memory of kernel 13's split, and profiles one step;
5c. the early-terminating forward: phase 5's stack with
   ``DLNERF_CULL_FWD=1`` (patched into the environment for this phase
   only): kernels 1 and 9 once a step, kernel 3 twice, kernels 4 and 5
   never; ms/step beside phase 5's and the share of fine blocks skipped;
   then 5-step trajectories (4,096 rays, float32 and bfloat16): the
   sigma-loss stack, kernel path against plain path, and the cf step
   against the dense kernel step; then kernels 9, 12 and 13 (and kernel
   13's chain and phase 2 alone) timed at the steps' shapes;
6. trajectory: 5 steps of the kernel path and of the plain path (plain
   modules and the sampling twin) from the same weights and generator seed,
   4,096 rays, float32 and bfloat16, perturbation and noise on; compares
   the losses and the final parameters;
7. each kernel's time at the serving and training shapes beside its plain
   version's, its achieved TFLOP/s and its bound (kernel 10's bound: int8 operations at 1,979
   TOPS plus bf16 FLOP at 989 TFLOP/s, or bytes at 3.35 TB/s; beside it the bytes of weights
   its tiles read through L2); kernel 14 per frame (det) and per step
   (random draws) in the renderer's layout: its device time by
   torch.profiler, the host time a wrapper call and the CUDA-events time
   over back-to-back calls; each phase of kernel 5's split
   backward alone over the fine pass's chunks, and the device memory the split takes;
8. (run within phase 3) the semantic kernels against their plain
   versions: kernels 6 (no-grad
   forward), 7 (forward saving activations) and 8 (backward), the semantic
   head kernel and the head's backward kernel, at W=256, 19 classes, D=4
   and D=8 skip@4, float32 and bfloat16, 4,096 and 16,384 rays x S=64 and
   128, on logit cotangents that are zero on the second half of the rays
   (the backward against the plain backward on kernel 7's activations;
   kernels 6 and 7 bitwise equal; kernel 8 bit for bit run to run; in
   its bfloat16 chain's input products on FMA, in the twin's order);
9. semantic training: ``bench.py``'s ``ref_default_semantic_two_mlp``
   stack (coarse D=4 and fine D=8 skip@4 at W=256, both with a 19-class
   semantic head, 64 + 64 samples, 16,384 rays half RGB half LiDAR depth,
   semantic loss 0.04, depth loss 0.01, ``raw_noise_std`` 1, bfloat16,
   ``cull_eps`` 1e-4) on ``draw_scene(..., num_classes=19)``: 5 warm-up
   steps and 20 timed ones. Asserts finite losses, the exact launch counts
   (kernels 7 and 8 and both head kernels twice a step, sampling once, four
   gradient reductions, no other MLP kernel), and that the total and the
   semantic loss fall; prints ms/step and rays/s and profiles one step;
10. semantic serving: one 94 x 352 frame of the seeded semantic stack at
   ``chunk`` 16,384 (both passes within the saved-activation cap, so both
   launch kernel 6), launch counts and a frame with few empty rays
   asserted, ms/frame, and the frame against the plain path (rgb, depth,
   acc and the semantic map, float32 and bfloat16);
10b. int8 semantic serving: one frame of the seeded stack with
   ``render_int8`` at ``chunk`` 32,768, whose D=8 fine tile takes kernel 11
   (the bf16 frame would take the plain module there), launch counts,
   ms/frame, each map against phase 10's bf16 frame; kernel 11's times at
   the serving shapes;
11. the semantic kernels' times at the step's shapes (and the device
   memory of kernel 8's split), then a 5-step
   trajectory of the semantic stack, kernel path against plain path (4,096
   rays, float32 and bfloat16);
12. one ``{"kernels": [...]}`` JSON line with every kernel.

It prints ``phase N done at T s`` as it goes; a whole run should stay well
within the 1,200 s limit on an H100, the build included (PERF.md). The last line is ``{"ok": true,
"device": {...}}``. Without a CUDA device, or outside a checkout, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.time()
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
# Training kernels against their plain versions: per gradient tensor (the
# JAX kernels' blocks), max abs error over mean abs of the reference; the
# raw output and activations, max abs error over max abs of the reference.
# Each is about 3x the largest gap measured on an H100 (PERF.md): 7.1e-5 in
# float32, 6.6e-3 in bfloat16 (a bfloat16 activation rounded the other way).
TRAIN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# Kernel 3 against kernel 2 (measured 1.8e-5 and 2.1e-2): in bfloat16
# kernel 3 rounds a ray's view-layer gradient per 16-sample block, kernel 2
# per ray in a 64-point tile.
CULL_TOL = {"float32": 5e-5, "bfloat16": 6e-2}
# Trajectory, kernel path against plain path over 5 steps: max relative
# loss gap over the steps, and max over parameters of the relative L2 gap of
# their 5-step updates (Adam gives an element whose gradient is rounding
# noise an update of arbitrary sign, so an element-wise gap says little).
# About 3x the measured gaps (float32 2.1e-6 and 3.5e-3; bfloat16 1.1e-3
# and 5.6e-2, where plain bfloat16 against plain float32 differ by 9.7e-4
# and 8.2e-2).
TRAJ_TOL = {"float32": (6e-6, 1e-2), "bfloat16": (3e-3, 0.15)}
TRAIN_N_RAYS, TRAJ_N_RAYS = 16384, 4096
SEM_CLASSES = 19  # bench.py's ref_default_semantic_two_mlp scene
# Semantic kernels against their plain versions, as TRAIN_TOL: per gradient
# tensor max abs error over mean abs of the reference; outputs (raw,
# logits, activations), max abs error over max abs of the reference. Per
# kernel, about 3x its largest gap measured on an H100 (PERF.md): float32
# 1.1e-6 (kernels 6, 7), 1.8e-4 (kernel 8: the gap grows with the points a
# gradient sums), 1.1e-5 (head backward); bfloat16 3.9e-3, 7.4e-3, 1.6e-4,
# 6.8e-6. The head kernel equals its twin (0); its limit is float32
# rounding of a 256-term sum.
SEM_TOL = {
    "float32": {"fused_nerf_fwd_sem": 3e-6, "fused_nerf_fwd_acts_sem": 3e-6,
                "fused_nerf_bwd_acts_sem": 5e-4, "fused_nerf_sem_head": 1e-5,
                "fused_nerf_sem_head_bwd": 3e-5},
    "bfloat16": {"fused_nerf_fwd_sem": 1.2e-2, "fused_nerf_fwd_acts_sem": 2e-2,
                 "fused_nerf_bwd_acts_sem": 5e-4, "fused_nerf_sem_head": 1e-5,
                 "fused_nerf_sem_head_bwd": 2e-5}}
# Semantic trajectory, kernel path against plain path over 5 steps: as
# TRAJ_TOL (loss, update). About 3x the gaps measured on an H100 (float32
# 3.1e-5 and 8.2e-3; bfloat16 2.1e-4 and 4.9e-2, where plain bfloat16
# against plain float32 differ by 1.8e-3 and 0.10). The float32 loss gap is
# 15x the two_mlp stack's: the cross-entropy of logits of ~30-300 passes
# their float32 differences on.
SEM_TRAJ_TOL = {"float32": (1e-4, 2.5e-2), "bfloat16": (6e-4, 0.15)}
# Semantic frame (the seeded stack), kernel path against plain path, per
# map: (float32 max abs error over the reference's max abs, float32 mean abs
# error over its mean abs, bfloat16 mean over mean). About 3x the gaps
# measured on an H100 (PERF.md). The float32 maxima come from a few rays
# whose importance samples move with a 1e-7 change of a coarse weight; the
# means carry the check's power. In bfloat16 the semantic map's limit about
# equals the gap between the plain path in bfloat16 and in float32 (1.35e-2),
# the other maps' stay below theirs.
SEM_FRAME_TOL = {"rgb_map": (1.5e-2, 1e-5, 6e-3),
                 "depth_map": (7e-3, 1.2e-5, 8e-3),
                 "acc_map": (1.5e-2, 1e-5, 6e-3),
                 "sem_preds": (5e-3, 3.3e-5, 1.4e-2)}
# Share of the frame's rays with no opacity (measured 0.5%): an empty ray
# has acc = depth = 0 in both paths and would thin out the comparison.
SEM_EMPTY_MAX = 0.01
SEM_CHUNK = 16384  # rays per serving tile: 2.10 M fine points, under the D=8 cap
# Kernels 10 and 11 against their twins, per dtype: (max abs error over the
# twin's max abs, mean abs error over its mean abs, share of elements off by
# more than 1e-5 of the twin's max abs); the logits on the first two. An
# activation within float32 noise of a .5 boundary rounds to the other int8
# value in one of the two (their float32 sums run in other orders), so the
# max is loose; the mean and the share carry the check, since a wrong kernel
# moves every element. Each about 3x the largest gap measured on an H100
# when the limits were set (PERF.md): raw float32 1.03e-2, 6.2e-6, 1.2e-3;
# bfloat16 1.0e-2, 1.6e-6, 2.5e-4; logits float32 3.9e-4, 1.2e-5; bfloat16
# 3.9e-3, 4.1e-5. Measured since the bfloat16 kernels form their side
# products in their twins' 16-k runs: float32 as before; bfloat16 raw
# 5.2e-7, 8.7e-8, 0, logits 0, 0.
Q8_TOL = {"float32": (3e-2, 1.8e-5, 3.6e-3), "bfloat16": (3e-2, 4.7e-6, 7.4e-4)}
Q8_LOGIT_TOL = {"float32": (1.2e-3, 3.5e-5), "bfloat16": (1.2e-2, 1.2e-4)}
# int8 frame against the bf16 kernel frame: rgb mean abs gap (JAX's atol,
# tests/test_fused_q8.py:133).
INT8_RGB_MEAN = 0.03
# int8 semantic frame against phase 10's bf16 frame, per map, mean abs gap
# over the bf16 frame's mean abs: about 3x the gaps measured on an H100
# (rgb 0.0198, depth 0.0281, acc 0.0194, semantic map 0.0264, and since the
# int8 products run on the tensor cores 0.0199, 0.0281, 0.0195, 0.0264;
# PERF.md).
# The maxima are not held: a ray whose last sample's density is near 0
# flips between empty and opaque (its interval is 1e10), as in phase 4.
INT8_SEM_FRAME_MEAN = {"rgb_map": 0.06, "depth_map": 0.085, "acc_map": 0.06,
                       "sem_preds": 0.08}
INT8_CHUNK = 32768  # the default chunk: the int8 semantic pass has no cap
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bytes/s and FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_INT8_OPS = 1979e12
# Kernels 12 and 13 against their twins: raw max abs error over the twin's
# max abs; gradients per parameter block (the view layer's feature and
# encoding rows apart), max abs error over the twin's mean abs and mean abs
# error over mean abs (a ReLU gate within float32 rounding of zero could
# open in one summation order and not the other and move a gradient row;
# the mean would still carry the check). About 3x the largest gaps measured
# on an H100 (PERF.md): float32 8.7e-7, 4.2e-5, 1.6e-6; bfloat16
# 4.1e-7, 2.0e-5, 8.8e-7.
PACKED_TOL = {"float32": (3e-6, 1.3e-4, 5e-6), "bfloat16": (1.5e-6, 6e-5, 3e-6)}
PACKED_SHAPES = ((8192, 64), (1000, 8))  # 1,000 rays x 8 pad to 1,024
# Kernel 9 against its twin (live raw, max abs error over max abs): about
# 3x the largest gap measured on an H100 (PERF.md: float32 1.0e-6,
# bfloat16 9.2e-7). The composited outputs and weight gradients of the
# early-terminating route against the dense route (float32) are held to
# JAX's test_fused_fwd_cull_exact limits (rtol 1e-4 / atol 1e-5; 1e-4 of a
# gradient's mean); measured equal bit for bit, since both routes run
# kernel 3 on the same cotangents.
CF_TWIN_TOL = {"float32": 3e-6, "bfloat16": 3e-6}
# The bfloat16 tile's accuracy, independent of its layout twin: summed over
# a net's layers, the share of kernel 4's activations that round otherwise
# than the layer recomputed in float64 from the kernel's own inputs
# (fused_mlp_t.bf16_product_witness) is at most the share for float32
# products on those inputs (the float32-FMA tile's arithmetic before the
# tensor cores). Measured on an H100 (PERF.md): 0.8x of it per net, 1.4x
# before each k-step's tensor-core sum was added to the accumulators in
# float32.
WITNESS_RATIO = 1.0
# Phase 2 of the split backward (fused_nerf_wgrad_kernel) against its twin:
# max abs error over the output's max abs. Both add exact bfloat16 products
# in float32, in other orders, over up to 2^18 points.
WGRAD_TOL = 1e-5
CF_N_RAYS = (TRAIN_N_RAYS, 4000)  # 4,000 pad to 4,096
CF_S, CF_EPS = 128, 1e-4
# Trajectories of the sigma-loss stack, kernel vs plain, as TRAJ_TOL: about
# 3x the gaps measured on an H100 (PERF.md: float32 1.54e-3 and
# 1.13e-2, bfloat16 1.4e-3 and 5.4e-2). The float32 gaps are those of plain
# bfloat16 against plain float32 (1.36e-3, 8.3e-2): the sigma loss makes the
# stack's 5-step trajectory sensitive to float32 summation order, so the
# one-step gradient check below carries the float32 power.
SIGMA_TRAJ_TOL = {"float32": (4.6e-3, 3.4e-2), "bfloat16": (4.2e-3, 0.16)}
# The sigma-loss term's gradients of one step, kernel path against plain
# path from the same weights, rays and generator (float32): per fine-net
# parameter, max abs error over the plain path's mean abs and mean abs
# error over mean abs. About 3x the gaps measured on an H100 (PERF.md:
# 2.0e-5 and 1.6e-6).
SIGMA_GRAD_TOL = (6e-5, 5e-6)
# The cf step against the dense kernel step: max relative loss gap over 5
# steps (float32 1e-5: the cull is exact, the fine backward sums in another
# order), and the bf16 loss gap.
CF_TRAJ_TOL = {"float32": 1e-5, "bfloat16": 3e-3}
SIGMA_STEPS = (5, 10)  # warm-up, timed
# Kernel 14's cases (phase 3, tests/test_torch_port_cuda.py and
# scripts/torch_sample_pdf_parity.py): rays, bins and draws a ray. The
# kernel equals its twin bit for bit in each (the same float32 operations in
# the same order), so phase 3 holds it to max abs err 0.
SAMPLE_PDF_NS = (1, 31, 33, 320, 16384, 33088)
SAMPLE_PDF_BS = (2, 9, 63, 64, 129)
SAMPLE_PDF_VS = (1, 40, 64, 128)
# Kernel 14's timing rotates over input sets of this many bytes in all, twice
# the H100's 50 MB L2, so that each launch reads its inputs from device memory.
L2_FLUSH_BYTES = 100e6


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


def sequential_cdf_np(w):
    """Kernel 14's CDF of weights ``[n, B-1]`` in numpy float32 (``[n, B]``,
    0 first): the 1e-5 floor, then the total and the prefix sum added in
    order (``np.cumsum`` accumulates in sequence), each term divided by the
    total on its own."""
    import numpy as np

    w = w.astype(np.float32) + np.float32(1e-5)
    total = np.cumsum(w, axis=1, dtype=np.float32)[:, -1:]
    cdf = np.cumsum(w / total, axis=1, dtype=np.float32)
    return np.concatenate([np.zeros_like(cdf[:, :1]), cdf], axis=1)


def sample_pdf_inputs(dev, N, B, V, det, layout="contiguous", seed=0,
                      u_one=False):
    """Seeded inputs of kernel 14 on ``dev``: bins ``[N, B]`` sorted, weights
    ``[N, B-1]`` (cubed uniforms; ray 0 all zero, a uniform pdf; ray 1 half
    zero, a flat CDF stretch for the denominator guard), draws ``u [N, V]``
    (``det``: ``linspace(0, 1)`` as ``pdf_uniforms`` makes it, else uniform).

    ``layout="renderer"`` hands them over as the renderer does: the weights
    as the slice ``[:, 1:-1]`` of an ``[N, B+1]`` tensor (row stride B + 1)
    and, with ``det``, u as the ``expand`` of one row (row stride 0). With
    ``u_one`` (B > 2) every ray's last weight is 0, so its last bin holds the
    floor alone and the denominator guard fires there; its rows are drawn
    until the sequential float32 CDF ends above 1.0, and its last draw is
    1.0: that draw lands a whole bin below where a CDF rounded to 1.0 or
    less puts it, so a kernel that sums in another order moves it."""
    import numpy as np
    import torch

    if u_one and B <= 2:
        raise ValueError("u_one needs B > 2: at B = 2 the CDF ends at 1.0")
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.random((N, B), dtype=np.float32), axis=-1)
    if u_one:
        rows, n = [], 0
        while n < N:
            c = rng.random((4 * N, B + 1), dtype=np.float32) ** 3
            c[:, -2] = 0.0
            c = c[sequential_cdf_np(c[:, 1:-1])[:, -1] > 1.0]
            rows.append(c)
            n += len(c)
        w = np.concatenate(rows)[:N]
    else:
        w = rng.random((N, B + 1), dtype=np.float32) ** 3
        w[0] = 0.0
        w[min(1, N - 1), 1:1 + B // 2] = 0.0
    weights = torch.from_numpy(w).to(dev)[:, 1:-1]
    if det:
        u = torch.linspace(0.0, 1.0, V, dtype=torch.float32,
                           device=dev).expand(N, V)
    else:
        u = torch.from_numpy(rng.random((N, V), dtype=np.float32)).to(dev)
        if u_one:
            u[:, -1] = 1.0
    if layout != "renderer":
        weights, u = weights.contiguous(), u.contiguous()
    return torch.from_numpy(bins).to(dev), weights, u


def sample_pdf_sets(dev, tiles, det, B=63, V=64):
    """Input sets of kernel 14 in the renderer's layout, one ``(bins,
    weights, u)`` a tile of ``tiles``, enough sets to hold L2_FLUSH_BYTES."""
    one = sum(n * (2 * B + 1 + (0 if det else V) + V) * 4 for n in tiles)
    return [[sample_pdf_inputs(dev, n, B, V, det, "renderer", seed=97 * k + i)
             for i, n in enumerate(tiles)]
            for k in range(max(2, -(-int(L2_FLUSH_BYTES) // one)))]


def sample_pdf_bound_ms(calls):
    """Kernel 14's byte bound over ``calls``, ``(bins, weights, u)`` each: the
    elements each call's inputs hold read once (a row stride of 0, det's
    expanded draws, is one row read once) and its ``[N, V]`` output written
    once, over the card's memory rate."""
    def held(t):
        return (t.shape[-1] if t.stride(0) == 0 else t.numel()) * t.element_size()

    bytes_ = sum(held(b) + held(w) + held(u) + u.numel() * 4 for b, w, u in calls)
    return bytes_ / PEAK_BYTES * 1e3


def sample_pdf_times(sc, sets, reps=50, host_calls=1000):
    """Kernel 14's times over one frame or step (a set of ``sets``: one
    wrapper call a tile), the sets rotated:
    - ``device_ms``: ``sample_pdf_kernel``'s self device time a frame, by
      torch.profiler over ``reps`` frames (``device_all_ms``: every kernel's,
      copies of the inputs included). A profiler session after another in
      one process may record no device events; after two such sessions the
      time is taken by CUDA events around each wrapper call instead, the
      stream held busy meanwhile so that the host path is not timed, and
      both keys hold that time (``device_by`` says which);
    - ``host_us_per_call``: a host clock around ``host_calls`` wrapper calls,
      stopped before the one synchronisation at the end;
    - ``events_ms``: CUDA events around ``reps`` back-to-back frames;
    - ``plain_ms``: the twin's frame, by events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    turn = [0]

    def frame():
        for bins, weights, u in sets[turn[0] % len(sets)]:
            sc.inverse_cdf(bins, weights, u)
        turn[0] += 1

    def plain():
        for bins, weights, u in sets[0]:
            sc.inverse_cdf_plain(bins, weights, u)

    events_ms = cuda_ms(frame, reps)
    plain_ms = cuda_ms(plain, reps=5, warmup=1)
    frames = max(1, host_calls // len(sets[0]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        frame()
    host_us = (time.perf_counter() - t0) * 1e6 / (frames * len(sets[0]))
    torch.cuda.synchronize()
    times = {"events_ms": events_ms, "host_us_per_call": host_us,
             "plain_ms": plain_ms}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                frame()
            torch.cuda.synchronize()
        by_name = device_times(prof)
        kern = sum(t for t, name in by_name if "sample_pdf_kernel" in name)
        if kern > 0:
            return {"device_ms": kern / reps, "device_by": "profiler",
                    "device_all_ms": sum(t for t, _ in by_name) / reps, **times}
    pairs = []
    for k in range(reps):
        for bins, weights, u in sets[k % len(sets)]:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            torch.cuda._sleep(1_000_000)  # ~0.5 ms: the launch is queued before start
            start.record()
            sc.inverse_cdf(bins, weights, u)
            end.record()
            pairs.append((start, end))
    torch.cuda.synchronize()
    ms = sum(s.elapsed_time(e) for s, e in pairs) / reps
    check(ms > 0, "events time sample_pdf_kernel's launches")
    return {"device_ms": ms, "device_by": "events", "device_all_ms": ms, **times}


def device_times(prof):
    """(ms, name) of each kernel in a profile, largest first. Kernel events
    only: an aten op's self device time repeats its kernels', and the
    optimizer's ``Optimizer.step`` annotation spans its own kernels."""
    import torch

    return sorted(((e.self_device_time_total / 1e3, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("Optimizer.")), reverse=True)


def profile_step(fn, label):
    """One call of ``fn`` under torch.profiler: wall time, device busy share
    and the ten kernels that took longest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_name = device_times(prof)
    dev_ms = sum(t for t, _ in by_name)
    print(f"profiled {label}: wall {wall_ms:.1f} ms, device busy {dev_ms:.1f} ms "
          f"({100 * dev_ms / wall_ms:.1f}%), idle {wall_ms - dev_ms:.1f} ms")
    for t, name in by_name[:10]:
        print(f"  {t:9.3f} ms  {name[:90]}")


def sass_tensor_core_check(_build, fmt, fm):
    """The bfloat16 products run on the tensor cores: ``cuobjdump
    --dump-sass`` of the built libraries shows HMMA (or HGMMA) in every
    bfloat16 instantiation of the forward kernels (1, 4, 6, 7, 9), of the
    recompute backward (2, 3; more than the forward tile alone has, so its
    backward tile has them too), of the split backward's phase 1
    (``fused_nerf_bwd_acts_kernel``: kernel 5's) and in phase 2's
    ``fused_nerf_wgrad_kernel``; none in a float32 instantiation. Kernel 8's
    phase 1 keeps its input products on FMA, in its twin's order (the note
    of ``backward_tile`` in csrc/fused_nerf_bwd.cu): its count is printed.
    Every instantiation of the int8 tile (``fused_nerf_q8_kernel``, kernels
    10 and 11) shows IMMA and no IDP4A, HMMA in bfloat16 and none in
    float32; the counts are printed. The packed-lane kernels
    (csrc/fused_nerf_packed.cu): HMMA in the bfloat16 kernel 12 and kernel
    13's chain, none in their float32 kernels."""
    import re

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    kernel = re.compile(r"\d+(fused_nerf_\w+?_kernel)"
                        r"(?:I(13__nv_bfloat16|f)Li(\d+)E((?:Lb[01]E)*))?")
    found = []  # (name, type, W, flags, tensor-core instructions) per instantiation
    for lib in (fmt.KERNEL, fmt.BWD_KERNEL):
        sass = subprocess.run([tool, "--dump-sass", str(_build.library_path(lib))],
                              capture_output=True, text=True, check=True).stdout
        for chunk in sass.split("Function : ")[1:]:
            m = kernel.search(chunk.split()[0])
            if m:
                found.append((m.group(1), {"f": "f32", None: "bf16 only"}.get(
                    m.group(2), "bf16"), m.group(3), m.group(4),
                    chunk.count("HMMA") + chunk.count("HGMMA")))
    tile = [k for k in found if k[0].startswith("fused_nerf_fwd")
            or k[0] == "fused_nerf_bwd_recompute_kernel"]
    # fused_nerf_bwd_acts_kernel<T, W, kSem>: Lb0E kernel 5, Lb1E kernel 8
    split = [k for k in found if k[0] == "fused_nerf_wgrad_kernel"
             or (k[0] == "fused_nerf_bwd_acts_kernel" and k[3] == "Lb0E")]
    sem = [k for k in found if k[0] == "fused_nerf_bwd_acts_kernel" and k[3] == "Lb1E"]
    for label, group in (("forward-tile", tile), ("split-backward", split),
                         ("kernel 8 phase-1 (FMA, its twin's order)", sem)):
        print(f"SASS: tensor-core instructions per bfloat16 {label} kernel "
              f"{sorted(k[4] for k in group if k[1] != 'f32')}, per float32 one "
              f"{sorted(k[4] for k in group if k[1] == 'f32')}")
    check(sum(k[1] == "bf16" for k in tile) == sum(k[1] == "f32" for k in tile) == 14,
          "14 forward-tile instantiations of each type in the SASS")
    check(sum(k[1] == "bf16" for k in split) == sum(k[1] == "f32" for k in split) == 2
          and [k[0] for k in split if k[1] == "bf16 only"] == ["fused_nerf_wgrad_kernel"]
          and len(sem) == 4, "2 bfloat16 and 2 float32 kernel-5 instantiations, 4 of kernel "
          "8 and the phase-2 kernel in the SASS")
    check(all(k[4] > 0 for k in tile + split if k[1] != "f32"),
          "HMMA in every bfloat16 kernel")
    check(all(k[4] == 0 for k in tile + split + sem if k[1] == "f32"),
          "no HMMA in a float32 kernel")
    fwd = {k[2]: k[4] for k in tile if k[0] == "fused_nerf_fwd_acts_kernel"
           and k[1] == "bf16"}
    for name, typ, width, _, n in tile:
        if name == "fused_nerf_bwd_recompute_kernel" and typ == "bf16":
            check(n > fwd[width], f"HMMA in the recompute backward's tile (W={width}: "
                  f"{n} against the forward tile's {fwd[width]})")
    # The int8 tile (kernels 10, 11): its W8A8 products on the integer tensor cores (IMMA),
    # none on __dp4a (IDP4A); the bfloat16 side products on HMMA, the float32 ones on FMA.
    sass = subprocess.run([tool, "--dump-sass", str(_build.library_path(fmt.Q8_KERNEL))],
                          capture_output=True, text=True, check=True).stdout
    q8 = []  # (type, W, IMMA, IDP4A, HMMA) per instantiation
    for chunk in sass.split("Function : ")[1:]:
        m = kernel.search(chunk.split()[0])
        if m and m.group(1) == "fused_nerf_q8_kernel":
            q8.append(({"f": "f32"}.get(m.group(2), "bf16"), m.group(3), chunk.count("IMMA"),
                       chunk.count("IDP4A"), chunk.count("HMMA") + chunk.count("HGMMA")))
    print("SASS: fused_nerf_q8_kernel (type, W, IMMA, IDP4A, HMMA) " + str(sorted(q8)))
    check(sorted((k[0], k[1]) for k in q8) == [("bf16", "128"), ("bf16", "256"),
                                               ("f32", "128"), ("f32", "256")],
          "4 fused_nerf_q8_kernel instantiations in the SASS")
    check(all(k[2] > 0 and k[3] == 0 for k in q8), "IMMA and no IDP4A in every int8 kernel")
    check(all((k[4] > 0) == (k[0] == "bf16") for k in q8),
          "HMMA in the bfloat16 int8 kernels and none in the float32 ones")
    # Kernels 12 and 13: fused_nerf_packed_fwd_kernel<T, W>, the float32
    # fused_nerf_packed_bwd_kernel<float, W>, the bfloat16 chain
    # fused_nerf_packed_chain_kernel<W>.
    sass = subprocess.run([tool, "--dump-sass", str(_build.library_path(fm.KERNEL))],
                          capture_output=True, text=True, check=True).stdout
    packed = []  # (name, type, W, HMMA) per instantiation
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split()[0]
        m = kernel.search(name)
        if m and m.group(1).startswith("fused_nerf_packed_"):
            packed.append((m.group(1), {"f": "f32"}.get(m.group(2), "bf16"),
                           re.search(r"Li(\d+)E", name).group(1),
                           chunk.count("HMMA") + chunk.count("HGMMA")))
    print("SASS: packed-lane kernels (name, type, W, HMMA) " + str(sorted(packed)))
    want = sorted((k, t, w) for k, t in (("fused_nerf_packed_fwd_kernel", "f32"),
                                         ("fused_nerf_packed_fwd_kernel", "bf16"),
                                         ("fused_nerf_packed_bwd_kernel", "f32"),
                                         ("fused_nerf_packed_chain_kernel", "bf16"))
                  for w in ("128", "256"))
    check(sorted(k[:3] for k in packed) == want, "8 packed-lane instantiations in the SASS")
    check(all((k[3] > 0) == (k[1] == "bf16") for k in packed),
          "HMMA in the bfloat16 packed-lane kernels and none in the float32 ones")


def mlp_macs(depth, width, e_p, e_v, live_skips, S):
    """Multiply-adds per point of the fused forward (per-ray view term
    spread over the ray's S points)."""
    m = e_p * width + (depth - 1) * width * width + len(live_skips) * e_p * width
    m += width + width * width + width * (width // 2) + (width // 2) * 3
    return m + e_v * (width // 2) / S


def bwd_macs(depth, width, e_p, e_v, live_skips, S):
    """Multiply-adds per point of the backward: one per weight for its
    gradient, one per weight that feeds a trunk activation for the input
    gradients (none into the encodings)."""
    fwd = mlp_macs(depth, width, e_p, e_v, live_skips, S)
    return 2 * fwd - e_p * width * (1 + len(live_skips)) - e_v * (width // 2) / S


def wgrad_macs(depth, width, e_p, live_skips):
    """Multiply-adds per point of phase 2 of the split backward: the weight
    gradients of the trunk (encoding rows of layer 0 and of each live skip
    layer, trunk rows of the others), feature and views_0's feature rows."""
    return (e_p * width * (1 + len(live_skips)) + (depth - 1) * width * width
            + width * width + width * (width // 2))


def split_memory(fmt, label, fn, P, depth):
    """Device memory a split backward's call takes beyond its inputs, by the
    allocator's peak, beside the cotangent buffer of one chunk."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    cot = fmt.cot_numel(min(P, fmt.BWD_CHUNK), depth, 256, 10) * 2
    print(f"split backward, {label}: {P} points in chunks of {fmt.BWD_CHUNK}; "
          f"extra device memory {peak / 2**30:.3f} GiB at peak, of which the "
          f"cotangent buffer {cot / 2**30:.3f} GiB", flush=True)
    return {"peak_bytes": peak, "cotangent_buffer_bytes": cot}


def split_phase_times(fmt, params, pts, vd, g, acts, S, kw, pk):
    """(ms, plain ms) of each phase of kernel 5's split backward alone over
    every chunk of a pass, phase 2 on phase 1's cotangents."""
    import torch

    P, depth = pts.shape[1], kw["depth"]
    pts, vd, g = (x.float().contiguous() for x in (pts, vd, g))
    chunks = [(c, min(fmt.BWD_CHUNK, P - c)) for c in range(0, P, fmt.BWD_CHUNK)]
    stride = -(-(pk.weights.numel() + pk.biases.numel()) // 4) * 4
    part = torch.zeros((2 * fmt._grid(pts.device, 1 << 30), stride), device=pts.device)
    cots = [fmt.fused_nerf_bwd_chain(params, pts, vd, g, acts, S, c, n, part,
                                     packed=pk, **kw) for c, n in chunks]
    ents = [fmt.wgrad_entries(acts, cot, P, c, n, depth, 256, 10, kw["skips"],
                              pk.w_offsets) for cot, (c, n) in zip(cots, chunks)]
    args = (params, pts, vd, g, acts, S)
    out = {
        "fused_nerf_bwd_chain": (
            cuda_ms(lambda: [fmt.fused_nerf_bwd_chain(*args, c, n, part, packed=pk,
                                                      cot=cot, **kw)
                             for cot, (c, n) in zip(cots, chunks)], 3, 1),
            cuda_ms(lambda: [fmt.fused_nerf_bwd_chain_plain(*args, c, n, **kw)
                             for c, n in chunks], 1, 1)),
        "fused_nerf_bwd_weight_grads": (
            cuda_ms(lambda: [fmt.bwd_weight_grads(e, part, n)
                             for e, (_, n) in zip(ents, chunks)], 3, 1),
            cuda_ms(lambda: [fmt.bwd_weight_grads_plain(e, part[:1])
                             for e in ents], 2, 1))}
    del cots, ents, part
    torch.cuda.empty_cache()
    return out


def mlp_inputs(NeRFMLP, dev, depth, n_rays, S, seed):
    """Seeded W=256 weights, points, view directions and a cotangent whose
    rays are live for a random prefix of their samples (zero after)."""
    import numpy as np
    import torch

    g = torch.Generator().manual_seed(seed)
    m = NeRFMLP(depth=depth, width=256, generator=g).to(dev)
    with torch.no_grad():
        m.sigma.bias += 0.5
    params = {k: v.detach() for k, v in m.named_parameters()}
    rng = np.random.default_rng(seed)
    P = n_rays * S
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, P)).astype(np.float32)).to(dev)
    vd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(n_rays, 3)).astype(np.float32)), dim=-1).T.contiguous().to(dev)
    gt = torch.randn((4, P), device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    lengths = torch.from_numpy(rng.integers(0, S + 1, n_rays)).to(dev)
    live = torch.arange(S, device=dev)[None] < lengths[:, None]
    return params, pts, vd, gt * live.reshape(1, -1)


def grad_err(fmt, got, ref, depth):
    """(max over the kernel's gradient blocks of max abs error / mean abs of
    the reference, max abs error)."""
    got, ref = (fmt.grad_blocks(x, depth, 256, 10, (4,)) for x in (got, ref))
    rel = max(((got[k] - ref[k]).abs().max() / (ref[k].abs().mean() + 1e-12)).item()
              for k in ref)
    return rel, max((got[k] - ref[k]).abs().max().item() for k in ref)


def train_kernel_checks(fmt, NeRFMLP, dev, launch_fns):
    """Phase 3, training kernels: kernel 4 against the plain forward, and in
    bfloat16 against the float64 witness (WITNESS_RATIO); kernels 2, 3 and 5
    against the plain backward run on kernel 4's activations; kernel 3
    against kernel 2. Returns each kernel's largest max abs error.

    The backward references take kernel 4's activations, which are bitwise
    the ones kernels 2 and 3 recompute (the same device code), because at
    10^5-10^6 points a few ReLU gates whose pre-activation lies within
    float32 rounding of zero open in one summation order and not in the
    other, and each such point moves a whole row of a weight gradient (a
    full plain recompute differs by up to 6e-2 of a gradient's mean at
    D=8, 4,096 rays, in float32)."""
    import torch

    err = {"fused_nerf_fwd_acts": 0.0, "fused_nerf_bwd": 0.0,
           "fused_nerf_bwd_culled": 0.0, "fused_nerf_bwd_acts": 0.0,
           "fused_nerf_bwd_chain": 0.0, "fused_nerf_bwd_weight_grads": 0.0}
    for depth in (4, 8):
        for n_rays, S in ((4096, 64), (4096, 128), (TRAIN_N_RAYS, 64),
                          (TRAIN_N_RAYS, 128)):
            params, pts, vd, g = mlp_inputs(NeRFMLP, dev, depth, n_rays, S,
                                            depth * 1000 + S)
            P = n_rays * S
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype)[6:]
                kw = dict(depth=depth, width=256, multires=10,
                          multires_views=4, dtype=dtype, skips=(4,))
                raw, acts = fmt.fused_nerf_fwd_acts(params, pts, vd, S, **kw)
                from_acts = fmt.fused_nerf_bwd_acts(params, pts, vd, g, acts,
                                                    S, **kw)
                if n_rays == 4096 and S == 64:
                    again = fmt.fused_nerf_bwd_acts(params, pts, vd, g, acts, S, **kw)
                    check(all(torch.equal(from_acts[k], again[k]) for k in again),
                          f"kernel 5 bit-identical run to run D={depth} {name}")
                    del again
                torch.cuda.synchronize()
                if dtype == torch.bfloat16 and n_rays == 4096 \
                        and (depth, S) in ((4, 64), (8, 128)):
                    bwd_witness(fmt, params, pts, vd, g, acts, from_acts, S, depth)
                if dtype == torch.bfloat16 and n_rays == TRAIN_N_RAYS and S == 128:
                    for k, e in split_phase_checks(fmt, params, pts, vd, g, acts, S,
                                                   kw).items():
                        err[k] = max(err[k], e)
                n_before = [f.launches for f in launch_fns]
                raw_ref, acts_ref, _, _ = fmt._forward_plain(
                    params, pts, vd, S, depth, 256, 10, 4, dtype, (4,))
                e4 = [(raw - raw_ref).abs().max().item(),
                      (raw - raw_ref).abs().max().item()
                      / raw_ref.abs().max().item()]
                for a, b in zip(fmt.split_acts(acts, P, depth, 256), acts_ref):
                    d = (a.float() - b).abs().max().item()
                    e4 = [max(e4[0], d), max(e4[1], d / b.abs().max().item())]
                del raw, raw_ref, acts_ref
                if dtype == torch.bfloat16 and n_rays == 4096:
                    wit = fmt.bf16_product_witness(
                        params, pts, vd, acts, S, depth=depth, width=256,
                        multires=10, multires_views=4, skips=(4,))
                    sk, s32 = sum(wit["kernel"]), sum(wit["float32"])
                    print(f"bf16 tile against the float64 witness D={depth} "
                          f"N={n_rays} S={S}: share rounded otherwise per layer "
                          "(trunk.., feature, view) kernel "
                          + " ".join(f"{x:.3g}" for x in wit["kernel"])
                          + "; float32 products "
                          + " ".join(f"{x:.3g}" for x in wit["float32"])
                          + f"; summed {sk:.4g} against {s32:.4g} "
                          f"({sk / s32:.3f}x, limit {WITNESS_RATIO:g}x)", flush=True)
                    check(sk <= WITNESS_RATIO * s32,
                          f"bf16 tile against the float64 witness D={depth} S={S}")
                ref = fmt.fused_nerf_bwd_acts_plain(params, pts, vd, g, acts,
                                                    S, **kw)
                e5 = grad_err(fmt, from_acts, ref, depth)
                del acts
                torch.cuda.empty_cache()
                check([f.launches for f in launch_fns] == n_before,
                      "a plain version launched a kernel")
                dense = fmt.fused_nerf_bwd(params, pts, vd, g, S, **kw)
                torch.cuda.synchronize()
                e2 = grad_err(fmt, dense, ref, depth)
                del ref
                xb, vb, gb, flags = fmt.culled_layout(pts, vd, g, S)
                culled = fmt.fused_nerf_bwd_culled(
                    params, xb, vb, gb, fmt.SAMPLE_BLOCK, flags, **kw)
                _, acts_c = fmt.fused_nerf_fwd_acts(params, xb, vb,
                                                    fmt.SAMPLE_BLOCK, **kw)
                torch.cuda.synchronize()
                n_before = [f.launches for f in launch_fns]
                ref_c = fmt.fused_nerf_bwd_acts_plain(
                    params, xb, vb, gb, acts_c, fmt.SAMPLE_BLOCK, **kw)
                check([f.launches for f in launch_fns] == n_before,
                      "a plain version launched a kernel")
                e3, e32 = grad_err(fmt, culled, ref_c, depth), \
                    grad_err(fmt, culled, dense, depth)
                del ref_c, acts_c, xb, vb, gb
                torch.cuda.empty_cache()
                print(f"kernels 2-5 D={depth} N={n_rays} S={S} {name}: "
                      f"fwd_acts {e4[1]:.3g} (abs {e4[0]:.3g}), bwd dense "
                      f"{e2[0]:.3g} (abs {e2[1]:.3g}), bwd culled {e3[0]:.3g} "
                      f"(abs {e3[1]:.3g}; live tiles {flags.float().mean().item():.3f}), "
                      f"bwd acts {e5[0]:.3g} (abs {e5[1]:.3g}), culled vs dense "
                      f"{e32[0]:.3g}; tolerance {TRAIN_TOL[name]:g} "
                      f"(culled vs dense {CULL_TOL[name]:g})", flush=True)
                for e in (e4[1], e2[0], e3[0], e5[0]):
                    check(e <= TRAIN_TOL[name],
                          f"training kernel vs plain D={depth} N={n_rays} S={S} {name}")
                check(e32[0] <= CULL_TOL[name],
                      f"culled vs dense D={depth} N={n_rays} S={S} {name}")
                for k, e in (("fused_nerf_fwd_acts", e4[0]), ("fused_nerf_bwd", e2[1]),
                             ("fused_nerf_bwd_culled", e3[1]),
                             ("fused_nerf_bwd_acts", e5[1])):
                    err[k] = max(err[k], e)
            del params, pts, vd, g
            torch.cuda.empty_cache()
    return err


def bwd_witness(fmt, params, pts, vd, g, acts, grads, S, depth):
    """Phase 3: the bfloat16 split backward against the float64 witness
    (fused_mlp_t.bwd_product_witness): phase 1's cotangents of all the
    points (one chunk) rounded otherwise no more often than by float32
    products (WITNESS_RATIO, summed over the layers); the weight gradients'
    max-over-mean errors against float64 products printed beside float32's."""
    import torch

    P = pts.shape[1]
    kw = dict(depth=depth, width=256, multires=10, multires_views=4, skips=(4,))
    pk = fmt.pack_params(params, depth, torch.bfloat16, pts.device)
    part = torch.zeros((fmt._grid(pts.device, 1 << 30),
                        -(-(pk.weights.numel() + pk.biases.numel()) // 4) * 4),
                       device=pts.device)
    cot = fmt.fused_nerf_bwd_chain(params, pts.contiguous(), vd.contiguous(), g, acts,
                                   S, 0, P, part, dtype=torch.bfloat16, packed=pk, **kw)
    wit = fmt.bwd_product_witness(params, g, acts, cot, grads, S, depth=depth,
                                  width=256, multires=10, skips=(4,))
    sk, s32 = sum(wit["kernel"]), sum(wit["float32"])
    wk, w32 = max(wit["wgrad_kernel"].values()), max(wit["wgrad_float32"].values())
    print(f"bf16 backward against the float64 witness D={depth} N={P // S} S={S}: "
          "cotangents rounded otherwise per layer (dhv, dfeat, dh_D-1 .. dh_0) kernel "
          + " ".join(f"{x:.3g}" for x in wit["kernel"]) + "; float32 products "
          + " ".join(f"{x:.3g}" for x in wit["float32"])
          + f"; summed {sk:.4g} against {s32:.4g} ({sk / s32:.3f}x, limit "
          f"{WITNESS_RATIO:g}x); weight gradients max abs err over mean abs, worst "
          f"block: kernel {wk:.3g}, float32 products {w32:.3g}", flush=True)
    check(sk <= WITNESS_RATIO * s32,
          f"bf16 backward against the float64 witness D={depth} S={S}")
    del cot, part
    torch.cuda.empty_cache()


def split_phase_checks(fmt, params, pts, vd, g, acts, S, kw):
    """Phase 3: each phase of the split backward on its own against its twin,
    on the first chunk of a step's fine pass: phase 1's cotangents (max abs
    error over max abs, per layer) and small gradients (as TRAIN_TOL) within
    TRAIN_TOL; phase 2 on phase 1's cotangents within WGRAD_TOL of its
    output's max abs. Returns each phase's largest max abs error."""
    import torch

    depth, dev = kw["depth"], pts.device
    P, count = pts.shape[1], min(pts.shape[1], fmt.BWD_CHUNK)
    pk = fmt.pack_params(params, depth, kw["dtype"], dev)
    n = pk.weights.numel() + pk.biases.numel()
    stride = -(-n // 4) * 4
    part = torch.zeros((fmt._grid(dev, 1 << 30), stride), device=dev)
    args = (params, pts.contiguous(), vd.contiguous(), g, acts, S, 0, count)
    cot = fmt.fused_nerf_bwd_chain(*args, part, packed=pk, **kw)
    ents = fmt.wgrad_entries(acts, cot, P, 0, count, depth, 256, 10, (4,), pk.w_offsets)
    wpart = torch.zeros((fmt._wgrad_splits(ents, count, dev), stride), device=dev)
    fmt.bwd_weight_grads(ents, wpart, count)
    torch.cuda.synchronize()
    cot_ref, small_ref = fmt.fused_nerf_bwd_chain_plain(*args, **kw)
    e1 = [(a.float() - b.float()).abs().max().item() / (b.float().abs().max().item()
                                                           + 1e-30)
          for a, b in zip(fmt.split_cot(cot, count, depth, 256, 10),
                          fmt.split_cot(cot_ref, count, depth, 256, 10))]
    e1_abs = (cot.float() - cot_ref.float()).abs().max().item()
    got = fmt.unpack_grads(part.sum(0)[:n], params, pk, depth)
    small = grad_err(fmt, got, fmt.unpack_grads(small_ref, params, pk, depth), depth)
    wref = torch.zeros((1, stride), device=dev)
    fmt.bwd_weight_grads_plain(ents, wref)
    e2_abs = (wpart.sum(0) - wref[0]).abs().max().item()
    e2 = e2_abs / wref.abs().max().item()
    print(f"split backward phases D={depth} N={P // S} S={S} bfloat16, first chunk of "
          f"{count} points: phase 1 cotangents max abs err over max abs per layer "
          + " ".join(f"{x:.3g}" for x in e1) + f", small gradients {small[0]:.3g} "
          f"(tolerance {TRAIN_TOL['bfloat16']:g}); phase 2 {e2:.3g} of its max "
          f"(abs {e2_abs:.3g}; tolerance {WGRAD_TOL:g}), {wpart.shape[0]} splits",
          flush=True)
    check(max(e1) <= TRAIN_TOL["bfloat16"] and small[0] <= TRAIN_TOL["bfloat16"],
          f"split backward phase 1 vs plain D={depth} S={S}")
    check(e2 <= WGRAD_TOL, f"split backward phase 2 vs plain D={depth} S={S}")
    del cot, cot_ref, part, wpart, wref, ents
    torch.cuda.empty_cache()
    return {"fused_nerf_bwd_chain": max(e1_abs, small[1]),
            "fused_nerf_bwd_weight_grads": e2_abs}


def sem_inputs(NeRFMLP, dev, depth, n_rays, S, seed):
    """Seeded W=256 weights with a 19-class semantic head (random biases, so
    the head's S-scaled biases count), points, view directions, a raw
    cotangent, and a logit cotangent that is zero on the second half of the
    rays (the step's depth rays carry no semantic loss)."""
    import numpy as np
    import torch

    g = torch.Generator().manual_seed(seed)
    m = NeRFMLP(depth=depth, width=256, num_semantic_classes=SEM_CLASSES,
                generator=g).to(dev)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        m.sigma.bias += 0.5
    params = {k: v.detach() for k, v in m.named_parameters()}
    rng = np.random.default_rng(seed)
    P = n_rays * S
    pts = torch.from_numpy(rng.uniform(-1, 1, (3, P)).astype(np.float32)).to(dev)
    vd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(n_rays, 3)).astype(np.float32)), dim=-1).T.contiguous().to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gt = torch.randn((4, P), device=dev, generator=gen)
    gsem = torch.randn((n_rays, SEM_CLASSES), device=dev, generator=gen)
    gsem[n_rays // 2:] = 0.0
    return params, pts, vd, gt, gsem


def rel_err(got, ref):
    """(max abs error, max abs error over max abs of the reference)."""
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / (ref.float().abs().max().item() + 1e-30)


SEM_KERNELS = ("fused_nerf_fwd_sem", "fused_nerf_fwd_acts_sem",
               "fused_nerf_bwd_acts_sem", "fused_nerf_sem_head",
               "fused_nerf_sem_head_bwd")


def sem_kernel_checks(fmt, NeRFMLP, dev, launch_fns, depths=(4, 8),
                      shapes=((4096, 64), (4096, 128), (TRAIN_N_RAYS, 64),
                              (TRAIN_N_RAYS, 128))):
    """Phase 8: kernels 6 and 7 against the plain forward and head; the head
    kernel alone against its twin on partial sums of kernel 7's feature
    activation; kernel 8 and the head's backward kernel against their twins
    on kernel 7's activations (the plain backward takes the kernel's
    activations, as in phase 3); kernel 8 twice, bit for bit. Returns each
    kernel's largest max abs error."""
    import torch

    err = dict.fromkeys(SEM_KERNELS, 0.0)
    width, C = 256, SEM_CLASSES
    for depth in depths:
        for n_rays, S in shapes:
            params, pts, vd, g, gsem = sem_inputs(NeRFMLP, dev, depth, n_rays,
                                                  S, depth * 100 + S)
            P = n_rays * S
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype)[6:]
                kw = dict(depth=depth, width=width, multires=10,
                          multires_views=4, dtype=dtype, skips=(4,))
                raw6, sem6 = fmt.fused_nerf_fwd_sem(params, pts, vd, S, **kw)
                raw7, acts, sem7, sem_acts = fmt.fused_nerf_fwd_acts_sem(
                    params, pts, vd, S, **kw)
                grads = fmt.fused_nerf_bwd_acts_sem(params, pts, vd, g, gsem,
                                                    acts, sem_acts, S, **kw)
                sem = fmt.pack_sem(params, dtype, dev)
                fpart = fmt.sem_tile_partials_plain(
                    fmt.split_acts(acts, P, depth, width)[depth], S)
                head, head_acts = fmt.sem_head(fpart, sem, n_rays, S, save=True)
                hflat, hdfeat = fmt.sem_head_bwd(gsem, sem_acts, sem, S)
                again = None
                if (n_rays, S) == shapes[0]:
                    again = fmt.fused_nerf_bwd_acts_sem(
                        params, pts, vd, g, gsem, acts, sem_acts, S, **kw)
                torch.cuda.synchronize()
                n_before = [f.launches for f in launch_fns]
                check(torch.equal(raw6, raw7) and torch.equal(sem6, sem7),
                      "kernels 6 and 7 give the same raw and logits")
                if again is not None:
                    check(all(torch.equal(grads[k], again[k]) for k in grads),
                          "kernel 8 bit-identical run to run")
                raw_ref, acts_ref, _, _ = fmt._forward_plain(
                    params, pts, vd, S, depth, width, 10, 4, dtype, (4,))
                sem_ref, sem_acts_ref = fmt.sem_head_plain(
                    fmt.sem_tile_partials_plain(acts_ref[depth], S), sem,
                    n_rays, S)
                e6 = [rel_err(raw6, raw_ref), rel_err(sem6, sem_ref)]
                e7 = [rel_err(raw7, raw_ref), rel_err(sem7, sem_ref),
                      rel_err(sem_acts, sem_acts_ref)]
                e7 += [rel_err(a, b) for a, b in
                       zip(fmt.split_acts(acts, P, depth, width), acts_ref)]
                del raw_ref, acts_ref, sem_acts_ref
                head_ref, head_acts_ref = fmt.sem_head_plain(fpart, sem,
                                                             n_rays, S)
                eh = [rel_err(head, head_ref),
                      rel_err(head_acts, head_acts_ref)]
                ref = fmt.fused_nerf_bwd_acts_sem_plain(
                    params, pts, vd, g, gsem, acts, sem_acts, S, **kw)
                e8 = grad_err(fmt, grads, ref, depth)
                hflat_ref, hdfeat_ref = fmt.sem_head_bwd_plain(gsem, sem_acts,
                                                               sem, S)
                hg, hg_ref = (fmt.unpack_sem_grads(x, width, C)
                              for x in (hflat, hflat_ref))
                ehb = [max(((hg[k] - hg_ref[k]).abs().max()
                            / (hg_ref[k].abs().mean() + 1e-12)).item()
                           for k in hg_ref),
                       rel_err(hdfeat, hdfeat_ref)[1]]
                ehb_abs = max(max((hg[k] - hg_ref[k]).abs().max().item()
                                  for k in hg_ref),
                              rel_err(hdfeat, hdfeat_ref)[0])
                check([f.launches for f in launch_fns] == n_before,
                      "a plain version launched a kernel")
                check(not hdfeat[n_rays // 2:].any(),
                      "zero logit cotangents give zero feature cotangents")
                del acts, ref, grads, again, fpart
                torch.cuda.empty_cache()
                rels = {"fused_nerf_fwd_sem": max(e[1] for e in e6),
                        "fused_nerf_fwd_acts_sem": max(e[1] for e in e7),
                        "fused_nerf_bwd_acts_sem": e8[0],
                        "fused_nerf_sem_head": max(e[1] for e in eh),
                        "fused_nerf_sem_head_bwd": max(ehb)}
                abss = {"fused_nerf_fwd_sem": max(e[0] for e in e6),
                        "fused_nerf_fwd_acts_sem": max(e[0] for e in e7),
                        "fused_nerf_bwd_acts_sem": e8[1],
                        "fused_nerf_sem_head": max(e[0] for e in eh),
                        "fused_nerf_sem_head_bwd": ehb_abs}
                print(f"kernels 6-8 D={depth} N={n_rays} S={S} {name}: "
                      + ", ".join(f"{k[11:]} {v:.3g} (abs {abss[k]:.3g})"
                                  for k, v in rels.items())
                      + f"; logit scale {sem_ref.abs().max().item():.3g}; "
                      "tolerance " + ", ".join(
                          f"{v:g}" for v in SEM_TOL[name].values()),
                      flush=True)
                for k, v in rels.items():
                    check(v <= SEM_TOL[name][k],
                          f"{k} vs plain D={depth} N={n_rays} S={S} {name}")
                    err[k] = max(err[k], abss[k])
            del params, pts, vd, g, gsem
            torch.cuda.empty_cache()
    return err


def q8_gaps(got, ref):
    """(max abs err / max abs ref, mean abs err / mean abs ref, share of
    elements off by more than 1e-5 of max abs ref, max abs err)."""
    d = (got.double() - ref.double()).abs()
    scale = ref.double().abs().max().item()
    return (d.max().item() / scale,
            d.mean().item() / ref.double().abs().mean().item(),
            (d > 1e-5 * scale).double().mean().item(), d.max().item())


def q8_kernel_checks(fmt, NeRFMLP, dev, launch_fns, depths=(4, 8),
                     shapes=((4096, 64), (4096, 128), (32768, 64),
                             (32768, 128))):
    """Phase 3: kernel 10 and kernel 11 (its trunk and the semantic head kernel)
    against their twins at W=256, D=4 and D=8 skip@4, float32 and bfloat16,
    4,096 and 32,768 rays x S=64 and 128, C=19; kernel 11's raw equals
    kernel 10's bit for bit. Returns each kernel's largest max abs error."""
    import numpy as np
    import torch

    err = {"fused_nerf_fwd_q8": 0.0, "fused_nerf_fwd_q8_sem": 0.0}
    for depth in depths:
        for n_rays, S in shapes:
            params, pts, vd, _, _ = sem_inputs(NeRFMLP, dev, depth, n_rays, S,
                                               depth * 10 + S)
            trunk = {k: v for k, v in params.items()
                     if not k.startswith("semantic_")}
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype)[6:]
                kw = dict(depth=depth, width=256, multires=10,
                          multires_views=4, dtype=dtype, skips=(4,))
                pk = fmt.pack_params_q8(params, depth, dtype, dev, (4,))
                with torch.no_grad():
                    raw10 = fmt.fused_nerf_fwd_q8(trunk, pts, vd, S, packed=pk,
                                                  **kw)
                    raw11, sem11 = fmt.fused_nerf_fwd_q8_sem(
                        params, pts, vd, S, packed=pk, **kw)
                    torch.cuda.synchronize()
                    n_before = [f.launches for f in launch_fns]
                    ref, sem_ref = fmt.fused_nerf_fwd_q8_sem_plain(
                        params, pts, vd, S, packed=pk, **kw)
                check([f.launches for f in launch_fns] == n_before,
                      "a plain version launched a kernel")
                check(torch.equal(raw10, raw11), "kernels 10 and 11 give the same raw")
                g10, g11 = q8_gaps(raw10, ref), q8_gaps(sem11, sem_ref)
                print(f"kernels 10-11 D={depth} N={n_rays} S={S} {name}: raw "
                      f"max/max {g10[0]:.3g} mean/mean {g10[1]:.3g} share "
                      f"{g10[2]:.3g} (abs {g10[3]:.3g}); logits max/max "
                      f"{g11[0]:.3g} mean/mean {g11[1]:.3g} (abs {g11[3]:.3g}, "
                      f"scale {sem_ref.abs().max().item():.3g}); tolerance "
                      f"{Q8_TOL[name]}, logits {Q8_LOGIT_TOL[name]}", flush=True)
                check(all(np.isfinite(g10[:3])) and all(
                    g <= t for g, t in zip(g10[:3], Q8_TOL[name])),
                    f"kernel 10 vs plain D={depth} N={n_rays} S={S} {name}")
                check(all(g <= t for g, t in zip(g11[:2], Q8_LOGIT_TOL[name])),
                      f"kernel 11 logits vs plain D={depth} N={n_rays} S={S} {name}")
                err["fused_nerf_fwd_q8"] = max(err["fused_nerf_fwd_q8"], g10[3])
                err["fused_nerf_fwd_q8_sem"] = max(err["fused_nerf_fwd_q8_sem"],
                                                   g10[3], g11[3])
                del raw10, raw11, sem11, ref, sem_ref, pk
                torch.cuda.empty_cache()
            del params, trunk, pts, vd
            torch.cuda.empty_cache()
    return err


def q8_work(fmt, passes, semantic):
    """(int8 ops, FLOP in the compute dtype, bytes) of kernel 10 (or 11 with
    ``semantic``) over ``passes`` [(params, pts, S, depth)], bfloat16: each
    input read once, each output written once; the head of kernel 11 on its
    rays."""
    ops = flops = by = 0
    Wd, WH, e_p, e_v = 256, 128, 63, 27
    for params, pts, S, depth in passes:
        P = pts.shape[1]
        N = P // S
        ls = fmt.live_skips(depth, (4,))
        ops += 2 * ((depth - 1) * Wd * Wd + Wd * Wd + Wd * WH) * P
        flops += 2 * (e_p * Wd * (1 + len(ls)) + Wd + WH * 3) * P \
            + 2 * e_v * WH * N
        n_q8 = (depth - 1) * Wd * Wd + Wd * Wd + Wd * WH
        n_w = sum(v.numel() for k, v in params.items()
                  if not k.startswith("semantic_"))
        by += (3 * P + 3 * N + 4 * P) * 4 + n_q8 + (n_w - n_q8) * 2 \
            + -(-(depth + 1) // 8) * 8 * Wd * 4
        if semantic:
            C = params["semantic_1.bias"].numel()
            flops += 2 * (Wd * WH + WH * C) * N + Wd * P
            by += (Wd * WH + WH * C) * 2 + (WH + C) * 4 + N * C * 4
    return ops, flops, by


def q8_tile_weight_bytes(depth, n_skips, Wd=256, e_p=63, e_v=27):
    """Bytes of weights one 64-point tile of kernel 10 reads through L2
    (bfloat16): the int8 layers, the bf16 first layer and skip rows (padded
    to 64 encoding columns), the heads, the view layer's per-ray rows, the
    biases and the column scales."""
    WH, ep16 = Wd // 2, -(-e_p // 16) * 16
    n_q8 = (depth - 1) * Wd * Wd + Wd * Wd + Wd * WH
    side = ep16 * Wd * (1 + n_skips) + Wd + e_v * WH + WH * 3
    n_b = depth * Wd + 1 + Wd + WH + 3
    return n_q8 + 2 * side + 4 * n_b + 4 * -(-(depth + 1) // 8) * 8 * Wd


def q8_times(fmt, dev, passes, semantic, card, label):
    """Kernel 10 (or 11) and its twin over ``passes`` (bf16, weights packed
    once, as on the serving path): (ms, plain ms, bound ms, bound by)."""
    import torch

    fn = fmt.fused_nerf_fwd_q8_sem if semantic else fmt.fused_nerf_fwd_q8
    plain = (fmt.fused_nerf_fwd_q8_sem_plain if semantic
             else fmt.fused_nerf_fwd_q8_plain)
    packs = [fmt.pack_params_q8(p, d, torch.bfloat16, dev, (4,))
             for p, _, _, d in passes]

    def run(f):
        def go():
            for (p, pts, S, d), pk in zip(passes, packs):
                f(p, pts, vdt_of(pts, S), S, depth=d, width=256, multires=10,
                  multires_views=4, dtype=torch.bfloat16, skips=(4,), packed=pk)
        return go

    vds = {}

    def vdt_of(pts, S):
        key = (pts.data_ptr(), S)
        if key not in vds:
            g = torch.Generator(device=dev).manual_seed(S)
            vds[key] = torch.nn.functional.normalize(torch.randn(
                (3, pts.shape[1] // S), device=dev, generator=g), dim=0)
        return vds[key]

    with torch.no_grad():
        ms = cuda_ms(run(fn), reps=5)
        plain_ms = cuda_ms(run(plain), reps=2, warmup=1)
    ops, flops, by = q8_work(fmt, passes, semantic)
    t_ops = ops / PEAK_INT8_OPS + flops / PEAK_FLOPS["bfloat16"]
    t_bytes = by / PEAK_BYTES
    bound = max(t_ops, t_bytes) * 1e3
    by_ = "operations" if t_ops > t_bytes else "bytes"
    l2 = [(-(-pts.shape[1] // fmt.TILE), q8_tile_weight_bytes(d, len(fmt.live_skips(d, (4,)))))
          for _, pts, _, d in passes]
    print(f"{label} per frame (coarse + fine, bf16): {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, {ops / ms / 1e9:.1f} int8 TOPS + "
          f"{flops / ms / 1e9:.1f} TFLOP/s, bound {bound:.3f} ms ({by_}); weights "
          f"read through L2 {sum(n * b for n, b in l2) / 1e9:.1f} GB "
          f"({sum(n * b for n, b in l2) / ms / 1e9:.2f} TB/s; "
          f"{', '.join(f'{b / 1e6:.3f}' for _, b in l2)} MB a tile) on {card}", flush=True)
    return ms, plain_ms, bound, by_


def psnr(a, b):
    import math

    mse = ((a.float() - b.float()) ** 2).mean().item()
    return float("inf") if mse == 0 else -10.0 * math.log10(mse)


def int8_serving_phase(fmt, sc, renderer, dev, card, cfg, rcfg, models, poses,
                       ms_bf16, fns):
    """Phase 4b: ``configs/rgb_only.txt`` with ``render_int8`` set through
    ``eval_render_config`` on phase 4's field; then fine-only, fine-only +
    int8 and coarse-downsampled + int8 frames. Returns the numbers for the
    JSON lines and each kernel's launches on these main paths."""
    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.render.renderer import (pick_render_tile,
                                                            render_image)
    from depth_lidar_nerf_tpu_torch.train.config import eval_render_config
    from depth_lidar_nerf_tpu_torch.train.loop import render_path

    def zero():
        for fn in fns.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in fns.items()}

    out = {"card": card}
    launches = dict.fromkeys(fns, 0)
    with torch.no_grad():
        for m in models:
            m.sigma.bias += SIGMA_OFFSET - COMPARE_OFFSET  # phase 4's serving field
    ecfg = eval_render_config(cfg.replace(render_int8=True), rcfg)
    check(ecfg.render_int8 and not rcfg.render_int8,
          "render_int8 reaches the eval config only")
    n_tiles = -(-H * W // pick_render_tile(models.coarse, models.fine, ecfg,
                                           H * W))
    zero()
    rgbs, disps = render_path(models, poses, (H, W, FOCAL), ecfg, device=dev)
    torch.cuda.synchronize()
    got = counts()
    want = dict.fromkeys(fns, 0)
    want.update({"fused_nerf_fwd_q8": 2 * n_tiles * N_FRAMES,
                 sc.KERNEL: n_tiles * N_FRAMES})
    print(f"int8 serving: {N_FRAMES} frames {H}x{W}, launches {got}, "
          f"tiles/frame {n_tiles}")
    check(got == want, f"int8 serving launch counts, want {want}")
    check(rgbs.shape == (N_FRAMES, H, W, 3) and np.isfinite(rgbs).all()
          and np.isfinite(disps).all(), "finite int8 frames")
    launches = {k: launches[k] + got[k] for k in fns}
    torch.cuda.synchronize()
    t0 = time.time()
    render_path(models, poses, (H, W, FOCAL), ecfg, device=dev)
    torch.cuda.synchronize()
    ms_int8 = (time.time() - t0) * 1e3 / N_FRAMES
    print(f"int8 serving steady: {ms_int8:.1f} ms/frame, "
          f"{H * W * 1e3 / ms_int8:,.0f} rays/s; bf16 (phase 4) "
          f"{ms_bf16:.1f} ms/frame, {H * W * 1e3 / ms_bf16:,.0f} rays/s; "
          f"int8 / bf16 {ms_int8 / ms_bf16:.3f} on {card}", flush=True)
    profile_step(lambda: render_image(models.coarse, models.fine, H, W, FOCAL,
                                      poses[1], ecfg, device=dev), "int8 frame")
    out.update(ms_per_frame=ms_int8, rays_per_s=H * W * 1e3 / ms_int8,
               bf16_ms_per_frame=ms_bf16)

    # Quality: frame 0 on phase 4's comparison field, int8 against bf16.
    with torch.no_grad():
        for m in models:
            m.sigma.bias += COMPARE_OFFSET - SIGMA_OFFSET
    fb = render_image(models.coarse, models.fine, H, W, FOCAL, poses[0], rcfg,
                      device=dev)
    fq = render_image(models.coarse, models.fine, H, W, FOCAL, poses[0], ecfg,
                      device=dev)
    gaps = {}
    for k in ("rgb_map", "depth_map", "acc_map"):
        d = (fq[k].float() - fb[k].float()).abs()
        # (mean abs, max abs, rays off by more than 0.1: a ray whose last
        # sample's density is near 0 flips between empty and opaque)
        gaps[k] = (d.mean().item(), d.max().item(),
                   int((d.reshape(H * W, -1).amax(1) > 0.1).sum().item()))
    p = psnr(fq["rgb_map"], fb["rgb_map"])
    print(f"int8 frame 0 against the bf16 kernel frame (comparison field): "
          f"PSNR {p:.2f} dB; mean abs / max abs / rays off by > 0.1: "
          + ", ".join(f"{k} {a:.3g} / {b:.3g} / {n}"
                      for k, (a, b, n) in gaps.items())
          + f"; rgb mean limit {INT8_RGB_MEAN}", flush=True)
    check(gaps["rgb_map"][0] <= INT8_RGB_MEAN, "int8 rgb within JAX's atol")
    out.update(psnr_vs_bf16=p, gaps_vs_bf16=gaps)
    del fb, fq
    with torch.no_grad():
        for m in models:
            m.sigma.bias += SIGMA_OFFSET - COMPARE_OFFSET

    # The modes that compose with int8, one frame each on the serving field.
    modes = {"fine_only": cfg.replace(render_fine_only=True),
             "fine_only_int8": cfg.replace(render_fine_only=True,
                                           render_int8=True),
             "downsample2_int8": cfg.replace(render_coarse_downsample=2,
                                             render_int8=True)}
    out["modes"] = {}
    for name, mcfg in modes.items():
        vcfg = eval_render_config(mcfg, rcfg)
        zero()
        frame = render_image(models.coarse, models.fine, H, W, FOCAL,
                             poses[1], vcfg, device=dev)
        torch.cuda.synchronize()
        got = counts()
        tile = pick_render_tile(models.coarse, models.fine,
                                dataclasses.replace(vcfg, render_fine_only=True),
                                H * W)
        nt = -(-H * W // tile)
        kern = "fused_nerf_fwd_q8" if vcfg.render_int8 else "fused_nerf_fwd"
        want = dict.fromkeys(fns, 0)
        if vcfg.render_coarse_downsample > 1:
            want.update({kern: 1 + nt, sc.KERNEL: 1})
        else:
            want.update({kern: 2 * nt, sc.KERNEL: nt})
        check(got == want, f"{name} launch counts {got}, want {want}")
        check(all(torch.isfinite(frame[k]).all().item()
                  for k in ("rgb_map", "acc_map", "depth_map")),
              f"finite {name} frame")
        launches = {k: launches[k] + got[k] for k in fns}
        torch.cuda.synchronize()
        t0 = time.time()
        render_image(models.coarse, models.fine, H, W, FOCAL, poses[1], vcfg,
                     device=dev)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        print(f"{name}: {ms:.1f} ms/frame, {H * W * 1e3 / ms:,.0f} rays/s, "
              f"launches {got} on {card}", flush=True)
        out["modes"][name] = {"ms_per_frame": ms, "launches": got}
        del frame
    torch.cuda.empty_cache()
    return out, launches


def int8_semantic_serving(fmt, sc, renderer, dev, card, cfg, rcfg, sm, pose,
                          frame, ms_frame, fns):
    """Phase 10b: one frame of the seeded semantic stack with ``render_int8``
    at ``chunk`` 32,768, against phase 10's bf16 ``frame``; kernel 11's
    times at the serving shapes. At that chunk the D=8 fine tile is beyond
    the saved-activation cap, where the bf16 frame takes the plain module;
    the int8 pass saves no activations, so it takes kernel 11, as in JAX."""
    import torch

    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train.config import eval_render_config

    S_c = rcfg.N_samples
    S_f = rcfg.N_samples + rcfg.N_importance
    rq = dataclasses.replace(
        eval_render_config(cfg.replace(render_int8=True), rcfg),
        chunk=INT8_CHUNK)
    check(not sm.fine.supports_raw_semantic(rq, n_points=INT8_CHUNK * S_f,
                                            S=S_f)
          and renderer._semantic_ok(sm.fine, rq, INT8_CHUNK, S_f),
          "kernel 11 takes the D=8 fine tile of a chunk-32768 int8 frame")
    nq = -(-H * W // INT8_CHUNK)
    for fn in fns.values():
        fn.launches = 0
    fq = render_image(sm.coarse, sm.fine, H, W, FOCAL, pose, rq, device=dev)
    torch.cuda.synchronize()
    q_launches = {k: fn.launches for k, fn in fns.items()}
    want = dict.fromkeys(fns, 0)
    want.update({"fused_nerf_fwd_q8_sem": 2 * nq, "fused_nerf_sem_head": 2 * nq,
                 sc.KERNEL: nq})
    print(f"int8 semantic serving launches, one {H}x{W} frame in {nq} tiles: "
          f"{q_launches}")
    check(q_launches == want, f"int8 semantic serving launch counts, want {want}")
    torch.cuda.synchronize()
    t0 = time.time()
    render_image(sm.coarse, sm.fine, H, W, FOCAL, pose, rq, device=dev)
    torch.cuda.synchronize()
    ms_q = (time.time() - t0) * 1e3
    q_err = {}
    for key in ("rgb_map", "depth_map", "acc_map", "sem_preds"):
        ref = frame[key].float()
        d = (fq[key].float() - ref).abs()
        q_err[key] = (d.max().item() / (ref.abs().max().item() + 1e-30),
                      d.mean().item() / (ref.abs().mean().item() + 1e-30))
        check(torch.isfinite(fq[key]).all().item()
              and q_err[key][1] <= INT8_SEM_FRAME_MEAN[key],
              f"int8 semantic frame {key} against the bf16 frame")
    print(f"int8 semantic serving: {ms_q:.1f} ms/frame, "
          f"{H * W * 1e3 / ms_q:,.0f} rays/s (bf16 frame at chunk {SEM_CHUNK}: "
          f"{ms_frame:.1f} ms); against the bf16 frame, max over max / mean "
          "over mean: " + ", ".join(f"{k} {a:.3g} / {b:.3g}"
                                    for k, (a, b) in q_err.items())
          + f" (mean limits {INT8_SEM_FRAME_MEAN}); rgb PSNR "
          f"{psnr(fq['rgb_map'], frame['rgb_map']):.2f} dB on {card}", flush=True)
    out = {"int8_serving": {"ms_per_frame": ms_q, "rays_per_s": H * W * 1e3 / ms_q,
                            "launches": q_launches, "vs_bf16_frame": q_err,
                            "card": card}}
    del fq
    # Kernel 11 at the serving shapes: the seeded stack on a frame's rays.
    g = torch.Generator(device=dev).manual_seed(11)
    N = H * W
    ro = torch.randn((N, 3), device=dev, generator=g)
    vd = torch.nn.functional.normalize(torch.randn((N, 3), device=dev,
                                                   generator=g), dim=-1)
    passes = []
    for m, S in ((sm.coarse, S_c), (sm.fine, S_f)):
        z = torch.sort(torch.rand((N, S), device=dev, generator=g), -1).values
        pts = (ro.T[:, :, None] + vd.T[:, :, None] * z[None]).reshape(3, N * S)
        passes.append(({k: v.detach() for k, v in m.named_parameters()},
                       pts.contiguous(), S, m.depth))
    out["q8_sem_times"] = q8_times(fmt, dev, passes, True, card,
                                   "fused_nerf_fwd_q8_sem")
    return out, q_launches


def kernel_fns(fmt, sc):
    """Every kernel wrapper with a launch counter, by kernel name."""
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm

    return {"fused_nerf_fwd": fmt.fused_nerf_fwd,
            "fused_nerf_fwd_acts": fmt.fused_nerf_fwd_acts,
            "fused_nerf_bwd": fmt.fused_nerf_bwd,
            "fused_nerf_bwd_culled": fmt.fused_nerf_bwd_culled,
            "fused_nerf_bwd_acts": fmt.fused_nerf_bwd_acts,
            "fused_nerf_fwd_sem": fmt.fused_nerf_fwd_sem,
            "fused_nerf_fwd_acts_sem": fmt.fused_nerf_fwd_acts_sem,
            "fused_nerf_bwd_acts_sem": fmt.fused_nerf_bwd_acts_sem,
            "fused_nerf_sem_head": fmt.sem_head,
            "fused_nerf_sem_head_bwd": fmt.sem_head_bwd,
            "fused_nerf_grad_reduce": fmt.grad_reduce,
            "fused_nerf_bwd_chain": fmt.fused_nerf_bwd_chain,
            "fused_nerf_bwd_weight_grads": fmt.bwd_weight_grads,
            "fused_nerf_fwd_q8": fmt.fused_nerf_fwd_q8,
            "fused_nerf_fwd_q8_sem": fmt.fused_nerf_fwd_q8_sem,
            "fused_nerf_fwd_cf": fmt.fused_nerf_fwd_cf,
            "fused_nerf_packed_fwd": fm.fused_packed_fwd,
            "fused_nerf_packed_bwd": fm.fused_packed_bwd,
            "fused_nerf_packed_chain": fm.fused_packed_chain,
            "fused_nerf_packed_weight_grads": fm.packed_wgrad,
            sc.KERNEL: sc.inverse_cdf}


def semantic_phases(fmt, sc, renderer, dev, card, plain_sampler):
    """Phases 9-11 (see the module note). Returns the numbers for the JSON
    lines: training, serving, each kernel's launches on these main paths,
    and each semantic kernel's (ms, plain ms, bound ms, bound by)."""
    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train.state import init_train_state
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    fns = kernel_fns(fmt, sc)
    out = {}

    # ---- 9. semantic training ----------------------------------------------
    t0 = time.time()
    cfg, rcfg, sm, tables, scene = bench_stack(dev, TRAIN_N_RAYS, "bfloat16",
                                               semantic=True)
    seeded = [{k: v.detach().clone() for k, v in m.state_dict().items()}
              for m in sm]
    state = init_train_state(cfg, sm)
    step = make_train_step(cfg, rcfg, sm, scene.hwf)
    print(f"semantic training: ref_default_semantic_two_mlp stack built in "
          f"{time.time() - t0:.1f} s ({tables[0].origins.shape[0]} rgb rays, "
          f"{tables[1].origins.shape[0]} depth rays, {scene.num_classes} "
          f"classes)", flush=True)
    for fn in fns.values():
        fn.launches = 0
    gen = torch.Generator(device=dev).manual_seed(0)
    metrics = [step(state, *tables, gen) for _ in range(5)]
    ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
    ev0.record()
    metrics += [step(state, *tables, gen) for _ in range(20)]
    ev1.record()
    torch.cuda.synchronize()
    ms_step = ev0.elapsed_time(ev1) / 20
    launches = {k: fn.launches for k, fn in fns.items()}
    n = 25
    want = dict.fromkeys(fns, 0)
    # Kernel 8's split backward: 2^20 coarse and 2^21 fine points a step,
    # 4 + 8 chunks of BWD_CHUNK, one launch of each phase a chunk.
    n_chunks = sum(-(-TRAIN_N_RAYS * S // fmt.BWD_CHUNK) for S in (64, 128))
    want.update({"fused_nerf_fwd_acts_sem": 2 * n, "fused_nerf_bwd_acts_sem": 2 * n,
                 "fused_nerf_sem_head": 2 * n, "fused_nerf_sem_head_bwd": 2 * n,
                 "fused_nerf_grad_reduce": 4 * n, sc.KERNEL: n,
                 "fused_nerf_bwd_chain": n_chunks * n,
                 "fused_nerf_bwd_weight_grads": n_chunks * n})
    print(f"semantic training launches over {n} steps: {launches}", flush=True)
    check(launches == want, f"semantic training launch counts, want {want}")
    vals = [{k: v.item() for k, v in m.items()} for m in metrics]
    check(all(np.isfinite(v) for m in vals for v in m.values()),
          "finite semantic metrics")
    falls = {}
    for key in ("loss", "semantic_loss", "semantic_loss0"):
        seq = [m[key] for m in vals]
        first, last = float(np.mean(seq[:10])), float(np.mean(seq[15:]))
        falls[key] = (first, last)
        print(f"semantic training {key} per step: "
              + " ".join(f"{x:.4f}" for x in seq)
              + f"; mean steps 1-10 {first:.5f}, steps 16-25 {last:.5f}")
    check(falls["loss"][1] < falls["loss"][0], "semantic training loss falls")
    check(falls["semantic_loss"][1] < falls["semantic_loss"][0],
          "semantic cross-entropy falls")
    print(f"semantic training steady: {ms_step:.1f} ms/step, "
          f"{TRAIN_N_RAYS * 1e3 / ms_step:,.0f} rays/s on {card}", flush=True)
    profile_step(lambda: step(state, *tables, gen), "semantic step")

    captured = []
    orig = fmt._bwd_acts_sem_dparams

    def capture(*a, **k):
        captured.append(a)
        return orig(*a, **k)

    with mock.patch.object(fmt, "_bwd_acts_sem_dparams", capture):
        step(state, *tables, gen)
    torch.cuda.synchronize()
    out["training"] = {"ms_per_step": ms_step,
                       "rays_per_s": TRAIN_N_RAYS * 1e3 / ms_step,
                       "losses": [m["loss"] for m in vals],
                       "semantic_losses": [m["semantic_loss"] for m in vals],
                       "launches": launches, "card": card}
    del state, step, metrics
    torch.cuda.empty_cache()
    print(f"phase 9 done at {time.time() - T_START:.0f} s", flush=True)

    # ---- 10. semantic serving ----------------------------------------------
    # The seeded stack: its density reaches nearly every ray of the frame,
    # where the 25 steps above leave three quarters of the rays empty.
    for m, sd in zip(sm, seeded):
        m.load_state_dict(sd)
    rv = dataclasses.replace(rcfg, chunk=SEM_CHUNK)
    S_c, S_f = rv.N_samples, rv.N_samples + rv.N_importance
    check(sm.coarse.supports_raw_semantic(rv, n_points=SEM_CHUNK * S_c, S=S_c)
          and sm.fine.supports_raw_semantic(rv, n_points=SEM_CHUNK * S_f, S=S_f),
          "kernel 6 takes both passes of a chunk-16384 tile")
    check(not sm.fine.supports_raw_semantic(rv, n_points=32768 * S_f, S=S_f),
          "a chunk-32768 fine tile is beyond the D=8 cap (plain module, as JAX)")
    pose = scene.poses[1]
    n_tiles = -(-H * W // SEM_CHUNK)
    for fn in fns.values():
        fn.launches = 0
    frame = render_image(sm.coarse, sm.fine, H, W, FOCAL, pose, rv, device=dev)
    torch.cuda.synchronize()
    s_launches = {k: fn.launches for k, fn in fns.items()}
    want = dict.fromkeys(fns, 0)
    want.update({"fused_nerf_fwd_sem": 2 * n_tiles,
                 "fused_nerf_sem_head": 2 * n_tiles, sc.KERNEL: n_tiles})
    print(f"semantic serving launches, one {H}x{W} frame in {n_tiles} tiles: "
          f"{s_launches}")
    check(s_launches == want, f"semantic serving launch counts, want {want}")
    check(frame["sem_preds"].shape == (H, W, SEM_CLASSES)
          and frame["rgb_map"].shape == (H, W, 3), "semantic frame shapes")
    # (disp_map is 0/0 on an empty ray, as in the reference.)
    bad = {k: int((~torch.isfinite(v)).sum()) for k, v in frame.items()}
    acc = frame["acc_map"].flatten().float()
    empty = (acc == 0).float().mean().item()
    qs = torch.quantile(acc, torch.tensor([0.0, 0.1, 0.5, 0.9, 1.0],
                                          device=dev)).tolist()
    print(f"semantic frame non-finite values by map: {bad}; acc quantiles "
          "0/10/50/90/100%: " + " ".join(f"{q:.3f}" for q in qs)
          + f", empty rays {int((acc == 0).sum().item())} (share {empty:.5f}, "
          f"limit {SEM_EMPTY_MAX:g})")
    check(not any(bad[k] for k in ("rgb_map", "depth_map", "acc_map",
                                   "sem_preds", "rgb0", "acc0")),
          "finite semantic frame")
    check(empty <= SEM_EMPTY_MAX, "semantic frame has few empty rays")
    torch.cuda.synchronize()
    t0 = time.time()
    render_image(sm.coarse, sm.fine, H, W, FOCAL, pose, rv, device=dev)
    torch.cuda.synchronize()
    ms_frame = (time.time() - t0) * 1e3
    print(f"semantic serving: {ms_frame:.1f} ms/frame, "
          f"{H * W * 1e3 / ms_frame:,.0f} rays/s on {card}")

    frames = {("kernel", d): render_image(
        *path_models(cfg, rcfg, sm, d, False, dev), H, W, FOCAL, pose, rv,
        device=dev) for d in ("float32", "bfloat16")}
    n_before = [fn.launches for fn in fns.values()]
    with mock.patch.object(renderer, "sample_pdf_cuda", plain_sampler):
        for d in ("float32", "bfloat16"):
            frames["plain", d] = render_image(
                *path_models(cfg, rcfg, sm, d, True, dev), H, W, FOCAL, pose,
                rv, device=dev)
    check([fn.launches for fn in fns.values()] == n_before,
          "the plain semantic render launched a kernel")
    frame_err = {}
    for key in ("rgb_map", "depth_map", "acc_map", "sem_preds"):
        gaps = {}
        for name, a, b in (("float32", ("kernel", "float32"), ("plain", "float32")),
                           ("bfloat16", ("kernel", "bfloat16"), ("plain", "bfloat16")),
                           ("plain_bf16_vs_f32", ("plain", "bfloat16"),
                            ("plain", "float32"))):
            ref = frames[b][key].float()
            d = (frames[a][key].float() - ref).abs()
            # (max abs, mean abs, max over max, mean over mean)
            gaps[name] = (d.max().item(), d.mean().item(),
                          d.max().item() / (ref.abs().max().item() + 1e-30),
                          d.mean().item() / (ref.abs().mean().item() + 1e-30))
        frame_err[key] = gaps
        f32, b16, low = (gaps[k] for k in ("float32", "bfloat16",
                                           "plain_bf16_vs_f32"))
        print(f"semantic frame {key}, kernel vs plain: float32 max abs "
              f"{f32[0]:.3g} mean {f32[1]:.3g} (over max {f32[2]:.3g}, mean "
              f"over mean {f32[3]:.3g}); bfloat16 max abs {b16[0]:.3g} mean "
              f"{b16[1]:.3g} (over max {b16[2]:.3g}, mean over mean "
              f"{b16[3]:.3g}); for scale, plain bfloat16 vs plain float32 max "
              f"abs {low[0]:.3g} mean {low[1]:.3g} (mean over mean "
              f"{low[3]:.3g}); tolerance {SEM_FRAME_TOL[key]}")
        check(f32[2] <= SEM_FRAME_TOL[key][0]
              and f32[3] <= SEM_FRAME_TOL[key][1],
              f"semantic frame {key} kernel vs plain, float32")
        check(b16[3] <= SEM_FRAME_TOL[key][2],
              f"semantic frame {key} kernel vs plain, bfloat16")
    del frames
    out["serving"] = {"ms_per_frame": ms_frame,
                      "rays_per_s": H * W * 1e3 / ms_frame,
                      "launches": s_launches, "empty_share": empty,
                      "frame_kernel_vs_plain": frame_err, "card": card}
    print(f"phase 10 done at {time.time() - T_START:.0f} s", flush=True)

    q_out, q_launches = int8_semantic_serving(
        fmt, sc, renderer, dev, card, cfg, rcfg, sm, pose, frame, ms_frame, fns)
    out.update(q_out)
    out["launches"] = {k: launches[k] + s_launches[k] + q_launches[k]
                       for k in fns}
    del sm, tables, frame
    torch.cuda.empty_cache()
    print(f"phase 10b done at {time.time() - T_START:.0f} s", flush=True)

    # ---- 11a. semantic kernel times at the step's shapes (bf16) -------------
    passes = []
    for a in sorted(captured, key=lambda a: a[-2].depth):  # coarse, fine
        params, pts, vd, acts, sem_acts, g, gsem, spec = a[:8]
        params = {k: v.detach() for k, v in params.items()}
        pk = fmt.pack_params(params, spec.depth, spec.dtype, dev)
        P = pts.shape[1]
        feat = fmt.split_acts(acts, P, spec.depth, 256)[spec.depth]
        passes.append(dict(params=params, pts=pts, vd=vd, acts=acts,
                           sem_acts=sem_acts, g=g, gsem=gsem, spec=spec,
                           pk=pk, fpart=fmt.sem_tile_partials_plain(feat, spec.S)))
    del captured

    def each(fn):
        def run():
            for q in passes:
                fn(q)
        return run

    t = {}
    with torch.no_grad():
        t["fused_nerf_fwd_sem"] = (
            cuda_ms(each(lambda q: fmt.fused_nerf_fwd_sem(
                q["params"], q["pts"], q["vd"], q["spec"].S, packed=q["pk"],
                **q["spec"].kw())), 3),
            cuda_ms(each(lambda q: fmt.fused_nerf_fwd_sem_plain(
                q["params"], q["pts"], q["vd"], q["spec"].S,
                **q["spec"].kw())), 1, 1))
        torch.cuda.empty_cache()
        t["fused_nerf_fwd_acts_sem"] = (
            cuda_ms(each(lambda q: fmt.fused_nerf_fwd_acts_sem(
                q["params"], q["pts"], q["vd"], q["spec"].S, packed=q["pk"],
                **q["spec"].kw())), 3),
            cuda_ms(each(lambda q: fmt.fused_nerf_fwd_acts_sem_plain(
                q["params"], q["pts"], q["vd"], q["spec"].S,
                **q["spec"].kw())), 1, 1))
        torch.cuda.empty_cache()
        t["fused_nerf_bwd_acts_sem"] = (
            cuda_ms(each(lambda q: fmt.fused_nerf_bwd_acts_sem(
                q["params"], q["pts"], q["vd"], q["g"], q["gsem"], q["acts"],
                q["sem_acts"], q["spec"].S, packed=q["pk"],
                **q["spec"].kw())), 3, 1),
            cuda_ms(each(lambda q: fmt.fused_nerf_bwd_acts_sem_plain(
                q["params"], q["pts"], q["vd"], q["g"], q["gsem"], q["acts"],
                q["sem_acts"], q["spec"].S, **q["spec"].kw())), 1, 1))
        torch.cuda.empty_cache()
        t["fused_nerf_sem_head"] = (
            cuda_ms(each(lambda q: fmt.sem_head(
                q["fpart"], q["pk"].sem, q["gsem"].shape[0], q["spec"].S,
                save=True)), 20),
            cuda_ms(each(lambda q: fmt.sem_head_plain(
                q["fpart"], q["pk"].sem, q["gsem"].shape[0], q["spec"].S)), 5))
        t["fused_nerf_sem_head_bwd"] = (
            cuda_ms(each(lambda q: fmt.sem_head_bwd(
                q["gsem"], q["sem_acts"], q["pk"].sem, q["spec"].S)), 20),
            cuda_ms(each(lambda q: fmt.sem_head_bwd_plain(
                q["gsem"], q["sem_acts"], q["pk"].sem, q["spec"].S)), 5))
    work = dict.fromkeys(t, (0.0, 0.0))  # (FLOP, bytes) of this run's inputs

    def add(k, fl, by):
        work[k] = (work[k][0] + fl, work[k][1] + by)

    Wd, C = 256, SEM_CLASSES
    WH = Wd // 2
    for q in passes:
        spec, pk = q["spec"], q["pk"]
        P, S = q["pts"].shape[1], spec.S
        N = P // S
        n_w, n_b = pk.weights.numel(), pk.biases.numel()
        n_sem = Wd * WH + WH + WH * C + C
        ls = fmt.live_skips(spec.depth, spec.skips)
        head_fl = 2 * (Wd * WH + WH * C) * N + Wd * P
        head_bwd_fl = 4 * (Wd * WH + WH * C) * N
        io = (3 * P + 3 * N + 4 * P) * 4 + n_w * 2 + n_sem * 2
        acts_b = q["acts"].numel() * 2
        sem_acts_b = N * (Wd + WH) * 2
        fpart_b = q["fpart"].numel() * 4  # every slot is one the head reads
        fwd = 2 * mlp_macs(spec.depth, Wd, 63, 27, ls, S) * P
        add("fused_nerf_fwd_sem", fwd + head_fl, io + N * C * 4)
        add("fused_nerf_fwd_acts_sem", fwd + head_fl,
            io + N * C * 4 + acts_b + sem_acts_b)
        add("fused_nerf_bwd_acts_sem",
            2 * bwd_macs(spec.depth, Wd, 63, 27, ls, S) * P + head_bwd_fl,
            io + n_w * 2 + acts_b + sem_acts_b + N * C * 4
            + (n_w + n_b + n_sem) * 4)
        add("fused_nerf_sem_head", head_fl,
            fpart_b + n_sem * 2 + N * C * 4 + sem_acts_b)
        add("fused_nerf_sem_head_bwd", head_bwd_fl,
            N * C * 4 + sem_acts_b + n_sem * 2 + N * Wd * 2 + n_sem * 4)
    bounds = {}
    for k, (fl, by) in work.items():
        t_ops, t_bytes = fl / PEAK_FLOPS["bfloat16"], by / PEAK_BYTES
        bounds[k] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops > t_bytes else "bytes")
        print(f"{k} at the semantic step's shapes (bf16, coarse + fine): "
              f"{t[k][0]:.3f} ms, plain {t[k][1]:.3f} ms, "
              f"{fl / t[k][0] / 1e9:.2f} TFLOP/s, bound {bounds[k][0]:.4f} ms "
              f"({bounds[k][1]}) on {card}", flush=True)
    out["times"] = {k: (t[k][0], t[k][1]) + bounds[k] for k in t}
    q = passes[-1]  # the fine pass (D=8 skip@4)
    out["split_memory"] = split_memory(
        fmt, "kernel 8 (fine pass of the semantic step)",
        lambda: fmt.fused_nerf_bwd_acts_sem(
            q["params"], q["pts"], q["vd"], q["g"], q["gsem"], q["acts"],
            q["sem_acts"], q["spec"].S, packed=q["pk"], **q["spec"].kw()),
        q["pts"].shape[1], q["spec"].depth)
    del q
    # Each pass alone, beside kernels 1 and 4 on the same points without the
    # head (what the semantic variants add).
    with torch.no_grad():
        for q in passes:
            kw, S = q["spec"].kw(), q["spec"].S
            trunk = {k: v for k, v in q["params"].items()
                     if not k.startswith("semantic_")}
            pk = fmt.pack_params(trunk, q["spec"].depth, q["spec"].dtype, dev)
            one = {
                "kernel 1": lambda: fmt.fused_nerf_fwd(trunk, q["pts"], q["vd"], S,
                                                       packed=pk, **kw),
                "kernel 4": lambda: fmt.fused_nerf_fwd_acts(
                    trunk, q["pts"], q["vd"], S, packed=pk, **kw),
                "kernel 6": lambda: fmt.fused_nerf_fwd_sem(
                    q["params"], q["pts"], q["vd"], S, packed=q["pk"], **kw),
                "kernel 7": lambda: fmt.fused_nerf_fwd_acts_sem(
                    q["params"], q["pts"], q["vd"], S, packed=q["pk"], **kw),
                "kernel 8": lambda: fmt.fused_nerf_bwd_acts_sem(
                    q["params"], q["pts"], q["vd"], q["g"], q["gsem"], q["acts"],
                    q["sem_acts"], S, packed=q["pk"], **kw)}
            # The MLP's FLOP (a semantic head adds under 1/S of a point's).
            d, P = q["spec"].depth, q["pts"].shape[1]
            ls = fmt.live_skips(d, kw["skips"])
            fl_f = 2 * mlp_macs(d, kw["width"], 63, 27, ls, S) * P
            fl = {"kernel 8": 2 * bwd_macs(d, kw["width"], 63, 27, ls, S) * P}
            ms = {k: cuda_ms(f, 3) for k, f in one.items()}
            print(f"semantic step pass D={d} P={P} (bf16): " + ", ".join(
                f"{k} {ms[k]:.3f} ms ({fl.get(k, fl_f) / ms[k] / 1e9:.1f} TFLOP/s)"
                for k in one), flush=True)
            # Half the points: whether saving activations costs by depth or
            # by the size of the buffer it writes.
            half = P // 2
            pts_h = q["pts"][:, :half].contiguous()
            vd_h = q["vd"][:, :half // S].contiguous()
            t1, t4 = (cuda_ms(lambda f=f: f(trunk, pts_h, vd_h, S, packed=pk,
                                            **kw), 3)
                      for f in (fmt.fused_nerf_fwd, fmt.fused_nerf_fwd_acts))
            print(f"  first half of the pass (P={half}): kernel 1 {t1:.3f} ms "
                  f"({fl_f / 2 / t1 / 1e9:.1f} TFLOP/s), kernel 4 {t4:.3f} ms "
                  f"({fl_f / 2 / t4 / 1e9:.1f} TFLOP/s)", flush=True)
            torch.cuda.empty_cache()
    del passes
    torch.cuda.empty_cache()
    print(f"phase 11a done at {time.time() - T_START:.0f} s", flush=True)

    # ---- 11b. semantic trajectory: kernel path against plain path -----------
    out["trajectory"] = trajectories("semantic trajectory", SEM_TRAJ_TOL, dev,
                                     list(fns.values()), renderer,
                                     plain_sampler, semantic=True)
    print(f"phase 11b done at {time.time() - T_START:.0f} s", flush=True)
    return out


def packed_macs(depth, width, e_p=63, e_v=27):
    """Multiply-adds per point of kernel 12: the first layer over the
    position lanes, the trunk, the feature and sigma columns, the view layer
    over the feature and the view lanes, the rgb head."""
    return (e_p * width + (depth - 1) * width * width + width * (width + 1)
            + (width + e_v) * (width // 2) + (width // 2) * 3)


def packed_inputs(NeRFMLP, fm, dev, depth, n_rays, S):
    """Phase 3's seeded inputs of kernels 12 and 13 at W=256: the
    parameters, points ``[Nf, S, 3]`` and view directions ``[Nf, 3]`` of
    ``n_rays`` rays padded as ``fused_nerf_apply_raw`` pads them (to
    ``Nf``), and a cotangent ``[Nf S, 8]``."""
    import numpy as np
    import torch

    g = torch.Generator().manual_seed(depth * 100 + S)
    m = NeRFMLP(depth=depth, width=256, generator=g).to(dev)
    with torch.no_grad():
        m.sigma.bias += 0.5
    params = {k: v.detach() for k, v in m.named_parameters()}
    rng = np.random.default_rng(depth * 100 + S)
    Nf = n_rays + (-n_rays) % (fm.TILE // S)
    pts = torch.from_numpy(rng.uniform(-1, 1, (Nf, S, 3)).astype(np.float32)).to(dev)
    vd = torch.nn.functional.normalize(torch.from_numpy(rng.normal(
        size=(Nf, 3)).astype(np.float32)), dim=-1).to(dev)
    gt = torch.randn((Nf * S, 8), device=dev, generator=torch.Generator(
        device=dev).manual_seed(S))
    return params, pts, vd, gt


def packed_gaps(fmt, fm, params, depth, got, ref, dws, ref_d):
    """Kernel 12's raw against its twin's (max abs error over max abs) and
    kernel 13's gradients per block (max abs error over mean abs, mean abs
    error over mean abs, max abs error): PACKED_TOL's three numbers."""
    e12 = rel_err(got, ref)
    W = params["trunk_0.weight"].shape[0]
    got_g, ref_g = (fmt.grad_blocks(fm.unpack_grads(d, params, depth, 63, 27), depth, W,
                                    10, ()) for d in (dws, ref_d))
    mx = max(((got_g[k] - ref_g[k]).abs().max()
              / (ref_g[k].abs().mean() + 1e-12)).item() for k in ref_g)
    mn = max(((got_g[k] - ref_g[k]).abs().mean()
              / (ref_g[k].abs().mean() + 1e-12)).item() for k in ref_g)
    return e12, mx, mn, max((got_g[k] - ref_g[k]).abs().max().item() for k in ref_g)


def packed_kernel_checks(fm, fmt, NeRFMLP, dev, launch_fns):
    """Phase 3, kernels 12 and 13 against their twins at W=256, D=4 and 2,
    float32 and bfloat16, 8,192 rays x S=64 and 1,000 rays x S=8 (padded as
    ``fused_nerf_apply_raw`` pads), within PACKED_TOL; in bfloat16 at 8,192
    x 64 also the witnesses and phase 2 (:func:`packed_split_checks`).
    Returns each kernel's (and kernel 13's phases') largest max abs
    error."""
    import numpy as np
    import torch

    err = {"fused_nerf_packed_fwd": 0.0, "fused_nerf_packed_bwd": 0.0,
           "fused_nerf_packed_chain": 0.0, "fused_nerf_packed_weight_grads": 0.0}
    for depth in (4, 2):
        for n_rays, S in PACKED_SHAPES:
            params, pts, vd, gt = packed_inputs(NeRFMLP, fm, dev, depth, n_rays, S)
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype)[6:]
                x = fm.pack_encoding(pts, vd, 10, 4, dtype)
                ws = fm.pack_params(params, depth, 63, 27, dtype, dev)
                kw = dict(depth=depth, e_p=63, e_v=27, dtype=dtype)
                out = fm.fused_packed_fwd(ws, x, **kw)
                dws = fm.fused_packed_bwd(ws, x, gt, **kw)
                torch.cuda.synchronize()
                n_before = [f.launches for f in launch_fns]
                ref = fm.fused_packed_fwd_plain(ws, x, depth, dtype, e_p=63, e_v=27)
                ref_d = fm.fused_packed_bwd_plain(ws, x, gt, depth, dtype, e_p=63,
                                                  e_v=27)
                check([f.launches for f in launch_fns] == n_before,
                      "a plain version launched a kernel")
                e12, mx, mn, e13 = packed_gaps(fmt, fm, params, depth, out, ref, dws,
                                               ref_d)
                tol = PACKED_TOL[name]
                print(f"kernels 12-13 D={depth} N={n_rays} S={S} {name}: fwd "
                      f"{e12[1]:.3g} (abs {e12[0]:.3g}), bwd max/mean {mx:.3g} "
                      f"mean/mean {mn:.3g} (abs {e13:.3g}); tolerance {tol}",
                      flush=True)
                check(np.isfinite(e12[1]) and e12[1] <= tol[0],
                      f"kernel 12 vs plain D={depth} N={n_rays} S={S} {name}")
                check(np.isfinite(mx) and mx <= tol[1] and mn <= tol[2],
                      f"kernel 13 vs plain D={depth} N={n_rays} S={S} {name}")
                err["fused_nerf_packed_fwd"] = max(err["fused_nerf_packed_fwd"],
                                                   e12[0])
                err["fused_nerf_packed_bwd"] = max(err["fused_nerf_packed_bwd"],
                                                   e13)
                del out, dws, ref, ref_d
                if dtype == torch.bfloat16 and S == 64:
                    for k, e in packed_split_checks(fm, fmt, ws, x, gt, depth,
                                                    launch_fns).items():
                        err[k] = max(err[k], e)
                del x, ws
                torch.cuda.empty_cache()
            del params, pts, vd, gt
            torch.cuda.empty_cache()
    return err


def packed_split_checks(fm, fmt, ws, x, g, depth, launch_fns):
    """Phase 3, kernel 13's split in bfloat16 on all of ``x``'s points in
    one chunk: kernel 12's tile (the chain's recompute writes its
    activations) and the chain's cotangents against their float64 witnesses
    (``fm.packed_fwd_witness``, ``fm.packed_bwd_witness``: summed over the
    layers, rounded otherwise no more often than by float32 products,
    WITNESS_RATIO); phase 2 on the chain's buffers against its twin within
    WGRAD_TOL of its output's max abs. Returns each phase's max abs error
    (the chain's: its small gradients against its twin's)."""
    import torch

    P, W = x.shape[0], ws[0].shape[1]
    kw = fm.kernel_weights(ws, depth, 63, 27)
    stride = -(-kw.grad_numel // 4) * 4
    part = torch.zeros((fmt._grid(x.device, 1 << 30), stride), device=x.device)
    # hv, which no phase reads, only for the forward witness
    hv = torch.empty((P * W // 2,), dtype=torch.bfloat16, device=x.device)
    acts, cot = fm.fused_packed_chain(ws, x, g, 0, P, part, depth=depth, e_p=63,
                                      e_v=27, dtype=torch.bfloat16, kw=kw, hv=hv)
    ents = fm.packed_wgrad_entries(x, acts, cot, 0, P, depth, W, 63, 27,
                                   fm.grad_offsets(ws))
    wpart = torch.zeros((fmt._wgrad_splits(ents, P, x.device), stride), device=x.device)
    fmt.bwd_weight_grads(ents, wpart, P, counter=fm.packed_wgrad)
    torch.cuda.synchronize()
    n_before = [f.launches for f in launch_fns]
    _, _, small, _ = fm.fused_packed_chain_plain(ws, x, g, 0, P, depth=depth, e_p=63,
                                                 e_v=27, dtype=torch.bfloat16)
    wref = torch.zeros((1, stride), device=x.device)
    fmt.bwd_weight_grads_plain(ents, wref)
    check([f.launches for f in launch_fns] == n_before, "a plain version launched a kernel")
    e1 = (part.sum(0)[:small.numel()] - small).abs().max().item()
    e2_abs = (wpart.sum(0) - wref[0]).abs().max().item()
    e2 = e2_abs / wref.abs().max().item()
    fw = fm.packed_fwd_witness(ws, x, acts, hv, depth, 63, 27)
    bw = fm.packed_bwd_witness(ws, g, acts, hv, cot, depth)
    for label, wit in (("kernel 12's tile (h_0 .., feat, hv)", fw),
                       ("kernel 13's chain (dhv, dfeat, dh_D-1 .. dh_0)", bw)):
        sk, s32 = sum(wit["kernel"]), sum(wit["float32"])
        print(f"{label} D={depth} P={P} bf16 against the float64 witness: share "
              "rounded otherwise per layer kernel "
              + " ".join(f"{v:.3g}" for v in wit["kernel"]) + "; float32 products "
              + " ".join(f"{v:.3g}" for v in wit["float32"])
              + f"; summed {sk:.4g} against {s32:.4g} ({sk / s32:.3f}x, limit "
              f"{WITNESS_RATIO:g}x)", flush=True)
        check(sk <= WITNESS_RATIO * s32, f"{label} against the float64 witness D={depth}")
    print(f"kernel 13 phase 2 D={depth} P={P}: {e2:.3g} of its max (abs {e2_abs:.3g}; "
          f"tolerance {WGRAD_TOL:g}), {wpart.shape[0]} splits; chain small gradients "
          f"abs {e1:.3g}", flush=True)
    check(e2 <= WGRAD_TOL, f"kernel 13 phase 2 vs plain D={depth}")
    del acts, cot, hv, part, wpart, wref, ents
    torch.cuda.empty_cache()
    return {"fused_nerf_packed_chain": e1, "fused_nerf_packed_weight_grads": e2_abs}


def cf_inputs(NeRFMLP, dev, n_rays, seed):
    """An occluding field (the density bias at 30, as JAX's
    ``_occluding_params``) at W=256, D=4, and rays of CF_S sorted depths on
    [2, 6] with a scrambled sort key, the compositor's distance terms and
    unit sigma noise: (params, rays_o, rays_d, viewdirs, z, key, deltas,
    noise)."""
    import torch

    from depth_lidar_nerf_tpu_torch.ops.compositing import composit_dists

    g = torch.Generator().manual_seed(seed)
    m = NeRFMLP(depth=4, width=256, generator=g).to(dev)
    with torch.no_grad():
        m.sigma.bias.fill_(30.0)
    params = {k: v.detach() for k, v in m.named_parameters()}
    gd = torch.Generator(device=dev).manual_seed(seed)
    ro = 0.2 * torch.randn((n_rays, 3), device=dev, generator=gd)
    rd = torch.randn((n_rays, 3), device=dev, generator=gd)
    vd = torch.nn.functional.normalize(rd, dim=-1)
    z = torch.sort(2 + 4 * torch.rand((n_rays, CF_S), device=dev, generator=gd),
                   -1).values
    key = torch.rand((n_rays,), device=dev, generator=gd)
    noise = torch.randn((n_rays, CF_S), device=dev, generator=gd)
    return params, ro, rd, vd, z, key, composit_dists(z, rd), noise


def cf_kernel_checks(fmt, NeRFMLP, dev, launch_fns):
    """Phase 3, kernel 9 on an occluding field, 16,384 and 4,000 rays x 128
    samples, scrambled key: live raw equal to kernel 1's on the same points
    (in the rays' own order, S=128) bit for bit, float32 and bfloat16; the
    same blocks skipped as its twin and live raw within CF_TWIN_TOL; the
    skipped share; the composited rgb, depth and weights and the weight
    gradients of a loss over them through the early-terminating route
    (kernel 9, then kernel 3) against the dense kernel route (kernel 1,
    then kernel 3), float32. Returns (largest max abs error against the
    twin, skipped share at 16,384 rays)."""
    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.ops.compositing import raw2outputs_t

    err, skipped_main = 0.0, None
    for n_rays in CF_N_RAYS:
        params, ro, rd, vd, z, key, deltas, noise = cf_inputs(NeRFMLP, dev,
                                                              n_rays, n_rays)
        pts_t = fmt._points_t(ro, rd, z).contiguous()
        vd_t = vd.T.contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            kw = dict(depth=4, width=256, multires=10, multires_views=4,
                      dtype=dtype)
            xb, vb, aux, order = fmt.cf_layout(pts_t, vd_t, key, deltas, noise,
                                               CF_S)
            with torch.no_grad():
                out_b = fmt.fused_nerf_fwd_cf(params, xb, vb, aux, CF_S,
                                              0.5 * CF_EPS, **kw)
                dense = fmt.fused_nerf_fwd(params, pts_t, vd_t, CF_S, **kw)
                torch.cuda.synchronize()
                n_before = [f.launches for f in launch_fns]
                twin = fmt.fused_nerf_fwd_cf_plain(params, xb, vb, aux, CF_S,
                                                   0.5 * CF_EPS, **kw)
            check([f.launches for f in launch_fns] == n_before,
                  "a plain version launched a kernel")
            dead = (out_b[3].reshape(-1, 2048) == -1e10).all(1)
            skipped = dead.float().mean().item()
            live_b = ~dead.repeat_interleave(2048)
            check(torch.equal(
                (twin[3].reshape(-1, 2048) == -1e10).all(1), dead),
                f"kernel 9 and its twin skip the same blocks N={n_rays} {name}")
            e_twin = rel_err(out_b[:, live_b], twin[:, live_b])
            raw = fmt.cf_unlayout(out_b, order, n_rays, CF_S)
            live = fmt.cf_unlayout(live_b.float()[None].expand(4, -1), order,
                                   n_rays, CF_S)[0] > 0
            bitwise = torch.equal(raw[:, live], dense[:, live])
            dead_ok = bool((raw[:3, ~live] == 0).all()
                           and (raw[3, ~live] == -1e10).all())
            print(f"kernel 9 N={n_rays} S={CF_S} {name}: skipped blocks "
                  f"{skipped:.3f}, live raw == kernel 1 bit for bit: {bitwise}, "
                  f"vs twin {e_twin[1]:.3g} (abs {e_twin[0]:.3g}; tolerance "
                  f"{CF_TWIN_TOL[name]:g})", flush=True)
            check(bitwise and dead_ok,
                  f"kernel 9 live raw equals kernel 1's N={n_rays} {name}")
            check(e_twin[1] <= CF_TWIN_TOL[name], f"kernel 9 vs twin N={n_rays} {name}")
            if n_rays == TRAIN_N_RAYS:
                check(skipped > 0.1, f"kernel 9 skips > 10% of blocks ({name})")
                skipped_main = skipped
            err = max(err, e_twin[0])
            del xb, vb, aux, out_b, dense, twin, raw
            torch.cuda.empty_cache()

        # The early-terminating route against the dense route, float32.
        lp = {k: v.clone().requires_grad_() for k, v in params.items()}
        kw = dict(depth=4, width=256, multires=10, multires_views=4,
                  dtype=torch.float32, cull_bwd=True)
        res = {}
        for fwd in (True, False):
            for p in lp.values():
                p.grad = None
            with mock.patch.dict(os.environ, {"DLNERF_CULL_FWD": "1"}):
                raw = fmt.fused_nerf_apply_rays(
                    lp, ro, rd, vd, z, fwd_cull=(key, deltas, noise, CF_EPS)
                    if fwd else None, **kw)
                check(fmt.fused_nerf_apply_rays.last_route
                      == ("cf" if fwd else "culled"), "cf route")
            o = raw2outputs_t(raw, z, rd, cull_eps=CF_EPS, noise=noise)
            (torch.mean(o.rgb ** 2) + torch.mean(o.depth ** 2)
             + torch.mean(o.acc)).backward()
            res[fwd] = (o, {k: p.grad.clone() for k, p in lp.items()})
        (oc, gc), (od, gd) = res[True], res[False]
        for a, b, label in ((oc.rgb, od.rgb, "rgb"), (oc.depth, od.depth, "depth"),
                            (oc.weights, od.weights, "weights")):
            d = (a - b).abs()
            ok = bool((d <= 1e-5 + 1e-4 * b.abs()).all())
            print(f"kernel 9 route N={n_rays} {label} vs dense route: max abs "
                  f"{d.max().item():.3g} (rtol 1e-4, atol 1e-5)")
            check(ok, f"cf route {label} equals the dense route's N={n_rays}")
        ge = max(((gc[k] - gd[k]).abs().max() / (gd[k].abs().mean() + 1e-12)).item()
                 for k in gd)
        print(f"kernel 9 route N={n_rays} weight gradients vs dense route: "
              f"max/mean {ge:.3g} (tolerance 1e-4)", flush=True)
        check(ge <= 1e-4, f"cf route gradients N={n_rays}")
        del lp, res, oc, od, gc, gd, params
        torch.cuda.empty_cache()
    return err, skipped_main


def sigma_grad_check(fm, dev, fns):
    """The sigma-loss term alone (``train.step._sigma_loss_term``) on the
    depth rays of a TRAJ_N_RAYS step, float32, through kernels 12 and 13
    and through the plain module from the same weights and generator seed:
    the fine net's gradients per parameter, (max over parameters of max
    abs error over mean abs, of mean abs error over mean abs)."""
    import torch

    from depth_lidar_nerf_tpu_torch.train.state import Models
    from depth_lidar_nerf_tpu_torch.train.step import _sigma_loss_term
    from depth_lidar_nerf_tpu_torch.train.tables import gather_rays

    cfg, rcfg, mk, tabs, _ = bench_stack(dev, TRAJ_N_RAYS, "float32",
                                         sigma_loss=True)
    mp = Models(*path_models(cfg, rcfg, mk, "float32", True, dev))
    table = tabs[1]
    idx = torch.randint(0, table.origins.shape[0], (TRAJ_N_RAYS // 2,),
                        device=dev, generator=torch.Generator(
                            device=dev).manual_seed(3))
    rays = gather_rays(table, idx, rcfg)
    grads = {}
    for label, models in (("kernel", mk), ("plain", mp)):
        n_before = (fm.fused_packed_fwd.launches, fm.fused_packed_bwd.launches)
        gen = torch.Generator(device=dev).manual_seed(4)
        loss = _sigma_loss_term(cfg, rcfg, models, rays, table.depth[idx], gen)
        loss.backward()
        torch.cuda.synchronize()
        n = (fm.fused_packed_fwd.launches - n_before[0],
             fm.fused_packed_bwd.launches - n_before[1])
        check(n == ((1, 1) if label == "kernel" else (0, 0)),
              f"sigma-loss term launches on the {label} path: {n}")
        grads[label] = {k: p.grad.detach().clone()
                        for k, p in models.fine.named_parameters()}
    gk, gp = grads["kernel"], grads["plain"]
    mx = max(((gk[k] - gp[k]).abs().max() / (gp[k].abs().mean() + 1e-30)).item()
             for k in gp)
    mn = max(((gk[k] - gp[k]).abs().mean() / (gp[k].abs().mean() + 1e-30)).item()
             for k in gp)
    print(f"sigma-loss term gradients of one step ({TRAJ_N_RAYS // 2} depth rays, "
          f"float32), kernel vs plain: max/mean {mx:.3g}, mean/mean {mn:.3g} "
          f"(tolerance {SIGMA_GRAD_TOL})", flush=True)
    check(mx <= SIGMA_GRAD_TOL[0] and mn <= SIGMA_GRAD_TOL[1],
          "sigma-loss term gradients, kernel vs plain")
    return mx, mn


def sigma_and_cf_training(fm, fmt, sc, renderer, dev, card, plain_sampler,
                          all_fns, ms_step_5):
    """Phases 5b and 5c and their trajectories (see the module note), then
    kernels 9, 12 and 13 at the steps' shapes. Returns the numbers for the
    JSON lines."""
    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.train.state import init_train_state
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    out = {"launches": {}}
    fns = kernel_fns(fmt, sc)
    warm, timed = SIGMA_STEPS
    n = warm + timed

    def run(step, state, tables, gen):
        for fn in fns.values():
            fn.launches = 0
        metrics = [step(state, *tables, gen) for _ in range(warm)]
        ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        ev0.record()
        metrics += [step(state, *tables, gen) for _ in range(timed)]
        ev1.record()
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in fns.items() if fn.launches}
        vals = [{k: v.item() for k, v in m.items()} for m in metrics]
        check(all(np.isfinite(v) for m in vals for v in m.values()),
              "finite metrics")
        return ev0.elapsed_time(ev1) / timed, launches, vals

    # ---- 5b. sigma-loss training ---------------------------------------------
    cfg, rcfg, tm, tables, scene = bench_stack(dev, TRAIN_N_RAYS, "bfloat16",
                                               sigma_loss=True)
    state = init_train_state(cfg, tm)
    step = make_train_step(cfg, rcfg, tm, scene.hwf)
    check(tm.fine.supports_raw(rcfg), "the packed-lane kernels cover the fine net")
    ms, launches, vals = run(step, state, tables,
                             torch.Generator(device=dev).manual_seed(0))
    n_chunks = -(-TRAIN_N_RAYS * 128 // fmt.BWD_CHUNK)  # kernel 5's split, fine pass
    # kernel 13's split: the sigma loss's N_samples points on each depth ray
    n_sig = -(-(TRAIN_N_RAYS // 2) * cfg.N_samples // fmt.BWD_CHUNK)
    want = {fmt.KERNEL: n, "fused_nerf_fwd_acts": n, "fused_nerf_bwd_culled": n,
            "fused_nerf_bwd_acts": n, sc.KERNEL: n, "fused_nerf_grad_reduce": 3 * n,
            "fused_nerf_packed_fwd": n, "fused_nerf_packed_bwd": n,
            "fused_nerf_packed_chain": n_sig * n,
            "fused_nerf_packed_weight_grads": n_sig * n,
            "fused_nerf_bwd_chain": n_chunks * n,
            "fused_nerf_bwd_weight_grads": n_chunks * n}
    print(f"sigma-loss training launches over {n} steps: {launches}", flush=True)
    check(launches == want, f"sigma-loss launch counts, want {want}")
    losses = [m["loss"] for m in vals]
    s_losses = [m["sigma_loss"] for m in vals]
    k = 5
    print("sigma-loss training loss per step: " + " ".join(f"{x:.4f}" for x in losses))
    print("sigma loss per step: " + " ".join(f"{x:.5f}" for x in s_losses))
    check(np.mean(losses[-k:]) < np.mean(losses[:k]), "sigma-loss step: loss falls")
    check(np.mean(s_losses[-k:]) < np.mean(s_losses[:k]), "sigma loss falls")
    print(f"sigma-loss training steady: {ms:.1f} ms/step, "
          f"{TRAIN_N_RAYS * 1e3 / ms:,.0f} rays/s (phase 5: {ms_step_5:.1f} "
          f"ms/step) on {card}", flush=True)
    out["sigma_training"] = {"ms_per_step": ms, "rays_per_s": TRAIN_N_RAYS * 1e3 / ms,
                             "losses": losses, "sigma_losses": s_losses,
                             "launches": launches}
    out["launches"] = {k: v for k, v in launches.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    profile_step(lambda: step(state, *tables, gen), "sigma-loss step")
    captured = {}
    orig_bwd = fm.fused_packed_bwd

    def cap_bwd(ws, x, g, **kw):
        captured["packed"] = (ws, x, g, kw)
        return orig_bwd(ws, x, g, **kw)

    # A wrapper counts its launches through its module-level name, which
    # the stand-in takes over: give it a counter of its own.
    cap_bwd.launches = 0
    with mock.patch.object(fm, "fused_packed_bwd", cap_bwd):
        step(state, *tables, gen)
    torch.cuda.synchronize()
    del state, step, tm, tables
    torch.cuda.empty_cache()
    print(f"phase 5b done at {time.time() - T_START:.0f} s", flush=True)

    # ---- 5c. the early-terminating forward -------------------------------------
    cfg, rcfg, tm, tables, scene = bench_stack(dev, TRAIN_N_RAYS, "bfloat16")
    state = init_train_state(cfg, tm)
    step = make_train_step(cfg, rcfg, tm, scene.hwf)
    with mock.patch.dict(os.environ, {"DLNERF_CULL_FWD": "1"}):
        ms_cf, launches, vals = run(step, state, tables,
                                    torch.Generator(device=dev).manual_seed(0))
        want = {fmt.KERNEL: n, "fused_nerf_fwd_cf": n, "fused_nerf_bwd_culled": 2 * n,
                sc.KERNEL: n, "fused_nerf_grad_reduce": 2 * n}
        print(f"cf training launches over {n} steps: {launches}", flush=True)
        check(launches == want, f"cf launch counts, want {want}")
        for key, v in launches.items():
            out["launches"][key] = out["launches"].get(key, 0) + v
        cf_losses = [m["loss"] for m in vals]
        # Three more steps, each fine pass's skipped share read from kernel
        # 9's output, and the last one's inputs kept for the kernel times.
        skipped = []
        orig_cf, orig_fn = fmt._fwd_cf, fmt.fused_nerf_fwd_cf

        def count_skips(*a, **kw):
            o = orig_fn(*a, **kw)
            skipped.append((o[3].reshape(-1, 2048) == -1e10).all(1)
                           .float().mean().item())
            return o

        count_skips.launches = 0  # as cap_bwd's in phase 5b

        def cap_cf(*a):
            captured["cf"] = a[:8]
            return orig_cf(*a)

        gen = torch.Generator(device=dev).manual_seed(1)
        profile_step(lambda: step(state, *tables, gen), "cf step")
        with mock.patch.object(fmt, "fused_nerf_fwd_cf", count_skips), \
                mock.patch.object(fmt, "_fwd_cf", cap_cf):
            for _ in range(3):
                step(state, *tables, gen)
        torch.cuda.synchronize()
    print("cf training loss per step: " + " ".join(f"{x:.4f}" for x in cf_losses))
    print(f"cf training steady: {ms_cf:.1f} ms/step, "
          f"{TRAIN_N_RAYS * 1e3 / ms_cf:,.0f} rays/s (phase 5, dense fine "
          f"forward: {ms_step_5:.1f} ms/step); fine blocks skipped per step "
          + " ".join(f"{s:.3f}" for s in skipped) + f" on {card}", flush=True)
    out["cf_training"] = {"ms_per_step": ms_cf, "rays_per_s": TRAIN_N_RAYS * 1e3 / ms_cf,
                          "losses": cf_losses, "fine_blocks_skipped": skipped,
                          "launches": launches}
    del state, step, tm, tables
    torch.cuda.empty_cache()
    print(f"phase 5c done at {time.time() - T_START:.0f} s", flush=True)

    # ---- the sigma-loss term's gradients, kernel path against plain path -----
    out["sigma_grad"] = sigma_grad_check(fm, dev, fns)

    # ---- trajectories ----------------------------------------------------------
    out["sigma_trajectory"] = trajectories(
        "sigma-loss trajectory", SIGMA_TRAJ_TOL, dev, list(fns.values()), renderer,
        plain_sampler, semantic=False, sigma_loss=True)
    cf_gaps = {}
    for dtype in ("float32", "bfloat16"):
        ls = {}
        for knob in ("0", "1"):
            cfg, rcfg, mj, tabs, scn = bench_stack(dev, TRAJ_N_RAYS, dtype)
            st = init_train_state(cfg, mj)
            stp = make_train_step(cfg, rcfg, mj, scn.hwf)
            gen = torch.Generator(device=dev).manual_seed(7)
            n9 = fmt.fused_nerf_fwd_cf.launches
            with mock.patch.dict(os.environ, {"DLNERF_CULL_FWD": knob}):
                ls[knob] = np.array([stp(st, *tabs, gen)["loss"].item()
                                     for _ in range(5)])
            check((fmt.fused_nerf_fwd_cf.launches - n9) == (5 if knob == "1" else 0),
                  "cf trajectory routes")
            del st, stp, mj, tabs
            torch.cuda.empty_cache()
        cf_gaps[dtype] = float(np.max(np.abs(ls["1"] - ls["0"]) / np.abs(ls["0"])))
        print(f"cf trajectory {dtype}, 5 steps of {TRAJ_N_RAYS} rays, cf vs dense "
              f"kernel step: max loss gap {cf_gaps[dtype]:.3g} (tolerance "
              f"{CF_TRAJ_TOL[dtype]:g}); losses cf " + " ".join(f"{x:.6f}" for x in ls["1"])
              + " dense " + " ".join(f"{x:.6f}" for x in ls["0"]), flush=True)
        check(cf_gaps[dtype] <= CF_TRAJ_TOL[dtype], f"cf trajectory {dtype}")
    out["cf_trajectory"] = cf_gaps
    print(f"trajectories of phases 5b-5c done at {time.time() - T_START:.0f} s",
          flush=True)

    # ---- kernels 9, 12 and 13 at the steps' shapes (bf16) ---------------------
    times = {}
    ws, x, g, kw = captured["packed"]
    kw = {k_: v for k_, v in kw.items() if k_ != "kw"}
    depth, W = kw["depth"], ws[0].shape[1]
    kwt = fm.kernel_weights(ws, depth, 63, 27)
    P = x.shape[0]
    n_w = sum(t.numel() for t in ws)
    dt = kw["dtype"]
    chunks = [(c, min(fmt.BWD_CHUNK, P - c)) for c in range(0, P, fmt.BWD_CHUNK)]
    part = torch.zeros((2 * fmt._grid(dev, 1 << 30), -(-n_w // 4) * 4), device=dev)
    g_at = fm.grad_offsets(ws)
    with torch.no_grad():
        t12 = (cuda_ms(lambda: fm.fused_packed_fwd(ws, x, kw=kwt, **kw), 10),
               cuda_ms(lambda: fm.fused_packed_fwd_plain(ws, x, depth, dt, e_p=63,
                                                         e_v=27), 3, 1))
        t13 = (cuda_ms(lambda: fm.fused_packed_bwd(ws, x, g, kw=kwt, **kw), 5, 1),
               cuda_ms(lambda: fm.fused_packed_bwd_plain(ws, x, g, depth, dt, e_p=63,
                                                         e_v=27), 2, 1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fm.fused_packed_bwd(ws, x, g, kw=kwt, **kw)
        torch.cuda.synchronize()
        buf_mem = sum(fm.chunk_numel(min(P, fmt.BWD_CHUNK), depth, W)) * 2
        mem = {"peak_bytes": torch.cuda.max_memory_allocated() - base,
               "activation_and_cotangent_buffers_bytes": buf_mem}
        print(f"split backward, kernel 13 (the sigma-loss term): {P} points in chunks of "
              f"{fmt.BWD_CHUNK}; extra device memory {mem['peak_bytes'] / 2**30:.3f} GiB "
              f"at peak, of which the chunk's activations and cotangents "
              f"{buf_mem / 2**30:.3f} GiB", flush=True)
        out["sigma_training"]["split_backward_memory"] = mem
        # kernel 13's phases alone over the pass's chunks, phase 2 on phase 1's buffers
        bufs = [fm.fused_packed_chain(ws, x, g, c, n_, part, kw=kwt, **kw)
                for c, n_ in chunks]
        ents = [fm.packed_wgrad_entries(x, a, c_, c, n_, depth, W, 63, 27, g_at)
                for (a, c_), (c, n_) in zip(bufs, chunks)]
        times_13 = {
            "fused_nerf_packed_chain": (
                cuda_ms(lambda: [fm.fused_packed_chain(ws, x, g, c, n_, part, kw=kwt,
                                                       acts=a, cot=c_, **kw)
                                 for (a, c_), (c, n_) in zip(bufs, chunks)], 5, 1),
                cuda_ms(lambda: [fm.fused_packed_chain_plain(ws, x, g, c, n_, depth=depth,
                                                             e_p=63, e_v=27, dtype=dt)
                                 for c, n_ in chunks], 2, 1)),
            "fused_nerf_packed_weight_grads": (
                cuda_ms(lambda: [fmt.bwd_weight_grads(e, part, n_, counter=fm.packed_wgrad)
                                 for e, (_, n_) in zip(ents, chunks)], 5, 1),
                cuda_ms(lambda: [fmt.bwd_weight_grads_plain(e, part[:1]) for e in ents],
                        2, 1))}
        del bufs, ents, part
        torch.cuda.empty_cache()
    macs = packed_macs(depth, W)
    # Kernel 13: the forward recomputed, a weight-gradient product per weight
    # and an input-gradient product per weight past the first layer.
    bwd_m = macs + 2 * macs - 63 * W - 27 * (W // 2)
    # Its phase 2: the large weight gradients (W1's e_p rows, the trunk, the
    # feature columns, the view layer's feature and view rows); phase 1 the rest.
    wg_m = 63 * W + (depth - 1) * W * W + W * W + W * (W // 2) + 27 * (W // 2)
    # Phase 1's buffers: the activations h_0 .. h_{D-1}, feat and the
    # cotangents (those layers' and dhv's), bfloat16.
    acts_bytes, cot_bytes = (2 * m for m in fm.chunk_numel(P, depth, W))
    x_lanes = fmt._pad16(63 + 27)  # the packed lanes 0 .. 95 that both phases read
    # The chain's small gradients: every bias, d(WR)'s rgb columns, d(WFS)'s sigma column.
    n_small = (depth + 1) * W + W // 2 + 4 + 3 * (W // 2) + W
    work = {"fused_nerf_packed_fwd": (2 * macs * P, P * 128 * 2 + P * 8 * 4 + n_w * 2),
            "fused_nerf_packed_bwd": (2 * bwd_m * P, P * 128 * 2 + P * 8 * 4 + n_w * 2
                                      + n_w * 4),
            # reads x's lanes, g and the weights; writes the activations,
            # the cotangents and the small gradients
            "fused_nerf_packed_chain": (2 * (bwd_m - wg_m) * P,
                                        P * x_lanes * 2 + P * 8 * 4 + n_w * 2 + acts_bytes
                                        + cot_bytes + n_small * 4),
            # reads the activations, the cotangents and x's lanes 0 .. 63
            # and 48 .. 95; writes the large gradients (wg_m entries)
            "fused_nerf_packed_weight_grads": (2 * wg_m * P,
                                               acts_bytes + cot_bytes + P * x_lanes * 2
                                               + wg_m * 4)}
    for k_, t_ in (("fused_nerf_packed_fwd", t12), ("fused_nerf_packed_bwd", t13),
                   *times_13.items()):
        fl, by = work[k_]
        t_ops, t_bytes = fl / PEAK_FLOPS["bfloat16"], by / PEAK_BYTES
        times[k_] = (t_[0], t_[1], max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops > t_bytes else "bytes")
    params, pts_t, vd_t, key, deltas, noise, spec, eps = captured["cf"]
    params = {k_: v.detach() for k_, v in params.items()}
    xb, vb, aux, order = fmt.cf_layout(pts_t, vd_t, key, deltas, noise, spec.S)
    pk = fmt.pack_params(params, spec.depth, spec.dtype, dev)
    kw9 = spec.kw()
    with torch.no_grad():
        o9 = fmt.fused_nerf_fwd_cf(params, xb, vb, aux, spec.S, 0.5 * eps,
                                   packed=pk, **kw9)
        dead = (o9[3].reshape(-1, 2048) == -1e10).all(1)
        t9 = (cuda_ms(lambda: fmt.fused_nerf_fwd_cf(params, xb, vb, aux, spec.S,
                                                    0.5 * eps, packed=pk, **kw9), 5),
              cuda_ms(lambda: fmt.fused_nerf_fwd_cf_plain(params, xb, vb, aux, spec.S,
                                                          0.5 * eps, **kw9), 2, 1))
        glue_ms = cuda_ms(lambda: (
            fmt.cf_layout(pts_t, vd_t, key, deltas, noise, spec.S),
            fmt.cf_unlayout(o9, order, vd_t.shape[1], spec.S)), 5)
    P9 = xb.shape[1]
    live_pts = int((~dead).sum().item()) * 2048
    fl = 2 * mlp_macs(spec.depth, 256, 63, 27, (), fmt.SAMPLE_BLOCK) * live_pts
    n_w9 = sum(v.numel() for v in params.values())
    by = live_pts * (3 + 2) * 4 + live_pts // 16 * 3 * 4 + P9 * 4 * 4 + n_w9 * 2
    t_ops, t_bytes = fl / PEAK_FLOPS["bfloat16"], by / PEAK_BYTES
    times["fused_nerf_fwd_cf"] = (t9[0], t9[1], max(t_ops, t_bytes) * 1e3,
                                  "operations" if t_ops > t_bytes else "bytes")
    print(f"fine pass of a cf step: {dead.numel()} blocks, "
          f"{100 * dead.float().mean().item():.2f}% skipped; cf glue (sort, "
          f"regroup, un-permute): {glue_ms:.3f} ms")
    flops = {k_: work[k_][0] for k_ in work}
    flops["fused_nerf_fwd_cf"] = fl
    for k_, (ms_, plain_, bound_, by_) in times.items():
        print(f"{k_} at the step's shapes (bf16): {ms_:.3f} ms, plain {plain_:.3f} "
              f"ms, {flops[k_] / ms_ / 1e9:.1f} TFLOP/s, bound {bound_:.3f} ms "
              f"({by_}) on {card}", flush=True)
    out["times"] = times
    out["cf_glue_ms"] = glue_ms
    del captured, xb, vb, aux, o9, x, g
    torch.cuda.empty_cache()
    print(f"phase 7 (kernels 9, 12, 13) done at {time.time() - T_START:.0f} s",
          flush=True)
    return out


def bench_stack(dev, n_rand, dtype, fused=True, semantic=False,
                sigma_loss=False):
    """``bench.py``'s ``two_mlp`` configuration, or with ``semantic`` its
    ``ref_default_semantic_two_mlp`` (fine D=8 skip@4, a 19-class head on
    both MLPs, semantic loss 0.04), on the in-memory synthetic scene; with
    ``sigma_loss`` the DS-NeRF sigma loss (JAX's default lambda 0.1):
    (cfg, rcfg, models, tables, scene)."""
    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.train.config import (TrainConfig,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import build_models
    from depth_lidar_nerf_tpu_torch.train.tables import (build_depth_table,
                                                         build_rgb_table)

    sc = draw_scene(n_images=4, H=H, W=W, focal=FOCAL, n_depth_points=8000,
                    backdrop=True, num_classes=SEM_CLASSES if semantic else None)
    cfg = TrainConfig(dataset_type="llff", N_rand=n_rand, N_samples=64,
                      N_importance=64, netdepth=4, netwidth=256,
                      netdepth_fine=8 if semantic else 4, netwidth_fine=256,
                      use_viewdirs=True, no_ndc=True, raw_noise_std=1.0,
                      colmap_depth=True, depth_loss=True, depth_lambda=0.01,
                      semantic_loss=semantic, semantic_lambda=0.04,
                      sigma_loss=sigma_loss, sigma_lambda=0.1,
                      compute_dtype=dtype, cull_eps=1e-4, seed=0,
                      use_fused_mlp=fused)
    rcfg = render_config_from(cfg, sc.num_classes if semantic else 0, sc.near,
                              sc.far)
    models = build_models(cfg, rcfg, device=dev if fused else "cpu")
    models = type(models)(*(m.to(dev) for m in models))
    it = range(4)
    tables = (build_rgb_table(sc.images, sc.poses, it, *sc.hwf, rcfg,
                              segmentation=sc.segmentation if semantic else None,
                              device=dev),
              build_depth_table(sc.depth_gts, sc.poses, it, *sc.hwf, rcfg,
                                device=dev))
    return cfg, rcfg, models, tables, sc


def path_models(cfg, rcfg, models, dtype, plain, dev):
    """Copies of ``models`` in ``dtype`` on the kernel path, or with
    ``plain`` as plain ``NeRFMLP`` modules (built on the CPU, where the
    config's ``use_fused_mlp=False`` is honoured, then moved)."""
    from depth_lidar_nerf_tpu_torch.train.state import build_models

    pm = build_models(cfg.replace(use_fused_mlp=not plain, compute_dtype=dtype),
                      rcfg, device="cpu" if plain else dev)
    pm.coarse.load_state_dict(models.coarse.state_dict())
    pm.fine.load_state_dict(models.fine.state_dict())
    return pm.coarse.to(dev), pm.fine.to(dev)


def trajectories(label, tol, dev, fns, renderer, plain_sampler, semantic,
                 sigma_loss=False):
    """5 steps of the kernel path and of the plain path (plain modules and
    the sampling twin, which must launch no kernel) of a :func:`bench_stack`
    from the same weights and generator seed, TRAJ_N_RAYS rays, float32 and
    bfloat16, perturbation and noise on. Prints and checks against ``tol``
    (max relative loss gap over the steps; max over parameters of the
    relative L2 gap of their 5-step updates) and returns the gaps."""
    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.train.state import (FusedMLP,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    traj = {}
    for dtype in ("float32", "bfloat16"):
        for plain in (False, True):
            cfg, rcfg, mj, tabs, scn = bench_stack(dev, TRAJ_N_RAYS, dtype,
                                                   fused=not plain,
                                                   semantic=semantic,
                                                   sigma_loss=sigma_loss)
            check(isinstance(mj.coarse, FusedMLP) != plain, "trajectory models")
            st = init_train_state(cfg, mj)
            stp = make_train_step(cfg, rcfg, mj, scn.hwf)
            gen = torch.Generator(device=dev).manual_seed(7)
            nets = (("coarse", mj.coarse), ("fine", mj.fine))
            init = {f"{net}.{n}": p.detach().clone()
                    for net, m in nets for n, p in m.named_parameters()}
            n_before = [fn.launches for fn in fns]
            ctx = (mock.patch.object(renderer, "sample_pdf_cuda", plain_sampler)
                   if plain else contextlib.nullcontext())
            with ctx:
                ls = [stp(st, *tabs, gen)["loss"].item() for _ in range(5)]
            torch.cuda.synchronize()
            if plain:
                check([fn.launches for fn in fns] == n_before,
                      f"the plain {label} path launched a kernel")
            traj[dtype, plain] = (np.array(ls), {  # each parameter's update
                f"{net}.{n}": p.detach() - init[f"{net}.{n}"]
                for net, m in nets for n, p in m.named_parameters()})
            del st, stp, mj, tabs
            torch.cuda.empty_cache()

    def gap(a, b):
        (la, pa), (lb, pb) = traj[a], traj[b]
        return (float(np.max(np.abs(la - lb) / np.abs(lb))),
                max((torch.linalg.norm(pa[k] - pb[k])
                     / torch.linalg.norm(pb[k])).item() for k in pb))

    gaps = {d: gap((d, False), (d, True)) for d in ("float32", "bfloat16")}
    gaps["plain_bf16_vs_f32"] = gap(("bfloat16", True), ("float32", True))
    for d in ("float32", "bfloat16"):
        print(f"{label} {d}, 5 steps of {TRAJ_N_RAYS} rays, kernel vs plain: "
              f"max loss gap {gaps[d][0]:.3g}, max update gap {gaps[d][1]:.3g} "
              f"(tolerance {tol[d][0]:g}, {tol[d][1]:g}); losses kernel "
              + " ".join(f"{x:.5f}" for x in traj[d, False][0])
              + " plain " + " ".join(f"{x:.5f}" for x in traj[d, True][0]))
    print(f"{label} for scale, plain bfloat16 vs plain float32: max loss gap "
          f"{gaps['plain_bf16_vs_f32'][0]:.3g}, max update gap "
          f"{gaps['plain_bf16_vs_f32'][1]:.3g}", flush=True)
    for d in ("float32", "bfloat16"):
        check(gaps[d][0] <= tol[d][0] and gaps[d][1] <= tol[d][1],
              f"{label} {d}")
    return gaps


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
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp as fm
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as fmt
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as sc
    from depth_lidar_nerf_tpu_torch.ops.sampling import pdf_uniforms
    from depth_lidar_nerf_tpu_torch.render import renderer
    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train.config import (parse_args,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.loop import render_path
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {kind}", flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.time()
    logs = _build.build_all([fmt.KERNEL, fmt.BWD_KERNEL, fmt.Q8_KERNEL,
                             fm.KERNEL, sc.KERNEL])
    for name, types in ((fmt.KERNEL, fmt.ARGTYPES),
                        (fmt.BWD_KERNEL, fmt.BWD_ARGTYPES),
                        (fmt.Q8_KERNEL, fmt.Q8_ARGTYPES),
                        (fm.KERNEL, fm.ARGTYPES),
                        (sc.KERNEL, sc.ARGTYPES)):
        _build.load(name, types)
    print(f"build: {time.time() - t0:.1f} s (nvcc {' '.join(_build.ARCH_FLAGS)})")
    for name, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1][:60]
            elif "registers" in line or "spill" in line or "error" in line:
                print(f"  {name} {fn}: {line.strip()}")
    sass_tensor_core_check(_build, fmt, fm)

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

    # Kernel 14 at the main path's tiles (serving 32,768 and 320 rays, the
    # step's 16,384; B = 63, V = 64), contiguous and as the renderer hands
    # its inputs over (the weights a slice with row stride 64, det's u an
    # expand with row stride 0), and with draws u = 1 where the sequential
    # CDF ends above 1.0. The plain version repeats the kernel's float32
    # operations in its order, so the two must agree to the last bit.
    N, B, V = H * W, 63, 64
    cases = [(n, det, layout, False) for n in (32768, H * W - 32768, TRAIN_N_RAYS)
             for det in (True, False) for layout in ("contiguous", "renderer")]
    cases += [(32768, det, "renderer", True) for det in (True, False)]
    for n, det, layout, u_one in cases:
        bins, wts, u = sample_pdf_inputs(dev, n, B, V, det, layout,
                                         seed=n + det, u_one=u_one)
        got = sc.inverse_cdf(bins, wts, u)
        torch.cuda.synchronize()
        ref = sc.inverse_cdf_plain(bins, wts, u)
        e = (got - ref).abs().max().item()
        print(f"kernel sample_pdf N={n} B={B} V={V} det={det} {layout}"
              f"{' u=1 at cdf[B-1] > 1' if u_one else ''}: max abs err {e:.3g}, "
              f"tolerance 0 (equal to the last bit)")
        check(torch.equal(got, ref), f"sample_pdf N={n} det={det} {layout} "
              f"u_one={u_one}")
        err[sc.KERNEL] = max(err[sc.KERNEL], e)
    del bins, wts, u, got, ref

    train_fns = {"fused_nerf_fwd_acts": fmt.fused_nerf_fwd_acts,
                 "fused_nerf_bwd": fmt.fused_nerf_bwd,
                 "fused_nerf_bwd_culled": fmt.fused_nerf_bwd_culled,
                 "fused_nerf_bwd_acts": fmt.fused_nerf_bwd_acts}
    all_fns = list(kernel_fns(fmt, sc).values())
    t0 = time.time()
    err.update(train_kernel_checks(fmt, NeRFMLP, dev, all_fns))
    print(f"training kernels checked in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    err.update(sem_kernel_checks(fmt, NeRFMLP, dev, all_fns))
    print(f"semantic kernels checked in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    err.update(q8_kernel_checks(fmt, NeRFMLP, dev, all_fns))
    print(f"int8 kernels checked in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    err.update(packed_kernel_checks(fm, fmt, NeRFMLP, dev, all_fns))
    print(f"packed-lane kernels checked in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    err["fused_nerf_fwd_cf"], cf_skipped = cf_kernel_checks(fmt, NeRFMLP, dev,
                                                            all_fns)
    print(f"early-terminating forward checked in {time.time() - t0:.1f} s; "
          f"phase 3 done at {time.time() - T_START:.0f} s", flush=True)

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

    profile_step(lambda: render_image(models.coarse, models.fine, H, W, FOCAL,
                                      poses[1], rcfg, device=dev), "frame")

    # The kernel path against the plain path on a sparser field, whose
    # opacity spreads across the frame (it leaves a few rays empty, where the
    # reference's disparity is 0/0).
    with torch.no_grad():
        for m in models:
            m.sigma.bias += COMPARE_OFFSET - SIGMA_OFFSET
    # Frame 0 through the kernels and through the plain versions, in float32
    # and in bfloat16, with the same weights. The plain path is plain NeRFMLP
    # modules and the sampling kernel's twin in place of the renderer's
    # wrapper; neither kernel may launch in it.
    def plain_sampler(bins, weights, n, *, det=False, generator=None):
        u = pdf_uniforms(bins.shape[0], n, det=det, generator=generator,
                         device=bins.device)
        return sc.inverse_cdf_plain(bins, weights, u)

    dtypes = ("float32", "bfloat16")
    frames = {("kernel", d): render_image(
        *path_models(cfg, rcfg, models, d, False, dev), H, W, FOCAL, poses[0],
        rcfg, device=dev) for d in dtypes}
    n_before = (fmt.fused_nerf_fwd.launches, sc.inverse_cdf.launches)
    with mock.patch.object(renderer, "sample_pdf_cuda", plain_sampler):
        for d in dtypes:
            frames["plain", d] = render_image(
                *path_models(cfg, rcfg, models, d, True, dev), H, W, FOCAL,
                poses[0], rcfg, device=dev)
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
    print(f"phase 4 done at {time.time() - T_START:.0f} s", flush=True)

    # ---- 4b. int8 serving and the modes that compose with it ---------------
    int8_out, int8_launches = int8_serving_phase(
        fmt, sc, renderer, dev, card, cfg, rcfg, models, poses, ms_frame,
        kernel_fns(fmt, sc))
    print(f"phase 4b done at {time.time() - T_START:.0f} s", flush=True)

    # ---- 5. kernel times at the serving shapes ----------------------------
    g = torch.Generator(device=dev).manual_seed(1)
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

    # Kernel 14: a frame's two tiles with det draws, and a step's 16,384 rays
    # with random draws, both in the renderer's layout.
    sp_bound = {}
    sp = {}
    for label, tiles, det in (("frame", (32768, N - 32768), True),
                              ("step", (TRAIN_N_RAYS,), False)):
        n = sum(tiles)
        sets = sample_pdf_sets(dev, tiles, det)
        sp_bound[label] = sample_pdf_bound_ms(sets[0])
        sp[label] = sample_pdf_times(sc, sets)
        del sets
        t_ = sp[label]
        print(f"sample_pdf per {label} ({n} rays): device {t_['device_ms']:.5f} ms "
              f"(by {t_['device_by']}) "
              f"({100 * sp_bound[label] / t_['device_ms']:.1f}% of the bound; "
              f"every kernel {t_['device_all_ms']:.5f}), events "
              f"{t_['events_ms']:.5f} ms, host {t_['host_us_per_call']:.2f} us a "
              f"call, plain {t_['plain_ms']:.4f} ms, bound {sp_bound[label]:.6f} "
              f"ms (bytes) on {card}")
    q8_rgb_times = q8_times(fmt, dev, work, False, card, "fused_nerf_fwd_q8")
    del work, models
    torch.cuda.empty_cache()

    # ---- 5. training ------------------------------------------------------
    t0 = time.time()
    cfg_t, rcfg_t, tm, tables, scene = bench_stack(dev, TRAIN_N_RAYS, "bfloat16")
    hwf = scene.hwf
    state = init_train_state(cfg_t, tm)
    step = make_train_step(cfg_t, rcfg_t, tm, hwf)
    step_strict = make_train_step(cfg_t.replace(cull_eps=0.0),
                                  dataclasses.replace(rcfg_t, cull_eps=0.0),
                                  tm, hwf)
    print(f"training: two_mlp stack built in {time.time() - t0:.1f} s "
          f"({tables[0].origins.shape[0]} rgb rays, "
          f"{tables[1].origins.shape[0]} depth rays, near {rcfg_t.near:.3f}, "
          f"far {rcfg_t.far:.3f})", flush=True)
    counted = {fmt.KERNEL: fmt.fused_nerf_fwd, **train_fns,
               sc.KERNEL: sc.inverse_cdf, "fused_nerf_grad_reduce": fmt.grad_reduce,
               "fused_nerf_bwd_chain": fmt.fused_nerf_bwd_chain,
               "fused_nerf_bwd_weight_grads": fmt.bwd_weight_grads}
    for fn in counted.values():
        fn.launches = 0
    gen = torch.Generator(device=dev).manual_seed(0)
    metrics = [step(state, *tables, gen) for _ in range(5)]
    ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
    ev0.record()
    metrics += [step(state, *tables, gen) for _ in range(20)]
    ev1.record()
    torch.cuda.synchronize()
    ms_step = ev0.elapsed_time(ev1) / 20
    metrics += [step_strict(state, *tables, gen) for _ in range(3)]
    torch.cuda.synchronize()
    train_launches = {k: fn.launches for k, fn in counted.items()}
    n_chunks = -(-TRAIN_N_RAYS * (rcfg_t.N_samples + rcfg_t.N_importance)
                 // fmt.BWD_CHUNK)  # kernel 5's split, fine pass
    want = {fmt.KERNEL: 28, "fused_nerf_fwd_acts": 28, "fused_nerf_bwd": 3,
            "fused_nerf_bwd_culled": 25, "fused_nerf_bwd_acts": 28,
            sc.KERNEL: 28, "fused_nerf_grad_reduce": 56,
            "fused_nerf_bwd_chain": 28 * n_chunks,
            "fused_nerf_bwd_weight_grads": 28 * n_chunks}
    print(f"training launches over 25 steps at cull_eps 1e-4 and 3 at 0: "
          f"{train_launches}", flush=True)
    check(train_launches == want, f"training launch counts, want {want}")
    vals = [{k: v.item() for k, v in m.items()} for m in metrics]
    check(all(np.isfinite(v) for m in vals for v in m.values()), "finite metrics")
    losses = [m["loss"] for m in vals]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[15:25]))
    print("training loss per step: " + " ".join(f"{x:.4f}" for x in losses))
    print(f"training psnr step 1 {vals[0]['psnr']:.2f} dB, step 25 "
          f"{vals[24]['psnr']:.2f} dB; mean loss steps 1-10 {first:.5f}, "
          f"steps 16-25 {last:.5f}")
    check(last < first, "training loss falls (mean of steps 16-25 below 1-10)")
    print(f"training steady: {ms_step:.1f} ms/step, "
          f"{TRAIN_N_RAYS * 1e3 / ms_step:,.0f} rays/s on {card}", flush=True)

    profile_step(lambda: step(state, *tables, gen), "step")

    # The backwards' inputs of one step, for the kernel times below.
    captured = {}

    def capture(name):
        orig = getattr(fmt, name)

        def wrapper(*a, **k):
            captured[name] = a
            return orig(*a, **k)
        return wrapper

    with mock.patch.object(fmt, "_bwd_culled_dparams",
                           capture("_bwd_culled_dparams")), \
            mock.patch.object(fmt, "_bwd_acts_dparams",
                              capture("_bwd_acts_dparams")):
        step(state, *tables, gen)
    torch.cuda.synchronize()
    del state, step, step_strict, tm, metrics
    torch.cuda.empty_cache()

    # ---- 6. trajectory: kernel path against plain path ---------------------
    traj_err = trajectories("trajectory", TRAJ_TOL, dev, all_fns, renderer,
                            plain_sampler, semantic=False)

    # ---- 7. training kernel times at the step's shapes (bf16) --------------
    pc, ptc, vdc, gc, spec_c, _ = captured["_bwd_culled_dparams"]
    pf, ptf, vdf, actsf, gf, spec_f, _ = captured["_bwd_acts_dparams"]
    pc = {k: v.detach() for k, v in pc.items()}
    pf = {k: v.detach() for k, v in pf.items()}
    kw_c, kw_f = spec_c.kw(), spec_f.kw()
    pk_c = fmt.pack_params(pc, spec_c.depth, spec_c.dtype, dev)
    pk_f = fmt.pack_params(pf, spec_f.depth, spec_f.dtype, dev)
    xb, vb, gb, flags = fmt.culled_layout(ptc, vdc, gc, spec_c.S)
    live = flags.float().mean().item()
    print(f"coarse backward of a training step: {flags.numel()} tiles, "
          f"{100 * (1 - live):.2f}% skipped by culling")
    t = {}
    with torch.no_grad():
        t["fused_nerf_fwd_acts"] = (
            cuda_ms(lambda: fmt.fused_nerf_fwd_acts(pf, ptf, vdf, spec_f.S,
                                                    packed=pk_f, **kw_f), reps=3),
            cuda_ms(lambda: fmt.fused_nerf_fwd_acts_plain(pf, ptf, vdf, spec_f.S,
                                                          **kw_f), 2, 1))
        t["fused_nerf_bwd_acts"] = (
            cuda_ms(lambda: fmt.fused_nerf_bwd_acts(pf, ptf, vdf, gf, actsf,
                                                    spec_f.S, packed=pk_f,
                                                    **kw_f), 3, 1),
            cuda_ms(lambda: fmt.fused_nerf_bwd_acts_plain(pf, ptf, vdf, gf, actsf,
                                                          spec_f.S, **kw_f), 2, 1))
        split_mem = split_memory(fmt, "kernel 5 (fine pass of the two_mlp step)",
                                 lambda: fmt.fused_nerf_bwd_acts(
                                     pf, ptf, vdf, gf, actsf, spec_f.S, packed=pk_f,
                                     **kw_f), ptf.shape[1], spec_f.depth)
        t.update(split_phase_times(fmt, pf, ptf, vdf, gf, actsf, spec_f.S, kw_f, pk_f))
        t["fused_nerf_bwd_culled"] = (
            cuda_ms(lambda: fmt.fused_nerf_bwd_culled(pc, xb, vb, gb,
                                                      fmt.SAMPLE_BLOCK, flags,
                                                      packed=pk_c, **kw_c), 3, 1),
            cuda_ms(lambda: fmt.fused_nerf_bwd_plain(pc, xb, vb, gb,
                                                     fmt.SAMPLE_BLOCK,
                                                     flags=flags, **kw_c), 2, 1))
        t["fused_nerf_bwd"] = (
            cuda_ms(lambda: fmt.fused_nerf_bwd(pc, ptc, vdc, gc, spec_c.S,
                                               packed=pk_c, **kw_c), 3, 1),
            cuda_ms(lambda: fmt.fused_nerf_bwd_plain(pc, ptc, vdc, gc, spec_c.S,
                                                     **kw_c), 2, 1))
        glue_ms = cuda_ms(lambda: fmt.culled_layout(ptc, vdc, gc, spec_c.S), 5)
    print(f"culling glue (live lengths, sort, regroup, flags): {glue_ms:.3f} ms")
    n_w, n_b = pk_c.weights.numel(), pk_c.biases.numel()
    P_c, P_f = ptc.shape[1], ptf.shape[1]
    N_c, N_f = P_c // spec_c.S, P_f // spec_f.S
    fwd_c = mlp_macs(spec_c.depth, 256, 63, 27, (), spec_c.S)
    fwd_f = mlp_macs(spec_f.depth, 256, 63, 27, (), spec_f.S)
    bwd_c = bwd_macs(spec_c.depth, 256, 63, 27, (), spec_c.S)
    bwd_f = bwd_macs(spec_f.depth, 256, 63, 27, (), spec_f.S)
    live_pts = int(flags.sum().item()) * fmt.TILE
    io = lambda P, N: (3 * P + 3 * N + 4 * P) * 4  # noqa: E731
    acts_bytes = actsf.numel() * actsf.element_size()
    wg_f = wgrad_macs(spec_f.depth, 256, 63, ())
    cot_bytes = fmt.cot_numel(P_f, spec_f.depth, 256, 10) * 2
    work_t = {  # (FLOP, bytes) of this run's inputs
        "fused_nerf_fwd_acts": (2 * fwd_f * P_f,
                                io(P_f, N_f) + n_w * 2 + acts_bytes),
        # phase 1 reads what kernel 5 reads and writes the cotangents and the
        # small gradients; phase 2 reads the activations it multiplies and
        # the cotangents and writes the large gradients
        "fused_nerf_bwd_chain": (2 * (bwd_f - wg_f) * P_f,
                                 io(P_f, N_f) + 2 * n_w * 2 + acts_bytes + cot_bytes
                                 + (n_w + n_b) * 4),
        "fused_nerf_bwd_weight_grads": (2 * wg_f * P_f,
                                        (spec_f.depth + 1) * P_f * 256 * 2 + cot_bytes
                                        + n_w * 4),
        "fused_nerf_bwd_acts": (2 * bwd_f * P_f,
                                io(P_f, N_f) + 2 * n_w * 2 + acts_bytes
                                + (n_w + n_b) * 4),
        "fused_nerf_bwd_culled": (2 * (fwd_c + bwd_c) * live_pts,
                                  io(live_pts, live_pts // fmt.SAMPLE_BLOCK)
                                  + 2 * n_w * 2 + (n_w + n_b) * 4),
        "fused_nerf_bwd": (2 * (fwd_c + bwd_c) * P_c,
                           io(P_c, N_c) + 2 * n_w * 2 + (n_w + n_b) * 4),
    }
    bounds = {}
    for k, (fl, by) in work_t.items():
        t_ops, t_bytes = fl / PEAK_FLOPS["bfloat16"], by / PEAK_BYTES
        bounds[k] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops > t_bytes else "bytes")
        print(f"{k} at the step's shapes (bf16): {t[k][0]:.3f} ms, plain "
              f"{t[k][1]:.3f} ms, {fl / t[k][0] / 1e9:.1f} TFLOP/s, bound "
              f"{bounds[k][0]:.3f} ms ({bounds[k][1]}) on {card}")
    del captured, pc, pf, actsf, gf, gc, xb, vb, gb
    torch.cuda.empty_cache()
    print(f"phase 7 done at {time.time() - T_START:.0f} s", flush=True)

    # ---- 5b, 5c and their trajectories; kernels 9, 12, 13 at the steps' shapes
    s5 = sigma_and_cf_training(fm, fmt, sc, renderer, dev, card, plain_sampler,
                               all_fns, ms_step)

    # ---- 9-11. the semantic stack ----------------------------------------------
    sem = semantic_phases(fmt, sc, renderer, dev, card, plain_sampler)

    src = "depth_lidar_nerf_tpu_torch/csrc/"
    main_launches = {k: launches.get(k, 0) + train_launches.get(k, 0)
                     + int8_launches[k] + sem["launches"][k]
                     + s5["launches"].get(k, 0)
                     for k in sem["launches"]}
    kernels = [
        {"name": fmt.KERNEL, "route": "cuda", "source": src + "fused_nerf_fwd.cu",
         "replaces": "depth_lidar_nerf_tpu/ops/fused_mlp_t.py:249",
         "launches": main_launches[fmt.KERNEL], "max_abs_err": err[fmt.KERNEL],
         "ms": mlp_ms, "plain_ms": mlp_plain_ms, "bound_ms": mlp_bound,
         "bound_by": mlp_by, "library_ms": None},
        {"name": sc.KERNEL, "route": "cuda", "source": src + "sample_pdf.cu",
         "replaces": "depth_lidar_nerf_tpu/ops/sampling_pallas.py:41",
         "launches": main_launches[sc.KERNEL], "max_abs_err": err[sc.KERNEL],
         "ms": sp["frame"]["device_ms"], "plain_ms": sp["frame"]["plain_ms"],
         "bound_ms": sp_bound["frame"], "bound_by": "bytes", "library_ms": None,
         "ms_by": sp["frame"]["device_by"], "events_ms": sp["frame"]["events_ms"],
         "host_us_per_call": sp["frame"]["host_us_per_call"],
         "step": {**sp["step"], "bound_ms": sp_bound["step"]}},
    ]
    for k, source, line in (("fused_nerf_bwd", "fused_nerf_bwd.cu", 316),
                            ("fused_nerf_bwd_culled", "fused_nerf_bwd.cu", 334),
                            ("fused_nerf_fwd_acts", "fused_nerf_fwd.cu", 662),
                            ("fused_nerf_bwd_acts", "fused_nerf_bwd.cu", 677),
                            # the two phases of kernels 5 and 8 in bfloat16
                            ("fused_nerf_bwd_chain", "fused_nerf_bwd.cu", 677),
                            ("fused_nerf_bwd_weight_grads", "fused_nerf_bwd.cu", 677)):
        kernels.append({
            "name": k, "route": "cuda", "source": src + source,
            "replaces": f"depth_lidar_nerf_tpu/ops/fused_mlp_t.py:{line}",
            "launches": main_launches[k], "max_abs_err": err[k], "ms": t[k][0],
            "plain_ms": t[k][1], "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1], "library_ms": None})
    for k, source, line in (("fused_nerf_fwd_sem", "fused_nerf_fwd.cu", 946),
                            ("fused_nerf_fwd_acts_sem", "fused_nerf_fwd.cu", 963),
                            ("fused_nerf_bwd_acts_sem", "fused_nerf_bwd.cu", 981),
                            ("fused_nerf_sem_head", "fused_nerf_fwd.cu", 927),
                            ("fused_nerf_sem_head_bwd", "fused_nerf_bwd.cu", 981)):
        ms_, plain_, bound_, by_ = sem["times"][k]
        kernels.append({
            "name": k, "route": "cuda", "source": src + source,
            "replaces": f"depth_lidar_nerf_tpu/ops/fused_mlp_t.py:{line}",
            "launches": main_launches[k], "max_abs_err": err[k], "ms": ms_,
            "plain_ms": plain_, "bound_ms": bound_, "bound_by": by_,
            "library_ms": None})
    for k, line, times in (("fused_nerf_fwd_q8", 1789, q8_rgb_times),
                           ("fused_nerf_fwd_q8_sem", 1795, sem["q8_sem_times"])):
        kernels.append({
            "name": k, "route": "cuda", "source": src + "fused_nerf_q8.cu",
            "replaces": f"depth_lidar_nerf_tpu/ops/fused_mlp_t.py:{line}",
            "launches": main_launches[k], "max_abs_err": err[k], "ms": times[0],
            "plain_ms": times[1], "bound_ms": times[2], "bound_by": times[3],
            "library_ms": None})
    for k, source, where in (
            ("fused_nerf_fwd_cf", "fused_nerf_fwd.cu", "fused_mlp_t.py:1233"),
            ("fused_nerf_packed_fwd", "fused_nerf_packed.cu", "fused_mlp.py:108"),
            ("fused_nerf_packed_bwd", "fused_nerf_packed.cu", "fused_mlp.py:115"),
            # the two phases of kernel 13 in bfloat16
            ("fused_nerf_packed_chain", "fused_nerf_packed.cu", "fused_mlp.py:115"),
            ("fused_nerf_packed_weight_grads", "fused_nerf_bwd.cu", "fused_mlp.py:115")):
        ms_, plain_, bound_, by_ = s5["times"][k]
        kernels.append({
            "name": k, "route": "cuda", "source": src + source,
            "replaces": f"depth_lidar_nerf_tpu/ops/{where}",
            "launches": main_launches[k], "max_abs_err": err[k], "ms": ms_,
            "plain_ms": plain_, "bound_ms": bound_, "bound_by": by_,
            "library_ms": None})
    parts = {"fused_nerf_sem_head", "fused_nerf_sem_head_bwd",  # parts of rows 6-8
             "fused_nerf_bwd_chain", "fused_nerf_bwd_weight_grads",  # of rows 5, 8
             "fused_nerf_packed_chain", "fused_nerf_packed_weight_grads"}  # of row 13
    check(len({k["name"] for k in kernels} - parts) == 14,
          "every TPU kernel has its counterpart")
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} launched on a main path")
    print(json.dumps({"int8_serving": int8_out}))
    print(json.dumps({"int8_semantic_serving": sem["int8_serving"]}))
    print(json.dumps({"semantic_training": {
        **sem["training"], "trajectory_kernel_vs_plain": sem["trajectory"],
        "split_backward_memory": sem["split_memory"]}}))
    print(json.dumps({"semantic_serving": sem["serving"]}))
    print(json.dumps({"sigma_loss_training": {
        **s5["sigma_training"], "trajectory_kernel_vs_plain": s5["sigma_trajectory"],
        "term_gradients_kernel_vs_plain": s5["sigma_grad"], "card": card}}))
    print(json.dumps({"cf_training": {
        **s5["cf_training"], "trajectory_cf_vs_dense": s5["cf_trajectory"],
        "kernel_checks_blocks_skipped": cf_skipped, "cf_glue_ms": s5["cf_glue_ms"],
        "card": card}}))
    print(f"total {time.time() - T_START:.0f} s")
    print(json.dumps({"training": {
        "ms_per_step": ms_step, "rays_per_s": TRAIN_N_RAYS * 1e3 / ms_step,
        "losses": losses, "launches": train_launches,
        "coarse_tiles_skipped": 1 - live, "culling_glue_ms": glue_ms,
        "split_backward_memory": split_mem,
        "trajectory_kernel_vs_plain": traj_err, "card": card}}))
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
