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
   sequential CDF ends above 1.0; and the grid step's case: 16,384 rays,
   B=127 bins of one row expanded to every ray (row stride 0), weights
   widened from bfloat16 rows), equal to its twin to the last bit; then
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
   kernels 6 and 7 bitwise equal; kernel 8 bit for bit run to run); in
   bfloat16 at 4,096 rays, kernel 8's chain (its input products on the
   tensor cores) against the float64 witness with the head's ray rows at
   D=4 S=64 and D=8 S=128;
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
12. the driver: ``train()`` from a scene on disk that the port's
   ``make_scene`` writes (8 views of 94 x 352, focal 88, 8,000 LiDAR points
   each, view 7 held out), ``configs/synthetic_smoke.txt`` at the
   ``two_mlp`` stack (coarse and fine D=4 / W=256, 64 + 64 samples, 16,384
   rays half LiDAR depth, multires 10/4, bfloat16, the default ``cull_eps``
   and ``lrate``, no semantic loss): run A to step 150 with a checkpoint,
   run B resumed from it to 300 (it must say so), run C from scratch to
   300. Asserts the launch counts of kernels 1, 3, 4, 5 (and its phases)
   and 14 over run C's steps 51-150 and that no other MLP kernel ran, B's
   parameters against C's within ``TRAJ_TOL``'s update limit (and says
   whether they are bit-identical), the [TRAIN] PSNR up by at least 2 dB;
   prints the held-out [TEST] line at 300, ms/step and rays/s over the
   window beside phase 5's bare step, the loop's costs (metric fetches,
   checkpoint saves in ms and MiB, the held-out eval) and each run's wall
   seconds. Then ``python -m depth_lidar_nerf_tpu_torch.train ...
   --render_only --render_test`` in a subprocess writes the held-out view's
   PNG, NPZ and depth PNG, whose rgb must equal an in-process
   ``render_image`` of the restored checkpoint bit for bit; and with
   ``--render_int8`` kernel 10 serves it (the subprocess prints its
   counters);
13. grid training and baked-density-grid serving at ``bench.py``'s grid
   headline (the ``two_mlp`` stack with ``grid_train_fine_only``,
   ``grid_train_samples`` 128 and ``grid_train_res`` 128). 13a, on phase
   5's scene: 5 two-MLP steps; the bakes (the ray CDF over both tables at
   S=128 through kernel 1, the 128^3 grid through the plain module) with
   their ms and MiB; one grid step's launches (kernels 4, 5 and 5's phases
   once a pass, kernel 14 once at B=127 with stride-0 bins, no kernel 1 or
   3); 25 grid steps with a falling loss, ms/step and rays/s beside phase
   5's, one profiled; a 5-step trajectory, kernel path against plain path,
   on one baked table (``GRID_TRAJ_TOL``). 13b, on phase 4's field: the grid
   bake's ms, 3 frames each of ``render_grid`` 128, ``render_grid_fine_only``
   with ``render_grid_samples`` 128, and that with ``render_int8`` (kernel
   10), with launch counts (no coarse MLP kernel), ms/frame beside phase
   4's and frame 0's rgb gap to phase 4's frame; frame 0 of the first two
   against the plain path at phase 4's limits, the int8 one against the
   bf16 kernel frame at phase 4b's. 13c, the driver on phase 12's scene
   with ``--grid_train --grid_train_after 100 --grid_rebake_every 50
   --grid_train_fine_only --grid_train_samples 128``: runs A (to 150), B
   (resumed to 300) and C (to 300); the rebakes at JAX's cadence with
   their times; run C's steps 151-250 timed, their launches asserted; the
   [TRAIN] PSNR up by 2 dB; the [TEST] frame at 300 through the grid; B
   within ``TRAJ_TOL``'s update limit of C (bit-identity reported); the
   CLI's ``--render_only --render_test`` bakes its own grid, and its rgb
   equals an in-process grid render of the checkpoint bit for bit;
14. the patch-loss iteration. 14a: ``configs/kitti360_full.txt``'s loss
   stack (LiDAR depth, inverse-depth smoothness and the VGG19 content loss
   at conv1_2..conv5_4 every 10th iteration, the semantic loss; coarse D=4
   and fine D=8 skip@4 at W=256 with a 19-class head, bfloat16) and patch
   (94 x 352, 32 x 64 rays with gradients) on phase 9's scene: the base
   step's and the patch step's ms, the 10-iteration period (9 base + 1
   patch) per iteration, the grad leg's forward + backward, the no-grad
   leg and VGG19's forward + backward alone, peak device memory, launches
   per leg (the no-grad leg: kernel 6 on both passes of each tile and
   kernel 14; the grad leg: kernels 7 and 8), one profiled patch
   iteration; the patch iterations' total, feature and smoothness losses
   fall over 30 periods of the schedule (300 iterations); the VGG loss of one crop on the card (float32 and TF32)
   against float64 on the CPU; one patch step kernel path against plain
   path (float32 and bfloat16, ``TRAJ_TOL``). 14b: one LPIPS (alex) patch
   step against the plain path; ``patch_ng_int8``: the no-grad leg runs
   kernel 11 and not 1 or 6, and its crop is within 0.03 mean abs of the
   bfloat16 one. 14c: the grid patch step (phase 13's grid fields,
   ``patch_render_samples`` 32; no coarse kernel): ms, launches, kernel
   path against plain path. 14d: the driver on
   ``configs/flagship_synthetic.txt`` cut to 300 iterations on the scene
   ``scripts/flagship_quality.py`` writes (20 views, seed 1): runs A (150),
   B (resumed to 300) and C (300); the [TRAIN] PSNR up by 2 dB from
   iteration 25; the [TEST] line carries LPIPS; B within ``TRAJ_TOL``'s
   update limit of C; the metric keys where the patch iterations fall;
15. the GAN loss, the frozen-alpha model and single-image batching. 15a:
   14a's KITTI stack with the GAN (``GAN_FIELDS``: the GAN keys of
   ``configs/content_loss.txt``, noise std 0.1; an ESR discriminator on the
   94 x 352 crop): the GAN step's and the GAN + feature + smoothness step's
   ms, the discriminator step alone, the 10-iteration period past
   ``gan_start`` (9 GAN + 1 GAN + VGG + smoothness) per iteration, peak
   device memory, launches (those of 14a's patch step), one profiled GAN
   iteration; two runs of 5 GAN iterations from one seed bit for bit
   (discriminator and moments included); one GAN step kernel path against
   plain path from the state of 9 base steps (float32 and bfloat16,
   ``TRAJ_TOL``; the discriminator's update with the MLPs'). 15b: the
   driver on ``configs/flagship_synthetic.txt`` with the GAN, runs A (60),
   B (resumed to 120) and C (120): B equals C bit for bit, the checkpoint's
   MiB, the CLI's ``--render_only --render_test`` frame equal to the
   in-process one. 15c: ``--alpha_model_path`` fine-tunes from phase 12's
   checkpoint, then with ``--no_coarse``: no fused-MLP launch (JAX's route),
   kernel 14 launched, the rendered density the alpha model's bit for bit,
   the density head unmoved. 15d: ``--no_batching`` with ``precrop_iters``
   on phase 12's scene: the base step's launches, ms/step beside phase 5's;
16. ray data parallelism (``parallel/``). 16a: an NCCL group of one
   process, joined as ``--dist_coordinator`` joins it (row-sliced tables,
   the row gather, the ray gathers, the gradient all-reduce): 5 two_mlp
   steps (phase 5's stack at full width) and one GAN iteration of 15a's
   stack equal the non-distributed ones bit for bit, with phase 5's
   launches; ms/step beside the non-distributed step's and phase 5's. 16b:
   two ranks on the one card over gloo (this process rank 0, rank 1
   spawned): the ranks agree bit for bit, and 5 steps are within
   ``TRAJ_TOL`` of one rank's. 16c: the CLI with ``--dist_coordinator`` on
   phase 12's scene: 150 steps equal phase 12's run A bit for bit, the run
   resumed to 300 equals run C, and its ``--render_only`` frame equals an
   in-process frame of its checkpoint;
17. tensor parallelism (``mesh_shape [dp, tp]``, the plain modules with
   their wide layers split by columns). 17a: phase 5's stack on plain
   modules in one process (the route tensor parallelism takes), ms/step
   beside the fused step's in the same call, kernel 14 launched and no
   fused-MLP kernel. 17b: ``mesh_shape [1, 2]``, two gloo ranks on the
   one card (NCCL refuses two ranks on one GPU; its ms/step is not a
   scaling number), ``TP_STEPS`` steps in float32 and in bfloat16 at
   ``TP_N_RAYS``: the ranks' replicated parameters bit for bit equal, the
   gathered parameters and losses against one process's plain run (float32
   step 1 at JAX's ``test_parallel.py:417-422`` limits, then ``TRAJ_TOL``),
   kernel 14 launched on each rank and no fused-MLP kernel, peak MiB a
   rank. 17c: a bfloat16 94 x 352 frame of the seeded weights split over
   the model group against one process's plain frame at phase 4's
   bfloat16 limit. 17d:
   ``train()`` on ``[1, 2]`` over phase 12's scene for ``TP_DRIVER[0]``
   steps with a checkpoint, which resumes in one process on the fused
   route to ``TP_DRIVER[1]`` (it must say so) and serves the held-out view
   through the CLI's ``--render_only``;
then one ``{"kernels": [...]}`` JSON line with every kernel.

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
# The grid step's trajectory (phase 13a): TRAJ_TOL, but for the bfloat16
# update gap (None): the grid stack's own bfloat16 rounding, the gap between
# its plain path in bfloat16 and in float32 in the same run. On two baked
# tables that floor read 0.137 and 0.222 on an H100, against kernel gaps of
# 0.033 and 0.197 (PERF.md, section 6): TRAJ_TOL's 0.15 lies within the
# stack's bfloat16 noise. Float32 carries the check's power.
GRID_TRAJ_TOL = {"float32": TRAJ_TOL["float32"],
                 "bfloat16": (TRAJ_TOL["bfloat16"][0], None)}
TRAIN_N_RAYS, TRAJ_N_RAYS = 16384, 4096
SEM_CLASSES = 19  # bench.py's ref_default_semantic_two_mlp scene
# Semantic kernels against their plain versions, as TRAIN_TOL: per gradient
# tensor max abs error over mean abs of the reference; outputs (raw,
# logits, activations), max abs error over max abs of the reference. Per
# kernel, about 3x its largest gap measured on an H100 (PERF.md): float32
# 1.1e-6 (kernels 6, 7), 1.8e-4 (kernel 8: the gap grows with the points a
# gradient sums), 1.1e-5 (head backward); bfloat16 3.9e-3, 7.4e-3, 3.1e-3,
# 6.8e-6. Kernel 8's bfloat16 chain sums its tensor-core products in
# another order than the twin's float32 products, so some cotangents round
# the other way: its gap to the twin (7.3e-4 to 3.1e-3 over the card
# test's and this file's shapes) is about the twin's own to a float64
# chain (1.05e-3, 2.61e-3; the kernel's 0.97e-3, 2.38e-3). Its accuracy is
# held by the float64 witness (WITNESS_RATIO) and the limit stays below
# TRAIN_TOL's, kernel 5's. The head kernel equals its twin (0); its limit
# is float32 rounding of a 256-term sum.
SEM_TOL = {
    "float32": {"fused_nerf_fwd_sem": 3e-6, "fused_nerf_fwd_acts_sem": 3e-6,
                "fused_nerf_bwd_acts_sem": 5e-4, "fused_nerf_sem_head": 1e-5,
                "fused_nerf_sem_head_bwd": 3e-5},
    "bfloat16": {"fused_nerf_fwd_sem": 1.2e-2, "fused_nerf_fwd_acts_sem": 2e-2,
                 "fused_nerf_bwd_acts_sem": 1e-2, "fused_nerf_sem_head": 1e-5,
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
# The grid step's bins: the midpoints of a 128-entry bake grid.
GRID_B = 127
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
    and, with ``det``, u as the ``expand`` of one row (row stride 0).
    ``layout="grid"`` as the grid step does: that, with the ``[N, B+1]``
    rows rounded to bfloat16 and widened back (the baked table's rows), and
    one row of bins expanded to every ray (row stride 0). With
    ``u_one`` (B > 2) every ray's last weight is 0, so its last bin holds the
    floor alone and the denominator guard fires there; its rows are drawn
    until the sequential float32 CDF ends above 1.0, and its last draw is
    1.0: that draw lands a whole bin below where a CDF rounded to 1.0 or
    less puts it, so a kernel that sums in another order moves it."""
    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.ops.sampling import unit_linspace

    if u_one and B <= 2:
        raise ValueError("u_one needs B > 2: at B = 2 the CDF ends at 1.0")
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.random((N, B), dtype=np.float32), axis=-1)

    def rows_of(a):  # the grid step's weights are widened bfloat16 rows
        if layout != "grid":
            return a
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    if u_one:
        rows, n = [], 0
        while n < N:
            c = rows_of(rng.random((4 * N, B + 1), dtype=np.float32) ** 3)
            c[:, -2] = 0.0
            c = c[sequential_cdf_np(c[:, 1:-1])[:, -1] > 1.0]
            rows.append(c)
            n += len(c)
        w = np.concatenate(rows)[:N]
    else:
        w = rows_of(rng.random((N, B + 1), dtype=np.float32) ** 3)
        w[0] = 0.0
        w[min(1, N - 1), 1:1 + B // 2] = 0.0
    weights = torch.from_numpy(w).to(dev)[:, 1:-1]
    if det:
        u = unit_linspace(V, dev).expand(N, V)
    else:
        u = torch.from_numpy(rng.random((N, V), dtype=np.float32)).to(dev)
        if u_one:
            u[:, -1] = 1.0
    if layout == "contiguous":
        weights, u = weights.contiguous(), u.contiguous()
    bins = torch.from_numpy(bins).to(dev)
    if layout == "grid":
        bins = bins[0].expand(N, B)
    return bins, weights, u


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
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "busy": dev_ms / wall_ms, "idle_ms": wall_ms - dev_ms}


def sass_tensor_core_check(_build, fmt, fm):
    """The bfloat16 products run on the tensor cores: ``cuobjdump
    --dump-sass`` of the built libraries shows HMMA (or HGMMA) in every
    bfloat16 instantiation of the forward kernels (1, 4, 6, 7, 9), of the
    recompute backward (2, 3; more than the forward tile alone has, so its
    backward tile has them too), of the split backward's phase 1
    (``fused_nerf_bwd_acts_kernel``: kernel 5's and kernel 8's) and in phase
    2's ``fused_nerf_wgrad_kernel``; none in a float32 instantiation. Every
    instantiation of the int8 tile (``fused_nerf_q8_kernel``, kernels
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
                         ("kernel 8 phase-1", sem)):
        print(f"SASS: tensor-core instructions per bfloat16 {label} kernel "
              f"{sorted(k[4] for k in group if k[1] != 'f32')}, per float32 one "
              f"{sorted(k[4] for k in group if k[1] == 'f32')}")
    check(sum(k[1] == "bf16" for k in tile) == sum(k[1] == "f32" for k in tile) == 14,
          "14 forward-tile instantiations of each type in the SASS")
    check(all(sum(k[1] == "bf16" for k in group) == sum(k[1] == "f32" for k in group) == 2
              for group in (split, sem))
          and [k[0] for k in split if k[1] == "bf16 only"] == ["fused_nerf_wgrad_kernel"],
          "2 bfloat16 and 2 float32 instantiations each of kernels 5 and 8, and the phase-2 "
          "kernel in the SASS")
    check(all(k[4] > 0 for k in tile + split + sem if k[1] != "f32"),
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


def bwd_witness(fmt, params, pts, vd, g, acts, grads, S, depth, dfeat_ray=None):
    """Phase 3: the bfloat16 split backward against the float64 witness
    (fused_mlp_t.bwd_product_witness): phase 1's cotangents of all the
    points (one chunk) rounded otherwise no more often than by float32
    products (WITNESS_RATIO, summed over the layers); the weight gradients'
    max-over-mean errors against float64 products printed beside float32's.
    With the semantic head's ray rows ``dfeat_ray``, kernel 8's chain."""
    import torch

    P = pts.shape[1]
    kw = dict(depth=depth, width=256, multires=10, multires_views=4, skips=(4,))
    pk = fmt.pack_params(params, depth, torch.bfloat16, pts.device)
    part = torch.zeros((fmt._grid(pts.device, 1 << 30),
                        -(-(pk.weights.numel() + pk.biases.numel()) // 4) * 4),
                       device=pts.device)
    cot = fmt.fused_nerf_bwd_chain(params, pts.contiguous(), vd.contiguous(), g, acts,
                                   S, 0, P, part, dtype=torch.bfloat16, packed=pk,
                                   dfeat_ray=dfeat_ray, **kw)
    wit = fmt.bwd_product_witness(params, g, acts, cot, grads, S, depth=depth,
                                  width=256, multires=10, skips=(4,), dfeat_ray=dfeat_ray)
    sk, s32 = sum(wit["kernel"]), sum(wit["float32"])
    wk, w32 = max(wit["wgrad_kernel"].values()), max(wit["wgrad_float32"].values())
    label = "bf16 backward" if dfeat_ray is None else "bf16 kernel 8"
    print(f"{label} against the float64 witness D={depth} N={P // S} S={S}: "
          "cotangents rounded otherwise per layer (dhv, dfeat, dh_D-1 .. dh_0) kernel "
          + " ".join(f"{x:.3g}" for x in wit["kernel"]) + "; float32 products "
          + " ".join(f"{x:.3g}" for x in wit["float32"])
          + f"; summed {sk:.4g} against {s32:.4g} ({sk / s32:.3f}x, limit "
          f"{WITNESS_RATIO:g}x); weight gradients max abs err over mean abs, worst "
          f"block: kernel {wk:.3g}, float32 products {w32:.3g}", flush=True)
    check(sk <= WITNESS_RATIO * s32, f"{label} against the float64 witness D={depth} S={S}")
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
                if dtype == torch.bfloat16 and n_rays == 4096 \
                        and (depth, S) in ((4, 64), (8, 128)):
                    bwd_witness(fmt, params, pts, vd, g, acts, grads, S, depth,
                                dfeat_ray=hdfeat)
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
        for m in models.nerfs():
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
        for m in models.nerfs():
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
        for m in models.nerfs():
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


def kernel_fns():
    """Every kernel wrapper with a launch counter, by kernel name (the
    registry of ``utils.tracing``, once every kernel module is imported)."""
    from depth_lidar_nerf_tpu_torch.ops import (fused_mlp,  # noqa: F401
                                                fused_mlp_t, sampling_cuda)
    from depth_lidar_nerf_tpu_torch.utils import tracing

    return tracing.launch_wrappers()


def semantic_phases(fmt, sc, renderer, dev, card, plain_sampler):
    """Phases 9-11 (see the module note). Returns the numbers for the JSON
    lines: training, serving, each kernel's launches on these main paths,
    and each semantic kernel's (ms, plain ms, bound ms, bound by)."""
    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train.state import init_train_state
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    fns = kernel_fns()
    out = {}

    # ---- 9. semantic training ----------------------------------------------
    t0 = time.time()
    cfg, rcfg, sm, tables, scene = bench_stack(dev, TRAIN_N_RAYS, "bfloat16",
                                               semantic=True)
    seeded = [{k: v.detach().clone() for k, v in m.state_dict().items()}
              for m in sm.nerfs()]
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
    for m, sd in zip(sm.nerfs(), seeded):
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
    fns = kernel_fns()
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

    # A wrapper counts its launches (and its split calls) through its
    # module-level name, which the stand-in takes over: give it counters of
    # its own.
    cap_bwd.launches = cap_bwd.split_calls = 0
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
    models = models._replace(coarse=models.coarse.to(dev),
                             fine=models.fine.to(dev))
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
                 sigma_loss=False, grid=None):
    """5 steps of the kernel path and of the plain path (plain modules and
    the sampling twin, which must launch no kernel) of a :func:`bench_stack`
    from the same weights and generator seed, TRAJ_N_RAYS rays, float32 and
    bfloat16, perturbation and noise on. With ``grid = (fields, cdf)``, grid
    steps of the stack with ``fields`` set, all four runs fed the one baked
    ray CDF ``cdf``. Prints and checks against ``tol`` (max relative loss
    gap over the steps; max over parameters of the relative L2 gap of their
    5-step updates) and returns the gaps."""
    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.train import step as step_mod
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
            kw = {}
            if grid is not None:
                cfg = cfg.replace(**grid[0])
                kw["aux"] = grid[1]
            stp = make_train_step(cfg, rcfg, mj, scn.hwf,
                                  grid_mode=grid is not None)
            gen = torch.Generator(device=dev).manual_seed(7)
            nets = (("coarse", mj.coarse), ("fine", mj.fine))
            init = {f"{net}.{n}": p.detach().clone()
                    for net, m in nets for n, p in m.named_parameters()}
            n_before = [fn.launches for fn in fns]
            with contextlib.ExitStack() as ctx:
                if plain:
                    for mod in (renderer, step_mod):
                        ctx.enter_context(mock.patch.object(
                            mod, "sample_pdf_cuda", plain_sampler))
                ls = [stp(st, *tabs, gen, **kw)["loss"].item()
                      for _ in range(5)]
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
        # A parameter that never had a gradient (the coarse MLP under grid
        # steps) has zero Adam moments: it must not move on either path.
        still = {k for k in pb if not pb[k].any()}
        check(all(not pa[k].any() for k in still),
              f"{label}: parameters without a gradient stay put")
        return (float(np.max(np.abs(la - lb) / np.abs(lb))),
                max((torch.linalg.norm(pa[k] - pb[k])
                     / torch.linalg.norm(pb[k])).item()
                    for k in pb if k not in still))

    gaps = {d: gap((d, False), (d, True)) for d in ("float32", "bfloat16")}
    gaps["plain_bf16_vs_f32"] = gap(("bfloat16", True), ("float32", True))
    # An update limit of None is the plain path's bfloat16-vs-float32 gap.
    tol = {d: (t[0], gaps["plain_bf16_vs_f32"][1] if t[1] is None else t[1])
           for d, t in tol.items()}
    for d in ("float32", "bfloat16"):
        print(f"{label} {d}, 5 steps of {TRAJ_N_RAYS} rays, kernel vs plain: "
              f"max loss gap {gaps[d][0]:.3g}, max update gap {gaps[d][1]:.3g} "
              f"(tolerance {tol[d][0]:g}, {tol[d][1]:g}); losses kernel "
              + " ".join(f"{x:.5f}" for x in traj[d, False][0])
              + " plain " + " ".join(f"{x:.5f}" for x in traj[d, True][0]))
    print(f"{label} for scale, plain bfloat16 vs plain float32: max loss gap "
          f"{gaps['plain_bf16_vs_f32'][0]:.3g}, max update gap "
          f"{gaps['plain_bf16_vs_f32'][1]:.3g}", flush=True)
    (_, pk), (_, pp) = traj["bfloat16", False], traj["bfloat16", True]
    worst = sorted(((torch.linalg.norm(pk[k] - pp[k])
                     / torch.linalg.norm(pp[k])).item(), k, pp[k].numel())
                   for k in pp if pp[k].any())[-3:]
    print(f"{label} bfloat16 largest update gaps (gap, parameter, elements): "
          f"{worst[::-1]}", flush=True)
    for d in ("float32", "bfloat16"):
        check(gaps[d][0] <= tol[d][0] and gaps[d][1] <= tol[d][1],
              f"{label} {d}")
    return gaps

# Phase 12, the driver: the two_mlp stack trained from a scene on disk.
DRIVER_VIEWS, DRIVER_HOLDOUT, DRIVER_DEPTH_POINTS = 8, 7, 8000
DRIVER_STEPS = (150, 300)  # run A stops and saves at 150; B and C end at 300
DRIVER_PRINT = 25  # i_print: the first [TRAIN] line at step 25
DRIVER_WINDOW = (50, 150)  # run C's steps 51-150: timed, launches counted
DRIVER_PSNR_GAIN = 2.0  # dB, JAX's test_train_rgb_only_psnr_climbs
# Run the CLI as ``python -m`` does, then print the launch counters.
CLI_COUNTING = (
    "import json, runpy, sys\n"
    "runpy.run_module('depth_lidar_nerf_tpu_torch.train', run_name='__main__',"
    " alter_sys=True)\n"
    "from depth_lidar_nerf_tpu_torch.utils import tracing\n"
    "print('launches ' + json.dumps(tracing.launch_counts()))\n")


class _Tee:
    """Copies what a run prints to the smoke's own stdout and keeps it."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def driver_argv(root, expname, n_iters, extra=()):
    """The driver's command line (phases 12 and 13c): the scene written
    under ``root``, ``configs/synthetic_smoke.txt`` at the ``two_mlp``
    stack, then ``extra``."""
    return ["--config", os.path.join(HERE, "configs", "synthetic_smoke.txt"),
            "--datadir", os.path.join(root, "scene"),
            "--basedir", os.path.join(root, "logs"), "--expname", expname,
            "--netdepth", "4", "--netwidth", "256", "--netdepth_fine", "4",
            "--netwidth_fine", "256", "--N_samples", "64",
            "--N_importance", "64", "--N_rand", str(TRAIN_N_RAYS),
            "--multires", "10", "--multires_views", "4",
            "--compute_dtype", "bfloat16", "--lrate", "5e-4",
            "--cull_eps", "1e-4", "--semantic_loss", "False",
            "--test_scene", str(DRIVER_HOLDOUT), "--N_iters", str(n_iters),
            "--i_print", str(DRIVER_PRINT),
            "--i_weights", str(DRIVER_STEPS[0]),
            "--i_testset", str(DRIVER_STEPS[1]), "--i_img", "0",
            "--i_video", "0", *extra]


def driver_run(cfg, hook=None):
    """``train(cfg)`` with what it prints kept: (state, wall s, text)."""
    import torch

    from depth_lidar_nerf_tpu_torch.train.loop import train

    tee = _Tee(sys.stdout)
    t = time.time()
    with contextlib.redirect_stdout(tee):
        state = train(cfg, metrics_hook=hook)
    torch.cuda.synchronize()
    return state, time.time() - t, tee.text()


def net_params(models, clone=False):
    """Both MLPs' tensors by ``net.name``, and the discriminator's where
    there is one (``disc.name``)."""
    nets = [("coarse", models.coarse), ("fine", models.fine)]
    if getattr(models, "discriminator", None) is not None:
        nets.append(("disc", models.discriminator))
    return {f"{net}.{k}": v.detach().clone() if clone else v.detach()
            for net, m in nets for k, v in m.state_dict().items()}


def resume_check(label, params_b, state_c, cfg_c, rcfg, dev):
    """Run B (resumed) against run C (uninterrupted) at the last step: the
    max over tensors of the relative L2 gap of their updates from the seeded
    initial weights, held to ``TRAJ_TOL``'s bf16 update limit, and whether
    they are bit-identical."""
    import torch

    from depth_lidar_nerf_tpu_torch.train.state import build_models

    p0 = net_params(build_models(cfg_c, rcfg, device=dev, seed=cfg_c.seed))
    params_c = net_params(state_c.models)
    identical = all(torch.equal(params_b[k], params_c[k]) for k in params_c)
    per = sorted(((torch.linalg.norm(params_b[k] - params_c[k])
                   / torch.linalg.norm(params_c[k] - p0[k])).item(), k)
                 for k in params_c)
    gap = per[-1][0]
    print(f"{label} resumed run B vs uninterrupted run C at step "
          f"{DRIVER_STEPS[1]}: max update gap {gap:.3g} (tolerance "
          f"{TRAJ_TOL['bfloat16'][1]:g}), bit-identical {identical}; "
          f"largest gaps {per[-3:][::-1]}")
    check(gap <= TRAJ_TOL["bfloat16"][1], f"{label}: resumed run vs "
          "uninterrupted run")
    return gap, identical


def driver_phase(fmt, sc, dev, card, ms_step_5, fns, keep=None):
    """Phase 12: ``train()`` on a scene that the port's ``make_scene`` writes
    to disk (8 views of 94 x 352, focal 88, 8,000 LiDAR points each, view 7
    held out), ``configs/synthetic_smoke.txt`` at the ``two_mlp`` stack
    (coarse and fine D=4 / W=256, 64 + 64 samples, 16,384 rays half LiDAR
    depth, multires 10/4, bfloat16, the default ``cull_eps`` and ``lrate``,
    no semantic loss). Run A trains to step 150 and saves; run B resumes it
    to 300 and must say so; run C goes from scratch to 300, timed over its
    steps 51-150 with the kernels' launches counted there. B's final
    parameters against C's by ``TRAJ_TOL``'s update limit; the [TRAIN] PSNR
    up by ``DRIVER_PSNR_GAIN``; the held-out [TEST] line at 300. Then the
    CLI serves the held-out view (``--render_only --render_test``) in a
    subprocess, whose rgb must equal an in-process ``render_image`` of the
    restored checkpoint bit for bit, and again with ``--render_int8``
    (kernel 10). Returns the numbers for the JSON line and the window's
    launch counts. With a list ``keep``, the scene and run C's checkpoint
    stay on disk for phase 15 (``(tmp, cfg_c)`` appended; the caller cleans
    up)."""
    import tempfile

    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene
    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train import checkpoint
    from depth_lidar_nerf_tpu_torch.train.config import (eval_render_config,
                                                         parse_args,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.loop import load_scene, step_seed
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step
    from depth_lidar_nerf_tpu_torch.train.tables import (build_depth_table,
                                                         build_rgb_table)

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_driver_")
    root = tmp.name
    t0 = time.time()
    make_scene(os.path.join(root, "scene"), n_images=DRIVER_VIEWS, H=H, W=W,
               focal=FOCAL, n_depth_points=DRIVER_DEPTH_POINTS, backdrop=True)
    print(f"driver: scene of {DRIVER_VIEWS} views {H}x{W} written in "
          f"{time.time() - t0:.2f} s", flush=True)

    def argv(expname, n_iters):
        return driver_argv(root, expname, n_iters)

    cfg_a = parse_args(argv("resumed", DRIVER_STEPS[0]))
    check(cfg_a.colmap_depth and cfg_a.depth_loss and cfg_a.use_viewdirs
          and cfg_a.no_ndc and cfg_a.should_seed and not cfg_a.semantic_loss
          and cfg_a.lrate == 5e-4 and cfg_a.cull_eps == 1e-4,
          "driver config")
    run = driver_run

    state_a, wall_a, _ = run(cfg_a)
    check(state_a.step == DRIVER_STEPS[0], "run A's step")
    del state_a
    state_b, wall_b, out_b = run(cfg_a.replace(N_iters=DRIVER_STEPS[1]))
    check(f"resumed from checkpoint at step {DRIVER_STEPS[0]}" in out_b,
          "run B resumes from run A's checkpoint")
    check(state_b.step == DRIVER_STEPS[1], "run B's step")
    params_b = net_params(state_b.models, clone=True)
    test_b = [l for l in out_b.splitlines() if l.startswith("[TEST]")]
    del state_b
    torch.cuda.empty_cache()

    psnrs, window = {}, {}

    def hook(i, m):
        psnrs[i] = m["psnr"]
        if i == DRIVER_WINDOW[0]:
            torch.cuda.synchronize()
            for fn in fns.values():
                fn.launches = 0
            window["t0"] = time.time()
        elif i == DRIVER_WINDOW[1]:
            torch.cuda.synchronize()
            window["t1"] = time.time()
            window["launches"] = {k: fn.launches for k, fn in fns.items()}

    cfg_c = cfg_a.replace(expname="fresh", N_iters=DRIVER_STEPS[1])
    state_c, wall_c, out_c = run(cfg_c, hook)
    check(state_c.step == DRIVER_STEPS[1], "run C's step")
    n_win = DRIVER_WINDOW[1] - DRIVER_WINDOW[0]
    ms_step = (window["t1"] - window["t0"]) * 1e3 / n_win
    launches = window["launches"]
    rcfg = render_config_from(cfg_c, 0, 0.0, 1.0)
    n_chunks = -(-TRAIN_N_RAYS * (rcfg.N_samples + rcfg.N_importance)
                 // fmt.BWD_CHUNK)
    want = {k: 0 for k in fns}
    want.update({fmt.KERNEL: n_win, "fused_nerf_fwd_acts": n_win,
                 "fused_nerf_bwd_culled": n_win, "fused_nerf_bwd_acts": n_win,
                 sc.KERNEL: n_win, "fused_nerf_grad_reduce": 2 * n_win,
                 "fused_nerf_bwd_chain": n_win * n_chunks,
                 "fused_nerf_bwd_weight_grads": n_win * n_chunks})
    print(f"driver run C launches over steps {DRIVER_WINDOW[0] + 1}-"
          f"{DRIVER_WINDOW[1]}: {launches}", flush=True)
    check(launches == want, f"driver launch counts, want {want}")

    # B against C: the same trajectory from one seed, one resumed at 150.
    gap, identical = resume_check("driver", params_b, state_c, cfg_c, rcfg,
                                  dev)

    # Where the window's time goes: run C's state and the driver's scene in
    # a bare step, timed by CUDA events as phase 5 times its step, then the
    # same steps with the loop's per-step seeding on the host clock, and one
    # step profiled.
    del params_b
    scene = load_scene(cfg_c)
    rcfg_s = render_config_from(cfg_c, 0, scene.near, scene.far)
    tabs = (build_rgb_table(scene.images, scene.poses, scene.i_train,
                            *scene.hwf, rcfg_s, device=dev),
            build_depth_table(scene.depth_gts, scene.poses, scene.i_train,
                              *scene.hwf, rcfg_s, device=dev))
    bare = make_train_step(cfg_c, rcfg_s, state_c.models, scene.hwf)
    gen = torch.Generator(device=dev).manual_seed(0)
    bare_ms = cuda_ms(lambda: bare(state_c, *tabs, gen), reps=20, warmup=3)

    def seeded():
        for i in range(20):
            gen.manual_seed(step_seed(cfg_c.seed, i))
            bare(state_c, *tabs, gen)

    torch.cuda.synchronize()
    t = time.time()
    seeded()
    torch.cuda.synchronize()
    seeded_ms = (time.time() - t) * 1e3 / 20
    print(f"driver scene, run C's state: bare step {bare_ms:.1f} ms (CUDA "
          f"events, as phase 5), seeded as the loop seeds {seeded_ms:.1f} ms "
          f"(host clock) on {card}")
    profile_step(lambda: bare(state_c, *tabs, gen), "driver-scene step")
    del bare, tabs

    steps_seen = sorted(psnrs)
    first, last = psnrs[steps_seen[0]], psnrs[steps_seen[-1]]
    test_c = [l for l in out_c.splitlines() if l.startswith("[TEST]")]
    print(f"driver [TRAIN] psnr step {steps_seen[0]} {first:.2f} dB, step "
          f"{steps_seen[-1]} {last:.2f} dB; held-out view {DRIVER_HOLDOUT}: "
          f"{test_c} (run B: {test_b})")
    check(last >= first + DRIVER_PSNR_GAIN, "driver PSNR climbs by 2 dB")
    check(len(test_c) == 1 and len(test_b) == 1, "held-out [TEST] lines")
    print(f"driver two_mlp: {ms_step:.1f} ms/step, "
          f"{TRAIN_N_RAYS * 1e3 / ms_step:,.0f} rays/s over steps "
          f"{DRIVER_WINDOW[0] + 1}-{DRIVER_WINDOW[1]} of run C (phase 5's bare "
          f"step: {ms_step_5:.1f} ms) on {card}; wall s: run A {wall_a:.1f}, "
          f"run B {wall_b:.1f}, run C {wall_c:.1f}", flush=True)
    del state_c
    torch.cuda.empty_cache()

    # Serving through the CLI, then the same frame in process.
    expdir = os.path.join(root, "logs", "fresh")
    outdir = os.path.join(expdir, f"renderonly_test_{DRIVER_STEPS[1]:06d}")
    cli = argv("fresh", DRIVER_STEPS[1]) + ["--render_only", "--render_test"]
    t = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "depth_lidar_nerf_tpu_torch.train", *cli],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    wall_cli = time.time() - t
    print(f"driver CLI --render_only --render_test: exit {proc.returncode} in "
          f"{wall_cli:.1f} s; {proc.stdout.strip().splitlines()[-1:]}")
    check(proc.returncode == 0, f"CLI render_only: {proc.stderr[-2000:]}")
    files = sorted(os.listdir(outdir))
    check({"000.png", "000.npz", "000_depth.png"} <= set(files),
          f"CLI render_only outputs {files}")
    served = np.load(os.path.join(outdir, "000.npz"))["rgb"]
    scene = load_scene(cfg_c)
    rcfg = render_config_from(cfg_c, 0, scene.near, scene.far)
    models = build_models(cfg_c, rcfg, device=dev)
    state = checkpoint.restore(
        checkpoint.load_file(checkpoint.path_of(
            checkpoint.ckpt_dir(cfg_c.basedir, cfg_c.expname), DRIVER_STEPS[1])),
        init_train_state(cfg_c, models), checkpoint.topology(cfg_c, 0))
    frame = render_image(models.coarse, models.fine, H, W, FOCAL,
                         scene.poses[DRIVER_HOLDOUT],
                         eval_render_config(cfg_c, rcfg), device=dev)
    rgb = frame["rgb_map"].float().cpu().numpy()
    cli_equal = bool(np.array_equal(rgb, served))
    print(f"driver CLI frame vs in-process render_image of checkpoint "
          f"{state.step}: bit-identical {cli_equal} (max abs diff "
          f"{np.abs(rgb - served).max():.3g})")
    check(cli_equal, "CLI frame equals the in-process frame bit for bit")

    t = time.time()
    proc = subprocess.run([sys.executable, "-c", CLI_COUNTING, *cli,
                           "--render_int8"], cwd=HERE, capture_output=True,
                          text=True, timeout=600)
    wall_int8 = time.time() - t
    check(proc.returncode == 0, f"CLI render_only int8: {proc.stderr[-2000:]}")
    counts = json.loads([l for l in proc.stdout.splitlines()
                         if l.startswith("launches ")][-1][len("launches "):])
    served8 = np.load(os.path.join(outdir, "000.npz"))["rgb"]
    n_tiles = -(-H * W // rcfg.render_tile(fused=True))
    print(f"driver CLI --render_int8: exit 0 in {wall_int8:.1f} s, launches "
          f"{counts}; rgb mean abs gap to the bf16 frame "
          f"{np.abs(served8 - served).mean():.3g}")
    check(counts["fused_nerf_fwd_q8"] == 2 * n_tiles
          and counts["fused_nerf_fwd"] == 0, "kernel 10 served the int8 frame")
    if keep is None:
        tmp.cleanup()
    else:
        keep.append((tmp, cfg_c))
    return {"ms_per_step": ms_step, "rays_per_s": TRAIN_N_RAYS * 1e3 / ms_step,
            "bare_step_ms_phase5": ms_step_5,
            "bare_step_ms_driver_scene": bare_ms,
            "seeded_step_ms_driver_scene": seeded_ms,
            "window_launches": launches,
            "psnr_first": first, "psnr_last": last, "test_line": test_c[0],
            "resume_update_gap": gap, "resume_bit_identical": identical,
            "wall_s": {"A": wall_a, "B": wall_b, "C": wall_c,
                       "cli": wall_cli, "cli_int8": wall_int8},
            "cli_frame_bit_identical": cli_equal,
            "cli_int8_launches": counts, "card": card}, launches


# Phase 13, grid training and serving: bench.py's grid headline
# (bench.py:103-129): the two_mlp stack with grid_train_fine_only,
# grid_train_samples 128 and grid_train_res 128.
GRID_FIELDS = dict(grid_train=True, grid_train_fine_only=True,
                   grid_train_samples=128, grid_train_res=128)
GRID_WARM = 5  # two-MLP steps before the bake (13a)
GRID_STEPS = (5, 20)  # grid steps: warm-up, timed (13a)
BAKE_CHUNK = 1 << 14  # rays a kernel-1 launch of the ray-CDF bake
# 13c: the driver's grid run, and its window of grid steps (two rebakes).
GRID_DRIVER_FLAGS = ("--grid_train", "True", "--grid_train_after", "100",
                     "--grid_rebake_every", "50", "--grid_train_fine_only",
                     "True", "--grid_train_samples", "128")
GRID_DRIVER_WINDOW = (150, 250)
GRID_REBAKES = {"A": [101], "B": [151, 201, 251], "C": [101, 151, 201, 251]}


def serving_field(cfg, rcfg, dev):
    """Phase 4's served field: ``build_models`` from the config's seed with
    the density head scaled and offset and the colour head scaled, so that
    density and colour vary across the frame with no empty ray (where the
    reference's disparity is 0/0)."""
    import torch

    from depth_lidar_nerf_tpu_torch.train.state import build_models

    models = build_models(cfg, rcfg, device=dev)
    with torch.no_grad():
        for m in models.nerfs():
            m.sigma.weight *= SIGMA_SCALE
            m.sigma.bias += SIGMA_OFFSET
            m.rgb.weight *= RGB_SCALE
    return models


def _counter(fns):
    """(zero, counts) over the launch counters of ``fns``."""
    def zero():
        for fn in fns.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in fns.items()}
    return zero, counts


def bake_launches(tables):
    """Kernel 1's launches in one ray-CDF bake: a launch a chunk of a
    table's rays."""
    return sum(-(-t.origins.shape[0] // BAKE_CHUNK) for t in tables
               if t is not None)


def grid_step_phase(fmt, sc, renderer, dev, card, plain_sampler, fns, all_fns,
                    ms_step_5):
    """Phase 13a: the grid step of ``bench.py``'s headline stack on phase 5's
    in-memory scene. 5 two-MLP steps, then the bakes (the ray CDF over both
    tables at S = 128: kernel 1 a chunk of 16,384 rays; the 128^3 grid:
    the plain module), one grid step whose launches are asserted (kernels
    4 and 5 and 5's phases once a pass, kernel 14 once at B = 127 with
    stride-0 bins, no kernel 1 or 3), 25 more (5 untimed) with a falling
    loss, one profiled; then a 5-step trajectory, kernel path against
    plain path, on one baked table. Returns the numbers and the launches."""
    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.ops.ray_cdf import bake_ray_cdf
    from depth_lidar_nerf_tpu_torch.train.loop import (bake_grid,
                                                       grid_bounds_for_poses)
    from depth_lidar_nerf_tpu_torch.train.state import init_train_state
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    zero, counts = _counter(fns)
    launches = dict.fromkeys(fns, 0)

    def add(got):
        for k in fns:
            launches[k] += got[k]

    cfg, rcfg, tm, tables, scene = bench_stack(dev, TRAIN_N_RAYS, "bfloat16")
    cfg = cfg.replace(**GRID_FIELDS)
    state = init_train_state(cfg, tm)
    gen = torch.Generator(device=dev).manual_seed(0)
    step = make_train_step(cfg, rcfg, tm, scene.hwf)
    for _ in range(GRID_WARM):
        step(state, *tables, gen)
    gstep = make_train_step(cfg, rcfg, tm, scene.hwf, grid_mode=True)
    torch.cuda.synchronize()

    zero()
    t0 = time.time()
    cdf = bake_ray_cdf(tm, rcfg, *tables, cfg.grid_train_samples)
    torch.cuda.synchronize()
    cdf_ms = (time.time() - t0) * 1e3
    got = counts()
    want = dict.fromkeys(fns, 0)
    want[fmt.KERNEL] = bake_launches(tables)
    check(got == want, f"ray-CDF bake launches {got}, want {want}")
    add(got)
    S = cfg.grid_train_samples
    check(cdf.w_rgb.shape == (tables[0].origins.shape[0], S)
          and cdf.w_depth.shape == (tables[1].origins.shape[0], S)
          and cdf.w_rgb.dtype == torch.bfloat16 and cdf.z.shape == (S,),
          "ray CDF shapes")
    check(bool(torch.isfinite(cdf.w_rgb.float()).all()), "finite ray CDF")
    cdf_mib = (cdf.w_rgb.numel() + cdf.w_depth.numel()) * 2 / 2 ** 20
    lo, hi = grid_bounds_for_poses(rcfg, scene.poses, scene.hwf)
    grid_ms = []  # the first bake of the process, then a rebake
    for _ in range(2):
        t0 = time.time()
        grid3 = bake_grid(rcfg, tm, lo, hi, cfg.grid_train_res, verbose=False)
        torch.cuda.synchronize()
        grid_ms.append((time.time() - t0) * 1e3)
    check(counts() == want, "the 3-D bake runs the plain module (no kernel)")
    check(bool(torch.isfinite(grid3[0]).all()), "finite density grid")
    grid_mib = grid3[0].numel() * 4 / 2 ** 20
    print(f"grid bakes ({card}): ray CDF of {tables[0].origins.shape[0]} rgb + "
          f"{tables[1].origins.shape[0]} depth rays at S={S} in {cdf_ms:.1f} ms "
          f"({want[fmt.KERNEL]} kernel-1 launches), {cdf_mib:.2f} MiB bf16; "
          f"{cfg.grid_train_res}^3 grid in {grid_ms[0]:.1f} ms (the process's "
          f"first), {grid_ms[1]:.1f} ms (again), {grid_mib:.2f} MiB", flush=True)
    del grid3

    # One grid step: its launches, and kernel 14's inputs as it takes them.
    seen = []
    orig_launch = sc._launch

    def spy(bins, weights, u):
        seen.append((tuple(bins.shape), bins.stride(0), weights.stride(0),
                     tuple(u.shape)))
        return orig_launch(bins, weights, u)

    zero()
    with mock.patch.object(sc, "_launch", spy):
        gstep(state, *tables, gen, aux=cdf)
    torch.cuda.synchronize()
    one = counts()
    n_chunks = -(-TRAIN_N_RAYS * cfg.N_importance // fmt.BWD_CHUNK)
    want = dict.fromkeys(fns, 0)
    want.update({"fused_nerf_fwd_acts": 1, "fused_nerf_bwd_acts": 1,
                 "fused_nerf_bwd_chain": n_chunks,
                 "fused_nerf_bwd_weight_grads": n_chunks,
                 "fused_nerf_grad_reduce": 1, sc.KERNEL: 1})
    print(f"grid step launches: {one}; kernel 14 took (bins shape, bins row "
          f"stride, weights row stride, u shape) {seen}", flush=True)
    check(one == want, f"grid step launch counts, want {want}")
    check(seen == [((TRAIN_N_RAYS, GRID_B), 0, GRID_B + 1,
                    (TRAIN_N_RAYS, cfg.N_importance))],
          "kernel 14 at B = 127 with stride-0 bins")
    add(one)

    zero()
    warm, timed = GRID_STEPS
    metrics = [gstep(state, *tables, gen, aux=cdf) for _ in range(warm)]
    ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
    ev0.record()
    metrics += [gstep(state, *tables, gen, aux=cdf) for _ in range(timed)]
    ev1.record()
    torch.cuda.synchronize()
    ms = ev0.elapsed_time(ev1) / timed
    got = counts()
    check(got == {k: v * (warm + timed) for k, v in want.items()},
          f"launch counts of {warm + timed} grid steps {got}")
    add(got)
    vals = [{k: v.item() for k, v in m.items()} for m in metrics]
    check(all(np.isfinite(v) for m in vals for v in m.values()), "finite metrics")
    check(not {"img_loss0", "psnr0"} & set(vals[0]), "no coarse loss terms")
    losses = [m["loss"] for m in vals]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[15:25]))
    print("grid step loss per step: " + " ".join(f"{x:.4f}" for x in losses))
    print(f"grid step psnr step 1 {vals[0]['psnr']:.2f} dB, step 25 "
          f"{vals[-1]['psnr']:.2f} dB; mean loss steps 1-10 {first:.5f}, "
          f"steps 16-25 {last:.5f}")
    check(last < first, "grid step loss falls (mean of steps 16-25 below 1-10)")
    print(f"grid step steady: {ms:.1f} ms/step, {TRAIN_N_RAYS * 1e3 / ms:,.0f} "
          f"rays/s; two_mlp (phase 5) {ms_step_5:.1f} ms/step, "
          f"{TRAIN_N_RAYS * 1e3 / ms_step_5:,.0f} rays/s; grid / two_mlp "
          f"{ms / ms_step_5:.3f} on {card}", flush=True)
    prof = profile_step(lambda: gstep(state, *tables, gen, aux=cdf), "grid step")
    del state, step, gstep, tm
    torch.cuda.empty_cache()

    traj = trajectories("grid trajectory", GRID_TRAJ_TOL, dev, all_fns,
                        renderer, plain_sampler, semantic=False,
                        grid=(GRID_FIELDS, cdf))
    del cdf, tables
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "rays_per_s": TRAIN_N_RAYS * 1e3 / ms,
            "two_mlp_ms_per_step_phase5": ms_step_5, "losses": losses,
            "bake_cdf_ms": cdf_ms, "bake_cdf_mib": cdf_mib,
            "bake_grid_ms": grid_ms, "bake_grid_mib": grid_mib,
            "one_step_launches": one, "profile": prof,
            "trajectory_kernel_vs_plain": traj, "card": card}, launches


def grid_serving_phase(fmt, sc, renderer, dev, card, cfg, rcfg, poses,
                       ms_frame, rgb0, plain_sampler, fns):
    """Phase 13b: grid serving of phase 4's field at 94 x 352. The 128^3
    grid baked from the fine model over the served poses' frusta; 3 frames
    each of ``render_grid 128`` (the union), ``render_grid_fine_only`` with
    ``render_grid_samples 128``, and the same with ``render_int8``
    (kernel 10): launch counts (no coarse MLP launch; kernel 1 or 10 and
    kernel 14 once a tile), ms/frame beside phase 4's, the rgb mean abs gap
    of frame 0 to phase 4's two-MLP frame; then frame 0 of the first two
    modes on phase 4's comparison field through the kernels and through the
    plain path (one grid per dtype, baked from the kernel path's model) at
    phase 4's frame limits, and the int8 frame against the bf16 kernel
    frame at phase 4b's."""
    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.render.renderer import (pick_render_tile,
                                                            render_image)
    from depth_lidar_nerf_tpu_torch.train.loop import (bake_grid,
                                                       grid_bounds_for_poses,
                                                       render_path)
    from depth_lidar_nerf_tpu_torch.train.state import Models

    zero, counts = _counter(fns)
    launches = dict.fromkeys(fns, 0)
    models = serving_field(cfg, rcfg, dev)
    lo, hi = grid_bounds_for_poses(rcfg, poses, (H, W, FOCAL))
    zero()
    t0 = time.time()
    grid3 = bake_grid(rcfg, models, lo, hi, GRID_FIELDS["grid_train_res"],
                      verbose=False)
    torch.cuda.synchronize()
    bake_ms = (time.time() - t0) * 1e3
    check(counts() == dict.fromkeys(fns, 0), "the 3-D bake launches no kernel")
    print(f"grid serving: {GRID_FIELDS['grid_train_res']}^3 grid of the D=8 fine "
          f"model baked in {bake_ms:.1f} ms (bounds {np.round(lo, 3)} .. "
          f"{np.round(hi, 3)}) on {card}", flush=True)
    R = GRID_FIELDS["grid_train_res"]
    fine_only = dict(render_grid=R, render_grid_fine_only=True,
                     render_grid_samples=128)
    modes = {"grid": dict(render_grid=R), "grid_fine_only": fine_only,
             "grid_fine_only_int8": dict(fine_only, render_int8=True)}
    out = {"bake_ms": bake_ms, "modes": {}, "card": card,
           "two_mlp_ms_per_frame_phase4": ms_frame}
    for name, kw in modes.items():
        mcfg = dataclasses.replace(rcfg, **kw)
        tile = pick_render_tile(models.coarse, models.fine, mcfg, H * W, grid3)
        n_tiles = -(-H * W // tile)
        zero()
        rgbs, disps = render_path(models, poses, (H, W, FOCAL), mcfg,
                                  device=dev, density_grid=grid3)
        torch.cuda.synchronize()
        got = counts()
        want = dict.fromkeys(fns, 0)
        kern = "fused_nerf_fwd_q8" if mcfg.render_int8 else fmt.KERNEL
        want.update({kern: n_tiles * N_FRAMES, sc.KERNEL: n_tiles * N_FRAMES})
        check(got == want, f"{name} launch counts {got}, want {want}")
        # A ray whose fine samples all see zero density is empty: its
        # disparity is 0/0, as the reference's.
        empty = float(1.0 - np.isfinite(disps).mean())
        check(rgbs.shape == (N_FRAMES, H, W, 3) and np.isfinite(rgbs).all()
              and empty <= SEM_EMPTY_MAX, f"finite {name} frames "
              f"(empty rays {empty:.4f})")
        for k in fns:
            launches[k] += got[k]
        torch.cuda.synchronize()
        t0 = time.time()
        render_path(models, poses, (H, W, FOCAL), mcfg, device=dev,
                    density_grid=grid3)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3 / N_FRAMES
        gap4 = float(np.abs(rgbs[0] - rgb0).mean())
        print(f"{name}: {ms:.1f} ms/frame, {H * W * 1e3 / ms:,.0f} rays/s "
              f"(phase 4's two-MLP frame {ms_frame:.1f}), launches {got}, "
              f"tiles/frame {n_tiles}, empty rays {empty:.4f}; frame 0 rgb "
              f"mean abs gap to phase 4's frame {gap4:.4g} on {card}",
              flush=True)
        out["modes"][name] = {"ms_per_frame": ms,
                              "rays_per_s": H * W * 1e3 / ms,
                              "launches": got, "rgb_gap_to_phase4": gap4,
                              "empty_rays": empty}
    out["profile"] = profile_step(
        lambda: render_image(models.coarse, models.fine, H, W, FOCAL, poses[1],
                             dataclasses.replace(rcfg, **fine_only),
                             device=dev, density_grid=grid3),
        "grid fine-only frame")
    del grid3

    # Frame 0 on the comparison field, kernel path against plain path.
    with torch.no_grad():
        for m in models.nerfs():
            m.sigma.bias += COMPARE_OFFSET - SIGMA_OFFSET
    dtypes = ("float32", "bfloat16")
    kms = {d: path_models(cfg, rcfg, models, d, False, dev) for d in dtypes}
    grids = {d: bake_grid(rcfg, Models(*kms[d]), lo, hi, R, verbose=False)
             for d in dtypes}
    out["kernel_vs_plain"] = {}
    frames = {}
    for name in ("grid", "grid_fine_only"):
        mcfg = dataclasses.replace(rcfg, **modes[name])
        for d in dtypes:
            frames[name, "kernel", d] = render_image(
                *kms[d], H, W, FOCAL, poses[0], mcfg, device=dev,
                density_grid=grids[d])
        n_before = counts()
        with mock.patch.object(renderer, "sample_pdf_cuda", plain_sampler):
            for d in dtypes:
                frames[name, "plain", d] = render_image(
                    *path_models(cfg, rcfg, models, d, True, dev), H, W, FOCAL,
                    poses[0], mcfg, device=dev, density_grid=grids[d])
        check(counts() == n_before, f"the plain {name} render launched a kernel")
        res = {}
        for key in ("rgb_map", "depth_map", "acc_map"):
            e = {}
            for d in dtypes:
                diff = (frames[name, "kernel", d][key].float()
                        - frames[name, "plain", d][key].float()).abs()
                e[d] = (diff.max().item(), diff.mean().item())
            print(f"{name} frame 0 {key}, kernel vs plain: float32 max abs "
                  f"{e['float32'][0]:.3g} mean {e['float32'][1]:.3g} (tolerance "
                  f"max {F32_TOL_MAX:g}, mean {F32_TOL_MEAN:g}); bfloat16 mean "
                  f"{e['bfloat16'][1]:.3g} (tolerance {BF16_TOL_MEAN:g})")
            check(e["float32"][0] <= F32_TOL_MAX
                  and e["float32"][1] <= F32_TOL_MEAN,
                  f"{name} frame 0 {key} kernel vs plain, float32")
            check(e["bfloat16"][1] <= BF16_TOL_MEAN,
                  f"{name} frame 0 {key} kernel vs plain, bfloat16")
            res[key] = e
        out["kernel_vs_plain"][name] = res
    q8 = render_image(*kms["bfloat16"], H, W, FOCAL, poses[0],
                      dataclasses.replace(rcfg, **modes["grid_fine_only_int8"]),
                      device=dev, density_grid=grids["bfloat16"])
    gap8 = (q8["rgb_map"].float()
            - frames["grid_fine_only", "kernel", "bfloat16"]["rgb_map"].float()
            ).abs().mean().item()
    print(f"grid_fine_only_int8 frame 0 against the bf16 kernel frame: rgb "
          f"mean abs {gap8:.4g} (limit {INT8_RGB_MEAN})", flush=True)
    check(gap8 <= INT8_RGB_MEAN, "grid int8 rgb within JAX's atol")
    out["int8_rgb_gap_to_bf16"] = gap8
    del frames, grids, kms, models, q8
    torch.cuda.empty_cache()
    return out, launches


def grid_driver_phase(fmt, sc, renderer, dev, card, fns):
    """Phase 13c: the driver's grid run on phase 12's disk scene, with
    ``--grid_train --grid_train_after 100 --grid_rebake_every 50
    --grid_train_fine_only --grid_train_samples 128`` (``DLNERF_LOG_REBAKE=1``
    for the phase): run A to 150 with a checkpoint, run B resumed to 300,
    run C from scratch to 300. The rebakes at JAX's cadence with their
    times; run C's steps 151-250 timed and their launches counted (100 grid
    steps, two rebakes); the [TRAIN] PSNR up by ``DRIVER_PSNR_GAIN`` from
    step 25; the [TEST] frame at 300 through the grid; B against C by
    ``TRAJ_TOL``'s update limit, bit-identity reported; then the CLI's
    ``--render_only --render_test`` of C's checkpoint bakes a grid itself,
    and its rgb equals an in-process grid render of the restored
    checkpoint bit for bit. Returns the numbers and the window's
    launches."""
    import re
    import tempfile

    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene
    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train import checkpoint
    from depth_lidar_nerf_tpu_torch.train.config import (eval_render_config,
                                                         parse_args,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.loop import (_bake_render_grid,
                                                       load_scene)
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_grid_driver_")
    root = tmp.name
    make_scene(os.path.join(root, "scene"), n_images=DRIVER_VIEWS, H=H, W=W,
               focal=FOCAL, n_depth_points=DRIVER_DEPTH_POINTS, backdrop=True)

    def argv(expname, n_iters):
        return driver_argv(root, expname, n_iters, GRID_DRIVER_FLAGS)

    cfg_a = parse_args(argv("resumed", DRIVER_STEPS[0]))
    check(cfg_a.grid_train and cfg_a.grid_train_after == 100
          and cfg_a.grid_rebake_every == 50 and cfg_a.grid_train_fine_only
          and cfg_a.grid_train_samples == 128 and cfg_a.grid_train_res == 128,
          "grid driver config")

    def rebakes(text):
        return [(int(i), float(a), float(b)) for i, a, b in re.findall(
            r"\[grid\] rebake@(\d+): cdf ([\d.]+)s, grid3 ([\d.]+)s", text)]

    psnrs, window, grid_calls = {}, {}, []

    def hook(i, m):
        psnrs[i] = m["psnr"]
        if i == GRID_DRIVER_WINDOW[0]:
            torch.cuda.synchronize()
            for fn in fns.values():
                fn.launches = 0
            window["t0"] = time.time()
        elif i == GRID_DRIVER_WINDOW[1]:
            torch.cuda.synchronize()
            window["t1"] = time.time()
            window["launches"] = {k: fn.launches for k, fn in fns.items()}

    orig_grid = renderer._composite_from_grid

    def counting_grid(*a, **k):
        grid_calls.append(1)
        return orig_grid(*a, **k)

    with mock.patch.dict(os.environ, {"DLNERF_LOG_REBAKE": "1"}):
        state_a, wall_a, out_a = driver_run(cfg_a)
        check(state_a.step == DRIVER_STEPS[0], "grid run A's step")
        del state_a
        state_b, wall_b, out_b = driver_run(cfg_a.replace(N_iters=DRIVER_STEPS[1]))
        check(f"resumed from checkpoint at step {DRIVER_STEPS[0]}" in out_b,
              "grid run B resumes from run A's checkpoint")
        params_b = net_params(state_b.models, clone=True)
        del state_b
        torch.cuda.empty_cache()
        cfg_c = cfg_a.replace(expname="fresh", N_iters=DRIVER_STEPS[1])
        with mock.patch.object(renderer, "_composite_from_grid", counting_grid):
            state_c, wall_c, out_c = driver_run(cfg_c, hook)
    check(state_c.step == DRIVER_STEPS[1], "grid run C's step")
    bakes = {"A": rebakes(out_a), "B": rebakes(out_b), "C": rebakes(out_c)}
    for run, want_steps in GRID_REBAKES.items():
        check([b[0] for b in bakes[run]] == want_steps,
              f"run {run} rebakes at {bakes[run]}, want steps {want_steps}")
    print("grid driver rebakes (step, ray CDF s, 128^3 grid s): "
          + "; ".join(f"run {k} {v}" for k, v in bakes.items()), flush=True)

    n_win = GRID_DRIVER_WINDOW[1] - GRID_DRIVER_WINDOW[0]
    ms_step = (window["t1"] - window["t0"]) * 1e3 / n_win
    scene = load_scene(cfg_c)
    rcfg = render_config_from(cfg_c, 0, scene.near, scene.far)
    n_train = len(scene.i_train)
    m_rgb, m_dep = n_train * H * W, n_train * DRIVER_DEPTH_POINTS
    n_bake = -(-m_rgb // BAKE_CHUNK) + -(-m_dep // BAKE_CHUNK)
    n_win_bakes = sum(GRID_DRIVER_WINDOW[0] < b <= GRID_DRIVER_WINDOW[1]
                      for b in GRID_REBAKES["C"])
    n_chunks = -(-TRAIN_N_RAYS * cfg_c.N_importance // fmt.BWD_CHUNK)
    want = dict.fromkeys(fns, 0)
    want.update({fmt.KERNEL: n_win_bakes * n_bake,
                 "fused_nerf_fwd_acts": n_win, "fused_nerf_bwd_acts": n_win,
                 sc.KERNEL: n_win, "fused_nerf_grad_reduce": n_win,
                 "fused_nerf_bwd_chain": n_win * n_chunks,
                 "fused_nerf_bwd_weight_grads": n_win * n_chunks})
    launches = window["launches"]
    print(f"grid driver run C launches over steps {GRID_DRIVER_WINDOW[0] + 1}-"
          f"{GRID_DRIVER_WINDOW[1]}: {launches}", flush=True)
    check(launches == want, f"grid driver launch counts, want {want}")
    n_test_tiles = -(-H * W // rcfg.render_tile(fused=True))
    check(len(grid_calls) == n_test_tiles,
          f"the [TEST] frame at 300 went through the grid ({len(grid_calls)} "
          f"grid passes, want {n_test_tiles})")

    gap, identical = resume_check("grid driver", params_b, state_c, cfg_c,
                                  rcfg, dev)
    steps_seen = sorted(psnrs)
    first, last = psnrs[steps_seen[0]], psnrs[steps_seen[-1]]
    test_c = [l for l in out_c.splitlines() if l.startswith("[TEST]")]
    test_b = [l for l in out_b.splitlines() if l.startswith("[TEST]")]
    print(f"grid driver [TRAIN] psnr step {steps_seen[0]} {first:.2f} dB, step "
          f"{steps_seen[-1]} {last:.2f} dB; held-out view {DRIVER_HOLDOUT} "
          f"through the grid: {test_c} (run B: {test_b})")
    check(last >= first + DRIVER_PSNR_GAIN, "grid driver PSNR climbs by 2 dB")
    check(len(test_c) == 1 and len(test_b) == 1, "grid held-out [TEST] lines")
    print(f"grid driver: {ms_step:.1f} ms/step, {TRAIN_N_RAYS * 1e3 / ms_step:,.0f}"
          f" rays/s over steps {GRID_DRIVER_WINDOW[0] + 1}-"
          f"{GRID_DRIVER_WINDOW[1]} of run C ({n_win_bakes} rebakes included); "
          f"wall s: run A {wall_a:.1f}, run B {wall_b:.1f}, run C {wall_c:.1f} "
          f"on {card}", flush=True)
    del state_c, params_b
    torch.cuda.empty_cache()

    # The CLI bakes the grid itself and serves through it.
    expdir = os.path.join(root, "logs", "fresh")
    outdir = os.path.join(expdir, f"renderonly_test_{DRIVER_STEPS[1]:06d}")
    cli = argv("fresh", DRIVER_STEPS[1]) + ["--render_only", "--render_test"]
    t = time.time()
    proc = subprocess.run([sys.executable, "-c", CLI_COUNTING, *cli], cwd=HERE,
                          capture_output=True, text=True, timeout=600)
    wall_cli = time.time() - t
    check(proc.returncode == 0, f"grid CLI render_only: {proc.stderr[-2000:]}")
    check(f"baked {cfg_c.grid_train_res}^3 density grid" in proc.stdout,
          "the CLI baked a grid for the grid-trained checkpoint")
    counts = json.loads([l for l in proc.stdout.splitlines()
                         if l.startswith("launches ")][-1][len("launches "):])
    served = np.load(os.path.join(outdir, "000.npz"))["rgb"]
    models = build_models(cfg_c, rcfg, device=dev)
    state = checkpoint.restore(
        checkpoint.load_file(checkpoint.path_of(
            checkpoint.ckpt_dir(cfg_c.basedir, cfg_c.expname), DRIVER_STEPS[1])),
        init_train_state(cfg_c, models), checkpoint.topology(cfg_c, 0))
    eff = cfg_c.replace(render_grid=cfg_c.grid_train_res,
                        render_grid_fine_only=cfg_c.grid_train_fine_only,
                        render_grid_samples=cfg_c.grid_train_samples)
    grid3, rcfg_ro = _bake_render_grid(eff, eval_render_config(cfg_c, rcfg),
                                       models, scene.poses[scene.i_test],
                                       scene.hwf)
    frame = render_image(models.coarse, models.fine, H, W, FOCAL,
                         scene.poses[DRIVER_HOLDOUT], rcfg_ro, device=dev,
                         density_grid=grid3)
    rgb = frame["rgb_map"].float().cpu().numpy()
    cli_equal = bool(np.array_equal(rgb, served))
    print(f"grid driver CLI --render_only --render_test: exit 0 in "
          f"{wall_cli:.1f} s, launches {counts}; frame vs in-process grid "
          f"render of checkpoint {state.step}: bit-identical {cli_equal} (max "
          f"abs diff {np.abs(rgb - served).max():.3g})", flush=True)
    check(counts["fused_nerf_fwd"] == n_test_tiles
          and counts[sc.KERNEL] == n_test_tiles
          and counts["fused_nerf_fwd_q8"] == 0,
          "the CLI's grid frame: kernels 1 and 14 once a tile")
    check(cli_equal, "grid CLI frame equals the in-process frame bit for bit")
    del models, state, grid3, frame
    torch.cuda.empty_cache()
    tmp.cleanup()
    return {"ms_per_step": ms_step, "rays_per_s": TRAIN_N_RAYS * 1e3 / ms_step,
            "window": list(GRID_DRIVER_WINDOW), "window_rebakes": n_win_bakes,
            "window_launches": launches, "rebakes": bakes,
            "psnr_first": first, "psnr_last": last, "test_line": test_c[0],
            "resume_update_gap": gap, "resume_bit_identical": identical,
            "wall_s": {"A": wall_a, "B": wall_b, "C": wall_c, "cli": wall_cli},
            "cli_launches": counts, "cli_frame_bit_identical": cli_equal,
            "card": card}, launches


# Phase 14, the patch-loss iteration: configs/kitti360_full.txt's loss stack
# (LiDAR depth, inverse-depth smoothness every 10th iteration, the VGG19
# content loss at conv1_2..conv5_4 with weights 0.1, 0.1, 1, 1, 1 (l1), the
# semantic loss) and its patch (94 x 352, 32 x 64 rays with gradients), at
# bfloat16, on phase 9's in-memory scene (19 classes).
KITTI_CONFIG = os.path.join(HERE, "configs", "kitti360_full.txt")
PATCH_STEPS = (2, 5)  # patch iterations: warm-up, timed
PATCH_FALL = 30  # periods (9 base + 1 patch) whose patch losses must fall
# The no-grad leg's int8 crop against its bfloat16 crop: mean abs rgb gap
# (phase 4b's limit, JAX's tests/test_fused_q8.py:133).
PATCH_INT8_GAP = 0.03
# 14d: the driver on configs/flagship_synthetic.txt, cut to 300 iterations.
FLAGSHIP_CONFIG = os.path.join(HERE, "configs", "flagship_synthetic.txt")
FLAGSHIP_VIEWS = 20


def kitti_stack(dev, root, dtype="bfloat16", **over):
    """``configs/kitti360_full.txt`` on phase 9's scene (4 views of 94 x 352,
    8,000 LiDAR points each, 19 classes) with ``no_ndc`` (the synthetic
    scene is not forward-facing), ``dtype`` and ``over``, the perceptual
    weights looked for under ``root`` (none there: the seed-0 init):
    (cfg, rcfg, models, tables, scene, patch source)."""
    import torch

    from depth_lidar_nerf_tpu_torch.data.synthetic import draw_scene
    from depth_lidar_nerf_tpu_torch.train.config import (parse_args,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import build_models
    from depth_lidar_nerf_tpu_torch.train.step import PatchSource
    from depth_lidar_nerf_tpu_torch.train.tables import (build_depth_table,
                                                         build_rgb_table)

    sc = draw_scene(n_images=4, H=H, W=W, focal=FOCAL, n_depth_points=8000,
                    backdrop=True, num_classes=SEM_CLASSES)
    cfg = parse_args(["--config", KITTI_CONFIG, "--no_ndc", "True",
                      "--compute_dtype", dtype, "--datadir", root]
                     ).replace(**over)
    rcfg = render_config_from(cfg, sc.num_classes, sc.near, sc.far)
    models = build_models(cfg, rcfg, device=dev)
    it = range(4)
    tables = (build_rgb_table(sc.images, sc.poses, it, *sc.hwf, rcfg,
                              segmentation=sc.segmentation, device=dev),
              build_depth_table(sc.depth_gts, sc.poses, it, *sc.hwf, rcfg,
                                device=dev))
    src = PatchSource(torch.as_tensor(sc.images, dtype=torch.float32,
                                      device=dev),
                      torch.as_tensor(sc.poses, dtype=torch.float32,
                                      device=dev))
    return cfg, rcfg, models, tables, sc, src


def patch_kernel_vs_plain(label, stack, fns, renderer, plain_sampler, dtypes,
                          grid=None, variant=None, **over):
    """One patch step (``variant``, feature + smoothness unless given; with
    the GAN, the discriminator's update is held with the MLPs') of the
    kernel path and of the
    plain path (plain modules, the sampling twin; no kernel may launch) on
    ``stack`` (:func:`kitti_stack`'s config, render config, tables, scene,
    patch source and perceptual models) with ``over``, per dtype, with
    ``perturb`` and sigma noise off, so that the two paths' tilings of the
    no-grad leg draw nothing. Both start from one state: the seeded weights
    after the 9 base iterations that precede a patch iteration in the
    schedule (run on the kernel path), with their Adam moments, since from
    fresh moments Adam moves every parameter by about the learning rate
    whatever its gradient's size, so that float32 noise in a near-zero
    gradient flips whole updates. Then one patch step each from one
    generator seed (one crop, one set of rays). ``grid = (fields, cdf)``:
    the grid variant on one baked ray CDF. The relative loss gap and the max
    over parameters of the relative L2 gap of their updates, held to
    ``TRAJ_TOL``."""
    import torch

    from depth_lidar_nerf_tpu_torch.train import step as step_mod
    from depth_lidar_nerf_tpu_torch.train.state import (FusedMLP,
                                                        build_models,
                                                        build_perceptual,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    cfg0, rcfg0, tabs, scn, src, percept = stack
    dev = tabs[0].origins.device
    cfg0 = cfg0.replace(perturb=0.0, raw_noise_std=0.0, **over)
    if over:
        percept = build_perceptual(cfg0, dev)
    rcfg = dataclasses.replace(rcfg0, perturb=False, raw_noise_std=0.0)
    kw = {} if grid is None else {"aux": grid[1]}
    gaps = {}
    for dtype in dtypes:
        cfg = cfg0.replace(compute_dtype=dtype)
        paths = {}
        for plain in (False, True):
            mlps = build_models(cfg.replace(feature_loss=False,
                                            use_fused_mlp=not plain), rcfg,
                                device="cpu" if plain else dev)
            disc = mlps.discriminator
            m = mlps._replace(coarse=mlps.coarse.to(dev),
                              fine=mlps.fine.to(dev), vgg=percept[0],
                              lpips=percept[1],
                              discriminator=None if disc is None
                              else disc.to(dev))
            check(isinstance(m.coarse, FusedMLP) != plain, f"{label} models")
            paths[plain] = (m, init_train_state(cfg, m))
        (mk, sk), (mp, sp) = paths[False], paths[True]
        gen = torch.Generator(device=dev).manual_seed(5)
        base = make_train_step(cfg, rcfg, mk, scn.hwf)
        for _ in range(9):
            base(sk, *tabs, gen)
        with torch.no_grad():  # the plain path takes the kernel path's state
            for pk, pp in zip(sk.optimizer.param_groups[0]["params"],
                              sp.optimizer.param_groups[0]["params"]):
                pp.copy_(pk)
                sp.optimizer.state[pp] = {k: v.clone() for k, v in
                                          sk.optimizer.state[pk].items()}
        sp.optimizer.count, sp.step = sk.optimizer.count, sk.step
        if grid is not None:
            cfg = cfg.replace(**grid[0])
        runs = {}
        for plain, (m, st) in paths.items():
            stp = make_train_step(cfg, rcfg, m, scn.hwf,
                                  grid_mode=grid is not None,
                                  **(variant or dict(feature_on=True,
                                                     smooth_on=True)))
            init = net_params(m, clone=True)
            gen = torch.Generator(device=dev).manual_seed(6)
            n_before = [fn.launches for fn in fns.values()]
            with contextlib.ExitStack() as ctx:
                if plain:
                    for mod in (renderer, step_mod):
                        ctx.enter_context(mock.patch.object(
                            mod, "sample_pdf_cuda", plain_sampler))
                loss = stp(st, *tabs, gen, patch=src, **kw)["loss"].item()
            torch.cuda.synchronize()
            if plain:
                check([fn.launches for fn in fns.values()] == n_before,
                      f"the plain {label} path launched a kernel")
            runs[plain] = (loss, {k: v - init[k]
                                  for k, v in net_params(m).items()})
        del paths, mk, mp, sk, sp, st, stp, m, base
        torch.cuda.empty_cache()
        (lk, uk), (lp, up) = runs[False], runs[True]
        moved = [k for k in up if up[k].any()]
        per = sorted(((torch.linalg.norm(uk[k] - up[k])
                       / torch.linalg.norm(up[k])).item(), k) for k in moved)
        gaps[dtype] = (abs(lk - lp) / abs(lp), per[-1][0])
        tol = TRAJ_TOL[dtype]
        print(f"{label} {dtype}, one patch step after 9 base steps, kernel vs "
              f"plain: loss {lk:.6f} vs {lp:.6f}, gap {gaps[dtype][0]:.3g}; "
              f"max update gap {gaps[dtype][1]:.3g} (tolerance {tol[0]:g}, "
              f"{tol[1]:g}); largest update gaps {per[-3:][::-1]}", flush=True)
        check(gaps[dtype][0] <= tol[0] and gaps[dtype][1] <= tol[1],
              f"{label} {dtype}")
    return gaps


def patch_phase(fmt, sc, renderer, dev, card, plain_sampler, fns, ms_step_5):
    """Phases 14a-14c (see the module note). Returns the numbers for the
    JSON line and each kernel's launches on these paths."""
    import tempfile

    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.models.vgg import vgg_normalize
    from depth_lidar_nerf_tpu_torch.ops.ray_cdf import bake_ray_cdf
    from depth_lidar_nerf_tpu_torch.ops.rays import patch_ray_dirs
    from depth_lidar_nerf_tpu_torch.render.renderer import (make_rays,
                                                            pick_render_tile,
                                                            render_rays,
                                                            render_rays_tiled)
    from depth_lidar_nerf_tpu_torch.train import losses as L
    from depth_lidar_nerf_tpu_torch.train.state import init_train_state
    from depth_lidar_nerf_tpu_torch.train.step import (NG_FUSED_CAP,
                                                       NG_PLAIN_CAP, _clip01,
                                                       _take, make_train_step,
                                                       sample_patch)

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_patch_")
    root = tmp.name
    zero, counts = _counter(fns)
    launches = dict.fromkeys(fns, 0)

    def add(got):
        for k in fns:
            launches[k] += got[k]

    out = {"card": card}
    # ---- 14a. the KITTI patch iteration ----------------------------------
    t0 = time.time()
    cfg, rcfg, models, tabs, scn, src = kitti_stack(dev, root)
    check(cfg.feature_loss and cfg.depth_inverse_loss and cfg.semantic_loss
          and cfg.vgg_layers == ["conv1_2", "conv2_2", "conv3_4", "conv4_4",
                                 "conv5_4"]
          and cfg.vgg_layer_weights == [0.1, 0.1, 1.0, 1.0, 1.0]
          and cfg.vgg_loss_type == "l1" and (cfg.nH, cfg.nW, cfg.gradH,
                                             cfg.gradW) == (94, 352, 32, 64)
          and cfg.feature_loss_every_n == cfg.depth_inverse_loss_every_n == 10,
          "the KITTI loss stack")
    nH, nW, n_grad = cfg.nH, cfg.nW, cfg.gradH * cfg.gradW
    state = init_train_state(cfg, models)
    base = make_train_step(cfg, rcfg, models, scn.hwf)
    patch = make_train_step(cfg, rcfg, models, scn.hwf, feature_on=True,
                            smooth_on=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"patch iteration: kitti360_full stack built in {time.time() - t0:.1f}"
          f" s (N_rand {cfg.N_rand}, patch {nH}x{nW}, {n_grad} rays with "
          f"gradients, VGG19 to {cfg.vgg_layers[-1]}, seed-0 weights)",
          flush=True)

    def run_base():
        return base(state, *tabs, gen)

    def run_patch():
        return patch(state, *tabs, gen, patch=src)

    zero()
    run_base()
    torch.cuda.synchronize()
    base_counts = counts()
    add(base_counts)
    zero()
    run_patch()
    torch.cuda.synchronize()
    patch_counts = counts()
    add(patch_counts)
    peak = {}
    for name, fn in (("base", run_base), ("patch", run_patch)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() / 2 ** 20
    zero()
    base_ms = cuda_ms(run_base, reps=10, warmup=1)
    patch_ms = cuda_ms(run_patch, reps=PATCH_STEPS[1], warmup=PATCH_STEPS[0])

    def period():  # the config's every_n = 10: 9 base iterations, 1 patch
        for _ in range(9):
            run_base()
        run_patch()

    period_ms = cuda_ms(period, reps=2, warmup=0) / 10
    add(counts())

    # Each part alone, on one drawn crop: the legs as the step runs them.
    pb = sample_patch(src, nH, nW, gen)
    ro, rd = patch_ray_dirs(H, W, FOCAL, pb.c2w, pb.start_h, pb.start_w, nH, nW)
    prays = make_rays(ro, rd, rcfg, H, W, FOCAL)
    g_rays, ng_rays = _take(prays, pb.perm[:n_grad]), _take(prays, pb.perm[n_grad:])
    n_ng = ng_rays.origins.shape[0]

    def ng_leg(rc):
        tile = pick_render_tile(models.coarse, models.fine, rc, n_ng,
                                fused_cap=NG_FUSED_CAP, flax_cap=NG_PLAIN_CAP)
        with torch.no_grad():
            return render_rays_tiled(models.coarse, models.fine, ng_rays, rc,
                                     gen, tile=tile), tile

    def grad_leg():
        o = render_rays(models.coarse, models.fine, g_rays, rcfg, gen)
        (o["rgb_map"].sum() + o["rgb0"].sum() + o["depth_map"].sum()
         + o["depth_map0"].sum()).backward()
        state.optimizer.zero_grad(set_to_none=True)

    vgg = models.vgg
    img = torch.rand((2, nH, nW, 3), device=dev, generator=gen,
                     requires_grad=True)

    def vgg_part():
        with torch.no_grad():
            fg = vgg(vgg_normalize(pb.gt_patch[None]))
        f = vgg(vgg_normalize(img))
        L.vgg_feature_distance({k: v[0:1] for k, v in f.items()}, fg,
                               cfg.vgg_layers, cfg.vgg_layer_weights,
                               "l1").backward()

    leg_counts = {}
    for name, fn in (("ng_leg", lambda: ng_leg(rcfg)), ("grad_leg", grad_leg)):
        zero()
        fn()
        torch.cuda.synchronize()
        leg_counts[name] = counts()
    n_tiles = -(-n_ng // ng_leg(rcfg)[1])
    zero()
    parts = {"grad_leg_fwd_bwd": cuda_ms(grad_leg, reps=5, warmup=1),
             "ng_leg": cuda_ms(lambda: ng_leg(rcfg), reps=5, warmup=1),
             "vgg_fwd_bwd": cuda_ms(vgg_part, reps=5, warmup=1)}
    zero()
    print(f"patch iteration launches: base step {base_counts}; patch step "
          f"{patch_counts}; the no-grad leg alone ({n_ng} rays, {n_tiles} "
          f"tiles) {leg_counts['ng_leg']}; the grad leg alone ({n_grad} rays) "
          f"{leg_counts['grad_leg']}", flush=True)
    ng, gl = leg_counts["ng_leg"], leg_counts["grad_leg"]
    check(ng["fused_nerf_fwd_sem"] == 2 * n_tiles
          and ng["fused_nerf_sem_head"] == 2 * n_tiles
          and ng[sc.KERNEL] == n_tiles
          and sum(ng.values()) == 5 * n_tiles,
          "the no-grad leg runs kernel 6 (both passes a tile) and kernel 14")
    check(gl["fused_nerf_fwd_acts_sem"] == 2 and gl["fused_nerf_bwd_acts_sem"] == 2
          and gl[sc.KERNEL] == 1 and gl["fused_nerf_fwd_sem"] == 0
          and gl[fmt.KERNEL] == 0 and gl["fused_nerf_fwd_acts"] == 0,
          "the grad leg runs kernels 7 and 8 on both passes")
    check(patch_counts == {k: base_counts[k] + ng[k] + gl[k] for k in fns},
          "a patch step launches the base step's kernels and both legs'")
    print(f"patch iteration ({card}): base step {base_ms:.2f} ms, feature + "
          f"smoothness patch step {patch_ms:.2f} ms; period of 10 (9 base + 1 "
          f"patch) {period_ms:.2f} ms/iteration; parts: grad leg forward + "
          f"backward {parts['grad_leg_fwd_bwd']:.2f} ms, no-grad leg "
          f"{parts['ng_leg']:.2f} ms, VGG19 forward + backward "
          f"{parts['vgg_fwd_bwd']:.2f} ms; peak device memory base "
          f"{peak['base']:.0f} MiB, patch {peak['patch']:.0f} MiB", flush=True)
    prof = profile_step(run_patch, "KITTI patch iteration")

    # Losses over 30 patch iterations of the schedule (30 periods of 9 base
    # iterations and 1 patch iteration): the field has to learn the image
    # before a perceptual distance to it can fall.
    zero()
    metrics = []
    for _ in range(PATCH_FALL):
        for _ in range(9):
            run_base()
        metrics.append(run_patch())
    add(counts())
    vals = [{k: v.item() for k, v in m.items()} for m in metrics]
    check(all(np.isfinite(v) for m in vals for v in m.values()),
          "finite patch metrics")
    falls = {}
    for key in ("loss", "feature_loss", "inv_loss"):
        seq = [m[key] for m in vals]
        falls[key] = (float(np.mean(seq[:10])), float(np.mean(seq[-10:])))
        print(f"patch iteration {key}: " + " ".join(f"{x:.5f}" for x in seq)
              + f"; mean of the first 10 {falls[key][0]:.5f}, last 10 "
              f"{falls[key][1]:.5f}", flush=True)
        check(falls[key][1] < falls[key][0], f"patch iteration {key} falls")
    print(f"patch iteration metric keys: {sorted(vals[0])}")

    # VGG precision: the card's feature loss (float32, then TF32 convolutions)
    # against float64 on the CPU, on one rendered crop and its ground truth.
    with torch.no_grad():
        crop = torch.rand((1, nH, nW, 3), device=dev, generator=gen)
        gt = pb.gt_patch[None]

        def feat_loss(model, a, b):
            fa, fb = model(vgg_normalize(a)), model(vgg_normalize(b))
            return L.vgg_feature_distance(fa, fb, cfg.vgg_layers,
                                          cfg.vgg_layer_weights, "l1").item()

        vgg_prec = {}
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            vgg_prec["tf32" if tf32 else "float32"] = feat_loss(vgg, crop, gt)
        torch.backends.cudnn.allow_tf32 = False
        v64 = type(vgg)(taps=vgg.taps).double()
        v64.load_state_dict(vgg.state_dict())
        vgg_prec["float64_cpu"] = feat_loss(v64, crop.double().cpu(),
                                            gt.double().cpu())
        del v64
    rel = {k: abs(v - vgg_prec["float64_cpu"]) / vgg_prec["float64_cpu"]
           for k, v in vgg_prec.items() if k != "float64_cpu"}
    print(f"VGG feature loss on one crop: card float32 {vgg_prec['float32']:.8f}"
          f" (rel. gap {rel['float32']:.3g}), card TF32 {vgg_prec['tf32']:.8f}"
          f" (rel. gap {rel['tf32']:.3g}), CPU float64 "
          f"{vgg_prec['float64_cpu']:.8f} on {card}", flush=True)
    out["kitti"] = {"base_ms": base_ms, "patch_ms": patch_ms,
                    "period_ms_per_iteration": period_ms, "parts_ms": parts,
                    "peak_mib": peak, "profile": prof,
                    "launches": {"base": base_counts, "patch": patch_counts,
                                 **leg_counts}, "ng_tiles": n_tiles,
                    "falls": falls, "vgg_precision": vgg_prec,
                    "vgg_rel_gap_to_f64": rel, "base_ms_phase5": ms_step_5}
    stack = (cfg, rcfg, tabs, scn, src, (models.vgg, models.lpips))
    out["kitti"]["kernel_vs_plain"] = patch_kernel_vs_plain(
        "KITTI patch step", stack, fns, renderer, plain_sampler,
        ("float32", "bfloat16"))
    print(f"phase 14a done at {time.time() - T_START:.0f} s", flush=True)

    # ---- 14b. LPIPS, and the int8 no-grad leg -------------------------------
    out["lpips_kernel_vs_plain"] = patch_kernel_vs_plain(
        "LPIPS (alex) patch step", stack, fns, renderer, plain_sampler,
        ("float32",), feature_loss_type="lpips")
    cfg8 = cfg.replace(patch_ng_int8=True)
    patch8 = make_train_step(cfg8, rcfg, models, scn.hwf, feature_on=True,
                             smooth_on=True)
    zero()
    patch8(state, *tabs, gen, patch=src)
    torch.cuda.synchronize()
    c8 = counts()
    add(c8)
    rcfg8 = dataclasses.replace(rcfg, render_int8=True)
    n_tiles8 = -(-n_ng // ng_leg(rcfg8)[1])
    print(f"patch_ng_int8 step launches: {c8} ({n_tiles8} no-grad tiles)",
          flush=True)
    check(c8["fused_nerf_fwd_q8_sem"] == 2 * n_tiles8
          and c8["fused_nerf_fwd_sem"] == 0 and c8[fmt.KERNEL] == 0
          and c8["fused_nerf_fwd_q8"] == 0,
          "the int8 no-grad leg runs kernel 11, not kernel 1 or 6")
    ms8 = cuda_ms(lambda: patch8(state, *tabs, gen, patch=src), reps=3,
                  warmup=1)
    gaps8 = {}
    for key in ("rgb_map", "rgb0"):
        gen.manual_seed(11)
        a = _clip01(ng_leg(rcfg)[0][key])
        gen.manual_seed(11)
        b = _clip01(ng_leg(rcfg8)[0][key])
        gaps8[key] = (a - b).abs().mean().item()
    print(f"patch_ng_int8 ({card}): patch step {ms8:.2f} ms (bf16 "
          f"{patch_ms:.2f} ms); the no-grad leg's crop, int8 against bf16, "
          f"mean abs rgb gap fine {gaps8['rgb_map']:.4g}, coarse "
          f"{gaps8['rgb0']:.4g} (limit {PATCH_INT8_GAP})", flush=True)
    check(max(gaps8.values()) <= PATCH_INT8_GAP, "int8 no-grad crop")
    out["int8"] = {"patch_ms": ms8, "launches": c8, "crop_gap": gaps8}
    zero()
    print(f"phase 14b done at {time.time() - T_START:.0f} s", flush=True)

    # ---- 14c. the grid patch iteration ------------------------------------
    gfields = dict(GRID_FIELDS, patch_render_samples=32)
    cfg_g = cfg.replace(**gfields)
    zero()
    cdf = bake_ray_cdf(models, rcfg, *tabs, cfg_g.grid_train_samples)
    gpatch = make_train_step(cfg_g, rcfg, models, scn.hwf, grid_mode=True,
                             feature_on=True, smooth_on=True)
    gpatch(state, *tabs, gen, patch=src, aux=cdf)
    torch.cuda.synchronize()
    add(counts())
    zero()
    gpatch(state, *tabs, gen, patch=src, aux=cdf)
    torch.cuda.synchronize()
    cg = counts()
    add(cg)
    print(f"grid patch step launches: {cg}", flush=True)
    check(cg["fused_nerf_fwd_sem"] == 1 and cg["fused_nerf_fwd_acts_sem"] == 2
          and cg["fused_nerf_bwd_acts_sem"] == 2 and cg[sc.KERNEL] == 3
          and cg["fused_nerf_bwd"] == cg["fused_nerf_bwd_culled"] == 0
          and cg[fmt.KERNEL] == 0,
          "the grid patch step: the fine pass only, kernels 6-8 and 14")
    gms = cuda_ms(lambda: gpatch(state, *tabs, gen, patch=src, aux=cdf),
                  reps=5, warmup=1)
    add(counts())
    print(f"grid patch step ({card}): {gms:.2f} ms (two-MLP patch step "
          f"{patch_ms:.2f} ms)", flush=True)
    out["grid"] = {"patch_ms": gms, "launches": cg}
    del state, base, patch, patch8, gpatch, models
    torch.cuda.empty_cache()
    out["grid"]["kernel_vs_plain"] = patch_kernel_vs_plain(
        "grid patch step", stack, fns, renderer, plain_sampler,
        ("float32",), grid=(gfields, cdf))
    del cdf, stack, tabs, src
    torch.cuda.empty_cache()
    tmp.cleanup()
    print(f"phase 14c done at {time.time() - T_START:.0f} s", flush=True)
    return out, launches


def flagship_driver_phase(fmt, sc, dev, card, fns):
    """Phase 14d: ``train()`` on ``configs/flagship_synthetic.txt`` cut to 300
    iterations (30 patch iterations), on the scene that
    ``scripts/flagship_quality.py`` writes (20 views of 94 x 352, focal 88,
    8,000 LiDAR points each, seed 1, a backdrop; view 10 held out), written
    by the port's ``make_scene``: run A to 150 with a checkpoint, run B
    resumed to 300 (``no_reload_optimizer`` off, so that it resumes the
    optimizer too), run C from scratch to 300, its launches counted. The
    [TRAIN] PSNR up by ``DRIVER_PSNR_GAIN`` from iteration 25 to 300; the
    [TEST] line carries LPIPS; B within ``TRAJ_TOL``'s update limit of C;
    the metric keys at each print where JAX's ``variant_key`` puts the
    patch iterations."""
    import tempfile

    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene
    from depth_lidar_nerf_tpu_torch.train.config import (parse_args,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.step import build_step_fns

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_flagship_")
    root = tmp.name
    make_scene(os.path.join(root, "scene"), n_images=FLAGSHIP_VIEWS, H=H, W=W,
               focal=FOCAL, n_depth_points=DRIVER_DEPTH_POINTS, seed=1,
               backdrop=True)

    def argv(expname, n_iters):
        return ["--config", FLAGSHIP_CONFIG,
                "--datadir", os.path.join(root, "scene"),
                "--basedir", os.path.join(root, "logs"), "--expname", expname,
                "--N_iters", str(n_iters), "--i_print", str(DRIVER_PRINT),
                "--i_weights", str(DRIVER_STEPS[0]),
                "--i_testset", str(DRIVER_STEPS[1]),
                "--no_reload_optimizer", "False"]

    cfg_a = parse_args(argv("resumed", DRIVER_STEPS[0]))
    check(cfg_a.feature_loss and cfg_a.depth_inverse_loss
          and cfg_a.semantic_loss and cfg_a.compute_dtype == "bfloat16"
          and (cfg_a.nH, cfg_a.nW) == (H, W), "flagship config")
    state_a, wall_a, _ = driver_run(cfg_a)
    check(state_a.step == DRIVER_STEPS[0], "flagship run A's step")
    del state_a
    state_b, wall_b, out_b = driver_run(cfg_a.replace(N_iters=DRIVER_STEPS[1]))
    check(f"resumed from checkpoint at step {DRIVER_STEPS[0]}" in out_b,
          "flagship run B resumes")
    params_b = net_params(state_b.models, clone=True)
    del state_b
    torch.cuda.empty_cache()

    seen = {}
    zero, counts = _counter(fns)
    cfg_c = cfg_a.replace(expname="fresh", N_iters=DRIVER_STEPS[1])
    zero()
    state_c, wall_c, out_c = driver_run(cfg_c,
                                        lambda i, m: seen.setdefault(i, m))
    launches = counts()
    zero()
    check(state_c.step == DRIVER_STEPS[1], "flagship run C's step")
    rcfg = render_config_from(cfg_c, 4, 0.0, 1.0)
    plan = build_step_fns(cfg_c, rcfg, None, (H, W, FOCAL))
    keys = {i: sorted(m) for i, m in seen.items()}
    for i, m in seen.items():
        f, _, s, _, _ = plan.variant_key(i)
        check(("feature_loss" in m) == f and ("inv_loss" in m) == s,
              f"flagship metrics at iteration {i}")
    n_patch = sum(any(plan.variant_key(i)[:3])
                  for i in range(1, DRIVER_STEPS[1] + 1))
    print(f"flagship driver: {n_patch} patch iterations of "
          f"{DRIVER_STEPS[1]}; metric keys by [TRAIN] iteration: {keys}")
    print(f"flagship driver run C launches: {launches}", flush=True)
    check(launches["fused_nerf_fwd_sem"] > 0
          and launches["fused_nerf_fwd_acts_sem"] > 0
          and launches["fused_nerf_bwd_acts_sem"] > 0
          and launches[sc.KERNEL] > 0 and launches[fmt.KERNEL] == 0,
          "the flagship run ran the semantic kernels and kernel 14")
    gap, identical = resume_check("flagship", params_b, state_c, cfg_c, rcfg,
                                  dev)
    first, last = seen[DRIVER_PRINT]["psnr"], seen[DRIVER_STEPS[1]]["psnr"]
    test_c = [l for l in out_c.splitlines() if l.startswith("[TEST]")]
    print(f"flagship [TRAIN] psnr iteration {DRIVER_PRINT} {first:.2f} dB, "
          f"{DRIVER_STEPS[1]} {last:.2f} dB; {test_c}; wall s: run A "
          f"{wall_a:.1f}, B {wall_b:.1f}, C {wall_c:.1f} on {card}",
          flush=True)
    check(last >= first + DRIVER_PSNR_GAIN, "flagship PSNR climbs by 2 dB")
    check(len(test_c) == 1 and " lpips " in test_c[0],
          "the flagship [TEST] line carries LPIPS")
    del state_c
    torch.cuda.empty_cache()
    tmp.cleanup()
    return {"psnr_first": first, "psnr_last": last, "test_line": test_c[0],
            "resume_update_gap": gap, "resume_bit_identical": identical,
            "metric_keys": keys, "patch_iterations": n_patch,
            "launches": launches,
            "wall_s": {"A": wall_a, "B": wall_b, "C": wall_c},
            "card": card}, launches


# Phase 15: the GAN loss on the KITTI stack (the GAN keys of
# configs/content_loss.txt, JAX's default input-noise std), the GAN driver
# on the flagship config, the frozen-alpha fine-tune from phase 12's
# checkpoint and single-image batching.
GAN_FIELDS = dict(gan_loss=True, gan_start_iteration=1, gan_lambda=1e-3,
                  gan_disc_lrate=5e-4, gan_noise_std=0.1)
GAN_FLAGS = ("--gan_loss", "True", "--gan_start_iteration", "1",
             "--gan_lambda", "1e-3", "--gan_disc_lrate", "5e-4",
             "--gan_noise_std", "0.1")
GAN_STEPS = (2, 5)  # GAN iterations: warm-up, timed (15a)
GAN_DET_ITERS = 5  # iterations of the two runs that must agree bit for bit
GAN_DRIVER_STEPS = (60, 120)  # 15b: run A stops and saves; B and C end
GAN_DRIVER_PRINT = 20
ALPHA_STEPS, ALPHA_PRINT = 30, 5  # 15c: fine-tune steps, i_print
NB_STEPS, NB_PRECROP = 30, 15  # 15d: driver steps, precrop_iters


def optimizer_state(state):
    """Both optimizers' moments and counts (the discriminator's with the
    GAN), by parameter position, and the step."""
    import torch

    out = {"step": torch.tensor(state.step)}
    for name, opt in (("nerf", state.optimizer),
                      ("disc", state.disc_optimizer)):
        if opt is None:
            continue
        out[f"{name}.count"] = torch.tensor(opt.count)
        for i, p in enumerate(opt.param_groups[0]["params"]):
            for k, v in opt.state.get(p, {}).items():
                out[f"{name}.{i}.{k}"] = v.detach().clone()
    return out


def same_tensors(a, b):
    """Whether two dicts of tensors hold the same keys and equal tensors."""
    import torch

    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def gan_phase(fmt, sc, renderer, dev, card, plain_sampler, fns):
    """Phase 15a (see the module note): the GAN iteration of the KITTI stack
    at full width. Returns the numbers for the JSON line and each kernel's
    launches on this path."""
    import tempfile

    import torch

    from depth_lidar_nerf_tpu_torch.train import losses as L
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import (_deterministic_cudnn,
                                                       make_train_step,
                                                       sample_patch)

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_gan_")
    zero, counts = _counter(fns)
    launches = dict.fromkeys(fns, 0)

    def add(got):
        for k in fns:
            launches[k] += got[k]

    t0 = time.time()
    cfg, rcfg, models, tabs, scn, src = kitti_stack(dev, tmp.name,
                                                    **GAN_FIELDS)
    disc = models.discriminator
    nH, nW = cfg.nH, cfg.nW
    check(disc is not None and (nH, nW, cfg.gradH, cfg.gradW)
          == (94, 352, 32, 64) and disc.classifier[0].in_features == 67584
          and cfg.feature_loss and cfg.depth_inverse_loss,
          "the KITTI stack with the GAN")
    state = init_train_state(cfg, models)
    gan = make_train_step(cfg, rcfg, models, scn.hwf, gan_on=True)
    full = make_train_step(cfg, rcfg, models, scn.hwf, gan_on=True,
                           feature_on=True, smooth_on=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"GAN iteration: KITTI stack + GAN built in {time.time() - t0:.1f} s"
          f" (ESR discriminator on {nH}x{nW}, classifier of "
          f"{disc.classifier[0].in_features} inputs, gan_lambda "
          f"{cfg.gan_lambda:g}, disc lrate {cfg.gan_disc_lrate:g}, noise std "
          f"{cfg.gan_noise_std:g})", flush=True)

    def run_gan():
        return gan(state, *tabs, gen, patch=src)

    def run_full():
        return full(state, *tabs, gen, patch=src)

    zero()
    make_train_step(cfg, rcfg, models, scn.hwf, feature_on=True,
                    smooth_on=True)(state, *tabs, gen, patch=src)
    torch.cuda.synchronize()
    patch_counts = counts()  # the patch step without the GAN (phase 14a's)
    add(patch_counts)
    zero()
    m = run_gan()
    torch.cuda.synchronize()
    gan_counts = counts()
    add(gan_counts)
    zero()
    run_full()
    torch.cuda.synchronize()
    full_counts = counts()
    add(full_counts)
    print(f"GAN step launches {gan_counts}; GAN + feature + smoothness "
          f"{full_counts} (the patch step without the GAN, phase 14a's: "
          f"{patch_counts})", flush=True)
    check({"gan_loss", "loss_dis"} <= set(m), "GAN metrics")
    check(gan_counts == full_counts == patch_counts,
          "a GAN step launches the patch step's kernels (base step, no-grad "
          "leg on kernel 6, grad leg on kernels 7 and 8, kernel 14)")
    peak = {}
    for name, fn in (("gan", run_gan), ("gan_feature_smooth", run_full)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() / 2 ** 20
    zero()
    gan_ms = cuda_ms(run_gan, reps=GAN_STEPS[1], warmup=GAN_STEPS[0])
    full_ms = cuda_ms(run_full, reps=3, warmup=1)

    def period():  # past gan_start: 9 GAN iterations, 1 with VGG + smoothness
        for _ in range(9):
            run_gan()
        run_full()

    period_ms = cuda_ms(period, reps=1, warmup=0) / 10
    add(counts())

    # The discriminator step alone (three forwards of a 94 x 352 crop, one
    # backward, its Adam), as the step runs it.
    pb = sample_patch(src, nH, nW, gen)
    fake = torch.rand((2, nH, nW, 3), device=dev, generator=gen)
    std = L.gan_noise_std_at(state.step, cfg.gan_noise_std)

    def noise():
        return torch.randn((1, nH, nW, 3), device=dev, generator=gen) * std

    def disc_alone():
        with _deterministic_cudnn():
            loss_fake = 0.5 * (L.gan_mse(disc(fake[0:1] + noise()), 0.0)
                               + L.gan_mse(disc(fake[1:2] + noise()), 0.0))
            loss = loss_fake + L.gan_mse(disc(pb.gt_patch[None] + noise()),
                                         1.0)
            state.disc_optimizer.zero_grad(set_to_none=True)
            loss.backward()
            state.disc_optimizer.step()

    disc_ms = cuda_ms(disc_alone, reps=5, warmup=1)
    print(f"GAN iteration ({card}): GAN step {gan_ms:.2f} ms, GAN + feature "
          f"+ smoothness step {full_ms:.2f} ms, the discriminator step alone "
          f"{disc_ms:.2f} ms; period of 10 (9 GAN + 1 GAN + VGG + smoothness)"
          f" {period_ms:.2f} ms/iteration; peak device memory GAN "
          f"{peak['gan']:.0f} MiB, GAN + VGG {peak['gan_feature_smooth']:.0f}"
          f" MiB", flush=True)
    zero()
    prof = profile_step(run_gan, "GAN iteration")
    add(counts())

    # Two runs of 5 GAN iterations (the 5th with VGG and smoothness) from
    # one seeded state: bit for bit, the discriminator and the moments too.
    def det_run():
        m = build_models(cfg.replace(feature_loss=False), rcfg, device=dev)
        m = m._replace(vgg=models.vgg)
        st = init_train_state(cfg, m)
        g = make_train_step(cfg, rcfg, m, scn.hwf, gan_on=True)
        f = make_train_step(cfg, rcfg, m, scn.hwf, gan_on=True,
                            feature_on=True, smooth_on=True)
        gn = torch.Generator(device=dev).manual_seed(7)
        for i in range(1, GAN_DET_ITERS + 1):
            (f if i == GAN_DET_ITERS else g)(st, *tabs, gn, patch=src)
        torch.cuda.synchronize()
        return {**net_params(m, clone=True), **optimizer_state(st)}

    zero()
    run1, run2 = det_run(), det_run()
    add(counts())
    det = same_tensors(run1, run2)
    print(f"two runs of {GAN_DET_ITERS} GAN iterations from one seed: "
          f"{len(run1)} tensors, bit-identical {det}", flush=True)
    check(det, "two GAN runs from one state agree bit for bit")
    del run1, run2, state, gan, full
    torch.cuda.empty_cache()
    stack = (cfg, rcfg, tabs, scn, src, (models.vgg, models.lpips))
    gaps = patch_kernel_vs_plain("GAN step", stack, fns, renderer,
                                 plain_sampler, ("float32", "bfloat16"),
                                 variant=dict(gan_on=True))
    del stack, tabs, src, models
    torch.cuda.empty_cache()
    tmp.cleanup()
    print(f"phase 15a done at {time.time() - T_START:.0f} s", flush=True)
    return {"gan_ms": gan_ms, "gan_feature_smooth_ms": full_ms,
            "disc_step_ms": disc_ms, "period_ms_per_iteration": period_ms,
            "peak_mib": peak, "profile": prof,
            "launches": {"gan": gan_counts, "gan_feature_smooth": full_counts},
            "bit_identical_runs": det, "kernel_vs_plain": gaps,
            "card": card}, launches


def gan_driver_phase(fmt, sc, dev, card, fns):
    """Phase 15b: ``train()`` on ``configs/flagship_synthetic.txt`` with the
    GAN (``GAN_FLAGS``: every iteration a GAN iteration, feature and
    smoothness every 10th), cut to ``GAN_DRIVER_STEPS`` iterations, on the
    scene of phase 14d: run A saves at 60, B resumes it to 120, C runs 120
    from scratch with its launches counted. B equals C bit for bit (the
    MLPs, the discriminator and both optimizers' moments and counts); the
    checkpoint's MiB; the CLI's ``--render_only --render_test`` frame of
    C's checkpoint equals an in-process ``render_image`` bit for bit."""
    import tempfile

    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene
    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train import checkpoint
    from depth_lidar_nerf_tpu_torch.train.config import (eval_render_config,
                                                         parse_args,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.loop import load_scene
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_gan_driver_")
    root = tmp.name
    make_scene(os.path.join(root, "scene"), n_images=FLAGSHIP_VIEWS, H=H, W=W,
               focal=FOCAL, n_depth_points=DRIVER_DEPTH_POINTS, seed=1,
               backdrop=True)
    a_steps, c_steps = GAN_DRIVER_STEPS

    def argv(expname, n_iters):
        return ["--config", FLAGSHIP_CONFIG,
                "--datadir", os.path.join(root, "scene"),
                "--basedir", os.path.join(root, "logs"), "--expname", expname,
                "--N_iters", str(n_iters), "--i_print", str(GAN_DRIVER_PRINT),
                "--i_weights", str(a_steps), "--i_testset", "0",
                "--no_reload_optimizer", "False", *GAN_FLAGS]

    cfg_a = parse_args(argv("resumed", a_steps))
    check(cfg_a.gan_loss and cfg_a.gan_start_iteration == 1
          and cfg_a.feature_loss and (cfg_a.nH, cfg_a.nW) == (H, W),
          "the flagship config with the GAN")
    state_a, wall_a, _ = driver_run(cfg_a)
    check(state_a.step == a_steps and state_a.disc_optimizer.count == a_steps,
          "GAN run A's step")
    del state_a
    state_b, wall_b, out_b = driver_run(cfg_a.replace(N_iters=c_steps))
    check(f"resumed from checkpoint at step {a_steps}" in out_b,
          "GAN run B resumes")
    snap_b = {**net_params(state_b.models, clone=True),
              **optimizer_state(state_b)}
    del state_b
    torch.cuda.empty_cache()
    seen = {}
    zero, counts = _counter(fns)
    cfg_c = cfg_a.replace(expname="fresh", N_iters=c_steps)
    zero()
    state_c, wall_c, out_c = driver_run(cfg_c,
                                        lambda i, m: seen.setdefault(i, m))
    launches = counts()
    zero()
    snap_c = {**net_params(state_c.models, clone=True),
              **optimizer_state(state_c)}
    identical = same_tensors(snap_b, snap_c)
    ck_path = checkpoint.path_of(checkpoint.ckpt_dir(cfg_c.basedir,
                                                     cfg_c.expname), c_steps)
    ck_mib = os.path.getsize(ck_path) / 2 ** 20
    keys = {i: sorted(m) for i, m in seen.items()}
    psnr = {i: m["psnr"] for i, m in seen.items()}
    print(f"GAN driver: resumed run B vs run C at {c_steps}: {len(snap_c)} "
          f"tensors (MLPs, discriminator, both optimizers), bit-identical "
          f"{identical}; checkpoint {ck_mib:.2f} MiB; [TRAIN] psnr {psnr}; "
          f"metric keys {keys}; launches {launches}; wall s: run A "
          f"{wall_a:.1f}, B {wall_b:.1f}, C {wall_c:.1f} on {card}",
          flush=True)
    check(identical, "GAN run B equals run C bit for bit")
    check(all({"gan_loss", "loss_dis"} <= set(m) for m in seen.values()),
          "every GAN driver iteration is a GAN iteration")
    check(launches["fused_nerf_fwd_sem"] > 0
          and launches["fused_nerf_fwd_acts_sem"] > 0
          and launches["fused_nerf_bwd_acts_sem"] > 0
          and launches[sc.KERNEL] > 0 and launches[fmt.KERNEL] == 0,
          "the GAN driver ran the semantic kernels and kernel 14")
    del state_c, snap_b, snap_c
    torch.cuda.empty_cache()

    expdir = os.path.join(root, "logs", "fresh")
    outdir = os.path.join(expdir, f"renderonly_test_{c_steps:06d}")
    t = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "depth_lidar_nerf_tpu_torch.train",
         *argv("fresh", c_steps), "--render_only", "--render_test"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    wall_cli = time.time() - t
    check(proc.returncode == 0, f"GAN CLI render_only: {proc.stderr[-2000:]}")
    served = np.load(os.path.join(outdir, "000.npz"))["rgb"]
    scene = load_scene(cfg_c)
    rcfg = render_config_from(cfg_c, scene.num_semantic_classes, scene.near,
                              scene.far)
    models = build_models(cfg_c, rcfg, device=dev)
    checkpoint.restore(checkpoint.load_file(ck_path),
                       init_train_state(cfg_c, models),
                       checkpoint.topology(cfg_c, rcfg.num_semantic_classes))
    frame = render_image(models.coarse, models.fine, H, W, FOCAL,
                         scene.poses[int(scene.i_test[0])],
                         eval_render_config(cfg_c, rcfg), device=dev)
    rgb = frame["rgb_map"].float().cpu().numpy()
    cli_equal = bool(np.array_equal(rgb, served))
    print(f"GAN driver CLI --render_only --render_test: exit 0 in "
          f"{wall_cli:.1f} s; frame vs in-process render_image: bit-identical "
          f"{cli_equal} (max abs diff {np.abs(rgb - served).max():.3g})",
          flush=True)
    check(cli_equal, "GAN CLI frame equals the in-process frame bit for bit")
    del models, frame
    torch.cuda.empty_cache()
    tmp.cleanup()
    print(f"phase 15b done at {time.time() - T_START:.0f} s", flush=True)
    return {"resume_bit_identical": identical, "checkpoint_mib": ck_mib,
            "psnr": psnr, "metric_keys": keys, "launches": launches,
            "cli_frame_bit_identical": cli_equal,
            "wall_s": {"A": wall_a, "B": wall_b, "C": wall_c,
                       "cli": wall_cli}, "card": card}, launches


def timed_hook(store):
    """A metrics hook that keeps each ``i_print`` iteration's metrics and
    the host time at it, once the device's work up to it is done."""
    import torch

    def hook(i, m):
        torch.cuda.synchronize()
        store[i] = (time.time(), m)
    return hook


def window_ms(store, lo, hi):
    """Host ms per step between the ``i_print`` iterations ``lo`` and
    ``hi`` of a :func:`timed_hook` store."""
    return (store[hi][0] - store[lo][0]) * 1e3 / (hi - lo)


def alpha_phase(fmt, sc, dev, card, fns, kept):
    """Phase 15c: fine-tunes from phase 12's checkpoint (run C's newest) with
    ``--alpha_model_path``, then with ``--no_coarse`` too, through
    ``train()``, ``ALPHA_STEPS`` steps each at phase 12's stack. The MLPs
    run as JAX's frozen-alpha route runs them, plain modules (no fused-MLP
    launch), sampling on kernel 14; the density the fine-tune renders equals
    the alpha model's bit for bit (and the coarse pass's, which with
    ``no_coarse`` is the alpha model); the trained density head keeps its
    seeded weights while the colour branch moves."""
    import torch

    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from depth_lidar_nerf_tpu_torch.render.renderer import query_network
    from depth_lidar_nerf_tpu_torch.train import checkpoint
    from depth_lidar_nerf_tpu_torch.train.config import (parse_args,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.state import (FrozenModel,
                                                        build_models)

    tmp, cfg12 = kept
    root = tmp.name
    ckdir = checkpoint.ckpt_dir(cfg12.basedir, cfg12.expname)
    src = checkpoint.path_of(ckdir, checkpoint.latest_step(ckdir))
    zero, counts = _counter(fns)
    launches = dict.fromkeys(fns, 0)
    out = {"card": card}
    g = torch.Generator(device=dev).manual_seed(3)
    pts = torch.rand((4096, 64, 3), device=dev, generator=g) * 2 - 1
    vd = torch.nn.functional.normalize(
        torch.randn((4096, 3), device=dev, generator=g), dim=-1)
    for no_coarse in (False, True):
        label = "no_coarse" if no_coarse else "alpha"
        cfg = parse_args(driver_argv(
            root, f"ft_{label}", ALPHA_STEPS,
            ("--alpha_model_path", src, "--no_coarse", str(no_coarse),
             "--i_print", str(ALPHA_PRINT))))
        store = {}
        zero()
        state, wall, _ = driver_run(cfg, timed_hook(store))
        got = counts()
        for k in fns:
            launches[k] += got[k]
        zero()
        ms = window_ms(store, 2 * ALPHA_PRINT, ALPHA_STEPS)
        rcfg = render_config_from(cfg, 0, 0.0, 1.0)
        alpha = NeRFMLP(depth=cfg.netdepth_fine, width=cfg.netwidth_fine,
                        in_channels=state.models.fine.in_channels,
                        in_channels_views=state.models.fine.in_channels_views,
                        output_ch=5, dtype=state.models.fine.dtype).to(dev)
        alpha.load_state_dict(checkpoint.load_file(src)["models"]["fine"])
        with torch.no_grad():
            want = query_network(alpha, pts, vd, rcfg)
            fine = query_network(state.models.fine, pts, vd, rcfg)
            coarse = query_network(state.models.coarse, pts, vd, rcfg)
        same_fine = torch.equal(fine[..., 3], want[..., 3])
        same_coarse = (torch.equal(coarse, want) if no_coarse
                       else torch.equal(coarse[..., 3], want[..., 3]))
        init = build_models(cfg, rcfg, device=dev, seed=cfg.seed)
        heads = [torch.equal(getattr(m, "sigma").weight,
                             getattr(i, "sigma").weight)
                 for m, i in ((state.models.fine, init.fine),
                              (state.models.coarse, init.coarse))
                 if not isinstance(m, FrozenModel)]
        rgb_moved = not torch.equal(state.models.fine.rgb.weight,
                                    init.fine.rgb.weight)
        fused = {k: v for k, v in got.items() if k != sc.KERNEL and v}
        print(f"frozen alpha ({label}) from phase 12's checkpoint: "
              f"{ALPHA_STEPS} steps, {ms:.1f} ms/step over steps "
              f"{2 * ALPHA_PRINT + 1}-{ALPHA_STEPS} (host clock; phase 12's "
              f"fused driver step is the kernels' route); wall {wall:.1f} s; "
              f"launches: kernel 14 {got[sc.KERNEL]}, fused MLP kernels "
              f"{sum(fused.values())} {fused}; rendered density equal to the "
              f"alpha model's: fine {same_fine}, coarse {same_coarse}; "
              f"density heads unmoved {heads}; colour moved {rgb_moved} on "
              f"{card}", flush=True)
        check(not fused and got[sc.KERNEL] > 0,
              f"{label}: plain MLPs (JAX's route) and kernel 14")
        check(same_fine and same_coarse, f"{label}: the alpha model's density")
        check(all(heads) and heads and rgb_moved,
              f"{label}: the density head frozen, the colour trained")
        check(isinstance(state.models.coarse, FrozenModel) == no_coarse,
              f"{label}: the coarse field")
        out[label] = {"ms_per_step": ms, "wall_s": wall, "launches": got,
                      "density_equal": [same_fine, same_coarse]}
        del state, init, alpha
        torch.cuda.empty_cache()
    print(f"phase 15c done at {time.time() - T_START:.0f} s", flush=True)
    return out, launches


def no_batching_phase(fmt, sc, dev, card, fns, kept, ms_step_5):
    """Phase 15d: ``train()`` with ``--no_batching`` and ``precrop_iters``
    ``NB_PRECROP`` on phase 12's scene and stack, ``NB_STEPS`` steps: every
    step runs the base step's kernels (1, 3, 4, 5 with its phases, 14), as
    many launches as phase 12's window counts a step; ms/step over the
    precrop steps and over those after, beside phase 5's."""
    import torch

    from depth_lidar_nerf_tpu_torch.train.config import (parse_args,
                                                         render_config_from)

    tmp, _ = kept
    cfg = parse_args(driver_argv(
        tmp.name, "no_batching", NB_STEPS,
        ("--no_batching", "True", "--precrop_iters", str(NB_PRECROP),
         "--precrop_frac", "0.5", "--i_print", "5")))
    zero, counts = _counter(fns)
    store = {}
    zero()
    state, wall, _ = driver_run(cfg, timed_hook(store))
    got = counts()
    zero()
    check(state.step == NB_STEPS, "the no_batching run's step")
    rcfg = render_config_from(cfg, 0, 0.0, 1.0)
    n_chunks = -(-TRAIN_N_RAYS * (rcfg.N_samples + rcfg.N_importance)
                 // fmt.BWD_CHUNK)
    want = {k: 0 for k in fns}
    want.update({fmt.KERNEL: NB_STEPS, "fused_nerf_fwd_acts": NB_STEPS,
                 "fused_nerf_bwd_culled": NB_STEPS,
                 "fused_nerf_bwd_acts": NB_STEPS, sc.KERNEL: NB_STEPS,
                 "fused_nerf_grad_reduce": 2 * NB_STEPS,
                 "fused_nerf_bwd_chain": NB_STEPS * n_chunks,
                 "fused_nerf_bwd_weight_grads": NB_STEPS * n_chunks})
    ms_pre = window_ms(store, 5, NB_PRECROP)
    ms_after = window_ms(store, NB_PRECROP, NB_STEPS)
    print(f"no_batching ({card}): {ms_pre:.1f} ms/step over precrop steps "
          f"6-{NB_PRECROP}, {ms_after:.1f} ms/step over steps "
          f"{NB_PRECROP + 1}-{NB_STEPS} (host clock, metric fetches "
          f"included; phase 5's bare step {ms_step_5:.1f} ms); launches "
          f"{got}", flush=True)
    check(got == want, f"no_batching launch counts, want {want}")
    del state
    torch.cuda.empty_cache()
    print(f"phase 15d done at {time.time() - T_START:.0f} s", flush=True)
    return {"ms_per_step_precrop": ms_pre, "ms_per_step_after": ms_after,
            "bare_step_ms_phase5": ms_step_5, "launches": got,
            "wall_s": wall, "card": card}, got


# Phase 16, ray data parallelism (see the module note).
DP_STEPS = 5  # steps of each 16a / 16b run
DP_TIMED = (2, 10)  # 16a's ms/step: warm-up, timed


def dp_counts(fmt, sc, n_steps):
    """Phase 5's launches of ``n_steps`` two_mlp steps (64 + 64 samples) at
    ``cull_eps`` 1e-4."""
    n_chunks = -(-TRAIN_N_RAYS * (64 + 64) // fmt.BWD_CHUNK)
    return {fmt.KERNEL: n_steps, "fused_nerf_fwd_acts": n_steps,
            "fused_nerf_bwd_culled": n_steps, "fused_nerf_bwd_acts": n_steps,
            sc.KERNEL: n_steps, "fused_nerf_grad_reduce": 2 * n_steps,
            "fused_nerf_bwd_chain": n_steps * n_chunks,
            "fused_nerf_bwd_weight_grads": n_steps * n_chunks}


def dp_stack(dev, mesh, kitti_root=None):
    """Phase 5's ``two_mlp`` stack (or with ``kitti_root`` 15a's KITTI stack
    with the GAN) from its seed, its step on ``mesh``, its tables as the
    driver holds them there (row slices under ``dist_coordinator``):
    (cfg, state, step, tables, extra step keywords)."""
    from depth_lidar_nerf_tpu_torch.train.loop import _row_sliced_table
    from depth_lidar_nerf_tpu_torch.train.state import init_train_state
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    if kitti_root is None:
        cfg, rcfg, models, tables, scn = bench_stack(dev, TRAIN_N_RAYS,
                                                     "bfloat16")
        kw, extra = {}, {}
    else:
        cfg, rcfg, models, tables, scn, src = kitti_stack(dev, kitti_root,
                                                          **GAN_FIELDS)
        kw, extra = dict(gan_on=True), dict(patch=src)
    if mesh is not None and mesh.row_sliced:
        tables = tuple(_row_sliced_table(t, mesh, dev) for t in tables)
    state = init_train_state(cfg, models)
    return (cfg, state, make_train_step(cfg, rcfg, models, scn.hwf,
                                        mesh=mesh, **kw), tables, extra)


def dp_run(dev, mesh, n_steps, kitti_root=None, timed=False):
    """``n_steps`` steps of :func:`dp_stack` from generator seed 0: the
    metrics, every tensor of the state after them, and with ``timed`` the
    ms/step of ``DP_TIMED`` more steps by CUDA events."""
    import torch

    cfg, state, step, tables, extra = dp_stack(dev, mesh, kitti_root)
    gen = torch.Generator(device=dev).manual_seed(0)
    metrics = [step(state, *tables, gen, **extra) for _ in range(n_steps)]
    torch.cuda.synchronize()
    out = {"metrics": [{k: v.float().cpu() for k, v in m.items()}
                       for m in metrics],
           "state": {**net_params(state.models, clone=True),
                     **optimizer_state(state)}}
    if timed:
        out["ms"] = cuda_ms(lambda: step(state, *tables, gen, **extra),
                            reps=DP_TIMED[1], warmup=DP_TIMED[0])
    return out


def same_run(a, b):
    """Whether two :func:`dp_run` results agree bit for bit."""
    import torch

    return (len(a["metrics"]) == len(b["metrics"])
            and all(same_tensors(x, y) for x, y in zip(a["metrics"],
                                                       b["metrics"]))
            and same_tensors(a["state"], b["state"]))


def dp_gloo_rank(out_dir):
    """A rank of 16b (this process's rank in the group): ``DP_STEPS`` steps
    of the two_mlp stack on the 2-rank mesh, saved to ``out_dir``."""
    import torch
    import torch.distributed as dist

    from depth_lidar_nerf_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh([2], device=dev)
    run = dp_run(dev, mesh, DP_STEPS)
    torch.save(run, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    return run


def update_gaps(a, b, p0):
    """The largest relative loss gap over the steps and the largest relative
    L2 gap of the parameters' updates from ``p0`` (``trajectories``'
    measures) between two :func:`dp_run` results."""
    import torch

    loss = max(abs(x["loss"].item() - y["loss"].item())
               / max(abs(y["loss"].item()), 1e-12)
               for x, y in zip(a["metrics"], b["metrics"]))
    upd = max((torch.linalg.norm(a["state"][k] - b["state"][k])
               / torch.linalg.norm(b["state"][k] - p0[k])).item()
              for k in p0 if torch.linalg.norm(b["state"][k] - p0[k]) > 0)
    return loss, upd


def same_checkpoint(path_a, path_b):
    """Whether two checkpoint files hold the same step, models and
    optimizer moments, bit for bit."""
    import torch

    a, b = (torch.load(p, map_location="cpu", weights_only=True)
            for p in (path_a, path_b))

    def flat(d, pre=""):
        if torch.is_tensor(d):
            return {pre: d}
        if isinstance(d, dict):
            return {k2: v2 for k, v in d.items()
                    for k2, v2 in flat(v, f"{pre}.{k}").items()}
        if isinstance(d, (list, tuple)):
            return {k2: v2 for i, v in enumerate(d)
                    for k2, v2 in flat(v, f"{pre}.{i}").items()}
        return {pre: torch.tensor(float(d)) if isinstance(d, (int, float))
                else d}

    fa = flat({k: a[k] for k in ("step", "models", "optimizer",
                                 "optimizer_count")})
    fb = flat({k: b[k] for k in ("step", "models", "optimizer",
                                 "optimizer_count")})
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k], fb[k]) if torch.is_tensor(fa[k])
        else fa[k] == fb[k] for k in fa)


def dp_phase(fmt, sc, dev, card, fns, ms_step_5, kept):
    """Phase 16: 16a, the NCCL group of one process joined as the CLI's
    ``--dist_coordinator`` joins it (row-sliced tables, the row gather, the
    ray gathers and the gradient all-reduce at world size 1): ``DP_STEPS``
    two_mlp steps and one GAN iteration of 15a's stack each equal the
    non-distributed ones bit for bit, with phase 5's launches; ms/step
    beside the non-distributed step's and phase 5's. 16b, two ranks on the
    one card over gloo: the ranks agree bit for bit, and their trajectory
    is within ``TRAJ_TOL`` of one rank's. 16c, the CLI with
    ``--dist_coordinator`` on phase 12's scene: 150 steps equal phase 12's
    run A bit for bit, the run resumed to 300 equals run C, and its
    ``--render_only`` frame equals an in-process frame. Returns the numbers
    for the JSON line."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from depth_lidar_nerf_tpu_torch.parallel import distributed as pdist
    from depth_lidar_nerf_tpu_torch.parallel.mesh import make_mesh
    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train import checkpoint
    from depth_lidar_nerf_tpu_torch.train.config import (eval_render_config,
                                                         parse_args,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.loop import load_scene
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)

    out = {"card": card}
    zero, counts = _counter(fns)

    # ---- 16a ----
    t0 = time.time()
    pdist.init_distributed(f"127.0.0.1:{pdist.free_port()}", 1, 0)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "16a: an NCCL group of one rank")
    mesh = make_mesh([1], device=dev, row_sliced=True)
    zero()
    one = dp_run(dev, None, DP_STEPS, timed=True)
    one_counts = counts()
    zero()
    dp = dp_run(dev, mesh, DP_STEPS, timed=True)
    dp_counts_got = counts()
    want = dict.fromkeys(fns, 0)
    want.update(dp_counts(fmt, sc, DP_STEPS + sum(DP_TIMED)))
    equal = same_run(one, dp)
    print(f"16a NCCL world size 1 (dist_coordinator route, row-sliced tables):"
          f" {DP_STEPS} two_mlp steps bit-identical to the non-distributed "
          f"steps {equal}; launches {dp_counts_got} (non-distributed "
          f"{one_counts}); {dp['ms']:.2f} ms/step, non-distributed "
          f"{one['ms']:.2f} ms/step (phase 5's bare step {ms_step_5:.2f} ms) "
          f"on {card}", flush=True)
    check(equal, "16a: world size 1 equals the non-distributed steps")
    check(dp_counts_got == one_counts == want,
          f"16a: phase 5's launches, want {want}")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dp_")
    gan_one = dp_run(dev, None, 1, kitti_root=tmp.name)
    gan_dp = dp_run(dev, mesh, 1, kitti_root=tmp.name)
    gan_equal = same_run(gan_one, gan_dp)
    print(f"16a GAN iteration of 15a's stack at world size 1: "
          f"{len(gan_dp['state'])} tensors and metrics {sorted(gan_dp['metrics'][0])}"
          f" bit-identical {gan_equal}", flush=True)
    check(gan_equal and "loss_dis" in gan_dp["metrics"][0],
          "16a: the GAN iteration at world size 1 equals the "
          "non-distributed one")
    dist.destroy_process_group()
    out["16a"] = {"bit_identical": equal, "gan_bit_identical": gan_equal,
                  "launches": dp_counts_got, "ms_per_step": dp["ms"],
                  "ms_per_step_non_distributed": one["ms"],
                  "ms_per_step_phase5": ms_step_5}
    del gan_one, gan_dp
    torch.cuda.empty_cache()
    print(f"phase 16a done at {time.time() - T_START:.0f} s "
          f"({time.time() - t0:.0f} s)", flush=True)

    # ---- 16c's first CLI run starts here and runs beside 16b ----
    root = kept[0].name
    logs = os.path.join(root, "logs")

    def start_cli(n_iters, extra=()):
        argv = driver_argv(root, "dist", n_iters) + [
            "--dist_coordinator", f"127.0.0.1:{pdist.free_port()}",
            "--dist_num_processes", "1", "--dist_process_id", "0", *extra]
        log = os.path.join(tmp.name, f"cli_{n_iters}_{len(extra)}")
        with open(log + ".out", "w") as fo, open(log + ".err", "w") as fe:
            proc = subprocess.Popen([sys.executable, "-c", CLI_COUNTING, *argv],
                                    cwd=HERE, stdout=fo, stderr=fe)
        return proc, time.time(), extra, log

    def finish_cli(started):
        proc, t, extra, log = started
        proc.wait(timeout=600)
        stdout, stderr = (open(log + ext).read() for ext in (".out", ".err"))
        check(proc.returncode == 0, f"16c CLI {extra}: {stderr[-3000:]}")
        got = json.loads([l for l in stdout.splitlines()
                          if l.startswith("launches ")][-1][len("launches "):])
        return stdout, got, time.time() - t

    def ckpt(exp, step):
        return checkpoint.path_of(os.path.join(logs, exp, "checkpoints"), step)

    s0, s1 = DRIVER_STEPS
    t_c = time.time()
    run_d = start_cli(s0)

    # ---- 16b ----
    t0 = time.time()
    r0 = pdist.launch_local(2, dp_gloo_rank, (tmp.name,), device="cuda",
                            backend="gloo")
    r1 = torch.load(os.path.join(tmp.name, "rank1.pt"), weights_only=False)
    ranks_equal = same_run(r0, r1)
    p0 = net_params(bench_stack(dev, TRAIN_N_RAYS, "bfloat16")[2])
    loss_gap, upd_gap = update_gaps(r0, one, p0)
    tol = TRAJ_TOL["bfloat16"]
    print(f"16b two gloo ranks on one card: ranks bit-identical {ranks_equal}; "
          f"against one rank over {DP_STEPS} steps: loss gap {loss_gap:.3g} "
          f"(tolerance {tol[0]:g}), update gap {upd_gap:.3g} (tolerance "
          f"{tol[1]:g}) on {card}", flush=True)
    check(ranks_equal, "16b: the two ranks agree bit for bit")
    check(loss_gap <= tol[0] and upd_gap <= tol[1],
          "16b: two ranks against one rank within TRAJ_TOL")
    out["16b"] = {"ranks_bit_identical": ranks_equal, "loss_gap": loss_gap,
                  "update_gap": upd_gap}
    del r0, r1, one, dp
    torch.cuda.empty_cache()
    print(f"phase 16b done at {time.time() - T_START:.0f} s "
          f"({time.time() - t0:.0f} s)", flush=True)

    # ---- 16c: the run of 150 steps, then its resumed run to 300 beside a
    # --render_only frame of its checkpoint at 150 ----
    out_d, launch_d, wall_d = finish_cli(run_d)
    check("multi-host ray-DP mesh: 1 processes" in out_d,
          "16c: the CLI joined the group")
    first = same_checkpoint(ckpt("dist", s0), ckpt("resumed", s0))
    run_e = start_cli(s1)
    run_f = start_cli(s1, ["--render_only", "--render_test", "--ft_path",
                           ckpt("dist", s0)])
    out_e, launch_e, wall_e = finish_cli(run_e)
    check(f"resumed from checkpoint at step {s0}" in out_e,
          "16c: the resumed CLI run")
    resumed = same_checkpoint(ckpt("dist", s1), ckpt("fresh", s1))
    out_f, launch_f, wall_f = finish_cli(run_f)
    served = np.load(os.path.join(logs, "dist", f"renderonly_test_{s0:06d}",
                                  "000.npz"))["rgb"]
    cfg = parse_args(driver_argv(root, "dist", s1))
    scene = load_scene(cfg)
    rcfg = render_config_from(cfg, 0, scene.near, scene.far)
    models = build_models(cfg, rcfg, device=dev)
    checkpoint.restore(checkpoint.load_file(ckpt("dist", s0)),
                       init_train_state(cfg, models),
                       checkpoint.topology(cfg, 0))
    frame = render_image(models.coarse, models.fine, H, W, FOCAL,
                         scene.poses[DRIVER_HOLDOUT],
                         eval_render_config(cfg, rcfg), device=dev)
    rgb = frame["rgb_map"].float().cpu().numpy()
    frame_equal = bool(np.array_equal(rgb, served))
    print(f"16c CLI --dist_coordinator (world size 1; wall s with 16b, then "
          f"with each other, on the card): {s0} steps in "
          f"{wall_d:.1f} s, checkpoint {s0} bit-identical to phase 12's run A "
          f"{first}; resumed to {s1} in {wall_e:.1f} s, bit-identical to run C "
          f"(uninterrupted) {resumed}; --render_only frame of checkpoint {s0} "
          f"in {wall_f:.1f} s vs in-process render_image: bit-identical "
          f"{frame_equal} (max abs "
          f"diff {np.abs(rgb - served).max():.3g}); CLI launches {launch_d}, "
          f"{launch_e}, {launch_f} on {card}", flush=True)
    check(first, "16c: 150 distributed CLI steps equal run A's")
    check(resumed, "16c: the resumed distributed run equals run C")
    check(frame_equal, "16c: the CLI frame equals the in-process frame")
    check(launch_d["fused_nerf_fwd"] == s0 and launch_d[sc.KERNEL] == s0,
          "16c: the CLI's steps ran kernels 1 and 14")
    out["16c"] = {"first_bit_identical": first,
                  "resumed_bit_identical": resumed,
                  "frame_bit_identical": frame_equal,
                  "wall_s": [wall_d, wall_e, wall_f]}
    tmp.cleanup()
    print(f"phase 16c done at {time.time() - T_START:.0f} s "
          f"({time.time() - t_c:.0f} s from its start, 16b's included)",
          flush=True)
    return out


# Phase 17, tensor parallelism (see the module note).
TP_STEPS = 5  # steps of each 17b run
TP_TIMED = (2, 10)  # 17a's ms/step: warm-up, timed
# 17b's rays a step, cut from phase 5's 16,384 for time, not memory. Two
# gloo ranks on one card move every split layer's output through the host,
# at ~0.9 GB/s on an H100's host (PERF.md, section 5): 1.1 GB a float32
# step at 1,024 rays, 17.6 GB at 16,384.
TP_N_RAYS = 1024
TP_DRIVER = (30, 35)  # 17d: the [1, 2] run's steps (checkpoint), resumed to
TP_DRIVER_RAYS = 1024  # 17d's N_rand (as TP_N_RAYS, for the gloo traffic)
MLP_KERNELS = ("fused_nerf_fwd", "fused_nerf_fwd_acts", "fused_nerf_bwd",
               "fused_nerf_bwd_culled", "fused_nerf_bwd_acts",
               "fused_nerf_packed_fwd", "fused_nerf_packed_bwd")


def tp_run(dev, mesh, n_rays, dtype, n_steps, frame=False):
    """``n_steps`` steps of phase 5's stack on plain modules
    (:func:`bench_stack` with ``fused=False``), split over the model group
    of ``mesh`` (None: one process), from generator seed 0: the metrics,
    the whole parameters before the steps, after step 1 and after the last
    (gathered), this rank's own tensors, ms/step over steps 2.. by the host clock
    (synchronised) and peak MiB; with ``frame`` first a bfloat16 94 x 352
    frame of the seeded weights (18 GB gathered; float32's 36), and its wall
    ms."""
    import torch

    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train.checkpoint import full_payload
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state,
                                                        shard_models,
                                                        shard_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    out = {}
    cfg, rcfg, models, tables, scn = bench_stack(dev, n_rays, dtype,
                                                 fused=False)
    torch.cuda.reset_peak_memory_stats(dev)
    if frame:
        fcfg = cfg.replace(compute_dtype="bfloat16")
        fm_ = build_models(fcfg, rcfg, device="cpu")
        fm_.coarse.load_state_dict(models.coarse.state_dict())
        fm_.fine.load_state_dict(models.fine.state_dict())
        fm_ = shard_models(fm_._replace(coarse=fm_.coarse.to(dev),
                                        fine=fm_.fine.to(dev)), mesh)
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.no_grad():
            f = render_image(fm_.coarse, fm_.fine, H, W, FOCAL,
                             scn.poses[0], rcfg.eval_mode(), device=dev,
                             mesh=mesh)
        torch.cuda.synchronize()
        out["frame_ms"] = (time.time() - t0) * 1e3
        out["frame"] = {k: f[k].float().cpu() for k in ("rgb_map",
                                                        "depth_map",
                                                        "acc_map")}
        del fm_, f
    state = shard_train_state(init_train_state(cfg, models), mesh)
    step = make_train_step(cfg, rcfg, state.models, scn.hwf, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(0)

    def whole():
        sd = full_payload(state, {}, mesh)["models"]
        return {f"{n}.{k}": v.detach().float().cpu().clone()
                for n in ("coarse", "fine") for k, v in sd[n].items()}

    out["init"] = whole()
    metrics, params, secs = [], [], 0.0
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.time()
        m = step(state, *tables, gen)
        torch.cuda.synchronize()
        secs += (time.time() - t0) if i > 0 else 0.0
        metrics.append({k: v.float().cpu() for k, v in m.items()})
        if i in (0, n_steps - 1):
            params.append(whole())
    out.update(metrics=metrics, params=params,
               local={k: v.float().cpu() for k, v in
                      net_params(state.models, clone=True).items()},
               ms=secs * 1e3 / max(n_steps - 1, 1),
               peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20)
    return out


def tp_gloo_rank(out_dir, n_rays):
    """A rank of 17b/17c (this process's rank in the gloo group): on the
    ``[1, 2]`` mesh, 17c's frame and ``TP_STEPS`` steps in float32, then
    ``TP_STEPS`` in bfloat16, each rank's launch counts; saved to
    ``out_dir``."""
    import torch
    import torch.distributed as dist

    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as fmt
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as sc
    from depth_lidar_nerf_tpu_torch.parallel.distributed import rank_device
    from depth_lidar_nerf_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(dist.get_rank(), "cuda")
    mesh = make_mesh([1, 2], device=dev)
    zero, counts = _counter(kernel_fns())
    zero()
    out = {"float32": tp_run(dev, mesh, n_rays, "float32", TP_STEPS,
                             frame=True),
           "bfloat16": tp_run(dev, mesh, n_rays, "bfloat16", TP_STEPS)}
    out["launches"] = counts()
    out["tp_rank"] = mesh.tp_rank
    torch.save(out, os.path.join(out_dir, f"tp_rank{dist.get_rank()}.pt"))
    return out


def tp_driver_rank(root, argv):
    """A rank of 17d: ``train()`` of ``argv`` in the gloo group; rank 0
    returns what it printed and its launches."""
    import io

    import torch

    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as fmt
    from depth_lidar_nerf_tpu_torch.ops import sampling_cuda as sc
    from depth_lidar_nerf_tpu_torch.train.config import parse_args
    from depth_lidar_nerf_tpu_torch.train.loop import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zero, counts = _counter(kernel_fns())
    zero()
    text = io.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(text):
        state = train(parse_args(argv))
    torch.cuda.synchronize()
    return {"printed": text.getvalue(), "launches": counts(),
            "wall_s": time.time() - t, "step": state.step,
            "trunk": tuple(state.models.coarse.trunk_0.weight.shape)}


def tp_phase(fmt, sc, dev, card, fns, kept, n_rays=TP_N_RAYS):
    """Phase 17 (see the module note), 17b at ``n_rays`` rays a step: returns
    the numbers for the JSON line and the launches of the main paths it
    drove in this process (17a's plain steps, rank 0 of 17b/17c, rank 0 of
    17d and the resumed run)."""
    import tempfile

    import numpy as np
    import torch

    from depth_lidar_nerf_tpu_torch.parallel import distributed as pdist
    from depth_lidar_nerf_tpu_torch.render.renderer import render_image
    from depth_lidar_nerf_tpu_torch.train import checkpoint
    from depth_lidar_nerf_tpu_torch.train.config import (eval_render_config,
                                                         parse_args,
                                                         render_config_from)
    from depth_lidar_nerf_tpu_torch.train.loop import load_scene
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.step import make_train_step

    out = {"card": card}
    zero, counts = _counter(fns)
    launched = dict.fromkeys(fns, 0)

    def add(got):
        for k, v in got.items():
            launched[k] += v

    # ---- 17a ----
    t0 = time.time()
    ms = {}
    for route in ("plain", "fused"):
        cfg, rcfg, models, tables, scn = bench_stack(
            dev, TRAIN_N_RAYS, "bfloat16", fused=route == "fused")
        state = init_train_state(cfg, models)
        step = make_train_step(cfg, rcfg, models, scn.hwf)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.reset_peak_memory_stats(dev)
        zero()
        ms[route] = cuda_ms(lambda: step(state, *tables, gen),
                            reps=TP_TIMED[1], warmup=TP_TIMED[0])
        got = counts()
        if route == "plain":
            add(got)
            plain_got = got
            peak = torch.cuda.max_memory_allocated(dev) / 2**20
        del state, step, models, tables
        torch.cuda.empty_cache()
    n = sum(TP_TIMED)
    print(f"17a plain-module two_mlp step (phase 5's stack, {TRAIN_N_RAYS} "
          f"rays, bfloat16, one process): {ms['plain']:.2f} ms/step, "
          f"{TRAIN_N_RAYS * 1e3 / ms['plain']:,.0f} rays/s, peak "
          f"{peak:.0f} MiB; the fused step in this call {ms['fused']:.2f} "
          f"ms/step ({ms['plain'] / ms['fused']:.2f}x); launches "
          f"{ {k: v for k, v in plain_got.items() if v} } on {card}",
          flush=True)
    check(plain_got[sc.KERNEL] == n and not any(plain_got[k]
                                                for k in MLP_KERNELS),
          "17a: kernel 14 once a step and no fused-MLP kernel")
    out["17a"] = {"ms_per_step_plain": ms["plain"],
                  "ms_per_step_fused": ms["fused"], "peak_mib": peak,
                  "launches": plain_got}
    print(f"phase 17a done at {time.time() - T_START:.0f} s "
          f"({time.time() - t0:.0f} s)", flush=True)

    # ---- 17d: the [1, 2] driver; its CLI frame runs beside 17b-c ----
    t0 = time.time()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tp_")
    root = kept[0].name
    logs = os.path.join(root, "logs")
    s0, s1 = TP_DRIVER
    extra = ["--N_rand", str(TP_DRIVER_RAYS), "--i_weights", str(s0),
             "--i_testset", "0", "--i_print", "10"]
    argv_tp = driver_argv(root, "tp", s0, extra + [
        "--mesh_shape", "1", "2", "--use_fused_mlp", "False"])
    zero()
    d0 = pdist.launch_local(2, tp_driver_rank, (root, argv_tp),
                            device="cuda", backend="gloo")
    add(counts())
    ck = checkpoint.path_of(os.path.join(logs, "tp", "checkpoints"), s0)
    check(d0["step"] == s0 and os.path.exists(ck)
          and "ray-DP x 2-way model-TP mesh over 2 devices" in d0["printed"]
          and d0["trunk"] == (128, 63),
          "17d: the [1, 2] driver trained with split trunks and saved")
    check(d0["launches"][sc.KERNEL] >= s0
          and not any(d0["launches"][k] for k in MLP_KERNELS),
          "17d: kernel 14 on rank 0 and no fused-MLP kernel")
    log = os.path.join(tmp.name, "cli_tp")
    fo, fe = open(log + ".out", "w"), open(log + ".err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", CLI_COUNTING,
         *driver_argv(root, "tp", s0, extra + [
             "--render_only", "True", "--render_test", "True",
             "--ft_path", ck])], cwd=HERE, stdout=fo, stderr=fe)
    t_d = time.time() - t0

    try:  # the CLI run is stopped if a check below fails
        # ---- 17b / 17c: one process's plain runs, then two gloo ranks ----
        t0 = time.time()
        one = {"float32": tp_run(dev, None, n_rays, "float32", TP_STEPS,
                                 frame=True),
               "bfloat16": tp_run(dev, None, n_rays, "bfloat16", TP_STEPS)}
        torch.cuda.empty_cache()
        t_ranks = time.time()
        zero()
        r0 = pdist.launch_local(2, tp_gloo_rank, (tmp.name, n_rays),
                                device="cuda", backend="gloo")
        add(counts())
        r1 = torch.load(os.path.join(tmp.name, "tp_rank1.pt"), weights_only=False)
        t_ranks = time.time() - t_ranks
        for r in (r0, r1):
            got = r["launches"]
            check(got[sc.KERNEL] > 0 and not any(got[k] for k in MLP_KERNELS),
                  f"17b: rank {r['tp_rank']} launched kernel 14 and no "
                  "fused-MLP kernel")
        b17 = {}
        for d in ("float32", "bfloat16"):
            a, b = r0[d], r1[d]
            split = {k for k in a["local"] if a["local"][k].shape
                     != a["params"][-1][k].shape}
            same = all(torch.equal(a["local"][k], b["local"][k])
                       for k in a["local"] if k not in split)
            same_whole = all(torch.equal(a["params"][-1][k], b["params"][-1][k])
                             for k in a["params"][-1])
            check(same and same_whole, f"17b {d}: the ranks' replicated and "
                  "gathered parameters agree bit for bit")
            check(split >= {"coarse.trunk_0.weight", "fine.feature.weight",
                            "fine.views_0.weight"}
                  and not split & {"coarse.sigma.weight", "fine.rgb.weight"},
                  f"17b {d}: the wide layers are split, the heads whole")
            run = {"metrics": a["metrics"], "state": a["params"][-1]}
            ref = {"metrics": one[d]["metrics"], "state": one[d]["params"][-1]}
            loss_gap, upd_gap = update_gaps(run, ref, one[d]["init"])
            tol = TRAJ_TOL[d]
            entry = {"ranks_bit_identical": same and same_whole,
                     "loss_gap": loss_gap, "update_gap": upd_gap,
                     "ms_per_step_gloo_one_card": a["ms"],
                     "ms_per_step_one_process": one[d]["ms"],
                     "peak_mib_rank": [a["peak_mib"], b["peak_mib"]]}
            if d == "float32":
                l1, l0 = a["metrics"][0]["loss"].item(), \
                    one[d]["metrics"][0]["loss"].item()
                w1, w0 = a["params"][0], one[d]["params"][0]
                worst = max(((w1[k] - w0[k]).abs() - 2e-5 - 2e-4 * w0[k].abs())
                            .max().item() for k in w0)
                step1 = abs(l1 - l0) <= 1e-6 + 1e-5 * abs(l0) and worst <= 0
                entry.update(step1_loss_gap=abs(l1 - l0),
                             step1_params_within_jax_limits=step1,
                             step1_params_excess=worst)
                check(step1, "17b float32 step 1 within JAX's test_parallel "
                      "limits (loss rtol 1e-5 / atol 1e-6, parameters rtol 2e-4 "
                      "/ atol 2e-5)")
            print(f"17b mesh_shape [1, 2] ({d}, {n_rays} rays, {TP_STEPS} "
                  f"steps): ranks bit-identical {same and same_whole}; against "
                  f"one process's plain run: loss gap {loss_gap:.3g} (tolerance "
                  f"{tol[0]:g}), update gap {upd_gap:.3g} (tolerance {tol[1]:g})"
                  + (f", step 1 loss gap {entry['step1_loss_gap']:.3g}, "
                     "parameters within JAX's limits "
                     f"{entry['step1_params_within_jax_limits']}"
                     if d == "float32" else "")
                  + f"; two gloo ranks on one card (not a scaling number) "
                  f"{a['ms']:.1f} ms/step, one process {one[d]['ms']:.1f} "
                  f"ms/step; peak MiB a rank {a['peak_mib']:.0f}, "
                  f"{b['peak_mib']:.0f} on {card}", flush=True)
            check(loss_gap <= tol[0] and upd_gap <= tol[1],
                  f"17b {d}: within TRAJ_TOL of one process")
            b17[d] = entry
        out["17b"] = b17
        out["17b"]["launches_rank"] = [r0["launches"][sc.KERNEL],
                                       r1["launches"][sc.KERNEL]]
        # ---- 17c ----
        f1 = one["float32"]["frame"]
        c17 = {}
        for key in ("rgb_map", "depth_map", "acc_map"):
            gaps = [(r["float32"]["frame"][key] - f1[key]).abs()
                    for r in (r0, r1)]
            e = (max(g.max().item() for g in gaps),
                 max(g.mean().item() for g in gaps))
            c17[key] = e
            print(f"17c frame {H}x{W} (bfloat16) split over the model group "
                  f"vs one process, {key}: max abs {e[0]:.3g} mean {e[1]:.3g} "
                  f"(tolerance: phase 4's bfloat16 mean {BF16_TOL_MEAN:g}); "
                  f"{r0['float32']['frame_ms']:.0f} ms on two gloo ranks, one "
                  f"process {one['float32']['frame_ms']:.0f} ms", flush=True)
            check(e[1] <= BF16_TOL_MEAN,
                  f"17c {key} split frame vs one process")
        out["17c"] = {"gaps_max_mean": c17,
                      "frame_ms_gloo": r0["float32"]["frame_ms"],
                      "frame_ms_one_process": one["float32"]["frame_ms"]}
        del one, r0, r1
        torch.cuda.empty_cache()
        print(f"phase 17b-c done at {time.time() - T_START:.0f} s "
              f"({time.time() - t0:.0f} s, the ranks {t_ranks:.0f} s)",
              flush=True)
    except BaseException:
        proc.kill()
        proc.wait()
        raise

    # ---- 17d, continued: the checkpoint in one process, the CLI frame ----
    t0 = time.time()
    saved = checkpoint.load_file(ck)
    whole = saved["models"]["coarse"]["trunk_0.weight"].shape == (256, 63)
    cfg_r = parse_args(driver_argv(root, "tp", s1, extra))
    zero()
    state_r, wall_r, out_r = driver_run(cfg_r)
    got_r = counts()
    add(got_r)
    check(whole and f"resumed from checkpoint at step {s0}" in out_r
          and state_r.step == s1, "17d: the checkpoint holds whole layers "
          "and resumes in one process")
    check(got_r["fused_nerf_fwd"] >= s1 - s0
          and got_r["fused_nerf_bwd_acts"] >= s1 - s0,
          "17d: the resumed run took the fused kernels")
    del state_r
    proc.wait(timeout=600)
    fo.close()
    fe.close()
    check(proc.returncode == 0,
          f"17d CLI --render_only: {open(log + '.err').read()[-3000:]}")
    served = np.load(os.path.join(logs, "tp", f"renderonly_test_{s0:06d}",
                                  "000.npz"))["rgb"]
    cfg = parse_args(driver_argv(root, "tp", s0, extra))
    scene = load_scene(cfg)
    rcfg = render_config_from(cfg, 0, scene.near, scene.far)
    models = build_models(cfg, rcfg, device=dev)
    checkpoint.restore(saved, init_train_state(cfg, models),
                       checkpoint.topology(cfg, 0))
    frame = render_image(models.coarse, models.fine, H, W, FOCAL,
                         scene.poses[DRIVER_HOLDOUT],
                         eval_render_config(cfg, rcfg), device=dev)
    rgb = frame["rgb_map"].float().cpu().numpy()
    frame_equal = bool(np.array_equal(rgb, served))
    print(f"17d train() on [1, 2] (two gloo ranks on one card, "
          f"{TP_DRIVER_RAYS} rays): {s0} steps in {d0['wall_s']:.1f} s, "
          f"rank 0's trunk_0 {d0['trunk']}, checkpoint {s0} whole; resumed in "
          f"one process on the fused kernels to {s1} in {wall_r:.1f} s; CLI "
          f"--render_only frame of the checkpoint vs in-process render_image: "
          f"bit-identical {frame_equal} (max abs diff "
          f"{np.abs(rgb - served).max():.3g}); rank 0 launches "
          f"{ {k: v for k, v in d0['launches'].items() if v} } on {card}",
          flush=True)
    check(frame_equal, "17d: the CLI frame equals the in-process frame")
    out["17d"] = {"wall_s": d0["wall_s"], "resumed_wall_s": wall_r,
                  "frame_bit_identical": frame_equal,
                  "launches_rank0": d0["launches"]}
    tmp.cleanup()
    print(f"phase 17d done at {time.time() - T_START:.0f} s "
          f"({t_d + time.time() - t0:.0f} s, its CLI run beside 17b-c)",
          flush=True)
    return out, launched


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
    from depth_lidar_nerf_tpu_torch.train.state import init_train_state
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
    # The grid step's shape (phase 13): B = 127 bins of the 128-entry bake
    # grid, one row expanded to every ray (row stride 0), the weights
    # widened from the table's bfloat16 rows, 64 draws.
    for det, u_one in ((True, False), (False, False), (True, True),
                       (False, True)):
        bins, wts, u = sample_pdf_inputs(dev, TRAIN_N_RAYS, GRID_B, V, det,
                                         "grid", seed=127 + det + 2 * u_one,
                                         u_one=u_one)
        check(bins.stride(0) == 0 and wts.stride(0) == GRID_B + 1,
              "the grid step's strides")
        got = sc.inverse_cdf(bins, wts, u)
        torch.cuda.synchronize()
        ref = sc.inverse_cdf_plain(bins, wts, u)
        e = (got - ref).abs().max().item()
        print(f"kernel sample_pdf N={TRAIN_N_RAYS} B={GRID_B} V={V} det={det} "
              f"grid (bins row stride 0, widened bf16 rows)"
              f"{' u=1 at cdf[B-1] > 1' if u_one else ''}: max abs err "
              f"{e:.3g}, tolerance 0 (equal to the last bit)")
        check(torch.equal(got, ref), f"sample_pdf grid det={det} u_one={u_one}")
        err[sc.KERNEL] = max(err[sc.KERNEL], e)
    del bins, wts, u, got, ref

    train_fns = {"fused_nerf_fwd_acts": fmt.fused_nerf_fwd_acts,
                 "fused_nerf_bwd": fmt.fused_nerf_bwd,
                 "fused_nerf_bwd_culled": fmt.fused_nerf_bwd_culled,
                 "fused_nerf_bwd_acts": fmt.fused_nerf_bwd_acts}
    all_fns = list(kernel_fns().values())
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
    models = serving_field(cfg, rcfg, dev)
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
    rgb0_phase4 = rgbs[0].copy()  # phase 13b's grid frames are held to it

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
        for m in models.nerfs():
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
        kernel_fns())
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

    # ---- 12. the driver: train, resume and serve a scene from disk -------------
    kept = []  # phase 12's scene and checkpoint, for phases 15c and 15d
    driver, driver_launches = driver_phase(fmt, sc, dev, card, ms_step,
                                           kernel_fns(), keep=kept)
    print(f"phase 12 done at {time.time() - T_START:.0f} s", flush=True)

    # ---- 13. grid training and baked-density-grid serving -----------------------
    grid_step, grid_step_launches = grid_step_phase(
        fmt, sc, renderer, dev, card, plain_sampler, kernel_fns(),
        all_fns, ms_step)
    print(f"phase 13a done at {time.time() - T_START:.0f} s", flush=True)
    grid_serving, grid_serving_launches = grid_serving_phase(
        fmt, sc, renderer, dev, card, cfg, rcfg, poses, ms_frame, rgb0_phase4,
        plain_sampler, kernel_fns())
    print(f"phase 13b done at {time.time() - T_START:.0f} s", flush=True)
    grid_driver, grid_driver_launches = grid_driver_phase(
        fmt, sc, renderer, dev, card, kernel_fns())
    print(f"phase 13c done at {time.time() - T_START:.0f} s", flush=True)

    # ---- 14. the patch-loss iteration and the flagship driver -------------------
    patch_out, patch_launches = patch_phase(fmt, sc, renderer, dev, card,
                                            plain_sampler, kernel_fns(),
                                            ms_step)
    flagship, flagship_launches = flagship_driver_phase(fmt, sc, dev, card,
                                                        kernel_fns())
    print(f"phase 14d done at {time.time() - T_START:.0f} s", flush=True)

    # ---- 15. the GAN loss, the frozen-alpha model, single-image batching ---
    gan_out, gan_launches = gan_phase(fmt, sc, renderer, dev, card,
                                      plain_sampler, kernel_fns())
    gan_driver, gan_driver_launches = gan_driver_phase(fmt, sc, dev, card,
                                                       kernel_fns())
    alpha_out, alpha_launches = alpha_phase(fmt, sc, dev, card,
                                            kernel_fns(), kept[0])
    nb_out, nb_launches = no_batching_phase(fmt, sc, dev, card,
                                            kernel_fns(), kept[0],
                                            ms_step)

    # ---- 16. ray data parallelism --------------------------------------------
    dp_out = dp_phase(fmt, sc, dev, card, kernel_fns(), ms_step,
                      kept[0])

    # ---- 17. tensor parallelism ----------------------------------------------
    tp_out, tp_launches = tp_phase(fmt, sc, dev, card, kernel_fns(),
                                   kept[0])
    kept[0][0].cleanup()

    # ---- the kernels line ---------------------------------------------------
    src = "depth_lidar_nerf_tpu_torch/csrc/"
    main_launches = {k: launches.get(k, 0) + train_launches.get(k, 0)
                     + int8_launches[k] + sem["launches"][k]
                     + s5["launches"].get(k, 0) + driver_launches.get(k, 0)
                     + grid_step_launches[k] + grid_serving_launches[k]
                     + grid_driver_launches[k] + patch_launches[k]
                     + flagship_launches[k] + gan_launches[k]
                     + gan_driver_launches[k] + alpha_launches[k]
                     + nb_launches[k] + tp_launches[k]
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
    print(json.dumps({"driver": driver}))
    print(json.dumps({"grid": {"step": grid_step, "serving": grid_serving,
                               "driver": grid_driver}}))
    print(json.dumps({"patch": {**patch_out, "flagship_driver": flagship}}))
    print(json.dumps({"gan": {**gan_out, "driver": gan_driver},
                      "frozen_alpha": alpha_out, "no_batching": nb_out}))
    print(json.dumps({"data_parallel": dp_out}))
    print(json.dumps({"tensor_parallel": tp_out}, default=str))
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
