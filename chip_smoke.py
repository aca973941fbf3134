#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port's paths on one NVIDIA GPU: MCClassS serving and
training, ScanNet segmentation serving and training (MCSeg on the z-order tile
kernels), the capacity-free bucket path (MCSeg without a tile capacity, and
MCClassS above 3072 points, on the cell-bucket kernels), the rest of the
classification zoo (MCClass, MCClassH) with the per-h dense conv pair K1v1 /
K2v1 that ``MCCNN_DENSE_V1=1`` selects, the roofline instruments (K1p under
``MCCNN_DENSE_PLANES=mxu``, the K5 / K6 probes of ``MCCNN_TILE_PROBE`` and
T1, with the tools that time them), and normal estimation (MCNorm,
MCNormS) and ShapeNet part segmentation with the Poisson sweep variants K3v2 /
K3v3 / K3v4 that ``MCCNN_POISSON_SWEEP`` selects, and ScanNet under the
reference's tile switches (``MCCNN_TILE_BWD_V1``, ``MCCNN_TILE_PACK``,
``MCCNN_TILE_ORDER``, ``MCCNN_TILE_ADJ``, ``MCCNN_TILE_MINOR``) with K6v1 and
K5p / K6p, and the bucket conv over active bricks (K9a / K10a) with
``tools.bucket_32k``.

    python3 chip_smoke.py

1. Refuses to run without a CUDA device; turns TF32 off; prints the card's
   name and power limit (``nvidia-smi``).
2. Builds the kernels from ``mccnn_tpu_torch/csrc`` (one nvcc per source, in
   parallel) and prints the build time and ``ptxas``'s register /
   shared-memory report.
3. Holds each forward kernel (K1 dense MC conv, K3 Poisson sweep, K4 KDE)
   against its plain PyTorch version on the card, at every shape the MCClassS
   serving path (B=8 clouds of N=1024 points) and training path (B=32, the
   trainer's batch) give it, and times both with CUDA events. K4 runs both
   its bodies (culled and all pairs) at every site it is checked at, each
   within KDE_RTOL, bitwise on repeat, and with the weight off each
   query's in-radius count exactly the plain one. K3 is also held bit for
   bit at the dense sweeps of the other default paths
   (``tools.dense_ab.poisson_sites``): ScanNet's levels 1 and 2 of a block
   batch (B=8) and of the 40960 scene (B=1), ShapeNet's levels 0-2 (r=0.025,
   0.1, 0.4) and ``tasks.modelnet --points 4096``'s levels 0-1.
4. Holds K2 (the dense MC-conv backward) against its plain version at the
   three conv sites of a B=8 and of a B=32 training batch (N=1024
   hierarchies: the row splits and partial sums differ with B), checks that
   two calls give bit-identical gradients, and times both. Then K1 and K2
   at ShapeNet's three 1024 -> 1024 sites (MCSeg grow 64: the stem at r
   0.025, 17 -> 64 channels; enc_0_1 and dec_1_0 at r 0.05, depthwise 64 and
   256) for a batch of 32 synthetic part clouds: against their plain
   versions, counts bit-equal, bitwise on repeat, with times, bounds and the
   GEMM parts' library calls.
5. Serving: builds MCClassS(40, grow=128) with seeded weights and BN
   statistics and serves request batches of 8, 3 and 1 clouds through
   ``serve.Predictor``; checks that the logits are finite, agree with the same
   model on the CPU plain path, and that K1, K3 and K4 were launched.
6. One train step of MCClassS at full width (drop_rate 0) on the card against
   the same step on the CPU plain path, at B=8 and at B=32: loss, every
   gradient, the updated BN statistics.
7. Training through the entry point: ``tasks.modelnet.main`` with
   ``--synthetic --batch 32 --points 1024 --grow 128 --n-classes 40`` for 4
   steps (default dropout 0.5); requires a finite loss and that K1, K2, K3 and
   K4 were all launched, and prints the warm time per step.
8. The z-order tile kernels of ScanNet segmentation, on a synthetic block
   batch of B=8 x 8192 points and a scene padded to 40960: K8 (the tile
   sampler's cover count) against its plain version at each of the 27 colours
   of the level-0 sweep, and the sweep's selection against the dense plain
   sampler; K7 (tile KDE) against its plain version at the two level-0 radii
   of the whole scene (with its layout's real and inert steps), and against
   K4 at 8192; K4 at the block hierarchy's
   seven KDE sites (levels 0-3); K5 (tile MC conv) at the four tile sites of
   the block batch (stem, enc_0_1, dec_2_1, dec_1_0). Each repeats bit for
   bit; times, bounds and plain times are printed.
   K6 (the tile MC-conv backward) at the same four sites of the batch,
   with a seeded dout: d_wf and every parameter gradient against the plain
   version, bitwise repetition, call and device times, candidate and
   in-radius pairs, bounds. Then the tile switches'
   kernels at the same sites: K5p and K6p (packed minor records) bit for bit
   against K5 and K6 and against their plain versions, K6v1 (the per-h
   backward) within 1e-5 of each gradient's largest value of its plain
   version and of K6 and bit for bit on repeat, with their times, plain times
   and bounds; and K5 and K6 at the minor sizes 8, 16, 64 and 128, K7 and K8
   at 64 and 8, each against its plain version with the capacity sized under
   that minor.
9. MCSeg (ScanNet defaults: grow 64, radii 0.05 / 0.15 / 0.4, seeded weights
   and BN statistics) on the card against the CPU plain path at B=2 x 8192
   (B=8 would keep the CPU for minutes), and the card's B=8 block hierarchy
   against the CPU's; then a block batch's and a whole scene's forward and a
   B=8 train step under torch.profiler (device time, busy share, the top
   kernels). One MCSeg train
   step (dropout 0) on the card against the same step on the CPU plain path
   at B=2 x 8192, with the same weights and BN statistics and the card's
   BN-ReLU decisions (the flips are counted): the loss, every gradient, the
   updated BN statistics.
10. Serving through the entry point: ``tasks.scannet.main --synthetic
   --eval-only`` for block evaluation (B=8, N=8192) and with
   ``--whole-scene-cap 40960``, with the launch counters of K1, K3, K4, K5,
   K7 and K8 read over each run; prints the batch and scene latencies.
11. Training through the entry point: ``tasks.scannet.main --synthetic`` at
   the CLI's defaults (B=8 x 8192) for 4 steps with ``--tile-pairs 32``, small
   enough that a step drops tile steps, is discarded, re-sized and run again;
   requires a finite loss, at least one ``resize`` record and the launch
   counters of K1-K6 and K8 moving, and prints the warm time per step. The
   same training at the CLI's defaults (4 steps and its evaluation) in child
   processes, with no switch and under ``MCCNN_TILE_BWD_V1=1`` (K6v1 launched, K6 not), ``MCCNN_TILE_PACK=1``
   (K5p and K6p launched, K5 and K6 not) and ``MCCNN_TILE_ORDER=morton
   MCCNN_TILE_ADJ=aabb MCCNN_TILE_MINOR=64`` with ``--whole-scene-cap 40960``
   (K5-K8 at Tm = 64): each must print a finite loss and its counters.
12. The bucket path on a block batch of B=8 x 8192 at the same widths with no
   tile capacity: the hierarchy (level 0 sampled through its self-neighbour
   lists) against the CPU plain path's, and per bucket site the grid
   overflow of each side (nonzero drops points, the reference's semantics)
   and the candidate and in-radius pair counts; K9 (bucket MC conv) and K10
   (its backward, with a seeded dout) at the four sites against their plain
   versions, bitwise repetition, times (K10's call and device times) and
   bounds.
13. MCSeg(tile_pairs=None) served through ``serve.Predictor``: the card
   against the CPU plain path at B=2 (identical hierarchies), then the
   latency of B=8 block batches, with K9 launched and no tile kernel, and a
   profiled B=8 forward (device time, busy share, top kernels).
14. One MCSeg bucket train step at B=2 x 8192 against the CPU plain path (the
   gate of 9), then timed train steps at B=8 x 8192 through
   ``make_train_step`` with K9 and K10 launched, and one under
   torch.profiler.
15. ``tasks.modelnet.main --synthetic --points 4096`` at B=32: three steps and
   one evaluation, with MCClassS's conv_0_1 on K9 and K10.
16. K1v1 and K2v1 (the per-h dense conv and its backward) at the 14 dense
   conv sites of MCClass (grow 64, radii 0.1 / 0.2 / 0.4) and MCClassH (grow
   128; ``tools.dense_ab.ZOO_SITES``) for batches of 8 and 32 clouds of 1024
   points: each against its plain version and against K1 / K2 on the same
   inputs (K2v1 bit for bit against K2 on K1's G), bit for bit on repeat,
   with each site's valid and in-radius pair counts and K2v1's transient
   device memory, and K1's and K2's counters still across two K2v1 calls;
   at B=32 the times of both, of their plain versions, of K1 / K2 and of one
   torch.matmul of the GEMM part, the bounds and the sums over the sites.
17. MCClass and MCClassH at their published widths (seeded weights and BN
   statistics) served through ``serve.Predictor`` at B=8: the first two
   clouds against the CPU plain path (B=2; every head of MCClassH), batch
   latencies and a profiled batch (busy share).
18. One train step of each (drop rates 0) at B=4 on the card against the CPU
   plain path, with MCSeg's BN-ReLU flip gate.
19. ``tasks.modelnet.main --model MCClass`` and ``--model MCClassH --protocol
   gradient`` at B=32, N=1024: two epochs of 3 steps (the second profiled)
   and one evaluation with 2 votes, K1-K4 launched.
20. The same MCClass training under ``MCCNN_DENSE_V1=1`` in a child process:
   its printed counters must show K1v1 / K2v1 launched and K1 / K2 not; its
   warm step is printed beside the default MCClass trainer's of 19.
21. K3v2, K3v3 and K3v4 (the Poisson sweep variants) at every sweep of
   MCNorm (N = 1024 at r 0.1, 496 at r 0.4), MCNormS (r 0.15), ShapeNet's
   MCSeg (r 0.025 / 0.1 / 0.4) and MCClassS for batches of 32 clouds, and
   MCClassS's at 8: each against its plain version and K3, bit for bit and
   bit for bit on repeat (K3v3 where the batch's colour runs fit their
   windows, as the reference runs it), with the times of each, its plain
   version and K3, and the bound.
22. MCNorm (grow 64, seeded weights and BN statistics) served through
   ``serve.Predictor`` at B=8: the first two clouds against the CPU plain
   path, latencies and a profiled batch.
23. One MCNorm and one ShapeNet-MCSeg train step (drop rates 0) at B=4 on the
   card against the CPU plain path, with MCSeg's BN-ReLU flip gate.
24. ``tasks.normals.main`` (MCNorm and MCNormS) and ``tasks.shapenet.main``
   ``--synthetic`` at the defaults (B=32, N=1024): two epochs of three steps
   (the second profiled) and one evaluation each, a finite loss, K1-K4
   launched, the warm step time and the kernels that take the most device
   time.
25. The same ``tasks.normals`` run under ``MCCNN_POISSON_SWEEP=v2``, ``v3``
   and ``v4``, each in a child process: its counters must show that
   variant's kernel launched and no other variant's.
26. The roofline instruments. K1p (the dense forward over K1's in-radius
   lists with its pre-activations on the tensor cores,
   ``MCCNN_DENSE_PLANES=mxu``) at the zoo's 14 sites and MCClassS's 3 for
   batches of 8 and 32: against its plain version and K1 on the same inputs,
   its count equal to K1's, bit for bit on repeat, with each site's valid
   and in-radius pair counts; at B=32 the times of K1p, its plain version,
   K1 and one torch.matmul of the GEMM part, the bounds, and K1p / K1 summed
   over the zoo's sites, MCClassS's and the C = 1 stems.
27. MCClass training under ``MCCNN_DENSE_PLANES=mxu`` in a child process: its
   counters must show K1p and K2 launched and K1 not; its warm step is
   printed beside the default trainer's.
28. The K5 / K6 probes (``MCCNN_TILE_PROBE``: noop, planes, mm, bwd_noop) at
   the four ScanNet tile sites of the B=8 x 8192 block batch: each against
   its plain version, the packed ones (K5p / K6p) bit for bit against the
   unpacked, bit for bit on repeat, with times and bounds; then
   ``tools.tile_roofline`` at 32768 points prints its table, with the
   probes' counters moving, and in the same counted window each probe runs
   once more on the tool's layout, held against its plain version there.
29. T1 (the dense conv's timing probes: mm_only, vpu_only, replica, h1,
   noop, mm_big, fwd_bf16) at the tool's shapes (B=8, N=M=1024, C=128,
   r=0.2): each against its plain version, bit for bit on repeat, with times,
   the bounds of each variant's function (planes and contractions over the
   in-radius pairs) and the library calls (``xla_equiv``'s torch.matmul,
   noop's torch.full). noop, mm_only and mm_big (the staged schedule) also
   with their device times (calls replayed from a CUDA graph), with the
   wrapper's bf16 cast and of the kernel alone, beside the library calls'
   device times: noop beside the bytes it stages, mm_only beside the walked
   floor of its (H+1) fp32 contractions (its kernel may not take less) and
   its ratio to ``xla_equiv``, mm_big (its H+1 contractions as bf16
   tensor-core GEMMs) beside the walked floor of its contractions at the
   bf16 peak and its ratios to ``xla_equiv`` and mm_only; then
   ``tools.dense_breakdown`` prints its table, every variant launched.
30. K9a / K10a (the bucket conv and its backward over the first NBA
   occupied bricks, ``bucket_mc_conv(..., max_active_bricks=)``) at
   ``tools.bucket_32k``'s scene (32768 points, r = 0.05, C = 128) with cap
   64: at NBA = 784, its occupied bricks, bit for bit K9 / K10 and on
   repeat and against their plain versions, timed beside K9 / K10; at NBA =
   600 against their plain versions, the samples and sources of the dropped
   bricks exact zeros; the full conv (mean both ways) at B = 4 clouds that
   occupy different numbers of bricks; then ``tools.bucket_32k 64 784`` and
   ``64 0`` as child processes, whose counters must show K9a / K10a and not
   K9 / K10, and the reverse.
31. Prints one JSON line of kernel results (K1-K4 at the trainer's batch,
   B=32, K1 / K2 again at ShapeNet's three 1024 -> 1024 sites, K4 again at
   the ScanNet block hierarchy's seven KDE sites, K3 again at every level
   of ScanNet's block batch, its scene, ShapeNet and ``--points 4096``
   that it samples (a row each), K5-K10,
   K5p, K6p and K6v1 at the ScanNet shapes, K1v1 / K2v1 summed over the
   zoo's 14 sites at B=32, K3v2 / K3v3 / K3v4 summed over MCNorm's
   two sweeps at B=32, K1p over the 17 dense sites at B=32, the probes over
   the four tile sites, T1 at its tool's shapes and K9a / K10a at the 32k
   scene; each with its least
   possible time on the card, ``bound_ms``, from
   the bytes and operations of this run's inputs), the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
N = 1024
SERVE_B = 8  # the served request batch
TRAIN_B = 32  # the trainer's batch: the CLI's default --batch
N_CLASSES, GROW = 40, 128
H = 8  # the kernel MLP's hidden width

SEG_B, SEG_N, SEG_CAP = 8, 8192, 40960  # the ScanNet CLI's block batch; whole-scene cap
SEG_CLASSES, SEG_GROW, SEG_RADII = 8, 64, (0.05, 0.15, 0.4)
SEG_CPU_B = 2  # MCSeg card vs the CPU plain path (B = 8 would keep the CPU for minutes)
# The four big conv sites of MCSeg at the ScanNet widths: (name, in level,
# out level, radius, c_in, c_out); each takes K5 with a tile capacity, K9 without.
SEG_SITES = [("stem", 0, 0, SEG_RADII[0], 1, SEG_GROW),
             ("enc_0_1", 0, 1, 2 * SEG_RADII[0], SEG_GROW, None),
             ("dec_2_1", 2, 1, 2 * SEG_RADII[1], 6 * SEG_GROW, None),
             ("dec_1_0", 1, 0, 2 * SEG_RADII[0], 4 * SEG_GROW, None)]
SEG_NEIGHBOR_K = 32  # MCSeg's default neighbor_k: the level-0 sampler's list capacity
BUCKET_TRAIN_STEPS = 4  # timed MCSeg bucket train steps at B = 8 after one warm-up
MODELNET_BUCKET_N = 4096  # tasks.modelnet --points: MCClassS's conv_0_1 leaves the dense envelope
# MCClassS's conv_0_1 at N = MODELNET_BUCKET_N (the trainer's B = TRAIN_B): the
# bucket site of tasks.modelnet --points 4096, full conv 1 -> GROW at r = 0.2
MODELNET_SITE = ("modelnet_conv_0_1", 0, 1, 0.2, 1, GROW)

# The classification zoo at its published widths (mccnn_tpu/models/mcclass.py,
# mcclass_h.py), N = 1024: MCClass (grow 64) on the hierarchy 0.1 / 0.2 / 0.4,
# MCClassH (grow 128) on path A's 0.1 / 0.4 and path B's 0.1 / 0.2 / 0.4.
ZOO = ("MCClass", "MCClassH")
ZOO_CPU_B = 2  # served logits, card vs the CPU plain path
ZOO_STEP_B = 4  # the zoo train steps, card vs the CPU plain path (B >= 3: the head BNs)
ZOO_TRAIN_STEPS = 3  # tasks.modelnet steps an epoch, two epochs (the second profiled)
RADII_3 = (0.1, 0.2, 0.4)
RADII_2 = (0.1, 0.4)  # also MCClassS's hierarchy
# MCClassS's three dense sites (as tools.dense_ab.ZOO_SITES), checked with K1p
MCCLASSS_SITES = [("MCClassS conv_0_1", RADII_2, 0, 1, 0.2, 1, GROW),
                  ("MCClassS conv_1_2", RADII_2, 1, 2, 0.8, GROW, 2 * GROW),
                  ("MCClassS conv_2_3", RADII_2, 2, 3, None, 2 * GROW, 8 * GROW)]
TILE_ROOFLINE_N = 32768  # tools.tile_roofline's scene (the reference tool's default)
ACTIVE_CAP = 64  # tools.bucket_32k's cap of bench_suite.py's 32k config: no point dropped
ACTIVE_NBA = 784  # the occupied bricks of that scene at cap 64 (of 2000): lossless
ACTIVE_LOSSY_NBA = 600
ACTIVE_SMALL_B = 4
FWD_PROBES = ("noop", "planes", "mm")

# Normal estimation and ShapeNet part segmentation at the CLIs' defaults
# (mccnn_tpu/tasks/normals.py, shapenet.py): MCNorm (grow 64, radii 0.1 /
# 0.4), MCNormS (radius 0.15) and MCSeg with 4 parts and a 16-category one-hot
# (grow 64, radii 0.025 / 0.1 / 0.4), N = 1024.
NORM_RADII, NORMS_RADIUS = (0.1, 0.4), 0.15
SHAPENET_RADII, SHAPENET_PARTS, SHAPENET_CATS = (0.025, 0.1, 0.4), 4, 16
NORM_STEP_B = 4  # the MCNorm / ShapeNet train steps, card vs the CPU plain path
TASK_TRAIN_STEPS = 3  # tasks.normals / tasks.shapenet steps before their evaluation
# The Poisson sweep variants (MCCNN_POISSON_SWEEP): kernel id -> (counter,
# the variant's value, its plain version and kernel in ops/cuda/poisson_kernel.py)
SWEEP_VARIANTS = {"K3v2": ("launches_v2", "v2"), "K3v3": ("launches_v3", "v3"),
                  "K3v4": ("launches_v4", "v4")}
# The tile switches (mccnn_tpu/ops/pallas/tile_conv.py): the minor sizes K5 and
# K6 are checked at besides the default 32, those of K7 and K8, and the child
# trainers: name -> (environment, extra CLI arguments, kernels that must run,
# kernels that must not). The first runs no switch: the others' step times
# are read against it (the parent's trainer runs with --tile-pairs 32).
TILE_MINORS = (8, 16, 64, 128)
SWEEP_MINORS = (64, 8)
TILE_SWITCH_KERNELS = ("K5p", "K6p", "K6v1")
TILE_CHILD_STEPS = 4
TILE_SWITCH_CHILDREN = {
    "default": ({}, (), ("K5", "K6"), ("K5p", "K6p", "K6v1")),
    "v1": ({"MCCNN_TILE_BWD_V1": "1"}, (), ("K5", "K6v1"), ("K6", "K5p", "K6p")),
    "pack": ({"MCCNN_TILE_PACK": "1"}, (), ("K5p", "K6p"), ("K5", "K6", "K6v1")),
    "morton_aabb_64": ({"MCCNN_TILE_ORDER": "morton", "MCCNN_TILE_ADJ": "aabb",
                        "MCCNN_TILE_MINOR": "64"}, ("--whole-scene-cap", str(SEG_CAP)),
                       ("K5", "K6", "K7", "K8"), ("K5p", "K6p", "K6v1")),
}

# Tolerances, kernel vs plain version on the card, with their reasons:
# K4: fp32 sums of up to N positive terms in another order, and the kernel's
#     expf against PyTorch's exp: bounded by about N * 2^-24 = 6e-5 relative.
KDE_RTOL = 1e-4
# K1: fp32 sums over up to N neighbours and (H+1)*C products, in another
#     order than cuBLAS's (TF32 off), relative to the site's largest output.
CONV_RTOL = 1e-4
# K2: d_wf, dW2 and db2 are sums over up to N samples or B*M rows (fp32,
#     other order): 1e-4 of the tensor's largest value. dW1 and db1 sum over
#     every pair of the batch (4M at conv_0_1) with cancellation, and a pair
#     whose pre-activation rounds across 0 differently (the kernel may fuse
#     a multiply-add the plain matmul rounds twice) moves its term: 1e-3.
BWD_RTOL = 1e-4
BWD_W1_RTOL = 1e-3
# Served logits, card vs the CPU plain path: identical hierarchies (the d2
#     test is bit-equal), then fp32 sums in other orders through three convs
#     and three dense layers.
LOGIT_RTOL = 1e-3
# Train step, card vs the CPU plain path: the loss as the logits; gradients
#     through three batch-statistic BNs and the convs, 2e-3 of each tensor's
#     largest value; the updated BN running statistics 1e-4 of their largest.
#     The head Dense biases feed a BN that subtracts the batch mean, so their
#     gradient is 0 up to rounding: both sides must be below 1e-6 of the
#     largest gradient.
# K5 / K7: as K1 / K4 (fp32 sums over a tile step list's pairs in another
#     order than the plain version's), relative to the site's largest value.
TILE_RTOL = 1e-4
# K6: every gradient within 1e-4 of its tensor's largest value: fp32 sums over
#     the backward list's pairs and channels in another order. dW1 / db1 hold
#     to it too: the plain version rounds pre_h as the kernel's mc_preact does,
#     so no pair's ReLU step falls differently (K2's plain version does not).
TILE_BWD_RTOL = 1e-4
# K6v1 against its plain version and against K6: every gradient within 1e-5
#     of its tensor's largest value (fp32 sums over the backward list's pairs,
#     h and channels in other orders; all three round pre_h as mc_preact
#     does). K5p / K6p against K5 / K6: bit for bit (the same sums in the
#     same order over the same staged values).
TILE_V1_RTOL = 1e-5
# MCSeg logits, card vs the CPU plain path: identical hierarchies, then fp32
#     sums in other orders through seven convs and thirteen BNs and dense layers.
SEG_LOGIT_RTOL = 1e-3
LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-3
STAT_RTOL = 1e-4
ZERO_GRAD_PARAMS = ("fcs.0.dense.bias", "fcs.1.dense.bias")
# MCSeg's mixing layers feed batch-statistic BNs, so their biases' gradients
# are 0 up to rounding: both sides must be below 1e-3 of the largest
# gradient. They are rounding noise of sums over every point of the batch
# (1.8e-5 of the largest gradient in a B=2 x 4096 step on the CPU plain path).
SEG_ZERO_GRAD_RTOL = 1e-3
# MCSeg train step: the CPU step takes the card's BN-ReLU decisions, and may
#     take only ones within rounding: at most 1e-5 of the active values flip,
#     and each flipped value lies within 1e-5 of its BN's largest |value| of 0
#     (seed 0 on an H100: 6 flips of 4.7M active values, all at dec_bn_0, the
#     largest 6.3e-8 of its BN's largest |value|).
FLIP_SHARE = 1e-5
FLIP_VALUE_RTOL = 1e-5
# K9: fp32 sums over a window's pairs and channels in another order than the
#     plain version's (which walks the same windows and rounds pre_h as the
#     kernel does), relative to the site's largest |output|.
BUCKET_RTOL = 1e-5
# K10: every gradient within 1e-4 of its largest value: fp32 sums over pairs,
#     channels and per-block partials in another order; the ReLU steps fall as
#     in the kernel (the same pre_h rounding), so dW1 / db1 hold to it too.
BUCKET_BWD_RTOL = 1e-4
# K1v1 against its plain version and against K1, relative to the site's
#     largest |output|. Against K1: the same a_h plane (mc_preact) and fold.
#     Against the plain version taken in float64 over the kernel's own pair
#     plane (``plain_forward64``): K1v1's fp32 sums over neighbours and
#     (H+1)*C products alone, which reach 1e-6 of the largest output at the
#     full sites (the fp32 plain version sits 1.04e-6 from float64 at
#     MCClassH's global 256 -> 1024 site, 2304 products an output): 3e-6. The
#     fp32 plain version is held as K1 is (CONV_RTOL): its own sums round as
#     much again (1.09e-6 from K1v1 at MCClassH's path_a conv_1_2, B = 8).
V1_FWD_RTOL = 3e-6
# K2v1 against its plain version and against K2: d_wf, dW2 and db2 within
#     1e-5 of their largest value (fp32 sums over samples, pairs and block
#     partials in other orders); dW1 / db1 1e-4 (sums over every pair of the
#     batch with cancellation; the ReLU steps fall as in the kernels). Against
#     K2 on K1's G also bit for bit: K2v1 forms the same G rows and t and runs
#     K2's kernels on them.
V1_BWD_RTOL = 1e-5
V1_BWD_W1_RTOL = 1e-4
# K1p against its plain version: the tensor cores sum cw, -sw and b1 (exact
#     TF32 pieces) in fp32 where the plain version rounds twice, then fp32 sums
#     over neighbours and channels in other orders: as K1 (CONV_RTOL) of the
#     site's largest output. Against K1, which forms pre_h in the offset form
#     ((p - x) / r) . W1: cw - sw cancels terms of |p| |W1| / r (|p| <= 1,
#     r >= 0.1 at the zoo's sites), some ulps of pre_h more: 1e-4 too.
K1P_RTOL = 1e-4
# The probes (planes, mm) against their plain versions: fp32 sums over the
#     step list's pairs in another order, of the site's largest value; noop
#     and bwd_noop give exact zeros. T1 against its plain versions: the same
#     planes (explicit roundings, the same bf16 casts), fp32 sums of the
#     products with the bf16 features in other orders.
PROBE_RTOL = 1e-4
T1_RTOL = 1e-4
# The zoo's mixing layers and head Dense biases feed batch-statistic BNs, so
# their gradients are 0 up to rounding of sums over the batch's points: both
# sides below 1e-3 of the largest gradient, as MCSeg's mixes.
ZOO_ZERO_GRAD_RTOL = 1e-3
# K9a / K10a against their plain versions: BUCKET_RTOL / BUCKET_BWD_RTOL, as
# K9 / K10 (the same bodies); against K9 / K10 at a lossless NBA, bit for bit.


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, iters: int = 20) -> float:
    """Warm per-call time of ``fn`` on the card, from CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the fp32 rate (the H100's
    published peaks, ``mccnn_tpu_torch.tools``)."""
    from mccnn_tpu_torch.tools import PEAK_BYTES_PER_S, PEAK_FP32_FLOP_PER_S

    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pair_counts(smp, qmask, src, smask, radius) -> tuple[int, int]:
    """(valid pairs, valid pairs within the radius) of one site."""
    from mccnn_tpu_torch.core.grid import pair_d2, radius_sq

    valid = qmask[:, :, None] & smask[:, None, :]
    inr = valid & (pair_d2(smp, src) <= radius_sq(radius))
    return int(valid.sum()), int(inr.sum())


def request(rng: np.random.Generator, b: int, n: int = N) -> dict:
    from mccnn_tpu_torch.data.datasets import _normalize_np
    from mccnn_tpu_torch.data.synthetic import classification_batch

    pts, _ = classification_batch(rng, b, n)
    pts = np.stack([_normalize_np(p) for p in pts])
    return {"points": pts, "mask": np.ones((b, n), bool)}


def levels(req: dict, dev, radii=(0.1, 0.4)) -> list:
    """The path's levels, built by the plain path on the CPU: the kernels then
    see exactly the shapes and padding masks they get there."""
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy

    hier = build_hierarchy(
        torch.from_numpy(req["points"]), torch.from_numpy(req["mask"]), radii,
        global_level=True,
    )
    lv = [(l.points.to(dev), l.mask.to(dev)) for l in hier.levels]
    print("levels:", [tuple(p.shape[:2]) for p, _ in lv],
          "valid per cloud:", [int(m.sum(1).min()) for _, m in lv], flush=True)
    return lv


def site_params(gen, c, co, dev):
    from mccnn_tpu_torch.core.mcconv import init_mcconv_params

    params = init_mcconv_params(gen, c, co, device=dev)
    return params._replace(
        b1=0.1 * torch.randn(params.b1.shape, generator=gen).to(dev),
        b2=0.1 * torch.randn(params.b2.shape, generator=gen).to(dev),
    )


def wcat(params, c, co):
    """[W2; b2] as one ((H+1)*C, CO) matrix: the GEMM operand of K1 and K2."""
    return torch.cat([params.w2.reshape(H * c, co), params.b2.reshape(c, co)]).contiguous()


def check_kde_site(name, pts, mask, radius) -> tuple:
    """K4 at one site: both bodies against the plain version (KDE_RTOL), the
    body ``pick_body`` takes bit for bit on repeat, each body's in-radius
    counts (the weight off) exactly the plain ones; timed, with the bound of
    the in-radius pairs' operations. The row of the kernels line."""
    from mccnn_tpu_torch.core.grid import pair_d2, radius_sq
    from mccnn_tpu_torch.ops.cuda import density_kernel

    body = density_kernel.pick_body(pts.shape[1])
    want = density_kernel.kde_density_reference(pts, mask, radius)
    r2 = radius_sq(radius)
    counts = torch.zeros(mask.shape, device=pts.device)
    for i0 in range(0, pts.shape[1], 1024):
        inr = (pair_d2(pts[:, i0:i0 + 1024].contiguous(), pts) <= r2) & mask[:, None, :]
        counts[:, i0:i0 + 1024] = inr.sum(-1).float()
    counts = torch.where(mask, counts, 1.0)
    errs, times = {}, {}
    for bd in ("culled", "all_pairs"):
        got = density_kernel.kde_density_cuda(pts, mask, radius, body=bd)
        again = density_kernel.kde_density_cuda(pts, mask, radius, body=bd)
        cnt = density_kernel._launch(pts, mask, r2, 0.0, 1.0, bd)
        torch.cuda.synchronize()
        require(bool(torch.equal(got, again)), f"K4 ({bd}) differs between two calls at {name}")
        require(bool(torch.equal(cnt, counts)),
                f"K4 ({bd}) drops or adds an in-radius pair at {name}")
        require(bool(torch.allclose(got, want, rtol=KDE_RTOL, atol=0.0)),
                f"K4 ({bd}) disagrees with its plain version at {name}")
        errs[bd] = (float((got - want).abs().max()),
                    float(((got - want).abs() / want.abs()).max()))
        times[bd] = time_ms(lambda: density_kernel.kde_density_cuda(pts, mask, radius, body=bd))
    pms = time_ms(lambda: density_kernel.kde_density_reference(pts, mask, radius), iters=3)
    inr = int((counts * mask).sum())
    bms, by = bound(pts.shape[0] * pts.shape[1] * (12 + 1 + 4), 12 * inr)
    print(f"K4 {name}: body={body} max_abs_err={errs[body][0]:.3e} "
          f"max_rel_err={errs[body][1]:.3e} (culled {errs['culled'][1]:.3e}, all_pairs "
          f"{errs['all_pairs'][1]:.3e}) bitwise_repeatable=True counts_exact=True "
          f"in_radius_pairs={inr} kernel_ms={times[body]:.4f} (culled "
          f"{times['culled']:.4f}, all_pairs {times['all_pairs']:.4f}) plain_ms={pms:.4f} "
          f"bound_ms={bms:.6f} ({by})", flush=True)
    return (errs[body][0], times[body], pms, bms, by, None)


def check_kde_levels(dev, lv) -> list:
    """K4 at MCSeg's seven KDE sites of the block batch (``SEG_KDE_SITES``)."""
    from mccnn_tpu_torch.tools.dense_ab import SEG_KDE_SITES

    return [check_kde_site(f"ScanNet B={lv[i][0].shape[0]} level {i} N={lv[i][0].shape[1]} "
                           f"r={radius}", *lv[i], radius) for i, radius in SEG_KDE_SITES]


def check_poisson_site(name, pts, mask, radius) -> tuple:
    """K3 at one site: bit for bit its plain version, timed, with the bound
    of its bytes and of the d2 that coverage needs (8 operations an
    in-radius pair of a selected point and a valid point: a point is
    covered by the selected points within r of it). The row of the kernels
    line."""
    from mccnn_tpu_torch.core.sampling import sweep_cells
    from mccnn_tpu_torch.ops.cuda import poisson_kernel

    cids, colors = sweep_cells(pts, radius)  # int32, as the kernel takes them
    args = (pts, mask, cids, colors, radius)
    got = poisson_kernel.poisson_sweep_cuda(*args)
    want = poisson_kernel.poisson_sweep_reference(*args)
    torch.cuda.synchronize()
    diff = int((got != want).sum())
    B, N = mask.shape
    ms = time_ms(lambda: poisson_kernel.poisson_sweep_cuda(*args))
    pms = time_ms(lambda: poisson_kernel.poisson_sweep_reference(*args),
                  iters=5 if B * N <= 32 * 1024 else 2)
    _, inr = pair_counts(pts, mask & want, pts, mask, radius)
    bms, by = bound(B * N * (12 + 1 + 4 + 4 + 1), 8 * inr)
    print(f"K3 {name} B={B} N={N} r={radius}: selected={int(got.sum())} "
          f"differing_flags={diff} kernel_ms={ms:.4f} plain_ms={pms:.4f} "
          f"bound_ms={bms:.6f} ({by})", flush=True)
    require(diff == 0, f"K3 selection differs from its plain version at {name} (N={N})")
    return (float(diff), ms, pms, bms, by, None)


K3_PATHS = ("ScanNet block batch", "ScanNet scene", "ShapeNet", "--points 4096")


def check_poisson_sites(dev) -> dict:
    """K3 at the dense sweeps of the other default paths
    (``dense_ab.poisson_sites`` but MCClassS's, which ``check_kernels``
    holds), by path (``K3_PATHS``): ScanNet's levels 1 and 2 in the block
    batch (B = 8) and the scene (B = 1), ShapeNet's levels 0-2 and
    ``--points 4096``'s levels 0-1."""
    from mccnn_tpu_torch.tools.dense_ab import poisson_sites

    rows = {path: [] for path in K3_PATHS}
    with torch.no_grad():
        for path, name, pts, mask, radius in poisson_sites(dev):
            if path in rows:
                rows[path].append(check_poisson_site(name, pts, mask, radius))
    return rows


def check_kernels(dev, b: int) -> dict:
    """Kernel vs plain version at the shapes a batch of ``b`` clouds gives them."""
    from mccnn_tpu_torch.api.hierarchy import GLOBAL_RADIUS
    from mccnn_tpu_torch.ops.cuda import dense_conv, density_kernel

    rng = np.random.default_rng(SEED + b)
    lv = levels(request(rng, b), dev)
    results = {"K1": [], "K3": [], "K4": []}

    with torch.no_grad():
        pdfs = {}
        for lvl, radius in ((0, 0.2), (1, 0.8), (2, GLOBAL_RADIUS)):
            pts, mask = lv[lvl]
            results["K4"].append(check_kde_site(f"B={b} N={pts.shape[1]} r={radius:.4f}", pts,
                                                mask, radius))
            pdfs[(lvl, radius)] = density_kernel.kde_density_reference(pts, mask, radius)

        for lvl, radius in ((0, 0.1), (1, 0.4)):
            results["K3"].append(check_poisson_site(f"MCClassS level {lvl}", *lv[lvl], radius))

        gen = torch.Generator().manual_seed(SEED)
        sites = [  # (in level, out level, radius, C, CO, main path?)
            (0, 1, 0.2, 1, GROW, True),
            (1, 2, 0.8, GROW, 2 * GROW, True),
            (2, 3, GLOBAL_RADIUS, 2 * GROW, 8 * GROW, True),
            (1, 2, 0.8, GROW, None, False),  # depthwise
            (0, 1, 0.2, 1, GROW, False),  # mean mode (use_pdf=False)
        ]
        for k, (i, o, radius, c, co, main) in enumerate(sites):
            mean = k == 4
            (src, smask), (smp, qmask) = lv[i], lv[o]
            params = site_params(gen, c, co, dev)
            feats = (torch.ones((b, src.shape[1], 1)) if c == 1 else
                     torch.randn((b, src.shape[1], c), generator=gen)).to(dev)
            pdf = torch.ones_like(src[..., 0]) if mean else pdfs[(i, radius)]
            args = (params, smp, qmask, src, smask, feats, pdf, radius)
            kw = dict(c_out=co, mean_normalize=mean, with_count=True)
            got, gcnt = dense_conv.dense_mc_conv(*args, **kw)
            want, wcnt = dense_conv.dense_mc_conv_reference(*args, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ms = time_ms(lambda: dense_conv.dense_mc_conv(*args, **kw))
            pms = time_ms(lambda: dense_conv.dense_mc_conv_reference(*args, **kw))
            mode = "mean" if mean else ("depthwise" if co is None else "full")
            line = (f"K1 B={b} conv_{i}_{o} {mode} N={src.shape[1]} M={smp.shape[1]} C={c} "
                    f"CO={co}: max_abs_err={err:.3e} max_abs_out={scale:.3e} "
                    f"kernel_ms={ms:.4f} plain_ms={pms:.4f}")
            require(bool(torch.equal(gcnt, wcnt)), f"K1 neighbour counts differ at conv_{i}_{o}")
            require(bool(torch.allclose(got, want, rtol=CONV_RTOL, atol=CONV_RTOL * scale)),
                    f"K1 disagrees with its plain version at conv_{i}_{o} ({mode})")
            if main:
                M = smp.shape[1]
                R, K = b * M, (H + 1) * c
                valid, inr = pair_counts(smp, qmask, src, smask, radius)
                nbytes = 4 * (b * M * 3 + b * src.shape[1] * 3 + b * src.shape[1] * c
                              + 4 * H + K * co + b * M * co + b * M) + b * (M + src.shape[1])
                flops = (8 * valid + inr * (6 + 6 * H + 2 * (H + 1) * c)
                         + 2 * int(qmask.sum()) * K * co)
                bms, by = bound(nbytes, flops)
                G = torch.randn((R, K), generator=gen).to(dev)
                W = wcat(params, c, co)
                lms = time_ms(lambda: torch.matmul(G, W))
                line += (f" bound_ms={bms:.6f} ({by}) matmul_ms={lms:.4f} "
                         f"(torch.matmul {R}x{K} @ {K}x{co})")
                results["K1"].append((err, ms, pms, bms, by, lms))
            print(line, flush=True)
    return results


def check_backward(dev, b: int) -> list:
    """K2 vs its plain version at the three conv sites of a training batch of
    ``b`` clouds."""
    from mccnn_tpu_torch.api.hierarchy import GLOBAL_RADIUS
    from mccnn_tpu_torch.ops.cuda import dense_conv, density_kernel

    rng = np.random.default_rng(SEED + 3 + b)
    lv = levels(request(rng, b), dev)
    gen = torch.Generator().manual_seed(SEED + 3)
    rows = []
    sites = [(0, 1, 0.2, 1, GROW), (1, 2, 0.8, GROW, 2 * GROW),
             (2, 3, GLOBAL_RADIUS, 2 * GROW, 8 * GROW)]
    names = ("d_wf", "dw1", "db1", "dw2", "db2")
    with torch.no_grad():
        for i, o, radius, c, co in sites:
            (src, smask), (smp, qmask) = lv[i], lv[o]
            M, Ns = smp.shape[1], src.shape[1]
            params = site_params(gen, c, co, dev)
            feats = (torch.ones((b, Ns, 1)) if c == 1 else
                     torch.randn((b, Ns, c), generator=gen)).to(dev)
            pdf = density_kernel.kde_density_reference(src, smask, radius)
            wf = dense_conv._weighted_features(feats, pdf, smask)
            _, cnt, G = dense_conv._forward_reference(params, smp, qmask, src, smask, wf,
                                                      radius, co, False)
            dout = torch.randn((b, M, co), generator=gen).to(dev)
            args = (params, smp, qmask, src, smask, wf, radius, G, cnt, dout)
            got = dense_conv.dense_mc_conv_backward_cuda(*args, c_out=co)
            again = dense_conv.dense_mc_conv_backward_cuda(*args, c_out=co)
            want = dense_conv.dense_mc_conv_backward_reference(*args, c_out=co)
            torch.cuda.synchronize()
            err = 0.0
            parts = []
            for name, a, a2, w in zip(names, got, again, want):
                require(tuple(a.shape) == tuple(w.shape), f"K2 {name} shape {tuple(a.shape)}")
                require(bool(torch.equal(a, a2)),
                        f"K2 {name} differs between two calls at conv_{i}_{o}")
                scale = float(w.abs().max())
                e = float((a - w).abs().max())
                err = max(err, e)
                tol = BWD_W1_RTOL if name in ("dw1", "db1") else BWD_RTOL
                parts.append(f"{name} {e:.3e}/{scale:.3e}")
                require(bool(torch.allclose(a, w, rtol=tol, atol=tol * scale)),
                        f"K2 {name} disagrees with its plain version at conv_{i}_{o}")
            ms = time_ms(lambda: dense_conv.dense_mc_conv_backward_cuda(*args, c_out=co))
            pms = time_ms(lambda: dense_conv.dense_mc_conv_backward_reference(*args, c_out=co),
                          iters=5)
            R, K = b * M, (H + 1) * c
            valid, inr = pair_counts(smp, qmask, src, smask, radius)
            nbytes = 4 * (b * M * 3 + b * Ns * 3 + 2 * b * Ns * c + 4 * H + 2 * K * co
                          + R * K + R + R * co + 4 * H) + b * (M + Ns)
            # the two GEMMs over the valid samples' rows, then the pairs
            flops = (4 * int(qmask.sum()) * K * co + 8 * valid
                     + inr * (6 + 6 * H + 2 * (H + 1) * c + 2 * H * c + 8 * H))
            bms, by = bound(nbytes, flops)
            t = dout.reshape(R, co).contiguous()
            W = wcat(params, c, co)
            Gf = G.reshape(R, K)
            lms = time_ms(lambda: (torch.matmul(t, W.T), torch.matmul(Gf.T, t)))
            print(f"K2 B={b} conv_{i}_{o} N={Ns} M={M} C={c} CO={co} pairs={valid} in_radius={inr}: "
                  f"max_abs_err (err/scale) {', '.join(parts)}; bitwise_repeatable=True "
                  f"kernel_ms={ms:.4f} plain_ms={pms:.4f} bound_ms={bms:.6f} ({by}) "
                  f"matmul_ms={lms:.4f} (torch.matmul {R}x{co} @ {co}x{K} and "
                  f"{K}x{R} @ {R}x{co})", flush=True)
            rows.append((err, ms, pms, bms, by, lms))
    return rows


def check_shapenet_sites(dev) -> dict:
    """K1 and K2 against their plain versions at ShapeNet's three 1024 -> 1024
    sites (``tools.dense_ab.shapenet_sites``) at the trainer's batch: counts
    bit-equal, bitwise repeat, times, bounds and the GEMM parts' library calls."""
    from mccnn_tpu_torch.ops.cuda import dense_conv
    from mccnn_tpu_torch.tools.dense_ab import shapenet_sites, site_inputs

    gen = torch.Generator().manual_seed(SEED + 7)
    rows = {"K1": [], "K2": []}
    names = ("d_wf", "dw1", "db1", "dw2", "db2")
    with torch.no_grad():
        for site in shapenet_sites(TRAIN_B, dev):
            name, _, _, radius, c, co = site
            params, smp, qmask, src, smask, wf, dout = site_inputs(site, gen, dev)
            b, M, Ns = smp.shape[0], smp.shape[1], src.shape[1]
            fargs = (params, smp, qmask, src, smask, wf, radius, co, False)
            out, cnt, G = dense_conv._forward_cuda(*fargs)
            out2, _, G2 = dense_conv._forward_cuda(*fargs)
            want, wcnt, wG = dense_conv._forward_reference(*fargs)
            torch.cuda.synchronize()
            require(bool(torch.equal(cnt, wcnt)), f"K1 neighbour counts differ at {name}")
            require(bool(torch.equal(out, out2) and torch.equal(G, G2)),
                    f"K1 differs between two calls at {name}")
            err, scale = float((out - want).abs().max()), float(want.abs().max())
            require(bool(torch.allclose(out, want, rtol=CONV_RTOL, atol=CONV_RTOL * scale)),
                    f"K1 disagrees with its plain version at {name}")
            valid, inr = pair_counts(smp, qmask, src, smask, radius)
            nq = int(qmask.sum())
            R, K = b * M, (H + 1) * c
            ms = time_ms(lambda: dense_conv._forward_cuda(*fargs))
            pms = time_ms(lambda: dense_conv._forward_reference(*fargs), iters=5)
            bms, by = dense_bound(b, M, Ns, c, co, valid, inr, nq, backward=False)
            Gr = wG.reshape(R, H + 1, c)
            if co is None:  # depthwise: G's rows against [w2; b2] channel by channel
                Wd = torch.cat([params.w2, params.b2[None]]).contiguous()
                lms = time_ms(lambda: torch.einsum("rkc,kc->rc", Gr, Wd))
                lib_what = f"torch.einsum rkc,kc->rc over {R}x{H + 1}x{c}"
            else:
                W, Gf = wcat(params, c, co), wG.reshape(R, K)
                lms = time_ms(lambda: torch.matmul(Gf, W))
                lib_what = f"torch.matmul {R}x{K} @ {K}x{co}"
            print(f"K1 B={b} {name} N={Ns} M={M} C={c} CO={co} pairs={valid} in_radius={inr}: "
                  f"max_abs_err={err:.3e} max_abs_out={scale:.3e} bitwise_repeatable=True "
                  f"kernel_ms={ms:.4f} plain_ms={pms:.4f} bound_ms={bms:.6f} ({by}) "
                  f"library_ms={lms:.4f} ({lib_what})", flush=True)
            rows["K1"].append((err, ms, pms, bms, by, lms))

            bargs = (params, smp, qmask, src, smask, wf, radius, wG, wcnt, dout)
            got = dense_conv.dense_mc_conv_backward_cuda(*bargs, c_out=co)
            again = dense_conv.dense_mc_conv_backward_cuda(*bargs, c_out=co)
            ref = dense_conv.dense_mc_conv_backward_reference(*bargs, c_out=co)
            torch.cuda.synchronize()
            berr, parts = 0.0, []
            for part, a, a2, w in zip(names, got, again, ref):
                require(bool(torch.equal(a, a2)), f"K2 {part} differs between two calls at {name}")
                sc, e = float(w.abs().max()), float((a - w).abs().max())
                berr = max(berr, e)
                tol = BWD_W1_RTOL if part in ("dw1", "db1") else BWD_RTOL
                parts.append(f"{part} {e:.3e}/{sc:.3e}")
                require(bool(torch.allclose(a, w, rtol=tol, atol=tol * sc)),
                        f"K2 {part} disagrees with its plain version at {name}")
            ms = time_ms(lambda: dense_conv.dense_mc_conv_backward_cuda(*bargs, c_out=co))
            pms = time_ms(lambda: dense_conv.dense_mc_conv_backward_reference(*bargs, c_out=co),
                          iters=3)
            bms, by = dense_bound(b, M, Ns, c, co, valid, inr, nq, backward=True)
            t = dout.reshape(R, -1).contiguous()
            if co is None:
                lms = time_ms(lambda: (t[:, None, :] * Wd, torch.einsum("rkc,rc->kc", Gr, t)))
                lib_what = f"t * [w2; b2] and torch.einsum rkc,rc->kc over {R}x{H + 1}x{c}"
            else:
                lms = time_ms(lambda: (torch.matmul(t, W.T), torch.matmul(Gf.T, t)))
                lib_what = f"torch.matmul {R}x{co} @ {co}x{K} and {K}x{R} @ {R}x{co}"
            print(f"K2 B={b} {name} N={Ns} M={M} C={c} CO={co} pairs={valid} in_radius={inr}: "
                  f"max_abs_err (err/scale) {', '.join(parts)}; bitwise_repeatable=True "
                  f"kernel_ms={ms:.4f} plain_ms={pms:.4f} bound_ms={bms:.6f} ({by}) "
                  f"library_ms={lms:.4f} ({lib_what})", flush=True)
            rows["K2"].append((berr, ms, pms, bms, by, lms))
    return rows


def calibrate_bn(model, batch: dict, rng: np.random.Generator) -> None:
    """Seeded, non-trivial BN statistics near each BN input's real moments, so
    the logits depend on the conv outputs and not on the statistics alone."""
    from mccnn_tpu_torch.models.layers import MaskedBatchNorm
    from mccnn_tpu_torch.serve import make_predict_fn

    predict = make_predict_fn(model)
    dev = next(model.parameters()).device
    args = [torch.from_numpy(batch[k]).to(dev) for k in ("points", "mask")]
    if "category_onehot" in batch:  # MCSeg on ShapeNet
        args += [None, torch.from_numpy(batch["category_onehot"]).to(dev)]
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    for bn in bns:
        seen = []
        hook = bn.register_forward_pre_hook(lambda mod, inp: seen.append(inp[0]))
        predict(*args)
        hook.remove()
        x = seen[0].reshape(-1, seen[0].shape[-1]).double()
        # the RMS sets the scale: the head's BNs see only B rows
        mean, rms = x.mean(0), x.square().mean(0).sqrt().clamp_min(1e-6)
        c = mean.shape[0]
        noise = lambda: torch.from_numpy(rng.normal(size=c)).to(dev)
        uni = lambda lo, hi: torch.from_numpy(rng.uniform(lo, hi, size=c)).to(dev)
        bn.mean.copy_((mean + 0.1 * rms * noise()).float())
        bn.var.copy_((rms**2 * uni(0.5, 1.5)).float())
        with torch.no_grad():
            bn.scale.copy_(uni(0.5, 1.5).float())
            bn.bias.copy_((0.1 * noise()).float())


def same_hierarchy(req: dict, dev, radii=(0.1, 0.4)) -> bool:
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy

    with torch.inference_mode():
        h_gpu = build_hierarchy(torch.from_numpy(req["points"]).to(dev),
                                torch.from_numpy(req["mask"]).to(dev), radii)
        h_cpu = build_hierarchy(torch.from_numpy(req["points"]),
                                torch.from_numpy(req["mask"]), radii)
    return all(
        torch.equal(a.sample.idx.cpu(), c.sample.idx) and torch.equal(a.mask.cpu(), c.mask)
        for a, c in zip(h_gpu.levels[1:], h_cpu.levels[1:])
    )


def counters() -> dict:
    """Each kernel's launch counter: (module, attribute) or, for a counter
    kept per variant, (module, attribute, key)."""
    from mccnn_tpu_torch.ops.cuda import (dense_conv, dense_probe, density_kernel,
                                          mcconv_kernel, poisson_kernel, tile_conv)

    return {"K1": (dense_conv, "launches"), "K2": (dense_conv, "backward_launches"),
            "K1p": (dense_conv, "launches_planes"),
            **{f"K5 probe {p}": (tile_conv, "launches_probe", p) for p in FWD_PROBES},
            "K6 bwd_noop": (tile_conv, "backward_launches_probe"),
            **{f"T1 {v}": (dense_probe, "launches", v) for v in dense_probe.VARIANTS},
            "K1v1": (dense_conv, "launches_v1"), "K2v1": (dense_conv, "backward_launches_v1"),
            "K3": (poisson_kernel, "launches"), "K4": (density_kernel, "launches"),
            "K5": (tile_conv, "launches"), "K6": (tile_conv, "backward_launches"),
            "K7": (tile_conv, "kde_launches"),
            "K8": (tile_conv, "cover_launches"),
            "K9": (mcconv_kernel, "launches"), "K10": (mcconv_kernel, "backward_launches"),
            "K9a": (mcconv_kernel, "launches_active"),
            "K10a": (mcconv_kernel, "backward_launches_active"),
            "K5p": (tile_conv, "packed_launches"), "K6p": (tile_conv, "packed_backward_launches"),
            "K6v1": (tile_conv, "backward_v1_launches"),
            **{kid: (poisson_kernel, attr) for kid, (attr, _) in SWEEP_VARIANTS.items()}}


def reset_counts() -> None:
    for module, attr, *key in counters().values():
        if key:
            getattr(module, attr)[key[0]] = 0
        else:
            setattr(module, attr, 0)


def read_counts() -> dict:
    return {k: getattr(module, attr)[key[0]] if key else getattr(module, attr)
            for k, (module, attr, *key) in counters().items()}


def serve(dev) -> dict:
    from mccnn_tpu_torch.models import MCClassS
    from mccnn_tpu_torch.serve import Predictor

    rng = np.random.default_rng(SEED + 1)
    model = MCClassS(N_CLASSES, grow=GROW, generator=torch.Generator().manual_seed(SEED))
    model = model.to(dev)
    calibrate_bn(model, request(rng, SERVE_B), rng)
    cpu_model = copy.deepcopy(model).cpu()
    predictor = Predictor(model, SERVE_B)
    cpu_predictor = Predictor(cpu_model, SERVE_B)
    requests = [request(rng, b) for b in (8, 3, 1, 8, 3, 1)]
    torch.cuda.synchronize()

    reset_counts()
    served, latencies = [], []
    for req in requests:
        t0 = time.perf_counter()
        logits = predictor.predict(req)
        torch.cuda.synchronize()
        latencies.append((len(req["points"]), (time.perf_counter() - t0) * 1e3))
        served.append(logits)
    launches = read_counts()
    print("launches while serving:", launches, flush=True)
    for name in ("K1", "K3", "K4"):
        require(launches[name] > 0, f"{name} was not launched while serving")
    require(launches["K2"] == 0 and launches["K6"] == 0, "a backward was launched while serving")

    for req, logits, (b, ms) in zip(requests, served, latencies):
        want = cpu_predictor.predict(req)
        got = logits.cpu()
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        same_levels = same_hierarchy(req, dev)
        print(f"served batch of {b}: latency_ms={ms:.3f} logits={tuple(got.shape)} "
              f"max_abs_err_vs_cpu={err:.3e} max_abs_logit={top:.3e} "
              f"hierarchy_equal_to_cpu={same_levels}", flush=True)
        require(tuple(got.shape) == (b, N_CLASSES), f"logits shape {tuple(got.shape)}")
        require(bool(torch.isfinite(got).all()), "non-finite logits")
        require(same_levels, "the card's hierarchy differs from the CPU plain path's")
        require(bool(torch.allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_RTOL * top)),
                "served logits disagree with the CPU plain path")
    return launches


def train_one_step(model, device, batch: dict, loss_fn) -> tuple:
    """One train step of ``model`` on ``device`` from a fresh optimizer:
    ``(loss, grads, buffers, ms, metrics)`` with the tensors on the CPU."""
    from mccnn_tpu_torch.train import batch_to_device, init_state, make_optimizer, make_train_step

    m = model.to(device)
    opt = make_optimizer(m.parameters())
    init_state(m, opt, SEED)
    step = make_train_step(m, opt, loss_fn)
    t0 = time.perf_counter()
    loss, metrics = step(batch_to_device(batch, device))
    loss = float(loss)  # waits for the device
    ms = (time.perf_counter() - t0) * 1e3
    grads = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
    stats = {n: b.detach().cpu() for n, b in m.named_buffers()}
    return loss, grads, stats, ms, metrics


def compare_train_steps(what: str, card: tuple, cpu: tuple, zero_grad, zero_rtol: float) -> None:
    """The card's train step against the CPU plain path's: the loss, every
    gradient (those named by ``zero_grad`` are analytically 0: both sides
    must be below ``zero_rtol`` of the largest gradient) and every buffer."""
    loss, grads, stats, ms, _ = card
    cpu_loss, cpu_grads, cpu_stats, cpu_ms, _ = cpu
    top = max(float(g.abs().max()) for n, g in cpu_grads.items() if not zero_grad(n))
    worst, worst_zero = (0.0, ""), 0.0
    for name, want in cpu_grads.items():
        got = grads[name]
        if zero_grad(name):
            noise = max(float(got.abs().max()), float(want.abs().max())) / top
            worst_zero = max(worst_zero, noise)
            require(noise < zero_rtol, f"{what}: {name} should have a zero gradient "
                    f"({noise:.3e} of the largest gradient)")
            continue
        scale = float(want.abs().max())
        rel = float((got - want).abs().max()) / scale
        worst = max(worst, (rel, name))
        require(bool(torch.allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale)),
                f"{what}: the gradient of {name} disagrees with the CPU plain path "
                f"({rel:.3e} of its largest value)")
    worst_stat = (0.0, "")
    for name, want in cpu_stats.items():
        scale = float(want.abs().max())
        rel = float((stats[name] - want).abs().max()) / max(scale, 1e-30)
        worst_stat = max(worst_stat, (rel, name))
        require(bool(torch.allclose(stats[name], want, rtol=STAT_RTOL, atol=STAT_RTOL * scale)),
                f"{what}: BN statistic {name} disagrees with the CPU plain path")
    print(f"{what}: loss={loss:.6f} cpu_loss={cpu_loss:.6f} "
          f"worst_grad_rel_err={worst[0]:.3e} ({worst[1]}) "
          f"zero_grad_noise={worst_zero:.3e} of the largest gradient "
          f"worst_bn_stat_rel_err={worst_stat[0]:.3e} ({worst_stat[1]}) "
          f"first_step_ms card={ms:.1f} cpu={cpu_ms:.1f}", flush=True)
    require(abs(loss - cpu_loss) <= LOSS_RTOL * abs(cpu_loss), f"{what}: the loss disagrees")


def check_train_step(dev, b: int) -> None:
    """One full-width train step of ``b`` clouds on the card against the CPU
    plain path."""
    from mccnn_tpu_torch.models import MCClassS
    from mccnn_tpu_torch.tasks.modelnet import make_loss

    rng = np.random.default_rng(SEED + 2 + b)
    batch = request(rng, b)
    batch["labels"] = rng.integers(0, N_CLASSES, size=b).astype(np.int32)
    require(same_hierarchy(batch, dev), "the card's training hierarchy differs from the CPU's")
    model = MCClassS(N_CLASSES, grow=GROW, drop_rate=0.0,
                     generator=torch.Generator().manual_seed(SEED))
    loss_fn = make_loss("MCClassS")
    cpu = train_one_step(copy.deepcopy(model), "cpu", batch, loss_fn)
    card = train_one_step(model, dev, batch, loss_fn)
    compare_train_steps(f"train step B={b}", card, cpu, lambda n: n in ZERO_GRAD_PARAMS, 1e-6)


def run_trainer() -> dict:
    """``tasks.modelnet`` through its entry point, at the CLI's batch shape."""
    from mccnn_tpu_torch.tasks import modelnet

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--batch", str(TRAIN_B), "--points", str(N), "--n-classes", "40",
                "--grow", "128", "--epochs", "1", "--steps-per-epoch", "4",
                "--device", "cuda", "--log-dir", tmp, "--ckpt-dir", os.path.join(tmp, "ck")]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = modelnet.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(tmp, "modelnet_MCClassS.metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["tag"] == "train"]
    require(len(train) == 1 and train[0]["steps"] == 4, f"trainer records: {recs}")
    rec = train[0]
    print(f"trainer (tasks.modelnet, B={TRAIN_B}, N={N}, grow=128, 40 classes, dropout 0.5): "
          f"loss={rec['loss']:.6f} acc={rec['acc']:.4f} steps={rec['steps']} "
          f"epoch_sec={rec['sec']} warm_step_ms={rec['warm_step_ms']:.3f} "
          f"eval_accuracy={res['best_accuracy']:.4f} total_sec={seconds:.2f} "
          f"launches={launches}", flush=True)
    require(bool(np.isfinite(rec["loss"])), "the trainer's loss is not finite")
    for name in ("K1", "K2", "K3", "K4"):
        require(launches[name] > 0, f"{name} was not launched while training")
    return launches

# ------------------------------------------------------------ ScanNet segmentation


def scene_batch(seed: int, b: int) -> dict:
    """A synthetic ScanNet block batch of ``b`` x SEG_N points (the CLI's source)."""
    from mccnn_tpu_torch.tasks.scannet import SyntheticSceneSource

    src = SyntheticSceneSource(4, SEG_CLASSES, seed)
    return next(src.batches(b, SEG_N, np.random.default_rng(seed)))


def inr_pairs(smp, qmask, src, smask, radius, cand=None) -> int:
    """Valid pairs within ``radius`` (with a flagged candidate, when given),
    counted in chunks of samples."""
    from mccnn_tpu_torch.core.grid import pair_d2, radius_sq

    r2, total = radius_sq(radius), 0
    ok_src = smask if cand is None else smask & cand
    for i0 in range(0, smp.shape[1], 1024):
        d2 = pair_d2(smp[:, i0:i0 + 1024].contiguous(), src)
        ok = (d2 <= r2) & qmask[:, i0:i0 + 1024, None] & ok_src[:, None, :]
        total += int(ok.sum())
    return total


def check_cover_sweep(dev, pts, mask, tile_pairs, timed: bool = True) -> tuple:
    """K8 at each colour of the level-0 tile sweep, then the sweep's selection
    against the sampler's own path and (``timed``) the dense plain sampler;
    ``timed`` also times the kernel and its plain version and sums the bounds."""
    from mccnn_tpu_torch.core import sampling
    from mccnn_tpu_torch.core.grid import cell_color27, linear_cell_ids
    from mccnn_tpu_torch.ops.cuda import poisson_kernel, tile_conv
    from mccnn_tpu_torch.tools.dense_ab import cover_colours

    radius = SEG_RADII[0]
    B, N, _ = pts.shape
    sweep, flags, sel = cover_colours(
        pts, mask, radius, tile_pairs, lambda lay, f: tile_conv.cover_counts_cuda(lay, f, radius))
    lay = sweep.layout
    rows = sweep.valid.shape[1]
    err = ms = pms = bms = 0.0
    flagged_pairs = 0
    bounds = []
    for c, cand in enumerate(flags):
        got = tile_conv.cover_counts_cuda(lay, cand, radius)
        again = tile_conv.cover_counts_cuda(lay, cand, radius)
        want = tile_conv.cover_counts_reference(lay, cand, radius)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        require(bool(torch.equal(got, want)), f"K8 differs from its plain version at colour {c}")
        require(bool(torch.equal(got, again)), f"K8 differs between two calls at colour {c}")
        if timed:
            ms += time_ms(lambda: tile_conv.cover_counts_cuda(lay, cand, radius), iters=5)
            pms += time_ms(lambda: tile_conv.cover_counts_reference(lay, cand, radius), iters=1)
            pairs = inr_pairs(lay.pts, lay.valid, lay.pts, lay.valid, radius, cand)
            flagged_pairs += pairs
            bounds.append(bound(B * rows * (12 + 1 + 1 + 4), 8 * pairs))
            bms += bounds[-1][0]
    coords, res = sampling._sampler_grid(pts, radius)
    cids, colors = linear_cell_ids(coords, res), cell_color27(coords)
    path, ovf = sampling._poisson_tiles(pts, mask, coords, cids, colors, radius, res, tile_pairs)
    dense = (poisson_kernel.poisson_sweep_reference(pts, mask, cids, colors, radius) & mask
             if timed else sel)
    torch.cuda.synchronize()
    print(f"K8 B={B} N={N} r={radius} Tm={lay.steps.Tm} S={lay.S} (27 colours): "
          f"max_abs_err={err:.1f} "
          f"bit_equal=True "
          f"bitwise_repeatable=True selected={int(sel.sum())} "
          f"equal_to_the_sampler_path={bool(torch.equal(sel, path & mask))} "
          f"equal_to_the_dense_plain_sampler="
          f"{bool(torch.equal(sel, dense)) if timed else 'not run'} "
          f"overflow={int(ovf.max())} flagged_in_radius_pairs={flagged_pairs} "
          f"kernel_ms={ms:.4f} plain_ms={pms:.4f} bound_ms={bms:.6f} (per sweep, summed)",
          flush=True)
    require(bool(torch.equal(sel, path & mask)), "the tile sampler's path differs from the "
            "per-colour replay")
    require(bool(torch.equal(sel, dense)), "the tile sweep differs from the dense plain sampler")
    require(int(ovf.max()) == 0, "the level-0 sampler overflowed its auto-sized capacity")
    return (err, ms, pms, bms, max(bounds)[1] if bounds else None, None)


def check_tile_kde(dev, tile_pairs_whole, block) -> tuple:
    """K7 at the whole scene's two level-0 radii, and K7 against K4 at 8192."""
    from mccnn_tpu_torch.ops.cuda import density_kernel, tile_conv
    from mccnn_tpu_torch.tools.dense_ab import whole_scene

    pts, mask = (torch.from_numpy(a).to(dev) for a in whole_scene(SEED + 6))
    err = ms = pms = bms = 0.0
    by = "operations"
    for radius in (SEG_RADII[0], SEG_RADII[0] * 2.0):
        lay = tile_conv.self_layout(pts, mask, radius, max_pairs=tile_pairs_whole)
        got = tile_conv.tile_kde_sums_cuda(lay, radius)
        again = tile_conv.tile_kde_sums_cuda(lay, radius)
        want = tile_conv.tile_kde_sums_reference(lay, radius)
        torch.cuda.synchronize()
        require(bool(torch.equal(got, again)), f"K7 differs between two calls at r={radius}")
        e = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30))[lay.valid].max())
        require(bool(torch.allclose(got, want, rtol=TILE_RTOL, atol=0.0)),
                f"K7 disagrees with its plain version at r={radius}")
        k_ms = time_ms(lambda: tile_conv.tile_kde_sums_cuda(lay, radius))
        p_ms = time_ms(lambda: tile_conv.tile_kde_sums_reference(lay, radius), iters=2)
        pairs = inr_pairs(lay.pts, lay.valid, lay.pts, lay.valid, radius)
        b_ms, by = bound(SEG_CAP * (12 + 1 + 4), 12 * pairs)
        real, inert = tile_conv.real_steps(lay.steps)
        print(f"K7 B=1 N={SEG_CAP} (valid {int(mask.sum())}) r={radius} Tm={lay.steps.Tm} "
              f"S={lay.S} (real steps {int(real.sum())}, inert {int(inert.sum())}): "
              f"max_abs_err={e:.3e} max_rel_err={rel:.3e} bitwise_repeatable=True "
              f"in_radius_pairs={pairs} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={b_ms:.6f} ({by})", flush=True)
        err, ms, pms, bms = max(err, e), ms + k_ms, pms + p_ms, bms + b_ms
    bp, bm = block
    for radius in (SEG_RADII[0], SEG_RADII[0] * 2.0):
        tile = tile_conv.tile_kde(bp, bm, radius, max_pairs=1 << 30)
        dense = density_kernel.kde_density_cuda(bp, bm, radius)
        torch.cuda.synchronize()
        rel = float(((tile - dense).abs() / dense).max())
        print(f"K7 vs K4 B={bp.shape[0]} N={bp.shape[1]} r={radius}: max_rel_err={rel:.3e}",
              flush=True)
        require(bool(torch.allclose(tile, dense, rtol=TILE_RTOL, atol=0.0)),
                f"K7 and K4 disagree at N={bp.shape[1]}, r={radius}")
    return (err, ms, pms, bms, by, None)


def tile_fwd_bytes(smp, src, c, co) -> int:
    """The bytes K5's function must move: each input and output byte once."""
    b, M, N = smp.shape[0], smp.shape[1], src.shape[1]
    CO = c if co is None else co
    return (4 * (b * M * 3 + b * N * 3 + b * N * c + 4 * H + H * c * (co or 1) + c * (co or 1)
                 + b * M * CO + b * M) + b * (M + N))


def tile_fwd_bound(smp, qmask, src, c, co, pairs) -> tuple[float, str]:
    """K5's least time (K5p's too): each input and output byte once, and the
    fp32 operations of the in-radius pairs (and the full conv's projection)."""
    H1 = H + 1
    nbytes = tile_fwd_bytes(smp, src, c, co)
    flops = pairs * (8 + 6 + 6 * H + 2 * H1 * c)
    if co is not None:
        flops += 2 * int(qmask.sum()) * H1 * c * co
    return bound(nbytes, flops)


def tile_bwd_bound(smp, qmask, src, smask, c, co, pairs) -> tuple[float, str]:
    """K6's least time (K6p's and K6v1's too: the same gradients of the same
    pairs)."""
    b, M, N = smp.shape[0], smp.shape[1], src.shape[1]
    CO, H1 = (c if co is None else co), H + 1
    vq, vp = int(qmask.sum()), int(smask.sum())
    nw = H * c * (co or 1) + c * (co or 1) + 4 * H
    nbytes = (4 * (b * M * 3 + b * N * 3 + 2 * b * N * c + b * M * CO + b * M + 2 * nw)
              + b * (M + N))
    # per in-radius pair: d2, offsets, H pre-activations, dpre's H x C and
    # dW1 / db1; depthwise, X's (H+1) x C FMAs and X's projections; full (the
    # stem), what the gradient needs: d_f~ = sum_h a_h dG and G = sum_p a_h f~
    # over (H+1) x C, and the GEMMs dG = t Wcat and dWcat = t^T G
    flops = pairs * (8 + 6 + 6 * H + 2 * H * c + 8 * H)
    flops += (pairs * 2 * H1 * CO + 4 * vp * H1 * c + vq * H * c if co is None else
              pairs * 4 * H1 * c + 4 * vq * H1 * c * CO)
    return bound(nbytes, flops)


def check_tile_conv(dev, hier, tile_pairs) -> tuple:
    """K5 at the four tile sites of the block batch's MCSeg: each site's call
    and device times (``tools.device_ms``), its valid candidate and
    in-radius pairs and the most in-radius sources of a sample."""
    from mccnn_tpu_torch.ops.cuda import density_kernel, tile_conv
    from mccnn_tpu_torch.tools import device_ms

    gen = torch.Generator().manual_seed(SEED + 7)
    err = ms = pms = bms = 0.0
    by = "operations"
    with torch.no_grad():
        for name, i, o, radius, c, co in SEG_SITES:
            (src, smask), (smp, qmask) = hier[i], hier[o]
            b, M, N = smp.shape[0], smp.shape[1], src.shape[1]
            params = site_params(gen, c, co, dev)
            feats = (torch.ones((b, N, 1)) if c == 1 else
                     torch.randn((b, N, c), generator=gen)).to(dev)
            pdf = density_kernel.kde_density_reference(src, smask, radius)
            max_pairs = tile_pairs if 0 in (i, o) else 1 << 30
            lay = tile_conv.conv_layout(smp, qmask, src, smask, radius, max_pairs=max_pairs)
            wf = tile_conv._sorted_weighted_features(lay, feats, pdf)
            kw = dict(c_out=co)
            got, gcnt = tile_conv.tile_conv_sorted_cuda(params, lay, wf, radius, **kw)
            again, _ = tile_conv.tile_conv_sorted_cuda(params, lay, wf, radius, **kw)
            want, wcnt = tile_conv.tile_conv_sorted_reference(params, lay, wf, radius, **kw)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            scale = float(want.abs().max())
            require(bool(torch.equal(got, again)), f"K5 differs between two calls at {name}")
            require(bool(torch.equal(gcnt, wcnt)), f"K5 neighbour counts differ at {name}")
            require(bool(torch.allclose(got, want, rtol=TILE_RTOL, atol=TILE_RTOL * scale)),
                    f"K5 disagrees with its plain version at {name}")
            require(int(lay.overflow.max()) == 0, f"K5 overflowed at {name}")
            k_ms = time_ms(lambda: tile_conv.tile_conv_sorted_cuda(params, lay, wf, radius, **kw),
                           iters=10)
            d_ms = device_ms(lambda: tile_conv.tile_conv_sorted_cuda(params, lay, wf, radius,
                                                                     **kw), iters=3)
            p_ms = time_ms(lambda: tile_conv.tile_conv_sorted_reference(params, lay, wf, radius,
                                                                        **kw), iters=1)
            pairs = inr_pairs(smp, qmask, src, smask, radius)
            b_ms, by = tile_fwd_bound(smp, qmask, src, c, co, pairs)
            steps = int((lay.steps.j_ids != lay.steps.n_minor).sum())
            print(f"K5 B={b} {name} N={N} M={M} C={c} CO={co}: Tm={lay.steps.Tm} S={lay.S} "
                  f"candidate_minors={steps} candidate_pairs={step_pairs(lay)} "
                  f"in_radius_pairs={pairs} max_in_radius_a_sample={int(wcnt.max())} "
                  f"max_abs_err={e:.3e} max_abs_out={scale:.3e} "
                  f"bitwise_repeatable=True kernel_ms={k_ms:.4f} device_ms={d_ms:.4f} "
                  f"plain_ms={p_ms:.4f} bound_ms={b_ms:.6f} ({by})", flush=True)
            err, ms, pms, bms = max(err, e), ms + k_ms, pms + p_ms, bms + b_ms
    return (err, ms, pms, bms, by, None)


def check_tile_backward(dev, hier, tile_pairs) -> tuple:
    """K6 at the four tile sites of the block batch's MCSeg, with a seeded dout:
    each site's call and device times (``tools.device_ms``), its candidate
    and in-radius pairs."""
    from mccnn_tpu_torch.ops.cuda import density_kernel, tile_conv
    from mccnn_tpu_torch.tools import device_ms

    gen = torch.Generator().manual_seed(SEED + 11)
    names = ("d_wf", "dw1", "db1", "dw2", "db2")
    err = ms = pms = bms = 0.0
    by = "operations"
    with torch.no_grad():
        for name, i, o, radius, c, co in SEG_SITES:
            (src, smask), (smp, qmask) = hier[i], hier[o]
            b, M, N = smp.shape[0], smp.shape[1], src.shape[1]
            CO = c if co is None else co
            params = site_params(gen, c, co, dev)
            feats = (torch.ones((b, N, 1)) if c == 1 else
                     torch.randn((b, N, c), generator=gen)).to(dev)
            pdf = density_kernel.kde_density_reference(src, smask, radius)
            max_pairs = tile_pairs if 0 in (i, o) else 1 << 30
            lay = tile_conv.conv_layout(smp, qmask, src, smask, radius, max_pairs=max_pairs,
                                        backward=True)
            wf = tile_conv._sorted_weighted_features(lay, feats, pdf)
            _, cnt = tile_conv.tile_conv_sorted_cuda(params, lay, wf, radius, c_out=co)
            dout = torch.randn((b, lay.smp.shape[1], CO), generator=gen).to(dev)
            args = (params, lay, wf, radius, cnt, dout)
            got = tile_conv.tile_conv_backward_sorted_cuda(*args, c_out=co)
            again = tile_conv.tile_conv_backward_sorted_cuda(*args, c_out=co)
            want = tile_conv.tile_conv_backward_sorted_reference(*args, c_out=co)
            torch.cuda.synchronize()
            require(int(lay.overflow.max()) == 0, f"K6 overflowed at {name}")
            parts, e_site = [], 0.0
            for gname, a, a2, w in zip(names, got, again, want):
                require(tuple(a.shape) == tuple(w.shape), f"K6 {gname} shape {tuple(a.shape)}")
                require(bool(torch.equal(a, a2)), f"K6 {gname} differs between two calls at {name}")
                scale = float(w.abs().max())
                e = float((a - w).abs().max())
                e_site = max(e_site, e)
                parts.append(f"{gname} {e:.3e}/{scale:.3e}")
                require(bool(torch.allclose(a, w, rtol=TILE_BWD_RTOL, atol=TILE_BWD_RTOL * scale)),
                        f"K6 {gname} disagrees with its plain version at {name}")
            k_ms = time_ms(lambda: tile_conv.tile_conv_backward_sorted_cuda(*args, c_out=co),
                           iters=5)
            d_ms = device_ms(lambda: tile_conv.tile_conv_backward_sorted_cuda(*args, c_out=co),
                             iters=3)
            p_ms = time_ms(lambda: tile_conv.tile_conv_backward_sorted_reference(*args, c_out=co),
                           iters=1)
            pairs = inr_pairs(smp, qmask, src, smask, radius)
            b_ms, by = tile_bwd_bound(smp, qmask, src, smask, c, co, pairs)
            steps = int((lay.steps_b.j_ids != lay.steps_b.n_minor).sum())
            # a candidate minor pairs its Tm samples with the source tile's T
            cand = steps * lay.steps_b.Tm * tile_conv.DEFAULT_TILE
            print(f"K6 B={b} {name} N={N} M={M} C={c} CO={co}: Tm={lay.steps.Tm} S={lay.S} "
                  f"candidate_minors={steps} candidate_pairs={cand} in_radius_pairs={pairs} "
                  f"max_abs_err (err/scale) {', '.join(parts)}; bitwise_repeatable=True "
                  f"kernel_ms={k_ms:.4f} device_ms={d_ms:.4f} plain_ms={p_ms:.4f} "
                  f"bound_ms={b_ms:.6f} ({by})", flush=True)
            err, ms, pms, bms = max(err, e_site), ms + k_ms, pms + p_ms, bms + b_ms
    return (err, ms, pms, bms, by, None)


def check_tile_switch_kernels(dev, hier, tile_pairs) -> dict:
    """K5p and K6p bit-equal to K5 and K6, and K6v1 against its plain version
    and K6, at the four tile sites of the block batch with a seeded dout; the
    kernels' and plain versions' times and the bounds (K5p's is K5's, K6p's
    and K6v1's K6's)."""
    from mccnn_tpu_torch.ops.cuda import density_kernel, tile_conv

    gen = torch.Generator().manual_seed(SEED + 13)
    names = ("d_wf", "dw1", "db1", "dw2", "db2")
    rows = {kid: [0.0, 0.0, 0.0, 0.0, "operations"] for kid in TILE_SWITCH_KERNELS}

    def add(kid, err, k_ms, p_ms, b):
        r = rows[kid]
        r[0], r[1], r[2], r[3], r[4] = max(r[0], err), r[1] + k_ms, r[2] + p_ms, r[3] + b[0], b[1]

    for name, i, o, radius, c, co in SEG_SITES:
        (src, smask), (smp, qmask) = hier[i], hier[o]
        b, N = smp.shape[0], src.shape[1]
        CO = c if co is None else co
        params = site_params(gen, c, co, dev)
        feats = (torch.ones((b, N, 1)) if c == 1 else
                 torch.randn((b, N, c), generator=gen)).to(dev)
        with torch.no_grad():
            pdf = density_kernel.kde_density_reference(src, smask, radius)
            max_pairs = tile_pairs if 0 in (i, o) else 1 << 30
            lay = tile_conv.conv_layout(smp, qmask, src, smask, radius, max_pairs=max_pairs,
                                        backward=True)
            require(int(lay.overflow.max()) == 0, f"the layout overflowed at {name}")
            wf = tile_conv._sorted_weighted_features(lay, feats, pdf)
            kw = dict(c_out=co)
            k5 = tile_conv.tile_conv_sorted_cuda(params, lay, wf, radius, **kw)
            k5p = tile_conv.tile_conv_sorted_packed_cuda(params, lay, wf, radius, **kw)
            k5p_plain = tile_conv.tile_conv_sorted_packed_reference(params, lay, wf, radius, **kw)
            dout = torch.randn((b, lay.smp.shape[1], CO), generator=gen).to(dev)
            args = (params, lay, wf, radius, k5[1], dout)
            k6 = tile_conv.tile_conv_backward_sorted_cuda(*args, **kw)
            k6p = tile_conv.tile_conv_backward_sorted_packed_cuda(*args, **kw)
            k6p_plain = tile_conv.tile_conv_backward_sorted_packed_reference(*args, **kw)
            v1 = tile_conv.tile_conv_backward_v1_sorted_cuda(*args, **kw)
            v1_again = tile_conv.tile_conv_backward_v1_sorted_cuda(*args, **kw)
            v1_plain = tile_conv.tile_conv_backward_v1_sorted_reference(*args, **kw)
            torch.cuda.synchronize()
        require(bool(torch.equal(k5p[0], k5[0]) and torch.equal(k5p[1], k5[1])),
                f"K5p differs from K5 at {name}")
        scale = float(k5p_plain[0].abs().max())
        e5p = float((k5p[0] - k5p_plain[0]).abs().max())
        require(e5p <= TILE_RTOL * scale, f"K5p disagrees with its plain version at {name}")
        e6p = e1 = 0.0
        parts = []
        for gname, a6p, w6p, a6, a1, a1b, w1 in zip(names, k6p, k6p_plain, k6, v1, v1_again,
                                                    v1_plain):
            require(bool(torch.equal(a6p, a6)), f"K6p {gname} differs from K6 at {name}")
            sc = float(w6p.abs().max())
            e6p = max(e6p, float((a6p - w6p).abs().max()))
            require(bool(torch.allclose(a6p, w6p, rtol=TILE_BWD_RTOL, atol=TILE_BWD_RTOL * sc)),
                    f"K6p {gname} disagrees with its plain version at {name}")
            require(bool(torch.equal(a1, a1b)), f"K6v1 {gname} differs between two calls at {name}")
            for ref, what in ((w1, "its plain version"), (a6, "K6")):
                sc = float(ref.abs().max())
                e = float((a1 - ref).abs().max())
                require(sc > 0 and e <= TILE_V1_RTOL * sc,
                        f"K6v1 {gname} disagrees with {what} at {name}: {e:.3e} of {sc:.3e}")
            e = float((a1 - w1).abs().max())
            e1 = max(e1, e)
            parts.append(f"{gname} {e:.3e}/{float((a1 - a6).abs().max()):.3e}/"
                         f"{float(w1.abs().max()):.3e}")
        pairs = inr_pairs(smp, qmask, src, smask, radius)
        fb = tile_fwd_bound(smp, qmask, src, c, co, pairs)
        bb = tile_bwd_bound(smp, qmask, src, smask, c, co, pairs)
        t = {"K5p": (time_ms(lambda: tile_conv.tile_conv_sorted_packed_cuda(params, lay, wf,
                                                                             radius, **kw),
                             iters=10),
                     time_ms(lambda: tile_conv.tile_conv_sorted_packed_reference(
                         params, lay, wf, radius, **kw), iters=1)),
             "K6p": (time_ms(lambda: tile_conv.tile_conv_backward_sorted_packed_cuda(*args, **kw),
                             iters=5),
                     time_ms(lambda: tile_conv.tile_conv_backward_sorted_packed_reference(
                         *args, **kw), iters=1)),
             "K6v1": (time_ms(lambda: tile_conv.tile_conv_backward_v1_sorted_cuda(*args, **kw),
                              iters=3),
                      time_ms(lambda: tile_conv.tile_conv_backward_v1_sorted_reference(
                          *args, **kw), iters=1))}
        add("K5p", e5p, *t["K5p"], fb)
        add("K6p", e6p, *t["K6p"], bb)
        add("K6v1", e1, *t["K6v1"], bb)
        print(f"K5p / K6p / K6v1 B={b} {name} N={N} M={smp.shape[1]} C={c} CO={co}: "
              f"Tm={lay.steps.Tm} S={lay.S} K5p_bit_equal_to_K5=True K6p_bit_equal_to_K6=True "
              f"K5p_max_abs_err={e5p:.3e} K6p_max_abs_err={e6p:.3e} K6v1 max_abs_err "
              f"(plain/K6/scale) {', '.join(parts)}; K6v1_bitwise_repeatable=True "
              + " ".join(f"{k}_ms={v[0]:.4f} {k}_plain_ms={v[1]:.4f}" for k, v in t.items())
              + f" fwd_bound_ms={fb[0]:.6f} bwd_bound_ms={bb[0]:.6f}", flush=True)
    return {kid: (*r[:4], r[4], None) for kid, r in rows.items()}


def check_tile_minors(dev, hier, block) -> None:
    """K5 and K6 at every minor size of TILE_MINORS at the four tile sites,
    and K8 (the 27 colours of the level-0 sweep) and K7 (the whole scene) at
    SWEEP_MINORS, each against its plain version at the default minor's
    tolerances and timed, with the capacity ``auto_tile_pairs`` sizes under
    that minor; the hierarchy is the default minor's (the tile sampler's
    selection does not depend on it)."""
    from mccnn_tpu_torch.ops.cuda import tile_conv
    from mccnn_tpu_torch.tools.dense_ab import whole_scene

    pts, mask = block
    wpts, wmask = (torch.from_numpy(a).to(dev) for a in whole_scene(SEED + 6))
    default = tile_conv._MINOR
    try:
        for m in TILE_MINORS:
            tile_conv._MINOR = str(m)
            tile_pairs = tile_conv.auto_tile_pairs(pts, mask, 2 * SEG_RADII[0])
            print(f"minor Tm={m}: block tile_pairs={tile_pairs}", flush=True)
            with torch.no_grad():
                check_tile_conv(dev, hier, tile_pairs)
            check_tile_backward(dev, hier, tile_pairs)
            if m in SWEEP_MINORS:
                whole_pairs = tile_conv.auto_tile_pairs(wpts, wmask, 2 * SEG_RADII[0])
                with torch.no_grad():
                    check_cover_sweep(dev, pts, mask, tile_pairs, timed=False)
                    check_tile_kde(dev, whole_pairs, block)
    finally:
        tile_conv._MINOR = default


def check_tile_kernels(dev) -> dict:
    """K8, K7, K5 and K6 against their plain versions at the ScanNet shapes,
    then the tile switches' kernels (K5p, K6p, K6v1), K5-K8 at the other
    minor sizes and the K5 / K6 probes."""
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy
    from mccnn_tpu_torch.ops.cuda.tile_conv import auto_tile_pairs
    from mccnn_tpu_torch.tools.dense_ab import whole_scene

    batch = scene_batch(SEED + 5, SEG_B)
    pts, mask = (torch.from_numpy(batch[k]).to(dev) for k in ("points", "mask"))
    tile_pairs = auto_tile_pairs(pts, mask, 2 * SEG_RADII[0])
    wpts, wmask = (torch.from_numpy(a).to(dev) for a in whole_scene(SEED + 6))
    tile_pairs_whole = auto_tile_pairs(wpts, wmask, 2 * SEG_RADII[0])
    print(f"tile capacities: block B={SEG_B} N={SEG_N} tile_pairs={tile_pairs}; whole scene "
          f"N={SEG_CAP} tile_pairs={tile_pairs_whole}", flush=True)
    with torch.no_grad():
        results = {"K8": check_cover_sweep(dev, pts, mask, tile_pairs)}
        results["K7"] = check_tile_kde(dev, tile_pairs_whole, (pts, mask))
        hier = build_hierarchy(pts, mask, SEG_RADII, tile_pairs=tile_pairs)
        lv = [(l.points, l.mask) for l in hier.levels]
        print("MCSeg levels:", [tuple(p.shape[:2]) for p, _ in lv], "valid per cloud:",
              [int(m.sum(1).min()) for _, m in lv], flush=True)
        results["K4 ScanNet"] = check_kde_levels(dev, lv)
        results["K5"] = check_tile_conv(dev, lv, tile_pairs)
    results["K6"] = check_tile_backward(dev, lv, tile_pairs)
    results |= check_tile_switch_kernels(dev, lv, tile_pairs)
    check_tile_minors(dev, lv, (pts, mask))
    results |= check_tile_probes(dev, lv, tile_pairs)
    return results


def check_mcseg(dev) -> None:
    """MCSeg at the ScanNet defaults on the card against the CPU plain path, and
    the card's block hierarchy against the CPU's."""
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy
    from mccnn_tpu_torch.models import MCSeg
    from mccnn_tpu_torch.tasks.common import maybe_auto_tile_pairs

    rng = np.random.default_rng(SEED + 8)
    blocks = scene_batch(SEED + 8, SEG_B)
    model = MCSeg(SEG_CLASSES, grow=SEG_GROW, radii=SEG_RADII,
                  generator=torch.Generator().manual_seed(SEED)).to(dev)
    maybe_auto_tile_pairs(model, blocks, dev)
    with torch.inference_mode():
        h_gpu = build_hierarchy(*(torch.from_numpy(blocks[k]).to(dev) for k in ("points", "mask")),
                                SEG_RADII, tile_pairs=model.tile_pairs, tile_steps=model.tile_steps)
        t0 = time.perf_counter()
        h_cpu = build_hierarchy(*(torch.from_numpy(blocks[k]) for k in ("points", "mask")),
                                SEG_RADII, tile_pairs=model.tile_pairs, tile_steps=model.tile_steps)
        cpu_s = time.perf_counter() - t0
    same = all(torch.equal(a.sample.idx.cpu(), c.sample.idx) and torch.equal(a.mask.cpu(), c.mask)
               for a, c in zip(h_gpu.levels[1:], h_cpu.levels[1:]))
    print(f"MCSeg block hierarchy B={SEG_B} N={SEG_N}: equal_to_cpu={same} "
          f"valid per level={[int(l.mask.sum()) for l in h_gpu.levels]} cpu_s={cpu_s:.1f}",
          flush=True)
    require(same, "the card's block hierarchy differs from the CPU plain path's")

    batch = {k: blocks[k][:SEG_CPU_B] for k in ("points", "mask")}
    calibrate_bn(model, batch, rng)
    cpu_model = copy.deepcopy(model).cpu()
    args = [torch.from_numpy(batch[k]) for k in ("points", "mask")]
    with torch.inference_mode():
        got, ovf = model(*(a.to(dev) for a in args), with_overflow=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, cpu_ovf = cpu_model(*args, with_overflow=True)
        cpu_s = time.perf_counter() - t0
    got = got.cpu()
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    print(f"MCSeg B={SEG_CPU_B} N={SEG_N} grow={SEG_GROW} card vs CPU plain path: "
          f"logits={tuple(got.shape)} max_abs_err={err:.3e} max_abs_logit={top:.3e} "
          f"overflow card={int(ovf)} cpu={int(cpu_ovf)} cpu_forward_s={cpu_s:.1f}", flush=True)
    require(bool(torch.isfinite(got).all()), "non-finite MCSeg logits")
    require(int(ovf) == 0 and int(cpu_ovf) == 0, "MCSeg overflowed its auto-sized capacities")
    require(bool(torch.allclose(got, want, rtol=SEG_LOGIT_RTOL, atol=SEG_LOGIT_RTOL * top)),
            "MCSeg logits on the card disagree with the CPU plain path")


def check_mcseg_train_step(dev, bucket: bool = False) -> None:
    """One MCSeg train step (ScanNet defaults, dropout 0) on the card against
    the same step on the CPU plain path, at B=2 x 8192: on the tile path
    (auto-sized capacity), or with ``bucket`` on the capacity-free bucket path,
    through ``gated_train_step``."""
    from mccnn_tpu_torch.models import MCSeg
    from mccnn_tpu_torch.tasks.common import maybe_auto_tile_pairs
    from mccnn_tpu_torch.train import segmentation_loss

    rng = np.random.default_rng(SEED + 10)
    blocks = scene_batch(SEED + 10, SEG_CPU_B)
    batch = {k: blocks[k] for k in ("points", "mask", "labels")}
    model = MCSeg(SEG_CLASSES, grow=SEG_GROW, radii=SEG_RADII, drop_rate=0.0,
                  generator=torch.Generator().manual_seed(SEED)).to(dev)
    if not bucket:
        maybe_auto_tile_pairs(model, batch, dev)
    calibrate_bn(model, batch, rng)

    def loss_fn(out, b):
        return segmentation_loss(out, b["labels"], b["mask"]), {}

    what = f"MCSeg {'bucket ' if bucket else ''}train step B={SEG_CPU_B} N={SEG_N} grow={SEG_GROW}"
    card, cpu, launches = gated_train_step(
        what, model, dev, batch, loss_fn,
        lambda n: n.startswith("mixes.") and n.endswith(".bias"), SEG_ZERO_GRAD_RTOL)
    path = ("K9", "K10") if bucket else ("K5", "K6")
    if bucket:
        require(launches["K5"] == launches["K6"] == launches["K8"] == 0,
                "a tile kernel was launched in the MCSeg bucket train step")
    else:
        for name, out in (("card", card), ("cpu", cpu)):
            require(int(out[4]["tile_overflow"]) == 0, f"the MCSeg train step overflowed ({name})")
    for name in path:
        require(launches[name] > 0, f"{name} was not launched in the MCSeg train step")


def gated_train_step(what: str, model, dev, batch: dict, loss_fn, zero_grad,
                     zero_rtol: float) -> tuple:
    """One train step of ``model`` on the card against the same step on the
    CPU plain path; returns ``(card, cpu, launches)`` (``train_one_step``'s
    tuples and the card step's launch counts).

    A BN output within rounding of 0 can fall on the other side of its ReLU
    on the two devices (forward values differ by ~1e-6 after a few convs),
    and each such flip moves its channel's BN gradients by one point's term,
    a few 1e-3 of their largest value at 4M values a layer. So the CPU step
    takes the card's ReLU decisions, and the check requires each one it takes
    to lie within rounding (``FLIP_SHARE``, ``FLIP_VALUE_RTOL``); the unforced
    step's worst gradient is printed beside it."""
    from mccnn_tpu_torch.models.layers import BatchNormReluDropout

    cpu_model, cpu_forced = copy.deepcopy(model).cpu(), copy.deepcopy(model).cpu()
    card_on, hooks = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNormReluDropout):
            hooks.append(mod.bn.register_forward_hook(
                lambda m, inp, out, name=name: card_on.__setitem__(name, (out > 0).cpu())))
    reset_counts()
    card = train_one_step(model, dev, batch, loss_fn)
    torch.cuda.synchronize()
    launches = read_counts()
    for h in hooks:
        h.remove()
    flips = {}
    for name, mod in cpu_forced.named_modules():
        if isinstance(mod, BatchNormReluDropout):
            def forced(x, mask, mod=mod, name=name):
                y = mod.bn(x, mask)
                yv, flip = y.detach()[mask].abs(), ((y > 0) != card_on[name])[mask]
                # (flips, active, largest flipped |y| / largest |y|)
                flips[name] = (int(flip.sum()), int(card_on[name][mask].sum()),
                               float(torch.where(flip, yv, 0.0).max() / yv.max()))
                y = torch.where(card_on[name], y, 0.0)  # relu with the card's decisions
                return torch.where(mask[..., None], mod.dropout(y), 0.0)

            mod.forward = forced
    cpu = train_one_step(cpu_forced, "cpu", batch, loss_fn)
    free = train_one_step(cpu_model, "cpu", batch, loss_fn)
    unforced = max((float((card[1][n] - w).abs().max()) / max(float(w.abs().max()), 1e-30), n)
                   for n, w in free[1].items() if not zero_grad(n))
    n_flips, n_active = (sum(v[k] for v in flips.values()) for k in (0, 1))
    worst_flip = max(v[2] for v in flips.values())
    print(f"{what}: ReLU decisions that differ between the card and the CPU plain "
          f"path: {n_flips} of {n_active} active ({ {k: v[0] for k, v in flips.items() if v[0]} });"
          f" largest flipped |value| {worst_flip:.3e} of its BN's largest; without the card's "
          f"decisions the worst gradient is {unforced[0]:.3e} of its largest value "
          f"({unforced[1]}) and the loss {abs(free[0] - card[0]) / abs(free[0]):.3e} relative",
          flush=True)
    require(n_flips <= FLIP_SHARE * n_active,
            f"{what}: {n_flips} BN-ReLU decisions differ between the card and the CPU "
            f"plain path, more than {FLIP_SHARE:g} of {n_active} active values")
    require(worst_flip <= FLIP_VALUE_RTOL,
            f"{what}: a BN-ReLU decision differs at a value {worst_flip:.3e} of its "
            f"BN's largest, beyond rounding ({FLIP_VALUE_RTOL:g})")
    compare_train_steps(what, card, cpu, zero_grad, zero_rtol)
    return card, cpu, launches


def profile_forward(forward, what: str, reps: int = 3, train: bool = False) -> float:
    """``reps`` eval forwards (``forward()``) under torch.profiler, after one
    warm-up: wall and device time a forward, the device's busy share, the
    device events a forward and the kernels that take the most device time.
    With ``train``, ``forward()`` is a train step, run with autograd on.
    Returns the busy share."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with contextlib.nullcontext() if train else torch.inference_mode():
        forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                forward()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3 / reps
    events = sum(e.count for e in device) / reps
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile {what}: wall_ms={wall_ms:.3f} device_ms={device_ms:.3f} "
          f"busy_share={device_ms / wall_ms:.4f} device_events={events:.0f} top: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / reps:.3f} ms"
                      for e in top), flush=True)
    return device_ms / wall_ms


def profile_mcseg(dev) -> None:
    """Where a block batch's and a whole scene's forward spend their time."""
    from mccnn_tpu_torch.models import MCSeg
    from mccnn_tpu_torch.tasks.common import auto_tile_steps, maybe_auto_tile_pairs
    from mccnn_tpu_torch.ops.cuda.tile_conv import auto_tile_pairs
    from mccnn_tpu_torch.tools.dense_ab import whole_scene

    blocks = scene_batch(SEED + 9, SEG_B)
    model = MCSeg(SEG_CLASSES, grow=SEG_GROW, radii=SEG_RADII,
                  generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    maybe_auto_tile_pairs(model, blocks, dev)
    pts, mask = (torch.from_numpy(blocks[k]).to(dev) for k in ("points", "mask"))
    profile_forward(lambda: model(pts, mask, with_overflow=True),
                    f"block batch B={SEG_B} N={SEG_N}")
    wpts, wmask = (torch.from_numpy(a).to(dev) for a in whole_scene(SEED + 9))
    model.tile_pairs = auto_tile_pairs(wpts, wmask, 2 * SEG_RADII[0])
    model.tile_steps = auto_tile_steps(model, wpts, wmask)
    profile_forward(lambda: model(wpts, wmask, with_overflow=True),
                    f"whole scene N={SEG_CAP} (valid {int(wmask.sum())})")


def profile_mcseg_train(dev) -> None:
    """Where an MCSeg train step on the tile path spends its time (B=8 x
    8192, the capacity sized for the batch, as the trainer's first step)."""
    from mccnn_tpu_torch.models import MCSeg
    from mccnn_tpu_torch.tasks.common import maybe_auto_tile_pairs
    from mccnn_tpu_torch.train import (batch_to_device, init_state, make_optimizer,
                                       make_train_step, segmentation_loss)

    blocks = scene_batch(SEED + 16, SEG_B)
    batch = {k: blocks[k] for k in ("points", "mask", "labels")}
    model = MCSeg(SEG_CLASSES, grow=SEG_GROW, radii=SEG_RADII,
                  generator=torch.Generator().manual_seed(SEED)).to(dev)
    maybe_auto_tile_pairs(model, batch, dev)
    opt = make_optimizer(model.parameters())
    init_state(model, opt, SEED)
    step = make_train_step(model, opt, lambda out, b: (
        segmentation_loss(out, b["labels"], b["mask"]), {}))
    on_dev = batch_to_device(batch, dev)
    profile_forward(lambda: step(on_dev), f"tile train step B={SEG_B} N={SEG_N}", train=True)


def run_scannet(whole: bool) -> dict:
    """``tasks.scannet`` through its entry point: block evaluation at B=8 x
    8192, or one pass per whole scene at the 40960 cap."""
    from mccnn_tpu_torch.tasks import scannet

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--eval-only", "--batch", str(SEG_B), "--points", str(SEG_N),
                "--device", "cuda", "--log-dir", tmp, "--ckpt-dir", os.path.join(tmp, "ck")]
        if whole:
            argv += ["--whole-scene-cap", str(SEG_CAP)]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = scannet.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(tmp, "scannet_mcseg.metrics.jsonl")) as f:
            resizes = [json.loads(line) for line in f if '"resize"' in line]
    kind = "whole scenes" if whole else "blocks"
    lat = res["scene_ms_all"] if whole else res["batch_ms_all"]
    print(f"scannet eval ({kind}): point_accuracy={res['point_accuracy']:.4f} "
          f"mIoU={res['mIoU']:.4f} latencies_ms={[round(x, 3) for x in lat]} "
          f"resizes={len(resizes)} total_sec={seconds:.2f} launches={launches}", flush=True)
    path = ("K1", "K3", "K4", "K5", "K7", "K8") if whole else ("K1", "K3", "K4", "K5", "K8")
    for name in path:
        require(launches[name] > 0, f"{name} was not launched in ScanNet eval ({kind})")
    require(launches["K2"] == 0 and launches["K6"] == 0, "a backward was launched in evaluation")
    return launches


def run_scannet_train() -> dict:
    """``tasks.scannet`` training through its entry point at the CLI's
    defaults (B=8 x 8192), with a tile capacity short enough that a step is
    discarded, re-sized and run again."""
    from mccnn_tpu_torch.tasks import scannet

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--epochs", "1", "--steps-per-epoch", "4", "--tile-pairs", "32",
                "--device", "cuda", "--log-dir", tmp, "--ckpt-dir", os.path.join(tmp, "ck")]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = scannet.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(tmp, "scannet_mcseg.metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["tag"] == "train"]
    resizes = [r for r in recs if r["tag"] == "resize" and "phase" not in r]
    require(len(train) == 1 and train[0]["steps"] == 4, f"scannet trainer records: {recs}")
    rec = train[0]
    print(f"scannet trainer (tasks.scannet, B={SEG_B}, N={SEG_N}, grow={SEG_GROW}, "
          f"--tile-pairs 32): loss={rec['loss']:.6f} acc={rec['acc']:.4f} steps={rec['steps']} "
          f"train_resizes={len(resizes)} capacity_resizes={rec.get('capacity_resizes')} "
          f"tile_pairs={[(r['tile_pairs_old'], r['tile_pairs']) for r in resizes]} "
          f"epoch_sec={rec['sec']} warm_step_ms={rec['warm_step_ms']:.3f} "
          f"best_mIoU={res['best_mIoU']:.4f} total_sec={seconds:.2f} launches={launches}",
          flush=True)
    require(bool(np.isfinite(rec["loss"])), "the scannet trainer's loss is not finite")
    require(len(resizes) >= 1 and rec.get("capacity_resizes") == len(resizes),
            "the scannet trainer did not re-size its tile capacity")
    for name in ("K1", "K2", "K3", "K4", "K5", "K6", "K8"):
        require(launches[name] > 0, f"{name} was not launched in ScanNet training")
    return launches


_TILE_CHILD = r"""
import json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from mccnn_tpu_torch.ops.cuda import tile_conv
from mccnn_tpu_torch.tasks import scannet
with tempfile.TemporaryDirectory() as tmp:
    res = scannet.main(["--synthetic", "--epochs", "1", "--steps-per-epoch", "%d", "--device",
                        "cuda", "--log-dir", tmp, "--ckpt-dir", tmp + "/ck"] + %r)
    with open(tmp + "/scannet_mcseg.metrics.jsonl") as f:
        recs = [json.loads(l) for l in f]
train = [r for r in recs if r["tag"] == "train"]
ev = [r for r in recs if r["tag"] == "eval"]
print("TILE_COUNTS " + json.dumps({
    "launches": chip_smoke.read_counts(), "minor": tile_conv.tile_minor(),
    "order": tile_conv._ORDER, "adj": tile_conv._ADJ, "pack": tile_conv._PACK,
    "v1": tile_conv._BWD_V1, "loss": train[0]["loss"], "steps": train[0]["steps"],
    "warm_step_ms": train[0].get("warm_step_ms"),
    "eval": {k: ev[-1].get(k) for k in ("point_accuracy", "mIoU", "scene_ms_all")} if ev else None,
    "best_mIoU": res["best_mIoU"]}))
"""


def run_tile_switch_trainers() -> dict:
    """``tasks.scannet`` training at the CLI's defaults (B = 8 x 8192, then its
    evaluation) with no switch and under each of TILE_SWITCH_CHILDREN's
    environments, each in a child process: its printed counters must show
    the switch's kernels launched and the defaults they replace not; a failed
    child fails the script."""
    out = {}
    base = {k: v for k, v in os.environ.items() if not k.startswith("MCCNN_TILE_")}
    for name, (env_vars, extra, launched, silent) in TILE_SWITCH_CHILDREN.items():
        what = " ".join(f"{k}={v}" for k, v in env_vars.items())
        code = _TILE_CHILD % (TILE_CHILD_STEPS, list(extra))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], env=dict(base, **env_vars),
                              cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                              text=True, timeout=600)
        seconds = time.perf_counter() - t0
        require(proc.returncode == 0, f"the {what} scannet trainer failed ({proc.returncode}): "
                f"{proc.stderr[-3000:]}")
        line = [x for x in proc.stdout.splitlines() if x.startswith("TILE_COUNTS ")]
        require(len(line) == 1, f"the {what} scannet trainer printed no counters: "
                f"{proc.stdout[-2000:]}")
        res = json.loads(line[0][len("TILE_COUNTS "):])
        counts = res["launches"]
        print(f"scannet trainer under {what} (child process, tasks.scannet {' '.join(extra)}, "
              f"B={SEG_B}, N={SEG_N}, {TILE_CHILD_STEPS} steps and one eval): {res} "
              f"child_sec={seconds:.2f}", flush=True)
        require(res["steps"] == TILE_CHILD_STEPS and bool(np.isfinite(res["loss"])),
                f"the {what} scannet trainer's loss or steps")
        require(res["minor"] == int(env_vars.get("MCCNN_TILE_MINOR", 32))
                and res["order"] == env_vars.get("MCCNN_TILE_ORDER", "")
                and res["adj"] == env_vars.get("MCCNN_TILE_ADJ", "")
                and res["pack"] == ("MCCNN_TILE_PACK" in env_vars)
                and res["v1"] == ("MCCNN_TILE_BWD_V1" in env_vars),
                f"{what} did not reach the module's switches: {res}")
        for kid in launched:
            require(counts[kid] > 0, f"{kid} was not launched under {what}")
        for kid in silent:
            require(counts[kid] == 0, f"{kid} was launched under {what}")
        out[f"scannet_train_{name}"] = counts
    return out


# ------------------------------------------------------------ the bucket path


def bucket_hierarchy(dev):
    """The capacity-free block hierarchy (level 0 sampled through its
    self-neighbour lists, K3 below) on the card against the CPU plain path's,
    then per bucket site the grid overflow of each side and the candidate
    and in-radius pair counts. Returns the card's levels and its cache."""
    from mccnn_tpu_torch.api.builder import SpatialCache
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy
    batch = scene_batch(SEED + 12, SEG_B)
    pts, mask = (torch.from_numpy(batch[k]) for k in ("points", "mask"))
    with torch.inference_mode():
        t0 = time.perf_counter()
        h_gpu = build_hierarchy(pts.to(dev), mask.to(dev), SEG_RADII, neighbor_k=SEG_NEIGHBOR_K)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h_cpu = build_hierarchy(pts, mask, SEG_RADII, neighbor_k=SEG_NEIGHBOR_K)
        cpu_s = time.perf_counter() - t0
    same = all(torch.equal(a.sample.idx.cpu(), c.sample.idx) and torch.equal(a.mask.cpu(), c.mask)
               for a, c in zip(h_gpu.levels[1:], h_cpu.levels[1:]))
    nbh = h_gpu.levels[0].self_nbh
    require(nbh is not None, "level 0 of the capacity-free hierarchy has no neighbour lists")
    print(f"bucket hierarchy B={SEG_B} N={SEG_N} neighbor_k={SEG_NEIGHBOR_K}: "
          f"equal_to_cpu={same} valid per level={[int(l.mask.sum()) for l in h_gpu.levels]} "
          f"level-0 lists truncated (count > k): {int((nbh.count > SEG_NEIGHBOR_K).sum())} of "
          f"{int(mask.sum())}, largest count {int(nbh.count.max())}; card_s={gpu_s:.2f} "
          f"cpu_s={cpu_s:.1f}", flush=True)
    require(same, "the card's bucket hierarchy differs from the CPU plain path's")
    cache = SpatialCache(h_gpu)
    lv = [(l.points, l.mask) for l in h_gpu.levels]
    for site in SEG_SITES:
        bucket_site_stats(lv, cache, site)
    return lv, cache


def window_pairs(gs, gp) -> int:
    """The candidate pairs of a bucket site: each kept sample with every kept
    source of the 27 cells around its cell."""
    from mccnn_tpu_torch.ops.cuda.mcconv_kernel import _OFFSETS, kept_points

    Rp, b = gs.padded_res, gs.slot_of_point.shape[0]
    cell = (gs.slot_of_point // gs.cap).long()
    off = _OFFSETS.to(cell.device)
    near = cell.clamp_max(Rp**3 - 1)[..., None] + (off[:, 0] * Rp + off[:, 1]) * Rp + off[:, 2]
    win = torch.gather(gp.cell_count, 1, near.clamp(0, Rp**3 - 1).reshape(b, -1))
    return int((win.reshape(near.shape).sum(-1) * kept_points(gs)).sum())


def bucket_site_stats(lv, cache, site) -> None:
    """Print a bucket site's grids (R, caps, slots), the overflow of each side
    per cloud, and its candidate and in-radius pair counts."""
    name, i, o, radius, _, _ = site
    gs, gp = cache.buckets(o, radius), cache.buckets(i, radius)
    b, cand = gs.slot_of_point.shape[0], window_pairs(gs, gp)
    (src, smask), (smp, qmask) = lv[i], lv[o]
    print(f"bucket site {name} B={b} r={radius}: R={gs.res} cap sample/source={gs.cap}/{gp.cap} "
          f"slots a cloud sample/source={gs.n_slots}/{gp.n_slots} overflow per cloud "
          f"sample={gs.overflow.tolist()} source={gp.overflow.tolist()} "
          f"candidate_pairs={cand} in_radius_pairs={inr_pairs(smp, qmask, src, smask, radius)}",
          flush=True)


def modelnet_bucket_levels(dev):
    """MCClassS's hierarchy of a B=TRAIN_B x 4096 ModelNet batch, built on the
    card as ``tasks.modelnet --points 4096`` builds it, and its cache."""
    from mccnn_tpu_torch.api.builder import SpatialCache
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy

    req = request(np.random.default_rng(SEED + 17), TRAIN_B, MODELNET_BUCKET_N)
    with torch.inference_mode():
        hier = build_hierarchy(torch.from_numpy(req["points"]).to(dev),
                               torch.from_numpy(req["mask"]).to(dev), (0.1, 0.4),
                               global_level=True)
    cache = SpatialCache(hier)
    lv = [(l.points, l.mask) for l in hier.levels]
    bucket_site_stats(lv, cache, MODELNET_SITE)
    return lv, cache


def bucket_site_inputs(gen, dev, lv, cache, site):
    """A bucket site's parameters, layouts and weighted features f / pdf."""
    from mccnn_tpu_torch.ops.cuda import density_kernel
    from mccnn_tpu_torch.ops.cuda.mcconv_kernel import kept_points

    name, i, o, radius, c, co = site
    src, smask = lv[i]
    gs, gp = cache.buckets(o, radius), cache.buckets(i, radius)
    params = site_params(gen, c, co, dev)
    b, N = src.shape[:2]
    feats = (torch.ones((b, N, 1)) if c == 1 else torch.randn((b, N, c), generator=gen)).to(dev)
    pdf = density_kernel.kde_density_reference(src, smask, radius)
    wf = torch.where(kept_points(gp)[..., None], feats / pdf[..., None], 0.0)
    return params, gs, gp, wf


def bucket_fwd_bound(M: int, N: int, c: int, co, pairs: int, vq: int) -> tuple[float, str]:
    """K9's least time over ``M`` samples (positions read, outputs and counts
    written) and ``N`` sources (positions and features read) of a batch,
    ``pairs`` of them within the radius and ``vq`` samples kept: d2, the
    offsets, H pre-activations and (H+1) FMAs a channel per pair, and the
    full conv's projection."""
    CO = c if co is None else co
    H1 = H + 1
    nbytes = (4 * (M * 3 + N * 3 + N * c + 4 * H + H * c * (co or 1) + c * (co or 1) + M * CO
                   + M) + M + N)
    flops = pairs * (8 + 6 + 6 * H + 2 * H1 * c)
    if co is not None:
        flops += 2 * vq * H1 * c * co
    return bound(nbytes, flops)


def bucket_bwd_bound(M: int, N: int, c: int, co, pairs: int, vq: int,
                     vp: int) -> tuple[float, str]:
    """K10's least time over ``M`` samples (positions, counts and dout read)
    and ``N`` sources (positions and features read, d_f~ written), ``pairs``
    of them within the radius, ``vq`` samples and ``vp`` sources kept."""
    CO = c if co is None else co
    H1 = H + 1
    nw = H * c * (co or 1) + c * (co or 1) + 4 * H
    nbytes = 4 * (M * 3 + N * 3 + 2 * N * c + M * CO + M + 2 * nw) + M + N
    # as K6's count: per in-radius pair d2, offsets, H pre-activations,
    # dpre's H x C and dW1 / db1; depthwise, X's (H+1) x C FMAs and its
    # projections; full (the stem), d_f~ and G over (H+1) x C and the
    # GEMMs dG = t Wcat and dWcat = t^T G
    flops = pairs * (8 + 6 + 6 * H + 2 * H * c + 8 * H)
    flops += (pairs * 2 * H1 * CO + 4 * vp * H1 * c + vq * H * c if co is None else
              pairs * 4 * H1 * c + 4 * vq * H1 * c * CO)
    return bound(nbytes, flops)


def check_bucket_conv(dev, sites) -> tuple:
    """K9 at each ``(levels, cache, site)``: the four bucket sites of the block
    batch's capacity-free MCSeg and MCClassS's conv_0_1 at 4096 points; each
    site's call and device times (``tools.device_ms``), its candidate (window)
    and in-radius pairs and the most in-radius sources of a sample."""
    from mccnn_tpu_torch.ops.cuda import mcconv_kernel as mk
    from mccnn_tpu_torch.tools import device_ms

    gen = torch.Generator().manual_seed(SEED + 13)
    err = ms = pms = bms = 0.0
    bounds = []  # (bound_ms, by) of each site: the row is bound as its largest site
    with torch.no_grad():
        for lv, cache, site in sites:
            name, i, o, _, c, co = site
            params, gs, gp, wf = bucket_site_inputs(gen, dev, lv, cache, site)
            b, M, N = gs.slot_of_point.shape[0], lv[o][0].shape[1], lv[i][0].shape[1]
            kw = dict(c_out=co)
            got, gcnt = mk.bucket_conv_cuda(params, gs, gp, wf, **kw)
            again, _ = mk.bucket_conv_cuda(params, gs, gp, wf, **kw)
            want, wcnt = mk.bucket_conv_reference(params, gs, gp, wf, **kw)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            scale = float(want.abs().max())
            require(bool(torch.equal(got, again)), f"K9 differs between two calls at {name}")
            require(bool(torch.equal(gcnt, wcnt)), f"K9 neighbour counts differ at {name}")
            require(e <= BUCKET_RTOL * scale, f"K9 disagrees with its plain version at {name}: "
                    f"{e:.3e} of {scale:.3e}")
            k_ms = time_ms(lambda: mk.bucket_conv_cuda(params, gs, gp, wf, **kw), iters=10)
            d_ms = device_ms(lambda: mk.bucket_conv_cuda(params, gs, gp, wf, **kw), iters=3)
            p_ms = time_ms(lambda: mk.bucket_conv_reference(params, gs, gp, wf, **kw), iters=1)
            pairs = int(wcnt.sum())
            b_ms, by = bucket_fwd_bound(b * M, b * N, c, co, pairs, int(mk.kept_points(gs).sum()))
            bounds.append((b_ms, by))
            print(f"K9 B={b} {name} N={N} M={M} C={c} CO={co}: candidate_pairs="
                  f"{window_pairs(gs, gp)} in_radius_pairs={pairs} max_in_radius_a_sample="
                  f"{int(wcnt.max())} max_abs_err={e:.3e} max_abs_out={scale:.3e} "
                  f"bitwise_repeatable=True kernel_ms={k_ms:.4f} device_ms={d_ms:.4f} "
                  f"plain_ms={p_ms:.4f} bound_ms={b_ms:.6f} ({by})", flush=True)
            err, ms, pms, bms = max(err, e), ms + k_ms, pms + p_ms, bms + b_ms
    return (err, ms, pms, bms, max(bounds)[1], None)


def check_bucket_backward(dev, sites) -> tuple:
    """K10 at each ``(levels, cache, site)`` of ``check_bucket_conv``, with a
    seeded dout: each site's call and device times (``tools.device_ms``), its
    candidate (window) and in-radius pairs."""
    from mccnn_tpu_torch.ops.cuda import mcconv_kernel as mk
    from mccnn_tpu_torch.tools import device_ms

    gen = torch.Generator().manual_seed(SEED + 14)
    names = ("d_wf", "dw1", "db1", "dw2", "db2")
    err = ms = pms = bms = 0.0
    bounds = []  # (bound_ms, by) of each site: the row is bound as its largest site
    with torch.no_grad():
        for lv, cache, site in sites:
            name, i, o, _, c, co = site
            params, gs, gp, wf = bucket_site_inputs(gen, dev, lv, cache, site)
            b, M, N = gs.slot_of_point.shape[0], lv[o][0].shape[1], lv[i][0].shape[1]
            CO = c if co is None else co
            _, cnt = mk.bucket_conv_reference(params, gs, gp, wf, c_out=co)
            dout = torch.randn((b, M, CO), generator=gen).to(dev)
            args = (params, gs, gp, wf, cnt, dout)
            got = mk.bucket_conv_backward_cuda(*args, c_out=co)
            again = mk.bucket_conv_backward_cuda(*args, c_out=co)
            want = mk.bucket_conv_backward_reference(*args, c_out=co)
            torch.cuda.synchronize()
            parts, e_site = [], 0.0
            for gname, a, a2, w in zip(names, got, again, want):
                require(tuple(a.shape) == tuple(w.shape), f"K10 {gname} shape {tuple(a.shape)}")
                require(bool(torch.equal(a, a2)),
                        f"K10 {gname} differs between two calls at {name}")
                scale = float(w.abs().max())
                e = float((a - w).abs().max())
                e_site = max(e_site, e)
                parts.append(f"{gname} {e:.3e}/{scale:.3e}")
                require(e <= BUCKET_BWD_RTOL * scale,
                        f"K10 {gname} disagrees with its plain version at {name}: "
                        f"{e:.3e} of {scale:.3e}")
            k_ms = time_ms(lambda: mk.bucket_conv_backward_cuda(*args, c_out=co), iters=5)
            d_ms = device_ms(lambda: mk.bucket_conv_backward_cuda(*args, c_out=co), iters=3)
            p_ms = time_ms(lambda: mk.bucket_conv_backward_reference(*args, c_out=co), iters=1)
            pairs = int(cnt.sum())
            vq, vp = int(mk.kept_points(gs).sum()), int(mk.kept_points(gp).sum())
            b_ms, by = bucket_bwd_bound(b * M, b * N, c, co, pairs, vq, vp)
            bounds.append((b_ms, by))
            print(f"K10 B={b} {name} N={N} M={M} C={c} CO={co}: candidate_pairs="
                  f"{window_pairs(gs, gp)} in_radius_pairs={pairs} max_abs_err (err/scale) "
                  f"{', '.join(parts)}; bitwise_repeatable=True kernel_ms={k_ms:.4f} "
                  f"device_ms={d_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.6f} ({by})",
                  flush=True)
            err, ms, pms, bms = max(err, e_site), ms + k_ms, pms + p_ms, bms + b_ms
    return (err, ms, pms, bms, max(bounds)[1], None)


def check_bucket_kernels(dev) -> dict:
    """The bucket hierarchies, then K9 and K10 against their plain versions at
    the shapes of both bucket paths: MCSeg's block batch and tasks.modelnet
    --points 4096."""
    lv, cache = bucket_hierarchy(dev)
    sites = [(lv, cache, site) for site in SEG_SITES]
    sites.append((*modelnet_bucket_levels(dev), MODELNET_SITE))
    return {"K9": check_bucket_conv(dev, sites), "K10": check_bucket_backward(dev, sites)}


def serve_mcseg_bucket(dev) -> dict:
    """MCSeg without a tile capacity served through ``serve.Predictor``: the
    card against the CPU plain path at B=2 (identical hierarchies), then the
    latency of B=8 block batches; K9 must launch and no tile kernel may. A
    profiled B=8 forward after the counted ones gives the busy share."""
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy
    from mccnn_tpu_torch.models import MCSeg
    from mccnn_tpu_torch.serve import Predictor

    rng = np.random.default_rng(SEED + 15)
    blocks = scene_batch(SEED + 15, SEG_B)
    small = {k: blocks[k][:SEG_CPU_B] for k in ("points", "mask")}
    model = MCSeg(SEG_CLASSES, grow=SEG_GROW, radii=SEG_RADII,
                  generator=torch.Generator().manual_seed(SEED)).to(dev)
    require(model.tile_pairs is None, "the bucket MCSeg has a tile capacity")
    calibrate_bn(model, small, rng)
    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        args = [torch.from_numpy(small[k]) for k in ("points", "mask")]
        h_gpu = build_hierarchy(*(a.to(dev) for a in args), SEG_RADII, neighbor_k=SEG_NEIGHBOR_K)
        h_cpu = build_hierarchy(*args, SEG_RADII, neighbor_k=SEG_NEIGHBOR_K)
    same = all(torch.equal(a.sample.idx.cpu(), c.sample.idx) and torch.equal(a.mask.cpu(), c.mask)
               for a, c in zip(h_gpu.levels[1:], h_cpu.levels[1:]))
    require(same, "the card's B=2 bucket hierarchy differs from the CPU plain path's")
    predictor, predictor8 = Predictor(model, SEG_CPU_B), Predictor(model, SEG_B)
    torch.cuda.synchronize()
    reset_counts()
    got = predictor.predict(small)
    lat = []
    for _ in range(4):
        t0 = time.perf_counter()
        logits8 = predictor8.predict(blocks)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts()
    pts8, mask8 = (torch.from_numpy(blocks[k]).to(dev) for k in ("points", "mask"))
    profile_forward(lambda: model(pts8, mask8, with_overflow=True),
                    f"bucket block batch B={SEG_B} N={SEG_N}")
    t0 = time.perf_counter()
    want = Predictor(cpu_model, SEG_CPU_B).predict(small)
    cpu_s = time.perf_counter() - t0
    got = got.cpu()
    err, top = float((got - want).abs().max()), float(want.abs().max())
    print(f"MCSeg bucket serving (Predictor, tile_pairs=None) B={SEG_CPU_B} N={SEG_N} "
          f"grow={SEG_GROW} card vs CPU plain path: logits={tuple(got.shape)} "
          f"max_abs_err={err:.3e} max_abs_logit={top:.3e} hierarchy_equal_to_cpu={same} "
          f"cpu_forward_s={cpu_s:.1f}; B={SEG_B} batch latencies_ms="
          f"{[round(x, 3) for x in lat]} (the first warms up) launches={launches}", flush=True)
    require(bool(torch.isfinite(got).all()) and bool(torch.isfinite(logits8).all()),
            "non-finite MCSeg bucket logits")
    require(bool(torch.allclose(got, want, rtol=SEG_LOGIT_RTOL, atol=SEG_LOGIT_RTOL * top)),
            "MCSeg bucket logits on the card disagree with the CPU plain path")
    for name in ("K1", "K3", "K4", "K9"):
        require(launches[name] > 0, f"{name} was not launched in MCSeg bucket serving")
    for name in ("K2", "K5", "K6", "K7", "K8", "K10"):
        require(launches[name] == 0, f"{name} was launched in MCSeg bucket serving")
    return launches


def train_mcseg_bucket(dev) -> dict:
    """Timed MCSeg bucket train steps at B=8 x 8192 through ``make_train_step``
    (one warm-up, then ``BUCKET_TRAIN_STEPS``); K9 and K10 must launch."""
    from mccnn_tpu_torch.models import MCSeg
    from mccnn_tpu_torch.train import (batch_to_device, init_state, make_optimizer,
                                       make_train_step, segmentation_loss)

    model = MCSeg(SEG_CLASSES, grow=SEG_GROW, radii=SEG_RADII,
                  generator=torch.Generator().manual_seed(SEED)).to(dev)
    opt = make_optimizer(model.parameters())
    init_state(model, opt, SEED)
    step = make_train_step(model, opt, lambda out, b: (
        segmentation_loss(out, b["labels"], b["mask"]), {}))
    batches = [batch_to_device({k: v for k, v in scene_batch(SEED + 16 + i, SEG_B).items()
                                if k in ("points", "mask", "labels")}, dev)
               for i in range(BUCKET_TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    reset_counts()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        loss, _ = step(batch)
        losses.append(float(loss))  # waits for the device
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts()
    print(f"MCSeg bucket train steps (make_train_step, B={SEG_B} N={SEG_N} grow={SEG_GROW}): "
          f"losses={[round(x, 5) for x in losses]} step_ms={[round(x, 3) for x in times]} "
          f"warm_step_ms={float(np.mean(times[1:])):.3f} launches={launches}", flush=True)
    profile_forward(lambda: step(batches[0]), f"bucket train step B={SEG_B} N={SEG_N}",
                    train=True)
    require(all(np.isfinite(losses)), "the MCSeg bucket train step's loss is not finite")
    for name in ("K1", "K2", "K3", "K4", "K9", "K10"):
        require(launches[name] > 0, f"{name} was not launched in MCSeg bucket training")
    for name in ("K5", "K6", "K7", "K8"):
        require(launches[name] == 0, f"{name} was launched in MCSeg bucket training")
    return launches


def run_modelnet_bucket() -> dict:
    """``tasks.modelnet`` at ``--points 4096`` (B=32, full width): a few steps
    and one evaluation, with MCClassS's conv_0_1 on K9 / K10."""
    from mccnn_tpu_torch.tasks import modelnet

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--batch", str(TRAIN_B), "--points", str(MODELNET_BUCKET_N),
                "--n-classes", "40", "--grow", "128", "--epochs", "1", "--steps-per-epoch", "3",
                "--device", "cuda", "--log-dir", tmp, "--ckpt-dir", os.path.join(tmp, "ck")]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = modelnet.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(tmp, "modelnet_MCClassS.metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["tag"] == "train"]
    evals = [r for r in recs if r["tag"] == "eval"]
    require(len(train) == 1 and train[0]["steps"] == 3 and len(evals) == 1,
            f"modelnet --points {MODELNET_BUCKET_N} records: {recs}")
    rec = train[0]
    print(f"trainer (tasks.modelnet, B={TRAIN_B}, N={MODELNET_BUCKET_N}, grow=128): "
          f"loss={rec['loss']:.6f} steps={rec['steps']} warm_step_ms={rec['warm_step_ms']:.3f} "
          f"eval_accuracy={res['best_accuracy']:.4f} total_sec={seconds:.2f} "
          f"launches={launches}", flush=True)
    require(bool(np.isfinite(rec["loss"])), f"modelnet --points {MODELNET_BUCKET_N}: loss")
    for name in ("K1", "K2", "K3", "K4", "K9", "K10"):
        require(launches[name] > 0, f"{name} was not launched by modelnet --points "
                f"{MODELNET_BUCKET_N}")
    return launches


# ------------------------------------------------------------ the classification zoo


def dense_bound(b, M, Ns, c, co, valid, inr, nq, backward) -> tuple[float, str]:
    """``bound`` of the dense conv's function at a site (K1's and K2's work;
    the v1 kernels' too, whose backward reads no G): positions, features,
    params, count and dout read once, outputs written once; the pairs'
    arithmetic and the projection's products over the ``nq`` valid samples."""
    K = (H + 1) * c
    cw, wbytes, proj = (c, K, K) if co is None else (co, K * co, K * co)
    if not backward:
        nbytes = 4 * (b * M * 3 + b * Ns * 3 + b * Ns * c + 4 * H + wbytes + b * M * cw
                      + b * M) + b * (M + Ns)
        return bound(nbytes, 8 * valid + inr * (6 + 6 * H + 2 * K) + 2 * nq * proj)
    nbytes = 4 * (b * M * 3 + b * Ns * 3 + 2 * b * Ns * c + 8 * H + 2 * wbytes + b * M
                  + b * M * cw) + b * (M + Ns)
    return bound(nbytes, 4 * nq * proj + 8 * valid
                 + inr * (6 + 6 * H + 2 * K + 2 * H * c + 8 * H))


def plain_forward64(params, smp, qmask, src, smask, wf, radius, co):
    """The plain forward in float64 over the kernels' fp32 pair plane (the
    in-radius test and pre_h as ``mc_preact`` rounds it): ``(B, M, C | co)``."""
    from mccnn_tpu_torch.core.mcconv import MCConvParams
    from mccnn_tpu_torch.ops.cuda import dense_conv

    inr, _, pre = dense_conv._pair_terms(params, smp, qmask, src, smask, radius,
                                         kernel_rounding=True)
    a = torch.cat([torch.relu(pre), torch.ones_like(pre[..., :1])], dim=-1) * inr[..., None]
    G = torch.einsum("bmnh,bnc->bmhc", a.double(), wf.double())
    cnt = inr.sum(dim=-1).double()
    p64 = MCConvParams(*(t.double() for t in params))
    return dense_conv.project_reference(p64, G, cnt, qmask, co, False)


def check_v1_kernels(dev, b: int, timed: bool) -> dict:
    """K1v1 and K2v1 at every dense conv site of MCClass and MCClassH for a
    batch of ``b`` clouds of N points (hierarchies built by the CPU plain path),
    each against its plain version and against K1 / K2 on the same inputs
    (K2 on K1's G: K2v1 forms the same G rows and runs K2's kernels on them,
    so it must equal K2 bit for bit), bit for bit on repeat, with the site's
    valid and in-radius pair counts and K2v1's transient device memory; K1's
    and K2's counters must not move across two K2v1 calls. With ``timed``,
    CUDA-event times of the kernels, their plain versions, K1 / K2 and one
    torch.matmul of the GEMM part (full sites), the bounds, and the sums over
    the sites. Returns the rows of the kernels line."""
    from mccnn_tpu_torch.api.hierarchy import GLOBAL_RADIUS
    from mccnn_tpu_torch.ops.cuda import dense_conv, density_kernel
    from mccnn_tpu_torch.tools.dense_ab import ZOO_SITES

    req = request(np.random.default_rng(SEED + 20 + b), b)
    lvs = {radii: levels(req, dev, radii) for radii in (RADII_3, RADII_2)}
    gen = torch.Generator().manual_seed(SEED + 20)
    rows = {"K1v1": [], "K2v1": []}
    names = ("d_wf", "dw1", "db1", "dw2", "db2")
    totals = np.zeros(4)  # K1v1, K1, K2v1, K2 ms over the sites
    peak = (0.0, "")  # K2v1's largest transient memory (MiB) and its site
    with torch.no_grad():
        for site, radii, i, o, radius, c, co in ZOO_SITES:
            radius = GLOBAL_RADIUS if radius is None else radius
            (src, smask), (smp, qmask) = lvs[radii][i], lvs[radii][o]
            M, Ns = smp.shape[1], src.shape[1]
            params = site_params(gen, c, co, dev)
            feats = (torch.ones((b, Ns, 1)) if c == 1 else
                     torch.randn((b, Ns, c), generator=gen)).to(dev)
            pdf = density_kernel.kde_density_reference(src, smask, radius)
            wf = dense_conv._weighted_features(feats, pdf, smask)
            fargs = (params, smp, qmask, src, smask, wf, radius, co, False)
            out, cnt = dense_conv._forward_cuda_v1(*fargs)
            again, _ = dense_conv._forward_cuda_v1(*fargs)
            want, wcnt, _ = dense_conv._forward_reference(*fargs)
            want64 = plain_forward64(params, smp, qmask, src, smask, wf, radius, co)
            k1, k1cnt, G = dense_conv._forward_cuda(*fargs)
            torch.cuda.synchronize()
            scale = float(want64.abs().max())
            e_plain = float((out.double() - want64).abs().max()) / scale
            e_fp32 = float((out - want).abs().max()) / scale
            e_k1 = float((out - k1).abs().max()) / scale
            del want64
            require(bool(torch.equal(out, again)), f"K1v1 differs between two calls at {site}")
            require(bool(torch.equal(cnt, wcnt)) and bool(torch.equal(cnt, k1cnt)),
                    f"K1v1 neighbour counts differ at {site}")
            valid, inr = pair_counts(smp, qmask, src, smask, radius)
            dout = torch.randn((b, M, c if co is None else co), generator=gen).to(dev)
            bargs = (params, smp, qmask, src, smask, wf, radius, cnt, dout)
            k2 = dense_conv.dense_mc_conv_backward_cuda(params, smp, qmask, src, smask, wf,
                                                        radius, G, cnt, dout, c_out=co)
            torch.cuda.synchronize()
            k12 = (dense_conv.launches, dense_conv.backward_launches)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = dense_conv.dense_mc_conv_v1_backward_cuda(*bargs, c_out=co)
            torch.cuda.synchronize()
            transient = (torch.cuda.max_memory_allocated() - base) / 2**20
            rep = dense_conv.dense_mc_conv_v1_backward_cuda(*bargs, c_out=co)
            torch.cuda.synchronize()
            require((dense_conv.launches, dense_conv.backward_launches) == k12,
                    f"K2v1 moved K1's or K2's launch counter at {site}")
            peak = max(peak, (transient, site))
            bwant = dense_conv.dense_mc_conv_v1_backward_reference(*bargs, c_out=co)
            parts, b_err = [], 0.0
            for name, a, a2, w, w2 in zip(names, got, rep, bwant, k2):
                require(bool(torch.equal(a, a2)),
                        f"K2v1 {name} differs between two calls at {site}")
                require(bool(torch.equal(a, w2)), f"K2v1 {name} differs from K2 on K1's G at "
                        f"{site}")
                top = max(float(w.abs().max()), 1e-30)
                e_w, e_k2 = float((a - w).abs().max()) / top, float((a - w2).abs().max()) / top
                tol = V1_BWD_W1_RTOL if name in ("dw1", "db1") else V1_BWD_RTOL
                require(e_w <= tol and e_k2 <= tol,
                        f"K2v1 {name} at {site}: {e_w:.3e} of its largest value from the plain "
                        f"version, {e_k2:.3e} from K2 (limit {tol:g})")
                parts.append(f"{name} {e_w:.2e}/{e_k2:.2e}")
                b_err = max(b_err, float((a - w).abs().max()))
            mode = "depthwise" if co is None else "full"
            line = (f"v1 B={b} {site} ({mode}) N={Ns} M={M} C={c} CO={co} pairs={valid} "
                    f"in_radius={inr}: K1v1 rel_err plain_f64={e_plain:.3e} K1={e_k1:.3e} "
                    f"plain_f32={e_fp32:.3e} (max |out| {scale:.3e}); K2v1 rel_err plain/K2 "
                    f"{', '.join(parts)} (bit-equal to K2 on K1's G); K2v1 transient "
                    f"{transient:.3f} MiB; bitwise_repeatable=True")
            require(e_plain <= V1_FWD_RTOL and e_k1 <= V1_FWD_RTOL and e_fp32 <= CONV_RTOL,
                    f"K1v1 at {site}: {e_plain:.3e} of the largest output from its plain "
                    f"version in float64 (limit {V1_FWD_RTOL:g}), {e_k1:.3e} from K1 (limit "
                    f"{V1_FWD_RTOL:g}), {e_fp32:.3e} from the fp32 plain version (limit "
                    f"{CONV_RTOL:g})")
            if timed:
                nq = int(qmask.sum())
                ms = time_ms(lambda: dense_conv._forward_cuda_v1(*fargs))
                pms = time_ms(lambda: dense_conv._forward_reference(*fargs), iters=3)
                k1ms = time_ms(lambda: dense_conv._forward_cuda(*fargs))
                bms = time_ms(lambda: dense_conv.dense_mc_conv_v1_backward_cuda(*bargs, c_out=co))
                bpms = time_ms(lambda: dense_conv.dense_mc_conv_v1_backward_reference(
                    *bargs, c_out=co), iters=3)
                k2ms = time_ms(lambda: dense_conv.dense_mc_conv_backward_cuda(
                    params, smp, qmask, src, smask, wf, radius, G, cnt, dout, c_out=co))
                totals += (ms, k1ms, bms, k2ms)
                fb, fby = dense_bound(b, M, Ns, c, co, valid, inr, nq, False)
                bb, bby = dense_bound(b, M, Ns, c, co, valid, inr, nq, True)
                lms = blms = None
                if co is not None:
                    R, K = b * M, (H + 1) * c
                    Gf, W = G.reshape(R, K), wcat(params, c, co)
                    t = dout.reshape(R, co).contiguous()
                    lms = time_ms(lambda: torch.matmul(Gf, W))
                    blms = time_ms(lambda: (torch.matmul(t, W.T), torch.matmul(Gf.T, t)))
                line += (f"; K1v1 ms={ms:.4f} plain_ms={pms:.4f} K1_ms={k1ms:.4f} "
                         f"bound_ms={fb:.6f} ({fby}) matmul_ms={lms}; K2v1 ms={bms:.4f} "
                         f"plain_ms={bpms:.4f} K2_ms={k2ms:.4f} bound_ms={bb:.6f} ({bby}) "
                         f"matmul_ms={blms}")
                rows["K1v1"].append((e_plain * scale, ms, pms, fb, fby, lms))
                rows["K2v1"].append((b_err, bms, bpms, bb, bby, blms))
            print(line, flush=True)
    summary = f"v1 B={b}: K2v1's largest transient memory {peak[0]:.3f} MiB at {peak[1]}"
    if timed:
        summary += (f"; over the {len(ZOO_SITES)} sites K1v1 {totals[0]:.4f} ms (K1 "
                    f"{totals[1]:.4f} in the same call), K2v1 {totals[2]:.4f} ms (K2 "
                    f"{totals[3]:.4f})")
    print(summary, flush=True)
    return rows


def zoo_model(name: str, **kw):
    from mccnn_tpu_torch.models import MCClass, MCClassH

    cls = MCClass if name == "MCClass" else MCClassH
    return cls(N_CLASSES, generator=torch.Generator().manual_seed(SEED), **kw)


def serve_zoo(dev) -> dict:
    """MCClass and MCClassH (seeded weights and BN statistics) served through
    ``serve.Predictor`` at B = 8: the first two clouds against the CPU plain
    path at B = 2 (identical hierarchies; every head of MCClassH), batch
    latencies, K1 / K3 / K4 launched and no backward, and a profiled batch."""
    from mccnn_tpu_torch.serve import Predictor

    launches = {}
    for k, name in enumerate(ZOO):
        rng = np.random.default_rng(SEED + 30 + k)
        model = zoo_model(name).to(dev)
        calibrate_bn(model, request(rng, SERVE_B), rng)
        cpu_predictor = Predictor(copy.deepcopy(model).cpu(), ZOO_CPU_B)
        predictor = Predictor(model, SERVE_B)
        reqs = [request(rng, SERVE_B) for _ in range(4)]
        torch.cuda.synchronize()
        reset_counts()
        lat, served = [], []
        for req in reqs:
            t0 = time.perf_counter()
            served.append(predictor.predict(req))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        launches[name] = read_counts()
        small = {key: v[:ZOO_CPU_B] for key, v in reqs[0].items()}
        same = all(same_hierarchy(small, dev, radii)
                   for radii in ((RADII_3,) if name == "MCClass" else (RADII_2, RADII_3)))
        want = cpu_predictor.predict(small)
        got, want = ([x[:ZOO_CPU_B].cpu() for x in served[0]], list(want)) if name == "MCClassH" \
            else ([served[0][:ZOO_CPU_B].cpu()], [want])
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        tops = [float(w.abs().max()) for w in want]
        pts, mask = (torch.from_numpy(reqs[1][key]).to(dev) for key in ("points", "mask"))
        busy = profile_forward(lambda: model(pts, mask), f"{name} served batch B={SERVE_B} N={N}")
        print(f"{name} serving (Predictor, published widths, B={SERVE_B} N={N}): "
              f"latencies_ms={[round(x, 3) for x in lat]} (the first warms up) "
              f"card vs CPU plain path (B={ZOO_CPU_B}) max_abs_err={errs} max_abs_logit={tops} "
              f"hierarchy_equal_to_cpu={same} busy_share={busy:.4f} "
              f"launches={launches[name]}", flush=True)
        require(same, f"{name}: the card's hierarchy differs from the CPU plain path's")
        for g, w, e, top in zip(got, want, errs, tops):
            require(bool(torch.isfinite(g).all()) and tuple(g.shape) == (ZOO_CPU_B, N_CLASSES),
                    f"{name}: served logits {tuple(g.shape)} not finite or misshapen")
            require(e <= LOGIT_RTOL * top, f"{name}: served logits disagree with the CPU plain "
                    f"path ({e:.3e} of {top:.3e})")
        for kid in ("K1", "K3", "K4"):
            require(launches[name][kid] > 0, f"{kid} was not launched while serving {name}")
        for kid in ("K2", "K1v1", "K2v1"):
            require(launches[name][kid] == 0, f"{kid} was launched while serving {name}")
    return launches


def zoo_zero_grad(param: str) -> bool:
    """Dense biases that feed a batch-statistic BN (gradient 0 up to rounding):
    MCClass's ``mix_{o}`` and the heads' FC biases."""
    if param.startswith("mixes.mix_"):
        return param.endswith(".bias")
    return param.startswith(("fcs.", "heads.")) and param.endswith(".dense.bias")


def check_zoo_train_steps(dev) -> dict:
    """One train step of MCClass and of MCClassH (published widths, drop
    rates 0, seeded BN statistics) at B = ZOO_STEP_B on the card against the
    CPU plain path, through ``gated_train_step``."""
    from mccnn_tpu_torch.tasks.modelnet import make_loss

    launches = {}
    for k, name in enumerate(ZOO):
        rng = np.random.default_rng(SEED + 40 + k)
        batch = request(rng, ZOO_STEP_B)
        batch["labels"] = rng.integers(0, N_CLASSES, size=ZOO_STEP_B).astype(np.int32)
        kw = {"drop_rate": 0.0} | ({"point_drop_rate": 0.0} if name == "MCClass" else {})
        model = zoo_model(name, **kw).to(dev)
        calibrate_bn(model, batch, rng)
        _, _, launches[name] = gated_train_step(
            f"{name} train step B={ZOO_STEP_B} N={N}", model, dev, batch, make_loss(name),
            zoo_zero_grad, ZOO_ZERO_GRAD_RTOL)
        for kid in ("K1", "K2", "K3", "K4"):
            require(launches[name][kid] > 0, f"{kid} was not launched in the {name} train step")
    return launches


def run_zoo_trainer(name: str, extra=()) -> tuple[dict, float]:
    """``tasks.modelnet --model name`` at the CLI's shape (B = 32, N = 1024,
    published widths): two epochs of ZOO_TRAIN_STEPS steps (the second
    profiled) and one voting evaluation; K1-K4 must launch. Returns the
    launch counts and the first epoch's warm step time (ms)."""
    from mccnn_tpu_torch.tasks import modelnet

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--model", name, "--batch", str(TRAIN_B), "--points", str(N),
                "--n-classes", str(N_CLASSES), "--epochs", "2", "--steps-per-epoch",
                str(ZOO_TRAIN_STEPS), "--eval-every", "2", "--votes", "2",
                "--device", "cuda", "--log-dir", tmp, "--ckpt-dir", os.path.join(tmp, "ck"),
                "--profile-dir", os.path.join(tmp, "prof"), *extra]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = modelnet.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(tmp, f"modelnet_{name}.metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["tag"] == "train"]
    evals = [r for r in recs if r["tag"] == "eval"]
    require(len(train) == 2 and all(r["steps"] == ZOO_TRAIN_STEPS for r in train)
            and len(evals) == 1, f"{name} trainer records: {recs}")
    print(f"trainer (tasks.modelnet --model {name} {' '.join(extra)}, B={TRAIN_B}, N={N}, "
          f"published widths, {N_CLASSES} classes, default dropout): losses="
          f"{[round(r['loss'], 6) for r in train]} warm_step_ms={train[0]['warm_step_ms']:.3f} "
          f"(second epoch, profiled: {train[1]['warm_step_ms']:.3f}, busy_share "
          f"{train[1]['profile_busy_share']:.4f}, device_ms {train[1]['profile_device_ms']:.3f} "
          f"over {ZOO_TRAIN_STEPS} steps) eval_accuracy={res['best_accuracy']:.4f} "
          f"(2 votes) total_sec={seconds:.2f} launches={launches}", flush=True)
    require(all(np.isfinite(r["loss"]) for r in train), f"{name}: the trainer's loss")
    for kid in ("K1", "K2", "K3", "K4"):
        require(launches[kid] > 0, f"{kid} was not launched by tasks.modelnet --model {name}")
    return launches, train[0]["warm_step_ms"]


_DENSE_CHILD = r"""
import json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from mccnn_tpu_torch.ops.cuda import dense_conv
from mccnn_tpu_torch.tasks import modelnet
assert getattr(dense_conv, %r), "the switch did not reach the module"
with tempfile.TemporaryDirectory() as tmp:
    res = modelnet.main(["--synthetic", "--model", "MCClass", "--batch", "%d", "--points", "%d",
                         "--n-classes", "%d", "--epochs", "1", "--steps-per-epoch", "%d",
                         "--device", "cuda", "--log-dir", tmp, "--ckpt-dir", tmp + "/ck"])
    with open(tmp + "/modelnet_MCClass.metrics.jsonl") as f:
        train = [json.loads(l) for l in f if '"train"' in l]
print("DENSE_COUNTS " + json.dumps({
    "launches": chip_smoke.read_counts(), "loss": train[0]["loss"],
    "warm_step_ms": train[0].get("warm_step_ms"), "best_accuracy": res["best_accuracy"]}))
"""


def run_dense_switch_trainer(var: str, value: str, attr: str, launched, not_launched,
                             default_ms: float) -> dict:
    """MCClass training through ``tasks.modelnet`` with ``var=value`` in a
    child process (``dense_conv.<attr>`` must be set there): its printed
    counters must show the kernels of ``launched`` and none of
    ``not_launched``; a failed child fails the script. Its warm step is
    printed beside ``default_ms``, the default MCClass trainer's."""
    what = f"{var}={value}"
    env = dict(os.environ, **{var: value})
    code = _DENSE_CHILD % (attr, TRAIN_B, N, N_CLASSES, ZOO_TRAIN_STEPS)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=os.path.dirname(
        os.path.abspath(__file__)), capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"the {what} trainer failed ({proc.returncode}): "
            f"{proc.stderr[-3000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("DENSE_COUNTS ")]
    require(len(line) == 1, f"the {what} trainer printed no counters: {proc.stdout[-2000:]}")
    res = json.loads(line[0][len("DENSE_COUNTS "):])
    counts = res["launches"]
    print(f"trainer under {what} (child process, tasks.modelnet --model MCClass, "
          f"B={TRAIN_B}, N={N}, {ZOO_TRAIN_STEPS} steps and one eval): {res} "
          f"child_sec={seconds:.2f}; warm_step_ms {res['warm_step_ms']:.3f} against "
          f"{default_ms:.3f} without the switch (phase 19)", flush=True)
    require(bool(np.isfinite(res["loss"])), f"the {what} trainer's loss")
    for kid in launched:
        require(counts[kid] > 0, f"{kid} was not launched under {what}")
    for kid in not_launched:
        require(counts[kid] == 0, f"{kid} was launched under {what}")
    return counts


def normals_batch_of(b: int, seed: int) -> dict:
    """A ``tasks.normals`` batch: ``b`` synthetic spheres drawn to N points,
    with their normals."""
    from mccnn_tpu_torch.tasks.normals import NormalsSource

    src = NormalsSource.synthetic(b, seed)
    return next(src.batches(b, N, np.random.default_rng(seed)))


def shapenet_batch_of(b: int, seed: int) -> dict:
    """A ``tasks.shapenet`` batch: ``b`` synthetic part clouds of N points with
    their part labels and category one-hots."""
    from mccnn_tpu_torch.tasks.shapenet import SyntheticSegSource

    src = SyntheticSegSource(b, SHAPENET_PARTS, SHAPENET_CATS, seed)
    return next(src.batches(b, N, np.random.default_rng(seed)))


def sweep_sites(b: int, models) -> list:
    """Every Poisson sweep of ``models``' hierarchies on a batch of ``b``
    clouds of that model's data: (model, level, points, mask, radius), the
    levels built by the plain path on the CPU."""
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy

    sources = {
        "MCNorm": lambda: (normals_batch_of(b, SEED + 50), NORM_RADII),
        "MCNormS": lambda: (normals_batch_of(b, SEED + 51), (NORMS_RADIUS,)),
        "ShapeNet MCSeg": lambda: (shapenet_batch_of(b, SEED + 52), SHAPENET_RADII),
        "MCClassS": lambda: (request(np.random.default_rng(SEED + 53 + b), b), RADII_2),
    }
    sites = []
    for model in models:
        batch, radii = sources[model]()
        hier = build_hierarchy(torch.from_numpy(batch["points"]), torch.from_numpy(batch["mask"]),
                               radii)
        for lvl, r in enumerate(radii):
            sites.append((model, lvl, hier.levels[lvl].points, hier.levels[lvl].mask, r))
    return sites


def check_sweep_variants(dev, b: int, models) -> dict:
    """K3v2, K3v3 and K3v4 at every sweep of ``models``' hierarchies on a batch
    of ``b`` clouds: each against its plain version and against K3, bit for
    bit, and bit for bit on repeat (K3v3 where the reference runs it: its
    colour runs fit their windows; K3v4 folds 4 clouds a block, the default
    SB); times of each, of its plain version and of K3, and the bound (the
    bytes of positions, mask, cells and colours in and the selection out, or
    the in-radius pairs' d2, as K3's). Returns MCNorm's rows, for the kernels
    line."""
    from mccnn_tpu_torch.core.sampling import sweep_cells
    from mccnn_tpu_torch.ops.cuda import poisson_kernel as pk

    rows = {kid: [] for kid in SWEEP_VARIANTS}
    with torch.no_grad():
        for model, lvl, pts, mask, r in sweep_sites(b, models):
            pts, mask = pts.to(dev), mask.to(dev)
            cids, colors = sweep_cells(pts, r)
            args = (pts, mask, cids, colors, r)
            k3 = pk.poisson_sweep_cuda(*args)
            require(torch.equal(k3, pk.poisson_sweep_reference(*args)),
                    f"K3 differs from its plain version at {model} level {lvl}")
            k3_ms = time_ms(lambda: pk.poisson_sweep_cuda(*args))
            _, inr = pair_counts(pts, mask, pts, mask, r)
            Bn, Nn = pts.shape[:2]
            bms, by = bound(Bn * Nn * (12 + 1 + 4 + 4 + 1), 8 * inr)
            layout = pk.v3_layout(mask, cids, colors)
            fits = layout.order.shape[1] > pk.SWEEP_WINDOW and bool(layout.fits)
            runs = {"K3v2": (pk.poisson_sweep_v2_cuda, pk.poisson_sweep_v2_reference, {}),
                    "K3v3": (pk.poisson_sweep_v3_cuda, pk.poisson_sweep_v3_reference,
                             {"layout": layout}),
                    "K3v4": (pk.poisson_sweep_v4_cuda, pk.poisson_sweep_v4_reference,
                             {"sb": int(pk._SB)})}
            parts = []
            for kid, (kernel, plain, kw) in runs.items():
                if kid == "K3v3" and not fits:
                    parts.append("K3v3 not run (a colour run overflows its window: the "
                                 "reference takes the default sweep, K3)")
                    continue
                got, again = kernel(*args, **kw), kernel(*args, **kw)
                want = plain(*args, **kw)
                torch.cuda.synchronize()
                diff, diff_k3 = int((got != want).sum()), int((got != k3).sum())
                require(diff == 0 and diff_k3 == 0,
                        f"{kid} differs from its plain version ({diff} flags) or K3 ({diff_k3}) "
                        f"at {model} level {lvl} B={Bn} N={Nn} r={r}")
                require(torch.equal(got, again), f"{kid} differs between two calls at {model}")
                ms = time_ms(lambda: kernel(*args, **kw))
                pms = time_ms(lambda: plain(*args, **kw), iters=5)
                parts.append(f"{kid} kernel_ms={ms:.4f} plain_ms={pms:.4f} differing_flags=0")
                if model == "MCNorm":
                    rows[kid].append((float(diff), ms, pms, bms, by, None))
            print(f"sweep variants {model} level {lvl} B={Bn} N={Nn} r={r}: "
                  f"selected={int(k3.sum())} K3_ms={k3_ms:.4f} bound_ms={bms:.6f} ({by}) v3_fits="
                  f"{fits}; " + "; ".join(parts), flush=True)
    return rows


def mcnorm_model():
    from mccnn_tpu_torch.tasks import normals

    return normals.build_model("MCNorm", None, seed=SEED)


def serve_mcnorm(dev) -> dict:
    """MCNorm (grow 64, seeded weights and BN statistics) served through
    ``serve.Predictor`` at B = 8: the first two clouds against the CPU plain
    path (B = 2, identical hierarchies), batch latencies, K1 / K3 / K4
    launched and no backward or variant kernel, and a profiled batch."""
    from mccnn_tpu_torch.serve import Predictor

    rng = np.random.default_rng(SEED + 60)
    model = mcnorm_model().to(dev)
    calibrate_bn(model, normals_batch_of(SERVE_B, SEED + 61), rng)
    cpu_predictor = Predictor(copy.deepcopy(model).cpu(), ZOO_CPU_B)
    predictor = Predictor(model, SERVE_B)
    reqs = [normals_batch_of(SERVE_B, SEED + 62 + k) for k in range(4)]
    torch.cuda.synchronize()
    reset_counts()
    lat, served = [], []
    for req in reqs:
        t0 = time.perf_counter()
        served.append(predictor.predict(req))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts()
    small = {key: reqs[0][key][:ZOO_CPU_B] for key in ("points", "mask")}
    same = same_hierarchy(small, dev, NORM_RADII)
    want = cpu_predictor.predict(small)
    got = served[0][:ZOO_CPU_B].cpu()
    err, top = float((got - want).abs().max()), float(want.abs().max())
    pts, mask = (torch.from_numpy(reqs[1][key]).to(dev) for key in ("points", "mask"))
    busy = profile_forward(lambda: model(pts, mask), f"MCNorm served batch B={SERVE_B} N={N}")
    print(f"MCNorm serving (Predictor, grow 64, radii {NORM_RADII}, B={SERVE_B} N={N}): "
          f"latencies_ms={[round(x, 3) for x in lat]} (the first warms up) card vs CPU plain "
          f"path (B={ZOO_CPU_B}) max_abs_err={err:.3e} max_abs_normal={top:.3e} "
          f"hierarchy_equal_to_cpu={same} busy_share={busy:.4f} launches={launches}", flush=True)
    require(same, "MCNorm: the card's hierarchy differs from the CPU plain path's")
    require(tuple(got.shape) == (ZOO_CPU_B, N, 3) and bool(torch.isfinite(got).all()),
            f"MCNorm: served normals {tuple(got.shape)} not finite or misshapen")
    require(err <= LOGIT_RTOL * top, f"MCNorm: served normals disagree with the CPU plain path "
            f"({err:.3e} of {top:.3e})")
    for kid in ("K1", "K3", "K4"):
        require(launches[kid] > 0, f"{kid} was not launched while serving MCNorm")
    for kid in ("K2", *SWEEP_VARIANTS):
        require(launches[kid] == 0, f"{kid} was launched while serving MCNorm")
    return launches


def check_norm_seg_train_steps(dev) -> dict:
    """One MCNorm and one ShapeNet-MCSeg train step (defaults, dropout 0,
    seeded BN statistics) at B = NORM_STEP_B on the card against the CPU
    plain path, through ``gated_train_step``."""
    from mccnn_tpu_torch.models import MCSeg
    from mccnn_tpu_torch.tasks import normals, shapenet

    mix_bias = lambda n: n.startswith("mixes.") and n.endswith(".bias")  # noqa: E731
    launches = {}
    cases = [("MCNorm", normals_batch_of(NORM_STEP_B, SEED + 71), mcnorm_model, normals.loss_fn),
             ("ShapeNet MCSeg", shapenet_batch_of(NORM_STEP_B, SEED + 72),
              lambda: MCSeg(SHAPENET_PARTS, n_categories=SHAPENET_CATS, drop_rate=0.0,
                            generator=torch.Generator().manual_seed(SEED)),
              shapenet.loss_fn)]
    for k, (name, batch, build, loss_fn) in enumerate(cases):
        rng = np.random.default_rng(SEED + 73 + k)
        model = build().to(dev)
        calibrate_bn(model, batch, rng)
        _, _, launches[name] = gated_train_step(
            f"{name} train step B={NORM_STEP_B} N={N}", model, dev, batch, loss_fn, mix_bias,
            SEG_ZERO_GRAD_RTOL)
        for kid in ("K1", "K2", "K3", "K4"):
            require(launches[name][kid] > 0, f"{kid} was not launched in the {name} train step")
    return launches


def run_task_trainer(task: str, extra=()) -> dict:
    """``tasks.normals`` or ``tasks.shapenet`` through its entry point at the
    CLI's defaults (B = 32, N = 1024, grow 64): two epochs of
    TASK_TRAIN_STEPS steps (the second profiled: busy share and the kernels
    that take the most device time) and one evaluation; a finite loss and
    K1-K4 launched."""
    from mccnn_tpu_torch.tasks import normals, shapenet

    module = normals if task == "normals" else shapenet
    with tempfile.TemporaryDirectory() as tmp:
        prof = os.path.join(tmp, "prof")
        argv = ["--synthetic", "--batch", str(TRAIN_B), "--points", str(N), "--epochs", "2",
                "--steps-per-epoch", str(TASK_TRAIN_STEPS), "--eval-every", "2",
                "--device", "cuda", "--log-dir", tmp, "--ckpt-dir", os.path.join(tmp, "ck"),
                "--profile-dir", prof, *extra]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = module.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        (log,) = [f for f in os.listdir(tmp) if f.endswith(".metrics.jsonl")]
        with open(os.path.join(tmp, log)) as f:
            recs = [json.loads(line) for line in f]
        with open(os.path.join(prof, "ops.txt")) as f:
            table = f.read().split("by self_cuda_time_total\n", 1)[1].splitlines()[:12]
    train = [r for r in recs if r["tag"] == "train"]
    evals = [r for r in recs if r["tag"] == "eval"]
    require(len(train) == 2 and all(r["steps"] == TASK_TRAIN_STEPS for r in train)
            and len(evals) == 1, f"tasks.{task} records: {recs}")
    metrics = {k: v for k, v in evals[0].items() if k not in ("t", "step", "tag", "epoch")}
    print(f"trainer (tasks.{task} {' '.join(extra)}, B={TRAIN_B}, N={N}, defaults): "
          f"losses={[round(r['loss'], 6) for r in train]} "
          f"warm_step_ms={train[0]['warm_step_ms']:.3f} (second epoch, profiled: "
          f"{train[1]['warm_step_ms']:.3f}, busy_share {train[1]['profile_busy_share']:.4f}, "
          f"device_ms {train[1]['profile_device_ms']:.3f} over {TASK_TRAIN_STEPS} steps) "
          f"eval={metrics} total_sec={seconds:.2f} launches={launches}", flush=True)
    print("\n".join(f"  {line}" for line in table), flush=True)
    require(all(np.isfinite(r["loss"]) for r in train), f"tasks.{task}: the trainer's loss")
    for kid in ("K1", "K2", "K3", "K4"):
        require(launches[kid] > 0, f"{kid} was not launched by tasks.{task}")
    return launches


_SWEEP_CHILD = r"""
import json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from mccnn_tpu_torch.ops.cuda import poisson_kernel
from mccnn_tpu_torch.tasks import normals
assert poisson_kernel._SWEEP == %r, "MCCNN_POISSON_SWEEP did not reach the module"
with tempfile.TemporaryDirectory() as tmp:
    res = normals.main(["--synthetic", "--batch", "%d", "--points", "%d", "--epochs", "1",
                        "--steps-per-epoch", "%d", "--device", "cuda", "--log-dir", tmp,
                        "--ckpt-dir", tmp + "/ck"])
    with open(tmp + "/normals_MCNorm.metrics.jsonl") as f:
        train = [json.loads(l) for l in f if '"train"' in l]
print("SWEEP_COUNTS " + json.dumps({
    "launches": chip_smoke.read_counts(), "routes": dict(poisson_kernel.routes),
    "loss": train[0]["loss"], "warm_step_ms": train[0].get("warm_step_ms"),
    "best_angular_error": res["best_angular_error"]}))
"""


def run_sweep_variant_trainers() -> dict:
    """``tasks.normals`` (MCNorm, B = 32, N = 1024) under
    ``MCCNN_POISSON_SWEEP=v2``, ``v3`` and ``v4``, each in a child process:
    its printed counters must show that variant's kernel launched and no
    other variant's; a failed child fails the script."""
    out = {}
    for kid, (_, variant) in SWEEP_VARIANTS.items():
        env = dict(os.environ, MCCNN_POISSON_SWEEP=variant)
        code = _SWEEP_CHILD % (variant, TRAIN_B, N, TASK_TRAIN_STEPS)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=os.path.dirname(
            os.path.abspath(__file__)), capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        require(proc.returncode == 0, f"the MCCNN_POISSON_SWEEP={variant} trainer failed "
                f"({proc.returncode}): {proc.stderr[-3000:]}")
        line = [x for x in proc.stdout.splitlines() if x.startswith("SWEEP_COUNTS ")]
        require(len(line) == 1, f"the MCCNN_POISSON_SWEEP={variant} trainer printed no "
                f"counters: {proc.stdout[-2000:]}")
        res = json.loads(line[0][len("SWEEP_COUNTS "):])
        counts = res["launches"]
        print(f"trainer under MCCNN_POISSON_SWEEP={variant} (child process, tasks.normals, "
              f"B={TRAIN_B}, N={N}, {TASK_TRAIN_STEPS} steps and one eval): {res} "
              f"child_sec={seconds:.2f}", flush=True)
        require(bool(np.isfinite(res["loss"])), f"the MCCNN_POISSON_SWEEP={variant} trainer's loss")
        require(counts[kid] > 0, f"{kid} was not launched under MCCNN_POISSON_SWEEP={variant}")
        for other in SWEEP_VARIANTS:
            require(other == kid or counts[other] == 0,
                    f"{other} was launched under MCCNN_POISSON_SWEEP={variant}")
        out[f"normals_train_{variant}"] = counts
    return out

# ------------------------------------------------------------ the roofline instruments


def planes_bound(b, M, Ns, c, co, valid, inr, nq) -> tuple[float, str]:
    """K1p's least time: K1's bytes (``dense_bound``); the operations of its
    function by the unit that runs them: the d2 test, the mask and ReLU, the
    contraction and the projection in fp32 on the CUDA cores, the H planes
    (cw_h - sw_h + b1_h: 2 operations a pair and plane) in TF32 on the
    tensor cores (the H100's published peaks, ``mccnn_tpu_torch.tools``)."""
    from mccnn_tpu_torch.tools import (PEAK_BYTES_PER_S, PEAK_FP32_FLOP_PER_S,
                                       PEAK_TF32_FLOP_PER_S)

    K = (H + 1) * c
    cw, wbytes, proj = (c, K, K) if co is None else (co, K * co, K * co)
    nbytes = 4 * (b * M * 3 + b * Ns * 3 + b * Ns * c + 4 * H + wbytes + b * M * cw
                  + b * M) + b * (M + Ns)
    fp32 = 8 * valid + inr * (2 * H + 2 * K) + 2 * nq * proj
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (fp32 / PEAK_FP32_FLOP_PER_S + 2 * H * inr / PEAK_TF32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_planes_kernels(dev, b: int, timed: bool) -> list:
    """K1p at every dense conv site of MCClass, MCClassH and MCClassS for a
    batch of ``b`` clouds of N points (hierarchies built by the CPU plain
    path), against its plain version and K1 on the same inputs, bit for bit
    on repeat; with ``timed``, CUDA-event times of K1p, its plain version, K1
    and one torch.matmul of the GEMM part (full sites), and the bounds; per
    site the valid and in-radius pair counts, and summed K1p / K1 over the
    zoo's sites, MCClassS's, and the C = 1 stems alone. Returns the rows of
    the kernels line."""
    from mccnn_tpu_torch.api.hierarchy import GLOBAL_RADIUS
    from mccnn_tpu_torch.ops.cuda import dense_conv, density_kernel
    from mccnn_tpu_torch.tools.dense_ab import ZOO_SITES

    req = request(np.random.default_rng(SEED + 30 + b), b)
    lvs = {radii: levels(req, dev, radii) for radii in (RADII_3, RADII_2)}
    gen = torch.Generator().manual_seed(SEED + 30)
    rows = []
    sums = {"zoo": [0.0, 0.0], "MCClassS": [0.0, 0.0], "C = 1 stem": [0.0, 0.0]}  # K1p, K1 ms
    with torch.no_grad():
        for site, radii, i, o, radius, c, co in ZOO_SITES + MCCLASSS_SITES:
            radius = GLOBAL_RADIUS if radius is None else radius
            (src, smask), (smp, qmask) = lvs[radii][i], lvs[radii][o]
            M, Ns = smp.shape[1], src.shape[1]
            params = site_params(gen, c, co, dev)
            feats = (torch.ones((b, Ns, 1)) if c == 1 else
                     torch.randn((b, Ns, c), generator=gen)).to(dev)
            pdf = density_kernel.kde_density_reference(src, smask, radius)
            wf = dense_conv._weighted_features(feats, pdf, smask)
            fargs = (params, smp, qmask, src, smask, wf, radius, co, False)
            out, cnt, _ = dense_conv.dense_mc_conv_planes_cuda(*fargs)
            again, _, _ = dense_conv.dense_mc_conv_planes_cuda(*fargs)
            want, wcnt, _ = dense_conv._forward_planes_reference(*fargs)
            k1, k1cnt, G = dense_conv._forward_cuda(*fargs)
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            e_plain = float((out - want).abs().max()) / scale
            e_k1 = float((out - k1).abs().max()) / scale
            require(bool(torch.equal(out, again)), f"K1p differs between two calls at {site}")
            require(bool(torch.equal(cnt, wcnt)) and bool(torch.equal(cnt, k1cnt)),
                    f"K1p neighbour counts differ at {site}")
            require(e_plain <= K1P_RTOL and e_k1 <= K1P_RTOL,
                    f"K1p at {site}: {e_plain:.3e} of the largest output from its plain version, "
                    f"{e_k1:.3e} from K1 (limit {K1P_RTOL:g})")
            mode = "depthwise" if co is None else "full"
            valid, inr = pair_counts(smp, qmask, src, smask, radius)
            line = (f"K1p B={b} {site} ({mode}) N={Ns} M={M} C={c} CO={co} pairs valid={valid} "
                    f"in_radius={inr}: rel_err plain={e_plain:.3e} K1={e_k1:.3e} (max |out| "
                    f"{scale:.3e}) bitwise_repeatable=True count_equals_K1=True")
            if timed:
                ms = time_ms(lambda: dense_conv.dense_mc_conv_planes_cuda(*fargs))
                pms = time_ms(lambda: dense_conv._forward_planes_reference(*fargs), iters=3)
                k1ms = time_ms(lambda: dense_conv._forward_cuda(*fargs))
                bms, by = planes_bound(b, M, Ns, c, co, valid, inr, int(qmask.sum()))
                lms = None
                if co is not None:
                    Gf, W = G.reshape(b * M, (H + 1) * c), wcat(params, c, co)
                    lms = time_ms(lambda: torch.matmul(Gf, W))
                line += (f" K1p_ms={ms:.4f} plain_ms={pms:.4f} K1_ms={k1ms:.4f} "
                         f"bound_ms={bms:.6f} ({by}) matmul_ms={lms}")
                rows.append((e_plain * scale, ms, pms, bms, by, lms))
                for key in ["MCClassS" if site.startswith("MCClassS") else "zoo"] + (
                        ["C = 1 stem"] if c == 1 else []):
                    sums[key][0] += ms
                    sums[key][1] += k1ms
            print(line, flush=True)
    if timed:
        print("K1p against K1, summed: " + "; ".join(
            f"{k} sites {v[0]:.4f} ms against {v[1]:.4f} ms ({v[0] / v[1]:.3f}x)"
            for k, v in sums.items()), flush=True)
    return rows


def step_pairs(lay) -> int:
    """Valid (sample, candidate source) pairs the forward step list hands K5
    (a sentinel minor holds none): the work of the ``mm`` probe's d2 planes."""
    st = lay.steps
    B, NS = lay.smp_valid.shape
    Tm = st.Tm
    vs = lay.smp_valid.reshape(B, NS // 128, 128).sum(-1)  # valid samples a major
    vm = lay.src_valid[:, : st.n_minor * Tm].reshape(B, st.n_minor, Tm).sum(-1)
    vm = torch.cat([vm, vm.new_zeros((B, 1))], dim=1)
    G, S = st.j_ids.shape[1:]
    per_step = vm.gather(1, st.j_ids.reshape(B, G * S).long()).reshape(B, G, S).sum(1)
    return int((per_step * vs.gather(1, st.i_ids.long())).sum())


def probe_bound(probe, smp, qmask, src, c, co, pairs, cand) -> tuple[float, str]:
    """A probe's least time: K5's bytes (K6's for bwd_noop, ``tile_bwd_bound``'s
    count) and the fp32 operations of its function: d2 and the count on the
    in-radius pairs (noop, bwd_noop), + the factored planes (planes); for mm,
    d2 over every valid candidate pair of the step list, one contraction of
    that d2 plane (the H planes are one plane) and one of the radius mask
    over the in-radius pairs, and their projection, ``D (sum_h w2_h) + Mk b2``
    a valid sample."""
    if probe == "bwd_noop":
        b, M, N = smp.shape[0], smp.shape[1], src.shape[1]
        CO = c if co is None else co
        nw = H * c * (co or 1) + c * (co or 1) + 4 * H
        nbytes = (4 * (b * M * 3 + b * N * 3 + 2 * b * N * c + b * M * CO + b * M + 2 * nw)
                  + b * (M + N))
        return bound(nbytes, 8 * pairs)
    flops = {"noop": 8 * pairs, "planes": pairs * (8 + 4 * H),
             "mm": (8 + 2 * c) * cand + 2 * c * pairs + 4 * int(qmask.sum()) * c * (co or 1)}[probe]
    return bound(tile_fwd_bytes(smp, src, c, co), flops)


def check_probe(probe, got, want, k5cnt, where) -> tuple[float, float]:
    """A K5 probe's ``(out, cnt)`` against its plain version's: the count
    K5's, noop's out 0, planes' and mm's within ``PROBE_RTOL`` of the largest
    output. Returns (max abs error, largest output)."""
    require(bool(torch.equal(got[1], k5cnt)), f"the {probe} probe's count at {where}")
    scale = float(want[0].abs().max())
    e = float((got[0] - want[0]).abs().max())
    if probe == "noop":
        require(scale == 0.0 and e == 0.0, f"the noop probe is not 0 at {where}")
    else:
        require(scale > 0 and e <= PROBE_RTOL * scale,
                f"the {probe} probe at {where}: {e:.3e} of {scale:.3e} from its plain version")
    return e, scale


def check_bwd_noop(got, want, where, packed=None) -> None:
    """The bwd_noop probe's gradients (and K6p's, ``packed``): every one 0,
    in the shapes of its plain version's."""
    names = ("d_wf", "dw1", "db1", "dw2", "db2")
    for gname, a, a2, w in zip(names, got, packed or got, want):
        require(tuple(a.shape) == tuple(w.shape) and bool(torch.equal(a, w))
                and bool(torch.equal(a2, w)),
                f"the bwd_noop probe's {gname} is not 0 at {where}")


def check_tile_probes(dev, hier, tile_pairs) -> dict:
    """The K5 probes (noop, planes, mm) and K6's bwd_noop at the four tile
    sites of the block batch: each against its plain version, the K5p / K6p
    probes bit for bit against the K5 / K6 ones, bit for bit on repeat, the
    count K5's; times, plain times and bounds."""
    from mccnn_tpu_torch.ops.cuda import density_kernel, tile_conv

    gen = torch.Generator().manual_seed(SEED + 17)
    rows = {k: [0.0, 0.0, 0.0, 0.0, "operations"]
            for k in [f"K5 probe {p}" for p in FWD_PROBES] + ["K6 bwd_noop"]}
    for name, i, o, radius, c, co in SEG_SITES:
        (src, smask), (smp, qmask) = hier[i], hier[o]
        b, N = smp.shape[0], src.shape[1]
        CO = c if co is None else co
        params = site_params(gen, c, co, dev)
        feats = (torch.ones((b, N, 1)) if c == 1 else
                 torch.randn((b, N, c), generator=gen)).to(dev)
        parts = []
        with torch.no_grad():
            pdf = density_kernel.kde_density_reference(src, smask, radius)
            max_pairs = tile_pairs if 0 in (i, o) else 1 << 30
            lay = tile_conv.conv_layout(smp, qmask, src, smask, radius, max_pairs=max_pairs,
                                        backward=True)
            require(int(lay.overflow.max()) == 0, f"the layout overflowed at {name}")
            wf = tile_conv._sorted_weighted_features(lay, feats, pdf)
            kw = dict(c_out=co)
            _, k5cnt = tile_conv.tile_conv_sorted_cuda(params, lay, wf, radius, **kw)
            pairs, cand = inr_pairs(smp, qmask, src, smask, radius), step_pairs(lay)
            for probe in FWD_PROBES:
                args = (probe, params, lay, wf, radius)
                got = tile_conv.tile_conv_probe_sorted_cuda(*args, **kw)
                again = tile_conv.tile_conv_probe_sorted_cuda(*args, **kw)
                packed = tile_conv.tile_conv_probe_sorted_packed_cuda(*args, **kw)
                want = tile_conv.tile_conv_probe_sorted_reference(*args, **kw)
                torch.cuda.synchronize()
                for a, r in ((again, "a second call"), (packed, "its K5p probe")):
                    require(bool(torch.equal(got[0], a[0]) and torch.equal(got[1], a[1])),
                            f"the {probe} probe differs from {r} at {name}")
                e, scale = check_probe(probe, got, want, k5cnt, name)
                ms = time_ms(lambda: tile_conv.tile_conv_probe_sorted_cuda(*args, **kw), iters=10)
                pms = time_ms(lambda: tile_conv.tile_conv_probe_sorted_reference(*args, **kw),
                              iters=1)
                bms, by = probe_bound(probe, smp, qmask, src, c, co, pairs, cand)
                r = rows[f"K5 probe {probe}"]
                r[0], r[1], r[2], r[3], r[4] = max(r[0], e), r[1] + ms, r[2] + pms, r[3] + bms, by
                parts.append(f"{probe} err={e:.3e}/{scale:.3e} ms={ms:.4f} plain_ms={pms:.4f} "
                             f"bound_ms={bms:.6f} ({by})")
            dout = torch.randn((b, lay.smp.shape[1], CO), generator=gen).to(dev)
            bargs = (params, lay, wf, radius, k5cnt, dout)
            got = tile_conv.tile_conv_backward_noop_sorted_cuda(*bargs, **kw)
            packed = tile_conv.tile_conv_backward_noop_sorted_packed_cuda(*bargs, **kw)
            want = tile_conv.tile_conv_backward_noop_sorted_reference(*bargs, **kw)
            torch.cuda.synchronize()
            check_bwd_noop(got, want, name, packed)
            ms = time_ms(lambda: tile_conv.tile_conv_backward_noop_sorted_cuda(*bargs, **kw),
                         iters=5)
            pms = time_ms(lambda: tile_conv.tile_conv_backward_noop_sorted_reference(*bargs, **kw),
                          iters=5)
            bms, by = probe_bound("bwd_noop", smp, qmask, src, c, co, pairs, cand)
            r = rows["K6 bwd_noop"]
            r[1], r[2], r[3], r[4] = r[1] + ms, r[2] + pms, r[3] + bms, by
            parts.append(f"bwd_noop zero ms={ms:.4f} plain_ms={pms:.4f} bound_ms={bms:.6f} ({by})")
        print(f"probes B={b} {name} N={N} M={smp.shape[1]} C={c} CO={co}: Tm={lay.steps.Tm} "
              f"S={lay.S} in_radius_pairs={pairs} candidate_pairs={cand}; packed_bit_equal=True "
              f"bitwise_repeatable=True; " + "; ".join(parts), flush=True)
    return {k: (*r[:4], r[4], None) for k, r in rows.items()}


def run_tile_roofline() -> dict:
    """``tools.tile_roofline`` at its default scene: its table, with the
    probes' launch counters (and K5's, K6's) moving in its run; in the same
    counted window each probe once more on the tool's layout, held against
    its plain version there."""
    from mccnn_tpu_torch.ops.cuda import tile_conv
    from mccnn_tpu_torch.tools import tile_roofline

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    case = tile_roofline.run(TILE_ROOFLINE_N, iters=2, reps=2)["case"]
    where = f"tools.tile_roofline's {TILE_ROOFLINE_N}-point scene"
    args = (case["params"], case["lay"], case["wf"], case["radius"])
    parts = []
    with torch.no_grad():
        for probe in FWD_PROBES:
            got = tile_conv.tile_conv_probe_sorted_cuda(probe, *args)
            want = tile_conv.tile_conv_probe_sorted_reference(probe, *args)
            e, scale = check_probe(probe, got, want, case["cnt"], where)
            parts.append(f"{probe} err={e:.3e}/{scale:.3e}")
        bargs = (*args, case["cnt"], case["dout"])
        check_bwd_noop(tile_conv.tile_conv_backward_noop_sorted_cuda(*bargs),
                       tile_conv.tile_conv_backward_noop_sorted_reference(*bargs), where)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"tools.tile_roofline probes against their plain versions at {where}: "
          + "; ".join(parts) + "; bwd_noop zero", flush=True)
    print(f"tools.tile_roofline {TILE_ROOFLINE_N}: {time.perf_counter() - t0:.2f} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    for kid in ["K5", "K6", "K6 bwd_noop"] + [f"K5 probe {p}" for p in FWD_PROBES]:
        require(counts[kid] > 0, f"{kid} was not launched by tools.tile_roofline")
    return counts


def t1_bound(variant: str, inr: int) -> tuple[float, str]:
    """T1 ``variant``'s least time: its function's bytes and operations
    (``tools.dense_breakdown``'s ``t1_bytes`` / ``t1_ops``) with ``inr`` of
    the tool's pairs within the radius."""
    from mccnn_tpu_torch.tools import dense_breakdown as db

    return bound(db.t1_bytes(variant), db.t1_ops(variant, db.B * db.M * db.N, inr))


def check_t1(dev) -> dict:
    """T1's variants at the tool's shapes against their plain versions, bit
    for bit on repeat; times, plain times, bounds, and the library calls:
    the tool's ``xla_equiv`` (torch.matmul) for mm_only and mm_big, one
    ``torch.full`` of w2[0, 0] for noop. noop, mm_only and mm_big (the staged
    schedule) and the library calls also get their device time (calls
    replayed from a CUDA graph: ``tools.device_ms``), the kernels' with the
    wrapper's bf16 cast and alone; noop beside the bytes it stages, mm_only
    beside the walked floor of its (H+1) fp32 contractions (its kernel alone
    may not beat it) and ``xla_equiv``, mm_big beside the walked floor of
    its contractions at the bf16 tensor-core peak and its ratios to
    ``xla_equiv`` and mm_only."""
    from mccnn_tpu_torch.ops.cuda import dense_probe
    from mccnn_tpu_torch.tools import PEAK_BF16_FLOP_PER_S, device_ms
    from mccnn_tpu_torch.tools import dense_breakdown as db

    pts, feats, w1, b1, w2, b2 = db.inputs(dev)
    fzb = feats.to(torch.bfloat16)
    args = (pts, feats, w1, b1, w2, b2, db.RADIUS)
    xla = lambda: dense_probe.xla_equiv(pts, feats, w2)  # noqa: E731
    lms, lib_dev = time_ms(xla, iters=5), device_ms(xla)
    fill = float(w2[0, 0])
    full = lambda: torch.full(tuple(feats.shape), fill, device=dev)  # noqa: E731
    full_ms, full_dev = time_ms(full, iters=10), device_ms(full, iters=10)
    print(f"T1 library calls: xla_equiv call_ms={lms:.4f} device_ms={lib_dev:.4f}; torch.full "
          f"call_ms={full_ms:.4f} device_ms={full_dev:.4f}", flush=True)
    inr = db.in_radius_pairs(pts)
    pairs = db.B * db.M * db.N
    rows, dev_ms = {}, {}
    with torch.no_grad():
        for v in dense_probe.VARIANTS:
            got = dense_probe.dense_probe_cuda(v, *args)
            again = dense_probe.dense_probe_cuda(v, *args)
            want = dense_probe.dense_probe_reference(v, *args)
            torch.cuda.synchronize()
            require(bool(torch.equal(got, again)), f"T1 {v} differs between two calls")
            scale = float(want.abs().max())
            e = float((got - want).abs().max())
            require(scale > 0 and e <= T1_RTOL * scale,
                    f"T1 {v}: {e:.3e} of {scale:.3e} from its plain version")
            ms = time_ms(lambda: dense_probe.dense_probe_cuda(v, *args), iters=10)
            pms = time_ms(lambda: dense_probe.dense_probe_reference(v, *args), iters=1)
            bms, by = t1_bound(v, inr)
            lib = lms if v in ("mm_only", "mm_big") else full_ms if v == "noop" else None
            rows[f"T1 {v}"] = (e, ms, pms, bms, by, lib)
            line = (f"T1 {v} B={db.B} N=M={db.N} C={db.C} r={db.RADIUS} in_radius={inr}: "
                    f"max_abs_err={e:.3e} max_abs_out={scale:.3e} bitwise_repeatable=True "
                    f"kernel_ms={ms:.4f} plain_ms={pms:.4f} bound_ms={bms:.6f} ({by}) "
                    f"library_ms={lib}")
            if v in ("noop", "mm_only", "mm_big"):
                with_cast = device_ms(lambda: dense_probe.dense_probe_cuda(v, *args), iters=10)
                dev_ms[v] = device_ms(lambda: dense_probe.dense_probe_cuda(v, pts, fzb, *args[2:]),
                                      iters=10)
                lib_d = full_dev if v == "noop" else lib_dev
                line += (f" device_ms={with_cast:.4f} kernel_alone_device_ms={dev_ms[v]:.4f} "
                         f"library_device_ms={lib_d:.4f}")
            if v == "noop":
                line += f" staged_bytes={dense_probe.staged_bytes(db.B, db.N, db.C, db.H)}"
            if v == "mm_only":
                floor = db.t1_floor(v, pairs, inr, walked=True)
                line += (f" walked_fp32_floor_ms={floor:.6f} ({db.t1_ops(v, pairs, inr, True)} "
                         f"fp32 operations) x_xla_equiv={dev_ms[v] / lib_dev:.4f} (device)")
                require(dev_ms[v] >= floor, f"T1 mm_only's kernel took {dev_ms[v]:.4f} ms, under "
                        f"the {floor:.4f} ms its walked fp32 contractions need: work was skipped")
            if v == "mm_big":
                walked = db.t1_ops(v, pairs, inr, walked=True)
                line += (f" walked_bf16_floor_ms={walked / PEAK_BF16_FLOP_PER_S * 1e3:.6f} "
                         f"({walked} tensor-core operations) x_xla_equiv={ms / lms:.4f} "
                         f"x_mm_only={ms / rows['T1 mm_only'][1]:.4f} (call); "
                         f"x_xla_equiv={dev_ms[v] / lib_dev:.4f} "
                         f"x_mm_only={dev_ms[v] / dev_ms['mm_only']:.4f} (device)")
            print(line, flush=True)
    return rows


def run_dense_breakdown() -> dict:
    """``tools.dense_breakdown``'s table, every T1 variant launched in its run.
    The counts are read after its call times, before its device times (CUDA
    graphs: a capture passes the wrappers' counters without launching, its
    replays launch without passing them)."""
    from mccnn_tpu_torch.tools import dense_breakdown

    counts = {}

    def calls_timed():
        torch.cuda.synchronize()
        counts.update(read_counts())

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    dense_breakdown.run(iters=2, reps=2, calls_timed=calls_timed)
    torch.cuda.synchronize()
    print(f"tools.dense_breakdown: {time.perf_counter() - t0:.2f} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    for kid in [k for k in counts if k.startswith("T1 ")] + ["K1", "K2", "K1p"]:
        require(counts[kid] > 0, f"{kid} was not launched by tools.dense_breakdown")
    return counts


# ------------------------------------------------------------ active bricks (K9a, K10a)


def active_pairs(gs, gp, active) -> int:
    """In-radius pairs of a visited sample and a source of a visited source
    brick: the plain forward's count over the sources as samples (C = 1)."""
    from mccnn_tpu_torch.core.mcconv import init_mcconv_params
    from mccnn_tpu_torch.ops.cuda import mcconv_kernel as mk

    dev = gs.positions.device
    params = init_mcconv_params(torch.Generator().manual_seed(0), 1, None, device=dev)
    ones = torch.ones((*gs.slot_of_point.shape, 1), device=dev)
    _, cnt = mk.bucket_conv_reference(params, mk._visited_samples(gp, active.src, active.bz),
                                      mk._visited_sources(gs, active.smp, active.bz), ones)
    return int(cnt.sum())


def check_active_pair(what, params, gs, gp, wf, active, gen, kw, lossless: bool,
                      timed: bool = False) -> dict:
    """K9a and K10a on ``active`` against their plain versions (and, when
    ``lossless``, bit for bit against K9 / K10, and on repeat), with exact
    zeros at the samples and sources of unvisited bricks; times, plain times
    and bounds when ``timed``."""
    from mccnn_tpu_torch.ops.cuda import mcconv_kernel as mk

    names = ("d_wf", "dw1", "db1", "dw2", "db2")
    co = kw["c_out"]
    with torch.no_grad():
        got, gcnt = mk.bucket_conv_active_cuda(params, gs, gp, wf, active, **kw)
        want, wcnt = mk.bucket_conv_active_reference(params, gs, gp, wf, active, **kw)
        torch.cuda.synchronize()
        e_f, s_f = float((got - want).abs().max()), float(want.abs().max())
        require(bool(torch.equal(gcnt, wcnt)), f"K9a neighbour counts differ at {what}")
        require(e_f <= BUCKET_RTOL * s_f, f"K9a disagrees with its plain version at {what}: "
                f"{e_f:.3e} of {s_f:.3e}")
        dropped = mk.kept_points(gs) & ~mk.visited_points(gs, active.smp, active.bz)
        require(bool((got[dropped] == 0).all()) and bool((gcnt[dropped] == 0).all()),
                f"K9a wrote a sample of an unvisited brick at {what}")
        dout = torch.randn(got.shape, generator=gen).to(got.device)
        args = (params, gs, gp, wf, gcnt, dout)
        gb = mk.bucket_conv_backward_active_cuda(*args, active, **kw)
        wb = mk.bucket_conv_backward_active_reference(*args, active, **kw)
        torch.cuda.synchronize()
        gone = mk.kept_points(gp) & ~mk.visited_points(gp, active.src, active.bz)
        require(bool((gb[0][gone] == 0).all()),
                f"K10a gave a source of an unvisited brick a gradient at {what}")
        e_b, parts = 0.0, []
        for name, a, w in zip(names, gb, wb):
            scale, e = float(w.abs().max()), float((a - w).abs().max())
            e_b = max(e_b, e)
            parts.append(f"{name} {e:.3e}/{scale:.3e}")
            require(e <= BUCKET_BWD_RTOL * scale, f"K10a {name} disagrees with its plain version "
                    f"at {what}: {e:.3e} of {scale:.3e}")
        if lossless:
            again, _ = mk.bucket_conv_active_cuda(params, gs, gp, wf, active, **kw)
            k9, k9cnt = mk.bucket_conv_cuda(params, gs, gp, wf, **kw)
            gb2 = mk.bucket_conv_backward_active_cuda(*args, active, **kw)
            k10 = mk.bucket_conv_backward_cuda(*args, **kw)
            torch.cuda.synchronize()
            require(bool(torch.equal(got, again)), f"K9a differs between two calls at {what}")
            require(bool(torch.equal(got, k9)) and bool(torch.equal(gcnt, k9cnt)),
                    f"K9a is not K9 bit for bit at {what}")
            for name, a, a2, k in zip(names, gb, gb2, k10):
                require(bool(torch.equal(a, a2)),
                        f"K10a {name} differs between two calls at {what}")
                require(bool(torch.equal(a, k)), f"K10a {name} is not K10 bit for bit at {what}")
    res = dict(fwd_err=e_f, bwd_err=e_b, dropped_samples=int(dropped.sum()),
               dropped_sources=int(gone.sum()))
    line = (f"K9a / K10a {what} NBA={active.smp.nba} BZ={active.bz}: K9a max_abs_err={e_f:.3e} "
            f"of {s_f:.3e}, K10a (err/scale) {', '.join(parts)}; samples of unvisited bricks "
            f"{res['dropped_samples']}, sources {res['dropped_sources']} (all exact 0)"
            + ("; bit for bit K9 / K10 and on repeat" if lossless else ""))
    if timed:
        b, M = gs.slot_of_point.shape
        c = wf.shape[-1]
        vq = int(mk.visited_points(gs, active.smp, active.bz).sum())
        vp = int(mk.visited_points(gp, active.src, active.bz).sum())
        fargs, bargs = (params, gs, gp, wf, active), (*args, active)
        with torch.no_grad():
            res["ms"] = time_ms(lambda: mk.bucket_conv_active_cuda(*fargs, **kw), iters=10)
            res["k9_ms"] = time_ms(lambda: mk.bucket_conv_cuda(params, gs, gp, wf, **kw), iters=10)
            res["plain_ms"] = time_ms(lambda: mk.bucket_conv_active_reference(*fargs, **kw),
                                      iters=1)
            res["bwd_ms"] = time_ms(lambda: mk.bucket_conv_backward_active_cuda(*bargs, **kw),
                                    iters=5)
            res["k10_ms"] = time_ms(lambda: mk.bucket_conv_backward_cuda(*args, **kw), iters=5)
            res["bwd_plain_ms"] = time_ms(
                lambda: mk.bucket_conv_backward_active_reference(*bargs, **kw), iters=1)
        res["bound"] = bucket_fwd_bound(vq, int(mk.kept_points(gp).sum()), c, co,
                                        int(gcnt.sum()), vq)
        res["bwd_bound"] = bucket_bwd_bound(int(mk.kept_points(gs).sum()), vp, c, co,
                                            active_pairs(gs, gp, active), vq, vp)
        line += (f"; K9a {res['ms']:.4f} ms (K9 {res['k9_ms']:.4f}, plain {res['plain_ms']:.4f}, "
                 f"bound {res['bound'][0]:.6f} ({res['bound'][1]})); K10a {res['bwd_ms']:.4f} ms "
                 f"(K10 {res['k10_ms']:.4f}, plain {res['bwd_plain_ms']:.4f}, bound "
                 f"{res['bwd_bound'][0]:.6f} ({res['bwd_bound'][1]}))")
    print(line, flush=True)
    return res


def active_small_case(dev, gen):
    """B = 4 clouds of 512 sources in boxes of 1, 2, 4 and 8 bricks (so other
    occupied counts; the smaller boxes overflow their cells), the first 160
    as samples, r = 0.2 (R = 6), caps 16 / 32 (BZ = 2, 27 bricks), C = 16 ->
    32 (the full conv)."""
    from mccnn_tpu_torch.core.buckets import build_buckets
    from mccnn_tpu_torch.ops.cuda import mcconv_kernel as mk

    rng = np.random.default_rng(SEED + 30)
    edge = np.array([[0.35, 0.35, 0.35], [0.75, 0.35, 0.35], [0.75, 0.75, 0.35],
                     [0.75, 0.75, 0.75]], np.float32)[:, None, :]
    src = torch.from_numpy((rng.uniform(0, 1, (ACTIVE_SMALL_B, 512, 3)) * edge).astype(np.float32))
    smask = torch.ones((ACTIVE_SMALL_B, 512), dtype=torch.bool)
    smask[:, -30:] = False
    src, smask = src.to(dev), smask.to(dev)
    gp = build_buckets(src, smask, 0.2, 32)
    gs = build_buckets(src[:, :160].contiguous(), smask[:, :160].contiguous(), 0.2, 16)
    params = site_params(gen, 16, 32, dev)
    feats = torch.randn((ACTIVE_SMALL_B, 512, 16), generator=gen).to(dev)
    pdf = (torch.rand((ACTIVE_SMALL_B, 512), generator=gen) + 0.5).to(dev)
    wf = torch.where(mk.kept_points(gp)[..., None], feats / pdf[..., None], 0.0)
    return params, gs, gp, wf


def check_active_bricks(dev) -> dict:
    """K9a / K10a: (a) at ``tools.bucket_32k``'s scene with cap 64 and NBA =
    its occupied bricks (lossless), against their plain versions and bit for
    bit against K9 / K10, timed; (b) there at a lossy NBA against their plain
    versions, the dropped samples and sources exact zeros; (c) the full conv
    (``c_out``, the mean both ways) at a B = 4 case whose clouds occupy
    different numbers of bricks."""
    from mccnn_tpu_torch.ops.cuda import mcconv_kernel as mk
    from mccnn_tpu_torch.tools import bucket_32k

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 30)
    s = bucket_32k.scene(dev, ACTIVE_CAP)
    grid, params = s["grid"], s["params"]
    wf = torch.where(mk.kept_points(grid)[..., None], s["feats"] / s["pdf"][..., None], 0.0)
    occupied = mk.count_active_bricks(grid).tolist()
    bz = mk.pick_bz(grid.res, ACTIVE_CAP)
    print(f"tools.bucket_32k's scene N={bucket_32k.N} r={bucket_32k.RADIUS} cap={ACTIVE_CAP}: "
          f"R={grid.res} BZ={bz} bricks={mk.n_bricks(grid.res, bz)} occupied={occupied} "
          f"overflow={int(grid.overflow.sum())}", flush=True)
    require(occupied == [ACTIVE_NBA] and int(grid.overflow.sum()) == 0,
            f"the 32k scene at cap {ACTIVE_CAP}: occupied {occupied}, "
            f"overflow {int(grid.overflow.sum())}")
    kw = dict(c_out=None, mean_normalize=False)
    row = check_active_pair("32k scene", params, grid, grid, wf,
                            mk.active_bricks(grid, grid, ACTIVE_NBA), gen, kw, lossless=True,
                            timed=True)
    lossy = check_active_pair("32k scene (lossy)", params, grid, grid, wf,
                              mk.active_bricks(grid, grid, ACTIVE_LOSSY_NBA), gen, kw,
                              lossless=False)
    require(lossy["dropped_samples"] > 0 and lossy["dropped_sources"] > 0,
            f"NBA={ACTIVE_LOSSY_NBA} dropped nothing")
    params4, gs, gp, wf4 = active_small_case(dev, gen)
    counts = [mk.brick_occupancy(g, mk.pick_bz(6, 16)).sum(dim=-1).tolist() for g in (gs, gp)]
    nba = max(max(c) for c in counts)
    print(f"B={ACTIVE_SMALL_B} case: occupied bricks per cloud sample {counts[0]} source "
          f"{counts[1]}, lossless NBA={nba}", flush=True)
    require(len(set(counts[1])) == ACTIVE_SMALL_B, "the B=4 clouds occupy equal brick counts")
    for mean in (False, True):
        check_active_pair(f"B={ACTIVE_SMALL_B} full conv 16->32 mean={mean}", params4, gs, gp,
                          wf4, mk.active_bricks(gs, gp, nba), gen,
                          dict(c_out=32, mean_normalize=mean), lossless=True)
    print(f"active bricks checks: {time.perf_counter() - t0:.2f} s", flush=True)
    bound_f, bound_b = row["bound"], row["bwd_bound"]
    return {"K9a": (row["fwd_err"], row["ms"], row["plain_ms"], bound_f[0], bound_f[1], None),
            "K10a": (row["bwd_err"], row["bwd_ms"], row["bwd_plain_ms"], bound_b[0], bound_b[1],
                     None)}


def run_bucket_32k(nba: int) -> dict:
    """``python -m mccnn_tpu_torch.tools.bucket_32k 64 <nba>`` as a child
    process: its printed counters must show K9a / K10a and not K9 / K10
    when 0 < nba < the brick count, and the reverse at 0."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mccnn_tpu_torch.tools.bucket_32k", str(ACTIVE_CAP), str(nba)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=600)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"tools.bucket_32k {ACTIVE_CAP} {nba} failed "
            f"({proc.returncode}): {proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        print(f"  bucket_32k {ACTIVE_CAP} {nba}: {line}", flush=True)
    line = [x for x in proc.stdout.splitlines() if x.startswith("launches ")]
    require(len(line) == 1, f"tools.bucket_32k printed no counters: {proc.stdout[-2000:]}")
    counts = json.loads(line[0][len("launches "):])
    print(f"tools.bucket_32k {ACTIVE_CAP} {nba} (child process): {seconds:.2f} s, launches "
          f"{counts}", flush=True)
    on, off = (("K9a", "K10a"), ("K9", "K10")) if nba else (("K9", "K10"), ("K9a", "K10a"))
    for kid in on:
        require(counts[kid] > 0, f"{kid} was not launched by tools.bucket_32k {ACTIVE_CAP} {nba}")
    for kid in off:
        require(counts[kid] == 0, f"{kid} was launched by tools.bucket_32k {ACTIVE_CAP} {nba}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mccnn_tpu_torch.ops.cuda import _build
    from mccnn_tpu_torch.tools import card_line

    card = card_line()
    print("card:", card, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "python",
          sys.version.split()[0], flush=True)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    lib = _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s): {lib.path}", flush=True)
    for line in lib.log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip(), flush=True)

    check_kernels(dev, SERVE_B)
    results = check_kernels(dev, TRAIN_B)
    k3_rows = check_poisson_sites(dev)
    check_backward(dev, SERVE_B)
    results["K2"] = check_backward(dev, TRAIN_B)
    shapenet_rows = check_shapenet_sites(dev)
    serve_launches = serve(dev)
    for b in (SERVE_B, TRAIN_B):
        check_train_step(dev, b)
    train_launches = run_trainer()
    tile_results = check_tile_kernels(dev)
    check_mcseg(dev)
    profile_mcseg(dev)
    profile_mcseg_train(dev)
    check_mcseg_train_step(dev)
    seg_launches = {"scannet_blocks": run_scannet(whole=False),
                    "scannet_whole": run_scannet(whole=True),
                    "scannet_train": run_scannet_train()}
    switch_launches = run_tile_switch_trainers()
    bucket_results = check_bucket_kernels(dev)
    bucket_serve = serve_mcseg_bucket(dev)
    reset_counts()
    check_mcseg_train_step(dev, bucket=True)
    bucket_launches = {"mcseg_bucket_serve": bucket_serve,
                       "mcseg_bucket_train_step": read_counts(),
                       "mcseg_bucket_train": train_mcseg_bucket(dev),
                       "modelnet_4096": run_modelnet_bucket()}

    check_v1_kernels(dev, SERVE_B, timed=False)
    v1_results = check_v1_kernels(dev, TRAIN_B, timed=True)
    zoo_serve = serve_zoo(dev)
    zoo_step = check_zoo_train_steps(dev)
    zoo_launches = {f"{name}_serve": zoo_serve[name] for name in ZOO}
    zoo_launches |= {f"{name}_train_step": zoo_step[name] for name in ZOO}
    zoo_launches["MCClass_train"], mcclass_ms = run_zoo_trainer("MCClass")
    zoo_launches["MCClassH_train"], _ = run_zoo_trainer("MCClassH", ("--protocol", "gradient"))
    v1_launches = {"MCClass_train_v1": run_dense_switch_trainer(
        "MCCNN_DENSE_V1", "1", "_USE_V1", ("K1v1", "K2v1"), ("K1", "K2"), mcclass_ms)}

    sweep_results = check_sweep_variants(dev, TRAIN_B, ("MCNorm", "MCNormS", "ShapeNet MCSeg",
                                                         "MCClassS"))
    check_sweep_variants(dev, SERVE_B, ("MCClassS",))
    norm_launches = {"MCNorm_serve": serve_mcnorm(dev)}
    norm_launches |= {f"{k}_train_step": v for k, v in check_norm_seg_train_steps(dev).items()}
    norm_launches["normals_train"] = run_task_trainer("normals")
    norm_launches["normals_MCNormS_train"] = run_task_trainer("normals", ("--model", "MCNormS"))
    norm_launches["shapenet_train"] = run_task_trainer("shapenet")
    sweep_launches = run_sweep_variant_trainers()

    check_planes_kernels(dev, SERVE_B, timed=False)
    planes_rows = check_planes_kernels(dev, TRAIN_B, timed=True)
    planes_launches = {"MCClass_train_planes": run_dense_switch_trainer(
        "MCCNN_DENSE_PLANES", "mxu", "_PLANES_MXU", ("K1p", "K2"), ("K1", "K1v1", "K2v1"),
        mcclass_ms)}
    roofline_launches = {"tile_roofline": run_tile_roofline()}
    t1_results = check_t1(dev)
    breakdown_launches = {"dense_breakdown": run_dense_breakdown()}
    active_results = check_active_bricks(dev)
    active_launches = {f"bucket_32k_{ACTIVE_CAP}_{ACTIVE_NBA}": run_bucket_32k(ACTIVE_NBA),
                       f"bucket_32k_{ACTIVE_CAP}_0": run_bucket_32k(0)}

    meta = {
        "K1": ("dense_mc_conv", "mccnn_tpu_torch/csrc/dense_conv.cu",
               "mccnn_tpu/ops/pallas/dense_conv.py:360"),
        "K2": ("dense_mc_conv_backward", "mccnn_tpu_torch/csrc/dense_conv_bwd.cu",
               "mccnn_tpu/ops/pallas/dense_conv.py:422"),
        "K3": ("poisson_sweep", "mccnn_tpu_torch/csrc/poisson_kernel.cu",
               "mccnn_tpu/ops/pallas/poisson_kernel.py:41"),
        "K4": ("kde_density", "mccnn_tpu_torch/csrc/density_kernel.cu",
               "mccnn_tpu/ops/pallas/density_kernel.py:34"),
        "K5": ("tile_mc_conv", "mccnn_tpu_torch/csrc/tile_conv.cu",
               "mccnn_tpu/ops/pallas/tile_conv.py:525"),
        "K6": ("tile_mc_conv_backward", "mccnn_tpu_torch/csrc/tile_conv_bwd.cu",
               "mccnn_tpu/ops/pallas/tile_conv.py:658"),
        "K7": ("tile_kde", "mccnn_tpu_torch/csrc/tile_sweep.cu",
               "mccnn_tpu/ops/pallas/tile_conv.py:1401"),
        "K8": ("tile_cover_counts", "mccnn_tpu_torch/csrc/tile_sweep.cu",
               "mccnn_tpu/ops/pallas/tile_conv.py:1553"),
        "K9": ("bucket_mc_conv", "mccnn_tpu_torch/csrc/bucket_conv.cu",
               "mccnn_tpu/ops/pallas/mcconv_kernel.py:293"),
        "K10": ("bucket_mc_conv_backward", "mccnn_tpu_torch/csrc/bucket_conv_bwd.cu",
                "mccnn_tpu/ops/pallas/mcconv_kernel.py:366"),
        "K1v1": ("dense_mc_conv_v1", "mccnn_tpu_torch/csrc/dense_conv_v1.cu",
                 "mccnn_tpu/ops/pallas/dense_conv.py:99"),
        "K2v1": ("dense_mc_conv_v1_backward", "mccnn_tpu_torch/csrc/dense_conv_v1_bwd.cu",
                 "mccnn_tpu/ops/pallas/dense_conv.py:129"),
        "K3v2": ("poisson_sweep_v2", "mccnn_tpu_torch/csrc/poisson_sweep_v2.cu",
                 "mccnn_tpu/ops/pallas/poisson_kernel.py:105"),
        "K3v3": ("poisson_sweep_v3", "mccnn_tpu_torch/csrc/poisson_sweep_v3.cu",
                 "mccnn_tpu/ops/pallas/poisson_kernel.py:293"),
        "K3v4": ("poisson_sweep_v4", "mccnn_tpu_torch/csrc/poisson_sweep_v4.cu",
                 "mccnn_tpu/ops/pallas/poisson_kernel.py:171"),
        "K5p": ("tile_mc_conv_packed", "mccnn_tpu_torch/csrc/tile_conv_packed.cu",
                "mccnn_tpu/ops/pallas/tile_conv.py:525"),
        "K6p": ("tile_mc_conv_backward_packed", "mccnn_tpu_torch/csrc/tile_conv_packed.cu",
                "mccnn_tpu/ops/pallas/tile_conv.py:658"),
        "K6v1": ("tile_mc_conv_backward_v1", "mccnn_tpu_torch/csrc/tile_conv_bwd_v1.cu",
                 "mccnn_tpu/ops/pallas/tile_conv.py:825"),
    }
    kernels = []
    for kid, (name, source, replaces) in meta.items():
        if kid in TILE_SWITCH_KERNELS:  # ScanNet shapes: the switched child trainers
            rows, paths, batch = [tile_results[kid]], switch_launches, SEG_B
        elif kid in tile_results:  # ScanNet shapes: eval and training
            rows, paths, batch = [tile_results[kid]], seg_launches, SEG_B
        elif kid in bucket_results:  # MCSeg's block batch and modelnet --points 4096
            rows, paths, batch = [bucket_results[kid]], bucket_launches, [SEG_B, TRAIN_B]
        elif kid in v1_results:  # the zoo's 14 dense sites at the trainer's batch
            rows, paths, batch = v1_results[kid], v1_launches, TRAIN_B
        elif kid in sweep_results:  # MCNorm's two sweeps at the trainer's batch
            variant = SWEEP_VARIANTS[kid][1]
            rows, batch = sweep_results[kid], TRAIN_B
            paths = {f"normals_train_{variant}": sweep_launches[f"normals_train_{variant}"]}
        else:
            rows = results[kid]
            paths = {"train": train_launches}
            batch = TRAIN_B
        by_path = {k: v[kid] for k, v in {"serve": serve_launches, "train": train_launches,
                                          **seg_launches, **switch_launches,
                                          **bucket_launches, **zoo_launches,
                                          **v1_launches, **norm_launches,
                                          **sweep_launches}.items()}
        lib_ms = [r[5] for r in rows]
        kernels.append({
            "name": f"{kid} {name}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(v[kid] for v in paths.values()),
            "launches_by_path": by_path,
            "batch": batch,
            "max_abs_err": max(r[0] for r in rows),
            "ms": sum(r[1] for r in rows),
            "plain_ms": sum(r[2] for r in rows),
            "bound_ms": sum(r[3] for r in rows),
            "bound_by": max(rows, key=lambda r: r[3])[4],
            "library_ms": sum(lib) if (lib := [x for x in lib_ms if x is not None]) else None,
        })
    # the roofline instruments: (id, name, source, replaces, rows, launch paths, batch)
    t1_lines = {"mm_only": 96, "vpu_only": 110, "replica": 131, "h1": 153, "noop": 182,
                "mm_big": 200, "fwd_bf16": 234}
    roofline = [("K1p", "dense_mc_conv_planes", "mccnn_tpu_torch/csrc/dense_conv_planes.cu",
                 "mccnn_tpu/ops/pallas/dense_conv.py:314", planes_rows, planes_launches, TRAIN_B)]
    roofline += [(f"K5 probe {p}", f"tile_mc_conv_probe_{p}",
                  "mccnn_tpu_torch/csrc/tile_conv_probe.cu", "mccnn_tpu/ops/pallas/tile_conv.py:575",
                  [tile_results[f"K5 probe {p}"]], roofline_launches, SEG_B) for p in FWD_PROBES]
    roofline += [("K6 bwd_noop", "tile_mc_conv_backward_noop",
                  "mccnn_tpu_torch/csrc/tile_conv_bwd_probe.cu",
                  "mccnn_tpu/ops/pallas/tile_conv.py:718", [tile_results["K6 bwd_noop"]],
                  roofline_launches, SEG_B)]
    t1_sources = {"mm_big": "dense_probe_mm_big.cu", "noop": "dense_probe_staged.cu",
                  "mm_only": "dense_probe_staged.cu"}
    roofline += [(f"T1 {v}", f"dense_probe_{v}",
                  f"mccnn_tpu_torch/csrc/{t1_sources.get(v, 'dense_probe.cu')}",
                  f"tools/exp_dense_breakdown.py:{line}", [t1_results[f"T1 {v}"]],
                  breakdown_launches, SERVE_B) for v, line in t1_lines.items()]
    roofline += [("K9a", "bucket_mc_conv_active", "mccnn_tpu_torch/csrc/bucket_conv.cu",
                  "mccnn_tpu/ops/pallas/mcconv_kernel.py:570",
                  [active_results["K9a"]], active_launches, 1),
                 ("K10a", "bucket_mc_conv_backward_active",
                  "mccnn_tpu_torch/csrc/bucket_conv_bwd.cu",
                  "mccnn_tpu/ops/pallas/mcconv_kernel.py:644",
                  [active_results["K10a"]], active_launches, 1)]
    for kid, name, source, replaces, rows, paths, batch in roofline:
        lib_ms = [r[5] for r in rows if r[5] is not None]
        kernels.append({
            "name": f"{kid} {name}", "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(v[kid] for v in paths.values()),
            "launches_by_path": {k: v[kid] for k, v in paths.items()},
            "batch": batch,
            "max_abs_err": max(r[0] for r in rows),
            "ms": sum(r[1] for r in rows),
            "plain_ms": sum(r[2] for r in rows),
            "bound_ms": sum(r[3] for r in rows),
            "bound_by": max(rows, key=lambda r: r[3])[4],
            "library_ms": sum(lib_ms) if lib_ms else None,
        })
    def line(name, source, replaces, rows, paths, batch) -> dict:
        """A row of the kernels line from ``rows`` of (err, ms, plain ms,
        bound ms, bound by, library ms) and the launches by path."""
        lib_ms = [r[5] for r in rows if r[5] is not None]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(paths.values()), "launches_by_path": paths, "batch": batch,
                "max_abs_err": max(r[0] for r in rows), "ms": sum(r[1] for r in rows),
                "plain_ms": sum(r[2] for r in rows), "bound_ms": sum(r[3] for r in rows),
                "bound_by": max(rows, key=lambda r: r[3])[4],
                "library_ms": sum(lib_ms) if lib_ms else None}

    shapenet_paths = {"shapenet_train": norm_launches["shapenet_train"]}
    for kid in ("K1", "K2"):  # ShapeNet's three 1024 -> 1024 sites at the trainer's batch
        name, source, replaces = meta[kid]
        kernels.append(line(f"{kid} {name} (ShapeNet stem, enc_0_1, dec_1_0)", source, replaces,
                            shapenet_rows[kid], {k: v[kid] for k, v in shapenet_paths.items()},
                            TRAIN_B))
    seg_paths = {k: v for k, v in {**seg_launches, **bucket_launches}.items()
                 if k != "modelnet_4096"}
    name, source, replaces = meta["K4"]  # MCSeg's seven KDE sites of the block batch
    kernels.append(line(f"K4 {name} (ScanNet block levels)", source, replaces,
                        tile_results["K4 ScanNet"], {k: v["K4"] for k, v in seg_paths.items()},
                        SEG_B))
    name, source, replaces = meta["K3"]  # the other default paths' dense sweeps, every level
    scannet = "levels 1-2: N = 1944, r = 0.15; N = 224, r = 0.4"
    for path, where, paths, batch in (
            ("ScanNet block batch", f"ScanNet block batch {scannet}",
             {k: v for k, v in seg_paths.items() if k != "scannet_whole"}, SEG_B),
            ("ScanNet scene", f"ScanNet scene {scannet}",
             {"scannet_whole": seg_launches["scannet_whole"]}, 1),
            ("ShapeNet", "ShapeNet levels 0-2: N = 1024, r = 0.025; N = 1024, r = 0.1; "
             "N = 496, r = 0.4", shapenet_paths, TRAIN_B),
            ("--points 4096", "tasks.modelnet --points 4096 levels 0-1: N = 4096, r = 0.1; "
             "N = 496, r = 0.4", {"modelnet_4096": bucket_launches["modelnet_4096"]}, TRAIN_B)):
        kernels.append(line(f"K3 {name} ({where})", source, replaces, k3_rows[path],
                            {k: v["K3"] for k, v in paths.items()}, batch))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
