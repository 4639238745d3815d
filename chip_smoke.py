#!/usr/bin/env python3
"""Drive the PyTorch port (``ehgr_tpu_torch``) on one CUDA GPU and check it.

Phases; any miss raises and the run exits nonzero:

1. build the CUDA kernels from the sources in this checkout, one ``nvcc``
   per source, all started together;
2. hold ``action_stats`` / ``action_apply`` against their plain versions at
   the eight ResNet-50 ACTION site shapes of the main path, at the served
   batch's 20 clips and at the train steps' 8 (the window kernel picks its
   frame group TG from the clip count), the 224^2 and the 256^2 (NvGesture
   test crop) sites at the test runner's 10, plus two ragged shapes, three
   more routes of ``action_apply``, two shapes at T=5 whose last frame
   group has masked frames and the sites of stages 3-4 at T=4 (as
   ``temporal_pool`` runs them) at 20 and 8 clips (each kernel's route,
   and the window kernel's TG and N, printed per shape), in fp32 (TF32
   off) and in bf16 (plain version in f32 from the same bf16 inputs),
   ``action_stats`` also bitwise equal over two calls; and measure how far
   the TPU kernel's bf16 running sum of ``pool`` would land from the f32
   sum kept here;
3. hold ``learnable_shift_fwd`` / ``learnable_shift_bwd`` (y, dx, dw)
   against autograd of the plain shift at the site shapes at 8 and at 20
   clips, the two ragged shapes, two shapes at T=5 and the stage 3-4 sites
   at T=4, fp32 and bf16, the backward's route (``strip``,
   ``csrc/shift_bwd.cu``, or ``sweep``) printed per shape and its dx and
   dw bitwise equal over two calls;
4. hold ``tsm_shift`` forward and reverse bitwise equal to the plain shift
   at the site shapes at 8 clips and two ragged shapes, fp32 and bf16; and
   ``action_prologue`` (x_shift, mc, pool, x3) against its plain version
   and over two calls as in 2;
5. serve: ``evaluate`` over ``make_score_fn`` on the full-width TSN + ACTION
   ResNet-50 (T=8, 224^2, 83 classes, bf16, ``action_fused='mega'``,
   weights drawn from a seeded ``torch.Generator``) for a few request
   batches of uint8 videos, with the kernels' launch counters zeroed just
   before and read just after (``action_stats`` on its window kernel,
   ``csrc/action_stats.cu``, and ``action_apply`` on its strip kernel,
   ``csrc/action_apply.cu``, at all 16 sites); then the logits against the
   plain path
   (``action_fused=None``) in fp32 and in bf16; one scorer call traced with
   ``torch.profiler`` (device time by kernel, idle share);
6. train, Stage 1: ``make_train_step(stage='mtmm')`` on the full-width
   ``tsn_mtmm`` (``action_fused='vjp'``: the four kernels forward and
   backward, every backward of the shift on its strip kernel; bf16
   compute, f32 params, 8 clips of uint8 rgb and depth,
   dropout 0.5 from a seeded generator) for a few steps, with the launch
   counters zeroed just before and read after each step; one train step
   traced; each ACTION site in training, kernel region against plain
   autograd, fp32; and one fp32 step's loss and gradients of the
   ``'vjp'`` model and the plain model against a float64 run;
7. TSM: the scorer on the full-width TSN + TSM ResNet-50 (16 ``tsm_shift``
   launches a forward), its probabilities against the plain shift's; a few
   ``make_train_step(stage='baseline')`` steps (16 forward + 16 reverse
   launches a step); each TSM site in training against plain autograd;
8. train, Stage 2: the trained ``tsn_mtmm`` into ``tsn_sd`` through
   ``merge_state_dict``, a few ``make_train_step(stage='sd')`` steps
   (``'vjp'``: 16 launches of each of the four kernels a step), and one
   fp32 SD step of both models against a float64 run;
9. deploy, Stage 2: the trained ``tsn_sd`` through the 4-head scorer in
   modes ``'prologue'`` (16 ``action_prologue`` launches a forward, all on
   its window kernel; one call traced) and ``'mega'``, the four heads
   against the plain model; ``tsn_middle1/2/3``
   loaded with ``merge_state_dict`` ('prologue': 3 / 7 / 13 launches), each
   against the SD model's exit;
10. the test protocol: ``run_test`` over the synthetic moving-patch
   videos (32 videos of 10 clips, one video a forward as the runner
   batches them), ``ego_baseline`` at 224^2 with ``--action_fused mega``
   on the serve model's weights read back from a ``.pth`` (16
   ``action_stats_window`` + 16 ``action_apply_strip`` launches a
   forward) and ``nv_sd`` at 256^2 with four heads in ``'prologue'`` (16
   ``action_prologue_window``), each with the loader alone and the scorer
   alone timed apart and the first batch's probabilities held against the
   plain model;
11. the trainers, at full width on the synthetic videos, each through its
   entry point, under a temporary run directory: ``cli.train_mtmm`` for 2
   epochs of 8 steps (validation of the live and the EMA weights, the
   ``latest`` / ``best`` / ``ema_best`` files), ``cli.train_sd`` for one
   epoch from the MTMM ``best`` (``--checkpoint_path``), ``run_training``
   resuming the MTMM ``latest`` with ``resume_full`` (the state restored
   bitwise, 8 more steps) and ``run_test`` on the config ``cli.test_sd``
   makes (``'prologue'``) on the SD ``best``; each train step launching the four kernels 16 times and
   validation none; clips/s of each epoch's train part, data and batch
   time, validation seconds, each checkpoint write's seconds and bytes and
   the restore's seconds; then one MTMM step without and with ``remat``:
   losses, gradients, BN statistics, peak memory and launches;
12. the joint stage and the TSN options: a few
   ``make_train_step(stage='mtmm_sd')`` steps on the full-width
   ``tsn_mtmm_sd`` (``modal='rgb_depth'``, 'vjp': 16 launches of each of
   the four kernels a step; the local decoder's 224^2 map and the global
   decoder's 56^2 one, which the loss reads; the first step's peak memory)
   and one fp32 step of both models against a float64 run; with
   ``temporal_pool`` (the 9 ACTION sites of stages 3-4 on T/2 = 4 frames)
   a few ``tsn`` steps (stage ``baseline``) and a 'mega' forward (16
   launches of each kernel) with its logits against the plain model, and
   both with ``before_softmax=False``; then ``cli.train_mtmm_sd`` for 2
   epochs of 8 steps warm-started from the MTMM ``best`` (the decoder keys
   it takes, skips and keeps from init as the code predicts them) and
   ``run_test`` as ``cli.test_sd`` configures it ('prologue') on the joint
   ``best``.  Then
   every (TG, N) of the window kernel that a main path launched (its sizes
   recorded at each launch) must be among those that phases 2 and 4 held
   against the plain version;
13. time each kernel, its plain version and a yardstick (the bare GEMM of
   the same ``[rows, C] x [C, F]`` (or ``x @ W_p3``) product for the ACTION
   kernels, the grouped ``conv3d`` and its backward for the learnable
   shift; none for the TSM shift) at each site shape with CUDA events,
   each ACTION kernel beside its route and launch grid; every kernel also
   on the device alone with its inputs cold in L2 (CUDA events around the
   call just after a 1 GiB write; each kernel's duration from a
   ``torch.profiler`` trace beside), the shift backward beside its route
   and strip geometry and its earlier design;
14. int8 inference (run beside the phases above): ``int8_conv`` (the
   implicit-GEMM int8 conv that quantizes the float activation on its way
   into shared memory, ``csrc/int8_conv.cu``, no Pallas counterpart) held
   bitwise to ``int8_conv_plain`` at the 15 site shapes of the 36 int8
   sites of ResNet-50 and at one site at T/2 = 4 frames, bf16 and f32
   activations, two kinds of data each, and on every finite bf16 value at
   three scales, right after the ACTION checks; ``int8_serve`` after the
   serve
   profile: the scorer on the serve model's weights with
   ``quantize='static'`` calibrated on the first request batch (36
   ``int8_conv`` + 16 + 16 ACTION launches a forward), its probabilities
   against the same model on ``int8_conv_plain`` and its logits' cosine
   against the float bf16 model's, then one batch in 'dynamic';
   ``int8_test`` after ``test_ego``: ``run_test`` on the config of ``cli.test
   --quantize static --action_fused mega`` over test_ego's videos and
   weights (calibrated on the first two loader batches: 2 more ACTION
   forwards), its 36 ``act_scale``s, the first batch against
   ``int8_conv_plain`` within test_ego's gate, its traced scorer call
   free of round passes (the quantize passes' kernels listed beside the
   kernel's), then ``cli.test --quantize dynamic``; each site shape timed
   in the timings phase beside its bound, the quantize passes the kernel
   took over, ``torch._int_mm`` (1x1 stride 1 only) and the bf16 cuDNN
   conv.

15. the serving surfaces (after ``loop_test_sd``, whose SD ``best`` they
   read): ``preprocess_eval_batch`` on the card against the port on the
   CPU at three camera geometries (square resize up and down, short side
   then centre crop); ``cli.export_serving --videos sym --action_fused
   mega`` on the serve model's weights, then ``--clip_scorer``,
   ``--quantize static`` and a TSM scorer, every artifact loaded in one
   fresh process that imports ``ehgr_tpu_torch.serve`` and no model code:
   the kernels' launches counted there (16 + 16 a 'mega' forward, 36 more
   for int8, 16 ``tsm_shift``), the graph's ``ehgr::*`` nodes, the
   probabilities against the live scorer, bytes, export and load seconds,
   clips/s loaded against live; ``cli.test_cascade --cascade_exit 1`` in
   'mega' and 'prologue' with each stage's launches counted apart, and the
   two-pass run against the sweep on the request batches;
   ``cli.stream_demo`` with ``--cascade_exit 0`` and ``1`` (fps, window
   latency, launches a window); and after the serve phase the custom ops'
   dispatch cost (``serve_dispatch``: the scorer with the ACTION kernels
   through their ops and through their CUDA implementations directly, in
   turns).

16. the other backbone families (``backbones``), each at full width, T=8,
   224^2, bf16, weights from the seed and BN statistics set from the first
   request batch: their ACTION kernels held against the plain versions at
   every new site shape (MobileNetV2's 10 sites, C = 24 ... 160, and
   Res2Net-50's 16, F = 104 ... 832, for ``action_stats`` /
   ``action_apply``; BN-Inception's 10 gates, C = 192 ... 1056, for
   ``action_prologue`` and ``tsm_shift``; the learnable shift at the new
   (S, C)); the request batches served in 'mega' (BN-Inception also in
   'prologue') with each route's launches a forward against the routes
   predicted (``BACKBONE_FORWARD``), clips/s, and the logits against the
   plain model (fp32 and bf16); two 'vjp' train steps of MobileNetV2 and
   Res2Net and one of BN-Inception (``BACKBONE_STEP``) and the fp32
   gradient gate against float64 with every BN on batch statistics.

17. the recipe's tools (``slice_checks`` first: the ACTION kernels and
   the learnable shift at the shapes below): ``cli.dress_rehearsal`` at
   its protocol defaults (224^2, T=8, 83 classes, 'vjp', 32 clips a step:
   MTMM, the SD transfer, SD, the 4-head test; 16 launches of each of the
   four kernels a step; each stage's wall, ms a step, first-step peak
   memory); ``cli.test_sd_actionnet`` on its SD ``best`` in 'prologue'
   (16 ``action_prologue`` a forward, the SD-head gate) and 'vjp' (equal
   to ``cli.test_sd``'s result); ``gradcam`` on the full-width ``tsn``
   and ``tsn_sd`` in fp32 at every exit, 'mega' against plain (the taps
   within TOL, each CAM's distance from a float64 plain run within WORST_X
   times the plain fp32 model's plus CAM_TOL, the same class), one call
   timed (``utils.profiling.time_fn``)
   and one traced (``utils.profiling.trace``, naming the ACTION kernels);
   ``case_study_scores`` on four synthetic test videos, 'mega' against
   plain; ``cli.reproduce --row ego_mtmm_sd --smoke`` (T=4, 32^2, S down
   to 1x1).

18. the last model families, none with a kernel on its path (each main
   path must launch none): ``video3d``, R(2+1)D-18 (T=8, 224^2, bf16)
   serving the request batches and SlowOnly-R50 the same, each after its
   fp32 logits on one clip against the port on the CPU (within 1e-3) and
   its bf16 logits' cosine to fp32 (>= 0.99); two ``r2plus1d_mtmm`` mtmm
   steps of 8 clips (ms a step, the first apart, first-step peak) and its
   fp32 gradient at 112^2 against a CPU float64 run in both BN settings,
   the CPU fp32 run the floor; ``cli.train_slowonly`` (2 steps of 8
   clips); ``videomae``, ViT-B/16 at T=16 (1568 tokens): the same gates,
   a bf16 forward of 8 clips and ``cli.train_videomae`` (2 steps, the
   first-step peak); ``dpt``, DPT-Large at 384^2 in fp32: one frame
   against the CPU (its depth checked non-degenerate first), a forward of
   8 frames, then ``midas_predictor`` on a MiDaS-keyed file saved from
   the model over four 480x640 frames (against the model's own depth) and
   ``generate_pseudo_depth_tree`` over them as JPEGs.

19. the mesh (``parallel/mesh.py``, ``mesh``): TSN + ACTION ResNet-50 at
   full width (T=8, 224^2, 8 clips a global batch), ranks launched by
   ``run_ranks``, each with its own launch counts: (a) data=2, model=1,
   two ranks sharing the card over gloo, 83 classes: one fp32 ``mtmm_sd``
   step's all-reduced gradients against a float64 one-process run by the
   rule of the fp32 gates above, its BN running statistics and loss
   against the one-process step's, bf16 steps timed beside one process;
   (b) data=1, model=2 at 16 classes (the heads shard): the same gate, the
   gathered checkpoint restored in one process bitwise, the sharded
   scorer ('mega') and the ``tsn_middle2`` deploy ('prologue') against the
   fp32 plain model by the bf16 logit rule; (c) NCCL, one rank (two where
   the machine has two cards).

Prints the kernel table as one JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  It needs one card;
without CUDA it exits nonzero before doing anything.

    python3 chip_smoke.py [--seed 0] [--parity-seeds 0,1,2,3,4,5]
                          [--int8-only]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np

T, CROP, CLASSES = 8, 224, 83
BATCHES, VIDEOS, CLIPS = 3, 2, 10       # requests of V videos x K clips
# (S, C, F, sites per forward) of the 16 ACTION sites of ResNet-50 at 224^2:
# each layer{i}_0 site runs at the previous stage's resolution
SITES = [(3136, 64, 64, 1), (3136, 256, 64, 2), (3136, 256, 128, 1),
         (784, 512, 128, 3), (784, 512, 256, 1), (196, 1024, 256, 5),
         (196, 1024, 512, 1), (49, 2048, 512, 2)]
# the same sites at NvGesture's 256^2 test crop (S = 64^2 / 32^2 / 16^2 /
# 8^2): no resize before the model, whose pooling adapts
NV_SITES = [(4096, 64, 64, 1), (4096, 256, 64, 2), (4096, 256, 128, 1),
            (1024, 512, 128, 3), (1024, 512, 256, 1), (256, 1024, 256, 5),
            (256, 1024, 512, 1), (64, 2048, 512, 2)]
# the test runner's clips a forward: max(1, 8 // clip_num) videos of the
# recipe's clip_num = 10 clips (ehgr_tpu_torch/eval/runner.py)
RUN_CLIPS = 10
# synthetic videos of the test phases: the factory tests on half of them,
# at least 32 (ehgr_tpu_torch/data/factory.py build_test_dataset)
RUN_VIDEOS = 64
# S off every tile size with Cr=8 and F under one tile; and C off the
# 8-channel rows the tensor-core sweep needs (bf16 then takes the FMA sweep)
RAGGED = [(1000, 128, 32), (50, 100, 24)]
# the routes of action_apply beyond the sites: S = 201 leaves the last
# 128-row strip ragged at F = 512 (two column blocks) on the strip kernel;
# S = 15 puts a 64-row strip in five or six frames, the rows past the
# fourth reading their gch from global memory; C = 72 (C % 64 != 0) takes
# the FMA sweep in bf16 (and so does action_stats)
ROUTE_SHAPES = [(201, 128, 512), (15, 64, 64), (50, 72, 40)]
# (T, S, C, F) off T = 8, each leaving masked frames in the window kernel's
# last frame group at the served batch's 20 clips: 980 strips of 64 rows
# take TG = 4 at Cr = 4 (frames 5-7 of the second group masked), 260 take
# TG = 2 at Cr = 32 (frame 5 of the third); the checks assert T % TG != 0
T_SHAPES = [(5, 3136, 64, 64), (5, 784, 512, 128)]
# (S, C, F, sites per forward) of the ACTION sites of stages 3-4, which run
# on T/2 frames under temporal_pool (layer3's 6 and layer4's 3 sites)
TPOOL_SITES = SITES[4:]
# bytes written before each device-only timed call of a shift kernel: over
# the card's 50 MB L2, so the call reads its inputs from device memory, as
# the train step finds them, and ~0.3 ms of writing, so the host has
# enqueued the call before the write ends
FLUSH_BYTES = 1 << 30
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 / fp32 FLOP/s
# and int8 operations/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# kernel vs plain, max |err| over max |plain|: fp32 differs only in
# summation order; bf16 also in two roundings to bf16 (2^-9 relative
# each): of the gated tile fed to the tensor cores, and of the output
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# shift kernels vs autograd of the plain shift, same measure.  fp32: y and
# dx differ only in the order of three products; dw in summation order over
# up to N*T*S = 200,704 rows (f32 per thread, a fixed-order sum of the block
# partials).  bf16: each output is rounded once to bf16 (2^-8 relative),
# dw too, since it leaves in w's dtype; its f32 sums add no more than the
# fp32 limit
SHIFT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# training batch: the recipe's 8 clips (sh/train_ego.sh), T=8, 224^2, depth
# targets at 56^2; steps timed and counted
TRAIN_CLIPS, TRAIN_STEPS, DEPTH_SIZE = 8, 5, 56
# the TSM shift's fold divisor (the model's shift_div), and (S, C) off the
# 16-byte vectors: C=100 moves one channel a thread in bf16, C=24 puts fold
# (3) and 2*fold (6) inside the first vector
FOLD_DIV = 8
TSM_RAGGED = [(50, 100), (1000, 24)]
# one ACTION site in training, 'vjp' (the kernel region) vs plain
# autograd, fp32: output and every gradient, max |diff| / max |plain|; the
# same math in another order (kernel sums, the region's matmul transposes)
SITE_TOL = 1e-4
# the full fp32 train step against a float64 run of the plain model: each
# parameter's gradient error (same measure); the kernel model's median and
# 95th percentile over the leaves within GRAD_X times the plain fp32
# model's, its worst leaf within WORST_X times the plain model's worst,
# each plus GRAD_TOL (see train_parity); the two fp32 losses within LOSS_TOL
GRAD_X, WORST_X, GRAD_TOL, LOSS_TOL = 1.5, 3.0, 1e-3, 1e-5
# logits of the 'mega' model vs the plain model, same measure (fp32), and
# how much further from fp32 the bf16 kernel outputs may be than the bf16
# plain ones (see compare_logits; the middle deploys are held the same way)
LOGIT_TOL = 1e-3
BF16_SLACK = 1.5
# the same for each of the SD model's four heads (see sd_deploy): over 24
# readings (3 runs, 2 modes, 4 heads; H100, PERF.md) the ratio to the plain
# model's bf16 error ranged 0.81-1.40, the final head the widest
HEADS_BF16_SLACK = 2.0
# bf16 probabilities of a before_softmax=False model: each frame's softmax
# rounded to bf16 (2^-9 relative a class), then averaged; how far a row's
# sum may sit from 1
BF16_SUM_TOL = 1e-2
# launches of one ACTION forward ('mega', or 'vjp' in a train step) and of
# one SD forward in 'prologue': every launch on the main path's route
MEGA_FORWARD = {"action_stats": 16, "action_stats_window": 16,
                "action_apply": 16, "action_apply_strip": 16}
PROLOGUE_FORWARD = {"action_prologue": 16, "action_prologue_window": 16}
# launches of the learnable shift in one MTMM or SD train step: every
# backward on the strip kernel
SHIFT_STEP = {"learnable_shift_fwd": 16, "learnable_shift_bwd": 16,
              "learnable_shift_bwd_strip": 16}
# the other backbones' temporal sites at 224^2: (S, C, F, sites a forward)
# of MobileNetV2's 10 ACTION sites (the residual expand convs, F = 6C) and
# Res2Net-50's 16 (every conv1, F = 4 x floor(planes x 26 / 64)), and
# (S, C, sites) of BN-Inception's 10 gates (the block inputs)
MBV2_SITES = [(3136, 24, 144, 1), (784, 32, 192, 2), (196, 64, 384, 3),
              (196, 96, 576, 2), (49, 160, 960, 2)]
RES2_SITES = [(3136, 64, 104, 1), (3136, 256, 104, 2), (3136, 256, 208, 1),
              (784, 512, 208, 3), (784, 512, 416, 1), (196, 1024, 416, 5),
              (196, 1024, 832, 1), (49, 2048, 832, 2)]
BNI_SITES = [(784, 192, 1), (784, 256, 1), (784, 320, 1), (196, 576, 3),
             (196, 608, 2), (49, 1056, 1), (49, 1024, 1)]
BACKBONES = ("mobilenet_v2", "res2net50", "bn_inception")
# the routes predicted for one bf16 forward in 'mega' (BN-Inception's gates
# take action_prologue, also in 'prologue'): window / strip need C % 64 ==
# 0 (and Cr % 4 == 0 for window), so MobileNetV2 has them at C = 64 only,
# BN-Inception at every C but 608 and 1056; Res2Net at all 16
BACKBONE_FORWARD = {
    "mobilenet_v2": {"action_stats": 10, "action_stats_window": 3,
                     "action_apply": 10, "action_apply_strip": 3},
    "res2net50": MEGA_FORWARD,
    "bn_inception": {"action_prologue": 10, "action_prologue_window": 7}}
# ... and of one bf16 'vjp' train step (the shift backward on strip at
# C % 64 == 0; BN-Inception's gates train through LearnableShift alone)
BACKBONE_STEP = {
    "mobilenet_v2": {**BACKBONE_FORWARD["mobilenet_v2"],
                     "learnable_shift_fwd": 10, "learnable_shift_bwd": 10,
                     "learnable_shift_bwd_strip": 3},
    "res2net50": {**SHIFT_STEP, **MEGA_FORWARD},
    "bn_inception": {"learnable_shift_fwd": 10, "learnable_shift_bwd": 10,
                     "learnable_shift_bwd_strip": 7}}
BACKBONE_STEPS = {"mobilenet_v2": 2, "res2net50": 2, "bn_inception": 1}
# the parameters (of a model's gradient keys) whose exact gradient is zero
# with every BN on batch statistics, held as BN_FED_BIASES are:
# MobileNetV2's last BN bias of each block whose output reaches only plain
# convs, each into a BN; BN-Inception's conv biases (each conv feeds its BN)
BACKBONE_ZERO_GRAD = {
    "mobilenet_v2": lambda keys: [
        f"base_model.features.{i}.conv.{7 if i > 1 else 4}.bias"
        for i in (1, 3, 6, 10, 13, 16, 17)],
    "bn_inception": lambda keys: [
        k for k in keys if k.endswith(".bias") and
        k[:-len(".bias")] + "_bn.weight" in keys]}
# the trainers' runs: synthetic videos to train on (8 steps of the recipe's
# 8 clips an epoch) and epochs of the MTMM run (the resume adds one)
LOOP_VIDEOS, LOOP_EPOCHS = 64, 2
LOOP_STEPS = LOOP_VIDEOS // TRAIN_CLIPS
# a step with remat against the same step without: each gradient's max
# |diff| over max |plain| (the recompute runs the same kernels on the same
# inputs; measured bitwise equal on the H100, PERF.md)
REMAT_GRAD_TOL = 1e-5
# the joint model's transposed convs whose output feeds a BN ('rgb_depth'):
# with that BN on batch statistics the bias's exact gradient is zero (the
# BN takes the channel's mean away), so the parity gate holds each within
# ZERO_GRAD_REL of its weight's largest gradient instead of against a
# float64 run's rounding noise: the fp32 sum that cancels leaves ~2^-24
# sqrt(M) / |x| of it over M = 12,544 outputs a channel, while a bias that
# moved the loss would sit near its weight's scale
BN_FED_BIASES = ("local_decoder.0.bias", "global_decoder.0.bias",
                 "global_decoder.2.bias")
ZERO_GRAD_REL = 1e-3
# the keys a Stage-1 file gives the joint model: the MTMM decoder's first
# BN (global_decoder.1.*, 256 channels) has the key and shape of the joint
# decoder's first BN; its other keys are absent or of another shape
JOINT_TAKEN = tuple(f"global_decoder.1.{leaf}" for leaf in
                    ("weight", "bias", "running_mean", "running_var"))
JOINT_SKIPPED = tuple(
    ["global_decoder.0.weight", "global_decoder.4.weight",
     "global_decoder.8.weight", "global_decoder.12.weight",
     "global_decoder.15.weight", "global_decoder.15.bias"] +
    [f"global_decoder.{i}.{leaf}" for i in (5, 9, 13) for leaf in
     ("weight", "bias", "running_mean", "running_var")])


# the 36 int8 sites of a TSN + ACTION ResNet-50 at 224^2 (ops/quantize.py;
# the ACTION conv1s, the stem and the head stay float): (site, Cin, Cout,
# kernel, stride, input H = W, sites a forward), 15 shapes
INT8_SITES = [("conv2", 64, 64, 3, 1, 56, 3),
              ("conv2", 128, 128, 3, 1, 28, 3),
              ("conv2", 256, 256, 3, 1, 14, 5),
              ("conv2", 512, 512, 3, 1, 7, 2),
              ("conv2", 128, 128, 3, 2, 56, 1),
              ("conv2", 256, 256, 3, 2, 28, 1),
              ("conv2", 512, 512, 3, 2, 14, 1),
              ("conv3", 64, 256, 1, 1, 56, 3),
              ("conv3", 128, 512, 1, 1, 28, 4),
              ("conv3", 256, 1024, 1, 1, 14, 6),
              ("conv3", 512, 2048, 1, 1, 7, 3),
              ("downsample", 64, 256, 1, 1, 56, 1),
              ("downsample", 256, 512, 1, 2, 56, 1),
              ("downsample", 512, 1024, 1, 2, 28, 1),
              ("downsample", 1024, 2048, 1, 2, 14, 1)]
# a stage-3 site at T/2 = 4 frames a clip, as temporal_pool runs it
INT8_TPOOL = INT8_SITES[2]
# launches of one int8 forward of that model ('mega')
INT8_FORWARD = {"int8_conv": 36, **MEGA_FORWARD}
# int8 'static' in run_test calibrates on the first two loader batches, one
# forward each
CALIB_FORWARDS = 2
# the int8 model on the kernel against itself on int8_conv_plain: max abs
# difference of the video probabilities (the kernel is bitwise its plain
# version; the rest of the two forwards is the same code on the same card)
INT8_PLAIN_TOL = 1e-6
# int8 logits against the float bf16 model's: the cosine must be above JAX's
# own bar for int8 inference (tests/test_quantize.py)
INT8_COS = 0.98
# kernel names of the passes the int8 sites ran before the kernel fused the
# quantize (f32 copy, divide, round, clamp, to int8), summed by word with
# the kernel's in the traced scorer calls of int8_test and test_ego (the
# float path has copies and clamps of its own); a round kernel in the int8
# call fails int8_test
INT8_TRACE_WORDS = ("round_kernel", "DivFunctor", "clamp", "copy_kernel",
                    "int8_conv")

# the serving surfaces' clip counts a forward beside the ones above: the
# stream's one clip a window, a loaded artifact's batch of 4 videos and the
# cascade check's 6 videos (its full stage at the 4-video bucket)
SERVE_CLIPS = (1, 4 * CLIPS, 6 * CLIPS)
# frame geometries of the on-device resize check: (H, W), square resize,
# scale, crop (EgoGesture's square 224 from a 4:3 camera frame and from a
# larger square one; NvGesture's short side to 256, then the centre 224)
PREPROCESS_GEOMS = [((120, 160), True, 224, 224),
                    ((300, 300), True, 224, 224),
                    ((240, 320), False, 256, 224)]
# the card's resize against the port's on the CPU: max |diff| of the
# normalized f32 output (the two sum the filter taps in other orders; JAX's
# resize is held to the port's CPU one at the same bound in the tests)
PREPROCESS_TOL = 1e-4
# a loaded artifact's bf16 video probabilities against the live scorer's on
# the same inputs: the same kernels and convs on the same card, so any
# difference is cuDNN taking another algorithm for a conv of the exported
# graph; probabilities near 1/83 round at ~6e-5 in bf16, so a few ulps stay
# well inside this
ARTIFACT_TOL = 1e-3
# launches of one forward of the exit-1 deploy (tsn_middle1: the 3 ACTION
# sites of layer1) in 'mega' and in 'prologue'
EXIT1_MEGA = {"action_stats": 3, "action_stats_window": 3,
              "action_apply": 3, "action_apply_strip": 3}
EXIT1_PROLOGUE = {"action_prologue": 3, "action_prologue_window": 3}
# frames pushed through the stream demo (cli.stream_demo's default; T=8,
# window 32, stride 8: a window every 8 frames from frame 8, 32 windows)
STREAM_FRAMES = 256
# passes over the request batches in each turn of the dispatch comparison
# and in the timing of a loaded artifact and its live scorer
DISPATCH_REPS = 5
# the dress rehearsal at the protocol's geometry (cli.dress_rehearsal's
# defaults: 224^2, T=8, 83 classes, 'vjp'): 32 clips a step; 64 videos
# give 2 steps an epoch under its --steps 3, one epoch a stage
REHEARSAL_ARGV = ["--batch", "32", "--steps", "3", "--videos", "64"]
REHEARSAL_CLIPS, REHEARSAL_STEPS = 32, 2
# GradCAM: two videos (the first clip of each of the first request batch)
# and the exits of each surface.  The CAM of an exit is ill-conditioned on
# a random full-width model: the head's gradient passes the scala's ReLUs,
# whose inputs sit at zero after BN, so rounding flips kinks and moves the
# channel weights by percents; the plain fp32 model's mid-exit CAMs read
# 1.5-1.7e-2 from a float64 run of itself on the CPU and 3.0-6.0e-3 on the
# H100 (PERF.md), where 1e-3 holds only at the final exit.  So each
# fp32 CAM (TF32 off) is held to the float64 plain model's: the 'mega'
# model's error within WORST_X times the plain fp32 model's plus CAM_TOL
CAM_VIDEOS = 2
CAM_EXITS = {"tsn": ("final",), "tsn_sd": ("final", "mid1", "mid2", "mid3")}
CAM_TOL = 1e-3
# words of the ACTION kernels' CUDA names (the window, strip and FMA sweep
# kernels) that a traced GradCAM call must list
ACTION_KERNEL_WORDS = ("stats_window_kernel", "apply_strip_kernel",
                       "sweep_kernel")
# the case study: synthetic test videos of the CLI's source, RUN_CLIPS
# clips each, scored one video a call
CASE_VIDEOS = 4
# cli.reproduce --smoke (the chain's flags): T=4, 32^2, 4 clips a train
# step, 3 steps a train stage; ResNet-50's 16 ACTION sites there: (S, C,
# F, sites a forward) with S = 8^2, 4^2, 2^2 and 1^2
REPRO_T, REPRO_CLIPS, REPRO_STEPS = 4, 4, 3
REPRO_SITES = [(64, 64, 64, 1), (64, 256, 64, 2), (64, 256, 128, 1),
               (16, 512, 128, 3), (16, 512, 256, 1), (4, 1024, 256, 5),
               (4, 1024, 512, 1), (1, 2048, 512, 2)]


def _inputs(torch, n, s, c, f, dtype, gen, t=T):
    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") *
                scale).to(dtype)

    def rand(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen,
                                            device="cuda")).to(dtype)
    return dict(x4=randn(n, t, s, c), w=randn(3, c),
                wp3=randn(c, c // 16, scale=c ** -0.5),
                g1=rand(n, t, s, 1), gch=rand(n, t, c, lo=3.0, hi=5.0),
                wn=randn(c, f, scale=c ** -0.5))


def _rel_err(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def _tpu_s_tile(s, c, out_cols, itemsize=2, budget=12 << 20):
    """The S tile the TPU kernel uses (ehgr_tpu/ops/pallas/action_mega.py
    ``_s_tile``), copied so the port imports nothing of that package."""
    lane = 128
    pad_out = (max(out_cols, 1) + lane - 1) // lane * lane
    per_row = T * (itemsize * (2 * c + 4 * lane + 2 * pad_out)
                   + 4 * (pad_out + lane))
    if s * per_row <= budget or s < 8:
        return s
    cap = max(8, budget // per_row // 8 * 8)
    for d in range(cap, 7, -8):
        if s % d == 0:
            return d
    return min(cap, max(8, s // 8 * 8))


def pool_accumulation_delta(torch, d):
    """How far a bf16 running sum of ``pool`` (the TPU kernel's: each S
    tile's sum rounded to bf16 and added into a bf16 accumulator) lands from
    the f32 sum this port's kernel keeps, on the same bf16 x_shift; as max
    |delta| / max |pool|."""
    from ehgr_tpu_torch.ops.temporal_shift import learnable_shift

    bf16 = torch.bfloat16
    xs = learnable_shift(d["x4"].float(), d["w"].float()).to(bf16)
    s, c = xs.shape[2], xs.shape[3]
    st = _tpu_s_tile(s, c, c // 16 + 1)
    acc = torch.zeros_like(xs[:, :, 0])
    for s0 in range(0, s, st):
        part = xs[:, :, s0:s0 + st].float().sum(2).to(bf16)
        acc = (acc.float() + part.float()).to(bf16)
    want = xs.float().mean(2)
    return dict(S=s, C=c, tpu_s_tile=st,
                bf16_acc_rel=_rel_err((acc / s).float(), want)[1],
                f32_acc_rel=_rel_err(want.to(bf16), want)[1])


def _launched_route(wrapper, call):
    """``call()``'s result and the route of ``wrapper`` that it launched,
    read from the wrapper's per-route count (zeroed first)."""
    counts = wrapper.route_launches
    for k in counts:
        counts[k] = 0
    out = call()
    moved = [k for k, v in counts.items() if v]
    if len(moved) != 1:
        raise AssertionError(f"{wrapper.__name__} launched routes {counts}")
    return out, moved[0]


def _repeat_is_bitwise(torch, first, call):
    """Whether a second ``call()`` gives outputs bitwise equal to
    ``first`` (no atomics: every sum in a fixed order)."""
    again = call()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, again))


def _check_shapes(n):
    """(clips, T, S, C, F) of the ACTION kernel checks: every site at the
    served batch's ``n`` clips, at TRAIN_CLIPS (the train steps' batch:
    the window kernel picks its TG from the clip count) and at the serving
    surfaces' SERVE_CLIPS, every 224^2 and
    256^2 site at the test runner's RUN_CLIPS, the ragged and route shapes
    and T_SHAPES at ``n``, and the sites of stages 3-4 at T/2 (the
    ``temporal_pool`` model's) at both ``n`` and TRAIN_CLIPS."""
    return ([(k, T) + s[:3] for k in (n, TRAIN_CLIPS) + SERVE_CLIPS
             for s in SITES] +
            [(RUN_CLIPS, T) + s[:3] for s in SITES + NV_SITES] +
            [(n, T) + s[:3] for s in RAGGED + ROUTE_SHAPES] +
            [(n,) + s for s in T_SHAPES] +
            [(k, T // 2) + s[:3] for k in (n, TRAIN_CLIPS)
             for s in TPOOL_SITES])


def _window_template(mega, route, k, t, s, c):
    """The window kernel's TG and N at these sizes (as its host code picks
    them; nothing off that route); a shape of T_SHAPES must leave masked
    frames in the last frame group (T % TG != 0)."""
    if route != "window":
        return {}
    g = mega.window_grid(k, t, s, c, c // 16)
    if any(sh[:3] == (t, s, c) for sh in T_SHAPES) and t % g["TG"] == 0:
        raise AssertionError(f"T={t} S={s} C={c}: TG={g['TG']} divides T, "
                             "so no frame of the last group is masked")
    return dict(TG=g["TG"], N=g["N"])


def check_kernels(torch, mega, n, gen, shapes=None):
    """Each kernel against its plain version at every shape of ``shapes``
    (clips, T, S, C, F; default ``_check_shapes``), fp32 and bf16,
    ``action_stats`` also bitwise over two calls; returns per-(shape,
    dtype) errors and raises on a miss."""
    results, pool_acc = [], []
    for k, t, s, c, f in shapes or _check_shapes(n):
        for dname in ("float32", "bfloat16"):
            d = _inputs(torch, k, s, c, f, getattr(torch, dname), gen, t)
            ref = {k_: v.float() for k_, v in d.items()}   # same values, f32
            stats = lambda: mega.action_stats(d["x4"], d["w"], d["wp3"])
            first, routes = {}, {}
            first["stats"], routes["action_stats"] = _launched_route(
                mega.action_stats, stats)
            got = dict(zip(("mc", "pool", "x3"), first["stats"]))
            want = dict(zip(("mc", "pool", "x3"), mega.action_stats_plain(
                ref["x4"], ref["w"], ref["wp3"])))
            got["out"], routes["action_apply"] = _launched_route(
                mega.action_apply,
                lambda: mega.action_apply(d["x4"], d["w"], d["g1"],
                                          d["gch"], d["wn"]))
            want["out"] = mega.action_apply_plain(
                ref["x4"], ref["w"], ref["g1"], ref["gch"], ref["wn"])
            torch.cuda.synchronize()
            bitwise = _repeat_is_bitwise(torch, first["stats"], stats)
            tmpl = _window_template(mega, routes["action_stats"], k, t, s, c)
            for name in got:
                err, rel = _rel_err(got[name], want[name])
                kernel = "action_apply" if name == "out" else "action_stats"
                route = routes[kernel]
                ok = rel <= TOL[dname] and math.isfinite(err)
                results.append(dict(kernel=kernel, output=name, clips=k, T=t,
                                    S=s, C=c, F=f, dtype=dname,
                                    max_abs_err=err, max_rel_err=rel,
                                    tol=TOL[dname], ok=ok, route=route))
                tail = ""
                if kernel == "action_stats":
                    results[-1].update(tmpl, bitwise_repeat=bitwise)
                    tail = "".join(f" {a}={v}" for a, v in tmpl.items())
                    tail += f" repeat bitwise {bitwise}"
                print(f"check {kernel:12s} {name:4s} n={k} T={t} S={s:4d} "
                      f"C={c:4d} F={f:3d} {dname:8s} max_abs_err={err:.3e} "
                      f"rel={rel:.3e} tol={TOL[dname]:.0e} "
                      f"{'ok' if ok else 'MISS'} {route}{tail}", flush=True)
                if not ok:
                    raise AssertionError(
                        f"{kernel}.{name} disagrees with its plain version "
                        f"at n={k} T={t} S={s} C={c} F={f} {dname}: rel "
                        f"{rel:.3e} > {TOL[dname]}")
            if not bitwise:
                raise AssertionError(f"action_stats ({routes['action_stats']}"
                                     f") differs between two calls at n={k} "
                                     f"T={t} S={s} C={c} {dname}")
            if dname == "bfloat16" and k == n and t == T and \
                    (s, c, f) in [x[:3] for x in SITES] and not shapes:
                pool_acc.append(pool_accumulation_delta(torch, d))
            del d, ref, got, want, first
    print("pool_accumulation " + json.dumps(pool_acc), flush=True)
    return results, pool_acc


def _shift_shapes(sites=SITES):
    """Distinct (S, C) of ``sites`` (default the 16 ACTION sites; the
    shift does not see F), with their site counts."""
    shapes = {}
    for s, c, _, count in sites:
        shapes[(s, c)] = shapes.get((s, c), 0) + count
    return [(s, c, k) for (s, c), k in shapes.items()]


def _shift_inputs(torch, n, s, c, dtype, gen, t=T):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return randn(n, t, s, c), randn(3, c), randn(n, t, s, c)


def _shift_check_shapes(n):
    """(clips, T, S, C) of the learnable-shift checks: the site shapes at
    TRAIN_CLIPS (the train steps') and at the served batch's ``n`` clips
    (the strip kernel picks its strip height R from the clip count), the
    ragged shapes at TRAIN_CLIPS, and the (T, S, C) of T_SHAPES (strips
    through five frames) and the stage 3-4 sites at T/2 (strips through
    four, as ``temporal_pool`` runs them) at both clip counts."""
    return ([(k, T, s, c) for k in (TRAIN_CLIPS, n)
             for s, c, _ in _shift_shapes()] +
            [(TRAIN_CLIPS, T, s, c) for s, c, _ in RAGGED] +
            [(k,) + sh[:3] for k in (TRAIN_CLIPS, n) for sh in T_SHAPES] +
            [(k, T // 2, s, c) for k in (TRAIN_CLIPS, n)
             for s, c, _ in _shift_shapes(TPOOL_SITES)])


def check_shift(torch, shk, n, gen, shapes=None):
    """``learnable_shift_fwd`` / ``_bwd`` against autograd of the plain
    shift (in f32 from the same values) at every shape of ``shapes``
    (clips, T, S, C; default ``_shift_check_shapes``), fp32 and bf16, the
    backward's route (read from its launch counts) printed per shape and
    its dx and dw bitwise equal over two calls; raises on a miss."""
    results = []
    for k, t, s, c in shapes or _shift_check_shapes(n):
        for dname in ("float32", "bfloat16"):
            x, w, g = _shift_inputs(torch, k, s, c, getattr(torch, dname),
                                    gen, t)
            bwd = lambda: shk.learnable_shift_bwd(x, g, w)
            got = dict(y=shk.learnable_shift_fwd(x, w))
            first, route = _launched_route(shk.learnable_shift_bwd, bwd)
            got["dx"], got["dw"] = first
            want = dict(y=shk.learnable_shift_fwd_plain(x.float(), w.float()))
            want["dx"], want["dw"] = shk.learnable_shift_bwd_plain(
                x.float(), g.float(), w.float())
            torch.cuda.synchronize()
            bitwise = _repeat_is_bitwise(torch, first, bwd)
            geo = shk.strip_geometry(k, s, c) if route == "strip" else {}
            tail = "" if not geo else (f" R={geo['rows']} "
                                       f"blocks={geo['blocks']}")
            for name in got:
                err, rel = _rel_err(got[name], want[name])
                kernel = "learnable_shift_fwd" if name == "y" \
                    else "learnable_shift_bwd"
                ok = rel <= SHIFT_TOL[dname] and math.isfinite(err)
                results.append(dict(kernel=kernel, output=name, clips=k, T=t,
                                    S=s, C=c, dtype=dname, max_abs_err=err,
                                    max_rel_err=rel, tol=SHIFT_TOL[dname],
                                    ok=ok))
                more = ""
                if kernel == "learnable_shift_bwd":
                    results[-1].update(route=route, bitwise_repeat=bitwise)
                    more = f" {route}{tail} repeat bitwise {bitwise}"
                print(f"check {kernel:19s} {name:2s} n={k} T={t} S={s:4d} "
                      f"C={c:4d} {dname:8s} max_abs_err={err:.3e} "
                      f"rel={rel:.3e} tol={SHIFT_TOL[dname]:.0e} "
                      f"{'ok' if ok else 'MISS'}{more}", flush=True)
                if not ok:
                    raise AssertionError(
                        f"{kernel}.{name} disagrees with its plain version "
                        f"at n={k} T={t} S={s} C={c} {dname}: rel {rel:.3e} "
                        f"> {SHIFT_TOL[dname]}")
            if not bitwise:
                raise AssertionError(f"learnable_shift_bwd ({route}) differs "
                                     f"between two calls at n={k} T={t} "
                                     f"S={s} C={c} {dname}")
            del x, w, g, got, want, first
    return results


def make_batches(seed):
    """Request batches of uint8 videos and labels from ``--seed``."""
    rng = np.random.default_rng(seed)
    shape = (VIDEOS, CLIPS, T, CROP, CROP, 3)
    return [(rng.integers(0, 256, shape, dtype=np.uint8),
             rng.integers(0, CLASSES, (VIDEOS,)))
            for _ in range(BATCHES)]


def _clips(torch, frames):
    from ehgr_tpu_torch.ops.preprocess_device import normalize_clip

    x = normalize_clip(torch.as_tensor(frames).cuda())
    return x.reshape((-1, T) + x.shape[3:])


def set_bn_stats(torch, model, clips):
    """Set each BN's running statistics from its input on one eval
    forward of ``model`` over ``clips`` ``[N, T, H, W, 3]`` (its device and
    dtype)."""
    from ehgr_tpu_torch.models.norm import BatchNorm

    def set_stats(bn, inputs):
        x = inputs[0].float()
        dims = (0,) + tuple(range(2, x.dim()))      # 2-D and 3-D BNs
        bn.running_mean.copy_(x.mean(dims))
        bn.running_var.copy_(x.var(dims, unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats)
             for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model.eval()(clips)
    for h in hooks:
        h.remove()


def build_models(torch, seed, frames, base_model="resnet50", arch="tsn"):
    """The served model ('mega') and its plain twin from the same seed
    (``base_model``: the backbone, ResNet-50 for the ACTION scorer;
    ``arch``: the surface, ``tsn`` for the scorer).

    With BN's init statistics (mean 0, var 1) a random ResNet-50 + ACTION
    at 224^2 grows its activations to ~1e5 (logits ~7e3), where the
    comparison with the plain path measures amplified rounding, not the
    kernels.  So, as one would for any random-weight smoke model, each BN's
    running statistics are set once from its input on the first batch
    (plain path, fp32); both models then hold the same weights."""
    from ehgr_tpu_torch.models.tsn import variant

    models = [variant(arch, num_class=CLASSES, num_segments=T,
                      base_model=base_model, temporal="action",
                      action_fused=mode, dtype=torch.float32, device="cuda",
                      generator=torch.Generator().manual_seed(seed))
              for mode in ("mega", None)]
    mega_model, plain = models
    set_bn_stats(torch, plain, _clips(torch, frames))
    mega_model.load_state_dict(plain.state_dict())
    for m in models:
        m.dtype = torch.bfloat16
    return mega_model, plain


def _counters():
    """Kernel name -> (wrapper or dict, attribute or key) of its launch
    counter; ``tsm_shift`` counts both directions, ``tsm_shift_reverse`` the
    reverse launches among them; ``learnable_shift_bwd`` counts every route,
    ``learnable_shift_bwd_strip`` its main path's (``csrc/shift_bwd.cu``)
    among them; ``action_apply`` counts every route,
    ``action_apply_strip`` its main path's route (``csrc/action_apply.cu``)
    among them, and ``action_stats_window`` / ``action_prologue_window``
    those of the window kernel (``csrc/action_stats.cu``)."""
    from ehgr_tpu_torch.ops.kernels import action_fused as fused
    from ehgr_tpu_torch.ops.kernels import action_mega as mega
    from ehgr_tpu_torch.ops.kernels import int8_conv as i8
    from ehgr_tpu_torch.ops.kernels import shift as shk
    from ehgr_tpu_torch.ops.kernels import tsm_shift as tk

    return {"learnable_shift_fwd": (shk.learnable_shift_fwd, "launches"),
            "learnable_shift_bwd": (shk.learnable_shift_bwd, "launches"),
            "learnable_shift_bwd_strip": (
                shk.learnable_shift_bwd.route_launches, "strip"),
            "action_stats": (mega.action_stats, "launches"),
            "action_stats_window": (mega.action_stats.route_launches,
                                    "window"),
            "action_apply": (mega.action_apply, "launches"),
            "action_apply_strip": (mega.action_apply.route_launches,
                                   "strip"),
            "action_prologue": (fused.action_prologue, "launches"),
            "action_prologue_window": (fused.action_prologue.route_launches,
                                       "window"),
            "tsm_shift": (tk.tsm_shift, "launches"),
            "tsm_shift_reverse": (tk.tsm_shift, "reverse_launches"),
            "int8_conv": (i8.int8_conv, "launches")}


# sizes (kernel, clips, T, S, C, Cr) of the window kernel's launches since
# the counters were last zeroed ("now"), and of those read after a main
# path ("main"; see record_window_launches)
WINDOW_LAUNCHES = {"now": set(), "main": set()}
WINDOW_ENTRIES = {"ehgr_action_stats_window": "action_stats",
                  "ehgr_action_prologue_window": "action_prologue"}


def record_window_launches(mega, fused):
    """Let each launch of a window entry point through the two wrappers'
    ``launch`` (a module global each looks up at the call) add its sizes to
    WINDOW_LAUNCHES["now"]; the launch itself is unchanged.  A main path
    zeroes the counters just before it runs and reads them just after, so
    ``_launches`` folds "now" into "main" there."""
    for mod in (mega, fused):
        def recording(lib, fn, x4, *args, _launch=mod.launch):
            if fn in WINDOW_ENTRIES:
                WINDOW_LAUNCHES["now"].add((WINDOW_ENTRIES[fn],) +
                                           tuple(args[-5:]))
            return _launch(lib, fn, x4, *args)
        mod.launch = recording


def reset_counters():
    for fn, attr in _counters().values():
        if isinstance(fn, dict):
            fn[attr] = 0
        else:
            setattr(fn, attr, 0)
    WINDOW_LAUNCHES["now"].clear()


def _launches():
    WINDOW_LAUNCHES["main"] |= WINDOW_LAUNCHES["now"]
    return {k: fn[attr] if isinstance(fn, dict) else getattr(fn, attr)
            for k, (fn, attr) in _counters().items()}


def check_window_coverage(mega, checks):
    """Every (kernel, TG, N) of the window kernel that a main path
    launched (its sizes recorded at the launch, TG and N as the host code
    picks them for those sizes) was held against its plain version by a
    check; raises if one was not."""
    checked = {(r["kernel"], r["TG"], r["N"]) for r in checks if "TG" in r}
    launched = {}
    for kernel, k, t, s, c, cr in sorted(WINDOW_LAUNCHES["main"]):
        g = mega.window_grid(k, t, s, c, cr)
        launched.setdefault((kernel, g["TG"], g["N"]), []).append(
            dict(clips=k, T=t, S=s, C=c, Cr=cr))
    out = [dict(kernel=kernel, TG=tg, N=nn,
                checked=(kernel, tg, nn) in checked, shapes=shapes)
           for (kernel, tg, nn), shapes in sorted(launched.items())]
    for r in out:
        print(f"window_coverage {r['kernel']} TG={r['TG']} N={r['N']} "
              f"checked={r['checked']} launched at " +
              ", ".join(f"n={d['clips']} T={d['T']} S={d['S']} C={d['C']} "
                        f"Cr={d['Cr']}" for d in r["shapes"]), flush=True)
    if not out:
        raise AssertionError("the main paths launched no window kernel")
    missing = [(r["kernel"], r["TG"], r["N"]) for r in out
               if not r["checked"]]
    if missing:
        raise AssertionError(f"window kernel (kernel, TG, N) launched on a "
                             f"main path and never checked: {missing}")
    return out


def serve(torch, model, batches, want, name="serve", heads=1):
    """A main path: the multi-clip scorer over request batches, with the
    kernels' launch counters zeroed just before and read just after; each
    forward must launch exactly ``want`` (kernel -> count, the others 0).
    ``heads=4`` scores the SD model's four heads (``evaluate`` reads the
    final one)."""
    from ehgr_tpu_torch.eval.inference import evaluate, make_score_fn

    score = make_score_fn(model, device="cuda", crop_size=CROP,
                          dtype_name="bfloat16", heads=heads)
    score(batches[0][0])                       # warm-up: cuDNN plans
    torch.cuda.synchronize()

    probs = []

    def recorded(frames):
        p = score(frames)
        probs.append(p)
        return p[0] if heads > 1 else p

    reset_counters()
    t0 = time.perf_counter()
    res = evaluate(recorded, batches, CLASSES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()

    want = {k: want.get(k, 0) * len(batches) for k in launches}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want} "
                             f"({len(batches)} forwards)")
    for p in probs:
        for q in (p if heads > 1 else (p,)):
            if q.shape != (VIDEOS, CLASSES) or \
                    not torch.isfinite(q).all() or \
                    (q.sum(-1) - 1).abs().max().item() > 1e-3:
                raise AssertionError(f"{name}: bad video probabilities {q}")
    if res["n_videos"] != VIDEOS * len(batches):
        raise AssertionError(f"{name}: evaluate saw {res['n_videos']} "
                             "videos")
    clips = len(batches) * VIDEOS * CLIPS
    out = dict(batches=len(batches), videos=VIDEOS, clips=CLIPS, heads=heads,
               launches=launches, top1=res["top1"], top5=res["top5"],
               seconds=wall, clips_per_s=clips / wall)
    print(f"{name} " + json.dumps(out), flush=True)
    return out


def compare_logits(torch, mega_model, plain, frames):
    """'mega' logits against the plain path from the same weights.

    fp32 (TF32 off): the two must agree within LOGIT_TOL; the floor beside
    it is the plain path against itself with the batch split in two (other
    GEMM/conv algorithms, same math).  bf16: both paths round at other
    places, so each is measured against the fp32 plain logits and the
    'mega' path must come within BF16_SLACK times the plain path's own bf16
    error (plus LOGIT_TOL)."""
    x = _clips(torch, frames)
    half = x.shape[0] // 2
    logits = {}
    with torch.inference_mode():
        for dname in ("float32", "bfloat16"):
            for m in (mega_model, plain):
                m.dtype = getattr(torch, dname)
            logits[dname] = (mega_model(x), plain(x))
        for m in (mega_model, plain):
            m.dtype = torch.float32
        split = torch.cat([plain(x[:half]), plain(x[half:])])
        for m in (mega_model, plain):
            m.dtype = torch.bfloat16
    ref = logits["float32"][1]
    err, rel = _rel_err(logits["float32"][0], ref)
    out = dict(max_abs_logit=ref.abs().max().item(),
               fp32=dict(max_abs_err=err, max_rel_err=rel,
                         floor_rel=_rel_err(split, ref)[1], tol=LOGIT_TOL))
    mega_rel = _rel_err(logits["bfloat16"][0], ref)[1]
    plain_rel = _rel_err(logits["bfloat16"][1], ref)[1]
    err_b, rel_b = _rel_err(*logits["bfloat16"])
    out["bf16"] = dict(max_abs_err=err_b, max_rel_err=rel_b,
                       mega_vs_fp32_rel=mega_rel, plain_vs_fp32_rel=plain_rel,
                       tol=BF16_SLACK * plain_rel + LOGIT_TOL)
    print("logits " + json.dumps(out), flush=True)
    if not rel <= LOGIT_TOL:
        raise AssertionError(f"fp32 logits: mega vs plain rel {rel:.3e} > "
                             f"{LOGIT_TOL}")
    if not mega_rel <= out["bf16"]["tol"]:
        raise AssertionError(f"bf16 logits: mega {mega_rel:.3e} from fp32, "
                             f"plain {plain_rel:.3e}")
    return out


def profile_forward(torch, model, frames, heads=1, name="profile",
                    shapes=False):
    """Device time by kernel name over one scorer call (torch.profiler),
    beside the call's wall time; with ``shapes``, also each convolution's
    kernels by its input and weight shapes (``_conv_kernels``)."""
    from ehgr_tpu_torch.eval.inference import make_score_fn

    score = make_score_fn(model, device="cuda", crop_size=CROP,
                          dtype_name="bfloat16", heads=heads)
    out = _device_profile(torch, lambda: score(frames), shapes=shapes)
    print(f"{name} " + json.dumps(out), flush=True)
    return out


def make_train_batches(seed, count):
    """Training batches of uint8 rgb, the next segment's uint8 depth and
    labels from ``seed``."""
    rng = np.random.default_rng(seed + 1)
    shape = (TRAIN_CLIPS, T, CROP, CROP)
    return [{"rgb": rng.integers(0, 256, shape + (3,), dtype=np.uint8),
             "depth": rng.integers(0, 256, shape + (1,), dtype=np.uint8),
             "label": rng.integers(0, CLASSES, (TRAIN_CLIPS,))}
            for _ in range(count)]


def _train_model(torch, seed, mode, dtype, dropout, arch="tsn_mtmm",
                 temporal="action", base_model="resnet50", classes=CLASSES):
    from ehgr_tpu_torch.models.tsn import variant

    return variant(arch, num_class=classes, num_segments=T,
                   base_model=base_model, temporal=temporal,
                   action_fused=mode, partial_bn=False,
                   dropout=dropout, dtype=dtype, device="cuda",
                   generator=torch.Generator().manual_seed(seed))


def run_steps(torch, name, model, stage, seed, want, steps=TRAIN_STEPS,
              policies=True):
    """``make_train_step(stage=...)`` on ``model`` with the recipe's
    optimizer settings (``policies=False``: one parameter group): one
    warm-up step (its peak memory above what the fresh state holds, as
    ``remat_step`` reads it, and its ms, cuDNN's plan search included),
    then ``steps`` steps with the launch counters zeroed just before and
    read after each step; each step must launch exactly ``want`` (kernel ->
    count, the others 0).  Returns the result and the warm (step, state,
    batch, generator)."""
    from ehgr_tpu_torch.configs import LossConfig, OptimConfig
    from ehgr_tpu_torch.ops.preprocess_device import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
    from ehgr_tpu_torch.train.optim import build_optimizer
    from ehgr_tpu_torch.train.steps import (create_train_state,
                                            make_train_step)

    opt, _ = build_optimizer(model, OptimConfig(lr=0.00125,
                                                weight_decay=1e-5,
                                                policies=policies),
                             partial_bn=False)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, stage=stage,
                           loss_cfg=LossConfig(depth_size=DEPTH_SIZE),
                           ema_decay=0.9999, mean=IMAGENET_MEAN,
                           std=IMAGENET_STD)
    batches = make_train_batches(seed, steps + 1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    e0 = {k: v.clone() for k, v in state.ema_params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    step(state, batches[0], gen)                 # warm-up: cuDNN plans
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    first_peak = torch.cuda.max_memory_allocated() - base

    counters = _counters()
    want = {k: want.get(k, 0) for k in counters}
    reset_counters()
    per_step, ms, metrics = [], [], []
    for b in batches[1:]:
        before = _launches()
        t0 = time.perf_counter()
        _, m = step(state, b, gen)
        m = {k: float(v) for k, v in m.items()}     # synchronises
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - before[k] for k, v in _launches().items()})
        metrics.append(m)
    launches = _launches()

    for i, (c, m) in enumerate(zip(per_step, metrics)):
        if c != want:
            raise AssertionError(f"{name} step {i}: launches {c}, want "
                                 f"{want}")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{name} step {i}: metrics {m}")
    moved = sum(not torch.equal(p0[k], v) for k, v in state.params.items())
    ema_moved = sum(not torch.equal(e0[k], v)
                    for k, v in state.ema_params.items())
    if moved < len(p0) // 2 or ema_moved < len(p0) // 2:
        raise AssertionError(f"{name}: params moved {moved}, EMA "
                             f"{ema_moved} of {len(p0)}")
    mean_ms = sum(ms) / len(ms)
    out = dict(stage=stage, steps=steps, clips=TRAIN_CLIPS,
               launches=launches, launches_per_step=per_step[0],
               ms_per_step=ms, mean_ms_per_step=mean_ms,
               clips_per_s=TRAIN_CLIPS / mean_ms * 1e3,
               losses=[m["loss"] for m in metrics], metrics=metrics,
               params_moved=moved, ema_moved=ema_moved, n_params=len(p0),
               first_step_peak_bytes=first_peak, first_step_ms=first_ms)
    print(f"{name} " + json.dumps(out), flush=True)
    return out, (step, state, batches[1], gen)


def train(torch, seed):
    """The Stage-1 training path: ``make_train_step(stage='mtmm')`` on the
    full-width ``tsn_mtmm`` in bf16, ``action_fused='vjp'`` (16 sites: 16
    launches of each of the four kernels a step)."""
    model = _train_model(torch, seed, "vjp", torch.bfloat16, 0.5)
    return run_steps(torch, "train", model, "mtmm", seed,
                     {**SHIFT_STEP, **MEGA_FORWARD})


def _frozen_bn_state(torch, seed, batch, arch="tsn_mtmm",
                     base_model="resnet50"):
    """Weights of the parity models with every BN's running statistics set
    from its input on ``batch`` (plain path, as for the scorer)."""
    from ehgr_tpu_torch.ops.preprocess_device import (IMAGENET_MEAN,
                                                      IMAGENET_STD,
                                                      normalize_clip)

    model = _train_model(torch, seed, None, torch.float32, 0.0, arch,
                         base_model=base_model)
    set_bn_stats(torch, model,
                 normalize_clip(batch["rgb"], IMAGENET_MEAN, IMAGENET_STD))
    return model.state_dict()


def check_sites(torch, gen):
    """One ACTION site in training at each site shape, TRAIN_CLIPS clips,
    fp32: ``ActionConv('vjp')`` (the kernel region) against the plain
    autograd formulation from the same weights, input and cotangent; the
    output, the input's gradient and every parameter's gradient, ME BN on
    batch statistics.  Raises on a miss."""
    from ehgr_tpu_torch.ops.action import ActionConv

    out = []
    for s, c, f, _ in SITES:
        h = int(round(math.sqrt(s)))
        mods = {mode: ActionConv(c, f, T, fused=mode, bn_frozen=False,
                                 device="cuda").train()
                for mode in ("vjp", None)}
        with torch.no_grad():              # taps off the TSM pattern
            mods["vjp"].action_shift.weight.normal_(0.0, 0.5, generator=gen)
        mods[None].load_state_dict(mods["vjp"].state_dict())
        x = torch.randn(TRAIN_CLIPS * T, c, h, s // h, device="cuda",
                        generator=gen).contiguous(
                            memory_format=torch.channels_last)
        cot = torch.randn(TRAIN_CLIPS * T, f, h, s // h, device="cuda",
                          generator=gen)
        res = {}
        for mode, m in mods.items():
            xi = x.clone().requires_grad_()
            y = m(xi)
            (y * cot).sum().backward()
            res[mode] = dict(out=y.detach(), dx=xi.grad, **{
                k: p.grad for k, p in m.named_parameters()})
        rels = {k: _rel_err(v, res[None][k])[1] for k, v in res["vjp"].items()}
        worst = max(rels, key=rels.get)
        r = dict(S=s, C=c, F=f, n=len(rels), worst=worst,
                 worst_rel=rels[worst], out_rel=rels["out"],
                 dx_rel=rels["dx"], tol=SITE_TOL)
        out.append(r)
        print("check_site " + json.dumps(r), flush=True)
        if not rels[worst] <= SITE_TOL:
            raise AssertionError(f"ACTION site S={s} C={c} F={f}: {worst} "
                                 f"rel {rels[worst]:.3e} > {SITE_TOL}")
        del mods, res, x, cot
    return out


def _parity_grads(torch, seed, mode, dtype, batch, state, arch="tsn_mtmm",
                  stage="mtmm", base_model="resnet50", classes=CLASSES):
    """Loss and gradients of one fp32 (or float64) forward/backward of the
    ``stage`` loss; ``state``: BN statistics to load, every BN then
    frozen."""
    from ehgr_tpu_torch.configs import LossConfig
    from ehgr_tpu_torch.models.norm import BatchNorm
    from ehgr_tpu_torch.ops.preprocess_device import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
    from ehgr_tpu_torch.train.steps import make_loss_fn

    model = _train_model(torch, seed, mode, torch.float32, 0.0, arch,
                         base_model=base_model, classes=classes)
    if state is not None:
        model.load_state_dict(state)
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.frozen = True
    model = model.to(dtype).train()
    model.dtype = dtype
    loss_fn = make_loss_fn(model, stage=stage,
                           loss_cfg=LossConfig(depth_size=DEPTH_SIZE),
                           mean=IMAGENET_MEAN, std=IMAGENET_STD)
    total, _, _ = loss_fn(batch, None)
    total.backward()
    return total.item(), {k: p.grad.double()
                          for k, p in model.named_parameters()
                          if p.grad is not None}


def _grad_stats(errs):
    """Median, 95th percentile and worst of per-leaf errors (key ->
    error), with the worst leaf's key."""
    e = sorted(errs.values())
    return dict(median=e[len(e) // 2], p95=e[min(len(e) - 1,
                                                 int(0.95 * len(e)))],
                worst=e[-1], worst_key=max(errs, key=errs.get))


def train_parity(torch, seed, arch="tsn_mtmm", stage="mtmm",
                 settings=("bn_batch", "bn_running"), leaves=False,
                 base_model="resnet50", zero_grad=lambda keys: ()):
    """One step's loss and gradients of the full-width model: the fp32
    'vjp' kernel model and the fp32 plain model, each against a float64 run
    of the plain model from the same weights and batch (dropout 0).  The
    plain model's own fp32 error is the floor: at random init the fp32
    gradient of this network is only good to a few percent (a forward
    perturbation of one rounding moves it as much), so the kernel model is
    held to GRAD_X times that floor in median and 95th percentile over the
    leaves, and to WORST_X times it on the worst leaf, each plus GRAD_TOL.
    Two settings: ``bn_batch``, every BN on batch statistics as the train
    phase runs; ``bn_running``, every BN on running statistics set from the
    batch.  ``leaves``: the result also holds every leaf's error.  A
    parameter outside the loss (the joint model's local decoder) has no
    gradient and no error; in ``bn_batch`` each bias of BN_FED_BIASES and
    of ``zero_grad(gradient keys)`` (exact gradient zero) is held instead
    within ZERO_GRAD_REL of its weight's largest gradient, in both fp32
    runs.  ``base_model``: the backbone of the ``arch`` model."""
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in make_train_batches(seed, 1)[0].items()}
    out = {}
    for setting in settings:
        state = _frozen_bn_state(torch, seed, batch, arch, base_model) \
            if setting == "bn_running" else None
        loss64, ref = _parity_grads(torch, seed, None, torch.float64, batch,
                                    state, arch, stage, base_model)
        runs = {name: _parity_grads(torch, seed, mode, torch.float32, batch,
                                    state, arch, stage, base_model)
                for name, mode in (("vjp", "vjp"), ("plain", None))}
        zero = [k for k in BN_FED_BIASES + tuple(zero_grad(set(ref)))
                if setting == "bn_batch" and k in ref]
        zero_rel = {name: {k: g[k].abs().max().item() / g[
            k[:-len("bias")] + "weight"].abs().max().item() for k in zero}
            for name, (_, g) in runs.items()}
        errs = {name: {k: _rel_err(g[k], ref[k])[1] for k in ref
                       if k not in zero}
                for name, (_, g) in runs.items()}
        direct = {k: _rel_err(g, runs["plain"][1][k])[1]
                  for k, g in runs["vjp"][1].items() if k not in zero}
        stat = {name: _grad_stats(e) for name, e in errs.items()}
        tol = {q: x * stat["plain"][q] + GRAD_TOL
               for q, x in (("median", GRAD_X), ("p95", GRAD_X),
                            ("worst", WORST_X))}
        loss_rel = abs(runs["vjp"][0] - runs["plain"][0]) / \
            abs(runs["plain"][0])
        r = out[setting] = dict(
            seed=seed, loss_vjp=runs["vjp"][0], loss_plain=runs["plain"][0],
            loss_float64=loss64, loss_rel=loss_rel, loss_tol=LOSS_TOL,
            n_grads=len(ref), vjp_vs_float64=stat["vjp"],
            plain_vs_float64=stat["plain"], tol=tol,
            vjp_vs_plain=_grad_stats(direct))
        if zero:
            r.update(zero_grad_tol=ZERO_GRAD_REL, zero_grad_rel={
                name: dict(n=len(z), worst=max(z.values()),
                           worst_key=max(z, key=z.get))
                for name, z in zero_rel.items()})
        print(f"train_parity {base_model} {stage} {setting} " +
              json.dumps(r), flush=True)
        if leaves:
            r["leaves"] = errs
        if any(v > ZERO_GRAD_REL for z in zero_rel.values()
               for v in z.values()):
            raise AssertionError(f"{setting}: gradient of a BN-fed bias "
                                 f"{zero_rel}")
        if not loss_rel <= LOSS_TOL:
            raise AssertionError(f"{setting}: fp32 train loss vjp "
                                 f"{runs['vjp'][0]} vs plain "
                                 f"{runs['plain'][0]}")
        for q in tol:
            if not stat["vjp"][q] <= tol[q]:
                raise AssertionError(
                    f"{setting}: {q} gradient error against float64: vjp "
                    f"{stat['vjp'][q]:.3e}, plain {stat['plain'][q]:.3e}")
        del runs, ref
    return out


# ---------------------------------------------------------------------------
# the third slice: the TSM shift, the ACTION prologue, TSM and Stage 2
# ---------------------------------------------------------------------------

def check_tsm(torch, tk, gen, shapes=None):
    """``tsm_shift`` forward and reverse against the plain shift at
    ``shapes`` (S, C, fold_div; default the site shapes and the ragged
    shapes, also at ``fold_div`` 4 there, where fold splits a 16-byte vector
    in fp32 too) at TRAIN_CLIPS clips, fp32 and bf16: a copy, so bitwise
    equal.  Raises on a miss."""
    results = []
    shapes = shapes or [(s, c, FOLD_DIV) for s, c, _ in _shift_shapes()] + \
        [(s, c, d) for s, c in TSM_RAGGED for d in (FOLD_DIV, 4)]
    for s, c, fold_div in shapes:
        for dname in ("float32", "bfloat16"):
            x = torch.randn(TRAIN_CLIPS, T, s, c, generator=gen,
                            device="cuda").to(getattr(torch, dname))
            for reverse in (False, True):
                got = tk.tsm_shift(x, fold_div, reverse)
                want = tk.tsm_shift_plain(x, fold_div, reverse)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = torch.equal(got, want)
                results.append(dict(kernel="tsm_shift", reverse=reverse,
                                    S=s, C=c, fold_div=fold_div, dtype=dname,
                                    max_abs_err=err, max_rel_err=err,
                                    tol=0.0, ok=ok))
                print(f"check tsm_shift {'rev' if reverse else 'fwd'} "
                      f"S={s:4d} C={c:4d} fold_div={fold_div} {dname:8s} "
                      f"max_abs_err={err:.3e} bitwise "
                      f"{'ok' if ok else 'MISS'}", flush=True)
                if not ok:
                    raise AssertionError(
                        f"tsm_shift (reverse={reverse}) differs from the "
                        f"plain shift at S={s} C={c} fold_div={fold_div} "
                        f"{dname}")
            del x
    return results


def check_prologue(torch, fused, mega, n, gen, shapes=None):
    """``action_prologue`` against its plain version (in f32 from the same
    values) and bitwise over two calls, at every shape of ``shapes``
    (default ``_check_shapes``; F unused), all four outputs, fp32 and bf16;
    raises on a miss."""
    results = []
    for k, t, s, c, f in shapes or _check_shapes(n):
        for dname in ("float32", "bfloat16"):
            d = _inputs(torch, k, s, c, f, getattr(torch, dname), gen, t)
            call = lambda: fused.action_prologue(d["x4"], d["w"], d["wp3"])
            got, route = _launched_route(fused.action_prologue, call)
            want = fused.action_prologue_plain(
                d["x4"].float(), d["w"].float(), d["wp3"].float())
            torch.cuda.synchronize()
            bitwise = _repeat_is_bitwise(torch, got, call)
            tmpl = _window_template(mega, route, k, t, s, c)
            tail = "".join(f" {a}={v}" for a, v in tmpl.items())
            for name, g, w in zip(("x_shift", "mc", "pool", "x3"), got,
                                  want):
                err, rel = _rel_err(g, w)
                ok = rel <= TOL[dname] and math.isfinite(err)
                results.append(dict(kernel="action_prologue", output=name,
                                    clips=k, T=t, S=s, C=c, dtype=dname,
                                    max_abs_err=err, max_rel_err=rel,
                                    tol=TOL[dname], ok=ok, route=route,
                                    bitwise_repeat=bitwise, **tmpl))
                print(f"check action_prologue {name:7s} n={k} T={t} "
                      f"S={s:4d} C={c:4d} {dname:8s} max_abs_err={err:.3e} "
                      f"rel={rel:.3e} tol={TOL[dname]:.0e} "
                      f"{'ok' if ok else 'MISS'} {route}{tail} repeat "
                      f"bitwise {bitwise}", flush=True)
                if not ok:
                    raise AssertionError(
                        f"action_prologue.{name} disagrees with its plain "
                        f"version at n={k} T={t} S={s} C={c} {dname}: rel "
                        f"{rel:.3e}")
            if not bitwise:
                raise AssertionError(f"action_prologue ({route}) differs "
                                     f"between two calls at n={k} T={t} "
                                     f"S={s} C={c} {dname}")
            del d, got, want
    return results


@contextlib.contextmanager
def plain_tsm():
    """``TSMConv`` with the shift taken by its plain version (autograd of
    the copy) instead of the kernel: the plain model of the TSM paths."""
    import ehgr_tpu_torch.ops.action as action
    from ehgr_tpu_torch.ops.kernels.tsm_shift import tsm_shift_plain

    saved = action.TsmShift
    action.TsmShift = types.SimpleNamespace(apply=tsm_shift_plain)
    try:
        yield
    finally:
        action.TsmShift = saved


def build_tsm_model(torch, seed, frames):
    """The TSN + TSM ResNet-50 (f32 weights from ``seed``), BN statistics
    set from the first batch on the plain path, bf16 compute."""
    from ehgr_tpu_torch.models.tsn import variant

    model = variant("tsn", num_class=CLASSES, num_segments=T,
                    temporal="tsm", dtype=torch.float32, device="cuda",
                    generator=torch.Generator().manual_seed(seed))
    with plain_tsm():
        set_bn_stats(torch, model, _clips(torch, frames))
    model.dtype = torch.bfloat16
    return model


def compare_tsm(torch, model, frames):
    """The TSM model's video probabilities through the kernel against the
    plain shift, fp32 (TF32 off) and bf16: the shift is exact, so both
    within LOGIT_TOL."""
    from ehgr_tpu_torch.eval.inference import make_score_fn

    out = {}
    for dname in ("float32", "bfloat16"):
        model.dtype = getattr(torch, dname)
        score = make_score_fn(model, device="cuda", crop_size=CROP,
                              dtype_name=dname)
        got = score(frames)
        with plain_tsm():
            want = score(frames)
        err, rel = _rel_err(got, want)
        out[dname] = dict(max_abs_err=err, max_rel_err=rel, tol=LOGIT_TOL)
    model.dtype = torch.bfloat16
    print("tsm_probs " + json.dumps(out), flush=True)
    for dname, r in out.items():
        if not r["max_rel_err"] <= LOGIT_TOL:
            raise AssertionError(f"TSM probabilities, kernel vs plain shift, "
                                 f"{dname}: {r}")
    return out


def check_tsm_sites(torch, gen):
    """One TSM site in training at each site shape, TRAIN_CLIPS clips, fp32:
    ``TSMConv`` on the kernel against the plain shift's autograd from the
    same weights, input and cotangent (output, dx, the conv's gradient).
    Raises on a miss."""
    from ehgr_tpu_torch.ops.action import TSMConv

    out = []
    for s, c, f, _ in SITES:
        h = int(round(math.sqrt(s)))
        m = TSMConv(c, f, T, shift_div=FOLD_DIV, device="cuda").train()
        x = torch.randn(TRAIN_CLIPS * T, c, h, s // h, device="cuda",
                        generator=gen).contiguous(
                            memory_format=torch.channels_last)
        cot = torch.randn(TRAIN_CLIPS * T, f, h, s // h, device="cuda",
                          generator=gen)
        res = {}
        for name in ("kernel", "plain"):
            xi = x.clone().requires_grad_()
            m.zero_grad()
            with plain_tsm() if name == "plain" else contextlib.nullcontext():
                y = m(xi)
                (y * cot).sum().backward()
            res[name] = dict(out=y.detach(), dx=xi.grad,
                             dw=m.net.weight.grad.clone())
        rels = {k: _rel_err(v, res["plain"][k])[1]
                for k, v in res["kernel"].items()}
        r = dict(S=s, C=c, F=f, tol=SITE_TOL, **{f"{k}_rel": v
                                                for k, v in rels.items()})
        out.append(r)
        print("check_tsm_site " + json.dumps(r), flush=True)
        if not max(rels.values()) <= SITE_TOL:
            raise AssertionError(f"TSM site S={s} C={c} F={f}: {rels}")
        del m, res, x, cot
    return out


def sd_transfer(torch, seed, stage1):
    """Stage 1 -> Stage 2: a full-width ``tsn_sd`` ('vjp', bf16 compute)
    takes the trained ``tsn_mtmm`` tensors through ``merge_state_dict``.
    The source's skipped keys must be exactly its ``global_decoder.*``,
    and the keys the target keeps from its init exactly its exits'."""
    from ehgr_tpu_torch.train.checkpoints import merge_state_dict

    model = _train_model(torch, seed + 2, "vjp", torch.bfloat16, 0.5,
                         "tsn_sd")
    skipped = merge_state_dict(model, stage1)
    kept = sorted(set(model.state_dict()) - set(stage1))
    want_skipped = sorted(k for k in stage1
                          if k.startswith("global_decoder."))
    want_kept = sorted(k for k in model.state_dict()
                       if k.startswith(("scala", "middle_fc")))
    out = dict(skipped=skipped, kept_from_init=kept, n_copied=len(stage1) -
               len(skipped))
    print("sd_transfer " + json.dumps(out), flush=True)
    if sorted(skipped) != want_skipped or kept != want_kept:
        raise AssertionError("tsn_mtmm -> tsn_sd: skipped or kept keys "
                             "differ from the global decoder / the exits")
    return out, model


def _head_probs(torch, outs):
    """Each head's softmax averaged over the CLIPS clips of a video."""
    return [torch.softmax(lg.float(), -1).reshape(-1, CLIPS, lg.shape[-1])
            .mean(1) for lg in outs[:4]]


def sd_deploy(torch, seed, trained, batches):
    """The Stage-2 deploys from the trained ``tsn_sd`` weights (BN
    statistics then set from the first batch on the plain path, as for the
    other scorers): the 4-head scorer in modes 'prologue' and 'mega' over
    the request batches with launch counts (one 'prologue' call traced),
    and ``tsn_middle1/2/3``
    ('prologue'), loaded with ``merge_state_dict``, with 3 / 7 / 13
    launches in a bf16 forward.  Compared over the clips of all request
    batches, each against the plain model in fp32.  fp32: both modes'
    four heads' probabilities within LOGIT_TOL of the plain model's, each
    middle deploy's logits equal to the SD model's exit K within
    LOGIT_TOL.  bf16, the rule of compare_logits: each middle deploy's
    logits within BF16_SLACK times the plain SD model's own bf16 error on
    that exit, plus LOGIT_TOL; each head's logits in both modes the same
    with HEADS_BF16_SLACK."""
    from ehgr_tpu_torch.models.tsn import variant
    from ehgr_tpu_torch.train.checkpoints import merge_state_dict

    def build(arch, mode):
        return variant(arch, num_class=CLASSES, num_segments=T,
                       temporal="action", action_fused=mode,
                       dtype=torch.float32, device="cuda",
                       generator=torch.Generator().manual_seed(seed))

    def run(m, dname):
        """``m``'s outputs over every request batch in ``dname``, joined
        along the clips."""
        m.dtype = getattr(torch, dname)
        outs = [m(_clips(torch, frames)) for frames, _ in batches]
        m.dtype = torch.bfloat16
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)

    models = {mode: build("tsn_sd", mode) for mode in ("prologue", "mega",
                                                       None)}
    plain = models[None]
    plain.load_state_dict(trained)
    x = _clips(torch, batches[0][0])
    set_bn_stats(torch, plain, x)
    for m in models.values():
        m.load_state_dict(plain.state_dict())
        m.dtype = torch.bfloat16
    out = {"serve_prologue": serve(torch, models["prologue"], batches,
                                   PROLOGUE_FORWARD, "sd_serve_prologue",
                                   heads=4),
           "serve_mega": serve(torch, models["mega"], batches, MEGA_FORWARD,
                               "sd_serve_mega", heads=4),
           "profile_prologue": profile_forward(
               torch, models["prologue"], batches[0][0], 4,
               "sd_profile_prologue")}

    with torch.inference_mode():
        outs = {(dname, mode): run(m, dname)
                for dname in ("float32", "bfloat16")
                for mode, m in models.items()}
    ref = outs["float32", None]
    ref_probs = _head_probs(torch, ref)

    def prob_errs(mode):
        """fp32: each head's video probabilities, as the scorer serves."""
        return [_rel_err(p, r)[1] for p, r in
                zip(_head_probs(torch, outs["float32", mode]), ref_probs)]

    def logit_errs(mode):
        """bf16: each head's per-clip logits, as compare_logits reads them
        (the max error of the clip-averaged probabilities of 6 videos
        ranged 0.26-3.9x the plain model's, head by head, in the runs of
        PERF.md)."""
        return [_rel_err(lg, r)[1]
                for lg, r in zip(outs["bfloat16", mode][:4], ref[:4])]

    heads = {}
    theirs = logit_errs(None)
    for mode in ("prologue", "mega"):
        fp32, mine = prob_errs(mode), logit_errs(mode)
        tol = [HEADS_BF16_SLACK * r + LOGIT_TOL for r in theirs]
        heads[mode] = dict(fp32_prob_rel=fp32, bf16_logit_rel=mine,
                           plain_bf16_logit_rel=theirs, bf16_tol=tol)
        if not all(r <= LOGIT_TOL for r in fp32) or \
                not all(r <= t for r, t in zip(mine, tol)):
            raise AssertionError(f"SD 4 heads, {mode} vs plain: "
                                 f"{heads[mode]}")
    out["heads"] = heads

    middles = {}
    with torch.inference_mode():
        for k, want in ((1, 3), (2, 7), (3, 13)):
            mid = build(f"tsn_middle{k}", "prologue")
            skipped = merge_state_dict(mid, plain.state_dict())
            if set(mid.state_dict()) - set(plain.state_dict()):
                raise AssertionError(f"tsn_middle{k}: keys missing in the "
                                     "SD model")
            mid.dtype = torch.bfloat16
            reset_counters()
            logits = mid(x)                    # the deploy: bf16
            torch.cuda.synchronize()
            launches = _launches()
            err, rel = _rel_err(run(mid, "float32"),
                                outs["float32", "prologue"][k])
            ref_k = outs["float32", None][k]
            mine = _rel_err(run(mid, "bfloat16"), ref_k)[1]
            theirs = _rel_err(outs["bfloat16", None][k], ref_k)[1]
            middles[k] = dict(launches=launches, skipped=len(skipped),
                              max_abs_err=err, max_rel_err=rel,
                              tol=LOGIT_TOL, bf16_logit_rel=mine,
                              plain_bf16_logit_rel=theirs,
                              bf16_tol=BF16_SLACK * theirs + LOGIT_TOL)
            if launches != {**{n: 0 for n in launches},
                            "action_prologue": want,
                            "action_prologue_window": want}:
                raise AssertionError(f"tsn_middle{k}: launches {launches}, "
                                     f"want {want} prologue launches")
            if not rel <= LOGIT_TOL or not mine <= middles[k]["bf16_tol"] \
                    or logits.shape != (x.shape[0], CLASSES):
                raise AssertionError(f"tsn_middle{k} vs tsn_sd mid{k}: "
                                     f"{middles[k]}")
            del mid
    out["middles"] = middles
    print("sd_deploy " + json.dumps({k: v for k, v in out.items()
                                     if k in ("heads", "middles")}),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# the eighth slice: the test protocol (data layer, run_test) on the card
# ---------------------------------------------------------------------------

def test_config(preset, checkpoint, mode, seed):
    """``preset`` on the synthetic moving-patch videos (RUN_VIDEOS, the
    recipe's 10 clips a video at the preset's test crop), ACTION in mode
    ``mode``, the weights of ``checkpoint``."""
    import dataclasses

    from ehgr_tpu_torch.configs import get_preset

    cfg = get_preset(preset)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, backend="synthetic",
                                 synthetic_task="motion",
                                 synthetic_videos=RUN_VIDEOS),
        model=dataclasses.replace(cfg.model, action_fused=mode),
        run=dataclasses.replace(cfg.run, checkpoint_path=checkpoint,
                                seed=seed))


def _scorer_probs(torch, cfg, arch, heads, frames, skipped_ok=()):
    """Each head's probabilities of one loader batch through the runner's
    model and scorer (``_build_model``, ``make_test_scorer``): the model in
    ``cfg``'s ACTION mode and the plain one (mode 'none'), each in bf16 and
    in fp32 (TF32 off); keyed (mode, dtype).  Every key of the checkpoint
    must load, but those under the prefixes ``skipped_ok``."""
    import dataclasses

    from ehgr_tpu_torch.eval import runner

    out = {}
    for mode in (cfg.model.action_fused, "none"):
        c = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  action_fused=mode))
        model, skipped = runner._build_model(c, arch, "cuda")
        if [k for k in skipped if not k.startswith(skipped_ok)]:
            raise AssertionError(f"{arch}: checkpoint keys not loaded: "
                                 f"{skipped}")
        for dname in ("bfloat16", "float32"):
            model.dtype = getattr(torch, dname)
            cd = c.replace(model=dataclasses.replace(c.model, dtype=dname))
            out[mode, dname] = runner.make_test_scorer(
                cd, model, heads, "cuda")(frames)
        del model
    return out


def _mode_gate(torch, cfg, arch, heads, frames, skipped_ok, slack):
    """The first batch's probabilities of every head against the plain
    model's: fp32 within LOGIT_TOL, bf16 within ``slack`` times the plain
    model's own bf16 error from fp32, plus LOGIT_TOL (the rule of
    compare_logits); one row a head, each with its verdict ``ok``."""
    probs = _scorer_probs(torch, cfg, arch, heads, frames, skipped_ok)
    mode = cfg.model.action_fused
    ref = probs["none", "float32"]
    names = ["final"] + [f"mid{i}" for i in range(1, heads)]
    gate = []
    for h in range(heads):
        theirs = _rel_err(probs["none", "bfloat16"][h], ref[h])[1]
        mine = _rel_err(probs[mode, "bfloat16"][h], ref[h])[1]
        fp32 = _rel_err(probs[mode, "float32"][h], ref[h])[1]
        g = dict(head=names[h], fp32_rel=fp32, fp32_tol=LOGIT_TOL,
                 bf16_rel=mine, plain_bf16_rel=theirs,
                 bf16_tol=slack * theirs + LOGIT_TOL)
        g["ok"] = bool(fp32 <= LOGIT_TOL and mine <= g["bf16_tol"] and
                       torch.isfinite(probs[mode, "bfloat16"][h]).all())
        gate.append(g)
    return gate


def run_protocol(torch, name, cfg, arch, heads, want, slack,
                 skipped_ok=(), gate=None, extra=None, trace_match=()):
    """A main path: ``run_test(cfg, arch, heads)`` on the card (host
    loader, upload, scorer, votes, metrics), with the kernels'
    launch counters zeroed just before and read just after; each forward
    (one video of RUN_CLIPS clips) must launch exactly ``want``, plus
    ``extra`` over the run (the calibration forwards of int8 'static').
    Then, apart: the loader alone and the scorer alone over the same
    batches (the wall's split between host and card), one scorer call
    traced (device busy and idle share), and the first batch's
    probabilities under ``gate(cfg, arch, heads, frames, skipped_ok)``
    (rows with a verdict ``ok``; default ``_mode_gate`` with ``slack``).
    ``skipped_ok``: key prefixes of the checkpoint the model has no place
    for; ``trace_match``: words of kernel names whose device time the
    traced call lists in full (``_device_profile``)."""
    from ehgr_tpu_torch.data.factory import build_test_dataset
    from ehgr_tpu_torch.data.pipeline import Loader
    from ehgr_tpu_torch.eval import runner

    reset_counters()
    t0 = time.perf_counter()
    res = runner.run_test(cfg, arch=arch, heads=heads, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()

    videos = max(cfg.data.synthetic_videos // 2, 32)
    per_batch = max(1, 8 // cfg.data.clip_num or 1)
    forwards = -(-videos // per_batch)
    extra = extra or {}
    want = {k: want.get(k, 0) * forwards + extra.get(k, 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want} "
                             f"({forwards} forwards)")
    names = ["final"] + [f"mid{i}" for i in range(1, heads)]
    keys = {"n_videos", "confusion"} | {f"{n}_top{k}" for n in names
                                        for k in (1, 5)}
    if res["n_videos"] != videos or set(res) != keys or any(
            res["confusion"][n].m.sum() != videos for n in names):
        raise AssertionError(f"{name}: run_test gave {sorted(res)}, "
                             f"n_videos {res['n_videos']}, want {videos}")

    dataset = build_test_dataset(cfg)
    calib = runner.calibration_clips(cfg, dataset) \
        if cfg.model.quantize == "static" else None
    t0 = time.perf_counter()
    batches = list(Loader(dataset, batch_size=per_batch,
                          num_workers=cfg.data.num_workers, drop_last=False))
    loader_s = time.perf_counter() - t0
    model, _ = runner._build_model(cfg, arch, "cuda", calib)
    score = runner.make_test_scorer(cfg, model, heads, "cuda")
    score(batches[0]["rgb"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        score(b["rgb"])
    torch.cuda.synchronize()
    scorer_s = time.perf_counter() - t0
    prof = _device_profile(torch, lambda: score(batches[0]["rgb"]),
                           trace_match)
    del model, score

    if gate is None:
        rows = _mode_gate(torch, cfg, arch, heads, batches[0]["rgb"],
                          skipped_ok, slack)
    else:
        rows = gate(cfg, arch, heads, batches[0]["rgb"], skipped_ok)
    clips = videos * cfg.data.clip_num
    out = dict(arch=arch, heads=heads, mode=cfg.model.action_fused,
               quantize=cfg.model.quantize, videos=videos,
               clips_per_video=cfg.data.clip_num,
               crop=cfg.data.crop_size, classes=cfg.model.num_classes,
               forwards=forwards, launches=launches,
               results={k: v for k, v in res.items() if k != "confusion"},
               seconds=wall, clips_per_s=clips / wall,
               videos_per_s=videos / wall, loader_alone_s=loader_s,
               scorer_alone_s=scorer_s,
               scorer_alone_clips_per_s=clips / scorer_s,
               scorer_call_traced={k: prof[k] for k in (
                   "wall_ms", "device_busy_ms", "idle_share",
                   "top_device_ms", "matched_ms") if k in prof},
               loader_workers=cfg.data.num_workers, probs=rows)
    print(f"{name} " + json.dumps(out), flush=True)
    for g in rows:
        if not g["ok"]:
            raise AssertionError(f"{name}: {g['head']} probabilities: {g}")
    return out


def test_ego(torch, seed, checkpoint):
    """The EgoGesture test protocol at full width: ``ego_baseline``
    (TSN + ACTION ResNet-50, T=8, 224^2, 83 classes, bf16) with the ACTION
    kernels at eval (``--action_fused mega``: 'vjp', the preset's, takes
    the plain formulation at eval in both packages), the serve model's
    weights through a ``.pth``; 16 ``action_stats_window`` and 16
    ``action_apply_strip`` launches a forward."""
    cfg = test_config("ego_baseline", checkpoint, "mega", seed)
    return run_protocol(torch, "test_ego", cfg, "tsn", 1, MEGA_FORWARD,
                        BF16_SLACK, trace_match=INT8_TRACE_WORDS)


def test_nv_sd(torch, seed, path):
    """The NvGesture SD test protocol: ``nv_sd`` (256^2 test crop, 25
    classes) with ``action_fused='prologue'``, four heads; a random
    ``tsn_sd`` from ``seed`` with BN statistics set from the first test
    batch (plain path, fp32), written to ``path`` and read back by the
    runner; 16 ``action_prologue_window`` launches a forward."""
    from ehgr_tpu_torch.data.factory import build_test_dataset
    from ehgr_tpu_torch.models.tsn import variant
    from ehgr_tpu_torch.ops.preprocess_device import normalize_clip

    cfg = test_config("nv_sd", path, "prologue", seed)
    model = variant("tsn_sd", num_class=cfg.model.num_classes,
                    num_segments=T, temporal="action", action_fused=None,
                    dtype=torch.float32, device="cuda",
                    generator=torch.Generator().manual_seed(seed))
    frames = build_test_dataset(cfg)[0]["rgb"]         # [K, T, 256, 256, 3]
    set_bn_stats(torch, model,
                 normalize_clip(torch.as_tensor(frames).cuda()))
    torch.save({"state_dict": model.state_dict()}, path)
    del model
    return run_protocol(torch, "test_nv_sd", cfg, "tsn_sd", 4,
                        PROLOGUE_FORWARD, HEADS_BF16_SLACK)


# ---------------------------------------------------------------------------
# the ninth slice: the training loop, checkpoints on disk, resume, remat
# ---------------------------------------------------------------------------

class LoopWatch:
    """Observes a trainer's run through ``ehgr_tpu_torch.train.loop``'s
    module globals without changing what it does: each train step's
    launches (counters read before and after the step's call), its step
    counter and loss; each validation's launches; the non-strict load's
    skipped keys and the keys the model kept from its init; the loop's
    timing records (``record.loop``).  ``first_state(state)``, if given,
    is called with the state before the first step.  Each
    ``make_train_step`` call opens a stage (one a ``run_training``): its
    steps are tagged with its index and timed (the card synchronised
    around the call), and its first step's peak memory above what was
    allocated before it is kept in ``stages``."""

    def __init__(self, torch, first_state=None):
        from ehgr_tpu_torch.train import loop

        self.torch, self.loop, self.first_state = torch, loop, first_state
        self.steps, self.val_launches, self.events = [], [], []
        self.stages, self.transfer = [], None

    def __enter__(self):
        loop, self._saved = self.loop, {}
        for name in ("make_train_step", "validate", "load_for_model"):
            self._saved[name] = getattr(loop, name)
        make, validate, load = (self._saved[k] for k in (
            "make_train_step", "validate", "load_for_model"))

        def make_train_step(*a, **k):
            step = make(*a, **k)
            stage = len(self.stages)
            self.stages.append({})
            cuda = self.torch.cuda

            def watched(state, batch, gen):
                if not self.steps and self.first_state:
                    self.first_state(state)
                first = not self.stages[stage]
                cuda.synchronize()
                if first:
                    cuda.reset_peak_memory_stats()
                    base = cuda.memory_allocated()
                before = _launches()
                t0 = time.perf_counter()
                state, metrics = step(state, batch, gen)
                cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                after = _launches()
                if first:
                    self.stages[stage]["first_step_peak_bytes"] = \
                        cuda.max_memory_allocated() - base
                self.steps.append(dict(
                    step=state.step, loss=metrics["loss"].detach(),
                    launches={k: v - before[k] for k, v in after.items()},
                    stage=stage, ms=ms))
                return state, metrics
            return watched

        def watched_validate(*a, **k):
            before = _launches()
            out = validate(*a, **k)
            after = _launches()
            self.val_launches.append(sum(after.values()) -
                                     sum(before.values()))
            return out

        def watched_load(path, model, strict=False):
            skipped = load(path, model, strict)
            keys = self.torch.load(path, map_location="cpu",
                                   weights_only=True)["state_dict"]
            self.transfer = dict(
                skipped=sorted(skipped),
                taken=sorted(set(keys) - set(skipped)),
                kept_from_init=sorted(set(model.state_dict()) - set(keys)))
            return skipped

        loop.make_train_step = make_train_step
        loop.validate = watched_validate
        loop.load_for_model = watched_load
        self._handler = logging.Handler(logging.INFO)
        self._handler.emit = lambda r: self.events.append(r.loop) \
            if hasattr(r, "loop") else None
        logging.getLogger(loop.__name__).addHandler(self._handler)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.loop, name, fn)
        logging.getLogger(self.loop.__name__).removeHandler(self._handler)
        return False

    def summary(self, name, want, steps, res, wall, launches,
                clips=TRAIN_CLIPS):
        """Gates shared by the trainer phases: ``steps`` steps of ``clips``
        clips, each launching exactly ``want`` (kernel -> count, the others
        0), none in validation, finite losses; returns the phase's JSON
        with each stage's step times and first-step peak memory."""
        want = {k: want.get(k, 0) for k in launches}
        losses = [float(s["loss"]) for s in self.steps]
        for i, s in enumerate(self.steps):
            if s["launches"] != want:
                raise AssertionError(f"{name} step {i}: launches "
                                     f"{s['launches']}, want {want}")
        if len(self.steps) != steps or any(self.val_launches) or \
                not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: {len(self.steps)} steps (want "
                                 f"{steps}), validation launches "
                                 f"{self.val_launches}, losses {losses}")
        epochs = [e for e in self.events if e["event"] == "train"]
        out = dict(
            steps=len(self.steps), clips=clips, launches=launches,
            launches_per_step=self.steps[0]["launches"], losses=losses,
            last_step=self.steps[-1]["step"], wall_s=wall,
            epochs=[dict(epoch=e["epoch"], steps=e["steps"],
                         train_s=e["seconds"],
                         clips_per_s=e["clips"] / e["seconds"],
                         data_time_s=e["data_time"],
                         batch_time_s=e["batch_time"]) for e in epochs],
            validate_s=[e["seconds"] for e in self.events
                        if e["event"] == "validate"],
            saves=[dict(tag=e["tag"], epoch=e["epoch"], s=e["seconds"],
                        bytes=e["bytes"]) for e in self.events
                   if e["event"] == "save"],
            restore=[dict(s=e["seconds"], step=e["step"], epoch=e["epoch"])
                     for e in self.events if e["event"] == "restore"],
            stages=[dict(st, ms_per_step=[s["ms"] for s in self.steps
                                          if s["stage"] == i])
                    for i, st in enumerate(self.stages)],
            result={k: v for k, v in res.items() if k != "run_dir"})
        print(f"{name} " + json.dumps(out), flush=True)
        return out


def loop_argv(tmp, preset, name, *extra):
    """A trainer's flags: ``preset`` at full width on the synthetic videos
    (LOOP_VIDEOS to train on, a quarter of them, at least 16, to validate
    on), 8 clips a batch, runs under ``tmp``, on the card."""
    return ["--preset", preset, "--synthetic", "--synthetic_videos",
            str(LOOP_VIDEOS), "--run_dir", os.path.join(tmp, "runs"),
            "--model_name", name, "--device", "cuda", *extra]


def _ckpt(res, name, tag):
    return os.path.join(res["run_dir"], f"{name}_{tag}_ckpt.pth")


def loop_mtmm(torch, tmp):
    """A main path: ``cli.train_mtmm`` (``ego_mtmm``: ``tsn_mtmm`` at full
    width, bf16, 'vjp', dropout 0.5) for LOOP_EPOCHS epochs of 8 steps with
    validation of the live and the EMA weights each epoch; each step
    launches the four kernels 16 times, validation none; two
    ``metrics.jsonl`` records and the three checkpoint files."""
    from ehgr_tpu_torch.cli import train_mtmm

    with LoopWatch(torch) as w:
        reset_counters()
        t0 = time.perf_counter()
        res = train_mtmm.main(loop_argv(tmp, "ego_mtmm", "mtmm", "--epochs",
                                        str(LOOP_EPOCHS)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
    out = w.summary("loop_mtmm", {**SHIFT_STEP, **MEGA_FORWARD},
                    LOOP_EPOCHS * LOOP_STEPS, res, wall, launches)
    with open(os.path.join(res["run_dir"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    files = sorted(f for f in os.listdir(res["run_dir"]) if f.endswith(".pth"))
    if len(records) != LOOP_EPOCHS or files != [
            "mtmm_best_ckpt.pth", "mtmm_ema_best_ckpt.pth",
            "mtmm_latest_ckpt.pth"]:
        raise AssertionError(f"loop_mtmm: {len(records)} records, files "
                             f"{files}")
    return out, res


def loop_sd(torch, tmp, mtmm):
    """A main path: ``cli.train_sd`` (``ego_sd``) for one epoch from the
    MTMM ``best`` through ``--checkpoint_path``: the skipped keys exactly
    the global decoder's, the keys kept from init exactly the exits'; the
    launches as in ``loop_mtmm``; the exits' top-1 in the result."""
    from ehgr_tpu_torch.cli import train_sd

    with LoopWatch(torch) as w:
        reset_counters()
        t0 = time.perf_counter()
        res = train_sd.main(loop_argv(
            tmp, "ego_sd", "sd", "--epochs", "1", "--checkpoint_path",
            _ckpt(mtmm, "mtmm", "best")))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
    out = w.summary("loop_sd", {**SHIFT_STEP, **MEGA_FORWARD}, LOOP_STEPS,
                    res, wall, launches)
    t = w.transfer
    if t is None or not t["skipped"] or any(
            not k.startswith("global_decoder.") for k in t["skipped"]) or \
            not t["kept_from_init"] or any(
                not k.startswith(("scala", "middle_fc"))
                for k in t["kept_from_init"]) or \
            not {f"mid{i}_top1" for i in (1, 2, 3)} <= set(res):
        raise AssertionError(f"loop_sd: transfer {t}, result {sorted(res)}")
    out["transfer"] = dict(skipped=len(t["skipped"]), taken=len(t["taken"]),
                           kept_from_init=len(t["kept_from_init"]))
    print("loop_sd_transfer " + json.dumps(out["transfer"]), flush=True)
    return out, res


def loop_resume(torch, tmp, mtmm):
    """A main path: ``run_training`` on the MTMM config with
    ``checkpoint_path`` the MTMM ``latest`` and ``resume_full`` (a config
    field, no flag, as in the JAX package) to LOOP_EPOCHS + 1 epochs: the
    state before the first step bitwise the file's (parameters,
    statistics, EMA, momentum, step), the resume at epoch LOOP_EPOCHS,
    LOOP_STEPS more steps, the last step counter (LOOP_EPOCHS + 1) x
    LOOP_STEPS."""
    import dataclasses

    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.data.factory import build_train_datasets
    from ehgr_tpu_torch.train.loop import run_training

    path = _ckpt(mtmm, "mtmm", "latest")
    argv = loop_argv(tmp, "ego_mtmm", "resumed", "--epochs",
                     str(LOOP_EPOCHS + 1))
    cfg = config_from_args([a for a in argv if a not in ("--device", "cuda")],
                           default_preset="ego_mtmm")
    cfg = cfg.replace(run=dataclasses.replace(
        cfg.run, checkpoint_path=path, resume_full=True))
    restored = {}

    def check(state):
        saved = torch.load(path, map_location="cpu", weights_only=True)
        live = {"state_dict": {**state.params, **state.batch_stats},
                "ema_state_dict": {**state.ema_params,
                                   **state.ema_batch_stats},
                "momentum": state.opt_state.momentum}
        restored["step"] = state.step
        restored["bitwise"] = all(
            sorted(live[t]) == sorted(saved[t]) and all(
                torch.equal(v.detach().cpu(), saved[t][k])
                for k, v in live[t].items()) for t in live) and \
            state.step == state.opt_state.step == saved["step"]
        restored["tensors"] = sum(len(live[t]) for t in live)

    with LoopWatch(torch, check) as w:
        reset_counters()
        t0 = time.perf_counter()
        res = run_training(cfg, "mtmm", *build_train_datasets(cfg, "mtmm"),
                           device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
    out = w.summary("loop_resume", {**SHIFT_STEP, **MEGA_FORWARD},
                    LOOP_STEPS, res, wall, launches)
    out["restored"] = restored
    print("loop_resume_restored " + json.dumps(restored), flush=True)
    start = [e["epoch"] for e in w.events if e["event"] == "restore"]
    if not restored.get("bitwise") or \
            restored["step"] != LOOP_EPOCHS * LOOP_STEPS or \
            start != [LOOP_EPOCHS] or \
            out["last_step"] != (LOOP_EPOCHS + 1) * LOOP_STEPS:
        raise AssertionError(f"loop_resume: restored {restored}, start "
                             f"epoch {start}, last step {out['last_step']}")
    return out


def loop_test_sd(torch, tmp, sd):
    """A main path: ``run_test`` on the trained SD ``best`` (the port's own
    full-state file) with the config ``cli.test_sd`` makes of its flags,
    ``--action_fused prologue``, over 32 synthetic videos x 10 clips:
    every key loaded (``_scorer_probs`` raises on a skipped one), 16
    ``action_prologue_window`` launches a forward, the first batch's
    probabilities against the plain model (``run_protocol``)."""
    from ehgr_tpu_torch.configs import config_from_args

    cfg = config_from_args(
        ["--preset", "ego_sd", "--synthetic", "--synthetic_videos", "32",
         "--checkpoint_path", _ckpt(sd, "sd", "best"), "--action_fused",
         "prologue"], default_preset="ego_sd")
    return run_protocol(torch, "loop_test_sd", cfg, "tsn_sd", 4,
                        PROLOGUE_FORWARD, HEADS_BF16_SLACK)


def remat_step(torch, seed):
    """One MTMM step from one state and one batch, without and with
    ``remat`` (partial BN off, as in the presets, so every BN trains):
    the losses equal, each gradient within REMAT_GRAD_TOL of the plain
    step's, every BN running statistic bitwise equal (the recompute
    leaves them alone), the peak memory lower with ``remat``; the
    recompute runs the region's forward again: 32 launches of
    ``action_stats`` / ``action_apply`` a step with it, 16 without, the
    shift kernels 16 either way (the region's backward runs once)."""
    from ehgr_tpu_torch.configs import LossConfig, OptimConfig
    from ehgr_tpu_torch.ops.preprocess_device import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
    from ehgr_tpu_torch.train.optim import build_optimizer
    from ehgr_tpu_torch.train.steps import (create_train_state,
                                            make_train_step)

    batch = make_train_batches(seed, 1)[0]
    runs = {}
    for remat in (False, True):
        model = _train_model(torch, seed, "vjp", torch.bfloat16, 0.5)
        model.base_model.remat = remat
        opt, _ = build_optimizer(model, OptimConfig())
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, stage="mtmm",
                               loss_cfg=LossConfig(depth_size=DEPTH_SIZE),
                               ema_decay=0.9999, mean=IMAGENET_MEAN,
                               std=IMAGENET_STD)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counters()
        t0 = time.perf_counter()
        _, m = step(state, batch,
                    torch.Generator(device="cuda").manual_seed(seed))
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs[remat] = dict(
            loss=loss, ms=ms, launches=_launches(),
            peak_bytes=torch.cuda.max_memory_allocated(),
            step_peak_bytes=torch.cuda.max_memory_allocated() - base,
            grads={k: p.grad.float() for k, p in model.named_parameters()},
            stats={k: v.clone() for k, v in state.batch_stats.items()})
        del model, state, step, opt
    plain, rem = runs[False], runs[True]
    grad_rel = {k: _rel_err(rem["grads"][k], g)[1]
                for k, g in plain["grads"].items()}
    stats_equal = all(torch.equal(rem["stats"][k], v)
                      for k, v in plain["stats"].items())
    worst = max(grad_rel, key=grad_rel.get)
    out = {("remat" if r else "plain"): {k: v[k] for k in (
        "loss", "ms", "launches", "peak_bytes", "step_peak_bytes")}
        for r, v in runs.items()}
    out.update(worst_grad_rel=grad_rel[worst], worst_leaf=worst,
               grad_tol=REMAT_GRAD_TOL, stats_bitwise=stats_equal)
    print("remat " + json.dumps(out), flush=True)
    want = {**SHIFT_STEP, **MEGA_FORWARD}
    want_remat = {**want, **{k: 2 * v for k, v in MEGA_FORWARD.items()}}
    for r, w in ((False, want), (True, want_remat)):
        got = runs[r]["launches"]
        if got != {k: w.get(k, 0) for k in got}:
            raise AssertionError(f"remat={r}: launches {got}, want {w}")
    if rem["loss"] != plain["loss"] or grad_rel[worst] > REMAT_GRAD_TOL \
            or not stats_equal or \
            not rem["step_peak_bytes"] < plain["step_peak_bytes"]:
        raise AssertionError(f"remat vs plain step: {out}")
    return out


# ---------------------------------------------------------------------------
# the tenth slice: the joint MTMM+SD stage and the TSN options
# ---------------------------------------------------------------------------

def joint_train(torch, seed):
    """The joint stage's train step: ``make_train_step(stage='mtmm_sd')``
    on the full-width ``tsn_mtmm_sd`` (``modal='rgb_depth'``, bf16,
    ``'vjp'``, dropout 0.5): 16 launches of each of the four kernels a step
    (``run_steps``); the local decoder's map ``[N*T, 224, 224, 1]`` and the
    global one's ``[N*T, 56, 56, 1]`` (the one the loss reads, against
    the current depth); the first step's peak memory."""
    model = _train_model(torch, seed, "vjp", torch.bfloat16, 0.5,
                         "tsn_mtmm_sd")
    shapes = {}
    for name in ("local_decoder", "global_decoder"):
        getattr(model, name).register_forward_hook(
            lambda mod, i, o, name=name: shapes.__setitem__(
                name, list(o.permute(0, 2, 3, 1).shape)))
    out, _ = run_steps(torch, "joint_train", model, "mtmm_sd", seed,
                       {**SHIFT_STEP, **MEGA_FORWARD})
    out["map_shapes"] = shapes
    print("joint_train_maps " + json.dumps(dict(
        shapes, first_step_peak_bytes=out["first_step_peak_bytes"])),
        flush=True)
    nt = TRAIN_CLIPS * T
    if shapes != {"local_decoder": [nt, CROP, CROP, 1],
                  "global_decoder": [nt, DEPTH_SIZE, DEPTH_SIZE, 1]}:
        raise AssertionError(f"joint_train: decoder maps {shapes}")
    return out


def tpool(torch, seed, batches):
    """``temporal_pool``: T halved after stage 2, the ACTION sites of
    stages 3-4 on T/2 = 4 frames.  ``tsn`` steps of stage ``baseline``
    (``run_steps``, 16 launches of each kernel a step: the one stage that
    trains with the pool, in both packages, since the MTMM depth map and
    the SD exits 1-2 then hold T/2 frames a clip against targets of T); a
    ``tsn`` 'mega' forward of the first
    request batch (16 ``action_stats`` / ``action_apply`` launches, those
    of stages 3-4 at T = 4) and its logits against the plain model's
    (``compare_logits``, BN statistics from that batch as for the served
    model); then both with ``before_softmax=False``: the frames'
    probabilities averaged, 'mega' within LOGIT_TOL of plain in fp32 and
    summing to 1 in bf16."""
    from ehgr_tpu_torch.models.tsn import variant
    from ehgr_tpu_torch.ops.action import ActionConv

    model = variant("tsn", num_class=CLASSES, num_segments=T,
                    temporal="action", action_fused="vjp", partial_bn=False,
                    dropout=0.5, temporal_pool=True, dtype=torch.bfloat16,
                    device="cuda",
                    generator=torch.Generator().manual_seed(seed))
    segs = [m.n_segment for m in model.modules()
            if isinstance(m, ActionConv)]
    trained, _ = run_steps(torch, "tpool_train", model, "baseline", seed,
                           {**SHIFT_STEP, **MEGA_FORWARD})
    del model
    models = [variant("tsn", num_class=CLASSES, num_segments=T,
                      temporal="action", action_fused=mode,
                      temporal_pool=True, dtype=torch.float32, device="cuda",
                      generator=torch.Generator().manual_seed(seed))
              for mode in ("mega", None)]
    mega_model, plain = models
    x = _clips(torch, batches[0][0])
    set_bn_stats(torch, plain, x)
    mega_model.load_state_dict(plain.state_dict())
    mega_model.dtype = torch.bfloat16
    with torch.inference_mode():
        mega_model(x)                              # warm-up
        torch.cuda.synchronize()
        reset_counters()
        mega_model(x)
        torch.cuda.synchronize()
        launches = _launches()
    at_t4 = sorted({w[3:5] for w in WINDOW_LAUNCHES["now"] if w[2] == T // 2})
    logits = compare_logits(torch, mega_model, plain, batches[0][0])
    with torch.inference_mode():
        for m in models:
            m.before_softmax = False
            m.dtype = torch.float32
        err, rel = _rel_err(mega_model(x), plain(x))
        mega_model.dtype = torch.bfloat16
        probs = mega_model(x).float()
    sums = (probs.sum(-1) - 1).abs().max().item()
    out = dict(segments={f"T={t}": segs.count(t) for t in sorted(set(segs))},
               train=trained, forward_launches=launches,
               window_sizes_at_t4=[list(w) for w in at_t4], logits=logits,
               before_softmax_false=dict(
                   fp32_max_abs_err=err, fp32_rel=rel, tol=LOGIT_TOL,
                   bf16_sum_err=sums, bf16_sum_tol=BF16_SUM_TOL))
    print("tpool " + json.dumps({k: v for k, v in out.items()
                                 if k not in ("train", "logits")}),
          flush=True)
    if segs.count(T) != 7 or segs.count(T // 2) != 9:
        raise AssertionError(f"tpool: ACTION sites at T {segs}")
    if launches != {**{k: 0 for k in launches}, **MEGA_FORWARD}:
        raise AssertionError(f"tpool: a 'mega' forward launched {launches}")
    if sorted(sc for sc in at_t4) != sorted(
            {(s, c) for s, c, _, _ in TPOOL_SITES}):
        raise AssertionError(f"tpool: window launches at T/2 {at_t4}")
    if not rel <= LOGIT_TOL or not sums <= BF16_SUM_TOL or \
            probs.shape != (x.shape[0], CLASSES):
        raise AssertionError(f"tpool, before_softmax=False: {out}")
    return out


def loop_mtmm_sd(torch, tmp, mtmm):
    """A main path: ``cli.train_mtmm_sd`` (``ego_mtmm_sd``: ``tsn_mtmm_sd``
    at full width, ``modal='rgb_depth'``, bf16, 'vjp', dropout 0.5) for
    LOOP_EPOCHS epochs of LOOP_STEPS steps, warm-started from the MTMM
    ``best`` through ``--checkpoint_path``: the keys taken from the
    decoder exactly JOINT_TAKEN, those skipped exactly JOINT_SKIPPED, the
    keys kept from init exactly the exits', the local decoder's and the
    joint decoder's others; each step launches the four kernels 16 times,
    validation none; the three checkpoint files."""
    from ehgr_tpu_torch.cli import train_mtmm_sd

    with LoopWatch(torch) as w:
        reset_counters()
        t0 = time.perf_counter()
        res = train_mtmm_sd.main(loop_argv(
            tmp, "ego_mtmm_sd", "joint", "--epochs", str(LOOP_EPOCHS),
            "--checkpoint_path", _ckpt(mtmm, "mtmm", "best")))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
    out = w.summary("loop_mtmm_sd", {**SHIFT_STEP, **MEGA_FORWARD},
                    LOOP_EPOCHS * LOOP_STEPS, res, wall, launches)
    t = w.transfer
    files = sorted(f for f in os.listdir(res["run_dir"]) if f.endswith(".pth"))
    kept_ok = ("scala", "middle_fc", "local_decoder.", "global_decoder.0.",
               "global_decoder.2.", "global_decoder.3.", "global_decoder.4.")
    taken = [k for k in (t or {}).get("taken", ())
             if k.startswith("global_decoder.")]
    if t is None or sorted(t["skipped"]) != sorted(JOINT_SKIPPED) or any(
            not k.startswith(kept_ok) for k in t["kept_from_init"]) or \
            taken != sorted(JOINT_TAKEN) or files != [
            "joint_best_ckpt.pth", "joint_ema_best_ckpt.pth",
            "joint_latest_ckpt.pth"] or not {
                f"mid{i}_top1" for i in (1, 2, 3)} <= set(res):
        raise AssertionError(f"loop_mtmm_sd: transfer {t}, files {files}, "
                             f"result {sorted(res)}")
    out["transfer"] = dict(skipped=len(t["skipped"]), taken=len(t["taken"]),
                           kept_from_init=len(t["kept_from_init"]),
                           taken_from_decoder=taken)
    print("loop_mtmm_sd_transfer " + json.dumps(out["transfer"]), flush=True)
    return out, res


def loop_test_mtmm_sd(torch, tmp, joint):
    """A main path: ``run_test`` on the joint stage's ``best`` with the
    config ``cli.test_sd`` makes of its flags (``tsn_sd``, four heads,
    ``--action_fused prologue``), 32 synthetic videos x 10 clips: every key
    but the two decoders' loaded, 16 ``action_prologue_window`` launches a
    forward, the first batch's probabilities against the plain model
    (``run_protocol``, the gates of ``loop_test_sd``)."""
    from ehgr_tpu_torch.configs import config_from_args

    cfg = config_from_args(
        ["--preset", "ego_sd", "--synthetic", "--synthetic_videos", "32",
         "--checkpoint_path", _ckpt(joint, "joint", "best"),
         "--action_fused", "prologue"], default_preset="ego_sd")
    return run_protocol(torch, "loop_test_mtmm_sd", cfg, "tsn_sd", 4,
                        PROLOGUE_FORWARD, HEADS_BF16_SLACK,
                        ("local_decoder.", "global_decoder."))


# ---------------------------------------------------------------------------
# the fourteenth slice: the other backbone families
# ---------------------------------------------------------------------------

def backbone_checks(torch, mega, fused, shk, tk, n, gen):
    """The kernels against their plain versions at the other backbones'
    site shapes: ``action_stats`` / ``action_apply`` at MobileNetV2's and
    Res2Net's sites at the served batch's ``n`` clips and at TRAIN_CLIPS
    (the train steps'), ``action_prologue`` at BN-Inception's gates at
    ``n``, the learnable shift at the (S, C) of MobileNetV2's sites and
    BN-Inception's gates at TRAIN_CLIPS (Res2Net's are ResNet-50's) and
    ``tsm_shift`` at BN-Inception's gates; fp32 and bf16."""
    sites = MBV2_SITES + RES2_SITES
    checks = check_kernels(torch, mega, n, gen, shapes=[
        (k, T, s, c, f) for k in (n, TRAIN_CLIPS) for s, c, f, _ in sites])[0]
    checks += check_prologue(torch, fused, mega, n, gen, shapes=[
        (n, T, s, c, 0) for s, c, _ in BNI_SITES])
    checks += check_shift(torch, shk, n, gen, shapes=[
        (TRAIN_CLIPS, T, s, c) for s, c in dict.fromkeys(
            [x[:2] for x in MBV2_SITES + BNI_SITES])])
    checks += check_tsm(torch, tk, gen, shapes=[(s, c, FOLD_DIV)
                                                for s, c, _ in BNI_SITES])
    return checks


def backbones(torch, seed, batches, card):
    """Each other backbone family with ACTION at full width (224^2, T=8,
    bf16, weights from ``seed``, BN statistics set from the first batch):
    the request batches served in 'mega' (BN-Inception's gates also in
    'prologue') as the main path, each forward's launches per route against
    BACKBONE_FORWARD, clips/s printed beside ``card`` (name, power limit),
    the logits against the plain model (``compare_logits``); then
    BACKBONE_STEPS 'vjp' train steps (stage ``baseline``, BACKBONE_STEP
    launches each) and the fp32 gradient gate against float64 with every
    BN on batch statistics.  Returns the results and the main paths'
    results by name."""
    from ehgr_tpu_torch.ops.action import ActionConv

    out, paths = {}, {}
    for family in BACKBONES:
        r = out[family] = {}
        model, plain = build_models(torch, seed, batches[0][0], family)
        for mode in ("mega", "prologue") if family == "bn_inception" \
                else ("mega",):
            for m in model.modules():
                if isinstance(m, ActionConv):
                    m.mode = mode
            name = f"{family}_serve_{mode}"
            served = paths[name] = serve(torch, model, batches,
                                         BACKBONE_FORWARD[family], name)
            per = {k: v // len(batches) for k, v in
                   served["launches"].items() if v}
            print(f"backbone_routes {family} {mode} launched a forward "
                  f"{json.dumps(per)} predicted "
                  f"{json.dumps(BACKBONE_FORWARD[family])}", flush=True)
            print(f"backbone_speed {family} {mode} clips/s "
                  f"{served['clips_per_s']:.1f} on {card}", flush=True)
            r[f"serve_{mode}"] = served
            r[f"logits_{mode}"] = compare_logits(torch, model, plain,
                                                 batches[0][0])
        del model, plain
        name = f"{family}_train"
        r["train"], _ = run_steps(
            torch, name, _train_model(torch, seed, "vjp", torch.bfloat16,
                                      0.5, "tsn", base_model=family),
            "baseline", seed, BACKBONE_STEP[family],
            steps=BACKBONE_STEPS[family])
        paths[name] = r["train"]
        r["train_parity"] = train_parity(
            torch, seed, "tsn", "baseline", ("bn_batch",),
            base_model=family,
            zero_grad=BACKBONE_ZERO_GRAD.get(family, lambda keys: ()))
    return out, paths


# ---------------------------------------------------------------------------
# the fifteenth slice: the dress rehearsal, the SD-from-ACTION-Net test CLI,
# GradCAM, the case study and the reproduction chain
# ---------------------------------------------------------------------------

def slice_checks(torch, mega, shk, n, gen):
    """The kernels against their plain versions at the shapes this slice's
    paths give them: ``action_stats`` / ``action_apply`` at every site at
    the rehearsal's 32 clips, GradCAM's 2 and the reproduce smoke's 4 at
    T=4, 32^2 (S = 64 ... 1); the learnable shift at the rehearsal's and
    the smoke's sites; fp32 and bf16."""
    checks = check_kernels(torch, mega, n, gen, shapes=(
        [(k, T) + s[:3] for k in (REHEARSAL_CLIPS, CAM_VIDEOS)
         for s in SITES] +
        [(REPRO_CLIPS, REPRO_T) + s[:3] for s in REPRO_SITES]))[0]
    checks += check_shift(torch, shk, n, gen, shapes=(
        [(REHEARSAL_CLIPS, T, s, c) for s, c, _ in _shift_shapes()] +
        [(REPRO_CLIPS, REPRO_T, s, c)
         for s, c, _ in _shift_shapes(REPRO_SITES)]))
    return checks


def _best_files(root):
    """``rehearsal_best_ckpt.pth`` files under ``root``, by stage."""
    out = {}
    for d, _, files in os.walk(root):
        if "rehearsal_best_ckpt.pth" in files:
            out[os.path.basename(os.path.dirname(d))] = os.path.join(
                d, "rehearsal_best_ckpt.pth")
    return out


def rehearsal(torch, tmp):
    """A main path: ``cli.dress_rehearsal`` at its protocol defaults
    (REHEARSAL_ARGV: 224^2, T=8, 83 classes, 'vjp', 32 clips a step) under
    ``tmp``: MTMM, the SD transfer, SD, the 4-head test.  Each train step
    launches the four kernels 16 times (every stats on the window kernel,
    every shift backward on the strip kernel), validation and the test none
    ('vjp' is the plain formulation at eval); ``ok``, finite losses and
    both stages' best files.  Prints each stage's wall, ms a step and
    first-step peak memory."""
    from ehgr_tpu_torch.cli import dress_rehearsal

    out_dir = os.path.join(tmp, "rehearsal")
    with LoopWatch(torch) as w:
        reset_counters()
        t0 = time.perf_counter()
        report = dress_rehearsal.main(REHEARSAL_ARGV + ["--out", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
    out = w.summary("rehearsal", {**SHIFT_STEP, **MEGA_FORWARD},
                    2 * REHEARSAL_STEPS, report, wall, launches,
                    clips=REHEARSAL_CLIPS)
    best = _best_files(out_dir)
    with open(os.path.join(out_dir, "rehearsal_report.json")) as f:
        written = json.load(f)
    if not report.get("ok") or written != report or \
            not all(math.isfinite(report[k]) for k in ("mtmm_loss",
                                                       "sd_loss")) or \
            sorted(best) != ["MTMM", "SD"] or len(w.stages) != 2:
        raise AssertionError(f"rehearsal: report {report}, best files "
                             f"{best}, stages {w.stages}")
    out["best"] = best
    out["readings"] = dict(
        card=report["card"],
        wall_s={k: report[f"{k}_wall_s"] for k in ("mtmm", "sd", "test")},
        ms_per_step={name: st["ms_per_step"] for name, st in
                     zip(("mtmm", "sd"), out["stages"])},
        first_step_peak_bytes={name: st["first_step_peak_bytes"] for
                               name, st in zip(("mtmm", "sd"),
                                               out["stages"])},
        launches_per_step=out["launches_per_step"])
    print("rehearsal_readings " + json.dumps(out["readings"]), flush=True)
    return out


def sd_actionnet(torch, best):
    """A main path: ``cli.test_sd_actionnet`` on the rehearsal's SD
    ``best`` (``ego_sd`` on the synthetic videos, 2 clips a video as the
    rehearsal tests, 4 videos a forward) in 'prologue' (16
    ``action_prologue_window`` launches a forward) and in 'vjp' (none:
    the plain formulation at eval), the 'vjp' result equal to
    ``cli.test_sd``'s, neither with a confusion matrix; the 'prologue'
    heads held to the plain model's on the first batch by the SD-head gate
    (``_mode_gate``)."""
    from ehgr_tpu_torch.cli import test_sd, test_sd_actionnet
    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.data.factory import build_test_dataset
    from ehgr_tpu_torch.data.pipeline import Loader

    def argv(mode):
        return ["--preset", "ego_sd", "--synthetic", "--synthetic_videos",
                str(RUN_VIDEOS), "--clip_num", "2", "--checkpoint_path",
                best, "--action_fused", mode]

    forwards = max(RUN_VIDEOS // 2, 32) // 4
    out = {}
    for mode, want in (("prologue", PROLOGUE_FORWARD), ("vjp", {})):
        reset_counters()
        t0 = time.perf_counter()
        res = test_sd_actionnet.main(argv(mode) + ["--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        want = {k: want.get(k, 0) * forwards for k in launches}
        if launches != want or "confusion" in res or \
                res["n_videos"] != forwards * 4:
            raise AssertionError(f"sd_actionnet {mode}: launches "
                                 f"{launches}, want {want}, result {res}")
        out[mode] = dict(launches=launches, result=res, seconds=wall,
                         clips_per_s=res["n_videos"] * 2 / wall)
    ref = test_sd.main(argv("vjp") + ["--device", "cuda"])
    if ref != out["vjp"]["result"]:
        raise AssertionError(f"sd_actionnet: 'vjp' {out['vjp']['result']} "
                             f"against cli.test_sd {ref}")
    cfg = config_from_args(argv("prologue"), default_preset="ego_sd")
    frames = next(iter(Loader(build_test_dataset(cfg), batch_size=4,
                              shuffle=False, num_workers=0)))["rgb"]
    out["heads"] = _mode_gate(torch, cfg, "tsn_sd", 4, frames, (),
                              HEADS_BF16_SLACK)
    print("sd_actionnet " + json.dumps(out), flush=True)
    for g in out["heads"]:
        if not g["ok"]:
            raise AssertionError(f"sd_actionnet: {g['head']} probabilities "
                                 f"in 'prologue': {g}")
    return out


def gradcam_phase(torch, seed, batches, tmp):
    """A main path: ``gradcam`` on the full-width ``tsn`` (exit ``final``)
    and ``tsn_sd`` (``final``, ``mid1-3``) built as ``build_models``
    builds them, in fp32 (TF32 off) on CAM_VIDEOS clips of the first
    request batch, class from the argmax: the 'mega' models' calls counted
    (16 ``action_stats`` + 16 ``action_apply`` a call, on the fp32 route);
    the layer taps of the 'mega' and the plain model within TOL (fp32);
    each CAM against the plain model's in float64, within WORST_X times the
    plain fp32 model's error plus CAM_TOL (see CAM_TOL), and the same class
    as the plain fp32 model (the 'mega' CAM's distance from the plain fp32
    one printed beside); one call timed with ``utils.profiling.time_fn``
    and one traced with ``utils.profiling.trace``, whose device kernels
    must include the ACTION kernels."""
    from ehgr_tpu_torch.eval.gradcam import gradcam
    from ehgr_tpu_torch.utils import profiling

    clip = _clips(torch, batches[0][0][:, :1])          # [2, T, 224, 224, 3]
    out, calls, launches = {}, 0, None
    for arch, exits in CAM_EXITS.items():
        mega_model, plain = build_models(torch, seed, batches[0][0],
                                         arch=arch)
        for m in (mega_model, plain):
            m.dtype = torch.float32
        with torch.no_grad():
            taps = [m(clip, return_taps=True)[1] for m in (mega_model, plain)]
        r = out[f"{arch}_taps"] = dict(
            max_rel_err={k: _rel_err(taps[0][k], taps[1][k])[1]
                         for k in ("layer1", "layer2", "layer3", "layer4")},
            tol=TOL["float32"])
        r["ok"] = max(r["max_rel_err"].values()) <= r["tol"]
        del taps
        for ex in exits:
            before = _launches()
            cam, logits = gradcam(mega_model, clip, exit=ex)
            torch.cuda.synchronize()
            after = _launches()
            launches = {k: after[k] - before[k] + (launches or {}).get(k, 0)
                        for k in after}
            calls += 1
            plain_cam, plain_logits = gradcam(plain, clip, exit=ex)
            plain.double().dtype = torch.float64
            ref, _ = gradcam(plain, clip.double(), exit=ex)
            plain.float().dtype = torch.float32
            err = float(np.abs(cam - ref).max())
            plain_err = float(np.abs(plain_cam - ref).max())
            r = out[f"{arch}_{ex}"] = dict(
                cam_shape=list(cam.shape), max_abs_err=err,
                plain_max_abs_err=plain_err,
                tol=WORST_X * plain_err + CAM_TOL,
                vs_plain_fp32=float(np.abs(cam - plain_cam).max()),
                logit_err=float(np.abs(logits - plain_logits).max()),
                cls=int(np.argmax(logits[0])),
                plain_cls=int(np.argmax(plain_logits[0])))
            r["ok"] = bool(err <= r["tol"] and r["cls"] == r["plain_cls"]
                           and np.isfinite(cam).all())
        if arch == "tsn":
            out["time"] = profiling.time_fn(
                lambda: gradcam(mega_model, clip), warmup=1, iters=5)
            with profiling.trace(os.path.join(tmp, "gradcam_trace")) as prof:
                gradcam(mega_model, clip)
            names = {e.key for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")}
            out["traced_action_kernels"] = sorted(
                k for k in names if any(w in k for w in ACTION_KERNEL_WORDS))
            out["trace_bytes"] = os.path.getsize(
                os.path.join(tmp, "gradcam_trace", "trace.json"))
        del mega_model, plain
    want = {k: 0 for k in launches}
    want.update(action_stats=16 * calls, action_apply=16 * calls)
    out["launches"] = launches
    print("gradcam " + json.dumps(out), flush=True)
    bad = [k for k, r in out.items() if isinstance(r, dict) and
           r.get("ok") is False]
    if bad or launches != want or not out["traced_action_kernels"]:
        raise AssertionError(f"gradcam: misses {bad}, launches {launches} "
                             f"(want {want}), traced ACTION kernels "
                             f"{out['traced_action_kernels']}")
    return out


def case_study_phase(torch, seed, batches):
    """A main path: ``case_study_scores`` of the serve model ('mega', bf16)
    on CASE_VIDEOS videos of the synthetic test source ``cli.case_study``
    reads (``ego_baseline``, RUN_CLIPS clips each), 16 + 16 launches a
    video; against the plain model: the fp32 predictions equal and the
    fp32 probabilities within LOGIT_TOL, the bf16 probabilities within the
    logit gate's rule (BF16_SLACK times the plain model's own bf16 error,
    plus LOGIT_TOL), a bf16 prediction that differs only where the fp32
    probabilities of the two classes lie within that bound."""
    import dataclasses

    from ehgr_tpu_torch.configs import get_preset
    from ehgr_tpu_torch.data.factory import build_test_dataset
    from ehgr_tpu_torch.eval.case_study import case_study_scores

    cfg = get_preset("ego_baseline")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               backend="synthetic"))
    data = build_test_dataset(cfg)
    videos = [data[i]["rgb"] for i in range(CASE_VIDEOS)]
    mega_model, plain = build_models(torch, seed, batches[0][0])
    reset_counters()
    t0 = time.perf_counter()
    probs = {("mega", "bfloat16"): [case_study_scores(mega_model, v)
                                    for v in videos]}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    for mode, m in (("mega", mega_model), ("none", plain)):
        for dname in ("bfloat16", "float32"):
            m.dtype = getattr(torch, dname)
            if (mode, dname) not in probs:
                probs[mode, dname] = [case_study_scores(m, v)
                                      for v in videos]
    del mega_model, plain
    p = {k: torch.stack(v) for k, v in probs.items()}
    ref = p["none", "float32"]
    pred = {k: v.argmax(-1).tolist() for k, v in p.items()}
    fp32 = _rel_err(p["mega", "float32"], ref)[1]
    mine = _rel_err(p["mega", "bfloat16"], ref)[1]
    theirs = _rel_err(p["none", "bfloat16"], ref)[1]
    tol = BF16_SLACK * theirs + LOGIT_TOL
    scale = ref.abs().max().item()
    flips = [i for i, (a, b) in enumerate(zip(pred["mega", "bfloat16"],
                                              pred["none", "bfloat16"]))
             if a != b and abs(ref[i, a] - ref[i, b]).item() > tol * scale]
    want = {k: MEGA_FORWARD.get(k, 0) * CASE_VIDEOS for k in launches}
    out = dict(videos=CASE_VIDEOS, clips=RUN_CLIPS, launches=launches,
               seconds=wall, clips_per_s=CASE_VIDEOS * RUN_CLIPS / wall,
               predictions={f"{m}_{d}": v for (m, d), v in pred.items()},
               fp32_rel=fp32, fp32_tol=LOGIT_TOL, bf16_rel=mine,
               plain_bf16_rel=theirs, bf16_tol=tol, bf16_flips=flips)
    print("case_study " + json.dumps(out), flush=True)
    if launches != want or fp32 > LOGIT_TOL or mine > tol or flips or \
            pred["mega", "float32"] != pred["none", "float32"] or \
            not all(torch.isfinite(v).all() for v in p.values()):
        raise AssertionError(f"case_study: {out}, want launches {want}")
    return out


def reproduce_smoke(torch, tmp):
    """A main path: ``cli.reproduce --row ego_mtmm_sd --smoke`` on the card
    (``train_mtmm``, ``train_sd`` from its best, ``test_sd`` on the SD
    best; T=4, 32^2, 4 clips a step, 3 steps a train stage): each step
    launches the four kernels 16 times at S = 64 ... 1, validation and
    the test none; finite stage losses and a ``final_top1``."""
    from ehgr_tpu_torch.cli import reproduce

    results = []
    run_row = reproduce.run_row

    def recorded(row, args):
        results.append(run_row(row, args))
        return results[-1]

    reproduce.run_row = recorded
    try:
        with LoopWatch(torch) as w:
            reset_counters()
            t0 = time.perf_counter()
            rc = reproduce.main(["--row", "ego_mtmm_sd", "--smoke",
                                 "--work_dir", os.path.join(tmp, "repro")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
    finally:
        reproduce.run_row = run_row
    res = results[0]
    out = w.summary("reproduce_smoke", {**SHIFT_STEP, **MEGA_FORWARD},
                    2 * REPRO_STEPS, res, wall, launches, clips=REPRO_CLIPS)
    if rc != 0 or not all(math.isfinite(res[f"stage{i}_train_loss"])
                          for i in (0, 1)) or \
            not 0 <= res.get("final_top1", -1) <= 100:
        raise AssertionError(f"reproduce_smoke: rc {rc}, result {res}")
    return out


# ---------------------------------------------------------------------------
# the sixteenth slice: the last model families (R(2+1)D-18 with its MTMM
# decoder, SlowOnly-R50, VideoMAE-Base, DPT-Large and the MiDaS predictor);
# none has a custom kernel on its path, so each main path must launch none
# ---------------------------------------------------------------------------

# clips / frames of the CPU fp32 reference runs of the card's fp32 outputs
REF_CLIPS = 1
# the card's fp32 outputs against the port's on the CPU (max |d| / max |ref|)
# and the bf16 logits' cosine against the card's fp32 ones
CPU_REL_TOL, BF16_COS = 1e-3, 0.99
# the fp32 gradient gate of r2plus1d_mtmm: clips at R(2+1)D's own 112^2
# (the decoder's map is then 28^2), so its CPU float64 run stays short
V3D_GRAD_CLIPS, V3D_GRAD_CROP = 2, 112
V3D_TRAIN_STEPS = 2
# the trainer CLIs: 16 synthetic videos in batches of 8 = 2 steps
SLICE16_TRAIN_ARGV = ["--synthetic", "--synthetic_videos", "16",
                      "--batch_size", "8", "--epochs", "1", "--device",
                      "cuda"]
VIT_T, VIT_CLIPS = 16, 8
DPT_SIZE, DPT_FRAMES = 384, 8
MIDAS_FRAMES, MIDAS_GEOM = 4, (480, 640)


def _no_launches(name, launches):
    if any(launches.values()):
        raise AssertionError(f"{name}: launches {launches}, want none")


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def card_vs_cpu(torch, name, model, cpu_model, x, bf16=True,
                check_ref=None):
    """The card's fp32 outputs of ``model`` on the first REF_CLIPS clips or
    frames of ``x`` against ``cpu_model`` (the same weights) on the CPU in
    fp32: max |d| / max |ref| within CPU_REL_TOL for each output; with
    ``bf16`` the card's bf16 first output's cosine against its fp32 one
    over all of ``x`` (>= BF16_COS).  ``check_ref`` is called with the
    CPU outputs before any error is read.  The model is left in its compute
    dtype."""
    dtype = model.dtype
    with torch.inference_mode():
        model.dtype = torch.float32
        card = model(x)
        ref = cpu_model(x[:REF_CLIPS].cpu())
        if bf16:
            model.dtype = torch.bfloat16
            low = model(x)
    model.dtype = dtype
    card, ref = (o if isinstance(o, tuple) else (o,) for o in (card, ref))
    out = dict(outputs=[], **(check_ref(ref) if check_ref else {}))
    for c, r in zip(card, ref):
        c = c[:REF_CLIPS]
        err, rel = _rel_err(c.cpu(), r)
        out["outputs"].append(dict(shape=list(c.shape), max_abs_ref=r.abs()
                                   .max().item(), max_abs_err=err,
                                   max_rel_err=rel, tol=CPU_REL_TOL))
        if not (torch.isfinite(c).all() and rel <= CPU_REL_TOL):
            raise AssertionError(f"{name}: card fp32 vs CPU fp32 rel "
                                 f"{rel:.3e}")
    if bf16:
        low = low if isinstance(low, tuple) else (low,)
        out["bf16_cosine"] = _cosine(low[0], card[0])
        out["bf16_max_rel_err"] = _rel_err(low[0], card[0])[1]
        if not out["bf16_cosine"] >= BF16_COS:
            raise AssertionError(f"{name}: bf16 cosine "
                                 f"{out['bf16_cosine']:.5f}")
    print(f"{name}_vs_cpu " + json.dumps(out), flush=True)
    return out


def _cpu_twin(torch, cls, model, **kw):
    """``cls(**kw)`` on the CPU with ``model``'s weights and statistics."""
    twin = cls(device="cpu", **kw)
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return twin.eval()


def _video3d_grads(torch, seed, setting, card):
    """Loss and gradients of one fp32 stage-``mtmm`` forward/backward of
    ``r2plus1d_mtmm`` (dropout 0) at V3D_GRAD_CROP on the card and on the
    CPU in fp32 and float64, from the same weights and batch; ``setting``
    ``bn_running`` sets every BN's statistics from the batch and freezes
    it.  Also the eval outputs of the card against the CPU fp32 run."""
    from ehgr_tpu_torch.configs import LossConfig
    from ehgr_tpu_torch.models.norm import BatchNorm
    from ehgr_tpu_torch.models.video3d import R2Plus1D18
    from ehgr_tpu_torch.ops.preprocess_device import (IMAGENET_MEAN,
                                                      IMAGENET_STD,
                                                      normalize_clip)
    from ehgr_tpu_torch.train.steps import make_loss_fn

    rng = np.random.default_rng(seed + 16)
    shape = (V3D_GRAD_CLIPS, T, V3D_GRAD_CROP, V3D_GRAD_CROP)
    batch = {"rgb": torch.as_tensor(rng.integers(0, 256, shape + (3,),
                                                 dtype=np.uint8)),
             "depth": torch.as_tensor(rng.integers(0, 256, shape + (1,),
                                                   dtype=np.uint8)),
             "label": torch.as_tensor(rng.integers(0, CLASSES,
                                                   (V3D_GRAD_CLIPS,)))}
    base = R2Plus1D18(CLASSES, dropout=0.0, with_depth=True, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    set_bn_stats(torch, base, normalize_clip(batch["rgb"]))
    state = base.state_dict()
    runs = {}
    for name, dev, dtype in (("card", "cuda", torch.float32),
                             ("cpu", "cpu", torch.float32),
                             ("float64", "cpu", torch.float64)):
        model = R2Plus1D18(CLASSES, dropout=0.0, with_depth=True,
                           device=dev)
        model.load_state_dict(state)
        model.to(dtype).dtype = dtype
        if name != "float64":
            x = normalize_clip(batch["rgb"].to(dev))
            with torch.inference_mode():
                runs[f"{name}_eval"] = [o.cpu() for o in model.eval()(x)]
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.frozen = setting == "bn_running"
        loss_fn = make_loss_fn(model.train(), stage="mtmm",
                               loss_cfg=LossConfig(
                                   depth_size=V3D_GRAD_CROP // 4),
                               mean=IMAGENET_MEAN, std=IMAGENET_STD)
        total, _, _ = loss_fn({k: v.to(dev) for k, v in batch.items()},
                              None)
        total.backward()
        runs[name] = (total.item(), {k: p.grad.double().cpu()
                                     for k, p in model.named_parameters()})
    eval_rel = [_rel_err(c, r)[1] for c, r in zip(runs["card_eval"],
                                                  runs["cpu_eval"])]
    if not max(eval_rel) <= CPU_REL_TOL:
        raise AssertionError(f"r2plus1d_mtmm eval at {V3D_GRAD_CROP}^2: "
                             f"card vs CPU rel {eval_rel}")
    loss64, ref = runs["float64"]
    errs = {name: {k: _rel_err(g[k], ref[k])[1] for k in ref}
            for name, (_, g) in runs.items() if name in ("card", "cpu")}
    stat = {name: _grad_stats(e) for name, e in errs.items()}
    tol = {q: x * stat["cpu"][q] + GRAD_TOL
           for q, x in (("median", GRAD_X), ("p95", GRAD_X),
                        ("worst", WORST_X))}
    loss_rel = abs(runs["card"][0] - runs["cpu"][0]) / abs(runs["cpu"][0])
    out = dict(setting=setting, crop=V3D_GRAD_CROP, clips=V3D_GRAD_CLIPS,
               eval_card_vs_cpu_rel=eval_rel, loss_card=runs["card"][0],
               loss_cpu=runs["cpu"][0], loss_float64=loss64,
               loss_rel=loss_rel, n_grads=len(ref),
               card_vs_float64=stat["card"], cpu_vs_float64=stat["cpu"],
               tol=tol, card=card)
    print("video3d_grad_parity " + json.dumps(out), flush=True)
    if not loss_rel <= CPU_REL_TOL:
        raise AssertionError(f"{setting}: loss card {runs['card'][0]} vs "
                             f"CPU {runs['cpu'][0]}")
    for q in tol:
        if not stat["card"][q] <= tol[q]:
            raise AssertionError(
                f"{setting}: {q} gradient error against float64: card "
                f"{stat['card'][q]:.3e}, CPU fp32 {stat['cpu'][q]:.3e}")
    return out


def _trainer_cli(torch, name, main, argv):
    """A trainer CLI at SLICE16_TRAIN_ARGV as a main path: 2 steps of 8
    clips launching no kernel, none in validation, its three checkpoint
    files; each step's ms (the first with cuDNN's plan search apart) and the
    first step's peak memory."""
    with LoopWatch(torch) as w:
        reset_counters()
        t0 = time.perf_counter()
        res = main(SLICE16_TRAIN_ARGV + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
    out = w.summary(name, {}, 2, res, wall, launches, clips=8)
    files = sorted(f for f in os.listdir(res["run_dir"])
                   if f.endswith(".pth"))
    if len(files) != 3:
        raise AssertionError(f"{name}: checkpoint files {files}")
    return out


def video3d_phase(torch, seed, batches, tmp, card):
    """R(2+1)D-18 (83 classes, T=8, 224^2, bf16) serving the request
    batches (2 videos x 10 clips a forward) after its card-vs-CPU gate,
    one scorer call traced;
    ``r2plus1d_mtmm``: V3D_TRAIN_STEPS ``make_train_step(stage='mtmm')``
    steps of 8 clips (one parameter group) and the fp32 gradient gate
    against float64 in both BN settings; SlowOnly-R50:
    ``cli.train_slowonly --synthetic`` (2 steps of 8 clips) and a served
    forward after its gate.  Every main path launches no kernel."""
    from ehgr_tpu_torch.cli import train_slowonly
    from ehgr_tpu_torch.models.video3d import R2Plus1D18, SlowOnlyR50

    out, paths = {}, {}
    clips = _clips(torch, batches[0][0])
    for arch, cls in (("r2plus1d", R2Plus1D18), ("slowonly", SlowOnlyR50)):
        model = cls(CLASSES, device="cuda",
                    generator=torch.Generator().manual_seed(seed))
        set_bn_stats(torch, model, clips)
        out[f"{arch}_vs_cpu"] = card_vs_cpu(
            torch, arch, model, _cpu_twin(torch, cls, model,
                                          num_class=CLASSES), clips)
        model.dtype = torch.bfloat16
        served = paths[f"{arch}_serve"] = serve(torch, model, batches, {},
                                                f"{arch}_serve")
        print(f"video3d_speed {arch} serve clips/s "
              f"{served['clips_per_s']:.1f} on {card}", flush=True)
        out[f"{arch}_serve"] = served
        out[f"{arch}_profile"] = profile_forward(
            torch, model, batches[0][0], name=f"{arch}_profile",
            shapes=True)
        del model
    model = R2Plus1D18(CLASSES, with_depth=True, dtype=torch.bfloat16,
                       device="cuda",
                       generator=torch.Generator().manual_seed(seed))
    out["r2plus1d_mtmm_train"], _ = run_steps(
        torch, "r2plus1d_mtmm_train", model, "mtmm", seed, {},
        steps=V3D_TRAIN_STEPS, policies=False)
    paths["r2plus1d_mtmm_train"] = out["r2plus1d_mtmm_train"]
    del model
    out["r2plus1d_mtmm_grad"] = [_video3d_grads(torch, seed, s, card)
                                 for s in ("bn_batch", "bn_running")]
    out["slowonly_train"] = paths["slowonly_train"] = _trainer_cli(
        torch, "slowonly_train", train_slowonly.main,
        ["--run_dir", os.path.join(tmp, "slowonly"), "--model_name",
         "slowonly"])
    out["card"] = card
    return out, paths


def videomae_phase(torch, seed, tmp, card):
    """VideoMAE-Base (ViT-B/16: 768 dim, 12 layers, 12 heads; T=16, 224^2,
    1568 tokens, 83 classes): the card-vs-CPU gate on one clip, a bf16
    forward of VIT_CLIPS clips (clips/s) launching no kernel, then
    ``cli.train_videomae --synthetic --clip_len 16`` (2 steps of 8 clips;
    the first step's peak memory, set by the fp32 softmax of 12 x 1568^2
    scores a clip and a layer); the forward traced once."""
    from ehgr_tpu_torch.cli import train_videomae
    from ehgr_tpu_torch.models.videomae import VideoMAE
    from ehgr_tpu_torch.ops.preprocess_device import normalize_clip

    rng = np.random.default_rng(seed + 17)
    frames = torch.as_tensor(rng.integers(
        0, 256, (VIT_CLIPS, VIT_T, CROP, CROP, 3), dtype=np.uint8)).cuda()
    x = normalize_clip(frames)
    model = VideoMAE(CLASSES, device="cuda",
                     generator=torch.Generator().manual_seed(seed))
    out = {"vs_cpu": card_vs_cpu(torch, "videomae", model,
                                 _cpu_twin(torch, VideoMAE, model,
                                           num_class=CLASSES), x)}
    model.dtype = torch.bfloat16
    with torch.inference_mode():
        model(x)                                     # warm-up
        torch.cuda.synchronize()
        reset_counters()
        ms = _time_ms(torch, lambda: model(x), reps=5)
        launches = _launches()
        logits = model(x)
    _no_launches("videomae_forward", launches)
    if logits.shape != (VIT_CLIPS, CLASSES) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"videomae forward: {logits.shape}")
    fwd = out["forward"] = dict(clips=VIT_CLIPS, t=VIT_T, ms=ms,
                                clips_per_s=VIT_CLIPS / ms * 1e3,
                                launches=launches)
    print(f"videomae_forward {json.dumps(fwd)} on {card}", flush=True)
    with torch.inference_mode():
        out["profile"] = _device_profile(torch, lambda: model(x))
    print("videomae_profile " + json.dumps(out["profile"]), flush=True)
    del model, x
    out["train"] = _trainer_cli(
        torch, "videomae_train", train_videomae.main,
        ["--clip_len", str(VIT_T), "--run_dir",
         os.path.join(tmp, "videomae"), "--model_name", "videomae"])
    out["card"] = card
    return out, {"videomae_forward": fwd, "videomae_train": out["train"]}


def _midas_keyed(torch, model, seed):
    """``model``'s weights as an official MiDaS state dict (plus
    refinenet4's ``resConfUnit1``, which MiDaS holds and never calls)."""
    from ehgr_tpu_torch.models.dpt import midas_key_map

    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    out = {k: sd[p] for k, p in midas_key_map(model).items()}
    g = torch.Generator().manual_seed(seed)
    for c in ("conv1", "conv2"):
        for leaf in ("weight", "bias"):
            ref = sd[f"refinenet4.res2.{c}.{leaf}"]
            out[f"scratch.refinenet4.resConfUnit1.{c}.{leaf}"] = \
                torch.randn(ref.shape, generator=g)
    return out


def dpt_phase(torch, seed, tmp, card):
    """DPT-Large (1024 dim, 24 layers, 577 tokens at 384^2), fp32: the
    card-vs-CPU gate on one frame (the reference depth checked to be
    non-degenerate first), a forward of DPT_FRAMES frames (ms a frame)
    launching no kernel, traced once; then ``midas_predictor`` on a file the phase
    saves from the model, keyed as MiDaS keys it, over MIDAS_FRAMES
    synthetic 480x640 frames (ms a frame, each depth in [0, 1], the first
    against the model's own depth of that frame), and through
    ``generate_pseudo_depth_tree`` over the same frames as a JPEG tree
    (ms a frame with the JPEG decode and encode).  The head's last bias is
    set to 1, so the random model's depth after its final ReLU is mostly
    nonzero."""
    from ehgr_tpu_torch.data.pseudo_depth import midas_predictor
    from ehgr_tpu_torch.models.dpt import DPT, dpt_large
    from ehgr_tpu_torch.ops.preprocess_device import resize_clip

    rng = np.random.default_rng(seed + 18)
    frames = torch.as_tensor(rng.integers(
        0, 256, (DPT_FRAMES, DPT_SIZE, DPT_SIZE, 3), dtype=np.uint8)).cuda()
    x = (frames.float() / 255.0 - 0.5) / 0.5
    model = dpt_large(device="cuda",
                      generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.head_conv3.bias.fill_(1.0)
    def non_degenerate(ref):
        top = ref[0].abs().max().item()
        zero = (ref[0] == 0).float().mean().item()
        if not (top > 0 and zero < 0.5):
            raise AssertionError(f"dpt: degenerate reference depth (max "
                                 f"{top}, {zero:.2f} zero)")
        return dict(ref_zero_share=zero)

    out = {"vs_cpu": card_vs_cpu(torch, "dpt", model,
                                 _cpu_twin(torch, DPT, model),
                                 x[:REF_CLIPS], bf16=False,
                                 check_ref=non_degenerate)}
    with torch.inference_mode():
        model(x)                                     # warm-up
        torch.cuda.synchronize()
        reset_counters()
        ms = _time_ms(torch, lambda: model(x), reps=3)
        launches = _launches()
        depth = model(x)
    _no_launches("dpt_forward", launches)
    if depth.shape != (DPT_FRAMES, DPT_SIZE, DPT_SIZE) or \
            not torch.isfinite(depth).all():
        raise AssertionError(f"dpt forward: {depth.shape}")
    fwd = out["forward"] = dict(frames=DPT_FRAMES, size=DPT_SIZE, ms=ms,
                                ms_per_frame=ms / DPT_FRAMES,
                                launches=launches)
    print(f"dpt_forward {json.dumps(fwd)} on {card}", flush=True)
    with torch.inference_mode():
        out["profile"] = _device_profile(torch, lambda: model(x))
    print("dpt_profile " + json.dumps(out["profile"]), flush=True)

    path = os.path.join(tmp, "dpt_large-midas-2f21e586.pt")
    torch.save(_midas_keyed(torch, model, seed), path)
    predict = midas_predictor(path, "cuda")
    h, w = MIDAS_GEOM
    pics = rng.integers(0, 256, (MIDAS_FRAMES, h, w, 3), dtype=np.uint8)
    predict(pics[0])                                 # warm-up
    reset_counters()
    t0 = time.perf_counter()
    maps = [predict(p) for p in pics]
    secs = time.perf_counter() - t0
    launches = _launches()
    _no_launches("midas_predictor", launches)
    for d in maps:
        if d.shape != (h, w) or not (d.min() == 0.0 and d.max() == 1.0):
            raise AssertionError(f"midas_predictor: {d.shape}, "
                                 f"[{d.min()}, {d.max()}]")
    s = 384.0 / min(h, w)                  # the predictor's geometry
    size = tuple(max(32, int(round(n * s / 32)) * 32) for n in (h, w))
    with torch.inference_mode():
        p = torch.as_tensor(pics[0]).cuda()[None].float() / 255.0
        inv = model((resize_clip(p, size) - 0.5) / 0.5)
        inv = resize_clip(inv[..., None], (h, w))[0, ..., 0]
        inv = ((inv - inv.min()) / (inv.max() - inv.min())).cpu().numpy()
    own = float(np.abs(maps[0] - inv).max())
    if not own <= 1e-4:
        raise AssertionError(f"midas_predictor vs the model: {own}")
    # the offline prep's path: a Color/rgb1 JPEG tree -> Depth_Est
    from PIL import Image

    from ehgr_tpu_torch.data.pseudo_depth import generate_pseudo_depth_tree

    root = os.path.join(tmp, "frames")
    color = os.path.join(root, "Subject01", "Scene1", "Color", "rgb1")
    os.makedirs(color)
    for i, pic in enumerate(pics):
        Image.fromarray(pic).save(os.path.join(color, f"{i + 1:06d}.jpg"))
    reset_counters()
    t0 = time.perf_counter()
    written = generate_pseudo_depth_tree(root, root, predictor=predict)
    tree_secs = time.perf_counter() - t0
    tree_launches = _launches()
    _no_launches("pseudo_depth_tree", tree_launches)
    est = os.path.join(root, "Subject01", "Scene1", "Depth_Est",
                       "depth_est1", "000001.jpg")
    with Image.open(est) as im:
        size = im.size
    if written != MIDAS_FRAMES or size != (w, h):
        raise AssertionError(f"pseudo-depth tree: {written} frames, "
                             f"{size}")
    mid = out["midas"] = dict(frames=MIDAS_FRAMES, geom=list(MIDAS_GEOM),
                              seconds=secs,
                              ms_per_frame=secs / MIDAS_FRAMES * 1e3,
                              vs_model_max_abs=own, launches=launches,
                              tree_frames=written,
                              tree_ms_per_frame=tree_secs / written * 1e3,
                              tree_launches=tree_launches)
    print(f"midas_predictor {json.dumps(mid)} on {card}", flush=True)
    out["card"] = card
    return out, {"dpt_forward": fwd, "midas_predictor": mid}


def slice16(torch, seed, batches, phases):
    """The sixteenth slice's phases (``video3d``, ``videomae``, ``dpt``),
    each timed into ``phases`` and their seconds printed, under one
    temporary directory.  Returns their results and their main paths'
    results by name."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    out, paths = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn, args in (
                ("video3d", video3d_phase, (batches, tmp, smi)),
                ("videomae", videomae_phase, (tmp, smi)),
                ("dpt", dpt_phase, (tmp, smi))):
            t0 = time.perf_counter()
            out[name], p = fn(torch, seed, *args)
            phases[name] = time.perf_counter() - t0
            paths.update(p)
    names = ("video3d", "videomae", "dpt")
    print("slice16_phase_seconds " + json.dumps(
        {**{k: phases[k] for k in names},
         "total": sum(phases[k] for k in names)}), flush=True)
    return out, paths


# ---------------------------------------------------------------------------
# the seventeenth slice: the mesh over torch.distributed (data parallelism
# with global BN statistics, tensor-parallel heads), its ranks on this card
# ---------------------------------------------------------------------------

# the TP cell's class count divides the model axis, so the heads shard
# (dryrun_multichip's 16); the DP cell runs the recipe's 83
MESH_TP_CLASSES = 16
# each rank's clips in the DP cell (TRAIN_CLIPS over data=2): the kernels
# are checked at this count before the ranks run
MESH_RANK_CLIPS = TRAIN_CLIPS // 2
# BN running statistics after the mesh's fp32 step against the one-process
# step's: per statistic, max |diff| / max |one-process|
MESH_STAT_TOL = 1e-5
# each collective's timeout and the whole run's limit (s)
MESH_GROUP_S, MESH_JOIN_S = 300.0, 900.0
# bf16 steps timed after a warm-up, on the ranks and in one process
MESH_STEPS = 3
# launches of one fp32 'vjp' step of tsn_mtmm_sd (fp32 takes the sweep
# routes): the four kernels 16 times each
MESH_F32_STEP = {"action_stats": 16, "action_apply": 16,
                 "learnable_shift_fwd": 16, "learnable_shift_bwd": 16}
# launches of one tsn_middle2 forward in 'prologue' (stages 1-2: 7 sites)
MIDDLE2_FORWARD = {"action_prologue": 7, "action_prologue_window": 7}


def _mesh_batch(seed, classes):
    """The train phase's first batch of TRAIN_CLIPS clips, labels under
    ``classes``."""
    b = make_train_batches(seed, 1)[0]
    return dict(b, label=b["label"] % classes)


def _mesh_step(torch, mesh, seed, classes, tp, dtype):
    """``make_train_step(stage='mtmm_sd')`` on the full-width
    ``tsn_mtmm_sd`` ('vjp', every BN on batch statistics; dropout 0 in
    fp32 for the gate, 0.5 in bf16 as the train phase) from ``seed``, on
    ``mesh`` (replicated from rank 0, heads sharded with ``tp``) or in one
    process (``mesh`` None): (model, optimizer, state, step)."""
    from ehgr_tpu_torch.configs import LossConfig, OptimConfig
    from ehgr_tpu_torch.ops.preprocess_device import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
    from ehgr_tpu_torch.parallel.mesh import replicated, shard_model
    from ehgr_tpu_torch.train.optim import build_optimizer
    from ehgr_tpu_torch.train.steps import (create_train_state,
                                            make_train_step)

    model = _train_model(torch, seed, "vjp", dtype,
                         0.0 if dtype == torch.float32 else 0.5,
                         "tsn_mtmm_sd", classes=classes)
    if mesh is not None:
        replicated(mesh, model.state_dict().values())
        shard_model(model, mesh, tp)
    opt, _ = build_optimizer(model, OptimConfig(lr=0.00125,
                                                weight_decay=1e-5),
                             partial_bn=False)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, stage="mtmm_sd",
                           loss_cfg=LossConfig(depth_size=DEPTH_SIZE),
                           ema_decay=0.9999, mean=IMAGENET_MEAN,
                           std=IMAGENET_STD, mesh=mesh)
    return model, opt, state, step


def _mesh_grad_step(torch, mesh, seed, classes, tp, batch):
    """One fp32 step: its loss, launches, the gradients it applied (on a
    mesh: SUMmed over the data group), the BN running statistics after it,
    and the state."""
    model, opt, state, step = _mesh_step(torch, mesh, seed, classes, tp,
                                         torch.float32)
    reset_counters()
    _, m = step(state, batch, torch.Generator(device="cuda").manual_seed(
        seed))
    loss = float(m["loss"])
    torch.cuda.synchronize()
    return dict(loss=loss, launches=_launches(), opt=opt, state=state,
                grads={k: p.grad.detach() for k, p in
                       model.named_parameters() if p.grad is not None})


def _collective_time(torch, fn):
    """One call of ``fn`` with every SUM of ``parallel/collectives.py`` (the
    BN moments, the gradients, the metrics) timed on the host, the card
    synchronized just before and just after each: the call's ms, the ms
    inside those SUMs, their count and their bytes.  The synchronizations
    serialize what the call would overlap, so the call's ms is beside the
    untimed steps' for comparison."""
    from ehgr_tpu_torch.parallel import collectives

    plain = collectives._sum_
    acc = dict(ms=0.0, calls=0, bytes=0)

    def timed(t, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = plain(t, group)
        torch.cuda.synchronize()
        acc["ms"] += (time.perf_counter() - t0) * 1e3
        acc["calls"] += 1
        acc["bytes"] += t.numel() * t.element_size()
        return r

    collectives._sum_ = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        collectives._sum_ = plain
    return dict(step_ms=wall, collective_ms=acc["ms"],
                collective_share=acc["ms"] / wall, calls=acc["calls"],
                bytes=acc["bytes"])


def _mesh_bf16_steps(torch, mesh, seed, classes, tp, batch):
    """A bf16 warm-up step, then MESH_STEPS timed, each step's launches;
    on a mesh, then one step with its collectives timed
    (``_collective_time``)."""
    _, _, state, step = _mesh_step(torch, mesh, seed, classes, tp,
                                   torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    step(state, batch, gen)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    ms, per = [], []
    for _ in range(MESH_STEPS):
        reset_counters()
        t0 = time.perf_counter()
        _, m = step(state, batch, gen)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        per.append(_launches())
        if not math.isfinite(loss):
            raise AssertionError(f"bf16 mesh step loss {loss}")
    out = dict(first_step_ms=first, ms_per_step=ms,
               mean_ms_per_step=sum(ms) / len(ms), launches=per[0],
               same_launches_each_step=all(p == per[0] for p in per))
    if mesh is not None:
        out["collectives"] = _collective_time(
            torch, lambda: step(state, batch, gen))
    return out


def _sha1(t):
    import hashlib

    return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()


def _state_trees(state):
    return {"params": state.params, "batch_stats": state.batch_stats,
            "ema_params": state.ema_params,
            "ema_batch_stats": state.ema_batch_stats,
            "momentum": state.opt_state.momentum}


def _mesh_scorer(torch, mesh, arch, classes, tp, path, mode, frames):
    """``make_sharded_score_fn`` (bf16) of the ``arch`` model saved at
    ``path``, after a warm-up call: the probabilities of ``frames`` and
    that call's launches."""
    from ehgr_tpu_torch.eval.inference import make_sharded_score_fn
    from ehgr_tpu_torch.models.tsn import variant

    model = variant(arch, num_class=classes, num_segments=T,
                    action_fused=mode, device="cuda")
    model.load_state_dict(torch.load(path, map_location="cuda",
                                     weights_only=True))
    model.dtype = torch.bfloat16
    score = make_sharded_score_fn(model, mesh, model_parallel=tp,
                                  crop_size=CROP, dtype_name="bfloat16")
    score(frames)
    torch.cuda.synchronize()
    reset_counters()
    probs = score(frames)
    torch.cuda.synchronize()
    return dict(probs=probs, launches=_launches())


def mesh_rank(mesh, cell, seed, classes, tp, batch, jobs, files=None,
              frames=None):
    """One rank of the mesh phase (``run_ranks`` imports it from this
    file): ``jobs`` in order, each with its launches counted apart --
    ``grad`` (one fp32 step; rank 0 returns its gradients and BN
    statistics, the other model ranks of data index 0 their head shards'
    gradients), ``save`` (the state after it gathered by
    ``state_payload`` and written by rank 0 to ``files['ckpt']``; each
    rank of data index 0 returns its live state, replicated tensors as
    SHA-1s, head shards as they are), ``bf16`` (timed bf16 steps),
    ``score`` / ``middle2`` (the sharded scorer of ``files['serve']`` in
    'mega' / of ``files['middle2']`` in 'prologue' over ``frames``),
    ``collectives`` (an all_reduce and a broadcast of CUDA tensors over the
    world).  Prints its launches; returns the window kernels' sizes it
    launched."""
    import torch
    import torch.distributed as dist
    from ehgr_tpu_torch.ops.kernels import action_fused as fused
    from ehgr_tpu_torch.ops.kernels import action_mega as mega

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record_window_launches(mega, fused)
    lead = mesh.data_index == 0
    out = {"rank": mesh.rank, "device": str(mesh.device)}
    launches = {}
    for job in jobs:
        if job == "grad":
            r = _mesh_grad_step(torch, mesh, seed, classes, tp, batch)
            shards = r["state"].head_shards
            out["grad"] = dict(loss=r["loss"], grads={
                k: g for k, g in r["grads"].items()
                if mesh.rank == 0 or (lead and k in shards)})
            if mesh.rank == 0:
                out["grad"]["stats"] = dict(r["state"].batch_stats)
            launches[job] = r["launches"]
            if "save" not in jobs:
                r = None
        elif job == "save":
            from ehgr_tpu_torch.train.checkpoints import state_payload

            payload = state_payload(r["state"], r["opt"])
            if mesh.rank == 0:
                torch.save(payload, files["ckpt"])
            if lead:
                out["live"] = {name: {
                    k: v if k in shards else _sha1(v) for k, v in t.items()
                    if mesh.rank == 0 or k in shards}
                    for name, t in _state_trees(r["state"]).items()}
                out["head_shards"] = dict(shards)
            payload = r = None
        elif job == "bf16":
            out[job] = _mesh_bf16_steps(torch, mesh, seed, classes, tp,
                                        batch)
            launches[job] = out[job]["launches"]
        elif job in ("score", "middle2"):
            arch, mode = ("tsn", "mega") if job == "score" else \
                ("tsn_middle2", "prologue")
            out[job] = _mesh_scorer(torch, mesh, arch, classes, tp,
                                    files[job], mode, frames)
            launches[job] = out[job]["launches"]
        elif job == "collectives":
            world = dist.get_world_size()
            t = torch.full((4,), float(mesh.rank + 1), device="cuda")
            dist.all_reduce(t)
            b = torch.arange(4.0, device="cuda") * (mesh.rank == 0)
            dist.broadcast(b, 0)
            out[job] = dict(
                backend=dist.get_backend(),
                all_reduce=t.tolist() == [world * (world + 1) / 2] * 4,
                broadcast=b.tolist() == [0.0, 1.0, 2.0, 3.0])
        torch.cuda.empty_cache()
    out["launches"] = launches
    out["window"] = sorted(WINDOW_LAUNCHES["main"] | WINDOW_LAUNCHES["now"])
    print(f"mesh_rank {cell} rank {mesh.rank} (data {mesh.data_index}, "
          f"model {mesh.model_index}) launches " + json.dumps(launches),
          flush=True)
    return out


def _np_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _mesh_grad_gate(name, grads, ref, plain):
    """train_parity's rule on the mesh's fp32 gradients: against the
    one-process float64 run of the plain model, the one-process fp32 plain
    run the floor; BN_FED_BIASES held within ZERO_GRAD_REL of their
    weights' largest gradient."""
    zero = [k for k in BN_FED_BIASES if k in ref]
    zero_rel = {k: float(np.abs(grads[k]).max() / np.abs(
        grads[k[:-len("bias")] + "weight"]).max()) for k in zero}
    errs = {k: _np_rel(grads[k], ref[k]) for k in ref if k not in zero}
    floor = {k: _np_rel(plain[k], ref[k]) for k in ref if k not in zero}
    stat, fstat = _grad_stats(errs), _grad_stats(floor)
    tol = {q: x * fstat[q] + GRAD_TOL
           for q, x in (("median", GRAD_X), ("p95", GRAD_X),
                        ("worst", WORST_X))}
    r = dict(n_grads=len(ref), mesh_vs_float64=stat,
             plain_vs_float64=fstat, tol=tol, zero_grad_rel=zero_rel)
    if any(v > ZERO_GRAD_REL for v in zero_rel.values()):
        raise AssertionError(f"{name}: gradient of a BN-fed bias {zero_rel}")
    for q in tol:
        if not stat[q] <= tol[q]:
            raise AssertionError(
                f"{name}: {q} gradient error against float64: mesh "
                f"{stat[q]:.3e}, plain {fstat[q]:.3e}")
    return r


def _check_rank_launches(name, outs, want):
    """Every rank's launches of each job equal ``want[job]`` (kernel ->
    count, the others 0): the four kernels of the train step 16 times each
    on every rank of a training job."""
    for o in outs:
        for job, got in o["launches"].items():
            w = {k: want[job].get(k, 0) for k in got}
            if got != w:
                raise AssertionError(f"{name} rank {o['rank']} {job}: "
                                     f"launches {got}, want {w}")


def _mesh_serve_files(torch, seed, frames, tmp):
    """The TP cell's serve and ``tsn_middle2`` weights (16 classes, BN
    statistics set from ``frames`` as ``build_models`` sets them), saved
    for the ranks; and the one-process references of both: the live bf16
    scorer's probabilities (the kernels) and the fp32 plain model's."""
    from ehgr_tpu_torch.eval.inference import make_score_fn
    from ehgr_tpu_torch.models.tsn import variant

    files, refs = {}, {}
    for job, arch, mode in (("score", "tsn", "mega"),
                            ("middle2", "tsn_middle2", "prologue")):
        models = [variant(arch, num_class=MESH_TP_CLASSES, num_segments=T,
                          action_fused=m, dtype=torch.float32, device="cuda",
                          generator=torch.Generator().manual_seed(seed))
                  for m in (mode, None)]
        set_bn_stats(torch, models[1], _clips(torch, frames))
        models[0].load_state_dict(models[1].state_dict())
        files[job] = os.path.join(tmp, f"mesh_{job}.pth")
        torch.save(models[1].state_dict(), files[job])
        probs = {}
        for name, m, dname in (("live", models[0], "bfloat16"),
                               ("plain_fp32", models[1], "float32")):
            m.dtype = getattr(torch, dname)
            probs[name] = make_score_fn(m, device="cuda", crop_size=CROP,
                                        dtype_name=dname)(frames).float() \
                .cpu().numpy()
        refs[job] = probs
        del models
    return files, refs


def mesh_phase(torch, seed, mega, shk, gen, batches):
    """The mesh (``parallel/mesh.py``) on this card, at full width (TSN +
    ACTION ResNet-50, T=8, 224^2, TRAIN_CLIPS clips a global batch), held
    to one process on the same card:

    (a) data=2, model=1: two ranks share the card over gloo, 83 classes
        (heads replicated): one fp32 ``mtmm_sd`` step, its all-reduced
        gradients by train_parity's rule against a float64 one-process run
        of the plain model, its BN running statistics within
        MESH_STAT_TOL of the one-process fp32 step's and its loss within
        LOSS_TOL; then bf16 steps timed, beside the same steps in one
        process;
    (b) data=1, model=2 at MESH_TP_CLASSES (the heads shard): the same
        step gate; the state's checkpoint (gathered) restored in one
        process bitwise; the sharded scorer ('mega', bf16) on the first
        request batch and the ``tsn_middle2`` deploy ('prologue') against
        the fp32 plain model within BF16_SLACK times the live scorer's own
        bf16 error plus LOGIT_TOL;
    (c) NCCL: one rank on cuda:0 (an all_reduce and a broadcast, bf16
        steps); two ranks when the machine has two cards.

    The kernels are first checked at each rank's MESH_RANK_CLIPS clips.
    Every rank's launches are counted per job and must be as one process
    makes them; their window sizes join the coverage check."""
    from ehgr_tpu_torch.parallel.mesh import run_ranks
    from ehgr_tpu_torch.train.checkpoints import load_train_state

    t_phase = time.perf_counter()
    checks = check_kernels(torch, mega, MESH_RANK_CLIPS, gen, shapes=[
        (MESH_RANK_CLIPS, T) + s[:3] for s in SITES])[0]
    checks += check_shift(torch, shk, MESH_RANK_CLIPS, gen, shapes=[
        (MESH_RANK_CLIPS, T, s, c) for s, c, _ in _shift_shapes()])
    frames = batches[0][0]
    kw = dict(device="cuda", timeout=MESH_GROUP_S, deadline=MESH_JOIN_S)
    step_want = {"grad": MESH_F32_STEP,
                 "bf16": {**SHIFT_STEP, **MEGA_FORWARD},
                 "score": MEGA_FORWARD, "middle2": MIDDLE2_FORWARD}
    out, paths = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        files, serve_refs = _mesh_serve_files(torch, seed, frames, tmp)
        files["ckpt"] = os.path.join(tmp, "mesh_1x2_ckpt.pth")
        one = {}
        for cell, classes in (("dp", CLASSES), ("tp", MESH_TP_CLASSES)):
            batch = _mesh_batch(seed, classes)
            dev = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
            refs = {dt: _parity_grads(torch, seed, None, dt, dev, None,
                                      "tsn_mtmm_sd", "mtmm_sd",
                                      classes=classes)
                    for dt in (torch.float64, torch.float32)}
            r = _mesh_grad_step(torch, None, seed, classes, False, batch)
            one[cell] = dict(
                batch=batch, loss=r["loss"],
                ref={k: v.cpu().numpy() for k, v in
                     refs[torch.float64][1].items()},
                plain={k: v.cpu().numpy() for k, v in
                       refs[torch.float32][1].items()},
                stats={k: v.cpu().numpy()
                       for k, v in r["state"].batch_stats.items()})
            del refs, r, dev
            torch.cuda.empty_cache()
        one_bf16 = _mesh_bf16_steps(torch, None, seed, CLASSES, False,
                                    one["dp"]["batch"])
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        dp = run_ranks(mesh_rank, 2, 1, backend="gloo", **kw,
                       args=("dp", seed, CLASSES, False, one["dp"]["batch"],
                             ("grad", "bf16")))
        dp_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tp = run_ranks(mesh_rank, 2, 2, backend="gloo", **kw,
                       args=("tp", seed, MESH_TP_CLASSES, True,
                             one["tp"]["batch"],
                             ("grad", "save", "score", "middle2"), files,
                             frames))
        tp_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nccl = run_ranks(mesh_rank, 1, 1, backend="nccl", **kw,
                         args=("nccl", seed, CLASSES, False,
                               one["dp"]["batch"], ("collectives", "bf16")))
        if torch.cuda.device_count() >= 2:
            nccl += run_ranks(mesh_rank, 2, 1, backend="nccl", **kw,
                              args=("nccl2", seed, CLASSES, False,
                                    one["dp"]["batch"],
                                    ("collectives", "bf16")))
        nccl_s = time.perf_counter() - t0

        # (a) and (b): the gradient gate, the statistics, the loss
        for cell, outs in (("dp", dp), ("tp", tp)):
            _check_rank_launches(f"mesh_{cell}", outs, step_want)
            grads = dict(outs[0]["grad"]["grads"])
            for k in outs[0].get("head_shards", {}):
                grads[k] = np.concatenate([o["grad"]["grads"][k]
                                           for o in outs[:2]])
            gate = _mesh_grad_gate(f"mesh_{cell}", grads, one[cell]["ref"],
                                   one[cell]["plain"])
            stat_rel = {k: _np_rel(v, one[cell]["stats"][k])
                        for k, v in outs[0]["grad"]["stats"].items()}
            worst = max(stat_rel, key=stat_rel.get)
            loss_rel = abs(outs[0]["grad"]["loss"] - one[cell]["loss"]) / \
                abs(one[cell]["loss"])
            out[cell] = dict(
                ranks=len(outs), grad_gate=gate,
                loss=outs[0]["grad"]["loss"], one_process_loss=one[cell][
                    "loss"], loss_rel=loss_rel, loss_tol=LOSS_TOL,
                bn_stats=dict(n=len(stat_rel), worst=stat_rel[worst],
                              worst_key=worst, tol=MESH_STAT_TOL),
                launches={o["rank"]: o["launches"] for o in outs})
            if not loss_rel <= LOSS_TOL:
                raise AssertionError(f"mesh_{cell}: loss {out[cell]}")
            if not stat_rel[worst] <= MESH_STAT_TOL:
                raise AssertionError(f"mesh_{cell}: BN statistics "
                                     f"{worst} rel {stat_rel[worst]:.3e}")
        out["dp"]["bf16"] = {"ranks": [o["bf16"] for o in dp],
                             "one_process": one_bf16}

        # (b): the checkpoint in one process, the scorer, the deploy
        _, _, state, _ = _mesh_step(torch, None, seed, MESH_TP_CLASSES,
                                    False, torch.float32)
        load_train_state(files["ckpt"], state)
        shards = tp[0]["head_shards"]
        bad = []
        for name, t in _state_trees(state).items():
            for k, v in t.items():
                if k in shards:
                    want = np.concatenate([o["live"][name][k]
                                           for o in tp[:2]])
                    same = np.array_equal(v.detach().cpu().numpy(), want)
                else:
                    same = _sha1(v) == tp[0]["live"][name][k]
                if not same:
                    bad.append(f"{name} {k}")
        out["tp"]["restore"] = dict(
            tensors=sum(len(t) for t in _state_trees(state).values()),
            head_shards=sorted(shards), not_bitwise=bad,
            step=state.step)
        del state
        torch.cuda.empty_cache()
        if bad or not shards:
            raise AssertionError(f"mesh_tp restore: {bad[:10]} not "
                                 f"bitwise, head shards {shards}")
        for job in ("score", "middle2"):
            ref = serve_refs[job]
            live_rel = _np_rel(ref["live"], ref["plain_fp32"])
            tol = BF16_SLACK * live_rel + LOGIT_TOL
            rels = [_np_rel(o[job]["probs"], ref["plain_fp32"]) for o in tp]
            out["tp"][job] = dict(
                mesh_vs_fp32_rel=rels, live_vs_fp32_rel=live_rel, tol=tol,
                mesh_vs_live_rel=[_np_rel(o[job]["probs"], ref["live"])
                                  for o in tp],
                shape=list(tp[0][job]["probs"].shape))
            if tp[0][job]["probs"].shape != (VIDEOS, MESH_TP_CLASSES) or \
                    not all(r <= tol for r in rels):
                raise AssertionError(f"mesh_tp {job}: {out['tp'][job]}")

        # (c): NCCL
        _check_rank_launches("mesh_nccl", nccl, step_want)
        out["nccl"] = dict(ranks=len(nccl), cards=torch.cuda.device_count(),
                           collectives=[o["collectives"] for o in nccl],
                           bf16=[o["bf16"] for o in nccl])
        if not all(c["backend"] == "nccl" and c["all_reduce"] and
                   c["broadcast"] for c in out["nccl"]["collectives"]):
            raise AssertionError(f"mesh_nccl: {out['nccl']}")

    for cell, outs in (("dp", dp), ("tp", tp), ("nccl", nccl)):
        for o in outs:
            WINDOW_LAUNCHES["main"] |= {tuple(w) for w in o["window"]}
            for job, l in o["launches"].items():
                paths[f"mesh_{cell}_rank{o['rank']}_{job}"] = dict(
                    launches=l)
    out["run_seconds"] = dict(dp=dp_s, tp=tp_s, nccl=nccl_s,
                              phase=time.perf_counter() - t_phase)
    print("mesh " + json.dumps(out), flush=True)
    return out, paths, checks


# ---------------------------------------------------------------------------
# the thirteenth slice: the serving surfaces (the on-device resize, the AOT
# artifact with the kernels as custom ops, the cascade, the stream)
# ---------------------------------------------------------------------------

def preprocess_phase(torch, seed):
    """The on-device resize: ``preprocess_eval_batch`` on the card against
    the port on the CPU, normalized f32, one request batch of frames
    (VIDEOS x CLIPS x T) at each of PREPROCESS_GEOMS, within
    PREPROCESS_TOL; its bf16 time a request batch on the card beside."""
    from ehgr_tpu_torch.ops.preprocess_device import preprocess_eval_batch

    rng = np.random.default_rng(seed + 13)
    rows = []
    for (h, w), square, scale, crop in PREPROCESS_GEOMS:
        x = rng.integers(0, 256, (VIDEOS, CLIPS, T, h, w, 3), dtype=np.uint8)
        kw = dict(scale_size=scale, crop_size=crop, square_resize=square)
        want = preprocess_eval_batch(torch.from_numpy(x),
                                     dtype=torch.float32, **kw)
        xd = torch.from_numpy(x).cuda()
        got = preprocess_eval_batch(xd, dtype=torch.float32, **kw)
        err = (got.cpu() - want).abs().max().item()
        r = dict(frames=[h, w], square_resize=square, scale=scale, crop=crop,
                 shape=list(got.shape), max_abs_err=err, tol=PREPROCESS_TOL,
                 frames_per_call=VIDEOS * CLIPS * T,
                 ms_bf16=_time_ms(torch, lambda: preprocess_eval_batch(
                     xd, dtype=torch.bfloat16, **kw)))
        rows.append(r)
        print("preprocess " + json.dumps(r), flush=True)
        if tuple(got.shape) != (VIDEOS, CLIPS, T, crop, crop, 3) or \
                tuple(want.shape) != tuple(got.shape) or \
                not err <= PREPROCESS_TOL:
            raise AssertionError(f"preprocess: {r}")
    return rows


# the process that loads the artifacts: it imports ehgr_tpu_torch.serve
# (and through it the kernels' registration) and nothing of the models;
# argv[1] is a JSON spec: artifacts [name, path, kind, inputs], the input
# files, how many of them are request batches and the passes over those
# that are timed
SERVE_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from ehgr_tpu_torch.serve import load_artifact
from ehgr_tpu_torch.serve.export import graph_ops
from ehgr_tpu_torch.ops.kernels.registry import OPS


def counts():
    st, ap, pr, ts, i8 = (OPS["ehgr::" + k] for k in (
        "action_stats", "action_apply", "action_prologue", "tsm_shift",
        "int8_conv"))
    return {"action_stats": st.launches,
            "action_stats_window": st.route_launches["window"],
            "action_apply": ap.launches,
            "action_apply_strip": ap.route_launches["strip"],
            "action_prologue": pr.launches,
            "action_prologue_window": pr.route_launches["window"],
            "tsm_shift": ts.launches, "tsm_shift_reverse": ts.reverse_launches,
            "int8_conv": i8.launches}


spec = json.loads(sys.argv[1])
data = [np.load(p) for p in spec["inputs"]]
out = {}
for name, path, kind, used in spec["artifacts"]:
    t0 = time.perf_counter()
    fn, manifest = load_artifact(path)
    load_s = time.perf_counter() - t0
    xs = [data[i] for i in used]
    if kind == "clip":
        xs = [x.reshape((-1,) + x.shape[2:]) for x in xs]
    fn(xs[0])
    torch.cuda.synchronize()
    calls, probs = [], {}
    for i, x in enumerate(xs):
        before = counts()
        y = fn(x)
        torch.cuda.synchronize()
        after = counts()
        calls.append(dict(batch=int(x.shape[0]),
                          launches={k: after[k] - before[k] for k in after}))
        probs["p%d" % i] = y.float().cpu().numpy()
    np.savez(path + ".probs.npz", **probs)
    req = xs[:spec["requests"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(spec["passes"]):
        for x in req:
            fn(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    clips = spec["passes"] * sum(
        int(np.prod(x.shape[:2 if kind == "video" else 1])) for x in req)
    out[name] = dict(load_s=load_s, manifest=manifest,
                     graph_ops=graph_ops(fn.program), calls=calls,
                     seconds=wall, clips_per_s=clips / wall)
    del fn
mods = sorted(m for m in sys.modules if m.startswith("ehgr_tpu_torch"))
out["_modules"] = dict(
    port=mods, models=[m for m in mods if m.startswith(
        ("ehgr_tpu_torch.models", "ehgr_tpu_torch.eval",
         "ehgr_tpu_torch.train"))],
    jax=sorted(m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "ehgr_tpu")))
print("SERVE_CHILD " + json.dumps(out), flush=True)
"""


def _ops_of(want):
    """The ``ehgr::`` graph nodes of a forward launching ``want``."""
    return {f"ehgr::{k}": v for k, v in want.items()
            if k in ("action_stats", "action_apply", "action_prologue",
                     "tsm_shift", "int8_conv")}


def export_serve(torch, seed, tmp, checkpoint, batches):
    """The AOT serving artifact: ``cli.export_serving --videos sym
    --action_fused mega`` on the serve model's weights (``checkpoint``,
    read back as ``test_ego`` reads them), then ``--clip_scorer``,
    ``--quantize static`` (calibrated on noise from the seed, as the CLI
    does) and a TSM model (``export_artifact`` on the TSM scorer), each
    loaded in one fresh process that imports ``ehgr_tpu_torch.serve`` and
    no model code (SERVE_CHILD): the three request batches, and for the
    'mega' video artifact and the TSM one batches of 1 and 4 videos too;
    per forward there the kernels' launches (counted in that process), the
    graph's ``ehgr::`` nodes, the probabilities against the live scorer
    (``make_score_fn``; the clip scorer's own module) within ARTIFACT_TOL,
    the artifact's bytes, export and load seconds, and clips/s over the
    request batches (DISPATCH_REPS passes) loaded against live."""
    from ehgr_tpu_torch.cli import export_serving
    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.eval import runner
    from ehgr_tpu_torch.eval.inference import make_score_fn
    from ehgr_tpu_torch.ops.preprocess_device import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
    from ehgr_tpu_torch.serve import export as serve

    frames = [b[0] for b in batches]
    inputs = frames + [frames[0][:1], np.concatenate(frames[1:])]
    files = []
    for i, x in enumerate(inputs):
        files.append(os.path.join(tmp, f"serve_input{i}.npy"))
        np.save(files[-1], x)
    requests = list(range(len(frames)))
    every = list(range(len(inputs)))
    base = ["--preset", "ego_baseline", "--checkpoint_path", checkpoint,
            "--action_fused", "mega"]
    # name, the CLI's extra flags (None: the TSM scorer), kind, inputs,
    # launches a forward
    variants = [("video_mega", [], "video", every, MEGA_FORWARD),
                ("clip_mega", ["--clip_scorer"], "clip", requests,
                 MEGA_FORWARD),
                ("video_int8_static", ["--quantize", "static"], "video",
                 requests, INT8_FORWARD),
                ("video_tsm", None, "video", every, {"tsm_shift": 16})]
    live, out = {}, {}
    for name, extra, kind, used, want in variants:
        path = os.path.join(tmp, name + ".ehgrtx")
        t0 = time.perf_counter()
        if extra is None:
            model = build_tsm_model(torch, seed, frames[0])
            program = serve.export_artifact(
                serve.make_video_scorer(model, scale_size=CROP,
                                        crop_size=CROP),
                serve.symbolic_batch((VIDEOS, CLIPS, T, CROP, CROP, 3)))
            nbytes = serve.save_artifact(path, program, {
                "arch": "tsn", "temporal": "tsm", "clip_scorer": False,
                "num_segments": T, "crop_size": CROP, "scale_size": CROP,
                "num_classes": CLASSES})
            del program
        else:
            res = export_serving.main(["--out", path, "--videos", "sym",
                                       "--clip_num", str(CLIPS), "--device",
                                       "cuda", *base, *extra])
            nbytes = res["bytes"]
            model, _ = runner._build_model(config_from_args(
                [f for f in base + extra if f != "--clip_scorer"]), "tsn",
                "cuda")
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
        if kind == "clip":
            clip_scorer = serve.make_clip_scorer(model, mean=IMAGENET_MEAN,
                                                 std=IMAGENET_STD)

            @torch.inference_mode()
            def score(x, _s=clip_scorer):
                return _s(torch.as_tensor(x.reshape((-1,) + x.shape[2:]))
                          .cuda())
        else:
            score = make_score_fn(model, device="cuda", crop_size=CROP,
                                  dtype_name="bfloat16")
        score(inputs[0])
        probs = [score(inputs[i]).float().cpu().numpy() for i in used]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_REPS):
            for i in requests:
                score(inputs[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        live[name] = dict(probs=probs, export_s=export_s, bytes=nbytes,
                          clips_per_s=DISPATCH_REPS * len(requests) *
                          VIDEOS * CLIPS / wall)
        del model, score
        if kind == "clip":
            del clip_scorer
        torch.cuda.empty_cache()

    spec = dict(inputs=files, requests=len(requests), passes=DISPATCH_REPS,
                artifacts=[[name, os.path.join(tmp, name + ".ehgrtx"), kind,
                            used] for name, _, kind, used, _ in variants])
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SERVE_CHILD,
                           json.dumps(spec)], cwd=here, capture_output=True,
                          text=True, timeout=900)
    child_s = time.perf_counter() - t0
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("SERVE_CHILD ")]
    if proc.returncode != 0 or not line:
        raise AssertionError(f"export_serve: the loading process failed "
                             f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    child = json.loads(line[-1][len("SERVE_CHILD "):])
    mods = child.pop("_modules")
    print("export_serve_child_modules " + json.dumps(mods), flush=True)
    if mods["models"] or mods["jax"] or "ehgr_tpu_torch.serve" not in \
            mods["port"]:
        raise AssertionError(f"export_serve: the loading process imported "
                             f"{mods}")
    for name, _, kind, used, want in variants:
        c, lv = child[name], live[name]
        loaded = np.load(os.path.join(tmp, name + ".ehgrtx.probs.npz"))
        errs = [float(np.abs(loaded[f"p{i}"] - p).max())
                for i, p in enumerate(lv["probs"])]
        per_call = [k["launches"] for k in c["calls"]]
        want_call = {k: want.get(k, 0) for k in per_call[0]}
        ops = _ops_of(want)
        launches = {k: sum(p[k] for p in per_call) for k in per_call[0]}
        out[name] = dict(
            kind=kind, bytes=lv["bytes"], export_s=lv["export_s"],
            load_s=c["load_s"], in_shape=c["manifest"]["in_shape"],
            device=c["manifest"]["device"], graph_ops=c["graph_ops"],
            manifest_ops=c["manifest"]["ops"],
            batches=[k["batch"] for k in c["calls"]],
            launches_per_forward=per_call[0], launches=launches,
            max_abs_prob_diff=max(errs), tol=ARTIFACT_TOL,
            loaded_clips_per_s=c["clips_per_s"],
            live_clips_per_s=lv["clips_per_s"])
        print(f"export_serve_{name} " + json.dumps(out[name]), flush=True)
        if c["graph_ops"] != ops or c["manifest"]["ops"] != ops or \
                any(p != want_call for p in per_call) or \
                len(per_call) != len(used) or not max(errs) <= ARTIFACT_TOL:
            raise AssertionError(f"export_serve {name}: graph "
                                 f"{c['graph_ops']} (want {ops}), launches "
                                 f"{per_call} (want {want_call} each), prob "
                                 f"diffs {errs}")
        for j, i in enumerate(used):
            p = loaded[f"p{j}"]
            rows = len(inputs[i]) * (CLIPS if kind == "clip" else 1)
            if p.shape != (rows, CLASSES) or \
                    not np.isfinite(p).all() or \
                    np.abs(p.sum(-1) - 1).max() > 1e-2:
                raise AssertionError(f"export_serve {name}: bad "
                                     f"probabilities at input {i}")
    out["child_s"] = child_s
    return out


def serve_dispatch(torch, model, batches):
    """The cost of the custom ops' dispatch on the serve path: the 'mega'
    scorer over the request batches (DISPATCH_REPS passes a turn) with each
    ACTION kernel called through its op (``torch.ops.ehgr.*``, this tree)
    and through its CUDA implementation directly, as the wrappers launched
    before the kernels became ops; after a pass to warm up, in turns op,
    direct, direct, op, twice; clips/s of each turn."""
    from ehgr_tpu_torch.eval.inference import make_score_fn
    from ehgr_tpu_torch.ops.kernels import action_mega as mega

    score = make_score_fn(model, device="cuda", crop_size=CROP,
                          dtype_name="bfloat16")
    direct = {"stats_op": mega._stats_cuda, "apply_op": mega._apply_cuda}
    for frames, _ in batches:
        score(frames)
    torch.cuda.synchronize()
    turns = []
    for turn in ("op", "direct", "direct", "op") * 2:
        saved = {k: getattr(mega, k) for k in direct}
        if turn == "direct":
            for k, fn in direct.items():
                setattr(mega, k, fn)
        try:
            reset_counters()
            t0 = time.perf_counter()
            for _ in range(DISPATCH_REPS):
                for frames, _ in batches:
                    score(frames)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
        finally:
            for k, fn in saved.items():
                setattr(mega, k, fn)
        forwards = DISPATCH_REPS * len(batches)
        if launches["action_stats_window"] != 16 * forwards or \
                launches["action_apply_strip"] != 16 * forwards:
            raise AssertionError(f"serve_dispatch {turn}: {launches}")
        turns.append(dict(turn=turn, clips_per_s=forwards * VIDEOS * CLIPS /
                          wall, ms_per_forward=wall / forwards * 1e3))
    op = statistics.median(t["clips_per_s"] for t in turns
                           if t["turn"] == "op")
    di = statistics.median(t["clips_per_s"] for t in turns
                           if t["turn"] == "direct")
    out = dict(turns=turns, op_clips_per_s=op, direct_clips_per_s=di,
               op_vs_direct_pct=100.0 * (op / di - 1.0))
    print("serve_dispatch " + json.dumps(out), flush=True)
    return out


@contextlib.contextmanager
def _watched_stages(torch, cascade, calls, raw):
    """``cascade.build_cascade_score_fns`` with each stage's scorer timed
    (synchronized) and its launches counted per call into ``calls["exit"]``
    / ``calls["full"]``; the unwatched pair is kept in ``raw``."""
    build = cascade.build_cascade_score_fns

    def watch(stage, fn):
        def run(frames):
            torch.cuda.synchronize()
            before = _launches()
            t0 = time.perf_counter()
            p = fn(frames)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = _launches()
            calls[stage].append(dict(
                videos=int(frames.shape[0]),
                clips=int(frames.shape[0] * frames.shape[1]), s=dt,
                launches={k: v - before[k] for k, v in after.items()}))
            return p
        return run

    def watched(*a, **k):
        raw[:] = build(*a, **k)
        return watch("exit", raw[0]), watch("full", raw[1])

    cascade.build_cascade_score_fns = watched
    try:
        yield
    finally:
        cascade.build_cascade_score_fns = build


def cascade_phase(torch, sd, batches):
    """A main path: ``cli.test_cascade --preset ego_sd --synthetic
    --checkpoint_path <loop_sd best> --cascade_exit 1`` at full width (32
    synthetic videos x 10 clips, one video a batch) in ``--action_fused
    mega`` and ``prologue``: each stage's launches counted apart at every
    call (exit, ``tsn_middle1``: 3 + 3 / 3 a forward; full, ``tsn``: 16 +
    16 / 16), each stage's clips/s, the curve with the effective rate from
    those and the CLI's two-pass check; then on the three request batches
    as one batch of 6 videos, ``execute_cascade`` at the median exit
    confidence (3 videos escalate, padded to the bucket of 4) against the
    predictions of ``collect_scores`` + the sweep's rule."""
    from ehgr_tpu_torch.cli import test_cascade
    from ehgr_tpu_torch.eval import cascade

    best = _ckpt(sd, "sd", "best")
    frames = np.concatenate([b[0] for b in batches])
    labels = np.concatenate([b[1] for b in batches])
    out = {}
    for mode, want_exit, want_full in (("mega", EXIT1_MEGA, MEGA_FORWARD),
                                       ("prologue", EXIT1_PROLOGUE,
                                        PROLOGUE_FORWARD)):
        calls, raw, seen = {"exit": [], "full": []}, [], []
        sweep = cascade.sweep_thresholds

        def recording(scores, *a, **k):
            seen.append(scores)
            return sweep(scores, *a, **k)

        with _watched_stages(torch, cascade, calls, raw):
            cascade.sweep_thresholds = recording
            try:
                reset_counters()
                t0 = time.perf_counter()
                res = test_cascade.main(
                    ["--preset", "ego_sd", "--synthetic",
                     "--synthetic_videos", "32", "--checkpoint_path", best,
                     "--cascade_exit", "1", "--action_fused", mode,
                     "--device", "cuda"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = _launches()
            finally:
                cascade.sweep_thresholds = sweep
        for stage, want in (("exit", want_exit), ("full", want_full)):
            bad = [c["launches"] for c in calls[stage]
                   if c["launches"] != {k: want.get(k, 0)
                                        for k in c["launches"]}]
            if bad or not calls[stage]:
                raise AssertionError(f"cascade {mode} {stage}: launches "
                                     f"{bad[:2]} (want {want} a call)")
        n = res["n_videos"]
        rates = {}
        for stage in ("exit", "full"):
            cs = []                                # collect_scores' calls
            while sum(c["videos"] for c in cs) < n:
                cs.append(calls[stage][len(cs)])
            rates[stage] = sum(c["clips"] for c in cs) / sum(
                c["s"] for c in cs)
        curve = cascade.sweep_thresholds(seen[0], cascade.DEFAULT_THRESHOLDS,
                                         rates["exit"], rates["full"])
        # the two-pass path against the sweep's rule on one request batch
        scores = cascade.collect_scores(raw[0], raw[1], [(frames, labels)])
        conf = scores["p_exit"].max(-1)
        tau = float(np.median(conf))
        run = cascade.execute_cascade(raw[0], raw[1], frames, tau)
        esc = conf < tau
        want = np.where(esc, scores["p_full"].argmax(-1),
                        scores["p_exit"].argmax(-1))
        check = dict(videos=int(len(frames)), threshold=tau,
                     escalated=int(esc.sum()),
                     bucket=cascade.bucket_size(int(esc.sum()), len(frames)),
                     same_escalations=bool((run["escalated"] == esc).all()),
                     same_predictions=bool((run["pred"] == want).all()),
                     max_abs_prob_diff=float(np.abs(
                         run["probs"] - np.where(esc[:, None],
                                                 scores["p_full"],
                                                 scores["p_exit"])).max()))
        out[mode] = dict(
            mode=mode, n_videos=n, wall_s=wall, launches=launches,
            exit_launches_per_forward=calls["exit"][0]["launches"],
            full_launches_per_forward=calls["full"][0]["launches"],
            exit_forwards=len(calls["exit"]),
            full_forwards=len(calls["full"]),
            exit_clips_per_s=rates["exit"], full_clips_per_s=rates["full"],
            top1_exit_only=res["top1_exit_only"],
            top1_full_only=res["top1_full_only"], curve=curve,
            cli_curve=res["curve"], two_pass_check=res["two_pass_check"],
            request_check=check)
        print(f"cascade_{mode} " + json.dumps(out[mode]), flush=True)
        if not (check["same_escalations"] and check["same_predictions"]) \
                or check["max_abs_prob_diff"] > ARTIFACT_TOL or \
                not 0 < check["escalated"] < len(frames) or \
                [r["top1"] for r in curve] != [r["top1"] for r in
                                               res["curve"]]:
            raise AssertionError(f"cascade {mode}: {check}")
        del raw[:]
        torch.cuda.empty_cache()
    return out


def stream_phase(torch, sd):
    """A main path: ``cli.stream_demo --preset ego_sd --synthetic --frames
    256 --action_fused mega`` on the SD ``best``, with ``--cascade_exit 0``
    (``tsn``: 16 + 16 launches a window) and ``1`` (``tsn_middle1``: 3 +
    3): its fps line, each window's latency (the scorer call, uint8 clip
    in, numpy probabilities out) as p50 / p99, the first window apart, and
    the launches of every window."""
    from ehgr_tpu_torch.cli import stream_demo
    from ehgr_tpu_torch.eval import streaming

    best = _ckpt(sd, "sd", "best")
    out = {}
    for k, want in ((0, MEGA_FORWARD), (1, EXIT1_MEGA)):
        windows = []
        make = streaming.make_stream_score_fn

        def watched(*a, **kw):
            fn = make(*a, **kw)

            def timed(clip):
                before = _launches()
                t0 = time.perf_counter()
                p = fn(clip)                    # numpy: synchronous
                dt = time.perf_counter() - t0
                after = _launches()
                windows.append(dict(s=dt, launches={
                    n: v - before[n] for n, v in after.items()}))
                return p
            return timed

        streaming.make_stream_score_fn = watched
        try:
            reset_counters()
            res = stream_demo.main(
                ["--preset", "ego_sd", "--synthetic", "--checkpoint_path",
                 best, "--frames", str(STREAM_FRAMES), "--cascade_exit",
                 str(k), "--action_fused", "mega", "--device", "cuda"])
            launches = _launches()
        finally:
            streaming.make_stream_score_fn = make
        lat = [w["s"] * 1e3 for w in windows]
        want_w = {n: want.get(n, 0) for n in windows[0]["launches"]}
        out[f"exit{k}"] = r = dict(
            arch=res["arch"], frames=STREAM_FRAMES, fps=res["fps"],
            events=res["events"], windows=len(windows),
            window_ms_p50=float(np.percentile(lat, 50)),
            window_ms_p99=float(np.percentile(lat, 99)),
            window_ms_first=lat[0],
            window_ms_p99_after_first=float(np.percentile(lat[1:], 99)),
            launches_per_window=windows[0]["launches"], launches=launches)
        print(f"stream_exit{k} " + json.dumps(r), flush=True)
        if len(windows) != STREAM_FRAMES // 8 or any(
                w["launches"] != want_w for w in windows):
            raise AssertionError(f"stream exit {k}: {len(windows)} windows, "
                                 f"launches {windows[0]['launches']} (want "
                                 f"{want_w} each)")
    return out


# ---------------------------------------------------------------------------
# the eleventh slice: int8 inference (QuantConv, calibration, int8_conv)
# ---------------------------------------------------------------------------

def _bits(torch, y):
    """The raw bits of ``y`` (NHWC order), for a bitwise comparison."""
    y = y.permute(0, 2, 3, 1).contiguous()
    return y.view(torch.int16 if y.dtype == torch.bfloat16 else torch.int32)


def _int8_operands(torch, gen, n, cin, cout, k, hw, dtype, kind="normal"):
    """A site's operands: the float activation (channels_last, ``dtype``),
    its scale (on the card), int8 weight codes and per-channel scales.
    ``normal``: N(0, 1) activations, xs = 0.8 max|x| / 127 (a few codes
    saturate), codes of either sign.  ``large_sums``: activations 1 +
    0.25 N(0, 1) and weight codes in [0, 127], so the int32 sums of the
    K = 4608 sites pass 2^24 (~2e7), where their conversion to f32
    rounds."""
    x = torch.randn((n, cin, hw, hw), generator=gen, device="cuda")
    lo = -127
    if kind == "large_sums":
        x, lo = 1 + 0.25 * x, 0
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    xs = x.float().abs().amax() / 127 * 0.8
    wq = torch.randint(lo, 128, (cout, cin, k, k), generator=gen,
                       device="cuda", dtype=torch.int8).contiguous(
                           memory_format=torch.channels_last)
    ws = torch.rand(cout, generator=gen, device="cuda") * 1e-2 + 1e-4
    return x, xs, wq, ws


def _int8_check(torch, i8, name, x, xs, wq, ws, conv_stride, pad, **info):
    """One ``int8_conv`` launch against ``int8_conv_plain`` on the same
    operands: bitwise, and counted once."""
    before = i8.int8_conv.launches
    got = i8.int8_conv(x, xs, wq, ws, conv_stride, pad)
    want = i8.int8_conv_plain(x, xs, wq, ws, conv_stride, pad)
    torch.cuda.synchronize()
    err, rel = _rel_err(got, want)
    dname = str(x.dtype).replace("torch.", "")
    r = dict(kernel="int8_conv", dtype=dname, **info, max_abs_err=err,
             max_rel_err=rel, shape=list(got.shape),
             bitwise=torch.equal(_bits(torch, got), _bits(torch, want)))
    print(f"check int8_conv {name} {dname}: bitwise={r['bitwise']} "
          f"err={err:.3e}", flush=True)
    if not r["bitwise"] or i8.int8_conv.launches != before + 1:
        raise AssertionError(f"int8_conv differs from its plain version (or "
                             f"did not launch): {r}")
    return r


# the all-values check: every finite bf16 value and 256 planted ties, at a
# 1x1 site with Cin = 16 (all int32 sums below 2^24, so a code that moves
# moves the output), at 0.041 (about the smallest act_scale that int8_serve
# and int8_test calibrate), at 1 (where every k + 0.5 is a bf16 value) and
# at MIN_SCALE (where x / xs overflows to inf)
INT8_VALUE_SCALES = (0.041, 1.0, 1e-12)


def _int8_values(torch, xs):
    """``[1, 16, 64, 64]`` f32 holding every finite bf16 value once (65,280)
    and the 256 ties (k + 0.5) * xs, k in [-128, 127], rounded to f32."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32,
                        device="cuda").to(torch.int16).view(torch.bfloat16)
    finite = bits[torch.isfinite(bits)].float()
    k = torch.arange(-128, 128, device="cuda", dtype=torch.float32)
    ties = (k + 0.5) * torch.tensor(xs, dtype=torch.float32, device="cuda")
    v = torch.cat([finite, ties])
    assert v.numel() == 64 * 64 * 16
    return v.reshape(1, 64, 64, 16).permute(0, 3, 1, 2)


def check_int8_values(torch, i8, gen):
    """The quantize in the kernel against the IEEE quotient of the plain
    version on every finite bf16 value (``_int8_values``) at each of
    INT8_VALUE_SCALES, as bf16 (the planted ties rounded to bf16) and as
    f32 (the ties exact f32 products (k + 0.5) * xs, a hair off the tie, so
    the kernel's near-tie path decides them): bitwise.  The weight is a
    signed permutation of the 16 channels (one code of +-1 a row), so each
    output is +-code * (xs * ws[c]) and every code shows in the output,
    in bf16 too (neighbouring codes are over one bf16 step apart)."""
    perm = torch.randperm(16, generator=gen, device="cuda")
    sign = torch.randint(0, 2, (16,), generator=gen, device="cuda") * 2 - 1
    wq = torch.zeros(16, 16, 1, 1, dtype=torch.int8, device="cuda")
    wq[torch.arange(16, device="cuda"), perm, 0, 0] = sign.to(torch.int8)
    ws = torch.rand(16, generator=gen, device="cuda") + 0.5
    out = []
    for scale in INT8_VALUE_SCALES:
        xs = torch.tensor(scale, dtype=torch.float32, device="cuda")
        v = _int8_values(torch, scale)
        for dtype in (torch.bfloat16, torch.float32):
            x = v.to(dtype).contiguous(memory_format=torch.channels_last)
            out.append(_int8_check(
                torch, i8, f"all_bf16_values xs={scale}", x, xs, wq, ws, 1,
                0, site="all_bf16_values", scale=scale, C=16, F=16, k=1,
                stride=1, H=64, n=1))
    return out


def check_int8(torch, i8, gen):
    """``int8_conv`` (float activation in) against ``int8_conv_plain`` at
    the 15 site shapes of INT8_SITES at the served batch's clips and at
    INT8_TPOOL, bf16 and f32 activations, each with ``normal`` and
    ``large_sums`` operands (``_int8_operands``): bitwise equal (the same
    codes, the same integers, then the same f32 multiply and rounding),
    each launch counted; then ``check_int8_values``."""
    out = []
    shapes = [(site, VIDEOS * CLIPS * T) for site in INT8_SITES] + \
        [(INT8_TPOOL, VIDEOS * CLIPS * T // 2)]
    for (kind, cin, cout, k, stride, hw, _), n in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            for data in ("normal", "large_sums"):
                ops = _int8_operands(torch, gen, n, cin, cout, k, hw, dtype,
                                     data)
                out.append(_int8_check(
                    torch, i8, f"{kind:10s} n={n} {cin}->{cout} k={k} "
                    f"s={stride} {hw}^2 {data}", *ops, stride, k // 2,
                    site=kind, data=data, n=n, C=cin, F=cout, k=k,
                    stride=stride, H=hw,
                    grid=i8.int8_conv_grid(dtype, ops[0].shape[0] * (
                        (hw + 2 * (k // 2) - k) // stride + 1) ** 2, cout,
                        k * k * cin)))
                del ops
    return out + check_int8_values(torch, i8, gen)


def time_int8(torch, i8, gen):
    """Per site shape of INT8_SITES at the served batch's clips, bf16
    activations: the kernel (CUDA events back to back, and on the device
    alone with its inputs cold in L2), its plain version, the work the
    kernel took over from the earlier composition (``quantize_codes`` and
    the channels_last copy of the codes, and ``xs * ws``, on the same
    inputs), and two yardsticks that are not the same function:
    ``torch._int_mm`` (the int32 GEMM of the codes alone, no quantize, no
    scale) at the 1x1 stride-1 sites, the only ones one call covers, and
    the bf16 cuDNN conv of the same site, the float path the int8 one
    replaces.  Bound: the bf16 activation the conv needs (2 bytes an
    element) and the weight codes read once, the scales read and the bf16
    output written once at 3.35 TB/s, beside 2 M N K operations at the int8
    peak; the same convs in bf16 (2 bytes an input and a weight element,
    no scales) at the bf16 peak beside.  A 1x1 conv needs one input pixel
    an output pixel (a quarter of the input at stride 2); a 3x3 one, pad 1,
    all of it."""
    import torch.nn.functional as F

    from ehgr_tpu_torch.ops.kernels.int8_conv import quantize_codes

    n = VIDEOS * CLIPS * T
    rows_out = []
    for kind, cin, cout, k, stride, hw, count in INT8_SITES:
        x, xs, wq, ws = _int8_operands(torch, gen, n, cin, cout, k, hw,
                                       torch.bfloat16)
        ho = (hw + 2 * (k // 2) - k) // stride + 1
        m, kk = n * ho * ho, k * k * cin
        x_elems = m * cin if k == 1 else x.numel()
        nbytes = 2 * x_elems + wq.numel() + 4 * cout + 4 + 2 * m * cout
        bf16_bytes = 2 * (x_elems + wq.numel() + m * cout)
        t_bytes, t_ops = _bound_ms(nbytes, 2 * m * cout * kk, "int8")
        wb = torch.randn(wq.shape, generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

        def kernel():
            return i8.int8_conv(x, xs, wq, ws, stride, k // 2)

        def removed():
            return (quantize_codes(x, xs).contiguous(
                memory_format=torch.channels_last), xs * ws)
        r = dict(kernel="int8_conv", site=kind, C=cin, F=cout, k=k,
                 stride=stride, H=hw, sites=count, M=m, K=kk, bytes=nbytes,
                 bytes_ms=t_bytes, ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bf16_bound_ms=max(_bound_ms(bf16_bytes, 2 * m * cout * kk,
                                             "bfloat16")),
                 grid=i8.int8_conv_grid(torch.bfloat16, m, cout, kk),
                 ms=_time_ms(torch, kernel),
                 plain_ms=_time_ms(torch, lambda: i8.int8_conv_plain(
                     x, xs, wq, ws, stride, k // 2), reps=3),
                 removed_quantize_ms=_time_ms(torch, removed),
                 cudnn_bf16_ms=_time_ms(torch, lambda: F.conv2d(
                     x, wb, stride=stride, padding=k // 2)),
                 int_mm_ms=None)
        if k == 1 and stride == 1:
            a = quantize_codes(x, xs).permute(0, 2, 3, 1).reshape(-1, cin)
            b = wq.reshape(cout, cin).t()
            r["int_mm_ms"] = _time_ms(torch, lambda: torch._int_mm(a, b))
        r["roofline_share"] = r["bound_ms"] / r["ms"]
        r["device_ms"], r["device_ms_by_kernel"] = _device_times(torch,
                                                                 kernel)
        r["device_share"] = r["bound_ms"] / r["device_ms"]
        rows_out.append(r)
        lib = "-" if r["int_mm_ms"] is None else f"{r['int_mm_ms']:.4f}"
        print(f"time int8_conv {kind:10s} {cin}->{cout} k={k} s={stride} "
              f"{hw}^2 BN={r['grid']['BN']} blocks={r['grid']['blocks']} "
              f"ms={r['ms']:.4f} device_ms={r['device_ms']:.4f} "
              f"bound={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"device_share={r['device_share']:.3f} "
              f"plain={r['plain_ms']:.4f} "
              f"removed_quantize={r['removed_quantize_ms']:.4f} "
              f"int_mm={lib} cudnn_bf16={r['cudnn_bf16_ms']:.4f}",
              flush=True)
        del x, xs, wq, ws, wb
    tot = {key: sum(r[key] * r["sites"] for r in rows_out)
           for key in ("ms", "device_ms", "bound_ms", "removed_quantize_ms",
                       "cudnn_bf16_ms")}
    print("time int8_conv forward (36 sites) " + json.dumps(
        dict(tot, device_share=tot["bound_ms"] / tot["device_ms"])),
        flush=True)
    return rows_out


def _int8_model(torch, seed, checkpoint, quantize):
    """The serve model's weights (``checkpoint``) in the full-width TSN +
    ACTION ResNet-50 ('mega') with int8 block convs ``quantize``, bf16."""
    from ehgr_tpu_torch.models.tsn import variant

    model = variant("tsn", num_class=CLASSES, num_segments=T,
                    temporal="action", action_fused="mega",
                    quantize=quantize, dtype=torch.bfloat16, device="cuda",
                    generator=torch.Generator().manual_seed(seed))
    model.load_state_dict(torch.load(checkpoint, map_location="cuda",
                                     weights_only=True)["state_dict"])
    return model.eval()


@contextlib.contextmanager
def _plain_int8():
    """The int8 sites on ``int8_conv_plain`` in place of the kernel (the
    name ``ops/quantize.py`` looks up at each call)."""
    from ehgr_tpu_torch.ops import quantize
    from ehgr_tpu_torch.ops.kernels.int8_conv import int8_conv_plain

    kernel = quantize.int8_conv
    quantize.int8_conv = int8_conv_plain
    try:
        yield
    finally:
        quantize.int8_conv = kernel


def _int8_gates(torch, model, fmodel, frames):
    """Gate 1: the kernel's probabilities against the same model on
    ``int8_conv_plain`` (INT8_PLAIN_TOL).  Gate 2: the int8 logits against
    the float bf16 model's, cosine over INT8_COS (JAX's own bar,
    ``tests/test_quantize.py``); the top-1 agreement is printed."""
    from ehgr_tpu_torch.eval.inference import make_score_fn

    x = _clips(torch, frames)
    with torch.inference_mode():
        score = make_score_fn(model, device="cuda", crop_size=CROP)
        probs = score(frames)
        logits = model(x).float()
        with _plain_int8():
            plain = score(frames)
        want = fmodel(x).float()
    cos = ((logits * want).sum() / (logits.norm() * want.norm())).item()
    out = dict(plain_max_abs=(probs - plain).abs().max().item(),
               plain_tol=INT8_PLAIN_TOL, cosine=cos, cosine_bar=INT8_COS,
               top1_agreement=(logits.argmax(-1) == want.argmax(-1))
               .float().mean().item())
    if not (out["plain_max_abs"] <= INT8_PLAIN_TOL and cos > INT8_COS and
            torch.isfinite(logits).all()):
        raise AssertionError(f"int8 gates: {out}")
    return out


def int8_serve(torch, seed, checkpoint, batches, served):
    """A main path: the scorer on the serve model's weights with int8
    'static' block convs (``quantize='static'``), calibrated on the first
    request batch (normalized at f32, run at bf16, as the runner
    calibrates), over the request batches: 36 ``int8_conv`` launches and
    16 + 16 ACTION a forward; its gates (``_int8_gates``) on every batch.
    Then one batch in 'dynamic' under the same gates and launches."""
    from ehgr_tpu_torch.ops.quantize import calibrate, sites

    fmodel = _int8_model(torch, seed, checkpoint, False)
    model = _int8_model(torch, seed, checkpoint, "static")
    calibrate(model, [_clips(torch, batches[0][0])])
    scales = [m.act_scale.item() for m in sites(model)]
    if len(scales) != 36 or not all(s > 0 for s in scales):
        raise AssertionError(f"int8_serve: act_scales {scales}")
    out = serve(torch, model, batches, INT8_FORWARD, "int8_serve")
    out["float_serve_clips_per_s"] = served["clips_per_s"]
    out["act_scale_min_max"] = [min(scales), max(scales)]
    out["gates"] = [_int8_gates(torch, model, fmodel, f) for f, _ in batches]
    del model
    dyn = _int8_model(torch, seed, checkpoint, "dynamic")
    out["dynamic"] = serve(torch, dyn, batches[:1], INT8_FORWARD,
                           "int8_serve_dynamic")
    out["dynamic"]["gates"] = [_int8_gates(torch, dyn, fmodel,
                                           batches[0][0])]
    print("int8_serve_gates " + json.dumps(
        dict(static=out["gates"], dynamic=out["dynamic"]["gates"])),
        flush=True)
    return out


def int8_test(torch, seed, checkpoint, ego):
    """A main path: ``run_test`` on the config ``cli.test --preset
    ego_baseline --synthetic --action_fused mega --quantize static`` makes,
    on test_ego's videos and weights (the same config but for
    ``quantize``): 2 calibration forwards (16 + 16 ACTION launches each),
    then 36 ``int8_conv`` and 16 + 16 ACTION launches a forward; the 36
    ``act_scale``s of run_test's model all > 0; the first batch's
    probabilities, kernel against ``int8_conv_plain``, within test_ego's
    gate of this run.  Then ``cli.test --quantize dynamic`` through its
    ``main`` on the same weights: 36 + 16 + 16 launches a forward, no
    calibration."""
    import dataclasses

    from ehgr_tpu_torch.cli import test as cli_test
    from ehgr_tpu_torch.configs import config_from_args
    from ehgr_tpu_torch.eval import runner
    from ehgr_tpu_torch.ops.quantize import sites

    flags = ["--preset", "ego_baseline", "--synthetic", "--action_fused",
             "mega", "--synthetic_videos", str(RUN_VIDEOS),
             "--checkpoint_path", checkpoint]
    cfg = config_from_args(flags + ["--quantize", "static"])
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               synthetic_task="motion"),
                      run=dataclasses.replace(cfg.run, seed=seed))
    if cfg.replace(model=dataclasses.replace(cfg.model, quantize=False)) != \
            test_config("ego_baseline", checkpoint, "mega", seed):
        raise AssertionError("int8_test: not test_ego's configuration")
    tol = {d: max(g[f"{d}_tol"] for g in ego["probs"])
           for d in ("fp32", "bf16")}

    built = []

    def gate(cfg, arch, heads, frames, skipped_ok):
        model = built[0][0]
        rows = []
        for dname, key in (("bfloat16", "bf16"), ("float32", "fp32")):
            model.dtype = getattr(torch, dname)
            cd = cfg.replace(model=dataclasses.replace(cfg.model,
                                                       dtype=dname))
            score = runner.make_test_scorer(cd, model, heads, "cuda")
            got = score(frames)[0]
            with _plain_int8():
                want = score(frames)[0]
            rel = _rel_err(got, want)[1]
            rows.append(dict(head="final", dtype=dname, rel=rel,
                             tol=tol[key], ok=bool(
                                 rel <= tol[key] and
                                 torch.isfinite(got).all())))
        return rows

    inner = runner._build_model

    def capture(cfg, arch, device=None, calib_batches=None):
        out = inner(cfg, arch, device, calib_batches)
        built.append((out[0], calib_batches))
        return out
    runner._build_model = capture
    try:
        out = run_protocol(torch, "int8_test", cfg, "tsn", 1, INT8_FORWARD,
                           BF16_SLACK, gate=gate,
                           extra={k: v * CALIB_FORWARDS
                                  for k, v in MEGA_FORWARD.items()},
                           trace_match=INT8_TRACE_WORDS)
    finally:
        runner._build_model = inner
    traced, floated = (p["scorer_call_traced"] for p in (out, ego))

    def by_word(matched):
        return {w: sum(v for k, v in matched.items() if w in k)
                for w in INT8_TRACE_WORDS}
    out["trace"] = dict(busy_ms=traced["device_busy_ms"],
                        float_busy_ms=floated["device_busy_ms"],
                        ms_by_word=by_word(traced["matched_ms"]),
                        float_ms_by_word=by_word(floated["matched_ms"]))
    print("int8_trace " + json.dumps(out["trace"]), flush=True)
    if any("round_kernel" in k for k in traced["matched_ms"]):
        raise AssertionError(f"int8_test: a round pass runs in the traced "
                             f"int8 scorer call: {out['trace']}")
    model, calib = built[0]
    scales = {n: m.act_scale.item() for n, m in model.named_modules()
              if m in sites(model)}
    del built, model
    if len(scales) != 36 or not all(v > 0 for v in scales.values()):
        raise AssertionError(f"int8_test: act_scales {scales}")
    out["act_scales"] = scales
    out["calibration_forwards"] = len(calib)
    out["test_ego_clips_per_s"] = ego["clips_per_s"]
    out["test_ego_videos_per_s"] = ego["videos_per_s"]

    flags += ["--quantize", "dynamic"]
    dcfg = config_from_args(flags)
    videos = max(dcfg.data.synthetic_videos // 2, 32)
    forwards = -(-videos // max(1, 8 // dcfg.data.clip_num or 1))
    reset_counters()
    t0 = time.perf_counter()
    res = cli_test.main(flags + ["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    want = {k: INT8_FORWARD.get(k, 0) * forwards for k in launches}
    if launches != want or res["n_videos"] != videos:
        raise AssertionError(f"int8_test dynamic: launches {launches}, want "
                             f"{want}; {res}")
    out["dynamic"] = dict(launches=launches, results=res, seconds=wall,
                          clips_per_s=videos * dcfg.data.clip_num / wall)
    print("int8_test_dynamic " + json.dumps(out["dynamic"]), flush=True)
    return out


def _conv_kernels(prof, top=12):
    """The ``top`` costliest convolutions of a profile, grouped by their
    input and weight shapes: calls, device ms and the device ms of each
    kernel they ran (cuDNN's layout conversions included)."""
    def kernels(e):
        yield from e.kernels
        for c in e.cpu_children:
            yield from kernels(c)

    rows = {}
    for e in prof.events():
        if e.name != "aten::convolution":
            continue
        key = str(e.input_shapes[:2])
        row = rows.setdefault(key, dict(input=e.input_shapes[0],
                                        weight=e.input_shapes[1], calls=0,
                                        ms=0.0, kernels={}))
        row["calls"] += 1
        for k in kernels(e):
            ms = k.duration / 1e3
            row["ms"] += ms
            row["kernels"][k.name[:90]] = row["kernels"].get(
                k.name[:90], 0.0) + ms
    return sorted(rows.values(), key=lambda r: -r["ms"])[:top]


def _device_profile(torch, fn, match=(), shapes=False):
    """Wall time and device time by kernel name of one call of ``fn``
    (torch.profiler), ``fn`` run once before to warm up; with ``match``,
    also every kernel whose name holds one of those words
    (``matched_ms``); with ``shapes``, the shapes recorded and the
    convolutions' kernels by shape (``convs``; the recording adds host
    time to ``wall_ms``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = {}
    for e in prof.key_averages():      # kernels only: ops would count twice
        if str(e.device_type).endswith("CUDA"):
            dev[e.key] = getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0)) / 1e3
    busy = sum(dev.values())
    top = dict(sorted(dev.items(), key=lambda kv: -kv[1])[:20])
    out = dict(wall_ms=wall, device_busy_ms=busy,
               idle_share=1 - busy / wall, top_device_ms=top)
    if match:
        out["matched_ms"] = {k: v for k, v in dev.items()
                             if any(w in k for w in match)}
    if shapes:
        out["convs"] = _conv_kernels(prof)
    return out


def profile_train(torch, warm):
    """Device time by kernel over one train step."""
    step, state, batch, gen = warm
    out = _device_profile(torch, lambda: step(state, batch, gen))
    print("train_profile " + json.dumps(out), flush=True)
    return out


def _time_ms(torch, fn, reps=20):
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _device_times(torch, fn, reps=10):
    """Device-only time of one ``fn()`` call with its inputs cold in L2:
    CUDA events just after a write of FLUSH_BYTES and just after the call,
    the median over ``reps`` calls (the host enqueues the call while the
    write still runs, so no host time falls between the events; the gaps
    between the call's own kernels do).  Returns (ms, ms by kernel name:
    each kernel's mean duration a call in a ``torch.profiler`` trace of
    the same calls, empty where the trace holds none of them)."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()                                      # built and warm
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        flush.fill_(1.0)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        pass                   # takes the records of earlier launches, which
    with profile(activities=activities) as prof:   # a trace may deliver late
        for _ in range(reps):
            flush.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and "Fill" not in e.key:
            name = e.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            by_name[name] = by_name.get(name, 0.0) + getattr(
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0)) / reps / 1e3
    return statistics.median(times), by_name


def _bound_ms(nbytes, flops, dname):
    """(ms to move the bytes, ms to do the FLOPs) at the card's peaks."""
    return nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dname] * 1e3


def time_kernels(torch, mega, n, gen):
    """Per site shape, bf16 (the main path's dtype): kernel, plain version,
    bare GEMM; bound from the bytes each function must move and the FLOPs
    it does; each kernel also on the device alone, its inputs cold in L2
    (``_device_times``); each kernel's route (read from its launch counts)
    and its grid: the strip kernel's for ``action_apply``, the window
    kernel's (TG, blocks) for ``action_stats``."""
    rows_out = []
    for s, c, f, count in SITES:
        d = _inputs(torch, n, s, c, f, torch.bfloat16, gen)
        rows, cr, nt = n * T * s, c // 16, n * T
        xb = d["x4"].reshape(rows, c)
        for kernel in ("action_stats", "action_apply"):
            if kernel == "action_stats":
                args = (d["x4"], d["w"], d["wp3"])
                fk, fp = mega.action_stats, mega.action_stats_plain
                gemm_w = d["wp3"]
                nbytes = 2 * (rows * c + 3 * c + c * cr +
                              rows + nt * c + rows * cr)
                flops = 2 * rows * c * cr
            else:
                args = (d["x4"], d["w"], d["g1"], d["gch"], d["wn"])
                fk, fp = mega.action_apply, mega.action_apply_plain
                gemm_w = d["wn"]
                nbytes = 2 * (rows * c + 3 * c + rows + nt * c + c * f +
                              rows * f)
                flops = 2 * rows * c * f
            t_bytes, t_ops = _bound_ms(nbytes, flops, "bfloat16")
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            r = dict(kernel=kernel, S=s, C=c, F=f, sites=count, rows=rows,
                     bytes=nbytes, flops=flops, bytes_ms=t_bytes,
                     ops_ms=t_ops, bound_ms=bound, bound_by=by,
                     ms=_time_ms(torch, lambda: fk(*args)),
                     plain_ms=_time_ms(torch, lambda: fp(*args)),
                     matmul_ms=_time_ms(torch, lambda: xb @ gemm_w))
            r["roofline_share"] = bound / r["ms"]
            r["device_ms"], r["device_ms_by_kernel"] = _device_times(
                torch, lambda: fk(*args))
            r["device_share"] = bound / r["device_ms"]
            r["route"] = _launched_route(fk, lambda: fk(*args))[1]
            if kernel == "action_apply":
                g = r["grid"] = mega.strip_grid(rows, f)
                extra = (f" grid={g['strips']}x{g['column_blocks']} "
                         f"BM={g['BM']} BN={g['BN']}")
            else:
                g = r["grid"] = mega.window_grid(n, T, s, c, cr)
                extra = _window_text(g)
            rows_out.append(r)
            print(f"time {kernel:12s} S={s:4d} C={c:4d} F={f:3d} "
                  f"ms={r['ms']:.4f} device_ms={r['device_ms']:.4f} "
                  f"bound={bound:.4f} ({by}) "
                  f"share={r['roofline_share']:.3f} "
                  f"device_share={r['device_share']:.3f} "
                  f"plain={r['plain_ms']:.4f} matmul={r['matmul_ms']:.4f} "
                  f"route={r['route']}{extra}", flush=True)
        del d, xb
    return rows_out


def _window_text(g):
    return (f" TG={g['TG']} N={g['N']} blocks={g['blocks']} "
            f"({g['strips']} strips x {g['frame_groups']} frame groups a "
            f"clip) threads={g['threads']} stages={g['stages']}")


def _conv3d_shift(torch, x4, w):
    """The yardstick of the shift: one grouped ``conv3d`` with kernel
    (3, 1, 1) and ``groups=C`` on the channels_last_3d view of ``x4``
    (``[N,C,T,S,1]``), the same function; the port never calls it."""
    import torch.nn.functional as F

    n, t, s, c = x4.shape
    x5 = x4.reshape(n, t, s, 1, c).permute(0, 4, 1, 2, 3)
    wc = w.t().reshape(c, 1, 3, 1, 1).contiguous()
    return x5, wc, lambda: F.conv3d(x5, wc, padding=(1, 0, 0), groups=c)


def time_shift(torch, shk, gen):
    """Per distinct (S, C) of the sites at TRAIN_CLIPS clips, bf16: each
    shift kernel, its plain version and the library yardstick (grouped
    conv3d; its ``convolution_backward`` for dx and dw).  Bound: the bytes
    each function must move once (fwd reads x and writes y, bwd reads x and
    g and writes dx, plus w and dw) at 3.35 TB/s, beside its f32 FMAs on
    the CUDA cores (5 flops/element fwd, 11 bwd) at 67 TFLOP/s.  Each
    kernel also on the device alone, its inputs cold in L2
    (``_device_times``; the share of the bound is read from that time), the
    backward's route and strip geometry, and beside it the backward's
    earlier design (route ``'sweep'``, ``csrc/shift.cu``) on the same
    inputs, timed both ways."""
    rows_out = []
    for s, c, count in _shift_shapes():
        x, w, g = _shift_inputs(torch, TRAIN_CLIPS, s, c, torch.bfloat16, gen)
        x5, wc, conv = _conv3d_shift(torch, x, w)
        g5 = g.reshape(TRAIN_CLIPS, T, s, 1, c).permute(0, 4, 1, 2, 3)
        if _rel_err(conv().permute(0, 2, 3, 4, 1).reshape(x.shape),
                    shk.learnable_shift_fwd(x, w))[1] > SHIFT_TOL["bfloat16"]:
            raise AssertionError("the conv3d yardstick computes another "
                                 "function")

        def conv_bwd():
            return torch.ops.aten.convolution_backward(
                g5, x5, wc, None, [1, 1, 1], [1, 0, 0], [1, 1, 1], False,
                [0, 0, 0], c, [True, True, False])

        elems = TRAIN_CLIPS * T * s * c
        for kernel in ("learnable_shift_fwd", "learnable_shift_bwd"):
            if kernel == "learnable_shift_fwd":
                fk = lambda: shk.learnable_shift_fwd(x, w)
                fp = lambda: shk.learnable_shift_fwd_plain(x, w)
                fl, nbytes, flops = conv, 2 * (2 * elems + 3 * c), 5 * elems
            else:
                fk = lambda: shk.learnable_shift_bwd(x, g, w)
                fp = lambda: shk.learnable_shift_bwd_plain(x, g, w)
                fl = conv_bwd
                nbytes, flops = 2 * (3 * elems + 6 * c), 11 * elems
            t_bytes, t_ops = _bound_ms(nbytes, flops, "float32")
            bound = max(t_bytes, t_ops)
            r = dict(kernel=kernel, S=s, C=c, sites=count,
                     rows=TRAIN_CLIPS * T * s, bytes=nbytes, flops=flops,
                     bytes_ms=t_bytes, ops_ms=t_ops, bound_ms=bound,
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     ms=_time_ms(torch, fk), plain_ms=_time_ms(torch, fp),
                     library_ms=_time_ms(torch, fl))
            r["device_ms"], r["device_ms_by_kernel"] = _device_times(
                torch, fk)
            r["roofline_share"] = bound / r["ms"]
            r["device_share"] = bound / r["device_ms"]
            extra = ""
            if kernel == "learnable_shift_bwd":
                # the earlier design on the same inputs: route 'sweep'
                sweep = lambda: shk.bwd_sweep(x, g, w)
                if _rel_err(sweep()[0], fk()[0])[1] > SHIFT_TOL["bfloat16"]:
                    raise AssertionError("the sweep route computes another "
                                         "dx than the strip route")
                r["sweep_ms"] = _time_ms(torch, sweep)
                r["sweep_device_ms"], r["sweep_device_ms_by_kernel"] = \
                    _device_times(torch, sweep)
                extra = (f" sweep: ms={r['sweep_ms']:.4f} device_ms="
                         f"{r['sweep_device_ms']:.4f}")
                r["route"] = _launched_route(shk.learnable_shift_bwd, fk)[1]
                extra = f" route={r['route']}" + extra
                if r["route"] == "strip":
                    g_ = r["grid"] = shk.strip_geometry(TRAIN_CLIPS, s, c)
                    extra += (f" R={g_['rows']} strips={g_['strips']} "
                              f"blocks={g_['blocks']} finish_blocks="
                              f"{g_['finish_blocks']}")
            rows_out.append(r)
            print(f"time {kernel:19s} S={s:4d} C={c:4d} ms={r['ms']:.4f} "
                  f"device_ms={r['device_ms']:.4f} bound={bound:.4f} "
                  f"({r['bound_by']}) share={r['device_share']:.3f} "
                  f"plain={r['plain_ms']:.4f} "
                  f"library={r['library_ms']:.4f}{extra} device_ms_by_kernel="
                  f"{r['device_ms_by_kernel']}", flush=True)
        del x, w, g, x5, g5, wc
    return rows_out


def time_tsm(torch, tk, gen):
    """Per distinct (S, C) of the sites at TRAIN_CLIPS clips, bf16: the TSM
    shift forward and reverse, the plain shift and the library yardstick:
    the grouped ``conv3d`` of ``_conv3d_shift`` with the TSM pattern's
    one-hot taps (flipped in time for the reverse), which computes the same
    function.  Bound: the bytes the copy must move once at 3.35 TB/s (write
    y; read x except the 2*fold edge channels at the clip's first and last
    frame, which are zeros); it does no arithmetic.  Each direction also on
    the device alone, its input cold in L2 (``_device_times``)."""
    from ehgr_tpu_torch.ops.temporal_shift import tsm_shift_init

    rows_out = []
    for s, c, count in _shift_shapes():
        x = torch.randn(TRAIN_CLIPS, T, s, c, generator=gen,
                        device="cuda").to(torch.bfloat16)
        taps = tsm_shift_init(c, FOLD_DIV, torch.bfloat16, "cuda")
        lib = {}
        for reverse, w in ((False, taps), (True, taps.flip(0))):
            _, _, conv = _conv3d_shift(torch, x, w)
            got = conv().permute(0, 2, 3, 4, 1).reshape(x.shape)
            want = tk.tsm_shift_plain(x, FOLD_DIV, reverse)
            lib[reverse] = dict(bitwise=torch.equal(got, want),
                                ms=_time_ms(torch, conv))
            if _rel_err(got, want)[1] > SHIFT_TOL["bfloat16"]:
                raise AssertionError("the conv3d yardstick computes another "
                                     "function than the TSM shift")
        fold = c // FOLD_DIV
        nbytes = 2 * (2 * x.numel() - 2 * fold * TRAIN_CLIPS * s)
        bound = _bound_ms(nbytes, 0, "bfloat16")[0]
        r = dict(kernel="tsm_shift", S=s, C=c, sites=count, bytes=nbytes,
                 bound_ms=bound, bound_by="bytes",
                 ms_forward=_time_ms(torch, lambda: tk.tsm_shift(
                     x, FOLD_DIV)),
                 ms_reverse=_time_ms(torch, lambda: tk.tsm_shift(
                     x, FOLD_DIV, reverse=True)),
                 plain_ms=_time_ms(torch, lambda: tk.tsm_shift_plain(
                     x, FOLD_DIV)),
                 library_ms_forward=lib[False]["ms"],
                 library_ms_reverse=lib[True]["ms"],
                 library_bitwise=lib[False]["bitwise"] and
                 lib[True]["bitwise"])
        for name, rev in (("forward", False), ("reverse", True)):
            r[f"device_ms_{name}"] = _device_times(
                torch, lambda: tk.tsm_shift(x, FOLD_DIV, reverse=rev))[0]
        r["roofline_share"] = bound / r["ms_forward"]
        r["device_share"] = bound / r["device_ms_forward"]
        rows_out.append(r)
        print(f"time tsm_shift S={s:4d} C={c:4d} fwd={r['ms_forward']:.4f} "
              f"rev={r['ms_reverse']:.4f} device fwd="
              f"{r['device_ms_forward']:.4f} rev={r['device_ms_reverse']:.4f}"
              f" share={r['device_share']:.3f} bound={bound:.4f} (bytes) "
              f"plain={r['plain_ms']:.4f} "
              f"library={r['library_ms_forward']:.4f}"
              f"+{r['library_ms_reverse']:.4f}", flush=True)
        del x
    return rows_out


def time_prologue(torch, fused, mega, n, gen):
    """Per distinct (S, C) of the sites at the served batch's ``n`` clips,
    bf16: the prologue kernel (its route and grid), its plain version and
    the bare ``x @ W_p3`` GEMM (no single PyTorch call computes the
    function), the kernel also on the device alone, its input cold in L2
    (``_device_times``).  Bound: x read once, x_shift, mc, pool and x3
    written once, the taps and W_p3 read once, at 3.35 TB/s, beside the
    GEMM's FLOPs at the bf16 peak."""
    rows_out = []
    for s, c, count in _shift_shapes():
        d = _inputs(torch, n, s, c, 16, torch.bfloat16, gen)
        rows, cr, nt = n * T * s, c // 16, n * T
        xb = d["x4"].reshape(rows, c)
        nbytes = 2 * (2 * rows * c + 3 * c + c * cr + rows + nt * c +
                      rows * cr)
        t_bytes, t_ops = _bound_ms(nbytes, 2 * rows * c * cr, "bfloat16")
        args = (d["x4"], d["w"], d["wp3"])
        r = dict(kernel="action_prologue", S=s, C=c, sites=count, rows=rows,
                 bytes=nbytes, bytes_ms=t_bytes, ops_ms=t_ops,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 ms=_time_ms(torch, lambda: fused.action_prologue(*args)),
                 plain_ms=_time_ms(torch,
                                   lambda: fused.action_prologue_plain(*args)),
                 matmul_ms=_time_ms(torch, lambda: xb @ d["wp3"]))
        r["roofline_share"] = r["bound_ms"] / r["ms"]
        r["device_ms"], r["device_ms_by_kernel"] = _device_times(
            torch, lambda: fused.action_prologue(*args))
        r["device_share"] = r["bound_ms"] / r["device_ms"]
        r["route"] = _launched_route(
            fused.action_prologue, lambda: fused.action_prologue(*args))[1]
        g = r["grid"] = mega.window_grid(n, T, s, c, cr)
        rows_out.append(r)
        print(f"time action_prologue S={s:4d} C={c:4d} ms={r['ms']:.4f} "
              f"device_ms={r['device_ms']:.4f} "
              f"bound={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"share={r['roofline_share']:.3f} "
              f"device_share={r['device_share']:.3f} "
              f"plain={r['plain_ms']:.4f} "
              f"matmul={r['matmul_ms']:.4f} route={r['route']}"
              f"{_window_text(g)}", flush=True)
        del d, xb
    return rows_out


def kernel_table(checks, timings, launches):
    """One entry per kernel.  The ACTION kernels' times are per forward of
    the served batch, the shift kernels' per train step (each site shape
    weighted by its number of sites); ``launches`` sums the counts of the
    main paths' runs (``launches_by_path``)."""
    csrc = "ehgr_tpu_torch/ops/kernels/csrc/"
    pallas = "ehgr_tpu/ops/pallas/"
    # (name, source, replaces, per, yardstick: "library_ms" where one
    # PyTorch call computes the same function, else the bare GEMM's
    # "matmul_ms")
    kernels = [
        ("learnable_shift_fwd", "shift.cu", "shift.py:158",
         "train step, 8 clips", "library_ms"),
        ("learnable_shift_bwd", "shift_bwd.cu", "shift.py:158",
         "train step, 8 clips", "library_ms"),
        ("action_stats", "action_stats.cu", "action_mega.py:126",
         "forward of the served batch, 20 clips", "matmul_ms"),
        ("action_apply", "action_apply.cu", "action_mega.py:192",
         "forward of the served batch, 20 clips", "matmul_ms"),
        ("action_prologue", "action_stats.cu", "action_fused.py:60",
         "forward of the served batch, 20 clips", "matmul_ms")]
    table = []
    for name, source, replaces, per, yard in kernels:
        t = [r for r in timings if r["kernel"] == name]
        c = [r for r in checks if r["kernel"] == name]
        tot = {k: sum(r[k] * r["sites"] for r in t)
               for k in ("ms", "plain_ms", yard, "bound_ms", "bytes_ms",
                         "ops_ms")}
        by_path = {p: v[name] for p, v in launches.items() if v.get(name)}
        entry = dict(
            name=name, route="cuda", source=csrc + source,
            replaces=pallas + replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in c
                            if r["dtype"] == "bfloat16"),
            max_abs_err_fp32=max(r["max_abs_err"] for r in c
                                 if r["dtype"] == "float32"),
            max_rel_err=max(r["max_rel_err"] for r in c),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by="bytes" if tot["bytes_ms"] >= tot["ops_ms"]
            else "operations",
            library_ms=tot.get("library_ms"))
        if yard == "matmul_ms":
            entry["matmul_ms"] = tot["matmul_ms"]
        if all("device_ms" in r for r in t):
            entry["device_ms"] = sum(r["device_ms"] * r["sites"] for r in t)
            entry["device_share"] = tot["bound_ms"] / entry["device_ms"]
        entry["per"] = per
        if name == "action_apply":
            entry["redesigned"] = ("one gated A tile per row strip, a "
                                   "cp.async ring, wgmma; the earlier "
                                   "kernel's time is in PERF.md's kernel "
                                   "table")
            entry["launches_strip_by_path"] = {
                p: v["action_apply_strip"] for p, v in launches.items()
                if v.get("action_apply_strip")}
        if name == "learnable_shift_bwd":
            for k in ("sweep_ms", "sweep_device_ms"):
                entry[k] = sum(r[k] * r["sites"] for r in t)
            entry["redesigned"] = ("a block over a strip of one clip and all "
                                   "T frames, a cp.async ring, dw summed in "
                                   "a fixed order by a second pass over at "
                                   "least one block an SM; sweep_ms and "
                                   "sweep_device_ms: the earlier design, "
                                   "route 'sweep' (csrc/shift.cu, fp32 and "
                                   "C % 64 != 0), on the same inputs")
            entry["route_launches_by_path"] = {
                p: {"strip": v["learnable_shift_bwd_strip"],
                    "sweep": v[name] - v["learnable_shift_bwd_strip"]}
                for p, v in launches.items() if v.get(name)}
        if name in ("action_stats", "action_prologue"):
            entry["redesigned"] = ("one sweep with a window over T, a "
                                   "cp.async ring, the product on the "
                                   "tensor cores, pool summed in a fixed "
                                   "order; the earlier kernel's time is in "
                                   "PERF.md's kernel table")
            entry["launches_window_by_path"] = {
                p: v[name + "_window"] for p, v in launches.items()
                if v.get(name + "_window")}
        entry["sites"] = [
            {k: r[k] for k in ("S", "C", "F", "sites", "ms", "plain_ms", yard,
                               "bound_ms", "bound_by", "roofline_share",
                               "device_ms", "device_share",
                               "device_ms_by_kernel", "sweep_ms",
                               "sweep_device_ms", "sweep_device_ms_by_kernel",
                               "route", "grid")
             if k in r} for r in t]
        table.append(entry)
    t = [r for r in timings if r["kernel"] == "tsm_shift"]
    c = [r for r in checks if r["kernel"] == "tsm_shift"]
    tot = {k: sum(r[k] * r["sites"] for r in t)
           for k in ("ms_forward", "ms_reverse", "plain_ms", "bound_ms",
                     "library_ms_forward", "library_ms_reverse",
                     "device_ms_forward", "device_ms_reverse")}
    by_path = {p: v["tsm_shift"] for p, v in launches.items()
               if v.get("tsm_shift")}
    table.append(dict(
        name="tsm_shift", route="cuda",
        source="ehgr_tpu_torch/ops/kernels/csrc/tsm_shift.cu",
        replaces="ehgr_tpu/ops/pallas/shift.py:83",
        launches=sum(by_path.values()), launches_by_path=by_path,
        reverse_launches_by_path={p: v["tsm_shift_reverse"]
                                  for p, v in launches.items()
                                  if v.get("tsm_shift_reverse")},
        max_abs_err=max(r["max_abs_err"] for r in c),
        max_rel_err=max(r["max_rel_err"] for r in c),
        ms=tot["ms_forward"] + tot["ms_reverse"],
        ms_forward=tot["ms_forward"], ms_reverse=tot["ms_reverse"],
        device_ms=tot["device_ms_forward"] + tot["device_ms_reverse"],
        device_share=2 * tot["bound_ms"] / (tot["device_ms_forward"] +
                                            tot["device_ms_reverse"]),
        plain_ms=2 * tot["plain_ms"], bound_ms=2 * tot["bound_ms"],
        bound_by="bytes",
        library_ms=tot["library_ms_forward"] + tot["library_ms_reverse"],
        library_bitwise=all(r["library_bitwise"] for r in t),
        per="train step, 8 clips: 16 forward + 16 reverse launches",
        sites=[{k: r[k] for k in ("S", "C", "sites", "ms_forward",
                                  "ms_reverse", "plain_ms", "bound_ms",
                                  "library_ms_forward", "library_ms_reverse",
                                  "device_ms_forward", "device_ms_reverse",
                                  "roofline_share", "device_share")}
               for r in t]))
    t = [r for r in timings if r["kernel"] == "int8_conv"]
    c = [r for r in checks if r["kernel"] == "int8_conv"]
    tot = {k: sum(r[k] * r["sites"] for r in t)
           for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms",
                     "bf16_bound_ms", "device_ms", "cudnn_bf16_ms",
                     "removed_quantize_ms")}
    by_path = {p: v["int8_conv"] for p, v in launches.items()
               if v.get("int8_conv")}
    table.append(dict(
        name="int8_conv", route="cuda", source=csrc + "int8_conv.cu",
        replaces="none: no pl.pallas_call; the XLA int8 conv of "
        "ehgr_tpu/ops/quantize.py:121",
        redesigned="float activation in, the quantize fused into the A-tile "
        "load, wgmma on s8 from swizzled tiles, 16-byte epilogue stores; the "
        "earlier kernel's time is in PERF.md's kernel table",
        launches=sum(by_path.values()), launches_by_path=by_path,
        max_abs_err=max(r["max_abs_err"] for r in c
                        if r["dtype"] == "bfloat16"),
        max_abs_err_fp32=max(r["max_abs_err"] for r in c
                             if r["dtype"] == "float32"),
        bitwise=all(r["bitwise"] for r in c),
        bitwise_all_bf16_values=all(r["bitwise"] for r in c
                                    if r["site"] == "all_bf16_values"),
        ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
        bound_by="bytes" if tot["bytes_ms"] >= tot["ops_ms"]
        else "operations",
        library_ms=None,
        library_note="no PyTorch call computes an int8 conv on CUDA; "
        "int_mm_ms: torch._int_mm (int32 GEMM of the codes, no quantize, no "
        "scale) at the 1x1 stride-1 sites alone; cudnn_bf16_ms: the float "
        "bf16 conv of every site; removed_quantize_ms: the passes the "
        "kernel took over (quantize_codes, the channels_last copy, "
        "xs * ws)",
        int_mm_ms=sum(r["int_mm_ms"] * r["sites"] for r in t
                      if r["int_mm_ms"] is not None),
        int_mm_sites_ms=sum(r["ms"] * r["sites"] for r in t
                            if r["int_mm_ms"] is not None),
        cudnn_bf16_ms=tot["cudnn_bf16_ms"],
        removed_quantize_ms=tot["removed_quantize_ms"],
        bf16_bound_ms=tot["bf16_bound_ms"], device_ms=tot["device_ms"],
        device_share=tot["bound_ms"] / tot["device_ms"],
        per="forward of the served batch, 20 clips (36 sites)",
        sites=[{k: r[k] for k in ("site", "C", "F", "k", "stride", "H",
                                  "sites", "ms", "device_ms",
                                  "device_ms_by_kernel", "plain_ms",
                                  "bound_ms", "bound_by", "bf16_bound_ms",
                                  "int_mm_ms", "cudnn_bf16_ms",
                                  "removed_quantize_ms", "grid",
                                  "roofline_share", "device_share")}
               for r in t]))
    return table


def parity_sweep(torch, seeds, path):
    """The fp32 train-step gates of ``train_parity`` (MTMM on batch and
    running BN statistics, SD on batch statistics) for each seed, every
    leaf's error written to ``path``; a seed that misses a gate is
    reported and the sweep goes on.  Returns 0 only if every seed
    passed."""
    readings, failed = [], []
    for seed in seeds:
        for arch, stage, settings in (
                ("tsn_mtmm", "mtmm", ("bn_batch", "bn_running")),
                ("tsn_sd", "sd", ("bn_batch",))):
            try:
                res = train_parity(torch, seed, arch, stage, settings,
                                   leaves=True)
            except AssertionError as e:
                failed.append(f"seed {seed} {stage}: {e}")
                print(f"parity_sweep MISS {failed[-1]}", flush=True)
                continue
            readings += [dict(stage=stage, setting=k, **v)
                         for k, v in res.items()]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dict(readings=readings, failed=failed), f)
    print("parity_sweep " + json.dumps(dict(seeds=seeds, failed=failed,
                                            out=path)), flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights, the videos and the inputs")
    p.add_argument("--parity-seeds", default=None, metavar="K,K,...",
                   help="run only the fp32 train-step gates against "
                   "float64 (MTMM in both BN settings, SD) for these seeds "
                   "and write every leaf's error to --out")
    p.add_argument("--out", default="parity_leaves.json",
                   help="where --parity-seeds writes its readings")
    p.add_argument("--int8-only", action="store_true",
                   help="run only the int8_conv checks and timings (the "
                   "kernel's short loop); prints no result line")
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ehgr_tpu_torch.ops.kernels import action_fused as fused
    from ehgr_tpu_torch.ops.kernels import action_mega as mega
    from ehgr_tpu_torch.ops.kernels import int8_conv as i8
    from ehgr_tpu_torch.ops.kernels import shift as shk
    from ehgr_tpu_torch.ops.kernels import tsm_shift as tk
    from ehgr_tpu_torch.ops.kernels.build import build, load

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    libs = ("action_mega", "action_stats", "action_apply", "shift",
            "shift_bwd", "tsm_shift", "int8_conv")
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source
        list(pool.map(lambda name: build(name, verbose=True), libs))
    for name in libs:                              # -Xptxas -v printed
        load(name)
    print(f"build {', '.join(libs)}: {time.perf_counter() - t0:.1f} s",
          flush=True)

    if args.parity_seeds is not None:
        return parity_sweep(torch, [int(k) for k in
                                    args.parity_seeds.split(",")], args.out)
    if args.int8_only:
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        check_int8(torch, i8, gen)
        time_int8(torch, i8, gen)
        return 0

    n = VIDEOS * CLIPS                         # clips per forward
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    record_window_launches(mega, fused)
    phases = {}

    def phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phases[name] = time.perf_counter() - t
        return out

    checks, pool_acc = phase("check_action", check_kernels, torch, mega, n,
                             gen)
    checks += phase("check_shift", check_shift, torch, shk, n, gen)
    checks += phase("check_tsm", check_tsm, torch, tk, gen)
    checks += phase("check_prologue", check_prologue, torch, fused, mega, n,
                    gen)
    checks += phase("int8_kernels", check_int8, torch, i8, gen)
    batches = make_batches(args.seed)

    # the serving path: the ACTION scorer ('mega'); its weights also serve
    # the EgoGesture test protocol below, through a file
    model, plain = build_models(torch, args.seed, batches[0][0])
    tmpdir = tempfile.TemporaryDirectory()     # removed at exit in any case
    tmp = tmpdir.name
    ego_pth = os.path.join(tmp, "ego_serve.pth")
    torch.save({"state_dict": model.state_dict()}, ego_pth)
    served = phase("serve", serve, torch, model, batches, MEGA_FORWARD)
    dispatch = phase("serve_dispatch", serve_dispatch, torch, model, batches)
    logits = compare_logits(torch, model, plain, batches[0][0])
    del plain
    prof = profile_forward(torch, model, batches[0][0])
    del model
    # int8 inference: the serve model's weights with int8 block convs
    i8_served = phase("int8_serve", int8_serve, torch, args.seed, ego_pth,
                      batches, served)

    # PR 2's path: the Stage-1 train step; its weights seed Stage 2
    trained, warm = phase("train", train, torch, args.seed)
    train_prof = profile_train(torch, warm)
    stage1 = {k: v.detach() for k, v in {**warm[1].params,
                                         **warm[1].batch_stats}.items()}
    del warm
    sites = phase("train_sites", check_sites, torch, gen)
    parity = phase("train_parity", train_parity, torch, args.seed)

    # TSM: serve and train through tsm_shift
    tsm_model = build_tsm_model(torch, args.seed, batches[0][0])
    tsm_served = phase("tsm_serve", serve, torch, tsm_model, batches,
                       {"tsm_shift": 16}, "tsm_serve")
    tsm_probs = compare_tsm(torch, tsm_model, batches[0][0])
    del tsm_model
    tsm_trained, _ = phase(
        "tsm_train", run_steps, torch, "tsm_train",
        _train_model(torch, args.seed, None, torch.bfloat16, 0.5, "tsn",
                     "tsm"), "baseline", args.seed,
        {"tsm_shift": 32, "tsm_shift_reverse": 16})
    tsm_sites = phase("tsm_sites", check_tsm_sites, torch, gen)

    # Stage 2: SD training from the Stage-1 weights, then its deploys
    transfer, sd_model = sd_transfer(torch, args.seed, stage1)
    del stage1
    sd_trained, _ = phase("sd_train", run_steps, torch, "sd_train",
                          sd_model, "sd", args.seed,
                          {**SHIFT_STEP, **MEGA_FORWARD})
    sd_state = {k: v.detach().clone()
                for k, v in sd_model.state_dict().items()}
    del sd_model
    sd_parity = phase("sd_parity", train_parity, torch, args.seed, "tsn_sd",
                      "sd", ("bn_batch",))
    deploy = phase("sd_deploy", sd_deploy, torch, args.seed, sd_state,
                   batches)
    del sd_state

    # the test protocol: host data layer, run_test, 10 clips a forward
    ego = phase("test_ego", test_ego, torch, args.seed, ego_pth)
    i8_test = phase("int8_test", int8_test, torch, args.seed, ego_pth, ego)
    nv_sd = phase("test_nv_sd", test_nv_sd, torch, args.seed,
                  os.path.join(tmp, "nv_sd.pth"))

    # the trainers: stage 1 -> stage 2 -> resume -> the 4-head test, each
    # through its entry point and the port's checkpoint files; then remat
    l_mtmm, mtmm_res = phase("loop_mtmm", loop_mtmm, torch, tmp)
    l_sd, sd_res = phase("loop_sd", loop_sd, torch, tmp, mtmm_res)
    l_resume = phase("loop_resume", loop_resume, torch, tmp, mtmm_res)
    l_test_sd = phase("loop_test_sd", loop_test_sd, torch, tmp, sd_res)

    # the serving surfaces: the on-device resize, the AOT artifact (kernels
    # as custom ops, loaded in a process without model code), the cascade
    # and the stream on the SD best
    prep = phase("preprocess", preprocess_phase, torch, args.seed)
    exported = phase("export_serve", export_serve, torch, args.seed, tmp,
                     ego_pth, batches)
    casc = phase("cascade", cascade_phase, torch, sd_res, batches)
    stream = phase("stream", stream_phase, torch, sd_res)
    remat = phase("remat", remat_step, torch, args.seed)

    # the joint stage and the TSN options: the joint train step, its fp32
    # gate, temporal_pool (train and serve, sites of stages 3-4 at T/2),
    # then the joint trainer from the MTMM best and the 4-head test on its
    # best, through the entry points and files
    joint = phase("joint_train", joint_train, torch, args.seed)
    joint_parity = phase("joint_parity", train_parity, torch, args.seed,
                         "tsn_mtmm_sd", "mtmm_sd")
    tp = phase("tpool", tpool, torch, args.seed, batches)
    l_joint, joint_res = phase("loop_mtmm_sd", loop_mtmm_sd, torch, tmp,
                               mtmm_res)
    l_test_joint = phase("loop_test_mtmm_sd", loop_test_mtmm_sd, torch, tmp,
                         joint_res)
    tmpdir.cleanup()

    # the other backbone families: their site shapes, then serving and
    # training each at full width
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    checks += phase("backbone_checks", backbone_checks, torch, mega, fused,
                    shk, tk, n, gen)
    bb, bb_paths = phase("backbones", backbones, torch, args.seed, batches,
                         smi)

    # the dress rehearsal at 32 clips a step, the SD test CLI on its best,
    # GradCAM, the case study and the reproduction chain
    checks += phase("slice_checks", slice_checks, torch, mega, shk, n, gen)
    slice_dir = tempfile.TemporaryDirectory()
    reh = phase("rehearsal", rehearsal, torch, slice_dir.name)
    sd_an = phase("sd_actionnet", sd_actionnet, torch, reh["best"]["SD"])
    cam = phase("gradcam", gradcam_phase, torch, args.seed, batches,
                slice_dir.name)
    case = phase("case_study", case_study_phase, torch, args.seed, batches)
    repro = phase("reproduce_smoke", reproduce_smoke, torch, slice_dir.name)
    slice_dir.cleanup()
    new_phases = ("slice_checks", "rehearsal", "sd_actionnet", "gradcam",
                  "case_study", "reproduce_smoke")
    print("slice_phase_seconds " + json.dumps(
        {**{k: phases[k] for k in new_phases},
         "total": sum(phases[k] for k in new_phases)}), flush=True)

    # the last model families: 3-D, VideoMAE, DPT and the MiDaS predictor
    families, family_paths = slice16(torch, args.seed, batches, phases)

    # the mesh: ranks on this card over gloo (data parallelism with global
    # BN statistics; tensor-parallel heads), and NCCL
    mesh, mesh_paths, mesh_checks = phase("mesh", mesh_phase, torch,
                                          args.seed, mega, shk, gen, batches)
    checks += mesh_checks
    coverage = phase("window_coverage", check_window_coverage, mega, checks)

    timings = phase("timings", lambda: time_kernels(torch, mega, n, gen) +
                    time_shift(torch, shk, gen) + time_tsm(torch, tk, gen) +
                    time_prologue(torch, fused, mega, n, gen) +
                    time_int8(torch, i8, gen))
    print("phase_seconds " + json.dumps(phases), flush=True)

    paths = {"serve": served, "train": trained, "tsm_serve": tsm_served,
             "tsm_train": tsm_trained, "sd_train": sd_trained,
             "sd_serve_prologue": deploy["serve_prologue"],
             "sd_serve_mega": deploy["serve_mega"],
             **{f"tsn_middle{k}": v
                for k, v in deploy["middles"].items()},
             "test_ego": ego, "test_nv_sd": nv_sd, "loop_mtmm": l_mtmm,
             "loop_sd": l_sd, "loop_resume": l_resume,
             "loop_test_sd": l_test_sd, "joint_train": joint,
             "tpool_train": tp["train"],
             "tpool_serve": dict(launches=tp["forward_launches"]),
             "loop_mtmm_sd": l_joint, "loop_test_mtmm_sd": l_test_joint,
             "int8_serve": i8_served,
             "int8_serve_dynamic": i8_served["dynamic"],
             "int8_test": i8_test, "int8_test_dynamic": i8_test["dynamic"],
             **{f"export_{k}": v for k, v in exported.items()
                if isinstance(v, dict)},
             **{f"cascade_{k}": v for k, v in casc.items()},
             **{f"stream_{k}": v for k, v in stream.items()},
             **bb_paths, "rehearsal": reh,
             "sd_actionnet_prologue": sd_an["prologue"],
             "sd_actionnet_vjp": sd_an["vjp"], "gradcam": cam,
             "case_study": case, "reproduce_smoke": repro,
             **family_paths, **mesh_paths}
    table = kernel_table(checks, timings,
                         {p: v["launches"] for p, v in paths.items()})
    print(json.dumps({"kernels": table, "serve": served, "logits": logits,
                      "pool_accumulation": pool_acc, "profile": prof,
                      "train": trained, "train_profile": train_prof,
                      "train_sites": sites, "train_parity": parity,
                      "tsm_serve": tsm_served, "tsm_probs": tsm_probs,
                      "tsm_train": tsm_trained, "tsm_sites": tsm_sites,
                      "sd_transfer": transfer, "sd_train": sd_trained,
                      "sd_parity": sd_parity, "sd_deploy": deploy,
                      "test_ego": ego, "test_nv_sd": nv_sd,
                      "loop_mtmm": l_mtmm, "loop_sd": l_sd,
                      "loop_resume": l_resume, "loop_test_sd": l_test_sd,
                      "remat": remat, "joint_train": joint,
                      "joint_parity": joint_parity, "tpool": tp,
                      "loop_mtmm_sd": l_joint,
                      "loop_test_mtmm_sd": l_test_joint,
                      "int8_serve": i8_served, "int8_test": i8_test,
                      "serve_dispatch": dispatch, "preprocess": prep,
                      "export_serve": exported, "cascade": casc,
                      "stream": stream, "backbones": bb,
                      "rehearsal": reh, "sd_actionnet": sd_an,
                      "gradcam": cam, "case_study": case,
                      "reproduce_smoke": repro, **families, "mesh": mesh,
                      "window_coverage": coverage,
                      "phase_seconds": phases, "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
