#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``slak_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one CUDA card
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,erf_kernels,erf
    python3 chip_smoke.py --phases build,cli
    python3 chip_smoke.py --phases build,kd_kernels,kd
    python3 chip_smoke.py --phases build,seg,det
    python3 chip_smoke.py --phases build,dual_kernels,dual,dual_timing,probes
    python3 chip_smoke.py --phases build,mlp_ab --base PARENT_CHECKOUT
    python3 chip_smoke.py --phases build,mlp_bwd_ab --base PARENT_CHECKOUT
    python3 chip_smoke.py --phases build,dwconv_ab --base PARENT_CHECKOUT
    python3 chip_smoke.py --phases build,wgrad_ab --base PARENT_CHECKOUT
    python3 chip_smoke.py --phases build,dual_kernels,dual,dwpair_ab \
        --base PARENT_CHECKOUT
    python3 chip_smoke.py --phases build,stacked_ab --base PARENT_CHECKOUT

Phases (any failure exits non-zero):
  build    nvcc-build every kernel under slak_tpu_torch/ops/csrc/.
  kernels  each kernel against its plain PyTorch version on the card at the
           flagship's shapes (SLaK-T 51x51 w1.3, the main path's batch): the
           dwconv pair at the four stages' (K,5)/(5,K) taps (also at
           batches 1, 3 and 8; the same bits twice; each launch's route,
           K6's Toeplitz kernel (stage 4's 7x7, with the band kernel's
           time at the same shapes), the band kernel, the fp32 band kernel or
           the tiled kernel, named in its row; the Toeplitz kernel also at
           the DW_EDGES_2D maps and taps and batches 1, 3, 8, 64, 65, 128,
           its geometry that of dwconv2d_geometry, the same bits twice; the
           fp32 pair also at the DW_EDGES_F32 maps, the same bits twice; the
           fp32 bound bytes against the lesser of 3xTF32 and FFMA), the
           fused MLP
           in NCHW, NHWC and (C, M) strides, bf16 and fp32, also without
           the residual and at the ragged batches 1 and 3, the same bits
           on a second launch; times with CUDA events (median), the bound,
           achieved TFLOP/s and share of the bound, the plain version's
           time and the library yardstick's.
  forward  the main path: create_model + make_eval_step on a few batches of
           synthetic labels, bf16 and fp32, with the launch counters set to 0
           just before and read just after (bf16: every stage-4 K1 launch
           on K6's Toeplitz kernel, 18 in 3 forwards, every other one on
           the band kernel; fp32: every K1 launch on the fp32 band kernel
           and every K2/K3 launch on the 3xTF32 route); logits held against
           the same weights through the plain versions. Then ConvNeXt-T
           (7x7 taps, decom=False, no BN: one K1 launch a block; bf16
           stages 1-3 on the tiled kernel and stage 4 on K6's, fp32 all
           tiled) one forward a dtype, counted and held the same way.
  timing   bf16 eval forward at batch 256 (bench.py's batch): img/s.
  train_kernels
           the train kernels against their plain versions at the train
           shapes (batch 128): the stats-fused conv (K4), the weight
           gradient (K5/K7) and K1 as the dgrad (flipped taps) at the four
           stages' (K,5)/(5,K) taps (in bf16 also at batches 1, 3 and 8;
           K4's sums must be the same bits on a second launch and the bits
           its route's mirror adds from its y in its order, band_stats_sums
           or, on stage 4's Toeplitz kernel, dwconv2d_stats_sums; stage 4's
           K4 and dgrad rows give the band kernel's time at the same
           shapes; the weight gradient the same bits on a second launch,
           the taps that only read padding exactly 0, each row naming its
           route; all three also at the DW_EDGES maps, K4 and the dgrad at
           the DW_EDGES_2D maps, the weight gradient at WGRAD_EDGES_TILED:
           planes above the shared memory, in row tiles), the fused MLP
           backward in NCHW, K8 at
           C = 124 and 249 and K9 at C = 499 and 998 (also at the ragged
           batches 1 and 3; two launches must give the same bits); bf16
           and fp32; times, bound, plain and library (or unfused) times.
  train    the train path: create_model (drop-path 0.1) +
           create_train_state (SNIP masks at 40% sparsity, random growth,
           refresh every 2 steps, EMA) + make_train_step, 4 bf16 steps at
           batch 128 with the launch counters set to 0 just before and read
           just after (every stage-4 K4 and K1 dgrad launch on K6's
           Toeplitz kernel, 24 + 24 in 4 steps; every other K4, K1 dgrad
           and bf16 weight-gradient launch on its band kernel; K8
           on stages 1-2; K2 + K9 on stages 3-4 where TRAIN_WIDE_MLP_BWD
           routes them); DST refreshes, mask counts and
           masked weights checked; one step from the same state held
           against the plain route (bf16 at 128, fp32 at 32): loss, every
           gradient, BN stats; one bf16 step with remat against one
           without, from the same state and generator (TOL_STEP, and the
           remat step's launches: K4 and K2 once more a block).
  train_timing
           the bf16 batch-128 train step, kernel route and plain route.
  cli      the train CLI (slak_tpu_torch.train.main, in process) on the
           flagship at full width and depth, bf16, batch 128, synthetic
           224^2 images through the recipe's host transforms (RandAugment
           rand-m9-mstd0.5-inc1, thread workers), mixup 0.8 / CutMix 1.0
           and erasing 0.25 on the card, SNIP masks at 40% sparsity with a
           DST refresh every 2 steps (random growth), EMA: the recipe run
           (1 epoch of 4 steps, eval, checkpoint-0), the resumed run
           (--epochs 2 on the same directory: auto-resumes, its first step's
           model, optimizer, mask and EMA tensors the checkpoint's bits,
           then epoch 1) and an Adan + remat run (2 steps, no eval); in
           each the launch counters set to 0 just before and read just
           after, equal to what its steps, eval forwards and float32 SNIP
           scoring launch (cli_counts: every kernel on its route, no plain
           version), every DST refresh moving mask entries with each live
           count in random growth's binomial bound, the losses, weights and
           EMA finite; img/s and ms a step with the loader feeding (the
           CLI's own epoch clock at its default --print_freq; the step
           hook only copies tensors on the card, and every check on them
           runs after the CLI returns; a 4-step epoch is mostly the
           loader's start, not a sustained rate), the host transform
           path, the loader's workers. Checkpoints are removed at the
           end.
  erf_kernels
           the ERF path's kernels against their plain versions in fp32 at
           the four 1024^2 stage shapes (batch 1): K9 (the wide-channel
           fused MLP backward, stage 3 T = 4096, C = 499; stage 4 T = 1024,
           C = 998; all eight outputs), K1 (forward and flipped-tap dgrad
           on the fp32 band kernel, the same bits twice; each row naming
           its route, its bound bytes against the lesser of 3xTF32 and
           FFMA with both beside it),
           K2/K3 (3xTF32, the same bits on a second launch) and K8; K8 and
           K9 in the full mode and in dy-only mode (dy alone, as the ERF
           calls them; its dy must have the full mode's bits), the fp32 MLP
           backward within 2e-5 (3xTF32); times, bound (fp32 products: the
           lesser of 3xTF32 at 495 TFLOP/s and FFMA at 67), plain and
           unfused (or library) times.
  erf      the ERF analysis through its CLI (analysis/visualize_erf.main):
           the flagship (random weights from a seed, given as --weights),
           fp32, 1024^2, 4 images, parameters frozen, launch counters set to
           0 just before and read just after (per image 36 K1 forward + 36
           dgrad, all on the fp32 band kernel, 18 K2/K3 all on the 3xTF32
           route, 6 K8, 12 K9, K8 and K9 all in dy-only mode, no
           weight-gradient, K4 or bf16 band-kernel launch);
           every image's map finite (all 4 averaged), the map nonzero and
           largest at the centre; one image on
           each route, maps within 1e-3; then one eval-mode backward (bf16,
           batch 8, 224^2, K1 forward and dgrad on stage 4 on K6's
           Toeplitz kernel, the others and the weight gradient on their
           band kernels) with
           every parameter requiring a gradient, each
           gradient held against the plain route's; ms an image on both
           routes.
  dual_kernels
           the dual eval path's kernels and the probes' kernels against
           their plain versions at the flagship's four stage shapes (bf16
           and fp32, batch 64): K10 (the one-pass pair) in its four modes
           summed and in the two dual-out modes raw (the dual stage's
           launch, dualboth raw, each row naming its route: in bf16 the
           band kernel, also at batches 1, 3 and 8 and at the
           DW_EDGES_PAIR maps, the same bits twice, the kernel's geometry
           that of pair_band_geometry), K12 (the dual tail)
           with and without the q output (also at the ragged batches 1 and
           3), K11 (the tap-stacked banded conv; bf16 on
           stacked_band_kernel: also at batches 1, 3 and 8, within one bf16
           ulp of its mirror, the same bits twice, its geometry that of
           stacked_band_geometry) and K13 (K1 with 0, 1 and all 5 tap
           columns; bf16 on the band route: all 5 the bits of K1's band
           launch, 1 within one ulp of its band mirror; the copy exact),
           each row naming its route and counter; K10's modes
           also at 256^2 in fp32 (row tiles); times, bound, plain and
           library (or unfused) times.
  dual     the dual eval path: create_model(eval_layout="dual") +
           make_eval_step on the batches of `forward`, bf16 and fp32, the
           launch counters set to 0 just before and read just after (18 K10
           + 18 K12 a forward, no K1, no K2/K3; bf16 every K10 launch on the
           band kernel, fp32 none); logits held against the plain dual
           route and against the default (split) route.
  dual_timing
           bf16 eval at batch 256: the dual route against the split route
           (tools/probe_eval_ab.py) and the dual route's plain versions.
  probes   the kernel probes as a user runs them, with the launch counters
           set to 0 just before and read just after: tools/probe_stacked
           (K11 against K1's band launch; bf16 and fp32 runs apart),
           probe_overhead and probe_floor (K13), probe_pair_ab (the
           PAIR_IMPL modes of K10 on the NCHW route); every bf16 K11 and
           K13 launch on its band kernel, by the counters.
  kd_kernels
           K8 at C = 96 and 192 and K9 at C = 384 and 768 (ConvNeXt-T's
           tails, the KD student's) at batch 128 on the 56^2 - 7^2 maps,
           bf16, NCHW, also at the ragged batches 1 and 3, against their
           plain versions (TOL_MLP_BWD), the same bits on a second launch;
           times, bound, plain and unfused times.
  kd       knowledge distillation: (b) the SLaK-T 51x51 w1.3 teacher
           (randomized, eval) and the ConvNeXt-T student (drop path 0.1,
           EMA), bf16, batch 128: 4 sparse NKD steps (SNIP masks at 40%, a
           DST refresh every 2 steps) with the launch counters set to 0
           just before and read just after, equal to kd_counts (the
           teacher's two K1 a block, stage 4's on K6's kernel, K2/K3 a
           block; the student's K2 a block, K8 at stages 1-2, K9 at 3-4; no
           teacher backward, K4 or weight-gradient launch), every teacher
           parameter without a gradient; then one step of each distill
           type (None, KD, KD hard, NKD, FD, FD+KD, FD+NKD, MGD) against the
           plain route from the same state (loss and every student and
           head gradient within TOL_STEP), the NKD step timed on both
           routes; (c) the teacher zoo at full width and 224^2, random
           weights from a seed: logits and feature shapes, fp32 on the card
           against the same module on the CPU (TOL_ZOO_FP32), bf16 against
           fp32 (TOL_LOGITS), a load_teacher_checkpoint round trip from a
           .pth with a module. prefix under "model" (the same logits), one
           FD+NKD step at batch 32 with the ConvNeXt-T student, the bf16
           forward timed at batch 128; (d) the KD CLI (kd/main.py) in
           process, NKD, one epoch of 4 steps at batch 128 through the
           recipe's host transforms, eval, checkpoint-0, counted; (e) the
           KD CLI through launch --kd --nproc 2 (gloo, one card) against
           the one-process CLI fed the ranks' batches (first loss within
           TOL_STEP), and one MGD step on 2 gloo ranks against the
           one-process step (loss and gradients within TOL_STEP, the
           heads and gradients the same on both ranks).
  seg      downstream segmentation: UperNet on the flagship backbone
           (upernet_slak_tiny_512_80k_ade20k: SLaK-T 51x51 w1.3 + UperNet
           512 channels, 150 classes), 512^2 crops, batch 8, bf16, random
           weights from a seed. (e) every kernel of the path against its
           plain version at the path's stage shapes (128^2 to 16^2: the
           K1 pair, K4, the weight gradient and the K1 dgrad, stage 1 on
           the tiled kernels and stages 2-4 on the band kernels; K2/K3; K8
           at stages 1-2, K9 at 3-4), the same bits twice, each with its
           time, bound, plain and library times; (a) one train step on
           the kernel route against the plain route from the same
           weights, batch and draws (TOL_STEP: loss, every gradient, BN
           stats); (b) its launch counts against downstream_counts; (d)
           the step's ms on both routes (CUDA events) and the peak
           memory; (c) the seg CLI (downstream/seg_main.py) in process,
           under torch.use_deterministic_algorithms: 4 uninterrupted
           steps, 3 steps with a checkpoint and the resumed step (its
           starting state the uninterrupted run's bits), --eval over 2
           batches (mIoU, mAcc, aAcc in [0, 1], the confusion matrix's
           count that of the labels' non-ignored pixels), each run's
           launch counts against downstream_counts.
  det      downstream detection: Cascade Mask R-CNN on the same backbone
           (cascade_mask_rcnn_slak_tiny_3x_coco: FPN 256, 3 stages, 80
           classes, 512 proposals), 800^2 images, batch 2, 8 GT slots,
           fp32. The same (e), (a)-(d) (K1 and its dgrad on the fp32 band
           kernel, K4 and the weight gradient on the tiled kernels, K2/K3
           on 3xTF32; (a) through the chain rule: both heads run on the
           kernel route's features, the backbones' gradients and BN stats
           within TOL_STEP, the two routes' features within
           TOL_DET_FEATURES, the loss on each route's own features with
           the kernel route's sampler draws, and where the two routes'
           proposals differ, its boxes at every stage), the NMS loop's
           time (one nms_fixed over 1024 and 512 boxes), and the CLI's
           --eval through cascade_predict and coco_ap (box and mask AP in
           [0, 1]).
  profile  (not in the default run) one eval forward and one train step
           under torch.profiler: device time by kernel, idle share, traces
           in chiprun_out/.
  mlp_ab   (not in the default run; needs --base) the fused MLP of another
           checkout (the parent commit, unpacked into a git-ignored
           directory) against this tree's in one process, in turns base,
           change, change, base: K2/K3 and K12 at the four stage shapes,
           K2 in fp32 at the 1024^2 ERF shapes, the bs256 bf16 eval, one
           fp32 ERF image at 1024^2 (each tree's K2/K3; the two maps
           within 1e-3).
  mlp_bwd_ab
           (not in the default run; needs --base) the MLP backward (K8, K9)
           of another checkout against this tree's in one process, in turns
           base, change, change, base: K8 at stages 1-2 and K9 at stages
           3-4 in bf16 at batch 128, both in fp32 at the 1024^2 ERF shapes
           in the full mode and as the ERF calls them (dy-only), one fp32
           ERF image at 1024^2 (each tree's K8/K9), the bf16 batch-128
           train step (each tree's kernels and route);
           then this tree's route alone, TRAIN_WIDE_MLP_BWD False against
           True.
  dwconv_ab
           (not in the default run; needs --base) K1/K4 of another
           checkout against this tree's in one process, in turns base,
           change, change, base: the bf16 K1 pair at each stage shape at
           batches 64 and 256, the K4 pair and the K1 dgrad pair at batch
           128 (on stage 4's 7x7 maps all three at batches 64, 128 and
           256), the fp32 K1 pair and dgrad pair at the four 1024^2 ERF
           shapes, then this tree's route A/B on the 7x7 maps (band,
           toeplitz2d, toeplitz2d, band), then the bs256 bf16 eval forward,
           the bs128 bf16 train step and one fp32 ERF image at 1024^2
           (CUDA events and the device's busy time, maps compared), each
           tree's ops/dwconv.py wrappers and kernels swapped in.
  dwpair_ab
           (not in the default run; needs --base) K10 of another checkout
           against this tree's in one process, in turns base, change,
           change, base: the bf16 dual stage's launch (dualboth, raw) at
           each stage shape at batches 64 and 256 and its sum over a dual
           forward, then the bs256 bf16 dual forward and the split forward
           (tools/probe_eval_ab.py's timing), each tree's dwpair swapped
           into models/slak.py.
  stacked_ab
           (not in the default run; needs --base) K11 and K13 of another
           checkout against this tree's in one process, in turns base,
           change, change, base: bf16 K11 and K13 at 0, 1 and 5 taps at
           each stage shape at batches 64 and 128 (and their sums), each
           tree's wrappers and kernels; then this tree's K11 against K1's
           band launch at the same shapes (band, stacked, stacked, band).
  wgrad_ab (not in the default run; needs --base) K5/K7 of another
           checkout against this tree's in one process, in turns base,
           change, change, base: the bf16 weight gradient at each stage
           shape and orientation at batch 128 (and the per-step sum), then
           the bs128 bf16 train step, each tree's dwconv_wgrad swapped into
           ops/dwconv_wgrad.py.

Prints the card's name and power limit, then a {"kernels": [...]} line, and
as its last line {"ok": true, "device": {...}}. TF32 is off for cuDNN and
for matmul throughout. Long output goes to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

MAIN_BATCH = 64
TIMING_BATCH = 256
TRAIN_BATCH = 128
TRAIN_STEPS = 4
CHECK_BATCH_FP32 = 32
N_BATCHES = 3
REPS = 10                                   # launches a timed round
MODEL_KW = dict(kernel_size=(51, 49, 47, 13, 5), width_factor=1.3)
PEAK_BYTES_PER_S = 3.35e12                  # H100 SXM HBM3
OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
# tolerances on max|kernel - plain| / max|plain|; bf16 allows the one-ulp
# rounding flips (2^-8) that a different fp32 summation order can cause
TOL_KERNEL = {"float32": 1e-5, "bfloat16": 1e-2}
TOL_MLP = {"float32": 1e-4, "bfloat16": 1e-2}
TOL_LOGITS = {"float32": 1e-3, "bfloat16": 5e-2}
# BN sums: max |kernel - plain| / max_c sum_{n,h,w} |y| (fp32 sums of the
# same stored y in another order; in bf16 also the y's own rounding flips)
TOL_SUMS = {"float32": 1e-5, "bfloat16": 1e-3}
# weight gradient: max |kernel - plain| / max |plain|, fp32 sums over
# N*H*W products in another order
TOL_WGRAD = {"float32": 1e-4, "bfloat16": 1e-4}
# the MLP backward: each output's max |kernel - plain| / max |plain|; in
# bf16 a rounding flip of g or da moves the products by an ulp of bf16; in
# fp32 the products are 3xTF32, as close as fp32 FFMA (the CUDA-core
# kernels read 2.7e-6), while one TF32 pass reads about 3e-4
TOL_MLP_BWD = {"float32": 2e-5, "bfloat16": 2e-2}
# one train step, kernel route vs plain route from the same state: loss
# (relative), each gradient (relative norm error), BN running stats
# (max |diff| / max |plain|)
TOL_STEP = {"float32": dict(loss=1e-4, grad=1e-3, bn=1e-4),
            "bfloat16": dict(loss=2e-2, grad=1e-1, bn=2e-2)}
# det's train-mode stage features (18 fp32 blocks, BN in train mode),
# kernel route vs plain route: max |diff| / max |plain|, ten times
# TOL_KERNEL's fp32 limit for one launch
TOL_DET_FEATURES = 1e-4
ERF_SIZE = 1024                             # the reference's ERF protocol
ERF_IMAGES = 4
ERF_GRAD_BATCH = 8                          # eval-mode parameter gradients
# the fp32 ERF map, kernel route vs plain route: max |diff| / max |plain|;
# the same fp32 math with sums in another order through 18 blocks' forward
# and backward (each kernel within 1e-5 - 1e-4 of its plain version)
TOL_ERF_MAP = 1e-3
MLP_BWD_NAMES = ("dy", "dW1", "dW2", "db1", "db2", "dgamma", "dln_scale",
                 "dln_bias")
PAIR_MODES = ("kernel", "input", "dualout", "dualboth")
PAIR_BIG = 256                              # K10's row-tiled maps (fp32)
BAND_ROUTE = ("bf16, (K, 5) or (5, K) taps, both map axes <= 64 (stages "
              "1-3 at 224^2; stage 4 takes TOEPLITZ_ROUTE): "
              "dwconv_band_kernel (per-channel banded products, mma.sync "
              "m16n8k16); larger maps: dwconv_tiled_kernel; fp32: F32_ROUTE")
TOEPLITZ_ROUTE = ("bf16, H * W <= 64, any odd taps (stage 4's 7x7 maps at "
                  "224^2: the eval pair, K4, the dgrad), checked first: "
                  "dwconv2d_kernel (one dense product a channel, the batch "
                  "on the 64 rows, mma.sync m16n8k16, A2 built in shared "
                  "memory)")
F32_ROUTE = ("fp32, (K, 5) or (5, K) taps, K != 5, at most 9 live "
             "diagonals (every K up to 65), any map size (the ERF's 1024^2 "
             "stages, the fp32 eval, the fp32 dgrad): dwconv_band_f32_kernel "
             "(per-channel banded products, 3xTF32 on mma.sync m16n8k8)")
PAIR_BAND_ROUTE = ("bf16, dualboth, the raw pair (the dual stage's launch), "
                   "(K, 5) / (5, K) taps with K > 5, square maps of side <= 64 "
                   "(all four stages at 224^2): dwpair_band_kernel (both "
                   "branches as per-channel banded products, mma.sync "
                   "m16n8k16, no transpose in staging or store); fp32, the "
                   "summed modes, other taps, larger or non-square maps: "
                   "dwpair_kernel")
STACKED_ROUTE = ("bf16, maps up to 64 a side (all four stages at 224^2): "
                 "stacked_band_kernel (g = min(kw, 64 // H) tap columns' "
                 "bands stacked along M, mma.sync m16n8k16 over a chunk of "
                 "images, one B fragment a k-tile for all g taps, a "
                 "warp-local shift-add); fp32: stacked_f32_kernel")
PROBE_ROUTE = ("bf16, (K, 5) taps, maps up to 64 a side: the band route, "
               "all 5 taps K1's dwconv_band_kernel launch, fewer "
               "dwconv_band_probe_kernel (the band kernel with the later "
               "taps' tiles and products left out; 0 taps the staged "
               "operand moved by movmatrix); fp32: the tiled kernel with "
               "a tap limit")
WGRAD_ROUTE = ("bf16, (K, 5) or (5, K) taps, both map axes <= 64 (all four "
               "stages at 224^2): wgrad_band_kernel (per-channel correlation "
               "matrices over the long tap axis, mma.sync m16n8k16, their "
               "diagonals folded into taps); fp32, other taps and larger "
               "maps: wgrad_tiled_kernel / wgrad_kernel")
RAGGED = (1, 3)                             # the fused MLP's ragged batches
# K1/K4's other batches: the ragged ones and the ERF's eval-mode gradient's
DW_BATCHES = RAGGED + (ERF_GRAD_BATCH,)
# bf16 K1/K4 maps off the 224^2 stage maps, (N, C, H, W, K, route): every
# band-kernel instantiation (MT = 1-4 m-tiles of the long axis, with and
# without 4-byte pairs: W even or odd), taps longer than the map,
# non-square maps, and stage 1's taps above BAND_MAX on the tiled kernel
DW_EDGES = ((3, 16, 48, 48, 47, "band"),      # MT 3, pairs
            (3, 16, 45, 45, 47, "band"),      # MT 3, odd W
            (3, 16, 27, 27, 49, "band"),      # MT 2, odd W
            (1, 16, 63, 63, 51, "band"),      # MT 4, odd W
            (3, 16, 12, 12, 51, "band"),      # taps longer than the map
            (3, 16, 14, 13, 47, "band"),      # non-square, odd W
            (2, 16, 40, 20, 49, "band"),      # MT 3 or 2 by orientation
            (2, 124, 112, 112, 51, "tiled"))  # stage 1's taps at 448^2
# the weight gradient's tiled kernel where a map's two fp32 planes exceed
# the shared memory (it stages row tiles, since detection's 200^2
# stage 1 failed with cudaErrorInvalidConfiguration before), (N, C, H, W,
# K, dtype): square and non-square, both orientations, a tile count that
# leaves a short last tile, and bf16 above BAND_MAX
WGRAD_EDGES_TILED = ((2, 16, 200, 200, 51, "float32"),
                     (1, 8, 300, 264, 13, "float32"),
                     (2, 16, 210, 160, 49, "float32"),
                     (2, 16, 224, 224, 51, "bfloat16"))
# K6's maps off stage 4's (bf16, H * W <= 64, any odd taps), all on the
# Toeplitz kernel: one pixel, a non-square map, stage 4's 7x7 and 8 x 8 (the
# most pixels, 8 n-tiles), each with taps longer than the map, square and
# short; at batches that leave the 64-row tile ragged or whole; C = 5 makes
# the last run of channels a single one and the runs' offsets in their
# 16-byte chunks vary with the image
DW_EDGES_2D_MAPS = ((1, 1), (3, 5), (7, 7), (8, 8))
DW_EDGES_2D_TAPS = ((13, 5), (5, 13), (5, 5), (13, 13), (3, 3))
DW_EDGES_2D_BATCHES = (1, 3, 8, 64, 65, 128)
DW_EDGES_2D_C = 5
# bf16 K10 maps off the stage maps (the dual stage's launch: dualboth, raw),
# (N, C, H, W, K, route): every band-kernel instantiation (MT = 1-4 m-tiles
# of the side, with and without 4-byte pairs: the side even or odd), taps
# longer than the map, and the shapes the band route leaves to
# dwpair_kernel (a non-square map, a map above BAND_MAX)
DW_EDGES_PAIR = ((3, 16, 12, 12, 51, "band"),     # MT 1, pairs, long taps
                 (3, 16, 9, 9, 13, "band"),       # MT 1, odd
                 (3, 16, 32, 32, 31, "band"),     # MT 2, pairs
                 (3, 16, 27, 27, 49, "band"),     # MT 2, odd
                 (3, 16, 48, 48, 47, "band"),     # MT 3, pairs
                 (3, 16, 45, 45, 47, "band"),     # MT 3, odd
                 (2, 16, 64, 64, 63, "band"),     # MT 4, pairs
                 (1, 16, 63, 63, 51, "band"),     # MT 4, odd
                 (3, 16, 14, 13, 47, "simt"),     # H != W
                 (2, 16, 80, 80, 51, "simt"))     # above BAND_MAX
# fp32 K1 maps off the stage maps, (N, C, H, W, K), all on the fp32 band
# kernel: whole images stacked along F (pairs, odd maps, 4 images), one
# image on a map not a multiple of 8, taps longer than the map, non-square
# maps, maps above 64 in F slices (two row tiles, batch 3, stage 1's taps
# at 448^2), a long axis above 256 (two and three blocks along L) and K =
# 65 (nine live diagonals, the most the route takes)
DW_EDGES_F32 = ((3, 16, 48, 48, 47), (3, 16, 45, 45, 47),
                (8, 16, 27, 27, 49), (1, 16, 63, 63, 51),
                (3, 16, 12, 12, 51), (3, 16, 14, 13, 47),
                (2, 16, 40, 20, 49), (1, 16, 80, 80, 51),
                (3, 16, 100, 72, 49), (2, 124, 112, 112, 51),
                (1, 8, 300, 264, 13), (1, 8, 520, 40, 65))


class PhaseError(RuntimeError):
    pass


def _check(ok: bool, msg: str):
    if not ok:
        raise PhaseError(msg)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def time_ms(fn, reps: int = REPS, warmup: int = 2, rounds: int = 5) -> float:
    """Device ms a call: CUDA events around `reps` back-to-back calls (so
    host launch overhead hides behind queued work), median of `rounds`."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def rel_err(got, want):
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return d, d / max(scale, 1e-30)


def peak_flops(dtype) -> float:
    import torch
    # H100 SXM peak: 989 TFLOP/s dense bf16, 67 fp32 (no TF32)
    return 989e12 if dtype == torch.bfloat16 else 67e12


PEAK_TF32 = 495e12                          # H100 SXM dense TF32


def bounds(byts, flops, dtype):
    """(ms to move `byts` at the HBM rate, ms for `flops` at the peak of
    `dtype`): the bound is the larger."""
    return (byts / PEAK_BYTES_PER_S * 1e3, flops / peak_flops(dtype) * 1e3)


def conv_bounds(byts, flops, dtype):
    """(bytes ms, operations ms, {the operations bounds}) of K1 launches;
    fp32 runs its products on the fp32 band kernel's tensor cores: the
    operations bound is the lesser of 3xTF32 (three passes at 495
    TFLOP/s) and FFMA (67 TFLOP/s), both given."""
    import torch
    b_ms, o_ms = bounds(byts, flops, dtype)
    if dtype != torch.float32:
        return b_ms, o_ms, {}
    tf32_ms = 3 * flops / PEAK_TF32 * 1e3
    return b_ms, min(o_ms, tf32_ms), dict(ops_ms_3xtf32=tf32_ms,
                                          ops_ms_ffma=o_ms)


def rate(flops, ms, bound_ms):
    """Achieved TFLOP/s of a launch and its share of the bound."""
    return dict(tflops=flops / ms * 1e-9, bound_share=bound_ms / ms)


def mlp_layouts(y, res):
    """(layout, y, res, channel_dim) of an NCHW pair in the three layouts
    the fused MLP serves: NCHW, NHWC and (C, M)."""
    C = y.shape[1]
    return (("NCHW", y, res, 1),
            ("NHWC", y.permute(0, 2, 3, 1).contiguous(),
             res.permute(0, 2, 3, 1).contiguous(), 3),
            ("CM", y.transpose(0, 1).reshape(C, -1).contiguous(),
             res.transpose(0, 1).reshape(C, -1).contiguous(), 0))


def check_mlp_variants(K2, y, res, pk, cd, layout, stage, dn, batch):
    """The fused MLP against its plain version without the residual, and
    at the ragged batches RAGGED (tiles that end mid-tile and, at P = 49
    and 196, cross images) with and without it. Returns {case: rel err}."""
    import torch
    errs = {}
    for nb in (None,) + RAGGED:
        if nb is None:
            yy, rr = y, res
        elif layout == "CM":                # (C, M): the first nb images
            per = y.shape[1] // batch
            yy = y[:, :nb * per].contiguous()
            rr = res[:, :nb * per].contiguous()
        else:
            yy, rr = y[:nb].contiguous(), res[:nb].contiguous()
        for add in ((False,) if nb is None else (True, False)):
            want = K2.fused_mlp_plain(yy, rr, pk, cd, add)
            got = K2.fused_mlp(yy, rr if add else None, pk, cd, add)
            torch.cuda.synchronize()
            _, r = rel_err(got, want)
            tag = ("full" if nb is None else f"batch{nb}") + (
                "" if add else "_no_residual")
            errs[tag] = r
            _check(r <= TOL_MLP[dn], f"fused_mlp stage {stage + 1} {layout} "
                   f"{dn} {tag}: rel err {r:.3g} > {TOL_MLP[dn]}")
    return errs


def dwconv_macs(N, C, H, W, kh, kw) -> int:
    """MACs a same-padded conv needs: taps that only see padding skipped."""
    def span(L, k):
        p = k // 2
        return sum(min(k, L + p - i) - max(0, p - i) for i in range(L))
    return N * C * span(H, kh) * span(W, kw)


def route_of(x, w) -> str:
    """The kernel ``ops/dwconv.py`` launches for these operands:
    "toeplitz2d", "band", "band_f32" or "tiled"."""
    from slak_tpu_torch.ops import dwconv as K1
    return K1._route_of(x, w)


def check_dwconv_pair(x, ws, dn, tag):
    """The K1 pair (the second launch adding into the first's output)
    against its plain version: (max abs err, rel err)."""
    import torch
    from slak_tpu_torch.ops import dwconv as K1

    def pair(conv=K1.dwconv):
        y = conv(x, ws[0])
        return conv(x, ws[1], out=y)
    want = pair(K1.dwconv_plain)
    got = pair()
    torch.cuda.synchronize()
    d, r = rel_err(got, want)
    _check(r <= TOL_KERNEL[dn], f"{tag} {dn}: rel err {r:.3g} > "
           f"{TOL_KERNEL[dn]}")
    return d, r


def check_dwconv_stats(x, w, dn, tag):
    """K4 against its plain version: y within TOL_KERNEL, both sums within
    TOL_SUMS of max_c sum |y|, the sums the same bits on a second launch
    and the same bits as the route's mirror adds the kernel's own y in the
    kernel's order (the band route: ``band_stats_sums``; the Toeplitz
    route: ``dwconv2d_stats_sums``). Returns (max abs err of y, sums rel
    err)."""
    import torch
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.ops import dwconv2d as K6
    y, s1, s2 = K1.dwconv_stats(x, w)
    _, t1, t2 = K1.dwconv_stats(x, w)
    yp, p1, p2 = K1.dwconv_stats_plain(x, w)
    torch.cuda.synchronize()
    d, r = rel_err(y, yp)
    _check(r <= TOL_KERNEL[dn], f"{tag} {tuple(w.shape[1:])} {dn}: y rel err "
           f"{r:.3g}")
    scale = yp.float().abs().sum((0, 2, 3)).max().item()
    s_err = max((a - b).abs().max().item() / scale
                for a, b in ((s1, p1), (s2, p2)))
    _check(s_err <= TOL_SUMS[dn], f"{tag} {dn}: sums rel err {s_err:.3g}")
    _check(torch.equal(s1, t1) and torch.equal(s2, t2),
           f"{tag} {dn}: the sums differ on a second launch")
    route = K1._stats_route_of(x, w)
    if route in ("band", "toeplitz2d"):
        m1, m2 = (K1.band_stats_sums(y, *w.shape[1:]) if route == "band"
                  else K6.dwconv2d_stats_sums(y))
        _check(torch.equal(s1, m1) and torch.equal(s2, m2),
               f"{tag} {dn}: the {route} kernel's sums are not the bits "
               f"its mirror gives")
    return d, s_err


def check_dwconv_f32_edges(phase: str, train: bool):
    """fp32 K1 at DW_EDGES_F32 against its plain version on the fp32 band
    kernel: the pair (``kernels``) or the dgrad on both orientations'
    flipped taps (``train_kernels``), and the same bits on a second
    launch; the kernel's launch geometry that of ``band_f32_geometry``.
    Prints a row a map."""
    import torch
    from slak_tpu_torch.ops import dwconv as K1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(71)
    dn = "float32"
    for N, C, H, W, K in DW_EDGES_F32:
        x = torch.randn(N, C, H, W, generator=g, device=dev)
        ws = [torch.randn(C, *t, generator=g, device=dev) * 0.05
              for t in ((K, 5), (5, K))]
        tag = f"dwconv fp32 {N}x{C}x{H}x{W} taps {K}"
        if train:
            ws = [w.flip(1, 2).contiguous() for w in ws]
        routes = [route_of(x, w) for w in ws]
        _check(routes == ["band_f32"] * 2, f"{tag}: routes {routes}")
        # the plain mirror's geometry is the kernel's
        geo = []
        for w in ws:
            got = K1.band_f32_kernel_geometry(N, C, H, W, *w.shape[1:])
            want = K1.band_f32_geometry(N, C, H, W, *w.shape[1:])
            _check(all(want[k] == v for k, v in got.items()),
                   f"{tag} {tuple(w.shape[1:])}: kernel geometry {got}, "
                   f"band_f32_geometry {want}")
            geo.append(got)
        row = dict(shape=[N, C, H, W], K=K, route="band_f32",
                   tol=TOL_KERNEL[dn], geometry=geo)
        if train:
            d_max = 0.0
            for w in ws:
                got, want = K1.dwconv(x, w), K1.dwconv_plain(x, w)
                torch.cuda.synchronize()
                d, r = rel_err(got, want)
                _check(r <= TOL_KERNEL[dn], f"{tag} dgrad "
                       f"{tuple(w.shape[1:])}: rel err {r:.3g}")
                same_bits_twice(lambda: K1.dwconv(x, w), tag + " dgrad")
                d_max = max(d_max, d)
            row["dgrad_max_abs_err"] = d_max
        else:
            row["pair_max_abs_err"] = check_dwconv_pair(x, ws, dn, tag)[0]
            same_bits_twice(lambda: K1.dwconv(x, ws[1], out=K1.dwconv(
                x, ws[0])), tag)
        row["same_bits_twice"] = True
        print(f"[{phase}] " + json.dumps(row), flush=True)
        del x
    torch.cuda.empty_cache()


def check_dwconv2d_edges(phase: str, train: bool):
    """bf16 K1/K4 on K6's Toeplitz kernel at the DW_EDGES_2D maps and taps,
    at each of DW_EDGES_2D_BATCHES, against their plain versions: the
    kernel's launch geometry that of ``dwconv2d_geometry``; ``kernels``:
    a launch and a second one adding into its output (other taps), the same
    bits twice; ``train_kernels``: K4 (y, sums, the same bits twice, the
    sums the bits ``dwconv2d_stats_sums`` adds from its y) and the dgrad on
    the flipped taps. At batch 3 also x and out as views that start off
    their 16-byte granule. Prints a row a map and taps."""
    import torch
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.ops import dwconv2d as K6
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(72)
    bf, dn, C = torch.bfloat16, "bfloat16", DW_EDGES_2D_C

    def view(t, off):
        """t's values in a contiguous view ``off`` elements into a buffer."""
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=dev)
        v = buf[off:off + t.numel()].view(t.shape)
        v.copy_(t)
        return v
    for H, W in DW_EDGES_2D_MAPS:
        for kh, kw in DW_EDGES_2D_TAPS:
            w = (torch.randn(C, kh, kw, generator=g, device=dev) * 0.1
                 ).to(bf).float()
            w2 = w.flip(1, 2).contiguous()
            tag = f"dwconv2d {H}x{W} taps {(kh, kw)}"
            for acc in (False, True):
                got = K6.kernel_geometry(64, C, H, W, kh, kw, acc)
                want = K6.dwconv2d_geometry(64, C, H, W, kh, kw, acc)
                _check(got == want, f"{tag}: kernel geometry {got}, "
                       f"dwconv2d_geometry {want}")
            row = dict(map=[H, W], taps=[kh, kw], C=C,
                       batches=list(DW_EDGES_2D_BATCHES), route="toeplitz2d",
                       tol=TOL_KERNEL[dn], geometry_checked=True)
            errs = []
            for N in DW_EDGES_2D_BATCHES:
                x = torch.randn(N, C, H, W, generator=g, device=dev).to(bf)
                _check(route_of(x, w) == "toeplitz2d",
                       f"{tag}: route {route_of(x, w)}")
                cases = [(x, None)]
                if N == 3:                  # off the 16-byte granule
                    cases.append((view(x, 3), 5))
                for xx, o_off in cases:
                    bt = f"{tag} batch {N}" + ("" if o_off is None else
                                               " off granule")
                    if not train:
                        def pair(conv=K1.dwconv, xx=xx, o_off=o_off):
                            y = conv(xx, w)
                            if o_off is not None:
                                y = view(y, o_off)
                            return conv(xx, w2, out=y)
                        want = pair(K1.dwconv_plain)
                        got = pair()
                        torch.cuda.synchronize()
                        d, r = rel_err(got, want)
                        _check(r <= TOL_KERNEL[dn], f"{bt}: pair rel err "
                               f"{r:.3g}")
                        same_bits_twice(pair, bt)
                        errs.append(d)
                        continue
                    d, e = check_dwconv_stats(xx, w, dn, bt + " stats")
                    errs.append(d)
                    row["sums_rel_err"] = max(row.get("sums_rel_err", 0.0),
                                              e)
                    got, want = K1.dwconv(xx, w2), K1.dwconv_plain(xx, w2)
                    torch.cuda.synchronize()
                    d, r = rel_err(got, want)
                    _check(r <= TOL_KERNEL[dn], f"{bt}: dgrad rel err "
                           f"{r:.3g}")
                    errs.append(d)
                del x
            row["max_abs_err"] = max(errs)
            row["same_bits_twice"] = True
            if train:
                row.update(tol_sums=TOL_SUMS[dn], sums_same_bits_twice=True,
                           sums_are_mirror_bits=True)
            print(f"[{phase}] " + json.dumps(row), flush=True)
    torch.cuda.empty_cache()


def check_dwconv_edges(phase: str, train: bool):
    """bf16 K1/K4 at DW_EDGES against their plain versions, each on the
    route it names: the K1 pair (``kernels``), or K4 on both orientations
    (y, sums, the same bits twice) and the K1 dgrad on their flipped taps
    (``train_kernels``); then fp32 K1 at DW_EDGES_F32
    (``check_dwconv_f32_edges``) and K6's maps (``check_dwconv2d_edges``).
    Prints a row a map."""
    import torch
    from slak_tpu_torch.ops import dwconv as K1
    check_dwconv2d_edges(phase, train)
    check_dwconv_f32_edges(phase, train)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(70)
    bf, dn = torch.bfloat16, "bfloat16"
    for N, C, H, W, K, route in DW_EDGES:
        x = torch.randn(N, C, H, W, generator=g, device=dev).to(bf)
        ws = [(torch.randn(C, *t, generator=g, device=dev) * 0.05
               ).to(bf).float() for t in ((K, 5), (5, K))]
        routes = [route_of(x, w) for w in ws]
        tag = f"dwconv {N}x{C}x{H}x{W} taps {K}"
        _check(routes == [route] * 2, f"{tag}: routes {routes}, want "
               f"{route}")
        row = dict(shape=[N, C, H, W], K=K, route=route, tol=TOL_KERNEL[dn])
        if route == "band":
            row.update(MT=[K1.band_geometry(N, C, H, W, *w.shape[1:])["MT"]
                           for w in ws], pairs=W % 2 == 0)
        if not train:
            row["pair_max_abs_err"] = check_dwconv_pair(x, ws, dn, tag)[0]
            print(f"[{phase}] " + json.dumps(row), flush=True)
            continue
        errs = [check_dwconv_stats(x, w, dn, tag + " stats") for w in ws]
        row.update(stats_max_abs_err=max(e[0] for e in errs),
                   sums_rel_err=max(e[1] for e in errs),
                   tol_sums=TOL_SUMS[dn], sums_same_bits_twice=True)
        d_max = 0.0
        for w in ws:
            f = w.flip(1, 2).contiguous()
            got, want = K1.dwconv(x, f), K1.dwconv_plain(x, f)
            torch.cuda.synchronize()
            d, r = rel_err(got, want)
            _check(r <= TOL_KERNEL[dn], f"{tag} dgrad {tuple(f.shape[1:])}: "
                   f"rel err {r:.3g}")
            d_max = max(d_max, d)
        row["dgrad_max_abs_err"] = d_max
        print(f"[{phase}] " + json.dumps(row), flush=True)


def wgrad_route_of(x, kh, kw) -> str:
    """The weight-gradient kernel ``ops/dwconv_wgrad.py`` launches."""
    from slak_tpu_torch.ops import dwconv_wgrad as KW
    return "band" if KW.wgrad_route(x, kh, kw) else "tiled"


def check_wgrad(x, dy, kh, kw, dn, tag):
    """The weight gradient against its plain version: within TOL_WGRAD of
    max |plain|, the same bits on a second launch, the taps that only ever
    read padding exactly 0. Returns (max abs err, rel err)."""
    import torch
    from slak_tpu_torch.ops import dwconv_wgrad as KW
    got = KW.dwconv_wgrad(x, dy, kh, kw)
    again = KW.dwconv_wgrad(x, dy, kh, kw)
    want = KW.dwconv_wgrad_plain(x, dy, kh, kw)
    torch.cuda.synchronize()
    d, r = rel_err(got, want)
    _check(r <= TOL_WGRAD[dn], f"{tag} {dn}: rel err {r:.3g} > "
           f"{TOL_WGRAD[dn]}")
    _check(torch.equal(got, again), f"{tag} {dn}: two launches differ")
    H, W = x.shape[2:]
    dead = ((torch.arange(kh, device=x.device)[:, None] - kh // 2).abs()
            >= H) | ((torch.arange(kw, device=x.device)[None, :] - kw // 2
                      ).abs() >= W)
    z = got[:, dead].abs().max().item() if bool(dead.any()) else 0.0
    _check(z == 0.0, f"{tag} {dn}: taps that only read padding got {z}")
    return d, r


def check_wgrad_edges(phase: str):
    """bf16 K5/K7 at DW_EDGES against the plain version, both
    orientations, each on the route it names (``check_wgrad``: within
    TOL_WGRAD, the same bits twice, dead taps exactly 0). Prints a row a
    map."""
    import torch
    from slak_tpu_torch.ops import dwconv_wgrad as KW
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(71)
    dn = "bfloat16"
    for N, C, H, W, K, route in DW_EDGES:
        x, dy = (torch.randn(N, C, H, W, generator=g, device=dev
                             ).to(torch.bfloat16) for _ in range(2))
        taps = ((K, 5), (5, K))
        tag = f"dwconv_wgrad {N}x{C}x{H}x{W} taps {K}"
        routes = [wgrad_route_of(x, *t) for t in taps]
        _check(routes == [route] * 2, f"{tag}: routes {routes}, want "
               f"{route}")
        errs = [check_wgrad(x, dy, *t, dn, tag) for t in taps]
        row = dict(shape=[N, C, H, W], K=K, route=route,
                   max_abs_err=max(e[0] for e in errs),
                   rel_err=max(e[1] for e in errs), tol=TOL_WGRAD[dn],
                   same_bits_twice=True, dead_taps_zero=True)
        if route == "band":
            row["MT"] = [KW.wgrad_geometry(N, C, H, W, *t)["MT"]
                         for t in taps]
        print(f"[{phase}] " + json.dumps(row), flush=True)


def check_wgrad_tiled_edges(phase: str):
    """The weight gradient at WGRAD_EDGES_TILED on the tiled kernel (row
    tiles), both orientations (``check_wgrad``: within TOL_WGRAD, the same
    bits twice, dead taps exactly 0). Prints a row a map."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(72)
    for N, C, H, W, K, dn in WGRAD_EDGES_TILED:
        dtype = getattr(torch, dn)
        x, dy = (torch.randn(N, C, H, W, generator=g, device=dev
                             ).to(dtype) for _ in range(2))
        taps = ((K, 5), (5, K))
        tag = f"dwconv_wgrad {N}x{C}x{H}x{W} taps {K}"
        routes = [wgrad_route_of(x, *t) for t in taps]
        _check(routes == ["tiled"] * 2, f"{tag}: routes {routes}")
        errs = [check_wgrad(x, dy, *t, dn, tag) for t in taps]
        print(f"[{phase}] " + json.dumps(dict(
            shape=[N, C, H, W], K=K, dtype=dn, route="tiled",
            max_abs_err=max(e[0] for e in errs),
            rel_err=max(e[1] for e in errs), tol=TOL_WGRAD[dn],
            same_bits_twice=True, dead_taps_zero=True)), flush=True)


def stage_shapes(cfg, size: int = 224):
    dims = cfg.widened_dims
    for i in range(4):
        H = (size // 4) >> i
        yield i, dims[i], H, cfg.stage_kernel(i), cfg.small_kernel, \
            cfg.depths[i]


def random_pack(C, g, dtype, gamma=(0.1, 0.5)):
    """Random tail weights at width C, packed for dtype (pre_bias random
    too)."""
    import torch
    from slak_tpu_torch.ops import mlp as K2
    dev, F4 = g.device, 4 * C

    def vec(scale, shift, n=C):
        return torch.randn(n, generator=g, device=dev) * scale + shift
    return K2.pack_mlp(vec(0.1, 1.0), vec(0.1, 0.0),
                       torch.randn(C, F4, generator=g, device=dev) * C ** -0.5,
                       vec(0.1, 0.0, F4),
                       torch.randn(F4, C, generator=g, device=dev)
                       * F4 ** -0.5,
                       vec(0.1, 0.0), vec(*gamma), vec(0.1, 0.0), dtype)


def unfused_bwd_ms(y, dout, pk, dtype, dy_only=False):
    """The autograd backward of the unfused torch composition (LN, two
    nn.Linear products, GELU, gamma) on NCHW y: the yardstick of the fused
    backward kernels (one call of it does not exist); ``dy_only``: the
    gradient of y alone, the parameters frozen."""
    import torch
    import torch.nn.functional as F
    C, F4 = pk.c, pk.f
    ln_s, ln_b, b2, gam, _ = pk.vec
    leaves = [t.to(dtype).detach().requires_grad_(not dy_only) for t in (
        ln_s, ln_b, pk.w1[:F4, :C], pk.b1[:F4], pk.w2[:C, :F4], b2, gam)]
    yl = y.detach().requires_grad_()
    z = yl.permute(0, 2, 3, 1)
    z = F.layer_norm(z, (C,), leaves[0], leaves[1], eps=1e-6)
    z = F.linear(F.gelu(F.linear(z, leaves[2], leaves[3])), leaves[4],
                 leaves[5])
    out = (leaves[6] * z).permute(0, 3, 1, 2)
    return time_ms(lambda: torch.autograd.grad(
        out, [yl] + ([] if dy_only else leaves), dout, retain_graph=True), 3,
        warmup=1)


def check_mlp_bwd(bwd, plain, y, dout, pk, tol, tag, dy_only=False):
    """Every output of a fused backward kernel against its plain version
    (``dy_only``: dy, and no parameter gradient): ({name: rel err}, max
    abs err)."""
    import torch
    got = bwd(y, dout, pk, 1, dy_only=dy_only)
    want = plain(y, dout, pk, 1, dy_only=dy_only)
    torch.cuda.synchronize()
    errs, d_max = {}, 0.0
    for nm, a, b in zip(MLP_BWD_NAMES, got, want):
        if dy_only and nm != "dy":
            _check(a is None and b is None, f"{tag}: dy-only gave {nm}")
            continue
        d, r = rel_err(a, b)
        errs[nm], d_max = r, max(d_max, d)
        _check(r <= tol, f"{tag}: {nm} rel err {r:.3g} > {tol}")
    return errs, d_max


def mlp_bwd_bounds(name, T, C, F4, dtype, dy_only):
    """(bytes ms, operations ms, {the operations bounds}) of a fused
    backward launch: each input read once, each output written once; the
    products the mode runs (six, 12 T C 4C operations; dy-only three). In
    fp32 the operations bound is the lesser of 3xTF32 on the tensor cores
    (three passes at 495 TFLOP/s) and FFMA (67 TFLOP/s)."""
    import torch
    item = torch.tensor([], dtype=dtype).element_size()
    dy_item = 4 if name == "mlp_bwd_wide" else item      # K9's dy is fp32
    outs = 4 * (F4 + 5 * C) if dy_only else 4 * (2 * C * F4 + F4 + 4 * C)
    ops = (6 if dy_only else 12) * T * C * F4
    b_ms, o_ms = bounds(2 * T * C * item + T * C * dy_item + 2 * C * F4 * item
                        + outs, ops, dtype)
    more = {}
    if dtype == torch.float32:
        tf32_ms = 3 * ops / PEAK_TF32 * 1e3
        more = dict(ops_ms_3xtf32=tf32_ms, ops_ms_ffma=o_ms)
        o_ms = min(o_ms, tf32_ms)
    return b_ms, o_ms, more


def mlp_fwd_bounds(T, C, F4, dtype):
    """(bytes ms, operations ms, {the operations bounds}) of a fused MLP
    launch (K2/K3): y, res and out once, the two weight matrices once; the
    two products' 4 T C 4C operations. In fp32 the operations bound is the
    lesser of 3xTF32 on the tensor cores (three passes at 495 TFLOP/s) and
    FFMA (67 TFLOP/s)."""
    import torch
    item = torch.tensor([], dtype=dtype).element_size()
    ops = 4 * T * C * F4
    b_ms, o_ms = bounds(3 * T * C * item + 2 * C * F4 * item, ops, dtype)
    more = {}
    if dtype == torch.float32:
        tf32_ms = 3 * ops / PEAK_TF32 * 1e3
        more = dict(ops_ms_3xtf32=tf32_ms, ops_ms_ffma=o_ms)
        o_ms = min(o_ms, tf32_ms)
    return b_ms, o_ms, more


def same_bits_twice(fn, tag):
    """Two launches of fn on the same inputs give the same bits (a tensor,
    or each of a tuple of them)."""
    import torch
    first, second = fn(), fn()
    torch.cuda.synchronize()
    pairs = zip(first, second) if isinstance(first, tuple) else \
        [(first, second)]
    _check(all(torch.equal(a, b) for a, b in pairs),
           f"{tag}: two launches differ")


def within_ulp(got, want, tag) -> float:
    """max |got - want|, which must be at most one bf16 ulp of want's scale
    (the same fp32 sums in another order, one rounding that may flip)."""
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)
    _check(d <= ulp, f"{tag}: max abs {d:.4g} > one bf16 ulp {ulp:.4g}")
    return d


def stacked_geometry(N, C, H, W, kh, kw) -> dict:
    """K11's bf16 launch geometry as its host code computes it; fails
    unless it is ``stacked_band_geometry``'s."""
    from slak_tpu_torch.ops import dwconv_stacked as K11
    got = K11.stacked_band_kernel_geometry(N, C, H, W, kh, kw)
    want = K11.stacked_band_geometry(N, C, H, W, kh, kw)
    _check(want is not None and all(want[k] == v for k, v in got.items()),
           f"dwconv_stacked {(N, C, H, W)} taps {(kh, kw)}: kernel geometry "
           f"{got}, stacked_band_geometry {want}")
    return got


def mlp_bwd_rows(tag, name, bwd, plain, y, dout, pk, dtype,
                 modes=("full",), **extra):
    """Check a fused backward kernel in each of ``modes`` ("full",
    "dy_only") against its plain version (``check_mlp_bwd``), that two
    launches give the same bits and that dy-only's dy has the full mode's
    bits, then time each mode, its plain version and the unfused autograd
    backward and print its row: {mode: (row, bytes ms, operations ms)}."""
    import torch
    dn = str(dtype).split(".")[1]
    tol = TOL_MLP_BWD[dn]
    C, F4 = pk.c, pk.f
    T = y.numel() // C
    dys, out = {}, {}
    for only in (False, True):
        mode = "dy_only" if only else "full"
        errs, d_max = check_mlp_bwd(bwd, plain, y, dout, pk, tol,
                                    f"{name} {extra} {dn} {mode}", only)
        # no atomics: two launches on the same inputs give the same bits
        first = bwd(y, dout, pk, 1, dy_only=only)
        second = bwd(y, dout, pk, 1, dy_only=only)
        torch.cuda.synchronize()
        _check(all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(first, second)),
               f"{name} {extra} {dn} {mode}: two launches differ")
        dys[mode] = first[0]
        del first, second
        if mode not in modes:
            continue
        b_ms, o_ms, more = mlp_bwd_bounds(name, T, C, F4, dtype, only)
        row = dict(kernel=name, dtype=dn, mode=mode, C=C, T=T, **extra,
                   max_abs_err=d_max, rel_err=errs, tol=tol,
                   deterministic=True,
                   ms=time_ms(lambda: bwd(y, dout, pk, 1, dy_only=only)),
                   plain_ms=time_ms(lambda: plain(y, dout, pk, 1,
                                                  dy_only=only), 3, warmup=1),
                   library_ms=None,
                   unfused_torch_ms=unfused_bwd_ms(y, dout, pk, dtype, only),
                   bound_ms=max(b_ms, o_ms), bytes_ms=b_ms, ops_ms=o_ms,
                   **more)
        print(f"[{tag}] " + json.dumps(row), flush=True)
        out[mode] = (row, b_ms, o_ms)
    _check(torch.equal(dys["full"], dys["dy_only"]),
           f"{name} {extra} {dn}: dy-only's dy differs from the full mode's")
    return out


def unfused_fwd_ms(y, res, pk, dtype, reps: int = REPS) -> float:
    """The unfused torch composition of K2/K3 on NCHW y (the pre-bias, LN,
    two nn.Linear products, GELU, gamma, the residual): the fused
    forward's yardstick (one call of it does not exist)."""
    import torch.nn.functional as F
    C, F4 = pk.c, pk.f
    ln_s, ln_b, b2, gam, pre = (v.to(dtype) for v in pk.vec)
    w1, w2 = pk.w1[:F4, :C].contiguous(), pk.w2[:C, :F4].contiguous()
    b1 = pk.b1[:F4].to(dtype)

    def run():
        z = (y + pre[:, None, None]).permute(0, 2, 3, 1)
        z = F.layer_norm(z, (C,), ln_s, ln_b, eps=1e-6)
        z = F.linear(F.gelu(F.linear(z, w1, b1)), w2, b2)
        return res + (gam * z).permute(0, 3, 1, 2)
    return time_ms(run, reps)


def stage_kernel_rows(tag, kinds, stage, C, H, K, s, depth, batch, dtype, g,
                      dw_batches=(), mlp_batches=(), mlp_variants=False,
                      bwd_modes=("full",), plain_reps=REPS, **extra):
    """The kernels `kinds` names at one stage's shapes (`batch` images, C
    channels, H^2 maps, (K, s) and (s, K) taps, `depth` blocks), on inputs
    drawn from `g`: "pair" the eval K1 pair (the second launch adding into
    the first's output), "stats" K4, "wgrad" the weight gradient, "dgrad"
    K1 on the flipped taps, "mlp" K2/K3 (NCHW; `mlp_variants`: also NHWC
    and (C, M), without the residual and at RAGGED), "mlp_bwd" K8 (C <=
    256) or K9 in each of `bwd_modes`. Each against its plain version
    within its tolerance, the same bits on a second launch; the
    convolutions also at the batches `dw_batches`, the backward at
    `mlp_batches`. Each row (printed under `[tag]`) has its route, ms,
    plain ms (`plain_reps` launches a round), library ms (F.conv2d,
    conv2d_weight) or the unfused composition's ms (the MLP), its bound
    (bytes at PEAK_BYTES_PER_S, operations at the dtype's peak; the lesser
    of 3xTF32 and FFMA where fp32 runs on tensor cores) with both parts,
    the stage's blocks and the launches a block. Returns {kind: [rows]}."""
    import torch
    import torch.nn.functional as F
    from slak_tpu_torch.models import slak as S
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.ops import dwconv_wgrad as KW
    from slak_tpu_torch.ops import mlp as K2
    dev, dn, st = g.device, str(dtype).split(".")[1], stage + 1
    base = dict(dtype=dn, stage=st, C=C, H=H, taps=[K, s], batch=batch,
                blocks=depth, **extra)
    taps = [(K, s), (s, K)]
    pads = [(kh // 2, kw // 2) for kh, kw in taps]
    out = {}

    def draw(scale=1.0):
        return (torch.randn(batch, C, H, H, generator=g, device=dev)
                * scale).to(dtype)

    def emit(kind, row):
        print(f"[{tag}] " + json.dumps(row), flush=True)
        out.setdefault(kind, []).append(row)

    def worst(check, *tensors):
        """check(label, *tensors) -> (max abs err, rel err) at `batch`;
        {batchN: rel err} at each of `dw_batches`."""
        d, r = check(f"batch {batch}", *tensors)
        by = {f"batch{nb}": check(f"batch {nb}", *(
            t[:nb].contiguous() for t in tensors))[1] for nb in dw_batches}
        return d, r, by

    def dw_bounds(t, reads, words, tc):
        """The bound of one launch a tap tensor, summed: launch j moves
        reads[j] tensors of t's size and C (kh kw + words) fp32 words;
        `tc`: on the fp32 band kernel's tensor cores (conv_bounds)."""
        got = dict(bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
        for (kh, kw), n in zip(taps, reads):
            args = (n * t.numel() * t.element_size()
                    + 4 * C * (kh * kw + words),
                    2 * dwconv_macs(batch, C, H, H, kh, kw), dtype)
            b_ms, o_ms, more = (conv_bounds(*args) if tc
                                else bounds(*args) + ({},))
            got["bound_ms"] += max(b_ms, o_ms)
            got["bytes_ms"] += b_ms
            got["ops_ms"] += o_ms
            for k, v in more.items():
                got[k] = got.get(k, 0.0) + v
        return got

    if {"pair", "stats", "wgrad", "dgrad"} & set(kinds):
        x, dy = draw(), draw()
        ws = [(torch.randn(C, kh, kw, generator=g, device=dev) * 0.05
               ).to(dtype).float() for kh, kw in taps]
        wl = [w.to(dtype)[:, None] for w in ws]
        flipped = [w.flip(1, 2).contiguous() for w in ws]

    if "pair" in kinds:
        def pair(conv=K1.dwconv):
            y = conv(x, ws[0])
            return conv(x, ws[1], out=y)

        def band(xx, w, out=None):
            return K1.launch("band", xx, w, out)
        d, r, by = worst(lambda lb, xb: check_dwconv_pair(
            xb, ws, dn, f"{tag} dwconv stage {st} {lb}"), x)
        same_bits_twice(pair, f"{tag} dwconv pair stage {st} {dn}")
        route = [route_of(x, w) for w in ws]
        row = dict(kernel="dwconv2d" if route[0] == "toeplitz2d"
                   else "dwconv", route=route, **base, max_abs_err=d,
                   rel_err=r, rel_err_by_batch=by, tol=TOL_KERNEL[dn],
                   same_bits_twice=True, ms=time_ms(pair),
                   plain_ms=time_ms(lambda: pair(K1.dwconv_plain),
                                    plain_reps),
                   library_ms=time_ms(lambda: [
                       F.conv2d(x, w, padding=p, groups=C)
                       for w, p in zip(wl, pads)], plain_reps),
                   **dw_bounds(x, (2, 3), 0, route[0] == "band_f32"),
                   launches_per_block=2)
        if route[0] == "toeplitz2d":    # the route A/B: the band kernel
            row["band_ms"] = time_ms(lambda: pair(band))
        emit("pair", row)

    if "stats" in kinds:
        def check_stats(lb, xb):
            errs = [check_dwconv_stats(xb, w, dn, f"{tag} dwconv_stats "
                                       f"stage {st} {lb}") for w in ws]
            return max(e[0] for e in errs), max(e[1] for e in errs)

        def lib():
            for w, p in zip(wl, pads):
                yf = F.conv2d(x, w, padding=p, groups=C).float()
                yf.sum((0, 2, 3)), yf.square().sum((0, 2, 3))
        d, e, by = worst(check_stats, x)
        for w in ws:
            same_bits_twice(lambda: K1.dwconv_stats(x, w),
                            f"{tag} dwconv_stats stage {st} {dn}")
        route = [K1._stats_route_of(x, w) for w in ws]
        row = dict(kernel="dwconv_stats", route=route, **base,
                   max_abs_err=d, sums_rel_err=e, sums_rel_err_by_batch=by,
                   tol=TOL_KERNEL[dn], tol_sums=TOL_SUMS[dn],
                   same_bits_twice=True,
                   ms=time_ms(lambda: [K1.dwconv_stats(x, w) for w in ws]),
                   plain_ms=time_ms(lambda: [K1.dwconv_stats_plain(x, w)
                                             for w in ws], plain_reps),
                   library_ms=time_ms(lib, plain_reps),
                   **dw_bounds(x, (2, 2), 2, False), launches_per_block=2)
        if route[0] == "toeplitz2d":
            row["band_ms"] = time_ms(lambda: [K1.launch_stats("band", x, w)
                                              for w in ws])
        emit("stats", row)

    if "wgrad" in kinds:
        def check_w(lb, xb, dyb):
            errs = [check_wgrad(xb, dyb, kh, kw, dn, f"{tag} dwconv_wgrad "
                                f"stage {st} {lb} {(kh, kw)}")
                    for kh, kw in taps]
            return max(e[0] for e in errs), max(e[1] for e in errs)
        d, r, by = worst(check_w, x, dy)
        row = dict(kernel="dwconv_wgrad",
                   route=[wgrad_route_of(x, *t) for t in taps], **base,
                   max_abs_err=d, rel_err=r, rel_err_by_batch=by,
                   tol=TOL_WGRAD[dn], same_bits_twice=True,
                   dead_taps_zero=True,
                   ms=time_ms(lambda: [KW.dwconv_wgrad(x, dy, kh, kw)
                                       for kh, kw in taps]),
                   plain_ms=time_ms(lambda: [KW.dwconv_wgrad_plain(
                       x, dy, kh, kw) for kh, kw in taps], plain_reps),
                   library_ms=time_ms(lambda: [torch.nn.grad.conv2d_weight(
                       x, (C, 1, kh, kw), dy, padding=p, groups=C)
                       for (kh, kw), p in zip(taps, pads)], plain_reps),
                   **dw_bounds(x, (2, 2), 0, False), launches_per_block=2)
        emit("wgrad", row)

    if "dgrad" in kinds:
        def check_dgrad(lb, dyb):
            d = r = 0.0
            for w in flipped:
                got, want = K1.dwconv(dyb, w), K1.dwconv_plain(dyb, w)
                torch.cuda.synchronize()
                dd, rr = rel_err(got, want)
                _check(rr <= TOL_KERNEL[dn], f"{tag} dwconv dgrad stage {st}"
                       f" {lb} {tuple(w.shape[1:])} {dn}: rel err {rr:.3g}")
                d, r = max(d, dd), max(r, rr)
            return d, r
        d, r, by = worst(check_dgrad, dy)
        for w in flipped:
            same_bits_twice(lambda: K1.dwconv(dy, w),
                            f"{tag} dwconv dgrad stage {st} {dn}")
        route = [route_of(dy, w) for w in flipped]
        row = dict(kernel="dwconv_dgrad", route=route, **base,
                   max_abs_err=d, rel_err=r, rel_err_by_batch=by,
                   tol=TOL_KERNEL[dn], same_bits_twice=True,
                   ms=time_ms(lambda: [K1.dwconv(dy, w) for w in flipped]),
                   plain_ms=time_ms(lambda: [K1.dwconv_plain(dy, w)
                                             for w in flipped], plain_reps),
                   library_ms=time_ms(lambda: [F.conv2d(
                       dy, w.to(dtype)[:, None], padding=p, groups=C)
                       for w, p in zip(flipped, pads)], plain_reps),
                   **dw_bounds(dy, (2, 2), 0, route[0] == "band_f32"),
                   launches_per_block=2)
        if route[0] == "toeplitz2d":
            row["band_ms"] = time_ms(lambda: [K1.launch("band", dy, w)
                                              for w in flipped])
        emit("dgrad", row)

    if {"pair", "stats", "wgrad", "dgrad"} & set(kinds):
        del x, dy, ws, wl, flipped
    if "mlp" in kinds or "mlp_bwd" in kinds:
        y, res, dout = draw(), draw(), draw(0.1)
        pk = random_pack(C, g, dtype)
        T, F4 = batch * H * H, 4 * C

    if "mlp" in kinds:
        for layout, yy, rr, cd in (mlp_layouts(y, res) if mlp_variants
                                   else (("NCHW", y, res, 1),)):
            want = K2.fused_mlp_plain(yy, rr, pk, cd)
            got = K2.fused_mlp(yy, rr, pk, cd)
            torch.cuda.synchronize()
            d, r = rel_err(got, want)
            del got, want
            _check(r <= TOL_MLP[dn], f"{tag} fused_mlp stage {st} {layout} "
                   f"{dn}: rel err {r:.3g} > {TOL_MLP[dn]}")
            row = dict(kernel="fused_mlp", route="3xTF32" if dn == "float32"
                       else "bf16", layout=layout, **base, T=T,
                       max_abs_err=d, rel_err=r, tol=TOL_MLP[dn])
            if mlp_variants:
                row["ragged_and_no_residual"] = check_mlp_variants(
                    K2, yy, rr, pk, cd, layout, stage, dn, batch)
            if layout == "NCHW":
                same_bits_twice(lambda: K2.fused_mlp(y, res, pk, 1),
                                f"{tag} fused_mlp stage {st} {dn}")
                b_ms, o_ms, more = mlp_fwd_bounds(T, C, F4, dtype)
                ms = time_ms(lambda: K2.fused_mlp(y, res, pk, 1))
                row.update(same_bits_twice=True, ms=ms,
                           plain_ms=time_ms(lambda: K2.fused_mlp_plain(
                               y, res, pk, 1), plain_reps),
                           library_ms=None,
                           unfused_torch_ms=unfused_fwd_ms(y, res, pk, dtype,
                                                           plain_reps),
                           bound_ms=max(b_ms, o_ms), bytes_ms=b_ms,
                           ops_ms=o_ms, **more,
                           **rate(4 * T * C * F4, ms, max(b_ms, o_ms)),
                           launches_per_block=1)
            emit("mlp", row)

    if "mlp_bwd" in kinds:
        wide = C > K2.BWD_C_MAX
        name, bwd, plain = (
            ("mlp_bwd_wide", K2.fused_mlp_bwd_wide,
             K2.fused_mlp_bwd_wide_plain) if wide else
            ("mlp_bwd", K2.fused_mlp_bwd, K2.fused_mlp_bwd_plain))
        for nb in mlp_batches:              # tiles that end mid-tile
            errs, _ = check_mlp_bwd(
                bwd, plain, y[:nb].contiguous(), dout[:nb].contiguous(), pk,
                TOL_MLP_BWD[dn], f"{tag} {name} stage {st} batch {nb}")
            print(f"[{tag}] {name} stage {st} {dn} batch {nb} (T = "
                  f"{nb * H * H}): rel err " + json.dumps(errs), flush=True)
        # K9 runs in the train step where S.TRAIN_WIDE_MLP_BWD routes the
        # wide tails through FusedMlp
        rows = mlp_bwd_rows(tag, name, bwd, plain, y, dout, pk, dtype,
                            bwd_modes, stage=st, layout="NCHW", batch=batch,
                            blocks=depth, launches_per_block=int(
                                not wide or S.TRAIN_WIDE_MLP_BWD), **extra)
        out["mlp_bwd"] = [dict(row, route=mode)
                          for mode, (row, _, _) in rows.items()]
    return out


TOTAL_KEYS = ("ms", "plain_ms", "library_ms", "unfused_torch_ms", "bound_ms",
              "bytes_ms", "ops_ms")


def add_total(totals, name, row, depth):
    """Adds `depth` blocks' worth of a stage's kernel row to totals[name]:
    the times, the bound and its two parts (the 3xTF32 and FFMA operations
    bounds where the row has them), the band route's time (where the row
    has none, its own), the worst max abs err and the row's route."""
    t = totals.setdefault(name, dict(dict.fromkeys(TOTAL_KEYS, 0.0),
                                     band_ms=0.0, err=0.0, routes=[]))
    for k in TOTAL_KEYS:
        t[k] += depth * (row.get(k) or 0.0)
    t["band_ms"] += depth * row.get("band_ms", row["ms"])
    for k in ("ops_ms_3xtf32", "ops_ms_ffma"):
        if k in row:
            t[k] = t.get(k, 0.0) + depth * row[k]
    t["err"] = max(t["err"], row["max_abs_err"])
    t["routes"].append(row.get("route"))
    return t


# ---------------------------------------------------------------------------


def phase_build(ptxas: bool):
    from slak_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=ptxas)
    print(f"[build] {time.perf_counter() - t0:.1f} s wall for "
          f"{sorted(logs) or 'nothing (up to date)'}")
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, (sec, log) in logs.items():
        print(f"[build] {name}: {sec:.1f} s")
        with open(os.path.join(OUT_DIR, f"ptxas_{name}.txt"), "w") as f:
            f.write(log)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")


def phase_kernels(cfg, batch):
    """Each kernel of the eval path against its plain version at the main
    path's shapes (``stage_kernel_rows``: the K1 pair also at DW_BATCHES,
    K2/K3 in its three layouts, without the residual and at RAGGED); first
    the bf16 K1 pair at DW_EDGES. Returns the per-forward bf16 totals: the
    K1 pairs by kernel (dwconv.cu's, stages 1-3; K6's Toeplitz kernel,
    stage 4, with the band route's time at the same shapes) and K2/K3."""
    import torch
    check_dwconv_edges("kernels", train=False)
    g = torch.Generator(device="cuda").manual_seed(0)
    totals = {}
    for dtype in (torch.bfloat16, torch.float32):
        for i, C, H, K, s, depth in stage_shapes(cfg):
            rows = stage_kernel_rows("kernels", ("pair", "mlp"), i, C, H, K,
                                     s, depth, batch, dtype, g,
                                     dw_batches=DW_BATCHES, mlp_variants=True)
            if dtype == torch.bfloat16:
                pair = rows["pair"][0]
                add_total(totals, pair["kernel"], pair, depth)
                t = add_total(totals, "fused_mlp", rows["mlp"][0], depth)
                t["err"] = max([t["err"]] + [r["max_abs_err"]
                                             for r in rows["mlp"]])
            torch.cuda.empty_cache()
    return totals


def randomize(model, seed: int):
    """Random weights from a seed that make every block matter: gamma near
    0.2 (not 1e-6), BN statistics and affines away from identity."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=g).to(p.device)
            if name.endswith("gamma"):
                p.copy_(0.2 + 0.05 * noise)
            elif ".bn." in name or p.ndim == 1:
                p.add_(0.05 * noise)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.05 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(1.0 + 0.2 * torch.rand(b.shape, generator=g))


def k6_convs(cfg, per_block: int = 2) -> int:
    """The bf16 K1 (or K4) launches of one pass on K6's Toeplitz kernel:
    ``per_block`` a block of the stages whose maps have H * W <= P_MAX at
    224^2 (stage 4's 7x7)."""
    from slak_tpu_torch.ops import dwconv as K1
    return sum(per_block * depth for _, _, H, _, _, depth in
               stage_shapes(cfg) if H * H <= K1.P_MAX)


def phase_forward(batch):
    """The main path; returns the model and the launch counts of the bf16
    run and of the fp32 run (K1, K2/K3, K1 on the band kernel, K2/K3 on
    the 3xTF32 route, K1 on the fp32 band kernel, K1 on K6's Toeplitz
    kernel)."""
    import torch
    from slak_tpu_torch.models import apply, create_model
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.ops import mlp as K2
    from slak_tpu_torch.train.engine import make_eval_step
    model = create_model("SLaK_tiny", dtype=torch.bfloat16, seed=0,
                         **MODEL_KW)
    randomize(model, 1)
    n_blocks = sum(model.cfg.depths)
    n_conv = sum(len(b.prepared(torch.bfloat16, torch.device("cuda"))[0])
                 for s in model.stages for b in s)
    print(f"[forward] SLaK-T 51x51 w1.3: dims {model.cfg.widened_dims}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M params,"
          f" {n_conv} conv + {n_blocks} MLP launches per forward")
    g = torch.Generator().manual_seed(2)
    batches = [(torch.randn(batch, 224, 224, 3, generator=g),
                torch.randint(0, 1000, (batch,), generator=g))
               for _ in range(N_BATCHES)]
    counts = None
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        step = make_eval_step(model, dtype)
        step(batches[0])                     # pack weights, warm up
        torch.cuda.synchronize()
        K1.launch_count = K1.band_launch_count = K1.tf32_launch_count = 0
        K1.toeplitz_launch_count = 0
        K2.launch_count = K2.tf32_launch_count = 0
        t0 = time.perf_counter()
        outs = [step(b) for b in batches]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = (K1.launch_count, K2.launch_count, K1.band_launch_count,
               K2.tf32_launch_count, K1.tf32_launch_count,
               K1.toeplitz_launch_count)
        if dtype == torch.bfloat16:
            counts = got
        else:
            counts_fp32 = got
        print(f"[forward] {dn}: {N_BATCHES} batches of {batch} in "
              f"{sec:.3f} s; launches dwconv {got[0]} (on the band kernel "
              f"{got[2]}, on K6's Toeplitz kernel {got[5]}, on the fp32 "
              f"band kernel {got[4]}), fused_mlp {got[1]} (on the 3xTF32 "
              f"route {got[3]})")
        # bf16: every K1 launch of stage 4 (7x7) on K6's Toeplitz kernel,
        # every other one on the band kernel; fp32: every K1 launch on the
        # fp32 band kernel and every K2/K3 launch on the 3xTF32 route
        bf16 = dtype == torch.bfloat16
        k6 = k6_convs(model.cfg) * N_BATCHES if bf16 else 0
        want = (n_conv * N_BATCHES, n_blocks * N_BATCHES,
                n_conv * N_BATCHES - k6 if bf16 else 0,
                0 if bf16 else n_blocks * N_BATCHES,
                0 if bf16 else n_conv * N_BATCHES, k6)
        _check(got == want, f"{dn} launch counts {got}, want {want}")
        for j, (o, (x, y)) in enumerate(zip(outs, batches)):
            lg = o["logits"]
            _check(lg.shape == (batch, 1000) and bool(
                torch.isfinite(lg).all()), f"{dn} logits bad: {lg.shape}")
            want = apply(model, x.to("cuda", dtype), plain=True)
            d, r = rel_err(lg, want)
            top1 = (lg.argmax(-1) == want.argmax(-1)).float().mean().item()
            print(f"[forward] {dn} batch {j}: loss {o['loss'].item():.6f} "
                  f"acc1 {o['acc1'].item():.4f} acc5 {o['acc5'].item():.4f}"
                  f" | vs plain: max abs {d:.4g}, rel {r:.4g} (tol "
                  f"{TOL_LOGITS[dn]}), top-1 agreement {top1:.4f}")
            _check(r <= TOL_LOGITS[dn], f"{dn} logits rel err {r:.3g}")
    check_convnext(batches[0])
    return model, counts, counts_fp32


def check_convnext(batch):
    """ConvNeXt-T (7x7 taps, decom=False, no BN, no small branch: one K1
    launch a block) through make_eval_step, bf16 and fp32, launch counters
    set to 0 just before and read just after, the logits against the same
    weights through the plain versions. bf16: stages 1-3 on the tiled K1
    kernel, stage 4 on K6's Toeplitz kernel; fp32: all on the tiled
    kernel, K2/K3 on the 3xTF32 route."""
    import torch
    from slak_tpu_torch.models import apply, create_model
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.ops import mlp as K2
    from slak_tpu_torch.train.engine import make_eval_step
    model = create_model("convnext_tiny", seed=0)
    randomize(model, 1)
    n_blocks = sum(model.cfg.depths)
    k6 = k6_convs(model.cfg, per_block=1)
    x, _ = batch
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        step = make_eval_step(model, dtype)
        step(batch)                          # pack weights, warm up
        torch.cuda.synchronize()
        reset_counts()
        lg = step(batch)["logits"]
        torch.cuda.synchronize()
        got = read_counts()
        bf16 = dtype == torch.bfloat16
        want = dict({k: 0 for k in got}, dwconv=n_blocks,
                    dwconv_toeplitz=k6 if bf16 else 0, fused_mlp=n_blocks,
                    fused_mlp_tf32=0 if bf16 else n_blocks)
        want_plain = apply(model, x.to("cuda", dtype), plain=True)
        d, r = rel_err(lg, want_plain)
        print(f"[forward] ConvNeXt-T {dn} batch {x.shape[0]}: launches "
              f"dwconv {got['dwconv']} (on K6's Toeplitz kernel "
              f"{got['dwconv_toeplitz']}, the rest on the tiled kernel), "
              f"fused_mlp {got['fused_mlp']} (3xTF32 "
              f"{got['fused_mlp_tf32']}) | vs plain: max abs {d:.4g}, rel "
              f"{r:.4g} (tol {TOL_LOGITS[dn]})", flush=True)
        _check(got == want, f"ConvNeXt-T {dn} launch counts {got}, want "
               f"{want}")
        _check(lg.shape == want_plain.shape and bool(
            torch.isfinite(lg).all()), f"ConvNeXt-T {dn} logits bad")
        _check(r <= TOL_LOGITS[dn], f"ConvNeXt-T {dn} logits rel err "
               f"{r:.3g}")
    del model
    torch.cuda.empty_cache()


def phase_timing(model, batch):
    import torch
    from slak_tpu_torch.models import apply
    x = torch.randn(batch, 224, 224, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3)
                    ).to(torch.bfloat16)
    ms = time_ms(lambda: apply(model, x))
    plain_ms = time_ms(lambda: apply(model, x, plain=True), 3, warmup=1)
    print(f"[timing] bf16 eval forward bs{batch}: kernels {ms:.3f} ms "
          f"({batch / ms * 1e3:.1f} img/s); plain versions {plain_ms:.3f} ms"
          f" ({batch / plain_ms * 1e3:.1f} img/s); peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return ms


def phase_train_kernels(cfg, batch):
    """The train step's kernels against their plain versions at the train
    shapes (``stage_kernel_rows``): K4, the weight gradient and the K1
    dgrad (bf16 also at DW_BATCHES), K8 (stages 1-2) and K9 (stages 3-4),
    also at the ragged batches RAGGED; first bf16 K4, the K1 dgrad and the
    weight gradient at DW_EDGES and the weight gradient at
    WGRAD_EDGES_TILED. Returns per-train-step bf16 totals for the JSON
    line (stage 4's K4 and dgrad, on K6's Toeplitz kernel, as
    dwconv2d_stats and dwconv2d_dgrad, with the band route's time) and
    K9's bf16 rows."""
    import torch
    check_dwconv_edges("train_kernels", train=True)
    check_wgrad_edges("train_kernels")
    check_wgrad_tiled_edges("train_kernels")
    g = torch.Generator(device="cuda").manual_seed(10)
    totals, on_7x7, k9_bf16 = {}, {}, []
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        for i, C, H, K, s, depth in stage_shapes(cfg):
            rows = stage_kernel_rows(
                "train_kernels", ("stats", "wgrad", "dgrad", "mlp_bwd"), i, C,
                H, K, s, depth, batch, dtype, g,
                dw_batches=DW_BATCHES if bf16 else (), mlp_batches=RAGGED)
            torch.cuda.empty_cache()
            if not bf16:
                continue
            for kind in ("stats", "wgrad", "dgrad"):
                row = rows[kind][0]
                name = row["kernel"]
                if row["route"][0] == "toeplitz2d":
                    name = name.replace("dwconv_", "dwconv2d_")
                add_total(totals, name, row, depth)
                if H == 7:      # stage 4: the TPU's K6 forward/dgrad and K7
                    add_total(on_7x7, row["kernel"], row, depth)
            row = rows["mlp_bwd"][0]
            add_total(totals, row["kernel"], row, depth)
            if row["kernel"] == "mlp_bwd_wide":
                k9_bf16.append(row)
    print("[train_kernels] per bf16 step, of which on the 7x7 maps: "
          + json.dumps({n: {k: round(t[k], 4) for k in (
              "ms", "plain_ms", "library_ms", "bound_ms")}
              for n, t in on_7x7.items()}), flush=True)
    return totals, k9_bf16


def phase_erf_kernels(cfg):
    """The ERF path's kernels against their plain versions in fp32 at the
    four 1024^2 stage shapes (batch 1): K1 (forward and flipped-tap
    dgrad, each a pair of launches adding into one output, as
    ``DwconvTaps`` runs them), then K2/K3, K8 (stages 1-2) and K9 (stages
    3-4) through ``stage_kernel_rows``, K8 and K9 in both modes (the ERF
    runs dy-only). Returns per-image totals for the JSON line, K8/K9's in
    dy-only mode and, as mlp_bwd_full and mlp_bwd_wide_full, in the full
    mode (K9 in bf16: ``phase_train_kernels``)."""
    import torch
    import torch.nn.functional as F
    from slak_tpu_torch.ops import dwconv as K1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    totals = {}
    # fp32, batch 1, 1024^2: every kernel of the ERF path
    dt = torch.float32
    for i, C, H, K, s, depth in stage_shapes(cfg, ERF_SIZE):
        x = torch.randn(1, C, H, H, generator=g, device=dev)
        dy = torch.randn(1, C, H, H, generator=g, device=dev)
        taps = [(K, s), (s, K)]
        ws = [torch.randn(C, kh, kw, generator=g, device=dev) * 0.05
              for kh, kw in taps]
        flipped = [w.flip(1, 2).contiguous() for w in ws]
        for name, inp, tt in (("dwconv", x, ws), ("dwconv_dgrad", dy,
                                                 flipped)):
            got = K1.conv_taps(inp, tt)
            want = K1.conv_taps(inp, tt, plain=True)
            torch.cuda.synchronize()
            d, r = rel_err(got, want)
            _check(r <= TOL_KERNEL["float32"], f"{name} 1024^2 stage "
                   f"{i + 1}: rel err {r:.3g}")
            # no atomics: the pair gives the same bits on a second launch
            same_bits_twice(lambda: K1.conv_taps(inp, tt),
                            f"{name} 1024^2 stage {i + 1}")
            lib_w = [w[:, None] for w in tt]
            b_ms = o_ms = bound = 0.0
            ops = {}
            for (kh, kw), n_t in zip(taps, (2, 3)):
                bb, oo, more = conv_bounds(
                    n_t * inp.numel() * 4 + 4 * C * kh * kw,
                    2 * dwconv_macs(1, C, H, H, kh, kw), dt)
                b_ms, o_ms, bound = b_ms + bb, o_ms + oo, bound + max(bb, oo)
                for k, v in more.items():
                    ops[k] = ops.get(k, 0.0) + v
            row = dict(kernel=name, dtype="float32", stage=i + 1, C=C, H=H,
                       taps=[K, s], batch=1,
                       route=[route_of(inp, w) for w in tt],
                       max_abs_err=d, rel_err=r,
                       tol=TOL_KERNEL["float32"],
                       ms=time_ms(lambda: K1.conv_taps(inp, tt)),
                       plain_ms=time_ms(lambda: K1.conv_taps(inp, tt,
                                                             plain=True)),
                       library_ms=time_ms(lambda: [F.conv2d(
                           inp, w, padding=(kh // 2, kw // 2), groups=C)
                           for w, (kh, kw) in zip(lib_w, taps)]),
                       bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms, **ops)
            print("[erf_kernels] " + json.dumps(row), flush=True)
            add_total(totals, name, row, depth)
        del x, dy
        rows = stage_kernel_rows("erf_kernels", ("mlp", "mlp_bwd"), i, C, H,
                                 K, s, depth, 1, dt, g,
                                 bwd_modes=("full", "dy_only"),
                                 size=ERF_SIZE)
        add_total(totals, "fused_mlp", rows["mlp"][0], depth)
        for row in rows["mlp_bwd"]:
            add_total(totals, row["kernel"] + (
                "_full" if row["mode"] == "full" else ""), row, depth)
        torch.cuda.empty_cache()
    print("[erf_kernels] per fp32 1024^2 image: " + json.dumps(
        {n: {k: round(v, 4) for k, v in t.items() if k != "routes"}
         for n, t in totals.items()}), flush=True)
    return totals


def _counters():
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.ops import dwconv_wgrad as KW
    from slak_tpu_torch.ops import mlp as K2
    return K1, KW, K2


def reset_counts():
    from slak_tpu_torch.ops import dwconv_stacked as K11
    from slak_tpu_torch.ops import dwpair as K10
    K1, KW, K2 = _counters()
    K1.launch_count = K1.stats_launch_count = KW.launch_count = 0
    KW.band_launch_count = 0
    K1.band_launch_count = K1.band_stats_launch_count = 0
    K1.toeplitz_launch_count = K1.toeplitz_stats_launch_count = 0
    K1.tf32_launch_count = 0
    K2.launch_count = K2.bwd_launch_count = K2.wide_bwd_launch_count = 0
    K2.bwd_dy_launch_count = K2.wide_bwd_dy_launch_count = 0
    K10.pair_launch_count = K10.pair_band_launch_count = 0
    K2.dual_launch_count = 0
    K2.tf32_launch_count = 0
    K11.stacked_launch_count = K1.probe_launch_count = 0
    K11.stacked_band_launch_count = K1.probe_band_launch_count = 0


def read_dual_counts():
    """The counters of the dual eval path and of the probes (K10, K12, K11,
    K13) beside K1's and K2/K3's."""
    from slak_tpu_torch.ops import dwconv_stacked as K11
    from slak_tpu_torch.ops import dwpair as K10
    K1, _, K2 = _counters()
    return {"dwpair": K10.pair_launch_count,
            "dwpair_band": K10.pair_band_launch_count,
            "fused_mlp_dual": K2.dual_launch_count,
            "dwconv_stacked": K11.stacked_launch_count,
            "dwconv_stacked_band": K11.stacked_band_launch_count,
            "dwconv_probe": K1.probe_launch_count,
            "dwconv_probe_band": K1.probe_band_launch_count,
            "dwconv": K1.launch_count, "fused_mlp": K2.launch_count}


def read_counts():
    K1, KW, K2 = _counters()
    return {"dwconv": K1.launch_count, "dwconv_stats": K1.stats_launch_count,
            "dwconv_band": K1.band_launch_count,
            "dwconv_toeplitz": K1.toeplitz_launch_count,
            "dwconv_tf32": K1.tf32_launch_count,
            "dwconv_stats_band": K1.band_stats_launch_count,
            "dwconv_stats_toeplitz": K1.toeplitz_stats_launch_count,
            "dwconv_wgrad": KW.launch_count,
            "dwconv_wgrad_band": KW.band_launch_count,
            "fused_mlp": K2.launch_count,
            "fused_mlp_tf32": K2.tf32_launch_count,
            "mlp_bwd": K2.bwd_launch_count,
            "mlp_bwd_wide": K2.wide_bwd_launch_count,
            "mlp_bwd_dy_only": K2.bwd_dy_launch_count,
            "mlp_bwd_wide_dy_only": K2.wide_bwd_dy_launch_count}


def train_setup(batch, dtype, mask_kw, seed=0, snip=True, masks=None,
                model_state=None, remat=False, group=None):
    """(model, train state, step fn, batches) of the flagship train path.
    With a process ``group`` (data parallel): the model's BNs averaged over
    it (SyncBN), each batch this rank's shard of the global ``batch``, and
    SNIP's gradients averaged over it."""
    import torch
    from slak_tpu_torch.models import apply, create_model
    from slak_tpu_torch.parallel import mesh
    from slak_tpu_torch.sparsity.masking import MaskConfig
    from slak_tpu_torch.train import losses as L
    from slak_tpu_torch.train.engine import (TrainConfig, create_train_state,
                                             make_train_step)
    from slak_tpu_torch.train.optim import cosine_schedule_array
    model = create_model("SLaK_tiny", dtype=dtype, seed=seed,
                         drop_path_rate=0.1, remat=remat,
                         bn_axis_name=None if group is None else
                         mesh.DATA_AXIS, **MODEL_KW)
    if model_state is not None:
        model.load_state_dict(model_state)
    else:
        randomize(model, 1)
    g = torch.Generator(device="cuda").manual_seed(7)
    batches = [(torch.randn(batch, 224, 224, 3, generator=g, device="cuda"),
                torch.randint(0, 1000, (batch,), generator=g, device="cuda"))
               for _ in range(2)]
    if group is not None:
        batches = [mesh.shard_batch(b) for b in batches]
    mc = MaskConfig(**mask_kw)
    tc = TrainConfig(compute_dtype=dtype, weight_decay=0.05,
                     ema_decay=0.9999, prune_t_max=100)

    def snip_loss():
        x, y = batches[0]
        return L.cross_entropy(apply(model, x.to(dtype)), y)
    state = create_train_state(model, tc, mc,
                               snip_loss if snip and masks is None else None,
                               masks=masks, seed=seed, group=group)
    lr = cosine_schedule_array(1e-3, 1e-6, 1, 100)
    return model, state, tc, mc, lr, batches


def cli_counts(cfg, steps=0, evals=0, snips=0, remat=False) -> dict:
    """The launch counts (read_counts' keys) of `steps` bf16 train steps
    (with remat K4 and K2 launch once more a block, in the backward's
    recompute), `evals` bf16 eval forwards and `snips` float32 SNIP
    scorings (an eval-mode forward and backward with every parameter's
    gradient: K1 and its dgrad on the fp32 band kernel, the tiled fp32
    weight gradient, K2/K3 on 3xTF32, K8 and K9 in the full mode) of the
    flagship at 224^2."""
    from slak_tpu_torch.models import slak as S
    from slak_tpu_torch.ops.mlp import BWD_C_MAX
    nb = sum(cfg.depths)
    narrow = sum(d for d, c in zip(cfg.depths, cfg.widened_dims)
                 if c <= BWD_C_MAX)
    wide = nb - narrow if S.TRAIN_WIDE_MLP_BWD else 0
    k6 = k6_convs(cfg)
    fwd = 2 if remat else 1
    return {
        "dwconv": 2 * nb * (steps + evals) + 4 * nb * snips,
        "dwconv_stats": 2 * nb * fwd * steps,
        "dwconv_band": (2 * nb - k6) * (steps + evals),
        "dwconv_toeplitz": k6 * (steps + evals),
        "dwconv_tf32": 4 * nb * snips,
        "dwconv_stats_band": (2 * nb - k6) * fwd * steps,
        "dwconv_stats_toeplitz": k6 * fwd * steps,
        "dwconv_wgrad": 2 * nb * (steps + snips),
        "dwconv_wgrad_band": 2 * nb * steps,
        "fused_mlp": (narrow + wide) * fwd * steps + nb * (evals + snips),
        "fused_mlp_tf32": nb * snips,
        "mlp_bwd": narrow * (steps + snips),
        "mlp_bwd_wide": wide * steps + (nb - narrow) * snips,
        "mlp_bwd_dy_only": 0, "mlp_bwd_wide_dy_only": 0}


TRAIN_MASK = dict(sparsity=0.4, sparse_init="snip", prune_mode="magnitude",
                  growth_mode="random", prune_rate=0.5, update_frequency=2)


def phase_train(batch):
    """The train path; returns the launch counts of its bf16 steps."""
    import copy
    import torch
    from slak_tpu_torch.models import slak as S
    from slak_tpu_torch.train.engine import make_train_step
    dtype = torch.bfloat16
    t0 = time.perf_counter()
    model, state, tc, mc, lr, batches = train_setup(batch, dtype, TRAIN_MASK)
    masks0 = {n: m.clone() for n, m in state.mask_state.masks.items()}
    sd0 = copy.deepcopy(model.state_dict())
    dens = (sum(float(m.sum()) for m in masks0.values())
            / sum(m.numel() for m in masks0.values()))
    print(f"[train] set-up (SNIP masks, {len(masks0)} masked tensors, "
          f"density {dens:.4f}) {time.perf_counter() - t0:.1f} s",
          flush=True)
    step = make_train_step(model, tc, mc, lr)
    named = dict(model.named_parameters())
    gen = torch.Generator(device="cuda").manual_seed(11)
    n_refresh = 0
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for k in range(TRAIN_STEPS):
        before = {n: m.clone() for n, m in state.mask_state.masks.items()}
        state, met = step(state, batches[k % 2], gen)
        masks = state.mask_state.masks
        changed = any(not torch.equal(before[n], masks[n]) for n in masks)
        n_refresh += changed
        loss = met["loss"].item()
        _check(math.isfinite(loss), f"step {k}: loss {loss}")
        for n, m in masks.items():
            z = (named[n].detach() * (1 - m)).abs().max().item()
            _check(z == 0.0, f"step {k}: masked weights of {n} not 0 ({z})")
        if changed:
            # random growth regrows Binomial(zeros, regrowth / zeros)
            for n, m in masks.items():
                nb, na = before[n].sum().item(), m.sum().item()
                _check(abs(na - nb) <= 6 * max(nb, 1) ** 0.5 + 1,
                       f"step {k}: {n} count {nb} -> {na}")
        print(f"[train] step {k}: loss {loss:.5f} grad_norm "
              f"{met['grad_norm'].item():.4f} lr {met['lr'].item():.3g} "
              f"refresh {bool(changed)}", flush=True)
    torch.cuda.synchronize()
    counts = read_counts()
    sec = time.perf_counter() - t0
    # every K4 and K1 dgrad launch of the bf16 step on stage 4 (7x7) on
    # K6's Toeplitz kernel, every other one and every weight-gradient
    # launch on its band kernel; the wide tails through FusedMlp (K2 + K9)
    # where TRAIN_WIDE_MLP_BWD routes them
    want = cli_counts(model.cfg, steps=TRAIN_STEPS)
    print(f"[train] {TRAIN_STEPS} bf16 steps at batch {batch} in {sec:.2f} s;"
          f" launches {counts}; refreshes {n_refresh}; TRAIN_WIDE_MLP_BWD "
          f"{S.TRAIN_WIDE_MLP_BWD}", flush=True)
    _check(counts == want, f"launch counts {counts}, want {want}")
    _check(n_refresh == TRAIN_STEPS // mc.update_frequency,
           f"{n_refresh} DST refreshes, want "
           f"{TRAIN_STEPS // mc.update_frequency}")
    ema = state.ema
    _check(all(bool(torch.isfinite(v).all()) for v in ema.values()),
           "EMA not finite")
    del model, state, step, batches
    torch.cuda.empty_cache()

    # one step from the same state, kernel route vs plain route
    for dtype, b in ((torch.bfloat16, batch),
                     (torch.float32, CHECK_BATCH_FP32)):
        dn = str(dtype).split(".")[1]
        runs = []
        for plain in (False, True):
            model, state, tc, mc, lr, batches = train_setup(
                b, dtype, TRAIN_MASK, masks={n: m.clone() for n, m in
                                             masks0.items()},
                model_state=sd0)
            step = make_train_step(model, tc, mc, lr, plain=plain)
            state, met = step(state, batches[0],
                              torch.Generator(device="cuda").manual_seed(5))
            grads = {n: p.grad.detach().float().clone()
                     for n, p in model.named_parameters()}
            bn = {n: v.clone() for n, v in model.state_dict().items()
                  if "running" in n}
            runs.append((met["loss"].item(), grads, bn))
            del model, state, step, batches
            torch.cuda.empty_cache()
        (lk, gk, bk), (lp, gp, bp) = runs
        tol = TOL_STEP[dn]
        le = abs(lk - lp) / abs(lp)
        ge = {n: ((gk[n] - gp[n]).norm() / gp[n].norm().clamp(min=1e-30)
                  ).item() for n in gp}
        worst = max(ge, key=ge.get)
        be = max(rel_err(bk[n], bp[n])[1] for n in bp)
        print(f"[train] one {dn} step at batch {b}, kernels vs plain: loss "
              f"{lk:.6f} vs {lp:.6f} (rel {le:.3g}, tol {tol['loss']}); "
              f"grad rel norm err max {ge[worst]:.3g} ({worst}), median "
              f"{statistics.median(ge.values()):.3g} (tol {tol['grad']}); "
              f"BN running stats rel {be:.3g} (tol {tol['bn']})", flush=True)
        _check(le <= tol["loss"], f"{dn} step loss rel err {le:.3g}")
        _check(ge[worst] <= tol["grad"], f"{dn} grad {worst} rel err "
               f"{ge[worst]:.3g}")
        _check(be <= tol["bn"], f"{dn} BN stats rel err {be:.3g}")
    check_remat_step(batch, masks0, sd0)
    return counts


def check_remat_step(batch, masks0, sd0):
    """One bf16 step with remat (each block under torch.utils.checkpoint)
    against one without, from the same state and drop-path generator, both
    through the kernels: loss, every gradient and the BN stats within
    TOL_STEP; the launches of the step with remat counted (K4 and K2 twice,
    once more in the backward's recompute)."""
    import torch
    from slak_tpu_torch.train.engine import make_train_step
    runs, counts = [], None
    for remat in (False, True):
        model, state, tc, mc, lr, batches = train_setup(
            batch, torch.bfloat16, TRAIN_MASK,
            masks={n: m.clone() for n, m in masks0.items()},
            model_state=sd0, remat=remat)
        step = make_train_step(model, tc, mc, lr)
        torch.cuda.synchronize()
        reset_counts()
        state, met = step(state, batches[0],
                          torch.Generator(device="cuda").manual_seed(5))
        torch.cuda.synchronize()
        counts = read_counts()
        runs.append((met["loss"].item(),
                     {n: p.grad.detach().float().clone()
                      for n, p in model.named_parameters()},
                     {n: v.clone() for n, v in model.state_dict().items()
                      if "running" in n}))
        del model, state, step, batches
        torch.cuda.empty_cache()
    (l0, g0, b0), (l1, g1, b1) = runs
    tol = TOL_STEP["bfloat16"]
    le = abs(l1 - l0) / abs(l0)
    ge = max(((g1[n] - g0[n]).norm() / g0[n].norm().clamp(min=1e-30)).item()
             for n in g0)
    be = max(rel_err(b1[n], b0[n])[1] for n in b0)
    print(f"[train] one bf16 step at batch {batch}, remat vs none: loss "
          f"{l1:.6f} vs {l0:.6f} (rel {le:.3g}, tol {tol['loss']}); grad "
          f"rel norm err max {ge:.3g} (tol {tol['grad']}); BN stats rel "
          f"{be:.3g} (tol {tol['bn']}); launches with remat {counts}",
          flush=True)
    _check(le <= tol["loss"], f"remat step loss rel err {le:.3g}")
    _check(ge <= tol["grad"], f"remat step grad rel err {ge:.3g}")
    _check(be <= tol["bn"], f"remat step BN stats rel err {be:.3g}")
    from slak_tpu_torch.models.slak import config_for
    want = cli_counts(config_for("SLaK_tiny", **MODEL_KW), steps=1,
                      remat=True)
    _check(counts == want, f"remat step launch counts {counts}, want {want}")


CLI_ARGS = ["--model", "SLaK_tiny", "--kernel_size", "51", "49", "47", "13",
            "5", "--width_factor", "1.3", "--Decom", "true", "--data_set",
            "synthetic", "--input_size", "224", "--batch_size",
            str(TRAIN_BATCH), "--sparse", "--sparse_init", "snip",
            "--sparsity", "0.4", "-u", "2", "--model_ema", "true",
            "--use_bf16", "true", "--warmup_epochs", "0"]


def _device_copy(tree):
    """A copy of every tensor in a nested dict / list, on its device."""
    import torch
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _device_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_device_copy(v) for v in tree)
    return tree


def _cli_run(tag, argv, want, resume_from=None):
    """One in-process run of the train CLI with the launch counters set to
    0 just before and read just after; every DST refresh checked (at
    least one mask entry moved, each masked tensor's live count within
    the binomial bound of random growth, as in `train`); with
    `resume_from`, the first step's state held to that checkpoint, bit
    for bit. The step hook runs inside the CLI's timed epoch, so it only
    makes copies on the device (the masks before each step; the first
    step's whole state), which read nothing from the card; every check
    runs on them after the CLI returns. Returns (the CLI's result, the
    number of refreshes, seconds)."""
    import torch
    from slak_tpu_torch.train import checkpoint as ckpt
    from slak_tpu_torch.train.main import main, parse_args
    seen = {"state": None, "masks": [], "start": None}

    def hook(state, epoch, i):
        if seen["state"] is None and resume_from is not None:
            seen["start"] = _device_copy(ckpt.state_dict(state, epoch - 1))
        seen["state"] = state
        seen["masks"].append({n: m.to(torch.bool) for n, m in
                              state.mask_state.masks.items()})

    def check_resumed(now):
        saved = torch.load(resume_from, weights_only=False,
                           map_location=next(
                               seen["state"].model.parameters()).device)
        _check(now["step"] == saved["step"], f"[cli {tag}] step "
               f"{now['step']} != saved {saved['step']}")
        pairs = [(f"model {k}", v, saved["model"][k])
                 for k, v in now["model"].items()]
        for k in ("masks", "fired"):
            pairs += [(f"{k} {n}", v, saved["mask_state"][k][n])
                      for n, v in now["mask_state"][k].items()]
        pairs += [(f"ema {n}", v, saved["ema"][n])
                  for n, v in now["ema"].items()]
        opt_now, opt_saved = (o["optimizer"]["state"] for o in (now, saved))
        pairs += [(f"optimizer {i} {k}", v, opt_saved[i][k])
                  for i, st in opt_now.items() for k, v in st.items()
                  if torch.is_tensor(v)]
        bad = [n for n, a, b in pairs if not torch.equal(a, b.to(a.device))]
        _check(not bad and len(opt_now) == len(opt_saved),
               f"[cli {tag}] resumed state differs from {resume_from}: "
               f"{bad[:5]}")
        print(f"[cli {tag}] first step of epoch {now['epoch'] + 1} starts "
              f"from {os.path.basename(resume_from)}: {len(pairs)} tensors "
              f"equal bit for bit", flush=True)

    def check_refreshes(snaps):
        refreshes = moved = 0
        for before, after in zip(snaps, snaps[1:]):
            if all(torch.equal(before[n], after[n]) for n in after):
                continue
            refreshes += 1
            for n, m in after.items():
                moved += int((before[n] != m).sum())
                nb, na = before[n].sum().item(), m.sum().item()
                _check(abs(na - nb) <= 6 * max(nb, 1) ** 0.5 + 1,
                       f"[cli {tag}] {n} live count {nb} -> {na}")
        return refreshes, moved

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = main(parse_args(argv), hook)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read_counts()
    state = seen["state"]
    if resume_from is not None:
        check_resumed(seen["start"])
        seen["start"] = None
    n_steps = len(seen["masks"]) // max(len(out["epochs"]), 1)
    refreshes, moved = check_refreshes(seen["masks"] + [
        {n: m.to(torch.bool) for n, m in state.mask_state.masks.items()}])
    seen["masks"] = []
    for st in out["epochs"]:
        print(f"[cli {tag}] epoch {st['epoch']}: {st['images_per_sec']:.1f}"
              f" img/s and {st['step_ms']:.1f} ms a step with the loader "
              f"feeding over a {n_steps}-step epoch (host "
              f"transform path {out['host_path']}, loader {out['loader']}); "
              f"train loss {st['train_loss']:.5f}"
              + (f"; val acc1 {st['test_acc1']:.4f}" if "test_acc1" in st
                 else ""), flush=True)
        _check(math.isfinite(st["train_loss"]), f"[cli {tag}] train loss "
               f"{st['train_loss']}")
    finite = all(bool(torch.isfinite(p).all())
                 for p in state.model.parameters()) and all(
        bool(torch.isfinite(v).all()) for v in state.ema.values())
    print(f"[cli {tag}] {sec:.1f} s; DST refreshes {refreshes} "
          f"({moved} mask entries moved); launches {counts}", flush=True)
    _check(finite, f"[cli {tag}] parameters or EMA not finite")
    _check(counts == want, f"[cli {tag}] launch counts {counts}, want "
           f"{want}")
    return out, refreshes, sec


def phase_cli():
    """The train CLI (slak_tpu_torch.train.main) on the flagship, in
    process: the recipe run (1 epoch of 4 steps, eval, checkpoint), the
    resumed run (auto-resumes from checkpoint-0, runs epoch 1), the Adan +
    remat run (2 steps, no eval). Checkpoints go under OUT_DIR and are
    removed at the end."""
    import shutil
    from slak_tpu_torch.models.slak import config_for
    cfg = config_for("SLaK_tiny", **MODEL_KW)
    out_dir = os.path.join(OUT_DIR, "cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    steps = 512 // TRAIN_BATCH
    runs = {}
    try:
        runs["recipe"] = _cli_run(
            "recipe", CLI_ARGS + ["--epochs", "1", "--synthetic_len", "512",
                                  "--output_dir", out_dir],
            cli_counts(cfg, steps=steps, evals=1, snips=1))
        runs["resume"] = _cli_run(
            "resume", CLI_ARGS + ["--epochs", "2", "--synthetic_len", "512",
                                  "--output_dir", out_dir],
            cli_counts(cfg, steps=steps, evals=1, snips=1),
            resume_from=os.path.join(out_dir, "checkpoint-0"))
        _check([s["epoch"] for s in runs["resume"][0]["epochs"]] == [1],
               "the resumed run did not run epoch 1 alone")
        runs["adan_remat"] = _cli_run(
            "adan_remat", CLI_ARGS + ["--epochs", "1", "--synthetic_len",
                                      "256", "--opt", "adan", "--remat",
                                      "true", "--disable_eval", "true"],
            cli_counts(cfg, steps=256 // TRAIN_BATCH, snips=1, remat=True))
        for tag, (_, refreshes, _) in runs.items():
            _check(refreshes >= 1, f"[cli {tag}] no DST refresh")
    finally:
        for f in os.listdir(out_dir) if os.path.isdir(out_dir) else ():
            if f.startswith("checkpoint-"):
                os.remove(os.path.join(out_dir, f))
    print(f"[cli] {smi_line()}", flush=True)
    return {tag: dict(images_per_sec=[s["images_per_sec"]
                                      for s in out["epochs"]],
                      step_ms=[s["step_ms"] for s in out["epochs"]],
                      host_path=out["host_path"], loader=out["loader"],
                      seconds=sec)
            for tag, (out, _, sec) in runs.items()}


def phase_train_timing(batch):
    """The bf16 train step (DST refresh every 100 steps, the reference's
    interval, so none falls in the window), kernel route and plain route
    timed in this run."""
    import torch
    from slak_tpu_torch.train.engine import make_train_step
    out = {}
    mask_kw = dict(TRAIN_MASK, sparse_init="ERK", update_frequency=100)
    for plain in (False, True):
        model, state, tc, mc, lr, batches = train_setup(
            batch, torch.bfloat16, mask_kw, snip=False)
        step = make_train_step(model, tc, mc, lr, plain=plain)
        gen = torch.Generator(device="cuda").manual_seed(3)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: step(state, batches[0], gen),
                     *((3, 1, 3) if plain else (5, 2, 5)))
        out["plain" if plain else "kernels"] = (
            ms, torch.cuda.max_memory_allocated() / 2**30)
        del model, state, step, batches
        torch.cuda.empty_cache()
    (k_ms, k_gb), (p_ms, p_gb) = out["kernels"], out["plain"]
    print(f"[train_timing] bf16 train step bs{batch}: kernels {k_ms:.3f} ms "
          f"({batch / k_ms * 1e3:.1f} img/s, peak {k_gb:.2f} GiB); plain "
          f"versions {p_ms:.3f} ms ({batch / p_ms * 1e3:.1f} img/s, peak "
          f"{p_gb:.2f} GiB)", flush=True)
    return k_ms


def erf_args(weights, size=ERF_SIZE):
    """The ERF CLI's flags for the flagship with the given weights."""
    return ["--model", "SLaK_tiny", "--kernel_size",
            *map(str, MODEL_KW["kernel_size"]), "--width_factor",
            str(MODEL_KW["width_factor"]), "--weights", weights,
            "--input_size", str(size)]


def phase_erf():
    """The ERF analysis through its CLI (``visualize_erf.main``): the
    flagship with random weights from a seed (a checkpoint written here,
    read through ``--weights``), fp32, 1024^2, ERF_IMAGES images with the
    launch counters set to 0 just before and read just after; then one
    image on each route, maps compared. Then one eval-mode backward with
    every parameter requiring a gradient (bf16, 224^2), kernel route vs
    plain route. Returns (the ERF run's counts, ms an image on the kernel
    route and on the plain route)."""
    import tempfile
    import numpy as np
    import torch
    from slak_tpu_torch.analysis import visualize_erf as V
    from slak_tpu_torch.models import create_model
    os.makedirs(OUT_DIR, exist_ok=True)
    model = create_model("SLaK_tiny", device="cpu", seed=0, **MODEL_KW)
    randomize(model, 1)
    tmp = tempfile.TemporaryDirectory()
    wpath = os.path.join(tmp.name, "erf_weights.pth")
    torch.save({"model": model.state_dict()}, wpath)
    cfg = model.cfg
    n_blocks = sum(cfg.depths)
    narrow = sum(d for d, c in zip(cfg.depths, cfg.widened_dims) if c <= 256)
    torch.cuda.synchronize()
    reset_counts()
    run = V.main(erf_args(wpath) + ["--num_images", str(ERF_IMAGES),
                                    "--save", os.path.join(OUT_DIR,
                                                           "erf.npy")])
    torch.cuda.synchronize()
    counts = read_counts()
    # fp32: every K1 launch (forward and dgrad) on the fp32 band kernel,
    # none on the bf16 one
    want = {"dwconv": 4 * n_blocks * ERF_IMAGES, "dwconv_stats": 0,
            "dwconv_band": 0, "dwconv_toeplitz": 0,
            "dwconv_tf32": 4 * n_blocks * ERF_IMAGES, "dwconv_stats_band": 0,
            "dwconv_stats_toeplitz": 0,
            "dwconv_wgrad": 0, "dwconv_wgrad_band": 0,
            "fused_mlp": n_blocks * ERF_IMAGES,
            "fused_mlp_tf32": n_blocks * ERF_IMAGES,
            "mlp_bwd": narrow * ERF_IMAGES,
            "mlp_bwd_wide": (n_blocks - narrow) * ERF_IMAGES,
            "mlp_bwd_dy_only": narrow * ERF_IMAGES,
            "mlp_bwd_wide_dy_only": (n_blocks - narrow) * ERF_IMAGES}
    print(f"[erf] {ERF_IMAGES} fp32 images at {ERF_SIZE}^2: launches "
          f"{counts} (per image: K1 {2 * n_blocks} forward + {2 * n_blocks} "
          f"dgrad, K2/K3 {n_blocks}, all on their 3xTF32 routes, K8 {narrow}, "
          f"K9 {n_blocks - narrow}, K8 and K9 in dy-only mode)", flush=True)
    _check(counts == want, f"ERF launch counts {counts}, want {want}")
    data = run["data"]
    c = ERF_SIZE // 2
    # erf_contribution drops a map that is not finite: every image's must
    # have gone into the average
    _check(run["used"] == ERF_IMAGES,
           f"only {run['used']} of {ERF_IMAGES} ERF maps were finite")
    _check(data.shape == (ERF_SIZE, ERF_SIZE) and bool(np.isfinite(data).all())
           and data.max() > 0 and data[c, c] > data[0, 0],
           f"ERF map bad: shape {data.shape}, max {data.max()}, centre "
           f"{data[c, c]}, corner {data[0, 0]}")
    one = {}
    for plain in (False, True):
        one[plain] = V.main(erf_args(wpath) + [
            "--num_images", "1", *(["--plain"] if plain else []),
            "--save", os.path.join(tmp.name, f"erf_one_{int(plain)}.npy")])
        _check(one[plain]["used"] == 1,
               f"the {'plain' if plain else 'kernel'} route's ERF map is "
               f"not finite")
    tmp.cleanup()
    d, r = rel_err(torch.from_numpy(one[False]["data"]),
                   torch.from_numpy(one[True]["data"]))
    sides = {route: {t: v and v["side"] for t, v in one[pl]["ratios"].items()}
             for route, pl in (("kernels", False), ("plain", True))}
    ms_k = float(np.median(run["seconds"])) * 1e3
    ms_p = one[True]["seconds"][0] * 1e3
    print(f"[erf] one image, kernel route vs plain route: max abs "
          f"{d:.4g}, rel {r:.4g} (tol {TOL_ERF_MAP}); analyze_erf sides "
          f"{json.dumps(sides)}; ms an image: kernels {ms_k:.3f} (median of "
          f"{ERF_IMAGES}), plain {ms_p:.3f}", flush=True)
    _check(r <= TOL_ERF_MAP, f"ERF map rel err {r:.3g} > {TOL_ERF_MAP}")

    # eval-mode differentiation with every parameter requiring a gradient
    model = model.to("cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(ERF_GRAD_BATCH, 3, 224, 224, generator=g,
                    device="cuda").to(torch.bfloat16)
    proj = torch.randn(ERF_GRAD_BATCH, cfg.widened_dims[-1], generator=g,
                       device="cuda")
    grads = {}
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        reset_counts()
        feats = model.forward_features(x, plain=plain)
        (feats.float() * proj).sum().backward()
        torch.cuda.synchronize()
        if not plain:
            got = read_counts()
            # bf16: K1 forward and dgrad on stage 4 (7x7) on K6's
            # Toeplitz kernel, the others and the weight gradient on their
            # band kernels
            k6 = k6_convs(cfg, 4)
            want = {"dwconv": 4 * n_blocks, "dwconv_stats": 0,
                    "dwconv_band": 4 * n_blocks - k6,
                    "dwconv_toeplitz": k6, "dwconv_tf32": 0,
                    "dwconv_stats_band": 0, "dwconv_stats_toeplitz": 0,
                    "dwconv_wgrad": 2 * n_blocks,
                    "dwconv_wgrad_band": 2 * n_blocks, "fused_mlp": n_blocks,
                    "fused_mlp_tf32": 0, "mlp_bwd": narrow,
                    "mlp_bwd_wide": n_blocks - narrow,
                    "mlp_bwd_dy_only": 0, "mlp_bwd_wide_dy_only": 0}
            _check(got == want, f"eval-grad launch counts {got}, want {want}")
        grads[plain] = {n: p.grad.float().clone()
                        for n, p in model.named_parameters()
                        if p.grad is not None}
    tol = TOL_STEP["bfloat16"]["grad"]
    missing = [n for n, _ in model.named_parameters() if n not in grads[False]]
    _check(set(grads[False]) == set(grads[True])
           and all(n.startswith("head.") for n in missing),
           f"parameters without a gradient besides the head's: {missing}")
    ge = {n: ((grads[False][n] - gp).norm() / gp.norm().clamp(min=1e-30)
              ).item() for n, gp in grads[True].items()}
    worst = max(ge, key=ge.get)
    print(f"[erf] eval-mode backward, bf16 batch {ERF_GRAD_BATCH} at 224^2, "
          f"{len(ge)} parameter gradients, kernels vs plain: rel norm err "
          f"max {ge[worst]:.3g} ({worst}), median "
          f"{statistics.median(ge.values()):.3g} (tol {tol}); launches "
          f"{got}", flush=True)
    _check(ge[worst] <= tol, f"eval grad {worst} rel err {ge[worst]:.3g}")
    del model, x, grads
    torch.cuda.empty_cache()
    return counts, ms_k, ms_p


def _profile_rows(prof):
    """Device-side rows only (the kernels; the aten ops above them would
    count the same time again), longest first."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    rows = [e for e in prof.key_averages() if dev_us(e) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows.sort(key=dev_us, reverse=True)
    return rows, dev_us


# kernel name -> share of the device time: the port's kernels by source,
# then what stock PyTorch runs (first match wins: the fp32 products'
# kernels before mlp.cu's "gemm_kernel<", mlp_bwd.cu's kernels before the
# wgrad group's "wgrad_" and the GEMM group's "gemm")
_GROUPS = (("tf32_gemm.cuh (fp32 K2/K3, K8/K9)", ("tf32_gemm_kernel",
                                                  "split_kernel")),
           ("mlp_bwd.cu (K8/K9)", ("bwd_gemm_kernel", "wide_prep_kernel",
                                   "wide_lnb_kernel", "wide_simt_kernel",
                                   "mlp_bwd_gemm_f32", "dgamma_kernel",
                                   "sum_chunks", "sum_partials")),
           ("dwconv2d.cu (K6)", ("dwconv2d_",)),
           ("dwconv.cu (K1/K4)", ("dwconv_kernel", "dwconv_tiled",
                                  "dwconv_band", "dwconv_stats_reduce")),
           ("dwconv_wgrad.cu (K5/K7)", ("wgrad_",)),
           ("mlp.cu (K2/K3)", ("mlp_fused_kernel", "gemm_kernel<",
                               "ln_bf16_kernel", "simt_ln_kernel",
                               "simt_out_kernel")),
           ("GEMM (cuBLAS/CUTLASS)", ("gemm", "cutlass")),
           ("stock conv (cuDNN/ATen)", ("conv_depthwise", "cudnn",
                                        "implicit_convolve", "nchwToNhwc",
                                        "nhwcToNchw")),
           ("reductions", ("reduce_kernel",)),
           ("elementwise, copies, foreach", ("elementwise", "copy",
                                              "multi_tensor", "foreach")))


def print_profile(tag, prof, wall_ms, top):
    """Busy time, idle share, the time by group and the `top` kernels."""
    rows, dev_us = _profile_rows(prof)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    print(f"[profile] {tag}: wall {wall_ms:.3f} ms (under the profiler), "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.4f}")
    groups = {}
    for e in rows:
        name = next((g for g, keys in _GROUPS
                     if any(k in e.key for k in keys)), "other")
        groups[name] = groups.get(name, 0.0) + dev_us(e) / 1e3
    print("[profile]   by group (ms): " + json.dumps(
        {k: round(v, 3) for k, v in sorted(groups.items(),
                                           key=lambda kv: -kv[1])}))
    for e in rows[:top]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")


def phase_profile_train(batch):
    """One bf16 train step under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from slak_tpu_torch.train.engine import make_train_step
    model, state, tc, mc, lr, batches = train_setup(
        batch, torch.bfloat16, dict(TRAIN_MASK, sparse_init="ERK",
                                    update_frequency=100), snip=False)
    step = make_train_step(model, tc, mc, lr)
    for _ in range(2):
        step(state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batches[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_profile(f"bf16 train step bs{batch}", prof, wall_ms, 20)
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, "train_trace.json"))


def phase_profile(model, batch):
    """One bf16 forward under torch.profiler: device time by kernel and the
    share of the forward's wall time the card was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from slak_tpu_torch.models import apply
    x = torch.randn(batch, 224, 224, 3, device="cuda").to(torch.bfloat16)
    for _ in range(2):
        apply(model, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        apply(model, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_profile(f"bf16 forward bs{batch}", prof, wall_ms, 12)
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, "forward_trace.json"))

def probe_macs(N, C, H, W, K, s, ntaps) -> int:
    """MACs of the (K, s) conv with only its first ``ntaps`` tap columns,
    taps that only read padding skipped."""
    p = K // 2
    rows = sum(min(K, H + p - i) - max(0, p - i) for i in range(H))
    cols = sum(1 for w in range(W) for j in range(ntaps)
               if 0 <= w + j - s // 2 < W)
    return N * C * rows * cols


def pair_route_of(x, w1, w2, tmode, xq, sum_out) -> str:
    """The kernel ``ops/dwpair.py`` launches for this K10 call: "band" or
    "simt"."""
    from slak_tpu_torch.ops import dwpair as K10
    return "band" if K10.pair_band_route(x, w1, w2, tmode, sum_out) \
        else "simt"


def pair_geometry(N, C, H, W, K) -> dict:
    """The band kernel's launch geometry as its host code computes it;
    fails unless it is ``pair_band_geometry``'s."""
    from slak_tpu_torch.ops import dwpair as K10
    got = K10.pair_band_kernel_geometry(N, C, H, W, K)
    want = K10.pair_band_geometry(N, C, H, W, K)
    _check(all(want[k] == v for k, v in got.items()),
           f"dwpair band {(N, C, H, W)} taps {K}: kernel geometry {got}, "
           f"pair_band_geometry {want}")
    return got


def check_dwpair_edges(phase: str):
    """bf16 K10's dual stage launch (dualboth, raw) at DW_EDGES_PAIR
    against its plain version, each on the route it names; the band route
    also the same bits twice and the kernel's geometry that of
    ``pair_band_geometry``. Prints a row a map."""
    import torch
    from slak_tpu_torch.ops import dwpair as K10
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(72)
    bf, dn = torch.bfloat16, "bfloat16"
    for N, C, H, W, K, route in DW_EDGES_PAIR:
        x = torch.randn(N, C, H, W, generator=g, device=dev).to(bf)
        xq = x.transpose(2, 3).contiguous()
        w1, w2 = ((torch.randn(C, *t, generator=g, device=dev) * 0.05
                   ).to(bf).float() for t in ((K, 5), (5, K)))
        raw = (w1, w2, "dualboth", xq, False)
        tag = f"dwpair {N}x{C}x{H}x{W} taps {K}"
        got_route = pair_route_of(x, *raw)
        _check(got_route == route, f"{tag}: route {got_route}, want {route}")
        got, want = K10.dwpair(x, *raw), K10.dwpair_plain(x, *raw)
        torch.cuda.synchronize()
        d = r = 0.0
        for a, b in zip(got, want):
            da, ra = rel_err(a, b)
            d, r = max(d, da), max(r, ra)
        _check(r <= TOL_KERNEL[dn], f"{tag}: rel err {r:.3g}")
        row = dict(shape=[N, C, H, W], K=K, route=route, max_abs_err=d,
                   rel_err=r, tol=TOL_KERNEL[dn])
        if route == "band":
            same_bits_twice(lambda: K10.dwpair(x, *raw), tag)
            row.update(MT=pair_geometry(N, C, H, W, K)["MT"],
                       pairs=W % 2 == 0, same_bits_twice=True)
        print(f"[{phase}] " + json.dumps(row), flush=True)
        del x, xq


def phase_dual_kernels(cfg, batch):
    """K10, K12, K11 and K13 against their plain versions at the four stage
    shapes, bf16 and fp32 at the main batch; K10's modes at 256^2 fp32.
    Returns bf16 totals for the JSON line: K10 and K12 per dual forward at
    batch ``batch``, K11 and K13 (all taps) one launch at each stage shape,
    K13's time by tap count, and the K11 against K1 A/B."""
    import torch
    import torch.nn.functional as F
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.ops import dwconv_stacked as K11
    from slak_tpu_torch.ops import dwpair as K10
    from slak_tpu_torch.ops import mlp as K2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(30)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
            "ops_ms")
    totals = {n: dict({k: 0.0 for k in keys}, err=0.0) for n in (
        "dwpair", "fused_mlp_dual", "dwconv_stacked", "dwconv_probe")}
    extra = {"probe_ms_by_ntaps": {}, "stacked_vs_k1": {}}

    def add(name, n, row, b_ms, o_ms):
        t = totals[name]
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            t[k] += n * (row[k] or 0.0)
        t["bytes_ms"] += n * b_ms
        t["ops_ms"] += n * o_ms
        t["err"] = max(t["err"], row["max_abs_err"])

    def check_all(tag, got, want, tol):
        pairs = list(zip(got, want)) if isinstance(got, tuple) else \
            [(got, want)]
        d_max = r_max = 0.0
        for a, b in pairs:
            d, r = rel_err(a, b)
            d_max, r_max = max(d_max, d), max(r_max, r)
        _check(r_max <= tol, f"{tag}: rel err {r_max:.3g} > {tol}")
        return d_max, r_max

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        item = torch.tensor([], dtype=dtype).element_size()
        bf16 = dtype == torch.bfloat16
        for i, C, H, K, s, depth in stage_shapes(cfg):
            x = torch.randn(batch, C, H, H, generator=g, device=dev
                            ).to(dtype)
            xq = x.transpose(2, 3).contiguous()
            w1 = (torch.randn(C, K, s, generator=g, device=dev) * 0.05
                  ).to(dtype).float()
            w2 = (torch.randn(C, s, K, generator=g, device=dev) * 0.05
                  ).to(dtype).float()
            wl1, wl2 = w1.to(dtype)[:, None], w2.to(dtype)[:, None]
            act = x.numel() * item
            macs = dwconv_macs(batch, C, H, H, K, s)

            # K10, every mode against its plain version
            errs, d_max = {}, 0.0
            for mode in PAIR_MODES:
                dual_in, dual_out = K10.MODES[mode]
                for sum_out in (True, False) if dual_out else (True,):
                    xm = xq if dual_in else None
                    d, r = check_all(
                        f"dwpair {mode} sum_out={sum_out} stage {i + 1} "
                        f"{dn}", K10.dwpair(x, w1, w2, mode, xm, sum_out),
                        K10.dwpair_plain(x, w1, w2, mode, xm, sum_out),
                        TOL_KERNEL[dn])
                    errs[mode + ("" if sum_out else "_raw")] = r
                    d_max = max(d_max, d)
            # the dual stage's launch (dualboth, raw): its route; on the
            # band route also at the other batches, the same bits twice and
            # the kernel's geometry that of pair_band_geometry
            raw = (w1, w2, "dualboth", xq, False)
            route = pair_route_of(x, *raw)
            _check(route == ("band" if bf16 else "simt"),
                   f"dwpair dualboth raw stage {i + 1} {dn}: route {route}")
            band = {}
            if route == "band":
                by_batch = {}
                for nb in DW_BATCHES:
                    xb, xqb = x[:nb].contiguous(), xq[:nb].contiguous()
                    _, by_batch[f"batch{nb}"] = check_all(
                        f"dwpair dualboth raw batch {nb} stage {i + 1} {dn}",
                        K10.dwpair(xb, w1, w2, "dualboth", xqb, False),
                        K10.dwpair_plain(xb, w1, w2, "dualboth", xqb, False),
                        TOL_KERNEL[dn])
                same_bits_twice(lambda: K10.dwpair(x, *raw),
                                f"dwpair band stage {i + 1}")
                band = dict(rel_err_by_batch=by_batch, same_bits_twice=True,
                            geometry=pair_geometry(batch, C, H, H, K))
            mode_ms = {m: time_ms(lambda m=m: K10.dwpair(
                x, w1, w2, m, xq if K10.MODES[m][0] else None))
                for m in PAIR_MODES}
            # x and xq read once, y1 and y2q written once
            b_ms, o_ms = bounds(4 * act + 8 * C * K * s, 4 * macs, dtype)
            row = dict(
                kernel="dwpair", dtype=dn, stage=i + 1, C=C, H=H,
                taps=[K, s], batch=batch, max_abs_err=d_max, rel_err=errs,
                tol=TOL_KERNEL[dn], mode="dualboth raw (the dual stage's)",
                route=route, **band,
                ms=time_ms(lambda: K10.dwpair(x, w1, w2, "dualboth", xq,
                                              False)),
                summed_mode_ms=mode_ms,
                plain_ms=time_ms(lambda: K10.dwpair_plain(
                    x, w1, w2, "dualboth", xq, False), 3, warmup=1),
                library_ms=time_ms(lambda: F.conv2d(
                    x, wl1, padding=(K // 2, s // 2), groups=C) + F.conv2d(
                    x, wl2, padding=(s // 2, K // 2), groups=C)),
                k1_pair_ms=time_ms(lambda: K1.conv_taps(x, [w1, w2])),
                bound_ms=max(b_ms, o_ms), bytes_ms=b_ms, ops_ms=o_ms,
                launches_per_forward=depth)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print("[dual_kernels] " + json.dumps(row), flush=True)
            if bf16:
                add("dwpair", depth, row, b_ms, o_ms)

            # K11 (the (K, s) branch): its route and counter, against its
            # plain version and (bf16) its mirror, the same bits twice, at
            # the other batches, its geometry the host code's
            route = K11.stacked_route(x, w1)
            _check(route == ("band" if bf16 else "simt"),
                   f"dwconv_stacked stage {i + 1} {dn}: route {route}")
            n0 = K11.stacked_band_launch_count
            got = K11.dwconv_stacked(x, w1)
            _check(K11.stacked_band_launch_count - n0 == int(bf16),
                   f"dwconv_stacked stage {i + 1} {dn}: "
                   f"stacked_band_launch_count moved by "
                   f"{K11.stacked_band_launch_count - n0}")
            d, r = check_all(f"dwconv_stacked stage {i + 1} {dn}", got,
                             K1.dwconv_plain(x, w1), TOL_KERNEL[dn])
            band = {}
            if bf16:
                dm = within_ulp(got, K11.dwconv_stacked_mirror(x, w1),
                                f"dwconv_stacked stage {i + 1} vs mirror")
                by_batch = {}
                for nb in DW_BATCHES:
                    xb = x[:nb].contiguous()
                    _, by_batch[f"batch{nb}"] = check_all(
                        f"dwconv_stacked batch {nb} stage {i + 1} {dn}",
                        K11.dwconv_stacked(xb, w1), K1.dwconv_plain(xb, w1),
                        TOL_KERNEL[dn])
                    same_bits_twice(lambda: K11.dwconv_stacked(xb, w1),
                                    f"dwconv_stacked batch {nb} stage {i + 1}")
                same_bits_twice(lambda: K11.dwconv_stacked(x, w1),
                                f"dwconv_stacked stage {i + 1}")
                band = dict(max_abs_vs_mirror=dm, rel_err_by_batch=by_batch,
                            same_bits_twice=True,
                            geometry=stacked_geometry(batch, C, H, H, K, s))
            b_ms, o_ms = bounds(2 * act + 4 * C * K * s, 2 * macs, dtype)
            row = dict(
                kernel="dwconv_stacked", dtype=dn, stage=i + 1, C=C, H=H,
                taps=[K, s], batch=batch, g=K11.stack_group(H, s),
                route=route, counter="stacked_band_launch_count" if bf16
                else "stacked_launch_count", max_abs_err=d, rel_err=r,
                tol=TOL_KERNEL[dn], **band,
                ms=time_ms(lambda: K11.dwconv_stacked(x, w1)),
                k1_band_ms=time_ms(lambda: K1.launch("band", x, w1))
                if bf16 else None,
                k1_ms=time_ms(lambda: K1.dwconv(x, w1)),
                plain_ms=time_ms(lambda: K1.dwconv_plain(x, w1), 3,
                                 warmup=1),
                library_ms=time_ms(lambda: F.conv2d(
                    x, wl1, padding=(K // 2, s // 2), groups=C)),
                bound_ms=max(b_ms, o_ms))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print("[dual_kernels] " + json.dumps(row), flush=True)
            if bf16:
                add("dwconv_stacked", 1, row, b_ms, o_ms)
                extra["stacked_vs_k1"][f"stage{i + 1}"] = dict(
                    g=row["g"], stacked_ms=row["ms"],
                    k1_band_ms=row["k1_band_ms"], bound_ms=row["bound_ms"],
                    bound_share=row["bound_share"])

            # K13 at 0, 1 and all tap columns: its route and counter; the
            # copy exact, all taps (bf16) the bits of K1's band launch, one
            # tap (bf16) its band mirror's
            proute = K1.probe_route(x, w1, s)
            _check(proute == ("band" if bf16 else "tiled"),
                   f"dwconv_probe stage {i + 1} {dn}: route {proute}")
            for nt in (0, 1, s):
                tag = f"dwconv_probe ntaps={nt} stage {i + 1} {dn}"
                n0 = K1.probe_band_launch_count
                got = K1.dwconv_probe(x, w1, nt)
                _check(K1.probe_band_launch_count - n0 == int(bf16),
                       f"{tag}: probe_band_launch_count moved by "
                       f"{K1.probe_band_launch_count - n0}")
                plain = K1.dwconv_probe_plain(x, w1, nt)
                d, r = check_all(tag, got, plain, TOL_KERNEL[dn])
                checks = {}
                if nt == 0:
                    _check(torch.equal(got, plain), f"{tag}: copy not exact")
                    checks["exact_copy"] = True
                elif nt == s and bf16:
                    _check(torch.equal(got, K1.launch("band", x, w1)),
                           f"{tag}: not the bits of K1's band launch")
                    checks["same_bits_as_band_launch"] = True
                elif bf16:
                    checks["max_abs_vs_mirror"] = within_ulp(
                        got, K1.dwconv_probe_band_mirror(x, w1, nt),
                        f"{tag} vs mirror")
                if nt == 0:
                    def lib():
                        return F.pad(x, (s // 2, -(s // 2)))
                else:
                    wl = wl1[..., :nt]

                    def lib():
                        return F.conv2d(x, wl, padding=(K // 2, s // 2),
                                        groups=C)[..., :H]
                b_ms, o_ms = bounds(2 * act + 4 * C * K * nt,
                                    2 * probe_macs(batch, C, H, H, K, s, nt),
                                    dtype)
                row = dict(
                    kernel="dwconv_probe", dtype=dn, stage=i + 1, C=C, H=H,
                    taps=[K, s], ntaps=nt, batch=batch, route=proute,
                    counter="probe_band_launch_count" if bf16
                    else "probe_launch_count", max_abs_err=d, rel_err=r,
                    tol=TOL_KERNEL[dn], **checks,
                    ms=time_ms(lambda: K1.dwconv_probe(x, w1, nt)),
                    plain_ms=time_ms(lambda: K1.dwconv_probe_plain(
                        x, w1, nt), 3, warmup=1),
                    library_ms=time_ms(lib), bound_ms=max(b_ms, o_ms))
                row["bound_share"] = row["bound_ms"] / row["ms"]
                print("[dual_kernels] " + json.dumps(row), flush=True)
                if bf16:
                    extra["probe_ms_by_ntaps"].setdefault(
                        f"ntaps{nt}", 0.0)
                    extra["probe_ms_by_ntaps"][f"ntaps{nt}"] += row["ms"]
                    if nt == s:
                        add("dwconv_probe", 1, row, b_ms, o_ms)
            del x, xq

            # K12 with and without the q output
            F4 = 4 * C
            y1 = torch.randn(batch, C, H, H, generator=g, device=dev
                             ).to(dtype)
            y2 = torch.randn(batch, C, H, H, generator=g, device=dev
                             ).to(dtype)
            res = torch.randn(batch, C, H, H, generator=g, device=dev
                              ).to(dtype)
            pk = random_pack(C, g, dtype)
            d_max, errs = 0.0, {}
            for nb in (batch,) + RAGGED:         # and the ragged batches
                for emit in (True, False):
                    args = (y1[:nb], y2[:nb], res[:nb], pk, emit)
                    got = K2.fused_mlp_dual(*args)
                    want = K2.fused_mlp_dual_plain(*args)
                    d, r = check_all(
                        f"fused_mlp_dual emit_q={emit} batch {nb} stage "
                        f"{i + 1} {dn}", got if emit else got[0],
                        want if emit else want[0], TOL_MLP[dn])
                    errs[f"emit_q={emit}" + (
                        "" if nb == batch else f" batch{nb}")] = r
                    if nb == batch:
                        d_max = max(d_max, d)
            ln_s, ln_b, b2, gam, pre = pk.vec
            w1d = pk.w1[:F4, :C].contiguous()
            w2d = pk.w2[:C, :F4].contiguous()
            b1d, b2d = pk.b1[:F4].to(dtype), b2.to(dtype)
            lnd = (ln_s.to(dtype), ln_b.to(dtype))
            gd, pd = gam.to(dtype), pre.to(dtype)

            def unfused():
                z = (y1 + y2.transpose(2, 3) + pd[:, None, None]
                     ).permute(0, 2, 3, 1)
                z = F.layer_norm(z, (C,), *lnd, eps=1e-6)
                z = F.linear(F.gelu(F.linear(z, w1d, b1d)), w2d, b2d)
                out = res + (gd * z).permute(0, 3, 1, 2)
                return out, out.transpose(2, 3).contiguous()
            T = batch * H * H
            row = dict(
                kernel="fused_mlp_dual", dtype=dn, stage=i + 1, C=C,
                batch=batch, max_abs_err=d_max, rel_err=errs,
                tol=TOL_MLP[dn],
                ms=time_ms(lambda: K2.fused_mlp_dual(y1, y2, res, pk, True)),
                ms_without_q=time_ms(lambda: K2.fused_mlp_dual(
                    y1, y2, res, pk, False)),
                k2_ms=time_ms(lambda: K2.fused_mlp(y1, res, pk, 1)),
                plain_ms=time_ms(lambda: K2.fused_mlp_dual_plain(
                    y1, y2, res, pk, True), 3, warmup=1),
                library_ms=None, unfused_torch_ms=time_ms(unfused))
            b_q, o_q = bounds(5 * T * C * item + 2 * C * F4 * item,
                              4 * T * C * F4, dtype)
            b_n, o_n = bounds(4 * T * C * item + 2 * C * F4 * item,
                              4 * T * C * F4, dtype)
            row.update(bound_ms=max(b_q, o_q),
                       bound_ms_without_q=max(b_n, o_n),
                       launches_per_forward=depth,
                       **rate(4 * T * C * F4, row["ms"], max(b_q, o_q)))
            print("[dual_kernels] " + json.dumps(row), flush=True)
            if bf16:
                t = totals["fused_mlp_dual"]
                t["ms"] += (depth - 1) * row["ms"] + row["ms_without_q"]
                t["plain_ms"] += depth * row["plain_ms"]
                t["library_ms"] += depth * row["unfused_torch_ms"]
                t["bound_ms"] += ((depth - 1) * row["bound_ms"]
                                  + row["bound_ms_without_q"])
                t["bytes_ms"] += (depth - 1) * b_q + b_n
                t["ops_ms"] += (depth - 1) * o_q + o_n
                t["err"] = max(t["err"], d_max)
            del y1, y2, res, pk
            torch.cuda.empty_cache()

    check_dwpair_edges("dual_kernels")
    # K10 on maps larger than a block's shared memory: row tiles
    C, K, s = cfg.widened_dims[0], cfg.stage_kernel(0), cfg.small_kernel
    x = torch.randn(2, C, PAIR_BIG, PAIR_BIG, generator=g, device=dev)
    w1 = torch.randn(C, K, s, generator=g, device=dev) * 0.05
    w2 = torch.randn(C, s, K, generator=g, device=dev) * 0.05
    errs = {}
    for mode in PAIR_MODES:
        for sum_out in (True, False) if K10.MODES[mode][1] else (True,):
            _, errs[mode + ("" if sum_out else "_raw")] = check_all(
                f"dwpair {mode} sum_out={sum_out} {PAIR_BIG}^2 float32",
                K10.dwpair(x, w1, w2, mode, sum_out=sum_out),
                K10.dwpair_plain(x, w1, w2, mode, sum_out=sum_out),
                TOL_KERNEL["float32"])
    print("[dual_kernels] " + json.dumps(dict(
        kernel="dwpair", dtype="float32", C=C, H=PAIR_BIG, taps=[K, s],
        batch=2, rel_err=errs, tol=TOL_KERNEL["float32"],
        kernel_mode_ms=time_ms(lambda: K10.dwpair(x, w1, w2, "kernel")),
        k1_pair_ms=time_ms(lambda: K1.conv_taps(x, [w1, w2])))), flush=True)
    del x
    torch.cuda.empty_cache()
    print("[dual_kernels] bf16 totals: " + json.dumps(
        {n: {k: round(v, 4) for k, v in t.items()}
         for n, t in totals.items()}), flush=True)
    return totals, extra


def phase_dual(batch):
    """The dual eval path; returns the launch counts of its bf16 run."""
    import dataclasses
    import torch
    from slak_tpu_torch.models import apply, create_model
    from slak_tpu_torch.train.engine import make_eval_step
    model = create_model("SLaK_tiny", dtype=torch.bfloat16, seed=0,
                         eval_layout="dual", **MODEL_KW)
    randomize(model, 1)
    n_blocks = sum(model.cfg.depths)
    cfg = model.cfg
    g = torch.Generator().manual_seed(2)
    batches = [(torch.randn(batch, 224, 224, 3, generator=g),
                torch.randint(0, 1000, (batch,), generator=g))
               for _ in range(N_BATCHES)]
    counts = None
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        step = make_eval_step(model, dtype)
        step(batches[0])                     # pack weights, warm up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        outs = [step(b) for b in batches]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = read_dual_counts()
        want = {"dwpair": n_blocks * N_BATCHES,
                "dwpair_band": n_blocks * N_BATCHES
                if dtype == torch.bfloat16 else 0,
                "fused_mlp_dual": n_blocks * N_BATCHES,
                "dwconv_stacked": 0, "dwconv_stacked_band": 0,
                "dwconv_probe": 0, "dwconv_probe_band": 0, "dwconv": 0,
                "fused_mlp": 0}
        if dtype == torch.bfloat16:
            counts = got
        print(f"[dual] {dn}: {N_BATCHES} batches of {batch} in {sec:.3f} s;"
              f" launches {got}", flush=True)
        _check(got == want, f"dual {dn} launch counts {got}, want {want}")
        for j, (o, (x, _)) in enumerate(zip(outs, batches)):
            lg = o["logits"]
            _check(lg.shape == (batch, 1000) and bool(
                torch.isfinite(lg).all()), f"dual {dn} logits bad")
            xd = x.to("cuda", dtype)
            plain = apply(model, xd, plain=True)
            model.cfg = dataclasses.replace(cfg, eval_layout="auto")
            split = apply(model, xd)
            model.cfg = cfg
            d, r = rel_err(lg, plain)
            ds, rs = rel_err(lg, split)
            top1 = (lg.argmax(-1) == split.argmax(-1)).float().mean().item()
            print(f"[dual] {dn} batch {j}: loss {o['loss'].item():.6f} | vs "
                  f"plain dual route: max abs {d:.4g}, rel {r:.4g}; vs split"
                  f" route: max abs {ds:.4g}, rel {rs:.4g} (tol "
                  f"{TOL_LOGITS[dn]}), top-1 agreement {top1:.4f}",
                  flush=True)
            _check(r <= TOL_LOGITS[dn], f"dual {dn} vs plain: rel {r:.3g}")
            _check(rs <= TOL_LOGITS[dn], f"dual {dn} vs split: rel {rs:.3g}")
    return counts


def phase_dual_timing(batch):
    """bf16 eval at ``batch``: the dual route against the split route
    (tools/probe_eval_ab.py) and the dual route's plain versions."""
    import torch
    from slak_tpu_torch.models import apply, create_model
    from slak_tpu_torch.tools import probe_eval_ab
    model = create_model("SLaK_tiny", dtype=torch.bfloat16, seed=0,
                         eval_layout="dual", **MODEL_KW)
    rows = probe_eval_ab.run(batch, model=model)
    x = torch.randn(batch, 224, 224, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5)
                    ).to(torch.bfloat16)
    plain_ms = time_ms(lambda: apply(model, x, plain=True), 3, warmup=1)
    for r in rows:
        print("[dual_timing] " + json.dumps(r), flush=True)
    by = {r["eval_layout"]: r for r in rows}
    print(f"[dual_timing] bf16 eval bs{batch}: dual {by['dual']['ms']:.3f} "
          f"ms ({by['dual']['img_per_s']:.1f} img/s), split "
          f"{by['split']['ms']:.3f} ms ({by['split']['img_per_s']:.1f} "
          f"img/s), dual plain versions {plain_ms:.3f} ms "
          f"({batch / plain_ms * 1e3:.1f} img/s)", flush=True)
    del model
    torch.cuda.empty_cache()
    return by


def phase_mlp_ab(cfg, base: str):
    """The fused MLP of another checkout (``base``: the parent commit
    unpacked into a git-ignored directory) against this tree's, in one
    process, in turns base, change, change, base: K2/K3 (NCHW bf16) and K12
    (with oq) at the four stage shapes at the main batch, K2 in fp32 at the
    1024^2 ERF shapes, the bs256 bf16 eval forward, and one fp32 ERF image
    at 1024^2 (the flagship's input gradient with frozen weights and its
    map; the maps of the two trees within TOL_ERF_MAP), timed with CUDA
    events and, as the device's busy time (its kernels' summed durations
    under torch.profiler), once a turn: the image syncs with the host, so
    where the host is slower than the device the events read the host's
    time. The base's
    ``csrc/mlp.cu`` is built here; both libraries serve the same wrappers
    (``ops/mlp.py``), swapped by their entry points. Returns the rows."""
    import torch
    from slak_tpu_torch.analysis.erf import get_input_grad
    from slak_tpu_torch.models import apply, create_model
    from slak_tpu_torch.ops import mlp as K2
    routes = {"base": K2.bind(build_base(base, "mlp", "mlp_ab")),
              "change": K2._entries()}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(40)
    cases = []                               # (name, fn)
    for i, C, H, _, _, _ in stage_shapes(cfg):
        y, y2, res = (torch.randn(MAIN_BATCH, C, H, H, generator=g,
                                  device=dev).to(torch.bfloat16)
                      for _ in range(3))
        pk = random_pack(C, g, torch.bfloat16)
        cases.append((f"k2_stage{i + 1}_ms",
                      lambda y=y, res=res, pk=pk: K2.fused_mlp(y, res, pk, 1)))
        cases.append((f"k12_stage{i + 1}_ms",
                      lambda y=y, y2=y2, res=res, pk=pk: K2.fused_mlp_dual(
                          y, y2, res, pk, True)))
    for i, C, H, _, _, _ in stage_shapes(cfg, ERF_SIZE):
        y, res = (torch.randn(1, C, H, H, generator=g, device=dev)
                  for _ in range(2))
        pk = random_pack(C, g, torch.float32)
        cases.append((f"k2_fp32_{ERF_SIZE}_stage{i + 1}_ms",
                      lambda y=y, res=res, pk=pk: K2.fused_mlp(y, res, pk, 1)))
    model = create_model("SLaK_tiny", dtype=torch.bfloat16, seed=0,
                         **MODEL_KW)
    x = torch.randn(TIMING_BATCH, 224, 224, 3, device=dev, generator=g
                    ).to(torch.bfloat16)
    cases.append(("eval_bs%d_ms" % TIMING_BATCH, lambda: apply(model, x)))
    order = ("base", "change", "change", "base")
    rows = {name: [] for name, _ in cases}
    own = K2._entries
    try:
        for route in order:
            K2._entries = lambda e=routes[route]: e
            for name, fn in cases:
                rows[name].append(time_ms(fn))
    finally:
        K2._entries = own
    del model, x, cases
    torch.cuda.empty_cache()
    # one ERF image: the eval forward at 1024^2, fp32, and its input
    # gradient, the parameters frozen (K2/K3 forward, K8/K9 dy-only)
    model = create_model("SLaK_tiny", seed=0, **MODEL_KW)
    randomize(model, 1)
    model.eval().requires_grad_(False)
    image = torch.randn(1, ERF_SIZE, ERF_SIZE, 3, generator=g, device=dev)

    def feature_fn(x):
        stages = model.forward_features(x.permute(0, 3, 1, 2).contiguous(),
                                        return_stages=True)
        return stages[-1].permute(0, 2, 3, 1)
    erf_ms, erf_busy, maps = [], [], {}
    try:
        for route in order:
            K2._entries = lambda e=routes[route]: e
            maps[route] = get_input_grad(feature_fn, image)
            erf_ms.append(time_ms(lambda: get_input_grad(feature_fn, image),
                                  2, 1, 3))
            erf_busy.append(busy_ms(lambda: get_input_grad(feature_fn,
                                                           image)))
    finally:
        K2._entries = own
    d, r = rel_err(torch.from_numpy(maps["change"]),
                   torch.from_numpy(maps["base"]))
    print(f"[mlp_ab] ERF map, change vs base: max abs {d:.4g}, rel "
          f"{r:.4g} (tol {TOL_ERF_MAP})", flush=True)
    _check(r <= TOL_ERF_MAP, f"mlp_ab: ERF map rel err {r:.3g}")
    rows["erf_image_%d_fp32_ms" % ERF_SIZE] = erf_ms
    rows["erf_image_%d_fp32_busy_ms" % ERF_SIZE] = erf_busy
    out = dict(order=order, **rows, eval_img_per_s=[
        TIMING_BATCH / ms * 1e3 for ms in rows["eval_bs%d_ms" % TIMING_BATCH]])
    for name, ms in rows.items():
        print(f"[mlp_ab] {name}: " + " / ".join(f"{v:.4f}" for v in ms)
              + "  (" + ", ".join(order) + ")", flush=True)
    print("[mlp_ab] " + json.dumps(out), flush=True)
    del model, image
    torch.cuda.empty_cache()
    return out


def busy_ms(fn):
    """The device's busy time of one call of fn: its kernels' summed
    durations under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, dev_us = _profile_rows(prof)
    return sum(dev_us(e) for e in rows) / 1e3


def build_base(base: str, name: str, tag: str):
    """``csrc/<name>.cu`` of another checkout (``base``: the parent commit
    unpacked into a git-ignored directory) built here with nvcc; returns
    the ctypes library."""
    import ctypes
    from slak_tpu_torch.ops import _build
    src = os.path.join(base, "slak_tpu_torch", "ops", "csrc", name + ".cu")
    _check(os.path.exists(src), f"{tag}: no {src}")
    so = os.path.join(_build.BUILD_DIR, "ab", f"lib{name}_base.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    t0 = time.perf_counter()
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                       capture_output=True, text=True)
    _check(r.returncode == 0, f"{tag}: {src} does not build:\n"
           f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
    print(f"[{tag}] {src} built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return ctypes.CDLL(so)


def base_module(base: str, name: str, py: str, loaders, tag: str):
    """The wrappers of another checkout: its ``csrc/<name>.cu`` built here
    (:func:`build_base`) and bound by that checkout's own ``ops/<py>.py``,
    loaded as a module of its own whose entry-point ``loaders`` (the
    lru-cached ones it has) are pointed at that library. Returns the
    module, whose wrappers launch the base's kernels."""
    import importlib.util
    from slak_tpu_torch.ops import _build
    lib = build_base(base, name, tag)
    spec = importlib.util.spec_from_file_location(
        "base_" + py, os.path.join(base, "slak_tpu_torch", "ops", py + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    own = _build.load
    _build.load = lambda n: lib if n == name else own(n)
    try:                                # bind (lru-cached) to the base's
        for loader in loaders:
            if hasattr(mod, loader):
                getattr(mod, loader)()
    finally:
        _build.load = own
    return mod


def phase_mlp_bwd_ab(cfg, base: str):
    """The MLP backward (K8, K9) of another checkout against this tree's,
    in one process, in turns base, change, change, base: K8 at stages 1-2
    and K9 at stages 3-4 in bf16 at the train batch; K8 and K9 in fp32 at
    the 1024^2 ERF shapes in the full mode and as the ERF calls them
    (``_dy`` rows: this tree's dy-only mode; a base without that mode
    runs its full sequence, as its ERF does); one fp32 ERF image at
    1024^2 (the flagship's input gradient with frozen weights, the base's
    K8/K9 swapped in); and the bf16 train step (base: the base's kernels
    and its TRAIN_WIDE_MLP_BWD, read from its models/slak.py (False where
    it has none); change: this tree's kernels and route). Then the route
    alone, this tree's kernels: the step with TRAIN_WIDE_MLP_BWD False
    (base) and True (change). Returns the rows."""
    import inspect
    import re
    import torch
    from slak_tpu_torch.analysis.erf import get_input_grad
    from slak_tpu_torch.models import create_model
    from slak_tpu_torch.models import slak as S
    from slak_tpu_torch.ops import mlp as K2
    from slak_tpu_torch.train.engine import make_train_step
    mod = base_module(base, "mlp_bwd", "mlp",
                      ("_bwd_entries", "_wide_entries"), "mlp_bwd_ab")
    with open(os.path.join(base, "slak_tpu_torch", "models", "slak.py")) as f:
        m = re.search(r"^TRAIN_WIDE_MLP_BWD = (True|False)", f.read(), re.M)
    base_wide = m is not None and m.group(1) == "True"

    def with_mode(fn):
        """fn as this tree's wrappers are called; a base wrapper without
        dy-only mode runs its full sequence."""
        if "dy_only" in inspect.signature(fn).parameters:
            return fn
        return lambda y, dout, pk, cd=-1, dy_only=False: fn(y, dout, pk, cd)
    kernels = {"base": (with_mode(mod.fused_mlp_bwd),
                        with_mode(mod.fused_mlp_bwd_wide)),
               "change": (K2.fused_mlp_bwd, K2.fused_mlp_bwd_wide)}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(50)
    cases = []                          # (name, wide, y, dout, pk, dy_only)
    for dt, size, batch in ((torch.bfloat16, 224, TRAIN_BATCH),
                            (torch.float32, ERF_SIZE, 1)):
        dn = str(dt).split(".")[1]
        for i, C, H, _, _, _ in stage_shapes(cfg, size):
            y = torch.randn(batch, C, H, H, generator=g, device=dev).to(dt)
            dout = (torch.randn(batch, C, H, H, generator=g, device=dev)
                    * 0.1).to(dt)
            wide = C > K2.BWD_C_MAX
            pk = random_pack(C, g, dt)
            name = f"{'k9' if wide else 'k8'}_{dn}_{size}_stage{i + 1}"
            cases.append((name + "_ms", wide, y, dout, pk, False))
            if dt == torch.float32:
                cases.append((name + "_dy_ms", wide, y, dout, pk, True))
    order = ("base", "change", "change", "base")
    rows = {c[0]: [] for c in cases}
    for route in order:
        k8, k9 = kernels[route]
        for name, wide, y, dout, pk, only in cases:
            fn = k9 if wide else k8
            rows[name].append(time_ms(
                lambda: fn(y, dout, pk, 1, dy_only=only)))
    del cases
    torch.cuda.empty_cache()
    # one ERF image: the eval forward at 1024^2, fp32, and its input
    # gradient, the parameters frozen
    model = create_model("SLaK_tiny", seed=0, **MODEL_KW)
    randomize(model, 1)
    model.eval().requires_grad_(False)
    image = torch.randn(1, ERF_SIZE, ERF_SIZE, 3, generator=g, device=dev)

    def feature_fn(x):
        stages = model.forward_features(x.permute(0, 3, 1, 2).contiguous(),
                                        return_stages=True)
        return stages[-1].permute(0, 2, 3, 1)
    own = (K2.fused_mlp_bwd, K2.fused_mlp_bwd_wide, S.TRAIN_WIDE_MLP_BWD)
    erf_ms, maps = [], {}
    try:
        for route in order:
            K2.fused_mlp_bwd, K2.fused_mlp_bwd_wide = kernels[route]
            maps[route] = get_input_grad(feature_fn, image)
            erf_ms.append(time_ms(lambda: get_input_grad(feature_fn, image),
                                  2, 1, 3))
    finally:
        K2.fused_mlp_bwd, K2.fused_mlp_bwd_wide = own[:2]
    d, r = rel_err(torch.from_numpy(maps["change"]),
                   torch.from_numpy(maps["base"]))
    print(f"[mlp_bwd_ab] ERF map, change vs base: max abs {d:.4g}, rel "
          f"{r:.4g} (tol {TOL_ERF_MAP})", flush=True)
    _check(r <= TOL_ERF_MAP, f"mlp_bwd_ab: ERF map rel err {r:.3g}")
    rows["erf_image_%d_fp32_ms" % ERF_SIZE] = erf_ms
    del model, image
    torch.cuda.empty_cache()
    model, state, tc, mc, lr, batches = train_setup(
        TRAIN_BATCH, torch.bfloat16, dict(TRAIN_MASK, sparse_init="ERK",
                                          update_frequency=100), snip=False)
    step = make_train_step(model, tc, mc, lr)
    gen = torch.Generator(device=dev).manual_seed(3)
    step_ms, route_ms = [], []
    try:
        for route in order:
            K2.fused_mlp_bwd, K2.fused_mlp_bwd_wide = kernels[route]
            S.TRAIN_WIDE_MLP_BWD = own[2] if route == "change" else base_wide
            step_ms.append(time_ms(lambda: step(state, batches[0], gen),
                                   5, 2, 3))
        K2.fused_mlp_bwd, K2.fused_mlp_bwd_wide = own[:2]
        for route in order:
            S.TRAIN_WIDE_MLP_BWD = route == "change"
            route_ms.append(time_ms(lambda: step(state, batches[0], gen),
                                    5, 2, 3))
    finally:
        K2.fused_mlp_bwd, K2.fused_mlp_bwd_wide, S.TRAIN_WIDE_MLP_BWD = own
    rows["train_step_bs%d_ms" % TRAIN_BATCH] = step_ms
    rows["train_step_route_false_true_ms"] = route_ms
    for name, ms in rows.items():
        print(f"[mlp_bwd_ab] {name}: " + " / ".join(f"{v:.4f}" for v in ms)
              + "  (" + ", ".join(order) + ")", flush=True)
    out = dict(order=order, train_wide_mlp_bwd=own[2],
               base_train_wide_mlp_bwd=base_wide, **rows)
    print("[mlp_bwd_ab] " + json.dumps(out), flush=True)
    del model, state, step, batches
    torch.cuda.empty_cache()
    return out


def phase_dwconv_ab(cfg, base: str):
    """K1/K4 of another checkout against this tree's, in one process, in
    turns base, change, change, base: the bf16 K1 pair (the second launch
    into the first's output) at each stage shape at the main batch and at
    the timing batch; the K4 pair and the K1 dgrad pair at the train
    batch (on stage 4's 7x7 maps all three at all three batches: the
    parent's band kernel against K6's Toeplitz kernel); the fp32 K1 pair
    and dgrad pair at the four 1024^2 ERF shapes (batch 1); then this
    tree's route A/B on the 7x7 maps, the same three at the same batches
    on the band kernel and on the Toeplitz kernel in turns band, toeplitz2d,
    toeplitz2d, band; then the bs256 bf16 eval forward, the bs128 bf16 train step
    and one fp32 ERF image at 1024^2 (the input gradient, weights frozen;
    on CUDA events and as the device's busy time; the two trees' maps
    within TOL_ERF_MAP), each with the tree's ``dwconv`` /
    ``dwconv_stats`` swapped into ``ops/dwconv.py`` (the model's convs,
    ``DwconvTaps`` and ``DwconvBnStats``, call them from there). Returns
    the rows."""
    import torch
    from slak_tpu_torch.analysis.erf import get_input_grad
    from slak_tpu_torch.models import apply, create_model
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.train.engine import make_train_step
    mod = base_module(base, "dwconv", "dwconv",
                      ("_entry", "_stats_entries", "_band_entries"),
                      "dwconv_ab")
    fns = {"base": (mod.dwconv, mod.dwconv_stats),
           "change": (K1.dwconv, K1.dwconv_stats)}
    own = fns["change"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(60)
    bf = torch.bfloat16
    cases = []                             # (name, fn(dwconv, dwconv_stats))
    k6_cases = []                          # stage 4: (name, fn(route))
    for i, C, H, K, s, _ in stage_shapes(cfg):
        ws = [(torch.randn(C, *t, generator=g, device=dev) * 0.05
               ).to(bf).float() for t in ((K, s), (s, K))]
        flipped = [w.flip(1, 2).contiguous() for w in ws]
        # K6's maps (stage 4): all three uses at all three batches
        k6 = H * H <= K1.P_MAX
        all3 = (MAIN_BATCH, TRAIN_BATCH, TIMING_BATCH)
        for batch in (all3 if k6 else (MAIN_BATCH, TIMING_BATCH)):
            x = torch.randn(batch, C, H, H, generator=g, device=dev).to(bf)
            cases.append((f"k1_pair_bs{batch}_stage{i + 1}_ms",
                          lambda f, x=x, ws=ws: f[0](x, ws[1],
                                                     out=f[0](x, ws[0]))))
            if k6:
                k6_cases.append((
                    f"k1_pair_bs{batch}_stage{i + 1}_ms",
                    lambda r, x=x, ws=ws: K1.launch(
                        r, x, ws[1], K1.launch(r, x, ws[0]))))
        for batch in (all3 if k6 else (TRAIN_BATCH,)):
            x, dy = (torch.randn(batch, C, H, H, generator=g, device=dev
                                 ).to(bf) for _ in range(2))
            cases.append((f"k4_pair_bs{batch}_stage{i + 1}_ms",
                          lambda f, x=x, ws=ws: [f[1](x, w) for w in ws]))
            cases.append((f"dgrad_pair_bs{batch}_stage{i + 1}_ms",
                          lambda f, dy=dy, fl=flipped: [f[0](dy, w)
                                                        for w in fl]))
            if k6:
                k6_cases.append((
                    f"k4_pair_bs{batch}_stage{i + 1}_ms",
                    lambda r, x=x, ws=ws: [K1.launch_stats(r, x, w)
                                           for w in ws]))
                k6_cases.append((
                    f"dgrad_pair_bs{batch}_stage{i + 1}_ms",
                    lambda r, dy=dy, fl=flipped: [K1.launch(r, dy, w)
                                                  for w in fl]))
    # the ERF's fp32 pairs at 1024^2 (batch 1): forward and dgrad
    for i, C, H, K, s, _ in stage_shapes(cfg, ERF_SIZE):
        ws = [torch.randn(C, *t, generator=g, device=dev) * 0.05
              for t in ((K, s), (s, K))]
        flipped = [w.flip(1, 2).contiguous() for w in ws]
        x, dy = (torch.randn(1, C, H, H, generator=g, device=dev)
                 for _ in range(2))
        cases.append((f"k1_pair_fp32_{ERF_SIZE}_stage{i + 1}_ms",
                      lambda f, x=x, ws=ws: f[0](x, ws[1],
                                                 out=f[0](x, ws[0]))))
        cases.append((f"dgrad_pair_fp32_{ERF_SIZE}_stage{i + 1}_ms",
                      lambda f, dy=dy, fl=flipped: f[0](dy, fl[1], out=f[0](
                          dy, fl[0]))))
    order = ("base", "change", "change", "base")
    rows = {name: [] for name, _ in cases}
    for route in order:
        for name, fn in cases:
            rows[name].append(time_ms(lambda: fn(fns[route])))
    # the route A/B on K6's maps within this tree: the band kernel against
    # the Toeplitz kernel at the same shapes, in turns
    k6_order = ("band", "toeplitz2d", "toeplitz2d", "band")
    k6_rows = {"route_" + name: [] for name, _ in k6_cases}
    for route in k6_order:
        for name, fn in k6_cases:
            k6_rows["route_" + name].append(time_ms(lambda: fn(route)))
    del cases, k6_cases
    torch.cuda.empty_cache()

    def timed(name, fn, *timing, busy=False):
        """fn timed in the turns of ``order``, each tree's wrappers swapped
        into ops/dwconv.py (``busy``: also the device's busy time, once a
        turn, under ``name`` with _busy_ms for _ms). Returns fn's last
        result of each tree."""
        rows[name] = []
        if busy:
            rows[name.replace("_ms", "_busy_ms")] = []
        last = {}
        try:
            for route in order:
                K1.dwconv, K1.dwconv_stats = fns[route]
                last[route] = fn()
                rows[name].append(time_ms(fn, *timing))
                if busy:
                    rows[name.replace("_ms", "_busy_ms")].append(busy_ms(fn))
        finally:
            K1.dwconv, K1.dwconv_stats = own
        return last
    model = create_model("SLaK_tiny", dtype=bf, seed=0, **MODEL_KW)
    x = torch.randn(TIMING_BATCH, 224, 224, 3, device=dev, generator=g
                    ).to(bf)
    timed(f"eval_bs{TIMING_BATCH}_ms", lambda: apply(model, x))
    del model, x
    torch.cuda.empty_cache()
    model, state, tc, mc, lr, batches = train_setup(
        TRAIN_BATCH, bf, dict(TRAIN_MASK, sparse_init="ERK",
                              update_frequency=100), snip=False)
    step = make_train_step(model, tc, mc, lr)
    gen = torch.Generator(device=dev).manual_seed(3)
    timed(f"train_step_bs{TRAIN_BATCH}_ms",
          lambda: step(state, batches[0], gen), 5, 2, 3)
    del model, state, step, batches
    torch.cuda.empty_cache()
    model = create_model("SLaK_tiny", seed=0, **MODEL_KW)
    randomize(model, 1)
    model.eval().requires_grad_(False)
    image = torch.randn(1, ERF_SIZE, ERF_SIZE, 3, generator=g, device=dev)

    def feature_fn(xx):
        stages = model.forward_features(xx.permute(0, 3, 1, 2).contiguous(),
                                        return_stages=True)
        return stages[-1].permute(0, 2, 3, 1)
    # the image syncs with the host: where the host is slower than the
    # device the events read the host's time, the busy time the device's
    maps = timed(f"erf_image_{ERF_SIZE}_fp32_ms",
                 lambda: get_input_grad(feature_fn, image), 2, 1, 3,
                 busy=True)
    d, r = rel_err(torch.from_numpy(maps["change"]),
                   torch.from_numpy(maps["base"]))
    print(f"[dwconv_ab] ERF map, change vs base: max abs {d:.4g}, rel "
          f"{r:.4g} (tol {TOL_ERF_MAP})", flush=True)
    _check(r <= TOL_ERF_MAP, f"dwconv_ab: ERF map rel err {r:.3g}")
    del model, image
    torch.cuda.empty_cache()
    for name, ms in rows.items():
        print(f"[dwconv_ab] {name}: " + " / ".join(f"{v:.4f}" for v in ms)
              + "  (" + ", ".join(order) + ")", flush=True)
    for name, ms in k6_rows.items():
        print(f"[dwconv_ab] {name}: " + " / ".join(f"{v:.4f}" for v in ms)
              + "  (" + ", ".join(k6_order) + ")", flush=True)
    out = dict(order=order, **rows, route_order=k6_order, **k6_rows)
    print("[dwconv_ab] " + json.dumps(out), flush=True)
    return out


def phase_wgrad_ab(cfg, base: str):
    """K5/K7 of another checkout against this tree's, in one process, in
    turns base, change, change, base: the bf16 weight gradient at each
    stage shape and orientation at the train batch, then the bs128 bf16
    train step with the tree's ``dwconv_wgrad`` swapped into
    ``ops/dwconv_wgrad.py`` (the conv backwards import it from there at
    call time). Also the per-step sum of the weight gradient's launches
    (each stage's depth times its pair). Returns the rows."""
    import torch
    from slak_tpu_torch.ops import dwconv_wgrad as KW
    from slak_tpu_torch.train.engine import make_train_step
    mod = base_module(base, "dwconv_wgrad", "dwconv_wgrad",
                      ("_entry", "_band_entries"), "wgrad_ab")
    fns = {"base": mod.dwconv_wgrad, "change": KW.dwconv_wgrad}
    own = fns["change"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(61)
    bf = torch.bfloat16
    cases = []                          # (name, stage depth, fn(wgrad))
    for i, C, H, K, s, depth in stage_shapes(cfg):
        x, dy = (torch.randn(TRAIN_BATCH, C, H, H, generator=g, device=dev
                             ).to(bf) for _ in range(2))
        for kh, kw in ((K, s), (s, K)):
            cases.append((f"wgrad_bs{TRAIN_BATCH}_stage{i + 1}_{kh}x{kw}_ms",
                          depth, lambda f, x=x, dy=dy, kh=kh, kw=kw:
                          f(x, dy, kh, kw)))
    order = ("base", "change", "change", "base")
    rows = {name: [] for name, _, _ in cases}
    for route in order:
        for name, _, fn in cases:
            rows[name].append(time_ms(lambda: fn(fns[route])))
    rows["wgrad_per_step_ms"] = [
        sum(depth * rows[name][t] for name, depth, _ in cases)
        for t in range(len(order))]
    del cases
    torch.cuda.empty_cache()
    model, state, tc, mc, lr, batches = train_setup(
        TRAIN_BATCH, bf, dict(TRAIN_MASK, sparse_init="ERK",
                              update_frequency=100), snip=False)
    step = make_train_step(model, tc, mc, lr)
    gen = torch.Generator(device=dev).manual_seed(3)
    name = f"train_step_bs{TRAIN_BATCH}_ms"
    rows[name] = []
    try:
        for route in order:
            KW.dwconv_wgrad = fns[route]
            rows[name].append(time_ms(lambda: step(state, batches[0], gen),
                                      5, 2, 3))
    finally:
        KW.dwconv_wgrad = own
    del model, state, step, batches
    torch.cuda.empty_cache()
    for name, ms in rows.items():
        print(f"[wgrad_ab] {name}: " + " / ".join(f"{v:.4f}" for v in ms)
              + "  (" + ", ".join(order) + ")", flush=True)
    out = dict(order=order, **rows)
    print("[wgrad_ab] " + json.dumps(out), flush=True)
    return out


def phase_dwpair_ab(cfg, base: str):
    """K10 of another checkout against this tree's, in one process, in
    turns base, change, change, base: the bf16 dual stage's launch
    (dualboth, the raw pair) at each stage shape at the main batch and at
    the timing batch (and their sum over one dual forward's 18 launches),
    then the bf16 dual forward at the timing batch and the default (split)
    forward, timed as ``tools/probe_eval_ab.py`` times them, each tree's
    ``dwpair`` swapped into ``models/slak.py``. The two trees' raw pairs
    agree within TOL_KERNEL. Returns the rows."""
    import torch
    from slak_tpu_torch.models import create_model
    from slak_tpu_torch.models import slak as S
    from slak_tpu_torch.ops import dwpair as K10
    from slak_tpu_torch.tools import probe_eval_ab
    mod = base_module(base, "dwpair", "dwpair", ("_entries", "_band_entries"),
                      "dwpair_ab")
    fns = {"base": mod.dwpair, "change": K10.dwpair}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(61)
    bf = torch.bfloat16
    cases, depths = [], {}
    for i, C, H, K, s, depth in stage_shapes(cfg):
        w1, w2 = ((torch.randn(C, *t, generator=g, device=dev) * 0.05
                   ).to(bf).float() for t in ((K, s), (s, K)))
        for batch in (MAIN_BATCH, TIMING_BATCH):
            x = torch.randn(batch, C, H, H, generator=g, device=dev).to(bf)
            xq = x.transpose(2, 3).contiguous()
            name = f"k10_bs{batch}_stage{i + 1}_ms"
            depths[name] = (batch, depth)

            def fn(f, x=x, xq=xq, w1=w1, w2=w2):
                return f(x, w1, w2, "dualboth", xq, False)
            cases.append((name, fn))
            d, r = 0.0, 0.0
            for a, b in zip(fn(fns["change"]), fn(fns["base"])):
                da, ra = rel_err(a, b)
                d, r = max(d, da), max(r, ra)
            _check(r <= TOL_KERNEL["bfloat16"], f"dwpair_ab {name}: change "
                   f"vs base rel err {r:.3g}")
    order = ("base", "change", "change", "base")
    rows = {name: [] for name, _ in cases}
    for route in order:
        for name, fn in cases:
            rows[name].append(time_ms(lambda: fn(fns[route])))
    for batch in (MAIN_BATCH, TIMING_BATCH):
        rows[f"k10_forward_bs{batch}_ms"] = [
            sum(depths[n][1] * rows[n][t] for n in depths
                if depths[n][0] == batch) for t in range(len(order))]
    del cases
    torch.cuda.empty_cache()
    model = create_model("SLaK_tiny", dtype=bf, seed=0, eval_layout="dual",
                         **MODEL_KW)
    own = S.dwpair
    for v in ("dual", "split"):
        rows[f"{v}_bs{TIMING_BATCH}_ms"] = []
    try:
        for route in order:
            S.dwpair = fns[route]
            for r in probe_eval_ab.run(TIMING_BATCH, model=model, rounds=3):
                rows[f"{r['eval_layout']}_bs{TIMING_BATCH}_ms"].append(
                    r["ms"])
    finally:
        S.dwpair = own
    del model
    torch.cuda.empty_cache()
    for name, ms in rows.items():
        print(f"[dwpair_ab] {name}: " + " / ".join(f"{v:.4f}" for v in ms)
              + "  (" + ", ".join(order) + ")", flush=True)
    out = dict(order=order, **rows)
    print("[dwpair_ab] " + json.dumps(out), flush=True)
    return out


def phase_stacked_ab(cfg, base: str):
    """K11 and K13 of another checkout against this tree's, in one process,
    in turns base, change, change, base: bf16 K11 and K13 at 0, 1 and all 5
    tap columns at each stage shape at the main and the train batch (and
    their sums over the four shapes), each tree's ``dwconv_stacked`` /
    ``dwconv_probe`` with its own kernels; the two trees' outputs agree
    within TOL_KERNEL, the copies exactly. Then this tree's K11 against
    K1's band launch (``dwconv.launch("band", ...)``) at the same shapes,
    in turns band, stacked, stacked, band. Returns the rows."""
    import torch
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.ops import dwconv_stacked as K11
    m11 = base_module(base, "dwconv_stacked", "dwconv_stacked",
                      ("_entries",), "stacked_ab")
    m13 = base_module(base, "dwconv", "dwconv", ("_probe_entry",),
                      "stacked_ab")
    fns = {"base": (m11.dwconv_stacked, m13.dwconv_probe),
           "change": (K11.dwconv_stacked, K1.dwconv_probe)}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(62)
    bf = torch.bfloat16
    cases, vs_band = [], []              # (name, fn(stacked, probe))
    for i, C, H, K, s, _ in stage_shapes(cfg):
        w1 = (torch.randn(C, K, s, generator=g, device=dev) * 0.05
              ).to(bf).float()
        for batch in (MAIN_BATCH, TRAIN_BATCH):
            x = torch.randn(batch, C, H, H, generator=g, device=dev).to(bf)
            tag = f"bs{batch}_stage{i + 1}"
            cases.append((f"k11_{tag}_ms",
                          lambda st, pr, x=x, w1=w1: st(x, w1)))
            for nt in (0, 1, s):
                cases.append((f"k13_ntaps{nt}_{tag}_ms",
                              lambda st, pr, x=x, w1=w1, nt=nt:
                              pr(x, w1, nt)))
            vs_band.append((tag, x, w1))
    for name, fn in cases:
        a, b = fn(*fns["change"]), fn(*fns["base"])
        if "ntaps0" in name:
            _check(torch.equal(a, b), f"stacked_ab {name}: copies differ")
        d, r = rel_err(a, b)
        _check(r <= TOL_KERNEL["bfloat16"], f"stacked_ab {name}: change vs "
               f"base rel err {r:.3g}")
    order = ("base", "change", "change", "base")
    rows = {name: [] for name, _ in cases}
    for tree in order:
        for name, fn in cases:
            rows[name].append(time_ms(lambda: fn(*fns[tree])))
    for batch in (MAIN_BATCH, TRAIN_BATCH):
        for kind in ("k11", "k13_ntaps0", "k13_ntaps1", "k13_ntaps5"):
            parts = [n for n, _ in cases
                     if n.startswith(f"{kind}_bs{batch}_")]
            rows[f"{kind}_bs{batch}_sum_ms"] = [
                sum(rows[n][t] for n in parts) for t in range(len(order))]
    del cases
    band_order = ("band", "stacked", "stacked", "band")
    for tag, x, w1 in vs_band:
        rows[f"k1band_vs_k11_{tag}_ms"] = [time_ms(
            (lambda: K1.launch("band", x, w1)) if r == "band"
            else (lambda: K11.dwconv_stacked(x, w1))) for r in band_order]
    for batch in (MAIN_BATCH, TRAIN_BATCH):
        parts = [n for n in rows if n.startswith("k1band_vs_k11_bs%d_"
                                                 % batch)]
        rows[f"k1band_vs_k11_bs{batch}_sum_ms"] = [
            sum(rows[n][t] for n in parts) for t in range(len(band_order))]
    del vs_band
    torch.cuda.empty_cache()
    for name, ms in rows.items():
        turns = band_order if name.startswith("k1band") else order
        print(f"[stacked_ab] {name}: " + " / ".join(f"{v:.4f}" for v in ms)
              + "  (" + ", ".join(turns) + ")", flush=True)
    out = dict(order=order, band_order=band_order, **rows)
    print("[stacked_ab] " + json.dumps(out), flush=True)
    return out


def phase_probes():
    """The four kernel probes with the launch counters set to 0 just before
    and read just after (probe_stacked once a dtype): each must launch its
    kernel, and every bf16 K11 and K13 launch must take its band kernel
    (stacked_band_kernel, K13's band route). Returns {probe: counts}."""
    import torch
    from slak_tpu_torch.tools import (probe_floor, probe_overhead,
                                      probe_pair_ab, probe_stacked)
    out = {}
    bf, f32 = torch.bfloat16, torch.float32
    for name, fn, want, band in (
            ("probe_stacked", lambda: probe_stacked.run(
                TRAIN_BATCH, dtypes=(bf,), rounds=3),
             "dwconv_stacked", "dwconv_stacked_band"),
            ("probe_stacked_fp32", lambda: probe_stacked.run(
                TRAIN_BATCH, dtypes=(f32,), rounds=3),
             "dwconv_stacked", None),
            ("probe_overhead", lambda: probe_overhead.run(TRAIN_BATCH,
                                                          rounds=3),
             "dwconv_probe", "dwconv_probe_band"),
            ("probe_floor", lambda: probe_floor.run(TRAIN_BATCH, rounds=3),
             "dwconv_probe", "dwconv_probe_band"),
            ("probe_pair_ab", lambda: probe_pair_ab.run(TIMING_BATCH,
                                                        rounds=3),
             "dwpair", None)):
        torch.cuda.synchronize()
        reset_counts()
        rows = fn()
        torch.cuda.synchronize()
        counts = read_dual_counts()
        for r in rows:
            print(f"[probes] {name} " + json.dumps(r), flush=True)
        print(f"[probes] {name} launches {counts}", flush=True)
        _check(counts[want] > 0, f"{name} launched no {want}")
        if band is not None:
            _check(counts[band] == counts[want], f"{name}: {counts[want]} "
                   f"{want} launches, {counts[band]} on the band kernel")
        elif want == "dwconv_stacked":
            _check(counts["dwconv_stacked_band"] == 0,
                   f"{name}: fp32 launches on the band kernel")
        out[name] = counts
        torch.cuda.empty_cache()
    return out


# --- data parallel with SyncBN and the channel-parallel eval ----------------
#
# The ranks are spawned processes (slak_tpu_torch/train/launch.py run_ranks)
# that import this file as their main module and run the _*_rank functions
# below. On one card several ranks can only share it through gloo (NCCL
# takes one card a rank), so every time printed by these phases is a gloo
# time on one card: it says nothing about data-parallel speed.

DP_RANKS = 2
DP_STEPS = 4
DP_TIMEOUT = 600                            # s: a rank group's run
TP_RANKS = (2, 4)
GLOO = "gloo, one card"


# the reference state of the one-step comparisons: masks drawn uniformly
# at 40% sparsity from the train state's seeded generator (the same in
# every process), not scored by SNIP (whose scores differ by rounding
# between one process and a group)
DP_REF_MASK = dict(TRAIN_MASK, sparse_init="uniform")


def _same_on_ranks(tensors, what):
    """Every tensor bit for bit rank 0's (broadcast and compare)."""
    import torch
    import torch.distributed as dist
    bad = []
    for n, t in tensors.items():
        t0 = t.detach().clone()
        dist.broadcast(t0, 0)
        if not torch.equal(t0, t.detach()):
            bad.append(n)
    _check(not bad, f"{what} differ across ranks: {bad[:5]}")
    return len(tensors)


def _step_snapshot(model, state, met):
    import torch
    return {"loss": met["loss"].item(),
            "grads": {n: p.grad.detach().float().clone()
                      for n, p in model.named_parameters()},
            "bn": {n: v.clone() for n, v in model.state_dict().items()
                   if "running" in n},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "masks": {n: m.clone() for n, m in
                      state.mask_state.masks.items()},
            "opt": {f"{i} {k}": v.clone() for i, st in
                    state.optimizer.state_dict()["state"].items()
                    for k, v in st.items() if torch.is_tensor(v)}}


def step_errors(got, want):
    """(loss rel err, max and worst of the gradients' relative norm
    errors, BN running stats' rel err) of one step against another."""
    le = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    ge = {n: ((got["grads"][n] - w).norm() / w.norm().clamp(min=1e-30)
              ).item() for n, w in want["grads"].items()}
    worst = max(ge, key=ge.get)
    be = max(rel_err(got["bn"][n], w)[1] for n, w in want["bn"].items())
    return le, ge[worst], worst, be


def _check_step(tag, dn, errs):
    le, ge, worst, be = errs
    tol = TOL_STEP[dn]
    print(f"[dp] {tag} {dn}: loss rel {le:.3g} (tol {tol['loss']}); grad "
          f"rel norm err max {ge:.3g} ({worst}, tol {tol['grad']}); BN "
          f"running stats rel {be:.3g} (tol {tol['bn']})", flush=True)
    _check(le <= tol["loss"], f"{tag} {dn} loss rel err {le:.3g}")
    _check(ge <= tol["grad"], f"{tag} {dn} grad {worst} rel err {ge:.3g}")
    _check(be <= tol["bn"], f"{tag} {dn} BN stats rel err {be:.3g}")


def _dp_rank(ref_dir):
    """One rank of `dp` (b): DP_STEPS sparse bf16 steps over the group
    (SNIP masks scored over it), then one step from the reference state in
    bf16 and fp32 against the one-process step saved in ref_dir."""
    import torch
    from slak_tpu_torch.parallel import mesh
    from slak_tpu_torch.parallel.syncbn import make_syncbn_train_step
    group = mesh.axis_group()
    r = mesh.rank()
    model, state, tc, mc, lr, batches = train_setup(
        TRAIN_BATCH, torch.bfloat16, TRAIN_MASK, group=group)
    n_masks = _same_on_ranks(state.mask_state.masks, "SNIP masks")
    step = make_syncbn_train_step(model, tc, mc, lr)
    gen = torch.Generator(device="cuda").manual_seed(11)
    refreshes, losses = 0, []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for k in range(DP_STEPS):
        before = {n: m.clone() for n, m in state.mask_state.masks.items()}
        state, met = step(state, batches[k % 2], gen)
        losses.append(met["loss"].item())
        _check(math.isfinite(losses[-1]), f"rank {r} step {k}: loss "
               f"{losses[-1]}")
        masks = state.mask_state.masks
        if any(not torch.equal(before[n], masks[n]) for n in masks):
            refreshes += 1
            _same_on_ranks(masks, f"masks after the refresh of step {k}")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read_counts()
    want = cli_counts(model.cfg, steps=DP_STEPS)
    _check(counts == want, f"rank {r}: launch counts {counts}, want {want}")
    _check(refreshes == DP_STEPS // mc.update_frequency,
           f"rank {r}: {refreshes} DST refreshes")
    n_params = _same_on_ranks(dict(model.named_parameters()), "parameters")
    out = {"steps": dict(losses=losses, counts=counts, seconds=sec,
                         refreshes=refreshes, masks=n_masks,
                         params=n_params)}
    del model, state, step, batches
    torch.cuda.empty_cache()
    for dtype, b in ((torch.bfloat16, TRAIN_BATCH),
                     (torch.float32, CHECK_BATCH_FP32)):
        dn = str(dtype).split(".")[1]
        model, state, tc, mc, lr, batches = train_setup(
            b, dtype, DP_REF_MASK, group=group)
        step = make_syncbn_train_step(model, tc, mc, lr)
        state, met = step(state, batches[0],
                          torch.Generator(device="cuda").manual_seed(5))
        got = _step_snapshot(model, state, met)
        _same_on_ranks(got["grads"], f"{dn} gradients")
        want = torch.load(os.path.join(ref_dir, f"step_{dn}.pt"),
                          map_location="cuda", weights_only=False)
        out[dn] = step_errors(got, want)
        del model, state, step, batches, got, want
        torch.cuda.empty_cache()
    return out


def dp_reference(ref_dir):
    """The one-process steps the ranks are held to: one step from the
    reference state (DP_REF_MASK) at the global batch, bf16 at TRAIN_BATCH
    and fp32 at CHECK_BATCH_FP32, saved to ref_dir."""
    import torch
    from slak_tpu_torch.train.engine import make_train_step
    for dtype, b in ((torch.bfloat16, TRAIN_BATCH),
                     (torch.float32, CHECK_BATCH_FP32)):
        dn = str(dtype).split(".")[1]
        model, state, tc, mc, lr, batches = train_setup(b, dtype,
                                                        DP_REF_MASK)
        step = make_train_step(model, tc, mc, lr)
        state, met = step(state, batches[0],
                          torch.Generator(device="cuda").manual_seed(5))
        snap = _step_snapshot(model, state, met)
        torch.save({k: snap[k] for k in ("loss", "grads", "bn")},
                   os.path.join(ref_dir, f"step_{dn}.pt"))
        del model, state, step, batches, snap
        torch.cuda.empty_cache()


def dp_nccl_world1(tmp):
    """`dp` (a): a group of one rank on NCCL. Two bf16 steps through the
    group (SyncBN's all-reduces, the gradient all-reduce) against the same
    steps without one, from the same state and generator: every gradient,
    parameter, BN stat, mask and optimizer tensor bit for bit; the
    launches counted. cuDNN is deterministic for the check (the 5x5
    branch's conv)."""
    import torch
    from slak_tpu_torch.parallel import mesh
    from slak_tpu_torch.parallel.syncbn import make_syncbn_train_step
    from slak_tpu_torch.train.engine import make_train_step
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mesh.init_distributed("nccl", f"file://{tmp}/nccl_world1", 0, 1, 0)
    try:
        group = mesh.axis_group()
        runs, counts = {}, None
        for tag in ("plain", "group"):
            g = group if tag == "group" else None
            model, state, tc, mc, lr, batches = train_setup(
                TRAIN_BATCH, torch.bfloat16, DP_REF_MASK, group=g)
            step = (make_syncbn_train_step(model, tc, mc, lr) if g is not None
                    else make_train_step(model, tc, mc, lr))
            gen = torch.Generator(device="cuda").manual_seed(11)
            torch.cuda.synchronize()
            reset_counts()
            for k in range(2):
                state, met = step(state, batches[k], gen)
            torch.cuda.synchronize()
            if g is not None:
                counts = read_counts()
            runs[tag] = _step_snapshot(model, state, met)
            del model, state, step, batches
            torch.cuda.empty_cache()
    finally:
        mesh.destroy()
        torch.backends.cudnn.deterministic = det

    def differ(a, b):
        bad = [] if a["loss"] == b["loss"] else ["loss"]
        for part in ("grads", "bn", "params", "masks", "opt"):
            bad += [f"{part} {n}" for n, v in a[part].items()
                    if not torch.equal(v, b[part][n])]
        return bad
    bad = differ(runs["group"], runs["plain"])
    n = sum(len(runs["plain"][p]) for p in ("grads", "bn", "params",
                                             "masks", "opt"))
    print(f"[dp] (a) NCCL, world size 1: 2 bf16 steps at batch {TRAIN_BATCH}"
          f" through the group vs without: {n - len(bad)} of {n} tensors "
          f"and the loss bit for bit; launches {counts}", flush=True)
    _check(not bad, f"NCCL world-1 steps differ from the ungrouped ones: "
           f"{bad[:5]}")
    from slak_tpu_torch.models.slak import config_for
    want = cli_counts(config_for("SLaK_tiny", **MODEL_KW), steps=2)
    _check(counts == want, f"NCCL world-1 launch counts {counts}, want "
           f"{want}")
    return counts


class RankBatches:
    """The train loader of a one-process CLI run that sees what DP_RANKS
    ranks see: each batch the ranks' batches concatenated in rank order."""

    def __init__(self, ds, batch_size, rank=0, world_size=1, **kw):
        from slak_tpu_torch.data.loader import BatchLoader
        self.parts = [BatchLoader(ds, batch_size // DP_RANKS, rank=r,
                                  world_size=DP_RANKS, **kw)
                      for r in range(DP_RANKS)]
        self.num_workers = self.parts[0].num_workers

    def set_epoch(self, epoch):
        for p in self.parts:
            p.set_epoch(epoch)

    def __len__(self):
        return len(self.parts[0])

    def __iter__(self):
        import torch
        for parts in zip(*self.parts):
            yield tuple(torch.cat(t) for t in zip(*parts))


def dp_cli():
    """`dp` (c): the train CLI through the launcher on DP_RANKS gloo ranks
    (the recipe run of `cli` at TRAIN_BATCH // DP_RANKS a rank: SNIP over
    the group, a 4-step epoch, eval on 129 synthetic val images, a
    checkpoint) and the one-process CLI at TRAIN_BATCH fed the ranks'
    batches concatenated: the first step's losses within TOL_STEP, every
    val image counted once, rank 0's one checkpoint."""
    import shutil
    from slak_tpu_torch import data
    from slak_tpu_torch.train import launch
    from slak_tpu_torch.train.main import main, parse_args
    out_dir = os.path.join(OUT_DIR, "dp_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    n_val = 129
    argv = list(CLI_ARGS)
    argv[argv.index("--batch_size") + 1] = str(TRAIN_BATCH // DP_RANKS)
    argv += ["--epochs", "1", "--synthetic_len", str(4 * n_val),
             "--dist_backend", "gloo"]
    try:
        t0 = time.perf_counter()
        two = launch.main(["--nproc", str(DP_RANKS), "--timeout",
                           str(DP_TIMEOUT), "--"] + argv
                          + ["--output_dir", out_dir])
        sec2 = time.perf_counter() - t0
        ckpts = sorted(f for f in os.listdir(out_dir)
                       if f.startswith("checkpoint-")
                       and f[len("checkpoint-"):].isdigit())
        base = data.BatchLoader

        def loader(ds, batch_size, shuffle=True, **kw):
            if shuffle:
                return RankBatches(ds, batch_size, shuffle=True, **kw)
            return base(ds, batch_size, shuffle=shuffle, **kw)
        argv[argv.index("--batch_size") + 1] = str(TRAIN_BATCH)
        data.BatchLoader = loader
        try:
            t0 = time.perf_counter()
            one = main(parse_args(argv + ["--disable_eval", "true",
                                          "--save_ckpt", "false"]))
            sec1 = time.perf_counter() - t0
        finally:
            data.BatchLoader = base
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    st = two["epochs"][0]
    l2, l1 = two["step_losses"][0], one["step_losses"][0]
    le = abs(l2 - l1) / abs(l1)
    print(f"[dp] (c) the CLI through launch --nproc {DP_RANKS} ({GLOO}): "
          f"{sec2:.1f} s in all; {len(two['step_losses'])} steps, losses "
          f"{[round(v, 5) for v in two['step_losses']]}; the one-process CLI"
          f" on the same batches {[round(v, 5) for v in one['step_losses']]}"
          f" ({sec1:.1f} s); first step rel {le:.3g} (tol "
          f"{TOL_STEP['bfloat16']['loss']}); val images {st['test_images']}"
          f"; checkpoints on disk {ckpts}, written by rank 0 "
          f"{[os.path.basename(c) for c in two['checkpoints']]}; "
          f"{st['images_per_sec']:.1f} img/s over the ranks with the "
          f"loader feeding", flush=True)
    _check(le <= TOL_STEP["bfloat16"]["loss"], f"CLI first step loss rel "
           f"err {le:.3g}")
    _check(st["test_images"] == n_val, f"eval counted {st['test_images']} "
           f"of {n_val} val images")
    _check(ckpts == ["checkpoint-0"], f"checkpoints {ckpts}")
    _check([os.path.basename(c) for c in two["checkpoints"]
            if "best" not in c] == ["checkpoint-0"],
           f"rank 0 wrote {two['checkpoints']}")
    return dict(seconds=sec2, losses=two["step_losses"],
                one_process_losses=one["step_losses"],
                images_per_sec=st["images_per_sec"])


def phase_dp():
    """Data parallel with SyncBN: (a) NCCL at world size 1, bit for bit;
    (b) DP_RANKS gloo ranks on the card; (c) the CLI through the
    launcher."""
    import tempfile
    import torch
    from slak_tpu_torch.train.launch import run_ranks
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="slak_dp_") as tmp:
        counts_a = dp_nccl_world1(tmp)
        ta = time.perf_counter() - t0
        dp_reference(tmp)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res = run_ranks(_dp_rank, DP_RANKS, (tmp,), "gloo", None, DP_TIMEOUT,
                        DP_TIMEOUT)
        tb = time.perf_counter() - t1
    for r, out in enumerate(res):
        st = out["steps"]
        print(f"[dp] (b) rank {r} of {DP_RANKS} ({GLOO}): {DP_STEPS} bf16 "
              f"steps at {TRAIN_BATCH // DP_RANKS} a rank (global "
              f"{TRAIN_BATCH}) in {st['seconds']:.2f} s, losses "
              f"{[round(v, 5) for v in st['losses']]}, {st['refreshes']} "
              f"refreshes, {st['masks']} masks and {st['params']} "
              f"parameters the same on every rank; launches {st['counts']}",
              flush=True)
        for dn in ("bfloat16", "float32"):
            _check_step(f"(b) rank {r}, one step vs one process", dn,
                        out[dn])
    _check(res[0]["steps"]["losses"] == res[1]["steps"]["losses"],
           "the ranks' losses differ")
    tc = time.perf_counter()
    cli = dp_cli()
    tc = time.perf_counter() - tc
    print(f"[dp] times ({GLOO}; no data-parallel speed): (a) {ta:.1f} s, "
          f"(b) {tb:.1f} s, (c) {tc:.1f} s", flush=True)
    return {"world1_nccl": counts_a, "rank_counts": res[0]["steps"]["counts"],
            "cli": cli}


def _tp_rank(ref_dir):
    """One rank of `tp`: K1 (and K6 on stage 4's 7x7 maps) at this group's
    shard widths against the plain version, then the flagship's
    channel-parallel eval in bf16 and fp32 against the one-process logits
    in ref_dir, the launches counted."""
    import torch
    from slak_tpu_torch.models import create_model
    from slak_tpu_torch.models.slak import config_for
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.parallel import mesh
    from slak_tpu_torch.parallel.tp import make_tp_apply
    d, r = mesh.world(), mesh.rank()
    cfg = config_for("SLaK_tiny", **MODEL_KW)
    out = {"kernels": []}
    g = torch.Generator(device="cuda").manual_seed(20 + r)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for i, C, H, K, s, _ in stage_shapes(cfg):
            c = -(-C // d)
            x = torch.randn(MAIN_BATCH, c, H, H, generator=g, device="cuda"
                            ).to(dtype)
            ws = [(0.05 * torch.randn(c, *shape, generator=g, device="cuda")
                   ).to(dtype).float() for shape in ((K, s), (s, K))]
            route = route_of(x, ws[0])
            want = ("toeplitz2d" if H * H <= K1.P_MAX else "band") \
                if dtype == torch.bfloat16 else "band_f32"
            _check(route == want, f"tp stage {i + 1} {dn} at {c} channels: "
                   f"route {route}, want {want}")
            err = check_dwconv_pair(x, ws, dn, f"tp stage {i + 1} {c} ch")
            same_bits_twice(lambda: K1.dwconv(x, ws[1], out=K1.dwconv(
                x, ws[0])), f"tp stage {i + 1} {dn} {c} ch")
            out["kernels"].append((dn, i + 1, c, route, err[1]))
    model = create_model("SLaK_tiny", dtype=torch.bfloat16, seed=0,
                         **MODEL_KW)
    randomize(model, 1)
    tp = make_tp_apply(model)
    images = torch.load(os.path.join(ref_dir, "images.pt"),
                        map_location="cuda")
    nb = sum(cfg.depths)
    k6 = k6_convs(cfg)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        x = images.to(dtype)
        tp(x)                               # fold the shard's taps, warm up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits = tp(x)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        want = torch.load(os.path.join(ref_dir, f"logits_{dn}.pt"),
                          map_location="cuda")
        err = rel_err(logits, want)
        _check(bool(torch.isfinite(logits).all()), f"tp {dn} logits not "
               f"finite")
        _check(err[1] <= TOL_LOGITS[dn], f"tp {dn} logits rel err "
               f"{err[1]:.3g} > {TOL_LOGITS[dn]}")
        want_counts = {"dwconv": 2 * nb, "fused_mlp": 0}
        if dtype == torch.bfloat16:
            want_counts.update(dwconv_band=2 * nb - k6, dwconv_toeplitz=k6,
                               dwconv_tf32=0)
        else:
            want_counts.update(dwconv_band=0, dwconv_toeplitz=0,
                               dwconv_tf32=2 * nb)
        got = {k: counts[k] for k in want_counts}
        _check(got == want_counts, f"tp {dn} launches {got}, want "
               f"{want_counts}")
        out[dn] = dict(err=err, counts=got, ms=1e3 * sec)
    return out


def add_parallel_launches(kernels, dp_run, tp_run):
    """Each kernel row's launches in `dp` (b) (one rank's, DP_STEPS bf16
    steps) and `tp` (one rank's, one forward a dtype), on the rows the
    earlier phases made."""
    dp, tp = {}, {}
    if dp_run is not None:
        c = dp_run["rank_counts"]
        dp = {"dwconv": c["dwconv"] - c["dwconv_toeplitz"],
              "dwconv2d": c["dwconv_toeplitz"] + c["dwconv_stats_toeplitz"],
              "dwconv_stats": c["dwconv_stats"] - c["dwconv_stats_toeplitz"],
              "dwconv_wgrad": c["dwconv_wgrad"], "fused_mlp": c["fused_mlp"],
              "mlp_bwd": c["mlp_bwd"], "mlp_bwd_wide": c["mlp_bwd_wide"]}
    if tp_run is not None:
        for d, by in tp_run.items():
            b, f = by["bfloat16"], by["float32"]
            for name, n in (("dwconv", b["dwconv_band"]),
                            ("dwconv2d", b["dwconv_toeplitz"]),
                            ("dwconv_f32", f["dwconv_tf32"])):
                tp.setdefault(name, {})[f"{d}_ranks"] = n
    for k in kernels:
        if k["name"] in dp:
            k["dp_launches"] = dp[k["name"]]
            k["dp_launches_in"] = ("dp: one of %d gloo ranks, %d bf16 steps "
                                   "at %d a rank" % (DP_RANKS, DP_STEPS,
                                                     TRAIN_BATCH // DP_RANKS))
        if k["name"] in tp:
            k["tp_launches"] = tp[k["name"]]
            k["tp_launches_in"] = ("tp: one rank, one forward at batch %d "
                                   "(bf16 for dwconv and dwconv2d, fp32 for "
                                   "dwconv_f32)" % MAIN_BATCH)


def phase_tp():
    """The flagship's channel-parallel eval over 2 and then 4 gloo ranks on
    the card at MAIN_BATCH, bf16 and fp32, against the one-process kernel
    route."""
    import tempfile
    import torch
    from slak_tpu_torch.models import create_model
    from slak_tpu_torch.train.engine import make_eval_step
    from slak_tpu_torch.train.launch import run_ranks
    results = {}
    with tempfile.TemporaryDirectory(prefix="slak_tp_") as tmp:
        model = create_model("SLaK_tiny", dtype=torch.bfloat16, seed=0,
                             **MODEL_KW)
        randomize(model, 1)
        g = torch.Generator().manual_seed(2)
        images = torch.randn(MAIN_BATCH, 224, 224, 3, generator=g)
        labels = torch.zeros(MAIN_BATCH, dtype=torch.int64)
        torch.save(images, os.path.join(tmp, "images.pt"))
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            logits = make_eval_step(model, dtype)((images, labels))["logits"]
            torch.save(logits, os.path.join(tmp, f"logits_{dn}.pt"))
        del model
        torch.cuda.empty_cache()
        for d in TP_RANKS:
            t0 = time.perf_counter()
            res = run_ranks(_tp_rank, d, (tmp,), "gloo", None, DP_TIMEOUT,
                            DP_TIMEOUT)
            sec = time.perf_counter() - t0
            widths = sorted({k[2] for k in res[0]["kernels"]})
            worst = max(k[4] for out in res for k in out["kernels"])
            print(f"[tp] {d} ranks ({GLOO}): K1/K6 at shard widths {widths} "
                  f"held to their plain versions on every rank (worst rel "
                  f"{worst:.3g}, routes "
                  f"{sorted({(k[0], k[3]) for k in res[0]['kernels']})}, the "
                  f"same bits twice); {sec:.1f} s in all", flush=True)
            for r, out in enumerate(res):
                for dn in ("bfloat16", "float32"):
                    o = out[dn]
                    print(f"[tp] {d} ranks, rank {r}, {dn}: logits rel err "
                          f"{o['err'][1]:.3g} (tol {TOL_LOGITS[dn]}) vs the "
                          f"one-process kernel route; launches {o['counts']};"
                          f" {o['ms']:.1f} ms a forward ({GLOO})", flush=True)
            results[d] = {dn: res[0][dn]["counts"] for dn in
                          ("bfloat16", "float32")}
    return results


# ---------------------------------------------------------------------------
# knowledge distillation: the SLaK-T 51x51 w1.3 teacher (eval) to the
# ConvNeXt-T student (train), and the teacher zoo

KD_STEPS = 4
KD_TYPES = ("None", "KD", "KD hard", "NKD", "FD", "FD+KD", "FD+NKD", "MGD")
KD_ZOO = ("vit_base_patch16_224", "swin_tiny_patch4_window7_224",
          "cswin_tiny", "resnet50d", "mobilenetv3_large_100",
          "efficientnet_b0", "tf_efficientnet_b3_ns")
ZOO_CHECK_BATCH = 2
ZOO_BF16_BATCH = 8
ZOO_STEP_BATCH = 32
# a zoo teacher's fp32 forward on the card against the same module on the
# CPU, TF32 off: max |diff| / max |CPU| of the logits and of the feature
# (fp32 sums in another order through up to 26 blocks)
TOL_ZOO_FP32 = 1e-4
KD_CLI_ARGS = ["--model", "SLaK_tiny", "--teacher_kernel_size", "51", "49",
               "47", "13", "5", "--teacher_width_factor", "1.3",
               "--teacher_Decom", "true", "--model_s", "convnext_tiny",
               "--distill_type", "NKD", "--data_set", "synthetic",
               "--input_size", "224", "--batch_size", str(TRAIN_BATCH),
               "--model_ema", "true", "--use_bf16", "true",
               "--warmup_epochs", "0", "--epochs", "1", "--synthetic_len",
               str(KD_STEPS * TRAIN_BATCH)]


def kd_config(dt):
    """The KDConfig of a KD_TYPES entry ("KD hard": KD with hard=True)."""
    from slak_tpu_torch.kd.engine import KDConfig
    return KDConfig("KD", hard=True) if dt == "KD hard" else KDConfig(dt)


def kd_counts(tcfg, scfg, steps=0, student_evals=0) -> dict:
    """The launch counts (read_counts' keys) of `steps` bf16 KD steps
    (the teacher's eval forward: two K1 a block, stage 4's on K6's
    Toeplitz kernel, the rest on the band kernel, one K2/K3 a block; the
    student's train step: its 7x7 branch through F.conv2d, K2 a block,
    K8 at C <= 256, K9 above where TRAIN_WIDE_MLP_BWD routes them; no
    teacher backward, K4 or weight-gradient launch) and `student_evals`
    bf16 eval forwards of the student (one K1 a block, stage 4's on K6's
    kernel, one K2/K3 a block)."""
    from slak_tpu_torch.models import slak as S
    from slak_tpu_torch.ops.mlp import BWD_C_MAX
    nt, ns = sum(tcfg.depths), sum(scfg.depths)
    narrow = sum(d for d, c in zip(scfg.depths, scfg.widened_dims)
                 if c <= BWD_C_MAX)
    wide = ns - narrow if S.TRAIN_WIDE_MLP_BWD else 0
    k6_t, k6_s = k6_convs(tcfg), k6_convs(scfg, per_block=1)
    want = {k: 0 for k in read_counts()}
    want.update(
        dwconv=2 * nt * steps + ns * student_evals,
        dwconv_band=(2 * nt - k6_t) * steps,
        dwconv_toeplitz=k6_t * steps + k6_s * student_evals,
        fused_mlp=(nt + narrow + wide) * steps + ns * student_evals,
        mlp_bwd=narrow * steps, mlp_bwd_wide=wide * steps)
    return want


def phase_kd_kernels(batch):
    """K8 and K9 at ConvNeXt-T's widths (C = 96, 192 and 384, 768, NCHW,
    bf16, batch 128, the 56^2 - 7^2 maps) against their plain versions,
    at the ragged batches too, the same bits twice; times, bound, plain
    and unfused: the per-step sums by kernel and the rows."""
    import torch
    from slak_tpu_torch.models.slak import config_for
    cfg = config_for("convnext_tiny")
    g = torch.Generator(device="cuda").manual_seed(13)
    totals, rows = {}, []
    for i, C, H, K, s, depth in stage_shapes(cfg):
        row = stage_kernel_rows("kd_kernels", ("mlp_bwd",), i, C, H, K, s,
                                depth, batch, torch.bfloat16, g,
                                mlp_batches=RAGGED,
                                model="convnext_tiny")["mlp_bwd"][0]
        rows.append(row)
        add_total(totals, row["kernel"], row, depth)
        torch.cuda.empty_cache()
    print("[kd_kernels] per bf16 ConvNeXt-T step at batch %d: " % batch
          + json.dumps({n: {k: round(v, 4) for k, v in t.items()
                            if k != "routes"}
                        for n, t in totals.items()}), flush=True)
    return totals, rows


def kd_teacher():
    """The flagship teacher, bf16, random weights from a seed (every block
    matters), in eval mode."""
    import torch
    from slak_tpu_torch.models import create_model
    teacher = create_model("SLaK_tiny", dtype=torch.bfloat16, seed=0,
                           **MODEL_KW)
    randomize(teacher, 1)
    return teacher


def kd_student_state():
    """ConvNeXt-T's weights for the KD runs: from a seed, randomized."""
    import torch
    from slak_tpu_torch.models import create_model
    student = create_model("convnext_tiny", seed=3, drop_path_rate=0.1)
    randomize(student, 2)
    sd = {k: v.clone() for k, v in student.state_dict().items()}
    del student
    torch.cuda.empty_cache()
    return sd


def kd_setup(teacher_apply, dt, batch, student_sd, teacher_channels=998,
             mask_kw=None, group=None):
    """(student, its train state, kd_params, their AdamW, train config,
    KD config, mask config, lr schedule, batches) of a bf16 KD run of the
    ConvNeXt-T student (drop path 0.1, EMA) on two random batches of
    `batch` 224^2 images; under `group` each batch this rank's shard and
    SNIP's gradients averaged over it."""
    import torch
    from slak_tpu_torch.kd.engine import init_kd_params, kd_opt_init
    from slak_tpu_torch.models import create_model
    from slak_tpu_torch.parallel import mesh
    from slak_tpu_torch.sparsity.masking import MaskConfig
    from slak_tpu_torch.train import losses as L
    from slak_tpu_torch.train.engine import TrainConfig, create_train_state
    from slak_tpu_torch.train.optim import cosine_schedule_array
    dtype = torch.bfloat16
    student = create_model("convnext_tiny", dtype=dtype, seed=3,
                           drop_path_rate=0.1)
    student.load_state_dict(student_sd)
    g = torch.Generator(device="cuda").manual_seed(7)
    batches = [(torch.randn(batch, 224, 224, 3, generator=g, device="cuda"),
                torch.randint(0, 1000, (batch,), generator=g, device="cuda"))
               for _ in range(2)]
    if group is not None:
        batches = [mesh.shard_batch(b) for b in batches]
    tc = TrainConfig(compute_dtype=dtype, weight_decay=0.05,
                     ema_decay=0.9999, prune_t_max=100)
    mc = MaskConfig(**mask_kw) if mask_kw else None
    snip = None
    if mc is not None and mc.sparse_init == "snip":
        def snip():
            from slak_tpu_torch.models import apply
            x, y = batches[0]
            return L.cross_entropy(apply(student, x.to(dtype)), y)
    state = create_train_state(student, tc, mc, snip, seed=0, group=group)
    cfg = kd_config(dt)
    kd = init_kd_params(torch.Generator().manual_seed(1), cfg,
                        student.cfg.widened_dims[-1], teacher_channels,
                        "cuda")
    lr = cosine_schedule_array(1e-3, 1e-6, 1, 100)
    return (student, state, kd, kd_opt_init(kd), tc, cfg, mc, lr, batches)


def kd_snapshot(student, kd, met):
    """The loss and every student and head gradient of a KD step."""
    grads = {n: p.grad.detach().float().clone()
             for n, p in student.named_parameters()}
    grads.update({"kd_params." + n: p.grad.detach().float().clone()
                  for n, p in kd.named_parameters()})
    return {"loss": met["loss"].item(), "grads": grads}


def kd_errors(got, want):
    """(loss rel err, the worst gradient's rel norm err, its name)."""
    le = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    ge = {n: ((got["grads"][n] - w).norm() / w.norm().clamp(min=1e-30)
              ).item() for n, w in want["grads"].items()}
    worst = max(ge, key=ge.get)
    return le, ge[worst], worst


def kd_headline(teacher, sd0):
    """(b): KD_STEPS sparse bf16 NKD steps at TRAIN_BATCH (SNIP masks at
    40%, a refresh every 2 steps), counted; then one step a distill type,
    kernels against the plain route; the NKD step timed on both routes."""
    import torch
    from slak_tpu_torch.kd.engine import make_kd_train_step, make_teacher_apply
    tapply = make_teacher_apply(teacher)
    t0 = time.perf_counter()
    (student, state, kd, kopt, tc, cfg, mc, lr, batches) = kd_setup(
        tapply, "NKD", TRAIN_BATCH, sd0, mask_kw=TRAIN_MASK)
    print(f"[kd] set-up (SNIP masks of the student) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    step = make_kd_train_step(student, tapply, cfg, tc, mc, lr)
    named = dict(student.named_parameters())
    gen = torch.Generator(device="cuda").manual_seed(11)
    refreshes = 0
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for k in range(KD_STEPS):
        before = {n: m.clone() for n, m in state.mask_state.masks.items()}
        state, kd, kopt, met = step(state, kd, kopt, batches[k % 2], gen)
        masks = state.mask_state.masks
        loss = met["loss"].item()
        _check(math.isfinite(loss), f"kd step {k}: loss {loss}")
        if any(not torch.equal(before[n], masks[n]) for n in masks):
            refreshes += 1
            for n, m in masks.items():
                nb, na = before[n].sum().item(), m.sum().item()
                _check(abs(na - nb) <= 6 * max(nb, 1) ** 0.5 + 1,
                       f"kd step {k}: {n} count {nb} -> {na}")
        for n, m in masks.items():
            z = (named[n].detach() * (1 - m)).abs().max().item()
            _check(z == 0.0, f"kd step {k}: masked weights of {n} not 0")
        print(f"[kd] NKD step {k}: loss {loss:.5f} grad_norm "
              f"{met['grad_norm'].item():.4f}", flush=True)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read_counts()
    want = kd_counts(teacher.cfg, student.cfg, steps=KD_STEPS)
    frozen = all(p.grad is None and not p.requires_grad
                 for p in teacher.parameters())
    print(f"[kd] {KD_STEPS} sparse bf16 NKD steps at batch {TRAIN_BATCH} "
          f"(SLaK-T 51x51 w1.3 teacher, ConvNeXt-T student) in {sec:.2f} s;"
          f" launches {counts}; refreshes {refreshes}; teacher frozen "
          f"{frozen}", flush=True)
    _check(counts == want, f"kd launch counts {counts}, want {want}")
    _check(refreshes == KD_STEPS // mc.update_frequency,
           f"kd: {refreshes} DST refreshes")
    _check(frozen, "a teacher parameter has a gradient or requires one")
    _check(all(bool(torch.isfinite(v).all()) for v in state.ema.values()),
           "kd: EMA not finite")
    del student, state, step, batches
    torch.cuda.empty_cache()

    errs, times = {}, {}
    for dt in KD_TYPES:
        snaps = []
        for plain in (False, True):
            (student, state, kd, kopt, tc, cfg, _, lr, batches) = kd_setup(
                tapply, dt, TRAIN_BATCH, sd0)
            step = make_kd_train_step(student, tapply, cfg, tc, None, lr,
                                      plain=plain)
            state, kd, kopt, met = step(
                state, kd, kopt, batches[0],
                torch.Generator(device="cuda").manual_seed(5))
            snaps.append(kd_snapshot(student, kd, met))
            if dt == "NKD":
                g = torch.Generator(device="cuda").manual_seed(6)
                times["plain" if plain else "kernels"] = time_ms(
                    lambda: step(state, kd, kopt, batches[1], g), 3,
                    warmup=1, rounds=3)
            del student, state, step, batches
            torch.cuda.empty_cache()
        le, ge, worst = kd_errors(*snaps)
        tol = TOL_STEP["bfloat16"]
        errs[dt] = dict(loss=snaps[0]["loss"], loss_rel=le, grad_rel=ge,
                        worst=worst, heads=sorted(
                            {n.split(".")[1] for n in snaps[0]["grads"]
                             if n.startswith("kd_params.")}))
        print(f"[kd] one bf16 {dt} step at batch {TRAIN_BATCH}, kernels vs "
              f"plain: loss {snaps[0]['loss']:.6f} vs {snaps[1]['loss']:.6f}"
              f" (rel {le:.3g}, tol {tol['loss']}); grad rel norm err max "
              f"{ge:.3g} ({worst}, tol {tol['grad']}); heads "
              f"{errs[dt]['heads']}", flush=True)
        _check(math.isfinite(snaps[0]["loss"]), f"kd {dt}: loss not finite")
        _check(le <= tol["loss"], f"kd {dt} loss rel err {le:.3g}")
        _check(ge <= tol["grad"], f"kd {dt} grad {worst} rel err {ge:.3g}")
    print(f"[kd] the bf16 NKD step at batch {TRAIN_BATCH}: kernels "
          f"{times['kernels']:.3f} ms, plain {times['plain']:.3f} ms (CUDA "
          f"events, median of 3 rounds of 3)", flush=True)
    return dict(counts=counts, seconds=sec, refreshes=refreshes,
                step_ms=times, types=errs)


def kd_zoo(sd0):
    """(c): each zoo teacher at full width and 224^2, random weights from
    a seed: logits and feature shapes, fp32 on the card against the same
    module on the CPU, bf16 against fp32 on the card, a load_teacher_
    checkpoint round trip from a .pth with a module. prefix under
    "model", one FD+NKD step at ZOO_STEP_BATCH with the ConvNeXt-T
    student, and the bf16 forward timed at TRAIN_BATCH."""
    import copy
    import torch
    from slak_tpu_torch.kd.engine import make_kd_train_step
    from slak_tpu_torch.models import zoo
    from slak_tpu_torch.utils.convert_teachers import load_teacher_checkpoint
    out = {}
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(ZOO_BF16_BATCH, 224, 224, 3, generator=g, device="cuda")
    xt = torch.randn(TRAIN_BATCH, 224, 224, 3, generator=g,
                     device="cuda").to(torch.bfloat16)
    for name in KD_ZOO:
        t0 = time.perf_counter()
        teacher = zoo.create_teacher(name, 1000, 224, "cuda", seed=0)
        randomize(teacher, 3)
        fn = teacher.teacher_apply()
        C = teacher.feature_channels
        side = 14 if zoo.family_of(name) == "vit" else 7
        l32, f32 = fn(x)
        _check(tuple(l32.shape) == (ZOO_BF16_BATCH, 1000)
               and l32.dtype == torch.float32, f"{name} logits {l32.shape}")
        _check(tuple(f32.shape) == (ZOO_BF16_BATCH, side, side, C),
               f"{name} feature {tuple(f32.shape)}, want "
               f"{(ZOO_BF16_BATCH, side, side, C)}")
        cpu = copy.deepcopy(teacher).cpu()
        with torch.no_grad():
            lc, fc = cpu(x[:ZOO_CHECK_BATCH].cpu())
        del cpu
        _, r_l = rel_err(l32[:ZOO_CHECK_BATCH].cpu(), lc)
        _, r_f = rel_err(f32[:ZOO_CHECK_BATCH].cpu(), fc)
        lb, fb = fn(x.to(torch.bfloat16))
        _, r_bl = rel_err(lb, l32)
        _, r_bf = rel_err(fb.float(), f32)
        path = os.path.join(OUT_DIR, f"zoo_{name}.pth")
        torch.save({"model": {"module." + k: v.cpu() for k, v in
                              teacher.state_dict().items()}}, path)
        try:
            back = load_teacher_checkpoint(path, name, "cuda")
        finally:
            os.remove(path)
        same = torch.equal(back.teacher_apply()(x)[0], l32)
        del back
        ms = time_ms(lambda: fn(xt), 3, warmup=1, rounds=3)
        # one FD+NKD step with the ConvNeXt-T student
        (student, state, kd, kopt, tc, cfg, _, lr, batches) = kd_setup(
            fn, "FD+NKD", ZOO_STEP_BATCH, sd0, teacher_channels=C)
        step = make_kd_train_step(student, fn, cfg, tc, None, lr)
        state, kd, kopt, met = step(state, kd, kopt, batches[0],
                                    torch.Generator(device="cuda")
                                    .manual_seed(5))
        loss = met["loss"].item()
        proj = "fd_proj" in kd
        row = dict(channels=C, feature=[side, side], fp32_vs_cpu=[r_l, r_f],
                   bf16_vs_fp32=[r_bl, r_bf], checkpoint_same=same,
                   bf16_forward_ms=ms, fd_nkd_loss=loss, fd_proj=proj,
                   seconds=time.perf_counter() - t0)
        print(f"[kd] zoo {name}: " + json.dumps(row), flush=True)
        _check(r_l <= TOL_ZOO_FP32 and r_f <= TOL_ZOO_FP32,
               f"{name} fp32 card vs CPU rel {r_l:.3g} / {r_f:.3g}")
        _check(r_bl <= TOL_LOGITS["bfloat16"]
               and r_bf <= TOL_LOGITS["bfloat16"],
               f"{name} bf16 vs fp32 rel {r_bl:.3g} / {r_bf:.3g}")
        _check(same, f"{name}: logits after the checkpoint round trip "
               "differ")
        _check(math.isfinite(loss), f"{name} FD+NKD loss {loss}")
        _check(proj == (C != student.cfg.widened_dims[-1]),
               f"{name}: fd_proj {proj} with {C} teacher channels")
        out[name] = row
        del teacher, fn, student, state, step, batches, kd
        torch.cuda.empty_cache()
    return out


def kd_cli():
    """(d): the KD CLI in process on the headline pair (NKD, bf16, one
    epoch of KD_STEPS steps at TRAIN_BATCH on synthetic 224^2 images
    through the recipe's host transforms, eval, checkpoint-0), counted."""
    import shutil
    import torch
    from slak_tpu_torch.kd.main import main, parse_args
    from slak_tpu_torch.models.slak import config_for
    out_dir = os.path.join(OUT_DIR, "kd_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    want = kd_counts(config_for("SLaK_tiny", **MODEL_KW),
                     config_for("convnext_tiny"), steps=KD_STEPS,
                     student_evals=1)
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        run = main(parse_args(KD_CLI_ARGS + ["--output_dir", out_dir]))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        ckpts = sorted(f for f in os.listdir(out_dir)
                       if f.startswith("checkpoint-"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    st = run["epochs"][0]
    print(f"[kd] CLI (kd/main.py, NKD, bf16, {KD_STEPS} steps at batch "
          f"{TRAIN_BATCH}): {sec:.1f} s; losses "
          f"{[round(v, 5) for v in run['step_losses']]}; "
          f"{st['images_per_sec']:.1f} img/s with the loader feeding over a "
          f"{KD_STEPS}-step epoch (mostly the loader's start, not a "
          f"sustained rate); val images {st['test_images']}; checkpoints "
          f"{ckpts}; launches {counts}", flush=True)
    _check(counts == want, f"kd CLI launch counts {counts}, want {want}")
    _check(len(run["step_losses"]) == KD_STEPS and all(
        math.isfinite(v) for v in run["step_losses"]), "kd CLI losses")
    _check(ckpts == ["checkpoint-0"], f"kd CLI checkpoints {ckpts}")
    return dict(seconds=sec, images_per_sec=st["images_per_sec"],
                losses=run["step_losses"], counts=counts)


def _kd_rank(ref_dir):
    """One rank of (e): one bf16 MGD step of the headline pair on this
    rank's shard of TRAIN_BATCH images against the one-process step in
    ref_dir; the heads and every gradient the same on every rank."""
    import torch
    from slak_tpu_torch.kd.engine import make_kd_train_step, make_teacher_apply
    from slak_tpu_torch.parallel import mesh
    group = mesh.axis_group()
    tapply = make_teacher_apply(kd_teacher())
    (student, state, kd, kopt, tc, cfg, _, lr, batches) = kd_setup(
        tapply, "MGD", TRAIN_BATCH, kd_student_state(), group=group)
    step = make_kd_train_step(student, tapply, cfg, tc, None, lr,
                              group=group)
    state, kd, kopt, met = step(state, kd, kopt, batches[0],
                                torch.Generator(device="cuda").manual_seed(5))
    got = kd_snapshot(student, kd, met)
    n = _same_on_ranks(got["grads"], "KD gradients")
    n += _same_on_ranks(dict(kd.named_parameters()), "kd_params")
    want = torch.load(os.path.join(ref_dir, "kd_step.pt"),
                      map_location="cuda", weights_only=False)
    return dict(errors=kd_errors(got, want), same=n)


def kd_launch():
    """(e): the KD CLI through `launch --kd --nproc DP_RANKS` (gloo, one
    card) against the one-process CLI fed the ranks' batches concatenated
    (first loss within TOL_STEP), then one MGD step on DP_RANKS gloo ranks
    against the one-process step."""
    import shutil
    import tempfile
    import torch
    from slak_tpu_torch import data
    from slak_tpu_torch.kd.engine import make_kd_train_step, make_teacher_apply
    from slak_tpu_torch.kd.main import main, parse_args
    from slak_tpu_torch.train import launch
    from slak_tpu_torch.train.launch import run_ranks
    out_dir = os.path.join(OUT_DIR, "kd_launch")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = list(KD_CLI_ARGS)
    argv[argv.index("--batch_size") + 1] = str(TRAIN_BATCH // DP_RANKS)
    try:
        t0 = time.perf_counter()
        two = launch.main(["--kd", "--nproc", str(DP_RANKS), "--timeout",
                           str(DP_TIMEOUT), "--"] + argv
                          + ["--dist_backend", "gloo", "--output_dir",
                             out_dir])
        sec2 = time.perf_counter() - t0
        ckpts = sorted(f for f in os.listdir(out_dir)
                       if f.startswith("checkpoint-"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    base = data.BatchLoader

    def loader(ds, batch_size, shuffle=True, **kw):
        if shuffle:
            return RankBatches(ds, batch_size, shuffle=True, **kw)
        return base(ds, batch_size, shuffle=shuffle, **kw)
    data.BatchLoader = loader
    try:
        one = main(parse_args(KD_CLI_ARGS + ["--save_ckpt", "false"]))
    finally:
        data.BatchLoader = base
    l2, l1 = two["step_losses"][0], one["step_losses"][0]
    cli_le = abs(l2 - l1) / abs(l1)
    print(f"[kd] (e) the KD CLI through launch --kd --nproc {DP_RANKS} "
          f"({GLOO}): {sec2:.1f} s; losses "
          f"{[round(v, 5) for v in two['step_losses']]}; the one-process CLI"
          f" on the same batches {[round(v, 5) for v in one['step_losses']]}"
          f"; first step rel {cli_le:.3g} (tol "
          f"{TOL_STEP['bfloat16']['loss']});"
          f" val images {two['epochs'][0]['test_images']}; checkpoints "
          f"{ckpts}", flush=True)
    _check(cli_le <= TOL_STEP["bfloat16"]["loss"], f"KD CLI first step "
           f"loss rel err {cli_le:.3g}")
    _check(ckpts == ["checkpoint-0"], f"launched KD CLI checkpoints {ckpts}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="slak_kd_") as tmp:
        teacher = kd_teacher()
        tapply = make_teacher_apply(teacher)
        (student, state, kd, kopt, tc, cfg, _, lr, batches) = kd_setup(
            tapply, "MGD", TRAIN_BATCH, kd_student_state())
        step = make_kd_train_step(student, tapply, cfg, tc, None, lr)
        state, kd, kopt, met = step(
            state, kd, kopt, batches[0],
            torch.Generator(device="cuda").manual_seed(5))
        torch.save(kd_snapshot(student, kd, met),
                   os.path.join(tmp, "kd_step.pt"))
        del teacher, tapply, student, state, step, batches, kd
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = run_ranks(_kd_rank, DP_RANKS, (tmp,), "gloo", None,
                        DP_TIMEOUT, DP_TIMEOUT)
        sec = time.perf_counter() - t0
    tol = TOL_STEP["bfloat16"]
    for r, out in enumerate(res):
        le, ge, worst = out["errors"]
        print(f"[kd] (e) rank {r} of {DP_RANKS} ({GLOO}), one bf16 MGD step "
              f"at {TRAIN_BATCH // DP_RANKS} a rank vs one process at "
              f"{TRAIN_BATCH}: loss rel {le:.3g} (tol {tol['loss']}); grad "
              f"rel norm err max {ge:.3g} ({worst}, tol {tol['grad']}); "
              f"{out['same']} gradients and heads the same on every rank; "
              f"{sec:.1f} s", flush=True)
        _check(le <= tol["loss"], f"KD rank {r} loss rel err {le:.3g}")
        _check(ge <= tol["grad"], f"KD rank {r} grad {worst} rel err "
               f"{ge:.3g}")
    return dict(cli_seconds=sec2, first_loss_rel=cli_le,
                step=[out["errors"][:2] for out in res])


def phase_kd():
    """(b) the headline KD path, (c) the teacher zoo, (d) the KD CLI, (e)
    the launcher."""
    import torch
    t0 = time.perf_counter()
    teacher = kd_teacher()
    sd0 = kd_student_state()
    run = {"headline": kd_headline(teacher, sd0)}
    del teacher
    torch.cuda.empty_cache()
    tb = time.perf_counter()
    run["zoo"] = kd_zoo(sd0)
    tc = time.perf_counter()
    run["cli"] = kd_cli()
    td = time.perf_counter()
    run["launch"] = kd_launch()
    te = time.perf_counter()
    print(f"[kd] times: (b) {tb - t0:.1f} s, (c) {tc - tb:.1f} s, (d) "
          f"{td - tc:.1f} s, (e) {te - td:.1f} s", flush=True)
    return run


def add_kd_launches(kernels, kd_totals, kd_run):
    """Each kernel row's launches in `kd`'s KD_STEPS counted steps, and K8's
    and K9's times at ConvNeXt-T's widths (`kd_kernels`); a row that no
    earlier phase made (a run of the KD phases alone) is made here."""
    c = None if kd_run is None else kd_run["headline"]["counts"]
    per = {"dwconv": None if c is None else
           c["dwconv"] - c["dwconv_toeplitz"],
           "dwconv2d": None if c is None else c["dwconv_toeplitz"],
           "fused_mlp": None if c is None else c["fused_mlp"],
           "mlp_bwd": None if c is None else c["mlp_bwd"],
           "mlp_bwd_wide": None if c is None else c["mlp_bwd_wide"]}
    names = {k["name"] for k in kernels}
    for name, src, repl in (
            ("mlp_bwd", "slak_tpu_torch/ops/csrc/mlp_bwd.cu",
             "slak_tpu/ops/pallas_mlp.py:263"),
            ("mlp_bwd_wide", "slak_tpu_torch/ops/csrc/mlp_bwd.cu",
             "slak_tpu/ops/pallas_mlp.py:419")):
        if kd_totals is None or name in names:
            continue
        t = kd_totals[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=per[name], max_abs_err=t["err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by="bytes" if t["bytes_ms"] >= t["ops_ms"] else
            "operations", library_ms=None,
            unfused_torch_ms=t["unfused_torch_ms"],
            times_per="the ConvNeXt-T tails of one bf16 KD step at batch %d"
            % TRAIN_BATCH,
            launches_in="the KD path: %d bf16 steps at batch %d"
            % (KD_STEPS, TRAIN_BATCH)))
    for k in kernels:
        if k["name"] in per and kd_run is not None:
            k["kd_launches"] = per[k["name"]]
            k["kd_launches_in"] = ("kd: %d sparse bf16 NKD steps at batch %d,"
                                   " SLaK-T 51x51 w1.3 teacher (eval), "
                                   "ConvNeXt-T student (train)"
                                   % (KD_STEPS, TRAIN_BATCH))
        if k["name"] in ("mlp_bwd", "mlp_bwd_wide") and kd_totals:
            t = kd_totals[k["name"]]
            k["kd_convnext_t"] = dict(
                {f: t[f] for f in ("ms", "plain_ms", "unfused_torch_ms",
                                   "bound_ms")}, max_abs_err=t["err"],
                times_per="the ConvNeXt-T tails of one bf16 step at batch "
                "%d (C = %s)" % (TRAIN_BATCH, "96, 192" if k["name"] ==
                                 "mlp_bwd" else "384, 768"))


# ---------------------------------------------------------------------------
# downstream transfer: UperNet segmentation and Cascade Mask R-CNN detection
# on the flagship backbone at the recipes' shapes

SEG_RECIPE = "upernet_slak_tiny_512_80k_ade20k"
SEG_BATCH, SEG_CROP = 8, 512                # the reference's 8 a GPU
DET_RECIPE = "cascade_mask_rcnn_slak_tiny_3x_coco"
DET_BATCH, DET_SIZE, DET_GTS = 2, 800, 8    # det_main's defaults
DS_CLI_STEPS = 3                            # then one resumed step
DS_EVAL_BATCHES = 2
DS_TIMED_STEPS = 2
# the routes each stage's K1, K4 and weight gradient take, by map size
# (ops/dwconv.py BAND_MAX = P_MAX = 64): bf16 seg at 512^2 (128/64/32/16)
# stage 1 on the tiled kernels, stages 2-4 on the band kernels, no K6;
# fp32 det at 800^2 (200/100/50/25) K1 and its dgrad on the fp32 band
# kernel, K4 and the weight gradient on the tiled kernels
SEG_ROUTES = {k: ["tiled", "band", "band", "band"]
              for k in ("dwconv", "dwconv_stats", "dwconv_wgrad")}
DET_ROUTES = {"dwconv": ["band_f32"] * 4, "dwconv_stats": ["tiled"] * 4,
              "dwconv_wgrad": ["tiled"] * 4}


def downstream_counts(cfg, size, dtype, steps=0, evals=0):
    """(read_counts' keys -> the launches of `steps` train steps and `evals`
    eval forwards of the flagship backbone at `size`^2; {kernel: each
    stage's route}, as the routers pick them for empty tensors of the
    stage's shapes): per block a step launches K4 twice, the K1 dgrad
    twice, the weight gradient twice, K2 once and K8 (C <= 256) or K9
    once; an eval forward the K1 pair and K2/K3 once."""
    import torch
    from slak_tpu_torch.models import slak as S
    from slak_tpu_torch.ops import dwconv as K1
    from slak_tpu_torch.ops.mlp import BWD_C_MAX
    c = dict.fromkeys(read_counts(), 0)
    routes = {"dwconv": [], "dwconv_stats": [], "dwconv_wgrad": []}
    for i, C, H, K, s, d in stage_shapes(cfg, size):
        x = torch.empty(1, C, H, H, dtype=dtype, device="meta")
        w = torch.empty(C, K, s, device="meta")
        r1, r4, rw = (route_of(x, w), K1._stats_route_of(x, w),
                      wgrad_route_of(x, K, s))
        for k, r in zip(routes, (r1, r4, rw)):
            routes[k].append(r)
        k1, k2 = 2 * d * (steps + evals), 2 * d * steps
        c["dwconv"] += k1
        c["dwconv_band"] += k1 * (r1 == "band")
        c["dwconv_toeplitz"] += k1 * (r1 == "toeplitz2d")
        c["dwconv_tf32"] += k1 * (r1 == "band_f32")
        c["dwconv_stats"] += k2
        c["dwconv_stats_band"] += k2 * (r4 == "band")
        c["dwconv_stats_toeplitz"] += k2 * (r4 == "toeplitz2d")
        c["dwconv_wgrad"] += k2
        c["dwconv_wgrad_band"] += k2 * (rw == "band")
        wide = C > BWD_C_MAX
        fused = d * steps * (not wide or S.TRAIN_WIDE_MLP_BWD) + d * evals
        c["fused_mlp"] += fused
        c["fused_mlp_tf32"] += fused * (dtype == torch.float32)
        c["mlp_bwd"] += d * steps * (not wide)
        c["mlp_bwd_wide"] += d * steps * (wide and S.TRAIN_WIDE_MLP_BWD)
    return c, routes


def downstream_kernels(tag, cfg, batch, size, dtype):
    """Every kernel of the seg / det path against its plain version at the
    path's own stage shapes (the backbone at `size`^2, `batch` images;
    ``stage_kernel_rows``, the plain versions and library calls timed
    over 3 launches a round). Returns the per-step sums by kernel (a train
    step: K4, the weight gradient, the dgrad, K2, K8 / K9; an eval
    forward: the pair, K2/K3), each stage's time weighted by its depth."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(19)
    tot = {}
    for i, C, H, K, s, depth in stage_shapes(cfg, size):
        rows = stage_kernel_rows(f"{tag}_kernels", ("pair", "stats", "wgrad",
                                                    "dgrad", "mlp", "mlp_bwd"),
                                 i, C, H, K, s, depth, batch, dtype, g,
                                 plain_reps=3)
        for kind, name in (("pair", "dwconv_pair"), ("stats", "dwconv_stats"),
                           ("wgrad", "dwconv_wgrad"),
                           ("dgrad", "dwconv_dgrad"), ("mlp", "fused_mlp")):
            add_total(tot, name, rows[kind][0], depth)
        row = rows["mlp_bwd"][0]
        add_total(tot, row["kernel"], row, depth)
        torch.cuda.empty_cache()
    return tot


def _ds_snapshot(model):
    """Loss-free step state: every gradient (fp32) and BN running stat."""
    return ({n: p.grad.detach().float().clone()
             for n, p in model.named_parameters() if p.grad is not None},
            {n: v.clone() for n, v in model.state_dict().items()
             if "running" in n})


def _ds_compare(tag, dn, loss_k, loss_p, snap_k, snap_p):
    """One step, kernel route against plain route, within TOL_STEP:
    (loss rel err, worst gradient's relative norm error and its name, BN
    running stats' rel err)."""
    tol = TOL_STEP[dn]
    le = abs(loss_k - loss_p) / abs(loss_p)
    gk, bk = snap_k
    gp, bp = snap_p
    ge = {n: ((gk[n] - w).norm() / w.norm().clamp(min=1e-30)).item()
          for n, w in gp.items() if w.norm().item() > 0}
    worst = max(ge, key=ge.get)
    be = max(rel_err(bk[n], w)[1] for n, w in bp.items())
    top = sorted(ge, key=ge.get, reverse=True)[:8]
    print(f"[{tag}] worst gradients (rel err, norm): " + json.dumps(
        {n: [ge[n], gp[n].norm().item()] for n in top}), flush=True)
    print(f"[{tag}] one {dn} step, kernels vs plain: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (rel {le:.3g}, tol {tol['loss']}); grad rel norm "
          f"err max {ge[worst]:.3g} ({worst}), median "
          f"{statistics.median(ge.values()):.3g} (tol {tol['grad']}); BN "
          f"running stats rel {be:.3g} (tol {tol['bn']})", flush=True)
    _check(le <= tol["loss"], f"{tag} step loss rel err {le:.3g}")
    _check(ge[worst] <= tol["grad"], f"{tag} grad {worst} rel err "
           f"{ge[worst]:.3g}")
    _check(be <= tol["bn"], f"{tag} BN stats rel err {be:.3g}")
    return dict(loss_rel=le, grad_rel_norm_max=ge[worst], grad_worst=worst,
                grad_rel_norm_median=statistics.median(ge.values()),
                bn_rel=be)


def _state_tensors(model, opt):
    """Every model and optimizer-state tensor, cloned on the card."""
    import torch
    out = {"model." + n: v.detach().clone()
           for n, v in model.state_dict().items()}
    for i, st in opt.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v.detach().clone()
                    for k, v in st.items() if torch.is_tensor(v)})
    return out


def _ds_cli(tag, mod, argv, steps_arg, counts_for):
    """The CLI in process: an uninterrupted run of DS_CLI_STEPS + 1 steps
    (no checkpoint), a run of DS_CLI_STEPS steps and its resumed step in
    one directory, then --eval over DS_EVAL_BATCHES batches, each with the
    launch counters set to 0 just before and read just after and held to
    `counts_for(steps, evals)`. The runs go under
    torch.use_deterministic_algorithms (the kernels give the same bits
    twice; PyTorch's atomics-based backwards take their deterministic
    forms), so the state the resumed run's step starts from (the step
    hook, before the step) must be, bit for bit, the state the
    uninterrupted run's step of that iteration starts from. Returns
    {run: seconds, launches, stats}."""
    import shutil
    import tempfile
    import torch
    parser = argparse.ArgumentParser(parents=[mod.get_seg_args_parser()
                                              if tag == "seg" else
                                              mod.get_det_args_parser()])
    seen = {}

    def hook(model, opt, it):
        if it == DS_CLI_STEPS:
            seen[run] = _state_tensors(model, opt)

    out, runs = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_"), {}
    torch.use_deterministic_algorithms(True)
    try:
        for run, extra, steps, evals in (
                ("uninterrupted", [steps_arg, str(DS_CLI_STEPS + 1)],
                 DS_CLI_STEPS + 1, 0),
                ("first", [steps_arg, str(DS_CLI_STEPS), "--output_dir",
                           out], DS_CLI_STEPS, 0),
                ("resumed", [steps_arg, str(DS_CLI_STEPS + 1),
                             "--output_dir", out], 1, 0),
                ("eval", ["--eval", "--eval_batches", str(DS_EVAL_BATCHES),
                          "--output_dir", out], 0, DS_EVAL_BATCHES)):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            stats = mod.main(parser.parse_args(argv + extra), hook)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = read_counts()
            want, _ = counts_for(steps, evals)
            _check(counts == want, f"{tag} CLI {run}: launch counts "
                   f"{counts}, want {want}")
            runs[run] = dict(seconds=sec, steps=steps, evals=evals,
                             launches=counts, stats=stats)
            print(f"[{tag}] CLI {run}: {sec:.1f} s, {json.dumps(stats)}",
                  flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(out, ignore_errors=True)
    a, b = seen["uninterrupted"], seen["resumed"]
    _check(a.keys() == b.keys(), f"{tag} CLI: the resumed run's state "
           f"holds {sorted(set(a) ^ set(b))[:5]} the uninterrupted one's "
           f"does not, or the other way round")
    bad = [k for k in a if a[k].device != b[k].device
           or not torch.equal(a[k], b[k])]
    _check(not bad, f"{tag} CLI: the resumed step's state differs from the "
           f"uninterrupted run's: {bad[:5]}")
    print(f"[{tag}] CLI resume: {len(a)} tensors the uninterrupted run's "
          f"bits", flush=True)
    return runs


def phase_seg(cfg):
    """`seg`: (e) the kernels at the 512^2 crop's shapes, (a) one bf16
    train step on the kernel route against the plain route, (b) its launch
    counts, (d) step ms on both routes and the peak memory, (c) the CLI:
    train, resume, eval."""
    import torch
    from slak_tpu_torch.downstream import seg_main as SM
    from slak_tpu_torch.downstream.configs import SEG_CONFIGS, poly_schedule
    t_start = time.perf_counter()
    dtype = torch.bfloat16
    dev = torch.device("cuda")
    recipe = SEG_CONFIGS[SEG_RECIPE]
    bcfg = recipe.backbone.model
    _, routes = downstream_counts(bcfg, SEG_CROP, dtype, 1)
    _check(routes == SEG_ROUTES, f"seg routes {routes}, want {SEG_ROUTES}")
    kern = downstream_kernels("seg", bcfg, SEG_BATCH, SEG_CROP, dtype)
    t_kern = time.perf_counter()
    lr_arr = poly_schedule(recipe.lr, 1000, 0, recipe.warmup_ratio)
    x, y = SM._synthetic_seg_batch(SM.iter_rng(0, 0), SEG_BATCH, SEG_CROP,
                                   recipe.num_classes)
    res, snaps = {}, {}
    for plain in (False, True):
        model = SM.build_seg(recipe, dev, 0)
        opt = SM.make_seg_optimizer(model, recipe)
        step = SM.make_seg_train_step(model, opt, recipe, lr_arr, dtype,
                                      plain)
        gen = torch.Generator(device=dev)
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        loss, gnorm, _ = step(0, x, y, gen.manual_seed(7))
        torch.cuda.synchronize()
        counts = read_counts()
        route = "plain" if plain else "kernels"
        want = downstream_counts(bcfg, SEG_CROP, dtype, 0 if plain else 1)[0]
        _check(counts == want, f"seg {route} step: launch counts {counts}, "
               f"want {want}")
        snaps[route] = (loss.item(), _ds_snapshot(model))
        res[route] = dict(
            loss=loss.item(), grad_norm=gnorm.item(), launches=counts,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            step_ms=time_ms(lambda: step(1, x, y, gen.manual_seed(8)),
                            DS_TIMED_STEPS, warmup=1, rounds=2))
        print(f"[seg] {route}: " + json.dumps(res[route]), flush=True)
        del model, opt, step
        torch.cuda.empty_cache()
    res["compare"] = _ds_compare("seg", "bfloat16", snaps["kernels"][0],
                                 snaps["plain"][0], snaps["kernels"][1],
                                 snaps["plain"][1])
    del snaps
    t_step = time.perf_counter()
    argv = ["--recipe", SEG_RECIPE, "--batch_size", str(SEG_BATCH),
            "--crop_size", str(SEG_CROP), "--use_bf16", "true",
            "--log_every", "1", "--save_every", "1000"]
    cli = _ds_cli("seg", SM, argv, "--max_iters",
                  lambda s, e: downstream_counts(bcfg, SEG_CROP, dtype, s, e))
    ev = cli["eval"]["stats"]
    for k in ("mIoU", "mAcc", "aAcc"):
        _check(math.isfinite(ev[k]) and 0.0 <= ev[k] <= 1.0,
               f"seg eval {k} {ev[k]}")
    import numpy as np
    pixels = 0
    rng = np.random.default_rng(0)
    for _ in range(DS_EVAL_BATCHES):
        pixels += int((SM._synthetic_seg_batch(rng, SEG_BATCH, SEG_CROP,
                                               recipe.num_classes)[1]
                       != 255).sum())
    _check(ev["pixels"] == pixels, f"seg eval: the confusion matrix counts "
           f"{ev['pixels']} pixels, the labels have {pixels} not ignored")
    t_end = time.perf_counter()
    sec = dict(kernels=t_kern - t_start, step=t_step - t_kern,
               cli=t_end - t_step, total=t_end - t_start)
    print(f"[seg] seconds: " + json.dumps(sec), flush=True)
    return dict(kernels=kern, step=res, cli=cli, seconds=sec)


def _nms_ms(k, dev):
    """CUDA-event ms of one nms_fixed over k score-sorted random boxes
    (the RPN's k = 2 x 512)."""
    import torch
    from slak_tpu_torch.downstream.detection import nms_fixed
    g = torch.Generator(device=dev).manual_seed(3)
    xy = torch.rand(k, 2, generator=g, device=dev) * 700
    boxes = torch.cat([xy, xy + 20 + torch.rand(k, 2, generator=g,
                                                device=dev) * 200], 1)
    scores = torch.sort(torch.rand(k, generator=g, device=dev),
                        descending=True)[0]
    return time_ms(lambda: nms_fixed(boxes, scores, 0.7, 512), 2, warmup=1,
                   rounds=3)


def _det_grads(model, batch, hw, hcfg, plain, gen, feats_in=None,
               g_feats=None, draws=None):
    """The det step's forward and backward without the optimizer: the
    backbone on `plain`'s route, cascade_loss on detached copies of its
    features (or of `feats_in`), then the backbone's backward from the
    loss's feature gradients (or from `g_feats`). Returns (loss, losses,
    cascade_loss's info, the backbone's features, the loss's feature
    gradients)."""
    import torch
    from slak_tpu_torch.downstream.detection import cascade_loss
    x, gb, gl, gv, gm = batch
    model.train()
    feats = model["backbone"](x, plain, gen)
    head_in = [f.detach().requires_grad_()
               for f in (feats if feats_in is None else feats_in)]
    tot, losses, info = cascade_loss(model["head"], head_in, gb, gl, gv, gm,
                                     hw, hcfg, train=True, generator=gen,
                                     draws=draws)
    tot.backward()
    g = [f.grad for f in head_in]
    torch.autograd.backward(list(feats), g if g_feats is None else g_feats)
    return (tot.item(), {k: v.item() for k, v in losses.items()}, info,
            [f.detach() for f in feats], g)


def phase_det(cfg):
    """`det`: (e) the kernels at the 800^2 shapes (fp32); (a) one fp32 step
    on the kernel route against the plain route from the same weights,
    batch and draws, under torch.use_deterministic_algorithms. The
    cascade's loss is not smooth in the features (the box clips, GIoU's
    corners, the level and sample boundaries): 1e-6 feature differences
    move its feature gradients by about 2e-3 (measured on one H100). So the
    two routes' backbones are held to each other through the chain rule:
    the heads run on the kernel route's features in both, and the plain
    backbone's backward starts from the kernel route's feature gradients;
    the backbone's gradients and BN stats within TOL_STEP. The head's
    gradients and BN stats are the same on both routes by construction, so
    they are left out of the comparison. The forward is held directly: the
    two routes' features within TOL_DET_FEATURES. The loss is held on each
    route's own features (the plain route's with the kernel route's draws;
    where its proposals differ, with the kernel route's boxes too). (b) the
    step's launch counts, (d) the step's ms on both routes (CUDA events),
    the peak memory and the NMS time, (c) the CLI: train, resume, eval
    (cascade_predict and coco_ap)."""
    import torch
    from slak_tpu_torch.downstream import det_main as DM
    from slak_tpu_torch.downstream.configs import DET_CONFIGS
    from slak_tpu_torch.downstream.detection import cascade_loss
    t_start = time.perf_counter()
    dtype = torch.float32
    dev = torch.device("cuda")
    recipe = DET_CONFIGS[DET_RECIPE]
    bcfg = recipe.backbone.model
    hcfg = DM._head_cfg(recipe, False)
    _, routes = downstream_counts(bcfg, DET_SIZE, dtype, 1)
    _check(routes == DET_ROUTES, f"det routes {routes}, want {DET_ROUTES}")
    kern = downstream_kernels("det", bcfg, DET_BATCH, DET_SIZE, dtype)
    t_kern = time.perf_counter()
    lr_arr = DM.step_lr_array(recipe.lr, 1000, recipe.epochs, 1000)
    batch = [t.to(dev) for t in DM._synthetic_det_batch(
        DM.iter_rng(0, 0), DET_BATCH, DET_SIZE, DET_GTS, hcfg.num_classes)]
    hw = (DET_SIZE, DET_SIZE)
    res, snaps = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        model_k = DM.build_det(recipe, hcfg, dev, 0)
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        loss_k, losses_k, info, feats_k, gf_k = _det_grads(
            model_k, batch, hw, hcfg, False,
            torch.Generator(device=dev).manual_seed(7))
        torch.cuda.synchronize()
        counts = read_counts()
        want = downstream_counts(bcfg, DET_SIZE, dtype, 1)[0]
        _check(counts == want, f"det kernel step: launch counts {counts}, "
               f"want {want}")
        res["kernels"] = dict(loss=loss_k, losses=losses_k, launches=counts,
                              peak_memory_gib=torch.cuda.max_memory_allocated()
                              / 2 ** 30)
        snaps["kernels"] = _ds_snapshot(model_k["backbone"])
        model_p = DM.build_det(recipe, hcfg, dev, 0)
        reset_counts()
        _det_grads(model_p, batch, hw, hcfg, True,
                   torch.Generator(device=dev).manual_seed(7), feats_k, gf_k,
                   info["draws"])
        torch.cuda.synchronize()
        _check(sum(read_counts().values()) == 0,
               f"det plain step launched {read_counts()}")
        snaps["plain"] = _ds_snapshot(model_p["backbone"])
        # the loss on the plain route's own features, the BN stats kept
        bn = {n: v.clone() for n, v in model_p.state_dict().items()
              if "running" in n}
        with torch.no_grad():
            feats_p = model_p["backbone"](batch[0], True,
                                          torch.Generator(device=dev)
                                          .manual_seed(7))
            own = cascade_loss(model_p["head"], feats_p, *batch[1:], hw,
                               hcfg, draws=info["draws"])
            differ = [int((~torch.isclose(a, b, rtol=0, atol=1e-3).all(-1))
                          .sum()) for a, b in zip(info["stage_proposals"],
                                                  own[2]["stage_proposals"])]
            if any(differ):
                own = cascade_loss(model_p["head"], feats_p, *batch[1:], hw,
                                   hcfg, draws=info["draws"],
                                   proposals=info["stage_proposals"])
        model_p.load_state_dict(bn, strict=False)
        feat_err = max(rel_err(a, b)[1] for a, b in zip(feats_k, feats_p))
        _check(feat_err <= TOL_DET_FEATURES, f"det features, kernels vs "
               f"plain: rel err {feat_err:.3g} > {TOL_DET_FEATURES}")
        res["plain"] = dict(loss=own[0].item(), losses={
            k: v.item() for k, v in own[1].items()},
            feature_rel_err=feat_err)
        res["proposals_differing_by_stage"] = differ
        print(f"[det] proposals that differ between the routes, by stage: "
              f"{differ} of {DET_BATCH} x {hcfg.num_proposals}; features "
              f"rel {feat_err:.3g}", flush=True)
        res["compare"] = _ds_compare("det", "float32", loss_k,
                                     res["plain"]["loss"], snaps["kernels"],
                                     snaps["plain"])
        del snaps, feats_k, gf_k, feats_p, own, info
    finally:
        torch.use_deterministic_algorithms(False)
    # (d) the train step (make_det_train_step: the optimizer too) on both
    # routes
    for route, model in (("kernels", model_k), ("plain", model_p)):
        opt = DM.make_det_optimizer(model, recipe)
        step = DM.make_det_train_step(model, opt, recipe, hcfg, lr_arr, hw,
                                      route == "plain")
        gen = torch.Generator(device=dev)
        torch.cuda.reset_peak_memory_stats()
        res[route]["step_ms"] = time_ms(
            lambda: step(1, batch, gen.manual_seed(8)), DS_TIMED_STEPS,
            warmup=1, rounds=2)
        res[route]["step_peak_memory_gib"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
        del opt, step
    del model_k, model_p
    torch.cuda.empty_cache()
    res["nms_ms"] = {f"k{k}": _nms_ms(k, dev) for k in (1024, 512)}
    res["nms_ms_per_train_step"] = DET_BATCH * res["nms_ms"]["k1024"]
    res["nms_ms_per_predict_batch"] = DET_BATCH * (res["nms_ms"]["k1024"]
                                                   + res["nms_ms"]["k512"])
    print("[det] steps: " + json.dumps(res), flush=True)
    t_step = time.perf_counter()
    argv = ["--recipe", DET_RECIPE, "--batch_size", str(DET_BATCH),
            "--img_size", str(DET_SIZE), "--num_gts", str(DET_GTS),
            "--log_every", "1", "--save_every", "1000"]
    cli = _ds_cli("det", DM, argv, "--steps",
                  lambda s, e: downstream_counts(bcfg, DET_SIZE, dtype, s, e))
    ev = cli["eval"]["stats"]
    for k, v in ev.items():
        _check(math.isfinite(v) and 0.0 <= v <= 1.0, f"det eval {k} {v}")
    t_end = time.perf_counter()
    sec = dict(kernels=t_kern - t_start, step=t_step - t_kern,
               cli=t_end - t_step, total=t_end - t_start)
    print(f"[det] seconds: " + json.dumps(sec), flush=True)
    return dict(kernels=kern, step=res, cli=cli, seconds=sec)


# the kernels line's rows by the downstream totals' names: (row name,
# totals, source, the TPU kernel, the library call)
_DS_ROWS = {
    "seg": (("dwconv", ("dwconv_pair", "dwconv_dgrad"),
             "slak_tpu_torch/ops/csrc/dwconv.cu",
             "slak_tpu/ops/pallas_banded.py:168", "F.conv2d(groups=C)"),
            ("dwconv_stats", ("dwconv_stats",),
             "slak_tpu_torch/ops/csrc/dwconv.cu",
             "slak_tpu/ops/pallas_banded.py:251",
             "F.conv2d(groups=C) + sum + sum of squares"),
            ("dwconv_wgrad", ("dwconv_wgrad",),
             "slak_tpu_torch/ops/csrc/dwconv_wgrad.cu",
             "slak_tpu/ops/pallas_banded.py:888",
             "torch.nn.grad.conv2d_weight(groups=C)"),
            ("fused_mlp", ("fused_mlp",), "slak_tpu_torch/ops/csrc/mlp.cu",
             "slak_tpu/ops/pallas_mlp.py:527", None),
            ("mlp_bwd", ("mlp_bwd",), "slak_tpu_torch/ops/csrc/mlp_bwd.cu",
             "slak_tpu/ops/pallas_mlp.py:263", None),
            ("mlp_bwd_wide", ("mlp_bwd_wide",),
             "slak_tpu_torch/ops/csrc/mlp_bwd.cu",
             "slak_tpu/ops/pallas_mlp.py:419", None)),
}
_DS_ROWS["det"] = tuple(
    (("dwconv_f32", r[1], "slak_tpu_torch/ops/csrc/dwconv_f32.cu") + r[3:])
    if r[0] == "dwconv" else r for r in _DS_ROWS["seg"])


def add_downstream(kernels, seg_run, det_run):
    """Each kernel row's launches in the seg / det CLI's uninterrupted run
    and its per-step sums at the recipe's shapes (`seg_512`, `det_800`); a
    row that no earlier phase made is made here from them."""
    for tag, run, key, what in (
            ("seg", seg_run, "seg_512", "the 512^2 crop, bf16, batch %d"
             % SEG_BATCH),
            ("det", det_run, "det_800", "800^2, fp32, batch %d"
             % DET_BATCH)):
        if run is None:
            continue
        c = run["cli"]["uninterrupted"]["launches"]
        steps = run["cli"]["uninterrupted"]["steps"]
        launches = {
            "dwconv": c["dwconv"] - c["dwconv_tf32"] - c["dwconv_toeplitz"],
            "dwconv_f32": c["dwconv_tf32"],
            "dwconv_stats": c["dwconv_stats"],
            "dwconv_wgrad": c["dwconv_wgrad"], "fused_mlp": c["fused_mlp"],
            "mlp_bwd": c["mlp_bwd"], "mlp_bwd_wide": c["mlp_bwd_wide"]}
        for name, parts, src, repl, lib in _DS_ROWS[tag]:
            ts = [run["kernels"][p] for p in parts]
            agg = {k: sum(t[k] for t in ts) for k in TOTAL_KEYS}
            err = max(t["err"] for t in ts)
            extra = {"routes": {p: run["kernels"][p]["routes"]
                                for p in parts},
                     "launches": launches[name], "max_abs_err": err,
                     "times_per": "one train step at %s%s" % (what, (
                         " (the dgrad) and one eval forward (the pair)"
                         if name in ("dwconv", "dwconv_f32") else "")),
                     "launches_in": "the %s CLI: %d train steps at %s"
                     % (tag, steps, what)}
            extra.update({k: agg[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bytes_ms", "ops_ms")},
                         bound_by="bytes" if agg["bytes_ms"] >= agg["ops_ms"]
                         else "operations")
            if lib is None:
                extra["unfused_torch_ms"] = agg["unfused_torch_ms"]
            else:
                extra["library_ms"] = agg["library_ms"]
            row = next((k for k in kernels if k["name"] == name), None)
            if row is None:
                row = dict(name=name, route="cuda", source=src,
                           replaces=repl, launches=launches[name],
                           max_abs_err=err, ms=agg["ms"],
                           plain_ms=agg["plain_ms"],
                           bound_ms=agg["bound_ms"],
                           bound_by=extra["bound_by"],
                           library_ms=agg["library_ms"] if lib else None,
                           **({} if lib else {
                               "unfused_torch_ms": agg["unfused_torch_ms"]}),
                           times_per=extra["times_per"],
                           launches_in=extra["launches_in"])
                kernels.append(row)
            row[key] = extra
            row[f"{tag}_launches"] = launches[name]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="build,kernels,forward,timing,"
                    "train_kernels,train,train_timing,cli,erf_kernels,erf,"
                    "dual_kernels,dual,dual_timing,probes,dp,tp,kd_kernels,"
                    "kd,seg,det")
    ap.add_argument("--base", help="mlp_ab, mlp_bwd_ab, dwconv_ab, "
                    "wgrad_ab, dwpair_ab, stacked_ab: another checkout of "
                    "the repository (e.g. the "
                    "parent commit from git archive, in a git-ignored "
                    "directory)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    # cuBLAS's deterministic workspace, read when its first handle is made:
    # the seg / det CLI runs go under torch.use_deterministic_algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from slak_tpu_torch.models.slak import config_for
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    cfg = config_for("SLaK_tiny", **MODEL_KW)
    totals, counts, counts_fp32 = None, None, None
    train_totals, train_counts, cli_runs = None, None, None
    erf_totals, k9_bf16, erf_run = None, None, None
    dual_totals, dual_counts, dual_by, probe_counts = None, None, None, None
    dp_run, tp_run, kd_totals, kd_rows, kd_run = None, None, None, None, None
    seg_run, det_run = None, None
    t_start = time.perf_counter()
    try:
        if "build" in phases:
            phase_build(ptxas=True)
        if "kernels" in phases:
            totals = phase_kernels(cfg, MAIN_BATCH)
        model = None
        if "forward" in phases:
            model, counts, counts_fp32 = phase_forward(MAIN_BATCH)
        if "timing" in phases:
            if model is None:
                from slak_tpu_torch.models import create_model
                model = create_model("SLaK_tiny", dtype=torch.bfloat16,
                                     **MODEL_KW)
            phase_timing(model, TIMING_BATCH)
        if "profile" in phases:
            if model is None:
                from slak_tpu_torch.models import create_model
                model = create_model("SLaK_tiny", dtype=torch.bfloat16,
                                     **MODEL_KW)
            phase_profile(model, TIMING_BATCH)
        del model
        torch.cuda.empty_cache()
        if "train_kernels" in phases:
            train_totals, k9_bf16 = phase_train_kernels(cfg, TRAIN_BATCH)
        if "train" in phases:
            train_counts = phase_train(TRAIN_BATCH)
        if "train_timing" in phases:
            phase_train_timing(TRAIN_BATCH)
        if "cli" in phases:
            cli_runs = phase_cli()
        if "profile" in phases:
            phase_profile_train(TRAIN_BATCH)
        if "erf_kernels" in phases:
            erf_totals = phase_erf_kernels(cfg)
        if "erf" in phases:
            erf_run = phase_erf()
        if "dual_kernels" in phases:
            dual_totals = phase_dual_kernels(cfg, MAIN_BATCH)
        if "dual" in phases:
            dual_counts = phase_dual(MAIN_BATCH)
        if "dual_timing" in phases:
            dual_by = phase_dual_timing(TIMING_BATCH)
        if "probes" in phases:
            probe_counts = phase_probes()
        if "dp" in phases:
            dp_run = phase_dp()
        if "tp" in phases:
            tp_run = phase_tp()
        if "kd_kernels" in phases:
            kd_totals, kd_rows = phase_kd_kernels(TRAIN_BATCH)
        if "kd" in phases:
            kd_run = phase_kd()
        if "seg" in phases:
            seg_run = phase_seg(cfg)
            torch.cuda.empty_cache()
        if "det" in phases:
            det_run = phase_det(cfg)
            torch.cuda.empty_cache()
        if "mlp_ab" in phases:
            _check(args.base is not None, "mlp_ab needs --base")
            phase_mlp_ab(cfg, args.base)
        if "mlp_bwd_ab" in phases:
            _check(args.base is not None, "mlp_bwd_ab needs --base")
            phase_mlp_bwd_ab(cfg, args.base)
        if "dwconv_ab" in phases:
            _check(args.base is not None, "dwconv_ab needs --base")
            phase_dwconv_ab(cfg, args.base)
        if "wgrad_ab" in phases:
            _check(args.base is not None, "wgrad_ab needs --base")
            phase_wgrad_ab(cfg, args.base)
        if "dwpair_ab" in phases:
            _check(args.base is not None, "dwpair_ab needs --base")
            phase_dwpair_ab(cfg, args.base)
        if "stacked_ab" in phases:
            _check(args.base is not None, "stacked_ab needs --base")
            phase_stacked_ab(cfg, args.base)
    except Exception as e:                      # report and fail the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    kernels = []
    if totals is not None:
        for name, src, repl, extra in (
                ("dwconv", "slak_tpu_torch/ops/csrc/dwconv.cu",
                 "slak_tpu/ops/pallas_banded.py:168", {}),
                ("fused_mlp", "slak_tpu_torch/ops/csrc/mlp.cu",
                 "slak_tpu/ops/pallas_mlp.py:527",
                 {"also_replaces": "slak_tpu/ops/pallas_mlp.py:149"})):
            t = totals[name]
            kernels.append(dict(
                name=name, route="cuda", source=src, replaces=repl,
                # dwconv.cu's: K1's launches less those on K6's kernel
                launches=None if counts is None else
                counts[0] - counts[5] if name == "dwconv" else counts[1],
                max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"],
                bound_by=("bytes" if t["bytes_ms"] >= t["ops_ms"]
                          else "operations"),
                library_ms=t["library_ms"] if name == "dwconv" else None,
                **extra,
                **({"unfused_torch_ms": t["unfused_torch_ms"]}
                   if name == "fused_mlp" else {}),
                **({"band_route": BAND_ROUTE,
                    "band_launches": None if counts is None else counts[2],
                    "train_band_launches": None if train_counts is None
                    else train_counts["dwconv_band"]}
                   if name == "dwconv" else {}),
                train_launches=None if train_counts is None
                else train_counts[name] - (train_counts["dwconv_toeplitz"]
                                           if name == "dwconv" else 0),
                times_per="one bf16 forward at batch %d" % MAIN_BATCH
                + (" (stages 1-3)" if name == "dwconv" else ""),
                launches_in="the eval path: %d bf16 forwards at batch %d"
                % (N_BATCHES, MAIN_BATCH)))
        if train_totals is not None:
            # K1 as the train step's dgrad, per bf16 step at TRAIN_BATCH
            t = train_totals["dwconv_dgrad"]
            kernels[0].update(
                {"train_" + k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                              "bound_ms")},
                train_max_abs_err=t["err"],
                train_times_per="the dgrad launches of one bf16 train step "
                "at batch %d" % TRAIN_BATCH)
    if totals is not None:
        # K6: the 7x7 maps' eval pair, K4 and dgrad on the Toeplitz kernel
        t = totals["dwconv2d"]
        k6 = dict(
            name="dwconv2d", route="cuda",
            source="slak_tpu_torch/ops/csrc/dwconv2d.cu",
            replaces="slak_tpu/ops/pallas_banded.py:753",
            launches=None if counts is None else counts[5],
            max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"],
            bound_by=("bytes" if t["bytes_ms"] >= t["ops_ms"]
                      else "operations"),
            library_ms=t["library_ms"], library="F.conv2d(groups=C)",
            band_route_ms=t["band_ms"], toeplitz_route=TOEPLITZ_ROUTE,
            times_per="one bf16 forward at batch %d (stage 4's pairs)"
            % MAIN_BATCH,
            launches_in="the eval path: %d bf16 forwards at batch %d"
            % (N_BATCHES, MAIN_BATCH))
        if train_totals is not None:
            for use in ("stats", "dgrad"):
                u = train_totals["dwconv2d_" + use]
                k6[f"train_{use}"] = {f: u[f] for f in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "band_ms")}
                k6["train_max_abs_err"] = max(k6.get("train_max_abs_err",
                                                     0.0), u["err"])
            k6["train_times_per"] = ("the stage-4 K4 (library: F.conv2d + "
                                     "the two sums) and dgrad launches of "
                                     "one bf16 train step at batch %d"
                                     % TRAIN_BATCH)
        if train_counts is not None:
            k6["train_launches"] = {
                "dwconv_stats": train_counts["dwconv_stats_toeplitz"],
                "dwconv_dgrad": train_counts["dwconv_toeplitz"]}
        kernels.append(k6)
    if train_totals is not None:
        for name, src, repl, extra in (
                ("dwconv_stats", "slak_tpu_torch/ops/csrc/dwconv.cu",
                 "slak_tpu/ops/pallas_banded.py:251",
                 {"library": "F.conv2d(groups=C) + sum + sum of squares",
                  "band_route": BAND_ROUTE,
                  "band_launches": None if train_counts is None
                  else train_counts["dwconv_stats_band"],
                  "times_per_stages": "1-3"}),
                ("dwconv_wgrad", "slak_tpu_torch/ops/csrc/dwconv_wgrad.cu",
                 "slak_tpu/ops/pallas_banded.py:888",
                 {"also_replaces": "slak_tpu/ops/pallas_banded.py:806",
                  "library": "torch.nn.grad.conv2d_weight(groups=C)",
                  "band_route": WGRAD_ROUTE,
                  "band_launches": None if train_counts is None
                  else train_counts["dwconv_wgrad_band"]}),
                ("mlp_bwd", "slak_tpu_torch/ops/csrc/mlp_bwd.cu",
                 "slak_tpu/ops/pallas_mlp.py:263", {})):
            t = train_totals[name]
            lib = t["library_ms"]
            if name == "mlp_bwd":
                extra = {"unfused_torch_ms": t["unfused_torch_ms"],
                         "library": "none; unfused_torch_ms is the autograd "
                         "backward of the unfused composition"}
                lib = None
            kernels.append(dict(
                name=name, route="cuda", source=src, replaces=repl,
                launches=None if train_counts is None
                else train_counts[name] - (
                    train_counts["dwconv_stats_toeplitz"]
                    if name == "dwconv_stats" else 0),
                max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"],
                bound_by=("bytes" if t["bytes_ms"] >= t["ops_ms"]
                          else "operations"),
                library_ms=lib, **extra,
                times_per="one bf16 train step at batch %d" % TRAIN_BATCH,
                launches_in="the train path: %d bf16 steps at batch %d"
                % (TRAIN_STEPS, TRAIN_BATCH)))
    if erf_totals is not None:
        t = erf_totals["mlp_bwd_wide"]
        kernels.append(dict(
            name="mlp_bwd_wide", route="cuda",
            source="slak_tpu_torch/ops/csrc/mlp_bwd.cu",
            replaces="slak_tpu/ops/pallas_mlp.py:419",
            launches=None if erf_run is None else erf_run[0]["mlp_bwd_wide"],
            max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"],
            bound_by=("bytes" if t["bytes_ms"] >= t["ops_ms"]
                      else "operations"),
            library_ms=None, unfused_torch_ms=t["unfused_torch_ms"],
            library="none; unfused_torch_ms is the autograd backward of the "
            "unfused composition (the gradient of y alone in dy-only mode)",
            mode="dy_only", ops_bound="3xTF32 (3 passes at 495 TFLOP/s)",
            full_mode={k: erf_totals["mlp_bwd_wide_full"][k] for k in (
                "ms", "plain_ms", "unfused_torch_ms", "bound_ms")},
            times_per="one float32 ERF image at %d^2 (9 launches at T=4096 "
            "C=499, 3 at T=1024 C=998)" % ERF_SIZE,
            launches_in="the ERF path: %d float32 images at %d^2"
            % (ERF_IMAGES, ERF_SIZE)))
        if train_totals is not None:
            # K9 in the bf16 train step (stages 3-4, batch TRAIN_BATCH),
            # launched there as TRAIN_WIDE_MLP_BWD says
            t = train_totals["mlp_bwd_wide"]
            kernels[-1].update(
                {"train_" + k: t[k] for k in ("ms", "plain_ms", "bound_ms")},
                train_unfused_torch_ms=t["unfused_torch_ms"],
                train_max_abs_err=t["err"],
                train_launches=None if train_counts is None
                else train_counts["mlp_bwd_wide"],
                train_times_per="the stage 3-4 tails of one bf16 train step "
                "at batch %d (9 launches at T=25088 C=499, 3 at T=6272 "
                "C=998)" % TRAIN_BATCH,
                bf16_batch128={"stage%d" % r["stage"]: {
                    k: r[k] for k in ("T", "C", "ms", "plain_ms",
                                      "unfused_torch_ms", "bound_ms",
                                      "max_abs_err", "blocks",
                                      "launches_per_block")}
                    for r in k9_bf16})
        # the ERF path's share of the older kernels; the yardstick is the
        # library call (K1), none (K2/K3), the unfused autograd (K8)
        for name, lib in (("fused_mlp", None),
                          ("mlp_bwd", "erf_unfused_torch_ms")):
            per = erf_totals[name]
            for k in kernels:
                if k["name"] == name:
                    k.update({"erf_" + f: per[f] for f in (
                        "ms", "plain_ms", "bound_ms")},
                        erf_max_abs_err=per["err"],
                        erf_times_per="one float32 ERF image at %d^2"
                        % ERF_SIZE)
                    if lib:
                        k[lib] = per["unfused_torch_ms"]
                    if name == "fused_mlp":
                        k.update(
                            erf_route="3xTF32 on TMA-fed wgmma",
                            erf_bound_by=("bytes" if per["bytes_ms"]
                                          >= per["ops_ms"] else "operations"),
                            erf_ops_ms_3xtf32=per["ops_ms_3xtf32"],
                            erf_ops_ms_ffma=per["ops_ms_ffma"])
                    if name == "mlp_bwd":
                        full = erf_totals["mlp_bwd_full"]
                        k.update(erf_mode="dy_only", erf_full_mode={
                            f: full[f] for f in ("ms", "plain_ms",
                                                 "unfused_torch_ms",
                                                 "bound_ms")})
        if erf_run is not None:
            for k in kernels:
                if k["name"] in ("fused_mlp", "mlp_bwd"):
                    k["erf_launches"] = erf_run[0][k["name"]]
                if k["name"] == "fused_mlp":
                    k["erf_tf32_launches"] = erf_run[0]["fused_mlp_tf32"]
    if erf_totals is not None:
        # fp32 K1 on its band kernel: the ERF image's forward and dgrad
        fw, dg = erf_totals["dwconv"], erf_totals["dwconv_dgrad"]
        both = {k: fw[k] + dg[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms",
            "ops_ms_3xtf32", "ops_ms_ffma")}
        kernels.append(dict(
            name="dwconv_f32", route="cuda",
            source="slak_tpu_torch/ops/csrc/dwconv_f32.cu",
            replaces="slak_tpu/ops/pallas_banded.py:168",
            launches=None if erf_run is None else erf_run[0]["dwconv_tf32"],
            max_abs_err=max(fw["err"], dg["err"]), ms=both["ms"],
            plain_ms=both["plain_ms"], bound_ms=both["bound_ms"],
            bound_by=("bytes" if both["bytes_ms"] >= both["ops_ms"]
                      else "operations"),
            library_ms=both["library_ms"], library="F.conv2d(groups=C)",
            band_f32_route=F32_ROUTE,
            ops_bound="the lesser of 3xTF32 (3 passes at 495 TFLOP/s) and "
            "FFMA (67 TFLOP/s)", ops_ms_3xtf32=both["ops_ms_3xtf32"],
            ops_ms_ffma=both["ops_ms_ffma"],
            forward={k: fw[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms")},
            dgrad={k: dg[k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms")},
            fp32_forward_launches=None if counts_fp32 is None
            else counts_fp32[4],
            times_per="one float32 ERF image at %d^2 (forward and dgrad, "
            "36 launches each)" % ERF_SIZE,
            launches_in="the ERF path: %d float32 images at %d^2"
            % (ERF_IMAGES, ERF_SIZE)))
    if dual_totals is not None:
        totals_d, extra_d = dual_totals
        per_fwd = "one bf16 dual forward at batch %d" % MAIN_BATCH
        per_stage = ("one launch at each of the four stage shapes, bf16, "
                     "batch %d, summed" % MAIN_BATCH)
        for name, src, repl, per, launches, more in (
                ("dwpair", "slak_tpu_torch/ops/csrc/dwpair.cu",
                 "slak_tpu/ops/pallas_banded.py:632", per_fwd,
                 None if dual_counts is None else dual_counts["dwpair"],
                 {"library": "two F.conv2d(groups=C) and the add",
                  "mode": "dualboth, raw pair",
                  "band_route": PAIR_BAND_ROUTE,
                  "band_launches": None if dual_counts is None
                  else dual_counts["dwpair_band"]}),
                ("fused_mlp_dual", "slak_tpu_torch/ops/csrc/mlp.cu",
                 "slak_tpu/ops/pallas_mlp.py:681", per_fwd,
                 None if dual_counts is None
                 else dual_counts["fused_mlp_dual"],
                 {"library": "none; unfused_torch_ms is the unfused "
                  "composition (the add, LN, two nn.Linear, GELU, gamma, "
                  "residual, the q copy)"}),
                ("dwconv_stacked", "slak_tpu_torch/ops/csrc/dwconv_stacked.cu",
                 "slak_tpu/ops/pallas_banded.py:364", per_stage,
                 None if probe_counts is None
                 else probe_counts["probe_stacked"]["dwconv_stacked"],
                 {"library": "F.conv2d(groups=C)",
                  "band_route": STACKED_ROUTE,
                  "band_launches": None if probe_counts is None
                  else probe_counts["probe_stacked"]["dwconv_stacked_band"],
                  "fp32_launches": None if probe_counts is None
                  else probe_counts["probe_stacked_fp32"]["dwconv_stacked"],
                  "vs_k1_band": extra_d["stacked_vs_k1"],
                  "launches_in": "tools/probe_stacked.py (bf16; fp32 "
                  "beside)"}),
                ("dwconv_probe", "slak_tpu_torch/ops/csrc/dwconv.cu",
                 "tools/probe_overhead.py:65", per_stage + " (all 5 taps)",
                 None if probe_counts is None else
                 probe_counts["probe_overhead"]["dwconv_probe"]
                 + probe_counts["probe_floor"]["dwconv_probe"],
                 {"library": "F.conv2d(groups=C) on the truncated taps "
                  "(F.pad for the copy)",
                  "band_route": PROBE_ROUTE,
                  "band_launches": None if probe_counts is None else
                  probe_counts["probe_overhead"]["dwconv_probe_band"]
                  + probe_counts["probe_floor"]["dwconv_probe_band"],
                  "ms_by_ntaps": extra_d["probe_ms_by_ntaps"],
                  "launches_in": "tools/probe_overhead.py and "
                  "tools/probe_floor.py"})):
            t = totals_d[name]
            lib = t["library_ms"]
            if name == "fused_mlp_dual":
                more = dict(more, unfused_torch_ms=lib)
                lib = None
            kernels.append(dict(
                name=name, route="cuda", source=src, replaces=repl,
                launches=launches, max_abs_err=t["err"], ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=("bytes" if t["bytes_ms"] >= t["ops_ms"]
                          else "operations"),
                library_ms=lib, times_per=per, **more))
    if dp_run is not None or tp_run is not None:
        add_parallel_launches(kernels, dp_run, tp_run)
    if kd_totals is not None or kd_run is not None:
        add_kd_launches(kernels, kd_totals, kd_run)
    if seg_run is not None or det_run is not None:
        add_downstream(kernels, seg_run, det_run)
    if kernels:
        print(json.dumps({"kernels": kernels}))
    if erf_run is not None:
        print(f"[erf] ms an image at {ERF_SIZE}^2 fp32: kernels "
              f"{erf_run[1]:.3f}, plain {erf_run[2]:.3f}")
    if cli_runs is not None:
        print("[cli] " + json.dumps(cli_runs))
    if dp_run is not None:
        print("[dp] " + json.dumps(dp_run))
    if tp_run is not None:
        print("[tp] " + json.dumps(tp_run))
    if kd_rows is not None:
        print("[kd_kernels] " + json.dumps(kd_rows))
    if kd_run is not None:
        print("[kd] " + json.dumps(kd_run))
    for tag, run in (("seg", seg_run), ("det", det_run)):
        if run is not None:
            print(f"[{tag}] " + json.dumps({k: run[k] for k in (
                "step", "cli", "seconds")}))
    if dual_by is not None:
        print(f"[dual_timing] bf16 eval bs{TIMING_BATCH} img/s: dual "
              f"{dual_by['dual']['img_per_s']:.1f}, split "
              f"{dual_by['split']['img_per_s']:.1f}")
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
