#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

The main path is the ``base``-method CIL train step: TSM-ResNet-50, 8 frames
at 224x224, batch 16, bf16 compute, LSC head (nb_proxies=1) with LSCLoss, the
labeled 6-group SGD; from task 1 on, feature-KD against the previous model and
the global-norm clip at 1.0. It runs in the two configurations that reach the
hand-written kernels (the defaults reach none):

  A  shift_mode='pad' + conv1x1_mode='pallas_stats'  -> conv1x1_with_stats
  B  shift_mode='fused_block'                        -> fused_residual_relu_shift
                                                        forward and backward

Every train step of every configuration also runs train-mode BatchNorm's
kernels (ops/batchnorm.py, csrc/batchnorm.cu): batchnorm_stats, _finalize
and _apply forward, _bwd_reduce and _bwd_dx backward, one of each a
BatchNorm (no statistics kernel where conv1x1_bn's GEMM gave the sums);
eval forwards run none. Every phase that runs train steps counts them with
its own kernels (``bn_launches``). Their rows (``batchnorm_rows``, after
phase 2's) time them at the stem and layer1 of batch 16.

Configuration A at the trainer's default float32 (phase 19) reaches the float32
kernel of the same function, conv1x1_with_stats_f32 (and gemm_with_stats_f32):
three TF32 products on the tensor cores (csrc/gemm_stats_tf32.cu).

The main path is fed by the fast input path: JPEG rawframes decoded by the
native pool into a yuv420 wire batch (uint8 planes, RandAugment draws, BGMix
and flip masks), staged through pinned memory to the card, and
``make_fast_input_fn`` (YCbCr -> RGB, RandAugment, normalize, flip,
background blend; eager PyTorch, no hand-written kernel) inside the step,
driven by ``train_epochs`` with K = 8 steps a call (phase 9). A whole
class-incremental run drives the slice above it (phase 10): the task loop,
herding, CBF, NME and TenCrop testing, in configuration B; the ActorCutMix
preset and the single-process tools (phase 11) drive it again from their
command-line entry points.

The other entry points, each with its own kernels:

  block  fused_bottleneck_fwd at TSM-R50 layer1 width (16 clips x 8 frames,
         56x56, 256 -> 64 -> 64 -> 256), both conv3x3 variants, and once at
         each of the other three stride-1 widths
         -> block_conv1x1_stats, conv3x3_affine_relu_stats,
            conv1x1_affine_relu_stats and block_affine_residual_relu, one
            each per block forward, block_bn_finalize three; in float32
            (phase 20) their float32 kernels, launches counted under the
            same names + "_f32"
  gemm   gemm_with_stats, forward and VJP, at the eight ResNet-50 1x1 shapes
         -> gemm_with_stats
  shift  temporal_shift_kernel, forward and VJP, at the block inputs of the
         pad path and at (64, 28, 28, 512) f32 -> temporal_shift

Phases (any failure exits non-zero; no phase swallows an exception):
  1. build every kernel from bdvcil_torch/csrc (nvcc, sm_90a);
  2. kernels: each against its plain PyTorch version at every ResNet-50 shape
     of its path, forward and backward, with CUDA-event times of the kernel,
     the plain version and, where one exists, the library call and its bare
     product (no statistics); the wgmma kernels' tile plan per shape; the
     block kernels' statistics on a second run, bit for bit; the block's
     conv3 (#7) also at a ragged M with b > 0; the block's tail
     (block_bn_finalize at C and Cm, block_affine_residual_relu) bit for
     bit at the four stride-1 widths; #1 and #2, bit for bit, at the
     shapes of every path that runs them: the bench's batch 16 (128 frames
     at 224, forward and backward), phase 10's batch 8 (64 frames at 224,
     forward and backward: train, KD, CBF, features, class means and the
     val test) and its TenCrop test at 256 (8 x 10 x 8 = 640 frames,
     H = W = 64 to 8, forward only), the later phases' paths
     (``fused_paths``), and phase 17's TSM-R18 in f32 at 2 segments: its
     train batch (16 frames at 56, H = W = 14 to 2, forward and backward)
     and its test batch (128 frames, forward only);
  3. reference: one small train step per configuration on the card against
     the same step on the CPU, where the port runs the plain versions;
  4. train A and B at full width: 3 task-0 steps (26 classes), growth to 31,
     3 task-1 KD steps; launch counts, finite losses, moved parameters and
     updated running statistics; step times;
  5. input: make_fast_input_fn on each wire format (rgb, yuv420, planes at
     UCF101's stored 320x240) and make_fast_acm_input_fn on yuv420, at 16 x 8
     x 224², under torch.cuda.set_sync_debug_mode("error"): the card against
     the CPU on the first 4 clips, the uint8 stage bit for bit, the bf16
     output within one bf16 ulp; the wire batch's H2D ms and bytes from
     pinned memory, the input function's ms per batch;
  6. train A fed by the input path: make_train_step(input_fn=make_fast_input_fn(
     alpha=0.5, with_randaug=True, dtype=bf16, wire_format="yuv420")), 3
     task-0 steps, growth, 3 task-1 KD steps with the checks of phase 4 and
     #3's 192 launches; the input function's share of the step; then one
     make_multi_train_step call with K = 2;
  7. iCaRL: one small task-1 step of 'icarl' (ActorCutMix smoothing) and of
     'icarl_video_mix' (tube-CutMix) on the card against the CPU;
  8. the block, gemm and shift paths, each with its launch counts set to 0
     before and read after: outputs against the plain compositions, the
     block against the library-convolution block at layer1 and against its
     plain composition at the other three widths, chained ms per block;
  9. loop, the main path end to end: a corpus of 128 UCF101-shaped videos
     written by the port's JPEG writer under chiprun_out/ (removed after;
     ``loader:`` names the loader and its wire), the loader's first batch
     through the input
     function on the card against the CPU (uint8 stage, bit for bit), then
     ``train_epochs`` for 2 epochs of config A fed by ``FastBGMixLoader`` on
     the yuv420 wire with K = 8: #3's launches equal 32 a step times the
     steps, finite losses, moved parameters, e2e clips/s, producer wait; then
     3 epochs straight against 1 epoch, a snapshot, a rebuilt state and 2
     more, bit for bit under deterministic algorithms (an op without a
     deterministic CUDA form is named, and the resume is held to the spread
     of two straight runs).
 10. cil, the slice's main path: a rawframe tree of UCF101's stored size
     (320x240 JPEG frames written with cv2, 16 a video, 8 classes, 4 train
     and 2 val videos a class, one background a video) under chiprun_out/
     (removed after), and ``bdvcil_torch.cil_tools.train_cil``'s ``main`` on
     a config file of the hmdb51 preset (TSM-R50, 8 segments, 224 train
     crops, TenCrop test at 256) in configuration B, bf16: 3 tasks
     ([0..3], [4, 5], [6, 7]), batch 8, 1 epoch a task, CBF 1 epoch, budget
     2, eval K = 2, then ``cil_testing`` with NME. One ``cil task`` line a
     task: the loaders each phase took (FastBGMixLoader on the yuv420 wire
     for train and CBF, FastEvalLoader for the rest, TenCrop on the
     yuv420_full wire; a host loader fails the phase), the seconds
     of train, features + herding, CBF and test, the CNN/NME rows (finite,
     in [0, 100]), the exemplar count, #1 and #2 launches against the count
     worked out from the forwards and backwards and the fast loaders'
     batches (``expected_cil_launches``), eval clips/s; then cil_testing's
     #1 launches, the fast loaders' batch time,
     and the card's eval step against the CPU's (f32) on one TenCrop batch:
     cls_score within 3e-2 of its largest entry, and the same prediction
     (the argmax of the crops' mean softmax) for every video whose CPU
     log-ratio of top-1 to top-2 probability exceeds 4x the measured max
     abs err: a logit error of e moves each crop's probabilities, and so
     their mean, by a factor within exp(+-2e), which cannot reorder two
     classes further apart than that.
 11. acm and the tools, the slice's path through each tool's ``main``: phase
     10's corpus writer with a ``detections.npy`` (one or two boxes on most
     frames, scores on both sides of 0.4, some frames without, one video
     without any); ``create_annotation_files`` (every video listed once with
     its frames and label); ``extract_background --device`` (the card's
     medians equal ``np.round(np.median(...))`` bit for bit at 16 and 15
     frames; at 16 a lower-middle median would differ); ``train_cil`` on the
     ``actorcutmix_plus_randaug`` preset of the hmdb51 template (TSM-R50,
     icarl with ACMSmoothCE, ActorCutMixDataset through the fast ACM loader,
     acm_prob 0.5 and no CBF as the preset sets them) cut as phase 10, with
     one ``cil acm task`` line a task (the loaders, all fast, stage seconds,
     #1/#2 launches against ``expected_cil_launches(use_cbf=False)``), then
     ``cil_testing`` and the fast ACM loader's batch time; ``test_cil`` (tables
     equal to the trainer's, launches equal); ``test_single_ckpt`` on the
     last checkpoint; ``predict`` on 4 videos (top-1 equal to the argmax of
     the eval step on the same videos, with the original labels of the
     annotation tool's map); ``extract_features`` on them (every video kept,
     scores and representations within 3e-2 of the largest entry of the eval
     step's).
 12. distributed, the slice's path across ranks (``bdvcil_torch/parallel``):
     (a) config A's task-0 and task-1 KD steps at 16 x 8 x 224² bf16 in a
     one-rank NCCL group against no group, bit for bit under deterministic
     algorithms (the gradient all-reduce, #3's sums and BatchNorm's all
     all-reduced), #3 32 launches a step, the step ms with and without the
     group; (b) two processes on the one card over gloo (NCCL refuses two
     ranks on one device; the script starts itself with ``--rank``), 8 rows
     each, against one process at 16: configs A and B in bf16 (losses, equal
     weights on both ranks, #3 32 a step, #1 16 / 32 and #2 16 on each rank)
     and B in float32 without TF32 (losses and the backbone's update, in
     norm), the task-1 batch's 4 pad rows all on rank 1; ``run_inference``
     of 10 videos at a global batch of 8, every gathered row against one
     process; ``train_cil`` for 2 tasks at phase 10's cut on both ranks,
     then ``cil_testing`` and ``test_cil`` on rank 0's checkpoints with equal
     tables; (c) one train-mode forward of TSM-R50 under ``stem_mode='s2d'``,
     ``shift_mode='fused'``, ``bn_groups=2`` and ``bn_stats_rows=4``, card
     against CPU in f32 and bf16.
 13. reference, the model layer's two entry points no other phase drives:
     (a) config B's TSM-R50 (bf16, LSC with eta) written as the reference
     writes ``ckpt_task_{t}.pt`` (``.net`` inside each block's conv1, the
     head as ``fc_cls.weights`` / ``loss_cls.eta``, under ``current_model.``,
     with a ``prev_model.`` copy of another eta and a ``num_batches_tracked``)
     under chiprun_out/ (removed after), read back through
     ``load_checkpoint_file`` and ``load_reference_cil_checkpoint`` into a
     fresh model with a strict load: eval logits at 16 x 8 x 224² equal the
     source's bit for bit, #1 16 launches a forward, the current model's eta;
     (b) config A's train-mode forward at 16 x 8 x 224² under
     ``conv1x1_mode='pallas_stats'`` and ``'pallas_stats_interpret'`` from
     one seed: #3 32 and 0 launches, logits within 3e-2 of the largest entry
     and losses within 3e-2 (phase 3's bf16 tolerance).
 14. jpeg, the port's own JPEG codec (``bdvcil_torch/csrc/host/jpeg_codec.h``,
     built with g++ beside the kernels; the script fails without it): frames
     from a seed written by the port's writer and by cv2 (4:4:4 with a
     restart interval, 4:2:2, gray, 4:2:0 with one), and the cv2 files as
     they were written when the digests were taken (``tests/goldens/jpeg``):
     the writer's bytes and every decoder entry point's output on each file
     equal sha256 digests taken with libjpeg-turbo 2.1.5 (``JPEG_DIGESTS``; a cv2 file
     whose bytes differ from its golden is not gated, its golden is), the
     pixels that differ from ``cv2.imread``; decode frames/s on bench_train's
     corpus (1,024 frames of 320x240), cold (the plane cache off) and warm,
     one thread and the pool, the yuv420 wire and rgb, and full-size decode
     on one thread against ``cv2.imread`` (libjpeg-turbo); then
     ``bench_train.run`` for config A, one window from JPEG and one
     synthetic: e2e, device_clips_per_sec, host decode frames/s, producer
     wait, cache counters, #3 at 32 launches a step.
 15. profile, the fed step split (``bdvcil_torch.profile_e2e``): config A at
     16 x 8 x 224², bf16, on bench_train's corpus with
     ``BDVC_PROFILE_PRODUCER=1``, the modes baseline, pipelined and prefetch
     from JPEG and from synthetic wire batches, 24 steps each after 2 warm-up
     steps: wait, put, dispatch and device ms a step, clips/s, the producer's
     pass1 / probe / pass2 / decode ms a batch and the plane cache's hit
     rate; each mode ran its steps, #3 at 32 launches a step, baseline's
     stages within 10% of its wall; 4 loader batches timed one by one, each
     phase >= 0 and their sum within the batch's time; with the switch at
     "0" a loader's epoch records nothing.
 16. bench, the port's benches in process at 16 x 8 x 224², bf16, one seed:
     (a) ``bench_step`` for configs A and default, 10 steps after 3 warm-up
     steps: clips/s, ``mfu`` and ``bw_roofline_fraction`` (each in (0, 1]),
     #3 at 32 launches a step under A and none under default; then
     ``--forward-only`` for config B, #1 at 16 a forward; (b) ``bench_eval
     --config B --measures 1`` on a corpus of bench_train's shape written by
     the port's writer, centre crop and TenCrop (K = 4, one sweep of 2
     passes): rows = passes x videos, finite scores, #1 at 16 a forward over
     every batch run, TenCrop on ``yuv420_full``; (c) ``bench_train --family
     acm --config A``, one window of 40 steps: ``FastACMLoader`` on the wire
     the line names, #3 at 32 a step; (d) ``bench_input`` on 256 frames.
 17. studies, the accuracy studies through their entry points (plain torch
     on the reference's side, the port's trainer on the other): (a)
     ``bn_ablation`` at its defaults (3 seeds x 3 modes x 24 epochs of
     R18-TSM at 2 x 32², f32): 9 records, finite losses, accuracies in [0, 1],
     every BatchNorm a ``GroupedBatchNorm`` in the per-device and ghost modes
     and none in the global one; (b) ``parity_study``'s ``main``, one seed of
     ``--method base`` at 3 stages on the study tree (``reference_loop``),
     twice: on the parity config as it is (pad + xla: no launch) and with
     ``--set model=...`` at ``shift_mode='fused_block'`` (#1 and #2 in f32 on
     the port's side, counted against ``expected_study_launches``, every call
     at a shape, dtype and segment count that phase 2 holds bit for bit
     against the plain version: ``fused_paths``' "study" rows): per-stage
     CNN/NME of both sides and both walls, matrices of 3 stages with every
     value finite in [0, 100], the output's schema. No delta is gated (one
     seed is chaotic); a side under 20 at the last stage is printed as
     collapsed.
 18. graft, the driver's entry points (``bdvcil_torch.graft_entry``): (a)
     ``entry()`` on the card, the flagship TSM-R50 bf16 eval forward at 8 x 8
     x 224² at the default modes: cls_score (8, 1, 51), finite, the
     forward's ms (CUDA events), one clip against the same forward on the
     CPU at the same weights within 3e-2 of the largest |logit| (phase 3's
     bf16 tolerance); (b) ``dryrun_multichip(1)`` in a one-rank NCCL group
     and ``dryrun_multichip(2)`` as two gloo processes on the card, every
     part's losses finite, against ``dryrun_multichip(2)`` on the CPU (run
     beside them): the losses within phase 12's loss rtol (the KD term and
     the K = 2 call's second step within 2e-2: the dry run's constant frames
     make f32 rounding grow), the eval scores within 3e-2 of the largest,
     the input functions' outputs within 1e-5; (c) no hand-written kernel
     launched, in this process or in any rank (the default pad + xla).
 19. f32, the GEMM with statistics in float32 and at any K and N, TF32 off:
     (a) the float32 kernel (``csrc/gemm_stats_tf32.cu``, 3xTF32 on the
     tensor cores: its tile, its bound at three TF32 products and the f32
     FMA bound beside it) through
     ``conv1x1_with_stats`` at the 12 R50 1x1 shapes of a train forward and
     through ``gemm_with_stats`` at phase 2's 8, both at ragged (M, K, N)
     (``RAGGED_SHAPES``) where the bf16 core runs too: f32 y within rtol
     1e-5, atol 1e-6 of max |y| of the plain version, the statistics rtol
     1e-4, bf16 as phase 2, a second run bit for bit; ``gemm_with_stats`` in
     f32 forward and VJP at the 8 shapes (the f32 gemm path, 8 launches); the
     bf16 core's outputs at the 12 R50 shapes equal to checksums recorded
     before it took ragged K and N (``BF16_CORE_CHECKSUMS``, on 132 SMs);
     (b) config A at 16 x 8 x 224² in float32, a task-0 step and a task-1 KD
     step under ``pallas_stats`` against ``pallas_stats_interpret``,
     deterministic algorithms: losses within rtol 2e-3, every BatchNorm
     running statistic within rtol 2e-3, atol 1e-3, the f32 kernel 32
     launches a step and the bf16 core none, the f32 step ms beside phase 4's
     bf16 step; (c) ``train_cil.main`` on a config A file that names no
     ``compute_dtype`` (the trainer's float32), one task at phase 10's cut:
     the f32 kernel 32 launches a train step, finite accuracies.
 20. block dtypes, the block probe at every dtype and shape the JAX ops
     take, TF32 off: (a) ``fused_bottleneck_fwd`` in float32 at the four
     stride-1 widths (128 frames): #6, #7 and #8 f32 (three TF32 products,
     ``gemm_stats_tf32.cu``) against their plain versions (y rtol 1e-5,
     atol 1e-6 of max |y|, the statistics rtol 1e-4; a second run bit for
     bit), #9b f32 bit for bit (a NaN pack included), the block against its
     plain composition and against ``plain_bottleneck_fwd`` (every output
     within 1e-4 of the terms' size, (mean, var) rtol 1e-4), one launch of
     each f32 kernel and three finalizes a block and no bf16 launch, the
     chained ms of a layer1 block; (b) bf16 #6, #7 and #8 at the JAX tests'
     geometries (c=64, cm=16 at 14²; c=32, cm=8 at 7²; the blocks too), #7
     and #8 at W = 64 (128 frames: layer1 at a 256² input) and W = 112, and
     at Cin 12 (the wrapper's zero padding): y within one bf16 ulp, the 3x3's
     C plan equal to ``gemm_plan.conv3x3_plan``; (c) the bf16 core's #7 and
     #8 at the R50 shapes equal to checksums recorded before it took any
     channel count and width (``BLOCK_CORE_CHECKSUMS``); (d) the f32 rows
     and #8 bf16 at W = 64 timed as phase 2's, the f32 rows bound by three
     TF32 products; (e) #8 f32 at W = 112 (two boxes a window) and 200
     (three bands) and at Cin 12 and 3, both variant names, #7 f32 at ragged
     K and N, against their plain versions as (a), the 3x3's C plan equal to
     ``gemm_plan.tf32_conv3x3_plan``; (f) #8 bf16 where its window is three
     bands of 136 rows (W = 272, layer1 of a 1280 x 720 and of a 1920 x 1080
     clip, W = 320 and 480) and at Cin 2048 (a deep product: its
     accumulator in chunks), within one bf16 ulp, its C plan equal to
     ``gemm_plan.conv3x3_plan``, timed at 720p (also f32) and 1080p; (g)
     #9b at C = 6144 (a and b in shared memory) and past it (6152, 8192:
     16-byte packs; 8193: per element; a and b through the read-only
     cache), bf16 and f32, bit for bit; (h) ``fused_bottleneck_fwd`` at the
     four stride-1 widths on an 8-frame 1280 x 720 clip (180 x 320 ... 23 x
     40) in bf16 and f32 and at 1920 x 1080's layer1 in bf16 against its
     plain composition (bf16 as phase 8's gate, f32 as (a)), the kernels
     only, the layer1 blocks chained.

Output: the card's name and power limit, a ``{"kernels": [...]}`` line, and
as the last line ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. Without a CUDA device it prints no result
and exits 1.

    python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import copy
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# published peaks of one H100 SXM (dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores: the block tail's arithmetic
# TF32 on the tensor cores: the float32 GEMM runs three TF32 products (3xTF32)
PEAK_TF32_FLOPS = 495e12

NT = 128  # 16 clips x 8 frames
BATCH, SEGMENTS, SIZE = 16, 8, 224
KERNEL_CONFIGS = ("A", "B")  # bdvcil_torch.config_templates.SWITCHES
FWD, BWD, CONV = ("fused_residual_relu_shift_fwd", "fused_residual_relu_shift_bwd",
                  "conv1x1_with_stats")
GEMM, SHIFT = "gemm_with_stats", "temporal_shift"
# the float32 kernel's launch counts (ops/conv1x1_bn.KERNEL_F32, GEMM_KERNEL_F32)
CONV_F32, GEMM_F32 = CONV + "_f32", GEMM + "_f32"
CONV1, CONV2, CONV3 = ("block_conv1x1_stats", "conv3x3_affine_relu_stats",
                       "conv1x1_affine_relu_stats")
FINALIZE, EPILOGUE = "block_bn_finalize", "block_affine_residual_relu"
# the block's float32 kernels (ops/block_fused.CONV1_F32, ...)
CONV1_F32, CONV2_F32, CONV3_F32, EPILOGUE_F32 = (CONV1 + "_f32", CONV2 + "_f32", CONV3 + "_f32",
                                                 EPILOGUE + "_f32")
# per kernel: its source, the TPU kernel it replaces, and what its library
# yardstick computes (None: no one PyTorch call computes the same function)
MATMUL_SUMS = "torch.matmul + two f32 sums"
F32_MATMUL_SUMS = "torch.matmul (f32, TF32 off) + two f32 sums"
# train-mode BatchNorm's kernels (ops/batchnorm.py, csrc/batchnorm.cu)
BN_STATS, BN_FINALIZE, BN_APPLY, BN_BWD_REDUCE, BN_BWD_DX = (
    "batchnorm_stats", "batchnorm_finalize", "batchnorm_apply", "batchnorm_bwd_reduce",
    "batchnorm_bwd_dx")
# (N*T, C, H, W) of their rows: the stem's BatchNorm and layer1's bn2 at batch 16
BN_SHAPES = {"stem": (NT, 64, 112, 112), "layer1": (NT, 64, 56, 56)}
BN_LIBRARY = "F.batch_norm (training, cuDNN or ATen) forward / backward, whole: a yardstick"
KERNEL_META = {
    FWD: ("bdvcil_torch/csrc/tsm_shift.cu", "bdvcil_tpu/ops/tsm_shift.py:131", None),
    BWD: ("bdvcil_torch/csrc/tsm_shift.cu", "bdvcil_tpu/ops/tsm_shift.py:140", None),
    CONV: ("bdvcil_torch/csrc/conv1x1_stats.cu", "bdvcil_tpu/ops/conv1x1_bn.py:164", MATMUL_SUMS),
    GEMM: ("bdvcil_torch/csrc/conv1x1_stats.cu", "bdvcil_tpu/ops/conv1x1_bn.py:37", MATMUL_SUMS),
    SHIFT: ("bdvcil_torch/csrc/tsm_shift.cu", "bdvcil_tpu/ops/tsm_shift.py:235", None),
    CONV1: ("bdvcil_torch/csrc/conv1x1_stats.cu", "bdvcil_tpu/ops/block_fused.py:96",
            MATMUL_SUMS),
    CONV3: ("bdvcil_torch/csrc/conv1x1_stats.cu", "bdvcil_tpu/ops/block_fused.py:73",
            MATMUL_SUMS + " without the prologue: less work than the kernel"),
    CONV2: ("bdvcil_torch/csrc/conv3x3_stats.cu", "bdvcil_tpu/ops/block_fused.py:110",
            "F.conv2d (channels_last) + two f32 sums without the prologue: less work than "
            "the kernel"),
    EPILOGUE: ("bdvcil_torch/csrc/block_epilogue.cu", "bdvcil_tpu/ops/block_fused.py:290",
               None),
    FINALIZE: ("bdvcil_torch/csrc/block_epilogue.cu", "bdvcil_tpu/ops/block_fused.py:262",
               None),
    CONV_F32: ("bdvcil_torch/csrc/gemm_stats_tf32.cu", "bdvcil_tpu/ops/conv1x1_bn.py:164",
               F32_MATMUL_SUMS),
    GEMM_F32: ("bdvcil_torch/csrc/gemm_stats_tf32.cu", "bdvcil_tpu/ops/conv1x1_bn.py:37",
               F32_MATMUL_SUMS),
    CONV1_F32: ("bdvcil_torch/csrc/gemm_stats_tf32.cu", "bdvcil_tpu/ops/block_fused.py:96",
                F32_MATMUL_SUMS),
    CONV3_F32: ("bdvcil_torch/csrc/gemm_stats_tf32.cu", "bdvcil_tpu/ops/block_fused.py:73",
                F32_MATMUL_SUMS + " without the prologue: less work than the kernel"),
    CONV2_F32: ("bdvcil_torch/csrc/gemm_stats_tf32.cu", "bdvcil_tpu/ops/block_fused.py:110",
                "F.conv2d (f32, TF32 off, channels_last) + two f32 sums without the prologue: "
                "less work than the kernel"),
    EPILOGUE_F32: ("bdvcil_torch/csrc/block_epilogue.cu", "bdvcil_tpu/ops/block_fused.py:290",
                   None),
    BN_STATS: ("bdvcil_torch/csrc/batchnorm.cu", "flax BatchNorm's batch statistics (XLA)",
               BN_LIBRARY),
    BN_FINALIZE: ("bdvcil_torch/csrc/batchnorm.cu", "flax BatchNorm's mean, var, running "
                  "statistics (XLA)", None),
    BN_APPLY: ("bdvcil_torch/csrc/batchnorm.cu", "flax BatchNorm's normalize + relu (XLA)",
               None),
    BN_BWD_REDUCE: ("bdvcil_torch/csrc/batchnorm.cu", "BatchNorm's VJP, its two sums (XLA)",
                    BN_LIBRARY),
    BN_BWD_DX: ("bdvcil_torch/csrc/batchnorm.cu", "BatchNorm's VJP, dx (XLA)", None),
}
# the 1x1 shapes of tools/bench_gemm_stats.py (M = 16 clips x 8 frames x H x W)
GEMM_SHAPES = [(NT * 56 * 56, 256, 64), (NT * 56 * 56, 64, 256), (NT * 28 * 28, 512, 128),
               (NT * 28 * 28, 128, 512), (NT * 14 * 14, 1024, 256), (NT * 14 * 14, 256, 1024),
               (NT * 7 * 7, 2048, 512), (NT * 7 * 7, 512, 2048)]
# the stride-1 bottlenecks of ResNet-50: (H = W, C, Cm); the first is layer1
BLOCKS = [(56, 256, 64), (28, 512, 128), (14, 1024, 256), (7, 2048, 512)]
BLOCK_ITERS = 20
UCF_STORED = (320, 240)  # UCF101's stored frames (bench.py:305): the planes wire
# the loop phase: a corpus of 128 videos (8 steps an epoch), K = 8, bench.py's 51 classes
LOOP_VIDEOS, LOOP_EPOCHS, LOOP_K, LOOP_CLASSES = 128, 2, 8, 51
# the CIL phase: UCF101's stored frames, 8 classes in 3 tasks, 4 train and 2
# val videos a class, budget 2, batch 8, 1 epoch a task and 1 CBF epoch
CIL_SPLITS = [[0, 1, 2, 3], [4, 5], [6, 7]]
CIL_TRAIN, CIL_VAL, CIL_FRAMES, CIL_BUDGET, CIL_BATCH, CIL_EVAL_K = 4, 2, 16, 2, 8, 2
EVAL_NT, EVAL_SIZE = CIL_BATCH * 10 * SEGMENTS, 256  # a TenCrop batch: 8 videos x 10 crops x 8
SERVE_VIDEOS = 4  # phase 11's predict and extract_features batch (float32, as the tools build)
CIL_BLOCKS = 16  # TSM-R50's blocks: one #1 launch each a forward, one #2 each a backward
# phase 10 gives #1's and #2's launches: the kernels line sums their rows of its train shapes
CIL_PATH = "cil"


# train-mode BatchNorm modules of a TSM-ResNet: 3 a bottleneck (R50) or 2 a
# basic block, one a downsample shortcut, and the stem's
R50_BNS, R18_BNS = 3 * 16 + 4 + 1, 2 * 8 + 3 + 1


def kernel_launches(since=None):
    """The launch counts since ``since`` (a copy of them), those not 0."""
    from bdvcil_torch.ops import _build

    since = since or {}
    return {k: v - since.get(k, 0) for k, v in _build.LAUNCHES.items() if v - since.get(k, 0)}


def bn_launches(steps, bns=R50_BNS, sums=0, dtype=torch.bfloat16):
    """Train-mode BatchNorm's launches (ops/batchnorm) over ``steps`` train
    steps of a model whose ``bns`` BatchNorms take the kernels: one forward
    and one backward of each, no statistics kernel for the ``sums`` of them
    that normalize conv1x1_bn's sums (32 in configuration A's R50)."""
    from bdvcil_torch.ops import batchnorm

    want = {batchnorm.launch_name(k, dtype): bns * steps for k in batchnorm.KERNELS}
    want[batchnorm.launch_name(batchnorm.STATS, dtype)] = (bns - sums) * steps
    return {k: v for k, v in want.items() if v}


def r50_shapes(nt: int = NT, size: int = SIZE):
    """Per forward of ``nt`` frames at ``size``: the fused epilogue's (N*T,
    H, W, C) shapes and the 1x1 GEMMs' (M, K, N) shapes of configuration A,
    each with its count, and the pad path's shifted block inputs (N*T, H, W,
    C)."""
    fused, gemm, shifted = collections.Counter(), collections.Counter(), collections.Counter()
    inplanes, planes, size = 64, 64, size // 4
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            shifted[(nt, size, size, inplanes)] += 1
            gemm[(nt * size * size, inplanes, planes)] += 1  # conv1, input resolution
            size //= stride
            gemm[(nt * size * size, planes, 4 * planes)] += 1  # conv3
            fused[(nt, size, size, 4 * planes)] += 1
            inplanes = 4 * planes
        planes *= 2
    return fused, gemm, shifted


def r18_shapes(nt: int, size: int):
    """Per forward of ``nt`` frames at ``size``: the fused epilogue's (N*T, H,
    W, C) shapes of TSM-R18, one a BasicBlock output (a 3x3 convolution of
    stride 2 rounds the side up)."""
    fused, planes, size = collections.Counter(), 64, size // 4
    for stage in range(4):
        for b in range(2):
            if stage > 0 and b == 0:
                size = -(-size // 2)
            fused[(nt, size, size, planes)] += 1
        planes *= 2
    return fused


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x|, |x| floored at 1/256 of the tensor's rms (near zero
    the f32 accumulation order, not the rounding, sets the error)."""
    floor = max(float(x.float().pow(2).mean().sqrt()) / 256, 1e-30)
    return torch.exp2(torch.floor(torch.log2(torch.clamp(x.abs(), min=floor))) - 7)


def fused_paths():
    """(path, the fused epilogue's shapes per forward, runs a backward, dtype,
    segments) of every path that runs #1: the bench's batch 16 at 224, phase
    10's batch 8 at 224 and its TenCrop test at 256 (bf16), phase 11's
    float32 tools: predict's TenCrop batch of 4 at 256, extract_features'
    batch of 4 at 224; and phase 12's: a rank's 4 videos at 224 (its CIL
    run's train and run_inference) and their TenCrop test at 256 (bf16),
    config B in float32 on one process (batch 16) and on a rank (batch 8),
    with a backward; phase 16's eval bench: TenCrop of 16 videos at 224
    (bf16); and phase 17's parity study, TSM-R18 at 2 segments and 56² in
    float32: its train and CBF batch (and the herding features, which run at
    that batch) with a backward, its test batch (the exemplar class means and
    the val test; the eval pads a short batch to a whole one) without."""
    from bdvcil_torch import parity_study
    from bdvcil_torch.reference_loop import tree

    bf16, f32 = torch.bfloat16, torch.float32
    rank_videos = CIL_BATCH // DIST_WORLD
    study = parity_study.PORT_OVERRIDES
    return [("bench", r50_shapes()[0], True, bf16, SEGMENTS),
            (CIL_PATH, r50_shapes(CIL_BATCH * SEGMENTS)[0], True, bf16, SEGMENTS),
            ("TenCrop", r50_shapes(EVAL_NT, EVAL_SIZE)[0], False, bf16, SEGMENTS),
            ("predict f32", r50_shapes(SERVE_VIDEOS * 10 * SEGMENTS, EVAL_SIZE)[0], False, f32,
             SEGMENTS),
            ("features f32", r50_shapes(SERVE_VIDEOS * SEGMENTS)[0], False, f32, SEGMENTS),
            ("cil rank", r50_shapes(rank_videos * SEGMENTS)[0], True, bf16, SEGMENTS),
            ("TenCrop rank", r50_shapes(rank_videos * 10 * SEGMENTS, EVAL_SIZE)[0], False, bf16,
             SEGMENTS),
            ("B f32", r50_shapes()[0], True, f32, SEGMENTS),
            ("B f32 rank", r50_shapes(BATCH // DIST_WORLD * SEGMENTS)[0], True, f32, SEGMENTS),
            ("eval TenCrop", r50_shapes(BATCH * 10 * SEGMENTS)[0], False, bf16, SEGMENTS),
            ("study f32", r18_shapes(study["videos_per_gpu"] * tree.T, tree.CROP), True, f32,
             tree.T),
            ("study test f32", r18_shapes(study["testing_videos_per_gpu"] * tree.T, tree.CROP),
             False, f32, tree.T)]


def gemm_paths():
    """(path, #3's (M, K, N) shapes per forward) of every path that runs #3:
    the main path's batch 16 (None: the kernels line's path) and a phase-12
    rank's batch 8."""
    return [(None, r50_shapes()[1]), ("A rank", r50_shapes(BATCH // DIST_WORLD * SEGMENTS)[1])]


def kernel_phase(dev, gen, paths, gemm_paths, tsm, conv):
    """Each kernel against its plain version at every shape of its paths."""
    rows = []
    bf16 = torch.bfloat16
    for path, shapes, backward, dtype, seg in paths:
        for shape, per_fwd in sorted(shapes.items()):
            h, idt, g_out, g_sh = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                                   for _ in range(4))
            out, sh = tsm.fused_fwd(h, idt, seg, 8)
            r_out, r_sh = tsm.fused_residual_relu_shift_plain(h, idt, seg, 8)
            same = torch.equal(out, r_out) and torch.equal(sh, r_sh)
            timed = [(FWD, lambda: tsm.fused_fwd(h, idt, seg, 8),
                      lambda: tsm.fused_residual_relu_shift_plain(h, idt, seg, 8))]
            if backward:
                g_in = tsm.fused_bwd(out, g_out, g_sh, seg, 8)
                r_g = tsm.fused_residual_relu_shift_bwd_plain(r_out, g_out, g_sh, seg, 8)
                same = same and torch.equal(g_in, r_g)
                timed.append((BWD, lambda: tsm.fused_bwd(out, g_out, g_sh, seg, 8),
                              lambda: tsm.fused_residual_relu_shift_bwd_plain(
                                  out, g_out, g_sh, seg, 8)))
            torch.cuda.synchronize()
            if not same:
                raise AssertionError(f"fused_residual_relu_shift differs from its plain version "
                                     f"at {shape} {dtype} {seg} segments ({path})")
            nbytes = 4 * h.numel() * h.element_size()  # two tensors in, two out
            for name, fn, plain in timed:
                b_ms, b_by = bound_ms(nbytes, 0.0)
                rows.append(dict(kernel=name, path=path, shape=list(shape), per_path=per_fwd,
                                 segments=seg, dtype=str(dtype).removeprefix("torch."),
                                 ms=cuda_ms(fn), plain_ms=cuda_ms(plain), library_ms=None,
                                 product_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
                                 bytes=nbytes, flops=0, tile=None))
            del h, idt, g_out, g_sh, out, sh, r_out, r_sh, timed
            if backward:
                del g_in, r_g
            torch.cuda.empty_cache()

    for path, (m, k, n), per_fwd in [(path, shape, per_fwd) for path, shapes in gemm_paths
                                     for shape, per_fwd in sorted(shapes.items())]:
        x = torch.randn((m, 1, 1, k), generator=gen, device=dev).to(bf16)
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(bf16)
        y, s1, s2 = conv.conv1x1_with_stats_fwd(x, w)
        ry, rs1, rs2 = conv.gemm_stats_plain(x, w)
        torch.cuda.synchronize()
        err = (y.float() - ry.float()).abs()
        if not bool((err <= bf16_ulp(ry.float())).all()):
            raise AssertionError(f"conv1x1_with_stats y is off by more than one bf16 ulp at "
                                 f"{(m, k, n)}")
        for got, ref, what in ((s1, rs1, "s1"), (s2, rs2, "s2")):
            torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3 * float(ref.abs().max()),
                                       msg=lambda s: f"conv1x1_with_stats {what} {(m, k, n)}: {s}")
        x2 = x.reshape(m, k)

        def library():
            yl = torch.matmul(x2, w)
            yf = yl.float()
            return yf.sum(0), (yf * yf).sum(0)

        nbytes = 2 * (m * k + m * n + k * n) + 2 * 4 * n
        flops = 2 * m * k * n
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append(dict(kernel=CONV, shape=[m, k, n], per_path=per_fwd,
                         ms=cuda_ms(lambda: conv.conv1x1_with_stats_fwd(x, w)),
                         plain_ms=cuda_ms(lambda: conv.gemm_stats_plain(x, w)),
                         library_ms=cuda_ms(library),
                         product_ms=cuda_ms(lambda: torch.matmul(x2, w)), bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=float(err.max()),
                         bytes=nbytes, flops=flops, tile=tile_of(m, k, n),
                         **({} if path is None else {"path": path})))
        # the autograd backward on the card against the JAX rule (_bwd4) in f32
        # on the kernel's own y: dy = bf16(gy + gs1 + 2 gs2 y), then dy @ w.T
        # and x.T @ dy. (Autograd through the plain version is no reference
        # here: it rounds gs1 + 2 gs2 y to bf16 before adding gy, which drops
        # the small gs2 term systematically over M rows.)
        gy = torch.randn((m, 1, 1, n), generator=gen, device=dev).to(bf16)
        gs1 = torch.randn((n,), generator=gen, device=dev)
        gs2 = torch.randn((n,), generator=gen, device=dev) * 1e-3
        xi, wi = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        yk, s1k, s2k = conv.conv1x1_with_stats(xi, wi)
        torch.autograd.backward([yk, s1k, s2k], [gy, gs1, gs2])
        dy = (gy.float() + gs1 + 2.0 * gs2 * yk.detach().float()).to(bf16).float().reshape(m, n)
        for got, ref, what in ((xi.grad, (dy @ w.float().t()).reshape(x.shape), "dx"),
                               (wi.grad, x2.float().t() @ dy, "dw")):
            torch.testing.assert_close(got.float(), ref, rtol=1e-2,
                                       atol=1e-2 * float(ref.abs().max()),
                                       msg=lambda s: f"conv1x1_with_stats {what} {(m, k, n)}: {s}")
        del x, w, y, ry, x2, gy, xi, wi, yk, dy

    return rows


def block_operands(dev, gen, nt, hw, c, cm, dtype):
    """x (NT, H, W, C), y (NT, H, W, Cm), a, b (Cm,) with b > 0 on every channel
    (a halo of relu(b) would show), w1 (C, Cm), w2 (3, 3, Cm, Cm), w3 (Cm, C)."""
    x = torch.randn((nt, hw, hw, c), generator=gen, device=dev).to(dtype)
    y = torch.randn((nt, hw, hw, cm), generator=gen, device=dev).to(dtype)
    a = torch.rand((cm,), generator=gen, device=dev) + 0.5
    b = torch.randn((cm,), generator=gen, device=dev).abs() * 0.5 + 0.1
    w1 = (torch.randn((c, cm), generator=gen, device=dev) / math.sqrt(c)).to(dtype)
    w2 = (torch.randn((3, 3, cm, cm), generator=gen, device=dev) / math.sqrt(9 * cm)).to(dtype)
    w3 = (torch.randn((cm, c), generator=gen, device=dev) / math.sqrt(cm)).to(dtype)
    return x, y, a, b, w1, w2, w3


def same_twice(what, fn):
    """fn() twice, the same bits both times; returns the first."""
    first, again = fn(), fn()
    if not all(torch.equal(u, v) for u, v in zip(first, again)):
        raise AssertionError(f"{what}: a second run differs")
    return first


def assert_stats(what, got, ref):
    """y within one bf16 ulp of the plain version's, the statistics rtol 1e-3."""
    (y, s1, s2), (ry, rs1, rs2) = got, ref
    if y.shape != ry.shape or y.dtype != ry.dtype:
        raise AssertionError(f"{what}: y {tuple(y.shape)} {y.dtype} vs {tuple(ry.shape)} "
                             f"{ry.dtype}")
    err = (y.float() - ry.float()).abs()
    if not bool((err <= bf16_ulp(ry.float())).all()):
        raise AssertionError(f"{what}: y is off by more than one bf16 ulp "
                             f"(max abs err {float(err.max())})")
    for g, r, name in ((s1, rs1, "s1"), (s2, rs2, "s2")):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3 * float(r.abs().max()),
                                   msg=lambda m: f"{what} {name}: {m}")
    return float(err.max())


def off_terms(out, ref, terms, tol):
    """Elements with |out - ref| > tol + tol * (|ref| + sum |term|), and the
    largest |out - ref|. The block's output is relu(y3 * a3 + b3 + x) rounded
    to bf16, so one ulp of a large term shows in a small output: the
    tolerance is taken against the terms' size."""
    scale = ref.float().abs() + sum(t.float().abs() for t in terms)
    err = (out.float() - ref.float()).abs()
    return int((err > tol + tol * scale).sum()), float(err.max())


def assert_block_close(what, out, ref, terms):
    """Every element within 5e-2 of the terms, and all but 1e-5 of them within
    2e-2. Three bf16 roundings, each a legitimate ulp apart between two
    summation orders, feed the next stage's normalize; on 10^8 outputs a
    few elements land outside 2e-2 (one ulp of y3 amplified by a3)."""
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{what}: not finite")
    n_tight, err = off_terms(out, ref, terms, 2e-2)
    n_loose, _ = off_terms(out, ref, terms, 5e-2)
    if n_loose or n_tight > 1e-5 * out.numel():
        raise AssertionError(f"{what}: {n_tight} of {out.numel()} elements outside 2e-2, "
                             f"{n_loose} outside 5e-2 (max abs err {err})")
    return dict(max_abs_err=err, outside_2e2=n_tight, numel=out.numel())


def timed_row(kernel, shape, per_path, fn, plain, library, nbytes, flops, err, product=None,
              tile=None, peak=PEAK_BF16_FLOPS):
    """One kernel row; ``product`` is the bare library product (no statistics),
    ``tile`` the wgmma core's plan for the shape, ``peak`` the card's rate for
    the type of ``flops``."""
    b_ms, b_by = bound_ms(nbytes, flops, peak)
    return dict(kernel=kernel, shape=list(shape), per_path=per_path, ms=cuda_ms(fn),
                plain_ms=cuda_ms(plain), library_ms=None if library is None else cuda_ms(library),
                product_ms=None if product is None else cuda_ms(product),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, bytes=nbytes, flops=flops,
                peak_flops=peak, tile=tile)


def tile_of(m, k, n):
    """The tile plan the wgmma kernels make for an (M, K, N) product on this
    card, as the C side reports it."""
    from bdvcil_torch.ops import gemm_plan

    dev = torch.device("cuda", 0)
    p = gemm_plan.kernel_plan(m, k, n, dev)
    return dict(block=[gemm_plan.BLOCK_M, p.block_n], tiles=p.tiles, grid=p.grid,
                waves=p.tiles / torch.cuda.get_device_properties(dev).multi_processor_count)


def stats_of(y):
    """The library yardstick's statistics: two f32 sums over the channels."""
    yf = y.float().reshape(-1, y.shape[-1])
    return yf.sum(0), (yf * yf).sum(0)


def batchnorm_rows(dev, gen):
    """Train-mode BatchNorm's five kernels (bf16, relu'd, as every module
    BatchNorm with a relu after it) at the stem and layer1 of batch 16,
    against their plain versions: given the same sums, the finalize, the
    normalize and dx bit for bit; the sums within 1e-5 of their terms'
    absolute sum (float64's for the forward's, the plain f32 ones for the
    backward's).
    ``library_ms``: F.batch_norm's whole forward (on the statistics row) and
    whole backward (on the reduction's)."""
    from bdvcil_torch.models.norm import BatchNorm
    from bdvcil_torch.ops import batchnorm as bn_ops

    rows = []
    for path, shape in BN_SHAPES.items():
        n, c = shape[0] * shape[2] * shape[3], shape[1]
        elems = n * c
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bn = BatchNorm(c, dtype=torch.bfloat16).to(dev)
        spec = bn_ops._Spec(False, True, torch.bfloat16, float(n), bn.epsilon, 1, False)
        k = bn_ops._Kernels(x, 1)
        s1, s2 = k.stats(x, 1)
        coef = k.finalize(s1, s2, spec.count, bn, spec)
        sg, sgx = k.bwd_reduce(g, x, coef, spec)
        xd = x.double()
        errs = {
            BN_STATS: max(float(((u.double() - v) / t).abs().max()) for u, v, t in (
                (s1, xd.sum((0, 2, 3)), xd.abs().sum((0, 2, 3))),
                (s2, (xd * xd).sum((0, 2, 3)), (xd * xd).sum((0, 2, 3))))),
            BN_FINALIZE: float((coef - bn_ops.finalize_plain(
                s1, s2, spec.count, BatchNorm(c).to(dev), spec)).abs().max()),
            BN_APPLY: float((k.apply(x, coef, spec).float()
                             - bn_ops.apply_plain(x, coef, spec).float()).abs().max()),
            BN_BWD_DX: float((k.bwd_dx(g, x, coef, sg, sgx, spec.count, spec).float()
                              - bn_ops.bwd_dx_plain(g, x, coef, sg, sgx, spec.count,
                                                    spec).float()).abs().max()),
        }
        sg_p, sgx_p = bn_ops.bwd_reduce_plain(g, x, coef, spec)
        gm = bn_ops._masked_g(g, x, coef, spec).abs()
        errs[BN_BWD_REDUCE] = max(float(((u - v).abs() / t).max()) for u, v, t in (
            (sg, sg_p, gm.sum((0, 2, 3))),
            (sgx, sgx_p, (gm * bn_ops._xhat(x, coef, spec).abs()).sum((0, 2, 3)))))
        del gm
        for name in (BN_FINALIZE, BN_APPLY, BN_BWD_DX):
            if errs[name] != 0:
                raise AssertionError(f"{name} {path}: off the plain version by {errs[name]}")
        if not max(errs[BN_STATS], errs[BN_BWD_REDUCE]) <= 1e-5:
            raise AssertionError(f"batchnorm sums {path}: off by {errs}")
        xl = x.detach().requires_grad_(True)
        rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        w, b = bn.weight.detach(), bn.bias.detach()
        lib_out = F.batch_norm(xl, rm, rv, w, b, training=True, momentum=0.1, eps=bn.epsilon)
        calls = {
            BN_STATS: (lambda: k.stats(x, 1), lambda: bn_ops.stats_plain(x, 1),
                       lambda: F.batch_norm(x, rm, rv, w, b, training=True, momentum=0.1,
                                            eps=bn.epsilon), 2 * elems, 3 * elems),
            BN_FINALIZE: (lambda: k.finalize(s1, s2, spec.count, bn, spec),
                          lambda: bn_ops.finalize_plain(s1, s2, spec.count, bn, spec), None,
                          11 * 4 * c, 12 * c),
            BN_APPLY: (lambda: k.apply(x, coef, spec), lambda: bn_ops.apply_plain(x, coef, spec),
                       None, 4 * elems, 4 * elems),
            BN_BWD_REDUCE: (lambda: k.bwd_reduce(g, x, coef, spec),
                            lambda: bn_ops.bwd_reduce_plain(g, x, coef, spec),
                            lambda: torch.autograd.grad(lib_out, (xl, ), g, retain_graph=True),
                            4 * elems, 8 * elems),
            BN_BWD_DX: (lambda: k.bwd_dx(g, x, coef, sg, sgx, spec.count, spec),
                        lambda: bn_ops.bwd_dx_plain(g, x, coef, sg, sgx, spec.count, spec),
                        None, 6 * elems, 12 * elems),
        }
        for name, (fn, plain, library, nbytes, flops) in calls.items():
            row = timed_row(name, shape, 1, fn, plain, library, nbytes, flops, errs[name],
                            peak=PEAK_F32_FLOPS)
            rows.append(dict(row, bn_path=path))
        del x, g, xl, lib_out, xd
        torch.cuda.empty_cache()
    return rows


def kernel_phase_2(dev, gen, shift_shapes, conv, tsm, bf):
    """Kernels #4-#8 and the block's tail against their plain versions at the
    shapes of their paths."""
    rows = []
    bf16 = torch.bfloat16

    # #4 gemm_with_stats: forward, and the VJP against JAX's _bwd rule in f32
    for m, k, n in GEMM_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(bf16)
        err = assert_stats(f"{GEMM} {(m, k, n)}", conv.gemm_with_stats_fwd(x, w),
                           conv.gemm_stats_plain(x, w))
        gy = torch.randn((m, n), generator=gen, device=dev).to(bf16)
        gs1 = torch.randn((n,), generator=gen, device=dev)
        gs2 = torch.randn((n,), generator=gen, device=dev) * 1e-3
        xi, wi = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y, s1, s2 = conv.gemm_with_stats(xi, wi)
        torch.autograd.backward([y, s1, s2], [gy, gs1, gs2])
        dy = (gy.float() + gs1 + 2.0 * gs2 * y.detach().float()).to(bf16).float()
        for got, ref, what in ((xi.grad, dy @ w.float().t(), "dx"),
                               (wi.grad, x.float().t() @ dy, "dw")):
            torch.testing.assert_close(got.float(), ref, rtol=1e-2,
                                       atol=1e-2 * float(ref.abs().max()),
                                       msg=lambda s: f"{GEMM} {what} {(m, k, n)}: {s}")
        rows.append(timed_row(
            GEMM, (m, k, n), 1, lambda: conv.gemm_with_stats_fwd(x, w),
            lambda: conv.gemm_stats_plain(x, w), lambda: stats_of(torch.matmul(x, w)),
            2 * (m * k + m * n + k * n) + 2 * 4 * n, 2 * m * k * n, err,
            product=lambda: torch.matmul(x, w), tile=tile_of(m, k, n)))
        del x, w, gy, xi, wi, y, dy

    # #5 the plain shift, forward and reverse: bit-exact
    for shape, dtype in shift_shapes:
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        for reverse, plain in ((False, tsm.temporal_shift), (True, tsm.temporal_unshift)):
            if not torch.equal(tsm.shift_fwd(x, SEGMENTS, 8, reverse), plain(x, SEGMENTS, 8)):
                raise AssertionError(f"{SHIFT} (reverse={reverse}) differs from its plain "
                                     f"version at {shape} {dtype}")
            rows.append(timed_row(
                SHIFT, shape, 1, lambda r=reverse: tsm.shift_fwd(x, SEGMENTS, 8, r),
                lambda p=plain: p(x, SEGMENTS, 8), None, 2 * x.numel() * x.element_size(), 0,
                0.0))
        del x

    # #6-#8 at the stride-1 bottlenecks (layer1 is the block path's shape);
    # b > 0 on every channel, so a halo of relu(b) would show
    for hw, c, cm in BLOCKS:
        per = 1 if (hw, c, cm) == BLOCKS[0] else 0
        m = NT * hw * hw
        x, y, a, b, w1, w2, w3 = block_operands(dev, gen, NT, hw, c, cm, bf16)
        w2_lib = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        y_nchw = y.permute(0, 3, 1, 2)  # channels_last view, no copy
        cases = [
            (CONV1, (m, c, cm), lambda: bf.conv1x1_stats(x, w1),
             lambda: conv.gemm_stats_plain(x, w1),
             lambda: stats_of(torch.matmul(x, w1)), lambda: torch.matmul(x, w1),
             2 * (m * c + m * cm + c * cm) + 8 * cm, 2 * m * c * cm, tile_of(m, c, cm)),
            (CONV3, (m, cm, c), lambda: bf.conv1x1_affine_relu_stats(y, a, b, w3),
             lambda: bf.conv1x1_affine_relu_stats_plain(y, a, b, w3),
             lambda: stats_of(torch.matmul(y, w3)), lambda: torch.matmul(y, w3),
             2 * (m * cm + m * c + cm * c) + 8 * cm + 8 * c, 2 * m * cm * c, tile_of(m, cm, c)),
        ] + [
            (CONV2, (NT, hw, hw, cm, cm, variant),
             lambda v=variant: bf.conv3x3_affine_relu_stats(y, a, b, w2, variant=v),
             lambda v=variant: bf.conv3x3_affine_relu_stats_plain(y, a, b, w2, variant=v),
             lambda: stats_of(F.conv2d(y_nchw, w2_lib, padding=1).permute(0, 2, 3, 1)),
             lambda: F.conv2d(y_nchw, w2_lib, padding=1),
             2 * (2 * m * cm + 9 * cm * cm) + 16 * cm, 2 * m * 9 * cm * cm,
             tile_of(m, 9 * cm, cm))
            for variant in ("taps", "im2col")
        ]
        for name, shape, fn, plain, library, product, nbytes, flops, tile in cases:
            # determinism: the same statistics, bit for bit
            first = same_twice(f"{name} {shape}", fn)
            err = assert_stats(f"{name} {shape}", first, plain())
            # the two variant names are one kernel: count its layer1 time once
            weight = per if shape[-1] != "im2col" else 0
            rows.append(timed_row(name, shape, weight, fn, plain, library, nbytes, flops, err,
                                  product=product, tile=tile))
            del first
        del y, w1, w2, w3, w2_lib, y_nchw
        rows += block_tail_rows(dev, gen, x, cm, per, bf)
        del x
        torch.cuda.empty_cache()

    # #7 at a ragged M (rows past M in the last tile), b > 0 on every channel:
    # a prologue applied to the TMA's zero fill would add relu(b) to the sums
    for m, k, n in ((NT * 7 * 7 + 37, 512, 2048), (300, 64, 256)):
        y = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        a = torch.rand((k,), generator=gen, device=dev) + 0.5
        b = torch.rand((k,), generator=gen, device=dev) * 0.5 + 0.1
        w3 = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(bf16)
        first = same_twice(f"{CONV3} ragged {(m, k, n)}",
                           lambda: bf.conv1x1_affine_relu_stats(y, a, b, w3))
        assert_stats(f"{CONV3} ragged {(m, k, n)}", first,
                     bf.conv1x1_affine_relu_stats_plain(y, a, b, w3))
        del y, a, b, w3, first
    return rows


def bits_differ(got, ref):
    """Elements whose bits differ (NaN against NaN counts as equal), and the
    largest |got - ref| over the rest."""
    nan = got.isnan()
    if not torch.equal(nan, ref.isnan()):
        return int((nan != ref.isnan()).sum()), math.inf
    ibits = torch.int16 if got.element_size() == 2 else torch.int32
    differ = (got.view(ibits) != ref.view(ibits)) & ~nan
    err = (got.float() - ref.float()).abs().masked_fill(nan, 0.0)
    return int(differ.sum()), float(err.max())


def block_tail_rows(dev, gen, x, cm, per, bf):
    """The block's tail at one width, bit for bit against the plain versions:
    block_bn_finalize at C and Cm on the sums of x (its C channels and its
    first Cm), block_affine_residual_relu on y3 and x with a NaN pack in y3. At
    layer1 (``per`` = 1) a block runs the finalize twice at Cm and once at
    C, the pass once."""
    nt, hw, _, c = x.shape
    m = nt * hw * hw
    y3 = (torch.randn(x.shape, generator=gen, device=dev) * 3).to(torch.bfloat16)
    y3.view(-1, c)[1, :8] = float("nan")
    a = torch.rand((c,), generator=gen, device=dev) + 0.5
    b = torch.randn((c,), generator=gen, device=dev) * 0.5
    rows = []
    n, err = bits_differ(bf.affine_residual_relu(y3, a, b, x),
                         bf.affine_residual_relu_plain(y3, a, b, x))
    if n:
        raise AssertionError(f"{EPILOGUE} {tuple(x.shape)}: {n} elements differ from the "
                             f"plain version (max abs err {err})")
    rows.append(timed_row(EPILOGUE, list(x.shape), per,
                          lambda: bf.affine_residual_relu(y3, a, b, x),
                          lambda: bf.affine_residual_relu_plain(y3, a, b, x), None,
                          3 * m * c * 2 + 2 * c * 4, 4 * m * c, err, peak=PEAK_F32_FLOPS))
    for width, src, weight in ((c, x, per), (cm, x[..., :cm], 2 * per)):
        s, q = stats_of(src)
        g = torch.rand((width,), generator=gen, device=dev) + 0.5
        beta = torch.randn((width,), generator=gen, device=dev) * 0.1
        n, err = bits_differ(bf.bn_finalize(s, q, g, beta, float(m), 1e-5),
                             bf.bn_finalize_plain(s, q, g, beta, float(m), 1e-5))
        if n:
            raise AssertionError(f"{FINALIZE} C={width}: {n} elements differ from the plain "
                                 f"version (max abs err {err})")
        rows.append(timed_row(FINALIZE, [width], weight,
                              lambda: bf.bn_finalize(s, q, g, beta, float(m), 1e-5),
                              lambda: bf.bn_finalize_plain(s, q, g, beta, float(m), 1e-5), None,
                              8 * width * 4, 10 * width, err, peak=PEAK_F32_FLOPS))
    del y3
    return rows


def block_path(dev, seed, smi):
    """fused_bottleneck_fwd at TSM-R50 layer1 width, both variants, against
    its plain composition and the library-convolution block; once at each
    other stride-1 width against its plain composition; chained ms at
    layer1."""
    from bdvcil_torch import bench_block_fused as bench
    from bdvcil_torch.ops import _build
    from bdvcil_torch.ops import block_fused as bf

    hw, c, cm = BLOCKS[0]
    x, p = bench.block_inputs(NT, hw, c, cm, seed, dev)
    _build.LAUNCHES.clear()
    forwards, checks = 0, {}
    with torch.no_grad():
        lib, lib_stats = bf.plain_bottleneck_fwd(x, p)
        for variant in bf.VARIANTS:
            out, stats = bf.fused_bottleneck_fwd(x, p, conv3x3_variant=variant)
            forwards += 1
            torch.cuda.synchronize()
            ref, ref_stats = bf.fused_bottleneck_fwd_plain(x, p, conv3x3_variant=variant)
            for (got, want, rtol, atol, against) in ((stats, ref_stats, 1e-3, 1e-4, "plain"),
                                                     (stats, lib_stats, 1e-4, 1e-4, "library")):
                for g, w in zip(got, want):
                    for u, v in zip(g, w):
                        torch.testing.assert_close(
                            u, v, rtol=rtol, atol=atol,
                            msg=lambda s: f"block {variant} stats vs {against}: {s}")
            checks[variant] = dict(
                vs_plain=assert_block_close(f"block {variant} vs plain composition", out, ref,
                                            (x, p.b3)),
                vs_library=assert_block_close(f"block {variant} vs library block", out, lib,
                                              (x, p.b3)),
                # the yardstick: two plain schedules against each other
                plain_vs_library=dict(zip(("outside_2e2", "max_abs_err"),
                                          off_terms(ref, lib, (x, p.b3), 2e-2))),
            )
            print(f"block {variant} checks: {checks[variant]}", flush=True)
            del out, stats, ref, ref_stats
        del lib, lib_stats
        blocks = bench.time_blocks(x, p, BLOCK_ITERS, dev)
        forwards += 2 * (BLOCK_ITERS + 2)  # two fused schedules, warm-up and chain
        for hw_o, c_o, cm_o in BLOCKS[1:]:
            key = f"{NT}x{hw_o}x{hw_o}x{c_o}/{cm_o}"
            xo, po = bench.block_inputs(NT, hw_o, c_o, cm_o, seed, dev)
            out, stats = bf.fused_bottleneck_fwd(xo, po)
            forwards += 1
            torch.cuda.synchronize()
            ref, ref_stats = bf.fused_bottleneck_fwd_plain(xo, po)
            for g, w in zip(stats, ref_stats):
                for u, v in zip(g, w):
                    torch.testing.assert_close(u, v, rtol=1e-3, atol=1e-4,
                                               msg=lambda s: f"block {key} stats vs plain: {s}")
            checks[key] = assert_block_close(f"block {key} vs plain composition", out, ref,
                                             (xo, po.b3))
            print(f"block {key} checks: {checks[key]}", flush=True)
            del xo, po, out, stats, ref, ref_stats
    launches = kernel_launches()
    want = {CONV1: forwards, CONV2: forwards, CONV3: forwards, FINALIZE: 3 * forwards,
            EPILOGUE: forwards}
    if launches != want:
        raise AssertionError(f"block path: kernel launches {launches}, expected {want}")
    result = dict(shape=[NT, hw, hw, c, cm], checks=checks, launches=launches,
                  iters=BLOCK_ITERS, **{f"{k}_ms_per_block": v for k, v in blocks.items()})
    print(f"block {NT}x{hw}x{hw}x{c}/{cm}: fused taps {blocks['fused_taps']:.4f} ms, fused "
          f"im2col {blocks['fused_im2col']:.4f} ms, plain {blocks['plain']:.4f} ms per block "
          f"(chain of {BLOCK_ITERS}), launches {launches} [{smi}]", flush=True)
    del x, p
    torch.cuda.empty_cache()
    return result


def gemm_path(dev, gen):
    """gemm_with_stats, forward and VJP, once at each shape."""
    from bdvcil_torch.ops import _build
    from bdvcil_torch.ops import conv1x1_bn as conv

    _build.LAUNCHES.clear()
    for m, k, n in GEMM_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16).requires_grad_(True)
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        w.requires_grad_(True)
        y, s1, s2 = conv.gemm_with_stats(x, w)
        (y.float().mean() + s1.mean() * 1e-3 + s2.mean() * 1e-6).backward()
        for t in (y, s1, s2, x.grad, w.grad):
            if not bool(torch.isfinite(t.float()).all()):
                raise AssertionError(f"gemm path {(m, k, n)}: non-finite output")
        if y.shape != (m, n):
            raise AssertionError(f"gemm path: y {tuple(y.shape)} for M={m}, N={n}")
        del x, w, y
    launches = kernel_launches()
    if launches != {GEMM: len(GEMM_SHAPES)}:
        raise AssertionError(f"gemm path: kernel launches {launches}")
    return launches


def shift_path(dev, gen, shift_shapes):
    """temporal_shift_kernel, forward and VJP, once at each shape; bit-exact
    against the plain shift and its transpose."""
    from bdvcil_torch.ops import _build
    from bdvcil_torch.ops import tsm_shift as tsm

    _build.LAUNCHES.clear()
    for shape, dtype in shift_shapes:
        x = torch.randn(shape, generator=gen, device=dev).to(dtype).requires_grad_(True)
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        out = tsm.temporal_shift_kernel(x, SEGMENTS, 8)
        out.backward(g)
        with torch.no_grad():
            if not (torch.equal(out, tsm.temporal_shift(x, SEGMENTS, 8))
                    and torch.equal(x.grad, tsm.temporal_unshift(g, SEGMENTS, 8))):
                raise AssertionError(f"shift path {shape} {dtype}: differs from the plain shift")
        del x, g, out
    launches = kernel_launches()
    if launches != {SHIFT: 2 * len(shift_shapes)}:
        raise AssertionError(f"shift path: kernel launches {launches}")
    return launches


def reference_phase(dev, seed):
    """One small train step per configuration on the card against the CPU."""
    from bdvcil_torch import config_templates as presets
    from bdvcil_torch import optim, runtime
    from bdvcil_torch.models import builder

    out = {}
    x = torch.randn((2, SEGMENTS, 64, 64, 3), generator=torch.Generator().manual_seed(seed))
    y = torch.tensor([1, 3])
    for name in KERNEL_CONFIGS:
        cfg = presets.hmdb51_r50_cfg(5, SEGMENTS, dropout_ratio=0.0, **presets.SWITCHES[name])
        losses = {}
        for where in ("cpu", dev):
            spec = builder.build_model(cfg, dtype=torch.bfloat16, device=where)
            model = builder.init_model_params(spec, seed)
            tx = optim.build_optimizer(model, presets.OPTIMIZER)
            state, m = runtime.make_train_step(spec, tx, 5)(
                runtime.TrainState.create(model, tx), None, x.to(where), y.to(where), {})
            losses[str(torch.device(where).type)] = float(m["loss"])
        rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        # bf16 activations through 50 layers, two conv libraries: a few % apart
        if not math.isfinite(losses["cuda"]) or rel > 3e-2:
            raise AssertionError(f"config {name}: card loss {losses['cuda']} vs CPU "
                                 f"{losses['cpu']} (rel {rel})")
        out[name] = dict(losses, rel_diff=rel)
        print(f"reference {name}: loss card {losses['cuda']} cpu {losses['cpu']} rel {rel}",
              flush=True)
    return out


def pinned_wire_batch(wire_format, seed, acm=False):
    """A synthetic wire batch of 16 clips x 8 frames at 224², pinned; the
    planes wire at UCF101's stored 320 x 240 (bench.py:305); RandAugment on
    3/4 of the clips (bench.py:572), BGMix on the others."""
    from bdvcil_torch.data import device_pipeline as dp
    from bdvcil_torch.data.synthetic import wire_batch

    return dp.pin_batch(wire_batch(wire_format, BATCH, SEGMENTS, SIZE, seed=seed,
                                   stored=UCF_STORED, acm=acm))


def train_phase(name, dev, seed, smi, fed=False):
    """3 task-0 steps, growth, 3 task-1 KD steps at full width; with ``fed``
    the steps take the yuv420 wire batch through the main input function."""
    from bdvcil_torch import config_templates as presets
    from bdvcil_torch.data import device_pipeline as dp
    from bdvcil_torch.models import build_model, init_model_params, update_fc
    from bdvcil_torch.ops import _build
    from bdvcil_torch.optim import build_optimizer
    from bdvcil_torch.runtime import TrainState, make_multi_train_step, make_train_step

    backbone = presets.SWITCHES[name]
    nc0 = presets.HMDB51_BASE_CLASSES
    nc1 = nc0 + presets.HMDB51_CLASSES_PER_TASK
    spec = build_model(presets.hmdb51_r50_cfg(nc0, SEGMENTS, **backbone), dtype=torch.bfloat16,
                       device=dev)
    model = init_model_params(spec, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if fed:  # the main path's input function (bench.py:554-598 on the yuv420 wire)
        input_fn = dp.make_fast_input_fn(alpha=0.5, with_randaug=True, dtype=torch.bfloat16,
                                         wire_format="yuv420")
        imgs = dp.batch_to_device(pinned_wire_batch("yuv420", seed), dev)
    else:
        input_fn = None
        imgs = torch.randn((BATCH, SEGMENTS, SIZE, SIZE, 3), generator=gen, device=dev)
    labels0 = torch.randint(0, nc0, (BATCH,), generator=gen, device=dev)
    labels1 = torch.randint(0, nc1, (BATCH,), generator=gen, device=dev)
    drop = torch.Generator(device=dev).manual_seed(seed + 1)
    watch = ["backbone.conv1.weight", "backbone.layer4.2.conv3.weight", "cls_head.eta"]
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    tx = build_optimizer(model, presets.OPTIMIZER, presets.LR_SCHEDULER, steps_per_epoch=100)
    state = TrainState.create(model, tx)
    step0 = make_train_step(spec, tx, nc0, input_fn=input_fn)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.LAUNCHES.clear()
    records = []

    def run(tag, step, prev, labels):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, prev, imgs, labels, {}, drop)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        rec = dict(task=tag, ms=dt, **{k: float(v) for k, v in m.items()})
        records.append(rec)
        if not all(math.isfinite(v) for v in rec.values() if isinstance(v, float)):
            raise AssertionError(f"config {name}: non-finite metrics {rec}")

    for _ in range(3):
        run("task0", step0, None, labels0)
    # task 1: the previous model is a copy before growth; both grow 26 -> 31
    prev = copy.deepcopy(state.module)
    grow = torch.Generator().manual_seed(seed + 2)
    update_fc(state.module, nc1, grow)
    update_fc(prev, nc1, grow)
    tx1 = build_optimizer(state.module, presets.OPTIMIZER, presets.LR_SCHEDULER,
                          steps_per_epoch=100, grad_clip=presets.GRAD_CLIP)
    state = TrainState.create(state.module, tx1)
    kd = presets.kd_config(nc1, nc1 - nc0)
    step_kw = dict(spec=spec, tx=tx1, num_classes=nc1, task_idx=1, prev_num_classes=nc0,
                   kd_config=kd, input_fn=input_fn)
    step1 = make_train_step(**step_kw)
    for _ in range(3):
        run("task1", step1, prev, labels1)
    launches = dict(_build.LAUNCHES)

    if not all(r["kd_loss"] > 0 for r in records[3:]):
        raise AssertionError(f"config {name}: KD did not contribute at task 1")
    after = state.module.state_dict()
    for key in watch:
        if torch.equal(after[key][: before[key].shape[0]], before[key]):
            raise AssertionError(f"config {name}: {key} did not move")
    stats = [k for k in before if k.endswith("running_mean") or k.endswith("running_var")]
    unchanged = [k for k in stats if torch.equal(after[k], before[k])]
    if unchanged:
        raise AssertionError(f"config {name}: running stats not updated: {unchanged[:3]}")

    t0 = statistics.median(r["ms"] for r in records[1:3])
    t1 = statistics.median(r["ms"] for r in records[4:6])
    result = dict(
        config=name, backbone=backbone, fed=fed, launches=launches, steps=records,
        task0_step_ms=t0, task1_step_ms=t1,
        task0_clips_per_s=BATCH / (t0 / 1e3), task1_clips_per_s=BATCH / (t1 / 1e3),
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
    )
    tag = f"train {name}{' fed by make_fast_input_fn(yuv420)' if fed else ''} {backbone}"
    print(f"{tag}: task-0 step {t0:.2f} ms ({result['task0_clips_per_s']:.2f} "
          f"clips/s), task-1 KD step {t1:.2f} ms ({result['task1_clips_per_s']:.2f} clips/s), "
          f"peak {result['peak_mem_gib']:.1f} GiB, launches {launches} [{smi}]", flush=True)
    if fed:
        with torch.no_grad():
            in_ms = cuda_ms(lambda: input_fn(imgs), reps=5)
        # K = 2 inner steps in one call, each slot its own copy of the batch
        multi = make_multi_train_step(step_kw, 2)
        stacked = {k: torch.stack([v, v]) for k, v in imgs.items()}
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, m = multi(state, prev, stacked, torch.stack([labels1, labels1]), {}, [drop, drop])
        torch.cuda.synchronize()
        multi_ms = (time.perf_counter() - start) * 1e3
        if state.step != 5 or not all(math.isfinite(float(v)) for v in m.values()):
            raise AssertionError(f"multi-step K=2: step {state.step}, metrics {m}")
        result.update(input_fn_ms=in_ms, input_share_task0=in_ms / t0, input_share_task1=in_ms / t1,
                      multi_k2_ms=multi_ms, multi_k2_loss=float(m["loss"]))
        print(f"{tag}: input function {in_ms:.3f} ms per batch, {100 * in_ms / t0:.1f}% of the "
              f"task-0 step, {100 * in_ms / t1:.1f}% of the task-1 step; make_multi_train_step "
              f"K=2 one call {multi_ms:.2f} ms, loss {float(m['loss']):.4f} [{smi}]", flush=True)
    del state, prev, model
    torch.cuda.empty_cache()
    return result


def input_phase(dev, seed, smi):
    """Each input function on the card against the CPU (the first 4 clips),
    with no device-to-host sync; H2D and per-batch times."""
    from bdvcil_torch.data import device_pipeline as dp

    # the same masks and RandAugment draws for every wire format
    cases = [(f"make_fast_input_fn {fmt}", fmt, False) for fmt in dp.WIRE_FORMATS]
    cases.append(("make_fast_acm_input_fn yuv420", "yuv420", True))
    out = {}
    for name, fmt, acm in cases:
        host = pinned_wire_batch(fmt, seed, acm)
        if acm:
            fn = dp.make_fast_acm_input_fn(dtype=torch.bfloat16, wire_format=fmt)
        else:
            fn = dp.make_fast_input_fn(alpha=0.5, with_randaug=True, dtype=torch.bfloat16,
                                       wire_format=fmt)
        nbytes = sum(v.numel() * v.element_size() for k, v in host.items()
                     if k not in dp.HOST_KEYS)
        dp.batch_to_device(host, dev)  # warm-up: the allocator's first blocks
        torch.cuda.synchronize()
        h2d = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            batch = dp.batch_to_device(host, dev)
            end.record()
            end.synchronize()
            h2d.append(start.elapsed_time(end))
        with torch.no_grad():
            torch.cuda.set_sync_debug_mode("error")  # any hidden sync raises
            try:
                got, got_u8 = fn(batch), fn.uint8_stage(batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            cpu = {k: v[:4] for k, v in host.items()}
            ref, ref_u8 = fn(cpu), fn.uint8_stage(cpu)
            pairs = (zip(got_u8, ref_u8) if isinstance(got_u8, tuple) else [(got_u8, ref_u8)])
            for g, r in pairs:
                if g is not None and not torch.equal(g[:4].cpu(), r):
                    raise AssertionError(f"input {name}: the uint8 stage differs from the CPU's")
            g = got[:4].float().cpu()
            err = (g - ref.float()).abs()
            if got.shape != (BATCH, SEGMENTS, SIZE, SIZE, 3) or got.dtype != torch.bfloat16:
                raise AssertionError(f"input {name}: {tuple(got.shape)} {got.dtype}")
            if not bool(torch.isfinite(got.float()).all()) or not bool(
                    (err <= bf16_ulp(ref.float())).all()):
                raise AssertionError(f"input {name}: off the CPU by more than one bf16 ulp "
                                     f"(max {float(err.max())})")
            ms = cuda_ms(lambda: fn(batch), reps=5)
            # its parts: the wire decoded to RGB, then RandAugment (and for
            # ACM the composite), then the float stage
            decode_ms = cuda_ms(lambda: dp.decode_wire(batch, "imgs", fmt), reps=5)
            u8_ms = cuda_ms(lambda: fn.uint8_stage(batch), reps=5)
        out[name] = dict(wire_bytes=nbytes, h2d_ms=statistics.median(h2d), input_fn_ms=ms,
                         decode_imgs_ms=decode_ms, uint8_stage_ms=u8_ms,
                         max_abs_err_vs_cpu=float(err.max()), differing_vs_cpu=int((err > 0).sum()),
                         randaug_clips=int(host["apply_randaug"].sum()))
        print(f"input {name}: wire {nbytes / 1e6:.2f} MB, H2D {out[name]['h2d_ms']:.3f} ms "
              f"(pinned), input function {ms:.3f} ms per batch (16 x 8 x 224², bf16 out; "
              f"uint8 stage {u8_ms:.3f}, of it the clips' decode {decode_ms:.3f}), "
              f"card vs CPU on 4 clips: uint8 stage equal, bf16 max abs err {float(err.max())}, "
              f"no device sync [{smi}]", flush=True)
        del host, batch, got, got_u8
    torch.cuda.empty_cache()
    return out


def icarl_reference_phase(dev, seed):
    """One small task-1 step of each iCaRL method on the card against the CPU:
    'icarl' with ActorCutMix smoothing, 'icarl_video_mix' with tube-CutMix
    (draws from a CPU generator, the same on both sides); soft targets from
    the previous model for the old classes (label < 3)."""
    from bdvcil_torch import config_templates as presets
    from bdvcil_torch import optim, runtime
    from bdvcil_torch.models import builder

    cfg = presets.hmdb51_r50_cfg(5, SEGMENTS, dropout_ratio=0.0, **presets.SWITCHES["A"])
    x = torch.randn((2, SEGMENTS, 64, 64, 3), generator=torch.Generator().manual_seed(seed))
    y = torch.tensor([1, 3])
    acm = dict(foreground_ratio=torch.tensor([0.3, 0.9]), background_label=torch.tensor([[2], [-1]]))
    out = {}
    for method, extra, video_mix in (("icarl", acm, None),
                                     ("icarl_video_mix", {}, dict(alpha=1.0, prob=1.0))):
        losses = {}
        for where in ("cpu", dev):
            spec = builder.build_model(cfg, dtype=torch.bfloat16, device=where)
            model = builder.init_model_params(spec, seed)
            prev = copy.deepcopy(model)
            tx = optim.build_optimizer(model, presets.OPTIMIZER)
            step = runtime.make_train_step(spec, tx, 5, method=method, task_idx=1,
                                           prev_num_classes=3, video_mix=video_mix)
            _, m = step(runtime.TrainState.create(model, tx), prev, x.to(where), y.to(where),
                        {k: v.to(where) for k, v in extra.items()},
                        torch.Generator().manual_seed(seed))
            losses[str(torch.device(where).type)] = float(m["loss"])
        rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        if not math.isfinite(losses["cuda"]) or rel > 3e-2:
            raise AssertionError(f"{method}: card loss {losses['cuda']} vs CPU {losses['cpu']} "
                                 f"(rel {rel})")
        out[method] = dict(losses, rel_diff=rel)
        print(f"reference {method} (task 1, config A): loss card {losses['cuda']} cpu "
              f"{losses['cpu']} rel {rel}", flush=True)
    return out


def _host_tree(state):
    """(module state_dict, momentum, optimizer count, step) on the host."""
    return ({k: v.detach().cpu().clone() for k, v in state.module.state_dict().items()},
            {k: v.detach().cpu().clone() for k, v in state.opt_state["momentum"].items()},
            state.opt_state["count"], state.step)


def _tree_diff(a, b):
    """(names of leaves that differ, largest |a - b| over all leaves)."""
    names, worst = [], 0.0
    for part_a, part_b in zip(a[:2], b[:2]):
        for k, v in part_a.items():
            if not torch.equal(v, part_b[k]):
                names.append(k)
                worst = max(worst, float((v.float() - part_b[k].float()).abs().max()))
    return names + [f"{what} {x} != {y}" for what, x, y in
                    (("count", a[2], b[2]), ("step", a[3], b[3])) if x != y], worst


def loop_phase(dev, seed, smi, conv_per_step):
    """Phase 9: a JPEG corpus from the port's writer, ``FastBGMixLoader`` over
    it, train_epochs in configuration A at full width, and the snapshot
    resume, bit for bit."""
    import shutil
    import warnings

    from bdvcil_torch import config_templates as presets
    from bdvcil_torch.data import corpus, native
    from bdvcil_torch.data import device_pipeline as dp
    from bdvcil_torch.data.loaders import FastBGMixLoader
    from bdvcil_torch.models import build_model, init_model_params
    from bdvcil_torch.ops import _build
    from bdvcil_torch.optim import build_optimizer
    from bdvcil_torch.runtime import TrainState, checkpoint, loops, make_multi_train_step
    from bdvcil_torch.runtime import make_train_step
    from bdvcil_torch.utils import Throughput

    if not native.available():  # the port's codec needs only g++: no fallback
        raise AssertionError(f"loop: native decoder unavailable: {native.build_error()}")
    out = dict(host_cpus=len(os.sched_getaffinity(0)))
    root = pathlib.Path("chiprun_out/loop_corpus")
    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        t0 = time.perf_counter()
        infos, bg_files = corpus.write_corpus(root, LOOP_VIDEOS, seed=seed,
                                              num_classes=LOOP_CLASSES)
        out["corpus_s"] = time.perf_counter() - t0
        loader = FastBGMixLoader(infos, bg_files, batch_size=BATCH, num_segments=SEGMENTS,
                                 crop_size=SIZE, randaug_prob=0.75, seed=seed,
                                 wire_format="auto")
        out.update(loader=type(loader).__name__, loader_source="jpeg",
                   wire_format=loader.wire_format, videos=LOOP_VIDEOS,
                   steps_per_epoch=len(loader), k=LOOP_K)
        print(f"loader: {type(loader).__name__} ({loader.wire_format} wire) over "
              f"{LOOP_VIDEOS} videos of JPEG frames written by the port's writer in "
              f"{out['corpus_s']:.1f} s", flush=True)
        fn = dp.make_fast_input_fn(alpha=0.5, with_randaug=True, dtype=torch.bfloat16,
                                   wire_format=loader.wire_format)

        # the loader's first batch through the input function: card against CPU
        it = iter(loader)
        first = next(it)
        it.close()
        with torch.no_grad():
            got = fn.uint8_stage(dp.batch_to_device(dp.pin_batch(first), dev))
            ref = fn.uint8_stage(dp.batch_to_device({k: v[:4] for k, v in first.items()}, "cpu"))
        for g, r in zip(got, ref):
            if not torch.equal(g[:4].cpu(), r):
                raise AssertionError("loop: the loader's first batch, uint8 stage, differs "
                                     "between the card and the CPU")
        del got, ref

        cfg = presets.hmdb51_r50_cfg(LOOP_CLASSES, SEGMENTS, **presets.SWITCHES["A"])

        def build(init_seed):
            spec = build_model(cfg, dtype=torch.bfloat16, device=dev)
            model = init_model_params(spec, init_seed)
            tx = build_optimizer(model, presets.OPTIMIZER, presets.LR_SCHEDULER,
                                 steps_per_epoch=len(loader))
            kw = dict(spec=spec, tx=tx, num_classes=LOOP_CLASSES, input_fn=fn)
            return (TrainState.create(model, tx), make_train_step(**kw),
                    make_multi_train_step(kw, LOOP_K))

        def run(built_state, num_epochs, start_epoch=0, **kw):
            state, single, multi = built_state
            return loops.train_epochs(single, state, None, loader, num_epochs, seed, device=dev,
                                      start_epoch=start_epoch, multi_step_fn=multi,
                                      steps_per_dispatch=LOOP_K, log_every_n_steps=LOOP_K, **kw)

        # train_epochs, 2 epochs, with the launch counts set to 0 just before
        state = build(seed)
        watch = ["backbone.conv1.weight", "backbone.layer4.2.conv3.weight", "cls_head.eta"]
        before = {k: state[0].module.state_dict()[k].detach().clone() for k in watch}
        meter, ends = Throughput(warmup=1), []

        def epoch_end(epoch, _):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())

        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        trained, last = run(state, LOOP_EPOCHS, epoch_hook=epoch_end, meter=meter)
        launches = kernel_launches()
        wall = ends[-1] - t0
        steps = LOOP_EPOCHS * len(loader)
        want = {CONV: conv_per_step * steps, **bn_launches(steps, sums=conv_per_step)}
        if launches != want:
            raise AssertionError(f"loop: kernel launches {launches}, expected {want} over "
                                 f"{steps} steps")
        if trained.step != steps or not all(math.isfinite(v) for v in last.values()):
            raise AssertionError(f"loop: step {trained.step}, last metrics {last}")
        after = trained.module.state_dict()
        still = [k for k in watch if torch.equal(after[k], before[k])]
        if still:
            raise AssertionError(f"loop: parameters did not move: {still}")
        clips = steps * BATCH
        out.update(launches=launches, steps=steps, last_metrics=last, wall_s=wall,
                   e2e_clips_per_s=clips / wall,
                   e2e_clips_per_s_last_epoch=len(loader) * BATCH / (ends[-1] - ends[-2]),
                   producer_wait_s=meter.wait_s, decode_frames_per_step=BATCH * (SEGMENTS + 1))
        print(f"loop A: train_epochs, {LOOP_EPOCHS} epochs x {len(loader)} steps (K={LOOP_K}) "
              f"from JPEG ({loader.wire_format} wire): e2e {out['e2e_clips_per_s']:.2f} "
              f"clips/s over the run, {out['e2e_clips_per_s_last_epoch']:.2f} in the last epoch; "
              f"producer wait {meter.wait_s:.3f} s of {wall:.2f} s; host CPUs "
              f"{out['host_cpus']}; #3 launches {launches[CONV]} = {conv_per_step} x {steps}; "
              f"loss {last['loss']:.4f} [{smi}]", flush=True)
        del state, trained, after, before

        # resume: 3 epochs straight against 1 + snapshot + rebuild + 2, bit for bit
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        snap = root / "mid_task_snapshot_inc_step.pt"
        meta = dict(task=0, phase="inc_step", num_classes=LOOP_CLASSES, run_token="chip_smoke")

        def hook(epoch, st, run_seed):
            checkpoint.save_train_snapshot(snap, st, run_seed, dict(meta, epoch=epoch))

        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            straight = _host_tree(run(build(seed), 3)[0])
            run(build(seed), 1, snapshot_hook=hook)
            snap_meta = checkpoint.peek_train_snapshot_meta(snap)
            if not checkpoint.snapshot_matches(snap_meta, 0, "inc_step", LOOP_CLASSES,
                                               "chip_smoke"):
                raise AssertionError(f"loop: snapshot meta {snap_meta}")
            fresh, single, multi = build(seed + 1)  # other weights: the load sets them all
            restored, run_seed, _ = checkpoint.load_train_snapshot(snap, fresh)
            resumed = _host_tree(run((restored, single, multi), 3,
                                     start_epoch=snap_meta["epoch"] + 1)[0])
        ops = sorted({str(w.message).split("\n")[0] for w in caught
                      if "deterministic" in str(w.message)})
        differ, err = _tree_diff(resumed, straight)
        out.update(resume_s=time.perf_counter() - t0, resume_nondeterministic_ops=ops,
                   resume_leaves=len(straight[0]) + len(straight[1]), resume_differ=differ[:10],
                   resume_max_abs_diff=err)
        if ops:  # name the op, and hold the resume to two straight runs' spread
            _, spread = _tree_diff(_host_tree(run(build(seed), 3)[0]), straight)
            out["straight_spread"] = spread
            print(f"loop resume: ops without a deterministic CUDA form: {ops}; resumed max abs "
                  f"diff {err} against a spread of {spread} between two straight runs",
                  flush=True)
            if err > spread:
                raise AssertionError(f"loop resume: {err} outside the straight runs' spread "
                                     f"{spread}")
        elif differ:
            raise AssertionError(f"loop resume: {len(differ)} leaves differ from the straight "
                                 f"run, e.g. {differ[:5]} (max abs diff {err})")
        else:
            print(f"loop resume: 3 epochs straight == 1 epoch, snapshot, rebuild, load, 2 "
                  f"epochs: bit for bit over {out['resume_leaves']} parameter, buffer and "
                  f"momentum leaves, optimizer count and step "
                  f"({out['resume_s']:.1f} s, deterministic algorithms)", flush=True)
    finally:
        torch.use_deterministic_algorithms(deterministic[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic[1:]
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def write_cil_corpus(root: pathlib.Path, seed: int):
    """The rawframe tree the hmdb51 preset reads under ``root``: JPEG frames
    written with cv2, annotation files, and one background a video (the
    median of its frames)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    w, h = UCF_STORED
    lines = {"train": [], "val": []}
    for cls in range(8):
        for v in range(CIL_TRAIN + CIL_VAL):
            name = f"c{cls}_v{v}"
            vdir = root / "rawframes" / name
            vdir.mkdir(parents=True, exist_ok=True)
            base = rng.integers(0, 200, size=3)
            frames = np.clip(base + rng.integers(0, 56, size=(CIL_FRAMES, h, w, 3)), 0,
                             255).astype(np.uint8)
            for t in range(CIL_FRAMES):
                cv2.imwrite(str(vdir / f"img_{t + 1:05}.jpg"), frames[t])
            (root / "bg_extract").mkdir(exist_ok=True)
            cv2.imwrite(str(root / "bg_extract" / f"{name}.jpg"),
                        np.median(frames, axis=0).astype(np.uint8))
            lines["train" if v < CIL_TRAIN else "val"].append(f"{name} {CIL_FRAMES} {cls}")
    for split, rows in lines.items():
        (root / f"hmdb51_{split}_split_1_rawframes.txt").write_text("\n".join(rows) + "\n")


def cil_config_file(root: pathlib.Path, splits=CIL_SPLITS, switches=None,
                    compute_dtype="bfloat16") -> pathlib.Path:
    """A config file against bdvcil_torch.config_templates: the hmdb51 preset
    (TSM-R50, 8 segments, 224 train crops, TenCrop test at 256) cut to the
    corpus, in configuration B (``switches``: the backbone's) with bf16
    compute (``compute_dtype`` None: the config names none, so the trainer
    takes its default)."""
    switches = dict(shift_mode="fused_block") if switches is None else switches
    dtype = "" if compute_dtype is None else f"compute_dtype={compute_dtype!r}, "
    backbone = "".join(f"_cfg['model']['backbone'][{k!r}] = {v!r}\n" for k, v in switches.items())
    path = root / "cil_config.py"
    path.write_text(f"""from bdvcil_torch.config_templates import make_cil_config
from bdvcil_torch.protocol import adaptive_scale_factors

_splits = {splits!r}
_cfg = make_cil_config("hmdb51", 1000, 3, "bgmix_plus_randAug", data_dir={str(root)!r},
                       work_dir={str(root / "work_dir")!r})
_cfg.update(task_splits=_splits, ending_task=len(_splits) - 1,
            adaptive_scale_factors=adaptive_scale_factors(_splits),
            videos_per_gpu={CIL_BATCH}, testing_videos_per_gpu={CIL_BATCH}, workers_per_gpu=6,
            testing_workers_per_gpu=6, num_epochs_per_task=1, cbf_num_epochs_per_task=1,
            use_cbf=True, budget_size={CIL_BUDGET}, eval_steps_per_dispatch={CIL_EVAL_K},
            {dtype}use_fast_input_pipeline=True, log_every_n_steps=1)
{backbone}_cfg["model"]["cls_head"]["num_classes"] = len(_splits[0])
_cfg["model"]["cls_head"]["inc_head_config"]["out_features"] = len(_splits[0])
globals().update(_cfg)
""")
    return path


def expected_cil_launches(use_cbf: bool = True, splits=CIL_SPLITS, train=CIL_TRAIN,
                          val=CIL_VAL, budget=CIL_BUDGET, train_batch=CIL_BATCH,
                          test_batch=CIL_BATCH, epochs=1, cbf_epochs=1, blocks=CIL_BLOCKS,
                          bns=R50_BNS, dtype=torch.bfloat16):
    """#1 and #2 launches per task of a CIL run in ``shift_mode='fused_block'``
    (``train``/``val`` videos a class, ``budget`` exemplars a seen class):
    every forward (train and CBF steps, the previous model's forward from
    task 1 on: KD in phases 10 and 17, the iCaRL targets in phase 11; the
    herding features at the train batch, the exemplar class means and the val
    test at the test batch) launches #1 once a block, every train or CBF
    backward #2 once a block; then cil_testing's TenCrop forwards (phases 10
    and 11). The loaders wrap-pad the last train or CBF batch to a whole one
    and the eval pads a short batch (``check_fast_loaders``; the host
    pipeline's loaders alike), so each split takes ceil(videos / batch)
    batches. Each train or CBF step also runs train-mode BatchNorm's kernels
    in the current model (``bn_launches``, ``bns`` BatchNorms in ``dtype``)."""
    def batches(n, b):
        return -(-n // b)

    per_task, seen = [], 0
    for t, split in enumerate(splits):
        new = train * len(split)
        steps = batches(new + budget * seen, train_batch) * epochs
        seen += len(split)
        if t > 0 and use_cbf:
            steps += batches(budget * seen, train_batch) * cbf_epochs
        kd = 2 if t > 0 else 1  # the current and the previous model
        fwd = steps * kd + batches(new, train_batch) + batches(budget * seen, test_batch) \
            + batches(val * seen, test_batch)
        per_task.append({FWD: blocks * fwd, BWD: blocks * steps,
                         **bn_launches(steps, bns, dtype=dtype)})
    testing = sum(batches(val * sum(len(s) for s in splits[:t + 1]), test_batch)
                  for t in range(len(splits)))
    return per_task, {FWD: blocks * testing}


def check_fast_loaders(what, stats):
    """Every loader a CIL task took is a fast one: with the decoder built, a
    loader on the host pipeline is an error."""
    host = [note for note in stats["loaders"] if ": host" in note]
    if host:
        raise AssertionError(f"{what}: the host pipeline with the decoder built: {host}")


def cil_phase(dev, seed, smi):
    """Phase 10: a whole class-incremental run through
    bdvcil_torch.cil_tools.train_cil's main() from JPEG files on disk, then
    cil_testing with TenCrop at 256, and the card's eval step against the
    CPU's on one TenCrop batch."""
    import shutil

    from bdvcil_torch.cil import trainer as trainer_mod
    from bdvcil_torch.cil_tools import train_cil
    from bdvcil_torch.models import build_model
    from bdvcil_torch.ops import _build
    from bdvcil_torch.runtime import make_eval_step

    root = pathlib.Path("chiprun_out/cil_corpus").resolve()
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    marks = []
    finish = trainer_mod.CILTrainer._finish_task

    def finish_and_mark(self):
        finish(self)
        torch.cuda.synchronize()
        marks.append(kernel_launches())

    try:
        t0 = time.perf_counter()
        write_cil_corpus(root, seed)
        out["corpus_s"] = time.perf_counter() - t0
        config = cil_config_file(root)
        want_tasks, want_testing = expected_cil_launches()

        trainer_mod.CILTrainer._finish_task = finish_and_mark
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        trainer = train_cil.main([str(config)])
        out["train_s"] = time.perf_counter() - t0
        trainer_mod.CILTrainer._finish_task = finish
        before = collections.Counter(marks[-1])
        t0 = time.perf_counter()
        trainer.cil_testing(test_nme=True)
        torch.cuda.synchronize()
        out["cil_testing_s"] = time.perf_counter() - t0
        testing = kernel_launches(before)

        tasks, prev = [], collections.Counter()
        for t, (stats, mark) in enumerate(zip(trainer.task_stats, marks)):
            got = {k: v - prev.get(k, 0) for k, v in mark.items() if v - prev.get(k, 0)}
            prev = collections.Counter(mark)
            if got != want_tasks[t]:
                raise AssertionError(f"cil task {t}: kernel launches {got}, expected "
                                     f"{want_tasks[t]}")
            cnn, nme = trainer.cnn_matrix[t], trainer.nme_matrix[t]
            for row in (cnn, nme):
                if len(row) != t + 1 or not all(math.isfinite(a) and 0 <= a <= 100 for a in row):
                    raise AssertionError(f"cil task {t}: accuracy row {row}")
            if stats["exemplars"] != CIL_BUDGET * sum(len(s) for s in CIL_SPLITS[:t + 1]):
                raise AssertionError(f"cil task {t}: {stats['exemplars']} exemplars")
            check_fast_loaders(f"cil task {t}", stats)
            by_choice = collections.defaultdict(list)  # "host (why)" -> the phases that took it
            for note in sorted(set(stats["loaders"])):
                what, choice = note.split(": ", 1)
                by_choice[choice].append(what)
            loaders = "; ".join(f"{', '.join(w)}: {c}" for c, w in by_choice.items())
            clips_s = stats["eval_clips"] / stats["eval_s"]
            tasks.append(dict(stats, launches=got, cnn=cnn, nme=nme, eval_clips_per_s=clips_s,
                              loaders=loaders))
            print(f"cil task {t}: loaders {loaders} | train {stats['train_s']:.2f} s, "
                  f"features + herding {stats['exemplar_s']:.2f} s, CBF "
                  f"{stats.get('cbf_s', 0.0):.2f} s, test {stats['test_s']:.2f} s | CNN {cnn} "
                  f"NME {nme} | exemplars {stats['exemplars']} | #1 {got.get(FWD)} #2 "
                  f"{got.get(BWD)} launches (= expected) | eval {clips_s:.2f} clips/s [{smi}]",
                  flush=True)
        if testing != want_testing:
            raise AssertionError(f"cil_testing: kernel launches {testing}, expected "
                                 f"{want_testing}")
        table = (root / "work_dir" / "cnn_result.txt").read_text()
        print(f"cil_testing (TenCrop at 256, K={CIL_EVAL_K}): {out['cil_testing_s']:.2f} s, #1 "
              f"{testing[FWD]} launches (= expected); CNN table:\n{table}", flush=True)
        out.update(tasks=tasks, cnn_matrix=trainer.cnn_matrix, nme_matrix=trainer.nme_matrix,
                   testing_launches=testing, cnn_table=table,
                   launches={FWD: sum(t["launches"][FWD] for t in tasks) + testing[FWD],
                             BWD: sum(t["launches"][BWD] for t in tasks)})

        # the fast loaders' batch time on this host: the last task's train
        # batches and the TenCrop test batches
        dm = trainer.data_module
        train_loader, _ = trainer._try_fast_loader()
        test_loader = dm.get_test_dataloader([0, len(CIL_SPLITS) - 1])
        check_fast_loaders("cil input", dict(loaders=dm.loader_notes))
        for name, loader in (("train", train_loader), ("TenCrop test", test_loader)):
            t0 = time.perf_counter()
            n = sum(1 for _ in loader)
            out[f"loader_{name}_batch_s"] = (time.perf_counter() - t0) / n
            print(f"cil input: {name} batch of {CIL_BATCH} videos from {type(loader).__name__} "
                  f"{out[f'loader_{name}_batch_s']:.3f} s ({n} batches, {os.cpu_count()} CPUs)",
                  flush=True)

        # the card's eval step against the CPU's on one TenCrop batch (f32 on the CPU)
        batch = next(iter(test_loader))
        imgs = (torch.from_numpy(batch["imgs"]) if "imgs" in batch else
                {k: torch.from_numpy(v) for k, v in batch.items() if k != "label"})
        nc = trainer.num_classes(len(CIL_SPLITS) - 1)
        state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
        cfg = dict(trainer.config.model)
        cpu_spec = build_model(cfg, dtype=torch.float32, device="cpu")
        cpu_model = cpu_spec.module(nc)
        cpu_model.load_state_dict(state)
        t0 = time.perf_counter()
        ref = make_eval_step(cpu_spec, nc)(cpu_model, imgs)
        out["cpu_eval_s"] = time.perf_counter() - t0
        _build.LAUNCHES.clear()
        got = make_eval_step(trainer.spec, nc)(trainer.model, imgs.to(dev) if isinstance(
            imgs, torch.Tensor) else {k: v.to(dev) for k, v in imgs.items()})
        torch.cuda.synchronize()
        if _build.LAUNCHES[FWD] != CIL_BLOCKS:
            raise AssertionError(f"the card's eval step launched #1 {_build.LAUNCHES[FWD]} times")
        if tuple(got["cls_score"].shape) != (CIL_BATCH, 10, nc):
            raise AssertionError(f"eval cls_score {tuple(got['cls_score'].shape)}")
        g, r = got["cls_score"].float().cpu(), ref["cls_score"].float()
        err = float((g - r).abs().max())
        tol = 3e-2 * float(r.abs().max())  # phase 3's bf16 tolerance
        # the prediction, as the trainer makes it (average_clips='prob'): the
        # argmax of the crops' mean softmax. A logit error of at most err moves
        # every probability, and so their mean over crops, by a factor within
        # exp(+-2 err): where the CPU's top-1/top-2 log-ratio exceeds 4 err the
        # card's prediction must be the CPU's.
        pg, pr = torch.softmax(g, -1).mean(1), torch.softmax(r, -1).mean(1)
        top2 = pr.topk(2, dim=-1).values
        margin = (top2[:, 0] / top2[:, 1]).log()
        held = margin > 4 * err
        flips = int((held & (pg.argmax(-1) != pr.argmax(-1))).sum())
        out.update(eval_check=dict(max_abs_err=err, tol=tol, argmax_equal=int(
            (pg.argmax(-1) == pr.argmax(-1)).sum()), held=int(held.sum()), bound=4 * err,
            min_margin=float(margin.min()), margins=margin.tolist()))
        if not bool(torch.isfinite(g).all()) or err > tol or flips:
            raise AssertionError(f"eval step: card vs CPU max abs err {err} (tol {tol}), "
                                 f"{flips} predictions differ beyond the bound")
        print(f"cil eval step: card (bf16) vs CPU (f32) on one TenCrop batch of "
              f"{type(test_loader).__name__} (N*T = {EVAL_NT}): cls_score max abs err {err:.4g} "
              f"(tol {tol:.4g}); prediction held equal on the {int(held.sum())} of {CIL_BATCH} "
              f"videos whose CPU top-1/top-2 log-ratio exceeds 4 x err = {4 * err:.3g} "
              f"(log-ratios {min(margin.tolist()):.3g} to {max(margin.tolist()):.3g}), equal on "
              f"{out['eval_check']['argmax_equal']} of {CIL_BATCH} in all; CPU "
              f"{out['cpu_eval_s']:.1f} s [{smi}]", flush=True)
    finally:
        trainer_mod.CILTrainer._finish_task = finish
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def write_detections(root: pathlib.Path, seed: int) -> pathlib.Path:
    """``detections.npy`` for the corpus, keyed by video and 1-based frame:
    most frames hold one or two person boxes with scores on both sides of
    the 0.4 threshold (0.4 itself among them), some none, and the first
    video none at all."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    w, h = UCF_STORED
    dets = {}
    for v, vdir in enumerate(sorted((root / "rawframes").iterdir())):
        frames = {}
        for fi in range(1, CIL_FRAMES + 1):
            n = 0 if v == 0 else int(rng.choice([0, 1, 1, 2, 2]))
            x0, y0 = rng.uniform(0, 0.6 * w, n), rng.uniform(0, 0.6 * h, n)
            x1, y1 = x0 + rng.uniform(20, 0.4 * w, n), y0 + rng.uniform(20, 0.4 * h, n)
            score = rng.choice([0.2, 0.4, 0.6, 0.9, 0.95], n)
            frames[fi] = np.stack([x0, y0, x1, y1, score], 1).astype(np.float32).reshape(-1, 5)
        dets[vdir.name] = frames
    path = root / "detections.npy"
    np.save(path, dets, allow_pickle=True)
    return path


def acm_config_file(root: pathlib.Path) -> pathlib.Path:
    """The ``actorcutmix_plus_randaug`` preset of the hmdb51 template (TSM-R50,
    8 segments, the icarl method with ACMSmoothCE, ActorCutMixDataset train
    and exemplar sets, acm_prob and use_cbf as the preset sets them, TenCrop
    test at 256) cut to the corpus, in configuration B with bf16 compute."""
    path = root / "acm_config.py"
    path.write_text(f"""from bdvcil_torch.config_templates import make_cil_config
from bdvcil_torch.protocol import adaptive_scale_factors

_splits = {CIL_SPLITS!r}
_cfg = make_cil_config("hmdb51", 1000, 3, "actorcutmix_plus_randaug", data_dir={str(root)!r},
                       work_dir={str(root / "work_dir")!r})
_cfg.update(task_splits=_splits, ending_task=len(_splits) - 1,
            adaptive_scale_factors=adaptive_scale_factors(_splits),
            videos_per_gpu={CIL_BATCH}, testing_videos_per_gpu={CIL_BATCH}, workers_per_gpu=6,
            testing_workers_per_gpu=6, num_epochs_per_task=1, budget_size={CIL_BUDGET},
            eval_steps_per_dispatch={CIL_EVAL_K}, compute_dtype="bfloat16",
            use_fast_input_pipeline=True, log_every_n_steps=1)
_cfg["model"]["backbone"]["shift_mode"] = "fused_block"
_cfg["model"]["cls_head"]["num_classes"] = len(_splits[0])
_cfg["model"]["cls_head"]["inc_head_config"]["out_features"] = len(_splits[0])
globals().update(_cfg)
""")
    return path


def _launched(before):
    """The #1 / #2 launches since ``before`` (a copy of the counts)."""
    from bdvcil_torch.ops import _build

    torch.cuda.synchronize()
    return kernel_launches(before)


def acm_phase(dev, seed, smi):
    """Phase 11: the ActorCutMix preset and the single-process tools, from
    JPEG files on disk through each tool's ``main``: annotation files, the
    card's background bank, a 3-task ActorCutMix run, test_cil,
    test_single_ckpt, predict and extract_features."""
    import shutil

    import cv2
    import numpy as np

    from bdvcil_torch.cil import trainer as trainer_mod
    from bdvcil_torch.cil_tools import (create_annotation_files, extract_background,
                                        extract_features, load_model, predict, test_cil,
                                        test_single_ckpt, train_cil)
    from bdvcil_torch.config import Config
    from bdvcil_torch.data.datasets import build_dataset
    from bdvcil_torch.data.host_loader import DataLoader
    from bdvcil_torch.models import build_model
    from bdvcil_torch.models.recognizer import average_clips
    from bdvcil_torch.ops import _build
    from bdvcil_torch.runtime import make_eval_step
    from bdvcil_torch.runtime.loops import run_inference

    root = pathlib.Path("chiprun_out/acm_corpus").resolve()
    shutil.rmtree(root, ignore_errors=True)
    out, tools, marks = {}, {}, []
    finish = trainer_mod.CILTrainer._finish_task

    def finish_and_mark(self):
        finish(self)
        torch.cuda.synchronize()
        marks.append(kernel_launches())

    def timed(name, fn):
        before = kernel_launches()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        tools[name] = dict(s=time.perf_counter() - t0, launches=_launched(before))
        return result

    phase0 = time.perf_counter()
    try:
        t0 = time.perf_counter()
        write_cil_corpus(root, seed)
        write_detections(root, seed)
        out["corpus_s"] = time.perf_counter() - t0
        config = acm_config_file(root)
        videos = {f"c{c}_v{v}": c for c in range(8) for v in range(CIL_TRAIN + CIL_VAL)}

        # annotation files: every video once a split, with its frames and label
        ann = root / "ann"
        timed("create_annotation_files", lambda: create_annotation_files.main([
            "--train_ann_file", str(root / "hmdb51_train_split_1_rawframes.txt"),
            "--val_ann_file", str(root / "hmdb51_val_split_1_rawframes.txt"),
            "--destination", str(ann), "--task_splits_config", str(config)]))
        listed = {}
        for split in ("train", "val"):
            for t in range(len(CIL_SPLITS)):
                for line in (ann / f"{split}_task_{t}.txt").read_text().split("\n"):
                    if line:
                        name, frames, label = line.split()
                        listed[name] = (int(frames), int(label))
        mapping = json.loads((ann / "class_indices_mapping.json").read_text())
        want = {n: (CIL_FRAMES, mapping[str(c)]) for n, c in videos.items()}
        if listed != want:
            raise AssertionError(f"create_annotation_files listed {len(listed)} videos, "
                                 f"expected {len(want)}: {sorted(set(want) ^ set(listed))}")
        shutil.copy(ann / "class_indices_mapping.json", root / "class_indices_mapping.json")

        # the background bank on the card, held to the rounded numpy median
        done = timed("extract_background", lambda: extract_background.main([
            "--video_dir", str(root / "rawframes"), "--output_dir", str(root / "bg_device"),
            "--device"]))
        if len(done) != len(videos) or len(list((root / "bg_device").glob("*.jpg"))) != len(
                videos):
            raise AssertionError(f"extract_background wrote {len(done)} of {len(videos)}")
        bg = dict(videos=len(done), frames=[CIL_FRAMES, CIL_FRAMES - 1], lower_middle_differs=0)
        for vdir in sorted((root / "rawframes").iterdir()):
            for max_frames in (CIL_FRAMES, CIL_FRAMES - 2):  # 16 frames, and 15
                got = extract_background.bg_extraction_tmf(vdir, root / "bg_check.jpg", False, 1,
                                                           max_frames, 0, device=dev)
                stack = np.stack([cv2.imread(str(f)) for f in sorted(vdir.glob("*.jpg"))][
                    :max_frames + 1])
                ref = np.round(np.median(stack, axis=0)).astype(np.uint8)
                if got.dtype != np.uint8 or not np.array_equal(got, ref):
                    raise AssertionError(f"{vdir.name}, {len(stack)} frames: the card's median "
                                         f"differs from numpy's on {(got != ref).sum()} pixels")
                if len(stack) % 2 == 0:
                    lower = np.sort(stack, axis=0)[len(stack) // 2 - 1]
                    bg["lower_middle_differs"] += int((lower != ref).any())
        if bg["lower_middle_differs"] != len(videos):
            raise AssertionError(f"a lower-middle median equals the card's on "
                                 f"{len(videos) - bg['lower_middle_differs']} videos")
        out["backgrounds"] = bg
        print(f"acm tools: create_annotation_files listed {len(listed)} videos x {CIL_FRAMES} "
              f"frames; extract_background --device: {len(done)} backgrounds in "
              f"{tools['extract_background']['s']:.2f} s, equal to np.round(np.median) bit for "
              f"bit at 16 and 15 frames (the lower-middle median differs on all "
              f"{bg['lower_middle_differs']} videos at 16) [{smi}]", flush=True)

        # the ActorCutMix run
        want_tasks, want_testing = expected_cil_launches(use_cbf=False)
        trainer_mod.CILTrainer._finish_task = finish_and_mark
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        trainer = train_cil.main([str(config)])
        out["train_s"] = time.perf_counter() - t0
        trainer_mod.CILTrainer._finish_task = finish
        if type(trainer.train_dataset).__name__ != "ActorCutMixDataset" or \
                trainer.method != "icarl":
            raise AssertionError(f"the preset trained {type(trainer.train_dataset).__name__} "
                                 f"with {trainer.method}")
        tasks, prev = [], collections.Counter()
        for t, (stats, mark) in enumerate(zip(trainer.task_stats, marks)):
            got = {k: v - prev.get(k, 0) for k, v in mark.items() if v - prev.get(k, 0)}
            prev = collections.Counter(mark)
            if got != want_tasks[t]:
                raise AssertionError(f"cil acm task {t}: kernel launches {got}, expected "
                                     f"{want_tasks[t]}")
            cnn, nme = trainer.cnn_matrix[t], trainer.nme_matrix[t]
            for row in (cnn, nme):
                if len(row) != t + 1 or not all(math.isfinite(a) and 0 <= a <= 100 for a in row):
                    raise AssertionError(f"cil acm task {t}: accuracy row {row}")
            check_fast_loaders(f"cil acm task {t}", stats)
            by_choice = collections.defaultdict(list)
            for note in sorted(set(stats["loaders"])):
                what, choice = note.split(": ", 1)
                by_choice[choice].append(what)
            loaders = "; ".join(f"{', '.join(w)}: {c}" for c, w in by_choice.items())
            tasks.append(dict(stats, launches=got, cnn=cnn, nme=nme, loaders=loaders))
            print(f"cil acm task {t}: loaders {loaders} | train {stats['train_s']:.2f} s, "
                  f"features + herding {stats['exemplar_s']:.2f} s, test "
                  f"{stats['test_s']:.2f} s | CNN {cnn} NME {nme} | exemplars "
                  f"{stats['exemplars']} | #1 {got.get(FWD)} #2 {got.get(BWD)} launches "
                  f"(= expected) [{smi}]", flush=True)
        before = kernel_launches()
        t0 = time.perf_counter()
        trainer.cil_testing(test_nme=True)
        out["cil_testing_s"] = time.perf_counter() - t0
        testing = _launched(before)
        if testing != want_testing:
            raise AssertionError(f"acm cil_testing: kernel launches {testing}, expected "
                                 f"{want_testing}")
        wd = root / "work_dir"
        tables = {n: (wd / n).read_text() for n in ("cnn_result.txt", "nme_result.txt")}

        # the fast ACM loader's batch time: the last task's train batches
        loader, _ = trainer._try_fast_loader()
        check_fast_loaders("acm input", dict(loaders=trainer.data_module.loader_notes))
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        out["loader_train_batch_s"] = (time.perf_counter() - t0) / n
        print(f"acm input: train batch of {CIL_BATCH} videos from {type(loader).__name__} "
              f"{out['loader_train_batch_s']:.3f} s ({n} batches, {os.cpu_count()} CPUs)",
              flush=True)

        # test_cil: the same tables as the trainer's own cil_testing
        timed("test_cil", lambda: test_cil.main([str(config)]))
        again = {n: (wd / n).read_text() for n in tables}
        if again != tables or tools["test_cil"]["launches"] != want_testing:
            raise AssertionError(f"test_cil: tables equal {again == tables}, launches "
                                 f"{tools['test_cil']['launches']} (expected {want_testing})")
        last = wd / "ckpt" / f"ckpt_task_{len(CIL_SPLITS) - 1}.pt"
        cnn, nme = timed("test_single_ckpt", lambda: test_single_ckpt.main([
            str(config), "--ckpt", str(last), "--starting_task", str(len(CIL_SPLITS) - 1)]))
        for row in (cnn.values, nme.values):
            if len(row) != len(CIL_SPLITS) or not all(math.isfinite(a) and 0 <= a <= 100
                                                      for a in row):
                raise AssertionError(f"test_single_ckpt: accuracy row {row}")
        print(f"acm testing: cil_testing {out['cil_testing_s']:.2f} s, test_cil "
              f"{tools['test_cil']['s']:.2f} s, tables equal, #1 {testing[FWD]} launches each "
              f"(= expected); test_single_ckpt {tools['test_single_ckpt']['s']:.2f} s CNN "
              f"{cnn.values} NME {nme.values}; CNN table:\n{tables['cnn_result.txt']}",
              flush=True)

        # predict and extract_features on 4 videos: float32, as the tools build
        # the model, against the same eval step in float32 and, at phase 3's
        # bf16 tolerance, against the trainer's bf16 one
        cfg = Config.fromfile(str(config))
        spec, module, nc, _ = load_model(cfg, last, dev)
        spec16 = build_model(dict(cfg.model), dtype=torch.bfloat16, device=dev)
        module16 = spec16.module(nc)
        module16.load_state_dict(module.state_dict())
        chosen = [f"c{c}_v{CIL_TRAIN}" for c in (0, 3, 5, 7)]
        vids = root / "predict_videos"
        vids.mkdir()
        for name in chosen:
            (vids / name).symlink_to(root / "rawframes" / name)

        def eval_scores(pipeline, spec, module, extract_repr=False):
            ann_file = root / "four.txt"
            ann_file.write_text("".join(f"{n} {CIL_FRAMES} 0\n" for n in chosen))
            ds = build_dataset(dict(type="RawframeDataset", ann_file=str(ann_file),
                                    data_prefix=str(root / "rawframes"), pipeline=pipeline,
                                    test_mode=True))
            return run_inference(make_eval_step(spec, nc), module,
                                 DataLoader(ds, SERVE_VIDEOS), device=dev,
                                 extract_repr=extract_repr, pad_batch_to=SERVE_VIDEOS)

        mode = cfg.model.get("test_cfg", {}).get("average_clips", "prob") or "score"
        ref32, ref16 = (average_clips(torch.from_numpy(eval_scores(
            cfg.data.test.pipeline, s, m)["cls_score"]), mode).numpy()
            for s, m in ((spec, module), (spec16, module16)))
        preds = timed("predict", lambda: predict.main([
            str(config), str(last), str(vids), "--output", str(root / "preds.json"),
            "--batch_size", str(SERVE_VIDEOS)]))["predictions"]
        top1 = [p["topk"][0]["class_index"] for p in preds]
        labels = [p["topk"][0].get("original_label") for p in preds]
        if [p["video"] for p in preds] != chosen or top1 != ref32.argmax(-1).tolist() or \
                None in labels or any(len(p["topk"]) != min(5, nc) for p in preds):
            raise AssertionError(f"predict: {[p['video'] for p in preds]} top-1 {top1} "
                                 f"(labels {labels}), the eval step's argmax "
                                 f"{ref32.argmax(-1).tolist()}")
        # every top-k score against the same video's eval-step score: each
        # video's scores differ from every other video's by more than the
        # tolerance, so a video paired with another's scores fails
        got = np.array([[e["score"] for e in p["topk"]] for p in preds])
        cls = np.array([[e["class_index"] for e in p["topk"]] for p in preds])
        serve = dict(f32=float(np.abs(got - np.take_along_axis(ref32, cls, 1)).max()),
                     bf16=float(np.abs(got - np.take_along_axis(ref16, cls, 1)).max()),
                     tol=1e-5, bf16_tol=3e-2 * float(np.abs(ref16).max()),
                     videos_apart=min(float(np.abs(ref32[a] - ref32[b]).max())
                                      for a in range(len(chosen)) for b in range(a)))
        if not serve["f32"] <= serve["tol"] < serve["videos_apart"] or \
                serve["bf16"] > serve["bf16_tol"]:
            raise AssertionError(f"predict's top-k scores against the eval step's: {serve}")

        # extract_features keeps the correctly classified videos: label each
        # with the float32 eval step's prediction on the val pipeline, so all 4 stay
        refs = {name: eval_scores(cfg.data.val.pipeline, s, m, extract_repr=True)
                for name, s, m in (("f32", spec, module), ("bf16", spec16, module16))}
        refs = {name: (r["cls_score"].mean(axis=1), r["repr"].mean(axis=1))
                for name, r in refs.items()}
        feat = root / "features"
        feat.mkdir()
        (feat / "four.txt").write_text("".join(f"{n} {CIL_FRAMES} {int(c)}\n" for n, c in
                                               zip(chosen, refs["f32"][0].argmax(-1))))
        fcfg = Config.fromfile(str(config))
        fcfg.data.train = dict(type="RawframeDataset", ann_file=str(feat / "four.txt"),
                               data_prefix=str(root / "rawframes"), pipeline=[])
        fcfg.dump(str(feat / "config.py"))
        shutil.copy(last, feat / "latest.pt")
        dst = timed("extract_features", lambda: extract_features.main([
            str(feat), "--batch_size", str(SERVE_VIDEOS)]))
        kept = {e["frame_dir"].rsplit("/", 1)[-1]: e for es in json.loads(
            dst.read_text())["features_by_class"].values() for e in es}
        if sorted(kept) != sorted(chosen):
            raise AssertionError(f"extract_features kept {sorted(kept)}")
        feat_err = {}
        for i, key in enumerate(("cls_score", "repr_consensus")):
            g = np.array([kept[n][key] for n in chosen])
            r32, r16 = refs["f32"][i], refs["bf16"][i]
            feat_err[key] = dict(f32=float(np.abs(g - r32).max()),
                                 bf16=float(np.abs(g - r16).max()),
                                 bf16_tol=3e-2 * float(np.abs(r16).max()))  # phase 3's
            if feat_err[key]["f32"] > 1e-5 * float(np.abs(r32).max()) or \
                    feat_err[key]["bf16"] > feat_err[key]["bf16_tol"]:
                raise AssertionError(f"extract_features {key}: {feat_err[key]}")
        out.update(tasks=tasks, cnn_matrix=trainer.cnn_matrix, nme_matrix=trainer.nme_matrix,
                   testing_launches=testing, tables=tables, tools=tools,
                   single_ckpt=dict(cnn=cnn.values, nme=nme.values), predict_top1=top1,
                   predict_labels=labels, predict_max_abs_err=serve,
                   features_max_abs_err=feat_err)
        out["launches"] = {k: sum(t["launches"].get(k, 0) for t in tasks) + testing.get(k, 0)
                           + sum(v["launches"].get(k, 0) for v in tools.values())
                           for k in (FWD, BWD)}
        out["phase_s"] = time.perf_counter() - phase0
        print(f"acm serving: predict {tools['predict']['s']:.2f} s on {len(chosen)} videos, "
              f"top-1 {top1} ({labels}) = the f32 eval step's argmax, top-k scores max abs "
              f"err {serve['f32']:.3g} (tol {serve['tol']:g}, videos apart by >= "
              f"{serve['videos_apart']:.3g}), against bf16 {serve['bf16']:.3g} (tol "
              f"{serve['bf16_tol']:.3g}); extract_features "
              f"{tools['extract_features']['s']:.2f} s, all {len(kept)} kept, max abs err "
              + ", ".join(f"{k} f32 {v['f32']:.3g} bf16 {v['bf16']:.3g} (tol {v['bf16_tol']:.3g})"
                          for k, v in feat_err.items()) + "; "
              f"phase launches #1 {out['launches'][FWD]} #2 {out['launches'][BWD]}, phase "
              f"{out['phase_s']:.1f} s (corpus {out['corpus_s']:.1f} s) [{smi}]",
              flush=True)
    finally:
        trainer_mod.CILTrainer._finish_task = finish
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# --- phase 12: the port across ranks ------------------------------------------------

DIST_WORLD = 2  # two processes on the one card, over gloo
DIST_DEVICE = "cuda:0"
DIST_BACKEND_A = "nccl"  # (a)'s one-rank group
DIST_PAD = 4  # the task-1 batch's pad rows: its last 4, all on the last rank
DIST_TIMEOUT_S = 900
DIST_EVAL_VIDEOS, DIST_EVAL_BATCH = 10, 8  # a padded global eval batch: 4 rows a rank
DIST_CIL_SPLITS = CIL_SPLITS[:2]  # phase 10's cut, 2 tasks
# (b)'s runs on 8 rows a rank against 16 rows in one process: (loss rtol, the
# backbone's task-0 update as one vector, in norm; the task-0 step of the
# BatchNorm running statistics as one vector, in norm). In bf16 the untrained
# BatchNorm net amplifies rounding into updates that differ O(1) (the CPU
# float64 witness, tests/test_torch_port_distributed.py, shows the math
# exact), so the update is bounded in float32 without TF32. The running
# statistics read the all-reduced sums (config A: #3's) directly, in f32:
# measured 3.7e-3 (bf16) and 1.1e-6 (f32) off, and 7.9e-2 for config A when
# #3's sums are not all-reduced.
DIST_TOLS = {"A": (1e-2, None, 1e-2), "B": (1e-2, None, 1e-2), "B_f32": (1e-4, 0.1, 1e-5)}
DIST_EVAL_TOL = 3e-2  # of the largest entry, phase 3's bf16 tolerance
MODE_SWITCHES = {"s2d": dict(stem_mode="s2d"), "fused": dict(shift_mode="fused"),
                 "bn_groups=2": dict(bn_groups=2), "bn_stats_rows=4": dict(bn_stats_rows=4)}
MODE_F32_TOL = 1e-3  # card f32 (no TF32) vs CPU f32, of the largest entry
MODE_BF16_FACTOR = 2.0  # card bf16 vs CPU f32, against the plain backbone's own error
# (with eager BatchNorm, as every mode's yardstick: modes_forward)


def dist_inputs(seed):
    """The global batch of phase 12's steps, made on the host from ``seed``:
    clips, task-0 and task-1 labels, and the task-1 sample weights (0 on the
    last ``DIST_PAD`` rows). The second half of the clips (the last rank's
    rows) is brighter and of more contrast, as clips of other videos are, so
    a rank's own statistics differ from the global batch's."""
    from bdvcil_torch import config_templates as presets

    g = torch.Generator().manual_seed(seed + 12)
    nc0 = presets.HMDB51_BASE_CLASSES
    imgs = torch.randn((BATCH, SEGMENTS, SIZE, SIZE, 3), generator=g)
    imgs[BATCH // 2:] = imgs[BATCH // 2:] * 1.5 + 0.5
    labels0 = torch.randint(0, nc0, (BATCH,), generator=g)
    labels1 = torch.randint(0, nc0 + presets.HMDB51_CLASSES_PER_TASK, (BATCH,), generator=g)
    weights1 = torch.ones(BATCH)
    weights1[-DIST_PAD:] = 0
    return imgs, labels0, labels1, weights1


def dist_steps(name, dev, seed, dtype=torch.bfloat16, switches=None):
    """A task-0 step and a task-1 KD step (padded tail) of config ``name`` (or
    the backbone ``switches``) at TSM-R50 16 x 8 x 224² in ``dtype``, on this
    rank's rows of the global batch (all of them in one process); dropout
    from ``step_generator(seed, step)``. float32 runs without TF32."""
    from bdvcil_torch import config_templates as presets
    from bdvcil_torch.models import build_model, init_model_params, update_fc
    from bdvcil_torch.ops import _build
    from bdvcil_torch.optim import build_optimizer
    from bdvcil_torch.parallel import mesh
    from bdvcil_torch.runtime import TrainState, make_train_step
    from bdvcil_torch.runtime.loops import step_generator

    lo, hi = mesh.local_rows(BATCH)
    imgs, labels0, labels1, weights1 = (t[lo:hi].to(dev) for t in dist_inputs(seed))
    nc0 = presets.HMDB51_BASE_CLASSES
    nc1 = nc0 + presets.HMDB51_CLASSES_PER_TASK
    switches = presets.SWITCHES[name] if switches is None else switches
    spec = build_model(presets.hmdb51_r50_cfg(nc0, SEGMENTS, **switches), dtype=dtype,
                       device=dev)
    model = init_model_params(spec, seed)
    tx = build_optimizer(model, presets.OPTIMIZER, presets.LR_SCHEDULER, steps_per_epoch=100)
    state = TrainState.create(model, tx)
    records = []

    def run(step, prev, labels, extra, s):
        nonlocal state
        _build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_tf32() if dtype == torch.float32 else contextlib.nullcontext():
            state, m = step(state, prev, imgs, labels, extra, step_generator(seed, s, dev))
        torch.cuda.synchronize()
        records.append(dict(ms=(time.perf_counter() - t0) * 1e3, loss=float(m["loss"]),
                            kd_loss=float(m["kd_loss"]), launches=kernel_launches()))

    run(make_train_step(spec, tx, nc0), None, labels0, {}, 0)
    after0 = {k: v.detach().float().cpu().clone() for k, v in state.module.state_dict().items()
              if k.startswith("backbone.")}
    prev = copy.deepcopy(state.module)
    update_fc(state.module, nc1, torch.Generator().manual_seed(seed + 2))
    update_fc(prev, nc1, torch.Generator().manual_seed(seed + 3))
    tx1 = build_optimizer(state.module, presets.OPTIMIZER, presets.LR_SCHEDULER,
                          steps_per_epoch=100, grad_clip=presets.GRAD_CLIP)
    state = TrainState.create(state.module, tx1)
    step1 = make_train_step(spec, tx1, nc1, task_idx=1, prev_num_classes=nc0,
                            kd_config=presets.kd_config(nc1, nc1 - nc0))
    run(step1, prev, labels1, {"sample_weight": weights1}, 1)
    after = {k: v.detach().float().cpu().clone() for k, v in state.module.state_dict().items()}
    del state, prev, model
    torch.cuda.empty_cache()
    return dict(records=records, state=after, state0=after0)


class EvalClips:
    """``DIST_EVAL_VIDEOS`` normalized clips at 8 x 224², made from (seed, index)."""

    def __init__(self, seed):
        self.seed = seed

    def __len__(self):
        return DIST_EVAL_VIDEOS

    def __getitem__(self, i):
        g = torch.Generator().manual_seed(self.seed * 1000 + i)
        return {"imgs": torch.randn((SEGMENTS, SIZE, SIZE, 3), generator=g).numpy(),
                "label": i % 5}


def dist_inference(dev, seed):
    """``run_inference`` of config B (bf16) over ``EvalClips`` at a global batch
    of ``DIST_EVAL_BATCH``: the rows gathered in rank order across ranks."""
    from bdvcil_torch import config_templates as presets
    from bdvcil_torch.data.host_loader import DataLoader
    from bdvcil_torch.models import build_model, init_model_params
    from bdvcil_torch.runtime import make_eval_step
    from bdvcil_torch.runtime.loops import run_inference

    spec = build_model(presets.hmdb51_r50_cfg(5, SEGMENTS, **presets.SWITCHES["B"]),
                       dtype=torch.bfloat16, device=dev)
    model = init_model_params(spec, seed)
    loader = DataLoader(EvalClips(seed), batch_size=DIST_EVAL_BATCH, num_workers=4)
    out = run_inference(make_eval_step(spec, 5), model, loader, device=dev, extract_repr=True,
                        pad_batch_to=DIST_EVAL_BATCH)
    del model
    torch.cuda.empty_cache()
    return {k: torch.from_numpy(v) for k, v in out.items()}


def dist_cil_config(root: pathlib.Path) -> pathlib.Path:
    """Phase 10's config file, cut to 2 tasks, at ``CIL_BATCH`` / ``DIST_WORLD``
    videos a rank (phase 10's global batch)."""
    path = cil_config_file(root)
    per_rank = CIL_BATCH // DIST_WORLD
    path.write_text(path.read_text().replace("globals().update(_cfg)", f"""_cfg.update(
    task_splits={DIST_CIL_SPLITS!r}, ending_task={len(DIST_CIL_SPLITS) - 1},
    adaptive_scale_factors=adaptive_scale_factors({DIST_CIL_SPLITS!r}),
    videos_per_gpu={per_rank}, testing_videos_per_gpu={per_rank})
globals().update(_cfg)"""))
    return path


def dist_cil(root: pathlib.Path):
    """On every rank: ``train_cil``'s main for 2 tasks, the trainer's
    ``cil_testing``, then ``test_cil``'s main on rank 0's checkpoints; the
    result tables of both, read by every rank after a barrier."""
    from bdvcil_torch.cil_tools import test_cil, train_cil
    from bdvcil_torch.ops import _build
    from bdvcil_torch.parallel import distributed

    config = root / "cil_config.py"
    wd = root / "work_dir"
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    trainer = train_cil.main([str(config)])
    train_s = time.perf_counter() - t0
    launches = kernel_launches()
    trainer.cil_testing(test_nme=True)
    distributed.sync_processes("tables")
    tables = {n: (wd / n).read_text() for n in ("cnn_result.txt", "nme_result.txt")}
    distributed.sync_processes("tables_read")
    test_cil.main([str(config)])
    distributed.sync_processes("test_cil_tables")
    again = {n: (wd / n).read_text() for n in tables}
    return dict(cnn=trainer.cnn_matrix, nme=trainer.nme_matrix, train_s=train_s,
                launches=launches, tables=tables, test_cil_tables=again,
                ckpts=sorted(p.name for p in (wd / "ckpt").glob("ckpt_task_*.pt")))


def rank_main(args) -> int:
    """One rank of phase 12 (b): joins the gloo group on cuda:0 and runs
    configs A and B, ``run_inference`` and the 2-task CIL run; writes its
    results to ``<dist-dir>/rank<r>.pt``."""
    from bdvcil_torch.parallel import distributed

    root = pathlib.Path(args.dist_dir)
    dev = distributed.initialize(backend="gloo", device=DIST_DEVICE,
                                 init_method=f"tcp://127.0.0.1:{args.port}",
                                 world_size=args.world, rank=args.rank, timeout_s=DIST_TIMEOUT_S)
    try:
        out = {}
        for name in KERNEL_CONFIGS:
            dist_steps(name, dev, args.seed)  # a warm-up, so the timed run is the second
            out[name] = dist_steps(name, dev, args.seed)
        out["B_f32"] = dist_steps("B", dev, args.seed, torch.float32)
        out["infer"] = dist_inference(dev, args.seed)
        out["cil"] = dist_cil(root)
        out["rank"] = distributed.process_index()
        torch.save(out, root / f"rank{args.rank}.pt")
    finally:
        distributed.shutdown()
    return 0


def rank_command(rank: int, port: int, root: pathlib.Path, seed: int):
    """The command line of one rank process: this script, given its rank."""
    return [sys.executable, os.path.abspath(__file__), "--seed", str(seed), "--rank", str(rank),
            "--world", str(DIST_WORLD), "--port", str(port), "--dist-dir", str(root)]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _backbone_update_gap(got, want, start, running=False):
    """|(got - start) - (want - start)| / |want - start| over the backbone's
    parameters as one vector (its BatchNorm running statistics with
    ``running``)."""
    names = [k for k in start if k.startswith("backbone.") and ("running" in k) == running
             and start[k].is_floating_point()]
    d_got = torch.cat([(got[k] - start[k]).double().reshape(-1) for k in names])
    d_want = torch.cat([(want[k] - start[k]).double().reshape(-1) for k in names])
    return float((d_got - d_want).norm() / d_want.norm())


def _initial_backbone(name, seed):
    from bdvcil_torch import config_templates as presets
    from bdvcil_torch.models import build_model, init_model_params

    spec = build_model(presets.hmdb51_r50_cfg(5, SEGMENTS, **presets.SWITCHES[name]),
                       device="cpu")
    return {k: v for k, v in init_model_params(spec, seed).state_dict().items()
            if k.startswith("backbone.")}


@contextlib.contextmanager
def no_tf32():
    """True float32 convolutions and matmuls on the card (no TF32)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def eager_batchnorm():
    """Train-mode BatchNorm's plain versions under autograd on every device
    (the eager formula; ops/batchnorm), in place of its kernels."""
    from bdvcil_torch.ops import batchnorm

    eager = batchnorm._eager
    batchnorm._eager = lambda x, spec: True
    try:
        yield
    finally:
        batchnorm._eager = eager


@contextlib.contextmanager
def recorded_batchnorm_sums(record=None):
    """BatchNorm's kernels with the statistics of torch's f32 reductions (the
    plain versions' sums; the kernels take them from there, so only the
    order of the sums differs from the kernels' own); with ``record`` the
    kernels' own sums instead, and for each call the largest error of the
    batch variance from the kernels' sums and from torch's, against
    float64's, of float64's variance plus eps, appended to ``record``."""
    from bdvcil_torch.ops import batchnorm

    stats = batchnorm._Kernels.stats

    def swapped(self, x, cdim):
        if record is None:
            return batchnorm.stats_plain(x, cdim)
        own = stats(self, x, cdim)
        dims, n = batchnorm._dims(x, cdim), x.numel() / x.shape[cdim]
        xd = x.double()
        mean = xd.sum(dims) / n
        var = (xd * xd).sum(dims) / n - mean * mean
        errs = []
        for s1, s2 in (own, batchnorm.stats_plain(x, cdim)):
            m = s1.double() / n
            errs.append(float(((s2.double() / n - m * m - var).abs() / (var + 1e-5)).max()))
        record.append(errs)
        return own

    batchnorm._Kernels.stats = swapped
    try:
        yield
    finally:
        batchnorm._Kernels.stats = stats


def modes_forward(dev, seed, smi):
    """(c): one train-mode forward of TSM-R50 under each switch no config on
    the main path reaches, on the card against the CPU (f32): in f32 without
    TF32, within ``MODE_F32_TOL``; in bf16, within twice the plain backbone's
    own bf16 error on the same input (``MODE_BF16_FACTOR``) with eager
    BatchNorm (``eager_batchnorm``): the yardstick of every mode, the plain
    backbone on BatchNorm's kernels included. The plain backbone's bf16 error
    is also read on the kernels fed torch's sums (``recorded_batchnorm_sums``:
    only the sums' order changed), and each BatchNorm's batch variance from
    the kernels' sums and from torch's against float64's: where the
    kernels' error differs from the eager one, these show whether the sums
    are the cause."""
    from bdvcil_torch import config_templates as presets
    from bdvcil_torch.models import build_model, init_model_params

    x = torch.randn((2, SEGMENTS, SIZE, SIZE, 3), generator=torch.Generator().manual_seed(seed))

    def forward(switches, where, dtype):
        cfg = presets.hmdb51_r50_cfg(5, SEGMENTS, dropout_ratio=0.0, **switches)
        model = init_model_params(build_model(cfg, dtype=dtype, device=where), seed)
        with torch.no_grad(), no_tf32():
            res = model(x.to(where), train=True)
        return {k: res[k].float().cpu() for k in ("cls_score", "repr")}

    def err(got, ref):
        return {k: float((got[k] - ref[k]).abs().max()) / float(ref[k].abs().max()) for k in ref}

    ref32 = forward({}, "cpu", torch.float32)
    with eager_batchnorm():
        plain16 = err(forward({}, dev, torch.bfloat16), ref32)
    tol16 = {k: MODE_BF16_FACTOR * v for k, v in plain16.items()}
    with recorded_batchnorm_sums():
        torch_sums16 = err(forward({}, dev, torch.bfloat16), ref32)
    var_errs = []
    with recorded_batchnorm_sums(var_errs):
        forward({}, dev, torch.bfloat16)
    kernel_var, torch_var = (sorted(e[i] for e in var_errs) for i in (0, 1))
    out = {"plain eager BatchNorm": dict(bf16=plain16),
           "plain kernels on torch's sums": dict(bf16=torch_sums16),
           "bf16 batch variance error": dict(kernels=kernel_var, torch=torch_var)}
    print(f"distributed (c) the plain backbone's bf16 error (cls_score / repr) with eager "
          f"BatchNorm {plain16['cls_score']:.3g} / {plain16['repr']:.3g}, with the kernels on "
          f"torch's f32 sums {torch_sums16['cls_score']:.3g} / {torch_sums16['repr']:.3g}; the "
          f"{len(var_errs)} BatchNorms' batch variance off float64's by, of var + eps: the "
          f"kernels' sums median {kernel_var[len(var_errs) // 2]:.3g} max {kernel_var[-1]:.3g}, "
          f"torch's median {torch_var[len(var_errs) // 2]:.3g} max {torch_var[-1]:.3g} "
          f"[{smi}]", flush=True)
    for mode, switches in {"plain": {}, **MODE_SWITCHES}.items():
        ref = forward(switches, "cpu", torch.float32)
        e32 = err(forward(switches, dev, torch.float32), ref)
        e16 = err(forward(switches, dev, torch.bfloat16), ref)
        out[mode] = dict(f32=e32, bf16=e16)
        bad = [k for k in ref if not e32[k] <= MODE_F32_TOL or not e16[k] <= tol16[k]]
        if bad:
            raise AssertionError(f"distributed (c) {mode}: card vs CPU f32 {e32}, bf16 {e16} "
                                 f"(tol f32 {MODE_F32_TOL}, bf16 {tol16})")
        print(f"distributed (c) {mode}: TSM-R50 train-mode forward 2 x 8 x 224² on the card "
              f"against the CPU (f32), off by, of the largest entry: f32 cls_score "
              f"{e32['cls_score']:.3g} repr {e32['repr']:.3g} (tol {MODE_F32_TOL}); bf16 "
              f"cls_score {e16['cls_score']:.3g} repr {e16['repr']:.3g} (tol "
              f"{MODE_BF16_FACTOR} x the plain backbone's with eager BatchNorm, "
              f"{plain16['cls_score']:.3g} / {plain16['repr']:.3g}) [{smi}]", flush=True)
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def counted_all_reduce():
    """Counts ``torch.distributed.all_reduce`` calls and their bytes."""
    import torch.distributed as dist

    counts = collections.Counter()
    real = dist.all_reduce

    def counting(tensor, *args, **kwargs):
        counts["calls"] += 1
        counts["bytes"] += tensor.numel() * tensor.element_size()
        return real(tensor, *args, **kwargs)

    dist.all_reduce = counting
    try:
        yield counts
    finally:
        dist.all_reduce = real


def distributed_phase(dev, seed, smi):
    """Phase 12: (a) config A's two steps over a one-rank NCCL group against no
    group, bit for bit; (b) two processes on the card over gloo against one
    process (configs A and B, run_inference) and a 2-task CIL run scored again
    by test_cil; (c) the backbone switches off the main path, card vs CPU."""
    import shutil

    from bdvcil_torch.parallel import distributed

    t_phase = time.perf_counter()
    out = {}
    # (a) deterministic algorithms, so two runs of one program agree bit for bit
    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        first = dist_steps("A", dev, seed)  # pays the first calls' set-up
        distributed.initialize(backend=DIST_BACKEND_A, device=dev,
                               init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                               rank=0)
        try:
            distributed.sync_processes("communicator")  # NCCL sets up at its first call
            grouped = dist_steps("A", dev, seed)
            with counted_all_reduce() as collectives:
                grouped_timed = dist_steps("A", dev, seed)
        finally:
            distributed.shutdown()
        alone = dist_steps("A", dev, seed)
    finally:
        torch.use_deterministic_algorithms(deterministic[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic[1:]
    differ = [k for k in alone["state"] for run in (first, grouped, grouped_timed)
              if not torch.equal(alone["state"][k], run["state"][k])]
    losses = ([r["loss"] for r in alone["records"]], [r["loss"] for r in grouped["records"]])
    if [r["loss"] for r in first["records"]] != losses[0]:
        differ.append("the first run's losses")
    conv_launches = [r["launches"].get(CONV, 0) for r in grouped["records"]]
    step_launches = {CONV: 32, **bn_launches(1, sums=32)}
    if differ or losses[0] != losses[1] or [r["launches"] for r in grouped["records"]] != [
            step_launches] * 2:
        raise AssertionError(f"distributed (a): {len(differ)} leaves differ (e.g. {differ[:3]}), "
                             f"losses {losses}, launches a step "
                             f"{[r['launches'] for r in grouped['records']]}, expected "
                             f"{step_launches}")
    ms = ([r["ms"] for r in alone["records"]], [r["ms"] for r in grouped_timed["records"]])
    extra_ms = sum(ms[1]) - sum(ms[0])
    out["a"] = dict(losses=losses[1], ms_alone=ms[0], ms_nccl1=ms[1],
                    conv_launches=conv_launches, all_reduces=collectives["calls"],
                    all_reduce_mb=collectives["bytes"] / 1e6,
                    extra_us_per_all_reduce=1e3 * extra_ms / collectives["calls"])
    print(f"distributed (a) config A, one rank over NCCL vs no process group, 2 steps at "
          f"16 x 8 x 224² bf16: losses and all {len(alone['state'])} weights and buffers equal "
          f"bit for bit (deterministic algorithms; no group, the group twice, no group "
          f"again); task-0 step {ms[1][0]:.2f} ms vs {ms[0][0]:.2f} ms, task-1 KD step "
          f"{ms[1][1]:.2f} ms vs {ms[0][1]:.2f} ms (the group's second run vs no group's "
          f"second); {collectives['calls']} all-reduces over the 2 steps "
          f"({collectives['bytes'] / 1e6:.1f} MB), so {out['a']['extra_us_per_all_reduce']:.0f} "
          f"us of step time each; #3 launches {conv_launches} a step [{smi}]", flush=True)
    del first, alone, grouped, grouped_timed

    # (b) one process at the whole batch, then two ranks on the card over gloo
    one = {name: dist_steps(name, dev, seed) for name in KERNEL_CONFIGS}
    one["B_f32"] = dist_steps("B", dev, seed, torch.float32)
    one_infer = dist_inference(dev, seed)
    root = pathlib.Path("chiprun_out/dist_corpus").resolve()
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    try:
        write_cil_corpus(root, seed)
        dist_cil_config(root)
        port = _free_port()
        logs = [open(root / f"rank{r}.log", "w") for r in range(DIST_WORLD)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(rank_command(r, port, root, seed), stdout=logs[r],
                                  stderr=subprocess.STDOUT) for r in range(DIST_WORLD)]
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(1.0, DIST_TIMEOUT_S - (time.perf_counter() - t0))))
            except subprocess.TimeoutExpired:
                codes.append("timeout")
        ranks_s = time.perf_counter() - t0
        for f in logs:
            f.close()
        if codes != [0] * DIST_WORLD:
            tails = "\n".join(f"--- rank {r}:\n" + (root / f"rank{r}.log").read_text()[-4000:]
                              for r in range(DIST_WORLD))
            raise AssertionError(f"distributed (b): rank exit codes {codes}\n{tails}")
        ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(DIST_WORLD)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    b = dict(ranks_s=ranks_s)
    for name, (loss_rtol, update_tol, running_tol) in DIST_TOLS.items():
        r0 = ranks[0][name]
        differ = [k for r in ranks[1:] for k in r0["state"]
                  if not torch.equal(r0["state"][k], r[name]["state"][k])]
        got = [x["loss"] for x in r0["records"]]
        want = [x["loss"] for x in one[name]["records"]]
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        start = _initial_backbone(name[0], seed)
        gap = _backbone_update_gap(r0["state0"], one[name]["state0"], start)
        gap2 = _backbone_update_gap(r0["state"], one[name]["state"], start)
        running = _backbone_update_gap(r0["state0"], one[name]["state0"], start, running=True)
        per_rank = [[x["launches"] for x in r[name]["records"]] for r in ranks]
        bn = bn_launches(1, sums=32 if name == "A" else 0,
                         dtype=torch.float32 if name.endswith("f32") else torch.bfloat16)
        if name == "A":
            bad = [c for rank in per_rank for c in rank if c != {CONV: 32, **bn}]
        else:  # #1 once a block a forward (the previous model's too at task 1), #2 a backward
            bad = [c for rank in per_rank for c, f in zip(rank, (1, 2))
                   if c != {FWD: CIL_BLOCKS * f, BWD: CIL_BLOCKS, **bn}]
        if (differ or max(rel) > loss_rtol or (update_tol is not None and gap > update_tol)
                or not running <= running_tol or bad
                or not all(math.isfinite(v) for v in got)):
            raise AssertionError(f"distributed (b) {name}: {len(differ)} leaves differ between "
                                 f"the ranks (e.g. {differ[:3]}), losses {got} vs one process "
                                 f"{want} (rel {rel}, tol {loss_rtol}), backbone update gap "
                                 f"{gap} (tol {update_tol}), running statistics gap {running} "
                                 f"(tol {running_tol}), launches {per_rank}")
        b[name] = dict(losses=got, one_process_losses=want, rel=rel, update_gap=gap,
                       update_gap_two_steps=gap2, running_gap=running,
                       launches_per_rank=per_rank,
                       ms_ranks=[[x["ms"] for x in r[name]["records"]] for r in ranks],
                       ms_one=[x["ms"] for x in one[name]["records"]])
        ms_r, ms_1 = [x["ms"] for x in r0["records"]], b[name]["ms_one"]
        held = (f"tol {update_tol}" if update_tol is not None else
                "not bounded in bf16: the float32 run bounds it")
        print(f"distributed (b) config {name}, 2 gloo ranks on one card (8 rows each) vs one "
              f"process (16 rows): losses {got} vs {want} (rel {max(rel):.3g}, tol "
              f"{loss_rtol}); backbone update gap {gap:.3g} of its norm after the task-0 step "
              f"({held}), {gap2:.3g} after both; BatchNorm running statistics' task-0 step "
              f"off by {running:.3g} of its norm (tol {running_tol}); ranks hold equal weights "
              f"and buffers; launches per rank and step {per_rank[0]}; step ms rank 0 "
              f"{ms_r[0]:.1f}, {ms_r[1]:.1f} vs one process {ms_1[0]:.1f}, {ms_1[1]:.1f} "
              f"[{smi}]", flush=True)
        del r0

    errs = {}
    for r, rank in enumerate(ranks):
        got = rank["infer"]
        if not torch.equal(got["labels"], one_infer["labels"]):
            raise AssertionError(f"distributed (b) rank {r}: gathered labels {got['labels']}")
        for key in ("cls_score", "repr"):
            ref = one_infer[key]
            if got[key].shape != ref.shape or got[key].shape[0] != DIST_EVAL_VIDEOS:
                raise AssertionError(f"distributed (b): gathered {key} {tuple(got[key].shape)}")
            row_err = (got[key] - ref).abs().reshape(DIST_EVAL_VIDEOS, -1).amax(1)
            tol = DIST_EVAL_TOL * float(ref.abs().max())
            errs[key] = max(errs.get(key, 0.0), float(row_err.max()) / float(ref.abs().max()))
            if float(row_err.max()) > tol:
                raise AssertionError(f"distributed (b) rank {r}: {key} rows off by "
                                     f"{row_err.tolist()} (tol {tol})")
    b["infer"] = errs
    print(f"distributed (b) run_inference, 2 gloo ranks ({DIST_EVAL_BATCH // DIST_WORLD} rows "
          f"each, {DIST_EVAL_VIDEOS} videos, padded) vs one process: every gathered row within "
          f"cls_score {errs['cls_score']:.3g}, repr {errs['repr']:.3g} of the largest entry (tol "
          f"{DIST_EVAL_TOL}) [{smi}]", flush=True)

    cils = [rank["cil"] for rank in ranks]
    c0 = cils[0]
    if any(c["cnn"] != c0["cnn"] or c["nme"] != c0["nme"] for c in cils[1:]):
        raise AssertionError(f"distributed (b) cil: the ranks' matrices differ: "
                             f"{[(c['cnn'], c['nme']) for c in cils]}")
    if c0["tables"] != c0["test_cil_tables"] or c0["ckpts"] != [
            f"ckpt_task_{t}.pt" for t in range(len(DIST_CIL_SPLITS))]:
        raise AssertionError(f"distributed (b) cil: test_cil tables equal "
                             f"{c0['tables'] == c0['test_cil_tables']}, checkpoints {c0['ckpts']}")
    for row_set in (c0["cnn"], c0["nme"]):
        for t, row in enumerate(row_set):
            if len(row) != t + 1 or not all(math.isfinite(a) and 0 <= a <= 100 for a in row):
                raise AssertionError(f"distributed (b) cil: accuracy row {row}")
    b["cil"] = dict(cnn=c0["cnn"], nme=c0["nme"], train_s=[c["train_s"] for c in cils],
                    launches=[c["launches"] for c in cils], tables=c0["tables"])
    print(f"distributed (b) cil: train_cil on 2 gloo ranks, {len(DIST_CIL_SPLITS)} tasks at "
          f"phase 10's cut ({CIL_BATCH // DIST_WORLD} videos a rank): CNN {c0['cnn']} NME "
          f"{c0['nme']}, equal on both ranks; test_cil on rank 0's checkpoints gives the "
          f"trainer's cil_testing tables; train {c0['train_s']:.1f} s; #1/#2 launches per rank "
          f"{[{k: c['launches'].get(k) for k in (FWD, BWD)} for c in cils]}; the ranks took "
          f"{ranks_s:.1f} s [{smi}]", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    out["b"] = b
    out["c"] = modes_forward(dev, seed, smi)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"distributed phase: {out['phase_s']:.1f} s [{smi}]", flush=True)
    return out


# --- phase 13: the reference's checkpoints and the interpret mode ----------------------

# the port's head names -> the reference's (IncrementalTSMHead, LSCLoss)
REFERENCE_HEAD = {"cls_head.fc_weights": "cls_head.fc_cls.weights",
                  "cls_head.fc_weight": "cls_head.fc_cls.weight",
                  "cls_head.fc_bias": "cls_head.fc_cls.bias",
                  "cls_head.eta": "cls_head.loss_cls.eta"}
REFERENCE_PREV_ETA = 7.0  # the previous model's eta in (a)'s checkpoint: must not be taken


def reference_checkpoint(state_dict):
    """A port ``state_dict`` as the reference writes ``ckpt_task_{t}.pt``:
    ``.net`` inside each block's conv1 (TemporalShift's wrapper), the head's
    reference names, under ``current_model.``; then a ``prev_model.`` copy with
    another eta, and a ``num_batches_tracked``, which the importer drops."""
    out = collections.OrderedDict()
    for key, value in state_dict.items():
        key = REFERENCE_HEAD.get(key, re.sub(r"^(backbone\.layer\d+\.\d+\.conv1)\.weight$",
                                             r"\1.net.weight", key))
        out["current_model." + key] = value.detach().cpu().clone()
    out["current_model.backbone.bn1.num_batches_tracked"] = torch.tensor(3)
    for key, value in list(out.items()):
        out["prev_model." + key[len("current_model."):]] = value.clone()
    out["prev_model.cls_head.loss_cls.eta"] = torch.tensor([REFERENCE_PREV_ETA])
    return out


def reference_ckpt_phase(dev, seed, smi):
    """Phase 13: (a) a checkpoint in the reference's layout through
    ``load_checkpoint_file`` and ``load_reference_cil_checkpoint`` into a fresh
    config-B model, whose eval logits equal the source's bit for bit, #1 16
    launches a forward; (b) config A's train-mode forward under
    ``'pallas_stats'`` (#3, 32 launches) and ``'pallas_stats_interpret'`` (the
    plain GEMM, none), logits and losses within phase 3's bf16 tolerance."""
    from bdvcil_torch import config_templates as presets
    from bdvcil_torch.models import build_model, init_model_params, load_reference_cil_checkpoint
    from bdvcil_torch.models.pretrained import load_checkpoint_file
    from bdvcil_torch.losses import lsc_nca_loss
    from bdvcil_torch.ops import _build

    out = {}
    nc = presets.HMDB51_BASE_CLASSES
    gen = torch.Generator().manual_seed(seed + 13)
    x = torch.randn((BATCH, SEGMENTS, SIZE, SIZE, 3), generator=gen).to(dev)
    labels = torch.randint(0, nc, (BATCH,), generator=gen).to(dev)

    # (a) the importer, config B (shift_mode='fused_block'), bf16, LSC with eta
    t0 = time.perf_counter()
    cfg = presets.hmdb51_r50_cfg(nc, SEGMENTS, **presets.SWITCHES["B"])
    source = init_model_params(build_model(cfg, dtype=torch.bfloat16, device=dev), seed)
    with torch.no_grad():  # pinned running statistics and eta, so the eval forward reads them
        for name, v in source.state_dict().items():
            if name.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
            elif name.endswith("running_mean"):
                v.copy_(torch.randn(v.shape, generator=gen) * 0.2)
        source.cls_head.eta.fill_(1.75)
    path = pathlib.Path("chiprun_out") / "reference_ckpt_task_1.pt"
    path.parent.mkdir(exist_ok=True)
    torch.save(reference_checkpoint(source.state_dict()), path)
    try:
        imported = load_reference_cil_checkpoint(load_checkpoint_file(str(path)))
    finally:
        path.unlink()
    model = build_model(cfg, dtype=torch.bfloat16, device=dev).module()
    model.load_state_dict(imported, strict=True)
    launches = []
    with torch.no_grad():
        logits = []
        for m in (source, model):
            _build.LAUNCHES.clear()
            logits.append(m(x, train=False)["cls_score"])
            torch.cuda.synchronize()
            launches.append(_build.LAUNCHES[FWD])
    eta = float(model.cls_head.eta.detach())
    diff = float((logits[0] - logits[1]).float().abs().max())
    if not torch.equal(logits[0], logits[1]) or not torch.isfinite(logits[1]).all():
        raise AssertionError(f"reference (a): imported logits differ from the source's by {diff}")
    if launches != [CIL_BLOCKS, CIL_BLOCKS] or eta != 1.75:
        raise AssertionError(f"reference (a): #1 launches {launches} (want {CIL_BLOCKS} a "
                             f"forward), eta {eta} (want the current model's 1.75)")
    out["a"] = dict(launches=launches[1], eta=eta, keys=len(imported), max_abs_err=diff,
                    seconds=time.perf_counter() - t0)
    print(f"reference (a): ckpt_task_1.pt in the reference's layout (current_model. + "
          f"prev_model. with eta {REFERENCE_PREV_ETA} + num_batches_tracked) -> "
          f"load_reference_cil_checkpoint -> strict load, {len(imported)} keys; config B eval "
          f"logits {tuple(logits[1].shape)} equal the source's bit for bit (max abs err "
          f"{diff}), #1 launches "
          f"{launches[1]} a forward, eta {eta}, {out['a']['seconds']:.1f} s [{smi}]", flush=True)
    del source, model, imported, logits

    # (b) conv1x1_mode 'pallas_stats' (#3) against 'pallas_stats_interpret' (its plain twin)
    t0 = time.perf_counter()
    runs, state = {}, None
    for mode in ("pallas_stats", "pallas_stats_interpret"):
        cfg = presets.hmdb51_r50_cfg(nc, SEGMENTS, dropout_ratio=0.0, shift_mode="pad",
                                     conv1x1_mode=mode)
        spec = build_model(cfg, dtype=torch.bfloat16, device=dev)
        model = init_model_params(spec, seed)
        if state is None:
            state = model.state_dict()
        else:
            model.load_state_dict(state, strict=True)
        _build.LAUNCHES.clear()
        with torch.no_grad():
            score = model(x, train=True)["cls_score"][:, 0, :]
            loss = lsc_nca_loss(score, labels, model.cls_head.eta)  # LSCLoss's defaults
        torch.cuda.synchronize()
        runs[mode] = dict(score=score.float(), loss=float(loss), launches=_build.LAUNCHES[CONV])
        del model
    kern, plain = runs["pallas_stats"], runs["pallas_stats_interpret"]
    err = float((kern["score"] - plain["score"]).abs().max())
    tol = 3e-2 * float(plain["score"].abs().max())  # phase 3's bf16 tolerance
    loss_err = abs(kern["loss"] - plain["loss"])
    launches = [kern["launches"], plain["launches"]]
    if launches != [32, 0]:
        raise AssertionError(f"reference (b): #3 launches {launches}, want [32, 0]")
    if not (err <= tol and loss_err <= 3e-2 * abs(plain["loss"])
            and math.isfinite(kern["loss"]) and math.isfinite(plain["loss"])):
        raise AssertionError(f"reference (b): logits off by {err} (tol {tol}), losses "
                             f"{kern['loss']} vs {plain['loss']}")
    out["b"] = dict(launches=launches, max_abs_err=err, tol=tol, loss=kern["loss"],
                    loss_interpret=plain["loss"], seconds=time.perf_counter() - t0)
    print(f"reference (b): config A train-mode forward {BATCH} x {SEGMENTS} x {SIZE}² bf16, #3 "
          f"launches "
          f"{launches[0]} under 'pallas_stats' and {launches[1]} under 'pallas_stats_interpret'"
          f"; logits max abs err {err:.4g} (tol {tol:.4g}), loss {kern['loss']:.6f} vs "
          f"{plain['loss']:.6f}, {out['b']['seconds']:.1f} s [{smi}]", flush=True)
    torch.cuda.empty_cache()
    return out


# --- phase 14: the port's JPEG codec on the card's machine ---------------------------

# Frames the phase writes with the port's writer, (w, h, quality): the gate holds the
# file bytes and every decode of them to digests taken with libjpeg-turbo 2.1.5.
JPEG_PORT_FILES = [(320, 240, 50), (320, 240, 75), (320, 240, 95), (320, 240, 100),
                   (321, 241, 95), (17, 9, 75)]
# Frames written with cv2.imwrite, (name, quality, sampling, restart interval in MCUs;
# sampling None: gray); their copies as written when the digests were taken are
# under JPEG_GOLDEN_DIR, since another cv2 may write other bytes.
JPEG_CV2_FILES = [("444_rst3", 90, "444", 3), ("422", 90, "422", 0), ("gray", 90, None, 0),
                  ("420_rst2", 90, "420", 2)]
JPEG_GOLDEN_DIR = pathlib.Path("tests/goldens/jpeg")
# sha256 of each file's bytes (the port's writer, and the cv2 goldens) and of
# jpeg_outputs over it, computed with libjpeg-turbo 2.1.5 (the JAX package's decoder)
JPEG_DIGESTS = {
    "port_320x240_q50.jpg": dict(
        file="2eb5edecd641a0aca161682aaa4814e9793b85b6f7f2271b6b6e8ff0b3900f3e",
        outputs="2bc7558afb6e005bba861177390b4f119c794a40e39e15cd3e0e6dd7b9145f1f"),
    "port_320x240_q75.jpg": dict(
        file="a71764896d43ecd51f6c3f920cee2141bb8d3635a30cea11374e3bafe8677316",
        outputs="7f1c911959bbda350e1ce1206a84db5528361007d10bcc411b0584af008c9dc2"),
    "port_320x240_q95.jpg": dict(
        file="4fdcf1cef7311a863af60ca2dcb7a727142f9ab3c2a1cf31c7bbc75c608c37fb",
        outputs="2725d2006c9aeaa6389cf2f413a617875f4b7ff95173f80ca9f1058202c5c70a"),
    "port_320x240_q100.jpg": dict(
        file="f0c90115d82df54e294c22a76e41d4c5a1ab89c04e799fb8734729751e05513d",
        outputs="e5f316725a252af10c361a28d422813d5b975690934dba89b636d247cb433e95"),
    "port_321x241_q95.jpg": dict(
        file="2c636638a23a0ec1fd9013d7cfbbe6095b14426b9e222dd7163e3128cef6999f",
        outputs="cb35ec5cf079a16f117d6dd54d031efe761a98e6dc9a93f0557d611d9448c6b7"),
    "port_17x9_q75.jpg": dict(
        file="d41c39c1f6e4cca9d7c0cad84c9dbcfe515b3336ba3796cca30227b95522910d",
        outputs="4276342a0a67dbb7a6bbbd8029f1f098162703c194c83d50e8f0c048b4718dc2"),
    "cv2_444_rst3.jpg": dict(
        file="8c6fc4e5f579a6800826a5834bf0c2a02115fd8bc72963a2dda6c87e9d033ce3",
        outputs="c2a2da74bc6d0c847f2f05d8264e21c3c77a2caddad79d22729c072c3e1cdb85"),
    "cv2_422.jpg": dict(
        file="653ae1a48ea913e12a848430a1f9538b02ecfc53df12044707a04d8c9fed40d7",
        outputs="4102e55b4012493913e72f2a655965359d06789eddc5e4e3467182dce2df370e"),
    "cv2_gray.jpg": dict(
        file="b2b98dbd78e94fbcced6203f7bba1965d65049ef8a3e4ec1dd519faa0246499c",
        outputs="42d6287da16cb8b2cfcf3502dff142642090985311bb03cf8bb58064629dc6ec"),
    "cv2_420_rst2.jpg": dict(
        file="7d0d71c3ef8c72f2e921c40e70d132959724d88ec8c0ac5f7cf4a488e298d44d",
        outputs="d73d46d619d5e9c301ad614721d65755eb62fe5dbbad267da4f04ab0d7f3bc4f"),
}
# the bench corpus of bench_train (64 videos x 16 frames at 320 x 240, quality 95)
JPEG_BENCH_VIDEOS, JPEG_BENCH_FRAMES = 64, 16


def jpeg_frame(seed: int, w: int, h: int):
    """A seeded RGB frame: a smooth gradient with a little noise. The phase's
    frames take fixed seeds, whatever ``--seed`` is: the digests are of them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = rng.uniform(0, 6, 6)
    img = np.stack([128 + 100 * np.sin(xx / (w + 1) * a[i] + yy / (h + 1) * a[i + 3])
                    for i in range(3)], -1)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def write_cv2_jpeg(path, spec, seed: int):
    """cv2.imwrite of a seeded frame at a ``JPEG_CV2_FILES`` entry's settings."""
    import cv2

    _, quality, sampling, rst = spec
    img = jpeg_frame(seed, *UCF_STORED)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if sampling is None:
        img = img[..., 0]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    if not cv2.imwrite(str(path), img[..., ::-1] if img.ndim == 3 else img, params):
        raise IOError(f"cv2.imwrite failed for {path}")


def jpeg_outputs(lib, path: str):
    """Every decoder entry point on one file (``lib``: a native module, the
    port's or, where the digests were taken, the JAX package's), the plane
    cache off: full-size RGB, short-side resizes that make the DCT scale 2, 4
    and 8, a per-axis resize, the yuv420 wire, its full-frame form, TenCrop,
    the stored planes and the header's dims."""
    import numpy as np

    w, h = (int(v) for v in lib.probe_dims_batch([path])[0])
    outs = [np.array([w, h], dtype=np.int32), lib.decode_file(path)]
    for d in (2, 4, 8):
        s = max(1, min(w, h) // d)
        outs.append(lib.decode_resize_crop_batch([path], s, max(1, s // 2), max(1, s // 2)))
    dims = np.array([[max(2, w * 3 // 4), max(2, h * 3 // 4)]], dtype=np.int32)
    crop = max(1, int(dims.min()) // 2)
    outs.append(lib.decode_resize2_crop_batch([path], dims, crop, crop, [(1, 1)]))
    outs += list(lib.decode_yuv420_batch([path], dims, crop // 2 * 2 or 2, [(0, 0)]))
    outs += list(lib.decode_yuv420_full_batch([path], dims, int(dims[0, 0] + 1) // 2 * 2,
                                              int(dims[0, 1] + 1) // 2 * 2))
    outs.append(lib.decode_tencrop_batch([path], max(1, min(w, h) // 2), max(1, min(w, h) // 4)))
    outs += list(lib.fetch_planes_batch([path], (w + 1) // 2 * 2, (h + 1) // 2 * 2))
    return outs


def sha256_of(arrays_or_bytes) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in arrays_or_bytes:
        h.update(a if isinstance(a, bytes) else a.tobytes())
    return h.hexdigest()


def jpeg_phase(dev, seed, smi):
    """Phase 14: the port's JPEG codec on the card's machine: its files and
    decodes against libjpeg's digests, against cv2.imread, its decode rates,
    and bench_train's window from JPEG beside its synthetic one."""
    import argparse as _argparse
    import shutil

    import cv2
    import numpy as np

    from bdvcil_torch import bench_train
    from bdvcil_torch.data import corpus, native
    from bdvcil_torch.ops import _build

    root = pathlib.Path("chiprun_out/jpeg_phase").resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = dict(files={})
    try:
        native.decode_cache_set_budget_mb(0)
        files = {}
        for i, (w, h, q) in enumerate(JPEG_PORT_FILES):
            path = root / f"port_{w}x{h}_q{q}.jpg"
            native.write_jpeg_batch([str(path)], jpeg_frame(i, w, h)[None], quality=q)
            files[path.name] = path
        for i, spec in enumerate(JPEG_CV2_FILES):
            name = spec[0]
            path = root / f"cv2_{name}.jpg"
            write_cv2_jpeg(path, spec, 100 + i)
            files[path.name] = path
            files[f"golden_{name}.jpg"] = JPEG_GOLDEN_DIR / f"cv2_{name}.jpg"
        bad, cv2_bytes_equal, imread_diff = [], 0, {}
        for key, path in files.items():
            data = path.read_bytes()
            outs = jpeg_outputs(native, str(path))
            got = dict(file=sha256_of([data]), outputs=sha256_of(outs))
            want = JPEG_DIGESTS[key.replace("golden_", "cv2_")]
            if key.startswith("cv2_") and got["file"] != want["file"]:
                got["gated"] = "no: this machine's cv2 writes other bytes (its golden is)"
            else:
                cv2_bytes_equal += key.startswith("cv2_")
                got["gated"] = "yes"
                if got != dict(want, gated="yes"):
                    bad.append(key)
            ref = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
            imread_diff[key] = int((outs[1] != ref).any(-1).sum())
            out["files"][key] = dict(got, imread_pixels_differ=imread_diff[key])
        if bad:
            raise AssertionError(f"jpeg: the port's codec differs from libjpeg's digests on "
                                 f"{bad}")
        out.update(imread_pixels_differ=sum(imread_diff.values()),
                   cv2_bytes_equal=cv2_bytes_equal)
        print(f"jpeg: {len(files)} files (the port's writer: {len(JPEG_PORT_FILES)}, cv2 on "
              f"this machine: {len(JPEG_CV2_FILES)}, of which {cv2_bytes_equal} byte-equal to "
              f"the goldens, and the {len(JPEG_CV2_FILES)} goldens): file bytes and the "
              f"{len(outs)} decoder outputs of each equal libjpeg-turbo 2.1.5's digests; "
              f"against cv2.imread {out['imread_pixels_differ']} pixels differ "
              f"({imread_diff}) [{smi}]", flush=True)

        # decode rates on bench_train's corpus: cold (no plane cache) and warm
        infos, _ = corpus.write_corpus(root / "bench_corpus", JPEG_BENCH_VIDEOS,
                                       JPEG_BENCH_FRAMES, seed=0,
                                       num_classes=bench_train.NUM_CLASSES)
        paths = [os.path.join(i["frame_dir"], corpus.FILENAME_TMPL.format(t))
                 for i in infos for t in range(1, JPEG_BENCH_FRAMES + 1)]
        n = len(paths)
        dims = np.array([[341, 256]] * n, dtype=np.int32)  # the short side at 256
        pool = native.default_threads()
        rates = {}
        for cache in ("cold", "warm"):
            native.decode_cache_set_budget_mb(0 if cache == "cold" else 512)
            if cache == "warm":
                native.decode_yuv420_batch(paths, dims, SIZE, [(0, 0)] * n, num_threads=pool)
            for threads in (1, pool):
                for wire, call in (
                        ("yuv420", lambda t: native.decode_yuv420_batch(
                            paths, dims, SIZE, [(0, 0)] * n, num_threads=t)),
                        ("rgb", lambda t: native.decode_resize_crop_batch(
                            paths, 256, SIZE, SIZE, num_threads=t))):
                    t0 = time.perf_counter()
                    call(threads)
                    rates[f"{wire} {cache} {threads} thread{'s' * (threads > 1)}"] = \
                        n / (time.perf_counter() - t0)
        # full-size RGB on one thread: the port's codec against cv2's libjpeg-turbo (SIMD)
        for name, decode in (("port decode_file", native.decode_file),
                             ("cv2.imread", lambda p: cv2.imread(p, cv2.IMREAD_COLOR))):
            t0 = time.perf_counter()
            for p in paths[:256]:
                decode(p)
            rates[f"full {name} 1 thread"] = 256 / (time.perf_counter() - t0)
        out.update(decode_frames_per_s=rates, decode_frames=n, decode_pool_threads=pool,
                   decode_cache=native.decode_cache_stats())
        print(f"jpeg decode rates, frames/s over {n} frames of 320x240 at quality 95 (the "
              f"yuv420 wire at 224 from 341x256; rgb: resize to 256, centre crop 224; cold: "
              f"the plane cache off; warm: served by it; full: 320x240 RGB, 256 frames): "
              + ", ".join(f"{k} {v:.0f}" for k, v in rates.items())
              + f"; cache {out['decode_cache']} [{smi}]", flush=True)
        native.decode_cache_set_budget_mb(512)
        native.decode_cache_clear()

        # bench_train, config A: one window from JPEG, one synthetic
        out["bench"] = {}
        for source in ("jpeg", "synthetic"):
            args = _argparse.Namespace(
                config="A", family="bgmix", k=8, source=source, device=None,
                corpus=str(root / "bench_corpus"),
                videos=JPEG_BENCH_VIDEOS, frames=JPEG_BENCH_FRAMES, batch=BATCH,
                segments=SEGMENTS, size=SIZE, depth=50, warmup=2, windows=1, steps=40,
                device_calls=3)
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            res = bench_train.run(args)
            launches = kernel_launches()
            if launches != {CONV: 32 * res["steps"], **bn_launches(res["steps"], sums=32)}:
                raise AssertionError(f"bench_train --source {source}: kernel launches "
                                     f"{launches}, expected 32 x {res['steps']} of {CONV} and "
                                     f"BatchNorm's")
            out["bench"][source] = dict(res, launches=launches)
            print(f"bench_train --config A --source {source} ({res['wire_format']} wire, K={res['k']}, "
                  f"1 window of {args.steps} steps): e2e {res['value']:.2f} clips/s, "
                  f"device_clips_per_sec {res['device_clips_per_sec']:.2f}, "
                  f"host_decode_frames_per_sec {res['host_decode_frames_per_sec']}, producer "
                  f"wait {res['producer_wait_s']:.3f} s of {res['window_wall_s'][0]:.2f} s, "
                  f"cache {res.get('decode_cache')}; #3 launches {launches[CONV]} = 32 x "
                  f"{res['steps']} steps [{smi}]", flush=True)
    finally:
        native.decode_cache_set_budget_mb(512)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# --- phase 15: the fed step split into wait, put, dispatch and device ------------------

PROFILE_STEPS = 24  # steps a mode
PROFILE_STAGES = ("wait", "put", "dispatch", "device")
PROFILE_PHASES = ("pass1", "probe", "pass2", "decode")
PROFILE_TIMED_BATCHES = 4  # the loader's batches timed one by one against their phases


def profile_phase(dev, seed, smi):
    """Phase 15: ``profile_e2e`` at config A, 16 x 8 x 224², bf16, on
    bench_train's corpus with ``BDVC_PROFILE_PRODUCER=1``: every mode from JPEG
    and from synthetic wire batches (#3 at 32 launches a step); each mode's
    steps, the producer's phases, baseline's stages against its wall; the
    phases of single batches against their time; the switch off."""
    import argparse as _argparse
    import shutil

    from bdvcil_torch import bench_train, profile_e2e
    from bdvcil_torch.data import loaders
    from bdvcil_torch.ops import _build

    t_phase = time.perf_counter()
    root = pathlib.Path("chiprun_out/profile_phase").resolve()
    shutil.rmtree(root, ignore_errors=True)
    switch = os.environ.get("BDVC_PROFILE_PRODUCER")
    os.environ["BDVC_PROFILE_PRODUCER"] = "1"
    out = dict(steps=PROFILE_STEPS, modes={})

    def profile_args(source):
        return _argparse.Namespace(
            steps=PROFILE_STEPS, mode="all", workers=1, config="A", source=source, device=None,
            corpus=str(root / "corpus"), videos=JPEG_BENCH_VIDEOS, frames=JPEG_BENCH_FRAMES,
            batch=BATCH, segments=SEGMENTS, size=SIZE, depth=50)

    try:
        for source in ("jpeg", "synthetic"):
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            lines = profile_e2e.run(profile_args(source), emit=lambda text: None)
            torch.cuda.synchronize()
            launches = kernel_launches()
            steps = profile_e2e.WARM_STEPS + len(lines) * PROFILE_STEPS
            if launches != {CONV: 32 * steps, **bn_launches(steps, sums=32)}:
                raise AssertionError(f"profile_e2e --source {source}: kernel launches "
                                     f"{launches}, expected 32 x {steps} of {CONV} and "
                                     f"BatchNorm's")
            for line in lines:
                what = f"profile_e2e {line['mode']} --source {source}"
                if line["steps"] != PROFILE_STEPS:
                    raise AssertionError(f"{what}: {line['steps']} steps, not {PROFILE_STEPS}")
                staged = sum(line[k] for k in PROFILE_STAGES) * PROFILE_STEPS / 1e3
                if line["mode"] == "baseline" and abs(staged - line["wall_s"]) > 0.1 * line[
                        "wall_s"]:
                    raise AssertionError(f"{what}: the stages sum to {staged:.3f} s of a "
                                         f"{line['wall_s']:.3f} s wall (more than 10% apart)")
                phases = line["producer_ms"]
                if source == "jpeg" and (set(phases) != set(PROFILE_PHASES)
                                         or min(phases.values()) < 0
                                         or line["producer_batches"] < PROFILE_STEPS):
                    raise AssertionError(f"{what}: producer phases {phases} over "
                                         f"{line['producer_batches']} batches")
                residual = line["wall_s"] * 1e3 / PROFILE_STEPS - sum(
                    line[k] for k in PROFILE_STAGES)
                cache = line.get("decode_cache")
                print(f"{what} (config A, {BATCH} x {SEGMENTS} x {SIZE}², bf16, {steps} "
                      f"steps with #3 at 32 a step): {line['clips_per_sec']:.2f} clips/s, "
                      f"wall {line['wall_s']:.3f} s; ms a step: "
                      + ", ".join(f"{k} {line[k]:.3f}" for k in PROFILE_STAGES)
                      + f", rest {residual:.3f}; producer ms a batch: "
                      + (", ".join(f"{k} {v:.3f}" for k, v in phases.items()) or "none")
                      + f" ({line['producer_batches']} batches)"
                      + ("" if cache is None else f"; cache hit rate {cache['hit_rate']:.4f} "
                         f"({cache['hits']} / {cache['misses']})") + f" [{smi}]", flush=True)
                out["modes"][f"{source} {line['mode']}"] = line
            out[f"launches {source}"] = launches

        # the producer's phases inside single batches, each timed on its own
        loader, _ = bench_train.make_loader(profile_args("jpeg"))
        timed = []
        for item in loader._epoch_batches(0)[:PROFILE_TIMED_BATCHES]:
            with loaders._PRODUCER_STATS_LOCK:
                loaders.PRODUCER_STATS.clear()
            t0 = time.perf_counter()
            loader._make_batch(*item)
            batch_ms = (time.perf_counter() - t0) * 1e3
            stats = dict(loaders.PRODUCER_STATS)
            phases = {k: stats[k] * 1e3 for k in PROFILE_PHASES}
            if stats.get("batches") != 1 or min(phases.values()) < 0 or \
                    sum(phases.values()) > batch_ms:
                raise AssertionError(f"loader batch of {batch_ms:.3f} ms: producer stats "
                                     f"{stats}")
            timed.append(dict(batch_ms=batch_ms, **phases))
        out["timed_batches"] = timed
        print(f"profile producer: {len(timed)} FastBGMixLoader batches timed one by one, ms "
              f"(batch / pass1 + probe + pass2 + decode): "
              + "; ".join(f"{t['batch_ms']:.3f} / " + " + ".join(
                  f"{t[k]:.3f}" for k in PROFILE_PHASES) for t in timed) + f" [{smi}]",
              flush=True)

        # the switch off: the loader records nothing
        os.environ["BDVC_PROFILE_PRODUCER"] = "0"
        with loaders._PRODUCER_STATS_LOCK:
            loaders.PRODUCER_STATS.clear()
        it = loader.iter_epochs(0, 1)
        for _ in range(len(loader)):
            next(it)
        it.close()
        if loaders.PRODUCER_STATS:
            raise AssertionError(f"BDVC_PROFILE_PRODUCER=0: the loader recorded "
                                 f"{loaders.PRODUCER_STATS}")
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"profile producer off: {len(loader)} batches, nothing recorded; phase "
              f"{out['phase_s']:.1f} s [{smi}]", flush=True)
    finally:
        if switch is None:
            os.environ.pop("BDVC_PROFILE_PRODUCER", None)
        else:
            os.environ["BDVC_PROFILE_PRODUCER"] = switch
        with loaders._PRODUCER_STATS_LOCK:
            loaders.PRODUCER_STATS.clear()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# --- phase 16: the port's benches ----------------------------------------------------

BENCH_STEPS, BENCH_WARMUP = 10, 3  # (a): steps timed after the warm-up steps
BENCH_EVAL_K, BENCH_EVAL_STEPS = 4, 8  # (b): 2 passes of 4 batches a sweep
BENCH_ACM_STEPS = 40  # (c): one window
BENCH_INPUT_FRAMES = 256


def bench_phase(dev, seed, smi):
    """Phase 16: ``bench_step`` (A, default; forward-only B), ``bench_eval``
    (B), ``bench_train --family acm`` (A) and ``bench_input`` in process at
    16 x 8 x 224², bf16, each with its launch counts set to 0 before it and
    read after it."""
    import shutil

    from bdvcil_torch import bench_eval, bench_input, bench_step, bench_train
    from bdvcil_torch.ops import _build

    t_phase = time.perf_counter()
    root = pathlib.Path("chiprun_out/bench_phase").resolve()
    shutil.rmtree(root, ignore_errors=True)
    shape = ["--batch", str(BATCH), "--segments", str(SEGMENTS), "--size", str(SIZE),
             "--corpus", str(root / "corpus"), "--videos", str(JPEG_BENCH_VIDEOS),
             "--frames", str(JPEG_BENCH_FRAMES)]
    out = {}

    def counted(fn, args):
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        res = fn(args)
        torch.cuda.synchronize()
        return res, kernel_launches()

    try:
        # (a) the step headline, A and default; the forward-only bench, B
        for config in ("A", "default"):
            args = bench_step.build_parser().parse_args(
                shape + ["--config", config, "--steps", str(BENCH_STEPS),
                         "--warmup", str(BENCH_WARMUP)])
            res, launches = counted(bench_step.run, args)
            steps = BENCH_STEPS + BENCH_WARMUP
            want = ({CONV: 32 * steps, **bn_launches(steps, sums=32)} if config == "A"
                    else bn_launches(steps))
            if launches != want:
                raise AssertionError(f"bench_step --config {config}: kernel launches {launches}, "
                                     f"expected {want} over {steps} steps")
            for key in ("mfu", "bw_roofline_fraction"):
                if not 0 < res[key] <= 1:
                    raise AssertionError(f"bench_step --config {config}: {key} {res[key]} is "
                                         f"not in (0, 1]")
            out[f"step {config}"] = dict(res, launches=launches)
            print(f"bench_step --config {config} ({BATCH} x {SEGMENTS} x {SIZE}², bf16, "
                  f"{BENCH_STEPS} steps after {BENCH_WARMUP}): {res['value']:.2f} clips/s, mfu "
                  f"{res['mfu']:.4f}, bw_roofline_fraction {res['bw_roofline_fraction']:.4f} "
                  f"({res['model_tflops_per_clip']:.4f} TFLOP a clip), launches {launches} "
                  f"[{smi}]", flush=True)
        args = bench_step.build_parser().parse_args(
            shape + ["--config", "B", "--forward-only", "--steps", str(BENCH_STEPS),
                     "--warmup", str(BENCH_WARMUP)])
        res, launches = counted(bench_step.run, args)
        forwards = BENCH_STEPS + BENCH_WARMUP
        if launches != {FWD: CIL_BLOCKS * forwards}:
            raise AssertionError(f"bench_step --forward-only --config B: kernel launches "
                                 f"{launches}, expected {CIL_BLOCKS} x {forwards} of {FWD}")
        out["forward B"] = dict(res, launches=launches)
        print(f"bench_step --forward-only --config B: {res['value']:.2f} clips/s "
              f"(vs_baseline {res['vs_baseline']:.3f}), launches {launches} [{smi}]", flush=True)

        # (b) eval, centre crop and TenCrop, config B
        args = bench_eval.build_parser().parse_args(
            shape + ["--config", "B", "--measures", "1", "--k", str(BENCH_EVAL_K),
                     "--steps", str(BENCH_EVAL_STEPS), "--skip-rgb"])
        res, launches = counted(bench_eval.run, args)
        forwards = sum(res["forwards"].values())
        if launches != {FWD: CIL_BLOCKS * forwards}:
            raise AssertionError(f"bench_eval --config B: kernel launches {launches}, expected "
                                 f"{CIL_BLOCKS} x {forwards} of {FWD}")
        if res["tencrop_wire"] != "yuv420_full" or res["wires"]["center"] != "rgb":
            raise AssertionError(f"bench_eval wires {res['wires']}")
        passes = -(-BENCH_EVAL_STEPS // (JPEG_BENCH_VIDEOS // BATCH))
        if set(res["rows"].values()) != {passes * JPEG_BENCH_VIDEOS}:
            raise AssertionError(f"bench_eval rows {res['rows']}, expected {passes} x "
                                 f"{JPEG_BENCH_VIDEOS}")
        out["eval B"] = dict(res, launches=launches)
        print(f"bench_eval --config B (K={BENCH_EVAL_K}, {passes} passes over "
              f"{JPEG_BENCH_VIDEOS} videos a sweep): centre {res['value']:.2f} videos/s "
              f"(rgb wire), TenCrop {res['tencrop_videos_per_sec']:.2f} videos/s "
              f"({res['tencrop_wire']} wire); forwards {res['forwards']}, launches {launches} "
              f"[{smi}]", flush=True)

        # (c) the ActorCutMix family end to end, config A
        args = bench_train.build_parser().parse_args(
            shape + ["--config", "A", "--family", "acm", "--windows", "1",
                     "--steps", str(BENCH_ACM_STEPS), "--warmup", "1", "--device-calls", "1"])
        made = []  # the loader bench_train.run makes
        make_loader = bench_train.make_loader

        def recording(*a, **kw):
            made.append(make_loader(*a, **kw))
            return made[-1]

        bench_train.make_loader = recording
        try:
            res, launches = counted(bench_train.run, args)
        finally:
            bench_train.make_loader = make_loader
        loader = made[0][0]
        if type(loader).__name__ != "FastACMLoader" or loader.wire_format != res["wire_format"]:
            raise AssertionError(f"bench_train --family acm ran {type(loader).__name__} on "
                                 f"{loader.wire_format}, its line names {res['wire_format']}")
        if launches != {CONV: 32 * res["steps"], **bn_launches(res["steps"], sums=32)}:
            raise AssertionError(f"bench_train --family acm: kernel launches {launches}, "
                                 f"expected 32 x {res['steps']} of {CONV} and BatchNorm's")
        out["acm A"] = dict(res, launches=launches)
        print(f"bench_train --family acm --config A ({type(loader).__name__}, "
              f"{res['wire_format']} wire, K={res['k']}, 1 window of {BENCH_ACM_STEPS} steps): "
              f"e2e {res['value']:.2f} clips/s, device_clips_per_sec "
              f"{res['device_clips_per_sec']:.2f}, producer wait {res['producer_wait_s']:.3f} s, "
              f"launches {launches} [{smi}]", flush=True)

        # (d) the native decoder against the cv2 chain
        res = bench_input.run(bench_input.build_parser().parse_args(
            ["--frames", str(BENCH_INPUT_FRAMES)]))
        out["input"] = res
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"bench_input ({res['frames']} frames of 320x240 at q90, short side 256, centre "
              f"224): native {res['value']:.1f} frames/s, cv2 {res['cv2_frames_per_sec']:.1f} "
              f"(x{res['vs_baseline']:.2f}), {res['host_cpus']} CPUs; phase "
              f"{out['phase_s']:.1f} s [{smi}]", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


STUDY_BLOCKS = 8  # TSM-R18's blocks: one #1 launch each a forward, one #2 each a backward
STUDY_STAGES = 3


def expected_study_launches(cfg, fused=True):
    """The launches of the port's side of one parity_study pair, from its
    config: the CIL run's count (``expected_cil_launches``: TSM-R18 in
    float32) over its tasks, without cil_testing; #1 / #2 in
    ``shift_mode='fused_block'`` (``fused``), train-mode BatchNorm's always
    (the reference loop runs torch's own BatchNorm)."""
    from bdvcil_torch.reference_loop import tree

    params = tree.TREE_PARAMS
    per_task, _ = expected_cil_launches(
        use_cbf=cfg["use_cbf"], splits=cfg["task_splits"][:cfg["ending_task"] + 1],
        train=params["train_videos_per_class"],
        val=params["val_videos_per_class"] + params["extra_val_videos_per_class"],
        budget=cfg["budget_size"], train_batch=cfg["videos_per_gpu"],
        test_batch=cfg["testing_videos_per_gpu"], epochs=cfg["num_epochs_per_task"],
        cbf_epochs=cfg["cbf_num_epochs_per_task"], blocks=STUDY_BLOCKS, bns=R18_BNS,
        dtype=torch.float32)
    return {k: sum(task[k] for task in per_task) for k in per_task[0]
            if fused or k not in (FWD, BWD)}


def check_study_run(what, payload, stages):
    """One parity_study output: the JSON schema, one run, both sides' matrices
    with ``stages`` rows (row t has t + 1 tasks), every value finite in
    [0, 100]. Returns the run."""
    want = {"method", "stages", "extra_val", "device", "n_seeds", "runs", "summary"}
    if not want <= set(payload) or payload["n_seeds"] != 1 or len(payload["runs"]) != 1:
        raise AssertionError(f"{what}: output {sorted(payload)}, n_seeds {payload.get('n_seeds')}")
    run = payload["runs"][0]
    keys = {"seed", "device", "wall_reference_s", "wall_port_s"} | {
        f"{m}_{side}" for m in ("cnn", "nme", "cnn_matrix", "nme_matrix")
        for side in ("reference", "port")}
    if set(run) != keys:
        raise AssertionError(f"{what}: run keys {sorted(run)}")
    for side in ("reference", "port"):
        for m in ("cnn", "nme"):
            matrix = run[f"{m}_matrix_{side}"]
            if [len(row) for row in matrix] != list(range(1, stages + 1)):
                raise AssertionError(f"{what}: {m} matrix of the {side} side {matrix}")
            values = [v for row in matrix for v in row] + run[f"{m}_{side}"]
            if not all(math.isfinite(v) and 0 <= v <= 100 for v in values):
                raise AssertionError(f"{what}: {m} of the {side} side out of [0, 100]: {matrix}")
    for m in ("cnn", "nme"):
        if not {"n_converged", "n_collapsed_reference", "n_collapsed_port",
                "final_stage_mean_delta"} <= set(payload["summary"][m]):
            raise AssertionError(f"{what}: summary {payload['summary'][m]}")
    return run


def study_phase(dev, seed, smi):
    """Phase 17: the accuracy studies on the card. (a) ``bn_ablation`` at its
    defaults; (b) ``parity_study`` through its ``main``, one seed of ``base``
    at 3 stages, on the parity config as it is (pad + xla: no kernel) and with
    the model's backbone at ``shift_mode='fused_block'`` (#1 and #2 in f32 on
    the port's side), each with its launch counts set to 0 before it and read
    after it."""
    import shutil

    from bdvcil_torch import bn_ablation, parity_study
    from bdvcil_torch.models.norm import BatchNorm, GroupedBatchNorm
    from bdvcil_torch.ops import _build
    from bdvcil_torch.ops import tsm_shift as tsm
    from bdvcil_torch.reference_loop import tree

    t_phase = time.perf_counter()
    root = pathlib.Path("chiprun_out/study_phase").resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {}

    # (a) the BatchNorm statistics modes, 3 seeds x 3 modes x 24 epochs
    built = []
    build_mode = bn_ablation.build_mode

    def recording(extra, *a, **kw):
        spec, module = build_mode(extra, *a, **kw)
        built.append((dict(extra), sum(isinstance(m, GroupedBatchNorm) for m in module.modules()),
                      sum(isinstance(m, BatchNorm) for m in module.modules())))
        return spec, module

    seeds = [int(x) for x in bn_ablation.SEEDS.split(",")]
    bn_ablation.build_mode = recording
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    try:
        t0 = time.perf_counter()
        res = bn_ablation.ablate(seeds, bn_ablation.EPOCHS, dev)
        torch.cuda.synchronize()
        bn_s = time.perf_counter() - t0
    finally:
        bn_ablation.build_mode = build_mode
    launches = kernel_launches()
    # R18 at pad + xla, the modes' default: train-mode BatchNorm's kernels in
    # float32, in the global mode only (batches of 32, the tail dropped)
    steps = bn_ablation.EPOCHS * sum(len(bn_ablation.seed_data(s)[1]) // 32 for s in seeds)
    if launches != bn_launches(steps, R18_BNS, dtype=torch.float32):
        raise AssertionError(f"bn_ablation: kernel launches {launches}, expected train-mode "
                             f"BatchNorm's over {steps} global-mode steps")
    records = res["records"]
    if len(records) != len(seeds) * len(bn_ablation.MODES):
        raise AssertionError(f"bn_ablation: {len(records)} records")
    for rec in records:
        if not (math.isfinite(rec["final_train_loss"]) and 0 <= rec["train_acc"] <= 1
                and 0 <= rec["val_acc"] <= 1):
            raise AssertionError(f"bn_ablation: {rec}")
    for extra, grouped, norms in built:
        # every BatchNorm grouped in the per-device and ghost modes, none in the global one
        if norms == 0 or grouped != (norms if extra else 0):
            raise AssertionError(f"bn_ablation {extra}: {grouped} GroupedBatchNorm of {norms} "
                                 f"BatchNorm modules")
    out["bn_ablation"] = dict(res, seconds=bn_s, grouped_bn=built)
    agg = res["summary"]["summary"]
    print(f"study (a) bn_ablation ({len(seeds)} seeds x {len(bn_ablation.MODES)} modes x "
          f"{bn_ablation.EPOCHS} epochs, R18-TSM 2 x 32², f32): "
          + "; ".join(f"{name.split()[0]} val_acc mean {v['mean']:.4f} spread {v['spread']:.4f}"
                      for name, v in agg.items())
          + f"; GroupedBatchNorm modules a model {sorted({(str(e), g) for e, g, _ in built})}; "
            f"{bn_s:.1f} s [{smi}]", flush=True)
    print("study (a) summary " + json.dumps(res["summary"]), flush=True)

    # (b) parity_study, one seed of base at 3 stages: pad + xla, then fused_block
    # the parity config's model dict (the paths are not read)
    model = copy.deepcopy(tree.make_parity_config(root, root, root, root, root).to_dict()["model"])
    model["backbone"]["shift_mode"] = "fused_block"
    # the (shape, dtype, segments) of every #1 / #2 call, against those phase 2 checks
    checked = {(kind, shape, dtype, seg) for _, shapes, backward, dtype, seg in fused_paths()
               for shape in shapes for kind in ((FWD, BWD) if backward else (FWD,))}
    fused_fwd, fused_bwd = tsm.fused_fwd, tsm.fused_bwd
    calls = collections.Counter()

    def recording_fwd(h, identity, num_segments, shift_div=8):
        calls[(FWD, tuple(h.shape), h.dtype, num_segments)] += 1
        return fused_fwd(h, identity, num_segments, shift_div)

    def recording_bwd(out, g_out, g_shifted, num_segments, shift_div=8):
        calls[(BWD, tuple(out.shape), out.dtype, num_segments)] += 1
        return fused_bwd(out, g_out, g_shifted, num_segments, shift_div)

    try:
        for name, extra in (("pad", []), ("fused_block", ["--set", f"model={model!r}"])):
            argv = ["--seeds", "1", "--first_seed", str(seed), "--method", "base",
                    "--stages", str(STUDY_STAGES), "--device", str(dev),
                    "--out", str(root / f"{name}.json"), "--data_root", str(root / "data")]
            made = []
            make_pair = parity_study.make_pair

            def recording_pair(*a, **kw):
                made.append(make_pair(*a, **kw))
                return made[-1]

            parity_study.make_pair = recording_pair
            tsm.fused_fwd, tsm.fused_bwd = recording_fwd, recording_bwd
            calls.clear()
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            try:
                if parity_study.main(argv + extra) != 0:
                    raise AssertionError(f"parity_study {name}: exit code not 0")
            finally:
                parity_study.make_pair = make_pair
                tsm.fused_fwd, tsm.fused_bwd = fused_fwd, fused_bwd
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_launches()
            payload = json.loads((root / f"{name}.json").read_text())
            run = check_study_run(f"parity_study {name}", payload, STUDY_STAGES)
            cfg = made[0][1].config
            want = expected_study_launches(cfg, fused=name != "pad")
            if cfg.model["backbone"].get("shift_mode", "pad") != name:
                raise AssertionError(f"parity_study {name}: the port's model ran "
                                     f"{cfg.model['backbone'].get('shift_mode', 'pad')}")
            if launches != want:
                raise AssertionError(f"parity_study {name}: kernel launches {launches}, "
                                     f"expected {want}")
            unchecked = sorted(str(c) for c in calls if c not in checked)
            if unchecked:
                raise AssertionError(f"parity_study {name}: #1 / #2 ran at shapes phase 2 does "
                                     f"not check: {unchecked}")
            collapsed = [f"{m} {side}" for m in ("cnn", "nme") for side in ("reference", "port")
                         if run[f"{m}_{side}"][-1] < parity_study.COLLAPSE_FLOOR_PTS]
            out[f"parity {name}"] = dict(run, launches=launches, wall_s=wall,
                                         summary=payload["summary"])
            print(f"study (b) parity_study --method base --stages {STUDY_STAGES} seed "
                  f"{seed}, {name} (the study's own epochs): CNN reference "
                  f"{[round(v, 2) for v in run['cnn_reference']]} port "
                  f"{[round(v, 2) for v in run['cnn_port']]}; NME reference "
                  f"{[round(v, 2) for v in run['nme_reference']]} port "
                  f"{[round(v, 2) for v in run['nme_port']]}; walls reference "
                  f"{run['wall_reference_s']:.2f} s, port {run['wall_port_s']:.2f} s, call "
                  f"{wall:.2f} s; collapsed {collapsed or 'none'}; launches {launches} at "
                  f"{len(calls)} (kernel, shape) pairs, each checked in phase 2 [{smi}]",
                  flush=True)
    finally:
        shutil.rmtree(root / "data", ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"study phase {out['phase_s']:.1f} s [{smi}]", flush=True)
    torch.cuda.empty_cache()
    return out


GRAFT_LOSS_RTOL = DIST_TOLS["A"][0]  # phase 12's loss rtol: a first step's f32 losses
# the KD term and (b)'s second step: the dry run's constant frames make the
# untrained R18 amplify f32 rounding, and each package's f32 dry run lies up
# to 1.52e-2 from its own float64 one on the CPU (tests/test_torch_port_graft_entry.py)
GRAFT_CHAOTIC_RTOL = 2e-2
# the input functions' f32 outputs, card vs CPU: their uint8 stages are bit
# for bit (phase 5), so only the normalize's rounding may differ
GRAFT_INPUT_ATOL = 1e-5
GRAFT_PARTS = "abcdefg"


def _close(what, got, want, rtol):
    if not (math.isfinite(got) and abs(got - want) <= rtol * abs(want)):
        raise AssertionError(f"{what}: {got} vs {want} (rtol {rtol})")


def check_graft_run(what, run, n, backend, device):
    """A dry run's schema: its ranks' backend and device, every part's losses
    finite, the eval scores (n, 10, 5); on the card each rank launched
    train-mode BatchNorm's float32 kernels for every train step ((a), (b)'s
    K, each of (d)-(g) that ran) and no other hand-written kernel, on the
    CPU none."""
    from bdvcil_torch import graft_entry

    if (run["n"], run["backend"], run["device"]) != (n, backend, device):
        raise AssertionError(f"{what}: ran {run['n']} ranks over {run['backend']} on "
                             f"{run['device']}, expected {n} over {backend} on {device}")
    for part in GRAFT_PARTS:
        if run[part] is None:
            if part not in "eg" or run["planes"]:
                raise AssertionError(f"{what}: part {part} did not run")
            continue
        values = [v for k, v in run[part].items() if k.endswith("loss")]
        if part != "c" and not (values and all(math.isfinite(v) for v in values)):
            raise AssertionError(f"{what}: part {part} losses {values}")
    scores = run["c"]["cls_score"]
    if scores.shape != (n, 10, 5) or not bool(torch.isfinite(torch.from_numpy(scores)).all()):
        raise AssertionError(f"{what}: eval cls_score {scores.shape}")
    steps = 1 + graft_entry.K + sum(run[part] is not None for part in "defg")
    want = {} if device == "cpu" else bn_launches(steps, R18_BNS, dtype=torch.float32)
    if run["launches"] != want or run["rank_launches"] != [sum(want.values())] * n:
        raise AssertionError(f"{what}: kernel launches {run['launches']} (rank 0), "
                             f"{run['rank_launches']} (each rank), expected {want} (TSM-R18 at "
                             f"pad + xla: BatchNorm's over {steps} train steps)")


def graft_metrics(run):
    """A dry run's result without its arrays (the eval scores, the input
    functions' outputs), for chiprun_out/chip_smoke.json."""
    return {k: {m: v for m, v in val.items() if m not in ("cls_score", "input")}
            if isinstance(val, dict) else val for k, val in run.items()}


def graft_phase(dev, seed, smi):
    """Phase 18: the driver's entry points (``bdvcil_torch.graft_entry``).
    (a) ``entry()`` on the card: cls_score (8, 1, 51), finite, the forward's
    ms, one clip against the CPU's forward at the same weights; (b)
    ``dryrun_multichip(1)`` in a one-rank NCCL group and ``(2)`` as two gloo
    processes on the card, against ``(2)`` on the CPU (run beside them); (c)
    no hand-written kernel launched in this process, and in each rank
    train-mode BatchNorm's only (``check_graft_run``)."""
    from bdvcil_torch import graft_entry
    from bdvcil_torch.ops import _build

    t_phase = time.perf_counter()
    out = {}
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        cpu_run = pool.submit(graft_entry.dryrun_multichip, 2, device="cpu", seed=seed,
                              echo=False)
        # (a) the flagship forward at the default modes
        fn, (model, imgs) = graft_entry.entry()
        if imgs.device.type != "cuda" or next(model.parameters()).device.type != "cuda":
            raise AssertionError(f"entry(): imgs on {imgs.device}, not on the card")
        scores = fn(model, imgs)
        torch.cuda.synchronize()
        if tuple(scores.shape) != (8, 1, 51) or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"entry(): cls_score {tuple(scores.shape)}, finite "
                                 f"{bool(torch.isfinite(scores).all())}")
        fwd_ms = cuda_ms(lambda: fn(model, imgs))
        cpu_fn, (cpu_model, cpu_imgs) = graft_entry.entry(device="cpu")
        ref = cpu_fn(cpu_model, cpu_imgs[:1]).float()
        got = fn(model, imgs[:1]).float().cpu()
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        if not err <= DIST_EVAL_TOL * scale:
            raise AssertionError(f"entry(): card vs CPU off by {err} of max |logit| {scale}")
        launched = kernel_launches()
        out["entry"] = dict(shape=list(scores.shape), forward_ms=fwd_ms, max_abs_err=err,
                            max_abs_logit=scale, launches=launched)
        print(f"graft (a) entry(): TSM-R50 bf16 eval forward at 8 x 8 x 224², cls_score "
              f"{tuple(scores.shape)} finite, {fwd_ms:.3f} ms a forward (CUDA events, median "
              f"of 10); one clip against the CPU's forward at the same weights: max abs err "
              f"{err:.4g} of max |logit| {scale:.4g} (tol {DIST_EVAL_TOL} of it); kernel "
              f"launches {launched} [{smi}]", flush=True)
        del model, imgs, cpu_model, cpu_imgs
        # (b) the dry run on the card, one rank and two
        t0 = time.perf_counter()
        one = graft_entry.dryrun_multichip(1, seed=seed)
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = graft_entry.dryrun_multichip(2, seed=seed)
        two_s = time.perf_counter() - t0
        cpu = cpu_run.result()
    finally:
        pool.shutdown(wait=True)
    check_graft_run("dryrun_multichip(1)", one, 1, "nccl", "cuda:0")
    check_graft_run("dryrun_multichip(2)", two, 2, "gloo", "cuda:0")
    check_graft_run("dryrun_multichip(2) on the CPU", cpu, 2, "gloo", "cpu")
    if (two["wire"], two["planes"]) != (cpu["wire"], cpu["planes"]):
        raise AssertionError(f"dryrun_multichip(2): wires {two['wire']}/{two['planes']} on the "
                             f"card, {cpu['wire']}/{cpu['planes']} on the CPU")
    gaps = {}
    for part in GRAFT_PARTS:
        if two[part] is None:
            continue
        if part == "c":
            got, want = two["c"]["cls_score"], cpu["c"]["cls_score"]
            gaps["c"] = float(abs(got - want).max())
            if not gaps["c"] <= DIST_EVAL_TOL * float(abs(want).max()):
                raise AssertionError(f"dryrun_multichip(2) eval: card vs CPU off by {gaps['c']}")
            continue
        for key in ("loss", "kd_loss"):
            if key in two[part]:
                rtol = (GRAFT_CHAOTIC_RTOL if key == "kd_loss" or part == "b"
                        else GRAFT_LOSS_RTOL)
                _close(f"dryrun_multichip(2) part {part} {key}, card vs CPU", two[part][key],
                       cpu[part][key], rtol)
                gaps[f"{part} {key}"] = abs(two[part][key] - cpu[part][key]) / abs(cpu[part][key])
        if "input" in two[part]:
            gap = float(abs(two[part]["input"] - cpu[part]["input"]).max())
            gaps[f"{part} input"] = gap
            if not gap <= GRAFT_INPUT_ATOL:
                raise AssertionError(f"dryrun_multichip(2) part {part}: input off by {gap}")
    launched = kernel_launches()
    if launched:  # (c) the default modes reach no hand-written kernel
        raise AssertionError(f"graft: kernel launches {launched}, expected none")
    for line in cpu["lines"]:
        print(f"cpu: {line}", flush=True)
    out.update({name: graft_metrics(run) for name, run in (("one", one), ("two", two),
                                                           ("cpu", cpu))})
    out.update(card_vs_cpu=gaps, one_s=one_s, two_s=two_s, launches=launched)
    print(f"graft (b) dryrun_multichip: 1 rank over NCCL {one_s:.1f} s, 2 gloo ranks on the "
          f"card {two_s:.1f} s, wire {two['wire']}, planes {two['planes']}; 2 ranks card vs "
          f"CPU: " + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
          + f" (losses rtol {GRAFT_LOSS_RTOL}, KD and (b) {GRAFT_CHAOTIC_RTOL}; eval "
            f"{DIST_EVAL_TOL} of the largest score; inputs atol {GRAFT_INPUT_ATOL}) [{smi}]",
          flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"graft (c) kernel launches {launched} in this process; a rank on the card "
          f"{two['launches']} (train-mode BatchNorm's alone at the default pad + xla modes); "
          f"graft phase {out['phase_s']:.1f} s [{smi}]", flush=True)
    torch.cuda.empty_cache()
    return out


# --- phase 19: the GEMM with statistics in float32, and at any K and N --------------

# (M, K, N): tests/test_conv1x1_bn.py's (100, 32, 128) and (896, 96, 128), and K
# and N that are not multiples of 8 (the wrapper pads them for the TMA) or 64
RAGGED_SHAPES = [(100, 32, 128), (896, 96, 128), (1000, 3, 5), (4096, 100, 101),
                 (4096, 96, 101)]
# float32 against the plain version (torch.matmul, TF32 off): y rtol 1e-5 and
# atol 1e-6 of max |y| (another order of f32 FMAs); the statistics rtol 1e-4,
# atol 1e-4 of the largest (another summation order)
F32_Y_RTOL, F32_Y_ATOL, F32_STATS_RTOL = 1e-5, 1e-6, 1e-4
# (b), pallas_stats against pallas_stats_interpret over two f32 steps: the JAX
# package's own tolerances for f32 statistics drift through 50 layers
# (tests/test_conv1x1_bn.py:91-105)
F32_LOSS_RTOL, F32_RUNNING_RTOL, F32_RUNNING_ATOL = 2e-3, 2e-3, 1e-3
# The bf16 core's (y, s1, s2) at the 12 R50 1x1 shapes of #3 on hashed operands
# (``bf16_core_checksums``), as the kernel computed them before it took K and N
# off the multiples of 64 (commit 93e9ecf), on an H100 SXM (132 SMs: the
# statistics' order follows the persistent grid, one partial per SM)
BF16_CORE_SMS = 132
BF16_CORE_CHECKSUMS = {
    "6272x512x2048": "7a5bf67ebd8447c6",
    "6272x2048x512": "942e36b78e032d01",
    "25088x256x1024": "3edf5c8ad03ace36",
    "25088x1024x256": "455afae3b6c99d76",
    "25088x1024x512": "e949686790e0609f",
    "100352x128x512": "dcc5256e686b6e0a",
    "100352x512x128": "1feeb59c5c333728",
    "100352x512x256": "a1796ec940090c31",
    "401408x64x64": "83d945673eb9a7de",
    "401408x64x256": "c38073956c07f57c",
    "401408x256x64": "5982b175fcdd3da0",
    "401408x256x128": "2028d8bbcdd35bd2",
}


def hashed(shape, salt: int, dev) -> torch.Tensor:
    """Values in [-1, 1) from an integer hash of each element's index: integer
    and exactly rounded float arithmetic only, so every card and every torch
    make the same bits."""
    i = torch.arange(math.prod(shape), device=dev, dtype=torch.int64)
    u = ((i * 2654435761 + salt * 40503) & 0xFFFFFFFF) >> 8  # 24 bits: exact in f32
    return (u.float() * 2.0 ** -23 - 1.0).reshape(shape)


def checksum(*tensors) -> str:
    """An integer checksum of the tensors' bits: each element's bits times a
    weight of its index, summed in int64 (wrapping, so in any order)."""
    total = 0
    for t in tensors:
        bits = t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)
        bits = bits.reshape(-1).long() & (0xFFFF if t.element_size() == 2 else 0xFFFFFFFF)
        i = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64)
        total = total * 1000003 + int((bits * ((i * 2654435761 + 1) % 1000003 + 1)).sum())
    return f"{total % (1 << 64):016x}"


def bf16_core_checksums(dev, conv):
    """``checksum`` of conv1x1_with_stats' (y, s1, s2) in bf16 at each R50 1x1
    shape of #3, on ``hashed`` operands."""
    out = {}
    for m, k, n in sorted(r50_shapes()[1]):
        x = hashed((m, 1, 1, k), 1, dev).to(torch.bfloat16)
        w = (hashed((k, n), 2, dev) * 2.0 ** -4).to(torch.bfloat16)
        out[f"{m}x{k}x{n}"] = checksum(*conv.conv1x1_with_stats_fwd(x, w))
        del x, w
    torch.cuda.empty_cache()
    return out


def assert_f32_stats(what, got, ref):
    """The float32 kernel's (y, s1, s2) within the F32_* tolerances of the
    plain version's; returns y's max abs error."""
    (y, s1, s2), (ry, rs1, rs2) = got, ref
    y = y.reshape(ry.shape)
    if y.dtype != torch.float32 or s1.shape != rs1.shape:
        raise AssertionError(f"{what}: y {y.dtype}, s1 {tuple(s1.shape)}")
    torch.testing.assert_close(y, ry, rtol=F32_Y_RTOL, atol=F32_Y_ATOL * float(ry.abs().max()),
                               msg=lambda m: f"{what} y: {m}")
    for g, r, name in ((s1, rs1, "s1"), (s2, rs2, "s2")):
        torch.testing.assert_close(g, r, rtol=F32_STATS_RTOL,
                                   atol=F32_STATS_RTOL * float(r.abs().max()),
                                   msg=lambda m: f"{what} {name}: {m}")
    return float((y - ry).abs().max())


def tf32_tile_of(m, n):
    """The 3xTF32 kernel's plan for an (M, ., N) product (N padded to 4, as the
    wrapper pads it), as its C side reports it, held against its Python copy."""
    from bdvcil_torch.ops import gemm_plan
    from bdvcil_torch.ops.conv1x1_bn import F32_TMA_ALIGN, sm_count

    dev = torch.device("cuda", 0)
    n = -(-n // F32_TMA_ALIGN) * F32_TMA_ALIGN
    p = gemm_plan.tf32_kernel_plan(m, n, dev)
    if p != gemm_plan.tf32_plan(m, n, sm_count(dev)):
        raise AssertionError(f"the 3xTF32 kernel plans {p} at {(m, n)}, its Python copy "
                             f"{gemm_plan.tf32_plan(m, n, sm_count(dev))}")
    return dict(block=[gemm_plan.BLOCK_M, p.block_n], tiles=p.tiles, grid=p.grid,
                stages=p.stages, waves=p.tiles / sm_count(dev))


def tf32_bounds(row, m, k, n):
    """A 3xTF32 row's work as three TF32 products at the tensor cores' rate,
    with the f32 FMA bound of the same product beside it (``ffma_bound_ms``)."""
    row.update(flops=6 * m * k * n, peak_flops=PEAK_TF32_FLOPS,
               ffma_bound_ms=bound_ms(row["bytes"], 2 * m * k * n, PEAK_F32_FLOPS)[0])
    row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], 6 * m * k * n, PEAK_TF32_FLOPS)
    return row


def tf32_conv3x3_tile_of(m, n, w):
    """The 3xTF32 3x3's plan for M pixels of width W and N (padded to 4)
    channels out, as its C side reports it, held against its Python copy."""
    from bdvcil_torch.ops import gemm_plan
    from bdvcil_torch.ops.conv1x1_bn import F32_TMA_ALIGN, sm_count

    dev = torch.device("cuda", 0)
    n = -(-n // F32_TMA_ALIGN) * F32_TMA_ALIGN
    p = gemm_plan.tf32_conv3x3_kernel_plan(m, n, w, dev)
    if p != gemm_plan.tf32_conv3x3_plan(m, n, w, sm_count(dev)):
        raise AssertionError(f"the 3xTF32 3x3 plans {p} at {(m, n, w)}, its Python copy "
                             f"{gemm_plan.tf32_conv3x3_plan(m, n, w, sm_count(dev))}")
    return dict(block=[gemm_plan.BLOCK_M, p.block_n], tiles=p.tiles, grid=p.grid,
                stages=p.stages, boxes=p.boxes, box_rows=p.box_rows, band=p.band,
                waves=p.tiles / sm_count(dev))


def stats_gemm_row(name, conv, gen, dev, mkn, dtype, per_path, path=None):
    """conv1x1_with_stats (``name`` CONV) or gemm_with_stats (GEMM) at (M, K, N)
    in ``dtype`` against the plain version, twice (the same bits), then timed."""
    m, k, n = mkn
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(dtype)
    xin = x.reshape(m, 1, 1, k) if name == CONV else x
    fwd = conv.conv1x1_with_stats_fwd if name == CONV else conv.gemm_with_stats_fwd
    first, again = fwd(xin, w), fwd(xin, w)
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(first, again)):
        raise AssertionError(f"{name} {mkn} {dtype}: a second run differs")
    ref = conv.gemm_stats_plain(x, w)
    got = (first[0].reshape(m, n), *first[1:])
    f32 = dtype == torch.float32
    err = (assert_f32_stats if f32 else assert_stats)(f"{name} {mkn} {dtype}", got, ref)
    row = timed_row(name + "_f32" if f32 else name, mkn, per_path, lambda: fwd(xin, w),
                    lambda: conv.gemm_stats_plain(x, w), lambda: stats_of(torch.matmul(x, w)),
                    (4 if f32 else 2) * (m * k + m * n + k * n) + 8 * n, 2 * m * k * n, err,
                    product=lambda: torch.matmul(x, w),
                    tile=tf32_tile_of(m, n) if f32 else tile_of(m, k, n))
    if f32:
        tf32_bounds(row, m, k, n)
    row["dtype"] = str(dtype).removeprefix("torch.")
    if path is not None:
        row["path"] = path
    del x, w, xin, first, again, ref, got
    return row


def f32_gemm_path(dev, gen, conv):
    """gemm_with_stats in float32, forward and VJP, once at each GEMM_SHAPES
    shape; the VJP against JAX's _bwd rule on the kernel's own y."""
    from bdvcil_torch.ops import _build

    _build.LAUNCHES.clear()
    for m, k, n in GEMM_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        gy = torch.randn((m, n), generator=gen, device=dev)
        gs1 = torch.randn((n,), generator=gen, device=dev)
        gs2 = torch.randn((n,), generator=gen, device=dev) * 1e-3
        xi, wi = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y, s1, s2 = conv.gemm_with_stats(xi, wi)
        torch.autograd.backward([y, s1, s2], [gy, gs1, gs2])
        dy = gy + gs1 + 2.0 * gs2 * y.detach()
        for got, ref, what in ((xi.grad, dy @ w.t(), "dx"), (wi.grad, x.t() @ dy, "dw")):
            torch.testing.assert_close(got, ref, rtol=F32_Y_RTOL,
                                       atol=F32_Y_RTOL * float(ref.abs().max()),
                                       msg=lambda s: f"{GEMM_F32} {what} {(m, k, n)}: {s}")
        del x, w, gy, xi, wi, y, dy
    launches = kernel_launches()
    if launches != {GEMM_F32: len(GEMM_SHAPES)}:
        raise AssertionError(f"f32 gemm path: kernel launches {launches}")
    return launches


def print_row(r):
    """One ``kernel`` line of a timed kernel row."""
    tile = r["tile"]
    path = r.get("path", r.get("bn_path", "path"))
    print(f"kernel {r['kernel']} {r['shape']} x{r['per_path']}/{path}: "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {r['library_ms']} "
          f"({KERNEL_META[r['kernel']][2]}), product {r['product_ms']}, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['ms'] / r['bound_ms']:.2f}x"
          + (f"; f32 FMA bound {r['ffma_bound_ms']:.4f}" if "ffma_bound_ms" in r else "")
          + f"), max_abs_err {r['max_abs_err']}"
          + ("" if tile is None else f", tile {tile['block'][0]}x{tile['block'][1]} "
             f"tiles {tile['tiles']} grid {tile['grid']} waves {tile['waves']:.2f}"),
          flush=True)


def f32_phase(dev, gen, seed, smi, conv, bf16_step_ms):
    """Phase 19: (a) the float32 kernel against its plain version at the R50
    1x1 shapes and at ragged ones, the bf16 core at the ragged ones and, bit
    for bit, at the R50 ones; (b) config A's two steps in float32 under
    pallas_stats against pallas_stats_interpret; (c) train_cil on a config A
    file that names no compute_dtype, for one task."""
    import shutil

    from bdvcil_torch import config_templates as presets
    from bdvcil_torch.cil_tools import train_cil
    from bdvcil_torch.ops import _build

    t_phase = time.perf_counter()
    out, rows = {}, []
    f32, bf16 = torch.float32, torch.bfloat16
    with no_tf32():
        # (a) #3 at a train forward's 12 shapes, #4 at phase 2's 8, both at the ragged ones
        for mkn, per in sorted(r50_shapes()[1].items()):
            rows.append(stats_gemm_row(CONV, conv, gen, dev, mkn, f32, per))
        for mkn in GEMM_SHAPES:
            rows.append(stats_gemm_row(GEMM, conv, gen, dev, mkn, f32, 1))
        for mkn in RAGGED_SHAPES:
            for name in (CONV, GEMM):
                for dtype in (f32, bf16):
                    rows.append(stats_gemm_row(name, conv, gen, dev, mkn, dtype, 0, "ragged"))
        torch.cuda.empty_cache()
        out["gemm_launches"] = f32_gemm_path(dev, gen, conv)
    for r in rows:
        print_row(r)
    sums = {(name, key): sum(r[key] * r["per_path"] for r in rows if r["kernel"] == name
                             and "path" not in r)
            for name in (CONV_F32, GEMM_F32) for key in ("ms", "bound_ms", "ffma_bound_ms")}
    checksums = bf16_core_checksums(dev, conv)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if sms == BF16_CORE_SMS and checksums != BF16_CORE_CHECKSUMS:
        bad = {k: (v, BF16_CORE_CHECKSUMS.get(k)) for k, v in checksums.items()
               if v != BF16_CORE_CHECKSUMS.get(k)}
        raise AssertionError(f"the bf16 core's outputs changed at the R50 shapes: {bad}")
    out.update(checksums=checksums, checksums_held=sms == BF16_CORE_SMS)
    print(f"f32 (a): the 3xTF32 kernel: {CONV_F32} over a train forward (12 shapes, 32 "
          f"launches) {sums[CONV_F32, 'ms']:.4f} ms (3xTF32 bound "
          f"{sums[CONV_F32, 'bound_ms']:.4f}, f32 FMA bound {sums[CONV_F32, 'ffma_bound_ms']:.4f}),"
          f" {GEMM_F32} over phase 2's 8 shapes {sums[GEMM_F32, 'ms']:.4f} ms (bounds "
          f"{sums[GEMM_F32, 'bound_ms']:.4f}, {sums[GEMM_F32, 'ffma_bound_ms']:.4f}); both within y rtol "
          f"{F32_Y_RTOL}, atol {F32_Y_ATOL} of max |y|, statistics rtol {F32_STATS_RTOL} of the "
          f"plain version (TF32 off) at the R50 and ragged shapes, bf16 within one ulp at the "
          f"ragged ones; f32 gemm path launches {out['gemm_launches']}; the bf16 core's "
          + (f"outputs at the 12 R50 shapes equal the recorded ones bit for bit" if
             out["checksums_held"] else f"checksums not held ({sms} SMs, recorded at "
                                        f"{BF16_CORE_SMS})") + f" [{smi}]", flush=True)

    # (b) two steps of config A in float32, the kernel against the plain GEMM
    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {mode: dist_steps("A", dev, seed, f32, dict(presets.SWITCHES["A"],
                                                             conv1x1_mode=mode))
                for mode in ("pallas_stats", "pallas_stats_interpret")}
    finally:
        torch.use_deterministic_algorithms(deterministic[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic[1:]
    kern, plain = runs["pallas_stats"], runs["pallas_stats_interpret"]
    # the 21 module BatchNorms on their kernels in both modes; the 32 that
    # normalize the GEMM's sums too under 'pallas_stats', on the plain
    # versions under 'pallas_stats_interpret'
    want_k = {CONV_F32: 32, **bn_launches(1, sums=32, dtype=f32)}
    want_p = bn_launches(1, R50_BNS - 32, dtype=f32)
    for rk, rp in zip(kern["records"], plain["records"]):
        if rk["launches"] != want_k or rp["launches"] != want_p:
            raise AssertionError(f"f32 (b): launches {rk['launches']} (pallas_stats), "
                                 f"{rp['launches']} (interpret); expected {want_k}, {want_p} a "
                                 f"step")
        _close("f32 (b) loss, pallas_stats vs interpret", rk["loss"], rp["loss"], F32_LOSS_RTOL)
    running = [k for k in plain["state"] if "running" in k]
    gaps = {}
    for key in running:
        g, r = kern["state"][key], plain["state"][key]
        torch.testing.assert_close(g, r, rtol=F32_RUNNING_RTOL, atol=F32_RUNNING_ATOL,
                                   msg=lambda m: f"f32 (b) {key}: {m}")
        gaps[key] = float((g - r).abs().max())
    out["steps"] = dict(losses=[(rk["loss"], rp["loss"]) for rk, rp in
                                zip(kern["records"], plain["records"])],
                        launches=sum(r["launches"][CONV_F32] for r in kern["records"]),
                        running_max_abs_gap=max(gaps.values()), running_stats=len(running),
                        ms=[r["ms"] for r in kern["records"]],
                        interpret_ms=[r["ms"] for r in plain["records"]])
    print(f"f32 (b): config A at 16 x 8 x 224² in float32, task-0 step then task-1 KD step, "
          f"pallas_stats against pallas_stats_interpret (deterministic algorithms, TF32 off): "
          f"losses " + ", ".join(f"{a:.6f} / {b:.6f}" for a, b in out["steps"]["losses"])
          + f" (rtol {F32_LOSS_RTOL}); {len(running)} running statistics within rtol "
          f"{F32_RUNNING_RTOL}, atol {F32_RUNNING_ATOL} (max abs gap "
          f"{out['steps']['running_max_abs_gap']:.3g}); {CONV_F32} 32 launches a step, the "
          f"bf16 core none; step ms (host clock) f32 {kern['records'][0]['ms']:.2f} / "
          f"{kern['records'][1]['ms']:.2f} (interpret {plain['records'][0]['ms']:.2f} / "
          f"{plain['records'][1]['ms']:.2f}) against config A's bf16 step "
          f"{bf16_step_ms[0]:.2f} / {bf16_step_ms[1]:.2f} (phase 4) [{smi}]", flush=True)
    del runs, kern, plain
    torch.cuda.empty_cache()

    # (c) train_cil on a config that names no compute_dtype: the trainer's float32
    root = pathlib.Path("chiprun_out/f32_cil_corpus").resolve()
    shutil.rmtree(root, ignore_errors=True)
    try:
        write_cil_corpus(root, seed)
        config = cil_config_file(root, CIL_SPLITS[:1], presets.SWITCHES["A"], None)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        trainer = train_cil.main([str(config)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = kernel_launches()
        steps = -(-CIL_TRAIN * len(CIL_SPLITS[0]) // CIL_BATCH)  # 1 epoch, task 0
        want = {CONV_F32: 32 * steps, **bn_launches(steps, sums=32, dtype=f32)}
        if trainer.spec.dtype != f32 or launches != want:
            raise AssertionError(f"f32 (c): dtype {trainer.spec.dtype}, launches {launches}, "
                                 f"expected {want}")
        cnn, nme = trainer.cnn_matrix[0], trainer.nme_matrix[0]
        if not all(math.isfinite(a) and 0 <= a <= 100 for a in cnn + nme):
            raise AssertionError(f"f32 (c): accuracies {cnn} {nme}")
        out["cil"] = dict(train_s=train_s, launches=launches, cnn=cnn, nme=nme,
                          stats=trainer.task_stats[0])
        print(f"f32 (c): train_cil on a config A file without compute_dtype (the trainer's "
              f"float32), task 0 at phase 10's cut: {train_s:.2f} s, CNN {cnn} NME {nme}, "
              f"{CONV_F32} {launches[CONV_F32]} launches (= 32 x {steps} train steps) [{smi}]",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {CONV_F32: out["steps"]["launches"] + out["cil"]["launches"][CONV_F32],
                       **out["gemm_launches"]}
    out["rows"] = rows
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"f32 phase {out['phase_s']:.1f} s [{smi}]", flush=True)
    torch.cuda.empty_cache()
    return out


# --- phase 20: the block probe at every dtype and shape the JAX ops take -------------

# the float32 block against its plain composition and the library block (TF32
# off): every output within 1e-4 + 1e-4 x (|ref| + |x| + |b3|), and (mean, var)
# rtol 1e-4, atol 1e-5 (f32 sums in another order, through three BatchNorms)
F32_BLOCK_TOL, F32_BLOCK_STATS_RTOL, F32_BLOCK_STATS_ATOL = 1e-4, 1e-4, 1e-5
F32_BLOCK_ITERS = 10
# bf16 at the JAX tests' geometries, (NT, H = W, C, Cm) (tests/test_block_fused.py)
JAX_TEST_BLOCKS = [(8, 14, 64, 16), (6, 7, 32, 8)]
# #7 and #8 past one TMA box of window, (NT, W = H, Cin, Cout): W = 64 is
# layer1 at a 256² input (the bench's --hw 64), W = 112 a 448² one
WIDE_3X3 = [(NT, 64, 64, 64), (8, 112, 64, 64)]
# channel counts the wrapper zero-pads to multiples of 8: (NT, H = W, Cin, Cout)
PADDED_3X3 = (16, 14, 12, 20)
# The bf16 core's (y, s1, s2) of #7 at the four R50 conv3 shapes and of #8 at
# the four R50 3x3 shapes, on hashed operands (``block_core_checksums``), as
# the kernels computed them before they took any channel count and width
# (commit 8aeb367), on an H100 SXM (132 SMs)
BLOCK_CORE_CHECKSUMS = {
    "conv1x1_affine_relu_stats 401408x64x256": "7987134a7c3326af",
    "conv1x1_affine_relu_stats 100352x128x512": "b29503f3b450b024",
    "conv1x1_affine_relu_stats 25088x256x1024": "0d072e81b66c2973",
    "conv1x1_affine_relu_stats 6272x512x2048": "c4cc046ed3d7ddab",
    "conv3x3_affine_relu_stats 128x56x56x64x64": "1e9bed853c7f63be",
    "conv3x3_affine_relu_stats 128x28x28x128x128": "88512a1abe0c1c47",
    "conv3x3_affine_relu_stats 128x14x14x256x256": "7f80f070cb944fa8",
    "conv3x3_affine_relu_stats 128x7x7x512x512": "1f15ca163a78a0bd",
}


def block_core_checksums(dev, bf):
    """``checksum`` of the bf16 #7's and #8's (y, s1, s2) at the R50 shapes of
    ``gemm_plan`` on ``hashed`` operands (a in [0.5, 1.5), b in [0, 0.5))."""
    from bdvcil_torch.ops import gemm_plan

    bf16, out = torch.bfloat16, {}
    for m, k, n in gemm_plan.R50_1X1_AFFINE_SHAPES:
        x = hashed((m, k), 3, dev).to(bf16)
        a, b = hashed((k,), 4, dev) * 0.5 + 1.0, hashed((k,), 5, dev) * 0.25 + 0.25
        w = (hashed((k, n), 6, dev) * 2.0 ** -4).to(bf16)
        out[f"{CONV3} {m}x{k}x{n}"] = checksum(*bf.conv1x1_affine_relu_stats(x, a, b, w))
    for nt, h, w_, c, n in gemm_plan.R50_3X3_SHAPES:
        x = hashed((nt, h, w_, c), 7, dev).to(bf16)
        a, b = hashed((c,), 8, dev) * 0.5 + 1.0, hashed((c,), 9, dev) * 0.25 + 0.25
        w = (hashed((3, 3, c, n), 10, dev) * 2.0 ** -5).to(bf16)
        out[f"{CONV2} {nt}x{h}x{w_}x{c}x{n}"] = checksum(
            *bf.conv3x3_affine_relu_stats(x, a, b, w))
    del x, w
    torch.cuda.empty_cache()
    return out


# The 3xTF32 kernel's (y, s1, s2) of #6, #7 and #8 f32 at the four R50 block
# shapes on hashed operands (``f32_core_checksums``), as it computed them before
# its 3x3 window plan became the one it shares with the bf16 3x3 (commit
# a37a2ba), on an H100 SXM (132 SMs)
F32_CORE_CHECKSUMS = {
    "block_conv1x1_stats_f32 128x56x56x256/64": "980c08945639c254",
    "conv1x1_affine_relu_stats_f32 128x56x56x256/64": "d120ca9f7319ace2",
    "conv3x3_affine_relu_stats_f32 128x56x56x256/64": "2cd9c3264b302ceb",
    "block_conv1x1_stats_f32 128x28x28x512/128": "af68ac2fd2633e1c",
    "conv1x1_affine_relu_stats_f32 128x28x28x512/128": "8c39385ed817b3b9",
    "conv3x3_affine_relu_stats_f32 128x28x28x512/128": "989450864b8e4fa3",
    "block_conv1x1_stats_f32 128x14x14x1024/256": "fff7aeb4b4c2f7c9",
    "conv1x1_affine_relu_stats_f32 128x14x14x1024/256": "66a9bc898f33b718",
    "conv3x3_affine_relu_stats_f32 128x14x14x1024/256": "8f198b421d4a26f3",
    "block_conv1x1_stats_f32 128x7x7x2048/512": "d4594a4801874897",
    "conv1x1_affine_relu_stats_f32 128x7x7x2048/512": "187162b236c66e7c",
    "conv3x3_affine_relu_stats_f32 128x7x7x2048/512": "97eaf0f0e728db16",
}


def f32_core_checksums(dev, bf):
    """``checksum`` of the float32 #6 (C -> Cm), #7 (Cm -> C, the prologue)
    and #8 (Cm -> Cm) at each stride-1 R50 width (128 frames) on ``hashed``
    operands (a in [0.5, 1.5), b in [0, 0.5))."""
    out = {}
    for hw, c, cm in BLOCKS:
        x = hashed((NT, hw, hw, c), 11, dev)
        y = hashed((NT, hw, hw, cm), 12, dev)
        a, b = hashed((cm,), 13, dev) * 0.5 + 1.0, hashed((cm,), 14, dev) * 0.25 + 0.25
        w1 = hashed((c, cm), 15, dev) * c ** -0.5
        w2 = hashed((3, 3, cm, cm), 16, dev) * (9 * cm) ** -0.5
        w3 = hashed((cm, c), 17, dev) * cm ** -0.5
        key = f"{NT}x{hw}x{hw}x{c}/{cm}"
        out[f"{CONV1_F32} {key}"] = checksum(*bf.conv1x1_stats(x, w1))
        out[f"{CONV3_F32} {key}"] = checksum(*bf.conv1x1_affine_relu_stats(y, a, b, w3))
        out[f"{CONV2_F32} {key}"] = checksum(*bf.conv3x3_affine_relu_stats(y, a, b, w2))
        del x, y, w1, w2, w3
    torch.cuda.empty_cache()
    return out


def f32_block_rows(dev, gen, hw, c, cm, per, bf, conv):
    """#6, #7, #8 (both variant names) and #9b in float32 at one stride-1 width
    (128 frames) against their plain versions, then timed; ``per`` weighs the
    row into the kernels line (1 at layer1)."""
    x, y, a, b, w1, w2, w3 = block_operands(dev, gen, NT, hw, c, cm, torch.float32)
    m = NT * hw * hw
    w2_lib = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    y_nchw = y.permute(0, 3, 1, 2)  # channels_last view, no copy
    cases = [
        (CONV1_F32, (m, c, cm), lambda: bf.conv1x1_stats(x, w1),
         lambda: conv.gemm_stats_plain(x, w1), lambda: stats_of(torch.matmul(x, w1)),
         lambda: torch.matmul(x, w1), 4 * (m * c + m * cm + c * cm) + 8 * cm, 2 * m * c * cm,
         tf32_tile_of(m, cm)),
        (CONV3_F32, (m, cm, c), lambda: bf.conv1x1_affine_relu_stats(y, a, b, w3),
         lambda: bf.conv1x1_affine_relu_stats_plain(y, a, b, w3),
         lambda: stats_of(torch.matmul(y, w3)), lambda: torch.matmul(y, w3),
         4 * (m * cm + m * c + cm * c) + 8 * cm + 8 * c, 2 * m * cm * c, tf32_tile_of(m, c)),
    ] + [
        (CONV2_F32, (NT, hw, hw, cm, cm, variant),
         lambda v=variant: bf.conv3x3_affine_relu_stats(y, a, b, w2, variant=v),
         lambda v=variant: bf.conv3x3_affine_relu_stats_plain(y, a, b, w2, variant=v),
         lambda: stats_of(F.conv2d(y_nchw, w2_lib, padding=1).permute(0, 2, 3, 1)),
         lambda: F.conv2d(y_nchw, w2_lib, padding=1),
         4 * (2 * m * cm + 9 * cm * cm) + 16 * cm, 2 * m * 9 * cm * cm,
         tf32_conv3x3_tile_of(m, cm, hw))
        for variant in bf.VARIANTS
    ]
    # (M, K, N) of each product, for its three TF32 products' bound
    products = {CONV1_F32: (m, c, cm), CONV3_F32: (m, cm, c), CONV2_F32: (m, 9 * cm, cm)}
    rows = []
    for name, shape, fn, plain, library, product, nbytes, flops, tile in cases:
        first = same_twice(f"{name} {shape}", fn)
        err = assert_f32_stats(f"{name} {shape}", first, plain())
        weight = per if shape[-1] != "im2col" else 0  # one kernel: count its time once
        row = dict(timed_row(name, shape, weight, fn, plain, library, nbytes, flops, err,
                             product=product, tile=tile, peak=PEAK_F32_FLOPS), dtype="float32")
        rows.append(tf32_bounds(row, *products[name]))
        del first
    del y, w1, w2, w3, w2_lib, y_nchw
    y3 = torch.randn(x.shape, generator=gen, device=dev) * 3
    y3.view(-1, c)[1, :4] = float("nan")
    a3 = torch.rand((c,), generator=gen, device=dev) + 0.5
    b3 = torch.randn((c,), generator=gen, device=dev) * 0.5
    n_bad, err = bits_differ(bf.affine_residual_relu(y3, a3, b3, x),
                             bf.affine_residual_relu_plain(y3, a3, b3, x))
    if n_bad:
        raise AssertionError(f"{EPILOGUE_F32} {tuple(x.shape)}: {n_bad} elements differ from "
                             f"the plain version (max abs err {err})")
    rows.append(dict(timed_row(EPILOGUE_F32, list(x.shape), per,
                               lambda: bf.affine_residual_relu(y3, a3, b3, x),
                               lambda: bf.affine_residual_relu_plain(y3, a3, b3, x), None,
                               3 * m * c * 4 + 2 * c * 4, 4 * m * c, err, peak=PEAK_F32_FLOPS),
                     dtype="float32"))
    del x, y3
    torch.cuda.empty_cache()
    return rows


# #8 f32 where the R50 widths do not go, (NT, H, W, Cin, Cout): a window in two
# boxes (W = 112), three bands (W = 200), Cin off 32 (12) and off 4 (3: padded)
F32_WIDE_3X3 = [(8, 112, 112, 64, 64), (2, 20, 200, 32, 72), (16, 14, 14, 12, 20),
                (4, 9, 9, 3, 5)]
# #7 f32 at (M, K, N) off the multiples of 32 and of 4
F32_RAGGED_1X1 = [(4096, 100, 101), (1000, 3, 5), (6272, 36, 20)]


def f32_wide_and_ragged(dev, gen, bf):
    """#8 f32 at wide images and ragged channels (both variant names) and #7
    f32 at ragged K and N against their plain versions (the F32_* gates, a
    second run bit for bit), the 3x3's C plan equal to its Python copy; each
    call counted."""
    from bdvcil_torch.ops import _build

    checks, want = {}, collections.Counter()
    _build.LAUNCHES.clear()
    with torch.no_grad():
        for nt, h, w_, cin, cout in F32_WIDE_3X3:
            y = torch.randn((nt, h, w_, cin), generator=gen, device=dev)
            a = torch.rand((cin,), generator=gen, device=dev) + 0.5
            b = torch.rand((cin,), generator=gen, device=dev) * 0.5 + 0.1
            w2 = torch.randn((3, 3, cin, cout), generator=gen, device=dev) / math.sqrt(9 * cin)
            plan = tf32_conv3x3_tile_of(nt * h * w_, cout, w_)
            for v in bf.VARIANTS:
                what = f"{CONV2_F32} {nt}x{h}x{w_}x{cin}/{cout} {v}"
                got = same_twice(what, lambda v=v: bf.conv3x3_affine_relu_stats(y, a, b, w2,
                                                                                 variant=v))
                ref = bf.conv3x3_affine_relu_stats_plain(y, a, b, w2, variant=v)
                checks[what] = dict(max_abs_err=assert_f32_stats(what, got, ref), plan=plan, w=w_)
                want[CONV2_F32] += 2
            del y, w2
        for m, k, n in F32_RAGGED_1X1:
            x = torch.randn((m, k), generator=gen, device=dev)
            a = torch.rand((k,), generator=gen, device=dev) + 0.5
            b = torch.rand((k,), generator=gen, device=dev) * 0.5 + 0.1
            w3 = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
            what = f"{CONV3_F32} {(m, k, n)}"
            got = same_twice(what, lambda: bf.conv1x1_affine_relu_stats(x, a, b, w3))
            checks[what] = dict(max_abs_err=assert_f32_stats(
                what, got, bf.conv1x1_affine_relu_stats_plain(x, a, b, w3)))
            want[CONV3_F32] += 2
    launches = kernel_launches()
    if launches != dict(want):
        raise AssertionError(f"f32 wide and ragged: kernel launches {launches}, expected "
                             f"{dict(want)}")
    torch.cuda.empty_cache()
    return dict(checks=checks, launches=launches)


def assert_f32_block_close(what, out, ref, terms):
    """Every output finite and within F32_BLOCK_TOL of the terms' size."""
    if out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: {out.dtype}, or not finite")
    n_off, err = off_terms(out, ref, terms, F32_BLOCK_TOL)
    if n_off:
        raise AssertionError(f"{what}: {n_off} of {out.numel()} elements outside "
                             f"{F32_BLOCK_TOL} (max abs err {err})")
    return dict(max_abs_err=err, numel=out.numel())


def f32_block_path(dev, seed, smi, bf):
    """fused_bottleneck_fwd in float32 at the four stride-1 widths (both
    variants at layer1) against its plain composition and the library block,
    with the launches of every run; the chained ms of a layer1 block."""
    from bdvcil_torch import bench_block_fused as bench
    from bdvcil_torch.ops import _build

    checks, blocks, forwards = {}, None, 0
    _build.LAUNCHES.clear()
    with torch.no_grad():
        for hw, c, cm in BLOCKS:
            x, p = bench.block_inputs(NT, hw, c, cm, seed, dev, torch.float32)
            lib, lib_stats = bf.plain_bottleneck_fwd(x, p)
            for variant in bf.VARIANTS if (hw, c, cm) == BLOCKS[0] else ("taps",):
                key = f"{NT}x{hw}x{hw}x{c}/{cm} {variant}"
                out, stats = bf.fused_bottleneck_fwd(x, p, conv3x3_variant=variant)
                forwards += 1
                torch.cuda.synchronize()
                ref, ref_stats = bf.fused_bottleneck_fwd_plain(x, p, conv3x3_variant=variant)
                for want, against in ((ref_stats, "plain"), (lib_stats, "library")):
                    for g, w in zip(stats, want):
                        for u, v in zip(g, w):
                            torch.testing.assert_close(
                                u, v, rtol=F32_BLOCK_STATS_RTOL, atol=F32_BLOCK_STATS_ATOL,
                                msg=lambda m: f"f32 block {key} stats vs {against}: {m}")
                checks[key] = dict(
                    vs_plain=assert_f32_block_close(f"f32 block {key} vs plain composition",
                                                    out, ref, (x, p.b3)),
                    vs_library=assert_f32_block_close(f"f32 block {key} vs library block",
                                                      out, lib, (x, p.b3)))
                del out, stats, ref, ref_stats
            del lib, lib_stats
            if (hw, c, cm) == BLOCKS[0]:
                blocks = bench.time_blocks(x, p, F32_BLOCK_ITERS, dev)
                forwards += 2 * (F32_BLOCK_ITERS + 2)  # two fused schedules, warm-up and chain
            del x, p
            torch.cuda.empty_cache()
    launches = kernel_launches()
    want = {CONV1_F32: forwards, CONV2_F32: forwards, CONV3_F32: forwards,
            FINALIZE: 3 * forwards, EPILOGUE_F32: forwards}
    if launches != want:
        raise AssertionError(f"f32 block path: kernel launches {launches}, expected {want} "
                             f"(no bf16 launch)")
    return dict(checks=checks, launches=launches, iters=F32_BLOCK_ITERS,
                **{f"{k}_ms_per_block": v for k, v in blocks.items()})


def bf16_block_shapes(dev, gen, seed, bf, conv):
    """The bf16 ops where the JAX ops take them and the R50 widths do not go:
    the JAX tests' geometries (the ops and the block), #7 and #8 at W = 64 and
    112, and at Cin 12 (zero-padded by the wrapper); each call counted. Returns
    the checks and the timed #8 row at W = 64."""
    from bdvcil_torch import bench_block_fused as bench
    from bdvcil_torch.ops import _build, gemm_plan

    bf16, rows, checks = torch.bfloat16, [], {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = collections.Counter()
    _build.LAUNCHES.clear()

    def check_op(name, what, fn, plain):
        checks[what] = assert_stats(what, same_twice(what, fn), plain())
        want[name] += 2

    def check_3x3(what, y, a, b, w2):
        nt, h, w_, cin = y.shape
        cin8, cout8 = -(-cin // 8) * 8, -(-w2.shape[-1] // 8) * 8
        plan = gemm_plan.conv3x3_kernel_plan(nt * h * w_, cout8, w_, cin8, dev)
        if plan != gemm_plan.conv3x3_plan(nt * h * w_, cout8, w_, cin8, sms):
            raise AssertionError(f"{what}: the kernel plans {plan}, gemm_plan "
                                 f"{gemm_plan.conv3x3_plan(nt * h * w_, cout8, w_, cin8, sms)}")
        for v in bf.VARIANTS:
            check_op(CONV2, f"{what} {v}",
                     lambda v=v: bf.conv3x3_affine_relu_stats(y, a, b, w2, variant=v),
                     lambda v=v: bf.conv3x3_affine_relu_stats_plain(y, a, b, w2, variant=v))
        return plan

    with torch.no_grad():
        for nt, hw, c, cm in JAX_TEST_BLOCKS:
            key = f"{nt}x{hw}x{hw}x{c}/{cm}"
            x, y, a, b, w1, w2, w3 = block_operands(dev, gen, nt, hw, c, cm, bf16)
            check_op(CONV1, f"{CONV1} {key}", lambda: bf.conv1x1_stats(x, w1),
                     lambda: conv.gemm_stats_plain(x, w1))
            check_op(CONV3, f"{CONV3} {key}", lambda: bf.conv1x1_affine_relu_stats(y, a, b, w3),
                     lambda: bf.conv1x1_affine_relu_stats_plain(y, a, b, w3))
            check_3x3(f"{CONV2} {key}", y, a, b, w2)
            xb, pb = bench.block_inputs(nt, hw, c, cm, seed, dev)
            out, _ = bf.fused_bottleneck_fwd(xb, pb)
            for name in (CONV1, CONV2, CONV3, EPILOGUE):
                want[name] += 1
            want[FINALIZE] += 3
            ref, _ = bf.fused_bottleneck_fwd_plain(xb, pb)
            checks[f"block {key}"] = assert_block_close(f"bf16 block {key} vs plain composition",
                                                        out, ref, (xb, pb.b3))
        plans = {}
        for nt, w_, cin, cout in WIDE_3X3 + [PADDED_3X3]:
            key = f"{nt}x{w_}x{w_}x{cin}/{cout}"
            _, y, a, b, _, _, _ = block_operands(dev, gen, nt, w_, 8, cin, bf16)
            w2 = (torch.randn((3, 3, cin, cout), generator=gen, device=dev)
                  / math.sqrt(9 * cin)).to(bf16)
            w3 = (torch.randn((cin, 4 * cout), generator=gen, device=dev)
                  / math.sqrt(cin)).to(bf16)
            plan = check_3x3(f"{CONV2} {key}", y, a, b, w2)
            plans[key] = plan._asdict()
            check_op(CONV3, f"{CONV3} {key}", lambda: bf.conv1x1_affine_relu_stats(y, a, b, w3),
                     lambda: bf.conv1x1_affine_relu_stats_plain(y, a, b, w3))
            if (nt, w_, cin, cout) == WIDE_3X3[0]:  # timed below, after the launch check
                wide = (key, plan, y, a, b, w2)
            del y, w2, w3
            torch.cuda.empty_cache()
        # #6 at K 13, N 6: padded in both
        x = torch.randn((16, 14, 14, 13), generator=gen, device=dev).to(bf16)
        w1 = (torch.randn((13, 6), generator=gen, device=dev) / math.sqrt(13)).to(bf16)
        check_op(CONV1, f"{CONV1} 16x14x14x13/6", lambda: bf.conv1x1_stats(x, w1),
                 lambda: conv.gemm_stats_plain(x, w1))
    launches = kernel_launches()
    if launches != dict(want):
        raise AssertionError(f"bf16 block shapes: kernel launches {launches}, expected "
                             f"{dict(want)}")
    # the #8 row at W = 64
    key, plan, y, a, b, w2 = wide
    nt, w_, cin, cout = WIDE_3X3[0]
    m = nt * w_ * w_
    y_nchw = y.permute(0, 3, 1, 2)
    w2_lib = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    rows.append(dict(timed_row(
        CONV2, (nt, w_, w_, cin, cout, "taps"), 0,
        lambda: bf.conv3x3_affine_relu_stats(y, a, b, w2),
        lambda: bf.conv3x3_affine_relu_stats_plain(y, a, b, w2),
        lambda: stats_of(F.conv2d(y_nchw, w2_lib, padding=1).permute(0, 2, 3, 1)),
        2 * (m * cin + m * cout + 9 * cin * cout) + 16 * cin, 2 * m * 9 * cin * cout,
        checks[f"{CONV2} {key} taps"], product=lambda: F.conv2d(y_nchw, w2_lib, padding=1),
        tile=dict(block=[128, plan.block_n], tiles=plan.tiles, grid=plan.grid,
                  waves=plan.tiles / sms, stages=plan.stages, boxes=plan.boxes,
                  box_rows=plan.box_rows)), path="wide", dtype="bfloat16"))
    del wide, y, w2, y_nchw, w2_lib
    torch.cuda.empty_cache()
    return dict(checks=checks, plans=plans, launches=launches, rows=rows)


# (f)-(h): the block probe on a 1280 x 720 clip of 8 frames, TSM-R50's four
# stride-1 widths at 180 x 320, 90 x 160, 45 x 80 and 23 x 40, and layer1 of a
# 1920 x 1080 one (270 x 480): (NT, H, W, C, Cm)
HD_BLOCKS = [(8, 180, 320, 256, 64), (8, 90, 160, 512, 128), (8, 45, 80, 1024, 256),
             (8, 23, 40, 2048, 512)]
FHD_BLOCK = (8, 270, 480, 256, 64)
HD_BLOCK_ITERS = 10
# #8 bf16 where its window is three bands, (NT, H, W, Cin, Cout): one column
# past the widest image it once took (272), layer1 at 720p and 1080p, Cin 2048
# one column past its old widest (248), and Cin 2056 (a and b a 64-channel
# slice a window past the 2048 staged in shared memory)
BANDED_3X3 = [(2, 12, 272, 64, 64), (8, 180, 320, 64, 64), (8, 270, 480, 64, 64),
              (1, 5, 248, 2048, 512), (1, 3, 248, 2056, 64)]
# #9b past the 6144 channels a and b take in shared memory (and 6144 itself,
# the widest staged), rows of layer1's 102.8M elements: the pack form at
# 6152 and 8192, the per-element form at 8193
WIDE_TAIL = [6144, 6152, 8192, 8193]
TAIL_ELEMENTS = NT * 56 * 56 * 256


def conv3x3_row(name, bf, y, a, b, w2, err, tile, path, peak=PEAK_BF16_FLOPS):
    """A timed #8 row (bf16 or f32) at y's shape, with F.conv2d + sums and the
    bare convolution beside it (no prologue: less work than the kernel)."""
    nt, h, w_, cin = y.shape
    cout = w2.shape[-1]
    m, esize = nt * h * w_, y.element_size()
    y_nchw = y.permute(0, 3, 1, 2)
    w2_lib = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    row = dict(timed_row(
            name, (nt, h, w_, cin, cout, "taps"), 0,
        lambda: bf.conv3x3_affine_relu_stats(y, a, b, w2),
        lambda: bf.conv3x3_affine_relu_stats_plain(y, a, b, w2),
        lambda: stats_of(F.conv2d(y_nchw, w2_lib, padding=1).permute(0, 2, 3, 1)),
        esize * (m * cin + m * cout + 9 * cin * cout) + 8 * cin + 8 * cout,
        2 * m * 9 * cin * cout, err, product=lambda: F.conv2d(y_nchw, w2_lib, padding=1),
        tile=tile, peak=peak),
        path=path, dtype=str(y.dtype).split(".")[-1])
    return tf32_bounds(row, m, 9 * cin, cout) if y.dtype == torch.float32 else row


def hd_blocks(dev, seed, bf, dtype, blocks):
    """fused_bottleneck_fwd at each (NT, H, W, C, Cm) against its plain
    composition (bf16: assert_block_close; f32: F32_BLOCK_TOL), its statistics
    too; the first block's chained ms. Returns checks, forwards run, chain."""
    from bdvcil_torch import bench_block_fused as bench

    checks, forwards, chain = {}, 0, None
    for nt, h, w_, c, cm in blocks:
        key = f"{nt}x{h}x{w_}x{c}/{cm} {str(dtype).split('.')[-1]}"
        x, p = bench.block_inputs(nt, (h, w_), c, cm, seed, dev, dtype)
        out, stats = bf.fused_bottleneck_fwd(x, p)
        forwards += 1
        torch.cuda.synchronize()
        ref, ref_stats = bf.fused_bottleneck_fwd_plain(x, p)
        rtol, atol = ((F32_BLOCK_STATS_RTOL, F32_BLOCK_STATS_ATOL) if dtype == torch.float32
                      else (1e-3, 1e-4))
        for g, w in zip(stats, ref_stats):
            for u, v in zip(g, w):
                torch.testing.assert_close(u, v, rtol=rtol, atol=atol,
                                           msg=lambda m: f"block {key} stats vs plain: {m}")
        close = assert_f32_block_close if dtype == torch.float32 else assert_block_close
        checks[key] = close(f"block {key} vs plain composition", out, ref, (x, p.b3))
        del out, stats, ref, ref_stats
        if chain is None:
            chain = bench.time_blocks(x, p, HD_BLOCK_ITERS, dev)
            forwards += 2 * (HD_BLOCK_ITERS + 2)  # two fused schedules, warm-up and chain
        del x, p
        torch.cuda.empty_cache()
    return checks, forwards, chain


def hd_phase(dev, gen, seed, smi, bf):
    """Phase 20 (f)-(h): #8 bf16 where its window is three bands and #9b past
    6144 channels against their plain versions; the block on a 720p clip at
    the four stride-1 widths in bf16 and f32 and at 1080p's layer1 in bf16,
    through the kernels only; timed rows at 720p's and 1080p's layer1."""
    from bdvcil_torch.ops import _build, gemm_plan

    t0 = time.perf_counter()
    bf16, rows, checks, want = torch.bfloat16, [], {}, collections.Counter()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _build.LAUNCHES.clear()
    with torch.no_grad():
        for nt, h, w_, cin, cout in BANDED_3X3:  # (f) #8 bf16 in bands
            key = f"{CONV2} {nt}x{h}x{w_}x{cin}/{cout}"
            y = torch.randn((nt, h, w_, cin), generator=gen, device=dev).to(bf16)
            a = torch.rand((cin,), generator=gen, device=dev) + 0.5
            b = torch.rand((cin,), generator=gen, device=dev) * 0.5 + 0.1
            w2 = (torch.randn((3, 3, cin, cout), generator=gen, device=dev)
                  / math.sqrt(9 * cin)).to(bf16)
            plan = gemm_plan.conv3x3_kernel_plan(nt * h * w_, cout, w_, cin, dev)
            want_plan = gemm_plan.conv3x3_plan(nt * h * w_, cout, w_, cin, sms)
            if plan != want_plan or plan.band != 136:
                raise AssertionError(f"{key}: the kernel plans {plan}, gemm_plan {want_plan}")
            got = same_twice(key, lambda: bf.conv3x3_affine_relu_stats(y, a, b, w2))
            err = assert_stats(key, got, bf.conv3x3_affine_relu_stats_plain(y, a, b, w2))
            checks[key] = dict(max_abs_err=err, plan=plan._asdict())
            want[CONV2] += 2
            del got
            if (nt, h, w_, cin, cout) == BANDED_3X3[3]:  # a deep product: chunked sums
                tile = dict(block=[128, plan.block_n], tiles=plan.tiles, grid=plan.grid,
                            waves=plan.tiles / sms, stages=plan.stages, boxes=plan.boxes)
                rows.append(conv3x3_row(CONV2, bf, y, a, b, w2, err, tile, "deep"))
                want[CONV2] += 12
            if (nt, h, w_, cin, cout) in BANDED_3X3[1:3]:  # layer1 at 720p and 1080p: timed
                tile = dict(block=[128, plan.block_n], tiles=plan.tiles, grid=plan.grid,
                            waves=plan.tiles / sms, stages=plan.stages, boxes=plan.boxes,
                            box_rows=plan.box_rows, band=plan.band)
                path = "720p" if (nt, h, w_, cin, cout) == BANDED_3X3[1] else "1080p"
                rows.append(conv3x3_row(CONV2, bf, y, a, b, w2, err, tile, path))
                want[CONV2] += 12  # timed_row's warm-up and reps
            if (nt, h, w_, cin, cout) == BANDED_3X3[1]:  # the same in f32, TF32 off
                with no_tf32():
                    yf, w2f = y.float(), w2.float()
                    keyf = f"{CONV2_F32} {nt}x{h}x{w_}x{cin}/{cout}"
                    got = same_twice(keyf, lambda: bf.conv3x3_affine_relu_stats(yf, a, b, w2f))
                    errf = assert_f32_stats(keyf, got,
                                            bf.conv3x3_affine_relu_stats_plain(yf, a, b, w2f))
                    checks[keyf] = dict(max_abs_err=errf)
                    rows.append(conv3x3_row(CONV2_F32, bf, yf, a, b, w2f, errf,
                                            tf32_conv3x3_tile_of(nt * h * w_, cout, w_), "720p",
                                            peak=PEAK_TF32_FLOPS))
                    want[CONV2_F32] += 14
                    del got, yf, w2f
            del y, w2
            torch.cuda.empty_cache()
        for c in WIDE_TAIL:  # (g) #9b past the shared staging, bit for bit
            for dtype, name in ((bf16, EPILOGUE), (torch.float32, EPILOGUE_F32)):
                shape = (round(TAIL_ELEMENTS / c), c)
                x = torch.randn(shape, generator=gen, device=dev).to(dtype)
                y3 = (torch.randn(shape, generator=gen, device=dev) * 3).to(dtype)
                y3[1, :8] = float("nan")
                a3 = torch.rand((c,), generator=gen, device=dev) + 0.5
                b3 = torch.randn((c,), generator=gen, device=dev) * 0.5
                n_bad, err = bits_differ(bf.affine_residual_relu(y3, a3, b3, x),
                                         bf.affine_residual_relu_plain(y3, a3, b3, x))
                want[name] += 1
                if n_bad:
                    raise AssertionError(f"{name} {shape}: {n_bad} elements differ from the "
                                         f"plain version (max abs err {err})")
                checks[f"{name} {shape}"] = dict(max_abs_err=err)
                if dtype == bf16 or c == 8192:
                    m = shape[0]
                    rows.append(dict(timed_row(
                        name, list(shape), 0, lambda: bf.affine_residual_relu(y3, a3, b3, x),
                        lambda: bf.affine_residual_relu_plain(y3, a3, b3, x), None,
                        3 * m * c * x.element_size() + 2 * c * 4, 4 * m * c, err,
                        peak=PEAK_F32_FLOPS), path="wide tail", dtype=str(dtype).split(".")[-1]))
                    want[name] += 12
                del x, y3
        torch.cuda.empty_cache()
        launches = kernel_launches()
        if launches != dict(want):
            raise AssertionError(f"banded #8 and wide #9b: kernel launches {launches}, "
                                 f"expected {dict(want)}")
        # (h) the block at 720p in both dtypes and at 1080p's layer1 in bf16
        _build.LAUNCHES.clear()
        blocks, forwards = {}, collections.Counter()
        for label, dtype, geoms in (("720p bf16", bf16, HD_BLOCKS),
                                    ("1080p bf16", bf16, [FHD_BLOCK]),
                                    ("720p f32", torch.float32, HD_BLOCKS)):
            with no_tf32():
                found, n, chain = hd_blocks(dev, seed, bf, dtype, geoms)
            checks.update(found)
            forwards[dtype] += n
            blocks[label] = {f"{k}_ms_per_block": v for k, v in chain.items()}
    hd_launches = kernel_launches()
    fb, ff = forwards[bf16], forwards[torch.float32]
    want_blocks = {CONV1: fb, CONV2: fb, CONV3: fb, EPILOGUE: fb, FINALIZE: 3 * (fb + ff),
                   CONV1_F32: ff, CONV2_F32: ff, CONV3_F32: ff, EPILOGUE_F32: ff}
    if hd_launches != want_blocks:
        raise AssertionError(f"720p / 1080p blocks: kernel launches {hd_launches}, expected "
                             f"{want_blocks} (the kernels only, no plain fallback)")
    return dict(checks=checks, launches=launches, block_launches=hd_launches, blocks=blocks,
                iters=HD_BLOCK_ITERS, rows=rows, phase_s=time.perf_counter() - t0)


def block_dtype_phase(dev, gen, seed, smi, bf, conv):
    """Phase 20: the block probe in float32 at the four stride-1 widths, in
    bf16 at the JAX tests' geometries, wide images and padded channels, the
    bf16 core's R50 outputs against recorded checksums, and the timed rows."""
    t_phase = time.perf_counter()
    out, rows = {}, []
    with no_tf32():
        for hw, c, cm in BLOCKS:  # (a) and (d): the f32 kernels at each width, timed
            rows += f32_block_rows(dev, gen, hw, c, cm, 1 if (hw, c, cm) == BLOCKS[0] else 0,
                                   bf, conv)
        out["block"] = f32_block_path(dev, seed, smi, bf)
        out["f32_wide"] = f32_wide_and_ragged(dev, gen, bf)
    blk = out["block"]
    print(f"block dtypes (a): fused_bottleneck_fwd in float32 at the four stride-1 widths "
          f"(128 frames, TF32 off) within {F32_BLOCK_TOL} of the terms against its plain "
          f"composition and the library block (max abs err "
          f"{max(v['vs_plain']['max_abs_err'] for v in blk['checks'].values()):.3g} / "
          f"{max(v['vs_library']['max_abs_err'] for v in blk['checks'].values()):.3g}), "
          f"launches {blk['launches']}; layer1 chained {blk['fused_taps_ms_per_block']:.4f} ms "
          f"a block (im2col {blk['fused_im2col_ms_per_block']:.4f}, library "
          f"{blk['plain_ms_per_block']:.4f}) [{smi}]", flush=True)
    wide = out["f32_wide"]
    print(f"block dtypes (e): #8 f32 at W = 112 and 200 and at Cin 12 and 3, both variant "
          f"names, #7 f32 at ragged K and N, within the f32 gates of the plain versions "
          f"(max abs err {max(v['max_abs_err'] for v in wide['checks'].values()):.3g}), a "
          f"second run bit for bit; 3x3 plans "
          + "; ".join(f"W={v['w']}: {v['plan']['block'][1]} columns, "
                      f"{v['plan']['stages']} stages, {v['plan']['boxes']} x "
                      f"{v['plan']['box_rows']} rows" for k, v in wide["checks"].items()
                      if k.endswith("taps"))
          + f"; launches {wide['launches']} [{smi}]", flush=True)
    out["bf16"] = bf16_block_shapes(dev, gen, seed, bf, conv)
    rows += out["bf16"].pop("rows")
    print(f"block dtypes (b): bf16 #6, #7, #8 and the block at the JAX tests' geometries, "
          f"#7 and #8 at W = 64 and 112 and at Cin 12 within one bf16 ulp of the plain "
          f"versions ({len(out['bf16']['checks'])} checks); 3x3 plans "
          + "; ".join(f"{k}: {v['block_n']} columns, {v['stages']} stages, {v['boxes']} x "
                      f"{v['box_rows']} rows" for k, v in out["bf16"]["plans"].items())
          + f"; launches {out['bf16']['launches']} [{smi}]", flush=True)
    checksums = block_core_checksums(dev, bf)
    f32_checksums = f32_core_checksums(dev, bf)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for sums, recorded, what in ((checksums, BLOCK_CORE_CHECKSUMS, "the bf16 core's #7 / #8"),
                                 (f32_checksums, F32_CORE_CHECKSUMS,
                                  "the 3xTF32 kernel's #6 / #7 / #8")):
        if sms == BF16_CORE_SMS and sums != recorded:
            bad = {k: (v, recorded.get(k)) for k, v in sums.items() if v != recorded.get(k)}
            raise AssertionError(f"{what} outputs changed at the R50 shapes: {bad}")
    out.update(checksums=checksums, f32_checksums=f32_checksums,
               checksums_held=sms == BF16_CORE_SMS)
    print(f"block dtypes (c): the bf16 core's #7 and #8 outputs and the 3xTF32 kernel's #6, "
          f"#7 and #8 at the R50 shapes "
          + ("equal the recorded ones bit for bit" if out["checksums_held"] else
             f"not held ({sms} SMs, recorded at {BF16_CORE_SMS})") + f" [{smi}]", flush=True)
    out["hd"] = hd_phase(dev, gen, seed, smi, bf)
    rows += out["hd"].pop("rows")
    hd = out["hd"]
    print(f"block dtypes (f): #8 bf16 in three bands of 136 rows at "
          + ", ".join(k.split(" ", 1)[1] for k in hd["checks"] if k.startswith(CONV2 + " "))
          + f" within one bf16 ulp of the plain version, the C plan its Python copy's (max abs "
          f"err {max(v['max_abs_err'] for k, v in hd['checks'].items() if k.startswith(CONV2)):.3g}"
          f"); (g) #9b bit for bit at C = {', '.join(map(str, WIDE_TAIL))} in bf16 and f32; "
          f"launches {hd['launches']} [{smi}]", flush=True)
    print(f"block dtypes (h): fused_bottleneck_fwd on a 1280x720 clip of 8 frames at the four "
          f"stride-1 widths in bf16 and f32 (TF32 off) and at 1920x1080's layer1 in bf16, "
          f"against the plain composition (bf16: 2e-2 of the terms but 1e-5 of the outputs, "
          f"f32: {F32_BLOCK_TOL}), the kernels only (launches {hd['block_launches']}); layer1 "
          f"chained ms a block: "
          + "; ".join(f"{k} fused {v['fused_taps_ms_per_block']:.4f}, library "
                      f"{v['plain_ms_per_block']:.4f}" for k, v in hd["blocks"].items())
          + f"; (f)-(h) {hd['phase_s']:.1f} s [{smi}]", flush=True)
    out["launches"] = {k: blk["launches"][k] for k in (CONV1_F32, CONV2_F32, CONV3_F32,
                                                       EPILOGUE_F32)}
    out["rows"] = rows
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"block dtypes phase {out['phase_s']:.1f} s [{smi}]", flush=True)
    torch.cuda.empty_cache()
    return out


def expected_launches(config: str, blocks: int = 16, gemms: int = 32):
    """Per config, over 3 task-0 and 3 task-1 steps: the kernels of the
    config, and train-mode BatchNorm's in the current model (the previous one
    runs in eval mode): one forward and one backward of each of the 3 *
    blocks + 4 + 1 BatchNorms a step, ``gemms`` of them normalizing the
    GEMM's sums in config A (no statistics kernel)."""
    bns = 3 * blocks + 5
    if config == "A":  # conv1/conv3 of every bottleneck, train mode only
        return {CONV: gemms * 6, **bn_launches(6, bns, sums=gemms)}
    bn = bn_launches(6, bns)
    # every block's epilogue: the current model, plus the previous one at task 1
    return {FWD: blocks * 3 + 2 * blocks * 3, BWD: blocks * 6, **bn}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    # phase 12's rank processes: the script starts itself with these
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--dist-dir", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU only", file=sys.stderr)
        return 1
    # cuBLAS's workspace for the loop phase's deterministic resume (set before
    # the first cuBLAS call; the size is PyTorch's default on Hopper)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if args.rank is not None:
        return rank_main(args)
    from bdvcil_torch.ops import _build
    from bdvcil_torch.ops import block_fused as bf
    from bdvcil_torch.ops import conv1x1_bn as conv
    from bdvcil_torch.ops import tsm_shift as tsm

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    from bdvcil_torch.data import native

    t0 = time.perf_counter()
    # the port's JPEG codec (g++) builds while nvcc builds the kernels
    codec = concurrent.futures.ThreadPoolExecutor(1).submit(native.available)
    _build.build_all()
    build_s = time.perf_counter() - t0
    if not codec.result():
        raise AssertionError(f"native decoder unavailable: {native.build_error()}")
    codec_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s (nvcc, sm_90a, one process per source); the JPEG "
          f"codec's host libraries (g++, no libjpeg) built by {codec_s:.2f} s", flush=True)

    wall0 = time.perf_counter()
    fused_shapes, gemm_shapes, shifted = r50_shapes()
    # the pad path's shifted block inputs (bf16), and the shape of
    # tools/check_tpu_kernels.py in f32
    shift_shapes = [(s, torch.bfloat16) for s in sorted(shifted)] + [
        ((64, 28, 28, 512), torch.float32)]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = kernel_phase(dev, gen, fused_paths(), gemm_paths(), tsm, conv)
    torch.cuda.empty_cache()
    rows += kernel_phase_2(dev, gen, shift_shapes, conv, tsm, bf)
    rows += batchnorm_rows(dev, gen)
    for r in rows:
        print_row(r)
    # #1 and #2 over one forward (backward) of each path that runs them
    sums = collections.defaultdict(collections.Counter)
    for r in rows:
        if "path" in r:
            for key in ("ms", "plain_ms", "bound_ms"):
                sums[(r["kernel"], r["path"])][key] += r[key] * r["per_path"]
    for (kname, path), v in sums.items():
        print(f"kernel {kname} over one {path} pass: {v['ms']:.4f} ms, plain "
              f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms", flush=True)
    torch.cuda.empty_cache()

    reference = reference_phase(dev, args.seed)

    trains = {}
    for name in KERNEL_CONFIGS:
        trains[name] = train_phase(name, dev, args.seed, smi)
        want = expected_launches(name, sum(fused_shapes.values()), sum(gemm_shapes.values()))
        got = {k: v for k, v in trains[name]["launches"].items() if v}
        if got != want:
            raise AssertionError(f"config {name}: kernel launches {got}, expected {want}")

    inputs = input_phase(dev, args.seed, smi)
    fed = train_phase("A", dev, args.seed, smi, fed=True)
    got = {k: v for k, v in fed["launches"].items() if v}
    if got != expected_launches("A", gemms=sum(gemm_shapes.values())):
        raise AssertionError(f"config A fed by the input path: kernel launches {got}")
    icarl = icarl_reference_phase(dev, args.seed)

    block = block_path(dev, args.seed, smi)
    gemm_launches = gemm_path(dev, gen)
    shift_launches = shift_path(dev, gen, shift_shapes)
    print(f"gemm path launches {gemm_launches}, shift path launches {shift_launches}",
          flush=True)
    loop = loop_phase(dev, args.seed, smi, sum(gemm_shapes.values()))
    cil = cil_phase(dev, args.seed, smi)
    acm = acm_phase(dev, args.seed, smi)
    dist = distributed_phase(dev, args.seed, smi)
    refck = reference_ckpt_phase(dev, args.seed, smi)
    jpeg = jpeg_phase(dev, args.seed, smi)
    profile = profile_phase(dev, args.seed, smi)
    benches = bench_phase(dev, args.seed, smi)
    studies = study_phase(dev, args.seed, smi)
    graft = graft_phase(dev, args.seed, smi)
    f32 = f32_phase(dev, gen, args.seed, smi, conv,
                    (trains["A"]["task0_step_ms"], trains["A"]["task1_step_ms"]))
    rows += f32["rows"]
    block_dtypes = block_dtype_phase(dev, gen, args.seed, smi, bf, conv)
    for r in block_dtypes["rows"]:
        print_row(r)
    rows += block_dtypes["rows"]

    # the main path is config A in train_epochs fed by the loader: its run gives #3's count
    launches = {**trains["A"]["launches"], **trains["B"]["launches"], **fed["launches"],
                **block["launches"], **gemm_launches, **shift_launches, **loop["launches"]}
    launches.update({k: cil["launches"][k] + acm["launches"][k] for k in (FWD, BWD)})
    launches.update(f32["launches"])
    launches.update(block_dtypes["launches"])
    kernels = []
    for kname, (source, replaces, library_call) in KERNEL_META.items():
        mine = [r for r in rows if r["kernel"] == kname and r.get("path", CIL_PATH) == CIL_PATH]
        per_path = lambda key: sum(r[key] * r["per_path"] for r in mine)  # noqa: E731
        t_bytes = sum(r["bytes"] * r["per_path"] for r in mine) / PEAK_HBM_BYTES * 1e3
        t_ops = sum(r["flops"] * r["per_path"] / r.get("peak_flops", PEAK_BF16_FLOPS)
                    for r in mine) * 1e3
        if not launches.get(kname):
            raise AssertionError(f"{kname}: launched no time on its path")
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname], max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=per_path("ms"), plain_ms=per_path("plain_ms"), bound_ms=per_path("bound_ms"),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None if mine[0]["library_ms"] is None else per_path("library_ms"),
            library_call=library_call,
            product_ms=None if mine[0]["product_ms"] is None else per_path("product_ms"),
        ))
    wall_s = time.perf_counter() - wall0 + max(build_s, codec_s)
    print(f"chip_smoke wall time {wall_s:.1f} s (build included)", flush=True)

    outdir = pathlib.Path("chiprun_out")
    outdir.mkdir(exist_ok=True)
    detail = dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_s, wall_s=wall_s, kernel_rows=rows, reference=reference,
                  train=trains, input=inputs, train_fed=fed, icarl=icarl, block=block,
                  loop=loop, loader_source=loop["loader_source"], cil=cil, acm=acm,
                  distributed=dist, reference_ckpt=refck, jpeg=jpeg, profile_e2e=profile,
                  bench=benches,
                  studies=studies, graft=graft,
                  f32={k: v for k, v in f32.items() if k != "rows"},
                  block_dtypes={k: v for k, v in block_dtypes.items() if k != "rows"},
                  kernels=kernels,
                  note="kernels: ms/plain_ms/bound_ms/library_ms summed over one run of the "
                       "kernel's path at its shapes (rows weighted by per_path): for #1 and #2 "
                       "one forward and one backward of phase 10's batch 8 (its train shapes), "
                       "for #3 a task-0 train forward of batch 16 (its launches from the loop "
                       "phase's train_epochs run), one call per shape for "
                       "gemm_with_stats and temporal_shift (forward and reverse), one layer1 "
                       "block forward for the block kernels; kernel_rows are per launch. "
                       "library_ms: the call that library_call names; for #7 and #8 it leaves "
                       "out the prologue, so it does less work than the kernel. product_ms: "
                       "the bare torch.matmul or F.conv2d of the library yardstick, without "
                       "its sums. tile: the wgmma core's plan (sm90::make_plan, read through "
                       "ops/gemm_plan.py) for #3, #4, #6, #7 and #8. launches of #1 and #2: "
                       "phase 10's whole CIL run (tasks and cil_testing) plus phase 11's "
                       "(the ActorCutMix run, its cil_testing and the tools). The float32 "
                       "kernel of #3, #4 and #6 (3xTF32, phase 19): #3 f32 a task-0 train "
                       "forward of batch 16, its launches phase 19 (b)'s two steps and (c)'s "
                       "task; #4 f32 one call per shape, its launches the f32 gemm path; its "
                       "tile is its own plan (ops/gemm_plan.tf32_kernel_plan), bound_ms at "
                       "three TF32 products on the tensor cores (495 TFLOP/s); kernel_rows' "
                       "ffma_bound_ms is the same product at the f32 FMA rate. The block's "
                       "float32 kernels (phase 20): one layer1 block forward, their launches "
                       "phase 20 (a)'s block runs; #6, #7 and #8 f32 bound at three TF32 "
                       "products (#8: K = 9 Cin), ffma_bound_ms beside it")
    (outdir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def failure_summary(exc: BaseException) -> str:
    """One line for the end of stderr: the phase and line of this script the
    error was raised under, and the error's first and last lines without a C++
    backtrace's ``frame #`` lines (a CUDA or c10d error's backtrace, or a rank's
    log quoted in the error, can fill a log's tail)."""
    import traceback

    mine = [f for f in traceback.extract_tb(exc.__traceback__) if f.name != "<module>"
            and os.path.abspath(f.filename) == os.path.abspath(__file__)]
    where = " > ".join(f"{f.name}:{f.lineno}" for f in mine) or "<module>"
    text = [line.strip() for line in str(exc).splitlines()
            if line.strip() and not line.lstrip().startswith(("frame #", "Exception raised from"))]
    shown = text if len(text) <= 8 else text[:3] + ["..."] + text[-5:]
    return f"chip_smoke failed in {where}: {type(exc).__name__}: {' | '.join(shown)}"


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:
        import traceback

        traceback.print_exc()
        print(failure_summary(exc), file=sys.stderr, flush=True)
        sys.exit(1)
