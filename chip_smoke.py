#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (uaps_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one card

Phases (any failure: exit 1 and no result line):
  1. build: compile every kernel in uaps_tpu_torch/csrc with nvcc for
     sm_90a (one nvcc per source, in parallel); one line of registers and
     spills per tensor-core kernel (csrc/conv3x3_mma.cuh); print the
     card's name and power limit as nvidia-smi reports them;
  2. kernels: hold the conv and pool forward kernels against their plain
     PyTorch versions on the card at every shape of one neu predict batch
     (B=16), in f32 and bf16: conv rtol=atol=1e-4 where the output is f32
     (only the summation order over <= 576 terms differs), 1e-2 for bf16
     output (<= 1 bf16 ulp); the conv also at ODD_CONV (Cin 3 and 40, Cout
     4, 13 and 72, a 37 x 70 image) in f32, bf16 and bf16 -> f32, where the
     bf16 tensor-core forward pads and masks, and a strided (the model's
     OIHW view) against a contiguous bf16 weight, bit for bit; pool
     exactly, with ties, -inf, +inf and NaN;
  3. serving: unet_uaps at the neu preset in bf16 (full width, 256 x 256,
     batch 16) from seeded weights with random BN running stats, saved as
     a .pth and loaded through InferenceEngine.from_torch; 40 images
     through the port server's AsyncBatcher and 2 through its HTTP front
     on 127.0.0.1; masks must equal engine.predict on the same images, and
     every dispatch must launch the conv kernel 9 times and the pool
     kernel 2 times;
  4. end to end against the plain path (the same weights with
     conv_backend="xla"): bf16 masks agree on >= 99.5% of pixels and probs
     to atol 2e-2; f32 masks on >= 99.99% and probs to atol 1e-4;
  5. serving times: each forward kernel and its plain version per shape
     (median of CUDA-event timings: conv with a warm L2, pool also with
     the L2 flushed before each call) and the host's cost per call; predict
     latency, its stages, the forward and its host enqueue, for the kernel
     and the plain engine in alternating rounds (median and range);
     AsyncBatcher imgs/s under a burst of 320 requests; a profiler table of
     3 forwards of each engine (device busy time and idle share);
  6. training kernels: dgrad, wgrad, pool backward and the fused CE+Dice
     forward and backward against their plain versions at every shape of
     one neu baseline step (B=16), f32 and bf16, the wgrad also at
     ODD_WGRAD (Cin 3 and 40, Cout 4 and 13, a 37 x 70 image) and the
     dgrad at ODD_CONV, where the bf16 tensor-core kernels pad and mask
     (tolerances in Smoke.train_kernels); the CE+Dice forward also at
     LOSS_ODD_SHAPES x LOSS_ODD_CLASSES x LOSS_ODD_LAYOUTS (its vector
     path and its scalar path: a ragged H W, an offset view, NHWC
     storage; C 2, 4, 7), each called twice and bit-equal; its ticket
     back at 0 after the calls and two CUDA-graph replays of it
     bit-equal;
  7. training: the supervised baseline as `python -m uaps_tpu_torch.train
     --preset neu --method baseline --dtype bfloat16 --dropout_backend xla
     --dataset synthetic` builds it (unet, full width, 256 x 256, batch
     16, synthetic data): 3 warm-up and 10 timed steps on the kernel path
     with finite losses and, per step, 9 conv, 8 dgrad, 9 wgrad, 2 pool, 2
     pool-backward, 1 CE+Dice forward and 1 backward launches; one step of
     the kernel path and one of the plain path (conv_backend="xla": cuDNN,
     plain pools and losses) from the same weights, batch and dropout
     seed, within bf16 tolerances (Smoke._compare_steps); one eval step;
     the plain path's step time;
  8. training times: per kernel and shape of one bf16 step, the kernel's
     ms, its plain version's, the library call's and the bound; a profile
     of 2 kernel-path steps, whose kernel names must show every weight-
     gradient pass, every conv3x3_nchw forward and dgrad and every
     fused-block forward and dgrad on the tensor cores and none of them on
     the CUDA cores, and each CE+Dice forward as one ce_dice_fwd_kernel
     (no ce_dice_finalize_kernel: 1 a baseline step, 8 a UAPS step)
     (bf16_route; the same route proof in phases 11, 14 and 18);
  9. UAPS kernels: every perturbation kernel (dropout at each level's rate
     and at 0.5, feature noise, feature dropout) forward and backward at
     the 5 skip shapes of a neu UAPS step (B=16), f32 and bf16, equal to
     its plain version bit for bit, the backward regenerating the
     forward's mask; dropout also at a level-0 count plus 1 and plus 7
     elements (the kernel's scalar tail) and on x and g one element past
     their allocations' start (a misaligned pointer: the scalar path),
     forward, backward and the kernel on g, bit for bit; feature noise
     likewise at a level-0 in-example count plus 1 and plus 7 and on the
     offset views (its scalar path), forward and backward; feature
     dropout's attention pass equal to channel_mean, and the feature
     dropout at FDROP_ODD (C 13, 40 and 300: a short last channel group,
     two rounds of groups; 37 x 70 and 16 x 24; B 1-3) and on the offset
     views, forward, backward and the kernel on g; on the card,
     dropout's zero share within 0.01 of p over 16.8 M elements, noise in
     [-r, r) and shared across the batch,
     feature dropout's threshold in [0.7, 0.9] x max; the fused
     uncertainty forward and backward on 4 x [16, 256, 256, 4] f32 NHWC
     views: var and dlogits within rtol = atol = 1e-5, pseudo-labels equal
     on >= 99.99% of pixels, differing only where the two classes' mixes
     agree to 2e-6; the forward also at 2 and 4 decoders over phase 6's
     odd CE+Dice cases, under the same gates;
 10. UAPS training: the faithful step as `python -m uaps_tpu_torch.train
     --preset neu --method uaps --dtype bfloat16 --dataset synthetic`
     builds it (unet_uaps, 16 + 16 images, 256 x 256, fused dropout on): 3
     warm-up and 10 timed steps with finite losses and the launch counts
     of UAPS_STEP_LAUNCHES per step; one step of the kernel path and one
     of the plain path past the ramp (w1 = w2 = 0.1) from the same weights,
     batch, seeds and mix_w (every perturbation on), within the bf16
     tolerances of Smoke._compare_steps, each loss term too; peak memory;
     InferenceEngine.uncertainty on the trained weights;
 11. UAPS times: per new kernel and step shape, ms (L2 flushed), the plain
     version's, the library call's (F.dropout; none for the others) and
     the bound (feature dropout: x read, out and the attention written;
     its backward: g and the attention read, dx written), summed per step
     by launches; a profile of 2 UAPS steps, whose kernel names must show
     phase 8's route and 10 fdrop_att_kernel and 10 + 10
     fdrop_apply_kernel a step (no feature_dropout_max_kernel);
 12. fused-block kernels: chain_conv_plain, chain_conv_bnl (at each level's
     dropout rate) and conv3x3_bnl, forward and backward, at every block
     shape of the chain and fused paths (CHAIN_BLOCKS, B=16), f32 and bf16,
     against their plain versions (tolerances in Smoke.chain_kernels), and
     chain_conv_plain and chain_conv_bnl also at ODD_CHAIN (3 -> 16, 40 ->
     13, 64 -> 32, 72 -> 13 on a 37 x 70 image: y, s1, s2 and the backward;
     plain with both moment cotangents, bnl with both at p = 0.1, with
     s1's alone at p = 0.1 and with none at p = 0); the dropout keep-mask
     bit for bit through a centre-tap identity weight; the route by dtype
     from the profiler's kernel names: 3 chain plain forwards and
     backwards, 3 chain bnl backwards, 3 conv forwards and 3 wgrads launch
     the tensor-core kernels in bf16 (bnl_bwd_mma_kernel for the dgrad with
     the prologue) and only the CUDA-core ones in f32;
 13. the chain and fused UAPS steps (the UAPS slice with
     ModelConfig.conv_backend="chain" / "fused"): 3 warm-up and 10 timed
     steps each with finite losses and CHAIN_STEP_LAUNCHES /
     FUSED_STEP_LAUNCHES per step; one step of each against the plain path
     past the ramp as in phase 10 (the encoder's dropout off at levels 0-1
     for chain, whose hashed mask is not the generator's), the fused
     blocks' conv biases without a gradient; the eval step; predict of the
     chain model against the default model on the trained weights in f32,
     under phase 4's f32 gates;
 14. fused-block times: per kernel and block shape, ms, the plain version's,
     the library composite's (cuDNN F.conv2d; for bnl with the torch
     normalise, leaky and dropout before it; backwards: autograd of the
     composite) and the bound, summed per step by launches; the UAPS step of
     the auto, chain and fused paths in alternating rounds; a profile of 2
     chain steps and of 2 fused steps, each with phase 8's route proof;
 15. the fused pseudo-label kernel against its plain version at the logits
     of each preset's UAPS step (PSEUDO_GEOMS: 4 x [16, 256, 256, 4 / 7 /
     6] and 4 x [12, 256, 512, 2]), f32 and bf16, as NHWC views of NCHW
     tensors: labels equal on >= 99.99% of pixels and, where they differ,
     the plain mix's top two within 2e-6 (phase 9's gate); built exact
     ties go to the lowest class on both sides; the f32 labels against the
     fused uncertainty kernel's under the same gate; ms (L2 flushed), the
     plain version's, the torch composite's (softmax, weighted sum, argmax:
     no single PyTorch call computes it) and the bound; the kernels line's
     max_abs_err is the largest difference of the plain mix between the
     kernel's and the plain version's classes;
 16. (a) the unfused UAPS route: the phase-10 step with
     MethodConfig.fused_uncertainty=False (softmaxes and KL maps as torch
     ops, the pseudo-label kernel): 3 warm-up and 10 timed steps with finite
     losses and UNFUSED_STEP_LAUNCHES per step; one step against the plain
     path past the ramp within phase 10's gates; peak memory; this step and
     the auto step in alternating rounds; a profile of 2 steps;
     (b) the dagm, mtiles and kosdd2 presets as `python -m
     uaps_tpu_torch.train --preset NAME --dataset synthetic --dtype
     bfloat16` builds them (PRESETS: 1 input channel and 7 classes; 6
     classes, lr 2e-3, the unramped uncertainty term; 2 classes at 256 x
     512, batch 12): one step each with finite losses and
     UAPS_STEP_LAUNCHES, one step against the plain path past the ramp
     within phase 10's gates (on a miss the same pair in f32 is reported,
     to tell a kernel fault from bf16 rounding, and the phase fails), one
     eval step (their times, device busy and route come from phase 19's
     graphs of them);
 17. the fullh entries (`conv3x3_nchw_fullh`, its dgrad,
     `conv3x3_nchw_wgrad_fullh`) at every ConvBlock conv shape of levels
     0-1 of a neu UAPS step (FULLH_SHAPES), the stats conv
     (`conv3x3_fast_nchw_stats`: y, s1, s2 and the backward with all three
     cotangents) at the bn_stats blocks' shapes (STATS_SHAPES) and the NHWC
     conv (`conv3x3_small`: y, dx, dW) at [16, 256, 256, 16] -> 16 and
     three odd shapes (5 -> 13 on 37 x 70, 40 -> 8 on 9 x 131, 3 -> 72 on
     37 x 70), f32 and bf16, against their plain versions (phase 12's
     tolerances; max abs and rel errors); fullh's bf16-in, f32-out output
     equal to the bf16 rounding of the default variant's; then per shape
     (bf16, warm L2) ms, the plain version's, the library call's (cuDNN
     F.conv2d, conv2d_input, conv2d_weight; F.conv2d + the two f32 sums and
     autograd of that for the stats conv; the same calls on channels_last
     tensors for the NHWC conv) and the bound;
 18. (a) the neu UAPS step (phase 10's) with ModelConfig.conv_variant=
     "fullh" and bn_backend="flat": 3 warm-up and 10 timed steps with
     finite losses and FULLH_STEP_LAUNCHES per step (20 StatsBatchNorms),
     one step against the plain path (conv_backend="xla", the same
     StatsBatchNorm) past the ramp within phase 10's gates (on a miss the
     same pair in f32 is reported, and the phase fails), this step and the
     auto step in alternating rounds, peak memory, a profile of 2 steps;
     (b) ConvBlock(bn_stats=True) at the neu level-0 and level-1 shapes in
     train mode, forward and backward, against the default ConvBlock with
     the same weights, f32 (tolerances in Smoke._stats_blocks); (c)
     conv3x3_small forward and backward at [16, 256, 256, 16] -> 16, bf16,
     and the route by dtype from the profiler's kernel names: 3 NHWC
     forwards and dgrads launch nhwc_fwd_mma_kernel (the tensor cores) in
     bf16 and conv3x3_nhwc_fwd_kernel (the CUDA cores) in f32;
 19. the steps as CUDA graphs (uaps_tpu_torch/dispatch.py GraphedSteps, K
     = 4 steps a graph): the phase-10 UAPS step and the phase-7 baseline
     step, each sampling its batches on the card from pools of 64 + 256
     synthetic images (data/device_pool.py): the first dispatch (4 eager
     steps on a side stream, then the capture) launches 2 x 4 x
     UAPS_STEP_LAUNCHES / STEP_LAUNCHES through the wrappers; from one
     state (weights, Adam, generator, pool position) 4 eager steps and a
     replay within phase 10's gates (each step's loss terms within 1e-2
     relative, >= 95% of the Adam deltas within lr/2; the largest
     parameter difference printed); the replay's Dirichlet weights equal
     the eager steps', differ from each other and from the next replay's,
     and an eager step between replays draws what the next replay's first
     step draws from the same generator state; a profiled replay (after
     the lead-in) holds 4 x the step's launches of every kernel family
     (bf16_route and GRAPH_FAMILIES), as do 4 eager steps and 4 eager
     steps with a float-lr, non-capturable Adam; at lr 0 a replay leaves
     every parameter equal (the BN buffers move); the CE+Dice ticket at 0;
     graph, eager and non-capturable eager dispatches in alternating
     rounds (ms a step), device busy and idle share of each, a replay on
     the device's clock, peak memory; then Trainer.run with the default
     RunConfig (K = 4 on the card) and device pools, 2 epochs of 8 UAPS
     steps, with finite metrics; then the other paths' steps (GRAPH_PATHS:
     the chain, fused, unfused, fullh + flat-BN steps of phases 13, 16a and
     18 on phase 19's pools, the dagm, mtiles and kosdd2 presets of phase
     16b on pools of GRAPH_PATH_POOLS at their geometry), each as a graph
     of 4 steps: the first dispatch launches 2 x 4 x its per-step launches
     through the wrappers, from one state a replay and 4 eager steps give
     bit-equal metrics, parameters and BN stats, a profiled replay holds 4
     x its launches of every kernel family, and graph and eager
     dispatches are timed in alternating rounds (device busy, idle share,
     peak memory);
 20. the cct, mt, uamt, dct, ucc and cps steps as `python -m
     uaps_tpu_torch.train --preset neu --method M --dtype bfloat16
     --dataset synthetic` builds them (16 + 16 images at 256 x 256 from
     phase 19's pools, default backends, seeded weights; uamt's teacher
     takes T = 8 noised copies as one [128, 256, 256, 3] forward; cps's
     two unet_f nets, net 2 in state.second with its own Adam), each:
     (a) one step on the kernel route and one on the plain route
     (conv_backend="xla") from the same weights, teacher, batch, hooks
     (the teacher's noise, dct's k = 1, ucc's mixed streams) and generator
     seed, past the ramp (w1 = 0.1; uamt's at UAMT_PAIR_CONSISTENCY, so
     that its entropy mask keeps more than a few pixels) and mt's gate,
     within phase 10's gates on METHOD_TERMS (each of cps's nets); (b)
     the kernel step's launches, printed: the kernels launched must be
     METHOD_KERNELS[M], each at least once (cps's exactly
     CPS_STEP_LAUNCHES); the PyTorch convs of an eager step on inputs of
     128 px or more, from the profiler's operator shapes, must all be
     logits heads (no ConvBlock conv at 256 or 128 px on cuDNN); (c) 4
     steps as one dispatch.GraphedSteps graph against 4 eager steps from
     one state (weights, teacher, net 2, every Adam, the generators, pool
     position), cuDNN at its default algorithms: the first dispatch's
     launches 2 x 4 x (b)'s, metrics, params, BN stats, the teacher and
     net 2 bit-equal; a profiled replay holds 4 x (b)'s launches of every
     kernel family (bf16_route, GRAPH_FAMILIES; cps's f32 heads on the
     CUDA-core kernels, F32_HEAD_LAUNCHES); graph and eager dispatches in
     alternating rounds (ms a step), a replay on CUDA events, device busy
     and idle share, peak memory; (d)
     Trainer.run with its defaults and device pools, 1 epoch
     of 8 steps, finite metrics (cps's val2_mdice too) and state.step ==
     counter;
 21. checkpoints, resume, eval and debug_nans (utils/checkpoint.py,
     train.py, eval.py), at the neu geometry, bf16, on pools of
     GRAPH_PATH_POOLS and a val pool of BATCH images: (a) for
     RESUME_METHODS, Trainer.run with its defaults (K = 4, device pools)
     for RESUME_RUN epochs of 8 steps with save_every 1 and
     keep_checkpoints 2, against a run of 1 epoch and a fresh Trainer that
     resumes from its checkpoint and runs epoch 2: every tensor of the run
     (state_tensors:
     parameters, BN buffers, Adam's moments, steps and lr, the counter,
     the generators, the teacher, net 2), the best dice, the schedulers
     and epoch 2's metrics line bit-equal; the resumed UAPS run's launches
     (counted from just before its run to just after) cover every UAPS
     kernel, and a profiled replay of its graph holds 4 x
     UAPS_STEP_LAUNCHES of every kernel family; (b) eval.evaluate on (a)'s
     UAPS run (8 test images at batch 1) through the kernels (the main
     decoder's 9 conv and 2 pool launches an image, counted, and their
     route from the profiler's names: conv_fwd_mma_kernel and
     max_pool_2x2_fwd_kernel), against the same call on the plain route
     (conv_backend="xla") within EVAL_TOL; p50 / p99 latency; once with
     tta=True and the visualisations; (c) debug_nans: a NaN written into
     one conv weight raises FloatingPointError naming that conv's module,
     and halt_on_nan, (a)'s run resumed for a third epoch with a NaN
     weight, names (a)'s last step;
 22. real image files (data/pipeline.py, specs.py, augment.py; OpenCV):
     (a) writes a seeded image set in NEU-Seg's layout under OUT_DIR
     (REAL_NEU: 3630 train and 840 test 200 x 200 RGB JPGs of the
     synthetic defect blobs, PNG masks of classes 0-3; data/synthetic.py
     write_image_set) and a KolektorSDD2-shaped one (REAL_KOSDD2: 64
     portrait PNGs, masks of 0 / 255), timed, and removes both at the
     end; (b) the neu stream alone (DefectDataset.train_iter, 16 + 16
     images a batch): images/s over REAL_STREAM_BATCHES batches after the
     first, with the host's cores (os.sched_getaffinity) and num_workers;
     two datasets of one seed give the same first REAL_SAME_BATCHES
     batches bit for bit; shapes, dtypes and label ranges of neu, ucc_neu
     (train_iter_weak_strong, with the strong view) and kosdd2 (256 x 512
     landscape, labels 0 / 1); (c) a dispatch.GraphedSteps graph of 4
     UAPS steps fed host batches of the stream (no sampler: the pinned
     staging of GraphedSteps._load) against 4 eager steps from one state
     on the same batches: metrics, every module's weights and BN stats
     and Adam's state bit-equal, the first dispatch's launches 2 x 4 x a
     step's, and a profiled replay with 4 x the step's launches of every
     kernel family (bf16_route, GRAPH_FAMILIES); the same for ucc on the
     weak / strong stream (its uimage_strong buffer); (d) `python -m
     uaps_tpu_torch.train --preset neu --method uaps --dtype bfloat16
     --image_root ... --mask_root ... --test_image_root ...
     --test_mask_root ...` (train.main, REAL_TRAINER epochs and steps,
     the default K = 4 graph fed from the host stream): every UAPS kernel
     launched in the run (its counts reset just before and read just
     after), the metrics lines finite, a checkpoint, and each epoch's val
     sweep over the val split's 545 images, its last batch of 1; then the
     same Trainer's graphed dispatches from the host stream against a
     device-pool graph of the same step on synthetic pools, in
     alternating rounds (host clock, ms a step), with the host stages of
     a host-fed dispatch (waiting for the stream's batches, staging and
     replay enqueue), the host time of a round's first dispatch on an
     idle card (waiting, stacking, the pinned fill and the copies, then
     the replay's enqueue), and device busy and idle share from a
     profiled window of dispatches of each; (e) `python -m uaps_tpu_torch.eval` on
     the 840 test images at batch 1 (eval.main): mIoU, mDice, pixel
     accuracy, p50 / p99 latency, and the main decoder's 9 conv and 2
     pool launches an image; (f) `python -m uaps_tpu_torch.serve --images
     DIR --out DIR --ckpt RUN_DIR` on REAL_SERVE_IMAGES test images
     (serve.main): the masks it writes equal InferenceEngine.predict of
     the same decoded batch, images/s; (g) cps with cuDNN's default
     algorithms: two eager steps from one state give the same gradients
     bit for bit (the f32 heads on the port's conv kernels, ROADMAP
     Queue C #5), phase 20's graph of it passed its bit-equal checks
     without cudnn.deterministic, and its graphed ms a step;
 23. export and BaseNet (serve.py `InferenceEngine.export`, artifact.py
     `ExportedEngine`, the kernels' `uaps::` operators of
     kernels/custom_ops.py, models/resnet.py): (a) phase 3's neu unet_uaps
     bf16 engine (its checkpoint) exports its artifact; a fresh python3
     process loads it with torch and the operators' module alone (no port
     model, method, config, data or serve module and no jax in its
     sys.modules) and predicts EXPORT_IMAGES uint8 images: its masks equal
     the live engine's on the same input (the artifact's normalisation)
     bit for bit, probs within EXPORT_PROBS_ATOL, and its launch counters
     read 9 conv and 2 pool launches a batch; the same engine on the CPU
     at batch 1 exports an artifact that runs on the card
     (move_to_device_pass) with 9 conv and 2 pool launches, equal to a
     live engine of batch 1 on the card; (b) the profiler's kernel
     names of one exported predict (after the lead-in): 9
     conv_fwd_mma_kernel, 2 max_pool_2x2_fwd_kernel, no CUDA-core conv,
     and no PyTorch conv on 128 px or more; (c) the EXPORT_ENGINES
     artifacts (unet_uaps --tta, chain, fused, fullh, and BASENET --tta
     from seeded weights with random BN running stats) each against its
     live engine on one batch (masks equal, probs within
     EXPORT_PROBS_ATOL), their launches equal to the live forward's
     `uaps::` operator calls (a TorchDispatchMode), each path's own
     kernel among them (EXPORT_ROUTES); (d) BASENET's baseline step as
     `python -m uaps_tpu_torch.train --preset neu --method baseline
     --model basenet_resnet50 --dtype bfloat16` builds it: BASENET_EAGER
     eager steps from device pools with finite losses and 1 + 1 CE+Dice
     launches a step, one step against the plain route
     (conv_backend="xla") within phase 7's gates, and a graph of 4 steps
     held to 4 eager steps bit for bit under cudnn.deterministic, its
     route from the profiler's names (_graph_bitwise), then Trainer.run
     with its defaults and device pools, 1 epoch of 8 steps; (e) times: the
     exported against the live predict of a batch of 16 in EXPORT_ROUNDS
     alternating rounds, BASENET's TTA predict, and its graphed step with
     cuDNN's default algorithms and peak memory, each printed with the
     card's name and power limit.
Before phase 1 it prints which image decoders import (cv2, PIL,
torchvision.io; report["versions"]["image_decoders"]). It then prints
{"kernels": [...]} (launches from phase 7 for the baseline
kernels, from phase 10 for the UAPS kernels, from phase 13 for the
fused-block kernels, from phase 16a for the pseudo-label kernel and from
phase 18's runs for the fullh, stats and NHWC kernels) and, last, {"ok":
true, "device": ...}. Details go to OUT_DIR/chip_smoke.json.
It exits non-zero without CUDA, and outside the repository.
"""
from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
SEED = 1234
BATCH = 16
HW = 256

# one neu predict batch: (module, Cin, Cout, H=W) of the 9 kernel convs
CONV_SHAPES = [("in_conv.0", 3, 16, 256), ("in_conv.4", 16, 16, 256),
               ("down1.0", 16, 32, 128), ("down1.4", 32, 32, 128),
               ("up3.0", 64, 32, 128), ("up3.4", 32, 32, 128),
               ("up4.0", 32, 16, 256), ("up4.4", 16, 16, 256),
               ("out_conv", 16, 4, 256)]
# and of the 2 kernel pools: (module, C, H=W of the input)
POOL_SHAPES = [("down1", 16, 256), ("down2", 32, 128)]
CONV_PER_BATCH, POOL_PER_BATCH = len(CONV_SHAPES), len(POOL_SHAPES)
# a baseline train step runs every forward shape, their dgrads but the
# input conv's (the image needs no gradient), every wgrad, both pools each
# way, and the fused CE+Dice forward and backward once, on [B, 256, 256, 4]
DGRAD_SHAPES = CONV_SHAPES[1:]
NUM_CLASSES = 4
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# the fused-ConvBlock kernels' counters (phases 12-14)
CHAIN_COUNTERS = ("chain_conv_plain", "chain_conv_bnl", "chain_conv_plain_bwd",
                  "chain_conv_bnl_bwd", "conv3x3_bnl", "conv3x3_bnl_bwd")
# ... and those of the fullh conv entries, the stats conv and the NHWC conv
# (phases 17-18)
FULLH_COUNTERS = ("conv3x3_nchw_fullh", "conv3x3_nchw_fullh_dgrad",
                  "conv3x3_nchw_wgrad_fullh")
STATS_COUNTERS = ("conv3x3_nchw_stats", "conv3x3_nchw_stats_bwd")
NHWC_COUNTERS = ("conv3x3_nhwc", "conv3x3_nhwc_wgrad")
OTHER_CONV_COUNTERS = FULLH_COUNTERS + STATS_COUNTERS + NHWC_COUNTERS
# kernel launches per baseline step (plain dropout), by launch counter
STEP_LAUNCHES = {"conv3x3_nchw": 9, "conv3x3_nchw_dgrad": 8,
                 "conv3x3_nchw_wgrad": 9, "max_pool_2x2_nchw": 2,
                 "max_pool_2x2_nchw_bwd": 2, "ce_dice_fwd": 1,
                 "ce_dice_bwd": 1, "fused_dropout": 0, "feature_noise": 0,
                 "feature_dropout": 0, "feature_dropout_bwd": 0,
                 "uncertainty_fwd": 0, "uncertainty_bwd": 0,
                 "pseudo_label": 0, **dict.fromkeys(CHAIN_COUNTERS, 0),
                 **dict.fromkeys(OTHER_CONV_COUNTERS, 0)}
# ... and per UAPS step: two forwards (labelled, unlabelled), each the
# encoder (4 kernel convs, 2 pools, 5 dropouts) and 4 decoders (5 kernel
# convs each), 3 x 5 perturbed skips; 4 + 4 CE+Dice; one uncertainty
UAPS_STEP_LAUNCHES = {"conv3x3_nchw": 48, "conv3x3_nchw_dgrad": 46,
                      "conv3x3_nchw_wgrad": 48, "max_pool_2x2_nchw": 4,
                      "max_pool_2x2_nchw_bwd": 4, "ce_dice_fwd": 8,
                      "ce_dice_bwd": 8, "fused_dropout": 40,
                      "feature_noise": 20, "feature_dropout": 10,
                      "feature_dropout_bwd": 10, "uncertainty_fwd": 1,
                      "uncertainty_bwd": 1, "pseudo_label": 0,
                      **dict.fromkeys(CHAIN_COUNTERS, 0),
                      **dict.fromkeys(OTHER_CONV_COUNTERS, 0)}
N_DEC = 4
# the blocks that the fused backends replace in a neu UAPS step (levels 0
# and 1): (block, conv1's Cin, Cout, H = W, dropout rate, forwards per step:
# the encoder's run once and each of the 4 decoders' once per forward, for
# the labelled and the unlabelled batch)
CHAIN_BLOCKS = [("in_conv", 3, 16, 256, 0.05, 2),
                ("down1", 16, 32, 128, 0.1, 2),
                ("up3", 64, 32, 128, 0.0, 8),
                ("up4", 32, 16, 256, 0.0, 8)]
# per UAPS step with conv_backend="chain": every level-0/1 block is two chain
# convs (20 + 20 calls, as many backwards), the heads stay on the conv
# kernel, the encoder's dropout at levels 0-1 moves into the chain prologue
CHAIN_STEP_LAUNCHES = {**UAPS_STEP_LAUNCHES, "conv3x3_nchw": 8,
                       "conv3x3_nchw_dgrad": 8, "conv3x3_nchw_wgrad": 8,
                       "fused_dropout": 32, "chain_conv_plain": 20,
                       "chain_conv_bnl": 20, "chain_conv_plain_bwd": 20,
                       "chain_conv_bnl_bwd": 20}
# ... and with "fused": the dropout-free blocks (up3, up4) run conv1 on the
# conv kernel and conv2 as conv3x3_bnl
FUSED_STEP_LAUNCHES = {**UAPS_STEP_LAUNCHES, "conv3x3_nchw": 32,
                       "conv3x3_nchw_dgrad": 30, "conv3x3_nchw_wgrad": 32,
                       "conv3x3_bnl": 16, "conv3x3_bnl_bwd": 16}
# ... and with MethodConfig.fused_uncertainty=False (phase 16): the
# softmaxes and KL maps as torch ops, the pseudo-label kernel once
UNFUSED_STEP_LAUNCHES = {**UAPS_STEP_LAUNCHES, "uncertainty_fwd": 0,
                         "uncertainty_bwd": 0, "pseudo_label": 1}
# ... and with conv_variant="fullh", bn_backend="flat" (phase 18): every
# ConvBlock conv at levels 0-1 on the fullh entries, the heads (head_variant
# dwmf) on the default ones
FULLH_STEP_LAUNCHES = {**UAPS_STEP_LAUNCHES, "conv3x3_nchw": 8,
                       "conv3x3_nchw_dgrad": 8, "conv3x3_nchw_wgrad": 8,
                       "conv3x3_nchw_fullh": 40,
                       "conv3x3_nchw_fullh_dgrad": 38,
                       "conv3x3_nchw_wgrad_fullh": 40}
# the ConvBlock convs at levels 0-1 of a neu UAPS step: (module(s), Cin,
# Cout, H = W, fullh forwards, dgrads and wgrads a step); the image needs no
# gradient
FULLH_SHAPES = [("in_conv.0", 3, 16, 256, 2, 0, 2),
                ("in_conv.4 + up4.4", 16, 16, 256, 10, 10, 10),
                ("down1.0", 16, 32, 128, 2, 2, 2),
                ("down1.4 + up3.4", 32, 32, 128, 10, 10, 10),
                ("up3.0", 64, 32, 128, 8, 8, 8),
                ("up4.0", 32, 16, 256, 8, 8, 8)]
# the bn_stats ConvBlocks of phase 18 at the neu level-0 and level-1 shapes:
# (block, Cin, Cout, H = W, dropout rate); their 4 convs are phase 17's
# stats shapes
STATS_BLOCKS = [("in_conv", 3, 16, 256, 0.05), ("down1", 16, 32, 128, 0.1)]
STATS_SHAPES = [(blk + ".0", cin, cout, hw) for blk, cin, cout, hw, _ in
                STATS_BLOCKS] + [(blk + ".4", cout, cout, hw) for
                                 blk, _, cout, hw, _ in STATS_BLOCKS]
# the NHWC conv at the neu level-0 shape: (B, H, W, Cin, Cout)
NHWC_SHAPE = (16, 256, 256, 16, 16)
# the presets of phase 16 as the CLI builds them: (batch, H, W, classes,
# input channels); they take the default (auto) UAPS step
PRESETS = {"dagm": (16, 256, 256, 7, 1), "mtiles": (16, 256, 256, 6, 3),
           "kosdd2": (12, 256, 512, 2, 3)}
# phase 15: the pseudo-label kernel at each preset's logits (B, H, W, C)
PSEUDO_GEOMS = {"neu": (BATCH, HW, HW, NUM_CLASSES),
                **{k: v[:4] for k, v in PRESETS.items()}}
# the 5 encoder levels of a neu step: (channels, H = W); the encoder's
# dropout rates by level
LEVELS = [(16, HW), (32, HW // 2), (64, HW // 4), (128, HW // 8),
          (256, HW // 16)]
ENC_DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)
# launches per UAPS step at each level shape: dropout 2 encoder + 2
# perturbation forwards and as many backwards; feature noise 2 + 2;
# feature dropout 2 forwards, 2 backwards
PER_LEVEL = {"fused_dropout": 8, "feature_noise": 4, "feature_dropout": 2,
             "feature_dropout_bwd": 2}
# shapes where the tensor-core wgrad and chain dgrad pad their channel tiles
# and mask their pixel tiles (Cin 3 and 40, Cout 4 and 13, a ragged image),
# checked in f32 and bf16 in phases 6 and 12: (Cin, Cout) at ODD_HW, batch
# ODD_BATCH
ODD_HW, ODD_BATCH = (37, 70), 2
ODD_WGRAD = [(3, 16), (40, 4), (40, 13), (16, 13)]
ODD_CHAIN = [(3, 16), (40, 13), (64, 32), (72, 13)]
# feature dropout's odd cases in phase 9: (B, C, (H, W))
FDROP_ODD = [(1, 13, ODD_HW), (1, 40, ODD_HW), (3, 13, (16, 24)),
             (3, 40, (16, 24)), (2, 300, (16, 24))]
# ... and where the tensor-core forwards pad their K (Cin 3, 40; the dgrad's
# Cout) and N (Cout 4, 13; 72: two groups of 64), checked in phases 2 and 6
ODD_CONV = [(3, 4), (3, 13), (40, 4), (40, 13), (13, 72)]
# the odd cases of the CE+Dice and uncertainty forwards (phases 6 and 9):
# (B, H, W) where H W is a multiple of 4 (the vector path) and where it is
# not (the scalar path), each at the kosdd2, neu and dagm class counts and
# in three layouts: the NHWC view of NCHW storage, that view one element
# past its storage's start (and the labels likewise), and contiguous NHWC
# storage; the uncertainty forward at 2 and 4 decoders
LOSS_ODD_SHAPES = [(3, 32, 48), (3, 37, 53)]
LOSS_ODD_CLASSES = (2, 4, 7)
LOSS_ODD_LAYOUTS = ("nchw", "offset", "nhwc")
UNC_ODD_DECODERS = (2, 4)
# the feature-dropout kernels the route proof counts: the attention pass
# and the apply pass (forward and backward), and the max kernel they
# replaced, which must not run
FDROP_ROUTE = ("fdrop_att_kernel", "fdrop_apply_kernel",
               "feature_dropout_max_kernel")
# the CE+Dice forward's one kernel, and the second pass it replaced, which
# must not run
CE_DICE_ROUTE = ("ce_dice_fwd_kernel", "ce_dice_finalize_kernel")
# the profiler's kernel names that the route proof counts: the tensor-core
# (bf16) weight-gradient pass, chain plain dgrad, conv3x3_nchw forward
# (and its dgrad), fused-block forward, NHWC forward (and its dgrad) and
# fused-block dgrad with the BN prologue, then the CUDA-core ones (f32),
# then FDROP_ROUTE and CE_DICE_ROUTE. No name contains another.
ROUTE_KERNELS = ("wgrad_mma_kernel", "dgrad_mma_kernel",
                 "conv_fwd_mma_kernel", "block_fwd_mma_kernel",
                 "nhwc_fwd_mma_kernel", "bnl_bwd_mma_kernel",
                 "wgrad_partial_kernel",
                 "block_conv_dgrad_kernel", "conv3x3_fwd_kernel",
                 "block_conv_fwd_kernel", "conv3x3_nhwc_fwd_kernel",
                 *FDROP_ROUTE, *CE_DICE_ROUTE)
# the launch counters whose every call runs one weight-gradient pass
WGRAD_PASSES = ("conv3x3_nchw_wgrad", "conv3x3_nchw_wgrad_fullh",
                "chain_conv_plain_bwd", "chain_conv_bnl_bwd",
                "conv3x3_bnl_bwd", "conv3x3_nchw_stats_bwd",
                "conv3x3_nhwc_wgrad")
# ... one conv3x3_nchw.cu forward kernel (the forward, or the dgrad through
# the rotated weight), and one block_conv.cu forward
NCHW_FWD_PASSES = ("conv3x3_nchw", "conv3x3_nchw_dgrad", "conv3x3_nchw_fullh",
                   "conv3x3_nchw_fullh_dgrad")
BLOCK_FWD_PASSES = ("chain_conv_plain", "chain_conv_bnl", "conv3x3_bnl",
                    "conv3x3_nchw_stats")
# chain_conv_plain backwards a chain step without a dgrad: in_conv's first
# conv, whose input is the image, in the labelled and unlabelled forwards
CHAIN_PLAIN_NO_DX = 2
# calls of phase 12's routed backward that one profile counts
ROUTE_CALLS = 3
# kernels launched first in each profile that proves a route (phase 12's
# and the steps' of phases 8, 11, 14 and 18), left uncounted; profiler
# windows a route proof may take (Smoke._profiled)
ROUTE_LEAD_IN = 64
LEAD_IN_TRIES = 3
# phase 19: the steps as CUDA graphs (uaps_tpu_torch/dispatch.py) sampling
# from device pools of GRAPH_POOLS (labelled, unlabelled) synthetic images,
# GRAPH_VAL_POOL validation images for the Trainer's run of GRAPH_TRAINER
# (epochs, iterations an epoch); the graph's kernels that its route proof
# counts beyond ROUTE_KERNELS, each with its launch counter (one kernel a
# launch)
GRAPH_POOLS = (64, 256)
GRAPH_VAL_POOL = 32
GRAPH_TRAINER = (2, 8)
GRAPH_FAMILIES = {"max_pool_2x2_fwd_kernel": "max_pool_2x2_nchw",
                  "max_pool_2x2_bwd_kernel": "max_pool_2x2_nchw_bwd",
                  "ce_dice_bwd_kernel": "ce_dice_bwd",
                  "dropout_kernel": "fused_dropout",
                  "noise_kernel": "feature_noise",
                  "uncertainty_fwd_kernel": "uncertainty_fwd",
                  "uncertainty_bwd_kernel": "uncertainty_bwd",
                  "pseudo_label_kernel": "pseudo_label"}
# ... then the other paths' steps as graphs, each against its eager steps
# bit for bit: (key, label, the Smoke method that makes its config and its
# arguments, per-step launches); the neu paths sample from phase 19's
# pools, the presets from pools of GRAPH_PATH_POOLS at their own geometry
GRAPH_PATHS = (
    ("chain", "chain", ("_uaps_config", {"conv_backend": "chain"}),
     CHAIN_STEP_LAUNCHES),
    ("fused", "fused", ("_uaps_config", {"conv_backend": "fused"}),
     FUSED_STEP_LAUNCHES),
    ("unfused", "unfused UAPS", ("_uaps_config", {}), UNFUSED_STEP_LAUNCHES),
    ("fullh_flat", "fullh + flat-BN",
     ("_uaps_config", {"conv_variant": "fullh", "bn_backend": "flat"}),
     FULLH_STEP_LAUNCHES),
    ("dagm", "dagm", ("_preset_config", "dagm"), UAPS_STEP_LAUNCHES),
    ("mtiles", "mtiles", ("_preset_config", "mtiles"), UAPS_STEP_LAUNCHES),
    ("kosdd2", "kosdd2", ("_preset_config", "kosdd2"), UAPS_STEP_LAUNCHES))
GRAPH_PATH_POOLS = (16, 48)
# the alternating rounds (rounds, dispatches a round and path) that time
# the graph and eager dispatches of each of these paths and of phase 20's
# methods
GRAPH_ROUNDS = (2, 1)
# phase 20: the other methods' steps, each with the kernels its model reaches
# (the plain U-Net's; cct's 4-decoder net adds the perturbation kernels,
# ucc's feature-noise head adds feature noise), the loss terms its kernel
# route is held to the plain route on, and the Trainer's run (epochs,
# iterations an epoch)
METHOD_STEPS = ("cct", "mt", "uamt", "dct", "ucc", "cps")
UNET_KERNELS = ("conv3x3_nchw", "conv3x3_nchw_dgrad", "conv3x3_nchw_wgrad",
                "max_pool_2x2_nchw", "max_pool_2x2_nchw_bwd", "ce_dice_fwd",
                "ce_dice_bwd", "fused_dropout")
METHOD_KERNELS = {"cct": UNET_KERNELS + ("feature_noise", "feature_dropout",
                                         "feature_dropout_bwd"),
                  "mt": UNET_KERNELS, "uamt": UNET_KERNELS,
                  "dct": UNET_KERNELS,
                  "ucc": UNET_KERNELS + ("feature_noise",),
                  "cps": ("conv3x3_nchw", "conv3x3_nchw_dgrad",
                          "conv3x3_nchw_wgrad", "ce_dice_fwd", "ce_dice_bwd",
                          "fused_dropout")}
# cps's launches a step, read from the code: four forwards of unet_f (two a
# net), each 9 kernel convs (the ConvBlocks at 256 and 128 px: in_conv,
# down1, up3, up4, all at NHWC levels of JAX's net, where its Conv3x3 gate
# takes the Pallas conv too; and the f32 dp0 head, a flax nn.Conv in JAX,
# on the port's f32 conv for its deterministic weight gradient), 8 of them
# with a dgrad (not the image's), and 5 encoder dropouts; 2 + 4 CE+Dice;
# no CUDA pool (JAX's pools there are XLA's)
CPS_STEP_LAUNCHES = {"conv3x3_nchw": 36, "conv3x3_nchw_dgrad": 32,
                     "conv3x3_nchw_wgrad": 36, "ce_dice_fwd": 6,
                     "ce_dice_bwd": 6, "fused_dropout": 40}
# ... of which the f32 heads' (their forward, dgrad and wgrad on the CUDA
# cores), by method: what bf16_route counts apart ("f32:" keys of a step's
# launches)
F32_HEAD_LAUNCHES = {"cps": {"f32:conv3x3_nchw": 4,
                             "f32:conv3x3_nchw_dgrad": 4,
                             "f32:conv3x3_nchw_wgrad": 4}}
CONSISTENCY_TERMS = ("loss", "ce_loss", "dice_loss", "consistency_loss")
METHOD_TERMS = {"cct": CONSISTENCY_TERMS, "mt": CONSISTENCY_TERMS,
                "uamt": CONSISTENCY_TERMS + ("mean_uncertainty",),
                "dct": CONSISTENCY_TERMS,
                "ucc": ("loss", "sup_loss", "ps_loss", "ce_loss",
                        "dice_loss"),
                "cps": ("loss", "sup_loss", "labeled_cps_loss",
                        "unlabeled_cps_loss")}
METHOD_TRAINER = (1, 8)
# uamt's pair at consistency1 = 0.4 (w = 0.4 past the ramp): at the preset's
# 0.1 the entropy threshold ln 2 = 0.69 lies far below a random-weight
# teacher's entropy (mean_uncertainty 1.34 of at most ln 4 = 1.39 nats),
# so its mask keeps a few pixels, and the consistency over them moved by
# 1.5% between the routes on the H100 where some straddled the threshold;
# (0.75 + 2.5 * 0.4) ln 2 = 1.21 keeps a few percent (mask_share, printed)
UAMT_PAIR_CONSISTENCY = 0.4
# phase 21: the methods whose resume is held to the uninterrupted run,
# its (epochs, iterations an epoch), and the largest difference of eval's
# mIoU, mDice and pixel accuracy (per-class IoU: twice that) between the
# kernel and the plain route in bf16 (the serving gate's 0.5% of pixels)
RESUME_METHODS = ("uaps", "mt", "cps", "ucc")
RESUME_RUN = (2, 8)
EVAL_TOL = 5e-3
# phase 22: the image sets (train images, test images, (H, W)): NEU-Seg's
# counts (3630 train, 840 test: SURVEY.md) at its 200 x 200, and 64
# KolektorSDD2-shaped portrait images; the stream's timed batches after
# the first, and the images one thread times stage by stage; the batches
# two datasets of one seed must share; the Trainer's run (epochs,
# iterations an epoch); the serve CLI's images; the timing rounds
# (rounds, dispatches a round) and the profiled window's dispatches
REAL_NEU = (3630, 840, (200, 200))
REAL_KOSDD2 = (64, 0, (640, 232))
REAL_STREAM_BATCHES = 20
REAL_STAGE_IMAGES = 64
REAL_SAME_BATCHES = 3
REAL_TRAINER = (2, 20)
REAL_SERVE_IMAGES = 64
REAL_ROUNDS = (2, 12)
REAL_PROFILED = 3
REAL_DIR = os.path.join(OUT_DIR, "real_images")
# the least time the card could take: published H100 SXM peaks
# phase 23: the deployable artifacts and BaseNet. EXPORT_IMAGES uint8
# images through the neu engine's artifact in a fresh process; the other
# engines' artifacts, (key, label, InferenceEngine config keywords, tta),
# each held to its live engine on one batch; the BaseNet trained and
# served; the exported and live predicts in EXPORT_ROUNDS (rounds,
# predicts a round and engine) alternating rounds
EXPORT_IMAGES = 40
EXPORT_DIR = os.path.join(ROOT, "runs", "chip_smoke", "export")
BASENET = "basenet_resnet50"
EXPORT_ENGINES = (
    ("tta", "unet_uaps --tta", {}, True),
    ("chain", "unet_uaps chain", {"conv_backend": "chain"}, False),
    ("fused", "unet_uaps fused", {"conv_backend": "fused"}, False),
    ("fullh", "unet_uaps fullh", {"conv_variant": "fullh"}, False),
    ("basenet", f"{BASENET} --tta", {"name": BASENET}, True))
# the counter each path's artifact must launch at least once
EXPORT_ROUTES = {"tta": "conv3x3_nchw", "chain": "chain_conv_bnl",
                 "fused": "conv3x3_bnl", "fullh": "conv3x3_nchw_fullh"}
EXPORT_ROUNDS = (5, 3)
BASENET_EAGER = 3
# the exported program must equal the live engine on the same input: the
# same kernels and library calls in the same order
EXPORT_PROBS_ATOL = 1e-6
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


def log(*a):
    print(*a, flush=True)


def counters():
    """{kernel name: launch count} of every wrapper."""
    from uaps_tpu_torch.kernels import block_conv as kbc
    from uaps_tpu_torch.kernels import ce_dice as kce
    from uaps_tpu_torch.kernels import conv3x3 as kn
    from uaps_tpu_torch.kernels import conv3x3_nchw as kc
    from uaps_tpu_torch.kernels import conv_bnl as kbnl
    from uaps_tpu_torch.kernels import perturb as kpt
    from uaps_tpu_torch.kernels import pool_nchw as kp
    from uaps_tpu_torch.kernels import pseudo_label as kpl
    from uaps_tpu_torch.kernels import uncertainty as kun
    return {"chain_conv_plain": kbc.plain_launches,
            "chain_conv_bnl": kbc.bnl_launches,
            "chain_conv_plain_bwd": kbc.plain_bwd_launches,
            "chain_conv_bnl_bwd": kbc.bnl_bwd_launches,
            "conv3x3_bnl": kbnl.fwd_launches,
            "conv3x3_bnl_bwd": kbnl.bwd_launches,
            "conv3x3_nchw": kc.launches,
            "conv3x3_nchw_dgrad": kc.dgrad_launches,
            "conv3x3_nchw_wgrad": kc.wgrad_launches,
            "max_pool_2x2_nchw": kp.launches,
            "max_pool_2x2_nchw_bwd": kp.bwd_launches,
            "ce_dice_fwd": kce.fwd_launches, "ce_dice_bwd": kce.bwd_launches,
            "fused_dropout": kpt.dropout_launches,
            "feature_noise": kpt.noise_launches,
            "feature_dropout": kpt.fdrop_launches,
            "feature_dropout_bwd": kpt.fdrop_bwd_launches,
            "uncertainty_fwd": kun.fwd_launches,
            "uncertainty_bwd": kun.bwd_launches,
            "pseudo_label": kpl.launches,
            "conv3x3_nchw_fullh": kc.fullh_launches,
            "conv3x3_nchw_fullh_dgrad": kc.fullh_dgrad_launches,
            "conv3x3_nchw_wgrad_fullh": kc.fullh_wgrad_launches,
            "conv3x3_nchw_stats": kc.stats_launches,
            "conv3x3_nchw_stats_bwd": kc.stats_bwd_launches,
            "conv3x3_nhwc": kn.nhwc_launches,
            "conv3x3_nhwc_wgrad": kn.nhwc_wgrad_launches}


def reset_counters():
    from uaps_tpu_torch.kernels import block_conv as kbc
    from uaps_tpu_torch.kernels import ce_dice as kce
    from uaps_tpu_torch.kernels import conv3x3 as kn
    from uaps_tpu_torch.kernels import conv3x3_nchw as kc
    from uaps_tpu_torch.kernels import conv_bnl as kbnl
    from uaps_tpu_torch.kernels import perturb as kpt
    from uaps_tpu_torch.kernels import pool_nchw as kp
    from uaps_tpu_torch.kernels import pseudo_label as kpl
    from uaps_tpu_torch.kernels import uncertainty as kun
    kbc.plain_launches = kbc.bnl_launches = 0
    kbc.plain_bwd_launches = kbc.bnl_bwd_launches = 0
    kbnl.fwd_launches = kbnl.bwd_launches = 0
    kc.launches = kc.dgrad_launches = kc.wgrad_launches = 0
    kc.fullh_launches = kc.fullh_dgrad_launches = kc.fullh_wgrad_launches = 0
    kc.stats_launches = kc.stats_bwd_launches = 0
    kn.nhwc_launches = kn.nhwc_wgrad_launches = 0
    kp.launches = kp.bwd_launches = 0
    kce.fwd_launches = kce.bwd_launches = 0
    kpt.dropout_launches = kpt.noise_launches = 0
    kpt.fdrop_launches = kpt.fdrop_bwd_launches = 0
    kun.fwd_launches = kun.bwd_launches = 0
    kpl.launches = 0


def bound(nbytes, ops, kind):
    """(ms, "bytes" | "operations"): the larger of moving `nbytes` at the
    HBM rate and doing `ops` at the peak rate of the inputs' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv_cost(cin, cout, hw, in_size, out_size):
    """(bytes, flops) of one 3x3 conv (or its dgrad, or wgrad with an f32
    dW): each input read once, each output written once."""
    px = BATCH * hw * hw
    return (px * cin * in_size + 9 * cin * cout * in_size
            + px * cout * out_size), 2 * px * cin * cout * 9


def lead_in_kernel(name):
    """Whether a profiler entry is a kernel of Smoke._lead_in: its int16
    adds and its spin (ATen's spin_kernel)."""
    return ("add" in name and "short" in name) or "spin_kernel" in name


def device_work(events, cuda):
    """The profiler's entries of work on the card (kernels, copies, memsets)
    past the lead-in: not the GPU-side spans of user annotations
    (record_function ranges such as Optimizer.step), which overlap the
    kernels they enclose and which torch's own table leaves out of its
    totals."""
    return [e for e in events if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and not lead_in_kernel(e.key)]


def route_of(entries):
    """{ROUTE_KERNELS family: launches} from (profiler name, count) pairs."""
    return {fam: sum(n for name, n in entries if fam in name)
            for fam in ROUTE_KERNELS}


def bf16_route(per_step, steps):
    """The ROUTE_KERNELS counts that `steps` bf16 steps launching
    `per_step` must show: every weight-gradient pass, every chain plain
    dgrad, every conv3x3_nchw forward and dgrad, every fused-block forward,
    every NHWC forward and dgrad and every fused-block dgrad with the BN
    prologue (the chain bnl and conv3x3_bnl backwards) on the tensor cores;
    no CUDA-core kernel but the f32 heads' (per_step's "f32:" entries,
    F32_HEAD_LAUNCHES: conv3x3_fwd_kernel a forward or dgrad,
    wgrad_partial_kernel a wgrad); every feature-dropout forward as the
    attention and apply passes, every backward as the apply pass, and the
    replaced max kernel never; every CE+Dice forward as one
    ce_dice_fwd_kernel, and the replaced finalize pass never."""
    plain = per_step["chain_conv_plain_bwd"]
    f32_fwd = (per_step.get("f32:conv3x3_nchw", 0)
               + per_step.get("f32:conv3x3_nchw_dgrad", 0))
    f32_wgrad = per_step.get("f32:conv3x3_nchw_wgrad", 0)
    return {"wgrad_mma_kernel": steps * (sum(per_step[k]
                                             for k in WGRAD_PASSES)
                                         - f32_wgrad),
            "dgrad_mma_kernel": steps * (plain - CHAIN_PLAIN_NO_DX
                                         if plain else 0),
            "conv_fwd_mma_kernel": steps * (sum(per_step[k]
                                                for k in NCHW_FWD_PASSES)
                                            - f32_fwd),
            "block_fwd_mma_kernel": steps * sum(per_step[k]
                                                for k in BLOCK_FWD_PASSES),
            "nhwc_fwd_mma_kernel": steps * per_step["conv3x3_nhwc"],
            "bnl_bwd_mma_kernel": steps * (per_step["chain_conv_bnl_bwd"]
                                           + per_step["conv3x3_bnl_bwd"]),
            "wgrad_partial_kernel": steps * f32_wgrad,
            "block_conv_dgrad_kernel": 0,
            "conv3x3_fwd_kernel": steps * f32_fwd, "block_conv_fwd_kernel": 0,
            "conv3x3_nhwc_fwd_kernel": 0,
            "fdrop_att_kernel": steps * per_step["feature_dropout"],
            "fdrop_apply_kernel": steps * (per_step["feature_dropout"]
                                           + per_step["feature_dropout_bwd"]),
            "feature_dropout_max_kernel": 0,
            "ce_dice_fwd_kernel": steps * per_step["ce_dice_fwd"],
            "ce_dice_finalize_kernel": 0}


def mma_registers(text):
    """One line per tensor-core kernel in nvcc -Xptxas=-v output: its
    template arguments and loaders (from the mangled name), registers and
    spill bytes."""
    import re
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if "_mma_kernel" in m.group(1) else None
            spill = None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            fam = re.search(r"(?:wgrad|dgrad|conv_fwd|block_fwd|nhwc_fwd|"
                            r"bnl_bwd)_mma_kernel",
                            name).group(0)
            args = ",".join(re.findall(r"L[ib](\d+)E", name))
            if re.search(r"Li\d+EfE", name):   # the f32-output forward
                args += ",f32 out"
            loads = "/".join(re.findall(r"(PlainLoad|ProLoad|FoldLoad|"
                                        r"NhwcLoad|DgradArgs)", name))
            out.append(f"{fam}<{args}> {loads}: {m.group(1)} registers, "
                       f"{spill or 0} B spilled")
            name = None
    return out


# the per-pixel loss kernels whose registers phase 1 prints: (kernel, its
# template arguments on the neu step: C = 4; D = 4, C = 4)
LOSS_KERNELS = (("ce_dice_fwd_kernel", "4"), ("uncertainty_fwd_kernel", "4,4"))


def family_registers(text, fam, main_args):
    """One line from nvcc -Xptxas=-v output for the kernel template `fam`:
    the registers and spill bytes of its instantiation `main_args` (e.g.
    "4,4"), and the range over every instantiation, with those that
    spill."""
    import re
    rows, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if fam in m.group(1) else None
            spill = 0
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            args = ",".join(re.findall(r"Li(\d+)E", name))
            rows.append((args, int(m.group(1)), spill))
            name = None
    if not rows:
        return f"{fam}: not in this log"
    main = [r for r in rows if r[0] == main_args]
    head = (f"{fam}<{main_args}>: {main[0][1]} registers, {main[0][2]} B "
            "spilled" if main else f"{fam}<{main_args}>: not found")
    regs = [r[1] for r in rows]
    spills = [f"<{a}> {s} B" for a, _, s in rows if s]
    return (f"{head}; {len(rows)} instantiations, {min(regs)}-{max(regs)} "
            f"registers, spilling: {spills or 'none'}")


def ptxas_summary(text):
    """One line from nvcc -Xptxas=-v output: the kernels' register range and
    every kernel that spills (the whole log is in chip_smoke_build.log)."""
    import re
    regs, spills, name = [], [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and int(m.group(1)) and name:
            spills.append(f"{name} ({m.group(1)} B)")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs.append(int(m.group(1)))
    if not regs:
        return text.strip()[-2000:]
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"spilling: {spills or 'none'}")


class Smoke:
    def __init__(self, torch, dev):
        self.torch = torch
        self.dev = torch.device(dev)
        self.report = {"phases": {}, "kernels": {}, "times": {}}
        self.failures = []

    # ------------------------------------------------------------ helpers
    def phase(self, name, fn):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
            ok = True
        except Exception:  # a failed phase is reported, the rest still run
            traceback.print_exc()
            self.failures.append(name)
            ok = False
        dt = time.perf_counter() - t0
        self.report["phases"][name] = {"ok": ok, "seconds": dt}
        log(f"== phase {name}: {'ok' if ok else 'FAILED'} ({dt:.1f} s)")
        return ok

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def gen(self, seed):
        return self.torch.Generator(device=self.dev).manual_seed(seed)

    def time_ms(self, fn, iters=20, rounds=5, warmup=3, cold=False,
                lead=True):
        """Device time of one fn() call in ms: CUDA events around `iters`
        back-to-back calls, divided by `iters`; the median over `rounds`.
        With `lead`, a ~2.5 ms spin kernel queued first keeps the device
        busy while the host queues the calls, so the host's launch cost
        (tens of µs a call) is not counted; without it, a call
        cheaper on the device than on the host measures the host. With
        `cold`, each of iters * rounds calls is timed alone after a 256 MiB
        write has flushed the 50 MB L2 (with `lead`, then a ~0.5 ms spin,
        which touches no memory: a call of several launches may take the
        host longer to queue than the flush takes the device), and the
        median is taken over those."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        if cold:
            flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                device=self.dev)
            for _ in range(iters * rounds):
                flush.zero_()   # still running when the events are queued
                if lead:
                    torch.cuda._sleep(1_000_000)   # cycles, ~0.5 ms
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            return statistics.median(times)
        for _ in range(rounds):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            if lead:
                torch.cuda._sleep(5_000_000)   # cycles, ~2.5 ms
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / iters)
        return statistics.median(times)

    def host_us(self, fn, n=100, rounds=5):
        """Host time to enqueue one fn() call in µs, with the device idle
        at the start: the median over `rounds` of n back-to-back calls."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(rounds):
            self.sync()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            times.append((time.perf_counter() - t0) / n * 1e6)
        self.sync()
        return statistics.median(times)

    # ------------------------------------------------------------ phase 1
    def build(self):
        from uaps_tpu_torch.kernels import _build
        t0 = time.perf_counter()
        logs = _build.build()
        self.report["build_seconds"] = time.perf_counter() - t0
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
            for name, text in logs.items():
                f.write(f"-- nvcc {name}:\n{text}\n")
        for name, text in logs.items():
            log(f"-- nvcc {name}: {ptxas_summary(text)}")
            for line in mma_registers(text):
                log(f"   tensor cores: {line}")
            for fam, args in LOSS_KERNELS:
                if fam.split("_fwd")[0] in name:
                    line = family_registers(text, fam, args)
                    self.report.setdefault("registers", {})[fam] = line
                    log(f"   {line}")
        log(f"built {_build.sources()} in "
            f"{self.report['build_seconds']:.1f} s")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        self.report["nvidia_smi"] = smi
        log(smi)

    # ------------------------------------------------------------ phase 2
    def _conv_case(self, cin, cout, hw, dtype, out_dtype, batch, seed,
                   hw2=None):
        from uaps_tpu_torch.kernels import conv3x3_nchw as kc
        torch = self.torch
        g = self.gen(seed)
        x = torch.randn((batch, cin, hw, hw2 or hw), generator=g,
                        device=self.dev).to(dtype)
        w = (torch.randn((3, 3, cin, cout), generator=g, device=self.dev)
             / (9 * cin) ** 0.5).to(dtype)
        y = kc.conv3x3_nchw(x, w, out_dtype)
        self.sync()
        ref = kc.conv3x3_nchw_plain(x, w, out_dtype)
        self.sync()
        tol = 1e-4 if out_dtype == torch.float32 else 1e-2
        err = float((y.float() - ref.float()).abs().max())
        ok = (y.shape == ref.shape and y.dtype == out_dtype
              and bool(torch.isfinite(y).all())
              and torch.allclose(y.float(), ref.float(), rtol=tol, atol=tol))
        return ok, err, tol, (x, w)

    def kernels(self):
        import torch.nn.functional as F
        from uaps_tpu_torch.kernels import conv3x3_nchw as kc
        from uaps_tpu_torch.kernels import pool_nchw as kp
        torch = self.torch
        bad = []
        conv_err = 0.0
        for dname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            for i, (mod, cin, cout, hw) in enumerate(CONV_SHAPES):
                out = torch.float32 if mod == "out_conv" else dtype
                ok, err, tol, (x, w) = self._conv_case(
                    cin, cout, hw, dtype, out, BATCH, SEED + i)
                conv_err = max(conv_err, err)
                # for scale: both against an f64 conv of the same inputs
                y64 = F.conv2d(x.double(), w.double().permute(3, 2, 0, 1),
                               padding=1)
                e64 = [float((f(x, w, out).double() - y64).abs().max())
                       for f in (kc.conv3x3_nchw, kc.conv3x3_nchw_plain)]
                log(f"conv {mod:10s} {cin:2d}->{cout:2d} @{hw} {dname}"
                    f"->{str(out)[6:]}: max_abs_err {err:.3e} (tol {tol})"
                    f" {'ok' if ok else 'MISMATCH'}; vs f64: kernel "
                    f"{e64[0]:.3e}, twin {e64[1]:.3e}")
                if not ok:
                    bad.append(f"conv {mod} {dname}")
        # shapes off the neu path that the kernel also takes: an odd Cout
        # (the dagm/mtiles heads), a ragged tile edge and W % 4 != 0
        for cin, cout, h, w in [(16, 7, 128, 128), (5, 13, 37, 70),
                                (3, 32, 9, 131)]:
            for dtype in (torch.float32, torch.bfloat16):
                ok, err, tol, _ = self._conv_case(cin, cout, h, dtype, dtype,
                                                  2, SEED + h, hw2=w)
                log(f"conv extra {cin}->{cout} {h}x{w} {str(dtype)[6:]}: "
                    f"max_abs_err {err:.3e} {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    bad.append(f"conv extra {cin}->{cout} {h}x{w} {dtype}")
        # where the bf16 tensor-core forward pads its K and N and masks a
        # ragged tile, with bf16 and f32 output, and f32 beside them
        for i, (cin, cout) in enumerate(ODD_CONV):
            for dtype, out in ((torch.float32, torch.float32),
                               (torch.bfloat16, torch.bfloat16),
                               (torch.bfloat16, torch.float32)):
                ok, err, tol, _ = self._conv_case(
                    cin, cout, ODD_HW[0], dtype, out, ODD_BATCH, SEED + 60 + i,
                    hw2=ODD_HW[1])
                label = (f"conv odd {cin}->{cout} @{ODD_HW[0]}x{ODD_HW[1]} "
                         f"B={ODD_BATCH} {str(dtype)[6:]}->{str(out)[6:]}")
                log(f"{label}: max_abs_err {err:.3e} (tol {tol}) "
                    f"{'ok' if ok else 'MISMATCH'}")
                if not ok:
                    bad.append(label)
        # the flat entry is the same memory and the same kernel
        g = self.gen(SEED)
        x = torch.randn((2, 16, 128 * 256), generator=g, device=self.dev)
        w = torch.randn((3, 3, 16, 8), generator=g, device=self.dev)
        flat = kc.conv3x3_fast_flat(x, w, (128, 256))
        four = kc.conv3x3_nchw(x.view(2, 16, 128, 256), w)
        if not torch.equal(flat.view_as(four), four):
            bad.append("conv flat entry")
        # the model hands over its OIHW weight as a permuted HWIO view,
        # which the kernel reads through its strides
        w_view = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
        if (w_view.is_contiguous() or not torch.equal(
                kc.conv3x3_nchw(x.view(2, 16, 128, 256), w_view), four)):
            bad.append("conv strided weight view")
        # in bf16 the tensor-core forward stages a strided weight one value
        # a load and a contiguous one 16 bytes a load: the same products
        xb, wb = x.view(2, 16, 128, 256).bfloat16(), w.bfloat16()
        wb_view = wb.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
        if not torch.equal(kc.conv3x3_nchw(xb, wb_view),
                           kc.conv3x3_nchw(xb, wb)):
            bad.append("conv strided weight view bf16")
        self.report["kernels"]["conv3x3_nchw"] = {"max_abs_err": conv_err}

        pool_err = 0.0
        for dname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            for i, (mod, c, hw) in enumerate(POOL_SHAPES):
                g = self.gen(SEED + 50 + i)
                x = torch.round(torch.randn((BATCH, c, hw, hw), generator=g,
                                            device=self.dev) * 2) / 2
                x[0, 0, 0, 0] = float("-inf")          # single -inf
                x[1, 1, 2:4, 4:6] = float("-inf")      # an all -inf window
                x[2, 2, 5, 7] = float("inf")
                x[3, 3, 8, 9] = float("nan")
                x[4, 4, 10:12, 12:14] = float("nan")
                x = x.to(dtype)
                y = kp.max_pool_2x2_nchw(x)
                self.sync()
                ref = kp.max_pool_2x2_nchw_plain(x)
                self.sync()
                same = (y == ref) | (torch.isnan(y) & torch.isnan(ref))
                ok = (y.shape == ref.shape and y.dtype == dtype
                      and bool(same.all())
                      and int(torch.isnan(y).sum()) == 2)
                err = (0.0 if bool(same.all()) else
                       float((y.float() - ref.float())[~same].abs().max()))
                pool_err = max(pool_err, err)
                log(f"pool {mod} {c}x{hw}x{hw} {dname}: exact "
                    f"{'ok' if ok else 'MISMATCH'} (max_abs_err {err})")
                if not ok:
                    bad.append(f"pool {mod} {dname}")
        self.report["kernels"]["max_pool_2x2_nchw"] = {"max_abs_err":
                                                       pool_err}
        if bad:
            raise AssertionError(f"kernel mismatches: {bad}")

    # ------------------------------------------------------------ phase 3
    def _config(self, dtype, **model_kw):
        """The neu preset as `python -m uaps_tpu_torch.server --preset neu
        --method uaps --dtype ...` builds it, with `model_kw` on top."""
        from uaps_tpu_torch.utils.cli import parse_args
        cfg, _ = parse_args(["--preset", "neu", "--method", "uaps",
                             "--dtype", dtype])
        cfg.model = dataclasses.replace(cfg.model, **model_kw)
        return cfg

    def _write_checkpoint(self):
        """Seeded unet_uaps weights with random BN running stats (so eval
        BN is not the identity), saved as the reference's training dict."""
        from uaps_tpu_torch.methods.base import build_model
        from uaps_tpu_torch.models.unet import BatchNorm
        torch = self.torch
        g = torch.Generator().manual_seed(SEED)
        model = build_model(self._config("bfloat16"), "cpu", g)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.running_mean.normal_(0.0, 0.1, generator=g)
                    m.running_var.uniform_(0.5, 1.5, generator=g)
                    m.weight.uniform_(0.8, 1.2, generator=g)
                    m.bias.normal_(0.0, 0.05, generator=g)
        path = os.path.join(ROOT, "runs", "chip_smoke", "model.pth")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"state_dict": model.state_dict()}, path)
        return path

    def serving(self):
        import numpy as np
        from uaps_tpu_torch.kernels import conv3x3_nchw as kc
        from uaps_tpu_torch.kernels import pool_nchw as kp
        from uaps_tpu_torch.serve import InferenceEngine
        from uaps_tpu_torch.server import AsyncBatcher, serve_http
        self.pth = self._write_checkpoint()
        self.engine = InferenceEngine.from_torch(self._config("bfloat16"),
                                                 self.pth, device=self.dev)
        assert self.engine.batch_size == BATCH
        self.images = np.random.default_rng(SEED).integers(
            0, 256, (42, HW, HW, 3), dtype=np.uint8)
        self.engine.predict(self.images[:1])   # first call: kernel loads

        engine = self.engine
        deltas = []

        class Counting:
            """The engine as AsyncBatcher sees it, recording the kernel
            launches of each dispatch."""
            batch_size = engine.batch_size

            def predict(self, images):
                c0, p0 = kc.launches, kp.launches
                out = engine.predict(images)
                deltas.append((kc.launches - c0, kp.launches - p0,
                               len(images)))
                return out

        batcher = AsyncBatcher(Counting(), max_wait_ms=20.0)
        srv = serve_http(batcher, port=0, host="127.0.0.1")
        port = srv.server_address[1]
        try:
            kc.launches = 0
            kp.launches = 0
            futs = [batcher.submit(im) for im in self.images[:40]]
            got = [f.result(timeout=600) for f in futs]
            http = []
            for im in self.images[40:42]:
                buf = io.BytesIO()
                np.save(buf, im)
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
                    method="POST")
                with urllib.request.urlopen(req, timeout=600) as resp:
                    http.append(np.load(io.BytesIO(resp.read())))
            conv_n, pool_n = kc.launches, kp.launches
            stats = batcher.stats()
        finally:
            srv.shutdown()
            srv.server_close()
            batcher.shutdown()
        self.launches = {"conv3x3_nchw": conv_n, "max_pool_2x2_nchw": pool_n}
        log(f"served 40 batcher + 2 HTTP requests in {len(deltas)} "
            f"dispatches {[d[2] for d in deltas]}; launches conv {conv_n}, "
            f"pool {pool_n}; batcher stats {json.dumps(stats)}")
        self.report["serving"] = {"dispatches": deltas, "stats": stats,
                                  "launches": self.launches}
        assert sum(d[2] for d in deltas) == 42, deltas
        assert len(deltas) >= 3, deltas
        for c, p, _ in deltas:
            assert (c, p) == (CONV_PER_BATCH, POOL_PER_BATCH), deltas
        assert conv_n == CONV_PER_BATCH * len(deltas)
        assert pool_n == POOL_PER_BATCH * len(deltas)

        masks, probs = self.engine.predict(self.images)
        ncls = self.engine.cfg.data.num_classes
        assert masks.shape == (42, HW, HW) and masks.dtype == np.int32
        assert probs.shape == (42, HW, HW, ncls)
        assert np.isfinite(probs).all()
        assert np.abs(probs.sum(-1) - 1).max() < 1e-4
        assert masks.min() >= 0 and masks.max() < ncls
        got_m = np.stack([m for m, _ in got])
        got_p = np.stack([p for _, p in got])
        n_diff = int((got_m != masks[:40]).sum())
        p_err = float(np.abs(got_p - probs[:40]).max())
        h_diff = int((np.stack(http) != masks[40:]).sum())
        shares = np.bincount(masks.ravel(), minlength=ncls) / masks.size
        log(f"batcher vs predict: {n_diff} mask pixels differ, probs max "
            f"abs diff {p_err:.3e}; HTTP vs predict: {h_diff} differ; "
            f"class shares {shares}")
        assert n_diff == 0 and h_diff == 0 and p_err <= 1e-5
        self.masks, self.probs = masks, probs

    # ------------------------------------------------------------ phase 4
    def end_to_end(self):
        import numpy as np
        from uaps_tpu_torch.kernels import conv3x3_nchw as kc
        from uaps_tpu_torch.kernels import pool_nchw as kp
        from uaps_tpu_torch.serve import InferenceEngine
        imgs = self.images[:32]
        self.plain = {}
        res = {}
        for dtype, min_agree, atol in (("bfloat16", 0.995, 2e-2),
                                       ("float32", 0.9999, 1e-4)):
            kern = (self.engine if dtype == "bfloat16" else
                    InferenceEngine.from_torch(self._config(dtype),
                                               self.pth, device=self.dev))
            plain = InferenceEngine.from_torch(
                self._config(dtype, conv_backend="xla"), self.pth,
                device=self.dev)
            self.plain[dtype] = plain
            c0, p0 = kc.launches, kp.launches
            pm, pp = plain.predict(imgs)
            assert (kc.launches, kp.launches) == (c0, p0), \
                "the plain path launched a kernel"
            km, kpr = kern.predict(imgs)
            agree = float((km == pm).mean())
            err = float(np.abs(kpr - pp).max())
            res[dtype] = {"mask_agree": agree, "probs_max_abs_diff": err}
            ok = agree >= min_agree and err <= atol
            log(f"e2e {dtype}: kernel vs plain masks agree {agree:.6f} "
                f"(min {min_agree}), probs max abs diff {err:.3e} "
                f"(atol {atol}) {'ok' if ok else 'MISMATCH'}")
            assert ok, res[dtype]
        self.report["end_to_end"] = res

    # ------------------------------------------------------------ phase 5
    def times(self):
        import torch.nn.functional as F
        from uaps_tpu_torch.kernels import conv3x3_nchw as kc
        from uaps_tpu_torch.kernels import pool_nchw as kp
        from uaps_tpu_torch.server import AsyncBatcher
        torch = self.torch
        t = self.report["times"]
        conv_rows, pool_rows = [], []
        for dname, dtype in (("bf16", torch.bfloat16),
                             ("f32", torch.float32)):
            for i, (mod, cin, cout, hw) in enumerate(CONV_SHAPES):
                out = torch.float32 if mod == "out_conv" else dtype
                _, _, _, (x, w) = self._conv_case(cin, cout, hw, dtype, out,
                                                  BATCH, SEED + i)
                w_oihw = w.permute(3, 2, 0, 1).contiguous()
                row = {"module": mod, "cin": cin, "cout": cout, "hw": hw,
                       "dtype": dname,
                       "ms": self.time_ms(
                           lambda: kc.conv3x3_nchw(x, w, out)),
                       "plain_ms": self.time_ms(
                           lambda: kc.conv3x3_nchw_plain(x, w, out)),
                       # cuDNN in the working dtype, for scale
                       "cudnn_ms": self.time_ms(
                           lambda: F.conv2d(x, w_oihw, padding=1)),
                       # host cost per call: the kernel's wrapper, given
                       # the model's permuted weight view, against cuDNN
                       "host_us": self.host_us(lambda: kc.conv3x3_nchw(
                           x, w_oihw.permute(2, 3, 1, 0), out)),
                       "cudnn_host_us": self.host_us(
                           lambda: F.conv2d(x, w_oihw, padding=1))}
                flops = 2 * BATCH * hw * hw * cin * cout * 9
                row["kernel_tflops"] = flops / row["ms"] / 1e9
                conv_rows.append(row)
                log(f"time conv {mod:10s} {cin:2d}->{cout:2d} @{hw} {dname}:"
                    f" kernel {row['ms']:.4f} ms ({row['kernel_tflops']:.2f}"
                    f" TFLOP/s), twin {row['plain_ms']:.4f} ms, cuDNN "
                    f"{row['cudnn_ms']:.4f} ms; host per call: kernel "
                    f"{row['host_us']:.1f} µs, cuDNN "
                    f"{row['cudnn_host_us']:.1f} µs")
            for mod, c, hw in POOL_SHAPES:
                x = torch.randn((BATCH, c, hw, hw), device=self.dev).to(dtype)
                kern = lambda: kp.max_pool_2x2_nchw(x)   # noqa: E731
                twin = lambda: kp.max_pool_2x2_nchw_plain(x)   # noqa: E731
                # cold: from HBM, as the bandwidth figure assumes; warm:
                # the input (17-34 MB) sits in the 50 MB L2
                row = {"module": mod, "c": c, "hw": hw, "dtype": dname,
                       "ms": self.time_ms(kern, cold=True),
                       "plain_ms": self.time_ms(twin, cold=True),
                       "warm_ms": self.time_ms(kern),
                       "warm_plain_ms": self.time_ms(twin),
                       "host_us": self.host_us(kern),
                       "plain_host_us": self.host_us(twin)}
                nbytes = x.numel() * x.element_size() * 5 / 4
                row["kernel_gbps"] = nbytes / row["ms"] / 1e6
                pool_rows.append(row)
                log(f"time pool {mod} {c}x{hw}x{hw} {dname}: L2 flushed: "
                    f"kernel {row['ms']:.4f} ms ({row['kernel_gbps']:.0f} "
                    f"GB/s from HBM), twin {row['plain_ms']:.4f} ms; warm "
                    f"L2: kernel {row['warm_ms']:.4f} ms, twin "
                    f"{row['warm_plain_ms']:.4f} ms; host per call: kernel "
                    f"{row['host_us']:.1f} µs, twin "
                    f"{row['plain_host_us']:.1f} µs")
        t["conv"], t["pool"] = conv_rows, pool_rows
        for name, rows in (("conv3x3_nchw", conv_rows),
                           ("max_pool_2x2_nchw", pool_rows)):
            main = [r for r in rows if r["dtype"] == "bf16"]
            if name == "conv3x3_nchw":
                # cuDNN in bf16 is the library call; the head writes f32
                lib = sum(r["cudnn_ms"] for r in main)
                bounds = [bound(*conv_cost(
                    r["cin"], r["cout"], r["hw"], 2,
                    4 if r["module"] == "out_conv" else 2), "bf16")
                    for r in main]
            else:
                # the plain version is the library call, F.max_pool2d
                lib = sum(r["plain_ms"] for r in main)
                bounds = [bound(BATCH * r["c"] * r["hw"] ** 2 * 2 * 5 / 4,
                                0, "bf16") for r in main]
            self.report["kernels"][name].update(
                ms=sum(r["ms"] for r in main),
                plain_ms=sum(r["plain_ms"] for r in main),
                library_ms=lib, bound_ms=sum(b[0] for b in bounds),
                bound_by=("bytes" if sum(b[0] for b in bounds
                                         if b[1] == "bytes") * 2
                          >= sum(b[0] for b in bounds) else "operations"))

        self.predict_rounds(t)
        t["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

        # a burst: every request submitted at once, so the latencies in
        # `stats` are mostly queueing behind the burst, not a line camera's
        batcher = AsyncBatcher(self.engine, max_wait_ms=5.0)
        try:
            n = 320
            t0 = time.perf_counter()
            futs = [batcher.submit(self.images[i % 42]) for i in range(n)]
            for f in futs:
                f.result(timeout=600)
            dt = time.perf_counter() - t0
            stats = batcher.stats()
        finally:
            batcher.shutdown()
        t["burst_imgs_per_s"] = n / dt
        t["burst_batcher_stats"] = stats
        log(f"time AsyncBatcher, burst: {n} requests at once in "
            f"{dt:.3f} s = {n / dt:.1f} imgs/s; {json.dumps(stats)}")

        self.profile(self.x_dev)

    def _stages(self, eng, batch):
        """One predict of `batch` (exactly one micro-batch) cut into its
        stages on the host clock, with a sync after each device stage."""
        import numpy as np
        torch = self.torch
        t0 = time.perf_counter()
        x = eng._normalize(batch)
        t1 = time.perf_counter()
        x_dev = torch.from_numpy(np.ascontiguousarray(x)).to(self.dev)
        self.sync()
        t2 = time.perf_counter()
        m, p = eng.predict_device(x_dev)
        self.sync()
        t3 = time.perf_counter()
        m.cpu().numpy(), p.cpu().numpy()
        t4 = time.perf_counter()
        return {"normalize": t1 - t0, "h2d": t2 - t1, "forward_sync": t3 - t2,
                "d2h": t4 - t3}

    def predict_rounds(self, t, rounds=10, reps=5):
        """Kernel and plain bf16 engines in alternating rounds (K P, P K,
        ...), so that drift in the host's or the card's speed falls on both.
        Per round and engine: the median of `reps` predict calls (host
        clock, numpy in and out), the forward (CUDA events over 10 back to
        back on device tensors: the steady rate, host-bound where the
        host's enqueue outlasts the device's work), the host's enqueue of
        one forward, and the predict's stages. Reported: median, min and max over the rounds."""
        torch = self.torch
        batch = self.images[:BATCH]
        x_dev = torch.from_numpy(self.engine._normalize(batch)).to(self.dev)
        engines = {"kernel": self.engine, "plain": self.plain["bfloat16"]}
        keys = ("predict", "forward", "enqueue", "normalize", "h2d",
                "forward_sync", "d2h")
        got = {lab: {k: [] for k in keys} for lab in engines}
        for eng in engines.values():
            eng.predict(batch)
        for r in range(rounds):
            for lab in (("kernel", "plain") if r % 2 == 0
                        else ("plain", "kernel")):
                eng, g = engines[lab], got[lab]
                lat = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    eng.predict(batch)
                    lat.append((time.perf_counter() - t0) * 1e3)
                g["predict"].append(statistics.median(lat))
                g["forward"].append(self.time_ms(
                    lambda: eng.predict_device(x_dev), iters=10, rounds=1,
                    warmup=1, lead=False))
                enq = []
                for _ in range(reps):
                    self.sync()
                    t0 = time.perf_counter()
                    eng.predict_device(x_dev)
                    enq.append((time.perf_counter() - t0) * 1e3)
                g["enqueue"].append(statistics.median(enq))
                st = [self._stages(eng, batch) for _ in range(reps)]
                for k in st[0]:
                    g[k].append(statistics.median(s[k] for s in st) * 1e3)
        for lab, g in got.items():
            summ = {k: {"median": statistics.median(v), "min": min(v),
                        "max": max(v)} for k, v in g.items()}
            t[f"e2e_{lab}"] = {"rounds": g, "summary": summ}
            log(f"time bf16 B={BATCH} {lab} engine, {rounds} alternating "
                f"rounds, median [min, max] ms: " + "; ".join(
                    f"{k} {s['median']:.3f} [{s['min']:.3f}, "
                    f"{s['max']:.3f}]" for k, s in summ.items()))
        self.x_dev = x_dev

    def profile(self, x_dev):
        """Device time by kernel over 3 forwards of each bf16 engine. Best
        effort: the profiler is a measurement aid, and its failure fails no
        phase."""
        from torch.profiler import ProfilerActivity, profile
        cuda = self.torch.autograd.DeviceType.CUDA
        t = self.report["times"]
        os.makedirs(OUT_DIR, exist_ok=True)
        for lab, eng in (("kernel", self.engine),
                         ("plain", self.plain["bfloat16"])):
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        eng.predict_device(x_dev)
                    self.sync()
                events = prof.key_averages()
                table = events.table(sort_by="cuda_time_total",
                                     row_limit=25)
            except RuntimeError as exc:
                log(f"profiler unavailable: {exc}")
                return
            # the kernels' own rows (operator rows repeat their kernels' time)
            busy_ms = sum(e.self_device_time_total
                          for e in device_work(events, cuda)) / 3 / 1e3
            fwd = t[f"e2e_{lab}"]["summary"]["forward"]["median"]
            t[f"device_busy_ms_per_forward_{lab}"] = busy_ms
            t[f"device_idle_share_{lab}"] = 1.0 - busy_ms / fwd
            log(f"device busy {busy_ms:.3f} ms per bf16 forward of the {lab}"
                f" engine (profiler) of {fwd:.3f} ms (CUDA events, median): "
                f"idle share {t[f'device_idle_share_{lab}']:.3f}")
            name = f"chip_smoke_profile_{lab}.txt"
            with open(os.path.join(OUT_DIR, name), "w") as f:
                f.write(table)
            if lab == "kernel":
                log(f"profile of 3 bf16 forwards (B=16) of the {lab} engine, "
                    f"by device time (the plain engine's: chiprun_out/"
                    f"chip_smoke_profile_plain.txt):\n" + table)

    # ------------------------------------------------------------ phase 6
    def _grad_case(self, cin, cout, hw, dtype, seed, batch=BATCH):
        """x [B, Cin, H, W], w [3, 3, Cin, Cout] (scaled as lecun_normal)
        and a cotangent g [B, Cout, H, W], all in `dtype`; hw is H = W or
        (H, W)."""
        torch = self.torch
        g = self.gen(seed)
        h, wd = hw if isinstance(hw, tuple) else (hw, hw)
        x = torch.randn((batch, cin, h, wd), generator=g,
                        device=self.dev).to(dtype)
        w = (torch.randn((3, 3, cin, cout), generator=g, device=self.dev)
             / (9 * cin) ** 0.5).to(dtype)
        gy = torch.randn((batch, cout, h, wd), generator=g,
                         device=self.dev).to(dtype)
        return x, w, gy

    def _pool_case(self, c, hw, dtype, seed):
        """A pool input with in-window ties, -inf, +inf and NaN, and a
        cotangent with ties."""
        torch = self.torch
        g = self.gen(seed)
        x = torch.round(torch.randn((BATCH, c, hw, hw), generator=g,
                                    device=self.dev) * 2) / 2
        x[0, 0, 0, 0] = float("-inf")
        x[1, 1, 2:4, 4:6] = float("-inf")
        x[2, 2, 5, 7] = float("inf")
        x[3, 3, 8, 9] = float("nan")
        x[4, 4, 10:12, 12:14] = float("nan")
        gy = torch.round(torch.randn((BATCH, c, hw // 2, hw // 2),
                                     generator=g, device=self.dev) * 8) / 8
        return x.to(dtype), gy.to(dtype)

    def _ce_case(self, seed):
        """f32 logits [B, 256, 256, C] as the model hands them over (the
        NHWC view of NCHW storage) and int32 labels, a few out of range."""
        torch = self.torch
        g = self.gen(seed)
        nchw = torch.randn((BATCH, NUM_CLASSES, HW, HW), generator=g,
                           device=self.dev) * 2
        labels = torch.randint(0, NUM_CLASSES, (BATCH, HW, HW), generator=g,
                               device=self.dev, dtype=torch.int32)
        labels[0, 0, :5] = NUM_CLASSES + 3
        return nchw.permute(0, 2, 3, 1), labels

    def _odd_logits(self, g, b, h, w, c, layout, scale=2.0):
        """f32 logits [b, h, w, c] in one of LOSS_ODD_LAYOUTS."""
        torch = self.torch
        if layout == "nhwc":
            return torch.randn((b, h, w, c), generator=g,
                               device=self.dev) * scale
        n = b * c * h * w
        base = torch.randn(n + 1, generator=g, device=self.dev) * scale
        flat = base[1:] if layout == "offset" else base[:n]
        return flat.view(b, c, h, w).permute(0, 2, 3, 1)

    def _odd_labels(self, g, b, h, w, c, offset):
        """int32 labels [b, h, w] in [0, c), six out of range, contiguous
        and (with `offset`) one element past their storage's start."""
        torch = self.torch
        lab = torch.randint(0, c, (b * h * w + 1,), generator=g,
                            device=self.dev, dtype=torch.int32)
        lab[1:6] = c + 3
        lab[7] = -1
        return (lab[1:] if offset else lab[:-1]).view(b, h, w)

    def _ce_q(self, stats):
        """q and gce of the backward for cotangents (0.5, 0.5)."""
        from uaps_tpu_torch.kernels import ce_dice as kce
        return kce.bwd_coefs(stats, 0.5, 0.5, BATCH * HW * HW)

    def train_kernels(self):
        """Each training kernel against its plain version at every shape
        of one neu baseline step (B=16), f32 and bf16. Tolerances:
        dgrad as the forward (it is the forward kernel): rtol=atol 1e-4 in
        f32, 1e-2 in bf16 (<= 1 bf16 ulp); wgrad max |err| <= 1e-4 x
        max |dW| (f32 sums of up to 1 M products in another order: per-
        block partials against cuBLAS's); pool backward exact, with ties,
        -inf, +inf and NaN windows (a NaN window routes nothing); CE+Dice
        stats rtol 1e-5 (sums of 1 M pixels in two tree orders), dlogits
        within 1e-4 x max |dlogits| (per-pixel expf/logf against torch's
        exp/log, a few ulp)."""
        from uaps_tpu_torch.kernels import ce_dice as kce
        from uaps_tpu_torch.kernels import conv3x3_nchw as kc
        from uaps_tpu_torch.kernels import pool_nchw as kp
        torch = self.torch
        errs = {n: 0.0 for n in ("conv3x3_nchw_dgrad", "conv3x3_nchw_wgrad",
                                 "max_pool_2x2_nchw_bwd", "ce_dice_fwd",
                                 "ce_dice_bwd")}
        bad = []

        def record(name, label, err, ok, note=""):
            errs[name] = max(errs[name], err)
            log(f"{label}: max_abs_err {err:.3e}{note} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(label)

        for dname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            tol = 1e-4 if dname == "f32" else 1e-2
            for i, (mod, cin, cout, hw) in enumerate(CONV_SHAPES):
                x, w, gy = self._grad_case(cin, cout, hw, dtype,
                                           SEED + 100 + i)
                if (mod, cin, cout, hw) in DGRAD_SHAPES:
                    dx = kc.conv3x3_nchw_dgrad(gy, w)
                    self.sync()
                    ref = kc.conv3x3_nchw_dgrad_plain(gy, w)
                    self.sync()
                    err = float((dx.float() - ref.float()).abs().max())
                    ok = (dx.shape == x.shape and dx.dtype == dtype
                          and bool(torch.isfinite(dx).all())
                          and torch.allclose(dx.float(), ref.float(),
                                             rtol=tol, atol=tol))
                    record("conv3x3_nchw_dgrad", f"dgrad {mod:10s} {cout:2d}"
                           f"->{cin:2d} @{hw} {dname}", err, ok)
                dw = kc.conv3x3_nchw_wgrad(x, gy)
                self.sync()
                ref = kc.conv3x3_nchw_wgrad_plain(x, gy)
                self.sync()
                err = float((dw - ref).abs().max())
                scale = float(ref.abs().max())
                ok = (dw.shape == (3, 3, cin, cout)
                      and dw.dtype == torch.float32
                      and bool(torch.isfinite(dw).all())
                      and err <= 1e-4 * scale)
                record("conv3x3_nchw_wgrad", f"wgrad {mod:10s} {cin:2d}->"
                       f"{cout:2d} @{hw} {dname}", err, ok,
                       f" (max |dW| {scale:.3e})")
            # where the tensor-core pass pads and masks (bf16), and f32
            for i, (cin, cout) in enumerate(ODD_WGRAD):
                x, _, gy = self._grad_case(cin, cout, ODD_HW, dtype,
                                           SEED + 130 + i, ODD_BATCH)
                dw = kc.conv3x3_nchw_wgrad(x, gy)
                self.sync()
                ref = kc.conv3x3_nchw_wgrad_plain(x, gy)
                self.sync()
                err = float((dw - ref).abs().max())
                scale = float(ref.abs().max())
                ok = (dw.shape == (3, 3, cin, cout)
                      and bool(torch.isfinite(dw).all())
                      and err <= 1e-4 * scale)
                record("conv3x3_nchw_wgrad", f"wgrad odd {cin:2d}->{cout:2d}"
                       f" @{ODD_HW[0]}x{ODD_HW[1]} B={ODD_BATCH} {dname}",
                       err, ok, f" (max |dW| {scale:.3e})")
            # where the bf16 tensor-core dgrad pads its K (Cout) and N
            # (Cin) and masks a ragged tile
            for i, (cin, cout) in enumerate(ODD_CONV):
                _, w, gy = self._grad_case(cin, cout, ODD_HW, dtype,
                                           SEED + 140 + i, ODD_BATCH)
                dx = kc.conv3x3_nchw_dgrad(gy, w)
                self.sync()
                ref = kc.conv3x3_nchw_dgrad_plain(gy, w)
                self.sync()
                err = float((dx.float() - ref.float()).abs().max())
                ok = (dx.shape == ref.shape and dx.dtype == dtype
                      and bool(torch.isfinite(dx).all())
                      and torch.allclose(dx.float(), ref.float(), rtol=tol,
                                         atol=tol))
                record("conv3x3_nchw_dgrad", f"dgrad odd {cout:2d}->{cin:2d}"
                       f" @{ODD_HW[0]}x{ODD_HW[1]} B={ODD_BATCH} {dname}",
                       err, ok)
            for i, (mod, c, hw) in enumerate(POOL_SHAPES):
                x, gy = self._pool_case(c, hw, dtype, SEED + 150 + i)
                dx = kp.max_pool_2x2_nchw_bwd(x, gy)
                self.sync()
                ref = kp.max_pool_2x2_nchw_bwd_plain(x, gy)
                self.sync()
                same = bool(torch.equal(dx, ref))
                err = 0.0 if same else float((dx.float() - ref.float())
                                             .abs().max())
                nan_win = dx[3, 3, 8:10, 8:10]
                ok = (same and dx.dtype == dtype
                      and bool((nan_win == 0).all())
                      and int((dx != 0).sum()) <= gy.numel())
                record("max_pool_2x2_nchw_bwd", f"pool bwd {mod} {c}x{hw}x"
                       f"{hw} {dname} exact", err, ok)

        def ce_fwd(label, lg, labels):
            """The stats against the plain version, and a second call
            bit-equal to the first (the fixed-order reduction)."""
            stats = kce.ce_dice_stats(lg, labels)
            again = kce.ce_dice_stats(lg, labels)
            self.sync()
            ref = kce.ce_dice_stats_plain(lg, labels)
            self.sync()
            err = float((stats - ref).abs().max())
            same = bool(torch.equal(stats, again))
            ok = (stats.shape == (4, lg.shape[-1]) and same
                  and bool(torch.isfinite(stats).all())
                  and torch.allclose(stats, ref, rtol=1e-5, atol=1e-3))
            record("ce_dice_fwd", f"ce_dice stats {label} f32", err, ok,
                   f" (nll sum {float(ref[3, 0]):.6e}; a second call "
                   f"{'bit-equal' if same else 'DIFFERS'})")
            return stats, ref

        lg, labels = self._ce_case(SEED + 170)
        stats, ref = ce_fwd(list(lg.shape), lg, labels)
        if self.dev.type == "cuda":
            # the last block left the ticket at 0, and a CUDA graph replays
            # the one launch unchanged
            ticket = int(kce._SCRATCH[self.dev][-1])
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                kce.ce_dice_stats(lg, labels)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(graph):
                replayed = kce.ce_dice_stats(lg, labels)
            graph.replay()
            graph.replay()
            self.sync()
            ok = (ticket == 0 and int(kce._SCRATCH[self.dev][-1]) == 0
                  and bool(torch.equal(replayed, stats)))
            record("ce_dice_fwd", "ce_dice stats: the ticket at 0 after the "
                   "calls, two CUDA-graph replays bit-equal", 0.0, ok,
                   f" (ticket {ticket})")
        g = self.gen(SEED + 175)
        for b, h, wd in LOSS_ODD_SHAPES:
            for c in LOSS_ODD_CLASSES:
                for layout in LOSS_ODD_LAYOUTS:
                    ce_fwd(f"[{b},{h},{wd},{c}] {layout}",
                           self._odd_logits(g, b, h, wd, c, layout),
                           self._odd_labels(g, b, h, wd, c,
                                            layout == "offset"))
        q, gce = self._ce_q(ref)
        d = kce.ce_dice_bwd(lg, labels, q, gce)
        self.sync()
        dref = kce.ce_dice_bwd_plain(lg, labels, q, gce)
        self.sync()
        err = float((d - dref).abs().max())
        scale = float(dref.abs().max())
        ok = (d.shape == lg.shape and d.stride() == lg.stride()
              and bool(torch.isfinite(d).all()) and err <= 1e-4 * scale)
        record("ce_dice_bwd", f"ce_dice dlogits {list(lg.shape)} f32", err,
               ok,
               f" (max |dlogits| {scale:.3e})")
        for name, e in errs.items():
            self.report["kernels"][name] = {"max_abs_err": e}
        if bad:
            raise AssertionError(f"training kernel mismatches: {bad}")

    # ------------------------------------------------------------ phase 7
    def _train_config(self, **model_kw):
        """The baseline slice as `python -m uaps_tpu_torch.train --preset
        neu --method baseline --dtype bfloat16 --dropout_backend xla
        --dataset synthetic` builds it, with `model_kw` on top."""
        from uaps_tpu_torch.utils.cli import parse_args
        cfg, _ = parse_args(["--preset", "neu", "--method", "baseline",
                             "--dtype", "bfloat16", "--dropout_backend",
                             "xla", "--dataset", "synthetic"])
        cfg.model = dataclasses.replace(cfg.model, **model_kw)
        return cfg

    def _step_pair(self, method, cfg, plain_cfg, init_sd, batch, want,
                   step=0, prepare=None):
        """One step of `method` on the kernel path and one on the plain
        path from the same weights, batch, generator seed and step count
        (`prepare(model)` applied to both models first); returns both
        models and their metrics."""
        from uaps_tpu_torch.methods import base
        out = []
        for c in (cfg, plain_cfg):
            model = base.build_model(c, self.dev)
            model.load_state_dict(init_sd)
            if prepare is not None:
                prepare(model)
            state = base.init_model_state(c, model)
            state.step = step
            before = counters()
            _, m = method.make_train_step(c, model)(state, batch)
            self.sync()
            launched = {k: v - before[k] for k, v in counters().items()}
            out.append((model, {k: float(v) for k, v in m.items()},
                        launched))
        assert not any(out[1][2].values()), \
            f"the plain path launched kernels: {out[1][2]}"
        assert out[0][2] == want, out[0][2]
        return out

    def training(self):
        """The baseline slice at full width: 3 warm-up and 10 timed steps on
        the kernel path, the launch counts per step, one step on each path
        from the same weights compared within bf16 tolerances, the eval
        step, and the plain path's step time."""
        import numpy as np
        from uaps_tpu_torch.data import SyntheticDefects
        from uaps_tpu_torch.methods import base, get_method
        from uaps_tpu_torch.train import to_device
        torch = self.torch
        cfg = self._train_config()
        assert (cfg.model.name, cfg.data.batch_size, cfg.data.image_size,
                cfg.model.compute_dtype) == ("unet", BATCH, (HW, HW),
                                             "bfloat16"), cfg
        t0 = time.perf_counter()
        data = SyntheticDefects(cfg.data, seed=SEED)
        it = data.train_iter()
        batches = [to_device(next(it), self.dev)
                   for _ in range(TRAIN_WARMUP + TRAIN_STEPS + 1)]
        val = to_device(next(data.val_iter(1)), self.dev)
        log(f"train data: {len(batches)} synthetic batches + 1 val in "
            f"{time.perf_counter() - t0:.1f} s")
        method = get_method("baseline")
        state, model = method.init_state(
            cfg, self.dev, torch.Generator().manual_seed(SEED))
        init_sd = {k: v.detach().clone() for k, v in
                   model.state_dict().items()}
        step = method.make_train_step(cfg, model)
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()       # the main path's run starts here
        losses, step_ms = [], []
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            self.sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(v) for k, v in m.items()})
        self.train_launches = counters()   # ... and ends here
        n_steps = TRAIN_WARMUP + TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        timed = step_ms[TRAIN_WARMUP:]
        t = self.report["times"]
        t["train_step_ms"] = {"median": statistics.median(timed),
                              "min": min(timed), "max": max(timed),
                              "all": step_ms}
        t["train_imgs_per_s"] = BATCH / statistics.median(timed) * 1e3
        t["train_peak_mem_gib"] = peak
        log("train losses: " + ", ".join(f"{m['loss']:.4f}" for m in losses))
        log(f"launches over {n_steps} kernel-path steps: "
            f"{json.dumps(self.train_launches)}")
        log(f"time train step bf16 B={BATCH} (host clock, sync each step): "
            f"median {t['train_step_ms']['median']:.3f} ms [min "
            f"{t['train_step_ms']['min']:.3f}, max "
            f"{t['train_step_ms']['max']:.3f}] over {TRAIN_STEPS} steps = "
            f"{t['train_imgs_per_s']:.1f} imgs/s; peak memory {peak:.3f} GiB")
        self.report["training"] = {"losses": losses,
                                   "launches": self.train_launches}
        assert all(np.isfinite(v) for m in losses for v in m.values()), \
            "non-finite training metrics"
        want = {k: v * n_steps for k, v in STEP_LAUNCHES.items()}
        assert self.train_launches == want, (self.train_launches, want)

        plain_cfg = self._train_config(conv_backend="xla")
        (km, kmet, _), (pm, pmet, _) = self._step_pair(
            method, cfg, plain_cfg, init_sd, batches[-1], STEP_LAUNCHES)
        self.report["training"]["kernel_vs_plain"] = self._compare_steps(
            km, pm, kmet, pmet, init_sd, cfg.optim.base_lr)

        ev = base.make_eval_step(cfg, model)(val)
        ev = {k: float(v) for k, v in ev.items()}
        log(f"eval step (bf16, B={BATCH}): {json.dumps(ev)}")
        assert all(np.isfinite(v) for v in ev.values()), ev
        self.report["training"]["eval"] = ev

        # the plain path's step time, for scale (same batches)
        pstate = base.init_model_state(plain_cfg, pm)
        pstep = method.make_train_step(plain_cfg, pm)
        pms = []
        for i in range(TRAIN_WARMUP + 5):
            t0 = time.perf_counter()
            pstep(pstate, batches[i % len(batches)])
            self.sync()
            pms.append((time.perf_counter() - t0) * 1e3)
        pms = pms[TRAIN_WARMUP:]
        t["plain_train_step_ms"] = {"median": statistics.median(pms),
                                    "min": min(pms), "max": max(pms)}
        log(f"time plain-path train step bf16 B={BATCH}: median "
            f"{statistics.median(pms):.3f} ms [min {min(pms):.3f}, max "
            f"{max(pms):.3f}] over 5 steps")
        self.train_model, self.train_state = model, state
        self.train_step, self.train_batch = step, batches[0]

    def _compare_steps(self, km, pm, kmet, pmet, init_sd, lr,
                       terms=("loss",), gate="all", label="kernel vs plain"):
        """Kernel path against the plain path after one step from the same
        weights. bf16 tolerances: the two paths round at other places
        (cuDNN's bf16 convs accumulate in their own order, the plain head
        takes f32 inputs), so the step-1 loss may differ by 1e-2
        relative; each weight tensor's gradient must point the same way
        (cosine >= 0.98); and since Adam's first update is about
        lr * sign(g), >= 95% of the parameter deltas must agree within
        lr / 2. The biases of the convs that feed a train-mode BN have a
        zero gradient up to rounding, so they are left out of both, as are
        parameters the step never reads (no gradient on either path: the
        deep-supervision heads dp1..3 of cps's nets). Every metric in
        `terms` is held to the loss's 1e-2 relative.
        gate="loss" holds only the metrics to that, gate="none" nothing
        (the numbers are reported either way)."""
        torch = self.torch
        rels = {k: abs(kmet[k] - pmet[k]) / abs(pmet[k]) for k in terms}
        rel = max(rels.values())
        pp = dict(pm.named_parameters())
        worst_cos, worst, agree, total = 1.0, None, 0, 0
        for k, p in km.named_parameters():
            if k.endswith(("conv_conv.0.bias", "conv_conv.4.bias")):
                continue
            if p.grad is None:
                assert pp[k].grad is None, f"{k}: a gradient on one path"
                continue
            gk, gp = p.grad.float().flatten(), pp[k].grad.float().flatten()
            cos = float(torch.nn.functional.cosine_similarity(gk, gp, dim=0))
            if cos < worst_cos:
                worst_cos, worst = cos, k
            dk = p.detach().float() - init_sd[k].float()
            dp = pp[k].detach().float() - init_sd[k].float()
            agree += int(((dk - dp).abs() <= lr / 2).sum())
            total += dk.numel()
        share = agree / total
        res = {"loss_kernel": kmet["loss"], "loss_plain": pmet["loss"],
               "loss_rel_diff": rel, "worst_grad_cosine": worst_cos,
               "worst_grad": worst, "delta_agree_share": share,
               "terms": {k: [kmet[k], pmet[k], r] for k, r in rels.items()}}
        ok = {"all": rel <= 1e-2 and worst_cos >= 0.98 and share >= 0.95,
              "loss": rel <= 1e-2, "none": True}[gate]
        log(f"{label} path, one step: " + "; ".join(
            f"{k} {kmet[k]:.6f} vs {pmet[k]:.6f} (rel {r:.2e})"
            for k, r in rels.items())
            + f" (tol 1e-2); worst grad cosine {worst_cos:.5f} ({worst}; "
            f"min 0.98); "
            f"param deltas within lr/2: {share:.5f} (min 0.95) "
            f"{'ok' if ok else 'MISMATCH'} (gated: {gate})")
        assert ok, res
        return res

    # ------------------------------------------------------------ phase 8
    def train_times(self):
        """Per kernel and shape of one bf16 baseline step: the kernel's ms,
        its plain version's and the library call's (cuDNN's dgrad and
        wgrad, aten's max-pool backward, the torch CE + Dice pair), and the
        bound; then a profile of one kernel-path step."""
        import torch.nn.functional as F
        from uaps_tpu_torch.kernels import ce_dice as kce
        from uaps_tpu_torch.kernels import conv3x3_nchw as kc
        from uaps_tpu_torch.kernels import pool_nchw as kp
        from uaps_tpu_torch.ops import softmax_dice_loss
        torch = self.torch
        bf = torch.bfloat16
        rows = {k: [] for k in ("conv3x3_nchw_dgrad", "conv3x3_nchw_wgrad",
                                "max_pool_2x2_nchw_bwd", "ce_dice_fwd",
                                "ce_dice_bwd")}

        def add(name, label, kern, plain, lib, nbytes, ops, kind,
                cold=False):
            row = {"shape": label,
                   "ms": self.time_ms(kern, cold=cold),
                   "plain_ms": self.time_ms(plain, cold=cold),
                   "library_ms": self.time_ms(lib, cold=cold)}
            row["bound_ms"], row["bound_by"] = bound(nbytes, ops, kind)
            rows[name].append(row)
            log(f"time {name} {label} bf16: kernel {row['ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms, library "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
                f"ms ({row['bound_by']})")

        for i, (mod, cin, cout, hw) in enumerate(CONV_SHAPES):
            x, w, gy = self._grad_case(cin, cout, hw, bf, SEED + 100 + i)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            label = f"{mod} {cin}->{cout} @{hw}"
            if (mod, cin, cout, hw) in DGRAD_SHAPES:
                nb, ops = conv_cost(cout, cin, hw, 2, 2)
                add("conv3x3_nchw_dgrad", label,
                    lambda: kc.conv3x3_nchw_dgrad(gy, w),
                    lambda: kc.conv3x3_nchw_dgrad_plain(gy, w),
                    lambda: torch.nn.grad.conv2d_input(
                        x.shape, w_oihw, gy, padding=1), nb, ops, "bf16")
            px = BATCH * hw * hw
            add("conv3x3_nchw_wgrad", label,
                lambda: kc.conv3x3_nchw_wgrad(x, gy),
                lambda: kc.conv3x3_nchw_wgrad_plain(x, gy),
                lambda: torch.nn.grad.conv2d_weight(
                    x, w_oihw.shape, gy, padding=1),
                px * (cin + cout) * 2 + 9 * cin * cout * 4,
                2 * px * cin * cout * 9, "bf16")
        for i, (mod, c, hw) in enumerate(POOL_SHAPES):
            x, gy = self._pool_case(c, hw, bf, SEED + 150 + i)
            _, idx = F.max_pool2d(x, 2, return_indices=True)
            n = x.numel() * 2
            add("max_pool_2x2_nchw_bwd", f"{mod} {c}x{hw}x{hw}",
                lambda: kp.max_pool_2x2_nchw_bwd(x, gy),
                lambda: kp.max_pool_2x2_nchw_bwd_plain(x, gy),
                lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                    gy, x, [2, 2], [2, 2], [0, 0], [1, 1], False, idx),
                n + n // 4 + n, 0, "bf16", cold=True)
        lg, labels = self._ce_case(SEED + 170)
        lab64 = labels.clamp(0, NUM_CLASSES - 1).long()
        nchw = lg.permute(0, 3, 1, 2)     # the contiguous storage
        px = BATCH * HW * HW
        add("ce_dice_fwd", "[16,256,256,4]",
            lambda: kce.ce_dice_stats(lg, labels),
            lambda: kce.ce_dice_stats_plain(lg, labels),
            lambda: (F.cross_entropy(nchw, lab64),
                     softmax_dice_loss(lg, lab64)),
            px * NUM_CLASSES * 4 + px * 4 + 16 * NUM_CLASSES,
            px * NUM_CLASSES * 12, "f32", cold=True)
        stats = kce.ce_dice_stats_plain(lg, labels)
        q, gce = self._ce_q(stats)
        lgr = nchw.detach().requires_grad_()
        pair = (F.cross_entropy(lgr, lab64)
                + softmax_dice_loss(lgr.permute(0, 2, 3, 1), lab64))
        add("ce_dice_bwd", "[16,256,256,4]",
            lambda: kce.ce_dice_bwd(lg, labels, q, gce),
            lambda: kce.ce_dice_bwd_plain(lg, labels, q, gce),
            lambda: torch.autograd.grad(pair, lgr, retain_graph=True),
            2 * px * NUM_CLASSES * 4 + px * 4, px * NUM_CLASSES * 16, "f32",
            cold=True)
        t = self.report["times"]
        t["train_kernels"] = rows
        for name, rs in rows.items():
            by_bytes = sum(r["bound_ms"] for r in rs if r["bound_by"] ==
                           "bytes")
            self.report["kernels"][name].update(
                ms=sum(r["ms"] for r in rs),
                plain_ms=sum(r["plain_ms"] for r in rs),
                library_ms=sum(r["library_ms"] for r in rs),
                bound_ms=sum(r["bound_ms"] for r in rs),
                bound_by=("bytes" if by_bytes * 2 >= sum(
                    r["bound_ms"] for r in rs) else "operations"))
        self.profile_steps("train", "train", self.train_step,
                           self.train_state, self.train_batch,
                           t["train_step_ms"]["median"], STEP_LAUNCHES)

    def profile_steps(self, key, label, step, state, batch, step_ms,
                      per_step=None):
        """Device time by kernel over 2 steps of `step`, beside the step's
        host-clock time `step_ms`: times[key + "_device_busy_ms"],
        "_device_idle_share" and "_device_top_ms" (the 20 largest device
        entries a step: name, ms, count), the operator table in
        chip_smoke_profile_<key>.txt. Best effort, as the serving
        profile, but with `per_step` (the step's launches, bf16) the
        profiler must show the conv route of bf16_route, or this raises.
        The steps come after the lead-in (whose kernels no number here
        counts): a step's first kernel is a conv forward."""
        cuda = self.torch.autograd.DeviceType.CUDA
        t = self.report["times"]
        try:
            prof = self._profiled(lambda: [step(state, batch)
                                           for _ in range(2)])
            events = prof.key_averages()
            table = events.table(sort_by="cuda_time_total", row_limit=40)
        except RuntimeError as exc:
            log(f"profiler unavailable: {exc}")
            if per_step is not None:
                raise
            return
        device = sorted(device_work(events, cuda),
                        key=lambda e: -e.self_device_time_total)
        if per_step is not None:
            got = route_of([(e.key, e.count) for e in device])
            want = bf16_route(per_step, 2)
            self.report.setdefault("route", {})[key] = got
            log(f"route over 2 {label} steps (profiler): {json.dumps(got)} "
                f"{'ok' if got == want else 'MISMATCH'} (want "
                f"{json.dumps(want)})")
            assert got == want, (got, want)
        busy = sum(e.self_device_time_total for e in device) / 2 / 1e3
        t[f"{key}_device_busy_ms"] = busy
        t[f"{key}_device_idle_share"] = 1.0 - busy / step_ms
        # the device's own entries (kernels, copies, memsets), by time
        t[f"{key}_device_top_ms"] = [
            [e.key, e.self_device_time_total / 2 / 1e3, e.count // 2]
            for e in device[:20]]
        with open(os.path.join(OUT_DIR, f"chip_smoke_profile_{key}.txt"),
                  "w") as f:
            f.write(table)
        log(f"device busy {busy:.3f} ms per {label} step (profiler) of "
            f"{step_ms:.3f} ms (host clock, median): idle share "
            f"{t[f'{key}_device_idle_share']:.3f}; by device time:\n"
            + "\n".join(f"  {ms:9.3f} ms x{n:4d}  {name[:100]}"
                        for name, ms, n in t[f"{key}_device_top_ms"])
            + "\n" + table)

    # ------------------------------------------------------------ phase 9
    def _level_case(self, lvl, dtype, seed):
        """A skip tensor of level `lvl`, a cotangent and a seed, on the
        card."""
        torch = self.torch
        c, hw = LEVELS[lvl]
        g = self.gen(seed)
        x = torch.randn((BATCH, c, hw, hw), generator=g,
                        device=self.dev).to(dtype)
        gy = torch.randn((BATCH, c, hw, hw), generator=g,
                         device=self.dev).to(dtype)
        sd = torch.randint(0, 2 ** 31 - 1, (), generator=g, device=self.dev)
        return x, gy, sd

    def _unc_case(self, seed):
        """N_DEC f32 logits [B, 256, 256, C] as the model hands them over
        (NHWC views of NCHW heads), Dirichlet mix weights and a cotangent
        of var."""
        torch = self.torch
        g = self.gen(seed)
        logits = [(torch.randn((BATCH, NUM_CLASSES, HW, HW), generator=g,
                               device=self.dev) * 3).permute(0, 2, 3, 1)
                  for _ in range(N_DEC)]
        w = torch.empty(N_DEC, device=self.dev).exponential_(generator=g)
        gv = torch.randn((N_DEC, BATCH, HW, HW), generator=g,
                         device=self.dev)
        return logits, w / w.sum(), gv

    def uaps_kernels(self):
        """Each UAPS kernel against its plain version (see phase 9 in the
        module docstring)."""
        from uaps_tpu_torch.kernels import perturb as kpt
        from uaps_tpu_torch.kernels import uncertainty as kun
        torch = self.torch
        errs = {n: 0.0 for n in ("fused_dropout", "feature_noise",
                                 "feature_dropout", "feature_dropout_bwd",
                                 "uncertainty_fwd", "uncertainty_bwd")}
        bad = []

        def exact(name, label, got, ref, extra=True):
            same = (got.shape == ref.shape and got.dtype == ref.dtype
                    and bool(torch.equal(got, ref)))
            err = 0.0 if same else float(
                (got.float() - ref.float()).abs().nan_to_num(1e30).max())
            errs[name] = max(errs[name], err)
            ok = same and extra
            log(f"{label}: {'bit-equal' if same else 'DIFFERS'} "
                f"(max_abs_err {err:.3e}){'' if extra else ' MASK'} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(label)

        def run(fn, x, gy, *args):
            """fn's output and its gradient through the autograd function."""
            xr = x.clone().requires_grad_()
            y = fn(xr, *args)
            y.backward(gy)
            self.sync()
            return y.detach(), xr.grad

        def same_mask(x, gy, y, dx):
            """The backward zeroed exactly what the forward zeroed (CUDA's
            randn gives an exact 0 about once in 2^25 draws: skip those)."""
            live = (x != 0) & (gy != 0)
            return bool(torch.equal((y != 0) & live, (dx != 0) & live))

        def fdrop_case(x, gy, sd, label):
            """Feature dropout's forward and backward through autograd (the
            backward from the saved attention and maxima) against the plain
            versions from x, and the attention pass's output against
            channel_mean, bit for bit."""
            y, dx = run(kpt.fused_feature_dropout, x, gy, sd)
            exact("feature_dropout", label, y,
                  kpt.feature_dropout_plain(x, sd))
            exact("feature_dropout_bwd", f"{label} bwd", dx,
                  kpt.feature_dropout_bwd_plain(x, gy, sd),
                  same_mask(x, gy, y, dx))
            exact("feature_dropout", f"{label} attention",
                  kpt._fdrop_fwd(x, sd)[1], kpt.channel_mean(x))

        for dname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            for lvl, (c, hw) in enumerate(LEVELS):
                x, gy, sd = self._level_case(lvl, dtype, SEED + 200 + lvl)
                shape = f"[{BATCH},{c},{hw},{hw}] {dname}"
                for rate in sorted({ENC_DROPOUT[lvl], 0.5}):
                    y, dx = run(kpt.fused_dropout, x, gy, sd, rate)
                    exact("fused_dropout", f"dropout p={rate} {shape}", y,
                          kpt.dropout_plain(x, sd, rate))
                    exact("fused_dropout", f"dropout bwd p={rate} {shape}",
                          dx, kpt.dropout_plain(gy, sd, rate),
                          same_mask(x, gy, y, dx))
                y, dx = run(kpt.fused_feature_noise, x, gy, sd)
                exact("feature_noise", f"feature noise {shape}", y,
                      kpt.feature_noise_plain(x, sd, 0.3))
                exact("feature_noise", f"feature noise bwd {shape}", dx,
                      kpt.feature_noise_plain(gy, sd, 0.3))
                fdrop_case(x, gy, sd, f"feature dropout {shape}")
            # the dropout kernel's scalar tail and scalar path
            # (csrc/perturb.cu): a level-0 count plus 1 and plus 7
            # elements, then x and g one element past their allocations'
            # 16-byte aligned start
            c, hw = LEVELS[0]
            n0 = BATCH * c * hw * hw
            g = self.gen(SEED + 260)
            sd = torch.randint(0, 2 ** 31 - 1, (), generator=g,
                               device=self.dev)
            for extra in (1, 7):
                x, gy = (torch.randn(n0 + extra, generator=g,
                                     device=self.dev).to(dtype)
                         for _ in range(2))
                for rate in sorted({ENC_DROPOUT[0], 0.5}):
                    label = f"dropout p={rate} [{n0} + {extra}] {dname}"
                    y, dx = run(kpt.fused_dropout, x, gy, sd, rate)
                    exact("fused_dropout", label, y,
                          kpt.dropout_plain(x, sd, rate))
                    exact("fused_dropout", f"{label} bwd", dx,
                          kpt.dropout_plain(gy, sd, rate),
                          same_mask(x, gy, y, dx))
            xb, gb = (torch.randn(n0 + 1, generator=g,
                                  device=self.dev).to(dtype)
                      for _ in range(2))
            xb.requires_grad_()
            x, gy = (t[1:].view(BATCH, c, hw, hw) for t in (xb, gb))
            assert x.data_ptr() % 16 and gy.data_ptr() % 16, "not offset"
            for rate in sorted({ENC_DROPOUT[0], 0.5}):
                label = (f"dropout p={rate} [{BATCH},{c},{hw},{hw}] at a "
                         f"one-element offset {dname}")
                xb.grad = None
                y = kpt.fused_dropout(x, sd, rate)
                y.backward(gy)
                self.sync()
                dx = xb.grad[1:].view(x.shape)
                ref = kpt.dropout_plain(gy, sd, rate)
                exact("fused_dropout", label, y.detach(),
                      kpt.dropout_plain(x.detach(), sd, rate))
                exact("fused_dropout", f"{label} bwd", dx, ref,
                      same_mask(x.detach(), gy, y.detach(), dx))
                exact("fused_dropout", f"{label}, the kernel on g",
                      kpt._dropout(gy, sd, rate), ref)
            # the noise kernel's scalar path (csrc/perturb.cu): a level-0
            # in-example count plus 1 and plus 7 (no whole vectors a row),
            # then x and g one element past their allocations' start
            inner = c * hw * hw
            for extra in (1, 7):
                x, gy = (torch.randn((BATCH, inner + extra), generator=g,
                                     device=self.dev).to(dtype)
                         for _ in range(2))
                label = f"feature noise [{BATCH}, {inner} + {extra}] {dname}"
                y, dx = run(kpt.fused_feature_noise, x, gy, sd)
                exact("feature_noise", label, y,
                      kpt.feature_noise_plain(x, sd, 0.3))
                exact("feature_noise", f"{label} bwd", dx,
                      kpt.feature_noise_plain(gy, sd, 0.3))
            xb, gb = (torch.randn(n0 + 1, generator=g,
                                  device=self.dev).to(dtype)
                      for _ in range(2))
            xb.requires_grad_()
            x, gy = (t[1:].view(BATCH, c, hw, hw) for t in (xb, gb))
            label = (f"feature noise [{BATCH},{c},{hw},{hw}] at a "
                     f"one-element offset {dname}")
            y = kpt.fused_feature_noise(x, sd)
            y.backward(gy)
            self.sync()
            exact("feature_noise", label, y.detach(),
                  kpt.feature_noise_plain(x.detach(), sd, 0.3))
            exact("feature_noise", f"{label} bwd", xb.grad[1:].view(x.shape),
                  kpt.feature_noise_plain(gy, sd, 0.3))
            # feature dropout's odd cases (csrc/perturb.cu): C = 13, 40 and
            # 300 (a short last channel group; 300: 38 groups, two rounds
            # of the attention pass), H x W = 37 x 70 (no whole vectors:
            # the scalar path of both passes) and 16 x 24 (the vector
            # path), B = 1 to 3; then x and g one element past their
            # allocations' start at the level-0 shape (misaligned: the
            # scalar path), forward, backward and the kernel on g
            for bsz, c_odd, (h, wd) in FDROP_ODD:
                x, gy = (torch.randn((bsz, c_odd, h, wd), generator=g,
                                     device=self.dev).to(dtype)
                         for _ in range(2))
                fdrop_case(x, gy, sd,
                           f"feature dropout [{bsz},{c_odd},{h},{wd}] "
                           f"{dname}")
            xb, gb = (torch.randn(n0 + 1, generator=g,
                                  device=self.dev).to(dtype)
                      for _ in range(2))
            xb.requires_grad_()
            x, gy = (t[1:].view(BATCH, c, hw, hw) for t in (xb, gb))
            label = (f"feature dropout [{BATCH},{c},{hw},{hw}] at a "
                     f"one-element offset {dname}")
            y = kpt.fused_feature_dropout(x, sd)
            y.backward(gy)
            self.sync()
            x, y = x.detach(), y.detach()
            dx = xb.grad[1:].view(x.shape)
            ref = kpt.feature_dropout_bwd_plain(x, gy, sd)
            exact("feature_dropout", label, y,
                  kpt.feature_dropout_plain(x, sd))
            exact("feature_dropout_bwd", f"{label} bwd", dx, ref,
                  same_mask(x, gy, y, dx))
            _, att, mx = kpt._fdrop_fwd(x, sd)
            exact("feature_dropout_bwd", f"{label}, the kernel on g",
                  kpt._fdrop_bwd(gy, sd, att, mx), ref)
        self._perturb_distributions(bad)

        def unc_fwd(label, logits, w):
            var, ps = kun.uncertainty_fwd(logits, w)
            self.sync()
            rvar, rps = kun.uncertainty_fwd_plain(logits, w)
            err = float((var - rvar).abs().max())
            errs["uncertainty_fwd"] = max(errs["uncertainty_fwd"], err)
            agree = float((ps == rps).float().mean())
            x64 = torch.stack([lg.double() for lg in logits])
            mix = torch.einsum("d,dbhwc->bhwc", w.double(),
                               torch.softmax(x64, -1))
            diff = ps != rps
            gap = float((mix.gather(-1, ps.long()[..., None])
                         - mix.gather(-1, rps.long()[..., None]))[diff]
                        .abs().max()) if bool(diff.any()) else 0.0
            ok = (var.shape == rvar.shape and ps.dtype == torch.int32
                  and ps.is_contiguous()
                  and torch.allclose(var, rvar, rtol=1e-5, atol=1e-5)
                  and agree >= 0.9999 and gap <= 2e-6)
            log(f"uncertainty fwd {label} f32: var max_abs_err {err:.3e} "
                f"(rtol = atol = 1e-5); pseudo agree {agree:.7f} (min "
                f"0.9999), {int(diff.sum())} differ, largest mix gap there "
                f"{gap:.2e} (max 2e-6) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(f"uncertainty fwd {label}")

        g = self.gen(SEED + 310)
        for b, h, wd in LOSS_ODD_SHAPES:
            for d in UNC_ODD_DECODERS:
                for c in LOSS_ODD_CLASSES:
                    for layout in LOSS_ODD_LAYOUTS:
                        w = torch.empty(d, device=self.dev).exponential_(
                            generator=g)
                        unc_fwd(f"{d} x [{b},{h},{wd},{c}] {layout}",
                                [self._odd_logits(g, b, h, wd, c, layout, 3.0)
                                 for _ in range(d)], w / w.sum())
        logits, w, gv = self._unc_case(SEED + 300)
        unc_fwd(f"{N_DEC} x {list(logits[0].shape)}", logits, w)
        dx = kun.uncertainty_bwd(logits, gv)
        self.sync()
        rdx = kun.uncertainty_bwd_plain(logits, gv)
        err = max(float((a - b).abs().max()) for a, b in zip(dx, rdx))
        errs["uncertainty_bwd"] = err
        # the kernel writes dlogits through the logits' strides (the plain
        # version of a CPU rehearsal returns contiguous tensors)
        ok = ((self.dev.type != "cuda" or all(
            a.stride() == lg.stride() for a, lg in zip(dx, logits)))
              and all(torch.allclose(a, b, rtol=1e-5, atol=1e-5)
                      for a, b in zip(dx, rdx)))
        log(f"uncertainty bwd: dlogits max_abs_err {err:.3e} (max "
            f"|dlogits| {max(float(b.abs().max()) for b in rdx):.3e}; "
            f"rtol = atol = 1e-5) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            bad.append("uncertainty bwd")
        for name, e in errs.items():
            self.report["kernels"][name] = {"max_abs_err": e}
        if bad:
            raise AssertionError(f"UAPS kernel mismatches: {bad}")

    def _perturb_distributions(self, bad):
        """The generator's distributions on the card, at the level-0 shape
        [16, 16, 256, 256] (16.8 M elements)."""
        from uaps_tpu_torch.kernels import perturb as kpt
        torch = self.torch
        c, hw = LEVELS[0]
        sd = torch.tensor(20260, device=self.dev)
        ones = torch.ones((BATCH, c, hw, hw), device=self.dev)
        for rate in (0.5, 0.05):
            y = kpt.fused_dropout(ones, sd, rate)
            zero = float((y == 0).float().mean())
            scale = float(torch.tensor(1.0 / (1.0 - rate)))
            ok = (abs(zero - rate) < 0.01 and bool((y[y != 0] == scale).all())
                  and not torch.equal(y[0], y[1]))
            log(f"dropout p={rate} over {y.numel()} elements: zero share "
                f"{zero:.6f}, survivors = 1/(1-p), masks differ per example "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(f"dropout distribution p={rate}")
        # the draw itself lies in [-r, r); x * (1 + u) - 1 at x = 1 within
        # an ulp of 1.3 of it
        nz = kpt.noise_draw(sd, ones.shape[1:])
        u = kpt.fused_feature_noise(ones, sd) - 1.0
        shared = all(bool(torch.equal(u[0], u[b])) for b in range(BATCH))
        ok = (bool((nz >= -0.3).all()) and bool((nz < 0.3).all())
              and float(u.min()) >= -0.3 - 1e-6
              and float(u.max()) <= 0.3 + 1e-6
              and abs(float(u.mean())) < 0.01 and shared)
        log(f"feature noise: draw in [{float(nz.min()):.7f}, "
            f"{float(nz.max()):.7f}] (in [-0.3, 0.3)), output - 1 in "
            f"[{float(u.min()):.7f}, {float(u.max()):.7f}], mean "
            f"{float(u.mean()):.2e}, shared across the batch {shared} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            bad.append("feature noise distribution")
        g = self.gen(SEED + 250)
        x = torch.randn((BATCH, c, hw, hw), generator=g,
                        device=self.dev).abs()
        y = kpt.fused_feature_dropout(x, sd)
        att = kpt.channel_mean(x)
        scale = kpt.fdrop_scale(sd)
        fracs = []
        for b in range(BATCH):
            kept = y[b, 0] != 0
            mx = float(att[b].max())
            thr = float(att[b].max() * scale)   # f32, as the kernel forms it
            t_lo, t_hi = float(att[b][kept].max()), float(att[b][~kept].min())
            fracs.append((t_lo / mx, t_hi / mx))
            ok = (t_lo < thr <= t_hi and 0.7 * mx <= t_hi
                  and t_lo <= 0.9 * mx
                  and bool(torch.equal(y[b][:, kept], x[b][:, kept])))
            if not ok:
                bad.append(f"feature dropout threshold, example {b}")
        log(f"feature dropout: scale {float(scale):.6f}; per example, kept "
            f"attention below and dropped at or above scale x max "
            f"(fractions of max from {min(f[0] for f in fracs):.4f} to "
            f"{max(f[1] for f in fracs):.4f})")

    # ------------------------------------------------------------ phase 10
    def _run_steps(self, cfg, batches, warmup, steps, key, label, per_step):
        """`warmup` + `steps` UAPS steps of `cfg` from seeded weights, with
        the launch counters read around them (the path's run): finite
        metrics, per_step launches a step, times[key + "_step_ms"] and the
        peak memory; returns (model, state, step, initial state dict,
        launches)."""
        import numpy as np
        from uaps_tpu_torch.methods import get_method
        torch = self.torch
        method = get_method("uaps")
        state, model = method.init_state(
            cfg, self.dev, torch.Generator().manual_seed(SEED))
        init_sd = {k: v.detach().clone() for k, v in
                   model.state_dict().items()}
        step = method.make_train_step(cfg, model)
        self.sync()
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_counters()       # this path's run starts here
        losses, step_ms = [], []
        n_steps = warmup + steps
        for i in range(n_steps):
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            self.sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(v) for k, v in m.items()})
        launches = counters()   # ... and ends here
        timed = step_ms[warmup:]
        t = self.report["times"]
        t[f"{key}_step_ms"] = {"median": statistics.median(timed),
                               "min": min(timed), "max": max(timed),
                               "all": step_ms}
        if self.dev.type == "cuda":
            t[f"{key}_peak_mem_gib"] = (torch.cuda.max_memory_allocated()
                                        / 2 ** 30)
        b = cfg.data.batch_size
        log(f"{label} losses: "
            + ", ".join(f"{m['loss']:.4f}" for m in losses))
        log(f"launches over {n_steps} {label} steps: {json.dumps(launches)}")
        log(f"time {label} step bf16 B={b}+{b} {cfg.data.image_size} (host "
            f"clock, sync each step): median {statistics.median(timed):.3f} "
            f"ms [min {min(timed):.3f}, max {max(timed):.3f}] over {steps} "
            f"steps; peak memory "
            f"{t.get(f'{key}_peak_mem_gib', 0.0):.3f} GiB")
        self.report[key] = {"losses": losses, "launches": launches}
        assert all(np.isfinite(v) for m in losses for v in m.values()), \
            f"non-finite {label} metrics"
        want = {k: v * n_steps for k, v in per_step.items()}
        assert launches == want, (launches, want)
        return model, state, step, init_sd, launches

    def _pair_past_ramp(self, cfg, plain_cfg, init_sd, batch, per_step,
                        label):
        """One step of `cfg` on the kernel path and one of `plain_cfg` past
        the ramp (w1 = w2 = 0.1) from the same weights, batch, seeds and
        mix_w, within phase 10's bf16 gates on every loss term."""
        from uaps_tpu_torch.methods import get_method
        torch = self.torch
        mcfg = cfg.method
        ramp_end = int(mcfg.ramp_iters * mcfg.consistency_rampup)
        batch = dict(batch, mix_w=torch.tensor([0.4, 0.3, 0.2, 0.1],
                                               device=self.dev))
        (km, kmet, _), (pm, pmet, _) = self._step_pair(
            get_method("uaps"), cfg, plain_cfg, init_sd, batch, per_step,
            step=ramp_end)
        assert abs(kmet["consistency_w1"] - 0.1) < 1e-7, kmet
        assert abs(kmet["consistency_w2"] - 0.1) < 1e-7, kmet
        return self._compare_steps(
            km, pm, kmet, pmet, init_sd, cfg.optim.base_lr,
            terms=("loss", "sup_loss", "ps_loss", "uncertainty_loss"),
            label=label)

    def _uaps_config(self, **model_kw):
        """The UAPS slice as `python -m uaps_tpu_torch.train --preset neu
        --method uaps --dtype bfloat16 --dataset synthetic` builds it, with
        `model_kw` on top (and BATCH, HW where a rehearsal shrinks them)."""
        from uaps_tpu_torch.utils.cli import parse_args
        cfg, _ = parse_args(["--preset", "neu", "--method", "uaps",
                             "--dtype", "bfloat16", "--dataset",
                             "synthetic"])
        cfg.model = dataclasses.replace(cfg.model, **model_kw)
        if (cfg.data.batch_size, cfg.data.image_size) != (BATCH, (HW, HW)):
            cfg.data = dataclasses.replace(cfg.data, batch_size=BATCH,
                                           image_size=(HW, HW))
        return cfg

    def uaps_training(self):
        """The UAPS slice at full width (see phase 10 in the module
        docstring)."""
        import numpy as np
        from uaps_tpu_torch.data import SyntheticDefects
        from uaps_tpu_torch.serve import InferenceEngine
        from uaps_tpu_torch.train import to_device
        cfg = self._uaps_config()
        assert (cfg.model.name, cfg.model.compute_dtype,
                cfg.model.dropout_backend, cfg.model.n_aux + 1) == (
                    "unet_uaps", "bfloat16", "auto", N_DEC), cfg
        t0 = time.perf_counter()
        data = SyntheticDefects(cfg.data, seed=SEED)
        it = data.train_iter()
        batches = [to_device(next(it), self.dev)
                   for _ in range(TRAIN_WARMUP + TRAIN_STEPS + 1)]
        log(f"UAPS data: {len(batches)} synthetic batches of {BATCH} + "
            f"{BATCH} images in {time.perf_counter() - t0:.1f} s")
        model, state, step, init_sd, self.uaps_launches = self._run_steps(
            cfg, batches, TRAIN_WARMUP, TRAIN_STEPS, "uaps", "UAPS",
            UAPS_STEP_LAUNCHES)
        t = self.report["times"]
        t["uaps_imgs_per_s"] = (2 * BATCH / t["uaps_step_ms"]["median"]
                                * 1e3)
        log(f"UAPS: {t['uaps_imgs_per_s']:.1f} imgs/s (labelled + "
            "unlabelled, at the median step)")
        # one step on each path past the ramp, every perturbation on
        self.report["uaps"]["kernel_vs_plain"] = self._pair_past_ramp(
            cfg, self._uaps_config(conv_backend="xla"), init_sd,
            batches[-1], UAPS_STEP_LAUNCHES, "kernel vs plain")

        engine = InferenceEngine(cfg, state_dict=model.state_dict(),
                                 device=self.dev)
        imgs = np.random.default_rng(SEED).integers(
            0, 256, (BATCH, HW, HW, 3), dtype=np.uint8)
        u = engine.uncertainty(imgs)
        again = engine.uncertainty(imgs)
        log(f"InferenceEngine.uncertainty: {u.shape} {u.dtype}, mean "
            f"{float(u.mean()):.4e}, max {float(u.max()):.4e}; repeatable "
            f"{bool((u == again).all())}")
        assert (u.shape == (BATCH, HW, HW) and np.isfinite(u).all()
                and (u == again).all() and float(u.min()) > -1e-5)
        self.uaps_model, self.uaps_state = model, state
        self.uaps_step, self.uaps_batch = step, batches[0]

    # ------------------------------------------------------------ phase 11
    def uaps_times(self):
        """Per UAPS kernel and step shape (bf16 perturbations, f32
        uncertainty): ms with the L2 flushed before each call, the plain
        version's and the library call's, and the bound; the kernels' rows
        sum them per step by launches. Then a profile of 2 UAPS steps."""
        import torch.nn.functional as F
        from uaps_tpu_torch.kernels import perturb as kpt
        from uaps_tpu_torch.kernels import uncertainty as kun
        torch = self.torch
        bf = torch.bfloat16
        rows = {k: [] for k in ("fused_dropout", "feature_noise",
                                "feature_dropout", "feature_dropout_bwd",
                                "uncertainty_fwd", "uncertainty_bwd")}

        def add(name, label, per_step, kern, plain, lib, nbytes, ops, kind):
            row = {"shape": label, "per_step": per_step,
                   "ms": self.time_ms(kern, cold=True),
                   "plain_ms": self.time_ms(plain, cold=True),
                   "library_ms": (None if lib is None
                                  else self.time_ms(lib, cold=True))}
            row["bound_ms"], row["bound_by"] = bound(nbytes, ops, kind)
            rows[name].append(row)
            lib_s = ("-" if lib is None else f"{row['library_ms']:.4f} ms")
            log(f"time {name} {label} x{per_step}/step: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"library {lib_s}, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")

        for lvl, (c, hw) in enumerate(LEVELS):
            x, gy, sd = self._level_case(lvl, bf, SEED + 200 + lvl)
            with torch.no_grad():
                _, att, mx = kpt._fdrop_fwd(x, sd)
            n = x.numel() * 2
            # feature dropout's bytes: x read, out and att written; g and
            # att read, dx written
            n_fdrop = 2 * n + att.numel() * 4
            label = f"[{BATCH},{c},{hw},{hw}]"
            add("fused_dropout", label, PER_LEVEL["fused_dropout"],
                lambda: kpt._dropout(x, sd, 0.5),
                lambda: kpt.dropout_plain(x, sd, 0.5),
                lambda: F.dropout(x, 0.5, training=True), 2 * n, 0, "bf16")
            add("feature_noise", label, PER_LEVEL["feature_noise"],
                lambda: kpt._noise(x, sd, 0.3),
                lambda: kpt.feature_noise_plain(x, sd, 0.3), None,
                2 * n, 0, "bf16")
            add("feature_dropout", label, PER_LEVEL["feature_dropout"],
                lambda: kpt._fdrop_fwd(x, sd),
                lambda: kpt.feature_dropout_plain(x, sd), None,
                n_fdrop, 0, "bf16")
            add("feature_dropout_bwd", label,
                PER_LEVEL["feature_dropout_bwd"],
                lambda: kpt._fdrop_bwd(gy, sd, att, mx),
                lambda: kpt.feature_dropout_bwd_plain(x, gy, sd), None,
                n_fdrop, 0, "bf16")
        logits, w, gv = self._unc_case(SEED + 300)
        px = BATCH * HW * HW
        label = f"{N_DEC} x [{BATCH},{HW},{HW},{NUM_CLASSES}] f32"
        add("uncertainty_fwd", label, 1,
            lambda: kun.uncertainty_fwd(logits, w),
            lambda: kun.uncertainty_fwd_plain(logits, w), None,
            N_DEC * px * NUM_CLASSES * 4 + N_DEC * px * 4 + px * 4,
            N_DEC * px * NUM_CLASSES * 12, "f32")
        add("uncertainty_bwd", label, 1,
            lambda: kun.uncertainty_bwd(logits, gv),
            lambda: kun.uncertainty_bwd_plain(logits, gv), None,
            2 * N_DEC * px * NUM_CLASSES * 4 + N_DEC * px * 4,
            N_DEC * px * NUM_CLASSES * 20, "f32")
        t = self.report["times"]
        t["uaps_kernels"] = rows
        for name, rs in rows.items():
            def per_step(key):
                return sum(r[key] * r["per_step"] for r in rs)
            by_bytes = sum(r["bound_ms"] * r["per_step"] for r in rs
                           if r["bound_by"] == "bytes")
            self.report["kernels"][name].update(
                ms=per_step("ms"), plain_ms=per_step("plain_ms"),
                library_ms=(None if rs[0]["library_ms"] is None
                            else per_step("library_ms")),
                bound_ms=per_step("bound_ms"),
                bound_by=("bytes" if by_bytes * 2 >= per_step("bound_ms")
                          else "operations"))
            k = self.report["kernels"][name]
            log(f"per UAPS step, {name}: kernel {k['ms']:.4f} ms, plain "
                f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms")
        self.profile_steps("uaps", "UAPS", self.uaps_step, self.uaps_state,
                           self.uaps_batch, t["uaps_step_ms"]["median"],
                           UAPS_STEP_LAUNCHES)

    # ------------------------------------------------------------ phase 12
    def _chain_case(self, cin, cout, hw, dtype, seed, batch=BATCH):
        """x [B, Cin, H, W] (a raw conv output where the prologue reads it),
        w [3, 3, Cin, Cout] (scaled as lecun_normal), BN's f and s [Cin] f32,
        the cotangents of (y, s1, s2) and a seed, on the card; hw is H = W
        or (H, W)."""
        torch = self.torch
        g = self.gen(seed)
        h, wd = hw if isinstance(hw, tuple) else (hw, hw)
        x = torch.randn((batch, cin, h, wd), generator=g,
                        device=self.dev).to(dtype)
        w = (torch.randn((3, 3, cin, cout), generator=g, device=self.dev)
             / (9 * cin) ** 0.5).to(dtype)
        f = torch.rand(cin, generator=g, device=self.dev) + 0.5
        s = torch.randn(cin, generator=g, device=self.dev) * 0.1
        gy = torch.randn((batch, cout, h, wd), generator=g,
                         device=self.dev).to(dtype)
        ds1 = torch.randn(cout, generator=g, device=self.dev) * 0.3
        ds2 = torch.randn(cout, generator=g, device=self.dev) * 0.1
        sd = torch.randint(0, 2 ** 31 - 1, (), generator=g, device=self.dev)
        return x, w, f, s, gy, ds1, ds2, sd

    def chain_kernels(self):
        """The fused-ConvBlock kernels against their plain versions at every
        block shape of a neu UAPS step (B=16), f32 and bf16, forward and
        backward: each block's conv1 as chain_conv_plain, its conv2 as
        chain_conv_bnl at the level's dropout rate and, for the dropout-free
        blocks, as conv3x3_bnl. Tolerances (tol = 1e-4 in f32, 1e-2 in
        bf16): y and dx rtol = atol = tol; dW within tol x max |dW|; the
        moments within tol x the sum of their terms' magnitudes (s1: sum |y|,
        s2 itself; in bf16 the kernel sums the f32 accumulator, the plain
        version the bf16 output, as JAX's kernel and twin differ); df and ds
        within tol x the sums of |dz x| and |dz| / (1 - rate). The dropout
        keep-mask bit for bit: with Cin = Cout and a centre-tap identity
        weight the conv's output is z, equal to the plain prologue's z, zero
        exactly where the mask drops, and the backward zeroes the same
        elements."""
        from uaps_tpu_torch.kernels import block_conv as kbc
        from uaps_tpu_torch.kernels import conv_bnl as kbnl
        from uaps_tpu_torch.kernels.conv3x3_nchw import conv3x3_nchw_plain
        torch = self.torch
        errs = dict.fromkeys(CHAIN_COUNTERS, 0.0)
        bad = []

        def check(name, label, got, ref, tol, scale=None):
            """rtol = atol = tol elementwise, or |err| <= tol * scale."""
            got, ref = got.float(), ref.float()
            err = float((got - ref).abs().max())
            errs[name] = max(errs[name], err)
            if scale is None:
                ok = bool(torch.isfinite(got).all()) and torch.allclose(
                    got, ref, rtol=tol, atol=tol)
                note = f"(rtol = atol = {tol})"
            else:
                lim = tol * scale
                ok = bool(torch.isfinite(got).all()) and bool(
                    ((got - ref).abs() <= lim).all())
                note = f"(limit {tol} x scale, max {float(lim.max()):.3e})"
            log(f"{label}: max_abs_err {err:.3e} {note} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(label)

        def chain_case(x, w, f, s, gy, ds1, ds2, sd, rate, label, tol):
            """ds1 or ds2 None: that moment takes no cotangent (autograd
            hands the backward None, which adds nothing to the fold)."""
            pro = f is not None
            name = "chain_conv_bnl" if pro else "chain_conv_plain"
            ins = [t.clone().requires_grad_() if t is not None else None
                   for t in (x, f, s, w)]
            if pro:
                y, s1, s2 = kbc.chain_conv_bnl(*ins, sd, rate)
            else:
                y, s1, s2 = kbc.chain_conv_plain(ins[0], ins[3])
            outs = [(o, c) for o, c in ((y, gy), (s1, ds1), (s2, ds2))
                    if c is not None]
            torch.autograd.backward([o for o, _ in outs],
                                    [c for _, c in outs])
            self.sync()
            with torch.no_grad():
                ry, r1, r2 = (kbc.chain_bnl_ref(x, f, s, w, sd, rate) if pro
                              else kbc.chain_plain_ref(x, w))
                # the backward from the kernel's own y, as autograd gives it
                ge = kbc.fold_plain(gy, y, ds1, ds2)
                rdx, rdw, rdf, rds = kbc.chain_bwd_plain(ge, x, w, f, s, sd,
                                                         rate)
                w_rot = w.flip((0, 1)).transpose(2, 3)
                dz = conv3x3_nchw_plain(ge, w_rot, torch.float32).abs()
            check(name, f"{label} y", y, ry, tol)
            check(name, f"{label} s1", s1, r1, tol,
                  ry.float().abs().sum((0, 2, 3)))
            check(name, f"{label} s2", s2, r2, tol, r2)
            check(name + "_bwd", f"{label} dx", ins[0].grad, rdx, tol)
            check(name + "_bwd", f"{label} dW", ins[3].grad, rdw, tol,
                  rdw.abs().max())
            if pro:
                keep = 1.0 / (1.0 - rate)
                check(name + "_bwd", f"{label} df", ins[1].grad, rdf, tol,
                      (dz * x.float().abs()).sum((0, 2, 3)) * keep)
                check(name + "_bwd", f"{label} ds", ins[2].grad, rds, tol,
                      dz.sum((0, 2, 3)) * keep)
            return ry

        def bnl_case(x, w, f, s, gy, label, tol):
            ins = [t.clone().requires_grad_() for t in (x, f, s, w)]
            y = kbnl.conv3x3_bnl(*ins)
            y.backward(gy)
            self.sync()
            with torch.no_grad():
                ry = kbnl.conv3x3_bnl_ref(x, f, s, w)
                rdx, rdw, rdf, rds = kbc.chain_bwd_plain(gy, x, w, f, s,
                                                         None, 0.0)
                w_rot = w.flip((0, 1)).transpose(2, 3)
                dz = conv3x3_nchw_plain(gy, w_rot, torch.float32).abs()
            check("conv3x3_bnl", f"{label} y", y, ry, tol)
            check("conv3x3_bnl_bwd", f"{label} dy", ins[0].grad, rdx, tol)
            check("conv3x3_bnl_bwd", f"{label} dW", ins[3].grad, rdw, tol,
                  rdw.abs().max())
            check("conv3x3_bnl_bwd", f"{label} df", ins[1].grad, rdf, tol,
                  (dz * x.float().abs()).sum((0, 2, 3)))
            check("conv3x3_bnl_bwd", f"{label} ds", ins[2].grad, rds, tol,
                  dz.sum((0, 2, 3)))

        def mask_case(x, f, s, sd, rate, label):
            """The keep-mask through a centre-tap identity weight."""
            c = x.shape[1]
            w = torch.zeros((3, 3, c, c), device=self.dev)
            w[1, 1] = torch.eye(c, device=self.dev)
            w = w.to(x.dtype)
            xr = x.clone().requires_grad_()
            y, _, _ = kbc.chain_conv_bnl(xr, f, s, w, sd, rate)
            y.backward(torch.ones_like(y))
            self.sync()
            with torch.no_grad():
                z = kbc.prologue_plain(x, f, s, sd, rate)
                live = kbc.prologue_plain(x, f, s, None, 0.0) != 0
                keep = kbc.hash_keep(sd, x.shape, rate)
            same = bool(torch.equal(y.detach(), z))
            mask = bool(torch.equal(y.detach() != 0, keep & live))
            bwd = bool((xr.grad[~keep] == 0).all())
            drop = 1.0 - float(keep.float().mean())
            ok = same and mask and bwd and abs(drop - rate) < 0.01
            log(f"{label} keep-mask: y = z bit for bit {same}, nonzeros = "
                f"kept (of the nonzero z) {mask}, backward zero where "
                f"dropped {bwd}, dropped share {drop:.6f} (p = {rate}) "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(f"{label} keep-mask")

        for dname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            tol = 1e-4 if dname == "f32" else 1e-2
            for i, (blk, cin, cout, hw, rate, _) in enumerate(CHAIN_BLOCKS):
                x, w, _, _, gy, ds1, ds2, sd = self._chain_case(
                    cin, cout, hw, dtype, SEED + 400 + i)
                chain_case(x, w, None, None, gy, ds1, ds2, sd, 0.0,
                           f"chain plain {blk}.0 {cin}->{cout} @{hw} "
                           f"{dname}", tol)
                x, w, f, s, gy, ds1, ds2, sd = self._chain_case(
                    cout, cout, hw, dtype, SEED + 420 + i)
                chain_case(x, w, f, s, gy, ds1, ds2, sd, rate,
                           f"chain bnl {blk}.4 {cout}->{cout} @{hw} p={rate} "
                           f"{dname}", tol)
                if rate > 0:
                    mask_case(x, f, s, sd, rate,
                              f"chain bnl {blk}.4 @{hw} p={rate} {dname}")
                else:
                    bnl_case(x, w, f, s, gy, f"conv3x3_bnl {blk}.4 "
                             f"{cout}->{cout} @{hw} {dname}", tol)
            # where the tensor-core dgrads and wgrad pad and mask, and the
            # dgrad with the prologue takes its scalar epilogue (W = 70;
            # Cin 72: two channel groups write one df/ds slot), with both
            # moment cotangents, s1's alone and none (bf16)
            for i, (cin, cout) in enumerate(ODD_CHAIN):
                x, w, f, s, gy, ds1, ds2, sd = self._chain_case(
                    cin, cout, ODD_HW, dtype, SEED + 440 + i, ODD_BATCH)
                odd = (f"odd {cin}->{cout} @{ODD_HW[0]}x{ODD_HW[1]} "
                       f"B={ODD_BATCH}")
                chain_case(x, w, None, None, gy, ds1, ds2, sd, 0.0,
                           f"chain plain {odd} {dname}", tol)
                for d1, d2, rate, cots in ((ds1, ds2, 0.1, "ds1+ds2"),
                                           (ds1, None, 0.1, "ds1"),
                                           (None, None, 0.0, "no ds")):
                    chain_case(x, w, f, s, gy, d1, d2, sd, rate,
                               f"chain bnl {odd} p={rate} {cots} {dname}",
                               tol)
        self._route_by_dtype(bad)
        for name, e in errs.items():
            self.report["kernels"][name] = {"max_abs_err": e}
        if bad:
            raise AssertionError(f"fused-block kernel mismatches: {bad}")

    def _lead_in(self):
        """Inside a profiler window, before the kernels it counts:
        ROUTE_LEAD_IN int16 adds and a ~2 ms spin (no idle gap after them).
        On the H100 the profiler missed the first 1-3 kernels after it
        started, the counted ones when they came first (PERF.md section 7);
        lead_in_kernel tells these apart."""
        torch = self.torch
        lead = torch.zeros(1, dtype=torch.int16, device=self.dev)
        for _ in range(ROUTE_LEAD_IN):
            lead.add_(1)
        torch.cuda._sleep(1 << 22)

    def _profiled(self, fn):
        """The torch.profiler window of the lead-in, then fn(). Where the
        profiler recorded no kernel of the lead-in's end (its spin), what
        it missed at the window's start may reach past the lead-in into
        the counted kernels (one run lost 11 of the 64 adds, another a
        step's first conv forward): the window runs again, up to
        LEAD_IN_TRIES times in all, and the last is returned."""
        from torch.profiler import ProfilerActivity, profile
        cuda = self.torch.autograd.DeviceType.CUDA
        for attempt in range(1, LEAD_IN_TRIES + 1):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                self._lead_in()
                fn()
                self.sync()
            if any(e.device_type == cuda and "spin_kernel" in e.key
                   for e in prof.key_averages()):
                break
            log(f"the profiler missed the lead-in's spin (window {attempt} "
                f"of {LEAD_IN_TRIES})")
        return prof

    def _route(self, fn, calls):
        """route_of the device entries of `calls` fn() calls, after one
        unprofiled call (builds, loads) and, inside the profiler, the
        lead-in. Also how many of the lead-in's adds it recorded."""
        torch = self.torch
        cuda = torch.autograd.DeviceType.CUDA
        fn()
        self.sync()
        prof = self._profiled(lambda: [fn() for _ in range(calls)])
        entries = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_type == cuda]
        seen = sum(n for name, n in entries
                   if "add" in name and "short" in name)
        return route_of(entries), seen

    def _route_by_dtype(self, bad):
        """From the profiler's kernel names: a plain chain conv forward and
        its backward (dgrad + wgrad), one chain_conv_bnl backward (p = 0.1:
        the dgrad with the prologue + wgrad), one conv3x3_nchw forward and
        one conv3x3_nchw_wgrad, ROUTE_CALLS times, launch the tensor-core
        kernels in bf16 and none of them in f32."""
        from uaps_tpu_torch.kernels import block_conv as kbc
        from uaps_tpu_torch.kernels import conv3x3_nchw as kc
        torch = self.torch
        want = {"bf16": {"wgrad_mma_kernel": 3, "dgrad_mma_kernel": 1,
                         "conv_fwd_mma_kernel": 1, "block_fwd_mma_kernel": 1,
                         "nhwc_fwd_mma_kernel": 0, "bnl_bwd_mma_kernel": 1,
                         "wgrad_partial_kernel": 0,
                         "block_conv_dgrad_kernel": 0,
                         "conv3x3_fwd_kernel": 0, "block_conv_fwd_kernel": 0,
                         "conv3x3_nhwc_fwd_kernel": 0,
                         **dict.fromkeys(FDROP_ROUTE, 0),
                         **dict.fromkeys(CE_DICE_ROUTE, 0)},
                "f32": {"wgrad_mma_kernel": 0, "dgrad_mma_kernel": 0,
                        "conv_fwd_mma_kernel": 0, "block_fwd_mma_kernel": 0,
                        "nhwc_fwd_mma_kernel": 0, "bnl_bwd_mma_kernel": 0,
                        "wgrad_partial_kernel": 3,
                        "block_conv_dgrad_kernel": 2,
                        "conv3x3_fwd_kernel": 1, "block_conv_fwd_kernel": 1,
                        "conv3x3_nhwc_fwd_kernel": 0,
                        **dict.fromkeys(FDROP_ROUTE, 0),
                        **dict.fromkeys(CE_DICE_ROUTE, 0)}}
        for dname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            x, w, f, s, gy, ds1, ds2, sd = self._chain_case(
                40, 13, ODD_HW, dtype, SEED + 460, ODD_BATCH)
            y = kbc.chain_conv_plain(x, w)[0]
            yb = kbc.chain_conv_bnl(x, f, s, w, sd, 0.1)[0]

            def run():   # the chain convs both ways, on this thread
                kbc.chain_conv_plain(x, w)
                kbc._backward(gy, ds1, ds2, y, x, None, None, w, None, 0.0,
                              True)
                kbc._backward(gy, ds1, ds2, yb, x, f, s, w, sd, 0.1, True)
                kc.conv3x3_nchw(x, w)
                kc.conv3x3_nchw_wgrad(x, gy)
            got, seen = self._route(run, ROUTE_CALLS)
            want[dname] = {k: n * ROUTE_CALLS for k, n in want[dname].items()}
            ok = got == want[dname]
            self.report.setdefault("route", {})[f"calls_{dname}"] = got
            log(f"route of {ROUTE_CALLS} chain plain forwards and backwards "
                f"+ chain bnl backwards + conv forwards and wgrads, "
                f"{dname}: {json.dumps(got)} {'ok' if ok else 'MISMATCH'} "
                f"(want {json.dumps(want[dname])}; the profiler recorded "
                f"{seen} of the {ROUTE_LEAD_IN} lead-in kernels)")
            if not ok:
                bad.append(f"route {dname}")

    # ------------------------------------------------------------ phase 13
    def _no_level01_dropout(self, model):
        """Encoder dropout off at levels 0-1, where the chain blocks draw the
        position-hash mask and the plain path the generator's (phase 12
        holds the hashed mask to its plain version)."""
        for block in (model.encoder.in_conv,
                      model.encoder.down1.maxpool_conv[1]):
            block.conv_conv[3].rate = 0.0

    def chain_training(self):
        """The chain and fused UAPS steps at full width (see phase 13 in the
        module docstring)."""
        import numpy as np
        from uaps_tpu_torch.data import SyntheticDefects
        from uaps_tpu_torch.methods import base, get_method
        from uaps_tpu_torch.serve import InferenceEngine
        from uaps_tpu_torch.train import to_device
        torch = self.torch
        data = SyntheticDefects(self._uaps_config().data, seed=SEED)
        it = data.train_iter()
        batches = [to_device(next(it), self.dev)
                   for _ in range(TRAIN_WARMUP + TRAIN_STEPS + 1)]
        val = to_device(next(data.val_iter(1)), self.dev)
        method = get_method("uaps")
        self.fused_paths, self.fused_launches = {}, {}
        for backend, per_step, blocks in (
                ("chain", CHAIN_STEP_LAUNCHES,
                 ("encoder.in_conv.", "encoder.down1.", ".up3.", ".up4.")),
                ("fused", FUSED_STEP_LAUNCHES, (".up3.", ".up4."))):
            cfg = self._uaps_config(conv_backend=backend)
            model, state, step, init_sd, launches = self._run_steps(
                cfg, batches, TRAIN_WARMUP, TRAIN_STEPS, backend,
                f"{backend} UAPS", per_step)
            self.fused_launches[backend] = launches

            # one step on each path past the ramp, every perturbation on
            mcfg = cfg.method
            ramp_end = int(mcfg.ramp_iters * mcfg.consistency_rampup)
            batch = dict(batches[-1], mix_w=torch.tensor(
                [0.4, 0.3, 0.2, 0.1], device=self.dev))
            (km, kmet, _), (pm, pmet, _) = self._step_pair(
                method, cfg, self._uaps_config(conv_backend="xla"), init_sd,
                batch, per_step, step=ramp_end,
                prepare=(self._no_level01_dropout if backend == "chain"
                         else None))
            # the fused blocks' conv biases fold into BN: no gradient
            none = {k for k, p in km.named_parameters() if p.grad is None}
            want_none = {k for k, _ in km.named_parameters()
                         if k.endswith(("conv_conv.0.bias", "conv_conv.4.bias"))
                         and any(b in k for b in blocks)}
            assert none == want_none, sorted(none ^ want_none)
            log(f"{backend}: {len(none)} fused-block conv biases have no "
                "gradient (left out of the comparison)")
            # the same pair in f32, where the two paths round alike
            (k32, k32met, _), (p32, p32met, _) = self._step_pair(
                method, self._uaps_config(conv_backend=backend,
                                          compute_dtype="float32"),
                self._uaps_config(conv_backend="xla",
                                  compute_dtype="float32"), init_sd, batch,
                per_step, step=ramp_end,
                prepare=(self._no_level01_dropout if backend == "chain"
                         else None))
            terms = ("loss", "sup_loss", "ps_loss", "uncertainty_loss")
            lr = cfg.optim.base_lr
            cmp = {
                # bf16: the fused blocks round BN's factor and shift to bf16
                # before y * f + sh (JAX's recipe) where the plain path
                # normalises in f32, so their gradients carry independent
                # bf16 rounding: the loss terms are held, the gradients
                # reported beside each bf16 step's distance to the f32 step
                "kernel_vs_plain": self._compare_steps(
                    km, pm, kmet, pmet, init_sd, lr, terms, gate="loss"),
                "kernel_vs_plain_f32": self._compare_steps(
                    k32, p32, k32met, p32met, init_sd, lr, terms,
                    label="f32 kernel vs plain"),
                "kernel_bf16_vs_plain_f32": self._compare_steps(
                    km, p32, kmet, p32met, init_sd, lr, terms, gate="none",
                    label="bf16 kernel vs f32 plain"),
                "plain_bf16_vs_plain_f32": self._compare_steps(
                    pm, p32, pmet, p32met, init_sd, lr, terms, gate="none",
                    label="bf16 plain vs f32 plain")}
            self.report[backend].update(cmp)
            del km, pm, k32, p32
            ev = base.make_eval_step(cfg, model)(val)
            ev = {k: float(v) for k, v in ev.items()}
            log(f"{backend} eval step (bf16, B={BATCH}): {json.dumps(ev)}")
            assert all(np.isfinite(v) for v in ev.values()), ev
            self.fused_paths[backend] = (model, state, step, batches[0])

        # predict of the trained chain weights: the chain model against the
        # default model, f32, phase 4's gates
        sd = self.fused_paths["chain"][0].state_dict()
        imgs = np.random.default_rng(SEED).integers(
            0, 256, (2 * BATCH, HW, HW, 3), dtype=np.uint8)
        engines = [InferenceEngine(self._uaps_config(
            conv_backend=b, compute_dtype="float32"), state_dict=sd,
            device=self.dev) for b in ("chain", "auto")]
        before = counters()
        cm, cp = engines[0].predict(imgs)
        fwd = counters()["chain_conv_plain"] - before["chain_conv_plain"]
        am, ap = engines[1].predict(imgs)
        agree = float((cm == am).mean())
        err = float(np.abs(cp - ap).max())
        ok = (agree >= 0.9999 and err <= 1e-4 and np.isfinite(cp).all()
              and (self.dev.type != "cuda" or fwd == 8))
        log(f"predict f32, chain vs default model on the chain weights: "
            f"masks agree {agree:.6f} (min 0.9999), probs max abs diff "
            f"{err:.3e} (atol 1e-4); chain_conv_plain launches {fwd} "
            f"{'ok' if ok else 'MISMATCH'}")
        self.report["chain"]["predict_vs_default"] = {
            "mask_agree": agree, "probs_max_abs_diff": err}
        assert ok

    # ------------------------------------------------------------ phase 14
    def chain_times(self):
        """Per fused-block kernel and step shape (bf16, warm L2, as the conv
        rows): the kernel's ms, its plain version's, the library composite's
        (cuDNN F.conv2d; for bnl the torch normalise, leaky and F.dropout
        before it; backwards: autograd of that composite) and the bound,
        summed per step by launches; the UAPS step of the auto, chain and
        fused paths in alternating rounds; a profile of 2 chain steps and
        of 2 fused steps."""
        import torch.nn.functional as F
        from uaps_tpu_torch.kernels import block_conv as kbc
        from uaps_tpu_torch.kernels import conv_bnl as kbnl
        torch = self.torch
        bf = torch.bfloat16
        rows = {k: [] for k in CHAIN_COUNTERS}

        def add(name, label, per_step, kern, plain, lib, nbytes, ops):
            row = {"shape": label, "per_step": per_step,
                   "ms": self.time_ms(kern), "plain_ms": self.time_ms(plain),
                   "library_ms": self.time_ms(lib)}
            row["bound_ms"], row["bound_by"] = bound(nbytes, ops, "bf16")
            rows[name].append(row)
            log(f"time {name} {label} x{per_step}/step: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")

        def composite(x, f, s, w, rate):
            """The library's forward of the same function, and a backward
            of it (autograd) for the cotangent g."""
            ins = [None if t is None else t.detach().clone()
                   .requires_grad_() for t in (x, f, s)]
            w_oihw = w.permute(3, 2, 0, 1).contiguous().requires_grad_()

            def fwd():
                z = ins[0]
                if f is not None:
                    z = F.leaky_relu(ins[0].float() * ins[1][:, None, None]
                                     + ins[2][:, None, None], 0.01)
                    if rate > 0:
                        z = F.dropout(z, rate)
                return F.conv2d(z.to(x.dtype), w_oihw, padding=1)
            out = fwd()
            grads = ([ins[0], w_oihw] if f is None
                     else [ins[0], ins[1], ins[2], w_oihw])
            return fwd, lambda g: torch.autograd.grad(out, grads, g,
                                                      retain_graph=True)

        for i, (blk, cin, cout, hw, rate, n) in enumerate(CHAIN_BLOCKS):
            px = BATCH * hw * hw
            x, w, f, s, gy, ds1, ds2, sd = self._chain_case(
                cin, cout, hw, bf, SEED + 400 + i)
            y, _, _ = kbc.chain_conv_plain(x, w)
            need_dx = blk != "in_conv"   # the image needs no gradient
            lib_f, lib_b = composite(x, None, None, w, 0.0)
            label = f"{blk}.0 {cin}->{cout} @{hw}"
            add("chain_conv_plain", label, n,
                lambda: kbc.chain_conv_plain(x, w),
                lambda: kbc.chain_plain_ref(x, w), lib_f,
                2 * (px * cin + 9 * cin * cout + px * cout),
                2 * px * cin * cout * 9)
            add("chain_conv_plain_bwd", label, n,
                lambda: kbc._backward(gy, ds1, ds2, y, x, None, None, w,
                                      None, 0.0, need_dx),
                lambda: kbc.chain_bwd_plain(kbc.fold_plain(gy, y, ds1, ds2),
                                            x, w, None, None, None, 0.0,
                                            need_dx),
                lambda: lib_b(gy),
                2 * (2 * px * cout + px * cin * (1 + need_dx))
                + 9 * cin * cout * (2 + 4),
                2 * px * cin * cout * 9 * (1 + need_dx))
            x, w, f, s, gy, ds1, ds2, sd = self._chain_case(
                cout, cout, hw, bf, SEED + 420 + i)
            y, _, _ = kbc.chain_conv_bnl(x, f, s, w, sd, rate)
            lib_f, lib_b = composite(x, f, s, w, rate)
            label = f"{blk}.4 {cout}->{cout} @{hw} p={rate}"
            nb_fwd = 2 * (2 * px * cout + 9 * cout * cout)
            ops = 2 * px * cout * cout * 9
            add("chain_conv_bnl", label, n,
                lambda: kbc.chain_conv_bnl(x, f, s, w, sd, rate),
                lambda: kbc.chain_bnl_ref(x, f, s, w, sd, rate), lib_f,
                nb_fwd, ops)
            add("chain_conv_bnl_bwd", label, n,
                lambda: kbc._backward(gy, ds1, ds2, y, x, f, s, w, sd, rate,
                                      True),
                lambda: kbc.chain_bwd_plain(kbc.fold_plain(gy, y, ds1, ds2),
                                            x, w, f, s, sd, rate),
                lambda: lib_b(gy),
                2 * 4 * px * cout + 9 * cout * cout * (2 + 4), 2 * ops)
            if rate == 0:
                label = f"{blk}.4 {cout}->{cout} @{hw}"
                add("conv3x3_bnl", label, n,
                    lambda: kbnl.conv3x3_bnl(x, f, s, w),
                    lambda: kbnl.conv3x3_bnl_ref(x, f, s, w), lib_f,
                    nb_fwd, ops)
                add("conv3x3_bnl_bwd", label, n,
                    lambda: kbnl._backward(gy, x, f, s, w),
                    lambda: kbc.chain_bwd_plain(gy, x, w, f, s, None, 0.0),
                    lambda: lib_b(gy),
                    2 * 3 * px * cout + 9 * cout * cout * (2 + 4), 2 * ops)
        t = self.report["times"]
        t["chain_kernels"] = rows
        for name, rs in rows.items():
            def per_step(key):
                return sum(r[key] * r["per_step"] for r in rs)
            by_bytes = sum(r["bound_ms"] * r["per_step"] for r in rs
                           if r["bound_by"] == "bytes")
            self.report["kernels"][name].update(
                ms=per_step("ms"), plain_ms=per_step("plain_ms"),
                library_ms=per_step("library_ms"),
                bound_ms=per_step("bound_ms"),
                bound_by=("bytes" if by_bytes * 2 >= per_step("bound_ms")
                          else "operations"))
            k = self.report["kernels"][name]
            log(f"per UAPS step, {name}: kernel {k['ms']:.4f} ms, plain "
                f"{k['plain_ms']:.4f} ms, library {k['library_ms']:.4f} ms, "
                f"bound {k['bound_ms']:.4f} ms")
        paths = {"auto": (self.uaps_step, self.uaps_state, self.uaps_batch)}
        for b, (_, state, step, batch) in self.fused_paths.items():
            paths[b] = (step, state, batch)
        self.step_rounds(t, "step_rounds", paths)
        for b, per_step in (("chain", CHAIN_STEP_LAUNCHES),
                            ("fused", FUSED_STEP_LAUNCHES)):
            _, state, step, batch = self.fused_paths[b]
            self.profile_steps(b, f"{b} UAPS", step, state, batch,
                               t["step_rounds"][b]["median"], per_step)

    def step_rounds(self, t, key, paths, rounds=3, reps=2):
        """The UAPS steps of `paths` ({label: (step, state, batch)}) in
        alternating rounds (the order rotates each round), so that drift in
        the host's or the card's speed falls on all of them: per round and
        path the median of `reps` steps (host clock, sync each step);
        t[key] gets the median, min and max over the rounds."""
        labs = list(paths)
        got = {lab: [] for lab in labs}
        for r in range(rounds):
            k = r % len(labs)
            for lab in labs[k:] + labs[:k]:
                step, state, batch = paths[lab]
                ms = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    step(state, batch)
                    self.sync()
                    ms.append((time.perf_counter() - t0) * 1e3)
                got[lab].append(statistics.median(ms))
        t[key] = {
            lab: {"rounds": v, "median": statistics.median(v),
                  "min": min(v), "max": max(v)} for lab, v in got.items()}
        log(f"time UAPS step bf16 B={BATCH}+{BATCH}, {rounds} alternating "
            f"rounds of {reps} steps, median [min, max] ms: " + "; ".join(
                f"{lab} {statistics.median(v):.3f} [{min(v):.3f}, "
                f"{max(v):.3f}]" for lab, v in got.items()))

    # ------------------------------------------------------------ phase 15
    def _pseudo_case(self, b, h, w, c, seed):
        """N_DEC f32 logits [b, h, w, c] as the model hands them over (NHWC
        views of NCHW heads), with built exact ties: at image row 0 every
        class equal (class 0 must win), at row 1 classes c - 2 and c - 1
        equal and far above the rest (class c - 2 must win); and Dirichlet
        mix weights."""
        torch = self.torch
        g = self.gen(seed)
        logits = []
        for _ in range(N_DEC):
            x = torch.randn((b, c, h, w), generator=g, device=self.dev) * 3
            x[:, :, 0] = 0.0
            x[:, c - 2:, 1] = 100.0
            logits.append(x.permute(0, 2, 3, 1))
        wts = torch.empty(N_DEC, device=self.dev).exponential_(generator=g)
        return logits, wts / wts.sum()

    def _label_gate(self, got, ref, mix):
        """(ok, {agree, differ, gap, err}): labels equal on >= 99.99% of
        pixels, and where they differ the top two of the plain mix within
        2e-6 (`gap`, phase 9's gate); int32, contiguous, of the plain
        version's shape. `err` is the largest difference of the plain mix
        between the two labels' classes (0 where the labels agree)."""
        torch = self.torch
        diff = got != ref
        top = mix.topk(2, dim=-1).values
        at = [mix.gather(-1, lab.long()[..., None])[..., 0]
              for lab in (got, ref)]
        res = {"agree": 1.0 - float(diff.float().mean()),
               "differ": int(diff.sum()),
               "gap": (float((top[..., 0] - top[..., 1])[diff].max())
                       if bool(diff.any()) else 0.0),
               "err": float((at[0] - at[1]).abs().max())}
        ok = (got.shape == ref.shape and got.dtype == torch.int32
              and got.is_contiguous() and res["agree"] >= 0.9999
              and res["gap"] <= 2e-6)
        return ok, res

    def pseudo_kernels(self):
        """The fused pseudo-label kernel against its plain version at each
        preset's logits (see phase 15 in the module docstring)."""
        from uaps_tpu_torch.kernels import pseudo_label as kpl
        from uaps_tpu_torch.kernels import uncertainty as kun
        torch = self.torch
        bad, rows, err = [], [], 0.0
        for i, (geom, (b, h, w, c)) in enumerate(PSEUDO_GEOMS.items()):
            logits, wts = self._pseudo_case(b, h, w, c, SEED + 400 + i)
            for dname, dtype in (("f32", torch.float32),
                                 ("bf16", torch.bfloat16)):
                lg = [x.to(dtype) for x in logits]
                got = kpl.fused_pseudo_label(lg, wts)
                self.sync()
                ref = kpl.pseudo_label_plain(lg, wts)
                mix = kpl.mixture(lg, wts)
                ok, gate = self._label_gate(got, ref, mix)
                gate["ties"] = all(bool((lab[:, 0] == 0).all())
                                   and bool((lab[:, 1] == c - 2).all())
                                   for lab in (got, ref))
                err = max(err, gate["err"])
                label = f"pseudo_label {geom} {N_DEC} x [{b},{h},{w},{c}] " \
                        f"{dname}"
                log(f"{label}: agree {gate['agree']:.7f} (min 0.9999), "
                    f"{gate['differ']} differ, largest top-two mix gap there "
                    f"{gate['gap']:.2e} (max 2e-6), mix error "
                    f"{gate['err']:.2e}; built ties to the lowest class "
                    f"{gate['ties']} "
                    f"{'ok' if ok and gate['ties'] else 'MISMATCH'}")
                if not (ok and gate["ties"]):
                    bad.append(label)
                if dname == "f32":
                    # the fused uncertainty kernel's labels, same gate
                    _, ups = kun.uncertainty_fwd(lg, wts)
                    self.sync()
                    ok, vs = self._label_gate(got, ups, mix)
                    vs["bit_equal"] = bool(torch.equal(got, ups))
                    gate["vs_uncertainty"] = vs
                    log(f"{label} vs the uncertainty kernel's labels: agree "
                        f"{vs['agree']:.7f}, {vs['differ']} differ, gap "
                        f"{vs['gap']:.2e}; bit-equal {vs['bit_equal']} "
                        f"{'ok' if ok else 'MISMATCH'}")
                    if not ok:
                        bad.append(f"{label} vs uncertainty")
                px = b * h * w
                size = 4 if dtype == torch.float32 else 2

                def composite(lg=lg):
                    return sum(wts[d] * torch.softmax(x.float(), -1)
                               for d, x in enumerate(lg)).argmax(-1)

                row = {"geometry": geom, "dtype": dname,
                       "shape": [N_DEC, b, h, w, c], "gate": gate,
                       "ms": self.time_ms(
                           lambda lg=lg: kpl.fused_pseudo_label(lg, wts),
                           cold=True),
                       "plain_ms": self.time_ms(
                           lambda lg=lg: kpl.pseudo_label_plain(lg, wts),
                           cold=True),
                       "composite_ms": self.time_ms(composite, cold=True)}
                row["bound_ms"], row["bound_by"] = bound(
                    N_DEC * px * c * size + px * 4, N_DEC * px * c * 5,
                    "f32")
                rows.append(row)
                log(f"time {label}: kernel {row['ms']:.4f} ms, plain "
                    f"{row['plain_ms']:.4f} ms, composite (softmax, "
                    f"weighted sum, argmax) {row['composite_ms']:.4f} ms, "
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        self.report["times"]["pseudo_label"] = rows
        # the kernels line: the main path's shape (neu, f32 logits)
        main = rows[0]
        self.report["kernels"]["pseudo_label"] = {
            "max_abs_err": err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "composite_ms": main["composite_ms"]}
        if bad:
            raise AssertionError(f"pseudo-label mismatches: {bad}")

    # ------------------------------------------------------------ phase 16
    def unfused_training(self):
        """The neu UAPS step with fused_uncertainty=False (see phase 16 in
        the module docstring)."""
        from uaps_tpu_torch.data import SyntheticDefects
        from uaps_tpu_torch.train import to_device
        cfg = self._uaps_config()
        cfg.method = dataclasses.replace(cfg.method, fused_uncertainty=False)
        data = SyntheticDefects(cfg.data, seed=SEED)
        it = data.train_iter()
        batches = [to_device(next(it), self.dev)
                   for _ in range(TRAIN_WARMUP + TRAIN_STEPS + 1)]
        _, state, step, init_sd, self.unfused_launches = self._run_steps(
            cfg, batches, TRAIN_WARMUP, TRAIN_STEPS, "unfused",
            "unfused UAPS", UNFUSED_STEP_LAUNCHES)
        plain_cfg = self._uaps_config(conv_backend="xla")
        plain_cfg.method = cfg.method
        self.report["unfused"]["kernel_vs_plain"] = self._pair_past_ramp(
            cfg, plain_cfg, init_sd, batches[-1], UNFUSED_STEP_LAUNCHES,
            "unfused kernel vs plain")
        t = self.report["times"]
        self.step_rounds(t, "unfused_step_rounds", {
            "auto": (self.uaps_step, self.uaps_state, self.uaps_batch),
            "unfused": (step, state, batches[0])})
        self.profile_steps("unfused", "unfused UAPS", step, state,
                           batches[0],
                           t["unfused_step_rounds"]["unfused"]["median"])

    def _preset_config(self, name, **model_kw):
        """Preset `name` as `python -m uaps_tpu_torch.train --preset NAME
        --dataset synthetic --dtype bfloat16` builds it, with `model_kw` on
        top; on the card at the preset's own batch and image size, which a
        CPU rehearsal may shrink through PRESETS."""
        from uaps_tpu_torch.utils.cli import parse_args
        cfg, _ = parse_args(["--preset", name, "--dataset", "synthetic",
                             "--dtype", "bfloat16"])
        cfg.model = dataclasses.replace(cfg.model, **model_kw)
        b, h, w, c, chans = PRESETS[name]
        assert (cfg.data.num_classes, cfg.data.in_channels, cfg.model.name,
                cfg.method.name, cfg.model.n_aux + 1) == (
                    c, chans, "unet_uaps", "uaps", N_DEC), cfg
        if (cfg.data.batch_size, cfg.data.image_size) != (b, (h, w)):
            assert self.dev.type != "cuda", (name, cfg.data)
            cfg.data = dataclasses.replace(cfg.data, batch_size=b,
                                           image_size=(h, w))
        return cfg

    def preset_training(self):
        """The dagm, mtiles and kosdd2 presets (see phase 16 in the module
        docstring)."""
        import numpy as np
        from uaps_tpu_torch.data import SyntheticDefects
        from uaps_tpu_torch.methods import base
        from uaps_tpu_torch.train import to_device
        for name in PRESETS:
            cfg = self._preset_config(name)
            data = SyntheticDefects(cfg.data, seed=SEED)
            it = data.train_iter()
            batches = [to_device(next(it), self.dev) for _ in range(2)]
            val = to_device(next(data.val_iter(1)), self.dev)
            model, state, step, init_sd, _ = self._run_steps(
                cfg, batches, 0, 1, name, f"{name} UAPS",
                UAPS_STEP_LAUNCHES)
            try:
                self.report[name]["kernel_vs_plain"] = self._pair_past_ramp(
                    cfg, self._preset_config(name, conv_backend="xla"),
                    init_sd, batches[-1], UAPS_STEP_LAUNCHES,
                    f"{name} kernel vs plain")
            except AssertionError:
                # tell a kernel fault from bf16 rounding: the same pair in
                # f32, reported, and the phase still fails
                self.report[name]["kernel_vs_plain_f32"] = \
                    self._pair_past_ramp(
                        self._preset_config(name, compute_dtype="float32"),
                        self._preset_config(name, conv_backend="xla",
                                            compute_dtype="float32"),
                        init_sd, batches[-1], UAPS_STEP_LAUNCHES,
                        f"{name} f32 kernel vs plain")
                raise
            ev = base.make_eval_step(cfg, model)(val)
            ev = {k: float(v) for k, v in ev.items()}
            log(f"{name} eval step (bf16, B={cfg.data.batch_size}): "
                f"{json.dumps(ev)}")
            assert all(np.isfinite(v) for v in ev.values()), ev
            self.report[name]["eval"] = ev
            del model, state, step, batches


    # ------------------------------------------------------------ phase 17
    def _nhwc_case(self, b, h, wd, cin, cout, dtype, seed):
        """x [b, h, wd, Cin], w [3, 3, Cin, Cout] (scaled as lecun_normal)
        and a cotangent g [b, h, wd, Cout], all in `dtype`, on the card."""
        torch = self.torch
        g = self.gen(seed)
        x = torch.randn((b, h, wd, cin), generator=g,
                        device=self.dev).to(dtype)
        w = (torch.randn((3, 3, cin, cout), generator=g, device=self.dev)
             / (9 * cin) ** 0.5).to(dtype)
        gy = torch.randn((b, h, wd, cout), generator=g,
                         device=self.dev).to(dtype)
        return x, w, gy

    def other_conv_kernels(self):
        """The fullh entries, the stats conv and the NHWC conv against their
        plain versions, then their times (see phase 17 in the module
        docstring). Tolerances (tol = 1e-4 in f32, 1e-2 in bf16, phase
        12's): y and dx rtol = atol = tol; dW within tol x max |dW|; the
        moments within tol x the sums of their terms' magnitudes (s1: sum
        |y|, s2 itself). Each check also reports max |err| / max |ref|."""
        import torch.nn.functional as F
        from uaps_tpu_torch.kernels import block_conv as kbc
        from uaps_tpu_torch.kernels import conv3x3 as kn
        from uaps_tpu_torch.kernels import conv3x3_nchw as kc
        torch = self.torch
        errs = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0}
                for n in OTHER_CONV_COUNTERS}
        bad = []

        def check(name, label, got, ref, tol, scale=None):
            """rtol = atol = tol elementwise, or |err| <= tol * scale."""
            got, ref = got.detach().float(), ref.float()
            d = (got - ref).abs()
            err = float(d.max())
            rel = err / max(float(ref.abs().max()), 1e-30)
            e = errs[name]
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e["max_rel_err"] = max(e["max_rel_err"], rel)
            ok = got.shape == ref.shape and bool(torch.isfinite(got).all())
            if scale is None:
                ok = ok and torch.allclose(got, ref, rtol=tol, atol=tol)
                note = f"(rtol = atol = {tol})"
            else:
                lim = tol * scale
                ok = ok and bool((d <= lim).all())
                note = f"(limit {tol} x scale, max {float(lim.max()):.3e})"
            log(f"{label}: max_abs_err {err:.3e}, max_rel_err {rel:.3e} "
                f"{note} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(label)

        for dname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            tol = 1e-4 if dname == "f32" else 1e-2
            for i, (mod, cin, cout, hw, *_) in enumerate(FULLH_SHAPES):
                x, w, gy = self._grad_case(cin, cout, hw, dtype, SEED + 500 + i)
                label = f"fullh {mod} {cin}->{cout} @{hw} {dname}"
                y = kc.conv3x3_nchw_fullh(x, w)
                dx = kc.conv3x3_nchw_dgrad_fullh(gy, w)
                dw = kc.conv3x3_nchw_wgrad_fullh(x, gy)
                self.sync()
                rdw = kc.conv3x3_nchw_wgrad_plain(x, gy)
                check("conv3x3_nchw_fullh", f"{label} y", y,
                      kc.conv3x3_nchw_plain(x, w), tol)
                check("conv3x3_nchw_fullh_dgrad", f"{label} dx", dx,
                      kc.conv3x3_nchw_dgrad_plain(gy, w), tol)
                check("conv3x3_nchw_wgrad_fullh", f"{label} dW", dw, rdw, tol,
                      rdw.abs().max())
            for i, (mod, cin, cout, hw) in enumerate(STATS_SHAPES):
                x, w, _, _, gy, ds1, ds2, _ = self._chain_case(
                    cin, cout, hw, dtype, SEED + 520 + i)
                need_dx = mod != "in_conv.0"   # the image needs no gradient
                xr = x.clone().requires_grad_(need_dx)
                wr = w.clone().requires_grad_()
                y, s1, s2 = kc.conv3x3_fast_nchw_stats(xr, wr)
                torch.autograd.backward([y, s1, s2], [gy, ds1, ds2])
                self.sync()
                with torch.no_grad():
                    ry, r1, r2 = kbc.chain_plain_ref(x, w)
                    # the backward from the kernel's own y, as autograd has
                    rdx, rdw, _, _ = kbc.chain_bwd_plain(
                        kbc.fold_plain(gy, y, ds1, ds2), x, w, None, None,
                        None, 0.0, need_dx)
                label = f"stats {mod} {cin}->{cout} @{hw} {dname}"
                check("conv3x3_nchw_stats", f"{label} y", y, ry, tol)
                check("conv3x3_nchw_stats", f"{label} s1", s1, r1, tol,
                      ry.float().abs().sum((0, 2, 3)))
                check("conv3x3_nchw_stats", f"{label} s2", s2, r2, tol, r2)
                if need_dx:
                    check("conv3x3_nchw_stats_bwd", f"{label} dx", xr.grad,
                          rdx, tol)
                check("conv3x3_nchw_stats_bwd", f"{label} dW", wr.grad, rdw,
                      tol, rdw.abs().max())
            # the neu level-0 shape, then an odd Cout (scalar stores), a
            # ragged tile edge and a dgrad writing Cin = 40 (two groups);
            # Cin 3 -> Cout 72: the forward's generic staging and two
            # groups of 64, the dgrad's 16-byte staging with a last K chunk
            # of 8 channels
            for i, shape in enumerate([NHWC_SHAPE, (2, 37, 70, 5, 13),
                                       (2, 9, 131, 40, 8),
                                       (2, 37, 70, 3, 72)]):
                x, w, gy = self._nhwc_case(*shape, dtype, SEED + 540 + i)
                label = f"nhwc {list(shape[:4])}->{shape[4]} {dname}"
                xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
                y = kn.conv3x3_small(xr, wr)
                y.backward(gy)
                self.sync()
                rdw = kn.conv3x3_wgrad_plain(x, gy)
                check("conv3x3_nhwc", f"{label} y", y,
                      kn.conv3x3_forward_plain(x, w), tol)
                check("conv3x3_nhwc", f"{label} dx", xr.grad,
                      kn.conv3x3_forward_plain(
                          gy, w.flip((0, 1)).transpose(2, 3)), tol)
                check("conv3x3_nhwc_wgrad", f"{label} dW (f32)",
                      kn.conv3x3_wgrad(x, gy), rdw, tol, rdw.abs().max())
                check("conv3x3_nhwc_wgrad", f"{label} dW", wr.grad, rdw, tol,
                      rdw.abs().max())
        # fullh's contract: bf16 in, out_dtype f32, the output rounded to
        # bf16 first (the default variant keeps the f32 accumulator)
        x, w, _ = self._grad_case(16, 16, HW, torch.bfloat16, SEED + 560)
        y = kc.conv3x3_nchw(x, w, torch.float32, variant="fullh")
        taps = kc.conv3x3_nchw(x, w, torch.float32)
        ok = (y.dtype == torch.float32
              and torch.equal(y, y.bfloat16().float())
              and torch.equal(y, taps.bfloat16().float()))
        log(f"fullh bf16 -> f32: the bf16 rounding of the default variant's "
            f"f32 output {'ok' if ok else 'MISMATCH'}")
        if not ok:
            bad.append("fullh bf16 -> f32 contract")
        if bad:
            raise AssertionError(f"kernel mismatches: {bad}")
        for name, e in errs.items():
            self.report["kernels"][name] = dict(e)
        self._other_conv_times()

    def _other_conv_times(self):
        """Per kernel and shape (bf16, warm L2 as the conv rows): ms, the
        plain version's, the library call's (cuDNN F.conv2d, conv2d_input,
        conv2d_weight; for the stats conv F.conv2d + the two f32 sums and
        autograd of that; for the NHWC conv the same calls on channels_last
        tensors) and the bound; summed by launches a step (fullh: phase
        18's UAPS step; stats and NHWC: phase 18's run of each)."""
        import torch.nn.functional as F
        from uaps_tpu_torch.kernels import block_conv as kbc
        from uaps_tpu_torch.kernels import conv3x3 as kn
        from uaps_tpu_torch.kernels import conv3x3_nchw as kc
        torch = self.torch
        bf = torch.bfloat16
        rows = {k: [] for k in OTHER_CONV_COUNTERS}
        grad = torch.nn.grad

        def add(name, label, per_step, kern, plain, lib, nbytes, ops):
            row = {"shape": label, "per_step": per_step,
                   "ms": self.time_ms(kern), "plain_ms": self.time_ms(plain),
                   "library_ms": self.time_ms(lib)}
            row["bound_ms"], row["bound_by"] = bound(nbytes, ops, "bf16")
            rows[name].append(row)
            log(f"time {name} {label} x{per_step}: kernel {row['ms']:.4f} ms,"
                f" plain {row['plain_ms']:.4f} ms, library "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")

        for i, (mod, cin, cout, hw, nf, nd, nw) in enumerate(FULLH_SHAPES):
            x, w, gy = self._grad_case(cin, cout, hw, bf, SEED + 500 + i)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            label = f"{mod} {cin}->{cout} @{hw}"
            px = BATCH * hw * hw
            add("conv3x3_nchw_fullh", label, nf,
                lambda: kc.conv3x3_nchw_fullh(x, w),
                lambda: kc.conv3x3_nchw_plain(x, w),
                lambda: F.conv2d(x, w_oihw, padding=1),
                *conv_cost(cin, cout, hw, 2, 2))
            if nd:
                add("conv3x3_nchw_fullh_dgrad", label, nd,
                    lambda: kc.conv3x3_nchw_dgrad_fullh(gy, w),
                    lambda: kc.conv3x3_nchw_dgrad_plain(gy, w),
                    lambda: grad.conv2d_input(x.shape, w_oihw, gy, padding=1),
                    *conv_cost(cout, cin, hw, 2, 2))
            add("conv3x3_nchw_wgrad_fullh", label, nw,
                lambda: kc.conv3x3_nchw_wgrad_fullh(x, gy),
                lambda: kc.conv3x3_nchw_wgrad_plain(x, gy),
                lambda: grad.conv2d_weight(x, w_oihw.shape, gy, padding=1),
                px * (cin + cout) * 2 + 9 * cin * cout * 4,
                2 * px * cin * cout * 9)
        for i, (mod, cin, cout, hw) in enumerate(STATS_SHAPES):
            x, w, _, _, gy, ds1, ds2, _ = self._chain_case(
                cin, cout, hw, bf, SEED + 520 + i)
            need_dx = mod != "in_conv.0"
            y, _, _ = kc.conv3x3_nchw_stats(x, w)
            px = BATCH * hw * hw
            label = f"{mod} {cin}->{cout} @{hw}"
            xl = x.detach().clone().requires_grad_(need_dx)
            wl = w.permute(3, 2, 0, 1).contiguous().requires_grad_()

            def composite(xl=xl, wl=wl):
                yl = F.conv2d(xl, wl, padding=1)
                yf = yl.float()
                return yl, yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))
            outs = composite()
            ins = [xl, wl] if need_dx else [wl]
            nb, ops = conv_cost(cin, cout, hw, 2, 2)
            add("conv3x3_nchw_stats", label, 1,
                lambda: kc.conv3x3_nchw_stats(x, w),
                lambda: kbc.chain_plain_ref(x, w), composite,
                nb + 2 * cout * 4, ops)
            add("conv3x3_nchw_stats_bwd", label, 1,
                lambda: kc._stats_backward(gy, ds1, ds2, y, x, w, need_dx),
                lambda: kbc.chain_bwd_plain(kbc.fold_plain(gy, y, ds1, ds2),
                                            x, w, None, None, None, 0.0,
                                            need_dx),
                lambda: torch.autograd.grad(outs, ins, [gy, ds1, ds2],
                                            retain_graph=True),
                2 * (2 * px * cout + px * cin * (1 + need_dx))
                + 9 * cin * cout * (2 + 4),
                2 * px * cin * cout * 9 * (1 + need_dx))
        b, h, wd, cin, cout = NHWC_SHAPE
        x, w, gy = self._nhwc_case(*NHWC_SHAPE, bf, SEED + 540)
        xl, gl = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)  # channels_last
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        px = b * h * wd
        label = f"[{b},{h},{wd},{cin}]->{cout}"
        conv_bytes = 2 * (px * (cin + cout) + 9 * cin * cout)
        add("conv3x3_nhwc", f"forward {label}", 1,
            lambda: kn.conv3x3_forward(x, w),
            lambda: kn.conv3x3_forward_plain(x, w),
            lambda: F.conv2d(xl, wl, padding=1), conv_bytes,
            2 * px * cin * cout * 9)
        add("conv3x3_nhwc", f"dgrad {label}", 1,
            lambda: kn.conv3x3_dgrad(gy, w),
            lambda: kn.conv3x3_forward_plain(
                gy, w.flip((0, 1)).transpose(2, 3)),
            lambda: grad.conv2d_input(xl.shape, wl, gl, padding=1),
            conv_bytes, 2 * px * cin * cout * 9)
        add("conv3x3_nhwc_wgrad", label, 1,
            lambda: kn.conv3x3_wgrad(x, gy),
            lambda: kn.conv3x3_wgrad_plain(x, gy),
            lambda: grad.conv2d_weight(xl, wl.shape, gl, padding=1),
            px * (cin + cout) * 2 + 9 * cin * cout * 4,
            2 * px * cin * cout * 9)
        self.report["times"]["other_conv_kernels"] = rows
        for name, rs in rows.items():
            def per_step(key):
                return sum(r[key] * r["per_step"] for r in rs)
            by_bytes = sum(r["bound_ms"] * r["per_step"] for r in rs
                           if r["bound_by"] == "bytes")
            self.report["kernels"][name].update(
                ms=per_step("ms"), plain_ms=per_step("plain_ms"),
                library_ms=per_step("library_ms"),
                bound_ms=per_step("bound_ms"),
                bound_by=("bytes" if by_bytes * 2 >= per_step("bound_ms")
                          else "operations"))
            k = self.report["kernels"][name]
            log(f"per run, {name}: kernel {k['ms']:.4f} ms, plain "
                f"{k['plain_ms']:.4f} ms, library {k['library_ms']:.4f} ms, "
                f"bound {k['bound_ms']:.4f} ms")

    # ------------------------------------------------------------ phase 18
    def fullh_flat_training(self):
        """(a) the neu UAPS step with conv_variant="fullh", bn_backend="flat"
        (see phase 18 in the module docstring), then (b) and (c)."""
        from uaps_tpu_torch.data import SyntheticDefects
        from uaps_tpu_torch.models.unet import StatsBatchNorm
        from uaps_tpu_torch.train import to_device
        knobs = dict(conv_variant="fullh", bn_backend="flat")
        cfg = self._uaps_config(**knobs)
        data = SyntheticDefects(cfg.data, seed=SEED)
        it = data.train_iter()
        batches = [to_device(next(it), self.dev)
                   for _ in range(TRAIN_WARMUP + TRAIN_STEPS + 1)]
        model, state, step, init_sd, self.fullh_launches = self._run_steps(
            cfg, batches, TRAIN_WARMUP, TRAIN_STEPS, "fullh",
            "fullh + flat-BN UAPS", FULLH_STEP_LAUNCHES)
        n_bn = sum(isinstance(m, StatsBatchNorm) for m in model.modules())
        assert n_bn == 20, f"{n_bn} StatsBatchNorms, want 20 (levels 0-1)"
        try:
            self.report["fullh"]["kernel_vs_plain"] = self._pair_past_ramp(
                cfg, self._uaps_config(conv_backend="xla", **knobs), init_sd,
                batches[-1], FULLH_STEP_LAUNCHES, "fullh kernel vs plain")
        except AssertionError:
            # tell a kernel fault from bf16 rounding: the same pair in f32,
            # reported, and the phase still fails
            self.report["fullh"]["kernel_vs_plain_f32"] = \
                self._pair_past_ramp(
                    self._uaps_config(compute_dtype="float32", **knobs),
                    self._uaps_config(conv_backend="xla",
                                      compute_dtype="float32", **knobs),
                    init_sd, batches[-1], FULLH_STEP_LAUNCHES,
                    "fullh f32 kernel vs plain")
            raise
        t = self.report["times"]
        if hasattr(self, "uaps_step"):
            self.step_rounds(t, "fullh_step_rounds", {
                "auto": (self.uaps_step, self.uaps_state, self.uaps_batch),
                "fullh": (step, state, batches[0])})
        self.profile_steps("fullh", "fullh + flat-BN UAPS", step, state,
                           batches[0], t["fullh_step_ms"]["median"],
                           FULLH_STEP_LAUNCHES)
        del model, state, step, batches
        self._stats_blocks()
        self._nhwc_run()

    def _stats_blocks(self):
        """(b) ConvBlock(bn_stats=True) at the neu level-0 and level-1 shapes
        (B=16, f32, train mode, each level's dropout with one seed on both
        sides), forward and backward of sum(y^2) / 2 (a cotangent that adds
        up over the pixels, so that a LeakyReLU input flipping at its kink
        moves the sums by one pixel's share), against the default ConvBlock
        with the same weights: y rtol = atol = 1e-4 and the running stats
        rtol 1e-4 / atol 1e-5 (moments over ~1 M pixels summed in another
        order in f32), each gradient within 1e-3 x its tensor's max (the
        BN-fed conv biases, whose exact gradient is 0, within 1e-3 x the
        block's largest). The launch counts are read around the two blocks'
        run: 4 stats forwards and 4 backwards, no plain conv launch."""
        from uaps_tpu_torch.models.factory import init_weights
        from uaps_tpu_torch.models.unet import BatchNorm, ConvBlock
        torch = self.torch
        f32 = torch.float32
        g = torch.Generator().manual_seed(SEED + 600)
        cases = []
        for i, (blk, cin, cout, hw, rate) in enumerate(STATS_BLOCKS):
            sb = ConvBlock(cin, cout, rate, f32, True, bn_stats=True)
            init_weights(sb, g)
            with torch.no_grad():
                for m in sb.modules():
                    if isinstance(m, BatchNorm):
                        m.running_mean.normal_(0.0, 0.1, generator=g)
                        m.running_var.uniform_(0.5, 1.5, generator=g)
                        m.weight.uniform_(0.8, 1.2, generator=g)
                        m.bias.normal_(0.0, 0.05, generator=g)
            db = ConvBlock(cin, cout, rate, f32, True)
            db.load_state_dict(sb.state_dict(), strict=True)
            gd = self.gen(SEED + 610 + i)
            x = torch.randn((BATCH, cin, hw, hw), generator=gd,
                            device=self.dev)
            sd = torch.randint(0, 2 ** 31 - 1, (), generator=gd,
                               device=self.dev)
            cases.append((f"{blk} {cin}->{cout} @{hw} p={rate}",
                          sb.to(self.dev).train(), db.to(self.dev).train(),
                          x, sd, i > 0))
        self.sync()
        reset_counters()          # the bn_stats blocks' run starts here
        outs = []
        for _, sb, _, x, sd, need_dx in cases:
            xr = x.clone().requires_grad_(need_dx)
            y = sb(xr, sd)
            y.backward(y.detach())
            outs.append((y.detach(), xr.grad))
        self.sync()
        self.stats_launches = counters()    # ... and ends here
        log(f"launches over the bn_stats blocks' run: "
            f"{json.dumps(self.stats_launches)}")
        assert (self.stats_launches["conv3x3_nchw_stats"],
                self.stats_launches["conv3x3_nchw_stats_bwd"],
                self.stats_launches["conv3x3_nchw"]) == (4, 4, 0), \
            self.stats_launches
        bad, res = [], {}
        for (label, sb, db, x, sd, need_dx), (y, dx) in zip(cases, outs):
            xr = x.clone().requires_grad_(need_dx)
            ry = db(xr, sd)
            ry.backward(y)
            r = {"y": float((y - ry.detach()).abs().max())}
            ok = torch.allclose(y, ry.detach(), rtol=1e-4, atol=1e-4)
            for i in (1, 5):
                for buf in ("running_mean", "running_var"):
                    a = getattr(sb.conv_conv[i], buf)
                    b = getattr(db.conv_conv[i], buf)
                    r[f"{i}.{buf}"] = float((a - b).abs().max())
                    ok = ok and torch.allclose(a, b, rtol=1e-4, atol=1e-5)
            pd = dict(db.named_parameters())
            big = max(float(p.grad.abs().max()) for p in pd.values())
            grads = [(k, p.grad, pd[k].grad) for k, p in sb.named_parameters()]
            if need_dx:
                grads.append(("x", dx, xr.grad))
            for k, gs, gd in grads:
                err = float((gs - gd).abs().max())
                r[f"d {k}"] = err
                lim = 1e-3 * (big if k.endswith(("conv_conv.0.bias",
                                                 "conv_conv.4.bias"))
                              else float(gd.abs().max()))
                ok = ok and err <= lim
            res[label] = r
            log(f"bn_stats block {label} vs the default block (f32): "
                + ", ".join(f"{k} {v:.3e}" for k, v in r.items())
                + f" {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(label)
        self.report["bn_stats_blocks"] = res
        assert not bad, f"bn_stats blocks off the default block: {bad}"

    def _nhwc_run(self):
        """(c) conv3x3_small forward and backward at the neu level-0 NHWC
        shape in bf16, the launch counts read around it (2 forward-kernel
        launches, the dgrad being one; 1 wgrad), the outputs against the
        plain versions with phase 17's bf16 tolerances."""
        from uaps_tpu_torch.kernels import conv3x3 as kn
        torch = self.torch
        x, w, gy = self._nhwc_case(*NHWC_SHAPE, torch.bfloat16, SEED + 630)
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        self.sync()
        reset_counters()          # the NHWC conv's run starts here
        y = kn.conv3x3_small(xr, wr)
        y.backward(gy)
        self.sync()
        self.nhwc_launches = counters()     # ... and ends here
        with torch.no_grad():
            ry = kn.conv3x3_forward_plain(x, w)
            rdx = kn.conv3x3_forward_plain(gy, w.flip((0, 1)).transpose(2, 3))
            rdw = kn.conv3x3_wgrad_plain(x, gy)
        errs = [float((a.detach().float() - b.float()).abs().max())
                for a, b in ((y, ry), (xr.grad, rdx), (wr.grad, rdw))]
        ok = (self.nhwc_launches["conv3x3_nhwc"] == 2
              and self.nhwc_launches["conv3x3_nhwc_wgrad"] == 1
              and torch.allclose(y.detach().float(), ry.float(), rtol=1e-2,
                                 atol=1e-2)
              and torch.allclose(xr.grad.float(), rdx.float(), rtol=1e-2,
                                 atol=1e-2)
              and errs[2] <= 1e-2 * float(rdw.abs().max()))
        log(f"conv3x3_small {list(NHWC_SHAPE[:4])}->{NHWC_SHAPE[4]} bf16: "
            f"launches {self.nhwc_launches['conv3x3_nhwc']} + "
            f"{self.nhwc_launches['conv3x3_nhwc_wgrad']}; max abs err y "
            f"{errs[0]:.3e}, dx {errs[1]:.3e}, dW {errs[2]:.3e} "
            f"{'ok' if ok else 'MISMATCH'}")
        # the route by dtype from the profiler's kernel names: ROUTE_CALLS
        # forwards and dgrads on the tensor cores in bf16, on the CUDA
        # cores in f32
        for dname, dtype in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
            x, w, gy = self._nhwc_case(2, 37, 70, 16, 16, dtype, SEED + 640)

            def run():
                kn.conv3x3_forward(x, w)
                kn.conv3x3_dgrad(gy, w)
            got, seen = self._route(run, ROUTE_CALLS)
            fam = ("nhwc_fwd_mma_kernel" if dname == "bf16"
                   else "conv3x3_nhwc_fwd_kernel")
            want = {k: 2 * ROUTE_CALLS if k == fam else 0
                    for k in ROUTE_KERNELS}
            self.report.setdefault("route", {})[f"nhwc_{dname}"] = got
            log(f"route of {ROUTE_CALLS} NHWC forwards and dgrads, {dname}: "
                f"{json.dumps(got)} {'ok' if got == want else 'MISMATCH'} "
                f"(want {json.dumps(want)}; the profiler recorded {seen} of "
                f"the {ROUTE_LEAD_IN} lead-in kernels)")
            ok = ok and got == want
        assert ok


    # ------------------------------------------------------------ phase 19
    def graph_training(self):
        """The UAPS and baseline steps as CUDA graphs of K steps sampling
        from device pools (see phase 19 in the module docstring), the
        Trainer with its defaults and device pools, then the other paths'
        steps as graphs (graph_paths)."""
        from uaps_tpu_torch.data import SyntheticDefects
        cfg = self._uaps_config()
        t0 = time.perf_counter()
        data = SyntheticDefects(cfg.data, seed=SEED,
                                labeled_pool=GRAPH_POOLS[0],
                                unlabeled_pool=GRAPH_POOLS[1],
                                val_pool=GRAPH_VAL_POOL)
        log(f"graph data: pools of {GRAPH_POOLS[0]} labelled + "
            f"{GRAPH_POOLS[1]} unlabelled and {GRAPH_VAL_POOL} val images "
            f"in {time.perf_counter() - t0:.1f} s")
        self.report["graph"] = {}
        bad = []
        for key, label, c, method, per_step in (
                ("uaps", "UAPS", cfg, "uaps", UAPS_STEP_LAUNCHES),
                ("baseline", "baseline", self._train_config(), "baseline",
                 STEP_LAUNCHES)):
            if not self._graph_case(key, label, c, method, data, per_step):
                bad.append(key)
        self._graph_trainer(data)
        bad += self.graph_paths(data)
        assert not bad, f"phase 19 failed for {bad}"

    def _graph_case(self, key, label, cfg, method_name, data, per_step):
        """One method's step as a graph of K steps, against K eager steps
        from the same state; returns whether every check passed (the
        numbers go to report["graph"][key])."""
        from uaps_tpu_torch import dispatch
        from uaps_tpu_torch.data.device_pool import PoolSampler
        from uaps_tpu_torch.kernels import ce_dice as kce
        from uaps_tpu_torch.methods import base, get_method
        from uaps_tpu_torch.methods import uaps as puaps
        torch = self.torch
        k = dispatch.AUTO_STEPS_CUDA
        lr = cfg.optim.base_lr
        method = get_method(method_name)
        state, model = method.init_state(
            cfg, self.dev, torch.Generator().manual_seed(SEED))
        step = method.make_train_step(cfg, model)
        sampler = PoolSampler(data, cfg.data.batch_size, SEED, self.dev)
        sampler.start_epoch(1)
        res = self.report["graph"][key] = {}
        checks = {}
        # every Dirichlet draw of the step, kept: those made while the
        # graph was captured are its static outputs
        draws, draw = [], puaps.dirichlet_weights

        def recorded(generator, n, device):
            w = draw(generator, n, device)
            draws.append(w)
            return w

        def eager_steps():
            return dispatch.run_steps(step, state, lambda i: sampler.sample(),
                                      k)

        puaps.dirichlet_weights = recorded
        try:
            graphed = dispatch.GraphedSteps(step, k, self.dev, sampler)
            self.sync()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            t0 = time.perf_counter()
            state, warm = graphed(state)   # K eager steps, then the capture
            self.sync()
            res["first_dispatch_s"] = time.perf_counter() - t0
            res["capture_s"] = graphed.capture_seconds
            launched = counters()
            reset_counters()   # the capture ticked them, no replay does
            want = {n: 2 * k * v for n, v in per_step.items()}
            checks["warm-up and capture through every wrapper"] = \
                launched == want
            captured = draws[k:2 * k]
            log(f"{label} graph of {k} steps: first dispatch (warm-up, "
                f"capture) {res['first_dispatch_s']:.2f} s, capture "
                f"{res['capture_s']:.2f} s; warm-up losses "
                f"{[round(float(v), 4) for v in warm['loss']]}; launch "
                f"counts of the warm-up and capture "
                f"{'ok' if launched == want else 'MISMATCH'}")

            # graph against eager: the same state, generator and batches
            snap = self._snapshot(model, state, sampler)
            n0 = len(draws)
            state, em = eager_steps()
            eager_draws = [w.clone() for w in draws[n0:]]
            eager_p = {n: p.detach().clone()
                       for n, p in model.named_parameters()}
            self._restore(snap, model, state, sampler)
            state, gm = graphed(state)
            self.sync()
            graph_p = {n: p.detach().clone()
                       for n, p in model.named_parameters()}
            terms = ("loss", "sup_loss", "ps_loss", "uncertainty_loss") \
                if key == "uaps" else ("loss", "ce_loss", "dice_loss")
            cmp = self._graph_vs_eager(em, gm, snap[0][0], eager_p,
                                       graph_p, lr, terms, label)
            res["graph_vs_eager"] = cmp
            checks["graph vs eager (phase 10's gates)"] = cmp["ok"]
            checks["finite metrics"] = all(
                bool(torch.isfinite(v).all()) for m in (warm, em, gm)
                for v in m.values())

            if captured:
                g1 = torch.stack([w.clone() for w in captured])
                e1 = torch.stack(eager_draws)
                distinct = all(not torch.equal(g1[i], g1[j])
                               for i in range(k) for j in range(i))
                state, _ = graphed(state)
                g2 = torch.stack([w.clone() for w in captured])
                # an eager step between replays continues the stream: from
                # the same generator state it draws what a replay's first
                # step draws
                gen = state.generator.get_state()
                n0 = len(draws)
                state, _ = step(state, sampler.sample())
                w_eager = draws[n0].clone()
                state.generator.set_state(gen)
                state, _ = graphed(state)
                self.sync()
                res["draws"] = {"replay_1": g1.tolist(),
                                "eager_same_state": e1.tolist(),
                                "replay_2": g2.tolist(),
                                "eager_step": w_eager.tolist(),
                                "replay_from_its_state": captured[0].tolist()}
                checks["the replay draws the eager steps' weights"] = \
                    torch.equal(g1, e1)
                checks["the K weights of a replay differ"] = distinct
                checks["two replays differ"] = all(
                    not torch.equal(g1[i], g2[i]) for i in range(k))
                checks["an eager step continues the stream"] = torch.equal(
                    w_eager, captured[0])
                log(f"{label} mixing weights: replay 1 {g1.tolist()}; "
                    f"replay 2 {g2.tolist()}; eager from replay 1's state "
                    f"max diff {float((g1 - e1).abs().max()):.3e}")
        finally:
            puaps.dirichlet_weights = draw

        # the eager steps with the optimizer of the port before the graph
        # (a float lr, capturable=False), for scale: what capturable Adam
        # costs an eager step
        pre = base.TrainState(state.step, torch.optim.Adam(
            model.parameters(), lr=lr, betas=(cfg.optim.b1, cfg.optim.b2),
            eps=cfg.optim.eps), state.generator, state.counter.clone())

        def eager_pre():
            return dispatch.run_steps(step, pre, lambda i: sampler.sample(),
                                      k)

        # the route and device busy: one profiled replay, K eager steps and
        # K eager steps with that optimizer (after the lead-in)
        paths = {"graph": lambda: graphed(state), "eager": eager_steps,
                 "eager_adam_not_capturable": eager_pre}
        eager_pre()   # its Adam moments
        busy = {}
        for path, fn in paths.items():
            ok, got, _, busy[path] = self._graph_route(
                fn, per_step, k, f"{label} {path} dispatch",
                f"graph_{key}_{path}")
            checks[f"route of the {path} dispatch"] = ok
            res.setdefault("route", {})[path] = got

        # the lr reaches the graph: at lr 0 a replay moves no parameter
        base.set_lr(state, 0.0)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        bn = {n: b.clone() for n, b in model.named_buffers()}
        state, _ = graphed(state)
        self.sync()
        frozen = all(torch.equal(p, before[n])
                     for n, p in model.named_parameters())
        bn_moved = any(not torch.equal(b, bn[n])
                       for n, b in model.named_buffers())
        base.set_lr(state, lr)
        checks["lr 0 reaches the graph (params equal, BN moved)"] = \
            frozen and bn_moved
        tickets = {str(d): int(buf[-1]) for d, buf in kce._SCRATCH.items()}
        checks["the CE+Dice ticket at 0"] = all(v == 0 for v in
                                                tickets.values())
        res["ce_dice_tickets"] = tickets

        # times: graph and eager dispatches in alternating rounds
        t = self.report["times"]
        rounds = self._dispatch_rounds(paths, k)
        t[f"graph_{key}_step_ms"] = rounds
        # a replay's time on the device's clock (CUDA events), unprofiled
        res["replay_event_ms"] = self.time_ms(lambda: graphed(state),
                                              iters=3, rounds=3,
                                              warmup=1) / k
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res["peak_reserved_gib"] = (torch.cuda.max_memory_reserved()
                                    / 2 ** 30)
        for path, b in busy.items():
            med = rounds[path]["median"]
            t[f"graph_{key}_{path}_device_busy_ms"] = b
            t[f"graph_{key}_{path}_idle_share"] = 1.0 - b / med
        res["checks"] = checks
        card = self.report.get("nvidia_smi", "")
        log(f"{label} step as a graph of {k} ({card}): " + "; ".join(
                f"{path} {rounds[path]['median']:.3f} ms a step "
                f"[{rounds[path]['min']:.3f}, {rounds[path]['max']:.3f}], "
                f"device busy {t[f'graph_{key}_{path}_device_busy_ms']:.3f} "
                f"ms, idle share {t[f'graph_{key}_{path}_idle_share']:.3f}"
                for path in paths)
            + f"; a replay on the device's clock (CUDA events) "
            f"{res['replay_event_ms']:.3f} ms a step"
            + f"; peak memory {res['peak_mem_gib']:.3f} GiB allocated, "
            f"{res['peak_reserved_gib']:.3f} GiB reserved")
        for name, ok in checks.items():
            log(f"  {label} graph check: {name}: {'ok' if ok else 'FAILED'}")
        return all(checks.values())

    @staticmethod
    def _modules(model, state):
        """The modules a step updates: the model, the teacher (mt, uamt)
        and net 2 (cps), those the state has."""
        return [model] + [m for m in (
            state.ema_model,
            state.second.model if state.second is not None else None)
            if m is not None]

    @staticmethod
    def _optimizers(state):
        """Every Adam of the state: net 1's, and net 2's for cps."""
        return [state.optimizer] + ([state.second.optimizer]
                                    if state.second is not None else [])

    def _snapshot(self, model, state, sampler):
        """Copies of what a step changes: the parameters and buffers of
        every module it updates (_modules), every Adam's state, the
        generators (the state's, and the sampler's where it draws strong
        views), the step and the sampler's position (no sampler: host-fed
        batches)."""
        opts = [{p: {n: v.clone() for n, v in st.items()}
                 for p, st in opt.state.items()}
                for opt in self._optimizers(state)]
        return ([{n: v.detach().clone() for n, v in m.state_dict().items()}
                 for m in self._modules(model, state)],
                opts, state.generator.get_state(), state.step,
                sampler._pos.clone() if sampler is not None else None,
                sampler.generator.get_state()
                if getattr(sampler, "generator", None) is not None else None)

    def _restore(self, snap, model, state, sampler):
        """Put a _snapshot back in place (into the same tensors, which a
        captured graph reads)."""
        sds, opts, gen, step, pos, sgen = snap
        with self.torch.no_grad():
            for m, sd in zip(self._modules(model, state), sds):
                for n, v in m.state_dict().items():
                    v.copy_(sd[n])
            for opt, saved in zip(self._optimizers(state), opts):
                for p, st in opt.state.items():
                    for n, v in st.items():
                        v.copy_(saved[p][n])
            if pos is not None:
                sampler._pos.copy_(pos)
        state.generator.set_state(gen)
        if sgen is not None:
            sampler.generator.set_state(sgen)
        state.step = step

    def _graph_vs_eager(self, em, gm, init, eager_p, graph_p, lr, terms,
                        label):
        """Phase 10's gates between K eager steps and a replay from the same
        state: each step's loss terms within 1e-2 relative, and >= 95% of
        the parameters' deltas after K steps within lr / 2 (the BN-fed conv
        biases, whose gradient is rounding, left out)."""
        torch = self.torch
        rels = {n: float(((gm[n] - em[n]).abs() / em[n].abs()).max())
                for n in terms}
        agree = total = 0
        largest, where = 0.0, None
        for n, pe in eager_p.items():
            diff = (graph_p[n].float() - pe.float()).abs()
            if float(diff.max()) > largest:
                largest, where = float(diff.max()), n
            if n.endswith(("conv_conv.0.bias", "conv_conv.4.bias")):
                continue
            dk = graph_p[n].float() - init[n].float()
            dp = pe.float() - init[n].float()
            agree += int(((dk - dp).abs() <= lr / 2).sum())
            total += dk.numel()
        share = agree / total
        ok = max(rels.values()) <= 1e-2 and share >= 0.95
        log(f"{label} graph vs eager from one state, {len(em['loss'])} "
            f"steps: " + "; ".join(f"{n} rel {r:.2e}" for n, r in
                                   rels.items())
            + f" (tol 1e-2); param deltas within lr/2: {share:.5f} (min "
            f"0.95); largest param difference {largest:.3e} ({where}) "
            f"{'ok' if ok else 'MISMATCH'}")
        return {"rel": rels, "delta_agree_share": share,
                "largest_param_diff": largest, "largest_at": where,
                "eager": {n: em[n].tolist() for n in terms},
                "graph": {n: gm[n].tolist() for n in terms}, "ok": ok}

    def _graph_route(self, fn, per_step, k, label, key):
        """Profile fn() (k steps) after the lead-in: whether its kernels
        are k x per_step of every family (bf16_route's and
        GRAPH_FAMILIES'), the counts, the wanted counts and the device busy
        ms a step; the 20 largest device entries a step go to
        times[key + "_device_top_ms"], the operator table to
        chip_smoke_profile_<key>.txt. A replay launches the same kernels
        every time, so where the counts differ fn() is profiled again,
        up to LEAD_IN_TRIES windows in all: the profiler once dropped 4
        kernels of ~8000 deep inside a window of cps's graph on the H100,
        as it misses some at a window's start."""
        cuda = self.torch.autograd.DeviceType.CUDA
        want = bf16_route(per_step, k)
        want.update({fam: k * per_step[c]
                     for fam, c in GRAPH_FAMILIES.items()})
        for attempt in range(1, LEAD_IN_TRIES + 1):
            prof = self._profiled(fn)
            events = prof.key_averages()
            device = sorted(device_work(events, cuda),
                            key=lambda e: -e.self_device_time_total)
            entries = [(e.key, e.count) for e in device]
            got = route_of(entries)
            got.update({fam: sum(n for name, n in entries if fam in name)
                        for fam in GRAPH_FAMILIES})
            if got == want:
                break
            log(f"route of a {label}: the profiler counted "
                f"{json.dumps({f: n for f, n in got.items() if n != want[f]})}"
                f", want {json.dumps({f: want[f] for f in got if got[f] != want[f]})}"
                f" (window {attempt} of {LEAD_IN_TRIES})")
        top = [[e.key, e.self_device_time_total / k / 1e3, e.count / k]
               for e in device[:20]]
        self.report["times"][f"{key}_device_top_ms"] = top
        with open(os.path.join(OUT_DIR, f"chip_smoke_profile_{key}.txt"),
                  "w") as f:
            f.write(events.table(sort_by="cuda_time_total", row_limit=40))
        busy = sum(e.self_device_time_total for e in device) / k / 1e3
        log(f"route of a {label} ({k} steps, profiler): {json.dumps(got)} "
            f"{'ok' if got == want else 'MISMATCH'} (want "
            f"{json.dumps(want)}); device busy {busy:.3f} ms a step; by "
            f"device time a step:\n" + "\n".join(
                f"  {ms:9.3f} ms x{n:6.1f}  {name[:100]}"
                for name, ms, n in top[:12]))
        return got == want, got, want, busy

    def _dispatch_rounds(self, paths, k, rounds=3, reps=2):
        """Dispatches of k steps of each of `paths` ({label: fn}) in
        alternating rounds, as step_rounds: per round and path the median
        of `reps` dispatches (host clock, a sync after each), divided by k;
        the median, min and max over the rounds, ms a step."""
        labs = list(paths)
        got = {lab: [] for lab in labs}
        for r in range(rounds):
            j = r % len(labs)
            for lab in labs[j:] + labs[:j]:
                ms = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    paths[lab]()
                    self.sync()
                    ms.append((time.perf_counter() - t0) * 1e3 / k)
                got[lab].append(statistics.median(ms))
        return {lab: {"rounds": v, "median": statistics.median(v),
                      "min": min(v), "max": max(v)} for lab, v in got.items()}

    def _graph_trainer(self, data, cfg=None, sizes=GRAPH_TRAINER,
                       report=None):
        """Trainer.run with the default RunConfig (steps_per_dispatch 0: K
        = 4 on the card) and device_pools on `data`: `sizes` (epochs,
        iterations an epoch) of the UAPS step or of `cfg`'s, every dispatch
        a replay but the first, finite metrics in its JSONL (stored in
        `report`, by default report["graph"]["trainer"])."""
        import shutil
        import numpy as np
        from uaps_tpu_torch.train import Trainer
        cfg = cfg if cfg is not None else self._uaps_config()
        report = report if report is not None else self.report["graph"]
        out = os.path.join(ROOT, "runs", "chip_smoke_trainer")
        shutil.rmtree(out, ignore_errors=True)
        epochs, iters = sizes
        assert cfg.run.steps_per_dispatch == 0 and not cfg.run.profile_steps
        cfg.run = dataclasses.replace(cfg.run, epochs=epochs,
                                      iter_per_epoch=iters, seed=SEED,
                                      device_pools=True, out_dir=out)
        t0 = time.perf_counter()
        tr = Trainer(cfg, device=self.dev, data=data)
        assert (tr.k_dispatch == 4 and tr.graphed is not None
                and tr.pools is not None and tr._val_pool is not None), \
            (tr.k_dispatch, tr.graphed, tr.pools, tr._val_pool)
        best = tr.run()
        self.sync()
        dt = time.perf_counter() - t0
        with open(os.path.join(out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        shutil.rmtree(out, ignore_errors=True)
        report["trainer"] = {"records": recs, "best": best, "seconds": dt}
        log(f"Trainer.run, {epochs} epochs of {iters} {cfg.method.name} "
            f"steps, K = "
            f"{tr.k_dispatch}, device pools, in {dt:.1f} s: " + "; ".join(
                f"epoch {r['step']} loss {r['loss']:.4f} val_mdice "
                f"{r['val_mdice']:.4f} {r['imgs_per_sec']:.1f} img/s"
                for r in recs))
        assert len(recs) == epochs, recs
        assert all(np.isfinite(v) for r in recs for n, v in r.items()
                   if n in ("loss", "sup_loss", "ps_loss", "uncertainty_loss",
                            "consistency_loss", "mean_uncertainty",
                            "labeled_cps_loss", "unlabeled_cps_loss",
                            "train_mdice", "val_loss", "val_mdice",
                            "val2_mdice", "lr")), recs
        if cfg.method.name == "cps":   # both nets validated
            assert all("val2_mdice" in r for r in recs), recs
        assert tr.state.step == int(tr.state.counter) == epochs * iters, (
            tr.state.step, int(tr.state.counter))

    # ------------------------------------------------------------ phase 20
    def _method_config(self, name, **model_kw):
        """Method `name` as `python -m uaps_tpu_torch.train --preset neu
        --method NAME --dtype bfloat16 --dataset synthetic` builds it, with
        `model_kw` on top (and BATCH, HW where a rehearsal shrinks them)."""
        from uaps_tpu_torch.utils.cli import parse_args
        cfg, _ = parse_args(["--preset", "neu", "--method", name, "--dtype",
                             "bfloat16", "--dataset", "synthetic"])
        cfg.model = dataclasses.replace(cfg.model, **model_kw)
        if (cfg.data.batch_size, cfg.data.image_size) != (BATCH, (HW, HW)):
            cfg.data = dataclasses.replace(cfg.data, batch_size=BATCH,
                                           image_size=(HW, HW))
        return cfg

    def method_training(self):
        """The cct, mt, uamt, dct, ucc and cps steps at full width (see
        phase 20 in the module docstring)."""
        import gc
        from uaps_tpu_torch.data import SyntheticDefects
        torch = self.torch
        cfg = self._method_config("mt")
        t0 = time.perf_counter()
        data = SyntheticDefects(cfg.data, seed=SEED,
                                labeled_pool=GRAPH_POOLS[0],
                                unlabeled_pool=GRAPH_POOLS[1],
                                val_pool=GRAPH_VAL_POOL)
        log(f"method data: pools of {GRAPH_POOLS[0]} labelled + "
            f"{GRAPH_POOLS[1]} unlabelled and {GRAPH_VAL_POOL} val images "
            f"in {time.perf_counter() - t0:.1f} s")
        self.report["methods"] = {}
        bad = []
        for name in METHOD_STEPS:
            t0 = time.perf_counter()
            if not self._method_case(name, data):
                bad.append(name)
            gc.collect()
            torch.cuda.empty_cache()
            dt = time.perf_counter() - t0
            self.report["methods"][name]["seconds"] = dt
            log(f"{name}: {dt:.1f} s")
        assert not bad, f"phase 20 failed for {bad}"

    def _method_hooks(self, name, cfg, batch):
        """JAX's batch hooks for `name`, drawn from a seeded generator, so
        that the kernel and the plain route see the same draws: the
        teacher's noise (mt, uamt), the rotation (dct, k = 1) and the four
        mixed streams (ucc, every sample gated in at p = 0.5)."""
        from uaps_tpu_torch.ops.cutmix import (generate_crossmix_data,
                                               generate_mix_data)
        torch = self.torch
        g = self.gen(SEED + 20)
        u = batch["uimage"]
        hooks = {}

        def noise(shape):
            return torch.clamp(0.1 * torch.randn(shape, generator=g,
                                                 device=self.dev), -0.2, 0.2)

        if name in ("mt", "uamt"):
            hooks["tnoise"] = noise(u.shape)
        if name == "uamt":
            t = cfg.method.uamt_num_samples
            hooks["tnoise_T"] = noise((t * u.shape[0], *u.shape[1:]))
        if name == "dct":
            hooks["rot_k"] = torch.tensor(1, device=self.dev)
        if name == "ucc":
            img, lab = generate_mix_data(g, batch["image"], batch["label"],
                                         p=0.5)
            wk, st = generate_crossmix_data(g, img, u,
                                            batch["uimage_strong"], p=0.5)
            hooks.update(mix_img_l=img, mix_lab_l=lab, mix_wk=wk, mix_st=st)
        return hooks

    def _method_pair(self, name, batch):
        """(a) and (b): one step of `name` on the kernel route and one on
        the plain route (conv_backend="xla") from the same weights, teacher,
        net 2 (cps), batch, hooks and generator seed, past the ramp (and
        past mt's gate), held to phase 10's gates (each net's); returns the
        kernel step's launches."""
        from uaps_tpu_torch.methods import get_method
        torch = self.torch
        cfgs = [self._method_config(name),
                self._method_config(name, conv_backend="xla")]
        if name == "uamt":
            for c in cfgs:
                c.method = dataclasses.replace(
                    c.method, consistency1=UAMT_PAIR_CONSISTENCY)
        cfg = cfgs[0]
        method = get_method(name)
        mcfg = cfg.method
        ramp = mcfg.ramp_iters if name == "uamt" else 150
        past = int(ramp * mcfg.consistency_rampup)
        assert past >= mcfg.consistency_start_iter, past
        batch = {**batch, **self._method_hooks(name, cfg, batch)}
        out, init = [], None
        for c in cfgs:
            state, model = method.init_state(
                c, self.dev, torch.Generator().manual_seed(SEED))
            if init is None:
                # the model's weights, and net 2's where the state has one
                init = [{k: v.detach().clone()
                         for k, v in m.state_dict().items()}
                        for m in (model, *([state.second.model]
                                           if state.second else []))]
            model.load_state_dict(init[0])
            if state.ema_model is not None:
                state.ema_model.load_state_dict(init[0])
            if state.second is not None:
                state.second.model.load_state_dict(init[1])
            state.step = past
            self.sync()
            before = counters()
            _, m = method.make_train_step(c, model)(state, batch)
            self.sync()
            launched = {k: v - before[k] for k, v in counters().items()}
            nets = [model] + ([state.second.model] if state.second else [])
            out.append((nets, {k: float(v) for k, v in m.items()},
                        launched))
        (knets, kmet, launched), (pnets, pmet, plain_launched) = out
        assert not any(plain_launched.values()), \
            f"the plain path launched kernels: {plain_launched}"
        assert abs(kmet["consistency_w1"] - mcfg.consistency1) < 1e-7, kmet
        res = self.report["methods"][name]
        if name == "uamt":
            # the share of pixels the entropy mask keeps: the T-pass again
            # on the kernel route's teacher, its own draws
            from uaps_tpu_torch.methods.uamt import uncertainty_samples
            t = mcfg.uamt_num_samples
            rep = batch["uimage"].repeat(t, 1, 1, 1) + batch["tnoise_T"]
            state = method.init_state(cfg, self.dev)[0]
            with torch.no_grad():
                ent = uncertainty_samples(state, rep, t)
            thr = (0.75 + 2.5 * kmet["consistency_w1"]) * 0.6931471805599453
            res["mask_share"] = float((ent < thr).float().mean())
            log(f"uamt: the entropy mask keeps {res['mask_share']:.4f} of "
                f"the pixels (threshold {thr:.4f}; T-pass batch "
                f"{tuple(rep.shape)})")
        res["kernel_vs_plain"] = [self._compare_steps(
            km, pm, kmet, pmet, sd, cfg.optim.base_lr,
            terms=METHOD_TERMS[name],
            label=f"{name} net {i + 1} kernel vs plain")
            for i, (km, pm, sd) in enumerate(zip(knets, pnets, init))]
        res["launches_a_step"] = launched
        reached = {k for k, v in launched.items() if v}
        log(f"{name} launches a step: " + json.dumps(
            {k: v for k, v in launched.items() if v}))
        assert reached == set(METHOD_KERNELS[name]), (
            f"{name}: kernels launched {sorted(reached)}, its model reaches "
            f"{sorted(METHOD_KERNELS[name])}")
        if name == "cps":
            assert {k: v for k, v in launched.items() if v} == \
                CPS_STEP_LAUNCHES, (launched, CPS_STEP_LAUNCHES)
        return launched

    def _library_convs(self, fn, classes):
        """PyTorch's own 3x3 convs in an eager fn(), from the profiler's
        operator input shapes (aten::convolution and its backward): (ok,
        [[input shape, weight shape, calls], ...] of those on inputs of
        128 px or more). ok: every one of them is a logits head (Cout =
        classes), so no ConvBlock conv at 256 or 128 px ran cuDNN."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            fn()
            self.sync()
        big = []
        for e in prof.key_averages(group_by_input_shape=True):
            at = {"aten::convolution": (0, 1),
                  "aten::convolution_backward": (1, 2)}.get(e.key)
            if at is None:
                continue
            x, w = (list(e.input_shapes[i]) for i in at)
            if len(x) == 4 and min(x[2:]) >= 128:
                big.append([x, w, e.count])
        return all(w[0] == classes for _, w, _ in big), big

    def _method_case(self, name, data):
        """Phase 20 for one method: (a) and (b) (_method_pair), the
        library convs of an eager step (_library_convs), (c) a graph of K
        steps against K eager steps from one state, bit for bit, and its
        times (_graph_bitwise), (d) the Trainer; returns whether every
        check of (c) passed (the rest raise)."""
        from uaps_tpu_torch.data.device_pool import PoolSampler
        from uaps_tpu_torch.methods import get_method
        torch = self.torch
        res = self.report["methods"][name] = {}
        cfg = self._method_config(name)
        sampler = PoolSampler(data, BATCH, SEED, self.dev,
                              strong=name == "ucc")
        sampler.start_epoch(1)
        per_step = {**self._method_pair(name, sampler.sample()),
                    **F32_HEAD_LAUNCHES.get(name, {})}

        # no ConvBlock conv at 256 or 128 px on cuDNN: one eager step
        method = get_method(name)
        state, model = method.init_state(
            cfg, self.dev, torch.Generator().manual_seed(SEED))
        step = method.make_train_step(cfg, model)
        batch = sampler.sample()
        step(state, batch)     # builds and loads outside the window
        ok, big = self._library_convs(lambda: step(state, batch),
                                      cfg.data.num_classes)
        res["library_convs_at_128px_or_more"] = big
        log(f"{name}: PyTorch convs on 128 px or more in an eager step "
            f"(input, weight, calls): {json.dumps(big)} "
            f"{'ok: logits heads only' if ok else 'MISMATCH'}")
        assert ok, big
        del state, model, step, batch

        res["cudnn_deterministic"] = torch.backends.cudnn.deterministic
        checks = self._graph_bitwise(f"method_{name}", name, cfg, name,
                                     sampler, per_step, res)
        # (d) the Trainer with its defaults and device pools
        self._graph_trainer(data, cfg, METHOD_TRAINER, res)
        return all(checks.values())

    def _eager_repeat(self, cfg, method_name, sampler):
        """Two eager steps of `method_name` from one state (after one step
        that builds and loads) with cuDNN's default algorithms: {parameter:
        the largest difference of its gradients} for those that differ
        (every module the step updates, net 2's names prefixed "net2.")."""
        from uaps_tpu_torch.methods import get_method
        method = get_method(method_name)
        state, model = method.init_state(
            cfg, self.dev, self.torch.Generator().manual_seed(SEED))
        step = method.make_train_step(cfg, model)
        batch = sampler.sample()
        step(state, batch)
        snap = self._snapshot(model, state, sampler)
        grads = []
        for _ in range(2):
            self._restore(snap, model, state, sampler)
            step(state, batch)
            grads.append({
                f"{'net2.' if i else ''}{n}": p.grad.clone()
                for i, m in enumerate(self._modules(model, state))
                for n, p in m.named_parameters() if p.grad is not None})
        diff = {n: float((g - grads[1][n]).abs().max())
                for n, g in grads[0].items() if not self.torch.equal(
                    g, grads[1][n])}
        log(f"{method_name}: two eager steps from one state, cuDNN's "
            f"default algorithms: {len(diff)} of {len(grads[0])} "
            f"gradients differ {json.dumps(diff)}")
        return diff

    def _graph_bitwise(self, key, label, cfg, method_name, sampler, per_step,
                       res, rounds=GRAPH_ROUNDS[0], reps=GRAPH_ROUNDS[1]):
        """`method_name`'s step on `cfg` as one dispatch.GraphedSteps graph
        of K steps sampling from `sampler`: the first dispatch (K eager
        steps, then the capture) launches 2 K x per_step through the
        wrappers; against K eager steps from one state (every module's
        weights and BN stats, every Adam, the generators, the pool
        position) the metrics and every module's state bit-equal; a
        profiled replay holds K x per_step of every kernel family; graph
        and eager dispatches in `rounds` alternating rounds of `reps`, a
        replay on CUDA events, device busy, idle share and peak memory
        (into `res`, and report["times"] under `key`). Returns the
        checks."""
        from uaps_tpu_torch import dispatch
        from uaps_tpu_torch.methods import get_method
        torch = self.torch
        k = dispatch.AUTO_STEPS_CUDA
        method = get_method(method_name)
        state, model = method.init_state(
            cfg, self.dev, torch.Generator().manual_seed(SEED))
        step = method.make_train_step(cfg, model)
        graphed = dispatch.GraphedSteps(step, k, self.dev, sampler)
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        state, warm = graphed(state)   # K eager steps, then the capture
        self.sync()
        res["first_dispatch_s"] = time.perf_counter() - t0
        res["capture_s"] = graphed.capture_seconds
        launched = counters()
        reset_counters()   # the capture ticked them, no replay does
        checks = {}
        want = {n: 2 * k * per_step[n] for n in launched}
        checks["warm-up and capture through every wrapper"] = \
            launched == want
        if launched != want:
            log(f"{label} warm-up and capture launches "
                f"{json.dumps({n: v for n, v in launched.items() if v})}, "
                f"want {json.dumps({n: v for n, v in want.items() if v})}")

        def copies():
            return [{n: v.detach().clone() for n, v in m.state_dict().items()}
                    for m in self._modules(model, state)]

        def eager_steps():
            return dispatch.run_steps(step, state, lambda i: sampler.sample(),
                                      k)

        snap = self._snapshot(model, state, sampler)
        state, em = eager_steps()
        eager = copies()
        self._restore(snap, model, state, sampler)
        state, gm = graphed(state)
        self.sync()
        graph = copies()
        checks["metrics bit-equal"] = all(torch.equal(gm[n], em[n])
                                          for n in em)
        checks["params and BN stats bit-equal (every module)"] = all(
            torch.equal(graph[j][n], v) for j in range(len(eager))
            for n, v in eager[j].items())
        checks["finite metrics"] = all(
            bool(torch.isfinite(v).all()) for m in (warm, em, gm)
            for v in m.values())
        largest = max(float((graph[j][n].float() - v.float()).abs().max())
                      for j in range(len(eager)) for n, v in eager[j].items())
        res["graph_vs_eager"] = {
            "largest_diff": largest, "modules": len(eager),
            "eager": {n: em[n].tolist() for n in em},
            "graph": {n: gm[n].tolist() for n in gm}}
        log(f"{label} graph of {k} steps: first dispatch (warm-up, capture) "
            f"{res['first_dispatch_s']:.2f} s, capture "
            f"{res['capture_s']:.2f} s; against {k} eager steps from one "
            f"state ({len(eager)} modules): losses "
            f"{[round(float(v), 5) for v in gm['loss']]} and "
            f"{[round(float(v), 5) for v in em['loss']]}, largest "
            f"difference {largest:.3e}")

        # the route and device busy of a replay, then the times
        ok, got, _, busy = self._graph_route(
            lambda: graphed(state), per_step, k, f"{label} graph dispatch",
            f"{key}_graph")
        checks["route of a replay (4 x the step's launches)"] = ok
        res["route"] = got
        times = self._dispatch_rounds({"graph": lambda: graphed(state),
                                       "eager": eager_steps}, k,
                                      rounds=rounds, reps=reps)
        res["replay_event_ms"] = self.time_ms(lambda: graphed(state),
                                              iters=2, rounds=2,
                                              warmup=1) / k
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        t = self.report["times"]
        t[f"{key}_step_ms"] = times
        t[f"{key}_graph_device_busy_ms"] = busy
        t[f"{key}_graph_idle_share"] = 1.0 - busy / times["graph"]["median"]
        res["checks"] = checks
        card = self.report.get("nvidia_smi", "")
        log(f"{label} step as a graph of {k} ({card}): graph "
            f"{times['graph']['median']:.3f} ms a step "
            f"[{times['graph']['min']:.3f}, {times['graph']['max']:.3f}], "
            f"a replay on CUDA events {res['replay_event_ms']:.3f} ms a "
            f"step, device busy {busy:.3f} ms, idle share "
            f"{t[f'{key}_graph_idle_share']:.3f}; eager "
            f"{times['eager']['median']:.3f} ms a step "
            f"[{times['eager']['min']:.3f}, {times['eager']['max']:.3f}]; "
            f"peak memory {res['peak_mem_gib']:.3f} GiB")
        for check, passed in checks.items():
            log(f"  {label} graph check: {check}: "
                f"{'ok' if passed else 'FAILED'}")
        return checks

    def graph_paths(self, data):
        """Phase 19's second part: the chain, fused, unfused, fullh +
        flat-BN, dagm, mtiles and kosdd2 steps, each as a graph of K steps
        held to K eager steps bit for bit and timed (_graph_bitwise);
        returns the keys of those that failed a check."""
        import gc
        from uaps_tpu_torch.data import SyntheticDefects
        from uaps_tpu_torch.data.device_pool import PoolSampler
        torch = self.torch
        paths = self.report["graph"]["paths"] = {}
        bad = []
        for key, label, (make_cfg, arg), per_step in GRAPH_PATHS:
            t0 = time.perf_counter()
            if make_cfg == "_uaps_config":
                cfg = self._uaps_config(**arg)
                if key == "unfused":
                    cfg.method = dataclasses.replace(
                        cfg.method, fused_uncertainty=False)
                pool = data
            else:
                cfg = self._preset_config(arg)
                pool = SyntheticDefects(cfg.data, seed=SEED,
                                        labeled_pool=GRAPH_PATH_POOLS[0],
                                        unlabeled_pool=GRAPH_PATH_POOLS[1])
            sampler = PoolSampler(pool, cfg.data.batch_size, SEED, self.dev)
            sampler.start_epoch(1)
            res = paths[key] = {}
            checks = self._graph_bitwise(f"graph_{key}", label, cfg,
                                         cfg.method.name, sampler, per_step,
                                         res)
            if not all(checks.values()):
                bad.append(key)
            del sampler, pool
            gc.collect()
            torch.cuda.empty_cache()
            res["seconds"] = time.perf_counter() - t0
            log(f"{label}: {res['seconds']:.1f} s")
        return bad

    # ------------------------------------------------------------ phase 23
    def export_basenet(self):
        """The deployable artifacts and BaseNet (phase 23 in the module
        docstring)."""
        import gc
        res = self.report["export"] = {}
        os.makedirs(EXPORT_DIR, exist_ok=True)
        try:
            self._export_neu(res)
            self._export_others(res)
            self._basenet_training(res)
        finally:
            shutil.rmtree(EXPORT_DIR, ignore_errors=True)
            gc.collect()
            self.torch.cuda.empty_cache()

    @staticmethod
    def _export_normalize(images, cfg):
        """uint8 images as the artifact normalises them: (x - 255 mean) /
        (255 std) in f32 (artifact.ExportedEngine._normalize)."""
        import numpy as np
        mean = np.asarray(cfg.data.mean, np.float32) * 255.0
        std = np.asarray(cfg.data.std, np.float32) * 255.0
        return (images.astype(np.float32) - mean) / std

    def _op_calls(self, fn):
        """{uaps:: operator: calls} of fn() (a TorchDispatchMode): what the
        live forward sends to the kernels' operators."""
        from collections import Counter
        from torch.utils._python_dispatch import TorchDispatchMode

        class Calls(TorchDispatchMode):
            n = Counter()

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace == "uaps":
                    self.n[func.__name__.split(".")[0]] += 1
                return func(*args, **(kwargs or {}))

        with Calls() as calls:
            fn()
            self.sync()
        return dict(calls.n)

    def _export_neu(self, res):
        """(a), (b) and (e) for the neu unet_uaps bf16 engine."""
        import numpy as np
        from uaps_tpu_torch.serve import ExportedEngine, InferenceEngine
        torch = self.torch
        if not hasattr(self, "pth"):
            self.pth = self._write_checkpoint()
        cfg = self._config("bfloat16")
        live = InferenceEngine.from_torch(cfg, self.pth, device=self.dev)
        path = os.path.join(EXPORT_DIR, "neu_uaps_bf16.uapsexport")
        t0 = time.perf_counter()
        size = live.export(path)
        res["neu_export_s"] = time.perf_counter() - t0
        images = np.random.default_rng(SEED + 23).integers(
            0, 256, (EXPORT_IMAGES, HW, HW, 3), dtype=np.uint8)
        np.save(os.path.join(EXPORT_DIR, "images.npy"), images)
        out = os.path.join(EXPORT_DIR, "exported.npz")
        code = f"""
import json, sys, time
import numpy as np
from uaps_tpu_torch.artifact import ExportedEngine
from uaps_tpu_torch.kernels import conv3x3_nchw as kc, pool_nchw as kp
t0 = time.perf_counter()
eng = ExportedEngine({path!r}, device="cuda")
load_s = time.perf_counter() - t0
images = np.load({os.path.join(EXPORT_DIR, "images.npy")!r})
eng.predict(images[:1])     # loads the kernel libraries
batches = -(-len(images) // eng.batch_size)
kc.launches = kp.launches = 0
masks, probs = eng.predict(images)
np.savez({out!r}, masks=masks, probs=probs)
bad = ("jax", "uaps_tpu", "uaps_tpu_torch.models", "uaps_tpu_torch.methods",
       "uaps_tpu_torch.utils", "uaps_tpu_torch.data", "uaps_tpu_torch.serve")
print(json.dumps({{"load_s": load_s, "batches": batches,
                  "conv": kc.launches, "pool": kp.launches,
                  "modules": [n for n in sys.modules
                              if n.split(".")[0] in bad[:2]
                              or n.startswith(bad[2:])]}}))
"""
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        sub_s = time.perf_counter() - t0
        if proc.returncode:
            raise RuntimeError(f"the loader process failed:\n{proc.stderr}")
        sub = json.loads(proc.stdout.strip().splitlines()[-1])
        got = np.load(out)
        # the live engine on the same input (the artifact's normalisation)
        want_m, want_p = live.predict(self._export_normalize(images, cfg))
        n_diff = int((got["masks"] != want_m).sum())
        p_err = float(np.abs(got["probs"] - want_p).max())
        u8_m, _ = live.predict(images)
        u8_agree = float((u8_m == got["masks"]).mean())
        per_batch = (sub["conv"] / sub["batches"], sub["pool"] / sub["batches"])
        res["neu"] = {"bytes": size, "loader_process_s": sub_s, **sub,
                      "mask_pixels_differ": n_diff, "probs_max_abs_diff": p_err,
                      "uint8_mask_agree_live_normalisation": u8_agree}
        log(f"neu unet_uaps bf16 artifact: {size} bytes, exported in "
            f"{res['neu_export_s']:.1f} s; a fresh process loaded it in "
            f"{sub['load_s']:.1f} s ({sub_s:.1f} s in all) and predicted "
            f"{EXPORT_IMAGES} uint8 images: {n_diff} mask pixels differ from "
            f"the live engine on the same input, probs max abs diff "
            f"{p_err:.3e} (atol {EXPORT_PROBS_ATOL}); launches a batch conv "
            f"{per_batch[0]}, pool {per_batch[1]}; port model / config / "
            f"jax modules loaded: {sub['modules']}; masks against the live "
            f"engine's own uint8 normalisation agree on {u8_agree:.6f}")
        assert n_diff == 0 and p_err <= EXPORT_PROBS_ATOL, res["neu"]
        assert per_batch == (CONV_PER_BATCH, POOL_PER_BATCH), per_batch
        assert not sub["modules"], sub["modules"]

        # an artifact exported on the CPU (batch 1) runs on the card
        # (move_to_device_pass), through the kernels, equal to a live
        # engine of batch 1 there (cuDNN may take other algorithms, and
        # round otherwise in bf16, at another batch)
        cpu, live1 = (InferenceEngine.from_torch(cfg, self.pth, device=d,
                                                 batch_size=1)
                      for d in ("cpu", self.dev))
        cpu_path = os.path.join(EXPORT_DIR, "neu_uaps_bf16_cpu.uapsexport")
        cpu.export(cpu_path)
        moved = ExportedEngine(cpu_path, device=self.dev)
        one = self._export_normalize(images[:1], cfg)
        reset_counters()
        mm, mp = moved.predict(one)
        moved_launches = {k: v for k, v in counters().items() if v}
        lm, lp = live1.predict(one)
        res["cpu_exported_on_card"] = {
            "launches": moved_launches,
            "mask_pixels_differ": int((mm != lm).sum()),
            "probs_max_abs_diff": float(np.abs(mp - lp).max())}
        log(f"the artifact exported on the CPU, run on the card: "
            f"{json.dumps(res['cpu_exported_on_card'])}")
        assert moved_launches == {"conv3x3_nchw": CONV_PER_BATCH,
                                  "max_pool_2x2_nchw": POOL_PER_BATCH}, \
            moved_launches
        assert (mm == lm).all() and float(np.abs(mp - lp).max()) \
            <= EXPORT_PROBS_ATOL, res["cpu_exported_on_card"]
        del cpu, live1, moved

        # (b) the route of one exported predict, from the profiler's names
        exported = ExportedEngine(path, device=self.dev)
        x = torch.from_numpy(self._export_normalize(
            images[:BATCH], cfg)).to(self.dev)
        exported.predict_device(x)
        cuda = torch.autograd.DeviceType.CUDA
        prof = self._profiled(lambda: exported.predict_device(x))
        names = [(e.key, e.count) for e in prof.key_averages()
                 if e.device_type == cuda]
        fams = {fam: sum(n for k, n in names if fam in k)
                for fam in ("conv_fwd_mma_kernel", "max_pool_2x2_fwd_kernel",
                            "conv3x3_fwd_kernel")}
        _, big = self._library_convs(lambda: exported.predict_device(x),
                                     cfg.data.num_classes)
        res["neu_route"] = {"kernels": fams, "library_convs_128px": big}
        log(f"an exported predict's kernels (profiler): {json.dumps(fams)}; "
            f"PyTorch convs on 128 px or more: {big}")
        assert fams == {"conv_fwd_mma_kernel": CONV_PER_BATCH,
                        "max_pool_2x2_fwd_kernel": POOL_PER_BATCH,
                        "conv3x3_fwd_kernel": 0}, fams
        assert not big, big

        # (e) the exported against the live predict, a batch of 16
        times = self._dispatch_rounds(
            {"live": lambda: live.predict_device(x),
             "exported": lambda: exported.predict_device(x)}, 1,
            rounds=EXPORT_ROUNDS[0], reps=EXPORT_ROUNDS[1])
        self.report["times"]["export_predict_ms"] = times
        card = self.report.get("nvidia_smi", "")
        log(f"predict of a batch of {BATCH} ({card}), alternating rounds: "
            + "; ".join(f"{k} {v['median']:.3f} ms [{v['min']:.3f}, "
                        f"{v['max']:.3f}]" for k, v in times.items()))

    def _export_others(self, res):
        """(c): the other engines' artifacts against their live engines,
        and the BaseNet TTA predict's time."""
        import numpy as np
        from uaps_tpu_torch.methods.base import build_model
        from uaps_tpu_torch.models.unet import BatchNorm
        from uaps_tpu_torch.serve import ExportedEngine, InferenceEngine
        torch = self.torch
        images = np.random.default_rng(SEED + 24).integers(
            0, 256, (BATCH, HW, HW, 3), dtype=np.uint8)
        card = self.report.get("nvidia_smi", "")
        for key, label, kw, tta in EXPORT_ENGINES:
            cfg = self._config("bfloat16", **kw)
            if key == "basenet":
                cfg.method = dataclasses.replace(cfg.method, name="baseline")
                g = torch.Generator().manual_seed(SEED)
                model = build_model(cfg, "cpu", g)
                with torch.no_grad():
                    for m in model.modules():
                        if isinstance(m, BatchNorm):
                            m.running_mean.normal_(0.0, 0.1, generator=g)
                            m.running_var.uniform_(0.5, 1.5, generator=g)
                live = InferenceEngine(cfg, state_dict=model.state_dict(),
                                       device=self.dev, tta=tta)
                del model
            else:
                live = InferenceEngine.from_torch(cfg, self.pth,
                                                  device=self.dev, tta=tta)
            x = torch.from_numpy(self._export_normalize(images, cfg)).to(
                self.dev)
            path = os.path.join(EXPORT_DIR, f"{key}.uapsexport")
            t0 = time.perf_counter()
            size = live.export(path)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            exported = ExportedEngine(path, device=self.dev)
            load_s = time.perf_counter() - t0
            calls = self._op_calls(lambda: live.predict_device(x))
            want_m, want_p = live.predict_device(x)
            reset_counters()
            got_m, got_p = exported.predict_device(x)
            self.sync()
            launched = {k: v for k, v in counters().items() if v}
            n_diff = int((got_m != want_m).sum())
            p_err = float((got_p - want_p).abs().max())
            r = res[key] = {"bytes": size, "export_s": export_s,
                            "load_s": load_s, "op_calls": calls,
                            "launches": launched,
                            "mask_pixels_differ": n_diff,
                            "probs_max_abs_diff": p_err}
            log(f"{label} artifact: {size} bytes, exported in "
                f"{export_s:.1f} s, loaded in {load_s:.1f} s; against the "
                f"live engine on one batch: {n_diff} mask pixels differ, "
                f"probs max abs diff {p_err:.3e}; launches "
                f"{json.dumps(launched)}, the live forward's operator calls "
                f"{json.dumps(calls)}")
            assert n_diff == 0 and p_err <= EXPORT_PROBS_ATOL, r
            assert launched == calls, (launched, calls)
            if key in EXPORT_ROUTES:
                assert launched.get(EXPORT_ROUTES[key], 0) >= 1, launched
            if key == "basenet":
                assert not calls, calls   # the trunk is cuDNN's
                s = got_p.sum(-1)
                assert bool(torch.isfinite(got_p).all()) and float(
                    (s - 1).abs().max()) < 1e-4
                times = self._dispatch_rounds(
                    {"live": lambda: live.predict_device(x),
                     "exported": lambda: exported.predict_device(x)}, 1,
                    rounds=3, reps=2)
                self.report["times"]["basenet_tta_predict_ms"] = times
                log(f"{label} predict of a batch of {BATCH} ({card}): "
                    + "; ".join(f"{k} {v['median']:.3f} ms [{v['min']:.3f}"
                                f", {v['max']:.3f}]"
                                for k, v in times.items()))
            del live, exported, x

    def _basenet_training(self, res):
        """(d) and the graphed step's time in (e): basenet_resnet50
        baseline at neu, bf16."""
        from uaps_tpu_torch import dispatch
        from uaps_tpu_torch.data import SyntheticDefects
        from uaps_tpu_torch.data.device_pool import PoolSampler
        from uaps_tpu_torch.methods import get_method
        torch = self.torch
        cfg = self._train_config(name=BASENET)
        plain_cfg = self._train_config(name=BASENET, conv_backend="xla")
        per_step = {**{n: 0 for n in counters()},
                    "ce_dice_fwd": 1, "ce_dice_bwd": 1}
        data = SyntheticDefects(cfg.data, seed=SEED,
                                labeled_pool=GRAPH_PATH_POOLS[0],
                                unlabeled_pool=GRAPH_PATH_POOLS[1],
                                val_pool=BATCH)
        sampler = PoolSampler(data, BATCH, SEED, self.dev)
        sampler.start_epoch(1)
        method = get_method("baseline")
        state, model = method.init_state(
            cfg, self.dev, torch.Generator().manual_seed(SEED))
        init_sd = {k: v.detach().clone() for k, v in
                   model.state_dict().items()}
        step = method.make_train_step(cfg, model)
        reset_counters()
        losses = []
        for _ in range(BASENET_EAGER):
            state, m = step(state, sampler.sample())
            losses.append(float(m["loss"]))
        launched = counters()
        r = res["basenet_train"] = {"eager_losses": losses}
        log(f"{BASENET} baseline, {BASENET_EAGER} eager steps: losses "
            f"{losses}; launches "
            f"{json.dumps({k: v for k, v in launched.items() if v})}")
        assert all(math.isfinite(v) for v in losses), losses
        assert launched == {n: BASENET_EAGER * v
                            for n, v in per_step.items()}, launched
        del state, model, step

        # one step against the plain route from the same weights and batch
        batch = sampler.sample()
        (km, kmet, _), (pm, pmet, _) = self._step_pair(
            method, cfg, plain_cfg, init_sd, batch, per_step)
        r["kernel_vs_plain"] = self._compare_steps(
            km, pm, kmet, pmet, init_sd, cfg.optim.base_lr,
            terms=("loss", "ce_loss", "dice_loss"),
            label=f"{BASENET} kernel vs plain")
        del km, pm

        # the graph against its eager steps, bit for bit under cuDNN's
        # deterministic algorithms; then its time with the default ones
        torch.backends.cudnn.deterministic = True
        try:
            checks = self._graph_bitwise("basenet_deterministic", BASENET,
                                         cfg, "baseline", sampler, per_step,
                                         r)
        finally:
            torch.backends.cudnn.deterministic = False
        method = get_method("baseline")
        state, model = method.init_state(
            cfg, self.dev, torch.Generator().manual_seed(SEED))
        graphed = dispatch.GraphedSteps(method.make_train_step(cfg, model),
                                        dispatch.AUTO_STEPS_CUDA, self.dev,
                                        sampler)
        torch.cuda.reset_peak_memory_stats()
        state, _ = graphed(state)
        times = self._dispatch_rounds({"graph": lambda: graphed(state)},
                                      dispatch.AUTO_STEPS_CUDA, rounds=3,
                                      reps=2)["graph"]
        r["graph_default_cudnn_ms"] = times
        r["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        self.report["times"]["basenet_graph_step_ms"] = times
        card = self.report.get("nvidia_smi", "")
        log(f"{BASENET} step as a graph of {dispatch.AUTO_STEPS_CUDA}, "
            f"cuDNN's default algorithms ({card}): {times['median']:.3f} ms "
            f"a step [{times['min']:.3f}, {times['max']:.3f}]; peak memory "
            f"{r['peak_mem_gib']:.3f} GiB")
        assert all(checks.values()), checks
        del state, model, graphed
        self._graph_trainer(data, cfg, (1, 8), r)   # Trainer.run, K = 4

# the kernels line: (launch counter, CUDA source, the TPU kernel replaced)

    # ------------------------------------------------------------ phase 21
    def _resume_trainer(self, name, data, out, epochs, **run_kw):
        """Trainer.run's run of method `name` as the CLI builds it, with
        its defaults (K = 4 on the card), device pools on `data`,
        save_every 1 and keep_checkpoints 2, for `epochs` epochs of
        RESUME_RUN[1] steps into `out`."""
        from uaps_tpu_torch.train import Trainer
        cfg = self._method_config(name)
        cfg.run = dataclasses.replace(
            cfg.run, epochs=epochs, iter_per_epoch=RESUME_RUN[1], seed=SEED,
            device_pools=True, save_every=1, keep_checkpoints=2,
            out_dir=out, **run_kw)
        tr = Trainer(cfg, device=self.dev, data=data)
        graphed = tr.graphed is not None or self.dev.type != "cuda"
        assert ((tr.k_dispatch == 4 and graphed) or cfg.run.debug_nans) \
            and tr.pools is not None, (tr.k_dispatch, tr.graphed, tr.pools)
        return tr

    @staticmethod
    def _epoch_lines(out):
        """{epoch: metrics line} of a run, without its wall-clock fields."""
        with open(os.path.join(out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        return {r.pop("step"): {k: v for k, v in r.items()
                                if k not in ("time", "imgs_per_sec")}
                for r in recs}

    def resume_eval(self):
        """Checkpoints, resume, eval and debug_nans (see phase 21 in the
        module docstring)."""
        import gc
        import shutil
        from uaps_tpu_torch.data import SyntheticDefects
        cfg = self._method_config("uaps")
        data = SyntheticDefects(cfg.data, seed=SEED,
                                labeled_pool=GRAPH_PATH_POOLS[0],
                                unlabeled_pool=GRAPH_PATH_POOLS[1],
                                val_pool=BATCH)
        res = self.report["resume"] = {}
        root = os.path.join(ROOT, "runs", "chip_smoke_resume")
        shutil.rmtree(root, ignore_errors=True)
        bad = []
        for name in RESUME_METHODS:
            t0 = time.perf_counter()
            if not self._resume_case(name, data, os.path.join(root, name),
                                     res):
                bad.append(name)
            gc.collect()
            self.torch.cuda.empty_cache()
            res[name]["seconds"] = time.perf_counter() - t0
            log(f"resume {name}: {res[name]['seconds']:.1f} s")
        uaps_run = os.path.join(root, "uaps", "whole")
        t0 = time.perf_counter()
        self._eval_case(uaps_run, res)
        res["eval"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._nan_case(data, uaps_run, os.path.join(root, "nan"), res)
        res["nan"]["seconds"] = time.perf_counter() - t0
        shutil.rmtree(root, ignore_errors=True)
        assert not bad, f"phase 21 failed for {bad}"

    def _resume_case(self, name, data, root, res):
        """(a) for one method: the uninterrupted run against 1 epoch and a
        resumed epoch 2; returns whether everything was equal."""
        from uaps_tpu_torch.utils.checkpoint import state_tensors
        torch = self.torch
        out = res[name] = {}
        whole_dir, cut_dir = (os.path.join(root, "whole"),
                              os.path.join(root, "cut"))
        epochs = RESUME_RUN[0]
        whole = self._resume_trainer(name, data, whole_dir, epochs)
        whole.run()
        cut = self._resume_trainer(name, data, cut_dir, epochs - 1)
        cut.run()
        del cut
        resumed = self._resume_trainer(name, data, cut_dir, epochs)
        reset_counters()        # the resumed run starts here
        resumed.run(resume=True)
        self.sync()
        launches = counters()   # ... and ends here
        a = state_tensors(whole.state, whole.model, whole.pools)
        b = state_tensors(resumed.state, resumed.model, resumed.pools)
        differ = {k: float((a[k].double() - b[k].double()).abs().max())
                  for k in a if k in b and not torch.equal(a[k], b[k])}
        lines = (self._epoch_lines(whole_dir), self._epoch_lines(cut_dir))
        checks = {
            "the same tensors": a.keys() == b.keys(),
            "every tensor bit-equal": not differ,
            "the same best dice, schedulers and epochs since best": (
                whole.best_dice == resumed.best_dice
                and whole._sched_host() == resumed._sched_host()
                and whole.epochs_since_best == resumed.epochs_since_best),
            "epoch 2's metrics line equal": lines[0][epochs] ==
            lines[1][epochs],
            "the same checkpoints": (whole.ckpt.steps()
                                     == resumed.ckpt.steps()),
            "the resumed step": resumed.state.step == int(
                resumed.state.counter) == epochs * RESUME_RUN[1]}
        out.update({"tensors": len(a), "differ": differ,
                    "steps": whole.ckpt.steps(),
                    "best_dice": [whole.best_dice, resumed.best_dice],
                    "epoch_lines": [lines[0][epochs], lines[1][epochs]],
                    "launches": launches})
        if name == "uaps":
            # the resumed run went through every UAPS kernel; a profiled
            # replay of its graph proves the route
            checks["every UAPS kernel launched in the resumed run"] = all(
                launches[k] >= 1 for k, n in UAPS_STEP_LAUNCHES.items()
                if n)
            ok, got, want, busy = self._graph_route(
                lambda: resumed.graphed(resumed.state), UAPS_STEP_LAUNCHES,
                4, "resumed UAPS replay", "resume_uaps")
            checks["route of the resumed UAPS replay"] = ok
            out["route"], out["route_busy_ms"] = got, busy
        out["checks"] = checks
        ran = {k: v for k, v in launches.items() if v}
        log(f"resume {name}: {len(a)} tensors, steps {out['steps']}, best "
            f"dice {whole.best_dice:.6f} / {resumed.best_dice:.6f}, epoch "
            f"{epochs} loss {lines[0][epochs].get('loss')} / "
            f"{lines[1][epochs].get('loss')}; differing tensors "
            f"{json.dumps(dict(list(differ.items())[:8]))}; launches of "
            f"the resumed run {json.dumps(ran)}")
        for what, ok in checks.items():
            log(f"  resume {name}: {what}: {'ok' if ok else 'FAILED'}")
        return all(checks.values())

    def _eval_case(self, run_dir, res):
        """(b): eval.evaluate on the UAPS run through the kernels (counted,
        its route profiled) and on the plain route; with tta=True and the
        visualisations."""
        import math
        from uaps_tpu_torch.eval import evaluate
        out = res["eval"] = {}
        cfg = self._method_config("uaps")
        plain = self._method_config("uaps", conv_backend="xla")
        got = {}

        def kernel_eval():
            got["kernel"] = evaluate(cfg, run_dir, device=self.dev)

        reset_counters()            # the eval's run starts here
        prof = self._profiled(kernel_eval)
        launches = counters()       # ... and ends here
        n = got["kernel"]["num_images"]
        per_image = {k: 0 for k in launches}
        per_image.update({"conv3x3_nchw": 9, "max_pool_2x2_nchw": 2})
        cuda = self.torch.autograd.DeviceType.CUDA
        entries = [(e.key, e.count) for e in device_work(
            prof.key_averages(), cuda)]
        route = route_of(entries)
        route["max_pool_2x2_fwd_kernel"] = sum(
            c for k, c in entries if "max_pool_2x2_fwd_kernel" in k)
        want = bf16_route(per_image, n)
        want["max_pool_2x2_fwd_kernel"] = 2 * n
        reset_counters()
        got["plain"] = evaluate(plain, run_dir, device=self.dev)
        plain_launches = sum(counters().values())
        viz_dir = os.path.join(run_dir, "viz")
        got["tta"] = evaluate(cfg, run_dir, device=self.dev, tta=True,
                              save_viz=viz_dir)
        pngs = sorted(os.listdir(viz_dir))
        k, p = got["kernel"], got["plain"]
        diffs = {m: abs(k[m] - p[m]) for m in ("miou", "mdice",
                                               "pixel_acc")}
        class_diff = [abs(a - b) if not (math.isnan(a) or math.isnan(b))
                      else (0.0 if math.isnan(a) and math.isnan(b)
                            else float("inf"))
                      for a, b in zip(k["class_iou"], p["class_iou"])]
        checks = {
            "8 images at batch 1": n == p["num_images"] == 8,
            "the kernels' launches: 9 conv and 2 pool an image": launches
            == {name: c * n for name, c in per_image.items()},
            "their route (profiler)": route == want,
            "the plain route launches no kernel": plain_launches == 0,
            f"kernel vs plain within {EVAL_TOL}": max(diffs.values())
            <= EVAL_TOL,
            f"per-class IoU within {2 * EVAL_TOL}": max(class_diff)
            <= 2 * EVAL_TOL,
            "tta: finite metrics": all(math.isfinite(got["tta"][m]) for m
                                       in ("miou", "mdice", "pixel_acc")),
            "tta: 3 PNGs an image": len(pngs) == 3 * n}
        out.update({"results": got, "diffs": diffs,
                    "class_iou_diff": class_diff, "launches": launches,
                    "route": route, "route_want": want, "checks": checks})
        card = self.report.get("nvidia_smi", "")
        for path, r in got.items():
            log(f"eval {path} ({card}): miou {r['miou']:.6f} mdice "
                f"{r['mdice']:.6f} pixel_acc {r['pixel_acc']:.6f} class IoU "
                f"{json.dumps(r['class_iou'])}; latency p50 "
                f"{r['p50_latency_ms']:.3f} ms, p99 "
                f"{r['p99_latency_ms']:.3f} ms ({r['num_images']} images, "
                f"batch 1, host clock)")
        log(f"eval route (profiler): {json.dumps(route)}; launches "
            f"{json.dumps({c: v for c, v in launches.items() if v})}")
        for what, ok in checks.items():
            log(f"  eval: {what}: {'ok' if ok else 'FAILED'}")
        assert all(checks.values()), checks

    def _nan_case(self, data, run_dir, nan_dir, res):
        """(c): debug_nans names the module of a NaN conv weight;
        halt_on_nan names (a)'s last good step."""
        torch = self.torch
        out = res["nan"] = {}
        tr = self._resume_trainer("uaps", data, nan_dir, 1,
                                  debug_nans=True)
        assert tr.k_dispatch == 1 and tr.graphed is None
        with torch.no_grad():
            tr.model.encoder.down1.maxpool_conv[1].conv_conv[0].weight[
                0, 0, 0, 0] = float("nan")
        try:
            tr.run()
            out["debug_nans"] = "no error"
        except FloatingPointError as exc:
            out["debug_nans"] = str(exc)
        log(f"debug_nans with a NaN conv weight: {out['debug_nans']}")
        assert ("'encoder.down1.maxpool_conv.1.conv_conv.0'"
                in out["debug_nans"]), out["debug_nans"]

        last = RESUME_RUN[0] * RESUME_RUN[1]
        tr = self._resume_trainer("uaps", data, run_dir, RESUME_RUN[0] + 1)
        start = tr.pools.start_epoch
        weight = tr.model.encoder.in_conv.conv_conv[0].weight

        def poisoned(epoch):
            if epoch == RESUME_RUN[0] + 1:
                with torch.no_grad():
                    weight.fill_(float("nan"))
            start(epoch)

        tr.pools.start_epoch = poisoned
        try:
            tr.run(resume=True)
            out["halt_on_nan"] = "no error"
        except FloatingPointError as exc:
            out["halt_on_nan"] = str(exc)
        log(f"halt_on_nan after resuming step {last}: {out['halt_on_nan']}")
        assert f"last good checkpoint: step {last}" in out["halt_on_nan"], \
            out["halt_on_nan"]

    # ------------------------------------------------------------ phase 22
    def _real_argv(self, roots, method="uaps", *extra):
        """The CLI flags of `method` at the neu preset on the image set
        `roots`; the CLIs' default device (cuda), and BATCH, where a
        rehearsal on the CPU shrinks it."""
        cpu = ["--device", "cpu"] if self.dev.type == "cpu" else []
        return ["--preset", "neu", "--method", method, "--dtype",
                "bfloat16", "--batch_size", str(BATCH), "--seed", str(SEED),
                "--image_root", roots["image_root"],
                "--mask_root", roots["mask_root"],
                "--test_image_root", roots["test_image_root"],
                "--test_mask_root", roots["test_mask_root"], *cpu, *extra]

    def real_images(self):
        """Real image files (see phase 22 in the module docstring); the
        image sets are removed at the end, also after a failure."""
        import shutil
        res = self.report["real"] = {}
        shutil.rmtree(REAL_DIR, ignore_errors=True)
        try:
            roots = self._real_write(res)
            bad = [part for part, ok in (
                ("stream", self._real_stream(roots, res)),
                ("host-fed graphs", self._real_graphs(roots["neu"], res)))
                if not ok]
            run_dir = self._real_trainer(roots["neu"], res)
            self._real_eval(roots["neu"], run_dir, res)
            self._real_serve(roots["neu"], run_dir, res)
            self._real_cps(res)
        finally:
            shutil.rmtree(REAL_DIR, ignore_errors=True)
        assert not bad, f"phase 22 failed: {bad}"

    def _real_write(self, res):
        """(a): the image sets; {dataset: its DataConfig roots}."""
        from uaps_tpu_torch.data.synthetic import write_image_set
        roots = {}
        for name, (n, n_test, hw), classes in (
                ("neu", REAL_NEU, NUM_CLASSES), ("kosdd2", REAL_KOSDD2, 2)):
            t0 = time.perf_counter()
            roots[name] = write_image_set(os.path.join(REAL_DIR, name), name,
                                          n, n_test, hw, classes, SEED)
            dt = time.perf_counter() - t0
            res[f"write_{name}"] = {"images": n + n_test, "seconds": dt}
            log(f"wrote {n} train and {n_test} test {name} images "
                f"({hw[0]} x {hw[1]}) with their masks in {dt:.2f} s "
                f"({(n + n_test) / dt:.0f} images/s)")
        return roots

    def _real_stream(self, roots, res):
        """(b): the neu stream's rate, its determinism, and the batches of
        neu, ucc_neu and kosdd2; returns whether every check passed."""
        import numpy as np
        from uaps_tpu_torch.train import make_data
        from uaps_tpu_torch.utils.cli import parse_args
        out = res["stream"] = {}
        cfg, _ = parse_args(self._real_argv(roots["neu"]))
        d = cfg.data
        data = make_data(cfg, seed=SEED)
        it = data.train_iter()
        next(it)                       # the threads start, the first batch
        t0 = time.perf_counter()
        for _ in range(REAL_STREAM_BATCHES):
            next(it)
        dt = time.perf_counter() - t0
        images = REAL_STREAM_BATCHES * 2 * d.batch_size
        out.update({"images_per_s": images / dt, "seconds": dt,
                    "batches": REAL_STREAM_BATCHES,
                    "cores": len(os.sched_getaffinity(0)),
                    "num_workers": d.num_workers,
                    "splits": {k: len(v) for k, v in data.splits.items()}})
        card = self.report.get("nvidia_smi", "")
        log(f"the neu stream alone (train_iter, {d.batch_size} + "
            f"{d.batch_size} images a batch, {d.num_workers} workers a "
            f"stream, {out['cores']} cores; {card}): "
            f"{out['images_per_s']:.1f} images/s over "
            f"{REAL_STREAM_BATCHES} batches after the first ({dt:.2f} s); "
            f"splits {json.dumps(out['splits'])}")
        # one thread's CPU-ms an image of each stage of the stream
        from uaps_tpu_torch.data.augment import normalize
        aug, rng = data.spec.train_aug(), np.random.default_rng(SEED)
        ms = {"decode": [], "augment": [], "normalize": []}
        for stem in data.splits["labeled"][:REAL_STAGE_IMAGES]:
            t0 = time.perf_counter()
            img, mask = data._read(d.image_root, d.mask_root, stem)
            t1 = time.perf_counter()
            img, mask = aug(rng, img, mask)
            t2 = time.perf_counter()
            normalize(img, d.mean, d.std)
            t3 = time.perf_counter()
            for stage, dt_ in zip(ms, (t1 - t0, t2 - t1, t3 - t2)):
                ms[stage].append(1e3 * dt_)
        out["one_thread_ms_an_image"] = {k: float(np.mean(v))
                                         for k, v in ms.items()}
        log(f"one thread, ms an image (mean of {REAL_STAGE_IMAGES}): "
            + ", ".join(f"{k} {v:.3f}" for k, v in
                        out["one_thread_ms_an_image"].items()))
        checks = {}
        a, b = (make_data(cfg, seed=SEED).train_iter() for _ in range(2))
        pairs = [(next(a), next(b)) for _ in range(REAL_SAME_BATCHES)]
        checks[f"one seed, the same first {REAL_SAME_BATCHES} batches"] = all(
            x.keys() == y.keys() and all(np.array_equal(x[k], y[k])
                                         for k in x) for x, y in pairs)
        hw = (HW, HW)
        cases = {"neu": (pairs[0][0], d.batch_size, hw, 3, NUM_CLASSES)}
        ucc, _ = parse_args(self._real_argv(roots["neu"], "ucc"))
        udata = make_data(ucc, seed=SEED)
        cases["ucc_neu"] = (next(udata.train_iter_weak_strong()),
                            d.batch_size, hw, 3, NUM_CLASSES)
        kos, _ = parse_args(["--preset", "kosdd2", "--seed", str(SEED),
                             "--image_root", roots["kosdd2"]["image_root"],
                             "--mask_root", roots["kosdd2"]["mask_root"]])
        cases["kosdd2"] = (next(make_data(kos, seed=SEED).train_iter()),
                           kos.data.batch_size, (256, 512), 3, 2)
        checks["ucc_neu read through UCC's recipe"] = \
            udata.spec.name == "ucc_neu"
        for name, (batch, bs, (h, w), c, classes) in cases.items():
            want = {"image": (bs, h, w, c), "label": (bs, h, w),
                    "uimage": (bs, h, w, c), "ulabel": (bs, h, w)}
            if name == "ucc_neu":
                want["uimage_strong"] = (bs, h, w, c)
            got = {k: tuple(v.shape) for k, v in batch.items()}
            labels = np.unique(np.concatenate([batch["label"].ravel(),
                                               batch["ulabel"].ravel()]))
            checks[f"{name}: keys and shapes"] = got == want
            checks[f"{name}: f32 images, int32 labels in [0, {classes})"] = (
                all(batch[k].dtype == np.float32 for k in want
                    if "image" in k)
                and all(batch[k].dtype == np.int32 for k in want
                        if "label" in k)
                and 0 <= int(labels.min()) and int(labels.max()) < classes)
            out[name] = {"shapes": got, "labels": labels.tolist()}
            log(f"{name} batch: {json.dumps(got)}, labels "
                f"{labels.tolist()}")
        out["checks"] = checks
        for what, ok in checks.items():
            log(f"  stream: {what}: {'ok' if ok else 'FAILED'}")
        return all(checks.values())

    def _state_copies(self, model, state):
        """{name: copy} of every module's weights and buffers and every
        Adam's state (_modules, _optimizers)."""
        out = {f"module{j}.{n}": v.detach().clone()
               for j, m in enumerate(self._modules(model, state))
               for n, v in m.state_dict().items()}
        for j, opt in enumerate(self._optimizers(state)):
            for i, st in enumerate(opt.state.values()):
                out.update({f"adam{j}.{i}.{n}": v.clone()
                            for n, v in st.items()})
        return out

    def _real_graphs(self, roots, res):
        """(c) for uaps and ucc; returns whether every check passed."""
        from uaps_tpu_torch.train import make_data, train_stream
        from uaps_tpu_torch.utils.cli import parse_args
        out = res["host_graph"] = {}
        ok = True
        for name in ("uaps", "ucc"):
            t0 = time.perf_counter()
            cfg, _ = parse_args(self._real_argv(roots, name))
            stream = train_stream(make_data(cfg, seed=SEED), name == "ucc")
            ok &= self._host_graph_case(name, cfg, stream, out)
            out[name]["seconds"] = time.perf_counter() - t0
            self.torch.cuda.empty_cache()
        return ok

    def _host_graph_case(self, name, cfg, stream, out):
        """One method's graph of K steps fed host batches, against K eager
        steps on the same batches from one state."""
        from uaps_tpu_torch import dispatch
        from uaps_tpu_torch.methods import get_method
        from uaps_tpu_torch.train import to_device
        torch = self.torch
        k = dispatch.AUTO_STEPS_CUDA
        res = out[name] = {}
        method = get_method(name)
        state, model = method.init_state(
            cfg, self.dev, torch.Generator().manual_seed(SEED))
        step = method.make_train_step(cfg, model)
        reset_counters()   # one eager step: its launches are a step's
        state, _ = step(state, to_device(next(stream), self.dev))
        self.sync()
        per_step = counters()
        graphed = dispatch.GraphedSteps(step, k, self.dev)   # no sampler
        first, second = ([next(stream) for _ in range(k)] for _ in range(2))
        reset_counters()
        t0 = time.perf_counter()
        state, warm = graphed(state, first)   # K eager steps, the capture
        self.sync()
        res["first_dispatch_s"] = time.perf_counter() - t0
        launched = counters()
        reset_counters()
        checks = {}
        if name == "uaps":
            checks["a step launches UAPS_STEP_LAUNCHES"] = \
                per_step == UAPS_STEP_LAUNCHES
        checks["warm-up and capture through every wrapper"] = (
            any(per_step.values())
            and launched == {n: 2 * k * v for n, v in per_step.items()})
        snap = self._snapshot(model, state, None)
        batches = [to_device(b, self.dev) for b in second]
        state, em = dispatch.run_steps(step, state, lambda i: batches[i], k)
        eager = self._state_copies(model, state)
        self._restore(snap, model, state, None)
        state, gm = graphed(state, second)
        self.sync()
        graph = self._state_copies(model, state)
        differ = {n: float((graph[n].double() - v.double()).abs().max())
                  for n, v in eager.items() if not torch.equal(graph[n], v)}
        checks["metrics bit-equal"] = all(torch.equal(gm[n], em[n])
                                          for n in em)
        checks["weights, BN stats and Adam's state bit-equal"] = \
            not differ and graph.keys() == eager.keys()
        checks["finite metrics"] = all(
            bool(torch.isfinite(v).all()) for m in (warm, em, gm)
            for v in m.values())
        ok, got, _, busy = self._graph_route(
            lambda: graphed(state, second), per_step, k,
            f"host-fed {name} replay", f"real_{name}_graph")
        checks["route of a replay (4 x the step's launches)"] = ok
        res.update({"launches_a_step": {n: v for n, v in per_step.items()
                                        if v},
                    "tensors": len(eager), "differ": differ, "route": got,
                    "busy_ms": busy, "checks": checks,
                    "eager": {n: em[n].tolist() for n in em},
                    "graph": {n: gm[n].tolist() for n in gm}})
        log(f"host-fed {name} graph of {k} steps: first dispatch (warm-up, "
            f"capture) {res['first_dispatch_s']:.2f} s; against {k} eager "
            f"steps on the same host batches from one state "
            f"({len(eager)} tensors: weights, BN stats, Adam): losses "
            f"{[round(float(v), 5) for v in gm['loss']]} and "
            f"{[round(float(v), 5) for v in em['loss']]}; differing "
            f"{json.dumps(dict(list(differ.items())[:6]))}; launches a "
            f"step {json.dumps(res['launches_a_step'])}")
        for what, passed in checks.items():
            log(f"  host-fed {name} graph: {what}: "
                f"{'ok' if passed else 'FAILED'}")
        return all(checks.values())

    def _real_trainer(self, roots, res):
        """(d): the training CLI on the image set, then its graphed
        dispatches from the host stream against a device-pool graph;
        returns the run directory."""
        import math
        from uaps_tpu_torch import train
        from uaps_tpu_torch.data import pipeline
        from uaps_tpu_torch.utils.checkpoint import CheckpointManager
        from uaps_tpu_torch.utils.cli import parse_args
        out = res["trainer"] = {}
        run_dir = os.path.join(REAL_DIR, "run")
        epochs, iters = REAL_TRAINER
        argv = self._real_argv(roots, "uaps", "--epochs", str(epochs),
                               "--iter_per_epoch", str(iters), "--out_dir",
                               run_dir)
        cfg, _ = parse_args(argv)
        n_val = len(train.make_data(cfg, seed=SEED).splits["val"])
        bs = cfg.data.batch_size
        want_sizes = epochs * ([bs] * (n_val // bs)
                               + ([n_val % bs] if n_val % bs else []))
        sizes = []
        finite = pipeline.DefectDataset._finite

        def recorded(data, ids, *a, **kw):
            for batch in finite(data, ids, *a, **kw):
                sizes.append(len(batch["image"]))
                yield batch

        pipeline.DefectDataset._finite = recorded
        try:
            reset_counters()       # the main path's run starts here
            t0 = time.perf_counter()
            best = train.main(argv)
            self.sync()
            dt = time.perf_counter() - t0
            launches = counters()  # ... and ends here
        finally:
            pipeline.DefectDataset._finite = finite
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        steps = CheckpointManager(os.path.join(run_dir, "checkpoints")).steps()
        path_kernels = [n for n, v in UAPS_STEP_LAUNCHES.items() if v]
        checks = {
            "every UAPS kernel launched in the run": all(
                launches[n] >= 1 for n in path_kernels),
            f"{epochs} finite metrics lines": len(recs) == epochs and all(
                math.isfinite(r[n]) for r in recs
                for n in ("loss", "sup_loss", "ps_loss", "uncertainty_loss",
                          "train_mdice", "val_loss", "val_mdice", "lr")),
            "a checkpoint and best_model.pth": bool(steps) and os.path.exists(
                os.path.join(run_dir, "best_model.pth")),
            f"val sweeps of {n_val} images, the last batch "
            f"{want_sizes[-1]}": sizes == want_sizes}
        out.update({"seconds": dt, "best": best, "records": recs,
                    "checkpoints": steps, "launches": launches,
                    "val_batches": sizes, "checks": checks})
        log(f"train.main on the image set ({epochs} epochs of {iters} UAPS "
            f"steps, K = 4 graph from the host stream) in {dt:.1f} s: "
            + "; ".join(f"epoch {r['step']} loss {r['loss']:.4f} val_mdice "
                        f"{r['val_mdice']:.4f} {r['imgs_per_sec']:.1f} img/s"
                        for r in recs)
            + f"; checkpoints {steps}; val batches of the last epoch "
            f"{sizes[len(sizes) - len(sizes) // epochs:]}; launches "
            f"{json.dumps({n: v for n, v in launches.items() if v})}")
        for what, ok in checks.items():
            log(f"  train: {what}: {'ok' if ok else 'FAILED'}")
        assert all(checks.values()), checks
        self._real_rates(cfg, out)
        return run_dir

    def _real_rates(self, cfg, out):
        """(d)'s timing: the Trainer's graphed dispatches from the host
        stream against a device-pool graph of the same step on synthetic
        pools, in alternating rounds of REAL_ROUNDS[1] dispatches (a sync
        after each round); the host-fed rate in its steady state (the
        median interval between dispatches after the first quarter of a
        round, once the batches the stream had ready are used up) and the
        stages of a host-fed dispatch (waiting for the stream's batches;
        the dispatch call: stacking, waiting for the previous copy to the
        card, the pinned staging and the replay's enqueue); the host time
        before a round's first replay, while the card has nothing queued
        (the by-rounds rate pays it once a round, the steady state not);
        device busy and idle share of each path from a profiled window."""
        import numpy as np
        from uaps_tpu_torch import dispatch, train
        from uaps_tpu_torch.data import SyntheticDefects
        from uaps_tpu_torch.data.device_pool import PoolSampler
        from uaps_tpu_torch.methods import get_method
        torch = self.torch
        cfg.run = dataclasses.replace(
            cfg.run, out_dir=os.path.join(REAL_DIR, "rates"))
        tr = train.Trainer(cfg, device=self.dev)
        k = tr.k_dispatch
        assert tr.graphed is not None and tr.pools is None, (tr.graphed,
                                                             tr.pools)
        stream = train.train_stream(tr.data, False)
        tr._dispatch(stream)            # K eager steps, then the capture
        pool_cfg = self._uaps_config()
        pools = SyntheticDefects(pool_cfg.data, seed=SEED,
                                 labeled_pool=GRAPH_PATH_POOLS[0],
                                 unlabeled_pool=GRAPH_PATH_POOLS[1])
        sampler = PoolSampler(pools, BATCH, SEED, self.dev)
        sampler.start_epoch(1)
        method = get_method("uaps")
        pstate, pmodel = method.init_state(
            pool_cfg, self.dev, torch.Generator().manual_seed(SEED))
        pgraph = dispatch.GraphedSteps(
            method.make_train_step(pool_cfg, pmodel), k, self.dev, sampler)
        pgraph(pstate)
        n = REAL_ROUNDS[1]
        stages = {"wait_for_batches": [], "dispatch_call": []}
        steady = []
        rounds_seen = []   # per round: each dispatch's stages, seconds
        inner = {}
        stack = dispatch.stack_batches

        def timed_stack(batches):
            t0 = time.perf_counter()
            out = stack(batches)
            inner["stack"] = time.perf_counter() - t0
            return out

        class TimedEvent:
            """The graph's copy event, its host wait timed."""

            def __init__(self, ev):
                self.ev = ev

            def synchronize(self):
                t0 = time.perf_counter()
                self.ev.synchronize()
                inner["synced_at"] = time.perf_counter()
                inner["copy_wait"] = inner["synced_at"] - t0

            def record(self):   # after the copies, before the replay
                self.ev.record()
                inner["recorded_at"] = time.perf_counter()

        tr.graphed._copied = TimedEvent(tr.graphed._copied)

        def host_fed(count=n):
            starts, seen = [], []
            for _ in range(count):
                t0 = time.perf_counter()
                starts.append(t0)
                host = [next(stream) for _ in range(k)]
                t1 = time.perf_counter()
                tr.graphed(tr.state, host)
                t2 = time.perf_counter()
                stages["wait_for_batches"].append(t1 - t0)
                stages["dispatch_call"].append(t2 - t1)
                seen.append({
                    "wait": t1 - t0, "call": t2 - t1, "stack": inner["stack"],
                    "copy_wait": inner["copy_wait"],
                    "fill": inner["recorded_at"] - inner["synced_at"],
                    "after": t2 - inner["recorded_at"]})
            steady.extend(b - a for a, b in zip(starts[count // 4:-1],
                                                 starts[count // 4 + 1:]))
            if count == n:
                rounds_seen.append(seen)

        def device_pools(count=n):
            for _ in range(count):
                pgraph(pstate)

        paths = {"host_fed": host_fed, "device_pools": device_pools}
        dispatch.stack_batches = timed_stack
        try:
            rounds = self._dispatch_rounds(paths, k * n,
                                           rounds=REAL_ROUNDS[0], reps=1)
        finally:
            dispatch.stack_batches = stack
        cuda = torch.autograd.DeviceType.CUDA
        t = self.report["times"]
        card = self.report.get("nvidia_smi", "")
        for path, fn in paths.items():
            prof = self._profiled(lambda: fn(REAL_PROFILED))
            busy = sum(e.self_device_time_total for e in device_work(
                prof.key_averages(), cuda)) / (REAL_PROFILED * k) / 1e3
            med = rounds[path]["median"]
            t[f"real_{path}_step_ms"] = rounds[path]
            t[f"real_{path}_device_busy_ms"] = busy
            t[f"real_{path}_idle_share"] = 1.0 - busy / med
        t["real_host_fed_steady_step_ms"] = 1e3 * float(
            np.median(steady)) / k
        host = {s: 1e3 * float(np.median(v)) / k for s, v in stages.items()}
        out["host_stages_ms_a_step"] = host
        # a round starts on an idle card: until the first dispatch's batches
        # are taken, stacked and staged, no replay is queued
        first = [r[0] for r in rounds_seen]
        start = {name: 1e3 * float(np.mean([d[name] for d in first]))
                 for name in first[0]}
        start["before_first_replay"] = (start["wait"] + start["stack"]
                                        + start["fill"])
        q = n // 4
        waits = {part: 1e3 * float(np.mean([d["wait"] for r in rounds_seen
                                            for d in r[sl]])) / k
                 for part, sl in (("first_quarter", slice(0, q)),
                                  ("rest", slice(q, None)))}
        out["round_start_ms"] = start
        out["wait_for_batches_ms_a_step"] = waits
        t["real_host_fed_round_start_ms"] = start["before_first_replay"]
        log(f"UAPS graph of {k} steps ({card}): " + "; ".join(
            f"{path} {rounds[path]['median']:.3f} ms a step "
            f"[{rounds[path]['min']:.3f}, {rounds[path]['max']:.3f}], device "
            f"busy {t[f'real_{path}_device_busy_ms']:.3f} ms, idle share "
            f"{t[f'real_{path}_idle_share']:.3f}" for path in paths)
            + f"; host-fed steady state {t['real_host_fed_steady_step_ms']:.3f}"
            " ms a step; its stages a step (median, host clock): "
            + ", ".join(f"{s} {v:.3f} ms" for s, v in host.items())
            + f"; a round's start before its first replay "
            f"{start['before_first_replay']:.3f} ms (waiting for batches "
            f"{start['wait']:.3f}, stacking {start['stack']:.3f}, the pinned "
            f"fill and the copies' enqueue {start['fill']:.3f}; "
            f"{start['before_first_replay'] / (k * n):.3f} ms a step of a "
            f"round), then the replay's enqueue and the metrics' clones "
            f"{start['after']:.3f} ms; waiting for batches a step "
            f"{waits['first_quarter']:.3f} ms in a round's first quarter, "
            f"{waits['rest']:.3f} after it")

    def _real_eval(self, roots, run_dir, res):
        """(e): the eval CLI on the test directory at batch 1."""
        import math
        from uaps_tpu_torch import eval as peval
        reset_counters()
        r = peval.main(self._real_argv(roots, "uaps", "--ckpt", run_dir))
        self.sync()
        launches = counters()
        n = r["num_images"]
        per_image = {"conv3x3_nchw": 9, "max_pool_2x2_nchw": 2}
        checks = {
            f"{REAL_NEU[1]} test images": n == REAL_NEU[1],
            "finite metrics": all(math.isfinite(r[m]) for m in (
                "miou", "mdice", "pixel_acc", "p50_latency_ms")),
            "9 conv and 2 pool launches an image, no other": launches == {
                c: per_image.get(c, 0) * n for c in launches}}
        res["eval"] = {"results": r, "launches": launches,
                       "checks": checks}
        card = self.report.get("nvidia_smi", "")
        log(f"eval CLI on {n} test images at batch 1 ({card}): miou "
            f"{r['miou']:.6f} mdice {r['mdice']:.6f} pixel_acc "
            f"{r['pixel_acc']:.6f}; latency p50 {r['p50_latency_ms']:.3f} "
            f"ms, p99 {r['p99_latency_ms']:.3f} ms (host clock)")
        for what, ok in checks.items():
            log(f"  eval: {what}: {'ok' if ok else 'FAILED'}")
        assert all(checks.values()), checks

    def _real_serve(self, roots, run_dir, res):
        """(f): the serve directory CLI on REAL_SERVE_IMAGES test images,
        against InferenceEngine.predict of the same decoded batch."""
        import shutil
        import numpy as np
        from uaps_tpu_torch import serve
        from uaps_tpu_torch.data.augment import cv2
        from uaps_tpu_torch.utils.checkpoint import module_tensors, restore_run
        from uaps_tpu_torch.utils.cli import parse_args
        src = os.path.join(REAL_DIR, "serve_in")
        dst = os.path.join(REAL_DIR, "serve_out")
        os.makedirs(src)
        test_dir = roots["test_image_root"]
        for f in sorted(os.listdir(test_dir))[:REAL_SERVE_IMAGES]:
            shutil.copy(os.path.join(test_dir, f), src)
        argv = self._real_argv(roots, "uaps", "--ckpt", run_dir, "--images",
                               src, "--out", dst)
        reset_counters()
        r = serve.main(argv)
        self.sync()
        launches = counters()
        cfg, _ = parse_args(argv)
        names, batch = serve.read_images(src, cfg.data.image_size)
        engine = serve.InferenceEngine(
            cfg, state_dict=module_tensors(restore_run(run_dir)[0]),
            device=self.dev)
        masks, _ = engine.predict(batch)
        written = [cv2().imread(os.path.join(
            dst, os.path.splitext(n)[0] + "_mask.png"), cv2().IMREAD_UNCHANGED)
            for n in names]
        batches = -(-len(names) // cfg.data.batch_size)
        checks = {
            f"{REAL_SERVE_IMAGES} images": r["images"] == len(names)
            == REAL_SERVE_IMAGES,
            "the written masks equal predict": all(
                w is not None and np.array_equal(w, m)
                for w, m in zip(written, masks)),
            "9 conv and 2 pool launches a batch": (
                launches["conv3x3_nchw"] == 9 * batches
                and launches["max_pool_2x2_nchw"] == 2 * batches)}
        res["serve"] = {"result": r, "launches": launches, "checks": checks}
        card = self.report.get("nvidia_smi", "")
        log(f"serve CLI on {r['images']} images ({card}): "
            f"{r['imgs_per_sec']:.1f} images/s (predict of the decoded "
            f"batch, host clock, {r['seconds']:.3f} s)")
        for what, ok in checks.items():
            log(f"  serve: {what}: {'ok' if ok else 'FAILED'}")
        assert all(checks.values()), checks

    def _real_cps(self, res):
        """(g): cps deterministic with cuDNN's default algorithms."""
        from uaps_tpu_torch.data import SyntheticDefects
        from uaps_tpu_torch.data.device_pool import PoolSampler
        torch = self.torch
        cfg = self._method_config("cps")
        data = SyntheticDefects(cfg.data, seed=SEED,
                                labeled_pool=GRAPH_PATH_POOLS[0],
                                unlabeled_pool=GRAPH_PATH_POOLS[1])
        sampler = PoolSampler(data, BATCH, SEED, self.dev)
        sampler.start_epoch(1)
        assert not torch.backends.cudnn.deterministic
        diff = self._eager_repeat(cfg, "cps", sampler)
        m = self.report.get("methods", {}).get("cps", {})
        graph_ms = self.report["times"].get("method_cps_step_ms", {}).get(
            "graph", {})
        checks = {
            "two eager steps from one state: the same gradients": not diff,
            "phase 20's cps graph bit-equal, cuDNN's defaults": bool(
                m.get("checks")) and all(m["checks"].values())
            and m.get("cudnn_deterministic") is False}
        res["cps"] = {"differ": diff, "graph_ms": graph_ms,
                      "checks": checks}
        card = self.report.get("nvidia_smi", "")
        if graph_ms:
            log(f"cps graphed with cuDNN's default algorithms ({card}): "
                f"{graph_ms['median']:.3f} ms a step [{graph_ms['min']:.3f}, "
                f"{graph_ms['max']:.3f}] (with cuDNN's f32 heads on an H100 "
                f"at 700 W, PERF.md section 5: 69.310 with its default "
                f"algorithms, 76.284 with its deterministic ones)")
        for what, ok in checks.items():
            log(f"  cps: {what}: {'ok' if ok else 'FAILED'}")
        assert all(checks.values()), checks



KERNELS = [
    ("conv3x3_nchw", "conv3x3_nchw", "uaps_tpu/pallas/conv3x3_nchw.py:289"),
    ("conv3x3_nchw_dgrad", "conv3x3_nchw",
     "uaps_tpu/pallas/conv3x3_nchw.py:987"),
    ("conv3x3_nchw_wgrad", "conv3x3_wgrad_nchw",
     "uaps_tpu/pallas/conv3x3_nchw.py:601"),
    ("max_pool_2x2_nchw", "pool_nchw", "uaps_tpu/pallas/pool_nchw.py:138"),
    ("max_pool_2x2_nchw_bwd", "pool_nchw", "uaps_tpu/pallas/pool_nchw.py:161"),
    ("ce_dice_fwd", "ce_dice", "uaps_tpu/pallas/ce_dice.py:103"),
    ("ce_dice_bwd", "ce_dice", "uaps_tpu/pallas/ce_dice.py:157"),
    ("fused_dropout", "perturb", "uaps_tpu/pallas/perturb.py:83"),
    ("feature_noise", "perturb", "uaps_tpu/pallas/perturb.py:106"),
    ("feature_dropout", "perturb", "uaps_tpu/pallas/perturb.py:259"),
    ("feature_dropout_bwd", "perturb", "uaps_tpu/pallas/perturb.py:327"),
    ("uncertainty_fwd", "uncertainty", "uaps_tpu/pallas/uncertainty.py:155"),
    ("uncertainty_bwd", "uncertainty", "uaps_tpu/pallas/uncertainty.py:193"),
]
# the kernels whose launches the UAPS run (phase 10) reports
UAPS_KERNELS = ("fused_dropout", "feature_noise", "feature_dropout",
                "feature_dropout_bwd", "uncertainty_fwd", "uncertainty_bwd")
# ... and the fused-block kernels, whose launches the chain and fused runs
# (phase 13) report
KERNELS += [
    ("chain_conv_plain", "block_conv", "uaps_tpu/pallas/block_conv.py:217"),
    ("chain_conv_bnl", "block_conv", "uaps_tpu/pallas/block_conv.py:217"),
    ("chain_conv_plain_bwd", "block_conv",
     "uaps_tpu/pallas/block_conv.py:345"),
    ("chain_conv_bnl_bwd", "block_conv", "uaps_tpu/pallas/block_conv.py:345"),
    ("conv3x3_bnl", "block_conv", "uaps_tpu/pallas/conv_bnl.py:149"),
    ("conv3x3_bnl_bwd", "block_conv", "uaps_tpu/pallas/conv_bnl.py:196"),
]
# ... and the pseudo-label kernel, whose launches the unfused run (phase
# 16a) reports
KERNELS += [("pseudo_label", "pseudo_label",
             "uaps_tpu/pallas/pseudo_label.py:60")]
# ... and the fullh entries (launches from the fullh + flat-BN run, phase
# 18a), the stats conv (the bn_stats blocks' run, 18b) and the NHWC conv
# (its run, 18c)
KERNELS += [
    ("conv3x3_nchw_fullh", "conv3x3_nchw",
     "uaps_tpu/pallas/conv3x3_nchw.py:752"),
    ("conv3x3_nchw_fullh_dgrad", "conv3x3_nchw",
     "uaps_tpu/pallas/conv3x3_nchw.py:932"),
    ("conv3x3_nchw_wgrad_fullh", "conv3x3_wgrad_nchw",
     "uaps_tpu/pallas/conv3x3_nchw.py:803"),
    ("conv3x3_nchw_stats", "block_conv",
     "uaps_tpu/pallas/conv3x3_nchw.py:1022"),
    ("conv3x3_nchw_stats_bwd", "block_conv",
     "uaps_tpu/pallas/conv3x3_nchw.py:1078"),
    ("conv3x3_nhwc", "conv3x3_nhwc", "uaps_tpu/pallas/conv3x3.py:73"),
    ("conv3x3_nhwc_wgrad", "conv3x3_nhwc", "uaps_tpu/pallas/conv3x3.py:138"),
]


def launches_of(s, name):
    """The kernel's launches on the run of the path that reports it."""
    if name in CHAIN_COUNTERS:
        path = "fused" if name.startswith("conv3x3_bnl") else "chain"
        return s.fused_launches[path][name]
    if name == "pseudo_label":
        return s.unfused_launches[name]
    if name in FULLH_COUNTERS:
        return s.fullh_launches[name]
    if name in STATS_COUNTERS:
        return s.stats_launches[name]
    if name in NHWC_COUNTERS:
        return s.nhwc_launches[name]
    return (s.uaps_launches if name in UAPS_KERNELS
            else s.train_launches)[name]


def image_decoders():
    """{module: its version, or why it does not import} for the image
    decoders a real-image pipeline could use: cv2, PIL, torchvision.io."""
    import importlib
    out = {}
    for name, top in (("cv2", "cv2"), ("PIL", "PIL"),
                      ("torchvision.io", "torchvision")):
        try:
            importlib.import_module(name)
            out[name] = str(getattr(importlib.import_module(top),
                                    "__version__", "unknown version"))
        except Exception as exc:   # absent, or broken on this machine
            out[name] = f"absent ({type(exc).__name__}: {exc})"
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a GPU", file=sys.stderr)
        return 2
    try:
        import uaps_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run it from the repository root ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    s = Smoke(torch, "cuda:0")
    s.report["versions"] = {"python": sys.version, "torch": torch.__version__,
                            "cuda": torch.version.cuda,
                            "image_decoders": image_decoders()}
    log(f"image decoders: "
        f"{json.dumps(s.report['versions']['image_decoders'])}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    if s.phase("1 build", s.build):
        s.phase("2 kernels vs plain", s.kernels)
        if s.phase("3 serving", s.serving):
            if s.phase("4 end to end vs plain", s.end_to_end):
                s.phase("5 times", s.times)
        s.phase("6 training kernels vs plain", s.train_kernels)
        if s.phase("7 training", s.training):
            s.phase("8 training times", s.train_times)
        s.phase("9 UAPS kernels vs plain", s.uaps_kernels)
        uaps_ok = s.phase("10 UAPS training", s.uaps_training)
        if uaps_ok:
            s.phase("11 UAPS times", s.uaps_times)
        s.phase("12 fused-block kernels vs plain", s.chain_kernels)
        if s.phase("13 chain and fused UAPS training", s.chain_training):
            s.phase("14 fused-block times", s.chain_times)
        s.phase("15 pseudo-label kernel vs plain", s.pseudo_kernels)
        if uaps_ok:
            s.phase("16a the unfused UAPS route", s.unfused_training)
        s.phase("16b the dagm, mtiles and kosdd2 presets",
                s.preset_training)
        s.phase("17 fullh, stats and NHWC kernels vs plain",
                s.other_conv_kernels)
        s.phase("18 the fullh + flat-BN UAPS step, the bn_stats blocks, "
                "the NHWC conv", s.fullh_flat_training)
        s.phase("19 the UAPS and baseline steps as CUDA graphs, the "
                "Trainer, the chain, fused, unfused, fullh + flat-BN and "
                "preset steps as graphs", s.graph_training)
        s.phase("20 the cct, mt, uamt, dct, ucc and cps steps",
                s.method_training)
        s.phase("21 checkpoints, resume, eval and debug_nans",
                s.resume_eval)
        s.phase("22 real image files: the stream, host-fed graphs, train, "
                "eval and serve CLIs, cps", s.real_images)
        s.phase("23 export and BaseNet", s.export_basenet)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(s.report, f, indent=1, default=str)
    if s.failures:
        print(f"chip_smoke: FAILED phases {s.failures}", file=sys.stderr)
        return 1
    kernels = []
    for name, src, replaces in KERNELS:
        k = s.report["kernels"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"uaps_tpu_torch/csrc/{src}.cu", "replaces": replaces,
            "launches": launches_of(s, name),
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        print(f"chip_smoke: kernels never launched on the main path: {idle}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
