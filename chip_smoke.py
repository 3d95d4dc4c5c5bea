#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero without the
final result line:

  1. build   — compile every kernel source (esrganplus_tpu_torch/csrc/*.cu,
               one nvcc per source, in parallel) and print ptxas -v lines;
  2. kernels — each CUDA kernel against its plain PyTorch twin at flagship
               widths (nf=64, gc=32) on an odd shape (B=2, 37×53 LR), the
               main path's shape (B=1, 128×128 LR) and the training path's
               (B=16, 32×32 LR), fp32 (TF32 off) and bf16;
               CUDA-event times of the kernel, the twin and a PyTorch
               yardstick (cuDNN convolutions), and the bound for the work;
               the rows of rdb_ct, conv3x3_ct, upfold_ct (both upconvs, and
               one of WIDE_C = 512 input channels, whose tile is staged in
               slices of 128 channels) and conv_hr_ct name
               their design (bf16 on the tensor cores, "mma": the dense
               stages' dense_mma_kernel; upfold_ct's
               phase fold, upfold_mma_kernel; conv_hr_ct's stage forward,
               then conv_hr_out_mma_kernel; fp32 "fma"), are gated on it and
               hold a second call bit-equal; bf16 rows of the dense wrappers
               and upfold_ct at the main
               path's shape also give the device time (calls queued behind a
               spin kernel) of the wrapper call and the cuDNN call (and of
               upfold_ct's launch), rdb_ct's rows the time of each of its five
               dense-stage launches;
               conv_hr_ct's time each launch and give the share of its
               conv0 activations that differ from the twin's;
  3. main    — flagship ESRGAN+ ×4 (nb=23, nf=64, gc=32) with seeded random
               weights exported to a .pth, through the port's test_image CLI
               on three PNGs in bf16; checks output shapes, the kernels'
               launch counts per image (every upfold_ct and conv_hr_ct call
               through "mma"),
               and the bf16 kernel path against the
               fp32 plain path (and the fp32 kernel path) on the card (every
               rdb_ct and conv3x3_ct call through "mma" too); then
               the small golden ESRGAN+ checkpoint (tests/golden) through the
               kernel path against the reference implementation's output;
     eval    — a Set5-shaped set (five seeded smooth HR PNGs at Set5's HR
               sizes, LR by ``prepare_data modlrbic``) through
               ``esrganplus_tpu_torch.cli.test`` in bf16, one image at a time
               and batched (``"eval_sharded": true``, four images a forward):
               the launch counts of each run from 0, every call through
               "mma"; each sequential PNG bit-equal to SRInferencer's
               upscale; the batched 128² output within the bf16 bar of the
               sequential one; psnr_torch / ssim_torch on the card against
               the host metrics; ``cli.parity_check`` against the sequential
               PNGs; seconds an image of both paths, output MPix/s, and
               rdb_ct at batch 4 against batch 1 on the card alone;
     serve   — ``esrganplus_tpu_torch.cli.serve`` in a thread (bf16, pad
               multiple 32): /healthz, three requests answered bit-equal to
               SRInferencer's upscale, 400 and 404, four concurrent requests
               counted exactly, every rdb_ct call through "mma"; p50 / max
               latency and output MPix/s;
  4. kernels-train-fwd — rdb_ct's training forward (saved l2|l4, the noise
               epilogue) at the training shape: its output and both saved
               buffers against the plain twin's, fp32 and bf16, gated on the
               design;
     kernels-bwd — each backward wrapper (rdb_ct_bwd, conv3x3_ct_bwd,
               upfold_ct_bwd at both stages and at an odd shape,
               conv_hr_ct_bwd) against its plain twin at the training shape
               (batch 16, 32×32 LR), fp32 and bf16, on the kernel's saved
               buffers and again with the twin fed its own forward's
               buffers, with times, bounds and a cuDNN-autograd yardstick;
               the rows of upfold_ct_bwd and conv_hr_ct_bwd name their design
               (bf16 on the tensor cores, "mma"), time each of its launches
               and hold a second call bit-equal; upfold_ct_bwd's db is held
               to 1e-4 of the twin's (the sum of the unrounded dz);
     kernels-dense-accuracy — one line: the share of rdb_ct's bf16 out,
               x1..x4 and l2|l4 that differs from the twin at all, at the
               odd, bench and train shapes with and without the RRDB fold,
               for the tensor-core design (held to 1 %) and, as its
               baseline, for the FMA design on the same inputs (reported);
     kernels-bwd-gate — bf16 conv_hr_ct_bwd on four seeded inputs: its lrelu
               gates whose sign differs from the twin's before and after the
               near-zero fix-up, and every gradient against the twin with
               the fix (held to the bar) and without it;
     kernels-noise — the fused noise mode at the training shape: the device
               Philox draws (csrc/philox.cu) against the twin's, rdb_ct's
               training forward drawing the noise in its epilogue and
               rdb_ct_bwd replaying it against their twins (fp32, bf16, detach
               on and off; two backward calls bit-equal), timed beside the
               input mode (a pre-drawn noise tensor) on the same inputs;
  5. train-check — flagship width and depth, one batch: loss and every
               gradient leaf of the kernel path against autograd of the plain
               graph on the card, fp32 then bf16, the same noise fed to both;
               every dense-stage call by design ("fma" in fp32, "mma" in bf16);
  6. train   — a seeded PNG dataset and an options file under build/smoke/,
               then ``esrganplus_tpu_torch.cli.train`` at the full flagship
               config (batch 16, HR 128, bf16, noise on) for 16 steps with the
               debug cadences; checks the logged losses, the launch counts of
               all eight kernels (rdb_ct, conv3x3_ct, upfold_ct, conv_hr_ct,
               upfold_ct_bwd and conv_hr_ct_bwd through "mma"), the
               exported checkpoint, and a resume from step 8 that must end
               bit-equal to the uninterrupted run;
     train-lmdb — the smoke dataset packed by ``prepare_data lmdb``: the
               first batch of ``data_type: "lmdb"`` bit-equal to the image
               folder's, then 4 flagship steps through the train CLI from the
               LMDB (finite losses, every call of the eight kernels "mma");
  7. train-steady — ``SRTrainer.train_step`` on one device-resident batch:
               median ms/step and crops/s, twice from one seed (bit-equal);
     train-fused — phases 6 and 7 again with ``"noise_kernel": "fused"``
               (every rdb_ct call of a step seeded, resume bit-equal, two
               steady runs bit-equal), then the input mode's steady step once
               more; ms/step and peak memory of both modes;
     kernels-rdb-t — rdb_t (with and without the RRDB fold) and rdb_t_bwd
               against their twins, fp32 and bf16, at the odd, inference and
               training shapes, with times, bounds and a cuDNN yardstick
               (bf16: also the card alone); rdb_t's design and the design of
               rdb_t_bwd's recompute gated, a second call bit-equal;
     kernels-rdb-t-gate — bf16 rdb_t_bwd against its twin on four seeds at
               nf/gc 32/64, 64/64, 64/32 (odd shape) and 32/64 (training
               shape), split into its recompute's flipped lrelu gates and the
               rest, with what each remedy of fault F3 would reach
               (reported, not gated);
     rdb-t-path — three chained ``rdb_t_diff`` (one RRDB) forward and
               backward at the training shape in bf16, launch counts from
               0 (every dense-stage launch, the recompute's too, through
               "mma"), against autograd of the fp32 twins;
  8. kernels-stage — the GAN slice's four stage wrappers (conv_s1_ct,
               conv_s2_ct and their backwards) against their plain twins, fp32
               and bf16, at an odd shape (B=2, 36×52, 3→8 and 16→16 channels,
               act none/relu/lrelu) and at every shape the flagship
               discriminator and VGG19 give them at batch 16, there with times,
               bounds and a cuDNN yardstick; the backward also on the twin's
               own forward output, each half alone and a second call (all
               bit-equal to the full call); every row names the design its
               launch took: bf16 on the tensor cores ("mma": the conv_s2_ct
               adjoint's data gradient is the phase fold,
               stage_dgrad_s2_mma_kernel, its weight gradient
               stage_wgrad_mma_kernel at 16 taps), fp32 on the CUDA cores
               ("fma"); bf16 conv_s2_ct_bwd rows also time the dx-only and
               dW-only halves and cuDNN autograd on the card alone;
  9. gan-check — flagship G, discriminator_vgg_128 and VGG19 (seeded), one
               batch: every loss term and every gradient leaf of G and of D
               through the kernel path against autograd of the plain graph on
               the card, fp32 then bf16, the same noise fed to both; every
               stage and dense wrapper call by design ("mma" in bf16, "fma" in
               fp32);
 10. gan-train — an options file with ``model: "srragan"`` at the recipe's
               shape (batch 16, HR 128, bf16, noise on, perceptual loss on)
               for 16 steps through ``esrganplus_tpu_torch.cli.train``; checks
               the logged terms, the launch counts of all twelve kernels
               (every call of the four stage wrappers, rdb_ct, conv3x3_ct,
               upfold_ct, conv_hr_ct, upfold_ct_bwd and conv_hr_ct_bwd
               through "mma"),
               ``latest_G.pth`` / ``latest_D.pth``, and a resume from step 8
               that must end bit-equal;
 11. gan-steady — ``GANTrainer.train_step`` on one device-resident batch:
               median ms/step and crops/s, twice from one seed (bit-equal);
 12. kernels-workbench — the workbench's conv3x3 and rdb_fused against their
               plain twins, fp32 and bf16: odd cases (conv 5→7 and 8→24 at
               B=2, 16×24; rdb_fused nf=16, gc=8 at B=2, 32×48, the 1×1 on
               and off, fp32 activations with bf16 weights) and flagship
               widths (conv 64→32, 192→64, 64→224; rdb_fused nf=64,
               gc=32) at B=1, 128² and B=16, 32², with times, bounds, a cuDNN
               yardstick, and rdb_ct on the same RDB params timed in turns;
               every row names the design its launch took (bf16 on the
               tensor cores, "mma"; fp32 on the CUDA cores, "fma") and is
               gated on it; bf16 rows hold a second call bit-equal and
               rdb_fused's bf16 rows the kernel at its next tile (8×8 beside
               8×16, 4×8 beside 8×8) bit-equal; flagship bf16 rows also give
               the device time (calls queued behind a spin kernel) of the
               wrapper call, the kernel's launch and the cuDNN call;
     kernels-workbench-wide — bf16 rdb_fused past nf 64, gc 32 (128/64,
               72/40 at 8×8, 256/32 at 4×8; B=1, 32×48): several passes of
               columns and K chunks a tap on the tensor cores, within the
               twin's max-error bar, no further from the fp64-summed
               reference than the twin plus 1 % of outputs (the twin's own
               fp32 sums move 0.2–2.4 % of outputs at 128/64), bit-equal on
               repeat and at every tile that fits;
 13. workbench-path — the flagship trunk's 23 RRDBs (69 rdb_fused calls)
               at B=1, 128², bf16, against the rdb_ct chain on the same
               params, and conv3x3 as the first RDB's by-source stage 1;
               launch counts by design (all 70 through "mma") and the total
               ms of both chains;
 14. srresnet — SRResNet (cuDNN only): the golden ``srresnet_small_x4``
               (tests/golden) on the card in fp32 within 1e-5 of the
               reference's output, and through ``cli.test_image`` (its PNG
               bit-equal to SRInferencer's); a seeded flagship SRResNet (nb
               16, nf 64, ×4) ``.pth`` through ``cli.test_image`` in bf16
               against fp32 at the bf16 bar, then through ``cli.test`` with a
               ``test_SRResNet.json``-shaped options file on the Set5-shaped
               set (each PNG bit-equal to SRInferencer's); no kernel
               launched; ms an image and MPix/s;
     train-srresnet — ``train_SRResNet.json`` as shipped (fp32, batch 16, HR
               96, l2, 4096 resident crops) with ``steps_per_dispatch: 4``
               (bursts of four graph replays) for 16 steps through
               the train CLI (finite logged losses, a ``latest_G.pth`` read
               back as SRResNet, a resume from step 8 bit-equal, no kernel
               launched), then ``train_SRGAN.json`` as
               shipped for 8 steps (finite terms; every call of the four
               stage wrappers through its dtype's design, "fma" in the
               recipe's fp32); the two recipes' steady resident ms/step and
               device ms a step (srresnet-steady, reported);
     train-resident — the flagship PSNR recipe's shape (batch 16, HR 128,
               bf16, noise on) on a store of 4096 crops: one resident step
               (a captured CUDA graph) bit-equal to ``train_step`` on the
               sampled batch, 16 steps through the train CLI with
               ``steps_per_dispatch: 4`` (one capture logged; the eight
               kernels' and the Philox wrappers' counts from 0 those of the
               capture's warm-up and recording, GRAPH_CALLS steps, and of the
               validations, all "mma") and a resume from step 8 bit-equal; a
               burst of 4 resident ``srragan`` steps, its capture's counts
               likewise; resident ms/step and crops/s beside train-steady's
               and gan-steady's (reported);
     train-burst — the PSNR and ``srragan`` steps as captured graphs: a
               burst of 8 replays and 2 more, traced, bit-equal to as many
               eager steps; what the traced replays launch, read from the
               captured graphs, equal by kernel family to what the profiler
               saw the card run in them and in the eager steps; host ms a
               step (CUDA events around bursts of K = 1 and 8), device ms,
               idle share and capture s beside eager resident
               steps (reported); train-burst-equal the same checks for the
               fused noise mode, SRResNet and ``D_update_ratio`` 2;
     train-profile-cli — ``cli.train --profile DIR --profile-steps 4`` on the
               PSNR recipe in bursts of 4, then ``cli.profile_summary DIR
               --steps 4``: the per-step launches of dense_mma_kernel,
               dgrad_mma_kernel and wgrad_mma_kernel in the replays' trace
               equal to the launches counted where each kernel is launched
               (``kernels/launch.py`` ``device_launches``) by the one
               capture, per GRAPH_CALLS; the table's top rows and the device
               ms a step; ``phases.json`` beside the trace and the summary's
               device ms a step by phase (``g.bwd`` among them);
 15. seg     — OutdoorSceneSeg (published widths and depth, seeded) through
               ``cli.test_seg --device cuda`` on two synthetic 384×512 HR
               images: each probability map within 1e-4 of the port's CPU
               forward, summing to 1 within 1e-5, the three output folders
               written; the forward's ms an image (host clock, and the
               card's kernel time by the profiler) and the CLI's s an image;
               no kernel launched;
     sft     — the shipped SFT_Net (nb 16, nf 64, cond_nf 32, ×4; seeded, the
               trunk ×0.1) exported to .pth (read back bit-exact) and run
               through ``cli.test_sftgan --device cuda`` on the seg phase's
               maps: each output within 1e-4 of max|ref| of the port's fp32
               CPU forward, its PNG equal to the card output's; ms an image
               at a 128² LR, fp32 and bf16, host clock and the card's kernel
               time by the profiler, MPix/s out; no kernel launched;
     featex  — MINC and ResNet-101 (seeded, published depth) at 96², batch
               16, on the card within 1e-4 of the CPU; ms of each;
     sftgan-check — one SFT-GAN step's G and D losses and gradients
               (batch 16, HR 96, SFT nb 16, the ACD, VGG19 to features[34])
               through the stage kernels (VGG19's ≤128-channel convs) against
               the plain graph on the card, fp32 then bf16, at gan-check's
               bars; every conv_s1_ct / conv_s1_ct_bwd call through "fma" in
               fp32 and "mma" in bf16, no other wrapper launched; the fp32
               step's launches are what train-sftgan expects a step;
     train-sftgan — ``train_sftgan.json`` as shipped (fp32, batch 16, HR 96,
               ACD, VGG19 seeded) on a synthetic OST tree (``img/`` named by
               category, ``bicseg/`` seg maps, a background folder, a val set
               of two) for 16 steps through the train CLI, host-fed and with
               1024 resident crops (``resident_async_refresh: false``), each
               resumed from step 8 bit-equal: the launches of conv_s1_ct and
               conv_s1_ct_bwd equal to 16 × sftgan-check's host-fed and
               GRAPH_CALLS × its one capture's resident, all "fma"; the
               other group (``other_start_iter`` 20 000) bit-unchanged with
               its Adam state, the sft group moved; then a trainer with
               ``other_start_iter`` 4 moves the other group at step 5 only;
               train-resident-sftgan the train-burst checks and times for its
               step over a seg store, the traced burst across
               ``other_start_iter``; the steady step's host ms and crops/s
               host-fed (the recipe's 8-worker loader through DeviceFeeder),
               on one batch already on the card, and resident
               (train-sftgan-steady);
16. dist-kernels — Philox's batch offset: with b0 = 8 at batch 8 the
               normals (philox_normal_cuda), rdb_ct's fused training forward
               and rdb_ct_bwd's replayed factor and dx equal rows 8–15 of the
               batch-16 launch bit for bit (bf16, 32²); b0 = 0 unchanged;
     dist-nccl-1 — ``cli.train --dist-coordinator localhost:PORT
               --dist-num-processes 1 --dist-process-id 0`` (a world-size-1
               NCCL group) on the PSNR recipe's shape (batch 16, HR 128,
               bf16, 4096 resident crops, ``steps_per_dispatch`` 8) for 16
               steps: logged losses and ``latest_G.pth`` bit-equal to the
               same run without ``--dist-*``, the kernels' counts of its one
               capture and validation; then the step captured under the group
               records its two collectives (the gradients', the logs'; NCCL
               makes an in-place SUM over one rank no node of the graph),
               host and device ms a step in bursts of 8 beside the same step
               captured without a group; then one captured resident step of
               ``srragan`` (bf16, D 128, seeded VGG19) and of SFT-GAN (fp32,
               seg store) under the group, with their batch norms', RaGAN's,
               masked CE's and logs' collectives captured, bit-equal to the
               same step without a group;
     dist-gloo-2 — two processes (``chip_smoke.py --gloo-worker``) share the
               card in a gloo group, eager host-fed fp32 steps at a global
               batch of 16: ``sr`` at full width and ``srragan`` (D 128,
               seeded VGG19); both ranks' logs and states bit-equal, every
               kernel of the step launched on each, the terms within 1e-5 of
               the one-process step on the global batch and every state
               leaf held to it by ``esrganplus_tpu_torch/parallel/held.py``
               (Adam's first step allowed for, a random D's own rounding
               noise — under a 1e-7 perturbation and across cuDNN's and
               PyTorch's own convolutions — up to a cap, the rounding-level
               biases left out and printed); ms a step and the all-reduces'
               share of it
               (profiler);
     tools   — back_projection and reverse_filter (20 iterations, a 128² LR
               and 512² SR pair) on the card within 1e-5 of the CPU, timed;
               net_interp → transfer_params --sft → auto_test on seeded
               SRResNet / SFT_Net checkpoints (the blend and the seeded keys
               exact, cli.test's images written, a missing checkpoint
               skipped);
     with ``--profile`` also a ``torch.profiler`` trace of three steady steps
     of each trainer, the PSNR one in both noise modes, and SFT-GAN's as
     shipped (sftgan-profile; device time by kernel family, the stage
     kernels' sum, csrc/tail_ct.cu's kernels by name, the card's busy share).

Then one ``{"kernels": [...]}`` line (sixteen kernels; the rows of conv_s1_ct and
conv_s1_ct_bwd also give ``sftgan_launches``, their launches in train-sftgan's
host-fed run), the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM: fp32 CUDA cores, bf16 dense
PEAK_BYTES = 3.35e12
NF, GC, OUT_NC = 64, 32, 3
# an upconv input wider than the bf16 block's shared memory holds whole: its
# tile is staged in slices of 128 channels (csrc/phase_fold.cuh fold_kt)
WIDE_C = 512
TRAIN_SHAPE = (16, 32, 32)  # batch, LR height, LR width of the reference recipe
# (B, H, W) of the LR image
SHAPES = {"odd": (2, 37, 53), "bench": (1, 128, 128), "train": TRAIN_SHAPE}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max|Δ| / max(1, max|ref|)
MAX_DIFFER_BF16 = 0.01  # share of bf16 outputs that may differ from the twin at all
REPLACES = {
    "rdb_ct": "esrganplus_tpu/kernels/rdb_ct.py:403",
    "conv3x3_ct": "esrganplus_tpu/kernels/rdb_ct.py:572",
    "upfold_ct": "esrganplus_tpu/kernels/tail_ct.py:297",
    "conv_hr_ct": "esrganplus_tpu/kernels/tail_ct.py:434",
}
# conv_hr_ct in bf16: stage_ct.cu's forward for conv0, tail_ct.cu's conv1
SOURCES = {"rdb_ct": "esrganplus_tpu_torch/csrc/rdb_ct.cu",
           "conv3x3_ct": "esrganplus_tpu_torch/csrc/rdb_ct.cu",
           "upfold_ct": "esrganplus_tpu_torch/csrc/tail_ct.cu",
           "conv_hr_ct": "esrganplus_tpu_torch/csrc/tail_ct.cu + esrganplus_tpu_torch/csrc/stage_ct.cu"}
PER_IMAGE = {"rdb_ct": 69, "conv3x3_ct": 1, "upfold_ct": 2, "conv_hr_ct": 1}
# the training slice: backward wrappers, per optimizer step
BWD_PER_STEP = {"rdb_ct_bwd": 69, "conv3x3_ct_bwd": 1, "upfold_ct_bwd": 2, "conv_hr_ct_bwd": 1}
BWD_REPLACES = {
    "rdb_ct_bwd": "esrganplus_tpu/kernels/rdb_ct.py:927",
    "conv3x3_ct_bwd": "esrganplus_tpu/kernels/rdb_ct.py:669",
    "upfold_ct_bwd": "esrganplus_tpu/kernels/tail_ct.py:749",
    "conv_hr_ct_bwd": "esrganplus_tpu/kernels/tail_ct.py:830",
}
BWD_SOURCE = ("esrganplus_tpu_torch/csrc/dgrad_ct.cu + "
              "esrganplus_tpu_torch/csrc/wgrad_ct.cu")
# the bf16 sources of the tail's backward wrappers (fp32: BWD_SOURCE): the
# upconv adjoint is tail_ct.cu's; conv_hr_ct_bwd runs the stage tensor-core
# kernels around tail_ct.cu's conv_hr_hid_fix_kernel and conv_hr_adj_kernel
BWD_MMA_SOURCE = {"upfold_ct_bwd": "esrganplus_tpu_torch/csrc/tail_ct.cu",
                  "conv_hr_ct_bwd": ("esrganplus_tpu_torch/csrc/tail_ct.cu + "
                                     "esrganplus_tpu_torch/csrc/stage_ct.cu")}
# the tail wrappers (stage_ct.design): bf16 "mma", fp32 "fma"
DESIGNED = ("upfold_ct", "conv_hr_ct", "upfold_ct_bwd", "conv_hr_ct_bwd")
# the dense-stage wrappers (launch.design; csrc/dense_conv.cuh): bf16 "mma",
# fp32 "fma"
DENSE_DESIGNED = ("rdb_ct", "conv3x3_ct")
# their adjoints (csrc/dgrad.cuh, csrc/wgrad.cuh): bf16 "mma", fp32 "fma"
DENSE_BWD_DESIGNED = ("rdb_ct_bwd", "conv3x3_ct_bwd")
# csrc/tail_ct.cu's kernels, by name in a profile (the bf16 step runs all but
# the fp32 upfold_kernel and conv_hr_kernel; the finishing passes are
# wgrad_finish_kernel, shared)
TAIL_KERNELS = ("upfold_kernel", "upfold_mma_kernel", "conv_hr_kernel", "conv_hr_out_mma_kernel",
                "upfold_dz_kernel", "upfold_dgrad_mma_kernel", "upfold_wgrad_mma_kernel",
                "conv_hr_hid_fix_kernel", "conv_hr_adj_kernel")
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # per gradient, of max|ref|
# the upconv adjoint's db against the twin's (the sum of the unrounded dz), of
# max|ref|: fp32 summation order only; a sum of the rounded dz is ~1e-3 off
DB_TOL = 1e-4
# the same, with the twin's backward fed the twin's own forward buffers: where a
# saved activation is within a summation-order difference of 0 its lrelu mask
# flips in one of the two, which moves single elements of dz by 0.8·|cotangent|
BWD_TOL_OWN_BUFFERS = 5e-2
TRAIN_STEPS, VAL_IMAGES = 16, 2

# the GAN slice: the stage convs of the discriminator (D) and the perceptual
# net (F) at the flagship recipe (batch 16, HR 128).
# name: (kernel size, cin, cout, input height = width, fused act, net)
GAN_BATCH = 16
STAGE_SHAPES = {
    "d_3_64_128": (3, 3, 64, 128, None, "D"),
    "f_3_64_128": (3, 3, 64, 128, "relu", "F"),
    "f_64_64_128": (3, 64, 64, 128, "relu", "F"),
    "d_64_128_64": (3, 64, 128, 64, None, "D"),
    "f_64_128_64": (3, 64, 128, 64, "relu", "F"),
    "f_128_128_64": (3, 128, 128, 64, "relu", "F"),
    "d_s2_64_64_128": (4, 64, 64, 128, None, "D"),
    "d_s2_128_128_64": (4, 128, 128, 64, None, "D"),
}
# per GAN step (srragan, perceptual loss on, G updated every step): F(real) and
# F(fake) run 4 convs each; D runs three times (real; fake in the G phase with
# D frozen; fake detached in the D phase), 2 + 2 stage convs each. Backward:
# F(fake) 4, D three times 2 + 2; F(real) is computed without a graph.
GAN_FWD_PER_STEP = {"conv_s1_ct": 14, "conv_s2_ct": 6}
GAN_BWD_PER_STEP = {"conv_s1_ct_bwd": 10, "conv_s2_ct_bwd": 6}
GAN_LOG_KEYS = ("l_g_pix", "l_g_fea", "l_g_gan", "l_d_total", "D_real", "D_fake")
STAGE_ODD = (2, 36, 52)  # B, H, W of the odd-shape check (3→8 and 16→16 channels)
STAGE_REPLACES = {
    "conv_s1_ct": "esrganplus_tpu/kernels/stage_ct.py:239",
    "conv_s1_ct_bwd": "esrganplus_tpu/kernels/stage_ct.py:350",
    "conv_s2_ct": "esrganplus_tpu/kernels/stage_ct.py:484",
    "conv_s2_ct_bwd": "esrganplus_tpu/kernels/stage_ct.py:614",
}
STAGE_SOURCE = "esrganplus_tpu_torch/csrc/stage_ct.cu"
# the shape whose numbers stand in the kernels line (every shape is listed beside it)
STAGE_MAIN_SHAPE = {"conv_s1_ct": "f_64_64_128", "conv_s1_ct_bwd": "f_64_64_128",
                    "conv_s2_ct": "d_s2_64_64_128", "conv_s2_ct_bwd": "d_s2_64_64_128"}

# the nESRGAN+ slice: the fused noise mode of rdb_ct / rdb_ct_bwd, and rdb_t
NOISE_SEED = (0x1234ABCD, 0x0BADF00D)  # one noise site's two Philox seed words
NOISE_SIGMA = 0.1
PHILOX_TOL = 1e-5  # device logf / cosf against torch's log / cos, max|Δ| of a normal
RDB_T_REPLACES = {"rdb_t": "esrganplus_tpu/kernels/rdb_t.py:255",
                  "rdb_t_bwd": "esrganplus_tpu/kernels/rdb_t.py:499"}
RDB_T_SOURCE = "esrganplus_tpu_torch/csrc/rdb_t.cu"
RDB_T_MAIN_SHAPE = "train"  # the shape whose numbers stand in the kernels line
# one RDB's multiply-adds per pixel: five 3×3 stages and the 1×1 shortcut
RDB_MACS = 9 * sum((NF + (k - 1) * GC) * (NF if k == 5 else GC) for k in range(1, 6)) + NF * GC
# rdb_t_bwd's per pixel: a data and a weight gradient of every product (twice
# the forward) and the recompute of stages 1–4 and the 1×1 (stage 5 is linear
# and not recomputed)
RDB_T_BWD_MACS = 2 * RDB_MACS + 9 * sum((NF + (k - 1) * GC) * GC for k in range(1, 5)) + NF * GC


def emit(obj):
    """Print ``obj`` as one JSON line; a phase's row with ``t_s``, the
    script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_summary(log: str) -> list:
    """One line per kernel instantiation from ``nvcc -Xptxas -v`` output:
    template arguments, registers, shared memory and spill bytes."""
    out, name, spill = [], None, "0"
    for line in log.splitlines():
        m = re.search(r"(dense_conv3x3_kernel|dense_mma_kernel|upfold_kernel|conv_hr_kernel|"
                      r"stage_fwd_kernel|stage_dgrad_kernel|stage_wgrad_kernel|"
                      r"stage_fwd_mma_kernel|stage_fwd_s2_mma_kernel|stage_dgrad_mma_kernel|"
                      r"stage_wgrad_mma_kernel|stage_dgrad_s2_mma_kernel|upfold_mma_kernel|"
                      r"conv_hr_hid_fix_kernel|conv_hr_adj_kernel|dgrad_kernel|wgrad_kernel|"
                      r"upfold_dz_kernel|upfold_dgrad_mma_kernel|upfold_wgrad_mma_kernel|"
                      r"conv_hr_out_mma_kernel|dgrad_mma_kernel|wgrad_mma_kernel|"
                      r"wb_conv3x3_kernel|wb_conv3x3_mma_kernel|wb_rdb_fused_kernel|"
                      r"wb_rdb_mma_kernel)"
                      r"I(\w+?)EE", line)
        if m:
            args = (m.group(2).replace("13__nv_bfloat16", "bf16")
                    .replace("NS_10HwioLayout", ",HWIO")
                    .replace("NS_14ByTargetLayout", ",by-target")
                    .replace("Li", ",").replace("E", "").lstrip(","))
            name = f"{m.group(1)}<{args.replace('f,', 'f32,')}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:  # no smem figure: the kernel uses dynamic shared memory only
            smem = f"{m.group(2)} B static smem" if m.group(2) else "dynamic smem"
            out.append(f"{name}: {m.group(1)} regs, {smem}, {spill} B spill")
            name, spill = None, "0"
    return out


def rel_err(got, ref):
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(1.0, ref.float().abs().max().item())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain twins
# ---------------------------------------------------------------------------


def make_cases(dtype, B, H, W, gen):
    """Per kernel: (cuda call, plain call, yardstick call, MACs, bytes) on
    the tensors the main path hands it for a B×H×W LR input; conv_hr_ct's
    inputs ``(x, w0, b0, w1, b1)``, for its bf16 launches one by one; each
    upconv's ``tail_ct.upfold_launch`` (its C entry alone); and a function
    giving rdb_ct's five dense-stage launches on its case
    (``rdb_ct_steps``)."""
    import torch
    import torch.nn.functional as F

    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import tail_ct as T

    dev = "cuda"
    esz = torch.tensor([], dtype=dtype).element_size()

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def conv_w(cin, cout):
        return {"w": rnd(3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5),
                "b": rnd(cout, scale=0.1)}

    act = lambda h, w: torch.rand((B, h, w, NF), generator=gen).to(dev, dtype)
    nchw = lambda t: t.permute(0, 3, 1, 2).contiguous()
    oihw = lambda w: w.to(dtype).permute(3, 2, 0, 1).contiguous()
    lrelu = lambda t: F.leaky_relu(t, 0.2)
    cases = {}

    # rdb_ct: the RRDB's third call (epilogue fold), the main path's heaviest form
    rdb = {f"conv{k}": conv_w(NF + (k - 1) * GC, NF if k == 5 else GC) for k in range(1, 6)}
    rdb["conv1x1"] = {"w": rnd(1, 1, NF, GC, scale=(2.0 / NF) ** 0.5)}
    wr = K.prepare_rdb_ct_weights(rdb, dtype)
    x, res = act(H, W), act(H, W)
    ws = [(oihw(rdb[f"conv{k}"]["w"]), rdb[f"conv{k}"]["b"].to(dtype)) for k in range(1, 6)]
    w11 = oihw(rdb["conv1x1"]["w"])
    xn, resn = nchw(x), nchw(res)

    def rdb_lib():
        c = lambda t, k: F.conv2d(t, ws[k][0], ws[k][1], padding=1)
        x1 = lrelu(c(xn, 0))
        x2 = lrelu(c(torch.cat([xn, x1], 1), 1)) + F.conv2d(xn, w11)
        x3 = lrelu(c(torch.cat([xn, x1, x2], 1), 2))
        x4 = lrelu(c(torch.cat([xn, x1, x2, x3], 1), 3)) + x2
        x5 = c(torch.cat([xn, x1, x2, x3, x4], 1), 4)
        return (x5 * 0.2 + xn) * 0.2 + resn

    mac = 9 * sum((NF + (k - 1) * GC) * (NF if k == 5 else GC) for k in range(1, 6)) + NF * GC
    wbytes = sum(t.numel() * t.element_size() for t in wr.values() if t is not None)
    cases["rdb_ct"] = (lambda: K.rdb_ct(x, wr, res, rrdb_scale=0.2),
                       lambda: K.rdb_ct_plain(x, wr, res, rrdb_scale=0.2),
                       rdb_lib, B * H * W * mac, 3 * B * H * W * NF * esz + wbytes)
    rdb_steps = lambda: K.rdb_ct_steps(x, wr, res, rrdb_scale=0.2)[0]

    # conv3x3_ct: trunk conv + global residual
    tc = conv_w(NF, NF)
    wc, bc = K.prepare_conv_ct_weights(tc["w"], tc["b"], dtype)
    wco, bco = oihw(tc["w"]), tc["b"].to(dtype)
    cases["conv3x3_ct"] = (lambda: K.conv3x3_ct(x, wc, bc, res),
                           lambda: K.conv3x3_ct_plain(x, wc, bc, res),
                           lambda: F.conv2d(xn, wco, bco, padding=1) + resn,
                           B * H * W * 9 * NF * NF,
                           3 * B * H * W * NF * esz + wc.numel() * esz)

    # upfold_ct: the first upconv (LR → 2×LR)
    up = conv_w(NF, NF)
    wf, bf = T.prepare_upfold_ct(up["w"], up["b"], dtype)
    wuo, buo = oihw(up["w"]), up["b"].to(dtype)
    cases["upfold_ct"] = (lambda: T.upfold_ct(x, wf, bf),
                          lambda: T.upfold_ct_plain(x, wf, bf),
                          lambda: lrelu(F.conv2d(F.interpolate(xn, scale_factor=2,
                                                               mode="nearest"),
                                                 wuo, buo, padding=1)),
                          4 * B * H * W * 4 * NF * NF,
                          5 * B * H * W * NF * esz + wf.numel() * esz)

    # the second upconv call (2×LR → 4×LR), timed for the per-image breakdown
    x2 = act(2 * H, 2 * W)
    x2n = nchw(x2)
    cases["upfold_ct_2nd"] = (lambda: T.upfold_ct(x2, wf, bf),
                              lambda: T.upfold_ct_plain(x2, wf, bf),
                              lambda: lrelu(F.conv2d(F.interpolate(x2n, scale_factor=2,
                                                                   mode="nearest"),
                                                     wuo, buo, padding=1)),
                              16 * B * H * W * 4 * NF * NF,
                              20 * B * H * W * NF * esz + wf.numel() * esz)
    # the upconv at WIDE_C input channels (no model path: the sliced tile)
    upw = conv_w(WIDE_C, NF)
    wfw, bfw = T.prepare_upfold_ct(upw["w"], upw["b"], dtype)
    wwo, bwo = oihw(upw["w"]), upw["b"].to(dtype)
    xw = torch.rand((B, H, W, WIDE_C), generator=gen).to(dev, dtype)
    xwn = nchw(xw)
    cases["upfold_ct_wide"] = (lambda: T.upfold_ct(xw, wfw, bfw),
                               lambda: T.upfold_ct_plain(xw, wfw, bfw),
                               lambda: lrelu(F.conv2d(F.interpolate(xwn, scale_factor=2,
                                                                    mode="nearest"),
                                                      wwo, bwo, padding=1)),
                               4 * B * H * W * 4 * WIDE_C * NF,
                               B * H * W * (WIDE_C + 4 * NF) * esz + wfw.numel() * esz)
    up_launch = {"upfold_ct": T.upfold_launch(x, wf, bf),
                 "upfold_ct_2nd": T.upfold_launch(x2, wf, bf),
                 "upfold_ct_wide": T.upfold_launch(xw, wfw, bfw)}

    # conv_hr_ct: hr_conv0 + hr_conv1 on the 4×LR image
    hr0, hr1 = conv_w(NF, NF), conv_w(NF, OUT_NC)
    hw = T.prepare_conv_hr_ct(hr0, hr1, dtype)
    xh = act(4 * H, 4 * W)
    xhn = nchw(xh)
    w0o, b0o, w1o, b1o = oihw(hr0["w"]), hr0["b"].to(dtype), oihw(hr1["w"]), hr1["b"].to(dtype)
    npx = B * 16 * H * W
    cases["conv_hr_ct"] = (lambda: T.conv_hr_ct(xh, *hw),
                           lambda: T.conv_hr_ct_plain(xh, *hw),
                           lambda: F.conv2d(lrelu(F.conv2d(xhn, w0o, b0o, padding=1)),
                                            w1o, b1o, padding=1),
                           npx * 9 * NF * (NF + OUT_NC),
                           npx * (NF + OUT_NC) * esz + (hw[0].numel() + hw[2].numel()) * esz)
    return cases, (xh, *hw), up_launch, rdb_steps


def _hid_share_differing(x, w0, b0):
    """Share of conv_hr_ct's bf16 conv0 activations (the tensor-core stage
    forward, ``stage_fwd_mma_kernel``) that differ from the twin's at all."""
    from esrganplus_tpu_torch.kernels import stage_ct as S
    from esrganplus_tpu_torch.kernels.rdb_ct import _conv, _lrelu

    hid = S.conv_s1_ct(x, w0, b0, act="lrelu").permute(0, 3, 1, 2)
    twin = _lrelu(_conv(x.float().permute(0, 3, 1, 2), w0, b0), 0.2).to(x.dtype)
    return (hid != twin).float().mean().item()


def check_kernels(failures):
    import torch

    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import tail_ct as T
    from esrganplus_tpu_torch.models.layers import fp32_exact

    gen = torch.Generator().manual_seed(0)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for sname, (B, H, W) in SHAPES.items():
            cases, hr_inputs, up_launch, rdb_steps = make_cases(dtype, B, H, W, gen)
            for name, (kern, plain, lib, macs, nbytes) in cases.items():
                with fp32_exact():
                    extra = {}
                    if name in ("upfold_ct", "upfold_ct_2nd", "upfold_ct_wide", "conv_hr_ct",
                                *DENSE_DESIGNED):
                        # bf16 on the tensor cores, fp32 on the FMA kernels
                        fn = (getattr(K, name) if name in DENSE_DESIGNED else
                              T.conv_hr_ct if name == "conv_hr_ct" else T.upfold_ct)
                        got, design = _design_of(fn, kern)
                        extra = {"design": design,
                                 "repeat_bit_equal": torch.equal(kern(), got)}
                        if dname == "bfloat16" and name == "conv_hr_ct":
                            extra["hid_frac_differ"] = _hid_share_differing(*hr_inputs[:3])
                    else:
                        got = kern()
                    torch.cuda.synchronize()
                    ref = plain()
                    d, rel = rel_err(got, ref)
                    # same rounding points: outputs differ at all only where
                    # fp32 summation order flips a bf16 rounding
                    differ = (got != ref).float().mean().item()
                    ok = (bool(torch.isfinite(got.float()).all()) and rel <= TOL[dname]
                          and (dname == "float32" or differ <= MAX_DIFFER_BF16))
                    if extra:
                        ok = (ok and extra["repeat_bit_equal"]
                              and extra["design"] == T.S.design(dtype))
                    # the cuDNN yardstick is an independent check (it rounds
                    # bf16 at other points, so it is reported, not held)
                    _, rel_lib = rel_err(got, lib().permute(0, 2, 3, 1))
                    row = {"phase": "kernels", "kernel": name, "dtype": dname,
                           "shape": sname, "lr": [B, H, W], "max_abs_err": d,
                           "rel_err": rel, "tol": TOL[dname], "frac_differ": differ,
                           "rel_err_vs_library": rel_lib, **extra,
                           "ok": ok}
                    if sname == "bench":
                        bound = max(2 * macs / PEAK_FLOPS[dname], nbytes / PEAK_BYTES) * 1e3
                        row.update(ms=time_ms(kern), plain_ms=time_ms(plain),
                                   library_ms=time_ms(lib), bound_ms=bound,
                                   bound_by="operations"
                                   if 2 * macs / PEAK_FLOPS[dname] >= nbytes / PEAK_BYTES
                                   else "bytes")
                        if name == "conv_hr_ct" and extra["design"] == "mma":
                            # ms of each of its launches
                            row["step_ms"] = {k: time_ms(f) for k, f in
                                              T.conv_hr_mma_steps(*hr_inputs)[0].items()}
                        if name in up_launch and dname == "bfloat16":
                            # the card alone: the wrapper call, its launch, cuDNN
                            _device_times(row, {"kern": kern, "lib": lib,
                                                "launch": up_launch[name][0]})
                        if name in DENSE_DESIGNED and dname == "bfloat16":
                            # the card alone: the wrapper call and cuDNN
                            row.update(device_ms=device_ms(kern), library_device_ms=device_ms(lib))
                            if name == "rdb_ct":  # each of the five dense-stage launches
                                steps = rdb_steps()
                                row["step_ms"] = {k: time_ms(f) for k, f in steps.items()}
                                row["step_device_ms"] = {k: device_ms(f) for k, f in steps.items()}
                        report[(name, dname)] = row
                emit(row)
                if not ok:
                    failures.append(f"{name} {dname} {sname}: rel err {rel:.3g}, differ {differ:.3g}")
    return report


# ---------------------------------------------------------------------------
# phase 3: the main path through the CLI
# ---------------------------------------------------------------------------


INFER_SIZES = {"a_128x128": (128, 128), "b_96x160": (96, 160), "c_97x131": (97, 131)}


def _flagship_checkpoint(workdir):
    """The flagship's seeded weights as a reference ``.pth`` → (params, cfg,
    path). Init scale 0.5 (not the training default 0.1) keeps the output
    O(1), so a bf16-vs-fp32 comparison is not one between near-zero images."""
    import torch

    from esrganplus_tpu_torch.convert import rrdbnet_to_state_dict
    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig, init_rrdbnet

    cfg = RRDBNetConfig()
    params = init_rrdbnet(cfg, seed=0, init_scale=0.5)
    path = os.path.join(workdir, "flagship_seed0.pth")
    torch.save(rrdbnet_to_state_dict(params, cfg), path)
    return params, cfg, path


def _reset_inference_counts():
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import tail_ct as T

    for fn in (K.rdb_ct, K.conv3x3_ct, T.upfold_ct, T.conv_hr_ct):
        fn.launches = 0
    T.reset_design_counts()
    K.reset_design_counts()


def _inference_launches():
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import tail_ct as T

    return {fn.__name__: fn.launches for fn in (K.rdb_ct, K.conv3x3_ct, T.upfold_ct, T.conv_hr_ct)}


def _profiled_device_ms(fn):
    """Device time (ms) of every kernel one ``fn()`` launches, by
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def main_path(failures, workdir):
    import torch

    from esrganplus_tpu_torch.cli import test_image
    from esrganplus_tpu_torch.infer import SRInferencer
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import tail_ct as T
    from esrganplus_tpu_torch.models import generator_forward
    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig, prep_trunk_ct
    from esrganplus_tpu_torch.ops.image_io import read_img, save_img

    params, cfg, ckpt = _flagship_checkpoint(workdir)
    lr_dir, out_dir = os.path.join(workdir, "LR"), os.path.join(workdir, "results")
    rng = np.random.RandomState(0)
    sizes = INFER_SIZES
    for name, (h, w) in sizes.items():
        save_img(_smooth_image(rng, h, w), os.path.join(lr_dir, name + ".png"))

    counted = (K.rdb_ct, K.conv3x3_ct, T.upfold_ct, T.conv_hr_ct)
    _reset_inference_counts()
    K.rdb_ct.device_launches = 0
    t0 = time.perf_counter()
    test_image.main([ckpt, "--input", lr_dir, "--output", out_dir, "--dtype", "bf16",
                     "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _inference_launches()
    n = len(sizes)
    for k, per in PER_IMAGE.items():
        if launches[k] != per * n:
            failures.append(f"main path: {k} launched {launches[k]} times, expected {per * n}")
    by_design = _path_designs(failures, "main", launches)
    emit({"phase": "main", "images": n, "seconds_total": seconds, "launches": launches,
          "by_design": by_design, "rdb_ct_device_launches": K.rdb_ct.device_launches})

    # outputs: shapes of the written PNGs; the raw (unclipped) bf16 kernel-path
    # output against the fp32 plain graph, relative to the output's magnitude
    bf16 = SRInferencer(params, cfg, dtype=torch.bfloat16)
    plain32 = SRInferencer(params, RRDBNetConfig(trunk_kernel="plain", tail_kernel="plain"))
    kern32 = SRInferencer(params, cfg)
    for name, (h, w) in sizes.items():
        png = read_img(os.path.join(out_dir, name + "_rlt.png"))
        if png.shape != (4 * h, 4 * w, 3):
            failures.append(f"main path: {name} output {png.shape}, expected {(4 * h, 4 * w, 3)}")
        img = read_img(os.path.join(lr_dir, name + ".png"))[:, :, ::-1].copy()
        x = torch.from_numpy(img[None]).cuda()
        with torch.inference_mode():
            y32 = generator_forward(plain32.params, x, plain32.cfg)
            y16 = generator_forward(bf16.params, x, cfg, dtype=torch.bfloat16)
            # context: the cuDNN bf16 graph's own distance from fp32
            y16p = generator_forward(plain32.params, x, plain32.cfg, dtype=torch.bfloat16)
        scale = y32.abs().max().item()
        r16 = (y16 - y32).abs().max().item() / scale
        row = {"phase": "main-check", "image": name, "max_abs_out": scale,
               "bf16_kernel_vs_fp32_plain_rel": r16, "tol_bf16": 0.05,
               "bf16_plain_vs_fp32_plain_rel": (y16p - y32).abs().max().item() / scale,
               "finite": bool(torch.isfinite(y16).all())}
        ok = row["finite"] and r16 <= 0.05
        if name == "c_97x131":
            with torch.inference_mode():
                y32k = generator_forward(kern32.params, x, cfg)
            r32 = (y32k - y32).abs().max().item() / scale
            row.update(fp32_kernel_vs_fp32_plain_rel=r32, tol_fp32=1e-4)
            ok = ok and r32 <= 1e-4
        row["ok"] = ok
        emit(row)
        if not ok:
            failures.append(f"main path: {name} output check failed: {row}")

    # the reference torch implementation's own output for a small ESRGAN+ ×4
    # checkpoint (tests/golden), through the kernel path on the card
    from esrganplus_tpu_torch.infer import load_generator

    gp, gcfg, _ = load_generator(os.path.join(HERE, "tests", "golden", "rrdb_small_x4.pth"))
    io = np.load(os.path.join(HERE, "tests", "golden", "rrdb_small_x4_io.npz"))
    gx = torch.from_numpy(io["x"].transpose(0, 2, 3, 1).copy()).cuda()
    gy = torch.from_numpy(io["y"].transpose(0, 2, 3, 1).copy()).cuda()
    for fn in counted:
        fn.launches = 0
    with torch.inference_mode():
        g32 = generator_forward(prep_trunk_ct(gp, gcfg, torch.float32), gx, gcfg)
        g16 = generator_forward(prep_trunk_ct(gp, gcfg, torch.bfloat16), gx, gcfg,
                                dtype=torch.bfloat16)
    # fp32 at the JAX suite's golden bar (1e-5 abs); bf16 relative to max|y|
    # (this net's outputs are below 0.1, where the 0.05 abs bf16 bar says little)
    row = {"phase": "golden", "checkpoint": "tests/golden/rrdb_small_x4.pth",
           "max_abs_out": gy.abs().max().item(),
           "fp32_kernel_max_abs_err": (g32 - gy).abs().max().item(), "tol_fp32": 1e-5,
           "bf16_kernel_rel_err": ((g16 - gy).abs().max() / gy.abs().max()).item(),
           "tol_bf16": 0.05, "launches": {fn.__name__: fn.launches for fn in counted}}
    row["ok"] = (row["fp32_kernel_max_abs_err"] <= 1e-5
                 and row["bf16_kernel_rel_err"] <= 0.05 and K.rdb_ct.launches > 0)
    emit(row)
    if not row["ok"]:
        failures.append(f"golden checkpoint on the card: {row}")

    # steady-state one-image latency of the bf16 kernel path at 128×128 LR
    img = read_img(os.path.join(lr_dir, "a_128x128.png"))[:, :, ::-1].copy()
    bf16.upscale(img)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        bf16.upscale(img)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    emit({"phase": "main-steady", "lr": [128, 128], "dtype": "bf16", "seconds": times,
          "median_s": med, "mpix_per_s_out": 512 * 512 / 1e6 / med})
    return launches


# ---------------------------------------------------------------------------
# the evaluation, serving and training-data slice: cli/test.py (one image at a
# time and batched), cli/parity_check.py, cli/serve.py, data_type "lmdb"
# ---------------------------------------------------------------------------

# Set5's HR sizes (height, width); the LR by prepare_data modlrbic ×1/4
SET5_HR = {"baby": (512, 512), "bird": (288, 288), "butterfly": (256, 256),
           "head": (280, 280), "woman": (344, 228)}
EVAL_BATCH = 4  # images a forward on the batched path (BatchedEvaluator's default)
METRIC_TOL = {"psnr_db": 1e-3, "ssim": 1e-4}  # device float32 against the host's float64
SERVE_REPEATS = 10  # sequential 128² requests behind the latency numbers
LMDB_STEPS = 4


def _set5_set(workdir, rng):
    """Five smooth HR PNGs from ``rng`` at Set5's HR sizes and their LR by
    ``prepare_data modlrbic`` → (HR dir, LR dir)."""
    from esrganplus_tpu_torch.cli import prepare_data
    from esrganplus_tpu_torch.ops.image_io import save_img

    src = os.path.join(workdir, "set5_src")
    for name, (h, w) in SET5_HR.items():
        save_img(_smooth_image(rng, h, w), os.path.join(src, name + ".png"))
    prepare_data.main(["modlrbic", src, os.path.join(workdir, "set5"), "--scale", "4"])
    return tuple(os.path.join(workdir, "set5", f"{k}_x4") for k in ("HR", "LR"))


def eval_path(failures, workdir):
    """Phase eval: a Set5-shaped set (five seeded smooth HR PNGs at Set5's
    HR sizes, LR by ``prepare_data modlrbic``) through ``cli.test`` in bf16
    on the card, one image at a time and then batched (``"eval_sharded":
    true``: EVAL_BATCH images a forward), then ``parity_check`` against the
    first run's PNGs. Gated: the launch counts of each run from 0, every
    call on "mma"; each sequential PNG bit-equal to SRInferencer's upscale
    through tensor2img; the batched 128² output (no padding) within the bf16
    bar of the sequential one; psnr_torch / ssim_torch on the card within
    METRIC_TOL of the host metrics; parity_check exits 0. Reported: PSNR_Y of
    the other batched outputs against the sequential ones (the pad edge),
    seconds an image of both paths (the CLI on the host clock, the forwards
    on the host clock and by the profiler's device time), output MPix/s,
    and rdb_ct at batch 4 against batch 1 on the card alone."""
    import contextlib
    import io

    import cv2
    import torch

    from esrganplus_tpu_torch.cli import parity_check
    from esrganplus_tpu_torch.cli import test as test_cli
    from esrganplus_tpu_torch.infer import BatchedEvaluator, SRInferencer
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.ops.color import bgr2ycbcr
    from esrganplus_tpu_torch.ops.image_io import img2tensor, read_img, tensor2img
    from esrganplus_tpu_torch.ops.metrics import (calculate_psnr, calculate_ssim, psnr_torch,
                                                  ssim_torch)

    params, cfg, ckpt = _flagship_checkpoint(workdir)
    rng = np.random.RandomState(5)
    hr_dir, lr_dir = _set5_set(workdir, rng)
    n = len(SET5_HR)

    def run(tag, **extra):
        opt = {"name": f"eval_{tag}", "model": "sr", "scale": 4, "compute_dtype": "bfloat16",
               "datasets": {"test_1": {"name": "set5", "mode": "LRHR", "dataroot_HR": hr_dir,
                                       "dataroot_LR": lr_dir}},
               "path": {"root": workdir, "pretrain_model_G": ckpt},
               "network_G": {"which_model_G": "RRDB_net", "norm_type": None, "mode": "CNA",
                             "nf": NF, "nb": 23, "in_nc": 3, "out_nc": OUT_NC, "gc": GC,
                             "gaussian_noise": True}, **extra}
        path = os.path.join(workdir, f"eval_{tag}.json")
        with open(path, "w") as f:
            json.dump(opt, f)
        _reset_inference_counts()
        t0 = time.perf_counter()
        test_cli.main(["-opt", path, "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _inference_launches()
        return (os.path.join(workdir, "results", f"eval_{tag}", "set5"), seconds, launches,
                _path_designs(failures, f"eval {tag}", launches))

    forwards = {"sequential": n, "batched": -(-n // EVAL_BATCH)}
    runs = {"sequential": run("sequential"), "batched": run("batched", eval_sharded=True)}
    for tag, (_, _, launches, _) in runs.items():
        for k, per in PER_IMAGE.items():
            if launches[k] != per * forwards[tag]:
                failures.append(f"eval {tag}: {k} launched {launches[k]} times, expected "
                                f"{per * forwards[tag]}")
    out = {tag: {name: cv2.imread(os.path.join(r[0], name + ".png"), cv2.IMREAD_UNCHANGED)
                 for name in SET5_HR} for tag, r in runs.items()}

    inf = SRInferencer(params, cfg, dtype=torch.bfloat16)
    lrs = {name: img2tensor(read_img(os.path.join(lr_dir, name + ".png"))) for name in SET5_HR}
    bit_equal = {name: bool(np.array_equal(out["sequential"][name],
                                           tensor2img(inf.upscale(lrs[name]))))
                 for name in SET5_HR}
    seq128, bat128 = (out[t]["baby"].astype(np.float64) / 255 for t in ("sequential", "batched"))
    batched_128_err = float(np.abs(bat128 - seq128).max())
    y = lambda img: bgr2ycbcr(img.astype(np.float32) / 255.0, only_y=True)[4:-4, 4:-4] * 255
    pad_edge_psnr_y = {name: calculate_psnr(y(out["batched"][name]), y(out["sequential"][name]))
                       for name in SET5_HR if name != "baby"}
    metrics = {}
    for name in SET5_HR:  # cli.test's protocol: [0, 255], crop = scale
        sr = out["sequential"][name][4:-4, 4:-4].astype(np.float64)
        gt = cv2.imread(os.path.join(hr_dir, name + ".png"), cv2.IMREAD_UNCHANGED)[4:-4, 4:-4]
        gt = gt.astype(np.float64)
        ts, tg = (torch.from_numpy(a).float().cuda() for a in (sr, gt))
        metrics[name] = {"psnr_host": calculate_psnr(sr, gt), "psnr_device": psnr_torch(ts, tg).item(),
                         "ssim_host": calculate_ssim(sr, gt), "ssim_device": ssim_torch(ts, tg).item()}
    metric_err = {"psnr_db": max(abs(m["psnr_device"] - m["psnr_host"]) for m in metrics.values()),
                  "ssim": max(abs(m["ssim_device"] - m["ssim_host"]) for m in metrics.values())}

    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        parity_rc = parity_check.main([ckpt, "--lr", lr_dir, "--hr", hr_dir, "--ref-results",
                                       runs["sequential"][0], "--ref-suffix", "",
                                       "--out", os.path.join(workdir, "parity"),
                                       "--device", "cuda"])
    parity_said = [l for l in said.getvalue().splitlines() if "delta" in l or "PARITY" in l]

    # the forwards alone: each path over the set, then over four 128² images
    bat = BatchedEvaluator(params, cfg, dtype=torch.bfloat16, batch=EVAL_BATCH)
    imgs = list(lrs.values())
    equal = [img2tensor(_smooth_image(rng, 128, 128).astype(np.float32) / 255.0)
             for _ in range(EVAL_BATCH)]
    paths = {"sequential": lambda s: [inf.upscale(i) for i in s], "batched": bat.upscale_batch}
    timing = {}
    for tag, fn in paths.items():
        for set_name, images in (("set5", imgs), ("equal_128", equal)):
            fn(images)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                res = fn(images)
                times.append(time.perf_counter() - t0)
            host = float(np.median(times))
            mpix = sum(r.shape[0] * r.shape[1] for r in res) / 1e6
            timing[f"{tag}_{set_name}"] = {
                "host_s_per_image": host / len(images),
                "device_s_per_image": _profiled_device_ms(lambda: fn(images)) / 1e3 / len(images),
                "mpix_per_s_out": mpix / host}
    gen = torch.Generator().manual_seed(4)
    w = K.prepare_rdb_ct_weights(_rdb_params(gen, NF, GC), torch.bfloat16)
    rdb_ms = {b: device_ms(lambda x=torch.randn((b, 128, 128, NF), generator=gen).to(
        "cuda", torch.bfloat16): K.rdb_ct(x, w)) for b in (1, EVAL_BATCH)}
    row = {"phase": "eval", "images": n, "hr": SET5_HR, "dtype": "bfloat16",
           # the batched path pads every LR to the set's largest (128², a multiple of 8)
           "lr_pixels": {"sequential": int(sum(i.shape[0] * i.shape[1] for i in imgs)),
                         "batched": n * 128 * 128},
           "cli_seconds": {t: r[1] for t, r in runs.items()},
           "cli_s_per_image": {t: r[1] / n for t, r in runs.items()},
           "launches": {t: r[2] for t, r in runs.items()},
           "by_design": {t: r[3] for t, r in runs.items()},
           "sequential_bit_equal_to_upscale": bit_equal,
           "batched_128_max_abs_err": batched_128_err, "tol_bf16": TOL["bfloat16"],
           "batched_128_bit_equal": bool(np.array_equal(out["batched"]["baby"],
                                                        out["sequential"]["baby"])),
           "batched_vs_sequential_psnr_y_db": pad_edge_psnr_y,
           "metrics": metrics, "metric_err": metric_err, "metric_tol": METRIC_TOL,
           "parity_rc": parity_rc, "parity": parity_said, "forwards": timing,
           "rdb_ct_device_ms_128": {f"b{b}": t for b, t in rdb_ms.items()},
           "rdb_ct_b4_over_b1": (rdb_ms[EVAL_BATCH] / rdb_ms[1]
                                 if rdb_ms[1] and rdb_ms[EVAL_BATCH] else None)}
    row["ok"] = bool(all(bit_equal.values()) and batched_128_err <= TOL["bfloat16"]
                     and all(metric_err[k] <= METRIC_TOL[k] for k in METRIC_TOL)
                     and parity_rc == 0 and all(np.isfinite(list(pad_edge_psnr_y.values()))))
    emit(row)
    if not row["ok"]:
        failures.append(f"eval: {row}")


def serve_path(failures, workdir):
    """Phase serve: ``cli.serve.make_server`` on 127.0.0.1 (port 0) in a
    thread, bf16, pad multiple 32, the flagship's seeded weights. Gated:
    /healthz 200 after the warm-up; three POST /upscale (128², 96×160,
    97×131) answered with PNGs bit-equal to SRInferencer(pad_multiple=32)'s
    upscale through tensor2img; a bad payload 400, an unknown path 404; four
    concurrent requests counted exactly in /stats; every rdb_ct call of the
    requests from 0 on "mma". Reported: the latency of SERVE_REPEATS
    sequential 128² requests (p50, max) and output MPix/s, host clock."""
    import argparse
    import http.client
    import threading

    import cv2
    import torch

    from esrganplus_tpu_torch.cli.serve import make_server
    from esrganplus_tpu_torch.infer import SRInferencer
    from esrganplus_tpu_torch.ops.image_io import decode_img, encode_png, img2tensor, tensor2img

    params, cfg, ckpt = _flagship_checkpoint(workdir)
    args = argparse.Namespace(model=ckpt, host="127.0.0.1", port=0, dtype="bf16",
                              pad_multiple=32, tile=0, x8=False, noise_seed=None, device="cuda")
    srv, _ = make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    addr = srv.server_address

    def call(method, path, body=None):
        c = http.client.HTTPConnection(*addr, timeout=120)
        c.request(method, path, body=body)
        r = c.getresponse()
        data = r.read()
        c.close()
        return r.status, data

    try:
        health = call("GET", "/healthz")[0]
        rng = np.random.RandomState(6)
        imgs = {name: _smooth_image(rng, h, w) for name, (h, w) in INFER_SIZES.items()}
        ref = SRInferencer(params, cfg, dtype=torch.bfloat16, pad_multiple=32)
        _reset_inference_counts()
        answers = {name: call("POST", "/upscale", encode_png(img)) for name, img in imgs.items()}
        launches = _inference_launches()
        by_design = _path_designs(failures, "serve", launches)
        bit_equal = {}
        for name, (status, body) in answers.items():
            want = tensor2img(ref.upscale(img2tensor(imgs[name].astype(np.float32) / 255.0)))
            bit_equal[name] = bool(status == 200 and np.array_equal(
                cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_UNCHANGED), want))
        bad, unknown = call("POST", "/upscale", b"not an image")[0], call("GET", "/nope")[0]
        before = json.loads(call("GET", "/stats")[1])["requests"]
        png = encode_png(imgs["b_96x160"])
        statuses = []
        threads = [threading.Thread(target=lambda: statuses.append(
            call("POST", "/upscale", png)[0])) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        counted = json.loads(call("GET", "/stats")[1])["requests"] - before
        png = encode_png(imgs["a_128x128"])
        lat = []
        for _ in range(SERVE_REPEATS):
            t0 = time.perf_counter()
            status, body = call("POST", "/upscale", png)
            lat.append(time.perf_counter() - t0)
        out_shape = decode_img(body).shape
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    p50 = float(np.median(lat))
    row = {"phase": "serve", "dtype": "bfloat16", "pad_multiple": 32, "healthz": health,
           "launches": launches, "by_design": by_design, "bit_equal_to_upscale": bit_equal,
           "bad_payload": bad, "unknown_path": unknown, "concurrent": statuses,
           "concurrent_counted": counted, "latency_s": lat, "p50_s": p50,
           "max_s": float(max(lat)), "mpix_per_s_out": out_shape[0] * out_shape[1] / 1e6 / p50,
           "last_shape": list(out_shape)}
    row["ok"] = bool(health == 200 and all(bit_equal.values()) and bad == 400
                     and unknown == 404 and statuses == [200] * 4 and counted == 4
                     and status == 200 and out_shape == (512, 512, 3)
                     and launches["rdb_ct"] == 69 * len(INFER_SIZES))
    emit(row)
    if not row["ok"]:
        failures.append(f"serve: {row}")


def train_lmdb_path(failures, workdir):
    """Phase train-lmdb: the train phase's smoke dataset packed by
    ``prepare_data lmdb``; the first batch of the LMDB loader bit-equal to
    the image folder's at one seed; then LMDB_STEPS flagship steps (batch
    16, HR 128, bf16) through ``cli.train`` from the LMDB: finite losses,
    every rdb_ct / rdb_ct_bwd call (and the other six kernels') from 0 on
    "mma"."""
    import torch

    from esrganplus_tpu_torch.cli import prepare_data
    from esrganplus_tpu_torch.cli import train as train_cli
    from esrganplus_tpu_torch.data import TrainLoader, create_dataset
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import tail_ct as T

    dirs = _smoke_dataset(workdir)
    for k in ("HR", "LR"):
        prepare_data.main(["lmdb", dirs[k], os.path.join(workdir, f"{k}.lmdb")])
    opt = _smoke_options(workdir, dirs, "debug_smoke_lmdb", "sr",
                         {"lr_G": 2e-4, "pixel_weight": 1.0})
    opt["train"]["niter"] = LMDB_STEPS
    ds_img = dict(opt["datasets"]["train"], phase="train", scale=4)
    opt["datasets"]["train"].update(dataroot_HR=os.path.join(workdir, "HR.lmdb"),
                                    dataroot_LR=os.path.join(workdir, "LR.lmdb"),
                                    data_type="lmdb")
    ds_db = dict(opt["datasets"]["train"], phase="train", scale=4)
    first = []
    for ds_opt in (ds_img, ds_db):
        loader = TrainLoader(create_dataset(ds_opt), batch_size=TRAIN_SHAPE[0], num_workers=1,
                             seed=0)
        first.append(next(iter(loader)))
        loader.stop()
    batch_equal = all(np.array_equal(first[0][k], first[1][k]) for k in ("LR", "HR"))
    opt_path = os.path.join(workdir, "train_lmdb.json")
    with open(opt_path, "w") as f:
        json.dump(opt, f, indent=1)
    fwd = (K.rdb_ct, K.conv3x3_ct, T.upfold_ct, T.conv_hr_ct)
    bwd = (K.rdb_ct_bwd, K.conv3x3_ct_bwd, T.upfold_ct_bwd, T.conv_hr_ct_bwd)
    for fn in fwd + bwd:
        fn.launches = 0
    T.reset_design_counts()
    K.reset_design_counts()
    t0 = time.perf_counter()
    train_cli.main(["-opt", opt_path, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fwd + bwd}
    want = {**{k: per * LMDB_STEPS for k, per in PER_IMAGE.items()},
            **{k: per * LMDB_STEPS for k, per in BWD_PER_STEP.items()}}
    by_design = _path_designs(failures, "train-lmdb", launches)
    losses, _ = _logged_losses(os.path.join(workdir, "experiments", "debug_smoke_lmdb"))
    finite = bool(losses) and all(np.isfinite(float(v)) for v in losses.values())
    row = {"phase": "train-lmdb", "steps": LMDB_STEPS, "first_batch_equal": batch_equal,
           "batch_shapes": {k: list(first[1][k].shape) for k in ("LR", "HR")},
           "seconds_total": seconds, "launches": launches, "by_design": by_design,
           "l_pix": losses, "finite": finite}
    row["ok"] = bool(batch_equal and finite and launches == want
                     and sorted(losses) == list(range(2, LMDB_STEPS + 1, 2)))
    emit(row)
    if not row["ok"]:
        failures.append(f"train-lmdb: {row}")


# ---------------------------------------------------------------------------
# phase 4: backward kernels against their plain twins (training shape)
# ---------------------------------------------------------------------------


def make_bwd_cases(dtype, gen):
    """Per backward wrapper: (cuda call, plain call, yardstick call, forward
    MACs, bytes, plain call on the twin's own forward buffers or None) on the
    tensors a training step hands it. The yardstick is ``torch.autograd.grad``
    through a cuDNN ``F.conv2d`` graph built once (the port never calls it).
    Also returns rdb_ct's training forward from the kernel and from the twin,
    ``{"out" | "cat" | "lsv": (kernel's, twin's)}``, per case of a
    two-design wrapper a function giving its bf16 launches on the case
    (``rdb_ct_bwd_mma_steps``, ``conv3x3_ct_bwd_mma_steps``,
    ``upfold_bwd_mma_steps``, ``conv_hr_bwd_mma_steps``), and the design
    the training forward's launches took."""
    import torch
    import torch.nn.functional as F

    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import tail_ct as T
    from esrganplus_tpu_torch.models.layers import fp32_exact

    dev = "cuda"
    B, H, W = TRAIN_SHAPE
    esz = torch.tensor([], dtype=dtype).element_size()

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def conv_w(cin, cout):
        return {"w": rnd(3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5),
                "b": rnd(cout, scale=0.1)}

    act = lambda h, w, c=NF: torch.randn((B, h, w, c), generator=gen).to(dev, dtype)
    nchw = lambda t: t.permute(0, 3, 1, 2).contiguous()
    oihw = lambda w: w.to(dtype).permute(3, 2, 0, 1).contiguous().requires_grad_()
    lrelu = lambda t: F.leaky_relu(t, 0.2)
    fbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts if t is not None)
    cases = {}

    def lib_grad(build_out, inputs, g):
        out = build_out()
        gn = nchw(g)
        return lambda: torch.autograd.grad(out, inputs, gn, retain_graph=True)

    # rdb_ct_bwd: noise on, scale not detached (the flagship recipe)
    rdb = {f"conv{k}": conv_w(NF + (k - 1) * GC, NF if k == 5 else GC) for k in range(1, 6)}
    rdb["conv1x1"] = {"w": rnd(1, 1, NF, GC, scale=(2.0 / NF) ** 0.5)}
    wr = K.prepare_rdb_ct_weights(rdb, dtype)
    x, noise, g = act(H, W), act(H, W), act(H, W)
    with fp32_exact():
        fwd_k, fwd_design = _design_of(
            K.rdb_ct, lambda: K._rdb_ct_cuda(x, wr, None, noise, sigma=0.1, save=True))
        fwd_p = K._rdb_ct_train_plain(x, wr, None, noise, sigma=0.1)
    (_, cat, lsv), (_, cat_p, lsv_p) = fwd_k, fwd_p
    train_fwd = dict(zip(("out", "cat", "lsv"), zip(fwd_k, fwd_p)))
    xn = nchw(x).requires_grad_()
    ws = [(oihw(rdb[f"conv{k}"]["w"]), rdb[f"conv{k}"]["b"].to(dtype).requires_grad_())
          for k in range(1, 6)]
    w11 = oihw(rdb["conv1x1"]["w"])

    def rdb_lib():
        c = lambda t, k: F.conv2d(t, ws[k][0], ws[k][1], padding=1)
        x1 = lrelu(c(xn, 0))
        x2 = lrelu(c(torch.cat([xn, x1], 1), 1)) + F.conv2d(xn, w11)
        x3 = lrelu(c(torch.cat([xn, x1, x2], 1), 2))
        x4 = lrelu(c(torch.cat([xn, x1, x2, x3], 1), 3)) + x2
        out = c(torch.cat([xn, x1, x2, x3, x4], 1), 4) * 0.2 + xn
        return out * (1 + 0.1 * nchw(noise))

    mac = 9 * sum((NF + (k - 1) * GC) * (NF if k == 5 else GC) for k in range(1, 6)) + NF * GC
    wcount = sum(t.numel() for k, t in wr.items() if t is not None and k.startswith("w"))
    args = (x, wr, cat, lsv, g, noise)
    args_p = (x, wr, cat_p, lsv_p, g, noise)
    steps = {"rdb_ct_bwd": lambda: K.rdb_ct_bwd_mma_steps(*args, sigma=0.1)[0]}
    cases["rdb_ct_bwd"] = (
        lambda: K.rdb_ct_bwd(*args, sigma=0.1), lambda: K.rdb_ct_bwd_plain(*args, sigma=0.1),
        lib_grad(rdb_lib, [xn, w11] + [t for pair in ws for t in pair], g),
        B * H * W * mac,
        fbytes(x, cat, lsv, g, noise, x) + wcount * (esz + 4),  # + dx; weights in, dW fp32 out
        lambda: K.rdb_ct_bwd_plain(*args_p, sigma=0.1))

    # conv3x3_ct_bwd
    tc = conv_w(NF, NF)
    wc, _ = K.prepare_conv_ct_weights(tc["w"], tc["b"], dtype)
    wco, bco = oihw(tc["w"]), tc["b"].to(dtype).requires_grad_()
    cases["conv3x3_ct_bwd"] = (
        lambda: K.conv3x3_ct_bwd(x, wc, g), lambda: K.conv3x3_ct_bwd_plain(x, wc, g),
        lib_grad(lambda: F.conv2d(xn, wco, bco, padding=1), [xn, wco, bco], g),
        B * H * W * 9 * NF * NF, fbytes(x, g, x) + wc.numel() * (esz + 4), None)
    steps["conv3x3_ct_bwd"] = lambda: K.conv3x3_ct_bwd_mma_steps(x, wc, g)[0]

    # upfold_ct_bwd: both stages of the ×4 tail, and an odd shape
    up = conv_w(NF, NF)
    wf, bf = T.prepare_upfold_ct(up["w"], up["b"], dtype)
    wuo, buo = oihw(up["w"]), up["b"].to(dtype).requires_grad_()
    for tag, (b, h, w) in (("upfold_ct_bwd", (B, H, W)), ("upfold_ct_bwd_2nd", (B, 2 * H, 2 * W)),
                           ("upfold_ct_bwd_odd", (2, 37, 53))):
        xs = torch.randn((b, h, w, NF), generator=gen).to(dev, dtype)
        with fp32_exact():
            out, out_p = T.upfold_ct(xs, wf, bf), T.upfold_ct_plain(xs, wf, bf)
        gs = torch.randn((b, 2 * h, 2 * w, NF), generator=gen).to(dev, dtype)
        xsn = nchw(xs).requires_grad_()
        cases[tag] = (
            lambda xs=xs, out=out, gs=gs: T.upfold_ct_bwd(xs, wf, out, gs),
            lambda xs=xs, out=out, gs=gs: T.upfold_ct_bwd_plain(xs, wf, out, gs),
            lib_grad(lambda xsn=xsn: lrelu(F.conv2d(
                F.interpolate(xsn, scale_factor=2, mode="nearest"), wuo, buo, padding=1)),
                [xsn, wuo, buo], gs),
            4 * b * h * w * 4 * NF * NF,
            fbytes(xs, out, gs, xs) + wf.numel() * (esz + 4),
            lambda xs=xs, out_p=out_p, gs=gs: T.upfold_ct_bwd_plain(xs, wf, out_p, gs))
        steps[tag] = lambda xs=xs, out=out, gs=gs: T.upfold_bwd_mma_steps(xs, wf, out, gs)[0]

    # conv_hr_ct_bwd on the 4×LR image
    hr0, hr1 = conv_w(NF, NF), conv_w(NF, OUT_NC)
    w0, b0, w1, _ = T.prepare_conv_hr_ct(hr0, hr1, dtype)
    xh, gh = act(4 * H, 4 * W), act(4 * H, 4 * W, OUT_NC)
    xhn = nchw(xh).requires_grad_()
    w0o, b0o = oihw(hr0["w"]), hr0["b"].to(dtype).requires_grad_()
    w1o, b1o = oihw(hr1["w"]), hr1["b"].to(dtype).requires_grad_()
    cases["conv_hr_ct_bwd"] = (
        lambda: T.conv_hr_ct_bwd(xh, w0, b0, w1, gh),
        lambda: T.conv_hr_ct_bwd_plain(xh, w0, b0, w1, gh),
        lib_grad(lambda: F.conv2d(lrelu(F.conv2d(xhn, w0o, b0o, padding=1)), w1o, b1o,
                                  padding=1), [xhn, w0o, b0o, w1o, b1o], gh),
        B * 16 * H * W * 9 * NF * (NF + OUT_NC),
        fbytes(xh, gh, xh) + (w0.numel() + w1.numel()) * (esz + 4), None)
    steps["conv_hr_ct_bwd"] = lambda: T.conv_hr_bwd_mma_steps(xh, w0, b0, w1, gh)[0]
    return cases, train_fwd, steps, fwd_design


def worst_err(got: dict, ref: dict):
    """Over the gradients of a backward's result dict: (largest max|Δ| /
    max|ref|, largest max|Δ|, all finite)."""
    import torch

    worst, worst_abs, finite = 0.0, 0.0, True
    for k, r in ref.items():
        if r is None:
            continue
        a, r = got[k].float(), r.float()
        finite = finite and bool(torch.isfinite(a).all())
        d = (a - r).abs().max().item()
        worst_abs = max(worst_abs, d)
        worst = max(worst, d / max(r.abs().max().item(), 1e-30))
    return worst, worst_abs, finite


def check_bwd_kernels(failures):
    import torch

    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import tail_ct as T
    from esrganplus_tpu_torch.models.layers import fp32_exact

    gen = torch.Generator().manual_seed(1)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        cases, train_fwd, mma_steps, fwd_design = make_bwd_cases(dtype, gen)
        # rdb_ct's training forward: what the backward's masks and products read
        row = {"phase": "kernels-train-fwd", "kernel": "rdb_ct", "dtype": dname,
               "lr": list(TRAIN_SHAPE), "noise_sigma": 0.1, "tol": TOL[dname],
               "design": fwd_design, "ok": fwd_design == T.S.design(dtype)}
        for key, (got, ref) in train_fwd.items():
            d, rel = rel_err(got, ref)
            differ = (got != ref).float().mean().item()
            mask_differ = ((got >= 0) != (ref >= 0)).float().mean().item()
            row[key] = {"max_abs_err": d, "rel_err": rel, "frac_differ": differ,
                        "frac_sign_differ": mask_differ}
            row["ok"] = bool(row["ok"] and torch.isfinite(got.float()).all()
                             and rel <= TOL[dname]
                             and (dname == "float32" or differ <= MAX_DIFFER_BF16))
        emit(row)
        if not row["ok"]:
            failures.append(f"rdb_ct training forward {dname}: {row}")

        for name, (kern, plain, lib, macs, nbytes, plain_own) in cases.items():
            with fp32_exact():
                wrapper = name if name in DESIGNED + DENSE_BWD_DESIGNED else name.rsplit("_", 1)[0]
                dense = wrapper in DENSE_BWD_DESIGNED
                designed = wrapper in DESIGNED or dense
                if designed:  # bf16 on the tensor cores, fp32 on the FMA kernels
                    got, design = _design_of(getattr(K if dense else T, wrapper), kern)
                else:
                    got = kern()
                torch.cuda.synchronize()
                ref = plain()
                worst, worst_abs, finite = worst_err(got, ref)
                ok = finite and worst <= BWD_TOL[dname]
                extra = {}
                if designed:
                    again = kern()
                    bits = all(got[k] is None or torch.equal(again[k], got[k]) for k in got)
                    extra = {"design": design, "repeat_bit_equal": bits}
                    if design == "mma":  # ms of each launch (and its finishing pass)
                        steps = mma_steps[name]()
                        extra["step_ms"] = {k: time_ms(f, iters=10) for k, f in steps.items()}
                        if dense:  # the card alone: each launch, the call and cuDNN autograd
                            extra.update(step_device_ms={k: device_ms(f, iters=10)
                                                         for k, f in steps.items()},
                                         device_ms=device_ms(kern, iters=10),
                                         library_device_ms=device_ms(lib, iters=10))
                    ok = ok and bits and design == T.S.design(dtype)
                if wrapper == "upfold_ct_bwd":  # db sums the unrounded dz, as the twin
                    extra["db_rel_err"] = worst_err({"b": got["b"]}, {"b": ref["b"]})[0]
                    ok = ok and extra["db_rel_err"] <= DB_TOL
                own = {}
                if plain_own is not None:
                    own = {"rel_err_own_buffers": worst_err(got, plain_own())[0],
                           "tol_own_buffers": BWD_TOL_OWN_BUFFERS}
                    ok = ok and own["rel_err_own_buffers"] <= BWD_TOL_OWN_BUFFERS
                # backward does the forward's products twice (dx and dW)
                ops_ms = 2 * 2 * macs / PEAK_FLOPS[dname] * 1e3
                bytes_ms = nbytes / PEAK_BYTES * 1e3
                row = {"phase": "kernels-bwd", "kernel": name, "dtype": dname,
                       "lr": [2, 37, 53] if name.endswith("_odd") else list(TRAIN_SHAPE),
                       "max_abs_err": worst_abs,
                       "rel_err": worst, "tol": BWD_TOL[dname], "ok": ok,
                       "ms": time_ms(kern, iters=10), "plain_ms": time_ms(plain, iters=5),
                       "library_ms": time_ms(lib, iters=10),
                       "bound_ms": max(ops_ms, bytes_ms),
                       "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", **own,
                       **extra}
                report[(name, dname)] = row
            emit(row)
            if not ok:
                failures.append(f"{name} {dname}: gradient rel err {worst:.3g}"
                                + (f", twin on its own buffers "
                                   f"{own['rel_err_own_buffers']:.3g}" if own else "")
                                + (f", {extra}" if extra else ""))
    return report


def check_dense_accuracy(failures):
    """Phase kernels-dense-accuracy, one line: rdb_ct's bf16 training forward
    (``out``, the saved x1..x4 ``cat`` and l2|l4 ``lsv``) at the odd, bench
    and train shapes, with and without the RRDB fold: the share of each that
    differs from the twin at all, for the tensor-core design the model paths
    run (held to MAX_DIFFER_BF16 and the bf16 bar) and for the FMA design on
    the same bf16 inputs, the baseline it is measured against (reported);
    beside them the shares of the tensor cores and of the twin off the
    twin's graph summed in float64 (``rdb_ct_fp64``; reported)."""
    import torch

    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.models.layers import fp32_exact

    gen = torch.Generator().manual_seed(3)
    w = K.prepare_rdb_ct_weights(_rdb_params(gen), torch.bfloat16)
    row = {"phase": "kernels-dense-accuracy", "kernel": "rdb_ct", "dtype": "bfloat16",
           "tol": TOL["bfloat16"], "max_differ": MAX_DIFFER_BF16, "mma": {}, "fma_baseline": {},
           "mma_rel_err": {}, "mma_vs_fp64": {}, "twin_vs_fp64": {}}
    share = lambda got, want: {n: (a != b).float().mean().item()
                               for n, a, b in zip(("out", "cat", "lsv"), got, want)}
    ok = True
    for sname, (B, H, W) in SHAPES.items():
        x = torch.rand((B, H, W, NF), generator=gen).to("cuda", torch.bfloat16)
        res = torch.rand((B, H, W, NF), generator=gen).to("cuda", torch.bfloat16)
        for fold in (False, True):
            kw = dict(res=res, rrdb_scale=0.2) if fold else {}
            case = f"{sname}{'_fold' if fold else ''}"
            with fp32_exact():
                ref = K._rdb_ct_train_plain(x, w, **kw)
                exact = K.rdb_ct_fp64(x, w, **kw)
                row["twin_vs_fp64"][case] = share(ref, exact)
                for kind, key in (("mma", "mma"), ("fma", "fma_baseline")):
                    got = K._rdb_ct_cuda(x, w, save=True, kind=kind, **kw)
                    torch.cuda.synchronize()
                    row[key][case] = share(got, ref)
                    if kind == "mma":
                        row["mma_vs_fp64"][case] = share(got, exact)
                        row["mma_rel_err"][case] = {n: rel_err(a, b)[1] for n, a, b in
                                                    zip(("out", "cat", "lsv"), got, ref)}
                        ok = ok and all(bool(torch.isfinite(a.float()).all()) for a in got)
    ok = ok and all(v <= MAX_DIFFER_BF16 for c in row["mma"].values() for v in c.values())
    ok = ok and all(v <= TOL["bfloat16"] for c in row["mma_rel_err"].values() for v in c.values())
    row["ok"] = bool(ok)
    emit(row)
    if not ok:
        failures.append(f"kernels-dense-accuracy: {row}")


def _planned(plan):
    """Run a backward's planned launches ``(steps, out)`` in order → ``out``
    (uncounted: the FMA baseline of a bf16 call, which no wrapper takes)."""
    steps, out = plan
    for step in steps.values():
        step()
    return out


def check_dense_bwd_accuracy(failures):
    """Phase kernels-dense-bwd-accuracy, one line: bf16 ``rdb_ct_bwd`` (input
    noise on) at the odd and train shapes on the saved buffers of the
    kernel's training forward, and ``conv3x3_ct_bwd`` at the train shape:
    how far dx, the weight gradients (the worst of w1..w5, w11) and the bias
    gradients (the worst of b1..b5) sit from the twin's graph summed in
    float64 (``rdb_ct_bwd_plain(acc=float64)``; dx rounded once to bf16
    there too), for the tensor cores (``mma``), for the FMA design on the
    same bf16 inputs (``fma_baseline``) and for the twin itself: max|Δ| /
    max|ref| per group, and the share of dx's entries that differ. Reported,
    not gated (``kernels-bwd`` holds the bars); fails only on a non-finite
    gradient."""
    import torch

    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.models.layers import fp32_exact

    gen = torch.Generator().manual_seed(15)
    bf = torch.bfloat16
    w = K.prepare_rdb_ct_weights(_rdb_params(gen), bf)
    row = {"phase": "kernels-dense-bwd-accuracy", "dtype": "bfloat16", "mma": {},
           "fma_baseline": {}, "twin": {}}
    finite = True

    def dist(got, ref):
        out = {}
        for grp in ("dx", "w", "b"):
            errs = [(got[k].double() - r.double()).abs().max().item()
                    / max(r.double().abs().max().item(), 1e-30)
                    for k, r in ref.items() if r is not None and k[0] == grp[0]]
            out[{"dx": "dx", "w": "dW", "b": "db"}[grp]] = max(errs)
        out["dx_frac_differ"] = (got["dx"] != ref["dx"]).float().mean().item()
        return out

    for sname in ("odd", "train"):
        B, H, W = SHAPES[sname]
        act = lambda: torch.randn((B, H, W, NF), generator=gen).to("cuda", bf)
        x, noise, g = act(), act(), act()
        with fp32_exact():
            _, cat, lsv = K._rdb_ct_cuda(x, w, None, noise, sigma=0.1, save=True)
            args = (x, w, cat, lsv, g, noise)
            exact = K.rdb_ct_bwd_plain(*args, sigma=0.1, acc=torch.float64)
            calls = {"mma": lambda: K.rdb_ct_bwd(*args, sigma=0.1),
                     "fma_baseline": lambda: _planned(
                         K._rdb_ct_bwd_steps(*args, sigma=0.1, kind="fma")),
                     "twin": lambda: K.rdb_ct_bwd_plain(*args, sigma=0.1)}
            for key, call in calls.items():
                got = call()
                finite = finite and all(bool(torch.isfinite(t.float()).all())
                                        for t in got.values() if t is not None)
                row[key][f"rdb_ct_bwd_{sname}"] = dist(got, exact)
    B, H, W = TRAIN_SHAPE
    x = torch.randn((B, H, W, NF), generator=gen).to("cuda", bf)
    g = torch.randn((B, H, W, NF), generator=gen).to("cuda", bf)
    wc = (torch.randn((3, 3, NF, NF), generator=gen) * (2.0 / (9 * NF)) ** 0.5).to("cuda", bf)
    with fp32_exact():
        x64, g64 = (t.double().permute(0, 3, 1, 2) for t in (x, g))
        exact = {"dx": K._dgrad_plain(g64, wc).to(bf).permute(0, 2, 3, 1),
                 "w": K._wgrad_plain(x64, g64), "b": g64.sum((0, 2, 3))}
        calls = {"mma": lambda: K.conv3x3_ct_bwd(x, wc, g),
                 "fma_baseline": lambda: _planned(K._conv3x3_ct_bwd_steps(x, wc, g, "fma")),
                 "twin": lambda: K.conv3x3_ct_bwd_plain(x, wc, g)}
        for key, call in calls.items():
            got = call()
            finite = finite and all(bool(torch.isfinite(t.float()).all()) for t in got.values())
            row[key]["conv3x3_ct_bwd_train"] = dist(got, exact)
    row["ok"] = bool(finite)
    emit(row)
    if not finite:
        failures.append(f"kernels-dense-bwd-accuracy: a gradient is not finite: {row}")


def check_conv_hr_gate(failures, seeds=4):
    """Phase kernels-bwd-gate: bf16 conv_hr_ct_bwd at the training shape on
    ``seeds`` seeded inputs. The lrelu gate is the sign of conv0's
    activation, which the kernel path and the twin recompute apart: per seed
    the share of the tensor-core recompute (``conv_s1_ct``, the same kernel)
    that differs from the twin's at all, the share ``fix_near_zero_hid``
    rewrites, whether the dense-stage kernel's bf16 recompute (its tensor-core
    design, ``csrc/dense_conv.cuh``) equals the twin's, the gates whose sign differs from the twin's
    before and after the fix, and every gradient against the twin with the
    fix (the path; held to BWD_TOL) and without it (reported)."""
    import torch

    from esrganplus_tpu_torch.kernels import build, launch
    from esrganplus_tpu_torch.kernels import stage_ct as S
    from esrganplus_tpu_torch.kernels import tail_ct as T
    from esrganplus_tpu_torch.kernels.rdb_ct import _conv, _dense, _lrelu
    from esrganplus_tpu_torch.models.layers import fp32_exact

    B, H, W = TRAIN_SHAPE
    dt, dev = torch.bfloat16, "cuda"
    gen = torch.Generator().manual_seed(5)
    rnd = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen) * scale).to(dev)
    rows = []
    for seed in range(seeds):
        hr0 = {"w": rnd(3, 3, NF, NF, scale=(2.0 / (9 * NF)) ** 0.5), "b": rnd(NF, scale=0.1)}
        hr1 = {"w": rnd(3, 3, NF, OUT_NC, scale=(2.0 / (9 * NF)) ** 0.5),
               "b": rnd(OUT_NC, scale=0.1)}
        w0, b0, w1, _ = T.prepare_conv_hr_ct(hr0, hr1, dt)
        x, g = rnd(B, 4 * H, 4 * W, NF).to(dt), rnd(B, 4 * H, 4 * W, OUT_NC).to(dt)
        with fp32_exact():
            ref = T.conv_hr_ct_bwd_plain(x, w0, b0, w1, g)
            hid_twin = _lrelu(_conv(x.float().permute(0, 3, 1, 2), w0, b0), 0.2).to(dt)
            hid_twin = hid_twin.permute(0, 2, 3, 1)
            hid = S.conv_s1_ct(x, w0, b0, act="lrelu")
            differ = (hid != hid_twin).float().mean().item()
            flips = int(((hid >= 0) != (hid_twin >= 0)).sum())
            near = hid.abs().float().view(-1, 8)
            near = (near < near.amax(1, keepdim=True) / 65536).float().mean().item()
            fixed = hid.clone()
            T.fix_near_zero_hid(fixed, x, w0, b0)
            flips_fixed = int(((fixed >= 0) != (hid_twin >= 0)).sum())
            hid_dense = torch.empty_like(x)
            _dense(build.load("rdb_ct"), x, None, NF, w0, b0, hid_dense.data_ptr(), NF,
                   mode=launch.ACT, cout=NF, slope=0.2)
            got = T.conv_hr_ct_bwd(x, w0, b0, w1, g)
            steps, unfixed = T.conv_hr_bwd_mma_steps(x, w0, b0, w1, g)
            for name, step in steps.items():
                if name != "hid_near_zero":
                    step()
            torch.cuda.synchronize()
        err, _, finite = worst_err(got, ref)
        rows.append({"seed": seed, "hid_share_differing_from_twin": differ,
                     "hid_share_rewritten": near,
                     "dense_mma_hid_equals_twin": bool(torch.equal(hid_dense, hid_twin)),
                     "gate_sign_flips_tensor_cores": flips,
                     "gate_sign_flips_after_fix": flips_fixed, "rel_err": err,
                     "rel_err_without_fix": worst_err(unfixed, ref)[0], "finite": finite})
    ok = all(r["finite"] and r["rel_err"] <= BWD_TOL["bfloat16"] for r in rows)
    row = {"phase": "kernels-bwd-gate", "kernel": "conv_hr_ct_bwd", "dtype": "bfloat16",
           "lr": list(TRAIN_SHAPE), "tol": BWD_TOL["bfloat16"], "seeds": rows, "ok": ok}
    emit(row)
    if not ok:
        failures.append(f"kernels-bwd-gate: {row}")


# ---------------------------------------------------------------------------
# the GAN slice: the stage kernels of the discriminator (D) and the VGG19
# perceptual net (F) against their plain twins
# ---------------------------------------------------------------------------


def make_stage_case(dtype, gen, ks, B, H, W, cin, cout, act):
    """One stage conv on seeded tensors: forward and backward wrappers, their
    twins, a cuDNN yardstick (``F.conv2d`` and ``autograd.grad`` through it,
    used nowhere in the port), MACs and the bytes each direction must move."""
    import torch
    import torch.nn.functional as F

    from esrganplus_tpu_torch.kernels import stage_ct as S
    from esrganplus_tpu_torch.models.layers import fp32_exact

    dev = "cuda"
    esz = torch.tensor([], dtype=dtype).element_size()
    fwd, fwd_p, bwd, bwd_p = ((S.conv_s1_ct, S.conv_s1_ct_plain, S.conv_s1_ct_bwd,
                               S.conv_s1_ct_bwd_plain) if ks == 3 else
                              (S.conv_s2_ct, S.conv_s2_ct_plain, S.conv_s2_ct_bwd,
                               S.conv_s2_ct_bwd_plain))
    stride = 1 if ks == 3 else 2
    rnd = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen) * scale).to(dev)
    w, b = S.prepare_stage_ct(rnd(ks, ks, cin, cout, scale=(2.0 / (ks * ks * cin)) ** 0.5),
                              rnd(cout, scale=0.1), dtype)
    x = rnd(B, H, W, cin).to(dtype)
    kw = dict(act=act, slope=0.2)
    with fp32_exact():
        out, out_p = fwd(x, w, b, **kw), fwd_p(x, w, b, **kw)
    g = rnd(*out.shape).to(dtype)
    saved = (lambda o: None if act is None else o)

    xn = x.permute(0, 3, 1, 2).contiguous().requires_grad_()
    wo = w.permute(3, 2, 0, 1).contiguous().requires_grad_()
    bo = b.to(dtype).requires_grad_()
    gn = g.permute(0, 3, 1, 2).contiguous()

    def lib():
        y = F.conv2d(xn, wo, bo, stride=stride, padding=1)
        return F.relu(y) if act == "relu" else F.leaky_relu(y, 0.2) if act == "lrelu" else y

    lib_out = lib()
    n_out = out.numel() // cout
    nw = w.numel()
    return {
        "fwd": (lambda: fwd(x, w, b, **kw), lambda: fwd_p(x, w, b, **kw),
                lambda: lib().detach()),
        "bwd": (lambda: bwd(x, w, saved(out), g, **kw), lambda: bwd_p(x, w, saved(out), g, **kw),
                lambda: torch.autograd.grad(lib_out, [xn, wo, bo], gn, retain_graph=True),
                None if act is None else lambda: bwd_p(x, w, out_p, g, **kw)),
        "bwd_dx_only": lambda: bwd(x, w, saved(out), g, need_dw=False, **kw),
        "bwd_dw_only": lambda: bwd(x, w, saved(out), g, need_dx=False, **kw),
        "macs": n_out * nw,
        "fwd_bytes": (x.numel() + out.numel() + nw) * esz + 4 * cout,
        # x, g, the saved output and the weights in; dx out; dW and db out in fp32
        "bwd_bytes": ((2 * x.numel() + (1 if act is None else 2) * out.numel() + nw) * esz
                      + 4 * (nw + cout)),
    }


def _design_of(fn, call, attr="launches_by_design"):
    """The result of ``call()`` and the one design its launch of ``fn`` took
    (by ``fn``'s counter ``attr``)."""
    before = dict(getattr(fn, attr))
    out = call()
    ran = [d for d, n in getattr(fn, attr).items() if n > before[d]]
    return out, ran[0] if len(ran) == 1 else ran


def _path_designs(failures, phase, launches):
    """``launches_by_design`` of the two-design wrappers that ``launches``
    counts: the tail's (since ``tail_ct.reset_design_counts()``), the dense
    stages' and their adjoints' (since ``rdb_ct.reset_design_counts()``); a
    bf16 path must have run every call of each through "mma"."""
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import tail_ct as T

    fns = {**{k: getattr(T, k) for k in DESIGNED},
           **{k: getattr(K, k) for k in DENSE_DESIGNED + DENSE_BWD_DESIGNED}}
    by_design = {k: dict(fn.launches_by_design) for k, fn in fns.items() if k in launches}
    for k, got in by_design.items():
        if got != {"fma": 0, "mma": launches[k]}:
            failures.append(f"{phase}: {k} launched {got} by design, expected "
                            f"{launches[k]} mma")
    return by_design


def check_stage_kernels(failures):
    """Phase kernels-stage: conv_s1_ct, conv_s2_ct and their backward wrappers
    against their twins, fp32 (TF32 off) and bf16, at an odd shape and at
    every shape the flagship GAN step gives them (timed there). Each row
    names the design its launch took (``stage_ct.design``): bf16 must run on
    the tensor cores (``mma``), fp32 on ``fma``. The backward's dx-only and
    dW-only halves and a second full call must give the full call's bits;
    bf16 ``conv_s2_ct_bwd`` rows also time both halves and cuDNN autograd on
    the card alone (:func:`device_ms`)."""
    import torch

    from esrganplus_tpu_torch.kernels import stage_ct as S
    from esrganplus_tpu_torch.models.layers import fp32_exact

    gen = torch.Generator().manual_seed(2)
    report = {}
    odd = [("odd", ks, STAGE_ODD[0], *STAGE_ODD[1:], cin, cout, a, "odd")
           for ks in (3, 4) for cin, cout in ((3, 8), (16, 16)) for a in (None, "relu", "lrelu")]
    flag = [(name, ks, GAN_BATCH, hw, hw, cin, cout, a, net)
            for name, (ks, cin, cout, hw, a, net) in STAGE_SHAPES.items()]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for sname, ks, B, H, W, cin, cout, act, net in odd + flag:
            case = make_stage_case(dtype, gen, ks, B, H, W, cin, cout, act)
            kname = "conv_s1_ct" if ks == 3 else "conv_s2_ct"
            want = "mma" if dname == "bfloat16" else "fma"  # both directions
            base = {"dtype": dname, "shape": sname, "net": net, "x": [B, H, W, cin],
                    "cout": cout, "act": act}
            with fp32_exact():
                kern, plain, lib = case["fwd"]
                got, design = _design_of(getattr(S, kname), kern)
                torch.cuda.synchronize()
                ref = plain()
                d, rel = rel_err(got, ref)
                differ = (got != ref).float().mean().item()
                ok = (bool(torch.isfinite(got.float()).all()) and rel <= TOL[dname]
                      and (dname == "float32" or differ <= MAX_DIFFER_BF16) and design == want)
                row = {"phase": "kernels-stage", "kernel": kname, **base, "design": design,
                       "max_abs_err": d, "rel_err": rel, "tol": TOL[dname], "frac_differ": differ,
                       "rel_err_vs_library": rel_err(got, lib().permute(0, 2, 3, 1))[1],
                       "ok": ok}
                if sname != "odd":
                    ops_ms = 2 * case["macs"] / PEAK_FLOPS[dname] * 1e3
                    bytes_ms = case["fwd_bytes"] / PEAK_BYTES * 1e3
                    row.update(ms=time_ms(kern), plain_ms=time_ms(plain),
                               library_ms=time_ms(lib), bound_ms=max(ops_ms, bytes_ms),
                               bound_by="operations" if ops_ms >= bytes_ms else "bytes")
                    report[(kname, sname, dname)] = row
                emit(row)
                if not ok:
                    failures.append(f"{kname} {dname} {sname} {cin}->{cout} act={act}: "
                                    f"rel err {rel:.3g}, differ {differ:.3g}, design {design}")

                kern, plain, lib, plain_own = case["bwd"]
                got, design = _design_of(getattr(S, kname + "_bwd"), kern)
                torch.cuda.synchronize()
                worst, worst_abs, finite = worst_err(got, plain())
                ok = finite and worst <= BWD_TOL[dname]
                own = {}
                if plain_own is not None:
                    own = {"rel_err_own_buffers": worst_err(got, plain_own())[0],
                           "tol_own_buffers": BWD_TOL_OWN_BUFFERS}
                    ok = ok and own["rel_err_own_buffers"] <= BWD_TOL_OWN_BUFFERS
                # the half a frozen net launches must give the same dx, the half
                # an image input launches the same dW and db, and a second call
                # the same bits (the reduction order is fixed by the shapes)
                dx_only, dw_only, again = (case["bwd_dx_only"](), case["bwd_dw_only"](),
                                           kern())
                bits = (dx_only["w"] is None and torch.equal(dx_only["dx"], got["dx"])
                        and dw_only["dx"] is None
                        and all(torch.equal(dw_only[k], got[k]) for k in ("w", "b"))
                        and all(torch.equal(again[k], got[k]) for k in ("dx", "w", "b")))
                ok = ok and bits and design == want
                row = {"phase": "kernels-stage", "kernel": kname + "_bwd", **base,
                       "design": design, "max_abs_err": worst_abs, "rel_err": worst,
                       "tol": BWD_TOL[dname], "halves_and_repeat_bit_equal": bits,
                       "ok": bool(ok), **own}
                if sname != "odd":
                    ops_ms = 2 * 2 * case["macs"] / PEAK_FLOPS[dname] * 1e3
                    bytes_ms = case["bwd_bytes"] / PEAK_BYTES * 1e3
                    row.update(ms=time_ms(kern, iters=10), plain_ms=time_ms(plain, iters=5),
                               library_ms=time_ms(lib, iters=10),
                               dx_only_ms=time_ms(case["bwd_dx_only"], iters=10),
                               dw_only_ms=time_ms(case["bwd_dw_only"], iters=10),
                               bound_ms=max(ops_ms, bytes_ms),
                               bound_by="operations" if ops_ms >= bytes_ms else "bytes")
                    if (ks, dname) == (4, "bfloat16"):  # the card alone, like against like
                        row.update(dx_only_device_ms=device_ms(case["bwd_dx_only"]),
                                   dw_only_device_ms=device_ms(case["bwd_dw_only"]),
                                   device_ms=device_ms(kern), library_device_ms=device_ms(lib))
                    report[(kname + "_bwd", sname, dname)] = row
                emit(row)
                if not ok:
                    failures.append(f"{kname}_bwd {dname} {sname} {cin}->{cout} act={act}: "
                                    f"gradient rel err {worst:.3g} {own}, bits {bits}, "
                                    f"design {design}")
    return report


# ---------------------------------------------------------------------------
# phases 5-7: training
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def train_check(failures):
    """Flagship width and depth, one batch of the training shape: the kernel
    path's loss and every gradient leaf against autograd of the plain graph
    (cuDNN with TF32 off, in its backward too) on the card, the same noise
    tensors fed to both. fp32: loss 1e-5, every leaf within 1e-3 of max|ref|.
    bf16 (kernel path in bf16 against the fp32 plain graph): the loss within
    2e-2, every leaf within 0.1 and the whole gradient's cosine at least
    0.999; the bf16 cuDNN graph's own figures are printed beside it."""
    import dataclasses

    import torch

    from esrganplus_tpu_torch.infer import params_to
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.models.layers import fp32_exact
    from esrganplus_tpu_torch.models.rrdb import (RRDBNetConfig, draw_noise, init_rrdbnet,
                                                  rrdbnet_forward)

    cfg = RRDBNetConfig()
    plain = dataclasses.replace(cfg, trunk_kernel="plain", tail_kernel="plain")
    B, H, W = TRAIN_SHAPE
    params = params_to(init_rrdbnet(cfg, seed=0, init_scale=0.5), "cuda")
    named = _leaves(params)
    for _, p in named:
        p.requires_grad_()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand((B, H, W, 3), generator=gen, device="cuda")
    hr = torch.rand((B, 4 * H, 4 * W, 3), generator=gen, device="cuda")
    noise = draw_noise(cfg, (B, H, W, cfg.nf), gen, torch.float32, "cuda")

    def run(c, dtype):
        with fp32_exact():  # the backward runs here, outside the forward's own context
            y = rrdbnet_forward(params, x, c, train=True, noise=noise, dtype=dtype)
            loss = (y.float() - hr).abs().mean()
            grads = torch.autograd.grad(loss, [p for _, p in named])
        return loss.item(), grads

    flat = lambda gs: torch.cat([g.flatten().float() for g in gs])
    l_ref, g_ref = run(plain, None)
    for dname, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        K.reset_design_counts()
        l_k, g_k = run(cfg, dtype)
        # every dense-stage call and adjoint by design: fp32 on the CUDA cores,
        # bf16 on the tensor cores
        want = "mma" if dtype else "fma"
        by_design = {k: dict(getattr(K, k).launches_by_design)
                     for k in DENSE_DESIGNED + DENSE_BWD_DESIGNED}
        designs_ok = all(d == {"fma": 0, "mma": 0, want: getattr(K, k).launches} and d[want] > 0
                         for k, d in by_design.items())
        per_leaf = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                    for (n, _), a, b in zip(named, g_k, g_ref)}
        worst = max(per_leaf, key=per_leaf.get)
        cos = torch.nn.functional.cosine_similarity(flat(g_k), flat(g_ref), dim=0).item()
        row = {"phase": "train-check", "dtype": dname, "loss_plain_fp32": l_ref,
               "loss_kernel": l_k, "loss_rel_err": abs(l_k - l_ref) / abs(l_ref),
               "grad_worst_leaf": worst, "grad_worst_rel_err": per_leaf[worst],
               "grad_cosine": cos, "leaves": len(named), "dense_by_design": by_design,
               "finite": all(bool(torch.isfinite(g).all()) for g in g_k)}
        if dtype is None:
            row.update(tol_loss=1e-5, tol_grad=1e-3)
            ok = row["loss_rel_err"] <= 1e-5 and per_leaf[worst] <= 1e-3
        else:
            l_p, g_p = run(plain, dtype)  # context: the cuDNN bf16 graph's own distance
            row.update(tol_loss=2e-2, tol_grad=0.1, tol_cosine=0.999,
                       plain_bf16_loss_rel_err=abs(l_p - l_ref) / abs(l_ref),
                       plain_bf16_grad_cosine=torch.nn.functional.cosine_similarity(
                           flat(g_p), flat(g_ref), dim=0).item())
            ok = row["loss_rel_err"] <= 2e-2 and per_leaf[worst] <= 0.1 and cos >= 0.999
        row["ok"] = bool(ok and row["finite"] and designs_ok)
        emit(row)
        if not row["ok"]:
            failures.append(f"train-check {dname}: {row}")


def _smooth_image(rng, h, w):
    """Smooth random content: bilinear blow-up of a coarse random grid."""
    coarse = rng.rand(h // 8 + 2, w // 8 + 2, 3)
    yy = np.linspace(0, coarse.shape[0] - 1.001, h)
    xx = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0, x0 = yy.astype(int), xx.astype(int)
    fy, fx = (yy - y0)[:, None, None], (xx - x0)[None, :, None]
    img = ((1 - fy) * ((1 - fx) * coarse[y0][:, x0] + fx * coarse[y0][:, x0 + 1])
           + fy * ((1 - fx) * coarse[y0 + 1][:, x0] + fx * coarse[y0 + 1][:, x0 + 1]))
    return (img * 255).round().astype(np.uint8)


def _logged_losses(exp_dir, key="l_pix"):
    """({step: the logged text of ``key``}, the log text) from the newest
    train log of an experiment."""
    logs = sorted(f for f in os.listdir(exp_dir) if f.endswith(".log"))
    text = open(os.path.join(exp_dir, logs[-1])).read()
    return {int(m.group(1).replace(",", "")): m.group(2)
            for m in re.finditer(rf"<step:\s*([\d,]+),.*?\b{key}: (\S+)", text)}, text


def _smoke_dataset(workdir):
    """8 train and VAL_IMAGES validation PNG pairs (HR and bicubic ×1/4 LR)
    from a seed → {"HR" | "LR" | "valHR" | "valLR": directory}."""
    from esrganplus_tpu_torch.ops.image_io import save_img
    from esrganplus_tpu_torch.ops.resize import imresize_np

    rng = np.random.RandomState(3)
    dirs = {k: os.path.join(workdir, k) for k in ("HR", "LR", "valHR", "valLR")}
    for prefix, n, size in (("", 8, (192, 192)), ("val", VAL_IMAGES, (96, 128))):
        for i in range(n):
            img = _smooth_image(rng, *size)
            save_img(img, os.path.join(dirs[prefix + "HR"], f"img{i}.png"))
            lr = np.clip(imresize_np(img.astype(np.float32) / 255.0, 0.25), 0, 1)
            save_img((lr * 255).round().astype(np.uint8),
                     os.path.join(dirs[prefix + "LR"], f"img{i}.png"))
    return dirs


def _smoke_options(workdir, dirs, name, model, train):
    """The flagship recipe's options (batch 16, HR 128, bf16, noise on) cut
    to TRAIN_STEPS steps with the debug cadences."""
    return {
        "name": name, "model": model, "scale": 4, "use_tb_logger": False,
        "datasets": {
            # one worker: the batch stream is then a function of the seed alone
            "train": {"name": "smoke", "mode": "LRHR", "dataroot_HR": dirs["HR"],
                      "dataroot_LR": dirs["LR"], "n_workers": 1, "batch_size": TRAIN_SHAPE[0],
                      "HR_size": 4 * TRAIN_SHAPE[1], "use_flip": True, "use_rot": True},
            "val": {"name": "smoke_val", "mode": "LRHR", "dataroot_HR": dirs["valHR"],
                    "dataroot_LR": dirs["valLR"]},
        },
        "path": {"root": workdir},
        "network_G": {"which_model_G": "RRDB_net", "norm_type": None, "mode": "CNA",
                      "nf": NF, "nb": 23, "in_nc": 3, "out_nc": OUT_NC, "gc": GC,
                      "gaussian_noise": True},
        "train": {"lr_scheme": "MultiStepLR", "lr_steps": [200000], "lr_gamma": 0.5,
                  "pixel_criterion": "l1", "manual_seed": 0, "niter": TRAIN_STEPS,
                  "compute_dtype": "bfloat16", **train},
        "logger": {"print_freq": 2},
    }


def train_path(failures, workdir, noise_kernel="input"):
    """16 flagship training steps through the CLI, then a resume from step 8.
    ``noise_kernel="fused"`` (phase train-fused): every per-RDB site draws its
    noise in rdb_ct's epilogue and rdb_ct_bwd replays it, so all 69 forward
    and 69 backward rdb_ct calls of each step must be seeded ones."""
    import shutil

    import torch

    from esrganplus_tpu_torch.cli import train as train_cli
    from esrganplus_tpu_torch.infer import load_generator
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import tail_ct as T
    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig, init_rrdbnet

    fused = noise_kernel == "fused"
    phase, name = ("train-fused", "debug_smoke_fused") if fused else ("train", "debug_smoke")
    dirs = _smoke_dataset(workdir)
    opt = _smoke_options(workdir, dirs, name, "sr", {"lr_G": 2e-4, "pixel_weight": 1.0})
    opt["network_G"]["noise_kernel"] = noise_kernel
    opt_path = os.path.join(workdir, "train_smoke.json")
    with open(opt_path, "w") as f:
        json.dump(opt, f, indent=1)

    fwd = (K.rdb_ct, K.conv3x3_ct, T.upfold_ct, T.conv_hr_ct)
    bwd = (K.rdb_ct_bwd, K.conv3x3_ct_bwd, T.upfold_ct_bwd, T.conv_hr_ct_bwd)
    for fn in fwd + bwd:
        fn.launches = 0
    T.reset_design_counts()
    K.reset_design_counts()
    K.rdb_ct.seeded_launches = K.rdb_ct_bwd.seeded_launches = 0
    t0 = time.perf_counter()
    train_cli.main(["-opt", opt_path, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fwd + bwd}
    seeded = {"rdb_ct": K.rdb_ct.seeded_launches, "rdb_ct_bwd": K.rdb_ct_bwd.seeded_launches}
    # forward: every step, plus each validation image at steps 8 and 16
    n_val = VAL_IMAGES * (TRAIN_STEPS // 8)
    for k, per in PER_IMAGE.items():
        if launches[k] != per * (TRAIN_STEPS + n_val):
            failures.append(f"{phase}: {k} launched {launches[k]} times, expected "
                            f"{per * (TRAIN_STEPS + n_val)}")
    for k, per in BWD_PER_STEP.items():
        if launches[k] != per * TRAIN_STEPS:
            failures.append(f"{phase}: {k} launched {launches[k]} times, expected "
                            f"{per * TRAIN_STEPS}")
    by_design = _path_designs(failures, phase, launches)  # bf16: the tensor cores
    want_seeded = 69 * TRAIN_STEPS if fused else 0  # validation forwards draw no noise
    if seeded != {"rdb_ct": want_seeded, "rdb_ct_bwd": want_seeded}:
        failures.append(f"{phase}: seeded rdb_ct launches {seeded}, expected {want_seeded} each")

    exp = os.path.join(workdir, "experiments", name)
    losses, text = _logged_losses(exp)
    finite = all(np.isfinite(float(v)) for v in losses.values())
    files = {f: os.path.exists(os.path.join(exp, f)) for f in
             ("training_state/8.state.npz", "training_state/16.state.npz", "models/8_G.pth",
              "models/16_G.pth", "models/latest_G.pth")}
    cfg = RRDBNetConfig()
    latest = os.path.join(exp, "models", "latest_G.pth")
    trained, tcfg, _ = load_generator(latest, device="cuda")
    init = init_rrdbnet(cfg, seed=0, init_scale=0.1)
    moved = max((a.cpu() - b).abs().max().item()
                for (_, a), (_, b) in zip(_leaves(trained), _leaves(init)))
    row = {"phase": phase, "noise_kernel": noise_kernel, "steps": TRAIN_STEPS,
           "seconds_total": seconds, "launches": launches, "seeded_launches": seeded,
           "by_design": by_design, "l_pix": losses, "finite": finite,
           "files": files,
           "validations": text.count("Validation # PSNR"), "max_abs_weight_change": moved,
           "reloaded": [tcfg.nb, tcfg.nf, tcfg.gc]}
    ok = (finite and sorted(losses) == list(range(2, TRAIN_STEPS + 1, 2)) and all(files.values())
          and row["validations"] == TRAIN_STEPS // 8 and moved > 0
          and (tcfg.nb, tcfg.nf, tcfg.gc) == (23, NF, GC))
    row["ok"] = bool(ok)
    emit(row)
    if not ok:
        failures.append(f"{phase}: {row}")

    # resume from step 8: the same batches, noise and arithmetic must follow
    kept = os.path.join(workdir, "latest_G_uninterrupted.pth")
    shutil.copy(latest, kept)
    opt["path"]["resume_state"] = os.path.join(exp, "training_state", "8.state.npz")
    with open(opt_path, "w") as f:
        json.dump(opt, f, indent=1)
    train_cli.main(["-opt", opt_path, "--device", "cuda"])
    torch.cuda.synchronize()
    losses2, text2 = _logged_losses(exp)
    a, b = torch.load(kept), torch.load(latest)
    diff = max((a[k] - b[k]).abs().max().item() for k in a)
    row = {"phase": phase + "-resume", "resumed": "resumed from" in text2, "l_pix": losses2,
           "l_pix_same_as_uninterrupted": all(losses2.get(s) == losses[s]
                                              for s in range(10, TRAIN_STEPS + 1, 2)),
           "max_abs_weight_diff_vs_uninterrupted": diff}
    row["ok"] = bool(row["resumed"] and row["l_pix_same_as_uninterrupted"] and diff == 0.0)
    emit(row)
    if not row["ok"]:
        failures.append(f"{phase}-resume: {row}")
    return launches


def train_steady(failures, noise_kernel="input", phase="train-steady"):
    """SRTrainer.train_step on one device-resident batch: median ms/step of
    10 after 3 warm-up steps (host clock around a synchronised step), twice
    from the same seed; the two runs' l_pix must agree bit for bit. Returns
    (median ms/step, peak device memory in bytes)."""
    import torch

    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer

    B, H, W = TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(9)
    batch = (torch.rand((B, H, W, 3), generator=gen, device="cuda"),
             torch.rand((B, 4 * H, 4 * W, 3), generator=gen, device="cuda"))
    runs = []
    for _ in range(2):
        trainer = SRTrainer(RRDBNetConfig(noise_kernel=noise_kernel),
                            SRTrainConfig(compute_dtype="bfloat16"), device="cuda")
        state = trainer.init_state(0)
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for i in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, logs = trainer.train_step(state, batch, 1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(logs["l_pix"].item())
        runs.append((losses, times[3:]))
    med = float(np.median(runs[0][1] + runs[1][1])) * 1e3
    peak = torch.cuda.max_memory_allocated()
    row = {"phase": phase, "noise_kernel": noise_kernel, "batch": B, "hr": 4 * H,
           "dtype": "bfloat16",
           "ms_per_step_runs": [float(np.median(t)) * 1e3 for _, t in runs],
           "median_ms_per_step": med, "crops_per_s": B / med * 1e3,
           "peak_memory_gb": peak / 1e9, "peak_memory_bytes": peak,
           "l_pix_run0": runs[0][0], "bit_equal_runs": runs[0][0] == runs[1][0],
           "finite": bool(np.isfinite(runs[0][0]).all())}
    row["ok"] = bool(row["finite"] and row["bit_equal_runs"])
    emit(row)
    if not row["ok"]:
        failures.append(f"{phase}: {row}")
    return med, peak


# ---------------------------------------------------------------------------
# the GAN slice: gradients, the CLI, the steady step
# ---------------------------------------------------------------------------


def _twelve():
    """The twelve counted wrappers, forward then backward."""
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import stage_ct as S
    from esrganplus_tpu_torch.kernels import tail_ct as T

    return (K.rdb_ct, K.conv3x3_ct, T.upfold_ct, T.conv_hr_ct, S.conv_s1_ct, S.conv_s2_ct,
            K.rdb_ct_bwd, K.conv3x3_ct_bwd, T.upfold_ct_bwd, T.conv_hr_ct_bwd,
            S.conv_s1_ct_bwd, S.conv_s2_ct_bwd)


def gan_check(failures):
    """Flagship width and depth (G nb=23, D vgg_128 with BN, F VGG19 to
    features[34] from a seed), one batch of the training shape: the loss terms
    and every gradient leaf of G and of D through the kernel path against
    autograd of the plain graph on the card (cuDNN, TF32 off in the backward
    too), the same noise fed to both, through ``GANTrainer``'s own loss
    functions. fp32: every logged term within 1e-4 (relative, or of 1 for the
    mean logits), every leaf of G within 5e-3 of max|ref| (see ``leaf_errs``),
    every leaf of D within 2e-2 in the 2-norm (D's lrelu gates sit behind
    batch norms: one that flips at a near-zero activation moves single
    entries of the deep weight gradients, which sum few pixels, by percents,
    so the largest entry error is printed, not held), both cosines at least
    0.9999. bf16 (kernel path in bf16 against the fp32 plain
    graph): terms within 5e-2, G's gradient cosine at least 0.999 and D's
    0.95 (D's batch-norm chain makes its bf16 gradient the noisier one in the
    cuDNN graph too, whose own figures are printed beside it)."""
    import dataclasses

    import torch

    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import stage_ct as S
    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig
    from esrganplus_tpu_torch.models.layers import deterministic_convs, fp32_exact
    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig, draw_noise
    from esrganplus_tpu_torch.models.vgg import VGGFeatConfig
    from esrganplus_tpu_torch.train import GANTrainConfig, GANTrainer
    from esrganplus_tpu_torch.train.sr_model import tree_leaves, tree_map

    B, H, W = TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand((B, H, W, 3), generator=gen, device="cuda")
    hr = torch.rand((B, 4 * H, 4 * W, 3), generator=gen, device="cuda")
    cfg_g = RRDBNetConfig()
    noise = draw_noise(cfg_g, (B, H, W, cfg_g.nf), gen, torch.float32, "cuda")

    def trainer(kind, dtype):
        g = cfg_g if kind == "auto" else dataclasses.replace(cfg_g, trunk_kernel="plain",
                                                             tail_kernel="plain")
        return GANTrainer(g, DiscriminatorVGGConfig(stage_kernel=kind),
                          GANTrainConfig(compute_dtype=dtype, init_scale_g=0.5), device="cuda",
                          vgg_cfg=VGGFeatConfig(stage_kernel=kind))

    state = trainer("plain", None).init_state(0)
    g_params, d_params = state["g_params"], state["d_params"]
    named_g, named_d = _leaves(g_params), [kv for kv in _leaves(d_params) if kv[1] is not None]

    def run(kind, dtype):
        t = trainer(kind, dtype)
        with fp32_exact(), deterministic_convs():
            real = t._d_logits(d_params, hr)
            frozen = tree_map(lambda p: p.detach(), d_params)
            g_total, fake, logs = t._g_loss(g_params, frozen, x, hr, real[0].detach(),
                                            {"noise": noise})
            g_grads = torch.autograd.grad(g_total, tree_leaves(g_params))
            d_total, _, d_logs = t._d_loss(d_params, fake.detach(), hr, None, real)
            d_grads = torch.autograd.grad(d_total, tree_leaves(d_params), allow_unused=True)
        terms = {k: v.item() for k, v in {**logs, **d_logs}.items()}
        return terms, g_grads, d_grads

    flat = lambda gs: torch.cat([g.flatten().float() for g in gs if g is not None])
    cosine = lambda a, b: torch.nn.functional.cosine_similarity(flat(a), flat(b), dim=0).item()

    def leaf_errs(named, got, ref, norm=float("inf")):
        # max|Δ| (or ‖Δ‖₂) of the leaf's largest reference entry (its norm),
        # or of 1e-3 of the net's largest where the leaf's own gradient is
        # smaller: a bias in front of a batch norm and the last bias under
        # the relativistic loss have a gradient of exactly 0, and what both
        # graphs compute there is rounding noise
        size = lambda t: torch.linalg.vector_norm(t.float().flatten(), norm)
        floor = 1e-3 * max(size(b).item() for b in ref if b is not None)
        return {n: (size(a - b) / size(b).clamp_min(floor)).item()
                for (n, _), a, b in zip(named, got, ref) if b is not None}

    def term_errs(got, ref):
        # the mean logits may sit near 0: of max(1, |ref|) for them
        return {k: abs(got[k] - ref[k]) / (max(1.0, abs(ref[k])) if k.startswith("D_")
                                           else abs(ref[k])) for k in ref}

    t_ref, gg_ref, dg_ref = run("plain", None)
    counted = _twelve()
    stage = (S.conv_s1_ct, S.conv_s2_ct, S.conv_s1_ct_bwd, S.conv_s2_ct_bwd)
    for dname, dtype in (("float32", None), ("bfloat16", "bfloat16")):
        for fn in counted:
            fn.launches = 0
        S.reset_launch_counts()
        K.reset_design_counts()
        t_k, gg_k, dg_k = run("auto", dtype)
        by_design = {fn.__name__: dict(fn.launches_by_design) for fn in stage}
        dense_fns = tuple(getattr(K, k) for k in DENSE_DESIGNED + DENSE_BWD_DESIGNED)
        dense = {fn.__name__: dict(fn.launches_by_design) for fn in dense_fns}
        want = "mma" if dtype else "fma"
        designs_ok = all(fn.launches_by_design == {"fma": 0, "mma": 0, want: fn.launches}
                         for fn in stage + dense_fns)
        terr = term_errs(t_k, t_ref)
        g_err, d_err = leaf_errs(named_g, gg_k, gg_ref), leaf_errs(named_d, dg_k, dg_ref)
        d_l2 = leaf_errs(named_d, dg_k, dg_ref, norm=2)
        wg, wd, wd2 = (max(e, key=e.get) for e in (g_err, d_err, d_l2))
        row = {"phase": "gan-check", "dtype": dname, "terms_plain_fp32": t_ref,
               "terms_kernel": t_k, "term_rel_err": terr,
               "g_worst_leaf": wg, "g_worst_rel_err": g_err[wg], "g_cosine": cosine(gg_k, gg_ref),
               "d_worst_leaf": wd, "d_worst_rel_err": d_err[wd],
               "d_worst_leaf_l2": wd2, "d_worst_rel_err_l2": d_l2[wd2],
               "d_cosine": cosine(dg_k, dg_ref),
               "leaves": [len(g_err), len(d_err)],
               "launches": {fn.__name__: fn.launches for fn in counted},
               "stage_launches_by_design": by_design, "dense_launches_by_design": dense,
               "finite": all(bool(torch.isfinite(g).all()) for g in list(gg_k) + list(dg_k)
                             if g is not None)}
        if dtype is None:
            row.update(tol_terms=1e-4, tol_g_grad=5e-3, tol_d_grad_l2=2e-2, tol_cosine=0.9999)
            ok = (max(terr.values()) <= 1e-4 and g_err[wg] <= 5e-3 and d_l2[wd2] <= 2e-2
                  and row["g_cosine"] >= 0.9999 and row["d_cosine"] >= 0.9999)
        else:
            t_p, gg_p, dg_p = run("plain", dtype)  # context: the cuDNN bf16 graph's own distance
            row.update(tol_terms=5e-2, tol_g_cosine=0.999, tol_d_cosine=0.95,
                       plain_bf16_term_rel_err=term_errs(t_p, t_ref),
                       plain_bf16_g_cosine=cosine(gg_p, gg_ref),
                       plain_bf16_d_cosine=cosine(dg_p, dg_ref))
            ok = (max(terr.values()) <= 5e-2 and row["g_cosine"] >= 0.999
                  and row["d_cosine"] >= 0.95)
        # the check itself must have gone through every stage kernel, by design
        ok = ok and designs_ok and all(row["launches"][k] == n
                                       for k, n in {**GAN_FWD_PER_STEP,
                                                    **GAN_BWD_PER_STEP}.items())
        row["ok"] = bool(ok and row["finite"])
        emit(row)
        if not row["ok"]:
            failures.append(f"gan-check {dname}: {row}")


def gan_train_path(failures, workdir):
    """TRAIN_STEPS flagship ``srragan`` steps through the CLI (G nb=23 with
    noise, discriminator_vgg_128, VGG19 perceptual net from a seed, batch 16,
    HR 128, bf16), then a resume from step 8."""
    import shutil

    import torch

    from esrganplus_tpu_torch.cli import train as train_cli
    from esrganplus_tpu_torch.convert import discriminator_from_state_dict, load_state_dict
    from esrganplus_tpu_torch.infer import load_generator
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import stage_ct as S
    from esrganplus_tpu_torch.kernels import tail_ct as T
    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig

    dirs = _smoke_dataset(workdir)
    opt = _smoke_options(workdir, dirs, "debug_gan_smoke", "srragan", {
        "lr_G": 1e-4, "lr_D": 1e-4, "pixel_weight": 1e-2, "feature_criterion": "l1",
        "feature_weight": 1, "gan_type": "vanilla", "gan_weight": 5e-3,
        "D_update_ratio": 1, "D_init_iters": 0})
    opt["network_D"] = {"which_model_D": "discriminator_vgg_128", "norm_type": "batch",
                        "act_type": "leakyrelu", "mode": "CNA", "nf": 64, "in_nc": 3}
    opt_path = os.path.join(workdir, "gan_smoke.json")
    with open(opt_path, "w") as f:
        json.dump(opt, f, indent=1)

    counted = _twelve()
    for fn in counted:
        fn.launches = 0
    S.reset_launch_counts()
    T.reset_design_counts()
    K.reset_design_counts()
    t0 = time.perf_counter()
    train_cli.main(["-opt", opt_path, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    # the bf16 step's stage convs (both sizes, both directions), the tail's
    # wrappers (upfold_ct, conv_hr_ct, upfold_ct_bwd, conv_hr_ct_bwd) and the
    # dense stages' (rdb_ct, conv3x3_ct) on "mma"
    by_design = {fn.__name__: dict(fn.launches_by_design)
                 for fn in (S.conv_s1_ct, S.conv_s1_ct_bwd, S.conv_s2_ct, S.conv_s2_ct_bwd)}
    per_step = {**GAN_FWD_PER_STEP, **GAN_BWD_PER_STEP}
    for k in by_design:
        want = {"fma": 0, "mma": per_step[k] * TRAIN_STEPS}
        if by_design[k] != want:
            failures.append(f"gan-train: {k} launched {by_design[k]} by design, expected {want}")
    by_design.update(_path_designs(failures, "gan-train", launches))
    # G's forward: every step, plus each validation image at steps 8 and 16
    n_val = VAL_IMAGES * (TRAIN_STEPS // 8)
    expected = {**{k: per * (TRAIN_STEPS + n_val) for k, per in PER_IMAGE.items()},
                **{k: per * TRAIN_STEPS for k, per in {**BWD_PER_STEP, **GAN_FWD_PER_STEP,
                                                       **GAN_BWD_PER_STEP}.items()}}
    for k, n in expected.items():
        if launches[k] != n:
            failures.append(f"gan-train: {k} launched {launches[k]} times, expected {n}")

    exp = os.path.join(workdir, "experiments", "debug_gan_smoke")
    logged = {k: _logged_losses(exp, k)[0] for k in GAN_LOG_KEYS}
    text = _logged_losses(exp)[1]
    steps = list(range(2, TRAIN_STEPS + 1, 2))
    finite = all(sorted(v) == steps and all(np.isfinite(float(t)) for t in v.values())
                 for v in logged.values())
    files = {f: os.path.exists(os.path.join(exp, f)) for f in
             ("training_state/8.state.npz", "training_state/16.state.npz", "models/8_G.pth",
              "models/8_D.pth", "models/16_G.pth", "models/16_D.pth", "models/latest_G.pth",
              "models/latest_D.pth")}
    latest = {n: os.path.join(exp, "models", f"latest_{n}.pth") for n in "GD"}
    _, tcfg, _ = load_generator(latest["G"], device="cuda")
    d_back = discriminator_from_state_dict(load_state_dict(latest["D"]),
                                           DiscriminatorVGGConfig())
    bn_moved = (d_back["bn"][1]["a"]["mean"].abs().max().item() > 0
                and (d_back["bn"][0]["b"]["var"] - 1).abs().max().item() > 0)
    row = {"phase": "gan-train", "steps": TRAIN_STEPS, "seconds_total": seconds,
           "launches": launches, "expected_launches": expected,
           "stage_launches_by_design": by_design, "logged": logged,
           "finite": finite, "files": files,
           "validations": text.count("Validation # PSNR"),
           "random_vgg_warning": "VGG19 weights not provided" in text,
           "d_running_stats_moved": bn_moved, "reloaded_g": [tcfg.nb, tcfg.nf, tcfg.gc]}
    ok = (finite and all(files.values()) and row["validations"] == TRAIN_STEPS // 8
          and row["random_vgg_warning"] and bn_moved
          and (tcfg.nb, tcfg.nf, tcfg.gc) == (23, NF, GC))
    row["ok"] = bool(ok)
    emit(row)
    if not ok:
        failures.append(f"gan-train: {row}")

    # resume from step 8: the same batches, noise and arithmetic must follow
    kept = {n: os.path.join(workdir, f"latest_{n}_uninterrupted.pth") for n in "GD"}
    for n in "GD":
        shutil.copy(latest[n], kept[n])
    opt["path"]["resume_state"] = os.path.join(exp, "training_state", "8.state.npz")
    with open(opt_path, "w") as f:
        json.dump(opt, f, indent=1)
    train_cli.main(["-opt", opt_path, "--device", "cuda"])
    torch.cuda.synchronize()
    logged2 = {k: _logged_losses(exp, k)[0] for k in GAN_LOG_KEYS}
    text2 = _logged_losses(exp)[1]
    diff = {}
    for n in "GD":
        a, b = torch.load(kept[n]), torch.load(latest[n])
        diff[n] = max((a[k].double() - b[k].double()).abs().max().item() for k in a)
    row = {"phase": "gan-train-resume", "resumed": "resumed from" in text2,
           "logged_same_as_uninterrupted": all(
               logged2[k].get(s) == logged[k][s]
               for k in GAN_LOG_KEYS for s in range(10, TRAIN_STEPS + 1, 2)),
           "max_abs_weight_diff_vs_uninterrupted": diff}
    row["ok"] = bool(row["resumed"] and row["logged_same_as_uninterrupted"]
                     and diff["G"] == 0.0 and diff["D"] == 0.0)
    emit(row)
    if not row["ok"]:
        failures.append(f"gan-train-resume: {row}")
    return launches


def _gan_trainer():
    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig
    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig
    from esrganplus_tpu_torch.train import GANTrainConfig, GANTrainer

    return GANTrainer(RRDBNetConfig(), DiscriminatorVGGConfig(),
                      GANTrainConfig(compute_dtype="bfloat16"), device="cuda")


def _fused_trainer():
    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer

    return SRTrainer(RRDBNetConfig(noise_kernel="fused"), SRTrainConfig(compute_dtype="bfloat16"),
                     device="cuda")


def gan_steady(failures):
    """GANTrainer.train_step (srragan, the flagship recipe) on one
    device-resident batch: median ms/step of 10 after 3 warm-up steps (host
    clock around a synchronised step), twice from the same seed; the two
    runs' logged terms must agree bit for bit."""
    import torch

    B, H, W = TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(9)
    batch = (torch.rand((B, H, W, 3), generator=gen, device="cuda"),
             torch.rand((B, 4 * H, 4 * W, 3), generator=gen, device="cuda"))
    runs = []
    for _ in range(2):
        trainer = _gan_trainer()
        state = trainer.init_state(0)
        torch.cuda.reset_peak_memory_stats()
        terms, times = [], []
        for i in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, logs = trainer.train_step(state, batch, 1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            terms.append({k: logs[k].item() for k in GAN_LOG_KEYS})
        runs.append((terms, times[3:]))
    med = float(np.median(runs[0][1] + runs[1][1])) * 1e3
    row = {"phase": "gan-steady", "batch": B, "hr": 4 * H, "dtype": "bfloat16",
           "ms_per_step_runs": [float(np.median(t)) * 1e3 for _, t in runs],
           "median_ms_per_step": med, "crops_per_s": B / med * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "terms_first_step": runs[0][0][0], "terms_last_step": runs[0][0][-1],
           "bit_equal_runs": runs[0][0] == runs[1][0],
           "finite": all(np.isfinite(v) for t in runs[0][0] for v in t.values())}
    row["ok"] = bool(row["finite"] and row["bit_equal_runs"])
    emit(row)
    if not row["ok"]:
        failures.append(f"gan-steady: {row}")
    return med


def train_profile(step_ms, make_trainer=None, phase="train-profile", batch=None):
    """``--profile`` only: ``torch.profiler`` over three steady training steps
    (bf16, batch 16; the PSNR trainer, or the one ``make_trainer`` builds, on
    ``batch`` where given):
    device time per step by kernel family, and the card's
    busy share of an untraced step (``step_ms``, train-steady's median; the
    traced steps themselves are slowed by the profiler). Reports; holds
    nothing."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer
    from esrganplus_tpu_torch.utils.trace import op_family

    B, H, W = TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(9)
    if batch is None:
        batch = (torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, 4 * H, 4 * W, 3), generator=gen, device="cuda"))
    trainer = (make_trainer() if make_trainer is not None else
               SRTrainer(RRDBNetConfig(), SRTrainConfig(compute_dtype="bfloat16"), device="cuda"))
    state = trainer.init_state(0)
    for _ in range(3):
        state, _ = trainer.train_step(state, batch, 1)
    torch.cuda.synchronize()
    steps = 3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = trainer.train_step(state, batch, 1)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    fam = collections.Counter()
    count = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = op_family(e.name)
        fam[name] += e.time_range.elapsed_us() / 1e3 / steps
        count[name] += 1
    busy = sum(fam.values())
    stage = {k: v for k, v in fam.items() if k.startswith("stage_")}  # csrc/stage_ct.cu
    # (in the PSNR step the stage kernels are conv_hr_ct's and conv_hr_ct_bwd's
    # bf16 launches)
    emit({"phase": phase, "steps": steps, "wall_ms_per_step_traced": wall_ms,
          "untraced_ms_per_step": step_ms, "device_ms_per_step": busy,
          "device_busy_share": busy / step_ms, "device_idle_share": 1 - busy / step_ms,
          "device_launches_per_step": sum(count.values()) / steps,
          "by_kernel_ms_per_step": {k: round(v, 4) for k, v in fam.most_common(20)},
          "launches_per_step": {k: count[k] / steps for k, _ in fam.most_common(20)},
          "stage_kernels_ms_per_step": sum(stage.values()),
          "stage_kernels_by_name_ms_per_step": {k: round(v, 4) for k, v in stage.items()},
          "tail_kernels_ms_per_step": {k: fam.get(k, 0.0) for k in TAIL_KERNELS},
          "tail_launches_per_step": {k: count[k] / steps for k in TAIL_KERNELS}})


# ---------------------------------------------------------------------------
# the nESRGAN+ slice: the fused noise mode (rdb_ct / rdb_ct_bwd drawing and
# replaying the noise from a site's seed words) and the 9-tap RDB (rdb_t)
# ---------------------------------------------------------------------------


def _rdb_params(gen, nf=NF, gc=GC):
    """One RDB (flagship widths unless given, conv1x1), HWIO, on the card."""
    import torch

    rnd = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen) * scale).to("cuda")
    p = {f"conv{k}": {"w": rnd(3, 3, nf + (k - 1) * gc, nf if k == 5 else gc,
                               scale=(2.0 / (9 * (nf + (k - 1) * gc))) ** 0.5),
                      "b": rnd(nf if k == 5 else gc, scale=0.1)} for k in range(1, 6)}
    p["conv1x1"] = {"w": rnd(1, 1, nf, gc, scale=(2.0 / nf) ** 0.5)}
    return p


def _interleaved(a, b, iters):
    """CUDA-event times of two calls measured in turns (a, b, b, a): the
    mean of each pair."""
    ta1, tb1 = time_ms(a, iters=iters), time_ms(b, iters=iters)
    tb2, ta2 = time_ms(b, iters=iters), time_ms(a, iters=iters)
    return (ta1 + ta2) / 2, (tb1 + tb2) / 2


def check_noise_kernels(failures):
    """Phase kernels-noise at the training shape (batch 16, 32×32 LR):
    philox.cu's draws against the twin's; rdb_ct's training forward drawing
    its noise in the kernel and rdb_ct_bwd replaying it against their twins
    (fp32 1e-4, bf16 2e-2, detach on and off), two backward calls bit-equal;
    CUDA-event times beside the input mode's (a pre-drawn noise tensor) on
    the same inputs. Every call held to its dtype's design."""
    import torch

    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels.launch import design
    from esrganplus_tpu_torch.kernels.philox import (key_words, philox_bits, philox_bits_cuda,
                                                     philox_normal, philox_normal_cuda)
    from esrganplus_tpu_torch.models.layers import fp32_exact

    B, H, W = TRAIN_SHAPE
    shape = (B, H, W, NF)
    # the kernels read the two seed words through a pointer: the key lives on
    # the card, as a training step's row holds it
    site = key_words(NOISE_SEED, "cuda")
    got = philox_normal_cuda(site, shape)
    torch.cuda.synchronize()
    errs = {dev: (got.cpu() - philox_normal(NOISE_SEED, shape, dev).cpu()).abs().max().item()
            for dev in ("cpu", "cuda")}
    row = {"phase": "kernels-noise", "kernel": "philox_normal", "shape": list(shape),
           "max_abs_err_vs_twin": errs, "tol": PHILOX_TOL,
           "mean": got.mean().item(), "std": got.std().item(),
           "ms": time_ms(lambda: philox_normal_cuda(site, shape)),
           "plain_ms": time_ms(lambda: philox_normal(site, shape, "cuda"), iters=5)}
    row["ok"] = bool(torch.isfinite(got).all() and max(errs.values()) <= PHILOX_TOL)
    emit(row)
    if not row["ok"]:
        failures.append(f"philox_normal_cuda: {row}")
    # the resident sampler's words (a batch's indices and coins; and many)
    for n in (B, 1 << 16):
        bits = philox_bits_cuda(site, n)
        torch.cuda.synchronize()
        row = {"phase": "kernels-noise", "kernel": "philox_bits", "n": n,
               "bit_equal_to_twin": torch.equal(bits, philox_bits(site, n, device="cuda"))
               and torch.equal(bits.cpu(), philox_bits(NOISE_SEED, n)),
               "ms": time_ms(lambda: philox_bits_cuda(site, n)),
               "plain_ms": time_ms(lambda: philox_bits(site, n, device="cuda"), iters=5),
               "bound_ms": n * 16 / PEAK_BYTES * 1e3, "bound_by": "bytes"}
        row["ok"] = bool(row["bit_equal_to_twin"])
        emit(row)
        if not row["ok"]:
            failures.append(f"philox_bits_cuda: {row}")

    gen = torch.Generator().manual_seed(12)
    p = _rdb_params(gen)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        wr = K.prepare_rdb_ct_weights(p, dtype)
        act = lambda: torch.randn(shape, generator=gen).to("cuda", dtype)
        x, noise, g = act(), act(), act()
        kw = dict(seed=site, sigma=NOISE_SIGMA)
        with fp32_exact():
            fwd_k, fwd_design = _design_of(K.rdb_ct, lambda: K._rdb_ct_cuda(x, wr, save=True, **kw))
            torch.cuda.synchronize()
            fwd_p = K._rdb_ct_train_plain(x, wr, **kw)
        row = {"phase": "kernels-noise", "kernel": "rdb_ct", "mode": "fused", "dtype": dname,
               "lr": list(TRAIN_SHAPE), "noise_sigma": NOISE_SIGMA, "tol": TOL[dname],
               "design": fwd_design}
        ok = fwd_design == design(dtype)
        for key, a, b in zip(("out", "cat", "lsv"), fwd_k, fwd_p):
            d, rel = rel_err(a, b)
            differ = (a != b).float().mean().item()
            row[key] = {"max_abs_err": d, "rel_err": rel, "frac_differ": differ}
            ok = ok and bool(torch.isfinite(a.float()).all()) and rel <= TOL[dname] and (
                dname == "float32" or differ <= MAX_DIFFER_BF16)
        input_ms, fused_ms = _interleaved(
            lambda: K._rdb_ct_cuda(x, wr, None, noise, sigma=NOISE_SIGMA, save=True),
            lambda: K._rdb_ct_cuda(x, wr, save=True, **kw), iters=20)
        row.update(ok=bool(ok), fused_ms=fused_ms, input_ms=input_ms,
                   plain_ms=time_ms(lambda: K._rdb_ct_train_plain(x, wr, **kw), iters=5))
        emit(row)
        report[("rdb_ct", dname)] = row
        if not ok:
            failures.append(f"rdb_ct fused forward {dname}: {row}")

        _, cat, lsv = fwd_k
        for detach in (False, True):
            seed = None if detach else site
            with fp32_exact():
                got, bwd_design = _design_of(K.rdb_ct_bwd, lambda: K.rdb_ct_bwd(
                    x, wr, cat, lsv, g, seed=seed, sigma=NOISE_SIGMA))
                again = K.rdb_ct_bwd(x, wr, cat, lsv, g, seed=seed, sigma=NOISE_SIGMA)
                torch.cuda.synchronize()
                want = K.rdb_ct_bwd_plain(x, wr, cat, lsv, g, seed=seed, sigma=NOISE_SIGMA)
            worst, worst_abs, finite = worst_err(got, want)
            bit_equal = all(got[k] is None or torch.equal(got[k], again[k]) for k in got)
            row = {"phase": "kernels-noise", "kernel": "rdb_ct_bwd",
                   "mode": "fused_detach" if detach else "fused", "dtype": dname,
                   "lr": list(TRAIN_SHAPE), "max_abs_err": worst_abs, "rel_err": worst,
                   "tol": BWD_TOL[dname], "bit_equal_second_call": bit_equal,
                   "design": bwd_design}
            row["ok"] = bool(finite and worst <= BWD_TOL[dname] and bit_equal
                             and bwd_design == design(dtype))
            if not detach:
                input_ms, fused_ms = _interleaved(
                    lambda: K.rdb_ct_bwd(x, wr, cat, lsv, g, noise, sigma=NOISE_SIGMA),
                    lambda: K.rdb_ct_bwd(x, wr, cat, lsv, g, seed=site,
                                         sigma=NOISE_SIGMA), iters=10)
                row.update(fused_ms=fused_ms, input_ms=input_ms)
                report[("rdb_ct_bwd", dname)] = row
            emit(row)
            if not row["ok"]:
                failures.append(f"rdb_ct_bwd {row['mode']} {dname}: {row}")
    return report


def train_fused(failures, workdir, input_steady):
    """Phase train-fused: the flagship recipe with ``noise_kernel: "fused"``
    through the CLI (launch counts, resume bit-equal), the steady step twice
    from one seed (bit-equal), and the input mode's steady step measured
    again after it; ms/step and peak memory of the two modes side by side."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        train_path(failures, tmp, "fused")
    fused_ms, fused_peak = train_steady(failures, "fused", "train-fused-steady")
    input_ms, input_peak = train_steady(failures, "input", "train-steady-again")
    emit({"phase": "train-fused-vs-input", "fused_ms_per_step": fused_ms,
          "input_ms_per_step": [input_steady[0], input_ms],
          "fused_peak_memory_bytes": fused_peak,
          "input_peak_memory_bytes": [input_steady[1], input_peak],
          "peak_saved_mib": (input_peak - fused_peak) / 2 ** 20,
          "predicted_peak_saved_mib": 69 * TRAIN_SHAPE[0] * TRAIN_SHAPE[1] * TRAIN_SHAPE[2]
          * NF * 2 / 2 ** 20})
    return fused_ms


def make_rdb_t_case(dtype, B, H, W, gen):
    """rdb_t and rdb_t_bwd on seeded flagship-width tensors: the kernel
    calls, their twins, cuDNN yardsticks (the five-conv chain and autograd
    through it, used nowhere in the port), MACs and the bytes each
    direction must move."""
    import torch
    import torch.nn.functional as F

    from esrganplus_tpu_torch.kernels import rdb_t as R

    p = _rdb_params(gen)
    ws = R.prepare_rdb_t_weights(p, NF, GC, True, dtype)
    act = lambda: torch.randn((B, H, W, NF), generator=gen).to("cuda", dtype)
    x, res, g = act(), act(), act()
    esz = x.element_size()
    nchw = lambda t: t.permute(0, 3, 1, 2).contiguous()
    oihw = lambda w: w.to(dtype).permute(3, 2, 0, 1).contiguous().requires_grad_()
    lrelu = lambda t: F.leaky_relu(t, 0.2)
    xn = nchw(x).requires_grad_()
    cw = [(oihw(p[f"conv{k}"]["w"]), p[f"conv{k}"]["b"].to(dtype).requires_grad_())
          for k in range(1, 6)]
    w11 = oihw(p["conv1x1"]["w"])

    def chain():
        c = lambda t, k: F.conv2d(t, cw[k][0], cw[k][1], padding=1)
        x1 = lrelu(c(xn, 0))
        x2 = lrelu(c(torch.cat([xn, x1], 1), 1)) + F.conv2d(xn, w11)
        x3 = lrelu(c(torch.cat([xn, x1, x2], 1), 2))
        x4 = lrelu(c(torch.cat([xn, x1, x2, x3], 1), 3)) + x2
        return c(torch.cat([xn, x1, x2, x3, x4], 1), 4) * 0.2 + xn

    lib_out = chain()
    gn = nchw(g)
    nw = sum(w.numel() for w in ws[:6])
    return {
        "fwd": (lambda: R.rdb_t(x, *ws), lambda: R.rdb_t_plain(x, *ws),
                lambda: chain().detach()),
        "fold": (lambda: R.rdb_t(x, *ws, res, rrdb_scale=0.2),
                 lambda: R.rdb_t_plain(x, *ws, res, rrdb_scale=0.2)),
        "bwd": (lambda: R.rdb_t_bwd(x, *ws, g), lambda: R.rdb_t_bwd_plain(x, *ws, g),
                lambda: torch.autograd.grad(lib_out, [xn, w11] + [t for c in cw for t in c],
                                            gn, retain_graph=True)),
        "bwd_steps": lambda: R.rdb_t_bwd_mma_steps(x, *ws, g)[0],
        "macs": B * H * W * RDB_MACS,
        "bwd_macs": B * H * W * RDB_T_BWD_MACS,
        # x in, out out; the weights in (the bias in fp32)
        "fwd_bytes": 2 * x.numel() * esz + nw * esz + 4 * ws[6].numel(),
        # x and g in, dx out; the weights in; dW, dW11 and db out in fp32
        "bwd_bytes": 3 * x.numel() * esz + nw * (esz + 4) + 2 * 4 * ws[6].numel(),
    }


def check_rdb_t_kernels(failures):
    """Phase kernels-rdb-t: rdb_t (with and without the RRDB fold) and
    rdb_t_bwd against their twins, fp32 (TF32 off) and bf16, at the odd,
    the inference (B=1, 128²) and the training (B=16, 32²) shapes; at the
    last two CUDA-event times of the kernel, the twin and cuDNN, and the
    bound (the backward's: twice the forward's products, plus the recompute
    of stages 1–4 and the 1×1); in bf16 also the card alone and each of the
    backward's launches. Every call held to its dtype's design, a second
    call to the same bits."""
    import torch

    from esrganplus_tpu_torch.kernels import rdb_t as R
    from esrganplus_tpu_torch.kernels.launch import design
    from esrganplus_tpu_torch.models.layers import fp32_exact

    gen = torch.Generator().manual_seed(13)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for sname, (B, H, W) in SHAPES.items():
            case = make_rdb_t_case(dtype, B, H, W, gen)
            base = {"phase": "kernels-rdb-t", "dtype": dname, "shape": sname, "lr": [B, H, W]}
            with fp32_exact():
                for tag in ("fwd", "fold"):
                    kern, plain = case[tag][:2]
                    got, kind = _design_of(R.rdb_t, kern)
                    bits = torch.equal(kern(), got)
                    torch.cuda.synchronize()
                    ref = plain()
                    d, rel = rel_err(got, ref)
                    differ = (got != ref).float().mean().item()
                    ok = (bool(torch.isfinite(got.float()).all()) and rel <= TOL[dname]
                          and (dname == "float32" or differ <= MAX_DIFFER_BF16)
                          and kind == design(dtype) and bits)
                    row = {**base, "kernel": "rdb_t" if tag == "fwd" else "rdb_t_fold",
                           "design": kind, "repeat_bit_equal": bits,
                           "max_abs_err": d, "rel_err": rel, "tol": TOL[dname],
                           "frac_differ": differ, "ok": ok}
                    if tag == "fwd":
                        row["rel_err_vs_library"] = rel_err(
                            got, case["fwd"][2]().permute(0, 2, 3, 1))[1]
                        if sname != "odd":
                            ops_ms = 2 * case["macs"] / PEAK_FLOPS[dname] * 1e3
                            bytes_ms = case["fwd_bytes"] / PEAK_BYTES * 1e3
                            row.update(ms=time_ms(kern), plain_ms=time_ms(plain, iters=5),
                                       library_ms=time_ms(case["fwd"][2]),
                                       bound_ms=max(ops_ms, bytes_ms),
                                       bound_by="operations" if ops_ms >= bytes_ms else "bytes")
                            if dname == "bfloat16":  # the card alone: the call and cuDNN
                                row.update(device_ms=device_ms(kern),
                                           library_device_ms=device_ms(case["fwd"][2]))
                            report[("rdb_t", sname, dname)] = row
                    emit(row)
                    if not ok:
                        failures.append(f"{row['kernel']} {dname} {sname}: rel err {rel:.3g}, "
                                        f"differ {differ:.3g}")

                kern, plain, lib = case["bwd"]
                # the design of the data and weight gradients, and of the recompute
                (got, kind), recompute = _design_of(
                    R.rdb_t_bwd, lambda: _design_of(R.rdb_t_bwd, kern), "recompute_by_design")
                again = kern()
                torch.cuda.synchronize()
                want = plain()
                names = ("dx", "w1", "w2", "w3", "w4", "w5", "w11", "b")
                worst, worst_abs, finite = worst_err(dict(zip(names, got)),
                                                     dict(zip(names, want)))
                bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
                ok = (finite and worst <= BWD_TOL[dname] and bit_equal
                      and kind == recompute == design(dtype))
                row = {**base, "kernel": "rdb_t_bwd", "design": kind, "recompute_design": recompute,
                       "max_abs_err": worst_abs, "rel_err": worst,
                       "tol": BWD_TOL[dname], "repeat_bit_equal": bit_equal, "ok": bool(ok)}
                if sname != "odd":
                    ops_ms = 2 * case["bwd_macs"] / PEAK_FLOPS[dname] * 1e3
                    bytes_ms = case["bwd_bytes"] / PEAK_BYTES * 1e3
                    row.update(ms=time_ms(kern, iters=10), plain_ms=time_ms(plain, iters=3),
                               library_ms=time_ms(lib, iters=10), bound_ms=max(ops_ms, bytes_ms),
                               bound_by="operations" if ops_ms >= bytes_ms else "bytes")
                    if dname == "bfloat16":  # each launch; the card alone: the call and cuDNN
                        steps = case["bwd_steps"]()
                        row.update(step_ms={k: time_ms(f, iters=10) for k, f in steps.items()},
                                   device_ms=device_ms(kern, iters=10),
                                   library_device_ms=device_ms(lib, iters=10))
                    report[("rdb_t_bwd", sname, dname)] = row
            emit(row)
            if not ok:
                failures.append(f"rdb_t_bwd {dname} {sname}: gradient rel err {worst:.3g}, "
                                f"bit-equal {bit_equal}")
    return report


RDB_T_GATE_CASES = ((32, 64, "odd"), (64, 64, "odd"), (64, 32, "odd"), (32, 64, "train"))


def check_rdb_t_gate(failures, seeds=4):
    """Phase kernels-rdb-t-gate: where bf16 rdb_t_bwd's distance to its twin
    (``rdb_t_bwd_plain``, which recomputes the forward's gates itself) comes
    from. At each (nf, gc, shape) of RDB_T_GATE_CASES, ``seeds`` seeded RDBs,
    every gradient held as max|Δ| / max|ref| (the worst, and which): the
    kernel to the twin (``to_twin``) and to the adjoint's twin
    (``rdb_ct_bwd_plain``) on the kernel's own recomputed buffers
    (``to_own_buffers``); that adjoint twin to the twin on the twin's own
    buffers (``twin_buffers``, the check of the split), on the kernel's
    (``recompute_alone``), on the kernel's with every gate whose sign differs
    from the twin's set to the twin's entry (``gates_fixed``), and on those
    of rdb_ct's fp32 twin, another summation order (``rdb_ct_twin_buffers``).
    ``gate_flips`` per stage 1..4: the gates whose sign differs from the
    twin's, of them those the float64 graph (``rdb_ct_fp64``) signs as the
    kernel does, the gates rdb_ct's twin flips, and the largest |float64
    value| of a flipped gate over its pixel's largest in that stage (the
    margin a near-zero fix must catch); ``x_share_differing``, the share of
    x1..x4 that differ at all. Which remedy of fault F3 could close the
    distance: ``flips_same_inputs`` per stage, the flipped gates whose
    inputs (x and x1..x_{k-1} over the gate pixel's 3×3 window) are
    bit-equal on both sides, so that only the order of stage k's own sum
    differs; ``same_inputs_fixed``, the adjoint's twin on the kernel's
    buffers with only those flips set to the twin's entry;
    ``f64_own_fixed``, the adjoint's twin on the kernel's buffers against
    the same on the twin's, each side's gates within 2⁻¹⁰ of its pixel's
    largest decided by a float64 sum over that side's own inputs
    (``f64_flips_left``: the gates whose sign still differs then).
    Reported, not gated; fails only on a non-finite gradient."""
    import torch

    import torch.nn.functional as F

    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import rdb_t as R
    from esrganplus_tpu_torch.models.layers import fp32_exact

    bf = torch.bfloat16
    names = ("dx", "w1", "w2", "w3", "w4", "w5", "w11", "b")
    lrelu = lambda z: torch.where(z >= 0, z, z * 0.2)

    def dist(got, ref):
        errs = {n: (a.double() - r.double()).abs().max().item()
                / max(r.double().abs().max().item(), 1e-30) for n, a, r in zip(names, got, ref)}
        at = max(errs, key=errs.get)
        return {"worst": errs[at], "at": at}

    rows, finite = [], True
    for nf, gc, sname in RDB_T_GATE_CASES:
        B, H, W = SHAPES[sname]
        # the gate of stage k: its slice of cat (x1, x3) or lsv (l2, l4)
        gates = {1: ("cat", 0), 2: ("lsv", 0), 3: ("cat", 2 * gc), 4: ("lsv", gc)}
        for seed in range(seeds):
            gen = torch.Generator().manual_seed(100 * nf + gc + seed)
            p = _rdb_params(gen, nf, gc)
            ws = R.prepare_rdb_t_weights(p, nf, gc, True, bf)
            wct = K.prepare_rdb_ct_weights(p, bf)
            x, g = (torch.randn((B, H, W, nf), generator=gen).to("cuda", bf) for _ in range(2))

            def adjoint(bufs):  # the adjoint's twin on (cat, lsv), in rdb_t's layout
                r = K.rdb_ct_bwd_plain(x, wct, bufs["cat"], bufs["lsv"], g)
                q = {f"conv{k}": {"w": r[f"w{k}"], "b": r[f"b{k}"]} for k in range(1, 6)}
                q["conv1x1"] = {"w": r["w11"][None, None]}
                return (r["dx"], *R.prepare_rdb_t_weights(q, nf, gc, True, torch.float32))

            with fp32_exact():
                got = R.rdb_t_bwd(x, *ws, g)
                twin = R.rdb_t_bwd_plain(x, *ws, g)
                # the twin's buffers: x1..x4 are the centre taps (4) of its im2col sources
                im, zs, _ = R._forward_plain(x, ws, 0.2)
                xk = lambda k: im[..., 9 * (nf + (k - 1) * gc) + 4 * gc:][..., :gc]
                ref = {"cat": torch.cat([xk(k) for k in range(1, 5)], -1).to(bf),
                       "lsv": torch.cat([lrelu(zs[1]), lrelu(zs[3])], -1).to(bf)}
                own = dict(zip(("cat", "lsv"), R._stages(x, ws, slope=0.2, last=False)[1:]))
                other = dict(zip(("cat", "lsv"), K._rdb_ct_train_plain(x, wct)[1:]))
                exact = dict(zip(("cat", "lsv"), K.rdb_ct_fp64(x, wct)[1:]))
                fixed = {n: t.clone() for n, t in own.items()}
                same_fixed = {n: t.clone() for n, t in own.items()}
                own64, ref64 = ({n: t.clone() for n, t in b.items()} for b in (own, ref))
                flips, same, left = {}, {}, {}

                def z64(bufs, k):  # stage k's z in float64 from one side's own inputs
                    src = torch.cat([x, bufs["cat"][..., :(k - 1) * gc]], -1)
                    return K._conv(K._nchw(src, torch.float64), wct[f"w{k}"],
                                   wct[f"b{k}"]).permute(0, 2, 3, 1)

                for k, (buf, c0) in gates.items():
                    sl = (..., slice(c0, c0 + gc))
                    sign = lambda bufs: bufs[buf][sl] >= 0
                    flip = sign(own) != sign(ref)
                    mag = exact[buf][sl].float().abs()
                    margin = (mag / mag.amax(-1, keepdim=True).clamp_min(1e-30))[flip]
                    flips[k] = [int(flip.sum()), int((flip & (sign(exact) == sign(own))).sum()),
                                int((sign(other) != sign(ref)).sum()),
                                margin.max().item() if margin.numel() else 0.0]
                    fixed[buf][sl] = torch.where(flip, ref[buf][sl], own[buf][sl])
                    # pixels whose 3×3 window of x1..x_{k-1} is bit-equal on both sides
                    differ = (own["cat"][..., :(k - 1) * gc]
                              != ref["cat"][..., :(k - 1) * gc]).any(-1).float()[:, None]
                    window = F.max_pool2d(differ, 3, 1, 1)[:, 0, ..., None] == 0
                    same[k] = int((flip & window).sum())
                    same_fixed[buf][sl] = torch.where(flip & window, ref[buf][sl], own[buf][sl])
                    for bufs, out in ((own, own64), (ref, ref64)):  # the remedy, each side alone
                        z = z64(bufs, k)
                        near = z.abs() <= z.abs().amax(-1, keepdim=True) * 2.0 ** -10
                        out[buf][sl] = torch.where(near, lrelu(z).to(bf), bufs[buf][sl])
                    left[k] = int(((own64[buf][sl] >= 0) != (ref64[buf][sl] >= 0)).sum())
                on_own = adjoint(own)
                torch.cuda.synchronize()
                finite = finite and all(bool(torch.isfinite(t.float()).all()) for t in got)
                rows.append({
                    "nf": nf, "gc": gc, "shape": sname, "seed": seed,
                    "to_twin": dist(got, twin), "to_own_buffers": dist(got, on_own),
                    "twin_buffers": dist(adjoint(ref), twin),
                    "recompute_alone": dist(on_own, twin),
                    "gates_fixed": dist(adjoint(fixed), twin),
                    "rdb_ct_twin_buffers": dist(adjoint(other), twin),
                    "same_inputs_fixed": dist(adjoint(same_fixed), twin),
                    "f64_own_fixed": dist(adjoint(own64), adjoint(ref64)),
                    "gate_flips": flips, "flips_same_inputs": same, "f64_flips_left": left,
                    "x_share_differing": (own["cat"] != ref["cat"]).float().mean().item()})
    row = {"phase": "kernels-rdb-t-gate", "kernel": "rdb_t_bwd", "dtype": "bfloat16",
           "tol": BWD_TOL["bfloat16"], "cases": rows, "ok": bool(finite)}
    emit(row)
    if not finite:
        failures.append(f"kernels-rdb-t-gate: a gradient is not finite: {row}")


def rdb_t_path(failures):
    """Phase rdb-t-path, the slice's second path: rdb_t's own API as a user
    calls it. One RRDB's chain of three ``rdb_t_diff`` (fp32 masters in
    rdb_t's layout, bf16 activations, batch 16 of 32×32 at flagship widths)
    forward and backward through autograd, the launch counts set to 0 just
    before and read just after; the loss within 2e-2 and the gradient's
    cosine at least 0.999 against autograd of the fp32 twins."""
    import torch

    from esrganplus_tpu_torch.kernels import rdb_t as R
    from esrganplus_tpu_torch.models.layers import fp32_exact

    gen = torch.Generator().manual_seed(14)
    B, H, W = TRAIN_SHAPE
    masters = [[w.requires_grad_() for w in R.prepare_rdb_t_weights(
        _rdb_params(gen), NF, GC, True, torch.float32)] for _ in range(3)]
    x = torch.randn((B, H, W, NF), generator=gen).cuda().requires_grad_()
    leaves = [x] + [w for ws in masters for w in ws]

    def run(block, dtype):
        with fp32_exact():
            h = x.to(dtype)
            for ws in masters:
                h = block(h, ws)
            out = h.float() * 0.2 + x
            loss = torch.sin(out).mean()
            return loss.item(), torch.autograd.grad(loss, leaves)

    R.reset_design_counts()
    loss_k, g_k = run(lambda h, ws: R.rdb_t_diff(h, *ws), torch.bfloat16)
    torch.cuda.synchronize()
    launches = {"rdb_t": R.rdb_t.launches, "rdb_t_bwd": R.rdb_t_bwd.launches}
    # every launch (forward, the backward's recompute, dx and dW) on "mma"
    by_design = {"rdb_t": dict(R.rdb_t.launches_by_design),
                 "rdb_t_bwd": dict(R.rdb_t_bwd.launches_by_design),
                 "rdb_t_bwd_recompute": dict(R.rdb_t_bwd.recompute_by_design)}
    loss_p, g_p = run(lambda h, ws: R.rdb_t_plain(h, *ws), torch.float32)
    flat = lambda gs: torch.cat([t.flatten() for t in gs])
    cos = torch.nn.functional.cosine_similarity(flat(g_k), flat(g_p), dim=0).item()
    row = {"phase": "rdb-t-path", "lr": list(TRAIN_SHAPE), "dtype": "bfloat16", "blocks": 3,
           "loss_kernel": loss_k, "loss_plain_fp32": loss_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p), "grad_cosine": cos,
           "launches": launches, "by_design": by_design, "tol_loss": 2e-2, "tol_cosine": 0.999,
           "finite": all(bool(torch.isfinite(t).all()) for t in g_k)}
    row["ok"] = bool(row["finite"] and row["loss_rel_err"] <= 2e-2 and cos >= 0.999
                     and launches == {"rdb_t": 3, "rdb_t_bwd": 3}
                     and all(d == {"fma": 0, "mma": 3} for d in by_design.values()))
    emit(row)
    if not row["ok"]:
        failures.append(f"rdb-t-path: {row}")
    return launches


# ---------------------------------------------------------------------------
# the workbench slice: the implicit-GEMM conv3x3 and the one-launch fused RDB
# rdb_fused, public API on no model path
# ---------------------------------------------------------------------------

WB_REPLACES = {"conv3x3": "esrganplus_tpu/kernels/workbench/conv.py:69",
               "rdb_fused": "esrganplus_tpu/kernels/workbench/rdb.py:154"}
WB_SOURCES = {"conv3x3": "esrganplus_tpu_torch/csrc/workbench_conv.cu",
              "rdb_fused": "esrganplus_tpu_torch/csrc/workbench_rdb.cu"}
WB_ODD = (2, 16, 24)  # B, H, W of conv3x3's odd cases (tile 8)
WB_CONV_ODD = {"5_7": (5, 7, None), "8_24": (8, 24, 0.2)}  # cin, cout, act_slope
# the by-source widths: a gc-wide stage, the widest tail source, and x's
# contributions to every target with the 1×1 (the by-source stage 1)
WB_CONV_FLAG = {"64_32": (64, 32, 0.2), "192_64": (192, 64, 0.2), "64_224": (64, 224, None)}
WB_RDB_ODD = (2, 32, 48, 16, 8)  # B, H, W, nf, gc of rdb_fused's odd cases (tile 16)
WB_FLAG_SHAPES = ("bench", "train")
WB_MAIN = {"conv3x3": ("64_224", "bench"), "rdb_fused": ("flagship", "bench")}
WB_PATH_TOL = 5e-2  # bf16 rdb_fused chain against the rdb_ct chain, of max|ref|
# rdb_fused's bf16 cases past nf 64, gc 32 (B, H, W; (nf, gc) each)
WB_RDB_WIDE = ((1, 32, 48), ((128, 64), (72, 40), (256, 32)))


def _alt_tile(nf, gc):
    """The tensor-core rdb_fused tile held bit-equal beside the one a call
    at these widths runs: the next that takes them, None if none does."""
    from esrganplus_tpu_torch.kernels.workbench import rdb as WR

    tiles = WR.mma_tiles(nf, gc)
    return tiles[1] if len(tiles) > 1 else None


def device_ms(fn, iters=20):
    """The card's time for one ``fn()`` call without the host's: CUDA events
    around ``iters`` calls queued behind a spin kernel (``torch.cuda._sleep``)
    that outlasts their launches, so the card runs them back to back. None
    if the spin ended before the host had queued them all (then the events
    would time the host too)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_ms + 2) * 2e6))  # cycles: >= 2 host_ms + 2 ms at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    hidden = not start.query()  # the spin still ran when the last call was queued
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters if hidden else None


def _device_times(row, case):
    """A flagship bf16 row's device times (:func:`device_ms`): the wrapper
    call, the kernel's launch alone and the cuDNN call."""
    row.update(device_ms=device_ms(case["kern"]), launch_device_ms=device_ms(case["launch"]),
               library_device_ms=device_ms(case["lib"]))


def _held(row, got, ref, dname):
    """Fill a row's error fields and ``ok`` from a kernel output and its twin's."""
    import torch

    d, rel = rel_err(got, ref)
    differ = (got != ref).float().mean().item()
    row.update(max_abs_err=d, rel_err=rel, tol=TOL[dname], frac_differ=differ,
               ok=bool(torch.isfinite(got.float()).all()) and rel <= TOL[dname]
               and (dname == "float32" or differ <= MAX_DIFFER_BF16))
    return row


def _design_held(row, want, got, call):
    """Gate a workbench row on the design its launch took; a bf16 row also
    on a second call giving the same bits."""
    import torch

    row["ok"] = row["ok"] and row["design"] == want
    if got.dtype == torch.bfloat16:
        row["repeat_bit_equal"] = bool(torch.equal(call(), got))
        row["ok"] = row["ok"] and row["repeat_bit_equal"]


def _bound(row, macs, nbytes, dname):
    ops_ms = 2 * macs / PEAK_FLOPS[dname] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    row.update(bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def _wb_conv_case(gen, dtype, B, H, W, cin, cout, slope):
    """conv3x3, its twin and the cuDNN yardstick (F.conv2d + activation on
    the same values in channels-last, never called by the port)."""
    import torch
    import torch.nn.functional as F

    from esrganplus_tpu_torch.kernels.workbench import conv as WC

    x = torch.randn((B, H, W, cin), generator=gen).to("cuda", dtype)
    w = (torch.randn((3, 3, cin, cout), generator=gen) * (2.0 / (9 * cin)) ** 0.5).cuda()
    b = (torch.randn(cout, generator=gen) * 0.1).cuda()
    xl = x.permute(0, 3, 1, 2)
    wl = w.to(dtype).permute(3, 2, 0, 1).contiguous()
    bl = b.to(dtype)

    def lib():
        y = F.conv2d(xl, wl, bl, padding=1)
        return y if slope is None else F.leaky_relu(y, slope)

    # the kernel's launch alone: the C entry on the operands the wrapper
    # hands it (weights cast, the bias rounded), the output allocated once
    from esrganplus_tpu_torch.kernels import build
    from esrganplus_tpu_torch.kernels.stage_ct import DESIGNS

    wc, bias = (t.contiguous() for t in WC._cast(x, w, b))
    out = torch.empty((B, H, W, cout), dtype=dtype, device="cuda")
    args = (DESIGNS[WC.conv_design(dtype)], build.dtype_code(x), x.data_ptr(), wc.data_ptr(),
            bias.data_ptr(), out.data_ptr(), B, H, W, cin, cout, int(slope is not None),
            0.0 if slope is None else slope, torch.cuda.current_stream().cuda_stream)
    entry = build.load("workbench_conv").esr_wb_conv3x3
    build.check(entry(*args), "esr_wb_conv3x3")

    esz = x.element_size()
    return {"kern": lambda: WC.conv3x3(x, w, b, act_slope=slope),
            "plain": lambda: WC.conv3x3_plain(x, w, b, act_slope=slope),
            "launch": lambda: entry(*args),
            "lib": lib, "macs": B * H * W * 9 * cin * cout,
            "bytes": (x.numel() + B * H * W * cout + w.numel()) * esz + 4 * cout}


def _wb_rdb_case(gen, xdt, wdt, B, H, W, nf, gc, conv1x1):
    """rdb_fused on seeded weights, its twin, the cuDNN five-conv literal RDB
    and rdb_ct on the same params (flagship widths only)."""
    import torch
    import torch.nn.functional as F

    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels.workbench import rdb as WR

    rnd = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen) * scale).to("cuda")
    p = {f"conv{k}": {"w": rnd(3, 3, nf + (k - 1) * gc, nf if k == 5 else gc,
                               scale=(2.0 / (9 * (nf + (k - 1) * gc))) ** 0.5),
                      "b": rnd(nf if k == 5 else gc, scale=0.1)} for k in range(1, 6)}
    if conv1x1:
        p["conv1x1"] = {"w": rnd(1, 1, nf, gc, scale=(2.0 / nf) ** 0.5)}
    ws = WR.prepare_rdb_weights(p, nf, gc, conv1x1, wdt)
    x = torch.randn((B, H, W, nf), generator=gen).to("cuda", xdt)
    kw = dict(nf=nf, gc=gc, conv1x1=conv1x1, tile=16 if H % 16 == 0 == W % 16 else 8)
    # the kernel's launch alone: the C entry at the design's tile, the output
    # allocated once
    from esrganplus_tpu_torch.kernels import build
    from esrganplus_tpu_torch.kernels.stage_ct import DESIGNS

    design = WR.rdb_design(xdt, wdt)
    th, tw = WR.kernel_tile(design, nf=nf, gc=gc)
    alt = _alt_tile(nf, gc) if design == "mma" else None
    out = torch.empty_like(x)
    args = (DESIGNS[design], build.dtype_code(x), build.dtype_code(ws[0]), x.data_ptr(),
            *(w.data_ptr() for w in ws), out.data_ptr(), B, H, W, nf, gc, int(conv1x1), 0.2, 0.2,
            th, tw, torch.cuda.current_stream().cuda_stream)
    entry = build.load("workbench_rdb").esr_wb_rdb_fused
    build.check(entry(*args), "esr_wb_rdb_fused")
    case = {"x": x, "ws": ws, "kern": lambda: WR.rdb_fused(x, *ws, **kw),
            "launch": lambda: entry(*args),
            "plain": lambda: WR.rdb_fused_plain(x, *ws, **kw),
            # the tensor-core kernel at its next tile
            "ktile": (th, tw), "ktile_alt": alt,
            "alt": lambda: WR._rdb_fused_cuda(x, ws[:5], ws[5], nf=nf, gc=gc, conv1x1=conv1x1,
                                              slope=0.2, res_scale=0.2, ktile=alt),
            "macs": B * H * W * RDB_MACS,
            "bytes": 2 * x.numel() * x.element_size()
            + sum(w.numel() * w.element_size() for w in ws)}
    if xdt == wdt and (nf, gc) == (NF, GC):
        oihw = lambda w: w.to(xdt).permute(3, 2, 0, 1).contiguous()
        cw = [(oihw(p[f"conv{k}"]["w"]), p[f"conv{k}"]["b"].to(xdt)) for k in range(1, 6)]
        w11 = oihw(p["conv1x1"]["w"])
        xl = x.permute(0, 3, 1, 2)
        lrelu = lambda t: F.leaky_relu(t, 0.2)

        def lib():
            c = lambda t, k: F.conv2d(t, cw[k][0], cw[k][1], padding=1)
            x1 = lrelu(c(xl, 0))
            x2 = lrelu(c(torch.cat([xl, x1], 1), 1)) + F.conv2d(xl, w11)
            x3 = lrelu(c(torch.cat([xl, x1, x2], 1), 2))
            x4 = lrelu(c(torch.cat([xl, x1, x2, x3], 1), 3)) + x2
            return c(torch.cat([xl, x1, x2, x3, x4], 1), 4) * 0.2 + xl

        wr = K.prepare_rdb_ct_weights(p, xdt)
        case.update(lib=lib, rdb_ct=lambda: K.rdb_ct(x, wr))
    return case


def check_workbench_kernels(failures):
    """Phase kernels-workbench: conv3x3 and rdb_fused against their twins,
    fp32 (TF32 off) and bf16, at odd cases (conv 5→7 and 8→24 at B=2,
    16×24, tile 8; rdb_fused nf=16, gc=8 at B=2, 32×48, tile 16, the 1×1 on
    and off, fp32 activations with bf16 weights) and at flagship widths (conv 64→32, 192→64, 64→224; rdb_fused nf=64, gc=32
    with the 1×1) at B=1, 128² and B=16, 32², there with CUDA-event times of
    the kernel, the twin and the cuDNN yardstick, the bound, and rdb_ct on the
    same RDB params timed in turns with rdb_fused; in bf16 the device times
    of the wrapper call, the launch and cuDNN, and rdb_fused at its next
    tensor-core tile, which must give the same bits."""
    import torch

    from esrganplus_tpu_torch.kernels.workbench import conv as WC
    from esrganplus_tpu_torch.kernels.workbench import rdb as WR
    from esrganplus_tpu_torch.models.layers import fp32_exact

    gen = torch.Generator().manual_seed(16)
    report = {}
    WC.reset_launch_counts()
    with fp32_exact():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            cases = [(c, "odd", WB_ODD, WB_CONV_ODD[c]) for c in WB_CONV_ODD] + [
                (c, sname, SHAPES[sname], WB_CONV_FLAG[c])
                for sname in WB_FLAG_SHAPES for c in WB_CONV_FLAG]
            for cname, sname, (B, H, W), (cin, cout, slope) in cases:
                case = _wb_conv_case(gen, dtype, B, H, W, cin, cout, slope)
                got, design = _design_of(WC.conv3x3, case["kern"])
                torch.cuda.synchronize()
                row = _held({"phase": "kernels-workbench", "kernel": "conv3x3", "dtype": dname,
                             "conv": cname, "shape": sname, "x": [B, H, W, cin],
                             "cout": cout, "act_slope": slope, "design": design},
                            got, case["plain"](), dname)
                _design_held(row, WC.conv_design(dtype), got, case["kern"])
                if sname != "odd":
                    row.update(ms=time_ms(case["kern"]), launch_ms=time_ms(case["launch"]),
                               plain_ms=time_ms(case["plain"], iters=5),
                               library_ms=time_ms(case["lib"]))
                    if dtype == torch.bfloat16:
                        _device_times(row, case)
                    _bound(row, case["macs"], case["bytes"], dname)
                    report[("conv3x3", cname, sname, dname)] = row
                emit(row)
                if not row["ok"]:
                    failures.append(f"conv3x3 {cname} {sname} {dname}: {row}")
        conv_launches = dict(WC.conv3x3.launches_by_design)

        B, H, W, nf, gc = WB_RDB_ODD
        cases = [("odd", (B, H, W), xdt, wdt, nf, gc, c11)
                 for xdt, wdt in ((torch.float32, torch.float32),
                                  (torch.bfloat16, torch.bfloat16),
                                  (torch.float32, torch.bfloat16))
                 for c11 in (True, False)]
        cases += [(sname, SHAPES[sname], dt, dt, NF, GC, True)
                  for dt in (torch.float32, torch.bfloat16) for sname in WB_FLAG_SHAPES]
        for sname, (B, H, W), xdt, wdt, nf, gc, c11 in cases:
            dname = str(xdt).split(".")[1]
            case = _wb_rdb_case(gen, xdt, wdt, B, H, W, nf, gc, c11)
            got, design = _design_of(WR.rdb_fused, case["kern"])
            torch.cuda.synchronize()
            row = _held({"phase": "kernels-workbench", "kernel": "rdb_fused", "dtype": dname,
                         "weights": str(wdt).split(".")[1], "shape": sname,
                         "lr": [B, H, W], "nf": nf, "gc": gc, "conv1x1": c11,
                         "design": design}, got, case["plain"](), dname)
            _design_held(row, WR.rdb_design(xdt, wdt), got, case["kern"])
            if xdt == wdt == torch.bfloat16:  # bit-equal: no per-pixel sum depends on the tile
                d_alt = rel_err(case["alt"](), got)[1]
                row.update(ktile=list(case["ktile"]), ktile_alt=list(case["ktile_alt"]),
                           rel_err_ktile_alt_vs_ktile=d_alt)
                row["ok"] = row["ok"] and d_alt == 0
            if sname != "odd":
                if xdt == torch.bfloat16:
                    row["ms_ktile_alt"] = time_ms(case["alt"], iters=10)
                    _device_times(row, case)
                rdb_ct_ms, fused_ms = _interleaved(case["rdb_ct"], case["kern"], iters=10)
                row.update(ms=fused_ms, launch_ms=time_ms(case["launch"], iters=10),
                           rdb_ct_ms=rdb_ct_ms,
                           plain_ms=time_ms(case["plain"], iters=3),
                           library_ms=time_ms(case["lib"], iters=10),
                           rel_err_vs_library=rel_err(got, case["lib"]().permute(0, 2, 3, 1))[1])
                _bound(row, case["macs"], case["bytes"], dname)
                report[("rdb_fused", "flagship", sname, dname)] = row
            emit(row)
            if not row["ok"]:
                failures.append(f"rdb_fused {sname} {dname} w {row['weights']} "
                                f"conv1x1 {c11}: {row}")
    return report, conv_launches


def check_workbench_wide(failures):
    """Phase kernels-workbench-wide: bf16 rdb_fused at widths past one pass
    of columns and one K chunk a tap, on the tensor cores at the largest tile
    that fits. The twin's fp32 sums round differently from exact ones in up to
    2.4 % of outputs at nf=128, gc=64 (tools/wb_rdb_variants.py), so the
    share of outputs is held against the fp64-summed reference
    (``rdb_fused_fp64``): no more than the twin's own share plus
    MAX_DIFFER_BF16; the max error against the twin within its bar."""
    import torch

    from esrganplus_tpu_torch.kernels.workbench import rdb as WR
    from esrganplus_tpu_torch.models.layers import fp32_exact

    gen = torch.Generator().manual_seed(18)
    (B, H, W), widths = WB_RDB_WIDE
    bf16 = torch.bfloat16
    for nf, gc in widths:
        case = _wb_rdb_case(gen, bf16, bf16, B, H, W, nf, gc, True)
        got, design = _design_of(WR.rdb_fused, case["kern"])
        with fp32_exact():
            twin = case["plain"]()
            exact = WR.rdb_fused_fp64(case["x"], *case["ws"], nf=nf, gc=gc)
        torch.cuda.synchronize()
        d, rel = rel_err(got, twin)
        share = lambda a, b: (a != b).float().mean().item()
        fits = WR.mma_tiles(nf, gc)
        tiles_equal = all(torch.equal(WR._rdb_fused_cuda(
            case["x"], case["ws"][:5], case["ws"][5], nf=nf, gc=gc, conv1x1=True, slope=0.2,
            res_scale=0.2, ktile=t), got) for t in fits)
        row = {"phase": "kernels-workbench-wide", "kernel": "rdb_fused", "dtype": "bfloat16",
               "lr": [B, H, W], "nf": nf, "gc": gc, "design": design,
               "ktile": list(WR.mma_tile(nf, gc)), "tiles_fit": [list(t) for t in fits],
               "max_abs_err": d, "rel_err": rel, "tol": TOL["bfloat16"],
               "frac_differ": share(got, twin), "frac_differ_fp64": share(got, exact),
               "twin_frac_differ_fp64": share(twin, exact), "tiles_bit_equal": tiles_equal}
        row["ok"] = bool(torch.isfinite(got.float()).all() and rel <= TOL["bfloat16"]
                         and row["frac_differ_fp64"]
                         <= row["twin_frac_differ_fp64"] + MAX_DIFFER_BF16
                         and design == "mma" and tiles_equal)
        _design_held(row, "mma", got, case["kern"])
        emit(row)
        if not row["ok"]:
            failures.append(f"rdb_fused wide {nf}/{gc}: {row}")


def workbench_path(failures):
    """Phase workbench-path, the slice's path: the workbench kernels through
    their public API as a user calls them. The flagship trunk's 23 RRDBs at
    full width (nf=64, gc=32, conv1x1) on seeded weights, B=1, 128², bf16:
    69 ``rdb_fused`` calls with each RRDB's ``·0.2 + x`` in torch between
    them, against the port's rdb_ct kernel path on the same params (within
    5e-2 of max|ref|); and ``conv3x3`` computing the first RDB's by-source
    stage 1 (x's 64→224 contributions, the 1×1 included) against its twin.
    The launch counts are set to 0 just before and read just after; the
    total ms of both chains are taken in turns."""
    import torch

    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels.workbench import conv as WC
    from esrganplus_tpu_torch.kernels.workbench import rdb as WR

    gen = torch.Generator().manual_seed(17)
    B, H, W = SHAPES["bench"]
    bf16 = torch.bfloat16
    params = [[_rdb_params(gen) for _ in range(3)] for _ in range(23)]
    fused_w = [[WR.prepare_rdb_weights(p, NF, GC, True, bf16) for p in rrdb] for rrdb in params]
    ct_w = [[K.prepare_rdb_ct_weights(p, bf16) for p in rrdb] for rrdb in params]
    x = torch.randn((B, H, W, NF), generator=gen).to("cuda", bf16)
    # the first RDB's w0 as an HWIO conv: x's contributions to every target
    w0 = fused_w[0][0][0]
    w0_hwio = w0.reshape(3, 3, NF, w0.shape[2]).permute(1, 0, 2, 3).contiguous()

    def fused_chain():
        h0 = x
        for rrdb in fused_w:
            h = h0
            for ws in rrdb:
                h = WR.rdb_fused(h, *ws, nf=NF, gc=GC)
            h0 = (h.float() * 0.2 + h0.float()).to(bf16)
        return h0

    def ct_chain():
        h0 = x
        for ws in ct_w:
            h = K.rdb_ct(K.rdb_ct(h0, ws[0]), ws[1])
            h0 = K.rdb_ct(h, ws[2], h0, rrdb_scale=0.2)
        return h0

    WR.reset_launch_counts()
    WC.reset_launch_counts()
    out = fused_chain()
    contrib = WC.conv3x3(x, w0_hwio)
    torch.cuda.synchronize()
    launches = {"rdb_fused": WR.rdb_fused.launches, "conv3x3": WC.conv3x3.launches}
    by_design = {"rdb_fused": dict(WR.rdb_fused.launches_by_design),
                 "conv3x3": dict(WC.conv3x3.launches_by_design)}
    ref = ct_chain()
    d, _ = rel_err(out, ref)
    rel = d / ref.float().abs().max().item()
    c_rel = rel_err(contrib, WC.conv3x3_plain(x, w0_hwio))[1]
    fused_ms, ct_ms = _interleaved(fused_chain, ct_chain, iters=3)
    row = {"phase": "workbench-path", "lr": [B, H, W], "dtype": "bfloat16", "rrdbs": 23,
           "launches": launches, "launches_by_design": by_design,
           "max_abs_err_vs_rdb_ct": d, "rel_err_vs_rdb_ct": rel,
           "tol": WB_PATH_TOL, "max_abs_out": ref.float().abs().max().item(),
           "conv3x3_rel_err": c_rel, "fused_chain_ms": fused_ms, "rdb_ct_chain_ms": ct_ms,
           "finite": bool(torch.isfinite(out.float()).all())}
    row["ok"] = bool(row["finite"] and rel <= WB_PATH_TOL and c_rel <= TOL["bfloat16"]
                     and launches == {"rdb_fused": 69, "conv3x3": 1}
                     and by_design == {"rdb_fused": {"fma": 0, "mma": 69},
                                       "conv3x3": {"fma": 0, "mma": 1}})
    emit(row)
    if not row["ok"]:
        failures.append(f"workbench-path: {row}")
    return launches


def workbench_rows(report, conv_launches, launches):
    """The kernels line's rows 15 and 16: the main case's bf16 numbers in the
    required keys, every flagship case beside them."""
    fields = ("ms", "launch_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
              "rel_err")
    rows = []
    for name in WB_REPLACES:
        case, sname = WB_MAIN[name]
        row = report[(name, case, sname, "bfloat16")]
        extra = ("device_ms", "launch_device_ms", "library_device_ms") + (
            ("rdb_ct_ms", "ms_ktile_alt") if name == "rdb_fused" else ())
        fp32 = report[(name, case, sname, "float32")]
        rows.append({
            "name": name, "route": "cuda", "source": WB_SOURCES[name],
            "replaces": WB_REPLACES[name], "launches": launches[name],
            **{f: row[f] for f in fields + extra}, "dtype": "bfloat16", "case": case,
            "shape": sname, "design": row["design"], "frac_differ": row["frac_differ"],
            "fp32_design": fp32["design"], "fp32_ms": fp32["ms"],
            "fp32_rel_err": fp32["rel_err"],
            **({"kernels_workbench_launches": conv_launches} if name == "conv3x3" else {}),
            "cases": {f"{c}@{s}": {**{f: r[f] for f in fields + extra + ("frac_differ",)},
                                   "fp32_ms": report[(n, c, s, "float32")]["ms"]}
                      for (n, c, s, dn), r in report.items()
                      if n == name and dn == "bfloat16"}})
    return rows


# ---------------------------------------------------------------------------
# the fourteenth slice: the shipped training recipes as shipped — SRResNet,
# the device-resident crop store with steps_per_dispatch, --profile with its
# trace summary (resume from a JAX-written state is a CPU test)
# ---------------------------------------------------------------------------

SHIPPED = os.path.join(HERE, "esrganplus_tpu", "options")  # the recipes (JSON), read as data
SRRESNET_GOLDEN = os.path.join(HERE, "tests", "golden", "srresnet_small_x4")
RESIDENT_CROPS = 4096  # the shipped recipes' resident_crops
DISPATCH = 4  # steps_per_dispatch of the resident runs (bursts of 4 graph replays)
PRINT_FREQ = 4  # the resident runs log every PRINT_FREQ steps
RDB_FAMILIES = ("dense_mma_kernel", "dgrad_mma_kernel", "wgrad_mma_kernel")
PROFILE_STEPS = 4  # one burst of DISPATCH replays inside train-profile-cli's trace
BURST_KS = (1, 8)  # the burst lengths train-burst times
BURST_STEPS = 16  # steps behind each of its host times
BURST_PROFILED = 8  # graph steps behind each of its device times
EAGER_PROFILED = 2  # eager steps behind a device time or a trace (the host's ops make it long)
GRAPH_CALLS = 2  # wrapper calls a capture makes per launch a step: its warm-up, its recording


def _zero_counts():
    """Set every counted wrapper's launches, designs and device launches to 0."""
    from esrganplus_tpu_torch.kernels import launch as L
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import stage_ct as S
    from esrganplus_tpu_torch.kernels import tail_ct as T

    from esrganplus_tpu_torch.kernels import philox as X

    for fn in _twelve() + (X.philox_bits_cuda, X.philox_normal_cuda):
        fn.launches = 0
    S.reset_launch_counts()
    T.reset_design_counts()
    K.reset_design_counts()
    K.rdb_ct.device_launches = 0
    K.rdb_ct.seeded_launches = K.rdb_ct_bwd.seeded_launches = 0
    L.device_launches.clear()


def _shipped_options(workdir, recipe, name, dirs, niter, freqs, **train):
    """A shipped recipe (``options/train/<recipe>``) with only its dataroots,
    ``niter``, its cadences (``freqs``: print, val, save) and ``train``
    changed."""
    from esrganplus_tpu_torch.options.options import _strip_comments

    with open(os.path.join(SHIPPED, "train", recipe)) as f:
        opt = json.loads(_strip_comments(f.read()))
    opt.update(name=name, use_tb_logger=False)
    opt["path"]["root"] = workdir
    ds = opt["datasets"]
    ds["train"].update(dataroot_HR=dirs["HR"], dataroot_LR=dirs["LR"])
    ds["val"].update(dataroot_HR=dirs["valHR"], dataroot_LR=dirs["valLR"])
    opt["logger"]["print_freq"] = freqs[0]
    opt["train"].update(niter=niter, val_freq=freqs[1], save_checkpoint_freq=freqs[2], **train)
    return opt


def _run_train_cli(workdir, opt, argv=()):
    """Write ``opt``, run the train CLI on the card → (seconds, exp dir)."""
    import torch

    from esrganplus_tpu_torch.cli import train as train_cli

    path = os.path.join(workdir, opt["name"] + ".json")
    with open(path, "w") as f:
        json.dump(opt, f, indent=1)
    t0 = time.perf_counter()
    train_cli.main(["-opt", path, "--device", "cuda", *argv])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, os.path.join(workdir, "experiments", opt["name"])


def _pool_bytes(text):
    m = re.search(r"resident crop store: (\d+) pairs on \S+ \(([\d,]+) bytes\)", text)
    return (int(m.group(1)), int(m.group(2).replace(",", ""))) if m else (None, None)


def _resume_row(failures, phase, workdir, opt, exp, losses, keys=("l_pix",)):
    """Resume ``opt``'s run from step 8: its logged terms after step 8 and
    its ``latest_*.pth`` must equal the uninterrupted run's."""
    import shutil

    import torch

    nets = [n for n in "GD" if os.path.exists(os.path.join(exp, "models", f"latest_{n}.pth"))]
    kept = {}
    for n in nets:
        kept[n] = os.path.join(workdir, f"{opt['name']}_latest_{n}.pth")
        shutil.copy(os.path.join(exp, "models", f"latest_{n}.pth"), kept[n])
    opt = dict(opt, path=dict(opt["path"], resume_state=os.path.join(
        exp, "training_state", "8.state.npz")))
    _run_train_cli(workdir, opt)
    after = {k: _logged_losses(exp, k)[0] for k in keys}
    text = _logged_losses(exp)[1]
    diff = {}
    for n in nets:
        a, b = torch.load(kept[n]), torch.load(os.path.join(exp, "models", f"latest_{n}.pth"))
        diff[n] = max((a[k].double() - b[k].double()).abs().max().item() for k in a)
    later = [s for s in losses[keys[0]] if s > 8]
    row = {"phase": phase + "-resume", "resumed": "resumed from" in text,
           "logged_same_as_uninterrupted": bool(later) and all(
               after[k].get(s) == losses[k][s] for k in keys for s in later),
           "max_abs_weight_diff_vs_uninterrupted": diff}
    row["ok"] = bool(row["resumed"] and row["logged_same_as_uninterrupted"]
                     and all(d == 0.0 for d in diff.values()))
    emit(row)
    if not row["ok"]:
        failures.append(f"{phase}-resume: {row}")


def _host_ms(fn, iters, warmup=2):
    """Median host-clock ms of ``fn()`` followed by a synchronise."""
    import torch

    times = []
    for i in range(warmup + iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def srresnet_path(failures, workdir):
    """Phase srresnet (see the module docstring). SRResNet runs no kernel of
    the port: every counter must stay 0."""
    import contextlib
    import io

    import cv2
    import torch

    from esrganplus_tpu_torch.cli import test as test_cli
    from esrganplus_tpu_torch.cli import test_image
    from esrganplus_tpu_torch.convert import generator_to_state_dict
    from esrganplus_tpu_torch.infer import SRInferencer, load_generator
    from esrganplus_tpu_torch.models import SRResNetConfig, generator_forward, generator_init
    from esrganplus_tpu_torch.models.layers import fp32_exact
    from esrganplus_tpu_torch.options.options import _strip_comments
    from esrganplus_tpu_torch.ops.image_io import read_img, save_img, tensor2img

    _zero_counts()
    row = {"phase": "srresnet"}
    # the golden checkpoint against the reference implementation's output
    params, cfg, _ = load_generator(SRRESNET_GOLDEN + ".pth", device="cuda")
    io_ = np.load(SRRESNET_GOLDEN + "_io.npz")
    x = torch.from_numpy(np.ascontiguousarray(io_["x"].transpose(0, 2, 3, 1))).cuda()
    with torch.inference_mode(), fp32_exact():
        y = generator_forward(params, x, cfg).cpu().numpy()
    row["golden_max_abs_err"] = float(np.abs(y - io_["y"].transpose(0, 2, 3, 1)).max())
    row["golden_cfg"] = [type(cfg).__name__, cfg.nb, cfg.nf, cfg.upscale]
    g_in, g_out = os.path.join(workdir, "golden_LR"), os.path.join(workdir, "golden_out")
    save_img(tensor2img(io_["x"][0].transpose(1, 2, 0)), os.path.join(g_in, "golden.png"))
    with contextlib.redirect_stdout(io.StringIO()):
        test_image.main([SRRESNET_GOLDEN + ".pth", "--input", g_in, "--output", g_out,
                         "--device", "cuda"])
    got = cv2.imread(os.path.join(g_out, "golden_rlt.png"), cv2.IMREAD_UNCHANGED)
    want = SRInferencer(params, cfg).upscale_bgr_to_png(read_img(os.path.join(g_in, "golden.png")))
    row["golden_cli_png_equal"] = bool(np.array_equal(got, want))

    # a seeded flagship SRResNet through the CLI, fp32 and bf16
    fcfg = SRResNetConfig()
    fparams = generator_init(0, fcfg, init_scale=0.5)
    ckpt = os.path.join(workdir, "srresnet_flagship.pth")
    torch.save(generator_to_state_dict(fparams, fcfg), ckpt)
    lr_dir = os.path.join(workdir, "LR")
    rng = np.random.RandomState(0)
    for name, (h, w) in INFER_SIZES.items():
        save_img(_smooth_image(rng, h, w), os.path.join(lr_dir, name + ".png"))
    outs = {}
    for dname in ("fp32", "bf16"):
        out_dir = os.path.join(workdir, "out_" + dname)
        with contextlib.redirect_stdout(io.StringIO()):
            test_image.main([ckpt, "--input", lr_dir, "--output", out_dir, "--dtype", dname,
                             "--device", "cuda"])
        outs[dname] = {n: cv2.imread(os.path.join(out_dir, n + "_rlt.png"), cv2.IMREAD_UNCHANGED)
                       for n in INFER_SIZES}
    row["flagship_shapes"] = {n: list(o.shape) for n, o in outs["bf16"].items()}
    row["flagship_bf16_vs_fp32_max_abs"] = max(
        float(np.abs(outs["bf16"][n].astype(np.float64) - outs["fp32"][n]).max()) / 255.0
        for n in INFER_SIZES)
    shapes_ok = all(outs["bf16"][n].shape == (4 * h, 4 * w, 3)
                    for n, (h, w) in INFER_SIZES.items())
    img = read_img(os.path.join(lr_dir, "a_128x128.png"))[:, :, ::-1].copy()
    fdev = load_generator(ckpt, device="cuda")[0]
    for dname, dt in (("fp32", None), ("bf16", torch.bfloat16)):
        inf = SRInferencer(fdev, fcfg, dtype=dt)
        med, _ = _host_ms(lambda: inf.upscale(img), iters=10)
        row[f"{dname}_ms_per_image_128"] = med
        row[f"{dname}_mpix_per_s_out"] = 512 * 512 / 1e6 / (med / 1e3)

    # cli.test with a test_SRResNet.json-shaped options file on the Set5-shaped set
    hr_dir, set_lr = _set5_set(workdir, np.random.RandomState(5))
    with open(os.path.join(SHIPPED, "test", "test_SRResNet.json")) as f:
        topt = json.loads(_strip_comments(f.read()))
    topt["path"].update(root=workdir, pretrain_model_G=ckpt)
    topt["datasets"]["test_1"].update(dataroot_HR=hr_dir, dataroot_LR=set_lr)
    tpath = os.path.join(workdir, "test_SRResNet.json")
    with open(tpath, "w") as f:
        json.dump(topt, f)
    t0 = time.perf_counter()
    test_cli.main(["-opt", tpath, "--device", "cuda"])
    torch.cuda.synchronize()
    row["eval_seconds_per_image"] = (time.perf_counter() - t0) / len(SET5_HR)
    res = os.path.join(workdir, "results", topt["name"], "set5")
    inf = SRInferencer(fdev, fcfg)
    row["eval_png_equal"] = {
        n: bool(np.array_equal(cv2.imread(os.path.join(res, n + ".png"), cv2.IMREAD_UNCHANGED),
                               inf.upscale_bgr_to_png(read_img(os.path.join(set_lr, n + ".png")))))
        for n in SET5_HR}
    row["kernel_launches"] = {fn.__name__: fn.launches for fn in _twelve()}
    row["ok"] = bool(row["golden_max_abs_err"] <= 1e-5 and row["golden_cli_png_equal"]
                     and shapes_ok and row["flagship_bf16_vs_fp32_max_abs"] <= TOL["bfloat16"]
                     and all(row["eval_png_equal"].values())
                     and not any(row["kernel_launches"].values()))
    emit(row)
    if not row["ok"]:
        failures.append(f"srresnet: {row}")


def train_srresnet_path(failures, workdir):
    """Phase train-srresnet (see the module docstring)."""
    from esrganplus_tpu_torch.convert import generator_from_state_dict, load_state_dict
    from esrganplus_tpu_torch.kernels import stage_ct as S
    from esrganplus_tpu_torch.models import SRResNetConfig

    dirs = _smoke_dataset(workdir)
    freqs = (PRINT_FREQ, 8, 8)
    opt = _shipped_options(workdir, "train_SRResNet.json", "srresnet_smoke", dirs, TRAIN_STEPS,
                           freqs, steps_per_dispatch=DISPATCH)
    _zero_counts()
    seconds, exp = _run_train_cli(workdir, opt)
    launches = {fn.__name__: fn.launches for fn in _twelve()}
    losses, text = _logged_losses(exp)
    back, bcfg, _ = generator_from_state_dict(
        load_state_dict(os.path.join(exp, "models", "latest_G.pth")))
    n_pool, pool_bytes = _pool_bytes(text)
    row = {"phase": "train-srresnet", "recipe": "train_SRResNet.json", "steps": TRAIN_STEPS,
           "steps_per_dispatch": DISPATCH, "dtype": opt["train"].get("compute_dtype") or "float32",
           "seconds_total": seconds, "l_pix": losses, "resident_pairs": n_pool,
           "resident_bytes": pool_bytes, "reloaded": [type(bcfg).__name__, bcfg.nb, bcfg.nf],
           "validations": text.count("Validation # PSNR"), "kernel_launches": launches}
    row["ok"] = bool(sorted(losses) == list(range(PRINT_FREQ, TRAIN_STEPS + 1, PRINT_FREQ))
                     and all(np.isfinite(float(v)) for v in losses.values())
                     and isinstance(bcfg, SRResNetConfig) and (bcfg.nb, bcfg.nf) == (16, 64)
                     and n_pool == RESIDENT_CROPS and pool_bytes == RESIDENT_CROPS * 3 * (
                         96 * 96 + 24 * 24)
                     and row["validations"] == TRAIN_STEPS // 8 and not any(launches.values()))
    emit(row)
    if not row["ok"]:
        failures.append(f"train-srresnet: {row}")
    _resume_row(failures, "train-srresnet", workdir, opt, exp, {"l_pix": losses})

    # SRGAN as shipped: fp32, so every stage call runs the FMA design
    steps = 8
    gopt = _shipped_options(workdir, "train_SRGAN.json", "srgan_smoke", dirs, steps, freqs,
                            steps_per_dispatch=DISPATCH)
    _zero_counts()
    seconds, exp = _run_train_cli(workdir, gopt)
    logged = {k: _logged_losses(exp, k)[0] for k in GAN_LOG_KEYS}
    text = _logged_losses(exp)[1]
    dname = gopt["train"].get("compute_dtype") or "float32"
    want_design = "mma" if dname == "bfloat16" else "fma"
    per_step = {**GAN_FWD_PER_STEP, **GAN_BWD_PER_STEP}
    by_design = {fn.__name__: dict(fn.launches_by_design)
                 for fn in (S.conv_s1_ct, S.conv_s1_ct_bwd, S.conv_s2_ct, S.conv_s2_ct_bwd)}
    captures = _captures(text)  # each counted as GRAPH_CALLS steps; a replay runs no wrapper
    designs_ok = captures == 1 and all(
        d == {"fma": 0, "mma": 0, want_design: per_step[k] * GRAPH_CALLS}
        for k, d in by_design.items())
    row = {"phase": "train-srgan", "recipe": "train_SRGAN.json", "steps": steps,
           "dtype": dname, "seconds_total": seconds, "ms_per_step": seconds / steps * 1e3,
           "captures": captures, "logged": logged, "stage_launches_by_design": by_design,
           "stage_design_expected": want_design,
           "random_vgg_warning": "VGG19 weights not provided" in text,
           "resident_pairs": _pool_bytes(text)[0]}
    row["ok"] = bool(designs_ok and all(
        sorted(v) == list(range(PRINT_FREQ, steps + 1, PRINT_FREQ))
        and all(np.isfinite(float(t)) for t in v.values()) for v in logged.values())
        and row["resident_pairs"] == RESIDENT_CROPS)
    emit(row)
    if not row["ok"]:
        failures.append(f"train-srgan: {row}")
    srresnet_steady(dirs)


def srresnet_steady(dirs):
    """The two SRResNet recipes' steps as shipped (fp32) on a store of their
    HR size: median resident ms/step and crops/s (host clock around a
    synchronised step), and the device ms a step by ``torch.profiler`` (three
    steps) with the card's idle share of the host step. Reported, not
    gated."""
    from esrganplus_tpu_torch.models import SRResNetConfig
    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig
    from esrganplus_tpu_torch.train import GANTrainConfig, GANTrainer, SRTrainConfig, SRTrainer

    B = 16
    row = {"phase": "srresnet-steady", "batch": B, "dtype": "float32"}
    for name, hr, make in (
            ("psnr", 96, lambda: SRTrainer(SRResNetConfig(), SRTrainConfig(pixel_criterion="l2"),
                                           device="cuda")),
            ("srgan", 128, lambda: GANTrainer(SRResNetConfig(), DiscriminatorVGGConfig(),
                                              GANTrainConfig(variant="srgan"), device="cuda"))):
        store = _resident_store(dirs, hr)
        trainer = make()
        state = trainer.init_state(0)
        med, times = _host_ms(lambda: trainer.train_step_resident(state, store, 1, B), iters=8)
        dev = _profiled_device_ms(lambda: [trainer.train_step_resident(state, store, 1, B)
                                           for _ in range(3)]) / 3
        row.update({f"{name}_hr": hr, f"{name}_ms_per_step": med,
                    f"{name}_crops_per_s": B / med * 1e3, f"{name}_ms_runs": times,
                    f"{name}_device_ms_per_step": dev, f"{name}_device_idle_share": 1 - dev / med})
        del trainer, state, store
    emit(row)


def _resident_store(dirs, hr_size):
    from esrganplus_tpu_torch.data import create_dataset
    from esrganplus_tpu_torch.data.resident import ResidentCropStore

    ds = create_dataset({"name": "smoke", "mode": "LRHR", "phase": "train", "scale": 4,
                         "dataroot_HR": dirs["HR"], "dataroot_LR": dirs["LR"],
                         "HR_size": hr_size, "use_flip": True, "use_rot": True,
                         "cache_images": True})
    return ResidentCropStore(ds, "cuda", n_crops=RESIDENT_CROPS, refresh_steps=1000, seed=0)


def _states_equal(a, b):
    import torch

    from esrganplus_tpu_torch.train.sr_model import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y for x, y in zip(la, lb))


def _bursts_logged(text):
    """The burst lengths the train CLI logged (``bursts: ...`` lines)."""
    return [int(n) for line in text.splitlines() if "bursts: " in line
            for n in line.split("bursts: ")[1].split()]


def _counted():
    """The counted wrappers' launches (and rdb_ct's seeded ones) by name."""
    from esrganplus_tpu_torch.kernels import philox as X
    from esrganplus_tpu_torch.kernels import rdb_ct as K

    out = {fn.__name__: fn.launches for fn in _twelve() + (X.philox_bits_cuda,
                                                          X.philox_normal_cuda)}
    out.update({f"{fn.__name__}.seeded": fn.seeded_launches for fn in (K.rdb_ct, K.rdb_ct_bwd)})
    return out


def _captures(text):
    """The graphs the train CLI logged it captured (None when it logged none)."""
    m = re.search(r"resident step graphs: (\d+) captured", text)
    return int(m.group(1)) if m else None


def _graph_vs_eager(make, store, batch_size, k, rng=1):
    """A burst of ``k`` replays of the captured resident step against ``k``
    eager steps on the batches the sampler draws, from one init (one
    trainer, two states); then EAGER_PROFILED more of each, traced → dict:
    ``equal`` (the states and the last logs bit-equal), ``finite``; the
    port's kernels by family that the traced replays launch, read from the
    captured graphs (``nodes``), and that the card ran in them and in the
    traced eager steps, by the profiler (``graph``, ``eager``); ``counted``,
    the traced eager steps' launches counted by the wrappers (no wrapper
    runs at a replay); ``a`` / ``b``, (trainer, graph state) and (trainer,
    eager state). Each burst's captures are made before it."""
    import collections

    import torch

    from esrganplus_tpu_torch.kernels import build
    from esrganplus_tpu_torch.train.resident_exec import burst_gates, executor
    from esrganplus_tpu_torch.train.rng import sample_seed
    from esrganplus_tpu_torch.utils.trace import kernel_counts

    own = build.kernel_names()
    t = make()
    sa, sb = t.init_state(0), t.init_state(0)
    ex = executor(t)
    out = {}

    def graph(n):
        ex.capture(sa, store, rng, batch_size, n)
        nodes = collections.Counter()
        for g in burst_gates(t, sa, n):
            nodes.update({f: c for f, c in ex.kernel_nodes(g).items() if f in own})
        return nodes, lambda: out.update(
            la=t.train_step_resident(sa, store, rng, batch_size, n_steps=n)[1])

    def eager(n):
        for _ in range(n):
            out["lb"] = t.train_step(sb, store.make_sampler(batch_size)(
                sample_seed(rng, sb["step"])), rng)[1]

    graph(k)[1]()
    eager(k)
    n = EAGER_PROFILED
    nodes, replays = graph(n)
    traced = kernel_counts(replays, own)
    _zero_counts()
    eager_trace = kernel_counts(lambda: eager(n), own)
    la, lb = out["la"], out["lb"]
    equal = (sa["step"] == sb["step"] == k + n and _states_equal(sa, sb)
             and set(la) == set(lb) and all(torch.equal(la[n], lb[n]) for n in la))
    finite = all(bool(torch.isfinite(v).all()) for v in la.values())
    return {"equal": equal, "finite": finite, "nodes": nodes, "graph": traced,
            "eager": eager_trace, "counted": _counted(), "a": (t, sa), "b": (t, sb)}


def _replay_row(r):
    """The JSON fields of a ``_graph_vs_eager`` result ``r``, and whether the
    traced replays launch, and the card ran in them, what it ran in the
    traced eager steps (the port's kernels by family, nonzero)."""
    k = EAGER_PROFILED
    per = lambda c: {f: n / k for f, n in sorted(c.items())}
    same = r["nodes"] == r["graph"] == r["eager"] and sum(r["nodes"].values()) > 0
    return {"bit_equal_to_eager": r["equal"], "finite": r["finite"],
            "replay_kernels_equal_to_eager": same,
            "replay_nodes_per_step": per(r["nodes"]),
            "replay_traced_per_step": per(r["graph"]),
            "eager_traced_per_step": per(r["eager"]),
            "eager_counted_per_step": {f: n / k for f, n in r["counted"].items() if n}}, same


def train_resident_path(failures, workdir, preloaded_ms, gan_preloaded_ms):
    """Phase train-resident (see the module docstring); ``preloaded_ms`` /
    ``gan_preloaded_ms`` are train-steady's and gan-steady's medians, a step
    on one batch already on the card. Returns the store (train-burst's)."""
    import torch

    from esrganplus_tpu_torch.kernels import philox as X
    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer
    from esrganplus_tpu_torch.train.rng import sample_seed

    B, H, _ = TRAIN_SHAPE
    dirs = _smoke_dataset(workdir)
    t0 = time.perf_counter()
    store = _resident_store(dirs, 4 * H)
    build_s = time.perf_counter() - t0
    make = lambda: SRTrainer(RRDBNetConfig(), SRTrainConfig(compute_dtype="bfloat16"),
                             device="cuda")
    a, b = make(), make()
    sa, sb = a.init_state(0), b.init_state(0)
    sa, la = a.train_step_resident(sa, store, 1, B)
    batch = store.make_sampler(B)(sample_seed(1, 0))
    on_card = all(t.is_cuda for t in batch)
    sb, lb = b.train_step(sb, batch, 1)
    single_equal = _states_equal(sa, sb) and all(torch.equal(la[k], lb[k]) for k in la)
    del b, sb
    step_ms, _ = _host_ms(lambda: a.train_step_resident(sa, store, 1, B), iters=10)
    del a, sa
    row = {"phase": "train-resident", "pairs": store.n_crops,
           "pool_bytes": store.lr.nbytes + store.hr.nbytes, "pool_build_s": build_s,
           "batch_on_card": on_card, "single_step_bit_equal": single_equal,
           "resident_ms_per_step": step_ms, "resident_crops_per_s": B / step_ms * 1e3,
           "preloaded_ms_per_step": preloaded_ms,
           "preloaded_crops_per_s": B / preloaded_ms * 1e3}

    # 16 steps through the CLI (bursts of DISPATCH replays), then a resume
    opt = _smoke_options(workdir, dirs, "resident_smoke", "sr", {"lr_G": 2e-4,
                                                                 "pixel_weight": 1.0})
    opt["datasets"]["train"].update(resident_crops=RESIDENT_CROPS, resident_refresh=1000,
                                    cache_images=True)
    opt["train"].update(steps_per_dispatch=DISPATCH, val_freq=8, save_checkpoint_freq=8)
    opt["logger"]["print_freq"] = PRINT_FREQ
    _zero_counts()
    seconds, exp = _run_train_cli(workdir, opt)
    counted = _twelve()
    launches = {fn.__name__: fn.launches for fn in counted}
    # the sampler's draw and the input mode's 69 noise sites a step, by the
    # Philox kernels (csrc/philox.cu)
    philox = {"philox_bits_cuda": X.philox_bits_cuda.launches,
              "philox_normal_cuda": X.philox_normal_cuda.launches}
    # the wrappers count the capture's warm-up and recording (GRAPH_CALLS
    # steps a capture) and each validation image; a replay runs no wrapper
    losses, text = _logged_losses(exp)
    captures = _captures(text)
    n_val = VAL_IMAGES * (TRAIN_STEPS // 8)
    calls = GRAPH_CALLS * (captures or 0)
    expected = {**{k: per * (calls + n_val) for k, per in PER_IMAGE.items()},
                **{k: per * calls for k, per in BWD_PER_STEP.items()}}
    counts_ok = captures == 1 and all(launches[k] == n for k, n in expected.items()) and (
        philox == {"philox_bits_cuda": calls, "philox_normal_cuda": 69 * calls})
    n_fail = len(failures)
    by_design = _path_designs(failures, "train-resident", launches)
    bursts = _bursts_logged(text)
    row.update(cli_seconds=seconds, cli_launches={k: launches[k] for k in expected},
               cli_expected=expected, cli_philox_launches=philox, cli_by_design=by_design,
               cli_captures=captures, l_pix=losses, cli_pool=_pool_bytes(text),
               cli_bursts=bursts)
    row["ok"] = bool(on_card and single_equal and counts_ok
                     and len(failures) == n_fail
                     and sorted(losses) == list(range(PRINT_FREQ, TRAIN_STEPS + 1, PRINT_FREQ))
                     and all(np.isfinite(float(v)) for v in losses.values())
                     and row["cli_pool"][0] == RESIDENT_CROPS
                     and bursts == [DISPATCH] * (TRAIN_STEPS // DISPATCH))
    emit(row)
    if not row["ok"]:
        failures.append(f"train-resident: {row}")
    _resume_row(failures, "train-resident", workdir, opt, exp, {"l_pix": losses})

    # srragan (train_ESRGANplus.json's shape) on the same store: one burst
    gan = _gan_trainer()
    state = gan.init_state(0)
    _zero_counts()
    gan_steps = 4
    state, logs = gan.train_step_resident(state, store, 1, B, n_steps=gan_steps)
    torch.cuda.synchronize()
    glaunches = {fn.__name__: fn.launches for fn in counted}
    gcalls = GRAPH_CALLS * gan._resident.captures
    gexpected = {k: per * gcalls for k, per in {**PER_IMAGE, **BWD_PER_STEP,
                                                **GAN_FWD_PER_STEP,
                                                **GAN_BWD_PER_STEP}.items()}
    designs = {fn.__name__: dict(fn.launches_by_design) for fn in counted}
    gan_ok = all(glaunches[k] == n and designs[k] == {"fma": 0, "mma": n}
                 for k, n in gexpected.items())
    gan_ms, _ = _host_ms(lambda: gan.train_step_resident(state, store, 1, B), iters=6)
    grow = {"phase": "train-resident-gan", "steps": gan_steps,
            "captures": gan._resident.captures, "launches": glaunches,
            "expected": gexpected, "by_design": designs,
            "finite": all(bool(torch.isfinite(v)) for v in logs.values()),
            "resident_ms_per_step": gan_ms, "resident_crops_per_s": B / gan_ms * 1e3,
            "preloaded_ms_per_step": gan_preloaded_ms,
            "preloaded_crops_per_s": B / gan_preloaded_ms * 1e3}
    grow["ok"] = bool(gan_ok and grow["finite"] and grow["captures"] == 1)
    emit(grow)
    if not grow["ok"]:
        failures.append(f"train-resident-gan: {grow}")
    return store


def _burst_times(fn, steps_per_call, calls, profiled):
    """(ms a step by CUDA events around ``calls`` calls of ``fn``, each of
    ``steps_per_call`` steps, queued back to back; device ms a step of
    ``profiled`` steps by the profiler)."""
    import torch

    fn()  # warm: a capture or the eager step's first call
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    host = start.elapsed_time(end) / (calls * steps_per_call)
    dev = _profiled_device_ms(
        lambda: [fn() for _ in range(profiled // steps_per_call)]) / profiled
    return host, dev


def _burst_timed(graph, eager, store, batch_size):
    """Going on from the states of ``_graph_vs_eager``: for each K in
    BURST_KS the graph's host and device ms a step, idle share and crops/s
    in bursts of K, and the same for eager resident steps."""
    from esrganplus_tpu_torch.train.resident_exec import run_eager

    (a, sa), (b, sb) = graph, eager
    out = {}

    def timed(fn, k, profiled):
        host, dev = _burst_times(fn, k, BURST_STEPS // k, profiled)
        return {"host_ms_per_step": host, "device_ms_per_step": dev,
                "device_idle_share": 1 - dev / host, "crops_per_s": batch_size / host * 1e3}

    for k in BURST_KS:
        out[f"graph_k{k}"] = timed(
            lambda: a.train_step_resident(sa, store, 1, batch_size, n_steps=k), k,
            BURST_PROFILED)
    out["eager"] = timed(lambda: run_eager(b, sb, store, 1, batch_size, 1), 1, EAGER_PROFILED)
    return out


def train_burst(failures, store):
    """Phase train-burst: the PSNR step (bf16, batch 16, HR 128, input noise)
    and the srragan step as captured CUDA graphs. First a burst of
    max(BURST_KS) replays against as many eager steps on the sampled batches,
    then EAGER_PROFILED more of each, traced (``_graph_vs_eager``: bit-equal,
    finite; the port's kernels by family that the replays launch, read from
    the captured graphs, equal to what the profiler saw the card run in
    them and in the eager steps); then, going on from there, ms a step by CUDA events around BURST_STEPS steps in
    bursts of K for each K in BURST_KS, the device ms a step by the profiler,
    the idle share, and the same for eager resident steps (the batch sampled,
    then ``train_step``); the captures' time and pool. Then the same checks
    alone for the fused noise mode, SRResNet and srragan with
    D_update_ratio 2 (its two captures switching inside each burst), at K =
    4 (train-burst-equal)."""
    import torch

    from esrganplus_tpu_torch.models import SRResNetConfig
    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig
    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig
    from esrganplus_tpu_torch.train import GANTrainConfig, GANTrainer, SRTrainConfig, SRTrainer

    B, H, _ = TRAIN_SHAPE
    kmax = max(BURST_KS)
    psnr = lambda: SRTrainer(RRDBNetConfig(), SRTrainConfig(compute_dtype="bfloat16"),
                             device="cuda")
    for name, make in (("psnr", psnr), ("srragan", _gan_trainer)):
        r = _graph_vs_eager(make, store, B, kmax)
        ex = r["a"][0]._resident
        fields, same = _replay_row(r)
        row = {"phase": "train-burst", "step": name, "batch": B, "hr": 4 * H,
               "dtype": "bfloat16", "noise_kernel": "input", "first_burst": kmax, **fields,
               "captures": ex.captures, "capture_s": ex.capture_seconds,
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        row.update(_burst_timed(r["a"], r["b"], store, B))
        row["ok"] = bool(r["equal"] and r["finite"] and same and row["captures"] == 1)
        emit(row)
        if not row["ok"]:
            failures.append(f"train-burst {name}: {row}")
        del r, ex
        torch.cuda.empty_cache()

    cases = (("fused", lambda: SRTrainer(RRDBNetConfig(noise_kernel="fused"),
                                         SRTrainConfig(compute_dtype="bfloat16"), device="cuda"),
              1),
             ("srresnet", lambda: SRTrainer(SRResNetConfig(), SRTrainConfig(), device="cuda"),
              1),
             ("srragan_d_update_ratio_2", lambda: GANTrainer(
                 RRDBNetConfig(), DiscriminatorVGGConfig(),
                 GANTrainConfig(compute_dtype="bfloat16", d_update_ratio=2), device="cuda"), 2))
    k = 4
    for name, make, captures in cases:
        r = _graph_vs_eager(make, store, B, k)
        ex = r["a"][0]._resident
        fields, same = _replay_row(r)
        row = {"phase": "train-burst-equal", "step": name, "k": k, **fields,
               "captures": ex.captures, "capture_s": ex.capture_seconds}
        if name == "fused":  # every rdb_ct call of each step drew its noise in the kernel
            row["seeded_ok"] = (r["counted"]["rdb_ct.seeded"] == EAGER_PROFILED * 69
                                == r["counted"]["rdb_ct_bwd.seeded"])
        row["ok"] = bool(r["equal"] and r["finite"] and same and row["captures"] == captures
                         and row.get("seeded_ok", True))
        emit(row)
        if not row["ok"]:
            failures.append(f"train-burst-equal {name}: {row}")
        del r, ex
        torch.cuda.empty_cache()


def train_profile_cli(failures, workdir):
    """Phase train-profile-cli (see the module docstring): the trace's
    per-step launches of the RDB kernel families against the launches
    counted where each kernel is launched, over the same run (every step
    launches the same: no validation, no checkpoint inside it)."""
    import contextlib
    import io

    from esrganplus_tpu_torch.cli import profile_summary
    from esrganplus_tpu_torch.kernels import launch as L
    from esrganplus_tpu_torch.utils.trace import (aggregate_exclusive, device_rows,
                                                  find_trace_file, load_trace_events)

    dirs = _smoke_dataset(workdir)
    niter = 10 + PROFILE_STEPS
    opt = _smoke_options(workdir, dirs, "profile_smoke", "sr", {"lr_G": 2e-4,
                                                                "pixel_weight": 1.0})
    opt["datasets"]["train"].update(resident_crops=RESIDENT_CROPS, cache_images=True)
    opt["train"].update(niter=niter, val_freq=10 ** 6, save_checkpoint_freq=10 ** 6,
                        steps_per_dispatch=DISPATCH)
    opt["logger"]["print_freq"] = 10 ** 6
    trace_dir = os.path.join(workdir, "trace")
    _zero_counts()
    seconds, exp = _run_train_cli(workdir, opt, ["--profile", trace_dir, "--profile-steps",
                                                 str(PROFILE_STEPS)])
    text = _logged_losses(exp)[1]
    captures = _captures(text)
    # the counters hold what the capture's warm-up and recording launched
    # (GRAPH_CALLS steps); the trace holds what the replays launched
    per_step = {f: L.device_launches[f] / (GRAPH_CALLS * (captures or 1)) for f in RDB_FAMILIES}
    path = find_trace_file(trace_dir)
    events = load_trace_events(path)
    rows_kind = device_rows(events)[0]
    device_ms, agg = aggregate_exclusive(events, steps=PROFILE_STEPS)
    traced = {f: agg.get(f, (0.0, 0))[1] for f in RDB_FAMILIES}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        profile_summary.main([trace_dir, "--steps", str(PROFILE_STEPS), "--top", "12"])
    table = out.getvalue().splitlines()
    # the captured step's kernels by phase (phases.json beside the trace)
    at = next((i for i, line in enumerate(table) if line.startswith("device ms/step by phase")),
              len(table))
    by_phase = table[at + 1:]
    row = {"phase": "train-profile-cli", "steps_traced": PROFILE_STEPS, "niter": niter,
           "steps_per_dispatch": DISPATCH,
           "bursts": _bursts_logged(text), "captures": captures,
           "seconds_total": seconds, "trace_bytes": os.path.getsize(path), "rows": rows_kind,
           "device_ms_per_step": device_ms,
           "device_launches_per_step": sum(c for _, c in agg.values()),
           "rdb_families_per_step_trace": traced, "rdb_families_per_step_counters": per_step,
           "counted_per_capture": {f: n / GRAPH_CALLS for f, n in
                                   sorted(L.device_launches.items())},
           "rdb_families_ms_per_step": {f: agg.get(f, (0.0, 0))[0] for f in RDB_FAMILIES},
           "summary_top": table[:14], "summary_phases": by_phase,
           "phases_json": os.path.isfile(os.path.join(trace_dir, "phases.json"))}
    row["ok"] = bool(rows_kind == "kernel" and traced == per_step and captures == 1
                     and all(v > 0 for v in traced.values())
                     and table[1].startswith("device total:") and row["phases_json"]
                     and any(line.endswith(" g.bwd") for line in by_phase)
                     and row["bursts"] == [DISPATCH, DISPATCH, 1, 1, DISPATCH])
    emit(row)
    if not row["ok"]:
        failures.append(f"train-profile-cli: {row}")


# ---------------------------------------------------------------------------
# the SFT-GAN slice: OutdoorSceneSeg, SFT_Net ×4, MINC / ResNet-101 features,
# the SFT-GAN step and train_sftgan.json as shipped (cuDNN on every model;
# VGG19's ≤128-channel stages of the perceptual loss on #11 / #12)
# ---------------------------------------------------------------------------

SFT_HR = (384, 512)  # the two synthetic HR images of the sft and seg phases
SFT_LR_BENCH = 128  # the LR side of the timed ×4 forward
SFT_BATCH, SFT_HR_SIZE = 16, 96  # train_sftgan.json's batch and HR crop
SFT_RESIDENT = 1024
SFT_STAGE = ("conv_s1_ct", "conv_s1_ct_bwd")  # the two kernels an SFT-GAN step runs
SFT_LOG_KEYS = ("l_g_pix", "l_g_fea", "l_g_gan", "l_g_cls", "l_d_total", "D_real", "D_fake")
OST_CATEGORIES = ("building", "plant", "mountain", "water", "sky", "grass", "animal")


def _seeded_seg_params(seed=0):
    """OutdoorSceneSeg at its published widths from a seed: He-normal convs,
    batch norms near identity with each bottleneck's last scaled by 0.2 (33
    residual adds stay bounded), a random ×8 transposed conv (the init's is
    zero, which would make every probability 1/8)."""
    import torch

    from esrganplus_tpu_torch.models.seg import init_seg

    params = init_seg(seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    u = lambda t, lo, hi: t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=gen))
    for layer in params["layers"]:
        if layer is None:
            continue
        for name, p in (layer.items() if "conv" not in layer else [("c", layer)]):
            bn = p["bn"]
            u(bn["scale"], 0.5, 1.0).mul_(0.2 if name == "c2" else 1.0)
            u(bn["var"], 0.5, 1.5)
            bn["bias"].copy_(0.1 * torch.randn(bn["bias"].shape, generator=gen))
            bn["mean"].copy_(0.1 * torch.randn(bn["mean"].shape, generator=gen))
    params["deconv_w"] = torch.randn(params["deconv_w"].shape, generator=gen) / 16
    return params


def _seeded_sft(cfg, seed=0, trunk_scale=0.1):
    """SFT_Net parameters from a seed with the trunk (the blocks, the final
    SFT layer and conv) scaled by ``trunk_scale``, as the RRDB trunk's init
    is: the unscaled He init the JAX package's trainer starts from grows
    ×2 a block, to outputs of 1e5 at nb 16, which clip to 0 or 1."""
    import torch

    from esrganplus_tpu_torch.models import generator_init

    params = generator_init(seed, cfg)

    def scale(tree):
        for k, v in tree.items():
            if k == "w":
                v.mul_(trunk_scale)
            elif isinstance(v, dict):
                scale(v)

    with torch.no_grad():
        for name in ("blocks", "final_sft", "final_conv"):
            scale(params[name])
    return params


def _sft_images(workdir):
    """Two smooth synthetic HR PNGs of SFT_HR → their folder."""
    from esrganplus_tpu_torch.ops.image_io import save_img

    hr_dir = os.path.join(workdir, "sft_hr")
    rng = np.random.RandomState(15)
    for name in ("scene_sky", "scene_building"):
        save_img(_smooth_image(rng, *SFT_HR), os.path.join(hr_dir, name + ".png"))
    return hr_dir


def seg_path(failures, workdir, hr_dir):
    """Phase seg: the seeded OutdoorSceneSeg through ``cli.test_seg --device
    cuda`` on the two HR images; each probability map against the port's
    CPU forward on the same input within 1e-4, each pixel's summing to 1
    within 1e-5, the three output folders written; the forward's ms an
    image (host clock, and the card's kernel time by ``torch.profiler``) and
    the CLI's s an image. Returns the prob folder."""
    import contextlib
    import io

    import cv2
    import torch

    from esrganplus_tpu_torch.cli import test_seg
    from esrganplus_tpu_torch.infer import params_to
    from esrganplus_tpu_torch.models.layers import fp32_exact
    from esrganplus_tpu_torch.models.seg import seg_forward, seg_to_state_dict
    from esrganplus_tpu_torch.ops.image_io import read_img

    _zero_counts()
    params = _seeded_seg_params()
    ckpt = os.path.join(workdir, "seg_seeded.pth")
    torch.save(seg_to_state_dict(params), ckpt)
    out = os.path.join(workdir, "ost")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        test_seg.main([ckpt, "--input", hr_dir, "--output", out, "--device", "cuda"])
    torch.cuda.synchronize()
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(hr_dir))
    row = {"phase": "seg", "images": len(names), "hr": list(SFT_HR),
           "cli_seconds_per_image": (time.perf_counter() - t0) / len(names)}
    errs, sums, written = {}, {}, {}
    dev = params_to(params, "cuda")
    for n in names:
        x = test_seg.seg_input(read_img(os.path.join(hr_dir, n + ".png")))[None]
        with torch.inference_mode():
            ref = seg_forward(params, torch.from_numpy(x))[0].numpy()
        prob = np.transpose(torch.load(os.path.join(out + "_segprob", n + "_bic.pth"),
                                       weights_only=True).numpy(), (1, 2, 0))
        errs[n] = float(np.abs(prob - ref).max())
        sums[n] = float(np.abs(prob.sum(-1) - 1.0).max())
        written[n] = all(os.path.exists(os.path.join(out + d, n + ".png"))
                         for d in ("_byteimg", "_colorimg")) and bool(np.array_equal(
            cv2.imread(os.path.join(out + "_byteimg", n + ".png"), cv2.IMREAD_UNCHANGED),
            prob.argmax(-1).astype(np.uint8)))
    xt = torch.from_numpy(x).cuda()
    with torch.inference_mode(), fp32_exact():
        fwd = lambda: seg_forward(dev, xt)
        row["forward_ms_per_image"] = _host_ms(fwd, iters=3)[0]
        # its ~450 launches overrun device_ms's queue behind a spin: profiler
        row["forward_device_ms_per_image"] = _profiled_device_ms(fwd)
    row.update(max_abs_err_vs_cpu=errs, max_prob_sum_err=sums, outputs_written=written,
               mean_max_prob=float(ref.max(-1).mean()), tol=1e-4, tol_sum=1e-5,
               kernel_launches={fn.__name__: fn.launches for fn in _twelve()})
    row["ok"] = bool(all(e <= 1e-4 for e in errs.values())
                     and all(s <= 1e-5 for s in sums.values()) and all(written.values())
                     and prob.shape == SFT_HR + (8,)
                     and not any(row["kernel_launches"].values()))
    emit(row)
    if not row["ok"]:
        failures.append(f"seg: {row}")
    return out + "_segprob"


def sft_path(failures, workdir, hr_dir, segprob):
    """Phase sft: the shipped SFT_Net (nb 16, nf 64, cond_nf 32, ×4) from a
    seed, exported to .pth (read back bit-exact), through ``cli.test_sftgan
    --device cuda`` on the seg phase's maps; each output against the port's
    fp32 forward on the CPU within 1e-4 of max|ref| and its PNG equal to the
    card output's; ms an image at a 128² LR in fp32 and bf16 (host clock,
    and the card's kernel time by ``torch.profiler``) and MPix/s out."""
    import contextlib
    import io

    import cv2
    import torch

    from esrganplus_tpu_torch.cli import test_sftgan
    from esrganplus_tpu_torch.convert import generator_from_state_dict, load_state_dict
    from esrganplus_tpu_torch.infer import SRInferencer, params_to
    from esrganplus_tpu_torch.models import SFTNetConfig
    from esrganplus_tpu_torch.models.layers import fp32_exact
    from esrganplus_tpu_torch.models.sft import sftnet_forward, sftnet_to_state_dict
    from esrganplus_tpu_torch.ops.color import modcrop
    from esrganplus_tpu_torch.ops.image_io import img2tensor, read_img, tensor2img
    from esrganplus_tpu_torch.ops.resize import imresize_np
    from esrganplus_tpu_torch.train.sr_model import tree_leaves

    _zero_counts()
    cfg = SFTNetConfig()
    params = _seeded_sft(cfg)
    ckpt = os.path.join(workdir, "sft_seeded.pth")
    torch.save(sftnet_to_state_dict(params, cfg), ckpt)
    back, bcfg, _ = generator_from_state_dict(load_state_dict(ckpt))
    round_trip = bcfg == cfg and all(torch.equal(a, b) for a, b in
                                     zip(tree_leaves(back), tree_leaves(params)))
    out = os.path.join(workdir, "sft_out")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        test_sftgan.main([ckpt, "--input", hr_dir, "--segprob", segprob, "--output", out,
                          "--device", "cuda"])
    torch.cuda.synchronize()
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(hr_dir))
    row = {"phase": "sft", "cfg": [cfg.nb, cfg.nf, cfg.cond_nf, cfg.upscale],
           "pth_round_trip_bit_exact": round_trip,
           "cli_seconds_per_image": (time.perf_counter() - t0) / len(names)}
    inf = SRInferencer(params, cfg, device="cuda")
    errs, png_equal = {}, {}
    for n in names:
        lr = img2tensor(np.clip(imresize_np(modcrop(read_img(os.path.join(hr_dir, n + ".png")),
                                                    8), 0.25), 0, 1))
        seg = np.transpose(torch.load(os.path.join(segprob, n + "_bic.pth"),
                                      weights_only=True).numpy(), (1, 2, 0))
        got = inf.upscale(lr, side=seg)
        with torch.inference_mode():
            ref = sftnet_forward(params, torch.from_numpy(lr[None]), torch.from_numpy(seg[None]),
                                 cfg)[0].clamp(0, 1).numpy()
        errs[n] = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
        png_equal[n] = bool(np.array_equal(
            cv2.imread(os.path.join(out, n + "_rlt.png"), cv2.IMREAD_UNCHANGED), tensor2img(got)))
    row.update(rel_err_vs_cpu=errs, png_equal=png_equal, out_shape=list(got.shape), tol=1e-4)
    # the ×4 forward at a 128² LR, fp32 and bf16
    gen = torch.Generator(device="cuda").manual_seed(3)
    s = SFT_LR_BENCH
    x = torch.rand((1, s, s, 3), generator=gen, device="cuda")
    side = torch.softmax(torch.randn((1, 4 * s, 4 * s, 8), generator=gen, device="cuda"), -1)
    dev = params_to(params, "cuda")
    for dname, dt in (("fp32", None), ("bf16", torch.bfloat16)):
        with torch.inference_mode(), fp32_exact():
            fwd = lambda: sftnet_forward(dev, x, side, cfg, dtype=dt)
            med, _ = _host_ms(fwd, iters=10)
            row[f"{dname}_ms_per_image_{s}"] = med
            row[f"{dname}_device_ms_per_image_{s}"] = _profiled_device_ms(fwd)
            row[f"{dname}_mpix_per_s_out"] = (4 * s) ** 2 / 1e6 / (med / 1e3)
    row["gflop_per_image"] = 2 * _sft_macs_per_lr_pixel(cfg) * s * s / 1e9
    row["kernel_launches"] = {fn.__name__: fn.launches for fn in _twelve()}
    row["ok"] = bool(round_trip and all(e <= 1e-4 for e in errs.values())
                     and all(png_equal.values()) and got.shape == (SFT_HR[0], SFT_HR[1], 3)
                     and not any(row["kernel_launches"].values()))
    emit(row)
    if not row["ok"]:
        failures.append(f"sft: {row}")


def _sft_macs_per_lr_pixel(cfg):
    """Multiply-adds of one SFT_Net ×4 forward per LR pixel, from its shapes."""
    nf, c = cfg.nf, cfg.cond_nf
    sft_layer = 2 * (c * c + c * nf)
    block = 2 * sft_layer + 2 * 9 * nf * nf
    cond = 16 * cfg.cond_in * 128 + 3 * 128 * 128 + 128 * c
    tail = 9 * nf * 4 * nf * (1 + 4) + 9 * nf * nf * 16 + 9 * nf * cfg.out_nc * 16
    return 9 * cfg.in_nc * nf + cfg.nb * block + sft_layer + 9 * nf * nf + cond + tail


def featex_path(failures):
    """Phase featex: MINC and ResNet-101 (published widths and depth, seeded
    weights through their converters) at 96², batch 16, on the card against
    the CPU within 1e-4 of max|ref|; ms of each forward on the card."""
    import torch

    from esrganplus_tpu_torch.infer import params_to
    from esrganplus_tpu_torch.models import feature_extractors as fe
    from esrganplus_tpu_torch.models.layers import fp32_exact

    gen = torch.Generator().manual_seed(21)
    he = lambda cout, cin, k: torch.randn((cout, cin, k, k), generator=gen) * (
        2.0 / (k * k * cin)) ** 0.5
    minc_sd = {}
    for name, cin, cout in (e for e in fe.MINC_PLAN if e != "M"):
        minc_sd[name + ".weight"], minc_sd[name + ".bias"] = he(cout, cin, 3), 0.1 * torch.randn(
            cout, generator=gen)
    res_sd = {"conv1.weight": he(64, 3, 7)}

    def bn(name, c, scale=1.0):
        res_sd.update({name + ".weight": scale * (0.5 + 0.5 * torch.rand(c, generator=gen)),
                       name + ".bias": 0.1 * torch.randn(c, generator=gen),
                       name + ".running_mean": 0.1 * torch.randn(c, generator=gen),
                       name + ".running_var": 0.5 + torch.rand(c, generator=gen)})

    bn("bn1", 64)
    inplanes = 64
    for stage, (planes, depth) in enumerate(zip((64, 128, 256, 512), (3, 4, 23, 3)), start=1):
        for i in range(depth):
            base = f"layer{stage}.{i}"
            for j, (cout, cin, k) in enumerate(((planes, inplanes, 1), (planes, planes, 3),
                                                (4 * planes, planes, 1)), start=1):
                res_sd[f"{base}.conv{j}.weight"] = he(cout, cin, k)
                bn(f"{base}.bn{j}", cout, 0.2 if j == 3 else 1.0)
            if i == 0:
                res_sd[base + ".downsample.0.weight"] = he(4 * planes, inplanes, 1)
                bn(base + ".downsample.1", 4 * planes)
            inplanes = 4 * planes
    x = torch.rand((SFT_BATCH, SFT_HR_SIZE, SFT_HR_SIZE, 3), generator=gen)
    row = {"phase": "featex", "batch": SFT_BATCH, "hr": SFT_HR_SIZE}
    ok = True
    for name, params, fwd in (
            ("minc", fe.minc_from_state_dict(minc_sd), fe.minc_forward),
            ("resnet101", fe.resnet101_from_state_dict(res_sd), fe.resnet101_feat_forward)):
        with torch.inference_mode(), fp32_exact():
            ref = fwd(params, x)
            dev, xd = params_to(params, "cuda"), x.cuda()
            got = fwd(dev, xd).cpu()
            ms = time_ms(lambda: fwd(dev, xd), iters=5, warmup=2)
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        row.update({f"{name}_out": list(got.shape), f"{name}_rel_err": err,
                    f"{name}_ms": ms})
        ok = ok and err <= 1e-4 and bool(torch.isfinite(got).all())
    row["tol"] = 1e-4
    row["ok"] = bool(ok)
    emit(row)
    if not row["ok"]:
        failures.append(f"featex: {row}")


def _sft_batch(gen, batch=SFT_BATCH, hr=SFT_HR_SIZE):
    """(LR, seg, HR, category) of train_sftgan.json's shape on the card."""
    import torch

    lr = torch.rand((batch, hr // 4, hr // 4, 3), generator=gen, device="cuda")
    seg = torch.softmax(3 * torch.randn((batch, hr, hr, 8), generator=gen, device="cuda"), -1)
    hr_img = torch.rand((batch, hr, hr, 3), generator=gen, device="cuda")
    cat = torch.randint(0, 8, (batch,), generator=gen, device="cuda")
    return lr, seg, hr_img, cat


def sftgan_check(failures):
    """Phase sftgan-check: one SFT-GAN step's G and D losses and gradients
    (train_sftgan.json's shape: batch 16, HR 96; SFT nb 16; the ACD; VGG19 to
    features[34] from a seed) through ``SFTGANTrainer``'s own loss functions,
    the perceptual net on the stage kernels (``stage_kernel="auto"``)
    against the plain graph (``"plain"``) on the card, fp32 then bf16, at
    gan-check's bars. Every stage call must have taken its dtype's design.
    Returns the fp32 launches of one step's G and D losses by wrapper."""
    import torch

    from esrganplus_tpu_torch.kernels import stage_ct as S
    from esrganplus_tpu_torch.models import SFTNetConfig
    from esrganplus_tpu_torch.models.layers import deterministic_convs, fp32_exact
    from esrganplus_tpu_torch.models.vgg import VGGFeatConfig
    from esrganplus_tpu_torch.train import SFTGANTrainConfig, SFTGANTrainer
    from esrganplus_tpu_torch.train.sr_model import tree_leaves, tree_map

    gen = torch.Generator(device="cuda").manual_seed(12)
    lr, seg, hr, cat = _sft_batch(gen)

    def trainer(kind, dtype):
        return SFTGANTrainer(SFTNetConfig(), SFTGANTrainConfig(compute_dtype=dtype),
                             device="cuda", vgg_cfg=VGGFeatConfig(stage_kernel=kind))

    t0 = trainer("plain", None)
    state = t0.init_state(0)
    g_params, d_params = t0.ingest_params(_seeded_sft(t0.net_g)), state["d_params"]
    named_g, named_d = _leaves(g_params), [kv for kv in _leaves(d_params) if kv[1] is not None]

    def run(kind, dtype):
        t = trainer(kind, dtype)
        with fp32_exact(), deterministic_convs():
            frozen = tree_map(lambda p: p.detach(), d_params)
            g_total, fake, logs = t._g_loss(g_params, frozen, lr, seg, hr, cat)
            g_grads = torch.autograd.grad(g_total, tree_leaves(g_params))
            d_total, _, d_logs = t._d_loss(d_params, fake.detach(), hr, cat)
            d_grads = torch.autograd.grad(d_total, tree_leaves(d_params), allow_unused=True)
        return {k: v.item() for k, v in {**logs, **d_logs}.items()}, g_grads, d_grads

    flat = lambda gs: torch.cat([g.flatten().float() for g in gs if g is not None])
    cosine = lambda a, b: torch.nn.functional.cosine_similarity(flat(a), flat(b), dim=0).item()

    def leaf_errs(named, got, ref, norm=float("inf")):
        size = lambda t: torch.linalg.vector_norm(t.float().flatten(), norm)
        floor = 1e-3 * max(size(b).item() for b in ref if b is not None)
        return {n: (size(a - b) / size(b).clamp_min(floor)).item()
                for (n, _), a, b in zip(named, got, ref) if b is not None}

    def term_errs(got, ref):
        return {k: abs(got[k] - ref[k]) / (max(1.0, abs(ref[k])) if k.startswith("D_")
                                           else max(abs(ref[k]), 1e-30)) for k in ref}

    stage = (S.conv_s1_ct, S.conv_s1_ct_bwd)
    t_ref, gg_ref, dg_ref = run("plain", None)
    per_step = None
    for dname, dtype in (("float32", None), ("bfloat16", "bfloat16")):
        _zero_counts()
        t_k, gg_k, dg_k = run("auto", dtype)
        launches = {fn.__name__: fn.launches for fn in _twelve()}
        want = "mma" if dtype else "fma"
        by_design = {fn.__name__: dict(fn.launches_by_design) for fn in stage}
        designs_ok = all(fn.launches > 0 and fn.launches_by_design == {
            "fma": 0, "mma": 0, want: fn.launches} for fn in stage)
        terr = term_errs(t_k, t_ref)
        g_err = leaf_errs(named_g, gg_k, gg_ref)
        d_l2 = leaf_errs(named_d, dg_k, dg_ref, norm=2)
        wg, wd2 = max(g_err, key=g_err.get), max(d_l2, key=d_l2.get)
        row = {"phase": "sftgan-check", "dtype": dname, "terms_plain_fp32": t_ref,
               "terms_kernel": t_k, "term_rel_err": terr, "g_worst_leaf": wg,
               "g_worst_rel_err": g_err[wg], "g_cosine": cosine(gg_k, gg_ref),
               "d_worst_leaf_l2": wd2, "d_worst_rel_err_l2": d_l2[wd2],
               "d_cosine": cosine(dg_k, dg_ref), "leaves": [len(g_err), len(d_l2)],
               "launches": launches, "stage_launches_by_design": by_design,
               "finite": all(bool(torch.isfinite(g).all()) for g in list(gg_k) + list(dg_k)
                             if g is not None)}
        if dtype is None:
            per_step = {k: launches[k] for k in SFT_STAGE}
            row.update(tol_terms=1e-4, tol_g_grad=5e-3, tol_d_grad_l2=2e-2, tol_cosine=0.9999)
            ok = (max(terr.values()) <= 1e-4 and g_err[wg] <= 5e-3 and d_l2[wd2] <= 2e-2
                  and row["g_cosine"] >= 0.9999 and row["d_cosine"] >= 0.9999)
        else:
            t_p, gg_p, dg_p = run("plain", dtype)
            row.update(tol_terms=5e-2, tol_g_cosine=0.999, tol_d_cosine=0.95,
                       plain_bf16_term_rel_err=term_errs(t_p, t_ref),
                       plain_bf16_g_cosine=cosine(gg_p, gg_ref),
                       plain_bf16_d_cosine=cosine(dg_p, dg_ref))
            ok = (max(terr.values()) <= 5e-2 and row["g_cosine"] >= 0.999
                  and row["d_cosine"] >= 0.95)
        # only the two stage wrappers of the perceptual net launch
        others = {k: n for k, n in launches.items() if k not in SFT_STAGE}
        row["ok"] = bool(ok and designs_ok and row["finite"] and not any(others.values()))
        emit(row)
        if not row["ok"]:
            failures.append(f"sftgan-check {dname}: {row}")
    return per_step


def _ost_tree(workdir):
    """A synthetic OST tree: ``img/`` (8 smooth PNGs named by category),
    ``bicseg/`` their [8, H, W] seg probabilities (``torch.save``), a
    DIV2K-like background folder and a two-image val set laid out the same
    way → {"train" | "bg" | "val": directory}."""
    import torch

    from esrganplus_tpu_torch.ops.image_io import save_img

    rng = np.random.RandomState(17)
    dirs = {}
    for part, n, size in (("train", 8, (120, 160)), ("val", 2, (96, 128))):
        img_dir = os.path.join(workdir, "OST", part, "img")
        seg_dir = os.path.join(workdir, "OST", part, "bicseg")
        os.makedirs(seg_dir)
        for i in range(n):
            name = f"{OST_CATEGORIES[i % len(OST_CATEGORIES)]}_{i:03d}"
            save_img(_smooth_image(rng, *size), os.path.join(img_dir, name + ".png"))
            logits = 4 * _smooth_image(rng, *size)[..., :1].astype(np.float32) / 255 \
                + rng.randn(8, 1, 1).astype(np.float32).transpose(1, 2, 0)
            prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
            torch.save(torch.from_numpy(np.ascontiguousarray(prob.transpose(2, 0, 1))),
                       os.path.join(seg_dir, name + ".pth"))
        dirs[part] = img_dir
    dirs["bg"] = os.path.join(workdir, "DIV2K_sub")
    for i in range(4):
        save_img(_smooth_image(rng, 128, 128), os.path.join(dirs["bg"], f"{i:04d}.png"))
    return dirs


def _sftgan_options(workdir, dirs, name, **train_ds):
    """train_sftgan.json as shipped with its dataroots, niter, cadences and
    a val set of two images changed (and ``train_ds`` added)."""
    from esrganplus_tpu_torch.options.options import _strip_comments

    with open(os.path.join(SHIPPED, "train", "train_sftgan.json")) as f:
        opt = json.loads(_strip_comments(f.read()))
    opt.update(name=name, use_tb_logger=False)
    opt["path"]["root"] = workdir
    opt["datasets"]["train"].update(dataroot_HR=dirs["train"], dataroot_HR_bg=dirs["bg"],
                                    **train_ds)
    opt["datasets"]["val"] = {"name": "ost_val", "mode": "LRHRseg_bg",
                              "dataroot_HR": dirs["val"]}
    opt["logger"]["print_freq"] = PRINT_FREQ
    opt["train"].update(niter=TRAIN_STEPS, val_freq=8, save_checkpoint_freq=8)
    return opt


def _groups_after(exp, net_g, trainer):
    """The saved state after TRAIN_STEPS steps against the trainer's initial
    one: whether the other group's parameters and Adam state are bit-equal
    to init and the sft group's parameters moved."""
    import torch

    from esrganplus_tpu_torch.train.checkpoint import load_state
    from esrganplus_tpu_torch.train.sftgan_model import group_mask
    from esrganplus_tpu_torch.train.sr_model import tree_leaves

    init = trainer.init_state(0)
    end = load_state(os.path.join(exp, "training_state", f"{TRAIN_STEPS}.state.npz"), init)
    same = lambda a, b: all(torch.equal(x, y) if torch.is_tensor(x) else x == y
                            for x, y in zip(tree_leaves(a), tree_leaves(b)))
    return {"other_params_unchanged": same(group_mask(end["g_params"], "other"),
                                           group_mask(init["g_params"], "other")),
            "other_moments_unchanged": same(end["g_opt"]["other"], init["g_opt"]["other"])
            and end["g_opt"]["other"]["count"] == 0,
            "sft_params_moved": not any(torch.equal(x, y) for x, y in zip(
                tree_leaves(group_mask(end["g_params"], "sft")),
                tree_leaves(group_mask(init["g_params"], "sft")))),
            "sft_count": end["g_opt"]["sft"]["count"]}


def train_sftgan_path(failures, workdir, per_step):
    """Phase train-sftgan: train_sftgan.json as shipped (fp32, batch 16,
    HR 96, VGG19 seeded) for TRAIN_STEPS steps through the train CLI, host-fed
    then from SFT_RESIDENT resident crops, each resumed from step 8 bit-equal;
    the launches of #11 / #12 equal to TRAIN_STEPS × ``per_step`` (what
    sftgan-check counted for one step), all by the fp32 design; the other
    group (other_start_iter 20 000) bit-unchanged, the sft group moved; a
    trainer with other_start_iter 4 moves both within 5 steps; host ms/step
    and crops/s of the steady step host-fed (the recipe's loader and
    DeviceFeeder), on one batch already on the card, and resident. Returns
    the host-fed run's launches by wrapper, the ms/step on the batch already
    on the card, and (trainer, that batch)."""
    import torch

    from esrganplus_tpu_torch.data import DeviceFeeder, create_dataloader, create_dataset
    from esrganplus_tpu_torch.data.resident import ResidentSegStore
    from esrganplus_tpu_torch.kernels import stage_ct as S
    from esrganplus_tpu_torch.models import SFTNetConfig
    from esrganplus_tpu_torch.train import SFTGANTrainConfig, SFTGANTrainer
    from esrganplus_tpu_torch.train.sftgan_model import group_mask
    from esrganplus_tpu_torch.train.sr_model import tree_leaves

    dirs = _ost_tree(workdir)
    trainer = SFTGANTrainer(SFTNetConfig(), SFTGANTrainConfig(), device="cuda")
    runs = {}
    for mode, extra in (("host", {}), ("resident", dict(
            resident_crops=SFT_RESIDENT, resident_async_refresh=False))):
        opt = _sftgan_options(workdir, dirs, f"sftgan_{mode}", **extra)
        _zero_counts()
        seconds, exp = _run_train_cli(workdir, opt)
        launches = {fn.__name__: fn.launches for fn in _twelve()}
        by_design = {fn.__name__: dict(fn.launches_by_design)
                     for fn in (S.conv_s1_ct, S.conv_s1_ct_bwd)}
        logged = {k: _logged_losses(exp, k)[0] for k in SFT_LOG_KEYS}
        text = _logged_losses(exp)[1]
        # resident: each capture counted as GRAPH_CALLS steps; a replay runs no wrapper
        captures = _captures(text)
        calls = TRAIN_STEPS if mode == "host" else GRAPH_CALLS * (captures or 0)
        expected = {k: per_step[k] * calls for k in SFT_STAGE}
        groups = _groups_after(exp, trainer.net_g, trainer)
        row = {"phase": "train-sftgan", "mode": mode, "recipe": "train_sftgan.json",
               "steps": TRAIN_STEPS, "dtype": opt["train"].get("compute_dtype") or "float32",
               "seconds_total": seconds, "captures": captures, "logged": logged,
               "launches": launches,
               "expected": expected, "stage_launches_by_design": by_design, **groups,
               "validations": text.count("Validation # PSNR"),
               "random_vgg_warning": "VGG19 weights not provided" in text,
               "resident_pool": _pool_bytes(text)}
        row["ok"] = bool(
            all(launches[k] == n and by_design[k] == {"fma": n, "mma": 0}
                for k, n in expected.items())
            and not any(n for k, n in launches.items() if k not in SFT_STAGE)
            and all(sorted(v) == list(range(PRINT_FREQ, TRAIN_STEPS + 1, PRINT_FREQ))
                    and all(np.isfinite(float(t)) for t in v.values())
                    for v in logged.values())
            and groups["other_params_unchanged"] and groups["other_moments_unchanged"]
            and groups["sft_params_moved"] and groups["sft_count"] == TRAIN_STEPS
            and row["validations"] == TRAIN_STEPS // 8
            and captures == (None if mode == "host" else 1)
            and (mode == "host" or row["resident_pool"] == (
                SFT_RESIDENT, SFT_RESIDENT * (24 * 24 * 3 * 4 + 96 * 96 * 8 + 96 * 96 * 3 + 8))))
        emit(row)
        if not row["ok"]:
            failures.append(f"train-sftgan {mode}: {row}")
        _resume_row(failures, f"train-sftgan-{mode}", workdir, opt, exp, logged,
                    keys=SFT_LOG_KEYS)
        runs[mode] = launches

    # the gate: a trainer with other_start_iter 4 moves both groups by step 5;
    # then the steady step
    ds = create_dataset({"name": "OST", "mode": "LRHRseg_bg", "phase": "train", "scale": 4,
                         "dataroot_HR": dirs["train"], "dataroot_HR_bg": dirs["bg"],
                         "HR_size": SFT_HR_SIZE, "use_flip": True, "use_rot": False})
    t0 = time.perf_counter()
    store = ResidentSegStore(ds, "cuda", n_crops=256, seed=0, use_rot=False)
    build_s = time.perf_counter() - t0
    gated = SFTGANTrainer(SFTNetConfig(), SFTGANTrainConfig(other_start_iter=4), device="cuda")
    state = gated.init_state(0)
    other0 = [t.detach().clone() for t in tree_leaves(group_mask(state["g_params"], "other"))]
    moved = []
    for _ in range(5):
        state, logs = gated.train_step_resident(state, store, 1, SFT_BATCH)
        moved.append(not all(torch.equal(a, b.detach()) for a, b in zip(
            other0, tree_leaves(group_mask(state["g_params"], "other")))))
    gate_ok = moved == [False] * 4 + [True] and state["g_opt"]["other"]["count"] == 1 \
        and state["g_opt"]["sft"]["count"] == 5
    del gated, state

    # the captured step over the seg store: a burst of 4, then a traced burst
    # of 2 across other_start_iter (two captures), against eager steps; then
    # both timed as train-burst times
    r = _graph_vs_eager(
        lambda: SFTGANTrainer(SFTNetConfig(), SFTGANTrainConfig(other_start_iter=5),
                              device="cuda"), store, SFT_BATCH, 4)
    ex = r["a"][0]._resident
    fields, same = _replay_row(r)
    per = {k: r["counted"][k] / EAGER_PROFILED for k in SFT_STAGE}
    row = {"phase": "train-resident-sftgan", "batch": SFT_BATCH, "hr": SFT_HR_SIZE,
           "dtype": "float32", "k": 4, "other_start_iter": 5, **fields,
           "launches_per_step": per, "expected_per_step": {k: per_step[k] for k in SFT_STAGE},
           "captures": sorted(map(list, ex._graphs)), "capture_s": ex.capture_seconds}
    row.update(_burst_timed(r["a"], r["b"], store, SFT_BATCH))
    row["ok"] = bool(r["equal"] and r["finite"] and same and per == row["expected_per_step"]
                     and len(row["captures"]) == 2)
    emit(row)
    if not row["ok"]:
        failures.append(f"train-resident-sftgan: {row}")
    del r, ex
    batch = store.make_sampler(SFT_BATCH)(7)
    st = trainer.init_state(0)
    # host-fed as cli.train feeds it: the recipe's loader (8 workers) and
    # DeviceFeeder; then one batch already on the card (the step alone); then
    # the resident store
    dso = dict(_sftgan_options(workdir, dirs, "sftgan_steady")["datasets"]["train"],
               phase="train", scale=4)
    loader = create_dataloader(create_dataset(dso), dso, seed=0)
    feeder = DeviceFeeder(loader, "cuda", keys=("LR", "seg", "HR", "category"))
    fed = iter(feeder)
    try:
        host_ms, host_runs = _host_ms(lambda: trainer.train_step(st, next(fed)[0], 1), iters=8)
    finally:
        feeder.stop()
        loader.stop()
    pre_ms, pre_runs = _host_ms(lambda: trainer.train_step(st, batch, 1), iters=8)
    res_ms, res_runs = _host_ms(lambda: trainer.train_step_resident(st, store, 1, SFT_BATCH),
                                iters=8)
    row = {"phase": "train-sftgan-steady", "batch": SFT_BATCH, "hr": SFT_HR_SIZE,
           "dtype": "float32", "other_start_iter_4_moved_by_step": moved,
           "gate_ok": bool(gate_ok), "pool_crops": store.n_crops, "pool_bytes": store.nbytes,
           "pool_build_s": build_s, "loader_workers": loader.num_workers,
           "host_fed_ms_per_step": host_ms,
           "host_fed_crops_per_s": loader.batch_size / host_ms * 1e3,
           "host_fed_ms_runs": host_runs,
           "preloaded_ms_per_step": pre_ms, "preloaded_ms_runs": pre_runs,
           "resident_ms_per_step": res_ms, "resident_crops_per_s": SFT_BATCH / res_ms * 1e3,
           "resident_ms_runs": res_runs}
    row["ok"] = bool(gate_ok and all(bool(torch.isfinite(v)) for v in logs.values()))
    emit(row)
    if not row["ok"]:
        failures.append(f"train-sftgan-steady: {row}")
    return runs["host"], pre_ms, (trainer, batch)


# ---------------------------------------------------------------------------
# data parallelism (parallel/mesh.py) and the offline tools
# ---------------------------------------------------------------------------

DIST_DISPATCH = 8  # train_sr.json's steps_per_dispatch in dist-nccl-1
B0 = 8  # the batch offset of dist-kernels: rank 1 of two at a global batch of 16
DIST_TOL = 1e-5  # dist-gloo-2: of max|leaf|, and relative for the logged terms
DIST_MOMENT_TOL = 1e-4  # relative L2 of a moment leaf (a batch sum in another order)
GLOO_STEPS = 3  # timed steps a rank in dist-gloo-2 (after the compared one)
BP_SIZES = (128, 512)  # tools: the LR and SR sides of the back-projection pair
BP_ITERS = 20


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_dist_kernels(failures):
    """Phase dist-kernels: with the batch offset b0 = B0 at batch B0, the
    Philox normals (philox_normal_cuda), the fused rdb_ct training forward's
    output and saved buffers, and rdb_ct_bwd's replayed noise factor and data
    gradient equal rows B0..2·B0-1 of the batch-2·B0 launch bit for bit (bf16,
    the training shape's 32×32); b0 = 0 draws what the call without it draws;
    the half batch's weight gradients against their twin at the bf16 bar."""
    import torch

    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels.philox import (key_words, noise_factor_cuda,
                                                     philox_normal_cuda)

    _, H, W = TRAIN_SHAPE
    B = 2 * B0
    site = key_words(NOISE_SEED, "cuda")
    whole = philox_normal_cuda(site, (B, H, W, NF))
    half = philox_normal_cuda(site, (B0, H, W, NF), b0=B0)
    zero = philox_normal_cuda(site, (B0, H, W, NF), b0=0)
    fac = noise_factor_cuda(site, NOISE_SIGMA, (B0, H, W, NF), "cuda", b0=B0)
    fac_whole = noise_factor_cuda(site, NOISE_SIGMA, (B, H, W, NF), "cuda")
    gen = torch.Generator().manual_seed(17)
    wr = K.prepare_rdb_ct_weights(_rdb_params(gen), torch.bfloat16)
    act = lambda: torch.randn((B, H, W, NF), generator=gen).to("cuda", torch.bfloat16)
    x, g = act(), act()
    kw = dict(seed=site, sigma=NOISE_SIGMA, save=True)
    full = K._rdb_ct_cuda(x, wr, **kw)
    part = K._rdb_ct_cuda(x[B0:].contiguous(), wr, b0=B0, **kw)
    bwd = K.rdb_ct_bwd(x[B0:].contiguous(), wr, part[1], part[2], g[B0:].contiguous(),
                       seed=site, b0=B0, sigma=NOISE_SIGMA)
    bwd_full = K.rdb_ct_bwd(x, wr, full[1], full[2], g, seed=site, sigma=NOISE_SIGMA)
    torch.cuda.synchronize()
    twin = K.rdb_ct_bwd_plain(x[B0:], wr, part[1], part[2], g[B0:], seed=site, b0=B0,
                              sigma=NOISE_SIGMA)
    worst, _, finite = worst_err({k: v for k, v in bwd.items() if k != "dx"},
                                 {k: v for k, v in twin.items() if k != "dx"})
    row = {"phase": "dist-kernels", "b0": B0, "batch": B0, "of_batch": B, "lr": [H, W],
           "philox_rows_bit_equal": torch.equal(half, whole[B0:]),
           "philox_b0_zero_unchanged": torch.equal(zero, whole[:B0]),
           "factor_rows_bit_equal": torch.equal(fac, fac_whole[B0:]),
           "rdb_ct_rows_bit_equal": all(torch.equal(a, b[B0:]) for a, b in zip(part, full)),
           "rdb_ct_bwd_dx_rows_bit_equal": torch.equal(bwd["dx"], bwd_full["dx"][B0:]),
           "rdb_ct_bwd_weights_rel_err_vs_twin": worst, "tol": BWD_TOL["bfloat16"]}
    row["ok"] = bool(row["philox_rows_bit_equal"] and row["philox_b0_zero_unchanged"]
                     and row["factor_rows_bit_equal"] and row["rdb_ct_rows_bit_equal"]
                     and row["rdb_ct_bwd_dx_rows_bit_equal"] and finite
                     and worst <= BWD_TOL["bfloat16"])
    emit(row)
    if not row["ok"]:
        failures.append(f"dist-kernels: {row}")


def _nccl_nodes(counter) -> dict:
    """The kernel families of a captured graph that NCCL launched."""
    return {f: n for f, n in counter.items() if "nccl" in f.lower() or "onerank" in f.lower()}


def _first_graph(trainer):
    """The trainer's one captured resident step's graph."""
    return next(iter(trainer._resident._graphs.values()))[0]


def _dist_gan_steps(workdir, dirs, store):
    """One captured resident step of ``srragan`` (train_ESRGANplus.json's
    shape: bf16, D 128, seeded VGG19, batch 16 of 128² crops) and of SFT-GAN
    (train_sftgan.json's: fp32, batch 16 of 96² crops over a seg store),
    each from its seeded state without a group and under a world-size-1 NCCL
    group → {model: {"plain" | "nccl": (state on the host, logs, collectives
    captured, graph kernel families)}}."""
    import torch

    from esrganplus_tpu_torch.data import create_dataset
    from esrganplus_tpu_torch.data.resident import ResidentSegStore
    from esrganplus_tpu_torch.models import SFTNetConfig
    from esrganplus_tpu_torch.parallel import mesh
    from esrganplus_tpu_torch.train import SFTGANTrainConfig, SFTGANTrainer
    from esrganplus_tpu_torch.utils.trace import graph_kernels

    ost = _ost_tree(workdir)
    ds = create_dataset({"name": "OST", "mode": "LRHRseg_bg", "phase": "train", "scale": 4,
                         "dataroot_HR": ost["train"], "dataroot_HR_bg": ost["bg"],
                         "HR_size": SFT_HR_SIZE, "use_flip": True, "use_rot": False})
    seg_store = ResidentSegStore(ds, "cuda", n_crops=256, seed=0, use_rot=False)
    cases = (("srragan", _gan_trainer, store, TRAIN_SHAPE[0]),
             ("sftgan", lambda: SFTGANTrainer(SFTNetConfig(), SFTGANTrainConfig(),
                                              device="cuda"), seg_store, SFT_BATCH))
    out = {}
    for model, make, st, batch in cases:
        out[model] = {}
        for name in ("plain", "nccl"):
            if name == "nccl":
                mesh.init_process_group(f"localhost:{_free_port()}", 1, 0, "cuda")
            try:
                t = make()
                state = mesh.replicate_tree(t.init_state(0))
                before = mesh.captured
                state, logs = t.train_step_resident(state, st, 1, batch)
                torch.cuda.synchronize()
                out[model][name] = (_tensors(state), {k: float(v) for k, v in logs.items()},
                                    mesh.captured - before, graph_kernels(_first_graph(t)))
                del t, state
            finally:
                mesh.destroy_process_group()
            torch.cuda.empty_cache()
    del seg_store
    return out


def dist_nccl_1(failures, workdir):
    """Phase dist-nccl-1: ``cli.train`` with ``--dist-*`` as a world-size-1
    NCCL group on ``train_sr.json``'s shape at full width (nb 23, nf 64, gc 32,
    batch 16, HR 128, bf16, input noise, 4096 resident crops,
    ``steps_per_dispatch`` 8) for 16 steps: its logged losses and
    ``latest_G.pth`` bit-equal to the same run without ``--dist-*``. Then the
    resident step captured under the group: the collectives recorded in the
    capture (``mesh.captured``), its graph's nodes beyond the same step
    captured without a group, NCCL's kernels among them (none at world size
    1: NCCL makes an in-place SUM over one rank no operation), and host /
    device ms a step in bursts of 8 beside the capture without a group
    (train-burst's ``graph_k8``). Then one captured resident step of
    ``srragan`` and of SFT-GAN under the group, bit-equal to the same step
    without one (:func:`_dist_gan_steps`), with its collectives captured."""
    import torch

    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig
    from esrganplus_tpu_torch.parallel import mesh
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer
    from esrganplus_tpu_torch.utils.trace import graph_kernels

    B, H, _ = TRAIN_SHAPE
    dirs = _smoke_dataset(workdir)
    from esrganplus_tpu_torch.kernels import philox as X

    runs = {}
    for name, argv in (("dist_plain", ()),
                       ("dist_nccl", ("--dist-coordinator", f"localhost:{_free_port()}",
                                      "--dist-num-processes", "1", "--dist-process-id", "0"))):
        opt = _smoke_options(workdir, dirs, name, "sr", {"lr_G": 2e-4, "pixel_weight": 1.0})
        opt["datasets"]["train"].update(resident_crops=RESIDENT_CROPS, resident_refresh=1000,
                                        cache_images=True)
        opt["train"].update(steps_per_dispatch=DIST_DISPATCH, val_freq=TRAIN_STEPS,
                            save_checkpoint_freq=TRAIN_STEPS)
        opt["logger"]["print_freq"] = DIST_DISPATCH
        _zero_counts()
        seconds, exp = _run_train_cli(workdir, opt, argv)
        launches = {fn.__name__: fn.launches for fn in _twelve()}
        philox = {"philox_bits_cuda": X.philox_bits_cuda.launches,
                  "philox_normal_cuda": X.philox_normal_cuda.launches}
        losses, text = _logged_losses(exp)
        runs[name] = (seconds, losses, text,
                      torch.load(os.path.join(exp, "models", "latest_G.pth")))
    # the --dist run's launches (the last one counted): its one capture's
    # warm-up and recording and the validation of step 16, as train-resident
    calls = GRAPH_CALLS * (_captures(text) or 0)
    expected = {**{k: per * (calls + VAL_IMAGES) for k, per in PER_IMAGE.items()},
                **{k: per * calls for k, per in BWD_PER_STEP.items()}}
    counts_ok = _captures(text) == 1 and all(launches[k] == n for k, n in expected.items()) \
        and philox == {"philox_bits_cuda": calls, "philox_normal_cuda": 69 * calls}
    (s0, l0, _, g0), (s1, l1, t1, g1) = runs["dist_plain"], runs["dist_nccl"]
    weights_equal = g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    row = {"phase": "dist-nccl-1", "batch": B, "hr": 4 * H, "dtype": "bfloat16",
           "steps": TRAIN_STEPS, "steps_per_dispatch": DIST_DISPATCH,
           "cli_seconds": {"plain": s0, "nccl": s1}, "l_pix": {"plain": l0, "nccl": l1},
           "losses_bit_equal": bool(l0) and l0 == l1, "latest_G_bit_equal": weights_equal,
           "group_logged": "process 0 of 1 (nccl)" in t1, "bursts": _bursts_logged(t1),
           "cli_launches": {k: launches[k] for k in expected}, "cli_expected": expected,
           "cli_philox_launches": philox, "counts_ok": counts_ok}

    # the resident step captured under a world-size-1 NCCL group, and without
    store = _resident_store(dirs, 4 * H)
    make = lambda: SRTrainer(RRDBNetConfig(), SRTrainConfig(compute_dtype="bfloat16"),
                             device="cuda")
    graphs = {}
    for name in ("nccl", "plain"):
        if name == "nccl":
            mesh.init_process_group(f"localhost:{_free_port()}", 1, 0, "cuda")
        try:
            t = make()
            state = mesh.replicate_tree(t.init_state(0))  # the first collective: eager
            before = mesh.captured
            burst = lambda: t.train_step_resident(state, store, 1, B, n_steps=DIST_DISPATCH)
            host, dev = _burst_times(burst, DIST_DISPATCH, BURST_STEPS // DIST_DISPATCH,
                                     BURST_PROFILED)
            graphs[name] = {"nodes": graph_kernels(_first_graph(t)),
                            "host_ms_per_step": host, "device_ms_per_step": dev,
                            "captures": t._resident.captures,
                            "collectives_captured": mesh.captured - before}
            del t, state, burst
        finally:
            mesh.destroy_process_group()
        torch.cuda.empty_cache()
    beyond = lambda a, b: {f: n - b.get(f, 0) for f, n in a.items() if n != b.get(f, 0)}
    row.update(
        collectives_captured=graphs["nccl"]["collectives_captured"],
        nccl_graph_nodes=_nccl_nodes(graphs["nccl"]["nodes"]),
        graph_nodes_beyond_plain=beyond(graphs["nccl"]["nodes"], graphs["plain"]["nodes"]),
        graph_kernel_nodes={k: sum(g["nodes"].values()) for k, g in graphs.items()},
        **{f"{k}_{f}": g[f] for k, g in graphs.items()
           for f in ("host_ms_per_step", "device_ms_per_step", "captures")},
        perf_md_graph_k8_host_ms=28.75)
    row["nccl_host_overhead"] = (row["nccl_host_ms_per_step"]
                                 / row["plain_host_ms_per_step"] - 1)
    # sr's step captures two collectives: the gradients' and the logs'
    sr_ok = bool(row["collectives_captured"] == 2 and row["nccl_captures"] == 1
                 and graphs["plain"]["collectives_captured"] == 0)

    gan = _dist_gan_steps(workdir, dirs, store)
    del store
    for model, r in gan.items():
        (sp, lp, cp, kp), (sn, ln, cn, kn) = r["plain"], r["nccl"]
        err = max(float((sn[k].double() - v.double()).abs().max()
                        / max(float(v.double().abs().max()), 1e-30)) for k, v in sp.items())
        row[model] = {"state_bit_equal": sp.keys() == sn.keys()
                      and all(torch.equal(sp[k], sn[k]) for k in sp),
                      "logs_bit_equal": lp == ln, "max_leaf_err_of_max": err,
                      "collectives_captured": cn, "plain_collectives_captured": cp,
                      "nccl_graph_nodes": _nccl_nodes(kn),
                      "graph_nodes_beyond_plain": beyond(kn, kp)}
    row["ok"] = bool(row["losses_bit_equal"] and weights_equal and row["group_logged"]
                     and counts_ok and sr_ok
                     and row["bursts"] == [DIST_DISPATCH] * (TRAIN_STEPS // DIST_DISPATCH)
                     and all(row[m]["state_bit_equal"] and row[m]["logs_bit_equal"]
                             and row[m]["collectives_captured"] > 2
                             and row[m]["plain_collectives_captured"] == 0 for m in gan))
    emit(row)
    if not row["ok"]:
        failures.append(f"dist-nccl-1: {row}")


def _gloo_case(model):
    """(trainer, the global batch on the card) of a dist-gloo-2 case: fp32,
    the global batch of TRAIN_SHAPE[0] from a seed; ``sr`` the flagship
    PSNR net with input noise, ``srragan`` it against discriminator_vgg_128
    and a seeded VGG19."""
    import torch

    from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig
    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig
    from esrganplus_tpu_torch.train import GANTrainConfig, GANTrainer, SRTrainConfig, SRTrainer

    B, H, W = TRAIN_SHAPE
    if model == "sr":
        t = SRTrainer(RRDBNetConfig(), SRTrainConfig(), device="cuda")
    else:
        t = GANTrainer(RRDBNetConfig(), DiscriminatorVGGConfig(input_size=4 * H),
                       GANTrainConfig(), device="cuda")
    gen = torch.Generator().manual_seed(23)
    batch = (torch.rand((B, H, W, 3), generator=gen).cuda(),
             torch.rand((B, 4 * H, 4 * W, 3), generator=gen).cuda())
    return t, batch


def _tensors(state) -> dict:
    """A state's tensor leaves by path, copied to the host."""
    import torch

    return {n: v.detach().cpu().clone() for n, v in _leaves(state) if torch.is_tensor(v)}


def gloo_worker(rank, port, out):
    """One rank of dist-gloo-2 (``chip_smoke.py --gloo-worker RANK PORT OUT``):
    joins a two-process gloo group on the one card; for each case one step on
    its rows of the global batch (logs and the state after it kept), then
    GLOO_STEPS timed steps, the last traced for the all-reduces' share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, HERE)
    from esrganplus_tpu_torch.parallel import mesh

    mesh.init_process_group(f"localhost:{port}", 2, int(rank), "cuda", backend="gloo")
    res = {}
    try:
        for model in ("sr", "srragan"):
            t, batch = _gloo_case(model)
            state = mesh.replicate_tree(t.init_state(0))
            local = tuple(mesh.local_rows(b).contiguous() for b in batch)
            _zero_counts()
            state, logs = t.train_step(state, local, 1)
            torch.cuda.synchronize()
            res[model] = {"logs": {k: float(v) for k, v in logs.items()},
                          "launches": _counted(),
                          "state": _tensors(state)}
            step = lambda: t.train_step(state, local, 1)
            ms, _ = _host_ms(step, iters=GLOO_STEPS, warmup=0)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            # gloo's collectives run on its own thread: each "gloo:all_reduce"
            # record spans one, the copies through the host included
            reduce_us = sum(e.cpu_time_total for e in prof.key_averages()
                            if e.key.startswith("gloo:"))
            res[model].update(ms_per_step=ms, allreduce_ms=reduce_us / 1e3,
                              profiled_host_ms=wall * 1e3)
            del t, state, local, batch
            torch.cuda.empty_cache()
        torch.save(res, out)
    finally:
        mesh.destroy_process_group()


def dist_gloo_2(failures, workdir):
    """Phase dist-gloo-2: two processes share the card in a gloo group
    (``gloo_worker``), eager host-fed fp32 steps at a global batch of 16
    (8 a rank): ``sr`` at full width (input noise) and ``srragan`` (D 128,
    seeded VGG19). After one step, both ranks' logs equal, each term within
    DIST_TOL of the one-process step's on the global batch, and every state
    leaf held to it by ``esrganplus_tpu_torch/parallel/held.py`` (tol
    DIST_TOL, floor DIST_MOMENT_TOL; the leaves it leaves out printed with
    the reason); ms a step and the all-reduces' share of the traced step's
    host time (profiler) beside the one-process step's. A leaf's noise is
    the larger of two motions of the one-process step: under a 1e-7
    relative perturbation of its batch, and with PyTorch's own fp32
    convolutions in place of cuDNN's (whose algorithm changes with the
    batch: the random D's last stage moves its gradients by up to 0.75 %,
    relative L2, between them, while a 1e-7 perturbation moves them 5e-6)."""
    import torch

    from esrganplus_tpu_torch.parallel import held

    port = _free_port()
    outs = [os.path.join(workdir, f"gloo{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                               "--gloo-worker", str(r), str(port), outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        row = {"phase": "dist-gloo-2", "ok": False, "returncodes": [p.returncode for p in procs],
               "tail": [t[-1500:] for t in texts]}
        emit(row)
        failures.append(f"dist-gloo-2: {row}")
        return
    ranks = [torch.load(o, weights_only=False) for o in outs]
    for model in ("sr", "srragan"):
        t, batch = _gloo_case(model)
        gen = torch.Generator().manual_seed(5)
        moved = tuple((b * (1 + 1e-7 * torch.randn(b.shape, generator=gen).to(b.device)))
                      for b in batch)
        host = lambda st: {n: v.numpy() for n, v in _tensors(st).items()}
        pert = host(t.train_step(t.init_state(0), moved, 1)[0])
        torch.backends.cudnn.enabled = False  # PyTorch's own convolutions
        try:
            native = host(t.train_step(t.init_state(0), batch, 1)[0])
        finally:
            torch.backends.cudnn.enabled = True
        state = t.init_state(0)
        state, logs = t.train_step(state, batch, 1)
        want = host(state)
        sources = {"perturbed": held.noise_of(pert, want),
                   "native_convs": held.noise_of(native, want)}
        noise = {n: max(v[n] for v in sources.values()) for n in want}
        ref_logs = {k: float(v) for k, v in logs.items()}
        one_ms, _ = _host_ms(lambda: t.train_step(state, batch, 1), iters=GLOO_STEPS)
        lr = t.lr_schedule(1)
        r0, r1 = ranks[0][model], ranks[1][model]
        ranks_equal = r0["logs"] == r1["logs"] and all(
            torch.equal(r0["state"][n], r1["state"][n]) for n in r0["state"])
        term_err = {k: abs(r0["logs"][k] - v) / max(abs(v), 1.0 if k.startswith("D_") else 1e-12)
                    for k, v in ref_logs.items()}
        got = {n: v.numpy() for n, v in r0["state"].items()}
        res = held.held_state(got, want, DIST_TOL, lr, lambda: noise, DIST_MOMENT_TOL)
        kept = [n for n in want if n not in res["left_out"]]
        leaf_err = max((float(np.abs(got[n].astype(np.float64) - want[n]).max()
                              / max(float(np.abs(want[n]).max(initial=0.0)), 1e-30)), n)
                       for n in kept)
        barred = res["barred"] or kept
        # every kernel of the step ran on each rank: G's eight (and the
        # input noise's Philox draws), D's and VGG19's four stage wrappers
        need = [fn.__name__ for fn in _twelve()
                if model == "srragan" or not fn.__name__.startswith("conv_s")]
        need.append("philox_normal_cuda")
        launched = {r: {k: ranks[r][model]["launches"][k] for k in need} for r in range(2)}
        row = {"phase": "dist-gloo-2", "model": model, "dtype": "float32",
               "launches": launched,
               "global_batch": TRAIN_SHAPE[0], "per_rank": TRAIN_SHAPE[0] // 2,
               "ranks_bit_equal": ranks_equal, "term_rel_err": term_err,
               "max_leaf_err_of_max": leaf_err[0], "max_leaf_err_leaf": leaf_err[1],
               "max_leaf_err_held_by_rule": res["held_by"].get(leaf_err[1]),
               "leaves_past_bar": res["bad"],
               "barred_leaves": len(res["barred"]), "worst_barred_of_bar": res["worst"],
               "noise_cap": held.NOISE_CAP, "left_out": res["left_out"],
               "barred_max_noise_by_source": {k: max(v[n] for n in barred)
                                              for k, v in sources.items()},
               "barred_max_rel_l2_to_native_convs": max(
                   held.rel_l2(got[n], native[n]) for n in barred),
               "ms_per_step": {r: ranks[r][model]["ms_per_step"] for r in range(2)},
               "one_process_ms_per_step": one_ms,
               "allreduce_ms": {r: ranks[r][model]["allreduce_ms"] for r in range(2)},
               "allreduce_share": {r: ranks[r][model]["allreduce_ms"]
                                   / ranks[r][model]["profiled_host_ms"] for r in range(2)},
               "profiled_host_ms": {r: ranks[r][model]["profiled_host_ms"] for r in range(2)}}
        row["ok"] = bool(ranks_equal and max(term_err.values()) <= DIST_TOL and not res["bad"]
                         and set(r0["logs"]) == set(ref_logs)
                         and all(n > 0 for c in launched.values() for n in c.values()))
        emit(row)
        if not row["ok"]:
            failures.append(f"dist-gloo-2 {model}: {row}")
        del t, state, batch
        torch.cuda.empty_cache()


def tools_path(failures, workdir):
    """Phase tools: ``back_projection`` and ``reverse_filter`` on a seeded
    BP_SIZES[0]² LR / BP_SIZES[1]² SR pair on the card against the CPU
    (within 1e-5), with their times; then a round trip on seeded checkpoints:
    ``cli.net_interp`` blends two SRResNet checkpoints, ``cli.transfer_params
    --sft`` seeds a shipped-width SFT_Net template from the blend (every
    mapped key equal to the blend's), and ``cli.auto_test`` sweeps
    ``cli.test`` on the card over the blend and a missing iteration."""
    import contextlib
    import io

    import torch

    from esrganplus_tpu_torch.cli import auto_test, net_interp, transfer_params
    from esrganplus_tpu_torch.convert import generator_to_state_dict, load_state_dict
    from esrganplus_tpu_torch.models import SRResNetConfig, generator_init
    from esrganplus_tpu_torch.models.sft import SFTNetConfig
    from esrganplus_tpu_torch.ops.back_projection import back_projection, reverse_filter
    from esrganplus_tpu_torch.ops.image_io import save_img
    from esrganplus_tpu_torch.ops.resize import imresize_np

    rng = np.random.RandomState(31)
    lr_side, sr_side = BP_SIZES
    hr = _smooth_image(rng, sr_side, sr_side).astype(np.float32) / 255.0
    lr = imresize_np(hr, lr_side / sr_side)
    sr = np.clip(hr + rng.randn(*hr.shape).astype(np.float32) * 0.03, 0, 1)
    row = {"phase": "tools", "lr": lr_side, "sr": sr_side, "iters": BP_ITERS, "tol": 1e-5}
    ok = True
    for fn in (back_projection, reverse_filter):
        scale = sr_side // lr_side
        got = fn(sr, lr, scale, BP_ITERS, device="cuda")
        torch.cuda.synchronize()
        want = fn(sr, lr, scale, BP_ITERS, device="cpu")
        err = float((got.cpu() - want).abs().max())
        row[fn.__name__] = {"max_abs_err_vs_cpu": err,
                            "ms": time_ms(lambda: fn(sr, lr, scale, BP_ITERS, device="cuda"),
                                          iters=3, warmup=1),
                            "cpu_ms": time_ms(lambda: fn(sr, lr, scale, BP_ITERS, device="cpu"),
                                              iters=1, warmup=0)}
        ok = ok and err <= 1e-5 and bool(torch.isfinite(got).all())

    cfg = SRResNetConfig()
    paths = {}
    for name, seed in (("psnr", 1), ("gan", 2)):
        paths[name] = os.path.join(workdir, f"{name}.pth")
        torch.save(generator_to_state_dict(generator_init(seed, cfg), cfg), paths[name])
    models = os.path.join(workdir, "experiments", "interp", "models")
    os.makedirs(models)
    blend = os.path.join(models, "8_G.pth")
    template = os.path.join(workdir, "sft_template.pth")
    sft_cfg = SFTNetConfig()
    torch.save(generator_to_state_dict(generator_init(3, sft_cfg), sft_cfg), template)
    seeded = os.path.join(workdir, "sft_seeded.pth")
    dirs = _smoke_dataset(os.path.join(workdir, "data"))
    opt = {"name": "base", "model": "sr", "scale": 4,
           "datasets": {"test_1": {"name": "smoke_val", "mode": "LRHR",
                                   "dataroot_HR": dirs["valHR"], "dataroot_LR": dirs["valLR"]}},
           "path": {"root": workdir},
           "network_G": {"which_model_G": "sr_resnet", "norm_type": None, "mode": "CNA",
                         "nf": cfg.nf, "nb": cfg.nb, "in_nc": 3, "out_nc": 3}}
    with open(os.path.join(workdir, "test.json"), "w") as f:
        json.dump(opt, f)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        net_interp.main(["0.3", paths["psnr"], paths["gan"], blend])
        transfer_params.main([blend, template, seeded, "--sft"])
        auto_test.main(["-opt", os.path.join(workdir, "test.json"), "--models-root",
                        os.path.join(workdir, "experiments"), "--names", "interp",
                        "--iters", "8", "16", "--device", "cuda"])
    a, b = load_state_dict(paths["psnr"]), load_state_dict(paths["gan"])
    mixed = load_state_dict(blend)
    blend_ok = mixed.keys() == a.keys() and all(
        torch.equal(mixed[k], torch.from_numpy(0.7 * a[k].numpy() + 0.3 * b[k].numpy()))
        for k in a)
    sft = load_state_dict(seeded)
    mapped = {d + s: k + s for d, k in transfer_params.srgan_to_sft_map().items()
              for s in (".weight", ".bias")}
    moved = [d for d, k in mapped.items() if d in sft and k in mixed
             and sft[d].shape == mixed[k].shape]
    transfer_ok = bool(moved) and all(torch.equal(sft[d], mixed[mapped[d]]) for d in moved)
    results = os.path.join(workdir, "results", "interp_8", "smoke_val")
    pngs = sorted(f for f in os.listdir(results) if f.endswith(".png")) \
        if os.path.isdir(results) else []
    printed = out.getvalue()
    row.update(blend_exact=blend_ok, sft_keys_seeded=len(moved), transfer_exact=transfer_ok,
               auto_test_images=len(pngs),
               auto_test_skipped_missing="skip interp@16" in printed)
    row["ok"] = bool(ok and blend_ok and transfer_ok and len(pngs) == VAL_IMAGES
                     and row["auto_test_skipped_missing"])
    emit(row)
    if not row["ok"]:
        failures.append(f"tools: {row}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from esrganplus_tpu_torch.kernels import build

    failures = []
    t0 = time.perf_counter()
    logs = build.build(force=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": sorted(logs)})
    for src, log in logs.items():
        for line in ptxas_summary(log):
            print(f"ptxas[{src}] {line}")

    report = check_kernels(failures)
    workdir = os.path.join(HERE, "build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        launches = main_path(failures, tmp)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        eval_path(failures, tmp)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        serve_path(failures, tmp)
    bwd_report = check_bwd_kernels(failures)
    check_dense_accuracy(failures)
    check_dense_bwd_accuracy(failures)
    check_conv_hr_gate(failures)
    noise_report = check_noise_kernels(failures)
    train_check(failures)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        train_launches = train_path(failures, tmp)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        train_lmdb_path(failures, tmp)
    input_steady = train_steady(failures)
    step_ms = input_steady[0]
    fused_step_ms = train_fused(failures, workdir, input_steady)
    rdb_t_report = check_rdb_t_kernels(failures)
    check_rdb_t_gate(failures)
    rdb_t_launches = rdb_t_path(failures)
    stage_report = check_stage_kernels(failures)
    gan_check(failures)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        gan_launches = gan_train_path(failures, tmp)
    gan_step_ms = gan_steady(failures)
    wb_report, wb_conv_launches = check_workbench_kernels(failures)
    check_workbench_wide(failures)
    wb_launches = workbench_path(failures)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        srresnet_path(failures, tmp)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        train_srresnet_path(failures, tmp)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        store = train_resident_path(failures, tmp, step_ms, gan_step_ms)
        train_burst(failures, store)
        del store
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        train_profile_cli(failures, tmp)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        hr_dir = _sft_images(tmp)
        segprob = seg_path(failures, tmp, hr_dir)
        sft_path(failures, tmp, hr_dir, segprob)
    featex_path(failures)
    sft_per_step = sftgan_check(failures)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        sft_launches, sft_step_ms, (sft_trainer, sft_batch) = train_sftgan_path(
            failures, tmp, sft_per_step)
    check_dist_kernels(failures)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        dist_nccl_1(failures, tmp)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        dist_gloo_2(failures, tmp)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        tools_path(failures, tmp)
    if "--profile" in sys.argv[1:]:
        train_profile(step_ms)
        train_profile(fused_step_ms, _fused_trainer, "train-fused-profile")
        train_profile(gan_step_ms, _gan_trainer, "gan-profile")
        train_profile(sft_step_ms, lambda: sft_trainer, "sftgan-profile", sft_batch)

    kernels = []
    for name in PER_IMAGE:
        row = report[(name, "bfloat16")]
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "dtype": "bfloat16", "lr": row["lr"],
                        "fp32_ms": report[(name, "float32")]["ms"],
                        "fp32_max_abs_err": report[(name, "float32")]["max_abs_err"],
                        "train_launches": train_launches[name],
                        "gan_launches": gan_launches[name]})
        if name == "upfold_ct":  # the design, the card alone; the 2nd upconv and WIDE_C beside
            second = report[("upfold_ct_2nd", "bfloat16")]
            wide = report[("upfold_ct_wide", "bfloat16")]
            timed = ("device_ms", "launch_device_ms", "library_device_ms")
            kernels[-1].update(design=row["design"], frac_differ=row["frac_differ"],
                               fp32_design=report[(name, "float32")]["design"],
                               **{f: row[f] for f in timed},
                               **{f"second_call_{f}": second[f]
                                  for f in ("ms", "plain_ms", "bound_ms", "library_ms",
                                            "max_abs_err", "frac_differ") + timed},
                               wide_c=WIDE_C,
                               **{f"wide_c_{f}": wide[f]
                                  for f in ("bound_ms", "max_abs_err", "frac_differ") + timed})
        if name == "conv_hr_ct":  # the design, and ms of each of its launches
            kernels[-1].update(design=row["design"], step_ms=row["step_ms"],
                               hid_frac_differ=row["hid_frac_differ"],
                               frac_differ=row["frac_differ"],
                               fp32_design=report[(name, "float32")]["design"],
                               fp32_source="esrganplus_tpu_torch/csrc/tail_ct.cu")
        if name in DENSE_DESIGNED:  # the design, the card alone (and rdb_ct's five launches)
            kernels[-1].update(design=row["design"], frac_differ=row["frac_differ"],
                               device_ms=row["device_ms"],
                               library_device_ms=row["library_device_ms"],
                               fp32_design=report[(name, "float32")]["design"],
                               **{k: row[k] for k in ("step_ms", "step_device_ms") if k in row})
        if name == "rdb_ct":  # the training forward at batch 16, 32×32: fused beside input
            fused = noise_report[("rdb_ct", "bfloat16")]
            kernels[-1].update(fused_ms=fused["fused_ms"], fused_input_ms=fused["input_ms"],
                               fused_rel_err=fused["out"]["rel_err"],
                               fused_fp32_rel_err=noise_report[("rdb_ct", "float32")]["out"]
                               ["rel_err"], fused_lr=list(TRAIN_SHAPE))
    for name in BWD_PER_STEP:
        row = bwd_report[(name, "bfloat16")]
        k = {"name": name, "route": "cuda",
             "source": BWD_MMA_SOURCE.get(name, BWD_SOURCE),
             "replaces": BWD_REPLACES[name], "launches": train_launches[name],
             "max_abs_err": row["max_abs_err"], "rel_err": row["rel_err"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"],
             "dtype": "bfloat16", "lr": row["lr"],
             "fp32_ms": bwd_report[(name, "float32")]["ms"],
             "fp32_rel_err": bwd_report[(name, "float32")]["rel_err"],
             "gan_launches": gan_launches[name]}
        if name == "rdb_ct_bwd":  # the fused mode's replay beside the input mode
            fused = noise_report[("rdb_ct_bwd", "bfloat16")]
            k.update(fused_ms=fused["fused_ms"], fused_input_ms=fused["input_ms"],
                     fused_rel_err=fused["rel_err"],
                     fused_source="esrganplus_tpu_torch/csrc/philox.cu",
                     fused_fp32_rel_err=noise_report[("rdb_ct_bwd", "float32")]["rel_err"])
        if name in DESIGNED:  # the design, and ms of each of its launches
            k.update(design=row["design"], step_ms=row["step_ms"],
                     fp32_design=bwd_report[(name, "float32")]["design"],
                     fp32_source=BWD_SOURCE + (" + esrganplus_tpu_torch/csrc/rdb_ct.cu"
                                               if name == "conv_hr_ct_bwd" else ""))
        if name in DENSE_BWD_DESIGNED:  # the design, each launch, the card alone
            k.update(fp32_design=bwd_report[(name, "float32")]["design"],
                     **{f: row[f] for f in ("design", "step_ms", "step_device_ms", "device_ms",
                                            "library_device_ms")})
        if name == "upfold_ct_bwd":  # the 2nd stage (64² → 128²) beside the 1st
            second = bwd_report[("upfold_ct_bwd_2nd", "bfloat16")]
            k.update(db_rel_err=row["db_rel_err"],
                     **{f"second_call_{f}": second[f]
                        for f in ("ms", "plain_ms", "bound_ms", "library_ms", "rel_err",
                                  "step_ms", "db_rel_err")})
        kernels.append(k)
    for name in STAGE_REPLACES:
        # one shape's numbers in the required keys, every flagship shape beside them
        row = stage_report[(name, STAGE_MAIN_SHAPE[name], "bfloat16")]
        fields = ("design", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "max_abs_err", "rel_err") + (("dx_only_ms", "dw_only_ms")
                                               if name.endswith("_bwd") else ())
        fields += (("dx_only_device_ms", "dw_only_device_ms", "device_ms", "library_device_ms")
                   if name == "conv_s2_ct_bwd" else ())
        kernels.append({
            "name": name, "route": "cuda", "source": STAGE_SOURCE,
            "replaces": STAGE_REPLACES[name], "launches": gan_launches[name],
            "max_abs_err": row["max_abs_err"], "rel_err": row["rel_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "dtype": "bfloat16", "design": row["design"], "shape": STAGE_MAIN_SHAPE[name],
            "x": row["x"], "cout": row["cout"],
            "fp32_ms": stage_report[(name, STAGE_MAIN_SHAPE[name], "float32")]["ms"],
            "shapes": {sname: {**{f: r[f] for f in fields},
                               "fp32_ms": stage_report[(kn, sname, "float32")]["ms"]}
                       for (kn, sname, dn), r in stage_report.items()
                       if kn == name and dn == "bfloat16"}})
        if name in SFT_STAGE:  # VGG19's early stages in train_sftgan.json's 16 steps
            kernels[-1]["sftgan_launches"] = sft_launches[name]
    for name in RDB_T_REPLACES:
        row = rdb_t_report[(name, RDB_T_MAIN_SHAPE, "bfloat16")]
        fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                  "rel_err", "design", "device_ms", "library_device_ms") + (
            ("frac_differ",) if name == "rdb_t" else ("recompute_design", "step_ms"))
        kernels.append({
            "name": name, "route": "cuda", "source": RDB_T_SOURCE,
            "replaces": RDB_T_REPLACES[name], "launches": rdb_t_launches[name],
            **{f: row[f] for f in fields}, "dtype": "bfloat16", "lr": row["lr"],
            "fp32_ms": rdb_t_report[(name, RDB_T_MAIN_SHAPE, "float32")]["ms"],
            "fp32_rel_err": rdb_t_report[(name, RDB_T_MAIN_SHAPE, "float32")]["rel_err"],
            "shapes": {sname: {**{f: r[f] for f in fields},
                               "fp32_ms": rdb_t_report[(kn, sname, "float32")]["ms"]}
                       for (kn, sname, dn), r in rdb_t_report.items()
                       if kn == name and dn == "bfloat16"}})
    kernels += workbench_rows(wb_report, wb_conv_launches, wb_launches)
    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        return 1
    emit({"kernels": kernels})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-worker"]:
        gloo_worker(*sys.argv[2:5])
        sys.exit(0)
    sys.exit(main())
