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
  3. main    — flagship ESRGAN+ ×4 (nb=23, nf=64, gc=32) with seeded random
               weights exported to a .pth, through the port's test_image CLI
               on three PNGs in bf16; checks output shapes, the kernels'
               launch counts per image, and the bf16 kernel path against the
               fp32 plain path (and the fp32 kernel path) on the card; then
               the small golden ESRGAN+ checkpoint (tests/golden) through the
               kernel path against the reference implementation's output;
  4. kernels-train-fwd — rdb_ct's training forward (saved l2|l4, the noise
               epilogue) at the training shape: its output and both saved
               buffers against the plain twin's, fp32 and bf16;
     kernels-bwd — each backward wrapper (rdb_ct_bwd, conv3x3_ct_bwd,
               upfold_ct_bwd at both stages, conv_hr_ct_bwd) against its plain
               twin at the training shape (batch 16, 32×32 LR), fp32 and bf16,
               on the kernel's saved buffers and again with the twin fed its
               own forward's buffers, with times, bounds and a cuDNN-autograd
               yardstick;
     kernels-noise — the fused noise mode at the training shape: the device
               Philox draws (csrc/philox.cu) against the twin's, rdb_ct's
               training forward drawing the noise in its epilogue and
               rdb_ct_bwd replaying it against their twins (fp32, bf16, detach
               on and off; two backward calls bit-equal), timed beside the
               input mode (a pre-drawn noise tensor) on the same inputs;
  5. train-check — flagship width and depth, one batch: loss and every
               gradient leaf of the kernel path against autograd of the plain
               graph on the card, fp32 then bf16, the same noise fed to both;
  6. train   — a seeded PNG dataset and an options file under build/smoke/,
               then ``esrganplus_tpu_torch.cli.train`` at the full flagship
               config (batch 16, HR 128, bf16, noise on) for 16 steps with the
               debug cadences; checks the logged losses, the launch counts of
               all eight kernels, the exported checkpoint, and a resume from
               step 8 that must end bit-equal to the uninterrupted run;
  7. train-steady — ``SRTrainer.train_step`` on one device-resident batch:
               median ms/step and crops/s, twice from one seed (bit-equal);
     train-fused — phases 6 and 7 again with ``"noise_kernel": "fused"``
               (every rdb_ct call of a step seeded, resume bit-equal, two
               steady runs bit-equal), then the input mode's steady step once
               more; ms/step and peak memory of both modes;
     kernels-rdb-t — rdb_t (with and without the RRDB fold) and rdb_t_bwd
               against their twins, fp32 and bf16, at the odd, inference and
               training shapes, with times, bounds and a cuDNN yardstick;
     rdb-t-path — three chained ``rdb_t_diff`` (one RRDB) forward and
               backward at the training shape in bf16, launch counts from
               0, against autograd of the fp32 twins;
  8. kernels-stage — the GAN slice's four stage wrappers (conv_s1_ct,
               conv_s2_ct and their backwards) against their plain twins, fp32
               and bf16, at an odd shape (B=2, 36×52, 3→8 and 16→16 channels,
               act none/relu/lrelu) and at every shape the flagship
               discriminator and VGG19 give them at batch 16, there with times,
               bounds and a cuDNN yardstick; the backward also on the twin's
               own forward output and with the weight half switched off;
  9. gan-check — flagship G, discriminator_vgg_128 and VGG19 (seeded), one
               batch: every loss term and every gradient leaf of G and of D
               through the kernel path against autograd of the plain graph on
               the card, fp32 then bf16, the same noise fed to both;
 10. gan-train — an options file with ``model: "srragan"`` at the recipe's
               shape (batch 16, HR 128, bf16, noise on, perceptual loss on)
               for 16 steps through ``esrganplus_tpu_torch.cli.train``; checks
               the logged terms, the launch counts of all twelve kernels,
               ``latest_G.pth`` / ``latest_D.pth``, and a resume from step 8
               that must end bit-equal;
 11. gan-steady — ``GANTrainer.train_step`` on one device-resident batch:
               median ms/step and crops/s, twice from one seed (bit-equal);
     with ``--profile`` also a ``torch.profiler`` trace of three steady steps
     of each trainer, the PSNR one in both noise modes (device time by
     kernel family, the card's busy share).

Then one ``{"kernels": [...]}`` line (fourteen kernels), the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.
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
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM: fp32 CUDA cores, bf16 dense
PEAK_BYTES = 3.35e12
NF, GC, OUT_NC = 64, 32, 3
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
SOURCES = {"rdb_ct": "esrganplus_tpu_torch/csrc/rdb_ct.cu",
           "conv3x3_ct": "esrganplus_tpu_torch/csrc/rdb_ct.cu",
           "upfold_ct": "esrganplus_tpu_torch/csrc/tail_ct.cu",
           "conv_hr_ct": "esrganplus_tpu_torch/csrc/tail_ct.cu"}
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
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # per gradient, of max|ref|
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
        m = re.search(r"(dense_conv3x3_kernel|upfold_kernel|conv_hr_kernel|stage_fwd_kernel|"
                      r"stage_dgrad_kernel|stage_wgrad_kernel|dgrad_kernel|wgrad_kernel)"
                      r"I(\w+?)EE", line)
        if m:
            args = (m.group(2).replace("13__nv_bfloat16", "bf16").replace("Li", ",")
                    .replace("E", "").lstrip(","))
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
    the tensors the main path hands it for a B×H×W LR input."""
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
    return cases


def check_kernels(failures):
    import torch

    from esrganplus_tpu_torch.models.layers import fp32_exact

    gen = torch.Generator().manual_seed(0)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for sname, (B, H, W) in SHAPES.items():
            cases = make_cases(dtype, B, H, W, gen)
            for name, (kern, plain, lib, macs, nbytes) in cases.items():
                with fp32_exact():
                    got = kern()
                    torch.cuda.synchronize()
                    ref = plain()
                    d, rel = rel_err(got, ref)
                    # same rounding points: outputs differ at all only where
                    # fp32 summation order flips a bf16 rounding
                    differ = (got != ref).float().mean().item()
                    ok = (bool(torch.isfinite(got.float()).all()) and rel <= TOL[dname]
                          and (dname == "float32" or differ <= MAX_DIFFER_BF16))
                    # the cuDNN yardstick is an independent check (it rounds
                    # bf16 at other points, so it is reported, not held)
                    _, rel_lib = rel_err(got, lib().permute(0, 2, 3, 1))
                    row = {"phase": "kernels", "kernel": name, "dtype": dname,
                           "shape": sname, "lr": [B, H, W], "max_abs_err": d,
                           "rel_err": rel, "tol": TOL[dname], "frac_differ": differ,
                           "rel_err_vs_library": rel_lib,
                           "ok": ok}
                    if sname == "bench":
                        bound = max(2 * macs / PEAK_FLOPS[dname], nbytes / PEAK_BYTES) * 1e3
                        row.update(ms=time_ms(kern), plain_ms=time_ms(plain),
                                   library_ms=time_ms(lib), bound_ms=bound,
                                   bound_by="operations"
                                   if 2 * macs / PEAK_FLOPS[dname] >= nbytes / PEAK_BYTES
                                   else "bytes")
                        report[(name, dname)] = row
                emit(row)
                if not ok:
                    failures.append(f"{name} {dname} {sname}: rel err {rel:.3g}, differ {differ:.3g}")
    return report


# ---------------------------------------------------------------------------
# phase 3: the main path through the CLI
# ---------------------------------------------------------------------------


def main_path(failures, workdir):
    import torch

    from esrganplus_tpu_torch.cli import test_image
    from esrganplus_tpu_torch.convert import rrdbnet_to_state_dict
    from esrganplus_tpu_torch.infer import SRInferencer
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels import tail_ct as T
    from esrganplus_tpu_torch.models import generator_forward
    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig, init_rrdbnet, prep_trunk_ct
    from esrganplus_tpu_torch.ops.image_io import read_img, save_img

    cfg = RRDBNetConfig()  # flagship: nb=23, nf=64, gc=32, ×4, conv1x1
    # init scale 0.5 (not the training default 0.1) keeps the output O(1), so
    # the bf16-vs-fp32 comparison below is not one between near-zero images
    params = init_rrdbnet(cfg, seed=0, init_scale=0.5)
    ckpt = os.path.join(workdir, "flagship_seed0.pth")
    torch.save(rrdbnet_to_state_dict(params, cfg), ckpt)
    lr_dir, out_dir = os.path.join(workdir, "LR"), os.path.join(workdir, "results")
    rng = np.random.RandomState(0)
    sizes = {"a_128x128": (128, 128), "b_96x160": (96, 160), "c_97x131": (97, 131)}
    for name, (h, w) in sizes.items():
        # smooth random content: bilinear blow-up of a coarse random grid
        coarse = rng.rand(h // 8 + 2, w // 8 + 2, 3)
        yy, xx = np.linspace(0, coarse.shape[0] - 1.001, h), np.linspace(0, coarse.shape[1] - 1.001, w)
        y0, x0 = yy.astype(int), xx.astype(int)
        fy, fx = (yy - y0)[:, None, None], (xx - x0)[None, :, None]
        img = ((1 - fy) * ((1 - fx) * coarse[y0][:, x0] + fx * coarse[y0][:, x0 + 1])
               + fy * ((1 - fx) * coarse[y0 + 1][:, x0] + fx * coarse[y0 + 1][:, x0 + 1]))
        save_img((img * 255).round().astype(np.uint8), os.path.join(lr_dir, name + ".png"))

    counted = (K.rdb_ct, K.conv3x3_ct, T.upfold_ct, T.conv_hr_ct)
    for fn in counted:
        fn.launches = 0
    K.rdb_ct.device_launches = 0
    t0 = time.perf_counter()
    test_image.main([ckpt, "--input", lr_dir, "--output", out_dir, "--dtype", "bf16",
                     "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    n = len(sizes)
    for k, per in PER_IMAGE.items():
        if launches[k] != per * n:
            failures.append(f"main path: {k} launched {launches[k]} times, expected {per * n}")
    emit({"phase": "main", "images": n, "seconds_total": seconds, "launches": launches,
          "rdb_ct_device_launches": K.rdb_ct.device_launches})

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
# phase 4: backward kernels against their plain twins (training shape)
# ---------------------------------------------------------------------------


def make_bwd_cases(dtype, gen):
    """Per backward wrapper: (cuda call, plain call, yardstick call, forward
    MACs, bytes, plain call on the twin's own forward buffers or None) on the
    tensors a training step hands it. The yardstick is ``torch.autograd.grad``
    through a cuDNN ``F.conv2d`` graph built once (the port never calls it).
    Also returns rdb_ct's training forward from the kernel and from the twin,
    ``{"out" | "cat" | "lsv": (kernel's, twin's)}``."""
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
        fwd_k = K._rdb_ct_cuda(x, wr, None, noise, sigma=0.1, save=True)
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

    # upfold_ct_bwd: both stages of the ×4 tail
    up = conv_w(NF, NF)
    wf, bf = T.prepare_upfold_ct(up["w"], up["b"], dtype)
    wuo, buo = oihw(up["w"]), up["b"].to(dtype).requires_grad_()
    for tag, mul in (("upfold_ct_bwd", 1), ("upfold_ct_bwd_2nd", 2)):
        xs = act(mul * H, mul * W)
        with fp32_exact():
            out, out_p = T.upfold_ct(xs, wf, bf), T.upfold_ct_plain(xs, wf, bf)
        gs = act(2 * mul * H, 2 * mul * W)
        xsn = nchw(xs).requires_grad_()
        cases[tag] = (
            lambda xs=xs, out=out, gs=gs: T.upfold_ct_bwd(xs, wf, out, gs),
            lambda xs=xs, out=out, gs=gs: T.upfold_ct_bwd_plain(xs, wf, out, gs),
            lib_grad(lambda xsn=xsn: lrelu(F.conv2d(
                F.interpolate(xsn, scale_factor=2, mode="nearest"), wuo, buo, padding=1)),
                [xsn, wuo, buo], gs),
            4 * mul * mul * B * H * W * 4 * NF * NF,
            fbytes(xs, out, gs, xs) + wf.numel() * (esz + 4),
            lambda xs=xs, out_p=out_p, gs=gs: T.upfold_ct_bwd_plain(xs, wf, out_p, gs))

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
    return cases, train_fwd


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

    from esrganplus_tpu_torch.models.layers import fp32_exact

    gen = torch.Generator().manual_seed(1)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        cases, train_fwd = make_bwd_cases(dtype, gen)
        # rdb_ct's training forward: what the backward's masks and products read
        row = {"phase": "kernels-train-fwd", "kernel": "rdb_ct", "dtype": dname,
               "lr": list(TRAIN_SHAPE), "noise_sigma": 0.1, "tol": TOL[dname], "ok": True}
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
                got = kern()
                torch.cuda.synchronize()
                worst, worst_abs, finite = worst_err(got, plain())
                ok = finite and worst <= BWD_TOL[dname]
                own = {}
                if plain_own is not None:
                    own = {"rel_err_own_buffers": worst_err(got, plain_own())[0],
                           "tol_own_buffers": BWD_TOL_OWN_BUFFERS}
                    ok = ok and own["rel_err_own_buffers"] <= BWD_TOL_OWN_BUFFERS
                # backward does the forward's products twice (dx and dW)
                ops_ms = 2 * 2 * macs / PEAK_FLOPS[dname] * 1e3
                bytes_ms = nbytes / PEAK_BYTES * 1e3
                row = {"phase": "kernels-bwd", "kernel": name, "dtype": dname,
                       "lr": list(TRAIN_SHAPE), "max_abs_err": worst_abs,
                       "rel_err": worst, "tol": BWD_TOL[dname], "ok": ok,
                       "ms": time_ms(kern, iters=10), "plain_ms": time_ms(plain, iters=5),
                       "library_ms": time_ms(lib, iters=10),
                       "bound_ms": max(ops_ms, bytes_ms),
                       "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", **own}
                report[(name, dname)] = row
            emit(row)
            if not ok:
                failures.append(f"{name} {dname}: gradient rel err {worst:.3g}"
                                + (f", twin on its own buffers "
                                   f"{own['rel_err_own_buffers']:.3g}" if own else ""))
    return report


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
        "macs": n_out * nw,
        "fwd_bytes": (x.numel() + out.numel() + nw) * esz + 4 * cout,
        # x, g, the saved output and the weights in; dx out; dW and db out in fp32
        "bwd_bytes": ((2 * x.numel() + (1 if act is None else 2) * out.numel() + nw) * esz
                      + 4 * (nw + cout)),
    }


def check_stage_kernels(failures):
    """Phase kernels-stage: conv_s1_ct, conv_s2_ct and their backward wrappers
    against their twins, fp32 (TF32 off) and bf16, at an odd shape and at
    every shape the flagship GAN step gives them (timed there)."""
    import torch

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
            base = {"dtype": dname, "shape": sname, "net": net, "x": [B, H, W, cin],
                    "cout": cout, "act": act}
            with fp32_exact():
                kern, plain, lib = case["fwd"]
                got = kern()
                torch.cuda.synchronize()
                ref = plain()
                d, rel = rel_err(got, ref)
                differ = (got != ref).float().mean().item()
                ok = (bool(torch.isfinite(got.float()).all()) and rel <= TOL[dname]
                      and (dname == "float32" or differ <= MAX_DIFFER_BF16))
                row = {"phase": "kernels-stage", "kernel": kname, **base, "max_abs_err": d,
                       "rel_err": rel, "tol": TOL[dname], "frac_differ": differ,
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
                                    f"rel err {rel:.3g}, differ {differ:.3g}")

                kern, plain, lib, plain_own = case["bwd"]
                got = kern()
                torch.cuda.synchronize()
                worst, worst_abs, finite = worst_err(got, plain())
                ok = finite and worst <= BWD_TOL[dname]
                own = {}
                if plain_own is not None:
                    own = {"rel_err_own_buffers": worst_err(got, plain_own())[0],
                           "tol_own_buffers": BWD_TOL_OWN_BUFFERS}
                    ok = ok and own["rel_err_own_buffers"] <= BWD_TOL_OWN_BUFFERS
                # the half a frozen net launches must give the same dx
                dx_only = case["bwd_dx_only"]()
                ok = ok and dx_only["w"] is None and torch.equal(dx_only["dx"], got["dx"])
                row = {"phase": "kernels-stage", "kernel": kname + "_bwd", **base,
                       "max_abs_err": worst_abs, "rel_err": worst, "tol": BWD_TOL[dname],
                       "ok": bool(ok), **own}
                if sname != "odd":
                    ops_ms = 2 * 2 * case["macs"] / PEAK_FLOPS[dname] * 1e3
                    bytes_ms = case["bwd_bytes"] / PEAK_BYTES * 1e3
                    row.update(ms=time_ms(kern, iters=10), plain_ms=time_ms(plain, iters=5),
                               library_ms=time_ms(lib, iters=10),
                               dx_only_ms=time_ms(case["bwd_dx_only"], iters=10),
                               bound_ms=max(ops_ms, bytes_ms),
                               bound_by="operations" if ops_ms >= bytes_ms else "bytes")
                    report[(kname + "_bwd", sname, dname)] = row
                emit(row)
                if not ok:
                    failures.append(f"{kname}_bwd {dname} {sname} {cin}->{cout} act={act}: "
                                    f"gradient rel err {worst:.3g} {own}")
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
        l_k, g_k = run(cfg, dtype)
        per_leaf = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                    for (n, _), a, b in zip(named, g_k, g_ref)}
        worst = max(per_leaf, key=per_leaf.get)
        cos = torch.nn.functional.cosine_similarity(flat(g_k), flat(g_ref), dim=0).item()
        row = {"phase": "train-check", "dtype": dname, "loss_plain_fp32": l_ref,
               "loss_kernel": l_k, "loss_rel_err": abs(l_k - l_ref) / abs(l_ref),
               "grad_worst_leaf": worst, "grad_worst_rel_err": per_leaf[worst],
               "grad_cosine": cos, "leaves": len(named),
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
        row["ok"] = bool(ok and row["finite"])
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
           "l_pix": losses, "finite": finite, "files": files,
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
            g_total, fake, logs = t._g_loss(g_params, frozen, x, hr, None, real[0].detach(),
                                            noise=noise)
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
    for dname, dtype in (("float32", None), ("bfloat16", "bfloat16")):
        for fn in counted:
            fn.launches = 0
        t_k, gg_k, dg_k = run("auto", dtype)
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
        # the check itself must have gone through every stage kernel
        ok = ok and all(row["launches"][k] == n
                        for k, n in {**GAN_FWD_PER_STEP, **GAN_BWD_PER_STEP}.items())
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
    t0 = time.perf_counter()
    train_cli.main(["-opt", opt_path, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
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
           "launches": launches, "expected_launches": expected, "logged": logged,
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


def train_profile(step_ms, make_trainer=None, phase="train-profile"):
    """``--profile`` only: ``torch.profiler`` over three steady training steps
    (bf16, batch 16; the PSNR trainer, or the one ``make_trainer`` builds):
    device time per step by kernel family, and the card's
    busy share of an untraced step (``step_ms``, train-steady's median; the
    traced steps themselves are slowed by the profiler). Reports; holds
    nothing."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig
    from esrganplus_tpu_torch.train import SRTrainConfig, SRTrainer

    B, H, W = TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(9)
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
        name = re.sub(r"\(anonymous namespace\)::|^void ", "", e.name)
        name = re.split(r"[<(]", name)[0].split("::")[-1] or e.name
        fam[name] += e.time_range.elapsed_us() / 1e3 / steps
        count[name] += 1
    busy = sum(fam.values())
    emit({"phase": phase, "steps": steps, "wall_ms_per_step_traced": wall_ms,
          "untraced_ms_per_step": step_ms, "device_ms_per_step": busy,
          "device_busy_share": busy / step_ms, "device_idle_share": 1 - busy / step_ms,
          "device_launches_per_step": sum(count.values()) / steps,
          "by_kernel_ms_per_step": {k: round(v, 4) for k, v in fam.most_common(20)},
          "launches_per_step": {k: count[k] / steps for k, _ in fam.most_common(20)}})


# ---------------------------------------------------------------------------
# the nESRGAN+ slice: the fused noise mode (rdb_ct / rdb_ct_bwd drawing and
# replaying the noise from a site's seed words) and the 9-tap RDB (rdb_t)
# ---------------------------------------------------------------------------


def _rdb_params(gen):
    """One flagship-width RDB (nf=64, gc=32, conv1x1), HWIO, on the card."""
    import torch

    rnd = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen) * scale).to("cuda")
    p = {f"conv{k}": {"w": rnd(3, 3, NF + (k - 1) * GC, NF if k == 5 else GC,
                               scale=(2.0 / (9 * (NF + (k - 1) * GC))) ** 0.5),
                      "b": rnd(NF if k == 5 else GC, scale=0.1)} for k in range(1, 6)}
    p["conv1x1"] = {"w": rnd(1, 1, NF, GC, scale=(2.0 / NF) ** 0.5)}
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
    the same inputs."""
    import torch

    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.kernels.philox import philox_normal, philox_normal_cuda
    from esrganplus_tpu_torch.models.layers import fp32_exact

    B, H, W = TRAIN_SHAPE
    shape = (B, H, W, NF)
    got = philox_normal_cuda(NOISE_SEED, shape)
    torch.cuda.synchronize()
    errs = {dev: (got.cpu() - philox_normal(NOISE_SEED, shape, dev).cpu()).abs().max().item()
            for dev in ("cpu", "cuda")}
    row = {"phase": "kernels-noise", "kernel": "philox_normal", "shape": list(shape),
           "max_abs_err_vs_twin": errs, "tol": PHILOX_TOL,
           "mean": got.mean().item(), "std": got.std().item(),
           "ms": time_ms(lambda: philox_normal_cuda(NOISE_SEED, shape)),
           "plain_ms": time_ms(lambda: philox_normal(NOISE_SEED, shape, "cuda"), iters=5)}
    row["ok"] = bool(torch.isfinite(got).all() and max(errs.values()) <= PHILOX_TOL)
    emit(row)
    if not row["ok"]:
        failures.append(f"philox_normal_cuda: {row}")

    gen = torch.Generator().manual_seed(12)
    p = _rdb_params(gen)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        wr = K.prepare_rdb_ct_weights(p, dtype)
        act = lambda: torch.randn(shape, generator=gen).to("cuda", dtype)
        x, noise, g = act(), act(), act()
        kw = dict(seed=NOISE_SEED, sigma=NOISE_SIGMA)
        with fp32_exact():
            fwd_k = K._rdb_ct_cuda(x, wr, save=True, **kw)
            torch.cuda.synchronize()
            fwd_p = K._rdb_ct_train_plain(x, wr, **kw)
        row = {"phase": "kernels-noise", "kernel": "rdb_ct", "mode": "fused", "dtype": dname,
               "lr": list(TRAIN_SHAPE), "noise_sigma": NOISE_SIGMA, "tol": TOL[dname]}
        ok = True
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
            seed = None if detach else NOISE_SEED
            with fp32_exact():
                got = K.rdb_ct_bwd(x, wr, cat, lsv, g, seed=seed, sigma=NOISE_SIGMA)
                again = K.rdb_ct_bwd(x, wr, cat, lsv, g, seed=seed, sigma=NOISE_SIGMA)
                torch.cuda.synchronize()
                want = K.rdb_ct_bwd_plain(x, wr, cat, lsv, g, seed=seed, sigma=NOISE_SIGMA)
            worst, worst_abs, finite = worst_err(got, want)
            bit_equal = all(got[k] is None or torch.equal(got[k], again[k]) for k in got)
            row = {"phase": "kernels-noise", "kernel": "rdb_ct_bwd",
                   "mode": "fused_detach" if detach else "fused", "dtype": dname,
                   "lr": list(TRAIN_SHAPE), "max_abs_err": worst_abs, "rel_err": worst,
                   "tol": BWD_TOL[dname], "bit_equal_second_call": bit_equal}
            row["ok"] = bool(finite and worst <= BWD_TOL[dname] and bit_equal)
            if not detach:
                input_ms, fused_ms = _interleaved(
                    lambda: K.rdb_ct_bwd(x, wr, cat, lsv, g, noise, sigma=NOISE_SIGMA),
                    lambda: K.rdb_ct_bwd(x, wr, cat, lsv, g, seed=NOISE_SEED,
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
    of stages 1–4 and the 1×1)."""
    import torch

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
                    got = kern()
                    torch.cuda.synchronize()
                    ref = plain()
                    d, rel = rel_err(got, ref)
                    differ = (got != ref).float().mean().item()
                    ok = (bool(torch.isfinite(got.float()).all()) and rel <= TOL[dname]
                          and (dname == "float32" or differ <= MAX_DIFFER_BF16))
                    row = {**base, "kernel": "rdb_t" if tag == "fwd" else "rdb_t_fold",
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
                            report[("rdb_t", sname, dname)] = row
                    emit(row)
                    if not ok:
                        failures.append(f"{row['kernel']} {dname} {sname}: rel err {rel:.3g}, "
                                        f"differ {differ:.3g}")

                kern, plain, lib = case["bwd"]
                got = kern()
                again = kern()
                torch.cuda.synchronize()
                want = plain()
                names = ("dx", "w1", "w2", "w3", "w4", "w5", "w11", "b")
                worst, worst_abs, finite = worst_err(dict(zip(names, got)),
                                                     dict(zip(names, want)))
                bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
                ok = finite and worst <= BWD_TOL[dname] and bit_equal
                row = {**base, "kernel": "rdb_t_bwd", "max_abs_err": worst_abs, "rel_err": worst,
                       "tol": BWD_TOL[dname], "bit_equal_second_call": bit_equal, "ok": bool(ok)}
                if sname != "odd":
                    ops_ms = 2 * case["bwd_macs"] / PEAK_FLOPS[dname] * 1e3
                    bytes_ms = case["bwd_bytes"] / PEAK_BYTES * 1e3
                    row.update(ms=time_ms(kern, iters=10), plain_ms=time_ms(plain, iters=3),
                               library_ms=time_ms(lib, iters=10), bound_ms=max(ops_ms, bytes_ms),
                               bound_by="operations" if ops_ms >= bytes_ms else "bytes")
                    report[("rdb_t_bwd", sname, dname)] = row
            emit(row)
            if not ok:
                failures.append(f"rdb_t_bwd {dname} {sname}: gradient rel err {worst:.3g}, "
                                f"bit-equal {bit_equal}")
    return report


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

    R.rdb_t.launches = R.rdb_t_bwd.launches = 0
    loss_k, g_k = run(lambda h, ws: R.rdb_t_diff(h, *ws), torch.bfloat16)
    torch.cuda.synchronize()
    launches = {"rdb_t": R.rdb_t.launches, "rdb_t_bwd": R.rdb_t_bwd.launches}
    loss_p, g_p = run(lambda h, ws: R.rdb_t_plain(h, *ws), torch.float32)
    flat = lambda gs: torch.cat([t.flatten() for t in gs])
    cos = torch.nn.functional.cosine_similarity(flat(g_k), flat(g_p), dim=0).item()
    row = {"phase": "rdb-t-path", "lr": list(TRAIN_SHAPE), "dtype": "bfloat16", "blocks": 3,
           "loss_kernel": loss_k, "loss_plain_fp32": loss_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p), "grad_cosine": cos,
           "launches": launches, "tol_loss": 2e-2, "tol_cosine": 0.999,
           "finite": all(bool(torch.isfinite(t).all()) for t in g_k)}
    row["ok"] = bool(row["finite"] and row["loss_rel_err"] <= 2e-2 and cos >= 0.999
                     and launches == {"rdb_t": 3, "rdb_t_bwd": 3})
    emit(row)
    if not row["ok"]:
        failures.append(f"rdb-t-path: {row}")
    return launches


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
    bwd_report = check_bwd_kernels(failures)
    noise_report = check_noise_kernels(failures)
    train_check(failures)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        train_launches = train_path(failures, tmp)
    input_steady = train_steady(failures)
    step_ms = input_steady[0]
    fused_step_ms = train_fused(failures, workdir, input_steady)
    rdb_t_report = check_rdb_t_kernels(failures)
    rdb_t_launches = rdb_t_path(failures)
    stage_report = check_stage_kernels(failures)
    gan_check(failures)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        gan_launches = gan_train_path(failures, tmp)
    gan_step_ms = gan_steady(failures)
    if "--profile" in sys.argv[1:]:
        train_profile(step_ms)
        train_profile(fused_step_ms, _fused_trainer, "train-fused-profile")
        train_profile(gan_step_ms, _gan_trainer, "gan-profile")

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
        if name == "rdb_ct":  # the training forward at batch 16, 32×32: fused beside input
            fused = noise_report[("rdb_ct", "bfloat16")]
            kernels[-1].update(fused_ms=fused["fused_ms"], fused_input_ms=fused["input_ms"],
                               fused_rel_err=fused["out"]["rel_err"],
                               fused_fp32_rel_err=noise_report[("rdb_ct", "float32")]["out"]
                               ["rel_err"], fused_lr=list(TRAIN_SHAPE))
    for name in BWD_PER_STEP:
        row = bwd_report[(name, "bfloat16")]
        k = {"name": name, "route": "cuda", "source": BWD_SOURCE,
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
        if name == "upfold_ct_bwd":  # the 2nd stage (64² → 128²) beside the 1st
            second = bwd_report[("upfold_ct_bwd_2nd", "bfloat16")]
            k.update({f"second_call_{f}": second[f]
                      for f in ("ms", "plain_ms", "bound_ms", "library_ms", "rel_err")})
        kernels.append(k)
    for name in STAGE_REPLACES:
        # one shape's numbers in the required keys, every flagship shape beside them
        row = stage_report[(name, STAGE_MAIN_SHAPE[name], "bfloat16")]
        fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                  "rel_err") + (("dx_only_ms",) if name.endswith("_bwd") else ())
        kernels.append({
            "name": name, "route": "cuda", "source": STAGE_SOURCE,
            "replaces": STAGE_REPLACES[name], "launches": gan_launches[name],
            "max_abs_err": row["max_abs_err"], "rel_err": row["rel_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "dtype": "bfloat16", "shape": STAGE_MAIN_SHAPE[name], "x": row["x"],
            "cout": row["cout"],
            "fp32_ms": stage_report[(name, STAGE_MAIN_SHAPE[name], "float32")]["ms"],
            "shapes": {sname: {**{f: r[f] for f in fields},
                               "fp32_ms": stage_report[(kn, sname, "float32")]["ms"]}
                       for (kn, sname, dn), r in stage_report.items()
                       if kn == name and dn == "bfloat16"}})
    for name in RDB_T_REPLACES:
        row = rdb_t_report[(name, RDB_T_MAIN_SHAPE, "bfloat16")]
        fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                  "rel_err")
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
    sys.exit(main())
