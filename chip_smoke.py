#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero without the
final result line:

  1. build   — compile every kernel source (esrganplus_tpu_torch/csrc/*.cu,
               one nvcc per source, in parallel) and print ptxas -v lines;
  2. kernels — each CUDA kernel against its plain PyTorch twin at flagship
               widths (nf=64, gc=32) on an odd shape (B=2, 37×53 LR) and the
               main path's shape (B=1, 128×128 LR), fp32 (TF32 off) and bf16;
               CUDA-event times of the kernel, the twin and a PyTorch
               yardstick (cuDNN convolutions), and the bound for the work;
  3. main    — flagship ESRGAN+ ×4 (nb=23, nf=64, gc=32) with seeded random
               weights exported to a .pth, through the port's test_image CLI
               on three PNGs in bf16; checks output shapes, the kernels'
               launch counts per image, and the bf16 kernel path against the
               fp32 plain path (and the fp32 kernel path) on the card; then
               the small golden ESRGAN+ checkpoint (tests/golden) through the
               kernel path against the reference implementation's output.

Then one ``{"kernels": [...]}`` line, the card's name and power limit, and
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
SHAPES = {"odd": (2, 37, 53), "bench": (1, 128, 128)}  # (B, H, W) of the LR image
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
        m = re.search(r"(dense_conv3x3_kernel|upfold_kernel|conv_hr_kernel)I(\w+?)EE", line)
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
                        "fp32_max_abs_err": report[(name, "float32")]["max_abs_err"]})
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
