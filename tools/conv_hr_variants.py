#!/usr/bin/env python3
"""Time conv_hr_ct's bf16 tensor-core design (two launches: the stage forward
writes conv0's activation, ``conv_hr_out_mma_kernel`` reads it back) against
the one-launch alternative in ``tools/conv_hr_fused.cu`` (conv0 over the
haloed tile kept in shared memory, 8 or 16 output rows a block), on an
NVIDIA GPU:

    python3 tools/conv_hr_variants.py

Builds the alternative with nvcc into ``build/tools/``, holds each variant
against the plain twin (max|Δ| of max|ref| and the share of outputs that
differ) at the flagship widths (64 → 64 → 3) on the inference shape (B=1,
512² HR) and the training shape (B=16, 128² HR), times them in turns with
CUDA events (two-launch, fused 8, fused 16, then back), and prints one JSON
line per shape after the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("conv_hr_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms
    from esrganplus_tpu_torch.kernels import build
    from esrganplus_tpu_torch.kernels import tail_ct as T
    from esrganplus_tpu_torch.models.layers import fp32_exact

    out_dir = os.path.join(ROOT, "build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libconv_hr_fused.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", so,
                    os.path.join(HERE, "conv_hr_fused.cu")], check=True)
    lib = ctypes.CDLL(so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.esr_conv_hr_fused.argtypes = [I, P, P, P, P, P, P, I, I, I, I, F, P]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)

    gen = torch.Generator().manual_seed(0)
    dt, nf, co2 = torch.bfloat16, 64, 3
    rnd = lambda *s, scale=1.0: (torch.randn(s, generator=gen) * scale).cuda()
    for name, (B, H, W) in (("bench", (1, 512, 512)), ("train", (16, 128, 128))):
        w0, b0, w1, b1 = T.prepare_conv_hr_ct(
            {"w": rnd(3, 3, nf, nf, scale=(2 / (9 * nf)) ** 0.5), "b": rnd(nf, scale=0.1)},
            {"w": rnd(3, 3, nf, co2, scale=(2 / (9 * nf)) ** 0.5), "b": rnd(co2, scale=0.1)}, dt)
        x = torch.rand((B, H, W, nf), generator=gen).to("cuda", dt)
        with fp32_exact():
            ref = T.conv_hr_ct_plain(x, w0, b0, w1, b1)
        outs = {}

        def fused(oth):
            out = outs.setdefault(oth, torch.empty_like(ref))
            build.check(lib.esr_conv_hr_fused(oth, x.data_ptr(), w0.data_ptr(), b0.data_ptr(),
                                              w1.data_ptr(), b1.data_ptr(), out.data_ptr(), co2,
                                              B, H, W, 0.2,
                                              torch.cuda.current_stream().cuda_stream),
                        "esr_conv_hr_fused")
            return out

        variants = {"two_launch": lambda: T.conv_hr_ct(x, w0, b0, w1, b1),
                    "fused_8": lambda: fused(8), "fused_16": lambda: fused(16)}
        row = {"shape": name, "hr": [B, H, W]}
        for k, fn in variants.items():
            got = fn()
            torch.cuda.synchronize()
            d = (got.float() - ref.float()).abs().max().item()
            row[k] = {"rel_err": d / max(1.0, ref.float().abs().max().item()),
                      "frac_differ": (got != ref).float().mean().item(), "ms": []}
        for k in list(variants) + list(variants)[::-1]:  # in turns
            row[k]["ms"].append(time_ms(variants[k]))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
