#!/usr/bin/env python3
"""Measure the bf16 dense-stage kernel's stage-5 split and its per-tap
partial sums against the alternatives, on an NVIDIA GPU:

    python3 tools/dense_variants.py

``csrc/dense_conv.cuh`` (``dmma``) keeps a block's weights resident in
shared memory. Stage 5's (221 KB at the flagship's widths) fit no block
beside its tile slots, so ``plan`` gives each block a part of the outputs:
the largest part that fits, 32 at 8-column tiles (two blocks a tile). Each
tap's product over a slice of at most 192 channels is a wgmma chain from
zero, joined to the fp32 total by a round-to-nearest add. This rebuilds
``csrc/rdb_ct.cu`` by nvcc into ``build/tools/`` with one of them changed,
and runs ``rdb_ct`` on each build:

* ``shipped``: the kernel as it is;
* ``split16``: a split stage takes 16 outputs a block at 16-column tiles
  (four blocks a tile, more columns a tile);
* ``chained``: every tap's chain onto the running sum (no per-tap partial).

For each build it prints the C plan of stage 5 at the div2k_sr cell's
commonest photo (B = 1, 339×510) and at the training shape (B = 16, 32²),
the share of the training forward's outputs (out, x1..x4, l2|l4) that
differ from the plain twin (cuDNN fp32, the 1 % bar) and from the twin's
graph in float64 (``rdb_ct_fp64``) at the flagship's widths and at gc =
64, whether its output equals the shipped build's bit for bit, and then
``rdb_ct``'s and its stage-5 launch's times on the card alone
(``chip_smoke.device_ms``) at both shapes, builds in turns (ABBA). One JSON
line per case after the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# dmma::plan's test of a part that fits, which split16 narrows
PLAN_FIT = "    if (!fit16 && smem_bytes(8, nb, NWG, ng, gx, s11) > MAX_SMEM) continue;\n"
SPLIT16 = ("    if (!fit16 && (nb < cout || smem_bytes(8, nb, NWG, ng, gx, s11) > MAX_SMEM))"
           " continue;\n")
# the consumer's taps, each a chain from zero joined to the total, which
# chained replaces by chains onto the total
TAPS = """      issue(0, part0);
#pragma unroll 1
      for (int t = 1; t < 9; t += 2) {
        issue(t, part1);
        esr::hopper::wgmma_wait<1>();
        join(part0);
        issue(t + 1, part0);
        esr::hopper::wgmma_wait<1>();
        join(part1);
      }
      esr::hopper::wgmma_wait<0>();
      join(part0);
"""
CHAINED = """#pragma unroll 1
      for (int t = 0; t < 9; ++t) {
        issue(t, acc);
        esr::hopper::wgmma_wait<0>();
      }
"""
# the first k-step's scale-d of a tap's chain (0: from zero), 1 in chained
FIRST = """              Wgmma<NB>::mma(P[mb], dam + k * gbu + 2 * h, db + tb + (4 * k + 2 * h) * chu,
                             k + h);
"""
VARIANTS = {
    "shipped": [],
    "split16": [(PLAN_FIT, SPLIT16)],
    "chained": [(TAPS, CHAINED), (FIRST, FIRST.replace("k + h);", "1);"))],
}


def variant(name: str, header: str) -> str:
    """``csrc/dense_conv.cuh``'s text with the variant ``name``'s changes."""
    for old, new in VARIANTS[name]:
        if header.count(old) != 1:
            raise ValueError(f"csrc/dense_conv.cuh changed where {name} patches it: "
                             "update tools/dense_variants.py")
        header = header.replace(old, new)
    return header


def _build(name, build):
    """The rdb_ct library of variant ``name`` under build/tools/dense_<name>/."""
    import shutil

    d = os.path.join(ROOT, "build", "tools", f"dense_{name}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build.CSRC, os.path.join(d, "csrc"))
    hdr = os.path.join(d, "csrc", "dense_conv.cuh")
    with open(hdr) as f:
        text = variant(name, f.read())
    with open(hdr, "w") as f:
        f.write(text)
    out = os.path.join(d, "librdb_ct.so")
    return out, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", os.path.join(d, "csrc"),
                                  "-o", out, os.path.join(d, "csrc", "rdb_ct.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("dense_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from esrganplus_tpu_torch.kernels import build
    from esrganplus_tpu_torch.kernels import launch as L
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.models.layers import fp32_exact

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    procs = {n: _build(n, build) for n in VARIANTS}
    libs = {}
    nsm = L.sm_count(torch.cuda.current_device())
    shapes = {"photo": (1, 339, 510), "train": (16, 32, 32)}
    for n, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {n}:\n{log[-3000:]}")
        lib = ctypes.CDLL(out)
        for fn, argtypes in build.SIGNATURES["rdb_ct"].items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
        libs[n] = lib
        plans = {}
        for s, (B, H, W) in shapes.items():
            p = (ctypes.c_int * 7)()
            lib.esr_dense_plan(64, 192, 64, L.RESID, B, H, W, nsm, p)
            plans[s] = dict(zip(L.DensePlan._fields + ("weight_bytes",), p))
        print(json.dumps({"variant": n, "stage5_plan": plans,
                          "ptxas": [line for line in C.ptxas_summary(log)
                                    if "dense_mma_kernel" in line][:8]}), flush=True)

    def use(n):
        build._libs["rdb_ct"] = libs[n]

    def params(rs, nf, gc):
        conv = lambda cin, cout: {
            "w": torch.from_numpy((rs.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin)))
                                  .astype(np.float32)).cuda(),
            "b": torch.from_numpy((rs.randn(cout) * 0.1).astype(np.float32)).cuda()}
        p = {f"conv{k}": conv(nf + (k - 1) * gc, nf if k == 5 else gc) for k in range(1, 6)}
        p["conv1x1"] = {"w": torch.from_numpy((rs.randn(1, 1, nf, gc) * np.sqrt(2.0 / nf))
                                              .astype(np.float32)).cuda()}
        return K.prepare_rdb_ct_weights(p, torch.bfloat16)

    share = lambda got, want: {k: (a != b).float().mean().item()
                               for k, a, b in zip(("out", "cat", "lsv"), got, want)}
    cases = [(64, 32, "odd"), (64, 32, "train"), (64, 32, "photo"), (64, 64, "odd"),
             (16, 64, "odd")]
    for nf, gc, sname in cases:
        rs = np.random.RandomState(100 * nf + gc)
        B, H, W = shapes.get(sname) or C.SHAPES[sname]
        w = params(rs, nf, gc)
        x = torch.from_numpy(rs.rand(B, H, W, nf).astype(np.float32)).to("cuda", torch.bfloat16)
        row = {"nf": nf, "gc": gc, "shape": [B, H, W]}
        with fp32_exact():
            twin = K._rdb_ct_train_plain(x, w)
            exact = K.rdb_ct_fp64(x, w)
            row["twin_vs_fp64"] = share(twin, exact)
            ship = None
            for n in VARIANTS:
                use(n)
                got = K._rdb_ct_cuda(x, w, save=True)
                ship = got if n == "shipped" else ship
                row[n] = {"vs_twin": share(got, twin), "vs_fp64": share(got, exact),
                          "bit_equal_shipped": all(torch.equal(a, b) for a, b in zip(got, ship))}
        print(json.dumps(row), flush=True)

    for sname, (B, H, W) in shapes.items():
        rs = np.random.RandomState(7)
        w = params(rs, 64, 32)
        x, res = (torch.from_numpy(rs.rand(B, H, W, 64).astype(np.float32)).to(
            "cuda", torch.bfloat16) for _ in range(2))
        times = {n: {"rdb_ct": [], "stage5": []} for n in VARIANTS}
        for n in list(VARIANTS) + list(VARIANTS)[::-1]:
            use(n)  # the steps take the library in use when they are made
            stage5 = K.rdb_ct_steps(x, w, res, rrdb_scale=0.2)[0]["stage5"]
            times[n]["rdb_ct"].append(C.device_ms(lambda: K.rdb_ct(x, w, res, rrdb_scale=0.2)))
            times[n]["stage5"].append(C.device_ms(stage5))
        print(json.dumps({"times_card_alone_ms": times, "lr": [B, H, W]}), flush=True)
    use("shipped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
