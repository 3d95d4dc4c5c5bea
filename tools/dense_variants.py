#!/usr/bin/env python3
"""Measure what the bf16 tensor-core dense-stage kernel's accumulation costs
and buys, on an NVIDIA GPU:

    python3 tools/dense_variants.py

``csrc/dense_conv.cuh`` (``tap_mma``) sums each ring stage (a tap's K, at
most 192 channels: 12 k-steps) from zero with ``mma.sync``'s own
accumulation and joins the running fp32 sum by a round-to-nearest add. This
rebuilds ``csrc/rdb_ct.cu`` by nvcc into ``build/tools/`` with that join
replaced, and runs ``rdb_ct`` on each build:

* ``stage``: the kernel as it is;
* ``chained``: every k-step's mma chained onto the running sum over the
  whole K (1728 at the flagship's stage 5);
* ``kstep``: every k-step from zero, joined by a round-to-nearest add;
* ``twosum``: each pair of k-steps from zero, joined by an error-free TwoSum
  (``csrc/workbench_rdb.cu``'s fold), the stage's (sum, error) pair added
  once at its end;
* ``split``: A's bf16 values split into their top 4 significant bits and
  the rest (both exact bf16s, so each product has 12 bits), every k-step's
  two products from zero, joined by a round-to-nearest add;

and the FMA design (``kind="fma"``, the CUDA cores) on the same bf16 inputs.
For the training forward's out, x1..x4 and l2|l4 it prints the share of
entries that differ from the plain twin (cuDNN fp32, the 1 % bar) and from
the twin's graph summed in float64 (``rdb_ct_fp64``), at the flagship widths
(nf=64, gc=32, the 1×1 on) on ``chip_smoke.py``'s odd, bench and train
shapes with uniform and normal activations, and at nf=16, 32, 64 with
gc=64 on the odd shape; then each build's ``rdb_ct`` and ``conv3x3_ct`` (64
→ 64) time at B=1, 128² on the card alone (``chip_smoke.device_ms``), in
turns. One JSON line per case after the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the shipped stage join in tap_mma, which each variant replaces
STAGE_JOIN = """    float part[Tl::MT][Tl::NT8][4] = {};  // the stage's own sum
    warp_mma<Tl::MT, Tl::NT8, KN>(part, a, ws + (s % NSLOT) * slot, wpitch, wn * Tl::NT8 * 8,
                                  rows(wc), lane);
#pragma unroll
    for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
      for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = __fadd_rn(acc[i][j][r], part[i][j][r]);
"""
CALL = ("    variant_join<Tl::MT, Tl::NT8, KN>(acc, a, ws + (s % NSLOT) * slot, wpitch,\n"
        "                                      wn * Tl::NT8 * 8, rows(wc), lane);\n")
ANCHOR = "template <int NP, bool KN, typename StageX, typename LoadW, typename After>"
HEAD = """template <int MT, int NT8, bool KN>
__device__ __forceinline__ void variant_join(float (&acc)[MT][NT8][4], const uint32_t (&a)[MT],
                                             uint32_t bt, int bp, int n0, int klen, int lane) {
"""
# acc += the k-steps [k, k + len) from zero (a fresh partial)
STEP = """  auto fresh = [&](float (&part)[MT][NT8][4], int k, int len) {
    uint32_t ak[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) ak[i] = a[i] + k * 2;
    warp_mma<MT, NT8, KN>(part, ak, KN ? bt + k * bp : bt + k * 2, bp, n0, len, lane);
  };
"""
FOR_EACH = ("#pragma unroll\n  for (int i = 0; i < MT; ++i)\n#pragma unroll\n"
            "    for (int j = 0; j < NT8; ++j)\n#pragma unroll\n      for (int r = 0; r < 4; ++r) ")
BODIES = {
    "chained": "  warp_mma<MT, NT8, KN>(acc, a, bt, bp, n0, klen, lane);\n",
    "kstep": STEP + "  for (int k = 0; k < klen; k += 16) {\n"
             "    float part[MT][NT8][4] = {};\n    fresh(part, k, 16);\n"
             "  " + FOR_EACH + "acc[i][j][r] = __fadd_rn(acc[i][j][r], part[i][j][r]);\n  }\n",
    "twosum": STEP + "  float lo[MT][NT8][4] = {};\n"
              "  for (int k = 0; k < klen; k += 32) {\n"
              "    float part[MT][NT8][4] = {};\n    fresh(part, k, min(32, klen - k));\n"
              "  " + FOR_EACH + "{\n"
              "          const float d = part[i][j][r], s = __fadd_rn(acc[i][j][r], d);\n"
              "          const float bb = __fsub_rn(s, acc[i][j][r]);\n"
              "          lo[i][j][r] = __fadd_rn(lo[i][j][r], __fadd_rn(__fsub_rn(acc[i][j][r],"
              " __fsub_rn(s, bb)), __fsub_rn(d, bb)));\n"
              "          acc[i][j][r] = s;\n        }\n  }\n"
              + FOR_EACH + "acc[i][j][r] = __fadd_rn(acc[i][j][r], lo[i][j][r]);\n",
    "split": """  using namespace esr::mma;
  for (int k = 0; k < klen; k += 16) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      ldsm_x4(ah[i], a[i] + k * 2);
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // hi: sign, exponent, 3 mantissa bits; lo = x - hi exactly
        const uint32_t x = ah[i][r], h = x & 0xFFF0FFF0u;
        const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                                         *reinterpret_cast<const __nv_bfloat162*>(&h));
        al[i][r] = *reinterpret_cast<const uint32_t*>(&d);
        ah[i][r] = h;
      }
    }
    float part[MT][NT8][4] = {};
    if constexpr (NT8 == 1) {
      uint32_t b[2];
      const int l = lane & 15;
      if constexpr (KN) ldsm_x2_t(b, bt + (k + l) * bp + n0 * 2);
      else ldsm_x2(b, bt + (n0 + (l & 7)) * bp + (k + (l >> 3) * 8) * 2);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(part[i][0], ah[i], b[0], b[1]);
        mma_bf16(part[i][0], al[i], b[0], b[1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT8; j += 2) {
        uint32_t b[4];
        if constexpr (KN)
          ldsm_x4_t(b, bt + (k + (lane & 15)) * bp + (n0 + j * 8 + (lane >> 4) * 8) * 2);
        else
          ldsm_x4(b, bt + (n0 + j * 8 + (lane & 7) + (lane >> 4) * 8) * bp +
                         (k + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(part[i][j], ah[i], b[0], b[1]);
          mma_bf16(part[i][j], al[i], b[0], b[1]);
          mma_bf16(part[i][j + 1], ah[i], b[2], b[3]);
          mma_bf16(part[i][j + 1], al[i], b[2], b[3]);
        }
      }
    }
  """ + FOR_EACH + "acc[i][j][r] = __fadd_rn(acc[i][j][r], part[i][j][r]);\n  }\n",
}
VARIANTS = ("stage",) + tuple(BODIES)


def variant(name: str, header: str) -> str:
    """``csrc/dense_conv.cuh``'s text with tap_mma's stage join replaced by
    the variant ``name`` (``"stage"``: unchanged)."""
    if name == "stage":
        return header
    if header.count(STAGE_JOIN) != 1 or header.count(ANCHOR) != 1:
        raise ValueError("csrc/dense_conv.cuh's stage join changed: update tools/dense_variants.py")
    fn = HEAD + BODIES[name] + "}\n\n"
    return header.replace(STAGE_JOIN, CALL).replace(ANCHOR, fn + ANCHOR)


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
    from esrganplus_tpu_torch.kernels import rdb_ct as K
    from esrganplus_tpu_torch.models.layers import fp32_exact

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    procs = {n: _build(n, build) for n in VARIANTS}
    libs = {}
    for n, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {n}:\n{log[-3000:]}")
        lib = ctypes.CDLL(out)
        for fn, argtypes in build.SIGNATURES["rdb_ct"].items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
        libs[n] = lib
        print(json.dumps({"variant": n, "ptxas": [line for line in C.ptxas_summary(log)
                                                  if "dense_mma_kernel<32,0" in line
                                                  or "dense_mma_kernel<64,3" in line]}))

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
    cases = [(64, 32, s) for s in C.SHAPES] + [(nf, 64, "odd") for nf in (16, 32, 64)]
    for nf, gc, sname in cases:
        for dist in ("rand", "randn"):
            rs = np.random.RandomState(100 * nf + gc)
            B, H, W = C.SHAPES[sname]
            w = params(rs, nf, gc)
            x = torch.from_numpy(getattr(rs, dist)(B, H, W, nf).astype(np.float32)).to(
                "cuda", torch.bfloat16)
            row = {"nf": nf, "gc": gc, "shape": sname, "x": dist}
            with fp32_exact():
                twin = K._rdb_ct_train_plain(x, w)
                exact = K.rdb_ct_fp64(x, w)
                row["twin_vs_fp64"] = share(twin, exact)
                for n in VARIANTS:
                    use(n)
                    got = K._rdb_ct_cuda(x, w, save=True)
                    row[n] = {"vs_twin": share(got, twin), "vs_fp64": share(got, exact)}
                use("stage")
                got = K._rdb_ct_cuda(x, w, save=True, kind="fma")
                row["fma"] = {"vs_twin": share(got, twin), "vs_fp64": share(got, exact)}
            print(json.dumps(row), flush=True)

    rs = np.random.RandomState(7)
    B, H, W = C.SHAPES["bench"]
    w = params(rs, 64, 32)
    x, res = (torch.from_numpy(rs.rand(B, H, W, 64).astype(np.float32)).to("cuda", torch.bfloat16)
              for _ in range(2))
    wc, bc = K.prepare_conv_ct_weights(
        torch.from_numpy((rs.randn(3, 3, 64, 64) * 0.06).astype(np.float32)).cuda(),
        torch.zeros(64, device="cuda"), torch.bfloat16)
    times = {n: {"rdb_ct": [], "conv3x3_ct": []} for n in VARIANTS}
    for n in VARIANTS + VARIANTS[::-1]:
        use(n)
        times[n]["rdb_ct"].append(C.device_ms(lambda: K.rdb_ct(x, w, res, rrdb_scale=0.2)))
        times[n]["conv3x3_ct"].append(C.device_ms(lambda: K.conv3x3_ct(x, wc, bc, res)))
    print(json.dumps({"times_card_alone_ms": times, "lr": [B, H, W]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
