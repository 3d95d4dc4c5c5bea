#!/usr/bin/env python3
"""Measure what the bf16 tensor-core ``rdb_fused`` design's accumulation
costs and buys, on an NVIDIA GPU:

    python3 tools/wb_rdb_variants.py

At the flagship widths (nf=64, gc=32, the 1×1 on), on twelve seeded cases at
B=2, 40×24 (the weights and inputs of ``tests/test_torch_cuda.py``'s
flagship-width case, RandomState 3..14) and on ``chip_smoke.py``'s inference
(B=1, 128²) and training (B=16, 32²) cases, each output's share of entries
that differ from the plain twin (cuDNN fp32, the 1 % bar) and from an fp64
reference with the same rounding points, for:

* ``kernel``: ``csrc/workbench_rdb.cu`` as it is (each pair of k-steps from
  zero, folded into the partial by TwoSum), at both of its tiles (held
  bit-equal);
* ``fresh``: the kernel with every k-step from zero and plain IEEE adds;
* ``chained``: the kernel with every k-step's mma chained onto the running
  fp32 partial (``mma.sync``'s own accumulation);
* ``cudnn_bf16``: the twin's by-source graph with each per-source conv a
  cuDNN bf16 conv (the tensor cores, one rounding);
* ``twin``: the twin itself against the fp64 reference.

Times (CUDA events, in turns) of the kernel, the two variants, the kernel's
other tile and the cuDNN five-conv literal RDB at the inference and training
shapes. Then the same shares past the flagship widths, where N runs in
several passes and a tap's K in several chunks: nf=128, gc=64 (tile 8×8),
nf=72, gc=40 (8×8) and nf=256, gc=32 (4×8) on six seeded cases each at B=1,
24×32, and ``chip_smoke.py``'s wide case (nf=128, gc=64 at B=1, 32×48).
The variants are rebuilt from ``csrc/workbench_rdb.cu`` with its
``warp_mma_n`` replaced, by nvcc into ``build/tools/``. One JSON line per
case after the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# warp_mma_n's replacements: the same arguments, (hi, lo) with lo unused
FRESH = """template <int MT, int NT8>
__device__ __forceinline__ void warp_mma_n(float (&hi)[MT][NT8][4], float (&lo)[MT][NT8][4],
                                           const uint32_t (&a)[MT], int n, uint32_t bt, int bp,
                                           int n0, int klen, int lane) {
  using namespace esr::mma;
  for (int k = 0; k < klen; k += 16) {
    uint32_t bf[NT8][2];
#pragma unroll
    for (int q = 0; q < NT8; q += 2) {
      uint32_t r[4];
      ldsm_x4_t(r, bt + (k + (lane & 15)) * bp + (n0 + q * 8 + (lane >> 4) * 8) * 2);
      bf[q][0] = r[0], bf[q][1] = r[1], bf[q + 1][0] = r[2], bf[q + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < n) {
        uint32_t af[4];
        ldsm_x4(af, a[i] + k * 2);
#pragma unroll
        for (int q = 0; q < NT8; ++q) {
          float d[4];
          mma_bf16_fresh(d, af, bf[q][0], bf[q][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) hi[i][q][r] = __fadd_rn(hi[i][q][r], d[r]);
        }
      }
    }
  }
}

"""
CHAINED = FRESH.replace(
    """          float d[4];
          mma_bf16_fresh(d, af, bf[q][0], bf[q][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) hi[i][q][r] = __fadd_rn(hi[i][q][r], d[r]);""",
    """          mma_bf16(hi[i][q], af, bf[q][0], bf[q][1]);""")
VARIANTS = {"fresh": FRESH, "chained": CHAINED}
BEGIN, END = "template <int MT, int NT8>\n__device__ __forceinline__ void warp_mma_n(", \
    "// Target J (1..5)"


def variant_source(src: str, body: str) -> str:
    """``csrc/workbench_rdb.cu`` with ``warp_mma_n`` replaced by ``body``
    (``ValueError`` when the source lacks either marker)."""
    i, j = src.index(BEGIN), src.index(END)
    return src[:i] + body + src[j:]


def card_case(seed, nf, gc, shape):
    """``tests/test_torch_cuda.py``'s ``_workbench_rdb_case`` (the 1×1 on)
    with RandomState ``seed``: (x, by-source bf16 weights)."""
    import numpy as np
    import torch

    from esrganplus_tpu_torch.kernels.workbench import rdb as WR

    rs = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    conv = lambda cin, cout: {"w": t(rs.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin))),
                              "b": t(rs.randn(cout) * 0.1)}
    p = {f"conv{k}": conv(nf + (k - 1) * gc, nf if k == 5 else gc) for k in range(1, 6)}
    p["conv1x1"] = {"w": t(rs.randn(1, 1, nf, gc) * np.sqrt(2.0 / nf))}
    x = t(rs.randn(*shape, nf)).to(torch.bfloat16)
    return x, WR.prepare_rdb_weights(p, nf, gc, True, torch.bfloat16)


def by_source(x, ws, bias, nf, gc, slope, res_scale, bf16_convs):
    """``rdb_fused_plain``'s graph (1×1 on) returning x1..x4 and the output;
    with ``bf16_convs`` each per-source conv is cuDNN's bf16 conv."""
    import torch
    import torch.nn.functional as F

    from esrganplus_tpu_torch.models.layers import fp32_exact

    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    b = bias.float().flatten()
    off = lambda j: nf + (4 - j) * gc
    lrelu = lambda t: torch.where(t >= 0, t, t * slope)

    def contrib(src, w):
        k = w.float().reshape(3, 3, w.shape[1] // 3, w.shape[2]).permute(3, 2, 1, 0).contiguous()
        if bf16_convs:
            return F.conv2d(src.to(dt), k.to(dt), padding=1).float()
        with fp32_exact():
            return rnd(F.conv2d(src, k, padding=1))

    xs, cs = [x.float().permute(0, 3, 1, 2)], []
    for j in range(1, 5):
        cs.append(contrib(xs[-1], ws[j - 1]))
        t = sum(c[:, off(j):off(j) + gc] for c in cs)
        t = lrelu(t + b[off(j):off(j) + gc, None, None])
        if j == 2:
            t = t + cs[0][:, nf + 4 * gc:]
        elif j == 4:
            t = t + xs[2]
        xs.append(rnd(t))
    cs.append(contrib(xs[4], ws[4]))
    x5 = sum(c[:, :nf] for c in cs) + b[:nf, None, None]
    return xs[1:], (x5 * res_scale + xs[0]).to(dt)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wb_rdb_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import _interleaved, _wb_rdb_case, rel_err, time_ms
    from esrganplus_tpu_torch.kernels import build
    from esrganplus_tpu_torch.kernels.workbench import rdb as WR
    from esrganplus_tpu_torch.models.layers import fp32_exact

    out_dir = os.path.join(ROOT, "build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    src = (build.CSRC / "workbench_rdb.cu").read_text()
    libs = {}
    for name, fn in VARIANTS.items():
        cu = os.path.join(out_dir, f"wb_rdb_{name}.cu")
        so = os.path.join(out_dir, f"libwb_rdb_{name}.so")
        with open(cu, "w") as f:
            f.write(variant_source(src, fn))
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", so, cu],
                       check=True, capture_output=True)
        libs[name] = ctypes.CDLL(so)
        libs[name].esr_wb_rdb_fused.argtypes = build.SIGNATURES["workbench_rdb"]["esr_wb_rdb_fused"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)

    bf16 = torch.bfloat16
    cases = [(f"card{s}", None, *card_case(s, 64, 32, (2, 40, 24))) for s in range(3, 15)]
    for shape, (B, H, W) in (("bench", (1, 128, 128)), ("train", (16, 32, 32))):
        c = _wb_rdb_case(torch.Generator().manual_seed(16), bf16, bf16, B, H, W, 64, 32, True)
        cases.append((shape, c["lib"], c["x"], c["ws"]))
    for wnf, wgc in ((128, 64), (72, 40), (256, 32)):
        cases += [(f"wide{wnf}_{wgc}_{s}", None, *card_case(s, wnf, wgc, (1, 24, 32)))
                  for s in range(3, 9)]
    c = _wb_rdb_case(torch.Generator().manual_seed(16), bf16, bf16, 1, 32, 48, 128, 64, True)
    cases.append(("smoke_wide128_64", None, c["x"], c["ws"]))
    share = lambda a, b: (a.float() != b.float()).float().mean().item()
    for name, lib, x, ws in cases:
        B, H, W, nf = x.shape
        gc = (ws[1].shape[2] - nf) // 3
        tile = WR.mma_tile(nf, gc)
        fits = WR.mma_tiles(nf, gc)
        with fp32_exact():
            twin = WR.rdb_fused_plain(x, *ws, nf=nf, gc=gc, tile=8)
            exact = WR.rdb_fused_fp64(x, *ws, nf=nf, gc=gc)
            cud = by_source(x, ws[:5], ws[5], nf, gc, 0.2, 0.2, True)[1].permute(0, 2, 3, 1)
        tiles = {t: (lambda t=t: WR._rdb_fused_cuda(x, ws[:5], ws[5], nf=nf, gc=gc,
                                                    conv1x1=True, slope=0.2, res_scale=0.2,
                                                    ktile=t)) for t in fits}
        outs = {"kernel": tiles[tile](), "cudnn_bf16": cud, "twin": twin}
        calls = {}
        for v, l in libs.items():
            o = torch.empty_like(x)
            args = (1, 1, 1, x.data_ptr(), *(w.data_ptr() for w in ws), o.data_ptr(), B, H, W,
                    nf, gc, 1, 0.2, 0.2, *tile, torch.cuda.current_stream().cuda_stream)
            build.check(l.esr_wb_rdb_fused(*args), v)
            calls[v] = lambda l=l, args=args: l.esr_wb_rdb_fused(*args)
            outs[v] = o
        torch.cuda.synchronize()
        row = {"case": name, "lr": [B, H, W], "nf": nf, "gc": gc, "tile": list(tile),
               "vs_twin": {k: share(o, twin) for k, o in outs.items() if k != "twin"},
               "vs_fp64": {k: share(o, exact) for k, o in outs.items()},
               "rel_err_vs_twin": rel_err(outs["kernel"], twin)[1],
               "tiles_bit_equal": all(torch.equal(f(), outs["kernel"]) for f in tiles.values())}
        if lib is not None:  # times, in turns
            alt = [t for t in fits if t != tile][0]
            ms = {"kernel": []}
            for k, f in (("fresh", calls["fresh"]), ("chained", calls["chained"]),
                         (f"tile_{alt[0]}x{alt[1]}", tiles[alt])):
                t_kernel, ms[k] = _interleaved(tiles[tile], f, iters=20)
                ms["kernel"].append(t_kernel)
            ms["cudnn_literal_rdb"] = time_ms(lib, iters=20)
            row["ms"] = ms
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
