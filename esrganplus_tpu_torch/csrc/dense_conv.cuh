// The dense-stage 3x3 convolution of a ResidualDenseBlock (NHWC, sm_90a),
// shared by rdb_ct.cu (HWIO weights) and rdb_t.cu (rdb_t's by-target
// weights): one launch per dense stage over a per-call NHWC concat buffer
// [B,H,W,4*gc] that holds x1|x2|x3|x4; x itself is read in place, so no
// concatenation is ever copied. Stage k convolves the first nf+(k-1)*gc
// channels of (x | buffer) and writes its gc (stage 5: nf) channels; the
// epilogue carries bias, leaky-relu, the stage-2 1x1 shortcut (computed from
// x's centre tap in the same pass), the stage-4 x4 += x2, and the stage-5
// beta*x5 + x with the optional RRDB fold (*rrdb + h0), each rounded to T
// once. A training forward also keeps the pre-residual activations l2 and l4
// (`lsave`: the backward takes its leaky-relu masks from their signs).
//
// Stage 5 applies the nESRGAN+ relative noise in one of two ways:
//   noise  a pre-drawn T tensor (noise_kernel "input"): out + n*(sigma*out)
//          with every product and the sum rounded to T, after the rounding,
//          as the T-typed XLA ops of esrganplus_tpu/kernels/rdb_ct.py:267-271;
//   seeded the draw made here (noise_kernel "fused", philox.cuh):
//          out * (1 + sigma*n) in fp32 with n in fp32, then the one rounding,
//          as rdb_ct.py:258-266. The site's two seed words are read through
//          a device pointer (`seed`), so a captured CUDA graph replays the
//          launch with the words of each step's row.
// The two orders differ by a T rounding per element, so they stay apart.
//
// Bound on this card: operations. One RDB is 241,664 MAC per pixel against
// ~1.4 KB of activation traffic per pixel (x read, 4*gc buffer written and
// re-read, nf written), far above the H100's ~295 FLOP/byte ridge. Two
// designs, picked by the wrapper by dtype (kernels/launch.py design); the C
// entries take the design and refuse any other, so nothing falls back:
//   * "mma" (bf16): dense_mma_kernel, an implicit GEMM on the tensor cores
//     (mma.sync m16n8k16 bf16 -> fp32, csrc/mma_tile.cuh). M = a block's
//     8x16 pixel tile (8 m16 tiles, one a tile row), N = COUT, K = 9 taps x
//     cin (padded to 16 with zeros in shared memory). The haloed 10x18 tile
//     of both sources (x's c0 channels, then the concat buffer's prefix) is
//     staged once as [pixel][channel] rows of odd 16-byte pitch, and every
//     tap reads it as a shifted ldmatrix row (tap_mma); the weights stream
//     through a 3-slot cp.async ring, a slot one (tile slice, tap, chunk of
//     up to KCH channels), in the layout's own order: HWIO rows [k][n] read
//     with .trans, by-target rows [n][k] read plainly (wlayout.cuh KN).
//     Where the tile of all channels does not fit beside the ring
//     (dense_kt: conv3x3_ct above ~400 input channels at 64 outputs) it holds
//     KCH channels at a time, restaged in turn. The stage-2 1x1 shortcut is
//     a second accumulator set over the centre tap's rows of the same tile.
//     Each ring stage sums into fresh accumulators that join the total by
//     fp32 adds (tap_mma), in one fixed order, so a second call gives the
//     same bits.
//   * "fma" (fp32, whose 1e-4 bar TF32 would miss): dense_conv3x3_kernel on
//     the CUDA cores in fp32: each 256-thread block owns an 8x16 pixel tile
//     and all COUT output channels, stages a KC-channel slice of the haloed
//     input tile and of the 9 taps' weights in shared memory as fp32, and
//     keeps a 4-pixel x COUT/8-channel register tile per thread, so every
//     shared-memory load feeds several FMAs.
// Both end in the same per-element epilogue (epilogue() below) on the fp32
// sum, so the two designs round at the same points. The FMA kernel also runs
// bf16 when asked for by name: the baseline of the tensor cores' accuracy.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"
#include "wlayout.cuh"

namespace esr {
namespace dense {

constexpr int TH = 8;           // tile rows
constexpr int TW = 16;          // tile columns
constexpr int NT = 256;         // threads per block
constexpr int NCG = 8;          // channel groups per block
constexpr int NPG = NT / NCG;   // pixel groups (32)
constexpr int PPT = TH * TW / NPG;  // pixels per thread (4)

enum Mode : int {
  kAct = 0,      // lrelu(conv + b)
  kAct1x1 = 1,   // lrelu(conv + b) + w11 . x(centre)          (stage 2)
  kActAdd = 2,   // lrelu(conv + b) + r1                       (stage 4: + x2)
  kResid = 3,    // (conv + b) * alpha + r1  [then * beta2 + r2] (stage 5, conv3x3_ct)
};

enum Design : int { kFma = 0, kMma = 1 };  // kernels/launch.py DESIGNS

// One launch's arguments, as a C interface receives them.
struct DenseArgs {
  const void *x, *cat, *w, *bias, *w11, *r1, *r2, *noise;
  void *out, *lsave;
  int c0, ccat, cin, out_stride, r1_stride, r2_stride, lsave_stride, B, H, W;
  float sigma, alpha, beta2, slope;
  const uint32_t* seed;  // the fused mode's (seed0, seed1) on the device; nullptr: not seeded
};

// The stage epilogue of output channel c of pixel pix = (b, gy, gx) from
// its fp32 conv sum `acc` (and in kAct1x1 mode the 1x1 shortcut's `acc11`):
// stores lsave where asked and returns the value the caller rounds once
// into out. Stage 5 applies the nESRGAN+ relative noise in one of two ways:
//   noise  a pre-drawn T tensor (noise_kernel "input"): out + n*(sigma*out)
//          with every product and the sum rounded to T, after the rounding,
//          as the T-typed XLA ops of esrganplus_tpu/kernels/rdb_ct.py:267-271;
//   seed   the draw made here (noise_kernel "fused", philox.cuh):
//          out * (1 + sigma*n) in fp32 with n in fp32, then the one rounding,
//          as rdb_ct.py:258-266, keyed by the two words at `seed`.
// The two orders differ by a T rounding per element, so they stay apart.
template <typename T, int COUT, int MODE>
__device__ __forceinline__ float epilogue(const DenseArgs& a, float acc, float acc11, int b,
                                          int gy, int gx, size_t pix, int c) {
  const T* r1 = static_cast<const T*>(a.r1);
  float v = acc + static_cast<const float*>(a.bias)[c];
  if (MODE == kResid) {
    const T* r2 = static_cast<const T*>(a.r2);
    const T* noise = static_cast<const T*>(a.noise);
    v = r1 ? v * a.alpha + to_f(r1[pix * a.r1_stride + c]) : v * a.alpha;
    if (r2) v = v * a.beta2 + to_f(r2[pix * a.r2_stride + c]);
    if (noise) {  // every product and the sum rounded to T, as the T-typed XLA ops are
      const float o = round_to<T>(v);
      const float t = round_to<T>(round_to<T>(a.sigma) * o);
      v = o + round_to<T>(to_f(noise[pix * COUT + c]) * t);
    } else if (a.seed) {  // fp32 product with the fp32 draw, rounded once by the caller
      v = __fmul_rn(v, noise_factor(a.sigma, __ldg(a.seed), __ldg(a.seed + 1), b, gy, gx, c));
    }
  } else {
    v = lrelu(v, a.slope);
    if (a.lsave) static_cast<T*>(a.lsave)[pix * a.lsave_stride + c] = from_f<T>(v);
    if (MODE == kAct1x1) v += acc11;
    if (MODE == kActAdd) v += to_f(r1[pix * a.r1_stride + c]);
  }
  return v;
}

// ---------------------------------------------------------------------------
// "fma": fp32 on the CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int COUT, int MODE, typename L>
__global__ void __launch_bounds__(NT) dense_conv3x3_kernel(const DenseArgs a, const L wl) {
  constexpr int KC = COUT >= 64 ? 8 : 16;  // input channels staged per step
  constexpr int CPT = COUT / NCG;          // output channels per thread
  __shared__ float xs[KC][TH + 2][TW + 2];
  __shared__ float ws[9][KC][COUT];
  __shared__ float w11s[MODE == kAct1x1 ? KC : 1][COUT];

  const T* __restrict__ x = static_cast<const T*>(a.x);      // [B,H,W,c0]: channels [0, c0)
  const T* __restrict__ cat = static_cast<const T*>(a.cat);  // [B,H,W,ccat]: [c0, cin)
  const T* __restrict__ w = static_cast<const T*>(a.w);      // 9 taps x cin x COUT in layout L
  const T* __restrict__ w11 = static_cast<const T*>(a.w11);  // kAct1x1: 1 x c0 x COUT in L
  const int c0 = a.c0, ccat = a.ccat, cin = a.cin, H = a.H, W = a.W;
  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const size_t img = (size_t)blockIdx.z * H * W;

  float acc[PPT][CPT];
  float acc11[MODE == kAct1x1 ? PPT : 1][CPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  if (MODE == kAct1x1) {
#pragma unroll
    for (int i = 0; i < (MODE == kAct1x1 ? PPT : 1); ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc11[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < cin; k0 += KC) {
    // haloed input tile, zero outside the image (SAME padding)
    for (int i = tid; i < KC * (TH + 2) * (TW + 2); i += NT) {
      const int kk = i % KC;
      const int p = i / KC;
      const int ty = p / (TW + 2), tx = p % (TW + 2);
      const int gy = y0 + ty - 1, gx = x0 + tx - 1, c = k0 + kk;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin) {
        const size_t pix = img + (size_t)gy * W + gx;
        v = c < c0 ? to_f(x[pix * c0 + c]) : to_f(cat[pix * ccat + (c - c0)]);
      }
      xs[kk][ty][tx] = v;
    }
    for (int i = tid; i < 9 * KC * COUT; i += NT) {
      const int co = i % COUT;
      const int kk = (i / COUT) % KC;
      const int t = i / (COUT * KC);
      const int c = k0 + kk;
      ws[t][kk][co] = c < cin ? to_f(w[wl(9, t, c, co, cin, COUT)]) : 0.f;
    }
    if (MODE == kAct1x1) {
      for (int i = tid; i < KC * COUT; i += NT) {
        const int co = i % COUT, kk = i / COUT, c = k0 + kk;
        w11s[MODE == kAct1x1 ? kk : 0][co] =
            c < c0 ? to_f(w11[wl(1, 0, c, co, c0, COUT)]) : 0.f;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int dy = t / 3, dx = t % 3;
        float wv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) wv[j] = ws[t][kk][cg * CPT + j];
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const int p = pg + NPG * i;
          const float v = xs[kk][p / TW + dy][p % TW + dx];
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(v, wv[j], acc[i][j]);
        }
      }
      if (MODE == kAct1x1) {
#pragma unroll
        for (int i = 0; i < (MODE == kAct1x1 ? PPT : 1); ++i) {
          const int p = pg + NPG * i;
          const float v = xs[kk][p / TW + 1][p % TW + 1];
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc11[i][j] = fmaf(v, w11s[MODE == kAct1x1 ? kk : 0][cg * CPT + j], acc11[i][j]);
        }
      }
    }
    __syncthreads();
  }

  T* __restrict__ out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = pg + NPG * i;
    const int gy = y0 + p / TW, gx = x0 + p % TW;
    if (gy >= H || gx >= W) continue;
    const size_t pix = img + (size_t)gy * W + gx;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cg * CPT + j;
      const float s11 = MODE == kAct1x1 ? acc11[MODE == kAct1x1 ? i : 0][j] : 0.f;
      out[pix * a.out_stride + c] =
          from_f<T>(epilogue<T, COUT, MODE>(a, acc[i][j], s11, blockIdx.z, gy, gx, pix, c));
    }
  }
}

template <typename T, int COUT, int MODE, typename L>
int launch_fma(const DenseArgs& a, L wl, cudaStream_t stream) {
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, a.B);
  dense_conv3x3_kernel<T, COUT, MODE, L><<<grid, NT, 0, stream>>>(a, wl);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "mma": bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace dmma {

using esr::mma::cp_async16;
using esr::mma::ldsm_pitch;
using esr::mma::smem_u32;
using esr::tile::bf16;
using esr::tile::HP;   // the haloed 10x18 tile of the 8x16 pixel tile (csrc/mma_tile.cuh)
using esr::tile::HW;
using esr::tile::round16;
using esr::tile::Tiling;
using esr::tile::warp_mma;

constexpr int NSLOT = 3;          // weight-ring depth
constexpr int KCH = 192;          // K rows of a ring slot at most, and a tile slice's channels
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may opt into on sm_90
// Eight warps a block (two m16 tiles and COUT/2 columns a warp, or all COUT
// at COUT = 8): at the model's shapes the grid is about one block an SM.
constexpr int NW = 8;
// Bytes of a ring slot of kch K rows by np outputs: [k][n] (kn) or [n][k].
__host__ __device__ constexpr int dense_slot(int np, int kch, bool kn) {
  return kn ? kch * ldsm_pitch(np) : np * ldsm_pitch(kch);
}

// Dynamic shared memory of a block: the haloed tile of kt channels, the ring,
// and in kAct1x1 mode the 1x1 shortcut's weights (c11 K rows, else 0).
__host__ __device__ constexpr int dense_smem(int np, int kt, bool kn, int c11) {
  return HP * ldsm_pitch(kt) + NSLOT * dense_slot(np, kt < KCH ? kt : KCH, kn) +
         (c11 ? dense_slot(np, c11, kn) : 0);
}

// Channels the staged tile holds: all kp where the block fits, else KCH.
__host__ __device__ constexpr int dense_kt(int np, int kp, bool kn, int c11) {
  return dense_smem(np, kp, kn, c11) <= MAX_SMEM ? kp : KCH;
}

// The block's 3x3 implicit GEMM: acc = the sum over the nine taps
// t = 3*dy + dx and the kp staged channels (a multiple of 16) of tile pixel
// (u + dy, v + dx) times the tap's weights, for block pixel (u, v). Each
// stage sums its at most KCH/16 = 12 k-steps from zero by mma.sync's own
// accumulation and joins acc by a round-to-nearest fp32 add, in the walk's
// fixed order. Chained over the whole K (1728 at the flagship's stage 5)
// mma.sync's accumulation moved 1.1-1.9 % of rdb_ct's outputs off the twin,
// over the 1 % bar; per stage 0.4-0.7 %. Shorter partials (one k-step),
// a TwoSum join and an exact split of A into two bf16 parts each measured
// the same against the twin on the H100 (PERF.md, Findings), at up to 57 %
// more time. The
// haloed tile holds kt channels at smem[0] (all kp, or slices of kt = kch
// restaged in turn); the weights stream through the NSLOT-slot ring, a slot
// of `slot` bytes holding one stage (tile slice, tap, chunk of up to kch K
// rows), [k][n] rows read with .trans (KN) or [n][k] rows. Either one slice
// holds all kp or a slice is one chunk, so no stage is empty.
//   stage_x(c, len, pitch): channels c .. c+len of the haloed tile into
//     shared rows of `pitch` bytes (cp.async or plain stores, no commit);
//   load_w(dst, t, c, len): K rows c .. c+len of tap t into the ring slot at
//     shared address dst (cp.async, no commit);
//   after(t, c, a): after each stage's product, with its tap, its first
//     channel and this lane's A row addresses.
// cp.async copies the caller issues before the call land with the tile.
template <int NP, bool KN, typename StageX, typename LoadW, typename After>
__device__ __forceinline__ void tap_mma(float (&acc)[Tiling<NP, NW>::MT][Tiling<NP, NW>::NT8][4],
                                        unsigned char* smem, int kp, int kt, int kch, int slot,
                                        StageX&& stage_x, LoadW&& load_w, After&& after) {
  using Tl = Tiling<NP, NW>;
  const int xp = ldsm_pitch(kt), wpitch = KN ? ldsm_pitch(NP) : ldsm_pitch(kch);
  const uint32_t xs = smem_u32(smem), ws = xs + HP * xp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / Tl::WN, wn = warp % Tl::WN;
  const int nkc = (kt + kch - 1) / kch, nsl = (kp + kt - 1) / kt;  // chunks a tap, slices
  const int nstage = 9 * nsl * nkc;

  // the ring's stages in order, walked by counters (no division in the loop)
  struct Walk {
    int sl = 0, t = 0, kc = 0;  // tile slice, tap, K chunk
  };
  auto step = [&](Walk& w) {
    if (++w.kc < nkc) return;
    w.kc = 0;
    if (++w.t < 9) return;
    w.t = 0;
    ++w.sl;
  };
  auto first = [&](const Walk& w) { return w.sl * kt + w.kc * kch; };  // the stage's channel
  auto rows = [&](const Walk& w) { return min(kch, min(kp, (w.sl + 1) * kt) - first(w)); };
  Walk wf, wc;  // the next stage to fetch, the stage to compute
  auto fetch = [&](int s) {
    load_w(ws + (s % NSLOT) * slot, wf.t, first(wf), rows(wf));
    step(wf);
  };
  stage_x(0, min(kt, kp), xp);
  esr::mma::cp_async_commit();
  fetch(0);
  esr::mma::cp_async_commit();
  fetch(1);
  esr::mma::cp_async_commit();

#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  uint32_t arow[Tl::MT];  // tile row = block row (+ dy), column lane & 15 (+ dx)
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
    arow[i] = xs + ((wm * Tl::MT + i) * HW + (lane & 15)) * xp + (lane >> 4) * 16;

  for (int s = 0; s < nstage; ++s) {
    if (nsl > 1 && s > 0 && wc.t == 0 && wc.kc == 0) {  // restage: the tile's next slice
      const int c = wc.sl * kt;
      __syncthreads();  // every warp is done with the last slice
      stage_x(c, min(kt, kp - c), xp);
      esr::mma::cp_async_commit();
      esr::mma::cp_async_wait<0>();
    }
    esr::mma::cp_async_wait<1>();  // the tile and stage s have landed
    __syncthreads();               // ... for every thread, and slot (s+2) % 3 is free
    if (s + 2 < nstage) fetch(s + 2);
    esr::mma::cp_async_commit();
    const int shift = (wc.t / 3) * HW + wc.t % 3;
    uint32_t a[Tl::MT];
#pragma unroll
    for (int i = 0; i < Tl::MT; ++i) a[i] = arow[i] + shift * xp + wc.kc * kch * 2;
    float part[Tl::MT][Tl::NT8][4] = {};  // the stage's own sum
    warp_mma<Tl::MT, Tl::NT8, KN>(part, a, ws + (s % NSLOT) * slot, wpitch, wn * Tl::NT8 * 8,
                                  rows(wc), lane);
#pragma unroll
    for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
      for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = __fadd_rn(acc[i][j][r], part[i][j][r]);
    after(wc.t, first(wc), a);
    step(wc);
  }
  esr::mma::cp_async_wait<0>();
}

template <int COUT, int MODE, typename L>
__global__ void __launch_bounds__(Tiling<COUT, NW>::NTH, Tiling<COUT, NW>::MIN_BLOCKS)
    dense_mma_kernel(const DenseArgs a, const L wl) {
  using Tl = Tiling<COUT, NW>;
  constexpr bool KN = L::KN;
  constexpr bool S11 = MODE == kAct1x1;
  extern __shared__ __align__(128) unsigned char smem[];
  const bf16* __restrict__ x = static_cast<const bf16*>(a.x);
  const bf16* __restrict__ cat = static_cast<const bf16*>(a.cat);
  const bf16* __restrict__ w = static_cast<const bf16*>(a.w);
  const int c0 = a.c0, ccat = a.ccat, cin = a.cin, H = a.H, W = a.W;
  const int kp = round16(cin), c11 = S11 ? round16(c0) : 0;
  const int kt = dense_kt(COUT, kp, KN, c11), kch = kt < KCH ? kt : KCH;
  const int slot = dense_slot(COUT, kch, KN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Tl::WN, wn = warp % Tl::WN;
  const int b = blockIdx.z, y0 = blockIdx.y * esr::tile::TH, x0 = blockIdx.x * esr::tile::TW;
  const bool vec = (c0 & 7) == 0 && (ccat & 7) == 0;  // 16-byte pixel rows in both sources

  // channels [cb, cb + len) of the haloed tile: x's below c0, the concat
  // buffer's from c0, zero past cin and outside the image
  auto stage_x = [&](int cb, int len, int pitch) {
    const int nc = len / 8;
    for (int i = tid; i < HP * nc; i += Tl::NTH) {
      const int p = i / nc, c8 = i % nc;
      const int gy = y0 - 1 + p / HW, gx = x0 - 1 + p % HW, ch = cb + c8 * 8;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const size_t pix = ((size_t)b * H + gy) * W + gx;
      unsigned char* dst = smem + p * pitch + c8 * 16;
      if (vec) {
        const bool ok = in && ch < cin;
        cp_async16(smem_u32(dst),
                   !ok ? x : ch < c0 ? x + pix * c0 + ch : cat + pix * ccat + (ch - c0), ok);
      } else {  // a channel at a time, 16-byte stores
        __align__(16) bf16 v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = ch + k;
          v[k] = !in || c >= cin ? __float2bfloat16_rn(0.f)
                 : c < c0        ? x[pix * c0 + c]
                                 : cat[pix * ccat + (c - c0)];
        }
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    }
  };
  // K rows kb .. kb+len (zero from cw) of tap t of a taps x cw x COUT weight
  // `src` in layout L into shared rows at dst: [k][n] rows of `pitch` bytes,
  // 8 outputs a vector, or [n][k] rows, 8 channels of one source a vector
  auto load_rows = [&](uint32_t dst, int pitch, const bf16* src, int taps, int t, int kb,
                       int len, int cw) {
    if constexpr (KN) {
      constexpr int NC = COUT / 8;
      for (int i = tid; i < len * NC; i += Tl::NTH) {
        const int r = i / NC, n8 = i % NC, ci = kb + r;
        const bool ok = ci < cw;
        cp_async16(dst + r * pitch + n8 * 16, ok ? src + wl(taps, t, ci, n8 * 8, cw, COUT) : src,
                   ok);
      }
    } else {
      const int nc = len / 8;
      for (int i = tid; i < COUT * nc; i += Tl::NTH) {
        const int n = i / nc, k8 = i % nc, ci = kb + k8 * 8;
        const bool ok = ci < cw;
        cp_async16(dst + n * pitch + k8 * 16, ok ? src + wl(taps, t, ci, n, cw, COUT) : src, ok);
      }
    }
  };
  const int wpitch = KN ? ldsm_pitch(COUT) : ldsm_pitch(kch);
  auto load_w = [&](uint32_t dst, int t, int kb, int len) {
    load_rows(dst, wpitch, w, 9, t, kb, len, cin);
  };
  // the 1x1 shortcut's weights (c11 K rows, zero from c0) after the ring
  const uint32_t w11s = smem_u32(smem) + HP * ldsm_pitch(kt) + NSLOT * slot;
  const int p11 = KN ? ldsm_pitch(COUT) : ldsm_pitch(c11);
  if (S11) load_rows(w11s, p11, static_cast<const bf16*>(a.w11), 1, 0, 0, c11, c0);

  float acc[Tl::MT][Tl::NT8][4], acc11[Tl::MT][Tl::NT8][4];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc11[i][j][r] = 0.f;
  // the 1x1 over the centre tap's rows of the first slice: K = c0 (c11)
  auto after = [&](int t, int cb, const uint32_t (&ar)[Tl::MT]) {
    if (S11 && t == 4 && cb == 0)
      warp_mma<Tl::MT, Tl::NT8, KN>(acc11, ar, w11s, p11, wn * Tl::NT8 * 8, c11, lane);
  };
  tap_mma<COUT, KN>(acc, smem, kp, kt, kch, slot, stage_x, load_w, after);

  // the shared epilogue on each accumulator, two channels a 4-byte store
  bf16* __restrict__ out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gy = y0 + wm * Tl::MT + i, gx = x0 + (lane >> 2) + 8 * h;
        const int n = (wn * Tl::NT8 + j) * 8 + (lane & 3) * 2;
        if (gy >= H || gx >= W) continue;
        const size_t pix = ((size_t)b * H + gy) * W + gx;
        const float v0 = epilogue<bf16, COUT, MODE>(a, acc[i][j][2 * h], acc11[i][j][2 * h], b,
                                                    gy, gx, pix, n);
        const float v1 = epilogue<bf16, COUT, MODE>(a, acc[i][j][2 * h + 1],
                                                    acc11[i][j][2 * h + 1], b, gy, gx, pix, n + 1);
        *reinterpret_cast<uint32_t*>(out + pix * a.out_stride + n) =
            esr::mma::pack_bf16(v0, v1);
      }
}

template <int COUT, int MODE, typename L>
int launch(const DenseArgs& a, L wl, cudaStream_t stream) {
  const int kp = round16(a.cin), c11 = MODE == kAct1x1 ? round16(a.c0) : 0;
  const size_t smem = dense_smem(COUT, dense_kt(COUT, kp, L::KN, c11), L::KN, c11);
  auto kern = dense_mma_kernel<COUT, MODE, L>;
  if (int e = esr::tile::smem_opt_in(kern, smem)) return e;
  const dim3 grid((a.W + esr::tile::TW - 1) / esr::tile::TW,
                  (a.H + esr::tile::TH - 1) / esr::tile::TH, a.B);
  kern<<<grid, NW * 32, smem, stream>>>(a, wl);
  return (int)cudaGetLastError();
}

}  // namespace dmma

template <typename T, bool MMA, int COUT, int MODE, typename L>
int launch(const DenseArgs& a, L wl, cudaStream_t s) {
  if constexpr (MMA) return dmma::launch<COUT, MODE>(a, wl, s);
  else return launch_fma<T, COUT, MODE>(a, wl, s);
}

template <typename T, bool MMA, int COUT, typename L>
int dispatch_mode(int mode, const DenseArgs& a, L wl, cudaStream_t s) {
  switch (mode) {
    case kAct: return launch<T, MMA, COUT, kAct>(a, wl, s);
    case kAct1x1: return launch<T, MMA, COUT, kAct1x1>(a, wl, s);
    case kActAdd: return launch<T, MMA, COUT, kActAdd>(a, wl, s);
    case kResid: return launch<T, MMA, COUT, kResid>(a, wl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, bool MMA, typename L>
int dispatch_cout(int cout, int mode, const DenseArgs& a, L wl, cudaStream_t s) {
  switch (cout) {
    case 8: return dispatch_mode<T, MMA, 8>(mode, a, wl, s);
    case 16: return dispatch_mode<T, MMA, 16>(mode, a, wl, s);
    case 32: return dispatch_mode<T, MMA, 32>(mode, a, wl, s);
    case 64: return dispatch_mode<T, MMA, 64>(mode, a, wl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One dense-stage launch in weight layout L; returns cudaGetLastError().
// The wrappers ask for one design per dtype (kernels/launch.py design): bf16
// on the tensor cores (kMma), fp32 on the CUDA cores (kFma). kFma also runs
// bf16 when asked for by name, as the accuracy baseline chip_smoke.py
// measures the tensor cores against; fp32 on the tensor cores (TF32) is
// refused.
template <typename L>
int dispatch(int dtype, int design, int cout, int mode, const DenseArgs& a, L wl,
             cudaStream_t s) {
  if (dtype == kBFloat16 && design == kMma)
    return dispatch_cout<__nv_bfloat16, true>(cout, mode, a, wl, s);
  if (dtype == kBFloat16 && design == kFma)
    return dispatch_cout<__nv_bfloat16, false>(cout, mode, a, wl, s);
  if (dtype == kFloat32 && design == kFma) return dispatch_cout<float, false>(cout, mode, a, wl, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace dense
}  // namespace esr
