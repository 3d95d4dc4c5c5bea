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
//     (wgmma m64nNk16 bf16 -> fp32, both operands from shared memory,
//     csrc/hopper.cuh), weight-stationary and persistent: about one block
//     an SM stages the weights of its N outputs once ([tap][K/8][N][8]
//     core matrices, from either layout; N = COUT, halved where the weights
//     of all COUT do not fit: stage 5's 221 KB) and then walks a strided
//     list of 8 x tw pixel tiles (tw = 16, or 8 where the grid would
//     otherwise leave warpgroups idle or two slots do not fit beside the
//     weights). A producer warp brings each tile's haloed groups of 32
//     channels (x's c0, then the concat buffer's prefix, each padded to
//     whole groups) by TMA, a box a group with the 64-byte swizzle, into
//     slots on mbarriers, one stream of slots a consumer warpgroup; the
//     tensor map's out-of-bounds zeros are the SAME padding and the channels
//     past a source's width. An M block of 64 pixels is 8 tile rows x 8
//     columns, so a tap's window is the group shifted by (dy, dx) under one
//     descriptor. Each (tap, slice of at most 6 groups = 192 channels)
//     partial sum is one wgmma chain from zero that joins the fp32 total by
//     a round-to-nearest add while the next tap's chain runs, in the fixed
//     order slice, then tap (the flagship's stages are one slice each); the
//     stage-2 1x1 shortcut is one more chain over the centre tap's x
//     groups. A second call gives the same bits. Chained over the whole K
//     instead (1728 at stage 5), the accumulation puts 1.1-1.4 % of
//     rdb_ct's outputs off the twin, over the 1 % bar (tools/dense_variants.py
//     `chained`).
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
#include "hopper.cuh"
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
  int b0;  // the draw's batch offset: local row b draws the global row b0 + b
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
//          as rdb_ct.py:258-266, keyed by the two words at `seed`, row b
//          drawing the counter of row b0 + b (a rank's rows of the global
//          batch under data parallelism; 0 in one process).
// The two orders differ by a T rounding per element, so they stay apart.
// The fused mode's factor out of line: an unrolled epilogue would otherwise
// carry a copy of the Philox rounds for each of its outputs.
static __device__ __noinline__ float seeded_factor(float sigma, const uint32_t* seed, int b,
                                                   int gy, int gx, int c) {
  return noise_factor(sigma, __ldg(seed), __ldg(seed + 1), b, gy, gx, c);
}

// The arithmetic after the bias (v = acc + b[c]): the value the caller
// rounds once into out; in the activation modes `pre` is the leaky-relu
// value that lsave keeps.
// NOISY = false leaves the noise out (a launch without noise or seed).
template <typename T, int MODE, bool NOISY = true>
__device__ __forceinline__ float epilogue_math(const DenseArgs& a, float v, float acc11, float r1,
                                               float r2, int b, int gy, int gx, size_t pix,
                                               int c, int cout, float& pre) {
  if (MODE == kResid) {
    const T* noise = static_cast<const T*>(a.noise);
    v = a.r1 ? v * a.alpha + r1 : v * a.alpha;
    if (a.r2) v = v * a.beta2 + r2;
    if (!NOISY) {
    } else if (noise) {  // every product and the sum rounded to T, as the T-typed XLA ops are
      const float o = round_to<T>(v);
      const float t = round_to<T>(round_to<T>(a.sigma) * o);
      v = o + round_to<T>(to_f(noise[pix * cout + c]) * t);
    } else if (a.seed) {  // fp32 product with the fp32 draw, rounded once by the caller
      v = __fmul_rn(v, seeded_factor(a.sigma, a.seed, a.b0 + b, gy, gx, c));
    }
    pre = v;
  } else {
    v = lrelu(v, a.slope);
    pre = v;
    if (MODE == kAct1x1) v += acc11;
    if (MODE == kActAdd) v += r1;
  }
  return v;
}

// The whole epilogue of one output with its operands read here: the bias,
// r1 (kActAdd, kResid), r2 (kResid), and the lsave store.
template <typename T, int MODE>
__device__ __forceinline__ float epilogue(const DenseArgs& a, float acc, float acc11, int b,
                                          int gy, int gx, size_t pix, int c, int cout) {
  const T* r1 = static_cast<const T*>(a.r1);
  const T* r2 = static_cast<const T*>(a.r2);
  const bool use1 = (MODE == kResid || MODE == kActAdd) && r1, use2 = MODE == kResid && r2;
  float pre;
  const float v = epilogue_math<T, MODE>(
      a, acc + static_cast<const float*>(a.bias)[c], acc11,
      use1 ? to_f(r1[pix * a.r1_stride + c]) : 0.f, use2 ? to_f(r2[pix * a.r2_stride + c]) : 0.f,
      b, gy, gx, pix, c, cout, pre);
  if (MODE != kResid && a.lsave)
    static_cast<T*>(a.lsave)[pix * a.lsave_stride + c] = from_f<T>(pre);
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
          from_f<T>(epilogue<T, MODE>(a, acc[i][j], s11, blockIdx.z, gy, gx, pix, c, COUT));
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

using esr::hopper::desc_kmajor;
using esr::hopper::mbar_arrive;
using esr::hopper::mbar_wait;
using esr::hopper::Wgmma;
using esr::mma::smem_u32;
using esr::tile::bf16;
using esr::tile::round16;

constexpr int TH = 8;             // tile rows: an M block of wgmma is 8 rows x 8 columns
constexpr int GCH = 32;           // channels of a group: one 64-byte swizzled row a pixel
constexpr int SLICE_G = 6;        // groups a tile slot holds at most: one partial's K (192)
constexpr int NWG = 2;            // consumer warpgroups, each its own stream of whole tiles
constexpr int NTH = NWG * 128 + 32;  // threads: the consumers and one producer warp
constexpr int MAX_BUF = 4;        // tile slots at most (a multiple of NWG)
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may opt into on sm_90

// Bytes of one haloed (TH+2) x (tw+2) group of 32 channels, 64 bytes a pixel
// (TMA's 64-byte swizzle), padded to 1024 bytes.
__host__ __device__ constexpr int group_bytes(int tw) {
  return ((TH + 2) * (tw + 2) * GCH * 2 + 1023) / 1024 * 1024;
}
// Groups of the K walk: x's c0 channels, then the concat prefix's cin - c0,
// each source padded to whole groups (zeros in the data and the weights).
__host__ __device__ constexpr int groups_x(int c0) { return (c0 + GCH - 1) / GCH; }
__host__ __device__ constexpr int groups_all(int cin, int c0) {
  return groups_x(c0) + (cin - c0 + GCH - 1) / GCH;
}
// Bytes of the resident weights of nb outputs over ng groups, all nine taps.
__host__ __device__ constexpr int w_bytes(int ng, int nb) { return 9 * ng * GCH * nb * 2; }
// A block's dynamic shared memory: nbuf tile slots of up to SLICE_G groups,
// the weights, the 1x1 shortcut's x groups (s11), two barriers a slot.
__host__ __device__ constexpr int smem_bytes(int tw, int nb, int nbuf, int ng, int gx,
                                             bool s11) {
  return nbuf * (ng < SLICE_G ? ng : SLICE_G) * group_bytes(tw) + w_bytes(ng, nb) +
         (s11 ? gx * GCH * nb * 2 : 0) + 16 * nbuf;
}

// A launch's plan (kernels/launch.py dense_plan mirrors it): the tile width
// tw (16 columns, two M blocks, where the outputs a block owns are at most
// 32 and the slots fit, else 8), the outputs a block owns nb (cout, or
// halved down to 8 where the weights of all cout do not fit: stage 5), the
// tile slots (2 or 4: one or two a stream), the tiles and the blocks. nb
// == 0: no plan fits (the launch is refused).
struct Plan {
  int tw, nb, nbuf, tiles, blocks, smem;
};

inline Plan plan(int cout, int cin, int c0, bool s11, int B, int H, int W, int nsm) {
  Plan p{0, 0, 0, 0, 0, 0};
  const int ng = groups_all(cin, c0), gx = groups_x(c0);
  for (int nb = cout; nb >= 8; nb /= 2) {
    const bool fit16 = nb <= 32 && smem_bytes(16, nb, NWG, ng, gx, s11) <= MAX_SMEM;
    if (!fit16 && smem_bytes(8, nb, NWG, ng, gx, s11) > MAX_SMEM) continue;
    const int np = cout / nb;
    const int tiles16 = B * ((H + TH - 1) / TH) * ((W + 15) / 16);
    // 16 columns where every warpgroup still gets a tile, else 8 (more tiles)
    p.tw = fit16 && tiles16 * np >= NWG * nsm ? 16 : 8;
    p.nb = nb;
    p.nbuf = smem_bytes(p.tw, nb, MAX_BUF, ng, gx, s11) <= MAX_SMEM ? MAX_BUF : NWG;
    p.smem = smem_bytes(p.tw, nb, p.nbuf, ng, gx, s11);
    p.tiles = B * ((H + TH - 1) / TH) * ((W + p.tw - 1) / p.tw);
    const int units = p.tiles * np;
    p.blocks = (units < nsm ? units : nsm) / np * np;
    if (p.blocks < np) p.blocks = np;
    return p;
  }
  return p;
}

// Weight bytes a launch of plan p stages into shared memory: every block
// its outputs' weights (and the 1x1's) once.
inline int staged_bytes(const Plan& p, int cin, int c0, bool s11) {
  const int w11 = s11 ? groups_x(c0) * GCH * p.nb * 2 : 0;
  return p.blocks * (w_bytes(groups_all(cin, c0), p.nb) + w11);
}

// What the kernel reads of its plan.
struct KPlan {
  int cout, mode, tw, nbuf, ng, gx, np, ntx, nty, tiles, vec;
};

// The source channel of K row k of the group walk (x's groups, then the
// concat prefix's), or -1 for a padding row.
__device__ __forceinline__ int k_channel(int k, int c0, int cin, int gx) {
  const int g = k / GCH, w = k % GCH;
  const int c = g < gx ? g * GCH + w : c0 + (g - gx) * GCH + w;
  return (g < gx ? g * GCH + w < c0 : c < cin) ? c : -1;
}

// Stage the block's weights once: outputs co0 .. co0 + NB of the 9 taps x
// ng groups, K rows in the group walk's order (zero in its padding), as
// [tap][K / 8][NB][8] (no-swizzle K-major core matrices); in kAct1x1 mode
// the 1x1's x groups as [K / 8][NB][8] (taps = 1). HWIO rows hold 8 outputs
// a vector: an 8 x 8 block is read as 8 vectors and written transposed;
// by-target rows hold 8 K of one source a vector.
template <int NB, typename L>
__device__ __forceinline__ void stage_weights(uint32_t dst, const bf16* __restrict__ w, int taps,
                                              int ng, int gx, int c0, int cin, int cout,
                                              int co0, const L& wl, int tid) {
  const int nch = ng * GCH / 8;
  if constexpr (L::KN) {
    constexpr int NG = NB / 8;
    for (int i = tid; i < taps * nch * NG; i += NWG * 128) {
      const int ng8 = i % NG, ch = (i / NG) % nch, t = i / (NG * nch);
      __align__(16) bf16 v[8][8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int ci = k_channel(ch * 8 + e, c0, cin, gx);
        uint4 r = make_uint4(0, 0, 0, 0);
        if (ci >= 0)
          r = *reinterpret_cast<const uint4*>(w + wl(taps, t, ci, co0 + ng8 * 8, cin, cout));
        *reinterpret_cast<uint4*>(v[e]) = r;
      }
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        __align__(16) bf16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = v[e][f];
        const uint4 r = *reinterpret_cast<const uint4*>(o);
        esr::hopper::st_shared16(dst + (((t * nch + ch) * NB) + ng8 * 8 + f) * 16, r);
      }
    }
  } else {  // the 8 K rows of a vector lie in one source: its width is a multiple of 8
    for (int i = tid; i < taps * nch * NB; i += NWG * 128) {
      const int n = i % NB, ch = (i / NB) % nch, t = i / (NB * nch);
      const int ci = k_channel(ch * 8, c0, cin, gx);
      uint4 r = make_uint4(0, 0, 0, 0);
      if (ci >= 0) r = *reinterpret_cast<const uint4*>(w + wl(taps, t, ci, co0 + n, cin, cout));
      esr::hopper::st_shared16(dst + i * 16, r);
    }
  }
}

// The epilogue of one M block's accumulators (64 pixels x NB outputs from
// n0; this thread's rows y, y + 1 at column x, outputs n0 + 8j + 2 *
// (lane % 4) + e with its bias in bias[2j + e]), two channels a 4-byte store
// of out (and of lsave); the residuals were read before the product
// (rr[0|1][h][j]: the bf16 pair of r1 | r2).
template <int MODE, int NB, bool NOISY = false>
__device__ __forceinline__ void store_mblock(const DenseArgs& a, const float (&acc)[NB / 2],
                                             const float (&acc11)[NB / 2],
                                             const float (&bias)[NB / 4], int cout, int b, int y,
                                             int x, int n0, int lane,
                                             const uint32_t (&rr)[2][2][NB / 8]) {
  auto lo = [](uint32_t u) { return __uint_as_float(u << 16); };
  auto hi = [](uint32_t u) { return __uint_as_float(u & 0xffff0000u); };
  const int nl = n0 + (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gy = y + h;
    if (gy >= a.H || x >= a.W) continue;
    const size_t pix = ((size_t)b * a.H + gy) * a.W + x;
    uint32_t* o = reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) + pix * a.out_stride + nl);
    uint32_t* ls = MODE != kResid && a.lsave
                       ? reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.lsave) +
                                                     pix * a.lsave_stride + nl)
                       : nullptr;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int r = 4 * j + 2 * h;
      float p0, p1;
      const float v0 = epilogue_math<bf16, MODE, NOISY>(a, acc[r] + bias[2 * j], acc11[r],
                                                 lo(rr[0][h][j]), lo(rr[1][h][j]), b, gy, x, pix,
                                                 nl + 8 * j, cout, p0);
      const float v1 = epilogue_math<bf16, MODE, NOISY>(a, acc[r + 1] + bias[2 * j + 1],
                                                        acc11[r + 1],
                                                 hi(rr[0][h][j]), hi(rr[1][h][j]), b, gy, x, pix,
                                                 nl + 8 * j + 1, cout, p1);
      if (ls) ls[4 * j] = esr::mma::pack_bf16(p0, p1);
      o[4 * j] = esr::mma::pack_bf16(v0, v1);
    }
  }
}

// Weight-stationary, persistent: each block stages the weights of its NB
// outputs once, then walks its tiles (g, g + G, ...; part = blockIdx.x % np
// picks the outputs, so a tile's parts run on neighbouring blocks at the
// same time). Tile j goes to consumer warpgroup j % NWG, whose stream of
// nbuf / NWG slots a producer warp fills in order, each slot one slice (at
// most SLICE_G groups) of one haloed tile: a TMA box a group (32 channels,
// 64-byte swizzle; out-of-bounds boxes read zero: SAME padding and the
// channels past a source's width), or its lanes' loads where a source's
// pixel rows are not 16-byte multiples. Each slot completes on its full
// barrier and is released on its empty one. For each tap t = 3 * dy + dx the
// warpgroup issues the slice's k-steps for each M block as one chain of
// wgmma (A: the group rows shifted by (dy, dx), B: the resident weights)
// from zero into a partial, which joins the fp32 total by a round-to-nearest
// add while the next tap's chains run (two partials alternate). The 1x1
// shortcut is one more chain over the centre tap's x groups. The residuals
// of the epilogue are read before the product, so their latency hides
// behind it; while one warpgroup stores a tile, the other's product runs.
// No atomics and a fixed order: a second call gives the same bits.
template <int NB, bool S11, typename L>
__global__ void __launch_bounds__(NTH, 1)
    dense_mma_kernel(const DenseArgs a, const L wl, const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmc, const KPlan p) {
  constexpr int NR = NB / 2;         // accumulators a thread and M block
  constexpr int MBX = NB <= 32 ? 2 : 1;  // M blocks a tile at most (registers)
  extern __shared__ __align__(1024) unsigned char smem[];
  // the warp's index broadcast from lane 0, so that the compiler knows it
  // (and the warpgroup's) to be uniform: wgmma needs converged warpgroups,
  // and under a branch it cannot prove uniform ptxas serializes them
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int tw = p.tw, hw = tw + 2, MB = tw / 8, ng = p.ng, gx = p.gx;
  const int nsl = (ng + SLICE_G - 1) / SLICE_G, gb = group_bytes(tw);
  const int slot = (ng < SLICE_G ? ng : SLICE_G) * gb, sb = p.nbuf / NWG;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t wsm = sbase + p.nbuf * slot;
  const uint32_t w11sm = wsm + w_bytes(ng, NB);
  const uint32_t bars = w11sm + (S11 ? gx * GCH * NB * 2 : 0);  // full[nbuf], then empty[nbuf]
  const int part = blockIdx.x % p.np, g = blockIdx.x / p.np, G = gridDim.x / p.np;
  const int mine = g < p.tiles ? (p.tiles - 1 - g) / G + 1 : 0;  // this block's tiles
  const int c0 = a.c0, cin = a.cin;

  if (tid == 0) {
    for (int i = 0; i < p.nbuf; ++i) {
      esr::hopper::mbar_init(bars + 8 * i, 1);
      esr::hopper::mbar_init(bars + 8 * (p.nbuf + i), 4);
    }
    esr::hopper::mbar_init_fence();
  }
  __syncthreads();
  if (warp < NWG * 4) {  // the consumers stage the weights while the first tiles load
    stage_weights<NB>(wsm, static_cast<const bf16*>(a.w), 9, ng, gx, c0, cin, p.cout, part * NB,
                      wl, tid);
    if (S11)
      stage_weights<NB>(w11sm, static_cast<const bf16*>(a.w11), 1, gx, gx, c0, c0, p.cout,
                        part * NB, wl, tid);
    esr::hopper::fence_async_shared();
    esr::hopper::bar_sync(1, NWG * 128);
  }

  auto origin = [&](int j, int& b, int& y0, int& x0) {  // tile j of this block
    const int i = g + j * G, tx = i % p.ntx, r = i / p.ntx;
    b = r / p.nty;
    y0 = (r % p.nty) * TH;
    x0 = tx * tw;
  };
  // slice s of tile j: its slot and the fill of that slot it is (in order)
  auto slot_of = [&](int j, int s, int& buf, int& fill) {
    const int ql = (j / NWG) * nsl + s;
    buf = (j % NWG) * sb + ql % sb;
    fill = ql / sb;
  };
  auto groups_of = [&](int s) {  // groups of slice s
    return (ng < (s + 1) * SLICE_G ? ng : (s + 1) * SLICE_G) - s * SLICE_G;
  };

  if (warp == NWG * 4) {  // the producer warp
    const bf16* __restrict__ x = static_cast<const bf16*>(a.x);
    const bf16* __restrict__ cat = static_cast<const bf16*>(a.cat);
    const int hp = (TH + 2) * hw;
    for (int q = 0; q < mine * nsl; ++q) {
      const int j = q / nsl, s = q % nsl;
      int buf, fill, b, y0, x0;
      slot_of(j, s, buf, fill);
      if (fill > 0) mbar_wait(bars + 8 * (p.nbuf + buf), (fill - 1) & 1);
      origin(j, b, y0, x0);
      const int g0 = s * SLICE_G, groups = groups_of(s);
      const uint32_t dst = sbase + buf * slot, full = bars + 8 * buf;
      if (p.vec) {
        if (lane == 0) {
          esr::hopper::mbar_arrive_tx(full, groups * hp * GCH * 2);
          for (int k = 0; k < groups; ++k) {
            const int gg = g0 + k;
            if (gg < gx)
              esr::hopper::tma_load_4d(dst + k * gb, &tmx, full, gg * GCH, x0 - 1, y0 - 1, b);
            else
              esr::hopper::tma_load_4d(dst + k * gb, &tmc, full, (gg - gx) * GCH, x0 - 1, y0 - 1,
                                       b);
          }
        }
      } else {  // a channel at a time into the swizzled rows, 16-byte stores
        for (int i = lane; i < groups * hp * 4; i += 32) {
          const int c16 = i % 4, px = (i / 4) % hp, k = i / (4 * hp);
          const int gy = y0 - 1 + px / hw, gxx = x0 - 1 + px % hw;
          const bool in = gy >= 0 && gy < a.H && gxx >= 0 && gxx < a.W;
          const size_t pix = ((size_t)b * a.H + gy) * a.W + gxx;
          __align__(16) bf16 v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int c = k_channel((g0 + k) * GCH + c16 * 8 + e, c0, cin, gx);
            v[e] = !in || c < 0 ? __float2bfloat16_rn(0.f)
                   : c < c0     ? x[pix * c0 + c]
                                : cat[pix * a.ccat + (c - c0)];
          }
          const uint32_t at = dst + k * gb + px * 64 + ((c16 ^ ((px >> 1) & 3)) * 16);
          esr::hopper::st_shared16(at, *reinterpret_cast<const uint4*>(v));
        }
        esr::hopper::fence_async_shared();
        __syncwarp();
        if (lane == 0) mbar_arrive(full);
      }
    }
    return;
  }

  // the consumers
  const int wg = warp / 4, wq = warp % 4;
  const int n0 = part * NB, nl = n0 + (lane & 3) * 2;
  float bias[NB / 4];  // this thread's outputs' biases
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    bias[2 * j] = static_cast<const float*>(a.bias)[nl + 8 * j];
    bias[2 * j + 1] = static_cast<const float*>(a.bias)[nl + 8 * j + 1];
  }
  const bool resid = (p.mode == kActAdd || p.mode == kResid) && a.r1;
  // descriptors in 16-byte units: A at slot 0's first row, B at the weights
  const uint64_t da0 = esr::hopper::desc_sw64(sbase, hw * GCH * 2);
  const uint64_t db0 = desc_kmajor(wsm, NB * 16, 128), d11 = desc_kmajor(w11sm, NB * 16, 128);
  const uint32_t gbu = gb >> 4, chu = NB;  // a group, an 8-row K chunk of weights
  using esr::hopper::fence_regs;
  for (int j = wg; j < mine; j += NWG) {
    int b, y0, x0;
    origin(j, b, y0, x0);
    // the residuals this thread's outputs add, read now (their latency hides
    // behind the product); zero where not read
    uint32_t rr[MBX][2][2][NB / 8] = {};
    if (resid) {
#pragma unroll
      for (int mb = 0; mb < MBX; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gy = y0 + 2 * wq + h, xc = x0 + mb * 8 + (lane >> 2);
          if (mb >= MB || gy >= a.H || xc >= a.W) continue;
          const size_t pix = ((size_t)b * a.H + gy) * a.W + xc;
          const unsigned* r1 = reinterpret_cast<const unsigned*>(
              static_cast<const bf16*>(a.r1) + pix * a.r1_stride + nl);
          const unsigned* r2 = a.r2 && p.mode == kResid
                                   ? reinterpret_cast<const unsigned*>(
                                         static_cast<const bf16*>(a.r2) + pix * a.r2_stride + nl)
                                   : nullptr;
#pragma unroll
          for (int jj = 0; jj < NB / 8; ++jj) {
            rr[mb][0][h][jj] = __ldg(r1 + 4 * jj);
            if (r2) rr[mb][1][h][jj] = __ldg(r2 + 4 * jj);
          }
        }
    }
    float acc[MBX][NR], acc11[MBX][NR], part0[MBX][NR], part1[MBX][NR];
#pragma unroll
    for (int mb = 0; mb < MBX; ++mb)
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[mb][r] = 0.f;
    for (int s = 0; s < nsl; ++s) {
      int buf, fill;
      slot_of(j, s, buf, fill);
      const int groups = groups_of(s);
      mbar_wait(bars + 8 * buf, fill & 1);
      const uint64_t da = da0 + ((buf * slot) >> 4);
      const uint64_t db = db0 + s * SLICE_G * 4 * chu;
      // tap t's chains into the partials P, one commit group
      auto issue = [&](int t, float(&P)[MBX][NR]) {
        // the window starts at tile row dy, column dx: 4 units a pixel
        const uint32_t ta = ((t / 3) * hw + t % 3) * 4, tb = t * ng * 4 * chu;
#pragma unroll
        for (int mb = 0; mb < MBX; ++mb) fence_regs(P[mb]);
        esr::hopper::wgmma_fence();
#pragma unroll
        for (int mb = 0; mb < MBX; ++mb) {
          if (mb >= MB) break;
          const uint64_t dam = da + ta + mb * 32;  // M block mb: 8 pixels on
          for (int k = 0; k < groups; ++k)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              Wgmma<NB>::mma(P[mb], dam + k * gbu + 2 * h, db + tb + (4 * k + 2 * h) * chu,
                             k + h);
        }
        esr::hopper::wgmma_commit();
      };
      // a landed tap's partials join the totals
      auto join = [&](float(&P)[MBX][NR]) {
#pragma unroll
        for (int mb = 0; mb < MBX; ++mb) {
          fence_regs(P[mb]);
#pragma unroll
          for (int r = 0; r < NR; ++r) acc[mb][r] = __fadd_rn(acc[mb][r], P[mb][r]);
        }
      };
      if constexpr (S11) {  // the 1x1 over the centre tap's x groups: a group of its own
        // (one slice: the launch refuses a 1x1 with more)
#pragma unroll
        for (int mb = 0; mb < MBX; ++mb) fence_regs(acc11[mb]);
        esr::hopper::wgmma_fence();
#pragma unroll
        for (int mb = 0; mb < MBX; ++mb) {
          if (mb >= MB) break;
          const uint64_t dam = da + (hw + 1) * 4 + mb * 32;
          for (int k = 0; k < gx; ++k)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              Wgmma<NB>::mma(acc11[mb], dam + k * gbu + 2 * h, d11 + (4 * k + 2 * h) * chu,
                             k + h);
        }
        esr::hopper::wgmma_commit();
      }
      // taps 0..8 in order, the two partials alternating: tap t + 1's
      // chains run while tap t's partials join
      issue(0, part0);
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
      if constexpr (S11) {
#pragma unroll
        for (int mb = 0; mb < MBX; ++mb) fence_regs(acc11[mb]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (p.nbuf + buf));
    }
#pragma unroll
    for (int mb = 0; mb < MBX; ++mb) {
      if (mb >= MB) break;
      const int y = y0 + 2 * wq, xc = x0 + mb * 8 + (lane >> 2);
      if constexpr (S11) {
        float s11[NR];  // out of the wgmma registers before the divergent stores
#pragma unroll
        for (int r = 0; r < NR; ++r) s11[r] = acc11[mb][r];
        store_mblock<kAct1x1, NB>(a, acc[mb], s11, bias, p.cout, b, y, xc, n0, lane, rr[mb]);
      } else {
        switch (p.mode) {
          case kAct:
            store_mblock<kAct, NB>(a, acc[mb], acc[mb], bias, p.cout, b, y, xc, n0, lane, rr[mb]);
            break;
          case kActAdd:
            store_mblock<kActAdd, NB>(a, acc[mb], acc[mb], bias, p.cout, b, y, xc, n0, lane,
                                      rr[mb]);
            break;
          default:
            if (a.noise || a.seed)
              store_mblock<kResid, NB, true>(a, acc[mb], acc[mb], bias, p.cout, b, y, xc, n0,
                                             lane, rr[mb]);
            else
              store_mblock<kResid, NB>(a, acc[mb], acc[mb], bias, p.cout, b, y, xc, n0, lane,
                                       rr[mb]);
            break;
        }
      }
    }
  }
}

// static: the record of what was opted into stays with the library whose
// kernels it names (an inline function's statics are one for the whole
// process, however many libraries include this header)
template <int NB, typename L>
static int run(const DenseArgs& a, L wl, const CUtensorMap& tmx, const CUtensorMap& tmc,
        const KPlan& kp, const Plan& pl, bool s11, int dev, cudaStream_t stream) {
  auto kern = s11 ? dense_mma_kernel<NB, true, L> : dense_mma_kernel<NB, false, L>;
  static int opted[2][64] = {};  // the shared memory each variant opted into, by device
  int& have = opted[s11][dev & 63];
  if (pl.smem > have) {
    if (int e = esr::tile::smem_opt_in(kern, pl.smem)) return e;
    have = pl.smem;
  }
  kern<<<pl.blocks, NTH, pl.smem, stream>>>(a, wl, tmx, tmc, kp);
  return (int)cudaGetLastError();
}

// The SMs of device dev (read once a device).
inline int sm_count(int dev) {
  static int n[64] = {};
  if (!n[dev & 63]) cudaDeviceGetAttribute(&n[dev & 63], cudaDevAttrMultiProcessorCount, dev);
  return n[dev & 63];
}

template <typename L>
int launch(const DenseArgs& a, int cout, int mode, L wl, cudaStream_t stream) {
  const bool s11 = mode == kAct1x1;
  const int ng = groups_all(a.cin, a.c0), gx = groups_x(a.c0);
  int dev = 0;
  cudaGetDevice(&dev);
  const Plan pl = plan(cout, a.cin, a.c0, s11, a.B, a.H, a.W, sm_count(dev));
  if (!pl.nb || mode < kAct || mode > kResid || (s11 && ng > SLICE_G))
    return (int)cudaErrorInvalidValue;
  const bool vec = (a.c0 & 7) == 0 && (!a.cat || (a.ccat & 7) == 0);
  const KPlan kp{cout, mode, pl.tw, pl.nbuf, ng, gx, cout / pl.nb,
                 (a.W + pl.tw - 1) / pl.tw, (a.H + TH - 1) / TH, pl.tiles, vec};
  CUtensorMap tmx{}, tmc{};
  if (vec) {
    if (int e = esr::hopper::nhwc_map(&tmx, a.x, a.c0, a.c0, a.B, a.H, a.W, pl.tw + 2, TH + 2))
      return e;
    if (a.cat && a.cin > a.c0) {
      if (int e = esr::hopper::nhwc_map(&tmc, a.cat, a.cin - a.c0, a.ccat, a.B, a.H, a.W,
                                        pl.tw + 2, TH + 2))
        return e;
    }
  }
  switch (pl.nb) {
    case 8: return run<8>(a, wl, tmx, tmc, kp, pl, s11, dev, stream);
    case 16: return run<16>(a, wl, tmx, tmc, kp, pl, s11, dev, stream);
    case 32: return run<32>(a, wl, tmx, tmc, kp, pl, s11, dev, stream);
    case 64: return run<64>(a, wl, tmx, tmc, kp, pl, s11, dev, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dmma

template <typename T, int COUT, typename L>
int dispatch_mode(int mode, const DenseArgs& a, L wl, cudaStream_t s) {
  switch (mode) {
    case kAct: return launch_fma<T, COUT, kAct>(a, wl, s);
    case kAct1x1: return launch_fma<T, COUT, kAct1x1>(a, wl, s);
    case kActAdd: return launch_fma<T, COUT, kActAdd>(a, wl, s);
    case kResid: return launch_fma<T, COUT, kResid>(a, wl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The mma design takes the width and the mode at run time (its kernel is
// instantiated by the outputs a block owns); the FMA design by template.
template <typename T, bool MMA, typename L>
int dispatch_cout(int cout, int mode, const DenseArgs& a, L wl, cudaStream_t s) {
  if (cout != 8 && cout != 16 && cout != 32 && cout != 64) return (int)cudaErrorInvalidValue;
  if constexpr (MMA) {
    return dmma::launch(a, cout, mode, wl, s);
  } else {
    switch (cout) {
      case 8: return dispatch_mode<T, 8>(mode, a, wl, s);
      case 16: return dispatch_mode<T, 16>(mode, a, wl, s);
      case 32: return dispatch_mode<T, 32>(mode, a, wl, s);
      default: return dispatch_mode<T, 64>(mode, a, wl, s);
    }
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
