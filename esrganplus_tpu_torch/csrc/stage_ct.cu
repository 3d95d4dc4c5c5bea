// Early-stage convolutions of the discriminator and the VGG19 perceptual net
// (NHWC, sm_90a): a SAME 3x3 stride-1 conv and a 4x4 stride-2 pad-1 conv, each
// with bias and a fused activation, and their adjoints.
//
// Replaces four TPU kernels of esrganplus_tpu/kernels/stage_ct.py:
//   * conv_s1_ct (_conv_s1_kernel) and conv_s2_ct (_conv_s2_kernel): the
//     forward, stage_fwd_kernel<KS = 3 | 4> (fp32), stage_fwd_mma_kernel and
//     stage_fwd_s2_mma_kernel (bf16). fp32 accumulation over taps and
//     channels, + bias, the activation on the fp32 value, one rounding to T.
//   * _make_conv_s1_ct_diff (_conv_s1_bwd_kernel) and _make_conv_s2_ct_diff
//     (_conv_s2_bwd_kernel): the adjoint, split into a data-gradient kernel
//     (dx: stage_dgrad_kernel in fp32; stage_dgrad_mma_kernel and
//     stage_dgrad_s2_mma_kernel in bf16) and a weight-gradient kernel +
//     stage_wgrad_finish_kernel (dW, db: stage_wgrad_kernel in fp32,
//     stage_wgrad_mma_kernel<NCH, KS> in bf16), so that a caller whose
//     weights are frozen, or whose input is an image, launches only the half
//     it needs. dz = g * gate(saved forward output) is computed
//     in fp32 at load and never stored; db sums it unrounded, both products
//     take it rounded to T.
// The TPU kernels carry the image as column-phase planes [C, pixels] with the
// stride-2 conv as a phase decimation over parity buffers; none of that layout
// is kept. Here activations are NHWC, weights HWIO; the FMA stride-2 conv
// reads input rows 2i-1..2i+2 and columns 2j-1..2j+2 directly, the bf16 one
// splits its shared input tile into row- and column-parity planes (below).
//
// Bound on this card: operations at every flagship shape except the
// 3-channel entry convs (27 or 48 MAC per output against a 64-channel
// output write: bytes). Two designs, picked by the caller
// (kernels/stage_ct.py design) by dtype: bf16 runs on the tensor cores
// (the "mma" kernels below), fp32 on the FMA kernels, which accumulate on the
// CUDA cores in fp32 like the trunk kernels: a 256-thread block owns an 8x16
// output tile and
// up to 64 output channels (a wider conv takes several blocks per tile),
// stages a few input channels of the haloed tile and of every tap's weights
// in shared memory as fp32, and keeps a 4-pixel x CO/8-channel register tile.
// The input-channel loop stops at the real channel count, so the 3-channel
// convs do 3 channels' products and nothing is padded in device memory.
//
// The weight gradient is a reduction over all B*Ho*Wo pixels. Blocks run in no
// order and fp32 atomics would make a GAN step differ from run to run, so the
// reduction is split by shape alone: block (chunk, part) walks a fixed range
// of pixel tiles and writes its partial sums to row `part` of a workspace,
// and the finishing pass adds the rows in order.
#include "common.cuh"
#include "mma_tile.cuh"
#include "phase_fold.cuh"

#include <algorithm>

namespace {

using esr::from_f;
using esr::to_f;

constexpr int TH = 8;           // tile rows
constexpr int TW = 16;          // tile columns
constexpr int NT = 256;         // threads per block
constexpr int NCG = 8;          // channel groups per block
constexpr int NPG = NT / NCG;   // pixel groups (32)
constexpr int PPT = TH * TW / NPG;  // pixels per thread (4)

using esr::tile::act_fwd;
using esr::tile::kLrelu;
using esr::tile::kNone;
using esr::tile::kRelu;

// Cotangent through the activation; `ref` is the saved forward OUTPUT (relu
// and lrelu keep the sign, so the output's sign is the gate).
__device__ __forceinline__ float act_adj(float g, float ref, int act, float slope) {
  if (act == kRelu) return ref > 0.f ? g : 0.f;
  if (act == kLrelu) return ref >= 0.f ? g : g * slope;
  return g;
}

// dz at one output element, unrounded fp32.
template <typename T>
__device__ __forceinline__ float dz_at(const T* __restrict__ g, const T* __restrict__ outp,
                                       size_t idx, int act, float slope) {
  const float v = to_f(g[idx]);
  return act == kNone ? v : act_adj(v, to_f(outp[idx]), act, slope);
}

// ---------------------------------------------------------------------------
// forward: out[b, i, j, co] = act(sum x[b, S*i-1+dy, S*j-1+dx, ci] * w[dy, dx, ci, co] + bias)
// ---------------------------------------------------------------------------

template <typename T, int CO, int KS>
__global__ void __launch_bounds__(NT) stage_fwd_kernel(
    const T* __restrict__ x,         // [B, H, W, cin]
    const T* __restrict__ w,         // [KS, KS, cin, cout] (HWIO)
    const float* __restrict__ bias,  // [cout]
    T* __restrict__ out,             // [B, Ho, Wo, cout]
    int H, int W, int Ho, int Wo, int cin, int cout, int nchunk, int act, float slope) {
  constexpr int S = KS == 3 ? 1 : 2;
  constexpr int KC = KS == 3 ? 8 : 4;  // input channels staged per step
  constexpr int CPT = CO / NCG;
  constexpr int XH = S * (TH - 1) + KS, XW = S * (TW - 1) + KS;
  __shared__ float xs[KC][XH][XW];
  __shared__ float ws[KS * KS][KC][CO];

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int b = blockIdx.z / nchunk;
  const int cbeg = (blockIdx.z % nchunk) * CO;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;

  float acc[PPT][CPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += KC) {
    const int kend = min(KC, cin - k0);
    for (int i = tid; i < KC * XH * XW; i += NT) {
      const int kk = i % KC;
      const int p = i / KC;
      const int ty = p / XW, tx = p % XW;
      const int gy = iy0 + ty, gx = ix0 + tx, c = k0 + kk;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin)
        v = to_f(x[(((size_t)b * H + gy) * W + gx) * cin + c]);
      xs[kk][ty][tx] = v;
    }
    for (int i = tid; i < KS * KS * KC * CO; i += NT) {
      const int co = i % CO;
      const int kk = (i / CO) % KC;
      const int t = i / (CO * KC);
      const int c = k0 + kk;
      ws[t][kk][co] = c < cin ? to_f(w[((size_t)t * cin + c) * cout + cbeg + co]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kend; ++kk) {
#pragma unroll
      for (int t = 0; t < KS * KS; ++t) {
        const int dy = t / KS, dx = t % KS;
        float wv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) wv[j] = ws[t][kk][cg * CPT + j];
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const int p = pg + NPG * i;
          const float v = xs[kk][S * (p / TW) + dy][S * (p % TW) + dx];
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(v, wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = pg + NPG * i;
    const int oy = oy0 + p / TW, ox = ox0 + p % TW;
    if (oy >= Ho || ox >= Wo) continue;
    const size_t pix = ((size_t)b * Ho + oy) * Wo + ox;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cbeg + cg * CPT + j;
      out[pix * cout + c] = from_f<T>(act_fwd(acc[i][j] + bias[c], act, slope));
    }
  }
}

// ---------------------------------------------------------------------------
// data gradient: dx[b, y, x, ci] = sum over the taps (dy, dx) that reach input
// pixel (y, x) of round_T(dz[b, (y+1-dy)/S, (x+1-dx)/S, co]) * w[dy, dx, ci, co]
// ---------------------------------------------------------------------------

template <typename T, int CO, int KS>
__global__ void __launch_bounds__(NT) stage_dgrad_kernel(
    const T* __restrict__ g,     // [B, Ho, Wo, cout]: the output's cotangent
    const T* __restrict__ outp,  // [B, Ho, Wo, cout]: the saved output (null for kNone)
    const T* __restrict__ w,     // [KS, KS, cin, cout]
    T* __restrict__ dx,          // [B, H, W, cin]
    int H, int W, int Ho, int Wo, int cin, int cout, int nchunk, int act, float slope) {
  constexpr int S = KS == 3 ? 1 : 2;
  constexpr int KC = 8;           // dz channels staged per step
  constexpr int NTAP = KS / S + (KS % S ? 1 : 0);  // taps per axis that reach one pixel
  constexpr int CPT = CO / NCG;
  constexpr int ZH = TH / S + 2, ZW = TW / S + 2;
  __shared__ float zs[KC][ZH][ZW];
  __shared__ float ws[KS * KS][KC][CO];

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int b = blockIdx.z / nchunk;
  const int cbeg = (blockIdx.z % nchunk) * CO;       // first dx channel of the block
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int zy0 = y0 / S - 1, zx0 = x0 / S - 1;
  // this thread's pixels: column lx, rows ly0, ly0+2, ly0+4, ly0+6, so all
  // four share the parity that selects the stride-2 conv's taps
  const int ly0 = pg / TW, lx = pg % TW;
  const int ry = (ly0 + 1) % S, rx = (lx + 1) % S;

  float acc[PPT][CPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cout; k0 += KC) {
    const int kend = min(KC, cout - k0);
    for (int i = tid; i < KC * ZH * ZW; i += NT) {
      const int kk = i % KC;
      const int p = i / KC;
      const int ty = p / ZW, tx = p % ZW;
      const int zy = zy0 + ty, zx = zx0 + tx, c = k0 + kk;
      float v = 0.f;
      if (zy >= 0 && zy < Ho && zx >= 0 && zx < Wo && c < cout) {
        const size_t idx = (((size_t)b * Ho + zy) * Wo + zx) * cout + c;
        v = esr::round_to<T>(dz_at<T>(g, outp, idx, act, slope));
      }
      zs[kk][ty][tx] = v;
    }
    for (int i = tid; i < KS * KS * KC * CO; i += NT) {
      const int kk = i % KC;
      const int co = (i / KC) % CO;
      const int t = i / (KC * CO);
      const int c = k0 + kk, ci = cbeg + co;
      ws[t][kk][co] = (c < cout && ci < cin) ? to_f(w[((size_t)t * cin + ci) * cout + c]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kend; ++kk) {
#pragma unroll
      for (int a = 0; a < NTAP; ++a) {
#pragma unroll
        for (int bb = 0; bb < NTAP; ++bb) {
          const int dy = ry + S * a, dxx = rx + S * bb;
          const int tx = (lx + 1 - dxx) / S + 1;
          float wv[CPT];
#pragma unroll
          for (int j = 0; j < CPT; ++j) wv[j] = ws[dy * KS + dxx][kk][cg * CPT + j];
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            const int ty = (ly0 + 2 * i + 1 - dy) / S + 1;
            const float v = zs[kk][ty][tx];
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(v, wv[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int y = y0 + ly0 + 2 * i, xx = x0 + lx;
    if (y >= H || xx >= W) continue;
    const size_t pix = ((size_t)b * H + y) * W + xx;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cbeg + cg * CPT + j;
      if (c < cin) dx[pix * cin + c] = from_f<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// weight and bias gradient:
//   dW[dy, dx, ci, co] = sum_p x[S*i-1+dy, S*j-1+dx, ci] * round_T(dz[p, co])
//   db[co]             = sum_p dz[p, co]                    (unrounded, fp32)
// A thread owns one input channel and SC/16 output channels for all KS*KS
// taps and slides a KSxKS register window along each tile row.
// ---------------------------------------------------------------------------

template <typename T, int SC, int KS>
__global__ void __launch_bounds__(NT) stage_wgrad_kernel(
    const T* __restrict__ x,     // [B, H, W, cin]
    const T* __restrict__ g,     // [B, Ho, Wo, cout]
    const T* __restrict__ outp,  // [B, Ho, Wo, cout] (null for kNone)
    float* __restrict__ part,    // [npart][KS*KS*cin*cout + cout]
    int H, int W, int Ho, int Wo, int cin, int cout, int nco_chunks, int act, float slope,
    int tiles_per_part, int total_tiles, int tiles_x, int tiles_y) {
  constexpr int S = KS == 3 ? 1 : 2;
  constexpr int WTH = KS == 3 ? 8 : 4;    // output tile rows (the 4x4 conv's input tile is twice as large)
  constexpr int WTW = 16;
  constexpr int NCO = SC >= 16 ? 16 : SC;  // output-channel groups
  constexpr int KC = NT / NCO;             // input channels per block
  constexpr int CPT = SC / NCO;
  constexpr int XH = S * (WTH - 1) + KS, XW = S * (WTW - 1) + KS;
  __shared__ float xs[XH][XW][KC];
  __shared__ float dzs[WTH * WTW][SC];
  __shared__ float red[NT];

  const int tid = threadIdx.x;
  const int ci = tid / NCO;
  const int cog = tid % NCO;
  const int cbeg = (blockIdx.x / nco_chunks) * KC;
  const int obeg = (blockIdx.x % nco_chunks) * SC;
  const size_t row = (size_t)KS * KS * cin * cout + cout;
  float* out = part + (size_t)blockIdx.y * row;

  float acc[KS * KS][CPT];
#pragma unroll
  for (int t = 0; t < KS * KS; ++t)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[t][j] = 0.f;
  float dbacc = 0.f;  // this thread always stages output channel tid % SC

  const int tile_end = min(total_tiles, (int)(blockIdx.y + 1) * tiles_per_part);
  for (int tile = blockIdx.y * tiles_per_part; tile < tile_end; ++tile) {
    const int b = tile / (tiles_x * tiles_y);
    const int oy0 = (tile / tiles_x) % tiles_y * WTH, ox0 = tile % tiles_x * WTW;
    for (int i = tid; i < XH * XW * KC; i += NT) {
      const int kk = i % KC;
      const int p = i / KC;
      const int gy = oy0 * S - 1 + p / XW, gx = ox0 * S - 1 + p % XW, c = cbeg + kk;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin)
        v = to_f(x[(((size_t)b * H + gy) * W + gx) * cin + c]);
      xs[p / XW][p % XW][kk] = v;
    }
    for (int i = tid; i < WTH * WTW * SC; i += NT) {
      const int co = i % SC;
      const int p = i / SC;
      const int oy = oy0 + p / WTW, ox = ox0 + p % WTW;
      float v = 0.f;
      if (oy < Ho && ox < Wo && obeg + co < cout)
        v = dz_at<T>(g, outp, (((size_t)b * Ho + oy) * Wo + ox) * cout + obeg + co, act, slope);
      dbacc += v;
      dzs[p][co] = esr::round_to<T>(v);
    }
    __syncthreads();
    for (int y = 0; y < WTH; ++y) {
      float a[KS][KS];
#pragma unroll
      for (int dy = 0; dy < KS; ++dy)
#pragma unroll
        for (int dx = 0; dx < KS - S; ++dx) a[dy][dx] = xs[S * y + dy][dx][ci];
#pragma unroll
      for (int px = 0; px < WTW; ++px) {
        float d[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) d[j] = dzs[y * WTW + px][cog + NCO * j];
#pragma unroll
        for (int dy = 0; dy < KS; ++dy) {
#pragma unroll
          for (int dx = KS - S; dx < KS; ++dx) a[dy][dx] = xs[S * y + dy][S * px + dx][ci];
#pragma unroll
          for (int dx = 0; dx < KS; ++dx)
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              acc[dy * KS + dx][j] = fmaf(a[dy][dx], d[j], acc[dy * KS + dx][j]);
#pragma unroll
          for (int dx = 0; dx < KS - S; ++dx) a[dy][dx] = a[dy][dx + S];
        }
      }
    }
    __syncthreads();
  }

  if (cbeg + ci < cin) {
#pragma unroll
    for (int t = 0; t < KS * KS; ++t)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int co = obeg + cog + NCO * j;
        if (co < cout) out[((size_t)t * cin + cbeg + ci) * cout + co] = acc[t][j];
      }
  }
  if (cbeg == 0) {  // db from the staged, unrounded dz, in a fixed order
    red[tid] = dbacc;
    __syncthreads();
    if (tid < SC && obeg + tid < cout) {
      float v = 0.f;
      for (int k = 0; k < NT / SC; ++k) v += red[tid + SC * k];
      out[(size_t)KS * KS * cin * cout + obeg + tid] = v;
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in that order.
__global__ void stage_wgrad_finish_kernel(const float* __restrict__ part, int npart,
                                          size_t row, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= row) return;
  float v = 0.f;
  for (int p = 0; p < npart; ++p) v += part[(size_t)p * row + i];
  out[i] = v;
}

// ===========================================================================
// The bf16 tensor-core design ("mma") of the 3x3 stride-1 conv and its adjoint.
//
// Each of the three products is an implicit GEMM on mma.sync m16n8k16 (bf16 in,
// fp32 accumulators) with operands read from shared memory by ldmatrix; nothing
// is im2col'ed in device memory and the rounding points are the FMA kernels'.
//   * forward: M = a block's 8x16 output pixels, N = all of cout, K = 9 taps x
//     cin. The haloed 10x18 input tile is copied once as [pixel][cin] rows
//     (cp.async, the zero ring written as zero-fill); a tap's A fragments are
//     ldmatrix reads of the same tile at a shifted pixel row. The weights (HWIO:
//     [k = ci][n = co] rows) stream through a 3-slot cp.async ring, one
//     (tap, 64-channel) slice at a time, and reach B through ldmatrix.trans.
//   * data gradient: the same GEMM with M = input pixels, N = cin, K = 9 taps x
//     cout, taps flipped. The haloed g tile lands by cp.async beside the first
//     weight slices and becomes dz in place (gate from the saved output in
//     fp32, one rounding; without an activation dz is g itself); w[t][ci][co]
//     is already the [n][k] layout that plain ldmatrix reads.
//   * weight gradient: M = (ci chunk of 16, tap) rows, N = cout, K = pixels. A
//     block owns 12 such m16 tiles and up to 64 output channels, and walks a
//     fixed range of 4x16 pixel tiles through a double-buffered cp.async
//     pipeline (x, g, the saved output); dz is formed in shared memory, its
//     unrounded value added to the block's db partial. Partial rows and the
//     fixed-order finishing pass keep the reduction order a function of the
//     shapes.
//   * 4x4 stride-2 forward: M = a block's 8x16 output pixels, N = cout, K = 16
//     taps x cin. Output pixel (i, j) reads padded input row 2i + ky and column
//     2j + kx, so the block's haloed 18x34 input tile is staged as four parity
//     planes (row & 1, column & 1) of 9x17 pixels each: tap (ky, kx) of output
//     pixel (i, j) is pixel (i + ky/2, j + kx/2) of plane (ky & 1, kx & 1), a
//     shifted row of one plane, as in the 3x3 forward. Eight neighbouring
//     output pixels are then consecutive plane rows (in the unsplit tile they
//     would be 2 pixels apart, 4 bank groups against an odd pitch). The planes
//     hold s2_xc(cout) input channels at a time and the weight ring walks
//     (chunk, tap) stages: 32 at cout <= 64 (a 63 KB block), 64 at 128 (140 KB,
//     one block an SM; the 32x32 output of the flagship 128-wide conv makes
//     only 128 blocks, so fewer, longer chunks win). Measured on the H100
//     against 4x16 tiles and other chunks (PERF.md).
//   * 4x4 stride-2 data gradient: the four parity classes of dx are 2x2
//     stride-1 convs of dz, input row 2m + a taking dz rows m + a - 1 + i
//     through tap 3 - a - 2i (columns likewise): the phase fold of
//     csrc/phase_fold.cuh, M = a block's 8x16 dz pixels, N = cin, K = 4 taps
//     x cout per phase; the haloed 10x18 g tile becomes dz in place (as in the
//     3x3 data gradient) and stays resident for the four phases, each phase
//     stored as 16-byte vectors at the strided dx pixels.
//   * 4x4 stride-2 weight gradient: the 3x3 weight gradient's kernel at KS = 4
//     (Wg<4>): 16 taps, a block owns one chunk of 16 input channels x 16
//     taps, and a 4x16 output-pixel tile's haloed 10x34 input tile is staged
//     as four parity planes, so the run of 16 output
//     pixels of a tap is a run of consecutive rows of plane (ky & 1, kx & 1),
//     read by ldmatrix.trans as in the stride-2 forward.
// The forward and data-gradient blocks are 8 warps of 32-pixel warp tiles when
// a width is above 64 (two ~100 KB blocks an SM), else 4 warps of 64-pixel
// tiles (fewer ldmatrix per mma: shared-memory bandwidth, not the tensor
// cores, bounds mma.sync fed from shared memory); the stride-2 forward is
// always 8 warps. Input channels are padded
// to 16 in shared memory only (the 3-channel entry convs), and an input whose
// channel count is not a multiple of 8 is staged a pixel at a time with plain
// loads (no 16-byte alignment). Bound: operations at 64+ channels, bytes at
// the 3-channel convs.
// ===========================================================================

namespace mk {

using esr::mma::cp_async16;
using esr::mma::ldsm_pitch;
using esr::mma::smem_u32;
using esr::tile::acc_to_smem;
using esr::tile::bf16;
using esr::tile::HP;   // the 8x16 forward / data-gradient pixel tile (csrc/mma_tile.cuh)
using esr::tile::HW;
using esr::tile::pack8;
using esr::tile::PIX;
using esr::tile::round16;
using esr::tile::smem_to_out;
using esr::tile::stage_tile;
using esr::tile::TH;
using esr::tile::Tiling;
using esr::tile::TW;
using esr::tile::warp_mma;

constexpr int NT = 256;                 // threads of a weight-gradient block (8 warps)
constexpr int KCH = 64;                 // K rows of one weight-ring slot
constexpr int NSLOT = 3;                // weight-ring depth
constexpr int WG_TH = 4;                // weight-gradient pixel tile: 4x16 = 64 pixels of K
constexpr int WG_PIX = WG_TH * TW;
constexpr int S2_PW = TW + 1;           // stride-2 forward (TH x TW output pixels): a parity
constexpr int S2_PP = (TH + 1) * S2_PW; // plane is (TH + 1) x (TW + 1) pixels
constexpr int S2_NW = 8;                // warps of a stride-2 forward block


// input channels a stride-2 forward block stages at a time (K rows of a ring slot)
__host__ __device__ constexpr int s2_xc(int np) { return np > 64 ? 64 : 32; }

// The weight gradient by kernel size: its WG_TH x TW output-pixel tile reads a
// haloed XH x XW input tile (four parity planes of PP pixels at KS = 4). A
// block owns MT m16 tiles m = (ci chunk m / NTAP, tap m % NTAP) and stages
// the XC input channels they span: at KS = 3, 12 tiles from m0 % 9 = 0, 3 or
// 6 span at most two chunks of 16; at KS = 4 a block is one chunk's 16 taps,
// its pixel-row loop unrolled by 2 to fit 128 registers without a spill (on
// the H100 11 % faster than 12 tiles of two chunks: PERF.md).
// kernels/stage_ct.py WG_MT mirrors MT.
template <int KS>
struct Wg {
  static constexpr int S = KS == 3 ? 1 : 2;
  static constexpr int NTAP = KS * KS;
  static constexpr int MT = KS == 3 ? 12 : 16;
  static constexpr int XC = KS == 3 ? 32 : 16;
  static constexpr int XH = S * (WG_TH - 1) + KS, XW = S * (TW - 1) + KS;
  static constexpr int PW = XW / 2, PP = XH / 2 * PW;
};

// dz = gate(g, saved output) in fp32 for 8 channels.
__device__ __forceinline__ void dz8(const uint4& gv, const uint4& ov, int act, float slope,
                                    float (&d)[8]) {
  const bf16* gp = reinterpret_cast<const bf16*>(&gv);
  const bf16* op = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float v = __bfloat162float(gp[k]);
    d[k] = act == kNone ? v : act_adj(v, __bfloat162float(op[k]), act, slope);
  }
}



// The haloed g tile (origin zy0, zx0; coutp channels in rows of zp bytes)
// becomes dz in place: gated by the saved output in fp32, rounded once.
// Pixels outside the H x W image were zero-filled and stay zero.
template <int NTH>
__device__ __forceinline__ void gate_tile(unsigned char* smem, int zp,
                                          const bf16* __restrict__ outp, int b, int zy0, int zx0,
                                          int H, int W, int cout, int coutp, int act, float slope,
                                          int tid) {
  const int nc = coutp / 8;
#pragma unroll 4
  for (int i = tid; i < HP * nc; i += NTH) {
    const int p = i / nc, c8 = i % nc;
    const int zy = zy0 + p / HW, zx = zx0 + p % HW, co = c8 * 8;
    if (zy >= 0 && zy < H && zx >= 0 && zx < W && co < cout) {  // else g was zero-filled
      uint4* z = reinterpret_cast<uint4*>(smem + p * zp + c8 * 16);
      float d[8];
      dz8(*z, *reinterpret_cast<const uint4*>(outp + (((size_t)b * H + zy) * W + zx) * cout + co),
          act, slope, d);
      *z = pack8(d);
    }
  }
}

// ---------------------------------------------------------------------------
// forward: NP = cout
// ---------------------------------------------------------------------------

template <int NP, int NW>
__global__ void __launch_bounds__(Tiling<NP, NW>::NTH, Tiling<NP, NW>::MIN_BLOCKS)
    stage_fwd_mma_kernel(
    const bf16* __restrict__ x,      // [B, H, W, cin]
    const bf16* __restrict__ w,      // [3, 3, cin, NP]
    const float* __restrict__ bias,  // [NP]
    bf16* __restrict__ out,          // [B, H, W, NP]
    int H, int W, int cin, int act, float slope) {
  using Tl = Tiling<NP, NW>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int cinp = round16(cin);
  const int xp = ldsm_pitch(cinp);
  constexpr int WP = ldsm_pitch(NP);
  const int slot = min(KCH, cinp) * WP;
  const uint32_t xs = smem_u32(smem), ws = xs + HP * xp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Tl::WN, wn = warp % Tl::WN;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int nkc = (cinp + KCH - 1) / KCH, nstage = 9 * nkc;

  auto load_w = [&](int s) {  // stage s = (tap, channel slice) into ring slot s % NSLOT
    const int t = s / nkc, c0 = (s % nkc) * KCH, len = min(KCH, cinp - c0);
    const uint32_t dst = ws + (s % NSLOT) * slot;
    constexpr int NC = NP / 8;
    for (int i = tid; i < len * NC; i += Tl::NTH) {
      const int r = i / NC, n8 = i % NC, ci = c0 + r;
      const bool ok = ci < cin;
      cp_async16(dst + r * WP + n8 * 16, ok ? w + ((size_t)t * cin + ci) * NP + n8 * 8 : w, ok);
    }
  };
  stage_tile<TH + 2, HW>(x, smem, xp, b, y0 - 1, x0 - 1, H, W, cin, 0, cinp, tid);
  esr::mma::cp_async_commit();
  load_w(0);
  esr::mma::cp_async_commit();
  load_w(1);
  esr::mma::cp_async_commit();

  float acc[Tl::MT][Tl::NT8][4];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  uint32_t arow[Tl::MT];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
    arow[i] = xs + ((wm * Tl::MT + i) * HW + (lane & 15)) * xp + (lane >> 4) * 16;

  for (int s = 0; s < nstage; ++s) {
    esr::mma::cp_async_wait<1>();  // the input tile and stage s have landed
    __syncthreads();               // ... for every thread, and slot (s+2) % 3 is free
    if (s + 2 < nstage) load_w(s + 2);
    esr::mma::cp_async_commit();
    const int t = s / nkc, c0 = (s % nkc) * KCH, len = min(KCH, cinp - c0);
    const int shift = (t / 3) * HW + t % 3;
    uint32_t a[Tl::MT];
#pragma unroll
    for (int i = 0; i < Tl::MT; ++i) a[i] = arow[i] + shift * xp + c0 * 2;
    warp_mma<Tl::MT, Tl::NT8, true>(acc, a, ws + (s % NSLOT) * slot, WP, wn * Tl::NT8 * 8, len,
                                    lane);
  }
  esr::mma::cp_async_wait<0>();
  __syncthreads();
  acc_to_smem<NP, NW>(acc, smem, WP, bias, act, slope, warp, lane);
  __syncthreads();
  smem_to_out(smem, WP, out, b, y0, x0, H, W, NP, tid);
}

// ---------------------------------------------------------------------------
// 4x4 stride-2 pad-1 forward: NP = cout, the input as parity planes
// ---------------------------------------------------------------------------

template <int NP>
__global__ void __launch_bounds__(Tiling<NP, S2_NW>::NTH, Tiling<NP, S2_NW>::MIN_BLOCKS)
    stage_fwd_s2_mma_kernel(
    const bf16* __restrict__ x,      // [B, H, W, cin]
    const bf16* __restrict__ w,      // [4, 4, cin, NP]
    const float* __restrict__ bias,  // [NP]
    bf16* __restrict__ out,          // [B, Ho, Wo, NP]
    int H, int W, int Ho, int Wo, int cin, int act, float slope) {
  using Tl = Tiling<NP, S2_NW>;
  constexpr int XC = s2_xc(NP);
  extern __shared__ __align__(128) unsigned char smem[];
  const int cinp = round16(cin);
  const int xc = min(XC, cinp);  // channels of a staged chunk, and K rows of a ring slot
  const int xp = ldsm_pitch(xc);
  constexpr int WP = ldsm_pitch(NP);
  const int slot = xc * WP;
  const uint32_t xs = smem_u32(smem), ws = xs + 4 * S2_PP * xp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Tl::WN, wn = warp % Tl::WN;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int nkc = (cinp + XC - 1) / XC, nstage = 16 * nkc;

  // the input rows 2*y0 - 1 .. 2*y0 + 2*TH and columns likewise, channel
  // chunk kc, as four parity planes
  auto load_x = [&](int kc) {
    stage_tile<2 * TH + 2, 2 * TW + 2, true>(x, smem, xp, b, 2 * y0 - 1, 2 * x0 - 1, H, W, cin,
                                             kc * XC, xc, tid);
  };
  auto load_w = [&](int s) {  // stage s = (chunk s / 16, tap s % 16) into slot s % NSLOT
    const int t = s % 16, c0 = (s / 16) * XC, len = min(XC, cinp - c0);
    const uint32_t dst = ws + (s % NSLOT) * slot;
    constexpr int NC = NP / 8;
    for (int i = tid; i < len * NC; i += Tl::NTH) {
      const int r = i / NC, n8 = i % NC, ci = c0 + r;
      const bool ok = ci < cin;
      cp_async16(dst + r * WP + n8 * 16, ok ? w + ((size_t)t * cin + ci) * NP + n8 * 8 : w, ok);
    }
  };
  load_x(0);
  esr::mma::cp_async_commit();
  load_w(0);
  esr::mma::cp_async_commit();
  load_w(1);
  esr::mma::cp_async_commit();

  float acc[Tl::MT][Tl::NT8][4];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  uint32_t arow[Tl::MT];  // output tile row = plane row, lane & 15 = plane column
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
    arow[i] = xs + ((wm * Tl::MT + i) * S2_PW + (lane & 15)) * xp + (lane >> 4) * 16;

  for (int s = 0; s < nstage; ++s) {
    if (s > 0 && s % 16 == 0) {  // the next channel chunk replaces this one
      __syncthreads();           // every warp is done with it
      load_x(s / 16);
      esr::mma::cp_async_commit();
      esr::mma::cp_async_wait<0>();
    }
    esr::mma::cp_async_wait<1>();  // the input chunk and stage s have landed
    __syncthreads();               // ... for every thread, and slot (s+2) % 3 is free
    if (s + 2 < nstage) load_w(s + 2);
    esr::mma::cp_async_commit();
    const int t = s % 16, ky = t / 4, kx = t % 4;
    const int len = min(XC, cinp - (s / 16) * XC);
    const int shift = ((ky & 1) * 2 + (kx & 1)) * S2_PP + (ky >> 1) * S2_PW + (kx >> 1);
    uint32_t a[Tl::MT];
#pragma unroll
    for (int i = 0; i < Tl::MT; ++i) a[i] = arow[i] + shift * xp;
    warp_mma<Tl::MT, Tl::NT8, true>(acc, a, ws + (s % NSLOT) * slot, WP, wn * Tl::NT8 * 8, len,
                                    lane);
  }
  esr::mma::cp_async_wait<0>();
  __syncthreads();
  acc_to_smem<NP, S2_NW>(acc, smem, WP, bias, act, slope, warp, lane);
  __syncthreads();
  smem_to_out(smem, WP, out, b, y0, x0, Ho, Wo, NP, tid);
}

// ---------------------------------------------------------------------------
// data gradient: NP = cin rounded up to 8, 16, 32, 64 or 128
// ---------------------------------------------------------------------------

template <int NP, int NW>
__global__ void __launch_bounds__(Tiling<NP, NW>::NTH, Tiling<NP, NW>::MIN_BLOCKS)
    stage_dgrad_mma_kernel(
    const bf16* __restrict__ g,     // [B, H, W, cout]
    const bf16* __restrict__ outp,  // [B, H, W, cout] (null for kNone)
    const bf16* __restrict__ w,     // [3, 3, cin, cout]
    bf16* __restrict__ dx,          // [B, H, W, cin]
    int H, int W, int cin, int cout, int act, float slope) {
  using Tl = Tiling<NP, NW>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int coutp = round16(cout);
  const int zp = ldsm_pitch(coutp);
  const int kch = min(KCH, coutp);
  const int wp = ldsm_pitch(kch);
  const int slot = NP * wp;
  const uint32_t zs = smem_u32(smem), ws = zs + HP * zp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Tl::WN, wn = warp % Tl::WN;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int nkc = (coutp + kch - 1) / kch, nstage = 9 * nkc;

  auto load_w = [&](int s) {  // w[t][ci][c0 .. c0+len) as [n = ci][k = co] rows
    const int t = s / nkc, c0 = (s % nkc) * kch, len = min(kch, coutp - c0);
    const uint32_t dst = ws + (s % NSLOT) * slot;
    const int nc = len / 8;
    for (int i = tid; i < NP * nc; i += Tl::NTH) {
      const int ci = i / nc, k8 = i % nc, co = c0 + k8 * 8;
      const bool ok = ci < cin && co < cout;
      cp_async16(dst + ci * wp + k8 * 16, ok ? w + ((size_t)t * cin + ci) * cout + co : w, ok);
    }
  };
  // the haloed g tile beside the first weight slices
  stage_tile<TH + 2, HW>(g, smem, zp, b, y0 - 1, x0 - 1, H, W, cout, 0, coutp, tid);
  esr::mma::cp_async_commit();
  load_w(0);
  esr::mma::cp_async_commit();
  load_w(1);
  esr::mma::cp_async_commit();
  if (act != kNone) {  // dz in place of g, gated by the saved output, rounded once
    esr::mma::cp_async_wait<2>();  // (without a gate dz is g itself)
    __syncthreads();
    gate_tile<Tl::NTH>(smem, zp, outp, b, y0 - 1, x0 - 1, H, W, cout, coutp, act, slope, tid);
  }

  float acc[Tl::MT][Tl::NT8][4];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  uint32_t arow[Tl::MT];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
    arow[i] = zs + ((wm * Tl::MT + i) * HW + (lane & 15)) * zp + (lane >> 4) * 16;

  for (int s = 0; s < nstage; ++s) {
    esr::mma::cp_async_wait<1>();
    __syncthreads();
    if (s + 2 < nstage) load_w(s + 2);
    esr::mma::cp_async_commit();
    const int t = s / nkc, c0 = (s % nkc) * kch, len = min(kch, coutp - c0);
    const int shift = (2 - t / 3) * HW + 2 - t % 3;  // dz pixel (y + 1 - dy, x + 1 - dx)
    uint32_t a[Tl::MT];
#pragma unroll
    for (int i = 0; i < Tl::MT; ++i) a[i] = arow[i] + shift * zp + c0 * 2;
    warp_mma<Tl::MT, Tl::NT8, false>(acc, a, ws + (s % NSLOT) * slot, wp, wn * Tl::NT8 * 8, len,
                                     lane);
  }
  esr::mma::cp_async_wait<0>();
  __syncthreads();
  constexpr int DP = ldsm_pitch(NP);
  acc_to_smem<NP, NW>(acc, smem, DP, nullptr, kNone, 0.f, warp, lane);
  __syncthreads();
  smem_to_out(smem, DP, dx, b, y0, x0, H, W, cin, tid);
}

// ---------------------------------------------------------------------------
// 4x4 stride-2 data gradient: NP = cin rounded up to 8, 16, 32, 64 or 128;
// the phase fold of csrc/phase_fold.cuh over the block's dz tile
// ---------------------------------------------------------------------------

template <int NP, int NW>
__global__ void __launch_bounds__(NW * 32, esr::fold::fold_min_blocks<NW>())
    stage_dgrad_s2_mma_kernel(
    const bf16* __restrict__ g,     // [B, Ho, Wo, cout]
    const bf16* __restrict__ outp,  // [B, Ho, Wo, cout] (null for kNone)
    const bf16* __restrict__ w,     // [4, 4, cin, cout]
    bf16* __restrict__ dx,          // [B, 2Ho, 2Wo, cin]
    int Ho, int Wo, int cin, int cout, int act, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int coutp = round16(cout), zp = ldsm_pitch(coutp);
  const int wp = ldsm_pitch(esr::fold::fold_kch(coutp));
  const int tid = threadIdx.x;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  auto stage_g = [&](int c0, int len, int pitch) {  // the whole tile: cout <= 128 fits
    stage_tile<TH + 2, HW>(g, smem, pitch, b, y0 - 1, x0 - 1, Ho, Wo, cout, c0, len, tid);
  };
  // slice (a, b, i, j): w[3-a-2i][3-b-2j] as [n = ci][k = co] rows, K rows c0 ..
  auto load_w = [&](uint32_t dst, int ph, int t, int c0, int len) {
    const int tap = (3 - (ph >> 1) - 2 * (t >> 1)) * 4 + 3 - (ph & 1) - 2 * (t & 1);
    const int nc = len / 8;
    for (int i = tid; i < NP * nc; i += NW * 32) {
      const int ci = i / nc, k8 = i % nc, co = c0 + k8 * 8;
      const bool ok = ci < cin && co < cout;
      cp_async16(dst + ci * wp + k8 * 16, ok ? w + ((size_t)tap * cin + ci) * cout + co : w, ok);
    }
  };
  auto gate = [&] {  // dz in place of g (without a gate dz is g itself)
    if (act == kNone) return;
    esr::mma::cp_async_wait<2>();
    __syncthreads();
    gate_tile<NW * 32>(smem, zp, outp, b, y0 - 1, x0 - 1, Ho, Wo, cout, coutp, act, slope, tid);
  };
  auto store = [&](int ph, const unsigned char* src, int pitch) {  // dx(2y + a, 2x + b)
    smem_to_out<2>(src, pitch, dx, b, y0, x0, Ho, Wo, cin, tid, ph >> 1, ph & 1);
  };
  esr::fold::fold_mma<NP, NW, false>(smem, coutp, stage_g, load_w, gate, nullptr, kNone, 0.f,
                                     store);
}

// ---------------------------------------------------------------------------
// weight and bias gradient: a block owns Wg<KS>::MT m16 tiles of (ci, tap)
// rows and NCH (16, 32 or 64) output channels
// ---------------------------------------------------------------------------

template <int NCH, int KS>
__global__ void __launch_bounds__(NT, 2) stage_wgrad_mma_kernel(
    const bf16* __restrict__ x,     // [B, H, W, cin]
    const bf16* __restrict__ g,     // [B, Ho, Wo, cout]
    const bf16* __restrict__ outp,  // [B, Ho, Wo, cout] (null for kNone)
    float* __restrict__ part,       // [npart][KS*KS*cin*cout + cout]
    int H, int W, int cin, int cout, int act, float slope, int tiles_per_part, int total_tiles,
    int tiles_x, int tiles_y) {
  using G = Wg<KS>;
  constexpr int WN = 2, MT = G::MT / 4, NT8 = NCH / 16;  // 4 x 2 warps of MT m16 x NCH/2
  constexpr int XP = ldsm_pitch(G::XC), GP = ldsm_pitch(NCH);
  constexpr int XBYTES = G::XH * G::XW * XP, GBYTES = WG_PIX * GP;
  constexpr int BUF = XBYTES + 2 * GBYTES;  // x, g (then dz), the saved output
  constexpr int NC = NCH / 8;               // dz chunks of 8 channels per pixel
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int Ho = H / G::S, Wo = W / G::S;
  const int mtiles = G::NTAP * round16(cin) / 16;  // m16 tile m = (ci chunk, tap)
  const int ngroups = (cout + NCH - 1) / NCH;
  const int m0 = blockIdx.x / ngroups * G::MT;
  const int n0 = blockIdx.x % ngroups * NCH;  // the block's output channels n0 .. n0 + NCH
  const int cx0 = m0 / G::NTAP * 16;          // the first of the XC channels it stages
  const size_t row = (size_t)G::NTAP * cin * cout + cout;
  float* dst = part + (size_t)blockIdx.y * row;

  const int tbeg = blockIdx.y * tiles_per_part;
  const int ntile = min(total_tiles, tbeg + tiles_per_part) - tbeg;
  auto load = [&](int it) {
    const int tile = tbeg + it;
    unsigned char* buf = smem + (it & 1) * BUF;
    const int b = tile / (tiles_x * tiles_y);
    const int oy0 = (tile / tiles_x) % tiles_y * WG_TH, ox0 = tile % tiles_x * TW;
    stage_tile<G::XH, G::XW, KS == 4>(x, buf, XP, b, G::S * oy0 - 1, G::S * ox0 - 1, H, W, cin,
                                      cx0, G::XC, tid);
    const uint32_t gs = smem_u32(buf + XBYTES);
    for (int i = tid; i < WG_PIX * NC; i += NT) {
      const int p = i / NC, c8 = i % NC, oy = oy0 + p / TW, ox = ox0 + p % TW;
      const int co = n0 + c8 * 8;
      const bool ok = oy < Ho && ox < Wo && co < cout;
      const size_t idx = ok ? (((size_t)b * Ho + oy) * Wo + ox) * cout + co : 0;
      cp_async16(gs + p * GP + c8 * 16, g + idx, ok);
      if (act != kNone) cp_async16(gs + GBYTES + p * GP + c8 * 16, outp + idx, ok);
    }
  };

  float acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  float db[8];  // channels n0 + (tid % NC) * 8 .. + 8: the chunk this thread always forms
#pragma unroll
  for (int k = 0; k < 8; ++k) db[k] = 0.f;

  if (ntile > 0) load(0);
  esr::mma::cp_async_commit();
  for (int it = 0; it < ntile; ++it) {
    if (it + 1 < ntile) load(it + 1);
    esr::mma::cp_async_commit();
    esr::mma::cp_async_wait<1>();
    __syncthreads();
    unsigned char* buf = smem + (it & 1) * BUF;
    unsigned char* gz = buf + XBYTES;
    for (int i = tid; i < WG_PIX * NC; i += NT) {  // dz in place of g, rounded once
      const int p = i / NC, c8 = i % NC;
      uint4* gp = reinterpret_cast<uint4*>(gz + p * GP + c8 * 16);
      const uint4 gv = *gp;
      const uint4 ov =
          act == kNone ? gv : *reinterpret_cast<const uint4*>(gz + GBYTES + p * GP + c8 * 16);
      float d[8];
      dz8(gv, ov, act, slope, d);
#pragma unroll
      for (int k = 0; k < 8; ++k) db[k] += d[k];
      *gp = pack8(d);
    }
    __syncthreads();
    const uint32_t xs = smem_u32(buf), zs = smem_u32(gz);
#pragma unroll (KS == 3 ? WG_TH : 2)
    for (int kk = 0; kk < WG_TH; ++kk) {  // one tile row of 16 pixels per k16 step
      uint32_t bf[NT8][2];
      if constexpr (NT8 == 1) {
        esr::mma::ldsm_x2_t(bf[0], zs + (kk * 16 + (lane & 15)) * GP + wn * 16);
      } else {
#pragma unroll
        for (int j = 0; j < NT8; j += 2) {
          uint32_t r[4];
          esr::mma::ldsm_x4_t(r, zs + (kk * 16 + (lane & 15)) * GP +
                                     (wn * NT8 * 8 + j * 8 + (lane >> 4) * 8) * 2);
          bf[j][0] = r[0], bf[j][1] = r[1], bf[j + 1][0] = r[2], bf[j + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = m0 + wm * MT + i;
        if (m >= mtiles) continue;  // warp-uniform
        const int t = m % G::NTAP, cl = m / G::NTAP * 16 - cx0;
        // A = x^T: [k = pixel][m = ci] rows read with .trans; output pixel
        // (kk, px) at tap t reads input tile pixel (S*kk + ky, S*px + kx): at
        // KS = 4 row kk + ky/2, column px + kx/2 of plane (ky & 1, kx & 1)
        const int px = (lane & 7) + (lane >> 4) * 8;
        int r;
        if constexpr (KS == 3)
          r = (kk + t / 3) * HW + px + t % 3;
        else
          r = ((t >> 2 & 1) * 2 + (t & 1)) * G::PP + (kk + (t >> 3)) * G::PW + px + (t >> 1 & 1);
        uint32_t af[4];
        esr::mma::ldsm_x4_t(af, xs + r * XP + (cl + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
        for (int j = 0; j < NT8; ++j) esr::mma::mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
    __syncthreads();
  }
  esr::mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = m0 + wm * MT + i;
    if (m >= mtiles) continue;
    const int t = m % G::NTAP;
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      const int n = n0 + (wn * NT8 + j) * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = m / G::NTAP * 16 + (lane >> 2) + 8 * h;
        if (ci < cin && n < cout)
          *reinterpret_cast<float2*>(dst + ((size_t)t * cin + ci) * cout + n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
  if (m0 == 0) {  // db: the threads' partials in a fixed order
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int k = 0; k < 8; ++k) red[tid * 8 + k] = db[k];
    __syncthreads();
    for (int c = tid; c < NCH; c += NT) {
      float v = 0.f;
      for (int r = c / 8; r < NT; r += NC) v += red[r * 8 + c % 8];
      if (n0 + c < cout) dst[(size_t)G::NTAP * cin * cout + n0 + c] = v;
    }
  }
}

}  // namespace mk

struct StageArgs {
  const void *x, *w, *g, *outp;
  const float* bias;
  void* out;       // forward: the output; dgrad: dx
  float *part, *dwdb;
  int B, H, W, Ho, Wo, cin, cout, act, npart;
  float slope;
};

template <typename T, int CO, int KS>
int launch_fwd(const StageArgs& a, cudaStream_t st) {
  const int nchunk = a.cout / CO;
  const dim3 grid((a.Wo + TW - 1) / TW, (a.Ho + TH - 1) / TH, a.B * nchunk);
  stage_fwd_kernel<T, CO, KS><<<grid, NT, 0, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w), a.bias, static_cast<T*>(a.out),
      a.H, a.W, a.Ho, a.Wo, a.cin, a.cout, nchunk, a.act, a.slope);
  return (int)cudaGetLastError();
}

template <typename T, int CO, int KS>
int launch_dgrad(const StageArgs& a, cudaStream_t st) {
  const int nchunk = (a.cin + CO - 1) / CO;
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, a.B * nchunk);
  stage_dgrad_kernel<T, CO, KS><<<grid, NT, 0, st>>>(
      static_cast<const T*>(a.g), static_cast<const T*>(a.outp), static_cast<const T*>(a.w),
      static_cast<T*>(a.out), a.H, a.W, a.Ho, a.Wo, a.cin, a.cout, nchunk, a.act, a.slope);
  return (int)cudaGetLastError();
}

// dW/db = the partial rows added in order.
void finish_wgrad(const StageArgs& a, int ks, cudaStream_t st) {
  const size_t row = (size_t)ks * ks * a.cin * a.cout + a.cout;
  stage_wgrad_finish_kernel<<<(unsigned)((row + 255) / 256), 256, 0, st>>>(a.part, a.npart, row,
                                                                          a.dwdb);
}

template <typename T, int SC, int KS>
int launch_wgrad(const StageArgs& a, cudaStream_t st) {
  constexpr int KC = NT / (SC >= 16 ? 16 : SC);
  constexpr int WTH = KS == 3 ? 8 : 4, WTW = 16;
  const int tiles_x = (a.Wo + WTW - 1) / WTW, tiles_y = (a.Ho + WTH - 1) / WTH;
  const int total = a.B * tiles_x * tiles_y;
  const int per = (total + a.npart - 1) / a.npart;
  const int nco_chunks = (a.cout + SC - 1) / SC;
  const dim3 grid(((a.cin + KC - 1) / KC) * nco_chunks, a.npart);
  stage_wgrad_kernel<T, SC, KS><<<grid, NT, 0, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), static_cast<const T*>(a.outp),
      a.part, a.H, a.W, a.Ho, a.Wo, a.cin, a.cout, nco_chunks, a.act, a.slope, per, total,
      tiles_x, tiles_y);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finish_wgrad(a, KS, st);
  return (int)cudaGetLastError();
}

enum Op : int { kFwd = 0, kDgrad = 1, kWgrad = 2 };

template <typename T, int C, int KS>
int dispatch_op(int op, const StageArgs& a, cudaStream_t st) {
  if (op == kFwd) return launch_fwd<T, C, KS>(a, st);
  if (op == kDgrad) return launch_dgrad<T, C, KS>(a, st);
  return launch_wgrad<T, C, KS>(a, st);
}

// `chunk`: output channels per block (forward, wgrad) or dx channels (dgrad).
template <typename T, int KS>
int dispatch_chunk(int op, int chunk, const StageArgs& a, cudaStream_t st) {
  switch (chunk) {
    case 8: return dispatch_op<T, 8, KS>(op, a, st);
    case 16: return dispatch_op<T, 16, KS>(op, a, st);
    case 32: return dispatch_op<T, 32, KS>(op, a, st);
    case 64: return dispatch_op<T, 64, KS>(op, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- the bf16 tensor-core design: launches -------------------------------------

template <int NP, int NW>
int launch_fwd_mma(const StageArgs& a, cudaStream_t st) {
  const int cinp = mk::round16(a.cin);
  const size_t smem = std::max<size_t>(
      (size_t)mk::HP * mk::ldsm_pitch(cinp) +
          (size_t)mk::NSLOT * std::min(mk::KCH, cinp) * mk::ldsm_pitch(NP),
      (size_t)mk::PIX * mk::ldsm_pitch(NP));
  if (int e = esr::tile::smem_opt_in(mk::stage_fwd_mma_kernel<NP, NW>, smem)) return e;
  const dim3 grid((a.W + mk::TW - 1) / mk::TW, (a.H + mk::TH - 1) / mk::TH, a.B);
  mk::stage_fwd_mma_kernel<NP, NW><<<grid, NW * 32, smem, st>>>(
      static_cast<const mk::bf16*>(a.x), static_cast<const mk::bf16*>(a.w), a.bias,
      static_cast<mk::bf16*>(a.out), a.H, a.W, a.cin, a.act, a.slope);
  return (int)cudaGetLastError();
}

template <int NP, int NW>
int launch_dgrad_mma(const StageArgs& a, cudaStream_t st) {
  const int coutp = mk::round16(a.cout);
  const size_t smem = std::max<size_t>(
      (size_t)mk::HP * mk::ldsm_pitch(coutp) +
          (size_t)mk::NSLOT * NP * mk::ldsm_pitch(std::min(mk::KCH, coutp)),
      (size_t)mk::PIX * mk::ldsm_pitch(NP));
  if (int e = esr::tile::smem_opt_in(mk::stage_dgrad_mma_kernel<NP, NW>, smem)) return e;
  const dim3 grid((a.W + mk::TW - 1) / mk::TW, (a.H + mk::TH - 1) / mk::TH, a.B);
  mk::stage_dgrad_mma_kernel<NP, NW><<<grid, NW * 32, smem, st>>>(
      static_cast<const mk::bf16*>(a.g), static_cast<const mk::bf16*>(a.outp),
      static_cast<const mk::bf16*>(a.w), static_cast<mk::bf16*>(a.out), a.H, a.W, a.cin,
      a.cout, a.act, a.slope);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_fwd_s2_mma(const StageArgs& a, cudaStream_t st) {
  const int xc = std::min(mk::s2_xc(NP), mk::round16(a.cin));
  const size_t smem = std::max<size_t>(
      (size_t)4 * mk::S2_PP * mk::ldsm_pitch(xc) +
          (size_t)mk::NSLOT * xc * mk::ldsm_pitch(NP),
      (size_t)mk::PIX * mk::ldsm_pitch(NP));
  if (int e = esr::tile::smem_opt_in(mk::stage_fwd_s2_mma_kernel<NP>, smem)) return e;
  const dim3 grid((a.Wo + mk::TW - 1) / mk::TW, (a.Ho + mk::TH - 1) / mk::TH, a.B);
  mk::stage_fwd_s2_mma_kernel<NP><<<grid, mk::S2_NW * 32, smem, st>>>(
      static_cast<const mk::bf16*>(a.x), static_cast<const mk::bf16*>(a.w), a.bias,
      static_cast<mk::bf16*>(a.out), a.H, a.W, a.Ho, a.Wo, a.cin, a.act, a.slope);
  return (int)cudaGetLastError();
}

template <int NP, int NW>
int launch_dgrad_s2_mma(const StageArgs& a, cudaStream_t st) {
  const size_t smem = esr::fold::fold_smem(NP, mk::round16(a.cout), false);
  if (int e = esr::tile::smem_opt_in(mk::stage_dgrad_s2_mma_kernel<NP, NW>, smem)) return e;
  const dim3 grid((a.Wo + mk::TW - 1) / mk::TW, (a.Ho + mk::TH - 1) / mk::TH, a.B);
  mk::stage_dgrad_s2_mma_kernel<NP, NW><<<grid, NW * 32, smem, st>>>(
      static_cast<const mk::bf16*>(a.g), static_cast<const mk::bf16*>(a.outp),
      static_cast<const mk::bf16*>(a.w), static_cast<mk::bf16*>(a.out), a.Ho, a.Wo, a.cin,
      a.cout, a.act, a.slope);
  return (int)cudaGetLastError();
}

template <int NCH, int KS>
int launch_wgrad_mma(const StageArgs& a, cudaStream_t st) {
  using G = mk::Wg<KS>;
  const size_t smem = 2 * ((size_t)G::XH * G::XW * mk::ldsm_pitch(G::XC) +
                           2 * (size_t)mk::WG_PIX * mk::ldsm_pitch(NCH));
  if (int e = esr::tile::smem_opt_in(mk::stage_wgrad_mma_kernel<NCH, KS>, smem)) return e;
  const int tiles_x = (a.Wo + mk::TW - 1) / mk::TW, tiles_y = (a.Ho + mk::WG_TH - 1) / mk::WG_TH;
  const int total = a.B * tiles_x * tiles_y;
  const int per = (total + a.npart - 1) / a.npart;
  const int mtiles = G::NTAP * mk::round16(a.cin) / 16;
  const int ngroups = (a.cout + NCH - 1) / NCH;
  const dim3 grid((mtiles + G::MT - 1) / G::MT * ngroups, a.npart);
  mk::stage_wgrad_mma_kernel<NCH, KS><<<grid, mk::NT, smem, st>>>(
      static_cast<const mk::bf16*>(a.x), static_cast<const mk::bf16*>(a.g),
      static_cast<const mk::bf16*>(a.outp), a.part, a.H, a.W, a.cin, a.cout, a.act, a.slope, per,
      total, tiles_x, tiles_y);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finish_wgrad(a, KS, st);
  return (int)cudaGetLastError();
}

// by width `np`: a power of two from 8 to 128
// Warps of a forward / data-gradient block: 8 (32-pixel warp tiles) when
// either width is above 64, as the block's shared memory then lets only two
// blocks share an SM; else 4 (64-pixel warp tiles, fewer ldmatrix per mma,
// three or more blocks an SM). Measured both ways on the H100 (PERF.md).
#define ESR_NW(LAUNCH, NP)                            \
  (a.cin > 64 || a.cout > 64 ? LAUNCH<NP, 8>(a, st) \
                             : LAUNCH<NP, (NP > 64 ? 8 : 4)>(a, st))
#define ESR_BY_WIDTH(LAUNCH)                                        \
  int LAUNCH##_w(int np, const StageArgs& a, cudaStream_t st) {     \
    switch (np) {                                                   \
      case 8: return ESR_NW(LAUNCH, 8);                             \
      case 16: return ESR_NW(LAUNCH, 16);                           \
      case 32: return ESR_NW(LAUNCH, 32);                           \
      case 64: return ESR_NW(LAUNCH, 64);                           \
      case 128: return ESR_NW(LAUNCH, 128);                         \
      default: return (int)cudaErrorInvalidValue;                   \
    }                                                               \
  }

int pow2_width(int c, int least) {
  int n = least;
  while (n < c) n *= 2;
  return n;
}

// the weight gradient's N per block: cout (at least 16), at most 64
template <int KS>
int launch_wgrad_mma_w(int cout, const StageArgs& a, cudaStream_t st) {
  switch (cout) {
    case 8:
    case 16: return launch_wgrad_mma<16, KS>(a, st);
    case 32: return launch_wgrad_mma<32, KS>(a, st);
    case 64:
    case 128: return launch_wgrad_mma<64, KS>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
ESR_BY_WIDTH(launch_fwd_mma)
ESR_BY_WIDTH(launch_dgrad_mma)
ESR_BY_WIDTH(launch_dgrad_s2_mma)
#undef ESR_BY_WIDTH

int launch_fwd_s2_mma_w(int np, const StageArgs& a, cudaStream_t st) {
  switch (np) {
    case 8: return launch_fwd_s2_mma<8>(a, st);
    case 16: return launch_fwd_s2_mma<16>(a, st);
    case 32: return launch_fwd_s2_mma<32>(a, st);
    case 64: return launch_fwd_s2_mma<64>(a, st);
    case 128: return launch_fwd_s2_mma<128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

enum Design : int { kFma = 0, kMma = 1 };  // kernels/launch.py DESIGNS, design()

int dispatch_mma(int ks, int op, const StageArgs& a, cudaStream_t st) {
  if (a.cin < 1 || a.cin > 128) return (int)cudaErrorInvalidValue;
  const int np = pow2_width(a.cin, 8);  // the data gradient's N
  if (ks == 4) {
    if (op == kFwd) return launch_fwd_s2_mma_w(a.cout, a, st);
    if (op == kDgrad) return launch_dgrad_s2_mma_w(np, a, st);
    return launch_wgrad_mma_w<4>(a.cout, a, st);
  }
  if (op == kFwd) return launch_fwd_mma_w(a.cout, a, st);
  if (op == kDgrad) return launch_dgrad_mma_w(np, a, st);
  return launch_wgrad_mma_w<3>(a.cout, a, st);
}

int dispatch(int dtype, int ks, int design, int op, int chunk, const StageArgs& a,
             cudaStream_t st) {
  if (ks != 3 && ks != 4) return (int)cudaErrorInvalidValue;
  // one design per dtype: bf16 on the tensor cores, fp32 on the FMA kernels
  if (dtype == esr::kBFloat16 && design == kMma) return dispatch_mma(ks, op, a, st);
  if (dtype == esr::kFloat32 && design == kFma)
    return ks == 3 ? dispatch_chunk<float, 3>(op, chunk, a, st)
                   : dispatch_chunk<float, 4>(op, chunk, a, st);
  return (int)cudaErrorInvalidValue;
}

StageArgs geometry(int ks, int B, int H, int W, int cin, int cout, int act, float slope) {
  StageArgs a{};
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.cout = cout, a.act = act, a.slope = slope;
  a.Ho = ks == 3 ? H : H / 2;
  a.Wo = ks == 3 ? W : W / 2;
  return a;
}

}  // namespace

extern "C" {

// ks = 3: SAME 3x3 stride 1; ks = 4: 4x4 stride 2 pad 1 (H and W even).
// x [B,H,W,cin], w [ks,ks,cin,cout], bias fp32 [cout] -> out [B,Ho,Wo,cout].
// `design`: 1 (the tensor-core kernels) for bf16, 0 (the FMA kernels) for
// fp32; any other value returns cudaErrorInvalidValue. `chunk` (FMA only)
// divides cout. Every function returns cudaGetLastError().
int esr_stage_fwd(int dtype, int ks, int design, int chunk, const void* x, const void* w,
                  const float* bias, void* out, int B, int H, int W, int cin, int cout, int act,
                  float slope, void* stream) {
  if (design == kFma && cout % chunk) return (int)cudaErrorInvalidValue;
  StageArgs a = geometry(ks, B, H, W, cin, cout, act, slope);
  a.x = x, a.w = w, a.bias = bias, a.out = out;
  return dispatch(dtype, ks, design, kFwd, chunk, a, static_cast<cudaStream_t>(stream));
}

// dx [B,H,W,cin] from the cotangent g and the saved output outp (both
// [B,Ho,Wo,cout]; outp may be null when act is none). `chunk` (FMA only): dx
// channels per block.
int esr_stage_dgrad(int dtype, int ks, int design, int chunk, const void* g, const void* outp,
                    const void* w, void* dx, int B, int H, int W, int cin, int cout, int act,
                    float slope, void* stream) {
  if (act != kNone && !outp) return (int)cudaErrorInvalidValue;
  StageArgs a = geometry(ks, B, H, W, cin, cout, act, slope);
  a.g = g, a.outp = outp, a.w = w, a.out = dx;
  return dispatch(dtype, ks, design, kDgrad, chunk, a, static_cast<cudaStream_t>(stream));
}

// dwdb[0 : ks*ks*cin*cout] = dW (HWIO), dwdb[ks*ks*cin*cout :] = db, both
// fp32. `part` is an fp32 workspace of npart * (ks*ks*cin*cout + cout) floats;
// part p sums the pixel tiles [p * per, (p + 1) * per), per = ceil(tiles / npart)
// (kernels/stage_ct.py stage_wgrad_ranges).
int esr_stage_wgrad(int dtype, int ks, int design, int chunk, const void* x, const void* g,
                    const void* outp, float* part, int npart, float* dwdb, int B, int H, int W,
                    int cin, int cout, int act, float slope, void* stream) {
  if (npart < 1 || (act != kNone && !outp)) return (int)cudaErrorInvalidValue;
  StageArgs a = geometry(ks, B, H, W, cin, cout, act, slope);
  a.x = x, a.g = g, a.outp = outp, a.part = part, a.npart = npart, a.dwdb = dwdb;
  return dispatch(dtype, ks, design, kWgrad, chunk, a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
