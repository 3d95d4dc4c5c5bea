// The workbench's 3x3 stride-1 SAME convolution as an implicit GEMM (NHWC x
// HWIO, sm_90a).
//
// Replaces esrganplus_tpu/kernels/workbench/conv.py (conv3x3, the Pallas
// kernel _conv3x3_kernel, :32-66): out = act(sum over the nine taps of
// x(y+dy-1, x+dx-1) . w[dy][dx] + b), fp32 accumulation, the bias (already
// rounded to the activation dtype by the wrapper, as the TPU kernel casts it)
// added in fp32, the optional (leaky) ReLU on the fp32 value, one rounding to
// T. Zero SAME padding is the haloed tile's zero fill; the TPU's channel pad
// to 128 and its column over-fetch were DMA constraints and are not kept.
//
// Bound on this card: operations for the model's widths. A 64->224 conv is
// 129,024 MAC per pixel against 576 bytes of bf16 traffic per pixel, far
// above the H100's ~295 FLOP/byte ridge. Two designs, picked by the wrapper
// (kernels/workbench/conv.py conv_design) by dtype; the C entry refuses any
// other:
//   * "mma" (bf16): wb_conv3x3_mma_kernel on the tensor cores (mma.sync
//     m16n8k16 bf16 -> fp32, csrc/mma_tile.cuh), the stage forward's design
//     (csrc/stage_ct.cu stage_fwd_mma_kernel) widened to any Cin and Cout:
//     a block owns an 8x16 pixel tile and one chunk of NP output channels
//     (Cout above 128 runs as chunks over blockIdx.z, the last one ragged:
//     zero weight columns, no store past Cout); the haloed 10x18 [pixel][cin]
//     tile is staged once (XC channels at a time: one chunk up to Cin 192) and
//     each tap is a shifted ldmatrix row of it; the weights stream through a
//     3-slot cp.async ring, one (chunk, tap) a slot; the epilogue adds the
//     bias, applies the activation as lrelu(v, slope) (so a ReLU keeps the
//     twin's sign of zero), rounds once into shared memory and stores the
//     real channels.
//     Cin and Cout that are not multiples of 8 are staged with plain loads
//     and padded with zeros in shared memory only. A kernel of its own on
//     csrc/mma_tile.cuh rather than stage_fwd_mma_kernel itself: the input
//     chunking, the output chunks with their stride and ragged columns, and
//     the epilogue's sign of zero would each be a branch in a kernel that
//     four GAN kernels share, whose ptxas lines and kernels-stage rows then
//     stay as they are by construction.
//   * "fma" (fp32, whose 1e-4 bar TF32 would miss): wb_conv3x3_kernel, the
//     CUDA cores in fp32: each 256-thread block owns an 8x16 pixel tile and
//     one chunk of CO output channels; it stages a KC-channel slice of the
//     haloed input tile once in shared memory (reused by all nine taps) with
//     the matching 9 x KC x CO weights, and every thread keeps a 4-pixel x
//     CO/8-channel register tile, so each shared-memory load feeds several
//     FMAs. Any Cin and any Cout: the channel slice and the last Cout chunk
//     are predicated (zero weights, no store past Cout).
#include "common.cuh"
#include "mma_tile.cuh"

#include <algorithm>

namespace esr {
namespace wbconv {

constexpr int TH = 8;               // tile rows
constexpr int TW = 16;              // tile columns
constexpr int NT = 256;             // threads per block
constexpr int NCG = 8;              // channel groups per block
constexpr int NPG = NT / NCG;       // pixel groups (32)
constexpr int PPT = TH * TW / NPG;  // pixels per thread (4)

template <typename T, int CO>
__global__ void __launch_bounds__(NT) wb_conv3x3_kernel(
    const T* __restrict__ x,        // [B, H, W, cin]
    const T* __restrict__ w,        // [3, 3, cin, cout]
    const float* __restrict__ bias, // [cout]
    T* __restrict__ out,            // [B, H, W, cout]
    int H, int W, int cin, int cout, int nchunk, int act, float slope) {
  constexpr int KC = CO >= 64 ? 8 : 16;  // input channels staged per step
  constexpr int CPT = CO / NCG;          // output channels per thread
  __shared__ float xs[KC][TH + 2][TW + 2];
  __shared__ float ws[9][KC][CO];

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int b = blockIdx.z / nchunk;
  const int co0 = (blockIdx.z % nchunk) * CO;
  const size_t img = (size_t)b * H * W;

  float acc[PPT][CPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += KC) {
    for (int i = tid; i < KC * (TH + 2) * (TW + 2); i += NT) {
      const int kk = i % KC;
      const int p = i / KC;
      const int ty = p / (TW + 2), tx = p % (TW + 2);
      const int gy = y0 + ty - 1, gx = x0 + tx - 1, c = k0 + kk;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin)
        v = to_f(x[(img + (size_t)gy * W + gx) * cin + c]);
      xs[kk][ty][tx] = v;
    }
    for (int i = tid; i < 9 * KC * CO; i += NT) {
      const int co = i % CO;
      const int kk = (i / CO) % KC;
      const int t = i / (CO * KC);
      const int c = k0 + kk;
      ws[t][kk][co] =
          (c < cin && co0 + co < cout) ? to_f(w[((size_t)t * cin + c) * cout + co0 + co]) : 0.f;
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
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = pg + NPG * i;
    const int gy = y0 + p / TW, gx = x0 + p % TW;
    if (gy >= H || gx >= W) continue;
    const size_t pix = img + (size_t)gy * W + gx;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = co0 + cg * CPT + j;
      if (c >= cout) continue;
      float v = __fadd_rn(acc[i][j], bias[c]);
      if (act) v = lrelu(v, slope);
      out[pix * cout + c] = from_f<T>(v);
    }
  }
}

template <typename T, int CO>
int launch(const void* x, const void* w, const float* bias, void* out, int B, int H, int W,
           int cin, int cout, int act, float slope, cudaStream_t stream) {
  const int nchunk = (cout + CO - 1) / CO;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * nchunk);
  wb_conv3x3_kernel<T, CO><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<T*>(out), H, W,
      cin, cout, nchunk, act, slope);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const float* bias, void* out, int B, int H, int W,
             int cin, int cout, int act, float slope, cudaStream_t s) {
  // the narrowest chunk that holds Cout, or chunks of 64 with a ragged last one
  if (cout <= 8) return launch<T, 8>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
  if (cout <= 16) return launch<T, 16>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
  if (cout <= 32) return launch<T, 32>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
  return launch<T, 64>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
}


// ---------------------------------------------------------------------------
// the bf16 tensor-core design
// ---------------------------------------------------------------------------

namespace wbmma {

using esr::mma::cp_async16;
using esr::mma::ldsm_pitch;
using esr::mma::smem_u32;
using esr::tile::bf16;
using esr::tile::HP;   // the 8x16 pixel tile and its 1-pixel halo (csrc/mma_tile.cuh)
using esr::tile::HW;
using esr::tile::PIX;
using esr::tile::round16;
using esr::tile::stage_tile;
using esr::tile::TH;
using esr::tile::Tiling;
using esr::tile::TW;
using esr::tile::warp_mma;

constexpr int NSLOT = 3;   // weight-ring depth
constexpr int XC = 192;    // input channels a block stages at a time (a slot's K rows)
constexpr int MAX_NP = 128;  // output channels of one chunk at most

// The chunk width NP for Cout (kernels/workbench/conv.py conv_chunk_width):
// the narrowest power of two from 8 that holds Cout up to 128; above, 64 or
// 128, whichever pads less (128 on a tie: fewer chunks stage the input tile
// fewer times).
__host__ __device__ constexpr int chunk_np(int cout) {
  if (cout <= MAX_NP) {
    int n = 8;
    while (n < cout) n *= 2;
    return n;
  }
  return (cout + 127) / 128 * 128 <= (cout + 63) / 64 * 64 ? 128 : 64;
}

template <int NP, int NW>
__global__ void __launch_bounds__(Tiling<NP, NW>::NTH, Tiling<NP, NW>::MIN_BLOCKS)
    wb_conv3x3_mma_kernel(
    const bf16* __restrict__ x,      // [B, H, W, cin]
    const bf16* __restrict__ w,      // [3, 3, cin, cout]
    const float* __restrict__ bias,  // [cout]
    bf16* __restrict__ out,          // [B, H, W, cout]
    int H, int W, int cin, int cout, int nchunk, int act, float slope) {
  using Tl = Tiling<NP, NW>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int cinp = round16(cin);
  const int xc = min(XC, cinp);  // channels of a staged chunk, and K rows of a ring slot
  const int xp = ldsm_pitch(xc);
  constexpr int WP = ldsm_pitch(NP);
  const int slot = xc * WP;
  const uint32_t xs = smem_u32(smem), ws = xs + HP * xp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Tl::WN, wn = warp % Tl::WN;
  const int b = blockIdx.z / nchunk, n0 = (blockIdx.z % nchunk) * NP;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int nkc = (cinp + XC - 1) / XC;  // input-channel chunks
  const int nstage = 9 * nkc;            // stages: (chunk, tap)

  auto load_x = [&](int kc) {
    stage_tile<TH + 2, HW>(x, smem, xp, b, y0 - 1, x0 - 1, H, W, cin, kc * XC, xc, tid);
  };
  // stage s = (chunk, tap) into ring slot s % NSLOT: the chunk's K rows
  // (zero past Cin) x the block's NP columns (zero past Cout). A whole tap a
  // slot: at 192 channels, 64-row slices (27 stages, each too short to hide
  // the next one's loads) took 1.7x as long on the H100.
  auto load_w = [&](int s) {
    const int t = s % 9, c0 = (s / 9) * XC;
    const int len = min(xc, cinp - c0);
    const uint32_t dst = ws + (s % NSLOT) * slot;
    constexpr int NC = NP / 8;
    if ((cout & 7) == 0) {
      for (int i = tid; i < len * NC; i += Tl::NTH) {
        const int r = i / NC, n8 = i % NC, ci = c0 + r, co = n0 + n8 * 8;
        const bool ok = ci < cin && co < cout;
        cp_async16(dst + r * WP + n8 * 16, ok ? w + ((size_t)t * cin + ci) * cout + co : w, ok);
      }
    } else {  // rows not 16-byte aligned: loads of the real columns, 16-byte stores
      for (int i = tid; i < len * NC; i += Tl::NTH) {
        const int r = i / NC, n8 = i % NC, ci = c0 + r;
        const bf16* row = w + ((size_t)t * cin + ci) * cout;
        __align__(16) bf16 v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int co = n0 + n8 * 8 + k;
          v[k] = ci < cin && co < cout ? row[co] : __float2bfloat16_rn(0.f);
        }
        *reinterpret_cast<uint4*>(smem + (dst - xs) + r * WP + n8 * 16) =
            *reinterpret_cast<const uint4*>(v);
      }
    }
  };
  load_x(0);
  esr::mma::cp_async_commit();
  load_w(0);
  esr::mma::cp_async_commit();
  load_w(1);  // nstage >= 9
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
    if (s > 0 && s % 9 == 0) {  // the next input-channel chunk replaces this one
      __syncthreads();          // every warp is done with it
      load_x(s / 9);
      esr::mma::cp_async_commit();
      esr::mma::cp_async_wait<0>();
    }
    esr::mma::cp_async_wait<1>();  // the input chunk and stage s have landed
    __syncthreads();               // ... for every thread, and slot (s+2) % 3 is free
    if (s + 2 < nstage) load_w(s + 2);
    esr::mma::cp_async_commit();
    const int t = s % 9, len = min(xc, cinp - (s / 9) * XC);
    const int shift = (t / 3) * HW + t % 3;
    uint32_t a[Tl::MT];
#pragma unroll
    for (int i = 0; i < Tl::MT; ++i) a[i] = arow[i] + shift * xp;
    warp_mma<Tl::MT, Tl::NT8, true>(acc, a, ws + (s % NSLOT) * slot, WP, wn * Tl::NT8 * 8, len,
                                    lane);
  }
  esr::mma::cp_async_wait<0>();
  __syncthreads();

  // fp32 + bias (zero past Cout), the activation, one rounding, into shared rows
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT8; ++j) {
      const int m = (wm * Tl::MT + i) * 16 + (lane >> 2);
      const int n = (wn * Tl::NT8 + j) * 8 + (lane & 3) * 2;
      const float b0 = n0 + n < cout ? bias[n0 + n] : 0.f;
      const float b1 = n0 + n + 1 < cout ? bias[n0 + n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = __fadd_rn(acc[i][j][2 * h], b0), v1 = __fadd_rn(acc[i][j][2 * h + 1], b1);
        if (act) v0 = lrelu(v0, slope), v1 = lrelu(v1, slope);
        *reinterpret_cast<uint32_t*>(smem + (m + 8 * h) * WP + n * 2) =
            esr::mma::pack_bf16(v0, v1);
      }
    }
  __syncthreads();
  // the chunk's real channels of the pixels inside the image
  const int nc = min(NP, cout - n0);
  if ((cout & 7) == 0) {
    const int n8 = nc / 8;
    for (int i = tid; i < PIX * n8; i += Tl::NTH) {
      const int m = i / n8, c8 = i % n8, y = y0 + m / TW, xx = x0 + m % TW;
      if (y < H && xx < W)
        *reinterpret_cast<uint4*>(out + (((size_t)b * H + y) * W + xx) * cout + n0 + c8 * 8) =
            *reinterpret_cast<const uint4*>(smem + m * WP + c8 * 16);
    }
  } else {
    for (int i = tid; i < PIX * nc; i += Tl::NTH) {
      const int m = i / nc, k = i % nc, y = y0 + m / TW, xx = x0 + m % TW;
      if (y < H && xx < W)
        out[(((size_t)b * H + y) * W + xx) * cout + n0 + k] =
            reinterpret_cast<const bf16*>(smem + m * WP)[k];
    }
  }
}

template <int NP, int NW>
int launch(const void* x, const void* w, const float* bias, void* out, int B, int H, int W,
           int cin, int cout, int act, float slope, cudaStream_t stream) {
  const int xc = std::min(XC, round16(cin));
  const size_t smem =
      std::max<size_t>((size_t)HP * ldsm_pitch(xc) + (size_t)NSLOT * xc * ldsm_pitch(NP),
                       (size_t)PIX * ldsm_pitch(NP));
  auto kern = wb_conv3x3_mma_kernel<NP, NW>;
  if (int e = esr::tile::smem_opt_in(kern, smem)) return e;
  const int nchunk = (cout + NP - 1) / NP;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * nchunk);
  kern<<<grid, NW * 32, smem, stream>>>(static_cast<const bf16*>(x),
                                        static_cast<const bf16*>(w), bias,
                                        static_cast<bf16*>(out), H, W, cin, cout, nchunk, act,
                                        slope);
  return (int)cudaGetLastError();
}

// Warps of a block: 8 (32-pixel warp tiles) when Cin or the chunk is above 64
// (the block's shared memory then lets only two blocks share an SM), else 4;
// the stage forward's rule (csrc/stage_ct.cu ESR_NW).
template <int NP>
int launch_nw(const void* x, const void* w, const float* bias, void* out, int B, int H, int W,
              int cin, int cout, int act, float slope, cudaStream_t s) {
  if constexpr (NP > 64) {
    return launch<NP, 8>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
  } else {
    if (cin > 64) return launch<NP, 8>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
    return launch<NP, 4>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
  }
}

int dispatch(const void* x, const void* w, const float* bias, void* out, int B, int H, int W,
             int cin, int cout, int act, float slope, cudaStream_t s) {
  switch (chunk_np(cout)) {
    case 8: return launch_nw<8>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
    case 16: return launch_nw<16>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
    case 32: return launch_nw<32>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
    case 64: return launch_nw<64>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
    case 128: return launch_nw<128>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wbmma

enum Design : int { kFma = 0, kMma = 1 };  // kernels/workbench/conv.py conv_design

}  // namespace wbconv
}  // namespace esr

extern "C" {

// out = act(conv3x3(x, w) + bias) in one launch; `act` 0 linear, 1 leaky
// ReLU with `slope` (0 is ReLU). `design`: 1 (the tensor-core kernel) for
// bf16, 0 (the FMA kernel) for fp32; any other value returns
// cudaErrorInvalidValue. Returns cudaGetLastError().
int esr_wb_conv3x3(int design, int dtype, const void* x, const void* w, const float* bias,
                   void* out, int B, int H, int W, int cin, int cout, int act, float slope,
                   void* stream) {
  using namespace esr::wbconv;
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  if (design != (dtype == esr::kBFloat16 ? kMma : kFma)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == esr::kFloat32)
    return dispatch<float>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
  if (dtype == esr::kBFloat16)
    return wbmma::dispatch(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
