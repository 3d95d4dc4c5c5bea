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
//          as rdb_ct.py:258-266.
// The two orders differ by a T rounding per element, so they stay apart.
//
// Bound on this card: operations. One RDB is 241,664 MAC per pixel against
// ~1.4 KB of activation traffic per pixel (x read, 4*gc buffer written and
// re-read, nf written), far above the H100's ~295 FLOP/byte ridge. This first
// version accumulates on the CUDA cores in fp32 (no tensor cores yet), so it
// sits under the fp32 CUDA-core roof (67 TFLOP/s), not the bf16 tensor-core
// roof; moving the inner product to mma/wgmma is later work. What the design
// does about the bound: each 256-thread block owns an 8x16 pixel tile and all
// COUT output channels, stages a KC-channel slice of the haloed input tile
// and of the 9 taps' weights in shared memory as fp32, and keeps a 4-pixel x
// COUT/8-channel register tile per thread, so every shared-memory load feeds
// several FMAs.
#pragma once

#include "common.cuh"
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

template <typename T, int COUT, int MODE, typename L>
__global__ void __launch_bounds__(NT) dense_conv3x3_kernel(
    const T* __restrict__ x, int c0,        // [B,H,W,c0]: input channels [0, c0)
    const T* __restrict__ cat, int ccat,    // [B,H,W,ccat]: input channels [c0, cin)
    int cin,
    const T* __restrict__ w, L wl,          // 9 taps x cin x COUT in layout L
    const float* __restrict__ bias,         // [COUT]
    const T* __restrict__ w11,              // kAct1x1: 1 tap x c0 x COUT in layout L
    T* __restrict__ out, int out_stride,    // pixel stride of the output
    const T* __restrict__ r1, int r1_stride,
    const T* __restrict__ r2, int r2_stride,
    T* __restrict__ lsave, int lsave_stride,   // kAct*: lrelu(conv + b) before the add
    const T* __restrict__ noise, float sigma,  // kResid: [B,H,W,COUT] pre-drawn normals
    int seeded, uint32_t seed0, uint32_t seed1,  // kResid: draw them here instead
    float alpha, float beta2, float slope, int H, int W) {
  constexpr int KC = COUT >= 64 ? 8 : 16;  // input channels staged per step
  constexpr int CPT = COUT / NCG;          // output channels per thread
  __shared__ float xs[KC][TH + 2][TW + 2];
  __shared__ float ws[9][KC][COUT];
  __shared__ float w11s[MODE == kAct1x1 ? KC : 1][COUT];

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

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = pg + NPG * i;
    const int gy = y0 + p / TW, gx = x0 + p % TW;
    if (gy >= H || gx >= W) continue;
    const size_t pix = img + (size_t)gy * W + gx;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cg * CPT + j;
      float v = acc[i][j] + bias[c];
      if (MODE == kResid) {
        v = r1 ? v * alpha + to_f(r1[pix * r1_stride + c]) : v * alpha;
        if (r2) v = v * beta2 + to_f(r2[pix * r2_stride + c]);
        if (noise) {  // every product and the sum rounded to T, as the T-typed XLA ops are
          const float o = round_to<T>(v);
          const float t = round_to<T>(round_to<T>(sigma) * o);
          v = o + round_to<T>(to_f(noise[pix * COUT + c]) * t);
        } else if (seeded) {  // fp32 product with the fp32 draw, rounded once below
          v = __fmul_rn(v, noise_factor(sigma, seed0, seed1, blockIdx.z, gy, gx, c));
        }
      } else {
        v = lrelu(v, slope);
        if (lsave) lsave[pix * lsave_stride + c] = from_f<T>(v);
        if (MODE == kAct1x1) v += acc11[MODE == kAct1x1 ? i : 0][j];
        if (MODE == kActAdd) v += to_f(r1[pix * r1_stride + c]);
      }
      out[pix * out_stride + c] = from_f<T>(v);
    }
  }
}

// One launch's arguments, as a C interface receives them.
struct DenseArgs {
  const void *x, *cat, *w, *bias, *w11, *r1, *r2, *noise;
  void *out, *lsave;
  int c0, ccat, cin, out_stride, r1_stride, r2_stride, lsave_stride, B, H, W;
  float sigma, alpha, beta2, slope;
  int seeded;
  uint32_t seed0, seed1;
};

template <typename T, int COUT, int MODE, typename L>
void launch(const DenseArgs& a, L wl, cudaStream_t stream) {
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, a.B);
  dense_conv3x3_kernel<T, COUT, MODE, L><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a.x), a.c0, static_cast<const T*>(a.cat), a.ccat, a.cin,
      static_cast<const T*>(a.w), wl, static_cast<const float*>(a.bias),
      static_cast<const T*>(a.w11), static_cast<T*>(a.out), a.out_stride,
      static_cast<const T*>(a.r1), a.r1_stride, static_cast<const T*>(a.r2), a.r2_stride,
      static_cast<T*>(a.lsave), a.lsave_stride, static_cast<const T*>(a.noise), a.sigma,
      a.seeded, a.seed0, a.seed1, a.alpha, a.beta2, a.slope, a.H, a.W);
}

template <typename T, int COUT, typename L>
int dispatch_mode(int mode, const DenseArgs& a, L wl, cudaStream_t s) {
  switch (mode) {
    case kAct: launch<T, COUT, kAct>(a, wl, s); break;
    case kAct1x1: launch<T, COUT, kAct1x1>(a, wl, s); break;
    case kActAdd: launch<T, COUT, kActAdd>(a, wl, s); break;
    case kResid: launch<T, COUT, kResid>(a, wl, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, typename L>
int dispatch_cout(int cout, int mode, const DenseArgs& a, L wl, cudaStream_t s) {
  switch (cout) {
    case 8: return dispatch_mode<T, 8>(mode, a, wl, s);
    case 16: return dispatch_mode<T, 16>(mode, a, wl, s);
    case 32: return dispatch_mode<T, 32>(mode, a, wl, s);
    case 64: return dispatch_mode<T, 64>(mode, a, wl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One dense-stage launch in weight layout L; returns cudaGetLastError().
template <typename L>
int dispatch(int dtype, int cout, int mode, const DenseArgs& a, L wl, cudaStream_t s) {
  if (dtype == kFloat32) return dispatch_cout<float>(cout, mode, a, wl, s);
  if (dtype == kBFloat16) return dispatch_cout<__nv_bfloat16>(cout, mode, a, wl, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace dense
}  // namespace esr
