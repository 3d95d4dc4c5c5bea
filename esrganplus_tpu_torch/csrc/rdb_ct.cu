// Dense-stage 3x3 convolution for the RRDB trunk (NHWC, sm_90a).
//
// Replaces two TPU kernels of esrganplus_tpu/kernels/rdb_ct.py:
//   * rdb_ct      (_rdb_ct_kernel / _rdb_ct_pipe_kernel): one whole
//     ResidualDenseBlock_5C. Here it is five launches of this kernel, one per
//     dense stage, over a per-call NHWC concat buffer [B,H,W,4*gc] that holds
//     x1|x2|x3|x4; x itself is read in place, so no concatenation is ever
//     copied. Stage k convolves the first nf+(k-1)*gc channels of (x | buffer)
//     and writes its gc (stage 5: nf) channels; the epilogue carries bias,
//     leaky-relu, the stage-2 1x1 shortcut (computed from x's centre tap in
//     the same pass), the stage-4 x4 += x2, and the stage-5 beta*x5 + x with
//     the optional RRDB fold (*rrdb + h0), each rounded to T once, as
//     rdb_ct.py:217-233 and :258-266 do.
//   * conv3x3_ct  (_conv_ct_kernel): the trunk conv plus the global residual,
//     the same kernel in RESID mode with alpha = 1 (rdb_ct.py:556-566).
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
#include "common.cuh"

namespace {

using esr::from_f;
using esr::to_f;

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

template <typename T, int COUT, int MODE>
__global__ void __launch_bounds__(NT) dense_conv3x3_kernel(
    const T* __restrict__ x, int c0,        // [B,H,W,c0]: input channels [0, c0)
    const T* __restrict__ cat, int ccat,    // [B,H,W,ccat]: input channels [c0, cin)
    int cin,
    const T* __restrict__ w,                // [3,3,cin,COUT] (HWIO)
    const float* __restrict__ bias,         // [COUT]
    const T* __restrict__ w11,              // kAct1x1: [c0, COUT]
    T* __restrict__ out, int out_stride,    // pixel stride of the output
    const T* __restrict__ r1, int r1_stride,
    const T* __restrict__ r2, int r2_stride,
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
      ws[t][kk][co] = c < cin ? to_f(w[((size_t)t * cin + c) * COUT + co]) : 0.f;
    }
    if (MODE == kAct1x1) {
      for (int i = tid; i < KC * COUT; i += NT) {
        const int co = i % COUT, kk = i / COUT, c = k0 + kk;
        w11s[MODE == kAct1x1 ? kk : 0][co] = c < c0 ? to_f(w11[(size_t)c * COUT + co]) : 0.f;
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
      } else {
        v = esr::lrelu(v, slope);
        if (MODE == kAct1x1) v += acc11[MODE == kAct1x1 ? i : 0][j];
        if (MODE == kActAdd) v += to_f(r1[pix * r1_stride + c]);
      }
      out[pix * out_stride + c] = from_f<T>(v);
    }
  }
}

template <typename T, int COUT, int MODE>
void launch(const void* x, int c0, const void* cat, int ccat, int cin, const void* w,
            const void* bias, const void* w11, void* out, int out_stride, const void* r1,
            int r1_stride, const void* r2, int r2_stride, float alpha, float beta2,
            float slope, int B, int H, int W, cudaStream_t stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  dense_conv3x3_kernel<T, COUT, MODE><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), c0, static_cast<const T*>(cat), ccat, cin,
      static_cast<const T*>(w), static_cast<const float*>(bias), static_cast<const T*>(w11),
      static_cast<T*>(out), out_stride, static_cast<const T*>(r1), r1_stride,
      static_cast<const T*>(r2), r2_stride, alpha, beta2, slope, H, W);
}

template <typename T, int COUT>
int dispatch_mode(int mode, const void* x, int c0, const void* cat, int ccat, int cin,
                  const void* w, const void* bias, const void* w11, void* out, int out_stride,
                  const void* r1, int r1_stride, const void* r2, int r2_stride, float alpha,
                  float beta2, float slope, int B, int H, int W, cudaStream_t s) {
#define ESR_LAUNCH(M)                                                                    \
  launch<T, COUT, M>(x, c0, cat, ccat, cin, w, bias, w11, out, out_stride, r1, r1_stride, \
                     r2, r2_stride, alpha, beta2, slope, B, H, W, s)
  switch (mode) {
    case kAct: ESR_LAUNCH(kAct); break;
    case kAct1x1: ESR_LAUNCH(kAct1x1); break;
    case kActAdd: ESR_LAUNCH(kActAdd); break;
    case kResid: ESR_LAUNCH(kResid); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ESR_LAUNCH
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_cout(int cout, int mode, const void* x, int c0, const void* cat, int ccat,
                  int cin, const void* w, const void* bias, const void* w11, void* out,
                  int out_stride, const void* r1, int r1_stride, const void* r2,
                  int r2_stride, float alpha, float beta2, float slope, int B, int H, int W,
                  cudaStream_t s) {
#define ESR_COUT(C)                                                                   \
  return dispatch_mode<T, C>(mode, x, c0, cat, ccat, cin, w, bias, w11, out,          \
                             out_stride, r1, r1_stride, r2, r2_stride, alpha, beta2, \
                             slope, B, H, W, s)
  switch (cout) {
    case 8: ESR_COUT(8);
    case 16: ESR_COUT(16);
    case 32: ESR_COUT(32);
    case 64: ESR_COUT(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ESR_COUT
}

}  // namespace

extern "C" {

// One dense-stage (or conv3x3_ct) launch on `stream`. Returns the
// cudaGetLastError() code after the launch (0 = launched).
int esr_dense_conv3x3(int dtype, int cout, int mode, const void* x, int c0, const void* cat,
                      int ccat, int cin, const void* w, const void* bias, const void* w11,
                      void* out, int out_stride, const void* r1, int r1_stride,
                      const void* r2, int r2_stride, float alpha, float beta2, float slope,
                      int B, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == esr::kFloat32)
    return dispatch_cout<float>(cout, mode, x, c0, cat, ccat, cin, w, bias, w11, out,
                                out_stride, r1, r1_stride, r2, r2_stride, alpha, beta2,
                                slope, B, H, W, s);
  if (dtype == esr::kBFloat16)
    return dispatch_cout<__nv_bfloat16>(cout, mode, x, c0, cat, ccat, cin, w, bias, w11, out,
                                        out_stride, r1, r1_stride, r2, r2_stride, alpha,
                                        beta2, slope, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
