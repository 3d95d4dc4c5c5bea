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
// above the H100's ~295 FLOP/byte ridge. This first version accumulates on
// the CUDA cores in fp32 (the tensor cores are later work), so its roof is
// the 67 TFLOP/s fp32 CUDA-core peak. What the design does about the bound:
// each 256-thread block owns an 8x16 pixel tile and one chunk of CO output
// channels; it stages a KC-channel slice of the haloed input tile once in
// shared memory (reused by all nine taps) with the matching 9 x KC x CO
// weights, and every thread keeps a 4-pixel x CO/8-channel register tile, so
// each shared-memory load feeds several FMAs. Any Cin and any Cout: the
// channel slice and the last Cout chunk are predicated (zero weights, no
// store past Cout).
#include "common.cuh"

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

}  // namespace wbconv
}  // namespace esr

extern "C" {

// out = act(conv3x3(x, w) + bias) in one launch; `act` 0 linear, 1 leaky
// ReLU with `slope` (0 is ReLU). Returns cudaGetLastError().
int esr_wb_conv3x3(int dtype, const void* x, const void* w, const float* bias, void* out, int B,
                   int H, int W, int cin, int cout, int act, float slope, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == esr::kFloat32)
    return esr::wbconv::dispatch<float>(x, w, bias, out, B, H, W, cin, cout, act, slope, s);
  if (dtype == esr::kBFloat16)
    return esr::wbconv::dispatch<__nv_bfloat16>(x, w, bias, out, B, H, W, cin, cout, act,
                                                slope, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
