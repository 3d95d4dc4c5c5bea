// Upsample tail of RRDBNet (NHWC, sm_90a): upfold and conv_hr.
//
// Replaces two TPU kernels of esrganplus_tpu/kernels/tail_ct.py:
//   * upfold_ct  (_upfold_kernel): nearest-x2 upsample + 3x3 conv + bias +
//     leaky-relu in one pass. Nearest-up duplicates pixels, so for output
//     phase (a, b) = (Y mod 2, X mod 2) the nine HR taps collapse onto a 2x2
//     grid of distinct LR taps at row offsets {a-1, a} and column offsets
//     {b-1, b}; the host folds the weights accordingly (prepare_upfold_ct), so
//     the kernel does 4*C MACs per output channel instead of 9*C, and the
//     upsampled intermediate never exists in device memory. Zero padding at
//     LR resolution is exactly the HR zero padding after the fold.
//   * conv_hr_ct (_conv_hr_kernel): hr_conv0 (3x3 C->C + leaky-relu) fused
//     with hr_conv1 (3x3 C->CO2). conv0 runs over the (TH+2)x(TW+2) haloed
//     tile into shared memory and its values outside the image are set to
//     zero, because conv1's SAME padding pads conv0's *output*
//     (tail_ct.py:413-421); conv0's activation is rounded to T as the TPU
//     kernel rounds it. The C-channel HR intermediate never leaves shared
//     memory.
//
// Bound on this card: operations for upfold (4*C*CO MACs per HR pixel against
// a C-channel LR read and a CO-channel HR write); for conv_hr, 9*C*(C+CO2)
// MACs per HR pixel against C channels read and CO2 written, also operations.
// Like rdb_ct.cu this first version accumulates on the CUDA cores in fp32,
// with the same register tiling (4-6 pixels x C/8 channels per thread) over
// shared-memory tiles; the 2x2 fold cuts upfold's work 2.25x, and conv_hr
// never writes or re-reads its 64-channel HR intermediate.
#include <algorithm>

#include "common.cuh"

namespace {

using esr::from_f;
using esr::to_f;

constexpr int TH = 8;
constexpr int TW = 16;
constexpr int NT = 256;
constexpr int NCG = 8;
constexpr int NPG = NT / NCG;
constexpr int PPT = TH * TW / NPG;

// ---------------------------------------------------------------------------
// upfold: one block = one output phase (a, b) of an 8x16 LR tile, all CO.
// ---------------------------------------------------------------------------

template <typename T, int CO>
__global__ void __launch_bounds__(NT) upfold_kernel(
    const T* __restrict__ x, int C,      // [B,H,W,C] LR
    const T* __restrict__ wf,            // [2(a),2(b),2(i),2(j),C,CO] folded
    const float* __restrict__ bias,      // [CO]
    T* __restrict__ out,                 // [B,2H,2W,CO]
    int H, int W, float slope) {
  constexpr int KC = 16;
  constexpr int CPT = CO / NCG;
  __shared__ float xs[KC][TH + 1][TW + 1];
  __shared__ float ws[4][KC][CO];

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int phase = blockIdx.z & 3;
  const int b = blockIdx.z >> 2;
  const int pa = phase >> 1, pb = phase & 1;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t img = (size_t)b * H * W;

  float acc[PPT][CPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += KC) {
    // tile row ty holds LR row y0 + pa - 1 + ty; column likewise
    for (int i = tid; i < KC * (TH + 1) * (TW + 1); i += NT) {
      const int kk = i % KC;
      const int p = i / KC;
      const int ty = p / (TW + 1), tx = p % (TW + 1);
      const int gy = y0 + pa - 1 + ty, gx = x0 + pb - 1 + tx, c = k0 + kk;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C)
        v = to_f(x[(img + (size_t)gy * W + gx) * C + c]);
      xs[kk][ty][tx] = v;
    }
    for (int i = tid; i < 4 * KC * CO; i += NT) {
      const int co = i % CO;
      const int kk = (i / CO) % KC;
      const int t = i / (CO * KC);
      const int c = k0 + kk;
      ws[t][kk][co] = c < C ? to_f(wf[(((size_t)phase * 4 + t) * C + c) * CO + co]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int di = t >> 1, dj = t & 1;
        float wv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) wv[j] = ws[t][kk][cg * CPT + j];
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const int p = pg + NPG * i;
          const float v = xs[kk][p / TW + di][p % TW + dj];
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(v, wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  const int W2 = 2 * W;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = pg + NPG * i;
    const int gy = y0 + p / TW, gx = x0 + p % TW;
    if (gy >= H || gx >= W) continue;
    const size_t opix = ((size_t)b * 2 * H + 2 * gy + pa) * W2 + 2 * gx + pb;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cg * CPT + j;
      out[opix * CO + c] = from_f<T>(esr::lrelu(acc[i][j] + bias[c], slope));
    }
  }
}

// ---------------------------------------------------------------------------
// conv_hr: one block = an 8x16 HR output tile, conv0 over its 10x18 halo.
// ---------------------------------------------------------------------------

constexpr int HTW = TW + 2;                 // conv0 tile width
constexpr int NHP = (TH + 2) * (TW + 2);    // conv0 pixels per block (180)
constexpr int HP = NHP + 1;                 // padded channel stride of hid
constexpr int PPT0 = (NHP + NPG - 1) / NPG; // conv0 pixels per thread (6)

template <int C>
__host__ __device__ constexpr int hr_kc() { return C >= 64 ? 8 : (C < 16 ? C : 16); }  // divides C

template <int C>
int hr_region_floats(int co2) {
  constexpr int KC = hr_kc<C>();
  return std::max(KC * (TH + 4) * (TW + 4) + 9 * KC * C, 9 * C * co2);
}

template <typename T, int C>
__global__ void __launch_bounds__(NT) conv_hr_kernel(
    const T* __restrict__ x,                                  // [B,H,W,C]
    const T* __restrict__ w0, const float* __restrict__ b0,   // [3,3,C,C], [C]
    const T* __restrict__ w1, const float* __restrict__ b1,   // [3,3,C,CO2], [CO2]
    int co2, T* __restrict__ out,                             // [B,H,W,CO2]
    int H, int W, float slope, int region) {
  constexpr int KC = hr_kc<C>();
  constexpr int CPT = C / NCG;
  constexpr int XW = TW + 4;
  constexpr int XTILE = (TH + 4) * XW;
  extern __shared__ float smem[];
  float* xs = smem;                  // [KC][TH+4][TW+4]
  float* ws = smem + KC * XTILE;     // [9][KC][C]
  float* w1s = smem;                 // after conv0: [9][C][CO2]
  float* hid = smem + region;        // [C][HP]

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t img = (size_t)blockIdx.z * H * W;

  float acc[PPT0][CPT];
#pragma unroll
  for (int i = 0; i < PPT0; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // conv0 over the haloed tile: hid pixel (hy, hx) is image pixel
  // (y0 - 1 + hy, x0 - 1 + hx); its input window starts at y0 - 2 + hy.
  for (int k0 = 0; k0 < C; k0 += KC) {
    for (int i = tid; i < KC * XTILE; i += NT) {
      const int kk = i % KC;
      const int p = i / KC;
      const int ty = p / XW, tx = p % XW;
      const int gy = y0 - 2 + ty, gx = x0 - 2 + tx;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f(x[(img + (size_t)gy * W + gx) * C + k0 + kk]);
      xs[kk * XTILE + p] = v;
    }
    for (int i = tid; i < 9 * KC * C; i += NT) {
      const int co = i % C;
      const int kk = (i / C) % KC;
      const int t = i / (C * KC);
      ws[i] = to_f(w0[((size_t)t * C + k0 + kk) * C + co]);
    }
    __syncthreads();
    for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int dy = t / 3, dx = t % 3;
        float wv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) wv[j] = ws[(t * KC + kk) * C + cg * CPT + j];
#pragma unroll
        for (int i = 0; i < PPT0; ++i) {
          const int p = pg + NPG * i;
          if (p < NHP) {
            const float v = xs[kk * XTILE + (p / HTW + dy) * XW + p % HTW + dx];
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(v, wv[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PPT0; ++i) {
    const int p = pg + NPG * i;
    if (p >= NHP) continue;
    const int gy = y0 - 1 + p / HTW, gx = x0 - 1 + p % HTW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cg * CPT + j;
      hid[c * HP + p] =
          inside ? esr::round_to<T>(esr::lrelu(acc[i][j] + b0[c], slope)) : 0.f;
    }
  }
  for (int i = tid; i < 9 * C * co2; i += NT) w1s[i] = to_f(w1[i]);
  __syncthreads();

  // conv1 over the core tile, reading conv0's output from shared memory
  for (int o = tid; o < TH * TW * co2; o += NT) {
    const int p = o % (TH * TW);
    const int co = o / (TH * TW);
    const int oy = p / TW, ox = p % TW;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= H || gx >= W) continue;
    float a = 0.f;
    for (int c = 0; c < C; ++c) {
      const float* hc = hid + c * HP;
#pragma unroll
      for (int t = 0; t < 9; ++t)
        a = fmaf(hc[(oy + t / 3) * HTW + ox + t % 3], w1s[(t * C + c) * co2 + co], a);
    }
    out[(img + (size_t)gy * W + gx) * co2 + co] = from_f<T>(a + b1[co]);
  }
}

template <typename T, int CO>
int launch_upfold(const void* x, int C, const void* wf, const void* bias, void* out, int B,
                  int H, int W, float slope, cudaStream_t s) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, 4 * B);
  upfold_kernel<T, CO><<<grid, NT, 0, s>>>(static_cast<const T*>(x), C,
                                           static_cast<const T*>(wf),
                                           static_cast<const float*>(bias),
                                           static_cast<T*>(out), H, W, slope);
  return (int)cudaGetLastError();
}

template <typename T>
int upfold_cout(int CO, const void* x, int C, const void* wf, const void* bias, void* out,
                int B, int H, int W, float slope, cudaStream_t s) {
  switch (CO) {
    case 8: return launch_upfold<T, 8>(x, C, wf, bias, out, B, H, W, slope, s);
    case 16: return launch_upfold<T, 16>(x, C, wf, bias, out, B, H, W, slope, s);
    case 32: return launch_upfold<T, 32>(x, C, wf, bias, out, B, H, W, slope, s);
    case 64: return launch_upfold<T, 64>(x, C, wf, bias, out, B, H, W, slope, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int C>
int launch_conv_hr(int co2, const void* x, const void* w0, const void* b0, const void* w1,
                   const void* b1, void* out, int B, int H, int W, float slope,
                   cudaStream_t s) {
  const int region = hr_region_floats<C>(co2);
  const size_t bytes = (size_t)(region + C * HP) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(conv_hr_kernel<T, C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  conv_hr_kernel<T, C><<<grid, NT, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w0), static_cast<const float*>(b0),
      static_cast<const T*>(w1), static_cast<const float*>(b1), co2, static_cast<T*>(out), H,
      W, slope, region);
  return (int)cudaGetLastError();
}

template <typename T>
int conv_hr_c(int C, int co2, const void* x, const void* w0, const void* b0, const void* w1,
              const void* b1, void* out, int B, int H, int W, float slope, cudaStream_t s) {
  switch (C) {
    case 8: return launch_conv_hr<T, 8>(co2, x, w0, b0, w1, b1, out, B, H, W, slope, s);
    case 16: return launch_conv_hr<T, 16>(co2, x, w0, b0, w1, b1, out, B, H, W, slope, s);
    case 32: return launch_conv_hr<T, 32>(co2, x, w0, b0, w1, b1, out, B, H, W, slope, s);
    case 64: return launch_conv_hr<T, 64>(co2, x, w0, b0, w1, b1, out, B, H, W, slope, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Fused nearest-x2 + 3x3 conv + bias + lrelu. Returns cudaGetLastError().
int esr_upfold(int dtype, int C, int CO, const void* x, const void* wf, const void* bias,
               void* out, int B, int H, int W, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == esr::kFloat32) return upfold_cout<float>(CO, x, C, wf, bias, out, B, H, W, slope, s);
  if (dtype == esr::kBFloat16)
    return upfold_cout<__nv_bfloat16>(CO, x, C, wf, bias, out, B, H, W, slope, s);
  return (int)cudaErrorInvalidValue;
}

// Fused hr_conv0 (+lrelu) and hr_conv1. Returns cudaGetLastError().
int esr_conv_hr(int dtype, int C, int CO2, const void* x, const void* w0, const void* b0,
                const void* w1, const void* b1, void* out, int B, int H, int W, float slope,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (CO2 < 1 || CO2 > 8) return (int)cudaErrorInvalidValue;
  if (dtype == esr::kFloat32)
    return conv_hr_c<float>(C, CO2, x, w0, b0, w1, b1, out, B, H, W, slope, s);
  if (dtype == esr::kBFloat16)
    return conv_hr_c<__nv_bfloat16>(C, CO2, x, w0, b0, w1, b1, out, B, H, W, slope, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
