// conv_hr's bf16 forward in one launch: the alternative to the two-launch
// tensor-core design of esrganplus_tpu_torch/csrc/tail_ct.cu (the stage
// forward writes hid to device memory, conv_hr_out_mma_kernel reads it back).
// Not on any path of the package: tools/conv_hr_variants.py builds it, holds
// it against the plain twin and times it beside the package's design.
//
// A block owns OTH x 16 output pixels. It stages the (OTH+4) x 20 input tile
// once, runs conv0 (3x3 C->C, mma.sync) over the (OTH+2) x 18 hid tile that
// conv1 reads (M = that tile's pixels in m16 tiles, each lane's ldmatrix row
// address its own pixel, so a tap is still one shift), rounds lrelu(conv0 +
// b0) to bf16 into shared memory over the input tile, zero outside the image
// (conv1's SAME padding), then runs conv1 (K = 9 x C, one n8 tile) from it.
// The hid round trip through device memory is gone; conv0 does
// (OTH+2)*18 / (OTH*16) of the pixels' work (1.41x at OTH 8, 1.27x at 16,
// before padding M to m16 tiles).
#include <algorithm>

#include "mma_tile.cuh"

namespace {

using esr::mma::ldsm_pitch;
using esr::mma::smem_u32;
using esr::tile::bf16;

constexpr int C = 64;                 // the flagship width, conv0's K and N
constexpr int NTH = 256;              // 8 warps: 4 along M x 2 halves of N
constexpr int XP = ldsm_pitch(C);     // bytes of a [pixel][C] row
constexpr int SLOT = C * XP;          // one tap of w0 as [k = ci][n = co] rows
constexpr int NSLOT = 3;

template <int OTH>
struct Geo {
  static constexpr int HR = OTH + 2, HC = 18;   // hid tile
  static constexpr int XR = OTH + 4, XC = 20;   // input tile
  static constexpr int NH = HR * HC;
  static constexpr int MT0 = (NH + 15) / 16;    // conv0's m16 tiles
  static constexpr int MTW = (MT0 + 3) / 4;     // a warp's (4 warps along M)
  static constexpr int MT1 = OTH / 8;           // conv1's m16 tiles (output rows) a warp
  static constexpr size_t SMEM = (size_t)XR * XC * XP + (size_t)NSLOT * SLOT;
};

template <int OTH>
__global__ void __launch_bounds__(NTH) conv_hr_fused_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w0, const float* __restrict__ b0,
    const bf16* __restrict__ w1, const float* __restrict__ b1, bf16* __restrict__ out, int co2,
    int H, int W, float slope) {
  using G = Geo<OTH>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t xs = smem_u32(smem), ws = xs + G::XR * G::XC * XP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int b = blockIdx.z, y0 = blockIdx.y * OTH, x0 = blockIdx.x * 16;

  auto load_w = [&](int t) {
    const uint32_t dst = ws + (t % NSLOT) * SLOT;
    for (int i = tid; i < C * (C / 8); i += NTH) {
      const int r = i / (C / 8), n8 = i % (C / 8);
      esr::mma::cp_async16(dst + r * XP + n8 * 16, w0 + ((size_t)t * C + r) * C + n8 * 8, true);
    }
  };
  esr::tile::stage_tile<G::XR, G::XC>(x, smem, XP, b, y0 - 2, x0 - 2, H, W, C, 0, C, tid);
  esr::mma::cp_async_commit();
  load_w(0);
  esr::mma::cp_async_commit();
  load_w(1);
  esr::mma::cp_async_commit();

  float acc[G::MTW][4][4];
#pragma unroll
  for (int i = 0; i < G::MTW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  uint32_t arow[G::MTW];
#pragma unroll
  for (int i = 0; i < G::MTW; ++i) {
    const int p = min((wm * G::MTW + i) * 16 + (lane & 15), G::NH - 1);
    arow[i] = xs + ((p / G::HC) * G::XC + p % G::HC) * XP + (lane >> 4) * 16;
  }
  for (int t = 0; t < 9; ++t) {
    esr::mma::cp_async_wait<1>();
    __syncthreads();
    if (t + 2 < 9) load_w(t + 2);
    esr::mma::cp_async_commit();
    uint32_t a[G::MTW];
#pragma unroll
    for (int i = 0; i < G::MTW; ++i) a[i] = arow[i] + ((t / 3) * G::XC + t % 3) * XP;
    esr::tile::warp_mma<G::MTW, 4, true>(acc, a, ws + (t % NSLOT) * SLOT, XP, wn * 32, C, lane);
  }
  esr::mma::cp_async_wait<0>();
  __syncthreads();

  // hid over the input tile's space: [NH][C] rows, zero outside the image
#pragma unroll
  for (int i = 0; i < G::MTW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (wm * G::MTW + i) * 16 + (lane >> 2) + 8 * h;
        if (m >= G::NH) continue;
        const int gy = y0 - 1 + m / G::HC, gx = x0 - 1 + m % G::HC;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const int n = wn * 32 + j * 8 + (lane & 3) * 2;
        const float v0 = esr::tile::act_fwd(acc[i][j][2 * h] + b0[n], esr::tile::kLrelu, slope);
        const float v1 =
            esr::tile::act_fwd(acc[i][j][2 * h + 1] + b0[n + 1], esr::tile::kLrelu, slope);
        *reinterpret_cast<uint32_t*>(smem + m * XP + n * 2) =
            esr::mma::pack_bf16(in ? v0 : 0.f, in ? v1 : 0.f);
      }
  bf16* w1s = reinterpret_cast<bf16*>(smem + G::XR * G::XC * XP);  // [9 * C][8] over the ring
  for (int i = tid; i < 9 * C * 8; i += NTH) {
    const int co = i % 8, r = i / 8;
    w1s[i] = co < co2 ? w1[(size_t)r * co2 + co] : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  float acc1[G::MT1][1][4];
#pragma unroll
  for (int i = 0; i < G::MT1; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc1[i][0][r] = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    uint32_t a[G::MT1];
#pragma unroll
    for (int i = 0; i < G::MT1; ++i)
      a[i] = xs + ((warp * G::MT1 + i + t / 3) * G::HC + (lane & 15) + t % 3) * XP +
             (lane >> 4) * 16;
    esr::tile::warp_mma<G::MT1, 1, true>(acc1, a, ws + t * C * 16, 16, 0, C, lane);
  }
#pragma unroll
  for (int i = 0; i < G::MT1; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = y0 + warp * G::MT1 + i, xx = x0 + (lane >> 2) + 8 * h;
      if (y >= H || xx >= W) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = (lane & 3) * 2 + e;
        if (n < co2)
          out[(((size_t)b * H + y) * W + xx) * co2 + n] =
              __float2bfloat16_rn(acc1[i][0][2 * h + e] + b1[n]);
      }
    }
}

template <int OTH>
int launch(const void* x, const void* w0, const float* b0, const void* w1, const float* b1,
           void* out, int co2, int B, int H, int W, float slope, cudaStream_t s) {
  if (int e = esr::tile::smem_opt_in(conv_hr_fused_kernel<OTH>, Geo<OTH>::SMEM)) return e;
  const dim3 grid((W + 15) / 16, (H + OTH - 1) / OTH, B);
  conv_hr_fused_kernel<OTH><<<grid, NTH, Geo<OTH>::SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w0), b0, static_cast<const bf16*>(w1),
      b1, static_cast<bf16*>(out), co2, H, W, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [B,H,W,co2] bf16 from x [B,H,W,64], w0 [3,3,64,64], b0 [64], w1
// [3,3,64,co2], b1 [co2] (weights bf16, biases fp32); oth 8 or 16 output rows
// a block. Returns cudaGetLastError().
int esr_conv_hr_fused(int oth, const void* x, const void* w0, const float* b0, const void* w1,
                      const float* b1, void* out, int co2, int B, int H, int W, float slope,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co2 < 1 || co2 > 8) return (int)cudaErrorInvalidValue;
  if (oth == 8) return launch<8>(x, w0, b0, w1, b1, out, co2, B, H, W, slope, s);
  if (oth == 16) return launch<16>(x, w0, b0, w1, b1, out, co2, B, H, W, slope, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
