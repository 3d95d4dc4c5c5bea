// Data gradient of a SAME 3x3 (or 1x1) convolution (NHWC, sm_90a), for
// weights in either layout of wlayout.cuh.
//
// The dx half of four TPU adjoints:
//   * esrganplus_tpu/kernels/rdb_ct.py _rdb_ct_bwd_kernel (dim_add + untap3):
//     one launch per dense stage, walked 5 -> 1 over an fp32 cotangent buffer
//     [B,H,W,nf+4*gc] that takes the place of the TPU kernel's dim_ref. Stage
//     k reads its dz from the buffer's x_k channels (gated at load, dz_src.cuh)
//     and adds w_k^T * dz_k into the channels of every earlier source; stage
//     2's 1x1 shortcut is one more launch with TAPS = 1; the last launch adds
//     the skip's cotangent and rounds dx to T once.
//   * _conv3x3_ct_bwd_kernel, and through kernels/tail_ct.py the upconv's and
//     the hr convs' adjoints (_upfold_bwd_kernel, _conv_hr_bwd_kernel).
//
// dx[p, ci] = sum_{dy,dx,co} dz[p - (dy-1, dx-1), co] * w[dy, dx, ci, co]: a
// 3x3 convolution of dz with the taps flipped and the weight's channel axes
// swapped, read straight from the forward's weights (HWIO for rdb_ct and the
// tail, rdb_t's by-target matrices for rdb_t_bwd).
//
// Bound on this card: operations (the forward's MACs again). Like the forward
// kernel this version accumulates on the CUDA cores in fp32: a 256-thread
// block owns an 8x16 pixel tile and CO of the conv's input channels, stages
// 16 dz channels of the haloed tile (rounded to T) and the matching weights
// in shared memory, and keeps a 4-pixel x CO/8-channel register tile.
#pragma once

#include "dz_src.cuh"
#include "wlayout.cuh"

namespace esr {
namespace dgrad {

constexpr int TH = 8;
constexpr int TW = 16;
constexpr int NT = 256;
constexpr int NCG = 8;
constexpr int NPG = NT / NCG;
constexpr int PPT = TH * TW / NPG;
constexpr int KC = 16;  // dz channels staged per step

template <typename T, int CO, int TAPS, typename L>
__global__ void __launch_bounds__(NT) dgrad_kernel(
    DzSrc dz, int s,                     // dz has s channels
    const T* __restrict__ w, L wl, int cin,  // TAPS x cin x s in layout L
    float* __restrict__ out32, int o32_stride, int accumulate,  // fp32 [pix * stride + c]
    T* __restrict__ outT, int oT_stride,                        // or T, rounded once
    DzSrc addg, int add_g,               // outT only: + this cotangent (the skip path)
    int nchunk) {
  constexpr int CPT = CO / NCG;
  constexpr int HALO = TAPS == 9 ? 1 : 0;
  constexpr int XH = TH + 2 * HALO, XW = TW + 2 * HALO;
  __shared__ float xs[KC][XH][XW];
  __shared__ float ws[TAPS][KC][CO];

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int b = blockIdx.z / nchunk;
  const int cbeg = (blockIdx.z % nchunk) * CO;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int H = dz.H, W = dz.W;

  float acc[PPT][CPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < s; k0 += KC) {
    for (int i = tid; i < KC * XH * XW; i += NT) {
      const int kk = i % KC;
      const int p = i / KC;
      const int ty = p / XW, tx = p % XW;
      const int gy = y0 + ty - HALO, gx = x0 + tx - HALO, c = k0 + kk;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < s)
        v = round_to<T>(dz_load<T>(dz, b, gy, gx, c));
      xs[kk][ty][tx] = v;
    }
    // tile tap t' pairs with forward tap TAPS-1-t' (the flip)
    for (int i = tid; i < TAPS * KC * CO; i += NT) {
      const int kk = i % KC;
      const int co = (i / KC) % CO;
      const int t = i / (KC * CO);
      const int c = k0 + kk, ci = cbeg + co;
      ws[t][kk][co] = (c < s && ci < cin)
                          ? to_f(w[wl(TAPS, TAPS - 1 - t, ci, c, cin, s)]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        const int dy = TAPS == 9 ? t / 3 : 0, dx = TAPS == 9 ? t % 3 : 0;
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
    const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cbeg + cg * CPT + j;
      if (c >= cin) continue;
      float v = acc[i][j];
      if (out32 && accumulate) v += out32[pix * o32_stride + c];
      if (outT) {
        if (add_g) v += dz_load<T>(addg, b, gy, gx, c);
        outT[pix * oT_stride + c] = from_f<T>(v);
      } else {
        out32[pix * o32_stride + c] = v;
      }
    }
  }
}

struct DgradArgs {
  DzSrc dz, addg;
  const void* w;
  float* out32;
  void* outT;
  int s, cin, o32_stride, accumulate, oT_stride, add_g, B;
};

template <typename T, int CO, int TAPS, typename L>
int launch(const DgradArgs& a, L wl, cudaStream_t stream) {
  const int nchunk = (a.cin + CO - 1) / CO;
  const dim3 grid((a.dz.W + TW - 1) / TW, (a.dz.H + TH - 1) / TH, a.B * nchunk);
  dgrad_kernel<T, CO, TAPS, L><<<grid, NT, 0, stream>>>(
      a.dz, a.s, static_cast<const T*>(a.w), wl, a.cin, a.out32, a.o32_stride, a.accumulate,
      static_cast<T*>(a.outT), a.oT_stride, a.addg, a.add_g, nchunk);
  return (int)cudaGetLastError();
}

template <typename T, int CO, typename L>
int dispatch_taps(int taps, const DgradArgs& a, L wl, cudaStream_t s) {
  if (taps == 9) return launch<T, CO, 9>(a, wl, s);
  if (taps == 1) return launch<T, CO, 1>(a, wl, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename L>
int dispatch_co(int co, int taps, const DgradArgs& a, L wl, cudaStream_t s) {
  switch (co) {
    case 8: return dispatch_taps<T, 8>(taps, a, wl, s);
    case 16: return dispatch_taps<T, 16>(taps, a, wl, s);
    case 32: return dispatch_taps<T, 32>(taps, a, wl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dx (+)= conv^T(dz, w) for the conv's input channels [0, cin), `chunk` of
// them per block, with the weights in layout L. With `outT` the result (plus
// out32's earlier content when `accumulate`, plus `addg` when given) is
// rounded to T; else it is stored or accumulated in out32. Returns
// cudaGetLastError().
template <typename L>
int run(int dtype, int chunk, int taps, const DzSrc* dz, int s, const void* w, L wl, int cin,
        float* out32, int o32_stride, int accumulate, void* outT, int oT_stride,
        const DzSrc* addg, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DgradArgs a{*dz, addg ? *addg : *dz, w, out32, outT, s, cin, o32_stride, accumulate,
              oT_stride, addg ? 1 : 0, B};
  if (!out32 && !outT) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) return dispatch_co<float>(chunk, taps, a, wl, st);
  if (dtype == kBFloat16) return dispatch_co<__nv_bfloat16>(chunk, taps, a, wl, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace dgrad
}  // namespace esr
