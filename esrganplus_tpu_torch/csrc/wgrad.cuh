// Weight and bias gradient of a SAME 3x3 (or 1x1) convolution (NHWC, sm_90a),
// written in either weight layout of wlayout.cuh.
//
// The dW/db half of four TPU adjoints: esrganplus_tpu/kernels/rdb_ct.py
// _rdb_ct_bwd_kernel (dw(dY_k, k) and dbv) and _conv3x3_ct_bwd_kernel, and
// through kernels/tail_ct.py _upfold_bwd_kernel and _conv_hr_bwd_kernel.
//
//   dW[dy, dx, ci, co] = sum_p x[p + (dy-1, dx-1), ci] * round_T(dz[p, co])
//   db[co]             = sum_p dz[p, co]                      (unrounded, fp32)
//
// a reduction over all B*H*W pixels into a small block, where the TPU kernel
// accumulates across its sequential grid. Here blocks run in no order, and
// fp32 atomics would make training differ from run to run, so the reduction
// is split deterministically: block (chunk, part) walks a fixed range of
// 8x16 pixel tiles for 16 (or 32) input channels and writes its partial sums
// to row `part` of a workspace, already in the layout the caller asked for
// (HWIO, or rdb_t's by-target [S, 9*C_prefix]); wgrad_finish_kernel then
// adds the rows in order. The split depends on the shapes only.
//
// Bound on this card: operations (the forward's MACs again). fp32 on the
// CUDA cores: a thread owns one input channel and S/16 output channels for
// all nine taps (9*S/16 accumulators) and slides a 3x3 register window along
// each tile row, so a pixel costs 3 + S/16 shared-memory loads for 9*S/16
// FMAs.
#pragma once

#include "dz_src.cuh"
#include "wlayout.cuh"

namespace esr {
namespace wgrad {

constexpr int TH = 8;
constexpr int TW = 16;
constexpr int NT = 256;

template <typename T, int S, int TAPS, typename L>
__global__ void __launch_bounds__(NT) wgrad_kernel(
    const T* __restrict__ x, int c0,      // [B,H,W,c0]: input channels [0, c0)
    const T* __restrict__ cat, int ccat,  // [B,H,W,ccat]: input channels [c0, cin)
    int cin, DzSrc dz, int s,             // dz has s <= S channels
    float* __restrict__ part, L wl,       // [npart][TAPS*cin*s + s], dW in layout L
    int tiles_per_part, int total_tiles, int tiles_x, int tiles_y) {
  constexpr int NCO = S >= 16 ? 16 : S;   // output-channel groups
  constexpr int KC = NT / NCO;            // input channels per block
  constexpr int CPT = S / NCO;
  __shared__ float xs[TH + 2][TW + 2][KC];
  __shared__ float dzs[TH * TW][S];
  __shared__ float red[NT];

  const int tid = threadIdx.x;
  const int ci = tid / NCO;
  const int cog = tid % NCO;
  const int cbeg = blockIdx.x * KC;
  const int H = dz.H, W = dz.W;
  const int row = TAPS * cin * s + s;
  float* out = part + (size_t)blockIdx.y * row;

  float acc[TAPS][CPT];
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[t][j] = 0.f;
  float dbacc = 0.f;  // this thread always stages output channel tid % S

  const int tile_end = min(total_tiles, (int)(blockIdx.y + 1) * tiles_per_part);
  for (int tile = blockIdx.y * tiles_per_part; tile < tile_end; ++tile) {
    const int b = tile / (tiles_x * tiles_y);
    const int y0 = (tile / tiles_x) % tiles_y * TH, x0 = tile % tiles_x * TW;
    for (int i = tid; i < (TH + 2) * (TW + 2) * KC; i += NT) {
      const int kk = i % KC;
      const int p = i / KC;
      const int gy = y0 + p / (TW + 2) - 1, gx = x0 + p % (TW + 2) - 1, c = cbeg + kk;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin) {
        const size_t pix = ((size_t)b * H + gy) * W + gx;
        v = c < c0 ? to_f(x[pix * c0 + c]) : to_f(cat[pix * ccat + (c - c0)]);
      }
      xs[p / (TW + 2)][p % (TW + 2)][kk] = v;
    }
    for (int i = tid; i < TH * TW * S; i += NT) {
      const int co = i % S;
      const int p = i / S;
      const int gy = y0 + p / TW, gx = x0 + p % TW;
      float v = 0.f;
      if (gy < H && gx < W && co < s) v = dz_load<T>(dz, b, gy, gx, co);
      dbacc += v;
      dzs[p][co] = round_to<T>(v);
    }
    __syncthreads();
    if (TAPS == 9) {
      for (int y = 0; y < TH; ++y) {
        float a[3][3];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          a[dy][0] = xs[y + dy][0][ci];
          a[dy][1] = xs[y + dy][1][ci];
        }
#pragma unroll
        for (int px = 0; px < TW; ++px) {
          float d[CPT];
#pragma unroll
          for (int j = 0; j < CPT; ++j) d[j] = dzs[y * TW + px][cog + NCO * j];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            a[dy][2] = xs[y + dy][px + 2][ci];
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
#pragma unroll
              for (int j = 0; j < CPT; ++j)
                acc[TAPS == 9 ? dy * 3 + dx : 0][j] =
                    fmaf(a[dy][dx], d[j], acc[TAPS == 9 ? dy * 3 + dx : 0][j]);
            a[dy][0] = a[dy][1];
            a[dy][1] = a[dy][2];
          }
        }
      }
    } else {
      for (int p = 0; p < TH * TW; ++p) {
        const float v = xs[p / TW + 1][p % TW + 1][ci];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[0][j] = fmaf(v, dzs[p][cog + NCO * j], acc[0][j]);
      }
    }
    __syncthreads();
  }

  if (cbeg + ci < cin) {
#pragma unroll
    for (int t = 0; t < TAPS; ++t)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int co = cog + NCO * j;
        if (co < s) out[wl(TAPS, t, cbeg + ci, co, cin, s)] = acc[t][j];
      }
  }
  if (blockIdx.x == 0) {  // db from the staged, unrounded dz, in a fixed order
    red[tid] = dbacc;
    __syncthreads();
    if (tid < s) {
      float v = 0.f;
      for (int k = 0; k < NT / S; ++k) v += red[tid + S * k];
      out[(size_t)TAPS * cin * s + tid] = v;
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in that order.
__global__ void wgrad_finish_kernel(const float* __restrict__ part, int npart, int row,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= row) return;
  float v = 0.f;
  for (int p = 0; p < npart; ++p) v += part[(size_t)p * row + i];
  out[i] = v;
}

struct WgradArgs {
  const void *x, *cat;
  DzSrc dz;
  float *part, *out;
  int c0, ccat, cin, s, B, npart;
};

template <typename T, int S, int TAPS, typename L>
int launch(const WgradArgs& a, L wl, cudaStream_t stream) {
  constexpr int KC = NT / (S >= 16 ? 16 : S);
  const int tiles_x = (a.dz.W + TW - 1) / TW, tiles_y = (a.dz.H + TH - 1) / TH;
  const int total = a.B * tiles_x * tiles_y;
  const int per = (total + a.npart - 1) / a.npart;
  const dim3 grid((a.cin + KC - 1) / KC, a.npart);
  wgrad_kernel<T, S, TAPS, L><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a.x), a.c0, static_cast<const T*>(a.cat), a.ccat, a.cin, a.dz,
      a.s, a.part, wl, per, total, tiles_x, tiles_y);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int row = TAPS * a.cin * a.s + a.s;
  wgrad_finish_kernel<<<(row + 255) / 256, 256, 0, stream>>>(a.part, a.npart, row, a.out);
  return (int)cudaGetLastError();
}

template <typename T, int S, typename L>
int dispatch_taps(int taps, const WgradArgs& a, L wl, cudaStream_t s) {
  if (taps == 9) return launch<T, S, 9>(a, wl, s);
  if (taps == 1) return launch<T, S, 1>(a, wl, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename L>
int dispatch_s(int taps, const WgradArgs& a, L wl, cudaStream_t st) {
  if (a.s <= 8) return dispatch_taps<T, 8>(taps, a, wl, st);
  if (a.s == 16) return dispatch_taps<T, 16>(taps, a, wl, st);
  if (a.s == 32) return dispatch_taps<T, 32>(taps, a, wl, st);
  if (a.s == 64) return dispatch_taps<T, 64>(taps, a, wl, st);
  return (int)cudaErrorInvalidValue;
}

// out[0 : taps*cin*s] = dW in layout L, out[taps*cin*s :] = db. `part` is an
// fp32 workspace of npart * (taps*cin*s + s) floats. Returns
// cudaGetLastError().
template <typename L>
int run(int dtype, int taps, const void* x, int c0, const void* cat, int ccat, int cin,
        const DzSrc* dz, int s, L wl, float* part, int npart, float* out, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (npart < 1 || s < 1) return (int)cudaErrorInvalidValue;
  const WgradArgs a{x, cat, *dz, part, out, c0, ccat, cin, s, B, npart};
  if (dtype == kFloat32) return dispatch_s<float>(taps, a, wl, st);
  if (dtype == kBFloat16) return dispatch_s<__nv_bfloat16>(taps, a, wl, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace wgrad
}  // namespace esr
