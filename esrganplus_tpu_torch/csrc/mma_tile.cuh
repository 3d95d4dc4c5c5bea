// Tile-level building blocks of the port's bf16 tensor-core kernels (sm_90a),
// on csrc/mma_bf16.cuh: the 8x16 pixel tile and its 1-pixel halo, staging a
// haloed NHWC tile into shared [pixel][channel] rows (cp.async, zero outside
// the image), a warp's implicit-GEMM product over a run of K, and the
// epilogue that rounds the block's fp32 accumulators once and stores them.
// Used by csrc/stage_ct.cu (the stage convs) and csrc/tail_ct.cu (the
// upsample tail).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace esr {
namespace tile {

using bf16 = __nv_bfloat16;
using mma::cp_async16;
using mma::smem_u32;

// the fused activation of a conv's epilogue
enum Act : int { kNone = 0, kRelu = 1, kLrelu = 2 };

__device__ __forceinline__ float act_fwd(float v, int act, float slope) {
  if (act == kRelu) return fmaxf(v, 0.f);
  if (act == kLrelu) return v >= 0.f ? v : v * slope;
  return v;
}

constexpr int TH = 8, TW = 16;          // a block's pixel tile
constexpr int PIX = TH * TW;            // M of a block (8 m16 tiles, one per tile row)
constexpr int HW = TW + 2;              // haloed tile width
constexpr int HP = (TH + 2) * HW;       // haloed tile pixels (180)

__host__ __device__ constexpr int round16(int c) { return (c + 15) / 16 * 16; }

// warps and fragments of an N-wide product over PIX = 8 m16 tiles by NW warps
template <int NP, int NW_>
struct Tiling {
  static constexpr int NW = NW_;                // warps (4 or 8)
  static constexpr int NTH = NW * 32;           // threads
  static constexpr int WN = NP >= 16 ? 2 : 1;   // warps along N
  static constexpr int WM = NW / WN;            // warps along M
  static constexpr int MT = 8 / WM;             // m16 tiles (tile rows) per warp
  static constexpr int NT8 = NP / 8 / WN;       // n8 tiles per warp
  static constexpr int MIN_BLOCKS = NW == 8 ? 2 : 3;
};

// Shared row of pixel p = (y, x) of an RH x RW tile: p itself, or with
// PARITY (RH, RW even) row (y >> 1) * RW/2 + (x >> 1) of parity plane
// (y & 1, x & 1), the planes one after another (kernels/stage_ct.py
// s2_plane_slot mirrors it).
template <int RH, int RW, bool PARITY>
__device__ __forceinline__ int tile_slot(int p) {
  if constexpr (!PARITY) return p;
  const int y = p / RW, x = p % RW;
  return ((y & 1) * 2 + (x & 1)) * (RH / 2) * (RW / 2) + (y >> 1) * (RW / 2) + (x >> 1);
}

// A haloed RH x RW tile of src [B, H, W, c] (origin gy0, gx0; channels
// c_off .. c_off + cs) into shared [pixel][cs] bf16 rows of `pitch` bytes
// (at tile_slot<RH, RW, PARITY>), zero outside the image and at channels >= c.
// cp.async when rows are 16-byte aligned (c % 8 == 0), plain loads otherwise.
template <int RH, int RW, bool PARITY = false>
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ src, unsigned char* dst,
                                           int pitch, int b, int gy0, int gx0, int H, int W,
                                           int c, int c_off, int cs, int tid) {
  const int nth = blockDim.x;
  if ((c & 7) == 0) {
    const uint32_t d = smem_u32(dst);
    const int nc = cs / 8;
    for (int i = tid; i < RH * RW * nc; i += nth) {
      const int p = i / nc, c8 = i % nc;
      const int gy = gy0 + p / RW, gx = gx0 + p % RW, ch = c_off + c8 * 8;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < c;
      cp_async16(d + tile_slot<RH, RW, PARITY>(p) * pitch + c8 * 16,
                 ok ? src + (((size_t)b * H + gy) * W + gx) * c + ch : src, ok);
    }
  } else {  // a pixel at a time: loads of the real channels, 16-byte stores
    const int nc = cs / 8;
    for (int i = tid; i < RH * RW * nc; i += nth) {
      const int p = i / nc, c8 = i % nc;
      const int gy = gy0 + p / RW, gx = gx0 + p % RW;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const bf16* px = in ? src + (((size_t)b * H + gy) * W + gx) * c : src;
      __align__(16) bf16 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int ch = c_off + c8 * 8 + k;
        v[k] = in && ch < c ? px[ch] : __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint4*>(dst + tile_slot<RH, RW, PARITY>(p) * pitch + c8 * 16) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

__device__ __forceinline__ uint4 pack8(const float (&d)[8]) {
  uint4 r;
  r.x = esr::mma::pack_bf16(d[0], d[1]);
  r.y = esr::mma::pack_bf16(d[2], d[3]);
  r.z = esr::mma::pack_bf16(d[4], d[5]);
  r.w = esr::mma::pack_bf16(d[6], d[7]);
  return r;
}

// acc += A * B over `klen` (a multiple of 16) for this warp's MT m16 tiles
// and NT8 n8 tiles from column n0. a[i]: this lane's ldmatrix row address of
// m16 tile i ([pixel][k] rows, k offset (lane / 16) * 8 folded in). B is a
// [k][n] tile read with .trans (BT) or an [n][k] tile read plainly.
template <int MT, int NT8, bool BT>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT8][4], const uint32_t (&a)[MT],
                                         uint32_t bt, int bpitch, int n0, int klen, int lane) {
  using namespace esr::mma;
  for (int k = 0; k < klen; k += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) ldsm_x4(af[i], a[i] + k * 2);
    if constexpr (NT8 == 1) {
      uint32_t b[2];
      const int l = lane & 15;
      if constexpr (BT) ldsm_x2_t(b, bt + (k + l) * bpitch + n0 * 2);
      else ldsm_x2(b, bt + (n0 + (l & 7)) * bpitch + (k + (l >> 3) * 8) * 2);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_bf16(acc[i][0], af[i], b[0], b[1]);
    } else {
#pragma unroll
      for (int j = 0; j < NT8; j += 2) {
        uint32_t b[4];
        if constexpr (BT)
          ldsm_x4_t(b, bt + (k + (lane & 15)) * bpitch + (n0 + j * 8 + (lane >> 4) * 8) * 2);
        else
          ldsm_x4(b, bt + (n0 + j * 8 + (lane & 7) + (lane >> 4) * 8) * bpitch +
                         (k + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], af[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], af[i], b[2], b[3]);
        }
      }
    }
  }
}

// The block's accumulators (PIX x NP) as bf16 into shared rows of `pitch`
// bytes, after bias and activation when `bias` is given.
template <int NP, int NW>
__device__ __forceinline__ void acc_to_smem(
    const float (&acc)[Tiling<NP, NW>::MT][Tiling<NP, NW>::NT8][4], unsigned char* dst, int pitch,
    const float* __restrict__ bias, int act, float slope, int warp, int lane) {
  using Tl = Tiling<NP, NW>;
  const int wm = warp / Tl::WN, wn = warp % Tl::WN;
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT8; ++j) {
      const int m = (wm * Tl::MT + i) * 16 + (lane >> 2);
      const int n = (wn * Tl::NT8 + j) * 8 + (lane & 3) * 2;
      const float b0 = bias ? bias[n] : 0.f, b1 = bias ? bias[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = act_fwd(acc[i][j][2 * h] + b0, act, slope);
        const float v1 = act_fwd(acc[i][j][2 * h + 1] + b1, act, slope);
        *reinterpret_cast<uint32_t*>(dst + (m + 8 * h) * pitch + n * 2) =
            esr::mma::pack_bf16(v0, v1);
      }
    }
}

// Shared [PIX][np] bf16 rows to dst [B, H, W, c] at the tile (y0, x0): the
// channels < c of the pixels inside the image. With S = 2, row m of the tile
// (pixel (y, x) of an H x W grid) goes to pixel (2y + a, 2x + bb) of dst
// [B, 2H, 2W, c]: one output phase of a doubled-resolution output.
template <int S = 1>
__device__ __forceinline__ void smem_to_out(const unsigned char* src, int pitch,
                                            bf16* __restrict__ dst, int b, int y0, int x0, int H,
                                            int W, int c, int tid, int a = 0, int bb = 0) {
  const int nth = blockDim.x;
  if ((c & 7) == 0) {
    const int nc = c / 8;
    for (int i = tid; i < PIX * nc; i += nth) {
      const int m = i / nc, c8 = i % nc, y = y0 + m / TW, x = x0 + m % TW;
      if (y < H && x < W)
        *reinterpret_cast<uint4*>(
            dst + (((size_t)b * S * H + S * y + a) * S * W + S * x + bb) * c + c8 * 8) =
            *reinterpret_cast<const uint4*>(src + m * pitch + c8 * 16);
    }
  } else {
    for (int i = tid; i < PIX * c; i += nth) {
      const int m = i / c, k = i % c, y = y0 + m / TW, x = x0 + m % TW;
      if (y < H && x < W)
        dst[(((size_t)b * S * H + S * y + a) * S * W + S * x + bb) * c + k] =
            reinterpret_cast<const bf16*>(src + m * pitch)[k];
    }
  }
}

// Opt a kernel into `bytes` of dynamic shared memory (above the 48 KB default).
template <typename K>
int smem_opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace tile
}  // namespace esr
