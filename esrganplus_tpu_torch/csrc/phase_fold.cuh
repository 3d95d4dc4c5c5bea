// The phase-folded 2x2 implicit GEMM of two bf16 tensor-core kernels
// (sm_90a) whose output has twice the resolution of the tensor they stage:
//   * the upconv (csrc/tail_ct.cu upfold_mma_kernel): nearest-x2 + 3x3 conv,
//     which the host folds into one 2x2 conv per output phase (a, b) =
//     (row & 1, column & 1): out(2m+a, 2n+b) reads x(m+a-1+i, n+b-1+j)
//     through wf[a][b][i][j] ([k = c][n = co] rows);
//   * the data gradient of the 4x4 stride-2 pad-1 conv (csrc/stage_ct.cu
//     stage_dgrad_s2_mma_kernel): the forward's output p reads input row
//     2p+ky-1, so input row 2m+a receives from dz rows m+a-1+i through tap
//     ky = 3-a-2i, columns likewise: dx(2m+a, 2n+b) reads dz(m+a-1+i,
//     n+b-1+j) through w[3-a-2i][3-b-2j] ([n = ci][k = co] rows).
// Both are, per output phase, four taps (i, j) in {0, 1}^2 of K = the staged
// channels. A block owns TH x TW staged pixels and stages their haloed
// (TH+2) x (TW+2) tile once (origin (y0-1, x0-1), zero outside the image) as
// [pixel][K] rows; tap (i, j) of phase (a, b) of block pixel (u, v) is tile
// pixel (u+a+i, v+b+j): the pixel's A row shifted by fold_shift(a, b, i, j)
// rows, read by ldmatrix. The tile stays resident for the four phases while
// the 16 (phase, tap) weight slices stream through a 3-slot cp.async ring in
// chunks of up to KCH rows (a whole tap at K <= 128). Where the tile of all K
// channels does not fit a block's shared memory (the upconv above about 440
// channels at 64 outputs) the tile holds KCH channels at a time, and each
// phase walks its slices in turn, restaging each (fold_kt). M = the block's 8
// m16 tiles (one a tile row), N = the output channels, K = 4 taps x the staged
// channels per phase. After each phase the fp32 accumulators take the
// caller's epilogue (bias and activation, or none), are rounded once into a
// staging region that overlaps neither the tile nor the ring, and leave as
// 16-byte vectors to output pixels (2(y0+u)+a, 2(x0+v)+b): 128 contiguous
// bytes a pixel at 64 channels, so every 32-byte sector is written whole.
// kernels/stage_ct.py fold_shift / fold_tap_slot mirror the map.
#pragma once

#include "mma_tile.cuh"

namespace esr {
namespace fold {

using mma::ldsm_pitch;
using tile::HP;
using tile::HW;
using tile::PIX;
using tile::Tiling;

constexpr int NSLOT = 3;    // weight-ring depth
constexpr int KCH = 128;    // K rows of a ring slot at most: a whole tap up to 128 channels
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may opt into on sm_90

// Rows that tap (i, j) of output phase (a, b) shifts a block pixel's A row by.
__host__ __device__ constexpr int fold_shift(int a, int b, int i, int j) {
  return (a + i) * HW + b + j;
}

__host__ __device__ constexpr int fold_kch(int kp) { return kp < KCH ? kp : KCH; }

// Bytes of a ring slot: kch rows of N ([k][n], BT) or N rows of kch ([n][k]).
__host__ __device__ constexpr int fold_slot(int np, int kch, bool bt) {
  return bt ? kch * ldsm_pitch(np) : np * ldsm_pitch(kch);
}

// Dynamic shared memory of a block: the haloed tile of kt channels, the ring,
// the output staging.
__host__ __device__ constexpr int fold_smem(int np, int kt, bool bt) {
  return HP * ldsm_pitch(kt) + NSLOT * fold_slot(np, fold_kch(kt), bt) + PIX * ldsm_pitch(np);
}

// Channels the staged tile holds: all kp where the block fits, else KCH.
__host__ __device__ constexpr int fold_kt(int np, int kp, bool bt) {
  return fold_smem(np, kp, bt) <= MAX_SMEM ? kp : KCH;
}

// Blocks an SM the compiler plans registers for: 4-warp blocks of <= 64
// channels fit three an SM; 8-warp blocks (a width above 64) one or two.
template <int NW>
__host__ __device__ constexpr int fold_min_blocks() { return NW == 4 ? 3 : 1; }

// The block's GEMMs over kp channels (a multiple of 16). stage_x(c0, len,
// pitch) copies channels c0 .. c0+len of the haloed tile to smem[0] as rows of
// `pitch` bytes (cp.async or plain stores, no commit); load_w(dst, phase, tap,
// c0, len) copies K rows c0 .. c0+len of slice (phase = 2a + b, tap = 2i + j)
// into a ring slot at shared address dst (cp.async, no commit); prologue()
// runs once, when the first tile slice and the first two weight stages are in
// flight (cp_async_wait<2> there waits for the tile alone): a caller that
// rewrites the tile in it must hold the whole tile (fold_kt == kp);
// store(phase, src, pitch) writes the staged [PIX][NP] bf16 rows of a
// finished phase. Stage s of the ring is (phase, tile slice, tap, K chunk).
template <int NP, int NW, bool BT, typename StageX, typename LoadW, typename Prologue,
          typename Store>
__device__ __forceinline__ void fold_mma(unsigned char* smem, int kp, StageX&& stage_x,
                                         LoadW&& load_w, Prologue&& prologue,
                                         const float* __restrict__ bias, int act, float slope,
                                         Store&& store) {
  using Tl = Tiling<NP, NW>;
  constexpr int DP = ldsm_pitch(NP);
  const int kt = fold_kt(NP, kp, BT), xp = ldsm_pitch(kt), kch = fold_kch(kt);
  const int slot = fold_slot(NP, kch, BT), wpitch = BT ? DP : ldsm_pitch(kch);
  const uint32_t xs = mma::smem_u32(smem), ws = xs + HP * xp;
  unsigned char* staged = smem + HP * xp + NSLOT * slot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / Tl::WN, wn = warp % Tl::WN;
  const int nkc = (kt + kch - 1) / kch, nsl = (kp + kt - 1) / kt;  // K chunks, tile slices
  const int nstage = 16 * nsl * nkc;

  // the ring's stages in order, walked by counters (no division in the loop)
  struct Walk {
    int ph = 0, sl = 0, t = 0, kc = 0;  // phase, tile slice, tap, K chunk
  };
  auto step = [&](Walk& w) {
    if (++w.kc < nkc) return;
    w.kc = 0;
    if (++w.t < 4) return;
    w.t = 0;
    if (++w.sl < nsl) return;
    w.sl = 0;
    ++w.ph;
  };
  auto rows = [&](const Walk& w) {  // K rows of the stage's chunk
    return min(kch, min(kp, (w.sl + 1) * kt) - w.sl * kt - w.kc * kch);
  };
  Walk wf, wc;  // the next stage to fetch, the stage to compute
  auto fetch = [&](int s) {
    load_w(ws + (s % NSLOT) * slot, wf.ph, wf.t, wf.sl * kt + wf.kc * kch, rows(wf));
    step(wf);
  };
  stage_x(0, min(kt, kp), xp);
  mma::cp_async_commit();
  fetch(0);
  mma::cp_async_commit();
  fetch(1);
  mma::cp_async_commit();
  prologue();

  float acc[Tl::MT][Tl::NT8][4];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  uint32_t arow[Tl::MT];  // tile row = block row + 1 (the halo), column lane & 15
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
    arow[i] = xs + ((wm * Tl::MT + i) * HW + (lane & 15)) * xp + (lane >> 4) * 16;

  for (int s = 0; s < nstage; ++s) {
    if (nsl > 1 && s > 0 && wc.kc == 0 && wc.t == 0) {  // restage: the tile's next slice
      const int c0 = wc.sl * kt;
      __syncthreads();  // every warp is done with the last slice
      stage_x(c0, min(kt, kp - c0), xp);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
    }
    mma::cp_async_wait<1>();  // the tile and stage s have landed
    __syncthreads();          // ... for every thread, and slot (s+2) % 3 is free
    if (s + 2 < nstage) fetch(s + 2);
    mma::cp_async_commit();
    const int ph = wc.ph, shift = fold_shift(ph >> 1, ph & 1, wc.t >> 1, wc.t & 1);
    uint32_t a[Tl::MT];
#pragma unroll
    for (int i = 0; i < Tl::MT; ++i) a[i] = arow[i] + shift * xp + wc.kc * kch * 2;
    tile::warp_mma<Tl::MT, Tl::NT8, BT>(acc, a, ws + (s % NSLOT) * slot, wpitch,
                                        wn * Tl::NT8 * 8, rows(wc), lane);
    step(wc);
    if (wc.ph != ph) {  // the phase is done: round once, store
      tile::acc_to_smem<NP, NW>(acc, staged, DP, bias, act, slope, warp, lane);
      __syncthreads();
      store(ph, staged, DP);
#pragma unroll
      for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
        for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    }
  }
  mma::cp_async_wait<0>();
}

}  // namespace fold
}  // namespace esr
