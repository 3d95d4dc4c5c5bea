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
//     the hr convs' fp32 adjoints (_upfold_bwd_kernel, _conv_hr_bwd_kernel).
//   * esrganplus_tpu/kernels/rdb_t.py _rdb_t_bwd_kernel, on rdb_t's
//     by-target weights (csrc/rdb_t.cu).
//
// dx[p, ci] = sum_{dy,dx,co} dz[p - (dy-1, dx-1), co] * w[dy, dx, ci, co]: a
// 3x3 convolution of dz with the taps flipped and the weight's channel axes
// swapped, read straight from the forward's weights (HWIO for rdb_ct and the
// tail, rdb_t's by-target matrices for rdb_t_bwd).
//
// Bound on this card: operations (the forward's MACs again). Two designs,
// picked by the wrapper by dtype (kernels/launch.py design); the C entries
// take the design and refuse fp32 on the tensor cores, so nothing falls back:
//   * "mma" (bf16): dgrad_mma_kernel, an implicit GEMM on the tensor cores
//     (mma.sync m16n8k16 bf16 -> fp32, csrc/mma_tile.cuh). M = a block's
//     8x16 pixel tile, N = an NP-channel chunk of the conv's input channels
//     (dgrad_np: chunks over blockIdx.z split cin where one block a tile would
//     leave SMs idle), K = TAPS x s. The haloed 10x18 dz tile is formed once
//     in shared memory from the DzSrc (read in fp32, rounded once) as
//     [pixel][s] rows of odd 16-byte pitch, and each tap reads it as a
//     shifted ldmatrix row. All TAPS weight slices of the chunk sit in
//     shared memory (at most 9 x 64 x 64), loaded by cp.async beside the dz
//     tile, slot t' holding forward tap TAPS-1-t' (the flip). K is co and N
//     is ci here, so the two layouts trade their ldmatrix mode against the
//     forward (wlayout.cuh KN): HWIO [t][ci][co] is [n][k] rows, 8 dz
//     channels a vector, read plainly; by-target [co][t*cin..] is [k][n]
//     rows, 8 input channels of one source a vector, read with .trans. Each
//     tap's product sums from zero and joins the total by an fp32 add, in a
//     fixed order (chained mma.sync accumulation drifts: dense_conv.cuh).
//   * "fma" (fp32, whose 1e-4 bar TF32 would miss): dgrad_kernel on the CUDA
//     cores: a 256-thread block owns an 8x16 pixel tile and CO of the conv's
//     input channels, stages 16 dz channels of the haloed tile (rounded to
//     T) and the matching weights in shared memory, and keeps a 4-pixel x
//     CO/8-channel register tile. It also runs bf16 when asked for by name:
//     the accuracy baseline chip_smoke.py measures the tensor cores against.
// Both end in the same epilogue (epilogue() below) on the fp32 sum: + the
// buffer's earlier content, or + that and the skip's cotangent rounded once
// to T; the mma kernel applies it to pairs of channels, 8-byte loads and
// stores.
#pragma once

#include "dz_src.cuh"
#include "mma_tile.cuh"
#include "wlayout.cuh"

namespace esr {
namespace dgrad {

enum Design : int { kFma = 0, kMma = 1 };  // kernels/launch.py DESIGNS

constexpr int TH = 8;
constexpr int TW = 16;
constexpr int NT = 256;
constexpr int NCG = 8;
constexpr int NPG = NT / NCG;
constexpr int PPT = TH * TW / NPG;
constexpr int KC = 16;  // dz channels staged per step

// The epilogue of dx channel c of pixel (b, gy, gx), shared by both designs:
// its fp32 sum v, + out32's earlier content `prev` when `accumulate`, and
// when the result is rounded into outT (`to_t`) + the cotangent `addg` when
// given. The caller stores the value to out32, or rounds it once into outT.
template <typename T>
__device__ __forceinline__ float epilogue(float v, float prev, bool accumulate, bool to_t,
                                          const DzSrc& addg, int add_g, int b, int gy, int gx,
                                          int c) {
  if (accumulate) v += prev;
  if (to_t && add_g) v += dz_load<T>(addg, b, gy, gx, c);
  return v;
}

// ---------------------------------------------------------------------------
// "fma": fp32 on the CUDA cores
// ---------------------------------------------------------------------------

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
      const bool add = out32 && accumulate;
      const float v = epilogue<T>(acc[i][j], add ? out32[pix * o32_stride + c] : 0.f, add,
                                  outT != nullptr, addg, add_g, b, gy, gx, c);
      if (outT) outT[pix * oT_stride + c] = from_f<T>(v);
      else out32[pix * o32_stride + c] = v;
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

// ---------------------------------------------------------------------------
// "mma": bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using esr::mma::cp_async16;
using esr::mma::ldsm_pitch;
using esr::mma::smem_u32;
using esr::tile::bf16;
using esr::tile::HP;  // the haloed 10x18 tile of the 8x16 pixel tile (csrc/mma_tile.cuh)
using esr::tile::HW;
using esr::tile::pack8;
using esr::tile::round16;
using esr::tile::Tiling;
using esr::tile::warp_mma;

constexpr int NW = 8;             // warps a block: two m16 tiles and NP/2 columns a warp
constexpr int FETCH = 3;          // dz groups of 8 channels a thread has in flight at once
constexpr int MAX_S = 64;         // dz channels a block takes (K of a tap)
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may opt into on sm_90

// N of a block, the conv input channels it owns: 64 from 97 channels up, else
// 32 from 17 (two or three blocks a pixel tile, where one block a tile
// leaves the card half empty: 128 tiles at the training shape), else 8 or 16.
__host__ __device__ constexpr int dgrad_np(int cin) {
  return cin > 96 ? 64 : cin > 16 ? 32 : cin > 8 ? 16 : 8;
}

// Bytes of one tap's weight slot of sp K rows (dz channels) by np conv input
// channels: [n][k] rows (nk: HWIO) or [k][n] rows (by-target).
__host__ __device__ constexpr int dgrad_slot(int np, int sp, bool nk) {
  return nk ? np * ldsm_pitch(sp) : sp * ldsm_pitch(np);
}

// A block's dynamic shared memory: the haloed dz tile and every tap's slot.
__host__ __device__ constexpr int dgrad_smem(int np, int sp, int taps, bool nk) {
  return HP * ldsm_pitch(sp) + taps * dgrad_slot(np, sp, nk);
}
static_assert(dgrad_smem(64, MAX_S, 9, true) <= MAX_SMEM &&
                  dgrad_smem(64, MAX_S, 9, false) <= MAX_SMEM,
              "the widest block fits");

template <int NP, int TAPS, typename L>
__global__ void __launch_bounds__(Tiling<NP, NW>::NTH, Tiling<NP, NW>::MIN_BLOCKS)
    dgrad_mma_kernel(DzSrc dz, int s,                            // dz has s <= MAX_S channels
                     const bf16* __restrict__ w, L wl, int cin,  // TAPS x cin x s in layout L
                     float* __restrict__ out32, int o32_stride, int accumulate,
                     bf16* __restrict__ outT, int oT_stride, DzSrc addg, int add_g, int nchunk) {
  using Tl = Tiling<NP, NW>;
  constexpr bool NK = L::KN;  // the adjoint swaps K and N: HWIO rows are [n][k], read plainly
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = round16(s), zp = ldsm_pitch(sp);
  const int wpitch = NK ? ldsm_pitch(sp) : ldsm_pitch(NP);
  const int slot = dgrad_slot(NP, sp, NK);
  const uint32_t zs = smem_u32(smem), ws = zs + HP * zp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Tl::WN, wn = warp % Tl::WN;
  const int b = blockIdx.z / nchunk, n0 = (blockIdx.z % nchunk) * NP;
  const int y0 = blockIdx.y * esr::tile::TH, x0 = blockIdx.x * esr::tile::TW;
  const int H = dz.H, W = dz.W;

  // every tap's weights for input channels n0 .. n0+NP, slot t' holding
  // forward tap TAPS-1-t' (the flip), zero past s and cin
  for (int t = 0; t < TAPS; ++t) {
    const uint32_t dst = ws + t * slot;
    const int tf = TAPS - 1 - t;
    if constexpr (NK) {  // [n = ci][k = co] rows, 8 dz channels a vector
      const int nc = sp / 8;
      for (int i = tid; i < NP * nc; i += Tl::NTH) {
        const int n = i / nc, k8 = i % nc, ci = n0 + n, co = k8 * 8;
        const bool ok = ci < cin && co < s;
        cp_async16(dst + n * wpitch + k8 * 16, ok ? w + wl(TAPS, tf, ci, co, cin, s) : w, ok);
      }
    } else {  // [k = co][n = ci] rows, 8 input channels of one source a vector
      constexpr int NC = NP / 8;
      for (int i = tid; i < sp * NC; i += Tl::NTH) {
        const int k = i / NC, n8 = i % NC, ci = n0 + n8 * 8;
        const bool ok = k < s && ci < cin;
        cp_async16(dst + k * wpitch + n8 * 16, ok ? w + wl(TAPS, tf, ci, k, cin, s) : w, ok);
      }
    }
  }
  esr::mma::cp_async_commit();

  // the haloed dz tile beside them: read in fp32, rounded once, zero outside
  // the image and past s (the 1x1 reads the centre pixels only); a thread
  // fetches FETCH groups of 8 channels before it finishes any
  const int nc = sp / 8, items = HP * nc;
  for (int i0 = tid; i0 < items; i0 += FETCH * Tl::NTH) {
    Dz8 raw[FETCH];
    bool live[FETCH];
#pragma unroll
    for (int r = 0; r < FETCH; ++r) {
      const int i = i0 + r * Tl::NTH, p = i / nc, c8 = i % nc;
      const int gy = y0 - 1 + p / HW, gx = x0 - 1 + p % HW;
      live[r] = i < items && gy >= 0 && gy < H && gx >= 0 && gx < W && c8 * 8 < s;
      if (live[r]) dz_fetch8(dz, b, gy, gx, c8 * 8, raw[r]);
    }
#pragma unroll
    for (int r = 0; r < FETCH; ++r) {
      const int i = i0 + r * Tl::NTH, p = i / nc, c8 = i % nc, ty = p / HW, tx = p % HW;
      if (i >= items) break;
      if (TAPS == 1 && (ty == 0 || ty == esr::tile::TH + 1 || tx == 0 || tx == HW - 1)) continue;
      float d[8] = {};
      if (live[r]) dz_finish8(dz, raw[r], d);
      *reinterpret_cast<uint4*>(smem + p * zp + c8 * 16) = pack8(d);
    }
  }
  esr::mma::cp_async_wait<0>();
  __syncthreads();

  float acc[Tl::MT][Tl::NT8][4];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  uint32_t arow[Tl::MT];  // tile row = block row (+ dy), column lane & 15 (+ dx)
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
    arow[i] = zs + ((wm * Tl::MT + i) * HW + (lane & 15)) * zp + (lane >> 4) * 16;
  // slot t' = 3*dy + dx: block pixel (u, v) reads tile pixel (u + dy, v + dx),
  // dz pixel (y + dy - 1, x + dx - 1) = p - off(forward tap 8 - t')
#pragma unroll 1
  for (int t = 0; t < TAPS; ++t) {
    const int shift = TAPS == 9 ? (t / 3) * HW + t % 3 : HW + 1;
    uint32_t a[Tl::MT];
#pragma unroll
    for (int i = 0; i < Tl::MT; ++i) a[i] = arow[i] + shift * zp;
    float part[Tl::MT][Tl::NT8][4] = {};  // the tap's own sum
    warp_mma<Tl::MT, Tl::NT8, !NK>(part, a, ws + t * slot, wpitch, wn * Tl::NT8 * 8, sp, lane);
#pragma unroll
    for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
      for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = __fadd_rn(acc[i][j][r], part[i][j][r]);
  }

  // the epilogue on pairs of channels (cin % 8 == 0: c < cin means c + 1 <
  // cin too): every pair of the buffer's earlier content loaded before any
  // is used, then the shared epilogue, one 8-byte or 4-byte store
  const bool add = out32 && accumulate;
  float2 prev[Tl::MT][Tl::NT8][2];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gy = y0 + wm * Tl::MT + i, gx = x0 + (lane >> 2) + 8 * h;
        const int c = n0 + (wn * Tl::NT8 + j) * 8 + (lane & 3) * 2;
        prev[i][j][h] = make_float2(0.f, 0.f);
        if (add && gy < H && gx < W && c < cin)
          prev[i][j][h] = *reinterpret_cast<const float2*>(
              out32 + (((size_t)b * H + gy) * W + gx) * o32_stride + c);
      }
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gy = y0 + wm * Tl::MT + i, gx = x0 + (lane >> 2) + 8 * h;
        const int c = n0 + (wn * Tl::NT8 + j) * 8 + (lane & 3) * 2;
        if (gy >= H || gx >= W || c >= cin) continue;
        const size_t pix = ((size_t)b * H + gy) * W + gx;
        const bool to_t = outT != nullptr;
        const float v0 = epilogue<bf16>(acc[i][j][2 * h], prev[i][j][h].x, add, to_t, addg, add_g,
                                        b, gy, gx, c);
        const float v1 = epilogue<bf16>(acc[i][j][2 * h + 1], prev[i][j][h].y, add, to_t, addg,
                                        add_g, b, gy, gx, c + 1);
        if (to_t) {
          *reinterpret_cast<uint32_t*>(outT + pix * oT_stride + c) = esr::mma::pack_bf16(v0, v1);
        } else {
          *reinterpret_cast<float2*>(out32 + pix * o32_stride + c) = make_float2(v0, v1);
        }
      }
}

template <int NP, int TAPS, typename L>
int launch(const DgradArgs& a, L wl, cudaStream_t stream) {
  const int nchunk = (a.cin + NP - 1) / NP;
  const size_t smem = dgrad_smem(NP, round16(a.s), TAPS, L::KN);
  auto kern = dgrad_mma_kernel<NP, TAPS, L>;
  if (int e = esr::tile::smem_opt_in(kern, smem)) return e;
  const dim3 grid((a.dz.W + esr::tile::TW - 1) / esr::tile::TW,
                  (a.dz.H + esr::tile::TH - 1) / esr::tile::TH, a.B * nchunk);
  kern<<<grid, NW * 32, smem, stream>>>(a.dz, a.s, static_cast<const bf16*>(a.w), wl, a.cin,
                                        a.out32, a.o32_stride, a.accumulate,
                                        static_cast<bf16*>(a.outT), a.oT_stride, a.addg, a.add_g,
                                        nchunk);
  return (int)cudaGetLastError();
}

template <int NP, typename L>
int dispatch_taps(int taps, const DgradArgs& a, L wl, cudaStream_t s) {
  if (taps == 9) return launch<NP, 9>(a, wl, s);
  if (taps == 1) return launch<NP, 1>(a, wl, s);
  return (int)cudaErrorInvalidValue;
}

// Widths a multiple of 8 (16-byte vectors), s at most MAX_S; dz not the
// upconv's phase view (kDzPhase: the bf16 upconv adjoint has its own kernels).
template <typename L>
int dispatch(int taps, const DgradArgs& a, L wl, cudaStream_t s) {
  if (a.s < 1 || a.s > MAX_S || a.s % 8 || a.cin < 1 || a.cin % 8 || a.dz.mode == kDzPhase)
    return (int)cudaErrorInvalidValue;
  switch (dgrad_np(a.cin)) {
    case 8: return dispatch_taps<8>(taps, a, wl, s);
    case 16: return dispatch_taps<16>(taps, a, wl, s);
    case 32: return dispatch_taps<32>(taps, a, wl, s);
    case 64: return dispatch_taps<64>(taps, a, wl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

// dx (+)= conv^T(dz, w) for the conv's input channels [0, cin), with the
// weights in layout L. With `outT` the result (plus out32's earlier content
// when `accumulate`, plus `addg` when given) is rounded to T; else it is
// stored or accumulated in out32. `design`: kMma (bf16 only; the block's
// channels by tc::dgrad_np) or kFma (`chunk` of them per block); fp32 on the
// tensor cores is refused. Returns cudaGetLastError().
template <typename L>
int run(int dtype, int design, int chunk, int taps, const DzSrc* dz, int s, const void* w, L wl,
        int cin, float* out32, int o32_stride, int accumulate, void* outT, int oT_stride,
        const DzSrc* addg, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DgradArgs a{*dz, addg ? *addg : *dz, w, out32, outT, s, cin, o32_stride, accumulate,
              oT_stride, addg ? 1 : 0, B};
  if (!out32 && !outT) return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16 && design == kMma) return tc::dispatch(taps, a, wl, st);
  if (design != kFma) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) return dispatch_co<float>(chunk, taps, a, wl, st);
  if (dtype == kBFloat16) return dispatch_co<__nv_bfloat16>(chunk, taps, a, wl, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace dgrad
}  // namespace esr
