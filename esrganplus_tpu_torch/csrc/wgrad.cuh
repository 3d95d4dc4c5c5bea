// Weight and bias gradient of a SAME 3x3 (or 1x1) convolution (NHWC, sm_90a),
// written in either weight layout of wlayout.cuh.
//
// The dW/db half of four TPU adjoints: esrganplus_tpu/kernels/rdb_ct.py
// _rdb_ct_bwd_kernel (dw(dY_k, k) and dbv) and _conv3x3_ct_bwd_kernel,
// esrganplus_tpu/kernels/rdb_t.py _rdb_t_bwd_kernel (by-target dW, through
// csrc/rdb_t.cu), and through kernels/tail_ct.py the fp32 _upfold_bwd_kernel
// and _conv_hr_bwd_kernel.
//
//   dW[dy, dx, ci, co] = sum_p x[p + (dy-1, dx-1), ci] * round_T(dz[p, co])
//   db[co]             = sum_p dz[p, co]                      (unrounded, fp32)
//
// a reduction over all B*H*W pixels into a small block, where the TPU kernel
// accumulates across its sequential grid. Here blocks run in no order, and
// fp32 atomics would make training differ from run to run, so the reduction
// is split deterministically: block (rows, part) walks a fixed range of
// pixel tiles and writes its partial sums to row `part` of a workspace,
// already in the layout the caller asked for (HWIO, or rdb_t's by-target
// [S, 9*C_prefix]); wgrad_finish_kernel then adds the rows in order. The
// split depends on the shapes only. The conv's input is split as the dense
// stages keep it: channels [0, c0) from x, the rest from the concat buffer.
//
// Bound on this card: operations (the forward's MACs again). Two designs,
// picked by the wrapper by dtype (kernels/launch.py design); the C entries
// take the design and refuse fp32 on the tensor cores:
//   * "mma" (bf16): wgrad_mma_kernel, the design of csrc/stage_ct.cu's
//     stage_wgrad_mma_kernel: an implicit GEMM on mma.sync m16n8k16 with M =
//     (16-channel ci chunk, tap) rows, N = s (16, 32 or 64; 8 padded to 16), K
//     = pixels. A block owns MT m16 tiles (12 of the nine taps, spanning at
//     most two chunks; 4 chunks of the 1x1) and walks its 4x16 pixel tiles
//     through a double-buffered cp.async pipeline over x | cat; dz is formed
//     in shared memory from the DzSrc, its unrounded fp32 value added to the
//     block's db partial, then rounded once. A = x^T and B = dz both reach
//     the tensor cores by ldmatrix.trans of [pixel][channel] rows.
//   * "fma" (fp32, whose 1e-4 bar TF32 would miss): wgrad_kernel on the CUDA
//     cores: a thread owns one input channel and S/16 output channels for all
//     nine taps (9*S/16 accumulators) and slides a 3x3 register window along
//     each tile row, so a pixel costs 3 + S/16 shared-memory loads for 9*S/16
//     FMAs. It also runs bf16 when asked for by name, the accuracy baseline.
#pragma once

#include "dz_src.cuh"
#include "mma_tile.cuh"
#include "wlayout.cuh"

namespace esr {
namespace wgrad {

enum Design : int { kFma = 0, kMma = 1 };  // kernels/launch.py DESIGNS

constexpr int TH = 8;
constexpr int TW = 16;
constexpr int NT = 256;

// ---------------------------------------------------------------------------
// "fma": fp32 on the CUDA cores
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// "mma": bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using esr::mma::cp_async16;
using esr::mma::ldsm_pitch;
using esr::mma::smem_u32;
using esr::tile::bf16;
using esr::tile::pack8;
using esr::tile::round16;

constexpr int WG_TH = 4;                 // pixel tile: 4x16 = 64 pixels of K a step
constexpr int WG_PIX = WG_TH * TW;
constexpr int XH = WG_TH + 2, XW = TW + 2;  // its haloed input tile

// A block's m16 tiles of (16-channel ci chunk, tap) rows and the input
// channels it stages: at TAPS = 9, 12 tiles from m0 % 9 = 0, 3 or 6 span at
// most two chunks; at TAPS = 1, 4 chunks. kernels/launch.py WG_MT mirrors MT.
template <int TAPS>
struct Wg {
  static constexpr int MT = TAPS == 9 ? 12 : 4;
  static constexpr int XC = TAPS == 9 ? 32 : 64;
};

// A block's dynamic shared memory: two buffers of the haloed input tile and
// the dz tile of nch (16, 32 or 64) channels.
__host__ __device__ constexpr int wgrad_smem(int taps, int nch) {
  return 2 * (XH * XW * ldsm_pitch(taps == 9 ? 32 : 64) + WG_PIX * ldsm_pitch(nch));
}

template <int NCH, int TAPS, typename L>
__global__ void __launch_bounds__(NT, 2) wgrad_mma_kernel(
    const bf16* __restrict__ x, int c0,      // [B,H,W,c0]: input channels [0, c0)
    const bf16* __restrict__ cat, int ccat,  // [B,H,W,ccat]: input channels [c0, cin)
    int cin, DzSrc dz, int s,                // dz has s <= NCH channels
    float* __restrict__ part, L wl,          // [npart][TAPS*cin*s + s], dW in layout L
    int tiles_per_part, int total_tiles, int tiles_x, int tiles_y) {
  using G = Wg<TAPS>;
  constexpr int WN = 2, MT = G::MT / 4, NT8 = NCH / 16;  // 4 x 2 warps of MT m16 x NCH/2
  constexpr int XP = ldsm_pitch(G::XC), GP = ldsm_pitch(NCH);
  constexpr int XBYTES = XH * XW * XP, BUF = XBYTES + WG_PIX * GP;  // x | cat, then dz
  constexpr int NC = NCH / 8;  // dz chunks of 8 channels per pixel
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int H = dz.H, W = dz.W;
  const int mtiles = TAPS * round16(cin) / 16;  // m16 tile m = (ci chunk m / TAPS, tap m % TAPS)
  const int m0 = blockIdx.x * G::MT;
  const int cx0 = m0 / TAPS * 16;  // the first of the XC channels it stages
  const size_t row = (size_t)TAPS * cin * s + s;
  float* dst = part + (size_t)blockIdx.y * row;

  const int tbeg = blockIdx.y * tiles_per_part;
  const int ntile = min(total_tiles, tbeg + tiles_per_part) - tbeg;
  auto origin = [&](int it, int& b, int& y0, int& x0) {
    const int tile = tbeg + it;
    b = tile / (tiles_x * tiles_y);
    y0 = (tile / tiles_x) % tiles_y * WG_TH, x0 = tile % tiles_x * TW;
  };
  // the haloed input tile of tile `it`: x's channels below c0, the concat
  // buffer's from c0, zero past cin and outside the image (cp.async)
  auto load_x = [&](int it) {
    int b, y0, x0;
    origin(it, b, y0, x0);
    const uint32_t xs = smem_u32(smem + (it & 1) * BUF);
    constexpr int nc = G::XC / 8;
    for (int i = tid; i < XH * XW * nc; i += NT) {
      const int p = i / nc, c8 = i % nc;
      const int gy = y0 - 1 + p / XW, gx = x0 - 1 + p % XW, ch = cx0 + c8 * 8;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < cin;
      const size_t pix = ((size_t)b * H + gy) * W + gx;
      cp_async16(xs + p * XP + c8 * 16,
                 !ok ? x : ch < c0 ? x + pix * c0 + ch : cat + pix * ccat + (ch - c0), ok);
    }
  };
  float db[8];  // channels (tid % NC) * 8 .. + 8: the chunk this thread always forms
#pragma unroll
  for (int k = 0; k < 8; ++k) db[k] = 0.f;
  // dz of tile `it`'s pixels into [pixel][NCH] rows: read in fp32, added
  // unrounded to db, rounded once; zero outside the image and past s. A
  // thread's groups of 8 channels (two at NCH = 64) are fetched first.
  auto form_dz = [&](int it) {
    constexpr int PER = (WG_PIX * NC + NT - 1) / NT;
    int b, y0, x0;
    origin(it, b, y0, x0);
    unsigned char* gz = smem + (it & 1) * BUF + XBYTES;
    Dz8 raw[PER];
    bool live[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = tid + r * NT, p = i / NC, c8 = i % NC, y = y0 + p / TW, xx = x0 + p % TW;
      live[r] = i < WG_PIX * NC && y < H && xx < W && c8 * 8 < s;
      if (live[r]) dz_fetch8(dz, b, y, xx, c8 * 8, raw[r]);
    }
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = tid + r * NT, p = i / NC, c8 = i % NC;
      if (i >= WG_PIX * NC) break;
      float d[8] = {};
      if (live[r]) dz_finish8(dz, raw[r], d);
#pragma unroll
      for (int k = 0; k < 8; ++k) db[k] += d[k];
      *reinterpret_cast<uint4*>(gz + p * GP + c8 * 16) = pack8(d);
    }
  };

  float acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  if (ntile > 0) {
    load_x(0);
    esr::mma::cp_async_commit();
    form_dz(0);
  }
  for (int it = 0; it < ntile; ++it) {
    if (it + 1 < ntile) load_x(it + 1);  // into the other buffer, freed at the end of it - 1
    esr::mma::cp_async_commit();
    if (it + 1 < ntile) form_dz(it + 1);
    esr::mma::cp_async_wait<1>();  // tile it's input has landed
    __syncthreads();               // ... and its dz is formed, for every thread
    const uint32_t xs = smem_u32(smem + (it & 1) * BUF), zs = xs + XBYTES;
#pragma unroll
    for (int kk = 0; kk < WG_TH; ++kk) {  // one tile row of 16 pixels per k16 step
      uint32_t bf[NT8][2];
      if constexpr (NT8 == 1) {
        esr::mma::ldsm_x2_t(bf[0], zs + (kk * 16 + (lane & 15)) * GP + wn * 16);
      } else {
#pragma unroll
        for (int j = 0; j < NT8; j += 2) {
          uint32_t r[4];
          esr::mma::ldsm_x4_t(r, zs + (kk * 16 + (lane & 15)) * GP +
                                     (wn * NT8 * 8 + j * 8 + (lane >> 4) * 8) * 2);
          bf[j][0] = r[0], bf[j][1] = r[1], bf[j + 1][0] = r[2], bf[j + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = m0 + wm * MT + i;
        if (m >= mtiles) continue;  // warp-uniform
        const int t = m % TAPS, cl = m / TAPS * 16 - cx0;
        // A = x^T: [k = pixel][m = ci] rows read with .trans; pixel (kk, px)
        // at tap t reads input tile pixel (kk + dy, px + dx) (the 1x1: + 1, + 1)
        const int px = (lane & 7) + (lane >> 4) * 8;
        const int r = TAPS == 9 ? (kk + t / 3) * XW + px + t % 3 : (kk + 1) * XW + px + 1;
        uint32_t af[4];
        esr::mma::ldsm_x4_t(af, xs + r * XP + (cl + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
        for (int j = 0; j < NT8; ++j) esr::mma::mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  esr::mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = m0 + wm * MT + i;
    if (m >= mtiles) continue;
    const int t = m % TAPS;
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      const int n = (wn * NT8 + j) * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = m / TAPS * 16 + (lane >> 2) + 8 * h;
        if (ci >= cin || n >= s) continue;  // s % 8 == 0: n + 1 < s too
        if constexpr (L::KN) {  // HWIO: the two output channels are neighbours
          *reinterpret_cast<float2*>(dst + wl(TAPS, t, ci, n, cin, s)) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          dst[wl(TAPS, t, ci, n, cin, s)] = acc[i][j][2 * h];
          dst[wl(TAPS, t, ci, n + 1, cin, s)] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
  if (m0 == 0) {  // db: the threads' partials in a fixed order
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int k = 0; k < 8; ++k) red[tid * 8 + k] = db[k];
    __syncthreads();
    for (int c = tid; c < s; c += NT) {
      float v = 0.f;
      for (int r = c / 8; r < NT; r += NC) v += red[r * 8 + c % 8];
      dst[(size_t)TAPS * cin * s + c] = v;
    }
  }
}

template <int NCH, int TAPS, typename L>
int launch(const WgradArgs& a, L wl, cudaStream_t stream) {
  const size_t smem = wgrad_smem(TAPS, NCH);
  auto kern = wgrad_mma_kernel<NCH, TAPS, L>;
  if (int e = esr::tile::smem_opt_in(kern, smem)) return e;
  const int tiles_x = (a.dz.W + TW - 1) / TW, tiles_y = (a.dz.H + WG_TH - 1) / WG_TH;
  const int total = a.B * tiles_x * tiles_y;
  const int per = (total + a.npart - 1) / a.npart;
  const int mtiles = TAPS * round16(a.cin) / 16;
  const dim3 grid((mtiles + Wg<TAPS>::MT - 1) / Wg<TAPS>::MT, a.npart);
  kern<<<grid, NT, smem, stream>>>(static_cast<const bf16*>(a.x), a.c0,
                                   static_cast<const bf16*>(a.cat), a.ccat, a.cin, a.dz, a.s,
                                   a.part, wl, per, total, tiles_x, tiles_y);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int row = TAPS * a.cin * a.s + a.s;
  wgrad_finish_kernel<<<(row + 255) / 256, 256, 0, stream>>>(a.part, a.npart, row, a.out);
  return (int)cudaGetLastError();
}

template <int NCH, typename L>
int dispatch_taps(int taps, const WgradArgs& a, L wl, cudaStream_t s) {
  if (taps == 9) return launch<NCH, 9>(a, wl, s);
  if (taps == 1) return launch<NCH, 1>(a, wl, s);
  return (int)cudaErrorInvalidValue;
}

// N of a block: s padded to 16, 32 or 64. Widths a multiple of 8 (16-byte
// vectors in every source); dz not the upconv's phase view (kDzPhase).
template <typename L>
int dispatch(int taps, const WgradArgs& a, L wl, cudaStream_t st) {
  if (a.cin < 1 || a.cin % 8 || a.c0 % 8 || a.ccat % 8 || a.s % 8 || a.dz.mode == kDzPhase)
    return (int)cudaErrorInvalidValue;
  if (a.s <= 16) return dispatch_taps<16>(taps, a, wl, st);
  if (a.s <= 32) return dispatch_taps<32>(taps, a, wl, st);
  if (a.s <= 64) return dispatch_taps<64>(taps, a, wl, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// out[0 : taps*cin*s] = dW in layout L, out[taps*cin*s :] = db. `part` is an
// fp32 workspace of npart * (taps*cin*s + s) floats; part p sums the pixel
// tiles [p * per, (p + 1) * per), per = ceil(tiles / npart), of 8x16 pixels
// (kFma) or 4x16 (kMma; kernels/launch.py wgrad_ranges). `design`: kMma (bf16
// only) or kFma; fp32 on the tensor cores is refused. Returns
// cudaGetLastError().
template <typename L>
int run(int dtype, int design, int taps, const void* x, int c0, const void* cat, int ccat,
        int cin, const DzSrc* dz, int s, L wl, float* part, int npart, float* out, int B,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (npart < 1 || s < 1) return (int)cudaErrorInvalidValue;
  const WgradArgs a{x, cat, *dz, part, out, c0, ccat, cin, s, B, npart};
  if (dtype == kBFloat16 && design == kMma) return tc::dispatch(taps, a, wl, st);
  if (design != kFma) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) return dispatch_s<float>(taps, a, wl, st);
  if (dtype == kBFloat16) return dispatch_s<__nv_bfloat16>(taps, a, wl, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace wgrad
}  // namespace esr
