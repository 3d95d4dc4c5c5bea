// Upsample tail of RRDBNet (NHWC, sm_90a): upfold and conv_hr.
//
// Replaces four TPU kernels of esrganplus_tpu/kernels/tail_ct.py:
//   * upfold_ct  (_upfold_kernel): nearest-x2 upsample + 3x3 conv + bias +
//     leaky-relu in one pass. Nearest-up duplicates pixels, so for output
//     phase (a, b) = (Y mod 2, X mod 2) the nine HR taps collapse onto a 2x2
//     grid of distinct LR taps at row offsets {a-1, a} and column offsets
//     {b-1, b}; the host folds the weights accordingly (prepare_upfold_ct), so
//     the kernel does 4*C MACs per output channel instead of 9*C, and the
//     upsampled intermediate never exists in device memory. Zero padding at
//     LR resolution is exactly the HR zero padding after the fold. fp32:
//     upfold_kernel; bf16: upfold_mma_kernel (namespace tc), the phase fold
//     of csrc/phase_fold.cuh.
//   * conv_hr_ct (_conv_hr_kernel): hr_conv0 (3x3 C->C + leaky-relu) then
//     hr_conv1 (3x3 C->CO2). conv1's SAME padding pads conv0's *output*
//     (tail_ct.py:413-421), and conv0's activation is rounded to T as the TPU
//     kernel rounds it. fp32 (conv_hr_kernel): conv0 over the (TH+2)x(TW+2)
//     haloed tile into shared memory, zero outside the image, so the
//     C-channel HR intermediate never leaves the block. bf16: the
//     tensor-core design below (namespace tc).
//   * _make_upfold_ct_diff (_upfold_bwd_kernel): the upconv's adjoint, bf16
//     on the tensor cores (namespace tc); fp32 runs csrc/dgrad_ct.cu and
//     csrc/wgrad_ct.cu (kernels/tail_ct.py upfold_ct_bwd).
//   * _make_conv_hr_ct_diff (_conv_hr_bwd_kernel): two launches of its bf16
//     design, conv_hr_hid_fix_kernel and conv_hr_adj_kernel below;
//     kernels/tail_ct.py conv_hr_ct_bwd runs them between the stage
//     tensor-core kernels of stage_ct.cu.
//
// Bound on this card in bf16: bytes for upfold (4*C*CO MACs per HR pixel
// against a C-channel LR read shared by four HR pixels and a CO-channel HR
// write: ~205 FLOP a byte at 64 wide, below the tensor cores' ~295) and for
// its adjoint; operations for conv_hr (9*C*(C+CO2) MACs per HR pixel against
// C channels read and CO2 written). The FMA kernels (fp32) accumulate on the
// CUDA cores in fp32, with the same register tiling as rdb_ct.cu (4-6 pixels
// x C/8 channels per thread) over shared-memory tiles; the 2x2 fold cuts
// upfold's work 2.25x.
#include <algorithm>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "mma_tile.cuh"
#include "phase_fold.cuh"
#include "wgrad.cuh"

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
// upfold, fp32: one block = one output phase (a, b) of an 8x16 LR tile, all CO.
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

// ---------------------------------------------------------------------------
// conv_hr's adjoint, bf16 design. kernels/tail_ct.py conv_hr_ct_bwd recomputes
// hid = bf16(lrelu(conv0(x) + b0)) with the stage forward (its entries near 0
// then rewritten by conv_hr_hid_fix_kernel, below), runs this kernel, then
// conv0's adjoint (dW0 and dx) on the stage tensor-core kernels. One
// pass over hid and conv1's output cotangent g forms
//   dz0[p, c] = lrelu'(hid[p, c]) * sum_{t, co} g[p + 1 - d(t), co] * w1[t, c, co]
// in fp32, adds it unrounded to db0, stores it rounded once, and sums
//   dW1[t, c, co] = sum_p hid[p + d(t) - 1, c] * g[p, co],   db1[co] = sum_p g[p, co].
// K = 9 * CO2 (27) for dz0 and N = CO2 (3) for dW1 are too narrow for mma.sync:
// both run on the CUDA cores in fp32 (~0.9 GFLOP each at the flagship shape),
// and the bound is bytes (hid read, dz0 written: 33.5 MB each). A thread
// forms 8 channels of dz0 for NZ pixels (w1 as float4 from shared memory, g
// broadcast), and one channel's 9 x CO2 dW1 sums over a run of pixels with a
// sliding 3x3 register window. Block `part` walks a fixed range of 8x16 pixel
// tiles (hid haloed by cp.async, double-buffered; g prefetched into
// registers, staged as fp32) and writes its dW1 | db1 | db0 sums to row
// `part` of a workspace; wgrad_finish_kernel adds the rows in order, so the
// reduction order is a function of the shapes (kernels/tail_ct.py
// conv_hr_adj_ranges mirrors the partition).
// ---------------------------------------------------------------------------

namespace adj {

using bf16 = __nv_bfloat16;
constexpr int HW = TW + 2;          // haloed tile width
constexpr int HPX = (TH + 2) * HW;  // haloed tile pixels (180)
constexpr int PIX = TH * TW;

template <int C, int CO2P>
struct Plan {
  static constexpr int NG = C / 8;                    // 8-channel groups of a pixel (dz0)
  static constexpr int ZSTEP = NT / NG;               // pixel stride of a thread's dz0 pixels
  static constexpr int NZ = (PIX + ZSTEP - 1) / ZSTEP;
  static constexpr int Q = NT / C;                    // threads of a channel (dW1)
  static constexpr int SEG = PIX / Q;                 // pixels each of them walks
  static constexpr int L = SEG < TW ? SEG : TW;       // a run along one tile row
  static constexpr int NSEG = SEG / L;
  static constexpr int HBYTES = HPX * C * 2;          // one hid buffer
  static constexpr int GFL = HPX * CO2P;              // one g buffer, floats
  static constexpr int GPT = (GFL + NT - 1) / NT;     // g values a thread prefetches
  static constexpr size_t SMEM_MAIN = 2 * (size_t)HBYTES + 4 * (2 * (size_t)GFL + 9 * CO2P * C);
  static constexpr size_t SMEM_RED = 4 * (size_t)9 * NT;  // dW1's [Q][9][C] (db0's [NT][8] is less)
  static constexpr size_t SMEM = SMEM_MAIN > SMEM_RED ? SMEM_MAIN : SMEM_RED;
};

// two blocks an SM (128 registers) for up to 3 output channels; 8 would spill there
template <int C, int CO2P>
__global__ void __launch_bounds__(NT, CO2P > 3 ? 1 : 2) conv_hr_adj_kernel(
    const bf16* __restrict__ g,    // [B, H, W, co2]: conv1's output cotangent
    const bf16* __restrict__ w1,   // [3, 3, C, co2]
    const bf16* __restrict__ hid,  // [B, H, W, C]: conv0's activation, rounded
    bf16* __restrict__ dz0,        // [B, H, W, C]
    float* __restrict__ part,      // [npart][9*C*co2 + co2 + C]: dW1 | db1 | db0
    int co2, int H, int W, float slope, int tiles_per_part, int total_tiles, int tiles_x,
    int tiles_y) {
  using Pl = Plan<C, CO2P>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem + 2 * Pl::HBYTES);  // [2][HPX][CO2P]
  float* w1s = gs + 2 * Pl::GFL;                                 // [9][CO2P][C]
  const int tid = threadIdx.x;
  const int c = tid % C, q = tid / C;              // dW1: channel, pixel run
  const int cg = tid % Pl::NG, zp = tid / Pl::NG;  // dz0: channel group, first pixel
  const int tbeg = blockIdx.x * tiles_per_part;
  const int ntile = min(total_tiles, tbeg + tiles_per_part) - tbeg;
  float* dst = part + (size_t)blockIdx.x * (9 * C * co2 + co2 + C);

  for (int i = tid; i < 9 * CO2P * C; i += NT) {
    const int cc = i % C, co = i / C % CO2P, t = i / (C * CO2P);
    w1s[i] = co < co2 ? __bfloat162float(w1[((size_t)t * C + cc) * co2 + co]) : 0.f;
  }
  auto origin = [&](int it, int& b, int& y0, int& x0) {
    const int tile = tbeg + it;
    b = tile / (tiles_x * tiles_y);
    y0 = tile / tiles_x % tiles_y * TH;
    x0 = tile % tiles_x * TW;
  };
  // the haloed hid tile, zero outside the image (conv1's SAME padding)
  auto load_hid = [&](int it) {
    int b, y0, x0;
    origin(it, b, y0, x0);
    const uint32_t d = esr::mma::smem_u32(smem + (it & 1) * Pl::HBYTES);
    constexpr int NC = C / 8;
    for (int i = tid; i < HPX * NC; i += NT) {
      const int p = i / NC, c8 = i % NC, gy = y0 - 1 + p / HW, gx = x0 - 1 + p % HW;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      esr::mma::cp_async16(d + p * C * 2 + c8 * 16,
                           ok ? hid + (((size_t)b * H + gy) * W + gx) * C + c8 * 8 : hid, ok);
    }
  };
  float gr[Pl::GPT];  // element tid + k * NT of the next haloed g tile, [pixel][CO2P]
  auto load_g = [&](int it) {
    int b, y0, x0;
    origin(it, b, y0, x0);
#pragma unroll
    for (int k = 0; k < Pl::GPT; ++k) {
      const int i = tid + k * NT, p = i / CO2P, co = i % CO2P;
      const int gy = y0 - 1 + p / HW, gx = x0 - 1 + p % HW;
      const bool ok = i < Pl::GFL && co < co2 && gy >= 0 && gy < H && gx >= 0 && gx < W;
      gr[k] = ok ? __bfloat162float(g[(((size_t)b * H + gy) * W + gx) * co2 + co]) : 0.f;
    }
  };

  float wacc[9][CO2P], gsum[CO2P], zsum[8];
#pragma unroll
  for (int co = 0; co < CO2P; ++co) {
    gsum[co] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) wacc[t][co] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) zsum[j] = 0.f;

  if (ntile > 0) {
    load_hid(0);
    load_g(0);
  }
  esr::mma::cp_async_commit();
  for (int it = 0; it < ntile; ++it) {
    if (it + 1 < ntile) load_hid(it + 1);
    esr::mma::cp_async_commit();
    float* gcur = gs + (it & 1) * Pl::GFL;
#pragma unroll
    for (int k = 0; k < Pl::GPT; ++k)
      if (tid + k * NT < Pl::GFL) gcur[tid + k * NT] = gr[k];
    if (it + 1 < ntile) load_g(it + 1);
    esr::mma::cp_async_wait<1>();
    __syncthreads();
    const unsigned char* hcur = smem + (it & 1) * Pl::HBYTES;
    int b, y0, x0;
    origin(it, b, y0, x0);

    // dz0 for channels cg*8 .. +8 of pixels zp, zp + ZSTEP, ...
    float acc[Pl::NZ][8];
#pragma unroll
    for (int k = 0; k < Pl::NZ; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
#pragma unroll
      for (int co = 0; co < CO2P; ++co) {
        const float4 wl = *reinterpret_cast<const float4*>(w1s + (t * CO2P + co) * C + cg * 8);
        const float4 wh = *reinterpret_cast<const float4*>(w1s + (t * CO2P + co) * C + cg * 8 + 4);
        const float wv[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
        for (int k = 0; k < Pl::NZ; ++k) {
          const int p = min(zp + k * Pl::ZSTEP, PIX - 1);  // (past PIX: C = 8's idle half)
          const float gv = gcur[((p / TW + 2 - t / 3) * HW + p % TW + 2 - t % 3) * CO2P + co];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[k][j] = fmaf(gv, wv[j], acc[k][j]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < Pl::NZ; ++k) {
      const int p = zp + k * Pl::ZSTEP, y = y0 + p / TW, xx = x0 + p % TW;
      if (p >= PIX || y >= H || xx >= W) continue;
      const uint4 hv = *reinterpret_cast<const uint4*>(
          hcur + ((p / TW + 1) * HW + p % TW + 1) * C * 2 + cg * 16);
      const bf16* hb = reinterpret_cast<const bf16*>(&hv);
      float d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        d[j] = __bfloat162float(hb[j]) >= 0.f ? acc[k][j] : acc[k][j] * slope;
        zsum[j] += d[j];
      }
      uint4 r;
      r.x = esr::mma::pack_bf16(d[0], d[1]);
      r.y = esr::mma::pack_bf16(d[2], d[3]);
      r.z = esr::mma::pack_bf16(d[4], d[5]);
      r.w = esr::mma::pack_bf16(d[6], d[7]);
      *reinterpret_cast<uint4*>(dz0 + (((size_t)b * H + y) * W + xx) * C + cg * 8) = r;
    }

    // dW1 and db1 over this thread's runs of L pixels along a tile row
    const bf16* hc = reinterpret_cast<const bf16*>(hcur) + c;  // channel c of pixel p: hc[p * C]
#pragma unroll
    for (int sg = 0; sg < Pl::NSEG; ++sg) {
      const int base = q * Pl::SEG + sg * Pl::L, ly = base / TW, lx0 = base % TW;
      float a[3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx)
          a[dy][dx] = __bfloat162float(hc[((ly + dy) * HW + lx0 + dx) * C]);
#pragma unroll
      for (int px = 0; px < Pl::L; ++px) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
          a[dy][2] = __bfloat162float(hc[((ly + dy) * HW + lx0 + px + 2) * C]);
        const float* gp = gcur + ((ly + 1) * HW + lx0 + px + 1) * CO2P;
#pragma unroll
        for (int co = 0; co < CO2P; ++co) {
          const float gv = gp[co];
          gsum[co] += gv;
#pragma unroll
          for (int t = 0; t < 9; ++t) wacc[t][co] = fmaf(a[t / 3][t % 3], gv, wacc[t][co]);
        }
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) a[dy][0] = a[dy][1], a[dy][1] = a[dy][2];
      }
    }
    __syncthreads();
  }
  esr::mma::cp_async_wait<0>();
  __syncthreads();

  // the block's sums, each in a fixed order: dW1 over the Q runs of a channel
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int co = 0; co < CO2P; ++co) {
    if (co >= co2) break;
#pragma unroll
    for (int t = 0; t < 9; ++t) red[(q * 9 + t) * C + c] = wacc[t][co];
    __syncthreads();
    for (int i = tid; i < 9 * C; i += NT) {
      float v = 0.f;
      for (int r = 0; r < Pl::Q; ++r) v += red[r * 9 * C + i];
      dst[(size_t)i * co2 + co] = v;  // i = t * C + channel: HWIO
    }
    __syncthreads();
  }
  if (c == 0) {  // db1: the runs of channel 0's threads
#pragma unroll
    for (int co = 0; co < CO2P; ++co) red[q * CO2P + co] = gsum[co];
  }
  __syncthreads();
  if (tid < co2) {
    float v = 0.f;
    for (int r = 0; r < Pl::Q; ++r) v += red[r * CO2P + tid];
    dst[9 * C * co2 + tid] = v;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) red[tid * 8 + j] = zsum[j];  // db0: the unrounded dz0
  __syncthreads();
  if (tid < C) {
    float v = 0.f;
    for (int r = tid / 8; r < NT; r += Pl::NG) v += red[r * 8 + tid % 8];
    dst[9 * C * co2 + co2 + tid] = v;
  }
}

// hid's near-zero entries as the FMA design computes them. The gate of
// conv_hr_adj_kernel is lrelu'(hid), the sign of conv0's pre-activation v.
// The tensor cores' fp32 accumulation of the recompute errs by ~1e-6 of the
// activations' scale, so a v that close to 0 can take the other sign than the
// FMA design's sum gives it (and cuDNN's fp32 conv, the twin's, which gives
// the same bits); at the flagship shape ~1 element in 16.7M flips a call, and
// one flipped gate moves dx by up to ~0.8 |dhid| |w0|, a few % of max|dx|. A
// thread reads 8 channels of one pixel; each whose |hid| is below GATE_EPS of
// their largest is recomputed as dense_conv3x3_kernel sums it, bit for bit:
// its fmaf chain over the input channels, the 9 taps inside, then + b0, then
// lrelu and one rounding. A bf16 x bf16 product is exact in fp32, so each
// fmaf is one rounded add: the warp forms the 9*C products (x and w0 from
// global memory) into shared memory and one lane adds them in the chain's
// order. ~5e-5 of the elements at random inputs; the pass is a read of hid.
constexpr float GATE_EPS = 1.f / 65536;

template <int C>
__global__ void __launch_bounds__(NT) conv_hr_hid_fix_kernel(
    bf16* __restrict__ hid,        // [B, H, W, C]: rewritten where near 0
    const bf16* __restrict__ x,    // [B, H, W, C]: conv0's input
    const bf16* __restrict__ w0,   // [3, 3, C, C]
    const float* __restrict__ b0,  // [C]
    int n8, int H, int W, float slope) {
  __shared__ float prod[NT / 32][9 * C];  // a warp's products of the element it recomputes
  const int tid = threadIdx.x, lane = tid & 31, i = blockIdx.x * NT + tid;
  uint4 hv = i < n8 ? reinterpret_cast<const uint4*>(hid)[i] : uint4{0, 0, 0, 0};
  bf16* hb = reinterpret_cast<bf16*>(&hv);
  float scale = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) scale = fmaxf(scale, fabsf(__bfloat162float(hb[j])));
  uint32_t todo = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    todo |= (uint32_t)(i < n8 && fabsf(__bfloat162float(hb[j])) < GATE_EPS * scale) << j;
  const bool any = todo != 0;
  while (__any_sync(0xffffffffu, todo != 0)) {  // the warp's near-zero entries, one at a time
    const int leader = __ffs(__ballot_sync(0xffffffffu, todo != 0)) - 1;
    const int j = __shfl_sync(0xffffffffu, todo ? __ffs(todo) - 1 : 0, leader);
    const int e = __shfl_sync(0xffffffffu, i, leader) * 8 + j;  // element of hid
    const int c = e % C, pix = e / C, xx = pix % W, y = pix / W % H, b = pix / (W * H);
    for (int k = lane; k < 9 * C; k += 32) {  // product k = (ci = k / 9, tap k % 9), exact
      const int ci = k / 9, t = k % 9, gy = y + t / 3 - 1, gx = xx + t % 3 - 1;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      prod[tid / 32][k] = in ? __bfloat162float(x[(((size_t)b * H + gy) * W + gx) * C + ci]) *
                                   __bfloat162float(w0[((size_t)t * C + ci) * C + c])
                             : 0.f;
    }
    __syncwarp();
    if (lane == leader) {
      float v = 0.f;
#pragma unroll 16
      for (int k = 0; k < 9 * C; ++k) v += prod[tid / 32][k];
      hb[j] = __float2bfloat16_rn(esr::lrelu(v + b0[c], slope));
      todo &= todo - 1;
    }
    __syncwarp();
  }
  if (any) reinterpret_cast<uint4*>(hid)[i] = hv;
}

}  // namespace adj

// ---------------------------------------------------------------------------
// The bf16 tensor-core design ("mma") of the upconv, its adjoint and conv_hr's
// forward: implicit GEMMs on mma.sync m16n8k16 (csrc/mma_tile.cuh), fp32
// accumulators, one rounding of each output. kernels/tail_ct.py picks the
// design by dtype (stage_ct.design); fp32 keeps the FMA kernels, whose 1e-4 bar
// TF32 would miss.
//
// Upconv (upfold_ct): upfold_mma_kernel, the phase fold of
// csrc/phase_fold.cuh: a block stages its 8x16 LR tile with the 1-pixel halo
// once (in slices of 128 channels, restaged for each phase, where all C do
// not fit shared memory) and runs the four output phases in turn, each as K =
// 4 taps x C of the folded weights wf[a][b][i][j] ([k = c][n = co] rows,
// ldmatrix.trans) over shifted rows of the tile; + bias, lrelu on the fp32
// value, one rounding; each phase stored as 16-byte vectors at HR pixels
// (2y + a, 2x + b).
// Bound: bytes (above).
//
// Upconv adjoint (upfold_ct_bwd), three launches and two fixed-order finishes:
//   * upfold_dz_kernel (bytes: g and the saved output read once as 16-byte
//     vectors, the rounded dz written once): dz of output phase (a, b) =
//     g[2y+a, 2x+b] gated by the saved output's sign (>= 0, no recompute, so
//     the gate is the twin's), rounded once and stored phase-stacked at LR
//     pixel (y, x): channel (2a+b)*COP + co of a [B, H, W, 4*COP] tensor (COP =
//     CO, at least 16: K of one mma). db sums the unrounded dz, in per-block
//     partial rows.
//   * upfold_dgrad_mma_kernel: dx = sum over the 16 (a, b, i, j) of dz_ab at
//     LR shift -(a-1+i, b-1+j) times wf[a, b, i, j]^T. M = an 8x16 LR pixel
//     tile, N = C, K = 16 blocks x COP: only the blocks the fold makes, where
//     a 3x3 adjoint over the phase-stacked channels would do 36. The haloed
//     10x18 stacked tile is staged once; block s is a shifted row of it at
//     channel offset (2a+b)*COP, and wf[a, b, i, j] ([c][co] = [n][k] rows)
//     streams through a 3-slot cp.async ring.
//   * upfold_wgrad_mma_kernel: dwf[a, b, i, j] = sum over pixels of x at LR
//     shift (a-1+i, b-1+j) times dz_ab. A block takes one phase (a, b) and N =
//     CO; its 8 warps are the 4 taps (i, j) x 2 halves of N, each over all C
//     (m16 tiles of 16 channels, x^T read by ldmatrix.trans), so a warp's taps
//     share one B fragment. Blocks walk fixed ranges of 4x16 pixel tiles
//     (double-buffered cp.async); partial rows and wgrad_finish_kernel keep
//     the reduction order a function of the shapes (kernels/tail_ct.py
//     upfold_wgrad_ranges and upfold_dz_ranges mirror both partitions).
// Bound: bytes (the gate pass's 2 reads and 1 write of an HR-sized tensor
// dominate; the two products are 2 x 4*C*CO MACs per HR pixel).
//
// conv_hr forward (conv_hr_ct), two launches: the stage forward
// (csrc/stage_ct.cu stage_fwd_mma_kernel, lrelu epilogue) writes hid =
// bf16(lrelu(conv0(x) + b0)) to device memory, then conv_hr_out_mma_kernel
// stages an 8x16 tile of hid with its 1-pixel halo (zero outside the image:
// conv1's SAME padding of conv0's output), w1 padded to N = 8, and runs K = 9
// taps x C on one n8 tile per warp: + b1, one rounding, co2 channels stored.
// Bound: operations for conv0 (9*C*C MACs a pixel), bytes for conv1 (hid read
// once). Writing hid and reading it back (2 x C bf16 a pixel) replaces the
// FMA kernel's 1.41x halo recompute of conv0.
// ---------------------------------------------------------------------------

namespace tc {

using esr::mma::cp_async16;
using esr::mma::ldsm_pitch;
using esr::mma::smem_u32;
using esr::tile::acc_to_smem;
using esr::tile::bf16;
using esr::tile::HP;
using esr::tile::HW;
using esr::tile::pack8;
using esr::tile::round16;
using esr::tile::smem_to_out;
using esr::tile::stage_tile;
using esr::tile::Tiling;
using esr::tile::warp_mma;

constexpr int NSLOT = 3;                 // weight-ring depth of the dx kernel
constexpr int UP_NW = 8;                 // warps of a dx block
constexpr int UPF_NW = 4;                // warps of an upconv forward block
constexpr int WG_TH = 4;                 // dW pixel tile: 4x16 = 64 pixels of K
constexpr int WG_PIX = WG_TH * TW;
constexpr int WG_HP = (WG_TH + 2) * HW;
constexpr int HR_NW = 4;                 // warps of a conv_hr output block

// the stacked dz's channels per output phase: CO, at least 16 (K of one mma)
__host__ __device__ constexpr int phase_width(int co) { return co < 16 ? 16 : co; }

// The upconv forward of one 8x16 LR tile, all four output phases: NP = CO.
template <int NP>
__global__ void __launch_bounds__(UPF_NW * 32, esr::fold::fold_min_blocks<UPF_NW>())
    upfold_mma_kernel(
    const bf16* __restrict__ x, int C,   // [B, H, W, C] LR
    const bf16* __restrict__ wf,         // [2(a), 2(b), 2(i), 2(j), C, NP] folded
    const float* __restrict__ bias,      // [NP]
    bf16* __restrict__ out,              // [B, 2H, 2W, NP]
    int H, int W, float slope) {
  constexpr int WP = ldsm_pitch(NP), NC = NP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kp = round16(C), tid = threadIdx.x;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  auto stage_x = [&](int c0, int len, int pitch) {  // channels c0 .. c0+len of the LR tile
    stage_tile<TH + 2, HW>(x, smem, pitch, b, y0 - 1, x0 - 1, H, W, C, c0, len, tid);
  };
  // slice (a, b, i, j) = wf[phase][tap] as [k = c][n = co] rows, K rows c0 ..
  auto load_w = [&](uint32_t dst, int ph, int t, int c0, int len) {
    const bf16* src = wf + (size_t)(ph * 4 + t) * C * NP;
    for (int i = tid; i < len * NC; i += UPF_NW * 32) {
      const int r = i / NC, n8 = i % NC, c = c0 + r;
      const bool ok = c < C;
      cp_async16(dst + r * WP + n8 * 16, ok ? src + (size_t)c * NP + n8 * 8 : wf, ok);
    }
  };
  auto store = [&](int ph, const unsigned char* src, int pitch) {  // out(2y + a, 2x + b)
    smem_to_out<2>(src, pitch, out, b, y0, x0, H, W, NP, tid, ph >> 1, ph & 1);
  };
  esr::fold::fold_mma<NP, UPF_NW, true>(smem, kp, stage_x, load_w, [] {}, bias,
                                         esr::tile::kLrelu, slope, store);
}

// Block p turns the 16-byte chunks [p * per, (p + 1) * per) of g into dz
// (chunk e = HR pixel e / NC, channels (e % NC) * 8 ..; chunks past CO are the
// zero padding of COP). per is a multiple of NT and NT of NC, so a thread
// always forms the same 8 channels and keeps their db partials in registers.
template <int COP>
__global__ void __launch_bounds__(NT) upfold_dz_kernel(
    const bf16* __restrict__ g,    // [B, 2H, 2W, CO]: the upconv output's cotangent
    const bf16* __restrict__ out,  // [B, 2H, 2W, CO]: its saved output
    bf16* __restrict__ dz,         // [B, H, W, 4 * COP]
    float* __restrict__ part,      // [npart][CO]: db
    int CO, int H, int W, float slope, int n8, int per) {
  constexpr int NC = COP / 8;
  __shared__ float red[NT * 8];
  const int tid = threadIdx.x, c8 = tid % NC;
  const int end = min(n8, (int)(blockIdx.x + 1) * per);
  float db[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) db[k] = 0.f;
  for (int e = blockIdx.x * per + tid; e < end; e += NT) {
    const int P = e / NC, X = P % (2 * W), Y = P / (2 * W) % (2 * H), n = P / (4 * H * W);
    uint4 r = make_uint4(0, 0, 0, 0);
    if (c8 * 8 < CO) {
      const size_t i = (size_t)P * CO + c8 * 8;
      const uint4 gv = *reinterpret_cast<const uint4*>(g + i);
      const uint4 ov = *reinterpret_cast<const uint4*>(out + i);
      const bf16* gp = reinterpret_cast<const bf16*>(&gv);
      const bf16* op = reinterpret_cast<const bf16*>(&ov);
      float d[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float v = __bfloat162float(gp[k]);
        d[k] = __bfloat162float(op[k]) >= 0.f ? v : v * slope;
        db[k] += d[k];
      }
      r = pack8(d);
    }
    *reinterpret_cast<uint4*>(dz + (((size_t)n * H + (Y >> 1)) * W + (X >> 1)) * 4 * COP +
                              ((Y & 1) * 2 + (X & 1)) * COP + c8 * 8) = r;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) red[tid * 8 + k] = db[k];
  __syncthreads();
  for (int c = tid; c < CO; c += NT) {  // the threads of channel c in a fixed order
    float v = 0.f;
    for (int r = c / 8; r < NT; r += NC) v += red[r * 8 + c % 8];
    part[(size_t)blockIdx.x * CO + c] = v;
  }
}

// dx of one 8x16 LR tile: NP = C, K = the 16 (a, b, i, j) blocks of COP rows.
template <int NP, int COP>
__global__ void __launch_bounds__(UP_NW * 32, 1) upfold_dgrad_mma_kernel(
    const bf16* __restrict__ dz,  // [B, H, W, 4 * COP]: phase-stacked, rounded
    const bf16* __restrict__ wf,  // [2, 2, 2, 2, NP, CO]: the folded weights
    bf16* __restrict__ dx,        // [B, H, W, NP]
    int CO, int H, int W) {
  using Tl = Tiling<NP, UP_NW>;
  constexpr int ZP = ldsm_pitch(4 * COP), WP = ldsm_pitch(COP), SLOT = NP * WP, NC = COP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t zs = smem_u32(smem), ws = zs + HP * ZP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Tl::WN, wn = warp % Tl::WN;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  auto load_w = [&](int s) {  // wf[a, b, i, j] as [n = c][k = co] rows, zero past CO
    const uint32_t dst = ws + (s % NSLOT) * SLOT;
    for (int i = tid; i < NP * NC; i += Tl::NTH) {
      const int c = i / NC, k8 = i % NC;
      const bool ok = k8 * 8 < CO;
      cp_async16(dst + c * WP + k8 * 16, ok ? wf + ((size_t)s * NP + c) * CO + k8 * 8 : wf, ok);
    }
  };
  stage_tile<TH + 2, HW>(dz, smem, ZP, b, y0 - 1, x0 - 1, H, W, 4 * COP, 0, 4 * COP, tid);
  esr::mma::cp_async_commit();
  load_w(0);
  esr::mma::cp_async_commit();
  load_w(1);
  esr::mma::cp_async_commit();

  float acc[Tl::MT][Tl::NT8][4];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  uint32_t arow[Tl::MT];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
    arow[i] = zs + ((wm * Tl::MT + i) * HW + (lane & 15)) * ZP + (lane >> 4) * 16;

  for (int s = 0; s < 16; ++s) {
    esr::mma::cp_async_wait<1>();  // the dz tile and block s have landed
    __syncthreads();               // ... for every thread, and slot (s+2) % 3 is free
    if (s + 2 < 16) load_w(s + 2);
    esr::mma::cp_async_commit();
    const int pa = s >> 3, pb = (s >> 2) & 1, i = (s >> 1) & 1, j = s & 1;
    // dz_ab at LR pixel (y - (a-1+i), x - (b-1+j)): tile row y + 2 - a - i
    const int shift = (2 - pa - i) * HW + 2 - pb - j;
    uint32_t a[Tl::MT];
#pragma unroll
    for (int m = 0; m < Tl::MT; ++m) a[m] = arow[m] + shift * ZP + (2 * pa + pb) * COP * 2;
    warp_mma<Tl::MT, Tl::NT8, false>(acc, a, ws + (s % NSLOT) * SLOT, WP, wn * Tl::NT8 * 8, COP,
                                     lane);
  }
  esr::mma::cp_async_wait<0>();
  __syncthreads();
  constexpr int DP = ldsm_pitch(NP);
  acc_to_smem<NP, UP_NW>(acc, smem, DP, nullptr, esr::tile::kNone, 0.f, warp, lane);
  __syncthreads();
  smem_to_out(smem, DP, dx, b, y0, x0, H, W, NP, tid);
}

// dwf of one phase (a, b) = blockIdx.x over the pixel tiles of part blockIdx.y.
// Warp w: tap (i, j) = (w >> 2 & 1, w >> 1 & 1), output channels (w & 1) * COP/2 ..;
// M = its CP / 16 m16 tiles of 16 input channels, K = pixels.
template <int CP, int COP>
__global__ void __launch_bounds__(NT, 2) upfold_wgrad_mma_kernel(
    const bf16* __restrict__ x,   // [B, H, W, C]
    const bf16* __restrict__ dz,  // [B, H, W, 4 * COP]
    float* __restrict__ part,     // [npart][16 * C * CO]: dwf's layout
    int C, int CO, int H, int W, int tiles_per_part, int total_tiles, int tiles_x, int tiles_y) {
  constexpr int MT = CP / 16, NT8 = COP / 16;
  constexpr int XP = ldsm_pitch(CP), GP = ldsm_pitch(COP);
  constexpr int XBYTES = WG_HP * XP, BUF = XBYTES + WG_PIX * GP;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tap = warp >> 1, wn = warp & 1, ti = tap >> 1, tj = tap & 1;
  const int ph = blockIdx.x, pa = ph >> 1, pb = ph & 1;
  float* dst = part + (size_t)blockIdx.y * 16 * C * CO;
  const int tbeg = blockIdx.y * tiles_per_part;
  const int ntile = min(total_tiles, tbeg + tiles_per_part) - tbeg;
  auto load = [&](int it) {
    const int tile = tbeg + it;
    unsigned char* buf = smem + (it & 1) * BUF;
    const int b = tile / (tiles_x * tiles_y);
    const int oy0 = tile / tiles_x % tiles_y * WG_TH, ox0 = tile % tiles_x * TW;
    stage_tile<WG_TH + 2, HW>(x, buf, XP, b, oy0 - 1, ox0 - 1, H, W, C, 0, CP, tid);
    stage_tile<WG_TH, TW>(dz, buf + XBYTES, GP, b, oy0, ox0, H, W, 4 * COP, ph * COP, COP, tid);
  };

  float acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  if (ntile > 0) load(0);
  esr::mma::cp_async_commit();
  for (int it = 0; it < ntile; ++it) {
    if (it + 1 < ntile) load(it + 1);
    esr::mma::cp_async_commit();
    esr::mma::cp_async_wait<1>();
    __syncthreads();
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
      // A = x^T: [k = pixel][m = c] rows read with .trans; x of dz pixel (y, x)
      // at tap (a, b, i, j) is tile pixel (y + a + i, x + b + j)
      const int px = (lane & 7) + (lane >> 4) * 8;
      const uint32_t xrow = xs + ((kk + pa + ti) * HW + px + pb + tj) * XP + ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t af[4];
        esr::mma::ldsm_x4_t(af, xrow + i * 32);
#pragma unroll
        for (int j = 0; j < NT8; ++j) esr::mma::mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
    __syncthreads();
  }
  esr::mma::cp_async_wait<0>();

  const int t = ph * 4 + tap;  // (a, b, i, j) flattened: dwf's leading index
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      const int n = (wn * NT8 + j) * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = i * 16 + (lane >> 2) + 8 * h;
        if (c < C && n < CO)
          *reinterpret_cast<float2*>(dst + ((size_t)t * C + c) * CO + n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// conv1 of conv_hr on the tensor cores: out = bf16(conv1(hid) + b1) over one
// 8x16 tile; 4 warps of two m16 tiles (tile rows) x one n8 tile.
template <int CP>
__global__ void __launch_bounds__(HR_NW * 32) conv_hr_out_mma_kernel(
    const bf16* __restrict__ hid,  // [B, H, W, C]: conv0's activation, rounded
    const bf16* __restrict__ w1,   // [3, 3, C, co2]
    const float* __restrict__ b1,  // [co2]
    bf16* __restrict__ out,        // [B, H, W, co2]
    int C, int co2, int H, int W) {
  using Tl = Tiling<8, HR_NW>;
  constexpr int XP = ldsm_pitch(CP), WP = 16;  // w1 as [k = (tap, c)][n = 8] rows
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* w1s = reinterpret_cast<bf16*>(smem + HP * XP);
  const uint32_t xs = smem_u32(smem), ws = xs + HP * XP;
  const int tid = threadIdx.x, lane = tid & 31, wm = tid >> 5;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  stage_tile<TH + 2, HW>(hid, smem, XP, b, y0 - 1, x0 - 1, H, W, C, 0, CP, tid);
  esr::mma::cp_async_commit();
  for (int i = tid; i < 9 * CP * 8; i += Tl::NTH) {
    const int co = i % 8, r = i / 8, t = r / CP, c = r % CP;
    w1s[i] = c < C && co < co2 ? w1[((size_t)t * C + c) * co2 + co] : __float2bfloat16_rn(0.f);
  }
  esr::mma::cp_async_wait<0>();
  __syncthreads();

  float acc[Tl::MT][1][4];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][0][r] = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    uint32_t a[Tl::MT];
#pragma unroll
    for (int i = 0; i < Tl::MT; ++i)
      a[i] = xs + (((wm * Tl::MT + i) + t / 3) * HW + (lane & 15) + t % 3) * XP + (lane >> 4) * 16;
    warp_mma<Tl::MT, 1, true>(acc, a, ws + t * CP * WP, WP, 0, CP, lane);
  }
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wm * Tl::MT + i) * 16 + (lane >> 2) + 8 * h;
      const int y = y0 + m / TW, xx = x0 + m % TW;
      if (y >= H || xx >= W) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = (lane & 3) * 2 + e;
        if (n < co2)
          out[(((size_t)b * H + y) * W + xx) * co2 + n] = __float2bfloat16_rn(acc[i][0][2 * h + e] + b1[n]);
      }
    }
}

}  // namespace tc

template <int C, int CO2P>
int launch_conv_hr_adj(int co2, const void* g, const void* w1, const void* hid, void* dz0,
                       float* part, int npart, float* out, int B, int H, int W, float slope,
                       cudaStream_t s) {
  using Pl = adj::Plan<C, CO2P>;
  cudaError_t e = cudaFuncSetAttribute(adj::conv_hr_adj_kernel<C, CO2P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Pl::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int total = B * tiles_x * tiles_y;
  const int per = (total + npart - 1) / npart;
  adj::conv_hr_adj_kernel<C, CO2P><<<npart, NT, Pl::SMEM, s>>>(
      static_cast<const adj::bf16*>(g), static_cast<const adj::bf16*>(w1),
      static_cast<const adj::bf16*>(hid), static_cast<adj::bf16*>(dz0), part, co2, H, W, slope,
      per, total, tiles_x, tiles_y);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int row = 9 * C * co2 + co2 + C;
  esr::wgrad::wgrad_finish_kernel<<<(row + 255) / 256, 256, 0, s>>>(part, npart, row, out);
  return (int)cudaGetLastError();
}

template <int CO2P>
int conv_hr_adj_c(int C, int co2, const void* g, const void* w1, const void* hid, void* dz0,
                  float* part, int npart, float* out, int B, int H, int W, float slope,
                  cudaStream_t s) {
#define ESR_ADJ(CC) \
  launch_conv_hr_adj<CC, CO2P>(co2, g, w1, hid, dz0, part, npart, out, B, H, W, slope, s)
  switch (C) {
    case 8: return ESR_ADJ(8);
    case 16: return ESR_ADJ(16);
    case 32: return ESR_ADJ(32);
    case 64: return ESR_ADJ(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ESR_ADJ
}

template <int C>
int launch_conv_hr_hid_fix(void* hid, const void* x, const void* w0, const float* b0, int B,
                           int H, int W, float slope, cudaStream_t s) {
  const int n8 = B * H * W * C / 8;
  adj::conv_hr_hid_fix_kernel<C><<<(n8 + NT - 1) / NT, NT, 0, s>>>(
      static_cast<adj::bf16*>(hid), static_cast<const adj::bf16*>(x),
      static_cast<const adj::bf16*>(w0), b0, n8, H, W, slope);
  return (int)cudaGetLastError();
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

int upfold_cout(int CO, const void* x, int C, const void* wf, const void* bias, void* out,
                int B, int H, int W, float slope, cudaStream_t s) {
  switch (CO) {
    case 8: return launch_upfold<float, 8>(x, C, wf, bias, out, B, H, W, slope, s);
    case 16: return launch_upfold<float, 16>(x, C, wf, bias, out, B, H, W, slope, s);
    case 32: return launch_upfold<float, 32>(x, C, wf, bias, out, B, H, W, slope, s);
    case 64: return launch_upfold<float, 64>(x, C, wf, bias, out, B, H, W, slope, s);
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


// ---- the bf16 tensor-core design: launches ---------------------------------

enum Design : int { kFma = 0, kMma = 1 };  // kernels/tail_ct.py DESIGNS

using esr::mma::ldsm_pitch;

template <int NP>
int launch_upfold_mma(int C, const void* x, const void* wf, const float* bias, void* out, int B,
                      int H, int W, float slope, cudaStream_t s) {
  const int kp = esr::tile::round16(C);
  const size_t smem = esr::fold::fold_smem(NP, esr::fold::fold_kt(NP, kp, true), true);
  if (int e = esr::tile::smem_opt_in(tc::upfold_mma_kernel<NP>, smem)) return e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  tc::upfold_mma_kernel<NP><<<grid, tc::UPF_NW * 32, smem, s>>>(
      static_cast<const tc::bf16*>(x), C, static_cast<const tc::bf16*>(wf), bias,
      static_cast<tc::bf16*>(out), H, W, slope);
  return (int)cudaGetLastError();
}

template <int COP>
int launch_upfold_dz(int CO, const void* g, const void* out, void* dz, float* part, int npart,
                     float* db, int B, int H, int W, float slope, cudaStream_t s) {
  const int n8 = B * 4 * H * W * (COP / 8);
  const int per = ((n8 + npart - 1) / npart + NT - 1) / NT * NT;
  tc::upfold_dz_kernel<COP><<<npart, NT, 0, s>>>(
      static_cast<const tc::bf16*>(g), static_cast<const tc::bf16*>(out),
      static_cast<tc::bf16*>(dz), part, CO, H, W, slope, n8, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  esr::wgrad::wgrad_finish_kernel<<<(CO + 255) / 256, 256, 0, s>>>(part, npart, CO, db);
  return (int)cudaGetLastError();
}

template <int NP, int COP>
int launch_upfold_dgrad(int CO, const void* dz, const void* wf, void* dx, int B, int H, int W,
                        cudaStream_t s) {
  const size_t smem = std::max<size_t>(
      (size_t)esr::tile::HP * ldsm_pitch(4 * COP) + (size_t)tc::NSLOT * NP * ldsm_pitch(COP),
      (size_t)esr::tile::PIX * ldsm_pitch(NP));
  if (int e = esr::tile::smem_opt_in(tc::upfold_dgrad_mma_kernel<NP, COP>, smem)) return e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  tc::upfold_dgrad_mma_kernel<NP, COP><<<grid, tc::UP_NW * 32, smem, s>>>(
      static_cast<const tc::bf16*>(dz), static_cast<const tc::bf16*>(wf),
      static_cast<tc::bf16*>(dx), CO, H, W);
  return (int)cudaGetLastError();
}

template <int CP, int COP>
int launch_upfold_wgrad(int C, int CO, const void* x, const void* dz, float* part, int npart,
                        float* dwf, int B, int H, int W, cudaStream_t s) {
  const size_t smem = 2 * ((size_t)tc::WG_HP * ldsm_pitch(CP) + (size_t)tc::WG_PIX * ldsm_pitch(COP));
  if (int e = esr::tile::smem_opt_in(tc::upfold_wgrad_mma_kernel<CP, COP>, smem)) return e;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + tc::WG_TH - 1) / tc::WG_TH;
  const int total = B * tiles_x * tiles_y;
  const int per = (total + npart - 1) / npart;
  tc::upfold_wgrad_mma_kernel<CP, COP><<<dim3(4, npart), NT, smem, s>>>(
      static_cast<const tc::bf16*>(x), static_cast<const tc::bf16*>(dz), part, C, CO, H, W, per,
      total, tiles_x, tiles_y);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int row = 16 * C * CO;
  esr::wgrad::wgrad_finish_kernel<<<(row + 255) / 256, 256, 0, s>>>(part, npart, row, dwf);
  return (int)cudaGetLastError();
}

template <int CP>
int launch_conv_hr_out(int C, int co2, const void* hid, const void* w1, const float* b1,
                       void* out, int B, int H, int W, cudaStream_t s) {
  const size_t smem = (size_t)esr::tile::HP * ldsm_pitch(CP) + (size_t)9 * CP * 16;
  if (int e = esr::tile::smem_opt_in(tc::conv_hr_out_mma_kernel<CP>, smem)) return e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  tc::conv_hr_out_mma_kernel<CP><<<grid, tc::HR_NW * 32, smem, s>>>(
      static_cast<const tc::bf16*>(hid), static_cast<const tc::bf16*>(w1), b1,
      static_cast<tc::bf16*>(out), C, co2, H, W);
  return (int)cudaGetLastError();
}

// by width: N = C (8, 16, 32, 64) of the dx kernel, CP = C rounded up to 16
// of the dW and conv_hr kernels, COP = phase_width(CO)
template <int NP>
int upfold_dgrad_co(int CO, const void* dz, const void* wf, void* dx, int B, int H, int W,
                    cudaStream_t s) {
  switch (CO) {
    case 8:
    case 16: return launch_upfold_dgrad<NP, 16>(CO, dz, wf, dx, B, H, W, s);
    case 32: return launch_upfold_dgrad<NP, 32>(CO, dz, wf, dx, B, H, W, s);
    case 64: return launch_upfold_dgrad<NP, 64>(CO, dz, wf, dx, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int CP>
int upfold_wgrad_co(int C, int CO, const void* x, const void* dz, float* part, int npart,
                    float* dwf, int B, int H, int W, cudaStream_t s) {
  switch (CO) {
    case 8:
    case 16: return launch_upfold_wgrad<CP, 16>(C, CO, x, dz, part, npart, dwf, B, H, W, s);
    case 32: return launch_upfold_wgrad<CP, 32>(C, CO, x, dz, part, npart, dwf, B, H, W, s);
    case 64: return launch_upfold_wgrad<CP, 64>(C, CO, x, dz, part, npart, dwf, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Fused nearest-x2 + 3x3 conv + bias + lrelu: x [B,H,W,C], wf
// [2,2,2,2,C,CO] (prepare_upfold_ct), bias fp32 [CO] -> out [B,2H,2W,CO]; CO
// in {8, 16, 32, 64}. `design`: 1 (upfold_mma_kernel) for bf16, 0
// (upfold_kernel) for fp32; any other value returns cudaErrorInvalidValue.
// Returns cudaGetLastError().
int esr_upfold(int dtype, int design, int C, int CO, const void* x, const void* wf,
               const void* bias, void* out, int B, int H, int W, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design != (dtype == esr::kBFloat16 ? kMma : kFma) || C < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == esr::kFloat32) return upfold_cout(CO, x, C, wf, bias, out, B, H, W, slope, s);
  if (dtype != esr::kBFloat16) return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  switch (CO) {
    case 8: return launch_upfold_mma<8>(C, x, wf, b, out, B, H, W, slope, s);
    case 16: return launch_upfold_mma<16>(C, x, wf, b, out, B, H, W, slope, s);
    case 32: return launch_upfold_mma<32>(C, x, wf, b, out, B, H, W, slope, s);
    case 64: return launch_upfold_mma<64>(C, x, wf, b, out, B, H, W, slope, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Fused hr_conv0 (+lrelu) and hr_conv1, the FMA design: fp32 only, `design`
// 0 (bf16 runs the tensor-core design: the stage forward, then
// esr_conv_hr_out); anything else returns cudaErrorInvalidValue. Returns
// cudaGetLastError().
int esr_conv_hr(int dtype, int design, int C, int CO2, const void* x, const void* w0,
                const void* b0, const void* w1, const void* b1, void* out, int B, int H, int W,
                float slope, void* stream) {
  if (dtype != esr::kFloat32 || design != kFma || CO2 < 1 || CO2 > 8)
    return (int)cudaErrorInvalidValue;
  return conv_hr_c<float>(C, CO2, x, w0, b0, w1, b1, out, B, H, W, slope,
                          static_cast<cudaStream_t>(stream));
}

// conv_hr's bf16 forward, second launch (tensor cores, `design` 1, else
// cudaErrorInvalidValue): out [B,H,W,CO2] = bf16(conv1(hid) + b1) from hid
// [B,H,W,C] (conv0's activation, rounded), w1 [3,3,C,CO2] (bf16), b1 [CO2]
// (fp32); C in {8, 16, 32, 64}, CO2 in 1..8. Returns cudaGetLastError().
int esr_conv_hr_out(int design, int C, int CO2, const void* hid, const void* w1,
                    const float* b1, void* out, int B, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design != kMma || CO2 < 1 || CO2 > 8) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 8:
    case 16: return launch_conv_hr_out<16>(C, CO2, hid, w1, b1, out, B, H, W, s);
    case 32: return launch_conv_hr_out<32>(C, CO2, hid, w1, b1, out, B, H, W, s);
    case 64: return launch_conv_hr_out<64>(C, CO2, hid, w1, b1, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The upconv's bf16 adjoint on the tensor cores (`design` 1 in each entry,
// else cudaErrorInvalidValue); C, CO in {8, 16, 32, 64}, COP = max(CO, 16).
// 1. dz [B,H,W,4*COP] bf16 (phase-stacked, rounded) from g and the saved
//    output out (both [B,2H,2W,CO] bf16); db [CO] fp32 from the unrounded dz
//    through `part`, an fp32 workspace of npart * CO floats: part p takes the
//    16-byte chunks [p * per, (p + 1) * per) of g, per = ceil(ceil(n8 / npart)
//    / 256) * 256 with n8 = B*4*H*W*COP/8 (kernels/tail_ct.py upfold_dz_ranges).
int esr_upfold_dz(int design, int CO, const void* g, const void* out, void* dz, float* part,
                  int npart, float* db, int B, int H, int W, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design != kMma || npart < 1) return (int)cudaErrorInvalidValue;
  switch (CO) {
    case 8:
    case 16: return launch_upfold_dz<16>(CO, g, out, dz, part, npart, db, B, H, W, slope, s);
    case 32: return launch_upfold_dz<32>(CO, g, out, dz, part, npart, db, B, H, W, slope, s);
    case 64: return launch_upfold_dz<64>(CO, g, out, dz, part, npart, db, B, H, W, slope, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 2. dx [B,H,W,C] bf16 from dz and the folded weights wf [2,2,2,2,C,CO] bf16.
int esr_upfold_dgrad(int design, int C, int CO, const void* dz, const void* wf, void* dx, int B,
                     int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design != kMma) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 8: return upfold_dgrad_co<8>(CO, dz, wf, dx, B, H, W, s);
    case 16: return upfold_dgrad_co<16>(CO, dz, wf, dx, B, H, W, s);
    case 32: return upfold_dgrad_co<32>(CO, dz, wf, dx, B, H, W, s);
    case 64: return upfold_dgrad_co<64>(CO, dz, wf, dx, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 3. dwf [2,2,2,2,C,CO] fp32 from x [B,H,W,C] and dz through `part`, an fp32
//    workspace of npart * 16*C*CO floats: part p sums the 4x16 LR pixel tiles
//    [p * per, (p + 1) * per), per = ceil(tiles / npart) (kernels/tail_ct.py
//    upfold_wgrad_ranges).
int esr_upfold_wgrad(int design, int C, int CO, const void* x, const void* dz, float* part,
                     int npart, float* dwf, int B, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design != kMma || npart < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 8:
    case 16: return upfold_wgrad_co<16>(C, CO, x, dz, part, npart, dwf, B, H, W, s);
    case 32: return upfold_wgrad_co<32>(C, CO, x, dz, part, npart, dwf, B, H, W, s);
    case 64: return upfold_wgrad_co<64>(C, CO, x, dz, part, npart, dwf, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// conv_hr's bf16 adjoint, after the recompute of hid [B,H,W,C] bf16 on the
// tensor cores (conv_hr_hid_fix_kernel): its entries near 0 recomputed as the
// FMA design computes them, from conv0's input x [B,H,W,C], w0 [3,3,C,C]
// (bf16) and b0 [C] (fp32), in place. Returns cudaGetLastError().
int esr_conv_hr_hid_fix(int C, void* hid, const void* x, const void* w0, const float* b0, int B,
                        int H, int W, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return launch_conv_hr_hid_fix<8>(hid, x, w0, b0, B, H, W, slope, s);
    case 16: return launch_conv_hr_hid_fix<16>(hid, x, w0, b0, B, H, W, slope, s);
    case 32: return launch_conv_hr_hid_fix<32>(hid, x, w0, b0, B, H, W, slope, s);
    case 64: return launch_conv_hr_hid_fix<64>(hid, x, w0, b0, B, H, W, slope, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// conv_hr's bf16 adjoint, middle launch (conv_hr_adj_kernel): dz0 [B,H,W,C]
// bf16 from g [B,H,W,CO2], w1 [3,3,C,CO2] and hid [B,H,W,C] (all bf16);
// out[0 : 9*C*CO2] = dW1 (HWIO), then db1 [CO2], then db0 [C], fp32. `part` is
// an fp32 workspace of npart * (9*C*CO2 + CO2 + C) floats; part p sums the
// 8x16 pixel tiles [p * per, (p + 1) * per), per = ceil(tiles / npart)
// (kernels/tail_ct.py conv_hr_adj_ranges). Returns cudaGetLastError().
int esr_conv_hr_adj(int C, int CO2, const void* g, const void* w1, const void* hid, void* dz0,
                    float* part, int npart, float* out, int B, int H, int W, float slope,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npart < 1 || CO2 < 1 || CO2 > 8) return (int)cudaErrorInvalidValue;
  // the output channels, padded to an instance: 1, 3 (RGB) or 8
  auto by_co2 = CO2 == 1 ? conv_hr_adj_c<1> : CO2 <= 3 ? conv_hr_adj_c<3> : conv_hr_adj_c<8>;
  return by_co2(C, CO2, g, w1, hid, dz0, part, npart, out, B, H, W, slope, s);
}

}  // extern "C"
