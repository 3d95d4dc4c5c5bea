// Early-stage convolutions of the discriminator and the VGG19 perceptual net
// (NHWC, sm_90a): a SAME 3x3 stride-1 conv and a 4x4 stride-2 pad-1 conv, each
// with bias and a fused activation, and their adjoints.
//
// Replaces four TPU kernels of esrganplus_tpu/kernels/stage_ct.py:
//   * conv_s1_ct (_conv_s1_kernel) and conv_s2_ct (_conv_s2_kernel): the
//     forward, stage_fwd_kernel<KS = 3 | 4>. fp32 accumulation over taps and
//     channels, + bias, the activation on the fp32 value, one rounding to T.
//   * _make_conv_s1_ct_diff (_conv_s1_bwd_kernel) and _make_conv_s2_ct_diff
//     (_conv_s2_bwd_kernel): the adjoint, split into stage_dgrad_kernel (dx)
//     and stage_wgrad_kernel + stage_wgrad_finish_kernel (dW, db), so that a
//     caller whose weights are frozen, or whose input is an image, launches
//     only the half it needs. dz = g * gate(saved forward output) is computed
//     in fp32 at load and never stored; db sums it unrounded, both products
//     take it rounded to T.
// The TPU kernels carry the image as column-phase planes [C, pixels] with the
// stride-2 conv as a phase decimation over parity buffers; none of that layout
// is kept. Here activations are NHWC, weights HWIO, and the stride-2 conv
// reads input rows 2i-1..2i+2 and columns 2j-1..2j+2 directly.
//
// Bound on this card: operations at every flagship shape except the
// 3-channel entry convs (27 or 48 MAC per output against a 64-channel
// output write: bytes). This first version accumulates on the CUDA cores in
// fp32 like the trunk kernels: a 256-thread block owns an 8x16 output tile and
// up to 64 output channels (a wider conv takes several blocks per tile),
// stages a few input channels of the haloed tile and of every tap's weights
// in shared memory as fp32, and keeps a 4-pixel x CO/8-channel register tile.
// The input-channel loop stops at the real channel count, so the 3-channel
// convs do 3 channels' products and nothing is padded in device memory.
//
// The weight gradient is a reduction over all B*Ho*Wo pixels. Blocks run in no
// order and fp32 atomics would make a GAN step differ from run to run, so the
// reduction is split by shape alone: block (chunk, part) walks a fixed range
// of pixel tiles and writes its partial sums to row `part` of a workspace,
// and the finishing pass adds the rows in order.
#include "common.cuh"

namespace {

using esr::from_f;
using esr::to_f;

constexpr int TH = 8;           // tile rows
constexpr int TW = 16;          // tile columns
constexpr int NT = 256;         // threads per block
constexpr int NCG = 8;          // channel groups per block
constexpr int NPG = NT / NCG;   // pixel groups (32)
constexpr int PPT = TH * TW / NPG;  // pixels per thread (4)

enum Act : int { kNone = 0, kRelu = 1, kLrelu = 2 };

__device__ __forceinline__ float act_fwd(float v, int act, float slope) {
  if (act == kRelu) return fmaxf(v, 0.f);
  if (act == kLrelu) return v >= 0.f ? v : v * slope;
  return v;
}

// Cotangent through the activation; `ref` is the saved forward OUTPUT (relu
// and lrelu keep the sign, so the output's sign is the gate).
__device__ __forceinline__ float act_adj(float g, float ref, int act, float slope) {
  if (act == kRelu) return ref > 0.f ? g : 0.f;
  if (act == kLrelu) return ref >= 0.f ? g : g * slope;
  return g;
}

// dz at one output element, unrounded fp32.
template <typename T>
__device__ __forceinline__ float dz_at(const T* __restrict__ g, const T* __restrict__ outp,
                                       size_t idx, int act, float slope) {
  const float v = to_f(g[idx]);
  return act == kNone ? v : act_adj(v, to_f(outp[idx]), act, slope);
}

// ---------------------------------------------------------------------------
// forward: out[b, i, j, co] = act(sum x[b, S*i-1+dy, S*j-1+dx, ci] * w[dy, dx, ci, co] + bias)
// ---------------------------------------------------------------------------

template <typename T, int CO, int KS>
__global__ void __launch_bounds__(NT) stage_fwd_kernel(
    const T* __restrict__ x,         // [B, H, W, cin]
    const T* __restrict__ w,         // [KS, KS, cin, cout] (HWIO)
    const float* __restrict__ bias,  // [cout]
    T* __restrict__ out,             // [B, Ho, Wo, cout]
    int H, int W, int Ho, int Wo, int cin, int cout, int nchunk, int act, float slope) {
  constexpr int S = KS == 3 ? 1 : 2;
  constexpr int KC = KS == 3 ? 8 : 4;  // input channels staged per step
  constexpr int CPT = CO / NCG;
  constexpr int XH = S * (TH - 1) + KS, XW = S * (TW - 1) + KS;
  __shared__ float xs[KC][XH][XW];
  __shared__ float ws[KS * KS][KC][CO];

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int b = blockIdx.z / nchunk;
  const int cbeg = (blockIdx.z % nchunk) * CO;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;

  float acc[PPT][CPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += KC) {
    const int kend = min(KC, cin - k0);
    for (int i = tid; i < KC * XH * XW; i += NT) {
      const int kk = i % KC;
      const int p = i / KC;
      const int ty = p / XW, tx = p % XW;
      const int gy = iy0 + ty, gx = ix0 + tx, c = k0 + kk;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin)
        v = to_f(x[(((size_t)b * H + gy) * W + gx) * cin + c]);
      xs[kk][ty][tx] = v;
    }
    for (int i = tid; i < KS * KS * KC * CO; i += NT) {
      const int co = i % CO;
      const int kk = (i / CO) % KC;
      const int t = i / (CO * KC);
      const int c = k0 + kk;
      ws[t][kk][co] = c < cin ? to_f(w[((size_t)t * cin + c) * cout + cbeg + co]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kend; ++kk) {
#pragma unroll
      for (int t = 0; t < KS * KS; ++t) {
        const int dy = t / KS, dx = t % KS;
        float wv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) wv[j] = ws[t][kk][cg * CPT + j];
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const int p = pg + NPG * i;
          const float v = xs[kk][S * (p / TW) + dy][S * (p % TW) + dx];
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
    const int oy = oy0 + p / TW, ox = ox0 + p % TW;
    if (oy >= Ho || ox >= Wo) continue;
    const size_t pix = ((size_t)b * Ho + oy) * Wo + ox;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cbeg + cg * CPT + j;
      out[pix * cout + c] = from_f<T>(act_fwd(acc[i][j] + bias[c], act, slope));
    }
  }
}

// ---------------------------------------------------------------------------
// data gradient: dx[b, y, x, ci] = sum over the taps (dy, dx) that reach input
// pixel (y, x) of round_T(dz[b, (y+1-dy)/S, (x+1-dx)/S, co]) * w[dy, dx, ci, co]
// ---------------------------------------------------------------------------

template <typename T, int CO, int KS>
__global__ void __launch_bounds__(NT) stage_dgrad_kernel(
    const T* __restrict__ g,     // [B, Ho, Wo, cout]: the output's cotangent
    const T* __restrict__ outp,  // [B, Ho, Wo, cout]: the saved output (null for kNone)
    const T* __restrict__ w,     // [KS, KS, cin, cout]
    T* __restrict__ dx,          // [B, H, W, cin]
    int H, int W, int Ho, int Wo, int cin, int cout, int nchunk, int act, float slope) {
  constexpr int S = KS == 3 ? 1 : 2;
  constexpr int KC = 8;           // dz channels staged per step
  constexpr int NTAP = KS / S + (KS % S ? 1 : 0);  // taps per axis that reach one pixel
  constexpr int CPT = CO / NCG;
  constexpr int ZH = TH / S + 2, ZW = TW / S + 2;
  __shared__ float zs[KC][ZH][ZW];
  __shared__ float ws[KS * KS][KC][CO];

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int b = blockIdx.z / nchunk;
  const int cbeg = (blockIdx.z % nchunk) * CO;       // first dx channel of the block
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int zy0 = y0 / S - 1, zx0 = x0 / S - 1;
  // this thread's pixels: column lx, rows ly0, ly0+2, ly0+4, ly0+6, so all
  // four share the parity that selects the stride-2 conv's taps
  const int ly0 = pg / TW, lx = pg % TW;
  const int ry = (ly0 + 1) % S, rx = (lx + 1) % S;

  float acc[PPT][CPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cout; k0 += KC) {
    const int kend = min(KC, cout - k0);
    for (int i = tid; i < KC * ZH * ZW; i += NT) {
      const int kk = i % KC;
      const int p = i / KC;
      const int ty = p / ZW, tx = p % ZW;
      const int zy = zy0 + ty, zx = zx0 + tx, c = k0 + kk;
      float v = 0.f;
      if (zy >= 0 && zy < Ho && zx >= 0 && zx < Wo && c < cout) {
        const size_t idx = (((size_t)b * Ho + zy) * Wo + zx) * cout + c;
        v = esr::round_to<T>(dz_at<T>(g, outp, idx, act, slope));
      }
      zs[kk][ty][tx] = v;
    }
    for (int i = tid; i < KS * KS * KC * CO; i += NT) {
      const int kk = i % KC;
      const int co = (i / KC) % CO;
      const int t = i / (KC * CO);
      const int c = k0 + kk, ci = cbeg + co;
      ws[t][kk][co] = (c < cout && ci < cin) ? to_f(w[((size_t)t * cin + ci) * cout + c]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kend; ++kk) {
#pragma unroll
      for (int a = 0; a < NTAP; ++a) {
#pragma unroll
        for (int bb = 0; bb < NTAP; ++bb) {
          const int dy = ry + S * a, dxx = rx + S * bb;
          const int tx = (lx + 1 - dxx) / S + 1;
          float wv[CPT];
#pragma unroll
          for (int j = 0; j < CPT; ++j) wv[j] = ws[dy * KS + dxx][kk][cg * CPT + j];
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            const int ty = (ly0 + 2 * i + 1 - dy) / S + 1;
            const float v = zs[kk][ty][tx];
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(v, wv[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int y = y0 + ly0 + 2 * i, xx = x0 + lx;
    if (y >= H || xx >= W) continue;
    const size_t pix = ((size_t)b * H + y) * W + xx;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cbeg + cg * CPT + j;
      if (c < cin) dx[pix * cin + c] = from_f<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// weight and bias gradient:
//   dW[dy, dx, ci, co] = sum_p x[S*i-1+dy, S*j-1+dx, ci] * round_T(dz[p, co])
//   db[co]             = sum_p dz[p, co]                    (unrounded, fp32)
// A thread owns one input channel and SC/16 output channels for all KS*KS
// taps and slides a KSxKS register window along each tile row.
// ---------------------------------------------------------------------------

template <typename T, int SC, int KS>
__global__ void __launch_bounds__(NT) stage_wgrad_kernel(
    const T* __restrict__ x,     // [B, H, W, cin]
    const T* __restrict__ g,     // [B, Ho, Wo, cout]
    const T* __restrict__ outp,  // [B, Ho, Wo, cout] (null for kNone)
    float* __restrict__ part,    // [npart][KS*KS*cin*cout + cout]
    int H, int W, int Ho, int Wo, int cin, int cout, int nco_chunks, int act, float slope,
    int tiles_per_part, int total_tiles, int tiles_x, int tiles_y) {
  constexpr int S = KS == 3 ? 1 : 2;
  constexpr int WTH = KS == 3 ? 8 : 4;    // output tile rows (the 4x4 conv's input tile is twice as large)
  constexpr int WTW = 16;
  constexpr int NCO = SC >= 16 ? 16 : SC;  // output-channel groups
  constexpr int KC = NT / NCO;             // input channels per block
  constexpr int CPT = SC / NCO;
  constexpr int XH = S * (WTH - 1) + KS, XW = S * (WTW - 1) + KS;
  __shared__ float xs[XH][XW][KC];
  __shared__ float dzs[WTH * WTW][SC];
  __shared__ float red[NT];

  const int tid = threadIdx.x;
  const int ci = tid / NCO;
  const int cog = tid % NCO;
  const int cbeg = (blockIdx.x / nco_chunks) * KC;
  const int obeg = (blockIdx.x % nco_chunks) * SC;
  const size_t row = (size_t)KS * KS * cin * cout + cout;
  float* out = part + (size_t)blockIdx.y * row;

  float acc[KS * KS][CPT];
#pragma unroll
  for (int t = 0; t < KS * KS; ++t)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[t][j] = 0.f;
  float dbacc = 0.f;  // this thread always stages output channel tid % SC

  const int tile_end = min(total_tiles, (int)(blockIdx.y + 1) * tiles_per_part);
  for (int tile = blockIdx.y * tiles_per_part; tile < tile_end; ++tile) {
    const int b = tile / (tiles_x * tiles_y);
    const int oy0 = (tile / tiles_x) % tiles_y * WTH, ox0 = tile % tiles_x * WTW;
    for (int i = tid; i < XH * XW * KC; i += NT) {
      const int kk = i % KC;
      const int p = i / KC;
      const int gy = oy0 * S - 1 + p / XW, gx = ox0 * S - 1 + p % XW, c = cbeg + kk;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin)
        v = to_f(x[(((size_t)b * H + gy) * W + gx) * cin + c]);
      xs[p / XW][p % XW][kk] = v;
    }
    for (int i = tid; i < WTH * WTW * SC; i += NT) {
      const int co = i % SC;
      const int p = i / SC;
      const int oy = oy0 + p / WTW, ox = ox0 + p % WTW;
      float v = 0.f;
      if (oy < Ho && ox < Wo && obeg + co < cout)
        v = dz_at<T>(g, outp, (((size_t)b * Ho + oy) * Wo + ox) * cout + obeg + co, act, slope);
      dbacc += v;
      dzs[p][co] = esr::round_to<T>(v);
    }
    __syncthreads();
    for (int y = 0; y < WTH; ++y) {
      float a[KS][KS];
#pragma unroll
      for (int dy = 0; dy < KS; ++dy)
#pragma unroll
        for (int dx = 0; dx < KS - S; ++dx) a[dy][dx] = xs[S * y + dy][dx][ci];
#pragma unroll
      for (int px = 0; px < WTW; ++px) {
        float d[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) d[j] = dzs[y * WTW + px][cog + NCO * j];
#pragma unroll
        for (int dy = 0; dy < KS; ++dy) {
#pragma unroll
          for (int dx = KS - S; dx < KS; ++dx) a[dy][dx] = xs[S * y + dy][S * px + dx][ci];
#pragma unroll
          for (int dx = 0; dx < KS; ++dx)
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              acc[dy * KS + dx][j] = fmaf(a[dy][dx], d[j], acc[dy * KS + dx][j]);
#pragma unroll
          for (int dx = 0; dx < KS - S; ++dx) a[dy][dx] = a[dy][dx + S];
        }
      }
    }
    __syncthreads();
  }

  if (cbeg + ci < cin) {
#pragma unroll
    for (int t = 0; t < KS * KS; ++t)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int co = obeg + cog + NCO * j;
        if (co < cout) out[((size_t)t * cin + cbeg + ci) * cout + co] = acc[t][j];
      }
  }
  if (cbeg == 0) {  // db from the staged, unrounded dz, in a fixed order
    red[tid] = dbacc;
    __syncthreads();
    if (tid < SC && obeg + tid < cout) {
      float v = 0.f;
      for (int k = 0; k < NT / SC; ++k) v += red[tid + SC * k];
      out[(size_t)KS * KS * cin * cout + obeg + tid] = v;
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in that order.
__global__ void stage_wgrad_finish_kernel(const float* __restrict__ part, int npart,
                                          size_t row, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= row) return;
  float v = 0.f;
  for (int p = 0; p < npart; ++p) v += part[(size_t)p * row + i];
  out[i] = v;
}

struct StageArgs {
  const void *x, *w, *g, *outp;
  const float* bias;
  void* out;       // forward: the output; dgrad: dx
  float *part, *dwdb;
  int B, H, W, Ho, Wo, cin, cout, act, npart;
  float slope;
};

template <typename T, int CO, int KS>
int launch_fwd(const StageArgs& a, cudaStream_t st) {
  const int nchunk = a.cout / CO;
  const dim3 grid((a.Wo + TW - 1) / TW, (a.Ho + TH - 1) / TH, a.B * nchunk);
  stage_fwd_kernel<T, CO, KS><<<grid, NT, 0, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w), a.bias, static_cast<T*>(a.out),
      a.H, a.W, a.Ho, a.Wo, a.cin, a.cout, nchunk, a.act, a.slope);
  return (int)cudaGetLastError();
}

template <typename T, int CO, int KS>
int launch_dgrad(const StageArgs& a, cudaStream_t st) {
  const int nchunk = (a.cin + CO - 1) / CO;
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, a.B * nchunk);
  stage_dgrad_kernel<T, CO, KS><<<grid, NT, 0, st>>>(
      static_cast<const T*>(a.g), static_cast<const T*>(a.outp), static_cast<const T*>(a.w),
      static_cast<T*>(a.out), a.H, a.W, a.Ho, a.Wo, a.cin, a.cout, nchunk, a.act, a.slope);
  return (int)cudaGetLastError();
}

template <typename T, int SC, int KS>
int launch_wgrad(const StageArgs& a, cudaStream_t st) {
  constexpr int KC = NT / (SC >= 16 ? 16 : SC);
  constexpr int WTH = KS == 3 ? 8 : 4, WTW = 16;
  const int tiles_x = (a.Wo + WTW - 1) / WTW, tiles_y = (a.Ho + WTH - 1) / WTH;
  const int total = a.B * tiles_x * tiles_y;
  const int per = (total + a.npart - 1) / a.npart;
  const int nco_chunks = (a.cout + SC - 1) / SC;
  const dim3 grid(((a.cin + KC - 1) / KC) * nco_chunks, a.npart);
  stage_wgrad_kernel<T, SC, KS><<<grid, NT, 0, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), static_cast<const T*>(a.outp),
      a.part, a.H, a.W, a.Ho, a.Wo, a.cin, a.cout, nco_chunks, a.act, a.slope, per, total,
      tiles_x, tiles_y);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t row = (size_t)KS * KS * a.cin * a.cout + a.cout;
  stage_wgrad_finish_kernel<<<(unsigned)((row + 255) / 256), 256, 0, st>>>(a.part, a.npart, row,
                                                                          a.dwdb);
  return (int)cudaGetLastError();
}

enum Op : int { kFwd = 0, kDgrad = 1, kWgrad = 2 };

template <typename T, int C, int KS>
int dispatch_op(int op, const StageArgs& a, cudaStream_t st) {
  if (op == kFwd) return launch_fwd<T, C, KS>(a, st);
  if (op == kDgrad) return launch_dgrad<T, C, KS>(a, st);
  return launch_wgrad<T, C, KS>(a, st);
}

// `chunk`: output channels per block (forward, wgrad) or dx channels (dgrad).
template <typename T, int KS>
int dispatch_chunk(int op, int chunk, const StageArgs& a, cudaStream_t st) {
  switch (chunk) {
    case 8: return dispatch_op<T, 8, KS>(op, a, st);
    case 16: return dispatch_op<T, 16, KS>(op, a, st);
    case 32: return dispatch_op<T, 32, KS>(op, a, st);
    case 64: return dispatch_op<T, 64, KS>(op, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int dtype, int ks, int op, int chunk, const StageArgs& a, cudaStream_t st) {
  if (ks != 3 && ks != 4) return (int)cudaErrorInvalidValue;
  if (dtype == esr::kFloat32)
    return ks == 3 ? dispatch_chunk<float, 3>(op, chunk, a, st)
                   : dispatch_chunk<float, 4>(op, chunk, a, st);
  if (dtype == esr::kBFloat16)
    return ks == 3 ? dispatch_chunk<__nv_bfloat16, 3>(op, chunk, a, st)
                   : dispatch_chunk<__nv_bfloat16, 4>(op, chunk, a, st);
  return (int)cudaErrorInvalidValue;
}

StageArgs geometry(int ks, int B, int H, int W, int cin, int cout, int act, float slope) {
  StageArgs a{};
  a.B = B, a.H = H, a.W = W, a.cin = cin, a.cout = cout, a.act = act, a.slope = slope;
  a.Ho = ks == 3 ? H : H / 2;
  a.Wo = ks == 3 ? W : W / 2;
  return a;
}

}  // namespace

extern "C" {

// ks = 3: SAME 3x3 stride 1; ks = 4: 4x4 stride 2 pad 1 (H and W even).
// x [B,H,W,cin], w [ks,ks,cin,cout], bias fp32 [cout] -> out [B,Ho,Wo,cout].
// `chunk` divides cout. Every function returns cudaGetLastError().
int esr_stage_fwd(int dtype, int ks, int chunk, const void* x, const void* w, const float* bias,
                  void* out, int B, int H, int W, int cin, int cout, int act, float slope,
                  void* stream) {
  if (cout % chunk) return (int)cudaErrorInvalidValue;
  StageArgs a = geometry(ks, B, H, W, cin, cout, act, slope);
  a.x = x, a.w = w, a.bias = bias, a.out = out;
  return dispatch(dtype, ks, kFwd, chunk, a, static_cast<cudaStream_t>(stream));
}

// dx [B,H,W,cin] from the cotangent g and the saved output outp (both
// [B,Ho,Wo,cout]; outp may be null when act is none). `chunk` dx channels per block.
int esr_stage_dgrad(int dtype, int ks, int chunk, const void* g, const void* outp, const void* w,
                    void* dx, int B, int H, int W, int cin, int cout, int act, float slope,
                    void* stream) {
  if (act != kNone && !outp) return (int)cudaErrorInvalidValue;
  StageArgs a = geometry(ks, B, H, W, cin, cout, act, slope);
  a.g = g, a.outp = outp, a.w = w, a.out = dx;
  return dispatch(dtype, ks, kDgrad, chunk, a, static_cast<cudaStream_t>(stream));
}

// dwdb[0 : ks*ks*cin*cout] = dW (HWIO), dwdb[ks*ks*cin*cout :] = db, both
// fp32. `part` is an fp32 workspace of npart * (ks*ks*cin*cout + cout) floats.
int esr_stage_wgrad(int dtype, int ks, int chunk, const void* x, const void* g, const void* outp,
                    float* part, int npart, float* dwdb, int B, int H, int W, int cin, int cout,
                    int act, float slope, void* stream) {
  if (npart < 1 || (act != kNone && !outp)) return (int)cudaErrorInvalidValue;
  StageArgs a = geometry(ks, B, H, W, cin, cout, act, slope);
  a.x = x, a.g = g, a.outp = outp, a.part = part, a.npart = npart, a.dwdb = dwdb;
  return dispatch(dtype, ks, kWgrad, chunk, a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
