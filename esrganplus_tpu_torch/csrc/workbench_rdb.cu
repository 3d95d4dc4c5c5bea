// The workbench's fused ResidualDenseBlock: a whole ESRGAN+ RDB in one launch,
// one block per output tile (NHWC, by-source weights, sm_90a).
//
// Replaces esrganplus_tpu/kernels/workbench/rdb.py (rdb_fused, the Pallas
// kernel _rdb_kernel, :84-149). The block reads its TxT tile of x once with a
// 5-pixel halo (zero outside the image) into shared memory; x1..x4 are
// computed on shrinking haloed regions (sides T+8, T+6, T+4, T+2) that never
// leave shared memory, and only the block output TxT is written back. Each
// intermediate is zero outside the image (never computed there), which is
// exactly the reference's per-conv SAME zero padding.
//
// Rounding is the TPU kernel's: its _conv_stage rounds every per-source
// contribution tensor to the activation dtype T before any sum (:71-81).
// Here the work runs by target: for each output channel of x_j the K loop
// is split at source boundaries (x, x1, .., x_{j-1}); each source's fp32
// partial sum is rounded to T and then added in fp32, in source order, then
// the fp32 bias. x_j = lrelu(that) (x2 then adds the T-rounded 1x1 shortcut,
// which is w0's last gc lanes at the centre tap; x4 adds x2), rounded to T
// once. x5 is the fp32 sum of the five rounded contributions plus b5, and
// out = x5 * res_scale + x in fp32 with one rounding (:146-149). Products
// are activations x weights in fp32; the weights keep the dtype WT the prep
// gave them (bf16 weights with fp32 activations is the JAX default).
//
// Weights: w_i [3 (kw), 3*C_i (kh-major), width_i], lanes
// [t5 (nf) | t4 | t3 | t2 | t1 | (1x1, w0 only)], read in place from global
// memory (they do not fit beside the activations in shared memory): a
// thread's 8 output channels are 8 contiguous lanes, one 16-byte (bf16) or
// two 16-byte (fp32) loads, the same address across a warp.
//
// Bound on this card: operations. One RDB is 241,664 MAC per pixel at
// nf=64, gc=32; this kernel recomputes the halo (at T=16 about 324 k MAC per
// output pixel, 1.34x; at T=8 430 k, 1.78x) to keep x1..x4 on chip. This
// first version accumulates on the CUDA cores in fp32 (tensor cores are later
// work), under the 67 TFLOP/s fp32 CUDA-core roof. What the design does: the
// activations sit in shared memory channel-planar ([c][pixel]), so a warp's
// 32 lanes read 32 neighbouring pixels of one channel (no bank conflicts),
// and each thread keeps a 4-pixel x 8-channel register tile (plus the
// per-source partial), so one weight vector load feeds 32 FMAs. The tile T
// is a launch argument (the wrapper's KERNEL_TILE, 8: ~86 KB of shared memory
// at nf=64, gc=32 in bf16, 172 KB in fp32; T=16 needs ~200 KB in bf16 and
// leaves half of the card's SMs idle at 128^2).
#include <cstdint>

#include "common.cuh"

namespace esr {
namespace wbrdb {

constexpr int NT = 256;  // threads per block
constexpr int CPT = 8;   // output channels per thread (8 contiguous weight lanes)
constexpr int PPT = 4;   // pixels per thread, 32 apart (lane-contiguous across a warp)

__device__ __forceinline__ void load_w(const float* p, float (&w)[CPT]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void load_w(const __nv_bfloat16* p, float (&w)[CPT]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// lrelu with the product kept a separate rounding (no contraction into a
// following add), as the reference's where(t >= 0, t, t * slope)
__device__ __forceinline__ float lrelu_rn(float v, float slope) {
  return v >= 0.f ? v : __fmul_rn(v, slope);
}

template <typename T, typename WT>
struct Block {
  const WT* w[5];  // by-source weights
  int wid[5];      // lane count of each (its row stride)
  int cin[5];      // channels of each source
  T* s[5];         // shared planes x, x1..x4: [c][side * side]
  int side[6];     // region side of x_j (j = 0..4) and of the output (j = 5)
  int nf, gc, H, W, ty0, tx0, conv1x1;
  float slope;
};

// Target j (1..5) of one block: compute x_j on its region (x_5 = the output
// tile), zero it outside the image (j < 5), store x_j to its plane or the
// block output to `out`.
template <int J, typename T, typename WT>
__device__ __forceinline__ void stage(const Block<T, WT>& k, T* __restrict__ out, size_t img,
                                      float res_scale, const float* __restrict__ bias) {
  constexpr int j = J;
  const int m = 5 - j;                      // halo of region j
  const int L = k.side[j];
  const int S = j == 5 ? k.nf : k.gc;       // output channels
  const int lane0 = j == 5 ? 0 : k.nf + (4 - j) * k.gc;  // lane offset of target j
  const float* b = bias + lane0;
  // the part of region j inside the image, local coordinates [u0, u1) x [v0, v1)
  const int u0 = max(0, m - k.ty0), u1 = min(L, k.H - k.ty0 + m);
  const int v0 = max(0, m - k.tx0), v1 = min(L, k.W - k.tx0 + m);
  const int tid = threadIdx.x;

  if (j < 5) {  // zero ring outside the image: SAME padding of the next convs
    T* plane = k.s[J % 5];  // J < 5 here
    for (int i = tid; i < L * L; i += NT) {
      const int u = i / L, v = i % L;
      if (u < u0 || u >= u1 || v < v0 || v >= v1)
        for (int c = 0; c < S; ++c) plane[c * L * L + i] = from_f<T>(0.f);
    }
  }
  if (u1 <= u0 || v1 <= v0) return;
  const int rw = v1 - v0;
  const int npix = (u1 - u0) * rw;
  const int ncg = S / CPT;
  const int npc = (npix + 32 * PPT - 1) / (32 * PPT) * 32;  // pixel chunks per group, x32
  for (int unit = tid; unit < ncg * npc; unit += NT) {
    const int cg = unit / npc;
    const int pc = unit % npc;
    const int qbase = (pc / 32) * 32 * PPT + pc % 32;
    int pu[PPT], pv[PPT];
    bool valid[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int q = qbase + 32 * i;
      valid[i] = q < npix;
      const int qq = valid[i] ? q : 0;
      pu[i] = u0 + qq / rw;
      pv[i] = v0 + qq % rw;
    }

    float tot[PPT][CPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) tot[i][c] = 0.f;

#pragma unroll
    for (int src = 0; src < j; ++src) {
      const int Ls = k.side[src];
      const int plane = Ls * Ls;
      const int o = j - src - 1;  // source pixel of tap (0, 0) is (u + o, v + o)
      const int C = k.cin[src];
      const int wid = k.wid[src];
      float part[PPT][CPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) part[i][c] = 0.f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const WT* wp = k.w[src] + (size_t)(kw * 3 * C + kh * C) * wid + lane0 + cg * CPT;
          const T* sp[PPT];
#pragma unroll
          for (int i = 0; i < PPT; ++i)
            sp[i] = k.s[src] + (pu[i] + o + kh) * Ls + (pv[i] + o + kw);
#pragma unroll 2
          for (int c = 0; c < C; ++c) {
            float wv[CPT];
            load_w(wp + (size_t)c * wid, wv);
#pragma unroll
            for (int i = 0; i < PPT; ++i) {
              const float a = to_f(sp[i][c * plane]);
#pragma unroll
              for (int q = 0; q < CPT; ++q) part[i][q] = fmaf(a, wv[q], part[i][q]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < PPT; ++i)
#pragma unroll
        for (int q = 0; q < CPT; ++q) tot[i][q] = __fadd_rn(tot[i][q], round_to<T>(part[i][q]));
    }

    // the 1x1 shortcut onto x2: w0's last gc lanes at the centre tap, rounded
    float c11[PPT][CPT];
    const bool has11 = J == 2 && k.conv1x1;
    if (has11) {
      const int Ls = k.side[0], plane = Ls * Ls, C = k.nf, wid = k.wid[0];
      const WT* wp = k.w[0] + (size_t)(1 * 3 * C + 1 * C) * wid + k.nf + 4 * k.gc + cg * CPT;
#pragma unroll
      for (int i = 0; i < PPT; ++i)
#pragma unroll
        for (int q = 0; q < CPT; ++q) c11[i][q] = 0.f;
      for (int c = 0; c < C; ++c) {
        float wv[CPT];
        load_w(wp + (size_t)c * wid, wv);
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float a = to_f(k.s[0][c * plane + (pu[i] + 2) * Ls + pv[i] + 2]);
#pragma unroll
          for (int q = 0; q < CPT; ++q) c11[i][q] = fmaf(a, wv[q], c11[i][q]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (!valid[i]) continue;
      const int u = pu[i], v = pv[i];
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int c = cg * CPT + q;
        float val = __fadd_rn(tot[i][q], b[c]);
        if (j == 5) {
          const int L0 = k.side[0];
          const float xv = to_f(k.s[0][c * L0 * L0 + (u + 5) * L0 + v + 5]);
          const int gy = k.ty0 + u, gx = k.tx0 + v;
          out[(img + (size_t)gy * k.W + gx) * k.nf + c] =
              from_f<T>(__fadd_rn(__fmul_rn(val, res_scale), xv));
          continue;
        }
        val = lrelu_rn(val, k.slope);
        if (has11) val = __fadd_rn(val, round_to<T>(c11[i][q]));
        if (j == 4) {  // x4 += x2 (x2's region is 2 pixels wider on each side)
          const int L2 = k.side[2];
          val = __fadd_rn(val, to_f(k.s[2][c * L2 * L2 + (u + 2) * L2 + v + 2]));
        }
        k.s[J % 5][c * L * L + u * L + v] = from_f<T>(val);  // J < 5 here
      }
    }
  }
}

template <typename T, typename WT>
__global__ void __launch_bounds__(NT, 1) wb_rdb_fused_kernel(
    const T* __restrict__ x, const WT* __restrict__ w0, const WT* __restrict__ w1,
    const WT* __restrict__ w2, const WT* __restrict__ w3, const WT* __restrict__ w4,
    const float* __restrict__ bias, T* __restrict__ out, int H, int W, int nf, int gc,
    int conv1x1, float slope, float res_scale, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Block<T, WT> k;
  k.w[0] = w0; k.w[1] = w1; k.w[2] = w2; k.w[3] = w3; k.w[4] = w4;
  k.nf = nf; k.gc = gc; k.H = H; k.W = W; k.conv1x1 = conv1x1; k.slope = slope;
  k.ty0 = blockIdx.y * tile;
  k.tx0 = blockIdx.x * tile;
  k.wid[0] = nf + 4 * gc + (conv1x1 ? gc : 0);
  k.cin[0] = nf;
  for (int i = 1; i < 5; ++i) {
    k.wid[i] = nf + (4 - i) * gc;
    k.cin[i] = gc;
  }
  for (int j = 0; j < 6; ++j) k.side[j] = tile + 2 * (5 - j);
  T* p = reinterpret_cast<T*>(smem_raw);
  for (int i = 0; i < 5; ++i) {
    k.s[i] = p;
    p += (size_t)k.cin[i] * k.side[i] * k.side[i];
  }
  const size_t img = (size_t)blockIdx.z * H * W;

  // x with halo 5, channel-planar, zero outside the image
  {
    const int L0 = k.side[0];
    for (int i = threadIdx.x; i < nf * L0 * L0; i += NT) {
      const int c = i % nf, pix = i / nf;
      const int gy = k.ty0 - 5 + pix / L0, gx = k.tx0 - 5 + pix % L0;
      T v = from_f<T>(0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = x[(img + (size_t)gy * W + gx) * nf + c];
      k.s[0][c * L0 * L0 + pix] = v;
    }
  }
  __syncthreads();
  stage<1>(k, out, img, res_scale, bias);
  __syncthreads();
  stage<2>(k, out, img, res_scale, bias);
  __syncthreads();
  stage<3>(k, out, img, res_scale, bias);
  __syncthreads();
  stage<4>(k, out, img, res_scale, bias);
  __syncthreads();
  stage<5>(k, out, img, res_scale, bias);
}

template <typename T, typename WT>
int launch(const void* x, const void* const* w, const float* bias, void* out, int B, int H,
           int W, int nf, int gc, int conv1x1, float slope, float res_scale, int tile,
           int smem, cudaStream_t stream) {
  auto kern = wb_rdb_fused_kernel<T, WT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const WT*>(w[0]), static_cast<const WT*>(w[1]),
      static_cast<const WT*>(w[2]), static_cast<const WT*>(w[3]), static_cast<const WT*>(w[4]),
      bias, static_cast<T*>(out), H, W, nf, gc, conv1x1, slope, res_scale, tile);
  return (int)cudaGetLastError();
}

}  // namespace wbrdb
}  // namespace esr

// Shared memory one block needs: x with halo 5 and x1..x4 with halos 4..1
// (kernels/workbench/rdb.py::smem_bytes picks the tile by the same count).
static int wb_rdb_smem(int dtype, int nf, int gc, int tile) {
  const int esz = dtype == esr::kFloat32 ? 4 : 2;
  long n = (long)nf * (tile + 10) * (tile + 10);
  for (int j = 1; j < 5; ++j) n += (long)gc * (tile + 2 * (5 - j)) * (tile + 2 * (5 - j));
  return (int)(n * esz);
}

extern "C" {

// One fused RDB over x [B, H, W, nf] (dtype) with by-source weights w0..w4
// (wdtype) and the fp32 bias [nf + 4 gc] (b5|b4|b3|b2|b1) into out, kernel
// tile `tile`. nf and gc must be multiples of 8. Returns cudaGetLastError().
int esr_wb_rdb_fused(int dtype, int wdtype, const void* x, const void* w0, const void* w1,
                     const void* w2, const void* w3, const void* w4, const float* bias,
                     void* out, int B, int H, int W, int nf, int gc, int conv1x1, float slope,
                     float res_scale, int tile, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || nf % 8 || gc % 8 || nf <= 0 || gc <= 0 || tile <= 0)
    return (int)cudaErrorInvalidValue;
  const void* w[5] = {w0, w1, w2, w3, w4};
  const int smem = wb_rdb_smem(dtype, nf, gc, tile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == esr::kBFloat16 && wdtype == esr::kBFloat16)
    return esr::wbrdb::launch<bf16, bf16>(x, w, bias, out, B, H, W, nf, gc, conv1x1, slope,
                                          res_scale, tile, smem, s);
  if (dtype == esr::kFloat32 && wdtype == esr::kFloat32)
    return esr::wbrdb::launch<float, float>(x, w, bias, out, B, H, W, nf, gc, conv1x1, slope,
                                            res_scale, tile, smem, s);
  if (dtype == esr::kFloat32 && wdtype == esr::kBFloat16)
    return esr::wbrdb::launch<float, bf16>(x, w, bias, out, B, H, W, nf, gc, conv1x1, slope,
                                           res_scale, tile, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
