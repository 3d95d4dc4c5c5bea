// The workbench's fused ResidualDenseBlock: a whole ESRGAN+ RDB in one launch,
// one block per output tile (NHWC, by-source weights, sm_90a).
//
// Replaces esrganplus_tpu/kernels/workbench/rdb.py (rdb_fused, the Pallas
// kernel _rdb_kernel, :84-149). The block reads its tile of x once with a
// 5-pixel halo (zero outside the image) into shared memory; x1..x4 are
// computed on shrinking haloed regions (halos 4, 3, 2, 1) that never leave
// shared memory, and only the block output is written back. Each
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
// are activations x weights; the weights keep the dtype WT the prep gave
// them (bf16 weights with fp32 activations is the JAX default).
//
// Weights: w_i [3 (kw), 3*C_i (kh-major), width_i], lanes
// [t5 (nf) | t4 | t3 | t2 | t1 | (1x1, w0 only)]; 516 KB of them in bf16 at
// nf=64, gc=32, which do not fit beside the activations in shared memory.
//
// Bound on this card: operations. One RDB is 241,664 MAC per pixel at
// nf=64, gc=32; keeping x1..x4 on chip costs the halo's recompute (1.34x at
// a 16x16 tile, 1.55x at 8x16, 1.78x at 8x8). Two designs, picked by the
// wrapper (kernels/workbench/rdb.py rdb_design) from the dtype pair; the C
// entry refuses any other:
//   * "mma" (bf16 activations and weights): wb_rdb_mma_kernel on the tensor
//     cores (mma.sync m16n8k16 bf16 -> fp32 fed by ldmatrix,
//     csrc/mma_tile.cuh). x and x1..x4 sit in shared memory as [pixel]
//     [channel] planes (channels padded to 16 with zeros, rows of odd 16-byte
//     units: no ldmatrix bank conflicts). Target j runs one implicit GEMM per
//     source i < j: M is target j's region (flattened, padded to m16 tiles),
//     N its gc (nf for x5) channels, K = 9 x C_i, and a lane's ldmatrix row
//     for tap (kh, kw) is source pixel (u + j-i-1 + kh, v + j-i-1 + kw), so
//     any region side works. N runs in passes of GC_PASS (NF_PASS for x5)
//     columns, one pass at nf <= 64, gc <= 32; each warp owns a pass's whole
//     N and a set of m16 tiles (one A fragment feeds four or eight n8
//     products, one B fragment every m16 tile of the warp) and keeps three
//     accumulator sets: the source's fp32 partial as a (hi, lo) pair and the
//     target's running sum, which takes the partial rounded to bf16: the
//     by-source rounding in registers, nothing stored per source. Each pair of
//     k-steps starts from zero and joins the partial through an error-free
//     TwoSum (warp_mma_n: the 1 % bar). The weights stream (target, pass,
//     source, tap, K chunk of K_SLOT rows) through a 3-slot cp.async ring,
//     the 1x1 as one more tap after target 2's sources. The tile is 8x16
//     at nf <= 64, gc <= 32 (156 KB of planes + 27 KB of ring at nf=64,
//     gc=32: one block an SM, 128 blocks at 128^2, one wave; one pass and
//     one K chunk, fixed at compile time), else 8x8 (102 KB at the flagship
//     widths, 256 blocks, 1.78x recompute against 1.55x; 1.7x slower on the
//     H100 there), else 4x8 (every width the FMA kernel's tile 8 fits in
//     bf16 fits here too); all give the same bits, since no per-pixel sum
//     depends on the tile.
//   * "fma" (fp32 activations, with fp32 or bf16 weights: the 1e-4 bar of
//     fp32 is one TF32 would miss): wb_rdb_fused_kernel on the CUDA cores in
//     fp32, square tile T. The activations sit in shared memory
//     channel-planar ([c][pixel]), so a warp's 32 lanes read 32 neighbouring
//     pixels of one channel (no bank conflicts), and each thread keeps a
//     4-pixel x 8-channel register tile (plus the per-source partial), so one
//     weight vector load (read in place from global memory: a thread's 8
//     output channels are 8 contiguous lanes, the same address across a warp)
//     feeds 32 FMAs. The tile T is a launch argument (the wrapper's
//     KERNEL_TILE, 8: 172 KB of shared memory at nf=64, gc=32 in fp32).
#include <cstdint>

#include "common.cuh"
#include "mma_tile.cuh"

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

// ---------------------------------------------------------------------------
// the bf16 tensor-core design
// ---------------------------------------------------------------------------

namespace wbrdb_mma {

using esr::mma::cp_async16;
using esr::mma::ldsm_pitch;
using esr::mma::smem_u32;
using esr::tile::bf16;
using esr::tile::round16;

constexpr int NW = 8;           // warps of a block
constexpr int NTH = NW * 32;    // threads
constexpr int NSLOT = 3;        // weight-ring depth
constexpr int GC_PASS = 32;     // columns of a target x1..x4 per pass: 4 n8 tiles
constexpr int NF_PASS = 64;     // columns of the target x5 per pass: 8 n8 tiles
constexpr int K_SLOT = 64;      // K rows (source channels) of a ring slot
constexpr int WPG = ldsm_pitch(GC_PASS);   // ring row pitch of targets 1..4 (80 B)
constexpr int WPF = ldsm_pitch(NF_PASS);   // of target 5 (144 B)
constexpr int SLOT = K_SLOT * WPF;         // a ring slot

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Target j's region (j = 0: x's) on a TH x TW tile: halo 5 - j, flattened
// row-major, padded to m16 tiles; the warps take its m16 tiles round-robin,
// each owning all of a pass's N, except that x5 on a tile of fewer m16 tiles
// than warps splits N in two halves (kernels/workbench/rdb.py mma_regions).
template <int TH, int TW>
struct Geo {
  __host__ __device__ static constexpr int rh(int j) { return TH + 2 * (5 - j); }
  __host__ __device__ static constexpr int rw(int j) { return TW + 2 * (5 - j); }
  __host__ __device__ static constexpr int pix(int j) { return rh(j) * rw(j); }
  __host__ __device__ static constexpr int nmt(int j) { return (pix(j) + 15) / 16; }
  __host__ __device__ static constexpr int nsplit(int j) { return j == 5 && nmt(5) < NW ? 2 : 1; }
  __host__ __device__ static constexpr int nt8(int j) {
    return (j == 5 ? NF_PASS : GC_PASS) / (8 * nsplit(j));
  }
  __host__ __device__ static constexpr int mt(int j) {
    return (nmt(j) * nsplit(j) + NW - 1) / NW;
  }
};

// Shared memory of a block: the five planes and the ring.
__host__ __device__ constexpr int smem_bytes(int nf, int gc, int th, int tw) {
  int n = (th + 10) * (tw + 10) * ldsm_pitch(round16(nf));
  for (int j = 1; j < 5; ++j)
    n += (th + 2 * (5 - j)) * (tw + 2 * (5 - j)) * ldsm_pitch(round16(gc));
  return n + NSLOT * SLOT;
}

struct Args {
  const bf16* x;
  const bf16* w[5];
  const float* bias;
  bf16* out;
  int H, W, nf, gc, conv1x1;
  float slope, res_scale;
};

// The ring's stages: per target j, pass p, source i < j (then, for target 2
// with the 1x1, i == j: x at the centre tap), tap t and K chunk kc of
// K_SLOT rows (kernels/workbench/rdb.py mma_stages lists them).
struct Stage {
  int j, p, i, t, kc;
};

__device__ __forceinline__ int stages_per_pass(const Args& a, int j, int nk0, int nkg) {
  return 9 * (nk0 + (j - 1) * nkg) + (j == 2 && a.conv1x1 ? nk0 : 0);
}

// The block's state: where the planes and the ring are, the ring's next
// stage to consume and the next to load.
struct Ctx {
  unsigned char* sm;  // the block's shared memory (generic), and as a shared address:
  uint32_t sm32;
  int off[5];      // byte offset of each plane x, x1..x4
  int ring;        // byte offset of the ring
  int px, pg;      // row pitch of x's plane and of x1..x4's
  int nfp, gcp;    // channels padded to 16
  int nk0, nkg;    // K chunks of a tap of x and of x1..x4
  int npf, npg;    // passes of x5's columns and of x1..x4's
  int ty0, tx0, b, tid, lane, warp;
  int s, nstage;   // next ring stage, stage count
  Stage next;      // the stage the next load_w fills
};

// The stage after st, in the order above.
__device__ __forceinline__ void advance(const Args& a, const Ctx& c, Stage& st) {
  const bool x_rows = st.i == 0 || st.i == st.j;
  if (++st.kc < (x_rows ? c.nk0 : c.nkg)) return;
  st.kc = 0;
  if (st.i < st.j) {
    if (++st.t < 9) return;
    st.t = 0;
    if (++st.i < st.j) return;
    if (st.j == 2 && a.conv1x1) {  // the 1x1 after target 2's sources
      st.t = 4;
      return;
    }
  }
  st.i = st.t = 0;
  if (++st.p < (st.j == 5 ? c.npf : c.npg)) return;
  st.p = 0;
  ++st.j;
}

// Stage c.next's weights into ring slot s % NSLOT, then advance c.next:
// source i's rows kc * K_SLOT .. at tap t (zero to round16(C_i)) x the
// pass's columns of target j (zero past gc / nf).
__device__ __forceinline__ void load_w(const Args& a, Ctx& c, int s) {
  const Stage st = c.next;
  advance(a, c, c.next);
  const bool is11 = st.i == st.j;
  const int src = is11 ? 0 : st.i;
  const int C = src == 0 ? a.nf : a.gc;
  const int r0 = st.kc * K_SLOT;
  const int rows = min(K_SLOT, (src == 0 ? c.nfp : c.gcp) - r0);
  const int wid = src == 0 ? a.nf + 4 * a.gc + (a.conv1x1 ? a.gc : 0) : a.nf + (4 - src) * a.gc;
  const int kh = st.t / 3, kw = st.t % 3;
  const int N = st.j == 5 ? a.nf : a.gc;
  const int col0 = st.p * (st.j == 5 ? NF_PASS : GC_PASS);
  const int lane0 = (is11 ? a.nf + 4 * a.gc : (st.j == 5 ? 0 : a.nf + (4 - st.j) * a.gc)) + col0;
  const int nc8 = (st.j == 5 ? NF_PASS : GC_PASS) / 8, wp = st.j == 5 ? WPF : WPG;
  const bf16* base = a.w[src];
  const bf16* wsrc = base + (size_t)(kw * 3 * C + kh * C + r0) * wid + lane0;
  const uint32_t dst = c.sm32 + c.ring + (s % NSLOT) * SLOT;
  for (int q = c.tid; q < rows * nc8; q += NTH) {
    const int r = q / nc8, c8 = q % nc8;
    const bool ok = r0 + r < C && col0 + c8 * 8 < N;
    cp_async16(dst + r * wp + c8 * 16, ok ? wsrc + (size_t)r * wid + c8 * 8 : base, ok);
  }
}

// Wait for stage c.s, queue stage c.s + 2, and return stage c.s's slot.
__device__ __forceinline__ uint32_t ring_step(const Args& a, Ctx& c) {
  esr::mma::cp_async_wait<1>();  // x's tile and stage s have landed
  __syncthreads();               // ... for every thread; slot (s+2) % 3 is free
  if (c.s + 2 < c.nstage) load_w(a, c, c.s + 2);
  esr::mma::cp_async_commit();
  return c.sm32 + c.ring + (c.s++ % NSLOT) * SLOT;
}

// d = a * b on the tensor cores from a zero accumulator: one 16x8x16 bf16
// product, its 16-term sums not chained onto a running fp32 sum.
__device__ __forceinline__ void mma_bf16_fresh(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// (hi, lo) += d with Knuth's TwoSum: hi takes the rounded sum, lo gathers
// each add's exact rounding error.
__device__ __forceinline__ void two_sum(float& hi, float& lo, float d) {
  const float s = __fadd_rn(hi, d);
  const float bb = __fsub_rn(s, hi);
  lo = __fadd_rn(lo, __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(d, bb)));
  hi = s;
}

// (hi, lo)[k] += A_k * B over klen for this warp's first n m16 tiles
// (warp-uniform n), NT8 n8 tiles from column n0; a[k] is tile k's ldmatrix
// row address. The tensor cores' accumulation truncates, and chained over a
// source's 36 k-steps (K = 576) it moved 0.6-2.1 % of the outputs off the
// twin's (cuDNN fp32) roundings on 14 flagship-width cases, mostly over the
// 1 % bar. So each pair of k-steps starts from zero (a short chain: its
// truncation is relative to a 32-term sum) and joins the partial through an
// error-free TwoSum; the partial is hi + lo. tools/wb_rdb_variants.py
// measures the designs against the twin and an fp64 reference (PERF.md).
template <int MT, int NT8>
__device__ __forceinline__ void warp_mma_n(float (&hi)[MT][NT8][4], float (&lo)[MT][NT8][4],
                                           const uint32_t (&a)[MT], int n, uint32_t bt, int bp,
                                           int n0, int klen, int lane) {
  using namespace esr::mma;
  auto load_b = [&](uint32_t (&bf)[NT8][2], int k) {
#pragma unroll
    for (int q = 0; q < NT8; q += 2) {
      uint32_t r[4];
      ldsm_x4_t(r, bt + (k + (lane & 15)) * bp + (n0 + q * 8 + (lane >> 4) * 8) * 2);
      bf[q][0] = r[0], bf[q][1] = r[1], bf[q + 1][0] = r[2], bf[q + 1][1] = r[3];
    }
  };
  int k = 0;
  for (; k + 32 <= klen; k += 32) {  // two k-steps a fold
    uint32_t b0[NT8][2], b1[NT8][2];
    load_b(b0, k);
    load_b(b1, k + 16);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < n) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, a[i] + k * 2);
        ldsm_x4(a1, a[i] + (k + 16) * 2);
#pragma unroll
        for (int q = 0; q < NT8; ++q) {
          float d[4];
          mma_bf16_fresh(d, a0, b0[q][0], b0[q][1]);
          mma_bf16(d, a1, b1[q][0], b1[q][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) two_sum(hi[i][q][r], lo[i][q][r], d[r]);
        }
      }
    }
  }
  if (k < klen) {  // an odd k-step count (K = 16 a tap): the last one alone
    uint32_t b0[NT8][2];
    load_b(b0, k);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < n) {
        uint32_t a0[4];
        ldsm_x4(a0, a[i] + k * 2);
#pragma unroll
        for (int q = 0; q < NT8; ++q) {
          float d[4];
          mma_bf16_fresh(d, a0, b0[q][0], b0[q][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) two_sum(hi[i][q][r], lo[i][q][r], d[r]);
        }
      }
    }
  }
}

// Target J (1..5): x_J on its region into its plane, zero outside the image
// (J < 5), or the block output into `out` (J = 5), a pass of columns at a
// time.
template <int TH, int TW, int J, bool ONE>
__device__ __forceinline__ void target(const Args& a, Ctx& c) {
  using G = Geo<TH, TW>;
  constexpr int MT = G::mt(J), NT8 = G::nt8(J), NS = G::nsplit(J);
  constexpr int RW = G::rw(J), M = G::pix(J), UNITS = G::nmt(J) * NS;
  static_assert(NS == 1 || MT == 1, "a split N gives a warp one unit");
  const int lane = c.lane, warp = c.warp;
  const int nmine = min(MT, max(0, (UNITS - warp + NW - 1) / NW));  // this warp's m16 tiles
  const int n0 = NS == 2 ? (warp % 2) * NT8 * 8 : 0;
  const int N = J == 5 ? a.nf : a.gc;
  const int lane0 = J == 5 ? 0 : a.nf + (4 - J) * a.gc;

  int pu[MT], pv[MT];  // region pixel of this lane's ldmatrix row in each tile
#pragma unroll
  for (int k = 0; k < MT; ++k) {
    int m = (warp + NW * k) / NS * 16 + (lane & 15);
    if (m >= M) m = 0;  // a padding row: read a real pixel, store nothing
    pu[k] = m / RW;
    pv[k] = m % RW;
  }
  float tot[MT][NT8][4], part[MT][NT8][4], lo[MT][NT8][4];

  // part + lo = source i's GEMM over taps t0 .. t1-1 (o: its tap (0, 0) is
  // pixel (u + o, v + o)), K = round16(C_i) a tap in chunks of K_SLOT
  auto source = [&](int i, int o, int t0, int t1) {
#pragma unroll
    for (int k = 0; k < MT; ++k)
#pragma unroll
      for (int q = 0; q < NT8; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[k][q][r] = lo[k][q][r] = 0.f;
    const int rwi = TW + 2 * (5 - i), pitch = i == 0 ? c.px : c.pg;
    const int klen = i == 0 ? c.nfp : c.gcp;
    uint32_t base[MT];
#pragma unroll
    for (int k = 0; k < MT; ++k)
      base[k] = c.sm32 + c.off[i] + ((pu[k] + o) * rwi + pv[k] + o) * pitch + (lane >> 4) * 16;
    for (int t = t0; t < t1; ++t) {
      const uint32_t shift = ((t / 3) * rwi + t % 3) * pitch;
      for (int k0 = 0; k0 < (ONE ? K_SLOT : klen); k0 += K_SLOT) {
        const uint32_t slot = ring_step(a, c);
        uint32_t ak[MT];
#pragma unroll
        for (int k = 0; k < MT; ++k) ak[k] = base[k] + shift + k0 * 2;
        warp_mma_n<MT, NT8>(part, lo, ak, nmine, slot, J == 5 ? WPF : WPG, n0,
                            ONE ? klen : min(K_SLOT, klen - k0), lane);
      }
    }
  };
  auto add_rounded = [&]() {  // tot += bf16(part + lo), elementwise in fp32
#pragma unroll
    for (int k = 0; k < MT; ++k)
#pragma unroll
      for (int q = 0; q < NT8; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          tot[k][q][r] = __fadd_rn(tot[k][q][r],
                                   round_to<bf16>(__fadd_rn(part[k][q][r], lo[k][q][r])));
  };

  const int npass = ONE ? 1 : J == 5 ? c.npf : c.npg;
  for (int p = 0; p < npass; ++p) {
    const int col0 = p * (J == 5 ? NF_PASS : GC_PASS);  // the pass's first column
#pragma unroll
    for (int k = 0; k < MT; ++k)
#pragma unroll
      for (int q = 0; q < NT8; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) tot[k][q][r] = 0.f;
#pragma unroll
    for (int i = 0; i < J; ++i) {  // the sources in order
      source(i, J - i - 1, 0, 9);
      add_rounded();
    }
    // + the bias (zero past N), then lrelu for x1..x4
#pragma unroll
    for (int q = 0; q < NT8; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = col0 + n0 + q * 8 + (lane & 3) * 2 + e;
        const float bv = n < N ? a.bias[lane0 + n] : 0.f;
#pragma unroll
        for (int k = 0; k < MT; ++k)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = __fadd_rn(tot[k][q][2 * h + e], bv);
            if (J < 5) v = wbrdb::lrelu_rn(v, a.slope);
            tot[k][q][2 * h + e] = v;
          }
      }
    if (J == 2 && a.conv1x1) {  // + the rounded 1x1 shortcut: x at the centre tap, K = nf
      source(0, 1, 4, 5);
      add_rounded();
    }

    // x_J (zero outside the image; x4 adds x2) or out = x5 * res_scale + x
    constexpr int halo = 5 - J;
#pragma unroll
    for (int k = 0; k < MT; ++k) {
      if (k >= nmine) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (warp + NW * k) / NS * 16 + (lane >> 2) + 8 * h;
        if (m >= M) continue;
        const int u = m / RW, v = m % RW;
        const int gy = c.ty0 - halo + u, gx = c.tx0 - halo + v;
        const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
        for (int q = 0; q < NT8; ++q) {
          const int n = col0 + n0 + q * 8 + (lane & 3) * 2;  // even: channels n, n + 1
          float v0 = tot[k][q][2 * h], v1 = tot[k][q][2 * h + 1];
          if constexpr (J == 5) {
            if (!in || n >= a.nf) continue;
            const int r0 = (u + 5) * G::rw(0) + v + 5;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(c.sm + c.off[0] + r0 * c.px + n * 2));
            v0 = __fadd_rn(__fmul_rn(v0, a.res_scale), xv.x);
            v1 = __fadd_rn(__fmul_rn(v1, a.res_scale), xv.y);
            *reinterpret_cast<uint32_t*>(a.out + (((size_t)c.b * a.H + gy) * a.W + gx) * a.nf +
                                         n) = esr::mma::pack_bf16(v0, v1);
          } else {
            if (n >= c.gcp) continue;
            if constexpr (J == 4) {  // x2's region is 2 pixels wider on each side
              const int r2 = (u + 2) * G::rw(2) + v + 2;
              const float2 x2 = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(c.sm + c.off[2] + r2 * c.pg + n * 2));
              v0 = __fadd_rn(v0, x2.x);
              v1 = __fadd_rn(v1, x2.y);
            }
            *reinterpret_cast<uint32_t*>(c.sm + c.off[J] + m * c.pg + n * 2) =
                in ? esr::mma::pack_bf16(v0, v1) : 0u;
          }
        }
      }
    }
  }
}

// The 8x16 tile runs one pass and one K chunk a tap only (nf <= NF_PASS,
// gc <= GC_PASS: the flagship widths), with those loop counts fixed at
// compile time, which runs faster; 8x8 and 4x8 take any widths that fit.
template <int TH, int TW>
__host__ __device__ constexpr bool one_pass_tile() {
  return TH == 8 && TW == 16;
}

template <int TH, int TW>
__global__ void __launch_bounds__(NTH, 1) wb_rdb_mma_kernel(const __grid_constant__ Args a) {
  using G = Geo<TH, TW>;
  constexpr bool ONE = one_pass_tile<TH, TW>();
  extern __shared__ __align__(128) unsigned char smem[];
  Ctx c;
  c.sm = smem;
  c.sm32 = smem_u32(smem);
  c.nfp = round16(a.nf);
  c.gcp = round16(a.gc);
  c.px = ldsm_pitch(c.nfp);
  c.pg = ldsm_pitch(c.gcp);
  c.off[0] = 0;
  int o = G::pix(0) * c.px;
  for (int i = 1; i < 5; ++i) {
    c.off[i] = o;
    o += (TH + 2 * (5 - i)) * (TW + 2 * (5 - i)) * c.pg;
  }
  c.ring = o;
  c.ty0 = blockIdx.y * TH;
  c.tx0 = blockIdx.x * TW;
  c.b = blockIdx.z;
  c.tid = threadIdx.x;
  c.lane = c.tid & 31;
  c.warp = c.tid >> 5;
  c.nk0 = ONE ? 1 : cdiv(c.nfp, K_SLOT);
  c.nkg = ONE ? 1 : cdiv(c.gcp, K_SLOT);
  c.npf = ONE ? 1 : cdiv(a.nf, NF_PASS);
  c.npg = ONE ? 1 : cdiv(a.gc, GC_PASS);
  c.s = 0;
  c.next = Stage{1, 0, 0, 0, 0};
  c.nstage = 0;
  for (int j = 1; j <= 5; ++j)
    c.nstage += (j == 5 ? c.npf : c.npg) * stages_per_pass(a, j, c.nk0, c.nkg);

  // x with halo 5 as [pixel][nfp] rows (zero outside the image and past nf),
  // then the first two ring stages
  esr::tile::stage_tile<TH + 10, TW + 10>(a.x, smem, c.px, c.b, c.ty0 - 5, c.tx0 - 5, a.H, a.W,
                                          a.nf, 0, c.nfp, c.tid);
  esr::mma::cp_async_commit();
  load_w(a, c, 0);
  esr::mma::cp_async_commit();
  load_w(a, c, 1);
  esr::mma::cp_async_commit();
  target<TH, TW, 1, ONE>(a, c);
  target<TH, TW, 2, ONE>(a, c);
  target<TH, TW, 3, ONE>(a, c);
  target<TH, TW, 4, ONE>(a, c);
  target<TH, TW, 5, ONE>(a, c);
  esr::mma::cp_async_wait<0>();
}

template <int TH, int TW>
int launch(const Args& a, int B, cudaStream_t stream) {
  if (one_pass_tile<TH, TW>() && (a.nf > NF_PASS || a.gc > GC_PASS))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(a.nf, a.gc, TH, TW);
  if (int e = esr::tile::smem_opt_in(wb_rdb_mma_kernel<TH, TW>, smem)) return e;
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, B);
  wb_rdb_mma_kernel<TH, TW><<<grid, NTH, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace wbrdb_mma
}  // namespace esr


// Shared memory one FMA block needs: x with halo 5 and x1..x4 with halos 4..1
// (kernels/workbench/rdb.py::smem_bytes picks the tile by the same count).
static int wb_rdb_smem(int dtype, int nf, int gc, int tile) {
  const int esz = dtype == esr::kFloat32 ? 4 : 2;
  long n = (long)nf * (tile + 10) * (tile + 10);
  for (int j = 1; j < 5; ++j) n += (long)gc * (tile + 2 * (5 - j)) * (tile + 2 * (5 - j));
  return (int)(n * esz);
}

enum Design : int { kFma = 0, kMma = 1 };  // kernels/workbench/rdb.py rdb_design

extern "C" {

// One fused RDB over x [B, H, W, nf] (dtype) with by-source weights w0..w4
// (wdtype) and the fp32 bias [nf + 4 gc] (b5|b4|b3|b2|b1) into out, on
// th x tw output tiles. `design`: 1 (the tensor-core kernel: bf16 x and
// weights, tile 8x16 at nf <= 64 and gc <= 32, or 8x8 or 4x8 at any widths
// that fit), 0 (the FMA kernel: fp32 x, a square tile)
// for the other dtype pairs; any other value, and a call the design does not
// take, returns cudaErrorInvalidValue. nf and gc must be multiples of 8, and
// the planes must fit a block's shared memory at the tile (cudaFuncSetAttribute
// refuses them otherwise). Returns cudaGetLastError().
int esr_wb_rdb_fused(int design, int dtype, int wdtype, const void* x, const void* w0,
                     const void* w1, const void* w2, const void* w3, const void* w4,
                     const float* bias, void* out, int B, int H, int W, int nf, int gc,
                     int conv1x1, float slope, float res_scale, int th, int tw, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || nf % 8 || gc % 8 || nf <= 0 || gc <= 0 || th <= 0 ||
      tw <= 0)
    return (int)cudaErrorInvalidValue;
  const bool mma = dtype == esr::kBFloat16 && wdtype == esr::kBFloat16;
  if (design != (mma ? kMma : kFma)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (mma) {
    namespace wm = esr::wbrdb_mma;
    wm::Args a{};
    a.x = static_cast<const bf16*>(x);
    const void* w[5] = {w0, w1, w2, w3, w4};
    for (int i = 0; i < 5; ++i) a.w[i] = static_cast<const bf16*>(w[i]);
    a.bias = bias, a.out = static_cast<bf16*>(out);
    a.H = H, a.W = W, a.nf = nf, a.gc = gc, a.conv1x1 = conv1x1;
    a.slope = slope, a.res_scale = res_scale;
    if (th == 8 && tw == 16) return wm::launch<8, 16>(a, B, s);
    if (th == 8 && tw == 8) return wm::launch<8, 8>(a, B, s);
    if (th == 4 && tw == 8) return wm::launch<4, 8>(a, B, s);
    return (int)cudaErrorInvalidValue;
  }
  if (th != tw) return (int)cudaErrorInvalidValue;
  const int tile = th;
  const void* w[5] = {w0, w1, w2, w3, w4};
  const int smem = wb_rdb_smem(dtype, nf, gc, tile);
  if (dtype == esr::kFloat32 && wdtype == esr::kFloat32)
    return esr::wbrdb::launch<float, float>(x, w, bias, out, B, H, W, nf, gc, conv1x1, slope,
                                            res_scale, tile, smem, s);
  if (dtype == esr::kFloat32 && wdtype == esr::kBFloat16)
    return esr::wbrdb::launch<float, bf16>(x, w, bias, out, B, H, W, nf, gc, conv1x1, slope,
                                           res_scale, tile, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
