// Hopper building blocks for the port's TMA-fed, wgmma kernels (sm_90a):
// mbarriers, 4-D tensor-map tile loads (cp.async.bulk.tensor) that complete
// on an mbarrier, the proxy fences between thread stores and the async
// proxy, and the warpgroup product wgmma.mma_async m64nNk16 bf16 -> fp32 with
// both operands read from shared memory through matrix descriptors.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"; CUTLASS's GmmaDescriptor)
// are built here for the no-swizzle K-major layout only: a core matrix is 8
// rows of 16 bytes (8 bf16 along K), stored as 128 contiguous bytes; the
// leading byte offset (LBO) steps from one core matrix to the next along K,
// the stride byte offset (SBO) from one group of 8 rows to the next along M
// (A) or N (B). Any row may start a matrix, so a window of shifted rows is
// just a descriptor with another start address.
//
// Host side: the driver's cuTensorMapEncodeTiled, found with dlsym in the
// already-loaded libcuda (the runtime loads it), so no library links
// against the driver.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <mutex>

namespace esr {
namespace hopper {

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// The barrier inits visible to every thread of the block (and to the async
// proxy) before any of them uses one; the caller syncs the block after.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and expect `bytes` more of asynchronous copies on the phase.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Named barrier `id` among the first `count` threads of the block (warps
// whole).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// TMA and proxy fences
// ---------------------------------------------------------------------------

// The box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at dst (128-byte aligned); out-of-bounds
// elements read as zero. Completes `bytes` of the barrier's transaction.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// This thread's shared-memory stores ordered before later async-proxy
// reads (wgmma, TMA) of the same bytes.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulators' registers: no access to them moves across this point
// (around the asynchronous wgmma).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A no-swizzle K-major matrix descriptor at shared address `addr` (16-byte
// aligned) with the given LBO (along K) and SBO (along M or N) in bytes.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// A 64-byte-swizzle K-major matrix descriptor (TMA's 64-byte swizzle: the
// 16-byte chunks of each 64-byte row XORed with address bits 7-8): rows of
// 64 bytes, 8-row groups `sbo` bytes apart, the k16 step's 32 bytes at
// `addr` (16-byte aligned). The swizzle follows the absolute shared address,
// as TMA writes it, so a window may start on any row with base offset 0
// (measured on the H100: a base offset of (addr >> 7) & 7 reads the wrong
// rows).
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (2ull << 62);
}

// 16 bytes into shared memory at a shared address.
__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// d (+)= A (64 x 16, descriptor a) * B (16 x N, descriptor b; stored N x K)
// for one warpgroup; the sum starts from zero where scale_d == 0. d holds
// this thread's N/2 accumulators in the mma.sync C layout repeated over the
// N/8 column groups: d[4j + 2h + e] is row 16 * warp + lane / 4 + 8h, column
// 8j + 2 * (lane % 4) + e. Asynchronous: read d only after wgmma_wait.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bf16 [B, H, W, row] NHWC tensor at `base` whose first `c` channels of
// each pixel's `row` are the map's (channels past c read as zero), cut in
// boxes of 32 channels x bw columns x bh rows x 1 image, each pixel's 64
// bytes swizzled (64-byte swizzle) in shared memory. A map depends on the
// address and the shape alone, so the last 64 encoded are kept and found
// again (encoding one costs microseconds of host time a launch). Returns 0
// or a CUDA error code.
inline int nhwc_map(CUtensorMap* map, const void* base, int c, int row, int B, int H, int W,
                    int bw, int bh) {
  struct Key {
    const void* base;
    int v[7];
  };
  struct Entry {
    Key k;
    CUtensorMap m;
    bool used;
  };
  static std::mutex mu;
  static Entry cache[64];
  static EncodeTiled encode = nullptr;
  const Key k{base, {c, row, B, H, W, bw, bh}};
  auto same = [&](const Key& o) {
    if (o.base != k.base) return false;
    for (int i = 0; i < 7; ++i)
      if (o.v[i] != k.v[i]) return false;
    return true;
  };
  size_t h = reinterpret_cast<size_t>(base) >> 8;
  for (int i = 0; i < 7; ++i) h = h * 31 + (size_t)k.v[i];
  Entry& e = cache[h % 64];
  std::lock_guard<std::mutex> lock(mu);
  if (e.used && same(e.k)) {
    *map = e.m;
    return 0;
  }
  if (!encode) {
    cudaFree(nullptr);  // the runtime has loaded the driver
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) encode = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
    if (!encode) return (int)cudaErrorSharedObjectSymbolNotFound;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)row * 2, (cuuint64_t)W * row * 2,
                                 (cuuint64_t)H * W * row * 2};
  const cuuint32_t box[4] = {32, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  e = Entry{k, *map, true};
  return 0;
}

}  // namespace hopper
}  // namespace esr
