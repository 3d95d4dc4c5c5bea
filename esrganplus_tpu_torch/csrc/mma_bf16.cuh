// Tensor-core building blocks for the port's bf16 kernels (sm_90a):
// 16-byte cp.async with commit / wait groups, ldmatrix (x4 / x2, plain and
// .trans), the warp-level mma.sync m16n8k16 bf16 product with fp32
// accumulators, and the padded row pitch that keeps ldmatrix free of bank
// conflicts on [row][channel] tiles.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), lane =
// 4 * g + q with g = lane / 4, q = lane % 4:
//   A (16 x 16, row-major)  a0: (g, 2q..2q+1)  a1: (g+8, 2q..)  a2: (g, 2q+8..)  a3: (g+8, 2q+8..)
//   B (16 x 8, "col")       b0: (k 2q..2q+1, n g)  b1: (k 2q+8.., n g)
//   C (16 x 8, fp32)        c0, c1: (g, 2q), (g, 2q+1)   c2, c3: (g+8, 2q), (g+8, 2q+1)
// ldmatrix.x4 loads four 8x8 b16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i of every lane receives matrix i.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace esr {
namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous. With valid == false nothing is
// read and the 16 bytes are zero-filled (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// .x2: only lanes 0..15 give addresses.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c += a * b on the tensor cores: one 16x8x16 bf16 product, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row pitch in bytes of a shared [row][n x bf16] tile that ldmatrix reads
// 8 rows at a time: n rounded up to 16-byte units, then to an odd count of
// them, so that 8 consecutive rows start in 8 different 16-byte bank groups
// (a pitch of 128 or 256 bytes would put all 8 in the same banks).
__host__ __device__ constexpr int ldsm_pitch(int n) { return (((n + 7) / 8) | 1) * 16; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma
}  // namespace esr
