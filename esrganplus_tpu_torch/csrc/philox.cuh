// Counter-based standard normals for the nESRGAN+ relative noise drawn inside
// the kernels (noise_kernel = "fused").
//
// Replaces the TPU core's hardware PRNG of esrganplus_tpu/kernels/rdb_ct.py
// (_seed_prng and _kernel_normal, :98-120). That generator cannot be replayed
// off a TPU; this one is a pure function of its inputs, so the backward
// regenerates the forward's draws (philox.cu) instead of saving them, and
// the plain PyTorch twin (kernels/philox.py) computes the same numbers on
// any device.
//
// The draw for element (b, y, x, c) of one noise site:
//   key     = (seed0, seed1)               the site's two seed words
//   counter = (c, x, y, b)                 one 32-bit word each, in that order
//   r0..r3  = Philox4x32-10(counter, key)  (Salmon et al., SC'11; the
//             Random123 multipliers and Weyl key increments)
//   u1 = (r0 >> 8) * 2^-24 + 2^-25        in (0, 1]
//   u2 = (r1 >> 8) * 2^-24                 in [0, 1)
//   n  = sqrtf(-2 * logf(u1)) * cosf(6.283185307179586f * u2)
// in fp32, as _kernel_normal's arithmetic (rdb_ct.py:113-120); r2 and r3 are
// not used. The counter holds only the element's coordinates: no tile,
// block or launch geometry enters it, so every kernel that reads the element
// draws the same number. The build has no --use_fast_math: logf, cosf and
// sqrtf are the accurate library functions.
#pragma once

#include <cstdint>

namespace esr {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = 0xD2511F53u * ctr.x, hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z, hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += 0x9E3779B9u;
    key.y += 0xBB67AE85u;
  }
  return ctr;
}

// The standard normal of element (b, y, x, c) of the site keyed (seed0, seed1).
__device__ __forceinline__ float philox_normal(uint32_t seed0, uint32_t seed1, int b, int y,
                                               int x, int c) {
  const uint4 r = philox4x32_10(make_uint4((uint32_t)c, (uint32_t)x, (uint32_t)y, (uint32_t)b),
                                make_uint2(seed0, seed1));
  const float u1 = __fadd_rn(__fmul_rn((float)(r.x >> 8), 0x1p-24f), 0x1p-25f);
  const float u2 = __fmul_rn((float)(r.y >> 8), 0x1p-24f);
  return __fmul_rn(sqrtf(__fmul_rn(-2.f, logf(u1))), cosf(__fmul_rn(6.283185307179586f, u2)));
}

// The fused mode's factor 1 + sigma * n, each step rounded as the twin rounds it.
__device__ __forceinline__ float noise_factor(float sigma, uint32_t seed0, uint32_t seed1, int b,
                                              int y, int x, int c) {
  return __fadd_rn(1.f, __fmul_rn(sigma, philox_normal(seed0, seed1, b, y, x, c)));
}

}  // namespace esr
