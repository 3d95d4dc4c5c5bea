// Where a backward kernel reads the cotangent dz of a conv's output.
//
// The data-gradient kernel (dgrad.cuh) and the weight-gradient kernel
// (wgrad.cuh) consume the same dz, and in every adjoint of this package dz
// is a cheap pointwise function of tensors already in device memory, so it is
// computed at load and never stored:
//   kDzG      dz = g * scale * (1 + sigma * n)                stage 5 / plain convs
//             n: a pre-drawn T tensor (`noise`); or `fac`, the fused mode's
//             fp32 factor 1 + sigma*n filled per backward call from the
//             site's seed words (philox.cu), bit for bit the forward's
//   kDzGate   v = d32[c + coff] (+ d32[c + coff2]);  dz = mask >= 0 ? v : v * slope
//   kDzPlain  the same v, not gated                           (the 1x1 shortcut)
//   kDzPhase  the upconv's phase view of an HR cotangent: channel c + coff is
//             (phase = (c + coff) / co, channel (c + coff) % co) at HR pixel
//             (2y + a, 2x + b), gated by the sign of the saved HR output
// The value is returned unrounded in fp32 (the bias gradient sums it so);
// callers round it to T before it enters a product, as the TPU kernels do.
#pragma once

#include "common.cuh"

namespace esr {

enum DzMode : int { kDzG = 0, kDzGate = 1, kDzPlain = 2, kDzPhase = 3 };

// Plain C layout shared with the Python wrappers (kernels/build.py DzSrc,
// which checks its size against esr_dzsrc_size() when a library loads).
struct DzSrc {
  const void* g;       // T: kDzG [pix * g_stride + c]; kDzPhase the HR cotangent
  const void* noise;   // T or null: kDzG [pix * g_stride + c]
  const float* fac;    // fp32 or null: kDzG [pix * g_stride + c], 1 + sigma*n (fused)
  const float* d32;    // fp32 cotangent buffer [pix * d_stride + coff + c]
  const void* mask;    // T: sign source [pix * m_stride + c]; kDzPhase the HR output
  int mode, g_stride, d_stride, coff, coff2, m_stride, co, H, W;
  float sigma, scale, slope;
};

// dz of mode kDzG from its operands: g, and n (noise) or f (fac) as present.
__device__ __forceinline__ float dz_g(const DzSrc& s, float g, float n, float f) {
  float v = g;
  if (s.noise) v *= 1.f + s.sigma * n;
  else if (s.fac) v = __fmul_rn(v, f);
  return v * s.scale;
}

// dz of modes kDzGate / kDzPlain from the buffer's value(s) and the mask.
__device__ __forceinline__ float dz_gate(const DzSrc& s, float v, float v2, float m) {
  if (s.coff2 >= 0) v += v2;
  if (s.mode == kDzPlain) return v;
  return m >= 0.f ? v : v * s.slope;
}

template <typename T>
__device__ __forceinline__ float dz_load(const DzSrc& s, int b, int y, int x, int c) {
  const size_t pix = ((size_t)b * s.H + y) * s.W + x;
  if (s.mode == kDzG) {
    const size_t i = pix * s.g_stride + c;
    return dz_g(s, to_f(static_cast<const T*>(s.g)[i]),
                s.noise ? to_f(static_cast<const T*>(s.noise)[i]) : 0.f, s.fac ? s.fac[i] : 0.f);
  }
  if (s.mode == kDzPhase) {
    const int ph = (c + s.coff) / s.co, cc = c + s.coff - ph * s.co;
    const size_t hp = ((size_t)b * 2 * s.H + 2 * y + (ph >> 1)) * 2 * s.W + 2 * x + (ph & 1);
    const float v = to_f(static_cast<const T*>(s.g)[hp * s.co + cc]);
    return to_f(static_cast<const T*>(s.mask)[hp * s.co + cc]) >= 0.f ? v : v * s.slope;
  }
  const float* d = s.d32 + pix * s.d_stride;
  return dz_gate(s, d[s.coff + c], s.coff2 >= 0 ? d[s.coff2 + c] : 0.f,
                 s.mode == kDzGate ? to_f(static_cast<const T*>(s.mask)[pix * s.m_stride + c])
                                   : 0.f);
}

// The 16-byte vectors behind dz_load of channels c .. c+7 (c % 8 == 0), for
// the bf16 tensor-core kernels: a thread fetches several groups before it
// finishes any (dz_finish8), so their loads are in flight together. kDzG:
// v[0] g, v[1] noise or v[1..2] fac; kDzGate / kDzPlain: v[0..1] d32 at
// coff, v[2..3] at coff2, v[4] mask. Every stride and channel offset a
// multiple of 8 and every base 16-byte aligned (the wrappers see to it);
// kDzPhase, which those kernels refuse, is not read.
struct Dz8 {
  uint4 v[5];
};

__device__ __forceinline__ void dz_fetch8(const DzSrc& s, int b, int y, int x, int c, Dz8& r) {
  const size_t pix = ((size_t)b * s.H + y) * s.W + x;
  auto ld = [](const void* p) { return *reinterpret_cast<const uint4*>(p); };
  if (s.mode == kDzG) {
    const size_t i = pix * s.g_stride + c;
    r.v[0] = ld(static_cast<const __nv_bfloat16*>(s.g) + i);
    if (s.noise) {
      r.v[1] = ld(static_cast<const __nv_bfloat16*>(s.noise) + i);
    } else if (s.fac) {
      r.v[1] = ld(s.fac + i);
      r.v[2] = ld(s.fac + i + 4);
    }
    return;
  }
  const float* p = s.d32 + pix * s.d_stride;
  r.v[0] = ld(p + s.coff + c);
  r.v[1] = ld(p + s.coff + c + 4);
  if (s.coff2 >= 0) {
    r.v[2] = ld(p + s.coff2 + c);
    r.v[3] = ld(p + s.coff2 + c + 4);
  }
  if (s.mode == kDzGate)
    r.v[4] = ld(static_cast<const __nv_bfloat16*>(s.mask) + pix * s.m_stride + c);
}

// dz of the fetched group, the values dz_load gives.
__device__ __forceinline__ void dz_finish8(const DzSrc& s, const Dz8& r, float (&d)[8]) {
  auto bf = [](const uint4& v, int k) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&v)[k]);
  };
  auto f32 = [](const uint4 (&v)[5], int j, int k) {
    return reinterpret_cast<const float*>(&v[j + k / 4])[k % 4];
  };
  if (s.mode == kDzG) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      d[k] = dz_g(s, bf(r.v[0], k), s.noise ? bf(r.v[1], k) : 0.f, s.fac ? f32(r.v, 1, k) : 0.f);
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    d[k] = dz_gate(s, f32(r.v, 0, k), s.coff2 >= 0 ? f32(r.v, 2, k) : 0.f,
                   s.mode == kDzGate ? bf(r.v[4], k) : 0.f);
}

}  // namespace esr

// sizeof(DzSrc) as this library was compiled; every library that includes
// this header is one translation unit, so each exports it once.
extern "C" int esr_dzsrc_size() { return (int)sizeof(esr::DzSrc); }
