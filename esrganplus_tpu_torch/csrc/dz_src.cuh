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

template <typename T>
__device__ __forceinline__ float dz_load(const DzSrc& s, int b, int y, int x, int c) {
  const size_t pix = ((size_t)b * s.H + y) * s.W + x;
  if (s.mode == kDzG) {
    const size_t i = pix * s.g_stride + c;
    float v = to_f(static_cast<const T*>(s.g)[i]);
    if (s.noise) v *= 1.f + s.sigma * to_f(static_cast<const T*>(s.noise)[i]);
    else if (s.fac) v = __fmul_rn(v, s.fac[i]);
    return v * s.scale;
  }
  if (s.mode == kDzPhase) {
    const int ph = (c + s.coff) / s.co, cc = c + s.coff - ph * s.co;
    const size_t hp = ((size_t)b * 2 * s.H + 2 * y + (ph >> 1)) * 2 * s.W + 2 * x + (ph & 1);
    const float v = to_f(static_cast<const T*>(s.g)[hp * s.co + cc]);
    return to_f(static_cast<const T*>(s.mask)[hp * s.co + cc]) >= 0.f ? v : v * s.slope;
  }
  float v = s.d32[pix * s.d_stride + s.coff + c];
  if (s.coff2 >= 0) v += s.d32[pix * s.d_stride + s.coff2 + c];
  if (s.mode == kDzPlain) return v;
  return to_f(static_cast<const T*>(s.mask)[pix * s.m_stride + c]) >= 0.f ? v : v * s.slope;
}

}  // namespace esr

// sizeof(DzSrc) as this library was compiled; every library that includes
// this header is one translation unit, so each exports it once.
extern "C" int esr_dzsrc_size() { return (int)sizeof(esr::DzSrc); }
