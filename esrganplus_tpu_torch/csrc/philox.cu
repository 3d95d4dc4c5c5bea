// Fills an NHWC fp32 tensor from philox.cuh's draws (sm_90a).
//
//   esr_philox_factor  the fused noise mode's factor 1 + sigma*n per element:
//                      rdb_ct_bwd fills one such buffer per call (freed when
//                      it returns) and its data- and weight-gradient kernels
//                      scale the stage-5 cotangent by it at load. The values
//                      are those rdb_ct.cu's epilogue multiplied in (the same
//                      device function), bit for bit, and nothing is kept
//                      from the forward. Regenerating the draw inside
//                      dz_src.cuh at every read instead cost the backward
//                      10 % (1.242 against 1.126 ms for rdb_ct_bwd at batch
//                      16 of 32x32, bf16, on an H100 80GB HBM3 at 700.00 W,
//                      chip_smoke.py's kernels-noise phase): each stage-5
//                      cotangent element is read ~20 times across dgrad's
//                      channel chunks, halos and wgrad's channel blocks.
//   esr_philox_normal  the standard normals themselves: a debug entry point,
//                      not on any model path; the tests and chip_smoke.py
//                      hold the device draw against its plain twin
//                      (kernels/philox.py) with it.
//
// Bound on this card: bytes (4 per element written) against ~150 integer
// and float operations per element; one thread per element, grid-stride.
#include "common.cuh"
#include "philox.cuh"

namespace {

template <bool FACTOR>
__global__ void philox_fill_kernel(float* __restrict__ out, uint32_t seed0, uint32_t seed1,
                                   float sigma, int B, int H, int W, int C) {
  const size_t n = (size_t)B * H * W * C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const size_t p = i / C;
    const int x = (int)(p % W), y = (int)(p / W % H), b = (int)(p / ((size_t)W * H));
    out[i] = FACTOR ? esr::noise_factor(sigma, seed0, seed1, b, y, x, c)
                    : esr::philox_normal(seed0, seed1, b, y, x, c);
  }
}

template <bool FACTOR>
int fill(float* out, unsigned seed0, unsigned seed1, float sigma, int B, int H, int W, int C,
         void* stream) {
  const size_t n = (size_t)B * H * W * C;
  if (n == 0) return 0;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  philox_fill_kernel<FACTOR><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, seed0, seed1, sigma, B, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[B, H, W, C] (fp32) = the standard normals of the site (seed0, seed1).
// Returns cudaGetLastError().
int esr_philox_normal(float* out, unsigned seed0, unsigned seed1, int B, int H, int W, int C,
                      void* stream) {
  return fill<false>(out, seed0, seed1, 0.f, B, H, W, C, stream);
}

// out[B, H, W, C] (fp32) = 1 + sigma * n for the site (seed0, seed1).
// Returns cudaGetLastError().
int esr_philox_factor(float* out, unsigned seed0, unsigned seed1, float sigma, int B, int H,
                      int W, int C, void* stream) {
  return fill<true>(out, seed0, seed1, sigma, B, H, W, C, stream);
}

}  // extern "C"
