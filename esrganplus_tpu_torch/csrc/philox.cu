// Fills tensors from philox.cuh's draws (sm_90a). Every entry reads its key
// (the two seed words, seed0 then seed1) through a device pointer, so a
// captured CUDA graph replays it with the words of each step's row.
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
//   esr_philox_normal  the standard normals themselves, NHWC fp32: the input
//                      noise mode's pre-drawn sites of a training step, and
//                      what the tests and chip_smoke.py hold against the plain
//                      twin (kernels/philox.py).
// Every fill takes a batch offset b0: local row b of the output is the draw
// of global row b0 + b, so a rank of a data-parallel run that holds rows
// [b0, b0 + B) of the global batch draws exactly those rows (0 in one process).
//   esr_philox_bits    the four raw output words of counter (i, stream, 0, 0)
//                      for i < n: the resident sampler's crop indices and
//                      augment coins (stream 0) and WGAN-GP's interpolation
//                      weights (stream 1), derived from them by the wrapper.
//
// Bound on this card: bytes (4 per element written; 16 per counter of the
// bits) against ~150 integer and float operations per element; one thread
// per element, grid-stride.
#include "common.cuh"
#include "philox.cuh"

namespace {

template <bool FACTOR>
__global__ void philox_fill_kernel(float* __restrict__ out, const uint32_t* __restrict__ seed,
                                   float sigma, int b0, int B, int H, int W, int C) {
  const uint32_t seed0 = __ldg(seed), seed1 = __ldg(seed + 1);
  const size_t n = (size_t)B * H * W * C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const size_t p = i / C;
    const int x = (int)(p % W), y = (int)(p / W % H), b = (int)(p / ((size_t)W * H));
    out[i] = FACTOR ? esr::noise_factor(sigma, seed0, seed1, b0 + b, y, x, c)
                    : esr::philox_normal(seed0, seed1, b0 + b, y, x, c);
  }
}

__global__ void philox_bits_kernel(uint4* __restrict__ out, const uint32_t* __restrict__ key,
                                   int n, uint32_t stream) {
  const uint2 k = make_uint2(__ldg(key), __ldg(key + 1));
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    out[i] = esr::philox4x32_10(make_uint4((uint32_t)i, stream, 0u, 0u), k);
}

int grid(size_t n) { return (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096); }

template <bool FACTOR>
int fill(float* out, const uint32_t* seed, float sigma, int b0, int B, int H, int W, int C,
         void* stream) {
  const size_t n = (size_t)B * H * W * C;
  if (n == 0) return 0;
  philox_fill_kernel<FACTOR><<<grid(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, seed, sigma, b0, B, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[B, H, W, C] (fp32) = the standard normals of the site seed[0..1], rows
// b0 .. b0 + B - 1 of its draw. Returns cudaGetLastError().
int esr_philox_normal(float* out, const unsigned* seed, int b0, int B, int H, int W, int C,
                      void* stream) {
  return fill<false>(out, seed, 0.f, b0, B, H, W, C, stream);
}

// out[B, H, W, C] (fp32) = 1 + sigma * n for the site seed[0..1], rows
// b0 .. b0 + B - 1 of its draw. Returns cudaGetLastError().
int esr_philox_factor(float* out, const unsigned* seed, float sigma, int b0, int B, int H,
                      int W, int C, void* stream) {
  return fill<true>(out, seed, sigma, b0, B, H, W, C, stream);
}

// out[n][4] (uint32) = Philox4x32-10 of counter (i, stream, 0, 0) under the
// key seed[0..1]. Returns cudaGetLastError().
int esr_philox_bits(void* out, const unsigned* seed, int n, unsigned stream, void* cstream) {
  if (n <= 0) return 0;
  philox_bits_kernel<<<grid((size_t)n), 256, 0, static_cast<cudaStream_t>(cstream)>>>(
      static_cast<uint4*>(out), seed, n, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
