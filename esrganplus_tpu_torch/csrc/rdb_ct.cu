// Dense-stage 3x3 convolution for the RRDB trunk (NHWC, sm_90a), HWIO weights.
//
// Replaces two TPU kernels of esrganplus_tpu/kernels/rdb_ct.py:
//   * rdb_ct      (_rdb_ct_kernel / _rdb_ct_pipe_kernel): one whole
//     ResidualDenseBlock_5C as five launches of dense_conv.cuh's kernel, one
//     per dense stage, each rounded to T where rdb_ct.py:217-233 and :258-266
//     round. The training forward keeps l2|l4 (rdb_ct.py:248-256) and applies
//     the nESRGAN+ relative noise in stage 5's epilogue: pre-drawn
//     (rdb_ct.py:267-271) or drawn in the kernel from the site's two seed
//     words (the `fused` mode, rdb_ct.py:158-161 and :261-266, with
//     philox.cuh in place of the TPU's hardware PRNG), read from device
//     memory so that a captured CUDA graph draws each step's own noise.
//   * conv3x3_ct  (_conv_ct_kernel): the trunk conv plus the global residual,
//     the same kernel in RESID mode with alpha = 1 (rdb_ct.py:556-566).
//
// The kernel's two designs (bf16 on the tensor cores, fp32 on the CUDA
// cores), its bound on this card and what the designs do about it are
// described in dense_conv.cuh.
#include "dense_conv.cuh"

extern "C" {

// One dense-stage (or conv3x3_ct) launch on `stream`. With `seed` (a device
// pointer to the site's two words, seed0 then seed1), stage 5 draws its noise
// instead of reading `noise`, local row b drawing global row b0 + b. `design`:
// 1 (the tensor-core kernel, bf16 only) or 0 (the FMA kernel, which the
// wrappers ask for in fp32); any other value returns cudaErrorInvalidValue. Returns the cudaGetLastError()
// code after the launch (0 = launched).
int esr_dense_conv3x3(int dtype, int design, int cout, int mode, const void* x, int c0,
                      const void* cat, int ccat, int cin, const void* w, const void* bias,
                      const void* w11, void* out, int out_stride, const void* r1, int r1_stride,
                      const void* r2, int r2_stride, void* lsave, int lsave_stride,
                      const void* noise, float sigma, const unsigned* seed, int b0, float alpha,
                      float beta2, float slope, int B, int H, int W, void* stream) {
  if (seed && noise) return (int)cudaErrorInvalidValue;
  const esr::dense::DenseArgs a{x, cat, w, bias, w11, r1, r2, noise, out, lsave, c0, ccat, cin,
                                out_stride, r1_stride, r2_stride, lsave_stride, B, H, W,
                                sigma, alpha, beta2, slope, seed, b0};
  return esr::dense::dispatch(dtype, design, cout, mode, a, esr::HwioLayout{},
                              static_cast<cudaStream_t>(stream));
}

// The bf16 design's plan of a launch on `nsm` SMs (kernels/launch.py
// dense_plan mirrors it): out[0..6] = tile width, outputs a block owns,
// tile slots, tiles, blocks, dynamic shared memory, and the weight bytes
// the launch stages into shared memory; returns cudaErrorInvalidValue where
// no plan fits.
int esr_dense_plan(int cout, int cin, int c0, int mode, int B, int H, int W, int nsm,
                   int* out) {
  namespace dm = esr::dense::dmma;
  const bool s11 = mode == esr::dense::kAct1x1;
  const dm::Plan p = dm::plan(cout, cin, c0, s11, B, H, W, nsm);
  const int v[7] = {p.tw, p.nb, p.nbuf, p.tiles, p.blocks, p.smem,
                    dm::staged_bytes(p, cin, c0, s11)};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return p.nb ? 0 : (int)cudaErrorInvalidValue;
}

}  // extern "C"
