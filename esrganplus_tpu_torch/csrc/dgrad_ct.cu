// Data gradient of a SAME 3x3 (or 1x1) convolution with HWIO weights (NHWC,
// sm_90a): the dx half of esrganplus_tpu/kernels/rdb_ct.py's
// _rdb_ct_bwd_kernel and _conv3x3_ct_bwd_kernel, and through
// kernels/tail_ct.py of the upconv's and the hr convs' fp32 adjoints. The
// kernels (bf16 on the tensor cores, fp32 on the CUDA cores), their bound
// and their design are described in dgrad.cuh.
#include "dgrad.cuh"

extern "C" {

// dx (+)= conv^T(dz, w) for HWIO `w` [taps, cin, s]; `design` 1 (tensor
// cores, bf16 only) or 0 (FMA); see esr::dgrad::run.
int esr_dgrad(int dtype, int design, int chunk, int taps, const esr::DzSrc* dz, int s,
              const void* w, int cin, float* out32, int o32_stride, int accumulate, void* outT,
              int oT_stride, const esr::DzSrc* addg, int B, void* stream) {
  return esr::dgrad::run(dtype, design, chunk, taps, dz, s, w, esr::HwioLayout{}, cin, out32,
                         o32_stride, accumulate, outT, oT_stride, addg, B, stream);
}

}  // extern "C"
