// Weight and bias gradient of a SAME 3x3 (or 1x1) convolution in HWIO layout
// (NHWC, sm_90a): the dW/db half of esrganplus_tpu/kernels/rdb_ct.py's
// _rdb_ct_bwd_kernel and _conv3x3_ct_bwd_kernel, and through
// kernels/tail_ct.py of _upfold_bwd_kernel and _conv_hr_bwd_kernel. The
// kernel, its bound and its design are described in wgrad.cuh.
#include "wgrad.cuh"

extern "C" {

// out[0 : taps*cin*s] = dW ([taps, cin, s], i.e. HWIO), out[taps*cin*s :] = db;
// see esr::wgrad::run.
int esr_wgrad(int dtype, int taps, const void* x, int c0, const void* cat, int ccat, int cin,
              const esr::DzSrc* dz, int s, float* part, int npart, float* out, int B,
              void* stream) {
  return esr::wgrad::run(dtype, taps, x, c0, cat, ccat, cin, dz, s, esr::HwioLayout{}, part,
                         npart, out, B, stream);
}

}  // extern "C"
