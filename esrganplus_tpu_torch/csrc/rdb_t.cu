// The 9-tap ResidualDenseBlock on rdb_t's by-target weights (NHWC, sm_90a).
//
// Replaces two TPU kernels of esrganplus_tpu/kernels/rdb_t.py:
//   * rdb_t       (_rdb_t_kernel, :144-248): the whole RDB forward. Stage k is
//     an implicit GEMM over K = 9 * C_prefix_k, read straight from the
//     by-target matrix w_k [S_k, 9 * C_prefix_k] whose K rows run source,
//     then tap r*3+s, then channel (ByTargetLayout, wlayout.cuh); the sources
//     are x (read in place) and a per-call NHWC buffer [B,H,W,4*gc] holding
//     x1|x2|x3|x4. The 1x1 shortcut reads w11 [gc, nf] (zeros when the RDB
//     has none: rdb_t always applies it, as the TPU kernel does), and each
//     stage's bias is read at its offset in the packed b5|b4|b3|b2|b1 column.
//     Stage outputs round to T where _rdb_t_kernel rounds them (:227-239);
//     stage 5 computes beta*x5 + x, and with the RRDB fold (x * rrdb + res),
//     in fp32 with one rounding (:242-248).
//   * _rdb_t_bwd  (_rdb_t_bwd_kernel, :313-493): the adjoint, which saves
//     nothing from the forward. The stage-1..4 forward is recomputed from x
//     into a workspace (x1..x4 and the pre-residual l2|l4 whose signs give
//     the leaky-relu masks) freed when the call returns; then the adjoint
//     walks stages 5 -> 1 over an fp32 cotangent buffer [B,H,W,nf+4*gc] in
//     _rdb_t_bwd_kernel's order: dz_k rounded to T before a product, db from
//     the unrounded dz, dW11 = dx2^T x and dx += W11^T dx2 on the rounded
//     dx2, dx0 = untap + dx_c11 + g rounded once. dW leaves in rdb_t's
//     [S, 9 * C_prefix] layout in fp32 (per-block partial rows, then a
//     fixed-order finishing pass: no atomics), dW11 as [gc, nf].
//
// The kernels are dense_conv.cuh's, dgrad.cuh's and wgrad.cuh's templates
// with the by-target weight indexer; their bound on this card (operations,
// fp32 on the CUDA cores) and design are described there. The backward does
// the forward's stage-1..4 products once more, then twice the forward's
// products (dx and dW).
#include "dense_conv.cuh"
#include "dgrad.cuh"
#include "wgrad.cuh"

extern "C" {

// One dense-stage launch of rdb_t's forward (or of the backward's
// recompute) with by-target weights `w` [cout, 9 * cin] and, in kAct1x1
// mode, w11 [cout, nf]. `bias` points at the stage's rows of the packed
// bias. Returns cudaGetLastError().
int esr_rdb_t_stage(int dtype, int cout, int mode, int nf, int gc, const void* x,
                    const void* cat, int ccat, int cin, const void* w, const void* bias,
                    const void* w11, void* out, int out_stride, const void* r1, int r1_stride,
                    const void* r2, int r2_stride, void* lsave, int lsave_stride, float alpha,
                    float beta2, float slope, int B, int H, int W, void* stream) {
  const esr::dense::DenseArgs a{x, cat, w, bias, w11, r1, r2, nullptr, out, lsave, nf, ccat,
                                cin, out_stride, r1_stride, r2_stride, lsave_stride, B, H, W,
                                0.f, alpha, beta2, slope, 0, 0u, 0u};
  return esr::dense::dispatch(dtype, cout, mode, a, esr::ByTargetLayout{nf, gc},
                              static_cast<cudaStream_t>(stream));
}

// dx (+)= conv^T(dz, w) for one stage of rdb_t_bwd, by-target `w`
// [s, taps * cin]; see esr::dgrad::run.
int esr_rdb_t_dgrad(int dtype, int chunk, int taps, int nf, int gc, const esr::DzSrc* dz, int s,
                    const void* w, int cin, float* out32, int o32_stride, int accumulate,
                    void* outT, int oT_stride, const esr::DzSrc* addg, int B, void* stream) {
  return esr::dgrad::run(dtype, chunk, taps, dz, s, w, esr::ByTargetLayout{nf, gc}, cin, out32,
                         o32_stride, accumulate, outT, oT_stride, addg, B, stream);
}

// out[0 : s*taps*cin] = dW as rdb_t's [s, taps * cin], out[s*taps*cin :] = db;
// see esr::wgrad::run.
int esr_rdb_t_wgrad(int dtype, int taps, int nf, int gc, const void* x, const void* cat,
                    int ccat, int cin, const esr::DzSrc* dz, int s, float* part, int npart,
                    float* out, int B, void* stream) {
  return esr::wgrad::run(dtype, taps, x, nf, cat, ccat, cin, dz, s,
                         esr::ByTargetLayout{nf, gc}, part, npart, out, B, stream);
}

}  // extern "C"
