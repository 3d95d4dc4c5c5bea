// Where a conv weight (or its gradient) element lives, for the two layouts
// the RDB kernels read: the templates of dense_conv.cuh, dgrad.cuh and
// wgrad.cuh take one of these, so rdb_ct and rdb_t share their arithmetic
// and each reads its own weights in place.
//
// Element (tap t of `taps`, conv input channel ci of cin, output channel co
// of cout):
//   HwioLayout      [taps, cin, cout]: rdb_ct's HWIO weights (the 1x1
//                   shortcut [nf, gc]), and every other conv of the package;
//   ByTargetLayout  [cout, taps * cin] with the K axis ordered source, then
//                   tap, then channel: the first source is x (nf channels),
//                   each later one a gc-channel stage output. This is
//                   esrganplus_tpu/kernels/rdb_t.py's by-target matrix
//                   (prepare_rdb_t_weights, :73-100); at taps = 1 with
//                   cin = nf it is the [gc, nf] shortcut w11.
#pragma once

#include <cstddef>

namespace esr {

struct HwioLayout {
  __device__ __forceinline__ size_t operator()(int taps, int t, int ci, int co, int cin,
                                               int cout) const {
    (void)taps;
    return ((size_t)t * cin + ci) * cout + co;
  }
};

struct ByTargetLayout {
  int nf, gc;  // widths of the first source and of every later one
  __device__ __forceinline__ size_t operator()(int taps, int t, int ci, int co, int cin,
                                               int cout) const {
    (void)cout;
    int k;
    if (ci < nf) {
      k = t * nf + ci;
    } else {
      const int j = ci - nf, src = j / gc;
      k = taps * (nf + src * gc) + t * gc + (j - src * gc);
    }
    return (size_t)co * taps * cin + k;
  }
};

}  // namespace esr
