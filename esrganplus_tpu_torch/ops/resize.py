"""MATLAB-compatible bicubic resize as two dense matrix products.

The reference implements MATLAB ``imresize`` as per-output-row ``mv()`` loops over a
symmetrically padded tensor (reference: ``codes/data/util.py:213-412``). That shape of
code — dynamic Python loops, per-row matrix-vector products — is exactly what XLA cannot
run fast. Here the same math is expressed as two dense resize matrices so the whole
operation becomes ``R_h @ img @ R_w.T``: two matrix products (numpy on the host in
:func:`imresize_np`, ``torch.einsum`` on the tensor's device in :func:`imresize`).
Counterpart of ``esrganplus_tpu/ops/resize.py``.

Semantics matched to the reference (``codes/data/util.py``):
  * cubic kernel a=-0.5 (``util.py:213-218``),
  * antialiasing widens the kernel by ``1/scale`` when downscaling (``util.py:221-224``),
  * source coordinates ``u = x/scale + 0.5*(1 - 1/scale)`` (``util.py:232``),
  * per-row weight normalisation and trimming of all-zero edge taps
    (``util.py:255-267``),
  * symmetric (reflect-with-repeat) boundary handling (``util.py:286-302``),
  * output size = ``ceil(in * scale)`` (``util.py:283``).

Weights are computed on host in float32 (like the reference's torch.FloatTensor path)
and cached per (in_len, out_len, scale) signature.
"""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = [
    "resize_matrix",
    "imresize",
    "imresize_np",
    "cubic_kernel",
]


def cubic_kernel(x: np.ndarray) -> np.ndarray:
    """Keys cubic convolution kernel with a = -0.5 (MATLAB's bicubic)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    near = 1.5 * ax3 - 2.5 * ax2 + 1.0
    far = -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0
    return np.where(ax <= 1.0, near, np.where(ax <= 2.0, far, 0.0)).astype(x.dtype)


def _reflect_index(idx: np.ndarray, n: int) -> np.ndarray:
    """Map out-of-range indices into [0, n) with symmetric (edge-repeating) reflection.

    Equivalent to indexing an array padded as [x[s-1::-1], x, x[:n-e-1:-1]] — i.e.
    MATLAB's 'symmetric' boundary — but expressed as index arithmetic so no padded
    copy is ever materialised. Periodic with period 2n, so it is correct even when
    the kernel support exceeds the input length.
    """
    period = 2 * n
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - 1 - idx, idx)


@functools.lru_cache(maxsize=256)
def resize_matrix(in_length: int, out_length: int, scale: float, antialiasing: bool = True) -> np.ndarray:
    """Dense [out_length, in_length] float32 matrix applying MATLAB bicubic resize
    along one axis, boundary handling folded in.
    """
    kernel_width = 4.0
    if scale < 1.0 and antialiasing:
        kernel_width = kernel_width / scale

    # Output pixel centres mapped into input space (1-based, like MATLAB).
    x = np.arange(1, out_length + 1, dtype=np.float32)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - kernel_width / 2.0)
    # Max taps per output pixel (+2 guard taps, trimmed below if unused).
    p = int(math.ceil(kernel_width)) + 2

    # [out, p] 1-based source indices and kernel weights.
    indices = left[:, None] + np.arange(p, dtype=np.float32)[None, :]
    dist = u[:, None] - indices
    if scale < 1.0 and antialiasing:
        weights = scale * cubic_kernel((dist * np.float32(scale)).astype(np.float32))
    else:
        weights = cubic_kernel(dist.astype(np.float32))
    weights = weights / np.sum(weights, axis=1, keepdims=True)

    # Trim guard taps whose weights are zero in every row (first/last column only,
    # mirroring the reference's narrow() logic).
    zero_cols = np.sum(weights == 0, axis=0)
    lo, hi = 0, p
    if not math.isclose(float(zero_cols[0]), 0.0, rel_tol=1e-6):
        lo += 1
    if not math.isclose(float(zero_cols[-1]), 0.0, rel_tol=1e-6):
        hi -= 1
    indices = indices[:, lo:hi]
    weights = weights[:, lo:hi]

    # 1-based → 0-based, then reflect out-of-range taps back inside.
    src = _reflect_index(indices.astype(np.int64) - 1, in_length)

    mat = np.zeros((out_length, in_length), dtype=np.float32)
    rows = np.repeat(np.arange(out_length), src.shape[1])
    np.add.at(mat, (rows, src.ravel()), weights.astype(np.float32).ravel())
    return mat


def _out_len(n: int, scale: float) -> int:
    return int(math.ceil(n * scale))


def imresize(img, scale: float, antialiasing: bool = True):
    """MATLAB-bicubic resize of a torch HWC (or ``[..., H, W, C]``) image in
    [0, 1] on its device, fp32 (TF32 off); H then W, the reference's pass order."""
    import torch

    from esrganplus_tpu_torch.models.layers import fp32_exact

    img = torch.as_tensor(img, dtype=torch.float32)
    h, w = img.shape[-3], img.shape[-2]
    rh = torch.from_numpy(resize_matrix(h, _out_len(h, scale), scale, antialiasing)).to(img.device)
    rw = torch.from_numpy(resize_matrix(w, _out_len(w, scale), scale, antialiasing)).to(img.device)
    with fp32_exact():
        out = torch.einsum("oh,...hwc->...owc", rh, img)
        return torch.einsum("ow,...hwc->...hoc", rw, out)


def imresize_np(img: np.ndarray, scale: float, antialiasing: bool = True) -> np.ndarray:
    """Host-side (numpy) variant for the data pipeline. HWC in, HWC out, float32.

    Drop-in behavioural equivalent of the reference's ``imresize_np``
    (``codes/data/util.py:345-412``) without the per-row Python loops.
    """
    img = np.asarray(img, dtype=np.float32)
    h, w = img.shape[0], img.shape[1]
    rh = resize_matrix(h, _out_len(h, scale), scale, antialiasing)
    rw = resize_matrix(w, _out_len(w, scale), scale, antialiasing)
    squeeze = False
    if img.ndim == 2:
        img = img[:, :, None]
        squeeze = True
    out = np.einsum("oh,hwc->owc", rh, img)
    out = np.einsum("ow,hwc->hoc", rw, out)
    return out[:, :, 0] if squeeze else out
