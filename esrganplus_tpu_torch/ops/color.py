"""ITU-R BT.601 (MATLAB-compatible) colour-space conversions and crop helpers.

Behavioural spec comes from the reference's numpy implementations
(``codes/data/util.py:109-204``): float inputs are treated as [0,1] and returned in
[0,1]; uint8 inputs are treated as [0,255] and returned rounded uint8. Unlike the
reference, these never mutate their input. All are plain numpy (host-side eval path);
``y_channel`` is the torch variant for tensors on the device. Counterpart of
``esrganplus_tpu/ops/color.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "rgb2ycbcr",
    "bgr2ycbcr",
    "ycbcr2rgb",
    "channel_convert",
    "modcrop",
    "y_channel",
]

# Y/Cb/Cr weights for RGB input, columns = (Y, Cb, Cr). BT.601 full-swing,
# scaled for the 16-235 studio range as MATLAB's rgb2ycbcr does.
_RGB2YCBCR = np.array(
    [
        [65.481, -37.797, 112.0],
        [128.553, -74.203, -93.786],
        [24.966, 112.0, -18.214],
    ],
    dtype=np.float64,
)
_YCBCR_OFFSET = np.array([16.0, 128.0, 128.0], dtype=np.float64)

_YCBCR2RGB = np.array(
    [
        [0.00456621, 0.00456621, 0.00456621],
        [0.0, -0.00153632, 0.00791071],
        [0.00625893, -0.00318811, 0.0],
    ],
    dtype=np.float64,
)
_RGB_OFFSET = np.array([-222.921, 135.576, -276.836], dtype=np.float64)


def _to_255(img: np.ndarray):
    """Return (img_in_0_255_float, was_uint8)."""
    if img.dtype == np.uint8:
        return img.astype(np.float64), True
    return np.asarray(img, dtype=np.float64) * 255.0, False


def _from_255(out: np.ndarray, was_uint8: bool, orig_dtype) -> np.ndarray:
    if was_uint8:
        return out.round().astype(np.uint8)
    return (out / 255.0).astype(orig_dtype)


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """HWC RGB → Y (or YCbCr). Matches MATLAB ``rgb2ycbcr``."""
    x, was_u8 = _to_255(img)
    if only_y:
        out = x @ _RGB2YCBCR[:, 0] / 255.0 + 16.0
    else:
        out = x @ _RGB2YCBCR / 255.0 + _YCBCR_OFFSET
    return _from_255(out, was_u8, img.dtype)


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """HWC BGR → Y (or YCbCr); the reference's on-disk images are BGR (cv2)."""
    x, was_u8 = _to_255(img)
    if only_y:
        out = x @ _RGB2YCBCR[::-1, 0] / 255.0 + 16.0
    else:
        out = x @ _RGB2YCBCR[::-1, :] / 255.0 + _YCBCR_OFFSET
    return _from_255(out, was_u8, img.dtype)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """HWC YCbCr → RGB. Matches MATLAB ``ycbcr2rgb``."""
    x, was_u8 = _to_255(img)
    out = x @ _YCBCR2RGB * 255.0 + _RGB_OFFSET
    return _from_255(out, was_u8, img.dtype)


def channel_convert(in_c: int, tar_type: str, img_list):
    """Convert a list of HWC images among BGR / gray / Y (reference ``util.py:109-120``)."""
    if in_c == 3 and tar_type == "gray":
        import cv2

        return [np.expand_dims(cv2.cvtColor(im, cv2.COLOR_BGR2GRAY), axis=2) for im in img_list]
    if in_c == 3 and tar_type == "y":
        return [np.expand_dims(bgr2ycbcr(im, only_y=True), axis=2) for im in img_list]
    if in_c == 1 and tar_type == "RGB":
        import cv2

        return [cv2.cvtColor(im, cv2.COLOR_GRAY2BGR) for im in img_list]
    return img_list


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H and W down to multiples of ``scale`` (reference ``util.py:191-204``)."""
    if img.ndim == 2:
        h, w = img.shape
        return img[: h - h % scale, : w - w % scale]
    if img.ndim == 3:
        h, w = img.shape[:2]
        return img[: h - h % scale, : w - w % scale, :]
    raise ValueError(f"modcrop: bad ndim {img.ndim}")


def y_channel(img, channel_order: str = "rgb"):
    """Y extraction from a torch ``[..., H, W, 3]`` image in [0, 1] → ``[..., H, W]``.

    Output is in [0, 1] (i.e. the MATLAB Y value divided by 255), matching the
    float path of :func:`rgb2ycbcr`.
    """
    import torch

    w = torch.as_tensor(_RGB2YCBCR[:, 0].copy(), dtype=img.dtype, device=img.device)
    if channel_order == "bgr":
        w = w.flip(0)
    return (img * 255.0) @ w / 255.0 / 255.0 + 16.0 / 255.0
