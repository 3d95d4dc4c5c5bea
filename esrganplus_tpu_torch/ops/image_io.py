"""Image I/O and array↔image conventions (a copy of
``esrganplus_tpu/ops/image_io.py``, which the port may not import).

Conventions follow the reference so checkpoint parity is bit-comparable: images on
disk are read with cv2 (BGR, HWC, uint8), converted to float32 [0,1]; model tensors
are RGB in NHWC layout (the reference is NCHW). ``tensor2img`` mirrors
``codes/utils/util.py:71-95``: clamp → ×255 → round → uint8 → RGB→BGR for saving
with cv2.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["read_img", "save_img", "decode_img", "encode_png", "img2tensor",
           "tensor2img", "is_image_file", "scan_images"]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".tiff", ".JPG", ".JPEG", ".PNG", ".BMP")


def is_image_file(name: str) -> bool:
    return name.endswith(IMG_EXTENSIONS)


def scan_images(root: str):
    """Sorted list of image paths under ``root`` (recursive)."""
    assert os.path.isdir(root), f"{root} is not a directory"
    out = []
    for dirpath, _, fnames in sorted(os.walk(root)):
        for f in sorted(fnames):
            if is_image_file(f):
                out.append(os.path.join(dirpath, f))
    assert out, f"{root} contains no images"
    return out


def read_img(path: str) -> np.ndarray:
    """Read an image file → float32 HWC BGR in [0,1]; gray expanded, alpha stripped."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return img


def decode_img(data: bytes) -> np.ndarray:
    """Decode encoded image bytes (PNG/JPEG/...) → float32 HWC BGR in [0,1]
    (same conventions as :func:`read_img`; serving path)."""
    import cv2

    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError("undecodable image payload")
    img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return img


def encode_png(img: np.ndarray) -> bytes:
    """HWC BGR uint8 → PNG bytes (serving path)."""
    import cv2

    ok, buf = cv2.imencode(".png", img)
    if not ok:
        raise ValueError("png encode failed")
    return bytes(buf.tobytes())


def save_img(img: np.ndarray, path: str) -> None:
    """Write an HWC BGR uint8 image with cv2."""
    import cv2

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cv2.imwrite(path, img)


def img2tensor(img_bgr: np.ndarray) -> np.ndarray:
    """HWC BGR [0,1] → HWC RGB float32 (NHWC model layout; add batch dim yourself)."""
    return np.ascontiguousarray(img_bgr[:, :, ::-1], dtype=np.float32)


def tensor2img(tensor, out_type=np.uint8, min_max=(0.0, 1.0)) -> np.ndarray:
    """[B?, H, W, C] RGB float in ``min_max`` → HWC BGR uint8 (or float in [0,1]).

    4-D inputs must have batch 1 (the reference tiles grids for larger batches; our
    eval path always passes single images).
    """
    x = np.asarray(tensor, dtype=np.float32)
    if x.ndim == 4:
        assert x.shape[0] == 1, "tensor2img expects batch 1 for 4-D input"
        x = x[0]
    x = np.clip(x, min_max[0], min_max[1])
    x = (x - min_max[0]) / (min_max[1] - min_max[0])
    if x.ndim == 3 and x.shape[2] == 3:
        x = x[:, :, ::-1]  # RGB → BGR
    elif x.ndim == 3 and x.shape[2] == 1:
        x = x[:, :, 0]
    if out_type == np.uint8:
        x = (x * 255.0).round().astype(np.uint8)
    return x
