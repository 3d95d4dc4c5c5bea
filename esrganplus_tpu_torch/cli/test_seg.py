"""Segmentation inference for SFT-GAN's conditioning (reference ``codes/test_seg.py``).

    python -m esrganplus_tpu_torch.cli.test_seg MODEL.pth --input DIR --output ROOT
        [--device cuda|cpu]

Counterpart of ``esrganplus_tpu/cli/test_seg.py``. Per HR image: modcrop 8,
bicubic ÷4 then ×4 (the "bic" degradation), Caffe-style BGR mean subtraction,
the OutdoorSceneSeg forward → the probability map
``<ROOT>_segprob/<base>_bic.pth`` (a torch ``[8, H, W]`` tensor, the
reference's format), the argmax as bytes in ``<ROOT>_byteimg/<base>.png`` and
colourised in ``<ROOT>_colorimg/<base>.png``. Runs on the card (``--device
cuda``, the default; cuDNN, no kernel of the port); ``--device cpu`` runs on
the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# RGB lookup, class 0..7 + void (reference test_seg.py:34-45)
LOOKUP = np.array([
    [153, 153, 153], [0, 255, 255], [109, 158, 235], [183, 225, 205],
    [153, 0, 255], [17, 85, 204], [106, 168, 79], [224, 102, 102],
    [255, 255, 255],
], np.float32) / 255.0

BGR_MEANS = (103.939, 116.779, 123.68)


def seg_input(img_bgr01: np.ndarray) -> np.ndarray:
    """A BGR [0,1] HR image → the seg net's input: modcrop 8, bicubic ÷4 then
    ×4, ×255, less the Caffe BGR means (HWC float32)."""
    from esrganplus_tpu_torch.ops.color import modcrop
    from esrganplus_tpu_torch.ops.resize import imresize_np

    img = modcrop(img_bgr01, 8)
    img_bic = imresize_np(imresize_np(img, 0.25), 4.0) * 255.0
    return (img_bic - np.asarray(BGR_MEANS, np.float32)).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description="OutdoorSceneSeg inference (PyTorch/CUDA)")
    ap.add_argument("model", help="segmentation .pth checkpoint")
    ap.add_argument("--input", required=True, help="HR image folder")
    ap.add_argument("--output", required=True, help="output root (creates *_segprob etc.)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from esrganplus_tpu_torch.convert.pth import load_state_dict
    from esrganplus_tpu_torch.infer import params_to, resolve_device
    from esrganplus_tpu_torch.models.layers import fp32_exact
    from esrganplus_tpu_torch.models.seg import seg_forward, seg_from_state_dict
    from esrganplus_tpu_torch.ops.image_io import read_img, save_img, scan_images

    device = resolve_device(args.device)
    params = params_to(seg_from_state_dict(load_state_dict(args.model)), device)
    prob_dir, byte_dir, color_dir = (args.output + s for s in
                                     ("_segprob", "_byteimg", "_colorimg"))
    for d in (prob_dir, byte_dir, color_dir):
        os.makedirs(d, exist_ok=True)

    for path in scan_images(args.input):
        base = os.path.splitext(os.path.basename(path))[0]
        x = seg_input(read_img(path))
        xt = torch.from_numpy(x.reshape((1,) + x.shape)).to(device)
        with torch.inference_mode(), fp32_exact():
            prob = seg_forward(params, xt)[0].cpu().numpy()  # [H, W, 8]
        # the reference's prob map: a torch tensor [8, H, W]
        torch.save(torch.from_numpy(np.ascontiguousarray(np.transpose(prob, (2, 0, 1)))),
                   os.path.join(prob_dir, base + "_bic.pth"))
        argmax = prob.argmax(-1).astype(np.uint8)
        save_img(argmax, os.path.join(byte_dir, base + ".png"))
        color_rgb = LOOKUP[np.minimum(argmax, 8)]
        save_img((color_rgb[:, :, ::-1] * 255).round().astype(np.uint8),
                 os.path.join(color_dir, base + ".png"))
        print(base, prob.shape)


if __name__ == "__main__":
    main()
