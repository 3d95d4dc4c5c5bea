"""SFT-GAN inference (reference ``codes/test_sftgan.py``).

    python -m esrganplus_tpu_torch.cli.test_sftgan MODEL.pth --input DIR --segprob DIR
        [--output DIR] [--legacy] [--device cuda|cpu]

Counterpart of ``esrganplus_tpu/cli/test_sftgan.py``. Per HR image: modcrop 8
→ RGB [0,1] → bicubic ÷4 LR; the seg probabilities from
``<segprob>/<base>_bic.pth`` (what ``cli.test_seg`` writes); the fp32 forward
of (LR, seg) → ``<output>/<base>_rlt.png``. ``--legacy`` selects the
torch-version SFT semantics (``SFT_Net_torch``, reference
``sft_arch.py:150-226``). Runs on the card (``--device cuda``, the default;
cuDNN, no kernel of the port); ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="SFT-GAN inference (PyTorch/CUDA)")
    ap.add_argument("model", help="SFT_Net .pth checkpoint")
    ap.add_argument("--input", required=True, help="HR image folder")
    ap.add_argument("--segprob", required=True, help="folder of <base>_bic.pth seg maps")
    ap.add_argument("--output", default="results_sftgan")
    ap.add_argument("--legacy", action="store_true", help="torch-version SFT semantics")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from esrganplus_tpu_torch.infer import SRInferencer, load_generator
    from esrganplus_tpu_torch.models.sft import SFTNetConfig
    from esrganplus_tpu_torch.ops.color import modcrop
    from esrganplus_tpu_torch.ops.image_io import (img2tensor, read_img, save_img, scan_images,
                                                   tensor2img)
    from esrganplus_tpu_torch.ops.resize import imresize_np

    params, cfg, _ = load_generator(args.model, SFTNetConfig(legacy=args.legacy),
                                    device=args.device)
    inferencer = SRInferencer(params, cfg, device=args.device)
    os.makedirs(args.output, exist_ok=True)
    for path in scan_images(args.input):
        base = os.path.splitext(os.path.basename(path))[0]
        img = modcrop(read_img(path), 8)  # BGR [0,1]
        lr_rgb = img2tensor(np.clip(imresize_np(img, 0.25), 0, 1))
        seg = torch.load(os.path.join(args.segprob, base + "_bic.pth"),
                         map_location="cpu", weights_only=True)
        seg = np.transpose(np.asarray(seg, np.float32), (1, 2, 0))  # [H, W, 8]
        out = inferencer.upscale(lr_rgb, side=seg)
        save_img(tensor2img(out), os.path.join(args.output, base + "_rlt.png"))
        print(base, out.shape)


if __name__ == "__main__":
    main()
