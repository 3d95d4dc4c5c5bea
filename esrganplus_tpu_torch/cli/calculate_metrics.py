"""Standalone PSNR/SSIM evaluator over result folders.

Reference surface: ``metrics/calculate_PSNR_SSIM.py`` — pairs images by sorted
order between a ground-truth folder and a results folder, crops ``--crop-border``
px, optionally evaluates on the BT.601 Y channel, reports per-image and average
metrics. Host metrics only (numpy/cv2, float64): no device is touched.
Counterpart of ``esrganplus_tpu/cli/calculate_metrics.py``.

    python -m esrganplus_tpu_torch.cli.calculate_metrics GT_DIR SR_DIR
        [--crop-border 4] [--test-y] [--suffix _rlt]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("gt", help="ground-truth image folder")
    ap.add_argument("sr", help="super-resolved results folder")
    ap.add_argument("--crop-border", type=int, default=4)
    ap.add_argument("--test-y", action="store_true", help="evaluate on the Y channel")
    ap.add_argument("--suffix", default="", help="suffix of result names vs GT names")
    args = ap.parse_args(argv)

    from esrganplus_tpu_torch.ops.color import bgr2ycbcr
    from esrganplus_tpu_torch.ops.image_io import read_img, scan_images
    from esrganplus_tpu_torch.ops.metrics import calculate_psnr, calculate_ssim

    gt_paths = scan_images(args.gt)
    psnrs, ssims = [], []
    for i, gt_path in enumerate(gt_paths):
        base = os.path.splitext(os.path.basename(gt_path))[0]
        sr_path = os.path.join(args.sr, base + args.suffix + ".png")
        if not os.path.exists(sr_path):
            print(f"skip {base}: no result at {sr_path}")
            continue
        gt = read_img(gt_path)
        sr = read_img(sr_path)
        if gt.shape != sr.shape:
            print(f"skip {base}: shape mismatch {gt.shape} vs {sr.shape}")
            continue
        if args.test_y and gt.shape[2] == 3:
            gt = bgr2ycbcr(gt, only_y=True)
            sr = bgr2ycbcr(sr, only_y=True)
        c = args.crop_border
        if c > 0:
            gt = gt[c:-c, c:-c, ...]
            sr = sr[c:-c, c:-c, ...]
        psnr = calculate_psnr(gt * 255, sr * 255)
        ssim = calculate_ssim(gt * 255, sr * 255)
        psnrs.append(psnr)
        ssims.append(ssim)
        print(f"{i + 1:3d} - {base:25s} PSNR: {psnr:.6f} dB, SSIM: {ssim:.6f}")
    if psnrs:
        print(f"Average: PSNR: {np.mean(psnrs):.6f} dB, SSIM: {np.mean(ssims):.6f}")


if __name__ == "__main__":
    main()
