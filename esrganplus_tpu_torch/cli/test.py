"""Batch evaluation entry point (reference ``codes/test.py`` surface).

    python -m esrganplus_tpu_torch.cli.test -opt path/to/test_options.json
                                            [--device cuda|cpu]

Per test set: run ×scale SR on every image, save results under
``results/<name>/<set>/``, and report PSNR/SSIM (and Y-channel variants) with
the reference protocol: border crop = scale, BT.601 Y, MATLAB-style SSIM
(``codes/test.py:70-110``). Counterpart of ``esrganplus_tpu/cli/test.py``.

Runs on the card (``--device cuda``, the default) through the CUDA kernels;
``--device cpu`` runs the plain graph. ``test_mode`` is ``normal``, ``x8``
(geometric self-ensemble) or ``tiled``; ``compute_dtype: "bfloat16"`` selects
bf16. Images run one at a time, as the reference and the JAX package on one
device do. ``"eval_sharded": true`` in ``normal`` mode instead runs chunks of
four images per forward through ``infer.BatchedEvaluator`` (edge-padded to
the set's largest image: interior-exact, borders within the receptive radius
of the pad edge differ).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-opt", required=True, help="path to option JSON file")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from esrganplus_tpu_torch.data import EvalLoader, create_dataset
    from esrganplus_tpu_torch.infer import BatchedEvaluator, SRInferencer, load_generator
    from esrganplus_tpu_torch.ops.color import bgr2ycbcr
    from esrganplus_tpu_torch.ops.image_io import save_img, tensor2img
    from esrganplus_tpu_torch.ops.metrics import calculate_psnr, calculate_ssim
    from esrganplus_tpu_torch.options.options import build_net_g_config, dict2str, parse
    from esrganplus_tpu_torch.utils import setup_logger

    opt = parse(args.opt, is_train=False)
    os.makedirs(opt["path"]["results_root"], exist_ok=True)
    logger = setup_logger("base", opt["path"]["log"], "test", screen=True)
    logger.info(dict2str(opt))

    net_g = build_net_g_config(opt)
    model_path = opt["path"]["pretrain_model_G"]
    assert model_path, "path.pretrain_model_G must point to a checkpoint"
    params, net_g, info = load_generator(model_path, net_g, device=args.device)
    if info["missing_conv1x1_blocks"]:
        logger.info(f"checkpoint lacks conv1x1 for {len(info['missing_conv1x1_blocks'])} "
                    "RDBs; zeros substituted (vanilla-ESRGAN checkpoint)")
    dtype = torch.bfloat16 if (opt.get("compute_dtype") == "bfloat16") else None
    inferencer = SRInferencer(params, net_g, dtype=dtype, device=args.device)
    scale = net_g.upscale
    # mode: 'normal' | 'x8' (geometric self-ensemble) | 'tiled' (large inputs)
    mode = opt.get("test_mode") or "normal"
    if mode == "x8":
        upscale_fn = inferencer.upscale_x8
    elif mode == "tiled":
        upscale_fn = lambda img: inferencer.upscale_tiled(
            img, tile=opt.get("tile_size") or 128,
            halo=opt.get("tile_halo"))  # None → derived from the weights
    else:
        upscale_fn = inferencer.upscale

    batched = None
    if mode == "normal" and opt.get("eval_sharded") is True:
        batched = BatchedEvaluator(inferencer.params, net_g, dtype=dtype, device=args.device)
        logger.info(f"batched eval, {batched.batch} images a forward")

    def iter_results(test_set):
        loader = EvalLoader(test_set)
        if batched is None:
            for sample in loader:
                yield sample, upscale_fn(sample["LR"])
            return
        chunk: list = []
        for sample in loader:
            chunk.append(sample)
            if len(chunk) == batched.batch:
                yield from zip(chunk, batched.upscale_batch([c["LR"] for c in chunk]))
                chunk = []
        if chunk:
            yield from zip(chunk, batched.upscale_batch([c["LR"] for c in chunk]))

    for name, ds_opt in opt["datasets"].items():
        ds_opt["phase"] = "test"
        test_set = create_dataset(ds_opt)
        set_name = ds_opt.get("name", name)
        logger.info(f"\nTesting [{set_name}]...")
        dataset_dir = os.path.join(opt["path"]["results_root"], set_name)
        os.makedirs(dataset_dir, exist_ok=True)

        metrics = {"psnr": [], "ssim": [], "psnr_y": [], "ssim_y": []}
        t0 = time.time()
        for sample, sr in iter_results(test_set):
            base = os.path.splitext(os.path.basename(sample["LR_path"]))[0]
            sr_img = tensor2img(sr)  # BGR uint8
            suffix = opt.get("suffix") or ""
            save_img(sr_img, os.path.join(dataset_dir, base + suffix + ".png"))

            if "HR" in sample:
                gt_img = tensor2img(sample["HR"])
                sr_f = sr_img.astype(np.float64) / 255.0
                gt_f = gt_img.astype(np.float64) / 255.0
                c = scale
                sr_c = sr_f[c:-c, c:-c, ...]
                gt_c = gt_f[c:-c, c:-c, ...]
                psnr = calculate_psnr(sr_c * 255, gt_c * 255)
                ssim = calculate_ssim(sr_c * 255, gt_c * 255)
                metrics["psnr"].append(psnr)
                metrics["ssim"].append(ssim)
                if gt_img.ndim == 3:
                    sr_y = bgr2ycbcr(sr_f.astype(np.float32), only_y=True)
                    gt_y = bgr2ycbcr(gt_f.astype(np.float32), only_y=True)
                    psnr_y = calculate_psnr(sr_y[c:-c, c:-c] * 255, gt_y[c:-c, c:-c] * 255)
                    ssim_y = calculate_ssim(sr_y[c:-c, c:-c] * 255, gt_y[c:-c, c:-c] * 255)
                    metrics["psnr_y"].append(psnr_y)
                    metrics["ssim_y"].append(ssim_y)
                    logger.info(f"{base:20s} - PSNR: {psnr:.6f} dB; SSIM: {ssim:.6f}; "
                                f"PSNR_Y: {psnr_y:.6f} dB; SSIM_Y: {ssim_y:.6f}.")
                else:
                    logger.info(f"{base:20s} - PSNR: {psnr:.6f} dB; SSIM: {ssim:.6f}.")
            else:
                logger.info(base)

        if metrics["psnr"]:
            logger.info(f"[{set_name}] ({time.time()-t0:.1f}s) Average PSNR/SSIM: "
                        f"{np.mean(metrics['psnr']):.6f} dB / {np.mean(metrics['ssim']):.6f}")
            if metrics["psnr_y"]:
                logger.info(f"[{set_name}] Average PSNR_Y/SSIM_Y: "
                            f"{np.mean(metrics['psnr_y']):.6f} dB / {np.mean(metrics['ssim_y']):.6f}")


if __name__ == "__main__":
    main()
