"""One-shot quality-parity check against a supplied weights file.

The Set5/Set14 ±0.01 dB contract (BASELINE.md) needs the upstream pretrained
checkpoints, which are external downloads (reference
``README.md:26,32-33``) not shipped in this repository. This CLI is the
executable form of PARITY.md's recipe for the day the weights ARE in hand —
converter → inference → metrics → (optional) activation compare, one command:

    python -m esrganplus_tpu_torch.cli.parity_check nESRGANplus.pth \
        --lr  test_image/LR \
        [--hr SET5_HR_DIR]                    # PSNR/SSIM vs ground truth
        [--ref-results REF_PNG_DIR]           # the reference net's own outputs
        [--torch-acts ref_acts.json]          # tools/dump_torch_activations.py
        [--out /tmp/parity] [--psnr-tol 0.01] [--device cuda|cpu]

Checks (each optional input enables one):
  1. converter accepts the checkpoint and reports the inferred architecture;
  2. fp32 parity-path inference over --lr writes SR outputs;
  3. --hr: PSNR_Y/SSIM (crop 4, MATLAB protocol) of our outputs;
  4. --ref-results: the same metrics on the reference's shipped outputs and
     the per-image |ΔPSNR| between the two runs (must be ≤ --psnr-tol);
  5. --torch-acts: the 29-stage activation-stat compare that localises any
     conversion fault to one graph stage.

Exit 0 iff every enabled check passes. Inference runs through the port's
``cli/test_image.py`` on the card (``--device cuda``, the default) or, with
``--device cpu``, on the plain graph. Counterpart of
``esrganplus_tpu/cli/parity_check.py``.
"""

from __future__ import annotations

import argparse
import json
import os


def _metrics_over(gt_dir: str, sr_dir: str, suffix: str, crop: int = 4):
    """MATLAB-protocol PSNR_Y/SSIM_Y per image, paired by basename."""
    from esrganplus_tpu_torch.ops.color import bgr2ycbcr
    from esrganplus_tpu_torch.ops.image_io import read_img, scan_images
    from esrganplus_tpu_torch.ops.metrics import calculate_psnr, calculate_ssim

    out = {}
    for gt_path in scan_images(gt_dir):
        base = os.path.splitext(os.path.basename(gt_path))[0]
        sr_path = os.path.join(sr_dir, base + suffix + ".png")
        if not os.path.exists(sr_path):
            continue
        gt, sr = read_img(gt_path), read_img(sr_path)
        if gt.shape != sr.shape:
            continue
        if gt.shape[2] == 3:
            gt = bgr2ycbcr(gt, only_y=True)
            sr = bgr2ycbcr(sr, only_y=True)
        if crop:
            gt = gt[crop:-crop, crop:-crop]
            sr = sr[crop:-crop, crop:-crop]
        out[base] = (calculate_psnr(gt * 255, sr * 255),
                     calculate_ssim(gt * 255, sr * 255))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="quality-parity check (PARITY.md recipe, one shot)")
    ap.add_argument("model", help="path to the pretrained RRDBNet .pth")
    ap.add_argument("--lr", required=True, help="LR input image dir")
    ap.add_argument("--hr", default=None, help="HR ground-truth dir")
    ap.add_argument("--ref-results", default=None,
                    help="dir of the reference implementation's SR outputs "
                         "(e.g. test_image/results), suffix via --ref-suffix")
    ap.add_argument("--ref-suffix", default="_nESRGANplus")
    ap.add_argument("--torch-acts", default=None,
                    help="reference activation dump from "
                         "tools/dump_torch_activations.py")
    ap.add_argument("--out", default="parity_out")
    ap.add_argument("--psnr-tol", type=float, default=0.01,
                    help="max |PSNR(ours) - PSNR(reference)| in dB")
    ap.add_argument("--act-tol", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.ref_results and not args.hr:
        ap.error("--ref-results needs --hr for the metric comparison")

    from esrganplus_tpu_torch.cli import test_image

    os.makedirs(args.out, exist_ok=True)
    sr_dir = os.path.join(args.out, "sr")
    failures = []

    # 1+2 (+5): converter, fp32 inference, optional activation compare
    ti_args = [args.model, "--input", args.lr, "--output", sr_dir,
               "--dtype", "fp32", "--device", args.device]
    if args.torch_acts:
        ti_args += ["--dump-activations", os.path.join(args.out, "acts.json"),
                    "--compare-activations", args.torch_acts,
                    "--act-tol", str(args.act_tol)]
    try:
        test_image.main(ti_args)
    except SystemExit as e:  # raised by --compare-activations
        if e.code:
            failures.append("activation-compare: a graph stage diverges "
                            "(see the FIRST DIVERGING STAGE line above)")

    # 3: our metrics vs HR
    ours = {}
    if args.hr:
        ours = _metrics_over(args.hr, sr_dir, "_rlt")
        if not ours:
            failures.append("metrics: no (HR, SR) pairs matched by basename")
        for base, (p, s) in sorted(ours.items()):
            print(f"ours    {base}: PSNR_Y {p:.4f} dB  SSIM {s:.5f}")
        if ours:
            avg = sum(p for p, _ in ours.values()) / len(ours)
            print(f"ours    average PSNR_Y {avg:.4f} dB over {len(ours)}")

    # 4: the reference outputs' metrics + per-image delta
    if args.ref_results:
        ref = _metrics_over(args.hr, args.ref_results, args.ref_suffix)
        if not ref:
            failures.append("ref-results: no (HR, ref SR) pairs matched")
        common = sorted(set(ours) & set(ref))
        if not common and ours and ref:
            failures.append("PSNR delta: ours and ref-results share no "
                            "basenames — nothing was compared")
        worst = 0.0
        for base in common:
            d = abs(ours[base][0] - ref[base][0])
            worst = max(worst, d)
            print(f"ref     {base}: PSNR_Y {ref[base][0]:.4f} dB  "
                  f"|delta| {d:.4f} dB")
        if worst > args.psnr_tol:
            failures.append(f"PSNR delta: worst |delta| {worst:.4f} dB > "
                            f"{args.psnr_tol} dB")
        elif common:
            print(f"PSNR parity: worst |delta| {worst:.4f} dB "
                  f"<= {args.psnr_tol} dB over {len(common)} images")

    summary = {"model": args.model, "failures": failures}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if failures:
        print("PARITY CHECK FAILED:")
        for msg in failures:
            print(f"  - {msg}")
        return 1
    print("PARITY CHECK PASSED (all enabled checks)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
