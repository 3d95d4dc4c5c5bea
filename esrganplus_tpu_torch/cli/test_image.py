"""One-shot ×4 SR over a folder of images (reference ``test_image/test.py`` surface).

    python -m esrganplus_tpu_torch.cli.test_image MODEL.pth [--input DIR] [--output DIR]
                                                  [--dtype fp32|bf16] [--device cuda|cpu]

Defaults mirror the reference: reads ``./LR`` relative to cwd, writes
``./results/<base>_rlt.png``. Runs on the card (``--device cuda``, the
default) through the CUDA kernels; ``--device cpu`` runs the plain graph.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="ESRGAN+ one-shot inference (PyTorch/CUDA)")
    ap.add_argument("model", help="path to RRDBNet .pth checkpoint")
    ap.add_argument("--input", default="LR", help="input image dir")
    ap.add_argument("--output", default="results", help="output dir")
    ap.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--suffix", default="_rlt")
    ap.add_argument("--pad-multiple", type=int, default=None,
                    help="edge-pad inputs to a multiple (inexact borders)")
    ap.add_argument("--noise-seed", type=int, default=None,
                    help="nESRGAN+/Tarsier noise sites (not yet ported)")
    ap.add_argument("--dump-activations", metavar="OUT.json", default=None,
                    help="also write per-stage activation stats (mean/rms/"
                         "maxabs per fea_conv, every RRDB, trunk, upconvs, HR "
                         "convs) for parity localisation")
    ap.add_argument("--compare-activations", metavar="REF.json", default=None,
                    help="compare the dumped stats against a reference dump "
                         "and report the first diverging stage")
    ap.add_argument("--act-tol", type=float, default=1e-4,
                    help="relative tolerance for --compare-activations")
    args = ap.parse_args(argv)
    if args.compare_activations and not args.dump_activations:
        ap.error("--compare-activations requires --dump-activations")
    if args.noise_seed is not None:
        ap.error("--noise-seed: the nESRGAN+/Tarsier noise mode is not yet ported "
                 "to the PyTorch package; use esrganplus_tpu.cli.test_image")

    import torch

    from esrganplus_tpu_torch.infer import SRInferencer, load_generator
    from esrganplus_tpu_torch.models.rrdb import rrdbnet_activations
    from esrganplus_tpu_torch.ops.image_io import img2tensor, read_img, save_img, scan_images

    params, cfg, info = load_generator(args.model, device=args.device)
    if info["missing_conv1x1_blocks"]:
        print(f"note: checkpoint lacks conv1x1 weights for "
              f"{len(info['missing_conv1x1_blocks'])} RDBs (vanilla-ESRGAN ckpt); using zeros")
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    inf = SRInferencer(params, cfg, dtype=dtype, pad_multiple=args.pad_multiple,
                       device=args.device)
    print(f"model: nb={cfg.nb} nf={cfg.nf} gc={cfg.gc} x{cfg.upscale} "
          f"conv1x1={cfg.conv1x1} dtype={args.dtype} device={inf.device}")

    os.makedirs(args.output, exist_ok=True)
    dumps = {}
    for i, path in enumerate(scan_images(args.input)):
        base = os.path.splitext(os.path.basename(path))[0]
        img = read_img(path)
        t0 = time.perf_counter()
        out = inf.upscale_bgr_to_png(img)  # ends in a device→host copy: synchronised
        dt = time.perf_counter() - t0
        dst = os.path.join(args.output, base + args.suffix + ".png")
        save_img(out, dst)
        mpix = out.shape[0] * out.shape[1] / 1e6
        print(f"[{i+1}] {base}: {img.shape[1]}x{img.shape[0]} -> "
              f"{out.shape[1]}x{out.shape[0]}  {dt:.3f}s ({mpix/dt:.2f} MPix/s out)  -> {dst}")
        if args.dump_activations:
            x = torch.from_numpy(img2tensor(img)[None]).to(inf.device)
            with torch.inference_mode():
                acts = rrdbnet_activations(params, x, cfg, dtype=dtype)
            dumps[base] = {name: activation_stats(a.float().cpu().numpy())
                           for name, a in acts.items()}

    if args.dump_activations:
        with open(args.dump_activations, "w") as f:
            json.dump({"model": args.model, "dtype": args.dtype,
                       "layout": "NHWC", "images": dumps}, f, indent=1)
        print(f"activation stats -> {args.dump_activations}")
    if args.compare_activations:
        with open(args.compare_activations) as f:
            ref = json.load(f)
        ok = compare_activation_dumps(dumps, ref["images"], tol=args.act_tol)
        raise SystemExit(0 if ok else 1)


def activation_stats(a) -> dict:
    """Layout-invariant scalar stats (float64 on host) of one activation."""
    a = np.asarray(a, np.float64)
    return {"shape": list(a.shape), "mean": float(a.mean()),
            "rms": float(np.sqrt((a * a).mean())), "maxabs": float(np.abs(a).max())}


def compare_activation_dumps(ours: dict, ref: dict, tol: float) -> bool:
    """Per-image, per-stage relative comparison of scalar stats (stages run in
    graph order, so the FIRST diverging stage localises a conversion fault)."""
    ok = True
    for image in ours:
        if image not in ref:
            print(f"{image}: not in reference dump, skipped")
            continue
        first_bad = None
        worst = 0.0
        for stage, s in ours[image].items():
            r = ref[image].get(stage)
            if r is None:
                print(f"{image}/{stage}: missing from reference dump")
                ok = False
                continue
            if sorted(s["shape"]) != sorted(r["shape"]):
                print(f"{image}/{stage}: shape {s['shape']} vs {r['shape']}")
                first_bad = (stage, float("inf"))
                break
            rel = max(abs(s[k] - r[k]) / max(abs(r[k]), 1e-12)
                      for k in ("mean", "rms", "maxabs"))
            worst = max(worst, rel)
            if rel > tol and first_bad is None:
                first_bad = (stage, rel)
        if first_bad:
            stage, rel = first_bad
            print(f"{image}: FIRST DIVERGING STAGE {stage} (rel {rel:.3e} > "
                  f"{tol:g}) — inspect the converter keys feeding it")
            ok = False
        else:
            print(f"{image}: all stages match (worst rel {worst:.3e})")
    return ok


if __name__ == "__main__":
    main()
