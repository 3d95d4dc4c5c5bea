"""Network interpolation: the perception-distortion trade-off dial.

    python -m esrganplus_tpu_torch.cli.net_interp ALPHA PSNR.pth ESRGAN.pth OUT.pth

Counterpart of ``esrganplus_tpu/cli/net_interp.py``: the per-key linear blend
``(1-α)·W_psnr + α·W_gan`` (reference ``codes/scripts/net_interp.py:16-18``)
of reference checkpoints or checkpoints either package exported (same
layout). A key present in only one checkpoint (e.g. conv1x1 when blending a
vanilla-ESRGAN PSNR model with an ESRGAN+ model) is blended against zeros,
which matches the vanilla graph's semantics. It edits checkpoint files on
the host; no device is touched.
"""

from __future__ import annotations

import argparse

import numpy as np


def interpolate_state_dicts(sd_a, sd_b, alpha: float):
    out = {}
    for k in set(sd_a) | set(sd_b):
        a = sd_a.get(k)
        b = sd_b.get(k)
        if a is None:
            a = np.zeros_like(b)
        if b is None:
            b = np.zeros_like(a)
        out[k] = (1.0 - alpha) * a + alpha * b
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("alpha", type=float, help="0 = pure first model, 1 = pure second")
    ap.add_argument("model_a", help="PSNR-oriented checkpoint (.pth)")
    ap.add_argument("model_b", help="GAN-oriented checkpoint (.pth)")
    ap.add_argument("out", help="output .pth path")
    args = ap.parse_args(argv)

    import torch

    from esrganplus_tpu_torch.convert import load_state_dict

    numpy = lambda path: {k: v.numpy() for k, v in load_state_dict(path).items()}
    sd_a, sd_b = numpy(args.model_a), numpy(args.model_b)
    blended = interpolate_state_dicts(sd_a, sd_b, args.alpha)
    torch.save({k: torch.from_numpy(np.array(v, copy=True)) for k, v in blended.items()},
               args.out)
    print(f"alpha={args.alpha}: wrote {len(blended)} keys -> {args.out}")


if __name__ == "__main__":
    main()
