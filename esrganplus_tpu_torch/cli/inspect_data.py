"""Dataloader smoke inspection (reference ``codes/test_dataloader.py`` surface).

    python -m esrganplus_tpu_torch.cli.inspect_data -opt train_options.json
        [--batches 3] [--out tmp_data]

Iterates a few batches of the configured train dataset and writes LR/HR grids
(and colourised seg maps for seg datasets) as PNGs for visual inspection.
Host work only: no device is touched. Counterpart of
``esrganplus_tpu/cli/inspect_data.py``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _grid(batch_imgs: np.ndarray, cols: int = 4) -> np.ndarray:
    n, h, w, c = batch_imgs.shape
    rows = -(-n // cols)
    canvas = np.zeros((rows * h, cols * w, c), batch_imgs.dtype)
    for i, img in enumerate(batch_imgs):
        r, col = divmod(i, cols)
        canvas[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
    return canvas


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-opt", required=True)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--out", default="tmp_data")
    args = ap.parse_args(argv)

    from esrganplus_tpu_torch.cli.test_seg import LOOKUP
    from esrganplus_tpu_torch.data import create_dataloader, create_dataset
    from esrganplus_tpu_torch.ops.image_io import save_img
    from esrganplus_tpu_torch.options.options import parse

    opt = parse(args.opt, is_train=True)
    ds_opt = next(d for d in opt["datasets"].values() if d["phase"] == "train")
    ds = create_dataset(ds_opt)
    loader = create_dataloader(ds, ds_opt, seed=0)
    os.makedirs(args.out, exist_ok=True)
    it = iter(loader)
    for i in range(args.batches):
        batch = next(it)
        for key in ("LR", "HR"):
            grid = _grid(batch[key][..., ::-1])  # RGB → BGR for cv2
            save_img((np.clip(grid, 0, 1) * 255).round().astype(np.uint8),
                     os.path.join(args.out, f"batch{i}_{key}.png"))
        if "seg" in batch:
            argmax = batch["seg"].argmax(-1).astype(np.uint8)
            color = LOOKUP[np.minimum(argmax, 8)][..., ::-1]
            save_img((_grid(color) * 255).round().astype(np.uint8),
                     os.path.join(args.out, f"batch{i}_seg.png"))
        print(f"batch {i}: " + " ".join(
            f"{k}:{tuple(v.shape)}" for k, v in batch.items() if isinstance(v, np.ndarray)))
    if hasattr(loader, "stop"):
        loader.stop()


if __name__ == "__main__":
    main()
