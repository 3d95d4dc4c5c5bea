"""Dataset preparation: HR subimage extraction + mod-crop bicubic LR generation.

Covers the reference's offline data tools in one CLI:

  * ``subimgs``  — multiprocess 480×480/step-240 HR subimage cropping
    (``codes/scripts/extract_subimgs_single.py``);
  * ``modlrbic`` — modcrop + canonical bicubic LR (÷scale) and Bic (÷scale→×scale)
    generation (``codes/scripts/generate_mod_LR_bic.py``);
  * ``lmdb``     — pack an image folder into LMDB with ``<key>.meta`` shape
    records (``codes/scripts/create_lmdb.py``) through the pure-python
    writer (``data/lmdb_io.py``).

    python -m esrganplus_tpu_torch.cli.prepare_data subimgs  IN_DIR OUT_DIR [--crop 480 --step 240 --thres 48]
    python -m esrganplus_tpu_torch.cli.prepare_data modlrbic IN_DIR OUT_ROOT [--scale 4]
    python -m esrganplus_tpu_torch.cli.prepare_data lmdb     IN_DIR OUT.lmdb

Host work only (numpy/cv2): no device is touched. Counterpart of
``esrganplus_tpu/cli/prepare_data.py``; the outputs are the same bytes.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os

import numpy as np

from esrganplus_tpu_torch.ops.image_io import read_img, save_img, scan_images
from esrganplus_tpu_torch.ops.color import modcrop
from esrganplus_tpu_torch.ops.resize import imresize_np
from esrganplus_tpu_torch.utils.progress_bar import ProgressBar


def _extract_one(args):
    path, out_dir, crop, step, thres = args
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    base = os.path.splitext(os.path.basename(path))[0]
    h, w = img.shape[:2]

    def positions(n):
        pos = list(range(0, n - crop + 1, step))
        if n - (pos[-1] + crop) > thres if pos else n > crop:
            pos.append(n - crop)
        return pos or [0]

    idx = 0
    for y in positions(h):
        for x in positions(w):
            idx += 1
            sub = img[y:y + crop, x:x + crop, ...]
            cv2.imwrite(os.path.join(out_dir, f"{base}_s{idx:03d}.png"), sub,
                        [cv2.IMWRITE_PNG_COMPRESSION, 3])
    return path


def cmd_subimgs(args):
    os.makedirs(args.out, exist_ok=True)
    paths = scan_images(args.input)
    bar = ProgressBar(len(paths))
    # spawned workers: forking a process that holds threads is unsafe
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        for p in pool.imap_unordered(
                _extract_one,
                [(p, args.out, args.crop, args.step, args.thres) for p in paths]):
            bar.update(os.path.basename(p))
    print()


def cmd_modlrbic(args):
    scale = args.scale
    hr_dir = os.path.join(args.out, f"HR_x{scale}")
    lr_dir = os.path.join(args.out, f"LR_x{scale}")
    bic_dir = os.path.join(args.out, f"Bic_x{scale}")
    for d in (hr_dir, lr_dir, bic_dir):
        os.makedirs(d, exist_ok=True)
    paths = scan_images(args.input)
    bar = ProgressBar(len(paths))
    for p in paths:
        name = os.path.basename(p)
        img = modcrop(read_img(p), scale)
        lr = imresize_np(img, 1.0 / scale)
        bic = imresize_np(lr, float(scale))
        save_img((np.clip(img, 0, 1) * 255).round().astype(np.uint8), os.path.join(hr_dir, name))
        save_img((np.clip(lr, 0, 1) * 255).round().astype(np.uint8), os.path.join(lr_dir, name))
        save_img((np.clip(bic, 0, 1) * 255).round().astype(np.uint8), os.path.join(bic_dir, name))
        bar.update(name)
    print()


def cmd_lmdb(args):
    """Pack an image folder into an LMDB environment (create_lmdb.py:35-66):
    key = basename without extension, value = raw uint8 bytes, ``<key>.meta``
    = ``"H, W, C"``; finish by pickling a ``_keys_cache.p`` of every key in
    cursor order. Uses the pure-python writer (data/lmdb_io.py)."""
    import pickle

    import cv2

    from esrganplus_tpu_torch.data.lmdb_io import LmdbReader, write_lmdb

    items = {}
    paths = scan_images(args.input)
    bar = ProgressBar(len(paths))
    for p in paths:
        img = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        key = os.path.splitext(os.path.basename(p))[0]
        h, w = img.shape[:2]
        c = img.shape[2] if img.ndim == 3 else 1
        items[key.encode("ascii")] = np.ascontiguousarray(img).tobytes()
        items[f"{key}.meta".encode("ascii")] = f"{h}, {w}, {c}".encode("ascii")
        bar.update(key)
    write_lmdb(args.out, items)
    # key cache exactly as the reference builds it: cursor order, all keys
    keys = [k.decode("ascii") for k in LmdbReader(args.out).keys()]
    with open(os.path.join(args.out, "_keys_cache.p"), "wb") as f:
        pickle.dump(keys, f)
    print()


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    s1 = sub.add_parser("subimgs")
    s1.add_argument("input"); s1.add_argument("out")
    s1.add_argument("--crop", type=int, default=480)
    s1.add_argument("--step", type=int, default=240)
    s1.add_argument("--thres", type=int, default=48)
    s1.add_argument("--workers", type=int, default=8)
    s2 = sub.add_parser("modlrbic")
    s2.add_argument("input"); s2.add_argument("out")
    s2.add_argument("--scale", type=int, default=4)
    s3 = sub.add_parser("lmdb")
    s3.add_argument("input"); s3.add_argument("out")
    args = ap.parse_args(argv)
    {"subimgs": cmd_subimgs, "modlrbic": cmd_modlrbic, "lmdb": cmd_lmdb}[args.cmd](args)


if __name__ == "__main__":
    main()
