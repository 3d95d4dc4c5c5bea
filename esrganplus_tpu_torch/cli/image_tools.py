"""Misc offline image utilities (reference ``codes/scripts/`` long tail).

    python -m esrganplus_tpu_torch.cli.image_tools color2gray IN_DIR OUT_DIR
    python -m esrganplus_tpu_torch.cli.image_tools rename IN_DIR --pattern "{base}_x4"
    python -m esrganplus_tpu_torch.cli.image_tools patches IN_DIR OUT_DIR --x 10 --y 10 --w 96 --h 96 --enlarge 3
    python -m esrganplus_tpu_torch.cli.image_tools video IN_DIR OUT.avi --fps 10
    python -m esrganplus_tpu_torch.cli.image_tools annotate IN_DIR OUT_DIR --text a b c
    python -m esrganplus_tpu_torch.cli.image_tools gif IN_DIR OUT.gif --duration 0.8
    python -m esrganplus_tpu_torch.cli.image_tools backproject SR_DIR LR_DIR OUT_DIR --scale 4 --iters 10 [--device cuda|cpu]

Counterpart of ``esrganplus_tpu/cli/image_tools.py``. Covers: ``color2gray.py``, ``rename.py``, ``extract_enlarge_patches.py``,
``make_gif_video.py`` (frame crop/enlarge/text annotation, GIF, and video
output), and the MATLAB back-projection scripts
(``metrics/back_projection/*.m``). Only ``backproject`` computes on a
device (``ops/back_projection.py``): the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from esrganplus_tpu_torch.ops.image_io import read_img, save_img, scan_images


def cmd_color2gray(args):
    import cv2

    os.makedirs(args.out, exist_ok=True)
    for p in scan_images(args.input):
        img = cv2.imread(p)
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        cv2.imwrite(os.path.join(args.out, os.path.basename(p)), gray)
        print(os.path.basename(p))


def cmd_rename(args):
    for p in scan_images(args.input):
        base, ext = os.path.splitext(os.path.basename(p))
        new = args.pattern.format(base=base) + ext
        os.rename(p, os.path.join(os.path.dirname(p), new))
        print(f"{base}{ext} -> {new}")


def cmd_patches(args):
    import cv2

    os.makedirs(args.out, exist_ok=True)
    for p in scan_images(args.input):
        img = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        patch = img[args.y:args.y + args.h, args.x:args.x + args.w, ...]
        if args.enlarge > 1:
            patch = cv2.resize(patch, None, fx=args.enlarge, fy=args.enlarge,
                               interpolation=cv2.INTER_NEAREST)
        base = os.path.splitext(os.path.basename(p))[0]
        cv2.imwrite(os.path.join(args.out, base + "_patch.png"), patch)
        print(base)


def cmd_video(args):
    import cv2

    paths = scan_images(args.input)
    first = cv2.imread(paths[0])
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"MJPG"), args.fps, (w, h))
    for p in paths:
        frame = cv2.imread(p)
        if frame.shape[:2] != (h, w):
            frame = cv2.resize(frame, (w, h))
        vw.write(frame)
    vw.release()
    print(f"wrote {len(paths)} frames -> {args.out}")


# Reference colour table (make_gif_video.py:39-50), BGR.
_COLOR_TB = {
    "yellow": (0, 255, 255), "green": (0, 255, 0), "red": (0, 0, 255),
    "magenta": (255, 0, 255), "matlab_blue": (189, 114, 0),
    "matlab_orange": (25, 83, 217), "matlab_yellow": (32, 177, 237),
    "matlab_purple": (142, 47, 126), "matlab_green": (48, 172, 119),
    "matlab_liblue": (238, 190, 77), "matlab_brown": (47, 20, 162),
}


def cmd_annotate(args):
    """Crop/enlarge frames and burn a text label into each
    (``make_gif_video.py:66-95``): writes ``<base>_text.png`` per input."""
    import cv2

    paths = scan_images(args.input)
    texts = args.text or [str(i + 1) for i in range(len(paths))]
    if len(texts) != len(paths):
        raise SystemExit(f"{len(texts)} --text labels for {len(paths)} images")
    os.makedirs(args.out, exist_ok=True)
    for p, txt in zip(paths, texts):
        img = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        base = os.path.splitext(os.path.basename(p))[0]
        # reference semantics: crop only when both offsets are nonzero
        if args.crop_y > 0 and args.crop_x > 0:
            img = img[args.crop_y:args.crop_y + args.crop_h,
                      args.crop_x:args.crop_x + args.crop_w, ...]
        if args.enlarge > 1:
            h, w = img.shape[:2]
            img = cv2.resize(img, (w * args.enlarge, h * args.enlarge),
                             interpolation=cv2.INTER_CUBIC)
        cv2.putText(img, txt, tuple(args.pos), cv2.FONT_HERSHEY_COMPLEX,
                    args.font_size, _COLOR_TB[args.color], args.thickness,
                    cv2.LINE_AA)
        cv2.imwrite(os.path.join(args.out, base + "_text.png"), img)
        print(base)


def cmd_gif(args):
    """Animated GIF from an image folder (``make_gif_video.py:97-99``)."""
    import cv2
    import imageio

    paths = scan_images(args.input)
    frames = []
    h = w = None
    for p in paths:
        frame = cv2.imread(p)[:, :, ::-1]  # BGR -> RGB for imageio
        if h is None:
            h, w = frame.shape[:2]
        elif frame.shape[:2] != (h, w):
            frame = cv2.resize(frame, (w, h))
        frames.append(np.ascontiguousarray(frame))
    imageio.mimsave(args.out, frames, format="GIF",
                    duration=args.duration * 1000, loop=0)
    print(f"wrote {len(frames)} frames -> {args.out}")


def cmd_backproject(args):
    from esrganplus_tpu_torch.ops.back_projection import back_projection, reverse_filter

    refine = reverse_filter if getattr(args, "reverse_filter", False) else back_projection
    os.makedirs(args.out, exist_ok=True)
    for p in scan_images(args.sr):
        base = os.path.basename(p)
        lr_path = os.path.join(args.lr, base)
        if not os.path.exists(lr_path):
            stem = os.path.splitext(base)[0].removesuffix(args.suffix)
            lr_path = os.path.join(args.lr, stem + os.path.splitext(base)[1])
        sr = read_img(p)
        lr = read_img(lr_path)
        refined = refine(sr, lr, args.scale, args.iters, device=args.device).cpu().numpy()
        save_img((refined * 255).round().astype(np.uint8), os.path.join(args.out, base))
        print(base)


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("color2gray"); s.add_argument("input"); s.add_argument("out")
    s = sub.add_parser("rename"); s.add_argument("input"); s.add_argument("--pattern", default="{base}")
    s = sub.add_parser("patches"); s.add_argument("input"); s.add_argument("out")
    s.add_argument("--x", type=int, default=0); s.add_argument("--y", type=int, default=0)
    s.add_argument("--w", type=int, default=96); s.add_argument("--h", type=int, default=96)
    s.add_argument("--enlarge", type=int, default=3)
    s = sub.add_parser("video"); s.add_argument("input"); s.add_argument("out")
    s.add_argument("--fps", type=int, default=10)
    s = sub.add_parser("annotate"); s.add_argument("input"); s.add_argument("out")
    s.add_argument("--text", nargs="*", default=None,
                   help="one label per image (default: 1..N)")
    s.add_argument("--pos", type=int, nargs=2, default=[10, 50])
    s.add_argument("--font-size", type=float, default=1.5)
    s.add_argument("--thickness", type=int, default=4)
    s.add_argument("--color", choices=sorted(_COLOR_TB), default="red")
    s.add_argument("--crop-x", type=int, default=0); s.add_argument("--crop-y", type=int, default=0)
    s.add_argument("--crop-w", type=int, default=352); s.add_argument("--crop-h", type=int, default=576)
    s.add_argument("--enlarge", type=int, default=1)
    s = sub.add_parser("gif"); s.add_argument("input"); s.add_argument("out")
    s.add_argument("--duration", type=float, default=0.8,
                   help="seconds per frame (reference default)")
    s = sub.add_parser("backproject"); s.add_argument("sr"); s.add_argument("lr"); s.add_argument("out")
    s.add_argument("--scale", type=int, default=4); s.add_argument("--iters", type=int, default=20)
    s.add_argument("--suffix", default="_rlt")
    # main_reverse_filter.m's double-resize residual loop instead of Gaussian BP
    s.add_argument("--reverse-filter", dest="reverse_filter", action="store_true")
    s.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    {"color2gray": cmd_color2gray, "rename": cmd_rename, "patches": cmd_patches,
     "video": cmd_video, "annotate": cmd_annotate, "gif": cmd_gif,
     "backproject": cmd_backproject}[args.cmd](args)


if __name__ == "__main__":
    main()
