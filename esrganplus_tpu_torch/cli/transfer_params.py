"""Cross-depth / cross-scale checkpoint surgery.

    python -m esrganplus_tpu_torch.cli.transfer_params SRC.pth DST_TEMPLATE.pth OUT.pth [--sft]

Counterpart of ``esrganplus_tpu/cli/transfer_params.py`` (reference
``codes/scripts/transfer_params.py``: seed a new-scale SRResNet from a ×4
model by copying matching keys, and ``transfer_params_sft.py``: seed SFT-GAN
from SRGAN weights). Every key of the destination template keeps its
template value unless the source has a key with the same name AND shape,
which is copied over; a summary of copied / kept keys is printed so depth or
scale mismatches are visible. It edits checkpoint files on the host; no
device is touched.
"""

from __future__ import annotations

import argparse

import numpy as np


def transfer(src: dict, dst: dict):
    out = {}
    copied, kept = [], []
    for k, v in dst.items():
        s = src.get(k)
        if s is not None and tuple(np.shape(s)) == tuple(np.shape(v)):
            out[k] = np.asarray(s)
            copied.append(k)
        else:
            out[k] = np.asarray(v)
            kept.append(k)
    return out, copied, kept


# SRGAN (16-block SRResNet, pixel-shuffle ×4) keys → SFT_Net keys, the seed
# mapping of reference ``codes/scripts/transfer_params_sft.py:17-39``.
def srgan_to_sft_map(nb: int = 16):
    m = {"conv0": "model.0"}
    for i in range(nb):
        m[f"sft_branch.{i}.conv0"] = f"model.1.sub.{i}.res.0"
        m[f"sft_branch.{i}.conv1"] = f"model.1.sub.{i}.res.2"
    m[f"sft_branch.{nb + 1}"] = f"model.1.sub.{nb}"
    m["HR_branch.0"] = "model.2"
    m["HR_branch.3"] = "model.5"
    m["HR_branch.6"] = "model.8"
    m["HR_branch.8"] = "model.10"
    return m


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("src", help="source checkpoint (.pth) to transfer from")
    ap.add_argument("template", help="template checkpoint (.pth) defining the target layout")
    ap.add_argument("out", help="output .pth")
    ap.add_argument("--sft", action="store_true",
                    help="seed an SFT_Net template from SRGAN/SRResNet weights "
                         "(reference transfer_params_sft.py key mapping)")
    args = ap.parse_args(argv)

    import torch

    from esrganplus_tpu_torch.convert import load_state_dict

    numpy = lambda path: {k: v.numpy() for k, v in load_state_dict(path).items()}
    src, dst = numpy(args.src), numpy(args.template)
    if args.sft:
        renamed = {}
        for dst_prefix, src_prefix in srgan_to_sft_map().items():
            for suffix in (".weight", ".bias"):
                if src_prefix + suffix in src:
                    renamed[dst_prefix + suffix] = src[src_prefix + suffix]
        src = renamed
    out, copied, kept = transfer(src, dst)
    torch.save({k: torch.from_numpy(np.array(v, copy=True)) for k, v in out.items()}, args.out)
    print(f"copied {len(copied)} keys from source; kept {len(kept)} template keys")
    for k in kept[:20]:
        print(f"  kept (no match): {k}")
    if len(kept) > 20:
        print(f"  ... and {len(kept) - 20} more")


if __name__ == "__main__":
    main()
