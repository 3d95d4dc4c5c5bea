"""Misc runtime utilities: loggers, experiment-dir archival, seeding.

Mirrors the reference's ``codes/utils/util.py:16-63``: timestamped dual
file+console loggers, ``mkdir_and_rename`` archiving a stale experiment dir
instead of clobbering it, and global seeding (torch generators are explicit in
this package, so seeding covers the host-side generators and torch's default
one). Counterpart of ``esrganplus_tpu/utils/misc.py``.
"""

from __future__ import annotations

import logging
import os
import random
import sys
import time

import numpy as np


def timestamp() -> str:
    return time.strftime("%y%m%d-%H%M%S")


def mkdir_and_rename(path: str) -> None:
    if os.path.exists(path):
        new_name = path + "_archived_" + timestamp()
        print(f"Path already exists. Renaming it to {new_name}")
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def set_random_seed(seed: int) -> None:
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def setup_logger(name: str, root: str, phase: str, level=logging.INFO,
                 screen: bool = False) -> logging.Logger:
    lg = logging.getLogger(name)
    for h in list(lg.handlers):  # fresh handlers per run (tests / repeated CLIs)
        lg.removeHandler(h)
        h.close()
    formatter = logging.Formatter("%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
                                  datefmt="%y-%m-%d %H:%M:%S")
    lg.setLevel(level)
    os.makedirs(root, exist_ok=True)
    fh = logging.FileHandler(os.path.join(root, f"{phase}_{timestamp()}.log"), mode="w")
    fh.setFormatter(formatter)
    lg.addHandler(fh)
    if screen:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(formatter)
        lg.addHandler(sh)
    return lg
