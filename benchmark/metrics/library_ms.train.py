"""Per-layer metric ``library_ms.train`` (ms), layer Library; moves ``train_crops_per_s``."""

from core import trace

LAYER = "Library"
UNIT = "ms"
MOVES = "train_crops_per_s"


def read(s):
    """Device ms a step in kernels that are not the program's own (its
    ``csrc/`` kernel names, read at run time)."""
    if not s.complete:
        return None
    own = s.context["port_kernels"]
    ms = sum(v for k, v in s.device_ms_by_family().items()
             if k not in own and trace.kind_of(k) == "kernel")
    return ms / len(s.work)
