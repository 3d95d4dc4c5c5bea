"""Per-layer metric ``optimizer_ms.train`` (ms), layer Trainers; moves ``train_crops_per_s``."""

from core import spans

LAYER = "Trainers"
UNIT = "ms"
MOVES = "train_crops_per_s"


def read(s):
    """Device ms a step in the optimizer phases of the replayed steps
    (``g.opt`` and ``d.opt``: the gradients' reduction and Adam, leaf by
    leaf)."""
    return spans.phase_ms(s, ("g.opt", "d.opt"))
