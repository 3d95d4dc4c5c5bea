"""Per-layer metric ``mfu.train`` (%), layer Model; moves ``train_crops_per_s``."""

from core import counting

LAYER = "Model"
UNIT = "%"
MOVES = "train_crops_per_s"


def read(s):
    """The traced steps' model FLOPs (``flops/<config>.py``) over their
    host-clock seconds, as a share of the peak of the dtype the step computes
    in."""
    t = counting.train_tally(s, "total")
    return 100.0 * t.total_flops / s.wall_s / counting.PEAK_FLOPS[s.context["dtype"]]
