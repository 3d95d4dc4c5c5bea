"""Per-layer metric ``mfu.infer`` (%), layer Model; moves ``sr_mpix_per_s``."""

from core import counting

LAYER = "Model"
UNIT = "%"
MOVES = "sr_mpix_per_s"


def read(s):
    """The traced images' forward FLOPs over their host-clock seconds, as a
    share of the peak of the dtype the forward computes in."""
    t = counting.image_tally(s, "total")
    return 100.0 * t.total_flops / s.wall_s / counting.PEAK_FLOPS[s.context["dtype"]]
