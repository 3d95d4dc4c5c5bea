"""Per-layer metric ``trunk_roofline.infer`` (%), layer Kernels; moves ``sr_mpix_per_s``."""

from core import counting

LAYER = "Kernels"
UNIT = "%"
MOVES = "sr_mpix_per_s"


def read(s):
    """The least time of the trunk's forward over the device time of the
    kernels that do it."""
    if not s.complete:
        return None
    ms = sum(v for k, v in s.device_ms_by_family().items() if k in counting.TRUNK_KERNELS)
    return counting.roofline(counting.image_tally(s, "trunk"), ms, s.context["dtype"])
