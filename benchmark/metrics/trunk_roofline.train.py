"""Per-layer metric ``trunk_roofline.train`` (%), layer Kernels; moves ``train_crops_per_s``."""

from core import counting

LAYER = "Kernels"
UNIT = "%"
MOVES = "train_crops_per_s"


def read(s):
    """The least time of the trunk's work (69 RDBs and the trunk conv,
    forward and adjoint) over the device time of the kernels that do it."""
    if not s.own_complete:  # its time is of the program's own kernels alone
        return None
    ms = sum(v for k, v in s.device_ms_by_family().items() if k in counting.TRUNK_KERNELS)
    return counting.roofline(counting.train_tally(s, "trunk"), ms, s.context["dtype"])
