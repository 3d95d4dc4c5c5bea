"""Per-layer metric ``stage_roofline.train`` (%), layer Kernels; moves ``train_crops_per_s``."""

from core import counting

LAYER = "Kernels"
UNIT = "%"
MOVES = "train_crops_per_s"


def read(s):
    """The least time of the work the stage kernels compute (D's and F's
    ≤128-channel convolutions; in bf16 also the tail's hr_conv0) over their
    device time."""
    if not s.own_complete:  # its time is of the program's own kernels alone
        return None
    ms = sum(v for k, v in s.device_ms_by_family().items()
             if k.startswith(counting.STAGE_PREFIX))
    return counting.roofline(counting.train_tally(s, "stage"), ms, s.context["dtype"])
