"""Per-layer metric ``device_idle.infer`` (%), layer Device; moves ``sr_mpix_per_s``."""

LAYER = "Device"
UNIT = "%"
MOVES = "sr_mpix_per_s"


def read(s):
    """The card's idle share of the traced images: one minus the union of its
    kernel, copy and memset intervals over the slice's span."""
    if not s.complete:
        return None
    return 100.0 * (1.0 - s.busy_us() / (s.hi - s.lo))
