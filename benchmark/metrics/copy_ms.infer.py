"""Per-layer metric ``copy_ms.infer`` (ms), layer Front end; moves ``sr_mpix_per_s``."""

from core import trace

LAYER = "Front end"
UNIT = "ms"
MOVES = "sr_mpix_per_s"


def read(s):
    """Device ms an image of host-device copies."""
    if not s.complete:
        return None
    return sum(v for k, v in s.device_ms_by_family().items()
               if trace.kind_of(k) == "copy") / len(s.work)
