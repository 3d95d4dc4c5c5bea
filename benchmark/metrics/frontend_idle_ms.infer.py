"""Per-layer metric ``frontend_idle_ms.infer`` (ms), layer Front end; moves ``sr_mpix_per_s``."""

from core import spans

LAYER = "Front end"
UNIT = "ms"
MOVES = "sr_mpix_per_s"
FRONT = ("sr.prepare", "sr.copy_in", "sr.copy_out")


def read(s):
    """Device-idle ms an image while the innermost open span of the front
    end (``sr.*``) is one of its host parts: the batch's preparation, the
    copy in, or the copy out with its clamp."""
    if not s.complete:
        return None
    idle = spans.idle_by_span(s, "sr.")
    if idle is None:
        return None
    return sum(idle[k] for k in FRONT) / 1e3 / len(s.work)
