"""Per-layer metric ``step_kernels.train`` (kernels), layer Device; moves ``train_crops_per_s``."""

from core import spans

LAYER = "Device"
UNIT = "kernels"
MOVES = "train_crops_per_s"


def read(s):
    """Kernels a replayed step launches: each replay's captured graph's
    kernel nodes (the program's record of them), averaged over the slice's
    replays."""
    ids = spans.replays(s)
    lists = spans.phase_lists()
    if not s.complete or not ids or lists is None or any(i not in lists for i in ids):
        return None
    return sum(len(lists[i]) for i in ids) / len(ids)
