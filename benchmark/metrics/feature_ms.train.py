"""Per-layer metric ``feature_ms.train`` (ms), layer Model; moves ``train_crops_per_s``."""

from core import spans

LAYER = "Model"
UNIT = "ms"
MOVES = "train_crops_per_s"


def read(s):
    """Device ms a step in the feature network F (VGG19) of the replayed
    steps: its forwards (``f.fwd``) and its backward (``f.bwd``)."""
    return spans.phase_ms(s, ("f.fwd", "f.bwd"))
