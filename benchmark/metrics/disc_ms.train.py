"""Per-layer metric ``disc_ms.train`` (ms), layer Model; moves ``train_crops_per_s``."""

from core import spans

LAYER = "Model"
UNIT = "ms"
MOVES = "train_crops_per_s"


def read(s):
    """Device ms a step in the discriminator D of the replayed steps: its
    forwards and backwards (``d.fwd``, ``d.bwd``), in G's loss and in D's
    own update."""
    return spans.phase_ms(s, ("d.fwd", "d.bwd"))
