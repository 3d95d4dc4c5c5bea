"""Learning-rate schedules.

The reference uses torch ``MultiStepLR`` (``codes/models/SR_model.py:50-55``):
lr multiplied by ``gamma`` at each milestone step. Counterpart of
``esrganplus_tpu/train/schedule.py``: a function of the 1-based global step.
"""

from __future__ import annotations

from typing import Sequence


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float = 0.5):
    """lr(step) = base_lr * gamma^(number of milestones passed)."""
    ms = sorted(int(m) for m in milestones)

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(int(step) >= m for m in ms)

    return schedule
