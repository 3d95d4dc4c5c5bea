"""Terminal progress bar for the offline dataset tools (reference
``codes/utils/progress_bar.py`` role: task counter, rate, elapsed).
A copy of ``esrganplus_tpu/utils/progress_bar.py``."""

from __future__ import annotations

import shutil
import sys
import time


class ProgressBar:
    def __init__(self, task_num: int = 0, bar_width: int = 50):
        self.task_num = task_num
        max_w = self._terminal_width() - 35
        self.bar_width = min(bar_width, max_w) if max_w > 10 else bar_width
        self.completed = 0
        self.start_time = time.time()
        if task_num > 0:
            sys.stdout.write(f"[{' ' * self.bar_width}] 0/{task_num}, elapsed: 0s, ETA:")
        else:
            sys.stdout.write("completed: 0, elapsed: 0s")
        sys.stdout.flush()

    @staticmethod
    def _terminal_width() -> int:
        return shutil.get_terminal_size().columns

    def update(self, msg: str = "") -> None:
        self.completed += 1
        elapsed = max(time.time() - self.start_time, 1e-9)
        fps = self.completed / elapsed
        if self.task_num > 0:
            pct = self.completed / self.task_num
            eta = int(elapsed * (1 - pct) / max(pct, 1e-9) + 0.5)
            mark = int(self.bar_width * pct)
            bar = ">" * mark + " " * (self.bar_width - mark)
            sys.stdout.write(
                f"\033[2K\r[{bar}] {self.completed}/{self.task_num}, "
                f"{fps:.1f} task/s, elapsed: {int(elapsed)}s, ETA: {eta:5d}s {msg}\n"
                if self.completed == self.task_num else
                f"\033[2K\r[{bar}] {self.completed}/{self.task_num}, "
                f"{fps:.1f} task/s, elapsed: {int(elapsed)}s, ETA: {eta:5d}s {msg}")
        else:
            sys.stdout.write(
                f"\033[2K\rcompleted: {self.completed}, elapsed: {int(elapsed)}s, "
                f"{fps:.1f} tasks/s")
        sys.stdout.flush()
