"""Per-stage host-clock timing (TicToc + means).

Stage times are host wall-clock; on the card a stage that ends in a
device-to-host copy includes the device work it waited for.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def mean_ms(self, name: str) -> float:
        n = self.counts.get(name, 0)
        return 1000.0 * self.totals[name] / n if n else 0.0

    def summary(self) -> Dict[str, float]:
        return {k: round(self.mean_ms(k), 2) for k in self.totals}
