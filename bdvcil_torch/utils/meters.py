"""Running meters (the port of ``bdvcil_tpu/utils/meters.py``): the
weighted running average of the accuracy tables, and the throughput meter of
the train loop, which also adds up the seconds the loop waited for its
input."""

from __future__ import annotations

import time


class AverageMeter:
    """Per-update values and sizes, and their running weighted average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.values = []
        self.sizes = []
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.values.append(val)
        self.sizes.append(n)
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class Throughput:
    """Items per second, the first ``warmup`` ticks excluded (they hold the
    first launches and the input's first fill).

    Call ``tick(n_items)`` once per dispatch. ``add_wait(seconds)`` adds
    time the consumer spent waiting for input to ``wait_s``."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.reset()

    def reset(self):
        self._steps = 0
        self._items = 0
        self._t0 = None
        self.wait_s = 0.0

    def tick(self, n_items: int):
        self._steps += 1
        if self._steps == self.warmup:
            self._t0 = time.perf_counter()
            self._items = 0
        elif self._steps > self.warmup:
            self._items += n_items

    def add_wait(self, seconds: float):
        self.wait_s += seconds

    @property
    def rate(self) -> float:
        if self._t0 is None or self._items == 0:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._items / dt if dt > 0 else 0.0
