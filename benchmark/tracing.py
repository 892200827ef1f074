"""The yardstick's reading of a ``torch.profiler`` trace: the device's busy
time as the union of its kernels' intervals (a frozen copy of
``bdvcil_torch/profile_step.py``'s ``_busy_us``), the device operations
that took most time, and the idle gaps named by what the host was doing.

Intervals are (start_us, end_us) pairs as the profiler reports them.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]


def busy_us(intervals: Sequence[Interval]) -> float:
    """Microseconds covered by at least one interval."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def idle_gaps(intervals: Sequence[Interval], start: float, stop: float) -> List[Interval]:
    """The gaps in [start, stop] that no interval covers."""
    gaps, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, stop)))
        cursor = max(cursor, e)
        if cursor >= stop:
            break
    if cursor < stop:
        gaps.append((cursor, stop))
    return [(s, e) for s, e in gaps if e > s]


def top_device_ops(kernels: Sequence[Tuple[str, float, float]], n: int = 10):
    """[[name, seconds], ...]: the ``n`` kernel names with most device time;
    ``kernels`` are (name, start_us, end_us)."""
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in kernels:
        by_name[name[:160]] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def named_gaps(gaps: Sequence[Interval], host_ops: Sequence[Tuple[str, float, float]],
               n: int = 10):
    """[[name, seconds], ...]: idle seconds summed by the innermost host
    operation (the latest to start) open at each gap's start; a gap with no
    host operation open is named 'outside any host op'."""
    ops = sorted(host_ops, key=lambda o: o[1])
    starts = [s for _, s, _ in ops]
    by_name: Dict[str, float] = defaultdict(float)
    for gs, ge in gaps:
        name = "outside any host op"
        # back from the last op to start by gs: the first one still open
        i = bisect.bisect_right(starts, gs) - 1
        floor = max(-1, i - 5000)  # a bounded look back
        while i > floor:
            if ops[i][2] >= gs:
                name = ops[i][0]
                break
            i -= 1
        by_name[name[:160]] += (ge - gs) / 1e6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]
