"""Profiling hooks (port of ``bdvcil_tpu/utils/profiling.py``): a
``torch.profiler`` trace in place of ``jax.profiler``'s, a step timer, and
named regions.

Usage:
    with trace("work_dirs/trace"):       # chrome trace: chrome://tracing, Perfetto
        run_steps()

    with step_timer() as t:
        ...
    print(t.elapsed)

    with annotate("herding"):
        ...
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """A ``torch.profiler`` trace of the region, host and (when a card is
    present) device activity, written to ``log_dir/trace.json`` as a chrome
    trace when the region ends. Yields the profiler (``key_averages()``)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, record_shapes=False)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _Timer:
    def __init__(self):
        self.elapsed = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


def step_timer() -> _Timer:
    return _Timer()


def annotate(name: str):
    """A named region in the trace (``torch.profiler.record_function``)."""
    return record_function(name)
