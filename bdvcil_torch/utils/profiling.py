"""Profiling hooks (port of ``bdvcil_tpu/utils/profiling.py``): a
``torch.profiler`` trace in place of ``jax.profiler``'s, and the program's
spans.

Usage:
    with trace("work_dirs/trace"):       # chrome trace: chrome://tracing, Perfetto
        run_steps()

    with annotate("herding"):
        ...

    spans()                              # the last run's records

A span costs one check when no ``torch.profiler`` session is recording on
the calling thread (``torch.autograd._profiler_enabled()``), and records
nothing. Under one it is a host region of the trace, beside the kernels and
on their clock (``torch._C._profiler._RecordFunctionFast``: the region
``record_function`` opens, without the user annotation that the profiler
mirrors on the device's timeline and ties to every kernel launched inside
it, which cost a traced TSM-R50 step on an H100 about three times as much),
and on exit it appends a ``Span`` to ``BOOK``: its name, its host-clock
start and end (``time.perf_counter``), its thread, the thread's CPU seconds
inside it (``time.thread_time``, only for a span that no other span on the
thread encloses: the thread clock is a system call, and on some hosts it
advances in 10 ms ticks, too coarse for the nested spans anyway), the
enclosing open span on the same thread, and the run and step it belongs to.
``runtime/loops.train_epochs`` starts a run (``new_run``) and names each
train step before calling it (``set_step``): the spans of one step share
(run, step), and the loop's own spans after a step carry that step's id.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Iterator, List, NamedTuple, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile

CAP = 1 << 16  # records kept; later ones are counted in ``SpanBook.dropped``


class Span(NamedTuple):
    name: str
    start: float  # time.perf_counter() seconds
    end: float
    thread: int  # threading.get_ident()
    cpu_s: Optional[float]  # the thread's CPU seconds in it; None inside another span
    id: int
    parent: Optional[int]  # the id of the enclosing open span on the thread
    run: int
    step: Optional[int]  # None before the run's first step


class SpanBook:
    """The records of closed spans, at most ``cap``, and the current run and step."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.records: List[Span] = []
        self.dropped = 0
        self.run = 0
        self.step: Optional[int] = None
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self.records) < self.cap:
                self.records.append(span)
            else:
                self.dropped += 1


BOOK = SpanBook()
_IDS = itertools.count()
_LOCAL = threading.local()  # .open: the ids of this thread's open spans


def new_run() -> int:
    """Start a run: later spans carry its id and no step until ``set_step``."""
    BOOK.run += 1
    BOOK.step = None
    return BOOK.run


def set_step(step: int) -> None:
    BOOK.step = step


def spans(run: Optional[int] = None) -> List[Span]:
    """The records of ``run`` (else of the last run) in the order they closed."""
    run = BOOK.run if run is None else run
    return [s for s in BOOK.records if s.run == run]


class _Open:
    """One recording span: a profiler region and, on exit, a ``Span``."""

    __slots__ = ("name", "region", "id", "parent", "t0", "c0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.region = _RecordFunctionFast(self.name)
        self.region.__enter__()
        stack = getattr(_LOCAL, "open", None)
        if stack is None:
            stack = _LOCAL.open = []
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self.id)
        self.t0 = time.perf_counter()
        self.c0 = time.thread_time() if self.parent is None else None
        return self

    def __exit__(self, *exc):
        cpu_s = None if self.c0 is None else time.thread_time() - self.c0
        t1 = time.perf_counter()
        _LOCAL.open.pop()
        BOOK.add(Span(self.name, self.t0, t1, threading.get_ident(), cpu_s, self.id,
                      self.parent, BOOK.run, BOOK.step))
        self.region.__exit__(*exc)  # last: the bookkeeping stays inside the region
        return False


_OFF = contextlib.nullcontext()


def annotate(name: str, on: bool = True):
    """The program's span named ``name`` (where ``on``): recorded only while a
    ``torch.profiler`` session records on this thread, else a shared no-op."""
    if on and torch.autograd._profiler_enabled():
        return _Open(name)
    return _OFF


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
