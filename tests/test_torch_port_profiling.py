"""``bdvcil_torch/utils/profiling.py``, the port of ``bdvcil_tpu/utils/profiling.py``:
``trace`` writes a chrome trace of its region with ``torch.profiler``;
``annotate`` is the program's span: a shared no-op without a profiler
session on the thread, else a profiler region that records a
``Span`` (name, times, thread, CPU seconds, parent, run, step) in a bounded
book. The JAX module's ``trace`` and ``annotate`` are kept.
"""

import inspect
import json
import threading

import torch
from torch.profiler import ProfilerActivity, profile

from bdvcil_tpu.utils import profiling as jax_profiling
from bdvcil_torch.utils import profiling


def test_the_jax_modules_names_are_kept():
    for name in ("trace", "annotate"):
        assert callable(getattr(profiling, name)) and callable(getattr(jax_profiling, name))
    assert list(inspect.signature(profiling.trace).parameters)[0] == "log_dir"


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    x = torch.randn(64, 64)
    profiling.new_run()
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("herding_region"):
            (x @ x).sum()
    assert any(e.key == "herding_region" for e in prof.key_averages())
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "herding_region" for e in events)
    assert [s.name for s in profiling.spans()] == ["herding_region"]


def test_annotate_without_a_profiler_is_one_shared_no_op_that_records_nothing():
    assert not torch.autograd._profiler_enabled()
    book = profiling.BOOK
    n, dropped = len(book.records), book.dropped
    off = profiling.annotate("a")
    assert off is profiling.annotate("b")
    with off, profiling.annotate("c"):
        torch.ones(4).sum()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.annotate("eval", on=False) is off
    assert (len(book.records), book.dropped) == (n, dropped)


def test_spans_under_a_profiler_carry_name_parent_thread_cpu_run_and_step():
    x = torch.randn(128, 128)
    run = profiling.new_run()
    profiling.set_step(7)
    seen = []

    def elsewhere():  # no profiler session on this thread: no record
        with profiling.annotate("worker"):
            seen.append(torch.autograd._profiler_enabled())

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                for _ in range(20):
                    x = torch.tanh(x @ x)
            th = threading.Thread(target=elsewhere)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive() and seen == [False]
    inner, outer = profiling.spans(run)
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent == outer.id and outer.parent is None
    assert inner.thread == outer.thread == threading.get_ident()
    assert (inner.run, inner.step) == (outer.run, outer.step) == (run, 7)
    assert outer.start <= inner.start < inner.end <= outer.end
    assert inner.cpu_s is None and 0.0 <= outer.cpu_s  # the thread clock: outermost spans
    assert profiling.spans() == [inner, outer]


def test_the_cap_counts_dropped_records(monkeypatch):
    monkeypatch.setattr(profiling, "BOOK", profiling.SpanBook(cap=2))
    run = profiling.new_run()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.annotate(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans(run)] == ["s0", "s1"]
    assert profiling.BOOK.dropped == 3
