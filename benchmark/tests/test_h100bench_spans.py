"""The readers of the program's spans (``benchmark/metrics/step_*_ms.train``,
``bn_forward_ms.train``, ``dispatch_offcpu_share.train``): their arithmetic
on a span table made here, None off the card, and, on a traced rehearsal of
each tiny cell on the CPU, the program's records are the traced slice's."""

import math

import pytest

from benchmark import harness, manifest
from benchmark.tests import tiny
from bdvcil_torch.utils import profiling

SEED = 2**31 + 77003
MS = ("step_input_fn_ms.train", "step_forward_ms.train", "bn_forward_ms.train",
      "step_backward_ms.train", "step_optimizer_ms.train")
METRICS = MS + ("dispatch_offcpu_share.train",)


def _span(name, start, wall, cpu, step, parent=None, id_=0):
    return profiling.Span(name, start, start + wall, 1, cpu, id_, parent, 1, step)


# two steps, the second an update: seconds of wall and of CPU (None in a nested span)
TABLE = [
    _span("loop.fetch", 0.000, 0.002, 0.0005, None),
    _span("step.input_fn", 0.010, 0.003, 0.003, 0),
    _span("model.bn", 0.014, 0.001, None, 0),
    _span("model.bn", 0.016, 0.002, None, 0),
    _span("step.forward", 0.013, 0.020, 0.015, 0),
    _span("step.backward", 0.040, 0.030, 0.001, 0),
    _span("step.input_fn", 0.100, 0.005, 0.004, 1),
    _span("model.bn", 0.106, 0.003, None, 1),
    _span("step.forward", 0.105, 0.024, 0.020, 1),
    _span("step.backward", 0.130, 0.034, 0.002, 1),
    _span("step.optimizer", 0.170, 0.008, 0.007, 1),
]
# ms a step over the 2 steps, and 1 - CPU / wall over input_fn, forward, optimizer
WANT = {"step_input_fn_ms.train": 4.0, "step_forward_ms.train": 22.0,
        "bn_forward_ms.train": 3.0, "step_backward_ms.train": 32.0,
        "step_optimizer_ms.train": 4.0,
        "dispatch_offcpu_share.train": (1 - 0.049 / 0.060) * 100.0}


def _obs(device="cuda", steps=2):
    return dict(device=device, slice=dict(steps=steps, seconds=0.2, kernels=[], busy_s=0.1))


@pytest.fixture
def table(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda run=None: list(TABLE))


@pytest.mark.parametrize("metric", METRICS)
def test_each_reader_on_a_span_table(table, metric):
    got = manifest.Manifest().reader(metric)(_obs())
    assert math.isclose(got, WANT[metric], rel_tol=1e-9), (metric, got)


@pytest.mark.parametrize("metric", METRICS)
def test_each_reader_reads_nothing_off_the_card_or_without_spans(table, monkeypatch, metric):
    read = manifest.Manifest().reader(metric)
    assert read(_obs(device="cpu")) is None
    assert read(_obs(steps=0)) is None
    assert read(dict(device="cuda", slice=None)) is None
    monkeypatch.setattr(profiling, "spans", lambda run=None: [])
    assert read(_obs()) is None


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_traced_rehearsal_leaves_the_slices_spans(tmp_path, monkeypatch, cell):
    seen = {}
    trace_numbers = harness._trace_numbers

    def capture(driver):
        out = trace_numbers(driver)
        seen.update(driver.slice, steps=out["steps"])
        return out

    monkeypatch.setattr(harness, "_trace_numbers", capture)
    man = tiny.tiny_tree(tmp_path, cell)
    res = harness.run_cell(cell, SEED, 0.5, True, "cpu", 0.0, man=man,
                           corpus_root=tmp_path / "corpus", log=lambda msg: None)
    assert res["correct"], res["checks"]
    assert not set(METRICS) & set(res["metrics"])  # off the card
    records = profiling.spans()
    assert records and all(seen["t0"] <= r.start <= r.end <= seen["t1"] for r in records)
    steps = sorted({r.step for r in records})
    assert len(steps) == seen["steps"] == 2
    for step in steps:
        names = [r.name for r in records if r.step == step]
        assert [names.count(n) for n in ("step.input_fn", "step.forward", "step.backward")] \
            == [1, 1, 1], (step, names)
        assert "model.bn" in names and "model.block" in names
