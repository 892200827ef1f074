"""``bdvcil_torch/utils/profiling.py``, the port of ``bdvcil_tpu/utils/profiling.py``:
``trace`` writes a chrome trace of its region with ``torch.profiler``,
``annotate`` names a region in it (``record_function``), ``step_timer``
times a block on the host clock. The JAX module's three names are kept.
"""

import inspect
import json
import time

import torch

from bdvcil_tpu.utils import profiling as jax_profiling
from bdvcil_torch.utils import profiling


def test_the_jax_modules_names_are_kept():
    for name in ("trace", "step_timer", "annotate"):
        assert callable(getattr(profiling, name)) and callable(getattr(jax_profiling, name))
    assert list(inspect.signature(profiling.trace).parameters)[0] == "log_dir"


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("herding_region"):
            (x @ x).sum()
    assert any(e.key == "herding_region" for e in prof.key_averages())
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "herding_region" for e in events)


def test_step_timer_times_its_block():
    with profiling.step_timer() as t:
        time.sleep(0.01)
    assert 0.01 <= t.elapsed < 5.0
