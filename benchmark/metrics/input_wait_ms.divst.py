"""input_wait_ms.divst: ``input_wait_ms.train`` read on the TimeSformer cell,
whose entry lists the TSM cells alone: milliseconds a train step of the
window waited for its batch in the prefetch queue. The reader is that
metric's own, loaded from its file. Layer: train loop (runtime/loops.py)."""

import pathlib

from benchmark import manifest

_SAME = manifest.load_module(pathlib.Path(__file__).with_name("input_wait_ms.train.py"),
                             "_bench_metric_input_wait_ms_train_for_divst")


def read(obs):
    return _SAME.read(obs)
