"""step_input_fn_ms.divst: ``step_input_fn_ms.train`` read on the TimeSformer
cell, whose entry lists the TSM cells alone: milliseconds a step of the
traced slice spent in the span ``step.input_fn``. The reader is that
metric's own, loaded from its file. Layer: device input function
(data/device_pipeline.py, ops/augment.py, ops/rand_augment_dev.py)."""

import pathlib

from benchmark import manifest

_SAME = manifest.load_module(pathlib.Path(__file__).with_name("step_input_fn_ms.train.py"),
                             "_bench_metric_step_input_fn_ms_train_for_divst")


def read(obs):
    return _SAME.read(obs)
