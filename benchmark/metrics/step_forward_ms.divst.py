"""step_forward_ms.divst: ``step_forward_ms.train`` read on the TimeSformer
cell, whose entry lists the TSM cells alone: milliseconds a step of the
traced slice spent in the span ``step.forward`` (the TimeSformer's
``model.*`` spans included). The reader is that metric's own, loaded from
its file. Layer: forward (models/)."""

import pathlib

from benchmark import manifest

_SAME = manifest.load_module(pathlib.Path(__file__).with_name("step_forward_ms.train.py"),
                             "_bench_metric_step_forward_ms_train_for_divst")


def read(obs):
    return _SAME.read(obs)
