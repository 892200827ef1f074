"""step_dispatch_ms.divst: ``step_dispatch_ms.train`` read on the TimeSformer
cell, whose entry lists the TSM cells alone: milliseconds the launching
thread spent in a call of the train step, the mean over the window's steps.
The reader is that metric's own, loaded from its file. Layer: train step
(runtime/steps.py, models/, optim.py)."""

import pathlib

from benchmark import manifest

_SAME = manifest.load_module(pathlib.Path(__file__).with_name("step_dispatch_ms.train.py"),
                             "_bench_metric_step_dispatch_ms_train_for_divst")


def read(obs):
    return _SAME.read(obs)
