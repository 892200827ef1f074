"""dispatch_offcpu_share.divst: ``dispatch_offcpu_share.train`` read on the
TimeSformer cell, whose entry lists the TSM cells alone: the percent of the
launching thread's wall time in its step spans in which it was not on a CPU.
The reader is that metric's own, loaded from its file. Layer: launching
thread (runtime/steps.py)."""

import pathlib

from benchmark import manifest

_SAME = manifest.load_module(pathlib.Path(__file__).with_name("dispatch_offcpu_share.train.py"),
                             "_bench_metric_dispatch_offcpu_share_train_for_divst")


def read(obs):
    return _SAME.read(obs)
