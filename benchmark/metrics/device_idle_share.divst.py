"""device_idle_share.divst: ``device_idle_share.train`` read on the TimeSformer
cell, whose entry lists the TSM cells alone: the percent of the traced slice
in which no kernel ran on the card. The reader is that metric's own, loaded
from its file. Layer: device (H100)."""

import pathlib

from benchmark import manifest

_SAME = manifest.load_module(pathlib.Path(__file__).with_name("device_idle_share.train.py"),
                             "_bench_metric_device_idle_share_train_for_divst")


def read(obs):
    return _SAME.read(obs)
