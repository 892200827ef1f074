"""producer_ms_per_batch.divst: ``producer_ms_per_batch.train`` read on the
TimeSformer cell, whose entry lists the TSM cells alone: milliseconds of the
loader's producer work a batch made in the window (traced runs only). The
reader is that metric's own, loaded from its file. Layer: loader host half
(data/loaders.py, data/native.py)."""

import pathlib

from benchmark import manifest

_SAME = manifest.load_module(pathlib.Path(__file__).with_name("producer_ms_per_batch.train.py"),
                             "_bench_metric_producer_ms_per_batch_train_for_divst")


def read(obs):
    return _SAME.read(obs)
