"""Each cell rehearsed on the CPU at the tiny size, through the harness to a
result of the contract's shape; the same runs with the timed path broken
underneath come out not correct; the fp8 control fails the limits."""

import json
import math

import pytest
import torch

from benchmark import compare, harness
from benchmark.tests import tiny

SEED = 2**31 + 99991  # past 32 signed bits, as the driver's seeds are
CELLS = sorted(tiny.CELLS)


def _run(tmp_path, cell, trace=False, fault=None, variants=()):
    man = tiny.tiny_tree(tmp_path, cell)
    return harness.run_cell(cell, SEED, 0.5, trace, "cpu", 0.0, man=man,
                            corpus_root=tmp_path / "corpus", fault=fault, variants=variants,
                            log=lambda msg: None)


def _shape_ok(res, metric_names):
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == set(metric_names)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_untraced(tmp_path, cell):
    res = _run(tmp_path, cell)
    _shape_ok(res, {"train_clips_per_s", "setup_s"})
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(tiny.limits(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_traced(tmp_path, cell):
    res = _run(tmp_path, cell, trace=True)
    # off the card only the host's readers find something to read
    _shape_ok(res, {"input_wait_ms.train", "producer_ms_per_batch.train",
                    "step_dispatch_ms.train"})
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_broken_step_is_not_correct(tmp_path, cell, fault):
    res = _run(tmp_path, cell, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_and_half_batch_fail_the_limits(tmp_path, cell):
    res = _run(tmp_path, cell, variants=("control", "half"))
    readings, limits = res["readings"], tiny.limits(cell)
    assert compare.verdict(readings["program"], limits)
    assert not compare.verdict(readings["control"], limits), readings["control"]
    assert not compare.verdict(readings["half"], limits), readings["half"]


def test_the_reference_input_function_equals_the_programs(tmp_path):
    """On the loader's own wire batches, the reference's input function gives
    the program's clips exactly (both in float32)."""
    from bdvcil_torch.cil.trainer import CILTrainer
    from bdvcil_torch.config import Config
    from bdvcil_torch.runtime.loops import split_batch, stage_batches
    from benchmark.reference import input_fn as ref_input

    cell = "r50_hmdb51_train_task0"
    man = tiny.tiny_tree(tmp_path, cell)
    entry = man.workload(cell)
    cfg = dict(man.config(entry["config"]), compute_dtype="float32")
    from bdvcil_torch.config_templates import DATASET_PRESETS, make_cil_config
    from benchmark import corpus

    preset = DATASET_PRESETS[cfg["dataset"]]
    splits = make_cil_config(cfg["dataset"], cfg["split_seed"], cfg["num_stages"],
                             cfg["variant"])["task_splits"]
    root = corpus.write_corpus(tmp_path / "corpus", man.traffic(entry["traffic"]), splits,
                               preset["train_ann"].format(split=1),
                               preset["val_ann"].format(split=1), threads=2)
    c = harness.trainer_config(cfg, man.config_family(entry["config"]), SEED, str(root),
                               str(tmp_path / "work"))
    c["videos_per_gpu"] = 26  # one batch: every clip of the corpus
    trainer = CILTrainer(Config(c), dump_config=False, device="cpu")
    loader, input_fn = trainer._try_fast_loader()
    seen_randaug = 0
    for epoch in range(3):
        loader.set_epoch(epoch)
        for batch in loader:
            imgs, labels, extra = split_batch(stage_batches([batch], False, False))
            got = input_fn(imgs)
            want = ref_input.input_fn({**imgs, "label": labels, **extra})
            assert torch.equal(got, want)
            seen_randaug += int(batch["apply_randaug"].sum())
    assert seen_randaug > 20


@pytest.mark.cuda
def test_rehearsal_on_the_card(tmp_path, cuda_device):
    man = tiny.tiny_tree(tmp_path, "r50_hmdb51_train_task0")
    res = harness.run_cell("r50_hmdb51_train_task0", SEED, 0.5, True, cuda_device, 0.0,
                           man=man, corpus_root=tmp_path / "corpus", log=lambda msg: None)
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert res["correct"], res["checks"]
