"""BENCHMARK.json against the benchmark's contract, and the files each name
in it leads to."""

import json
import re
import shutil

import pytest

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = manifest.Manifest()
DATA = MAN.data


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(DATA["paths"]) <= 16 and all(PATH.match(p) for p in DATA["paths"])
    assert isinstance(DATA["run_seconds"], int) and 1 <= DATA["run_seconds"] <= 51
    assert len(json.dumps(DATA)) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entry_keys_and_names(section, keys):
    names = [e["name"] for e in DATA[section]]
    assert len(names) == len(set(names))
    for e in DATA[section]:
        assert set(e) == keys, e
        assert NAME.match(e["name"]) and _line(e["why"])
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] in (1, 4)
        else:
            assert _line(e["source"]) and e["source"].startswith("https://")
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metric_names_and_units(section):
    cells = {w["name"] for w in DATA["workloads"]}
    for m in DATA[section]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if section == "end_to_end":
            assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
            assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        else:
            assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                              "moves"}
            assert m["source"] in ("host_clock", "device_trace", "program_span",
                                   "program_counter")
            assert _line(m["layer"]) and m["moves"] in {e["name"] for e in DATA["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in DATA["end_to_end"] + DATA["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names


@pytest.mark.parametrize("cell", [w["name"] for w in DATA["workloads"]])
def test_every_file_is_found_by_name(cell):
    entry = MAN.workload(cell)
    family = MAN.config_family(entry["config"])  # the family has checked the configuration
    assert MAN.traffic(entry["traffic"])["frames"] > 0
    limits = MAN.cell(cell)["limits"]
    assert limits and set(limits) <= set(family.NUMBERS) and all(v > 0 for v in limits.values())
    for m in MAN.per_layer(cell):
        assert callable(MAN.reader(m["name"]))
    assert {"setup_s", "train_clips_per_s"} <= {m["name"] for m in MAN.end_to_end(cell)}
    assert MAN.per_layer(cell)


def test_a_new_cell_config_and_metric_are_files_alone(tmp_path):
    """A copy of the tree with one more configuration, traffic mix, cell and
    metric, added as files and entries: the manifest finds each by name."""
    bench = tmp_path / "benchmark"
    shutil.copytree(MAN.dir, bench, ignore=shutil.ignore_patterns(".corpus", ".cache",
                                                                 "__pycache__"))
    data = json.loads(json.dumps(DATA))
    cfg = MAN.config("tsm_r50_hmdb51")
    (bench / "configs" / "tsm_r101_hmdb51.json").write_text(json.dumps(dict(cfg, depth=101)))
    (bench / "traffic" / "hmdb51_task0_warm.json").write_text(
        json.dumps(dict(MAN.traffic("hmdb51_task0_cold"), train_videos_per_class=4)))
    (bench / "workloads" / "r101_hmdb51_train_task0.json").write_text(
        json.dumps(MAN.cell("r50_hmdb51_train_task0")))
    (bench / "metrics" / "steps_in_window.py").write_text(
        "def read(obs):\n    return float(obs['window']['steps'])\n")
    data["configs"].append(dict(name="tsm_r101_hmdb51", source="https://arxiv.org/abs/1811.08383",
                                file="benchmark/configs/tsm_r101_hmdb51.json", reduced=[],
                                why="deeper"))
    data["workloads"].append(dict(name="r101_hmdb51_train_task0", config="tsm_r101_hmdb51",
                                  traffic="hmdb51_task0_warm", chips=1, why="deeper"))
    data["per_layer"].append(dict(name="steps_in_window", unit="steps", better="higher",
                                  source="host_clock", layer="train loop (runtime/loops.py)",
                                  moves="train_clips_per_s",
                                  workloads=["r101_hmdb51_train_task0"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    man = manifest.Manifest(tmp_path, bench)
    assert man.config(man.workload("r101_hmdb51_train_task0")["config"])["depth"] == 101
    assert man.config_family("tsm_r101_hmdb51").NUMBERS == MAN.family("tsm_resnet").NUMBERS
    assert man.traffic("hmdb51_task0_warm")["train_videos_per_class"] == 4
    assert [m["name"] for m in man.per_layer("r101_hmdb51_train_task0")] == ["steps_in_window"]
    assert man.reader("steps_in_window")({"window": {"steps": 7}}) == 7.0
    # the committed cells still see only their own metrics
    assert "steps_in_window" not in {m["name"] for m in man.per_layer("r50_hmdb51_train_task0")}


def test_paths_hold_the_benchmark_alone():
    assert DATA["paths"] == ["benchmark"]
    for c in DATA["configs"]:
        assert c["file"].startswith("benchmark/configs/")
    files = [c["file"] for c in DATA["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("config", [c["name"] for c in DATA["configs"]])
def test_a_committed_configuration_runs_its_preset_unchanged(config):
    """The sizes a configuration file sets on ``make_cil_config``'s config are
    the preset's own: the cells cut nothing (``reduced`` is empty). The
    preset's model is a TSM-ResNet, so its model is compared for that
    family's configurations; another family's model is its family's own."""
    from bdvcil_torch.config_templates import make_cil_config

    from benchmark import harness

    cfg = MAN.config(config)
    preset = make_cil_config(cfg["dataset"], cfg["split_seed"], cfg["num_stages"],
                             cfg["variant"], data_dir="d", work_dir="w")
    run = harness.trainer_config(cfg, MAN.config_family(config), 7, "d", "w")
    for key in ("videos_per_gpu", "accumulate_grad_batches", "workers_per_gpu", "data",
                "optimizer", "cbf_optimizer", "task_splits", "methods", "randAug_prob"):
        assert run[key] == preset[key], key
    assert run["model"]["backbone"]["pretrained"] is None
    if manifest.family_name(cfg) != "tsm_resnet":
        return
    # every backbone key but the port's switches, and every head key (depth
    # and in_channels among them), is the preset's
    switches = {"shift_mode", "conv1x1_mode", "pretrained"}
    backbone = {k: v for k, v in run["model"]["backbone"].items() if k not in switches}
    assert backbone == {k: v for k, v in preset["model"]["backbone"].items() if k not in switches}
    assert run["model"]["cls_head"] == preset["model"]["cls_head"]
    assert (cfg["depth"], cfg["in_channels"]) == (preset["model"]["backbone"]["depth"],
                                                  preset["model"]["cls_head"]["in_channels"])
