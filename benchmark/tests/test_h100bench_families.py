"""Model families (``benchmark/families/<name>.py``): a configuration of a new
family, its cell and its check are new files and entries alone; the
committed family draws the same weights and reads the same check numbers as
the harness did before families; a family the tree does not hold, or a
configuration its family refuses, cannot start."""

import hashlib
import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, manifest
from benchmark.tests import tiny

ROOT = pathlib.Path(__file__).resolve().parents[2]
MAN = manifest.Manifest()
SEED = 2**31 + 99991  # the rehearsal's

# Recorded from the harness as it was before families, on the CPU (torch
# 2.13.0+cpu, x86-64; two runs bit for bit alike): sha256 of every weight's
# name, shape and float32 bytes in draw order at seed 0, with the classes of
# task 0 and the number of leaves; FLOPs of a train clip; and the tiny
# rehearsal's numbers at SEED, the program's and the reference's put in its
# place (fp8, half of each batch).
PARENT_WEIGHTS = {
    "r50_hmdb51_train_task0": (26, 161,
                               "25255e70bb1e5d97e1a50192509ee7406182870907540b5b7cb586e57848919c"),
    "r34_ucf101_train_task0": (51, 110,
                               "1fa52e8aec75bfc2b7809918385f8af1337e72ce3669df0ecc6657307c4e9ab8"),
}
PARENT_FLOPS = {"r50_hmdb51_train_task0": 196182540288.0,
                "r34_ucf101_train_task0": 175835971584.0}
PARENT_TINY = {
    "r50_hmdb51_train_task0": {
        "program": {"loss_gap": 0.0027264502965303485, "grad_gap": 0.30832171406754283,
                    "change_gap": 0.19632516928450125,
                    "grad_gap_conv_median": 0.09040799692840351,
                    "change_gap_conv_median": 0.07174769057122711,
                    "var_gap": 0.024944309145212173},
        "control": {"loss_gap": 0.004718549967336829, "grad_gap": 0.2337475184894239,
                    "change_gap": 0.2345962681340012,
                    "grad_gap_conv_median": 0.025142360955643348,
                    "change_gap_conv_median": 0.036889643511485444,
                    "var_gap": 0.16178612411022186},
        "half": {"loss_gap": 0.005633635809735206, "grad_gap": 11.397806040542623,
                 "change_gap": 8.204071376310663, "grad_gap_conv_median": 7.051039258977771,
                 "change_gap_conv_median": 6.545007156279992, "var_gap": 0.2528584897518158},
    },
    "r34_ucf101_train_task0": {
        "program": {"loss_gap": 0.0009803762488599906, "grad_gap": 0.22779586336105231,
                    "change_gap": 0.18516148233154223,
                    "grad_gap_conv_median": 0.015250194839209575,
                    "change_gap_conv_median": 0.013176980782378032,
                    "var_gap": 0.00644658925011754},
        "control": {"loss_gap": 0.0013803421299963922, "grad_gap": 0.5151901706145278,
                    "change_gap": 0.47997044607357897,
                    "grad_gap_conv_median": 0.10402325296523138,
                    "change_gap_conv_median": 0.09771051008557236,
                    "var_gap": 0.06081659533083439},
        "half": {"loss_gap": 0.004321066492613158, "grad_gap": 4.9278988825867165,
                 "change_gap": 4.355363996594148, "grad_gap_conv_median": 3.085594963646817,
                 "change_gap_conv_median": 2.9862286918235825, "var_gap": 0.18634698539972305},
    },
}

# a second family: TSM-ResNet again, held to the loss and a number of its own
MATRIX_FAMILY = '''"""TSM-ResNet, checked on its loss and the median gap of its matrices'
gradient norms (the conv kernels and the classifier's proxies)."""

from benchmark import compare
from benchmark.families.tsm_resnet import (  # noqa: F401
    check_config, conv_leaves, decay, first_forward_readings, make_weights, model_config,
    param_shapes, reference_config, reference_train_steps, reset_buffers, train_flops_per_clip)

NUMBERS = ("loss_gap", "grad_gap_matrix_median")


def numbers(program, reference):
    every = list(reference["grad_norms"])
    matrices = conv_leaves(every) + [k for k in every if k.endswith("fc_weights")]
    return {"loss_gap": compare.loss_gap(program["losses"], reference["losses"]),
            "grad_gap_matrix_median": compare.median_gap(program["grad_norms"],
                                                         reference["grad_norms"], matrices)}
'''


def _files(root: pathlib.Path):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_second_family_is_new_files_and_entries(tmp_path):
    cell, base = "r50_hmdb51_train_task0", "tsm_r50_hmdb51"
    man = tiny.tiny_tree(tmp_path, cell)
    before = _files(tmp_path)
    bench = man.dir
    (bench / "families" / "tsm_resnet_matrix.py").write_text(MATRIX_FAMILY)
    cfg = dict(man.config(base), family="tsm_resnet_matrix")
    (bench / "configs" / "tsm_r50_hmdb51_matrix.json").write_text(json.dumps(cfg))
    limits = {"loss_gap": 0.05, "grad_gap_matrix_median": 0.2}
    cellp = dict(man.cell(cell), limits=limits)
    (bench / "workloads" / "r50_matrix_hmdb51_train_task0.json").write_text(json.dumps(cellp))
    data = json.loads(json.dumps(man.data))
    data["configs"].append(dict(man.config_entry(base), name="tsm_r50_hmdb51_matrix",
                                file="benchmark/configs/tsm_r50_hmdb51_matrix.json"))
    data["workloads"].append(dict(man.workload(cell), name="r50_matrix_hmdb51_train_task0",
                                  config="tsm_r50_hmdb51_matrix"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    after = _files(tmp_path)
    old = json.loads(before.pop(pathlib.Path("BENCHMARK.json")))
    new = json.loads(after[pathlib.Path("BENCHMARK.json")])
    assert all(after[p] == b for p, b in before.items())  # no file edited
    for section in old:  # every entry kept, in its place
        if isinstance(old[section], list):
            assert new[section][:len(old[section])] == old[section], section
        else:
            assert new[section] == old[section], section

    man = manifest.Manifest(tmp_path, bench)
    assert man.config_family("tsm_r50_hmdb51_matrix").NUMBERS == tuple(limits)
    res = harness.run_cell("r50_matrix_hmdb51_train_task0", SEED, 0.5, False, "cpu", 0.0,
                           man=man, corpus_root=tmp_path / "corpus", log=lambda msg: None)
    assert res["correct"], res["checks"]
    assert list(res["checks"]) == list(limits)


@pytest.mark.parametrize("cell", sorted(PARENT_WEIGHTS))
def test_the_weights_and_flops_are_the_parents(cell):
    config = MAN.workload(cell)["config"]
    family, cfg = MAN.config_family(config), MAN.config(config)
    classes, leaves, digest = PARENT_WEIGHTS[cell]
    weights = family.make_weights(cfg, classes, 0, torch.device("cpu"))
    h = hashlib.sha256()
    for name, t in weights.items():
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().numpy().tobytes())
    assert (len(weights), h.hexdigest()) == (leaves, digest), torch.__version__
    assert family.train_flops_per_clip(cfg) == PARENT_FLOPS[cell]
    from bdvcil_torch.config_templates import make_cil_config

    splits = make_cil_config(cfg["dataset"], cfg["split_seed"], cfg["num_stages"],
                             cfg["variant"])["task_splits"]
    assert len(splits[0]) == classes


@pytest.mark.parametrize("cell", sorted(PARENT_TINY))
def test_the_tiny_check_reads_the_parents_numbers(tmp_path, cell):
    man = tiny.tiny_tree(tmp_path, cell)
    res = harness.run_cell(cell, SEED, 0.5, False, "cpu", 0.0, man=man,
                           corpus_root=tmp_path / "corpus", variants=("control", "half"),
                           readings=True, log=lambda msg: None)
    assert res["readings"] == PARENT_TINY[cell], (torch.__version__, res["readings"])


@pytest.mark.parametrize("change,named", [
    ({"family": "no_such_family"}, "no_such_family"),
    ({"family": "../reference/model"}, "../reference/model"),
    ({"depth": 19}, "depth 19"),
], ids=["unknown", "a_path", "depth_19"])
def test_a_configuration_no_family_runs_cannot_start(tmp_path, change, named):
    """run.py exits 2 with no result line: a family the tree does not hold,
    a family name that is a path, a configuration its family refuses. The
    program is there, so without the family's look the run would go on to
    look for a card."""
    shutil.copytree(MAN.dir, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".corpus", ".cache", "__pycache__"))
    (tmp_path / "bdvcil_torch").symlink_to(ROOT / "bdvcil_torch")
    cell = "r50_hmdb51_train_task0"
    config = MAN.workload(cell)["config"]
    (tmp_path / "benchmark" / "configs" / f"{config}.json").write_text(
        json.dumps(dict(MAN.config(config), **change)))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert (out.returncode, out.stdout) == (2, ""), out.stderr[-2000:]
    assert "cannot start" in out.stderr and named in out.stderr, out.stderr[-2000:]
