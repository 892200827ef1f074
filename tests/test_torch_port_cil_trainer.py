"""The port's CIL trainer held against the JAX package's ``CILTrainer``, by
teacher forcing.

One JAX run (module fixture) trains 3 tasks of a tiny rawframe tree: R18,
4 segments, 56² crops, f32, 1 epoch a task, CBF on, budget 2, dropout 0, on
one CPU device. The port's trainer runs on the same config and tree (its own
work_dir). For each task t both trainers are given the JAX checkpoint of t
(through ``models/convert.py``) and compared on:

  * the predictions on the merged val set of tasks 0..t: same order and
    labels, cls_score and repr within rtol 1e-4, atol 1e-4;
  * the herding selection of task t: the same videos, and the exemplar
    files byte for byte;
  * the NME class means over the exemplars of tasks 0..t: rtol 1e-4, atol 1e-5;
  * the CNN and NME accuracy rows: equal (the CNN row also equals the JAX
    run's own row for t);
  * the train steps of task t+1 (3 steps, KD and the clip on), from the same
    grown weights and the same replay data: every logged loss within rtol
    1e-4, every parameter after the epoch within rtol 2e-3, atol 2e-4 (see
    PARAM_TOL), every parameter's update (after - before) within UPDATE_TOL
    of JAX's in norm, and the classifier's update within 1% of its largest
    entry.

Why the f32 updates are held in norm, and how loosely: the float64 witness.
From task 1's grown weights, its first epoch (3 replay batches) runs four
times: JAX in f32, JAX with x64 (an f64 model), the port in f32 and the port
in f64. JAX's and the port's f64 updates agree within 1e-6 of each leaf's
norm, so the two compute the same steps, KD gradient included; in f32 JAX's
update drifts further from them than the port's does.

The JAX trainer's random draws (its chained key) and the port's (seed, task,
phase) draws differ on purpose, so a free-running comparison would drift;
with dropout 0 the train steps draw nothing.

A port-only run checks the resume: 3 tasks straight, then a run resumed at
task 1 in a copy of the work_dir gives the same accuracy rows and the same
weights, bit for bit.
"""

from __future__ import annotations

import copy
import json
import pathlib
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_torch.cil import CILTrainer as PortTrainer
from bdvcil_torch.config import Config as PortConfig
from bdvcil_torch.models import build_model as port_build_model
from bdvcil_torch.models.convert import from_jax_variables, jax_path, to_jax_variables
from bdvcil_torch.runtime import TrainState as PortTrainState
from bdvcil_torch.runtime import make_train_step as port_make_train_step
from bdvcil_tpu.cil import CILTrainer as JaxTrainer
from bdvcil_tpu.config import Config as JaxConfig
from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.parallel import make_mesh
from bdvcil_tpu.runtime import TrainState as JaxTrainState
from bdvcil_tpu.runtime import make_train_step as jax_make_train_step
from tests.synthetic import make_rawframe_tree
from tests.test_cil_e2e import make_cil_config
from tests.torch_port_helpers import numpy_tree

TASKS = 3
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
# the repo's tolerance for coupled steps (tests/test_torch_port_loops.py): at
# these weights JAX's f32 updates stray from the f64 ones far beyond f32
# rounding (the float64 witness below; the losses agree to 1e-4), so the
# parameters cannot be held closer to JAX's than this
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)
# each leaf's update against JAX's, in norm: over these 3 steps JAX's own f32
# update is up to 5.9e-2 off its f64 one, the port's 8e-3 (the float64
# witness below)
UPDATE_TOL = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(root, frames, train_ann, val_ann, work_dir):
    cfg = make_cil_config(root, frames, train_ann, val_ann, work_dir, use_cbf=True,
                          videos_per_gpu=3, budget_size=2, log_every_n_steps=1).to_dict()
    cfg["model"]["cls_head"]["dropout_ratio"] = 0.0
    return cfg


def port_module(tr: PortTrainer, variables):
    """A port module holding the JAX ``variables``."""
    sd = from_jax_variables(numpy_tree(variables))
    module = tr.spec.module(sd["cls_head.fc_weights"].shape[0])
    module.load_state_dict(sd)
    return module


def exemplar_file(tr, t: int) -> pathlib.Path:
    return tr.data_module.exemplar_dir / f"exemplar_task_{t}.txt"


def set_replay(tr, t: int) -> None:
    """Both trainers' data modules at task t, with the exemplars of 0..t-1."""
    dm = tr.data_module
    tr._current_task = t
    dm.exemplar_datasets = [dm.build_exemplar_dataset(str(exemplar_file(tr, i)))
                            for i in range(t)]
    dm.reload_train_dataset(use_internal_exemplar=True)


def float64_witness(jtr, ptr, grown, grown_prev):
    """The first epoch of the current task (its replay batches, dropout 0, so
    no draws) from ``grown`` and the previous model ``grown_prev``, four
    ways: JAX f32, JAX with x64 and an f64 model, the port f32 and the port
    f64 (its f32 casts made no-ops for f64 tensors). Returns {leaf: {run:
    update}} in float64, the update being the parameters after the epoch
    minus ``grown``'s."""
    loader = ptr.data_module.train_dataloader()
    batches, t = list(loader), ptr._current_task
    kw = dict(num_classes=ptr.num_classes(t), method=ptr.method, task_idx=t,
              prev_num_classes=ptr.num_classes(t - 1), kd_config=ptr._kd_config())

    def jax_update(dtype, spec):
        tx, _ = jtr._make_optimizer(grown["params"], "inc_step", len(batches))
        step = jax_make_train_step(spec=spec, tx=tx, donate=False, **kw)
        def cast(tree):
            return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dtype)), tree)

        state, prev = JaxTrainState.create(cast(grown), tx), cast(grown_prev)
        for b in batches:
            state, _ = step(state, prev, jnp.asarray(b["imgs"].astype(dtype)),
                            jnp.asarray(b["label"]),
                            {"sample_weight": jnp.asarray(b["sample_weight"])},
                            jax.random.PRNGKey(0))
        return dict(_leaves(jax.tree.map(np.asarray, dict(state.params)), np.float64))

    def port_update(dtype):
        ptr.spec = port_build_model(dict(ptr.config.model), dtype=dtype, device="cpu")
        ptr.model, prev = (port_module(ptr, v).to(dtype) for v in (grown, grown_prev))
        tx = ptr._make_optimizer("inc_step", len(batches))
        step = port_make_train_step(spec=ptr.spec, tx=tx, **kw)
        state = PortTrainState.create(ptr.model, tx)
        for b in batches:
            state, _ = step(state, prev, torch.from_numpy(b["imgs"]).to(dtype),
                            torch.from_numpy(b["label"]),
                            {"sample_weight": torch.from_numpy(b["sample_weight"])})
        return dict(_port_leaves(ptr.model))

    spec32 = ptr.spec
    j32 = jax_update(np.float32, jtr.spec)
    with jax.enable_x64(True):
        j64 = jax_update(np.float64, jax_build_model(dict(jtr.config.model), dtype=jnp.float64))
    p32 = port_update(torch.float32)
    cast32 = torch.Tensor.float
    torch.Tensor.float = lambda x, *a, **k: x if x.dtype == torch.float64 else cast32(x, *a, **k)
    try:
        p64 = port_update(torch.float64)
    finally:
        torch.Tensor.float = cast32
    ptr.spec = spec32
    start = dict(_leaves(grown["params"], np.float64))
    runs = dict(jax_f32=j32, jax_x64=j64, port_f32=p32, port_f64=p64)
    return {n: {run: u[n] - start[n] for run, u in runs.items()} for n in start}


def _port_leaves(module):
    """The module's parameters in float64, by their JAX names and layout."""
    for name, p in module.named_parameters():
        arr = p.detach().double().numpy()
        yield "/".join(jax_path(name)[1]), arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr


def new_metric_lines(path: pathlib.Path, start: int):
    return [json.loads(line) for line in path.read_text().splitlines()[start:]]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cil_parity")
    frames, train_ann, val_ann = make_rawframe_tree(root / "data", num_classes=4,
                                                    videos_per_class=4, num_frames=8,
                                                    size=(64, 80))
    cfg = tiny_config(root, frames, train_ann, val_ann, root / "jax_wd")
    jtr = JaxTrainer(JaxConfig.fromdict(copy.deepcopy(cfg)), mesh=make_mesh(jax.devices()[:1]))
    jtr.train()
    run_cnn = [list(r) for r in jtr.cnn_matrix]
    jax_ckpts = [numpy_tree(jtr._load_task_ckpt(t)) for t in range(TASKS)]

    pcfg = copy.deepcopy(cfg)
    pcfg["work_dir"] = str(root / "port_wd")
    ptr = PortTrainer(PortConfig.fromdict(pcfg), device="cpu")

    out = SimpleNamespace(root=root, cfg=cfg, jtr=jtr, ptr=ptr, run_cnn=run_cnn, tasks=[])
    for t in range(TASKS):
        # teacher forcing: both trainers hold the JAX checkpoint of task t
        jtr._current_task = ptr._current_task = t
        jtr.variables = jax_ckpts[t]
        ptr.model = port_module(ptr, jax_ckpts[t])
        nc = jtr.num_classes(t)
        rec = SimpleNamespace()
        rec.jpred = jtr._predict(jtr.data_module.get_val_dataloader([0, t]), nc, True)
        rec.ppred = ptr._predict(ptr.data_module.get_val_dataloader([0, t]), nc, True)
        rec.jsel = jtr._build_exemplar_for_current_task()
        rec.psel = ptr._build_exemplar_for_current_task()
        jtr.data_module.create_exemplar_ann_file(rec.jsel, task_idx=t)
        ptr.data_module.create_exemplar_ann_file(rec.psel, task_idx=t)
        rec.jmeans = jtr._get_exemplar_class_means(t, override_class_mean_ckpt=True)
        rec.pmeans = ptr._get_exemplar_class_means(t, override_class_mean_ckpt=True)
        rec.jacc = jtr._testing([0, t], "val", rec.jmeans)
        rec.pacc = ptr._testing([0, t], "val", rec.pmeans)
        if t + 1 < TASKS:
            # the first steps of task t+1 from the same grown weights and replay
            nc1 = jtr.num_classes(t + 1)
            grown = jtr.spec.grow_params(jax_ckpts[t], nc1, jax.random.PRNGKey(t))
            grown_prev = jtr.spec.grow_params(jax_ckpts[t], nc1, jax.random.PRNGKey(100 + t))
            jtr.variables, jtr.prev_variables = grown, grown_prev
            ptr.model, ptr.prev_model = port_module(ptr, grown), port_module(ptr, grown_prev)
            set_replay(jtr, t + 1)
            set_replay(ptr, t + 1)
            jlog, plog = jtr.work_dir / "metrics.jsonl", ptr.work_dir / "metrics.jsonl"
            jn, pn = len(jlog.read_text().splitlines()), len(plog.read_text().splitlines())
            jloader = jtr.data_module.train_dataloader()
            ploader = ptr.data_module.train_dataloader()
            rec.steps = len(ploader)
            rec.start = numpy_tree(grown)
            jtr._fit(jloader, 1, phase="inc_step")
            ptr._fit(ploader, 1, phase="inc_step")
            rec.jlosses = new_metric_lines(jlog, jn)
            rec.plosses = new_metric_lines(plog, pn)
            rec.jvars = numpy_tree(jtr.variables)
            rec.pvars = to_jax_variables(ptr.model.state_dict())
            if t == 0:
                out.witness = float64_witness(jtr, ptr, grown, grown_prev)
        out.tasks.append(rec)
    return out


def test_task_split_files_are_byte_identical(run):
    jdir, pdir = run.jtr.work_dir / "task_splits", run.ptr.work_dir / "task_splits"
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in pdir.iterdir()) and len(names) == 2 * TASKS
    for name in names:
        assert (jdir / name).read_bytes() == (pdir / name).read_bytes(), name


@pytest.mark.parametrize("t", range(TASKS))
def test_predictions_match_jax(run, t):
    rec = run.tasks[t]
    np.testing.assert_array_equal(rec.ppred["labels"], np.asarray(rec.jpred["labels"]))
    for key in ("cls_score", "repr"):
        np.testing.assert_allclose(rec.ppred[key], np.asarray(rec.jpred[key], np.float32),
                                   err_msg=key, **SCORE_TOL)
    np.testing.assert_allclose(np.linalg.norm(rec.ppred["repr"], axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("t", range(TASKS))
def test_exemplar_selection_matches_jax(run, t):
    rec = run.tasks[t]
    assert sorted(rec.psel) == sorted(rec.jsel)
    for c in rec.jsel:
        assert rec.psel[c]["indices"] == rec.jsel[c]["indices"], c
        assert rec.psel[c]["frame_dir"] == rec.jsel[c]["frame_dir"], c
    assert exemplar_file(run.ptr, t).read_bytes() == exemplar_file(run.jtr, t).read_bytes()


@pytest.mark.parametrize("t", range(TASKS))
def test_nme_class_means_match_jax(run, t):
    rec = run.tasks[t]
    assert rec.pmeans.shape == rec.jmeans.shape == (run.jtr.num_classes(t), 512)
    np.testing.assert_allclose(rec.pmeans, rec.jmeans, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t", range(TASKS))
def test_cnn_and_nme_accuracies_match_jax(run, t):
    rec = run.tasks[t]
    (pcnn, pnme), (jcnn, jnme) = rec.pacc, rec.jacc
    assert pcnn.values == jcnn.values == run.run_cnn[t]
    assert pnme.values == jnme.values
    assert pcnn.sizes == jcnn.sizes and len(pcnn.values) == t + 1


@pytest.mark.parametrize("t", range(TASKS - 1))
def test_next_task_train_steps_match_jax(run, t):
    rec = run.tasks[t]
    assert 1 < rec.steps <= 4
    key = f"[inc_step_Task_{t + 1}]loss"
    jl = [r[key] for r in rec.jlosses if key in r]
    pl = [r[key] for r in rec.plosses if key in r]
    assert len(pl) == len(jl) == rec.steps - 1  # the last step's metrics are not logged
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    for coll in ("params", "batch_stats"):
        flat_j = dict(_leaves(rec.jvars[coll]))
        flat_p = dict(_leaves(rec.pvars[coll]))
        assert flat_j.keys() == flat_p.keys()
        for name, ref in flat_j.items():
            np.testing.assert_allclose(flat_p[name], ref, **PARAM_TOL, err_msg=f"{coll}/{name}")
    # every parameter's update, against JAX's in norm
    start = dict(_leaves(rec.start["params"]))
    flat_j, flat_p = dict(_leaves(rec.jvars["params"])), dict(_leaves(rec.pvars["params"]))
    rel = {name: _rel(flat_p[name] - p0, flat_j[name] - p0) for name, p0 in start.items()}
    worst = max(rel, key=rel.get)
    print(f"task {t + 1}, {rec.steps} steps: worst update in norm {rel[worst]:.3g} ({worst})")
    for name, r in rel.items():
        assert r < UPDATE_TOL, f"{name}: update off JAX's by {r:.3g} in norm"
    # the classifier's update itself, against its size
    for name in ("head/fc_weights", "head/eta"):
        dj, dp = flat_j[name] - start[name], flat_p[name] - start[name]
        assert np.abs(dj).max() > 0
        np.testing.assert_allclose(dp, dj, rtol=0, atol=1e-2 * np.abs(dj).max(), err_msg=name)


def _leaves(tree, dtype=np.float32, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, dtype, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, dtype)


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_float64_witness_puts_the_f32_gap_on_jax(run):
    """Over task 1's first epoch JAX and the port compute the same steps:
    their f64 updates agree within 1e-6 of each leaf's norm. In f32 the
    port's update stays within 2e-2 of the f64 one in every leaf, and the
    whole of it sits closer to the f64 update than JAX's f32 update does."""
    rows = {name: {run_: _rel(u[key], u["port_f64"]) for run_, key in
                   (("x64", "jax_x64"), ("port", "port_f32"), ("jax", "jax_f32"))}
            for name, u in run.witness.items()}
    for key in ("x64", "port", "jax"):
        worst = max(rows, key=lambda n: rows[n][key])
        print(f"witness {key} vs port f64, per leaf: worst {rows[worst][key]:.3g} ({worst}), "
              f"median {np.median([r[key] for r in rows.values()]):.3g}")
    whole = {k: np.concatenate([u[k].ravel() for u in run.witness.values()])
             for k in ("jax_f32", "port_f32", "port_f64")}
    port_gap = _rel(whole["port_f32"], whole["port_f64"])
    jax_gap = _rel(whole["jax_f32"], whole["port_f64"])
    print(f"witness whole update vs port f64: port f32 {port_gap:.3g}, JAX f32 {jax_gap:.3g}")
    for name, r in rows.items():
        assert r["x64"] < 1e-6, f"{name}: JAX x64 and the port f64 differ by {r['x64']:.3g}"
        assert r["port"] < 2e-2, f"{name}: the port's f32 update is {r['port']:.3g} off f64"
    assert port_gap < jax_gap


def test_resume_at_task_1_equals_the_straight_run(run):
    root = run.root / "resume"
    cfg = copy.deepcopy(run.cfg)
    cfg["work_dir"] = str(root / "straight")
    straight = PortTrainer(PortConfig.fromdict(copy.deepcopy(cfg)), device="cpu")
    straight.train()
    shutil.copytree(root / "straight", root / "resumed")
    cfg.update(work_dir=str(root / "resumed"), starting_task=1)
    resumed = PortTrainer(PortConfig.fromdict(cfg), device="cpu")
    resumed.train()
    assert resumed.cnn_matrix == straight.cnn_matrix[1:]
    assert resumed.nme_matrix == straight.nme_matrix[1:]
    final = torch.load(root / "straight" / "ckpt" / "ckpt_task_2.pt", weights_only=True)
    again = resumed.model.state_dict()
    assert final.keys() == again.keys()
    for name, ref in final.items():
        assert torch.equal(again[name], ref), name
