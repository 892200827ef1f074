"""The port's accuracy studies held against the JAX package's: the
reference-loop mirror (``bdvcil_torch/reference_loop``), ``parity_study``
and ``bn_ablation`` against ``tests/synthetic.py``,
``tests/test_protocol_parity.py``, ``tests/torch_cil_reference.py``,
``tools/parity_study.py`` and ``tools/bn_ablation.py``, on the CPU at a cut
size.

  * the study tree: every file byte for byte (annotation files and JPEG
    frames), at cut ``TREE_PARAMS`` (fewer videos, 4 and 10 classes);
  * the study's config, method and depth overrides: equal dicts;
  * the mirror: the port's ``TorchMiniCIL`` and the tests' on a cut protocol
    (2 stages, 1 epoch, 1 CBF epoch), ``base`` and ``icarl_video_mix``: equal
    CNN and NME matrices and equal final weights (both torch f32 on equal
    batches);
  * ``run_pair``: the port's logits at the shared init within rtol 2e-4,
    atol 2e-5 of the mirror's; two CPU calls equal;
  * ``summarize`` equal to the JAX tool's with the keys renamed; the CLI's
    refusals equal to the JAX tool's; ``--resume`` skips the seeds done;
  * ``bn_ablation``: ``make_data`` equal, each mode's model config equal to
    the one the JAX tool builds, and with JAX's init and dropout 0 each
    mode's losses over 3 steps within rtol 1e-4 of JAX's; ``main``'s lines
    in the JAX tool's schema.
"""

from __future__ import annotations

import copy
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import bdvcil_tpu.models as jax_models
import bdvcil_tpu.models.norm as jax_norm
import bdvcil_tpu.optim as jax_optim
import bdvcil_tpu.runtime as jax_runtime
import jax
import jax.numpy as jnp
from bdvcil_torch import bn_ablation, parity_study
from bdvcil_torch import runtime as port_runtime
from bdvcil_torch.models import build_model as port_build_model
from bdvcil_torch.models import init_model_params as port_init_model_params
from bdvcil_torch.optim import build_optimizer as port_build_optimizer
from bdvcil_torch.models.convert import from_jax_variables
from bdvcil_torch.reference_loop import mini_cil, tree
from tests import synthetic
from tests import test_protocol_parity as jax_parity
from tests import torch_cil_reference
from tools import bn_ablation as jax_bn_ablation
from tools import parity_study as jax_parity_study

# a cut of the study tree: 4 classes (two 2-class stages), fewer videos
CUT_TREE = dict(tree.TREE_PARAMS, num_classes=4, train_videos_per_class=3,
                val_videos_per_class=2, extra_val_videos_per_class=1)
# 2 stages, 1 epoch, 1 CBF epoch
CUT_PROTOCOL = dict(tree.depth_overrides(2), num_epochs_per_task=1, cbf_num_epochs_per_task=1)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
LOSS_RTOL = 1e-4
WITNESS_RTOL = 1e-6
# bn_ablation's f32 losses of steps 2 and 3 against JAX's f32 ones: each just
# above the furthest that either package's f32 loss at that step lies from
# its own f64 loss (1.6e-3 at step 2, 6.3e-3 at step 3, the ghost mode)
F32_STEP_RTOLS = (2e-3, 1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cut_tree(tmp_path_factory):
    return tree.build_parity_tree(tmp_path_factory.mktemp("study_tree"), CUT_TREE)


def _files(root: pathlib.Path):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


# -- the tree and the configs ---------------------------------------------------


@pytest.mark.parametrize("params", [
    CUT_TREE,
    dict(tree.DEPTH_TREE_PARAMS, num_classes=10, train_videos_per_class=2,
         val_videos_per_class=1, extra_val_videos_per_class=1, num_frames=3),
], ids=["base_cut", "depth_cut_3_levels"])
def test_tree_writes_the_jax_sides_files(tmp_path, params):
    port = tree.make_learnable_rawframe_tree(tmp_path / "port", **params)
    ref = synthetic.make_learnable_rawframe_tree(tmp_path / "jax", **params)
    assert [p.relative_to(tmp_path / "port") for p in port] == [
        p.relative_to(tmp_path / "jax") for p in ref]
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) > 2
    assert [k for k in got if got[k] != want[k]] == []


def test_parity_tree_with_backgrounds_equals_the_jax_sides(tmp_path):
    tree.build_parity_tree(tmp_path / "port", CUT_TREE)
    jax_parity.build_parity_tree(tmp_path / "jax", CUT_TREE)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want
    assert sum(k.startswith("bg/") for k in got) == 6


def _config_pair(tmp_path, **overrides):
    args = (tmp_path, tmp_path / "rawframes", tmp_path / "train_ann.txt",
            tmp_path / "val_ann.txt", tmp_path / "work")
    return (tree.make_parity_config(*args, **overrides).to_dict(),
            jax_parity.make_parity_config(*args, **overrides).to_dict())


@pytest.mark.parametrize("method", ["base", "icarl", "icarl_video_mix"])
def test_method_overrides_and_config_equal_the_jax_sides(tmp_path, method):
    assert tree.method_overrides(method) == jax_parity.method_overrides(method)
    port, ref = _config_pair(tmp_path, **tree.method_overrides(method))
    assert port == ref


@pytest.mark.parametrize("stages", [2, 6])
def test_depth_overrides_equal_the_jax_sides(tmp_path, stages):
    assert tree.depth_overrides(stages) == jax_parity.depth_overrides(stages)
    port, ref = _config_pair(tmp_path, **tree.depth_overrides(stages))
    assert port == ref


def test_tree_constants_equal_the_jax_sides():
    assert tree.TREE_PARAMS == jax_parity.TREE_PARAMS
    assert tree.DEPTH_TREE_PARAMS == jax_parity.DEPTH_TREE_PARAMS
    assert tree.make_icarl_model() == jax_parity.make_icarl_model()


# -- the mirror ---------------------------------------------------------------


@pytest.mark.parametrize("method", ["base", "icarl_video_mix"])
def test_mirror_equals_the_tests_mirror_on_a_cut_protocol(cut_tree, tmp_path, method):
    root, frames, train_ann, val_ann = cut_tree
    overrides = dict(tree.method_overrides(method), **CUT_PROTOCOL)
    cfg_port = tree.make_parity_config(root, frames, train_ann, val_ann, tmp_path / "port",
                                       **overrides)
    cfg_ref = jax_parity.make_parity_config(root, frames, train_ann, val_ann,
                                            tmp_path / "ref", **overrides)
    if method != "base":
        cfg_port.optimizer["lr"] = cfg_ref.optimizer["lr"] = 0.01

    port = mini_cil.TorchMiniCIL(cfg_port, device="cpu")
    port.train()
    ref = torch_cil_reference.TorchMiniCIL(cfg_ref)
    ref.train()

    assert len(port.cnn_matrix) == 2
    assert port.cnn_matrix == ref.cnn_matrix
    assert port.nme_matrix == ref.nme_matrix
    got, want = port.model.state_dict(), ref.model.state_dict()
    assert got.keys() == want.keys()
    assert [k for k in got if not torch.equal(got[k], want[k])] == []


def test_mirror_runs_on_the_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    cfg = tree.make_parity_config(tmp_path, tmp_path, tmp_path, tmp_path, tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mini_cil.TorchMiniCIL(cfg)


@pytest.mark.parametrize("method", ["base", "icarl"])
def test_port_logits_at_the_shared_init_match_the_mirror(cut_tree, tmp_path, method):
    mini, trainer = parity_study.make_pair(cut_tree, tmp_path / "ref", tmp_path / "port",
                                           method, "cpu", **CUT_PROTOCOL)
    x = np.random.default_rng(0).normal(size=(3, tree.T, tree.CROP, tree.CROP, 3))
    x = x.astype(np.float32)
    mini.model.eval()
    with torch.no_grad():
        ref = mini.model(mini_cil._to_torch_frames(x, torch.device("cpu")))["cls_score"]
        got = trainer.model(torch.from_numpy(x), train=False)["cls_score"][:, 0]
    assert got.shape == ref.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **LOGIT_TOL)


def test_run_pair_twice_on_the_cpu_is_equal(cut_tree, tmp_path):
    runs = [parity_study.run_pair(cut_tree, tmp_path / f"work{i}", "base", 0, CUT_PROTOCOL,
                                  "cpu") for i in range(2)]
    keys = {"seed", "device", "wall_reference_s", "wall_port_s"} | {
        f"{m}_{side}" for m in ("cnn", "nme", "cnn_matrix", "nme_matrix")
        for side in ("reference", "port")}
    assert set(runs[0]) == keys
    for r in runs:
        assert r["wall_reference_s"] > 0 and r["wall_port_s"] > 0
        assert len(r["cnn_matrix_port"]) == len(r["cnn_reference"]) == 2
        assert not list((tmp_path / "work0").glob("*"))  # each pair's work dirs removed
    strip = lambda r: {k: v for k, v in r.items() if not k.startswith("wall_")}  # noqa: E731
    assert strip(runs[0]) == strip(runs[1])


# -- summarize and the CLI -------------------------------------------------------


def _renamed(run):
    names = {"torch": "reference", "jax": "port"}
    out = {}
    for key, value in run.items():
        head, _, side = key.rpartition("_")
        out[f"{head}_{names[side]}" if side in names else key] = value
    return out


def _fake_runs(seeds, stages, rng, collapse=()):
    runs = []
    for seed in seeds:
        run = {"seed": seed}
        for metric in ("cnn", "nme"):
            for side in ("torch", "jax"):
                vals = list(rng.uniform(25, 95, size=stages))
                if (seed, metric, side) in collapse:
                    vals[-1] = float(rng.uniform(0, 19))
                run[f"{metric}_{side}"] = vals
        runs.append(run)
    return runs


@pytest.mark.parametrize("case", ["several", "none_converged", "one_pair"])
def test_summarize_equals_the_jax_tools(case):
    rng = np.random.default_rng(5)
    if case == "several":
        runs = _fake_runs(range(6), 3, rng, collapse={(1, "cnn", "torch"), (4, "nme", "jax"),
                                                      (2, "cnn", "jax")})
    elif case == "none_converged":
        runs = _fake_runs(range(2), 2, rng, collapse={(0, m, s) for m in ("cnn", "nme")
                                                      for s in ("torch",)} | {
            (1, m, "jax") for m in ("cnn", "nme")})
    else:
        runs = _fake_runs([7], 4, rng)
    want = jax_parity_study.summarize(runs)
    got = parity_study.summarize([_renamed(r) for r in runs])
    for metric in ("cnn", "nme"):
        w = dict(want[metric])
        w["n_collapsed_reference"] = w.pop("n_collapsed_torch")
        w["n_collapsed_port"] = w.pop("n_collapsed_jax")
        assert got[metric] == w
    if case == "none_converged":
        assert got["cnn"]["no_converged_pairs"] and got["cnn"]["final_stage_mean_delta"] is None
    if case == "one_pair":
        assert got["cnn"]["n_converged"] == 1 and got["cnn"]["final_stage_se"] is None


def _fake_tree(root, params=None):
    return root, root / "rawframes", root / "train_ann.txt", root / "val_ann.txt"


def _resume_file(path: pathlib.Path, method="base", seeds=(0,)):
    runs = [dict(_renamed(r), wall_reference_s=1.5, wall_port_s=2.5)
            for r in _fake_runs(seeds, 3, np.random.default_rng(1))]
    path.write_text(json.dumps(dict(method=method, stages=3, extra_val=None,
                                    n_seeds=len(runs), runs=runs)))


def _jax_main(monkeypatch, argv):
    monkeypatch.setattr(jax_parity_study, "_register_for_bench_pause", lambda: None)
    monkeypatch.setattr(jax_parity, "build_parity_tree", _fake_tree)
    monkeypatch.setattr(sys, "argv", ["parity_study.py"] + argv)
    jax_parity_study.main()


@pytest.mark.parametrize("argv", [
    ["--stages", "1"], ["--stages", "14"], ["--seeds", "0"], ["--set", "use_cbf"],
    ["--method", "finetune"], ["--resume", "--method", "icarl"],
    ["--resume", "--set", "use_cbf=False"], ["--resume", "--stages", "6"],
], ids=["stages_1", "stages_14", "seeds_0", "set_without_value", "method",
        "resume_other_method", "resume_other_overrides", "resume_other_stages"])
def test_cli_refuses_what_the_jax_tool_refuses(tmp_path, monkeypatch, argv):
    out = tmp_path / "study.json"
    _resume_file(out)
    argv = argv + ["--out", str(out), "--data_root", str(tmp_path / "data")]
    monkeypatch.setattr(parity_study, "build_parity_tree", _fake_tree)
    monkeypatch.setattr(parity_study, "run_pair", pytest.fail)
    with pytest.raises(SystemExit) as port_exit:
        parity_study.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jax_exit:
        _jax_main(monkeypatch, argv)
    assert port_exit.value.code == jax_exit.value.code == 2


def test_resume_skips_done_seeds_and_dumps_each(tmp_path, monkeypatch):
    out = tmp_path / "study.json"
    _resume_file(out, seeds=(0, 2))
    done = json.loads(out.read_text())["runs"]
    calls = []

    def fake_pair(tree_, work_root, method, seed, extra, device):
        calls.append(seed)
        return dict(done[0], seed=seed)

    monkeypatch.setattr(parity_study, "build_parity_tree", _fake_tree)
    monkeypatch.setattr(parity_study, "run_pair", fake_pair)
    assert parity_study.main(["--seeds", "4", "--resume", "--out", str(out), "--data_root",
                              str(tmp_path / "data"), "--device", "cpu"]) == 0
    assert calls == [1, 3]
    payload = json.loads(out.read_text())
    assert [r["seed"] for r in payload["runs"]] == [0, 2, 1, 3]
    assert payload["n_seeds"] == 4 and payload["device"] == "cpu"
    assert payload["summary"]["cnn"]["n_converged"] == 4


# -- bn_ablation ----------------------------------------------------------------


def test_make_data_equals_the_jax_tools():
    for seed in (0, 3):
        means = np.random.default_rng(seed).normal(size=(8, 3)) * 0.8
        for kw in (dict(jitter=0.5), dict(per_class=8, jitter=0.7, hw=16, t=3)):
            got = bn_ablation.make_data(np.random.default_rng(seed), means, **kw)
            want = jax_bn_ablation.make_data(np.random.default_rng(seed), means, **kw)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


class _Captured(Exception):
    pass


def _small_data(per_class=12):
    rng = np.random.default_rng(0)
    means = rng.normal(size=(8, 3)) * 0.8
    x, y = bn_ablation.make_data(rng, means, per_class=per_class, jitter=0.5)
    x_val, y_val = bn_ablation.make_data(np.random.default_rng(100), means, per_class=1,
                                         jitter=0.7)
    return x, y, x_val, y_val


@pytest.mark.parametrize("name,extra", bn_ablation.MODES, ids=["global", "groups8", "ghost16"])
def test_mode_config_equals_the_jax_tools(monkeypatch, name, extra):
    seen = []

    def capture(cfg, *a, **kw):
        seen.append(copy.deepcopy(cfg))
        raise _Captured

    monkeypatch.setattr(jax_models, "build_model", capture)
    with pytest.raises(_Captured):
        jax_bn_ablation.run_mode(name, extra, *_small_data(), epochs=1)
    assert bn_ablation.mode_config(extra, 2, 8) == seen[0]


class _F64:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX norm's
    explicit f32 statistics in f64, for the witness."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _witness_losses(cfg, init, x, y, order, batch=32):
    """Three steps of one mode in float64 on both sides from the same init:
    JAX under x64 (its norm's f32 casts made f64), the port with its
    ``.float()`` casts made no-ops for f64 tensors."""
    idxs = [order[i : i + batch] for i in range(0, len(order) - batch + 1, batch)]
    jax_losses, port_losses = [], []
    with jax.enable_x64(True):
        spec = jax_models.build_model(cfg, dtype=jnp.float64)
        variables = jax.tree.map(lambda a: jnp.asarray(a.astype(np.float64)), init)
        tx = jax_optim.build_optimizer(variables["params"], bn_ablation.OPTIMIZER)
        state = jax_runtime.TrainState.create(variables, tx)
        step = jax_runtime.make_train_step(spec, tx, num_classes=8, method="base", task_idx=0)
        for idx in idxs:
            state, m = step(state, None, jnp.asarray(x[idx].astype(np.float64)),
                            jnp.asarray(y[idx][:, None]), {}, jax.random.PRNGKey(0))
            jax_losses.append(float(m["loss"]))
    spec = port_build_model(cfg, dtype=torch.float64, device="cpu")
    module = port_init_model_params(spec, 0, 8)
    module.load_state_dict(from_jax_variables(init))
    module.to(torch.float64)
    tx = port_build_optimizer(module, bn_ablation.OPTIMIZER)
    state = port_runtime.TrainState.create(module, tx)
    step = port_runtime.make_train_step(spec, tx, num_classes=8, method="base", task_idx=0)
    for idx in idxs:
        state, m = step(state, None, torch.from_numpy(x[idx]).double(),
                        torch.from_numpy(y[idx][:, None]), {}, None)
        port_losses.append(float(m["loss"]))
    return jax_losses, port_losses


@pytest.mark.parametrize("name,extra", bn_ablation.MODES, ids=["global", "groups8", "ghost16"])
def test_three_step_losses_match_jax_from_its_init(monkeypatch, name, extra):
    """Both tools' ``run_mode`` from JAX's init with dropout 0, 3 steps of 32.

    In f32 the first loss (the forward from the shared init) agrees within
    rtol 1e-4; the next two carry rounding chaos in both packages (this
    untrained R18 at 32x32 amplifies a rounding difference ~100-300x a
    step; under ghost statistics each package's f32 loss parts from its f64
    one by 1.6e-3 at step 2 and 6.3e-3 at step 3), so the f32 losses of
    steps 2 and 3 are held to JAX's at ``F32_STEP_RTOLS``, set from that
    stray, and the three steps are held in float64, where the two packages
    compute the same losses within 1e-8 (rtol 1e-6 here, the tolerance asked
    1e-4)."""
    x, y, x_val, y_val = _small_data(per_class=12)  # 96 clips: 3 steps of 32
    init, jax_losses, port_losses = [], [], []
    real_build, real_init = jax_models.build_model, jax_models.init_model_params
    real_step = jax_runtime.make_train_step

    def build_no_dropout(cfg, *a, **kw):
        cfg = copy.deepcopy(cfg)
        cfg["cls_head"]["dropout_ratio"] = 0.0
        return real_build(cfg, *a, **kw)

    def keep_init(*a, **kw):
        variables = real_init(*a, **kw)
        # a copy: the train step donates the state's buffers
        init.append(jax.tree.map(lambda v: np.array(v, np.float32, copy=True), dict(variables)))
        return variables

    def recording(real, sink):
        def make(*a, **kw):
            step = real(*a, **kw)

            def run(*sa, **skw):
                state, metrics = step(*sa, **skw)
                sink.append(float(metrics["loss"]))
                return state, metrics
            return run
        return make

    def no_eval(spec, num_classes):  # accuracies are not compared: skip the eval compile
        return lambda variables, xb: {"cls_score": np.zeros((xb.shape[0], 1, num_classes))}

    with monkeypatch.context() as m:
        m.setattr(jax_models, "build_model", build_no_dropout)
        m.setattr(jax_models, "init_model_params", keep_init)
        m.setattr(jax_runtime, "make_train_step", recording(real_step, jax_losses))
        m.setattr(jax_runtime, "make_eval_step", no_eval)
        jax_bn_ablation.run_mode(name, extra, x, y, x_val, y_val, epochs=1, seed=0)
        m.setattr(bn_ablation, "make_train_step",
                  recording(bn_ablation.make_train_step, port_losses))
        rec = bn_ablation.run_mode(name, extra, x, y, x_val, y_val, epochs=1, seed=0,
                                   device="cpu", dropout_ratio=0.0, init_state=from_jax_variables(init[0]))
    assert len(jax_losses) == len(port_losses) == 3
    np.testing.assert_allclose(port_losses[0], jax_losses[0], rtol=LOSS_RTOL)
    for got, want, rtol in zip(port_losses[1:], jax_losses[1:], F32_STEP_RTOLS):
        np.testing.assert_allclose(got, want, rtol=rtol)
    assert rec["final_train_loss"] == round(port_losses[-1], 4)
    assert 0 <= rec["train_acc"] <= 1 and 0 <= rec["val_acc"] <= 1

    # the witness, on the tools' data order (epoch 0 of seed 0)
    monkeypatch.setattr(jax_norm, "jnp", _F64())
    cast32 = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t, *a, **k: t if t.dtype == torch.float64
                        else cast32(t, *a, **k))
    order = np.random.default_rng(2).permutation(len(y))
    jax64, port64 = _witness_losses(bn_ablation.mode_config(extra, 2, 8, 0.0), init[0], x, y,
                                    order)
    assert len(jax64) == 3
    np.testing.assert_allclose(port64, jax64, rtol=WITNESS_RTOL)


def test_main_prints_the_jax_tools_schema(monkeypatch, capsys):
    monkeypatch.setenv("BN_SEEDS", "0")
    monkeypatch.setenv("BN_EPOCHS", "1")
    assert bn_ablation.main(["--device", "cpu"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]

    modes = []

    def fake_run(name, extra, *a, **kw):
        modes.append((name, extra))
        rec = {"mode": name, "final_train_loss": 1.0, "train_acc": 0.5, "val_acc": 0.5}
        print(json.dumps(rec))
        return rec

    monkeypatch.setattr(jax_bn_ablation, "run_mode", fake_run)
    jax_bn_ablation.main()
    want = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(lines) == len(want) == 4
    assert modes == bn_ablation.MODES
    for got_rec, want_rec in zip(lines[:3], want[:3]):
        assert got_rec.keys() == want_rec.keys() and got_rec["mode"] == want_rec["mode"]
        assert np.isfinite(got_rec["final_train_loss"])
    assert lines[3].keys() == want[3].keys() and lines[3]["seeds"] == want[3]["seeds"] == [0]
    assert lines[3]["summary"].keys() == want[3]["summary"].keys()
    for mode, agg in lines[3]["summary"].items():
        assert agg.keys() == want[3]["summary"][mode].keys()
