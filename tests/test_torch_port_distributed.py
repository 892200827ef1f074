"""The port across ranks (bdvcil_torch/parallel, the distributed step, loop,
inference and trainer) on the CPU: two gloo ranks, as subprocesses, against
one process and against JAX.

The rank processes run ``tests/torch_dist_worker.py`` (torch only, a free
port each run, a timeout of 120 s each) while this process computes the
references. Workloads and what holds them:

  * ``tests/mp_worker.py``'s: R18, 2 frames at 32², 4 classes, LSC, dropout
    0.5, 20 samples at a global batch of 8, so the third step's tail has 4
    pad rows, all on rank 1. JAX runs the same three steps in this process
    on the whole batch on one CPU device, its global BatchNorm statistics
    being the SPMD semantics, with the port's dropout masks (its
    ``bernoulli`` is patched to return them). Step-0 loss rtol 1e-5; the
    other steps' losses rtol 1e-4; each leaf's update within
    ``UPDATE_TOL`` of JAX's in norm.
  * the float64 witness: the same workload, and config A's over two steps,
    in float64 on two ranks and in one process agree within 1e-7 of each
    leaf's update norm (measured: 6e-13 and 8e-10). In float32 the two
    differ by up to 5e-4 of an update (R18, three steps) and 2e-2 (R50, one
    step): an untrained BN ResNet's gradient amplifies reduction-order
    rounding (layer4's BatchNorms normalize over 16 and 8 values), so f32
    updates are held in norm only.
  * a task-0 step, growth 4 -> 6, and a task-1 step with exemplar-only
    feature-KD and the clip on the padded tail (classes 2-3 the exemplars):
    two ranks against one process, f32 and the float64 witness (measured
    1.2e-12).
  * the gathered inference rows of 10 samples at a global batch of 8 equal
    one process's (atol 1e-6) and JAX's (atol 1e-5); so do those of a global
    batch of 4 dispatched K = 2 batches a call.
  * ``bn_groups='per_device'`` on two ranks against ``bn_groups=2`` in one
    process and in JAX on one device.
  * ghost statistics (``bn_stats_rows=10``, one group) whose row prefix
    spans both ranks, in float64 against one process.
  * config A (``conv1x1_mode='pallas_stats'``, the GEMM-with-statistics op,
    its plain version on the CPU, with the sums all-reduced) at R50, one step
    of a global batch of 4, against one process and JAX's ``'xla'``.
  * a 2-rank mid-task resume, accumulation 2, equals the straight 2-rank run
    bit for bit.
  * a 2-task ``CILTrainer`` run (CBF, herding, NME) on a rawframe corpus at
    ``videos_per_gpu`` 2 on two ranks against 4 in one process.

One-process rules of ``parallel/`` (every collective an identity, no group
without a launcher, a missing card refused) are checked in this process.
"""

import copy
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import init_model_params as jax_init
from bdvcil_tpu.optim import build_optimizer as jax_build_optimizer
from bdvcil_tpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple
from bdvcil_tpu.runtime import TrainState as JaxTrainState
from bdvcil_tpu.runtime import make_eval_step as jax_make_eval_step
from bdvcil_tpu.runtime import make_train_step as jax_make_train_step
from bdvcil_torch.models import from_jax_variables
from bdvcil_torch.parallel import distributed, mesh
from bdvcil_torch.runtime.loops import step_generator
from tests import torch_dist_worker as W
from tests.mp_worker import ArrDataset
from tests.synthetic import make_rawframe_tree
from tests.test_cil_e2e import make_cil_config
from tests.torch_port_helpers import numpy_tree

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 120
WORLD = 2
# each leaf's f32 update against JAX's, in norm (the repo's tolerance for
# updates, tests/test_torch_port_cil_trainer.py)
UPDATE_TOL = 0.1
WITNESS_TOL = 1e-7
# the task-1 checkpoint of a 2-task run on two ranks against one process, as
# one vector in norm
CKPT_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _plain(tree):
    """Plain dicts, lists and tuples, so the ranks unpickle nothing of JAX's
    package (its ``Config`` nests its own dict type)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    return tree


def _cil_config(root, tree, work_dir, videos_per_gpu):
    cfg = make_cil_config(root, *tree, work_dir, use_cbf=True, videos_per_gpu=videos_per_gpu,
                          testing_videos_per_gpu=videos_per_gpu, budget_size=2,
                          log_every_n_steps=1, ending_task=1).to_dict()
    cfg["model"]["cls_head"]["dropout_ratio"] = 0.0
    return _plain(cfg)


class Ranks:
    """The rank processes, started at once; ``results()`` waits for them."""

    def __init__(self, tmp: pathlib.Path, inputs):
        torch.save(inputs, tmp / "inputs.pt")
        port = _free_port()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["CUDA_VISIBLE_DEVICES"] = ""
        self.outs = [tmp / f"rank{r}.pt" for r in range(WORLD)]
        self.logs = [open(tmp / f"rank{r}.log", "w+") for r in range(WORLD)]
        self.procs = [
            subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
                              "--rank", str(r), "--world", str(WORLD), "--port", str(port),
                              "--inputs", str(tmp / "inputs.pt"), "--out", str(self.outs[r])],
                             cwd=ROOT, env=env, stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(WORLD)]
        self._results = None

    def results(self):
        if self._results is None:
            try:
                codes = [p.wait(timeout=RANK_TIMEOUT_S) for p in self.procs]
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
            logs = []
            for f in self.logs:
                f.seek(0)
                logs.append(f.read()[-3000:])
                f.close()
            assert codes == [0] * WORLD, f"rank exit codes {codes}:\n" + "\n".join(logs)
            self._results = [torch.load(o, weights_only=False) for o in self.outs]
        return self._results


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    r18_vars = numpy_tree(jax_init(jax_build_model(W.model_cfg()), jax.random.PRNGKey(0),
                                   (1, W.T, 32, 32, 3)))
    r50_cfg = W.model_cfg(50, 0.0, conv1x1_mode="xla")
    r50_vars = numpy_tree(jax_init(jax_build_model(r50_cfg), jax.random.PRNGKey(1),
                                   (1, W.T, 32, 32, 3)))
    tree = make_rawframe_tree(tmp / "data", num_classes=4, videos_per_class=4, num_frames=8,
                              size=(64, 80))
    (tmp / "snap").mkdir()
    inputs = dict(r18=from_jax_variables(r18_vars), r50=from_jax_variables(r50_vars),
                  snap_dir=str(tmp / "snap"), cil=_cil_config(tmp, tree, tmp / "wd_ranks", 2))
    ranks = Ranks(tmp, inputs)
    (tmp / "snap_one").mkdir()
    return dict(ranks=ranks, tmp=tmp, inputs=inputs, r18_vars=r18_vars, r50_vars=r50_vars,
                one=W.run_all(dict(inputs, snap_dir=str(tmp / "snap_one"),
                                   cil=_cil_config(tmp, tree, tmp / "wd_one", 4))),
                one_groups2=W.train_steps(W.model_cfg(bn_groups=2), inputs["r18"], max_steps=2))


# --- JAX on the whole batch ------------------------------------------------------


def _dropout_masks(steps, rows, features=512):
    """The port's dropout masks of steps 0..steps-1 (its global draw)."""
    return [(torch.rand((rows, features), generator=step_generator(W.SEED, s, "cpu")) < 0.5)
            .numpy() for s in range(steps)]


def jax_steps(monkeypatch, cfg, variables, n, batch, max_steps=None):
    """JAX's train step over the batches of the port's one-process loader,
    with the port's dropout masks; (losses, variables after)."""
    import flax.linen.stochastic as stochastic

    masks = []

    class Random:
        """``jax.random`` with a ``bernoulli`` that returns the current mask."""

        def __getattr__(self, name):
            return getattr(jax.random, name)

        @staticmethod
        def bernoulli(key, p, shape):
            del key, p
            return jax.pure_callback(lambda: masks[-1], jax.ShapeDtypeStruct(tuple(shape),
                                                                               jnp.bool_))

    monkeypatch.setattr(stochastic, "random", Random())
    spec = jax_build_model(cfg)
    tx = jax_build_optimizer(variables["params"], W.OPT)
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx)
    step = jax_make_train_step(spec, tx, W.NC, donate=False)
    loader = W.train_loader(n, batch)
    loader.set_epoch(0)
    batches = list(loader)[:max_steps]
    all_masks = _dropout_masks(len(batches), batch * W.T)
    losses = []
    for b, mask in zip(batches, all_masks):
        masks.append(mask)
        state, m = step(state, None, jnp.asarray(b["imgs"]), jnp.asarray(b["label"]),
                        {"sample_weight": jnp.asarray(b["sample_weight"])},
                        jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    after = numpy_tree({"params": state.params, "batch_stats": state.batch_stats})
    return losses, from_jax_variables(after)


def update_gaps(got, want, start):
    """{leaf: |(got - start) - (want - start)| / |want - start|} over the
    parameters that moved."""
    gaps = {}
    for name, s in start.items():
        if (name not in want or not s.is_floating_point() or "running" in name
                or want[name].shape != s.shape):  # a grown classifier
            continue
        ref = want[name].double() - s.double()
        if float(ref.norm()) == 0:
            continue
        gaps[name] = float(((got[name].double() - s.double()) - ref).norm() / ref.norm())
    return gaps


def running_gap(got, want, start):
    """The BatchNorm running statistics' step, |(got - start) - (want - start)|
    / |want - start|, over all of them as one vector."""
    names = [k for k in start if "running" in k]
    d_got = torch.cat([(got[k].double() - start[k].double()).reshape(-1) for k in names])
    d_want = torch.cat([(want[k].double() - start[k].double()).reshape(-1) for k in names])
    return float((d_got - d_want).norm() / d_want.norm())


def assert_updates_close(got, want, start, tol, what):
    gaps = update_gaps(got, want, start)
    assert gaps, what
    worst = max(gaps, key=gaps.get)
    print(f"{what}: worst update gap {gaps[worst]:.3g} ({worst})")
    assert gaps[worst] <= tol, f"{what}: {worst} update off by {gaps[worst]:.3g} of its norm"


# --- the tests ---------------------------------------------------------------------


def test_ranks_hold_equal_weights_and_the_pad_rows_fall_on_one_rank(run):
    r0, r1 = run["ranks"].results()
    for key in ("mp_train", "per_device", "config_a", "mp_f64", "kd", "kd_f64", "ghost_f64"):
        for name, v in r0[key]["state"].items():
            assert torch.equal(v, r1[key]["state"][name]), (key, name)
    # the tail batch: rank 0 holds its 4 valid rows, rank 1 its 4 pad rows
    w0, w1 = r0["mp_train"]["sample_weights"], r1["mp_train"]["sample_weights"]
    assert len(w0) == 3 and all(len(w) == 4 for w in w0 + w1)
    assert w0[2].tolist() == [1, 1, 1, 1] and w1[2].tolist() == [0, 0, 0, 0]
    assert all(w.tolist() == [1, 1, 1, 1] for w in w0[:2] + w1[:2])


def test_two_gloo_ranks_match_jax_whole_batch_steps(run, monkeypatch):
    losses, after = jax_steps(monkeypatch, W.model_cfg(), run["r18_vars"], 20, 8)
    got = run["ranks"].results()[0]["mp_train"]
    np.testing.assert_allclose(got["losses"][0], losses[0], rtol=1e-5)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    assert_updates_close(got["state"], after, run["inputs"]["r18"], UPDATE_TOL,
                         "2 ranks vs JAX, 3 steps with the padded tail")


def test_two_ranks_match_one_process_and_its_float64_witness(run):
    r0 = run["ranks"].results()[0]
    one = run["one"]
    np.testing.assert_allclose(r0["mp_train"]["losses"], one["mp_train"]["losses"], rtol=1e-5)
    assert_updates_close(r0["mp_train"]["state"], one["mp_train"]["state"], run["inputs"]["r18"],
                         UPDATE_TOL, "2 ranks vs 1 process, f32")
    for key, start in (("mp_f64", "r18"), ("config_a_f64", "r50")):
        np.testing.assert_allclose(r0[key]["losses"], one[key]["losses"], rtol=WITNESS_TOL)
        assert_updates_close(r0[key]["state"], one[key]["state"], run["inputs"][start],
                             WITNESS_TOL, f"{key}: 2 ranks vs 1 process")
        # the running statistics read the all-reduced sums (#3's, under config A)
        gap = running_gap(r0[key]["state"], one[key]["state"], run["inputs"][start])
        print(f"{key}: running statistics off by {gap:.3g} of their step")
        assert gap <= WITNESS_TOL, f"{key}: running statistics off by {gap:.3g}"


def test_kd_step_with_exemplar_only_and_a_padded_tail_matches_one_process(run):
    r0 = run["ranks"].results()[0]
    one = run["one"]
    np.testing.assert_allclose(r0["kd"]["losses"], one["kd"]["losses"], rtol=1e-5)
    start = run["inputs"]["r18"]
    assert_updates_close(r0["kd"]["state"], one["kd"]["state"], start, UPDATE_TOL,
                         "KD step, 2 ranks vs 1 process, f32")
    np.testing.assert_allclose(r0["kd_f64"]["losses"], one["kd_f64"]["losses"],
                               rtol=WITNESS_TOL)
    assert_updates_close(r0["kd_f64"]["state"], one["kd_f64"]["state"], start, WITNESS_TOL,
                         "KD step, 2 ranks vs 1 process, f64")
    assert r0["kd"]["losses"][2] > 0  # the KD term contributed


def test_gathered_inference_rows_match_one_process_and_jax(run):
    r0, r1 = run["ranks"].results()
    one = run["one"]["mp_infer"]
    for got in (r0["mp_infer"], r1["mp_infer"]):
        assert got["cls_score"].shape[0] == 10
        assert torch.equal(got["labels"], one["labels"])
        for key in ("cls_score", "repr"):
            np.testing.assert_allclose(got[key].numpy(), one[key].numpy(), rtol=0, atol=1e-6)
    spec = jax_build_model(W.model_cfg())
    imgs = np.stack([ArrDataset(10, t=W.T, nc=W.NC)[i]["imgs"] for i in range(10)])
    ref = jax_make_eval_step(spec, W.NC)(jax.tree.map(jnp.asarray, run["r18_vars"]),
                                         jnp.asarray(imgs))
    for key in ("cls_score", "repr"):
        np.testing.assert_allclose(r0["mp_infer"][key].numpy(), np.asarray(ref[key]), rtol=0,
                                   atol=1e-5)


def test_gathered_inference_with_k_step_dispatch_matches_one_process(run):
    """K = 2 batches a dispatch across the ranks (a 2-batch group, then a
    ragged single batch whose pad rows fall on rank 1) gives one process's
    K = 1 rows."""
    one = run["one"]["mp_infer"]
    for r in run["ranks"].results():
        got = r["mp_infer_k2"]
        assert got["cls_score"].shape[0] == 10
        assert torch.equal(got["labels"], one["labels"])
        for key in ("cls_score", "repr"):
            np.testing.assert_allclose(got[key].numpy(), one[key].numpy(), rtol=0, atol=1e-6)


def test_per_device_bn_groups_match_bn_groups_2_in_one_process_and_jax(run, monkeypatch):
    got = run["ranks"].results()[0]["per_device"]
    one = run["one_groups2"]
    losses, after = jax_steps(monkeypatch, W.model_cfg(bn_groups=2), run["r18_vars"], 20, 8,
                              max_steps=2)
    for ref_losses in (one["losses"], losses):
        np.testing.assert_allclose(got["losses"][0], ref_losses[0], rtol=1e-5)
        np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-4)
    start = run["inputs"]["r18"]
    assert_updates_close(got["state"], one["state"], start, UPDATE_TOL, "per_device vs groups 2")
    assert_updates_close(got["state"], after, start, UPDATE_TOL, "per_device vs JAX groups 2")
    for name in after:  # the running statistics: the mean over the ranks' groups
        if "running" in name:
            np.testing.assert_allclose(got["state"][name].numpy(), after[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_ghost_statistics_over_the_ranks_match_one_process(run):
    """``bn_stats_rows=10`` with one group: the statistics' row prefix spans
    rank 0's 8 rows and 2 of rank 1's; float64, against one process."""
    got, one = run["ranks"].results()[0]["ghost_f64"], run["one"]["ghost_f64"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=WITNESS_TOL)
    assert_updates_close(got["state"], one["state"], run["inputs"]["r18"], WITNESS_TOL,
                         "ghost statistics, 2 ranks vs 1 process, f64")
    for name, v in one["state"].items():
        if "running" in name:
            np.testing.assert_allclose(got["state"][name].numpy(), v.numpy(), rtol=1e-9,
                                       atol=1e-12, err_msg=name)


def test_config_a_on_two_ranks_matches_one_process_and_jax_xla(run, monkeypatch):
    got = run["ranks"].results()[0]["config_a"]
    one = run["one"]["config_a"]
    losses, after = jax_steps(monkeypatch, W.model_cfg(50, 0.0, conv1x1_mode="xla"),
                              run["r50_vars"], 8, 4, max_steps=1)
    start = run["inputs"]["r50"]
    for ref_losses, ref_state, what in ((one["losses"], one["state"], "1 process"),
                                        (losses, after, "JAX 'xla'")):
        np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-5, err_msg=what)
        assert_updates_close(got["state"], ref_state, start, UPDATE_TOL, f"config A vs {what}")


def test_two_rank_midtask_resume_is_bit_exact(run):
    for r in run["ranks"].results():
        res = r["resume"]
        assert res["steps"] == (9, 9)
        for name, v in res["straight"].items():
            assert torch.equal(v, res["resumed"][name]), name


def test_two_rank_train_cil_matches_one_process(run):
    r0, r1 = run["ranks"].results()
    one = run["one"]["train_cil"]
    for r in (r0, r1):
        assert r["train_cil"]["cnn"] == one["cnn"]
        assert r["train_cil"]["nme"] == one["nme"]
    assert len(one["cnn"]) == 2
    # the whole task-1 checkpoint in norm: over two tasks of f32 steps the
    # reduction-order rounding grows as in the step tests above
    names = [k for k, v in one["ckpt"].items() if v.is_floating_point()]
    got = torch.cat([r0["train_cil"]["ckpt"][k].double().reshape(-1) for k in names])
    want = torch.cat([one["ckpt"][k].double().reshape(-1) for k in names])
    gap = float((got - want).norm() / want.norm())
    print(f"train_cil checkpoint gap {gap:.3g}")
    assert gap < CKPT_TOL, gap
    wd = run["tmp"] / "wd_ranks"
    assert sorted(p.name for p in (wd / "ckpt").glob("ckpt_task_*.pt")) == [
        "ckpt_task_0.pt", "ckpt_task_1.pt"]
    assert (wd / "exemplar" / "exemplar_task_1.txt").read_text() == (
        run["tmp"] / "wd_one" / "exemplar" / "exemplar_task_1.txt").read_text()


# --- one process -----------------------------------------------------------------


def test_one_process_collectives_are_identities(tmp_path, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "BDVC_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.initialize() is None and not distributed.is_initialized()
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)
    assert distributed.is_primary() and distributed.launch_rank() == (0, 1)
    x = torch.arange(6.0).reshape(3, 2)
    assert distributed.all_reduce_sum(x) is x
    assert np.array_equal(distributed.all_gather_host(np.ones(3)), np.ones(3))
    s1, s2 = distributed.global_sums(x[0], x[1])
    assert torch.equal(s1, x[0]) and torch.equal(s2, x[1])
    assert float(distributed.global_count(5, x)) == 5.0
    assert mesh.local_rows(8) == (0, 8)
    assert np.array_equal(mesh.gather_to_host(x, n_valid=2), x.numpy()[:2])
    module = torch.nn.Linear(2, 2)
    assert mesh.replicate(module) is module
    distributed.sync_processes()
    monkeypatch.setenv("BDVC_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("BDVC_NUM_PROCESSES", "4")
    monkeypatch.setenv("BDVC_PROCESS_ID", "3")
    assert distributed.launch_rank() == (3, 4)


def test_a_rank_without_its_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize(init_method="tcp://127.0.0.1:1", world_size=2, rank=1)
    assert not distributed.is_initialized()


@pytest.mark.parametrize("shape,multiple", [((5, 3), 4), ((8, 2), 4), ((1,), 3)])
def test_pad_to_multiple_matches_jax(shape, multiple):
    a = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got, n = mesh.pad_to_multiple(a, multiple)
    want, m = jax_pad_to_multiple(a, multiple)
    assert n == m and np.array_equal(got, want)
