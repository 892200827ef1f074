"""The port's checkpoints and train snapshots (``bdvcil_torch/runtime/
checkpoint.py``), on the CPU.

  * a checkpoint round trip: state_dict and sidecar meta;
  * a JAX checkpoint, written and read by the JAX package, loaded into the
    port through ``models/convert.py``: the same eval forward (rtol 1e-4,
    atol 1e-4, tests/test_torch_port_model.py);
  * the snapshot header peek (and a missing, truncated or foreign file read
    as no snapshot), ``clear_train_snapshot``, and a stale snapshot refused;
  * mid-task resume, as tests/test_midtask_resume.py:90 asks of JAX: 3
    straight epochs against 1 epoch, a snapshot, a state rebuilt from other
    weights, the snapshot loaded and 2 more epochs; every parameter, buffer
    and optimizer-state leaf equal bit for bit, with dropout on, a K = 2
    chunk and a single step in every epoch, and an LR milestone crossed.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import init_model_params as jax_init
from bdvcil_tpu.runtime import checkpoint as jax_ckpt
from bdvcil_torch.models import build_model, from_jax_variables, init_model_params
from bdvcil_torch.optim import build_optimizer
from bdvcil_torch.runtime import TrainState, make_multi_train_step, make_train_step
from bdvcil_torch.runtime import checkpoint as ckpt
from bdvcil_torch.runtime.loops import train_epochs
from tests.torch_port_helpers import T, model_cfg, randomize_bn, to_torch

META = dict(task=1, phase="inc_step", epoch=0, num_classes=5, run_token="abc123")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The shapes are tiny: one intra-op thread is about as fast alone, and
    far faster when the suite's workers share the cores (idle intra-op
    threads spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(nc=5, dropout=0.0):
    cfg = model_cfg(18, "pad", "xla", nc, in_channels=512)
    cfg["cls_head"]["dropout_ratio"] = dropout
    return build_model(cfg, device="cpu")


def test_checkpoint_round_trip(tmp_path):
    model = init_model_params(_spec(), 3)
    path = tmp_path / "ckpt" / "ckpt_task_1.pt"
    ckpt.save_checkpoint(path, model, meta=dict(num_classes=5))
    state, meta = ckpt.load_checkpoint(path)
    assert meta == dict(num_classes=5)
    want = model.state_dict()
    assert set(state) == set(want)
    assert all(torch.equal(state[k], want[k]) for k in want)
    ckpt.save_checkpoint(tmp_path / "bare.pt", want)
    assert ckpt.load_checkpoint(tmp_path / "bare.pt")[1] is None


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    cfg = model_cfg(18, "pad", "xla", 5, in_channels=512)
    jspec = jax_build_model(cfg)
    variables = randomize_bn(jax_init(jspec, jax.random.PRNGKey(2), (1, T, 32, 32, 3)), seed=5)
    path = tmp_path / "ckpt_task_0.msgpack"
    jax_ckpt.save_checkpoint(path, variables, meta=dict(num_classes=5))
    restored, meta = jax_ckpt.load_checkpoint(path)
    assert meta == dict(num_classes=5)

    x = np.random.default_rng(1).standard_normal((2, T, 32, 32, 3)).astype(np.float32)
    ref = jspec.module().apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x), train=False)
    model = build_model(cfg, device="cpu").module()
    model.load_state_dict(from_jax_variables(restored), strict=True)
    with torch.no_grad():
        out = model(to_torch(x), train=False)
    for key in ("cls_score", "repr"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)


def _state(seed=0, dropout=0.0, accumulate=1):
    spec = _spec(dropout=dropout)
    model = init_model_params(spec, seed)
    tx = build_optimizer(model, dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=1e-4,
                                     paramwise_cfg=dict(fc_lr_scale_factor=5.0)),
                         dict(type="MultiStepLR", params=dict(milestones=[2], gamma=0.1)),
                         steps_per_epoch=-(-3 // accumulate), accumulate_steps=accumulate)
    return spec, tx, TrainState.create(model, tx)


def test_snapshot_header_peek_clear_and_stale_refusal(tmp_path):
    _, _, state = _state()
    path = tmp_path / "snap.pt"
    ckpt.save_train_snapshot(path, state, 9, META)
    assert ckpt.peek_train_snapshot_meta(path) == META
    assert not (tmp_path / "snap.pt.tmp").exists()
    run = dict(task=1, phase="inc_step", num_classes=5, run_token="abc123")
    assert ckpt.snapshot_matches(META, **run)
    for other in (dict(task=2), dict(phase="cbf_step"), dict(num_classes=6),
                  dict(run_token="other")):  # a stale snapshot: another task, phase, run
        assert not ckpt.snapshot_matches(META, **dict(run, **other)), other
    legacy = {k: v for k, v in META.items() if k != "run_token"}
    assert ckpt.snapshot_matches(legacy, 1, "inc_step", 5, "abc123")
    assert not ckpt.snapshot_matches(None, 1, "inc_step", 5, "abc123")

    truncated = tmp_path / "truncated.pt"
    truncated.write_bytes(path.read_bytes()[:10])
    foreign = tmp_path / "foreign.pt"
    torch.save({"x": torch.zeros(2)}, foreign)
    for bad in (truncated, foreign, tmp_path / "missing.pt"):
        assert ckpt.peek_train_snapshot_meta(bad) is None
    ckpt.clear_train_snapshot(path)
    assert ckpt.peek_train_snapshot_meta(path) is None
    assert not path.with_suffix(".json").exists()


class FakeLoader:
    """3 batches an epoch, a pure function of (epoch, index)."""

    def __init__(self, nc=5):
        self.nc, self.epoch = nc, 0

    def __len__(self):
        return 3

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(1000 + self.epoch)
        for _ in range(3):
            yield {"imgs": rng.standard_normal((4, T, 32, 32, 3), dtype=np.float32),
                   "label": rng.integers(0, self.nc, size=(4, 1))}


def _run(state, spec, tx, num_epochs, start_epoch=0, snapshot_hook=None):
    kw = dict(spec=spec, tx=tx, num_classes=5)
    return train_epochs(make_train_step(**kw), state, None, FakeLoader(), num_epochs, 42,
                        device="cpu", start_epoch=start_epoch, snapshot_hook=snapshot_hook,
                        multi_step_fn=make_multi_train_step(kw, 2), steps_per_dispatch=2)[0]


def test_midtask_resume_is_bit_exact(tmp_path):
    _check_resume(tmp_path, accumulate=1)


def test_midtask_resume_inside_an_accumulation_window_is_bit_exact(tmp_path):
    """With 2 micro-steps an update and 3 batches an epoch, the snapshot after
    epoch 0 falls inside a window: its gradient sum must ride along."""
    _check_resume(tmp_path, accumulate=2)


def _check_resume(tmp_path, accumulate):
    spec, tx, state = _state(dropout=0.5, accumulate=accumulate)
    straight = _run(state, spec, tx, 3)

    spec2, tx2, state2 = _state(dropout=0.5, accumulate=accumulate)
    path = tmp_path / "mid_task_snapshot_inc_step.pt"

    def hook(epoch, st, seed):
        ckpt.save_train_snapshot(path, st, seed, dict(META, epoch=epoch))

    _run(state2, spec2, tx2, 1, snapshot_hook=hook)
    meta = ckpt.peek_train_snapshot_meta(path)
    assert meta["epoch"] == 0
    open_window = [p.grad for p in state2.module.parameters() if p.grad is not None]
    assert len(open_window) == (0 if accumulate == 1 else len(list(state2.module.parameters())))

    spec3, tx3, fresh = _state(seed=7, dropout=0.5, accumulate=accumulate)  # other weights:
    before = copy.deepcopy(fresh.module.state_dict())  # the load must set them all
    restored, seed, meta3 = ckpt.load_train_snapshot(path, fresh)
    assert seed == 42 and meta3 == meta and restored.step == 3
    assert not all(torch.equal(before[k], v) for k, v in restored.module.state_dict().items())
    for p, g in zip(restored.module.parameters(), state2.module.parameters()):
        assert (p.grad is None and g.grad is None) or torch.equal(p.grad, g.grad)
    resumed = _run(restored, spec3, tx3, 3, start_epoch=meta["epoch"] + 1)

    assert resumed.step == straight.step == 9
    got, want = resumed.module.state_dict(), straight.module.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert resumed.opt_state["count"] == straight.opt_state["count"] == 9 // accumulate
    for k, v in straight.opt_state["momentum"].items():
        assert torch.equal(resumed.opt_state["momentum"][k], v), k
    for p, q in zip(resumed.module.parameters(), straight.module.parameters()):
        assert (p.grad is None and q.grad is None) or torch.equal(p.grad, q.grad)


def test_dropout_makes_the_resume_test_sensitive_to_the_step_generators():
    """A resume that reused generator 0 for every step would differ: the
    loop's draws depend on the step."""
    spec, tx, state = _state(dropout=0.5)
    kw = dict(spec=spec, tx=tx, num_classes=5)
    batch = next(iter(FakeLoader()))
    losses = []
    for seed in (1, 2):
        model = copy.deepcopy(state.module)
        st = TrainState.create(model, tx)
        _, m = make_train_step(**kw)(st, None, to_torch(batch["imgs"]),
                                     torch.from_numpy(batch["label"]), {},
                                     torch.Generator().manual_seed(seed))
        losses.append(float(m["loss"]))
    assert losses[0] != losses[1]
