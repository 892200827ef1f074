"""The port's epoch loop (``bdvcil_torch/runtime/loops.py``) and its bench
entry point, on the CPU.

  * ``prefetch_to_device``: order, an error raised again in the consumer, and
    the thread ending when the consumer stops early;
  * ``train_epochs``' schedule against JAX's, with a recording step (K = 3,
    7 batches an epoch, epochs 1 and 2 of 3): which batches reach which call,
    single or chunk, the logged steps and metrics, the hook calls; with and
    without the loader's epoch-spanning stream; each step's generator is
    ``step_generator(seed, step)``;
  * a coupled real-model run of 4 steps (one K = 3 chunk and one single step)
    against JAX's ``train_epochs``: the losses JAX logs, then the classifier
    and layer4_0/conv1 within rtol 2e-3, atol 2e-4
    (tests/test_torch_port_train.py);
  * the staging of a K-chunk (pinning is the card's; here plain tensors);
  * ``python -m bdvcil_torch.bench_train --device cpu`` at a small size
    prints one parseable JSON line;
  * the program's spans (``utils/profiling.py``) of a tiny R18 run under
    ``torch.profiler``: one ``step.input_fn`` (with an input function),
    ``step.forward`` and ``step.backward`` a step, ``step.optimizer`` on
    update steps only, a ``model.bn`` a BatchNorm a forward, the loop's and
    the step's spans on the calling thread, nested as the layers are; no
    record without the profiler.
"""

import contextlib
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import init_model_params as jax_init
from bdvcil_tpu.optim import build_optimizer as jax_build_optimizer
from bdvcil_tpu.runtime import TrainState as JaxTrainState
from bdvcil_tpu.runtime import make_multi_train_step as jax_make_multi
from bdvcil_tpu.runtime import make_train_step as jax_make_train_step
from bdvcil_tpu.runtime.loops import train_epochs as jax_train_epochs
from bdvcil_torch import bench_train
from bdvcil_torch.data import device_pipeline as pdp
from bdvcil_torch.data.device_pipeline import HOST_KEYS
from bdvcil_torch.data.synthetic import SyntheticWireLoader, wire_batch
from bdvcil_torch.models import build_model, from_jax_variables, init_model_params
from bdvcil_torch.models.norm import BatchNorm
from bdvcil_torch.optim import build_optimizer
from bdvcil_torch.runtime import TrainState, make_multi_train_step, make_train_step
from bdvcil_torch.runtime import loops
from bdvcil_torch.utils import profiling
from tests.torch_port_helpers import T, model_cfg, numpy_tree

OPT = dict(type="SGD", constructor="CILTSMOptimizerConstructorImprovised",
           paramwise_cfg=dict(fc_lr_scale_factor=5.0), lr=0.004, momentum=0.9,
           weight_decay=1e-4)
TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The shapes are tiny: one intra-op thread is about as fast alone, and
    far faster when the suite's workers share the cores (idle intra-op
    threads spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class RecordLoader:
    """7 batches an epoch; batch i of epoch e carries label 100 e + i."""

    def __init__(self, n: int = 7):
        self.n, self.epoch = n, 0

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _batch(self, e, i):
        return {"imgs": np.full((2, 1), 100 * e + i, np.float32),
                "label": np.array([[100 * e + i], [0]], np.int64)}

    def __iter__(self):
        return (self._batch(self.epoch, i) for i in range(self.n))


class SpanLoader(RecordLoader):
    def iter_epochs(self, first, num):
        return (self._batch(e, i) for e in range(first, first + num) for i in range(self.n))


class Logger:
    def __init__(self):
        self.rows = []

    def log(self, payload, step):
        self.rows.append((step, {k: v for k, v in payload.items() if k != "clips_per_sec"}))


def _run_schedule(train_epochs, loader, to_list, make_loss, seed_arg):
    calls, hooks, log = [], [], Logger()

    def single(state, prev, imgs, labels, extra, key):
        calls.append(("single", to_list(labels), key))
        return state + 1, {"loss": make_loss(to_list(labels))}

    def multi(state, prev, imgs, labels, extra, keys):
        calls.append(("multi", to_list(labels), keys))
        return state + 3, {"loss": make_loss(to_list(labels))}

    state, last = train_epochs(
        single, 0, None, loader, 3, seed_arg, metric_logger=log, log_every_n_steps=2,
        epoch_hook=lambda e, s: hooks.append(("epoch", e, s)), start_epoch=1,
        snapshot_hook=lambda e, s, r: hooks.append(("snapshot", e, s)), multi_step_fn=multi,
        steps_per_dispatch=3)
    return state, last, calls, hooks, log.rows


@pytest.mark.parametrize("span", [True, False])
def test_schedule_matches_jax(span):
    make = SpanLoader if span else RecordLoader

    j_state, j_last, j_calls, j_hooks, j_log = _run_schedule(
        jax_train_epochs, make(), lambda a: np.asarray(a)[..., 0].tolist(),
        lambda lab: jnp.float32(np.sum(lab)), jax.random.PRNGKey(0))
    p_state, p_last, p_calls, p_hooks, p_log = _run_schedule(
        lambda *a, **k: loops.train_epochs(*a, device="cpu", **k), make(),
        lambda t: t[..., 0].tolist(), lambda lab: torch.tensor(float(np.sum(lab))), 11)

    assert [(kind, labels) for kind, labels, _ in p_calls] == \
        [(kind, labels) for kind, labels, _ in j_calls]
    # epochs 1 and 2, 7 batches each: a chunk of 3, a chunk of 3, 1 single
    assert [kind for kind, _, _ in p_calls] == ["multi", "multi", "single"] * 2
    assert [row[0] for row in p_calls[0][1]] == [100, 101, 102]
    assert p_state == j_state == 14
    assert p_hooks == j_hooks == [("epoch", 1, 7), ("snapshot", 1, 7), ("epoch", 2, 14),
                                  ("snapshot", 2, 14)]
    assert [s for s, _ in p_log] == [s for s, _ in j_log]
    for (_, got), (_, want) in zip(p_log, j_log):
        assert got == pytest.approx(want)
    assert p_last == pytest.approx(j_last)
    # step s (counted from epoch 0) draws from step_generator(11, s)
    step = 7
    for kind, _, gens in p_calls:
        gens = gens if kind == "multi" else [gens]
        for g in gens:
            assert g.initial_seed() == loops.step_generator(11, step, "cpu").initial_seed()
            step += 1


def test_step_generators_differ_by_step_and_repeat_by_seed():
    a = [torch.rand(4, generator=loops.step_generator(5, s, "cpu")) for s in range(3)]
    b = [torch.rand(4, generator=loops.step_generator(5, s, "cpu")) for s in range(3)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], torch.rand(4, generator=loops.step_generator(6, 0, "cpu")))


def test_prefetch_keeps_order_and_reraises():
    got = list(loops.prefetch_to_device(range(30), size=2, put_fn=lambda x: x * 2))
    assert got == [2 * x for x in range(30)]

    def source():
        for i in range(10):
            if i == 4:
                raise OSError("decode failed for a.jpg")
            yield i

    seen = []
    with pytest.raises(OSError, match="a.jpg"):
        for x in loops.prefetch_to_device(source()):
            seen.append(x)
    assert seen == [0, 1, 2, 3]


def test_prefetch_thread_ends_on_early_break():
    closed = threading.Event()

    def source():
        try:
            for i in range(10_000):
                yield i
        finally:
            closed.set()

    def alive():
        return [t for t in threading.enumerate() if t.name == "bdvc-device-prefetch"]

    before = set(alive())
    it = loops.prefetch_to_device(source(), size=2)
    for x in it:
        if x == 3:
            break
    it.close()
    deadline = time.time() + 10
    while time.time() < deadline and set(alive()) - before:
        time.sleep(0.02)
    assert not set(alive()) - before
    assert closed.wait(5)


def test_stage_batches_stacks_a_chunk_and_refuses_mixed_shapes():
    batches = [{"imgs_y": np.full((2, 3), i, np.uint8), "apply_randaug": np.array([True, i > 0]),
                "label": np.array([[i], [i]])} for i in range(3)]
    tree = loops.stage_batches(batches, pin=False, stack=True)
    assert tree["imgs_y"].shape == (3, 2, 3) and tree["label"][:, 0, 0].tolist() == [0, 1, 2]
    dev, event = loops.copy_to_device(tree, torch.device("cpu"), None)
    assert event is None and "apply_randaug" in HOST_KEYS
    imgs, labels, extra = loops.split_batch(loops.wait_copied(dev, event, torch.device("cpu")))
    assert set(imgs) == {"imgs_y", "apply_randaug"} and extra == {}
    batches[1]["imgs_y"] = np.zeros((1, 3), np.uint8)
    with pytest.raises(ValueError, match="uniform batches"):
        loops.stage_batches(batches, pin=False, stack=True)


class TensorLoader:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return ({"imgs": self.x[i], "label": self.y[i]} for i in range(len(self.x)))


def test_coupled_train_epochs_matches_jax():
    """One epoch of 4 batches, K = 3: a 3-step chunk and a single step."""
    nc, batch, hw = 4, 4, 32
    cfg = model_cfg(18, "pad", "xla", nc, in_channels=512)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, batch, T, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, nc, size=(4, batch, 1))

    jspec = jax_build_model(cfg)
    jvars = numpy_tree(jax_init(jspec, jax.random.PRNGKey(0), (1, T, hw, hw, 3)))
    jtx = jax_build_optimizer(jvars["params"], OPT)
    kw = dict(spec=jspec, tx=jtx, num_classes=nc, donate=False)
    jlog = Logger()
    jstate, jlast = jax_train_epochs(
        jax_make_train_step(**kw), JaxTrainState.create(jax.tree.map(jnp.asarray, jvars), jtx),
        None, TensorLoader(x, y), 1, jax.random.PRNGKey(1), metric_logger=jlog,
        log_every_n_steps=1, multi_step_fn=jax_make_multi(kw, 3), steps_per_dispatch=3)

    spec = build_model(cfg, device="cpu")
    model = spec.module()
    model.load_state_dict(from_jax_variables(jvars), strict=True)
    tx = build_optimizer(model, OPT)
    pkw = dict(spec=spec, tx=tx, num_classes=nc)
    plog = Logger()
    state, last = loops.train_epochs(
        make_train_step(**pkw), TrainState.create(model, tx), None, TensorLoader(x, y), 1, 1,
        device="cpu", metric_logger=plog, log_every_n_steps=1,
        multi_step_fn=make_multi_train_step(pkw, 3), steps_per_dispatch=3)

    assert state.step == int(jstate.step) == 4
    assert [s for s, _ in plog.rows] == [s for s, _ in jlog.rows] == [4]
    for (_, got), (_, want) in zip(plog.rows, jlog.rows):
        np.testing.assert_allclose([got[k] for k in sorted(want)],
                                   [want[k] for k in sorted(want)], **TOL)
    np.testing.assert_allclose(last["loss"], jlast["loss"], **TOL)
    head = jstate.params["head"]
    for name in ("fc_weights", "eta"):
        np.testing.assert_allclose(getattr(model.cls_head, name).detach().numpy(),
                                   np.asarray(head[name]), **TOL, err_msg=name)
    ref_k = np.transpose(np.asarray(jstate.params["backbone"]["layer4_0"]["conv1"]["kernel"]),
                         (3, 2, 0, 1))
    np.testing.assert_allclose(model.backbone.layer4[0].conv1.weight.detach().numpy(), ref_k,
                               **TOL)


@pytest.mark.parametrize("wire,accumulate,traced", [(True, 2, True), (False, 1, True),
                                                     (True, 2, False)])
def test_train_epochs_spans(wire, accumulate, traced):
    """Four steps of R18 at 32², two clips a batch: from wire batches through
    the input function with two-step accumulation, or from float clips."""
    nc, steps = 10, 4
    spec = build_model(model_cfg(18, "pad", "xla", nc, in_channels=512), device="cpu")
    model = init_model_params(spec, 0)
    tx = build_optimizer(model, OPT, accumulate_steps=accumulate)
    if wire:
        loader = SyntheticWireLoader(2 * steps, 2, T, 32, seed=5)
        input_fn = pdp.make_fast_input_fn(wire_format=loader.wire_format)
    else:
        rng = np.random.default_rng(5)
        loader = TensorLoader(rng.standard_normal((steps, 2, T, 32, 32, 3)).astype(np.float32),
                              rng.integers(0, nc, size=(steps, 2, 1)))
        input_fn = None
    step_fn = make_train_step(spec=spec, tx=tx, num_classes=nc, input_fn=input_fn)
    book = profiling.BOOK
    n0 = len(book.records)
    with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
        _, last = loops.train_epochs(step_fn, TrainState.create(model, tx), None, loader, 1, 3,
                                     device="cpu", log_every_n_steps=2)
    assert np.isfinite(last["loss"])
    records = profiling.spans()
    if not traced:
        assert records == [] and len(book.records) == n0
        return

    by_id = {r.id: r for r in records}
    assert len(by_id) == len(records)
    assert {r.thread for r in records} == {threading.get_ident()}
    assert {r.run for r in records} == {book.run}
    bns = sum(isinstance(m, BatchNorm) for m in model.modules())
    blocks = sum(len(getattr(model.backbone, f"layer{i}")) for i in range(1, 5))
    stages = len({tuple(n.split(".")[:2]) for n, _ in model.named_parameters()})

    def names(step, prefix):
        return sorted(r.name for r in records if r.step == step and r.name.startswith(prefix))

    for s in range(steps):
        update = (s + 1) % accumulate == 0
        want = ["step.backward", "step.forward", "step.loss"] + ["step.input_fn"] * wire
        assert names(s, "step.") == sorted(want + ["step.optimizer"] * update), s
        assert names(s, "optim.") == ["optim.update"] * stages * update, s
        assert names(s, "model.") == sorted(["model.block"] * blocks + ["model.bn"] * bns
                                            + ["model.stage"] * 4 + ["model.head"]), s
        # after step s: the next item's fetch and feed; after the last, the
        # readback of step 1's metrics (one interval late) and the final one
        loop = ["loop.fetch"] + ["loop.feed"] * (s < steps - 1) + ["loop.log"] * 2 * (s == 3)
        assert names(s, "loop.") == sorted(loop), s
    assert names(None, "") == ["loop.feed", "loop.fetch"]

    parents = {"step.loss": {"step.forward"}, "model.head": {"step.forward"},
               "model.stage": {"step.forward"}, "model.block": {"model.stage"},
               "model.bn": {"model.block", "step.forward"}, "optim.update": {"step.optimizer"}}
    for r in records:
        parent = by_id.get(r.parent)
        if r.name in parents:
            assert parent.name in parents[r.name], r
            assert parent.start <= r.start <= r.end <= parent.end, r
        else:
            assert r.name.startswith(("loop.", "step.")) and parent is None, r
        assert (r.cpu_s is None) == (parent is not None), r


@pytest.mark.parametrize("source", ["jpeg", "synthetic"])
def test_bench_train_on_the_cpu_prints_one_json_line(tmp_path, capsys, source):
    rc = bench_train.main([
        "--device", "cpu", "--config", "default", "--depth", "18", "--size", "32",
        "--segments", "2", "--batch", "2", "--videos", "4", "--frames", "4", "--k", "2",
        "--steps", "2", "--windows", "2", "--warmup", "1", "--device-calls", "1",
        "--corpus", str(tmp_path / "corpus"), "--source", source])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == bench_train.METRIC and out["unit"] == "clips/s"
    assert out["source"] == source and out["wire_format"] == "yuv420" and out["device"] == "cpu"
    assert len(out["window_rates"]) == len(out["window_producer_wait_s"]) == 2
    assert out["value"] > 0 and out["device_clips_per_sec"] > 0 and out["host_cpus"] >= 1
    assert (out["host_decode_frames_per_sec"] > 0) if source == "jpeg" else (
        out["host_decode_frames_per_sec"] is None and not (tmp_path / "corpus").exists())
    assert out["k"] == 2 and out["card"] is None


def test_synthetic_loader_is_a_pure_function_of_seed_epoch_and_index():
    loader = SyntheticWireLoader(6, 2, num_segments=2, crop_size=16, seed=4)
    spanned = list(loader.iter_epochs(0, 2))
    per_epoch = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        per_epoch.extend(loader)
    assert len(loader) == 3 and len(spanned) == len(per_epoch) == 6
    for a, b in zip(spanned, per_epoch):
        assert set(a) == set(wire_batch("yuv420", 2, 2, 16)) == set(b)
        assert all(np.array_equal(a[k], b[k]) for k in a)
    again = list(SyntheticWireLoader(6, 2, num_segments=2, crop_size=16, seed=4).iter_epochs(0, 2))
    assert all(np.array_equal(a[k], b[k]) for a, b in zip(spanned, again) for k in a)
    assert not np.array_equal(spanned[0]["randaug_op_indices"], spanned[4]["randaug_op_indices"])


def test_bench_train_refuses_the_jpeg_source_without_the_decoder(monkeypatch, tmp_path):
    from bdvcil_torch.data import native

    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(native, "_error", "jpeglib.h: No such file or directory")
    with pytest.raises(RuntimeError, match="--source synthetic"):
        bench_train.main(["--device", "cpu", "--corpus", str(tmp_path)])
