"""The port's producer profiling, its ``BDVC_PLANES_MAX_PX`` override and its
wandb mirror against the JAX package's, and the tests' access to the JAX
decoder, on the CPU.

  * ``jax_native`` (``tests/torch_port_helpers.py``) recovers a JAX decoder
    module whose failed load stuck (an empty library, as a worker that
    loses the JAX build's race sees it), and fails with the reason when a
    second try fails too;
  * with ``BDVC_PROFILE_PRODUCER=1`` both ``FastBGMixLoader``s record the same
    phases and batch count; off (unset or "0"), neither records; the batches
    are equal at uint8 either way;
  * ``BDVC_PLANES_MAX_PX`` below the corpus's frames gives both fast train
    loaders JAX's pads and 'planes' batches;
  * ``MetricLogger`` makes JAX's wandb calls on a stub module, none without
    ``WANDB_API_KEY``; both CIL trainers pass ``use_wandb``.
"""

import copy
import ctypes
import sys
import types

import jax
import numpy as np
import pytest
import torch

from bdvcil_tpu.cil.trainer import CILTrainer as JaxTrainer
from bdvcil_tpu.config import Config as JaxConfig
from bdvcil_tpu.data import device_pipeline as jdp
from bdvcil_tpu.parallel.mesh import make_mesh
from bdvcil_tpu.utils.logging import MetricLogger as JaxMetricLogger
from bdvcil_torch.cil import trainer as port_trainer
from bdvcil_torch.config import Config as PortConfig
from bdvcil_torch.data import corpus, loaders, native
from bdvcil_torch.utils.logging import MetricLogger
from tests.synthetic import make_rawframe_tree
from tests.test_cil_e2e import make_cil_config
from tests.torch_port_helpers import assert_batch_matches_jax, jax_native

CROP = 56
SIZE = (100, 76)  # (w, h) of the corpus's frames: 7,600 pixels
COMMON = dict(batch_size=4, num_segments=4, crop_size=CROP, seed=3, process_index=0,
              process_count=1)
PHASES = {"pass1", "probe", "pass2", "decode"}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    if not native.available():
        pytest.fail(f"the port's native decoder did not build: {native.build_error()}")
    jax_native()  # the JAX loaders decode with it
    infos, bg_files = corpus.write_corpus(tmp_path_factory.mktemp("corpus"), 6,
                                          frames_per_video=8, seed=4, num_classes=3, size=SIZE)
    rng = np.random.default_rng(1)
    w, h = SIZE
    for info in infos:  # ActorCutMix detections, 1-based frame keys
        info["all_detections"] = {
            fi: [[float(rng.uniform(0, w / 2)), float(rng.uniform(0, h / 2)),
                  float(rng.uniform(w / 2, w)), float(rng.uniform(h / 2, h)),
                  float(rng.uniform(0.5, 1.0))]]
            for fi in range(1, 9)}
    return infos, bg_files


@pytest.fixture
def producer_stats():
    """Both packages' phase sums, empty before and after the test."""
    stats = (loaders.PRODUCER_STATS, jdp.PRODUCER_STATS)
    for s in stats:
        s.clear()
    yield stats
    for s in stats:
        s.clear()


# -- the JAX decoder for the tests ------------------------------------------------------


@pytest.fixture
def restored_jax_native(monkeypatch):
    """The loaded JAX decoder module, whose load state the test may change:
    put back as it was after the test."""
    jn = jax_native()
    for name in ("_lib", "_build_failed", "_LIB_PATH"):
        monkeypatch.setattr(jn, name, getattr(jn, name))
    return jn


def test_jax_native_recovers_a_sticky_load_failure(restored_jax_native, tmp_path, env):
    jn = restored_jax_native
    real = jn._LIB_PATH
    half = tmp_path / "libbdvcdec.so"  # what a process sees once another one's make opened it
    half.write_bytes(b"")
    jn._lib, jn._LIB_PATH = None, half
    assert not jn.available() and jn._build_failed
    assert not jn.available()  # the failure sticks for the process's life

    got = jax_native()
    assert got is jn and got.available() and not got._build_failed and got._LIB_PATH == real
    frame = f"{env[0][0]['frame_dir']}/img_00001.jpg"
    np.testing.assert_array_equal(got.decode_file(frame), native.decode_file(frame))


def test_jax_native_fails_with_the_reason_when_the_second_try_fails(restored_jax_native,
                                                                    monkeypatch):
    def refuse(*args, **kwargs):
        raise OSError("simulated: invalid ELF header")

    restored_jax_native._lib = None
    monkeypatch.setattr(ctypes, "CDLL", refuse)
    with pytest.raises(pytest.fail.Exception, match="second try.*simulated: invalid ELF"):
        jax_native()


# -- the producer's phase timing --------------------------------------------------------


@pytest.mark.parametrize("wire", ["rgb", "yuv420", "planes"])
def test_producer_phases_match_jax(env, producer_stats, monkeypatch, wire):
    infos, bg_files = env
    kw = dict(COMMON, wire_format=wire, randaug_prob=0.5)
    port_stats, jax_stats = producer_stats
    first = None
    for switch in ("1", "0", None):
        if switch is None:
            monkeypatch.delenv("BDVC_PROFILE_PRODUCER", raising=False)
        else:
            monkeypatch.setenv("BDVC_PROFILE_PRODUCER", switch)
        port = loaders.FastBGMixLoader(infos, bg_files, num_workers=2, **kw)
        got = list(port.iter_epochs(0, 2))
        ref = jdp.FastBGMixLoader(infos, bg_files, **kw)
        want = []
        for epoch in (0, 1):
            ref.set_epoch(epoch)
            want.extend(ref)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert_batch_matches_jax(g, w, CROP)
        if switch == "1":
            assert set(port_stats) == set(jax_stats) == PHASES | {"batches"}
            assert port_stats["batches"] == jax_stats["batches"] == 2.0
            assert all(port_stats[k] >= 0 for k in PHASES)
            port_stats.clear()
            jax_stats.clear()
        else:
            assert port_stats == jax_stats == {}
        first = first or got
        for g, f in zip(got, first):  # the timing changes no byte of a batch
            for key in f:
                np.testing.assert_array_equal(g[key], f[key], err_msg=key)


def test_the_other_loaders_record_no_phases(env, producer_stats, monkeypatch):
    """As in JAX, only FastBGMixLoader's batches are timed."""
    infos, _ = env
    monkeypatch.setenv("BDVC_PROFILE_PRODUCER", "1")
    next(iter(loaders.FastACMLoader(infos, wire_format="yuv420", **COMMON)))
    next(iter(loaders.FastEvalLoader(infos, batch_size=2, num_segments=4, crop_size=CROP,
                                     process_index=0, process_count=1)))
    assert producer_stats[0] == {}


# -- BDVC_PLANES_MAX_PX ---------------------------------------------------------------


@pytest.mark.parametrize("family", ["bgmix", "acm"])
def test_planes_max_px_gives_jax_pads_and_batches(env, monkeypatch, family):
    infos, bg_files = env
    kw = dict(COMMON, wire_format="planes")

    def make(pkg):
        if family == "acm":
            return pkg.FastACMLoader(infos, acm_prob=0.5, **kw)
        return pkg.FastBGMixLoader(infos, bg_files, randaug_prob=0.5, **kw)

    monkeypatch.delenv("BDVC_PLANES_MAX_PX", raising=False)
    default = make(loaders)
    assert default.planes_max_px == loaders.PLANES_MAX_PX == 512 * 512
    first = next(iter(default))
    monkeypatch.setenv("BDVC_PLANES_MAX_PX", str(SIZE[0] * SIZE[1] - 1))  # every frame over
    port, ref = make(loaders), make(jdp)
    assert port.planes_max_px == ref.planes_max_px == SIZE[0] * SIZE[1] - 1
    got, want = next(iter(port)), next(iter(ref))
    assert (port._pad_w, port._pad_h) == (ref._pad_w, ref._pad_h) == (64, 64)  # the crop in 16s
    assert (default._pad_w, default._pad_h) == (112, 80)  # the override bites
    assert got["imgs_y"].shape != first["imgs_y"].shape
    assert_batch_matches_jax(got, want, CROP)


# -- the wandb mirror ---------------------------------------------------------------------


def wandb_stub(calls, fail=False):
    """A ``wandb`` module that records its calls in ``calls``."""

    class Run:
        def log(self, metrics, step=None):
            calls.append(("log", dict(metrics), step))

        def finish(self):
            calls.append(("finish",))

    def init(**kwargs):
        calls.append(("init", kwargs))
        if fail:
            raise RuntimeError("simulated: no network")
        return Run()

    return types.SimpleNamespace(init=init)


@pytest.mark.parametrize("api_key,use_wandb,fail", [("key", True, False), (None, True, False),
                                                    ("key", False, False), ("key", True, True)])
def test_wandb_mirror_makes_jax_calls(tmp_path, monkeypatch, api_key, use_wandb, fail):
    if api_key is None:
        monkeypatch.delenv("WANDB_API_KEY", raising=False)
    else:
        monkeypatch.setenv("WANDB_API_KEY", api_key)
    calls, files = {}, {}
    for name, cls in (("port", MetricLogger), ("jax", JaxMetricLogger)):
        calls[name] = []
        monkeypatch.setitem(sys.modules, "wandb", wandb_stub(calls[name], fail))
        work_dir = tmp_path / "wd"
        (work_dir / "metrics.jsonl").unlink(missing_ok=True)
        ml = cls(str(work_dir), use_wandb=use_wandb)
        ml.log({"loss": 1.5}, step=3)
        ml.log({"acc": 2.0})
        ml.close()
        files[name] = [line.split('"time"')[0] for line in
                       (work_dir / "metrics.jsonl").read_text().splitlines()]
    assert calls["port"] == calls["jax"]
    assert files["port"] == files["jax"] and len(files["port"]) == 2
    init = ("init", {"project": "CILVideo", "dir": str(tmp_path / "wd")})
    if api_key and use_wandb and not fail:
        assert calls["port"] == [init, ("log", {"loss": 1.5}, 3), ("log", {"acc": 2.0}, 4),
                                 ("finish",)]
    else:
        assert calls["port"] == ([init] if fail else [])


def test_both_trainers_start_the_mirror_from_use_wandb(tmp_path, monkeypatch):
    frames, train_ann, val_ann = make_rawframe_tree(tmp_path / "data", num_classes=4,
                                                    videos_per_class=2, num_frames=8,
                                                    size=(64, 80))
    cfg = make_cil_config(tmp_path, frames, train_ann, val_ann, tmp_path / "jax_wd",
                          use_wandb=True).to_dict()
    monkeypatch.setenv("WANDB_API_KEY", "key")
    calls = {"jax": [], "port": []}
    monkeypatch.setitem(sys.modules, "wandb", wandb_stub(calls["jax"]))
    JaxTrainer(JaxConfig.fromdict(copy.deepcopy(cfg)), mesh=make_mesh(jax.devices()[:1]))
    monkeypatch.setitem(sys.modules, "wandb", wandb_stub(calls["port"]))
    cfg["work_dir"] = str(tmp_path / "port_wd")
    ptr = port_trainer.CILTrainer(PortConfig.fromdict(cfg), device="cpu")
    assert calls["jax"] == [("init", {"project": "CILVideo", "dir": str(tmp_path / "jax_wd")})]
    assert calls["port"] == [("init", {"project": "CILVideo",
                                       "dir": str(tmp_path / "port_wd")})]
    ptr.metric_logger.close()
    assert calls["port"][-1] == ("finish",)
