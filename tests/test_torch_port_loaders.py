"""The host half of the port's input path against the JAX package's, on the CPU.

A tiny corpus is written in the test by the port's corpus writer (7 videos of
8 frames at 100 x 76, crop 56, short side 64) and read by both packages'
loaders, the JAX side through its own built decoder (``native/``), the port
through the one it builds (``bdvcil_torch/_build/``).

  * ``SampleFrames`` over a grid of ``total_frames``, train and test mode;
  * every planner over seeded generators, bit for bit;
  * ``FastBGMixLoader`` (rgb, yuv420, planes) and ``FastACMLoader`` (rgb,
    yuv420): every key of the JAX batch equal bit for bit, ``randaug_key``
    replaced by the draws the port derives from it; for 1 and 3 workers,
    through ``iter_epochs`` and epoch by epoch; the padded tail's
    ``sample_weight``; an empty background list;
  * the native binding's outputs against JAX's binding;
  * ``_parallel_ordered_iter``: order, error re-raise, early stop;
  * the corpus's backgrounds against ``bg_extraction_tmf`` of its frames.
"""

import threading
import time

import numpy as np
import pytest
import torch

from bdvcil_tpu.data import device_pipeline as jdp
from bdvcil_tpu.data.datasets import bg_extraction_tmf
from bdvcil_tpu.data.sampling import SampleFrames as JaxSampleFrames
from bdvcil_torch.data import corpus, loaders, native
from bdvcil_torch.data.sampling import SampleFrames
from bdvcil_torch.ops.rand_augment_dev import DRAW_KEYS, draw_randaug
from tests.torch_port_helpers import assert_batch_matches_jax, jax_native

CROP, SHORT, SEG = 56, 64, 4
SIZE = (100, 76)  # (w, h) of the corpus's frames
COMMON = dict(batch_size=4, num_segments=SEG, crop_size=CROP, short_side=SHORT, seed=3,
              process_index=0, process_count=1)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The shapes are tiny: one intra-op thread is about as fast alone, and
    far faster when the suite's workers share the cores (idle intra-op
    threads spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    if not native.available():
        pytest.fail(f"the port's native decoder did not build: {native.build_error()}")
    jax_native()  # the JAX loaders decode with it
    root = tmp_path_factory.mktemp("corpus")
    infos, bg_files = corpus.write_corpus(root, 7, frames_per_video=8, seed=1, num_classes=3,
                                          size=SIZE)
    rng = np.random.default_rng(0)
    w, h = SIZE
    for v, info in enumerate(infos):  # ActorCutMix detections, 1-based frame keys
        info["all_detections"] = {
            fi: [[float(rng.uniform(0, w / 2)), float(rng.uniform(0, h / 2)),
                  float(rng.uniform(w / 2, w)), float(rng.uniform(h / 2, h)),
                  float(rng.uniform(0.3 if v == 3 else 0.5, 1.0))]
                 for _ in range(int(rng.integers(1, 3)))]
            for fi in range(1, 9)}
    return infos, bg_files


# -- SampleFrames and the planners ------------------------------------------------


@pytest.mark.parametrize("test_mode,twice", [(False, False), (True, False), (True, True)])
def test_sample_frames_matches_jax(test_mode, twice):
    for total in (1, 3, 4, 7, 8, 9, 16, 33, 120):
        for clip_len, interval, clips in ((1, 1, 8), (2, 2, 3), (1, 1, 1)):
            kw = dict(clip_len=clip_len, frame_interval=interval, num_clips=clips,
                      test_mode=test_mode, twice_sample=twice)
            got = SampleFrames(**kw).sample(total, np.random.default_rng(total))
            want = JaxSampleFrames(**kw).sample(total, np.random.default_rng(total))
            np.testing.assert_array_equal(got, want, err_msg=str((total, kw)))
            assert got.dtype == want.dtype


def test_sample_frames_jitter_and_repeat_last_match_jax():
    for total in (5, 12, 40):
        kw = dict(clip_len=3, frame_interval=2, num_clips=4, temporal_jitter=True,
                  out_of_bound_opt="repeat_last")
        np.testing.assert_array_equal(
            SampleFrames(**kw).sample(total, np.random.default_rng(total)),
            JaxSampleFrames(**kw).sample(total, np.random.default_rng(total)))


DIMS = [(320, 240), (340, 256), (100, 76), (240, 320), (57, 57), (1280, 720)]


@pytest.mark.parametrize("planner", ["resized_dims", "plan_train_geometry", "plan_bg_crop",
                                     "transform_acm_boxes", "rasterized_union_area",
                                     "pads_from_dims"])
def test_planner_matches_jax(planner):
    for seed, (w, h) in enumerate(DIMS):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        if planner == "resized_dims":
            for short in (64, 256, 331):
                assert loaders.resized_dims(w, h, short) == jdp.resized_dims(w, h, short)
        elif planner == "plan_train_geometry":
            for crop, short in ((224, 256), (56, 64), (112, 128)):
                for _ in range(20):
                    assert (loaders.plan_train_geometry(r1, w, h, crop, short)
                            == jdp.plan_train_geometry(r2, w, h, crop, short))
        elif planner == "plan_bg_crop":
            for _ in range(20):
                assert (loaders.plan_bg_crop(r1, w, h, 256, 224)
                        == jdp.plan_bg_crop(r2, w, h, 256, 224))
        elif planner == "transform_acm_boxes":
            dets = r1.uniform(0, min(w, h), size=(5, 4)).astype(np.float32)
            for flip in (False, True):
                got = loaders.transform_acm_boxes(dets, w, h, 256, 224, flip)
                want = jdp.transform_acm_boxes(dets, w, h, 256, 224, flip)
                np.testing.assert_array_equal(got, want)
        elif planner == "rasterized_union_area":
            boxes = r1.uniform(0, 60, size=(4, 4)).astype(np.float32)
            boxes[:, 2:] += boxes[:, :2]
            assert (loaders._rasterized_union_area(boxes, 64, 64)
                    == jdp._rasterized_union_area(boxes, 64, 64))
        else:
            dims = r1.integers(40, 700, size=(9, 2))
            for max_px in (512 * 512, 60 * 60):
                assert (loaders._pads_from_dims(dims, 56, max_px)
                        == jdp._pads_from_dims(dims, 56, max_px))


def test_resolve_wire_format_matches_jax():
    for fmt in ("auto", "rgb", "yuv420", "planes"):
        for crop in (56, 224):
            assert loaders.resolve_wire_format(fmt, crop) == jdp.resolve_wire_format(fmt, crop)
    for fmt, crop in (("yuv420", 57), ("planes", 57), ("bgr", 56)):
        with pytest.raises(ValueError):
            loaders.resolve_wire_format(fmt, crop)


def test_randaug_draws_are_per_clip_functions_of_the_key():
    keys = np.random.default_rng(0).integers(0, 2**32, size=(5, 2), dtype=np.uint32)
    draws = loaders.randaug_draws_from_keys(keys, 2, 56, 48)
    for i, (k0, k1) in enumerate(keys):
        one = draw_randaug(torch.Generator().manual_seed((int(k0) << 32) | int(k1)), 1, 2, 56, 48)
        for key in DRAW_KEYS:
            np.testing.assert_array_equal(draws[key][i], one[key][0].numpy(), err_msg=key)
        alone = loaders.randaug_draws_from_keys(keys[i:i + 1], 2, 56, 48)
        assert all(np.array_equal(alone[k][0], draws[k][i]) for k in DRAW_KEYS)
    assert draws["randaug_op_indices"].shape == (5, 2)
    assert (draws["randaug_x0"] < 48).all() and (draws["randaug_y0"] < 56).all()


# -- the loaders against JAX's ------------------------------------------------------


@pytest.mark.parametrize("wire", ["rgb", "yuv420", "planes"])
def test_bgmix_loader_matches_jax(env, wire):
    infos, bg_files = env
    kw = dict(COMMON, wire_format=wire, randaug_prob=0.5, flip_ratio=0.5)
    port = loaders.FastBGMixLoader(infos, bg_files, **kw)
    ref = jdp.FastBGMixLoader(infos, bg_files, **kw)
    assert port.wire_format == ref.wire_format == wire and len(port) == len(ref) == 1
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 1
        assert_batch_matches_jax(got[0], want[0], CROP)


@pytest.mark.parametrize("wire", ["rgb", "yuv420"])
def test_acm_loader_matches_jax(env, wire):
    infos, _ = env
    kw = dict(COMMON, wire_format=wire, acm_prob=0.5)
    port, ref = loaders.FastACMLoader(infos, **kw), jdp.FastACMLoader(infos, **kw)
    assert port.max_boxes == ref.max_boxes
    acm = []
    for epoch in (0, 1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for got, want in zip(list(port), list(ref)):
            assert_batch_matches_jax(got, want, CROP)
            acm.extend(want["apply_acm"])
    assert any(acm) and not all(acm)  # both kinds of row were compared


@pytest.mark.parametrize("family", ["bgmix", "acm"])
def test_worker_counts_and_iter_epochs_match_jax(env, family):
    """Port with 3 workers through one 3-epoch stream == JAX with 1 worker,
    epoch by epoch (padded tail included)."""
    infos, bg_files = env
    kw = dict(COMMON, wire_format="yuv420", drop_last=False, pad_to_batch=True)

    def make(pkg, workers):
        if family == "acm":
            return pkg.FastACMLoader(infos, num_workers=workers, acm_prob=0.5, **kw)
        return pkg.FastBGMixLoader(infos, bg_files, num_workers=workers, randaug_prob=0.5, **kw)

    ref = make(jdp, 1)
    want = []
    for epoch in range(3):
        ref.set_epoch(epoch)
        want.extend(ref)
    for workers in (1, 3):
        got = list(make(loaders, workers).iter_epochs(0, 3))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert_batch_matches_jax(g, w, CROP)


def test_padded_tail_sample_weight(env):
    infos, bg_files = env
    kw = dict(COMMON, wire_format="rgb", drop_last=False, pad_to_batch=True, shuffle=False)
    port = list(loaders.FastBGMixLoader(infos, bg_files, **kw))
    ref = list(jdp.FastBGMixLoader(infos, bg_files, **kw))
    assert len(port) == 2
    np.testing.assert_array_equal(port[0]["sample_weight"], np.ones(4, np.float32))
    np.testing.assert_array_equal(port[1]["sample_weight"], np.array([1, 1, 1, 0], np.float32))
    for g, w in zip(port, ref):
        assert_batch_matches_jax(g, w, CROP)


def test_process_slicing_matches_jax(env):
    infos, bg_files = env
    kw = dict(COMMON, wire_format="yuv420", drop_last=False, process_count=2)
    for rank in (0, 1):
        kw["process_index"] = rank
        port = list(loaders.FastBGMixLoader(infos, bg_files, **kw))
        ref = list(jdp.FastBGMixLoader(infos, bg_files, **kw))
        assert [len(b["label"]) for b in port] == [2, 2]
        for g, w in zip(port, ref):
            assert_batch_matches_jax(g, w, CROP)


def test_empty_background_list(env):
    infos, _ = env
    kw = dict(COMMON, wire_format="yuv420", randaug_prob=0.5)
    got = next(iter(loaders.FastBGMixLoader(infos, [], **kw)))
    want = next(iter(jdp.FastBGMixLoader(infos, [], **kw)))
    assert not any(k.startswith("bg_") for k in got) and not got["apply_bgmix"].any()
    assert_batch_matches_jax(got, want, CROP)


def test_loaders_raise_without_the_decoder(env, monkeypatch):
    infos, bg_files = env
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(native, "_error", "jpeglib.h: No such file or directory")
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        loaders.FastBGMixLoader(infos, bg_files, **COMMON)
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        loaders.FastACMLoader(infos, **COMMON)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.probe_dims_batch([infos[0]["frame_dir"]])


# -- the native binding and the corpus ------------------------------------------------


def test_native_binding_matches_jax(env):
    infos, bg_files = env
    jnative = jax_native()
    paths = [f"{info['frame_dir']}/img_{t:05}.jpg" for info in infos[:3] for t in (1, 4, 8)]
    n = len(paths)
    rng = np.random.default_rng(0)
    dims = np.stack([rng.integers(58, 130, n), rng.integers(58, 100, n)], 1).astype(np.int32)
    crops = [(int(rng.integers(0, w - 56)), int(rng.integers(0, h - 56))) for w, h in dims]
    np.testing.assert_array_equal(native.probe_dims_batch(paths), jnative.probe_dims_batch(paths))
    np.testing.assert_array_equal(native.decode_file(paths[0]), jnative.decode_file(paths[0]))
    np.testing.assert_array_equal(
        native.decode_resize_crop_batch(paths, 64, 56, 56, num_threads=2),
        jnative.decode_resize_crop_batch(paths, 64, 56, 56, num_threads=2))
    np.testing.assert_array_equal(
        native.decode_resize2_crop_batch(paths, dims, 56, 56, crops, num_threads=3),
        jnative.decode_resize2_crop_batch(paths, dims, 56, 56, crops, num_threads=3))
    for got, want in zip(native.decode_yuv420_batch(paths, dims, 56, crops),
                         jnative.decode_yuv420_batch(paths, dims, 56, crops)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(native.fetch_planes_batch(paths + bg_files[:1], 112, 80),
                         jnative.fetch_planes_batch(paths + bg_files[:1], 112, 80)):
        np.testing.assert_array_equal(got, want)
    stats = native.decode_cache_stats()
    assert set(stats) == {"hits", "misses", "bytes", "entries"}
    with pytest.raises(IOError):
        native.probe_dims_batch(paths[:1] + ["/nonexistent.jpg"])


def test_corpus_backgrounds_are_the_temporal_median(env):
    infos, bg_files = env
    assert [i["label"] for i in infos] == [v % 3 for v in range(7)]
    for info, bg in zip(infos[:2], bg_files[:2]):
        frames = np.stack([native.decode_file(f"{info['frame_dir']}/img_{t:05}.jpg")
                           for t in range(1, 9)])
        want = bg_extraction_tmf(info["frame_dir"])[..., ::-1]  # cv2 decodes BGR
        np.testing.assert_array_equal(corpus.median_background(frames), want)
        assert native.probe_dims_batch([bg])[0].tolist() == list(SIZE)
    odd = np.random.default_rng(0).integers(0, 256, (3, 4, 5, 3), dtype=np.uint8)
    np.testing.assert_array_equal(corpus.median_background(odd),
                                  np.median(odd, axis=0).astype(np.uint8))


# -- _parallel_ordered_iter ---------------------------------------------------------


def test_parallel_ordered_iter_keeps_order():
    rng = np.random.default_rng(0)
    delays = rng.uniform(0, 0.01, 30)

    def make(i, scale):
        time.sleep(delays[i])
        return i * scale

    got = list(loaders._parallel_ordered_iter([(i, 10) for i in range(30)], make, 4, 2))
    assert got == [i * 10 for i in range(30)]


def test_parallel_ordered_iter_reraises_and_stops_early():
    def make(i):
        if i == 5:
            raise KeyError("bad batch")
        return i

    seen = []
    with pytest.raises(KeyError, match="bad batch"):
        for x in loaders._parallel_ordered_iter(list(range(20)), make, 3, 2):
            seen.append(x)
    assert seen == list(range(5))

    before = {t for t in threading.enumerate() if t.name == "bdvc-loader"}
    it = loaders._parallel_ordered_iter(list(range(100)), lambda i: i, 3, 2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()  # the consumer leaves early: the workers exit
    deadline = time.time() + 10
    while time.time() < deadline:
        alive = {t for t in threading.enumerate() if t.name == "bdvc-loader"} - before
        if not alive:
            break
        time.sleep(0.05)
    assert not alive
