"""The port's benches (``bdvcil_torch.roofline``, ``bench_step``,
``bench_eval``, ``bench_train --family acm``, ``bench_input``,
``bench_randaug`` and the composite ``bench``) against the JAX system's
``bench.py``, ``tools/roofline.py`` and ``tools/bench_randaug.py``, on the CPU.

  * the bench model config equals ``bench._bench_model_cfg``;
  * the roofline equals ``tools/roofline.py`` exactly: the layer list and
    both pass models' bytes and FLOPs at 16 x 8 x 224², and at 2 x 2 x 64²
    against the JAX tool with its constants and layer dims patched; the H100
    bounds are the arithmetic that ``ROADMAP.md`` quotes;
  * ``bench.py:1083``'s 32.97 "GFLOPs" a clip forward is the roofline's
    multiply-adds (within 1%), half its FLOPs; the step's ``mfu`` and
    ``bw_roofline_fraction`` are the roofline's shares of the line's rate;
  * the forward-only bench's scores (R50, 32², 2 segments, batch 1, f32, JAX
    weights through ``convert.from_jax_variables``) equal JAX's
    ``make_eval_step`` on the same chained inputs, rtol 1e-4;
  * ``bench_eval``'s scores (R18, 32², 2 segments, 4 videos, K = 2, centre
    and TenCrop) equal JAX's ``run_inference`` over JAX's ``FastEvalLoader``
    at the eval tests' tolerances (rtol 1e-4, atol 1e-4);
  * the ACM bench's first loader batch equals JAX's ``FastACMLoader``'s at
    the bench's boxes, acm_prob 1 and seed 0;
  * ``bench_input``'s native decode equals JAX's bit for bit;
  * ``bench_randaug``'s rebuild with nothing skipped equals
    ``rand_augment_batch`` bit for bit, its families are the JAX tool's op
    ids, and a skipped family leaves exactly its clips' rounds untouched;
  * each line has JAX's keys (``_per_chip`` dropped); the composite with
    ``--budget 0`` prints the headline, then both ``*_skipped_budget``
    markers in a last line that parses;
  * each entry point that runs on a device refuses the CPU unless asked
    (``bench_input`` and ``roofline`` run no device code).
"""

from __future__ import annotations

import ast
import importlib
import itertools
import json
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_torch import bench as port_bench
from bdvcil_torch import bench_eval, bench_input, bench_randaug, bench_step, bench_train, roofline
from bdvcil_torch.data import native
from bdvcil_torch.models import build_model, from_jax_variables
from bdvcil_torch.ops.rand_augment_dev import GEO_IDS, OP_TABLE, rand_augment_batch
from bdvcil_tpu.data.device_pipeline import FastACMLoader as JaxFastACMLoader
from bdvcil_tpu.data.device_pipeline import FastEvalLoader as JaxFastEvalLoader
from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import init_model_params as jax_init
from bdvcil_tpu.ops import rand_augment_dev as jax_rad
from bdvcil_tpu.runtime import make_eval_step as jax_make_eval_step
from bdvcil_tpu.runtime import make_multi_eval_step as jax_make_multi_eval_step
from bdvcil_tpu.runtime.loops import run_inference as jax_run_inference
from tests.torch_port_helpers import assert_batch_matches_jax, jax_native, randomize_bn

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_port_eval.py's
SMALL = ["--device", "cpu", "--size", "32", "--segments", "2", "--batch", "2", "--videos", "4",
         "--frames", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_bench():
    """``bench.py`` as ``tests/test_bench_pause.py`` imports it, with the JAX
    compilation-cache settings it makes at import restored after."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    saved = {k: getattr(jax.config, k) for k in keys}
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    import bench

    for k, v in saved.items():
        jax.config.update(k, v)
    if env is None:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    return bench


@pytest.fixture(scope="module")
def jax_roofline():
    return importlib.import_module("tools.roofline")


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    if not native.available():
        pytest.fail(f"the port's native decoder did not build: {native.build_error()}")
    return str(tmp_path_factory.mktemp("bench_corpus"))


@pytest.fixture(scope="module")
def _jax_decoder(corpus_dir):
    jax_native()  # the JAX loaders decode with it


def lines_of(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


# -- the model and the roofline --------------------------------------------------------


@pytest.mark.parametrize("segments", [8, 2])
def test_bench_model_cfg_is_bench_pys(jax_bench, segments):
    assert bench_train.model_cfg(segments) == jax_bench._bench_model_cfg(segments)


def test_roofline_layers_and_traffic_equal_the_jax_tool(jax_roofline):
    assert roofline.r50_layers() == jax_roofline.r50_layers()
    for model in roofline.MODELS:
        assert roofline.traffic(model) == jax_roofline.traffic(model)


def test_roofline_at_another_shape_equals_the_patched_jax_tool(jax_roofline, monkeypatch):
    layers = jax_roofline.r50_layers()
    scaled = [(name, h * 64 // 224, w * 64 // 224, *rest) for name, h, w, *rest in layers]
    monkeypatch.setattr(jax_roofline, "BATCH", 2)
    monkeypatch.setattr(jax_roofline, "T", 2)
    monkeypatch.setattr(jax_roofline, "N", 4)
    monkeypatch.setattr(jax_roofline, "r50_layers", lambda: scaled)
    assert roofline.r50_layers(64) == scaled
    for model in roofline.MODELS:
        assert roofline.traffic(model, batch=2, segments=2, size=64) == \
            jax_roofline.traffic(model)


def test_roofline_h100_bounds():
    b = roofline.bounds()
    assert round(b["minimal"]["traffic_gb"], 2) == 22.84
    assert round(b["xla"]["traffic_gb"], 2) == 51.30
    assert round(b["train_tflop_per_step"], 3) == 3.139
    assert round(b["minimal"]["bw_bound_ms"], 2) == 6.82
    assert round(b["xla"]["bw_bound_ms"], 2) == 15.31
    assert round(b["minimal"]["clips_per_sec_at_bound"]) == 2347
    assert round(b["xla"]["clips_per_sec_at_bound"]) == 1045
    assert round(b["flop_bound_ms"], 2) == 3.17


def test_roofline_cli_prints_a_ratio_only_for_a_measured_step(capsys):
    assert roofline.main([]) == 0
    assert "measured_ms" not in json.loads(capsys.readouterr().out)
    assert roofline.main(["--measured-ms", "125.0"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["bw_fraction_vs_xla_model"] == pytest.approx(out["xla"]["bw_bound_ms"] / 125.0)
    assert out["mfu"] == pytest.approx(out["flop_bound_ms"] / 125.0)


def test_bench_pys_forward_gflops_are_multiply_adds():
    """bench.py:1083 takes 32.97e-3 TFLOPs as a clip's forward (the model
    zoo's metafile figure): it is within 1% of the roofline's multiply-adds
    and half its FLOPs, so bench.py's mfu is half the step's share."""
    src = (ROOT / "bench.py").read_text()
    cited = float(re.search(r"FWD_TFLOPS_PER_CLIP = ([0-9.e-]+)", src).group(1)) * 1e12
    fwd_flops = roofline.train_flops_per_clip() / 3
    assert abs(fwd_flops / 2 / cited - 1) < 0.01
    assert abs(fwd_flops / cited - 2) < 0.02


def test_step_shares_are_the_rooflines():
    value = 125.0
    u = bench_step.utilization(value, 16, 8, 224, 50)
    flops = roofline.train_flops_per_clip(8, 224)
    assert u["mfu"] == value * flops / 989e12
    assert u["bw_roofline_fraction"] == value / roofline.bounds(16, 8, 224)["xla"][
        "clips_per_sec_at_bound"]
    assert u["model_tflops_per_clip"] == flops / 1e12
    assert bench_step.utilization(value, 16, 8, 224, 18) == {
        "roofline": "depth 18 not modelled"}


# -- the step headline and the forward-only bench ---------------------------------------


def test_step_line_on_the_cpu(capsys):
    assert bench_step.main(SMALL + ["--depth", "50", "--steps", "1", "--warmup", "1"]) == 0
    (line,) = lines_of(capsys)
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line)
    assert line["metric"] == "train_clips_per_sec_tsm_r50_8x224" and line["device"] == "cpu"
    assert line["vs_baseline"] == pytest.approx(line["value"] / 15.0)
    # a CPU rate is no share of the card's peak: the line says so and carries none
    assert line["roofline"] == "not computed off the card"
    assert not {"mfu", "bw_roofline_fraction"} & set(line)
    u = bench_step.utilization(line["value"], 2, 2, 32, 50)
    assert u["mfu"] == line["value"] * roofline.train_flops_per_clip(2, 32) / 989e12
    assert {"model_tflops_per_clip", "mfu", "bw_roofline_fraction", "utilization_note"} == set(u)


@pytest.mark.parametrize("flags", [["--scan", "2"], ["--forward-only", "--config", "B"]])
def test_step_variants_on_the_cpu(capsys, flags):
    assert bench_step.main(SMALL + ["--depth", "18", "--steps", "1", "--warmup", "1"]
                           + flags) == 0
    (line,) = lines_of(capsys)
    if "--scan" in flags:
        assert line["steps"] == 2 and line["scan"] == 2
        assert line["roofline"] == "not computed off the card"
    else:
        assert line["metric"] == "fwd_clips_per_sec_tsm_r50_8x224"
        assert line["vs_baseline"] == pytest.approx(line["value"] / 74.0)
        assert line["backbone"]["shift_mode"] == "fused_block"


def test_forward_only_scores_equal_jax(jax_bench):
    cfg = jax_bench._bench_model_cfg(2)
    jspec = jax_build_model(cfg)
    jvars = randomize_bn(jax_init(jspec, jax.random.PRNGKey(0), (1, 2, 32, 32, 3)), 50)
    spec = build_model(bench_train.model_cfg(2), device="cpu")
    module = spec.module(bench_train.NUM_CLASSES)
    module.load_state_dict(from_jax_variables(jvars))
    imgs, _ = bench_step.bench_inputs(1, 2, 32, CPU)
    _, out = bench_step.time_forward(spec, module, imgs, steps=2, warmup=1, device=CPU)
    jstep = jax_make_eval_step(jspec, bench_train.NUM_CLASSES)
    base, carry = jnp.asarray(imgs.numpy()), jnp.zeros(())
    for _ in range(3):  # bench.py:996-1007's chain
        ref = jstep(jvars, base + carry * 1e-6)
        carry = ref["cls_score"].mean()
    np.testing.assert_allclose(out["cls_score"].numpy(), np.asarray(ref["cls_score"]),
                               rtol=1e-4, atol=1e-6)


# -- eval, ACM, input --------------------------------------------------------------------


def eval_pair(depth: int):
    """(JAX spec, JAX variables, port spec, port module) of the bench model at
    ``depth``, 2 segments, f32, with the same weights."""
    jspec = jax_build_model(bench_train.model_cfg(2, depth))
    jvars = randomize_bn(jax_init(jspec, jax.random.PRNGKey(depth), (1, 2, 32, 32, 3)), depth)
    spec = build_model(bench_train.model_cfg(2, depth), device="cpu")
    module = spec.module(bench_train.NUM_CLASSES)
    module.load_state_dict(from_jax_variables(jvars))
    return jspec, jvars, spec, module


@pytest.mark.parametrize("tencrop", [False, True])
def test_eval_bench_scores_equal_jax_run_inference(corpus_dir, _jax_decoder, tencrop):
    args = bench_eval.build_parser().parse_args(
        SMALL + ["--depth", "18", "--k", "2", "--steps", "2", "--measures", "1",
                 "--corpus", corpus_dir])
    infos = bench_eval.video_infos(args)
    jspec, jvars, spec, module = eval_pair(18)
    loader = bench_eval.make_loader(infos, args, tencrop, "auto")
    _, rates, out, forwards = bench_eval.measure(spec, module, loader, args, CPU)
    passes = 1  # the fewest passes of 2 batches that hold --steps 2
    assert len(rates) == 1 and forwards == (2 + 1 + passes) * len(loader)
    jloader = JaxFastEvalLoader(infos, batch_size=2, num_segments=2, crop_size=32,
                                short_side=37, tencrop=tencrop, num_workers=1, prefetch=2,
                                process_index=0, process_count=1, wire_format="auto")
    assert jloader.wire_format == loader.wire_format == ("yuv420_full" if tencrop else "rgb")
    nc = bench_train.NUM_CLASSES
    ref = jax_run_inference(jax_make_eval_step(jspec, nc), jvars,
                            itertools.chain.from_iterable(iter(jloader) for _ in range(passes)),
                            steps_per_dispatch=2,
                            multi_eval_step=jax_make_multi_eval_step(jspec, nc, 2))
    assert out["cls_score"].shape == (passes * 4, 10 if tencrop else 1, nc)
    np.testing.assert_array_equal(out["labels"], np.asarray(ref["labels"]))
    np.testing.assert_allclose(out["cls_score"], np.asarray(ref["cls_score"]), **TOL)


def test_eval_line_has_jax_keys(corpus_dir, capsys, _jax_decoder):
    assert bench_eval.main(SMALL + ["--depth", "18", "--k", "2", "--steps", "2", "--measures",
                                    "2", "--corpus", corpus_dir]) == 0
    (line,) = lines_of(capsys)
    assert {"metric", "value", "unit", "vs_baseline", "tencrop_videos_per_sec", "tencrop_wire",
            "rgb_wire_tencrop_videos_per_sec"} <= set(line)
    assert line["metric"] == "e2e_eval_videos_per_sec_tsm_r50_8x224"
    assert line["vs_baseline"] == pytest.approx(line["value"] / (74.0 / 8.0))
    assert line["tencrop_wire"] == "yuv420_full" and line["wires"]["center"] == "rgb"
    assert line["rows"] == {"center": 4, "tencrop": 4, "rgb_tencrop": 4}
    assert line["value"] == sorted(line["sweep_rates"]["center"])[1]  # bench.py's pick


def test_acm_first_batch_equals_jax(corpus_dir, _jax_decoder):
    args = bench_train.build_parser().parse_args(SMALL + ["--corpus", corpus_dir])
    loader, infos = bench_train.make_loader(args, family="acm")
    dets = infos[0]["all_detections"]
    assert sorted(dets) == list(range(1, 5)) and dets[1] == bench_train.ACM_BOXES
    ref_loader = JaxFastACMLoader(infos, batch_size=2, num_segments=2, crop_size=32,
                                  acm_prob=1.0, seed=0, drop_last=True, prefetch=2,
                                  num_workers=1, process_index=0, process_count=1,
                                  wire_format="auto")
    assert loader.wire_format == ref_loader.wire_format
    got, want = next(iter(loader)), next(iter(ref_loader))
    assert want["apply_acm"].all()
    assert_batch_matches_jax(got, want, crop=32)


def test_acm_bench_line(corpus_dir, capsys):
    assert bench_train.main(SMALL + ["--depth", "18", "--family", "acm", "--k", "2", "--steps",
                                     "2", "--windows", "1", "--warmup", "1",
                                     "--device-calls", "1", "--corpus", corpus_dir]) == 0
    (line,) = lines_of(capsys)
    assert line["metric"] == "e2e_acm_train_clips_per_sec_tsm_r50_8x224"
    assert line["family"] == "acm" and line["source"] == "jpeg" and line["value"] > 0
    assert {"window_rates", "window_min", "producer_wait_s", "device_clips_per_sec"} <= set(line)


def test_acm_bench_refuses_the_synthetic_source():
    args = bench_train.build_parser().parse_args(SMALL + ["--source", "synthetic"])
    with pytest.raises(ValueError, match="decodes the corpus"):
        bench_train.make_loader(args, family="acm")


def test_bgmix_line_gains_only_the_family_key(corpus_dir, capsys):
    argv = SMALL + ["--depth", "18", "--k", "2", "--steps", "2", "--windows", "1", "--warmup",
                    "1", "--device-calls", "1", "--source", "synthetic"]
    assert bench_train.main(argv) == 0
    (line,) = lines_of(capsys)
    keys = list(line)
    assert keys[:4] == ["metric", "value", "unit", "family"] and line["family"] == "bgmix"
    assert line["metric"] == bench_train.METRIC
    assert keys[4:] == ["config", "backbone", "k", "window_rates", "window_min",
                        "window_wall_s", "window_producer_wait_s", "producer_wait_s",
                        "warm_s", "device_clips_per_sec", "steps", "decode_cache",
                        "host_decode_frames_per_sec", "host_cpus", "source", "wire_format",
                        "losses", "shape", "device", "card"]


def test_input_bench_decode_equals_jax_bit_for_bit(tmp_path, _jax_decoder):
    paths = bench_input.write_frames(tmp_path, 6)
    got = native.decode_resize_crop_batch(paths, 256, 224, 224)
    want = jax_native().decode_resize_crop_batch(paths, 256, 224, 224)
    assert got.shape == (6, 224, 224, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert bench_input.cv2_chain(paths[0]).shape == (224, 224, 3)


def test_input_line_has_jax_keys(capsys):
    assert bench_input.main(["--frames", "16"]) == 0
    (line,) = lines_of(capsys)
    assert line["metric"] == "native_decode_frames_per_sec" and line["unit"] == "frames/s"
    assert line["vs_baseline"] == pytest.approx(line["value"] / line["cv2_frames_per_sec"])
    assert line["frames"] == 16


# -- RandAugment's families ---------------------------------------------------------------


def jax_tool_families():
    """``families`` of ``tools/bench_randaug.py``, read from its source."""
    tree = ast.parse((ROOT / "tools" / "bench_randaug.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "families":
            return ast.literal_eval(node.value)
    raise AssertionError("no families dict in tools/bench_randaug.py")


def test_randaug_families_are_the_jax_tools():
    assert [name for name, _, _ in OP_TABLE] == [name for name, _, _ in jax_rad.OP_TABLE]
    assert tuple(GEO_IDS) == tuple(jax_rad._GEO_IDS)
    want = {name: set(GEO_IDS) if ids == {"geo"} else ids
            for name, ids in jax_tool_families().items()}
    assert bench_randaug.FAMILIES == want


def test_randaug_rebuild_with_nothing_skipped_is_the_full_op_table():
    imgs, draws = bench_randaug.bench_batch(8, 2, 32, CPU)
    full = rand_augment_batch(imgs, *draws, m=bench_randaug.M)
    rebuilt = rand_augment_batch(imgs, *bench_randaug.without(draws, set()), m=bench_randaug.M)
    assert not torch.equal(full, imgs) and torch.equal(rebuilt, full)


@pytest.mark.parametrize("family", sorted(bench_randaug.FAMILIES))
def test_randaug_family_skipped_leaves_its_rounds_untouched(family):
    """Three clips draw (s, s), (s, o), (o, o), s in the family, o not: with
    the family skipped the first passes through, the second gets o alone,
    the third is the full table's."""
    skip = bench_randaug.FAMILIES[family]
    s, o = min(skip), min(set(range(1, len(OP_TABLE))) - skip)
    imgs, (_, sign, x0, y0) = bench_randaug.bench_batch(3, 2, 32, CPU)
    draws = (np.array([[s, s], [s, o], [o, o]]), sign, x0, y0)
    m = bench_randaug.M
    out = rand_augment_batch(imgs, *bench_randaug.without(draws, skip), m=m)
    full = rand_augment_batch(imgs, *draws, m=m)
    assert not torch.equal(full[0], imgs[0])  # the family does change the clip
    assert torch.equal(out[0], imgs[0])
    o_alone = rand_augment_batch(imgs[1:2], np.array([[0, o]]), sign[1:2], x0[1:2], y0[1:2],
                                 m=m)
    assert torch.equal(out[1], o_alone[0])
    assert torch.equal(out[2], full[2])


def test_randaug_line_has_jax_keys(capsys):
    assert bench_randaug.main(["--device", "cpu", "--batch", "2", "--segments", "1", "--size",
                               "32", "--steps", "1"]) == 0
    (line,) = lines_of(capsys)
    names = list(bench_randaug.FAMILIES)
    costs = [f"cost:{n[3:] if n.startswith('no_') else n}" for n in names]
    assert {"full_n2", "rebuilt_full", *names, *costs} <= set(line)
    for name, cost in zip(names, costs):
        assert line[cost] == line["rebuilt_full"] - line[name]


# -- the composite and the device rule ---------------------------------------------------


def test_composite_with_no_budget_prints_the_headline_and_skips(capsys):
    rc = port_bench.main(SMALL + ["--depth", "18", "--budget", "0", "--source", "synthetic",
                                  "--k", "2", "--steps", "1", "--warmup", "1", "--e2e-steps",
                                  "2", "--windows", "1"])
    lines = lines_of(capsys)
    assert rc == 0 and len(lines) == 3
    assert lines[0]["metric"] == "train_clips_per_sec_tsm_r50_8x224"
    last = lines[-1]
    assert last["eval_skipped_budget"] is True and last["acm_skipped_budget"] is True
    assert {"e2e_train_clips_per_sec", "e2e_vs_baseline", "e2e_window_rates",
            "e2e_window_min", "e2e_steps_per_dispatch", "bench_wall_s"} <= set(last)
    assert not any(k.endswith("_error") for k in last)
    assert last["value"] == lines[0]["value"]


def test_composite_records_a_failed_section_and_exits_1(capsys):
    # the ACM section cannot run from the synthetic source: recorded, not raised
    rc = port_bench.main(SMALL + ["--depth", "18", "--budget", "1e9", "--source", "synthetic",
                                  "--k", "2", "--steps", "1", "--warmup", "1", "--e2e-steps",
                                  "2", "--windows", "1"])
    last = lines_of(capsys)[-1]
    assert rc == 1
    assert "decodes the corpus" in last["eval_error"] and "decodes the corpus" in last[
        "acm_error"]


@pytest.mark.parametrize("entry,argv", [
    (bench_step.main, []),
    (bench_step.main, ["--forward-only"]),
    (bench_eval.main, []),
    (bench_train.main, ["--family", "acm"]),
    (bench_randaug.main, []),
    (port_bench.main, []),
], ids=["step", "forward", "eval", "acm", "randaug", "composite"])
def test_entry_points_refuse_the_cpu_unless_asked(entry, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(argv + ["--size", "32", "--segments", "2", "--batch", "2"]
              + (["--corpus", str(tmp_path)] if entry is not bench_randaug.main else []))
