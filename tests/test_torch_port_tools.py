"""The port's command-line tools against the JAX package's, on the CPU.

Each port tool's ``main(argv)`` runs with ``--device cpu`` on a small
rawframe tree (R18 at 56², random weights from a seed, batch-norm statistics
randomized); the JAX tool runs on the same inputs, with its checkpoint, and
the port reads the same weights converted through ``models/convert.py``:

  * ``test_cil``: ``cnn_result.txt`` and ``nme_result.txt`` equal to JAX's,
    character for character, from three per-task checkpoints and the
    exemplar files of a run's work_dir;
  * ``test_single_ckpt``: the CNN and NME accuracies equal;
  * ``extract_features``: the same samples kept, ``cls_score`` and
    ``repr_consensus`` within rtol 1e-4 (atol 1e-6) in f32, the classifier
    weights equal;
  * ``predict``: the same videos and top-k labels, scores within 1e-4; the
    discovery of stray images and 0-based layouts as JAX's;
  * the model tools (``load_model``, predict, ``tools.train``) compute in
    float32 on a bf16 config, as the JAX tools do;
  * ``extract_background``: every image equal bit for bit to the JAX tool's,
    on the host (truncated median over two workers; the mean; the simulated
    camera motion's nanmedian and nanmean) and the device path (``--device
    cpu``, the rounded median of ``ops/augment.temporal_median`` against the
    JAX tool's ``jnp.median``), with odd and even frame counts; skip-existing;
  * ``create_annotation_files``: every file byte for byte;
  * ``bdvcil_torch.tools.train``: one epoch from the same weights (dropout
    0), every logged loss within rtol 1e-4 of JAX's ``tools/train.py`` and
    the same validation accuracy;
  * the device rule: each tool started through ``python -m`` without
    ``--device`` and with ``CUDA_VISIBLE_DEVICES=""`` raises instead of
    running on the CPU, and writes nothing.
"""

from __future__ import annotations

import copy
import json
import os
import pathlib
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from bdvcil_torch.cil_tools import (create_annotation_files, extract_background,
                                    extract_features, predict, test_cil, test_single_ckpt)
from bdvcil_torch.models.convert import from_jax_variables
from bdvcil_torch.runtime.checkpoint import save_checkpoint as port_save
from bdvcil_torch.tools import train as port_train
from bdvcil_tpu import cil as jax_cil
from bdvcil_tpu import parallel as jax_parallel
from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import init_model_params as jax_init
from bdvcil_tpu.runtime import save_checkpoint as jax_save
from tests.synthetic import make_rawframe_tree
from tests.test_cil_e2e import MEAN, STD, make_cil_config
from tests.torch_port_helpers import numpy_tree, randomize_bn

ROOT = pathlib.Path(__file__).resolve().parent.parent
T = 4
SCORE_TOL = dict(rtol=1e-4, atol=1e-6)
VAL_PIPELINE = [
    dict(type="SampleFrames", clip_len=1, frame_interval=1, num_clips=T, test_mode=True),
    dict(type="RawFrameDecode"),
    dict(type="Resize", scale=(-1, 64)),
    dict(type="CenterCrop", crop_size=56),
    dict(type="Normalize", mean=MEAN, std=STD),
    dict(type="FormatShape", input_format="NHWC"),
    dict(type="Collect", keys=["imgs", "label"], meta_keys=[]),
    dict(type="ToTensor", keys=["imgs"]),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    frames, train_ann, val_ann = make_rawframe_tree(root, num_classes=4, videos_per_class=3,
                                                    num_frames=6, size=(64, 80))
    return root, frames, train_ann, val_ann


def write_config(path: pathlib.Path, cfg: dict) -> pathlib.Path:
    """A python config file both packages' ``Config.fromfile`` read."""
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    return path


def jax_variables(model_cfg, num_classes, seed):
    """JAX weights at ``num_classes`` with randomized batch-norm statistics."""
    spec = jax_build_model(model_cfg)
    variables = jax_init(spec, jax.random.PRNGKey(seed), (1, T, 56, 56, 3))
    if num_classes != spec.num_classes:
        variables = spec.grow_params(variables, num_classes, jax.random.PRNGKey(100 + seed))
    return randomize_bn(variables, seed)


def save_both(variables, jax_path, port_path, meta=None):
    jax_save(jax_path, variables, meta=meta)
    port_save(port_path, from_jax_variables(numpy_tree(variables)), meta=meta)


def run_jax_tool(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__] + [str(a) for a in argv])
    return module.main()


@pytest.fixture
def one_device_jax(monkeypatch):
    """The JAX tools on one CPU device, as the port runs on one device."""
    make_mesh = jax_parallel.make_mesh

    class OneDeviceTrainer(jax_cil.CILTrainer):
        def __init__(self, config, dump_config=True, mesh=None):
            super().__init__(config, dump_config, mesh=make_mesh(jax.devices()[:1]))

    monkeypatch.setattr(jax_cil, "CILTrainer", OneDeviceTrainer)
    monkeypatch.setattr(jax_parallel, "make_mesh", lambda *a: make_mesh(jax.devices()[:1]))
    monkeypatch.setattr(jax, "device_count", lambda *a: 1)
    return OneDeviceTrainer


# -- test_cil and test_single_ckpt ------------------------------------------------------


@pytest.fixture(scope="module")
def cil_runs(tree):
    """Two work_dirs (JAX, port) holding the same three per-task checkpoints
    and exemplar files, as a CIL run leaves them."""
    root, frames, train_ann, val_ann = tree
    runs = {}
    for name in ("jax", "port"):
        cfg = make_cil_config(root, frames, train_ann, val_ann, root / f"{name}_wd").to_dict()
        runs[name] = write_config(root / f"{name}_cil.py", cfg)
    splits = cfg["task_splits"]
    train = [line.split() for line in train_ann.read_text().splitlines()]
    seen = 0
    for t, split in enumerate(splits):
        seen += len(split)
        variables = jax_variables(cfg["model"], seen, seed=t)
        meta = {"task": t, "num_classes": seen}
        save_both(variables, root / "jax_wd" / "ckpt" / f"ckpt_task_{t}.msgpack",
                  root / "port_wd" / "ckpt" / f"ckpt_task_{t}.pt", meta)
        rows = "".join(f"{r[0]} {r[1]} {r[2]}\n" for c in split
                       for r in [x for x in train if int(x[2]) == c][:2])
        for name in ("jax", "port"):
            ex = root / f"{name}_wd" / "exemplar" / f"exemplar_task_{t}.txt"
            ex.parent.mkdir(parents=True, exist_ok=True)
            ex.write_text(rows)
    return runs


def test_test_cil_tables_match_jax(cil_runs, one_device_jax, monkeypatch):
    import cil_tools.test_cil as jax_tool

    run_jax_tool(monkeypatch, jax_tool, [cil_runs["jax"]])
    trainer = test_cil.main([str(cil_runs["port"]), "--device", "cpu"])
    jwd, pwd = pathlib.Path(trainer.work_dir).parent / "jax_wd", pathlib.Path(trainer.work_dir)
    for name in ("cnn_result.txt", "nme_result.txt"):
        got, want = (pwd / name).read_text(), (jwd / name).read_text()
        assert got == want, f"{name}:\n{got}\nJAX:\n{want}"
    assert "Avg" in (pwd / "cnn_result.txt").read_text()


def test_test_single_ckpt_matches_jax(cil_runs, one_device_jax, monkeypatch):
    import cil_tools.test_single_ckpt as jax_tool

    got = {}
    testing = one_device_jax._testing

    def record(self, *a, **k):
        got["jax"] = testing(self, *a, **k)
        return got["jax"]

    monkeypatch.setattr(one_device_jax, "_testing", record)
    wd = {name: cil_runs[name].parent / f"{name}_wd" for name in ("jax", "port")}
    run_jax_tool(monkeypatch, jax_tool, [cil_runs["jax"], "--ckpt",
                                         wd["jax"] / "ckpt" / "ckpt_task_1.msgpack",
                                         "--starting_task", 1])
    cnn, nme = test_single_ckpt.main([str(cil_runs["port"]), "--ckpt",
                                      str(wd["port"] / "ckpt" / "ckpt_task_1.pt"),
                                      "--starting_task", "1", "--device", "cpu"])
    jcnn, jnme = got["jax"]
    assert cnn.values == jcnn.values and len(cnn.values) == 2
    assert nme.values == jnme.values and cnn.sizes == jcnn.sizes


# -- extract_features and predict -------------------------------------------------------


def tool_model_cfg():
    return dict(
        type="CILRecognizer2D",
        backbone=dict(type="ResNetTSM", depth=18, num_segments=T, shift_div=8),
        cls_head=dict(type="IncrementalTSMHead", num_classes=4, in_channels=512,
                      inc_head_config=dict(type="SimpleLinear", out_features=4),
                      num_segments=T, loss_cls=dict(type="CrossEntropyLoss"),
                      dropout_ratio=0.0),
        test_cfg=dict(average_clips="prob"),
    )


@pytest.fixture(scope="module")
def model_dirs(tree):
    """A JAX and a port dir, each with a config and the same weights."""
    root, frames, train_ann, val_ann = tree
    variables = jax_variables(tool_model_cfg(), 4, seed=7)
    dirs = {name: root / f"model_{name}" for name in ("jax", "port")}
    save_both(variables, dirs["jax"] / "latest.msgpack", dirs["port"] / "latest.pt")
    return dirs


def test_extract_features_matches_jax(tree, model_dirs, one_device_jax, monkeypatch):
    import cil_tools.extract_features as jax_tool
    from bdvcil_torch.cil_tools import load_model
    from bdvcil_torch.config import Config
    from bdvcil_torch.data.datasets import build_dataset
    from bdvcil_torch.data.host_loader import DataLoader
    from bdvcil_torch.runtime import make_eval_step
    from bdvcil_torch.runtime.loops import run_inference

    root, frames, train_ann, val_ann = tree
    cfg = dict(model=tool_model_cfg(), data=dict(
        train=dict(type="RawframeDataset", ann_file=str(train_ann), data_prefix=str(frames),
                   pipeline=VAL_PIPELINE),
        val=dict(type="RawframeDataset", ann_file=str(val_ann), data_prefix=str(frames),
                 pipeline=VAL_PIPELINE, test_mode=True)))
    # label every video with the class the model predicts, so the tools keep
    # (and the test compares) every sample, not only the lucky ones
    config = Config.fromdict(copy.deepcopy(cfg))
    spec, module, nc, _ = load_model(config, model_dirs["port"] / "latest.pt", "cpu")
    ds = build_dataset(dict(cfg["data"]["train"], test_mode=True))
    pred = run_inference(make_eval_step(spec, nc), module, DataLoader(ds, 4), device="cpu")
    labels = pred["cls_score"].mean(axis=1).argmax(-1)
    ann = root / "features_ann.txt"
    ann.write_text("".join(f"{line.split()[0]} {line.split()[1]} {c}\n" for line, c in
                           zip(train_ann.read_text().splitlines(), labels)))
    cfg["data"]["train"]["ann_file"] = str(ann)
    for name in ("jax", "port"):
        write_config(model_dirs[name] / "config.py", cfg)

    run_jax_tool(monkeypatch, jax_tool, [model_dirs["jax"], "--batch_size", 4])
    out = extract_features.main([str(model_dirs["port"]), "--batch_size", "4", "--device",
                                 "cpu"])
    got = json.loads(out.read_text())
    want = json.loads((model_dirs["jax"] / "features" / "out.json").read_text())
    assert got["model_weights"] == want["model_weights"]
    assert np.asarray(got["model_weights"]).shape == (4, 512)
    assert got["features_by_class"].keys() == want["features_by_class"].keys()
    assert sum(len(v) for v in got["features_by_class"].values()) == len(labels) == 8
    for cls, entries in want["features_by_class"].items():
        mine = got["features_by_class"][cls]
        assert [e["frame_dir"] for e in mine] == [e["frame_dir"] for e in entries]
        for g, w in zip(mine, entries):
            assert g["label"] == w["label"] == int(cls)
            for key in ("cls_score", "repr_consensus"):
                np.testing.assert_allclose(g[key], w[key], err_msg=key, **SCORE_TOL)


def test_predict_matches_jax(tree, model_dirs, one_device_jax, monkeypatch, tmp_path):
    import cil_tools.predict as jax_tool

    root, frames, train_ann, val_ann = tree
    cfg = dict(model=tool_model_cfg(), data=dict(test=dict(
        type="BackgroundMixDataset", ann_file=str(val_ann), data_prefix=str(frames),
        bg_dir=str(root / "bg"), pipeline=VAL_PIPELINE, test_mode=True)))
    outs = {}
    for name in ("jax", "port"):
        config = write_config(tmp_path / name / "config.py", cfg)
        (config.parent / "class_indices_mapping.json").write_text(
            json.dumps({f"orig_{c}": c for c in range(4)}))
        outs[name] = tmp_path / f"{name}.json"
    ckpt = {"jax": model_dirs["jax"] / "latest.msgpack", "port": model_dirs["port"] / "latest.pt"}
    args = ["--topk", "3", "--batch_size", "4"]
    run_jax_tool(monkeypatch, jax_tool, [tmp_path / "jax" / "config.py", ckpt["jax"], frames,
                                         "--output", outs["jax"], *args])
    payload = predict.main([str(tmp_path / "port" / "config.py"), str(ckpt["port"]),
                            str(frames), "--output", str(outs["port"]), *args,
                            "--device", "cpu"])
    got, want = json.loads(outs["port"].read_text()), json.loads(outs["jax"].read_text())
    assert got == payload
    assert len(want["predictions"]) == len(got["predictions"]) == 12
    for g, w in zip(got["predictions"], want["predictions"]):
        assert (g["video"], g["num_frames"]) == (w["video"], w["num_frames"])
        assert [e["class_index"] for e in g["topk"]] == [e["class_index"] for e in w["topk"]]
        assert [e["original_label"] for e in g["topk"]] == [e["original_label"] for e in w["topk"]]
        np.testing.assert_allclose([e["score"] for e in g["topk"]],
                                   [e["score"] for e in w["topk"]], rtol=0, atol=1e-4)
    # one video's frame directory
    one = sorted(d for d in frames.iterdir() if d.is_dir())[0]
    single = predict.main([str(tmp_path / "port" / "config.py"), str(ckpt["port"]), str(one),
                           "--topk", "1", "--device", "cpu"])
    assert [p["video"] for p in single["predictions"]] == [one.name]
    top, ref = single["predictions"][0]["topk"][0], got["predictions"][0]["topk"][0]
    assert top["class_index"] == ref["class_index"]
    np.testing.assert_allclose(top["score"], ref["score"], rtol=0, atol=1e-4)


def test_model_tools_compute_in_float32_on_a_bf16_config(tree, model_dirs, tmp_path):
    """The JAX tools build their model in float32 whatever the config's
    ``compute_dtype`` (cil_tools/predict.py, extract_features.py,
    tools/train.py); the port's do too: ``load_model``'s convs are float32,
    predict writes the same payload as on a float32 config, and
    ``tools.train`` trains a float32 model."""
    from bdvcil_torch.cil_tools import load_model
    from bdvcil_torch.config import Config
    from bdvcil_torch.models.resnet_tsm import Conv2d

    def conv_dtypes(module):
        return {m.dtype for m in module.modules() if isinstance(m, Conv2d)}

    root, frames, train_ann, val_ann = tree
    test = dict(type="RawframeDataset", ann_file=str(val_ann), data_prefix=str(frames),
                pipeline=VAL_PIPELINE, test_mode=True)
    payloads = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dict(model=tool_model_cfg(), compute_dtype=dtype, data=dict(test=test))
        spec, module, _, _ = load_model(Config.fromdict(copy.deepcopy(cfg)),
                                        model_dirs["port"] / "latest.pt", "cpu")
        assert spec.dtype == torch.float32 and conv_dtypes(module) == {torch.float32}, dtype
        config = write_config(tmp_path / dtype / "config.py", cfg)
        payloads[dtype] = predict.main([str(config), str(model_dirs["port"] / "latest.pt"),
                                        str(frames), "--batch_size", "4", "--device", "cpu"])
    assert payloads["bfloat16"] == payloads["float32"]
    train_pipeline = make_cil_config(root, frames, train_ann, val_ann,
                                     tmp_path).to_dict()["data"]["train"]["pipeline"]
    config = write_config(tmp_path / "train_cfg.py", dict(
        model=tool_model_cfg(), compute_dtype="bfloat16", videos_per_gpu=4, workers_per_gpu=2,
        total_epochs=1, seed=3, optimizer=dict(type="SGD", lr=0.01, momentum=0.9),
        lr_scheduler=dict(type="MultiStepLR", params=dict(milestones=[20], gamma=0.1)),
        data=dict(train=dict(type="RawframeDataset", ann_file=str(train_ann),
                             data_prefix=str(frames), pipeline=train_pipeline))))
    state = port_train.main([str(config), "--work_dir", str(tmp_path / "train"),
                             "--device", "cpu"])
    assert conv_dtypes(state.module) == {torch.float32}


@pytest.mark.parametrize("layout", ["stray-image", "zero-based"])
def test_predict_discovery_matches_jax(tmp_path, layout):
    from cil_tools.predict import discover_videos as jax_discover

    root = tmp_path / "frames"
    for name, start, n in (("v0", 0, 6), ("v1", 1, 4)) if layout == "zero-based" else \
            (("v0", 1, 5), ("v1", 1, 3)):
        d = root / name
        d.mkdir(parents=True)
        for i in range(start, start + n):
            cv2.imwrite(str(d / f"img_{i:05}.jpg"), np.full((8, 8, 3), i, np.uint8))
    if layout == "stray-image":
        (root / "v0" / "preview.jpg").write_bytes(b"\xff\xd8\xff\xd9")
        (root / "v1" / "img_00009.jpg").write_bytes(b"\xff\xd8\xff\xd9")  # past a gap
    got = predict.discover_videos(root, "img_{:05}.jpg")
    assert got == jax_discover(root, "img_{:05}.jpg")
    want = {"zero-based": {"v0": (6, 0), "v1": (4, 1)},
            "stray-image": {"v0": (5, 1), "v1": (3, 1)}}[layout]
    assert {name: (n, s) for name, d, n, s in got} == want


# -- extract_background ---------------------------------------------------------------


@pytest.fixture(scope="module", params=[5, 6], ids=["odd", "even"])
def bg_tree(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"bg{request.param}")
    frames, _, _ = make_rawframe_tree(root, num_classes=2, videos_per_class=2,
                                      num_frames=request.param, size=(32, 40),
                                      seed=request.param)
    return frames, request.param


def _images(out_dir):
    files = sorted(out_dir.glob("*.jpg"))
    return {p.name: (cv2.imread(str(p), cv2.IMREAD_UNCHANGED), p.read_bytes()) for p in files}


def test_extract_background_host_matches_jax(bg_tree, tmp_path, monkeypatch):
    import cil_tools.extract_background as jax_tool

    frames, n = bg_tree
    run_jax_tool(monkeypatch, jax_tool, ["--video_dir", frames, "--output_dir",
                                         tmp_path / "jax", "--num_workers", 2])
    done = extract_background.main(["--video_dir", str(frames), "--output_dir",
                                    str(tmp_path / "port"), "--num_workers", "2"])
    assert len(done) == 4
    got, want = _images(tmp_path / "port"), _images(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) == 4
    for name, (img, raw) in want.items():
        np.testing.assert_array_equal(got[name][0], img, err_msg=name)
        assert got[name][1] == raw, name
    # skip-existing: a second run extracts nothing and rewrites nothing
    stamps = {p: p.stat().st_mtime_ns for p in (tmp_path / "port").glob("*.jpg")}
    assert extract_background.main(["--video_dir", str(frames), "--output_dir",
                                    str(tmp_path / "port")]) == []
    assert stamps == {p: p.stat().st_mtime_ns for p in (tmp_path / "port").glob("*.jpg")}


@pytest.mark.parametrize("method,avg", [("tmf", "mean"), ("sim_cam", "median"),
                                        ("sim_cam", "mean")])
def test_extract_background_methods_match_jax(tmp_path, monkeypatch, method, avg):
    import cil_tools.extract_background as jax_tool

    frames, _, _ = make_rawframe_tree(tmp_path, num_classes=1, videos_per_class=2,
                                      num_frames=6, size=(32, 40), seed=11)
    args = ["--video_dir", frames, "--num_workers", 1, "--method", method, "--avg_method", avg]
    run_jax_tool(monkeypatch, jax_tool, args + ["--output_dir", tmp_path / "jax"])
    extract_background.main([str(a) for a in args] + ["--output_dir", str(tmp_path / "port")])
    got, want = _images(tmp_path / "port"), _images(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) == 2
    for name, (img, raw) in want.items():
        np.testing.assert_array_equal(got[name][0], img, err_msg=name)
        assert got[name][1] == raw, name


def test_extract_background_device_matches_jax(bg_tree, tmp_path):
    from cil_tools.extract_background import bg_extraction_tmf as jax_tmf

    frames, n = bg_tree
    extract_background.main(["--video_dir", str(frames), "--output_dir",
                             str(tmp_path / "port"), "--device", "cpu"])
    host = {}
    for vdir in sorted(frames.iterdir()):
        dest = tmp_path / "jax" / f"{vdir.name}.jpg"
        dest.parent.mkdir(exist_ok=True)
        want = jax_tmf(vdir, dest, False, 1, 500, 0, use_device=True)
        host[vdir.name] = extract_background.bg_extraction_tmf(vdir, tmp_path / "h.jpg", False,
                                                              1, 500, 0)
        got = cv2.imread(str(tmp_path / "port" / f"{vdir.name}.jpg"), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, cv2.imread(str(dest), cv2.IMREAD_UNCHANGED))
        assert (tmp_path / "port" / f"{vdir.name}.jpg").read_bytes() == dest.read_bytes()
        stack = np.stack([cv2.imread(str(f)) for f in sorted(vdir.glob("*.jpg"))])
        np.testing.assert_array_equal(np.asarray(want),
                                      np.round(np.median(stack, axis=0)).astype(np.uint8))
        # the host path truncates what the device path rounds: they differ
        # only where an even count's middle pair has an odd sum
        trunc = np.median(stack, axis=0).astype(np.uint8)
        np.testing.assert_array_equal(host[vdir.name], trunc)
        assert (np.asarray(want) != trunc).any() == (n % 2 == 0)


def test_create_annotation_files_match_jax(tree, tmp_path, monkeypatch):
    import cil_tools.create_annotation_files as jax_tool

    root, frames, train_ann, val_ann = tree
    splits = write_config(tmp_path / "splits.py", {"task_splits": [[0, 1], [2], [3]]})
    args = ["--train_ann_file", train_ann, "--val_ann_file", val_ann, "--task_splits_config",
            splits]
    run_jax_tool(monkeypatch, jax_tool, args + ["--destination", tmp_path / "jax"])
    out = create_annotation_files.main([str(a) for a in args] +
                                       ["--destination", str(tmp_path / "port")])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "class_indices_mapping.json" in names and "val_oracle_task_2.txt" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert sum(len(v) for v in out.values()) == len(names) - 1


# -- bdvcil_torch.tools.train -----------------------------------------------------------


def test_tools_train_matches_jax(tree, model_dirs, one_device_jax, monkeypatch, tmp_path):
    import tools.train as jax_tool

    root, frames, train_ann, val_ann = tree
    train_pipeline = make_cil_config(root, frames, train_ann, val_ann,
                                     tmp_path).to_dict()["data"]["train"]["pipeline"]
    cfg = dict(
        model=tool_model_cfg(), videos_per_gpu=4, workers_per_gpu=2, total_epochs=1,
        log_every_n_steps=1, seed=3, testing_videos_per_gpu=4,
        optimizer=dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4),
        lr_scheduler=dict(type="MultiStepLR", params=dict(milestones=[20], gamma=0.1)),
        data=dict(
            train=dict(type="RawframeDataset", ann_file=str(train_ann), data_prefix=str(frames),
                       pipeline=train_pipeline),
            val=dict(type="RawframeDataset", ann_file=str(val_ann), data_prefix=str(frames),
                     pipeline=VAL_PIPELINE, test_mode=True)))
    config = write_config(tmp_path / "train_cfg.py", cfg)
    run_jax_tool(monkeypatch, jax_tool, [config, "--work_dir", tmp_path / "jax", "--resume-from",
                                         model_dirs["jax"] / "latest.msgpack"])
    port_train.main([str(config), "--work_dir", str(tmp_path / "port"), "--resume-from",
                     str(model_dirs["port"] / "latest.pt"), "--device", "cpu"])
    logs = {name: [json.loads(line) for line in
                   (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
            for name in ("jax", "port")}
    key = "[train_Task_0]loss"
    jl, pl = ([r[key] for r in logs[name] if key in r] for name in ("jax", "port"))
    assert len(pl) == len(jl) == 1  # 8 videos, batch 4: the last step's metrics are not logged
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert [r["val_top1"] for r in logs["port"] if "val_top1" in r] == \
        [r["val_top1"] for r in logs["jax"] if "val_top1" in r]
    for name in ("latest.pt", "final.pt", "config.py"):
        assert (tmp_path / "port" / name).exists(), name


# -- the device rule ----------------------------------------------------------------------


def _tool_commands(tmp_path):
    """(module, argv) of each tool, without --device where it takes one."""
    cfg = str(tmp_path / "missing_config.py")
    out = str(tmp_path / "out")
    return {
        "test_cil": ["bdvcil_torch.cil_tools.test_cil", cfg],
        "test_single_ckpt": ["bdvcil_torch.cil_tools.test_single_ckpt", cfg, "--ckpt", "x.pt",
                             "--starting_task", "1"],
        "predict": ["bdvcil_torch.cil_tools.predict", cfg, "x.pt", str(tmp_path), "--output",
                    out],
        "extract_features": ["bdvcil_torch.cil_tools.extract_features", out],
        "extract_background": ["bdvcil_torch.cil_tools.extract_background", "--video_dir",
                               str(tmp_path), "--output_dir", out, "--device"],
        "train": ["bdvcil_torch.tools.train", cfg, "--work_dir", out],
    }


@pytest.fixture(scope="module")
def refused(tmp_path_factory):
    """Every tool started at once through ``python -m`` with no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    tmp_path = tmp_path_factory.mktemp("refused")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = {name: subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, argv in _tool_commands(tmp_path).items()}
    out = {name: (p.wait(timeout=120), *p.communicate(timeout=60)) for name, p in procs.items()}
    return tmp_path, out


@pytest.mark.parametrize("tool", list(_tool_commands(pathlib.Path("."))))
def test_tool_refuses_to_fall_back_to_the_cpu(refused, tool):
    tmp_path, out = refused
    rc, stdout, stderr = out[tool]
    assert rc != 0
    assert "device='cpu'" in stderr, stderr[-2000:]
    assert not (tmp_path / "out").exists()
