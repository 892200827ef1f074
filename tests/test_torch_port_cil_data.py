"""The port's copies of the CIL data side against the JAX package's.

  * ``Config``: ``fromfile`` with ``_base_``, ``merge_from_dict`` and
    ``dump`` give the same dicts and the same file text;
  * ``make_cil_config`` equals JAX's for the arguments of every file under
    ``configs/`` (read with ``ast``: those files import the JAX package);
  * the annotation helpers and the data module's task-split files, byte for
    byte;
  * the host pipeline (``RawframeDataset``/``BackgroundMixDataset`` with
    RandAugment, MultiScaleCrop, BGMix; the val centre crop; TenCrop) and
    the host ``DataLoader``'s batches (shuffle, padded tail, sample_weight):
    bit for bit for the same seed, epoch and index;
  * herding: the same selection, distances and class means on the same
    features ('videos' and 'clips', 'class' and 'fixed' budgets);
  * the data module: exemplar files, the replay merge, and the CBF dataset
    under the three background policies;
  * gradient accumulation 2 against ``optax.MultiSteps``: 4 micro-steps,
    losses within rtol 1e-4, nothing moves on a micro-step that is not the
    second, and every parameter's update within 5% in norm;
  * the result table against the JAX package's (``tabulate``).
"""

from __future__ import annotations

import ast
import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_torch import config as pconfig
from bdvcil_torch import config_templates as ptemplates
from bdvcil_torch.cil import CILDataModule, Herding
from bdvcil_torch.data import annotations as pann
from bdvcil_torch.data.datasets import build_dataset
from bdvcil_torch.data.host_loader import DataLoader
from bdvcil_torch.models import build_model, from_jax_variables
from bdvcil_torch.optim import build_optimizer
from bdvcil_torch.runtime import TrainState, make_train_step
from bdvcil_torch.utils import AverageMeter, print_mean_accuracy
from bdvcil_tpu import config as jconfig
from bdvcil_tpu import config_templates as jtemplates
from bdvcil_tpu.cil import CILDataModule as JaxDataModule
from bdvcil_tpu.cil import Herding as JaxHerding
from bdvcil_tpu.data import DataLoader as JaxDataLoader
from bdvcil_tpu.data import annotations as jann
from bdvcil_tpu.data import build_dataset as jax_build_dataset
from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import init_model_params as jax_init
from bdvcil_tpu.optim import build_optimizer as jax_build_optimizer
from bdvcil_tpu.runtime import TrainState as JaxTrainState
from bdvcil_tpu.runtime import make_train_step as jax_make_train_step
from bdvcil_tpu.utils import print_mean_accuracy as jax_print_mean_accuracy
from tests.synthetic import make_rawframe_tree
from tests.test_cil_e2e import make_cil_config
from tests.torch_port_helpers import numpy_tree

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- Config and the experiment grid ------------------------------------------------


def test_config_round_trips_like_jax(tmp_path):
    (tmp_path / "base.py").write_text(
        "a = 1\nmodel = dict(backbone=dict(depth=50, shift=(1, 2)), head=[1, 2])\n"
        "data = dict(train=dict(alpha=0.5, pipeline=[dict(type='X')]))\n")
    (tmp_path / "child.py").write_text(
        "_base_ = ['base.py']\nimport os\nb = 'two'\nmodel = dict(backbone=dict(depth=18))\n")
    cfgs = [m.Config.fromfile(str(tmp_path / "child.py")) for m in (pconfig, jconfig)]
    assert cfgs[0].to_dict() == cfgs[1].to_dict()
    assert cfgs[0].model.backbone.shift == (1, 2) and cfgs[0].data.train.alpha == 0.5
    for c in cfgs:
        c.merge_from_dict({"data.train.alpha": 0.3, "model.backbone.depth": 34, "new.key": [1]})
    assert cfgs[0].to_dict() == cfgs[1].to_dict()
    for name, c in zip(("port", "jax"), cfgs):
        c.dump(str(tmp_path / f"{name}_dump.py"))
    assert (tmp_path / "port_dump.py").read_text() == (tmp_path / "jax_dump.py").read_text()
    again = pconfig.Config.fromfile(str(tmp_path / "port_dump.py"))
    assert again.to_dict() == cfgs[0].to_dict()


def _template_calls(path: pathlib.Path):
    """The keyword arguments of every make_cil_config(...) call in a config file."""
    calls = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "make_cil_config":
            assert not node.args
            calls.append({kw.arg: ast.literal_eval(kw.value) for kw in node.keywords})
    return calls


CONFIG_FILES = sorted(p for p in (ROOT / "configs").rglob("*.py") if p.name != "generate.py")


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: str(p.relative_to(ROOT / "configs")))
def test_make_cil_config_matches_jax_for_every_config_file(path, monkeypatch):
    monkeypatch.delenv("VIDEO_CIL_ROOT", raising=False)
    calls = _template_calls(path)
    assert calls, path
    for kwargs in calls:
        assert ptemplates.make_cil_config(**kwargs) == jtemplates.make_cil_config(**kwargs)


def test_preset_string_is_make_cil_config():
    want = jtemplates.make_cil_config("hmdb51", 1000, 6, "bgmix_plus_randAug")
    assert ptemplates.parse_preset("hmdb51:1000:6") == want
    want = jtemplates.make_cil_config("ucf101", 1993, 10, "predefined_background:bg_x")
    assert ptemplates.parse_preset("ucf101:1993:10:predefined_background:bg_x") == want
    with pytest.raises(ValueError):
        ptemplates.parse_preset("hmdb51:1000")


def test_result_table_matches_jax():
    rng = np.random.default_rng(0)
    accs = []
    for i in range(4):
        m = AverageMeter()
        for _ in range(i + 1):
            m.update(float(rng.choice([0.0, 100.0, 33.3333, 7.5])), int(rng.integers(1, 9)))
        accs.append(m)
    sizes = [26, 5, 5, 115]
    assert print_mean_accuracy(accs, sizes) == jax_print_mean_accuracy(accs, sizes)


# -- annotation files and the data module ------------------------------------------


def test_annotation_helpers_match_jax(tmp_path):
    splits = [[3, 1], [0], [2, 4]]
    assert pann.build_label_remap(splits) == jann.build_label_remap(splits)
    assert pann.accumulate_task_sizes(splits) == jann.accumulate_task_sizes(splits)
    recs = [jann.VideoRecord(f"v{i}", 8 + i, i % 5) for i in range(9)]
    jann.write_annotation_file(tmp_path / "j.txt", recs)
    pann.write_annotation_file(tmp_path / "p.txt", [pann.VideoRecord(*r.__dict__.values())
                                                    for r in recs])
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "p.txt").read_bytes()
    assert [r.__dict__ for r in pann.read_annotation_file(tmp_path / "j.txt")] == [
        r.__dict__ for r in jann.read_annotation_file(tmp_path / "j.txt")]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cil_data")
    frames, train_ann, val_ann = make_rawframe_tree(root / "data", num_classes=4,
                                                    videos_per_class=4, num_frames=8,
                                                    size=(64, 80))
    return root, frames, train_ann, val_ann


def config_dict(tree, work_dir, **overrides):
    root, frames, train_ann, val_ann = tree
    return make_cil_config(root, frames, train_ann, val_ann, work_dir, **overrides).to_dict()


class Controller:
    """What the data modules read of their trainer."""

    def __init__(self, num_tasks):
        self.current_task, self.num_tasks, self.mesh = 0, num_tasks, None


def data_modules(tree, tmp_path, **overrides):
    mods = []
    for name, cls, cfg_cls in (("port", CILDataModule, pconfig.Config),
                               ("jax", JaxDataModule, jconfig.Config)):
        cfg = config_dict(tree, tmp_path / name, **overrides)
        dm = cls(cfg_cls.fromdict(cfg))
        dm.controller = Controller(len(cfg["task_splits"]))
        dm.generate_annotation_file()
        mods.append(dm)
    return mods


def test_task_split_files_are_byte_identical(tree, tmp_path):
    port, ref = data_modules(tree, tmp_path)
    assert [p.name for p in port.task_splits_ann_files["train"]] == [
        p.name for p in ref.task_splits_ann_files["train"]]
    for kind in ("train", "val"):
        for p, j in zip(port.task_splits_ann_files[kind], ref.task_splits_ann_files[kind]):
            assert p.read_bytes() == j.read_bytes(), p.name


def _exemplar_meta(dm, task, per_class=2):
    """An exemplar selection of the first videos of each class of ``task``."""
    meta = {}
    infos = dm._build(dm.config.data.train, dm.task_splits_ann_files["train"][task]).video_infos
    for c in sorted({i["label"] for i in infos}):
        rows = [i for i in infos if i["label"] == c][:per_class]
        meta[c] = {"frame_dir": [i["frame_dir"] for i in rows],
                   "total_frames": np.array([i["total_frames"] for i in rows])}
    return meta


@pytest.mark.parametrize("policy", ["default", "keep_all_backgrounds", "cbf_full_bg"])
def test_exemplars_replay_and_cbf_dataset_match_jax(tree, tmp_path, policy):
    overrides = {policy: True} if policy != "default" else {}
    mods = data_modules(tree, tmp_path, **overrides)
    for dm in mods:
        dm.reload_train_dataset(exemplar=None, use_internal_exemplar=False)
        for t in range(2):
            dm.controller.current_task = t
            dm.build_exemplar_from_current_task(_exemplar_meta(dm, t))
            dm.controller.current_task = t + 1
            dm.reload_train_dataset(use_internal_exemplar=True)
    port, ref = mods
    for t in range(2):
        name = f"exemplar_task_{t}.txt"
        assert (port.exemplar_dir / name).read_bytes() == (ref.exemplar_dir / name).read_bytes()
    assert port.exemplar_size == ref.exemplar_size == 6
    assert port.train_dataset.video_infos == ref.train_dataset.video_infos
    assert port.train_dataset.bg_files == ref.train_dataset.bg_files
    pc, jc = port.build_cbf_dataset(), ref.build_cbf_dataset()
    assert pc.video_infos == jc.video_infos and len(pc) == 6
    assert sorted(pc.bg_files) == sorted(jc.bg_files)
    port.build_validation_datasets()
    ref.build_validation_datasets()
    merged = [port.get_test_dataset([0, 2], "val"), ref.get_test_dataset([0, 2], "val")]
    assert merged[0].video_infos == merged[1].video_infos


# -- the host pipeline ----------------------------------------------------------------


def _datasets(tree, tmp_path, which, test_crop=None):
    cfg = config_dict(tree, tmp_path)
    ds_cfg = copy.deepcopy(cfg["data"][which])
    if test_crop is not None:
        for op in ds_cfg["pipeline"]:
            if op["type"] == "CenterCrop":
                op["type"] = test_crop
    ds_cfg["ann_file"] = str(tree[2] if which == "train" else tree[3])
    return build_dataset(copy.deepcopy(ds_cfg)), jax_build_dataset(copy.deepcopy(ds_cfg))


@pytest.mark.parametrize("which,crop", [("train", None), ("val", None), ("val", "TenCrop")])
def test_host_pipeline_matches_jax_bit_for_bit(tree, tmp_path, which, crop):
    port, ref = _datasets(tree, tmp_path, which, crop)
    assert len(port) == len(ref) > 0
    seen_bg = seen_randaug = False
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for idx in range(len(ref)):
            got, want = port[idx], ref[idx]
            assert got.keys() == want.keys()
            for key in want:
                if key == "rng":
                    continue
                np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]),
                                              err_msg=f"{key} idx {idx} epoch {epoch}")
            seen_bg |= int(want.get("bg_idx", -1)) >= 0
            seen_randaug |= bool(want.get("randAug", False))
    if which == "train":  # both branches of the RandAugment / BGMix mutex ran
        assert seen_bg and seen_randaug
    if crop == "TenCrop":
        assert got["imgs"].shape[0] == 10 * 4


def test_host_loader_batches_match_jax(tree, tmp_path):
    port_ds, ref_ds = _datasets(tree, tmp_path, "train")
    kw = dict(batch_size=5, shuffle=True, num_workers=2, drop_last=False, pad_to_batch=True,
              seed=3)
    port = DataLoader(port_ds, **kw)
    ref = JaxDataLoader(ref_ds, process_index=0, process_count=1, **kw)
    assert len(port) == len(ref) == 3
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for got, want in zip(port, ref):
            assert got.keys() == want.keys()
            for key in want:
                np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]),
                                              err_msg=key)
    assert want["sample_weight"].tolist() == [1.0, 1.0, 0.0, 0.0, 0.0]


# -- herding ---------------------------------------------------------------------------


@pytest.mark.parametrize("storing,budget_type,cosine", [
    ("videos", "class", True), ("videos", "fixed", True), ("clips", "class", True),
    ("videos", "class", False)])
def test_herding_matches_jax(storing, budget_type, cosine):
    rng = np.random.default_rng(7)
    n, c = 23, 16
    shape = (n, 2, c) if storing == "videos" else (n, 3, 2, c)
    pred = {"repr_": rng.standard_normal(shape).astype(np.float32),
            "label": rng.integers(0, 3, n), "frame_dir": [f"/d/v{i}" for i in range(n)],
            "total_frames": rng.integers(8, 20, n), "cls_score": rng.random((n, 1, 3))}
    kw = dict(budget_size=4, class_indices=[0, 1, 2], cosine_distance=cosine,
              storing_methods=storing, budget_type=budget_type)
    got = Herding(**kw).construct_exemplar(copy.deepcopy(pred))
    want = JaxHerding(**kw).construct_exemplar(copy.deepcopy(pred))
    assert got.keys() == want.keys()
    for cls in want:
        assert got[cls]["indices"] == want[cls]["indices"]
        assert got[cls]["frame_dir"] == want[cls]["frame_dir"]
        assert got[cls]["dist"] == want[cls]["dist"]
        np.testing.assert_array_equal(got[cls]["class_mean"], want[cls]["class_mean"])
        np.testing.assert_array_equal(got[cls]["total_frames"], want[cls]["total_frames"])


# -- gradient accumulation -------------------------------------------------------------


OPT = dict(type="SGD", paramwise_cfg=dict(fc_lr_scale_factor=5.0), lr=0.05, momentum=0.9,
           weight_decay=1e-4)


def test_gradient_accumulation_matches_optax_multisteps():
    seg, hw, nc, b = 2, 32, 4, 3
    model_cfg = dict(
        type="CILRecognizer2D",
        backbone=dict(type="ResNetTSM", depth=18, num_segments=seg, shift_div=8),
        cls_head=dict(type="IncrementalTSMHead", num_classes=nc, in_channels=512,
                      inc_head_config=dict(type="LocalSimilarityClassifier", out_features=nc,
                                           nb_proxies=1),
                      num_segments=seg, loss_cls=dict(type="LSCLoss"), dropout_ratio=0.0),
    )
    rng = np.random.default_rng(11)
    xs = rng.standard_normal((4, b, seg, hw, hw, 3)).astype(np.float32)
    ys = rng.integers(0, nc, (4, b))
    sched = dict(type="StepLR", params=dict(step_size=1, gamma=0.5))

    jspec = jax_build_model(model_cfg)
    jvars = numpy_tree(jax_init(jspec, jax.random.PRNGKey(3), (1, seg, hw, hw, 3)))
    tx = jax_build_optimizer(jvars["params"], OPT, sched, steps_per_epoch=1, grad_clip=1.0,
                             accumulate_steps=2)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, jvars), tx)
    jstep = jax_make_train_step(jspec, tx, nc, donate=False)
    jlosses, jparams = [], []
    for s in range(4):
        jstate, m = jstep(jstate, None, jnp.asarray(xs[s]), jnp.asarray(ys[s]), {},
                          jax.random.PRNGKey(0))
        jlosses.append(float(m["loss"]))
        jparams.append(numpy_tree(jstate.params))

    spec = build_model(model_cfg, device="cpu")
    module = spec.module(nc)
    module.load_state_dict(from_jax_variables(jvars))
    ptx = build_optimizer(module, OPT, sched, steps_per_epoch=1, grad_clip=1.0,
                          accumulate_steps=2)
    state = TrainState.create(module, ptx)
    step = make_train_step(spec, ptx, nc)
    losses, params = [], []
    for s in range(4):
        state, m = step(state, None, torch.from_numpy(xs[s]), torch.from_numpy(ys[s]), {})
        losses.append(float(m["loss"]))
        params.append({k: v.detach().clone() for k, v in module.state_dict().items()})
    assert state.opt_state["count"] == 2 and state.step == 4
    assert all(p.grad is None for p in module.parameters())  # the window closed

    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    start = from_jax_variables(jvars)
    for name, p0 in start.items():
        if "running" in name:
            continue
        assert torch.equal(params[0][name], p0), name  # the first micro-step moves nothing
        assert torch.equal(params[2][name], params[1][name]), name
    for s in (1, 3):
        ref = from_jax_variables({"params": jparams[s], "batch_stats": jvars["batch_stats"]})
        for name, p0 in start.items():
            if "running" in name:
                continue
            dj, dp = (ref[name] - p0).numpy(), (params[s][name] - p0).numpy()
            assert np.abs(dj).max() > 0, name
            # in norm: the f32 updates of the two disagree beyond rounding in
            # places (tests/test_torch_port_cil_trainer.py, PARAM_TOL)
            rel = np.linalg.norm(dp - dj) / np.linalg.norm(dj)
            assert rel < 5e-2, f"{name} after micro-step {s + 1}: {rel}"


# -- ImageNet backbone weights from a local file --------------------------------------


def test_pretrained_backbone_loads_like_jax(tmp_path):
    from bdvcil_torch.models.pretrained import (apply_backbone_weights, load_checkpoint_file,
                                                load_torch_resnet_backbone)
    from bdvcil_tpu.models import pretrained as jpre

    seg, nc = 2, 3
    model_cfg = dict(
        type="CILRecognizer2D",
        backbone=dict(type="ResNetTSM", depth=18, num_segments=seg, shift_div=8),
        cls_head=dict(type="IncrementalTSMHead", num_classes=nc, in_channels=512,
                      inc_head_config=dict(type="LocalSimilarityClassifier", out_features=nc,
                                           nb_proxies=1),
                      num_segments=seg, loss_cls=dict(type="LSCLoss")),
    )
    spec = build_model(model_cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    # a torchvision-shaped file: backbone names, a classifier and BN counters
    tv = {k[len("backbone."):]: torch.randn(v.shape, generator=gen)
          for k, v in spec.module(nc).state_dict().items() if k.startswith("backbone.")}
    tv.update({"fc.weight": torch.randn(1000, 512), "fc.bias": torch.zeros(1000),
               "bn1.num_batches_tracked": torch.tensor(5)})
    torch.save(tv, tmp_path / "resnet18.pth")

    jspec = jax_build_model(model_cfg)
    jvars = numpy_tree(jax_init(jspec, jax.random.PRNGKey(0), (1, seg, 32, 32, 3)))
    jp, js = jpre.load_torch_resnet_backbone(jpre.load_checkpoint_file(str(tmp_path / "resnet18.pth")))
    ref = from_jax_variables(jpre.apply_backbone_weights(jvars, jp, js))

    module = spec.module(nc)
    module.load_state_dict(from_jax_variables(jvars))
    apply_backbone_weights(module, load_torch_resnet_backbone(
        load_checkpoint_file(str(tmp_path / "resnet18.pth"))))
    got = module.state_dict()
    assert got.keys() == ref.keys()
    for name in ref:
        assert torch.equal(got[name], ref[name].to(got[name].dtype)), name
    with pytest.raises(KeyError, match="unhandled"):
        apply_backbone_weights(module, {"layer9.0.conv1.weight": torch.zeros(1)})
