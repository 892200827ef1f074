"""``bdvcil_torch/models/timesformer.py``, TimeSformer with divided
space-time attention, on the port's normal path, held against the plain
reference ``bdvcil_torch/reference_loop/timesformer.py`` at small widths on
the CPU (embed 64, 4 heads, 2 layers, 3 frames, 32² crops, patch 16):

  * the forward's LSC scores in float32, eval and train (drop path and
    dropout replayed from the same generator seed), within 1e-5 relative;
  * the first step's gradient of every leaf within 1e-4 relative;
  * bfloat16 within a stated tolerance of the float32 reference;
  * a structure neither implementation could share a mistake on: with
    ``time_embed`` zeroed and no drop path, permuting the frames leaves the
    cls feature as it is (a wrong ``(p, t)`` token order breaks this);
  * ``build_model``'s dispatch, the clip path of the recognizer (crops x clips
    groups), the KD taps, the spans and the attention path counter, the
    optimizer's labels (TSM-R50 and TSM-R34 keep theirs leaf for leaf);
  * ``CILTrainer`` trains two tasks of the synthetic tree with the base
    method: KD from task 1, eval, herding.
"""

import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bdvcil_torch.losses import lsc_nca_loss
from bdvcil_torch.models import build_model, init_model_params
from bdvcil_torch.models import timesformer as tsf
from bdvcil_torch.ops import _build
from bdvcil_torch.optim import label_params
from bdvcil_torch.reference_loop import timesformer as ref
from bdvcil_torch.utils import profiling
from tests.torch_port_helpers import model_cfg

T, SIZE, M, HEADS, LAYERS, CLASSES = 3, 32, 64, 4, 2, 5
DROP_PATH, DROPOUT = 0.3, 0.5
REF_CFG = dict(patch_size=16, num_heads=HEADS, num_layers=LAYERS, ln_eps=1e-6,
               drop_path_rate=DROP_PATH)
# bf16 against the f32 reference: every product rounds its operands to 8
# bits of mantissa (2^-9 relative) and the residual stream is stored in bf16
# through 2 layers, so a cosine score moves by a few 2^-9 (measured 1.8e-3 to
# 3.4e-3 on scores up to 0.33 over four seeds); 1e-2 leaves 3x that
BF16_ATOL = 1e-2


def tsf_cfg(layers=LAYERS, frames=T, drop_path=DROP_PATH, size=SIZE, patch=16, dims=M,
            heads=HEADS):
    return dict(
        type="CILRecognizer2D",
        backbone=dict(type="TimeSformer", num_frames=frames, img_size=size, patch_size=patch,
                      embed_dims=dims, num_heads=heads, num_transformer_layers=layers,
                      drop_path_rate=drop_path),
        cls_head=dict(type="IncrementalTSMHead", num_classes=CLASSES, in_channels=dims,
                      num_segments=1,
                      inc_head_config=dict(type="LocalSimilarityClassifier", nb_proxies=1),
                      loss_cls=dict(type="LSCLoss"), dropout_ratio=DROPOUT),
        test_cfg=dict(average_clips="prob"))


def seeded_module(dtype=torch.float32, seed=0, **kw):
    """The program's module with seeded random weights (every leaf drawn, so
    no path is silent), and the f32 weight dict the reference takes."""
    spec = build_model(tsf_cfg(**kw), dtype=dtype, device="cpu")
    module = init_model_params(spec, 0)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            scale = p.shape[-1] ** -0.5 if p.dim() >= 2 and "embed" not in name else 0.1
            p.copy_(torch.randn(p.shape, generator=gen) * scale + (1.0 if "norm.weight" in name
                                                                  else 0.0))
    return spec, module, {n: p.detach().clone() for n, p in module.named_parameters()}


def clips(b=4, seed=1, frames=T):
    return torch.randn(b, frames, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(seed))


def rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_the_f32_forward_is_the_references(mode):
    _, module, w = seeded_module()
    x = clips()
    if mode == "eval":
        got = module(x, train=False)["cls_score"][:, 0]
        want = ref.forward(w, x, REF_CFG)
    else:
        got = module(x, train=True, generator=torch.Generator().manual_seed(11))["cls_score"][:, 0]
        want = ref.forward(w, x, REF_CFG, DROPOUT, torch.Generator().manual_seed(11))
    assert rel(got, want) <= 1e-5, (mode, rel(got, want))


def test_drop_path_and_dropout_draw_the_same_units_from_the_generator():
    """The train forward differs from the eval one, and another seed draws
    other masks: the replay is not vacuous."""
    _, module, w = seeded_module()
    x = clips()
    a = module(x, train=True, generator=torch.Generator().manual_seed(11))["cls_score"]
    b = module(x, train=True, generator=torch.Generator().manual_seed(12))["cls_score"]
    c = module(x, train=False)["cls_score"]
    assert rel(a, b) > 1e-2 and rel(a, c) > 1e-2


def test_the_first_steps_gradients_are_the_references():
    _, module, w = seeded_module()
    x, labels = clips(), torch.tensor([0, 3, 1, 4])
    out = module(x, train=True, generator=torch.Generator().manual_seed(21))
    lsc_nca_loss(out["cls_score"][:, 0], labels, module.cls_head.eta).backward()
    leaves = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    scores = ref.forward(leaves, x, REF_CFG, DROPOUT, torch.Generator().manual_seed(21))
    grads = torch.autograd.grad(lsc_nca_loss(scores, labels, leaves["cls_head.eta"]),
                                list(leaves.values()))
    worst = {}
    for (name, p), g in zip(dict(module.named_parameters()).items(), grads):
        assert g.norm() > 0, name
        worst[name] = rel(p.grad, g)
    assert max(worst.values()) <= 1e-4, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


def test_bf16_is_the_f32_reference_within_its_rounding():
    _, module, w = seeded_module(dtype=torch.bfloat16)
    x = clips()
    got = module(x.to(torch.bfloat16), train=False)["cls_score"][:, 0].float()
    want = ref.forward(w, x, REF_CFG)
    assert float((got - want).detach().abs().max()) <= BF16_ATOL


def test_permuting_frames_leaves_the_cls_feature_without_time_embed():
    _, module, _ = seeded_module(drop_path=0.0)
    with torch.no_grad():
        module.backbone.time_embed.zero_()
    x = clips().permute(0, 1, 4, 2, 3)  # (N, T, C, H, W), the backbone's input
    perm = torch.tensor([2, 0, 1])
    a = module.backbone(x)["out"]
    b = module.backbone(x[:, perm])["out"]
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)  # f32 rounding of values ~3
    # the patches of a frame are not exchangeable: a spatial shuffle moves it
    c = module.backbone(x.flip(-1))["out"]
    assert not torch.allclose(a, c, rtol=1e-3, atol=1e-3)
    # and time_embed makes the frame order matter
    with torch.no_grad():
        module.backbone.time_embed.normal_(0.0, 0.5)
    assert not torch.allclose(module.backbone(x)["out"], module.backbone(x[:, perm])["out"],
                              rtol=1e-3, atol=1e-3)


def test_the_recognizer_scores_each_crop_and_clip_group():
    """(B, G T, H, W, C): G groups of T frames, each a clip of its own."""
    spec, module, _ = seeded_module()
    x = clips(b=6).reshape(2, 3 * T, SIZE, SIZE, 3)
    out = module(x, train=False)
    assert out["cls_score"].shape == (2, 3, CLASSES) and out["repr"].shape == (2, 3, M)
    each = module(clips(b=6), train=False)["cls_score"][:, 0]
    assert torch.allclose(out["cls_score"].reshape(6, CLASSES), each, atol=1e-6)
    assert spec.num_segments == T and spec.head_kwargs["num_segments"] == 1
    tokens = 1 + (SIZE // 16) ** 2 * T
    for k in range(1, 5):
        assert out["feats"][f"backbone.layer{k}"].shape == (6, tokens, M)
    assert out["feats"]["cls_head.avg_pool"].shape == (6, M)


def test_the_tencrop_eval_step_scores_ten_clips_a_video():
    """uint8 TenCrop frames (B, T, 5, h, w, C) through ``make_eval_step``:
    ten clips of T frames a video, each the clip scored alone."""
    from bdvcil_torch.ops.augment import normalize_batch, tencrop_expand
    from bdvcil_torch.runtime import make_eval_step

    spec, module, _ = seeded_module()
    frames = torch.randint(0, 256, (2, T, 5, SIZE, SIZE, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    out = make_eval_step(spec, CLASSES)(module, frames)
    assert out["cls_score"].shape == (2, 10, CLASSES) and out["repr"].shape == (2, 10, M)
    clips = normalize_batch(tencrop_expand(frames)).reshape(20, T, SIZE, SIZE, 3)
    with torch.no_grad():
        each = module(clips, train=False)["cls_score"][:, 0]
    assert torch.allclose(out["cls_score"].reshape(20, CLASSES), each, atol=1e-6)


@pytest.mark.parametrize("layers,taps", [(12, (3, 6, 9, 12)), (2, (1, 1, 1, 2)),
                                         (4, (1, 2, 3, 4))])
def test_the_kd_taps_sit_at_the_quarter_points(layers, taps):
    backbone = tsf.TimeSformer(num_frames=2, img_size=16, patch_size=16, embed_dims=8,
                               num_heads=2, num_transformer_layers=layers, device="cpu")
    served = {name: i + 1 for i, names in backbone.taps.items() for name in names}
    assert tuple(served[f"layer{k}"] for k in range(1, 5)) == taps


def test_build_model_dispatches_on_the_backbone_type():
    with pytest.raises(ValueError, match="unknown backbone"):
        cfg = tsf_cfg()
        cfg["backbone"]["type"] = "ViT"
        build_model(cfg, device="cpu")
    cfg = tsf_cfg()
    cfg["backbone"]["attention_type"] = "joint_space_time"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu")
    spec = build_model(model_cfg(18, "pad", "xla", 3, in_channels=512), device="cpu")
    assert spec.backbone_type == "ResNetTSM" and spec.num_segments == spec.head_kwargs[
        "num_segments"]
    assert spec.frames_per_clip is None and spec.module(3).backbone.frames_per_clip is None
    spec = build_model(tsf_cfg(frames=4), device="cpu")
    assert spec.backbone_type == "TimeSformer" and spec.frames_per_clip == 4
    assert spec.num_segments == 4 and spec.module(3).backbone.frames_per_clip == 4


def test_the_embeddings_start_from_mmcv_s_normal_of_std_0_02():
    """mmcv's ``trunc_normal_(std=0.02)`` cuts at the absolute -2 and 2, so
    ``pos_embed`` and ``cls_token`` start from an all but uncut N(0, 0.02²):
    a cut at 2 sigma would read a std near 0.0176 and nothing past 0.04."""
    spec = build_model(tsf_cfg(size=256, patch=4, dims=64), device="cpu")
    backbone = init_model_params(spec, 3).backbone
    w = backbone.pos_embed.detach().flatten()
    assert w.numel() == 4097 * 64
    assert abs(float(w.std()) - 0.02) < 0.0005
    assert float(w.abs().max()) > 0.06
    assert not backbone.time_embed.any()


def test_the_published_widths_hold_121m_parameters():
    spec = build_model(tsf_cfg(layers=12, frames=8, size=224, dims=768, heads=12), device="meta")
    module = spec.module(26)
    backbone = sum(p.numel() for n, p in module.named_parameters() if n.startswith("backbone."))
    assert backbone == 121_258_752


def test_the_spans_nest_under_a_profiler_and_vanish_without():
    spec, module, _ = seeded_module()
    x = clips()
    n = len(profiling.BOOK.records)
    module(x, train=True, generator=torch.Generator().manual_seed(0))
    assert len(profiling.BOOK.records) == n
    profiling.new_run()
    with profile(activities=[ProfilerActivity.CPU]):
        module(x, train=True, generator=torch.Generator().manual_seed(0))
    spans = profiling.spans()
    names = [s.name for s in spans]
    assert names.count("model.embed") == 1 and names.count("model.block") == LAYERS
    blocks = {s.id for s in spans if s.name == "model.block"}
    for name in ("model.attn_t", "model.attn_s", "model.mlp"):
        inner = [s for s in spans if s.name == name]
        assert len(inner) == LAYERS and all(s.parent in blocks for s in inner), name


def test_the_attention_path_counter_reads_the_pinned_backend():
    _, module, _ = seeded_module()
    before = dict(_build.LAUNCHES)
    module(clips(), train=False)
    calls = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
             if v != before.get(k, 0)}
    assert calls == {"attention.temporal.matmul": LAYERS, "attention.spatial.flash": LAYERS}
    q = torch.zeros(1, 1, 2, 8)
    assert tsf.attention_backend(q) == "flash"
    assert tsf.attention_backend(torch.zeros(1, 1, 2, 8, device="meta")) == "flash"


def test_every_timesformer_leaf_gets_its_optimizer_label():
    _, module, _ = seeded_module()
    labels = label_params(module)
    for name, label in labels.items():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("cls_head."):
            want = "classifier_weight"
        elif ".norm." in name:
            want = "norm"
        elif leaf in ("cls_token", "pos_embed", "time_embed"):
            want = "embed"
        elif leaf in ("bias", "in_proj_bias"):
            want = "normal_bias"
        else:
            want = "normal_weight"
        assert label == want, (name, label)
    assert set(labels.values()) == {"classifier_weight", "norm", "embed", "normal_bias",
                                    "normal_weight"}


def _tsm_labels_before_timesformer(module):
    """``label_params`` as the TSM path had it before the TimeSformer labels."""
    from bdvcil_torch.models.norm import BatchNorm

    bn = {f"{mn}.{pn}" if mn else pn for mn, mod in module.named_modules()
          if isinstance(mod, BatchNorm) for pn, _ in mod.named_parameters(recurse=False)}
    out = {}
    for name, _ in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        out[name] = ("classifier_weight" if leaf in ("fc_weights", "fc_weight", "eta") else
                     "classifier_bias" if leaf == "fc_bias" else "bn" if name in bn else
                     "normal_bias" if leaf == "bias" else
                     "first_conv_weight" if name == "backbone.conv1.weight" else "normal_weight")
    return out


@pytest.mark.parametrize("depth,width", [(50, 2048), (34, 512)])
def test_the_tsm_labels_are_unchanged(depth, width):
    spec = build_model(model_cfg(depth, "pad", "xla", 26, in_channels=width), device="meta")
    module = spec.module()
    assert label_params(module) == _tsm_labels_before_timesformer(module)


def test_train_cil_runs_two_tasks_with_kd_eval_and_herding(tmp_path):
    from bdvcil_torch.cil import CILTrainer
    from bdvcil_torch.config import Config
    from tests.synthetic import make_rawframe_tree
    from tests.test_cil_e2e import make_cil_config

    frames, train_ann, val_ann = make_rawframe_tree(tmp_path / "data", num_classes=3,
                                                    videos_per_class=3, num_frames=8,
                                                    size=(70, 92))
    model = tsf_cfg(layers=4, frames=4, size=56, patch=14, dims=32, heads=2)
    model["cls_head"]["num_classes"] = 2
    cfg = make_cil_config(tmp_path, frames, train_ann, val_ann, tmp_path / "wd",
                          task_splits=[[0, 1], [2]], ending_task=1, model=model,
                          videos_per_gpu=2, kd_modules_names=["backbone.layer2",
                                                              "backbone.layer4",
                                                              "cls_head.avg_pool"],
                          kd_weight_by_module=[0.01, 0.01, 0.01]).to_dict()
    trainer = CILTrainer(Config.fromdict(copy.deepcopy(cfg)), device="cpu")
    trainer.train()
    assert len(trainer.cnn_matrix) == 2 and len(trainer.nme_matrix) == 2
    assert (tmp_path / "wd" / "ckpt" / "ckpt_task_1.pt").exists()
    assert trainer._kd_config() is not None  # task 1 distilled through the taps
    assert len(trainer.data_module.exemplar_datasets) >= 1
