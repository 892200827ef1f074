"""The ``timesformer`` family and its cell ``divst_b16_hmdb51_train_task0``:
the committed configuration's published widths and the numbers they give,
the family's weights against the program's parameters and its decay
against the program's optimizer labels, and the cell rehearsed on the CPU
at a tiny size through the harness (correct untraced and traced; a broken
step, the fp8 control and half a batch fail its limits). The rehearsal's
tree is the committed R50 tree of ``tiny.py`` with this family's
configuration and cell added as files and entries."""

import json
import math

import pytest
import torch

from benchmark import attention, compare, harness, manifest
from benchmark.tests import tiny

SEED = 2**31 + 99991  # past 32 signed bits, as a run's seed may be
MAN = manifest.Manifest()
CELL, CONFIG = "divst_b16_hmdb51_train_task0", "timesformer_divst_b16_hmdb51"
TINY = dict(embed_dims=64, num_layers=2, num_heads=4, in_channels=64, crop_size=32,
            short_side=37, num_segments=2, videos_per_gpu=4, workers_per_gpu=1)
# at the tiny size, past the program's readings and below the fp8 control's
# and half a batch's (their readings at SEED: test_the_fp8_control_and_half_batch_fail_the_limits;
# the worst leaf: program 0.0053 / 0.0070, control 0.099 / 0.114)
TINY_LIMITS = {"grad_gap_matrix_median": 0.01, "change_gap_matrix_median": 0.01,
               "grad_gap": 0.03, "change_gap": 0.03}
# the TSM cells' per-layer metrics read on this cell, under names of its own
DIVST_TWINS = ("device_idle_share", "input_wait_ms", "producer_ms_per_batch",
               "step_dispatch_ms", "step_input_fn_ms", "step_forward_ms", "step_backward_ms",
               "step_optimizer_ms", "dispatch_offcpu_share")
ETA = "cls_head.eta"
PUBLISHED = dict(embed_dims=768, num_layers=12, num_heads=12, mlp_ratio=4, patch_size=16,
                 ln_eps=1e-6, drop_path_rate=0.1, num_segments=8, crop_size=224,
                 in_channels=768)


def _tiny_tree(tmp_path):
    """The R50 tiny tree with this family's configuration (tiny widths) and cell."""
    man = tiny.tiny_tree(tmp_path, "r50_hmdb51_train_task0")
    bench = man.dir
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(dict(MAN.config(CONFIG),
                                                                      **TINY)))
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(dict(
        MAN.cell(CELL), warmup_steps=4, followed_steps=3, trace_steps=2, limits=TINY_LIMITS)))
    data = json.loads(json.dumps(man.data))
    data["configs"].append(MAN.config_entry(CONFIG))
    data["workloads"].append(MAN.workload(CELL))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    return manifest.Manifest(tmp_path, bench)


def _run(tmp_path, trace=False, fault=None, variants=(), detail=False):
    man = _tiny_tree(tmp_path)
    return harness.run_cell(CELL, SEED, 0.5, trace, "cpu", 0.0, man=man,
                            corpus_root=tmp_path / "corpus", fault=fault, variants=variants,
                            readings=True, detail=detail, log=lambda msg: None)


def test_the_committed_configuration_has_the_published_widths():
    cfg = MAN.config(CONFIG)
    assert {k: cfg[k] for k in PUBLISHED} == PUBLISHED
    assert cfg["family"] == "timesformer" and MAN.config_entry(CONFIG)["reduced"] == []
    assert not {"depth", "shift_div", "shift_mode", "conv1x1_mode"} & set(cfg)
    r50 = MAN.config("tsm_r50_hmdb51")
    for key in ("dataset", "variant", "split_seed", "num_stages", "short_side", "nb_proxies",
                "dropout_ratio", "videos_per_gpu", "accumulate_grad_batches", "workers_per_gpu",
                "steps_per_dispatch", "compute_dtype", "lr", "momentum", "weight_decay",
                "fc_lr_scale_factor", "lsc_margin", "bgmix_alpha", "randaug_prob"):
        assert cfg[key] == r50[key], key
    assert MAN.workload(CELL)["traffic"] == MAN.workload("r50_hmdb51_train_task0")["traffic"]


def test_the_published_widths_give_the_flops_and_parameters():
    family, cfg = MAN.config_family(CONFIG), MAN.config(CONFIG)
    assert family.train_flops_per_clip(cfg) == pytest.approx(1.175e12, rel=5e-3)
    shapes = family.param_shapes(cfg, 26)
    backbone = sum(math.prod(s) for n, s in shapes.items() if n.startswith("backbone."))
    assert backbone == 121_258_752
    assert shapes["cls_head.fc_weights"] == (26, 768)


@pytest.mark.parametrize("change,named", [
    (dict(num_heads=10), "num_heads"), (dict(crop_size=220), "patch_size"),
    (dict(in_channels=512), "in_channels")], ids=["heads", "crop", "head_width"])
def test_an_inconsistent_configuration_is_refused(change, named):
    family = MAN.family("timesformer")
    family.check_config(dict(MAN.config(CONFIG), **TINY))  # small widths are fine
    with pytest.raises(ValueError, match=named):
        family.check_config(dict(MAN.config(CONFIG), **change))


def _program(cfg, num_classes):
    from bdvcil_torch.config import Config
    from bdvcil_torch.models import build_model

    c = harness.trainer_config(cfg, MAN.family("timesformer"), 0, "d", "w")
    return build_model(Config(c).model, device="cpu").module(num_classes)


@pytest.mark.parametrize("widths", ["tiny", "published"])
def test_the_weights_are_the_programs_parameters(widths):
    cfg = dict(MAN.config(CONFIG), **(TINY if widths == "tiny" else {}))
    family = MAN.family("timesformer")
    module = _program(cfg, 26)
    params = {n: tuple(p.shape) for n, p in module.named_parameters()}
    assert params == {n: tuple(s) for n, s in family.param_shapes(cfg, 26).items()}
    if widths == "tiny":
        weights = family.make_weights(cfg, 26, SEED, torch.device("cpu"))
        assert {n: tuple(w.shape) for n, w in weights.items()} == params
        assert all(w.dtype == torch.float32 for w in weights.values())
        again = family.make_weights(cfg, 26, SEED, torch.device("cpu"))
        assert all(torch.equal(weights[n], again[n]) for n in weights)


def test_decay_is_the_programs_label_policy():
    from bdvcil_torch.optim import GROUP_POLICY, label_params

    cfg = dict(MAN.config(CONFIG), **TINY)
    family = MAN.family("timesformer")
    ref_cfg = family.reference_config(cfg)
    labels = label_params(_program(cfg, 26))
    assert set(labels.values()) == {"norm", "embed", "normal_bias", "normal_weight",
                                    "classifier_weight"}
    for name, label in labels.items():
        want = ref_cfg["weight_decay"] if GROUP_POLICY[label][1] else 0.0
        assert family.decay(name, ref_cfg) == want, (name, label)


def test_rehearsal_untraced(tmp_path):
    res = _run(tmp_path)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_clips_per_s", "setup_s"}
    assert set(res["checks"]) == set(TINY_LIMITS)
    json.dumps(res)


def test_rehearsal_traced(tmp_path):
    from bdvcil_torch.ops._build import LAUNCHES

    before = dict(LAUNCHES)
    res = _run(tmp_path, trace=True)
    assert res["correct"], res["checks"]
    assert [m["name"] for m in MAN.per_layer(CELL)] == [
        "attn_temporal_ms.train", "attn_spatial_ms.train", "attention_roofline",
        "train_mfu.divst"] + [f"{base}.divst" for base in DIVST_TWINS]
    # off the card only the host's readers find something to read
    assert set(res["metrics"]) == {"input_wait_ms.divst", "producer_ms_per_batch.divst",
                                   "step_dispatch_ms.divst"}
    calls = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()}
    assert calls["attention.spatial.flash"] == calls["attention.temporal.matmul"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_broken_step_is_not_correct(tmp_path, fault):
    res = _run(tmp_path, fault=fault)
    assert not res["correct"], res["checks"]


def test_the_fp8_control_and_half_batch_fail_the_limits(tmp_path):
    res = _run(tmp_path, variants=("control", "half"), detail=True)
    readings = res["readings"]
    assert compare.verdict(readings["program"], TINY_LIMITS), readings["program"]
    assert not compare.verdict(readings["control"], TINY_LIMITS), readings["control"]
    assert not compare.verdict(readings["half"], TINY_LIMITS), readings["half"]
    # eta's scales are at least what they bound: its first gradient and its change
    ref = res["detail"]["reference"]
    scales = ref["scales"]
    assert scales["grad"][ETA] >= ref["grad_norms"][ETA] > 0
    assert scales["change"][ETA] >= ref["change_norms"][ETA] > 0


def test_eta_terms_add_up_to_eta_s_gradient():
    """Each row's share of the batch's loss, differentiated alone, sums to
    the batch's gradient of eta; the scale is the sum of their magnitudes."""
    from benchmark.reference import model, timesformer as ref

    gen = torch.Generator().manual_seed(SEED)
    scores = torch.randn(6, 5, generator=gen) * 0.3
    labels = torch.tensor([0, 1, 2, 3, 4, 0])
    weights = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0])
    eta = torch.tensor([1.3], requires_grad=True)
    total = weights.sum()
    (whole,) = torch.autograd.grad(model.lsc_loss(scores, labels, eta, weights, 0.6), eta)
    rows = []
    for r in range(6):
        loss = model.lsc_loss(scores[r:r + 1], labels[r:r + 1], eta, weights[r:r + 1],
                              0.6) * (weights[r] / total)
        rows.append(torch.autograd.grad(loss, eta)[0])
    assert torch.stack(rows).sum() == pytest.approx(float(whole), rel=1e-6)
    scale = ref.eta_terms(scores, labels, eta, weights, total, 0.6)
    assert float(scale) == pytest.approx(float(torch.stack(rows).abs().sum()), rel=1e-6)
    assert float(scale) > abs(float(whole))


def test_worst_gap_takes_a_leaf_over_its_scale():
    family = MAN.family("timesformer")
    ref_norms = {"a": 1.0, "b": 2.0, "c": 3.0, ETA: 0.5}
    norms = {"a": 1.01, "b": 2.0, "c": 3.0, ETA: 0.55}
    keep = list(ref_norms)
    # no scale: compare.norm_gap's worst leaf, eta over the median (1.5)
    assert family.worst_gap(norms, ref_norms, keep, {}) == compare.norm_gap(norms, ref_norms,
                                                                           keep)
    assert family.worst_gap(norms, ref_norms, keep, {}) == pytest.approx(0.05 / 1.5)
    # eta over its scale of 5: the worst leaf is a
    assert family.worst_gap(norms, ref_norms, keep, {ETA: 5.0}) == pytest.approx(0.01)
    # eta five times too small still reads past the limits
    wrong = dict(norms, **{ETA: 0.1})
    assert family.worst_gap(wrong, ref_norms, keep, {ETA: 5.0}) == pytest.approx(0.08)
    assert family.worst_gap(dict(norms, a=math.nan), ref_norms, keep, {}) == math.inf
    assert family.worst_gap({"a": 1.0}, ref_norms, keep, {}) == math.inf


def test_the_attention_arithmetic():
    """One spatial call at the published widths: 3 x 4 S H L² d operations
    and 2 x 4 S H L d bf16 elements; the step sums 12 layers."""
    f, b = attention.call_flops_bytes(24 * 8, 12, 197, 64)
    assert f == 3 * 4 * 24 * 8 * 12 * 197 ** 2 * 64
    assert b == 2 * 4 * 24 * 8 * 12 * 197 * 64 * 2
    cfg = MAN.config(CONFIG)
    spatial = attention.step_least_seconds(cfg, 24, temporal=False)
    both = attention.step_least_seconds(cfg, 24, temporal=True)
    assert spatial == pytest.approx(12 * max(b / 3.35e12, f / 989e12))
    assert both > spatial


def _span(name, start, wall, step):
    from bdvcil_torch.utils import profiling

    return profiling.Span(name, start, start + wall, 1, None, 0, None, 1, step)


def test_the_span_readers_sum_their_span_a_step(monkeypatch):
    from bdvcil_torch.utils import profiling

    table = [_span("model.attn_t", 0.0, 0.002, 0), _span("model.attn_s", 0.01, 0.005, 0),
             _span("model.attn_t", 0.1, 0.004, 1), _span("model.attn_s", 0.11, 0.007, 1),
             _span("model.mlp", 0.12, 0.009, 1)]
    monkeypatch.setattr(profiling, "spans", lambda run=None: list(table))
    obs = dict(device="cuda", slice=dict(steps=2, seconds=0.2, kernels=[], busy_s=0.1))
    assert MAN.reader("attn_temporal_ms.train")(obs) == pytest.approx(3.0)
    assert MAN.reader("attn_spatial_ms.train")(obs) == pytest.approx(6.0)
    for name in ("attn_temporal_ms.train", "attn_spatial_ms.train"):
        assert MAN.reader(name)(dict(obs, device="cpu")) is None
        assert MAN.reader(name)(dict(obs, slice=None)) is None
    monkeypatch.setattr(profiling, "spans", lambda run=None: [])
    assert MAN.reader("attn_spatial_ms.train")(obs) is None


@pytest.mark.parametrize("base", DIVST_TWINS)
def test_each_twin_is_its_train_metric_on_this_cell(monkeypatch, base):
    from bdvcil_torch.utils import profiling

    entries = {m["name"]: m for m in MAN.data["per_layer"]}
    twin, train = entries[f"{base}.divst"], entries[f"{base}.train"]
    assert {k: v for k, v in twin.items() if k not in ("name", "workloads")} == {
        k: v for k, v in train.items() if k not in ("name", "workloads")}
    assert twin["workloads"] == [CELL]
    table = [_span(name, 0.01 * i, 0.001 * (i + 1), 0)._replace(cpu_s=0.0005 * (i + 1))
             for i, name in enumerate(("step.input_fn", "step.forward", "step.backward",
                                       "step.optimizer"))]
    monkeypatch.setattr(profiling, "spans", lambda run=None: list(table))
    obs = dict(device="cuda", slice=dict(steps=2, seconds=0.2, kernels=[("k", 0.0, 1e4)],
                                         busy_s=0.15),
               window=dict(steps=4, wait_s=0.02, dispatch_s=[0.01, 0.03],
                           stats0=dict(batches=1.0, decode=1.0),
                           stats1=dict(batches=3.0, decode=2.0, probe=0.5)))
    value = MAN.reader(f"{base}.divst")(obs)
    assert value is not None and value == MAN.reader(f"{base}.train")(obs)


def test_the_roofline_and_mfu_readers(monkeypatch):
    from bdvcil_torch.ops import _build

    cfg = MAN.config(CONFIG)
    least = attention.step_least_seconds(cfg, 24, temporal=False)
    kernels = [("pytorch_flash::flash_fwd_kernel<x>", 0.0, least * 1e6),  # us
               ("pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel<x>", 0.0,
                least * 1e6),
               ("ampere_bf16_s16816gemm", 0.0, 5e3)]
    obs = dict(device="cuda", config=cfg, frames_per_step=24 * 8, flops_per_clip=1.175e12,
               slice=dict(steps=1, seconds=1.0, kernels=kernels, busy_s=1.0),
               window=dict(untraced=dict(seconds=2.0, clips=400)))
    monkeypatch.setattr(_build, "LAUNCHES", {"attention.spatial.flash": 12,
                                             "attention.temporal.matmul": 12})
    assert MAN.reader("attention_roofline")(obs) == pytest.approx(50.0)
    monkeypatch.setattr(_build, "LAUNCHES", {"attention.spatial.flash": 12,
                                             "attention.temporal.flash": 12})
    both = attention.step_least_seconds(cfg, 24, temporal=True)
    assert MAN.reader("attention_roofline")(obs) == pytest.approx(both / (2 * least) * 100)
    assert MAN.reader("attention_roofline")(dict(obs, device="cpu")) is None
    r50 = dict(obs, config=MAN.config("tsm_r50_hmdb51"))
    assert MAN.reader("attention_roofline")(r50) is None
    assert MAN.reader("train_mfu.divst")(obs) == pytest.approx(200 * 1.175e12 / 989e12 * 100)
    assert MAN.reader("train_mfu.divst")(dict(obs, device="cpu")) is None


def test_the_new_reference_and_family_take_nothing_of_the_program():
    """``test_h100bench_imports``' scans, run on this family's two files, and
    the reference imported alone loads neither the program nor JAX."""
    from benchmark.tests import test_h100bench_imports as imports

    here = manifest.HERE
    scanned = [here / "reference" / "timesformer.py", here / "families" / "timesformer.py"]
    for path in scanned:
        assert path.is_file()
        imports.test_reference_sources_name_no_program_module(path)
    names = imports._top_levels_after("from benchmark.reference import timesformer")
    assert not names & (imports.FORBIDDEN | {"bdvcil_torch"}), names
