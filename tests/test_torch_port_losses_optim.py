"""The port's losses, optimizer, head growth and weight converter against the
JAX package's, on the CPU, f32.

Tolerances: losses rtol 1e-6 (same formulas, f32); one and two optimizer
updates rtol 1e-6, atol 1e-7 (same per-leaf arithmetic); labels and
schedules exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bdvcil_tpu import losses as jax_losses
from bdvcil_tpu import optim as jax_optim
from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import update_fc as jax_update_fc
from bdvcil_tpu.models.recognizer import average_clips as jax_average_clips
from bdvcil_torch import losses
from bdvcil_torch import optim
from bdvcil_torch.models import (
    KD_TAPS, average_clips, build_model, from_jax_variables, init_model_params, to_jax_variables,
    update_fc,
)
from bdvcil_torch.models.convert import jax_path, torch_name
from tests.torch_port_helpers import T, model_cfg, to_torch

RTOL = 1e-6


def _jax_tree_shapes(depth, classifier, nc=5):
    in_ch = 2048 if depth == 50 else 512
    spec = jax_build_model(model_cfg(depth, "pad", "xla", nc, classifier=classifier,
                                     in_channels=in_ch))
    dummy = jnp.zeros((1, T, 32, 32, 3))
    return jax.eval_shape(lambda: spec.module().init(jax.random.PRNGKey(0), dummy))


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), dict(shapes))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# --- losses --------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_lsc_nca_and_cross_entropy_match_jax(weighted):
    rng = np.random.default_rng(0)
    sims = rng.uniform(-1, 1, (6, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 6)
    eta = np.array([1.7], np.float32)
    w = (rng.random(6) > 0.3).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else to_torch(w)
    for margin, hinge in [(0.6, True), (0.1, False)]:
        ref = jax_losses.lsc_nca_loss(jnp.asarray(sims), jnp.asarray(labels), jnp.asarray(eta),
                                      margin=margin, hinge_proxynca=hinge, sample_weights=jw)
        got = losses.lsc_nca_loss(to_torch(sims), torch.from_numpy(labels), to_torch(eta),
                                  margin=margin, hinge_proxynca=hinge, sample_weights=tw)
        np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)
    ref = jax_losses.cross_entropy(jnp.asarray(sims * 5), jnp.asarray(labels), jw)
    got = losses.cross_entropy(to_torch(sims * 5), torch.from_numpy(labels), tw)
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def test_lsc_nca_gradient_matches_jax():
    rng = np.random.default_rng(1)
    sims = rng.uniform(-1, 1, (5, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 5)
    eta = np.array([2.0], np.float32)
    jg = jax.grad(lambda s, e: jax_losses.lsc_nca_loss(s, jnp.asarray(labels), e),
                  argnums=(0, 1))(jnp.asarray(sims), jnp.asarray(eta))
    ts, te = to_torch(sims).requires_grad_(True), to_torch(eta).requires_grad_(True)
    losses.lsc_nca_loss(ts, torch.from_numpy(labels), te).backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jg[1]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("exemplar_only", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_feature_kd_loss_matches_jax(exemplar_only, weighted):
    rng = np.random.default_rng(2)
    b = 3
    shapes = {"backbone.layer1": (b * T, 4, 4, 8), "backbone.layer2": (b * T, 2, 2, 16),
              "cls_head.avg_pool": (b * T, 16)}
    cur = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    prev = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    labels = np.array([0, 3, 1])
    w = np.array([1.0, 1.0, 0.0], np.float32) if weighted else None
    kw = dict(module_names=list(shapes), module_weights=[3.0, 3.0, 0.1], scale_factor=2.5,
              prev_num_classes=2, exemplar_only=exemplar_only, num_segments=T)
    ref = jax_losses.feature_kd_loss(
        {k: jnp.asarray(v) for k, v in cur.items()}, {k: jnp.asarray(v) for k, v in prev.items()},
        labels=jnp.asarray(labels), sample_weights=None if w is None else jnp.asarray(w), **kw)
    got = losses.feature_kd_loss(
        {k: to_torch(v) for k, v in cur.items()}, {k: to_torch(v) for k, v in prev.items()},
        labels=torch.from_numpy(labels), sample_weights=None if w is None else to_torch(w), **kw)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=RTOL, err_msg=key)


def test_soft_target_ce_and_average_clips_match_jax():
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((4, 3, 6)).astype(np.float32)
    targets = rng.dirichlet(np.ones(6), 4).astype(np.float32)
    ref = jax_losses.soft_target_ce(jnp.asarray(scores[:, 0]), jnp.asarray(targets))
    got = losses.soft_target_ce(to_torch(scores[:, 0]), to_torch(targets))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)
    for mode in ("prob", "score", None):
        np.testing.assert_allclose(average_clips(to_torch(scores), mode).numpy(),
                                   np.asarray(jax_average_clips(jnp.asarray(scores), mode)),
                                   rtol=RTOL, atol=1e-7)


# --- converter and labels --------------------------------------------------------


@pytest.mark.parametrize("classifier", ["LocalSimilarityClassifier", "SimpleLinear"])
def test_converter_maps_every_leaf_both_ways(classifier):
    depth = 50 if classifier == "LocalSimilarityClassifier" else 18
    shapes = _jax_tree_shapes(depth, classifier)
    variables = _random_tree(shapes, seed=4)
    spec = build_model(model_cfg(depth, "pad", "xla", 5, classifier=classifier,
                                 in_channels=2048 if depth == 50 else 512), device="cpu")
    model = spec.module()
    sd = from_jax_variables(variables)
    assert set(sd) == set(model.state_dict())  # every port entry comes from a JAX leaf
    model.load_state_dict(sd, strict=True)
    back = to_jax_variables(model.state_dict())
    ref_leaves = dict(_leaves(variables))
    got_leaves = dict(_leaves(back))
    assert set(ref_leaves) == set(got_leaves)
    for path, val in ref_leaves.items():
        np.testing.assert_array_equal(got_leaves[path], val, err_msg="/".join(path))
        assert jax_path(torch_name(path[0], path[1:])) == (path[0], path[1:])


def test_label_params_equal_jax_leaf_for_leaf_on_r50_lsc():
    params = dict(_jax_tree_shapes(50, "LocalSimilarityClassifier"))["params"]
    jax_labels = dict(_leaves(jax_optim.label_params(params)))
    spec = build_model(model_cfg(50, "pad", "xla", 5), device="cpu")
    port_labels = optim.label_params(spec.module())
    assert len(port_labels) == len(jax_labels)
    for path, label in jax_labels.items():
        assert port_labels[torch_name("params", path)] == label, path
    assert set(jax_labels.values()) == {"first_conv_weight", "normal_weight", "bn",
                                        "classifier_weight"}


@pytest.mark.parametrize("kind,params", [
    ("MultiStepLR", dict(milestones=[3, 7], gamma=0.1)),
    ("CosineAnnealingLR", dict(T_max=10, eta_min=1e-4)),
    ("StepLR", dict(step_size=4, gamma=0.5)),
    ("LinearLR", dict(start_factor=0.25, total_iters=4)),
])
def test_lr_factors_match_jax(kind, params):
    cfg = dict(type=kind, params=params)
    ref = jax_optim.build_lr_factor_fn(cfg, base_lr=0.01)
    got = optim.build_lr_factor_fn(cfg, base_lr=0.01)
    assert [got(e) for e in range(15)] == [ref(e) for e in range(15)]


# --- one optimizer update -----------------------------------------------------------


@pytest.mark.parametrize("freeze_backbone", [False, True])
@pytest.mark.parametrize("grad_scale", [1.0, 1e-4])  # the clip triggers / does not
def test_optimizer_updates_match_optax(freeze_backbone, grad_scale):
    shapes = _jax_tree_shapes(18, "LocalSimilarityClassifier")
    variables = _random_tree(shapes, seed=5)
    spec = build_model(model_cfg(18, "pad", "xla", 5, in_channels=512), device="cpu")
    model = spec.module()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    opt_cfg = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4,
                   paramwise_cfg=dict(fc_lr_scale_factor=5.0))
    sched = dict(type="MultiStepLR", params=dict(milestones=[1], gamma=0.1))
    kw = dict(steps_per_epoch=1, grad_clip=1.0, freeze_backbone=freeze_backbone)

    jparams = jax.tree.map(jnp.asarray, variables["params"])
    tx = jax_optim.build_optimizer(jparams, opt_cfg, sched, **kw)
    jstate = tx.init(jparams)
    ptx = optim.build_optimizer(model, opt_cfg, sched, **kw)
    pstate = ptx.init(model)
    for s in range(2):  # epoch 0 then epoch 1 (the schedule drops the lr)
        grads = jax.tree.map(lambda a: a * grad_scale,
                             _random_tree(jax.tree.map(lambda a: jax.ShapeDtypeStruct(
                                 a.shape, a.dtype), jparams), seed=10 + s))
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        port_grads = from_jax_variables({"params": grads})
        for name, p in model.named_parameters():
            p.grad = port_grads[name].clone()
        pstate = ptx.step(model, pstate)

    got = dict(_leaves(to_jax_variables(model.state_dict())["params"]))
    for path, ref in _leaves(jax.tree.map(np.asarray, jparams)):
        np.testing.assert_allclose(got[path], ref, rtol=RTOL, atol=1e-7, err_msg="/".join(path))
    if freeze_backbone:
        np.testing.assert_array_equal(got[("backbone", "conv1", "kernel")],
                                      variables["params"]["backbone"]["conv1"]["kernel"])


# --- head growth -----------------------------------------------------------------------


@pytest.mark.parametrize("classifier", ["LocalSimilarityClassifier", "SimpleLinear"])
def test_update_fc_keeps_old_rows_and_grows_like_jax(classifier):
    spec = build_model(model_cfg(18, "pad", "xla", 4, classifier=classifier, in_channels=512),
                       device="cpu")
    model = init_model_params(spec, 0)
    head = model.cls_head
    name = "fc_weights" if classifier == "LocalSimilarityClassifier" else "fc_weight"
    old = getattr(head, name).detach().clone()
    update_fc(model, 9, torch.Generator().manual_seed(1))
    new = getattr(head, name).detach()
    assert head.num_classes == 9 and new.shape == (9, 512)
    assert torch.equal(new[:4], old)
    # new rows are kaiming-normal N(0, 1/fan_in), as the JAX growth draws them
    assert abs(float(new[4:].std()) * np.sqrt(512) - 1.0) < 0.1
    jax_head = {name: jnp.asarray(old.numpy())}
    if classifier == "SimpleLinear":
        jax_head["fc_bias"] = jnp.asarray(head.fc_bias.detach()[:4].numpy())
        np.testing.assert_array_equal(head.fc_bias.detach()[4:].numpy(), np.zeros(5))
    grown = jax_update_fc({"head": jax_head}, 9, jax.random.PRNGKey(0), classifier)["head"]
    assert grown[name].shape == tuple(new.shape)
    with pytest.raises(ValueError):
        update_fc(model, 3)


def test_kd_tap_names_match_jax():
    spec = jax_build_model(model_cfg(18, "pad", "xla", 3, in_channels=512))
    out = jax.eval_shape(
        lambda: spec.module().init_with_output(jax.random.PRNGKey(0),
                                               jnp.zeros((1, T, 32, 32, 3)))[0])
    assert tuple(sorted(out["feats"])) == tuple(sorted(KD_TAPS))
