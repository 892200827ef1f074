"""The port's iCaRL methods (bdvcil_torch/runtime/steps.py) and ActorCutMix
smoothing (bdvcil_torch/losses.py) against the JAX package's, on the CPU, f32.

  * ``acm_smooth_targets`` and ``acm_smooth_ce``, with and without
    ``buggy_sign``: rtol 1e-6;
  * 'icarl' (with and without the ActorCutMix fields in ``extra``) and
    'icarl_video_mix' over 4 coupled steps of R18 with the LSC head: 2 at
    task 0 (one-hot / smoothed targets), growth 4 -> 6 with the grown rows
    copied from the JAX side, 2 at task 1 (the previous model's softmax as
    the targets of old-class samples). For 'icarl_video_mix' the port's
    ``draw_tubemix`` is patched to return the draws JAX made from the step's
    key (applied at 3 of the 4 steps). Losses, the classifier and
    layer4_0/conv1 after the last step within rtol 2e-3, atol 2e-4
    (tests/test_torch_port_train.py).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu import losses as jlosses
from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import init_model_params as jax_init
from bdvcil_tpu.optim import build_optimizer as jax_build_optimizer
from bdvcil_tpu.runtime import TrainState as JaxTrainState
from bdvcil_tpu.runtime import make_train_step as jax_make_train_step
from bdvcil_torch import losses as plosses
from bdvcil_torch.models import build_model, from_jax_variables
from bdvcil_torch.optim import build_optimizer
from bdvcil_torch.runtime import TrainState, make_train_step, steps
from tests.torch_port_helpers import (T, grow_like_jax, jax_tubemix_draws, model_cfg, numpy_tree,
                                      to_torch)

HW, B = 32, 4
OPT = dict(type="SGD", constructor="CILTSMOptimizerConstructorImprovised",
           paramwise_cfg=dict(fc_lr_scale_factor=5.0), lr=0.004, momentum=0.9,
           weight_decay=1e-4)
TOL = dict(rtol=2e-3, atol=2e-4)
VIDEO_MIX = dict(alpha=1.0, prob=0.5)


@pytest.mark.parametrize("buggy_sign", [False, True])
def test_acm_smooth_ce_matches_jax(buggy_sign):
    rng = np.random.default_rng(0)
    nc = 7
    score = rng.standard_normal((6, nc)).astype(np.float32)
    labels = rng.integers(0, nc, size=6)
    bg = rng.integers(-1, nc, size=6)
    bg[0] = -1
    fg = rng.random(6).astype(np.float32)
    fg[1] = 1.0
    ref_t = jlosses.acm_smooth_targets(jnp.asarray(labels), jnp.asarray(bg), jnp.asarray(fg), nc)
    got_t = plosses.acm_smooth_targets(torch.from_numpy(labels), torch.from_numpy(bg),
                                       torch.from_numpy(fg), nc)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=1e-6, atol=1e-7)
    ref = jlosses.acm_smooth_ce(jnp.asarray(score), jnp.asarray(labels), jnp.asarray(bg),
                                jnp.asarray(fg), nc, buggy_sign=buggy_sign)
    got = plosses.acm_smooth_ce(to_torch(score), torch.from_numpy(labels), torch.from_numpy(bg),
                                torch.from_numpy(fg), nc, buggy_sign=buggy_sign)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    assert (float(got) < 0) == buggy_sign


def _step_keys(n):
    """Step keys whose tube-CutMix applies at every step but the second."""
    want, keys, i = [True, False] + [True] * (n - 2), [], 0
    while len(keys) < n:
        key = jax.random.PRNGKey(100 + i)
        mix_key = jax.random.split(key)[0]
        if bool(jax_tubemix_draws(mix_key, B, HW, HW, **VIDEO_MIX)["apply"]) == want[len(keys)]:
            keys.append(key)
        i += 1
    return keys


@pytest.mark.parametrize("method,acm", [("icarl", False), ("icarl", True),
                                        ("icarl_video_mix", False)])
def test_icarl_coupled_steps_match_jax(method, acm, monkeypatch):
    nc0, nc1 = 4, 6
    cfg = model_cfg(18, "pad", "xla", nc0, in_channels=512)
    cfg["test_cfg"] = dict(average_clips="score")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, B, T, HW, HW, 3)).astype(np.float32)
    labels = [rng.integers(0, nc0, size=B) for _ in range(2)]
    labels += [np.array([0, 5, 2, 4]), np.array([4, 1, 5, 3])]  # old and new classes at task 1
    extras = [{} for _ in range(4)]
    if acm:
        for e in extras:
            e.update(foreground_ratio=rng.random(B).astype(np.float32),
                     background_label=rng.integers(-1, nc0, size=(B, 1)))
    keys = _step_keys(4)
    video_mix = VIDEO_MIX if method == "icarl_video_mix" else None

    # ---- JAX ------------------------------------------------------------
    jspec = jax_build_model(cfg)
    jvars = numpy_tree(jax_init(jspec, jax.random.PRNGKey(0), (1, T, HW, HW, 3)))
    tx = jax_build_optimizer(jvars["params"], OPT)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, jvars), tx)
    jstep = jax_make_train_step(jspec, tx, nc0, method=method, video_mix=video_mix, donate=False)
    jax_losses = []
    jextra = [{k: jnp.asarray(v) for k, v in e.items()} for e in extras]
    for s in range(2):
        jstate, m = jstep(jstate, None, jnp.asarray(x[s]), jnp.asarray(labels[s]), jextra[s],
                          keys[s])
        jax_losses.append(float(m["loss"]))
    jprev = jspec.grow_params(jax.tree.map(jnp.copy, jstate.variables), nc1,
                              jax.random.PRNGKey(6))
    jcur = jspec.grow_params(jstate.variables, nc1, jax.random.PRNGKey(5))
    tx1 = jax_build_optimizer(jcur["params"], OPT)
    jstate = JaxTrainState.create(jcur, tx1)
    jstep1 = jax_make_train_step(jspec, tx1, nc1, method=method, task_idx=1, prev_num_classes=nc0,
                                 video_mix=video_mix, donate=False)
    for s in range(2, 4):
        jstate, m = jstep1(jstate, jprev, jnp.asarray(x[s]), jnp.asarray(labels[s]), jextra[s],
                           keys[s])
        jax_losses.append(float(m["loss"]))

    # ---- port -----------------------------------------------------------
    draws = [jax_tubemix_draws(jax.random.split(k)[0], B, HW, HW, **VIDEO_MIX) for k in keys]
    calls = []

    def jax_draws(generator, b, h, w, alpha, prob, device=None):
        assert (b, h, w, alpha, prob) == (B, HW, HW, VIDEO_MIX["alpha"], VIDEO_MIX["prob"])
        calls.append(len(calls))
        return draws[len(calls) - 1]

    monkeypatch.setattr(steps, "draw_tubemix", jax_draws)
    spec = build_model(cfg, device="cpu")
    model = spec.module()
    model.load_state_dict(from_jax_variables(jvars), strict=True)
    ptx = build_optimizer(model, OPT)
    state = TrainState.create(model, ptx)
    step = make_train_step(spec, ptx, nc0, method=method, video_mix=video_mix)
    textra = [{k: torch.from_numpy(v) for k, v in e.items()} for e in extras]
    losses = []
    for s in range(2):
        state, m = step(state, None, to_torch(x[s]), torch.from_numpy(labels[s]), textra[s])
        losses.append(float(m["loss"]))
    prev = copy.deepcopy(model)
    grow_like_jax(model, numpy_tree(jcur), nc0, nc1)
    grow_like_jax(prev, numpy_tree(jprev), nc0, nc1)
    ptx1 = build_optimizer(model, OPT)
    state = TrainState.create(model, ptx1)
    step1 = make_train_step(spec, ptx1, nc1, method=method, task_idx=1, prev_num_classes=nc0,
                            video_mix=video_mix)
    assert step1.needs_prev
    for s in range(2, 4):
        state, m = step1(state, prev, to_torch(x[s]), torch.from_numpy(labels[s]), textra[s])
        losses.append(float(m["loss"]))

    assert len(calls) == (4 if video_mix else 0)
    np.testing.assert_allclose(losses, jax_losses, **TOL)
    head = jstate.params["head"]
    for name in ("fc_weights", "eta"):
        np.testing.assert_allclose(getattr(model.cls_head, name).detach().numpy(),
                                   np.asarray(head[name]), **TOL, err_msg=name)
    ref_k = np.transpose(np.asarray(jstate.params["backbone"]["layer4_0"]["conv1"]["kernel"]),
                         (3, 2, 0, 1))
    np.testing.assert_allclose(model.backbone.layer4[0].conv1.weight.detach().numpy(), ref_k,
                               **TOL)


def test_icarl_video_mix_needs_its_settings():
    spec = build_model(model_cfg(18, "pad", "xla", 3, classifier="SimpleLinear",
                                 in_channels=512), device="cpu")
    with pytest.raises(ValueError, match="video_mix"):
        make_train_step(spec, None, 3, method="icarl_video_mix")
