"""The port's train step (bdvcil_torch/runtime) against the JAX package's, on the CPU, f32.

  * Depth 18, shift_mode 'pad' and 'fused_block': 3 coupled task-0 steps
    (LSC head, LSCLoss, labeled SGD), then update_fc 4 -> 6 classes with the
    grown rows copied from the JAX side, then 1 task-1 step with feature-KD
    against the previous model and the global-norm clip at 1.0. Losses, and
    the classifier and layer4_0/conv1 parameters after the last step, within
    rtol 2e-3, atol 2e-4 (the tolerance of tests/test_torch_train_parity.py:
    beyond ~4 steps the trajectory is chaotic, so the horizon stays short).
The depth-50 step is in test_torch_port_train_r50.py.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import init_model_params as jax_init
from bdvcil_tpu.optim import build_optimizer as jax_build_optimizer
from bdvcil_tpu.runtime import TrainState as JaxTrainState
from bdvcil_tpu.runtime import make_train_step as jax_make_train_step
from bdvcil_torch.models import KD_TAPS, build_model, from_jax_variables, update_fc
from bdvcil_torch.optim import build_optimizer
from bdvcil_torch.runtime import TrainState, make_train_step
from tests.torch_port_helpers import T, model_cfg, numpy_tree, to_torch

HW = 32
OPT = dict(type="SGD", constructor="CILTSMOptimizerConstructorImprovised",
           paramwise_cfg=dict(fc_lr_scale_factor=5.0), lr=0.004, momentum=0.9,
           weight_decay=1e-4)
KEY = jax.random.PRNGKey(1)  # dropout_ratio=0: unused


def _kd(nc0, nc1):
    return dict(module_names=list(KD_TAPS), module_weights=[3.0, 3.0, 3.0, 3.0, 0.1],
                scale_factor=math.sqrt(nc1 / (nc1 - nc0)), exemplar_only=False)


def _port_model(cfg, jvars):
    spec = build_model(cfg, device="cpu")
    model = spec.module()
    model.load_state_dict(from_jax_variables(jvars), strict=True)
    return spec, model


@pytest.mark.parametrize("shift_mode", ["pad", "fused_block"])
def test_coupled_steps_with_growth_and_kd_match_jax(shift_mode):
    nc0, nc1, batch = 4, 6, 4
    cfg = model_cfg(18, shift_mode, "xla", nc0, in_channels=512)
    rng = np.random.default_rng(42)
    x = rng.standard_normal((4, batch, T, HW, HW, 3)).astype(np.float32)
    y0 = rng.integers(0, nc0, size=(3, batch))
    y1 = rng.integers(0, nc1, size=(batch,))
    kd = _kd(nc0, nc1)

    # ---- JAX ------------------------------------------------------------
    jspec = jax_build_model(cfg)
    jvars = numpy_tree(jax_init(jspec, jax.random.PRNGKey(0), (1, T, HW, HW, 3)))
    tx = jax_build_optimizer(jvars["params"], OPT)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, jvars), tx)
    jstep = jax_make_train_step(jspec, tx, nc0, donate=False)
    jax_losses = []
    for s in range(3):
        jstate, m = jstep(jstate, None, jnp.asarray(x[s]), jnp.asarray(y0[s]), {}, KEY)
        jax_losses.append(float(m["loss"]))
    jprev = jspec.grow_params(jax.tree.map(jnp.copy, jstate.variables), nc1,
                              jax.random.PRNGKey(6))
    jcur = jspec.grow_params(jstate.variables, nc1, jax.random.PRNGKey(5))
    tx1 = jax_build_optimizer(jcur["params"], OPT, grad_clip=1.0)
    jstate = JaxTrainState.create(jcur, tx1)
    jstep1 = jax_make_train_step(jspec, tx1, nc1, task_idx=1, prev_num_classes=nc0,
                                 kd_config=kd, donate=False)
    jstate, m = jstep1(jstate, jprev, jnp.asarray(x[3]), jnp.asarray(y1), {}, KEY)
    jax_losses.append(float(m["loss"]))
    assert float(m["kd_loss"]) > 0

    # ---- port -----------------------------------------------------------
    spec, model = _port_model(cfg, jvars)
    ptx = build_optimizer(model, OPT)
    state = TrainState.create(model, ptx)
    step = make_train_step(spec, ptx, nc0)
    losses = []
    for s in range(3):
        state, m = step(state, None, to_torch(x[s]), torch.from_numpy(y0[s]), {})
        losses.append(float(m["loss"]))
    prev = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(0)
    for mod, tree in ((model, jcur), (prev, jprev)):
        update_fc(mod, nc1, gen)
        with torch.no_grad():  # the same new rows as the JAX side
            grown = np.asarray(tree["params"]["head"]["fc_weights"])
            mod.cls_head.fc_weights[nc0:] = torch.from_numpy(np.array(grown[nc0:]))
    ptx1 = build_optimizer(model, OPT, grad_clip=1.0)
    state = TrainState.create(model, ptx1)
    step1 = make_train_step(spec, ptx1, nc1, task_idx=1, prev_num_classes=nc0, kd_config=kd)
    state, m = step1(state, prev, to_torch(x[3]), torch.from_numpy(y1), {})
    losses.append(float(m["loss"]))

    np.testing.assert_allclose(losses, jax_losses, rtol=2e-3, atol=2e-4)
    head = jstate.params["head"]
    for name in ("fc_weights", "eta"):
        np.testing.assert_allclose(getattr(model.cls_head, name).detach().numpy(),
                                   np.asarray(head[name]), rtol=2e-3, atol=2e-4, err_msg=name)
    ref_k = np.transpose(np.asarray(jstate.params["backbone"]["layer4_0"]["conv1"]["kernel"]),
                         (3, 2, 0, 1))
    np.testing.assert_allclose(model.backbone.layer4[0].conv1.weight.detach().numpy(), ref_k,
                               rtol=2e-3, atol=2e-4)
