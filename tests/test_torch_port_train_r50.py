"""The depth-50 train step of the port against the JAX package's, on the CPU, f32.

Configurations A and B (tests/torch_port_helpers.CONFIGS): one task-0 step
each (T=2, 32x32, B=2, LSC head, LSCLoss); loss rtol 2e-3 and all
batch_stats rtol 2e-3, atol 1e-3 (f32 summation order through 50 layers).
B is held against JAX 'fused_block', A against JAX 'xla', which the JAX tests
pin equal to its 'pallas_stats'. Parameters after the step are not compared:
the full-model gradient is chaotically ill-conditioned (tests/test_conv1x1_bn.py).
"""

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
from bdvcil_torch.models import build_model, from_jax_variables
from bdvcil_torch.optim import build_optimizer
from bdvcil_torch.runtime import TrainState, make_train_step
from tests.torch_port_helpers import CONFIGS, T, model_cfg, numpy_tree, to_torch

HW = 32
OPT = dict(type="SGD", constructor="CILTSMOptimizerConstructorImprovised",
           paramwise_cfg=dict(fc_lr_scale_factor=5.0), lr=0.004, momentum=0.9,
           weight_decay=1e-4)
KEY = jax.random.PRNGKey(1)  # dropout_ratio=0: unused


@pytest.mark.parametrize("config", ["A", "B"])
def test_r50_one_step_loss_and_batch_stats_match_jax(config):
    jax_kw, port_kw = CONFIGS[config]
    nc, batch = 5, 2
    jcfg = model_cfg(50, jax_kw["shift_mode"], "xla", nc)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((batch, T, HW, HW, 3)).astype(np.float32)
    y = rng.integers(0, nc, size=(batch,))

    jspec = jax_build_model(jcfg)
    jvars = numpy_tree(jax_init(jspec, jax.random.PRNGKey(2), (1, T, HW, HW, 3)))
    tx = jax_build_optimizer(jvars["params"], OPT)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, jvars), tx)
    jstep = jax_make_train_step(jspec, tx, nc, donate=False)
    jstate, jm = jstep(jstate, None, jnp.asarray(x), jnp.asarray(y), {}, KEY)

    spec = build_model(model_cfg(50, **port_kw, num_classes=nc), device="cpu")
    model = spec.module()
    model.load_state_dict(from_jax_variables(jvars), strict=True)
    ptx = build_optimizer(model, OPT)
    state, m = make_train_step(spec, ptx, nc)(
        TrainState.create(model, ptx), None, to_torch(x), torch.from_numpy(y), {})

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-3)
    ref = from_jax_variables({"batch_stats": numpy_tree(jstate.batch_stats)})
    sd = model.state_dict()
    assert len(ref) == 2 * 53  # the stem BN and 52 in the blocks, mean and var each
    for name, val in ref.items():
        np.testing.assert_allclose(sd[name].numpy(), val.numpy(), rtol=2e-3, atol=1e-3,
                                   err_msg=name)
