"""The port's train step fed by its input function, and its K-step dispatch,
on the CPU, f32.

  * ``make_train_step(..., input_fn=make_fast_input_fn(wire_format='yuv420'))``
    against JAX's step with its own input function on the same wire batch
    (the port gets the RandAugment draws JAX derives from the batch's keys):
    one task-0 step, growth, one task-1 step with feature-KD and the clip.
    R18 with pad + xla, and configuration A (R50, pad + pallas_stats, held
    against JAX 'xla' as in test_torch_port_train_r50.py). Losses rtol 2e-3,
    atol 2e-4 (tests/test_torch_port_train.py); for R18 the classifier and
    layer4_0/conv1 after the KD step at the same tolerance, for R50 every
    BatchNorm running statistic after the task-0 step at rtol 2e-3, atol 1e-3
    (the tolerance of test_torch_port_train_r50.py, which also stops at one step).
  * the step with ``input_fn`` equals the step given ``input_fn``'s output,
    bit for bit;
  * ``make_multi_train_step`` at K = 2 equals two single steps, bit for bit.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.data import device_pipeline as jdp
from bdvcil_tpu.models import build_model as jax_build_model
from bdvcil_tpu.models import init_model_params as jax_init
from bdvcil_tpu.optim import build_optimizer as jax_build_optimizer
from bdvcil_tpu.runtime import TrainState as JaxTrainState
from bdvcil_tpu.runtime import make_train_step as jax_make_train_step
from bdvcil_torch.data import device_pipeline as pdp
from bdvcil_torch.data.synthetic import wire_batch
from bdvcil_torch.models import KD_TAPS, build_model, from_jax_variables, init_model_params
from bdvcil_torch.ops import rand_augment_dev as pra
from bdvcil_torch.optim import build_optimizer
from bdvcil_torch.runtime import TrainState, make_multi_train_step, make_train_step
from tests.torch_port_helpers import T, grow_like_jax, jax_randaug_draws, model_cfg, numpy_tree

S, B = 32, 4
OPT = dict(type="SGD", constructor="CILTSMOptimizerConstructorImprovised",
           paramwise_cfg=dict(fc_lr_scale_factor=5.0), lr=0.004, momentum=0.9,
           weight_decay=1e-4)
KEY = jax.random.PRNGKey(1)  # dropout_ratio=0: unused
TOL = dict(rtol=2e-3, atol=2e-4)


def wire_pair(seed, wire_format="yuv420"):
    """The same wire batch for JAX (with keys) and for the port (with the
    draws JAX derives from them)."""
    port = wire_batch(wire_format, B, T, S, seed=seed)
    keys = np.random.default_rng(seed + 1).integers(0, 2**32, size=(B, 2), dtype=np.uint32)
    ops, sign, x0, y0 = jax_randaug_draws(keys, 2, S, S)
    port.update(randaug_op_indices=ops.astype(np.int64), randaug_flip_sign=sign,
                randaug_x0=x0, randaug_y0=y0)
    jbatch = {k: jnp.asarray(v) for k, v in port.items() if k not in pra.DRAW_KEYS}
    jbatch["randaug_key"] = jnp.asarray(keys)
    return jbatch, pdp.batch_to_device(port, "cpu")


CASES = {
    "r18_pad_xla": (18, dict(shift_mode="pad", conv1x1_mode="xla"), "xla", 512),
    "A_r50": (50, dict(shift_mode="pad", conv1x1_mode="pallas_stats"), "xla", 2048),
}


@pytest.mark.parametrize("case", list(CASES))
def test_step_with_input_fn_matches_jax(case):
    depth, port_kw, jax_conv, width = CASES[case]
    nc0, nc1 = 4, 6
    jcfg = model_cfg(depth, port_kw["shift_mode"], jax_conv, nc0, in_channels=width)
    pcfg = model_cfg(depth, port_kw["shift_mode"], port_kw["conv1x1_mode"], nc0,
                     in_channels=width)
    rng = np.random.default_rng(5)
    y0, y1 = rng.integers(0, nc0, size=B), rng.integers(0, nc1, size=B)
    (jb0, pb0), (jb1, pb1) = wire_pair(21), wire_pair(22)
    kd = dict(module_names=list(KD_TAPS), module_weights=[3.0, 3.0, 3.0, 3.0, 0.1],
              scale_factor=math.sqrt(nc1 / (nc1 - nc0)), exemplar_only=False)
    jfn = jdp.make_fast_input_fn(wire_format="yuv420")
    pfn = pdp.make_fast_input_fn(wire_format="yuv420")

    jspec = jax_build_model(jcfg)
    jvars = numpy_tree(jax_init(jspec, jax.random.PRNGKey(0), (1, T, S, S, 3)))
    tx = jax_build_optimizer(jvars["params"], OPT)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, jvars), tx)
    jstate, m = jax_make_train_step(jspec, tx, nc0, donate=False, input_fn=jfn)(
        jstate, None, jb0, jnp.asarray(y0), {}, KEY)
    jax_losses = [float(m["loss"])]
    jstats0 = numpy_tree(jstate.batch_stats)
    jprev = jspec.grow_params(jax.tree.map(jnp.copy, jstate.variables), nc1, jax.random.PRNGKey(6))
    jcur = jspec.grow_params(jstate.variables, nc1, jax.random.PRNGKey(5))
    tx1 = jax_build_optimizer(jcur["params"], OPT, grad_clip=1.0)
    jstate = JaxTrainState.create(jcur, tx1)
    jstate, m = jax_make_train_step(jspec, tx1, nc1, task_idx=1, prev_num_classes=nc0,
                                    kd_config=kd, donate=False, input_fn=jfn)(
        jstate, jprev, jb1, jnp.asarray(y1), {}, KEY)
    jax_losses.append(float(m["loss"]))
    assert float(m["kd_loss"]) > 0

    spec = build_model(pcfg, device="cpu")
    model = spec.module()
    model.load_state_dict(from_jax_variables(jvars), strict=True)
    ptx = build_optimizer(model, OPT)
    state, m = make_train_step(spec, ptx, nc0, input_fn=pfn)(
        TrainState.create(model, ptx), None, pb0, torch.from_numpy(y0), {})
    losses = [float(m["loss"])]
    stats0 = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    prev = copy.deepcopy(model)
    grow_like_jax(model, numpy_tree(jcur), nc0, nc1)
    grow_like_jax(prev, numpy_tree(jprev), nc0, nc1)
    ptx1 = build_optimizer(model, OPT, grad_clip=1.0)
    state, m = make_train_step(spec, ptx1, nc1, task_idx=1, prev_num_classes=nc0,
                               kd_config=kd, input_fn=pfn)(
        TrainState.create(model, ptx1), prev, pb1, torch.from_numpy(y1), {})
    losses.append(float(m["loss"]))

    np.testing.assert_allclose(losses, jax_losses, **TOL)
    if depth == 18:
        head = jstate.params["head"]
        for name in ("fc_weights", "eta"):
            np.testing.assert_allclose(getattr(model.cls_head, name).detach().numpy(),
                                       np.asarray(head[name]), **TOL, err_msg=name)
        ref_k = np.transpose(
            np.asarray(jstate.params["backbone"]["layer4_0"]["conv1"]["kernel"]), (3, 2, 0, 1))
        np.testing.assert_allclose(model.backbone.layer4[0].conv1.weight.detach().numpy(), ref_k,
                                   **TOL)
    else:  # after the task-0 step: past one R50 step the statistics drift apart
        ref = from_jax_variables({"batch_stats": jstats0})
        assert len(ref) == len(stats0) == 2 * 53
        for name, val in ref.items():
            np.testing.assert_allclose(stats0[name].numpy(), val.numpy(), rtol=2e-3, atol=1e-3,
                                       err_msg=name)


def _port_model(seed=0, nc=4):
    spec = build_model(model_cfg(18, "pad", "xla", nc, in_channels=512), device="cpu")
    return spec, init_model_params(spec, seed)


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_step_with_input_fn_equals_step_on_its_output():
    spec, model = _port_model()
    twin = copy.deepcopy(model)
    _, batch = wire_pair(31, "planes")
    labels = torch.tensor([0, 1, 2, 3])
    fn = pdp.make_fast_input_fn(wire_format="planes")
    tx, tx2 = build_optimizer(model, OPT), build_optimizer(twin, OPT)
    _, m1 = make_train_step(spec, tx, 4, input_fn=fn)(
        TrainState.create(model, tx), None, batch, labels, {})
    _, m2 = make_train_step(spec, tx2, 4)(TrainState.create(twin, tx2), None, fn(batch),
                                          labels, {})
    assert float(m1["loss"]) == float(m2["loss"])
    p1, p2 = _params(model), _params(twin)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)


def test_multi_step_k2_equals_two_single_steps():
    spec, model = _port_model(1)
    twin = copy.deepcopy(model)
    batches = [wire_pair(40 + k)[1] for k in range(2)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    labels = torch.tensor([[0, 1, 2, 3], [3, 2, 1, 0]])
    weights = torch.tensor([[1.0, 1.0, 1.0, 0.0], [1.0, 0.0, 1.0, 1.0]])
    kwargs = dict(spec=spec, num_classes=4, input_fn=pdp.make_fast_input_fn(wire_format="yuv420"))
    tx = build_optimizer(model, OPT)
    multi = make_multi_train_step(dict(kwargs, tx=tx), 2)
    state, m = multi(TrainState.create(model, tx), None, stacked, labels,
                     {"sample_weight": weights}, [torch.Generator().manual_seed(k) for k in range(2)])
    tx2 = build_optimizer(twin, OPT)
    single = make_train_step(**dict(kwargs, tx=tx2))
    state2 = TrainState.create(twin, tx2)
    for k in range(2):
        state2, m2 = single(state2, None, batches[k], labels[k], {"sample_weight": weights[k]},
                            torch.Generator().manual_seed(k))
    assert state.step == state2.step == 2
    assert all(torch.equal(m[k], m2[k]) for k in m2)
    p1, p2 = _params(model), _params(twin)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    with pytest.raises(ValueError, match="generators"):
        multi(state, None, stacked, labels, {}, [None])
