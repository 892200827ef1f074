"""The port's ``GroupedBatchNorm`` (bdvcil_torch/models/norm.py) against the JAX
package's (bdvcil_tpu/models/norm.py), on the CPU, f32, one process.

The same numpy input (N*T = 8 rows, 4x4, C = 6) and the same affine and running
statistics go to both. At groups 1/2/4 and stats_rows 0 (exact statistics)
and 1/3 (ghost statistics from each group's row prefix), the train-mode
output, the updated running statistics and the gradients of a fixed
cotangent with respect to the input, scale and bias, and the eval-mode
output, all agree at rtol 1e-5 (atol 1e-6 of the gradients' scale). The
ghost path normalizes in the compute dtype, so it also runs with a bf16
output (rtol 1e-2, bf16's 8 bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.models.norm import GroupedBatchNorm as JaxGroupedBatchNorm
from bdvcil_torch.models.norm import BatchNorm, GroupedBatchNorm

N, H, W, C = 8, 4, 4, 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, H, W, C)) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal((N, H, W, C)).astype(np.float32)
    scale = (rng.random(C) + 0.5).astype(np.float32)
    bias = (rng.standard_normal(C) * 0.1).astype(np.float32)
    mean = (rng.standard_normal(C) * 0.3).astype(np.float32)
    var = (rng.random(C) + 0.5).astype(np.float32)
    return x, g, scale, bias, mean, var


def _port(groups, stats_rows, scale, bias, mean, var, dtype=None):
    bn = GroupedBatchNorm(C, groups=groups, stats_rows=stats_rows, dtype=dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    return bn


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("stats_rows", [0, 1, 3])
def test_grouped_batchnorm_matches_jax(groups, stats_rows):
    x, g, scale, bias, mean, var = _inputs(groups * 10 + stats_rows)
    jm = JaxGroupedBatchNorm(use_running_average=False, groups=groups, stats_rows=stats_rows)
    jvars = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
             "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}

    def f(xx, params):
        y, mut = jm.apply({"params": params, "batch_stats": jvars["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut)

    (_, (jy, jmut)), (jgx, jgp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jvars["params"])

    bn = _port(groups, stats_rows, scale, bias, mean, var)
    tx = _nchw(x).requires_grad_(True)
    y = bn(tx, True)
    (y * _nchw(g)).sum().backward()

    np.testing.assert_allclose(_nhwc(y), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(jmut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jmut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-7)
    for got, ref in ((_nhwc(tx.grad), jgx), (bn.weight.grad.numpy(), jgp["scale"]),
                     (bn.bias.grad.numpy(), jgp["bias"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())

    # eval mode: the running statistics, written in the input's dtype
    je = JaxGroupedBatchNorm(use_running_average=True, groups=groups, stats_rows=stats_rows)
    jy_eval = je.apply(jvars, jnp.asarray(x))
    bn_eval = _port(groups, stats_rows, scale, bias, mean, var)
    with torch.no_grad():
        y_eval = bn_eval(_nchw(x), False)
    np.testing.assert_allclose(_nhwc(y_eval), np.asarray(jy_eval), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("groups", [1, 2])
def test_ghost_statistics_normalize_in_the_compute_dtype(groups):
    x, _, scale, bias, mean, var = _inputs(5)
    jm = JaxGroupedBatchNorm(use_running_average=False, groups=groups, stats_rows=2,
                             dtype=jnp.bfloat16)
    jvars = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
             "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    jy, _ = jm.apply(jvars, jnp.asarray(x).astype(jnp.bfloat16), mutable=["batch_stats"])
    bn = _port(groups, 2, scale, bias, mean, var, dtype=torch.bfloat16)
    with torch.no_grad():
        y = bn(_nchw(x).to(torch.bfloat16), True)
    assert y.dtype == torch.bfloat16
    ref = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(_nhwc(y), ref, rtol=1e-2, atol=1e-2 * np.abs(ref).max())


def test_one_group_without_a_prefix_is_the_exact_batchnorm_up_to_its_formula():
    """groups=1, stats_rows=0 is JAX's exact grouped formula; the flax
    ``BatchNorm`` (``models/norm.BatchNorm``) computes the same statistics
    with another normalize, so the two agree to f32 rounding."""
    x, _, scale, bias, mean, var = _inputs(9)
    grouped = _port(1, 0, scale, bias, mean, var)
    plain = BatchNorm(C)
    plain.load_state_dict(grouped.state_dict())
    with torch.no_grad():
        a, b = grouped(_nchw(x), True), plain(_nchw(x), True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grouped.running_var.numpy(), plain.running_var.numpy(), rtol=1e-6)


def test_groups_must_divide_the_rows():
    bn = GroupedBatchNorm(C, groups=3)
    with pytest.raises(ValueError, match="not divisible"):
        bn(torch.zeros(N, C, H, W), True)
