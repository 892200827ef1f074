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

import copy

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


# --- train-mode BatchNorm through ops/batchnorm (the plain versions here) ----
# On the CPU the module runs the plain versions' forward under autograd; the
# analytic backward's plain versions (the kernels' twins) are called directly.

import flax.linen as flax_nn  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from bdvcil_torch.models.resnet_tsm import ResNetTSM  # noqa: E402
from bdvcil_torch.ops import batchnorm as port_bn  # noqa: E402


def _eager_batchnorm(bn, x, relu):
    """The eager flax BatchNorm the Function replaces, as models/norm.py ran
    it: (output, running mean, running var)."""
    xf = x.float()
    count = xf.new_full((1,), float(xf.numel() // xf.shape[1]))
    s1, s2 = xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    m = bn.momentum
    rm = m * bn.running_mean + (1 - m) * mean
    rv = m * bn.running_var + (1 - m) * var
    mul = torch.rsqrt(var + bn.epsilon) * bn.weight
    y = ((x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]).to(
        bn.dtype or x.dtype)
    return (F.relu(y) if relu else y), rm, rv


def _module(c, seed, dtype=None):
    rng = np.random.default_rng(seed)
    bn = BatchNorm(c, dtype=dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy((rng.random(c) + 0.5).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy((rng.standard_normal(c) * 0.3).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy((rng.standard_normal(c) * 0.3).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy((rng.random(c) + 0.5).astype(np.float32)))
    return bn


def _channels_last(c, seed, dtype, n=4, h=5, w=6, constant=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32) * 2 + 0.5
    if constant is not None:
        x[:, constant] = 0.5
    return torch.from_numpy(x).to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", [3, 13, 64, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batchnorm_forward_and_running_statistics_are_the_eager_formula(dtype, c, relu):
    """The plain versions keep the eager expression's bits: the output, and
    the running statistics updated in place."""
    x = _channels_last(c, c, dtype, n=2 if c == 2048 else 4)
    bn = _module(c, c, dtype)
    ref, rm, rv = _eager_batchnorm(bn, x, relu)
    with torch.no_grad():
        y = bn(x, True, relu=relu)
    assert y.dtype == ref.dtype and y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, ref)
    assert torch.equal(bn.running_mean, rm) and torch.equal(bn.running_var, rv)


@pytest.fixture
def float64_tensors(monkeypatch):
    """``Tensor.float`` as a no-op, as the float64 witnesses run the port: the
    plain versions then stay in float64."""
    monkeypatch.setattr(torch.Tensor, "float", lambda self: self)


def _analytic_grads(bn, x, g, relu):
    """The analytic backward's plain versions (``ops/batchnorm._backward``,
    the kernels' twins) at x's batch statistics: (dx, dweight, dbias)."""
    spec = port_bn._Spec(False, relu, bn.dtype or x.dtype, float(x.numel() // x.shape[1]),
                         bn.epsilon, 1, False)
    with torch.no_grad():
        s1, s2 = port_bn.stats_plain(x, 1)
        coef = port_bn.finalize_plain(s1, s2, spec.count, copy.deepcopy(bn), spec)
        return port_bn._backward(port_bn.PLAIN, g, x, coef, spec.count, spec, True)


def _eager_float64_grads(bn, x, g, relu):
    """Autograd of the eager formula in float64: (dx, dweight, dbias)."""
    x = x.detach().double().requires_grad_(True)
    w = bn.weight.detach().double().requires_grad_(True)
    b = bn.bias.detach().double().requires_grad_(True)
    n = x.numel() // x.shape[1]
    s1, s2 = x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    y = (x - mean[:, None, None]) * (torch.rsqrt(var + bn.epsilon) * w)[:, None, None] \
        + b[:, None, None]
    (F.relu(y) if relu else y).backward(g.double())
    return x.grad, w.grad, b.grad


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", [3, 13, 64])
def test_batchnorm_analytic_backward_is_autograd_of_the_eager_formula_in_float64(
        float64_tensors, c, relu):
    """dx, dweight and dbias of the analytic backward (the kernels' twins)
    against autograd of the eager expression, both in float64; channel 1
    constant (var = 0)."""
    x = _channels_last(c, 7 + c, torch.float64, constant=1 if c > 1 else None)
    g = torch.from_numpy(np.random.default_rng(c).standard_normal(x.shape))
    bn = _module(c, c).double()
    ref = _eager_float64_grads(bn, x, g, relu)
    for got, want in zip(_analytic_grads(bn, x, g, relu), ref):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                                   atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("backward", ["autograd", "analytic"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("constant", [None, 2])
def test_batchnorm_gradients_match_jax_flax_batchnorm(constant, relu, backward):
    """The port's train-mode BatchNorm against ``jax.grad`` of the flax
    BatchNorm the JAX backbone uses (``_make_bn`` with one group), f32, at
    this file's tolerances; with ``constant`` one channel has var = 0. The
    gradients are autograd's of the module (the CPU's) or the analytic
    backward's (the kernels' twins)."""
    x = _channels_last(C, 11, torch.float32, n=N, h=H, w=W, constant=constant)
    g = np.random.default_rng(12).standard_normal((N, H, W, C)).astype(np.float32)
    bn = _module(C, 13)
    jm = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    params = {"scale": jnp.asarray(bn.weight.detach().numpy()),
              "bias": jnp.asarray(bn.bias.detach().numpy())}
    stats = {"mean": jnp.asarray(bn.running_mean.numpy()),
             "var": jnp.asarray(bn.running_var.numpy())}
    x_nhwc = jnp.asarray(_nhwc(x))

    def f(xx, p):
        y, mut = jm.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        y = jax.nn.relu(y) if relu else y
        return jnp.sum(y * g), (y, mut)

    (_, (jy, jmut)), (jgx, jgp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        x_nhwc, params)
    analytic = _analytic_grads(bn, x, _nchw(g), relu)
    xr = x.clone().requires_grad_(True)
    y = bn(xr, True, relu=relu)
    (y * _nchw(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy), rtol=1e-5, atol=1e-6)
    for got, ref in ((bn.running_mean.numpy(), jmut["batch_stats"]["mean"]),
                     (bn.running_var.numpy(), jmut["batch_stats"]["var"])):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-7)
    dx, dweight, dbias = (analytic if backward == "analytic"
                          else (xr.grad, bn.weight.grad, bn.bias.grad))
    for got, ref in ((_nhwc(dx), jgx), (dweight.detach().numpy(), jgp["scale"]),
                     (dbias.detach().numpy(), jgp["bias"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batchnorm_relu_is_relu_of_batchnorm_forward_and_backward(dtype):
    """relu=True gives relu(bn(x)) bit for bit, and its gradients (autograd's
    of the module: the sums may add in another order, as the unfused g's
    layout is autograd's); the analytic backward's fused mask is
    threshold_backward on the recomputed output: with relu it equals the
    backward without it of g zeroed where the output is 0, bit for bit."""
    x = _channels_last(16, 3, dtype)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(x.shape).astype(np.float32))
    outs, grads = [], []
    for fused in (False, True):
        bn = _module(16, 5, dtype)
        xr = x.clone().requires_grad_(True)
        y = bn(xr, True, relu=True) if fused else F.relu(bn(xr, True))
        y.backward(g.to(y.dtype))
        outs.append(y)
        grads.append((xr.grad, bn.weight.grad, bn.bias.grad))
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=1e-5,
                                   atol=1e-6 * float(b.float().abs().max()))
    bn = _module(16, 5, dtype)
    gx = g.to(x.dtype)
    masked = gx.masked_fill(outs[1].detach() <= 0, 0)
    for a, b in zip(_analytic_grads(bn, x, gx, True), _analytic_grads(bn, x, masked, False)):
        assert torch.equal(a, b)


def _count_batchnorm_calls(monkeypatch):
    calls = {"module": 0, "sums": 0}
    forward = port_bn._forward

    def spy(ops, x, s1, s2, bn, spec):
        calls["sums" if spec.sums else "module"] += 1
        return forward(ops, x, s1, s2, bn, spec)

    monkeypatch.setattr(port_bn, "_forward", spy)
    return calls


@pytest.mark.parametrize("depth,switches,module_calls,sums_calls", [
    (50, dict(shift_mode="pad", conv1x1_mode="pallas_stats"), 21, 32),
    (34, dict(shift_mode="fused_block", conv1x1_mode="xla"), 36, 0),
])
def test_every_train_mode_batchnorm_takes_ops_batchnorm_once(monkeypatch, depth, switches,
                                                             module_calls, sums_calls):
    """One forward of ops/batchnorm (the Function's on a card, the plain one
    here) per train-mode BatchNorm a forward: R50 in configuration A 53 (21
    modules, 32 conv1x1_bn normalizes), R34 in configuration B 36; none in
    eval mode."""
    calls = _count_batchnorm_calls(monkeypatch)
    torch.manual_seed(0)
    model = ResNetTSM(depth=depth, num_segments=2, dtype=torch.bfloat16,
                      norm_dtype=torch.bfloat16, **switches)
    x = torch.randn(2, 32, 32, 3)
    with torch.no_grad():
        model(x, train=True)
    assert calls == {"module": module_calls, "sums": sums_calls}
    with torch.no_grad():
        model(x, train=False)
    assert calls == {"module": module_calls, "sums": sums_calls}


def test_batchnorm_kernels_take_bfloat16_or_float32_only():
    for dtype in (torch.bfloat16, torch.float32):
        assert port_bn.launch_name(port_bn.APPLY, dtype).startswith(port_bn.APPLY)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        port_bn.launch_name(port_bn.STATS, torch.float16)
