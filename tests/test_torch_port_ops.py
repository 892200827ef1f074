"""The port's ops (bdvcil_torch/ops) against the JAX package's, on the CPU.

The same numpy inputs go through the JAX function (Pallas in interpret mode)
and the port's counterpart, which on a CPU tensor runs its kernel's plain
version. Tolerances:
  * fused_residual_relu_shift forward and VJP: bit-exact (elementwise adds
    rounded once, and an index permutation);
  * conv1x1_with_stats, f32: y rtol 1e-5; s1, s2 rtol 1e-5, atol 1e-4
    (summation order); bf16: y within one bf16 ulp;
  * the autograd gradient, including the gs1/gs2 path: rtol 1e-5.
The kernels themselves run only on the card: tests/test_torch_port_cuda.py
holds each one against its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.ops import conv1x1_bn as jax_conv
from bdvcil_tpu.ops import tsm_shift as jax_tsm
from bdvcil_torch.ops import conv1x1_bn as port_conv
from bdvcil_torch.ops import tsm_shift as port_tsm
from bdvcil_torch.ops import _build

T = 2


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x: np.ndarray, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 bits of mantissa)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("shape", [(2 * T, 4, 4, 16), (3 * T, 2, 3, 24), (4, 1, 1, 8)])
def test_temporal_shift_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = _np(jax_tsm.temporal_shift(jnp.asarray(x), T, 8))
    np.testing.assert_array_equal(port_tsm.temporal_shift(_t(x), T, 8).numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2 * T, 4, 4, 32), (T, 3, 5, 16), (3 * T, 2, 2, 64)])
def test_fused_residual_relu_shift_fwd_and_vjp_bit_exact(shape, dtype):
    rng = np.random.default_rng(1)
    h, i, g_out, g_sh = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)

    def jax_fn(a, b):
        return jax_tsm.fused_residual_relu_shift(a, b, T, 8, True)

    (j_out, j_sh), vjp = jax.vjp(jax_fn, jnp.asarray(h, jdt), jnp.asarray(i, jdt))
    j_dh, j_di = vjp((jnp.asarray(g_out, jdt), jnp.asarray(g_sh, jdt)))

    th = _t(h, tdt).requires_grad_(True)
    ti = _t(i, tdt).requires_grad_(True)
    p_out, p_sh = port_tsm.fused_residual_relu_shift(th, ti, T, 8)
    torch.autograd.backward([p_out, p_sh], [_t(g_out, tdt), _t(g_sh, tdt)])

    for port, ref in [(p_out, j_out), (p_sh, j_sh), (th.grad, j_dh), (ti.grad, j_di)]:
        assert port.dtype == tdt
        np.testing.assert_array_equal(port.detach().float().numpy(), _np(ref))


def test_fused_plain_versions_match_the_unfused_ops():
    """The plain forward is relu(h + id) then the shift; its backward is the
    autograd gradient of that composition."""
    rng = np.random.default_rng(2)
    shape = (2 * T, 3, 3, 16)
    h = _t(rng.standard_normal(shape)).requires_grad_(True)
    i = _t(rng.standard_normal(shape)).requires_grad_(True)
    g_out, g_sh = _t(rng.standard_normal(shape)), _t(rng.standard_normal(shape))
    out = torch.relu(h + i)
    shifted = port_tsm.temporal_shift(out, T, 8)
    torch.autograd.backward([out, shifted], [g_out, g_sh])
    p_out, p_sh = port_tsm.fused_residual_relu_shift_plain(h.detach(), i.detach(), T, 8)
    np.testing.assert_array_equal(p_out.numpy(), out.detach().numpy())
    np.testing.assert_array_equal(p_sh.numpy(), shifted.detach().numpy())
    g = port_tsm.fused_residual_relu_shift_bwd_plain(p_out, g_out, g_sh, T, 8)
    np.testing.assert_allclose(g.numpy(), h.grad.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2 * T, 4, 4, 32, 64), (T, 3, 5, 48, 16), (3, 7, 1, 8, 24)])
def test_conv1x1_with_stats_f32_matches_jax(shape):
    nt, h, w, k, n = shape
    rng = np.random.default_rng(3)
    x = rng.standard_normal((nt, h, w, k)).astype(np.float32)
    wm = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    jy, js1, js2 = jax_conv.conv1x1_with_stats(jnp.asarray(x), jnp.asarray(wm), True)
    py, ps1, ps2 = port_conv.conv1x1_with_stats(_t(x), _t(wm))
    assert py.shape == (nt, h, w, n) and ps1.shape == (n,) and ps2.shape == (n,)
    np.testing.assert_allclose(py.numpy(), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ps1.numpy(), _np(js1), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ps2.numpy(), _np(js2), rtol=1e-5, atol=1e-4)


def test_conv1x1_with_stats_bf16_within_one_ulp_of_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2 * T, 4, 4, 64)).astype(np.float32)
    wm = (rng.standard_normal((64, 128)) * 0.05).astype(np.float32)
    jy, js1, js2 = jax_conv.conv1x1_with_stats(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wm, jnp.bfloat16), True)
    py, ps1, ps2 = port_conv.conv1x1_with_stats(_t(x, torch.bfloat16), _t(wm, torch.bfloat16))
    assert py.dtype == torch.bfloat16 and ps1.dtype == torch.float32
    jyf, pyf = _np(jy), py.float().numpy()
    assert np.all(np.abs(pyf - jyf) <= _bf16_ulp(jyf))
    # the statistics are sums over each side's own rounded y
    np.testing.assert_allclose(ps1.numpy(), pyf.reshape(-1, 128).sum(0), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ps2.numpy(), (pyf.reshape(-1, 128) ** 2).sum(0),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ps1.numpy(), _np(js1), rtol=2e-2, atol=2e-1)


@pytest.mark.parametrize("use_gs", [False, True])
def test_conv1x1_with_stats_gradient_matches_jax_vjp(use_gs):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2 * T, 3, 3, 32)).astype(np.float32)
    wm = (rng.standard_normal((32, 16)) * 0.1).astype(np.float32)
    gy = rng.standard_normal((2 * T, 3, 3, 16)).astype(np.float32)
    gs1 = rng.standard_normal(16).astype(np.float32) * use_gs
    gs2 = rng.standard_normal(16).astype(np.float32) * use_gs

    _, vjp = jax.vjp(lambda a, b: jax_conv.conv1x1_with_stats(a, b, True),
                     jnp.asarray(x), jnp.asarray(wm))
    jdx, jdw = vjp((jnp.asarray(gy), jnp.asarray(gs1), jnp.asarray(gs2)))

    tx, tw = _t(x).requires_grad_(True), _t(wm).requires_grad_(True)
    y, s1, s2 = port_conv.conv1x1_with_stats(tx, tw)
    torch.autograd.backward([y, s1, s2], [_t(gy), _t(gs1), _t(gs2)])
    np.testing.assert_allclose(tx.grad.numpy(), _np(jdx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), _np(jdw), rtol=1e-5, atol=1e-4)


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    x = torch.empty((2, 2, 2, 32), device="meta")
    with pytest.raises(NotImplementedError):
        port_tsm.fused_fwd(x, x, 2, 8)
    with pytest.raises(NotImplementedError):
        port_conv.conv1x1_with_stats_fwd(x, torch.empty((32, 64), device="meta"))


def test_cpu_dispatch_launches_no_kernel():
    _build.LAUNCHES.clear()
    x = torch.ones((2 * T, 2, 2, 32))
    port_tsm.fused_residual_relu_shift(x, x, T, 8)
    port_conv.conv1x1_with_stats(x, torch.ones((32, 64)))
    assert sum(_build.LAUNCHES.values()) == 0
