"""The GEMM with statistics in float32 and at any K and N, on the CPU.

On the card the port runs float32 as three TF32 products on the tensor cores
(``csrc/gemm_stats_tf32.cu``, K and N zero-padded to multiples of 4, with or
without the block's prologue) and bfloat16 on the wgmma core, zero-padding K and N to multiples of 8 for the TMA
(``ops/conv1x1_bn.aligned_call``). Here the wrappers run the plain
version, and these tests hold what surrounds the kernels:

  * the port's ``gemm_with_stats`` and ``conv1x1_with_stats`` against the JAX
    package's with ``interpret=True`` at ragged shapes (M not a tile multiple,
    K and N not multiples of 8 or 64). float32: y rtol 1e-5, atol 1e-6 of
    max |y| (JAX's interpreted product is up to 1.9e-5 off numpy's at
    (4096, 100, 101), about 5e-7 of max |y|); the statistics rtol 1e-5, atol
    1e-6 of the largest (another summation order). bfloat16, as the JAX
    package's own tests/test_conv1x1_bn.py: y rtol 2e-2, atol 2e-2 (one ulp of
    accumulation order), the statistics against each side's own rounded y
    rtol 1e-5, atol 1e-4;
  * the dtype routing (``launch_name``): float32 to the float32 kernels' count,
    bfloat16 to the wgmma core's, anything else a TypeError before a build;
  * the padding for the TMA applied to the plain version: y bit for bit the
    unpadded plain version's, the statistics rtol 1e-6 (the CPU's sum over
    8 columns takes another path than over 5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.ops import conv1x1_bn as jax_conv
from bdvcil_torch.ops import _build
from bdvcil_torch.ops import conv1x1_bn as port_conv

# (M, K, N): JAX's own test shapes (100, 32, 128) and (896, 96, 128), and K, N
# that are not multiples of 8 or 64
RAGGED = [(100, 32, 128), (896, 96, 128), (1000, 3, 5), (4096, 100, 101), (4096, 96, 101)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    return x, w


def _t(x: np.ndarray, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("mkn", RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["gemm_with_stats", "conv1x1_with_stats"])
def test_ragged_shapes_match_jax_interpret(op, dtype, mkn):
    m, k, n = mkn
    x, w = _operands(m, k, n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if op == "gemm_with_stats":
        jy, js1, js2 = jax_conv.gemm_with_stats(jnp.asarray(x, jdt), jnp.asarray(w, jdt), True)
        py, ps1, ps2 = port_conv.gemm_with_stats(_t(x, tdt), _t(w, tdt))
    else:  # an (M, 1, 1, K) activation: the 1x1 convolution reads its rows
        jy, js1, js2 = jax_conv.conv1x1_with_stats(
            jnp.asarray(x.reshape(m, 1, 1, k), jdt), jnp.asarray(w, jdt), True)
        py, ps1, ps2 = port_conv.conv1x1_with_stats(_t(x.reshape(m, 1, 1, k), tdt), _t(w, tdt))
    assert py.dtype == tdt and ps1.dtype == ps2.dtype == torch.float32
    assert py.numel() == m * n and ps1.shape == ps2.shape == (n,)
    jyf, pyf = _f32(jy).reshape(m, n), py.float().numpy().reshape(m, n)
    if dtype == "float32":
        np.testing.assert_allclose(pyf, jyf, rtol=1e-5, atol=1e-6 * np.abs(jyf).max())
        for p, j in ((ps1, js1), (ps2, js2)):
            j = _f32(j)
            np.testing.assert_allclose(p.numpy(), j, rtol=1e-5, atol=1e-6 * np.abs(j).max())
    else:
        np.testing.assert_allclose(pyf, jyf, rtol=2e-2, atol=2e-2)
        for s1, s2, y in ((ps1.numpy(), ps2.numpy(), pyf), (_f32(js1), _f32(js2), jyf)):
            yd = y.astype(np.float64)
            np.testing.assert_allclose(s1, yd.sum(0), rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(s2, (yd * yd).sum(0), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtypes,want", [
    ((torch.float32, torch.float32), port_conv.GEMM_KERNEL_F32),
    ((torch.bfloat16, torch.bfloat16), port_conv.GEMM_KERNEL),
    ((torch.float16, torch.float16), TypeError),
    ((torch.float64, torch.float64), TypeError),
    ((torch.float32, torch.bfloat16), TypeError),
])
def test_launch_name_routes_by_dtype(dtypes, want):
    if want is TypeError:
        with pytest.raises(TypeError):
            port_conv.launch_name(port_conv.GEMM_KERNEL, *dtypes)
    else:
        assert port_conv.launch_name(port_conv.GEMM_KERNEL, *dtypes) == want


def test_wrapper_refuses_a_dtype_before_it_builds_or_counts():
    """float16, with or without the block's prologue, and two dtypes with it
    raise TypeError in the CUDA wrapper before it reaches a compiler or a
    launch count (float32 and bfloat16 take the prologue since the block
    probe's f32 kernels)."""
    _build.LAUNCHES.clear()
    h = torch.zeros((4, 8), dtype=torch.float16)
    with pytest.raises(TypeError):
        port_conv.gemm_stats_cuda(port_conv.GEMM_KERNEL, h, torch.zeros((8, 8),
                                                                       dtype=torch.float16))
    a = torch.ones(64)
    with pytest.raises(TypeError):
        port_conv.gemm_stats_cuda(port_conv.GEMM_KERNEL, torch.zeros((4, 64), dtype=torch.float16),
                                  torch.zeros((64, 64), dtype=torch.float16), a, a)
    with pytest.raises(TypeError):
        port_conv.gemm_stats_cuda(port_conv.GEMM_KERNEL, torch.zeros((4, 64)),
                                  torch.zeros((64, 64), dtype=torch.bfloat16), a, a)
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1000, 3, 5), (4096, 100, 101), (7, 13, 64), (64, 8, 8),
                                   (6, 2, 3, 20, 9)])
def test_tma_padding_keeps_the_plain_result(shape, dtype):
    *rows, k, n = shape
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((*rows, k)).astype(np.float32), dtype)
    w = _t((rng.standard_normal((k, n)) * 0.1).astype(np.float32), dtype)
    y, s1, s2 = port_conv.aligned_call(port_conv.gemm_stats_plain, x, w)
    ry, rs1, rs2 = port_conv.gemm_stats_plain(x, w)
    assert y.shape == ry.shape == (*rows, n) and y.is_contiguous()
    assert torch.equal(y, ry)
    for got, ref in ((s1, rs1), (s2, rs2)):
        assert got.shape == (n,)
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * float(ref.abs().max()))
