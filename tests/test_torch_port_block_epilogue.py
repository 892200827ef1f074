"""The block's tail (bdvcil_torch/ops/block_fused.py: bn_finalize,
affine_residual_relu) against the JAX package's, on the CPU.

The same numpy inputs go through the JAX expressions of
bdvcil_tpu/ops/block_fused.py (``_finalize`` :262 with the ``mv`` of
``fused_bottleneck_fwd`` :294, and the last pass :290) and the port's ops,
which on a CPU tensor run their plain versions. Tolerances:
  * bn_finalize, f32: rtol 1e-6 (JAX divides by the count where PyTorch may
    multiply by its reciprocal: a few elements an ulp apart);
  * affine_residual_relu, bf16: bit for bit against JAX's expression run op
    by op, as fused_bottleneck_fwd runs it outside jit; under jax.jit XLA may
    fuse the pass into one multiply-add, so there within one bf16 ulp on at
    most 1e-4 of the elements (4 of 401,408 at 4 x 7 x 7 x 2048, seed 0);
  * the whole block over the plain ops: the tolerances of
    tests/test_torch_port_block_fused.py.
The kernels themselves run only on the card: tests/test_torch_port_cuda.py
holds each one bit for bit against its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.ops import block_fused as jbf
from bdvcil_torch import bench_block_fused
from bdvcil_torch.ops import _build
from bdvcil_torch.ops import block_fused as pbf
from tests.test_torch_port_block_fused import VARIANTS, _block_case, _check_block

# the four stride-1 bottleneck widths of ResNet-50, (H = W, C), at a few
# frames, and a ragged row count (315 rows of 17 packs)
WIDTHS = [(2, 56, 256), (2, 28, 512), (2, 14, 1024), (4, 7, 2048), (5, 7, 136)]


def _bf16(rng, shape, scale=1.0):
    return np.asarray(jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16), np.float32)


def _jax_last_pass(y3, a3, b3, x):
    """bdvcil_tpu/ops/block_fused.py:290, as written there."""
    return jnp.maximum(
        y3.astype(jnp.float32) * a3 + b3 + x.astype(jnp.float32), 0.0
    ).astype(x.dtype)


def _jax_mv(s, q, cnt1):
    """The ``mv`` of bdvcil_tpu/ops/block_fused.py:294, as written there."""
    m = s / cnt1
    return m, q / cnt1 - jnp.square(m)


def _epilogue_case(seed, nt, hw, c):
    rng = np.random.default_rng(seed)
    y = _bf16(rng, (nt, hw, hw, c), 3.0)
    x = _bf16(rng, (nt, hw, hw, c))
    a = (rng.random(c) + 0.5).astype(np.float32)
    b = (rng.standard_normal(c) * 0.5).astype(np.float32)
    return y, x, a, b


def _stats_case(seed, c, count):
    """Sums of ``count`` rows: mean about N(0, 1), variance in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(c)
    var = rng.random(c) + 0.5
    s = (mean * count).astype(np.float32)
    q = ((var + mean ** 2) * count).astype(np.float32)
    g = (rng.random(c) + 0.5).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return s, q, g, beta


@pytest.mark.parametrize("c,count", [(64, 25088.0), (256, 401408.0), (2048, 6272.0), (8, 6.0)])
def test_bn_finalize_plain_matches_jax_finalize_and_mv(c, count):
    s, q, g, beta = _stats_case(c, c, count)
    out = pbf.bn_finalize(*(torch.from_numpy(v) for v in (s, q, g, beta)), count, 1e-5)
    assert out.shape == (4, c) and out.dtype == torch.float32
    js, jq, jg, jbeta = (jnp.asarray(v) for v in (s, q, g, beta))
    ja, jb = jbf._finalize(js, jq, count, jg, jbeta, 1e-5)
    jm, jv = _jax_mv(js, jq, count)
    for got, want in zip(out.numpy(), (ja, jb, jm, jv)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("nt,hw,c", WIDTHS, ids=[f"{n}x{h}x{h}x{c}" for n, h, c in WIDTHS])
def test_affine_residual_relu_plain_matches_jax_last_pass(nt, hw, c):
    y, x, a, b = _epilogue_case(c, nt, hw, c)
    got = pbf.affine_residual_relu(torch.from_numpy(y).bfloat16(), torch.from_numpy(a),
                                   torch.from_numpy(b), torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == y.shape
    got = got.float().numpy()
    args = (jnp.asarray(y, jnp.bfloat16), jnp.asarray(a), jnp.asarray(b),
            jnp.asarray(x, jnp.bfloat16))
    eager = np.asarray(_jax_last_pass(*args).astype(jnp.float32))
    np.testing.assert_array_equal(got, eager)
    fused = np.asarray(jax.jit(_jax_last_pass)(*args).astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(fused), np.finfo(np.float32).tiny))) - 7)
    assert np.all(np.abs(got - fused) <= ulp)
    assert np.count_nonzero(got != fused) <= 1e-4 * got.size


def test_affine_residual_relu_keeps_nan_and_zeroes_negatives_like_jax():
    y = np.array([[np.nan, -np.inf, np.inf, -3.0, 3.0, 0.0, -0.5, 1.0]], np.float32)
    x = np.array([[1.0, 1.0, 1.0, 1.0, 1.0, -1.0, 0.25, np.nan]], np.float32)
    a = np.full(8, 2.0, np.float32)
    b = np.full(8, 0.5, np.float32)
    got = pbf.affine_residual_relu(torch.from_numpy(y).bfloat16(), torch.from_numpy(a),
                                   torch.from_numpy(b), torch.from_numpy(x).bfloat16())
    want = np.asarray(_jax_last_pass(jnp.asarray(y, jnp.bfloat16), jnp.asarray(a),
                                     jnp.asarray(b), jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert np.isnan(want[0, 0]) and np.isnan(want[0, 7]) and want[0, 1] == 0.0


def test_block_tail_ops_refuse_inputs_that_require_grad():
    v = torch.ones(8, requires_grad=True)
    y = torch.zeros((1, 2, 2, 8), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="forward-only"):
        pbf.bn_finalize(v, torch.ones(8), torch.ones(8), torch.zeros(8), 4.0, 1e-5)
    with pytest.raises(RuntimeError, match="forward-only"):
        pbf.affine_residual_relu(y, v, torch.zeros(8), y)
    with pytest.raises(RuntimeError, match="forward-only"):
        pbf.affine_residual_relu(y.clone().requires_grad_(True), torch.ones(8), torch.zeros(8),
                                 y)


def test_block_tail_ops_refuse_devices_they_have_no_kernel_for():
    v = torch.empty((8,), device="meta")
    y = torch.empty((1, 2, 2, 8), device="meta", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        pbf.bn_finalize(v, v, v, v, 4.0, 1e-5)
    with pytest.raises(NotImplementedError):
        pbf.affine_residual_relu(y, v, v, y)


def test_block_tail_wrappers_check_before_they_build():
    """The CUDA wrappers' checks come before the library is built or loaded,
    so every refusal holds whatever the operands' device (here the CPU, where
    a launch would fail to find nvcc). The last pass takes bf16 and f32 at any
    C and alignment, the finalize any C (per-element forms on the card);
    what they refuse: float16, two dtypes, other shapes, non-contiguous
    operands, vectors that are not contiguous f32 (C,)."""
    bf16 = torch.bfloat16
    v, y = torch.ones(16), torch.zeros((2, 3, 3, 16), dtype=bf16)
    epi, fin = pbf._affine_residual_relu_cuda, pbf._bn_finalize_cuda
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        epi(y.half(), v, v, y.half())
    with pytest.raises(TypeError, match="one dtype"):
        epi(y.float(), v, v, y)
    with pytest.raises(ValueError, match="shapes"):
        epi(y, v, v, y[:1])
    with pytest.raises(ValueError, match="contiguous"):
        epi(y.transpose(1, 2), v, v, y)
    with pytest.raises(ValueError, match="contiguous"):
        epi(y.float().transpose(1, 2), v, v, y.float())
    with pytest.raises(ValueError, match="float32"):
        epi(y, v.double(), v, y)
    with pytest.raises(ValueError, match=r"\(16,\)"):
        epi(y.float(), torch.ones(12), v, y.float())
    with pytest.raises(ValueError, match=r"\(16,\)"):
        fin(v, torch.ones(8), v, v, 4.0, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        fin(v, torch.ones(32)[::2], v, v, 4.0, 1e-5)
    with pytest.raises(ValueError, match="float32"):
        fin(*(torch.ones(12, dtype=torch.float64),) * 4, 4.0, 1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("geometry", [(0, 8, 14, 64, 16), (2, 6, 7, 32, 8)],
                         ids=["8x14x14x64/16", "odd-6x7x7x32/8"])
def test_block_over_the_plain_tail_matches_jax_fused_block(geometry, variant):
    jx, jp, px, pp = _block_case(*geometry)
    _build.LAUNCHES.clear()
    pout = pbf.fused_bottleneck_fwd_plain(px, pp, conv3x3_variant=variant)
    assert sum(_build.LAUNCHES.values()) == 0
    _check_block(pout, jbf.fused_bottleneck_fwd(jx, jp, interpret=True,
                                                conv3x3_variant=variant))


def test_bench_parts_time_the_tail_kernel_beside_its_plain_version(capsys):
    import json

    assert bench_block_fused.main(["1", "--parts", "--rows", "2", "--hw", "4", "--c", "32",
                                   "--cm", "8", "--device", "cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("epilogue_kernel_ms", "epilogue_plain_ms", "bn_finalize_kernel_ms",
                "bn_finalize_plain_ms"):
        assert result[key] > 0
