"""The port's whole-block fused bottleneck (bdvcil_torch/ops/block_fused.py)
against the JAX package's, on the CPU.

The same numpy inputs and weights go through the JAX functions (Pallas in
interpret mode) and the port's, which on a CPU tensor run each stats
kernel's plain version. Tolerances:
  * each stats op, bf16 at (8, 14, 14, 64), c=64, cm=16: y within one bf16 ulp
    (f32 accumulation order); s1/s2 rtol 1e-5, atol 1e-3, the tolerance of
    tests/test_block_fused.py (f32 sums in another order);
  * the block: out rtol/atol 2e-2, mean and var 1e-4, as tests/test_block_fused.py
    holds the JAX fused block against the XLA one.
The kernels themselves run only on the card: tests/test_torch_port_cuda.py
holds each one against its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.ops import block_fused as jbf
from bdvcil_torch.models.convert import block_params_from_jax
from bdvcil_torch.ops import _build
from bdvcil_torch.ops import block_fused as pbf
from bdvcil_torch import bench_block_fused

VARIANTS = ["taps", "im2col"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _case(seed, nt, hw, c, cm):
    """numpy x (bf16 values) and JAX BlockParams as numpy, and both sides' copies."""
    rng = np.random.default_rng(seed)
    jp = jbf.make_params(jax.random.PRNGKey(seed), c=c, cm=cm)
    p_np = {k: np.asarray(v, np.float32) for k, v in jp._asdict().items()}
    x = np.asarray(jnp.asarray(rng.standard_normal((nt, hw, hw, c)), jnp.bfloat16), np.float32)
    return x, jp, p_np


@pytest.fixture(scope="module")
def case():
    return _case(0, 8, 14, 64, 16)


def _affine(rng, k):
    a = (rng.random(k) + 0.5).astype(np.float32)
    b = (rng.standard_normal(k) * 0.5 + 0.2).astype(np.float32)
    return a, b


def _check_stats_op(jout, pout):
    jy, js1, js2 = (_np(v) for v in jout)
    py, ps1, ps2 = pout
    assert py.dtype == torch.bfloat16 and ps1.dtype == torch.float32
    pyf = py.float().numpy()
    assert pyf.shape == jy.shape
    assert np.all(np.abs(pyf - jy) <= _bf16_ulp(jy))
    np.testing.assert_allclose(ps1.numpy(), js1, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(ps2.numpy(), js2, rtol=1e-5, atol=1e-3)


def test_conv1x1_stats_matches_jax(case):
    x, _, p_np = case
    w = p_np["w1"].reshape(64, 16)
    jout = jbf.conv1x1_stats(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                             interpret=True)
    pout = pbf.conv1x1_stats(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    _check_stats_op(jout, pout)


def test_conv1x1_affine_relu_stats_matches_jax(case):
    x, _, p_np = case
    rng = np.random.default_rng(1)
    y = np.asarray(jnp.asarray(rng.standard_normal((8, 14, 14, 16)), jnp.bfloat16), np.float32)
    a, b = _affine(rng, 16)
    w = p_np["w3"].reshape(16, 64)
    jout = jbf.conv1x1_affine_relu_stats(jnp.asarray(y, jnp.bfloat16), jnp.asarray(a),
                                         jnp.asarray(b), jnp.asarray(w, jnp.bfloat16),
                                         interpret=True)
    pout = pbf.conv1x1_affine_relu_stats(torch.from_numpy(y).bfloat16(), torch.from_numpy(a),
                                         torch.from_numpy(b), torch.from_numpy(w).bfloat16())
    _check_stats_op(jout, pout)


@pytest.mark.parametrize("variant", VARIANTS)
def test_conv3x3_affine_relu_stats_matches_jax(case, variant):
    _, _, p_np = case
    rng = np.random.default_rng(2)
    y = np.asarray(jnp.asarray(rng.standard_normal((8, 14, 14, 16)), jnp.bfloat16), np.float32)
    a, b = _affine(rng, 16)  # b > 0 on most channels: a halo of relu(b) would show
    w = p_np["w2"]
    jout = jbf.conv3x3_affine_relu_stats(jnp.asarray(y, jnp.bfloat16), jnp.asarray(a),
                                         jnp.asarray(b), jnp.asarray(w, jnp.bfloat16),
                                         interpret=True, variant=variant)
    pout = pbf.conv3x3_affine_relu_stats(torch.from_numpy(y).bfloat16(), torch.from_numpy(a),
                                         torch.from_numpy(b), torch.from_numpy(w).bfloat16(),
                                         variant=variant)
    _check_stats_op(jout, pout)


def test_conv3x3_halo_is_zero_after_the_prologue():
    """With x = 0 and b > 0 every input pixel is relu(b) > 0, and the border
    output pixels see fewer of them than the interior: a halo of relu(b)
    would make the border equal to the interior."""
    k = 32
    x = torch.zeros((1, 4, 4, k), dtype=torch.bfloat16)
    a, b = torch.ones(k), torch.full((k,), 0.5)
    w = torch.ones((3, 3, k, 64), dtype=torch.bfloat16)
    for variant in VARIANTS:
        y, _, _ = pbf.conv3x3_affine_relu_stats(x, a, b, w, variant=variant)
        assert float(y[0, 0, 0, 0]) == 4 * k * 0.5  # a corner sees 2 x 2 pixels
        assert float(y[0, 1, 1, 0]) == 9 * k * 0.5


def _block_case(seed, nt, hw, c, cm):
    x, jp, p_np = _case(seed, nt, hw, c, cm)
    pp = block_params_from_jax(p_np)
    return jnp.asarray(x, jnp.bfloat16), jp, torch.from_numpy(x).bfloat16(), pp


def _check_block(pout, jout):
    (p_out, p_stats), (j_out, j_stats) = pout, jout
    assert p_out.dtype == torch.bfloat16 and p_out.shape == tuple(j_out.shape)
    np.testing.assert_allclose(p_out.float().numpy(), _np(j_out), rtol=2e-2, atol=2e-2)
    for (pm, pv), (jm, jv) in zip(p_stats, j_stats):
        np.testing.assert_allclose(pm.numpy(), _np(jm), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(pv.numpy(), _np(jv), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("geometry", [(0, 8, 14, 64, 16), (2, 6, 7, 32, 8)],
                         ids=["8x14x14x64/16", "odd-6x7x7x32/8"])
def test_fused_block_matches_jax_fused_and_xla_blocks(geometry, variant):
    jx, jp, px, pp = _block_case(*geometry)
    pout = pbf.fused_bottleneck_fwd(px, pp, conv3x3_variant=variant)
    _check_block(pout, jbf.fused_bottleneck_fwd(jx, jp, interpret=True,
                                                conv3x3_variant=variant))
    _check_block(pout, jbf.xla_bottleneck_fwd(jx, jp))


@pytest.mark.parametrize("geometry", [(0, 8, 14, 64, 16), (2, 6, 7, 32, 8)],
                         ids=["8x14x14x64/16", "odd-6x7x7x32/8"])
def test_plain_block_matches_xla_block(geometry):
    jx, jp, px, pp = _block_case(*geometry)
    _check_block(pbf.plain_bottleneck_fwd(px, pp), jbf.xla_bottleneck_fwd(jx, jp))


def test_fused_block_plain_composition_is_the_cpu_dispatch(case):
    """On the CPU the dispatching ops run the plain versions: the two
    compositions agree bit for bit, and no kernel is launched."""
    _, _, p_np = case
    x = torch.from_numpy(case[0]).bfloat16()
    pp = block_params_from_jax(p_np)
    _build.LAUNCHES.clear()
    out, stats = pbf.fused_bottleneck_fwd(x, pp, conv3x3_variant="im2col")
    ref, ref_stats = pbf.fused_bottleneck_fwd_plain(x, pp, conv3x3_variant="im2col")
    assert sum(_build.LAUNCHES.values()) == 0
    assert torch.equal(out, ref)
    for (m, v), (rm, rv) in zip(stats, ref_stats):
        assert torch.equal(m, rm) and torch.equal(v, rv)


def test_block_params_from_jax_carries_the_weights(case):
    _, jp, p_np = case
    pp = block_params_from_jax(p_np)
    assert pp.w1.shape == (64, 16) and pp.w3.shape == (16, 64) and pp.w2.shape == (3, 3, 16, 16)
    assert pp.w1.dtype == torch.bfloat16 and pp.g1.dtype == torch.float32
    for name in pbf.BlockParams._fields:
        ref = np.asarray(getattr(jp, name), np.float32)
        got = getattr(pp, name).float().numpy()
        np.testing.assert_array_equal(got, ref.reshape(got.shape))
    # a NamedTuple of numpy arrays works as well as a mapping
    again = block_params_from_jax(jbf.BlockParams(**p_np))
    assert all(torch.equal(u, v) for u, v in zip(again, pp))


def test_make_params_draws_like_jax_shapes_and_scales():
    pp = pbf.make_params(torch.Generator().manual_seed(0), c=256, cm=64, device="cpu")
    jp = jbf.make_params(jax.random.PRNGKey(0), c=256, cm=64)
    for name in pbf.BlockParams._fields:
        got, ref = getattr(pp, name), np.asarray(getattr(jp, name), np.float32)
        assert got.numel() == ref.size
        assert str(got.dtype).split(".")[-1] == str(getattr(jp, name).dtype)
        # the same distribution: the spread agrees to sampling noise
        assert abs(float(got.float().std()) - float(ref.std())) < 0.2 * float(ref.std())
    assert float(pp.w2.float().abs().max()) <= 2 * (1 / (9 * 64)) ** 0.5 / 0.8796 + 1e-3


def test_forward_only_ops_refuse_inputs_that_require_grad(case):
    x = torch.from_numpy(case[0]).bfloat16().requires_grad_(True)
    pp = block_params_from_jax(case[2])
    k = 16
    y = torch.zeros((8, 14, 14, k), dtype=torch.bfloat16)
    a, b = torch.ones(k, requires_grad=True), torch.zeros(k)
    with pytest.raises(RuntimeError, match="forward-only"):
        pbf.conv1x1_stats(x, pp.w1)
    with pytest.raises(RuntimeError, match="forward-only"):
        pbf.conv1x1_affine_relu_stats(y, a, b, pp.w3)
    with pytest.raises(RuntimeError, match="forward-only"):
        pbf.conv3x3_affine_relu_stats(y, a, b, pp.w2)
    with pytest.raises(RuntimeError, match="forward-only"):
        pbf.fused_bottleneck_fwd(x, pp)


def test_stats_ops_refuse_devices_and_variants_they_have_no_kernel_for():
    x = torch.empty((2, 4, 4, 32), device="meta", dtype=torch.bfloat16)
    a = torch.empty((32,), device="meta")
    with pytest.raises(NotImplementedError):
        pbf.conv1x1_stats(x, torch.empty((32, 64), device="meta", dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError):
        pbf.conv1x1_affine_relu_stats(x, a, a, torch.empty((32, 64), device="meta"))
    with pytest.raises(NotImplementedError):
        pbf.conv3x3_affine_relu_stats(x, a, a, torch.empty((3, 3, 32, 64), device="meta"))
    with pytest.raises(ValueError, match="variant"):
        pbf.conv3x3_affine_relu_stats(x, a, a, torch.empty((3, 3, 32, 64)), variant="wgmma")


def test_bench_runs_on_the_cpu_when_asked(capsys):
    assert bench_block_fused.main(["2", "--parts", "--rows", "4", "--hw", "6", "--c", "32",
                                   "--cm", "8", "--device", "cpu"]) == 0
    import json
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["device"] == "cpu" and result["rows"] == 4
    for key in ("fused_taps_ms_per_block", "fused_im2col_ms_per_block", "plain_ms_per_block",
                "fused_conv2_3x3_ms", "lib_conv2_3x3_ms"):
        assert result[key] > 0


def test_bench_and_make_params_need_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pbf.make_params(torch.Generator().manual_seed(0), c=32, cm=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_block_fused.main(["1", "--rows", "2", "--hw", "4", "--c", "32", "--cm", "8"])
