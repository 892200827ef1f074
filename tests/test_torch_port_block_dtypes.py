"""The block probe at every dtype and shape the JAX ops take, on the CPU.

The JAX package's block ops (``bdvcil_tpu/ops/block_fused.py``) take any
dtype and any (NT, H, W, C): their kernels cast to ``x_ref.dtype`` and their
BlockSpecs take any h, w, k and n. The port's run float32 on the 3xTF32
kernel (conv1, conv3 and the 3x3, any width below 65536), and bfloat16 on the
wgmma core, at any channel count (zero-padded for the TMA) and any width below
65536; the block's tail at any channel count. Here the ops run their plain
versions, and
these tests hold them and what surrounds the kernels against the JAX
package, with the same numpy inputs (JAX's Pallas kernels in interpret
mode):

  * each stats op and ``fused_bottleneck_fwd`` in float32 at the JAX tests'
    geometries (c=64, cm=16 at 14²; c=32, cm=8 at 7²) and at W = 64 > 63:
    y rtol 1e-5, atol 1e-6 of max |y| (f32 sums of another order, and XLA
    may contract the prologue's product and sum into one FMA); the
    statistics rtol 1e-5, atol 1e-6 of the largest; the block's output
    within 1e-4 of the terms' size and its (mean, var) rtol 1e-4, atol 1e-5,
    as the card holds the f32 block (``chip_smoke.F32_BLOCK_TOL``); the same
    block composed of the 3xTF32 kernels' emulated arithmetic
    (``ops/tf32``: #6, #7 and #8, the tail plain) against JAX's, both
    variant names, at the same tolerances;
  * bf16 at W = 64 and 112 and at channel counts that are not multiples of
    8: y within one bf16 ulp, the ulp taken at no less than 1/256 of y's rms
    (near zero the f32 accumulation order, not the rounding, sets the error:
    the floor of the card tests); each side's statistics against the f64
    sums of its own rounded y rtol 1e-5, atol 1e-4, as
    tests/test_torch_port_stats_gemm_dtypes.py holds the bf16 GEMMs (a y an
    ulp apart moves the sums over 8192 rows by up to 1e-2);
  * past the bf16 3x3's old widest image (W = 271), where both 3x3 kernels
    read their window in three bands: the 3x3 at (1, 3, 300, 8) and the
    block at (2, 3, 320, 32 -> 8), bf16 and f32, at the tolerances above
    (the bf16 block: tests/test_torch_port_block_fused.py's); the block at
    C = 6400 > 6144 (once the tail kernels' most channels) in both dtypes,
    its tail bit for bit against JAX's expression (block_fused.py:289-292);
  * the wrappers' channel padding (x with zero channels, a = b = 0 there, w
    with zero rows in every tap and zero columns) on the plain versions:
    y bit for bit the unpadded result's, the statistics rtol 1e-6 (the CPU
    sums a padded row in another order);
  * the 3x3's shape rule (``gemm_plan.conv3x3_plan``): window boxes and
    bands, stages, tile width, its shared memory worked by hand;
  * ``launch_name`` routing of the four float32 launch names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdvcil_tpu.ops import block_fused as jbf
from bdvcil_torch.models.convert import block_params_from_jax
from bdvcil_torch.ops import _build, gemm_plan
from bdvcil_torch.ops import block_fused as pbf
from bdvcil_torch.ops import conv1x1_bn as port_conv
from bdvcil_torch.ops import tf32
from tests.test_torch_port_block_epilogue import _jax_last_pass
from tests.test_torch_port_block_fused import _check_block

VARIANTS = ["taps", "im2col"]
# (seed, NT, H = W, C, Cm): tests/test_block_fused.py's two geometries and W > 63
GEOMETRIES = [(0, 8, 14, 64, 16), (2, 6, 7, 32, 8), (3, 2, 64, 32, 8)]
IDS = ["8x14x14x64/16", "6x7x7x32/8", "2x64x64x32/8"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _affine(rng, k):
    """a in [0.5, 1.5), b > 0 on every channel: a halo of relu(b) would show."""
    return ((rng.random(k) + 0.5).astype(np.float32),
            (rng.random(k) * 0.5 + 0.1).astype(np.float32))


def _check_f32(jout, pout):
    jy, js1, js2 = (_np(v) for v in jout)
    py, ps1, ps2 = pout
    assert py.dtype == torch.float32 and ps1.dtype == ps2.dtype == torch.float32
    pyf = py.numpy()
    assert pyf.shape == jy.shape
    np.testing.assert_allclose(pyf, jy, rtol=1e-5, atol=1e-6 * np.abs(jy).max())
    for p, j in ((ps1, js1), (ps2, js2)):
        np.testing.assert_allclose(p.numpy(), j, rtol=1e-5, atol=1e-6 * np.abs(j).max())


def _check_bf16(jout, pout):
    jy, js1, js2 = (_np(v) for v in jout)
    py, ps1, ps2 = pout
    assert py.dtype == torch.bfloat16 and ps1.dtype == ps2.dtype == torch.float32
    pyf = py.float().numpy()
    assert pyf.shape == jy.shape
    floor = np.sqrt(np.mean(jy.astype(np.float64) ** 2)) / 256
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(jy), floor))) - 7)
    assert np.all(np.abs(pyf - jy) <= ulp)
    n = jy.shape[-1]
    for s1, s2, y in ((ps1.numpy(), ps2.numpy(), pyf), (js1, js2, jy)):
        yd = y.reshape(-1, n).astype(np.float64)
        np.testing.assert_allclose(s1, yd.sum(0), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(s2, (yd * yd).sum(0), rtol=1e-5, atol=1e-4)


def _stats_op_case(op, seed, nt, hw, k, n, dtype):
    """The op's inputs as numpy (f32 values exact in ``dtype``), and JAX's and
    the port's outputs; ``hw`` is H = W, or (H, W)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    h, w_ = hw if isinstance(hw, tuple) else (hw, hw)

    def exact(a):
        return _np(jnp.asarray(a, jdt))

    x = exact(rng.standard_normal((nt, h, w_, k)))
    a, b = _affine(rng, k)
    three = op.startswith("conv3x3")
    wshape, fan_in = ((3, 3, k, n), 9 * k) if three else ((k, n), k)
    w = exact(rng.standard_normal(wshape) / np.sqrt(fan_in))
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    px, pw = torch.tensor(x).to(tdt), torch.tensor(w).to(tdt)
    ja, jb, pa, pb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)
    if op == "conv1x1":
        return (jbf.conv1x1_stats(jx, jw, interpret=True), pbf.conv1x1_stats(px, pw))
    if op == "conv1x1_affine":
        return (jbf.conv1x1_affine_relu_stats(jx, ja, jb, jw, interpret=True),
                pbf.conv1x1_affine_relu_stats(px, pa, pb, pw))
    variant = op.split("_")[-1] if "_" in op else "taps"
    return (jbf.conv3x3_affine_relu_stats(jx, ja, jb, jw, interpret=True, variant=variant),
            pbf.conv3x3_affine_relu_stats(px, pa, pb, pw, variant=variant))


@pytest.mark.parametrize("op", ["conv1x1", "conv1x1_affine", "conv3x3", "conv3x3_im2col"])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_f32_stats_ops_match_jax_interpret(geometry, op):
    seed, nt, hw, c, cm = geometry
    k, n = {"conv1x1": (c, cm), "conv1x1_affine": (cm, c)}.get(op, (cm, cm))
    _check_f32(*_stats_op_case(op, seed, nt, hw, k, n, "float32"))


# The f32 block's output against JAX's: |out - ref| <= TOL * (1 + |ref| + |x| +
# |b3|), the terms of relu(y3 * a3 + b3 + x) (``chip_smoke.off_terms``). On the
# CPU the largest f32 gap is 3.0e-6 of that scale (2x64x64x32/8 im2col); the
# same block with x and the conv weights in bf16 is 3.3e-2 off at the least,
# and with them rounded to TF32's 10-bit mantissa 2.9e-3: a composition that
# dropped below f32 fails.
F32_BLOCK_TOL, F32_BLOCK_STATS_RTOL, F32_BLOCK_STATS_ATOL = 1e-4, 1e-4, 1e-5


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_f32_block_matches_jax_fused_block(geometry, variant):
    """The f32 block against JAX's, at F32_BLOCK_TOL of the terms' size; its
    (mean, var) rtol 1e-4, atol 1e-5 (the largest gap 1.1e-6)."""
    seed, nt, hw, c, cm = geometry
    rng = np.random.default_rng(seed)
    jp = jbf.make_params(jax.random.PRNGKey(seed), c=c, cm=cm, dtype=jnp.float32)
    pp = block_params_from_jax({k: np.asarray(v) for k, v in jp._asdict().items()},
                               dtype=torch.float32)
    x = rng.standard_normal((nt, hw, hw, c)).astype(np.float32)
    _build.LAUNCHES.clear()
    p_out, p_stats = pbf.fused_bottleneck_fwd(torch.from_numpy(x), pp, conv3x3_variant=variant)
    assert sum(_build.LAUNCHES.values()) == 0
    j_out, j_stats = jbf.fused_bottleneck_fwd(jnp.asarray(x), jp, interpret=True,
                                              conv3x3_variant=variant)
    assert p_out.dtype == torch.float32 and p_out.shape == tuple(j_out.shape)
    ref = _np(j_out)
    scale = 1 + np.abs(ref) + np.abs(x) + np.abs(np.asarray(jp.b3)).reshape(-1)
    assert np.all(np.abs(p_out.numpy() - ref) <= F32_BLOCK_TOL * scale)
    for (pm, pv), (jm, jv) in zip(p_stats, j_stats):
        for p, j in ((pm, jm), (pv, jv)):
            np.testing.assert_allclose(p.numpy(), _np(j), rtol=F32_BLOCK_STATS_RTOL,
                                       atol=F32_BLOCK_STATS_ATOL)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_f32_block_on_the_3xtf32_arithmetic_matches_jax_fused_block(geometry, variant):
    """The f32 block as the card computes it: #6, #7 and #8 in the 3xTF32
    kernel's arithmetic (``ops/tf32``'s emulations: the prologue rounded,
    then the split; 32-wide k-steps, the 3x3 slice by slice and tap by tap),
    the BatchNorm finalizes and the tail plain, against JAX's fused block at
    F32_BLOCK_TOL of the terms' size, (mean, var) rtol 1e-4, atol 1e-5."""
    seed, nt, hw, c, cm = geometry
    rng = np.random.default_rng(seed + 10)
    jp = jbf.make_params(jax.random.PRNGKey(seed), c=c, cm=cm, dtype=jnp.float32)
    pp = block_params_from_jax({k: np.asarray(v) for k, v in jp._asdict().items()},
                               dtype=torch.float32)
    x = rng.standard_normal((nt, hw, hw, c)).astype(np.float32)
    p_out, p_stats = pbf._bottleneck(
        torch.from_numpy(x), pp, 1e-5, tf32.gemm_stats_3xtf32_emulated,
        tf32.conv3x3_affine_relu_stats_3xtf32_emulated, tf32.affine_relu_stats_3xtf32_emulated,
        pbf.bn_finalize_plain, pbf.affine_residual_relu_plain)
    j_out, j_stats = jbf.fused_bottleneck_fwd(jnp.asarray(x), jp, interpret=True,
                                              conv3x3_variant=variant)
    ref = _np(j_out)
    assert p_out.dtype == torch.float32 and p_out.shape == ref.shape
    scale = 1 + np.abs(ref) + np.abs(x) + np.abs(np.asarray(jp.b3)).reshape(-1)
    assert np.all(np.abs(p_out.numpy() - ref) <= F32_BLOCK_TOL * scale)
    for (pm, pv), (jm, jv) in zip(p_stats, j_stats):
        for p, j in ((pm, jm), (pv, jv)):
            np.testing.assert_allclose(p.numpy(), _np(j), rtol=F32_BLOCK_STATS_RTOL,
                                       atol=F32_BLOCK_STATS_ATOL)


# (op, seed, NT, H = W, K, N): W = 64 and 112, past the one-box window; channel
# counts that are not multiples of 8 (the wrapper pads them on the card)
BF16_CASES = [("conv3x3", 4, 2, 64, 16, 16), ("conv3x3_im2col", 5, 1, 112, 8, 24),
              ("conv3x3", 6, 3, 7, 12, 20), ("conv3x3_im2col", 7, 2, 5, 3, 5),
              ("conv1x1_affine", 8, 2, 64, 16, 64), ("conv1x1_affine", 9, 3, 7, 12, 20),
              ("conv1x1", 10, 2, 7, 13, 6)]


@pytest.mark.parametrize("case", BF16_CASES, ids=[f"{c[0]}-{c[3]}w-{c[4]}x{c[5]}"
                                                  for c in BF16_CASES])
def test_bf16_wide_and_ragged_ops_match_jax_interpret(case):
    op, seed, nt, hw, k, n = case
    _check_bf16(*_stats_op_case(op, seed, nt, hw, k, n, "bfloat16"))


def _conv3x3_plain(x, w, a, b):
    return pbf.conv3x3_affine_relu_stats_plain(x, a, b, w)


def _conv1x1_affine_plain(x, w, a, b):
    return pbf.conv1x1_affine_relu_stats_plain(x, a, b, w)


# (op, NT, H, W, K, N): K and/or N not multiples of 8, and one already aligned
PAD_CASES = [("conv3x3", 2, 5, 7, 12, 20), ("conv3x3", 1, 4, 9, 3, 5), ("conv3x3", 2, 3, 3, 16, 13),
             ("conv1x1", 3, 7, 7, 12, 20), ("conv1x1", 2, 5, 5, 5, 64), ("conv3x3", 1, 3, 4, 8, 8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", PAD_CASES, ids=[f"{c[0]}-{c[4]}x{c[5]}" for c in PAD_CASES])
def test_channel_padding_keeps_the_plain_result(case, dtype):
    """The bf16 wrappers' padding (``conv1x1_bn.aligned_call``), applied to the
    plain versions: zero channels of x with a = b = 0, zero rows of w in every
    tap and zero columns change neither y nor the statistics."""
    op, nt, h, w_, k, n = case
    rng = np.random.default_rng(k * 100 + n)
    x = torch.from_numpy(rng.standard_normal((nt, h, w_, k)).astype(np.float32)).to(dtype)
    a, b = (torch.from_numpy(v) for v in _affine(rng, k))
    wshape = (3, 3, k, n) if op == "conv3x3" else (k, n)
    w = torch.from_numpy((rng.standard_normal(wshape) * 0.1).astype(np.float32)).to(dtype)
    fwd = _conv3x3_plain if op == "conv3x3" else _conv1x1_affine_plain
    y, s1, s2 = port_conv.aligned_call(fwd, x, w, a, b)
    ry, rs1, rs2 = fwd(x, w, a, b)
    assert y.shape == ry.shape == (nt, h, w_, n) and y.is_contiguous()
    assert torch.equal(y, ry)
    for got, ref in ((s1, rs1), (s2, rs2)):
        assert got.shape == (n,)
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * float(ref.abs().max()))


def test_conv3x3_plan_takes_wide_images_in_boxes():
    """W = 64 and 112: the window of 128 + 2 W + 2 rows in two boxes of equal
    rows, each a whole number of swizzle periods and at most 256 rows, the
    widest ring still fitting at Cout 64."""
    for w, rows in ((64, 136), (112, 184)):
        plan = gemm_plan.conv3x3_plan(128 * w * w, 64, w, 64, 132)
        assert (plan.boxes, plan.box_rows) == (2, rows)
        assert 2 * rows >= 128 + 2 * w + 2 and rows % 8 == 0 and rows <= gemm_plan.MAX_BOX_ROWS
        assert (plan.block_n, plan.stages) == (64, 6) and plan.smem <= gemm_plan.MAX_SMEM
    for w in range(1, 64):  # one box of exactly the window up to W = 63
        assert gemm_plan.window_plan(w)[:2] == (1, 128 + 2 * w + 2)


# the widest image the bf16 3x3 took at each Cin before its window came in
# bands (64 columns, 2 stages, two windows of boxes and a, b over C in a CTA)
OLD_WIDEST = {8: 271, 64: 271, 512: 271, 2048: 247}


@pytest.mark.parametrize("c", [8, 64, 512, 2048])
def test_conv3x3_plan_gives_way_before_it_refuses(c):
    """Past the widest ring the plan takes fewer stages, then a narrower
    tile; it no longer refuses: one column past the image it once refused
    at this Cin, and at W = 4096, the window is three bands of 136 rows and
    the 1x1's 256-wide tile keeps 2 of its 3 stages at Cout 512, or, at Cin
    2048 (9 x 32 k-steps: a deep product, two accumulator arrays), the
    128-wide tile its 4; Cout = Cin keeps the 1x1's width (a and b take at
    most 16 KB of shared memory)."""
    ksteps = gemm_plan.conv3x3_ksteps(c)
    bn, stages = (128, 4) if ksteps > gemm_plan.WHOLE_STEPS else (256, 2)
    assert (bn == 128) == (c == 2048)
    for w in (OLD_WIDEST[c] + 1, 4096):
        m = 2 * w * w
        plan = gemm_plan.conv3x3_plan(m, 512, w, c, 132)
        assert (plan.boxes, plan.box_rows, plan.box_step, plan.band) == (3, 136, w, 136)
        assert gemm_plan.wgmma_plan(m, 512, 132, ksteps=ksteps).block_n == plan.block_n == bn
        assert plan.stages == stages and plan.smem <= gemm_plan.MAX_SMEM
        assert (stages == gemm_plan.CONV3X3_MAX_STAGES[bn]
                or gemm_plan.conv3x3_smem(bn, stages + 1, w, c) > gemm_plan.MAX_SMEM)
        plan = gemm_plan.conv3x3_plan(m, c, w, c, 132)  # Cout = Cin: the 1x1's width too
        assert plan.block_n == gemm_plan.wgmma_plan(m, c, 132, ksteps=ksteps).block_n
    # W = 96 at Cout 512: the 1x1's 256-wide tile keeps 2 of its 3 stages
    assert gemm_plan.wgmma_plan(128 * 96 * 96, 512, 132, ksteps=ksteps).block_n == bn
    plan = gemm_plan.conv3x3_plan(128 * 96 * 96, 512, 96, c, 132)
    assert (plan.block_n, plan.stages, plan.boxes) == (bn, stages, 2)


def test_conv3x3_smem_is_the_kernel_layout_at_layer1():
    """sm90::Layout<64, kIm2col> at W = 56, 6 stages, one box of 242 rows,
    worked by hand: 6 x 8192 (w) + 2 x 16384 (A) + 2 x 31744 (windows) +
    4096 (sums) + 128 (barriers) + 512 (a, b) + 1024 (slack); at a banded
    W two windows of 3 x 136 rows (52,224 bytes each) in place of the boxes;
    past 2048 channels a and b a 64-channel slice for each window (1024)."""
    assert gemm_plan.conv3x3_smem(64, 6, 56, 64) == (6 * 8192 + 2 * 16384 + 2 * 31744 + 4096
                                                     + 128 + 512 + 1024)
    assert gemm_plan.conv3x3_smem(64, 6, 320, 64) == (6 * 8192 + 2 * 16384 + 2 * 52224 + 4096
                                                      + 128 + 512 + 1024)
    assert gemm_plan.conv3x3_smem(64, 6, 56, 2048) - gemm_plan.conv3x3_smem(64, 6, 56, 64) == \
        2 * 4 * (2048 - 64)
    assert gemm_plan.conv3x3_smem(64, 6, 56, 2056) == gemm_plan.conv3x3_smem(64, 6, 56, 128)


# past the bf16 3x3's old widest image: (seed, NT, H, W, K, N) of the op, and
# (seed, NT, H, W, C, Cm) of the block
BANDED_3X3 = (11, 1, 3, 300, 8, 8)
BANDED_BLOCK = (12, 2, 3, 320, 32, 8)
WIDE_TAIL_BLOCK = (13, 2, 2, 2, 6400, 16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("op", ["conv3x3", "conv3x3_im2col"])
def test_3x3_past_the_old_widest_image_matches_jax_interpret(op, dtype):
    seed, nt, h, w_, k, n = BANDED_3X3
    check = _check_bf16 if dtype == "bfloat16" else _check_f32
    check(*_stats_op_case(op, seed, nt, (h, w_), k, n, dtype))


def _block_at(geometry, dtype):
    """JAX's fused block (interpret mode) and the port's on the CPU, from one
    seed's parameters and numpy input."""
    seed, nt, h, w_, c, cm = geometry
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jbf.make_params(jax.random.PRNGKey(seed), c=c, cm=cm, dtype=jdt)
    pp = block_params_from_jax({k: np.asarray(v) for k, v in jp._asdict().items()}, dtype=tdt)
    x = _np(jnp.asarray(np.random.default_rng(seed).standard_normal((nt, h, w_, c)), jdt))
    _build.LAUNCHES.clear()
    pout = pbf.fused_bottleneck_fwd(torch.from_numpy(x).to(tdt), pp)
    assert sum(_build.LAUNCHES.values()) == 0
    jout = jbf.fused_bottleneck_fwd(jnp.asarray(x, jdt), jp, interpret=True)
    return x, jp, pout, jout


def _check_block_f32(x, jp, pout, jout):
    (p_out, p_stats), (j_out, j_stats) = pout, jout
    ref = _np(j_out)
    assert p_out.dtype == torch.float32 and p_out.shape == ref.shape
    scale = 1 + np.abs(ref) + np.abs(x) + np.abs(np.asarray(jp.b3)).reshape(-1)
    assert np.all(np.abs(p_out.numpy() - ref) <= F32_BLOCK_TOL * scale)
    for (pm, pv), (jm, jv) in zip(p_stats, j_stats):
        for p, j in ((pm, jm), (pv, jv)):
            np.testing.assert_allclose(p.numpy(), _np(j), rtol=F32_BLOCK_STATS_RTOL,
                                       atol=F32_BLOCK_STATS_ATOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("geometry", [BANDED_BLOCK, WIDE_TAIL_BLOCK],
                         ids=["2x3x320x32/8", "2x2x2x6400/16"])
def test_block_past_the_old_limits_matches_jax_fused_block(geometry, dtype):
    """The block where the bf16 3x3 once refused (W = 320) and where the tail
    once refused (C = 6400): bf16 at tests/test_torch_port_block_fused.py's
    tolerances, f32 at F32_BLOCK_TOL."""
    x, jp, pout, jout = _block_at(geometry, dtype)
    if dtype == "bfloat16":
        _check_block(pout, jout)
    else:
        _check_block_f32(x, jp, pout, jout)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tail_past_6144_channels_is_jax_expression(dtype):
    """affine_residual_relu at C = 6400 (and 8193: off the 16-byte packs)
    against JAX's last pass (block_fused.py:289-292) run op by op, bit for
    bit, NaN kept."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for c in (6400, 8193):
        rng = np.random.default_rng(c)
        y = np.array(_np(jnp.asarray(rng.standard_normal((3, c)) * 3, jdt)))
        x = _np(jnp.asarray(rng.standard_normal((3, c)), jdt))
        y[1, :8] = np.nan
        a = (rng.random(c) + 0.5).astype(np.float32)
        b = (rng.standard_normal(c) * 0.5).astype(np.float32)
        got = pbf.affine_residual_relu(torch.from_numpy(y).to(tdt), torch.from_numpy(a),
                                       torch.from_numpy(b), torch.from_numpy(x).to(tdt))
        want = _np(_jax_last_pass(jnp.asarray(y, jdt), jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(x, jdt)))
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("name,f32", [(pbf.CONV1, pbf.CONV1_F32), (pbf.CONV2, pbf.CONV2_F32),
                                      (pbf.CONV3, pbf.CONV3_F32),
                                      (pbf.EPILOGUE, pbf.EPILOGUE_F32)])
def test_launch_name_routes_the_block_ops(name, f32):
    assert f32 == name + "_f32"
    assert port_conv.launch_name(name, torch.float32, torch.float32) == f32
    assert port_conv.launch_name(name, torch.bfloat16, torch.bfloat16) == name
    for dtypes in ((torch.float16, torch.float16), (torch.float32, torch.bfloat16)):
        with pytest.raises(TypeError):
            port_conv.launch_name(name, *dtypes)


def test_block_wrappers_refuse_float16_before_they_build():
    h = torch.zeros((1, 4, 4, 8), dtype=torch.float16)
    v = torch.ones(8)
    _build.LAUNCHES.clear()
    with pytest.raises(TypeError):
        pbf._conv3x3_cuda(h, v, v, torch.zeros((3, 3, 8, 8), dtype=torch.float16), "taps")
    with pytest.raises(TypeError):
        pbf._conv1x1_affine_cuda(h, v, v, torch.zeros((8, 8), dtype=torch.float16))
    with pytest.raises(TypeError):
        pbf._conv3x3_cuda(h.float(), v, v, torch.zeros((3, 3, 8, 8), dtype=torch.bfloat16),
                          "taps")
    with pytest.raises(TypeError):
        pbf._affine_residual_relu_cuda(h, v, v, h)
    assert sum(_build.LAUNCHES.values()) == 0


def test_block_params_from_jax_carries_f32_weights():
    jp = jbf.make_params(jax.random.PRNGKey(1), c=32, cm=8, dtype=jnp.float32)
    pp = block_params_from_jax({k: np.asarray(v) for k, v in jp._asdict().items()},
                               dtype=torch.float32)
    for name in pbf.BlockParams._fields:
        got, ref = getattr(pp, name), np.asarray(getattr(jp, name))
        assert got.dtype == torch.float32 and ref.dtype == np.float32
        np.testing.assert_array_equal(got.numpy(), ref.reshape(got.shape))
    assert pp.w1.shape == (32, 8) and pp.w3.shape == (8, 32) and pp.w2.shape == (3, 3, 8, 8)
