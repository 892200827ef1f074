"""The 3xTF32 float32 GEMM with statistics, on the CPU.

On the card the port runs float32 ``conv1x1_with_stats``, ``gemm_with_stats``
and the block's conv1 as three TF32 products on the tensor cores
(``csrc/gemm_stats_tf32.cu``). These tests hold, without a card, what that
design promises and what surrounds the kernel:

  * the split (``ops/tf32.py``): big = tf32(x) and small = tf32(x - big) with
    their low 13 mantissa bits zero, x - big exact, the rounding equal to an
    independent numpy reference on the bits (to nearest, ties away, as PTX's
    ``cvt.rna.tf32.f32``), and values past TF32's largest finite turned to
    inf, so y is NaN there (a deliberate divergence from the f32 product);
  * the emulated 3xTF32 product against the JAX package's float32
    ``gemm_with_stats`` (``interpret=True``) at the 12 ResNet-50 1x1 (K, N),
    M cut to 1024, held to ``chip_smoke.py`` phase 19's gates: y rtol 1e-5,
    atol 1e-6 of max |y|; the statistics rtol 1e-4, atol 1e-4 of the largest;
  * one TF32 pass misses that y gate at every one of those shapes, so the
    gate tells the two designs apart;
  * the kernel's tile plan (``gemm_plan.tf32_plan``): tiles that cover the
    product once, a grid of at most one CTA an SM (the partial rows the
    finish sums), shared memory within a CTA's;
  * the wrapper's launch arguments: the SM count as the partials' rows, and
    an x that is not 16-byte aligned copied for the TMA;
  * the padding of K and N to multiples of 4 for the TMA, applied to the plain
    version, and the route: float32 without a prologue to the 3xTF32 kernel,
    with one to the FFMA kernel, and no fallback when the kernel raises.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bdvcil_tpu.ops import conv1x1_bn as jax_conv
from bdvcil_torch.ops import _build, gemm_plan
from bdvcil_torch.ops import conv1x1_bn as port_conv
from bdvcil_torch.ops import tf32

R50 = sorted({(k, n) for _, k, n in gemm_plan.r50_1x1_shapes()})
M = 1024  # the R50 rows cut to size
RAGGED = [(100, 32, 128), (896, 96, 128), (1000, 3, 5), (4096, 100, 101), (4096, 96, 101)]
# chip_smoke.py phase 19's gates (F32_Y_RTOL, F32_Y_ATOL, F32_STATS_RTOL)
Y_RTOL, Y_ATOL, STATS_RTOL = 1e-5, 1e-6, 1e-4
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_tf32_bits(x: np.ndarray) -> np.ndarray:
    """TF32 rounding on the uint32 bits, sign and magnitude apart: keep the
    top 10 mantissa bits, add one where the 13 dropped bits are half or more."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    sign, mag = b & 0x80000000, b & 0x7FFFFFFF
    kept = (mag >> 13) + ((mag & 0x1FFF) >= 0x1000)
    return (sign | (kept << 13)).astype(np.uint32)


FINITE_TF32 = st.floats(min_value=-tf32.TF32_MAX, max_value=tf32.TF32_MAX, width=32,
                        allow_nan=False, allow_infinity=False)


@settings(max_examples=400, deadline=None, database=None)
@given(st.lists(FINITE_TF32, min_size=1, max_size=64))
def test_split_is_exact_and_clears_the_low_bits(values):
    x = torch.tensor(values, dtype=torch.float32)
    big, small = tf32.split_3xtf32(x)
    assert torch.equal(big + (x - big), x)
    for part in (big, small):
        assert bool(torch.isfinite(part).all())
        assert not bool((part.view(torch.int32) & 0x1FFF).any())


@settings(max_examples=400, deadline=None, database=None)
@given(st.lists(st.floats(width=32, allow_nan=False), min_size=1, max_size=64))
def test_round_tf32_equals_a_numpy_reference_on_the_bits(values):
    x = np.asarray(values, dtype=np.float32)
    got = tf32.round_tf32(torch.from_numpy(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, _numpy_tf32_bits(x))


@pytest.mark.parametrize("value,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),        # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                      # below the tie: down
    (tf32.TF32_MAX, tf32.TF32_MAX),               # TF32's largest finite stays
    (float(np.finfo(np.float32).max), float("inf")),  # past it: inf, as cvt.rna
    (float("-inf"), float("-inf")),
    (2.0 ** -136, 2.0 ** -136),                   # a subnormal with no dropped bits
    (2.0 ** -140, 0.0),                           # one below the half unit: to zero
])
def test_round_tf32_at_the_edges(value, want):
    got = tf32.round_tf32(torch.tensor([value], dtype=torch.float32))
    assert got.item() == want


def test_round_tf32_keeps_nan_and_refuses_other_dtypes():
    assert bool(torch.isnan(tf32.round_tf32(torch.tensor([float("nan")]))).all())
    with pytest.raises(TypeError):
        tf32.round_tf32(torch.zeros(2, dtype=torch.float64))


def test_values_past_tf32_max_give_nan():
    """The pinned divergence: x past TF32's largest finite becomes big = inf,
    small = -inf, so y is NaN where the f32 product is finite."""
    x = torch.tensor([[float(np.finfo(np.float32).max), 1.0]])
    w = torch.tensor([[2.0 ** -100], [1.0]])
    y, s1, s2 = tf32.gemm_stats_3xtf32_emulated(x, w)
    assert bool(torch.isfinite(x @ w).all())
    assert bool(torch.isnan(y).all()) and bool(torch.isnan(s1).all())


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _jax_f32(x, w):
    y, s1, s2 = jax_conv.gemm_with_stats(jnp.asarray(x), jnp.asarray(w), True)
    return tuple(np.asarray(v, np.float32) for v in (y, s1, s2))


def _assert_gate(y, s1, s2, ref):
    ry, rs1, rs2 = ref
    np.testing.assert_allclose(y, ry, rtol=Y_RTOL, atol=Y_ATOL * np.abs(ry).max())
    for got, want in ((s1, rs1), (s2, rs2)):
        np.testing.assert_allclose(got, want, rtol=STATS_RTOL,
                                   atol=STATS_RTOL * np.abs(want).max())


@pytest.mark.parametrize("kn", R50)
def test_3xtf32_matches_jax_f32_at_r50_shapes(kn):
    k, n = kn
    x, w = _operands(M, k, n, seed=k + n)
    y, s1, s2 = tf32.gemm_stats_3xtf32_emulated(torch.from_numpy(x), torch.from_numpy(w))
    assert y.shape == (M, n) and y.dtype == torch.float32
    _assert_gate(y.numpy(), s1.numpy(), s2.numpy(), _jax_f32(x, w))


@pytest.mark.parametrize("kn", R50)
def test_one_tf32_pass_misses_the_gate(kn):
    k, n = kn
    x, w = _operands(M, k, n, seed=k + n)
    ry = _jax_f32(x, w)[0]
    one = (tf32.round_tf32(torch.from_numpy(x)) @ tf32.round_tf32(torch.from_numpy(w))).numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(one, ry, rtol=Y_RTOL, atol=Y_ATOL * np.abs(ry).max())


@pytest.mark.parametrize("mkn", sorted(gemm_plan.r50_1x1_shapes()) + RAGGED)
def test_tf32_plan_covers_the_product_once(mkn):
    """Every row and column lies in exactly one tile of a width the kernel
    has, N rounded up to 4 (the wrapper's padding); one partial row a CTA of
    a grid of at most one CTA an SM; the CTA's shared memory within 227 KB."""
    m, _, n = mkn
    n4 = -(-n // 4) * 4
    p = gemm_plan.tf32_plan(m, n4, H100_SMS)
    assert p.block_n in (64, 128) and p.stages == gemm_plan.TF32_STAGES[p.block_n]
    assert (p.m_tiles - 1) * gemm_plan.BLOCK_M < m <= p.m_tiles * gemm_plan.BLOCK_M
    assert (p.n_tiles - 1) * p.block_n < n4 <= p.n_tiles * p.block_n
    assert p.tiles == p.m_tiles * p.n_tiles and p.grid == min(p.tiles, H100_SMS)
    assert p.smem == gemm_plan.tf32_smem(p.block_n) <= gemm_plan.MAX_SMEM


@pytest.mark.parametrize("mn,sms,want", [
    ((401408, 64), 132, (64, 3136, 1, 3136, 132)),
    ((401408, 256), 132, (128, 3136, 2, 6272, 132)),
    ((6272, 2048), 132, (128, 49, 16, 784, 132)),
    ((6272, 512), 132, (64, 49, 8, 392, 132)),      # 2.97 waves of 64 beat 1.48 of 128
    ((1000, 8), 132, (64, 8, 1, 8, 8)),             # fewer tiles than SMs
    ((4096, 104), 132, (64, 32, 2, 64, 64)),        # one wave either way: the narrower
    ((4096, 104), 16, (128, 32, 1, 32, 16)),
])
def test_tf32_plan(mn, sms, want):
    p = gemm_plan.tf32_plan(*mn, sms)
    assert (p.block_n, p.m_tiles, p.n_tiles, p.tiles, p.grid) == want
    assert p.smem == {128: 222256, 64: 201808}[p.block_n]


@pytest.mark.parametrize("bad", [(0, 64, 132), (64, 0, 132), (64, 64, 0), (2 ** 31, 64, 132)])
def test_tf32_plan_refuses_what_the_kernel_refuses(bad):
    with pytest.raises(ValueError):
        gemm_plan.tf32_plan(*bad)


@pytest.mark.parametrize("mkn", RAGGED)
def test_f32_padding_keeps_the_plain_result(mkn):
    m, k, n = mkn
    x, w = (torch.from_numpy(v) for v in _operands(m, k, n, seed=7))
    y, s1, s2 = port_conv.aligned_call(port_conv.gemm_stats_plain, x, w,
                                       align=port_conv.F32_TMA_ALIGN)
    ry, rs1, rs2 = port_conv.gemm_stats_plain(x, w)
    assert y.shape == ry.shape and y.is_contiguous()
    torch.testing.assert_close(y, ry, rtol=Y_RTOL, atol=Y_ATOL * float(ry.abs().max()))
    for got, ref in ((s1, rs1), (s2, rs2)):
        assert got.shape == (n,)
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * float(ref.abs().max()))


@pytest.fixture
def routes(monkeypatch):
    """The CUDA wrapper's float32 kernels replaced by recorders that run the
    plain version on the shapes they are given."""
    calls = []

    def tf32_kernel(name, x, w):
        calls.append(("tf32", name, tuple(x.shape), tuple(w.shape)))
        return port_conv.gemm_stats_plain(x, w)

    def ffma_kernel(name, x, w, a, b):
        calls.append(("ffma", name, tuple(x.shape), tuple(w.shape)))
        return port_conv.gemm_stats_plain(torch.relu(x * a + b), w)

    monkeypatch.setattr(port_conv, "_tf32_stats", tf32_kernel)
    monkeypatch.setattr(port_conv, "_f32_affine_stats", ffma_kernel)
    return calls


def test_f32_routes_to_the_3xtf32_kernel_with_k_and_n_padded_to_4(routes):
    _build.LAUNCHES.clear()
    x, w = torch.ones((6, 2, 5)), torch.ones((5, 7))
    y, s1, s2 = port_conv.gemm_stats_cuda(port_conv.KERNEL, x, w)
    assert routes == [("tf32", port_conv.KERNEL, (6, 2, 8), (8, 8))]
    assert y.shape == (6, 2, 7) and bool((y == 5).all()) and s1.shape == (7,)
    assert _build.LAUNCHES == {port_conv.KERNEL_F32: 1}
    a = torch.ones(5)
    port_conv.gemm_stats_cuda(port_conv.GEMM_KERNEL, x.reshape(12, 5), w, a, a)
    assert routes[1] == ("ffma", port_conv.GEMM_KERNEL, (12, 5), (5, 7))


def test_a_refused_tf32_launch_raises_without_a_fallback(monkeypatch, routes):
    """No plain version or FFMA kernel stands behind the 3xTF32 kernel: its
    error reaches the caller and no launch is counted."""
    def refused(name, x, w):
        raise RuntimeError(f"{name}: CUDA error 1: invalid argument")

    monkeypatch.setattr(port_conv, "_tf32_stats", refused)
    _build.LAUNCHES.clear()
    with pytest.raises(RuntimeError, match="invalid argument"):
        port_conv.gemm_stats_cuda(port_conv.GEMM_KERNEL, torch.ones((4, 8)), torch.ones((8, 8)))
    assert routes == [] and sum(_build.LAUNCHES.values()) == 0


class _RecordingTF32Lib:
    """A stand-in for the 3xTF32 library: records the launch's x (its
    pointer and, read through it, its values) and part_rows, and returns
    success without computing anything."""

    def __init__(self, m, k):
        self.m, self.k, self.calls = m, k, []

    def bdv_gemm_stats_tf32(self, x_ptr, w_ptr, wsplit, y, part, part_rows, stats, m, k, n,
                            stream):
        buf = (ctypes.c_float * (m * k)).from_address(x_ptr)
        self.calls.append(dict(x_ptr=x_ptr, part_rows=part_rows, mkn=(m, k, n),
                               x=np.frombuffer(buf, dtype=np.float32).copy()))
        return 0


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_tf32_launch_gets_an_aligned_x_and_the_sm_count(monkeypatch, offset):
    """The kernel's TMA needs x 16-byte aligned: a contiguous x at a storage
    offset of 1-3 floats reaches it as an aligned copy of the same values, an
    aligned x as itself; part_rows is the SM count (the grid's cap)."""
    m, k, n = 12, 8, 4
    lib = _RecordingTF32Lib(m, k)
    monkeypatch.setattr(port_conv, "_tf32_lib", lambda: lib)
    monkeypatch.setattr(port_conv, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(port_conv.torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0})())
    buf = torch.zeros(m * k + 8)
    start = (-buf.data_ptr() % 16) // 4 + offset  # 16-byte aligned, then `offset` floats on
    x = buf[start:start + m * k].view(m, k)
    x.copy_(torch.arange(m * k, dtype=torch.float32).view(m, k))
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    port_conv._tf32_stats(port_conv.GEMM_KERNEL, x, torch.ones((k, n)))
    (call,) = lib.calls
    assert call["x_ptr"] % 16 == 0 and (call["x_ptr"] == x.data_ptr()) == (offset == 0)
    assert call["part_rows"] == H100_SMS and call["mkn"] == (m, k, n)
    np.testing.assert_array_equal(call["x"], x.numpy().ravel())
