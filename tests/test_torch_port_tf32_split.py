"""The 3xTF32 float32 GEMMs with statistics, on the CPU.

On the card the port runs every float32 stats op (``conv1x1_with_stats``,
``gemm_with_stats``, the block's conv1, its conv3 with the affine-relu
prologue and its 3x3) as three TF32 products on the tensor cores
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
    version, and the route: float32 with or without a prologue, and the 3x3,
    to the 3xTF32 kernel, and no fallback when the kernel raises;
  * the emulated #7 and #8 (``ops/tf32``: the prologue rounded as the
    kernel's, then the split; the 3x3 slice by slice, tap by tap) against the
    JAX package's float32 block ops (``interpret=True``) at small geometries,
    both variant names, channel counts off 32 and off 4: phase 19's gates;
  * the 3x3's window as the kernel reads it (a model of its index
    arithmetic: boxes, bands, shifted rows, the halo and rows past M) equal
    to the im2col of the zero-padded prologue output, bit for bit, with
    relu(b) > 0 so a halo or a row past M read through the prologue shows;
  * the 3x3's plan (``gemm_plan.tf32_conv3x3_plan``): tiles that cover the
    product once, a window that holds every row its taps read, shared memory
    within a CTA's at the R50 widths, wide images and ragged channels.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bdvcil_tpu.ops import conv1x1_bn as jax_conv
from bdvcil_tpu.ops import block_fused as jax_bf
from bdvcil_torch.ops import _build, gemm_plan
from bdvcil_torch.ops import block_fused as port_bf
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

    def tf32_kernel(name, x, w, a=None, b=None):
        calls.append(("tf32", name, tuple(x.shape), tuple(w.shape), a is not None))
        return port_conv.gemm_stats_plain(x if a is None else torch.relu(x * a + b), w)

    def tf32_conv3x3(x, w, a, b):
        calls.append(("tf32", port_bf.CONV2, tuple(x.shape), tuple(w.shape), True))
        return port_bf.conv3x3_affine_relu_stats_plain(x, a, b, w)

    monkeypatch.setattr(port_conv, "_tf32_stats", tf32_kernel)
    monkeypatch.setattr(port_bf, "_conv3x3_f32", tf32_conv3x3)
    return calls


def test_f32_routes_to_the_3xtf32_kernel_with_k_and_n_padded_to_4(routes):
    _build.LAUNCHES.clear()
    x, w = torch.ones((6, 2, 5)), torch.ones((5, 7))
    y, s1, s2 = port_conv.gemm_stats_cuda(port_conv.KERNEL, x, w)
    assert routes == [("tf32", port_conv.KERNEL, (6, 2, 8), (8, 8), False)]
    assert y.shape == (6, 2, 7) and bool((y == 5).all()) and s1.shape == (7,)
    assert _build.LAUNCHES == {port_conv.KERNEL_F32: 1}
    a = torch.ones(5)
    y, _, _ = port_conv.gemm_stats_cuda(port_conv.GEMM_KERNEL, x.reshape(12, 5), w, a, a)
    assert routes[1] == ("tf32", port_conv.GEMM_KERNEL, (12, 8), (8, 8), True)
    assert y.shape == (12, 7) and bool((y == 10).all())


def test_a_refused_tf32_launch_raises_without_a_fallback(monkeypatch, routes):
    """No plain version or other kernel stands behind the 3xTF32 kernel: its
    error reaches the caller and no launch is counted."""
    def refused(name, x, w, a=None, b=None):
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


# --- #7 and #8 in float32: the prologue, then the split ---------------------------

def _affine(rng, k):
    """a in [0.5, 1.5), b in [0.1, 0.6) on every channel: relu(b) > 0, so a halo
    or a row past M read through the prologue would show."""
    return ((rng.random(k) + 0.5).astype(np.float32),
            (rng.random(k) * 0.5 + 0.1).astype(np.float32))


def _jax_np(out):
    return tuple(np.asarray(v, np.float32) for v in out)


# (M, K, N): the layer1-4 conv3 (K, N) at M cut to 512; K off 32 (36, 100), off
# 4 (3, 6: padded by the wrapper), N off 4
AFFINE_CASES = [(512, 64, 256), (512, 128, 512), (512, 256, 1024), (512, 512, 2048),
                (1000, 3, 5), (500, 100, 101), (300, 36, 20), (128, 6, 10)]


@pytest.mark.parametrize("mkn", AFFINE_CASES)
def test_3xtf32_affine_matches_jax_f32(mkn):
    """#7: the emulated kernel (relu(x * a + b) rounded as the kernel rounds
    it, then split, 32-wide k-steps) within phase 19's gates of the JAX
    package's float32 conv1x1_affine_relu_stats."""
    m, k, n = mkn
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, 1, 1, k)).astype(np.float32)
    a, b = _affine(rng, k)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    got = tf32.affine_relu_stats_3xtf32_emulated(*(torch.from_numpy(v) for v in (x, a, b, w)))
    ref = _jax_np(jax_bf.conv1x1_affine_relu_stats(jnp.asarray(x), jnp.asarray(a),
                                                   jnp.asarray(b), jnp.asarray(w),
                                                   interpret=True))
    assert got[0].shape == (m, 1, 1, n) and got[0].dtype == torch.float32
    _assert_gate(got[0].numpy().reshape(m, n), got[1].numpy(), got[2].numpy(),
                 (ref[0].reshape(m, n), ref[1], ref[2]))


# (NT, H, W, C, N): R50-like 64 -> 64 and 128 -> 128, C off 32 (12, 40), off 4
# (3: padded by the wrapper), W past one image row of a tile (40)
CONV3X3_CASES = [(2, 8, 8, 64, 64), (1, 6, 6, 128, 128), (1, 6, 9, 12, 20), (2, 5, 5, 3, 5),
                 (1, 4, 40, 40, 24)]


@pytest.mark.parametrize("variant", ["taps", "im2col"])
@pytest.mark.parametrize("case", CONV3X3_CASES, ids=[f"{c[2]}w-{c[3]}x{c[4]}"
                                                     for c in CONV3X3_CASES])
def test_3xtf32_conv3x3_matches_jax_f32(case, variant):
    """#8: the emulated kernel (the zero-padded prologue output split, each
    32-channel slice's 9 taps in order) within phase 19's gates of the JAX
    package's float32 conv3x3_affine_relu_stats, both variant names."""
    nt, h, w_, c, n = case
    rng = np.random.default_rng(nt * 1000 + w_ * 10 + c)
    x = rng.standard_normal((nt, h, w_, c)).astype(np.float32)
    a, b = _affine(rng, c)
    w = (rng.standard_normal((3, 3, c, n)) / np.sqrt(9 * c)).astype(np.float32)
    got = tf32.conv3x3_affine_relu_stats_3xtf32_emulated(
        *(torch.from_numpy(v) for v in (x, a, b, w)))
    ref = _jax_np(jax_bf.conv3x3_affine_relu_stats(jnp.asarray(x), jnp.asarray(a),
                                                   jnp.asarray(b), jnp.asarray(w),
                                                   interpret=True, variant=variant))
    m = nt * h * w_
    assert got[0].shape == (nt, h, w_, n) and got[0].dtype == torch.float32
    _assert_gate(got[0].numpy().reshape(m, n), got[1].numpy(), got[2].numpy(),
                 (ref[0].reshape(m, n), ref[1], ref[2]))


@pytest.mark.parametrize("op", ["affine", "conv3x3"])
def test_prologue_values_past_tf32_max_give_nan(op):
    """The pinned divergence with the prologue: relu(x * a + b) past TF32's
    largest finite rounds to inf (big = inf, small = NaN), so y is NaN
    wherever the value is read, where the f32 product is finite; other
    outputs stay finite."""
    x = torch.ones((1, 5, 5, 4))
    x[0, 2, 2, 0] = float(np.finfo(np.float32).max)
    a, b = torch.ones(4), torch.zeros(4)
    if op == "affine":
        w = torch.ones((4, 4))
        w[0] = 2.0 ** -100
        y = tf32.affine_relu_stats_3xtf32_emulated(x, a, b, w)[0]
        ref = port_bf.conv1x1_affine_relu_stats_plain(x, a, b, w)[0]
        bad = torch.zeros((1, 5, 5), dtype=torch.bool)
        bad[0, 2, 2] = True
    else:
        w = torch.zeros((3, 3, 4, 4))
        w[1, 1] = 1.0
        w[1, 1, 0] = 2.0 ** -100
        y = tf32.conv3x3_affine_relu_stats_3xtf32_emulated(x, a, b, w)[0]
        ref = port_bf.conv3x3_affine_relu_stats_plain(x, a, b, w)[0]
        bad = torch.zeros((1, 5, 5), dtype=torch.bool)
        bad[0, 1:4, 1:4] = True  # every pixel whose taps read it: inf x 0 is NaN
    assert bool(torch.isfinite(ref).all())
    assert bool(torch.isnan(y[bad]).all()) and bool(torch.isfinite(y[~bad]).all())


# --- the 3x3's window, as the kernel reads it -----------------------------------------

def _window_tile(xa, m0, tap, h, w_, win):
    """The 128 rows of A the kernel's consumers read for the tile at pixel m0
    and one tap, from its window (``gemm_plan.Window``): box i holds rows
    m0 - W - 1 + i * box_step .. + box_rows - 1 of the prologue's output xa
    (M, C), zero outside it (the TMA's zero fill, which the prologue leaves);
    row r reads window row (dy + 1) * band + 1 + r + dx where the tap lies
    inside the image and m0 + r < M, else 0. Also returns the largest window
    row read."""
    m, c = xa.shape
    window = torch.zeros((win.boxes * win.box_rows, c))
    for i in range(win.boxes):
        for j in range(win.box_rows):
            row = m0 - w_ - 1 + i * win.box_step + j
            if 0 <= row < m:
                window[i * win.box_rows + j] = xa[row]
    dy, dx = tap // 3 - 1, tap % 3 - 1
    tile, top = torch.zeros((gemm_plan.BLOCK_M, c)), 0
    for r in range(gemm_plan.BLOCK_M):
        px = m0 + r
        hh, ww = (px // w_) % h + dy, px % w_ + dx
        if px < m and 0 <= hh < h and 0 <= ww < w_:
            j = (dy + 1) * win.band + 1 + r + dx
            tile[r], top = window[j], max(top, j)
    return tile, top


@pytest.mark.parametrize("w_", [5, 9, 63, 64, 112, 135, 136, 139, 150, 300, 320, 480])
def test_conv3x3_window_reads_the_im2col_rows(w_):
    """Every tile and tap of the window model both 3x3 kernels read (the
    bf16 one 64 channels a row, the 3xTF32 one 32) equals the rows of the
    im2col of pad(relu(x * a + b), 1), bit for bit: one box (W <= 63), several
    (64 .. 135), three bands (136 and up: 320 and 480 are layer1 of a 720p and
    a 1080p clip); the halo and the rows past M (M not
    a multiple of 128) read exactly 0 where relu(b) > 0, and no read passes
    the window's rows."""
    nt, h, c = 3, 3, 4
    rng = np.random.default_rng(w_)
    x = torch.from_numpy(rng.standard_normal((nt, h, w_, c)).astype(np.float32))
    a, b = (torch.from_numpy(v) for v in _affine(rng, c))
    xa = tf32.affine_relu(x, a, b)
    m = nt * h * w_
    assert m % gemm_plan.BLOCK_M and float(torch.relu(b).min()) > 0
    xp = torch.nn.functional.pad(xa, (0, 0, 1, 1, 1, 1))
    win = gemm_plan.window_plan(w_)
    rows = torch.zeros((-(-m // gemm_plan.BLOCK_M) * gemm_plan.BLOCK_M, c))
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        rows[:m] = xp[:, dy:dy + h, dx:dx + w_].reshape(m, c)
        for m0 in range(0, m, gemm_plan.BLOCK_M):
            tile, top = _window_tile(xa.reshape(m, c), m0, tap, h, w_, win)
            assert torch.equal(tile, rows[m0:m0 + gemm_plan.BLOCK_M]), (tap, m0)
            assert top < win.boxes * win.box_rows


# --- the 3x3's plan -------------------------------------------------------------------

# (M, N, W): the four R50 3x3s, wide images (two boxes, bands, the widest W),
# ragged N (padded to 4 by the wrapper)
CONV3X3_PLAN_CASES = [(nt * h * w, n, w) for nt, h, w, _, n in gemm_plan.R50_3X3_SHAPES] + [
    (128 * 64 * 64, 64, 64), (8 * 112 * 112, 64, 112), (9 * 200, 72, 200),
    (2 * 2 * 65535, 8, 65535), (4 * 5 * 9, 20, 9), (3 * 7 * 7, 136, 7), (100, 4, 10)]


@pytest.mark.parametrize("mnw", CONV3X3_PLAN_CASES)
def test_tf32_conv3x3_plan_covers_the_product_and_fits(mnw):
    """Every pixel and column lies in exactly one tile of a width the kernel
    has; the window holds the rows all 9 taps read (boxes of at most 256 rows,
    each on a period of the swizzle where there are several); the CTA's shared
    memory, as the kernel lays it out, within 232,448 bytes, at least 2 ring
    stages; a grid of at most one CTA an SM."""
    m, n, w_ = mnw
    p = gemm_plan.tf32_conv3x3_plan(m, n, w_, H100_SMS)
    assert p.block_n in (64, 128) and 2 <= p.stages <= gemm_plan.TF32_STAGES[p.block_n]
    assert (p.m_tiles - 1) * gemm_plan.BLOCK_M < m <= p.m_tiles * gemm_plan.BLOCK_M
    assert (p.n_tiles - 1) * p.block_n < n <= p.n_tiles * p.block_n
    assert p.tiles == p.m_tiles * p.n_tiles and p.grid == min(p.tiles, H100_SMS)
    assert p.smem == gemm_plan.tf32_smem(p.block_n, "im2col", p.stages, p.boxes, p.box_rows)
    assert p.smem <= gemm_plan.MAX_SMEM == 232448
    assert p.box_rows <= gemm_plan.MAX_BOX_ROWS and (p.boxes == 1 or p.box_rows % 8 == 0)
    if p.band == w_:  # one contiguous window: rows m0 - W - 1 .. m0 + 128 + W
        assert p.box_step == p.box_rows and p.boxes * p.box_rows >= gemm_plan.BLOCK_M + 2 * w_ + 2
    else:  # three bands, one a dy, each rows m0 + dy W - 1 .. m0 + dy W + 128
        assert (p.boxes, p.box_step, p.band) == (3, w_, p.box_rows)
        assert p.box_rows >= gemm_plan.BLOCK_M + 2


@pytest.mark.parametrize("mnw,want", [
    ((128 * 56 * 56, 64, 56), (64, 3136, 1, 3136, 132, 5, 1, 242, 242, 56, 183920)),
    ((128 * 28 * 28, 128, 28), (128, 784, 1, 784, 132, 3, 1, 186, 186, 28, 222800)),
    ((128 * 14 * 14, 256, 14), (128, 196, 2, 392, 132, 3, 1, 158, 158, 14, 214608)),
    ((128 * 7 * 7, 512, 7), (128, 49, 4, 196, 132, 3, 1, 144, 144, 7, 210512)),
    ((9 * 200, 72, 200), (64, 15, 2, 30, 30, 5, 3, 136, 200, 136, 224880)),
])
def test_tf32_conv3x3_plan(mnw, want):
    """The plans at the four R50 widths (the widest tile that divides N: at
    layer4 128, not the 1x1 cost model's 64) and a banded one, worked by
    hand at layer1: 5 x 16384 (w's ring) + 32768 (y) + 2 x 31744 (windows of 242
    rows) + 512 (a, b) + 4096 (sums) + 112 (barriers) + 1024 (slack)."""
    assert tuple(gemm_plan.tf32_conv3x3_plan(*mnw, H100_SMS)) == want
    assert want[-1] == 183920 or mnw[2] != 56
    assert 5 * 16384 + 32768 + 2 * 31744 + 512 + 4096 + 112 + 1024 == 183920


def test_tf32_smem_of_the_three_loads():
    """The 1x1 without a prologue keeps its layout; with one each stage adds
    a and b's 32 channels (256 bytes)."""
    assert (gemm_plan.tf32_smem(128), gemm_plan.tf32_smem(64)) == (222256, 201808)
    assert gemm_plan.tf32_smem(128, "affine") == 222256 + 3 * 256
    assert gemm_plan.tf32_smem(64, "affine") == 201808 + 5 * 256
    with pytest.raises(KeyError):
        gemm_plan.tf32_smem(64, "ffma")


# --- the 3x3's route and launch ---------------------------------------------------------

def test_f32_conv3x3_routes_to_the_3xtf32_kernel_with_c_and_n_padded_to_4(routes):
    """The float32 3x3 reaches the 3xTF32 kernel with Cin and Cout padded to
    4 (a = b = 0 on the padded channels), both variant names, one launch
    counted each; y and the statistics cut back to Cout."""
    _build.LAUNCHES.clear()
    x, w = torch.ones((2, 3, 5, 6)), torch.full((3, 3, 6, 7), 0.5)
    v = torch.ones(6)
    for variant in port_bf.VARIANTS:
        y, s1, s2 = port_bf._conv3x3_cuda(x, v, v, w, variant)
        assert y.shape == (2, 3, 5, 7) and s1.shape == s2.shape == (7,)
        torch.testing.assert_close(y, port_bf.conv3x3_affine_relu_stats_plain(x, v, v, w)[0])
    assert routes == [("tf32", port_bf.CONV2, (2, 3, 5, 8), (3, 3, 8, 8), True)] * 2
    assert _build.LAUNCHES == {port_bf.CONV2_F32: 2}


def test_a_refused_tf32_conv3x3_launch_raises_without_a_fallback(monkeypatch):
    """No plain version or other kernel stands behind the float32 3x3: its
    error reaches the caller and no launch is counted."""
    def refused(x, w, a, b):
        raise RuntimeError(f"{port_bf.CONV2_F32}: CUDA error 1: invalid argument")

    monkeypatch.setattr(port_bf, "_conv3x3_f32", refused)
    _build.LAUNCHES.clear()
    v = torch.ones(8)
    with pytest.raises(RuntimeError, match="invalid argument"):
        port_bf._conv3x3_cuda(torch.ones((1, 4, 4, 8)), v, v, torch.ones((3, 3, 8, 8)), "taps")
    assert sum(_build.LAUNCHES.values()) == 0


class _RecordingConv3x3Lib:
    """A stand-in for the 3xTF32 library's 3x3 entry: records its arguments
    (x read through its pointer) and returns success."""

    def __init__(self):
        self.calls = []

    def bdv_conv3x3_affine_relu_stats_tf32(self, x_ptr, w_ptr, ab, wsplit, y, part, part_rows,
                                           stats, nt, h, w, c, n, stream):
        buf = (ctypes.c_float * (nt * h * w * c)).from_address(x_ptr)
        abv = (ctypes.c_float * (2 * c)).from_address(ab)
        self.calls.append(dict(x_ptr=x_ptr, part_rows=part_rows, shape=(nt, h, w, c, n),
                               x=np.frombuffer(buf, dtype=np.float32).copy(),
                               ab=np.frombuffer(abv, dtype=np.float32).copy(),
                               wsplit=wsplit))
        return 0


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_tf32_conv3x3_launch_gets_an_aligned_x_the_scratch_and_ab(monkeypatch, offset):
    """The 3x3's launch: x 16-byte aligned (a copy of the same values where
    it was not), a and b as one (2, C) operand, the SM count as the
    partials' rows, and a (2, N, 9, C rounded up to 32) scratch for w."""
    nt, h, w_, c, n = 1, 3, 4, 8, 4
    lib = _RecordingConv3x3Lib()
    scratch = []
    empty = torch.empty

    def recording_empty(shape, **kw):
        t = empty(shape, **kw)
        scratch.append((tuple(t.shape), t.data_ptr()))
        return t

    monkeypatch.setattr(port_bf, "_tf32_lib", lambda: lib)
    monkeypatch.setattr(port_bf, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(port_bf.torch, "empty", recording_empty)
    monkeypatch.setattr(port_bf.torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0})())
    size = nt * h * w_ * c
    buf = torch.zeros(size + 8)
    start = (-buf.data_ptr() % 16) // 4 + offset
    x = buf[start:start + size].view(nt, h, w_, c)
    x.copy_(torch.arange(size, dtype=torch.float32).view(nt, h, w_, c))
    a, b = torch.arange(c, dtype=torch.float32), -torch.arange(c, dtype=torch.float32)
    port_bf._conv3x3_f32(x, torch.ones((3, 3, c, n)), a, b)
    (call,) = lib.calls
    assert call["x_ptr"] % 16 == 0 and (call["x_ptr"] == x.data_ptr()) == (offset == 0)
    assert call["part_rows"] == H100_SMS and call["shape"] == (nt, h, w_, c, n)
    np.testing.assert_array_equal(call["x"], x.numpy().ravel())
    np.testing.assert_array_equal(call["ab"], np.concatenate([a.numpy(), b.numpy()]))
    assert ((2, n, 9 * 32), call["wsplit"]) in scratch


def test_tf32_affine_launch_gets_a_and_b_as_one_operand(monkeypatch):
    """#7's launch passes [a; b] as one (2, K) operand and K, N as given."""
    seen = []

    class Lib:
        def bdv_gemm_affine_relu_stats_tf32(self, x, w, ab, wsplit, y, part, part_rows, stats,
                                            m, k, n, stream):
            seen.append(((m, k, n), np.frombuffer((ctypes.c_float * (2 * k)).from_address(ab),
                                                  dtype=np.float32).copy()))
            return 0

    monkeypatch.setattr(port_conv, "_tf32_lib", lambda: Lib())
    monkeypatch.setattr(port_conv, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(port_conv.torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0})())
    a, b = torch.arange(8, dtype=torch.float32), torch.full((8,), 0.5)
    port_conv._tf32_stats(port_bf.CONV3, torch.ones((6, 8)), torch.ones((8, 4)), a, b)
    ((mkn, ab),) = seen
    assert mkn == (6, 8, 4)
    np.testing.assert_array_equal(ab, np.concatenate([a.numpy(), b.numpy()]))
