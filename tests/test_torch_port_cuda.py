"""The port's hand-written kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch; there run it without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerances: the fused epilogue kernels are bit-exact (f32 add rounded once,
as a bf16 add is), and so are the plain shift (an index copy) and the
block's tail, bn_finalize and affine_residual_relu (every f32 operation
rounded once, in eager PyTorch's order); the GEMM and
convolution kernels with the statistics epilogue (conv1x1_with_stats,
gemm_with_stats, the block's three stats ops): y within one bf16 ulp
(accumulation order; near zero the ulp is taken at 1/256 of the tensor's
rms), the statistics rtol 1e-3 (f32 sums in another order), and the same
statistics bit for bit on a second run; the float32 GEMM with statistics
(csrc/gemm_stats_tf32.cu, three TF32 products on the tensor cores: #3, #4
and the block's #6): y rtol 1e-5, atol 1e-6 of max |y| (another order of
summation than the library product's f32 FMAs), the statistics rtol 1e-4,
atol 1e-4 of the largest (another summation order), and the same bits on a
second run; so are the block's float32 kernels with a prologue (#7 and #8, on
the same 3xTF32 kernel), whose tail (#9b) is bit for bit; against x @ w in
float64 each 3xTF32 form's error stays within WITNESS_FACTOR of its plain
emulation's (ops/tf32);
the float32 block against its plain composition within 1e-4 of the terms'
size (f32 sums of another order through three BatchNorms); train-mode
BatchNorm (csrc/batchnorm.cu): given the same sums, the finalize, the
normalize, the running statistics and dx bit for bit against the plain
versions, the forward's sums within 1e-5 of sum |x| of float64's, the
backward's two sums within 1e-5 of the terms' absolute sum of the plain
f32 reductions, and the same bits on a second run.
"""

import numpy as np
import pytest
import torch

from bdvcil_torch.ops import _build
from bdvcil_torch.ops import batchnorm as port_bn
from bdvcil_torch.ops import block_fused as port_bf
from bdvcil_torch.ops import conv1x1_bn as port_conv
from bdvcil_torch.ops import gemm_plan, tf32
from bdvcil_torch.ops import tsm_shift as port_tsm

pytestmark = pytest.mark.cuda

T = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def assert_close_to_terms(out, ref, terms, tol=2e-2):
    """|out - ref| <= tol + tol * (|ref| + sum |term|): the block's output is
    relu(y3 * a3 + b3 + x) rounded to bf16, so one ulp of a large term shows
    in a small output; the tolerance is taken against the terms' size."""
    scale = ref.float().abs() + sum(t.float().abs() for t in terms)
    err = (out.float() - ref.float()).abs()
    bad = err > tol + tol * scale
    assert not bool(bad.any()), (f"{int(bad.sum())} of {bad.numel()} elements off; "
                                 f"max error {float(err.max())}")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x|, with |x| floored at 1/256 of the tensor's rms:
    near zero the f32 accumulation order, not the rounding, sets the error."""
    floor = max(float(x.float().pow(2).mean().sqrt()) / 256, float(np.finfo(np.float32).tiny))
    mag = torch.clamp(x.abs(), min=floor)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2 * T, 4, 4, 32), (8 * T, 7, 7, 256), (4, 3, 5, 12)])
def test_fused_kernels_bit_exact(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    h, i, g_out, g_sh = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                         for _ in range(4))
    _build.LAUNCHES.clear()
    out, sh = port_tsm.fused_fwd(h, i, T, 8)
    g_in = port_tsm.fused_bwd(out, g_out, g_sh, T, 8)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[port_tsm.FWD] == 1 and _build.LAUNCHES[port_tsm.BWD] == 1
    r_out, r_sh = port_tsm.fused_residual_relu_shift_plain(h, i, T, 8)
    r_g = port_tsm.fused_residual_relu_shift_bwd_plain(r_out, g_out, g_sh, T, 8)
    assert torch.equal(out, r_out)
    assert torch.equal(sh, r_sh)
    assert torch.equal(g_in, r_g)


@pytest.mark.parametrize("mkn", [(300, 64, 64), (6272, 512, 2048), (1000, 256, 128),
                                 (128, 64, 64)])
def test_conv1x1_kernel_matches_plain(cuda, mkn):
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((m, 1, 1, k), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=g, device=cuda) * 0.05).to(torch.bfloat16)
    _build.LAUNCHES.clear()
    y, s1, s2 = port_conv.conv1x1_with_stats_fwd(x, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[port_conv.KERNEL] == 1
    ry, _, _ = port_conv.gemm_stats_plain(x, w)
    assert bool(((y.float() - ry.float()).abs() <= _bf16_ulp(ry.float())).all())
    # the statistics are sums over the kernel's own rounded y: the plain
    # version's y differs by an ulp here and there, and over M rows those
    # flips add up to more than the summation order does
    yd = y.double().reshape(m, n)
    torch.testing.assert_close(s1.double(), yd.sum(0), rtol=1e-3, atol=1e-2)
    torch.testing.assert_close(s2.double(), (yd * yd).sum(0), rtol=1e-3, atol=1e-2)


def test_conv1x1_kernel_statistics_are_deterministic(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((4096, 1, 1, 256), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((256, 128), generator=g, device=cuda) * 0.05).to(torch.bfloat16)
    first = port_conv.conv1x1_with_stats_fwd(x, w)
    second = port_conv.conv1x1_with_stats_fwd(x, w)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """float32 and K, N off the wgmma core's multiples of 64 are taken; float16,
    two dtypes, non-contiguous operands and operands on two devices are not,
    and a refused call counts no launch."""
    bf16 = torch.bfloat16
    _build.LAUNCHES.clear()
    x = torch.ones((2, 2, 2, 48), device=cuda, dtype=bf16)
    y, _, _ = port_conv.conv1x1_with_stats_fwd(x, torch.ones((48, 96), device=cuda, dtype=bf16))
    assert y.shape == (2, 2, 2, 96) and bool((y.float() == 48).all())
    y, _, _ = port_conv.conv1x1_with_stats_fwd(x.float()[..., :3].contiguous(),
                                               torch.ones((3, 5), device=cuda))
    assert y.dtype == torch.float32 and bool((y == 3).all())
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_conv.KERNEL: 1, port_conv.KERNEL_F32: 1}
    _build.LAUNCHES.clear()
    with pytest.raises(TypeError):  # float16: no configuration computes in it
        port_conv.conv1x1_with_stats_fwd(x.half(), torch.zeros((48, 64), device=cuda,
                                                               dtype=torch.float16))
    with pytest.raises(TypeError):  # two dtypes
        port_conv.conv1x1_with_stats_fwd(x.float(), torch.zeros((48, 64), device=cuda,
                                                                dtype=bf16))
    with pytest.raises(ValueError):  # not contiguous
        port_conv.gemm_with_stats_fwd(torch.zeros((64, 64), device=cuda).t()[:, :32],
                                      torch.zeros((32, 64), device=cuda))
    with pytest.raises(ValueError):  # two devices
        port_conv.gemm_with_stats_fwd(torch.zeros((64, 32), device=cuda),
                                      torch.zeros((32, 64)))
    with pytest.raises(ValueError):  # not contiguous
        port_tsm.fused_fwd(x[..., ::2], x[..., ::2], 2, 8)
    assert sum(_build.LAUNCHES.values()) == 0


def test_interpret_mode_launches_no_conv1x1_kernel(cuda):
    """conv1x1_mode='pallas_stats_interpret' runs the GEMM's plain version on
    the card; 'pallas_stats' launches the kernel for conv1 and conv3. The two
    train-mode block outputs agree within 3e-2 of the largest entry (bf16)."""
    from bdvcil_torch.models.resnet_tsm import Bottleneck, nchw

    g = torch.Generator().manual_seed(4)
    x = torch.randn((4 * T, 8, 8, 256), generator=g).to(cuda, torch.bfloat16)
    launches, outs = {}, {}
    for mode in ("pallas_stats", "pallas_stats_interpret"):
        block = Bottleneck(256, 64, 1, T, 8, True, torch.bfloat16, torch.bfloat16,
                           conv1x1_mode=mode)
        pg = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for name, p in block.named_parameters():
                if p.dim() == 4:
                    p.copy_(torch.randn(p.shape, generator=pg) / p[0].numel() ** 0.5)
        block.to(cuda)
        _build.LAUNCHES.clear()
        outs[mode] = block(nchw(x), True).float()
        torch.cuda.synchronize()
        launches[mode] = _build.LAUNCHES[port_conv.KERNEL]
    assert launches == {"pallas_stats": 2, "pallas_stats_interpret": 0}
    ref = outs["pallas_stats_interpret"]
    err = float((outs["pallas_stats"] - ref).abs().max())
    assert err <= 3e-2 * float(ref.abs().max())


# --- the float32 GEMM with statistics (csrc/gemm_stats_tf32.cu): #3, #4, #6 in f32 ---

# (M, K, N) off every tile multiple: the JAX test's two and K, N not multiples of 8
RAGGED_1X1 = [(100, 32, 128), (896, 96, 128), (1000, 3, 5), (4096, 100, 101), (4096, 96, 101)]


def _check_f32(got, ref):
    (y, s1, s2), (ry, rs1, rs2) = got, ref
    assert y.shape == ry.shape and y.dtype == ry.dtype == torch.float32
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-6 * float(ry.abs().max()))
    for a, b in ((s1, rs1), (s2, rs2)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("mkn", [(128 * 56 * 56 // 8, 256, 64), (6272, 512, 2048)]
                         + RAGGED_1X1)
def test_f32_kernel_matches_plain(cuda, mkn):
    """conv1x1_with_stats and gemm_with_stats in float32 (TF32 off, as the
    plain version's product defaults to) at a layer1 and a layer4 shape of
    ResNet-50 and at ragged ones; a second run gives the same bits."""
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((m, k), generator=g, device=cuda)
    w = torch.randn((k, n), generator=g, device=cuda) * k ** -0.5
    assert not torch.backends.cuda.matmul.allow_tf32
    ref = port_conv.gemm_stats_plain(x, w)
    _build.LAUNCHES.clear()
    conv = port_conv.conv1x1_with_stats_fwd(x.reshape(m, 1, 1, k), w)
    got = port_conv.gemm_with_stats_fwd(x, w)
    again = port_conv.gemm_with_stats_fwd(x, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_conv.KERNEL_F32: 1, port_conv.GEMM_KERNEL_F32: 2}
    _check_f32((conv[0].reshape(m, n), conv[1], conv[2]), ref)
    _check_f32(got, ref)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


R50_1X1 = sorted(gemm_plan.r50_1x1_shapes())


@pytest.mark.parametrize("mkn", R50_1X1 + RAGGED_1X1)
def test_tf32_kernel_matches_plain_at_r50_and_ragged_shapes(cuda, mkn):
    """#3, #4 and #6 in float32, all on the 3xTF32 kernel, against the plain
    version with TF32 off at the 12 R50 1x1 shapes and the ragged ones (K, N
    zero-padded to multiples of 4); a second run gives the same bits."""
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn((m, k), generator=g, device=cuda)
    w = torch.randn((k, n), generator=g, device=cuda) * k ** -0.5
    assert not torch.backends.cuda.matmul.allow_tf32
    ref = port_conv.gemm_stats_plain(x, w)
    x4 = x.reshape(m, 1, 1, k)
    _build.LAUNCHES.clear()
    got = {port_conv.KERNEL_F32: port_conv.conv1x1_with_stats_fwd(x4, w),
           port_conv.GEMM_KERNEL_F32: port_conv.gemm_with_stats_fwd(x, w),
           port_bf.CONV1_F32: port_bf.conv1x1_stats(x4, w)}
    again = port_conv.gemm_with_stats_fwd(x, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_conv.KERNEL_F32: 1, port_conv.GEMM_KERNEL_F32: 2,
                               port_bf.CONV1_F32: 1}
    for y, s1, s2 in got.values():
        _check_f32((y.reshape(m, n), s1, s2), ref)
    assert all(torch.equal(u, v) for u, v in zip(got[port_conv.GEMM_KERNEL_F32], again))


def test_tf32_plan_is_the_kernels(cuda):
    """The Python plan that sizes the 3xTF32 kernel's partials equals the one
    its C side makes, at every R50 shape, the ragged ones (N padded to 4) and
    fewer rows and columns than a tile."""
    sms = port_conv.sm_count(cuda)
    mns = [(m, n) for m, _, n in R50_1X1] + [(m, -(-n // 4) * 4) for m, _, n in RAGGED_1X1]
    for m, n in mns + [(1, 4), (129, 192), (4096, 104)]:
        assert gemm_plan.tf32_kernel_plan(m, n, cuda) == gemm_plan.tf32_plan(m, n, sms)


def test_f32_forms_run_on_their_libraries(cuda, monkeypatch):
    """#3, #4, #6, #7 and #8 in float32 (#7 and #8 with the prologue) all
    load the 3xTF32 library, and only it."""
    used = []

    def recording(lib):
        def load():
            used.append("tf32")
            return lib()
        return load

    for mod in (port_conv, port_bf):
        monkeypatch.setattr(mod, "_tf32_lib", recording(mod._tf32_lib))
    g = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn((2, 6, 6, 64), generator=g, device=cuda)
    w = torch.randn((64, 64), generator=g, device=cuda) * 0.125
    w2 = torch.randn((3, 3, 64, 64), generator=g, device=cuda) * 0.04
    a, b = torch.ones(64, device=cuda), torch.full((64,), 0.1, device=cuda)
    for fn in (lambda: port_conv.conv1x1_with_stats_fwd(x, w),
               lambda: port_conv.gemm_with_stats_fwd(x.reshape(-1, 64), w),
               lambda: port_bf.conv1x1_stats(x, w),
               lambda: port_bf.conv1x1_affine_relu_stats(x, a, b, w),
               lambda: port_bf.conv3x3_affine_relu_stats(x, a, b, w2)):
        used.clear()
        fn()
        assert used == ["tf32"]
    assert not hasattr(port_conv, "_f32_lib") and not hasattr(port_bf, "_f32_lib")


# the kernel's largest error against x @ w in float64, over the emulation's
WITNESS_FACTOR = 1.6


@pytest.mark.parametrize("k", [64, 512, 2048])
def test_tf32_kernel_error_within_the_emulations(cuda, k):
    """A float64 witness: against x @ w in float64, the kernel's largest error
    is within WITNESS_FACTOR times that of the emulated 3xTF32
    (``ops/tf32.gemm_3xtf32``: the same split, each TF32 product exact in
    f32, the sums IEEE f32, TF32 off). The tensor cores truncate their sum of
    a k-step's 12 products, so the kernel's error is not the emulation's.

    Ratios read by ``python -m bdvcil_torch.tf32_witness`` over 16 seeds
    (18, this test's, and 0-14), NVIDIA H100 80GB HBM3, 700.00 W:

        K      kernel        one accumulator
        64     0.77-1.06     1.94-3.70
        512    1.07-1.34     17.3-24.8
        2048   0.98-1.28     38.6-48.2

    (seed 18: 0.88, 1.16, 1.03). "One accumulator" is the kernel with all of
    K summed in the tensor cores' accumulator, without the IEEE f32 add a
    32-wide k-step. The factor lies between the kernel's largest ratio and
    that variant's smallest."""
    m, n = 8192, 256
    g = torch.Generator(device=cuda).manual_seed(18)
    x = torch.randn((m, k), generator=g, device=cuda)
    w = torch.randn((k, n), generator=g, device=cuda) * k ** -0.5
    y64 = x.double() @ w.double()
    got = port_conv.gemm_with_stats_fwd(x, w)[0]
    emulated = tf32.gemm_3xtf32(x, w)
    err, bound = (float((v.double() - y64).abs().max()) for v in (got, emulated))
    assert err <= WITNESS_FACTOR * bound, f"kernel {err}, emulation {bound}"


def test_tf32_kernel_gives_nan_past_tf32_max_as_the_emulation(cuda):
    """The pinned divergence: x past TF32's largest finite rounds to inf, so
    the row's y is NaN on the card as in ``ops/tf32`` (the f32 product is
    finite there); the other rows stay finite."""
    x = torch.ones((4, 8), device=cuda)
    x[1, 0] = float(np.finfo(np.float32).max)
    w = torch.full((8, 8), 2.0 ** -100, device=cuda)
    w[1:] = 1.0
    y, _, _ = port_conv.gemm_with_stats_fwd(x, w)
    want = tf32.gemm_stats_3xtf32_emulated(x, w)[0]
    assert bool(torch.isfinite(x @ w).all())
    assert torch.equal(torch.isnan(y), torch.isnan(want))
    assert bool(torch.isnan(y[1]).all()) and bool(torch.isfinite(y[[0, 2, 3]]).all())


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_tf32_kernel_takes_a_misaligned_x(cuda, offset):
    """A contiguous float32 x at a storage offset of 1-3 floats, so not
    16-byte aligned as the TMA needs (K = 64: no padding copies it): the
    plain result, one launch counted."""
    m, k, n = 1000, 64, 96
    g = torch.Generator(device=cuda).manual_seed(19)
    buf = torch.randn((m * k + 4,), generator=g, device=cuda)
    x = buf[offset:offset + m * k].view(m, k)
    w = torch.randn((k, n), generator=g, device=cuda) * k ** -0.5
    assert x.is_contiguous() and x.data_ptr() % 16
    ref = port_conv.gemm_stats_plain(x, w)
    _build.LAUNCHES.clear()
    got = port_conv.gemm_with_stats_fwd(x, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_conv.GEMM_KERNEL_F32: 1}
    _check_f32(got, ref)


# --- #7 and #8 in float32 on the 3xTF32 kernel ------------------------------------

def _block_f32_operands(cuda, shape, seed):
    """#7's (x (M, K), a, b, w (K, N)) or #8's (x (NT, H, W, C), a, b, w (3, 3,
    C, N)), b > 0 on every channel (a halo or a row past M read through the
    prologue would show)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    *xs, k, n = shape
    x = torch.randn((*xs, k), generator=g, device=cuda)
    a = torch.rand((k,), generator=g, device=cuda) + 0.5
    b = torch.rand((k,), generator=g, device=cuda) * 0.5 + 0.1
    fan = (9 if len(xs) == 3 else 1) * k
    w = torch.randn(((3, 3) if len(xs) == 3 else ()) + (k, n), generator=g,
                    device=cuda) * fan ** -0.5
    return x, a, b, w


def _conv3x3_f64(xa, w):
    """conv3x3(pad(xa, 1), w) in float64 as nine tap products, (M, N)."""
    nt, h, w_, c = xa.shape
    xp = torch.nn.functional.pad(xa.double(), (0, 0, 1, 1, 1, 1))
    y = 0
    for dy in range(3):
        for dx in range(3):
            y = y + xp[:, dy:dy + h, dx:dx + w_].reshape(-1, c) @ w[dy, dx].double()
    return y


# (op, shape): #7 at the layer1 and layer4 conv3, #8 at the layer1 and layer4 3x3
BLOCK_WITNESS = [("conv3", (401408, 64, 256)), ("conv3", (6272, 512, 2048)),
                 ("conv2", (128, 56, 56, 64, 64)), ("conv2", (128, 7, 7, 512, 512))]


@pytest.mark.parametrize("op,shape", BLOCK_WITNESS)
def test_tf32_block_kernels_error_within_the_emulations(cuda, op, shape):
    """The float64 witness for #7 and #8 in float32: against the product of
    the prologue's output (relu(x * a + b) in f32, as both compute it) in
    float64, the kernel's largest error is within WITNESS_FACTOR times that
    of the emulated 3xTF32 (``ops/tf32``: the same split and k-steps, the 3x3
    slice by slice and tap by tap, each step's sums in IEEE f32, TF32 off),
    at the layer1 and layer4 shapes."""
    x, a, b, w = _block_f32_operands(cuda, shape, 20)
    xa = tf32.affine_relu(x, a, b)
    if op == "conv3":
        y64 = xa.double() @ w.double()
        got = port_bf.conv1x1_affine_relu_stats(x, a, b, w)[0]
        emulated = tf32.gemm_3xtf32(xa, w)
    else:
        y64 = _conv3x3_f64(xa, w)
        got = port_bf.conv3x3_affine_relu_stats(x, a, b, w)[0].reshape(y64.shape)
        emulated = tf32.conv3x3_3xtf32(x, a, b, w)
    err, bound = (float((v.double() - y64).abs().max()) for v in (got, emulated))
    assert err <= WITNESS_FACTOR * bound, f"kernel {err}, emulation {bound}"


@pytest.mark.parametrize("op", ["conv3", "conv2"])
def test_tf32_block_kernels_give_nan_past_tf32_max_as_the_emulation(cuda, op):
    """The pinned divergence with the prologue: relu(x * a + b) past TF32's
    largest finite rounds to inf, so y is NaN where the emulation has it
    (the f32 product is finite there) and finite elsewhere."""
    x = torch.ones((1, 5, 5, 8), device=cuda)
    x[0, 2, 2, 0] = float(np.finfo(np.float32).max)
    a, b = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    if op == "conv3":
        w = torch.ones((8, 8), device=cuda)
        w[0] = 2.0 ** -100
        got = port_bf.conv1x1_affine_relu_stats(x, a, b, w)[0]
        want = tf32.affine_relu_stats_3xtf32_emulated(x, a, b, w)[0]
        plain = port_bf.conv1x1_affine_relu_stats_plain(x, a, b, w)[0]
    else:
        w = torch.zeros((3, 3, 8, 8), device=cuda)
        w[1, 1] = 1.0
        w[1, 1, 0] = 2.0 ** -100
        got = port_bf.conv3x3_affine_relu_stats(x, a, b, w)[0]
        want = tf32.conv3x3_affine_relu_stats_3xtf32_emulated(x, a, b, w)[0]
        plain = port_bf.conv3x3_affine_relu_stats_plain(x, a, b, w)[0]
    assert bool(torch.isfinite(plain).all()) and bool(torch.isnan(want).any())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isfinite(got[~torch.isnan(want)]).all())


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("op", ["conv3", "conv2"])
def test_tf32_block_kernels_take_a_misaligned_x(cuda, op, offset):
    """A contiguous float32 x at a storage offset of 1-3 floats (channels a
    multiple of 4: no padding copies it): the plain result, one launch."""
    shape = (1000, 64, 96) if op == "conv3" else (2, 9, 11, 64, 40)
    x0, a, b, w = _block_f32_operands(cuda, shape, 21)
    buf = torch.empty((x0.numel() + 4,), device=cuda)
    x = buf[offset:offset + x0.numel()].view(x0.shape)
    x.copy_(x0)
    assert x.is_contiguous() and x.data_ptr() % 16
    _build.LAUNCHES.clear()
    if op == "conv3":
        got = port_bf.conv1x1_affine_relu_stats(x, a, b, w)
        ref = port_bf.conv1x1_affine_relu_stats_plain(x0, a, b, w)
        name = port_bf.CONV3_F32
    else:
        got = port_bf.conv3x3_affine_relu_stats(x, a, b, w)
        ref = port_bf.conv3x3_affine_relu_stats_plain(x0, a, b, w)
        name = port_bf.CONV2_F32
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {name: 1}
    _check_f32(got, ref)


# (NT, H, W, Cin, Cout): W past one box (64, 112), three bands (200, 1000, the
# widest W), Cin off 32 (12, 40) and off 4 (3, 13: padded), Cout off 4
WIDE_F32_3X3 = [(2, 64, 64, 64, 64), (1, 112, 112, 64, 64), (1, 9, 200, 32, 72),
                (1, 4, 1000, 40, 24), (1, 2, 65535, 4, 4), (4, 5, 9, 12, 20), (2, 3, 3, 3, 5),
                (2, 6, 7, 13, 9)]


@pytest.mark.parametrize("geometry", WIDE_F32_3X3)
def test_tf32_conv3x3_at_wide_images_and_ragged_channels(cuda, geometry):
    """#8 in float32 at wide images (a window in boxes, or in three bands)
    and ragged channel counts against its plain version (TF32 off), both
    variant names, the same bits on a second run, the C plan equal to
    ``gemm_plan.tf32_conv3x3_plan``."""
    nt, h, w_, cin, cout = geometry
    x, a, b, w = _block_f32_operands(cuda, geometry, 22)
    m, n4 = nt * h * w_, -(-cout // 4) * 4
    assert (gemm_plan.tf32_conv3x3_kernel_plan(m, n4, w_, cuda)
            == gemm_plan.tf32_conv3x3_plan(m, n4, w_, port_conv.sm_count(cuda)))
    _build.LAUNCHES.clear()
    got = {v: port_bf.conv3x3_affine_relu_stats(x, a, b, w, variant=v) for v in port_bf.VARIANTS}
    again = port_bf.conv3x3_affine_relu_stats(x, a, b, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_bf.CONV2_F32: 3}
    for v, out in got.items():
        _check_f32(out, port_bf.conv3x3_affine_relu_stats_plain(x, a, b, w, variant=v))
    assert all(torch.equal(u, v) for u, v in zip(got["taps"], again))


@pytest.mark.parametrize("mkn", RAGGED_1X1 + [(300, 36, 20), (128, 6, 10)])
def test_tf32_affine_at_ragged_k_and_n(cuda, mkn):
    """#7 in float32 where K or N is off 32 or off 4 (padded) and M off a
    tile: the plain result, the same bits on a second run."""
    x, a, b, w = _block_f32_operands(cuda, mkn, 23)
    got = port_bf.conv1x1_affine_relu_stats(x, a, b, w)
    again = port_bf.conv1x1_affine_relu_stats(x, a, b, w)
    _check_f32(got, port_bf.conv1x1_affine_relu_stats_plain(x, a, b, w))
    assert all(torch.equal(u, v) for u, v in zip(got, again))


def test_tf32_conv3x3_plan_is_the_kernels(cuda):
    """The Python copy of the 3x3's plan equals the one its C side makes, at
    the R50 widths, wide images and ragged Cout (padded to 4)."""
    sms = port_conv.sm_count(cuda)
    mnw = [(nt * h * w, n, w) for nt, h, w, _, n in gemm_plan.R50_3X3_SHAPES]
    mnw += [(nt * h * w, -(-n // 4) * 4, w) for nt, h, w, _, n in WIDE_F32_3X3]
    for m, n, w in mnw + [(1, 4, 1), (128 * 139 * 139, 64, 139), (128 * 140 * 140, 64, 140)]:
        assert gemm_plan.tf32_conv3x3_kernel_plan(m, n, w, cuda) == gemm_plan.tf32_conv3x3_plan(
            m, n, w, sms)


@pytest.mark.parametrize("mkn", RAGGED_1X1)
def test_wgmma_1x1_kernels_match_plain_at_ragged_k_and_n(cuda, mkn):
    """#3, #4 and #6 in bf16 where K or N is not a multiple of 64 (the TMA's
    zero fill past K and N, the epilogue's column mask) or of 8 (the
    wrapper's zero padding)."""
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=g, device=cuda) * k ** -0.5).to(torch.bfloat16)
    ref = port_conv.gemm_stats_plain(x, w)
    _build.LAUNCHES.clear()
    got = {
        port_conv.KERNEL: port_conv.conv1x1_with_stats_fwd(x.reshape(m, 1, 1, k), w),
        port_conv.GEMM_KERNEL: port_conv.gemm_with_stats_fwd(x, w),
        port_bf.CONV1: port_bf.conv1x1_stats(x.reshape(m, 1, 1, k), w),
    }
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {name: 1 for name in got}
    for y, s1, s2 in got.values():
        _check_stats((y.reshape(m, n), s1, s2), ref)


def test_f32_bottleneck_launches_the_f32_kernel_only(cuda):
    """A float32 bottleneck under conv1x1_mode='pallas_stats' launches the
    float32 kernel for conv1 and conv3 in a train forward, BatchNorm's float32
    kernels, and the bf16 core never; its output and running statistics match
    'pallas_stats_interpret' (the plain GEMM) within 1e-4 of the largest entry."""
    from bdvcil_torch.models.resnet_tsm import Bottleneck, nchw

    g = torch.Generator().manual_seed(14)
    x = torch.randn((4 * T, 8, 8, 256), generator=g).to(cuda)
    launches, outs, stats = {}, {}, {}
    for mode in ("pallas_stats", "pallas_stats_interpret"):
        block = Bottleneck(256, 64, 1, T, 8, True, torch.float32, torch.float32,
                           conv1x1_mode=mode)
        pg = torch.Generator().manual_seed(15)
        with torch.no_grad():
            for name, p in block.named_parameters():
                if p.dim() == 4:
                    p.copy_(torch.randn(p.shape, generator=pg) / p[0].numel() ** 0.5)
        block.to(cuda)
        _build.LAUNCHES.clear()
        outs[mode] = block(nchw(x), True)
        torch.cuda.synchronize()
        launches[mode] = dict(_build.LAUNCHES)
        stats[mode] = {k: v for k, v in block.state_dict().items() if "running" in k}
    # bn2 through the module's BatchNorm kernels; bn1 and bn3 normalize the
    # GEMM's sums, in 'pallas_stats_interpret' with the plain versions
    bn2 = {port_bn.STATS + port_bn.F32: 1, port_bn.FINALIZE + port_bn.F32: 1,
           port_bn.APPLY + port_bn.F32: 1}
    assert launches == {"pallas_stats": {port_conv.KERNEL_F32: 2, **bn2,
                                         port_bn.FINALIZE + port_bn.F32: 3,
                                         port_bn.APPLY + port_bn.F32: 3},
                        "pallas_stats_interpret": bn2}
    ref = outs["pallas_stats_interpret"]
    assert float((outs["pallas_stats"] - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    for k, v in stats["pallas_stats_interpret"].items():
        torch.testing.assert_close(stats["pallas_stats"][k], v, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,segs", [((2 * 4, 4, 4, 16), 4), ((8, 2, 2, 8), 4),
                                        ((8 * T, 7, 7, 256), T), ((4, 3, 5, 12), T),
                                        ((64, 28, 28, 512), 8)])
def test_shift_kernel_bit_exact_both_directions(cuda, shape, segs, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    _build.LAUNCHES.clear()
    fwd = port_tsm.shift_fwd(x, segs, 8)
    rev = port_tsm.shift_fwd(x, segs, 8, reverse=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[port_tsm.SHIFT] == 2
    assert torch.equal(fwd, port_tsm.temporal_shift(x, segs, 8))
    assert torch.equal(rev, port_tsm.temporal_unshift(x, segs, 8))
    xi = x.clone().requires_grad_(True)
    port_tsm.temporal_shift_kernel(xi, segs, 8).backward(x)
    assert torch.equal(xi.grad, port_tsm.temporal_unshift(x, segs, 8))


def _check_stats(got, ref):
    (y, s1, s2), (ry, rs1, rs2) = got, ref
    assert y.shape == ry.shape and y.dtype == ry.dtype
    assert bool(((y.float() - ry.float()).abs() <= _bf16_ulp(ry.float())).all())
    for a, b in ((s1, rs1), (s2, rs2)):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3 * float(b.abs().max()))


@pytest.mark.parametrize("mk", [(300, 64, 64), (401408 // 8, 256, 64), (6272, 2048, 512)])
def test_gemm_with_stats_kernel_matches_plain_and_jax_rule(cuda, mk):
    m, k, n = mk
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=g, device=cuda) * k ** -0.5).to(torch.bfloat16)
    _build.LAUNCHES.clear()
    got = port_conv.gemm_with_stats_fwd(x, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[port_conv.GEMM_KERNEL] == 1 and got[0].shape == (m, n)
    _check_stats(got, port_conv.gemm_stats_plain(x, w))
    # the VJP against JAX's _bwd rule in f32 on the kernel's own y
    gy = torch.randn((m, n), generator=g, device=cuda).to(torch.bfloat16)
    gs1 = torch.randn((n,), generator=g, device=cuda)
    gs2 = torch.randn((n,), generator=g, device=cuda) * 1e-3
    xi, wi = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y, s1, s2 = port_conv.gemm_with_stats(xi, wi)
    torch.autograd.backward([y, s1, s2], [gy, gs1, gs2])
    dy = (gy.float() + gs1 + 2.0 * gs2 * y.detach().float()).to(torch.bfloat16).float()
    for got_g, ref in ((xi.grad, dy @ w.float().t()), (wi.grad, x.float().t() @ dy)):
        torch.testing.assert_close(got_g.float(), ref, rtol=1e-2, atol=1e-2 * float(ref.abs().max()))


def _block_operands(cuda, nt, hw, c, cm, seed=5):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((nt, hw, hw, c), generator=g, device=cuda).to(torch.bfloat16)
    y = torch.randn((nt, hw, hw, cm), generator=g, device=cuda).to(torch.bfloat16)
    a = torch.rand((cm,), generator=g, device=cuda) + 0.5
    b = torch.randn((cm,), generator=g, device=cuda).abs() * 0.5 + 0.1  # b > 0: halo shows
    p = port_bf.make_params(torch.Generator().manual_seed(seed), c=c, cm=cm, device=cuda)
    w1 = p.w1.contiguous()
    w3 = p.w3.contiguous()
    return x, y, a, b, w1, p.w2.contiguous(), w3


@pytest.mark.parametrize("geometry", [(4, 9, 64, 64), (8, 14, 256, 64), (16, 7, 512, 128),
                                      (3, 5, 128, 256)])
def test_block_stats_kernels_match_plain(cuda, geometry):
    x, y, a, b, w1, w2, w3 = _block_operands(cuda, *geometry)
    _build.LAUNCHES.clear()
    out1 = port_bf.conv1x1_stats(x, w1)
    out3 = port_bf.conv1x1_affine_relu_stats(y, a, b, w3)
    out2 = {v: port_bf.conv3x3_affine_relu_stats(y, a, b, w2, variant=v)
            for v in port_bf.VARIANTS}
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_bf.CONV1: 1, port_bf.CONV3: 1, port_bf.CONV2: 2}
    _check_stats(out1, port_conv.gemm_stats_plain(x, w1))
    _check_stats(out3, port_bf.conv1x1_affine_relu_stats_plain(y, a, b, w3))
    for v, got in out2.items():
        _check_stats(got, port_bf.conv3x3_affine_relu_stats_plain(y, a, b, w2, variant=v))


def test_block_stats_kernels_are_deterministic(cuda):
    x, y, a, b, w1, w2, w3 = _block_operands(cuda, 32, 28, 256, 64)
    for fn in (lambda: port_bf.conv1x1_stats(x, w1),
               lambda: port_bf.conv1x1_affine_relu_stats(y, a, b, w3),
               lambda: port_bf.conv3x3_affine_relu_stats(y, a, b, w2)):
        for u, v in zip(fn(), fn()):
            assert torch.equal(u, v)


def test_fused_block_on_the_card_matches_its_plain_composition(cuda):
    x, *_ = _block_operands(cuda, 16, 14, 256, 64)
    p = port_bf.make_params(torch.Generator().manual_seed(6), c=256, cm=64, device=cuda)
    for variant in port_bf.VARIANTS:
        _build.LAUNCHES.clear()
        out, stats = port_bf.fused_bottleneck_fwd(x, p, conv3x3_variant=variant)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {port_bf.CONV1: 1, port_bf.CONV2: 1, port_bf.CONV3: 1,
                                   port_bf.FINALIZE: 3, port_bf.EPILOGUE: 1}
        ref, ref_stats = port_bf.fused_bottleneck_fwd_plain(x, p, conv3x3_variant=variant)
        assert_close_to_terms(out, ref, (x, p.b3))
        for got, want in zip(stats, ref_stats):
            for u, v in zip(got, want):
                torch.testing.assert_close(u, v, rtol=1e-3, atol=1e-3)
        lib, lib_stats = port_bf.plain_bottleneck_fwd(x, p)
        assert_close_to_terms(out, lib, (x, p.b3))
        for got, want in zip(stats, lib_stats):
            for u, v in zip(got, want):
                torch.testing.assert_close(u, v, rtol=1e-4, atol=1e-4)


def _same_bits(got, ref):
    """Equal bit for bit, NaN where the other is NaN."""
    nan = got.isnan()
    ibits = torch.int16 if got.element_size() == 2 else torch.int32
    return (torch.equal(nan, ref.isnan())
            and torch.equal(got.view(ibits)[~nan], ref.view(ibits)[~nan]))


# the stride-1 bottleneck widths of ResNet-50, (frames, H = W, C, Cm), and a
# ragged row count (315 rows of 17 packs: no whole chunk of the grid)
TAIL_GEOMETRIES = [(8, 56, 256, 64), (8, 28, 512, 128), (8, 14, 1024, 256), (8, 7, 2048, 512),
                   (5, 7, 136, 64)]


@pytest.mark.parametrize("geometry", TAIL_GEOMETRIES,
                         ids=[f"{n}x{h}x{h}x{c}" for n, h, c, _ in TAIL_GEOMETRIES])
def test_block_tail_kernels_bit_exact_at_r50_widths(cuda, geometry):
    nt, hw, c, cm = geometry
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((nt, hw, hw, c), generator=g, device=cuda).to(torch.bfloat16)
    y = (torch.randn((nt, hw, hw, c), generator=g, device=cuda) * 3).to(torch.bfloat16)
    y.view(-1, c)[1, :8] = float("nan")
    a = torch.rand((c,), generator=g, device=cuda) + 0.5
    b = torch.randn((c,), generator=g, device=cuda) * 0.5
    count = float(nt * hw * hw)
    _build.LAUNCHES.clear()
    out = port_bf.affine_residual_relu(y, a, b, x)
    fins = {}
    for width in (c, cm):
        xf = x[..., :width].float()
        s, q = xf.sum((0, 1, 2)), (xf * xf).sum((0, 1, 2))
        gamma = torch.rand((width,), generator=g, device=cuda) + 0.5
        beta = torch.randn((width,), generator=g, device=cuda) * 0.1
        fins[width] = (port_bf.bn_finalize(s, q, gamma, beta, count, 1e-5),
                       port_bf.bn_finalize_plain(s, q, gamma, beta, count, 1e-5))
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_bf.EPILOGUE: 1, port_bf.FINALIZE: 2}
    assert _same_bits(out, port_bf.affine_residual_relu_plain(y, a, b, x))
    assert bool(out.view(-1, c)[1, :8].isnan().all()) and bool((out[~out.isnan()] >= 0).all())
    for width, (got, ref) in fins.items():
        assert got.shape == (4, width) and _same_bits(got, ref), width
        assert bool(torch.isfinite(got).all())


def test_block_tail_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """float16, two dtypes, other shapes, non-contiguous operands and vectors
    that are not contiguous f32 (C,) on the operand's device; any C (past the
    6144 channels a and b take in shared memory too) and alignment are taken
    (the per-element forms), and a refused call counts no launch."""
    bf16 = torch.bfloat16
    y = torch.zeros((2, 3, 3, 16), device=cuda, dtype=bf16)
    v = torch.ones((16,), device=cuda)
    _build.LAUNCHES.clear()
    with pytest.raises(TypeError):
        port_bf.affine_residual_relu(y.half(), v, v, y.half())
    with pytest.raises(TypeError):
        port_bf.affine_residual_relu(y.float(), v, v, y)
    with pytest.raises(ValueError, match="float32"):
        port_bf.affine_residual_relu(y, v.double(), v, y)
    with pytest.raises(ValueError, match="shapes"):
        port_bf.affine_residual_relu(y, v, v, y[:1])
    with pytest.raises(ValueError, match="contiguous"):
        port_bf.affine_residual_relu(y.transpose(1, 2), v, v, y)
    with pytest.raises(ValueError):
        port_bf.affine_residual_relu(y, v.cpu(), v, y)
    with pytest.raises(ValueError, match="float32"):
        port_bf.bn_finalize(v.double(), v, v, v, 4.0, 1e-5)
    with pytest.raises(ValueError):
        port_bf.bn_finalize(v, v[:8], v, v, 4.0, 1e-5)
    with pytest.raises(ValueError):
        port_bf.bn_finalize(v, v.cpu(), v, v, 4.0, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        port_bf.bn_finalize(v, torch.ones((32,), device=cuda)[::2], v, v, 4.0, 1e-5)
    assert sum(_build.LAUNCHES.values()) == 0
    wide = torch.ones((1, 6152), device=cuda, dtype=bf16)  # once refused: C > 6144
    av = torch.ones((6152,), device=cuda)
    out = port_bf.affine_residual_relu(wide, av, av, wide)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_bf.EPILOGUE: 1} and bool((out == 3).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [12, 20, 3, 8, 64])
def test_block_tail_kernels_take_any_channel_count(cuda, c, dtype):
    """#9b and #9a bit for bit at C off the 16-byte packs, and on operands
    that do not start on a 16-byte boundary (both per-element forms), NaN
    kept."""
    g = torch.Generator(device=cuda).manual_seed(16)
    rows = 37
    flat = torch.randn((2, rows * c + 1), generator=g, device=cuda).to(dtype)
    x, y = flat[0, 1:].view(rows, c), (flat[1, :-1] * 3).view(rows, c)
    y.view(-1)[5] = float("nan")
    ab = torch.rand((2, c + 1), generator=g, device=cuda)
    a, b = ab[0, 1:] + 0.5, ab[1, :c] - 0.5
    for args in ((y, a, b, x), (y.clone(), a.clone(), b.clone(), x.clone())):
        _build.LAUNCHES.clear()
        out = port_bf.affine_residual_relu(*args)
        fin = port_bf.bn_finalize(args[1], args[2], a + 1.0, b, 7.0, 1e-5)
        torch.cuda.synchronize()
        name = port_bf.EPILOGUE_F32 if dtype == torch.float32 else port_bf.EPILOGUE
        assert _build.LAUNCHES == {name: 1, port_bf.FINALIZE: 1}
        assert _same_bits(out, port_bf.affine_residual_relu_plain(*args))
        assert _same_bits(fin, port_bf.bn_finalize_plain(args[1], args[2], a + 1.0, b, 7.0,
                                                         1e-5))


# past the 6144 channels a and b take in shared memory: a whole number of
# 16-byte packs in both dtypes (6152), and none (8193)
WIDE_TAIL_C = [6152, 8193]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", WIDE_TAIL_C)
def test_block_tail_kernels_past_6144_channels_bit_exact(cuda, c, dtype):
    """#9b with a and b read through the read-only cache (C past the shared
    staging), in its pack form (6152) and its per-element form (8193), bit
    for bit against the plain version, NaN kept."""
    g = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randn((37, c), generator=g, device=cuda).to(dtype)
    y = (torch.randn((37, c), generator=g, device=cuda) * 3).to(dtype)
    y[1, :8] = float("nan")
    a = torch.rand((c,), generator=g, device=cuda) + 0.5
    b = torch.randn((c,), generator=g, device=cuda) * 0.5
    _build.LAUNCHES.clear()
    out = port_bf.affine_residual_relu(y, a, b, x)
    torch.cuda.synchronize()
    name = port_bf.EPILOGUE_F32 if dtype == torch.float32 else port_bf.EPILOGUE
    assert _build.LAUNCHES == {name: 1}
    assert _same_bits(out, port_bf.affine_residual_relu_plain(y, a, b, x))
    assert bool(out[1, :8].isnan().all())


# #8 bf16 where its window is three bands, (NT, H, W, Cin, Cout): layer1 of a
# 720p clip (W = 320) and of a 1080p one (W = 480), one column past the old
# widest image (272), Cin 2048 one past its old widest (248), and Cin 2056
# (a and b a 64-channel slice a window, the last slice 8 channels)
BANDED_3X3 = [(2, 12, 272, 64, 64), (8, 180, 320, 64, 64), (2, 270, 480, 64, 64),
              (1, 5, 248, 2048, 512), (1, 3, 248, 2056, 64)]


@pytest.mark.parametrize("geometry", BANDED_3X3)
def test_wgmma_conv3x3_in_bands_matches_plain(cuda, geometry):
    """#8 bf16 at wide images against its plain version (one bf16 ulp, the
    statistics rtol 1e-3), b > 0 on every channel (a halo of relu(b) would
    show), the same bits on a second run; its C plan three bands of 136 rows,
    equal to ``gemm_plan.conv3x3_plan``."""
    nt, h, w_, cin, cout = geometry
    g = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn((nt, h, w_, cin), generator=g, device=cuda).to(torch.bfloat16)
    a = torch.rand((cin,), generator=g, device=cuda) + 0.5
    b = torch.rand((cin,), generator=g, device=cuda) * 0.5 + 0.1
    w2 = (torch.randn((3, 3, cin, cout), generator=g, device=cuda)
          * (9 * cin) ** -0.5).to(torch.bfloat16)
    plan = gemm_plan.conv3x3_kernel_plan(nt * h * w_, cout, w_, cin, cuda)
    assert plan == gemm_plan.conv3x3_plan(nt * h * w_, cout, w_, cin, port_conv.sm_count(cuda))
    assert (plan.boxes, plan.box_rows, plan.box_step, plan.band) == (3, 136, w_, 136)
    _build.LAUNCHES.clear()
    got = port_bf.conv3x3_affine_relu_stats(x, a, b, w2)
    again = port_bf.conv3x3_affine_relu_stats(x, a, b, w2)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_bf.CONV2: 2}
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    _check_stats(got, port_bf.conv3x3_affine_relu_stats_plain(x, a, b, w2))


@pytest.mark.parametrize("k", [4672, 18432, 36864])
def test_wgmma_deep_products_within_one_ulp(cuda, k):
    """#3 and #7 (the 1x1 forms) past K = 4608, where the core adds chunks of
    8 k-steps in IEEE f32: y within one bf16 ulp of the plain version and
    within 0.6 of one of the float64 product (the tensor cores' own sum read
    0.78 ulps at K = 4608, 1.8 at 18432 and 3.8 at 36864 on an H100,
    ``python -m bdvcil_torch.bf16_witness``; 0.5 is the rounding), the same
    bits twice."""
    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.rand((4096, k), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, 512), generator=g, device=cuda) * k ** -0.5).to(torch.bfloat16)
    a = torch.ones((k,), device=cuda)
    _build.LAUNCHES.clear()
    got = port_conv.gemm_with_stats_fwd(x, w)
    again = port_conv.gemm_with_stats_fwd(x, w)
    got3 = port_bf.conv1x1_affine_relu_stats(x, a, 0 * a, w)  # relu(x) = x: x >= 0
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_conv.GEMM_KERNEL: 2, port_bf.CONV3: 1}
    assert all(torch.equal(u, v) for u, v in zip(got, again)) and torch.equal(got[0], got3[0])
    _check_stats(got, port_conv.gemm_stats_plain(x, w))
    ref = x.double() @ w.double()
    ulp = _bf16_ulp(ref.float()).double()
    assert float(((got[0].double() - ref).abs() / ulp).max()) <= 0.6


def test_conv3x3_plans_are_the_kernels_at_any_width(cuda):
    """Both 3x3s' C plans equal their Python copies from one box to the
    widest W, at Cout 64 and 512."""
    sms = port_conv.sm_count(cuda)
    for w_ in (7, 63, 64, 135, 136, 272, 320, 480, 4096, 65535):
        for n in (64, 512):
            m = 2 * 3 * w_
            for c in (64, 2048):
                assert gemm_plan.conv3x3_kernel_plan(m, n, w_, c, cuda) == \
                    gemm_plan.conv3x3_plan(m, n, w_, c, sms)
            assert gemm_plan.tf32_conv3x3_kernel_plan(m, n, w_, cuda) == \
                gemm_plan.tf32_conv3x3_plan(m, n, w_, sms)


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """The block's stats ops take float32 and bfloat16 at any channel count,
    both 3x3s any W < 65536 and H < 32768 (``pixel_of``'s packing); they
    refuse float16, two dtypes, W = 65536 or H = 32768, vectors on another
    device and non-contiguous operands, before a launch; the bf16 3x3
    launches one column past the image it once refused (W = 272)."""
    bf16 = torch.bfloat16
    y = torch.zeros((2, 4, 4, 32), device=cuda, dtype=bf16)
    a = torch.ones((32,), device=cuda)
    _build.LAUNCHES.clear()
    with pytest.raises(TypeError):  # float16: no configuration computes in it
        port_bf.conv3x3_affine_relu_stats(y.half(), a, a, torch.zeros((3, 3, 32, 64),
                                                                      device=cuda).half())
    with pytest.raises(TypeError):
        port_bf.conv1x1_affine_relu_stats(y.half(), a, a, torch.zeros((32, 64),
                                                                      device=cuda).half())
    with pytest.raises(TypeError):  # two dtypes
        port_bf.conv1x1_affine_relu_stats(y.float(), a, a, torch.zeros((32, 64), device=cuda,
                                                                        dtype=bf16))
    for dtype in (bf16, torch.float32):
        for shape in ((1, 1, 1 << 16, 8), (1, 1 << 15, 1, 8)):
            with pytest.raises(ValueError, match="W < 65536"):
                port_bf.conv3x3_affine_relu_stats(
                    torch.zeros(shape, device=cuda, dtype=dtype), a[:8], a[:8],
                    torch.zeros((3, 3, 8, 8), device=cuda, dtype=dtype))
    with pytest.raises(ValueError):  # a on the wrong device
        port_bf.conv1x1_affine_relu_stats(y, a.cpu(), a, torch.zeros((32, 64), device=cuda,
                                                                   dtype=bf16))
    with pytest.raises(ValueError):  # not contiguous
        port_conv.gemm_with_stats_fwd(torch.zeros((64, 64), device=cuda, dtype=bf16).t()[:, :32],
                                      torch.zeros((32, 64), device=cuda, dtype=bf16))
    assert sum(_build.LAUNCHES.values()) == 0
    with pytest.raises(TypeError):
        port_tsm.shift_fwd(torch.zeros((2, 2, 2, 16), device=cuda, dtype=torch.float16), 2)
    with pytest.raises(ValueError):  # N*T not a multiple of T
        port_tsm.shift_fwd(torch.zeros((3, 2, 2, 16), device=cuda), 2)
    _build.LAUNCHES.clear()
    x = torch.ones((1, 2, 272, 8), device=cuda, dtype=bf16)
    y, s1, _ = port_bf.conv3x3_affine_relu_stats(x, a[:8], 0 * a[:8],
                                                 torch.ones((3, 3, 8, 8), device=cuda, dtype=bf16))
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_bf.CONV2: 1}
    assert float(y[0, 0, 0, 0]) == 4 * 8 and float(y[0, 1, 100, 0]) == 6 * 8


# (NT, H = W, C, Cm): the JAX tests' geometries, one R50-like, a ragged one
F32_BLOCK_GEOMETRIES = [(8, 14, 64, 16), (6, 7, 32, 8), (4, 9, 256, 64), (3, 5, 12, 20)]


@pytest.mark.parametrize("geometry", F32_BLOCK_GEOMETRIES)
def test_block_f32_kernels_match_plain(cuda, geometry):
    """#6, #7 and #8 (both variant names) in float32 against their plain
    versions (TF32 off), b > 0 on every channel (a halo or rows past M
    through the prologue would show), the same bits on a second run."""
    nt, hw, c, cm = geometry
    g = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn((nt, hw, hw, c), generator=g, device=cuda)
    y = torch.randn((nt, hw, hw, cm), generator=g, device=cuda)
    a = torch.rand((cm,), generator=g, device=cuda) + 0.5
    b = torch.rand((cm,), generator=g, device=cuda) * 0.5 + 0.1
    w1 = torch.randn((c, cm), generator=g, device=cuda) * c ** -0.5
    w2 = torch.randn((3, 3, cm, cm), generator=g, device=cuda) * (9 * cm) ** -0.5
    w3 = torch.randn((cm, c), generator=g, device=cuda) * cm ** -0.5
    assert not torch.backends.cuda.matmul.allow_tf32
    _build.LAUNCHES.clear()
    out1 = port_bf.conv1x1_stats(x, w1)
    out3 = port_bf.conv1x1_affine_relu_stats(y, a, b, w3)
    out2 = {v: port_bf.conv3x3_affine_relu_stats(y, a, b, w2, variant=v)
            for v in port_bf.VARIANTS}
    again = port_bf.conv3x3_affine_relu_stats(y, a, b, w2)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_bf.CONV1_F32: 1, port_bf.CONV3_F32: 1, port_bf.CONV2_F32: 3}
    _check_f32(out1, port_conv.gemm_stats_plain(x, w1))
    _check_f32(out3, port_bf.conv1x1_affine_relu_stats_plain(y, a, b, w3))
    for v, got in out2.items():
        _check_f32(got, port_bf.conv3x3_affine_relu_stats_plain(y, a, b, w2, variant=v))
    assert all(torch.equal(u, v) for u, v in zip(out2["taps"], again))


def test_f32_fused_block_launches_the_f32_kernels_only(cuda, monkeypatch):
    """fused_bottleneck_fwd on float32 operands: one launch of each float32
    kernel and three finalizes, no bf16 launch; the output within 1e-4 of the
    terms' size of its plain composition and of the library block (TF32 off
    in cuDNN too)."""
    x = torch.randn((16, 14, 14, 256), generator=torch.Generator().manual_seed(18)).to(cuda)
    p = port_bf.make_params(torch.Generator().manual_seed(19), c=256, cm=64,
                            dtype=torch.float32, device=cuda)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # the library block's convs
    for variant in port_bf.VARIANTS:
        _build.LAUNCHES.clear()
        out, stats = port_bf.fused_bottleneck_fwd(x, p, conv3x3_variant=variant)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {port_bf.CONV1_F32: 1, port_bf.CONV2_F32: 1,
                                   port_bf.CONV3_F32: 1, port_bf.FINALIZE: 3,
                                   port_bf.EPILOGUE_F32: 1}
        assert out.dtype == torch.float32
        ref, ref_stats = port_bf.fused_bottleneck_fwd_plain(x, p, conv3x3_variant=variant)
        lib, lib_stats = port_bf.plain_bottleneck_fwd(x, p)
        for want, want_stats in ((ref, ref_stats), (lib, lib_stats)):
            assert_close_to_terms(out, want, (x, p.b3), tol=1e-4)
            for got, w in zip(stats, want_stats):
                for u, v in zip(got, w):
                    torch.testing.assert_close(u, v, rtol=1e-4, atol=1e-5)


# (NT, H, W, Cin, Cout): Cin and Cout not multiples of 64 (the TMA's zero fill
# past C in each tap) or of 8 (the wrapper's padding), W past one TMA box
RAGGED_3X3 = [(8, 14, 14, 16, 16), (6, 7, 7, 8, 8), (4, 5, 9, 12, 20), (2, 3, 3, 3, 5),
              (2, 64, 64, 64, 64), (1, 112, 112, 64, 64), (1, 9, 200, 32, 72),
              (3, 7, 7, 96, 136)]


@pytest.mark.parametrize("geometry", RAGGED_3X3)
def test_wgmma_block_ops_at_any_channel_count_and_width(cuda, geometry):
    """#8 and #7 in bf16 at channel counts off the 64-channel step and at
    wide images against the plain versions, b > 0 on every channel; the C
    side's 3x3 plan equal to ``gemm_plan.conv3x3_plan``."""
    nt, h, w_, cin, cout = geometry
    g = torch.Generator(device=cuda).manual_seed(20)
    x = torch.randn((nt, h, w_, cin), generator=g, device=cuda).to(torch.bfloat16)
    a = torch.rand((cin,), generator=g, device=cuda) + 0.5
    b = torch.rand((cin,), generator=g, device=cuda) * 0.5 + 0.1
    w2 = (torch.randn((3, 3, cin, cout), generator=g, device=cuda)
          * (9 * cin) ** -0.5).to(torch.bfloat16)
    w3 = (torch.randn((cin, cout), generator=g, device=cuda) * cin ** -0.5).to(torch.bfloat16)
    cin8, cout8 = -(-cin // 8) * 8, -(-cout // 8) * 8
    assert gemm_plan.conv3x3_kernel_plan(nt * h * w_, cout8, w_, cin8, cuda) == \
        gemm_plan.conv3x3_plan(nt * h * w_, cout8, w_, cin8, port_conv.sm_count(cuda))
    _build.LAUNCHES.clear()
    got2 = {v: port_bf.conv3x3_affine_relu_stats(x, a, b, w2, variant=v)
            for v in port_bf.VARIANTS}
    got3 = port_bf.conv1x1_affine_relu_stats(x, a, b, w3)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_bf.CONV2: 2, port_bf.CONV3: 1}
    for v, got in got2.items():
        _check_stats(got, port_bf.conv3x3_affine_relu_stats_plain(x, a, b, w2, variant=v))
    _check_stats(got3, port_bf.conv1x1_affine_relu_stats_plain(x, a, b, w3))


# --- the persistent wgmma core (csrc/gemm_stats_sm90.cuh): #3, #4, #6, #7 and #8 ---

# the 12 1x1 shapes of a TSM-R50 train forward in configuration A, and ragged M
WGMMA_1X1_SHAPES = sorted(gemm_plan.r50_1x1_shapes()) + [(300, 64, 64), (6272 + 37, 512, 2048)]


@pytest.mark.parametrize("mkn", WGMMA_1X1_SHAPES)
def test_wgmma_1x1_kernels_match_plain_at_r50_shapes(cuda, mkn):
    """#3, #4 and #6 (one kernel, three wrappers) against the plain version."""
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=g, device=cuda) * k ** -0.5).to(torch.bfloat16)
    ref = port_conv.gemm_stats_plain(x, w)
    _build.LAUNCHES.clear()
    got = {
        port_conv.KERNEL: port_conv.conv1x1_with_stats_fwd(x.reshape(m, 1, 1, k), w),
        port_conv.GEMM_KERNEL: port_conv.gemm_with_stats_fwd(x, w),
        port_bf.CONV1: port_bf.conv1x1_stats(x.reshape(m, 1, 1, k), w),
    }
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {name: 1 for name in got}
    for y, s1, s2 in got.values():
        _check_stats((y.reshape(m, n), s1, s2), ref)


@pytest.mark.parametrize("geometry", list(gemm_plan.R50_3X3_SHAPES[:1]) + [
    (16, hw, hw, c, n) for _, hw, _, c, n in gemm_plan.R50_3X3_SHAPES[1:]] + [
    (3, 7, 5, 64, 128), (2, 3, 11, 128, 64), (2, 5, 63, 64, 64)])
def test_wgmma_conv3x3_matches_plain_at_r50_widths(cuda, geometry):
    """#8 at the four stride-1 widths, at a ragged NT*H*W and at the widest
    image it takes (W = 63), with b > 0 on every channel, so a halo of
    relu(b) instead of zero would show."""
    nt, h, w_, c, n = geometry
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn((nt, h, w_, c), generator=g, device=cuda).to(torch.bfloat16)
    a = torch.rand((c,), generator=g, device=cuda) + 0.5
    b = torch.rand((c,), generator=g, device=cuda) * 0.5 + 0.1
    w = (torch.randn((3, 3, c, n), generator=g, device=cuda) * (9 * c) ** -0.5).to(torch.bfloat16)
    _build.LAUNCHES.clear()
    got = port_bf.conv3x3_affine_relu_stats(x, a, b, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_bf.CONV2: 1}
    _check_stats(got, port_bf.conv3x3_affine_relu_stats_plain(x, a, b, w))


@pytest.mark.parametrize("mkn", list(gemm_plan.R50_1X1_AFFINE_SHAPES) + [
    (300, 64, 256), (6272 + 37, 512, 2048), (3 * 5 * 7, 128, 512)])
def test_wgmma_conv1x1_affine_matches_plain_at_r50_widths(cuda, mkn):
    """#7 (the block's conv3: the prologue applied to the TMA's A tile) at
    the four stride-1 widths and at ragged M, with b > 0 on every channel, so
    a prologue applied to the zero-filled rows past M would show in the
    statistics."""
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    a = torch.rand((k,), generator=g, device=cuda) + 0.5
    b = torch.rand((k,), generator=g, device=cuda) * 0.5 + 0.1
    w = (torch.randn((k, n), generator=g, device=cuda) * k ** -0.5).to(torch.bfloat16)
    _build.LAUNCHES.clear()
    got = port_bf.conv1x1_affine_relu_stats(x, a, b, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {port_bf.CONV3: 1}
    _check_stats(got, port_bf.conv1x1_affine_relu_stats_plain(x, a, b, w))


@pytest.mark.parametrize("bn", (256, 128, 64))
def test_wgmma_statistics_repeat_bit_for_bit_per_tile_width(cuda, bn):
    """Each tile instantiation, in each way of loading A (rows, rows with the
    prologue, the 3x3's window): a second run gives the same y and the same
    statistics, bit for bit (no float atomics)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    m, k, nt, hw = 50_000, 256, 16, 56
    assert gemm_plan.kernel_plan(m, k, bn, cuda).block_n == bn
    assert gemm_plan.kernel_plan(nt * hw * hw, 9 * 64, bn, cuda).block_n == bn
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, bn), generator=g, device=cuda) * 0.05).to(torch.bfloat16)
    xi = torch.randn((nt, hw, hw, 64), generator=g, device=cuda).to(torch.bfloat16)
    a = torch.rand((64,), generator=g, device=cuda) + 0.5
    b = torch.rand((64,), generator=g, device=cuda)
    w2 = (torch.randn((3, 3, 64, bn), generator=g, device=cuda) * 0.05).to(torch.bfloat16)
    a_k = torch.rand((k,), generator=g, device=cuda) + 0.5
    b_k = torch.rand((k,), generator=g, device=cuda)
    for fn in (lambda: port_conv.gemm_with_stats_fwd(x, w),
               lambda: port_bf.conv1x1_affine_relu_stats(x, a_k, b_k, w),
               lambda: port_bf.conv3x3_affine_relu_stats(xi, a, b, w2)):
        for u, v in zip(fn(), fn()):
            assert torch.equal(u, v)


def test_wgmma_plan_covers_every_shape(cuda):
    """The C side's tile plan (which the wrappers do not mirror: they give the
    kernel one partial row per SM) at every R50 shape of #3, #7 and #8 and a
    few ragged ones: a width that divides N rounded up to 64, every tile
    once, at most one CTA per SM; and the picker's trade of waves against
    width."""
    sms = port_conv.sm_count(cuda)
    mkn = (WGMMA_1X1_SHAPES + list(gemm_plan.R50_1X1_AFFINE_SHAPES) + RAGGED_1X1
           + [(nt * h * w_, 9 * c, n) for nt, h, w_, c, n in gemm_plan.R50_3X3_SHAPES]
           + [(1, 64, 64), (129, 8, 320), (7, 8, 8), (6272, 18432, 512), (300, 4616, 256)])
    for m, k, n in mkn:
        p = gemm_plan.kernel_plan(m, k, n, cuda)
        assert p == gemm_plan.wgmma_plan(m, n, sms, ksteps=-(-k // 64))
        assert p.block_n in (64, 128, 256) and p.n_tiles * p.block_n == -(-n // 64) * 64
        assert p.block_n <= 128 or k <= 64 * gemm_plan.WHOLE_STEPS  # a deep product
        assert p.m_tiles == -(-m // gemm_plan.BLOCK_M) and p.tiles == p.m_tiles * p.n_tiles
        assert p.grid == min(p.tiles, sms)
    if sms == 132:  # an H100 SXM
        # layer3 3x3 (M = 25088, N = 256): 196 tiles of 128x256 take 2 rounds,
        # 392 of 128x128 take 3, and 2 * (256 + 32) > 3 * (128 + 32)
        assert gemm_plan.kernel_plan(25088, 9 * 256, 256, cuda).block_n == 128
        assert gemm_plan.kernel_plan(401408, 64, 256, cuda).block_n == 256
        # layer4 (M = 6272, N = 512): 98 tiles of 256 tie 392 of 64; the tie goes wide
        p = gemm_plan.kernel_plan(6272, 9 * 512, 512, cuda)
        assert (p.block_n, p.tiles, p.grid) == (256, 98, 98)


@pytest.mark.parametrize("config,flags,kernel,per_call,module_bns", [
    ("A", [], port_conv.KERNEL, 32, 21),
    ("B", ["--forward-only"], port_tsm.FWD, 16, 0),
], ids=["A step", "B forward"])
def test_bench_step_launches_the_kernels(cuda, config, flags, kernel, per_call, module_bns):
    """``bench_step`` at TSM-R50, batch 2 x 8 x 224²: config A's train step
    launches conv1x1_with_stats 32 times a step and train-mode BatchNorm's
    kernels (21 statistics, 53 of each other a step), config B's
    forward-only bench (eval mode) the fused epilogue 16 times a forward; the
    step's shares of the card's peaks are in (0, 1]."""
    from bdvcil_torch import bench_step

    args = bench_step.build_parser().parse_args(
        ["--config", config, "--batch", "2", "--steps", "2", "--warmup", "1"] + flags)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    line = bench_step.run(args)
    torch.cuda.synchronize()
    want = {kernel: per_call * 3}
    if module_bns:
        want.update({name: (module_bns + per_call) * 3 for name in port_bn.KERNELS})
        want[port_bn.STATS] = module_bns * 3
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == want
    if not flags:
        assert 0 < line["mfu"] <= 1 and 0 < line["bw_roofline_fraction"] <= 1


def test_parity_study_pair_launches_the_shift_kernels(cuda, tmp_path):
    """One cut ``parity_study.run_pair`` on the card (a 4-class tree, 2
    stages, 1 epoch, 1 CBF epoch) with the port's backbone at
    ``shift_mode='fused_block'``: the port's side launches the fused
    epilogue forward and backward in f32, and each train step train-mode
    BatchNorm's f32 kernels once for each of TSM-R18's 20 BatchNorms (8
    blocks: #2 once a block a step); the reference loop (plain torch) none;
    both matrices are finite and in [0, 100]."""
    import copy

    from bdvcil_torch import parity_study
    from bdvcil_torch.reference_loop import tree

    params = dict(tree.TREE_PARAMS, num_classes=4, train_videos_per_class=3,
                  val_videos_per_class=2, extra_val_videos_per_class=1)
    study_tree = tree.build_parity_tree(tmp_path / "data", params)
    model = copy.deepcopy(tree.make_parity_config(*study_tree, tmp_path).to_dict()["model"])
    model["backbone"]["shift_mode"] = "fused_block"
    extra = dict(tree.depth_overrides(2), num_epochs_per_task=1, cbf_num_epochs_per_task=1,
                 model=model)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    run = parity_study.run_pair(study_tree, tmp_path / "work", "base", 0, extra, cuda)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    bn = {k: v for k, v in launches.items() if port_bn.is_launch(k)}
    assert set(launches) - set(bn) == {port_tsm.FWD, port_tsm.BWD}, launches
    assert launches[port_tsm.FWD] > launches[port_tsm.BWD] > 0
    steps = launches[port_tsm.BWD] // 8
    assert launches[port_tsm.BWD] == 8 * steps
    assert bn == {k + port_bn.F32: 20 * steps for k in port_bn.KERNELS}, bn
    assert run["device"].startswith("cuda")
    for key in ("cnn_matrix_reference", "cnn_matrix_port", "nme_matrix_reference",
                "nme_matrix_port"):
        assert [len(row) for row in run[key]] == [1, 2]
        assert all(np.isfinite(v) and 0 <= v <= 100 for row in run[key] for v in row)


# --- train-mode BatchNorm (csrc/batchnorm.cu, ops/batchnorm.py) ---------------

# (N, C, H, W) of the benchmark cells' train-mode BatchNorm modules: TSM-R34 at
# 48 clips x 8 frames (the stem, layer1-4; the shortcuts share these shapes),
# TSM-R50 at 24 x 8 in configuration A (the stem, the 3x3s' bn2, the shortcuts)
BN_MODULE_SHAPES = [(384, 64, 112, 112), (384, 64, 56, 56), (384, 128, 28, 28),
                    (384, 256, 14, 14), (384, 512, 7, 7), (192, 64, 112, 112),
                    (192, 64, 56, 56), (192, 256, 56, 56), (192, 128, 28, 28),
                    (192, 512, 28, 28), (192, 256, 14, 14), (192, 1024, 14, 14),
                    (192, 512, 7, 7), (192, 2048, 7, 7)]
# (N*T, H, W, C) of R50's conv1x1_bn normalizes (conv1 and conv3 of each stage)
BN_SUMS_SHAPES = [(192, 56, 56, 64), (192, 56, 56, 256), (192, 56, 56, 128),
                  (192, 28, 28, 128), (192, 28, 28, 512), (192, 28, 28, 256),
                  (192, 14, 14, 256), (192, 14, 14, 1024), (192, 14, 14, 512),
                  (192, 7, 7, 512), (192, 7, 7, 2048)]


def _bn_module(c, dtype, cuda, seed):
    from bdvcil_torch.models.norm import BatchNorm

    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c, dtype=dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g) * 0.3)
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.3)
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return bn.to(cuda)


def _bn_input(shape, dtype, cuda, seed, channels_last=True):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


def _bn_sums_close(got, ref, terms, what):
    for u, v, t in zip(got, ref, terms):
        err = (u.double() - v.double()).abs()
        assert bool((err <= 1e-5 * t.double() + 1e-30).all()), (
            f"{what}: off by {float(err.max())} of terms {float(t.max())}")


def _bn_kernels_against_plain(x, bn, spec, s1=None, s2=None):
    """The five kernels on x against the plain versions given the same sums;
    returns the kernels' (out, dx)."""
    import copy

    dims = port_bn._dims(x, spec.cdim)
    bn_plain = copy.deepcopy(bn)
    kernels = port_bn._Kernels(x, spec.cdim)
    _build.LAUNCHES.clear()
    if s1 is None:
        s1, s2 = kernels.stats(x, spec.cdim)
        xd = x.double()
        _bn_sums_close((s1, s2), (xd.sum(dims), (xd * xd).sum(dims)),
                       (xd.abs().sum(dims), (xd * xd).sum(dims)), "stats")
    coef = kernels.finalize(s1, s2, spec.count, bn, spec)
    out = kernels.apply(x, coef, spec)
    coef_p = port_bn.finalize_plain(s1, s2, spec.count, bn_plain, spec)
    assert torch.equal(coef, coef_p)
    assert torch.equal(bn.running_mean, bn_plain.running_mean)
    assert torch.equal(bn.running_var, bn_plain.running_var)
    out_p = port_bn.apply_plain(x, coef, spec)
    assert out.dtype == out_p.dtype and out.stride() == out_p.stride()
    assert torch.equal(out, out_p)

    gen = torch.Generator(device=x.device).manual_seed(7)
    g = torch.randn(out.shape, generator=gen, device=x.device).to(out.dtype)
    g = g.contiguous(memory_format=torch.channels_last) if spec.cdim == 1 else g
    sg, sgx = kernels.bwd_reduce(g, x, coef, spec)
    sg_p, sgx_p = port_bn.bwd_reduce_plain(g, x, coef, spec)
    gm = port_bn._masked_g(g, x, coef, spec).abs()
    _bn_sums_close((sg, sgx), (sg_p, sgx_p),
                   (gm.sum(dims), (gm * port_bn._xhat(x, coef, spec).abs()).sum(dims)),
                   "backward sums")
    dx = kernels.bwd_dx(g, x, coef, sg, sgx, spec.count, spec)
    dx_p = port_bn.bwd_dx_plain(g, x, coef, sg, sgx, spec.count, spec)
    assert dx.dtype == x.dtype and dx.stride() == x.stride()
    assert torch.equal(dx, dx_p)
    torch.cuda.synchronize()
    stats = 0 if spec.sums else 1
    suffix = "" if x.dtype == torch.bfloat16 else port_bn.F32
    assert _build.LAUNCHES == {k + suffix: 1 for k in port_bn.KERNELS[1 - stats:]}
    return out, dx


@pytest.mark.parametrize("shape", BN_MODULE_SHAPES)
def test_batchnorm_kernels_match_plain_at_the_cells_shapes(cuda, shape):
    """Every module BatchNorm shape of both cells, bf16, with and without the
    relu: the kernels against the plain versions (ops/batchnorm)."""
    for relu in (True, False):
        x = _bn_input(shape, torch.bfloat16, cuda, shape[1] + relu)
        bn = _bn_module(shape[1], torch.bfloat16, cuda, 3)
        m = x.numel() // shape[1]
        spec = port_bn._Spec(False, relu, torch.bfloat16, float(m), bn.epsilon, 1, False)
        _bn_kernels_against_plain(x, bn, spec)


@pytest.mark.parametrize("shape", BN_SUMS_SHAPES)
def test_batchnorm_normalize_from_sums_matches_plain_at_r50_shapes(cuda, shape):
    """conv1x1_bn's normalize at R50's 1x1 shapes, bf16, relu'd (conv1) or
    not (conv3), from f32 sums of y."""
    for relu in (True, False):
        y = _bn_input(shape, torch.bfloat16, cuda, shape[-1] + relu, channels_last=False)
        yf = y.float().reshape(-1, shape[-1])
        bn = _bn_module(shape[-1], torch.bfloat16, cuda, 4)
        spec = port_bn._Spec(True, relu, torch.bfloat16, float(yf.shape[0]), 1e-5, 3, False)
        _bn_kernels_against_plain(y, bn, spec, yf.sum(0), (yf * yf).sum(0))


@pytest.mark.parametrize("shape,dtype,out_dtype,sums", [
    ((16, 64, 14, 14), torch.float32, torch.float32, False),
    ((16, 13, 9, 7), torch.float32, torch.float32, False),
    ((16, 12, 9, 7), torch.bfloat16, torch.bfloat16, False),
    ((16, 3, 5, 5), torch.bfloat16, torch.float32, False),
    ((16, 96, 6, 6), torch.bfloat16, torch.float32, False),
    ((16, 96, 6, 6), torch.float32, torch.bfloat16, False),
    ((16, 6, 6, 96), torch.float32, torch.float32, True),
    ((16, 6, 6, 40), torch.bfloat16, torch.float32, True),
    ((4, 2, 2, 9000), torch.bfloat16, torch.bfloat16, True),
    ((4, 9000, 2, 2), torch.float32, torch.float32, False),
])
def test_batchnorm_kernels_take_any_channel_count_and_dtype(cuda, shape, dtype, out_dtype,
                                                            sums):
    """float32 and mixed dtypes, C off the 16-byte pack (the per-element
    form), and C past one CTA's columns (9000)."""
    cdim = 3 if sums else 1
    c = shape[cdim]
    for relu in (True, False):
        x = _bn_input(shape, dtype, cuda, c, channels_last=not sums)
        bn = _bn_module(c, out_dtype, cuda, 5)
        spec = port_bn._Spec(sums, relu, out_dtype, float(x.numel() // c), 1e-5, cdim, False)
        if sums:
            xf = x.float().reshape(-1, c)
            _bn_kernels_against_plain(x, bn, spec, xf.sum(0), (xf * xf).sum(0))
        else:
            _bn_kernels_against_plain(x, bn, spec)


def test_batchnorm_kernels_take_a_misaligned_view(cuda):
    """A view at an odd element offset takes the per-element form."""
    base = _bn_input((8 * 33 * 7 * 7 + 1,), torch.bfloat16, cuda, 8, channels_last=False)
    x = base[1:].view(33, 7, 7, 8).permute(0, 3, 1, 2)  # channels_last, 2-byte aligned
    bn = _bn_module(8, torch.bfloat16, cuda, 6)
    spec = port_bn._Spec(False, True, torch.bfloat16, float(33 * 49), 1e-5, 1, False)
    _bn_kernels_against_plain(x, bn, spec)


def test_batchnorm_function_repeats_its_bits(cuda):
    """Two forward and backward passes of the Function give the same bits
    (fixed-order partials, no float atomics)."""
    runs = []
    for _ in range(2):
        bn = _bn_module(256, torch.bfloat16, cuda, 7)
        x = _bn_input((96, 256, 28, 28), torch.bfloat16, cuda, 9).requires_grad_(True)
        y = bn(x, True, relu=True)
        y.backward(torch.ones_like(y))
        runs.append((y, x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
                     bn.running_var))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _bn_function_run(cuda, shape, sums, relu, plain):
    """One forward and backward of train-mode BatchNorm on seeded inputs, the
    Function on the kernels or (``plain``) the plain versions under
    autograd: (out, dx, dweight, dbias, running mean, running var)."""
    cdim = 3 if sums else 1
    c = shape[cdim]
    bn = _bn_module(c, torch.bfloat16, cuda, 11)
    x = _bn_input(shape, torch.bfloat16, cuda, 12, channels_last=not sums).requires_grad_(True)
    if sums:  # differentiable sums: autograd's plain path takes dx through them
        xf = x.float().reshape(-1, c)
        out = port_bn.normalize_from_sums(x, xf.sum(0), (xf * xf).sum(0), bn,
                                          float(xf.shape[0]), 1e-5, torch.bfloat16, relu, plain)
    elif plain:
        spec = port_bn._Spec(False, relu, torch.bfloat16, float(x.numel() // c), bn.epsilon,
                             1, True)
        out = port_bn._forward(port_bn.PLAIN, x, None, None, bn, spec)[0]
    else:
        out = port_bn.batchnorm_train(x, bn, torch.bfloat16, relu)
    gen = torch.Generator(device=cuda).manual_seed(13)
    out.backward(torch.randn(out.shape, generator=gen, device=cuda).to(out.dtype))
    torch.cuda.synchronize()
    return (out.detach(), x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean.clone(),
            bn.running_var.clone())


@pytest.mark.parametrize("shape,sums,relu", [
    ((8, 64, 8, 8), False, True), ((16, 256, 4, 4), False, False),
    ((8, 8, 8, 512), True, True), ((16, 4, 4, 64), True, False),
], ids=["module relu", "module", "sums relu", "sums"])
def test_batchnorm_function_under_a_process_group(cuda, monkeypatch, shape, sums, relu):
    """The Function as the model runs it, under a one-rank process group
    (``distributed.is_initialized`` true, the all-reduce the identity, so
    ``global_sums`` concatenates and splits as with ranks) at shapes small
    enough for the caching allocator's small pool: the same bits as with no
    group (the reduced sums stay alive through the launches that read them),
    and against the plain versions under autograd on the same inputs: the
    output within one bf16 step of its magnitude, the running statistics and
    the gradients within 1e-4 and 1e-2 of their largest entry (the kernels'
    sums differ from torch's in rounding order)."""
    from bdvcil_torch.parallel import distributed

    alone = _bn_function_run(cuda, shape, sums, relu, plain=False)
    plain = _bn_function_run(cuda, shape, sums, relu, plain=True)
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed, "all_reduce_sum", lambda t: t)
    grouped = _bn_function_run(cuda, shape, sums, relu, plain=False)
    for a, b in zip(alone, grouped):
        assert torch.equal(a, b)
    for what, a, b, rtol in zip(("out", "dx", "dweight", "dbias", "running mean",
                                 "running var"), alone, plain, (2 ** -7, 1e-2, 1e-2, 1e-2,
                                                                1e-4, 1e-4)):
        err = float((a.float() - b.float()).abs().max())
        assert err <= rtol * float(b.float().abs().max()), f"{what}: off by {err}"


def test_batchnorm_kernels_refuse_what_they_do_not_take(cuda):
    """NCHW-contiguous memory and float16 raise; nothing runs."""
    bn = _bn_module(16, torch.bfloat16, cuda, 8)
    _build.LAUNCHES.clear()
    with pytest.raises(ValueError, match="rows of channels"):
        bn(_bn_input((4, 16, 5, 5), torch.bfloat16, cuda, 1, channels_last=False), True)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        bn(_bn_input((4, 16, 5, 5), torch.float16, cuda, 1), True)
    torch.cuda.synchronize()
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("depth,switches,module_bns,sums_bns", [
    (50, dict(shift_mode="pad", conv1x1_mode="pallas_stats"), 21, 32),
    (34, dict(shift_mode="fused_block", conv1x1_mode="xla"), 36, 0),
], ids=["R50 A", "R34 B"])
def test_batchnorm_launches_per_train_step(cuda, depth, switches, module_bns, sums_bns):
    """One train forward and backward of each cell's backbone (bf16, 2 clips x
    8 frames at 64²): every train-mode BatchNorm takes the kernels, R50 in
    configuration A 21 statistics launches and 53 of each other kernel, R34
    in configuration B 36 of each; an eval forward launches none."""
    from bdvcil_torch.models.resnet_tsm import ResNetTSM

    torch.manual_seed(0)
    model = ResNetTSM(depth=depth, num_segments=8, dtype=torch.bfloat16,
                      norm_dtype=torch.bfloat16, device=cuda, **switches)
    for p in model.parameters():
        if p.dim() == 4:
            torch.nn.init.normal_(p, std=p[0].numel() ** -0.5)
    x = torch.randn((16, 64, 64, 3), device=cuda)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    out = model(x, train=True)["out"]
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    bns = module_bns + sums_bns
    want = {name: bns for name in port_bn.KERNELS}
    want[port_bn.STATS] = module_bns
    assert {k: v for k, v in _build.LAUNCHES.items() if port_bn.is_launch(k)} == want
    _build.LAUNCHES.clear()
    with torch.no_grad():
        model(x, train=False)
    torch.cuda.synchronize()
    assert not any(port_bn.is_launch(k) for k, v in _build.LAUNCHES.items() if v)
