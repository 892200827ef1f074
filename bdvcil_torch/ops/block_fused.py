"""Whole-block fused bottleneck forward.

Port of ``bdvcil_tpu/ops/block_fused.py``: a training-mode (batch-statistics)
ResNet bottleneck, NHWC, stride 1, as three fused kernels and one elementwise
pass (layer1 geometry: 56x56, 256 -> 64 -> 64 -> 256):

  y1 = conv1x1(x)                 + BN1 statistics      conv1x1_stats
  y2 = conv3x3(relu(bn1(y1)))     + BN2 statistics      conv3x3_affine_relu_stats
  y3 = conv1x1(relu(bn2(y2)))     + BN3 statistics      conv1x1_affine_relu_stats
  out = relu(bn3(y3) + x)         one elementwise pass  affine_residual_relu

Each kernel reads its input activation once (the previous BatchNorm's
normalize and relu run as a prologue on the tile already loaded) and writes
its output once (the per-channel sum and sum of squares come out of the
epilogue). Between kernels ``bn_finalize`` turns each BatchNorm's statistics
into its affine (a, b) and its (mean, var), (C,)-sized math: seven launches
a block in all.

On a CUDA tensor each op is its hand-written kernel, chosen by the
operands' dtype as the JAX ops take any (``conv1x1_bn.launch_name``: float32
launches count under the op's name + ``"_f32"``, float16 raises, as no
configuration of the JAX package computes in it):

  op                          bfloat16                    float32
  conv1x1_stats               csrc/conv1x1_stats.cu       csrc/gemm_stats_tf32.cu
  conv1x1_affine_relu_stats   csrc/conv1x1_stats.cu       csrc/gemm_stats_tf32.cu
  conv3x3_affine_relu_stats   csrc/conv3x3_stats.cu       csrc/gemm_stats_tf32.cu
  bn_finalize                 csrc/block_epilogue.cu (f32 statistics either way)
  affine_residual_relu        csrc/block_epilogue.cu, 16-byte packs of 8 bf16 or 4 f32,
                              any C

The bf16 stats kernels run on the persistent wgmma core of
``csrc/gemm_stats_sm90.cuh``, which applies the prologue to the A tile in
shared memory; channel counts that are not multiples of 8 are zero-padded
for the TMA (a = b = 0 on the padded channels: ``conv1x1_bn.aligned_call``),
and the 3x3 takes any W < 65536 (its window of x in boxes, or three bands
of 136 rows where wide: ``gemm_plan.window_plan``). The float32 stats ops
run as three TF32 products on the tensor cores (``csrc/gemm_stats_tf32.cu``),
conv3 with the prologue applied to A's fragments in registers, the 3x3 as an
implicit im2col from a window of x that the prologue has been applied to
once, at any W < 65536 too (channel counts zero-padded to multiples of 4, as
for the float32 conv1).
Each 3x3 kernel serves both of the JAX package's
variant names ("taps", "im2col": one function, two ways of tiling the TPU's
matrix unit). On a CPU tensor each op is its ``_plain`` version; the plain
3x3 mirrors each variant's summation (nine f32 tap products accumulated in
order, or one K=9C product). ``bn_finalize`` and ``affine_residual_relu``
are bit for bit against their plain versions, the eager expressions they
replace.

Forward-only, as the JAX ops are (they have no VJP): the ops raise if an input
requires grad rather than letting autograd reach the plain versions.
``plain_bottleneck_fwd`` is the counterpart of ``xla_bottleneck_fwd``: the
same block with library convolutions and eager BatchNorm.
"""

from __future__ import annotations

import ctypes
import math
from functools import partial
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import _device
from . import _build
from . import gemm_plan
from .conv1x1_bn import (F32, F32_TMA_ALIGN, _tf32_lib, aligned_call, aligned_x, check_affine,
                         gemm_stats_cuda, gemm_stats_plain, launch_name, sm_count, stats_scratch)

CONV1 = "block_conv1x1_stats"
CONV2 = "conv3x3_affine_relu_stats"
CONV3 = "conv1x1_affine_relu_stats"
FINALIZE = "block_bn_finalize"
EPILOGUE = "block_affine_residual_relu"
VARIANTS = ("taps", "im2col")
# the float32 kernels' launch counts
CONV1_F32, CONV2_F32, CONV3_F32, EPILOGUE_F32 = (CONV1 + F32, CONV2 + F32, CONV3 + F32,
                                                 EPILOGUE + F32)


class BlockParams(NamedTuple):
    """Bottleneck parameters; conv weights HWIO (the kernels read them K-major)."""

    w1: torch.Tensor  # (C, Cm) or (1, 1, C, Cm)
    g1: torch.Tensor  # (Cm,) BN scale
    b1: torch.Tensor  # (Cm,) BN bias
    w2: torch.Tensor  # (3, 3, Cm, Cm)
    g2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor  # (Cm, C) or (1, 1, Cm, C)
    g3: torch.Tensor  # (C,)
    b3: torch.Tensor


def _lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """``jax.nn.initializers.lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1/fan_in."""
    t = torch.empty(shape, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)


def make_params(generator: Optional[torch.Generator] = None, c: int = 256, cm: int = 64,
                dtype: torch.dtype = torch.bfloat16, device=None) -> BlockParams:
    """Random block parameters as the JAX ``make_params`` draws them (lecun-normal
    convs in ``dtype``, BN scale |N| + 0.5, bias 0.1 N, in f32). The values
    come from ``generator`` and differ from JAX's; on the card unless
    ``device`` says otherwise."""
    device = _device.resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def normal(n):
        return torch.randn((n,), generator=gen, device=gen.device)

    p = BlockParams(
        w1=_lecun_normal((c, cm), c, gen).to(dtype),
        g1=normal(cm).abs() + 0.5,
        b1=normal(cm) * 0.1,
        w2=_lecun_normal((3, 3, cm, cm), 9 * cm, gen).to(dtype),
        g2=normal(cm).abs() + 0.5,
        b2=normal(cm) * 0.1,
        w3=_lecun_normal((cm, c), cm, gen).to(dtype),
        g3=normal(c).abs() + 0.5,
        b3=normal(c) * 0.1,
    )
    return BlockParams(*(t.to(device) for t in p))


# --- plain versions -----------------------------------------------------------


def affine_relu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x.dtype(relu(f32(x) * a + b)): a product and a sum, each rounded to f32."""
    return torch.relu(x.float() * a + b).to(x.dtype)


def bn_finalize_plain(s, q, gamma, beta, count, eps):
    """Batch statistics -> (4, C) f32 rows: the normalize affine a = gamma /
    sqrt(var + eps), b = beta - mean * a, then mean and var."""
    mean = s / count
    var = q / count - mean * mean
    inv = gamma / torch.sqrt(var + eps)
    return torch.stack((inv, beta - mean * inv, mean, var))


def affine_residual_relu_plain(y, a, b, x):
    """x.dtype(relu(f32(y) * a + b + f32(x))): the block's last pass, each
    operation rounded to f32 in that order."""
    return torch.relu(y.float() * a + b + x.float()).to(x.dtype)


def conv1x1_affine_relu_stats_plain(x, a, b, w):
    return gemm_stats_plain(affine_relu(x, a, b), w)


def conv3x3_affine_relu_stats_plain(x, a, b, w, variant: str = "taps"):
    """conv3x3(pad(relu(x * a + b)), w) 'SAME' + stats; the halo is padded
    after the prologue, so it is zero."""
    nt, h, w_, k = x.shape
    n = w.shape[-1]
    xp = F.pad(affine_relu(x, a, b), (0, 0, 1, 1, 1, 1))
    taps = [xp[:, dy:dy + h, dx:dx + w_, :].reshape(-1, k) for dy in range(3) for dx in range(3)]
    if variant == "taps":
        acc = torch.zeros((nt * h * w_, n), dtype=torch.float32, device=x.device)
        for i, tap in enumerate(taps):
            acc = acc + tap.float() @ w[i // 3, i % 3].float()
    else:
        acc = torch.cat(taps, dim=-1).float() @ w.reshape(9 * k, n).float()
    y = acc.to(x.dtype)
    yf = y.float()
    return y.reshape(nt, h, w_, n), yf.sum(0), (yf * yf).sum(0)


# --- kernels ------------------------------------------------------------------


def _conv3x3_lib() -> ctypes.CDLL:
    lib = _build.library("conv3x3_stats")
    if not getattr(lib, "_bdv_typed", False):
        lib.bdv_conv3x3_affine_relu_stats.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.bdv_conv3x3_affine_relu_stats.restype = ctypes.c_int
        lib.bdv_conv3x3_stats_plan.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.bdv_conv3x3_stats_plan.restype = ctypes.c_int
        lib._bdv_typed = True
    return lib


def _conv1x1_affine_cuda(x, a, b, w):
    return gemm_stats_cuda(CONV3, x, w, a, b)


def _conv3x3_wgmma(x, w, a, b):
    """The bf16 3x3 on the wgmma core: Cin and Cout % 8 == 0, any W < 65536
    (the window in three bands where it is wide)."""
    nt, h, w_, k = x.shape
    n = w.shape[-1]
    _check_3x3_extent(CONV2, h, w_)
    part_rows = sm_count(x.device)  # one partial per persistent CTA, one CTA per SM at most
    lib = _conv3x3_lib()
    y = torch.empty((nt, h, w_, n), dtype=x.dtype, device=x.device)
    part, stats = stats_scratch((2, part_rows, n), n, x.device)
    code = lib.bdv_conv3x3_affine_relu_stats(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), part.data_ptr(),
        part_rows, stats.data_ptr(), nt, h, w_, k, n,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, CONV2)
    return y, stats[0], stats[1]


def _conv3x3_f32(x, w, a, b):
    """The float32 3x3 as three TF32 products: Cin and Cout % 4 == 0, any W
    < 65536 (the window in three bands where it is wide). w is split into a
    (2, Cout, 9, Cin rounded up to 32) scratch; a and b go as one (2, Cin)
    operand."""
    nt, h, w_, k = x.shape
    n = w.shape[-1]
    _check_3x3_extent(CONV2_F32, h, w_)
    lib = _tf32_lib()
    x = aligned_x(x)
    y = torch.empty((nt, h, w_, n), dtype=x.dtype, device=x.device)
    part_rows = sm_count(x.device)  # one partial per persistent CTA, at most one CTA per SM
    part, stats = stats_scratch((2, part_rows, n), n, x.device)
    c_pad = -(-k // gemm_plan.TF32_BLOCK_K) * gemm_plan.TF32_BLOCK_K
    wsplit = torch.empty((2, n, 9 * c_pad), dtype=torch.float32, device=x.device)
    ab = torch.stack((a, b))
    code = lib.bdv_conv3x3_affine_relu_stats_tf32(
        x.data_ptr(), w.data_ptr(), ab.data_ptr(), wsplit.data_ptr(), y.data_ptr(),
        part.data_ptr(), part_rows, stats.data_ptr(), nt, h, w_, k, n,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, CONV2_F32)
    return y, stats[0], stats[1]


def _check_3x3_extent(name, h, w_):
    """Both 3x3 kernels pack a pixel's (h, w) into one int (``pixel_of``)."""
    if h >= 1 << 15 or w_ >= 1 << 16:
        raise ValueError(f"{name}: needs H < 32768 and W < 65536, got H={h} W={w_}")


def _conv3x3_cuda(x, a, b, w, variant):
    del variant  # one kernel serves both variants
    if x.dim() != 4 or w.shape[:2] != (3, 3) or w.dim() != 4 or w.shape[2] != x.shape[-1]:
        raise ValueError(f"{CONV2}: shapes {tuple(x.shape)} x {tuple(w.shape)}")
    counter = launch_name(CONV2, x.dtype, w.dtype)
    if w.device != x.device:
        raise ValueError(f"{CONV2}: operands on {x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{CONV2}: operands must be contiguous (NHWC x, HWIO w)")
    check_affine(CONV2, x.shape[-1], a, b, x.device)
    if x.dtype == torch.float32:
        out = aligned_call(_conv3x3_f32, x, w, a, b, align=F32_TMA_ALIGN)
    else:
        out = aligned_call(_conv3x3_wgmma, x, w, a, b)
    _build.LAUNCHES[counter] += 1
    return out


def _epilogue_lib() -> ctypes.CDLL:
    lib = _build.library("block_epilogue")
    if not getattr(lib, "_bdv_typed", False):
        lib.bdv_bn_finalize.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        lib.bdv_affine_residual_relu.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.bdv_bn_finalize, lib.bdv_affine_residual_relu):
            fn.restype = ctypes.c_int
        lib._bdv_typed = True
    return lib


def _bn_finalize_cuda(s, q, gamma, beta, count, eps):
    c = s.numel()
    check_affine(FINALIZE, c, s, q, s.device)
    check_affine(FINALIZE, c, gamma, beta, s.device)
    out = torch.empty((4, c), dtype=torch.float32, device=s.device)
    lib = _epilogue_lib()
    code = lib.bdv_bn_finalize(s.data_ptr(), q.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                               out.data_ptr(), c, count, eps,
                               torch.cuda.current_stream(s.device).cuda_stream)
    _build.check(lib, code, FINALIZE)
    _build.LAUNCHES[FINALIZE] += 1
    return out


def _affine_residual_relu_cuda(y, a, b, x):
    counter = launch_name(EPILOGUE, y.dtype, x.dtype)
    if y.shape != x.shape or y.dim() == 0:
        raise ValueError(f"{EPILOGUE}: shapes {tuple(y.shape)} + {tuple(x.shape)}")
    if x.device != y.device:
        raise ValueError(f"{EPILOGUE}: operands on {y.device} and {x.device}")
    if not (y.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{EPILOGUE}: operands must be contiguous (NHWC)")
    c = y.shape[-1]
    check_affine(EPILOGUE, c, a, b, y.device)
    lib = _epilogue_lib()
    out = torch.empty_like(y)
    code = lib.bdv_affine_residual_relu(
        y.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), y.numel(), c,
        y.element_size(), sm_count(y.device), torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, code, counter)
    _build.LAUNCHES[counter] += 1
    return out


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward-only (the JAX op has no VJP): an input "
                           "requires grad")


def conv1x1_stats(x: torch.Tensor, w: torch.Tensor):
    """y = x @ w over x's channels (NHWC, f32 accumulate, rounded to x's
    dtype) + per-channel sum(y) and sum(y^2) of the rounded y. x (NT, H, W,
    K), w (K, N)."""
    _forward_only(CONV1, x, w)
    return _build.dispatch(CONV1, x, partial(gemm_stats_cuda, CONV1), gemm_stats_plain, x, w)


def conv1x1_affine_relu_stats(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                              w: torch.Tensor):
    """y = x.dtype(relu(x * a + b)) @ w + stats; a, b (K,) (cast to f32)."""
    k = x.shape[-1]
    a, b = a.reshape(k).float(), b.reshape(k).float()
    _forward_only(CONV3, x, a, b, w)
    return _build.dispatch(CONV3, x, _conv1x1_affine_cuda, conv1x1_affine_relu_stats_plain,
                           x, a, b, w)


def conv3x3_affine_relu_stats(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                              w: torch.Tensor, variant: str = "taps"):
    """y = conv3x3(relu(x * a + b), w), stride 1, 'SAME', + stats.
    x (NT, H, W, Cin), w (3, 3, Cin, Cout) HWIO, a, b (Cin,)."""
    if variant not in VARIANTS:
        raise ValueError(f"{CONV2}: variant must be one of {VARIANTS}, got {variant!r}")
    k = x.shape[-1]
    a, b = a.reshape(k).float(), b.reshape(k).float()
    _forward_only(CONV2, x, a, b, w)
    return _build.dispatch(CONV2, x, _conv3x3_cuda, conv3x3_affine_relu_stats_plain,
                           x, a, b, w, variant)


def bn_finalize(s: torch.Tensor, q: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                count: float, eps: float) -> torch.Tensor:
    """One BatchNorm's batch statistics (sum s and sum of squares q over
    ``count`` rows) -> (4, C) f32: rows a, b (the normalize affine), mean,
    var. All inputs f32 (C,)."""
    _forward_only(FINALIZE, s, q, gamma, beta)
    return _build.dispatch(FINALIZE, s, _bn_finalize_cuda, bn_finalize_plain,
                           s, q, gamma, beta, count, eps)


def affine_residual_relu(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """x.dtype(relu(f32(y) * a + b + f32(x))) over NHWC y and x of one dtype
    (bf16 or f32), with a, b f32 (C,) per channel: the block's last pass."""
    _forward_only(EPILOGUE, y, a, b, x)
    return _build.dispatch(EPILOGUE, y, _affine_residual_relu_cuda, affine_residual_relu_plain,
                           y, a, b, x)


# --- the block ----------------------------------------------------------------


def _bottleneck(x, p: BlockParams, eps, conv1, conv2, conv3, finalize, epilogue):
    nt, h, w_, c = x.shape
    w1 = p.w1.reshape(c, -1).to(x.dtype).contiguous()
    w3 = p.w3.reshape(p.w3.shape[-2], p.w3.shape[-1]).to(x.dtype).contiguous()
    w2 = p.w2.to(x.dtype).contiguous()
    cnt = float(nt * h * w_)

    y1, s1, q1 = conv1(x, w1)
    f1 = finalize(s1, q1, p.g1, p.b1, cnt, eps)
    y2, s2, q2 = conv2(y1, f1[0], f1[1], w2)
    f2 = finalize(s2, q2, p.g2, p.b2, cnt, eps)
    y3, s3, q3 = conv3(y2, f2[0], f2[1], w3)
    f3 = finalize(s3, q3, p.g3, p.b3, cnt, eps)
    out = epilogue(y3, f3[0], f3[1], x)
    return out, tuple((f[2], f[3]) for f in (f1, f2, f3))


def fused_bottleneck_fwd(x: torch.Tensor, p: BlockParams, eps: float = 1e-5,
                         conv3x3_variant: str = "taps"):
    """Training-mode bottleneck forward as three fused stats kernels, three
    BatchNorm finalizes and one elementwise pass. x (NT, H, W, C) NHWC,
    contiguous. Returns (out, ((mean, var) per BN)): the statistics a full
    integration would feed the running averages."""
    conv2 = partial(conv3x3_affine_relu_stats, variant=conv3x3_variant)
    return _bottleneck(x.contiguous(), p, eps, conv1x1_stats, conv2, conv1x1_affine_relu_stats,
                       bn_finalize, affine_residual_relu)


def fused_bottleneck_fwd_plain(x: torch.Tensor, p: BlockParams, eps: float = 1e-5,
                               conv3x3_variant: str = "taps"):
    """``fused_bottleneck_fwd`` over the ops' plain versions, on any device."""
    conv2 = partial(conv3x3_affine_relu_stats_plain, variant=conv3x3_variant)
    return _bottleneck(x.contiguous(), p, eps, gemm_stats_plain, conv2,
                       conv1x1_affine_relu_stats_plain, bn_finalize_plain,
                       affine_residual_relu_plain)


def plain_bottleneck_fwd(x: torch.Tensor, p: BlockParams, eps: float = 1e-5):
    """The same block with library convolutions (``F.conv2d``) and eager
    BatchNorm: the counterpart of ``xla_bottleneck_fwd`` (f32 statistics,
    normalize in f32 rounded to the activation dtype)."""

    def conv(xv, w):  # NHWC x HWIO -> NHWC (a channels_last view)
        wt = w.to(xv.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(xv.permute(0, 3, 1, 2), wt, padding=1 if w.shape[0] == 3 else 0)
        return y.permute(0, 2, 3, 1)

    def bn(y, g, b):
        yf = y.float()
        m = yf.mean((0, 1, 2))
        v = (yf * yf).mean((0, 1, 2)) - m * m
        inv = g / torch.sqrt(v + eps)
        return (yf * inv + (b - m * inv)).to(y.dtype), (m, v)

    c = x.shape[-1]
    w1 = p.w1.reshape(1, 1, c, -1)
    w3 = p.w3.reshape(1, 1, p.w3.shape[-2], p.w3.shape[-1])
    y1, mv1 = bn(conv(x, w1), p.g1, p.b1)
    y2, mv2 = bn(conv(torch.relu(y1), p.w2), p.g2, p.b2)
    y3, mv3 = bn(conv(torch.relu(y2), w3), p.g3, p.b3)
    out = torch.relu(y3.float() + x.float()).to(x.dtype)
    return out, (mv1, mv2, mv3)
