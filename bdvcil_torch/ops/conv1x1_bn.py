"""1x1 convolution (GEMM) with a BatchNorm-statistics epilogue.

Port of ``bdvcil_tpu/ops/conv1x1_bn.py``. The bottleneck's conv1/conv3 are
stride-1 1x1 convolutions, i.e. GEMMs over (M = N*T*H*W, K) x (K, N'). Their
outputs feed a train-mode BatchNorm, whose statistics would otherwise take a
second full read of the conv output. ``conv1x1_with_stats`` emits the
per-channel sum and sum of squares from the pass that produces the output,
computed on the ROUNDED bf16 output so they equal a reduction over the stored
tensor. ``gemm_with_stats`` is the same function on a 2-D (M, K) operand.

On a CUDA tensor the forward is a hand-written kernel, chosen by dtype
(``launch_name``), with or without the block's prologue relu(x * a + b):
bfloat16 runs ``csrc/conv1x1_stats.cu`` on the persistent wgmma core of
``csrc/gemm_stats_sm90.cuh`` (K and N not multiples of 8 are zero-padded
for the TMA, a and b with zeros: ``aligned_call``); float32 runs as three
TF32 products on the tensor cores in ``csrc/gemm_stats_tf32.cu``, the
prologue applied to A's fragments in registers (K and N zero-padded to
multiples of 4); float32 launches count under the wrapper's name +
``"_f32"``; any other dtype raises. On a CPU tensor it is
``gemm_stats_plain``; ``interpret=True`` names the plain version
on every device, the counterpart of JAX's Pallas interpreter
(``conv1x1_mode='pallas_stats_interpret'``). The backward is plain PyTorch on
both, as the JAX package leaves it to XLA: the cotangents of s1/s2, where
given, are folded into dy (``dy += gs1 + 2 * gs2 * y``), then the GEMM's own
backward. ``conv1x1_bn`` normalizes y through ``ops/batchnorm``: on a card
its Function's backward hands over the whole dy and no cotangent of s1/s2,
on the CPU (and with ``interpret``) autograd gives the cotangents to fold
(under a process group the kernel's s1, s2 and row count are all-reduced
first; the kernel itself sees only the rank's rows).
"""

from __future__ import annotations

import ctypes
import math
from functools import partial
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import annotate
from . import _build, batchnorm
from ._build import sm_count

KERNEL = "conv1x1_with_stats"
GEMM_KERNEL = "gemm_with_stats"
F32 = "_f32"  # the float32 kernel's launches count under the wrapper's name + F32
KERNEL_F32, GEMM_KERNEL_F32 = KERNEL + F32, GEMM_KERNEL + F32
EPS = 1e-5
# the TMA's 16-byte global strides in bf16 elements: K % 8 == 0 and N % 8 == 0
TMA_ALIGN = 8
# the same in f32 elements, for the 3xTF32 kernel: K % 4 == 0 and N % 4 == 0
F32_TMA_ALIGN = 4


def gemm_stats_plain(
    x: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y = x @ w over x's last dim in f32, rounded to x's dtype; stats over the
    rounded y. x (..., K), w (K, N) -> y (..., N), s1 (N,), s2 (N,)."""
    k, n = w.shape
    y = (x.reshape(-1, k).float() @ w.float()).to(x.dtype)
    yf = y.float()
    return y.reshape(*x.shape[:-1], n), yf.sum(0), (yf * yf).sum(0)


def _lib() -> ctypes.CDLL:
    lib = _build.library("conv1x1_stats")
    if not getattr(lib, "_bdv_typed", False):
        lib.bdv_conv1x1_with_stats.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.bdv_conv1x1_with_stats.restype = ctypes.c_int
        lib.bdv_conv1x1_affine_relu_stats.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.bdv_conv1x1_affine_relu_stats.restype = ctypes.c_int
        lib.bdv_wgmma_stats_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p]
        lib.bdv_wgmma_stats_plan.restype = ctypes.c_int
        lib._bdv_typed = True
    return lib


def _tf32_lib() -> ctypes.CDLL:
    lib = _build.library("gemm_stats_tf32")
    if not getattr(lib, "_bdv_typed", False):
        tail = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
        lib.bdv_gemm_stats_tf32.argtypes = [ctypes.c_void_p] * 5 + tail + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.bdv_gemm_affine_relu_stats_tf32.argtypes = [ctypes.c_void_p] * 6 + tail + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.bdv_conv3x3_affine_relu_stats_tf32.argtypes = [ctypes.c_void_p] * 6 + tail + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.bdv_gemm_stats_tf32_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_void_p]
        lib.bdv_conv3x3_stats_tf32_plan.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        for fn in (lib.bdv_gemm_stats_tf32, lib.bdv_gemm_affine_relu_stats_tf32,
                   lib.bdv_conv3x3_affine_relu_stats_tf32, lib.bdv_gemm_stats_tf32_plan,
                   lib.bdv_conv3x3_stats_tf32_plan):
            fn.restype = ctypes.c_int
        lib._bdv_typed = True
    return lib


def stats_scratch(part_shape, n: int, device):
    """The partials scratch and the (2, N) statistics, in one f32 allocation."""
    size = math.prod(part_shape)
    buf = torch.empty(size + 2 * n, dtype=torch.float32, device=device)
    return buf[:size].view(part_shape), buf[size:].view(2, n)


def check_affine(name: str, k: int, a: torch.Tensor, b: torch.Tensor, device) -> None:
    """The prologue's (a, b), or any two per-channel operands: contiguous f32
    (K,) vectors on the operand's device."""
    for v in (a, b):
        if v.shape != (k,) or v.dtype != torch.float32 or v.device != device:
            raise ValueError(f"{name}: vectors must be ({k},) float32 on {device}, got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name}: vectors must be contiguous")


def launch_name(name: str, x_dtype: torch.dtype, w_dtype: torch.dtype) -> str:
    """The launch count a GEMM-with-statistics call adds to: ``name`` for
    bfloat16 (the wgmma core), ``name + F32`` for float32 (the 3xTF32 kernel).
    Any other dtype, or two dtypes, raise TypeError: no configuration of the
    JAX package computes in float16 (its trainer maps only float32 and
    bfloat16, ``cil/trainer.py:78``)."""
    if x_dtype != w_dtype or x_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the kernels take float32 or bfloat16 operands of one dtype, "
                        f"got {x_dtype} x {w_dtype}")
    return name + F32 if x_dtype == torch.float32 else name


def aligned_call(fwd, x: torch.Tensor, w: torch.Tensor, a: Optional[torch.Tensor] = None,
                 b: Optional[torch.Tensor] = None, align: int = TMA_ALIGN):
    """``fwd(x, w)``, or with a prologue ``fwd(x, w, a, b)``, on x (..., K) and w
    (..., K, N) (a 1x1's (K, N), or a 3x3's (3, 3, K, N): each tap's rows)
    zero-padded to K and N multiples of ``align``, a and b (K,) with zeros,
    with y and the statistics cut back to N columns. x's zero channels stay
    zero through the prologue (relu(0 * 0 + 0)) and meet w's zero rows, and
    w's zero columns give zero columns of y: neither changes y or the
    statistics."""
    k, n = w.shape[-2:]
    pad_k, pad_n = -k % align, -n % align
    affine = () if a is None else (a, b)
    if not (pad_k or pad_n):
        return fwd(x, w, *affine)
    if pad_k:
        x = F.pad(x, (0, pad_k))
        affine = tuple(F.pad(v, (0, pad_k)) for v in affine)
    y, s1, s2 = fwd(x, F.pad(w, (0, pad_n, 0, pad_k)), *affine)
    return y[..., :n].contiguous(), s1[:n], s2[:n]


def _wgmma_stats(name: str, x: torch.Tensor, w: torch.Tensor,
                 a: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None):
    """The bf16 wgmma core on x (..., K) and w (K, N), K and N % 8 == 0; with
    (a, b), on bf16(relu(x * a + b))."""
    lib = _lib()
    k, n = w.shape
    m = x.numel() // k
    y = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    part_rows = sm_count(x.device)  # one partial per persistent CTA, at most one CTA per SM
    part, stats = stats_scratch((2, part_rows, n), n, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if a is None:
        code = lib.bdv_conv1x1_with_stats(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(), part_rows,
            stats.data_ptr(), m, k, n, stream,
        )
    else:
        code = lib.bdv_conv1x1_affine_relu_stats(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
            part.data_ptr(), part_rows, stats.data_ptr(), m, k, n, stream,
        )
    _build.check(lib, code, name)
    return y, stats[0], stats[1]


def aligned_x(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it where it is not 16-byte aligned (a view at an odd
    offset), for the 3xTF32 kernel's TMA."""
    return x.clone() if x.data_ptr() % 16 else x


def _tf32_stats(name: str, x: torch.Tensor, w: torch.Tensor,
                a: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None):
    """The float32 GEMM as three TF32 products on x (..., K) and w (K, N), K
    and N % 4 == 0: the kernel splits w into its (2, N, K) scratch first; with
    (a, b), on relu(x * a + b), a and b passed as one (2, K) operand."""
    lib = _tf32_lib()
    k, n = w.shape
    m = x.numel() // k
    x = aligned_x(x)
    y = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    part_rows = sm_count(x.device)  # one partial per persistent CTA, at most one CTA per SM
    part, stats = stats_scratch((2, part_rows, n), n, x.device)
    wsplit = torch.empty((2, n, k), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if a is None:
        code = lib.bdv_gemm_stats_tf32(
            x.data_ptr(), w.data_ptr(), wsplit.data_ptr(), y.data_ptr(), part.data_ptr(),
            part_rows, stats.data_ptr(), m, k, n, stream)
    else:
        ab = torch.stack((a, b))
        code = lib.bdv_gemm_affine_relu_stats_tf32(
            x.data_ptr(), w.data_ptr(), ab.data_ptr(), wsplit.data_ptr(), y.data_ptr(),
            part.data_ptr(), part_rows, stats.data_ptr(), m, k, n, stream)
    _build.check(lib, code, name + F32)
    return y, stats[0], stats[1]


def gemm_stats_cuda(name: str, x: torch.Tensor, w: torch.Tensor,
                    a: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None):
    """Launch the GEMM-with-statistics kernel of x's dtype on the rows of x
    (..., K) and w (K, N): float32 on the 3xTF32 kernel, bfloat16 on the wgmma
    core; with (a, b), on the rows of relu(x * a + b) in x's dtype. Counts
    one launch under ``launch_name``. Returns y (..., N), s1 (N,), s2 (N,)."""
    if x.dim() < 2 or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} x {tuple(w.shape)}")
    counter = launch_name(name, x.dtype, w.dtype)
    if w.device != x.device:
        raise ValueError(f"{name}: operands on {x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous (row-major x, (K, N) w)")
    if a is not None:
        check_affine(name, w.shape[0], a, b, x.device)
    if x.dtype == torch.float32:
        out = aligned_call(partial(_tf32_stats, name), x, w, a, b, align=F32_TMA_ALIGN)
    else:
        out = aligned_call(partial(_wgmma_stats, name), x, w, a, b)
    _build.LAUNCHES[counter] += 1
    return out


def conv1x1_with_stats_fwd(x4: torch.Tensor, w: torch.Tensor):
    """The forward: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if x4.dim() != 4:
        raise ValueError(f"{KERNEL}: x must be (N*T, H, W, K), got {tuple(x4.shape)}")
    return _build.dispatch(KERNEL, x4, partial(gemm_stats_cuda, KERNEL), gemm_stats_plain, x4, w)


def gemm_with_stats_fwd(x: torch.Tensor, w: torch.Tensor):
    """``gemm_with_stats``'s forward on (M, K) x (K, N)."""
    if x.dim() != 2:
        raise ValueError(f"{GEMM_KERNEL}: x must be (M, K), got {tuple(x.shape)}")
    return _build.dispatch(GEMM_KERNEL, x, partial(gemm_stats_cuda, GEMM_KERNEL),
                           gemm_stats_plain, x, w)


class _GemmWithStats(torch.autograd.Function):
    """(y, sum(y), sum(y^2)) of a GEMM over x's rows; ``fwd`` is the forward."""

    @staticmethod
    def forward(ctx, x, w, fwd):
        y, s1, s2 = fwd(x, w)
        ctx.save_for_backward(x, w, y)
        ctx.set_materialize_grads(False)  # no zero cotangents of unused outputs
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, w, y = ctx.saved_tensors
        k, n = w.shape
        # d/dy of (y, sum(y), sum(y^2)) contracted with the cotangents; with
        # none for the sums (conv1x1_bn's normalize hands over the whole dy) gy
        dy = gy
        if gs1 is not None or gs2 is not None:
            dy = gy.float() if gy is not None else torch.zeros_like(y, dtype=torch.float32)
            if gs1 is not None:
                dy = dy + gs1
            if gs2 is not None:
                dy = dy + 2.0 * gs2 * y.float()
        dy = dy.to(x.dtype).reshape(-1, n)
        dx = (dy @ w.t()).reshape(x.shape)
        dw = x.reshape(-1, k).t() @ dy
        return dx, dw, None


def conv1x1_with_stats(x4: torch.Tensor, w: torch.Tensor, interpret: bool = False):
    """y = 1x1-conv(x4, w) (NHWC, f32 accumulate) + per-channel sum(y) and
    sum(y^2) in f32, one pass. x4 (N*T, H, W, K), w (K, N). ``interpret``
    names the plain version as the forward on every device (JAX's Pallas
    interpreter); the backward is the same either way."""
    return _GemmWithStats.apply(x4, w, gemm_stats_plain if interpret else conv1x1_with_stats_fwd)


def gemm_with_stats(x: torch.Tensor, w: torch.Tensor):
    """y = x @ w (f32 accumulate, rounded to x's dtype) plus per-column sum(y)
    and sum(y*y) in f32, in one pass over the output. x (M, K), w (K, N).

    The JAX version pads M to its tile; the kernel masks the ragged edge, and y
    is (M, N) either way. The VJP is JAX's ``_bwd``."""
    return _GemmWithStats.apply(x, w, gemm_with_stats_fwd)


def conv1x1_bn(
    x: torch.Tensor,
    conv_weight: torch.Tensor,
    bn,
    train: bool,
    dtype: torch.dtype,
    norm_dtype: torch.dtype,
    interpret: bool = False,
    relu: bool = False,
) -> torch.Tensor:
    """``conv(1x1) -> BatchNorm`` (``-> relu`` with ``relu``) on an NHWC
    tensor, with the statistics from the GEMM's epilogue in train mode.

    x: (N*T, H, W, K); conv_weight: the conv's (N, K, 1, 1) OIHW parameter;
    ``bn``: the BatchNorm module that owns the affine and running statistics.
    Train mode normalizes through ``ops/batchnorm.normalize_from_sums`` (the
    running statistics updated with the flax momentum; under a process group
    the sums and the row count all-reduced first); with ``interpret`` the GEMM
    is ``gemm_stats_plain`` and the normalize its plain version on every
    device (``conv1x1_mode='pallas_stats_interpret'``). Eval mode uses the
    plain 1x1 conv and the running statistics. Returns (N*T, H, W, N) in
    ``norm_dtype``.
    """
    nt, h, w_, k = x.shape
    features = conv_weight.shape[0]
    x4 = x.to(dtype).contiguous()
    wmat = conv_weight.reshape(features, k).t().to(dtype).contiguous()
    if train:
        y, s1, s2 = conv1x1_with_stats(x4, wmat, interpret)
        with annotate("model.bn"):  # BatchNorm's half: the statistics to the normalize
            return batchnorm.normalize_from_sums(y, s1, s2, bn, float(nt * h * w_), EPS,
                                                 norm_dtype, relu, plain=interpret)
    y = x4 @ wmat
    inv = bn.weight / torch.sqrt(bn.running_var + EPS)
    shift = bn.bias - bn.running_mean * inv
    out = y.to(norm_dtype) * inv.to(norm_dtype) + shift.to(norm_dtype)
    return F.relu(out) if relu else out
