"""1x1 convolution (GEMM) with a BatchNorm-statistics epilogue.

Port of ``bdvcil_tpu/ops/conv1x1_bn.py``. The bottleneck's conv1/conv3 are
stride-1 1x1 convolutions, i.e. GEMMs over (M = N*T*H*W, K) x (K, N'). Their
outputs feed a train-mode BatchNorm, whose statistics would otherwise take a
second full read of the conv output. ``conv1x1_with_stats`` emits the
per-channel sum and sum of squares from the pass that produces the output,
computed on the ROUNDED bf16 output so they equal a reduction over the stored
tensor.

On a CUDA tensor the forward is the hand-written kernel of
``csrc/conv1x1_stats.cu``; on a CPU tensor it is
``conv1x1_with_stats_plain``. The backward is plain PyTorch on both, as the
JAX package leaves it to XLA: the cotangents of s1/s2 are folded into dy
(``dy += gs1 + 2 * gs2 * y``), then the GEMM's own backward.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

KERNEL = "conv1x1_with_stats"
EPS = 1e-5


def conv1x1_with_stats_plain(
    x4: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y = x4 @ w in f32, rounded to the input dtype; stats over the rounded y."""
    nt, h, w_, k = x4.shape
    n = w.shape[-1]
    y = (x4.reshape(-1, k).float() @ w.float()).to(x4.dtype)
    yf = y.float()
    return y.reshape(nt, h, w_, n), yf.sum(0), (yf * yf).sum(0)


def _lib() -> ctypes.CDLL:
    lib = _build.library("conv1x1_stats")
    if not getattr(lib, "_bdv_typed", False):
        lib.bdv_conv1x1_with_stats.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.bdv_conv1x1_with_stats.restype = ctypes.c_int
        for fn in (lib.bdv_conv1x1_stats_block_m, lib.bdv_conv1x1_stats_block_n,
                   lib.bdv_conv1x1_stats_block_k):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib._bdv_typed = True
    return lib


def _conv1x1_with_stats_cuda(x4: torch.Tensor, w: torch.Tensor):
    if x4.dim() != 4 or w.dim() != 2 or x4.shape[-1] != w.shape[0]:
        raise ValueError(f"{KERNEL}: shapes {tuple(x4.shape)} x {tuple(w.shape)}")
    if x4.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{KERNEL}: the kernel takes bfloat16, got {x4.dtype} x {w.dtype}")
    if w.device != x4.device:
        raise ValueError(f"{KERNEL}: operands on {x4.device} and {w.device}")
    if not (x4.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{KERNEL}: operands must be contiguous (NHWC x4, (K, N) w)")
    lib = _lib()
    nt, h, w_, k = x4.shape
    n = w.shape[1]
    bm, bn, bk = (lib.bdv_conv1x1_stats_block_m(), lib.bdv_conv1x1_stats_block_n(),
                  lib.bdv_conv1x1_stats_block_k())
    if k % bk or n % bn:
        raise ValueError(f"{KERNEL}: needs K % {bk} == 0 and N % {bn} == 0, got K={k} N={n}")
    m = nt * h * w_
    y = torch.empty((nt, h, w_, n), dtype=x4.dtype, device=x4.device)
    part = torch.empty((2, -(-m // bm), n), dtype=torch.float32, device=x4.device)
    stats = torch.empty((2, n), dtype=torch.float32, device=x4.device)
    stream = torch.cuda.current_stream(x4.device).cuda_stream
    code = lib.bdv_conv1x1_with_stats(
        x4.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(), stats.data_ptr(),
        m, k, n, stream,
    )
    _build.check(lib, code, KERNEL)
    _build.LAUNCHES[KERNEL] += 1
    return y, stats[0], stats[1]


def conv1x1_with_stats_fwd(x4: torch.Tensor, w: torch.Tensor):
    """The forward: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if x4.is_cuda:
        return _conv1x1_with_stats_cuda(x4, w)
    if x4.device.type == "cpu":
        return conv1x1_with_stats_plain(x4, w)
    raise NotImplementedError(f"no {KERNEL} for device {x4.device}")


class _Conv1x1WithStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x4, w):
        y, s1, s2 = conv1x1_with_stats_fwd(x4, w)
        ctx.save_for_backward(x4, w, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x4, w, y = ctx.saved_tensors
        k, n = w.shape
        # d/dy of (y, sum(y), sum(y^2)) contracted with the cotangents
        dy = gy.float()
        if gs1 is not None:
            dy = dy + gs1
        if gs2 is not None:
            dy = dy + 2.0 * gs2 * y.float()
        dy = dy.to(x4.dtype).reshape(-1, n)
        dx = (dy @ w.t()).reshape(x4.shape)
        dw = x4.reshape(-1, k).t() @ dy
        return dx, dw


def conv1x1_with_stats(x4: torch.Tensor, w: torch.Tensor):
    """y = 1x1-conv(x4, w) (NHWC, f32 accumulate) + per-channel sum(y) and
    sum(y^2) in f32, one pass. x4 (N*T, H, W, K), w (K, N)."""
    return _Conv1x1WithStats.apply(x4, w)


def bn_affine_from_sums(
    bn, s1: Optional[torch.Tensor], s2: Optional[torch.Tensor], count: float, train: bool
):
    """``_BNStats``: turn kernel-emitted sums into (scale, bias, mean, var).

    ``bn`` owns ``weight``/``bias`` and the running statistics (the flax
    BatchNorm layout); in train mode the running statistics are updated with
    the flax momentum convention.
    """
    if not train:
        return bn.weight, bn.bias, bn.running_mean, bn.running_var
    mean = s1 / count
    var = s2 / count - mean * mean
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
    return bn.weight, bn.bias, mean, var


def conv1x1_bn(
    x: torch.Tensor,
    conv_weight: torch.Tensor,
    bn,
    train: bool,
    dtype: torch.dtype,
    norm_dtype: torch.dtype,
) -> torch.Tensor:
    """``conv(1x1) -> BatchNorm`` on an NHWC tensor, with the statistics from
    the GEMM's epilogue in train mode.

    x: (N*T, H, W, K); conv_weight: the conv's (N, K, 1, 1) OIHW parameter;
    ``bn``: the BatchNorm module that owns the affine and running statistics.
    Eval mode uses the plain 1x1 conv and the running statistics. Returns
    (N*T, H, W, N) in ``norm_dtype``.
    """
    nt, h, w_, k = x.shape
    features = conv_weight.shape[0]
    x4 = x.to(dtype).contiguous()
    wmat = conv_weight.reshape(features, k).t().to(dtype).contiguous()
    if train:
        y, s1, s2 = conv1x1_with_stats(x4, wmat)
        scale, bias, mean, var = bn_affine_from_sums(bn, s1, s2, float(nt * h * w_), True)
    else:
        y = x4 @ wmat
        scale, bias, mean, var = bn_affine_from_sums(bn, None, None, 1.0, False)
    inv = scale / torch.sqrt(var + EPS)
    shift = bias - mean * inv
    return y.to(norm_dtype) * inv.to(norm_dtype) + shift.to(norm_dtype)
