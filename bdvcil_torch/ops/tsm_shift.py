"""Temporal Shift Module (TSM) channel shift, and the fused block epilogue.

Port of ``bdvcil_tpu/ops/tsm_shift.py``. Given features of ``num_segments``
frames, the first C/shift_div channels take the next frame's values (frame t
sees t+1), the next C/shift_div the previous frame's (t sees t-1), the rest
pass through; boundary frames read zero.

  * ``temporal_shift`` — plain PyTorch (slice + cat), differentiable by
    autograd. ``shift_mode='pad'`` uses it before every block's conv1.
  * ``shifted_conv`` — ``shift_mode='fused'``: ``conv(temporal_shift(x), W)``
    through the conv's linearity, three ``F.conv2d`` calls on the pass-through
    channels and the two shifted folds, so the shifted tensor is never
    written whole. The JAX function is three XLA convolutions, no kernel.
  * ``temporal_shift_kernel`` — the same shift through the hand-written
    kernel of ``csrc/tsm_shift.cu`` (the port of ``temporal_shift_pallas``):
    forward and backward are one kernel with a direction argument, the
    backward being the reverse shift. On a CPU tensor it runs
    ``temporal_shift`` / ``temporal_unshift``.
  * ``fused_residual_relu_shift`` — ``shift_mode='fused_block'``: a block's
    epilogue ``out = relu(h + identity)`` together with the next block's
    shifted input ``temporal_shift(out)``, in one pass. On a CUDA tensor the
    forward and the backward are the hand-written kernels of
    ``csrc/tsm_shift.cu``; on a CPU tensor they are the plain versions
    below, which compute the same values bit for bit.

Layout: channels-last ``(N*T, H, W, C)``, contiguous, with ``T ==
num_segments``, the JAX package's layout.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

FWD = "fused_residual_relu_shift_fwd"
BWD = "fused_residual_relu_shift_bwd"
SHIFT = "temporal_shift"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def temporal_shift(x: torch.Tensor, num_segments: int, shift_div: int = 8) -> torch.Tensor:
    """Shift channels across time; x: (N*T, H, W, C)."""
    nt, h, w, c = x.shape
    n = nt // num_segments
    fold = c // shift_div
    xt = x.reshape(n, num_segments, h, w, c)
    left = torch.cat([xt[:, 1:, ..., :fold], torch.zeros_like(xt[:, :1, ..., :fold])], dim=1)
    right = torch.cat(
        [torch.zeros_like(xt[:, :1, ..., fold:2 * fold]), xt[:, :-1, ..., fold:2 * fold]], dim=1
    )
    return torch.cat([left, right, xt[..., 2 * fold:]], dim=-1).reshape(nt, h, w, c)


def temporal_unshift(g: torch.Tensor, num_segments: int, shift_div: int = 8) -> torch.Tensor:
    """The transpose of ``temporal_shift`` (the shift's gradient)."""
    nt, h, w, c = g.shape
    n = nt // num_segments
    fold = c // shift_div
    gt = g.reshape(n, num_segments, h, w, c)
    left = torch.cat([torch.zeros_like(gt[:, :1, ..., :fold]), gt[:, :-1, ..., :fold]], dim=1)
    right = torch.cat(
        [gt[:, 1:, ..., fold:2 * fold], torch.zeros_like(gt[:, :1, ..., fold:2 * fold])], dim=1
    )
    return torch.cat([left, right, gt[..., 2 * fold:]], dim=-1).reshape(nt, h, w, c)


def shifted_conv(x: torch.Tensor, weight: torch.Tensor, num_segments: int, shift_div: int = 8,
                 stride: int = 1, padding: int = 0) -> torch.Tensor:
    """``conv(temporal_shift(x), weight)`` without the shifted tensor:

        conv(x[..., 2f:], W[:, 2f:]) + conv(shift_left(x[..., :f]), W[:, :f])
                                     + conv(shift_right(x[..., f:2f]), W[:, f:2f])

    x: (N*T, H, W, C); weight (O, C, kh, kw) OIHW, cast to x's dtype. Returns
    (N*T, H', W', O), the NHWC view of a channels_last tensor."""
    nt, h, w, c = x.shape
    n = nt // num_segments
    fold = c // shift_div
    weight = weight.to(x.dtype)

    def conv(inp, ker):
        return F.conv2d(inp.permute(0, 3, 1, 2), ker, None, stride, padding)

    y = conv(x[..., 2 * fold:], weight[:, 2 * fold:])
    xt = x.reshape(n, num_segments, h, w, c)
    left = torch.cat([xt[:, 1:, ..., :fold], torch.zeros_like(xt[:, :1, ..., :fold])],
                     dim=1).reshape(nt, h, w, fold)
    right = torch.cat([torch.zeros_like(xt[:, :1, ..., fold:2 * fold]),
                       xt[:, :-1, ..., fold:2 * fold]], dim=1).reshape(nt, h, w, fold)
    y = y + conv(left, weight[:, :fold])
    y = y + conv(right, weight[:, fold:2 * fold])
    return y.permute(0, 2, 3, 1)


# --- plain versions -----------------------------------------------------------


def fused_residual_relu_shift_plain(
    h: torch.Tensor, identity: torch.Tensor, num_segments: int, shift_div: int = 8
) -> Tuple[torch.Tensor, torch.Tensor]:
    out = torch.relu(h + identity)
    return out, temporal_shift(out, num_segments, shift_div)


def fused_residual_relu_shift_bwd_plain(
    out: torch.Tensor,
    g_out: torch.Tensor,
    g_shifted: torch.Tensor,
    num_segments: int,
    shift_div: int = 8,
) -> torch.Tensor:
    g_total = g_out + temporal_unshift(g_shifted, num_segments, shift_div)
    return torch.where(out > 0, g_total, torch.zeros_like(g_total))


# --- kernels ------------------------------------------------------------------


def _check(name: str, ref: torch.Tensor, *others: torch.Tensor) -> None:
    if ref.dim() != 4:
        raise ValueError(f"{name}: expected (N*T, H, W, C), got {tuple(ref.shape)}")
    if ref.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {ref.dtype}")
    for t in (ref,) + others:
        if t.shape != ref.shape or t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(f"{name}: operands differ in shape, dtype or device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous (N*T, H, W, C)")


def _lib() -> ctypes.CDLL:
    lib = _build.library("tsm_shift")
    if not getattr(lib, "_bdv_typed", False):
        args = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        for fn in (lib.bdv_fused_residual_relu_shift_fwd, lib.bdv_fused_residual_relu_shift_bwd):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.bdv_temporal_shift.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.bdv_temporal_shift.restype = ctypes.c_int
        lib._bdv_typed = True
    return lib


def _geometry(x: torch.Tensor, num_segments: int, shift_div: int):
    nt, h, w, c = x.shape
    if nt % num_segments:
        raise ValueError(f"leading dim {nt} is not a multiple of num_segments={num_segments}")
    return x.numel(), num_segments, h * w, c, c // shift_div, _DTYPE_CODES[x.dtype]


def _fused_fwd_cuda(h, identity, num_segments, shift_div):
    _check("fused_residual_relu_shift", h, identity)
    lib = _lib()
    out = torch.empty_like(h)
    shifted = torch.empty_like(h)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    code = lib.bdv_fused_residual_relu_shift_fwd(
        h.data_ptr(), identity.data_ptr(), out.data_ptr(), shifted.data_ptr(),
        *_geometry(h, num_segments, shift_div), stream,
    )
    _build.check(lib, code, FWD)
    _build.LAUNCHES[FWD] += 1
    return out, shifted


def _fused_bwd_cuda(out, g_out, g_shifted, num_segments, shift_div):
    _check("fused_residual_relu_shift backward", out, g_out, g_shifted)
    lib = _lib()
    g_in = torch.empty_like(out)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    code = lib.bdv_fused_residual_relu_shift_bwd(
        out.data_ptr(), g_out.data_ptr(), g_shifted.data_ptr(), g_in.data_ptr(),
        *_geometry(out, num_segments, shift_div), stream,
    )
    _build.check(lib, code, BWD)
    _build.LAUNCHES[BWD] += 1
    return g_in


def fused_fwd(h, identity, num_segments: int, shift_div: int = 8):
    """The forward: the kernel on a CUDA tensor, the plain version on a CPU one."""
    return _build.dispatch(FWD, h, _fused_fwd_cuda, fused_residual_relu_shift_plain,
                           h, identity, num_segments, shift_div)


def fused_bwd(out, g_out, g_shifted, num_segments: int, shift_div: int = 8):
    """The backward: the kernel on a CUDA tensor, the plain version on a CPU one."""
    return _build.dispatch(BWD, out, _fused_bwd_cuda, fused_residual_relu_shift_bwd_plain,
                           out, g_out, g_shifted, num_segments, shift_div)


class _FusedResidualReluShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, identity, num_segments, shift_div):
        out, shifted = fused_fwd(h, identity, num_segments, shift_div)
        ctx.save_for_backward(out)
        ctx.geometry = (num_segments, shift_div)
        return out, shifted

    @staticmethod
    def backward(ctx, g_out, g_shifted):
        (out,) = ctx.saved_tensors
        g_in = fused_bwd(out, g_out.contiguous(), g_shifted.contiguous(), *ctx.geometry)
        # relu(h + identity): the same gradient reaches both inputs
        return g_in, g_in, None, None


def fused_residual_relu_shift(
    h: torch.Tensor, identity: torch.Tensor, num_segments: int, shift_div: int = 8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, shifted) = (relu(h + identity), temporal_shift(out)) in one pass.

    h, identity: (N*T, H, W, C), contiguous, same dtype. Used by ResNetTSM
    ``shift_mode='fused_block'``.
    """
    return _FusedResidualReluShift.apply(h, identity, num_segments, shift_div)


# --- the plain shift through its kernel (temporal_shift_pallas) ----------------


def _shift_cuda(x, num_segments, shift_div, reverse):
    _check(SHIFT, x)
    lib = _lib()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.bdv_temporal_shift(x.data_ptr(), out.data_ptr(),
                                  *_geometry(x, num_segments, shift_div), int(reverse), stream)
    _build.check(lib, code, SHIFT)
    _build.LAUNCHES[SHIFT] += 1
    return out


def shift_fwd(x, num_segments: int, shift_div: int = 8, reverse: bool = False):
    """The shift (or with ``reverse`` its transpose): the kernel on a CUDA
    tensor, ``temporal_shift`` / ``temporal_unshift`` on a CPU one."""
    plain = temporal_unshift if reverse else temporal_shift
    return _build.dispatch(SHIFT, x, lambda *a: _shift_cuda(*a, reverse), plain,
                           x, num_segments, shift_div)


class _TemporalShiftKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, num_segments, shift_div):
        ctx.geometry = (num_segments, shift_div)
        return shift_fwd(x, num_segments, shift_div)

    @staticmethod
    def backward(ctx, g):
        # the shift is linear: its VJP is the reverse shift (_shift_bwd)
        return shift_fwd(g.contiguous(), *ctx.geometry, reverse=True), None, None


def temporal_shift_kernel(x: torch.Tensor, num_segments: int, shift_div: int = 8) -> torch.Tensor:
    """``temporal_shift`` through the shift kernel, forward and backward.

    x: (N*T, H, W, C), contiguous, float32 or bfloat16 on the card; any C
    (packs that straddle a fold boundary are copied element by element)."""
    return _TemporalShiftKernel.apply(x, num_segments, shift_div)
