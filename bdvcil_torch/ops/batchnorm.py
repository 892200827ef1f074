"""Train-mode BatchNorm as one autograd Function, forward and backward.

Every train-mode ``models/norm.BatchNorm`` (flax semantics: statistics in f32,
``var = max(0, E[x^2] - E[x]^2)``, momentum 0.9 on the biased variance) and
the normalize half of ``ops/conv1x1_bn.conv1x1_bn`` run here. On a CUDA
tensor each half is a short chain of the hand-written kernels of
``csrc/batchnorm.cu``:

  forward   batchnorm_stats      per-channel f32 sum and sum of squares
                                 (not for conv1x1_bn: its GEMM gave them)
            batchnorm_finalize   mean, var, the running statistics updated in
                                 place, the (5, C) coefficients
            batchnorm_apply      out = out_dtype(((x - mean) * mul) + bias),
                                 with the following relu where asked
  backward  batchnorm_bwd_reduce sum g and sum g * xhat (xhat recomputed from
                                 x; g masked by the recomputed relu)
            batchnorm_bwd_dx     dx = mul * (g - sum g / n - xhat * sum g xhat / n)

Launches count in ``_build.LAUNCHES`` under these names, with ``_f32`` added
where the input is float32. Under a process group ``(s1, s2, count)`` are
all-reduced between stats and finalize, and the backward's two sums before
dx; the weight and bias gradients stay this rank's, as autograd's are
(``runtime/steps`` all-reduces them with the others).

Two modes, ``_Spec.sums``: False is the BatchNorm module's arithmetic,
``mul = rsqrt(var + eps) * weight`` and the normalize in f32 rounded once to
the output dtype; True is conv1x1_bn's, ``inv = weight / sqrt(var + eps)``
unclamped, ``shift = bias - mean * inv``, ``out = T(T(T(y) * T(inv)) +
T(shift))`` in the norm dtype T. The coefficient rows are mean, r (the
reciprocal standard deviation), k (mul or inv: dx's scale), and the
normalize's (a, b): (mul, bias) or (T(inv), T(shift)).

The forward keeps the eager expressions' bits given the same sums (the
kernels round each f32 operation once, in eager PyTorch's order). The
backward is the analytic gradient of the batch statistics in f32, one
reduction and one elementwise pass; autograd's replay of the eager graph
took some twenty. For conv1x1_bn it is the whole dy, the paths through s1
and s2 included, so the GEMM's backward receives no gradient for them.

On a CPU tensor (and with ``plain``, conv1x1_mode ``'pallas_stats_interpret'``,
on any device) the plain versions below compose the same forward, the eager
expression, and autograd differentiates it, as JAX differentiates flax's: the
CPU runs keep the eager graph's roundings, which the tests against the JAX
package hold. The analytic backward's plain versions (``bwd_reduce_plain``,
``bwd_dx_plain``, composed by ``_backward``) are the kernels' twins: the card
tests hold the kernels to them, the CPU tests hold them to autograd in
float64 and to ``jax.grad``. The plain versions cast with ``.float()`` only,
so a float64 model whose ``Tensor.float`` is made a no-op stays in float64.
The kernels take channels_last (N, C, H, W) or NHWC (..., C) tensors in
bfloat16 or float32 and raise on any other layout or dtype.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from ..parallel import distributed
from . import _build

STATS = "batchnorm_stats"
FINALIZE = "batchnorm_finalize"
APPLY = "batchnorm_apply"
BWD_REDUCE = "batchnorm_bwd_reduce"
BWD_DX = "batchnorm_bwd_dx"
KERNELS = (STATS, FINALIZE, APPLY, BWD_REDUCE, BWD_DX)
F32 = "_f32"  # float32 inputs' launches count under the kernel's name + F32
COEF_ROWS = 5  # mean, r, k, a, b

Count = Union[float, torch.Tensor]  # this rank's rows, or the ranks' (1,) sum


class _Spec(NamedTuple):
    sums: bool  # conv1x1_bn's normalize of given sums, else the BatchNorm module's
    relu: bool
    out_dtype: torch.dtype
    count: float  # this rank's rows
    eps: float
    cdim: int  # the channel dimension: 1 (N, C, H, W) or the last (NHWC)
    plain: bool  # the plain versions on every device


def is_launch(name: str) -> bool:
    """Whether a ``_build.LAUNCHES`` key counts one of these kernels."""
    return name.removesuffix(F32) in KERNELS


def launch_name(name: str, dtype: torch.dtype) -> str:
    """The count a launch adds to: ``name`` for bfloat16 input, ``name + F32``
    for float32; any other dtype raises TypeError."""
    if dtype == torch.bfloat16:
        return name
    if dtype == torch.float32:
        return name + F32
    raise TypeError(f"{name}: the kernels take bfloat16 or float32, got {dtype}")


# --- plain versions ------------------------------------------------------------


def _dims(x: torch.Tensor, cdim: int) -> Tuple[int, ...]:
    return tuple(d for d in range(x.dim()) if d != cdim)


def _per_channel(v: torch.Tensor, x: torch.Tensor, cdim: int) -> torch.Tensor:
    """v (C,) broadcast along x's channel dimension."""
    return v.reshape(v.shape + (1,) * (x.dim() - 1 - cdim))


def _count_tensor(count: Count, like: torch.Tensor) -> torch.Tensor:
    return count if isinstance(count, torch.Tensor) else like.new_full((1,), count)


def stats_plain(x: torch.Tensor, cdim: int):
    """(sum x, sum x^2) per channel in f32."""
    xf = x.float()
    dims = _dims(x, cdim)
    return xf.sum(dim=dims), (xf * xf).sum(dim=dims)


def finalize_plain(s1: torch.Tensor, s2: torch.Tensor, count: Count, bn, spec: _Spec):
    """The statistics of (s1, s2) over ``count`` rows -> coefficients (5, C);
    ``bn``'s running statistics updated in place with the flax momentum."""
    n = _count_tensor(count, s1)
    mean = s1 / n
    if spec.sums:
        var = s2 / n - mean * mean
        sd = torch.sqrt(var + spec.eps)
        k = bn.weight / sd
        r = 1 / sd
        a = k.to(spec.out_dtype).to(k.dtype)
        b = (bn.bias - mean * k).to(spec.out_dtype).to(k.dtype)
    else:
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        r = torch.rsqrt(var + spec.eps)
        k = r * bn.weight
        a, b = k, bn.bias
    bn._update_running(mean, var)
    return torch.stack((mean, r, k, a, b))


def _normalize_plain(x: torch.Tensor, coef: torch.Tensor, spec: _Spec) -> torch.Tensor:
    """The forward's output before the relu."""
    mean, _, _, a, b = (_per_channel(v, x, spec.cdim) for v in coef)
    if spec.sums:
        t = spec.out_dtype
        return x.to(t) * a.to(t) + b.to(t)
    return ((x - mean) * a + b).to(spec.out_dtype)


def apply_plain(x: torch.Tensor, coef: torch.Tensor, spec: _Spec) -> torch.Tensor:
    y = _normalize_plain(x, coef, spec)
    return torch.relu(y) if spec.relu else y


def _masked_g(g: torch.Tensor, x: torch.Tensor, coef: torch.Tensor, spec: _Spec):
    """g in f32, zero where the relu'd output is <= 0 (threshold_backward)."""
    gf = g.float()
    if spec.relu:
        gf = gf.masked_fill(_normalize_plain(x, coef, spec) <= 0, 0.0)
    return gf


def _xhat(x: torch.Tensor, coef: torch.Tensor, spec: _Spec) -> torch.Tensor:
    return (x.float() - _per_channel(coef[0], x, spec.cdim)) * _per_channel(coef[1], x, spec.cdim)


def bwd_reduce_plain(g: torch.Tensor, x: torch.Tensor, coef: torch.Tensor, spec: _Spec):
    """(sum g, sum g * xhat) per channel, g masked by the relu."""
    gf = _masked_g(g, x, coef, spec)
    dims = _dims(x, spec.cdim)
    return gf.sum(dim=dims), (gf * _xhat(x, coef, spec)).sum(dim=dims)


def bwd_dx_plain(g: torch.Tensor, x: torch.Tensor, coef: torch.Tensor, sg: torch.Tensor,
                 sgx: torch.Tensor, count: Count, spec: _Spec) -> torch.Tensor:
    """dx = k * ((g - sum g / n) - xhat * (sum g xhat / n)) in x's dtype."""
    n = _count_tensor(count, sg)
    c0, c1, k = (_per_channel(v, x, spec.cdim) for v in (sg / n, sgx / n, coef[2]))
    gf = _masked_g(g, x, coef, spec)
    return (k * ((gf - c0) - _xhat(x, coef, spec) * c1)).to(x.dtype)


# --- the kernels -----------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.library("batchnorm")
    if not getattr(lib, "_bdv_typed", False):
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.bdv_batchnorm_stats.argtypes = [p, ll, i, i, p, p, p, i, p]
        lib.bdv_batchnorm_finalize.argtypes = [p, p, p, f] + [p] * 5 + [i, f, f, f, i, i, p]
        lib.bdv_batchnorm_apply.argtypes = [p, p, p, ll] + [i] * 6 + [p]
        lib.bdv_batchnorm_bwd_reduce.argtypes = [p, p, p, ll] + [i] * 5 + [p, p, p, i, p]
        lib.bdv_batchnorm_bwd_dx.argtypes = [p] * 6 + [f, p, ll] + [i] * 6 + [p]
        for fn in (lib.bdv_batchnorm_stats, lib.bdv_batchnorm_finalize, lib.bdv_batchnorm_apply,
                   lib.bdv_batchnorm_bwd_reduce, lib.bdv_batchnorm_bwd_dx):
            fn.restype = ctypes.c_int
        lib._bdv_typed = True
    return lib


_TICKETS = {}


def _ticket(device: torch.device, stream: int) -> int:
    """The zeroed counter of a stream's reductions (its address): the last CTA
    of a launch resets it, so launches in stream order share one."""
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t.data_ptr()


def _check_vectors(name: str, c: int, device, *vs: torch.Tensor) -> None:
    for v in vs:
        if v.shape != (c,) or v.dtype != torch.float32 or v.device != device \
                or not v.is_contiguous():
            raise ValueError(f"{name}: per-channel vectors must be contiguous ({c},) float32 "
                             f"on {device}, got {tuple(v.shape)} {v.dtype} on {v.device}")


_NAMES = {dtype: {k: launch_name(k, dtype) for k in KERNELS}
          for dtype in (torch.bfloat16, torch.float32)}


def _channels_last_rows(x: torch.Tensor, cdim: int) -> bool:
    if cdim == 1 and x.dim() == 4:
        return x.is_contiguous(memory_format=torch.channels_last)
    return cdim == x.dim() - 1 and x.is_contiguous()


def _count_args(count: Count):
    """(the ranks' count's address or None, this rank's count or 0)."""
    return (count.data_ptr(), 0.0) if isinstance(count, torch.Tensor) else (None, count)


class _Kernels:
    """The kernels under the plain versions' names, for one Function call
    (x's rows, dtype, device and stream looked up once). The reductions
    return their sums as views of one f32 scratch tensor that holds the
    per-CTA partials too."""

    def __init__(self, x: torch.Tensor, cdim: int):
        names = _NAMES.get(x.dtype)
        if names is None:
            launch_name(STATS, x.dtype)  # raises
        if not _channels_last_rows(x, cdim):
            raise ValueError(f"{STATS}: x must hold rows of channels (channels_last (N, C, H, "
                             f"W) or NHWC), got shape {tuple(x.shape)} strides {x.stride()}")
        self.names = names
        self.c = x.shape[cdim]
        self.m = x.numel() // self.c
        self.dev = x.device
        self.lib = _lib()
        self.sms = _build.sm_count(self.dev)
        self.stream = torch.cuda.current_stream(self.dev).cuda_stream

    def _launched(self, kernel: str, code: int) -> None:
        name = self.names[kernel]
        if code:
            _build.check(self.lib, code, name)
        _build.LAUNCHES[name] += 1

    def _scratch(self):
        """The (2, SMs, C) partials, then the (2, C) sums: the tensor, the
        partials' and the sums' addresses."""
        n = 2 * self.sms * self.c
        buf = torch.empty(n + 2 * self.c, dtype=torch.float32, device=self.dev)
        return buf, buf.data_ptr(), buf.data_ptr() + 4 * n

    def _sums(self, buf: torch.Tensor):
        return buf[2 * self.sms * self.c:].view(2, self.c).unbind(0)

    def stats(self, x: torch.Tensor, cdim: int):
        buf, part, sums = self._scratch()
        self._launched(STATS, self.lib.bdv_batchnorm_stats(
            x.data_ptr(), self.m, self.c, x.element_size(), part, sums,
            _ticket(self.dev, self.stream), self.sms, self.stream))
        return self._sums(buf)

    def finalize(self, s1: torch.Tensor, s2: torch.Tensor, count: Count, bn, spec: _Spec):
        c = self.c
        vectors = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
        _check_vectors(FINALIZE, c, self.dev, s1, s2, *vectors)
        if spec.out_dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{FINALIZE}: output dtype {spec.out_dtype}")
        coef = torch.empty((COEF_ROWS, c), dtype=torch.float32, device=self.dev)
        m = bn.momentum
        self._launched(FINALIZE, self.lib.bdv_batchnorm_finalize(
            s1.data_ptr(), s2.data_ptr(), *_count_args(count),
            *(v.data_ptr() for v in vectors), coef.data_ptr(), c, m, 1 - m, spec.eps,
            int(spec.sums), spec.out_dtype.itemsize, self.stream))
        return coef

    def apply(self, x: torch.Tensor, coef: torch.Tensor, spec: _Spec) -> torch.Tensor:
        out = torch.empty_like(x, dtype=spec.out_dtype)
        self._launched(APPLY, self.lib.bdv_batchnorm_apply(
            x.data_ptr(), coef.data_ptr(), out.data_ptr(), self.m, self.c, x.element_size(),
            out.element_size(), int(spec.sums), int(spec.relu), self.sms, self.stream))
        return out

    def bwd_reduce(self, g: torch.Tensor, x: torch.Tensor, coef: torch.Tensor, spec: _Spec):
        buf, part, sums = self._scratch()
        self._launched(BWD_REDUCE, self.lib.bdv_batchnorm_bwd_reduce(
            g.data_ptr(), x.data_ptr(), coef.data_ptr(), self.m, self.c, x.element_size(),
            g.element_size(), int(spec.sums), int(spec.relu), part, sums,
            _ticket(self.dev, self.stream), self.sms, self.stream))
        return self._sums(buf)

    def bwd_dx(self, g: torch.Tensor, x: torch.Tensor, coef: torch.Tensor, sg: torch.Tensor,
               sgx: torch.Tensor, count: Count, spec: _Spec) -> torch.Tensor:
        _check_vectors(BWD_DX, self.c, self.dev, sg, sgx)
        dx = torch.empty_like(x)
        self._launched(BWD_DX, self.lib.bdv_batchnorm_bwd_dx(
            g.data_ptr(), x.data_ptr(), coef.data_ptr(), sg.data_ptr(), sgx.data_ptr(),
            *_count_args(count), dx.data_ptr(), self.m, self.c, x.element_size(),
            g.element_size(), int(spec.sums), int(spec.relu), self.sms, self.stream))
        return dx

    def grad_rows(self, g: torch.Tensor, cdim: int) -> torch.Tensor:
        """The backward's g as rows of channels, on autograd's stream."""
        self.stream = torch.cuda.current_stream(self.dev).cuda_stream
        if _channels_last_rows(g, cdim):  # autograd may hand any layout
            return g
        return g.contiguous(memory_format=torch.channels_last) if cdim == 1 else g.contiguous()


def _forward(ops, x: torch.Tensor, s1, s2, bn, spec: _Spec):
    """stats (unless given), the ranks' sums, finalize, apply: (out, coef,
    count), ``ops`` the plain versions or the kernels."""
    if s1 is None:
        s1, s2 = ops.stats(x, spec.cdim)
    count: Count = spec.count
    if distributed.is_initialized():
        s1, s2, count = distributed.global_sums(s1, s2, s1.new_full((1,), count))
    coef = ops.finalize(s1, s2, count, bn, spec)
    return ops.apply(x, coef, spec), coef, count


def _backward(ops, g: torch.Tensor, x: torch.Tensor, coef: torch.Tensor, count: Count,
              spec: _Spec, need_dx: bool):
    """bwd_reduce, the ranks' sums, bwd_dx: (dx or None, dweight, dbias)."""
    sg, sgx = ops.bwd_reduce(g, x, coef, spec)
    dweight, dbias = sgx, sg  # this rank's, as autograd's
    if distributed.is_initialized():
        sg, sgx = distributed.global_sums(sg, sgx)
    dx = ops.bwd_dx(g, x, coef, sg, sgx, count, spec) if need_dx else None
    return dx, dweight, dbias


PLAIN = SimpleNamespace(stats=stats_plain, finalize=finalize_plain, apply=apply_plain,
                        bwd_reduce=bwd_reduce_plain, bwd_dx=bwd_dx_plain)


def _eager(x: torch.Tensor, spec: _Spec) -> bool:
    """Whether x takes the plain versions under autograd (the CPU, ``plain``)
    rather than the kernels (a card)."""
    if spec.plain or x.device.type == "cpu":
        return True
    if x.is_cuda:
        return False
    raise NotImplementedError(f"no BatchNorm for device {x.device}")


def _train(x: torch.Tensor, s1, s2, bn, spec: _Spec) -> torch.Tensor:
    if _eager(x, spec):
        return _forward(PLAIN, x, s1, s2, bn, spec)[0]
    return _TrainBatchNorm.apply(x, s1, s2, bn.weight, bn.bias, bn, spec)


class _TrainBatchNorm(torch.autograd.Function):
    """out = BatchNorm(x) (train mode, optionally relu'd) on the kernels; s1
    and s2 the given sums of x (conv1x1_bn) or None (computed here)."""

    @staticmethod
    def forward(ctx, x, s1, s2, weight, bias, bn, spec: _Spec):
        ops = _Kernels(x, spec.cdim)
        out, coef, count = _forward(ops, x, s1, s2, bn, spec)
        ctx.ops, ctx.spec = ops, spec
        ctx.save_for_backward(x, coef, count if isinstance(count, torch.Tensor) else None)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, coef, count_t = ctx.saved_tensors
        ops, spec = ctx.ops, ctx.spec
        count = count_t if count_t is not None else spec.count
        dx, dweight, dbias = _backward(ops, ops.grad_rows(g, spec.cdim), x, coef, count, spec,
                                       ctx.needs_input_grad[0])
        return dx, None, None, dweight, dbias, None, None


def batchnorm_train(x: torch.Tensor, bn, out_dtype: torch.dtype,
                    relu: bool = False) -> torch.Tensor:
    """``models/norm.BatchNorm`` in train mode on x (N, C, H, W): the batch's
    statistics (the global batch's under a process group), the running
    statistics updated, the output in ``out_dtype``, relu'd with ``relu``."""
    spec = _Spec(False, relu, out_dtype, float(x.numel() // x.shape[1]), bn.epsilon, 1, False)
    return _train(x, None, None, bn, spec)


def normalize_from_sums(y: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor, bn,
                        count: float, eps: float, out_dtype: torch.dtype, relu: bool = False,
                        plain: bool = False) -> torch.Tensor:
    """conv1x1_bn's train-mode normalize of y (..., C) NHWC from its sums over
    ``count`` rows of this rank, in ``out_dtype`` (the norm dtype); ``plain``
    runs the plain versions on every device."""
    spec = _Spec(True, relu, out_dtype, count, eps, y.dim() - 1, plain)
    return _train(y, s1, s2, bn, spec)

