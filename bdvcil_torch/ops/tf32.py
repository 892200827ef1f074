"""A plain emulation of the 3xTF32 split, for the tests.

``csrc/gemm_stats_tf32.cu`` computes the float32 GEMMs with statistics on
the tensor cores: each operand is split into big = tf32(v) and small =
tf32(v - big) (PTX ``cvt.rna.tf32.f32``: round to nearest, ties away from
zero, the low 13 mantissa bits zero), and y is the sum of three TF32
products, small_x big_w + big_x small_w + big_x big_w, per 32-wide k-step,
the k-steps added in f32. With the block's prologue, A is relu(x * a + b)
(the product and the sum each rounded, relu keeping NaN) before the split;
the 3x3's k-steps run channel slice by channel slice (32 channels), the 9
taps of a slice in a row, over the zero-padded prologue output. This module
repeats that arithmetic in plain PyTorch, so the tests can hold the design's
accuracy against the JAX package before the card runs it, and the card's
float64 witness can hold the kernel to it. Nothing on the main path calls it.

Values above TF32's largest finite (``TF32_MAX``, about 3.4025e38) round to
inf, as ``cvt.rna`` does; small is then -inf or NaN, and so is y.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

BLOCK_K = 32  # the kernel's k-step: its products are added into y once a step
DROPPED = 13  # f32's mantissa bits that TF32 does not keep
TF32_MAX = (2.0 - 2.0 ** -10) * 2.0 ** 127  # TF32's largest finite value


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 values in float32: to nearest, ties away from zero, by
    integer operations on the bits (half the dropped bits' unit added to the
    sign-magnitude pattern, then those bits cleared). NaN stays NaN."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_tf32: needs float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + (1 << (DROPPED - 1))) & ~((1 << DROPPED) - 1)).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def split_3xtf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) = (tf32(x), tf32(x - big)); x - big is exact in f32."""
    big = round_tf32(x)
    return big, round_tf32(x - big)


def gemm_3xtf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = x @ w as the kernel sums it: per BLOCK_K-wide k-step the three TF32
    products (each exact in f32; small ones first), that step's sum added into
    y in f32. x (M, K), w (K, N) float32."""
    xb, xs = split_3xtf32(x)
    wb, ws = split_3xtf32(w)
    y = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for k0 in range(0, x.shape[1], BLOCK_K):
        k = slice(k0, k0 + BLOCK_K)
        y = _step(y, xb[:, k], xs[:, k], wb[k], ws[k])
    return y


def gemm_stats_3xtf32_emulated(
    x: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``gemm_stats_plain``'s function with the kernel's 3xTF32 arithmetic:
    x (..., K), w (K, N) float32 -> y (..., N), sum(y), sum(y^2) over the
    rows."""
    k, n = w.shape
    y = gemm_3xtf32(x.reshape(-1, k), w)
    return y.reshape(*x.shape[:-1], n), y.sum(0), (y * y).sum(0)


def affine_relu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(x * a + b) in float32: the product and the sum each rounded (two
    eager operations, no FMA), relu keeping NaN: the kernel's prologue."""
    return torch.relu(x.float() * a + b)


def _step(y, xb, xs, wb, ws):
    """y + one k-step's three TF32 products (small ones first), in f32."""
    return y + ((xs @ wb + xb @ ws) + xb @ wb)


def affine_relu_stats_3xtf32_emulated(x, a, b, w):
    """#7 with the kernel's arithmetic: y = relu(x * a + b) @ w over x
    (..., K), a, b (K,), w (K, N) float32, 32-wide k-steps; y (..., N),
    sum(y), sum(y^2) over the rows."""
    k, n = w.shape
    y = gemm_3xtf32(affine_relu(x.reshape(-1, k), a, b), w)
    return y.reshape(*x.shape[:-1], n), y.sum(0), (y * y).sum(0)


def conv3x3_3xtf32(x, a, b, w):
    """#8's y with the kernel's arithmetic: conv3x3(pad(relu(x * a + b), 1),
    w), stride 1, 'SAME', x (NT, H, W, C), w (3, 3, C, N) HWIO float32; per
    32-channel slice, per tap (dy, dx) in order, that tap's three TF32
    products added into y in f32. Returns y as (NT H W, N)."""
    nt, h, w_, c = x.shape
    n = w.shape[-1]
    xb, xs = split_3xtf32(F.pad(affine_relu(x, a, b), (0, 0, 1, 1, 1, 1)))
    wb, ws = split_3xtf32(w.float())
    y = torch.zeros((nt * h * w_, n), dtype=torch.float32, device=x.device)
    for c0 in range(0, c, BLOCK_K):
        ch = slice(c0, c0 + BLOCK_K)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            rows = (slice(None), slice(dy, dy + h), slice(dx, dx + w_), ch)
            cols = xb[rows].shape[-1]
            y = _step(y, xb[rows].reshape(-1, cols), xs[rows].reshape(-1, cols),
                      wb[dy, dx, ch], ws[dy, dx, ch])
    return y


def conv3x3_affine_relu_stats_3xtf32_emulated(x, a, b, w):
    """``conv3x3_3xtf32`` as the op returns it: y (NT, H, W, N), sum(y),
    sum(y^2) over the pixels."""
    y = conv3x3_3xtf32(x, a, b, w)
    return y.reshape(*x.shape[:-1], w.shape[-1]), y.sum(0), (y * y).sum(0)
