"""A plain emulation of the 3xTF32 split, for the tests.

``csrc/gemm_stats_tf32.cu`` computes the float32 GEMM with statistics on
the tensor cores: each operand is split into big = tf32(v) and small =
tf32(v - big) (PTX ``cvt.rna.tf32.f32``: round to nearest, ties away from
zero, the low 13 mantissa bits zero), and y is the sum of three TF32
products, small_x big_w + big_x small_w + big_x big_w, per 32-wide k-step,
the k-steps added in f32. This module repeats that arithmetic in plain
PyTorch on the CPU, so the tests can hold the design's accuracy against the
JAX package before the card runs it. Nothing on the main path calls it.

Values above TF32's largest finite (``TF32_MAX``, about 3.4025e38) round to
inf, as ``cvt.rna`` does; small is then -inf or NaN, and so is y.
"""

from __future__ import annotations

from typing import Tuple

import torch

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
        y = y + ((xs[:, k] @ wb[k] + xb[:, k] @ ws[k]) + xb[:, k] @ wb[k])
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
