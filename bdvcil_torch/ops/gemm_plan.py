"""The tile plans of the GEMM-with-statistics kernels, and the ResNet-50
shapes they serve.

``csrc/gemm_stats_sm90.cuh`` (#3 ``conv1x1_with_stats``, #4
``gemm_with_stats``, #6 the block's conv1, #7 its conv3 and #8 the 3x3, in
bf16) computes y = A @ w in 128-row tiles of ``block_n`` columns on a
persistent grid of at most one CTA per SM; ``sm90::make_plan`` picks the
width and the grid per shape, and ``kernel_plan`` reads that choice back for
reports and tests. Nothing here sizes its launch: the wrappers give the
kernel one partial row per SM.

``csrc/gemm_stats_f32.cu`` (#3 and #4 in float32) runs one CTA per 128 x
``block_n`` tile and one partial row per 128-row tile. ``f32_plan`` is the
Python copy of its ``make_plan``; the wrapper sizes the partials with it and
the kernel refuses a count that is not its own. ``f32_kernel_plan`` reads
the C plan back.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import torch

from . import _build

BLOCK_M = 128
F32_BLOCK_M = 128  # the FFMA kernel's tile rows


class Plan(NamedTuple):
    """128 x block_n tiles, tiles = m_tiles * n_tiles, on ``grid`` CTAs."""

    block_n: int
    m_tiles: int
    n_tiles: int
    tiles: int
    grid: int


class F32Plan(NamedTuple):
    """block_m x block_n tiles, m_tiles x n_tiles of them, one CTA each."""

    block_m: int
    block_n: int
    m_tiles: int
    n_tiles: int
    grid: int


def kernel_plan(m: int, n: int, device: torch.device) -> Plan:
    """The plan the wgmma kernels make for an (M, ., N) product on ``device``."""
    from .conv1x1_bn import _lib, sm_count

    lib = _lib()
    out = (ctypes.c_int * 5)()
    _build.check(lib, lib.bdv_wgmma_stats_plan(m, n, sm_count(device), out),
                 "bdv_wgmma_stats_plan")
    return Plan(*out)


def f32_plan(m: int, n: int) -> F32Plan:
    """The float32 kernel's tiles for an (M, ., N) product (``f32gemm::make_plan``):
    128 columns, or 64 where a 128-wide last tile would hold 64 empty columns
    or more (N % 128 in 1 .. 64)."""
    if m <= 0 or n <= 0:
        raise ValueError(f"f32_plan: M={m} N={n}")
    rest = n % 128
    block_n = 128 if rest == 0 or rest > 64 else 64
    m_tiles, n_tiles = -(-m // F32_BLOCK_M), -(-n // block_n)
    return F32Plan(F32_BLOCK_M, block_n, m_tiles, n_tiles, m_tiles * n_tiles)


def f32_kernel_plan(m: int, n: int) -> F32Plan:
    """The plan the float32 kernel makes, as its C side reports it."""
    from .conv1x1_bn import _f32_lib

    lib = _f32_lib()
    out = (ctypes.c_int * 5)()
    _build.check(lib, lib.bdv_gemm_stats_f32_plan(m, n, out), "bdv_gemm_stats_f32_plan")
    return F32Plan(*out)


def r50_1x1_shapes(nt: int = 128, size: int = 56) -> Counter:
    """(M, K, N) of the bottleneck 1x1 convolutions of one TSM-ResNet-50
    train forward in configuration A (conv1 at the block's input resolution,
    conv3 after the stride), with their counts: 12 shapes, 32 launches at
    16 clips x 8 frames of 224x224."""
    shapes: Counter = Counter()
    inplanes, planes = 64, 64
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            shapes[(nt * size * size, inplanes, planes)] += 1
            size //= stride
            shapes[(nt * size * size, planes, 4 * planes)] += 1
            inplanes = 4 * planes
        planes *= 2
    return shapes


# (NT, H, W, Cin, Cout) of the 3x3 of each stride-1 ResNet-50 bottleneck width
R50_3X3_SHAPES = ((128, 56, 56, 64, 64), (128, 28, 28, 128, 128), (128, 14, 14, 256, 256),
                  (128, 7, 7, 512, 512))
# (M, K, N) of the conv3 (Cm -> 4 Cm, with the prologue) of the same bottlenecks
R50_1X1_AFFINE_SHAPES = tuple((nt * h * w, cm, 4 * cm) for nt, h, w, cm, _ in R50_3X3_SHAPES)
