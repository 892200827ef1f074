"""The tile plans of the GEMM-with-statistics kernels, and the ResNet-50
shapes they serve.

``csrc/gemm_stats_sm90.cuh`` (#3 ``conv1x1_with_stats``, #4
``gemm_with_stats``, #6 the block's conv1, #7 its conv3 and #8 the 3x3, in
bf16) computes y = A @ w in 128-row tiles of ``block_n`` columns on a
persistent grid of at most one CTA per SM; ``sm90::make_plan`` picks the
width and the grid per shape (``wgmma_plan`` is its Python copy), and
``kernel_plan`` reads that choice back for reports and tests. A product of
more than ``WHOLE_STEPS`` 64-deep k-steps (K > 4608) sums its accumulator in
chunks of 8 k-steps and adds them in IEEE f32, in a second register array,
so it takes at most 128 columns. Nothing here sizes its launch: the
wrappers give the kernel one partial row per SM.

The 3x3 (``sm90::conv3x3_plan``, Python copy ``conv3x3_plan``) also reads,
for each 128-row tile and 64-channel slice, a window of x into shared memory,
twice buffered (``window_plan``, the C side's ``sm90::window_plan``, which
both 3x3 kernels share): 128 + 2 W + 2 rows in TMA boxes of at most 256 rows,
or, where that is more, three bands of 136 rows that fit at any W; where two
windows and the widest ring of w do not fit a CTA's 227 KB, it takes fewer
ring stages (at least 2), then a narrower tile, and 64 columns and 2 stages
always fit. Channel counts that are not multiples of 8 are zero-padded by
the wrapper (``conv1x1_bn.aligned_call``), and the plan is made for the
padded counts.

``csrc/gemm_stats_tf32.cu`` (every float32 stats kernel: #3, #4, #6, #7 and
#8, as three TF32 products) runs 128 x ``block_n`` tiles, ``block_n`` 128 or
64, on a persistent grid of at most one CTA per SM, one partial row a CTA;
``tf32_plan`` is the Python copy of its ``make_plan`` (the bf16 core's cost
model over the two widths, with each width's ring stages and shared
memory), for the tests and reports. As for the bf16 core, the wrapper passes
the SM count as the partials' rows, the C plan caps its grid there and the
finish sums the grid's rows; ``tf32_kernel_plan`` reads the C plan back.
Its 3x3 (``tf32gemm::conv3x3_plan``, Python copy ``tf32_conv3x3_plan``, read
back by ``tf32_conv3x3_kernel_plan``) reads, for each tile and 32-channel
slice, the same ``window_plan``'s window; it takes the widest tile (each
column tile reloads the windows) with the most ring stages that fit beside
them, then the narrower tile.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import torch

from . import _build

BLOCK_M = 128
BLOCK_K = 64  # the wgmma core's K step: a 3x3 channel slice
TILE_OVERHEAD = 32  # make_plan's cost model
WHOLE_STEPS = 72  # k-steps one accumulator of the bf16 core sums (K = 4608)
STAGED_C = 2048  # the bf16 3x3 stages a and b over all of C up to here, else a slice a window
MAX_SMEM = 232448  # the most shared memory one CTA may have on sm_90 (227 KB)
MAX_BOX_ROWS = 256  # a TMA box's most rows
A_BYTES = BLOCK_M * BLOCK_K * 2  # one bf16 A tile
# the 3x3's most ring stages per tile width (sm90::Layout<BN, kIm2col>::kMaxStages)
CONV3X3_MAX_STAGES = {256: 3, 128: 4, 64: 6}
TF32_BLOCK_K = 32  # the 3xTF32 kernel's K step: one 128-byte row of f32
# the 3xTF32 kernel's most ring stages per tile width (tf32gemm::Layout<BN>::kMaxStages)
TF32_STAGES = {128: 3, 64: 5}
BAND_ROWS = 136  # a band of a 3x3's wide window: 130 rows, rounded up to 8


class Plan(NamedTuple):
    """128 x block_n tiles, tiles = m_tiles * n_tiles, on ``grid`` CTAs."""

    block_n: int
    m_tiles: int
    n_tiles: int
    tiles: int
    grid: int


class Conv3x3Plan(NamedTuple):
    """A 3x3's tiles (``Plan``'s fields), its ring stages, its window
    (``Window``'s fields) and its CTA's shared memory in bytes: the bf16
    core's and the 3xTF32 kernel's."""

    block_n: int
    m_tiles: int
    n_tiles: int
    tiles: int
    grid: int
    stages: int
    boxes: int
    box_rows: int
    box_step: int
    band: int
    smem: int


class TF32Plan(NamedTuple):
    """The 3xTF32 kernel's ``Plan`` fields, its ring stages and its CTA's
    shared memory in bytes; ``grid`` is the partials' row count."""

    block_n: int
    m_tiles: int
    n_tiles: int
    tiles: int
    grid: int
    stages: int
    smem: int


def kernel_plan(m: int, k: int, n: int, device: torch.device) -> Plan:
    """The plan the wgmma kernels make for an (M, K, N) product on ``device``."""
    from .conv1x1_bn import _lib, sm_count

    lib = _lib()
    out = (ctypes.c_int * 5)()
    _build.check(lib, lib.bdv_wgmma_stats_plan(m, k, n, sm_count(device), out),
                 "bdv_wgmma_stats_plan")
    return Plan(*out)


def wgmma_plan(m: int, n: int, sms: int, widths=(256, 128, 64), ksteps: int = 1) -> Plan:
    """``sm90::make_plan``: among the widths that divide N rounded up to 64,
    at most 128 for a product of more than WHOLE_STEPS k-steps (``ksteps``),
    the fewest column-time units on the busiest SM, ceil(tiles / SMs) * (BN +
    32); a tie goes to the wider tile. grid = min(tiles, sms). ``widths``,
    widest first: the kernel's tile widths (the 3xTF32 kernel has 128, 64)."""
    if m <= 0 or n <= 0 or sms <= 0:
        raise ValueError(f"wgmma_plan: M={m} N={n} SMs={sms}")
    best, best_cost = None, None
    m_tiles, n64 = -(-m // BLOCK_M), -(-n // 64) * 64
    for bn in widths:
        if n64 % bn or (bn > 128 and ksteps > WHOLE_STEPS):
            continue
        tiles = m_tiles * (n64 // bn)
        cost = -(-tiles // sms) * (bn + TILE_OVERHEAD)
        if best_cost is None or cost < best_cost:
            best, best_cost = Plan(bn, m_tiles, n64 // bn, tiles, min(tiles, sms)), cost
    return best


class Window(NamedTuple):
    """A 3x3's window of a tile and channel slice: ``boxes`` TMA boxes of
    ``box_rows`` rows, box i from row m0 - W - 1 + i * box_step of x as an
    (M, C) matrix; tap (dy, dx) of the tile's row r reads window row
    (dy + 1) * band + 1 + r + dx."""

    boxes: int
    box_rows: int
    box_step: int
    band: int


def window_plan(w: int) -> Window:
    """``sm90::window_plan``: rows m0 - W - 1 .. m0 + 128 + W (128 + 2 W +
    2) in the fewest equal boxes of at most 256 rows (one box of exactly the
    window where it fits, else rows rounded up to 8, so that each box starts
    on a period of the 128-byte swizzle), the bands of dy W rows apart; where
    that is more than three bands of 136 rows, those bands, band dy + 1 from
    row m0 + dy W - 1, at any W."""
    rows = BLOCK_M + 2 * w + 2
    boxes = -(-rows // MAX_BOX_ROWS)
    box_rows = rows if boxes == 1 else -(-(-(-rows // boxes)) // 8) * 8
    if boxes * box_rows <= 3 * BAND_ROWS:
        return Window(boxes, box_rows, box_rows, w)
    return Window(3, BAND_ROWS, w, BAND_ROWS)


def conv3x3_smem(block_n: int, stages: int, w: int, c: int) -> int:
    """Shared memory of one bf16 3x3 CTA (``sm90::Layout`` + 1024 bytes of
    alignment slack): the ring of w, two A tiles, two windows, the
    statistics' cross-warp sums, the barriers, and a and b: over C rounded
    up to 64 where C <= STAGED_C, else each window's 64-channel slice."""
    win = window_plan(w)
    win_bytes = -(-win.boxes * win.box_rows * 128 // 1024) * 1024
    red = stages * BLOCK_K * block_n * 2 + 2 * A_BYTES + 2 * win_bytes
    ab = -(-(red + 2 * 8 * block_n * 4 + (2 * stages + 4) * 8) // 16) * 16
    return 1024 + ab + 4 * 2 * (-(-c // BLOCK_K) * BLOCK_K if c <= STAGED_C else 2 * BLOCK_K)


def conv3x3_ksteps(c: int) -> int:
    """The bf16 3x3's k-steps over C input channels: 9 taps of each
    64-channel slice."""
    return 9 * -(-c // BLOCK_K)


def conv3x3_plan(m: int, n: int, w: int, c: int, sms: int) -> Conv3x3Plan:
    """``sm90::conv3x3_plan`` for M = NT*H*W pixels of width W, C channels
    in and N out (multiples of 8): ``wgmma_plan``'s width for its k-steps
    with the most ring stages that fit, then narrower widths. A window of at
    most three bands fits at 64 columns and 2 stages, so every W has a plan;
    C sets the k-steps and a and b's shared memory (at most 16 KB)."""
    first = wgmma_plan(m, n, sms, ksteps=conv3x3_ksteps(c))
    win = window_plan(w)
    n64 = -(-n // 64) * 64
    bn = first.block_n
    while bn >= 64:
        for stages in range(CONV3X3_MAX_STAGES[bn], 1, -1):
            smem = conv3x3_smem(bn, stages, w, c)
            if smem <= MAX_SMEM:
                tiles = first.m_tiles * (n64 // bn)
                return Conv3x3Plan(bn, first.m_tiles, n64 // bn, tiles, min(tiles, sms),
                                   stages, *win, smem)
        bn //= 2
    raise ValueError(f"conv3x3_plan: no plan at W={w}")


def conv3x3_kernel_plan(m: int, n: int, w: int, c: int, device: torch.device) -> Conv3x3Plan:
    """The plan the bf16 3x3 kernel makes on ``device``, as its C side reports it."""
    from .block_fused import _conv3x3_lib
    from .conv1x1_bn import sm_count

    lib = _conv3x3_lib()
    out = (ctypes.c_int * 11)()
    _build.check(lib, lib.bdv_conv3x3_stats_plan(m, n, w, c, sm_count(device), out),
                 "bdv_conv3x3_stats_plan")
    return Conv3x3Plan(*out)


def tf32_smem(block_n: int, load: str = "rows", stages: int = 0, boxes: int = 0,
              box_rows: int = 0) -> int:
    """Shared memory of one 3xTF32 CTA (``tf32gemm::Layout`` + 1024 bytes of
    alignment slack), ``load`` "rows", "affine" (with the prologue) or
    "im2col" (the 3x3): the ring of ``stages`` (0: the width's most) with w's
    big and small block_n x 32 tiles a stage and x's 128 x 32 tile for the
    1x1s, y's 128 x block_n tile for the TMA store, the 3x3's two windows of
    ``boxes`` x ``box_rows`` rows, a and b's 32 channels (a stage's with the
    prologue, a window's for the 3x3), the statistics' cross-warp sums and the
    barriers (full and empty a stage, and a window)."""
    stages = stages or TF32_STAGES[block_n]
    im2col = load == "im2col"
    stage = (0 if im2col else BLOCK_M * TF32_BLOCK_K * 4) + 2 * block_n * TF32_BLOCK_K * 4
    window = -(-boxes * box_rows * 128 // 1024) * 1024 if im2col else 0
    ab = {"rows": 0, "affine": stages, "im2col": 2}[load] * 2 * TF32_BLOCK_K * 4
    barriers = 2 * stages + (4 if im2col else 0)
    return (1024 + stages * stage + BLOCK_M * block_n * 4 + 2 * window + ab
            + 2 * 8 * block_n * 4 + 8 * barriers)


def tf32_plan(m: int, n: int, sms: int) -> TF32Plan:
    """``tf32gemm::make_plan``: ``wgmma_plan`` over widths 128 and 64, with
    the width's ring stages and shared memory (the 1x1 without a
    prologue)."""
    if m > 2 ** 31 - BLOCK_M:
        raise ValueError(f"tf32_plan: M={m} past the kernel's int rows")
    plan = wgmma_plan(m, n, sms, widths=(128, 64))
    return TF32Plan(*plan, TF32_STAGES[plan.block_n], tf32_smem(plan.block_n))


def tf32_kernel_plan(m: int, n: int, device: torch.device) -> TF32Plan:
    """The plan the 3xTF32 kernel makes on ``device``, as its C side reports it."""
    from .conv1x1_bn import _tf32_lib, sm_count

    lib = _tf32_lib()
    out = (ctypes.c_int * 7)()
    _build.check(lib, lib.bdv_gemm_stats_tf32_plan(m, n, sm_count(device), out),
                 "bdv_gemm_stats_tf32_plan")
    return TF32Plan(*out)


def tf32_conv3x3_plan(m: int, n: int, w: int, sms: int) -> Conv3x3Plan:
    """``tf32gemm::conv3x3_plan`` for M = NT*H*W pixels of width W and N
    channels out (a multiple of 4): the widest tile (128 where it divides N
    rounded up to 64; each column tile reloads the window and reruns its
    prologue) with the most ring stages (at least 2) that fit beside two
    windows, then the narrower width. A banded window fits at 64 columns, so
    every W has a plan."""
    if m <= 0 or n <= 0 or sms <= 0 or m > 2 ** 31 - BLOCK_M:
        raise ValueError(f"tf32_conv3x3_plan: M={m} N={n} SMs={sms}")
    win = window_plan(w)
    m_tiles, n64 = -(-m // BLOCK_M), -(-n // 64) * 64
    bn = 128 if n64 % 128 == 0 else 64
    while bn >= 64:
        for stages in range(TF32_STAGES[bn], 1, -1):
            smem = tf32_smem(bn, "im2col", stages, win.boxes, win.box_rows)
            if smem <= MAX_SMEM:
                tiles = m_tiles * (n64 // bn)
                return Conv3x3Plan(bn, m_tiles, n64 // bn, tiles, min(tiles, sms), stages,
                                   *win, smem)
        bn //= 2
    raise ValueError(f"tf32_conv3x3_plan: no plan at W={w}")


def tf32_conv3x3_kernel_plan(m: int, n: int, w: int, device: torch.device) -> Conv3x3Plan:
    """The plan the 3xTF32 3x3 makes on ``device``, as its C side reports it."""
    from .conv1x1_bn import _tf32_lib, sm_count

    lib = _tf32_lib()
    out = (ctypes.c_int * 11)()
    _build.check(lib, lib.bdv_conv3x3_stats_tf32_plan(m, n, w, sm_count(device), out),
                 "bdv_conv3x3_stats_tf32_plan")
    return Conv3x3Plan(*out)


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
