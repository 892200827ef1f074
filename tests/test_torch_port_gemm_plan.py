"""The ResNet-50 shapes of the sm90 GEMM-with-statistics kernels
(``ops/gemm_plan.py``), against the kernels' shape rule.

The kernels (``csrc/gemm_stats_sm90.cuh``) run only on the card, and so does
their tile plan (``tests/test_torch_port_cuda.py`` holds the C plans to their
Python copies there). Here: the shapes the profiles and the card tests use
are those of a configuration-A train forward and of the stride-1
bottlenecks, every one of them a whole number of the kernels' 64-channel
steps and tiles (K or Cin % 64 == 0, N % 64 == 0), and each 3x3 width one
that the 3x3's plan (``gemm_plan.conv3x3_plan``) serves with its window in
one TMA box and the widest ring. Ragged K and N (the TMA's zero fill, the
wrapper's padding) and wider images are in
``tests/test_torch_port_block_dtypes.py`` and the card tests.
"""

import pytest

from bdvcil_torch.ops import gemm_plan

BLOCK_K = 64  # the wgmma kernels' K step: K (the 3x3's Cin) % 64 == 0
MIN_BLOCK_N = 64  # the narrowest tile: N % 64 == 0


def test_r50_1x1_shapes_are_the_config_a_forward():
    shapes = gemm_plan.r50_1x1_shapes()
    assert len(shapes) == 12 and sum(shapes.values()) == 32
    assert shapes[(128 * 56 * 56, 64, 256)] == 3
    assert shapes[(128 * 14 * 14, 256, 1024)] == 6


@pytest.mark.parametrize("mkn", sorted(gemm_plan.r50_1x1_shapes()))
def test_every_r50_shape_maps_to_an_instantiation(mkn):
    m, k, n = mkn
    assert m > 0 and k % BLOCK_K == 0 and n % MIN_BLOCK_N == 0


@pytest.mark.parametrize("geometry", gemm_plan.R50_3X3_SHAPES)
def test_every_r50_3x3_width_fits_the_kernel(geometry):
    """At 132 SMs (an H100 SXM): the plan the 1x1 would make, the widest ring
    of its width, the window in one box of exactly 128 + 2 W + 2 rows (the
    kernel's layout before it took wider images), within a CTA's shared
    memory and below the widest image the kernel takes."""
    nt, h, w, c, n = geometry
    assert c % BLOCK_K == 0 and n % MIN_BLOCK_N == 0
    plan = gemm_plan.conv3x3_plan(nt * h * w, n, w, c, 132)
    assert plan[:5] == tuple(gemm_plan.wgmma_plan(nt * h * w, n, 132))
    assert plan.stages == gemm_plan.CONV3X3_MAX_STAGES[plan.block_n]
    assert (plan.boxes, plan.box_rows) == (1, 128 + 2 * w + 2)
    assert plan.smem <= gemm_plan.MAX_SMEM
    assert w <= gemm_plan.conv3x3_max_width(c)
    assert nt * h * w % gemm_plan.BLOCK_M == 0  # the R50 tiles are full; ragged M is a card test


@pytest.mark.parametrize("mkn", gemm_plan.R50_1X1_AFFINE_SHAPES)
def test_every_r50_conv1x1_affine_width_fits_the_kernel(mkn):
    """#7, the block's conv3 (Cm -> 4 Cm), on the wgmma core: K % 64 == 0 and
    N % 64 == 0."""
    m, k, n = mkn
    assert n == 4 * k and k % BLOCK_K == 0 and n % MIN_BLOCK_N == 0
    assert m % gemm_plan.BLOCK_M == 0  # the R50 tiles are full; ragged M is a card test
