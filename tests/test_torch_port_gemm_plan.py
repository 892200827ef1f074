"""The ResNet-50 shapes of the sm90 GEMM-with-statistics kernels
(``ops/gemm_plan.py``), against the kernels' shape rule.

The kernels (``csrc/gemm_stats_sm90.cuh``) run only on the card, and so does
their tile plan (``tests/test_torch_port_cuda.py`` holds the C plans to their
Python copies there). Here: the shapes the profiles and the card tests use
are those of a configuration-A train forward and of the stride-1
bottlenecks, every one of them a whole number of the kernels' 64-channel
steps and tiles (K or Cin % 64 == 0, N % 64 == 0), and each 3x3 width one
that the 3x3's plan (``gemm_plan.conv3x3_plan``) serves with its window in
one TMA box and the widest ring. The window plan both 3x3 kernels share
(``gemm_plan.window_plan``) at every width below 65536, and the bf16 3x3's
plan fitting a CTA's shared memory at every such width: boxes where they fit
in three bands' rows, else three bands of 136 rows. Ragged K and N (the
TMA's zero fill, the wrapper's padding) and wider images on the ops are in
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
    of its width, the window in one box of exactly 128 + 2 W + 2 rows, the
    taps' rows W apart (the kernel's layout before it took wider images),
    within a CTA's shared memory."""
    nt, h, w, c, n = geometry
    assert c % BLOCK_K == 0 and n % MIN_BLOCK_N == 0
    plan = gemm_plan.conv3x3_plan(nt * h * w, n, w, c, 132)
    assert plan[:5] == tuple(gemm_plan.wgmma_plan(nt * h * w, n, 132))
    assert plan.stages == gemm_plan.CONV3X3_MAX_STAGES[plan.block_n]
    assert (plan.boxes, plan.box_rows) == (1, 128 + 2 * w + 2)
    assert (plan.box_step, plan.band) == (plan.box_rows, w)
    assert plan.smem <= gemm_plan.MAX_SMEM
    assert nt * h * w % gemm_plan.BLOCK_M == 0  # the R50 tiles are full; ragged M is a card test


@pytest.mark.parametrize("mkn", gemm_plan.R50_1X1_AFFINE_SHAPES)
def test_every_r50_conv1x1_affine_width_fits_the_kernel(mkn):
    """#7, the block's conv3 (Cm -> 4 Cm), on the wgmma core: K % 64 == 0 and
    N % 64 == 0."""
    m, k, n = mkn
    assert n == 4 * k and k % BLOCK_K == 0 and n % MIN_BLOCK_N == 0
    assert m % gemm_plan.BLOCK_M == 0  # the R50 tiles are full; ragged M is a card test


def test_window_plan_bands_exactly_where_boxes_would_be_more():
    """At every W < 65536: the window's 128 + 2 W + 2 rows in the fewest equal
    boxes of at most 256 rows (one of exactly the window up to W = 63, else
    rows rounded up to 8, each box on a 1024-byte period of the swizzle)
    where those take at most three bands' rows (3 x 136), else three bands of
    136 rows, band dy + 1 from row m0 + dy W - 1, which hold every row a tap
    reads (1 + r + dx <= 129). So a window is at most 52,224 bytes."""
    bands = 0
    for w in range(1, 1 << 16):
        win = gemm_plan.window_plan(w)
        rows = gemm_plan.BLOCK_M + 2 * w + 2
        boxes = -(-rows // gemm_plan.MAX_BOX_ROWS)
        box_rows = rows if boxes == 1 else (-(-rows // boxes) + 7) // 8 * 8
        if boxes * box_rows <= 3 * gemm_plan.BAND_ROWS:
            assert win == (boxes, box_rows, box_rows, w), w
            assert boxes <= 3 and win.boxes * win.box_rows >= rows
            assert boxes == 1 or win.box_rows * 128 % 1024 == 0
        else:
            assert win == (3, gemm_plan.BAND_ROWS, w, gemm_plan.BAND_ROWS), w
            bands += 1
        assert win.boxes * win.box_rows * 128 <= 3 * gemm_plan.BAND_ROWS * 128 == 52224
    assert gemm_plan.BAND_ROWS * 128 % 1024 == 0 and gemm_plan.BAND_ROWS >= gemm_plan.BLOCK_M + 2
    # two boxes up to W = 135 (2 x 200 rows), three bands from W = 136 (2 x 208 > 408)
    assert gemm_plan.window_plan(135).boxes == 2 and gemm_plan.window_plan(136).boxes == 3
    assert bands == (1 << 16) - 1 - 135


@pytest.mark.parametrize("cin", [8, 64, 512, 2048, 16384])
def test_conv3x3_plan_fits_at_every_width(cin):
    """The bf16 3x3's plan at every W < 65536 for Cin = Cout = ``cin`` (8
    frames of 3 rows): a CTA's shared memory as the kernel lays it out
    (a and b over C up to 2048 channels, 16 KB, or a slice a window)
    within 232,448 bytes, at least 2 ring stages, and the 1x1's tile width
    unless not even 2 stages of it fit beside the windows."""
    for w in range(1, 1 << 16):
        m = 8 * 3 * w
        plan = gemm_plan.conv3x3_plan(m, cin, w, cin, 132)
        first = gemm_plan.wgmma_plan(m, cin, 132, ksteps=gemm_plan.conv3x3_ksteps(cin))
        assert plan.smem == gemm_plan.conv3x3_smem(plan.block_n, plan.stages, w, cin)
        assert plan.smem <= gemm_plan.MAX_SMEM and plan.stages >= 2, w
        assert tuple(plan[6:10]) == gemm_plan.window_plan(w)
        if plan.block_n != first.block_n:
            assert gemm_plan.conv3x3_smem(first.block_n, 2, w, cin) > gemm_plan.MAX_SMEM, w


@pytest.mark.parametrize("k", [4608, 4616, 18432, 36864])
def test_deep_products_take_at_most_128_columns(k):
    """The bf16 core sums one accumulator over at most WHOLE_STEPS k-steps (K =
    4608, the deepest ResNet-50 product); a deeper product keeps a second
    register array of chunk sums, so its plan leaves out the 256-wide tile,
    for the 1x1 (K) and the 3x3 (9 taps of each 64-channel slice)."""
    ksteps = -(-k // BLOCK_K)
    deep = ksteps > gemm_plan.WHOLE_STEPS
    assert deep == (k > 64 * 72)
    for m, n in ((6272, 512), (401408, 256), (300, 2048)):
        plan = gemm_plan.wgmma_plan(m, n, 132, ksteps=ksteps)
        shallow = gemm_plan.wgmma_plan(m, n, 132)
        assert plan == (gemm_plan.wgmma_plan(m, n, 132, widths=(128, 64)) if deep else shallow)
    assert gemm_plan.wgmma_plan(6272, 512, 132).block_n == 256  # R50 layer4's 1x1 and 3x3
    c = k // 9 // 64 * 64
    if c:
        plan = gemm_plan.conv3x3_plan(6272, 512, 7, c, 132)
        ksteps = gemm_plan.conv3x3_ksteps(c)
        assert plan.block_n == gemm_plan.wgmma_plan(6272, 512, 132, ksteps=ksteps).block_n
        assert (plan.block_n <= 128) == (ksteps > gemm_plan.WHOLE_STEPS)
