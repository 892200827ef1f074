"""The yardstick's arithmetic: operations and bytes of the TSM-ResNet train
step and of the two hand-written kernels the cells drive, at the H100's
published peaks.

A frozen copy of ``bdvcil_torch/roofline.py``'s conv table and FLOP count
(2 a multiply-add, forward + dgrad + wgrad = 3x the forward), extended to
the basic blocks of ResNet-18/34, and of the kernel bounds of
``chip_smoke.py``'s kernel table:

  * ``conv1x1_with_stats`` (#3): a bottleneck's train-mode conv1 and conv3
    as one GEMM with BatchNorm statistics, (M, K) x (K, N): 2 (MK + MN + KN)
    bytes in bf16 plus the f32 sums (2 x 4 N), 2 MKN operations;
  * ``fused_residual_relu_shift`` (#1) and its backward (#2): four tensors
    of the block output's size, each read or written once, no operations
    counted.

The least time of a piece of work is the larger of its bytes over the HBM
peak and its operations over the bf16 tensor-core peak. Pure arithmetic:
no torch, no card.
"""

from __future__ import annotations

from typing import List, Tuple

# one H100 SXM, NVIDIA's data sheet, dense rates at the full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16_BYTES = 2

# depth -> (block kind, blocks a stage, expansion)
ARCH = {
    18: ("basic", (2, 2, 2, 2), 1),
    34: ("basic", (3, 4, 6, 3), 1),
    50: ("bottleneck", (3, 4, 6, 3), 4),
    101: ("bottleneck", (3, 4, 23, 3), 4),
}

Conv = Tuple[str, int, int, int, int, int, int, bool]


def conv_layers(depth: int, size: int = 224) -> List[Conv]:
    """(name, h, w, c_in, c_out, k, stride, shifted) of every conv of a
    ResNet at ``size``² (h, w: the conv's input dims). Bottleneck blocks:
    conv1 1x1 (the temporal shift on its input), conv2 3x3 (the stride),
    conv3 1x1; basic blocks: conv1 3x3 (the shift, the stride), conv2 3x3;
    a 1x1 downsample on each block whose stride or width changes."""
    if size % 32:
        raise ValueError(f"size {size} is not a multiple of 32")
    kind, blocks_per_stage, expansion = ARCH[depth]
    layers: List[Conv] = [("stem", size, size, 3, 64, 7, 2, False)]
    c_prev = 64  # after the max pool: (size / 4)² x 64
    for si, blocks in enumerate(blocks_per_stage):
        mid = 64 * 2 ** si
        out = mid * expansion
        sp = size // (4 * 2 ** si)  # the stage's output side
        for b in range(blocks):
            stride = 2 if (b == 0 and si > 0) else 1
            h_in = sp * stride
            if kind == "bottleneck":
                layers.append((f"s{si}b{b}c1", h_in, h_in, c_prev, mid, 1, 1, True))
                layers.append((f"s{si}b{b}c2", h_in, h_in, mid, mid, 3, stride, False))
                layers.append((f"s{si}b{b}c3", sp, sp, mid, out, 1, 1, False))
            else:
                layers.append((f"s{si}b{b}c1", h_in, h_in, c_prev, mid, 3, stride, True))
                layers.append((f"s{si}b{b}c2", sp, sp, mid, mid, 3, 1, False))
            if stride != 1 or c_prev != out:
                layers.append((f"s{si}b{b}ds", h_in, h_in, c_prev, out, 1, stride, False))
            c_prev = out
    return layers


def forward_macs_per_frame(depth: int, size: int = 224) -> float:
    """Multiply-adds of one frame's forward through the convs."""
    total = 0.0
    for _, h, _, c_in, c_out, k, s, _ in conv_layers(depth, size):
        ho = h // s
        total += ho * ho * c_out * c_in * k * k
    return total


def train_flops_per_clip(depth: int, segments: int = 8, size: int = 224) -> float:
    """FLOPs of one clip's forward + backward (3x the forward, 2 a
    multiply-add), the convs alone: R50 at 8 x 224² is 0.1962 TFLOP."""
    return 2.0 * 3.0 * segments * forward_macs_per_frame(depth, size)


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time of the work on one H100: bytes at the HBM peak or
    operations at the bf16 peak, whichever is longer."""
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)


def stats_gemm_shapes(depth: int, frames: int, size: int = 224) -> List[Tuple[int, int, int]]:
    """(M, K, N) of every ``conv1x1_with_stats`` launch of one train-mode
    forward: each bottleneck's conv1 and conv3 (``frames`` = clips x
    segments). None for a basic-block network."""
    if ARCH[depth][0] != "bottleneck":
        return []
    shapes = []
    for name, h, w, c_in, c_out, k, s, _ in conv_layers(depth, size):
        if name.endswith(("c1", "c3")) and k == 1 and s == 1:
            shapes.append((frames * h * w, c_in, c_out))
    return shapes


def stats_gemm_least_seconds(depth: int, frames: int, size: int = 224) -> float:
    """The least time of one forward's ``conv1x1_with_stats`` work: each
    launch's x and w read once, y written once in bf16, the two f32 sums."""
    total = 0.0
    for m, k, n in stats_gemm_shapes(depth, frames, size):
        nbytes = BF16_BYTES * (m * k + m * n + k * n) + 2 * 4 * n
        total += least_seconds(nbytes, 2.0 * m * k * n)
    return total


def block_output_elements(depth: int, frames: int, size: int = 224) -> List[int]:
    """Elements of every residual block's output in one forward."""
    kind, blocks_per_stage, expansion = ARCH[depth]
    out = []
    for si, blocks in enumerate(blocks_per_stage):
        sp = size // (4 * 2 ** si)
        out += [frames * sp * sp * 64 * 2 ** si * expansion] * blocks
    return out


def fused_shift_least_seconds(depth: int, frames: int, size: int = 224) -> float:
    """The least time of one train step's ``fused_residual_relu_shift``
    work: forward (#1) and backward (#2) at every block, four bf16 tensors
    of the block output's size each (chip_smoke's count)."""
    return sum(2 * least_seconds(4 * BF16_BYTES * n, 0.0)
               for n in block_output_elements(depth, frames, size))
