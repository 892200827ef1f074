"""Time the whole-block fused bottleneck forward against the plain schedule.

Port of ``tools/bench_block_fused.py``. It chains ``iters`` block forwards,
each output feeding the next input (a data dependency per iteration), and
times the chain after two warm-up blocks, for three schedules:

  fused_taps     ``fused_bottleneck_fwd``, conv3x3 variant "taps"
  fused_im2col   the same with variant "im2col" (the same kernel on the card)
  plain          ``plain_bottleneck_fwd``: library convolutions, eager BatchNorm

``--parts`` also times each stats op alone against its library counterpart
plus the statistics reduction (``bench_parts`` of the JAX tool):
``torch.matmul`` + two sums for the 1x1 convs, ``F.conv2d`` on channels_last
+ two sums for the 3x3, and the statistics reduction alone. As in the JAX
tool, the parts take a = 1, b = 0 and the library counterparts apply relu
only. It also times the block's tail: the last elementwise pass, relu(y3 *
a3 + b3 + x), as the kernel the fused schedule launches
(``affine_residual_relu``, ``epilogue_kernel``) and as its eager plain
version (``epilogue_plain``), and one BatchNorm finalize at C likewise
(``bn_finalize_kernel``, ``bn_finalize_plain``).

The geometry comes from flags (the JAX defaults: 16 clips x 8 frames at
layer1, 56x56, 256 -> 64 -> 64 -> 256), at any width and channel count the
ops take (``--hw 64`` is layer1 at a 256² input). Three knobs of the TPU tool are not
carried over: ``BLOCK_VMEM_BUDGET_MB`` and ``BLOCK_SCOPED_VMEM_KIB``, which
sized the row tiles to the TPU's VMEM, and ``BLOCK_IM2COL``, which existed
only because the TPU compiler rejected that variant; both variants always
run here.

On the card the times are CUDA events; with ``--device cpu`` the plain
versions run and the host clock times them (no device metric). Prints one
JSON line.

    python -m bdvcil_torch.bench_block_fused [iters] [--parts]
        [--rows 128 --hw 56 --c 256 --cm 64] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from functools import partial

import torch
import torch.nn.functional as F

from ._device import resolve_device
from .ops import block_fused as bf


def elapsed_ms(fn, device: torch.device) -> float:
    """Milliseconds of one call of ``fn``: CUDA events on the card, the host
    clock (after the work is done) on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def median_ms(fn, device: torch.device, reps: int = 10, warmup: int = 2) -> float:
    """Median time of one call over ``reps`` calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return statistics.median(elapsed_ms(fn, device) for _ in range(reps))


def block_inputs(rows: int, hw, c: int, cm: int, seed: int, device: torch.device,
                 dtype: torch.dtype = torch.bfloat16):
    """x (rows, H, W, c), ``hw`` H = W or (H, W), and the block's conv
    weights in ``dtype`` (its BatchNorm parameters in f32), made from
    ``seed``."""
    h, w = hw if isinstance(hw, tuple) else (hw, hw)
    gen = torch.Generator().manual_seed(seed)
    p = bf.make_params(gen, c=c, cm=cm, dtype=dtype, device=device)
    x = torch.randn((rows, h, w, c), generator=gen).to(dtype).to(device)
    return x, p


SCHEDULES = {
    "fused_taps": partial(bf.fused_bottleneck_fwd, conv3x3_variant="taps"),
    "fused_im2col": partial(bf.fused_bottleneck_fwd, conv3x3_variant="im2col"),
    "plain": bf.plain_bottleneck_fwd,
}


def time_blocks(x, p, iters: int, device: torch.device):
    """ms per block of each schedule, over a chain of ``iters`` blocks."""

    def chain(fn, n):
        v = x
        for _ in range(n):
            v, _ = fn(v, p)
        return v

    out = {}
    for name, fn in SCHEDULES.items():
        chain(fn, 2)
        out[name] = elapsed_ms(lambda fn=fn: chain(fn, iters), device) / iters
    return out


def _stats(y: torch.Tensor):
    yf = y.float()
    return yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))


def time_parts(x, p, device: torch.device, reps: int = 10):
    """ms of each stats op alone and of its library counterpart + statistics."""
    rows, hw, _, c = x.shape
    cm = p.w2.shape[-1]
    w1 = p.w1.reshape(c, cm).to(x.dtype).contiguous()
    w3 = p.w3.reshape(cm, c).to(x.dtype).contiguous()
    w2 = p.w2.to(x.dtype).contiguous()
    w2_oihw = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    ones = torch.ones((cm,), device=device)
    zeros = torch.zeros((cm,), device=device)
    gen = torch.Generator().manual_seed(2)
    y1 = torch.randn((rows, hw, hw, cm), generator=gen).to(x.dtype).to(device)
    y3 = torch.randn(x.shape, generator=gen).to(x.dtype).to(device)
    s3, q3 = _stats(y3)
    count = float(rows * hw * hw)

    def lib_conv2():
        y = F.conv2d(torch.relu(y1).permute(0, 3, 1, 2), w2_oihw, padding=1)
        return _stats(y.permute(0, 2, 3, 1))

    parts = {
        "fused_conv1_1x1": lambda: bf.conv1x1_stats(x, w1),
        "lib_conv1_1x1": lambda: _stats(torch.matmul(x, w1)),
        "fused_conv2_3x3": lambda: bf.conv3x3_affine_relu_stats(y1, ones, zeros, w2),
        "lib_conv2_3x3": lib_conv2,
        "fused_conv3_1x1": lambda: bf.conv1x1_affine_relu_stats(y1, ones, zeros, w3),
        "lib_conv3_1x1": lambda: _stats(torch.matmul(torch.relu(y1), w3)),
        "lib_bn_stats_only": lambda: _stats(y1),
        # the fused block's last pass, relu(y3 * a3 + b3 + x), and its last
        # BatchNorm finalize
        "epilogue_kernel": lambda: bf.affine_residual_relu(y3, p.g3, p.b3, x),
        "epilogue_plain": lambda: bf.affine_residual_relu_plain(y3, p.g3, p.b3, x),
        "bn_finalize_kernel": lambda: bf.bn_finalize(s3, q3, p.g3, p.b3, count, 1e-5),
        "bn_finalize_plain": lambda: bf.bn_finalize_plain(s3, q3, p.g3, p.b3, count, 1e-5),
    }
    return {f"{name}_ms": median_ms(fn, device, reps) for name, fn in parts.items()}


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("iters", type=int, nargs="?", default=30)
    parser.add_argument("--parts", action="store_true",
                        help="also time each stats op against its library counterpart")
    parser.add_argument("--rows", type=int, default=128)
    parser.add_argument("--hw", type=int, default=56)
    parser.add_argument("--c", type=int, default=256)
    parser.add_argument("--cm", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="default: the card (raises without one); 'cpu' runs the plain "
                             "versions on the host clock")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    x, p = block_inputs(args.rows, args.hw, args.c, args.cm, args.seed, device)
    with torch.no_grad():
        blocks = time_blocks(x, p, args.iters, device)
        result = {f"{name}_ms_per_block": ms for name, ms in blocks.items()}
        for name in ("fused_taps", "fused_im2col"):
            result[f"{name}_vs_plain"] = blocks["plain"] / blocks[name]
        if args.parts:
            result.update(time_parts(x, p, device))
    result.update(rows=args.rows, hw=args.hw, c=args.c, cm=args.cm, iters=args.iters,
                  device=device.type,
                  card=card_line() if device.type == "cuda" else None,
                  timer="cuda events" if device.type == "cuda" else "host clock")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
