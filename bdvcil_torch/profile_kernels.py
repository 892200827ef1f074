"""Split every hand-written kernel's device time by CUDA kernel, on the card.

Runs ``conv1x1_with_stats`` (#3, the kernel that also serves #4 and #6) at
the 12 1x1 shapes of one TSM-ResNet-50 train forward in configuration A, in
bf16 (the wgmma core) and in float32 (three TF32 products on the tensor
cores, ``csrc/gemm_stats_tf32.cu``: the GEMM, w's split and the statistics
finish),
``conv3x3_affine_relu_stats`` (#8), ``conv1x1_affine_relu_stats`` (#7,
the block's conv3), the block's tail (``bn_finalize`` at C and Cm,
``affine_residual_relu``) and the whole block forward
(``fused_bottleneck_fwd``, 128 frames) at the four stride-1 bottleneck
widths, the fused epilogue forward and backward (#1, #2) at the 4 shapes of
one configuration-B train forward (128 frames at 224², bf16), and the
temporal shift, forward and reverse (#5), at the pad path's 5 shifted block
inputs (bf16) and at (64, 28, 28, 512) f32, each ``--reps`` times under
``torch.profiler``. Prints, per shape,
the device time per launch of every CUDA kernel the wrapper starts (the GEMM
and the statistics finish), the wrapper's host time per call (``host``: the
host clock over ``--reps`` calls issued back to back, the card running
behind; for the block, the host time of its seven wrapper calls), and, from
the build's ``nvcc -Xptxas -v`` logs, each kernel's registers, shared
memory and spills; then one ``device`` line per kernel of the kernel table
(#1-#9b, #3 and #4 in float32, and #6-#9b in float32: the block's float32
kernels and the float32 block at layer1), its device ms summed over the same
run of its path as ``chip_smoke.py``'s kernels line times: #1-#3 one train
forward (#2 its backward) of batch 16, #4 and #5 one call a shape (#5
forward and reverse), #6-#9b one layer1 block; and #8 in bf16 at W = 64
(128 x 64 x 64, 64 -> 64: layer1 at a 256² input, two TMA boxes a window);
#8 and the block at layer1 of a 1280 x 720 clip of 8 frames (8 x 180 x 320:
the 3x3's window in three bands), bf16 and f32, and of a 1920 x 1080 one (8
x 270 x 480) in bf16; #9b at 6144 channels (a and b in shared memory) and
8192 (through the read-only cache) over layer1's 102.8M elements; and
train-mode BatchNorm's five kernels (``ops/batchnorm``, bf16, relu'd) at the
stem's and layer1's BatchNorm of batch 16 (``BN ...`` lines).

    python -m bdvcil_torch.profile_kernels [--reps 20]

Writes ``chiprun_out/profile_kernels.json``. Needs a GPU. The ``host #3``
lines sum the wrapper's host time over the 32 launches of one forward, in
bf16 and in float32; ``--host-of FILE`` prints them from a saved JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import re
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .ops import _build
from .ops import block_fused as bf
from .ops import conv1x1_bn as conv
from .ops import gemm_plan
from .ops import tsm_shift as tsm

SEGMENTS = 8
KERNEL_F32 = conv.KERNEL_F32
# the 1x1 shapes of tools/bench_gemm_stats.py, #4's path (M = 128 frames x H x W)
GEMM_SHAPES = ((128 * 56 * 56, 256, 64), (128 * 56 * 56, 64, 256), (128 * 28 * 28, 512, 128),
               (128 * 28 * 28, 128, 512), (128 * 14 * 14, 1024, 256), (128 * 14 * 14, 256, 1024),
               (128 * 7 * 7, 2048, 512), (128 * 7 * 7, 512, 2048))


def r50_block_shapes(nt: int = 128, size: int = 56):
    """Per TSM-ResNet-50 forward: the fused epilogue's (N*T, H, W, C) shapes
    (configuration B, one a block) and the pad path's shifted block inputs,
    each with its count."""
    fused, shifted = defaultdict(int), defaultdict(int)
    inplanes, planes = 64, 64
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for b in range(blocks):
            shifted[(nt, size, size, inplanes)] += 1
            size //= 2 if stage > 0 and b == 0 else 1
            fused[(nt, size, size, 4 * planes)] += 1
            inplanes = 4 * planes
        planes *= 2
    return fused, shifted


def device_ms(row) -> float:
    """A row's device ms per call: every CUDA kernel its wrapper starts."""
    return sum(v for k, v in row["us"].items() if k != "host") / 1e3


def ptxas_report(build_dir: pathlib.Path):
    """Per source: for each compiled function, its registers, shared memory and
    spill lines, as ``-Xptxas -v`` printed them."""
    out = {}
    for log in sorted(build_dir.glob("*.log")):
        funcs, current = {}, None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '([^']+)'|Function properties for (\S+)", line)
            if m:
                current = m.group(1) or m.group(2)
                funcs.setdefault(current, [])
            elif current and re.search(r"registers|spill|smem|stack", line):
                funcs[current].append(line.split("info    :")[-1].strip())
        out[log.stem] = {k: v for k, v in funcs.items() if v}
    return out


def host_us(fn, reps: int) -> float:
    """Host us per call of ``fn``, issued ``reps`` times without a sync (the
    launch queue holds them, so the host does not wait for the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def kernel_split(fn, reps: int):
    """Device us per call of each CUDA kernel that ``fn`` launches, and under
    ``host`` the host us per call."""
    for _ in range(3):
        fn()
    host = host_us(fn, reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"\w*_kernel\w*", e.name)
            per[m.group(0) if m else e.name[:60]] += e.time_range.end - e.time_range.start
    return {**{k: v / reps for k, v in per.items()}, "host": host}


def kernel_table(rows):
    """Device ms of each kernel-table row over its path (see the module docstring)."""
    def of(kernel, **match):
        return [r for r in rows if r["kernel"] == kernel
                and all(r.get(k) == v for k, v in match.items())]

    def per_path(kernel):
        return sum(device_ms(r) * r["per_forward"] for r in of(kernel))

    layer1 = dict(hw=56)
    conv = {tuple(r["shape"]): device_ms(r) for r in of("conv1x1_with_stats")}
    conv_f32 = {tuple(r["shape"]): device_ms(r) for r in of(KERNEL_F32)}
    finalize = {r["shape"][0]: device_ms(r) for r in of(bf.FINALIZE, **layer1)}
    c, cm = max(finalize), min(finalize)
    return {
        "#1 fused_residual_relu_shift_fwd": per_path(tsm.FWD),
        "#2 fused_residual_relu_shift_bwd": per_path(tsm.BWD),
        "#3 conv1x1_with_stats": per_path("conv1x1_with_stats"),
        "#4 gemm_with_stats": sum(conv[s] for s in GEMM_SHAPES),
        "#5 temporal_shift": sum(device_ms(r) for r in of(tsm.SHIFT)),
        "#6 block_conv1x1_stats": conv[GEMM_SHAPES[0]],
        "#7 conv1x1_affine_relu_stats": device_ms(of("conv1x1_affine_relu_stats")[0]),
        "#8 conv3x3_affine_relu_stats": device_ms(of("conv3x3_affine_relu_stats", **layer1)[0]),
        "#9 fused_bottleneck_fwd": device_ms(of("fused_bottleneck_fwd", dtype=None,
                                                **layer1)[0]),
        "#9a block_bn_finalize x3": finalize[c] + 2 * finalize[cm],
        "#9b block_affine_residual_relu": device_ms(of(bf.EPILOGUE, **layer1)[0]),
        "#3 f32 conv1x1_with_stats_f32": per_path(KERNEL_F32),
        "#4 f32 gemm_with_stats_f32": sum(conv_f32[s] for s in GEMM_SHAPES),
        "#6 f32 block_conv1x1_stats_f32": device_ms(of(bf.CONV1_F32)[0]),
        "#7 f32 conv1x1_affine_relu_stats_f32": device_ms(of(bf.CONV3_F32)[0]),
        "#8 f32 conv3x3_affine_relu_stats_f32": device_ms(of(bf.CONV2_F32)[0]),
        "#9b f32 block_affine_residual_relu_f32": device_ms(of(bf.EPILOGUE_F32)[0]),
        "#9 f32 fused_bottleneck_fwd": device_ms(of("fused_bottleneck_fwd", dtype="float32")[0]),
        "#8 bf16 W=64 conv3x3_affine_relu_stats": device_ms(of("conv3x3_affine_relu_stats",
                                                              hw=64)[0]),
        **{f"{label} {r['kernel']} {r['shape']}": device_ms(r)
           for r in rows if (label := r.get("wide") or r.get("bn"))},
    }


def host_per_forward(rows):
    """The wrapper's host ms of #3 over one forward's launches, bf16 and f32."""
    return {kernel: sum(r["us"]["host"] * r["per_forward"] for r in rows
                        if r["kernel"] == kernel) / 1e3
            for kernel in ("conv1x1_with_stats", KERNEL_F32)}


def print_host(rows, card):
    for kernel, ms in host_per_forward(rows).items():
        print(f"host #3 {kernel}: {ms:.4f} ms a forward [{card}]", flush=True)


def f32_block_rows(gen, dev, reps):
    """The block's float32 kernels (#6, #7, #8, #9b) and the float32 block at
    layer1 (128 x 56 x 56, 256 -> 64 -> 64 -> 256), and #8 in bf16 at W = 64."""
    nt, hw, c, cm = 128, 56, 256, 64
    rows, f32 = [], torch.float32
    x = torch.randn((nt, hw, hw, c), generator=gen, device=dev)
    y = torch.randn((nt, hw, hw, cm), generator=gen, device=dev)
    a = torch.rand((cm,), generator=gen, device=dev) + 0.5
    b = torch.rand((cm,), generator=gen, device=dev) * 0.5 + 0.1
    p = bf.make_params(torch.Generator().manual_seed(0), c=c, cm=cm, dtype=f32, device=dev)
    w1, w2, w3 = p.w1.contiguous(), p.w2.contiguous(), p.w3.contiguous()
    y3 = torch.randn((nt, hw, hw, c), generator=gen, device=dev)  # its own bytes, not x's
    a3, b3 = torch.rand((c,), generator=gen, device=dev) + 0.5, p.b3
    calls = [(bf.CONV1_F32, [nt * hw * hw, c, cm], lambda: bf.conv1x1_stats(x, w1)),
             (bf.CONV3_F32, [nt * hw * hw, cm, c], lambda: bf.conv1x1_affine_relu_stats(
                 y, a, b, w3)),
             (bf.CONV2_F32, [nt, hw, hw, cm, cm], lambda: bf.conv3x3_affine_relu_stats(
                 y, a, b, w2)),
             (bf.EPILOGUE_F32, [nt, hw, hw, c], lambda: bf.affine_residual_relu(y3, a3, b3, x)),
             ("fused_bottleneck_fwd", [nt, hw, hw, c, cm], lambda: bf.fused_bottleneck_fwd(x, p))]
    for name, shape, fn in calls:
        rows.append(dict(kernel=name, shape=shape, dtype="float32", hw=hw,
                         us=kernel_split(fn, reps)))
    del x, y, y3, p, w1, w2, w3
    wide = 64  # #8 in bf16 at W = 64: its window in two TMA boxes
    yb = torch.randn((nt, wide, wide, cm), generator=gen, device=dev).to(torch.bfloat16)
    w2b = (torch.randn((3, 3, cm, cm), generator=gen, device=dev) / math.sqrt(9 * cm)).to(
        torch.bfloat16)
    rows.append(dict(kernel="conv3x3_affine_relu_stats", shape=[nt, wide, wide, cm, cm],
                     hw=wide, plan=gemm_plan.conv3x3_kernel_plan(nt * wide * wide, cm, wide, cm,
                                                                 dev)._asdict(),
                     us=kernel_split(lambda: bf.conv3x3_affine_relu_stats(yb, a, b, w2b), reps)))
    del yb, w2b
    torch.cuda.empty_cache()
    return rows


# layer1 of a 1280 x 720 and of a 1920 x 1080 clip of 8 frames, (NT, H, W),
# with the dtypes run at each; #9b's channel counts over layer1's elements
HD_LAYER1 = {"720p": ((8, 180, 320), (torch.bfloat16, torch.float32)),
             "1080p": ((8, 270, 480), (torch.bfloat16,))}
WIDE_TAIL = {6144: (torch.bfloat16,), 8192: (torch.bfloat16, torch.float32)}


def wide_rows(gen, dev, reps):
    """#8 (64 -> 64) and the block (256 -> 64 -> 64 -> 256) at layer1 of a
    720p and a 1080p clip; #9b at 6144 and 8192 channels. Each row's ``wide``
    labels its ``device`` line."""
    rows, c, cm = [], 256, 64
    for res, ((nt, h, w_), dtypes) in HD_LAYER1.items():
        for dtype in dtypes:
            tag = "#8 f32" if dtype == torch.float32 else "#8 bf16"
            y = torch.randn((nt, h, w_, cm), generator=gen, device=dev).to(dtype)
            a = torch.rand((cm,), generator=gen, device=dev) + 0.5
            b = torch.rand((cm,), generator=gen, device=dev) * 0.5 + 0.1
            w2 = (torch.randn((3, 3, cm, cm), generator=gen, device=dev)
                  / math.sqrt(9 * cm)).to(dtype)
            rows.append(dict(kernel=conv.launch_name(bf.CONV2, dtype, dtype),
                             shape=[nt, h, w_, cm, cm], wide=f"{tag} {res}",
                             us=kernel_split(lambda: bf.conv3x3_affine_relu_stats(y, a, b, w2),
                                             reps)))
            del y, w2
            x = torch.randn((nt, h, w_, c), generator=gen, device=dev).to(dtype)
            p = bf.make_params(torch.Generator().manual_seed(0), c=c, cm=cm, dtype=dtype,
                               device=dev)
            rows.append(dict(kernel="fused_bottleneck_fwd", shape=[nt, h, w_, c, cm],
                             wide=f"#9{tag[2:]} {res}",
                             us=kernel_split(lambda: bf.fused_bottleneck_fwd(x, p), reps)))
            del x, p
            torch.cuda.empty_cache()
    elements = 128 * 56 * 56 * 256
    for ch, dtypes in WIDE_TAIL.items():
        for dtype in dtypes:
            shape = (elements // ch, ch)
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            y = torch.randn(shape, generator=gen, device=dev).to(dtype)
            a = torch.rand((ch,), generator=gen, device=dev) + 0.5
            b = torch.randn((ch,), generator=gen, device=dev) * 0.5
            tag = "#9b f32" if dtype == torch.float32 else "#9b"
            rows.append(dict(kernel=conv.launch_name(bf.EPILOGUE, dtype, dtype),
                             shape=list(shape), wide=f"{tag} C={ch}",
                             us=kernel_split(lambda: bf.affine_residual_relu(y, a, b, x), reps)))
            del x, y
    torch.cuda.empty_cache()
    return rows


# (N*T, C, H, W) of train-mode BatchNorm's kernel-table rows: the stem's and
# layer1's bn2 at batch 16 (chip_smoke.BN_SHAPES)
BN_SHAPES = {"stem": (128, 64, 112, 112), "layer1": (128, 64, 56, 56)}


def batchnorm_rows(gen, dev, reps):
    """Train-mode BatchNorm's five kernels (bf16, relu'd) at BN_SHAPES, one
    row a kernel and shape; ``bn`` labels its ``device`` line."""
    from .models.norm import BatchNorm
    from .ops import batchnorm as bn_ops

    rows = []
    for path, shape in BN_SHAPES.items():
        n, c = shape[0] * shape[2] * shape[3], shape[1]
        x, g = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last) for _ in range(2))
        bn = BatchNorm(c, dtype=torch.bfloat16).to(dev)
        spec = bn_ops._Spec(False, True, torch.bfloat16, float(n), bn.epsilon, 1, False)
        k = bn_ops._Kernels(x, 1)
        s1, s2 = k.stats(x, 1)
        coef = k.finalize(s1, s2, spec.count, bn, spec)
        sg, sgx = k.bwd_reduce(g, x, coef, spec)
        calls = {bn_ops.STATS: lambda: k.stats(x, 1),
                 bn_ops.FINALIZE: lambda: k.finalize(s1, s2, spec.count, bn, spec),
                 bn_ops.APPLY: lambda: k.apply(x, coef, spec),
                 bn_ops.BWD_REDUCE: lambda: k.bwd_reduce(g, x, coef, spec),
                 bn_ops.BWD_DX: lambda: k.bwd_dx(g, x, coef, sg, sgx, spec.count, spec)}
        for name, fn in calls.items():
            rows.append(dict(kernel=name, shape=list(shape), bn=f"BN {path}",
                             us=kernel_split(fn, reps)))
        del x, g
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--host-of", type=pathlib.Path, default=None,
                        help="print the host #3 lines of a saved profile_kernels.json")
    args = parser.parse_args(argv)
    if args.host_of is not None:
        saved = json.loads(args.host_of.read_text())
        print_host(saved["rows"], saved["card"])
        return 0
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    rows = []
    for (m, k, n), count in sorted(gemm_plan.r50_1x1_shapes().items()):
        x = torch.randn((m, 1, 1, k), generator=gen, device=dev).to(bf16)
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(bf16)
        split = kernel_split(lambda: conv.conv1x1_with_stats_fwd(x, w), args.reps)
        rows.append(dict(kernel="conv1x1_with_stats", shape=[m, k, n], per_forward=count,
                         plan=gemm_plan.kernel_plan(m, k, n, dev)._asdict(), us=split))
        # the float32 kernel: 3xTF32 on operands with all 24 bits of f32
        xf = torch.randn((m, 1, 1, k), generator=gen, device=dev)
        wf = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        split = kernel_split(lambda: conv.conv1x1_with_stats_fwd(xf, wf), args.reps)
        rows.append(dict(kernel=KERNEL_F32, shape=[m, k, n], per_forward=count,
                         plan=gemm_plan.tf32_kernel_plan(m, n, dev)._asdict(), us=split))
        del x, w, xf, wf
    for nt, h, w_, c, n in gemm_plan.R50_3X3_SHAPES:
        x = torch.randn((nt, h, w_, c), generator=gen, device=dev).to(bf16)
        a = torch.rand((c,), generator=gen, device=dev) + 0.5
        b = torch.rand((c,), generator=gen, device=dev) * 0.5 + 0.1
        w = (torch.randn((3, 3, c, n), generator=gen, device=dev) / math.sqrt(9 * c)).to(bf16)
        split = kernel_split(lambda: bf.conv3x3_affine_relu_stats(x, a, b, w), args.reps)
        rows.append(dict(kernel="conv3x3_affine_relu_stats", shape=[nt, h, w_, c, n], hw=h,
                         plan=gemm_plan.conv3x3_kernel_plan(nt * h * w_, n, w_, c,
                                                            dev)._asdict(), us=split))
        del x, a, b, w
    with torch.no_grad():
        rows += f32_block_rows(gen, dev, args.reps)
    for m, k, n in gemm_plan.R50_1X1_AFFINE_SHAPES:  # #7, the block's conv3, at each width
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        a = torch.rand((k,), generator=gen, device=dev) + 0.5
        b = torch.rand((k,), generator=gen, device=dev) * 0.5 + 0.1
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(bf16)
        split = kernel_split(lambda: bf.conv1x1_affine_relu_stats(x, a, b, w), args.reps)
        rows.append(dict(kernel="conv1x1_affine_relu_stats", shape=[m, k, n],
                         plan=gemm_plan.kernel_plan(m, k, n, dev)._asdict(), us=split))
        del x, a, b, w
    for nt, h, w_, cm, _ in gemm_plan.R50_3X3_SHAPES:  # the block's tail and the block
        c = 4 * cm
        tail = dict(hw=h)
        x = torch.randn((nt, h, w_, c), generator=gen, device=dev).to(bf16)
        y = torch.randn((nt, h, w_, c), generator=gen, device=dev).to(bf16)
        a = torch.rand((c,), generator=gen, device=dev) + 0.5
        b = torch.randn((c,), generator=gen, device=dev) * 0.5
        split = kernel_split(lambda: bf.affine_residual_relu(y, a, b, x), args.reps)
        rows.append(dict(kernel=bf.EPILOGUE, shape=[nt, h, w_, c], us=split, **tail))
        yf = x.float()
        for width in (c, cm):
            s, q = yf[..., :width].sum((0, 1, 2)), (yf[..., :width] ** 2).sum((0, 1, 2))
            split = kernel_split(lambda: bf.bn_finalize(s, q, a[:width], b[:width],
                                                        float(nt * h * w_), 1e-5), args.reps)
            rows.append(dict(kernel=bf.FINALIZE, shape=[width], us=split, **tail))
        del y, yf
        p = bf.make_params(torch.Generator().manual_seed(0), c=c, cm=cm, device=dev)
        with torch.no_grad():
            split = kernel_split(lambda: bf.fused_bottleneck_fwd(x, p), args.reps)
        rows.append(dict(kernel="fused_bottleneck_fwd", shape=[nt, h, w_, c, cm], us=split,
                         **tail))
        del x, a, b, p
    fused, shifted = r50_block_shapes()
    for shape, count in sorted(fused.items()):  # #1 and #2 at configuration B's shapes
        h, idt, g_out, g_sh = (torch.randn(shape, generator=gen, device=dev).to(bf16)
                               for _ in range(4))
        out, _ = tsm.fused_fwd(h, idt, SEGMENTS, 8)
        split = kernel_split(lambda: tsm.fused_fwd(h, idt, SEGMENTS, 8), args.reps)
        rows.append(dict(kernel=tsm.FWD, shape=list(shape), per_forward=count, us=split))
        split = kernel_split(lambda: tsm.fused_bwd(out, g_out, g_sh, SEGMENTS, 8), args.reps)
        rows.append(dict(kernel=tsm.BWD, shape=list(shape), per_forward=count, us=split))
        del h, idt, g_out, g_sh, out
    shift_shapes = [(s, bf16) for s in sorted(shifted)] + [((64, 28, 28, 512), torch.float32)]
    for shape, dtype in shift_shapes:  # #5, forward and reverse, one call each
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        split = kernel_split(lambda: (tsm.shift_fwd(x, SEGMENTS, 8),
                                      tsm.shift_fwd(x, SEGMENTS, 8, reverse=True)), args.reps)
        rows.append(dict(kernel=tsm.SHIFT, shape=list(shape), dtype=str(dtype), us=split))
        del x
    with torch.no_grad():
        rows += batchnorm_rows(gen, dev, args.reps)
        rows += wide_rows(gen, dev, args.reps)  # last: kernel_table reads earlier rows first
    for r in rows:
        parts = ", ".join(f"{k} {v:.1f} us" for k, v in sorted(r["us"].items()))
        print(f"{r['kernel']} {r['shape']}: {parts}", flush=True)
    table = kernel_table(rows)
    for name, ms in table.items():
        print(f"device {name}: {ms:.4f} ms [{card}]", flush=True)
    print_host(rows, card)
    report = ptxas_report(_build.build_all())
    for src, funcs in report.items():
        for fn, lines in funcs.items():
            print(f"ptxas {src} {fn[:90]}: {' | '.join(lines)}", flush=True)
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "profile_kernels.json").write_text(json.dumps(
        dict(card=card, sm_count=sms, reps=args.reps, rows=rows, table=table, ptxas=report),
        indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
