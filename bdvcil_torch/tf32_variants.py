"""Where the 3xTF32 kernel's time goes at the block's float32 shapes, on the card.

Times ``csrc/gemm_stats_tf32.cu``'s stats kernel (device time, from
``torch.profiler``) at #8 f32 (``conv3x3_affine_relu_stats``) and #7 f32
(``conv1x1_affine_relu_stats``) at the four stride-1 ResNet-50 widths (128
frames), beside variants of the kernel that each leave one part of the work
out, built at run time from its source (``tf32_witness.build_variant``):

  one_product   a k-step's 12 wgmma cut to big x big's 4
  no_split      A's split left out: big = v, small = 0 (two roundings and a
                subtraction a value and k-step fewer)
  no_prologue   the 3x3's window prologue left out (#7's is kept)

A variant computes the wrong y; its time says what its part costs. Each
case runs the kernel and the variants in turns, then again in reverse
order, in one process on one card.

    python -m bdvcil_torch.tf32_variants [--reps 20]

Prints one line a case and writes ``chiprun_out/tf32_variants.json``. Needs a
GPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import pathlib
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from .ops import block_fused as bf
from .ops import conv1x1_bn as conv
from .ops import gemm_plan
from .tf32_witness import build_variant

PRODUCTS = ("Wgmma<BN>::mma(acc, xs[kk], sm90::smem_desc(wb + kk * 32, 16, 1024), kk != 0);",
            "Wgmma<BN>::mma(acc, xb[kk], sm90::smem_desc(ws + kk * 32, 16, 1024), 1);",
            "Wgmma<BN>::mma(acc, xb[kk], sm90::smem_desc(wb + kk * 32, 16, 1024), 1);")
VARIANTS = {
    "one_product": ((PRODUCTS[0], ";"), (PRODUCTS[1], ";"),
                    (PRODUCTS[2], PRODUCTS[2].replace("), 1);", "), kk != 0);"))),
    "no_split": (("const float b = to_tf32(v);", "const float b = v;"),
                 ("small[kk][e] = __float_as_uint(to_tf32(__fsub_rn(v, b)));",
                  "small[kk][e] = 0u;")),
    "no_prologue": (("window_prologue(window(wi), ab_of(wi), m0, ct, p);", ""),),
}
KERNEL = "tf32_stats_kernel"


def device_us(fn, reps: int) -> float:
    """The stats kernel's device us a call, over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages() if KERNEL in e.key)
    return total / reps


def cases(dev):
    """(name, call) of #8 and #7 in float32 at the stride-1 R50 widths."""
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for nt, h, w_, c, n in gemm_plan.R50_3X3_SHAPES:
        x = torch.randn((nt, h, w_, c), generator=g, device=dev)
        a = torch.rand((c,), generator=g, device=dev) + 0.5
        b = torch.rand((c,), generator=g, device=dev) * 0.5 + 0.1
        w = torch.randn((3, 3, c, n), generator=g, device=dev) / (9 * c) ** 0.5
        out.append((f"#8 {nt}x{h}x{w_}x{c}x{n}",
                    lambda x=x, a=a, b=b, w=w: bf.conv3x3_affine_relu_stats(x, a, b, w)))
    for m, k, n in gemm_plan.R50_1X1_AFFINE_SHAPES:
        x = torch.randn((m, k), generator=g, device=dev)
        a = torch.rand((k,), generator=g, device=dev) + 0.5
        b = torch.rand((k,), generator=g, device=dev) * 0.5 + 0.1
        w = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
        out.append((f"#7 {m}x{k}x{n}",
                    lambda x=x, a=a, b=b, w=w: bf.conv1x1_affine_relu_stats(x, a, b, w)))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("tf32_variants: needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    libs = {"kernel": conv._tf32_lib()}
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = {name: pool.submit(build_variant, edits, name) for name, edits in VARIANTS.items()}
        libs.update({name: f.result() for name, f in built.items()})
    own = conv._tf32_lib
    rows = []
    try:
        for name, fn in cases(dev):
            us = {v: [] for v in libs}
            for order in (list(libs), list(libs)[::-1]):
                for v in order:
                    conv._tf32_lib = bf._tf32_lib = (lambda lib=libs[v]: lib)
                    us[v].append(device_us(fn, args.reps))
            row = dict(case=name, **{f"{v}_us": sum(t) / len(t) for v, t in us.items()})
            rows.append(row)
            print(f"{name}: " + ", ".join(f"{v} {row[f'{v}_us']:.1f} us" for v in libs)
                  + f" [{card}]", flush=True)
    finally:
        conv._tf32_lib = bf._tf32_lib = own
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "tf32_variants.json").write_text(json.dumps(dict(card=card, reps=args.reps,
                                                            rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
