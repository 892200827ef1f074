"""The float64 witness of the 3xTF32 kernel, over seeds, on the card.

``tests/test_torch_port_cuda.py::test_tf32_kernel_error_within_the_emulations``
holds the float32 GEMM with statistics (``csrc/gemm_stats_tf32.cu``) to a
multiple of the error of its plain emulation (``ops/tf32.gemm_3xtf32``),
both against x @ w in float64. This script reads that ratio, the kernel's
largest error over the emulation's, at the test's shape (M = 8192, N = 256,
K = 64, 512 and 2048) for ``--seeds`` seeds, and the same ratio for a
variant of the kernel that accumulates all of K in one tensor-core
accumulator (no IEEE f32 add a k-step: the design the kernel's header
argues against). The variant is the kernel's source with three lines
changed and its namespace renamed, written and built under ``bdvcil_torch/_build/`` at run time; the
package never loads it. The test's factor lies between the kernel's largest
ratio and the variant's smallest.

    python -m bdvcil_torch.tf32_witness [--seeds 16]

Prints one JSON line and writes ``chiprun_out/tf32_witness.json``. Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

from .ops import _build, tf32
from .ops import conv1x1_bn as conv

M, N = 8192, 256
KS = (64, 512, 2048)
TEST_SEED = 18  # the card test's seed, read first

# the kernel's source -> the variant that accumulates all of K in one
# tensor-core accumulator: the first product of a k-step adds to acc instead
# of starting it afresh, acc is zeroed once a tile, and y is acc itself
ONE_ACCUMULATOR = (
    ("Wgmma<BN>::mma(acc, xs[kk], sm90::smem_desc(wb + kk * 32, 16, 1024), kk != 0);",
     "Wgmma<BN>::mma(acc, xs[kk], sm90::smem_desc(wb + kk * 32, 16, 1024), 1);"),
    ("for (int j = 0; j < BN / 2; ++j) sum[j] = __fadd_rn(sum[j], acc[j]);",
     "for (int j = 0; j < BN / 2; ++j) sum[j] = acc[j];"),
    ("for (int j = 0; j < BN / 2; ++j) sum[j] = 0.f;",
     "for (int j = 0; j < BN / 2; ++j) sum[j] = acc[j] = 0.f;"),
)


ENTRY_POINTS = ("bdv_gemm_stats_tf32", "bdv_gemm_affine_relu_stats_tf32",
                "bdv_conv3x3_affine_relu_stats_tf32", "bdv_gemm_stats_tf32_plan",
                "bdv_conv3x3_stats_tf32_plan", "bdv_cuda_error_string")


def build_variant(edits, tag: str) -> ctypes.CDLL:
    """Build ``gemm_stats_tf32.cu`` with each (old, new) of ``edits`` replaced
    (each old exactly once) and load it, typed as the kernel's own library,
    so that ``ops/conv1x1_bn._tf32_lib`` and ``ops/block_fused._tf32_lib``
    can be pointed at it. Built under ``bdvcil_torch/_build/``; the package
    never loads it."""
    src = (_build.CSRC / "gemm_stats_tf32.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"tf32 variant {tag}: the kernel's source no longer has {old!r}")
        src = src.replace(old, new)
    # a namespace of its own: the static flags of an inline launcher are one
    # per process across libraries (GNU unique symbols), so in the kernel's
    # namespace the variant would skip its own shared-memory attribute
    src = src.replace("tf32gemm", f"tf32gemm_{tag}")
    out = _build.BUILD_ROOT / f"tf32_{tag}"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"gemm_stats_tf32_{tag}.cu").write_text(src)
    so = out / f"libgemm_stats_tf32_{tag}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                    str(out / f"gemm_stats_tf32_{tag}.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    own = conv._tf32_lib()
    for fn in ENTRY_POINTS:
        getattr(lib, fn).argtypes = getattr(own, fn).argtypes
        getattr(lib, fn).restype = getattr(own, fn).restype
    lib._bdv_typed = True
    return lib


def variant_library() -> ctypes.CDLL:
    """The one-accumulator variant of ``gemm_stats_tf32.cu``, loaded. Read at
    the test's shape, whose tile is 128 columns wide: the kernel's one
    accumulator a warpgroup."""
    return build_variant(ONE_ACCUMULATOR, "one_acc")


def errors(k: int, seed: int, variant: ctypes.CDLL, dev: torch.device) -> dict:
    """The largest |y - x @ w in float64| of the kernel, the variant and the
    emulation, on the card test's operands at one K and seed."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, k), generator=g, device=dev)
    w = torch.randn((k, N), generator=g, device=dev) * k ** -0.5
    y64 = x.double() @ w.double()
    kernel = conv.gemm_with_stats_fwd(x, w)[0]
    own = conv._tf32_lib
    conv._tf32_lib = lambda: variant
    try:
        one_acc = conv.gemm_with_stats_fwd(x, w)[0]
    finally:
        conv._tf32_lib = own
    emulated = tf32.gemm_3xtf32(x, w)
    return {name: float((v.double() - y64).abs().max())
            for name, v in (("kernel", kernel), ("one_accumulator", one_acc),
                            ("emulation", emulated))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=16)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("tf32_witness: needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    assert not torch.backends.cuda.matmul.allow_tf32
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    variant = variant_library()
    seeds = [TEST_SEED] + [s for s in range(args.seeds) if s != TEST_SEED][:args.seeds - 1]
    rows, summary = [], {}
    for k in KS:
        ratios = {"kernel": [], "one_accumulator": []}
        for seed in seeds:
            e = errors(k, seed, variant, dev)
            rows.append(dict(k=k, seed=seed, **e))
            for name in ratios:
                ratios[name].append(e[name] / e["emulation"])
        summary[k] = {f"{name}_ratio_{f.__name__}": f(v) for name, v in ratios.items()
                      for f in (min, max)}
        print(f"K={k}: " + ", ".join(f"{key} {v:.4f}" for key, v in summary[k].items())
              + f" [{card}]", flush=True)
    result = dict(card=card, m=M, n=N, seeds=seeds, summary=summary, rows=rows)
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "tf32_witness.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(dict(card=card, seeds=seeds, summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
