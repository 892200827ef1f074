"""The float64 witness of the bf16 wgmma core's deep products, on the card.

``csrc/gemm_stats_sm90.cuh`` sums at most ``kWholeSteps`` k-steps (K = 4608)
in one tensor-core accumulator; a deeper product restarts it every 8
k-steps and adds the chunks in IEEE f32, because the tensor cores' own f32
sum drifts as K grows. This script reads the kernel's largest error against
the product in float64, in bf16 ulps of the reference (the ulp taken at no
less than 1/256 of its rms, as the card tests take it), for the 1x1
(``bdv_conv1x1_with_stats``, M = 4096, N = 512, x in [0, 1)) at K = 2048 ..
36864 and for the 3x3 (``bdv_conv3x3_affine_relu_stats``, 1 x 5 x 56, Cin
1024 and 2048, Cout 512), beside a variant of the kernel that sums all of K
in one accumulator (``kWholeSteps`` raised past any K: the kernel as it was
before it took deep products apart). The variant is the kernel's source
with that line changed and its namespace renamed, written and built under
``bdvcil_torch/_build/`` at run time; the package never loads it.

    python -m bdvcil_torch.bf16_witness

Prints one line a case and writes ``chiprun_out/bf16_witness.json``. Needs a
GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

from .ops import _build
from .ops import block_fused as bf
from .ops import conv1x1_bn as conv

M, N = 4096, 512
KS = (2048, 4608, 4672, 9216, 18432, 36864)
CINS = (1024, 2048)  # the 3x3's K = 9 Cin: 9216, 18432 (a and b staged)
ONE_ACCUMULATOR = ("constexpr int kWholeSteps = 72;", "constexpr int kWholeSteps = 1 << 30;")


def build_variant(stem: str, typed: ctypes.CDLL) -> ctypes.CDLL:
    """``csrc/<stem>.cu`` on the header with ONE_ACCUMULATOR applied and the
    namespace renamed (an inline launcher's static flags are one per process
    across libraries), loaded and typed as ``typed``, the kernel's own."""
    header = (_build.CSRC / "gemm_stats_sm90.cuh").read_text()
    if header.count(ONE_ACCUMULATOR[0]) != 1:
        raise RuntimeError(f"bf16 variant: the header no longer has {ONE_ACCUMULATOR[0]!r}")
    out = _build.BUILD_ROOT / "bf16_one_acc"
    out.mkdir(parents=True, exist_ok=True)
    for name, text in (("gemm_stats_sm90.cuh", header.replace(*ONE_ACCUMULATOR)),
                       (f"{stem}.cu", (_build.CSRC / f"{stem}.cu").read_text())):
        (out / name).write_text(re.sub(r"\bsm90\b", "sm90_one_acc", text))
    so = out / f"lib{stem}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(out), "-o", str(so),
                    str(out / f"{stem}.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("bdv_conv1x1_with_stats", "bdv_conv3x3_affine_relu_stats"):
        if hasattr(typed, fn):
            getattr(lib, fn).argtypes = getattr(typed, fn).argtypes
            getattr(lib, fn).restype = getattr(typed, fn).restype
    return lib


def ulps(y: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |y - ref| in bf16 ulps of ref, |ref| floored at 1/256 of
    its rms."""
    floor = float(ref.pow(2).mean().sqrt()) / 256
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=floor))) - 7)
    return float(((y.double() - ref).abs() / ulp).max())


def run(lib, fn: str, dev, *args) -> None:
    code = getattr(lib, fn)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{fn}: error {code}")


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_witness: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    sms = conv.sm_count(dev)
    libs = {"kernel": (conv._lib(), bf._conv3x3_lib())}
    libs["one accumulator"] = tuple(build_variant(stem, own) for stem, own in
                                    (("conv1x1_stats", libs["kernel"][0]),
                                     ("conv3x3_stats", libs["kernel"][1])))
    part = torch.empty((2, sms, N), device=dev)
    stats = torch.empty((2, N), device=dev)
    rows = []
    for k in KS:
        g = torch.Generator(device=dev).manual_seed(k)
        x = torch.rand((M, k), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, N), generator=g, device=dev) * k ** -0.5).to(torch.bfloat16)
        ref = x.double() @ w.double()
        row = dict(case="1x1", k=k)
        for name, (lib, _) in libs.items():
            y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
            run(lib, "bdv_conv1x1_with_stats", dev, x.data_ptr(), w.data_ptr(), y.data_ptr(),
                part.data_ptr(), sms, stats.data_ptr(), M, k, N)
            row[name] = ulps(y, ref)
        rows.append(row)
        del x, w, ref
    for cin in CINS:
        nt, h, w_ = 1, 5, 56
        g = torch.Generator(device=dev).manual_seed(cin)
        x = torch.randn((nt, h, w_, cin), generator=g, device=dev).to(torch.bfloat16)
        a = torch.rand((cin,), generator=g, device=dev) + 0.5
        b = torch.rand((cin,), generator=g, device=dev) * 0.5 + 0.1
        w2 = (torch.randn((3, 3, cin, N), generator=g, device=dev)
              * (9 * cin) ** -0.5).to(torch.bfloat16)
        xp = torch.nn.functional.pad(bf.affine_relu(x, a, b).double(), (0, 0, 1, 1, 1, 1))
        ref = sum(xp[:, dy:dy + h, dx:dx + w_, :] @ w2[dy, dx].double()
                  for dy in range(3) for dx in range(3))
        row = dict(case="3x3", k=9 * cin)
        for name, (_, lib) in libs.items():
            y = torch.empty((nt, h, w_, N), dtype=torch.bfloat16, device=dev)
            run(lib, "bdv_conv3x3_affine_relu_stats", dev, x.data_ptr(), w2.data_ptr(),
                a.data_ptr(), b.data_ptr(), y.data_ptr(), part.data_ptr(), sms,
                stats.data_ptr(), nt, h, w_, cin, N)
            row[name] = ulps(y, ref)
        rows.append(row)
        del x, w2, xp, ref
    for row in rows:
        print(f"bf16 witness {row['case']} K={row['k']}: kernel {row['kernel']:.3f} ulp, one "
              f"accumulator {row['one accumulator']:.3f} ulp of float64 [{card}]", flush=True)
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "bf16_witness.json").write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
