"""Cost of each op family of the port's device RandAugment (the port of
``tools/bench_randaug.py``).

Times ``ops/rand_augment_dev.rand_augment_batch`` (n = 2, m = 10) on a
batch of 16 clips x 8 frames x 224² uint8 on the card, each call on the last
call's output with the same draws (``draw_randaug`` from a seeded
generator), ``--steps`` calls after one warm call, CUDA-synchronized on the
host clock. Then the same with each op family replaced by the identity, and
a family's cost is the full time less the time without it. A family is
replaced by mapping its op ids in the draws to the identity (op 0), which
``rand_augment_batch`` never computes: the clips that drew it pass through
that round untouched, as in the JAX tool's rebuild. The families and their
op ids are the JAX tool's (``OP_TABLE``'s order is the same in both
packages).

The line: ``full_n2`` ms a call, ``rebuilt_full`` (the draws through the
mapping with nothing skipped), each family's ms as ``no_<family>`` and its
cost as ``cost:<family>``, with the shape, the card's name and power limit.

    python -m bdvcil_torch.bench_randaug [--batch 16] [--steps 20]

``--device cpu`` with a small ``--size`` rehearses it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import bench_train
from ._device import resolve_device
from .ops.rand_augment_dev import DRAW_KEYS, GEO_IDS, OP_TABLE, draw_randaug, rand_augment_batch

N, M = 2, 10
_ID = {name: i for i, (name, _, _) in enumerate(OP_TABLE)}
PHOTOMETRIC = ("AutoContrast", "Equalize", "Solarize", "Color", "Contrast", "Brightness",
               "Sharpness", "Posterize", "CutoutAbs")
# family -> the op ids it replaces (tools/bench_randaug.py:97-108)
FAMILIES = {
    "no_equalize": {_ID["Equalize"]},
    "no_autocontrast": {_ID["AutoContrast"]},
    "no_solarize_posterize": {_ID["Solarize"], _ID["Posterize"]},
    "no_color": {_ID["Color"]},
    "no_contrast": {_ID["Contrast"]},
    "no_brightness": {_ID["Brightness"]},
    "no_sharpness": {_ID["Sharpness"]},
    "no_cutout": {_ID["CutoutAbs"]},
    "no_geo": set(GEO_IDS),
    "photometric_none": {_ID[name] for name in PHOTOMETRIC},
}


def without(draws, skip):
    """The draws with the op ids in ``skip`` replaced by the identity."""
    ops, sign, x0, y0 = draws
    return np.where(np.isin(ops, sorted(skip)), 0, ops), sign, x0, y0


def bench_batch(batch: int, segments: int, size: int, device: torch.device):
    """(uint8 clips (B, T, H, W, 3) on ``device``, the host draws) from seed 0."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, size=(batch, segments, size, size, 3), dtype=np.uint8)
    draws = draw_randaug(torch.Generator().manual_seed(0), batch, N, size, size)
    return torch.from_numpy(imgs).to(device), tuple(draws[k].numpy() for k in DRAW_KEYS)


def timed_ms(draws, imgs, steps: int, device: torch.device) -> float:
    """ms a call of ``steps`` chained calls, after one warm call."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    out = rand_augment_batch(imgs, *draws, m=M)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = rand_augment_batch(out, *draws, m=M)
    sync()
    return (time.perf_counter() - t0) / steps * 1e3


def run(args) -> dict:
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    imgs, draws = bench_batch(args.batch, args.segments, args.size, device)
    out = {"full_n2": timed_ms(draws, imgs, args.steps, device)}
    base = out["rebuilt_full"] = timed_ms(without(draws, set()), imgs, args.steps, device)
    for name, skip in FAMILIES.items():
        out[name] = timed_ms(without(draws, skip), imgs, args.steps, device)
        out[f"cost:{name[3:] if name.startswith('no_') else name}"] = base - out[name]
    out.update(unit="ms a call", steps=args.steps,
               shape=dict(batch=args.batch, segments=args.segments, size=args.size),
               device=torch.cuda.get_device_name(device) if cuda else str(device),
               card=bench_train.card_line() if cuda else None)
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="default: the card")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--segments", type=int, default=8)
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--steps", type=int, default=20)
    return parser


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
