"""End-to-end inference throughput of the port on one card (the port of
``bench.py``'s ``bench_eval_e2e``, ``bench.py:826-940``).

The shipping inference path: ``FastEvalLoader`` (the native decode pool to a
uint8 batch) -> ``runtime.loops.run_inference`` (pinned staging, the copy to
the card, K batches a call through ``make_multi_eval_step``) -> the normalize
(and TenCrop's crops and flips) on the card -> TSM-ResNet-50 at 8 x 224²,
bf16, random weights from seed 0 -> the scores back on the host in dataset
order. The corpus is ``bench_train``'s (``data/corpus.py``: 64 videos of 16
frames at 320 x 240, under ``--corpus``).

Two protocols: centre crop 1 x 8 on wire 'auto' (rgb), the model zoo's
inference protocol, whose yardstick is the reference's 74 videos/s over 8
GPUs; and TenCrop on 'auto' (``yuv420_full``: each frame resized once, the
ten crops cut on the card), the CIL testing protocol; then TenCrop on the
rgb wire unless ``--skip-rgb``. Each runs one warm call, one untimed settle
pass, then ``--measures`` timed sweeps of the fewest whole passes over the
corpus that hold ``--steps`` batches, each through one ``run_inference``
call; the rate is the upper median sweep's videos/s (``bench.py``'s pick).
Every sweep returns passes x videos rows, and every score is finite.

    python -m bdvcil_torch.bench_eval [--config A|B|default] [--k 8] [--steps 40]
                                      [--measures 3] [--skip-rgb]

``--device cpu`` with small shapes rehearses it on the CPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import numpy as np
import torch

from . import bench_train
from ._device import resolve_device
from .data import corpus, native
from .data.loaders import FastEvalLoader
from .runtime import make_eval_step, make_multi_eval_step
from .runtime.loops import run_inference

METRIC = "e2e_eval_videos_per_sec_tsm_r50_8x224"
BASELINE_VIDEOS_PER_SEC = 74.0 / 8.0  # the reference's inference rate a GPU (bench.py:927)


def video_infos(args):
    """The corpus's eval infos (written once under ``--corpus``)."""
    if args.source != "jpeg":
        raise ValueError("the eval bench decodes the corpus: it has no --source "
                         f"{args.source}")
    if not native.available():
        raise RuntimeError(f"native decoder unavailable: {native.build_error()}")
    return corpus.write_corpus(args.corpus, args.videos, args.frames, seed=0,
                               num_classes=bench_train.NUM_CLASSES)[0]


def make_loader(infos, args, tencrop: bool, wire: str) -> FastEvalLoader:
    return FastEvalLoader(infos, batch_size=args.batch, num_segments=args.segments,
                          crop_size=args.size, short_side=int(round(args.size / 0.875)),
                          tencrop=tencrop, num_workers=args.workers, prefetch=2,
                          process_index=0, process_count=1, wire_format=wire)


def measure(spec, module, loader, args, device: torch.device):
    """(the upper median sweep's videos/s, the sweeps' rates, the last sweep's
    outputs, the forwards run) of ``loader`` through ``run_inference``."""
    videos = len(loader.video_infos)
    passes = max(1, -(-args.steps // len(loader)))
    kwargs = dict(device=device, steps_per_dispatch=args.k,
                  multi_eval_step=(make_multi_eval_step(spec, bench_train.NUM_CLASSES, args.k)
                                   if args.k > 1 else None))
    eval_step = make_eval_step(spec, bench_train.NUM_CLASSES)

    def stream(n):
        return itertools.chain.from_iterable(iter(loader) for _ in range(n))

    warm = max(1, args.k // len(loader) + 1)  # every K-group shape once, the cache filled
    run_inference(eval_step, module, stream(warm), **kwargs)
    run_inference(eval_step, module, stream(1), **kwargs)  # settle
    rates, out = [], None
    for _ in range(args.measures):
        t0 = time.perf_counter()
        out = run_inference(eval_step, module, stream(passes), **kwargs)
        dt = time.perf_counter() - t0
        if out["cls_score"].shape[0] != passes * videos:
            raise AssertionError(f"{out['cls_score'].shape[0]} rows from {passes} passes over "
                                 f"{videos} videos")
        if not np.isfinite(out["cls_score"]).all():
            raise AssertionError("non-finite scores in the eval bench")
        rates.append(passes * videos / dt)
    forwards = (warm + 1 + args.measures * passes) * len(loader)
    return sorted(rates)[len(rates) // 2], rates, out, forwards


def run(args) -> dict:
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    infos = video_infos(args)
    spec, module = bench_train.build_bench_model(args, device)
    protocols = [("center", False, "auto"), ("tencrop", True, "auto")]
    if native.has_yuv420_full() and not args.skip_rgb:
        protocols.append(("rgb_tencrop", True, "rgb"))
    rates, sweeps, wires, forwards, rows = {}, {}, {}, {}, {}
    for name, tencrop, wire in protocols:
        loader = make_loader(infos, args, tencrop, wire)
        rates[name], sweeps[name], out, forwards[name] = measure(spec, module, loader, args,
                                                                 device)
        wires[name], rows[name] = loader.wire_format, int(out["cls_score"].shape[0])
    result = {
        "metric": METRIC,
        "value": rates["center"],
        "unit": "videos/s",
        "vs_baseline": rates["center"] / BASELINE_VIDEOS_PER_SEC,
        "tencrop_videos_per_sec": rates["tencrop"],
        "tencrop_wire": wires["tencrop"],
    }
    if "rgb_tencrop" in rates:
        result["rgb_wire_tencrop_videos_per_sec"] = rates["rgb_tencrop"]
    result.update({
        "sweep_rates": sweeps,
        "wires": wires,
        "rows": rows,
        "forwards": forwards,
        "k": args.k,
        "config": args.config,
        "shape": dict(batch=args.batch, segments=args.segments, size=args.size,
                      depth=args.depth, videos=args.videos),
        "device": torch.cuda.get_device_name(device) if cuda else str(device),
        "card": bench_train.card_line() if cuda else None,
    })
    return result


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    bench_train.add_model_arguments(parser)
    parser.set_defaults(config="default")  # bench.py's model
    parser.add_argument("--k", type=int, default=8, help="eval batches a call")
    parser.add_argument("--steps", type=int, default=40, help="least batches a sweep")
    parser.add_argument("--measures", type=int, default=3, help="timed sweeps")
    parser.add_argument("--workers", type=int, default=1, help="the loader's producer workers")
    parser.add_argument("--skip-rgb", action="store_true", help="no rgb-wire TenCrop sweep")
    return parser


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
