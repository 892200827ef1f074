"""End-to-end training throughput of the port on one card: JPEG rawframes on
disk -> the native decode pool -> the yuv420 wire -> pinned host memory and
an asynchronous copy -> the input function inside the step -> TSM-R50 at 16
clips x 8 frames x 224², bf16, LSC head, labeled SGD, K steps per call (the
main path of ``bench.py:530-660``).

The corpus is ``data/corpus.py``'s UCF101-shaped one (64 videos of 16
frames, 320 x 240, backgrounds by temporal median), written once under
``--corpus``. ``FastBGMixLoader`` (wire 'auto', RandAugment on 3/4 of the
clips, BGMix on the rest) feeds ``make_multi_train_step`` through the train
loop's prefetch thread (``runtime/loops.py``: pinned staging, side-stream
copy, event). After ``--warmup`` calls, ``--windows`` windows of ``--steps``
steps each are timed on the host clock, each ending in a synchronize; the
value is the median window's clips/s.

``--family acm`` measures the ActorCutMix family instead (``bench.py:708-823``):
every video carries the two fixed person boxes of ``ACM_BOXES`` on every
frame, and ``FastACMLoader`` at ``acm_prob=1.0`` (two clips decoded a row:
the actor and a scene) feeds ``make_fast_acm_input_fn`` in the same step,
windows and loop. It always decodes: ``--source synthetic`` is refused.

Printed, as one JSON line: the metric, its value and unit, the family, the
configuration, K, the window rates, wall times and producer waits (seconds
the step loop waited for input), ``device_clips_per_sec`` (the same step on
one staged chunk that stays on the card: the rate without the host), the
steps run, the decoded-plane cache's counters after the windows
(``decode_cache``: the corpus fits the 512 MB cache, so warm windows replay
cached planes and resize), ``host_decode_frames_per_sec`` (the decode pool
alone at the bench's geometry, cold: the cache off), the host's CPU count,
the loader's source, and the card's name and power limit.

    python -m bdvcil_torch.bench_train --config A [--k 8] [--source jpeg|synthetic]
                                       [--family bgmix|acm]

``--source jpeg`` (the default) decodes the corpus with the port's own JPEG
codec (``csrc/host/jpeg_codec.h``), which needs only g++, and raises when it
cannot be built; ``--source synthetic`` measures on in-memory wire batches
instead and says so. ``--device cpu`` with small shapes rehearses it on the CPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

from . import config_templates as presets
from ._device import resolve_device
from .data import corpus, native
from .data.device_pipeline import make_fast_acm_input_fn, make_fast_input_fn
from .data.loaders import FastACMLoader, FastBGMixLoader
from .data.synthetic import SyntheticWireLoader
from .models import build_model, init_model_params
from .optim import build_optimizer
from .runtime import TrainState, make_multi_train_step, make_train_step
from .runtime.loops import (
    copy_to_device,
    prefetch_to_device,
    side_stream,
    split_batch,
    stage_batches,
    step_generator,
    wait_copied,
)
from .utils import Throughput

METRIC = "e2e_train_clips_per_sec_tsm_r50_8x224"
ACM_METRIC = "e2e_acm_train_clips_per_sec_tsm_r50_8x224"
NUM_CLASSES = 51  # bench.py's head
# two person-sized boxes (x1, y1, x2, y2, score) on every frame (bench.py:733-736)
ACM_BOXES = [[40.0, 30.0, 200.0, 170.0, 0.9], [120.0, 60.0, 300.0, 230.0, 0.8]]


def card_line() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def host_cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        return os.cpu_count() or 1


def model_cfg(segments: int = 8, depth: int = 50, **backbone) -> dict:
    """The recognizer every bench measures (``bench.py``'s ``_bench_model_cfg``:
    TSM-ResNet at ``depth``, shift_div 8, the LSC head over 51 classes);
    ``backbone`` adds switches."""
    cfg = presets.hmdb51_r50_cfg(NUM_CLASSES, segments, **backbone)
    cfg["backbone"]["depth"] = depth
    cfg["cls_head"]["in_channels"] = 2048 if depth >= 50 else 512
    return cfg


def build_bench_model(args, device: torch.device, **backbone):
    """(spec, module): ``model_cfg`` at ``--config``'s switches (``backbone``
    overrides them), ``--depth`` and ``--segments``, bf16, random weights
    from seed 0."""
    cfg = model_cfg(args.segments, args.depth, **{**presets.SWITCHES[args.config], **backbone})
    spec = build_model(cfg, dtype=torch.bfloat16, device=device)
    return spec, init_model_params(spec, 0)


def acm_infos(infos):
    """The corpus's video infos with ``ACM_BOXES`` on every frame."""
    return [dict(info, all_detections={t: [list(b) for b in ACM_BOXES]
                                       for t in range(1, info["total_frames"] + 1)})
            for info in infos]


def make_loader(args, num_workers: int = 1, family: str = "bgmix"):
    """(loader, video_infos): the JPEG corpus through ``FastBGMixLoader`` (or,
    for ``family`` 'acm', ``FastACMLoader`` at acm_prob 1) with
    ``num_workers`` producer workers, or (the in-memory synthetic loader,
    None)."""
    if family == "acm" and args.source == "synthetic":
        raise ValueError("--family acm decodes the corpus (bench.py's ACM bench always "
                         "decodes): it has no --source synthetic")
    if args.source == "synthetic":
        return SyntheticWireLoader(args.videos, args.batch, args.segments, args.size, seed=0), None
    if not native.available():
        raise RuntimeError(f"native decoder unavailable: {native.build_error()} "
                           f"(--source synthetic measures without it)")
    infos, bg_files = corpus.write_corpus(args.corpus, args.videos, args.frames, seed=0,
                                          num_classes=NUM_CLASSES)
    if family == "acm":
        infos = acm_infos(infos)
        loader = FastACMLoader(infos, batch_size=args.batch, num_segments=args.segments,
                               crop_size=args.size, acm_prob=1.0, seed=0, drop_last=True,
                               prefetch=2, num_workers=num_workers, wire_format="auto")
        return loader, infos
    loader = FastBGMixLoader(infos, bg_files, batch_size=args.batch, num_segments=args.segments,
                             crop_size=args.size, randaug_prob=0.75, seed=0, drop_last=True,
                             prefetch=2, num_workers=num_workers, wire_format="auto")
    return loader, infos


def host_decode_rate(infos, size: int, frames: int) -> float:
    """Frames/s of the decode pool alone, cold: the decoded-plane cache off,
    then every frame of up to 8 videos decoded, short-side resized and
    cropped to ``size`` on up to 8 threads; the cache's budget is restored
    after.
    (``bench.py:666-675`` decodes one video's frames 8 times, which the plane
    cache then serves.)"""
    paths = [os.path.join(info["frame_dir"], corpus.FILENAME_TMPL.format(t))
             for info in infos[:8] for t in range(1, frames + 1)]
    native.decode_cache_set_budget_mb(0)
    try:
        t0 = time.perf_counter()
        native.decode_resize_crop_batch(paths, int(round(size / 0.875)), size, size,
                                        num_threads=min(8, host_cpus()))
        return len(paths) / (time.perf_counter() - t0)
    finally:
        native.decode_cache_set_budget_mb(int(os.environ.get("BDVC_DECODE_CACHE_MB", 512)))


def build_step(args, device: torch.device, wire_format: str, k: int, family: str = "bgmix"):
    """(step, state): the bench's model (``build_bench_model``), labeled SGD,
    and the task-0 ``base`` step with the family's fast input function on
    ``wire_format`` inside it; K steps a call for ``k`` > 1."""
    spec, model = build_bench_model(args, device)
    tx = build_optimizer(model, presets.OPTIMIZER, steps_per_epoch=100)
    if family == "acm":
        input_fn = make_fast_acm_input_fn(dtype=torch.bfloat16, wire_format=wire_format)
    else:
        input_fn = make_fast_input_fn(alpha=0.5, with_randaug=True, dtype=torch.bfloat16,
                                      wire_format=wire_format)
    step_kwargs = dict(spec=spec, tx=tx, num_classes=NUM_CLASSES, method="base",
                       input_fn=input_fn)
    step = make_multi_train_step(step_kwargs, k) if k > 1 else make_train_step(**step_kwargs)
    return step, TrainState.create(model, tx)


def run(args) -> dict:
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    loader, infos = make_loader(args, family=args.family)
    k = args.k
    step, state = build_step(args, device, loader.wire_format, k, family=args.family)
    stream = side_stream(device)

    def prepare(items):
        return copy_to_device(stage_batches(items, cuda, stack=k > 1), device, stream)

    def chunks(src):  # whole chunks only; they may span epochs
        while True:
            items = list(itertools.islice(src, k))
            if len(items) < k:
                return
            yield items

    per_window = -(-args.steps // k)  # calls per window
    calls = args.warmup + args.windows * per_window + 1
    epochs = -(-calls * k // len(loader)) + 1
    meter = Throughput()
    stream_it = prefetch_to_device(chunks(iter(loader.iter_epochs(0, epochs))), size=2,
                                   put_fn=prepare, meter=meter)
    done = 0  # steps so far: the step generators' index

    def call(staged):
        nonlocal state, done
        imgs, labels, extra = split_batch(wait_copied(*staged, device))
        gens = [step_generator(0, done + j, device) for j in range(k)]
        state, metrics = step(state, None, imgs, labels, extra, gens if k > 1 else gens[0])
        done += k
        return metrics

    t0 = time.perf_counter()
    for _ in range(args.warmup):
        call(next(stream_it))
    sync()
    warm_s = time.perf_counter() - t0
    rates, walls, waits, losses = [], [], [], []
    for _ in range(args.windows):
        wait0 = meter.wait_s
        t0 = time.perf_counter()
        for _ in range(per_window):
            metrics = call(next(stream_it))
        sync()
        walls.append(time.perf_counter() - t0)
        waits.append(meter.wait_s - wait0)
        rates.append(per_window * k * args.batch / walls[-1])
        losses.append(float(metrics["loss"]))

    # the step alone: one staged chunk kept on the card, called again and again
    staged = next(stream_it)
    stream_it.close()
    call(staged)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.device_calls):
        call(staged)
    sync()
    device_rate = args.device_calls * k * args.batch / (time.perf_counter() - t0)
    jpeg = infos is not None

    result = {
        "metric": ACM_METRIC if args.family == "acm" else METRIC,
        "value": statistics.median(rates),
        "unit": "clips/s",
        "family": args.family,
        "config": args.config,
        "backbone": presets.SWITCHES[args.config],
        "k": k,
        "window_rates": rates,
        "window_min": min(rates),
        "window_wall_s": walls,
        "window_producer_wait_s": waits,
        "producer_wait_s": sum(waits),
        "warm_s": warm_s,
        "device_clips_per_sec": device_rate,
        "steps": done,
        "decode_cache": native.decode_cache_stats() if jpeg else None,
        "host_decode_frames_per_sec": (host_decode_rate(infos, args.size, args.frames)
                                       if jpeg else None),
        "host_cpus": host_cpus(),
        "source": "jpeg" if jpeg else "synthetic",
        "wire_format": loader.wire_format,
        "losses": losses,
        "shape": dict(batch=args.batch, segments=args.segments, size=args.size,
                      depth=args.depth, videos=args.videos),
        "device": torch.cuda.get_device_name(device) if cuda else str(device),
        "card": card_line() if cuda else None,
    }
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss in the windows: {losses}")
    return result


def add_model_arguments(parser: argparse.ArgumentParser) -> None:
    """The flags of the corpus, the loader and the model (``make_loader``,
    ``build_step``), shared with ``profile_e2e``."""
    parser.add_argument("--config", choices=sorted(presets.SWITCHES), default="A")
    parser.add_argument("--source", choices=("jpeg", "synthetic"), default="jpeg")
    parser.add_argument("--device", default=None, help="default: the card")
    parser.add_argument("--corpus", default="work_dirs/bench_train_corpus")
    parser.add_argument("--videos", type=int, default=64)
    parser.add_argument("--frames", type=int, default=16, help="frames per video")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--segments", type=int, default=8)
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--depth", type=int, default=50)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_arguments(parser)
    parser.add_argument("--family", choices=("bgmix", "acm"), default="bgmix")
    parser.add_argument("--k", type=int, default=8, help="steps per call")
    parser.add_argument("--warmup", type=int, default=3, help="calls before the windows")
    parser.add_argument("--windows", type=int, default=5)
    parser.add_argument("--steps", type=int, default=40, help="steps per window")
    parser.add_argument("--device-calls", type=int, default=3)
    return parser


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
