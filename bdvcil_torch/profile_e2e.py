"""Wall-clock decomposition of the end-to-end training loop (the port of
``tools/profile_e2e.py``).

Each fed train step is split into four stages, timed on the host clock:

  wait      ``next()`` on the loader's one producer stream of chained epochs
            (``iter_epochs``): the step loop waiting for input
  put       in ``baseline`` only: the batch into pinned memory, its
            asynchronous copy to the card and a synchronize
            (``stage_batches`` + ``copy_to_device``); in the other modes
            this work is inside ``dispatch`` or the prefetch thread
  dispatch  the step call until it returns: on the card, the eager launch of
            the step's kernels, which the card runs behind it
  device    in ``baseline`` only: the synchronize after the step, the card's
            work that did not overlap the launching

Modes (``--mode``): ``baseline`` synchronizes after every put and step, so
the stages are serial and each is its own; ``pipelined`` times wait and
dispatch (the copy to the card included) and synchronizes once at the end;
``prefetch`` puts ``prefetch_to_device`` in front, so a thread stages and
copies batches ahead of the step; ``all`` runs the three in turn, each from
a new loader. The corpus, loader, model and step are ``bench_train``'s
(``make_loader``, ``build_step``), so the profiled loop cannot drift from the
benched one, with a single-step ``make_train_step`` (K = 1) as in the JAX
tool; its flags are ``bench_train``'s shape flags.

Two warm-up steps come first, then a ``{"note": "warm", ...}`` line. Each mode
prints one JSON line: ``mode``, ``steps``, ``wall_s``, ``clips_per_sec`` and
the four stages in ms a step. With ``BDVC_PROFILE_PRODUCER=1`` the line also
has ``producer_ms``, the mean seconds a batch (in ms) of ``FastBGMixLoader``'s
phases (``pass1``, ``probe``, ``pass2``, ``decode``; ``data/loaders.py``)
over the batches made since the last line, and, from JPEG, ``decode_cache``:
the plane cache's counters since the process started, with their hit rate.
The JAX tool's ``_pause_for_measurement`` (quiescing a TPU host's background
jobs, ``bench.py``) is not carried.

    python -m bdvcil_torch.profile_e2e [steps] [--mode all] [--workers 1] [--config A]
                                       [--source jpeg|synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import torch

from . import bench_train
from ._device import resolve_device
from .data import loaders, native
from .runtime.loops import (
    copy_to_device,
    prefetch_to_device,
    side_stream,
    split_batch,
    stage_batches,
    step_generator,
    wait_copied,
)

MODES = ("baseline", "pipelined", "prefetch")
WARM_STEPS = 2


def producer_line(source: str) -> dict:
    """``producer_ms`` (and, from JPEG, ``decode_cache``) for a mode's line;
    clears the producer's phase sums."""
    with loaders._PRODUCER_STATS_LOCK:
        stats = dict(loaders.PRODUCER_STATS)
        loaders.PRODUCER_STATS.clear()
    batches = stats.pop("batches", 0.0) or 1.0
    out = {"producer_ms": {k: v / batches * 1000 for k, v in stats.items()},
           "producer_batches": int(batches) if stats else 0}
    if source == "jpeg":
        cache = native.decode_cache_stats()
        total = cache["hits"] + cache["misses"]
        out["decode_cache"] = dict(cache, hit_rate=cache["hits"] / total if total else 0.0)
    return out


def put(batch, device: torch.device, stream):
    """A loader batch on its way to ``device``: pinned, copied on ``stream``
    (``copy_to_device``'s (tree, event))."""
    return copy_to_device(stage_batches([batch], device.type == "cuda", stack=False), device,
                          stream)


def call_step(step, state, staged, device: torch.device, n: int):
    """The step on a put batch; the new state."""
    imgs, labels, extra = split_batch(wait_copied(*staged, device))
    return step(state, None, imgs, labels, extra, step_generator(0, n, device))[0]


def run_mode(mode: str, args, step, state, device: torch.device, first_step: int):
    """One mode's ``args.steps`` steps from a new loader: (its line, the state)."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    stream = side_stream(device)
    prepare = functools.partial(put, device=device, stream=stream)
    loader, _ = bench_train.make_loader(args, num_workers=args.workers)
    # enough chained epochs to cover the steps in one producer stream
    epochs = -(-args.steps // max(1, len(loader))) + 1
    src = loader.iter_epochs(0, epochs)
    if mode == "prefetch":
        src = prefetch_to_device(src, size=2, put_fn=prepare)
    stats = dict(wait=0.0, put=0.0, dispatch=0.0, device=0.0)
    it = iter(src)
    t_start = time.perf_counter()
    try:
        for n in range(args.steps):
            t0 = time.perf_counter()
            batch = next(it)
            t1 = time.perf_counter()
            stats["wait"] += t1 - t0
            if mode == "baseline":
                batch = prepare(batch)
                sync()
                t2 = time.perf_counter()
                stats["put"] += t2 - t1
            else:
                t2 = t1
            staged = prepare(batch) if mode == "pipelined" else batch
            state = call_step(step, state, staged, device, first_step + n)
            t3 = time.perf_counter()
            stats["dispatch"] += t3 - t2
            if mode == "baseline":
                sync()
                stats["device"] += time.perf_counter() - t3
        sync()
        wall = time.perf_counter() - t_start
    finally:
        it.close()
    out = {"mode": mode, "steps": args.steps, "wall_s": wall,
           "clips_per_sec": args.steps * args.batch / wall,
           **{k: v / args.steps * 1000 for k, v in stats.items()}}
    if loaders._producer_profiling_enabled():
        out.update(producer_line(args.source))
    return out, state


def run(args, emit=print) -> list:
    """Warm up, then each mode in turn; ``emit`` gets each line's JSON text.
    Returns the modes' lines."""
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    loader, _ = bench_train.make_loader(args, num_workers=args.workers)
    step, state = bench_train.build_step(args, device, loader.wire_format, k=1)
    stream = side_stream(device)
    it = iter(loader.iter_epochs(0, 1 + -(-WARM_STEPS // max(1, len(loader)))))
    try:
        for n in range(WARM_STEPS):
            state = call_step(step, state, put(next(it), device, stream), device, n)
    finally:
        it.close()
    if cuda:
        torch.cuda.synchronize()
    with loaders._PRODUCER_STATS_LOCK:  # each mode's line counts its own batches
        loaders.PRODUCER_STATS.clear()
    emit(json.dumps({"note": "warm", "device": torch.cuda.get_device_name(device) if cuda
                     else str(device), "card": bench_train.card_line() if cuda else None,
                     "source": args.source, "wire_format": loader.wire_format}))
    lines, done = [], WARM_STEPS
    for mode in MODES if args.mode == "all" else (args.mode,):
        line, state = run_mode(mode, args, step, state, device, done)
        done += args.steps
        emit(json.dumps(line))
        lines.append(line)
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("steps", type=int, nargs="?", default=12, help="steps a mode")
    parser.add_argument("--mode", choices=(*MODES, "all"), default="all")
    parser.add_argument("--workers", type=int, default=1, help="the loader's producer workers")
    bench_train.add_model_arguments(parser)
    args = parser.parse_args(argv)
    run(args, emit=lambda text: print(text, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
