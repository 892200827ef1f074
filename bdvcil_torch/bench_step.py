"""Train-step throughput of the port on one card, on device-resident batches
(the port of ``bench.py``'s headline, ``bench.py:943-1104``).

TSM-ResNet-50 at 16 clips x 8 frames x 224², bf16, the LSC head over 51
classes, the labeled 6-group SGD (classifier lr x5, MultiStepLR), the task-0
``base`` step; ``--config default`` (the default) is ``bench.py``'s model, A
and B reach the hand-written kernels. The batch is standard-normal f32 images
and integer labels from ``numpy.random.default_rng(0)``, put on the card
once. ``--warmup`` steps, then ``--steps`` steps timed on the host clock
between two synchronizes; ``--scan N`` times one ``make_multi_train_step``
call of N steps instead (the counterpart of the JAX ``lax.scan`` super-step).

The line: ``train_clips_per_sec_tsm_r50_8x224``, its value and unit,
``vs_baseline`` (the reference's ~15 training clips/s a GPU, ``bench.py``'s
yardstick), and the step's shares of the card's peaks from
``bdvcil_torch.roofline`` at the run's shape: ``mfu`` = clips/s x the train
FLOPs of a clip (2 a multiply-add) / 989 TFLOP/s (bf16, dense), and
``bw_roofline_fraction`` = clips/s / the clips/s of the ``xla`` pass model at
3.35 TB/s. The roofline models ResNet-50 only: at another ``--depth`` both
keys make way for ``"roofline": "depth N not modelled"``, and off the card
for ``"roofline": "not computed off the card"`` (a CPU rate is no share of
the card's peak). Then the configuration, shape, the card's name and power
limit.

``--forward-only`` times eval-step calls instead, each on the images plus
1e-6 x the last call's mean score, so every call waits on the one before:
``fwd_clips_per_sec_tsm_r50_8x224``, ``vs_baseline`` = rate / 74.0 as in
``bench.py``.

    python -m bdvcil_torch.bench_step [--config A|B|default] [--forward-only] [--scan N]

The backbone switches of ``bench.py``'s ``BENCH_*`` variables are flags:
``--norm-dtype``, ``--no-shift``, ``--stem-mode``, ``--conv1x1``,
``--bn-groups``, ``--bn-stats-rows``. ``--device cpu`` with small shapes
rehearses it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import bench_train, roofline
from . import config_templates as presets
from ._device import resolve_device
from .optim import build_optimizer
from .runtime import TrainState, make_eval_step, make_multi_train_step, make_train_step
from .runtime.loops import step_generator

METRIC = "train_clips_per_sec_tsm_r50_8x224"
FWD_METRIC = "fwd_clips_per_sec_tsm_r50_8x224"
BASELINE_CLIPS_PER_SEC = 15.0  # bench.py:65, the reference's training clips/s a GPU
BASELINE_FWD_CLIPS_PER_SEC = 74.0  # bench.py:1015


def backbone_switches(args) -> dict:
    """The switches the flags set, over ``--config``'s (``bench.py:958-969``)."""
    sw = {}
    if args.norm_dtype:
        sw["norm_dtype"] = args.norm_dtype
    if args.no_shift:
        sw["is_shift"] = False
    if args.stem_mode:
        sw["stem_mode"] = args.stem_mode
    if args.conv1x1:
        sw["conv1x1_mode"] = args.conv1x1
    if args.bn_groups:
        sw["bn_groups"] = args.bn_groups
    if args.bn_stats_rows:
        sw["bn_stats_rows"] = args.bn_stats_rows
    return sw


def bench_inputs(batch: int, segments: int, size: int, device: torch.device):
    """(images (B, T, H, W, 3) f32, labels (B, 1)) from ``default_rng(0)``, on ``device``."""
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((batch, segments, size, size, 3), dtype=np.float32)
    labels = rng.integers(0, bench_train.NUM_CLASSES, size=(batch, 1))
    return torch.from_numpy(imgs).to(device), torch.from_numpy(labels).to(device)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_forward(spec, module, imgs, steps: int, warmup: int, device: torch.device):
    """(seconds of ``steps`` chained eval calls, the last call's outputs)."""
    eval_step = make_eval_step(spec, bench_train.NUM_CLASSES)
    carry = torch.zeros((), device=device)
    out = None
    for _ in range(warmup):
        out = eval_step(module, imgs + carry * 1e-6)
        carry = out["cls_score"].float().mean()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = eval_step(module, imgs + carry * 1e-6)
        carry = out["cls_score"].float().mean()
    _sync(device)
    return time.perf_counter() - t0, out


def time_train(spec, module, imgs, labels, steps: int, warmup: int, scan: int,
               device: torch.device):
    """(seconds, steps timed, the last loss): ``steps`` single steps after
    ``warmup``, or with ``scan`` one warm and one timed call of ``scan`` steps."""
    tx = build_optimizer(module, presets.OPTIMIZER, presets.LR_SCHEDULER, steps_per_epoch=100)
    step_kwargs = dict(spec=spec, tx=tx, num_classes=bench_train.NUM_CLASSES, method="base",
                       task_idx=0)
    state = TrainState.create(module, tx)
    if scan:
        multi = make_multi_train_step(step_kwargs, scan)
        stacked = imgs.expand(scan, *imgs.shape), labels.expand(scan, *labels.shape)
        for call in range(2):  # warm, then timed
            gens = [step_generator(0, call * scan + i, device) for i in range(scan)]
            _sync(device)
            t0 = time.perf_counter()
            state, metrics = multi(state, None, *stacked, {}, gens)
            _sync(device)
        return time.perf_counter() - t0, scan, float(metrics["loss"])
    step = make_train_step(**step_kwargs)
    for i in range(warmup):
        state, metrics = step(state, None, imgs, labels, {}, step_generator(0, i, device))
    _sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        state, metrics = step(state, None, imgs, labels, {},
                              step_generator(0, warmup + i, device))
    _sync(device)
    return time.perf_counter() - t0, steps, float(metrics["loss"])


def utilization(rate: float, batch: int, segments: int, size: int, depth: int) -> dict:
    """The step's shares of the H100's peaks at ``rate`` clips/s on the card
    (``roofline``)."""
    if depth != 50:
        return {"roofline": f"depth {depth} not modelled"}
    flops = roofline.train_flops_per_clip(segments, size)
    xla = roofline.bounds(batch, segments, size)["xla"]["clips_per_sec_at_bound"]
    return {
        "model_tflops_per_clip": flops / 1e12,
        "mfu": rate * flops / roofline.PEAK_BF16_FLOPS,
        "bw_roofline_fraction": rate / xla,
        "utilization_note": f"mfu against 989 TFLOP/s (H100 SXM bf16, dense; 2 FLOPs a "
                            f"multiply-add); bw_roofline_fraction against {xla:.1f} clips/s, the "
                            f"xla pass model at 3.35 TB/s (bdvcil_torch.roofline)",
    }


def run(args) -> dict:
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    switches = {**presets.SWITCHES[args.config], **backbone_switches(args)}
    spec, module = bench_train.build_bench_model(args, device, **backbone_switches(args))
    imgs, labels = bench_inputs(args.batch, args.segments, args.size, device)
    if args.forward_only:
        dt, out = time_forward(spec, module, imgs, args.steps, args.warmup, device)
        rate = args.batch * args.steps / dt
        if not torch.isfinite(out["cls_score"]).all():
            raise AssertionError("non-finite scores in the forward-only bench")
        result = {"metric": FWD_METRIC, "value": rate, "unit": "clips/s",
                  "vs_baseline": rate / BASELINE_FWD_CLIPS_PER_SEC, "steps": args.steps}
    else:
        dt, steps, loss = time_train(spec, module, imgs, labels, args.steps, args.warmup,
                                     args.scan, device)
        rate = args.batch * steps / dt
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss in the step bench: {loss}")
        result = {"metric": METRIC, "value": rate, "unit": "clips/s",
                  "vs_baseline": rate / BASELINE_CLIPS_PER_SEC,
                  **(utilization(rate, args.batch, args.segments, args.size, args.depth)
                     if cuda else {"roofline": "not computed off the card"}),
                  "steps": steps, "scan": args.scan, "loss": loss}
    result.update({
        "config": args.config,
        "backbone": switches,
        "shape": dict(batch=args.batch, segments=args.segments, size=args.size,
                      depth=args.depth),
        "device": torch.cuda.get_device_name(device) if cuda else str(device),
        "card": bench_train.card_line() if cuda else None,
    })
    return result


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    bench_train.add_model_arguments(parser)
    parser.set_defaults(config="default")  # bench.py's model
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--scan", type=int, default=0, help="time one call of N steps")
    parser.add_argument("--forward-only", action="store_true")
    parser.add_argument("--norm-dtype", choices=("float32", "bfloat16"), default=None)
    parser.add_argument("--no-shift", action="store_true", help="the backbone without the shift")
    parser.add_argument("--stem-mode", choices=("conv", "s2d"), default=None)
    parser.add_argument("--conv1x1", default=None, help="conv1x1_mode over --config's")
    parser.add_argument("--bn-groups", type=int, default=0)
    parser.add_argument("--bn-stats-rows", type=int, default=0)
    return parser


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
