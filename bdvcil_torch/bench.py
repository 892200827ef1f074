"""The port's benches in one run, the step headline first (the port of
``bench.py``'s composite, ``bench.py:1107-1225``).

``--mode all`` (the default) runs, in order of importance:

  1. the step headline (``bench_step``: device-resident batches, ``mfu``,
     ``bw_roofline_fraction``);
  2. ``bench_train``'s end-to-end train clips/s (BGMix family, K steps a call);
  3. ``bench_eval`` with 2 sweeps of at least 24 batches and no rgb-wire
     TenCrop sweep, unless fewer than 120 s of ``--budget`` remain;
  4. ``bench_train --family acm`` with 5 windows, unless fewer than 150 s
     remain.

After each section it prints the whole merged line again with
``bench_wall_s``, so the last stdout line is always a complete result. A
section skipped for the budget is recorded as ``<section>_skipped_budget``; a
section that fails as ``<section>_error`` (its message), and the run then
exits 1. A failing headline fails the run at once.

``--mode step|forward|input|train_e2e|train_e2e_acm|eval_e2e`` runs one
bench and prints its own line. The model and corpus flags (``--config``,
default ``default``, ``bench.py``'s model; ``--device``, shapes, ``--corpus``)
reach every section.

    python -m bdvcil_torch.bench [--mode all] [--budget 450] [--config default]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import bench_eval, bench_input, bench_step, bench_train

MODES = ("all", "step", "forward", "input", "train_e2e", "train_e2e_acm", "eval_e2e")
EVAL_RESERVE_S, ACM_RESERVE_S = 120.0, 150.0  # bench.py:1166, :1196
SHARED = ("config", "source", "device", "corpus", "videos", "frames", "batch", "segments",
          "size", "depth")


def section_args(module, args, **overrides) -> argparse.Namespace:
    """``module``'s defaults, then the composite's shared flags, then ``overrides``."""
    ns = module.build_parser().parse_args([])
    for key in SHARED:
        setattr(ns, key, getattr(args, key))
    for key, value in overrides.items():
        setattr(ns, key, value)
    return ns


def step_args(args, forward_only: bool = False):
    return section_args(bench_step, args, steps=args.steps, warmup=args.warmup,
                        forward_only=forward_only)


def e2e_args(args, family: str, windows: int):
    return section_args(bench_train, args, family=family, k=args.k, steps=args.e2e_steps,
                        windows=windows)


def composite(args, emit=print) -> int:
    """``--mode all``: the headline, then the sections the budget allows."""
    t0 = time.monotonic()
    line = bench_step.run(step_args(args))
    extras = {}

    def publish():
        extras["bench_wall_s"] = time.monotonic() - t0
        emit(json.dumps({**line, **extras}))

    publish()
    try:
        e2e = bench_train.run(e2e_args(args, "bgmix", args.windows))
        extras.update(e2e_train_clips_per_sec=e2e["value"],
                      e2e_vs_baseline=e2e["value"] / bench_step.BASELINE_CLIPS_PER_SEC,
                      e2e_window_rates=e2e["window_rates"], e2e_window_min=e2e["window_min"],
                      e2e_steps_per_dispatch=e2e["k"],
                      e2e_device_clips_per_sec=e2e["device_clips_per_sec"],
                      e2e_producer_wait_s=e2e["producer_wait_s"],
                      host_decode_frames_per_sec=e2e["host_decode_frames_per_sec"])
    except Exception as e:  # noqa: BLE001 -- recorded, and the exit code says so
        extras["e2e_error"] = f"{type(e).__name__}: {e}"[:200]
    publish()
    if time.monotonic() - t0 > args.budget - EVAL_RESERVE_S:
        extras["eval_skipped_budget"] = True
    else:
        try:
            ev = bench_eval.run(section_args(bench_eval, args, k=args.k, steps=24, measures=2,
                                             skip_rgb=True))
            extras.update(eval_videos_per_sec=ev["value"], eval_vs_baseline=ev["vs_baseline"],
                          eval_tencrop_videos_per_sec=ev["tencrop_videos_per_sec"],
                          eval_tencrop_wire=ev["tencrop_wire"])
        except Exception as e:  # noqa: BLE001
            extras["eval_error"] = f"{type(e).__name__}: {e}"[:200]
        publish()
    if time.monotonic() - t0 > args.budget - ACM_RESERVE_S:
        extras["acm_skipped_budget"] = True
    else:
        try:
            acm = bench_train.run(e2e_args(args, "acm", windows=5))
            extras.update(acm_e2e_train_clips_per_sec=acm["value"],
                          acm_e2e_vs_baseline=acm["value"] / bench_step.BASELINE_CLIPS_PER_SEC,
                          acm_e2e_window_rates=acm["window_rates"],
                          acm_e2e_wire_format=acm["wire_format"])
        except Exception as e:  # noqa: BLE001
            extras["acm_error"] = f"{type(e).__name__}: {e}"[:200]
    publish()
    return 1 if any(k.endswith("_error") for k in extras) else 0


def run_mode(args, emit=print) -> int:
    if args.mode == "all":
        return composite(args, emit)
    if args.mode in ("step", "forward"):
        out = bench_step.run(step_args(args, forward_only=args.mode == "forward"))
    elif args.mode == "input":
        out = bench_input.run(bench_input.build_parser().parse_args([]))
    elif args.mode == "eval_e2e":
        out = bench_eval.run(section_args(bench_eval, args, k=args.k))
    else:
        out = bench_train.run(e2e_args(args, "acm" if args.mode == "train_e2e_acm" else "bgmix",
                                       args.windows))
    emit(json.dumps(out))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    bench_train.add_model_arguments(parser)
    parser.set_defaults(config="default")  # bench.py's model
    parser.add_argument("--mode", choices=MODES, default="all")
    parser.add_argument("--budget", type=float, default=450.0,
                        help="wall seconds the optional sections must fit in")
    parser.add_argument("--steps", type=int, default=20, help="the step headline's steps")
    parser.add_argument("--warmup", type=int, default=5, help="the step headline's warm-up")
    parser.add_argument("--k", type=int, default=8, help="steps (eval: batches) a call")
    parser.add_argument("--e2e-steps", type=int, default=40, help="steps a train window")
    parser.add_argument("--windows", type=int, default=5, help="train_e2e's windows")
    return parser


def main(argv=None) -> int:
    return run_mode(build_parser().parse_args(argv), emit=lambda text: print(text, flush=True))


if __name__ == "__main__":
    sys.exit(main())
