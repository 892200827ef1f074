"""Where one train step's time goes on the card, from ``torch.profiler``.

Runs the main path (TSM-R50, 16 clips x 8 frames at 224x224, bf16, LSC head,
labeled SGD) in one configuration, at task 0 (no KD) and at task 1 (KD
against the previous model, clip 1.0). After two warm-up steps it profiles
``--steps`` steps of each task and prints, per step:

  * wall ms (host clock around synchronized steps),
  * device busy ms (the union of the kernels' intervals) and the idle share,
  * device time by kernel category and the top kernels by device time.

The summary goes to ``chiprun_out/profile_<config>.json``. Needs a GPU:

    python -m bdvcil_torch.profile_step --config A
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import re
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from . import config_templates as presets
from .models import build_model, init_model_params, update_fc
from .optim import build_optimizer
from .runtime import TrainState, make_train_step

# first match wins; kernel names are the device-side names in the trace
CATEGORIES = [
    ("port: conv1x1_with_stats", r"conv1x1_stats_kernel|stats_finish_kernel"),
    ("port: fused_residual_relu_shift", r"fused_fwd_kernel|fused_bwd_kernel"),
    ("conv (cuDNN)", r"conv|fprop|dgrad|wgrad|implicit|winograd|nchwToNhwc|nhwcToNchw"),
    ("gemm (cuBLAS)", r"gemm|cutlass|xmma|Kernel2|ampere|sm90"),
    ("reduction", r"reduce|Reduce"),
    ("cat / copy", r"Cat|copy|Copy"),
    ("elementwise", r"elementwise|Elementwise|vectorized|unrolled"),
]


def _category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def _busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _profile_steps(run_step, steps: int):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_cat, by_name = defaultdict(float), defaultdict(float)
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_cat[_category(e.name)] += dur
        by_name[e.name] += dur
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return dict(
        wall_ms=wall_ms / steps,
        busy_ms=busy_ms / steps,
        idle_share=1.0 - busy_ms / wall_ms,
        launches_per_step=len(kernels) / steps,
        by_category_ms={k: v / 1e3 / steps for k, v in sorted(by_cat.items(),
                                                             key=lambda kv: -kv[1])},
        top_kernels_ms=[(name[:120], us / 1e3 / steps) for name, us in top],
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=sorted(presets.SWITCHES), default="A")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    nc0 = presets.HMDB51_BASE_CLASSES
    nc1 = nc0 + presets.HMDB51_CLASSES_PER_TASK
    spec = build_model(presets.hmdb51_r50_cfg(nc0, **presets.SWITCHES[args.config]),
                       dtype=torch.bfloat16, device=dev)
    model = init_model_params(spec, args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    imgs = torch.randn((16, 8, 224, 224, 3), generator=gen, device=dev)
    labels = torch.randint(0, nc0, (16,), generator=gen, device=dev)
    drop = torch.Generator(device=dev).manual_seed(args.seed + 1)

    tx = build_optimizer(model, presets.OPTIMIZER, presets.LR_SCHEDULER, steps_per_epoch=100)
    holder = {"state": TrainState.create(model, tx)}
    step0 = make_train_step(spec, tx, nc0)

    def run0():
        holder["state"], _ = step0(holder["state"], None, imgs, labels, {}, drop)

    for _ in range(2):
        run0()
    result = {"card": card, "config": args.config, "backbone": presets.SWITCHES[args.config],
              "task0": _profile_steps(run0, args.steps)}

    prev = copy.deepcopy(model)
    grow = torch.Generator().manual_seed(args.seed + 2)
    update_fc(model, nc1, grow)
    update_fc(prev, nc1, grow)
    tx1 = build_optimizer(model, presets.OPTIMIZER, presets.LR_SCHEDULER, steps_per_epoch=100,
                          grad_clip=presets.GRAD_CLIP)
    holder["state"] = TrainState.create(model, tx1)
    step1 = make_train_step(spec, tx1, nc1, task_idx=1, prev_num_classes=nc0,
                            kd_config=presets.kd_config(nc1, nc1 - nc0))
    labels1 = torch.randint(0, nc1, (16,), generator=gen, device=dev)

    def run1():
        holder["state"], _ = step1(holder["state"], prev, imgs, labels1, {}, drop)

    for _ in range(2):
        run1()
    result["task1"] = _profile_steps(run1, args.steps)

    for task in ("task0", "task1"):
        r = result[task]
        print(f"{args.config} {task}: wall {r['wall_ms']:.2f} ms/step, device busy "
              f"{r['busy_ms']:.2f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['launches_per_step']:.0f} kernels/step [{card}]")
        for cat, ms in r["by_category_ms"].items():
            print(f"    {cat:34s} {ms:9.3f} ms")
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"profile_{args.config}.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
