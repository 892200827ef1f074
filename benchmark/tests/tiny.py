"""A benchmark tree at a size the CPU runs in seconds: the committed
configurations with 32² crops, 2 segments and batch 4, a corpus of one
video a class at 80 x 60, and limits for that size, set per model family."""

from __future__ import annotations

import json
import pathlib
import shutil

from benchmark import manifest

TINY_LIMITS = {"tsm_resnet": {"grad_gap_conv_median": 0.1, "change_gap_conv_median": 0.1,
                              "var_gap": 0.06}}
CELLS = {"r50_hmdb51_train_task0": dict(followed=3, warmup=4),
         "r34_ucf101_train_task0": dict(followed=4, warmup=5)}


def limits(cell: str) -> dict:
    """The tiny limits of a committed cell: its configuration's family's."""
    real = manifest.Manifest()
    return TINY_LIMITS[manifest.family_name(real.config(real.workload(cell)["config"]))]


def tiny_tree(tmp: pathlib.Path, cell: str) -> manifest.Manifest:
    """``tmp`` as a checkout holding ``cell`` at the tiny size."""
    real = manifest.Manifest()
    entry = dict(real.workload(cell))
    bench = tmp / "benchmark"
    for sub in ("configs", "traffic", "workloads"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "families"):
        shutil.copytree(real.dir / sub, bench / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    cfg = real.config(entry["config"])
    cfg.update(crop_size=32, short_side=37, num_segments=2, videos_per_gpu=4,
               workers_per_gpu=1)
    (bench / "configs" / f"{entry['config']}.json").write_text(json.dumps(cfg))
    traffic = dict(real.traffic(entry["traffic"]), train_videos_per_class=1, frames=4,
                   width=80, height=60)
    (bench / "traffic" / f"{entry['traffic']}.json").write_text(json.dumps(traffic))
    sizes = CELLS[cell]
    (bench / "workloads" / f"{cell}.json").write_text(json.dumps(dict(
        warmup_steps=sizes["warmup"], followed_steps=sizes["followed"], trace_steps=2,
        limits=limits(cell))))
    data = dict(real.data)
    data["configs"] = [dict(real.config_entry(entry["config"]),
                            file=f"benchmark/configs/{entry['config']}.json")]
    data["workloads"] = [entry]
    (tmp / "BENCHMARK.json").write_text(json.dumps(data))
    return manifest.Manifest(tmp, bench)
