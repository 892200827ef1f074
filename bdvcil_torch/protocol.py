"""vCLIMB class-incremental protocol generators (the port's copy of
``bdvcil_tpu/protocol.py``).

The reference hardcodes class orders for seeds {1000, 1993, 2021} following
"Class-Incremental Learning for Action Recognition in Videos" (vCLIMB,
arXiv 2203.13611) — cited at configs/cil/task_splits_config.py:5-8. Those
orders are exactly ``np.random.seed(seed); np.random.shuffle(arange(n))``
(the procedure in configs/cil/task_splits_tool.py:12-15), so this module
generates them instead of storing tables. Verified against the reference's
hardcoded sequences for all three seeds on UCF-101 (101 classes) and
HMDB-51 (51 classes).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

# dataset name -> (total classes, base-task classes)
DATASETS = {
    "ucf101": (101, 51),
    "hmdb51": (51, 26),
    "sthv2": (174, 84),
}


def ceildiv(a: int, b: int) -> int:
    return -(a // -b)


def class_order(seed: int, num_classes: int) -> List[int]:
    """The vCLIMB random class order for a seed (task_splits_tool.py:12-15)."""
    rng_state = np.random.get_state()
    np.random.seed(seed)
    order = np.arange(num_classes)
    np.random.shuffle(order)
    np.random.set_state(rng_state)
    return order.tolist()


def task_splits(
    seed: int, num_classes: int, init_task_num_classes: int, num_classes_per_task: int
) -> List[List[int]]:
    """Base task of ``init_task_num_classes`` + equal incremental tasks."""
    order = class_order(seed, num_classes)
    num_tasks = ceildiv(num_classes - init_task_num_classes, num_classes_per_task) + 1
    splits = []
    for task_idx in range(num_tasks):
        if task_idx == 0:
            start, stop = 0, init_task_num_classes
        else:
            start = init_task_num_classes + (task_idx - 1) * num_classes_per_task
            stop = start + num_classes_per_task
        splits.append(order[start:stop])
    return splits


def task_splits_for(dataset: str, seed: int, num_stages: int) -> List[List[int]]:
    """Splits by dataset name and incremental stage count (e.g. ucf101 with
    num_stages=10 -> 51 base + 10 tasks of 5)."""
    total, base = DATASETS[dataset]
    per_task = ceildiv(total - base, num_stages)
    return task_splits(seed, total, base, per_task)


def adaptive_scale_factors(splits: List[List[int]]) -> List[float]:
    """Per-task KD scale: sqrt(total classes so far / classes added this task)
    (reproduces the constants at e.g. configs/ucf101/.../*:89 exactly)."""
    factors = [1.0]
    total = len(splits[0])
    for task in splits[1:]:
        total += len(task)
        factors.append(math.sqrt(total / len(task)))
    return factors
