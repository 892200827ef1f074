"""The CIL result table (the port of ``bdvcil_tpu/utils/tables.py``).

One row per evaluated checkpoint (task i), one column per task's class
range, the sample-weighted average last, and a final row with the mean of
the per-task averages. The text is what ``tabulate``'s "simple" format makes
of the JAX package's table, written out here so the port needs no
``tabulate``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .meters import AverageMeter


def _simple_table(rows: Sequence[Sequence], headers: Sequence[str], floatfmt: str) -> str:
    """tabulate(rows, headers, floatfmt=floatfmt, missingval='') for a first
    column of text and number columns: text left-aligned, numbers right,
    every column at least two wider than its header, two spaces apart."""
    cells = [[str(r[0])] + ["" if v is None else format(v, floatfmt) for v in r[1:]]
             for r in rows]
    widths = [max([len(h) + 2] + [len(c[j]) for c in cells]) for j, h in enumerate(headers)]

    def line(values: Sequence[str]) -> str:
        return "  ".join(v.ljust(w) if j == 0 else v.rjust(w)
                         for j, (v, w) in enumerate(zip(values, widths)))

    return "\n".join([line(headers), line(["-" * w for w in widths])] + [line(c) for c in cells])


def print_mean_accuracy(accuracies: List[AverageMeter], num_classes_per_task,
                        floatfmt: str = ".2f") -> str:
    assert len(accuracies) == len(num_classes_per_task)
    num_tasks = len(num_classes_per_task)

    start = 0
    headers = ["range"]
    for num_classes in num_classes_per_task:
        headers.append("{}-{}".format(start, start + num_classes - 1))
        start += num_classes
    headers.append("Avg")

    table: List[List[Optional[object]]] = []
    avg_acc = []
    for task_i in range(num_tasks):
        num_placeholders = num_tasks - task_i - 1
        table.append(["task {}".format(task_i), *accuracies[task_i].values]
                     + num_placeholders * [None] + [accuracies[task_i].avg])
        avg_acc.append(accuracies[task_i].avg)

    table.append(["avg_acc"] + num_tasks * [None] + [float(np.mean(avg_acc))])
    return _simple_table(table, headers, floatfmt)
