"""The comparison that decides ``correct``: the system's first train steps
against the plain reference's, on the same weights and the same batches.

A family (``families/<name>.py``) builds its numbers from these pieces, and
``verdict`` holds each to its own limit where the cell's workload file names
one (``limits``). Built here, under the names the families give them:

  * ``loss_gap``: the largest relative gap of a step's loss,
    |L - L_ref| / |L_ref|, over the followed steps;
  * ``grad_gap`` (``norm_gap`` of the gradients): the gap of each
    parameter's gradient norm as the first update takes it,
    | |g| - |g_ref| |, over the larger of the reference's norm of that leaf
    and the median leaf's; the worst leaf;
  * ``change_gap`` (``norm_gap`` of the changes): the same of each
    parameter's change over the followed steps, |w_K - w_0|, over the
    leaves whose reference gradient is at least a thousandth of the median
    leaf's (``moved_leaves``: a leaf the reference does not move moves
    under SGD by rounding alone). A step that leaves the state unchanged
    reads 1 on it.

``median_gap`` is the median over chosen leaves of | |x| - |x_ref| | /
|x_ref|, steadier from seed to seed than the worst leaf.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping, Sequence

MIN_GRAD_SHARE = 1e-3  # of the median leaf's reference gradient norm


def loss_gap(losses: Sequence[float], ref_losses: Sequence[float]) -> float:
    if len(losses) != len(ref_losses):
        return math.inf
    gaps = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, ref_losses)]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def norm_gap(norms: Mapping[str, float], ref_norms: Mapping[str, float],
             keep: Sequence[str]) -> float:
    """max over ``keep`` of | |x| - |x_ref| | / max(|x_ref|, median |x_ref|)."""
    if set(norms) != set(ref_norms):
        return math.inf
    median = statistics.median(ref_norms[k] for k in keep)
    worst = 0.0
    for k in keep:
        if not math.isfinite(norms[k]):
            return math.inf
        worst = max(worst, abs(norms[k] - ref_norms[k]) / max(ref_norms[k], median, 1e-30))
    return worst


def moved_leaves(ref_grad_norms: Mapping[str, float]) -> List[str]:
    median = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= MIN_GRAD_SHARE * median]


def median_gap(norms: Mapping[str, float], ref_norms: Mapping[str, float],
               keep: Sequence[str]) -> float:
    """The median over ``keep`` of | |x| - |x_ref| | / |x_ref|."""
    if set(norms) != set(ref_norms) or not all(math.isfinite(norms[k]) for k in keep):
        return math.inf
    return statistics.median(abs(norms[k] - ref_norms[k]) / max(ref_norms[k], 1e-30)
                             for k in keep)


def verdict(values: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    return all(math.isfinite(values[k]) and values[k] <= limits[k] for k in limits)


def report(values: Mapping[str, float], limits: Mapping[str, float]) -> Dict[str, Dict]:
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}
