"""The comparison that decides ``correct``: the system's first train steps
against the plain reference's, on the same weights and the same batches.

The numbers, each held to its own limit where the cell's workload file
names one (``limits``):

  * ``loss_gap``: the largest relative gap of a step's loss,
    |L - L_ref| / |L_ref|, over the followed steps;
  * ``grad_gap``: the gap of each parameter's gradient norm as the first
    update takes it, | |g| - |g_ref| |, over the larger of the reference's
    norm of that leaf and the median leaf's; the worst leaf;
  * ``change_gap``: the same of each parameter's change over the followed
    steps, |w_K - w_0|, over the leaves whose reference gradient is at
    least a thousandth of the median leaf's (a leaf the reference does not
    move moves under SGD by rounding alone). A step that leaves the state
    unchanged reads 1 on it;
  * ``grad_gap_conv_median`` / ``change_gap_conv_median``: the median over
    the conv weights (those moved, for the change) of | |x| - |x_ref| | /
    |x_ref|. The worst leaf is a small BatchNorm leaf whose norm moves with
    the rounding of the whole forward; the median is steady from seed to
    seed;
  * ``var_gap``: the median over the BatchNorm layers of the median over
    channels of |v - v_ref| / v_ref, the batch variances of the first
    step's forward (read from the running variance the step updated).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping, Sequence

import torch

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


def conv_leaves(names: Sequence[str]) -> List[str]:
    return [k for k in names if k.rsplit(".", 2)[-2].startswith("conv")
            or ".downsample.0." in k]


def var_gap(bn_vars: Mapping[str, torch.Tensor], ref_vars: Mapping[str, torch.Tensor]) -> float:
    """The median over the BatchNorm layers of the median over channels of
    |v - v_ref| / v_ref, the first forward's batch variances."""
    if set(bn_vars) != set(ref_vars) or not ref_vars:
        return math.inf
    per_layer = []
    for k, ref in ref_vars.items():
        got = torch.as_tensor(bn_vars[k]).float().reshape(-1)
        ref = torch.as_tensor(ref).float().reshape(-1)
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            return math.inf
        per_layer.append(float(((got - ref).abs() / ref.clamp(min=1e-30)).median()))
    return statistics.median(per_layer)


def numbers(program: Mapping, reference: Mapping) -> Dict[str, float]:
    """program / reference: {'losses', 'grad_norms', 'change_norms'}."""
    keep = moved_leaves(reference["grad_norms"])
    every = list(reference["grad_norms"])
    convs = conv_leaves(every)
    return {
        "loss_gap": loss_gap(program["losses"], reference["losses"]),
        "grad_gap": norm_gap(program["grad_norms"], reference["grad_norms"], every),
        "change_gap": norm_gap(program["change_norms"], reference["change_norms"], keep),
        "grad_gap_conv_median": median_gap(program["grad_norms"], reference["grad_norms"],
                                           convs),
        "change_gap_conv_median": median_gap(program["change_norms"],
                                             reference["change_norms"],
                                             [k for k in convs if k in keep]),
        "var_gap": var_gap(program["bn_vars"], reference["bn_vars"]),
    }


def verdict(values: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    return all(math.isfinite(values[k]) and values[k] <= limits[k] for k in limits)


def report(values: Mapping[str, float], limits: Mapping[str, float]) -> Dict[str, Dict]:
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}
