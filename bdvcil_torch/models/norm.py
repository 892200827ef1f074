"""BatchNorm with flax semantics, and the grouped BatchNorm of the reference's
per-GPU statistics.

``BatchNorm`` ports the ``flax.linen.BatchNorm`` the JAX backbone uses
(through ``bdvcil_tpu/models/resnet_tsm.py::_make_bn`` with ``bn_groups ==
1``). It differs from ``torch.nn.BatchNorm2d`` in ways that change numbers:

  * momentum 0.9 in the flax convention: ``ra = 0.9 * ra + 0.1 * batch``;
  * statistics in f32 from the input whatever its dtype, with
    ``var = max(0, E[x^2] - E[x]^2)``;
  * the running variance takes the BIASED batch variance (torch takes the
    unbiased one, an n/(n-1) difference);
  * the normalize ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` runs in
    f32 and is cast once to ``dtype`` (the backbone's ``norm_dtype``).

Train mode runs through ``ops/batchnorm.py``: on a card one autograd
Function, the hand-written kernels of ``csrc/batchnorm.cu`` forward and
backward (the analytic backward); on the CPU their plain versions, this
formula in eager torch, differentiated by autograd. ``relu=True`` applies
the relu that follows at the call site in the same pass. Under a process
group its train-mode statistics are those of the global batch, as the JAX
package computes them under SPMD: the f32 (sum x, sum x^2, count) are
all-reduced, and the backward all-reduces their gradients, or on a card
the sums that dx takes (``parallel/distributed.global_sums``).
``torch.nn.SyncBatchNorm`` is not used: it keeps the unbiased running
variance and torch's momentum.

``GroupedBatchNorm`` ports ``bdvcil_tpu/models/norm.py``: train-mode
statistics over ``groups`` contiguous row blocks of the (N*T) axis, and with
``stats_rows`` > 0 ghost statistics from each group's first rows, normalized
in the compute dtype. ``groups`` counts the groups of the GLOBAL batch: with
W ranks each holds groups / W of them (``'per_device'`` gives one a rank, the
reference's DDP-without-SyncBN), and a single group spans the ranks. The
running statistics take the mean over all groups, so every rank's buffers
stay equal.

A train-mode application is the span ``model.bn`` (``utils/profiling.py``).

Parameters are named like torchvision's (``weight``, ``bias``,
``running_mean``, ``running_var``) so state dicts convert one to one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import batchnorm
from ..parallel import distributed
from ..utils.profiling import annotate


class BatchNorm(nn.Module):
    def __init__(
        self,
        num_features: int,
        momentum: float = 0.9,
        epsilon: float = 1e-5,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype  # output dtype; None keeps the input's
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x: torch.Tensor, train: bool, relu: bool = False) -> torch.Tensor:
        """x: (N, C, H, W); statistics over N, H, W (and over every rank's rows
        under a process group). ``relu`` applies the relu that follows. Train
        mode is ``ops/batchnorm.batchnorm_train`` (the kernels on a card, which
        take channels_last memory; any layout on the CPU)."""
        with annotate("model.bn", train):
            if train:
                return batchnorm.batchnorm_train(x, self, self.dtype or x.dtype, relu)
            mul = torch.rsqrt(self.running_var + self.epsilon) * self.weight
            y = ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                 + self.bias[:, None, None]).to(self.dtype or x.dtype)
            return F.relu(y) if relu else y


class GroupedBatchNorm(BatchNorm):
    """Train-mode statistics per contiguous row group of the global batch
    (``groups``), optionally from each group's first ``stats_rows`` rows."""

    def __init__(self, num_features: int, groups: int = 1, stats_rows: int = 0, **kw):
        super().__init__(num_features, **kw)
        self.groups = int(groups)
        self.stats_rows = int(stats_rows)

    def _layout(self, n_local: int):
        """(groups on this rank, rows per group, this rank's rows in the
        statistics prefix of a group spanning the ranks, or None)."""
        world, rank = distributed.process_count(), distributed.process_index()
        g = self.groups
        if g == 1 and world > 1:
            # one group over every rank's rows: this rank's share of its prefix
            k = min(self.stats_rows, n_local * world) if self.stats_rows else n_local * world
            return 1, n_local, max(0, min(n_local, k - rank * n_local))
        if g % world:
            raise ValueError(f"bn groups {g} do not split over {world} ranks (give 1, a "
                             f"multiple of the rank count, or 'per_device')")
        local = g // world
        if n_local % local:
            raise ValueError(f"leading dim {n_local} not divisible by {local} bn groups a rank")
        return local, n_local // local, None

    def forward(self, x: torch.Tensor, train: bool, relu: bool = False) -> torch.Tensor:
        """x: (N, C, H, W); returns ``dtype`` (else x's dtype), relu'd with
        ``relu``."""
        out_dtype = self.dtype or x.dtype
        if not train:
            inv = self.weight / torch.sqrt(self.running_var + self.epsilon)
            y = ((x.to(out_dtype) - self.running_mean.to(out_dtype)[:, None, None])
                 * inv.to(out_dtype)[:, None, None] + self.bias.to(out_dtype)[:, None, None])
        else:
            with annotate("model.bn"):
                y = self._train_forward(x, out_dtype)
        return F.relu(y) if relu else y

    def _train_forward(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        n, c = x.shape[0], x.shape[1]
        groups, rows, prefix = self._layout(n)
        xg = x.reshape(groups, rows, *x.shape[1:])
        dims = (1, 3, 4)  # rows + spatial, keep (G, C)
        shape = (groups, 1, c, 1, 1)
        if prefix is None:
            k = min(self.stats_rows, rows) if self.stats_rows else 0
            xs = (xg[:, :k] if k else xg).float()
            mean = xs.mean(dim=dims)
            var = (xs * xs).mean(dim=dims) - mean * mean
        else:
            # the group spans the ranks: sums over this rank's share, all-reduced
            k = self.stats_rows
            xs = xg[:, :prefix].float()
            s1, s2, count = distributed.global_sums(
                xs.sum(dim=dims).reshape(-1), (xs * xs).sum(dim=dims).reshape(-1),
                xs.new_full((1,), float(prefix * x.shape[2] * x.shape[3])))
            mean = (s1 / count).reshape(1, c)
            var = (s2 / count).reshape(1, c) - mean * mean

        if k:
            # ghost statistics: normalize in the compute dtype
            inv = (self.weight[None] / torch.sqrt(var + self.epsilon)).to(out_dtype)
            y = (xg.to(out_dtype) - mean.to(out_dtype).reshape(shape)) * inv.reshape(shape)
            y = y.reshape(x.shape) + self.bias.to(out_dtype)[:, None, None]
        else:
            y = (xg.float() - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + self.epsilon)
            y = y.reshape(x.shape).to(out_dtype)
            y = y * self.weight.to(out_dtype)[:, None, None] + self.bias.to(out_dtype)[:, None, None]

        with torch.no_grad():
            if prefix is None and distributed.process_count() > 1:
                # the mean over every rank's groups
                sm, sv = distributed.global_sums(mean.sum(dim=0), var.sum(dim=0))
                self._update_running(sm / self.groups, sv / self.groups)
            else:
                self._update_running(mean.mean(dim=0), var.mean(dim=0))
        return y
