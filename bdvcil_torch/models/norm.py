"""BatchNorm with flax semantics.

Port of the ``flax.linen.BatchNorm`` the JAX backbone uses (through
``bdvcil_tpu/models/resnet_tsm.py::_make_bn`` with ``bn_groups == 1``). It
differs from ``torch.nn.BatchNorm2d`` in ways that change numbers:

  * momentum 0.9 in the flax convention: ``ra = 0.9 * ra + 0.1 * batch``;
  * statistics in f32 from the input whatever its dtype, with
    ``var = max(0, E[x^2] - E[x]^2)``;
  * the running variance takes the BIASED batch variance (torch takes the
    unbiased one, an n/(n-1) difference);
  * the normalize ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` runs in
    f32 and is cast once to ``dtype`` (the backbone's ``norm_dtype``).

Parameters are named like torchvision's (``weight``, ``bias``,
``running_mean``, ``running_var``) so state dicts convert one to one.
``GroupedBatchNorm`` (``bn_groups``/``bn_stats_rows``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


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

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """x: (N, C, H, W) in any memory format; statistics over N, H, W."""
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = (xf * xf).mean(dim=(0, 2, 3))
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype or x.dtype)
