"""Incremental TSM head with growable classifiers
(port of ``bdvcil_tpu/models/heads.py``).

  * spatial average pool -> dropout -> growable classifier -> AvgConsensus
    over segments (mmaction2 TSMHead semantics)
  * ``SimpleLinear``-style linear classifier (``fc_weight``, ``fc_bias``)
  * ``LocalSimilarityClassifier`` (LSC) cosine-proxy classifier
    (``fc_weights``); with LSCLoss the learnable temperature ``eta`` is a head
    parameter
  * ``update_fc`` grows the classifier between tasks: old rows copied, new
    rows kaiming-normal.

The head returns the pooled representation and the consensus representation
beside the logits, for the KD tap ``cls_head.avg_pool``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

LSC_TYPES = ("LocalSimilarityClassifier", "LSC")
LINEAR_TYPES = ("SimpleLinear", "IncrementalNet")


def kaiming_uniform_linear(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch kaiming_uniform_(nonlinearity='linear'): U(-b, b), b = sqrt(3/fan_in)."""
    bound = math.sqrt(3.0 / shape[-1])
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


def kaiming_normal_linear(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch kaiming_normal_(nonlinearity='linear'): N(0, 1/fan_in)."""
    return torch.randn(shape, generator=generator) / math.sqrt(shape[-1])


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale by 1/keep.
    ``generator`` lives on x's device."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class IncrementalTSMHead(nn.Module):
    def __init__(
        self,
        num_classes: int,
        in_channels: int,
        num_segments: int = 8,
        classifier_type: str = "LocalSimilarityClassifier",
        nb_proxies: int = 3,
        dropout_ratio: float = 0.8,
        with_eta: bool = False,
        eta_init: float = 1.0,
        init_std: float = 0.001,  # kept for config parity; growable heads use kaiming
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.num_segments = num_segments
        self.classifier_type = classifier_type
        self.nb_proxies = nb_proxies
        self.dropout_ratio = dropout_ratio
        self.with_eta = with_eta
        self.eta_init = eta_init
        if classifier_type in LSC_TYPES:
            self.fc_weights = nn.Parameter(
                torch.zeros(num_classes, nb_proxies * in_channels, device=device))
        elif classifier_type in LINEAR_TYPES:
            self.fc_weight = nn.Parameter(torch.zeros(num_classes, in_channels, device=device))
            self.fc_bias = nn.Parameter(torch.zeros(num_classes, device=device))
        else:
            raise ValueError(f"unknown classifier type {classifier_type!r}")
        if with_eta:
            self.eta = nn.Parameter(torch.full((1,), float(eta_init), device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX initializers, drawn on the CPU from ``generator``."""
        if self.classifier_type in LSC_TYPES:
            self.fc_weights.copy_(kaiming_normal_linear(tuple(self.fc_weights.shape), generator))
        else:
            self.fc_weight.copy_(kaiming_uniform_linear(tuple(self.fc_weight.shape), generator))
            self.fc_bias.zero_()
        if self.with_eta:
            self.eta.fill_(self.eta_init)

    def forward(
        self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """x: (N*T, H, W, C) backbone features. Returns 'cls_score' (groups,
        num_classes), 'avg_pool' (N*T, C) KD tap, 'repr' (groups, C)."""
        # spatial average pool, f32 accumulation, rounded to the input dtype
        pooled = x.mean(dim=(1, 2), dtype=torch.float32).to(x.dtype).float()
        h = pooled
        if train and self.dropout_ratio > 0:
            h = dropout(h, self.dropout_ratio, generator)
        if self.classifier_type in LSC_TYPES:
            scores = self._lsc_forward(h, self.fc_weights)
        else:
            scores = h @ self.fc_weight.t() + self.fc_bias
        groups = scores.reshape(-1, self.num_segments, scores.shape[-1]).mean(dim=1)
        repr_consensus = pooled.reshape(-1, self.num_segments, pooled.shape[-1]).mean(dim=1)
        return {"cls_score": groups, "avg_pool": pooled, "repr": repr_consensus}

    def _lsc_forward(self, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """Cosine similarity against per-class proxies, softmax-reduced."""
        nc = weights.shape[0]
        proxies = weights.reshape(nc * self.nb_proxies, self.in_channels)
        x_norm = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)
        p_norm = proxies / torch.clamp(
            torch.linalg.vector_norm(proxies, dim=-1, keepdim=True), min=1e-8)
        sims = (x_norm @ p_norm.t()).reshape(-1, nc, self.nb_proxies)
        return torch.sum(torch.softmax(sims, dim=2) * sims, dim=2)


def head_param_path(module: nn.Module) -> nn.Module:
    """The head inside a recognizer (or the module itself if it is a head)."""
    for name in ("cls_head", "head"):
        if hasattr(module, name):
            return getattr(module, name)
    return module


@torch.no_grad()
def update_fc(
    module: nn.Module, new_num_classes: int, generator: Optional[torch.Generator] = None
) -> nn.Module:
    """Grow the classifier to ``new_num_classes`` in place (reference update_fc).

    Old rows are copied; new rows are kaiming-normal from ``generator`` (a CPU
    generator; both classifier types grow with kaiming_normal). Works on a
    recognizer or a bare head; returns ``module``. The parameters are new
    tensors, so an optimizer built before the growth must be built anew.
    """
    head = head_param_path(module)
    old_nc = head.num_classes
    if new_num_classes < old_nc:
        raise ValueError(f"cannot shrink classifier {old_nc} -> {new_num_classes}")
    names = ("fc_weights",) if head.classifier_type in LSC_TYPES else ("fc_weight",)
    for name in names:
        old = getattr(head, name)
        new = kaiming_normal_linear((new_num_classes, old.shape[1]), generator)
        new = new.to(device=old.device, dtype=old.dtype)
        new[:old_nc] = old
        setattr(head, name, nn.Parameter(new))
    if head.classifier_type in LINEAR_TYPES:
        new_b = torch.zeros(new_num_classes, dtype=head.fc_bias.dtype, device=head.fc_bias.device)
        new_b[:old_nc] = head.fc_bias
        head.fc_bias = nn.Parameter(new_b)
    head.num_classes = new_num_classes
    return module
