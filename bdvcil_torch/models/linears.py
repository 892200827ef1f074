"""PyCIL-style classifier heads (port of ``bdvcil_tpu/models/linears.py``).

The live classifiers are the linear and LSC heads of ``models/heads.py``;
these are the vendored PyCIL heads of the reference's public surface
(libs/models/cil_heads/linears.py:11-170):

  * ``SimpleLinear``      — linear with kaiming-uniform init
  * ``CosineLinear``      — cosine classifier with an optional learnable sigma
  * ``SplitCosineLinear`` — old/new-class cosine halves sharing one sigma
  * ``reduce_proxies``    — softmax-weighted proxy reduction
  * ``nca_loss``          — the PyCIL NCA with a fixed scale (the live path
                            uses ``losses.lsc_nca_loss``)

Parameter names follow the JAX modules (``weight``, ``bias``, ``sigma``,
``fc1.weight``, ``fc2.weight``), so ``models/convert.linear_from_jax`` maps
a flax parameter tree one to one. Initial draws come from a CPU
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..losses import lsc_nca_loss
from .heads import kaiming_normal_linear, kaiming_uniform_linear


def reduce_proxies(similarities: torch.Tensor, nb_proxies: int) -> torch.Tensor:
    """(B, C*P) proxy similarities -> (B, C) softmax-weighted reduction."""
    if nb_proxies == 1:
        return similarities
    sims = similarities.reshape(similarities.shape[0], -1, nb_proxies)
    return torch.sum(torch.softmax(sims, dim=-1) * sims, dim=-1)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


class SimpleLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(kaiming_uniform_linear((out_features, in_features), generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.t() + self.bias


class CosineLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, nb_proxies: int = 1,
                 to_reduce: bool = False, sigma: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nb_proxies, self.to_reduce = nb_proxies, to_reduce
        self.weight = nn.Parameter(
            kaiming_normal_linear((out_features * nb_proxies, in_features), generator))
        self.sigma = nn.Parameter(torch.ones(1)) if sigma else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _l2_normalize(x) @ _l2_normalize(self.weight).t()
        if self.to_reduce:
            out = reduce_proxies(out, self.nb_proxies)
        if self.sigma is not None:
            out = self.sigma.reshape(()) * out
        return out


class SplitCosineLinear(nn.Module):
    """Two cosine sub-classifiers (old classes, new classes) sharing a sigma."""

    def __init__(self, in_features: int, out_features1: int, out_features2: int,
                 nb_proxies: int = 1, sigma: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nb_proxies = nb_proxies
        self.fc1 = CosineLinear(in_features, out_features1, nb_proxies, False, False, generator)
        self.fc2 = CosineLinear(in_features, out_features2, nb_proxies, False, False, generator)
        self.sigma = nn.Parameter(torch.ones(1)) if sigma else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = reduce_proxies(torch.cat([self.fc1(x), self.fc2(x)], dim=-1), self.nb_proxies)
        if self.sigma is not None:
            out = self.sigma.reshape(()) * out
        return out


def nca_loss(
    similarities: torch.Tensor,
    targets: torch.Tensor,
    scale: float = 1.0,
    margin: float = 0.6,
    class_weights: Optional[torch.Tensor] = None,
    exclude_pos_denominator: bool = True,
    hinge_proxynca: bool = True,
) -> torch.Tensor:
    """PyCIL NCA with a fixed scale (the live path's learnable-eta variant is
    ``losses.lsc_nca_loss``)."""
    return lsc_nca_loss(
        similarities,
        targets,
        torch.full((1,), float(scale), device=similarities.device),
        margin=margin,
        exclude_pos_denominator=exclude_pos_denominator,
        hinge_proxynca=hinge_proxynca,
        class_weights=class_weights,
    )
