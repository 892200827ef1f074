"""Loss functions (port of ``bdvcil_tpu/losses.py``).

  * ``cross_entropy``   — standard CE (mmaction2 CrossEntropyLoss)
  * ``lsc_nca_loss``    — PODNet NCA over cosine similarities with learnable
                          temperature eta, margin, positive-excluded
                          denominator, hinge clamp
  * ``soft_target_ce``  — iCaRL CE on soft targets
  * ``acm_smooth_targets``, ``acm_smooth_ce``
                        — ActorCutMix label smoothing with
                          lambda = 1 - (1 - fg_ratio)^alpha; the reference
                          module returns +mean(sum y*log_softmax) (a sign
                          bug): ``buggy_sign=True`` gives that literal
                          behaviour, the default the negated iCaRL loss
  * ``feature_kd_loss`` — MSE feature distillation over tagged intermediates
                          with per-module weights and per-task scale,
                          optional exemplar-only masking

Every batch mean divides by the global batch's count (``weighted_mean``,
``feature_kd_loss``): under a process group a rank's loss is its share of the
global loss, and the ranks' gradients sum to the one-process gradient of the
whole batch, pad rows and exemplar-only masks included.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from .parallel import distributed


def _global_total(x: torch.Tensor) -> torch.Tensor:
    """A denominator summed over the ranks (no gradient flows into it)."""
    return distributed.global_sums(x.detach().reshape(1))[0][0]


def weighted_mean(values: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the batch, optionally masked by per-sample weights (0 on pad rows).

    The denominator is the global batch's: under a process group each rank
    returns its own numerator over the all-reduced count or weight sum, so
    the ranks' losses, and their gradients, sum to the global ones."""
    if weights is None:
        return values.sum() / distributed.global_count(values.numel(), values)
    weights = weights.to(values.dtype)
    return torch.sum(values * weights) / torch.clamp(_global_total(torch.sum(weights)),
                                                     min=1e-8)


def cross_entropy(
    cls_score: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """cls_score: (B, C) logits, labels: (B,) int."""
    logp = torch.log_softmax(cls_score, dim=-1)
    per_sample = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
    return weighted_mean(per_sample, weights)


def lsc_nca_loss(
    similarities: torch.Tensor,
    targets: torch.Tensor,
    eta: torch.Tensor,
    margin: float = 0.6,
    exclude_pos_denominator: bool = True,
    hinge_proxynca: bool = True,
    class_weights: Optional[torch.Tensor] = None,
    sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NCA loss on cosine similarities. similarities (B, C), targets (B,) int."""
    if not exclude_pos_denominator:
        return cross_entropy(similarities, targets, sample_weights)
    targets = targets.long()
    sims = eta.reshape(()) * (similarities - margin)
    sims = sims - torch.amax(sims, dim=1, keepdim=True).detach()

    pos = torch.gather(sims, 1, targets[:, None])  # (B, 1)
    # zero out the positive column in the denominator
    disable_pos = torch.zeros_like(sims).scatter(1, targets[:, None], pos)
    denominator = sims - disable_pos

    losses = pos[:, 0] - torch.log(torch.sum(torch.exp(denominator), dim=-1))
    if class_weights is not None:
        losses = class_weights[targets] * losses
    losses = -losses
    if hinge_proxynca:
        losses = torch.clamp(losses, min=0.0)
    return weighted_mean(losses, sample_weights)


def soft_target_ce(
    cls_score: torch.Tensor, soft_targets: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """-mean over batch of sum_c y_c log_softmax(s)_c."""
    logp = torch.log_softmax(cls_score, dim=-1)
    return weighted_mean(-torch.sum(soft_targets * logp, dim=-1), weights)


def acm_smooth_targets(
    labels: torch.Tensor,
    background_labels: torch.Tensor,
    foreground_ratio: torch.Tensor,
    num_classes: int,
    alpha: float = 4.0,
) -> torch.Tensor:
    """lambda-mixed one-hot targets (B, classes): the action label weighted by
    lambda = 1 - (1 - fg_ratio)^alpha, the background label by 1 - lambda.
    A background label of -1 is read as 0 (fg_ratio is 1 there)."""
    action = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    bg_labels = torch.where(background_labels == -1, 0, background_labels).long()
    bg = torch.nn.functional.one_hot(bg_labels, num_classes).float()
    lam = (1.0 - (1.0 - foreground_ratio.float()) ** alpha)[:, None]
    return action * lam + (1.0 - lam) * bg


def acm_smooth_ce(
    cls_score: torch.Tensor,
    labels: torch.Tensor,
    background_labels: torch.Tensor,
    foreground_ratio: torch.Tensor,
    num_classes: int,
    alpha: float = 4.0,
    buggy_sign: bool = False,
) -> torch.Tensor:
    """CE on ``acm_smooth_targets``; ``buggy_sign`` keeps the reference
    module's missing minus."""
    y = acm_smooth_targets(labels, background_labels, foreground_ratio, num_classes, alpha)
    loss = torch.mean(torch.sum(y * torch.log_softmax(cls_score, dim=-1), dim=-1))
    return loss if buggy_sign else -loss


def feature_kd_loss(
    current_feats: Mapping[str, torch.Tensor],
    prev_feats: Mapping[str, torch.Tensor],
    module_names: Sequence[str],
    module_weights: Sequence[float],
    scale_factor: float,
    labels: Optional[torch.Tensor] = None,
    prev_num_classes: Optional[int] = None,
    exemplar_only: bool = False,
    num_segments: int = 8,
    sample_weights: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Per-module MSE KD with weights and adaptive scale.

    With ``exemplar_only`` only samples whose label < prev_num_classes
    contribute, as a per-sample mask; ``sample_weights`` also masks padded
    rows. Returns {'kd_loss': total, '<module>': per-module unscaled mse}.
    """
    out: Dict[str, torch.Tensor] = {}
    device = next(iter(current_feats.values())).device
    total = torch.zeros((), dtype=torch.float32, device=device)

    sample_mask = None
    if exemplar_only:
        if labels is None or prev_num_classes is None:
            raise ValueError("exemplar_only needs labels and prev_num_classes")
        sample_mask = (labels < prev_num_classes).float()
    if sample_weights is not None:
        w = sample_weights.float()
        sample_mask = w if sample_mask is None else sample_mask * w

    for name, weight in zip(module_names, module_weights):
        cur = current_feats[name].float()
        prev = prev_feats[name].detach().float()
        sq = (cur - prev) ** 2
        if sample_mask is None:
            mse = sq.sum() / distributed.global_count(sq.numel(), sq)
        else:
            # features are (B*T, ...); expand the mask over segments
            per_elem = sq.reshape(sq.shape[0], -1).mean(dim=1)
            m = torch.repeat_interleave(sample_mask, per_elem.shape[0] // sample_mask.shape[0])
            mse = torch.sum(per_elem * m) / torch.clamp(_global_total(torch.sum(m)), min=1.0)
        out[name] = mse
        total = total + scale_factor * weight * mse
    out["kd_loss"] = total
    return out
