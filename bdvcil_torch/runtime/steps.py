"""The CIL train step (port of the ``base`` branch of
``bdvcil_tpu/runtime/steps.py``).

  * 'base' — loss_cls (CE or LSC/NCA) + per-module feature-KD MSE between the
    current model's taps (train mode) and the previous model's (eval mode,
    no gradient), from task 1 on.

The step runs eagerly: forward, backward, then the labeled SGD update in
place. ``icarl``, ``icarl_video_mix``, ``input_fn`` and the multi-dispatch
variant are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..losses import cross_entropy, feature_kd_loss, lsc_nca_loss
from ..models.builder import ModelSpec
from ..models.heads import head_param_path
from .train_state import TrainState


def _squeeze_labels(labels: torch.Tensor) -> torch.Tensor:
    return labels.reshape(labels.shape[0]) if labels.dim() > 1 else labels


def _loss_cls(spec: ModelSpec, cls_score, labels, module: nn.Module, sample_weights=None):
    loss_cfg = spec.loss_cls
    if loss_cfg.get("type") == "LSCLoss":
        return lsc_nca_loss(
            cls_score,
            labels,
            head_param_path(module).eta,
            margin=loss_cfg.get("margin", 0.6),
            exclude_pos_denominator=loss_cfg.get("exclude_pos_denominator", True),
            hinge_proxynca=loss_cfg.get("hinge_proxynca", True),
            sample_weights=sample_weights,
        )
    return cross_entropy(cls_score, labels, sample_weights)


def make_train_step(
    spec: ModelSpec,
    tx,
    num_classes: int,
    method: str = "base",
    task_idx: int = 0,
    prev_num_classes: int = 0,
    kd_config: Optional[Dict[str, Any]] = None,
) -> Callable:
    """The train step for one task.

    kd_config (task > 0): {'module_names', 'module_weights', 'scale_factor',
    'exemplar_only'}.

    Returned step signature:
        step(state, prev_model, imgs, labels, extra, generator) -> (state, metrics)
    imgs: (B, M, H, W, C); labels (B,) or (B, 1); extra: dict of optional
    tensors ('sample_weight') — pass {} when unused; prev_model may be None
    when KD is off; generator drives dropout and lives on the batch's device.
    The state's module is updated in place. Metrics are device tensors.
    """
    if method != "base":
        raise NotImplementedError(f"method {method!r} is not ported yet (ROADMAP A.2)")
    use_kd = kd_config is not None and task_idx > 0

    def step(state: TrainState, prev_model, imgs, labels, extra, generator=None):
        module = state.module
        if head_param_path(module).num_classes != num_classes:
            raise ValueError(f"the module's head has {head_param_path(module).num_classes} "
                             f"classes, the step was built for {num_classes}")
        labels = _squeeze_labels(labels)
        sample_weights = extra.get("sample_weight")
        module.zero_grad(set_to_none=True)

        out = module(imgs, train=True, generator=generator)
        cls_score = out["cls_score"][:, 0, :]
        loss_cls = _loss_cls(spec, cls_score, labels, module, sample_weights)
        metrics: Dict[str, torch.Tensor] = {"loss_cls": loss_cls}
        total = loss_cls
        if use_kd:
            with torch.no_grad():
                prev_out = prev_model(imgs, train=False)
            kd = feature_kd_loss(
                out["feats"],
                prev_out["feats"],
                kd_config["module_names"],
                kd_config["module_weights"],
                kd_config["scale_factor"],
                labels=labels,
                prev_num_classes=prev_num_classes,
                exemplar_only=kd_config.get("exemplar_only", False),
                num_segments=spec.num_segments,
                sample_weights=sample_weights,
            )
            metrics.update(kd)
            total = total + kd["kd_loss"]
        else:
            metrics["kd_loss"] = torch.zeros((), device=total.device)
        total.backward()
        new_opt_state = tx.step(module, state.opt_state)
        metrics["loss"] = total
        metrics = {k: v.detach() for k, v in metrics.items()}
        return TrainState(module=module, opt_state=new_opt_state, step=state.step + 1), metrics

    return step

