"""The CIL train and eval steps (port of ``bdvcil_tpu/runtime/steps.py``).

  * 'base'            — loss_cls (CE or LSC/NCA) + per-module feature-KD MSE
                        between the current model's taps (train mode) and the
                        previous model's (eval mode, no gradient), from task 1 on
  * 'icarl'           — CE on soft targets: one-hot for new classes, the
                        previous model's softmax for old-class samples;
                        ActorCutMix lambda smoothing when the batch carries
                        foreground_ratio
  * 'icarl_video_mix' — tube-CutMix of the batch, then the iCaRL loss

The step runs eagerly: the input function (when given), forward, backward,
then the labeled SGD update in place (with gradient accumulation, every k-th
call; ``optim.py``), each a span of ``utils/profiling.py`` (``step.input_fn``,
``step.forward`` with the loss's ``step.loss`` in it, ``step.backward``,
``step.optimizer``) under a ``torch.profiler`` session.
``make_multi_train_step`` runs K steps per call.

Under a process group (``parallel/distributed.py``) each rank runs the step on
its rows of the global batch: its loss is its share of the global loss (the
denominators are all-reduced, ``losses.py``), BatchNorm takes the global
batch's statistics, the gradients are summed over the ranks after every
backward (one flat all-reduce; the module stays unwrapped, so no
``module.`` prefix reaches a checkpoint), dropout and tube-CutMix draw for
the global batch, and the metrics are the global losses. W ranks then take
the step one process takes on the whole batch.

``make_eval_step`` is the forward of ``predict_step``: raw per-group scores
and L2-normalized representations, from a float batch, uint8 crops (5-D
centre, 6-D TenCrop) or the full-frame yuv420 eval wire;
``make_multi_eval_step`` runs K batches per call.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ..losses import (
    acm_smooth_targets,
    cross_entropy,
    feature_kd_loss,
    lsc_nca_loss,
    soft_target_ce,
)
from ..models.builder import ModelSpec
from ..models.heads import head_param_path
from ..parallel import distributed, mesh
from ..ops.augment import (
    draw_tubemix,
    eval_yuv_full_crops,
    normalize_batch,
    tencrop_expand,
    tubemix,
)
from ..utils.profiling import annotate
from .train_state import TrainState

METHODS = ("base", "icarl", "icarl_video_mix")


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
    video_mix: Optional[Dict[str, float]] = None,
    input_fn: Optional[Callable] = None,
) -> Callable:
    """The train step for one task.

    kd_config ('base', task > 0): {'module_names', 'module_weights',
    'scale_factor', 'exemplar_only'}. video_mix ('icarl_video_mix'):
    {'alpha', 'prob'} of tube-CutMix.

    Returned step signature:
        step(state, prev_model, imgs, labels, extra, generator) -> (state, metrics)
    imgs: (B, M, H, W, C), or with ``input_fn`` the wire batch that
    ``input_fn(imgs)`` turns into it first (``data/device_pipeline.py``);
    labels (B,) or (B, 1); extra: dict of optional tensors ('sample_weight',
    and for 'icarl' with ActorCutMix 'foreground_ratio', 'background_label')
    — pass {} when unused; prev_model may be None at task 0 or when KD is
    off; generator (on the batch's device) drives dropout and, for
    'icarl_video_mix', the tube-CutMix draws (taken first). The state's
    module is updated in place, on every ``tx.accumulate_steps``-th call:
    the calls between add their gradients to ``p.grad``. Metrics are device
    tensors.
    """
    if method not in METHODS:
        # the trainer maps 'oracle' and 'finetune' to 'base' before it builds a step
        raise ValueError(f"method {method!r} is not a step method {METHODS}; the CIL "
                         f"trainer maps 'oracle' and 'finetune' to 'base' (cil/trainer.py)")
    if method == "icarl_video_mix" and video_mix is None:
        raise ValueError("method 'icarl_video_mix' needs video_mix={'alpha', 'prob'}")
    use_kd = method == "base" and kd_config is not None and task_idx > 0
    use_prev_targets = method != "base" and task_idx > 0

    def base_loss(module, prev_model, imgs, labels, sample_weights, generator):
        out = module(imgs, train=True, generator=generator)
        with annotate("step.loss"):
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
            return total, metrics

    def icarl_loss(module, prev_model, imgs, labels, extra, sample_weights, generator):
        targets = torch.nn.functional.one_hot(labels.long(), num_classes).float()
        if method == "icarl" and "foreground_ratio" in extra:
            targets = acm_smooth_targets(labels, _squeeze_labels(extra["background_label"]),
                                         extra["foreground_ratio"].float(), num_classes,
                                         alpha=4.0)
        if method == "icarl_video_mix":
            # the mix permutes the global batch: gather every rank's rows,
            # mix them as one process would, keep this rank's
            g_imgs, g_targets = mesh.all_gather_rows(imgs), mesh.all_gather_rows(targets)
            b, _, h, w, _ = g_imgs.shape
            draws = draw_tubemix(generator, b, h, w, video_mix["alpha"], video_mix["prob"],
                                 device=imgs.device)  # on the generator's device if given
            g_imgs, g_targets = tubemix(g_imgs, g_targets, **draws)
            lo, hi = mesh.local_rows(b)
            imgs, targets = g_imgs[lo:hi], g_targets[lo:hi]
        out = module(imgs, train=True, generator=generator)
        with annotate("step.loss"):
            # average_clips='score' in iCaRL: the raw score mean over clips
            cls_score = out["cls_score"].mean(dim=1)
            if use_prev_targets:
                with torch.no_grad():
                    prev_scores = prev_model(imgs, train=False)["cls_score"].mean(dim=1)
                    prev_probs = torch.softmax(prev_scores, dim=-1)
                is_old = (labels < prev_num_classes)[:, None]
                targets = torch.where(is_old, prev_probs, targets)
            loss = soft_target_ce(cls_score, targets, sample_weights)
            return loss, {"loss_cls": loss, "kd_loss": torch.zeros((), device=loss.device)}

    def step(state: TrainState, prev_model, imgs, labels, extra, generator=None):
        module = state.module
        if head_param_path(module).num_classes != num_classes:
            raise ValueError(f"the module's head has {head_param_path(module).num_classes} "
                             f"classes, the step was built for {num_classes}")
        if input_fn is not None:
            with annotate("step.input_fn"), torch.no_grad():
                imgs = input_fn(imgs)
        labels = _squeeze_labels(labels)
        sample_weights = extra.get("sample_weight")
        with annotate("step.forward"):
            if method == "base":
                total, metrics = base_loss(module, prev_model, imgs, labels, sample_weights,
                                           generator)
            else:
                total, metrics = icarl_loss(module, prev_model, imgs, labels, extra,
                                            sample_weights, generator)
        with annotate("step.backward"):
            if distributed.is_initialized():
                _backward_all_reduced(module, total)
            else:
                total.backward()  # adds to p.grad, which holds the accumulation window's sum
        if (state.step + 1) % tx.accumulate_steps:
            new_opt_state = state.opt_state  # a micro-step: no update yet
        else:
            with annotate("step.optimizer"):
                new_opt_state = tx.step(module, state.opt_state)
                module.zero_grad(set_to_none=True)
        metrics["loss"] = total
        metrics = _global_metrics({k: v.detach() for k, v in metrics.items()})
        return TrainState(module=module, opt_state=new_opt_state, step=state.step + 1), metrics

    step.needs_prev = use_kd or use_prev_targets
    return step


def _backward_all_reduced(module: nn.Module, total: torch.Tensor) -> None:
    """The backward of one rank's share of the loss, its gradients summed over
    the ranks, then added to the window's sum in ``p.grad``: after every
    micro-step each rank's ``p.grad`` holds the global sum of the window so
    far (``optax.MultiSteps`` in JAX), so a snapshot inside a window is whole."""
    params = [p for p in module.parameters() if p.requires_grad]
    window = [p.grad for p in params]
    for p in params:
        p.grad = None
    total.backward()
    distributed.all_reduce_gradients(params)
    for p, g in zip(params, window):
        if g is not None:
            if p.grad is None:
                p.grad = g
            else:
                p.grad.add_(g)


def _global_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ranks' loss shares summed into the global batch's losses (each
    rank's loss divides by the global denominators, ``losses.py``)."""
    if not distributed.is_initialized():
        return metrics
    keys = sorted(metrics)
    total = distributed.global_sums(*[metrics[k].float().reshape(1) for k in keys])
    return {k: v[0] for k, v in zip(keys, total)}


def _slot(tree, k: int):
    if isinstance(tree, dict):
        return {key: v[k] for key, v in tree.items()}
    return tree[k]


def make_multi_train_step(step_kwargs: Dict[str, Any], steps_per_dispatch: int) -> Callable:
    """K train steps per call, the counterpart of the JAX ``lax.scan``
    super-step. Eager PyTorch has no dispatch to save, so this is a loop over
    the single step, with its contract:

        step(state, prev_model, imgs, labels, extra, generators) -> (state, metrics)

    every tensor in ``imgs`` (a tensor or a wire dict), ``labels`` and
    ``extra`` carries a leading ``steps_per_dispatch`` axis, one slot per
    inner step; ``generators`` is a sequence of K generators, one per inner
    step (or None). ``metrics`` are the last inner step's.
    ``step_kwargs`` are :func:`make_train_step`'s keyword arguments.
    """
    if steps_per_dispatch < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
    inner = make_train_step(**step_kwargs)

    def multi(state, prev_model, imgs, labels, extra, generators: Optional[Sequence] = None):
        if generators is not None and len(generators) != steps_per_dispatch:
            raise ValueError(f"{len(generators)} generators for {steps_per_dispatch} steps")
        metrics = {}
        for k in range(steps_per_dispatch):
            state, metrics = inner(state, prev_model, _slot(imgs, k), labels[k], _slot(extra, k),
                                   None if generators is None else generators[k])
        return state, metrics

    multi.needs_prev = inner.needs_prev
    return multi


def _eval_forward(spec: ModelSpec, module: nn.Module, imgs) -> Dict[str, torch.Tensor]:
    if isinstance(imgs, dict):
        # the full-frame yuv420 wire: crops, flips and YCbCr -> RGB on the device
        rgb = eval_yuv_full_crops(imgs)
        rgb = rgb[:, :, 0] if rgb.shape[2] == 1 else tencrop_expand(rgb)
        imgs = normalize_batch(rgb, dtype=spec.dtype)
    elif imgs.dtype == torch.uint8:
        if imgs.dim() == 6:  # (B, T, 5, h, w, C) from the TenCrop decoder
            imgs = tencrop_expand(imgs)
        imgs = normalize_batch(imgs, dtype=spec.dtype)
    out = module(imgs, train=False)
    repr_ = out["repr"]
    norm = torch.linalg.vector_norm(repr_, dim=-1, keepdim=True)
    return {"cls_score": out["cls_score"], "repr": repr_ / torch.clamp(norm, min=1e-12)}


def make_eval_step(spec: ModelSpec, num_classes: int) -> Callable:
    """The eval forward (``predict_step``, reference cil.py:558-578):

        eval_step(module, imgs) -> {'cls_score': (B, G, nc), 'repr': (B, G, C)}

    raw scores and L2-normalized representations, under ``torch.no_grad``
    with BatchNorm's running statistics. ``imgs``: a normalized float batch
    (B, M, H, W, C); uint8 crops (B, T, h, w, C) or TenCrop's (B, T, 5, h, w,
    C), normalized (and flipped) here; or the ``yuv420_full`` wire dict
    {imgs_y, imgs_c, crop_yx_<px>} of ``FastEvalLoader``."""

    def eval_step(module: nn.Module, imgs) -> Dict[str, torch.Tensor]:
        if head_param_path(module).num_classes != num_classes:
            raise ValueError(f"the module's head has {head_param_path(module).num_classes} "
                             f"classes, the eval step was built for {num_classes}")
        with torch.no_grad():
            return _eval_forward(spec, module, imgs)

    return eval_step


def make_multi_eval_step(spec: ModelSpec, num_classes: int, steps_per_dispatch: int) -> Callable:
    """K eval forwards per call, the counterpart of JAX's ``lax.map`` form:
    every leaf of ``imgs`` carries a leading K axis, and every output leaf is
    stacked (K, B, ...). Each slot is exactly one ``make_eval_step`` call."""
    if steps_per_dispatch < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
    single = make_eval_step(spec, num_classes)

    def multi(module: nn.Module, imgs) -> Dict[str, torch.Tensor]:
        outs = [single(module, _slot(imgs, k)) for k in range(steps_per_dispatch)]
        return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}

    return multi
