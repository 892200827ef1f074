"""Optimizer + LR schedule (port of ``bdvcil_tpu/optim.py``).

The reference optimizer policy (``CILTSMOptimizerConstructorImprovised``)
partitions parameters into groups

  first_conv_weight : base lr,            weight decay
  normal_weight     : base lr,            weight decay
  normal_bias       : 2x lr,              no decay
  bn                : base lr,            no decay
  classifier_weight : fc_scale x lr,      weight decay   (LSC weights,
                      linear weight, LSCLoss eta)
  classifier_bias   : 2*fc_scale x lr,    no decay       (linear bias)
  norm              : base lr,            no decay       (LayerNorm)
  embed             : base lr,            no decay       (TimeSformer's
                      cls_token, pos_embed, time_embed: mmaction2's
                      decay_mult=0 keys)

A linear's bias, ``in_proj_bias`` among them, is ``normal_bias``.

SGD semantics match torch: grad += wd * w, buf = momentum * buf + grad,
update = -lr(t) * buf, with the schedule stepped once per epoch. Before the
update, frozen gradients are zeroed and then the global-norm clip is applied
with optax's formula, so the clip never counts frozen gradients.

Parameters are updated in place; the momentum buffers live in the optimizer
state dict that ``init`` returns and ``step`` carries.

Gradient accumulation (``accumulate_steps`` k > 1) is ``optax.MultiSteps``
with the sum kept in ``p.grad``: the train step (``runtime/steps.py``) lets
autograd add k micro-steps' gradients there and calls ``step`` on every k-th
one, which applies the update above to their mean ``p.grad / k``. The
schedule counts updates, not micro-steps.
"""

from __future__ import annotations

import bisect
import itertools
import math
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .models.norm import BatchNorm
from .utils.profiling import annotate

CLASSIFIER_LEAVES = {"fc_weights", "fc_weight", "eta"}
CLASSIFIER_BIAS_LEAVES = {"fc_bias"}
EMBED_LEAVES = {"cls_token", "pos_embed", "time_embed"}
BIAS_LEAVES = {"bias", "in_proj_bias"}
FIRST_CONV = ("backbone.conv1.weight", "conv1.weight")

GROUP_POLICY = {
    # label: (lr multiplier given fc_scale, use weight decay)
    "first_conv_weight": (lambda s: 1.0, True),
    "normal_weight": (lambda s: 1.0, True),
    "normal_bias": (lambda s: 2.0, False),
    "bn": (lambda s: 1.0, False),
    "classifier_weight": (lambda s: s, True),
    "classifier_bias": (lambda s: 2.0 * s, False),
    "norm": (lambda s: 1.0, False),
    "embed": (lambda s: 1.0, False),
}

MAX_EPOCHS = 4096


def label_params(module: nn.Module) -> Dict[str, str]:
    """An optimizer-group label for every parameter, by its state_dict name."""

    def params_of(kind):
        return {f"{mod_name}.{p_name}" if mod_name else p_name
                for mod_name, mod in module.named_modules() if isinstance(mod, kind)
                for p_name, _ in mod.named_parameters(recurse=False)}

    bn_params, ln_params = params_of(BatchNorm), params_of(nn.LayerNorm)
    labels = {}
    for name, _ in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in CLASSIFIER_LEAVES:
            labels[name] = "classifier_weight"
        elif leaf in CLASSIFIER_BIAS_LEAVES:
            labels[name] = "classifier_bias"
        elif name in bn_params:
            labels[name] = "bn"
        elif name in ln_params:
            labels[name] = "norm"
        elif leaf in EMBED_LEAVES:
            labels[name] = "embed"
        elif leaf in BIAS_LEAVES:
            labels[name] = "normal_bias"
        elif name in FIRST_CONV:
            labels[name] = "first_conv_weight"
        else:
            labels[name] = "normal_weight"
    return labels


def build_lr_factor_fn(
    cfg: Optional[Mapping], base_lr: Optional[float] = None
) -> Callable[[int], float]:
    """torch.optim.lr_scheduler factor semantics, keyed by epoch."""
    if not cfg:
        return lambda epoch: 1.0
    kind = cfg["type"]
    p = dict(cfg.get("params", {}))

    if kind == "StepLR":
        step_size, gamma = p["step_size"], p.get("gamma", 0.1)
        return lambda e: gamma ** (e // step_size)
    if kind == "MultiStepLR":
        milestones = sorted(p["milestones"])
        gamma = p.get("gamma", 0.1)
        return lambda e: gamma ** bisect.bisect_right(milestones, e)
    if kind == "LinearLR":
        start = p.get("start_factor", 1.0 / 3)
        end = p.get("end_factor", 1.0)
        total = p.get("total_iters", 5)
        return lambda e: start + (end - start) * min(e, total) / total
    if kind == "ExponentialLR":
        gamma = p["gamma"]
        return lambda e: gamma**e
    if kind == "CosineAnnealingLR":
        t_max = p["T_max"]
        if "eta_min" in p:  # torch's absolute-lr kwarg
            if not base_lr:
                raise ValueError("CosineAnnealingLR eta_min needs base_lr")
            eta_min_factor = p["eta_min"] / base_lr
        else:
            eta_min_factor = p.get("eta_min_factor", 0.0)
        return lambda e: eta_min_factor + (1 - eta_min_factor) * (
            1 + math.cos(math.pi * e / t_max)
        ) / 2
    raise KeyError(f"unknown lr scheduler {kind!r}")


class LabeledSGD:
    """The 6-group SGD policy, optional frozen leaves and global-norm clip.

    ``init(module)`` returns the state ``{'momentum': {name: tensor},
    'count': int}``; ``step(module, state)`` reads ``p.grad`` (the sum of
    ``accumulate_steps`` micro-steps' gradients), updates the parameters in
    place and returns the new state.
    """

    def __init__(self, labels: Dict[str, str], base_lr: float, momentum: float,
                 weight_decay: float, fc_scale: float, factor_table: np.ndarray,
                 steps_per_epoch: int, grad_clip: Optional[float], accumulate_steps: int = 1):
        self.labels = labels
        self.base_lr = base_lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.fc_scale = fc_scale
        self.factor_table = factor_table
        self.steps_per_epoch = max(1, steps_per_epoch)
        self.grad_clip = grad_clip
        self.accumulate_steps = max(1, int(accumulate_steps))

    def init(self, module: nn.Module) -> Dict:
        return {
            "momentum": {n: torch.zeros_like(p) for n, p in module.named_parameters()},
            "count": 0,
        }

    @torch.no_grad()
    def step(self, module: nn.Module, state: Dict) -> Dict:
        params = dict(module.named_parameters())
        if set(params) != set(self.labels):
            raise ValueError("the module's parameters differ from those the optimizer labeled")
        k = self.accumulate_steps
        # frozen leaves get no gradient at all, before the clip sees any
        grads = {
            n: torch.zeros_like(p) if (p.grad is None or self.labels[n] == "frozen")
            else p.grad if k == 1 else p.grad / k
            for n, p in params.items()
        }
        if self.grad_clip is not None:
            # optax.clip_by_global_norm: g if norm < max else g / norm * max
            norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
            clip = self.grad_clip
            grads = {n: torch.where(norm < clip, g, g / norm.to(g.dtype) * clip)
                     for n, g in grads.items()}
        epoch = min(state["count"] // self.steps_per_epoch, len(self.factor_table) - 1)
        factor = self.factor_table[epoch]
        new_m = {}
        # a span a top-level stage of the module (backbone.layer3, ...): the
        # gaps of a traced update stay within reach of a span's start
        for _, stage in itertools.groupby(params.items(), key=lambda kv: kv[0].split(".")[:2]):
            with annotate("optim.update"):
                for n, p in stage:
                    label = self.labels[n]
                    if label == "frozen":
                        new_m[n] = state["momentum"][n]
                        continue
                    mult_fn, use_wd = GROUP_POLICY[label]
                    g32 = grads[n].float()
                    if use_wd and self.weight_decay:
                        g32 = g32 + self.weight_decay * p.float()
                    m = self.momentum * state["momentum"][n] + g32 if self.momentum else g32
                    coef = float(np.float32(-self.base_lr * mult_fn(self.fc_scale)) * factor)
                    p.add_((coef * m).to(p.dtype))
                    new_m[n] = m
        return {"momentum": new_m, "count": state["count"] + 1}


def build_optimizer(
    module: nn.Module,
    optimizer_cfg: Mapping,
    lr_scheduler_cfg: Optional[Mapping] = None,
    steps_per_epoch: int = 1,
    grad_clip: Optional[float] = None,
    accumulate_steps: int = 1,
    freeze_backbone: bool = False,
) -> LabeledSGD:
    """The labeled SGD from a reference-shaped optimizer config:

        optimizer = dict(type='SGD',
                         constructor='CILTSMOptimizerConstructorImprovised',
                         paramwise_cfg=dict(fc_lr_scale_factor=5.0),
                         lr=0.01, momentum=0.9, weight_decay=0.0001)
    """
    if optimizer_cfg.get("type", "SGD") != "SGD":
        raise ValueError(f"only SGD exists, got {optimizer_cfg.get('type')!r}")
    base_lr = optimizer_cfg["lr"]
    paramwise = optimizer_cfg.get("paramwise_cfg", {}) or {}
    fc_scale = paramwise.get("fc_lr_scale_factor", 1.0)
    if "fc_lr5" in paramwise:  # legacy CILTSMOptimizerConstructor flag
        fc_scale = 5.0 if paramwise["fc_lr5"] else 1.0

    factor_fn = build_lr_factor_fn(lr_scheduler_cfg, base_lr=base_lr)
    table = np.asarray([factor_fn(e) for e in range(MAX_EPOCHS)], np.float32)

    labels = label_params(module)
    if freeze_backbone:
        # CBF backbone freeze: the stand-in for requires_grad=False
        labels = {n: "frozen" if n.startswith("backbone.") else lbl for n, lbl in labels.items()}
    return LabeledSGD(
        labels, base_lr, optimizer_cfg.get("momentum", 0.0),
        optimizer_cfg.get("weight_decay", 0.0), fc_scale, table, steps_per_epoch, grad_clip,
        accumulate_steps,
    )
