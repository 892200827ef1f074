"""The reference train step: the input function, the forward, the LSC loss,
the backward by autograd, and the labelled SGD of the reference's optimizer
constructor (``CILTSMOptimizerConstructorImprovised``), with gradient
accumulation.

The SGD's six groups, by parameter: the first conv's weight and every other
conv weight at the base rate with weight decay; BatchNorm's weight and bias
at the base rate without decay; other biases at twice the rate without
decay; the classifier's weights and the LSC temperature eta at
``fc_lr_scale`` times the rate with decay; a classifier bias at twice that
without. torch's SGD: g + wd w into the momentum buffer (``momentum`` times
the old one, plus that), the weight moved by -lr times the buffer. With
``accumulate`` k > 1, k micro-steps' gradients are averaged and the update
runs on every k-th step.

``precision='control'`` computes the same steps with every conv's and the
classifier's operands in fp8 (e4m3, one scale a tensor, the gradients
flowing back in e5m2): the precision one step below the configuration's
bfloat16. ``'bf16'`` rounds them to bfloat16 instead, the configuration's
own precision, to tell rounding from a fault.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from . import model
from .input_fn import input_fn


def _round(t: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """t rounded to ``fmt`` and back to t's dtype; an 8-bit format under one
    scale that maps t's largest magnitude to the format's largest."""
    if fmt == torch.bfloat16:
        return t.to(fmt).to(t.dtype)
    top = torch.finfo(fmt).max
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (t * scale).to(fmt).to(t.dtype) / scale


class _LowConv(torch.autograd.Function):
    """A conv whose operands are rounded to ``fwd`` and whose incoming
    gradient is rounded to ``bwd``, the products summed in float32."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, fwd, bwd):
        xq, wq = _round(x, fwd), _round(w, fwd)
        ctx.save_for_backward(xq, wq)
        ctx.stride, ctx.padding, ctx.bwd = stride, padding, bwd
        return F.conv2d(xq, wq, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _round(g, ctx.bwd)
        dx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, ctx.stride, ctx.padding)
        dw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, ctx.stride, ctx.padding)
        return dx, dw, None, None, None, None


def low_precision(fwd: torch.dtype, bwd: torch.dtype):
    """(conv, matmul) computing in ``fwd`` operands and ``bwd`` gradients;
    the matmul rounds its operands on the way in and passes the gradient
    straight through."""

    def conv(x, w, bias=None, stride=1, padding=0):
        return _LowConv.apply(x, w, stride, padding, fwd, bwd)

    def matmul(a, b):
        qa = a + (_round(a, fwd) - a).detach()
        qb = b + (_round(b, fwd) - b).detach()
        return qa @ qb

    return conv, matmul


PRECISIONS = {"control": (torch.float8_e4m3fn, torch.float8_e5m2),
              "bf16": (torch.bfloat16, torch.bfloat16)}


def group_of(name: str) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("fc_weights", "fc_weight", "eta"):
        return "classifier_weight"
    if leaf == "fc_bias":
        return "classifier_bias"
    if ".bn" in name or ".downsample.1." in name:
        return "bn"
    if leaf == "bias":
        return "normal_bias"
    if name == "backbone.conv1.weight":
        return "first_conv_weight"
    return "normal_weight"


def lr_and_decay(name: str, lr: float, wd: float, fc_scale: float):
    group = group_of(name)
    mult = {"first_conv_weight": 1.0, "normal_weight": 1.0, "normal_bias": 2.0, "bn": 1.0,
            "classifier_weight": fc_scale, "classifier_bias": 2.0 * fc_scale}[group]
    decays = group in ("first_conv_weight", "normal_weight", "classifier_weight")
    return lr * mult, (wd if decays else 0.0)


def train_steps(params0: Dict[str, torch.Tensor], batches: Sequence[Dict[str, torch.Tensor]],
                dropout_seeds: Sequence[int], cfg: Dict, precision: Optional[str] = None,
                rows: Optional[slice] = None) -> Dict:
    """Run ``len(batches)`` train steps from ``params0``.

    cfg: depth, segments, shift_div, dropout, alpha, margin, lr, momentum,
    weight_decay, fc_scale, accumulate. ``rows`` keeps only those rows of
    every batch (a fault of the benchmark's own tests: half of the batch).

    Returns losses (one a step), ``bn_vars`` (each BatchNorm's batch
    variance in the first step's forward), ``first_grad`` (each parameter's
    gradient as the first update takes it: the mean over its micro-steps)
    and ``params`` after the last step, all float32.
    """
    conv, matmul = (low_precision(*PRECISIONS[precision]) if precision
                    else (F.conv2d, torch.matmul))
    params = {k: v.detach().clone().float() for k, v in params0.items()}
    momentum = {k: torch.zeros_like(v) for k, v in params.items()}
    acc = {k: torch.zeros_like(v) for k, v in params.items()}
    k_acc = int(cfg["accumulate"])
    losses: List[float] = []
    first_grad = None
    bn_vars: Dict[str, torch.Tensor] = {}
    for step, (batch, seed) in enumerate(zip(batches, dropout_seeds)):
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        with torch.no_grad():
            clips = input_fn(batch, alpha=cfg["alpha"])
        scores = model.forward(leaves, clips, cfg["depth"], cfg["segments"], cfg["shift_div"],
                               cfg["dropout"], seed, conv, matmul,
                               stats=bn_vars if step == 0 else None)
        labels = batch["label"].reshape(-1).long()
        weights = batch.get("sample_weight")
        loss = model.lsc_loss(scores, labels, leaves["cls_head.eta"],
                              None if weights is None else weights.float(), cfg["margin"])
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        del leaves, scores, loss, clips
        for (name, _), g in zip(params.items(), grads):
            acc[name] += g
        if (step + 1) % k_acc:
            continue
        with torch.no_grad():
            mean = {n: a / k_acc for n, a in acc.items()}
            if first_grad is None:
                first_grad = {n: g.clone() for n, g in mean.items()}
            for name, p in params.items():
                lr, wd = lr_and_decay(name, cfg["lr"], cfg["weight_decay"], cfg["fc_scale"])
                momentum[name] = cfg["momentum"] * momentum[name] + mean[name] + wd * p
                p -= lr * momentum[name]
            acc = {k: torch.zeros_like(v) for k, v in params.items()}
    return {"losses": losses, "bn_vars": bn_vars, "first_grad": first_grad, "params": params}
