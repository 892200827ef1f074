"""The TSM-ResNet family: ResNet-18/34/50/101 with TSM's residual shift and
the LSC head (the port's ``ResNetTSM`` and ``IncrementalTSMHead``), the
family of a configuration file without a ``"family"`` key.

A family is one file of ``benchmark/families/``, found by the name a
configuration file gives it. It holds what the harness knows of one kind of
model, and gives:

  * ``NUMBERS``: the check numbers a cell's ``limits`` may name;
  * ``check_config(cfg)``: raises ValueError on a configuration it cannot run;
  * ``model_config(cfg, model)``: the configuration's backbone and head keys,
    set on ``make_cil_config``'s model;
  * ``reference_config(cfg)``: the plain reference's settings;
  * ``param_shapes(cfg, num_classes)`` and
    ``make_weights(cfg, num_classes, seed, device)``: every parameter's
    name and shape, and the float32 weights drawn from the seed;
  * ``reset_buffers(module)``: the program's buffers at their start;
  * ``decay(name, ref_cfg)``: the weight decay of a parameter, which the
    first update adds to its gradient;
  * ``first_forward_readings(module, ref_cfg)``: what the check reads of the
    first forward, from the program's module after the first step;
  * ``train_flops_per_clip(cfg)``;
  * ``reference_train_steps(w0, batches, seeds, ref_cfg, precision, rows)``:
    the plain reference's steps (``precision``: None, 'control' or 'bf16',
    turned into the reference's own (conv, matmul)); returns ``losses``,
    ``first_grad``, ``params`` and the first forward's readings;
  * ``numbers(program, reference)``: every number of ``NUMBERS``.

This family's numbers, beside ``compare``'s ``loss_gap``, ``grad_gap`` and
``change_gap``:

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
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from benchmark import compare, flops
from benchmark.reference import model as ref_model
from benchmark.reference import step as ref_step

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_gap_conv_median",
           "change_gap_conv_median", "var_gap")


def check_config(cfg: Mapping) -> None:
    if cfg["depth"] not in ref_model.ARCH:
        raise ValueError(f"TSM-ResNet has no depth {cfg['depth']!r}; "
                         f"it has {sorted(ref_model.ARCH)}")


def model_config(cfg: Mapping, model: Dict) -> None:
    model["backbone"].update(depth=cfg["depth"], num_segments=cfg["num_segments"],
                             shift_div=cfg["shift_div"], shift_mode=cfg["shift_mode"],
                             conv1x1_mode=cfg["conv1x1_mode"], pretrained=None)
    head = model["cls_head"]
    head.update(in_channels=cfg["in_channels"], num_segments=cfg["num_segments"],
                dropout_ratio=cfg["dropout_ratio"])
    head["inc_head_config"]["nb_proxies"] = cfg["nb_proxies"]


def reference_config(cfg: Mapping) -> Dict:
    return dict(depth=cfg["depth"], segments=cfg["num_segments"], shift_div=cfg["shift_div"],
                dropout=cfg["dropout_ratio"], alpha=cfg["bgmix_alpha"], margin=cfg["lsc_margin"],
                lr=cfg["lr"], momentum=cfg["momentum"], weight_decay=cfg["weight_decay"],
                fc_scale=cfg["fc_lr_scale_factor"], accumulate=cfg["accumulate_grad_batches"],
                bn_momentum=cfg["bn_running_momentum"])


def param_shapes(cfg: Mapping, num_classes: int) -> Dict[str, Tuple]:
    return ref_model.param_shapes(cfg["depth"], num_classes, cfg["nb_proxies"])


def make_weights(cfg: Mapping, num_classes: int, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """The model's float32 weights from the seed, on ``device``, in one draw:
    every conv weight and the classifier's proxies N(0, 1 / fan_in) (LeCun's
    normal), BatchNorm weight 1 and bias 0, the LSC temperature 1."""
    shapes = param_shapes(cfg, num_classes)
    drawn = [n for n, s in shapes.items() if len(s) == 4 or n.endswith("fc_weights")]
    sizes = [math.prod(shapes[n]) for n in drawn]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, offset = {}, 0
    for name, size in zip(drawn, sizes):
        shape = shapes[name]
        out[name] = flat[offset:offset + size].view(shape) / math.sqrt(math.prod(shape[1:]))
        offset += size
    for name, shape in shapes.items():
        if name.endswith("eta") or (name not in out and name.endswith("weight")):
            out[name] = torch.ones(shape, device=device)
        elif name not in out:
            out[name] = torch.zeros(shape, device=device)
    return out


def reset_buffers(module: torch.nn.Module) -> None:
    """BatchNorm's running statistics start at mean 0 and variance 1."""
    with torch.no_grad():
        for name, b in module.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)


def decay(name: str, ref_cfg: Mapping) -> float:
    """The reference's decay groups (``reference/step.py``)."""
    return ref_step.lr_and_decay(name, 0.0, ref_cfg["weight_decay"], 1.0)[1]


def first_forward_readings(module: torch.nn.Module, ref_cfg: Mapping) -> Dict:
    """``bn_vars``: the first forward's batch variances, from the running
    variance it updated: new = m old + (1 - m) batch, old = 1."""
    m = ref_cfg["bn_momentum"]
    return {"bn_vars": {n[: -len(".running_var")]: ((b.detach().float() - m) / (1 - m)).cpu()
                        for n, b in module.named_buffers() if n.endswith(".running_var")}}


def train_flops_per_clip(cfg: Mapping) -> float:
    return flops.train_flops_per_clip(cfg["depth"], cfg["num_segments"], cfg["crop_size"])


def reference_train_steps(w0: Mapping[str, torch.Tensor], batches: Sequence[Dict],
                          seeds: Sequence[int], ref_cfg: Mapping, precision: Optional[str],
                          rows: Optional[slice]) -> Dict:
    out = ref_step.train_steps(w0, batches, seeds, ref_cfg, precision=precision, rows=rows)
    return dict(losses=out["losses"], first_grad=out["first_grad"], params=out["params"],
                bn_vars={n: v.cpu() for n, v in out["bn_vars"].items()})


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
    """program / reference: {'losses', 'grad_norms', 'change_norms', 'bn_vars'}."""
    keep = compare.moved_leaves(reference["grad_norms"])
    every = list(reference["grad_norms"])
    convs = conv_leaves(every)
    return {
        "loss_gap": compare.loss_gap(program["losses"], reference["losses"]),
        "grad_gap": compare.norm_gap(program["grad_norms"], reference["grad_norms"], every),
        "change_gap": compare.norm_gap(program["change_norms"], reference["change_norms"], keep),
        "grad_gap_conv_median": compare.median_gap(program["grad_norms"],
                                                   reference["grad_norms"], convs),
        "change_gap_conv_median": compare.median_gap(program["change_norms"],
                                                     reference["change_norms"],
                                                     [k for k in convs if k in keep]),
        "var_gap": var_gap(program["bn_vars"], reference["bn_vars"]),
    }
