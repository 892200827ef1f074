"""Weights from the reference's files, read locally (the port of
``bdvcil_tpu/models/pretrained.py``).

The reference starts its TSM backbone from torchvision's ImageNet weights
(``model.backbone.pretrained``, e.g. resnet50-0676ba61.pth). The port's
modules use torchvision's names, so a torchvision ``state_dict`` maps onto
``backbone.*`` as it is: ``fc.*`` (the classifier is grown per task) and
``num_batches_tracked`` are dropped. Only local files are read; the trainer
trains from scratch when the configured file is not there, as the JAX
trainer does, and nothing is downloaded.

``load_reference_cil_checkpoint`` renames a reference CIL checkpoint
(``ckpt_task_{t}.pt``: the raw ``state_dict`` of ``CILRecognizer2D``, an
mmaction2 ResNetTSM backbone and the IncrementalTSMHead) into the port's
``state_dict``, which ``load_state_dict(strict=True)`` takes into the
recognizer ``build_model`` makes for the same config, under every
``shift_mode``:

  ``current_model.`` (optional prefix)     -> taken off
  ``backbone.layerL.B.conv1.net.weight``   -> ``backbone.layerL.B.conv1.weight``
  (TemporalShift wraps each block's conv1 as ``.net``; other backbone names
  are torchvision's, as the port's)
  ``cls_head.fc_cls.weights`` (LSC)        -> ``cls_head.fc_weights``
  ``cls_head.fc_cls.{weight,bias}``        -> ``cls_head.fc_weight`` / ``fc_bias``
  ``cls_head.loss_cls.eta``                -> ``cls_head.eta``, shape (1,)
  ``prev_model.*``, ``num_batches_tracked``, other buffers -> dropped

The eta is the current model's only. The JAX function matches any key that
ends in ``loss_cls.eta``, so in a checkpoint that holds both models it takes
``prev_model``'s, the later one in the reference's order; its docstring says
``prev_model.*`` is ignored, which is what this function does.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def load_checkpoint_file(path: str) -> Dict[str, torch.Tensor]:
    """A torch .pth/.pt (read with ``weights_only=True``) or an .npz of the
    same keys, as a flat name -> CPU tensor dict; a ``state_dict`` entry is
    unwrapped."""
    if str(path).endswith(".npz"):
        with np.load(path) as f:
            return {k: torch.from_numpy(np.array(f[k])) for k in f.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and isinstance(obj.get("state_dict"), Mapping):
        obj = obj["state_dict"]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def load_torch_resnet_backbone(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The backbone's weights and running statistics by their names under
    ``backbone.`` (a leading ``backbone.`` is taken off; ``fc.*`` and
    ``num_batches_tracked`` are dropped)."""
    if isinstance(state_dict.get("state_dict"), Mapping):
        state_dict = state_dict["state_dict"]
    out = {}
    for key, value in state_dict.items():
        key = key[len("backbone."):] if key.startswith("backbone.") else key
        if key.startswith("fc.") or "num_batches_tracked" in key:
            continue
        out[key] = torch.as_tensor(value)
    return out


_HEAD_NAMES = {"cls_head.fc_cls.weights": "cls_head.fc_weights",
               "cls_head.fc_cls.weight": "cls_head.fc_weight",
               "cls_head.fc_cls.bias": "cls_head.fc_bias"}


def load_reference_cil_checkpoint(
        state_dict: Mapping[str, torch.Tensor]) -> "OrderedDict[str, torch.Tensor]":
    """A reference CIL checkpoint's ``state_dict`` (tensors or arrays) -> the
    port's recognizer ``state_dict``, by the mapping in the module docstring."""
    if isinstance(state_dict.get("state_dict"), Mapping):
        state_dict = state_dict["state_dict"]
    backbone, head = {}, OrderedDict()
    for key, value in state_dict.items():
        if key.startswith("current_model."):
            key = key[len("current_model."):]
        if key.startswith("backbone."):
            backbone[key.replace(".net.", ".")] = value
        elif key in _HEAD_NAMES:
            head[_HEAD_NAMES[key]] = torch.as_tensor(value)
        elif key == "cls_head.loss_cls.eta":
            head["cls_head.eta"] = torch.as_tensor(value).reshape(1)
    out = OrderedDict(("backbone." + k, v) for k, v in load_torch_resnet_backbone(backbone).items())
    out.update(head)
    return out


@torch.no_grad()
def apply_backbone_weights(module: nn.Module, backbone: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy ``backbone`` (from :func:`load_torch_resnet_backbone`) into the
    recognizer's backbone in place; every name must exist there with the
    same shape. Returns ``module``."""
    target = module.backbone.state_dict()
    for key, value in backbone.items():
        if key not in target:
            raise KeyError(f"unhandled torch key {key!r}")
        if tuple(target[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(target[key].shape)} vs "
                             f"{tuple(value.shape)}")
        target[key].copy_(value)
    return module
