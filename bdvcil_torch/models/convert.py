"""Carry weights and running statistics between the JAX package and the port.

``from_jax_variables`` takes the JAX recognizer's ``{'params',
'batch_stats'}`` tree, as nested dicts of numpy arrays, and returns the
port's ``state_dict``; ``to_jax_variables`` is its inverse. Every leaf maps
in both directions:

  conv ``kernel`` (HWIO)        <-> ``weight`` (OIHW)
  BN ``scale`` / ``bias``       <-> ``weight`` / ``bias``
  BN ``mean`` / ``var``         <-> ``running_mean`` / ``running_var``
  ``layer{s}_{b}``              <-> ``layer{s}.{b}``
  ``downsample_conv`` / ``_bn`` <-> ``downsample.0`` / ``downsample.1``
  head ``fc_weights``, ``fc_weight``, ``fc_bias``, ``eta`` (same names;
  the head is ``head`` in JAX and ``cls_head`` in the port)

``block_params_from_jax`` carries the whole-block fused bottleneck's
``BlockParams`` (``ops/block_fused.py``) across. ``linear_from_jax`` /
``linear_to_jax`` carry the PyCIL heads of ``models/linears.py``: ``weight``
(already (out, in) in both), ``bias``, ``sigma``, and ``fc1`` / ``fc2`` of
the split classifier as ``fc1.weight`` / ``fc2.weight``.

The converter works on arrays, so it imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..ops.block_fused import BlockParams

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
_HEAD_LEAVES = ("fc_weights", "fc_weight", "fc_bias", "eta")


def _module_path(parts: Tuple[str, ...]) -> str:
    out = []
    for p in parts:
        m = re.fullmatch(r"layer(\d+)_(\d+)", p)
        if m:
            out += [f"layer{m[1]}", m[2]]
        elif p == "downsample_conv":
            out += ["downsample", "0"]
        elif p == "downsample_bn":
            out += ["downsample", "1"]
        else:
            out.append(p)
    return ".".join(out)


def torch_name(collection: str, path: Tuple[str, ...]) -> str:
    """The port's state_dict name of a JAX leaf ``variables[collection][path]``."""
    top, rest = path[0], path[1:]
    if top in ("head", "cls_head"):
        if collection != "params" or len(rest) != 1 or rest[0] not in _HEAD_LEAVES:
            raise KeyError(f"unknown head leaf {collection}/{'/'.join(path)}")
        return f"cls_head.{rest[0]}"
    if top != "backbone":
        raise KeyError(f"unknown top-level module {top!r}")
    leaf_map = _PARAM_LEAF if collection == "params" else _STAT_LEAF
    if rest[-1] not in leaf_map:
        raise KeyError(f"unknown leaf {collection}/{'/'.join(path)}")
    return "backbone." + _module_path(rest[:-1]) + "." + leaf_map[rest[-1]]


def jax_path(name: str) -> Tuple[str, Tuple[str, ...]]:
    """The JAX ``(collection, path)`` of a port state_dict name."""
    parts = name.split(".")
    if parts[0] == "cls_head":
        if len(parts) != 2 or parts[1] not in _HEAD_LEAVES:
            raise KeyError(f"unknown head entry {name!r}")
        return "params", ("head", parts[1])
    if parts[0] != "backbone":
        raise KeyError(f"unknown entry {name!r}")
    mods, leaf = parts[1:-1], parts[-1]
    out = []
    i = 0
    while i < len(mods):
        p = mods[i]
        if re.fullmatch(r"layer\d+", p) and i + 1 < len(mods) and mods[i + 1].isdigit():
            out.append(f"{p}_{mods[i + 1]}")
            i += 2
        elif p == "downsample" and i + 1 < len(mods):
            out.append("downsample_conv" if mods[i + 1] == "0" else "downsample_bn")
            i += 2
        else:
            out.append(p)
            i += 1
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", ("backbone", *out, leaf[len("running_"):])
    if leaf == "weight":
        is_bn = out[-1].startswith("bn") or out[-1] == "downsample_bn"
        return "params", ("backbone", *out, "scale" if is_bn else "kernel")
    if leaf == "bias":
        return "params", ("backbone", *out, "bias")
    raise KeyError(f"unknown entry {name!r}")


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``{'params', 'batch_stats'}`` (numpy leaves) -> the port's state_dict."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            arr = np.asarray(value, dtype=np.float32)
            if arr.ndim == 4:  # HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            out[torch_name(collection, path)] = torch.from_numpy(np.array(arr, order="C"))
    return out


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The port's state_dict -> JAX ``{'params', 'batch_stats'}`` of numpy arrays."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for name, tensor in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        collection, path = jax_path(name)
        arr = tensor.detach().float().cpu().numpy()
        if arr.ndim == 4:  # OIHW -> HWIO
            arr = arr.transpose(2, 3, 1, 0)
        node = out[collection]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return out


def block_params_from_jax(params, dtype: torch.dtype = torch.bfloat16) -> BlockParams:
    """The JAX ``block_fused.BlockParams`` (a NamedTuple or a mapping of its
    field names to numpy arrays) -> the port's, on the CPU: conv weights in
    ``dtype`` with w1 as (C, Cm) and w3 as (Cm, C), BN scale and bias in f32."""
    fields = params._asdict() if hasattr(params, "_asdict") else dict(params)

    def tensor(name):
        return torch.from_numpy(np.array(np.asarray(fields[name], dtype=np.float32), order="C"))

    w1, w2, w3 = tensor("w1"), tensor("w2"), tensor("w3")
    return BlockParams(
        w1=w1.reshape(-1, w1.shape[-1]).to(dtype),
        g1=tensor("g1"), b1=tensor("b1"),
        w2=w2.to(dtype),
        g2=tensor("g2"), b2=tensor("b2"),
        w3=w3.reshape(-1, w3.shape[-1]).to(dtype),
        g3=tensor("g3"), b3=tensor("b3"),
    )


_LINEAR_LEAVES = ("weight", "bias", "sigma")


def linear_from_jax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """A ``linears.py`` module's flax params (numpy leaves) -> its state_dict."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, value in _leaves(params):
        if path[-1] not in _LINEAR_LEAVES or any(p not in ("fc1", "fc2") for p in path[:-1]):
            raise KeyError(f"unknown linear-head leaf {'/'.join(path)}")
        out[".".join(path)] = torch.from_numpy(np.array(np.asarray(value, np.float32), order="C"))
    return out


def linear_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of ``linear_from_jax``."""
    out: Dict = {}
    for name, tensor in state_dict.items():
        *mods, leaf = name.split(".")
        if leaf not in _LINEAR_LEAVES or any(m not in ("fc1", "fc2") for m in mods):
            raise KeyError(f"unknown linear-head entry {name!r}")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = tensor.detach().float().cpu().numpy()
    return out
