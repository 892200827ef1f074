"""Per-task checkpoints and mid-task train snapshots (the port of
``bdvcil_tpu/runtime/checkpoint.py:24-147``), in the port's own format:
``torch.save``, read back with ``weights_only=True``.

  * ``save_checkpoint`` / ``load_checkpoint``: a module's ``state_dict`` and
    a JSON sidecar (``.json``) with the meta the CIL resume needs, such as
    the classifier width ``update_fc`` had reached. A JAX checkpoint comes
    over through ``models/convert.from_jax_variables``.
  * ``save_train_snapshot`` and the rest: a rolling epoch-boundary snapshot
    of the whole train state (module, optimizer state, step, run seed), so an
    interrupted run resumes bit for bit (``runtime/loops.train_epochs``).
    The file is the ``BDVSNAP1`` magic, a u32le meta length and the meta
    JSON ({task, phase, epoch, num_classes, run_token}), then the payload;
    it is written to a temporary file and renamed, so the meta and the
    payload always belong together. ``peek_train_snapshot_meta`` reads only
    the header.

Under a process group every rank holds the same weights and optimizer state
(the gradients are all-reduced, ``runtime/steps.py``), so one file serves all:
the callers write on rank 0 and then meet at a barrier
(``parallel.distributed.is_primary`` / ``sync_processes``; ``cil/trainer.py``,
``tools/train.py``), and every rank reads it back. The module is never
wrapped, so its names carry no ``module.`` prefix. JAX's orbax backend, a
sharding-aware directory format, has no counterpart.
"""

from __future__ import annotations

import io
import json
import os
import pathlib
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from .train_state import TrainState

PathLike = Union[str, pathlib.Path]
_SNAP_MAGIC = b"BDVSNAP1"


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: PathLike, module: Union[nn.Module, Mapping[str, torch.Tensor]],
                    meta: Optional[Dict] = None) -> None:
    """The module's state_dict (parameters and running statistics) at
    ``path``, and ``meta`` in the JSON sidecar when given."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = module.state_dict() if isinstance(module, nn.Module) else module
    torch.save(_cpu(dict(state)), path)
    if meta is not None:
        path.with_suffix(".json").write_text(json.dumps(meta, default=float))


def load_checkpoint(path: PathLike) -> Tuple[Dict[str, torch.Tensor], Optional[Dict]]:
    """(state_dict on the CPU, sidecar meta or None)."""
    path = pathlib.Path(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    meta_path = path.with_suffix(".json")
    return state, json.loads(meta_path.read_text()) if meta_path.exists() else None


def save_train_snapshot(path: PathLike, state: TrainState, seed: int, meta: Dict) -> None:
    """Commit a snapshot of ``state`` and the run seed atomically (tmp file,
    then rename). ``meta`` identifies the phase ({'task', 'phase', 'epoch',
    'num_classes', 'run_token'}) so a stale snapshot is never restored
    (``snapshot_matches``); it rides in the header and in the payload. A
    JSON sidecar is written for people; it is never read back."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta_json = json.dumps(meta, default=float)
    # p.grad is set only inside a gradient accumulation window: its sum so far
    grads = {n: p.grad for n, p in state.module.named_parameters() if p.grad is not None}
    payload = {"meta": meta_json, "step": int(state.step), "seed": int(seed),
               "module": _cpu(state.module.state_dict()), "opt_state": _cpu(state.opt_state),
               "grads": _cpu(grads)}
    buf = io.BytesIO()
    torch.save(payload, buf)
    meta_bytes = meta_json.encode()
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_SNAP_MAGIC + len(meta_bytes).to_bytes(4, "little") + meta_bytes)
        f.write(buf.getbuffer())
    os.replace(tmp, path)
    try:  # for people only
        path.with_suffix(".json").write_text(meta_json)
    except OSError:
        pass


def _read_header(f) -> Tuple[Dict, int]:
    """(meta, payload offset) of an open snapshot file."""
    if f.read(len(_SNAP_MAGIC)) != _SNAP_MAGIC:
        raise ValueError("not a BDVSNAP1 train snapshot")
    n = int.from_bytes(f.read(4), "little")
    return json.loads(f.read(n)), len(_SNAP_MAGIC) + 4 + n


def peek_train_snapshot_meta(path: PathLike) -> Optional[Dict]:
    """The snapshot's meta from its header alone; None when the file is
    missing, truncated or not a snapshot."""
    try:
        with open(path, "rb") as f:
            return _read_header(f)[0]
    except (OSError, ValueError):  # json.JSONDecodeError is a ValueError
        return None


def snapshot_matches(meta: Optional[Mapping], task: int, phase: str, num_classes: int,
                     run_token: Optional[str]) -> bool:
    """Whether a snapshot's meta belongs to this run's task and phase: the
    same task, phase and classifier width, and the same run token (a meta
    without one is accepted, as the JAX trainer does)."""
    if meta is None:
        return False
    token = meta.get("run_token")
    return (int(meta.get("task", -1)) == task and meta.get("phase") == phase
            and int(meta.get("num_classes", -1)) == num_classes
            and (token is None or token == run_token))


def load_train_snapshot(path: PathLike, state_target: TrainState) -> Tuple[TrainState, int, Dict]:
    """Restore a snapshot into a freshly built ``TrainState`` of the same
    shapes (its module takes the weights and an open accumulation window's
    gradients in place; the optimizer state moves to the module's device).
    Returns (state, seed, meta), the meta read from the same payload as the
    state."""
    with open(path, "rb") as f:
        _, offset = _read_header(f)
        f.seek(offset)
        raw = f.read()
    payload = torch.load(io.BytesIO(raw), map_location="cpu", weights_only=True)
    module = state_target.module
    module.load_state_dict(payload["module"], strict=True)
    device = next(module.parameters()).device

    def to_device(tree):
        if isinstance(tree, torch.Tensor):
            return tree.to(device)
        if isinstance(tree, Mapping):
            return {k: to_device(v) for k, v in tree.items()}
        return tree

    for n, p in module.named_parameters():
        p.grad = payload["grads"][n].to(device) if n in payload["grads"] else None
    state = TrainState(module=module, opt_state=to_device(payload["opt_state"]),
                       step=int(payload["step"]))
    return state, int(payload["seed"]), json.loads(payload["meta"])


def clear_train_snapshot(path: PathLike) -> None:
    path = pathlib.Path(path)
    path.unlink(missing_ok=True)
    path.with_suffix(".json").unlink(missing_ok=True)
