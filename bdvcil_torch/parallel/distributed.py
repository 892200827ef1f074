"""Multi-process support over ``torch.distributed`` (the port of
``bdvcil_tpu/parallel/distributed.py``).

The reference trains as NCCL data parallelism, one process per GPU
(Lightning ``ddp_spawn``). The port keeps that shape: one rank per card,
each holding its contiguous rows of the global batch (``parallel/mesh.py``).

  * ``initialize()``   the process group from torchrun's environment or the
                       JAX package's ``BDVC_*`` contract; a no-op without either
  * ``all_gather_host`` a host value from every rank, stacked in rank order
  * ``is_primary()``   the rank-0 guard of file writes
  * ``sync_processes`` a barrier after rank 0 has written a file
  * ``all_reduce_sum`` an all-reduce whose backward all-reduces the gradient,
                       for statistics and denominators taken over the global batch
  * ``all_reduce_gradients`` the gradient sum of a train step, one flat
                       all-reduce per dtype

Every function is the identity (or its one-process answer) when no process
group exists, so the one-process path runs no collective at all.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

# a lost rank fails its peers' collectives after this long instead of hanging them
DEFAULT_TIMEOUT_S = 600

_DEVICE: Optional[torch.device] = None


def _launch_env():
    """(init_method, world_size, rank, local_rank) from the environment, or None.

    torchrun sets RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR/MASTER_PORT; the
    JAX package's manual contract is BDVC_COORDINATOR_ADDRESS (host:port),
    BDVC_NUM_PROCESSES and BDVC_PROCESS_ID."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        rank = int(env["RANK"])
        return "env://", int(env["WORLD_SIZE"]), rank, int(env.get("LOCAL_RANK", rank))
    if "BDVC_COORDINATOR_ADDRESS" in env:
        rank = int(env["BDVC_PROCESS_ID"])
        return (f"tcp://{env['BDVC_COORDINATOR_ADDRESS']}", int(env["BDVC_NUM_PROCESSES"]),
                rank, int(env.get("LOCAL_RANK", rank)))
    return None


def launch_rank():
    """(rank, world size) of this process: the process group's, else the
    launcher's environment's, else (0, 1). Reads the environment only, so a
    process can split work by rank before it touches CUDA or a group."""
    if is_initialized():
        return dist.get_rank(), dist.get_world_size()
    launch = _launch_env()
    return (0, 1) if launch is None else (launch[2], launch[1])


def _rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: ``device`` if given, else ``cuda:local_rank``; a rank
    with no such card raises and never wraps around to another one."""
    if device is not None:
        device = torch.device(device)
    else:
        device = torch.device("cuda", local_rank)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank needs {device}, and no CUDA device is available; "
                               f"pass device='cpu' to run the rank on the CPU")
        index = device.index if device.index is not None else torch.cuda.current_device()
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"rank needs cuda:{index}, and this machine has "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        device = torch.device("cuda", index)
    return device


def initialize(
    backend: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Optional[torch.device]:
    """Join the process group; returns this rank's device, or None when there
    is no group to join (one process).

    Without ``init_method`` the launch comes from the environment (torchrun's
    or the ``BDVC_*`` contract); without either it is a no-op. The backend is
    NCCL for a card and gloo for the CPU unless ``backend`` names one (two
    ranks on one card need gloo: NCCL refuses them). The rank's device is
    ``cuda:LOCAL_RANK`` unless ``device`` is given. Called from every
    command-line entry point before it touches the card."""
    global _DEVICE
    if is_initialized():
        return _DEVICE
    if init_method is None:
        launch = _launch_env()
        if launch is None:
            return None
        init_method, env_world, env_rank, local_rank = launch
        world_size = env_world if world_size is None else world_size
        rank = env_rank if rank is None else rank
    else:
        if world_size is None or rank is None:
            raise ValueError("an explicit init_method needs world_size and rank")
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = _rank_device(device, local_rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                            rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev
    return dev


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _DEVICE
    if is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def device() -> Optional[torch.device]:
    """The device ``initialize`` gave this rank (None without a group)."""
    return _DEVICE if is_initialized() else None


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


def _barrier_kwargs():
    if backend() == "nccl" and _DEVICE is not None and _DEVICE.type == "cuda":
        return {"device_ids": [_DEVICE.index]}
    return {}


def all_gather_host(x: Any):
    """Every rank's host value ``x``, stacked on a new leading axis in rank
    order (JAX's ``process_allgather``); ``x`` itself in one process."""
    if process_count() == 1:
        return x
    parts: List[Any] = [None] * process_count()
    dist.all_gather_object(parts, np.asarray(x))
    return np.stack(parts)


def sync_processes(name: str = "barrier") -> None:
    """A barrier across ranks (``name`` documents the call site)."""
    del name
    if process_count() == 1:
        return
    dist.barrier(**_barrier_kwargs())


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the backward sums the ranks' gradients, because every
    rank's partial loss depends on the summed value."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable (the identity without a group)."""
    if not is_initialized():
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x)
    y = x.contiguous().clone()
    dist.all_reduce(y)
    return y


def global_sums(*parts: torch.Tensor) -> List[torch.Tensor]:
    """1-D f32 ``parts`` summed over the ranks in one all-reduce, split back;
    the parts themselves without a group. cat and split copy exactly, so a
    one-rank group and no group give the same bits."""
    if not is_initialized():
        return list(parts)
    sizes = [p.numel() for p in parts]
    flat = all_reduce_sum(torch.cat([p.reshape(-1) for p in parts]))
    return list(torch.split(flat, sizes))


def global_count(n: float, like: torch.Tensor) -> torch.Tensor:
    """The number ``n`` of this rank's rows, summed over the ranks, as a
    0-d f32 tensor on ``like``'s device."""
    return global_sums(like.new_full((1,), float(n), dtype=torch.float32))[0][0]


@torch.no_grad()
def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum ``p.grad`` over the ranks in place: one flat all-reduce per dtype
    and device (a no-op without a group). It runs after the whole backward,
    so splitting it into buckets would overlap nothing. Every rank must hold
    grads for the same parameters, in the same order."""
    if not is_initialized():
        return
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            groups.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in groups.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
