"""The batch contract of the ranks (what the port needs of
``bdvcil_tpu/parallel/mesh.py``).

Data parallelism over ``torch.distributed``: every rank holds the whole model
and its contiguous rows of the global batch, in rank order (rank r holds rows
``[r * B/W, (r + 1) * B/W)`` of a global batch of B rows over W ranks). The
loaders cut those rows (``data/loaders.py``, ``data/host_loader.py``);
``gather_to_host`` puts the ranks' outputs back together in the same order.

The JAX package's hierarchical ``('dcn', 'data')`` mesh is not carried: it is
a topology hint to XLA's partitioner, and NCCL picks its own rings and trees.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from . import distributed


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``axis`` up to a multiple by repeating the edge; returns
    (padded, valid_count)."""
    n = array.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return array, n
    pad_widths = [(0, 0)] * array.ndim
    pad_widths[axis] = (0, target - n)
    return np.pad(array, pad_widths, mode="edge"), n


def local_rows(global_rows: int) -> Tuple[int, int]:
    """This rank's (lo, hi) of a global batch of ``global_rows`` rows."""
    world = distributed.process_count()
    if global_rows % world:
        raise ValueError(f"a global batch of {global_rows} rows does not split over "
                         f"{world} ranks")
    per = global_rows // world
    lo = distributed.process_index() * per
    return lo, lo + per


def gather_to_host(x: Union[torch.Tensor, np.ndarray],
                   n_valid: Optional[int] = None) -> np.ndarray:
    """Every rank's rows of ``x`` (equal row counts) as one host array, in rank
    order, trimmed to ``n_valid`` rows (the pad rows of a global batch)."""
    t = torch.as_tensor(x)
    if distributed.process_count() > 1 and distributed.backend() != "gloo":
        t = t.to(distributed.device())  # NCCL gathers card tensors
    out = all_gather_rows(t).cpu().numpy()
    return out if n_valid is None else out[:n_valid]


@torch.no_grad()
def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-rank tensor (equal rows on every rank), in
    rank order, on ``x``'s device; ``x`` itself in one process."""
    if distributed.process_count() == 1:
        return x
    # gloo gathers host tensors only: stage a card tensor through the host
    t = x.detach().cpu() if distributed.backend() == "gloo" else x.detach()
    parts = [torch.empty_like(t) for _ in range(distributed.process_count())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts).to(x.device)


@torch.no_grad()
def replicate(module: nn.Module) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, so every rank
    starts from the same weights (a no-op in one process)."""
    if distributed.process_count() == 1:
        return module
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
    return module
