"""Data parallelism over ``torch.distributed``, one rank per card.

  distributed  the process group (``initialize`` from torchrun's environment
               or the ``BDVC_*`` contract), rank queries, the rank-0 guard,
               barriers, host gathers, the differentiable all-reduce of
               global-batch statistics and the flat gradient all-reduce
  mesh         the batch contract (each rank's contiguous rows of the global
               batch, in rank order), ``pad_to_multiple``, ``gather_to_host``
               and ``replicate``
"""

from .distributed import (
    all_gather_host,
    initialize,
    is_primary,
    process_count,
    process_index,
    sync_processes,
)
from .mesh import gather_to_host, pad_to_multiple, replicate

__all__ = [
    "all_gather_host",
    "gather_to_host",
    "initialize",
    "is_primary",
    "pad_to_multiple",
    "process_count",
    "process_index",
    "replicate",
    "sync_processes",
]
