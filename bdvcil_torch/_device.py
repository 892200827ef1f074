"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names one.

    With no ``device`` and no CUDA device this raises rather than carrying on
    quietly on the CPU; pass ``device="cpu"`` to run there on purpose. Under a
    process group the default is the rank's device
    (``parallel.distributed.initialize``).
    """
    if device is None:
        from .parallel import distributed

        if distributed.device() is not None:
            return distributed.device()
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
