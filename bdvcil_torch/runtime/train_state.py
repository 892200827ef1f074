"""Training state: the module (parameters + running statistics), the
optimizer state and the step count (port of ``bdvcil_tpu/runtime/train_state.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from torch import nn


@dataclasses.dataclass
class TrainState:
    module: nn.Module
    opt_state: Dict[str, Any]
    step: int = 0

    @staticmethod
    def create(module: nn.Module, tx) -> "TrainState":
        return TrainState(module=module, opt_state=tx.init(module), step=0)
