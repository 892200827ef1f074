"""Class-incremental orchestration of the port: herding, the per-task data
module and the trainer (the port of ``bdvcil_tpu/cil``)."""

from .data_module import CILDataModule
from .herding import Herding
from .trainer import CILTrainer

__all__ = ["CILDataModule", "CILTrainer", "Herding"]
