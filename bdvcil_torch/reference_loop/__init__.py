"""The reference's CIL loop in plain torch, the yardstick of the accuracy
study (the port's torch-only copy of ``tests/torch_oracle.py``,
``tests/torch_cil_reference.py`` and the study tree of
``tests/test_protocol_parity.py``).

  model     the independent R18-TSM (torchvision names) and the reference's
            LSC scores: plain torch, no hand-written kernel
  mini_cil  ``TorchMiniCIL``: the reference's task loop (KD, herding,
            replay, CBF, NME and CNN+NME testing) on the port's data module,
            herding, host loader and meters, with a world-size-8 batch
  tree      the study's synthetic rawframe tree and its configs
            (``TREE_PARAMS``, ``DEPTH_TREE_PARAMS``, ``make_parity_config``,
            ``method_overrides``, ``depth_overrides``)
  timesformer  TimeSformer (divided space-time attention) and the LSC
            head as plain float32 functions of a weight dict, the CPU tests'
            reference for ``models/timesformer.py``

``bdvcil_torch/parity_study.py`` runs ``TorchMiniCIL`` beside the port's
``CILTrainer`` on one tree, one init and one data order.
"""

from .mini_cil import TorchMiniCIL
from .model import TorchResNet18TSM

__all__ = ["TorchMiniCIL", "TorchResNet18TSM"]
