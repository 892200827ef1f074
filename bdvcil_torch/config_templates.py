"""The main path's configuration: the parts of ``bdvcil_tpu/config_templates.py``
(the ``hmdb51`` preset) and ``bench.py`` that the port runs.

TSM-ResNet-50 with 8 segments and shift_div 8; the LSC head with
``nb_proxies=1``, LSCLoss and dropout 0.5; HMDB51's 26 base classes, then 5
per task; feature-KD on ``backbone.layer1..4`` and ``cls_head.avg_pool``
with weights [3, 3, 3, 3, 0.1] and the per-task scale sqrt(classes so far /
classes added); the labeled SGD at lr 0.01, momentum 0.9, weight decay 1e-4,
classifier lr x5, MultiStepLR; the global-norm clip at 1.0 from task 1 on.
"""

from __future__ import annotations

import math
from typing import Dict

from .models.recognizer import KD_TAPS

HMDB51_BASE_CLASSES = 26
HMDB51_CLASSES_PER_TASK = 5
KD_WEIGHTS = (3.0, 3.0, 3.0, 3.0, 0.1)
GRAD_CLIP = 1.0  # tasks > 0
OPTIMIZER = dict(type="SGD", constructor="CILTSMOptimizerConstructorImprovised",
                 paramwise_cfg=dict(fc_lr_scale_factor=5.0), lr=0.01, momentum=0.9,
                 weight_decay=1e-4)
LR_SCHEDULER = dict(type="MultiStepLR", params=dict(milestones=[20, 30], gamma=0.1))
# backbone switches: the JAX defaults, and the two configurations that reach
# the hand-written kernels (they exclude each other)
SWITCHES = {
    "default": dict(shift_mode="pad", conv1x1_mode="xla"),
    "A": dict(shift_mode="pad", conv1x1_mode="pallas_stats"),  # conv1x1_with_stats
    "B": dict(shift_mode="fused_block", conv1x1_mode="xla"),  # fused epilogue
}


def hmdb51_r50_cfg(num_classes: int = HMDB51_BASE_CLASSES, num_segments: int = 8,
                   dropout_ratio: float = 0.5, **backbone) -> Dict:
    """The TSM-R50 + LSC recognizer config; ``backbone`` adds switches such as
    ``shift_mode`` and ``conv1x1_mode``."""
    return dict(
        type="CILRecognizer2D",
        backbone=dict(type="ResNetTSM", depth=50, num_segments=num_segments, shift_div=8,
                      **backbone),
        cls_head=dict(
            type="IncrementalTSMHead", num_classes=num_classes, in_channels=2048,
            inc_head_config=dict(type="LocalSimilarityClassifier", out_features=num_classes,
                                 nb_proxies=1),
            num_segments=num_segments, loss_cls=dict(type="LSCLoss"),
            dropout_ratio=dropout_ratio,
        ),
        test_cfg=dict(average_clips="prob"),
    )


def kd_config(classes_so_far: int, classes_added: int) -> Dict:
    """The base method's KD settings for a task that adds ``classes_added``."""
    return dict(module_names=list(KD_TAPS), module_weights=list(KD_WEIGHTS),
                scale_factor=math.sqrt(classes_so_far / classes_added), exemplar_only=False)
