"""Sanity-check config (reference configs/cil/tsm/bgmix_debias_sanity_check.py):
one task containing all 101 UCF-101 classes — exercises the full CIL
machinery (herding, exemplars, NME, checkpoints) with no incremental step.
The port's counterpart of ``configs/cil/bgmix_debias_sanity_check.py``:

    python -m bdvcil_torch.cil_tools.train_cil bdvcil_torch/configs/bgmix_debias_sanity_check.py
"""

from bdvcil_torch.config_templates import make_cil_config
from bdvcil_torch.protocol import class_order

_cfg = make_cil_config(dataset="ucf101", seed=1000, num_stages=10, variant="bgmix_plus_randAug")
_cfg["task_splits"] = [class_order(1000, 101)]  # single task, all classes
_cfg["ending_task"] = 0
_cfg["adaptive_scale_factors"] = [1.0]
_cfg["model"]["cls_head"]["num_classes"] = 101
_cfg["model"]["cls_head"]["inc_head_config"]["out_features"] = 101
_cfg["work_dir"] = "work_dirs/bgmix_debias_sanity_check"

globals().update(_cfg)
del _cfg
