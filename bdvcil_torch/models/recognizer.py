"""2D recognizer: backbone + head with clip/crop handling
(port of ``bdvcil_tpu/models/recognizer.py``).

The (B, M, H, W, C) batch is flattened to (B*M, H, W, C) for the backbone,
the head folds segments via AvgConsensus, and test-time crop/clip scores are
averaged by ``average_clips``. The output dict carries 'cls_score', 'repr'
and 'feats' keyed with the reference's kd_modules_names.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .heads import IncrementalTSMHead
from .resnet_tsm import ResNetTSM

KD_TAPS = (
    "backbone.layer1",
    "backbone.layer2",
    "backbone.layer3",
    "backbone.layer4",
    "cls_head.avg_pool",
)


def average_clips(cls_score: torch.Tensor, mode: Optional[str] = "prob") -> torch.Tensor:
    """(B, G, num_classes) -> (B, num_classes); G = crops*clips per video."""
    if mode is None:
        return cls_score
    if mode == "prob":
        return torch.softmax(cls_score, dim=-1).mean(dim=1)
    if mode == "score":
        return cls_score.mean(dim=1)
    raise ValueError(f"average_clips mode must be 'prob'|'score'|None, got {mode!r}")


class CILRecognizer2D(nn.Module):
    def __init__(self, backbone: ResNetTSM, cls_head: IncrementalTSMHead):
        super().__init__()
        self.backbone = backbone
        self.cls_head = cls_head

    def forward(
        self,
        imgs: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """imgs: (B, M, H, W, C) normalized frames, M = crops * num_segments
        (NCHW frames (B, M, C, H, W) are accepted too).

        Returns cls_score (B, G, num_classes), repr (B, G, C) and the KD taps.
        ``generator`` (on the input's device) drives dropout in train mode.
        """
        b, m = imgs.shape[0], imgs.shape[1]
        if imgs.shape[-1] not in (1, 3) and imgs.shape[2] in (1, 3):
            imgs = imgs.permute(0, 1, 3, 4, 2)
        x = imgs.reshape((b * m,) + tuple(imgs.shape[2:]))
        feats = self.backbone(x, train=train)
        head_out = self.cls_head(feats["out"], train=train, generator=generator)

        num_groups = m // self.cls_head.num_segments
        kd_feats = {f"backbone.layer{i}": feats[f"layer{i}"] for i in range(1, 5)}
        kd_feats["cls_head.avg_pool"] = head_out["avg_pool"]
        return {
            "cls_score": head_out["cls_score"].reshape(b, num_groups, -1),
            "repr": head_out["repr"].reshape(b, num_groups, -1),
            "feats": kd_feats,
        }
