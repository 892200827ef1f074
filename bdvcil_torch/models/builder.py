"""Model building from reference-shaped config dicts
(port of ``bdvcil_tpu/models/builder.py``).

Accepts the mmaction2-style model config verbatim:

    model = dict(
        type='CILRecognizer2D',
        backbone=dict(type='ResNetTSM', depth=50, num_segments=8, shift_div=8, ...),
        cls_head=dict(type='IncrementalTSMHead', num_classes=N, in_channels=2048,
                      inc_head_config=dict(type='LocalSimilarityClassifier',
                                           out_features=N, nb_proxies=1),
                      loss_cls=dict(type='LSCLoss'), dropout_ratio=0.5, ...),
        test_cfg=dict(average_clips='prob'))
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import torch

from .._device import resolve_device
from .heads import IncrementalTSMHead
from .norm import BatchNorm
from .recognizer import CILRecognizer2D
from .resnet_tsm import Conv2d, ResNetTSM

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class ModelSpec:
    """A recognizer config resolved into constructor kwargs; ``module(nc)``
    builds the recognizer for any classifier width (one per task)."""

    backbone_kwargs: Dict[str, Any]
    head_kwargs: Dict[str, Any]
    loss_cls: Dict[str, Any]
    test_cfg: Dict[str, Any]
    num_classes: int
    dtype: torch.dtype = torch.float32
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cuda"))

    @property
    def classifier_type(self) -> str:
        return self.head_kwargs["classifier_type"]

    @property
    def num_segments(self) -> int:
        return self.head_kwargs["num_segments"]

    @property
    def average_clips(self) -> Optional[str]:
        return self.test_cfg.get("average_clips", "prob")

    def module(self, num_classes: Optional[int] = None) -> CILRecognizer2D:
        """The recognizer on ``self.device``; weights uninitialized (see
        ``init_model_params``)."""
        nc = self.num_classes if num_classes is None else num_classes
        backbone = ResNetTSM(dtype=self.dtype, device=self.device, **self.backbone_kwargs)
        head = IncrementalTSMHead(num_classes=nc, dtype=self.dtype, device=self.device,
                                  **self.head_kwargs)
        return CILRecognizer2D(backbone, head)


def build_model(
    cfg: Dict[str, Any],
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
) -> ModelSpec:
    """Resolve a model config. Runs on the card unless ``device`` says otherwise;
    with no CUDA device and no ``device`` this raises."""
    device = resolve_device(device)
    cfg = dict(cfg)
    if cfg.get("type", "CILRecognizer2D") not in ("CILRecognizer2D", "Recognizer2D"):
        raise ValueError(f"unknown recognizer type {cfg.get('type')!r}")
    b = dict(cfg["backbone"])
    if b.pop("type") != "ResNetTSM":
        raise ValueError("only the ResNetTSM backbone exists")
    if b.get("bn_groups") == "per_device":
        raise NotImplementedError(
            "bn_groups='per_device' is not ported yet (ROADMAP A.1 (norm), A.7 multi-GPU)")
    backbone_kwargs = dict(
        depth=b.get("depth", 50),
        num_segments=b.get("num_segments", 8),
        shift_div=b.get("shift_div", 8),
        is_shift=b.get("is_shift", True),
        norm_eval=b.get("norm_eval", False),
        shift_mode=b.get("shift_mode", "pad"),
        stem_mode=b.get("stem_mode", "conv"),
        conv1x1_mode=b.get("conv1x1_mode", "xla"),
        pretrained=b.get("pretrained"),
        bn_groups=int(b.get("bn_groups", 1)),
        bn_stats_rows=int(b.get("bn_stats_rows", 0)),
    )
    if "norm_dtype" in b:
        nd = b["norm_dtype"]
        backbone_kwargs["norm_dtype"] = _DTYPES.get(nd, nd)
    else:
        # follow the compute dtype: statistics are f32 either way
        backbone_kwargs["norm_dtype"] = dtype

    h = dict(cfg["cls_head"])
    if h.pop("type") != "IncrementalTSMHead":
        raise ValueError("only the IncrementalTSMHead head exists")
    inc = dict(h.get("inc_head_config", {"type": "LocalSimilarityClassifier"}))
    loss_cls = dict(h.get("loss_cls", {"type": "CrossEntropyLoss"}))
    head_kwargs = dict(
        in_channels=h["in_channels"],
        num_segments=h.get("num_segments", 8),
        classifier_type=inc.get("type", "LocalSimilarityClassifier"),
        nb_proxies=inc.get("nb_proxies", 3),
        dropout_ratio=h.get("dropout_ratio", 0.8),
        with_eta=loss_cls.get("type") == "LSCLoss",
        eta_init=loss_cls.get("eta", 1.0),
        init_std=h.get("init_std", 0.001),
    )
    return ModelSpec(
        backbone_kwargs=backbone_kwargs,
        head_kwargs=head_kwargs,
        loss_cls=loss_cls,
        test_cfg=dict(cfg.get("test_cfg") or {"average_clips": "prob"}),
        num_classes=h["num_classes"],
        dtype=dtype,
        device=device,
    )


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal (+-2 std) with variance 1/fan_in."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    # std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(weight.shape)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    weight.copy_(w)


@torch.no_grad()
def init_model_params(
    spec: ModelSpec,
    generator: Union[int, torch.Generator] = 0,
    num_classes: Optional[int] = None,
) -> CILRecognizer2D:
    """The recognizer with the JAX package's initializers, drawn on the CPU
    from ``generator`` (or a seed) and placed on ``spec.device``."""
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    module = spec.module(num_classes)
    for m in module.modules():
        if isinstance(m, Conv2d):
            _lecun_normal_(m.weight, generator)
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, IncrementalTSMHead):
            m.reset_parameters(generator)
    return module
