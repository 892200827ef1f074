"""Model building from reference-shaped config dicts
(port of ``bdvcil_tpu/models/builder.py``).

Accepts the mmaction2-style model config verbatim:

    model = dict(
        type='CILRecognizer2D',
        backbone=dict(type='ResNetTSM', depth=50, num_segments=8, shift_div=8, ...),
        # or mmaction2's TimeSformer keys: dict(type='TimeSformer', num_frames=8,
        #    img_size=224, patch_size=16, embed_dims=768, num_heads=12,
        #    num_transformer_layers=12, attention_type='divided_space_time',
        #    norm_cfg=dict(type='LN', eps=1e-6), drop_path_rate=0.1)
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
from ..parallel import distributed
from .heads import IncrementalTSMHead
from .norm import BatchNorm
from .recognizer import CILRecognizer2D
from .resnet_tsm import Conv2d, ResNetTSM
from .timesformer import ATTENTION_TYPES, TimeSformer

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
    backbone_type: str = "ResNetTSM"
    # a clip backbone's frames (it takes whole (N, T, C, H, W) clips); None
    # for a frame backbone, whose clip length is the head's segments
    frames_per_clip: Optional[int] = None

    @property
    def classifier_type(self) -> str:
        return self.head_kwargs["classifier_type"]

    @property
    def num_segments(self) -> int:
        """Frames a clip: a clip backbone's frames, or the TSM head's segments."""
        if self.frames_per_clip is not None:
            return self.frames_per_clip
        return self.head_kwargs["num_segments"]

    @property
    def average_clips(self) -> Optional[str]:
        return self.test_cfg.get("average_clips", "prob")

    def module(self, num_classes: Optional[int] = None) -> CILRecognizer2D:
        """The recognizer on ``self.device``; weights uninitialized (see
        ``init_model_params``)."""
        nc = self.num_classes if num_classes is None else num_classes
        backbone = BACKBONES[self.backbone_type](dtype=self.dtype, device=self.device,
                                                 **self.backbone_kwargs)
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
    backbone_type = b.pop("type")
    if backbone_type == "TimeSformer":
        backbone_kwargs = _timesformer_kwargs(b)
    elif backbone_type == "ResNetTSM":
        backbone_kwargs = _resnet_tsm_kwargs(b, dtype)
    else:
        raise ValueError(f"unknown backbone {backbone_type!r}: not one of {sorted(BACKBONES)}")

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
        backbone_type=backbone_type,
        frames_per_clip=backbone_kwargs.get("num_frames"),
    )


BACKBONES = {"ResNetTSM": ResNetTSM, "TimeSformer": TimeSformer}


def _resnet_tsm_kwargs(b: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
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
        # 'per_device' resolves to the ranks of the process group (one card a
        # rank): the reference's per-GPU statistics, DDP without SyncBN
        bn_groups=(distributed.process_count() if b.get("bn_groups") == "per_device"
                   else int(b.get("bn_groups", 1))),
        bn_stats_rows=int(b.get("bn_stats_rows", 0)),
    )
    if "norm_dtype" in b:
        nd = b["norm_dtype"]
        backbone_kwargs["norm_dtype"] = _DTYPES.get(nd, nd)
    else:
        # follow the compute dtype: statistics are f32 either way
        backbone_kwargs["norm_dtype"] = dtype
    return backbone_kwargs


def _timesformer_kwargs(b: Dict[str, Any]) -> Dict[str, Any]:
    """mmaction2's TimeSformer keys; ``drop_path_rate`` (mmaction2 fixes it
    at 0.1) and ``mlp_ratio`` (4) are the port's."""
    attention_type = b.get("attention_type", "divided_space_time")
    if attention_type not in ATTENTION_TYPES:
        raise NotImplementedError(f"TimeSformer attention_type {attention_type!r}: the port has "
                                  f"{ATTENTION_TYPES} (ROADMAP F)")
    norm = dict(b.get("norm_cfg") or {"type": "LN", "eps": 1e-6})
    if norm.get("type", "LN") != "LN":
        raise ValueError(f"TimeSformer takes LayerNorm, not {norm['type']!r}")
    return dict(
        num_frames=b.get("num_frames", 8),
        img_size=b.get("img_size", 224),
        patch_size=b.get("patch_size", 16),
        embed_dims=b.get("embed_dims", 768),
        num_heads=b.get("num_heads", 12),
        num_transformer_layers=b.get("num_transformer_layers", 12),
        mlp_ratio=b.get("mlp_ratio", 4),
        ln_eps=norm.get("eps", 1e-6),
        drop_path_rate=b.get("drop_path_rate", 0.1),
        pretrained=b.get("pretrained"),
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
    from ``generator`` (or a seed) and placed on ``spec.device``. A backbone
    with a ``reset_parameters`` of its own (``TimeSformer``: mmaction2's)
    draws with it first."""
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    module = spec.module(num_classes)
    reset_backbone = getattr(module.backbone, "reset_parameters", None)
    if reset_backbone is not None:
        reset_backbone(generator)
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
