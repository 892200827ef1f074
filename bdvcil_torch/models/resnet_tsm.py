"""ResNet-TSM backbone (port of ``bdvcil_tpu/models/resnet_tsm.py``).

A torchvision-style ResNet-18/34/50/101 where every residual block applies
the temporal channel shift to its input before conv1 (mmaction2
``shift_place='blockres'``). ``forward`` returns a dict of tagged stage
outputs (``layer1``..``layer4``, ``out``) for the feature-distillation taps.

Layout: the public input and outputs are ``(N*T, H, W, C)``, the JAX layout.
Inside, activations are NCHW tensors in ``torch.channels_last`` memory, the
same bytes, so a 1x1 conv is a GEMM on a contiguous ``(M, K)`` view and the
NHWC kernels take the tensors as they are.

In train mode each stage of blocks is the span ``model.stage`` and each
residual block ``model.block`` (``utils/profiling.py``).

Mixed precision: ``dtype`` is the compute/activation dtype (convs cast their
input and weight to it), ``norm_dtype`` the BatchNorm output dtype;
parameters and BatchNorm statistics stay float32.

Switches, as in the JAX package:
  * ``shift_mode``: ``'pad'`` (materialised shift, the default), ``'fused'``
    (conv1 takes the shift through the conv's linearity,
    ``ops/tsm_shift.shifted_conv``: three convolutions, no shifted copy) or
    ``'fused_block'`` (each block's epilogue kernel emits its successor's
    shifted input, ``ops/tsm_shift.fused_residual_relu_shift``);
  * ``conv1x1_mode``: ``'xla'`` (plain conv, the default),
    ``'pallas_stats'`` (bottleneck conv1/conv3 as the GEMM kernel with a
    BatchNorm-statistics epilogue, ``ops/conv1x1_bn``; needs ``shift_mode ==
    'pad'``, ``bn_groups == 1`` and ``bn_stats_rows == 0``) or
    ``'pallas_stats_interpret'`` (the same path with the GEMM's plain
    version on every device, as JAX runs the Pallas kernel in its
    interpreter). The names follow the JAX package's configs;
  * ``stem_mode``: ``'conv'`` (the 7x7/s2 stem) or ``'s2d'`` (a 2x2
    space-to-depth and the equivalent 4x4/s1 conv, ``S2DStem``; the same
    parameter);
  * ``bn_groups`` / ``bn_stats_rows``: ``GroupedBatchNorm`` (``models/norm.py``)
    in place of every BatchNorm when ``bn_groups > 1`` or ``bn_stats_rows > 0``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv1x1_bn import conv1x1_bn
from ..ops.tsm_shift import fused_residual_relu_shift, shifted_conv, temporal_shift
from ..utils.profiling import annotate
from .norm import BatchNorm, GroupedBatchNorm

# depth -> (block type, stage sizes, expansion)
ARCH = {
    18: ("basic", (2, 2, 2, 2), 1),
    34: ("basic", (3, 4, 6, 3), 1),
    50: ("bottleneck", (3, 4, 6, 3), 4),
    101: ("bottleneck", (3, 4, 23, 3), 4),
}

SHIFT_MODES = ("pad", "fused", "fused_block")
CONV1X1_MODES = ("xla", "pallas_stats", "pallas_stats_interpret")
STEM_MODES = ("conv", "s2d")


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last memory) -> the (N, H, W, C) view of the same bytes."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> the NCHW view, channels_last when x is contiguous."""
    return x.permute(0, 3, 1, 2)


def _shift(x: torch.Tensor, num_segments: int, shift_div: int) -> torch.Tensor:
    return nchw(temporal_shift(nhwc(x), num_segments, shift_div))


def _fused_epilogue(h, identity, num_segments, shift_div):
    out, shifted = fused_residual_relu_shift(
        nhwc(h).contiguous(), nhwc(identity).contiguous(), num_segments, shift_div
    )
    return nchw(out), nchw(shifted)


class Conv2d(nn.Module):
    """Bias-free conv with flax ``nn.Conv(dtype=...)`` semantics: input and
    weight are cast to the compute dtype. Weight layout OIHW (torchvision)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size, device=device)
        )
        self.stride = stride
        self.padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None, self.stride,
                        self.padding)


class ShiftedConv2d(Conv2d):
    """conv1 of ``shift_mode='fused'``: ``conv(temporal_shift(x))`` through the
    conv's linearity (``ops/tsm_shift.shifted_conv``). The parameter is
    ``Conv2d``'s, so checkpoints and optimizer labels do not change."""

    def __init__(self, in_ch, out_ch, kernel_size, stride, padding, num_segments, shift_div,
                 dtype=torch.float32, device=None):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding, dtype, device)
        self.num_segments, self.shift_div = num_segments, shift_div

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nchw(shifted_conv(nhwc(x.to(self.dtype)), self.weight.to(self.dtype),
                                 self.num_segments, self.shift_div, self.stride, self.padding))


class S2DStem(Conv2d):
    """The space-to-depth stem (``_S2DStem``): a 2x2 space-to-depth of the
    input (224² x 3 -> 112² x 12) and the exactly equivalent 4x4/s1 conv with
    rearranged weights and padding (2, 1). The parameter keeps the plain
    stem's (64, 3, 7, 7) layout. Its output is channels_last, as every
    activation of the backbone."""

    def __init__(self, out_ch, dtype=torch.float32, device=None):
        super().__init__(3, out_ch, 7, 2, 3, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        # space-to-depth, channel order (p, q, c)
        xt = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
        xt = xt.reshape(n, 4 * c, h // 2, w // 2)
        # w_pad[t + 1] = w[t]; wt[(p, q, c), a, b] = w[2a + p - 1, 2b + q - 1, c]
        w_pad = F.pad(self.weight, (1, 0, 1, 0))
        o = w_pad.shape[0]
        wt = w_pad.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 4, 4)
        xt = F.pad(xt.to(self.dtype), (2, 1, 2, 1))
        return F.conv2d(xt, wt.to(self.dtype)).contiguous(memory_format=torch.channels_last)


def _make_bn(planes, norm_dtype, bn_groups, bn_stats_rows, device):
    """``BatchNorm`` (global-batch statistics), or ``GroupedBatchNorm`` when
    ``bn_groups > 1`` or ``bn_stats_rows > 0`` (the JAX ``_make_bn``)."""
    if bn_groups > 1 or bn_stats_rows > 0:
        return GroupedBatchNorm(planes, groups=bn_groups, stats_rows=bn_stats_rows,
                                dtype=norm_dtype, device=device)
    return BatchNorm(planes, dtype=norm_dtype, device=device)


def _conv1(inplanes, planes, kernel_size, stride, padding, num_segments, shift_div, is_shift,
           shift_mode, dtype, device):
    if is_shift and shift_mode == "fused":
        return ShiftedConv2d(inplanes, planes, kernel_size, stride, padding, num_segments,
                             shift_div, dtype, device)
    return Conv2d(inplanes, planes, kernel_size, stride, padding, dtype, device)


def _downsample(inplanes, planes, stride, dtype, bn, device):
    return nn.Sequential(Conv2d(inplanes, planes, 1, stride, 0, dtype, device), bn)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride, num_segments, shift_div, is_shift, dtype,
                 norm_dtype, shift_mode="pad", bn_groups=1, bn_stats_rows=0, device=None):
        super().__init__()
        self.num_segments, self.shift_div = num_segments, shift_div
        self.fused_block = is_shift and shift_mode == "fused_block"
        # 'fused' takes the shift inside conv1
        self.is_shift = is_shift and shift_mode != "fused"
        bn = lambda c: _make_bn(c, norm_dtype, bn_groups, bn_stats_rows, device)  # noqa: E731
        self.conv1 = _conv1(inplanes, planes, 3, stride, 1, num_segments, shift_div, is_shift,
                            shift_mode, dtype, device)
        self.bn1 = bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, dtype, device)
        self.bn2 = bn(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = _downsample(inplanes, planes, stride, dtype, bn(planes), device)

    def forward(self, x, train: bool, x_shifted=None):
        with annotate("model.block", train):
            identity = x
            if self.fused_block:
                h = x_shifted  # the producer block emitted shift(x) already
            else:
                h = _shift(x, self.num_segments, self.shift_div) if self.is_shift else x
            h = self.bn1(self.conv1(h), train, relu=True)
            h = self.bn2(self.conv2(h), train)
            if self.downsample is not None:
                identity = self.downsample[1](self.downsample[0](identity), train)
            if self.fused_block:
                return _fused_epilogue(h, identity.to(h.dtype), self.num_segments, self.shift_div)
            return F.relu(h + identity.to(h.dtype))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride, num_segments, shift_div, is_shift, dtype,
                 norm_dtype, shift_mode="pad", conv1x1_mode="xla", bn_groups=1, bn_stats_rows=0,
                 device=None):
        super().__init__()
        self.num_segments, self.shift_div = num_segments, shift_div
        self.fused_block = is_shift and shift_mode == "fused_block"
        self.is_shift = is_shift and shift_mode != "fused"
        # the GEMM-with-stats path replaces conv1/bn1 and conv3/bn3 when the
        # shift is materialised and BatchNorm is the global one (the JAX
        # package's condition)
        self.use_stats_gemm = (conv1x1_mode in ("pallas_stats", "pallas_stats_interpret")
                               and shift_mode == "pad" and bn_groups == 1
                               and bn_stats_rows == 0)
        self.interpret_stats_gemm = conv1x1_mode == "pallas_stats_interpret"
        self.dtype, self.norm_dtype = dtype, norm_dtype
        out_planes = planes * self.expansion
        bn = lambda c: _make_bn(c, norm_dtype, bn_groups, bn_stats_rows, device)  # noqa: E731
        self.conv1 = _conv1(inplanes, planes, 1, 1, 0, num_segments, shift_div, is_shift,
                            shift_mode, dtype, device)
        self.bn1 = bn(planes)
        # stride on the 3x3 (torch / mmaction2 'pytorch' style)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, dtype, device)
        self.bn2 = bn(planes)
        self.conv3 = Conv2d(planes, out_planes, 1, 1, 0, dtype, device)
        self.bn3 = bn(out_planes)
        self.downsample = None
        if stride != 1 or inplanes != out_planes:
            self.downsample = _downsample(inplanes, out_planes, stride, dtype, bn(out_planes),
                                          device)

    def _conv_bn(self, h, conv, bn, train, relu=False):
        if self.use_stats_gemm:
            out = conv1x1_bn(nhwc(h), conv.weight, bn, train, self.dtype, self.norm_dtype,
                             self.interpret_stats_gemm, relu)
            return nchw(out)
        return bn(conv(h), train, relu)

    def forward(self, x, train: bool, x_shifted=None):
        with annotate("model.block", train):
            identity = x
            if self.fused_block:
                h = x_shifted
            else:
                h = _shift(x, self.num_segments, self.shift_div) if self.is_shift else x
            h = self._conv_bn(h, self.conv1, self.bn1, train, relu=True)
            h = self.bn2(self.conv2(h), train, relu=True)
            h = self._conv_bn(h, self.conv3, self.bn3, train)
            if self.downsample is not None:
                identity = self.downsample[1](self.downsample[0](identity), train)
            if self.fused_block:
                return _fused_epilogue(h, identity.to(h.dtype), self.num_segments, self.shift_div)
            return F.relu(h + identity.to(h.dtype))


class ResNetTSM(nn.Module):
    # a frame backbone: the recognizer hands it (B*M, H, W, C) frames
    frames_per_clip: Optional[int] = None

    def __init__(
        self,
        depth: int = 50,
        num_segments: int = 8,
        shift_div: int = 8,
        is_shift: bool = True,
        norm_eval: bool = False,
        dtype: torch.dtype = torch.float32,
        norm_dtype: torch.dtype = torch.float32,
        shift_mode: str = "pad",
        stem_mode: str = "conv",
        bn_groups: int = 1,
        bn_stats_rows: int = 0,
        conv1x1_mode: str = "xla",
        pretrained: Optional[str] = None,  # recorded for config parity
        device=None,
    ):
        super().__init__()
        if shift_mode not in SHIFT_MODES:
            raise ValueError(f"unknown shift_mode {shift_mode!r}, not one of {SHIFT_MODES}")
        if conv1x1_mode not in CONV1X1_MODES:
            raise NotImplementedError(
                f"unknown conv1x1_mode {conv1x1_mode!r}: the port has the JAX package's "
                f"{CONV1X1_MODES} (ROADMAP, 'Deliberately not carried', lists what it leaves "
                f"out)")
        if stem_mode not in STEM_MODES:
            raise ValueError(f"unknown stem_mode {stem_mode!r}, not one of {STEM_MODES}")
        block_kind, stage_sizes, expansion = ARCH[depth]
        self.depth = depth
        self.num_segments, self.shift_div, self.is_shift = num_segments, shift_div, is_shift
        self.norm_eval = norm_eval
        self.dtype, self.norm_dtype = dtype, norm_dtype
        self.fused_block = is_shift and shift_mode == "fused_block"

        self.conv1 = (S2DStem(64, dtype, device) if stem_mode == "s2d"
                      else Conv2d(3, 64, 7, 2, 3, dtype, device))
        self.bn1 = _make_bn(64, norm_dtype, bn_groups, bn_stats_rows, device)
        inplanes, planes = 64, 64
        for stage_idx, num_blocks in enumerate(stage_sizes):
            blocks = []
            for block_idx in range(num_blocks):
                stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
                kw = dict(shift_mode=shift_mode, bn_groups=bn_groups,
                          bn_stats_rows=bn_stats_rows, device=device)
                if block_kind == "bottleneck":
                    block = Bottleneck(inplanes, planes, stride, num_segments, shift_div,
                                       is_shift, dtype, norm_dtype, conv1x1_mode=conv1x1_mode,
                                       **kw)
                else:
                    block = BasicBlock(inplanes, planes, stride, num_segments, shift_div,
                                       is_shift, dtype, norm_dtype, **kw)
                blocks.append(block)
                inplanes = planes * expansion
            setattr(self, f"layer{stage_idx + 1}", nn.ModuleList(blocks))
            planes *= 2
        self.out_channels = 512 * expansion

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        """x: (N*T, H, W, C) normalized frames; returns tagged (N*T, H, W, C) stage outputs."""
        bn_train = train and not self.norm_eval
        h = nchw(x.to(self.dtype).contiguous())
        h = self.bn1(self.conv1(h), bn_train, relu=True)
        h = F.max_pool2d(h, 3, 2, 1)

        feats: Dict[str, torch.Tensor] = {}
        # fused_block threads shift(block output) alongside the output: each
        # block's epilogue kernel emits its successor's shifted input
        h_shifted = _shift(h, self.num_segments, self.shift_div) if self.fused_block else None
        for stage in range(1, 5):
            with annotate("model.stage", train):
                for block in getattr(self, f"layer{stage}"):
                    if self.fused_block:
                        h, h_shifted = block(h, bn_train, h_shifted)
                    else:
                        h = block(h, bn_train)
            feats[f"layer{stage}"] = nhwc(h)
        feats["out"] = nhwc(h)
        return feats
