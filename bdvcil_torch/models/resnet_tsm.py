"""ResNet-TSM backbone (port of ``bdvcil_tpu/models/resnet_tsm.py``).

A torchvision-style ResNet-18/34/50/101 where every residual block applies
the temporal channel shift to its input before conv1 (mmaction2
``shift_place='blockres'``). ``forward`` returns a dict of tagged stage
outputs (``layer1``..``layer4``, ``out``) for the feature-distillation taps.

Layout: the public input and outputs are ``(N*T, H, W, C)``, the JAX layout.
Inside, activations are NCHW tensors in ``torch.channels_last`` memory, the
same bytes, so a 1x1 conv is a GEMM on a contiguous ``(M, K)`` view and the
NHWC kernels take the tensors as they are.

Mixed precision: ``dtype`` is the compute/activation dtype (convs cast their
input and weight to it), ``norm_dtype`` the BatchNorm output dtype;
parameters and BatchNorm statistics stay float32.

Switches, as in the JAX package:
  * ``shift_mode``: ``'pad'`` (materialised shift, the default) or
    ``'fused_block'`` (each block's epilogue kernel emits its successor's
    shifted input, ``ops/tsm_shift.fused_residual_relu_shift``);
  * ``conv1x1_mode``: ``'xla'`` (plain conv, the default) or
    ``'pallas_stats'`` (bottleneck conv1/conv3 as the GEMM kernel with a
    BatchNorm-statistics epilogue, ``ops/conv1x1_bn``; needs ``shift_mode ==
    'pad'``). The names follow the JAX package's configs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv1x1_bn import conv1x1_bn
from ..ops.tsm_shift import fused_residual_relu_shift, temporal_shift
from .norm import BatchNorm

# depth -> (block type, stage sizes, expansion)
ARCH = {
    18: ("basic", (2, 2, 2, 2), 1),
    34: ("basic", (3, 4, 6, 3), 1),
    50: ("bottleneck", (3, 4, 6, 3), 4),
    101: ("bottleneck", (3, 4, 23, 3), 4),
}

SHIFT_MODES = ("pad", "fused_block")
CONV1X1_MODES = ("xla", "pallas_stats")


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


def _downsample(inplanes, planes, stride, dtype, norm_dtype, device):
    return nn.Sequential(
        Conv2d(inplanes, planes, 1, stride, 0, dtype, device),
        BatchNorm(planes, dtype=norm_dtype, device=device),
    )


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride, num_segments, shift_div, is_shift, dtype,
                 norm_dtype, shift_mode="pad", device=None):
        super().__init__()
        self.num_segments, self.shift_div, self.is_shift = num_segments, shift_div, is_shift
        self.fused_block = is_shift and shift_mode == "fused_block"
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, dtype, device)
        self.bn1 = BatchNorm(planes, dtype=norm_dtype, device=device)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, dtype, device)
        self.bn2 = BatchNorm(planes, dtype=norm_dtype, device=device)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = _downsample(inplanes, planes, stride, dtype, norm_dtype, device)

    def forward(self, x, train: bool, x_shifted=None):
        identity = x
        if self.fused_block:
            h = x_shifted  # the producer block emitted shift(x) already
        else:
            h = _shift(x, self.num_segments, self.shift_div) if self.is_shift else x
        h = F.relu(self.bn1(self.conv1(h), train))
        h = self.bn2(self.conv2(h), train)
        if self.downsample is not None:
            identity = self.downsample[1](self.downsample[0](identity), train)
        if self.fused_block:
            return _fused_epilogue(h, identity.to(h.dtype), self.num_segments, self.shift_div)
        return F.relu(h + identity.to(h.dtype))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride, num_segments, shift_div, is_shift, dtype,
                 norm_dtype, shift_mode="pad", conv1x1_mode="xla", device=None):
        super().__init__()
        self.num_segments, self.shift_div, self.is_shift = num_segments, shift_div, is_shift
        self.fused_block = is_shift and shift_mode == "fused_block"
        # the GEMM-with-stats path replaces conv1/bn1 and conv3/bn3 when the
        # shift is materialised (the JAX package's condition)
        self.use_stats_gemm = conv1x1_mode == "pallas_stats" and shift_mode == "pad"
        self.dtype, self.norm_dtype = dtype, norm_dtype
        out_planes = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, 1, 0, dtype, device)
        self.bn1 = BatchNorm(planes, dtype=norm_dtype, device=device)
        # stride on the 3x3 (torch / mmaction2 'pytorch' style)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, dtype, device)
        self.bn2 = BatchNorm(planes, dtype=norm_dtype, device=device)
        self.conv3 = Conv2d(planes, out_planes, 1, 1, 0, dtype, device)
        self.bn3 = BatchNorm(out_planes, dtype=norm_dtype, device=device)
        self.downsample = None
        if stride != 1 or inplanes != out_planes:
            self.downsample = _downsample(inplanes, out_planes, stride, dtype, norm_dtype, device)

    def _conv_bn(self, h, conv, bn, train):
        if self.use_stats_gemm:
            out = conv1x1_bn(nhwc(h), conv.weight, bn, train, self.dtype, self.norm_dtype)
            return nchw(out)
        return bn(conv(h), train)

    def forward(self, x, train: bool, x_shifted=None):
        identity = x
        if self.fused_block:
            h = x_shifted
        else:
            h = _shift(x, self.num_segments, self.shift_div) if self.is_shift else x
        h = F.relu(self._conv_bn(h, self.conv1, self.bn1, train))
        h = F.relu(self.bn2(self.conv2(h), train))
        h = self._conv_bn(h, self.conv3, self.bn3, train)
        if self.downsample is not None:
            identity = self.downsample[1](self.downsample[0](identity), train)
        if self.fused_block:
            return _fused_epilogue(h, identity.to(h.dtype), self.num_segments, self.shift_div)
        return F.relu(h + identity.to(h.dtype))


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class ResNetTSM(nn.Module):
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
            raise _not_ported(f"shift_mode={shift_mode!r}", "A.1 (shifted_conv 'fused')")
        if conv1x1_mode not in CONV1X1_MODES:
            raise _not_ported(f"conv1x1_mode={conv1x1_mode!r}", "A.1 (conv1x1 modes)")
        if stem_mode != "conv":
            raise _not_ported(f"stem_mode={stem_mode!r}", "A.1 (s2d stem)")
        if bn_groups != 1 or bn_stats_rows:
            raise _not_ported("GroupedBatchNorm (bn_groups / bn_stats_rows)", "A.1 (norm)")
        block_kind, stage_sizes, expansion = ARCH[depth]
        self.depth = depth
        self.num_segments, self.shift_div, self.is_shift = num_segments, shift_div, is_shift
        self.norm_eval = norm_eval
        self.dtype, self.norm_dtype = dtype, norm_dtype
        self.fused_block = is_shift and shift_mode == "fused_block"

        self.conv1 = Conv2d(3, 64, 7, 2, 3, dtype, device)
        self.bn1 = BatchNorm(64, dtype=norm_dtype, device=device)
        inplanes, planes = 64, 64
        for stage_idx, num_blocks in enumerate(stage_sizes):
            blocks = []
            for block_idx in range(num_blocks):
                stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
                kw = dict(shift_mode=shift_mode, device=device)
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
        h = F.relu(self.bn1(self.conv1(h), bn_train))
        h = F.max_pool2d(h, 3, 2, 1)

        feats: Dict[str, torch.Tensor] = {}
        # fused_block threads shift(block output) alongside the output: each
        # block's epilogue kernel emits its successor's shifted input
        h_shifted = _shift(h, self.num_segments, self.shift_div) if self.fused_block else None
        for stage in range(1, 5):
            for block in getattr(self, f"layer{stage}"):
                if self.fused_block:
                    h, h_shifted = block(h, bn_train, h_shifted)
                else:
                    h = block(h, bn_train)
            feats[f"layer{stage}"] = nhwc(h)
        feats["out"] = nhwc(h)
        return feats
