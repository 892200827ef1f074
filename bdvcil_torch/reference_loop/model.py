"""The independent torch ResNet-18-TSM of the accuracy study (the port's copy
of the parts of ``tests/torch_oracle.py`` that the loop uses).

Written from the reference semantics (mmaction2 ResNetTSM: torchvision
resnet topology + temporal channel shift before each block's conv1) with
torchvision ``state_dict`` names, so ``models/pretrained.load_torch_resnet_backbone``
takes its weights as they are. Plain torch: the port's model and kernels are
held against it, so it uses none of them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def tsm_shift(x: torch.Tensor, num_segments: int, shift_div: int = 8) -> torch.Tensor:
    """Reference TSM shift: first fold shifted backward in time (frame t sees
    t+1), second fold forward, remainder untouched. x: (N*T, C, H, W)."""
    nt, c, h, w = x.shape
    n = nt // num_segments
    xv = x.view(n, num_segments, c, h, w)
    fold = c // shift_div
    out = torch.zeros_like(xv)
    out[:, :-1, :fold] = xv[:, 1:, :fold]
    out[:, 1:, fold : 2 * fold] = xv[:, :-1, fold : 2 * fold]
    out[:, :, 2 * fold :] = xv[:, :, 2 * fold :]
    return out.view(nt, c, h, w)


class BasicBlockTSM(nn.Module):
    def __init__(self, inplanes, planes, stride, num_segments, shift_div=8, is_shift=True):
        super().__init__()
        self.num_segments = num_segments
        self.shift_div = shift_div
        self.is_shift = is_shift
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes),
            )

    def forward(self, x):
        identity = x
        h = tsm_shift(x, self.num_segments, self.shift_div) if self.is_shift else x
        h = F.relu(self.bn1(self.conv1(h)))
        h = self.bn2(self.conv2(h))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(h + identity)


class TorchResNet18TSM(nn.Module):
    """ResNet-18 TSM whose forward returns the four stages' outputs (the KD taps)."""

    def __init__(self, num_segments=4, shift_div=8, is_shift=True):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        planes = [64, 128, 256, 512]
        inplanes = 64
        for i, p in enumerate(planes):
            blocks = []
            for b in range(2):
                stride = 2 if (i > 0 and b == 0) else 1
                blocks.append(
                    BasicBlockTSM(inplanes, p, stride, num_segments, shift_div, is_shift)
                )
                inplanes = p
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        taps = {}
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, 2, 1)
        for i in range(1, 5):
            h = getattr(self, f"layer{i}")(h)
            taps[f"layer{i}"] = h
        return taps


def lsc_scores(x: torch.Tensor, weights: torch.Tensor, num_classes: int, nb_proxies: int):
    """Reference LSC classifier, op-for-op (cosine_linear.py:27-43):
    weights (out, nb_proxies*in) viewed as (nb_proxies*out, in)."""
    in_features = x.shape[1]
    sims = F.cosine_similarity(
        x.view(x.size(0), 1, in_features),
        weights.view(1, nb_proxies * num_classes, in_features),
        dim=2,
    )
    sims = sims.reshape(-1, num_classes, nb_proxies)
    attn = torch.softmax(sims, dim=2)
    return (attn * sims).sum(dim=2)
