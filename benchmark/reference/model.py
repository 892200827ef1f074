"""TSM-ResNet with the LSC head and the LSC (PODNet NCA) loss, as plain
functions of a parameter dict.

Published descriptions followed:
  * ResNet-18/34 (basic blocks) and -50/101 (bottlenecks), torchvision's
    layout: a 7x7/2 stem, a 3x3/2 max pool, the stride on the first 3x3 of
    a stage, a 1x1 conv + BatchNorm on the shortcut where the shape changes;
  * TSM (Lin, Gan and Han, ICCV 2019), residual shift ('blockres'): each
    block shifts its input along time before its first conv, the first
    1/shift_div of the channels taken from the next frame and the second
    from the previous one, zeros at the ends; the shortcut takes the
    unshifted input;
  * BatchNorm in train mode: the batch's mean and biased variance over
    (N, H, W), eps 1e-5;
  * the TSM head: spatial average pool, dropout, the classifier per frame,
    the average over the segments (AvgConsensus);
  * the LSC classifier (PODNet's local similarity classifier): cosine
    similarity of the L2-normalised feature against each class's
    L2-normalised proxies, softmax-weighted over the proxies;
  * the LSC loss (PODNet NCA): eta * (s - margin), less its row maximum,
    the positive's logit zeroed in the denominator as PODNet's code does, a
    hinge at 0, the mean over the rows weighted by their sample weights.

Departures: the dropout mask is drawn as ``torch.rand(rows, C) < 1 - rate``
from a generator seeded with the seed the benchmark hands over, the same
stream the system under test draws from, so that both drop the same units.
Parameters are named as torchvision names them, under ``backbone.`` and
``cls_head.`` (``fc_weights``, ``eta``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

ARCH = {
    18: ("basic", (2, 2, 2, 2), 1),
    34: ("basic", (3, 4, 6, 3), 1),
    50: ("bottleneck", (3, 4, 6, 3), 4),
    101: ("bottleneck", (3, 4, 23, 3), 4),
}
EPS = 1e-5

Params = Dict[str, torch.Tensor]


def param_shapes(depth: int, num_classes: int, nb_proxies: int = 1) -> Dict[str, Tuple]:
    """Every parameter's name and shape, in the order a forward uses them."""
    kind, blocks_per_stage, expansion = ARCH[depth]
    shapes: Dict[str, Tuple] = {"backbone.conv1.weight": (64, 3, 7, 7),
                                "backbone.bn1.weight": (64,), "backbone.bn1.bias": (64,)}
    c_prev = 64
    for si, blocks in enumerate(blocks_per_stage):
        mid = 64 * 2 ** si
        out = mid * expansion
        for b in range(blocks):
            pre = f"backbone.layer{si + 1}.{b}."
            stride = 2 if (b == 0 and si > 0) else 1
            convs = ([(c_prev, mid, 1), (mid, mid, 3), (mid, out, 1)] if kind == "bottleneck"
                     else [(c_prev, mid, 3), (mid, mid, 3)])
            for i, (ci, co, k) in enumerate(convs, 1):
                shapes[f"{pre}conv{i}.weight"] = (co, ci, k, k)
                shapes[f"{pre}bn{i}.weight"] = (co,)
                shapes[f"{pre}bn{i}.bias"] = (co,)
            if stride != 1 or c_prev != out:
                shapes[f"{pre}downsample.0.weight"] = (out, c_prev, 1, 1)
                shapes[f"{pre}downsample.1.weight"] = (out,)
                shapes[f"{pre}downsample.1.bias"] = (out,)
            c_prev = out
    shapes["cls_head.fc_weights"] = (num_classes, nb_proxies * 512 * expansion)
    shapes["cls_head.eta"] = (1,)
    return shapes


def temporal_shift(x: torch.Tensor, segments: int, shift_div: int) -> torch.Tensor:
    """x (N*T, C, H, W): channels [0, C/d) from frame t + 1, [C/d, 2C/d) from
    frame t - 1, zeros where there is none, the rest unchanged."""
    nt, c, h, w = x.shape
    fold = c // shift_div
    x = x.reshape(nt // segments, segments, c, h, w)
    out = torch.zeros_like(x)
    out[:, :-1, :fold] = x[:, 1:, :fold]
    out[:, 1:, fold:2 * fold] = x[:, :-1, fold:2 * fold]
    out[:, :, 2 * fold:] = x[:, :, 2 * fold:]
    return out.reshape(nt, c, h, w)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               stats: Optional[Dict[str, torch.Tensor]] = None, name: str = "") -> torch.Tensor:
    """Train-mode BatchNorm; the batch's variance goes to ``stats[name]``."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    if stats is not None:
        stats[name] = var.detach().reshape(-1)
    return (x - mean) / torch.sqrt(var + EPS) * weight[:, None, None] + bias[:, None, None]


def backbone(params: Params, x: torch.Tensor, depth: int, segments: int, shift_div: int,
             conv: Callable = F.conv2d,
             stats: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """x (N*T, 3, H, W) -> (N*T, C, h, w); each BatchNorm's batch variance
    goes to ``stats`` under its parameters' prefix."""
    kind, blocks_per_stage, _ = ARCH[depth]
    p = params

    def bn(y, prefix):
        return batch_norm(y, p[prefix + ".weight"], p[prefix + ".bias"], stats, prefix)

    h = F.relu(bn(conv(x, p["backbone.conv1.weight"], None, 2, 3), "backbone.bn1"))
    h = F.max_pool2d(h, 3, 2, 1)
    for si, blocks in enumerate(blocks_per_stage):
        for b in range(blocks):
            pre = f"backbone.layer{si + 1}.{b}."
            stride = 2 if (b == 0 and si > 0) else 1
            y = temporal_shift(h, segments, shift_div)
            if kind == "bottleneck":
                y = F.relu(bn(conv(y, p[pre + "conv1.weight"]), pre + "bn1"))
                y = F.relu(bn(conv(y, p[pre + "conv2.weight"], None, stride, 1), pre + "bn2"))
                y = bn(conv(y, p[pre + "conv3.weight"]), pre + "bn3")
            else:
                y = F.relu(bn(conv(y, p[pre + "conv1.weight"], None, stride, 1), pre + "bn1"))
                y = bn(conv(y, p[pre + "conv2.weight"], None, 1, 1), pre + "bn2")
            identity = h
            if pre + "downsample.0.weight" in p:
                identity = bn(conv(h, p[pre + "downsample.0.weight"], None, stride),
                              pre + "downsample.1")
            h = F.relu(y + identity)
    return h


def lsc_scores(feat: torch.Tensor, fc_weights: torch.Tensor, matmul: Callable = torch.matmul):
    """feat (R, C), fc_weights (classes, P * C) -> (R, classes)."""
    classes = fc_weights.shape[0]
    proxies = fc_weights.reshape(-1, feat.shape[1])
    fn = feat / torch.clamp(torch.linalg.vector_norm(feat, dim=1, keepdim=True), min=1e-8)
    pn = proxies / torch.clamp(torch.linalg.vector_norm(proxies, dim=1, keepdim=True), min=1e-8)
    sims = matmul(fn, pn.t()).reshape(feat.shape[0], classes, -1)
    return (torch.softmax(sims, dim=2) * sims).sum(dim=2)


def forward(params: Params, clips: torch.Tensor, depth: int, segments: int, shift_div: int,
            dropout: float, dropout_seed: Optional[int], conv: Callable = F.conv2d,
            matmul: Callable = torch.matmul,
            stats: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """clips (B, T, H, W, 3) normalised -> class scores (B, classes)."""
    b, t = clips.shape[:2]
    x = clips.reshape(b * t, *clips.shape[2:]).permute(0, 3, 1, 2)
    feat = backbone(params, x, depth, segments, shift_div, conv, stats).mean(dim=(2, 3))
    if dropout > 0:
        gen = torch.Generator(device=feat.device)
        gen.manual_seed(int(dropout_seed))
        keep = torch.rand(feat.shape, generator=gen, device=feat.device) < 1.0 - dropout
        feat = torch.where(keep, feat / (1.0 - dropout), torch.zeros_like(feat))
    scores = lsc_scores(feat, params["cls_head.fc_weights"], matmul)
    return scores.reshape(b, t, -1).mean(dim=1)


def lsc_loss(scores: torch.Tensor, labels: torch.Tensor, eta: torch.Tensor,
             weights: Optional[torch.Tensor], margin: float = 0.6) -> torch.Tensor:
    """PODNet's NCA over (B, classes) similarities, the positive left out of
    the denominator, clamped at 0, weighted mean over the rows."""
    z = eta.reshape(()) * (scores - margin)
    z = z - z.max(dim=1, keepdim=True).values.detach()
    rows = torch.arange(z.shape[0], device=z.device)
    pos = z[rows, labels]
    # PODNet's code zeroes the positive's logit in the denominator (it adds
    # exp(0) there) rather than dropping the term
    others = z.clone()
    others[rows, labels] = 0.0
    losses = torch.clamp(-(pos - torch.logsumexp(others, dim=1)), min=0.0)
    if weights is None:
        return losses.mean()
    return (losses * weights).sum() / torch.clamp(weights.sum(), min=1e-8)

