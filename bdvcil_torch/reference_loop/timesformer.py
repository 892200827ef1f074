"""TimeSformer (divided space-time attention) with the LSC head, as plain
float32 functions of a parameter dict: the CPU tests' reference for
``models/timesformer.py``.

Published description followed (arXiv:2102.05095, mmaction2's
``TimeSformer`` with ``attention_type='divided_space_time'``): a patch
embedding (a conv of the patch size and stride); a cls token; ``pos_embed``
added in every frame and ``time_embed`` to the patches; each layer a
temporal attention over the frames of each patch followed by
``temporal_fc``, a spatial attention over each frame's patches beside the
cls token (its outputs averaged over the frames), and a GELU MLP, each a
pre-LayerNorm residual; a last LayerNorm of the cls token. The head: dropout,
then the LSC classifier (cosine similarity against the class proxies,
softmax-weighted over the proxies).

Written independently of the program's layout: the patch tokens are held
as ``(B, P, T, M)`` and the cls token as ``(B, M)``; attention is
``softmax(q k^T / sqrt(d)) v`` written out per head. Float32; on a card,
call it with ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False, so that no product runs in TF32.

Departures: the stochastic-depth and dropout masks come from ``draw_masks``
(``torch.rand`` from the step's generator in the program's order: layer by
layer, temporal (B P rows), spatial (B T), MLP (B), layers at rate 0
skipped, then the head's dropout (B, M)), so that both drop the same
units; mmaction2's drop path of the temporal branch acts before
``temporal_fc``, as here. Parameters carry mmaction2's names under
``backbone.`` and the LSC head's under ``cls_head.``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F

PREFIX = "backbone.transformer_layers.layers."

Params = Mapping[str, torch.Tensor]


def rates(drop_path_rate: float, num_layers: int) -> List[float]:
    """Stochastic depth a layer: np.linspace(0, rate, layers)."""
    if num_layers == 1:
        return [0.0]
    return [i * (drop_path_rate / (num_layers - 1)) for i in range(num_layers)]


def draw_masks(generator: torch.Generator, b: int, t: int, p: int, m: int,
               layer_rates: List[float], dropout: float) -> Dict:
    """The keep masks of one train forward, in the program's draw order."""
    dev = generator.device
    masks: Dict = {"layers": []}
    for rate in layer_rates:
        if rate == 0.0:
            masks["layers"].append(None)
            continue
        keep = 1.0 - rate
        temporal = torch.rand(b * p, generator=generator, device=dev) < keep
        spatial = torch.rand(b * t, generator=generator, device=dev) < keep
        mlp = torch.rand(b, generator=generator, device=dev) < keep
        masks["layers"].append((temporal.reshape(b, p), spatial.reshape(b, t), mlp, keep))
    if dropout > 0:
        masks["head"] = torch.rand((b, m), generator=generator, device=dev) < 1.0 - dropout
    return masks


def layer_norm(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + bias


def self_attention(x: torch.Tensor, params: Params, pre: str, heads: int) -> torch.Tensor:
    """x (..., L, M): multi-head self-attention with qkv in one projection."""
    m = x.shape[-1]
    d = m // heads
    qkv = x @ params[pre + "in_proj_weight"].t() + params[pre + "in_proj_bias"]
    q, k, v = qkv.split(m, dim=-1)
    split = lambda y: y.reshape(*y.shape[:-1], heads, d).transpose(-3, -2)  # noqa: E731
    q, k, v = split(q), split(k), split(v)  # (..., heads, L, d)
    scores = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
    o = (scores @ v).transpose(-3, -2).reshape(x.shape)
    return o @ params[pre + "out_proj.weight"].t() + params[pre + "out_proj.bias"]


def backbone(params: Params, clips: torch.Tensor, cfg: Mapping,
             masks: Optional[Dict] = None) -> torch.Tensor:
    """clips (B, T, H, W, 3) normalized -> the cls feature (B, M).

    cfg: patch_size, num_heads, num_layers, ln_eps."""
    p_ = params
    b, t = clips.shape[:2]
    eps, heads = cfg["ln_eps"], cfg["num_heads"]
    frames = clips.reshape(b * t, *clips.shape[2:]).permute(0, 3, 1, 2)
    conv = F.conv2d(frames, p_["backbone.patch_embed.projection.weight"],
                    p_["backbone.patch_embed.projection.bias"], stride=cfg["patch_size"])
    m = conv.shape[1]
    pos = p_["backbone.pos_embed"][0]  # (1 + P, M)
    patches = conv.reshape(b, t, m, -1).permute(0, 3, 1, 2) + pos[1:, None, :]  # (B, P, T, M)
    patches = patches + p_["backbone.time_embed"][0]
    cls = (p_["backbone.cls_token"][0, 0] + pos[0]).expand(b, m)
    for i in range(cfg["num_layers"]):
        pre = f"{PREFIX}{i}."
        drop = masks["layers"][i] if masks is not None else None

        def dropped(y, which):
            if drop is None:
                return y
            keep = drop[which].reshape(drop[which].shape + (1,) * (y.dim() - drop[which].dim()))
            return torch.where(keep, y / drop[3], torch.zeros_like(y))

        # temporal: each patch attends over the T frames
        a = pre + "attentions.0."
        h = layer_norm(patches, p_[a + "norm.weight"], p_[a + "norm.bias"], eps)
        h = dropped(self_attention(h, p_, a + "attn.", heads), 0)
        patches = patches + h @ p_[a + "temporal_fc.weight"].t() + p_[a + "temporal_fc.bias"]
        # spatial: in each frame the cls token and the P patches
        a = pre + "attentions.1."
        tokens = torch.cat((cls[:, None, None, :].expand(b, t, 1, m),
                            patches.permute(0, 2, 1, 3)), dim=2)  # (B, T, 1 + P, M)
        h = layer_norm(tokens, p_[a + "norm.weight"], p_[a + "norm.bias"], eps)
        h = dropped(self_attention(h, p_, a + "attn.", heads), 1)
        cls = cls + h[:, :, 0].mean(dim=1)
        patches = patches + h[:, :, 1:].permute(0, 2, 1, 3)
        # MLP on every token
        f = pre + "ffns.0."
        for which in ("cls", "patches"):
            x = cls if which == "cls" else patches
            h = layer_norm(x, p_[f + "norm.weight"], p_[f + "norm.bias"], eps)
            h = F.gelu(h @ p_[f + "layers.0.0.weight"].t() + p_[f + "layers.0.0.bias"])
            h = h @ p_[f + "layers.1.weight"].t() + p_[f + "layers.1.bias"]
            if which == "cls":
                cls = cls + dropped(h, 2)
            else:
                patches = patches + dropped(h, 2)
    return layer_norm(cls, p_["backbone.norm.weight"], p_["backbone.norm.bias"], eps)


def lsc_scores(feat: torch.Tensor, fc_weights: torch.Tensor) -> torch.Tensor:
    """feat (R, C), fc_weights (classes, P * C) -> (R, classes)."""
    proxies = fc_weights.reshape(-1, feat.shape[1])
    fn = feat / torch.clamp(torch.linalg.vector_norm(feat, dim=1, keepdim=True), min=1e-8)
    pn = proxies / torch.clamp(torch.linalg.vector_norm(proxies, dim=1, keepdim=True), min=1e-8)
    sims = (fn @ pn.t()).reshape(feat.shape[0], fc_weights.shape[0], -1)
    return (torch.softmax(sims, dim=2) * sims).sum(dim=2)


def forward(params: Params, clips: torch.Tensor, cfg: Mapping, dropout: float = 0.0,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Class scores (B, classes) of clips (B, T, H, W, 3); with ``generator``
    the train forward, its masks drawn from it."""
    masks = None
    if generator is not None:
        b, t, hgt = clips.shape[:3]
        p = (hgt // cfg["patch_size"]) ** 2
        m = params["backbone.cls_token"].shape[-1]
        masks = draw_masks(generator, b, t, p, m,
                           rates(cfg["drop_path_rate"], cfg["num_layers"]), dropout)
    feat = backbone(params, clips, cfg, masks)
    if masks is not None and "head" in masks:
        feat = torch.where(masks["head"], feat / (1.0 - dropout), torch.zeros_like(feat))
    return lsc_scores(feat, params["cls_head.fc_weights"])
