"""TimeSformer (divided space-time attention) with the LSC head and loss, and
its train steps under the labelled SGD, as plain float32 functions of a
parameter dict: the benchmark's reference for the ``timesformer`` family.

Published description followed (Bertasius, Wang and Torresani, ICML 2021,
arXiv:2102.05095; mmaction2's ``TimeSformer``, ``divided_space_time``):
  * a patch embedding: a conv of the patch size and stride on every frame,
    with a bias; a learned cls token; ``pos_embed`` (1 + P positions) added
    in every frame, then ``time_embed`` (T) added to the patches; the cls
    token ``cls_token + pos_embed[0]``;
  * each layer, three pre-LayerNorm residual sublayers (LayerNorm eps from
    the configuration): temporal attention over the T frames of each patch
    then ``temporal_fc``; spatial attention over the cls token and the P
    patches of each frame, the cls outputs averaged over the frames; an MLP
    ``fc2(gelu(fc1(x)))`` with the exact GELU;
  * multi-head attention as ``softmax(q k^T / sqrt(d)) v`` per head, q, k
    and v from one projection with a bias, then ``out_proj``;
  * a last LayerNorm of the cls token; the LSC head (``model.lsc_scores``)
    after dropout, the LSC loss (``model.lsc_loss``);
  * the SGD of the program's labels: linear and conv weights at the base
    rate with weight decay, their biases at twice the rate without, the
    LayerNorms and the three embeddings at the base rate without decay
    (mmaction2's ``decay_mult=0`` keys for this model), the LSC proxies and
    eta at ``fc_scale`` times the rate with decay; torch's momentum SGD.

Held as ``(B, P, T, M)`` patches beside a ``(B, M)`` cls token, not in the
program's flattened ``b (p t) m`` order. Float32 throughout, run with TF32
off (``harness.check`` sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False around it).

Departures: the stochastic depth (rising linearly from 0 to
``drop_path_rate`` over the layers, on the temporal branch's B P rows
before ``temporal_fc``, the spatial branch's B T rows and the MLP's B rows,
as mmaction2 applies it) and the head's dropout are drawn with
``torch.rand`` from a generator seeded with the seed the benchmark hands
over, in the system's order (layer by layer, temporal, spatial, MLP, layers
at rate 0 skipped, then the head), so that both drop the same units. The
masks are drawn for the whole batch first; the forward and backward then
run ``CHUNK`` clips at a time, their losses weighted to the batch's, so
that a batch of 24 fits one card in float32. Parameters carry mmaction2's
names under ``backbone.`` and the head's under ``cls_head.``.

Beside the losses, the first gradient and the last weights, ``train_steps``
gives ``scales``: for ``cls_head.eta``, the LSC temperature, what its first
gradient and its change would be if the terms they sum did not cancel. Its
gradient is a sum over the clips of terms of either sign (each clip's
positive similarity against the others'), which at random weights can
cancel to a small part of its terms: ``grad`` is the sum of the terms'
magnitudes, each clip's share of the batch's loss differentiated alone;
``change`` runs the momentum update on those magnitudes and on ``|decay w|``.

``precision='control'`` rounds the operands of every matrix product (the
linears, the patch conv, q k^T and the probabilities times v, the
classifier) to fp8 (e4m3 forward, e5m2 gradients), one step below the
configuration's bfloat16; ``'bf16'`` rounds them to bfloat16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import model
from .input_fn import input_fn
from .step import PRECISIONS, low_precision

LAYERS = "backbone.transformer_layers.layers."
EMBEDS = ("cls_token", "pos_embed", "time_embed")
CHUNK = 4  # clips a forward and backward
ETA = "cls_head.eta"

Params = Mapping[str, torch.Tensor]


def param_shapes(cfg: Mapping, num_classes: int, nb_proxies: int = 1) -> Dict[str, Tuple]:
    """Every parameter's name and shape. cfg: embed_dims, num_layers,
    mlp_ratio, patch_size, crop_size, num_segments."""
    m, ps = cfg["embed_dims"], cfg["patch_size"]
    p = (cfg["crop_size"] // ps) ** 2
    hidden = cfg["mlp_ratio"] * m
    shapes: Dict[str, Tuple] = {
        "backbone.cls_token": (1, 1, m), "backbone.pos_embed": (1, p + 1, m),
        "backbone.time_embed": (1, cfg["num_segments"], m),
        "backbone.patch_embed.projection.weight": (m, 3, ps, ps),
        "backbone.patch_embed.projection.bias": (m,)}
    for i in range(cfg["num_layers"]):
        for a in range(2):
            pre = f"{LAYERS}{i}.attentions.{a}."
            shapes.update({pre + "norm.weight": (m,), pre + "norm.bias": (m,),
                           pre + "attn.in_proj_weight": (3 * m, m),
                           pre + "attn.in_proj_bias": (3 * m,),
                           pre + "attn.out_proj.weight": (m, m),
                           pre + "attn.out_proj.bias": (m,)})
            if a == 0:
                shapes.update({pre + "temporal_fc.weight": (m, m),
                               pre + "temporal_fc.bias": (m,)})
        pre = f"{LAYERS}{i}.ffns.0."
        shapes.update({pre + "norm.weight": (m,), pre + "norm.bias": (m,),
                       pre + "layers.0.0.weight": (hidden, m), pre + "layers.0.0.bias": (hidden,),
                       pre + "layers.1.weight": (m, hidden), pre + "layers.1.bias": (m,)})
    shapes.update({"backbone.norm.weight": (m,), "backbone.norm.bias": (m,),
                   "cls_head.fc_weights": (num_classes, nb_proxies * m), "cls_head.eta": (1,)})
    return shapes


def rates(drop_path_rate: float, num_layers: int) -> List[float]:
    """np.linspace(0, drop_path_rate, num_layers): start + i * step."""
    if num_layers == 1:
        return [0.0]
    return [i * (drop_path_rate / (num_layers - 1)) for i in range(num_layers)]


def draw_masks(seed: int, device, b: int, t: int, p: int, m: int, layer_rates: List[float],
               dropout: float) -> Dict:
    """One train forward's keep masks, drawn in the system's order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    layers = []
    for rate in layer_rates:
        if rate == 0.0:
            layers.append(None)
            continue
        keep = 1.0 - rate
        temporal = torch.rand(b * p, generator=gen, device=device) < keep
        spatial = torch.rand(b * t, generator=gen, device=device) < keep
        mlp = torch.rand(b, generator=gen, device=device) < keep
        layers.append((temporal.reshape(b, p), spatial.reshape(b, t), mlp, keep))
    head = (torch.rand((b, m), generator=gen, device=device) < 1.0 - dropout
            if dropout > 0 else None)
    return {"layers": layers, "head": head}


def chunk_masks(masks: Dict, rows: slice) -> Dict:
    return {"layers": [None if d is None else (d[0][rows], d[1][rows], d[2][rows], d[3])
                       for d in masks["layers"]],
            "head": None if masks["head"] is None else masks["head"][rows]}


def layer_norm(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + bias


def linear(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, matmul: Callable) -> torch.Tensor:
    return matmul(x, w.t()) + bias


def self_attention(x: torch.Tensor, params: Params, pre: str, heads: int,
                   matmul: Callable) -> torch.Tensor:
    """x (..., L, M): multi-head self-attention, written out."""
    m = x.shape[-1]
    d = m // heads
    qkv = linear(x, params[pre + "in_proj_weight"], params[pre + "in_proj_bias"], matmul)
    q, k, v = (y.reshape(*y.shape[:-1], heads, d).transpose(-3, -2)
               for y in qkv.split(m, dim=-1))  # (..., heads, L, d)
    probs = torch.softmax(matmul(q, k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
    o = matmul(probs, v).transpose(-3, -2).reshape(x.shape)
    return linear(o, params[pre + "out_proj.weight"], params[pre + "out_proj.bias"], matmul)


def _dropped(y: torch.Tensor, keep: Optional[torch.Tensor], keep_prob: float) -> torch.Tensor:
    if keep is None:
        return y
    keep = keep.reshape(keep.shape + (1,) * (y.dim() - keep.dim()))
    return torch.where(keep, y / keep_prob, torch.zeros_like(y))


def backbone(params: Params, clips: torch.Tensor, cfg: Mapping, masks: Optional[Dict],
             conv: Callable = F.conv2d, matmul: Callable = torch.matmul) -> torch.Tensor:
    """clips (B, T, H, W, 3) normalised -> the cls feature (B, M)."""
    p_ = params
    b, t = clips.shape[:2]
    eps, heads = cfg["ln_eps"], cfg["num_heads"]
    frames = clips.reshape(b * t, *clips.shape[2:]).permute(0, 3, 1, 2)
    patches = conv(frames, p_["backbone.patch_embed.projection.weight"], None,
                   cfg["patch_size"], 0) + p_["backbone.patch_embed.projection.bias"][:, None, None]
    m = patches.shape[1]
    pos = p_["backbone.pos_embed"][0]
    patches = patches.reshape(b, t, m, -1).permute(0, 3, 1, 2) + pos[1:, None, :]  # (B, P, T, M)
    patches = patches + p_["backbone.time_embed"][0]
    cls = (p_["backbone.cls_token"][0, 0] + pos[0]).expand(b, m)
    for i in range(cfg["num_layers"]):
        drop = masks["layers"][i] if masks is not None else None
        keeps = (None, None, None, 1.0) if drop is None else drop
        a = f"{LAYERS}{i}.attentions.0."
        h = layer_norm(patches, p_[a + "norm.weight"], p_[a + "norm.bias"], eps)
        h = _dropped(self_attention(h, p_, a + "attn.", heads, matmul), keeps[0], keeps[3])
        patches = patches + linear(h, p_[a + "temporal_fc.weight"], p_[a + "temporal_fc.bias"],
                                   matmul)
        a = f"{LAYERS}{i}.attentions.1."
        tokens = torch.cat((cls[:, None, None, :].expand(b, t, 1, m),
                            patches.permute(0, 2, 1, 3)), dim=2)  # (B, T, 1 + P, M)
        h = layer_norm(tokens, p_[a + "norm.weight"], p_[a + "norm.bias"], eps)
        h = _dropped(self_attention(h, p_, a + "attn.", heads, matmul), keeps[1], keeps[3])
        cls = cls + h[:, :, 0].mean(dim=1)
        patches = patches + h[:, :, 1:].permute(0, 2, 1, 3)
        f = f"{LAYERS}{i}.ffns.0."

        def mlp(x):
            h = layer_norm(x, p_[f + "norm.weight"], p_[f + "norm.bias"], eps)
            h = F.gelu(linear(h, p_[f + "layers.0.0.weight"], p_[f + "layers.0.0.bias"], matmul))
            h = linear(h, p_[f + "layers.1.weight"], p_[f + "layers.1.bias"], matmul)
            return _dropped(h, keeps[2], keeps[3])

        cls, patches = cls + mlp(cls), patches + mlp(patches)
    return layer_norm(cls, p_["backbone.norm.weight"], p_["backbone.norm.bias"], eps)


def forward(params: Params, clips: torch.Tensor, cfg: Mapping, masks: Optional[Dict],
            conv: Callable = F.conv2d, matmul: Callable = torch.matmul) -> torch.Tensor:
    """clips (B, T, H, W, 3) -> class scores (B, classes); ``masks`` from
    ``draw_masks`` in train mode, None for none."""
    feat = backbone(params, clips, cfg, masks, conv, matmul)
    if masks is not None and masks["head"] is not None:
        feat = _dropped(feat, masks["head"], 1.0 - cfg["dropout"])
    return model.lsc_scores(feat, params["cls_head.fc_weights"], matmul)


def group_of(name: str) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("fc_weights", "eta"):
        return "classifier_weight"
    if ".norm." in name:
        return "norm"
    if leaf in EMBEDS:
        return "embed"
    if leaf in ("bias", "in_proj_bias"):
        return "normal_bias"
    return "normal_weight"


def lr_and_decay(name: str, lr: float, wd: float, fc_scale: float):
    group = group_of(name)
    mult = {"normal_weight": 1.0, "normal_bias": 2.0, "norm": 1.0, "embed": 1.0,
            "classifier_weight": fc_scale}[group]
    return lr * mult, (wd if group in ("normal_weight", "classifier_weight") else 0.0)


def eta_terms(scores: torch.Tensor, labels: torch.Tensor, eta: torch.Tensor,
              weights: torch.Tensor, total: torch.Tensor, margin: float) -> torch.Tensor:
    """The sum over the rows of |d (a row's share of the batch's loss) / d eta|,
    the scores held fixed."""
    eta = eta.detach().clone().requires_grad_(True)
    out = torch.zeros((), device=scores.device)
    for r in range(scores.shape[0]):
        row = slice(r, r + 1)
        loss = model.lsc_loss(scores[row].detach(), labels[row], eta, weights[row],
                              margin) * (weights[r] / total)
        out = out + torch.autograd.grad(loss, eta)[0].abs().sum()
    return out


def train_steps(params0: Dict[str, torch.Tensor], batches: Sequence[Dict[str, torch.Tensor]],
                dropout_seeds: Sequence[int], cfg: Mapping, precision: Optional[str] = None,
                rows: Optional[slice] = None) -> Dict:
    """Run ``len(batches)`` train steps from ``params0``.

    cfg: the sizes of ``param_shapes``, num_heads, ln_eps, drop_path_rate,
    dropout, alpha, margin, lr, momentum, weight_decay, fc_scale,
    accumulate. ``rows`` keeps only those rows of every batch.

    Returns losses (one a step), ``first_grad`` (each parameter's gradient
    as the first update takes it), ``params`` after the last step, all
    float32, and ``scales`` (the module docstring).
    """
    conv, matmul = (low_precision(*PRECISIONS[precision]) if precision
                    else (F.conv2d, torch.matmul))
    params = {k: v.detach().clone().float() for k, v in params0.items()}
    momentum = {k: torch.zeros_like(v) for k, v in params.items()}
    acc = {k: torch.zeros_like(v) for k, v in params.items()}
    k_acc = int(cfg["accumulate"])
    layer_rates = rates(cfg["drop_path_rate"], cfg["num_layers"])
    losses: List[float] = []
    first_grad = None
    # eta's scales (the module docstring): the magnitudes of its gradient's
    # terms, carried through the momentum update as the gradient is
    eta_lr, eta_wd = lr_and_decay(ETA, cfg["lr"], cfg["weight_decay"], cfg["fc_scale"])
    terms_acc = terms_momentum = change_scale = 0.0
    grad_scale = None
    for step, (batch, seed) in enumerate(zip(batches, dropout_seeds)):
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
        with torch.no_grad():
            clips = input_fn(batch, alpha=cfg["alpha"])
        b, t, size = clips.shape[:3]
        p = (size // cfg["patch_size"]) ** 2
        masks = draw_masks(seed, clips.device, b, t, p, cfg["embed_dims"], layer_rates,
                           cfg["dropout"])
        labels = batch["label"].reshape(-1).long()
        weights = batch.get("sample_weight")
        weights = (torch.ones(b, device=clips.device) if weights is None
                   else weights.float().reshape(-1))
        total = torch.clamp(weights.sum(), min=1e-8)
        loss_sum = 0.0
        for lo in range(0, b, CHUNK):
            sl = slice(lo, min(lo + CHUNK, b))
            leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            scores = forward(leaves, clips[sl], cfg, chunk_masks(masks, sl), conv, matmul)
            # the chunk's share of the batch's weighted mean
            loss = model.lsc_loss(scores, labels[sl], leaves["cls_head.eta"], weights[sl],
                                  cfg["margin"]) * (weights[sl].sum() / total)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            terms_acc += float(eta_terms(scores, labels[sl], leaves[ETA], weights[sl], total,
                                         cfg["margin"]))
            loss_sum += float(loss.detach())
            for (name, _), g in zip(params.items(), grads):
                acc[name] += g
            del leaves, scores, loss, grads
        losses.append(loss_sum)
        del clips, masks
        if (step + 1) % k_acc:
            continue
        with torch.no_grad():
            mean = {n: a / k_acc for n, a in acc.items()}
            if first_grad is None:
                first_grad = {n: g.clone() for n, g in mean.items()}
                grad_scale = terms_acc / k_acc
            terms_momentum = (cfg["momentum"] * terms_momentum + terms_acc / k_acc
                              + eta_wd * float(params[ETA].abs().sum()))
            change_scale += eta_lr * terms_momentum
            terms_acc = 0.0
            for name, p_ in params.items():
                lr, wd = lr_and_decay(name, cfg["lr"], cfg["weight_decay"], cfg["fc_scale"])
                momentum[name] = cfg["momentum"] * momentum[name] + mean[name] + wd * p_
                p_ -= lr * momentum[name]
            acc = {k: torch.zeros_like(v) for k, v in params.items()}
    return {"losses": losses, "first_grad": first_grad, "params": params,
            "scales": {"grad": {ETA: grad_scale}, "change": {ETA: change_scale}}}
