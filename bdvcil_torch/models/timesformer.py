"""TimeSformer with divided space-time attention (Bertasius, Wang and
Torresani, ICML 2021, arXiv:2102.05095), in mmaction2's layout
(``mmaction/models/backbones/timesformer.py``, ``attention_type=
'divided_space_time'``) and under mmaction2's ``state_dict`` names.

Input: clips ``(N, T, C, H, W)`` of normalized frames (the recognizer hands
``N = B * crops * clips``). Tokens are ``(N, 1 + P * T, M)`` in mmaction2's
order: the cls token first, then the patches outer and the frames inner
(``b (p t) m``).

  * embedding (``model.embed``): a Conv2d of ``patch_size`` with stride
    ``patch_size`` on every frame, the P patches of a frame in row-major
    order; the cls token; ``pos_embed`` (1 + P positions) added in every
    frame, then ``time_embed`` (T) added to the patch tokens; the cls
    token is ``cls_token + pos_embed[0]``, the same in every frame, so the
    first frame's is kept;
  * each layer (``model.block``), three residual sublayers:

      - temporal attention (``model.attn_t``): the patch tokens as
        ``(N * P, T, M)``, LayerNorm, multi-head attention over the T frames,
        drop path, ``temporal_fc``, added to the patch tokens; the cls
        token passes unchanged;
      - spatial attention (``model.attn_s``): the cls token repeated once a
        frame beside that frame's patches, ``(N * T, 1 + P, M)``, LayerNorm,
        multi-head attention over the 1 + P tokens, drop path; the cls
        outputs averaged over the frames; the result, turned back to
        ``b (p t) m``, added to the tokens;
      - MLP (``model.mlp``): ``x + drop_path(fc2(gelu(fc1(LN(x)))))``,
        exact (erf) GELU;

  * a last LayerNorm of the cls token: the ``(N, M)`` feature ``out``.

mmaction2's quirks, kept: the temporal sublayer's drop path acts on its
``N * P`` rows (a patch's temporal update is dropped, not a clip's) and
before ``temporal_fc``, so a dropped row still gets the layer's bias; the
spatial one on its ``N * T`` rows; the MLP's on the N clips. Stochastic
depth rises linearly from 0 at the first layer to ``drop_path_rate`` at the
last (``np.linspace``); a layer at 0 draws nothing.

**Random draws.** In train mode with a ``generator``, each drop path draws
``torch.rand(rows * world)`` on the generator's device (this rank's rows
kept under a process group, as ``heads.dropout`` does) and keeps the rows
whose draw is below ``1 - rate``, scaled by ``1 / (1 - rate)``. The order
is fixed: layer by layer, temporal, spatial, MLP, skipping layers at rate
0; the head's dropout draws after the backbone. A plain reference seeded
as the step's generator replays every mask.

**Feature taps.** The outputs of the layers at the quarter points of depth
are served as ``layer1``..``layer4`` (layer ``max(1, floor(k L / 4))``
serves ``layer<k>``: 3, 6, 9 and 12 of 12), so the reference configs' ``kd_modules_names``
(``backbone.layer1``..``layer4``) distil a ViT at the same relative depths
as the ResNet's four stages.

**Precision.** Parameters stay float32; activations, the residual stream
included, are in ``dtype`` (the linears and the patch conv cast their
weights to it). LayerNorm computes its statistics in float32 (torch does
for 16-bit input), and so does the attention's softmax (inside
``scaled_dot_product_attention``, and ``torch.softmax`` of the temporal
one).

**Attention.** On ``(S, heads, L, head_dim)``. The spatial attention is
``F.scaled_dot_product_attention`` with the backend pinned
(``torch.nn.attention.sdpa_kernel``): flash attention, or on the card in
float32 (which flash does not take) the memory-efficient kernel; never a
silent fallback to the math path. The temporal attention over T = 8
positions is a batched matmul, ``softmax(q k^T / sqrt(d)) v`` (the softmax
accumulating in float32): on the H100 its forward and backward over 4,704
sequences take 1.32 ms a layer against flash's 6.78 and the efficient
kernel's 2.34, whose tiles are padded to 64 or 128 rows (``PERF.md``).
Each call counts in ``ops/_build.LAUNCHES`` by its path,
``attention.spatial.<backend>`` or ``attention.temporal.matmul``, so the
run's ``kernel launches`` line shows it. qkv is one ``M -> 3M`` projection with a bias, as
``nn.MultiheadAttention``'s ``in_proj_weight`` / ``in_proj_bias``, then
``out_proj``.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..ops import _build
from ..parallel import distributed
from ..utils.profiling import annotate

_BACKENDS = {"flash": SDPBackend.FLASH_ATTENTION,
             "efficient": SDPBackend.EFFICIENT_ATTENTION}
ATTENTION_TYPES = ("divided_space_time",)


def attention_backend(q: torch.Tensor) -> str:
    """The pinned backend of the spatial attention: flash, except on the
    card in float32."""
    if q.device.type == "cuda" and q.dtype == torch.float32:
        return "efficient"
    return "flash"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, where: str) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v on (S, heads, L, d), its path counted:
    ``temporal`` as a batched matmul, ``spatial`` through the pinned kernel."""
    if where == "temporal":
        _build.LAUNCHES["attention.temporal.matmul"] += 1
        return torch.softmax((q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5, dim=-1) @ v
    backend = attention_backend(q)
    _build.LAUNCHES[f"attention.{where}.{backend}"] += 1
    with sdpa_kernel(_BACKENDS[backend]):
        return F.scaled_dot_product_attention(q, k, v)


def drop_path_rates(rate: float, num_layers: int) -> List[float]:
    """``np.linspace(0, rate, num_layers)``: start + i * step."""
    if num_layers == 1:
        return [0.0]
    step = rate / (num_layers - 1)
    return [i * step for i in range(num_layers)]


def drop_path(x: torch.Tensor, rate: float, train: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """mmcv's DropPath on x's leading rows, drawn as the module docstring says."""
    if not train or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    rows = x.shape[0]
    world = distributed.process_count()
    draw_device = x.device if generator is None else generator.device
    u = torch.rand(rows * world, generator=generator, device=draw_device)
    if world > 1:
        lo = distributed.process_index() * rows
        u = u[lo:lo + rows]
    keep = (u < keep_prob).to(x.device).reshape((rows,) + (1,) * (x.dim() - 1))
    return torch.where(keep, x / keep_prob, 0.0)


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype (the weight cast to it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm in its input's dtype: float32 statistics, the affine
    parameters cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class MultiheadSelfAttention(nn.Module):
    """Self-attention with ``nn.MultiheadAttention``'s parameters
    (``in_proj_weight`` (3M, M), ``in_proj_bias``, ``out_proj``), batch first."""

    def __init__(self, embed_dims: int, num_heads: int, device=None):
        super().__init__()
        if embed_dims % num_heads:
            raise ValueError(f"embed_dims {embed_dims} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims, embed_dims, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dims, device=device))
        self.out_proj = Linear(embed_dims, embed_dims, device=device)

    def forward(self, x: torch.Tensor, where: str) -> torch.Tensor:
        s, n, m = x.shape
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        q, k, v = qkv.view(s, n, 3, self.num_heads, m // self.num_heads).permute(2, 0, 3, 1, 4)
        o = attention(q, k, v, where)  # (s, heads, n, d)
        return self.out_proj(o.transpose(1, 2).reshape(s, n, m))


class _AttentionWithNorm(nn.Module):
    """mmaction2's ``Divided{Temporal,Spatial}AttentionWithNorm``: ``norm``, ``attn``."""

    def __init__(self, embed_dims, num_heads, eps, temporal, device=None):
        super().__init__()
        self.norm = LayerNorm(embed_dims, eps=eps, device=device)
        self.attn = MultiheadSelfAttention(embed_dims, num_heads, device)
        if temporal:
            self.temporal_fc = Linear(embed_dims, embed_dims, device=device)


class _FFNWithNorm(nn.Module):
    """mmaction2's ``FFNWithNorm``: ``norm``, ``layers.0.0`` (fc1), ``layers.1`` (fc2)."""

    def __init__(self, embed_dims, hidden, eps, device=None):
        super().__init__()
        self.norm = LayerNorm(embed_dims, eps=eps, device=device)
        self.layers = nn.ModuleList([nn.ModuleList([Linear(embed_dims, hidden, device=device)]),
                                     Linear(hidden, embed_dims, device=device)])


class DividedSTLayer(nn.Module):
    """One layer: ``attentions.0`` temporal, ``attentions.1`` spatial, ``ffns.0``."""

    def __init__(self, embed_dims, num_heads, hidden, eps, num_frames, drop_path_rate,
                 device=None):
        super().__init__()
        self.num_frames = num_frames
        self.drop_path_rate = drop_path_rate
        self.attentions = nn.ModuleList([
            _AttentionWithNorm(embed_dims, num_heads, eps, True, device),
            _AttentionWithNorm(embed_dims, num_heads, eps, False, device)])
        self.ffns = nn.ModuleList([_FFNWithNorm(embed_dims, hidden, eps, device)])

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        n, tokens, m = x.shape
        t = self.num_frames
        p = (tokens - 1) // t
        rate = self.drop_path_rate
        temporal, spatial = self.attentions
        with annotate("model.attn_t", train):
            cls, patches = x[:, :1], x[:, 1:]
            h = temporal.attn(temporal.norm(patches).reshape(n * p, t, m), "temporal")
            h = temporal.temporal_fc(drop_path(h, rate, train, generator))
            x = torch.cat((cls, patches + h.reshape(n, p * t, m)), dim=1)
        with annotate("model.attn_s", train):
            cls, patches = x[:, :1], x[:, 1:]
            frames = patches.reshape(n, p, t, m).transpose(1, 2).reshape(n * t, p, m)
            h = torch.cat((cls.expand(n, t, m).reshape(n * t, 1, m), frames), dim=1)
            h = drop_path(spatial.attn(spatial.norm(h), "spatial"), rate, train, generator)
            cls_h = h[:, 0].reshape(n, t, m).mean(dim=1, keepdim=True)
            patches_h = h[:, 1:].reshape(n, t, p, m).transpose(1, 2).reshape(n, p * t, m)
            x = x + torch.cat((cls_h, patches_h), dim=1)
        with annotate("model.mlp", train):
            ffn = self.ffns[0]
            fc1, fc2 = ffn.layers[0][0], ffn.layers[1]
            h = fc2(F.gelu(fc1(ffn.norm(x))))
            x = x + drop_path(h, rate, train, generator)
        return x


class _TransformerLayers(nn.Module):
    def __init__(self, layers: List[DividedSTLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _PatchEmbed(nn.Module):
    """mmaction2's ``PatchEmbed``: ``projection``, a Conv2d with a bias."""

    def __init__(self, in_channels, embed_dims, patch_size, device=None):
        super().__init__()
        self.projection = nn.Conv2d(in_channels, embed_dims, patch_size, stride=patch_size,
                                    device=device)


class TimeSformer(nn.Module):
    """The backbone; ``forward`` returns ``out`` (N, M), the last LayerNorm
    of the cls token, and the taps ``layer1``..``layer4`` (N, 1 + P T, M)."""

    def __init__(
        self,
        num_frames: int = 8,
        img_size: int = 224,
        patch_size: int = 16,
        embed_dims: int = 768,
        num_heads: int = 12,
        num_transformer_layers: int = 12,
        mlp_ratio: int = 4,
        ln_eps: float = 1e-6,
        drop_path_rate: float = 0.1,
        dtype: torch.dtype = torch.float32,
        pretrained: Optional[str] = None,  # recorded for config parity
        device=None,
    ):
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"img_size {img_size} is not a multiple of patch_size {patch_size}")
        self.num_frames, self.patch_size, self.embed_dims = num_frames, patch_size, embed_dims
        self.frames_per_clip = num_frames  # a clip backbone: the recognizer hands it clips
        self.num_patches = (img_size // patch_size) ** 2
        self.dtype = dtype
        self.patch_embed = _PatchEmbed(3, embed_dims, patch_size, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dims, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_patches + 1, embed_dims,
                                                  device=device))
        self.time_embed = nn.Parameter(torch.zeros(1, num_frames, embed_dims, device=device))
        rates = drop_path_rates(drop_path_rate, num_transformer_layers)
        self.transformer_layers = _TransformerLayers([
            DividedSTLayer(embed_dims, num_heads, mlp_ratio * embed_dims, ln_eps, num_frames,
                           r, device) for r in rates])
        self.norm = LayerNorm(embed_dims, eps=ln_eps, device=device)
        # layer index -> the taps it serves: layer k at k L / 4 (rounded down, at least 1)
        self.taps: Dict[int, List[str]] = collections.defaultdict(list)
        for k in range(1, 5):
            self.taps[max(1, k * num_transformer_layers // 4) - 1].append(f"layer{k}")

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """mmaction2's initialisation (its ``pretrained=None`` path), drawn on
        the CPU from ``generator``: ``nn.MultiheadAttention``'s (xavier-uniform
        ``in_proj_weight``, zero biases) and ``nn.Linear``'s defaults, the
        patch conv kaiming-normal (fan in, linear), ``pos_embed`` and
        ``cls_token`` truncated normal std 0.02 (cut at -2 and 2, as mmcv's
        ``trunc_normal_`` cuts, so in effect not cut), ``time_embed`` and every
        ``temporal_fc`` zero, LayerNorm (1, 0)."""

        def put(p, value):
            p.copy_(value.to(p.device))

        def linear(mod):
            w = torch.empty(mod.weight.shape)
            nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=generator)
            bound = 1.0 / math.sqrt(w.shape[1])
            put(mod.weight, w)
            put(mod.bias, torch.rand(mod.bias.shape, generator=generator) * 2 * bound - bound)

        for mod in self.modules():
            if isinstance(mod, MultiheadSelfAttention):
                w = torch.empty(mod.in_proj_weight.shape)
                nn.init.xavier_uniform_(w, generator=generator)
                put(mod.in_proj_weight, w)
                mod.in_proj_bias.zero_()
                linear(mod.out_proj)
                mod.out_proj.bias.zero_()
            elif isinstance(mod, _FFNWithNorm):
                linear(mod.layers[0][0])
                linear(mod.layers[1])
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        proj = self.patch_embed.projection
        fan_in = math.prod(proj.weight.shape[1:])
        put(proj.weight, torch.randn(proj.weight.shape, generator=generator) / math.sqrt(fan_in))
        proj.bias.zero_()
        for p in (self.pos_embed, self.cls_token):
            w = torch.empty(p.shape)
            nn.init.trunc_normal_(w, 0.0, 0.02, -2.0, 2.0, generator=generator)
            put(p, w)
        self.time_embed.zero_()
        for layer in self.transformer_layers.layers:
            layer.attentions[0].temporal_fc.weight.zero_()
            layer.attentions[0].temporal_fc.bias.zero_()

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(N, T, C, H, W) -> tokens (N, 1 + P T, M)."""
        n, t = x.shape[:2]
        dt, m = self.dtype, self.embed_dims
        proj = self.patch_embed.projection
        frames = x.reshape(n * t, *x.shape[2:]).to(dt)
        h = F.conv2d(frames, proj.weight.to(dt), proj.bias.to(dt), stride=self.patch_size)
        pos = self.pos_embed.to(dt)
        h = h.flatten(2).transpose(1, 2) + pos[:, 1:]  # (N T, P, M)
        p = h.shape[1]
        h = h.reshape(n, t, p, m).transpose(1, 2) + self.time_embed.to(dt)  # (N, P, T, M)
        cls = (self.cls_token.to(dt) + pos[:, :1]).expand(n, 1, m)
        return torch.cat((cls, h.reshape(n, p * t, m)), dim=1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """x: (N, T, C, H, W) normalized clips."""
        if x.shape[1] != self.num_frames:
            raise ValueError(f"clips of {x.shape[1]} frames; the model has {self.num_frames}")
        with annotate("model.embed", train):
            h = self.embed(x)
        feats: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.transformer_layers.layers):
            with annotate("model.block", train):
                h = layer(h, train, generator)
            for name in self.taps.get(i, ()):
                feats[name] = h
        feats["out"] = self.norm(h[:, 0])
        return feats

