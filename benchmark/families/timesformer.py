"""The TimeSformer family: divided space-time attention (arXiv:2102.05095,
mmaction2's ``TimeSformer``) with the LSC head, the port's ``TimeSformer``
backbone under ``IncrementalTSMHead`` (one 768-wide cls feature a clip,
``num_segments`` 1). What a family gives is listed in ``tsm_resnet.py``.

This family's numbers:

  * ``loss_gap``, as ``compare`` builds it;
  * ``grad_gap`` / ``change_gap``: ``compare.norm_gap``'s worst leaf of every
    leaf (LayerNorm, the three embeddings, the biases, the patch conv and
    eta among them), except that eta's gap is taken over the larger of its
    norm, the median leaf's and its ``scale`` from the reference: eta's
    first gradient and change are sums over the clips of terms of either
    sign, and where they cancel (at random weights they may, to under
    twice the median leaf's) the program's bfloat16 rounding of each term
    reads several hundredths of the sum, as the reference computed with
    bfloat16 products does. The scale is the sum of the terms' magnitudes
    (``reference/timesformer.py``), the size that the rounding of each term
    is a share of;
  * ``grad_gap_matrix_median`` / ``change_gap_matrix_median``: the median
    over the 2-D weight leaves (qkv, the output projections, ``temporal_fc``,
    the MLP's two linears, the LSC proxies; for the change, those the
    reference moves) of | |x| - |x_ref| | / |x_ref|.

The cell compares both kinds: the medians hold the matrices tight, the
worst leaf holds every other leaf, whose gradient and update go through the
labels and ``decay`` of ``optim.py``.

The first forward has no batch statistics to read: ``first_forward_readings``
is empty.
"""

from __future__ import annotations

import math
import pathlib
import statistics
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from benchmark import compare, manifest
from benchmark.reference import timesformer as ref

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_gap_matrix_median",
           "change_gap_matrix_median")
# the program's backbone, looked for as a file: a family imports nothing of the program
PROGRAM_MODULE = pathlib.Path("bdvcil_torch", "models", "timesformer.py")
MATRIX_LEAVES = ("attn.in_proj_weight", "attn.out_proj.weight", "temporal_fc.weight",
                 "layers.0.0.weight", "layers.1.weight", "cls_head.fc_weights")


def check_config(cfg: Mapping) -> None:
    """Refuses sizes that do not fit together, and a checkout whose program
    has no TimeSformer (so that such a run cannot start)."""
    if not (manifest.ROOT / PROGRAM_MODULE).is_file():
        raise ValueError(f"the program has no TimeSformer backbone: no {PROGRAM_MODULE}")
    m, heads, ps = cfg["embed_dims"], cfg["num_heads"], cfg["patch_size"]
    if m % heads:
        raise ValueError(f"embed_dims {m} is not a multiple of num_heads {heads}")
    if cfg["crop_size"] % ps:
        raise ValueError(f"crop_size {cfg['crop_size']} is not a multiple of patch_size {ps}")
    if cfg["in_channels"] != m:
        raise ValueError(f"the head's in_channels {cfg['in_channels']} is not embed_dims {m}")
    if cfg["num_layers"] < 1 or cfg["num_segments"] < 1:
        raise ValueError("TimeSformer needs a layer and a frame")


def model_config(cfg: Mapping, model: Dict) -> None:
    model["backbone"] = dict(
        type="TimeSformer", num_frames=cfg["num_segments"], img_size=cfg["crop_size"],
        patch_size=cfg["patch_size"], embed_dims=cfg["embed_dims"], num_heads=cfg["num_heads"],
        num_transformer_layers=cfg["num_layers"], mlp_ratio=cfg["mlp_ratio"],
        attention_type="divided_space_time", norm_cfg=dict(type="LN", eps=cfg["ln_eps"]),
        drop_path_rate=cfg["drop_path_rate"], pretrained=None)
    head = model["cls_head"]
    head.update(in_channels=cfg["in_channels"], num_segments=1,
                dropout_ratio=cfg["dropout_ratio"])
    head["inc_head_config"]["nb_proxies"] = cfg["nb_proxies"]


def reference_config(cfg: Mapping) -> Dict:
    return dict(embed_dims=cfg["embed_dims"], num_layers=cfg["num_layers"],
                num_heads=cfg["num_heads"], mlp_ratio=cfg["mlp_ratio"],
                patch_size=cfg["patch_size"], crop_size=cfg["crop_size"],
                num_segments=cfg["num_segments"], ln_eps=cfg["ln_eps"],
                drop_path_rate=cfg["drop_path_rate"], dropout=cfg["dropout_ratio"],
                alpha=cfg["bgmix_alpha"], margin=cfg["lsc_margin"], lr=cfg["lr"],
                momentum=cfg["momentum"], weight_decay=cfg["weight_decay"],
                fc_scale=cfg["fc_lr_scale_factor"], accumulate=cfg["accumulate_grad_batches"])


def param_shapes(cfg: Mapping, num_classes: int) -> Dict[str, Tuple]:
    return ref.param_shapes(cfg, num_classes, cfg["nb_proxies"])


def _drawn(name: str, shape: Tuple) -> Optional[float]:
    """A drawn leaf's scale: 1 / sqrt(fan_in) for a linear's or the patch
    conv's weight and the proxies, 0.02 for the embeddings; None for the
    rest (LayerNorm (1, 0), biases 0, eta 1)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ref.EMBEDS:
        return 0.02
    if leaf in ("weight", "in_proj_weight", "fc_weights") and ".norm." not in name:
        return 1.0 / math.sqrt(math.prod(shape[1:]))
    return None


def make_weights(cfg: Mapping, num_classes: int, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """The model's float32 weights from the seed, on ``device``, in one draw:
    every linear's and the patch conv's weight and the proxies N(0, 1 /
    fan_in) (``temporal_fc`` drawn too, not zero as mmaction2 starts it, so
    that the temporal branch has a gradient in the first step), the cls
    token and the two position embeddings N(0, 0.02²), LayerNorm (1, 0),
    every bias 0, the LSC temperature 1."""
    shapes = param_shapes(cfg, num_classes)
    drawn = [n for n, s in shapes.items() if _drawn(n, s) is not None]
    sizes = [math.prod(shapes[n]) for n in drawn]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, offset = {}, 0
    for name, size in zip(drawn, sizes):
        out[name] = flat[offset:offset + size].view(shapes[name]) * _drawn(name, shapes[name])
        offset += size
    for name, shape in shapes.items():
        if name.endswith("eta") or (name not in out and name.endswith("norm.weight")):
            out[name] = torch.ones(shape, device=device)
        elif name not in out:
            out[name] = torch.zeros(shape, device=device)
    return out


def reset_buffers(module: torch.nn.Module) -> None:
    """The model has no buffers."""


def decay(name: str, ref_cfg: Mapping) -> float:
    """The reference's decay groups (``reference/timesformer.py``), which
    are the program's labels (``optim.label_params``)."""
    return ref.lr_and_decay(name, 0.0, ref_cfg["weight_decay"], 1.0)[1]


def first_forward_readings(module: torch.nn.Module, ref_cfg: Mapping) -> Dict:
    return {}


def train_flops_per_clip(cfg: Mapping) -> float:
    """FLOPs of one clip's forward + backward (3x the forward, 2 a
    multiply-add): the patch embedding, and at every layer the two qkv
    projections, the two output projections, ``temporal_fc``, the MLP and
    both attentions' q k^T and probabilities times v. At the published
    widths (768, 12 layers, 8 x 224²) 1.175 TFLOP."""
    m, t = cfg["embed_dims"], cfg["num_segments"]
    p = (cfg["crop_size"] // cfg["patch_size"]) ** 2
    d = m // cfg["num_heads"]
    heads = cfg["num_heads"]
    hidden = cfg["mlp_ratio"] * m
    patch = p * t * 3 * cfg["patch_size"] ** 2 * m
    temporal = p * t * (3 * m * m + m * m + m * m) + p * heads * 2 * t * t * d
    spatial = (p + 1) * t * (3 * m * m + m * m) + t * heads * 2 * (p + 1) ** 2 * d
    mlp = (1 + p * t) * 2 * m * hidden
    macs = patch + cfg["num_layers"] * (temporal + spatial + mlp)
    return 2.0 * 3.0 * macs


def reference_train_steps(w0: Mapping[str, torch.Tensor], batches: Sequence[Dict],
                          seeds: Sequence[int], ref_cfg: Mapping, precision: Optional[str],
                          rows: Optional[slice]) -> Dict:
    out = ref.train_steps(w0, batches, seeds, ref_cfg, precision=precision, rows=rows)
    return dict(losses=out["losses"], first_grad=out["first_grad"], params=out["params"],
                scales=out["scales"])


def matrix_leaves(names: Sequence[str]) -> list:
    return [k for k in names if k.endswith(MATRIX_LEAVES)]


def worst_gap(norms: Mapping[str, float], ref_norms: Mapping[str, float],
              keep: Sequence[str], scales: Mapping[str, float]) -> float:
    """``compare.norm_gap``, a leaf in ``scales`` taken over its scale too:
    max over ``keep`` of | |x| - |x_ref| | / max(|x_ref|, median |x_ref|, scale)."""
    if set(norms) != set(ref_norms):
        return math.inf
    median = statistics.median(ref_norms[k] for k in keep)
    worst = 0.0
    for k in keep:
        if not math.isfinite(norms[k]):
            return math.inf
        worst = max(worst, abs(norms[k] - ref_norms[k])
                    / max(ref_norms[k], median, scales.get(k, 0.0), 1e-30))
    return worst


def numbers(program: Mapping, reference: Mapping) -> Dict[str, float]:
    """program / reference: {'losses', 'grad_norms', 'change_norms'}; the
    reference also {'scales'}."""
    keep = compare.moved_leaves(reference["grad_norms"])
    every = list(reference["grad_norms"])
    matrices = matrix_leaves(every)
    scales = reference["scales"]
    return {
        "loss_gap": compare.loss_gap(program["losses"], reference["losses"]),
        "grad_gap": worst_gap(program["grad_norms"], reference["grad_norms"], every,
                              scales["grad"]),
        "change_gap": worst_gap(program["change_norms"], reference["change_norms"], keep,
                                scales["change"]),
        "grad_gap_matrix_median": compare.median_gap(program["grad_norms"],
                                                     reference["grad_norms"], matrices),
        "change_gap_matrix_median": compare.median_gap(program["change_norms"],
                                                       reference["change_norms"],
                                                       [k for k in matrices if k in keep]),
    }
