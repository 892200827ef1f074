"""Shared set-up for the tests that hold bdvcil_torch against bdvcil_tpu.

Inputs and weights are made with numpy and handed to both sides; the JAX
package's variables go to the port through ``models/convert.py``.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from bdvcil_torch.models.convert import from_jax_variables

T = 2
BLOCK_PREFIX = "backbone.layer1.0."

# (JAX backbone switches, port backbone switches) for configurations A and B
CONFIGS = {
    "A": (dict(shift_mode="pad", conv1x1_mode="pallas_stats_interpret"),
          dict(shift_mode="pad", conv1x1_mode="pallas_stats")),
    "B": (dict(shift_mode="fused_block", conv1x1_mode="xla"),
          dict(shift_mode="fused_block", conv1x1_mode="xla")),
}


def numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), dict(tree))


def randomize_bn(variables, seed: int):
    """Non-trivial BN affine and running statistics, so eval-mode BN is pinned."""
    rng = np.random.default_rng(seed)
    out = numpy_tree(variables)

    def walk(params, stats):
        for k, v in params.items():
            if isinstance(v, dict):
                walk(v, stats.get(k, {}) if stats is not None else None)
            elif k == "scale":
                params[k] = (rng.random(v.shape) + 0.5).astype(np.float32)
            elif k == "bias" and stats:
                params[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        if stats and "mean" in stats:
            stats["mean"] = (rng.standard_normal(stats["mean"].shape) * 0.5).astype(np.float32)
            stats["var"] = (rng.random(stats["var"].shape) + 0.5).astype(np.float32)

    walk(out["params"], out.get("batch_stats", {}))
    return out


def block_state_dict(block_vars):
    """A JAX block's {'params', 'batch_stats'} -> the port block's state_dict."""
    wrapped = {c: {"backbone": {"layer1_0": v}} for c, v in block_vars.items()}
    return {k[len(BLOCK_PREFIX):]: v for k, v in from_jax_variables(wrapped).items()}


def model_cfg(depth: int, shift_mode: str, conv1x1_mode: str, num_classes: int,
              classifier: str = "LocalSimilarityClassifier", in_channels: int = 2048):
    loss = dict(type="LSCLoss") if classifier == "LocalSimilarityClassifier" else dict(
        type="CrossEntropyLoss")
    return dict(
        type="CILRecognizer2D",
        backbone=dict(type="ResNetTSM", depth=depth, num_segments=T, shift_div=8,
                      shift_mode=shift_mode, conv1x1_mode=conv1x1_mode),
        cls_head=dict(
            type="IncrementalTSMHead", num_classes=num_classes, in_channels=in_channels,
            inc_head_config=dict(type=classifier, out_features=num_classes, nb_proxies=1),
            num_segments=T, loss_cls=loss, dropout_ratio=0.0,
        ),
        test_cfg=dict(average_clips="prob"),
    )


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))
