"""The yardstick's arithmetic of the TimeSformer attentions: operations and
bytes of one train step's attention through the fused kernel, at the H100's
published peaks (``flops.least_seconds``).

One attention call of S sequences, H heads, L tokens and head size d:

  * operations: q k^T and the probabilities times v, 2 S H L² d each
    forward (2 a multiply-add); the backward twice the forward's, no
    recompute counted: 3 x 4 S H L² d;
  * bytes: q, k, v and o once each way (read and written once forward, their
    gradients once backward) in bf16: 2 x 4 x S H L d x 2.

The spatial attention of a layer is S = clips x T sequences of L = 1 + P
tokens, the temporal one S = clips x P sequences of L = T. The least time of
a step is the sum over its calls of each call's least time. Pure
arithmetic: no torch, no card.
"""

from __future__ import annotations

from typing import Mapping

from benchmark import flops


def call_flops_bytes(sequences: int, heads: int, length: int, head_dim: int):
    """(operations, bytes) of one attention call's forward and backward."""
    flops_ = 3.0 * 4.0 * sequences * heads * length * length * head_dim
    nbytes = 2.0 * 4.0 * sequences * heads * length * head_dim * flops.BF16_BYTES
    return flops_, nbytes


def step_least_seconds(cfg: Mapping, clips: int, temporal: bool) -> float:
    """The least time of one train step's attention calls through the fused
    kernel: every layer's spatial attention, and its temporal one where
    ``temporal``. cfg: the configuration's sizes."""
    heads, t = cfg["num_heads"], cfg["num_segments"]
    p = (cfg["crop_size"] // cfg["patch_size"]) ** 2
    d = cfg["embed_dims"] // heads
    calls = [(clips * t, 1 + p)] + ([(clips * p, t)] if temporal else [])
    per_layer = 0.0
    for sequences, length in calls:
        f, b = call_flops_bytes(sequences, heads, length, d)
        per_layer += flops.least_seconds(b, f)
    return cfg["num_layers"] * per_layer
