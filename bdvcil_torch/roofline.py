"""HBM-bandwidth and FLOP roofline of the TSM-ResNet-50 train step on one
H100 (the port of ``tools/roofline.py``).

A small-channel CNN at 16 clips x 8 frames moves far more activation bytes
per FLOP than a transformer, so the step's share of the card's peak FLOP/s
(``mfu``) is small by nature; the share of a bandwidth bound says more. This
module counts, conv by conv, the HBM bytes of forward + backward under two
pass models and the FLOPs, and turns each into the least time a step could
take on the card:

  * minimal  every activation written once and read once per consumer, all
             elementwise work fused into its producer;
  * xla      the pass structure of an unfused conv + BatchNorm + ReLU: the
             conv output materialized, a separate statistics pass, a
             separate normalize pass, a two-pass BatchNorm backward, dgrad
             and wgrad each reading their inputs again. The name is the JAX
             package's (XLA emits these passes); the port's eager step has
             the same structure.

FLOPs count 2 a multiply-add, forward + dgrad + wgrad (3x the forward).
Spatial dims scale with ``size / 224``. Pure arithmetic: no torch, no card.

    python -m bdvcil_torch.roofline [--batch 16] [--segments 8] [--size 224]
                                    [--measured-ms X]

prints the bounds as one JSON object; with ``--measured-ms`` (a measured
step time) also the step's share of each bound.
"""

from __future__ import annotations

import argparse
import json
import sys

# published peaks of one H100 SXM (dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BPE = 2  # bf16 bytes an element
PARAMS = 25.6e6  # ResNet-50's parameters: f32 weights and momentum, read and written
MODELS = ("minimal", "xla")


def r50_layers(size: int = 224):
    """(name, h, w, c_in, c_out, k, stride, shifted) for every conv of
    ResNet-50 at ``size``² (h, w: the conv's input dims). Bottlenecks: conv1
    1x1 (the shift applied to its input), conv2 3x3, conv3 1x1, and a 1x1
    downsample on each stage's first block."""
    if size % 32:
        raise ValueError(f"size {size} is not a multiple of 32")
    layers = [("stem", size, size, 3, 64, 7, 2, False)]
    stages = [(3, 64, 256, size // 4), (4, 128, 512, size // 8), (6, 256, 1024, size // 16),
              (3, 512, 2048, size // 32)]
    c_prev = 64  # after the max pool: (size / 4)² x 64
    for si, (blocks, mid, out, sp) in enumerate(stages):
        for b in range(blocks):
            stride = 2 if (b == 0 and si > 0) else 1
            h_in = sp * stride
            layers.append((f"s{si}b{b}c1", h_in, h_in, c_prev, mid, 1, 1, True))
            layers.append((f"s{si}b{b}c2", h_in, h_in, mid, mid, 3, stride, False))
            layers.append((f"s{si}b{b}c3", sp, sp, mid, out, 1, 1, False))
            if b == 0:
                layers.append((f"s{si}b{b}ds", h_in, h_in, c_prev, out, 1, stride, False))
            c_prev = out
    return layers


def traffic(model: str, batch: int = 16, segments: int = 8, size: int = 224):
    """(HBM bytes, FLOPs) of one train step under pass model ``model``."""
    if model not in MODELS:
        raise ValueError(f"unknown pass model {model!r}: {MODELS}")
    n = batch * segments  # frames through the 2D backbone
    total = 0.0
    flops = 0.0
    for name, h, w, c_in, c_out, k, s, shifted in r50_layers(size):
        a_in = n * h * w * c_in * BPE
        ho, wo = h // s, w // s
        a_out = n * ho * wo * c_out * BPE
        flops += 2.0 * n * ho * wo * c_out * c_in * k * k * 3  # fwd + dgrad + wgrad
        if model == "minimal":
            fwd = a_in + a_out  # normalize + relu folded into the next conv's read
            bwd = a_out + a_in + a_in + a_out  # dy, dx, wgrad's x, BN's second pass
            extra = 0.0
        else:
            fwd = a_in + a_out + a_out + 2 * a_out  # conv, statistics, normalize + relu
            # relu mask + BN sums (dy, y); dx (dy, xhat -> dx); dgrad; wgrad
            bwd = 2 * a_out + 3 * a_out + (a_out + a_in) + (a_out + a_in)
            extra = 0.0
        if shifted:  # the shift materializes a copy of the conv input, fwd + bwd
            extra += 2 * a_in if model == "minimal" else 4 * a_in
        if name.endswith("c3"):  # the residual add: one more round trip of the output
            extra += (2 if model == "minimal" else 4) * a_out
        total += fwd + bwd + extra
    total += PARAMS * 4 * 4  # the optimizer
    return total, flops


def train_flops_per_clip(segments: int = 8, size: int = 224) -> float:
    """FLOPs of one clip's forward + backward (3x its forward)."""
    return traffic("minimal", 1, segments, size)[1]


def bounds(batch: int = 16, segments: int = 8, size: int = 224) -> dict:
    """Each pass model's bytes, bandwidth-bound ms and clips/s at that bound,
    and the FLOP bound, at the H100's peaks."""
    out = {}
    for model in MODELS:
        nbytes, flops = traffic(model, batch, segments, size)
        ms = nbytes / PEAK_HBM_BYTES * 1e3
        out[model] = dict(traffic_gb=nbytes / 1e9, bw_bound_ms=ms,
                          clips_per_sec_at_bound=batch / (ms / 1e3))
    out["train_tflop_per_step"] = flops / 1e12
    out["flop_bound_ms"] = flops / PEAK_BF16_FLOPS * 1e3
    out["shape"] = dict(batch=batch, segments=segments, size=size)
    out["peaks"] = dict(bf16_flops=PEAK_BF16_FLOPS, hbm_bytes_per_sec=PEAK_HBM_BYTES,
                        card="H100 SXM, published dense")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--segments", type=int, default=8)
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--measured-ms", type=float, default=None,
                        help="a measured step time: adds its share of each bound")
    args = parser.parse_args(argv)
    out = bounds(args.batch, args.segments, args.size)
    if args.measured_ms is not None:
        out["measured_ms"] = args.measured_ms
        for model in MODELS:
            out[f"bw_fraction_vs_{model}_model"] = out[model]["bw_bound_ms"] / args.measured_ms
        out["mfu"] = out["flop_bound_ms"] / args.measured_ms
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
