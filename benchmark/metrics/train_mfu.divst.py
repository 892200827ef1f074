"""train_mfu.divst: the TimeSformer cell's whole step as a share of the
card's bf16 peak, in percent: clips a second in the window before the
traced slice (the part the profiler does not slow), times the model's
train FLOPs of a clip (the family's ``train_flops_per_clip``: the patch
embedding, the projections, the MLP and both attentions, forward + 2x for
the backward, 2 a multiply-add; 1.175 TFLOP at ViT-B/16, 8 x 224²), over
989 TFLOP/s (H100 SXM, dense). Layer: the whole step."""

from benchmark import flops


def read(obs):
    if obs["device"] != "cuda":
        return None
    part = obs["window"]["untraced"]
    seconds, clips = part["seconds"], part["clips"]
    if seconds <= 0 or clips <= 0:
        return None
    return clips / seconds * obs["flops_per_clip"] / flops.PEAK_BF16_FLOPS * 100.0
