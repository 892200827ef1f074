"""train_mfu: the whole step's share of the card's bf16 peak, in percent:
clips a second in the window before the traced slice (the part the
profiler does not slow), times the convs' train FLOPs of a clip (forward +
dgrad + wgrad, 2 a multiply-add; ``flops.train_flops_per_clip``), over
989 TFLOP/s (H100 SXM, dense)."""

from benchmark import flops


def read(obs):
    if obs["device"] != "cuda":
        return None
    part = obs["window"]["untraced"]
    seconds, clips = part["seconds"], part["clips"]
    if seconds <= 0 or clips <= 0:
        return None
    return clips / seconds * obs["flops_per_clip"] / flops.PEAK_BF16_FLOPS * 100.0
