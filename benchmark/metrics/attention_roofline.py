"""attention_roofline: the share, in percent, of the least time of the
TimeSformer's attention through torch's fused kernel (every layer's spatial
attention, and its temporal one when the program sent it there too, as its
launch counter ``_build.LAUNCHES`` says under ``attention.temporal.flash``:
q k^T and the probabilities times v forward and twice that backward, q, k,
v and o once each way in bf16; ``attention.step_least_seconds``) in the
device time of the kernels that
path launches (``KERNELS``: flash attention's forward, its backward and the
backward's pre- and post-processing), over the traced slice. Layer: the
attention (``models/timesformer.py``, torch's scaled_dot_product_attention)."""

from benchmark import attention

KERNELS = ("flash_fwd", "flash_bwd")


def _temporal_in_flash() -> bool:
    try:
        from bdvcil_torch.ops._build import LAUNCHES
    except ImportError:
        return False
    return LAUNCHES.get("attention.temporal.flash", 0) > 0


def read(obs):
    s, cfg = obs["slice"], obs["config"]
    if obs["device"] != "cuda" or s is None or not s["steps"] or "embed_dims" not in cfg:
        return None
    device_s = sum(e - b for name, b, e in s["kernels"] if any(k in name for k in KERNELS)) / 1e6
    clips = obs["frames_per_step"] // cfg["num_segments"]
    least = s["steps"] * attention.step_least_seconds(cfg, clips, _temporal_in_flash())
    if device_s <= 0 or least <= 0:
        return None
    return least / device_s * 100.0
