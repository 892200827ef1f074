"""fused_shift_roofline: the share, in percent, of the least time of the
fused residual + ReLU + temporal shift forward (#1) and its backward (#2)
at every block (four bf16 tensors of the block output's size each;
``flops.fused_shift_least_seconds``) in the device time of the launches
that compute them, over the traced slice. Layer: the kernels
(``ops/tsm_shift.py``, ``csrc/tsm_shift.cu``)."""

from benchmark import flops

KERNELS = ("fused_fwd_kernel", "fused_bwd_kernel")


def read(obs):
    s, cfg = obs["slice"], obs["config"]
    if obs["device"] != "cuda" or s is None or not s["steps"]:
        return None
    device_s = sum(e - b for name, b, e in s["kernels"] if any(k in name for k in KERNELS)) / 1e6
    least = s["steps"] * flops.fused_shift_least_seconds(cfg["depth"], obs["frames_per_step"],
                                                         cfg["crop_size"])
    if device_s <= 0 or least <= 0:
        return None
    return least / device_s * 100.0
