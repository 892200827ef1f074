"""conv1x1_stats_roofline: the share, in percent, of the least time of the
train-mode 1x1 convs with BatchNorm statistics (each bottleneck's conv1
and conv3 as one GEMM: x and w read once, y written once in bf16, the two
f32 sums; ``flops.stats_gemm_least_seconds``) in the device time of the
launches that compute them, over the traced slice. Layer: the kernels
(``ops/conv1x1_bn.py``, ``csrc/conv1x1_stats.cu``, ``gemm_stats_sm90.cuh``)."""

from benchmark import flops

KERNELS = ("wgmma_stats_kernel", "partials_finish_kernel")


def read(obs):
    s, cfg = obs["slice"], obs["config"]
    if obs["device"] != "cuda" or s is None or not s["steps"]:
        return None
    device_s = sum(e - b for name, b, e in s["kernels"] if any(k in name for k in KERNELS)) / 1e6
    least = s["steps"] * flops.stats_gemm_least_seconds(cfg["depth"], obs["frames_per_step"],
                                                        cfg["crop_size"])
    if device_s <= 0 or least <= 0:
        return None
    return least / device_s * 100.0
