"""device_idle_share.train: the percent of the traced slice in which no
kernel ran on the card: one minus the union of the kernels' intervals
(``tracing.busy_us``) over the slice's seconds. Layer: the device."""


def read(obs):
    s = obs["slice"]
    if obs["device"] != "cuda" or s is None or not s["kernels"] or s["seconds"] <= 0:
        return None
    return (1.0 - s["busy_s"] / s["seconds"]) * 100.0
