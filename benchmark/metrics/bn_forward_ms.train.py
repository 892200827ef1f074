"""bn_forward_ms.train: milliseconds a step of the traced slice spent in the
program's spans ``model.bn``: every train-mode BatchNorm
(``models/norm.py``) and the normalize half of ``ops/conv1x1_bn.py``'s
``conv1x1_bn``, host-clock wall time summed over the slice over its steps,
from ``bdvcil_torch.utils.profiling.spans()``. Layer: BatchNorm."""

SPAN = "model.bn"


def _spans(obs):
    """The slice's records of the program's spans: none off the card, for a
    slice of no steps, or from a program that records no spans."""
    s = obs["slice"]
    if obs["device"] != "cuda" or s is None or not s["steps"]:
        return []
    try:
        from bdvcil_torch.utils.profiling import spans
    except ImportError:
        return []
    return spans()


def read(obs):
    walls = [r.end - r.start for r in _spans(obs) if r.name == SPAN]
    if not walls:
        return None
    return sum(walls) / obs["slice"]["steps"] * 1e3
