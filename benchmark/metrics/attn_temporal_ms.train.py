"""attn_temporal_ms.train: milliseconds a step of the traced slice spent in
the program's span ``model.attn_t`` (``models/timesformer.py``: the temporal attention: LayerNorm, attention over the frames of each patch, drop path, ``temporal_fc`` and the residual), host-clock wall time of
its launches summed over the slice's layers and steps over its steps, from
``bdvcil_torch.utils.profiling.spans()``. Layer: the attention
(``models/timesformer.py``, torch's scaled_dot_product_attention)."""

SPAN = "model.attn_t"


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
