"""step_input_fn_ms.train: milliseconds a step of the traced slice spent in
the program's span ``step.input_fn`` (``runtime/steps.py``: the device
input function, ``data/device_pipeline.py``, ``ops/augment.py``,
``ops/rand_augment_dev.py``), host-clock wall time summed over the slice
over its steps. The spans are ``bdvcil_torch.utils.profiling``'s; the
program records them only while the slice's profiler runs, so the last
run's records are the slice's. Layer: the device input function."""

SPAN = "step.input_fn"


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
