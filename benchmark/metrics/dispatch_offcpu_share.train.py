"""dispatch_offcpu_share.train: the percent of the launching thread's wall
time inside the program's spans ``step.input_fn``, ``step.forward`` and
``step.optimizer`` in which that thread was not on a CPU: one minus their
summed ``cpu_s`` (the thread's CPU seconds, ``time.thread_time``) over their
summed wall time, over the traced slice, from
``bdvcil_torch.utils.profiling.spans()``. These spans launch their kernels
from the calling thread (``step.backward``'s run on autograd's thread and are
left out), so the share is the time the thread waited off a CPU: for the
GIL (the loader's workers, the prefetch thread), in a call that sleeps, or
preempted. Layer: the launching thread."""

SPANS = ("step.input_fn", "step.forward", "step.optimizer")


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
    records = [r for r in _spans(obs) if r.name in SPANS]
    wall = sum(r.end - r.start for r in records)
    if wall <= 0:
        return None
    return (1.0 - sum(r.cpu_s for r in records) / wall) * 100.0
