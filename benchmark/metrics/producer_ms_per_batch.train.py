"""producer_ms_per_batch.train: milliseconds of the loader's producer
work a batch made in the window (``PRODUCER_STATS``: planning, header
probes and decode, summed over the workers, traced runs only). Layer: the
loader's host half (``data/loaders.py``, ``data/native.py``)."""

PHASES = ("pass1", "probe", "pass2", "decode")


def read(obs):
    s0, s1 = obs["window"]["stats0"], obs["window"]["stats1"]
    batches = s1.get("batches", 0.0) - s0.get("batches", 0.0)
    if batches <= 0:
        return None
    seconds = sum(s1.get(k, 0.0) - s0.get(k, 0.0) for k in PHASES)
    return seconds / batches * 1e3
