"""input_wait_ms.train: milliseconds a train step of the window waited for
its batch in ``train_epochs``'s prefetch queue (the meter's ``wait_s``
over the window's steps). Layer: the train loop (``runtime/loops.py``)."""


def read(obs):
    w = obs["window"]
    if not w["steps"]:
        return None
    return w["wait_s"] / w["steps"] * 1e3
