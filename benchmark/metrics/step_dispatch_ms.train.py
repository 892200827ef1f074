"""step_dispatch_ms.train: milliseconds the launching thread spent in a
call of the train step (it returns once the step's work is enqueued), the
mean over the window's steps, on the host clock. Layer: the train step
(``runtime/steps.py``, ``models/``, ``optim.py``)."""


def read(obs):
    spans = obs["window"]["dispatch_s"]
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
