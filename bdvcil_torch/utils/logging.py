"""Scalar metric logging to stdout and a JSONL file (the port of
``bdvcil_tpu/utils/logging.py``, without its optional wandb mirror).

``get_logger`` gives the package's stdout loggers; ``MetricLogger`` appends
one JSON record per call to ``<work_dir>/metrics.jsonl``.
"""

from __future__ import annotations

import json
import logging
import pathlib
import sys
import time
from typing import Any, Dict, Optional

_LOGGERS: Dict[str, logging.Logger] = {}


def get_logger(name: str = "bdvcil") -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("[%(asctime)s] %(name)s %(levelname)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    _LOGGERS[name] = logger
    return logger


class MetricLogger:
    """Appends ``{'step', 'time', **metrics}`` lines to ``work_dir/metrics.jsonl``;
    a logger without a ``work_dir`` keeps nothing."""

    def __init__(self, work_dir: Optional[str] = None):
        self.work_dir = pathlib.Path(work_dir) if work_dir else None
        self._fh = None
        if self.work_dir is not None:
            self.work_dir.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.work_dir / "metrics.jsonl", "a")
        self._step = 0

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        step = self._step if step is None else step
        self._step = step + 1
        if self._fh is not None:
            record = {"step": step, "time": time.time(), **metrics}
            self._fh.write(json.dumps(record, default=float) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
