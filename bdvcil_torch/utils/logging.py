"""Scalar metric logging to stdout, a JSONL file and optionally wandb (the
port of ``bdvcil_tpu/utils/logging.py``).

``get_logger`` gives the package's stdout loggers; ``MetricLogger`` appends
one JSON record per call to ``<work_dir>/metrics.jsonl`` and, with
``use_wandb`` and ``WANDB_API_KEY`` set, mirrors the scalars to wandb (the
reference's ``WandbLogger(project='CILVideo')``), when it imports and starts.
"""

from __future__ import annotations

import json
import logging
import os
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
    """Appends ``{'step', 'time', **metrics}`` lines to ``work_dir/metrics.jsonl``
    and mirrors the metrics to a wandb run when ``use_wandb`` is set and so is
    ``WANDB_API_KEY``; a wandb that fails to import or start leaves the mirror
    off. A logger without a ``work_dir`` writes no file."""

    def __init__(self, work_dir: Optional[str] = None, project: str = "CILVideo",
                 use_wandb: bool = False):
        self.work_dir = pathlib.Path(work_dir) if work_dir else None
        self._fh = None
        if self.work_dir is not None:
            self.work_dir.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.work_dir / "metrics.jsonl", "a")
        self._wandb = None
        if use_wandb and os.environ.get("WANDB_API_KEY"):
            try:
                import wandb  # optional, imported only when asked for

                self._wandb = wandb.init(project=project, dir=str(self.work_dir or "."))
            except Exception:  # noqa: BLE001 -- the mirror is best effort, as in the reference
                get_logger().warning("wandb mirror off: wandb did not start", exc_info=True)
                self._wandb = None
        self._step = 0

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        step = self._step if step is None else step
        self._step = step + 1
        if self._fh is not None:
            record = {"step": step, "time": time.time(), **metrics}
            self._fh.write(json.dumps(record, default=float) + "\n")
            self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
