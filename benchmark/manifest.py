"""Finds what belongs to a cell by name: ``BENCHMARK.json`` at the root, a
configuration in ``configs/<config>.json``, a traffic mix in
``traffic/<traffic>.json``, the cell's own settings in
``workloads/<cell>.json``, each per-layer metric's reader in
``metrics/<metric>.py`` and each model family in ``families/<family>.py``
(beside this file). A configuration file names its family under
``"family"`` (``tsm_resnet`` where it does not): what the harness knows of
one kind of model, its weights, its reference and its check
(``families/tsm_resnet.py`` lists what a family gives). A new cell,
configuration, mix or metric is new files and new entries, never an edit of
a reader, and a new family is a new file."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from types import ModuleType
from typing import Callable, Dict, List, Mapping, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_FAMILY = "tsm_resnet"
FAMILY_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def load_json(path: pathlib.Path) -> Dict:
    return json.loads(pathlib.Path(path).read_text())


def load_module(path: pathlib.Path, module_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family_name(cfg: Mapping) -> str:
    return cfg.get("family", DEFAULT_FAMILY)


class Manifest:
    def __init__(self, root: pathlib.Path = ROOT, bench_dir: Optional[pathlib.Path] = None):
        self.root = pathlib.Path(root)
        self.dir = pathlib.Path(bench_dir) if bench_dir is not None else HERE
        self.data = load_json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        return load_json(self.root / self.config_entry(name)["file"])

    def traffic(self, name: str) -> Dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def cell(self, name: str) -> Dict:
        return load_json(self.dir / "workloads" / f"{name}.json")

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict]:
        return [m for m in self.data["per_layer"] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable:
        """The ``read(obs)`` function of ``metrics/<metric>.py``."""
        module_name = "_bench_metric_" + metric.replace(".", "_").replace("-", "_")
        return load_module(self.dir / "metrics" / f"{metric}.py", module_name).read

    def family(self, name: str) -> ModuleType:
        """``families/<name>.py``; a KeyError names a family it does not hold."""
        path = self.dir / "families" / f"{name}.py"
        if not (isinstance(name, str) and FAMILY_NAME.match(name) and path.is_file()):
            raise KeyError(f"no model family {name!r} in {self.dir / 'families'}")
        return load_module(path, "_bench_family_" + name)

    def config_family(self, config: str) -> ModuleType:
        """The family of configuration ``config``, which has checked the
        configuration (a ValueError where it cannot run it)."""
        cfg = self.config(config)
        family = self.family(family_name(cfg))
        family.check_config(cfg)
        return family
