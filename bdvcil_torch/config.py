"""Python-file experiment configs (the port's copy of ``bdvcil_tpu/config.py``).

Reimplements the capability surface of mmcv ``Config`` that the reference
relies on (reference: cil_tools/train_cil.py:54-61, libs/cil/cil.py:700-701,
configs/cil/tsm/tsm_r34_1x1x8_25e_ucf101_lsc.py:1-3):

  * ``Config.fromfile`` — execute a python config file, collect top-level vars
  * ``_base_`` inheritance — recursive dict merge of base config files
  * ``merge_from_dict`` — dotted-key CLI overrides
  * ``dump`` — re-emit the resolved config as a python file
  * attribute-style access on nested dicts

This is a clean-room implementation: plain dict + thin attribute wrapper,
no mmcv dependency.
"""

from __future__ import annotations

import copy
import os
import os.path as osp
import pprint
import types
from typing import Any, Dict, Iterator, Mapping

_DELETE_KEY = "_delete_"
_BASE_KEY = "_base_"

_RESERVED = {"__builtins__", "__name__", "__file__", "__doc__", "__package__"}


class ConfigDict(dict):
    """A dict with attribute access, applied recursively on read."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError:
            raise AttributeError(
                f"'{type(self).__name__}' object has no attribute {name!r}"
            ) from None
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __deepcopy__(self, memo):
        out = ConfigDict()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out

    def copy(self) -> "ConfigDict":  # shallow, like dict.copy
        return ConfigDict(self)


def _wrap(value: Any) -> Any:
    """Recursively convert plain dicts to ConfigDict (lists/tuples too)."""
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, dict):
        return ConfigDict({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_wrap(v) for v in value)
    return value


def _merge_dict(base: Dict, override: Mapping) -> Dict:
    """Recursively merge ``override`` into ``base`` (override wins).

    A nested dict carrying ``_delete_: True`` replaces the base value wholesale
    instead of merging into it.
    """
    for key, value in override.items():
        if (
            isinstance(value, Mapping)
            and key in base
            and isinstance(base[key], dict)
            and not value.get(_DELETE_KEY, False)
        ):
            _merge_dict(base[key], value)
        else:
            if isinstance(value, Mapping):
                value = {k: v for k, v in value.items() if k != _DELETE_KEY}
            base[key] = copy.deepcopy(value)
    return base


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(filename)
    with open(filename, "r") as f:
        source = f.read()
    code = compile(source, filename, "exec")
    namespace: Dict[str, Any] = {"__file__": filename}
    exec(code, namespace)
    cfg = {
        k: v
        for k, v in namespace.items()
        if k not in _RESERVED
        and not k.startswith("__")
        and not isinstance(v, (types.ModuleType, types.FunctionType, type))
    }
    return cfg


def _load_with_bases(filename: str) -> Dict[str, Any]:
    cfg = _exec_pyfile(filename)
    bases = cfg.pop(_BASE_KEY, None)
    if bases is None:
        return cfg
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    cfg_dir = osp.dirname(osp.abspath(osp.expanduser(filename)))
    for base_rel in bases:
        base_cfg = _load_with_bases(osp.join(cfg_dir, base_rel))
        _merge_dict(merged, base_cfg)
    _merge_dict(merged, cfg)
    return merged


class Config:
    """Resolved experiment configuration with attribute access and dump."""

    def __init__(self, cfg_dict: Mapping | None = None, filename: str | None = None):
        object.__setattr__(self, "_cfg", _wrap(dict(cfg_dict or {})))
        object.__setattr__(self, "_filename", filename)

    # -- construction -----------------------------------------------------
    @staticmethod
    def fromfile(filename: str) -> "Config":
        return Config(_load_with_bases(filename), filename=filename)

    @staticmethod
    def fromdict(d: Mapping) -> "Config":
        return Config(d)

    # -- accessors --------------------------------------------------------
    @property
    def filename(self) -> str | None:
        return self._filename

    def __getattr__(self, name: str) -> Any:
        try:
            return self._cfg[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg[name] = _wrap(value)

    def __getitem__(self, name: str) -> Any:
        return self._cfg[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._cfg[name] = _wrap(value)

    def __contains__(self, name: str) -> bool:
        return name in self._cfg

    def __iter__(self) -> Iterator[str]:
        return iter(self._cfg)

    def get(self, name: str, default: Any = None) -> Any:
        return self._cfg.get(name, default)

    def keys(self):
        return self._cfg.keys()

    def items(self):
        return self._cfg.items()

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(dict(self._cfg))

    def __deepcopy__(self, memo):
        return Config(copy.deepcopy(dict(self._cfg), memo), filename=self._filename)

    def __repr__(self) -> str:
        return f"Config(filename={self._filename!r}):\n{pprint.pformat(dict(self._cfg))}"

    # -- mutation ---------------------------------------------------------
    def merge_from_dict(self, options: Mapping[str, Any]) -> None:
        """Merge dotted-key overrides, e.g. ``{'data.train.alpha': 0.3}``.

        Mirrors mmcv semantics used at cil_tools/train_cil.py:56.
        """
        nested: Dict[str, Any] = {}
        for full_key, value in options.items():
            d = nested
            parts = full_key.split(".")
            for part in parts[:-1]:
                d = d.setdefault(part, {})
            d[parts[-1]] = value
        _merge_dict(self._cfg, nested)
        object.__setattr__(self, "_cfg", _wrap(self._cfg))

    # -- serialization ----------------------------------------------------
    def dump(self, filename: str) -> None:
        """Write the resolved config back out as an executable python file.

        Mirrors ``config.dump`` at libs/cil/cil.py:700-701 so that a work_dir
        always carries the exact configuration that produced it.
        """
        os.makedirs(osp.dirname(osp.abspath(filename)) or ".", exist_ok=True)
        lines = []
        for key, value in self._cfg.items():
            lines.append(f"{key} = {_pyrepr(value)}")
        with open(filename, "w") as f:
            f.write("\n".join(lines) + "\n")


def _pyrepr(value: Any, indent: int = 0) -> str:
    """repr that round-trips ConfigDict as plain dict literals."""
    if isinstance(value, dict):
        inner = ", ".join(f"{k!r}: {_pyrepr(v)}" for k, v in value.items())
        return "{" + inner + "}"
    if isinstance(value, list):
        return "[" + ", ".join(_pyrepr(v) for v in value) + "]"
    if isinstance(value, tuple):
        inner = ", ".join(_pyrepr(v) for v in value)
        if len(value) == 1:
            inner += ","
        return "(" + inner + ")"
    return repr(value)
