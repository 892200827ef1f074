"""Type-string registries (the port's copy of ``bdvcil_tpu/registry.py``).

Replaces the capability of mmcv/mmaction registries (``DATASETS``,
``PIPELINES``, ``RECOGNIZERS``, ``HEADS``, ``LOSSES`` — reference usage e.g.
libs/loader/comix_loader.py:16, libs/pipelines/rand_augment.py:221) with a
plain factory map: configs stay dicts with a ``type`` key, and
``registry.build(cfg)`` instantiates the registered class with the remaining
keys as kwargs.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Mapping, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._map: Dict[str, Callable] = {}

    def register_module(self, name: Optional[str] = None, cls: Optional[Callable] = None):
        """Use as decorator ``@REG.register_module()`` or direct call."""

        def _register(obj: Callable) -> Callable:
            key = name or obj.__name__
            if key in self._map and self._map[key] is not obj:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._map[key] = obj
            return obj

        if cls is not None:
            return _register(cls)
        return _register

    def get(self, key: str) -> Callable:
        try:
            return self._map[key]
        except KeyError:
            known = ", ".join(sorted(self._map))
            raise KeyError(f"{key!r} not found in registry {self.name!r} (known: {known})") from None

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def keys(self):
        return self._map.keys()

    def build(self, cfg: Mapping[str, Any], **extra_kwargs) -> Any:
        """Instantiate ``cfg['type']`` with remaining keys as kwargs."""
        if "type" not in cfg:
            raise KeyError(f"config for registry {self.name!r} needs a 'type' key: {cfg}")
        cfg = dict(cfg)
        obj_type = cfg.pop("type")
        cls = self.get(obj_type)
        kwargs = {**cfg, **extra_kwargs}
        try:
            return cls(**kwargs)
        except TypeError as e:
            sig = None
            try:
                sig = str(inspect.signature(cls))
            except (TypeError, ValueError):
                pass
            raise TypeError(f"building {obj_type}{sig or ''} from {self.name}: {e}") from e


# global registries mirroring the reference's capability surface
DATASETS = Registry("datasets")
PIPELINES = Registry("pipelines")
RECOGNIZERS = Registry("recognizers")
BACKBONES = Registry("backbones")
HEADS = Registry("heads")
LOSSES = Registry("losses")
