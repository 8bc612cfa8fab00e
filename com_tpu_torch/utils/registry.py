"""Name → class registries (the port's copy of ``com_tpu/utils/registry.py``).

The reference looks components up by NAME in per-module ``__all__`` dicts
(pcdet/datasets/__init__.py:16-24, pcdet/models/detectors/__init__.py:15-29).
We centralize that pattern in a tiny Registry class so every subsystem
(datasets, detectors, VFEs, backbones, dense and RoI heads) registers
itself with a decorator.
"""
from __future__ import annotations


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: dict[str, object] = {}

    def register(self, obj=None, *, name: str | None = None):
        def deco(o):
            key = name or o.__name__
            if key in self._entries:
                raise KeyError(f"{key} already registered in {self.name}")
            self._entries[key] = o
            return o

        if obj is None:
            return deco
        return deco(obj)

    def register_unported(self, key: str, what: str):
        """A name of the JAX package's registry that this port has not
        reached yet: building it raises ``NotImplementedError`` naming it."""
        def unported(*args, **kwargs):
            raise NotImplementedError(f"{key} ({what}) is not ported yet")

        self._entries[key] = unported

    def get(self, key: str):
        if key not in self._entries:
            raise KeyError(
                f"{key!r} not found in registry {self.name!r}; "
                f"available: {sorted(self._entries)}"
            )
        return self._entries[key]

    def __contains__(self, key):
        return key in self._entries

    def keys(self):
        return sorted(self._entries)


DATASETS = Registry("datasets")
DETECTORS = Registry("detectors")
VFES = Registry("vfe")
BACKBONES_3D = Registry("backbones_3d")
MAP_TO_BEV = Registry("map_to_bev")
BACKBONES_2D = Registry("backbones_2d")
DENSE_HEADS = Registry("dense_heads")
ROI_HEADS = Registry("roi_heads")
