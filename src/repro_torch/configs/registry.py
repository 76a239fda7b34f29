"""Config registry: ``--arch <id>`` resolution.

Only architectures whose model family is ported are registered; the rest
of the reference's registry follows with their families.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_ARCHS = {
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
}


def list_configs() -> list[str]:
    return sorted(_ARCHS)


def get_config(name: str) -> ArchConfig:
    key = name.lower()
    if key not in _ARCHS:
        raise ValueError(f"unknown arch {name!r}; known: {list_configs()}")
    mod = importlib.import_module(_ARCHS[key])
    return mod.get(key) if hasattr(mod, "get") else mod.CONFIG
