"""Architecture configs the port serves (copies of ``repro.configs``):
``get_config(name)`` / ``get_smoke(name)``."""
from __future__ import annotations

import importlib

__all__ = ["ARCHS", "get_config", "get_smoke"]

ARCHS = ["minicpm3_4b", "olmoe_1b_7b", "opt_125m"]

_ALIASES = {"minicpm3-4b": "minicpm3_4b", "olmoe-1b-7b": "olmoe_1b_7b",
            "opt-125m": "opt_125m"}


def _module(name: str):
    key = _ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if key not in ARCHS:
        raise KeyError(f"{name!r}: the port has configs for {ARCHS} only")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE
