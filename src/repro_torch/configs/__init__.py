"""Architecture configs the port serves (copies of ``repro.configs``):
``get_config(name)`` / ``get_smoke(name)``."""
from __future__ import annotations

import importlib

__all__ = ["ARCHS", "get_config", "get_smoke"]

ARCHS = ["whisper_tiny", "minitron_8b", "nemotron_4_340b", "minicpm3_4b", "olmo_1b",
         "olmoe_1b_7b", "llava_next_34b", "opt_125m",
         "xlstm_125m", "zamba2_1p2b", "deepseek_v3_671b"]

_ALIASES = {"whisper-tiny": "whisper_tiny", "minitron-8b": "minitron_8b",
            "nemotron-4-340b": "nemotron_4_340b", "minicpm3-4b": "minicpm3_4b",
            "olmo-1b": "olmo_1b", "olmoe-1b-7b": "olmoe_1b_7b",
            "llava-next-34b": "llava_next_34b", "opt-125m": "opt_125m",
            "xlstm-125m": "xlstm_125m", "zamba2-1.2b": "zamba2_1p2b",
            "deepseek-v3-671b": "deepseek_v3_671b"}


def _module(name: str):
    key = _ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if key not in ARCHS:
        raise KeyError(f"{name!r}: the port has configs for {ARCHS} only")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE
