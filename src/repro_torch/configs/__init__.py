"""Config registry: the dense architectures ported so far (+ smoke)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig, BlockSpec

_MODULES = {
    "granite-34b": "granite_34b",
    "chatglm3-6b": "chatglm3_6b",
    "yi-34b": "yi_34b",
    "llama3-405b": "llama3_405b",
}

ARCH_NAMES: List[str] = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"have {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ArchConfig", "BlockSpec", "ARCH_NAMES", "get_config"]
