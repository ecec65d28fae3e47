"""Config registry of the port.  It holds the configs whose model code has
been ported: gptneox-1b now; the other architectures of ``repro.configs``
arrive with their slices."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig, BlockSpec  # noqa: F401
from repro_torch.configs.gptneox_1b import CONFIG as GPTNEOX_1B

REGISTRY: Dict[str, ArchConfig] = {GPTNEOX_1B.name: GPTNEOX_1B}


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(REGISTRY)}") from None
