"""Config registry of the port.  It holds the configs whose model code has
been ported: gptneox-1b (attention decoder) and mamba2-2.7b (SSM); the
other architectures of ``repro.configs`` arrive with their slices."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig, BlockSpec  # noqa: F401
from repro_torch.configs.gptneox_1b import CONFIG as GPTNEOX_1B
from repro_torch.configs.mamba2_2p7b import CONFIG as MAMBA2_2P7B

REGISTRY: Dict[str, ArchConfig] = {c.name: c
                                   for c in (GPTNEOX_1B, MAMBA2_2P7B)}


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(REGISTRY)}") from None
