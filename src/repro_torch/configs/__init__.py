"""Config registry of the port, every config of ``repro.configs``: the
dense attention decoders gptneox-1b, gemma2-2b, qwen2.5-3b, llama3.2-3b
and gemma-2b, the SSM mamba2-2.7b, the hybrid jamba-v0.1-52b, the MoE
decoders kimi-k2-1t-a32b and llama4-maverick-400b-a17b, the
encoder-decoder seamless-m4t-medium and the VLM internvl2-2b."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig, BlockSpec  # noqa: F401
from repro_torch.configs.gemma2_2b import CONFIG as GEMMA2_2B
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B
from repro_torch.configs.gptneox_1b import CONFIG as GPTNEOX_1B
from repro_torch.configs.internvl2_2b import CONFIG as INTERNVL2_2B
from repro_torch.configs.jamba_v0p1_52b import CONFIG as JAMBA_52B
from repro_torch.configs.kimi_k2_1t import CONFIG as KIMI_K2
from repro_torch.configs.llama3p2_3b import CONFIG as LLAMA3P2_3B
from repro_torch.configs.llama4_maverick_400b import CONFIG as LLAMA4_MAVERICK
from repro_torch.configs.mamba2_2p7b import CONFIG as MAMBA2_2P7B
from repro_torch.configs.qwen2p5_3b import CONFIG as QWEN2P5_3B
from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS_M4T

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in (GPTNEOX_1B, MAMBA2_2P7B, GEMMA2_2B, QWEN2P5_3B,
                        LLAMA3P2_3B, GEMMA_2B, JAMBA_52B, KIMI_K2,
                        LLAMA4_MAVERICK, SEAMLESS_M4T, INTERNVL2_2B)}


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(REGISTRY)}") from None
