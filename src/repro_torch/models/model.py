"""Model API (counterpart of ``repro.models.model``): ``build_model(cfg)``
returns a :class:`Model` whose methods close over the config."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # -- parameters -------------------------------------------------- #
    def init(self, generator: torch.Generator, device) -> dict:
        return tf.init_lm(self.cfg, generator, device)

    # -- execution modes: whole sequence, then decode ----------------- #
    def forward(self, params: dict, batch: Dict[str, torch.Tensor]):
        """(logits (b, s, vocab) fp32, aux) of ``batch["tokens"]``."""
        return tf.lm_forward(params, batch, self.cfg)

    def features(self, params: dict, batch: Dict[str, torch.Tensor]):
        """(features (b, s, d_model) after the final norm, aux)."""
        return tf.lm_features(params, batch, self.cfg)

    def unembed_weight(self, params: dict) -> torch.Tensor:
        return tf.unembed_weight(params, self.cfg)

    def prefill(self, params: dict, batch: Dict[str, torch.Tensor],
                max_seq: int):
        """(last-position logits (b, vocab) fp32, cache): whole-prompt
        prefill into a fresh pooled cache, for :meth:`decode_step`."""
        return tf.lm_prefill(params, batch, self.cfg, max_seq)

    # -- serving hot path (fused loop / chunked pooled prefill) ------- #
    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    pos: torch.Tensor,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
        return tf.lm_decode_step(params, cache, token, pos, self.cfg,
                                 active=active)

    def prefill_chunk(self, params: dict, cache: dict, tokens: torch.Tensor,
                      slot: int, pos_offset: int, valid_len: int
                      ) -> torch.Tensor:
        return tf.lm_prefill_chunk(params, cache, tokens, slot, pos_offset,
                                   valid_len, self.cfg)

    def clear_slot(self, cache: dict, slot: int) -> dict:
        return tf.clear_slot(cache, slot)

    def min_cache_capacity(self, max_seq: int) -> int:
        return tf.min_cache_capacity(self.cfg, max_seq)

    def init_cache(self, batch: int, max_seq: int, device) -> dict:
        return tf.init_cache(self.cfg, batch, max_seq, device)

    def kv_cache_stats(self, cache: dict) -> dict:
        return tf.kv_cache_stats(cache, self.cfg)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
