"""Model API (counterpart of ``repro.models.model``): ``build_model(cfg)``
returns a :class:`Model` whose methods close over the config; batches
are plain dicts (:func:`batch_fields`, :func:`make_batch`)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.compat import resolve_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf

# Number of vision patches the VLM frontend stub contributes to the trunk.
VLM_PATCHES = 256


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # -- parameters -------------------------------------------------- #
    def init(self, generator: torch.Generator, device) -> dict:
        return tf.init_lm(self.cfg, generator, device)

    # -- execution modes: whole sequence, then decode ----------------- #
    def forward(self, params: dict, batch: Dict[str, torch.Tensor]):
        """(logits (b, s_trunk, vocab) fp32, aux) of ``batch`` (the fields
        of :func:`batch_fields`: ``tokens``, and ``frames`` or
        ``patches``)."""
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
                      slot: int, pos_offset: int, valid_len: int,
                      embeds: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        return tf.lm_prefill_chunk(params, cache, tokens, slot, pos_offset,
                                   valid_len, self.cfg, embeds=embeds)

    def encode_slot(self, params: dict, cache: dict, frames: torch.Tensor,
                    slot: int, src_len: int) -> dict:
        """Encode one request's frames into pool row ``slot``'s
        ``enc_out`` and cross-KV (``transformer.lm_encode_slot``)."""
        return tf.lm_encode_slot(params, cache, frames, slot, src_len,
                                 self.cfg)

    # -- speculative decoding (serve.spec) ----------------------------- #
    def verify_chunk(self, params: dict, cache: dict, tokens: torch.Tensor,
                     positions: torch.Tensor):
        """(logits (b, s, vocab) fp32, info) of ``s`` tentative tokens a
        row, without writing the cache (``transformer.lm_verify_chunk``)."""
        return tf.lm_verify_chunk(params, cache, tokens, positions,
                                  self.cfg)

    def commit_chunk(self, cache: dict, info: list, positions: torch.Tensor,
                     e: torch.Tensor) -> dict:
        """Write the first ``e`` verified positions a row, in place."""
        return tf.lm_commit_chunk(cache, info, positions, e, self.cfg)

    def rollback_chunk(self, cache: dict, positions: torch.Tensor,
                       reject: torch.Tensor) -> dict:
        """Invalidate rejected ring writes (a pointer move), in place."""
        return tf.lm_rollback_chunk(cache, positions, reject)

    def clear_slot(self, cache: dict, slot: int) -> dict:
        return tf.clear_slot(cache, slot)

    def min_cache_capacity(self, max_seq: int) -> int:
        return tf.min_cache_capacity(self.cfg, max_seq)

    def init_cache(self, batch: int, max_seq: int, device,
                   enc_len: int = 0) -> dict:
        return tf.init_cache(self.cfg, batch, max_seq, device,
                             enc_len=enc_len)

    def kv_cache_stats(self, cache: dict) -> dict:
        return tf.kv_cache_stats(cache, self.cfg)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)


# --------------------------------------------------------------------- #
# Batch construction
# --------------------------------------------------------------------- #

def vlm_patches(seq_len: int) -> int:
    """Patch-prefix length of a VLM trunk of ``seq_len`` (shrinks for
    short sequences)."""
    return min(VLM_PATCHES, max(1, seq_len // 2))


def batch_fields(cfg: ArchConfig, batch: int, seq_len: int
                 ) -> Dict[str, Tuple[tuple, str]]:
    """{name: (shape, dtype)} of a forward / prefill batch of ``batch``
    rows and ``seq_len`` trunk positions, as the reference's: frame
    embeddings and ``seq_len`` tokens for an encoder-decoder model, a
    patch prefix and the remaining tokens for a VLM, else tokens."""
    emb = cfg.compute_dtype
    if cfg.is_encoder_decoder:
        return {"frames": ((batch, seq_len, cfg.d_model), emb),
                "tokens": ((batch, seq_len), "int32")}
    if cfg.frontend == "vision":
        n_pat = vlm_patches(seq_len)
        return {"patches": ((batch, n_pat, cfg.d_model), emb),
                "tokens": ((batch, seq_len - n_pat), "int32")}
    return {"tokens": ((batch, seq_len), "int32")}


def make_batch(cfg: ArchConfig, batch: int, seq_len: int, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """A batch of :func:`batch_fields` drawn with numpy from ``seed``:
    tokens uniform over the vocabulary, embeddings N(0, 0.02^2) at the
    compute dtype."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in batch_fields(cfg, batch, seq_len).items():
        if dtype == "int32":
            arr = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
            out[name] = torch.from_numpy(arr).to(device)
        else:
            arr = rng.standard_normal(shape, np.float32) * np.float32(0.02)
            out[name] = torch.from_numpy(arr).to(device,
                                                 resolve_dtype(dtype))
    return out
