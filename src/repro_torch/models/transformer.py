"""Model assembly for serving: parameter tree, pooled ring cache, chunked
prefill and the decode step (counterpart of ``repro.models.transformer``,
attention mixer + dense FFN).

The reference scans over the period axis with ``lax.scan``; here a Python
loop walks the layers, and each layer reads its slice ``leaf[l]`` of the
period-stacked parameters and cache (views, no copies).  The cache is
updated in place (see ``repro_torch.models.attention``).

The decode step's attention goes through the hand-written CUDA kernel
(``kernels.ops.flash_decode``) where the reference calls the XLA
``decode_attention``; chunked prefill keeps plain ``cache_attention``,
which has no kernel in the reference either.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.compat import resolve_dtype
from repro_torch.configs.base import ArchConfig, BlockSpec
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import slotstate
from repro_torch.models.layers import (
    apply_mlp, apply_rope, dense_init, embed, init_mlp, rms_norm, unembed)


def _check_block(cfg: ArchConfig, blk: BlockSpec) -> None:
    """This slice ports the attention decoder with dense FFNs."""
    if blk.mixer != "attn":
        raise NotImplementedError(
            f"{cfg.name}: mixer {blk.mixer!r} arrives with the SSM slice")
    if blk.ffn != "dense":
        raise NotImplementedError(
            f"{cfg.name}: ffn {blk.ffn!r} arrives with the MoE slice")
    if blk.cross_attn or cfg.is_encoder_decoder or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and VLM models arrive with "
            f"their slice")


def _at(tree: dict, layer: int) -> dict:
    """Layer ``layer``'s slice of a period-stacked tree (views)."""
    return {k: _at(v, layer) if isinstance(v, dict) else v[layer]
            for k, v in tree.items()}


# --------------------------------------------------------------------- #
# Parameter tree
# --------------------------------------------------------------------- #

def init_block(cfg: ArchConfig, blk: BlockSpec, dtype,
               generator: torch.Generator, device, lead=()) -> dict:
    _check_block(cfg, blk)
    ones = torch.ones((*lead, cfg.d_model), dtype=dtype, device=device)
    return {"ln_mix": ones,
            "attn": attn.init_attention(cfg, dtype, generator, device, lead),
            "ln_ffn": ones.clone(),
            "mlp": init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_variant, dtype,
                            generator, device, lead)}


def init_lm(cfg: ArchConfig, generator: torch.Generator, device) -> dict:
    """The port's own seeded init: the reference's shapes and
    distributions (truncated normal ±2σ, σ = 1/sqrt(fan_in); norms are
    ones), drawn from ``generator`` on ``device``.  It does not
    reproduce ``jax.random`` bits; conformance tests bridge the
    reference's weights instead (``repro_torch.bridge``)."""
    dtype = resolve_dtype(cfg.param_dtype)
    d, V = cfg.d_model, cfg.vocab_size
    params = {"embed": dense_init((V, d), dtype, generator, device,
                                  fan_in=d),
              "final_norm": torch.ones((d,), dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init((d, V), dtype, generator, device,
                                       fan_in=d)
    params["layers"] = {
        f"pos{i}": init_block(cfg, blk, dtype, generator, device,
                              lead=(cfg.n_periods,))
        for i, blk in enumerate(cfg.block_pattern())}
    return params


def unembed_weight(params: dict, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


# --------------------------------------------------------------------- #
# Serving cache
# --------------------------------------------------------------------- #

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device) -> dict:
    """Pooled ring cache: ``pos{i}/kv/{k,v}`` (n_periods, batch, cap,
    hkv, d) at the cache dtype and ``slot_pos`` (n_periods, batch, cap)
    = -1.  Capacities honour sliding windows."""
    kv_dtype = resolve_dtype(cfg.cache_dtype or cfg.compute_dtype)
    cache = {}
    for i, blk in enumerate(cfg.block_pattern()):
        _check_block(cfg, blk)
        cache[f"pos{i}"] = {"kv": attn.init_kv_cache(
            batch, attn.cache_capacity(max_seq, blk.window),
            cfg.n_kv_heads, cfg.head_dim, kv_dtype, device,
            kv_format=cfg.kv_format_for(i), lead=(cfg.n_periods,))}
    return cache


def kv_cache_stats(cache: dict, cfg: ArchConfig) -> dict:
    """Measured KV storage of a dense cache: total payload bytes, bytes
    per element and per cached token position across the layer stack,
    per position-in-period (``slot_pos`` bookkeeping excluded)."""
    kv_bytes, elems, per_token = 0, 0, 0.0
    per_layer = {}
    for name, entry in cache.items():
        kv = entry["kv"]
        n_p, b, cap = kv["slot_pos"].shape
        payload = sum(t.numel() * t.element_size()
                      for k, t in kv.items() if k != "slot_pos")
        part_elems = 2 * n_p * b * cap * cfg.n_kv_heads * cfg.head_dim
        kv_bytes += payload
        elems += part_elems
        per_token += payload / (b * cap)
        per_layer[name] = {"format": cfg.cache_dtype or cfg.compute_dtype,
                           "bytes_per_elem": payload / part_elems}
    return {"kv_format": cfg.cache_dtype or cfg.compute_dtype,
            "kv_bytes": int(kv_bytes), "cross_kv_bytes": 0,
            "bytes_per_elem": kv_bytes / elems if elems else 0.0,
            "bytes_per_token": per_token, "per_layer": per_layer}


def min_cache_capacity(cfg: ArchConfig, max_seq: int) -> int:
    """Smallest per-layer ring capacity — the upper bound on a prefill
    chunk (a chunk's slots must be distinct)."""
    caps = [attn.cache_capacity(max_seq, b.window)
            for b in cfg.block_pattern() if b.mixer == "attn"]
    return min(caps) if caps else max_seq


def clear_slot(cache: dict, slot: int) -> dict:
    """Evict pool row ``slot``: its ring entries become empty
    (slot_pos = -1), in place.  See ``repro_torch.models.slotstate``."""
    return slotstate.clear_slot(cache, slot)


# --------------------------------------------------------------------- #
# Decode step and chunked prefill
# --------------------------------------------------------------------- #

def _final_logits(params: dict, x: torch.Tensor, cfg: ArchConfig
                  ) -> torch.Tensor:
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(unembed_weight(params, cfg), x,
                   cfg.final_logit_softcap)[:, 0]


def lm_decode_step(params: dict, cache: dict, token: torch.Tensor,
                   pos: torch.Tensor, cfg: ArchConfig,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step.  token: (b,) int; pos: (b,) int32 per-row position
    of the incoming token.  Writes the step's K/V into the cache in place
    and returns logits (b, vocab) fp32.

    ``active`` (b,) bool masks the cache writes: inactive pool rows ride
    along in the fused loop, their logits are garbage and the caller
    never samples them."""
    cdt = resolve_dtype(cfg.compute_dtype)
    x = embed(params["embed"], token[:, None]).to(cdt)     # (b, 1, d)
    positions = pos[:, None]
    for layer in range(cfg.n_periods):
        for i, blk in enumerate(cfg.block_pattern()):
            p = _at(params["layers"][f"pos{i}"], layer)
            kv = _at(cache[f"pos{i}"], layer)["kv"]
            h = rms_norm(p["ln_mix"], x, cfg.norm_eps)
            q = attn.project_q(p["attn"], h)
            k, v = attn.project_kv(p["attn"], h)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            attn.cache_write_decode(kv, k, v, pos, active=active)
            o = ops.flash_decode(q, kv["k"], kv["v"], kv["slot_pos"], pos,
                                 window=blk.window,
                                 softcap=cfg.attn_logit_softcap)
            x = x + attn.project_out(p["attn"], o)
            h = rms_norm(p["ln_ffn"], x, cfg.norm_eps)
            x = x + apply_mlp(p["mlp"], h, cfg.mlp_variant)
    return _final_logits(params, x, cfg)


def lm_prefill_chunk(params: dict, cache: dict, tokens: torch.Tensor,
                     slot: int, pos_offset: int, valid_len: int,
                     cfg: ArchConfig) -> torch.Tensor:
    """Prefill one prompt chunk for pool row ``slot`` straight into the
    shared cache.  tokens: (chunk,) int, zero-padded past ``valid_len``;
    ``pos_offset`` is the absolute position of tokens[0].  Returns logits
    (1, vocab) at the last valid position.

    The chunk's queries attend the cache's PRE-write history concatenated
    with the chunk's own raw K/V (position masking gives intra-chunk
    causality); the chunk is written afterwards.  Writing first would
    evict, in a sliding-window ring, positions still inside the windows
    of the chunk's earlier queries."""
    cdt = resolve_dtype(cfg.compute_dtype)
    s = tokens.shape[0]
    dev = tokens.device
    x = embed(params["embed"], tokens[None, :]).to(cdt)    # (1, s, d)
    positions = pos_offset + torch.arange(s, dtype=torch.int32, device=dev)
    valid = torch.arange(s, device=dev) < valid_len
    chunk_sp = torch.where(valid, positions, -1)[None, :]
    for layer in range(cfg.n_periods):
        for i, blk in enumerate(cfg.block_pattern()):
            p = _at(params["layers"][f"pos{i}"], layer)
            kv_row = slotstate.take_row(_at(cache[f"pos{i}"], layer)["kv"],
                                        slot)
            h = rms_norm(p["ln_mix"], x, cfg.norm_eps)
            q = attn.project_q(p["attn"], h)
            k, v = attn.project_kv(p["attn"], h)
            q = apply_rope(q, positions[None, :], cfg.rope_theta)
            k = apply_rope(k, positions[None, :], cfg.rope_theta)
            kc, vc = kv_row["k"], kv_row["v"]
            o = attn.cache_attention(
                q, torch.cat([kc, k.to(kc.dtype)], dim=1),
                torch.cat([vc, v.to(vc.dtype)], dim=1),
                torch.cat([kv_row["slot_pos"], chunk_sp], dim=1),
                positions[None, :], window=blk.window,
                softcap=cfg.attn_logit_softcap)
            x = x + attn.project_out(p["attn"], o)
            attn.cache_write_chunk(kv_row, k, v, positions, valid)
            h = rms_norm(p["ln_ffn"], x, cfg.norm_eps)
            x = x + apply_mlp(p["mlp"], h, cfg.mlp_variant)
    return _final_logits(params, x[:, valid_len - 1:valid_len], cfg)
