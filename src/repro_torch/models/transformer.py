"""Model assembly: parameter tree, the whole-sequence forward (scoring)
and whole-prompt prefill, pooled cache, chunked prefill and the decode
step (counterpart of ``repro.models.transformer``).  A block is an
attention or SSM mixer, then a dense FFN, a MoE FFN (``models.moe``) or,
after an SSM mixer, none: the dense decoders, mamba2, the hybrid jamba
and the MoE decoders kimi-k2 and llama4.  An encoder-decoder model
(seamless) adds a bidirectional encoder over frame embeddings and a
cross-attention in every decoder block; a VLM (internvl2) puts patch
embeddings in front of the token embeddings.

The reference scans over the period axis with ``lax.scan``; here a Python
loop walks the layers, and each layer reads its slice ``leaf[l]`` of the
period-stacked parameters and cache (views, no copies).  The cache is
updated in place (see ``repro_torch.models.attention``).

The decode step's attention goes through a hand-written CUDA kernel
where the reference calls the XLA ``decode_attention``:
``kernels.flash_decode`` over a dense cache, and
``kernels.flash_decode_quant`` over a quantized one (``kv_format``),
which reads the packed codes and e8m0 scales and expands them on the way
in, where the reference dequantizes the whole cache each step
(``cache_kv``).  Chunked prefill keeps plain ``cache_attention`` over the
dequantized history, which has no kernel in the reference either.  Every
self-attention over a whole sequence (:func:`lm_forward`,
:func:`lm_features`, :func:`lm_prefill`) goes through the hand-written
CUDA ``kernels.flash_attention``, where the reference calls the XLA
``attention()``; its plain version is that dispatch, with the config's
``attn_chunk``.

Cross-attention, as in the reference, reads a ring cache of its own,
``pos{i}/cross_kv`` (capacity ``enc_len``, ``slot_pos`` the source
positions, quantized under the position's kv format), written once: by
:func:`lm_prefill` for whole prompts, by :func:`lm_encode_slot` for one
pool row.  Every reader attends the cached (possibly dequantized) view:
:func:`lm_prefill` through ``flash_attention(causal=False)``, the decode
step through ``flash_decode`` / ``flash_decode_quant`` at query position
2^30 (every written source slot visible), the chunked prefill through
plain ``cache_attention``.  The encoder runs ``flash_attention`` with
``causal=False``.

A MoE FFN routes the tokens it is given within subgroups of them: the
whole sequence, the padded prefill chunk (its pad rows take expert
capacity, as in the reference), or each row alone in a decode step.  The
whole-sequence paths sum its aux losses over the layers, as the
reference's ``_acc_aux`` does.

An SSM layer (``models.ssm``) keeps its conv carries and fp32 state in
the cache entry's ``ssm`` part.  Its whole-sequence block and its
chunked prefill run the SSD core through the hand-written CUDA
``kernels.ssd_scan``, where the reference runs the XLA ``ssd_chunked``;
its decode step is the one-token recurrence in plain torch, as in the
reference.

:func:`lm_prefill` writes the prompt's K/V (or the SSM carries and
state) into a fresh pooled cache from :func:`init_cache`, so
:func:`lm_decode_step` continues from it unchanged.

Speculative decoding scores a block of tentative tokens a row without
writing the cache (:func:`lm_verify_chunk`: plain ``cache_attention``
over the cache concatenated with the block, as in the reference), then
writes the kept prefix (:func:`lm_commit_chunk`); a draft model's eager
writes are undone by :func:`lm_rollback_chunk`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.compat import resolve_dtype
from repro_torch.configs.base import ArchConfig, BlockSpec
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_decode_quant import flash_decode_quant
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import slotstate
from repro_torch.models import ssm
from repro_torch.models.layers import (
    apply_mlp, apply_rope, dense_init, embed, init_mlp, rms_norm, unembed)


def _check_block(cfg: ArchConfig, blk: BlockSpec) -> None:
    """A block is an attention or SSM mixer, then a dense or MoE FFN, or
    (SSM only) none; only an attention block cross-attends."""
    if blk.mixer not in ("attn", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: mixer {blk.mixer!r} is not ported")
    ffns = ("dense", "moe") + (("none",) if blk.mixer == "ssm" else ())
    if blk.ffn not in ffns:
        raise NotImplementedError(
            f"{cfg.name}: ffn {blk.ffn!r} after a {blk.mixer!r} mixer "
            f"is not ported")
    if blk.cross_attn and blk.mixer != "attn":
        raise NotImplementedError(
            f"{cfg.name}: cross-attention after a {blk.mixer!r} mixer")


# the encoder's blocks (enc-dec models)
ENC_BLOCK = BlockSpec(mixer="attn", ffn="dense")
# the query position of cross-attention over a ring cache: every written
# source slot (slot_pos >= 0) is visible
CROSS_POS = 2 ** 30

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_dropped")


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


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
    p = {"ln_mix": ones}
    if blk.mixer == "ssm":
        p["ssm"] = ssm.init_ssm(cfg, dtype, generator, device, lead)
    else:
        p["attn"] = attn.init_attention(cfg, dtype, generator, device, lead)
        if blk.cross_attn:
            p["ln_cross"] = ones.clone()
            p["cross"] = attn.init_attention(cfg, dtype, generator, device,
                                             lead)
    if blk.ffn != "none":
        p["ln_ffn"] = ones.clone()
    if blk.ffn == "dense":
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_variant, dtype,
                            generator, device, lead)
    elif blk.ffn == "moe":
        p["moe"] = moe.init_moe(cfg, dtype, generator, device, lead)
    return p


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
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": init_block(cfg, ENC_BLOCK, dtype, generator, device,
                                 lead=(cfg.n_encoder_layers,)),
            "final_norm": torch.ones((d,), dtype=dtype, device=device)}
    return params


def unembed_weight(params: dict, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


# --------------------------------------------------------------------- #
# Whole-sequence forward (scoring) and whole-prompt prefill
# --------------------------------------------------------------------- #

def _self_attention(p: dict, x: torch.Tensor, cfg: ArchConfig,
                    blk: BlockSpec, causal: bool = True
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Self-attention over the whole sequence x (b, s, d_model),
    positions 0..s-1, causal or (the encoder) not: (out (b, s, d_model),
    (k, v) after RoPE).  GQA runs through the kernel's head index; the
    reference's ``attn_repeat_kv`` copy of K/V gives the same values and
    is not made."""
    positions = torch.arange(x.shape[1], device=x.device)
    q = attn.project_q(p, x)
    k, v = attn.project_kv(p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal, window=blk.window,
                        softcap=cfg.attn_logit_softcap, chunk=cfg.attn_chunk)
    return attn.project_out(p, o), (k, v)


def _cross_attention(p: dict, x: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The block's cross-attention and its residual over the whole
    sequence: the decoder's queries (no RoPE) against the source's K/V
    (b, s_src, hkv, d), every key visible."""
    h = rms_norm(p["ln_cross"], x, cfg.norm_eps)
    q = attn.project_q(p["cross"], h)
    o = flash_attention(q, k, v, causal=False)
    return x + attn.project_out(p["cross"], o)


def apply_ffn(p: dict, blk: BlockSpec, cfg: ArchConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, dict]:
    """The block's FFN and its residual: (x, aux).  aux holds the MoE
    losses of a MoE FFN and is {} otherwise."""
    if blk.ffn == "none":
        return x, {}
    h = rms_norm(p["ln_ffn"], x, cfg.norm_eps)
    if blk.ffn == "moe":
        y, aux = moe.apply_moe(p["moe"], h, cfg)
        return x + y, aux
    return x + apply_mlp(p["mlp"], h, cfg.mlp_variant), {}


def apply_block(p: dict, blk: BlockSpec, cfg: ArchConfig, x: torch.Tensor,
                enc_out: Optional[torch.Tensor] = None, causal: bool = True
                ) -> Tuple[torch.Tensor, dict]:
    """One block over the whole sequence: (x, aux).  A cross-attention
    block attends ``enc_out`` (b, s_src, d_model) when it is given."""
    _check_block(cfg, blk)
    h = rms_norm(p["ln_mix"], x, cfg.norm_eps)
    if blk.mixer == "ssm":
        x = x + ssm.ssm_forward(p["ssm"], h, cfg)
    else:
        x = x + _self_attention(p["attn"], h, cfg, blk, causal)[0]
        if blk.cross_attn and enc_out is not None:
            x = _cross_attention(p, x, *attn.project_kv(p["cross"], enc_out),
                                 cfg)
    return apply_ffn(p, blk, cfg, x)


def _needs_grad(*trees) -> bool:
    """Whether a tensor in the nested dicts / tensors requires grad."""
    for t in trees:
        if isinstance(t, dict):
            if _needs_grad(*t.values()):
                return True
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            return True
    return False


def _remat_block(p: dict, blk: BlockSpec, cfg: ArchConfig, x: torch.Tensor,
                 enc_out: Optional[torch.Tensor] = None, causal: bool = True
                 ) -> Tuple[torch.Tensor, dict]:
    """:func:`apply_block`, rematerialised in the backward when a
    gradient is wanted (grad enabled and an input or a weight of the
    block requires it) and ``cfg.remat`` is not "none" (the reference's
    ``_remat_wrap``): only the block's inputs are kept, and its forward
    (each ``flash_attention`` launch included) runs again in the
    backward.  Both "block" and "full" keep nothing inside the block:
    torch has no counterpart of the reference's policy that saves the
    weight products, and the values are the same either way.  Otherwise
    (serving, or grad disabled) this is :func:`apply_block`."""
    # jaxlint: disable=JL102(eager torch: requires_grad is metadata)
    if (cfg.remat != "none" and torch.is_grad_enabled()
            and _needs_grad(x, enc_out, p)):
        return torch.utils.checkpoint.checkpoint(
            apply_block, p, blk, cfg, x, enc_out, causal,
            use_reentrant=False)
    return apply_block(p, blk, cfg, x, enc_out=enc_out, causal=causal)


def encode(params: dict, frames: torch.Tensor, cfg: ArchConfig
           ) -> torch.Tensor:
    """The bidirectional encoder over frame embeddings (b, s_src,
    d_model): (b, s_src, d_model) at the compute dtype, after the
    encoder's final norm.  Its self-attention is ``flash_attention``
    with ``causal=False`` over every frame it is given (see
    :func:`lm_encode_slot` for padded sources)."""
    enc = params["encoder"]
    x = frames.to(resolve_dtype(cfg.compute_dtype))
    for layer in range(cfg.n_encoder_layers):
        x, _ = _remat_block(_at(enc["layers"], layer), ENC_BLOCK, cfg, x,
                            causal=False)
    return rms_norm(enc["final_norm"], x, cfg.norm_eps)


def trunk_inputs(params: dict, cfg: ArchConfig,
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Trunk inputs (b, s_trunk, d_model) at the compute dtype: the
    token embeddings, behind ``batch["patches"]`` (b, n_patches,
    d_model) for a vision frontend; and the encoder's output of
    ``batch["frames"]`` for an encoder-decoder model, else None."""
    x = embed(params["embed"], batch["tokens"])
    if cfg.frontend == "vision" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    enc_out = (encode(params, batch["frames"], cfg)
               if cfg.is_encoder_decoder else None)
    return x.to(resolve_dtype(cfg.compute_dtype)), enc_out


def lm_features(params: dict, batch: Dict[str, torch.Tensor],
                cfg: ArchConfig) -> Tuple[torch.Tensor, dict]:
    """Trunk output after the final norm, before unembedding: (features
    (b, s_trunk, d_model) at the compute dtype, aux).  aux holds the
    reference's keys: each MoE loss summed over the MoE layers (0 in a
    model without one)."""
    x, enc_out = trunk_inputs(params, cfg, batch)
    aux = _zero_aux(x.device)
    for layer in range(cfg.n_periods):
        for i, blk in enumerate(cfg.block_pattern()):
            x, a = _remat_block(_at(params["layers"][f"pos{i}"], layer),
                                blk, cfg, x, enc_out=enc_out)
            for name, v in a.items():
                aux[name] = aux[name] + v
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, aux


def lm_forward(params: dict, batch: Dict[str, torch.Tensor],
               cfg: ArchConfig) -> Tuple[torch.Tensor, dict]:
    """(logits (b, s_trunk, vocab) fp32, aux)."""
    x, aux = lm_features(params, batch, cfg)
    return unembed(unembed_weight(params, cfg), x,
                   cfg.final_logit_softcap), aux


def lm_prefill(params: dict, batch: Dict[str, torch.Tensor],
               cfg: ArchConfig, max_seq: int
               ) -> Tuple[torch.Tensor, dict]:
    """Forward over whole prompts (b, s_trunk), building the cache:
    (logits at the last position (b, vocab) fp32, cache).  The cache is
    a fresh :func:`init_cache` pool on the embeddings' device holding
    positions 0..s-1 (the last ``capacity`` of them in a ring), quantized
    on the way in under ``kv_format``; SSM layers hold the carries and
    state the prompt leaves.  An encoder-decoder model's cache also holds
    ``enc_out`` and every layer's cross-KV ring (capacity s_src); the
    prompt attends the cached cross K/V, dequantized under a kv format,
    as the chunked prefill and the decode step read them."""
    x, enc_out = trunk_inputs(params, cfg, batch)
    cache = init_cache(cfg, x.shape[0], max_seq, x.device,
                       enc_len=0 if enc_out is None else enc_out.shape[1])
    for layer in range(cfg.n_periods):
        for i, blk in enumerate(cfg.block_pattern()):
            p = _at(params["layers"][f"pos{i}"], layer)
            entry = _at(cache[f"pos{i}"], layer)
            kv_fmt = cfg.kv_format_for(i)
            h = rms_norm(p["ln_mix"], x, cfg.norm_eps)
            if blk.mixer == "ssm":
                out, state = ssm.ssm_forward(p["ssm"], h, cfg,
                                             return_state=True)
                x = x + out
                for name, t in state.items():
                    entry["ssm"][name].copy_(t)
            else:
                out, (k, v) = _self_attention(p["attn"], h, cfg, blk)
                x = x + out
                attn.cache_write_prefill(entry["kv"], k, v,
                                         kv_format=kv_fmt)
                if blk.cross_attn and enc_out is not None:
                    ck, cv = attn.project_kv(p["cross"], enc_out)
                    attn.cache_write_prefill(entry["cross_kv"], ck, cv,
                                             kv_format=kv_fmt)
                    x = _cross_attention(p, x, *attn.cache_kv(
                        entry["cross_kv"], kv_fmt, cfg.head_dim,
                        out_dtype=x.dtype), cfg)
            x, _ = apply_ffn(p, blk, cfg, x)
    if enc_out is not None:
        cache["enc_out"].copy_(enc_out)
    return _final_logits(params, x[:, -1:], cfg), cache


# --------------------------------------------------------------------- #
# Serving cache
# --------------------------------------------------------------------- #

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device,
               enc_len: int = 0) -> dict:
    """Pooled cache.  Attention: ring ``pos{i}/kv/{k,v}`` (n_periods,
    batch, cap, hkv, d) at the cache dtype, or the quantized leaves of
    ``cfg.kv_format_for(i)``, and ``slot_pos`` (n_periods, batch, cap)
    = -1; capacities honour sliding windows.  A cross-attention block
    adds ``pos{i}/cross_kv``, a ring of the same layout and format of
    capacity ``enc_len``, and the model a top-level ``enc_out`` (batch,
    enc_len, d_model) of zeros at the compute dtype.  SSM:
    ``pos{i}/ssm`` conv carries at the compute dtype and the fp32
    state, zeros."""
    kv_dtype = resolve_dtype(cfg.cache_dtype or cfg.compute_dtype)
    cdt = resolve_dtype(cfg.compute_dtype)
    cache = {}
    for i, blk in enumerate(cfg.block_pattern()):
        _check_block(cfg, blk)
        if blk.mixer == "ssm":
            cache[f"pos{i}"] = {"ssm": ssm.init_ssm_cache(
                cfg, batch, cdt, device, lead=(cfg.n_periods,))}
            continue
        caps = {"kv": attn.cache_capacity(max_seq, blk.window)}
        if blk.cross_attn:
            caps["cross_kv"] = enc_len
        cache[f"pos{i}"] = {part: attn.init_kv_cache(
            batch, cap, cfg.n_kv_heads, cfg.head_dim, kv_dtype, device,
            kv_format=cfg.kv_format_for(i), lead=(cfg.n_periods,))
            for part, cap in caps.items()}
    if cfg.is_encoder_decoder:
        cache["enc_out"] = torch.zeros((batch, enc_len, cfg.d_model),
                                       dtype=cdt, device=device)
    return cache


def kv_cache_stats(cache: dict, cfg: ArchConfig) -> dict:
    """Measured KV storage: total payload bytes (codes + scales, or the
    dense K/V) of the self- and cross-attention rings, the cross rings'
    share (``cross_kv_bytes``), bytes per logical element, bytes per
    cached decoder position across the layer stack (self-attention
    only: a cross ring holds source positions), per ring
    (``"pos{i}"``, ``"pos{i}.cross"``); ``slot_pos`` bookkeeping,
    ``enc_out`` and SSM state excluded (an attention-free model reports
    0), with the reference's keys."""
    plain = cfg.cache_dtype or cfg.compute_dtype
    kv_bytes, cross_bytes, elems, per_token = 0, 0, 0, 0.0
    per_layer = {}
    for name, entry in cache.items():
        if not name.startswith("pos"):
            continue
        for part in ("kv", "cross_kv"):
            if part not in entry:
                continue
            kv = entry[part]
            n_p, b, cap = kv["slot_pos"].shape
            payload = sum(t.numel() * t.element_size()
                          for k, t in kv.items() if k != "slot_pos")
            part_elems = 2 * n_p * b * cap * cfg.n_kv_heads * cfg.head_dim
            kv_bytes += payload
            elems += part_elems
            if part == "kv":
                per_token += payload / (b * cap)
            else:
                cross_bytes += payload
            key = name if part == "kv" else f"{name}.cross"
            per_layer[key] = {"format": cfg.kv_format_for(int(name[3:]))
                              or plain,
                              "bytes_per_elem": payload / part_elems}
    return {"kv_format": cfg.kv_format or plain,
            "kv_bytes": int(kv_bytes), "cross_kv_bytes": int(cross_bytes),
            "bytes_per_elem": kv_bytes / elems if elems else 0.0,
            "bytes_per_token": per_token, "per_layer": per_layer}


def min_cache_capacity(cfg: ArchConfig, max_seq: int) -> int:
    """Smallest per-layer ring capacity — the upper bound on a prefill
    chunk (a chunk's slots must be distinct)."""
    caps = [attn.cache_capacity(max_seq, b.window)
            for b in cfg.block_pattern() if b.mixer == "attn"]
    return min(caps) if caps else max_seq


def clear_slot(cache: dict, slot: int) -> dict:
    """Evict pool row ``slot``, in place: its ring entries (self- and
    cross-attention) become empty (slot_pos = -1), its SSM carries and
    state and its ``enc_out`` row zero.  See
    ``repro_torch.models.slotstate``."""
    return slotstate.clear_slot(cache, slot)


# --------------------------------------------------------------------- #
# Decode step and chunked prefill
# --------------------------------------------------------------------- #

def _final_logits(params: dict, x: torch.Tensor, cfg: ArchConfig
                  ) -> torch.Tensor:
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(unembed_weight(params, cfg), x,
                   cfg.final_logit_softcap)[:, 0]


def _decode_attention(q: torch.Tensor, kv: dict, pos: torch.Tensor,
                      kv_fmt: Optional[str], window: Optional[int] = None,
                      softcap: Optional[float] = None) -> torch.Tensor:
    """One query a row against a ring cache: ``flash_decode_quant`` over
    a quantized cache, ``flash_decode`` over a dense one."""
    if attn.is_quantized_cache(kv):
        return flash_decode_quant(q, kv, pos, fmt=kv_fmt, window=window,
                                  softcap=softcap)
    return flash_decode(q, kv["k"], kv["v"], kv["slot_pos"], pos,
                        window=window, softcap=softcap)


def lm_decode_step(params: dict, cache: dict, token: torch.Tensor,
                   pos: torch.Tensor, cfg: ArchConfig,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step.  token: (b,) int; pos: (b,) int32 per-row position
    of the incoming token.  Writes the step's K/V (attention) or advances
    the carries and state (SSM) in the cache in place and returns logits
    (b, vocab) fp32.  A cross-attention block reads its cross ring at
    query position 2^30 and never writes it (read-only in decode, as
    ``enc_out``).

    ``active`` (b,) bool masks the cache writes: inactive pool rows ride
    along in the fused loop, their logits are garbage and the caller
    never samples them."""
    cdt = resolve_dtype(cfg.compute_dtype)
    x = embed(params["embed"], token[:, None]).to(cdt)     # (b, 1, d)
    positions = pos[:, None]
    # filled on the device: a tensor made from a host value would
    # synchronize
    pos_far = (torch.full_like(pos, CROSS_POS)
               if any(b.cross_attn for b in cfg.block_pattern()) else None)
    for layer in range(cfg.n_periods):
        for i, blk in enumerate(cfg.block_pattern()):
            p = _at(params["layers"][f"pos{i}"], layer)
            entry = _at(cache[f"pos{i}"], layer)
            h = rms_norm(p["ln_mix"], x, cfg.norm_eps)
            if blk.mixer == "ssm":
                x = x + ssm.ssm_decode(p["ssm"], h, entry["ssm"], cfg,
                                       active=active)
                x, _ = apply_ffn(p, blk, cfg, x)
                continue
            kv = entry["kv"]
            q = attn.project_q(p["attn"], h)
            k, v = attn.project_kv(p["attn"], h)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            kv_fmt = cfg.kv_format_for(i)
            attn.cache_write_decode(kv, k, v, pos, kv_format=kv_fmt,
                                    active=active)
            o = _decode_attention(q, kv, pos, kv_fmt, window=blk.window,
                                  softcap=cfg.attn_logit_softcap)
            x = x + attn.project_out(p["attn"], o)
            if blk.cross_attn and "cross_kv" in entry:
                h = rms_norm(p["ln_cross"], x, cfg.norm_eps)
                q = attn.project_q(p["cross"], h)
                o = _decode_attention(q, entry["cross_kv"], pos_far, kv_fmt)
                x = x + attn.project_out(p["cross"], o)
            x, _ = apply_ffn(p, blk, cfg, x)
    return _final_logits(params, x, cfg)


def lm_prefill_chunk(params: dict, cache: dict, tokens: torch.Tensor,
                     slot: int, pos_offset: int, valid_len: int,
                     cfg: ArchConfig, embeds: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Prefill one prompt chunk for pool row ``slot`` straight into the
    shared cache.  tokens: (chunk,) int, zero-padded past ``valid_len``;
    ``pos_offset`` is the absolute trunk position of tokens[0].  With
    ``embeds`` (1, chunk, d_model) the chunk's trunk inputs are these
    embeddings instead of the tokens' (a VLM's patch prefix streams
    through the same path).  Returns logits (1, vocab) at the last valid
    position.

    The chunk's queries attend the cache's PRE-write history concatenated
    with the chunk's own raw K/V (position masking gives intra-chunk
    causality); the chunk is written afterwards.  Writing first would
    evict, in a sliding-window ring, positions still inside the windows
    of the chunk's earlier queries.  An SSM layer carries its conv
    inputs and state across chunks (``models.ssm.ssm_prefill_chunk``).
    Cross-attention reads the slot's cross ring, written once by
    :func:`lm_encode_slot`, through plain ``cache_attention`` at query
    position 2^30."""
    cdt = resolve_dtype(cfg.compute_dtype)
    s = tokens.shape[0]
    dev = tokens.device
    x = (embed(params["embed"], tokens[None, :]) if embeds is None
         else embeds).to(cdt)                              # (1, s, d)
    positions = pos_offset + torch.arange(s, dtype=torch.int32, device=dev)
    valid = torch.arange(s, device=dev) < valid_len
    chunk_sp = torch.where(valid, positions, -1)[None, :]
    for layer in range(cfg.n_periods):
        for i, blk in enumerate(cfg.block_pattern()):
            p = _at(params["layers"][f"pos{i}"], layer)
            entry = _at(cache[f"pos{i}"], layer)
            h = rms_norm(p["ln_mix"], x, cfg.norm_eps)
            if blk.mixer == "ssm":
                x = x + ssm.ssm_prefill_chunk(
                    p["ssm"], h, slotstate.take_row(entry["ssm"], slot),
                    cfg, valid, valid_len)
                x, _ = apply_ffn(p, blk, cfg, x)
                continue
            kv_row = slotstate.take_row(entry["kv"], slot)
            q = attn.project_q(p["attn"], h)
            k, v = attn.project_kv(p["attn"], h)
            q = apply_rope(q, positions[None, :], cfg.rope_theta)
            k = apply_rope(k, positions[None, :], cfg.rope_theta)
            kv_fmt = cfg.kv_format_for(i)
            kc, vc = attn.cache_kv(kv_row, kv_fmt, cfg.head_dim,
                                   out_dtype=x.dtype)
            o = attn.cache_attention(
                q, torch.cat([kc, k.to(kc.dtype)], dim=1),
                torch.cat([vc, v.to(vc.dtype)], dim=1),
                torch.cat([kv_row["slot_pos"], chunk_sp], dim=1),
                positions[None, :], window=blk.window,
                softcap=cfg.attn_logit_softcap)
            x = x + attn.project_out(p["attn"], o)
            attn.cache_write_chunk(kv_row, k, v, positions, valid,
                                   kv_format=kv_fmt)
            if blk.cross_attn and "cross_kv" in entry:
                h = rms_norm(p["ln_cross"], x, cfg.norm_eps)
                q = attn.project_q(p["cross"], h)
                ckv_row = slotstate.take_row(entry["cross_kv"], slot)
                ck, cv = attn.cache_kv(ckv_row, kv_fmt, cfg.head_dim,
                                       out_dtype=x.dtype)
                o = attn.cache_attention(
                    q, ck, cv, ckv_row["slot_pos"],
                    torch.full_like(positions, CROSS_POS)[None, :])
                x = x + attn.project_out(p["cross"], o)
            x, _ = apply_ffn(p, blk, cfg, x)
    return _final_logits(params, x[:, valid_len - 1:valid_len], cfg)


def lm_encode_slot(params: dict, cache: dict, frames: torch.Tensor,
                   slot: int, src_len: int, cfg: ArchConfig) -> dict:
    """Encode one request once and write the results into pool row
    ``slot``, in place: the ``enc_out`` row (zero past ``src_len``) and
    every decoder layer's cross ring row (quantized on the way in under
    the position's kv format, ``slot_pos`` = source positions 0..src_len-1,
    the rest of the row as it was: -1 after :func:`clear_slot`).  The
    decoder prompt then streams through :func:`lm_prefill_chunk`, and
    decode reads the same cached cross view.

    frames: (1, n, d_model) frame embeddings, n >= ``src_len`` (padding
    past ``src_len`` is not read).  The reference encodes the frames
    padded to the pool's ``enc_len`` and masks the padded keys in every
    encoder self-attention (``k_valid``); the ``flash_attention`` kernel
    takes no key mask, so the port encodes ``frames[:, :src_len]`` alone.
    Under the reference's mask a valid position never sees a padded key
    in any layer, so the valid outputs are the same, and the padded ones
    are zeroed there as here.  Returns ``cache``."""
    enc = encode(params, frames[:, :src_len], cfg)         # (1, src, d)
    row = cache["enc_out"][slot:slot + 1]
    row[:, :src_len] = enc.to(row.dtype)
    row[:, src_len:].zero_()
    positions = torch.arange(src_len, dtype=torch.int32, device=enc.device)
    valid = torch.ones(src_len, dtype=torch.bool, device=enc.device)
    for layer in range(cfg.n_periods):
        for i, blk in enumerate(cfg.block_pattern()):
            entry = _at(cache[f"pos{i}"], layer)
            if not (blk.cross_attn and "cross_kv" in entry):
                continue
            p = _at(params["layers"][f"pos{i}"], layer)
            ck, cv = attn.project_kv(p["cross"], enc)
            attn.cache_write_chunk(
                slotstate.take_row(entry["cross_kv"], slot), ck, cv,
                positions, valid, kv_format=cfg.kv_format_for(i))
    return cache


# --------------------------------------------------------------------- #
# Speculative verify, commit and rollback
# --------------------------------------------------------------------- #

def lm_verify_chunk(params: dict, cache: dict, tokens: torch.Tensor,
                    positions: torch.Tensor, cfg: ArchConfig
                    ) -> Tuple[torch.Tensor, list]:
    """Score ``s`` tentative tokens a pool row in one pass, as ``s``
    successive :func:`lm_decode_step` calls would, without writing the
    cache.

    tokens (b, s): row r is [last committed token, draft_1, ...,
    draft_{s-1}]; positions (b, s) int32: each token's absolute position
    (``pos[r] + j``).  Returns (logits (b, s, vocab) fp32, info): logits
    row j is the next-token distribution after tokens[:, :j+1]; ``info``
    (one dict of ``pos{i}`` legs a layer) is what
    :func:`lm_commit_chunk` writes: an attention layer's post-RoPE K/V,
    an SSM layer's discretized inputs and conv streams.

    An attention layer's queries attend the concatenation of the
    pre-block cache view (dequantized whole when it is quantized,
    ``cache_kv``) and the chunk's own K/V, rounded as decode would read
    them back (quantized then dequantized under the position's format;
    cast to the storage dtype for a dense cache).  Writing first and
    reading after would be wrong on a local ring (capacity == window):
    writing row j evicts position pos+j-cap, which the queries before j
    still see.  An SSM layer runs the decode recurrence in order
    (``models.ssm.ssm_verify_chunk``), read-only; cross-attention reads
    its ring at query position 2^30; a MoE FFN routes as in decode.
    Inactive rows give garbage logits that the caller never keeps."""
    cdt = resolve_dtype(cfg.compute_dtype)
    x = embed(params["embed"], tokens).to(cdt)             # (b, s, d)
    pos_far = (torch.full_like(positions, CROSS_POS)
               if any(b.cross_attn for b in cfg.block_pattern()) else None)
    info = []
    for layer in range(cfg.n_periods):
        legs = {}
        for i, blk in enumerate(cfg.block_pattern()):
            p = _at(params["layers"][f"pos{i}"], layer)
            entry = _at(cache[f"pos{i}"], layer)
            h = rms_norm(p["ln_mix"], x, cfg.norm_eps)
            if blk.mixer == "ssm":
                out, legs[f"pos{i}"] = ssm.ssm_verify_chunk(
                    p["ssm"], h, entry["ssm"], cfg)
                x, _ = apply_ffn(p, blk, cfg, x + out)
                continue
            kv = entry["kv"]
            q = attn.project_q(p["attn"], h)
            k, v = attn.project_kv(p["attn"], h)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            kv_fmt = cfg.kv_format_for(i)
            kc, vc = attn.cache_kv(kv, kv_fmt, cfg.head_dim,
                                   out_dtype=x.dtype)
            if attn.is_quantized_cache(kv):
                kd, vd = (attn.dequantize_kv(*attn.quantize_kv(t, kv_fmt),
                                             kv_fmt, cfg.head_dim,
                                             out_dtype=x.dtype)
                          for t in (k, v))
            else:
                kd, vd = k.to(kc.dtype), v.to(vc.dtype)
            o = attn.cache_attention(
                q, torch.cat([kc, kd], dim=1), torch.cat([vc, vd], dim=1),
                torch.cat([kv["slot_pos"], positions.to(torch.int32)],
                          dim=1),
                positions, window=blk.window,
                softcap=cfg.attn_logit_softcap)
            x = x + attn.project_out(p["attn"], o)
            legs[f"pos{i}"] = {"k": k, "v": v}
            if blk.cross_attn and "cross_kv" in entry:
                ckv = entry["cross_kv"]
                h = rms_norm(p["ln_cross"], x, cfg.norm_eps)
                q = attn.project_q(p["cross"], h)
                ck, cv = attn.cache_kv(ckv, kv_fmt, cfg.head_dim,
                                       out_dtype=x.dtype)
                o = attn.cache_attention(q, ck, cv, ckv["slot_pos"], pos_far)
                x = x + attn.project_out(p["cross"], o)
            x, _ = apply_ffn(p, blk, cfg, x)
        info.append(legs)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(unembed_weight(params, cfg), x,
                     cfg.final_logit_softcap)
    return logits, info


def lm_commit_chunk(cache: dict, info: list, positions: torch.Tensor,
                    e: torch.Tensor, cfg: ArchConfig) -> dict:
    """Commit the first ``e`` (b,) verified positions of each row into the
    cache, in place: the writes :func:`lm_verify_chunk` deferred.
    positions (b, s) as given to verify; ``e`` in [0, s], 0 for an
    inactive row (every write a no-op there).  An attention layer writes
    through decode's quantize-on-write (``attention.cache_write_rows``),
    an SSM layer re-materializes its state from the pre-block state
    (``models.ssm.ssm_commit_chunk``); cross rings and ``enc_out`` are
    read-only.  Needs no parameters: ``info`` holds the K/V and the
    discretized SSM inputs."""
    s = positions.shape[1]
    valid = torch.arange(s, device=e.device)[None, :] < e[:, None]
    for layer, legs in enumerate(info):
        for i, blk in enumerate(cfg.block_pattern()):
            entry = _at(cache[f"pos{i}"], layer)
            leg = legs[f"pos{i}"]
            if blk.mixer == "ssm":
                ssm.ssm_commit_chunk(entry["ssm"], leg, e, cfg)
            else:
                attn.cache_write_rows(entry["kv"], leg["k"], leg["v"],
                                      positions, valid,
                                      kv_format=cfg.kv_format_for(i))
    return cache


def lm_rollback_chunk(cache: dict, positions: torch.Tensor,
                      reject: torch.Tensor) -> dict:
    """Invalidate speculative writes at ``positions`` (b, s) where
    ``reject`` (b, s), in place: a ``slot_pos`` pointer move in every
    self-attention ring (``attention.cache_rollback`` on the
    period-stacked leaves).  Cross rings, SSM parts and payload bytes
    are untouched.  Used on a draft model's cache, whose drafting decode
    steps write eagerly."""
    for name, entry in cache.items():
        if name.startswith("pos") and "kv" in entry:
            attn.cache_rollback(entry["kv"], positions, reject)
    return cache
