"""Token sampling (counterpart of ``repro.serve.sampler``): fp32 logits
in, int32 tokens out.

* :func:`sample_token`: one key for the whole call.
* :func:`sample_tokens`: batched sampling for the fused decode loop.
  Each row samples under a key folded from the engine's base key, the
  row's request (``slot_seed``) and the position the token will occupy
  (``pos``), so a stream depends only on (engine seed, request,
  position), not on the batch around it, the pool slot or the decode
  block size.
* :func:`sample_tokens_chunk`: the same for (b, s) rows of logits, each
  under the key of its own position.

Temperature 0 is greedy (``argmax``, the first index on ties).  Else the
logits are divided by the temperature (an fp32 tensor on the logits'
device: a Python scalar would make a CUDA division a product with the
reciprocal, one ulp off the reference's division), filtered to the
``top_k`` largest (values below the k-th become ``-inf``) and sampled
with the Gumbel-max trick under ``repro_torch.serve.prng``, which gives
``jax.random``'s bits.  Everything runs on the logits' device with no
host read.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.serve import prng


def _top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < cutoff, float("-inf"))


def _scaled(logits: torch.Tensor, key: Optional[torch.Tensor],
            temperature: float, top_k: int) -> torch.Tensor:
    if key is None:
        raise ValueError("sampling (temperature > 0) needs a PRNG key")
    logits = logits / torch.full((), temperature, dtype=torch.float32,
                                 device=logits.device)
    return _top_k_filter(logits, top_k) if top_k > 0 else logits


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_token(logits: torch.Tensor, key: Optional[torch.Tensor] = None,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (b, v) -> tokens (b,), one key for all rows."""
    if temperature <= 0.0:
        return _greedy(logits)
    logits = _scaled(logits, key, temperature, top_k)
    return prng.categorical(key, logits).to(torch.int32)


def fold_slot_keys(key: torch.Tensor, slot_seed: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """Per-row keys ``fold_in(fold_in(key, slot_seed[i]), pos[i])``:
    key (2,), slot_seed (b,) and pos (b,) or (b, s) integer -> (b, 2) or
    (b, s, 2)."""
    seeded = prng.fold_in(key, slot_seed.to(torch.int32))     # (b, 2)
    seeded = seeded.view(-1, *(1,) * (pos.dim() - 1), 2)
    return prng.fold_in(seeded, pos.to(torch.int32))


def sample_tokens(logits: torch.Tensor, key: Optional[torch.Tensor] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  slot_seed: Optional[torch.Tensor] = None,
                  pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (b, v) -> tokens (b,) int32.  With ``slot_seed`` (b,) and
    ``pos`` (b,) each row samples under its folded key
    (:func:`fold_slot_keys`); without, under ``key`` shared by all rows
    (:func:`sample_token`).  Logits (b, s, v) with ``pos`` (b, s) give
    tokens (b, s) (:func:`sample_tokens_chunk`)."""
    if temperature <= 0.0:
        return _greedy(logits)
    if slot_seed is None or pos is None:
        return sample_token(logits, key, temperature, top_k)
    logits = _scaled(logits, key, temperature, top_k)
    keys = fold_slot_keys(key, slot_seed, pos)
    return prng.categorical(keys, logits).to(torch.int32)


def sample_tokens_chunk(logits: torch.Tensor,
                        key: Optional[torch.Tensor] = None,
                        temperature: float = 0.0, top_k: int = 0,
                        slot_seed: Optional[torch.Tensor] = None,
                        pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (b, s, v) -> tokens (b, s) int32: row (i, j) samples under
    the key :func:`sample_tokens` gives request ``slot_seed[i]`` at
    position ``pos[i, j]``, so a token is the same whether it was
    sampled one step at a time or in a chunk."""
    return sample_tokens(logits, key, temperature, top_k, slot_seed, pos)
