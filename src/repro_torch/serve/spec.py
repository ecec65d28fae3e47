"""Speculative decoding: the drafting side and its configuration
(counterpart of ``repro.serve.spec``).

The verify / commit half lives in the model stack
(``models.transformer.lm_verify_chunk`` / ``lm_commit_chunk``); the
engine's speculative block (``serve.engine.ServeEngine._spec_block``)
drafts, verifies, commits and rolls back.  Three ways to draft:

* **n-gram** (the default, no second model): each pool slot keeps a
  device-resident hash table from the last ``ngram_context`` tokens to
  the token that followed them last time, seeded from the prompt tail at
  admission and updated as tokens commit.
* **a draft model**: a small decoder-only attention LM that shares the
  slot protocol (the same pool slots, the same admission prefill, ring
  rollback through ``slot_pos``) and proposes greedily.
* ``draft_fn``: a test hook, ``draft_fn(state) -> (b, draft_tokens)``
  int32 drafts computed from the engine's state dict of tensors.

Emitted tokens are always the tokens sampled from the verify logits, so
a draft only decides how many of them a block keeps.

The hash is the reference's: a rolling polynomial in wrapping int32,
taken modulo the table size as a uint32.  torch has no dependable
uint32 arithmetic, so it runs in int64 and keeps the low 32 bits after
each step, ``h = (h * 1000003 + ctx) & 0xFFFFFFFF``: the same residue
as the wrapped int32, read as unsigned.  Every function here runs on
the tensors' device with no host read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

# multiplier of the rolling polynomial context hash
_HASH_MULT = 1000003
_LOW32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculation settings for ``ServeEngine(spec=...)``.

    draft_tokens:  drafts proposed a block (the verify width is
                   draft_tokens + 1: one row re-scores the incoming
                   committed token, the last samples past the last
                   accepted draft).
    ngram_context: tokens of context hashed into the per-slot table.
    ngram_table:   per-slot hash-table entries (int32 each).
    prompt_tail:   prompt-tail tokens that seed the table at admission.
    draft_model:   optional small decoder-only attention ``Model`` of the
                   port sharing the slot protocol; ``draft_params`` its
                   weights.
    draft_fn:      test hook, ``draft_fn(state) -> (b, draft_tokens)``
                   int32 drafts from the engine's state dict; overrides
                   n-gram and draft-model drafting.
    """
    draft_tokens: int = 4
    ngram_context: int = 3
    ngram_table: int = 512
    prompt_tail: int = 32
    draft_model: Any = None
    draft_params: Any = None
    draft_fn: Optional[Callable[[dict], torch.Tensor]] = None

    def __post_init__(self):
        if self.draft_tokens < 1:
            raise ValueError("draft_tokens must be >= 1")
        if self.ngram_context < 1:
            raise ValueError("ngram_context must be >= 1")
        if self.ngram_table < 1:
            raise ValueError("ngram_table must be >= 1")
        if (self.draft_model is None) != (self.draft_params is None):
            raise ValueError("draft_model and draft_params go together")


def ngram_index(ctx: torch.Tensor, table_size: int) -> torch.Tensor:
    """Hash a context window (..., C) of ids -> table index (...,) int64.
    Entries of -1 (a history not yet full) take part in the hash."""
    h = torch.zeros(ctx.shape[:-1], dtype=torch.int64, device=ctx.device)
    for j in range(ctx.shape[-1]):
        h = (h * _HASH_MULT + ctx[..., j].to(torch.int64)) & _LOW32
    return h % table_size


def ngram_draft(hist: torch.Tensor, table: torch.Tensor,
                draft_tokens: int) -> torch.Tensor:
    """``draft_tokens`` greedy n-gram continuations a row, (b, D) int32.

    hist: (b, C) last committed tokens (-1 where the slot has seen fewer
    than C); table: (b, T) int32 token-or-(-1) entries.  A miss repeats
    the last context token (clamped at 0): any filler is correct, a
    wrong draft only shortens the accepted prefix."""
    cur = hist
    drafts = []
    for _ in range(draft_tokens):
        idx = ngram_index(cur, table.shape[-1])
        tok = table.gather(1, idx[:, None])[:, 0]
        tok = torch.where(tok >= 0, tok, cur[:, -1].clamp_min(0))
        drafts.append(tok)
        cur = torch.cat([cur[:, 1:], tok[:, None]], dim=1)
    return torch.stack(drafts, dim=1).to(torch.int32)


def ngram_update(hist: torch.Tensor, table: torch.Tensor,
                 toks: torch.Tensor, valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold ``toks`` (b, s) under ``valid`` (b, s) into the per-slot
    history and table: each valid token is stored at the hash of the
    history before it (once the history is full), then shifted into the
    history.  Returns new (hist, table); the inputs are not written."""
    for j in range(toks.shape[1]):
        tok, ok = toks[:, j].to(hist.dtype), valid[:, j]
        ins = ok & (hist >= 0).all(dim=1)
        idx = ngram_index(hist, table.shape[-1])[:, None]
        old = table.gather(1, idx)
        table = table.scatter(1, idx, torch.where(ins[:, None],
                                                  tok[:, None].to(
                                                      table.dtype), old))
        hist = torch.where(ok[:, None],
                           torch.cat([hist[:, 1:], tok[:, None]], dim=1),
                           hist)
    return hist, table


def seed_from_tail(tail: torch.Tensor, ngram_context: int,
                   table_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Admission seeding of one slot: fold a prompt tail (``prompt_tail``,)
    of ids, left-padded with -1, into a fresh history (C,) and table
    (T,), int32."""
    hist = torch.full((1, ngram_context), -1, dtype=torch.int32,
                      device=tail.device)
    table = torch.full((1, table_size), -1, dtype=torch.int32,
                       device=tail.device)
    tail = tail.to(torch.int32)[None]
    hist, table = ngram_update(hist, table, tail, tail >= 0)
    return hist[0], table[0]
