"""Per-slot decode-state protocol (counterpart of
``repro.models.slotstate``): the ring-KV parts of the attention layers
(self- and cross-attention), the recurrent parts of the SSM layers and
the encoder output.

The serving cache is a dict of ``pos{i}`` layer entries whose leaves
carry the period axis first: ``(n_periods, batch, ...)``, plus bare
top-level tensors (``enc_out``) whose slot axis is 0.  Three rules:

1. **Slot addressing.**  Inside the per-layer loop a leaf is
   ``(batch, ...)``; :func:`take_row` returns one slot's row as a size-1
   *view*, so writes into it land in the pool directly (the reference
   needs ``put_row`` to write the row back; in place, nothing does).
2. **Eviction** (:func:`clear_slot`): ring parts mark the slot empty
   (``slot_pos = -1``; payload bytes stay and position masking makes
   them unreachable); every other part (SSM conv carries and state,
   ``enc_out``) zeroes the slot's row: zero IS its empty state.
3. **Decode-step advancement** under one ``active`` predicate: ring KV
   is masked at the write site (``cache_write_decode(active=...)``) and
   updated in place; a recurrent part takes its new value on the active
   rows only (:func:`decode_advance`), since the port updates it in
   place; the cross-attention rings and ``enc_out``, written once at
   admission, are not written by a decode step at all.
"""

from __future__ import annotations

from typing import Optional

import torch


def mask_rows(mask: Optional[torch.Tensor], new: torch.Tensor,
              old: torch.Tensor) -> torch.Tensor:
    """Select ``new`` where ``mask`` (leading-dims bool) else ``old``."""
    if mask is None:
        return new
    m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(m, new, old)


def take_row(tree: dict, slot: int) -> dict:
    """One slot's row (kept as a size-1 axis) of every leaf of a part
    tree whose slot axis is 0 — views into the pool."""
    return {name: leaf[slot:slot + 1] for name, leaf in tree.items()}


def decode_advance(active: Optional[torch.Tensor], tree: dict,
                   new: dict) -> None:
    """Rule 3 for a recurrent part: write ``new`` into the part's leaves
    (batch, ...) in place, on the ``active`` rows only (all rows when
    ``active`` is None)."""
    for name, leaf in tree.items():
        leaf.copy_(mask_rows(active, new[name], leaf))


def clear_slot(cache: dict, slot: int) -> dict:
    """Evict pool row ``slot`` from the whole cache (rule 2), in place."""
    for entry in cache.values():
        if isinstance(entry, torch.Tensor):      # enc_out: slot on axis 0
            entry[slot].zero_()
            continue
        for tree in entry.values():
            if "slot_pos" in tree:
                tree["slot_pos"][:, slot] = -1
            else:
                for leaf in tree.values():
                    leaf[:, slot].zero_()
    return cache
