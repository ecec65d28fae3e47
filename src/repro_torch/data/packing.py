"""Sequence packing (the port's copy of ``repro.data.packing``):
concatenate variable-length documents into fixed training rows with
loss masks that zero the first token after each boundary (no
cross-document next-token supervision).  Greedy first-fit, numpy, on
the host."""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np


def pack_documents(docs: Iterable[np.ndarray], seq_len: int,
                   pad_id: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack ``docs`` (1-D int arrays) into rows of ``seq_len``.

    Returns (tokens (n, s) int32, loss_mask (n, s) float32, segment_ids
    (n, s) int32).  loss_mask is 0 on padding and on the first token of
    every document (its "previous token" belongs to another document).
    A document longer than a row is cut into rows of ``seq_len``; a
    piece goes into the first row with room for it."""
    rows: List[List[np.ndarray]] = []
    space: List[int] = []
    for doc in docs:
        doc = np.asarray(doc, np.int32)
        while doc.size > 0:
            fit = next((i for i, s in enumerate(space) if doc.size <= s),
                       None)
            if fit is not None:
                rows[fit].append(doc)
                space[fit] -= doc.size
                break
            piece = doc[:seq_len]
            rows.append([piece])
            space.append(seq_len - piece.size)
            doc = doc[seq_len:]

    n = len(rows)
    tokens = np.full((n, seq_len), pad_id, np.int32)
    mask = np.zeros((n, seq_len), np.float32)
    seg = np.zeros((n, seq_len), np.int32)
    for i, docs_i in enumerate(rows):
        off = 0
        for j, d in enumerate(docs_i):
            tokens[i, off:off + d.size] = d
            mask[i, off + 1:off + d.size] = 1.0   # no cross-doc supervision
            seg[i, off:off + d.size] = j + 1
            off += d.size
    return tokens, mask, seg
