"""Deterministic synthetic prompts on the host (the port's copy of
``repro.data.synthetic.host_prompt`` for the ``affine`` task, the one
serving traces use).

``affine``: t_{i+1} = (a * t_i + b) mod v on a reduced vocab, with the
reference ``SyntheticConfig``'s defaults for a, b and v.  The draw is
numpy's ``default_rng(seed)`` in the reference's order, so a trace built
from these prompts is token for token the reference's.
"""

from __future__ import annotations

import numpy as np

AFFINE_A = 5
AFFINE_B = 17
AFFINE_VOCAB = 97                 # prime => full cycle


def host_prompt(length: int, seed: int, vocab_size: int) -> list:
    """One deterministic prompt as a list of ints (what
    ``ServeEngine.submit`` takes)."""
    if length < 1:
        raise ValueError("prompt length must be >= 1")
    rng = np.random.default_rng(seed)
    v = min(AFFINE_VOCAB, vocab_size)
    t = int(rng.integers(0, v))
    out = [t]
    for _ in range(length - 1):
        t = (AFFINE_A * t + AFFINE_B) % v
        out.append(t)
    return out
