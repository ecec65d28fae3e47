"""Token sampling (counterpart of ``repro.serve.sampler``): fp32 logits
in, int32 tokens out.  Greedy only in this slice: sampled decoding needs
the reference's threefry ``fold_in``/``categorical`` bit for bit, which
arrives with its own slice."""

from __future__ import annotations

import torch


def check_temperature(temperature: float) -> None:
    if temperature > 0.0:
        raise NotImplementedError(
            f"temperature={temperature}: sampled decoding waits for the "
            f"threefry port; this slice decodes greedily (temperature 0)")


def sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy: logits (b, v) -> tokens (b,) int32.  ``argmax`` returns
    the first maximal index on ties, as ``jnp.argmax`` does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
