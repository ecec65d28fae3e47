"""Serving stack of the port: ``engine`` (``ServeEngine``), ``sampler``
(greedy and sampled decoding), ``prng`` (``jax.random``'s threefry draws)
and ``quant`` (serving-precision cast)."""

from repro_torch.serve.engine import (  # noqa: F401
    EMIT_FAULT, EMIT_NONE, EMIT_TOKEN, STATUSES, GenerationResult,
    ServeEngine)
from repro_torch.serve.quant import quantize_params  # noqa: F401
