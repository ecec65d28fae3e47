"""Serving stack of the port: ``engine`` (``ServeEngine``), ``sampler``
(greedy and sampled decoding), ``prng`` (``jax.random``'s threefry draws),
``quant`` (serving-precision cast), ``spec`` (speculative decoding:
``SpecConfig`` and the drafting side), ``admission`` (bounded queue,
policies, deadlines, scheduling), ``faults`` (fault injection) and
``traffic`` (seeded arrival traces and their replay)."""

from repro_torch.serve.admission import (  # noqa: F401
    POLICIES, SCHEDULERS, AdmissionConfig, AdmissionQueue, QueueFull)
from repro_torch.serve.engine import (  # noqa: F401
    EMIT_FAULT, EMIT_NONE, EMIT_TOKEN, STATUSES, GenerationResult,
    ServeEngine)
from repro_torch.serve.faults import FAULT_KINDS  # noqa: F401
from repro_torch.serve.spec import SpecConfig  # noqa: F401
from repro_torch.serve.quant import quantize_params  # noqa: F401
from repro_torch.serve.traffic import (  # noqa: F401
    Arrival, Scenario, ScenarioReport, bursty_trace, overload_ramp_trace,
    poisson_trace, replay)
