"""Microbenchmark probe suite — the paper's §IV-§VI on the card
(counterpart of ``repro.core.probes``):

* :mod:`repro_torch.core.probes.compute`   — §IV: true / completion
  latency, ILP ramp, fp64 factor (Tab III, Fig 2/3), in the ``dep_chain``
  kernel
* :mod:`repro_torch.core.probes.memory`    — §VI: pointer chase (the
  ``chase`` kernel), stride sweep, streaming bandwidth, concurrency
  scaling (Fig 6-10)
* :mod:`repro_torch.core.probes.matmul`    — §V: tile sweep and warp x
  ILP scaling (Fig 4/5, Tab VII), in the ``mma_probe`` kernel
* :mod:`repro_torch.core.probes.precision` — §V.A-C: FP4/FP6/FP8 support
  matrix, numerics, block scaling (Tab IV/V)

The reference's ``collectives`` probe is not ported yet.
"""

from repro_torch.core.probes import (  # noqa: F401
    compute,
    matmul,
    memory,
    precision,
)
