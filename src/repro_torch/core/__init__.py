"""Core library of the port: the paper's microbenchmark-driven device
characterization (counterpart of ``repro.core``): device models, the
energy model (``energy``), the timing layer, the card's power and energy
readings (``nvml``) and the probe suite.  ``hlo_analysis`` and ``roofline``
are XLA-only and have no counterpart here."""

from repro_torch.core.device_model import (  # noqa: F401
    DeviceModel,
    GB203,
    GH100,
    H100_SXM,
    HOST_CPU,
    MemoryLevel,
    PAPER_GH100,
    REGISTRY,
    TPU_V5E,
    detect_backend_model,
    get_device_model,
)
from repro_torch.core.energy import (  # noqa: F401
    ENERGY_PER_BYTE_PJ, ENERGY_PER_FLOP_PJ, EnergyEstimate, estimate,
    matmul_energy)
from repro_torch.core.timing import (  # noqa: F401
    TimingResult, time_fn, timer_overhead)
