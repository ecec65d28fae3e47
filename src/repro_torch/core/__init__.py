"""Core library of the port: the paper's microbenchmark-driven device
characterization (counterpart of ``repro.core``): device models, the
timing layer and the probe suite.  ``hlo_analysis`` and ``roofline``
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
from repro_torch.core.timing import (  # noqa: F401
    TimingResult, time_fn, timer_overhead)
