"""Distribution layer of the port: the straggler watchdog and the
heartbeat (``elastic``), and the int8 stochastic-rounding gradient mean
over a ``torch.distributed`` process group (``compression``).  Sharding
and re-mesh (``remesh``, ``opt_state_specs``) wait for mesh serving."""

from repro_torch.distributed.compression import (  # noqa: F401
    compressed_psum,
    compressed_psum_tree,
    quantize,
    stochastic_round,
)
from repro_torch.distributed.elastic import (  # noqa: F401
    Heartbeat,
    StepWatchdog,
    StragglerEvent,
)
