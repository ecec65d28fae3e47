"""Distribution layer of the port: the straggler watchdog and the
heartbeat (``elastic``); sharding, compressed collectives and re-mesh
wait for mesh serving."""

from repro_torch.distributed.elastic import (  # noqa: F401
    Heartbeat,
    StepWatchdog,
    StragglerEvent,
)
