"""Optimizers of the port (counterpart of ``repro.optim``): AdamW with
precision / memory knobs, updated in place."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    Schedule,
    adamw_init,
    adamw_update,
    global_norm,
)
