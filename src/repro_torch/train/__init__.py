"""Training of the port (counterpart of ``repro.train``): loss, train
step (gradient accumulation, block remat), loop, and the explicit
data-parallel step over a process group (``local_dp``)."""

from repro_torch.train.step import (  # noqa: F401
    chunked_cross_entropy,
    cross_entropy_loss,
    make_loss_fn,
    make_train_step,
    train_state_init,
)
from repro_torch.train.loop import TrainLoopConfig, run_train_loop  # noqa: F401
from repro_torch.train.local_dp import make_local_dp_train_step  # noqa: F401
