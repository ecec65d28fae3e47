"""Training of the port (counterpart of ``repro.train``): loss, train
step (gradient accumulation, block remat), loop.  The local
data-parallel step waits for mesh serving."""

from repro_torch.train.step import (  # noqa: F401
    chunked_cross_entropy,
    cross_entropy_loss,
    make_loss_fn,
    make_train_step,
    train_state_init,
)
from repro_torch.train.loop import TrainLoopConfig, run_train_loop  # noqa: F401
