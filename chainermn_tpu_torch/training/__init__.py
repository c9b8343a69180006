"""Training of the port (counterpart of :mod:`chainermn_tpu.training`):
the data-parallel train step so far."""

from chainermn_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_train_step,
    normalize_loss_fn,
)

__all__ = ["TrainState", "create_train_state", "make_train_step",
           "normalize_loss_fn"]
