"""Training of the port (counterpart of :mod:`chainermn_tpu.training`):
the data-parallel train and eval steps, the trainer and the device
prefetcher."""

from chainermn_tpu_torch.training.prefetch import prefetch_to_device
from chainermn_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
    normalize_loss_fn,
)
from chainermn_tpu_torch.training.trainer import (
    Trainer,
    default_collate,
    host_local_batch_to_global,
)

__all__ = ["TrainState", "Trainer", "create_train_state", "default_collate",
           "host_local_batch_to_global", "make_eval_step", "make_train_step",
           "normalize_loss_fn", "prefetch_to_device"]
