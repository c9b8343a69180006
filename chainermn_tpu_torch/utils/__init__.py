"""Utilities of the port (counterpart of :mod:`chainermn_tpu.utils`): the
preemption guard so far."""

from chainermn_tpu_torch.utils.preemption import (
    PreemptionGuard,
    install_preemption_guard,
)

__all__ = ["PreemptionGuard", "install_preemption_guard"]
