"""The multi-node optimizer wrapper (counterpart of
``chainermn_tpu/optimizers.py``'s ``MultiNodeOptimizer`` and
``create_multi_node_optimizer``).

The wrapper holds a ``torch.optim.Optimizer`` and a communicator.
``step()`` averages every parameter's ``.grad`` over the ranks through
``comm.allreduce_grad`` (on the wire dtype), then steps the inner
optimizer. ``double_buffering=True`` keeps the JAX package's staleness-1
semantics exactly: each step applies the gradients reduced at the
previous step (zeros at the first step, still run through the inner
optimizer) and banks this step's reduced gradients for the next.
:meth:`MultiNodeOptimizer.state_dict` carries the inner optimizer's state
and that bank, as the JAX ``opt_state`` carries the stale gradient, so a
resumed run applies the same gradients as one that never stopped.

Left for later (ROADMAP queue 3.3, optimizer and reduction):
``error_feedback`` and ``reduction_schedule`` (the four schedules,
``'zero'`` among them, and ``'auto'``), which raise
``NotImplementedError``, and ``LocalSGDOptimizer`` / ``create_local_sgd``.

:func:`inner_transform` unwraps a wrapper into the factory of its inner
optimizer, which a :class:`~chainermn_tpu_torch.parallel.plan.
ParallelPlan` builds over its own update groups.
"""

from __future__ import annotations

import inspect

import torch

from chainermn_tpu_torch.communicators.base import (
    CommunicatorBase,
    _wire_dtype,
)


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 3.3, optimizer and "
        "reduction)")


class MultiNodeOptimizer:
    """A ``torch.optim.Optimizer`` whose ``step()`` first reduces the
    gradients over the communicator. Unknown attributes (``param_groups``,
    ``state``, ``zero_grad``, ...) are the inner optimizer's."""

    #: protocol marker for make_train_step: this wrapper reduces the
    #: gradients itself, so the step must not reduce them again
    handles_cross_rank_sync = True

    def __init__(self, actual_optimizer: torch.optim.Optimizer,
                 communicator: CommunicatorBase, *,
                 double_buffering: bool = False, compress_dtype=None,
                 error_feedback: bool = False,
                 reduction_schedule=None) -> None:
        if error_feedback:
            raise _later("error_feedback (EF-SGD over the int8 wire)")
        if reduction_schedule is not None:
            raise _later(f"reduction_schedule={reduction_schedule!r}")
        self.actual_optimizer = actual_optimizer
        self.communicator = communicator
        self.double_buffering = double_buffering
        # None falls back to the communicator's wire, as in the JAX
        # wrapper
        self.compress_dtype = (communicator.allreduce_grad_dtype
                               if compress_dtype is None
                               else _wire_dtype(compress_dtype))
        #: the gradients reduced at the previous step (double buffering)
        self._bank = None

    def _params(self) -> list:
        return [p for g in self.actual_optimizer.param_groups
                for p in g["params"]]

    @torch.no_grad()
    def step(self) -> None:
        params = self._params()
        self.communicator.allreduce_grad(params, dtype=self.compress_dtype)
        if self.double_buffering:
            # staleness 1: apply last step's reduced gradients (zeros at
            # the first step), bank this step's
            if self._bank is None:
                self._bank = [torch.zeros_like(p) for p in params]
            for i, p in enumerate(params):
                p.grad, self._bank[i] = self._bank[i], p.grad
        self.actual_optimizer.step()

    def state_dict(self) -> dict:
        """``{"actual_optimizer": inner.state_dict(), "bank": ...}``. The
        bank is the list of gradients reduced at the last step with
        double buffering (zeros before the first step: what that step
        applies), None without it."""
        bank = None
        if self.double_buffering:
            bank = (self._bank if self._bank is not None
                    else [torch.zeros_like(p) for p in self._params()])
        return {"actual_optimizer": self.actual_optimizer.state_dict(),
                "bank": bank}

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore :meth:`state_dict`'s output: the inner optimizer's
        state, and the bank copied onto each parameter's device."""
        bank = state_dict["bank"]
        if (bank is None) != (not self.double_buffering):
            raise ValueError(
                f"the state's bank is {'absent' if bank is None else 'present'}"
                f" but this optimizer has double_buffering="
                f"{self.double_buffering}")
        params = self._params()
        if bank is not None:
            if len(bank) != len(params):
                raise ValueError(f"the state banks {len(bank)} gradients for "
                                 f"{len(params)} parameters")
            for b, p in zip(bank, params):
                if b.shape != p.shape:
                    raise ValueError(f"a banked gradient of shape "
                                     f"{tuple(b.shape)} for a parameter of "
                                     f"shape {tuple(p.shape)}")
            self._bank = [b.to(device=p.device, dtype=p.dtype, copy=True)
                          for b, p in zip(bank, params)]
        self.actual_optimizer.load_state_dict(state_dict["actual_optimizer"])

    def __getattr__(self, item):
        # Guard against re-entry while __dict__ is still empty (copy,
        # unpickling).
        if item.startswith("__") or "actual_optimizer" not in self.__dict__:
            raise AttributeError(item)
        return getattr(self.actual_optimizer, item)


def inner_transform(optimizer):
    """The plain optimizer factory a :class:`~chainermn_tpu_torch.parallel.
    plan.ParallelPlan` composes: ``make_inner(params) -> Optimizer``.

    A plan owns the whole reduction (its spec providers say which
    collective each axis owes the step) and builds one inner optimizer
    per update group over the tensors that group updates, so it takes a
    factory, as :func:`~chainermn_tpu_torch.parallel.zero.
    zero_shard_optimizer` does. A :class:`MultiNodeOptimizer` is unwrapped
    into a factory of its inner optimizer's class with its defaults (the
    JAX function returns the inner optax transform); wrappers whose
    semantics live in the wrapper itself (double buffering's staleness
    bank, error feedback, a compressed wire) are refused loudly rather
    than silently dropped. A factory (any other callable) passes through;
    a bare ``torch.optim.Optimizer`` instance is unwrapped like the
    wrapper's inner one."""
    if isinstance(optimizer, MultiNodeOptimizer):
        if optimizer.double_buffering or getattr(optimizer,
                                                 "error_feedback", False):
            raise ValueError(
                "a ParallelPlan composes its own reduction; "
                "double_buffering/error_feedback live in the wrapper's "
                "wire and cannot ride a plan-compiled step — pass the "
                "plain inner optimizer")
        if optimizer.compress_dtype is not None:
            raise ValueError(
                "a ParallelPlan reduces in full precision; the wrapper's "
                f"compressed wire (allreduce_grad_dtype="
                f"{str(optimizer.compress_dtype).replace('torch.', '')}) "
                "would be silently dropped — pass the plain inner "
                "optimizer, or keep this call site on the communicator path")
        optimizer = optimizer.actual_optimizer
    if isinstance(optimizer, torch.optim.Optimizer):
        cls = type(optimizer)
        # the defaults the constructor takes (AdamW keeps a
        # ``decoupled_weight_decay`` default that its constructor fixes)
        takes = inspect.signature(cls.__init__).parameters
        defaults = {k: v for k, v in optimizer.defaults.items()
                    if k in takes}

        def make_inner(params):
            return cls(params, **defaults)

        make_inner.optimizer_class = cls
        make_inner.defaults = defaults
        return make_inner
    if not callable(optimizer):
        raise TypeError(f"a ParallelPlan takes an optimizer factory "
                        f"make_inner(params) -> torch.optim.Optimizer, got "
                        f"{type(optimizer).__name__}")
    return optimizer


def create_multi_node_optimizer(actual_optimizer: torch.optim.Optimizer,
                                communicator: CommunicatorBase, *,
                                double_buffering: bool = False,
                                allreduce_grad_dtype=None,
                                error_feedback: bool = False,
                                reduction_schedule=None
                                ) -> MultiNodeOptimizer:
    """Factory mirroring the reference signature
    (``create_multi_node_optimizer(opt, comm, double_buffering)``)."""
    return MultiNodeOptimizer(
        actual_optimizer, communicator, double_buffering=double_buffering,
        compress_dtype=allreduce_grad_dtype, error_feedback=error_feedback,
        reduction_schedule=reduction_schedule)


__all__ = ["MultiNodeOptimizer", "create_multi_node_optimizer",
           "inner_transform"]
