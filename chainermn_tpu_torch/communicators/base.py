"""A communicator over a ``torch.distributed`` process group, one rank per
process (counterpart of ``chainermn_tpu/communicators/base.py``'s
``CommunicatorBase``; the reference ChainerMN's one-process-per-device
model rather than the JAX package's one controller per host).

What is ported: ``rank``/``size``/``intra_rank``/``intra_size``,
``bcast_data``, ``allreduce_grad`` with the compressed wire
(``allreduce_grad_dtype`` ``'bfloat16'``/``'float16'``/None),
``allreduce_mean``, ``barrier`` and the object calls ``bcast_obj``,
``gather_obj``, ``allgather_obj`` and ``allreduce_obj``. When no default
process group exists, the communicator makes a one-rank group in this
process over an in-process ``HashStore``; several ranks come from
:func:`chainermn_tpu_torch.testing.run_distributed` (gloo) or from any
launcher that initialises the default group first.

Left for later (ROADMAP queue 3.2, communicators): the int8 wire,
``split``, tagged send/recv, the array collectives and the trace
``wire`` events.
"""

from __future__ import annotations

import socket
import sys
from typing import Any, Callable, Iterable, Optional, Union

import torch
import torch.distributed as dist
from torch import nn

from chainermn_tpu_torch._device import resolve_device

_WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": None}
#: ``allreduce_grad``'s default: the communicator's own wire dtype
COMM_WIRE = object()


def _wire_dtype(name) -> Optional[torch.dtype]:
    """``allreduce_grad_dtype`` as a torch dtype (None: the fp32 wire)."""
    if name is None or isinstance(name, torch.dtype):
        return None if name in (None, torch.float32) else name
    if name in ("int8", "auto"):
        raise NotImplementedError(
            f"allreduce_grad_dtype={name!r} is not ported yet (ROADMAP queue "
            "3.3, optimizer and reduction: the int8 wire and the tuned "
            "'auto' wire)")
    if name not in _WIRE_DTYPES:
        raise ValueError(f"allreduce_grad_dtype must be one of "
                         f"{sorted(_WIRE_DTYPES)} or None, got {name!r}")
    return _WIRE_DTYPES[name]


def _params_of(model) -> list:
    if isinstance(model, nn.Module):
        return list(model.parameters())
    return list(model)


class CommunicatorBase:
    """One rank of a ``torch.distributed`` group.

    ``backend`` is ``'gloo'`` (CPU tensors) or ``'nccl'`` (CUDA tensors).
    ``packed=True`` reduces all gradients as ONE flat buffer per call (the
    reference pure_nccl design); ``packed=False`` reduces parameter by
    parameter (the reference naive design).
    """

    name = "base"

    def __init__(self, backend: str, *, packed: bool,
                 allreduce_grad_dtype=None, device=None) -> None:
        if backend == "nccl":
            # never a quiet fallback to gloo: the NCCL names need the card
            self.device = resolve_device(device)
            if self.device.type != "cuda" or not dist.is_nccl_available():
                raise RuntimeError(
                    f"communicator {self.name!r} runs NCCL on a CUDA device; "
                    f"got device {self.device} (NCCL available: "
                    f"{dist.is_nccl_available()}) — use 'naive' for gloo on "
                    "the CPU")
        elif backend == "gloo":
            self.device = torch.device("cpu" if device is None else device)
            if self.device.type != "cpu":
                raise ValueError(f"communicator {self.name!r} runs gloo on "
                                 f"CPU tensors, got device={device}")
        else:
            raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                             f"{backend!r}")
        self.backend = backend
        self.packed = packed
        self.allreduce_grad_dtype = _wire_dtype(allreduce_grad_dtype)
        self.group = self._process_group(backend)
        self._intra = None

    def _process_group(self, backend: str):
        """The default group when it speaks ``backend``; a one-rank
        default group over an in-process store when there is none; else
        a new group of the default group's ranks on ``backend``."""
        if not dist.is_initialized():
            # torch wraps sys.excepthook with a rank prefix; a one-rank
            # group made for this process alone leaves the process's own
            # hook in place
            hook = sys.excepthook
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
            sys.excepthook = hook
            return dist.group.WORLD
        if dist.get_backend() == backend:
            return dist.group.WORLD
        return dist.new_group(backend=backend)

    # ------------------------------------------------------------- topology

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    def _intra_ranks(self) -> tuple:
        """(position among the ranks on this host, ranks on this host),
        from a hostname exchange (the reference's ``init_ranks``)."""
        if self._intra is None:
            if self.size == 1:
                self._intra = (0, 1)
            else:
                names = [None] * self.size
                dist.all_gather_object(names, socket.gethostname(),
                                       group=self.group)
                mine = names[self.rank]
                same = [r for r, n in enumerate(names) if n == mine]
                self._intra = (same.index(self.rank), len(same))
        return self._intra

    @property
    def intra_rank(self) -> int:
        return self._intra_ranks()[0]

    @property
    def intra_size(self) -> int:
        return self._intra_ranks()[1]

    @property
    def host(self) -> "CommunicatorBase":
        """The host plane of the JAX package's communicator. One rank
        per device here, so the host plane is the communicator itself
        (``host.size == size``)."""
        return self

    def __repr__(self) -> str:
        wire = self.allreduce_grad_dtype
        return (f"{type(self).__name__}(name={self.name!r}, backend="
                f"{self.backend!r}, rank={self.rank}, size={self.size}, "
                f"wire={'float32' if wire is None else str(wire)[6:]})")

    # ------------------------------------------------------------- model ops

    def _check_device(self, t: torch.Tensor, what: str) -> None:
        if t.device.type != self.device.type:
            raise ValueError(f"{what} is on {t.device}; communicator "
                             f"{self.name!r} reduces {self.device.type} "
                             "tensors")

    def bcast_data(self, model: Union[nn.Module, Iterable], root: int = 0):
        """Broadcast every parameter (and buffer) from rank ``root`` in
        place, so all ranks start from the same weights."""
        tensors = _params_of(model)
        if isinstance(model, nn.Module):
            tensors += list(model.buffers())
        with torch.no_grad():
            for t in tensors:
                self._check_device(t, "a parameter")
                dist.broadcast(t.data, src=root, group=self.group)
        return model

    def allreduce_grad(self, model: Union[nn.Module, Iterable], *,
                       dtype=COMM_WIRE) -> None:
        """Average every parameter's ``.grad`` over the ranks, in place.

        The gradients are cast to the wire dtype (``dtype``, by default
        the communicator's ``allreduce_grad_dtype``; None is fp32), summed
        with ``all_reduce``, divided by ``size`` in the wire dtype and cast
        back — packed into one flat buffer, or parameter by parameter
        when the communicator is not packed. At size 1 the values still
        round through the wire dtype. A parameter without a gradient
        gets zeros first, as the JAX step differentiates every leaf.
        """
        wire = (self.allreduce_grad_dtype if dtype is COMM_WIRE
                else _wire_dtype(dtype))
        params = _params_of(model)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            self._check_device(p.grad, "a gradient")
        grads = [p.grad for p in params]
        if not grads:
            return
        with torch.no_grad():
            if self.packed:
                buf = torch.cat([g.reshape(-1).to(wire or g.dtype)
                                 for g in grads])
                dist.all_reduce(buf, group=self.group)
                buf.div_(self.size)
                off = 0
                for g in grads:
                    n = g.numel()
                    g.copy_(buf[off:off + n].view_as(g))
                    off += n
            else:
                for g in grads:
                    w = g.to(wire or g.dtype)
                    dist.all_reduce(w, group=self.group)
                    g.copy_(w.div_(self.size))

    def allreduce_mean(self, values: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of a small fp32 vector (metrics)."""
        buf = values.detach().to(self.device, torch.float32)
        dist.all_reduce(buf, group=self.group)
        return buf.div_(self.size).to(values.device)

    # ------------------------------------------------------- object calls

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        """``obj`` of rank ``root`` on every rank (pickled)."""
        box = [obj]
        dist.broadcast_object_list(box, src=root, group=self.group)
        return box[0]

    def allgather_obj(self, obj: Any) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def gather_obj(self, obj: Any, root: int = 0) -> Optional[list]:
        """Every rank's ``obj`` on ``root``; None on the other ranks."""
        everyone = self.allgather_obj(obj)
        return everyone if self.rank == root else None

    def allreduce_obj(self, obj: Any,
                      op: Optional[Callable[[Any, Any], Any]] = None) -> Any:
        """Reduce python objects over the ranks, in rank order. The
        default ``op`` sums numbers, and dicts, lists and tuples of them
        element-wise (the multi-node evaluator's use)."""
        items = self.allgather_obj(obj)
        op = _default_sum if op is None else op
        out = items[0]
        for item in items[1:]:
            out = op(out, item)
        return out

    def barrier(self) -> None:
        """Block until every rank arrives (one all_reduce of one value
        on the communicator's device)."""
        dist.all_reduce(torch.zeros(1, device=self.device), group=self.group)


def _default_sum(a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _default_sum(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_default_sum(x, y) for x, y in zip(a, b))
    return a + b
