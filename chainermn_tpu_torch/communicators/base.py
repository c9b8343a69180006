"""A communicator over a ``torch.distributed`` process group, one rank per
process (counterpart of ``chainermn_tpu/communicators/base.py``'s
``CommunicatorBase``; the reference ChainerMN's one-process-per-device
model rather than the JAX package's one controller per host).

The topology: ``rank``/``size``, ``intra_rank``/``intra_size`` (the
ranks on this host) and ``inter_rank``/``inter_size`` (the hosts), from
one hostname exchange; ``grad_axes``, the groups gradients are averaged
over (this group; ``('inter', 'intra')`` under the hierarchical
communicators of :mod:`~chainermn_tpu_torch.communicators.
xla_communicator`), and ``axis_names``/``axis_groups``, the same axes by
name (``('data',)`` here), which composed reduction schedules spell.

The model calls: ``bcast_data`` and ``allreduce_grad`` with the
compressed wire (``allreduce_grad_dtype`` ``'bfloat16'``/``'float16'``,
``'int8'`` — the two-phase quantized wire, per gradient — or None),
``allreduce_mean``, ``barrier``.

The array collectives ``allreduce``, ``bcast``, ``allgather``,
``alltoall`` and ``scatter`` take THIS rank's tensor (the JAX
package's eager forms take the stacked ``[size, ...]`` contributions of
every rank, its single-controller convention). The object collectives
``bcast_obj``, ``gather_obj``, ``allgather_obj``, ``scatter_obj`` and
``allreduce_obj`` are pickled.

The point-to-point plane — ``send``/``recv`` of a tensor, a numpy array
or a tuple of them (dtypes kept exactly, int64 and bfloat16 included),
``send_obj``/``recv_obj``, ``probe``, ``ANY_SOURCE`` and
``recv_any_obj`` — runs over a gloo group of the same ranks, even when
the gradient group is NCCL (NCCL has no any-source receive and no tags).
Each message is announced in the default group's store under ``(source,
destination, tag, sequence)`` and its bytes follow over gloo: so
``probe`` checks for an announcement without consuming it, a receive
from ``ANY_SOURCE`` polls the sources in rank order, and tags match
exactly. Sends to this rank itself stay in a local mailbox. Arrays and
objects cross through the host, as the reference's non-CUDA-aware
path did.

``split(color, key)`` makes every colour's group on every rank in one
fixed order (``new_group`` is collective over the world);
``sub_communicator(ranks)`` makes one.

When no default process group exists, the communicator makes a one-rank
group in this process over an in-process ``HashStore``; several ranks
come from :func:`chainermn_tpu_torch.testing.run_distributed` (gloo) or
from any launcher that initialises the default group first.

Left for later: the ``'auto'`` wire and the trace ``wire`` events and
flight marker (ROADMAP queue 8).
"""

from __future__ import annotations

import collections
import pickle
import socket
import sys
import time
from typing import Any, Callable, Iterable, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from chainermn_tpu_torch._device import resolve_device

#: wildcard source of ``recv``/``recv_obj``/``probe`` (``MPI.ANY_SOURCE``)
ANY_SOURCE = -1

_WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "int8": torch.int8, "float32": None}
#: ``allreduce_grad``'s default: the communicator's own wire dtype
COMM_WIRE = object()


def _wire_dtype(name) -> Optional[torch.dtype]:
    """``allreduce_grad_dtype`` as a torch dtype (None: the fp32 wire)."""
    if name is None or isinstance(name, torch.dtype):
        return None if name in (None, torch.float32) else name
    if name == "auto":
        raise NotImplementedError(
            "allreduce_grad_dtype='auto' is not ported yet (ROADMAP queue 8, "
            "tuning: the wire resolved through the registry)")
    if name not in _WIRE_DTYPES:
        raise ValueError(f"allreduce_grad_dtype must be one of "
                         f"{sorted(_WIRE_DTYPES)} or None, got {name!r}")
    return _WIRE_DTYPES[name]


def _params_of(model) -> list:
    if isinstance(model, nn.Module):
        return list(model.parameters())
    return list(model)


def _store():
    return dist.distributed_c10d._get_default_store()


#: per-process message counters of the point-to-point plane, by
#: (plane, peer, tag) — shared by every communicator of one group
_SEQ: collections.Counter = collections.Counter()


class CommunicatorBase:
    """One rank of a ``torch.distributed`` group.

    ``backend`` is ``'gloo'`` or ``'nccl'`` (CUDA tensors). gloo reduces
    CPU tensors, and CUDA tensors too where a subclass allows it
    (``gloo_on_cuda``: through host copies). ``packed=True`` reduces all
    gradients as ONE flat buffer per call (the reference pure_nccl
    design); ``packed=False`` reduces parameter by parameter (the
    reference naive design).
    """

    name = "base"
    #: whether gloo may reduce CUDA tensors (through host copies)
    gloo_on_cuda = False

    def __init__(self, backend: str, *, packed: bool,
                 allreduce_grad_dtype=None, device=None,
                 _groups=None) -> None:
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
            if self.device.type != "cpu" and not (
                    self.gloo_on_cuda and self.device.type == "cuda"):
                raise ValueError(f"communicator {self.name!r} runs gloo on "
                                 f"CPU tensors, got device={device}")
        else:
            raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                             f"{backend!r}")
        self.backend = backend
        self.packed = packed
        self.allreduce_grad_dtype = _wire_dtype(allreduce_grad_dtype)
        if _groups is None:
            self.group = self._process_group(backend)
            self._p2p = self._p2p_group(None)
        else:
            self.group, self._p2p = _groups
        self._intra = None
        self._hosts = None
        self._mailbox: dict = collections.defaultdict(collections.deque)
        self._sends: list = []

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

    def _p2p_group(self, ranks: Optional[list]):
        """The gloo group of the point-to-point plane: the group itself
        when it is gloo; none for one rank; else a new gloo group of the
        same ranks (collective over the world, as every ``new_group``)."""
        if self.backend == "gloo":
            return self.group
        n = dist.get_world_size() if ranks is None else len(ranks)
        if n == 1:
            return None
        return dist.new_group(ranks, backend="gloo")

    # ------------------------------------------------------------- topology

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    def _global(self, rank: int) -> int:
        """Rank ``rank`` of this communicator as a rank of the default
        group (what ``torch.distributed``'s ``src``/``dst`` take)."""
        if self.group is None or self.group is dist.group.WORLD:
            return rank
        return dist.get_global_rank(self.group, rank)

    @property
    def global_ranks(self) -> list:
        """This communicator's ranks as default-group ranks, in order."""
        return [self._global(r) for r in range(self.size)]

    def _host_names(self) -> list:
        """Every rank's hostname, in rank order (one exchange)."""
        if self._hosts is None:
            if self.size == 1:
                self._hosts = [socket.gethostname()]
            else:
                names = [None] * self.size
                dist.all_gather_object(names, socket.gethostname(),
                                       group=self.group)
                self._hosts = names
        return self._hosts

    def _intra_ranks(self) -> tuple:
        """(position among the ranks on this host, ranks on this host),
        from a hostname exchange (the reference's ``init_ranks``)."""
        if self._intra is None:
            names = self._host_names()
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
    def inter_rank(self) -> int:
        """This rank's host among the hosts, in order of their first
        rank (the reference's node index)."""
        names = self._host_names()
        hosts = list(dict.fromkeys(names))
        return hosts.index(names[self.rank])

    @property
    def inter_size(self) -> int:
        """The number of hosts (the reference's node count)."""
        return len(set(self._host_names()))

    @property
    def axis_groups(self):
        """The axes gradients are averaged over, by name, bound to their
        groups (a :class:`~chainermn_tpu_torch.parallel.collectives.
        AxisGroups`): the names a composition's stages speak. Here one
        ``'data'`` axis, this communicator's group, as the JAX
        communicator's ``grad_axes`` names it."""
        from chainermn_tpu_torch.parallel.collectives import AxisGroups

        return AxisGroups(("data",), (self.group,))

    @property
    def axis_names(self) -> tuple:
        """The names of :attr:`axis_groups`, in mesh order."""
        return self.axis_groups.names

    @property
    def grad_axes(self) -> tuple:
        """:attr:`axis_groups`' groups merged in mesh order (a
        :class:`~chainermn_tpu_torch.parallel.collectives.MergedAxes`
        with their product, this communicator's group, when there are
        several)."""
        return self.axis_groups.merged(self.axis_names)

    #: ``(intra, inter)`` groups of a pinned two-level reduction, or None
    two_level_axes = None

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
        from chainermn_tpu_torch.parallel import collectives as C

        tensors = _params_of(model)
        if isinstance(model, nn.Module):
            tensors += list(model.buffers())
        with torch.no_grad():
            for t in tensors:
                self._check_device(t, "a parameter")
                t.data.copy_(C._host_staged(C._bcast, t.data, self.group,
                                            root))
        return model

    def _wire(self, dtype) -> Optional[torch.dtype]:
        return (self.allreduce_grad_dtype if dtype is COMM_WIRE
                else _wire_dtype(dtype))

    def _grads(self, model) -> list:
        params = _params_of(model)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            self._check_device(p.grad, "a gradient")
        return [p.grad for p in params]

    def allreduce_grad(self, model: Union[nn.Module, Iterable], *,
                       dtype=COMM_WIRE) -> None:
        """Average every parameter's ``.grad`` over the ranks, in place.

        The gradients are cast to the wire dtype (``dtype``, by default
        the communicator's ``allreduce_grad_dtype``; None is fp32), summed
        with ``all_reduce``, divided by ``size`` in the wire dtype and cast
        back — packed into one flat buffer, or parameter by parameter
        when the communicator is not packed. At size 1 the values still
        round through the wire dtype. The int8 wire reduces each floating
        gradient on its own (its scales are per gradient), through
        :func:`~chainermn_tpu_torch.parallel.collectives.
        int8_allreduce_mean` over ``grad_axes``, exact at size 1. A
        parameter without a gradient gets zeros first, as the JAX step
        differentiates every leaf.
        """
        wire = self._wire(dtype)
        grads = self._grads(model)
        if not grads:
            return
        with torch.no_grad():
            if wire == torch.int8:
                self._reduce_int8_per_leaf(grads)
            else:
                self._reduce(grads, wire)

    def _reduce_int8_per_leaf(self, grads: list) -> None:
        from chainermn_tpu_torch.parallel import collectives as C

        axes = C._axes(self.grad_axes)
        for g in grads:
            g.copy_(C._int8_core(g, axes)[0])

    def _reduce(self, grads: list, wire) -> None:
        """The base strategy: one all-reduce mean of every gradient on
        ``wire`` (packed, or gradient by gradient)."""
        from chainermn_tpu_torch.parallel import collectives as C

        if self.packed:
            buf = torch.cat([g.reshape(-1).to(wire or g.dtype)
                             for g in grads])
            buf = C._host_staged(C._all_reduce, buf, self.group,
                                 inplace=True).div_(self.size)
            off = 0
            for g in grads:
                n = g.numel()
                g.copy_(buf[off:off + n].view_as(g))
                off += n
        else:
            for g in grads:
                w = C._host_staged(C._all_reduce, g.to(wire or g.dtype),
                                   self.group, inplace=True)
                g.copy_(w.div_(self.size))

    def allreduce_mean(self, values: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of a small fp32 vector (metrics)."""
        from chainermn_tpu_torch.parallel import collectives as C

        buf = values.detach().to(self.device, torch.float32)
        return (C._host_staged(C._all_reduce, buf, self.group)
                .div_(self.size).to(values.device))

    # ------------------------------------------------------ array calls

    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """This rank's ``x`` reduced over the ranks (``op``: 'sum',
        'mean', 'max', 'min'); a new tensor on every rank."""
        from chainermn_tpu_torch.parallel import collectives as C

        if op not in C._REDUCE_OPS:
            raise ValueError(f"unknown reduction op: {op!r}")
        return C._host_staged(C._all_reduce, x, self.group, op)

    def bcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Rank ``root``'s ``x`` on every rank (the others' ``x`` gives
        the shape and dtype)."""
        from chainermn_tpu_torch.parallel import collectives as C

        return C._host_staged(C._bcast, x, self.group, root)

    def allgather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x``, stacked ``[size, ...]`` in rank order."""
        from chainermn_tpu_torch.parallel import collectives as C

        return C._host_staged(C._all_gather, x, self.group, 0, False)

    def alltoall(self, x: torch.Tensor) -> torch.Tensor:
        """``x[j]`` (``x`` is ``[size, ...]``) goes to rank ``j``; row
        ``s`` of the result came from rank ``s`` (``MPI_Alltoall``)."""
        from chainermn_tpu_torch.parallel import collectives as C

        if x.dim() < 1 or x.shape[0] != self.size:
            raise ValueError(f"alltoall expects [size={self.size}, ...] "
                             f"input, got {tuple(x.shape)}")
        return C._host_staged(C._all_to_all, x, self.group, 0, 0, True)

    def scatter(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """``x[i]`` of rank ``root``'s ``x`` (``[size, ...]``) on rank
        ``i``; the other ranks' ``x`` gives the shape and dtype."""
        from chainermn_tpu_torch.parallel import collectives as C

        if x.dim() < 1 or x.shape[0] != self.size:
            raise ValueError(f"scatter expects [size={self.size}, ...] "
                             f"input, got {tuple(x.shape)}")
        return C._host_staged(C._scatter_from, x, self.group, root, 0,
                              False)

    # ------------------------------------------------------- object calls

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        """``obj`` of rank ``root`` on every rank (pickled)."""
        box = [obj]
        dist.broadcast_object_list(box, src=self._global(root),
                                   group=self.group)
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

    def scatter_obj(self, objs: Optional[Sequence[Any]],
                    root: int = 0) -> Any:
        """``objs[i]`` of rank ``root`` on rank ``i`` (the other ranks
        pass None)."""
        if self.rank == root and (objs is None or len(objs) != self.size):
            raise ValueError(f"scatter_obj needs {self.size} objects on "
                             f"the root, got {objs!r}")
        everyone = self.bcast_obj(list(objs) if self.rank == root else None,
                                  root)
        return everyone[self.rank]

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
        from chainermn_tpu_torch.parallel import collectives as C

        C._host_staged(C._all_reduce, torch.zeros(1, device=self.device),
                       self.group, inplace=True)

    # ------------------------------------------- the point-to-point plane

    def _key(self, src: int, dst: int, tag: int, seq: int) -> str:
        ns = ",".join(map(str, self.global_ranks))
        return f"cmn_p2p/{ns}/{src}>{dst}/t{tag}/{seq}"

    def _check_peer(self, peer: int, what: str) -> None:
        if not 0 <= peer < self.size:
            raise ValueError(f"{what} {peer} is not a rank of a "
                             f"communicator of {self.size}")

    def send_obj(self, obj: Any, dest: int, tag: int = 0) -> None:
        """Send a picklable ``obj`` to rank ``dest`` under ``tag``
        (announced in the store, its bytes over the gloo group; to this
        rank itself, into the local mailbox). Returns without waiting
        for the receive (the message waits, announced, until a receive
        takes it)."""
        self._check_peer(dest, "dest")
        data = pickle.dumps(obj)
        if dest == self.rank:
            self._mailbox[tag].append(data)
            return
        me, to = self._global(self.rank), self._global(dest)
        seq = _SEQ[("send", self._key(me, to, tag, ""))]
        _SEQ[("send", self._key(me, to, tag, ""))] += 1
        gtag = 1 + _SEQ[("gloo", self._key(me, to, 0, ""))] % (1 << 30)
        _SEQ[("gloo", self._key(me, to, 0, ""))] += 1
        payload = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        _store().set(self._key(me, to, tag, seq), f"{len(data)}:{gtag}")
        work = dist.isend(payload, dst=to, group=self._p2p, tag=gtag)
        self._sends = [(w, p) for w, p in self._sends
                       if not w.is_completed()] + [(work, payload)]

    def _announced(self, source: int, tag: int) -> Optional[str]:
        src, me = self._global(source), self._global(self.rank)
        key = self._key(src, me, tag, _SEQ[("recv", self._key(
            src, me, tag, ""))])
        return key if _store().check([key]) else None

    def _take(self, source: int, tag: int, key: Optional[str] = None):
        """Receive the next message of ``(source, tag)``, waiting for its
        announcement when ``key`` is None."""
        src, me = self._global(source), self._global(self.rank)
        counter = ("recv", self._key(src, me, tag, ""))
        if key is None:
            key = self._key(src, me, tag, _SEQ[counter])
        nbytes, gtag = map(int, _store().get(key).decode().split(":"))
        buf = torch.empty(nbytes, dtype=torch.uint8)
        dist.recv(buf, src=src, group=self._p2p, tag=gtag)
        _store().delete_key(key)
        _SEQ[counter] += 1
        return pickle.loads(buf.numpy().tobytes())

    def recv_obj(self, source: int, tag: int = 0) -> Any:
        """The next object rank ``source`` sent under ``tag`` (waiting for
        it); ``source=ANY_SOURCE`` takes the first one any rank sent."""
        if source == ANY_SOURCE:
            return self.recv_any_obj(tag)[1]
        self._check_peer(source, "source")
        if source == self.rank:
            box = self._mailbox.get(tag)
            if not box:
                raise RuntimeError(
                    f"recv_obj from this rank ({source}, tag {tag}) with no "
                    "message sent to itself first: it would wait forever")
            return pickle.loads(box.popleft())
        return self._take(source, tag)

    def probe(self, source: int, tag: int = 0) -> bool:
        """Whether a message from ``source`` (or ``ANY_SOURCE``) under
        ``tag`` is waiting (``MPI_Iprobe``): a check of its announcement,
        which leaves the message for the receive."""
        if source == ANY_SOURCE:
            return any(self.probe(s, tag) for s in range(self.size))
        self._check_peer(source, "source")
        if source == self.rank:
            return bool(self._mailbox.get(tag))
        return self._announced(source, tag) is not None

    def recv_any_obj(self, tag: int = 0, *,
                     poll_interval: float = 1e-3) -> tuple:
        """``(source, obj)`` of the first message under ``tag`` from any
        rank (``recv(source=MPI.ANY_SOURCE)``): this rank's mailbox
        first, then the other ranks in rank order, polled until one has
        announced a message."""
        while True:
            if self._mailbox.get(tag):
                return self.rank, pickle.loads(self._mailbox[tag].popleft())
            for s in range(self.size):
                if s == self.rank:
                    continue
                key = self._announced(s, tag)
                if key is not None:
                    return s, self._take(s, tag, key)
            if self.size == 1:
                raise RuntimeError(
                    "recv_any_obj with no message in this rank's mailbox "
                    "and no other rank: nothing can arrive")
            time.sleep(poll_interval)

    def send(self, x, dest: int, tag: int = 0) -> None:
        """Send a tensor, a numpy array, or a tuple or list of them to
        rank ``dest`` (``MpiCommunicatorBase.send``): shapes and dtypes
        travel with the bytes, so the receiver gets them exactly."""
        is_tuple = isinstance(x, (tuple, list))
        header, payloads = [], []
        for part in (list(x) if is_tuple else [x]):
            if isinstance(part, torch.Tensor):
                t = part.detach().cpu().contiguous()
                header.append(("torch", tuple(t.shape), str(t.dtype)[6:]))
                payloads.append(t.reshape(-1).view(torch.uint8).numpy()
                                .tobytes())
            else:
                a = np.ascontiguousarray(part)
                header.append(("numpy", a.shape, a.dtype.str))
                payloads.append(a.tobytes())
        self.send_obj(("array", is_tuple, header, payloads), dest, tag)

    def recv(self, source: int, tag: int = 0):
        """The arrays rank ``source`` (or ``ANY_SOURCE``) sent under
        ``tag``: numpy arrays as numpy arrays, tensors as tensors on this
        communicator's device, a tuple when a tuple or list was sent."""
        msg = self.recv_obj(source, tag)
        if not (isinstance(msg, tuple) and msg and msg[0] == "array"):
            raise RuntimeError(
                "recv expected an array message, got an object (send_obj/"
                "send on one channel must meet recv_obj/recv in order)")
        _, is_tuple, header, payloads = msg
        out = []
        for (kind, shape, dt), buf in zip(header, payloads):
            if kind == "numpy":
                out.append(np.frombuffer(buf, dtype=np.dtype(dt))
                           .reshape(shape).copy())
            else:
                dtype = getattr(torch, dt)
                t = (torch.frombuffer(bytearray(buf), dtype=dtype)
                     if buf else torch.empty(0, dtype=dtype))
                out.append(t.reshape(shape).to(self.device))
        return tuple(out) if is_tuple else out[0]

    # ------------------------------------------------- sub-communicators

    def _sub(self, group, p2p) -> "CommunicatorBase":
        sub = _SplitCommunicator(
            self.backend, packed=self.packed, device=self.device,
            allreduce_grad_dtype=self.allreduce_grad_dtype,
            _groups=(group, p2p))
        return sub

    def _new_groups(self, ranks: list):
        """``(group, p2p group)`` over the default-group ranks ``ranks``,
        on this communicator's backend (collective over the world)."""
        group = dist.new_group(ranks, backend=self.backend)
        return group, self._p2p_group(ranks) if self.backend != "gloo" \
            else group

    def split(self, color: int, key: int = 0) -> "CommunicatorBase":
        """Group the ranks by ``color`` (``MPI_Comm_split``): a
        communicator over this rank's colour, its ranks ordered by
        ``(key, rank)``. Every rank calls it; every colour's groups are
        made on every rank in order of colour. torch numbers a group's
        ranks by their default-group ranks, so a ``key`` that reorders
        the ranks of a colour raises (on every rank alike)."""
        info = self.allgather_obj((int(color), int(key), self.rank))
        colors = sorted({c for c, _, _ in info})
        members = {c: [r for _, _, r in sorted(
            (k, r, r) for cc, k, r in info if cc == c)] for c in colors}
        for c, ms in members.items():
            if ms != sorted(ms):
                raise ValueError(
                    f"split: key orders colour {c}'s ranks as {ms}; a torch "
                    "group numbers its ranks in default-group order")
        mine = None
        for c in colors:  # the same order on every rank
            groups = self._new_groups([self._global(r) for r in members[c]])
            if c == color:
                mine = groups
        return self._sub(*mine)

    def sub_communicator(self, ranks: Sequence[int]
                         ) -> Optional["CommunicatorBase"]:
        """A communicator over the ranks ``ranks`` of this one (the JAX
        device-plane split). Every rank calls it (``new_group`` is
        collective); the ranks outside get None."""
        ranks = sorted(int(r) for r in ranks)
        for r in ranks:
            self._check_peer(r, "rank")
        groups = self._new_groups([self._global(r) for r in ranks])
        return self._sub(*groups) if self.rank in ranks else None


class _SplitCommunicator(CommunicatorBase):
    """A communicator over one colour of :meth:`CommunicatorBase.split`
    (or :meth:`~CommunicatorBase.sub_communicator`'s ranks): ``rank`` and
    ``size`` are the group's."""

    name = "split"
    gloo_on_cuda = True


def _default_sum(a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _default_sum(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_default_sum(x, y) for x, y in zip(a, b))
    return a + b
