"""``torch.distributed.checkpoint`` (DCP) backend with the reference's
agreement semantics (counterpart of
``chainermn_tpu/extensions/orbax_adapter.py``).

DCP is PyTorch's own standard checkpoint format, as orbax is JAX's: teams
standardised on it should not have to leave it to get ChainerMN's
fault-tolerance behaviour. This adapter keeps the two-method surface of
:class:`~chainermn_tpu_torch.extensions.checkpoint.MultiNodeCheckpointer`
(``save`` / ``maybe_load``, with ``wait_async`` and ``close``) and its
cross-rank guarantees:

- the last ``keep`` steps are kept, each in its own step directory;
- resume from the NEWEST step that EVERY process holds, agreed through
  :func:`~chainermn_tpu_torch.extensions.checkpoint.agree_max_common_step`
  (the JAX adapter's agreement, one object collective carrying each
  rank's drain error);
- re-saving a step overwrites it.

Storage layout follows the JAX adapter: one process writes a per-rank
directory ``{path}/{name}_dcp_rank{rank}``; several processes follow
DCP's own collective model, one shared directory ``{path}/{name}_dcp``
written by coordinated saves, whose contract is state replicated across
processes — enforced at save time by a digest exchange. Per-rank
divergent state belongs to the npz backend.

The state is what the npz backend stores (a TrainState or a nested
mapping), flattened to DCP's flat ``{key: tensor or value}`` form under
the same tree-path keys; DCP loads the tensors in place into the
template's (a TrainState's parameters and primed optimizer state), and
its non-tensor values come back as saved. DCP's collectives run over a
gloo group of the communicator's ranks, which ``dcp.async_save`` needs
for ``save(block=False)``. Below ``save``/``load`` everything is plain
DCP: a step directory is readable by ``torch.distributed.checkpoint``
tooling.
"""

from __future__ import annotations

import hashlib
import os
import shutil

import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators.base import CommunicatorBase
from chainermn_tpu_torch.extensions.checkpoint import (
    _flatten,
    _into,
    _template_leaves,
    _tree_of,
    _unflatten,
    _unprime,
    agree_max_common_step,
)


class DcpMultiNodeCheckpointer:
    """``save(state, step)`` / ``maybe_load(template) -> (state, step)`` on
    DCP storage, with cross-rank resume agreement."""

    def __init__(self, name: str, comm: CommunicatorBase, *,
                 path: str = "checkpoints", keep: int = 2) -> None:
        self.name = name
        self.comm = comm
        self.keep = keep
        self._multiprocess = comm.size > 1
        sub = (f"{name}_dcp" if self._multiprocess
               else f"{name}_dcp_rank{comm.rank}")
        self.path = os.path.abspath(os.path.join(path, sub))
        os.makedirs(self.path, exist_ok=True)
        # a gloo group of the same ranks: DCP's planning collectives, and
        # async_save's staging, need a group that runs on the CPU
        self._pg = (comm.group if comm.backend == "gloo"
                    else dist.new_group(backend="gloo"))
        self._pending = None  # the last async save's future

    def _step_dir(self, iteration: int) -> str:
        return os.path.join(self.path, str(iteration))

    def _local_iterations(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.path)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.path, d, ".metadata")))

    def _assert_replicated(self, flat: dict) -> None:
        h = hashlib.sha256()
        for key in sorted(flat):
            v = flat[key]
            h.update(key.encode())
            if isinstance(v, torch.Tensor):
                h.update(v.detach().cpu().contiguous().view(-1)
                         .view(torch.uint8).numpy().tobytes())
            else:
                h.update(repr(v).encode())
        digests = self.comm.allgather_obj(h.hexdigest())
        if len(set(digests)) != 1:
            raise ValueError(
                "dcp backend multiprocess contract violated: state differs "
                f"across processes (digests {sorted(set(digests))}); "
                "per-rank-divergent state needs "
                "create_multi_node_checkpointer (npz, per-rank files)")

    def _gc(self) -> None:
        """Remove the steps beyond ``keep``: rank 0 alone in the shared
        directory, the others waiting for it, so that every rank lists
        the same steps afterwards."""
        if self._multiprocess and self.comm.rank != 0:
            self.comm.barrier()
            return
        its = self._local_iterations()
        for it in its[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(it), ignore_errors=True)
        if self._multiprocess:
            self.comm.barrier()

    def save(self, state, iteration: int, *, block: bool = True) -> str:
        """Save ``state`` as step ``iteration`` (overwriting a step of
        that number; drained first, so an async save of the same step in
        flight lands before it is removed). ``block=False`` returns once
        DCP has staged the tensors on the host (``dcp.async_save``); the
        write completes in the background until :meth:`wait_async`."""
        self.wait_async()
        _, flat = _flatten(_tree_of(state))
        step_dir = self._step_dir(iteration)
        if self._multiprocess:
            self._assert_replicated(flat)
            # rank 0 alone looks and removes; the barrier keeps every rank
            # from writing before that (a rank that looked on its own could
            # see the directory a faster rank's save had just begun)
            if self.comm.rank == 0 and os.path.exists(step_dir):
                shutil.rmtree(step_dir)
            self.comm.barrier()
        elif os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        import torch.distributed.checkpoint as dcp

        if block:
            dcp.save(flat, checkpoint_id=step_dir, process_group=self._pg)
            self._gc()
        else:
            self._pending = dcp.async_save(flat, checkpoint_id=step_dir,
                                           process_group=self._pg)
        return step_dir

    def wait_async(self) -> None:
        """Wait for the pending async save (raises its failure), then
        remove steps beyond ``keep``."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()
            self._gc()

    def maybe_load(self, state_template):
        """Restore the newest step ALL processes hold; ``(template,
        None)`` when there is none. Call with the freshly built state: the
        template gives the keys, shapes, dtypes and devices."""
        drain_err = None
        try:
            self.wait_async()
        except Exception as e:  # any failure of the background save
            drain_err = f"{type(e).__name__}: {e}"
        step = agree_max_common_step(self.comm, self._local_iterations(),
                                     drain_err)
        if step is None:
            return state_template, None
        import torch.distributed.checkpoint as dcp

        skeleton, flat, primed = _template_leaves(state_template)
        try:
            dcp.load(flat, checkpoint_id=self._step_dir(step),
                     process_group=self._pg)
            return _into(state_template, _unflatten(skeleton, flat)), step
        except BaseException:
            if primed:
                _unprime(state_template.optimizer)
            raise

    def close(self) -> None:
        self.wait_async()


def create_dcp_checkpointer(name: str, comm: CommunicatorBase,
                            **kwargs) -> DcpMultiNodeCheckpointer:
    """Factory mirroring :func:`create_multi_node_checkpointer`, on DCP
    storage."""
    return DcpMultiNodeCheckpointer(name, comm, **kwargs)


__all__ = ["DcpMultiNodeCheckpointer", "create_dcp_checkpointer"]
