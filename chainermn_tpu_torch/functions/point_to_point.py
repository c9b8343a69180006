"""Differentiable point-to-point communication (counterpart of
``chainermn_tpu/functions/point_to_point.py``; the reference ChainerMN's
``functions/point_to_point_communication.py`` †, SURVEY.md §2.4, §3.4).

The reference's ``Send``/``Recv`` Functions are each other's backward:
``Send.backward`` receives the gradient and ``Recv.backward`` sends it.
Here a transfer is :func:`send_recv`, one ``torch.autograd.Function``
called on every rank of the group with the same ``(src, dst)`` and a
tensor of the same shape and dtype (on ``dst`` it only gives the shape),
as the JAX function is one ``ppermute`` that every shard runs:

- rank ``src`` sends ``x`` and returns zeros; in the backward it
  receives the gradient of ``x`` from ``dst``;
- rank ``dst`` receives and returns ``src``'s ``x``; in the backward it
  sends the cotangent back to ``src``;
- every other rank returns zeros and communicates nothing;
- ``src == dst`` is a local copy, as ``ppermute([(0, 0)])`` is.

``src`` and ``dst`` are explicit on every rank, as in JAX.

**Order, and deadlock.** A send blocks until its receive is posted, so
the ranks must meet their transfers in one order, forward and backward.
Forward: every rank calls the transfers in program order. Backward:
autograd runs a rank's nodes in reverse dependency order, so the
transfers come back in reverse order only when each later transfer on a
rank depends on the earlier ones. A rank whose loss does not use a
transfer's output (the sender's zeros, a stage without a loss) must
still back through it, or its peer waits forever. Both are what the
reference's *delegate variables* are for: :func:`send` returns a
zero-valued delegate that depends on the transfer; graft it into the
input of the rank's next transfer (``recv(..., delegate=phi)`` or
:func:`pseudo_connect`) and into what the rank backs through last, and
the rank's transfers form one chain whose backward is their exact
reverse on every rank. :class:`~chainermn_tpu_torch.links.
MultiNodeChainList` builds that chain itself.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

from chainermn_tpu_torch.parallel import collectives as C

PyTree = Any


def send_recv(x: PyTree, src: int, dst: int, comm_or_group=None) -> PyTree:
    """Transfer ``x`` from rank ``src`` to rank ``dst`` of the group.

    Every rank calls it; the result is ``src``'s ``x`` on ``dst`` and
    zeros elsewhere. Differentiable: the cotangent flows from ``dst``
    back to ``src`` (the reference's ``Send.backward == recv`` /
    ``Recv.backward == send``)."""
    return C.ppermute(x, comm_or_group, [(src, dst)])


def send(x: PyTree, dst: int, comm_or_group=None, *,
         src: Optional[int] = None):
    """Reference-shaped ``send``: ``(received, delegate)``, the transfer
    of :func:`send_recv` and a zero-valued *delegate* that depends on it.
    Thread the delegate into the rank's next transfer (:func:`recv`'s
    ``delegate=``) or into what it backs through (:func:`pseudo_connect`),
    so that the backward of the transfer runs, in order (module
    docstring).

    ``src`` is required, as in JAX: every rank calls the transfer, so the
    pair must be named on all of them."""
    if src is None:
        raise ValueError(
            "send needs the static source index: send(x, dst, group, "
            "src=i) (every rank calls the transfer, so the (src, dst) pair "
            "is named on all of them, as in the JAX package)")
    received = send_recv(x, src, dst, comm_or_group)
    delegate = pytree.tree_map(lambda r: r.sum() * 0.0, received)
    return received, delegate


def recv(received: PyTree, *, delegate: Optional[PyTree] = None) -> PyTree:
    """Reference-shaped ``recv``: unwraps a transfer of :func:`send` or
    :func:`send_recv`, grafting ``delegate`` from an earlier transfer
    onto it (the reference's ``recv(..., delegate_variable=phi)``)."""
    if delegate is not None:
        received = pseudo_connect(delegate, received)
    return received


def stream_blocks(blocks: PyTree, src: int, dst: int,
                  comm_or_group=None) -> PyTree:
    """Move a pytree of tensors (a KV-block payload) from rank ``src`` to
    rank ``dst``: one :func:`send_recv` per leaf, in the leaves' order on
    both ranks. The payload lands on ``dst``; zeros elsewhere."""
    return pytree.tree_map(
        lambda x: send_recv(x, src, dst, comm_or_group), blocks)


def pseudo_connect(delegate: PyTree, actual: PyTree) -> PyTree:
    """``actual`` with a zero term built from ``delegate`` added to each
    leaf: the value is unchanged, and a backward through ``actual`` also
    runs the backward of whatever ``delegate`` depends on (the
    reference's ``pseudo_connect`` †)."""
    zeros = [leaf.sum() * 0.0 for leaf in pytree.tree_leaves(delegate)
             if isinstance(leaf, torch.Tensor)]
    if not zeros:
        return actual
    z = sum(zeros[1:], zeros[0])
    return pytree.tree_map(lambda a: a + z.to(a.dtype), actual)


__all__ = ["pseudo_connect", "recv", "send", "send_recv", "stream_blocks"]
