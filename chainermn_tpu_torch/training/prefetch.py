"""Device-side input prefetching (counterpart of
``chainermn_tpu/training/prefetch.py``).

On the card, the next ``size`` batches are copied ahead of the step: each
batch's numpy leaves are pinned and copied with ``non_blocking=True`` on a
side CUDA stream, and the consumer's stream waits on that copy's event
before it uses the batch, so the host-to-device copy of batch ``t+1``
overlaps the step on batch ``t``. On the CPU the iterator passes the
batches through, numpy leaves as tensors that share their memory.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from chainermn_tpu_torch._device import resolve_device


def _tree_map(fn, batch: Any) -> Any:
    """``fn`` over the leaves of nested tuples, lists and dicts."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _as_tensor(leaf) -> torch.Tensor:
    return torch.from_numpy(leaf) if isinstance(leaf, np.ndarray) else leaf


def to_device(batch: Any, device) -> Any:
    """``batch`` with every numpy or tensor leaf as a tensor on
    ``device`` (a synchronous copy; none on the CPU)."""
    return _tree_map(lambda a: _as_tensor(a).to(device), batch)


def prefetch_to_device(iterator: Iterable[Any], size: int = 2, *,
                       device=None) -> Iterator[Any]:
    """Yield the batches of ``iterator`` (nested tuples/lists/dicts of
    numpy arrays or tensors) as tensors on ``device``, up to ``size`` of
    them already in flight. ``device=None`` is the CUDA card."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    device = resolve_device(device)
    if device.type != "cuda":
        return (to_device(b, device) for b in iterator)
    stream = torch.cuda.Stream(device)

    def copy(leaf):
        leaf = _as_tensor(leaf)
        if leaf.is_cuda:
            return leaf
        return leaf.pin_memory().to(device, non_blocking=True)

    def put(batch):
        with torch.cuda.stream(stream):
            out = _tree_map(copy, batch)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def take(item):
        out, done = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        # the tensors were allocated on the side stream: tell the caching
        # allocator that the consumer's stream uses them too
        _tree_map(lambda t: t.record_stream(consumer), out)
        return out

    def gen() -> Iterator[Any]:
        queue: collections.deque = collections.deque()
        it = iter(iterator)
        for batch in it:
            queue.append(put(batch))
            if len(queue) >= size:
                yield take(queue.popleft())
        while queue:
            yield take(queue.popleft())

    return gen()


__all__ = ["prefetch_to_device", "to_device"]
