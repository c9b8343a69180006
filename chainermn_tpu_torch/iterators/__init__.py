"""Multi-node iterators (counterpart of
``chainermn_tpu/iterators/__init__.py``).

``create_synchronized_iterator``: every rank draws the same order from a
shared seed, with no communication. ``create_multi_node_iterator``: the
master rank draws batches and broadcasts each one through ``bcast_obj``
(input replication for model-parallel ranks). Batches are lists of
examples on the host; the trainer collates them.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Sequence

import numpy as np

from chainermn_tpu_torch.communicators.base import CommunicatorBase


class _BatchIterator:
    """Minimal epoch-aware batch iterator: one epoch per ``iter()``."""

    def __init__(self, dataset: Sequence[Any], batch_size: int, *,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self._rng = np.random.RandomState(seed)
        self._order = self._new_order()
        self._pos = 0

    def _new_order(self) -> np.ndarray:
        n = len(self.dataset)
        return self._rng.permutation(n) if self.shuffle else np.arange(n)

    def __iter__(self) -> Iterator[list]:
        return self

    def __next__(self) -> list:
        n = len(self.dataset)
        if self._pos >= n or (self.drop_last
                              and self._pos + self.batch_size > n):
            self.epoch += 1
            self._order = self._new_order()
            self._pos = 0
            raise StopIteration
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += len(idx)
        return [self.dataset[int(i)] for i in idx]


def create_multi_node_iterator(dataset: Sequence[Any], batch_size: int,
                               comm: CommunicatorBase, *,
                               rank_master: int = 0, shuffle: bool = True,
                               seed: int = 0) -> Iterable[list]:
    """``rank_master`` draws the batches; every rank receives the same
    batch through ``comm.bcast_obj``."""
    if comm.size == 1:
        return _BatchIterator(dataset, batch_size, shuffle=shuffle,
                              seed=seed)
    return _MasterBroadcastIterator(dataset, batch_size, comm, rank_master,
                                    shuffle, seed)


class _MasterBroadcastIterator:
    #: every rank receives the identical batch (not a data-parallel shard)
    replicated_batches = True

    def __init__(self, dataset, batch_size, comm, rank_master, shuffle,
                 seed):
        self.comm = comm
        self.rank_master = rank_master
        self._inner = (_BatchIterator(dataset, batch_size, shuffle=shuffle,
                                      seed=seed)
                       if comm.rank == rank_master else None)

    def __iter__(self):
        return self

    def __next__(self):
        payload = None
        if self.comm.rank == self.rank_master:
            try:
                payload = ("batch", next(self._inner))
            except StopIteration:
                payload = ("stop", None)
        kind, batch = self.comm.bcast_obj(payload, self.rank_master)
        if kind == "stop":
            raise StopIteration
        return batch

    @property
    def epoch(self):
        return self._inner.epoch if self._inner is not None else None


def create_synchronized_iterator(dataset: Sequence[Any], batch_size: int,
                                 comm: CommunicatorBase, *, seed: int = 0,
                                 shuffle: bool = True) -> Iterable[list]:
    """Every rank draws the same order from ``seed``: no communication."""
    del comm  # the same seed on every rank: nothing to exchange
    return _BatchIterator(dataset, batch_size, shuffle=shuffle, seed=seed)


__all__ = ["create_multi_node_iterator", "create_synchronized_iterator"]
