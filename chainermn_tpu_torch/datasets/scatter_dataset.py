"""Dataset scattering by index arithmetic (counterpart of
``chainermn_tpu/datasets/scatter_dataset.py``).

Every rank computes its own ``(begin, end)`` slice of the same seeded
permutation from ``comm.rank``; no data moves, and only the seed needs
agreement (one ``bcast_obj`` when the caller does not fix it). The port
runs one rank per device, so a rank's shard is what the JAX call with
``size=comm.size, rank=comm.rank`` gives, ``force_equal_length``
included.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from chainermn_tpu_torch.communicators.base import CommunicatorBase


class SubDataset:
    """A view of ``dataset`` restricted to ``indices``."""

    def __init__(self, dataset: Sequence[Any], indices: np.ndarray) -> None:
        self._dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._dataset[int(j)] for j in self.indices[i]]
        return self._dataset[int(self.indices[i])]

    def __iter__(self):
        for j in self.indices:
            yield self._dataset[int(j)]


def _shard_bounds(n: int, size: int, rank: int) -> tuple[int, int]:
    """Near-equal contiguous chunks, the first ``n % size`` one longer."""
    base, rem = divmod(n, size)
    begin = rank * base + min(rank, rem)
    end = begin + base + (1 if rank < rem else 0)
    return begin, end


def scatter_dataset(dataset: Sequence[Any], comm: CommunicatorBase, *,
                    shuffle: bool = False, seed: Optional[int] = None,
                    root: int = 0, force_equal_length: bool = False,
                    rank: Optional[int] = None, size: Optional[int] = None
                    ) -> SubDataset:
    """This rank's shard of ``dataset``.

    ``shuffle``/``seed``: a seeded global permutation before chunking
    (``seed=None`` draws one on ``root`` and broadcasts it).
    ``force_equal_length``: pad short shards by wrapping, so every rank
    sees the same number of examples. ``rank``/``size`` override the
    communicator's."""
    n = len(dataset)
    size = comm.size if size is None else size
    rank = comm.rank if rank is None else rank

    if shuffle:
        if seed is None:
            seed = (int(np.random.randint(0, 2**31 - 1))
                    if comm.rank == root else 0)
            seed = comm.bcast_obj(seed, root)
        order = np.random.RandomState(seed).permutation(n)
    else:
        order = np.arange(n)

    begin, end = _shard_bounds(n, size, rank)
    indices = order[begin:end]
    if force_equal_length and n > 0:
        target = -(-n // size)  # ceil
        if len(indices) == 0:
            # more ranks than examples: wrap around the global order
            indices = order[(begin + np.arange(target)) % n]
        elif len(indices) < target:
            reps = -(-target // len(indices))
            indices = np.tile(indices, reps)[:target]
    return SubDataset(dataset, indices)
