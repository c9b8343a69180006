"""Placeholder datasets for model-parallel ranks (counterpart of
``chainermn_tpu/datasets/empty_dataset.py``): a dataset of ``None``s as
long as the real one, for ranks that receive activations, not data."""

from __future__ import annotations

from typing import Any, Sequence


class _EmptyDataset:
    def __init__(self, length: int) -> None:
        self._length = length

    def __len__(self) -> int:
        return self._length

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [None] * len(range(*i.indices(self._length)))
        if not -self._length <= i < self._length:
            raise IndexError(i)
        return None

    def __iter__(self):
        return iter([None] * self._length)


def create_empty_dataset(dataset: Sequence[Any]) -> _EmptyDataset:
    """An all-``None`` dataset with the same length as ``dataset``."""
    return _EmptyDataset(len(dataset))
