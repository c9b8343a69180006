"""Data helpers of the port (counterpart of :mod:`chainermn_tpu.datasets`):
the dataset scatter, the empty dataset and the serving prefill buckets."""

from chainermn_tpu_torch.datasets.empty_dataset import create_empty_dataset
from chainermn_tpu_torch.datasets.scatter_dataset import (
    SubDataset,
    scatter_dataset,
)

__all__ = ["SubDataset", "create_empty_dataset", "scatter_dataset"]
