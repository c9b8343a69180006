"""Multi-node evaluator (counterpart of
``chainermn_tpu/extensions/evaluator.py``): each rank evaluates its shard
and the result dicts are combined over the ranks with ``allreduce_obj``,
so every rank holds the whole-dataset metrics."""

from __future__ import annotations

from typing import Any, Callable, Mapping

from chainermn_tpu_torch.communicators.base import CommunicatorBase


def create_multi_node_evaluator(
        evaluator: Callable[..., Mapping[str, Any]],
        communicator: CommunicatorBase, *, reduce: str = "mean"):
    """Wrap ``evaluator`` (any callable returning ``{name: scalar}``) so
    its results are combined over the ranks.

    ``reduce='mean'``: the mean over the ranks, weighted by the local
    example count when the dict has the key ``'n'``. ``reduce='sum'``:
    the element-wise sum (for metrics made from summed statistics)."""
    if reduce not in ("mean", "sum"):
        raise ValueError(f"reduce must be 'mean' or 'sum', got {reduce!r}")

    def evaluate(*args, **kwargs):
        local = dict(evaluator(*args, **kwargs))
        if reduce == "sum":
            total = communicator.allreduce_obj(
                {k: float(v) for k, v in local.items()})
        else:
            n = float(local.pop("n", 1.0))
            weighted = {k: float(v) * n for k, v in local.items()}
            weighted["__n"] = n
            total = communicator.allreduce_obj(weighted)
            n_total = total.pop("__n")
            total = {k: v / n_total for k, v in total.items()}
        return total

    return evaluate
