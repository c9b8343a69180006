"""Differentiable collective functions (counterpart of
``chainermn_tpu/functions/collective.py``; the reference ChainerMN's
``functions/collective_communication.py`` †, SURVEY.md §2.4).

These are the functions of :mod:`chainermn_tpu_torch.parallel.collectives`
under this module's names; each takes a communicator or a process group (``None`` is the default
group), as the JAX functions take a communicator or an axis name. Each
backward is the transpose that JAX's AD gives inside ``shard_map``, so a
backward on every rank gives the gradient of the sum of the ranks'
losses — the convention ``tests/test_functions.py`` asserts of the JAX
functions:

=============  ==========================================
function       backward
=============  ==========================================
``allgather``  reduce-scatter of the cotangents
``alltoall``   the inverse ``alltoall``
``bcast``      the cotangents summed onto ``root``
``gather``     ``scatter`` of ``root``'s cotangent
``scatter``    ``gather`` of the cotangents onto ``root``
``allreduce``  ``allreduce``
=============  ==========================================

Every rank of the group calls each function, in the same order.
"""

from chainermn_tpu_torch.parallel.collectives import (
    allgather,
    allreduce,
    alltoall,
    bcast,
    gather,
    scatter,
)

__all__ = ["allgather", "allreduce", "alltoall", "bcast", "gather",
           "scatter"]
