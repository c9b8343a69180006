"""Attention constants shared by the port's kernels and their plain
versions (counterpart of ``chainermn_tpu/ops/attention.py``).

Only the masking constant is ported so far; the training attention
(``dot_product_attention``, ``blockwise_attention``, the ``attention``
dispatcher) lands with the training slice.
"""

#: Score of a masked key. A large finite negative rather than ``-inf``:
#: ``exp(NEG_INF - m)`` underflows to an exact 0 and ``NEG_INF - NEG_INF``
#: stays 0, so fully masked rows never produce NaN.
NEG_INF = -1e30
