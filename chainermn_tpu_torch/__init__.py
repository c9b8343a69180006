"""PyTorch/CUDA port of :mod:`chainermn_tpu` for NVIDIA Hopper (H100).

The port grows slice by slice beside the JAX package and mirrors its
module names, so every module here has a counterpart of the same path
under ``chainermn_tpu/``. It imports ``torch`` and never ``jax``, ``flax``
or anything of the JAX package: where it needs code from a jax-free
module there, it keeps its own copy.

What it serves today: the Transformer-base causal LM through the paged
continuous-batching engine (``serving.ServingEngine`` under
``serving.Scheduler``), with the paged-decode attention running in a
hand-written CUDA kernel (``ops.paged_decode``, source
``csrc/paged_decode.cu``).

Entry points run on ``cuda`` unless the caller passes ``device=`` (the
CPU tests pass ``device="cpu"``); with no card and no ``device=`` they
raise instead of falling back.
"""

from chainermn_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
