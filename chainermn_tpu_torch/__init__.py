"""PyTorch/CUDA port of :mod:`chainermn_tpu` for NVIDIA Hopper (H100).

The port grows slice by slice beside the JAX package and mirrors its
module names, so every module here has a counterpart of the same path
under ``chainermn_tpu/``. It imports ``torch`` and never ``jax``, ``flax``
or anything of the JAX package: where it needs code from a jax-free
module there, it keeps its own copy.

What it does today: it serves the Transformer-base causal LM through the
paged continuous-batching engine (``serving.ServingEngine`` under
``serving.Scheduler``), its paged-decode attention in hand-written CUDA
kernels (``ops.paged_decode``); it trains that LM with the
flash-attention kernels (``ops.flash_attention``); and it trains the
MNIST MLP and the ResNets data-parallel with synchronized BatchNorm
(``models``, ``links``, ``training.Trainer``), one process per rank
(``testing.run_distributed`` launches gloo ranks on the CPU). Training
resumes where it stopped: ``create_multi_node_checkpointer`` saves
per-rank snapshots (async through a native writer, or through
``torch.distributed.checkpoint`` with ``extensions.dcp_adapter``) and
agrees on the newest common one at restart; ``utils.preemption`` turns
SIGTERM into a checkpoint and a clean exit, and ``global_except_hook``
turns one rank's crash into the whole job's end. The autograd graph spans
ranks: ``functions`` (differentiable send/recv and collectives, over
``parallel.collectives``), ``links.MultiNodeChainList`` (a model split
across ranks), ``links.create_mnbn_model``, and ``parallel.tensor``'s
tensor-parallel layers. The LM splits across ranks by its weights
(``TransformerLM(tp_group=)``, ``serving.ServingEngine(mesh=)``) or by
its state (``parallel.zero``, ``parallel.fsdp``), and the checkpointer
saves the sharded state.

Entry points run on ``cuda`` unless the caller passes ``device=`` (the
CPU tests pass ``device="cpu"``); with no card and no ``device=`` they
raise instead of falling back.
"""

from chainermn_tpu_torch import global_except_hook  # installs nothing
from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.extensions.checkpoint import (
    create_multi_node_checkpointer,
)

__all__ = ["create_multi_node_checkpointer", "global_except_hook",
           "resolve_device"]
