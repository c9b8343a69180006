"""The port's communicator at world size 1: ``'naive'`` (gloo on the CPU),
the packed flat-buffer reduction, the wire dtype, the topology names
over gloo, and the names and wires that need the card or are not
ported."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from chainermn_tpu_torch.communicators import (
    CommunicatorBase,
    create_communicator,
)
from torch_rank_workers import few_threads  # noqa: F401


def _model_with_grads(seed=0):
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Linear(5, 7), nn.Linear(7, 3, bias=False))
    rs = np.random.RandomState(seed)
    for p in model.parameters():
        p.grad = torch.tensor(rs.randn(*p.shape) * 10 ** rs.uniform(-3, 2),
                              dtype=torch.float32)
    return model


def test_naive_topology_at_size_one():
    hook = sys.excepthook
    comm = create_communicator("naive")
    assert sys.excepthook is hook  # the one-rank group leaves it alone
    assert (comm.rank, comm.size) == (0, 1)
    assert (comm.intra_rank, comm.intra_size) == (0, 1)
    assert comm.device.type == "cpu"
    comm.barrier()
    assert "naive" in repr(comm)


@pytest.mark.parametrize("packed", [False, True], ids=["per-param", "flat"])
@pytest.mark.parametrize("wire", [None, "bfloat16", "float16"])
def test_allreduce_grad_rounds_through_the_wire(packed, wire):
    """At size 1 the mean is the gradient itself, rounded through the wire
    dtype exactly as the JAX in-step reduction rounds it."""
    comm = CommunicatorBase("gloo", packed=packed, allreduce_grad_dtype=wire)
    model = _model_with_grads()
    before = [p.grad.numpy().copy() for p in model.parameters()]
    comm.allreduce_grad(model)
    jdt = {None: jnp.float32, "bfloat16": jnp.bfloat16,
           "float16": jnp.float16}[wire]
    for p, g in zip(model.parameters(), before):
        want = np.asarray(jnp.asarray(g).astype(jdt).astype(jnp.float32))
        np.testing.assert_array_equal(p.grad.numpy(), want)


def test_allreduce_grad_dtype_override_and_missing_grads():
    comm = create_communicator("naive", allreduce_grad_dtype="bfloat16")
    model = _model_with_grads(1)
    before = [p.grad.clone() for p in model.parameters()]
    comm.allreduce_grad(model, dtype=None)  # the fp32 wire, explicitly
    for p, g in zip(model.parameters(), before):
        torch.testing.assert_close(p.grad, g, rtol=0, atol=0)
    model[1].weight.grad = None
    comm.allreduce_grad(model)
    assert torch.equal(model[1].weight.grad, torch.zeros(3, 7))


def test_bcast_data_leaves_params_equal():
    comm = create_communicator("naive")
    model = _model_with_grads(2)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert comm.bcast_data(model) is model
    for n, p in model.named_parameters():
        torch.testing.assert_close(p, before[n], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["hierarchical", "two_dimensional",
                                  "single_node", "non_cuda_aware"])
def test_queue_three_names_raise(name):
    """The topology names are ported: over gloo on the CPU when asked
    for it, at world size 1 one host and one rank; without the card they
    raise rather than fall back from NCCL, and the 'auto' wire still
    raises naming ROADMAP queue 8."""
    comm = create_communicator(name, backend="gloo", device="cpu")
    assert (comm.rank, comm.size, comm.inter_size, comm.intra_size) == (
        0, 1, 1, 1)
    with pytest.raises(RuntimeError, match="runs NCCL on a CUDA device"):
        create_communicator(name, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 8"):
        create_communicator(name, backend="gloo", device="cpu",
                            allreduce_grad_dtype="auto")


@pytest.mark.parametrize("name", ["pure_nccl", "xla", "flat"])
def test_nccl_names_need_the_card(name):
    """No CUDA here: the NCCL names raise rather than fall back to gloo,
    with or without an explicit device."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_communicator(name)
    with pytest.raises(RuntimeError, match="runs NCCL on a CUDA device"):
        create_communicator(name, device="cpu")


def test_bad_names_and_wires_raise():
    with pytest.raises(ValueError, match="unknown communicator"):
        create_communicator("mpi")
    # the int8 wire is ported (exact at one rank); 'auto' is queue 8's
    assert create_communicator(
        "naive", allreduce_grad_dtype="int8").allreduce_grad_dtype == \
        torch.int8
    with pytest.raises(NotImplementedError, match="ROADMAP queue 8"):
        create_communicator("naive", allreduce_grad_dtype="auto")
    with pytest.raises(ValueError, match="allreduce_grad_dtype"):
        create_communicator("naive", allreduce_grad_dtype="float64")
    with pytest.raises(ValueError, match="gloo on CPU tensors"):
        create_communicator("naive", device="meta")
