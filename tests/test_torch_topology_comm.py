"""The port's communicators and their calls (``chainermn_tpu_torch.
communicators``): the eight registry names, the topology (``rank``,
``size``, ``intra_*``, ``inter_*``, ``grad_axes``) by hostname and on a
2 x 2 ``mesh=``, the array collectives against the JAX communicator's
stacked eager forms, the object calls, tagged point to point with exact
dtypes, ``probe``/``ANY_SOURCE`` (cf. ``tests/test_multiprocess.py``'s
``test_mp_probe_any_source``), and ``split`` 2 x 2 (cf.
``test_mp_split_2x2``), at 4 gloo ranks
(``tests/torch_comm_workers.py::topology_worker``, one launch).

Tolerances: the array collectives against JAX rtol 1e-6 (atol 1e-6); the
rest are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chainermn_tpu
from chainermn_tpu.communicators import _REGISTRY
from chainermn_tpu_torch.communicators import (
    ANY_SOURCE,
    TOPOLOGY_NAMES,
    create_communicator,
)
from chainermn_tpu_torch.communicators.base import _wire_dtype
from chainermn_tpu_torch.testing import run_distributed
from torch_comm_workers import TOPOLOGY, run_once, topology_worker
from torch_rank_workers import few_threads  # noqa: F401

N = 4
TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs():
    rs = np.random.RandomState(3)
    return {"x": rs.randn(N, 3, 2).astype(np.float32),
            "a2a": rs.randn(N, N, 2).astype(np.float32),
            "sc": rs.randn(N, N, 3).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _inputs()
    outs = run_once("topology_worker", lambda: run_distributed(
        topology_worker, N, inputs, timeout=240), tmp_path_factory)
    return inputs, outs


def test_the_registry_has_the_jax_names():
    assert ANY_SOURCE == chainermn_tpu.communicators.ANY_SOURCE == -1
    names = set(_REGISTRY)
    assert names == {"naive", "xla", "flat", "pure_nccl", *TOPOLOGY_NAMES}
    assert set(TOPOLOGY) == set(TOPOLOGY_NAMES)


@pytest.mark.parametrize("name", TOPOLOGY)
def test_topology_names_by_hostname(runs, name):
    """One host: intra is every rank, inter one host; hierarchical axes
    (inter, intra) of sizes (1, 4); two_dimensional alone pins the
    two-level pipeline."""
    _, outs = runs
    for r, o in enumerate(outs):
        assert list(o[f"topo/{name}"]) == [r, N, r, N, 0, 1]
        want_axes = [N] if name == "single_node" else [1, N]
        assert list(o[f"axes/{name}"]) == want_axes
        assert bool(o[f"two_level/{name}"]) == (name == "two_dimensional")


def test_naive_topology_and_nccl_names_need_the_card(runs):
    _, outs = runs
    for r, o in enumerate(outs):
        assert list(o["topo/naive"]) == [r, N, r, N, 0, 1]
        for name in ("xla", "flat", "pure_nccl"):
            assert bool(o[f"nccl_raised/{name}"])


def test_mesh_sets_the_layout(runs):
    """``mesh=`` (2 x 2) on one host: rank r at (r // 2, r % 2); a 1-axis
    mesh is refused by two_dimensional."""
    _, outs = runs
    for r, o in enumerate(outs):
        assert list(o["topo/mesh2x2"]) == [r, N, r % 2, 2, r // 2, 2]
        assert bool(o["two_d_1axis_raised"])


def test_topology_names_run_nccl_unless_asked_for_gloo():
    """No fallback: on the CPU without backend='gloo' the topology names
    raise (NCCL needs the card), as does the 'auto' wire (queue 8)."""
    for name in TOPOLOGY:
        with pytest.raises(RuntimeError, match="runs NCCL on a CUDA"):
            create_communicator(name, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 8"):
        _wire_dtype("auto")
    with pytest.raises(ValueError, match="backend"):
        create_communicator("hierarchical", backend="mpi", device="cpu")


def _jax_comm():
    return chainermn_tpu.create_communicator(
        "naive", devices=jax.devices("cpu")[:N])


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_allreduce_matches_the_jax_stacked_form(runs, op):
    inputs, outs = runs
    want = np.asarray(_jax_comm().allreduce(jnp.asarray(inputs["x"]), op=op))
    for o in outs:
        np.testing.assert_allclose(o[f"allreduce/{op}"], want, **TOL)


def test_bcast_allgather_alltoall_scatter_match_jax(runs):
    inputs, outs = runs
    jc = _jax_comm()
    bc = np.asarray(jc.bcast(jnp.asarray(inputs["x"]), root=2, stacked=True))
    ag = np.asarray(jc.allgather(jnp.asarray(inputs["x"])))
    a2a = np.asarray(jc.alltoall(jnp.asarray(inputs["a2a"])))
    sc = np.asarray(jc.scatter(jnp.asarray(inputs["sc"][1]), root=1))
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["bcast"], bc, **TOL)
        np.testing.assert_allclose(o["allgather"], ag, **TOL)
        np.testing.assert_allclose(o["alltoall"], a2a[r], **TOL)
        np.testing.assert_allclose(o["scatter"], sc[r], **TOL)


def test_object_calls(runs):
    _, outs = runs
    for o in outs:
        assert bool(o["scatter_obj"]) and bool(o["bcast_obj"])
        assert bool(o["allreduce_obj"])
        assert bool(o["p2p/self"])


def test_tagged_send_recv_keeps_dtypes_exactly(runs):
    _, outs = runs
    o = outs[0]
    for key in ("p2p/tag6", "p2p/int64", "p2p/bf16", "p2p/f16", "p2p/0dim"):
        assert bool(o[key]), key


def test_probe_does_not_consume_and_any_source_takes_every_sender(runs):
    """Rank 0 probes (1, 5) twice (still there), finds nothing from 3
    under tag 5, finds tag 9 from any source and its own self-send; three
    senders under one tag all arrive through ANY_SOURCE; afterwards
    nothing is left."""
    _, outs = runs
    o = outs[0]
    assert [bool(b) for b in o["probe_before"]] == [True, True, False, True,
                                                    True]
    assert list(o["p2p/any_sources"]) == [1, 2, 3]
    assert [bool(b) for b in o["probe_after"]] == [False, False]


def test_split_two_by_two(runs):
    """Colours {0, 1} and {2, 3}: group ranks, independent group calls in
    opposite orders without deadlock, the group's sum, p2p by group
    rank; a key that reorders ranks raises on every rank; the sub-
    communicator of ranks 1 and 3 exists only there."""
    _, outs = runs
    for r, o in enumerate(outs):
        assert list(o["split/topo"]) == [r % 2, 2]
        assert int(o["split/bcast_from"]) == r - r % 2
        assert int(o["split/total"]) == 2
        assert float(o["split/allreduce"][0]) == (1.0 if r < 2 else 5.0)
        assert bool(o["split_key_raised"])
        assert bool(o["sub/none"]) == (r not in (1, 3))
        if r in (1, 3):
            assert list(o["sub/topo"]) == [r // 2, 2]
            assert float(o["sub/sum"][0]) == 4.0
    assert bool(outs[3]["split/p2p"])
