"""The port's fault tolerance on gloo ranks: the preemption guard, the
global except hook, the observation aggregator and the
``torch.distributed.checkpoint`` (dcp) adapter.

- Preemption drill (JAX ``tests/test_multiprocess.py::test_mp_preemption``):
  SIGTERM on rank 0 of 2; both ranks save the same iteration (the first
  multiple of 5 after the signal) and exit 0.
- Preemption then resume (``test_mp_preemption_resume``): the same through
  the Trainer, then fresh processes resume at that iteration and finish
  with the state of a run that never stopped.
- Crash teardown (``test_mp_crash_tears_down_whole_job``): rank 1 of 3
  raises; every rank exits promptly and nonzero, none reaches its
  deadline, the crasher prints the rank-tagged banner. These drills end
  their own processes, so they run through ``testing.launch_ranks``,
  which lets every rank die on its own.
- The observation aggregator at 2 gloo ranks, interval 1 and windowed
  (keys that vary inside a window), against the JAX
  ``ObservationAggregator`` driven on the same per-rank inputs by one
  thread per rank over a shared in-memory communicator: equal results.
- The dcp adapter (JAX ``tests/test_extensions.py`` orbax tests): round
  trip, an empty directory, retention, a resave that overwrites (also
  over an async save in flight), plain DCP reading what it wrote, a
  TrainState resumed bit for bit, and at 2 ranks the shared-directory
  round trip with divergent state refused.

Tolerance: exact, except the aggregator's means (1e-12 relative: the
same float sums in the same rank order).
"""

import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from chainermn_tpu.extensions import ObservationAggregator as JaxAggregator
from chainermn_tpu_torch import global_except_hook
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.extensions import (
    ObservationAggregator,
    create_dcp_checkpointer,
)
from chainermn_tpu_torch.testing import launch_ranks, run_distributed
from chainermn_tpu_torch.utils.preemption import install_preemption_guard
from torch_rank_workers import aggregator_dcp_worker, few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
WORKERS = str(Path(__file__).resolve().parent / "torch_fault_workers.py")
#: a drill's deadline; every rank must end well before it
DEADLINE_S = 90.0


def _env(**kw):
    path = os.pathsep.join(p for p in (str(ROOT),
                                       os.environ.get("PYTHONPATH")) if p)
    return {"PYTHONPATH": path, **kw}


def _launch(case, size, **env):
    exits = launch_ranks([WORKERS, case], size, timeout=DEADLINE_S,
                         env=_env(**env))
    assert not any(e.timed_out for e in exits), [e.output for e in exits]
    return exits


def _snapshots(d):
    return sorted(f for f in os.listdir(d) if f.startswith("snapshot_"))


def test_preemption_drill_saves_one_agreed_iteration_and_exits_0(tmp_path):
    exits = _launch("preemption", 2, CKPT_DIR=str(tmp_path))
    assert [e.returncode for e in exits] == [0, 0], [e.output for e in exits]
    assert _snapshots(tmp_path) == ["snapshot_pre_0_5.npz",
                                    "snapshot_pre_1_5.npz"]
    assert all("saved iteration 5" in e.output for e in exits)


def test_preemption_then_resume_through_the_trainer(tmp_path):
    first = _launch("preemption_resume", 2, CKPT_DIR=str(tmp_path), PHASE="1")
    assert [e.returncode for e in first] == [0, 0], [e.output for e in first]
    assert _snapshots(tmp_path) == ["snapshot_pre_0_5.npz",
                                    "snapshot_pre_1_5.npz"]
    second = _launch("preemption_resume", 2, CKPT_DIR=str(tmp_path),
                     PHASE="2")
    assert [e.returncode for e in second] == [0, 0], [e.output for e in
                                                      second]
    assert all("resumed at 5, finished at 8" in e.output for e in second)


def test_crash_tears_down_the_whole_job():
    exits = _launch("crash_teardown", 3)
    assert all(e.returncode not in (0, None) for e in exits), \
        [(e.returncode, e.output) for e in exits]
    crasher = exits[1].output
    assert "uncaught exception on rank 1/3" in crasher
    assert "deliberate crash for the teardown drill" in crasher
    assert not any("CASE_OK" in e.output for e in exits)
    # prompt: through the closed sockets, not a deadline
    assert max(e.seconds for e in exits) < DEADLINE_S / 2


def test_global_except_hook_installs():
    old = sys.excepthook
    try:
        global_except_hook._add_hook()
        assert sys.excepthook is global_except_hook._global_except_hook
        global_except_hook._add_hook()  # idempotent
        assert sys.excepthook is global_except_hook._global_except_hook
    finally:
        sys.excepthook = old
        global_except_hook._hook_installed = False


def test_preemption_guard_cadence_and_uninstall():
    import signal

    comm = create_communicator("naive")
    before = signal.getsignal(signal.SIGTERM)
    guard = install_preemption_guard()
    try:
        assert not guard.triggered
        assert not guard.should_checkpoint(comm, every=5, iteration=5)
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.triggered
        assert not guard.should_checkpoint(comm, every=5, iteration=6)
        assert guard.should_checkpoint(comm, every=5, iteration=10)
        # without iteration=: an internal counter, each call one step
        assert [guard.should_checkpoint(comm, every=3) for _ in range(4)] \
            == [True, False, False, True]
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


# ------------------------------------------------------------- aggregator

OBSERVATIONS = [
    [{"loss": 4.0}, {"loss": 2.0, "acc": 1.0}, {"loss": 0.0},
     {"loss": 10.0, "acc": 0.5}, {"lr": 0.1}],
    [{"loss": 1.0, "acc": 0.0}, {"loss": 3.0}, {"loss": 5.0, "lr": 0.2},
     {"acc": 0.25}, {"loss": 7.0}],
]


class _ThreadComm:
    """One rank of a communicator shared by threads in this process: the
    JAX aggregator's object collectives, in rank order."""

    def __init__(self, shared, rank):
        self.shared, self.rank = shared, rank

    def allgather_obj(self, obj):
        slots, barrier = self.shared
        slots[self.rank] = obj
        barrier.wait()
        items = list(slots)
        barrier.wait()
        return items

    def allreduce_obj(self, obj, op):
        items = self.allgather_obj(obj)
        out = items[0]
        for item in items[1:]:
            out = op(out, item)
        return out


def _jax_aggregate(interval):
    n = len(OBSERVATIONS)
    shared = ([None] * n, threading.Barrier(n, timeout=30))
    results = [None] * n

    def rank(r):
        agg = JaxAggregator(_ThreadComm(shared, r), interval=interval)
        results[r] = [agg(o) for o in OBSERVATIONS[r]] + [agg.flush()]

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return results


@pytest.fixture(scope="module")
def rank_outs(tmp_path_factory):
    return run_distributed(
        aggregator_dcp_worker, 2,
        {"observations": json.dumps(OBSERVATIONS),
         "dir": str(tmp_path_factory.mktemp("dcp_ranks"))}, timeout=120)


def _same(a, b):
    if a is None or b is None:
        return a is b
    return set(a) == set(b) and all(
        abs(a[k] - b[k]) <= 1e-12 * max(1.0, abs(b[k])) for k in b)


@pytest.mark.parametrize("interval", [1, 3])
def test_observation_aggregator_matches_jax(rank_outs, interval):
    want = _jax_aggregate(interval)
    for r, out in enumerate(rank_outs):
        got = json.loads(str(out[f"agg{interval}"]))
        assert len(got) == len(want[r])
        assert all(_same(g, w) for g, w in zip(got, want[r])), (got, want[r])
    if interval == 3:  # windows close at call 3; the flush takes 4-5
        assert got[0] is None and got[1] is None and got[2] is not None


def test_observation_aggregator_single_process():
    comm = create_communicator("naive")
    assert ObservationAggregator(comm)({"loss": 1.5}) == {"loss": 1.5}
    agg = ObservationAggregator(comm, interval=3)
    assert agg({"loss": 4.0}) is None
    assert agg({"loss": 2.0, "acc": 1.0}) is None
    assert agg({"loss": 0.0}) == {"loss": 2.0, "acc": 1.0}
    assert agg({"loss": 10.0}) is None
    assert agg.flush_per_rank() == [{"loss": 10.0}]
    assert agg.flush() is None
    with pytest.raises(ValueError, match="interval"):
        ObservationAggregator(comm, interval=0)


# ------------------------------------------------------------- dcp adapter

@pytest.fixture(scope="module")
def comm():
    return create_communicator("naive")


def test_dcp_checkpointer_roundtrip(tmp_path, comm):
    ckpt = create_dcp_checkpointer("job", comm, path=str(tmp_path))
    state = {"w": torch.arange(6.0).reshape(2, 3), "step": torch.tensor(7),
             "lr": 0.5, "betas": (0.9, 0.999)}
    ckpt.save(state, iteration=100)
    restored, it = ckpt.maybe_load({"w": torch.zeros(2, 3),
                                    "step": torch.tensor(0), "lr": 0.0,
                                    "betas": (0.0, 0.0)})
    assert it == 100
    assert torch.equal(restored["w"], state["w"])
    assert int(restored["step"]) == 7 and restored["lr"] == 0.5
    assert restored["betas"] == (0.9, 0.999)
    ckpt.close()


def test_dcp_checkpointer_empty_and_retention(tmp_path, comm):
    ckpt = create_dcp_checkpointer("ret", comm, path=str(tmp_path), keep=2)
    template = {"x": torch.zeros(3)}
    restored, it = ckpt.maybe_load(template)
    assert it is None and restored is template
    for step in [1, 2, 3, 4, 5]:
        ckpt.save({"x": torch.full((3,), float(step))}, iteration=step,
                  block=step % 2 == 0)
    ckpt.wait_async()
    assert ckpt._local_iterations() == [4, 5]
    restored, it = ckpt.maybe_load(template)
    assert it == 5 and torch.equal(restored["x"], torch.full((3,), 5.0))
    ckpt.close()


@pytest.mark.parametrize("first_block", [True, False],
                         ids=["blocking", "async-in-flight"])
def test_dcp_checkpointer_resave_same_step_overwrites(tmp_path, comm,
                                                      first_block):
    ckpt = create_dcp_checkpointer("resave", comm, path=str(tmp_path))
    ckpt.save({"x": torch.zeros(2)}, iteration=7, block=first_block)
    ckpt.save({"x": torch.ones(2)}, iteration=7)
    restored, it = ckpt.maybe_load({"x": torch.zeros(2)})
    assert it == 7 and torch.equal(restored["x"], torch.ones(2))
    ckpt.close()


def test_dcp_checkpoints_readable_by_plain_dcp(tmp_path, comm):
    import torch.distributed.checkpoint as dcp

    ckpt = create_dcp_checkpointer("interop", comm, path=str(tmp_path))
    ckpt.save({"a": torch.full((4,), 3.0)}, iteration=42)
    ckpt.close()
    assert os.listdir(ckpt.path) == ["42"]
    out = {"['a']": torch.zeros(4)}
    dcp.load(out, checkpoint_id=os.path.join(ckpt.path, "42"))
    assert torch.equal(out["['a']"], torch.full((4,), 3.0))


def test_dcp_checkpointer_resumes_a_train_state_bit_for_bit(tmp_path, comm):
    from chainermn_tpu_torch.models import MLP
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )

    def build():
        model = MLP(n_units=16, seed=0, device="cpu")
        opt = create_multi_node_optimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-2), comm,
            double_buffering=True)
        return create_train_state(model, opt, comm), make_train_step(
            lambda m, b: torch.nn.functional.cross_entropy(m(b[0]), b[1]),
            opt, comm)

    g = torch.Generator().manual_seed(0)
    batches = [(torch.randn(4, 784, generator=g),
                torch.randint(0, 10, (4,), generator=g)) for _ in range(4)]

    def run(step, state, bs):
        out = []
        for b in bs:
            state, m = step(state, b)
            out.append(float(m["loss"]))
        return state, out

    state, step = build()
    _, ref = run(step, state, batches)
    state, step = build()
    state, first = run(step, state, batches[:2])
    ckpt = create_dcp_checkpointer("ts", comm, path=str(tmp_path))
    ckpt.save(state, 2, block=False)
    fresh, step = build()
    fresh, it = ckpt.maybe_load(fresh)
    assert it == 2 and fresh.step == 2
    _, rest = run(step, fresh, batches[2:])
    assert first + rest == ref
    ckpt.close()


def test_dcp_adapter_at_two_ranks(rank_outs):
    for out in rank_outs:
        assert out["kept"].tolist() == [2, 3]
        assert int(out["it"]) == 3 and int(out["step"]) == 30
        np.testing.assert_array_equal(out["w"], np.ones((2, 3)))
        assert bool(out["divergent_refused"])
