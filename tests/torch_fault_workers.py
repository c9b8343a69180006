"""Rank programs of the port's fault-tolerance drills.

``chainermn_tpu_torch.testing.launch_ranks`` starts each rank as
``python tests/torch_fault_workers.py <case>``; a rank joins its gloo
group through ``init_rank_from_env`` and may end its own process (the
preemption guard's clean exit, the except hook's abort), which is what
the drills check. Imports no JAX. ``CKPT_DIR`` names the snapshot
directory, ``PHASE`` the drill's phase.
"""

from __future__ import annotations

import os
import signal
import sys
import time

import torch

from chainermn_tpu_torch import global_except_hook
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
from chainermn_tpu_torch.testing import init_rank_from_env
from chainermn_tpu_torch.training import Trainer
from chainermn_tpu_torch.utils.preemption import install_preemption_guard

#: the step after which rank 0 signals itself, and the checkpoint cadence:
#: the ranks must agree on iteration 5
SIGNAL_AT = 3
EVERY = 5


def case_preemption(rank, comm):
    """Only rank 0 is signalled; the guard's agreement makes every rank
    checkpoint the same iteration and exit 0."""
    ckpt = create_multi_node_checkpointer("pre", comm,
                                          path=os.environ["CKPT_DIR"], keep=0)
    guard = install_preemption_guard()
    state = {"w": torch.zeros(3)}
    for it in range(1, 200):
        state = {"w": state["w"] + 1.0}
        if it == SIGNAL_AT and rank == 0:
            os.kill(os.getpid(), signal.SIGTERM)  # rank 0 only
        if guard.should_checkpoint(comm, every=EVERY, iteration=it):
            ckpt.save(state, it)
            print(f"saved iteration {it}", flush=True)
            guard.exit_if_preempted(comm)  # never returns
    raise AssertionError("preemption never triggered a checkpoint")


def _step(state, batch):
    """w += mean(batch) (= 1) per iteration: w == iteration exactly."""
    return ({"w": state["w"] + batch.mean(), "step": state["step"] + 1},
            {"loss": state["w"].sum()})


def case_preemption_resume(rank, comm):
    """Phase 1: SIGTERM mid-run through the Trainer, every rank saves the
    agreed iteration and exits 0. Phase 2: fresh processes ``maybe_load``
    that snapshot and the Trainer resumes from exactly that iteration."""
    ckpt = create_multi_node_checkpointer("pre", comm,
                                          path=os.environ["CKPT_DIR"], keep=2)
    template = {"w": torch.zeros(3), "step": torch.zeros((), dtype=torch.int64)}
    data = [[torch.ones(2).numpy()] * 2 for _ in range(64)]
    if os.environ["PHASE"] == "1":
        guard = install_preemption_guard()
        trainer = Trainer(_step, template, data, comm, log_interval=1000)

        def sigterm_rank0(tr):
            if tr.iteration == SIGNAL_AT and rank == 0:
                os.kill(os.getpid(), signal.SIGTERM)

        def ckpt_on_preempt(tr):
            if guard.should_checkpoint(comm, every=EVERY,
                                       iteration=tr.iteration):
                ckpt.save(tr.state, tr.iteration)
                print(f"saved iteration {tr.iteration}", flush=True)
                guard.exit_if_preempted(comm)

        trainer.extend(sigterm_rank0)
        trainer.extend(ckpt_on_preempt)
        trainer.run(50)
        raise AssertionError("preemption never triggered a checkpoint")
    state, it = ckpt.maybe_load(template)
    assert it == EVERY, it  # the first multiple of EVERY after the signal
    assert int(state["step"]) == EVERY
    torch.testing.assert_close(state["w"], torch.full((3,), float(EVERY)))
    trainer = Trainer(_step, state, data, comm, log_interval=1000)
    trainer.iteration = it
    trainer.run(8)  # resume 5 -> 8: exactly 3 more steps
    assert trainer.iteration == 8
    torch.testing.assert_close(trainer.state["w"], torch.full((3,), 8.0))
    assert int(trainer.state["step"]) == 8
    print(f"resumed at {it}, finished at {trainer.iteration}", flush=True)


def case_crash_teardown(rank, comm):
    """Rank 1 raises outside any collective; the others wait in a barrier
    that fails once rank 1's process is gone, their own hooks fire, and
    every rank exits nonzero."""
    global_except_hook._add_hook()
    print("ready", flush=True)
    if rank == 1:
        time.sleep(0.5)  # let the peers reach the barrier first
        raise RuntimeError("deliberate crash for the teardown drill")
    comm.barrier()
    print("CASE_OK past the barrier", flush=True)  # must not be reached


if __name__ == "__main__":
    rank, _ = init_rank_from_env()
    comm = create_communicator("naive")
    globals()[f"case_{sys.argv[1]}"](rank, comm)
