"""The port's checkpointer (``chainermn_tpu_torch.extensions.checkpoint``)
and its native async writer against the JAX package's.

- The JAX checkpointer tests of ``tests/test_extensions.py`` on the port:
  round trip (blocking and async), an empty directory, the ``keep`` GC,
  the newest common iteration, restore by tree path, a renamed leaf, a
  reshaped leaf, cleanup, a failed async write surfacing at
  ``wait_async``, the writer's overlap, use after ``finalize``, shard
  coverage, conflicting copies and strided shard indices.
- ``agree_max_common_step`` against the JAX function on the same per-rank
  iteration lists and drain errors (equal results, equal errors).
- A ``TrainState`` of the Transformer LM with AdamW behind
  ``create_multi_node_optimizer(double_buffering=True)``: saved after 3
  steps and loaded into a freshly built model and optimizer, the next 3
  steps give the losses and parameters of a run that never stopped, bit
  for bit; the optimizer state (AdamW's per-parameter ``step`` tensors,
  the ``param_groups``, the bank) comes back exactly. Without the bank
  the resumed steps differ. A model with a frozen parameter resumes the
  same way through the train step.
- At 2 and 4 gloo ranks in one directory: the agreement when the ranks
  hold different iterations, none in common, and a raise on every rank
  when one rank's async write failed; a replicated state saved by 2
  ranks restored by 4 (``allow_world_resize``).

Tolerance: none — every restored value is compared exactly.
"""

import os

import numpy as np
import pytest
import torch

from chainermn_tpu.extensions.checkpoint import (
    agree_max_common_step as jax_agree,
)
from chainermn_tpu_torch import create_multi_node_checkpointer
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.extensions.checkpoint import (
    _SHARD_SEP,
    MultiNodeCheckpointer,
    _index_str,
    agree_max_common_step,
)
from chainermn_tpu_torch.models import TransformerLM, lm_loss
from chainermn_tpu_torch.native.ckpt_writer import AsyncCheckpointWriter
from chainermn_tpu_torch.ops.flash_attention import flash_attention
from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
from chainermn_tpu_torch.testing import run_distributed
from chainermn_tpu_torch.training import create_train_state, make_train_step
from torch_rank_workers import checkpoint_worker, few_threads  # noqa: F401


@pytest.fixture(scope="module")
def comm():
    return create_communicator("naive")


def _state(it=7):
    return {"w": torch.arange(6.0).reshape(2, 3), "step": torch.tensor(it)}


def _template():
    return {"w": torch.zeros(2, 3), "step": torch.tensor(0)}


@pytest.mark.parametrize("block", [True, False], ids=["blocking", "async"])
def test_checkpointer_roundtrip(tmp_path, comm, block):
    ckpt = create_multi_node_checkpointer("job", comm, path=str(tmp_path))
    ckpt.save(_state(), iteration=100, block=block)
    restored, it = ckpt.maybe_load(_template())
    assert it == 100
    torch.testing.assert_close(restored["w"], _state()["w"], rtol=0, atol=0)
    assert int(restored["step"]) == 7
    ckpt.close()


def test_checkpointer_values_and_dtypes_roundtrip(tmp_path, comm):
    """bf16 tensors bit for bit; non-array leaves (None, bool, float, str,
    int) equal; tuples come back as tuples; numpy leaves as numpy."""
    ckpt = create_multi_node_checkpointer("kinds", comm, path=str(tmp_path))
    bf = torch.randn(5, generator=torch.Generator().manual_seed(0)).bfloat16()
    state = {"bf": bf, "none": None, "flag": True, "lr": 0.1 + 0.2,
             "name": "adamw", "betas": (0.9, 0.999), "n": 3,
             "np": np.arange(4, dtype=np.int32), "seq": [torch.ones(2), 2.5]}
    ckpt.save(state, 1)
    template = {"bf": torch.zeros(5, dtype=torch.bfloat16), "none": None,
                "flag": False, "lr": 0.0, "name": "", "betas": (0.0, 0.0),
                "n": 0, "np": np.zeros(4, np.int32),
                "seq": [torch.zeros(2), 0.0]}
    got, _ = ckpt.maybe_load(template)
    assert torch.equal(got["bf"].view(torch.int16), bf.view(torch.int16))
    assert got["none"] is None and got["flag"] is True and got["n"] == 3
    assert got["lr"] == 0.1 + 0.2 and got["name"] == "adamw"
    assert got["betas"] == (0.9, 0.999) and isinstance(got["betas"], tuple)
    np.testing.assert_array_equal(got["np"], state["np"])
    assert torch.equal(got["seq"][0], torch.ones(2)) and got["seq"][1] == 2.5


def test_checkpointer_no_snapshot_returns_template(tmp_path, comm):
    ckpt = create_multi_node_checkpointer("fresh", comm, path=str(tmp_path))
    template = {"x": torch.zeros(3)}
    restored, it = ckpt.maybe_load(template)
    assert it is None
    assert restored is template


def test_checkpointer_gc_keeps_newest(tmp_path, comm):
    ckpt = create_multi_node_checkpointer("gc", comm, path=str(tmp_path),
                                          keep=2)
    state = {"x": torch.zeros(2)}
    for it in [1, 2, 3, 4, 5]:
        ckpt.save(state, iteration=it)
    assert sorted(os.listdir(tmp_path)) == ["snapshot_gc_0_4.npz",
                                            "snapshot_gc_0_5.npz"]
    _, it = ckpt.maybe_load(state)
    assert it == 5


def test_checkpointer_resumes_max_common(tmp_path, comm):
    ckpt = create_multi_node_checkpointer("agree", comm, path=str(tmp_path),
                                          keep=10)
    state = {"x": torch.ones(2)}
    ckpt.save(state, 10)
    ckpt.save(state, 20)
    _, it = ckpt.maybe_load(state)
    assert it == 20  # newest common (one process: newest local)


def test_checkpointer_keys_by_tree_path_not_position(tmp_path, comm):
    """Same-shaped leaves restore by NAME, whatever the template's key
    order."""
    ckpt = create_multi_node_checkpointer("paths", comm, path=str(tmp_path))
    ckpt.save({"alpha": torch.full((2, 2), 1.0),
               "beta": torch.full((2, 2), 2.0)}, 1)
    restored, _ = ckpt.maybe_load({"beta": torch.zeros(2, 2),
                                   "alpha": torch.zeros(2, 2)})
    assert torch.equal(restored["alpha"], torch.full((2, 2), 1.0))
    assert torch.equal(restored["beta"], torch.full((2, 2), 2.0))


@pytest.mark.parametrize("saved,template,match", [
    ({"w": torch.zeros(3), "b": torch.zeros(3)},
     {"w": torch.zeros(3), "bias": torch.zeros(3)}, "key set"),
    ({"w": torch.zeros(3)}, {"w": torch.zeros(3), "b": torch.zeros(3)},
     "key set"),
    ({"w": torch.zeros(3), "b": torch.zeros(3)}, {"w": torch.zeros(3)},
     "key set"),
    ({"w": torch.zeros(3, 4)}, {"w": torch.zeros(4, 3)}, "shape"),
    ({"w": torch.zeros(3), "s": 1}, {"w": torch.zeros(3), "s": torch.ones(1)},
     "saved as a value"),
], ids=["renamed", "missing", "extra", "reshaped", "kind"])
def test_checkpointer_mismatch_fails_loudly(tmp_path, comm, saved, template,
                                            match):
    ckpt = create_multi_node_checkpointer("strict", comm, path=str(tmp_path))
    ckpt.save(saved, 1)
    with pytest.raises(ValueError, match=match):
        ckpt.maybe_load(template)


def test_checkpointer_cleanup(tmp_path, comm):
    ckpt = create_multi_node_checkpointer("clean", comm, path=str(tmp_path))
    ckpt.save({"x": torch.zeros(1)}, 1)
    ckpt.save({"x": torch.zeros(1)}, 2, block=False)
    ckpt.cleanup()
    assert os.listdir(tmp_path) == []
    ckpt.close()


def test_sharded_leaf_save_raises_naming_the_roadmap_item(tmp_path, comm):
    """DTensor leaves are saved since ROADMAP queue 1, item 6.2
    (tests/test_torch_sharded_checkpoint.py); the older ShardedTensor
    still raises, naming the DTensor to use instead."""
    class ShardedTensor(torch.Tensor):
        pass

    ckpt = create_multi_node_checkpointer("shard", comm, path=str(tmp_path))
    with pytest.raises(NotImplementedError,
                       match="ShardedTensor .* not ported.*DTensor"):
        ckpt.save({"w": torch.zeros(2).as_subclass(ShardedTensor)}, 1)


class TestAsyncCheckpoint:
    def test_async_save_roundtrip(self, comm, tmp_path):
        """block=False saves become durable at wait_async (GC runs there:
        only ``keep`` newest remain); maybe_load drains first."""
        ckpt = create_multi_node_checkpointer("async", comm,
                                              path=str(tmp_path), keep=2)
        for it in range(1, 5):
            ckpt.save(_state(it), it, block=False)
        ckpt.wait_async()
        assert len(os.listdir(tmp_path)) == 2
        restored, it = ckpt.maybe_load(_template())
        assert it == 4 and int(restored["step"]) == 4
        assert torch.equal(restored["w"], _state()["w"])
        ckpt.close()

    def test_async_failure_surfaces_at_wait(self, comm, tmp_path):
        ckpt = create_multi_node_checkpointer("fail", comm,
                                              path=str(tmp_path), keep=0)
        state = {"w": torch.zeros(2)}
        ckpt.save(state, 1, block=False)
        ckpt.wait_async()
        ckpt.path = str(tmp_path / "gone" / "deeper")
        ckpt.save(state, 2, block=False)
        with pytest.raises(RuntimeError, match="checkpoint write"):
            ckpt.wait_async()
        ckpt.close()

    def test_writer_overlaps(self, tmp_path):
        """submit returns while the data is still being made durable."""
        w = AsyncCheckpointWriter(queue_depth=4)
        blob = b"x" * (32 << 20)
        for i in range(4):
            w.submit(str(tmp_path / f"f{i}.bin"), blob)
        assert w.pending > 0
        w.wait()
        assert w.pending == 0
        for i in range(4):
            assert (tmp_path / f"f{i}.bin").stat().st_size == len(blob)
        w.finalize()


def test_async_writer_use_after_finalize_raises(tmp_path):
    w = AsyncCheckpointWriter()
    w.submit(str(tmp_path / "a.bin"), b"abc")
    w.wait()
    assert (tmp_path / "a.bin").read_bytes() == b"abc"
    w.finalize()
    with pytest.raises(RuntimeError, match="after finalize"):
        w.submit(str(tmp_path / "b.bin"), b"abc")
    with pytest.raises(RuntimeError, match="after finalize"):
        w.wait()


def test_async_writer_builds_into_the_port_build_dir():
    from chainermn_tpu_torch.native import BUILD_DIR, lib_path

    lib = lib_path("ckpt_writer")
    assert lib.parent == BUILD_DIR
    assert BUILD_DIR.parts[-2:] == ("chainermn_tpu_torch", "build")


# ---------------------------------------------------------------- shards

def test_global_from_shards_coverage_and_conflicts(tmp_path, comm):
    full = np.arange(12, dtype=np.float32).reshape(6, 2)
    merged = {"w@@0:3|0:2": full[0:3], "w@@3:6|0:2": full[3:6]}
    out = MultiNodeCheckpointer._global_from_shards("w", merged, (6, 2),
                                                    np.float32)
    np.testing.assert_array_equal(out, full)
    with pytest.raises(ValueError, match="do not cover"):
        MultiNodeCheckpointer._global_from_shards(
            "w", {"w@@0:3|0:2": full[0:3]}, (6, 2), np.float32)
    with pytest.raises(ValueError, match="no shards"):
        MultiNodeCheckpointer._global_from_shards("v", merged, (6, 2),
                                                  np.float32)
    # two ranks' files that disagree on one key: a corrupt set
    for rank, val in ((0, 0.0), (1, 1.0)):
        np.savez(tmp_path / f"snapshot_c_{rank}_3.npz", w=np.full(2, val))
    ckpt = MultiNodeCheckpointer("c", comm, path=str(tmp_path))
    with pytest.raises(ValueError, match="conflicting copies"):
        ckpt._merged_shard_data(3)


class TestStridedShardIndices:
    def test_index_str_contiguous_unchanged(self):
        assert _index_str((slice(0, 4), slice(None)), (8, 3)) == "0:4|0:3"

    def test_index_str_strided(self):
        assert _index_str((slice(0, 8, 2), slice(0, 4)), (8, 4)) \
            == "0:8:2|0:4"
        assert _index_str((slice(1, 8, 2),), (8,)) == "1:8:2"

    def test_global_from_shards_reassembles_strided(self):
        full = np.arange(32.0).reshape(8, 4)
        merged = {f"w{_SHARD_SEP}0:8:2|0:4": full[0:8:2],
                  f"w{_SHARD_SEP}1:8:2|0:4": full[1:8:2]}
        out = MultiNodeCheckpointer._global_from_shards("w", merged, (8, 4),
                                                        np.float32)
        np.testing.assert_array_equal(out, full)

    def test_global_from_shards_strided_hole_fails_loudly(self):
        full = np.arange(32.0).reshape(8, 4)
        merged = {f"w{_SHARD_SEP}0:8:2|0:4": full[0:8:2]}
        with pytest.raises(ValueError, match="do not cover"):
            MultiNodeCheckpointer._global_from_shards("w", merged, (8, 4),
                                                      np.float32)

    def test_index_str_matches_the_jax_format(self):
        from chainermn_tpu.extensions.checkpoint import (
            _index_str as jax_index_str,
        )

        for index, shape in (((slice(0, 4), slice(None)), (8, 3)),
                             ((slice(1, 8, 2),), (8,)),
                             ((slice(None, None, 3), slice(2, 5)), (9, 6))):
            assert _index_str(index, shape) == jax_index_str(index, shape)


# ---------------------------------------------------------------- agreement

class _Gathered:
    """A communicator whose ``allgather_obj`` hands back every rank's
    entry at once: rank r's iterations and drain error."""

    def __init__(self, its, errs):
        self.entries = [{"its": sorted(i), "err": e}
                        for i, e in zip(its, errs)]

    def allgather_obj(self, obj):
        return list(self.entries)


@pytest.mark.parametrize("its,errs", [
    ([[10, 20], [20, 30]], [None, None]),
    ([[1], [2]], [None, None]),
    ([[], []], [None, None]),
    ([[5, 3, 9], [9, 3], [3, 9, 5]], [None, None, None]),
    ([[40, 10, 20], [10, 20, 30, 40], [20, 40], [40]], [None] * 4),
    ([[10, 20], [10, 20]], [None, "2 async checkpoint write(s) failed"]),
    ([[1], [1], [1]], ["disk full", None, "gone"]),
], ids=["overlap", "disjoint", "empty", "three", "four", "drain1", "drain2"])
def test_agree_max_common_step_matches_jax(its, errs):
    comm = _Gathered(its, errs)
    try:
        want = jax_agree(comm, its[0], errs[0])
    except RuntimeError as e:
        with pytest.raises(RuntimeError) as got:
            agree_max_common_step(comm, its[0], errs[0])
        assert str(got.value) == str(e)
        return
    assert agree_max_common_step(comm, its[0], errs[0]) == want


# ---------------------------------------------------------------- TrainState

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
           max_len=32)


def _batches(n):
    rs = np.random.RandomState(3)
    return [torch.from_numpy(rs.randint(0, 64, size=(2, 16))) for _ in
            range(n)]


def _loss(model, tokens):
    return lm_loss(model(tokens), tokens)


def _build(comm):
    model = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu",
                          attention_fn=flash_attention, seed=1)
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4),
        comm, double_buffering=True)
    return create_train_state(model, opt, comm), make_train_step(_loss, opt,
                                                                 comm)


def _run(step, state, batches):
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("block", [True, False], ids=["blocking", "async"])
def test_train_state_with_double_buffering_resumes_bit_for_bit(
        tmp_path, comm, block):
    batches = _batches(6)
    state, step = _build(comm)
    ref_state, ref = _run(step, state, batches)
    state, step = _build(comm)
    state, first = _run(step, state, batches[:3])
    saved_opt = state.optimizer.state_dict()
    ckpt = create_multi_node_checkpointer("lm", comm, path=str(tmp_path))
    ckpt.save(state, 3, block=block)
    fresh, step = _build(comm)
    fresh, it = ckpt.maybe_load(fresh)
    assert it == 3 and fresh.step == 3
    got_opt = fresh.optimizer.state_dict()
    assert got_opt["actual_optimizer"]["param_groups"] == \
        saved_opt["actual_optimizer"]["param_groups"]
    for i, per in saved_opt["actual_optimizer"]["state"].items():
        for name, t in per.items():  # step, exp_avg, exp_avg_sq
            g = got_opt["actual_optimizer"]["state"][i][name]
            assert g.dtype == t.dtype and torch.equal(g, t), (i, name)
    for a, b in zip(got_opt["bank"], saved_opt["bank"]):
        assert torch.equal(a, b)
    fresh, rest = _run(step, fresh, batches[3:])
    assert first + rest == ref
    for (n, a), b in zip(fresh.model.state_dict().items(),
                         ref_state.model.state_dict().values()):
        assert torch.equal(a, b), n
    ckpt.close()


def test_a_resume_without_the_bank_is_not_the_same_run(tmp_path, comm):
    """The bank holds the gradients the next step applies; dropping it
    (as a checkpoint of the inner optimizer alone would) changes the
    resumed losses."""
    batches = _batches(4)
    state, step = _build(comm)
    _, ref = _run(step, state, batches)
    state, step = _build(comm)
    state, _ = _run(step, state, batches[:2])
    ckpt = create_multi_node_checkpointer("bank", comm, path=str(tmp_path))
    ckpt.save(state, 2)
    fresh, step = _build(comm)
    fresh, _ = ckpt.maybe_load(fresh)
    fresh.optimizer._bank = None
    _, rest = _run(step, fresh, batches[2:])
    assert rest != ref[2:]


def test_a_failed_restore_leaves_the_template_optimizer_empty(tmp_path,
                                                              comm):
    state, _ = _build(comm)
    ckpt = create_multi_node_checkpointer("bad", comm, path=str(tmp_path))
    ckpt.save({"w": torch.zeros(2)}, 1)
    with pytest.raises(ValueError, match="key set"):
        ckpt.maybe_load(state)
    assert not state.optimizer.actual_optimizer.state


# ---------------------------------------------------------------- gloo ranks

@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """One launch at 2 ranks, then one at 4, sharing the resize
    directory: the 4 ranks restore what the 2 saved."""
    resize = tmp_path_factory.mktemp("resize")
    return {n: run_distributed(
        checkpoint_worker, n,
        {"dir": str(tmp_path_factory.mktemp(f"ranks{n}")),
         "resize_dir": str(resize)}, timeout=120) for n in (2, 4)}


@pytest.mark.parametrize("size", [2, 4])
def test_ranks_agree_on_the_newest_common_iteration(rank_runs, size):
    for out in rank_runs[size]:
        assert int(out["agree"]) == 20  # 30 misses on rank 0, 40 on the last
        assert bool(out["disjoint_none"])


@pytest.mark.parametrize("size", [2, 4])
def test_one_ranks_drain_error_raises_on_every_rank(rank_runs, size):
    for out in rank_runs[size]:
        msg = str(out["drain_raised"])
        assert msg.startswith("async checkpoint write failures detected")
        assert "rank 1:" in msg and "rank 0:" not in msg


def test_world_resize_restores_two_ranks_snapshot_on_four(rank_runs):
    for out in rank_runs[4]:
        assert int(out["resize_it"]) == 7 and bool(out["resize_ok"])
        np.testing.assert_array_equal(out["resize_w"],
                                      np.arange(12.0).reshape(3, 4))


def test_a_frozen_parameter_restores_through_the_train_step(tmp_path, comm):
    """The train step gives every parameter a gradient (zeros for a
    frozen one), so the optimizer holds state for each; the primed
    template must expect the same set."""
    from chainermn_tpu_torch.models import MLP

    def build():
        model = MLP(n_units=16, seed=0, device="cpu")
        next(model.parameters()).requires_grad_(False)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2)

        def loss(m, b):
            return torch.nn.functional.cross_entropy(m(b[0]), b[1])

        return (create_train_state(model, opt, comm),
                make_train_step(loss, opt, comm))

    g = torch.Generator().manual_seed(0)
    batches = [(torch.randn(4, 784, generator=g),
                torch.randint(0, 10, (4,), generator=g)) for _ in range(4)]
    state, step = build()
    _, ref = _run(step, state, batches)
    state, step = build()
    state, first = _run(step, state, batches[:2])
    ckpt = create_multi_node_checkpointer("frozen", comm, path=str(tmp_path))
    ckpt.save(state, 2)
    fresh, step = build()
    fresh, it = ckpt.maybe_load(fresh)
    assert it == 2
    _, rest = _run(step, fresh, batches[2:])
    assert first + rest == ref
