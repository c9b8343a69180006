"""The checkpointer's sharded leaves (``DTensor``) against the JAX
package's sharded format, at 2 and 4 gloo ranks
(``tests/torch_tp_workers.py::sharded_ckpt_worker``, one launch per world
size; the 4-rank launch first, since the 2 ranks restore what it saved):

- the keys each rank writes for ``{"params": {"w": [8, 6] sharded on
  dim 0, "b": [6] replicated}}`` equal the keys the JAX package writes
  for the same tree on the same process (``path@@start:stop|...`` for the
  local shard, the path alone for the whole leaf), and the port restores
  its own shard;
- the port reads a sharded snapshot written by the JAX package (its
  ``MultiNodeCheckpointer.save`` on a leaf whose addressable shards are
  each process's rows, the multi-process layout): at the same world size
  each rank takes its shard, and from another world size
  (``allow_world_resize``) the leaf is reassembled and re-cut;
- an FSDP train state (the MLP with AdamW, parameters and moments as
  DTensors) saved after 2 steps and loaded into a fresh one gives the
  losses of 4 steps without a stop, bit for bit;
- the FSDP state saved by 4 ranks restores on 2: the full parameters,
  Adam's moments and its step come back exactly, on the 2-rank
  placements.

No tolerance: every restored value is compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chainermn_tpu.extensions.checkpoint import (
    MultiNodeCheckpointer as JaxCheckpointer,
)
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu_torch.convert import mlp_state_from_flax
from chainermn_tpu_torch.testing import run_distributed
from torch_rank_workers import few_threads  # noqa: F401
from torch_tp_workers import sharded_ckpt_worker

SIZES = (4, 2)  # 4 first: the 2 ranks restore its FSDP snapshot
RESIZE_FROM = 4
W_SHAPE, B_SHAPE = (8, 6), (6,)


class _Shard:
    def __init__(self, index, data):
        self.index, self.data = index, data


class _ProcessShardedLeaf(jax.Array):
    """A global ``[8, 6]`` array as one process of ``n`` sees it: not
    fully addressable, its addressable shard this process's rows (what
    the JAX checkpointer saves for a multi-process sharded leaf)."""

    def __init__(self, full, rank, n):
        rows = full.shape[0] // n
        index = (slice(rank * rows, (rank + 1) * rows), slice(None))
        self._full = full
        self._shards = [_Shard(index, full[index])]

    shape = property(lambda self: self._full.shape)
    dtype = property(lambda self: self._full.dtype)
    is_fully_addressable = property(lambda self: False)
    addressable_shards = property(lambda self: self._shards)


class _Rank:
    def __init__(self, rank):
        self.rank = rank


def _jax_write(path, w, b, n, name="jaxsharded", it=9):
    """The JAX package's snapshot files of ``{"params": {"w", "b"}}`` for
    ``n`` processes; returns each rank's keys."""
    keys = []
    for r in range(n):
        ck = JaxCheckpointer(name, _Rank(r), path=str(path))
        fname = ck.save({"params": {"w": _ProcessShardedLeaf(w, r, n),
                                    "b": b}}, it)
        with np.load(fname) as f:
            keys.append(sorted(f.files))
    return keys


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rs = np.random.RandomState(0)
    w = rs.randn(*W_SHAPE).astype(np.float32)
    b = rs.randn(*B_SHAPE).astype(np.float32)
    model = JaxMLP(n_units=64, n_out=4)
    x = rs.randn(32, 10).astype(np.float32)
    y = rs.randint(0, 4, size=32).astype(np.int32)
    params = model.init(jax.random.key(0), jnp.asarray(x[:1]))["params"]
    sd = mlp_state_from_flax(jax.tree.map(np.asarray, params))
    inputs = {"ckpt/w": w, "ckpt/b": b, "fsdp/x": x, "fsdp/y": y,
              "resize_save": np.array(RESIZE_FROM),
              "resize_dir": str(tmp_path_factory.mktemp("resize")),
              **{f"fsdp/sd/{k}": v.numpy() for k, v in sd.items()}}
    jax_keys = {}
    for n in SIZES:
        other = 4 if n == 2 else 2
        same = tmp_path_factory.mktemp(f"jax_same{n}")
        jax_keys[n] = _jax_write(same, w, b, n)
        oth = tmp_path_factory.mktemp(f"jax_other{n}")
        _jax_write(oth, w, b, other)
        inputs[f"jax_same_dir{n}"] = str(same)
        inputs[f"jax_other_dir{n}"] = str(oth)
    return inputs, jax_keys, w, b


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    inputs, *_ = setup
    out = {}
    for n in SIZES:
        mine = dict(inputs, dir=str(tmp_path_factory.mktemp(f"ranks{n}")),
                    jax_same_dir=inputs[f"jax_same_dir{n}"],
                    jax_other_dir=inputs[f"jax_other_dir{n}"])
        out[n] = run_distributed(sharded_ckpt_worker, n, mine, timeout=180)
    return out


@pytest.mark.parametrize("n", SIZES)
def test_keys_equal_the_jax_package_s(setup, runs, n):
    _, jax_keys, w, _ = setup
    rows = W_SHAPE[0] // n
    for r, o in enumerate(runs[n]):
        assert o["keys"].tolist() == jax_keys[n][r]
        assert f"['params']['w']@@{r * rows}:{(r + 1) * rows}|0:6" in \
            jax_keys[n][r]
        assert int(o["keys/it"]) == 5
        np.testing.assert_array_equal(o["keys/w"],
                                      w[r * rows:(r + 1) * rows])


@pytest.mark.parametrize("tag", ["jax_same", "jax_other"])
@pytest.mark.parametrize("n", SIZES)
def test_reads_a_sharded_snapshot_the_jax_package_wrote(setup, runs, n,
                                                        tag):
    _, _, w, b = setup
    rows = W_SHAPE[0] // n
    for r, o in enumerate(runs[n]):
        assert int(o[f"{tag}/it"]) == 9
        np.testing.assert_array_equal(o[f"{tag}/w_local"],
                                      w[r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(o[f"{tag}/w"], w)
        np.testing.assert_array_equal(o[f"{tag}/b"], b)


@pytest.mark.parametrize("n", SIZES)
def test_fsdp_state_resumes_bit_for_bit(runs, n):
    for o in runs[n]:
        assert int(o["resume/start"]) == 2
        assert o["resume/got"].tolist() == o["resume/ref"].tolist()


def test_fsdp_state_saved_by_four_ranks_restores_on_two(runs):
    saved, restored = runs[4][0], runs[2]
    names = [k[len("resize/p/"):] for k in saved if k.startswith(
        "resize/p/")]
    assert names
    for o in restored:
        assert int(o["resize/start"]) == 2
        for name in names:
            np.testing.assert_array_equal(o[f"resize/p/{name}"],
                                          saved[f"resize/p/{name}"])
        np.testing.assert_array_equal(o["resize/exp_avg"],
                                      saved["resize/exp_avg"])
        assert float(o["resize/step"]) == float(saved["resize/step"]) == 2
    # the hidden kernel is placed for 2 ranks, the biases replicated
    assert str(restored[0]["resize/placement/dense1.weight"]).startswith(
        "Shard")
    assert str(restored[0]["resize/placement/dense0.bias"]) == "Replicate()"
