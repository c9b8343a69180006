"""Fault-tolerant multi-node checkpointing (counterpart of
``chainermn_tpu/extensions/checkpoint.py``).

Reference: ``chainermn/extensions/checkpoint.py`` (SURVEY.md sections 2.7,
3.5): ``create_multi_node_checkpointer(name, comm)`` snapshots per-rank
files tagged ``(name, rank, iteration)``, removes stale snapshots beyond
``keep``, and on restart ``maybe_load`` agrees, through one object
collective, on the newest iteration EVERY rank holds.

What is stored: a :class:`~chainermn_tpu_torch.training.TrainState` (its
``model.state_dict()``, its ``optimizer.state_dict()`` — for a
:class:`~chainermn_tpu_torch.optimizers.MultiNodeOptimizer` the inner
optimizer's state and the double-buffering bank — and ``step``), or any
nested mapping, list or tuple of tensors, numpy arrays and Python scalars.
Each leaf is keyed by its path in that tree (``['model']['ln_f.weight']``,
``['optimizer']['actual_optimizer']['state'][0]['exp_avg']``, the JAX
``keystr`` form), never by its position. Tensors go into the ``.npz`` as
arrays (dtypes numpy lacks, such as bfloat16, as integer views of the same
width), restored bit for bit, AdamW's per-parameter ``step`` tensors
included. The leaves that are not arrays — the optimizer's
``param_groups`` hyperparameters (floats, bools, None, strings), its
integer parameter ids, ``step`` — go into one JSON entry
(``__leaves__``) with each array leaf's dtype; JSON writes a float by its
shortest exact form, so they come back equal, and tuples and lists come
back as the restoring template has them.

Restore is strict, by path: a renamed, missing, extra or reshaped leaf
raises instead of loading a tensor into the wrong place. A fresh
optimizer holds no per-parameter state until its first step, so to know
the paths and shapes to expect, ``maybe_load`` first gives an empty
optimizer its state with one step on zero gradients at learning rate 0
(the parameters do not move; ``torch.distributed.checkpoint`` primes
optimizers the same way), then loads the saved state over it.

Sharded leaves (``DTensor``, as :mod:`chainermn_tpu_torch.parallel.fsdp`
places parameters and optimizer state) are saved as the JAX package saves
a multi-process sharded array: each rank writes only its local shard,
keyed ``path@@start:stop|...`` by its global index (:func:`_index_str`); a
replicated ``DTensor`` is written whole under its path. A restore at the
same world size takes each rank's shard by the template leaf's own
index; ``allow_world_resize=True`` reassembles each leaf from every
rank's files (:meth:`MultiNodeCheckpointer._global_from_shards`) and cuts
the template's shard out of it, so 4 ranks' FSDP state loads on 2. A
snapshot that the JAX package wrote (arrays only, no ``__leaves__``
entry) restores into a template of tensors the same way. ``ShardedTensor``
leaves raise.
"""

from __future__ import annotations

import io
import json
import os
import re
from typing import Mapping, Optional

import numpy as np
import torch

from chainermn_tpu_torch.communicators.base import CommunicatorBase

_FNAME_RE = re.compile(
    r"^snapshot_(?P<name>.+)_(?P<rank>\d+)_(?P<iter>\d+)\.npz$")

#: separates the tree-path key from a shard's global-index suffix
_SHARD_SEP = "@@"
#: the npz entry with the non-array leaves and the array leaves' dtypes
_LEAVES_KEY = "__leaves__"
#: dtypes numpy cannot hold, stored as integer views of the same width
_VIEWED = {torch.bfloat16: torch.int16}
_SCALARS = (bool, int, float, str, type(None))


def _index_str(index, shape) -> str:
    """Canonical string for a shard's global index: ``start:stop`` per
    dim, or ``start:stop:step`` for a strided shard, normalised against
    the global shape (so device numbering never enters the format)."""
    parts = []
    for sl, dim in zip(index, shape):
        start, stop, step = sl.indices(dim)
        if step == 1:
            parts.append(f"{start}:{stop}")
        else:
            parts.append(f"{start}:{stop}:{step}")
    return "|".join(parts)


# ---------------------------------------------------------------- trees

def _is_train_state(state) -> bool:
    from chainermn_tpu_torch.training.train_step import TrainState

    return isinstance(state, TrainState)


def _tree_of(state):
    """The nested containers a state is saved as: a TrainState becomes
    ``{"model", "optimizer", "step"}``; anything else is itself."""
    if _is_train_state(state):
        return {"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}
    return state


def _is_dtensor(leaf) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a torch without DTensor holds none
        return False
    return isinstance(leaf, DTensor)


def _dtensor_index(leaf) -> tuple:
    """The global slices of this rank's local shard of a ``DTensor``:
    along each ``Shard(d)`` mesh dim, the chunks of ``torch.chunk``
    (``ceil(size / n)`` each, the last ones shorter or empty)."""
    from torch.distributed.tensor import Replicate, Shard

    bounds = [[0, s] for s in leaf.shape]
    coord = leaf.device_mesh.get_coordinate()
    for i, pl in enumerate(leaf.placements):
        if isinstance(pl, Replicate):
            continue
        if type(pl) is not Shard:
            raise NotImplementedError(
                f"checkpointing a DTensor placed {pl} is not ported (Shard "
                "and Replicate are)")
        lo, hi = bounds[pl.dim]
        n = leaf.device_mesh.size(i)
        c = -(-(hi - lo) // n)
        start = min(lo + coord[i] * c, hi)
        bounds[pl.dim] = [start, min(start + c, hi)]
    return tuple(slice(a, b) for a, b in bounds)


def _is_replicated(leaf) -> bool:
    from torch.distributed.tensor import Replicate

    return all(isinstance(pl, Replicate) for pl in leaf.placements)


def _flatten(tree, path: str = "", out: Optional[dict] = None):
    """``(skeleton, {path: leaf})``: the leaves of ``tree`` keyed by their
    JAX-``keystr`` paths, and a skeleton that rebuilds the containers
    (:func:`_unflatten`)."""
    if out is None:
        out = {}
    if isinstance(tree, Mapping):
        items = []
        for k, v in tree.items():
            if isinstance(k, bool) or not isinstance(k, (str, int)):
                raise TypeError(f"checkpoint keys must be str or int, got "
                                f"{k!r} at {path or '<root>'}")
            items.append((k, _flatten(v, f"{path}[{k!r}]", out)[0]))
        return ("dict", type(tree), items), out
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        kids = [_flatten(v, f"{path}[{i}]", out)[0]
                for i, v in enumerate(tree)]
        return (type(tree).__name__, None, kids), out
    key = path or "<root>"
    if _SHARD_SEP in key:
        raise ValueError(f"tree-path key {key!r} contains {_SHARD_SEP!r}")
    if type(tree).__name__ == "ShardedTensor":
        raise NotImplementedError(
            f"the ShardedTensor leaf {key!r} is not ported; place sharded "
            "state as a DTensor")
    if not isinstance(tree, (torch.Tensor, np.ndarray, np.generic)
                      + _SCALARS):
        raise TypeError(f"cannot checkpoint a leaf of type {type(tree)} at "
                        f"{key}")
    out[key] = tree
    return ("leaf", key), out


def _unflatten(skeleton, values: dict):
    kind = skeleton[0]
    if kind == "leaf":
        return values[skeleton[1]]
    if kind == "dict":
        cls = skeleton[1]
        built = {k: _unflatten(s, values) for k, s in skeleton[2]}
        return built if cls is dict else cls(built)
    kids = [_unflatten(s, values) for s in skeleton[2]]
    return tuple(kids) if kind == "tuple" else kids


def _to_array(leaf) -> np.ndarray:
    t = leaf.detach().cpu()
    if t.dtype in _VIEWED:
        t = t.view(_VIEWED[t.dtype])
    return t.numpy()


def _meta_and_arrays(state) -> tuple[dict, dict]:
    """``({path: ["array", dtype] | ["value", v]}, {path: ndarray})``."""
    _, leaves = _flatten(_tree_of(state))
    meta, arrays = {}, {}
    for key, leaf in leaves.items():
        if _is_dtensor(leaf):
            meta[key] = ["array", str(leaf.dtype)]
            local = _to_array(leaf.to_local())
            if _is_replicated(leaf):
                arrays[key] = local
            else:
                index = _index_str(_dtensor_index(leaf), leaf.shape)
                arrays[f"{key}{_SHARD_SEP}{index}"] = local
        elif isinstance(leaf, torch.Tensor):
            meta[key] = ["array", str(leaf.dtype)]
            arrays[key] = _to_array(leaf)
        elif isinstance(leaf, (np.ndarray, np.generic)):
            meta[key] = ["array", f"numpy.{np.asarray(leaf).dtype}"]
            arrays[key] = np.asarray(leaf)
        else:
            meta[key] = ["value", leaf]
    return meta, arrays


def _npz_bytes(state) -> bytes:
    meta, arrays = _meta_and_arrays(state)
    buf = io.BytesIO()
    np.savez(buf, **arrays, **{_LEAVES_KEY: np.array(json.dumps(meta))})
    return buf.getvalue()


def _prime_optimizer(optimizer) -> bool:
    """Give an optimizer without per-parameter state its state: one step
    on zero gradients at learning rate 0 (gradients and rates restored
    after). Every parameter gets a gradient, as in the port's train step
    (``allreduce_grad`` gives a parameter without one zeros, the JAX
    step's gradient of every leaf), so every parameter gets its state.
    Returns whether it did."""
    inner = getattr(optimizer, "actual_optimizer", optimizer)
    if inner.state:
        return False
    params = [p for g in inner.param_groups for p in g["params"]]
    grads = [p.grad for p in params]
    lrs = [g.get("lr") for g in inner.param_groups]
    try:
        for p in params:
            p.grad = torch.zeros_like(p)
        for g in inner.param_groups:
            if "lr" in g:
                g["lr"] = (torch.zeros_like(g["lr"])
                           if isinstance(g["lr"], torch.Tensor) else 0.0)
        with torch.no_grad():
            inner.step()
    finally:
        for p, g in zip(params, grads):
            p.grad = g
        for g, lr in zip(inner.param_groups, lrs):
            if lr is not None:
                g["lr"] = lr
    return True


def _unprime(optimizer) -> None:
    getattr(optimizer, "actual_optimizer", optimizer).state.clear()


def _template_leaves(template):
    """``(skeleton, {path: leaf})`` of a restore template, a TrainState's
    optimizer primed first (undone by the caller on failure)."""
    primed = (_is_train_state(template)
              and _prime_optimizer(template.optimizer))
    skeleton, leaves = _flatten(_tree_of(template))
    return skeleton, leaves, primed


def _into(template, tree):
    """Load a rebuilt tree into the template: a TrainState's module and
    optimizer in place (returned as a TrainState with the saved step),
    anything else returned as is."""
    if not _is_train_state(template):
        return tree
    template.model.load_state_dict(tree["model"])
    template.optimizer.load_state_dict(tree["optimizer"])
    return template._replace(step=tree["step"])


def _restore_leaf(key, arr, meta, t):
    """The saved array ``arr`` as the template leaf ``t`` (a tensor on
    its device and dtype, or a numpy array; for a ``DTensor`` template,
    ``arr`` is this rank's shard and a ``DTensor`` of the template's
    placements comes back)."""
    if _is_dtensor(t):
        from torch.distributed.tensor import DTensor

        local = _restore_leaf(key, arr, meta, t.to_local())
        return DTensor.from_local(local, t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    if tuple(arr.shape) != tuple(np.shape(t)):
        raise ValueError(f"checkpoint leaf {key!r} has shape "
                         f"{tuple(arr.shape)}, template expects "
                         f"{tuple(np.shape(t))}")
    if isinstance(t, torch.Tensor):
        saved = torch.from_numpy(np.array(arr))
        dtype = meta[1]
        if dtype.startswith("torch."):
            want = getattr(torch, dtype[len("torch."):])
            if want in _VIEWED:
                saved = saved.view(want)
        return saved.to(dtype=t.dtype, device=t.device)
    return np.asarray(arr).astype(np.asarray(t).dtype)


def _restore(template, meta: dict, array_of, where: str):
    """Rebuild ``template`` from saved leaves: ``meta`` as
    :func:`_meta_and_arrays` wrote it, ``array_of(key, template_leaf)``
    the saved array of an array leaf. Strict by path."""
    skeleton, leaves, primed = _template_leaves(template)
    try:
        wanted, saved = set(leaves), set(meta)
        if saved != wanted:
            raise ValueError(
                f"checkpoint {where} key set does not match the state "
                f"template: missing={sorted(wanted - saved)[:8]} "
                f"unexpected={sorted(saved - wanted)[:8]}")
        values = {}
        for key, t in leaves.items():
            kind = meta[key][0]
            is_array = isinstance(t, (torch.Tensor, np.ndarray, np.generic))
            if is_array != (kind == "array"):
                raise ValueError(
                    f"checkpoint leaf {key!r} was saved as "
                    f"{'an array' if kind == 'array' else 'a value'}, the "
                    "template holds "
                    f"{'an array' if is_array else 'a value'} there")
            values[key] = (_restore_leaf(key, array_of(key, t), meta[key], t)
                           if is_array else meta[key][1])
        return _into(template, _unflatten(skeleton, values))
    except BaseException:
        if primed:
            _unprime(template.optimizer)
        raise


# ---------------------------------------------------------------- agreement

def agree_max_common_step(comm: CommunicatorBase, local_iterations,
                          drain_err: Optional[str] = None) -> Optional[int]:
    """The cross-rank resume agreement, shared by every checkpoint backend
    (npz and dcp): allgather ``(iterations, drain error)`` in ONE
    collective, raise on EVERY rank if any rank's async writes failed (a
    raise before the collective would leave the healthy ranks waiting in
    it), else return the newest iteration all ranks hold (None when there
    is none). Reference protocol: SURVEY.md section 3.5."""
    everyone = comm.allgather_obj(
        {"its": sorted(local_iterations), "err": drain_err})
    errs = [f"rank {r}: {e['err']}" for r, e in enumerate(everyone)
            if e["err"]]
    if errs:
        raise RuntimeError("async checkpoint write failures detected at "
                           "restore: " + "; ".join(errs))
    common = set(everyone[0]["its"])
    for entry in everyone[1:]:
        common &= set(entry["its"])
    return max(common) if common else None


# ---------------------------------------------------------------- npz

class MultiNodeCheckpointer:
    """Per-rank ``snapshot_{name}_{rank}_{iteration}.npz`` files in
    ``path``, the newest ``keep`` kept (see the module docstring)."""

    def __init__(self, name: str, comm: CommunicatorBase, *,
                 path: str = "checkpoints", keep: int = 2) -> None:
        self.name = name
        self.comm = comm
        self.path = path
        self.keep = keep
        self._writer = None  # the native async writer, made at first use
        os.makedirs(path, exist_ok=True)

    def _fname(self, iteration: int, rank: Optional[int] = None) -> str:
        rank = self.comm.rank if rank is None else rank
        return os.path.join(self.path,
                            f"snapshot_{self.name}_{rank}_{iteration}.npz")

    def _listdir(self) -> list[str]:
        """The snapshot directory's entries; none when it is gone (a rank
        must still reach the agreement's collective, where its drain
        error is reported, instead of raising before it)."""
        try:
            return os.listdir(self.path)
        except FileNotFoundError:
            return []

    def _local_iterations(self) -> list[int]:
        its = []
        for fn in self._listdir():
            m = _FNAME_RE.match(fn)
            if (m and m.group("name") == self.name
                    and int(m.group("rank")) == self.comm.rank):
                its.append(int(m.group("iter")))
        return sorted(its)

    def _directory_iterations(self) -> list[int]:
        """Iterations present for ANY rank (a world-resize restore: the
        saving world's rank numbering does not matter)."""
        its = set()
        for fn in self._listdir():
            m = _FNAME_RE.match(fn)
            if m and m.group("name") == self.name:
                its.add(int(m.group("iter")))
        return sorted(its)

    def _merged_shard_data(self, iteration: int) -> dict:
        """Union of every rank's saved entries at ``iteration`` (the
        directory must be shared storage); a key saved by several ranks
        must hold the same bytes everywhere."""
        merged: dict[str, np.ndarray] = {}
        for fn in sorted(self._listdir()):
            m = _FNAME_RE.match(fn)
            if not (m and m.group("name") == self.name
                    and int(m.group("iter")) == iteration):
                continue
            with np.load(os.path.join(self.path, fn)) as data:
                for k in data.files:
                    arr = np.asarray(data[k])
                    if k in merged:
                        prev = merged[k]
                        # bytes, not values: NaN == NaN and dtype-exact
                        if (prev.shape != arr.shape
                                or prev.dtype != arr.dtype
                                or prev.tobytes() != arr.tobytes()):
                            raise ValueError(
                                f"conflicting copies of {k!r} across ranks' "
                                f"snapshots at iteration {iteration} — "
                                "corrupt checkpoint set")
                        continue
                    merged[k] = arr
        return merged

    @staticmethod
    def _global_from_shards(key: str, merged: dict, tshape, dtype):
        """Reassemble one leaf's full global array from its shard entries
        (``key@@start:stop|...``, strided forms included); raises when
        their coverage has holes."""
        out = np.zeros(tshape, dtype)
        covered = np.zeros(tshape, bool)
        prefix = f"{key}{_SHARD_SEP}"
        found = False
        for skey, arr in merged.items():
            if not skey.startswith(prefix):
                continue
            found = True
            slices = tuple(slice(*map(int, part.split(":")))
                           for part in skey[len(prefix):].split("|"))
            out[slices] = arr
            covered[slices] = True
        if not found:
            raise ValueError(f"no shards found for leaf {key!r}")
        if not covered.all():
            raise ValueError(
                f"shards for leaf {key!r} do not cover the full global shape "
                f"{tuple(tshape)} — snapshot set incomplete (all ranks' files "
                "must be on shared storage for a world-resize restore)")
        return out

    # ------------------------------------------------------------------

    def save(self, state, iteration: int, *, block: bool = True) -> str:
        """Snapshot ``state`` for this rank, then remove this rank's
        snapshots beyond ``keep``.

        ``block=True``: a temporary file, fsync, rename over the final
        name, fsync of the directory, so a crash never leaves a torn
        snapshot under the final name. ``block=False``: the state is
        copied to host bytes now and handed to the native async writer
        (:mod:`chainermn_tpu_torch.native.ckpt_writer`), which makes it
        durable the same way on its own thread; call :meth:`wait_async`
        before treating the iteration as durable (``maybe_load`` does)."""
        data = _npz_bytes(state)
        fname = self._fname(iteration)
        if not block:
            if self._writer is None:
                from chainermn_tpu_torch.native.ckpt_writer import (
                    AsyncCheckpointWriter,
                )

                self._writer = AsyncCheckpointWriter()
            self._writer.submit(fname, data)
            # only durable files are scanned, so writes in flight are safe
            self._gc()
            return fname
        tmp = fname + ".tmp.npz"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)
        dfd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._gc()
        return fname

    def _gc(self) -> None:
        for it in self._local_iterations()[: -self.keep] if self.keep else []:
            try:
                os.remove(self._fname(it))
            except FileNotFoundError:
                pass

    def wait_async(self) -> None:
        """Drain the async writer: on return every ``block=False`` save is
        durable (raises if one failed), and stale snapshots are removed."""
        if self._writer is not None:
            self._writer.wait()
            self._gc()

    def close(self) -> None:
        """Drain AND release the native writer's thread and buffers, also
        when the drain raises a write failure."""
        try:
            self.wait_async()
        finally:
            if self._writer is not None:
                self._writer.finalize()
                self._writer = None

    def maybe_load(self, state_template, *, allow_world_resize: bool = False):
        """Resume from the newest iteration available on ALL ranks.
        Returns ``(state, iteration)``, or ``(state_template, None)`` when
        no common snapshot exists. A TrainState template is loaded in
        place (its module and optimizer) and comes back with the saved
        step.

        ``allow_world_resize=True`` restores snapshots written by another
        world size: iterations are found directory-wide and every leaf
        comes from the union of all ranks' files at that iteration (the
        directory must be shared storage; copies saved by several ranks
        must agree)."""
        # drain in-flight async saves so they count once durable; a write
        # failure travels through the collective instead of raising before
        # it, so every rank raises together
        drain_err = None
        try:
            self.wait_async()
        except RuntimeError as e:
            drain_err = str(e)
        its = (self._directory_iterations() if allow_world_resize
               else self._local_iterations())
        it = agree_max_common_step(self.comm, its, drain_err)
        if it is None:
            return state_template, None
        if allow_world_resize:
            merged = self._merged_shard_data(it)
            return self._restore_from(state_template, merged,
                                      f"iteration {it}", resized=True), it
        with np.load(self._fname(it)) as data:
            return self._restore_from(state_template, data,
                                      self._fname(it), resized=False), it

    def _restore_from(self, template, data, where: str, *, resized: bool):
        files = set(data.files if hasattr(data, "files") else data)
        shard_keys = {k.split(_SHARD_SEP, 1)[0] for k in files
                      if _SHARD_SEP in k}
        if _LEAVES_KEY in files:
            meta = json.loads(str(np.asarray(data[_LEAVES_KEY])))
        else:
            # the JAX package's snapshot: arrays only, keyed by tree path
            meta = {k.split(_SHARD_SEP, 1)[0]: ["array", "numpy"]
                    for k in files}
        for k in shard_keys:
            meta.setdefault(k, ["array", "sharded"])

        def global_of(key, t):
            dtype = (np.asarray(t).dtype if not isinstance(t, torch.Tensor)
                     else _to_array(torch.empty(0, dtype=t.dtype)).dtype)
            return self._global_from_shards(key, data, tuple(np.shape(t)),
                                            dtype)

        def array_of(key, t):
            if _is_dtensor(t):
                index = _dtensor_index(t)
                skey = f"{key}{_SHARD_SEP}{_index_str(index, t.shape)}"
                if skey in files:
                    return np.asarray(data[skey])
                if key in files:
                    return np.asarray(data[key])[index]
                if not resized:
                    raise ValueError(
                        f"checkpoint misses shard {skey!r} required by the "
                        "template's placement; was it saved under another "
                        "mesh layout? (allow_world_resize=True reassembles "
                        "it from every rank's files)")
                return global_of(key, t)[index]
            if key in files:
                return np.asarray(data[key])
            if not resized:
                raise ValueError(
                    f"checkpoint leaf {key!r} was saved sharded; restore "
                    "it into a DTensor template, or with "
                    "allow_world_resize=True")
            return global_of(key, t)

        return _restore(template, meta, array_of, where)

    def cleanup(self) -> None:
        """Remove this rank's snapshots (after draining the writer, so an
        in-flight save cannot land after the deletes)."""
        if self._writer is not None:
            try:
                self._writer.wait()
            except RuntimeError:
                pass  # everything goes anyway
        for it in self._local_iterations():
            try:
                os.remove(self._fname(it))
            except FileNotFoundError:
                pass


def create_multi_node_checkpointer(name: str, comm: CommunicatorBase, *,
                                   path: str = "checkpoints",
                                   keep: int = 2) -> MultiNodeCheckpointer:
    """Factory mirroring the reference signature."""
    return MultiNodeCheckpointer(name, comm, path=path, keep=keep)


__all__ = ["MultiNodeCheckpointer", "agree_max_common_step",
           "create_multi_node_checkpointer"]
