"""The port's composition executor over process groups, the composed
schedules of the optimizer and of the plan's ``grad_reduction=``, and
``MeasuredComposedReducer``, against the JAX package's on the CPU.

One launch of 8 gloo ranks on the 2 x 2 x 2 layout and one of 4 on the
2 x 2 (``tests/torch_composition_workers.py``, shared by this file and
``tests/test_torch_async_host.py``):

- ``reduce_composed`` of every derived composition of the 3-axis mesh,
  sliced and zigzag spellings, a leaf that degrades below its slice
  count, an expanded spelling, merged stages written out of mesh order,
  and three broadcast trees: BITWISE equal on every rank to the JAX
  ``reduce_composed`` inside ``shard_map`` on the 8-device CPU mesh, on
  exact-dyadic inputs (small integers over 8: every partial sum exact);
  the ``torch.distributed`` calls each makes EQUAL to
  ``predicted_collectives`` (a broadcast stage's root; the others by the
  sub-sends they take part in). The JAX HLO counts are not compared: jax 0.9's
  CPU compiler merges the sliced all-reduces.
- the shard each rank holds after a merged scatter, in mesh order and
  written out of it (``rs(a2+a1)``, ``rs(a2+a0+a1)``): BITWISE the
  shard JAX's ``psum_scatter`` over the written order leaves on its
  device (the chunk a sharded update owns); ``run_gather_suffix`` after
  ``run_reduce_prefix`` around an identity update gives the mean back.
- ``MultiNodeOptimizer`` (Adam 1e-2, 3 steps) under every derived
  composition, a sliced and a zigzag one and ``'zero'``
  (``zero_composition``'s groups over 3 axes: rs(a2), ar(a0+a1),
  ag(a2)):
  within rtol 1e-5 / atol 1e-6 of the JAX single-device trajectory, as
  the JAX ``TestTrainerEquivalence`` holds its distributed runs; calls a
  step equal to the prediction for the one bucket.
- the int8 wire's sliced renderings (contiguous and zigzag, flat and
  two-level): within 4 codes of the largest |x| of the exact mean and
  of the JAX renderings (per-slice scales), S all-to-alls a slice count.
- the plan's ``grad_reduction=``: ``'flat'`` and ``'ar(data)'`` give the
  plan without it bit for bit with the same calls; ``'rs(a0)>ag(a0)'``
  on dyadic inputs gives it bit for bit, one all-reduce fewer and its
  reduce-scatter and all-gather more; a ladder on a data x zero plan
  changes nothing but ``describe()``, whose signatures are JAX's.
- the refusals (a sharded update, an unreduced axis, foreign axes,
  error feedback, the int8 wire beyond its renderings, ``'zero'`` in
  ``reduce_tree``, an unknown name), as the JAX package's.
- ``MeasuredComposedReducer`` on the 2 x 2 layout: means bitwise the
  flat schedule's (dyadic), one stage row a stage with the bytes of
  ``stage_wire_layout``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu.parallel import composition as J
from chainermn_tpu.parallel import reduction_schedule as JRS
from chainermn_tpu.parallel.plan import ParallelPlan as JaxPlan
from chainermn_tpu_torch.parallel import composition as K
from torch_composition_workers import (
    AXES3,
    BROADCAST_CASES,
    LEAVES,
    CALLS,
    MEASURED_CASES,
    OPT_LR,
    OPT_STEPS,
    SHARD_CASES,
    SPLIT_CASES,
    inputs4,
    inputs8,
    int8_cases,
    launch4,
    launch8,
    optimizer_cases,
    reduction_cases,
)
from torch_rank_workers import few_threads  # noqa: F401

SIZES3 = {a: 2 for a in AXES3}


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    inputs = inputs8()
    return inputs, launch8(inputs, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    inputs = inputs4()
    return inputs, launch4(inputs, tmp_path_factory)


def _mesh3():
    return Mesh(np.array(jax.devices("cpu")[:8]).reshape(2, 2, 2), AXES3)


@functools.lru_cache(maxsize=None)
def _jax_reduce_composed_all():
    """``{signature: {leaf: [8, ...]}}``: JAX's ``reduce_composed`` of
    every case on the 8-device mesh, in one compiled program (the
    reductions mean, the broadcasts sum)."""
    inputs = inputs8()
    sigs = reduction_cases() + list(BROADCAST_CASES)
    comps = {s: J.compile_schedule(s, AXES3) for s in sigs}
    tree = {n: jnp.asarray(inputs[f"x/{n}"]) for n, _ in LEAVES}

    def local(t):
        return {s: {k: J.reduce_composed(
            v[0].reshape(-1), comps[s],
            op="sum" if s.startswith("bc") else "mean")
            .reshape(v.shape[1:])[None] for k, v in t.items()}
            for s in sigs}

    spec = {n: P(AXES3) for n in tree}
    f = jax.jit(shard_map(local, mesh=_mesh3(), in_specs=(spec,),
                          out_specs={s: spec for s in sigs},
                          check_vma=False))
    return jax.device_get(f(tree))


def _jax_reduce_composed(inputs, sig, op):
    del op  # the case's own: every reduction means, every tree sums
    assert inputs is not None
    return _jax_reduce_composed_all()[sig]


def _calls(pred) -> list:
    return [pred.get(k, 0) for k in CALLS]


def _member_sends(n: int, radix: int, index: int) -> int:
    """The sub-sends of ``tree_sends(n, radix)`` in which member ``index``
    of the merged group (the root is 0) sends or receives: the
    ``batch_isend_irecv`` calls a broadcast stage makes on it."""
    calls, holders = 0, 1
    while holders < n:
        for j in range(1, radix):
            if any(index in (s, s + j * holders) for s in range(holders)
                   if s + j * holders < n):
                calls += 1
        holders *= radix
    return calls


def _member_calls(comp, size, rank) -> list:
    """The calls ``rank`` makes: the reductions' counts, a broadcast
    stage's sub-sends this member of its merged group takes part in."""
    pred = K.predicted_collectives(comp, size, SIZES3)
    if "batch_isend_irecv" in pred:
        coords = dict(zip(AXES3, np.unravel_index(rank, (2, 2, 2))))
        calls = 0
        for st in comp.stages:
            idx = int(np.ravel_multi_index(
                [coords[a] for a in st.axes], [2] * len(st.axes)))
            calls += _member_sends(2 ** len(st.axes), st.radix or 2, idx)
        pred["batch_isend_irecv"] = calls * K.effective_slices(
            comp.slices, size)
    return _calls(pred)


def test_communicator_names_its_axes_and_topology(ranks8):
    _, outs = ranks8
    for r, o in enumerate(outs):
        assert list(o["axis_names"]) == list(AXES3)
        # inter: every axis but the last, merged; intra: the last
        assert list(o["topo"]) == [r // 2, 4, r % 2, 2]


@pytest.mark.parametrize("sig", reduction_cases())
def test_reduce_composed_bitwise_jax_and_calls_predicted(ranks8, sig):
    inputs, outs = ranks8
    want = _jax_reduce_composed(inputs, sig, "mean")
    comp = K.compile_schedule(sig, AXES3)
    for r, o in enumerate(outs):
        for name, shape in LEAVES:
            np.testing.assert_array_equal(o[f"rc/{sig}/{name}"],
                                          want[name][r], err_msg=sig)
            size = int(np.prod(shape))
            assert list(o[f"calls/{sig}/{name}"]) == _calls(
                K.predicted_collectives(comp, size)), (sig, name)
    # every composition is the mean: bitwise the flat one (dyadic)
    for name, _ in LEAVES:
        exact = inputs[f"x/{name}"].mean(0)
        np.testing.assert_array_equal(outs[0][f"rc/{sig}/{name}"], exact)


@functools.lru_cache(maxsize=None)
def _jax_shards_all():
    """``{axes: {leaf: [8, c]}}``: the summed shard each device holds
    after JAX's ``run_reduce_prefix`` of one ``reduce_scatter`` stage
    over ``axes`` (a ``psum_scatter`` over them in the written order) on
    the 8-device mesh, in one compiled program."""
    inputs = inputs8()
    tree = {n: jnp.asarray(inputs[f"x/{n}"]) for n, _ in LEAVES}

    def local(t):
        return {axes: {k: J.run_reduce_prefix(
            v[0].reshape(-1), [J.Stage("reduce_scatter", axes)],
            total=1)[None] for k, v in t.items()} for axes in SHARD_CASES}

    spec = {n: P(AXES3) for n in tree}
    f = jax.jit(shard_map(local, mesh=_mesh3(), in_specs=(spec,),
                          out_specs={a: spec for a in SHARD_CASES},
                          check_vma=False))
    return jax.device_get(f(tree))


@pytest.mark.parametrize("axes", SHARD_CASES, ids="+".join)
def test_merged_scatter_leaves_each_rank_the_jax_shard(ranks8, axes):
    """A merged scatter written out of mesh order (``rs(a2+a1)``) runs
    on the product group, whose members torch numbers in mesh order:
    each rank must still hold the shard ``psum_scatter`` over the
    written order gives its device, the chunk a sharded update owns."""
    _, outs = ranks8
    shards = _jax_shards_all()
    want = shards[axes]
    key = "+".join(axes)
    for r, o in enumerate(outs):
        for name, _ in LEAVES:
            np.testing.assert_array_equal(o[f"shard/{key}/{name}"],
                                          want[name][r], err_msg=key)
    ordered = tuple(sorted(axes, key=AXES3.index))
    if ordered != axes:  # the written order moves some rank's shard
        assert any(not np.array_equal(want[n][r], shards[ordered][n][r])
                   for r in range(8) for n, _ in LEAVES), key


@pytest.mark.parametrize("sig", SPLIT_CASES)
def test_gather_suffix_puts_back_what_the_reduce_prefix_cut(ranks8, sig):
    """``run_reduce_prefix`` then ``run_gather_suffix`` around an
    identity update is the mean on every rank, bitwise (dyadic inputs),
    with the merged stages in mesh order and written out of it."""
    inputs, outs = ranks8
    for o in outs:
        for name, _ in LEAVES:
            np.testing.assert_array_equal(o[f"split/{sig}/{name}"],
                                          inputs[f"x/{name}"].mean(0),
                                          err_msg=sig)


@pytest.mark.parametrize("sig", BROADCAST_CASES)
def test_broadcast_trees_bitwise_jax_and_calls_by_member(ranks8, sig):
    inputs, outs = ranks8
    want = _jax_reduce_composed(inputs, sig, "sum")
    comp = K.compile_schedule(sig, AXES3)
    for r, o in enumerate(outs):
        for name, shape in LEAVES:
            got = o[f"rc/{sig}/{name}"]
            np.testing.assert_array_equal(got, want[name][r], err_msg=sig)
            np.testing.assert_array_equal(got, inputs[f"x/{name}"][0])
            size = int(np.prod(shape))
            assert list(o[f"calls/{sig}/{name}"]) == _member_calls(
                comp, size, r), (sig, name, r)
    # the root makes every sub-send: the prediction itself
    size = int(np.prod(LEAVES[0][1]))
    assert list(outs[0][f"calls/{sig}/{LEAVES[0][0]}"]) == _calls(
        K.predicted_collectives(comp, size, SIZES3))


def test_menu_names_and_their_signatures_are_one_reduction(ranks8):
    inputs, outs = ranks8
    for o in outs:
        for name in ("flat", "two_level"):
            sig = K.signature_for(name, 3)
            assert list(o[f"rtcalls/{name}"]) == list(o[f"rtcalls/{sig}"])
            for leaf, _ in LEAVES:
                np.testing.assert_array_equal(o[f"rt/{name}/{leaf}"],
                                              o[f"rt/{sig}/{leaf}"])
                np.testing.assert_array_equal(
                    o[f"rt/{name}/{leaf}"], inputs[f"x/{leaf}"].mean(0))


def _jax_single_adam(inputs):
    """The JAX single-device trajectory the distributed runs equal."""
    params = {"w": jnp.asarray(inputs["opt/w"]),
              "b": jnp.asarray(inputs["opt/b"])}
    x, y = jnp.asarray(inputs["opt/x"]), jnp.asarray(inputs["opt/y"])

    def loss(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            x @ p["w"] + p["b"], y).mean()

    opt = optax.adam(OPT_LR)
    state = opt.init(params)
    losses = []
    for _ in range(OPT_STEPS):
        val, g = jax.value_and_grad(loss)(params)
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        losses.append(float(val))
    return jax.device_get(params), losses


@pytest.mark.parametrize("sched", optimizer_cases())
def test_optimizer_schedule_follows_jax_over_three_steps(ranks8, sched):
    inputs, outs = ranks8
    want, losses = _jax_single_adam(inputs)
    for o in outs:
        for k in ("w", "b"):
            np.testing.assert_allclose(o[f"opt/{sched}/{k}"], want[k],
                                       rtol=1e-5, atol=1e-6, err_msg=sched)
    # the loss is each rank's own rows'; their mean is the global one
    for s in range(OPT_STEPS):
        mean = np.mean([float(o[f"opt/{sched}/loss{s}"]) for o in outs])
        assert abs(mean - losses[s]) < 1e-6, (sched, s)
    comp = K.compile_schedule(sched, AXES3)
    if comp.has_update:  # 'zero': rs(a2), ar(a0+a1), ag(a2) once a step
        pred = {"reduce_scatter_tensor": 1, "all_reduce": 1,
                "all_gather_into_tensor": 1}
    else:
        pred = K.predicted_collectives(comp, 5 * 3 + 3)
    for o in outs:
        assert list(o[f"opt/{sched}/calls"]) == _calls(pred), sched


@functools.lru_cache(maxsize=None)
def _jax_int8_all():
    """``{signature: [8, n]}``: JAX's int8 ``reduce_tree`` of every int8
    case on the 8-device mesh, in one compiled program."""
    sigs = int8_cases()
    x = jnp.asarray(inputs8()["int8/x"])

    def local(v):
        return {s: JRS.reduce_tree([v[0]], schedule=s, axes=AXES3,
                                   compress_dtype=jnp.int8)[0][None]
                for s in sigs}

    spec = P(AXES3, None)
    f = jax.jit(shard_map(local, mesh=_mesh3(), in_specs=(spec,),
                          out_specs={s: spec for s in sigs},
                          check_vma=False))
    return jax.device_get(f(x))


def _jax_int8(inputs, sig):
    assert inputs is not None
    return _jax_int8_all()[sig]


@pytest.mark.parametrize("sig", int8_cases())
def test_int8_wire_renders_per_slice_as_jax(ranks8, sig):
    inputs, outs = ranks8
    x = inputs["int8/x"]
    exact = x.mean(0)
    tol = 4.0 * float(np.abs(x).max()) / 127.0
    want = _jax_int8(inputs, sig)
    comp = K.compile_schedule(sig, AXES3)
    base = "flat" if "ar(a0+a1+a2)" in sig or sig == "flat" else "two_level"
    for r, o in enumerate(outs):
        got = o[f"int8/{sig}"]
        np.testing.assert_allclose(got, exact, atol=tol, err_msg=sig)
        np.testing.assert_allclose(got, want[r], atol=tol, err_msg=sig)
        # one two-phase wire a slice: S times the unsliced all-to-alls
        a2a = CALLS.index("all_to_all_single")
        assert (o[f"int8calls/{sig}"][a2a]
                == comp.slices * o[f"int8calls/{base}"][a2a])
    # every rank holds the same mean (each slice's stage-2 shards)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"int8/{sig}"],
                                      outs[0][f"int8/{sig}"])


def test_composition_refusals_as_jax(ranks8):
    _, outs = ranks8
    for o in outs:
        for key in ("refuse/su", "refuse/unreduced", "refuse/foreign",
                    "refuse/ef", "refuse/int8_opt", "refuse/int8_ladder",
                    "refuse/int8_ladder_sliced", "refuse/zero_tree",
                    "refuse/ring"):
            assert bool(o[key]), key


def test_plan_flat_grad_reduction_is_the_plan_without_it(ranks8):
    _, outs = ranks8
    for o in outs:
        for tag in ("dp/flat", "dp/ar"):
            np.testing.assert_array_equal(o[f"plan/{tag}/w"],
                                          o["plan/dp/base/w"])
            assert float(o[f"plan/{tag}/loss"]) == float(
                o["plan/dp/base/loss"])
            assert list(o[f"plan/{tag}/calls"]) == list(
                o["plan/dp/base/calls"])
        # the JAX plan reports the signature the composition runs
        assert eval(str(o["plan/dp/flat/describe"]))[0] == JaxPlan(
            {"data": 8}, devices=jax.devices("cpu")[:8],
            grad_reduction="flat").describe()["grad_reduction"]


def test_plan_decomposed_grad_reduction_moves_only_its_calls(ranks8):
    _, outs = ranks8
    pred = K.predicted_collectives(K.compile_schedule("rs(a0)>ag(a0)",
                                                      ("data",)))
    for o in outs:
        np.testing.assert_array_equal(o["plan/dp/rsag/w"],
                                      o["plan/dp/rsag_base/w"])
        base = dict(zip(CALLS, o["plan/dp/rsag_base/calls"]))
        got = dict(zip(CALLS, o["plan/dp/rsag/calls"]))
        assert got["all_reduce"] == base["all_reduce"] - 1
        for call in ("reduce_scatter_tensor", "all_gather"):
            assert got[call] == base[call] + pred[call]
        gr, coll = eval(str(o["plan/dp/rsag/describe"]))
        assert gr == "rs(data)>ag(data)"
        assert coll["data"] == ("reduce_scatter_tensor", "all_gather")


def test_plan_ladder_on_a_zero_plan_changes_only_describe(ranks8):
    _, outs = ranks8
    for sig, tag in (("rs(a1)>rs(a0)>ag(a0)>ag(a1)", "dpz/ladder"),
                     ("rs(a1)[s0..1]>rs(a0)>ag(a0)>ag(a1)", "dpz/sliced")):
        jd = JaxPlan({"data": 2, "zero": 4}, devices=jax.devices("cpu")[:8],
                     grad_reduction=sig).describe()
        for o in outs:
            np.testing.assert_array_equal(o[f"plan/{tag}/w"],
                                          o["plan/dpz/base/w"])
            assert list(o[f"plan/{tag}/calls"]) == list(
                o["plan/dpz/base/calls"])
            gr, coll = eval(str(o[f"plan/{tag}/describe"]))
            assert gr == jd["grad_reduction"]
            # the data axis's calls are the composition's, the zero
            # axis keeps its own provider entry (JAX's vocabulary)
            assert coll["data"] == tuple(
                K.STAGE_CALLS[{"reduce-scatter": "reduce_scatter",
                               "all-gather": "allgather"}[c]]
                for c in jd["collectives"]["data"])
            assert coll["zero"] == jd["collectives"]["zero"]


def test_plan_grad_reduction_refusals_as_jax(ranks8):
    _, outs = ranks8
    for o in outs:
        for key in ("zero", "no_dp", "unreduced", "zsg"):
            assert bool(o[f"plan/refuse/{key}"]), key


@pytest.mark.parametrize("sig", MEASURED_CASES)
def test_measured_reducer_times_each_stage(ranks4, sig):
    inputs, outs = ranks4
    names = ("inter", "intra")
    comp = K.compile_schedule(sig, names)
    n_elems = sum(int(np.prod(s)) for _, s in LEAVES)
    layout = K.stage_wire_layout(comp, {"inter": 2, "intra": 2}, 4,
                                 n_elems)
    for o in outs:
        for leaf, _ in LEAVES:
            np.testing.assert_array_equal(o[f"measured/{sig}/{leaf}"],
                                          o[f"flat/{leaf}"])
            np.testing.assert_array_equal(o[f"measured/{sig}/{leaf}"],
                                          inputs[f"x/{leaf}"].mean(0))
        assert list(o[f"measured/{sig}/stages"]) == [
            f"{r['stage']}|{r['op']}|{r['nbytes']}|{r.get('slice', -1)}"
            for r in layout]
        assert bool(o[f"measured/{sig}/dur_ok"])
        assert list(o[f"measured/{sig}/calls"]) == _calls(
            K.predicted_collectives(comp, n_elems))
        assert bool(o["measured/refuse_su"])


def test_calibrate_fits_every_derived_pipeline_over_gloo(ranks4):
    """``calibrate`` at 4 gloo ranks: the derived pipelines of the 2 x 2
    layout timed (the median of 3 a rank, the slowest rank's), fitted
    into one model on every rank. Gloo figures: no speed is asserted."""
    _, outs = ranks4
    want = [c.signature() for c in K.derive_compositions(("a0", "a1"))]
    for o in outs:
        assert tuple(o["cal/shape"]) == (2, 2)
        assert sorted(o["cal/rows"]) == sorted(want)
        assert str(o["cal/source"]) == "fit:calibration"
        assert np.all(o["cal/coeffs"] >= 0)
        np.testing.assert_array_equal(o["cal/coeffs"],
                                      outs[0]["cal/coeffs"])
        assert bool(o["cal/repeats_refused"])


def test_mnist_twin_takes_signatures(capsys):
    """The MNIST twin's ``--reduction-schedule`` takes signatures over
    its communicator's axes (``'data'`` here, one rank): a zigzag sliced
    one trains as ``flat`` does, bit for bit at one rank; a sharded
    update in a signature and a foreign axis exit naming the fault."""
    from chainermn_tpu_torch.examples.mnist import train_mnist
    from torch_rank_workers import kept_excepthook

    base = ["--device", "cpu", "--iterations", "12", "--batchsize", "32"]
    with kept_excepthook():
        flat = train_mnist.main(base + ["--reduction-schedule", "flat"])
        sliced = train_mnist.main(
            base + ["--reduction-schedule", "rs(data)[z0..3]>ag(data)"])
        assert sliced == flat and sliced["val_acc"] > 0.9
        for sig, what in (("rs(data)>su>ag(data)", "sharded_update"),
                          ("ar(inter+intra)", "neither on the mesh"),
                          ("rs(data)>frob", "unparseable")):
            with pytest.raises(SystemExit):
                train_mnist.main(base + ["--reduction-schedule", sig])
            assert what in capsys.readouterr().err, sig
