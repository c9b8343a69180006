"""The port's composition DSL (``chainermn_tpu_torch.parallel.
composition``) against the JAX package's, with no ranks: the same
spellings and mesh axes through both, and the results compared exactly.

- the validator's rejection suite (``tests/test_composition.py``'s
  TestValidator, the sliced, broadcast and zigzag rejections): the same
  :class:`CompositionError` message on both sides;
- ``derive_compositions`` for 1, 2 and 3 axes, ``schedule_candidates``,
  ``normalize_schedule_name``, ``signature_for``: the same signatures in
  the same order;
- parsing, binding, slicing (``effective_slices``, ``slice_bounds``,
  ``expand_slices``, ``compact_slices``), ``tree_depth``/``tree_sends``
  and ``stage_wire_layout``: equal, the wire table's ``op`` being the
  ``torch.distributed`` call each JAX HLO op becomes
  (:data:`STAGE_CALLS`);
- ``predicted_collectives`` in the port's call vocabulary: the JAX
  counts under the same mapping.
"""

import pytest

from chainermn_tpu.parallel import composition as J
from chainermn_tpu_torch.parallel import composition as K

AXES3 = ("a0", "a1", "a2")
#: the JAX HLO op of each stage as the port's ``torch.distributed`` call
HLO_TO_CALL = {J.STAGE_HLO[p]: K.STAGE_CALLS[p] for p in J.STAGE_HLO}


def _both(fn_name, *args, **kwargs):
    """``(jax result or error text, port result or error text)``."""
    out = []
    for mod in (J, K):
        try:
            out.append(("ok", getattr(mod, fn_name)(*args, **kwargs)))
        except (J.CompositionError, K.CompositionError, ValueError) as e:
            out.append(("raised", str(e)))
    return out


def _sig(c):
    return c.signature() if hasattr(c, "signature") else c


# -- the validator ----------------------------------------------------------

REJECTED = [
    # (signature, mesh axes, what the message names)
    ("ar(a0+a1+a2)>ar(a0)", AXES3, "reduced more than once"),
    ("rs(a2)>ag(a2)", AXES3, "never reduced"),
    ("rs(a2)>ar(a0+a1)>ag(a1)", AXES3, "does not conjugate"),
    ("rs(a2)>rs(a1)>ar(a0)>ag(a2)>ag(a1)", AXES3, "does not conjugate"),
    ("ar(a0+a1+a2)>ag(a2)", AXES3, "no open reduce_scatter"),
    ("rs(a2)>ar(a0+a1)", AXES3, "never gathered back"),
    ("rs(a2)>su>ar(a0+a1)>ag(a2)", AXES3, "before every axis is reduced"),
    ("ar(a0+a1+a2)>su", AXES3, "no open reduce_scatter"),
    ("rs(a0+a1+a2)>su>su>ag(a0+a1+a2)", AXES3, "more than one"),
    ("ar(bogus)", AXES3, "not on the mesh"),
    ("rs(a0+a1+a2)>ar(a0)>ag(a0+a1+a2)", AXES3, "reduced more than once"),
    # sliced
    ("rs(a2)[s0:2]>rs(a2)[s1:2]>ar(a0+a1)[s0:2]>ag(a2)[s0:2]", AXES3,
     "slice s1:2"),
    ("ar(a0+a1+a2)[s0:2]>ar(a0+a1+a2)", AXES3, "no slice address"),
    ("ar(a0+a1+a2)[s0:2]>ar(a0+a1+a2)[s1:3]", AXES3, "slice totals"),
    ("ar(a0+a1+a2)[s0:3]>ar(a0+a1+a2)[s2:3]", AXES3, "have no stages"),
    ("rs(a0+a1+a2)[s0..1]>su>ag(a0+a1+a2)", AXES3, "unsliceable"),
    # broadcast
    ("bc(a0)>ar(a1+a2)", AXES3, "never compose"),
    ("bc(a0+a1)", AXES3, "never broadcast"),
    ("bc(a0+a1+a2)>bc(a0)", AXES3, "more than once"),
    ("ar(a0)>bc(a1+a2)", AXES3, "never compose"),
    # one axis
    ("rs(data)>ag(data)>ar(data)", ("data",), "reduced more than once"),
    ("ag(data)", ("data",), "no open reduce_scatter"),
]


@pytest.mark.parametrize("sig,axes,what", REJECTED,
                         ids=[r[0] for r in REJECTED])
def test_validator_rejects_as_jax(sig, axes, what):
    msgs = []
    for mod in (J, K):
        with pytest.raises(mod.CompositionError) as e:
            mod.validate_composition(mod.parse_signature(sig), axes)
        msgs.append(str(e.value))
    assert what in msgs[1]
    assert msgs[1] == msgs[0]


STAGE_REJECTED = [
    (("alltoall", ("a0",)), "unknown primitive"),
    (("allreduce", ()), "empty axis group"),
    (("allreduce", ("a0", "a0", "a1", "a2")), "duplicate axis"),
]


@pytest.mark.parametrize("stage,what", STAGE_REJECTED,
                         ids=[w for _, w in STAGE_REJECTED])
def test_validator_rejects_stage_objects_as_jax(stage, what):
    msgs = []
    for mod in (J, K):
        with pytest.raises(mod.CompositionError) as e:
            mod.validate_composition(
                mod.Composition((mod.Stage(*stage),)), AXES3)
        msgs.append(str(e.value))
    assert what in msgs[1] and msgs[0] == msgs[1]


def test_validator_rejects_radix_slices_and_layout_as_jax():
    for build in (
            lambda m: m.Composition((
                m.Stage("reduce_scatter", ("a2",), radix=4),
                m.Stage("allreduce", ("a0", "a1")),
                m.Stage("allgather", ("a2",)))),
            lambda m: m.Composition(m.flat_composition(AXES3).stages,
                                    slices=0),
            lambda m: m.Composition(m.two_level_composition(AXES3).stages,
                                    slices=2, slice_layout="diagonal"),
            lambda m: m.Composition(m.zero_composition(AXES3).stages,
                                    slices=2),
            lambda m: m.Composition(())):
        msgs = []
        for mod in (J, K):
            with pytest.raises(mod.CompositionError) as e:
                mod.validate_composition(build(mod), AXES3)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


PARSE_REJECTED = [
    "rs(a0)>frobnicate", "rs(a0+a1+a2)>su(a0)>ag(a0+a1+a2)",
    "rs(a2)@4>ar(a0+a1)>ag(a2)", "rs(a2)[z1:4]>ar(a0+a1)>ag(a2)",
    "rs(a2)[s1..3]>ar(a0+a1)>ag(a2)", "rs(a2)[s4:4]>ag(a2)",
    "rs(a2)[s0..3]>ar(a0+a1)[s0..1]>ag(a2)",
    "rs(a2)[s0..3]>ar(a0+a1)[z0..3]>ag(a2)"]


@pytest.mark.parametrize("sig", PARSE_REJECTED)
def test_parse_rejects_as_jax(sig):
    (js, jmsg), (ks, kmsg) = _both("parse_signature", sig)
    assert js == ks == "raised"
    assert kmsg == jmsg


def test_bind_and_compile_reject_as_jax():
    for fn, args in (
            ("bind_composition", (None, ("data", "model"))),
            ("compile_schedule", ("ring", AXES3)),
            ("compile_schedule", ("ar(x0+x1)", ("data", "model"))),
            ("sliced_composition", (None, 2)),
            ("sliced_composition", ("two", 4, "diagonal")),
            ("tree_depth", (8, 1)), ("tree_sends", (8, 1)),
            ("effective_slices", (0, 10))):
        msgs = []
        for mod in (J, K):
            a = list(args)
            if fn == "bind_composition":
                a[0] = mod.parse_signature("ar(x0+x1)")
            if fn == "sliced_composition":
                a[0] = (mod.two_level_composition(AXES3) if a[0] == "two"
                        else mod.zero_composition(AXES3))
            with pytest.raises((mod.CompositionError, ValueError)) as e:
                getattr(mod, fn)(*a)
            msgs.append(str(e.value).replace("chainermn_tpu_torch",
                                             "chainermn_tpu"))
        if fn == "compile_schedule" and args[0] == "ring":
            assert "unknown schedule" in msgs[1]  # the menus are equal
        assert msgs[0] == msgs[1], fn


# -- the deriver and the menu -------------------------------------------------

@pytest.mark.parametrize("names", [("a0",), ("data",), ("a0", "a1"),
                                   ("inter", "intra"), AXES3,
                                   ("dcn", "ici_y", "ici_x"),
                                   ("a0", "a1", "a2", "a3")])
def test_derive_compositions_as_jax(names):
    got = [c.signature() for c in K.derive_compositions(names)]
    want = [c.signature() for c in J.derive_compositions(names)]
    assert got == want
    assert len(got) == 2 ** len(names)
    for sig in got:  # every derived composition parses back and validates
        assert K.parse_signature(sig).signature() == sig
        K.validate_composition(K.parse_signature(sig), names)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_schedule_candidates_and_menu_names_as_jax(k):
    assert K.schedule_candidates(k) == J.schedule_candidates(k)
    for sched in ("flat", "two_level", "zero"):
        assert K.signature_for(sched, k) == J.signature_for(sched, k)
    for sig in K.schedule_candidates(k)[3:] + tuple(
            K.signature_for(s, k) for s in ("flat", "two_level", "zero")):
        assert (K.normalize_schedule_name(sig, k)
                == J.normalize_schedule_name(sig, k))
    names = K.canonical_axis_names(k)
    for fn in ("flat_composition", "two_level_composition",
               "zero_composition", "broadcast_composition"):
        assert (getattr(K, fn)(names).signature()
                == getattr(J, fn)(names).signature())


# -- parsing, binding, slicing ------------------------------------------------

SIGNATURES = [
    "rs(a2)>ar(a0+a1)>ag(a2)", "rs(a2)[s0..3]>ar(a0+a1)>ag(a2)",
    "rs(a2)[z0..3]>ar(a0+a1)>ag(a2)", "bc(a0+a1)@4>bc(a2)",
    "bc(a0+a1+a2)@2", "rs(a0+a1+a2)>su>ag(a0+a1+a2)",
    "rs(a2)[s0:2]>ar(a0+a1)[s0:2]>rs(a2)[s1:2]>ag(a2)[s0:2]"
    ">ar(a0+a1)[s1:2]>ag(a2)[s1:2]",
    "rs(a2+a1)>ar(a0)>ag(a2+a1)", "ar(a0+a1+a2)[s0..0]",
]


@pytest.mark.parametrize("sig", SIGNATURES)
def test_parse_bind_compile_roundtrip_as_jax(sig):
    kc, jc = K.parse_signature(sig), J.parse_signature(sig)
    assert kc.signature() == jc.signature()
    assert (kc.slices, kc.slice_layout) == (jc.slices, jc.slice_layout)
    assert [(s.primitive, s.axes, s.slice, s.radix) for s in kc.stages] == [
        (s.primitive, s.axes, s.slice, s.radix) for s in jc.stages]
    for axes in (AXES3, ("dcn", "ici_y", "ici_x")):
        (js, jv), (ks, kv) = _both("compile_schedule", sig, axes)
        assert js == ks
        assert _sig(kv) == _sig(jv)


@pytest.mark.parametrize("n,s", [(10, 4), (8, 8), (7, 3), (1, 1), (3, 8),
                                 (0, 4), (103, 4), (64, 16)])
def test_slice_bounds_and_effective_slices_as_jax(n, s):
    assert K.effective_slices(s, n) == J.effective_slices(s, n)
    e = K.effective_slices(s, n)
    assert K.slice_bounds(n, e) == J.slice_bounds(n, e)


@pytest.mark.parametrize("sig", [
    "rs(a2)[s0..3]>ar(a0+a1)>ag(a2)", "rs(a2)[z0..2]>ar(a0+a1)>ag(a2)",
    "rs(a2)>rs(a1)>ar(a0)>ag(a1)>ag(a2)",
    "rs(a1+a2)[s0..7]>ar(a0)>ag(a1+a2)"])
@pytest.mark.parametrize("size", [None, 3, 64])
def test_expand_and_compact_slices_as_jax(sig, size):
    kc, jc = K.parse_signature(sig), J.parse_signature(sig)
    ke, je = K.expand_slices(kc, size), J.expand_slices(jc, size)
    assert [s.signature() for s in ke] == [s.signature() for s in je]
    if kc.slices > 1 and (size is None or size > 1):
        kx = K.Composition(ke)
        jx = J.Composition(je)
        assert K.compact_slices(kx).signature() == J.compact_slices(
            jx).signature()
        K.validate_composition(kx, AXES3)


def test_compact_slices_refuses_a_heterogeneous_expansion_as_jax():
    sig = ("rs(a2)[s0:2]>ar(a0+a1)[s0:2]>ag(a2)[s0:2]"
           ">ar(a0+a1+a2)[s1:2]")
    msgs = []
    for mod in (J, K):
        mod.validate_composition(mod.parse_signature(sig), AXES3)
        with pytest.raises(mod.CompositionError) as e:
            mod.compact_slices(mod.parse_signature(sig))
        msgs.append(str(e.value))
    assert "different pipeline" in msgs[1] and msgs[0] == msgs[1]


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 64])
@pytest.mark.parametrize("radix", [2, 3, 4])
def test_tree_depth_and_sends_as_jax(n, radix):
    assert K.tree_depth(n, radix) == J.tree_depth(n, radix)
    assert K.tree_sends(n, radix) == J.tree_sends(n, radix)


# -- the wire layout and the predicted calls ---------------------------------

LAYOUTS = [
    ("rs(a2)>rs(a1)>ar(a0)>ag(a1)>ag(a2)", 100, 4),
    ("rs(a2)>rs(a1)>ar(a0)>ag(a1)>ag(a2)", 128, 2),
    ("rs(a2)[s0..3]>ar(a0+a1)>ag(a2)", 103, 4),
    ("rs(a2)[z0..3]>ar(a0+a1)>ag(a2)", 103, 4),
    ("rs(a2)[s0..7]>ar(a0+a1)>ag(a2)", 3, 4),
    ("bc(a0+a1)@4>bc(a2)", 64, 4),
    ("rs(a0+a1+a2)>su>ag(a0+a1+a2)", 50, 1),
    ("ar(a0+a1+a2)", 9, 4),
]


@pytest.mark.parametrize("sig,size,itemsize", LAYOUTS)
def test_stage_wire_layout_as_jax(sig, size, itemsize):
    sizes = {"a0": 2, "a1": 2, "a2": 2}
    got = K.stage_wire_layout(K.parse_signature(sig), sizes, itemsize, size)
    want = J.stage_wire_layout(J.parse_signature(sig), sizes, itemsize,
                               size)
    for row in want:
        row["op"] = HLO_TO_CALL[row["op"]]
    assert got == want


@pytest.mark.parametrize("sig", [
    "ar(a0+a1+a2)", "rs(a2)>rs(a1)>ar(a0)>ag(a1)>ag(a2)",
    "rs(a2)[s0..3]>ar(a0+a1)>ag(a2)", "rs(a2)[z0..7]>ar(a0+a1)>ag(a2)",
    "bc(a0+a1+a2)", "bc(a0+a1+a2)@4", "bc(a0+a1)@4>bc(a2)",
    "rs(a0+a1+a2)>su>ag(a0+a1+a2)"])
@pytest.mark.parametrize("size", [None, 3, 64])
def test_predicted_collectives_as_jax(sig, size):
    sizes = {"a0": 2, "a1": 2, "a2": 2}
    got = K.predicted_collectives(K.parse_signature(sig), size, sizes)
    want = J.predicted_collectives(J.parse_signature(sig), size, sizes)
    assert got == {HLO_TO_CALL[k]: v for k, v in want.items()}
    if sig.startswith("bc"):  # a broadcast needs its group's size
        msgs = []
        for mod in (J, K):
            with pytest.raises(mod.CompositionError) as e:
                mod.predicted_collectives(mod.parse_signature(sig))
            msgs.append(str(e.value))
        assert "axis_sizes" in msgs[1]
