"""The port's α–β cost model (``chainermn_tpu_torch.parallel.cost_model``)
against the JAX package's, with no ranks: the same compositions, world
shapes, payloads and rows through both.

- ``stage_terms``, ``CostModel.predict``, ``fit_pipeline_rows`` (its
  coefficients, its ``fit_err_pct`` and its rows), ``rank_compositions``
  (order, predicted ms, the top-k split, the loud uncalibrated degrade)
  and ``model_error_pct``: equal to JAX's within a relative 1e-9;
- ``load_from_bench_details`` on files the tests write (there is no
  default path: the repo's TPU rows fit nothing on the card), and its
  ``None`` degrades (missing file, no rows, another world shape, rows
  that do not overdetermine the fit);
- ``emit_sched_search_event`` returns the audit error as JAX's does with
  no recorder active;
- ``canonical_signature`` maps real axis names onto the tokens.

The live ``calibrate`` runs at 4 gloo ranks in
``tests/test_torch_composition_ranks.py``.
"""

import inspect
import json
import random

import pytest

from chainermn_tpu.parallel import composition as JK
from chainermn_tpu.parallel import cost_model as J
from chainermn_tpu_torch.parallel import composition as KK
from chainermn_tpu_torch.parallel import cost_model as K

SHAPES = [(8,), (2, 4), (2, 2, 2), (4, 2, 2)]
PAYLOADS = [1 << 20, 3 * (1 << 16) + 12, 64]
REL = 1e-9


def _grid(shape):
    return [c.signature() for c in JK.derive_compositions(
        JK.canonical_axis_names(len(shape)))]


def _extra(shape):
    """Sliced, zigzag, broadcast and sharded-update spellings."""
    names = JK.canonical_axis_names(len(shape))
    two = JK.two_level_composition(names)
    return [JK.sliced_composition(two, 4).signature(),
            JK.sliced_composition(two, 3, layout="zigzag").signature(),
            JK.broadcast_composition(names).signature(),
            JK.broadcast_composition(names, 4).signature(),
            JK.zero_composition(names).signature()]


def _models(shape):
    k = len(shape)
    rng = random.Random(len(shape))
    return [(tuple(rng.uniform(0.01, 1.0) for _ in range(k)),
             tuple(rng.uniform(1e-7, 2e-6) for _ in range(k)))
            for _ in range(2)]


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=1e-15)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("payload", PAYLOADS)
def test_stage_terms_and_predict_as_jax(shape, payload):
    names = JK.canonical_axis_names(len(shape))
    for sig in _grid(shape) + _extra(shape):
        n = max(1, payload // 4)
        got = K.stage_terms(KK.parse_signature(sig), n, shape)
        want = J.stage_terms(JK.parse_signature(sig), n, shape)
        assert len(got) == len(want), sig
        for g, w in zip(got, want):
            assert g[:3] == w[:3], sig
            _close(g[3], w[3])
        for alphas, betas in _models(shape):
            km = K.CostModel(shape, alphas, betas, "fit:test", 0.0)
            jm = J.CostModel(shape, alphas, betas, "fit:test", 0.0)
            _close(km.predict(sig, payload), jm.predict(sig, payload))
            _close(km.predict(sig, payload, names),
                   jm.predict(sig, payload, names))


def test_stage_terms_reject_a_mismatched_shape_as_jax():
    msgs = []
    for mod, kmod in ((J, JK), (K, KK)):
        with pytest.raises(kmod.CompositionError) as e:
            mod.stage_terms(kmod.parse_signature("ar(a0+a1)"), 8, (2, 2),
                            ("a0",))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("noise", [0.0, 0.15])
def test_fit_pipeline_rows_as_jax(shape, noise):
    (alphas, betas), _ = _models(shape)
    truth = J.CostModel(shape, alphas, betas, "fit:test", 0.0)
    rng = random.Random(7)
    rows = {s: truth.predict(s, 1 << 20) * rng.uniform(1 - noise, 1 + noise)
            for s in _grid(shape) + _extra(shape)[:2]}
    got = K.fit_pipeline_rows(rows, shape, 1 << 20, source="fit:x")
    want = J.fit_pipeline_rows(rows, shape, 1 << 20, source="fit:x")
    assert got.world_shape == want.world_shape
    assert got.source == want.source and got.fit_rows == want.fit_rows
    for g, w in zip(got.alphas + got.betas, want.alphas + want.betas):
        _close(g, w)
    assert got.fit_err_pct == pytest.approx(want.fit_err_pct, rel=REL,
                                            abs=1e-3)
    assert all(c >= 0.0 for c in got.alphas + got.betas)
    for s in rows:
        _close(got.predict(s, 1 << 20), want.predict(s, 1 << 20))


def test_fit_refuses_one_row_as_jax():
    msgs = []
    for mod, kmod in ((J, JK), (K, KK)):
        with pytest.raises(kmod.CompositionError) as e:
            mod.fit_pipeline_rows({"ar(a0+a1+a2)": 3.2}, (2, 2, 2), 1 << 20)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("k", [1, 3, 100])
def test_rank_compositions_as_jax(shape, k):
    (alphas, betas), _ = _models(shape)
    sigs = _grid(shape) + _extra(shape)[:2]
    random.Random(k).shuffle(sigs)
    km = K.CostModel(shape, alphas, betas, "fit:test", 0.0)
    jm = J.CostModel(shape, alphas, betas, "fit:test", 0.0)
    got = K.rank_compositions(km, sigs, 1 << 20, k=k)
    want = J.rank_compositions(jm, sigs, 1 << 20, k=k)
    assert (got.mode, got.provenance, got.order, got.measured,
            got.skipped) == (want.mode, want.provenance, want.order,
                             want.measured, want.skipped)
    assert set(got.predicted_ms) == set(want.predicted_ms)
    for s in got.predicted_ms:
        _close(got.predicted_ms[s], want.predicted_ms[s])
    for mode_kw, model in (({}, None), ({"mode": "exhaustive"}, "m")):
        g = K.rank_compositions(km if model else None, sigs, 1 << 20,
                                **mode_kw)
        w = J.rank_compositions(jm if model else None, sigs, 1 << 20,
                                **mode_kw)
        assert vars(g) == vars(w)
    assert K.rank_compositions(None, sigs, 1).provenance == K.UNCALIBRATED


@pytest.mark.parametrize("pred,meas", [
    ({"a": 1.0, "b": 2.0}, {"a": 1.1, "b": 2.0}),
    ({"a": 1.0}, {"b": 1.0}), ({}, {}),
    ({"a": 3.0, "b": 0.5, "c": 9.0}, {"a": 2.5, "b": 0.75, "c": 9.0})])
def test_model_error_and_the_search_audit_as_jax(pred, meas):
    got, want = K.model_error_pct(pred, meas), J.model_error_pct(pred, meas)
    assert got == want
    rank = K.RankResult("topk", "cost_model:fit:test", tuple(pred), pred,
                        tuple(pred), ())
    jrank = J.RankResult("topk", "cost_model:fit:test", tuple(pred), pred,
                         tuple(pred), ())
    assert (K.emit_sched_search_event(rank, meas, spread_pct=10.0)
            == J.emit_sched_search_event(jrank, meas, spread_pct=10.0))


def _details(path, rows, shape=(2, 2, 2), payload_mb=1):
    path.write_text(json.dumps({"composed_schedule_ms": rows,
                                "composed_world_shape": list(shape),
                                "composed_payload_mb": payload_mb}))
    return str(path)


def test_load_from_bench_details_reads_the_file_it_is_given(tmp_path):
    assert inspect.signature(K.load_from_bench_details).parameters[
        "path"].default is inspect.Parameter.empty
    truth = J.CostModel((2, 2, 2), (0.12, 0.25, 0.56),
                        (9e-7, 9.5e-7, 1.1e-6), "t", 0.0)
    rows = {s: truth.predict(s, 2 << 20) * (1.0 + 0.01 * i)
            for i, s in enumerate(_grid((2, 2, 2)))}
    path = _details(tmp_path / "rows.json", rows, payload_mb=2)
    got = K.load_from_bench_details(path)
    want = J.load_from_bench_details(path)
    assert got.source == want.source == "fit:bench_details"
    assert got.world_shape == (2, 2, 2)
    for g, w in zip(got.alphas + got.betas, want.alphas + want.betas):
        _close(g, w)
    tol = (got.fit_err_pct + 5e-4) / 100.0
    for s, ms in rows.items():
        assert abs(got.predict(s, 2 << 20) - ms) <= tol * ms
    assert K.load_from_bench_details(path, world_shape=(2, 2, 2)) == got
    assert K.load_from_bench_details(path, world_shape=(4, 2)) is None


def test_load_from_bench_details_degrades_to_none(tmp_path):
    assert K.load_from_bench_details(str(tmp_path / "nope.json")) is None
    (tmp_path / "bad.json").write_text("{not json")
    assert K.load_from_bench_details(str(tmp_path / "bad.json")) is None
    (tmp_path / "empty.json").write_text(json.dumps({"device_kind": "cpu"}))
    assert K.load_from_bench_details(str(tmp_path / "empty.json")) is None
    topk = _details(tmp_path / "topk.json", {
        "ar(a0+a1+a2)": 3.2, "rs(a0+a1+a2)>ag(a0+a1+a2)": 3.3,
        "rs(a1+a2)>ar(a0)>ag(a1+a2)": 3.6, "rs(a2)>ar(a0+a1)>ag(a2)": 3.9})
    assert K.load_from_bench_details(topk) is None
    assert J.load_from_bench_details(topk) is None


def test_canonical_signature_maps_real_axis_names():
    assert K.canonical_signature("flat", 3) == J.canonical_signature(
        "flat", 3)
    assert K.canonical_signature(
        "rs(intra)[s0..3]>ar(inter)>ag(intra)", 2,
        ("inter", "intra")) == "rs(a1)[s0..3]>ar(a0)>ag(a1)"
    assert K.canonical_signature("bc(inter+intra)@4", 2,
                                 ("inter", "intra")) == "bc(a0+a1)@4"
