"""Serving rollup over the scheduler's events (counterpart of
``chainermn_tpu/observability/trace.py::summarize_serving``).

The port's scheduler keeps its ``serving`` events in a local list and
rolls them up here; the definitions are the JAX package's, so the two
summaries agree key for key on the same events. The recorder, spans,
export and the metrics/flight/journey planes land with the
observability slice; so do the rollups of the events the port does not
emit yet (SLO verdicts, preemption, speculative, chunked and
prefix-cache events).
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Optional

from chainermn_tpu_torch.observability.stats import jain_index, nearest_rank

#: Cap on the events a scheduler keeps per accounting window — a runaway
#: loop must not eat the host; overflow is counted, not stored.
MAX_BUFFERED_EVENTS = 200_000


def summarize_serving(events: Iterable[Mapping[str, Any]]) -> Optional[dict]:
    """Serving rollup from ``serving`` events.

    - ``generated_tokens`` = one per prefill (its sampled first token)
      plus each ``decode_step``'s ``tokens`` field;
    - ``tokens_per_sec`` = generated tokens / (prefill + decode step
      durations) — device-busy time, not wall;
    - ``token_ms_p50``/``p99`` = nearest-rank percentiles over
      ``decode_step`` durations (each active request gains one token per
      step, so the step duration is its per-token latency);
    - ``ttft_ms_p50``/``p99`` = percentiles over the prefill events'
      ``ttft_s`` (submit -> first token);
    - ``tpot_ms_p50``/``p99`` = percentiles over per-request mean
      inter-token latency (the finish events' ``tpot_ms``, else
      ``(dur_s - ttft_s) / (generated - 1)``);
    - ``occupancy_mean`` = mean of ``n_active / n_slots`` over decode
      steps;
    - ``tenants`` = per-tenant rollup keyed by the events' ``tenant``
      field (``'default'`` when absent) and ``tenant_fairness_jain``.

    Returns None when there are no serving events."""
    queue_waits: list[float] = []
    prefills: list[float] = []
    ttfts: list[float] = []
    ttft_by_req: dict = {}
    tpots: list[float] = []
    steps: list[float] = []
    occupancy: list[float] = []
    step_tokens = 0
    finishes = 0
    finish_evs: list = []
    tenant_ttfts: dict = {}
    tenant_fin: dict = {}
    for ev in events:
        if ev.get("kind") != "serving":
            continue
        phase = ev.get("phase")
        dur = float(ev.get("dur_s") or 0.0)
        if phase == "queue_wait":
            queue_waits.append(dur)
        elif phase == "prefill":
            prefills.append(dur)
            if ev.get("ttft_s") is not None:
                ttfts.append(float(ev["ttft_s"]))
                tenant_ttfts.setdefault(
                    ev.get("tenant") or "default", []
                ).append(float(ev["ttft_s"]))
                rid = ev.get("request")
                if rid is not None and rid not in ttft_by_req:
                    ttft_by_req[rid] = float(ev["ttft_s"])
        elif phase == "decode_step":
            steps.append(dur)
            step_tokens += int(ev.get("tokens") or 0)
            n_slots = ev.get("n_slots")
            if n_slots:
                occupancy.append(float(ev.get("n_active") or 0)
                                 / float(n_slots))
        elif phase == "finish":
            finishes += 1
            finish_evs.append(ev)
    for ev in finish_evs:
        tpot = ev.get("tpot_ms")
        if tpot is None:
            gen = int(ev.get("generated") or 0)
            ttft = ttft_by_req.get(ev.get("request"))
            if gen > 1 and ttft is not None and ev.get("dur_s"):
                tpot = (float(ev["dur_s"]) - ttft) / (gen - 1) * 1e3
        if tpot is not None:
            tpots.append(float(tpot))
        tf = tenant_fin.setdefault(
            ev.get("tenant") or "default",
            {"requests": 0, "tokens": 0, "tpots": []},
        )
        tf["requests"] += 1
        tf["tokens"] += int(ev.get("generated") or 0)
        if tpot is not None:
            tf["tpots"].append(float(tpot))
    if not (queue_waits or prefills or steps or finishes):
        return None

    def pct_ms(values, q, scale=1e3):
        return round(nearest_rank(values, q) * scale, 4) if values else None

    tokens = step_tokens + len(prefills)
    busy_s = sum(prefills) + sum(steps)
    out: dict = {
        "requests": finishes,
        "prefills": len(prefills),
        "generated_tokens": tokens,
        "decode_steps": len(steps),
        "queue_wait_ms_mean": (
            round(sum(queue_waits) / len(queue_waits) * 1e3, 4)
            if queue_waits else None),
        "prefill_ms_mean": (round(sum(prefills) / len(prefills) * 1e3, 4)
                            if prefills else None),
        "token_ms_p50": pct_ms(steps, 0.5),
        "token_ms_p99": pct_ms(steps, 0.99),
        "ttft_ms_p50": pct_ms(ttfts, 0.5),
        "ttft_ms_p99": pct_ms(ttfts, 0.99),
        "tpot_ms_p50": pct_ms(tpots, 0.5, scale=1.0),
        "tpot_ms_p99": pct_ms(tpots, 0.99, scale=1.0),
        "occupancy_mean": (round(sum(occupancy) / len(occupancy), 4)
                           if occupancy else None),
        "tokens_per_sec": (round(tokens / busy_s, 2) if busy_s > 0
                           else None),
    }
    if tenant_fin or tenant_ttfts:
        tenants: dict = {}
        for t in sorted(set(tenant_fin) | set(tenant_ttfts)):
            tf = tenant_fin.get(t, {"requests": 0, "tokens": 0,
                                    "tpots": []})
            tts = tenant_ttfts.get(t, [])
            tenants[t] = {
                "requests": tf["requests"],
                "generated_tokens": tf["tokens"],
                "ttft_ms_p50": pct_ms(tts, 0.5),
                "ttft_ms_p99": pct_ms(tts, 0.99),
                "tpot_ms_p50": pct_ms(tf["tpots"], 0.5, scale=1.0),
                "tpot_ms_p99": pct_ms(tf["tpots"], 0.99, scale=1.0),
            }
        out["tenants"] = tenants
        out["tenant_fairness_jain"] = round(jain_index(
            [tenants[t]["generated_tokens"] for t in tenants]), 4)
    return out
