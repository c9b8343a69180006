"""Host-side admission loop over a :class:`ServingEngine` (counterpart of
``chainermn_tpu/serving/scheduler.py``).

FCFS by construction (the queue is arrival-ordered); the
``prefill_priority`` policy drains every admissible queued request into
free slots BEFORE each decode step, while plain ``fcfs`` admits at most
one request per decode round so in-flight decode latency stays level.

Every phase appends a ``serving`` event to the scheduler's local list:

- ``phase='queue_wait'`` — request, ``dur_s`` from submit to admission;
- ``phase='prefill'`` — request, slot, bucket, prompt_len, ``dur_s``,
  ``ttft_s`` (submit -> first token);
- ``phase='decode_step'`` — ``n_active``/``n_slots``, ``tokens``,
  ``dur_s`` (the per-token latency sample);
- ``phase='finish'`` — request, generated count, ``dur_s`` from submit,
  ``tpot_ms`` (mean inter-token latency).

:meth:`Scheduler.summary` rolls them up through
:func:`chainermn_tpu_torch.observability.trace.summarize_serving`.

Left for later: the ``slo`` policy with per-request targets and
preemption, deficit-round-robin fair share and tenants, sessions,
journeys, metric gauges and the flight heartbeat.
"""

from __future__ import annotations

import itertools
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

from chainermn_tpu_torch.observability.trace import (
    MAX_BUFFERED_EVENTS,
    summarize_serving,
)

POLICIES = ("fcfs", "prefill_priority")


@dataclass
class Request:
    """One serving request: ``prompt`` tokens in, up to
    ``max_new_tokens`` generated tokens out (generation also stops at
    ``eos_id`` when given — the emitted EOS counts as generated).

    ``seed`` is the request's sampling-stream seed: under a sampled engine
    token ``i`` draws with ``fold_in(fold_in(base_key, seed), i)``. None
    means :meth:`Scheduler.submit` derives ``crc32(request_id) &
    0x7FFFFFFF`` and stores it on the request. Greedy engines ignore it.
    """

    prompt: Sequence[int]
    max_new_tokens: int
    request_id: Optional[str] = None
    eos_id: Optional[int] = None
    seed: Optional[int] = None
    _arrival: float = field(default=0.0, repr=False)

    def __post_init__(self) -> None:
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")


@dataclass
class _InFlight:
    request: Request
    slot: int
    stream: list  # prompt + generated tokens
    generated: int
    #: perf_counter stamp of the request's first token — the TPOT clock.
    first_token_t: float


class Scheduler:
    """Admission + completion loop; see module docstring."""

    def __init__(self, engine, policy: str = "fcfs",
                 tenant_weights=None) -> None:
        if policy == "slo":
            raise NotImplementedError(
                "policy='slo' (SLO scheduling and preemption) is not "
                "ported yet (ROADMAP queue 1, serving items left out of "
                "the first slice: the slo policy and preemption)")
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got "
                             f"{policy!r}")
        if tenant_weights:
            raise NotImplementedError(
                "tenant_weights (fair-share admission) is not ported yet "
                "(ROADMAP queue 1, serving items left out of the first "
                "slice: tenants and fair share)")
        self.engine = engine
        self.policy = policy
        self._queue: deque = deque()
        self._inflight: dict[int, _InFlight] = {}
        self._ids = itertools.count()
        #: request_id -> {'tokens': prompt+generated, 'generated': [...]}
        self.results: dict = {}
        #: this window's serving events (capped; overflow is counted)
        self._events: list[dict] = []
        self.events_dropped = 0
        self._wall: Optional[float] = None
        self._window_t0 = time.perf_counter()

    # ------------------------------------------------------------------

    def _event(self, **fields) -> None:
        if len(self._events) < MAX_BUFFERED_EVENTS:
            self._events.append({"kind": "serving", **fields})
        else:
            self.events_dropped += 1

    def submit(self, request: Request) -> str:
        """Enqueue; returns the request id (assigned when absent).
        Rejects up front a request that could never finish inside the
        engine's horizon (``prompt + max_new_tokens <= max_len``)."""
        total = len(request.prompt) + request.max_new_tokens
        if total > self.engine.max_len:
            raise ValueError(
                f"request needs {total} positions (prompt "
                f"{len(request.prompt)} + max_new_tokens "
                f"{request.max_new_tokens}) but the engine horizon is "
                f"max_len={self.engine.max_len}")
        if any(r is request for r in self._queue) or any(
                fl.request is request for fl in self._inflight.values()):
            raise ValueError("request object is already queued/in flight")
        if request.request_id is None:
            request.request_id = f"r{next(self._ids)}"
        rid = request.request_id
        if request.seed is None:
            request.seed = zlib.crc32(str(rid).encode()) & 0x7FFFFFFF
        if rid in self.results or any(
                r.request_id == rid for r in self._queue) or any(
                fl.request.request_id == rid
                for fl in self._inflight.values()):
            raise ValueError(f"duplicate request_id {rid!r}")
        if not request._arrival:
            request._arrival = time.perf_counter()
        self._queue.append(request)
        return rid

    # ------------------------------------------------------------------

    def _finish(self, fl: _InFlight) -> None:
        self.engine.leave(fl.slot)
        del self._inflight[fl.slot]
        req = fl.request
        now = time.perf_counter()
        self.results[req.request_id] = {
            "tokens": list(fl.stream),
            "generated": list(fl.stream[len(req.prompt):]),
        }
        ev: dict = dict(phase="finish", request=req.request_id,
                        generated=fl.generated,
                        dur_s=round(now - req._arrival, 9))
        if fl.generated > 1:
            ev["tpot_ms"] = round(
                (now - fl.first_token_t) / (fl.generated - 1) * 1e3, 6)
        self._event(**ev)

    def _begin_stream(self, req: Request, slot: int, tok: int, *,
                      bucket, t_admit: float) -> None:
        """Register the in-flight entry for a freshly sampled first token
        and emit the ``prefill`` event with its TTFT sample (one ``now``
        stamp feeds both ``dur_s`` and ``ttft_s``)."""
        now = time.perf_counter()
        self._event(phase="prefill", request=req.request_id, slot=slot,
                    bucket=bucket, prompt_len=len(req.prompt),
                    dur_s=round(now - t_admit, 9),
                    ttft_s=round(now - req._arrival, 9))
        fl = _InFlight(req, slot, list(req.prompt) + [int(tok)], 1,
                       first_token_t=now)
        self._inflight[slot] = fl
        if fl.generated >= req.max_new_tokens or (
                req.eos_id is not None and int(tok) == req.eos_id):
            self._finish(fl)

    def _admit_one(self) -> bool:
        """Try to admit the queue head through ``prefill_join``."""
        if not self._queue:
            return False
        req = self._queue[0]
        t0 = time.perf_counter()
        res = self.engine.prefill_join(req.prompt, seed=req.seed)
        if res is None:
            return False
        self._queue.popleft()
        slot, tok, bucket = res
        self._event(phase="queue_wait", request=req.request_id,
                    dur_s=round(t0 - req._arrival, 9))
        self._begin_stream(req, slot, tok, bucket=bucket, t_admit=t0)
        return True

    def _admit_round(self) -> bool:
        """One policy-shaped admission pass: ``prefill_priority`` drains
        every admissible queued request, ``fcfs`` admits at most one."""
        if self.policy == "prefill_priority":
            progressed = False
            while self._admit_one():
                progressed = True
            return progressed
        return self._admit_one()

    def step(self) -> None:
        """One decode round: every in-flight request gains one token;
        requests that reach ``max_new_tokens`` or EOS finish."""
        toks, dur = self.engine.decode_step()
        n_active = len(self._inflight)
        self._event(phase="decode_step", n_active=n_active,
                    n_slots=self.engine.num_slots, tokens=n_active,
                    dur_s=round(dur, 9))
        for slot, fl in list(self._inflight.items()):
            tok = int(toks[slot])
            fl.stream.append(tok)
            fl.generated += 1
            req = fl.request
            if fl.generated >= req.max_new_tokens or (
                    req.eos_id is not None and tok == req.eos_id):
                self._finish(fl)

    def start_window(self) -> None:
        """Begin a fresh accounting window for :meth:`summary`."""
        self._events = []
        self.events_dropped = 0
        self._window_t0 = time.perf_counter()

    def close_window(self) -> None:
        self._wall = time.perf_counter() - self._window_t0

    def run(self, max_steps: int = 100_000,
            max_seconds: Optional[float] = None) -> dict:
        """Drive admissions + decode until queue and slots drain; returns
        :attr:`results`. :meth:`summary` covers THIS run.

        ``max_seconds`` bounds the run by wall clock (checked once per
        round; unfinished work stays queued/in flight); ``max_steps`` is
        the runaway guard and raises. Under tensor parallelism
        (``engine.tp_size > 1``) every rank must take the same decisions,
        so the clock may not end a run: ``max_seconds`` is refused."""
        if max_seconds is not None and getattr(self.engine, "tp_size", 1) > 1:
            raise ValueError(
                "max_seconds reads each rank's own clock; under tensor "
                "parallelism the ranks would stop after different rounds "
                "and leave their all-reduces unmatched")
        self.start_window()
        t0 = self._window_t0
        steps = 0
        while self._queue or self._inflight:
            if max_seconds is not None and (
                    time.perf_counter() - t0 >= max_seconds):
                break
            progressed = self._admit_round()
            if not self._inflight:
                if self._queue and not progressed:
                    head = self._queue[0]
                    raise RuntimeError(
                        f"request {head.request_id!r} cannot be admitted "
                        f"on an idle engine (prompt_len={len(head.prompt)}"
                        f", free_slots={self.engine.free_slot_count})")
                continue
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"exceeded max_steps={max_steps} with "
                    f"{len(self._inflight)} in flight")
        self.close_window()
        return self.results

    def summary(self) -> dict:
        """Tokens/s + latency accounting for the last :meth:`run` (the
        JAX package's rollup definitions), plus ``wall_s``."""
        out = summarize_serving(self._events) or {}
        if self._wall is not None:
            out["wall_s"] = round(self._wall, 4)
        if self.events_dropped:
            out["events_dropped"] = self.events_dropped
        return out
