"""Request lifecycle tracing and the per-tick engine timeline.
A copy of ``repro/serving/observability/trace.py``.

Two recorders, two clocks, deliberately:

  * ``RequestTracer`` records typed lifecycle events (submit -> admit /
    prefix-adopt -> prefill chunk(s) -> token commits -> speculate ->
    preempt -> finish) on the **engine clock** — the same ``now`` /
    ``arrival_time`` values the scheduler stamps onto requests.  TTFT,
    time-in-queue, preemption wait, and accept rate are therefore
    *derived* from events and match the request-timestamp ground truth
    exactly (tested), instead of being hand-computed in three places.
  * ``TickTimeline`` records wall spans on ``time.perf_counter``: each
    engine tick split into plan / host_prep / device_step / commit
    phases, one annotated span per slot per device call, plus instant
    markers (admissions, preemptions) and counter tracks (pool pages,
    queue depth).  ``to_chrome()`` emits Chrome Trace Event JSON —
    ``--trace-out trace.json`` opens directly in Perfetto
    (https://ui.perfetto.dev) or chrome://tracing.

Everything here is host-side and append-only; the device step never
sees any of it, so the one-device-call-per-tick invariant is untouched.
"""
from __future__ import annotations

import json
import numbers
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

# -- lifecycle event kinds ---------------------------------------------------
SUBMIT = "submit"                # queued (t = arrival_time)
ADMIT = "admit"                  # joined a slot (data: slot, cached, wait_s)
PREFIX_ADOPT = "prefix_adopt"    # admission mapped cached pages (data: tokens)
PREFILL_CHUNK = "prefill_chunk"  # chunk streamed into pages (data: start, n)
TOKEN = "token"                  # committed tokens (data: n)
SPECULATE = "speculate"          # verify verdict (data: drafted, accepted, n)
PREEMPT = "preempt"              # evicted back to the queue head
FINISH = "finish"                # stream complete (EOS / max_new)

EVENT_KINDS = (SUBMIT, ADMIT, PREFIX_ADOPT, PREFILL_CHUNK, TOKEN,
               SPECULATE, PREEMPT, FINISH)


@dataclass
class TraceEvent:
    kind: str
    t: float                         # engine-clock seconds
    data: dict = field(default_factory=dict)


@dataclass
class RequestTrace:
    """One request's event stream plus the derived lifecycle metrics.

    Derivations only ever read events — if a derived number disagrees
    with the scheduler's own timestamps, the *trace* is wrong, which is
    exactly what the parity test pins down."""

    req_id: int
    events: List[TraceEvent] = field(default_factory=list)

    def add(self, kind: str, t: float, **data) -> None:
        self.events.append(TraceEvent(kind, t, data))

    def first(self, kind: str) -> Optional[TraceEvent]:
        for e in self.events:
            if e.kind == kind:
                return e
        return None

    def of_kind(self, kind: str) -> List[TraceEvent]:
        return [e for e in self.events if e.kind == kind]

    # -- derived metrics -----------------------------------------------------
    @property
    def submit_t(self) -> Optional[float]:
        e = self.first(SUBMIT)
        return e.t if e else None

    @property
    def first_token_t(self) -> Optional[float]:
        e = self.first(TOKEN)
        return e.t if e else None

    @property
    def finish_t(self) -> Optional[float]:
        e = self.first(FINISH)
        return e.t if e else None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def latency_s(self) -> Optional[float]:
        if self.submit_t is None or self.finish_t is None:
            return None
        return self.finish_t - self.submit_t

    @property
    def queue_s(self) -> Optional[float]:
        """Submit -> first admission."""
        adm = self.first(ADMIT)
        if adm is None or self.submit_t is None:
            return None
        return adm.t - self.submit_t

    @property
    def num_preemptions(self) -> int:
        return len(self.of_kind(PREEMPT))

    @property
    def preempt_wait_s(self) -> float:
        """Total time spent back in the queue after preemptions: the sum
        over each preempt -> next re-admission gap (the queueing cost a
        preemption injects; the recompute cost shows up as extra
        ``prefill_chunk`` tokens)."""
        total, pending = 0.0, None
        for e in self.events:
            if e.kind == PREEMPT:
                pending = e.t
            elif e.kind == ADMIT and pending is not None:
                total += e.t - pending
                pending = None
        return total

    @property
    def prefill_tokens(self) -> int:
        return sum(e.data.get("n", 0) for e in self.of_kind(PREFILL_CHUNK))

    @property
    def cached_tokens(self) -> int:
        return sum(e.data.get("n", 0) for e in self.of_kind(PREFIX_ADOPT))

    @property
    def committed_tokens(self) -> int:
        return sum(e.data.get("n", 0) for e in self.of_kind(TOKEN))

    @property
    def drafted_tokens(self) -> int:
        return sum(e.data.get("drafted", 0) for e in self.of_kind(SPECULATE))

    @property
    def accepted_tokens(self) -> int:
        return sum(e.data.get("accepted", 0) for e in self.of_kind(SPECULATE))


class RequestTracer:
    """Lifecycle recorder: one ``RequestTrace`` per request id, moved to
    the ``finished`` ring on its finish event.  ``maxlen`` bounds
    retention for long-running servers (None keeps everything — the
    launcher and tests read the full set at exit)."""

    def __init__(self, maxlen: Optional[int] = None):
        self.live: Dict[int, RequestTrace] = {}
        self.finished: Deque[RequestTrace] = deque(maxlen=maxlen)

    def record(self, req_id: int, kind: str, t: float, **data) -> None:
        tr = self.live.get(req_id)
        if tr is None:
            tr = self.live[req_id] = RequestTrace(req_id)
        tr.add(kind, t, **data)
        if kind == FINISH:
            self.finished.append(self.live.pop(req_id))

    def get(self, req_id: int) -> Optional[RequestTrace]:
        if req_id in self.live:
            return self.live[req_id]
        for tr in self.finished:
            if tr.req_id == req_id:
                return tr
        return None

    @property
    def num_events(self) -> int:
        return sum(len(t.events) for t in self.live.values()) \
            + sum(len(t.events) for t in self.finished)

    def clear(self) -> None:
        self.live.clear()
        self.finished.clear()


# -- per-tick engine timeline ------------------------------------------------
TICK_PHASES = ("plan", "host_prep", "device_step", "commit")

_PID = 0           # one engine process
_ENGINE_TID = 0    # engine-phases track; slot s renders on tid s + 1


class TickTimeline:
    """Wall-clock spans per engine tick, exported as Chrome Trace Event
    JSON.  Tracks: tid 0 is the engine-phases track (plan / host_prep /
    device_step / commit slices per tick, nested extra spans like the
    draft call, instants, counter series); tid ``s + 1`` is slot ``s``
    (what that slot contributed to each device call: ``prefill``,
    ``decode``, or ``verify+K``, annotated with request id and token
    counts).  Timestamps are ``time.perf_counter`` microseconds,
    rebased to the first recorded event at export."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self._spans: List[Tuple[str, int, float, float, dict]] = []
        self._instants: List[Tuple[str, float, dict]] = []
        self._counters: List[Tuple[str, float, dict]] = []
        self._metadata: dict = {}
        self.ticks = 0

    def set_metadata(self, **kv) -> None:
        """Stamp run-level configuration (kv_dtype,
        speculate_k, ...) into the export: it lands both in
        ``otherData`` and as an ``engine_config`` metadata event, so two
        traces from differently-tuned engines are distinguishable inside
        Perfetto, not just by filename."""
        self._metadata.update(kv)

    # -- recording -----------------------------------------------------------
    def add_tick(self, tick: int, marks: Sequence[float],
                 slot_events: Sequence[Tuple[int, str, float, float, dict]]
                 = (), extra_spans: Sequence[Tuple[str, float, float]] = (),
                 counters: Optional[dict] = None) -> None:
        """``marks`` are the 5 phase boundaries (start, after-plan,
        after-host-prep, after-device, end); ``slot_events`` are
        (slot, name, t0, t1, args) annotations; ``extra_spans`` nest
        inside the tick on the engine track (e.g. the draft call);
        ``counters`` is a point sample for the counter track."""
        if len(marks) != len(TICK_PHASES) + 1:
            raise ValueError(
                f"need {len(TICK_PHASES) + 1} marks, got {len(marks)}")
        for name, t0, t1 in zip(TICK_PHASES, marks, marks[1:]):
            self._spans.append((name, _ENGINE_TID, t0, t1, {"tick": tick}))
        for name, t0, t1 in extra_spans:
            self._spans.append((name, _ENGINE_TID, t0, t1, {"tick": tick}))
        for slot, name, t0, t1, args in slot_events:
            self._spans.append((name, slot + 1, t0, t1,
                                {"tick": tick, **args}))
        if counters:
            self._counters.append(("engine", marks[0], dict(counters)))
        self.ticks += 1

    def span(self, name: str, t0: float, t1: float,
             tid: int = _ENGINE_TID, **args) -> None:
        """One standalone wall span on the given track — compile events
        and other out-of-tick work the phase marks don't cover."""
        self._spans.append((name, tid, t0, t1, args))

    def instant(self, name: str, t: Optional[float] = None,
                **args) -> None:
        self._instants.append((name, self.clock() if t is None else t, args))

    @property
    def num_events(self) -> int:
        return len(self._spans) + len(self._instants) + len(self._counters)

    def clear(self) -> None:
        self._spans.clear()
        self._instants.clear()
        self._counters.clear()
        self.ticks = 0

    # -- export --------------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome Trace Event JSON (the ``traceEvents`` object form) —
        loadable as-is in Perfetto / chrome://tracing."""
        times = [t0 for _, _, t0, _, _ in self._spans] \
            + [t for _, t, _ in self._instants] \
            + [t for _, t, _ in self._counters]
        t0 = min(times) if times else 0.0
        us = lambda t: (t - t0) * 1e6               # noqa: E731
        tids = sorted({tid for _, tid, _, _, _ in self._spans})
        ev: List[dict] = [{
            "ph": "M", "pid": _PID, "tid": _ENGINE_TID,
            "name": "process_name", "args": {"name": "horn-serving-engine"},
        }]
        if self._metadata:
            ev.append({"ph": "M", "pid": _PID, "tid": _ENGINE_TID,
                       "name": "engine_config",
                       "args": dict(self._metadata)})
        for tid in sorted(set(tids) | {_ENGINE_TID}):
            ev.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": "thread_name",
                       "args": {"name": "engine phases" if tid == 0
                                else f"slot {tid - 1}"}})
        for name, tid, a, b, args in self._spans:
            ev.append({"ph": "X", "pid": _PID, "tid": tid, "name": name,
                       "cat": "engine" if tid == _ENGINE_TID else "slot",
                       "ts": us(a), "dur": max(0.0, us(b) - us(a)),
                       "args": args})
        for name, t, args in self._instants:
            ev.append({"ph": "i", "pid": _PID, "tid": _ENGINE_TID,
                       "name": name, "cat": "engine", "ts": us(t),
                       "s": "t", "args": args})
        for name, t, values in self._counters:
            ev.append({"ph": "C", "pid": _PID, "tid": _ENGINE_TID,
                       "name": name, "ts": us(t), "args": values})
        other = {"source": "repro_torch.serving.observability"}
        if self._metadata:
            other["engine_config"] = dict(self._metadata)
        return {"traceEvents": ev,
                "displayTimeUnit": "ms",
                "otherData": other}

    def export(self, path: str) -> int:
        """Write the Chrome trace to ``path``; returns the event count."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f, default=_json_scalar)
            f.write("\n")
        return len(doc["traceEvents"])


def _json_scalar(o):
    """numpy ints/floats riding in span args -> JSON scalars."""
    if isinstance(o, numbers.Integral):
        return int(o)
    if isinstance(o, numbers.Real):
        return float(o)
    raise TypeError(f"not JSON-serializable: {type(o)}")


# -- schema check ------------------------------------------------------------
_PH_REQUIRED = {
    "X": ("ts", "dur"),
    "B": ("ts",), "E": ("ts",),
    "i": ("ts",), "I": ("ts",),
    "C": ("ts",),
    "M": (),
}


def validate_chrome_trace(doc) -> int:
    """Minimal Trace Event JSON schema check (the CI gate): the object
    form with a ``traceEvents`` list whose events each carry a known
    ``ph``, a string ``name``, integer ``pid``/``tid``, and the
    non-negative numeric timing fields their phase requires.  Raises
    ``ValueError`` with the first offending event; returns the event
    count."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"event {i} is not an object: {e!r}")
        ph = e.get("ph")
        if ph not in _PH_REQUIRED:
            raise ValueError(f"event {i} has unknown ph {ph!r}")
        if not isinstance(e.get("name"), str) or not e["name"]:
            raise ValueError(f"event {i} has no name: {e!r}")
        for k in ("pid", "tid"):
            if not isinstance(e.get(k), numbers.Integral):
                raise ValueError(f"event {i} missing integer {k!r}: {e!r}")
        for k in _PH_REQUIRED[ph]:
            v = e.get(k)
            if not isinstance(v, numbers.Real) or v < 0:
                raise ValueError(
                    f"event {i} ({ph!r}) needs non-negative numeric "
                    f"{k!r}: {e!r}")
    return len(events)
