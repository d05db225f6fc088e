"""Traffic-trace record/replay: versioned JSONL request streams and a
deterministic virtual-clock drive loop.  A copy of
``repro/serving/observability/replay.py``: the port reads and writes the
very files the JAX package does, and ``stream_digest`` is byte-equal to
the JAX package's for the same streams, so a port replay of a pinned
trace is compared with the JAX engine's by digest alone.

A trace is the *workload*, separated from the wall clock that happened
to deliver it: each record pins a request's arrival offset, exact
prompt token ids, generation budget, SLO class, and ensemble flag.
Replaying drives the engine on a **virtual clock** — arrivals are
submitted when virtual time passes their offset and every tick advances
time by a fixed ``tick_dt`` — so admission order, preemption points,
chunking, TTFT, and latency are functions of the trace alone, not of
host load.  With greedy sampling the committed token streams are
byte-identical run-to-run (the regression harness pins the SHA-256 of
the streams), and trace-derived TTFT/latency are exactly reproducible;
only the per-tick *wall* durations differ between runs — which is
precisely the quantity the perf gate estimates robustly (pooled p10)
rather than trusting.

File format (JSONL, one object per line):

  line 1   header: ``{"schema": "horn-serving-trace", "version": 1,
           "meta": {...engine/workload provenance...}}``
  line 2+  one record per request, sorted by ``arrival_s``:
           ``{"arrival_s": float, "prompt": [int, ...],
           "max_new_tokens": int, "slo_class": str,
           "ensemble": str | null, "submodel_id": int | null,
           "session": str | null}``

``repro_torch.launch.serve --record-trace`` writes one and ``--replay``
consumes it; the JAX package's launcher and regression harness read the
same files (pinned copies live under ``benchmarks/traces/``)."""
from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SCHEMA = "horn-serving-trace"
VERSION = 1

# Virtual seconds one engine tick advances during replay.  The value is
# part of replay semantics (it scales trace-derived TTFT/latency and
# decides how many arrivals land between ticks), so the regression
# baselines pin it; 10ms approximates a healthy CPU tick and keeps
# Poisson traces recorded at rate ~16 req/s interleaving realistically.
DEFAULT_TICK_DT = 0.01


@dataclass
class TraceRecord:
    """One request of a recorded stream."""

    arrival_s: float
    prompt: List[int]
    max_new_tokens: int
    slo_class: str = "default"
    ensemble: Optional[str] = None         # combine mode or None (solo)
    submodel_id: Optional[int] = None      # routing hint (None = router)
    session: Optional[str] = None          # affinity key for hash routing

    def as_dict(self) -> dict:
        d = {"arrival_s": round(float(self.arrival_s), 6),
             "prompt": [int(t) for t in self.prompt],
             "max_new_tokens": int(self.max_new_tokens),
             "slo_class": self.slo_class}
        if self.ensemble is not None:
            d["ensemble"] = self.ensemble
        if self.submodel_id is not None:
            d["submodel_id"] = int(self.submodel_id)
        if self.session is not None:
            d["session"] = self.session
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TraceRecord":
        return cls(arrival_s=float(d["arrival_s"]),
                   prompt=[int(t) for t in d["prompt"]],
                   max_new_tokens=int(d["max_new_tokens"]),
                   slo_class=d.get("slo_class", "default"),
                   ensemble=d.get("ensemble"),
                   submodel_id=d.get("submodel_id"),
                   session=d.get("session"))


def save_trace(path: str, records: List[TraceRecord],
               meta: Optional[dict] = None) -> int:
    """Write header + records (sorted by arrival, stable) as JSONL."""
    recs = sorted(records, key=lambda r: r.arrival_s)
    with open(path, "w") as f:
        json.dump({"schema": SCHEMA, "version": VERSION,
                   "meta": dict(meta or {})}, f, sort_keys=True)
        f.write("\n")
        for r in recs:
            json.dump(r.as_dict(), f, sort_keys=True)
            f.write("\n")
    return len(recs)


def load_trace(path: str) -> Tuple[List[TraceRecord], dict]:
    """Parse a JSONL trace; returns (records, header-meta).  Rejects
    unknown schemas/major versions up front — a silently misread trace
    would produce a confidently wrong regression verdict."""
    with open(path) as f:
        lines = [ln for ln in f if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty trace file")
    head = json.loads(lines[0])
    if head.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: schema {head.get('schema')!r} != {SCHEMA!r}")
    if int(head.get("version", -1)) > VERSION:
        raise ValueError(
            f"{path}: trace version {head.get('version')} is newer than "
            f"supported version {VERSION}")
    records = [TraceRecord.from_dict(json.loads(ln)) for ln in lines[1:]]
    if not records:
        raise ValueError(f"{path}: trace has a header but no records")
    return records, head.get("meta", {})


class TraceRecorder:
    """Accumulates records during a live run (``serve.py
    --record-trace``): call ``add`` with exactly what was submitted —
    including the *resolved* ensemble decision, so replay does not
    depend on the recorder's RNG state — then ``save``."""

    def __init__(self, meta: Optional[dict] = None):
        self.records: List[TraceRecord] = []
        self.meta = dict(meta or {})

    def add(self, arrival_s: float, prompt, max_new_tokens: int, *,
            slo_class: str = "default", ensemble: Optional[str] = None,
            submodel_id: Optional[int] = None,
            session: Optional[str] = None) -> None:
        self.records.append(TraceRecord(
            arrival_s=float(arrival_s), prompt=list(map(int, prompt)),
            max_new_tokens=int(max_new_tokens), slo_class=slo_class,
            ensemble=ensemble, submodel_id=submodel_id, session=session))

    def save(self, path: str) -> int:
        return save_trace(path, self.records, self.meta)


def stream_digest(streams: List[Tuple[int, List[int]]]) -> str:
    """SHA-256 over the canonical JSON of ``[[index, [token, ...]],
    ...]`` — indices are per-replay submission order (NOT engine request
    ids, which keep incrementing across replays on a reused engine), so
    two replays of the same trace on the same engine can be compared."""
    doc = [[int(i), [int(t) for t in toks]] for i, toks in streams]
    return hashlib.sha256(
        json.dumps(doc, separators=(",", ":")).encode()).hexdigest()


@dataclass
class ReplayResult:
    """Everything a determinism check or a regression gate reads.

    ``streams``/``ttft_s``/``latency_s`` are trace-derived and
    deterministic; ``tick_wall_s`` is the only wall-clock quantity (the
    per-tick host+device durations the pooled-p10 throughput estimator
    consumes)."""

    requests: int
    ticks: int
    generated_tokens: int
    streams: List[Tuple[int, List[int]]]   # (submission index, tokens)
    token_digest: str
    ttft_s: List[float]                    # virtual-clock, per stream
    latency_s: List[float]
    tick_wall_s: List[float]               # wall, per non-trivial tick
    tick_dt: float
    accept_rate: float = 0.0
    virtual_s: float = 0.0                 # virtual makespan
    alerts: List[dict] = field(default_factory=list)

    def summary(self) -> dict:
        """JSON-ready gate inputs.  Decode throughput uses the pooled
        p10 of per-tick wall durations — the contention-robust estimate
        of what a tick costs on an otherwise-idle machine — times the
        tick count, never the run's wall clock."""
        from .metrics import percentile_or_none
        walls = sorted(self.tick_wall_s)
        p10 = walls[max(0, int(0.10 * (len(walls) - 1)))] if walls else None
        tok_s = None
        if p10 and self.ticks:
            tok_s = round(self.generated_tokens / (p10 * self.ticks), 2)
        return {
            "requests": self.requests,
            "ticks": self.ticks,
            "generated_tokens": self.generated_tokens,
            "token_digest": self.token_digest,
            "ttft_p50_s": percentile_or_none(self.ttft_s, 50),
            "ttft_p99_s": percentile_or_none(self.ttft_s, 99),
            "latency_p50_s": percentile_or_none(self.latency_s, 50),
            "latency_p99_s": percentile_or_none(self.latency_s, 99),
            "tick_p10_wall_s": None if p10 is None else round(p10, 6),
            "decode_tok_s_p10": tok_s,
            "accept_rate": round(self.accept_rate, 4),
            "virtual_s": round(self.virtual_s, 4),
            "alerts": len(self.alerts),
        }


def replay(engine, records: List[TraceRecord], *,
           tick_dt: float = DEFAULT_TICK_DT, reset: bool = True,
           max_ticks: int = 1_000_000,
           clock=time.perf_counter) -> ReplayResult:
    """Drive ``engine`` through ``records`` on the virtual clock.

    ``reset=True`` zeroes stats/telemetry first (the warmup-boundary
    reset — compile caches and the prefix cache deliberately survive,
    exactly like the benchmarks' measured phase).  The engine must have
    been built compatibly with the trace's meta (the callers check);
    temperature 0 (greedy) is what makes streams byte-identical."""
    recs = sorted(records, key=lambda r: r.arrival_s)
    if reset:
        engine.reset_stats()
    submitted: List[Tuple[int, object]] = []   # (index, Request | group)
    ticks = 0
    tick_wall_s: List[float] = []
    now, i = 0.0, 0
    while i < len(recs) or engine.sched.has_work():
        while i < len(recs) and recs[i].arrival_s <= now:
            r = recs[i]
            out = engine.submit(
                r.prompt, r.max_new_tokens, arrival_time=r.arrival_s,
                ensemble=r.ensemble, submodel_id=r.submodel_id,
                session=r.session, slo_class=r.slo_class)
            submitted.append((i, out))
            i += 1
        if not engine.sched.has_work():
            now = max(now, recs[i].arrival_s)     # idle-skip to next arrival
            continue
        w0 = clock()
        engine.step(now, tick_clock=lambda: now + tick_dt)
        tick_wall_s.append(clock() - w0)
        ticks += 1
        now += tick_dt
        if ticks > max_ticks:
            raise RuntimeError(
                f"replay exceeded {max_ticks} ticks with "
                f"{len(engine.sched.waiting)} waiting / "
                f"{len(engine.sched.running)} running — wedged engine?")

    streams: List[Tuple[int, List[int]]] = []
    ttft: List[float] = []
    lat: List[float] = []
    for idx, out in submitted:
        # an ensemble group delivers ONE stream (its leader's)
        req = out.leader if hasattr(out, "leader") else out
        streams.append((idx, [int(t) for t in req.out_tokens]))
        if req.t_first_token is not None:
            ttft.append(req.t_first_token - req.arrival_time)
        if req.t_done is not None:
            lat.append(req.t_done - req.arrival_time)

    alerts = []
    mon = getattr(engine.obs, "anomaly", None)
    if mon is not None:
        alerts = [a.as_dict() for a in mon.alerts]
    return ReplayResult(
        requests=len(recs), ticks=ticks,
        generated_tokens=engine.stats.generated_tokens,
        streams=streams, token_digest=stream_digest(streams),
        ttft_s=ttft, latency_s=lat, tick_wall_s=tick_wall_s,
        tick_dt=tick_dt, accept_rate=engine.stats.accept_rate,
        virtual_s=now, alerts=alerts)
