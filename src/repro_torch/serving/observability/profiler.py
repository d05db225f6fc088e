"""Device-step cost attribution: compile cells and per-variant device
time for the engine's step functions.

The port of ``repro/serving/observability/profiler.py``, redone for
torch.  The engine's whole device story is a handful of step callables
(the unified step, one variant per chunk-width bucket, verify-window
extent and ensemble flag; the draft step, one per catch-up bucket and
draft length).  Two things about them are prime silent regressions:

  * **Late compiles.**  There is no jit cache to watch here, so a
    *compile cell* is the first call of a ``(step name, argument shapes,
    kwargs)`` variant: the JAX profiler's first-seen-signature rule.  The
    first call's wall time holds whatever the variant pays once: the
    ``kernels/build.py`` nvcc build of a kernel it is the first to launch,
    lazy library initialisation, the first allocations of its shapes.
    Those are the port's cold stalls, so they count.  A variant first
    seen after the warmup boundary (``mark_warm``, driven by
    ``Engine.reset_stats``) is a post-warm compile: a ``TickTimeline``
    span (``jit_compile``), an ``Engine.metrics()`` counter and a
    ``recompile`` anomaly alert, as in the JAX package.
  * **Cost drift.**  XLA's ``cost_analysis()`` (FLOPs, bytes accessed per
    compiled variant) has no counterpart for eager torch code, so the
    port reports what each variant *took* instead: on a CUDA device every
    wrapped call records a pair of ``torch.cuda.Event(enable_timing=True)``
    on the current stream around the call, and ``cost_report()`` gives
    per variant ``calls``, ``compiles``, ``device_ms_p50`` and
    ``device_ms_total`` over its calls (the compile call's span holds its
    first-call stall too, which the p50 shrugs off once a variant has run
    a few times).  The events are read only once the stream has passed them,
    after the tick's one deliberate host pull (``Telemetry.on_tick``
    drains them with the non-blocking ``Event.query()``), so telemetry
    adds no synchronisation to a tick.  An event pair measures the span
    of the call's work on the stream, gaps between its kernels included:
    where the host launches slower than the device runs (a host-bound
    tick) the span follows the host, and it is an upper bound on the
    device's busy time, not the busy time itself.  On the CPU the step is
    synchronous and the same fields hold the call's wall time, labelled
    ``host_ms_p50`` and ``host_ms_total``, never ``device_ms_*``.

Roofline context: ``set_peaks`` records reference rates (single-layer
paged-attention tok/s and KV GB/s), and ``roofline()`` relates achieved
rates to them.  Future CUDA-graph captures of a step report through the
same ``_record_compile``."""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

# call samples kept per variant for the p50 (the total counts all)
MAX_SAMPLES = 4096


@dataclass
class CompileEvent:
    """One observed compile cell (a variant's first call)."""

    name: str                    # wrapped step's name ("unified_step")
    variant: str                 # shape-bucket label, e.g. "C=32,ens=False"
    t0: float                    # perf_counter at call start
    dur_s: float                 # wall duration of the compiling call
    post_warm: bool              # after the warmup boundary => regression

    def as_dict(self) -> dict:
        return {"name": self.name, "variant": self.variant,
                "dur_s": round(self.dur_s, 4), "post_warm": self.post_warm}


@dataclass
class _Variant:
    """Book-keeping for one (step, shape-signature) compile cell."""

    label: str
    cuda: bool                   # timed by CUDA events, else host wall
    calls: int = 0
    compiles: int = 0
    samples: Deque[float] = field(
        default_factory=lambda: deque(maxlen=MAX_SAMPLES))   # ms a call
    total_ms: float = 0.0        # sum over every call read so far
    pending: list = field(default_factory=list)   # (start, end) events


class StepProfiler:
    """Wraps step callables; collects compile events and per-variant
    call/time stats.  One per Telemetry; the engine wraps its steps at
    construction time."""

    def __init__(self, clock=time.perf_counter, max_events: int = 256):
        self.clock = clock
        self.max_events = max_events
        self.compile_events: List[CompileEvent] = []
        self.compiles_total = 0
        self.compiles_post_warm = 0
        self._warm = False
        self._variants: Dict[tuple, _Variant] = {}
        self._pending: List[_Variant] = []       # variants with events out
        self.peaks: Dict[str, float] = {}
        # set by the owning Telemetry: routes each event to the timeline
        # span + anomaly monitor the moment the compile is observed
        self.on_compile: Optional[Callable[[CompileEvent], None]] = None

    # -- wrapping ------------------------------------------------------------
    def wrap(self, name: str, step_fn, key_fn=None, device=None):
        """Return a drop-in replacement for ``step_fn``.

        ``key_fn(args, kw)`` labels the shape bucket; the default uses
        every top-level tensor argument's shape.  ``device`` is where the
        step runs: a CUDA device times each call with CUDA events, anything
        else with the host clock."""
        cuda = device is not None and torch.device(device).type == "cuda"

        def default_key(args, kw):
            shapes = tuple(tuple(a.shape) for a in args
                           if hasattr(a, "shape"))
            return shapes, ",".join("x".join(map(str, s)) for s in shapes)

        keyer = key_fn if key_fn is not None else default_key

        def wrapped(*args, **kw):
            sig, label = keyer(args, kw)
            key = (name, sig, tuple(sorted(kw.items())))
            rec = self._variants.get(key)
            compiled = rec is None
            if compiled:
                rec = self._variants[key] = _Variant(
                    label=f"{name}[{label}]", cuda=cuda)
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = self.clock()
            out = step_fn(*args, **kw)
            dur = self.clock() - t0
            rec.calls += 1
            if compiled:
                self._record_compile(name, rec.label, t0, dur)
                rec.compiles += 1
            if cuda:
                end.record()
                if not rec.pending:
                    self._pending.append(rec)
                rec.pending.append((start, end))
            else:
                rec.samples.append(dur * 1e3)
                rec.total_ms += dur * 1e3
            return out

        return wrapped

    def drain(self, block: bool = False) -> None:
        """Read every completed event pair into its variant's samples.
        Without ``block``, a pair the stream has not passed yet stays
        pending (``Event.query`` never waits); the engine calls this after
        its tick's host pull, when every pair of the tick is complete."""
        keep = []
        for rec in self._pending:
            left = []
            for start, end in rec.pending:
                if block:
                    end.synchronize()
                elif left or not end.query():
                    left.append((start, end))
                    continue
                ms = start.elapsed_time(end)
                rec.samples.append(ms)
                rec.total_ms += ms
            rec.pending = left
            if left:
                keep.append(rec)
        self._pending = keep

    def _record_compile(self, name: str, variant: str, t0: float,
                        dur_s: float) -> None:
        ev = CompileEvent(name, variant, t0, dur_s, self._warm)
        self.compiles_total += 1
        if self._warm:
            self.compiles_post_warm += 1
        if len(self.compile_events) < self.max_events:
            self.compile_events.append(ev)
        if self.on_compile is not None:
            self.on_compile(ev)

    def mark_warm(self) -> None:
        """Warmup boundary (``Engine.reset_stats``): compiles so far were
        expected; any compile from here on is a late compile, the
        regression signal.  A no-op until a wrapped step has run at least
        once: resetting a cold engine (a one-shot ``--replay`` in a fresh
        process) must not turn its very first compiles into alerts."""
        if any(rec.calls for rec in self._variants.values()):
            self._warm = True

    # -- cost attribution ----------------------------------------------------
    def cost_report(self, compute: bool = True) -> dict:
        """Per variant: ``calls``, ``compiles`` and the calls' time,
        ``device_ms_p50`` / ``device_ms_total`` from CUDA events on a card
        or ``host_ms_p50`` / ``host_ms_total`` from the host clock on the
        CPU (None before a call's time has been read).  ``compute=True``
        first waits for any event pair still in flight (report time, never
        the tick path); ``compute=False`` reads only what has completed,
        the shape ``Engine.metrics()`` uses on the stats-line path."""
        self.drain(block=compute)
        out: Dict[str, dict] = {}
        for rec in self._variants.values():
            unit = "device_ms" if rec.cuda else "host_ms"
            out[rec.label] = {
                "calls": rec.calls, "compiles": rec.compiles,
                f"{unit}_p50": float(np.percentile(rec.samples, 50))
                if rec.samples else None,
                f"{unit}_total": rec.total_ms}
        return out

    # -- roofline ------------------------------------------------------------
    def set_peaks(self, **peaks: float) -> None:
        """Reference rates (e.g. ``kv_gb_s=...``, ``tok_s=...``);
        achieved-vs-peak gauges divide by these."""
        self.peaks.update({k: float(v) for k, v in peaks.items()
                           if v is not None})

    def roofline(self, achieved: Dict[str, float]) -> dict:
        """Relate achieved rates to the recorded peaks: for each metric
        present in both, emit the achieved value, the peak, and the
        fraction."""
        out = {}
        for k, v in achieved.items():
            entry = {"achieved": v}
            peak = self.peaks.get(k)
            if peak:
                entry["peak"] = peak
                entry["frac"] = v / peak
            out[k] = entry
        return out

    # -- lifecycle -----------------------------------------------------------
    def summary(self) -> dict:
        return {"compiles_total": self.compiles_total,
                "compiles_post_warm": self.compiles_post_warm,
                "variants": len(self._variants),
                "events": [e.as_dict() for e in self.compile_events]}

    def reset(self) -> None:
        """Drop events/counters but keep the variants and their call and
        time records (a stats reset is not a cold start, so the variants
        seen stay seen)."""
        self.compile_events.clear()
        self.compiles_total = 0
        self.compiles_post_warm = 0
