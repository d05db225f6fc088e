"""Serving observability of the port: metrics registry, request
lifecycle tracing, per-tick Perfetto timelines, SLO attainment,
traffic-trace record/replay, device-step cost attribution from CUDA
events, and live anomaly detection: the one telemetry substrate the
engine writes and everything else (stats lines, the exit report, replay)
reads.

The port of ``repro/serving/observability/``.  Seven of its modules are
copies (numpy and the standard library only); ``profiler.py`` is redone
for torch: a compile cell is a step variant's first call, and each call's
device time is read from a pair of CUDA events after the tick's one host
pull (the wall time of the synchronous call on the CPU), in place of
XLA's ``cost_analysis``."""
from .anomaly import (ACCEPT_COLLAPSE, ALERT_KINDS, POOL_LEAK, RECOMPILE,
                      SLO_BURN, TICK_SPIKE, AcceptCollapseDetector, Alert,
                      AnomalyMonitor, BurnRateDetector, PoolLeakWatchdog,
                      TickSpikeDetector)
from .metrics import (DEFAULT_MAX_LABELS, OVERFLOW_LABEL, Counter, Gauge,
                      Histogram, MetricsRegistry, percentile,
                      percentile_or_none)
from .profiler import CompileEvent, StepProfiler
from .replay import (ReplayResult, TraceRecord, TraceRecorder, load_trace,
                     replay, save_trace, stream_digest)
from .slo import DEFAULT_CLASS, SLOClass, SLOTracker, parse_slo_class
from .stats import EngineStats
from .telemetry import Telemetry
from .trace import (ADMIT, EVENT_KINDS, FINISH, PREEMPT, PREFILL_CHUNK,
                    PREFIX_ADOPT, SPECULATE, SUBMIT, TICK_PHASES, TOKEN,
                    RequestTrace, RequestTracer, TickTimeline, TraceEvent,
                    validate_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "percentile", "percentile_or_none",
    "DEFAULT_MAX_LABELS", "OVERFLOW_LABEL",
    "DEFAULT_CLASS", "SLOClass", "SLOTracker", "parse_slo_class",
    "EngineStats", "Telemetry",
    "SUBMIT", "ADMIT", "PREFIX_ADOPT", "PREFILL_CHUNK", "TOKEN",
    "SPECULATE", "PREEMPT", "FINISH", "EVENT_KINDS", "TICK_PHASES",
    "TraceEvent", "RequestTrace", "RequestTracer", "TickTimeline",
    "validate_chrome_trace",
    "Alert", "ALERT_KINDS", "TICK_SPIKE", "SLO_BURN", "POOL_LEAK",
    "ACCEPT_COLLAPSE", "RECOMPILE", "AnomalyMonitor", "TickSpikeDetector",
    "BurnRateDetector", "PoolLeakWatchdog", "AcceptCollapseDetector",
    "CompileEvent", "StepProfiler",
    "TraceRecord", "TraceRecorder", "ReplayResult",
    "load_trace", "save_trace", "replay", "stream_digest",
]
