"""Engine serving counters as a dataclass, so the field list is the
single source of truth.

The port of ``repro/serving/observability/stats.py``, plus the port's own
launch counters (``attn_launches``, ``decode_launches``,
``draft_attn_launches``, ``draft_decode_launches``) and ``decode_ticks``.
``reset()`` walks ``dataclasses.fields`` and restores every field to its
declared default, so a newly added counter can never survive a
benchmark's warmup reset: adding a field IS adding its reset.  Derived
rates live here too, all safe at zero denominators (a fresh engine
reports 0.0 rates and a ``None`` prefix hit rate, never a division crash
or a misleading number).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class EngineStats:
    """Serving counters for one engine, zeroed by ``reset()`` between a
    benchmark's warmup and its measured phase."""

    steps: int = 0                   # unified device ticks issued
    generated_tokens: int = 0        # committed (recorded) tokens
    prefill_tokens: int = 0          # prompt/recompute tokens streamed
    peak_utilization: float = 0.0    # page-pool high-water mark
    bt_rows_synced: int = 0          # block-table rows re-uploaded
    ticks_nonempty: int = 0          # ticks that issued a device call
    ticks_cobatched: int = 0         # ...carrying >= 2 distinct submodels
    tokens_by_submodel: Dict[int, int] = field(default_factory=dict)
    peak_util_by_submodel: Dict[int, float] = field(default_factory=dict)
    # prefix-cache / COW accounting
    cache_hit_tokens: int = 0        # prompt tokens served from cache
    cache_eligible_tokens: int = 0   # prompt tokens lookups could cover
    prefill_tok_saved: int = 0       # hit tokens + ensemble fork savings
    cow_page_copies: int = 0         # device page copies issued
    # speculative-decode accounting
    spec_slot_ticks: int = 0         # (speculating slot, tick) pairs
    spec_drafted: int = 0            # draft tokens the parent verified
    spec_accepted: int = 0           # drafts that survived verification
    spec_committed: int = 0          # tokens committed by verify ticks
    # the port's paged-kernel launches (0 on the CPU, which runs the
    # plain versions)
    attn_launches: int = 0           # the parent's launches of both
                                     # paged kernels
    decode_launches: int = 0         # of them, the decode kernel's
    draft_attn_launches: int = 0     # the draft's launches of both
    draft_decode_launches: int = 0   # of them, the decode kernel's
    decode_ticks: int = 0            # ticks of chunk bucket 1 (decode only)

    def reset(self) -> None:
        """Restore every field to its declared default.  Derived from
        ``dataclasses.fields``, so a counter added tomorrow is reset
        tomorrow: there is no second list to forget to update."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default_factory()
                    if f.default_factory is not dataclasses.MISSING
                    else f.default)

    def as_dict(self) -> dict:
        """Shallow snapshot of every counter (dict fields copied)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = dict(v) if isinstance(v, dict) else v
        return out

    # -- derived rates (all zero-denominator safe) ---------------------------
    @property
    def accept_rate(self) -> float:
        """Fraction of drafted tokens the parent accepted (0.0 when
        nothing was drafted)."""
        return self.spec_accepted / max(1, self.spec_drafted)

    @property
    def accepted_tok_per_tick(self) -> float:
        """Tokens committed per (speculating slot, tick): 1.0 is plain
        decode's ceiling, 0.0 when nothing speculated."""
        return self.spec_committed / max(1, self.spec_slot_ticks)

    @property
    def cobatch_ratio(self) -> float:
        """Fraction of non-empty ticks whose one device call carried
        tokens from >= 2 distinct sub-models (0.0 before any tick)."""
        return self.ticks_cobatched / max(1, self.ticks_nonempty)

    @property
    def prefix_hit_rate(self) -> Optional[float]:
        """Fraction of cache-eligible prompt tokens served from the
        prefix cache, or None when nothing was eligible (cache disabled,
        or no lookup could match), so reports say "n/a"/null instead of a
        misleading 0.0."""
        if self.cache_eligible_tokens == 0:
            return None
        return self.cache_hit_tokens / self.cache_eligible_tokens
