"""Request router over a ModelBank: tags every request with a submodel_id.

A copy of ``repro/serving/router.py`` (host-only, no framework).  Three
policies:

  "explicit"      the caller names the circuit (``submodel_id=...``); the
                  router only validates the id.
  "hash"          stable affinity: the same session key (or, failing that,
                  the same prompt bytes) always lands on the same circuit —
                  useful when callers want a *consistent* sub-model per
                  conversation without pinning ids themselves.
  "least_loaded"  balance in-flight requests: pick the circuit with the
                  fewest live requests (ties -> lowest id).  The engine
                  reports completions back via ``release``.

An explicit ``submodel_id`` always wins regardless of policy.  The router
is pure host-side bookkeeping — the engine gathers the chosen circuit's
masks on the device per slot, so routing adds no per-layer host work.
"""
from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

POLICIES = ("explicit", "hash", "least_loaded")


class Router:
    def __init__(self, num_submodels: int, *, policy: str = "least_loaded"):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")
        if num_submodels < 1:
            raise ValueError("router needs at least one submodel")
        self.num_submodels = num_submodels
        self.policy = policy
        self.loads = [0] * num_submodels    # in-flight requests per circuit
        self.routed = [0] * num_submodels   # lifetime assignments (stats)

    def _check(self, g: int) -> int:
        if not 0 <= g < self.num_submodels:
            raise ValueError(
                f"submodel_id {g} not in [0, {self.num_submodels})")
        return g

    def _hash_key(self, session, prompt) -> bytes:
        if session is not None:
            return str(session).encode()
        if prompt is None:
            raise ValueError("hash policy needs a session key or a prompt")
        return np.ascontiguousarray(prompt, dtype=np.int32).tobytes()

    def route(self, *, submodel_id: Optional[int] = None, session=None,
              prompt=None) -> int:
        """Pick (and account for) the circuit serving one new request."""
        if submodel_id is not None:
            g = self._check(int(submodel_id))
        elif self.policy == "explicit":
            raise ValueError("policy 'explicit' requires submodel_id")
        elif self.policy == "hash":
            g = zlib.crc32(self._hash_key(session, prompt)) \
                % self.num_submodels
        else:                               # least_loaded
            g = min(range(self.num_submodels), key=lambda i: self.loads[i])
        self.loads[g] += 1
        self.routed[g] += 1
        return g

    def acquire(self, g: int) -> int:
        """Account for a request pinned to ``g`` outside ``route`` (e.g.
        one member of an ensemble fan-out)."""
        g = self._check(g)
        self.loads[g] += 1
        self.routed[g] += 1
        return g

    def release(self, g: int) -> None:
        """A request on circuit ``g`` finished (engine callback)."""
        self._check(g)
        if self.loads[g] <= 0:
            raise ValueError(f"release without matching route on {g}")
        self.loads[g] -= 1

    def stats(self) -> dict:
        """Per-circuit load/assignment snapshot for the telemetry layer."""
        return {
            "policy": self.policy,
            "loads": {g: n for g, n in enumerate(self.loads)},
            "routed": {g: n for g, n in enumerate(self.routed)},
        }
