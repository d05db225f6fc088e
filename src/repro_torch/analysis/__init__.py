"""The port's analysis tooling: what carries over of the reference's
``repro/analysis/`` to a PyTorch package with hand-written CUDA kernels.

* ``hornlint`` — the AST linter with four pass families: ``import_time``
  (HL101, torch tensors built at module import), ``host_sync`` (HL2xx,
  device-to-host syncs on the engine's tick path), ``pool_lifetime``
  (HL4xx, page allocations that can leak) and ``sharding_contracts``
  (HL5xx, mesh-dim and logical axis names, placements and collectives'
  groups on the ``DeviceMesh``).  The pure-AST modules are copies of the
  reference's or its counterparts; findings fingerprint as its do.
* ``hornshape`` — proves the launch geometry of every route of the five
  CUDA kernels (``launch_geometry``: in-bounds, exact coverage, launch
  limits, the block-table contract), over the pure-shape models in
  ``kernels/<name>/geometry.py``.
* ``sanitize`` — the runtime sanitizer behind ``launch/serve.py
  --sanitize``: per-tick pool and block-table audits, the geometry twin at
  the engine's serving shapes, and torch guards (NaN, strict rank
  promotion).

The reference's other rules have no subject here: jit retraces (HL102-105)
and buffer donation (HL6xx) need ``jax.jit``; its Pallas contracts (HL3xx)
become ``launch_geometry``.
"""
from repro_torch.analysis.core import (Finding, lint_paths, lint_source,
                                       load_baseline, write_baseline)

__all__ = ["Finding", "lint_paths", "lint_source", "load_baseline",
           "write_baseline"]
