"""The port's analysis tooling: what carries over of the reference's
``repro/analysis/`` to a PyTorch package with hand-written CUDA kernels.

* ``hornlint`` — the AST linter with two pass families: ``host_sync``
  (HL2xx, device-to-host syncs on the engine's tick path) and
  ``pool_lifetime`` (HL4xx, page allocations that can leak).  The pure-AST
  modules are copies of the reference's; findings fingerprint as its do.
* ``hornshape`` — proves the launch geometry of every route of the five
  CUDA kernels (``launch_geometry``: in-bounds, exact coverage, launch
  limits, the block-table contract), over the pure-shape models in
  ``kernels/<name>/geometry.py``.
* ``sanitize`` — the runtime sanitizer behind ``launch/serve.py
  --sanitize``: per-tick pool and block-table audits, the geometry twin at
  the engine's serving shapes, and torch guards (NaN, strict rank
  promotion).

The reference's other pass families have no subject here: jit retraces
(HL1xx) and buffer donation (HL6xx) need ``jax.jit``; its Pallas contracts
(HL3xx) become ``launch_geometry``; its shard_map rules (HL5xx) wait for a
pass over the port's ``DeviceMesh`` rules (ROADMAP item 33).
"""
from repro_torch.analysis.core import (Finding, lint_paths, lint_source,
                                       load_baseline, write_baseline)

__all__ = ["Finding", "lint_paths", "lint_source", "load_baseline",
           "write_baseline"]
