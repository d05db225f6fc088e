"""Runtime sanitizers: the dynamic counterpart of the hornlint passes.

The reference's ``repro/analysis/sanitize.py`` on the port.  ``serve.py
--sanitize`` wires three layers:

* torch guards (``install_torch_guards``, the counterpart of the
  reference's ``install_jax_guards``) — a ``TorchFunctionMode`` active over
  every engine step, with two checks: the NaN guard (``jax_debug_nans``:
  the first torch op, or kernel entry behind ``kernels/*/ops.py``, whose
  floating output, or operand written in place, holds a NaN raises and
  names itself; infinities are
  legitimate mask values, as under JAX) and strict rank promotion
  (``jax_numpy_rank_promotion="raise"``: an elementwise op whose
  non-scalar tensor operands differ in rank raises; 0-d operands and
  Python numbers are exempt, as in JAX);
* per-tick pool invariants — the ``live_table_pages() == used_pages``
  accounting identity (the pool-lifetime pass's claim, checked on the
  real pool every tick, the draft pool included) plus the pool's own
  ``check_invariants()`` audit;
* block-table mirror consistency, audited where the kernels read the
  table: right after the tick's ``_sync_block_tables``, every running
  slot's mirror state carries the pool's table version and its device row
  holds the pool's table (one device-to-host copy of the table a checked
  tick).  The reference audits after the tick, where a speculative
  rollback (``truncate_seq`` after the verify) has legitimately moved the
  pool's version past the mirror's until the next sync, so it raises
  false alerts on a speculating engine (the pinned ``decode_heavy``
  trace);
* the hornshape geometry twin (first checked tick only) — both paged
  kernels proved at the engine's own serving geometry, and the table
  columns each reads held against the slots' visible live pages
  (``hornshape.crosscheck_paged_geometry``).

Alerts are collected, not raised: a sanitized run reports every violation
at exit (``serve.py`` exits 3 if any fired), so one bad tick does not hide
the next.  A guard does raise: a NaN or a rank promotion stops the step at
the op that made it.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch
from torch.overrides import TorchFunctionMode


@dataclass
class InvariantAlert:
    tick: int
    kind: str
    message: str

    def render(self) -> str:
        return f"tick {self.tick}: [{self.kind}] {self.message}"


class GuardError(RuntimeError):
    """A torch guard fired: the step stops at the op that tripped it."""


class NaNGuardError(GuardError):
    """A torch op or kernel entry produced a NaN under the NaN guard."""


class RankPromotionError(GuardError):
    """An elementwise op broadcast operands of different ranks."""


# elementwise ops whose operands jax_numpy_rank_promotion governs: the
# binary ufuncs (jnp.add ... jnp.clip raise on a rank mismatch under
# "raise"; jnp.where does not, and torch ops with no jnp ufunc are left
# alone), by base name; dunder, reflected and in-place spellings reduce
# to these
ELEMENTWISE = frozenset({
    "add", "sub", "subtract", "mul", "multiply", "div", "divide",
    "true_divide", "floor_divide", "remainder", "fmod", "pow",
    "float_power", "maximum", "minimum", "fmax", "fmin", "atan2",
    "arctan2", "hypot", "copysign", "eq", "ne", "lt", "le", "gt", "ge",
    "less", "less_equal", "greater", "greater_equal", "not_equal",
    "logical_and", "logical_or", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "and", "or", "xor", "truediv", "floordiv",
    "mod", "xlogy", "logaddexp", "logaddexp2", "nextafter", "ldexp",
    "clamp", "clip"})
# results that are uninitialised memory by design
_ALLOCATORS = frozenset({"empty", "empty_like", "new_empty", "empty_strided",
                         "new_empty_strided"})


def _inplace(func) -> bool:
    """``add_``, ``index_copy_``, ``__iadd__``: the op writes into (and
    hands back) its first operand."""
    n = getattr(func, "__name__", "")
    if n.startswith("__") and n.endswith("__"):
        return n.startswith("__i") and n[3:-2] in ELEMENTWISE
    return n.endswith("_")


def _base_name(func) -> str:
    n = getattr(func, "__name__", str(func)).strip("_")
    if n.startswith(("r", "i")) and n[1:] in ELEMENTWISE:
        n = n[1:]                       # __radd__, __iadd__
    return n.rstrip("_")                # add_


def _tensors(args, kwargs):
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (t for t in a if isinstance(t, torch.Tensor))


def _floating(out) -> list:
    """The non-empty floating tensors of an op's result."""
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() and out.numel() else []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _floating(o)]
    return []


def _nan_flag(ts: list):
    """A 0-d bool tensor on ``ts``' device: any NaN in any of them."""
    flags = [torch.isnan(t).any() for t in ts]
    return flags[0] if len(flags) == 1 else torch.stack(flags).any()


# the kernel entries behind kernels/*/ops.py: (module, attribute) of each
# function an ops dispatcher calls, the CUDA wrappers and the plain versions
KERNEL_ENTRIES = (
    ("repro_torch.kernels.paged_attention.kernel", "paged_attention"),
    ("repro_torch.kernels.paged_attention.kernel", "paged_chunk_attention"),
    ("repro_torch.kernels.paged_attention.ops", "paged_attention_ref"),
    ("repro_torch.kernels.paged_attention.ops", "paged_chunk_attention_ref"),
    ("repro_torch.kernels.flash_attention.kernel", "flash_attention_fwd"),
    ("repro_torch.kernels.flash_attention.kernel", "flash_attention_bwd"),
    ("repro_torch.kernels.flash_attention.ops", "attention_ref"),
    ("repro_torch.kernels.dropout_matmul.kernel", "dropout_matmul"),
    ("repro_torch.kernels.dropout_matmul.ops", "dropout_matmul_ref"),
    ("repro_torch.kernels.ssd.kernel", "ssd_chunk_scan"),
    ("repro_torch.kernels.ssd.ops", "ssd_chunk_scan_ref"),
)


class TorchGuards(TorchFunctionMode):
    """The NaN guard and strict rank promotion over the torch calls made
    while the mode is active, and the NaN guard over the kernel entries
    (patched in by ``install``, which the kernels' ctypes launches would
    otherwise bypass).

    A result on the CPU is checked at once.  A result on a device of
    ``DEFER`` leaves a device-side flag instead, with the op and its call
    site; the flags are read together, one sync, when the mode exits (the
    end of the engine's step), and the first op whose flag is set raises,
    as it would have at once.  A sync after every op of a 28-layer tick
    would cost ~250 ms a tick.  Rank promotion is always strict: the port
    has no caller that would allow it."""

    DEFER = ("cuda",)

    def __init__(self):
        super().__init__()
        self.ops_checked = 0
        self._patched: List[tuple] = []
        self._pending: List[tuple] = []    # (flag, what, frames)
        self._active = 0

    def __enter__(self):
        self._active += 1
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._active -= 1
        try:
            self.flush()
        finally:
            self._pending.clear()

    def flush(self) -> None:
        """Read the deferred flags (one sync); raise for the first NaN."""
        if not self._pending:
            return
        flags = torch.stack([f for f, _, _ in self._pending])
        if bool(flags.any()):
            what, frames = self._pending[int(flags.nonzero()[0, 0])][1:]
            self._pending.clear()
            raise NaNGuardError(f"NaN guard: {what} produced a NaN at "
                                f"{_render(frames)} (jax_debug_nans)")
        self._pending.clear()

    def _check(self, out, what: str) -> None:
        """The NaN check of one result: at once on the CPU, deferred (a
        device flag) on a ``defer`` device while the mode is active."""
        ts = _floating(out)
        if not ts:
            return
        if self._active and ts[0].device.type in self.DEFER:
            self._pending.append((_nan_flag(ts), what, _frames()))
        elif bool(_nan_flag(ts)):
            raise NaNGuardError(f"NaN guard: {what} produced a NaN at "
                                f"{_render(_frames())} (jax_debug_nans)")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _base_name(func)
        if name in ELEMENTWISE:
            ranks = {t.dim() for t in _tensors(args, kwargs) if t.dim() > 0}
            if len(ranks) > 1:
                shapes = [tuple(t.shape) for t in _tensors(args, kwargs)]
                raise RankPromotionError(
                    f"rank guard: {_qual(func)} broadcasts operands of "
                    f"ranks {sorted(ranks)} (shapes {shapes}); make the rank "
                    f"explicit (jax_numpy_rank_promotion='raise')")
        out = func(*args, **kwargs)
        self.ops_checked += 1
        # an op that hands back one of its inputs (a no-op cast) made
        # nothing, unless it wrote into it in place; uninitialised
        # allocations are not values yet
        if name not in _ALLOCATORS and (
                _inplace(func) or not any(out is a for a in args)):
            self._check(out, _qual(func))
        return out

    # -- kernel entries ------------------------------------------------------
    def install(self) -> "TorchGuards":
        """Wrap every kernel entry so a NaN in its output raises."""
        import importlib
        if self._patched:
            return self
        for mod_name, attr in KERNEL_ENTRIES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._patched.append((mod, attr, fn))
            setattr(mod, attr, self._checked(f"{mod_name}.{attr}", fn))
        return self

    def uninstall(self) -> None:
        for mod, attr, fn in reversed(self._patched):
            setattr(mod, attr, fn)
        self._patched.clear()

    def _checked(self, label: str, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def entry(*a, **kw):
            out = fn(*a, **kw)
            self._check(out, f"kernel entry {label}")
            return out
        return entry


def _frames() -> list:
    """(file, line, function) of the two innermost frames of the port
    outside this module: where the op was called, and from where."""
    import sys
    out, f = [], sys._getframe(1)
    while f is not None and len(out) < 2:
        name = f.f_code.co_filename
        if "repro_torch" in name and "repro_torch/analysis" not in name:
            out.append((name.split("repro_torch/")[-1], f.f_lineno,
                        f.f_code.co_name))
        f = f.f_back
    return out


def _render(frames) -> str:
    return " <- ".join(f"{n}:{ln} ({fn})" for n, ln, fn in frames) \
        or "<outside the port>"


def _qual(func) -> str:
    mod = getattr(func, "__module__", None) or ""
    name = getattr(func, "__qualname__", None) or getattr(
        func, "__name__", repr(func))
    if "Tensor" in name or not mod:
        return f"torch.{name}" if not name.startswith("torch") else name
    return f"{mod}.{name}"


@dataclass
class Sanitizer:
    """Attachable per-tick invariant checker for a serving Engine."""
    check_every: int = 1
    alerts: List[InvariantAlert] = field(default_factory=list)
    ticks_checked: int = 0
    guards: Optional[TorchGuards] = None

    # ------------------------------------------------------------------
    def install_torch_guards(self) -> TorchGuards:
        """The NaN guard and strict rank promotion, active over every step
        of the engine ``attach`` wraps; the kernel entries are wrapped at
        once.  Call before the engine is built, as the reference installs
        its jax guards before anything is jitted."""
        self.guards = TorchGuards().install()
        return self.guards

    def attach(self, engine) -> "Sanitizer":
        """Wrap ``engine.step`` so every tick runs under the guards and
        then the invariant suite.  The wrapper lives on the instance, so
        both the live loop and trace replay (which drive ``engine.step``)
        are covered."""
        inner: Callable = engine.step
        sync = getattr(engine, "_sync_block_tables", None)
        if sync is not None:
            def synced():
                sync()
                tick = engine.steps + 1          # the tick being run
                if tick % max(1, self.check_every) == 0:
                    self.check_block_tables(engine, tick)
            engine._sync_block_tables = synced

        def stepped(*a, **kw):
            if self.guards is not None:
                with self.guards:
                    out = inner(*a, **kw)
            else:
                out = inner(*a, **kw)
            if engine.steps % max(1, self.check_every) == 0:
                self.check(engine, engine.steps)
            return out

        engine.step = stepped
        engine._sanitizer = self
        return self

    # ------------------------------------------------------------------
    def _alert(self, tick: int, kind: str, message: str) -> None:
        self.alerts.append(InvariantAlert(tick, kind, message))

    def check(self, engine, tick: int) -> None:
        self.ticks_checked += 1
        if self.ticks_checked == 1:
            self._check_kernel_geometry(engine, tick)
        self._check_pool(engine.pool, tick, "pool")
        spec = getattr(engine, "spec", None)
        if spec is not None:
            self._check_pool(spec.pool, tick, "draft-pool")

    def _check_kernel_geometry(self, engine, tick: int) -> None:
        """hornshape's runtime twin: both paged kernels proved at the
        geometry this engine serves (its slots, kv heads, head dim, page
        size, pages, table width, dtypes and windows).  Geometry is static
        per engine, so once per attach is enough."""
        ecfg = getattr(engine, "ecfg", None)
        cfg = getattr(engine, "cfg", None)
        bt = getattr(engine, "_bt", None)
        if ecfg is None or cfg is None or getattr(bt, "host", None) is None:
            return                    # not a paged engine (stubs, tests)
        from repro_torch.analysis.hornshape import crosscheck_paged_geometry
        from repro_torch.kernels.paged_attention import geometry, kernel
        dev = getattr(engine, "device", torch.device("cpu"))
        sms = kernel.sm_count(dev.index or 0) if dev.type == "cuda" \
            else geometry.H100_SMS
        windows = {None}
        if getattr(cfg, "sliding_window", None) and any(
                k != "attn" for k in getattr(cfg, "layer_pattern", ())):
            windows.add(int(cfg.sliding_window))
        batch, max_pages = bt.host.shape
        try:
            alerts = []
            for window in sorted(windows, key=lambda w: w or 0):
                alerts += crosscheck_paged_geometry(
                    batch=int(batch), kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.head_dim, page_size=ecfg.page_size,
                    num_pages=ecfg.num_pages, max_pages=int(max_pages),
                    quantized=str(ecfg.kv_dtype) == "int8",
                    num_heads=cfg.num_heads,
                    dtype=str(ecfg.compute_dtype), window=window,
                    sm_count=sms)
        except Exception as e:        # an alert, never a dead tick
            self._alert(tick, "hornshape",
                        f"geometry cross-check failed: "
                        f"{type(e).__name__}: {e}")
            return
        for a in alerts:
            self._alert(tick, "hornshape", a)

    def _check_pool(self, pool, tick: int, label: str) -> None:
        live, used = pool.live_table_pages(), pool.used_pages
        if live != used:
            self._alert(tick, f"{label}-leak",
                        f"live_table_pages()={live} != used_pages={used} "
                        f"(free={pool.free_pages}, "
                        f"cached={pool.cached_pages}) — pages left the "
                        f"free list that no live table references")
        try:
            pool.check_invariants()
        except AssertionError as e:
            self._alert(tick, f"{label}-invariant", str(e))

    def check_block_tables(self, engine, tick: int) -> None:
        """The mirror as the tick's kernels read it: run right after the
        engine's ``_sync_block_tables`` (``attach`` wires it there)."""
        bt = getattr(engine, "_bt", None)
        if bt is None or not hasattr(bt, "_state") \
                or not engine.sched.running:
            return
        rows = bt.dev.cpu().numpy()       # the table the kernels read
        for slot, req in engine.sched.running.items():
            try:
                want = engine.pool.table_version(req.id)
                table = engine.pool.table(req.id)
            except (KeyError, ValueError):
                self._alert(tick, "block-table",
                            f"slot {slot} runs seq {req.id} with no pool "
                            f"table")
                continue
            have = bt._state[slot] if slot < len(bt._state) else None
            if have is None or have[0] != req.id or have[-1] != want:
                self._alert(tick, "block-table",
                            f"slot {slot} mirror row is stale (state "
                            f"{have} != seq {req.id} at pool version "
                            f"{want})")
            elif [int(p) for p in rows[slot, :len(table)]] != table:
                self._alert(tick, "block-table",
                            f"slot {slot} device row holds pages "
                            f"{[int(p) for p in rows[slot, :len(table)]]} "
                            f"!= the pool's table {table} for seq {req.id}")

    # ------------------------------------------------------------------
    def report(self) -> dict:
        return {
            "ticks_checked": self.ticks_checked,
            "alerts": len(self.alerts),
            "by_kind": {k: sum(1 for a in self.alerts if a.kind == k)
                        for k in sorted({a.kind for a in self.alerts})},
        }

    def render_report(self) -> str:
        if not self.alerts:
            return (f"sanitizer: 0 invariant alerts over "
                    f"{self.ticks_checked} checked ticks")
        lines = [f"sanitizer: {len(self.alerts)} invariant alert(s) over "
                 f"{self.ticks_checked} checked ticks"]
        lines += [f"  {a.render()}" for a in self.alerts[:20]]
        if len(self.alerts) > 20:
            lines.append(f"  ... and {len(self.alerts) - 20} more")
        return "\n".join(lines)
