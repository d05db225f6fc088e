"""HL4xx — PagePool allocation lifetimes over the port's ``serving/``.

The reference's pass (``repro/analysis/pool_lifetime.py``), copied: the
port's ``PagePool`` (``serving/kv_cache.py``) keeps the reference's
allocation names (``alloc``, ``alloc_pages``, ``fork``, ``adopt_prefix``)
and release names (``free_seq``, ``truncate_seq``, and the prefix cache's
``release``).  Its one other page-taking call, ``ensure``, grows a table
that is already registered (and so already reachable by ``free_seq``), as
does ``prepare_write``'s copy-on-write swap; neither creates an owner, so
neither is an allocation here.

Pages handed out by ``alloc``/``alloc_pages``/``fork``/``adopt_prefix``
must reach an owner that a later ``free_seq``/``truncate_seq``/``release``
can find — on *every* path, including exception edges.  An allocation
that escapes neither into a field/container nor back to the caller, or
that is live when an unguarded ``raise`` fires, leaks pool pages until
the watchdog trips at 3 a.m.

Abstract interpretation over each function body: an alloc-family call
creates an *unpublished* allocation keyed by the root variable of its
seq-id argument.  Publication = storing into an attribute/subscript
mentioning that root, appending it to a container, or returning/yielding
an expression that mentions it.  Release-family calls retire it.

* HL401 ``leak-on-raise``: a ``raise`` (outside a try whose handlers or
  ``finally`` release) while an allocation is unreleased.
* HL402 ``unpublished-alloc``: function exit with an allocation that was
  never published or released.

Branches union their effects (may-leak); loop bodies run twice for
loop-carried state; a ``try`` whose handler/finally contains a
release-family call protects its body.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import List, Optional, Set

from repro_torch.analysis.core import (Finding, PassContext, dotted_name,
                                 qualname_map)

RULES = {
    "HL401": "pool allocation may leak on an exception path "
             "(release in a finally/handler, or allocate later)",
    "HL402": "pool allocation never published or released on some path",
}

ALLOC_METHODS = {"alloc", "alloc_pages", "fork", "adopt_prefix"}
RELEASE_METHODS = {"free_seq", "truncate_seq", "release", "free",
                   "release_seq", "drop"}


@dataclass
class _Alloc:
    root: Optional[str]     # root Name of the seq-id argument
    line: int
    col: int
    method: str
    published: bool = False


def _call_method(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            return sub.id
    return None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _Interp:
    def __init__(self, path: str, qual: str):
        self.path = path
        self.qual = qual
        self.live: List[_Alloc] = []
        self.findings: List[Finding] = []
        self.protected = 0      # depth of trys with releasing handlers

    # ------------------------------------------------------------------
    def _allocs_in(self, node: ast.AST) -> List[_Alloc]:
        out = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) \
                    and _call_method(sub) in ALLOC_METHODS \
                    and isinstance(sub.func.value, (ast.Attribute,
                                                    ast.Name)):
                # require a pool-ish receiver: x.alloc_pages / self.pool.*
                recv = dotted_name(sub.func.value)
                if not recv:
                    continue
                root = _root_name(sub.args[0]) if sub.args else None
                out.append(_Alloc(root, sub.lineno, sub.col_offset,
                                  _call_method(sub)))
        return out

    def _releases_in(self, node: ast.AST) -> List[Optional[str]]:
        out = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) \
                    and _call_method(sub) in RELEASE_METHODS \
                    and isinstance(sub.func, ast.Attribute) \
                    and isinstance(sub.func.value, (ast.Attribute,
                                                    ast.Name)):
                out.append(_root_name(sub.args[0]) if sub.args else None)
        return out

    def _apply_releases(self, roots: List[Optional[str]]) -> None:
        for r in roots:
            if r is None:
                self.live.clear()       # conservative: releases all
            else:
                self.live = [a for a in self.live
                             if a.root is not None and a.root != r]

    def _publish(self, names: Set[str], publish_all: bool = False) -> None:
        for a in self.live:
            if publish_all or (a.root is not None and a.root in names):
                a.published = True

    # ------------------------------------------------------------------
    def _emit(self, rule: str, a: _Alloc, why: str) -> None:
        self.findings.append(Finding(
            rule, self.path, a.line, a.col,
            f"{a.method}() {why}", self.qual))

    def exec_body(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self.exec_stmt(stmt)

    def exec_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.Raise):
            if self.protected == 0:
                for a in self.live:
                    self._emit("HL401", a,
                               "may leak: raise reached while the "
                               "allocation is unreleased and no "
                               "handler/finally releases it")
            self.live = []      # path ends here
            return
        if isinstance(stmt, (ast.Return,)):
            if stmt.value is not None:
                names = _names_in(stmt.value)
                has_alloc_call = any(True for _ in self._allocs_in(
                    stmt.value))
                self._publish(names, publish_all=has_alloc_call)
                # `return self.alloc_pages(...)`: hands pages straight
                # to the caller — published by construction
            self._finish_path()
            self.live = []
            return
        if isinstance(stmt, ast.Try):
            releasing = any(self._releases_in(h) for h in stmt.handlers) \
                or bool(self._releases_in(ast.Module(
                    body=stmt.finalbody, type_ignores=[])))
            if releasing:
                self.protected += 1
            self.exec_body(stmt.body)
            if releasing:
                self.protected -= 1
            for h in stmt.handlers:
                self.exec_body(h.body)
            self.exec_body(stmt.orelse)
            self.exec_body(stmt.finalbody)
            if releasing:
                # handler/finally released on the exception edge; treat
                # the same roots as released on the fallthrough too
                rel = []
                for h in stmt.handlers:
                    rel.extend(self._releases_in(h))
                rel.extend(self._releases_in(ast.Module(
                    body=stmt.finalbody, type_ignores=[])))
                self._apply_releases(rel)
            return
        if isinstance(stmt, ast.If):
            saved = [_Alloc(a.root, a.line, a.col, a.method, a.published)
                     for a in self.live]
            self.exec_body(stmt.body)
            then_live = self.live
            self.live = saved
            self.exec_body(stmt.orelse)
            # union of may-live allocations from both branches
            seen = {(a.line, a.col) for a in self.live}
            for a in then_live:
                if (a.line, a.col) not in seen:
                    self.live.append(a)
            return
        if isinstance(stmt, (ast.For, ast.While)):
            for _ in range(2):
                self.exec_body(stmt.body)
            self.exec_body(stmt.orelse)
            return
        if isinstance(stmt, ast.With):
            self.exec_body(stmt.body)
            return

        # --- straight-line statement: releases, allocs, publications ---
        self._apply_releases(self._releases_in(stmt))
        new_allocs = self._allocs_in(stmt)

        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
            value = stmt.value
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
            value = stmt.value
        else:
            targets, value = [], getattr(stmt, "value", None)

        # an alloc whose result is bound (t = pool.alloc(...)) publishes
        # when that binding later escapes; binding to a plain local is
        # not yet publication — but storing into self.x / d[k] is.
        for a in new_allocs:
            # double-alloc for the same root without release in between
            for prev in self.live:
                if prev.root is not None and prev.root == a.root \
                        and not prev.published:
                    self._emit("HL402", prev,
                               "overlapping allocation for the same "
                               "sequence id without an intervening "
                               "release")
            self.live.append(a)

        store_names: Set[str] = set()
        publish_all = False
        for t in targets:
            if isinstance(t, (ast.Attribute, ast.Subscript)):
                store_names |= _names_in(t)
                if value is not None and new_allocs \
                        and any(id(c) in {id(x) for x in ast.walk(value)}
                                for c in [value]):
                    publish_all = True      # self.t[...] = pool.alloc(...)
                if value is not None:
                    store_names |= _names_in(value)
        # method calls that stash the table: x.append(t) / x.extend(...)
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in ("append", "extend", "add",
                                          "update", "setdefault"):
                for arg in sub.args:
                    store_names |= _names_in(arg)
        if store_names or publish_all:
            self._publish(store_names, publish_all=publish_all)

    def _finish_path(self) -> None:
        for a in self.live:
            if not a.published:
                self._emit("HL402", a,
                           "result never published (stored/returned) or "
                           "released before function exit")

    def finish(self) -> None:
        self._finish_path()


def run(tree: ast.AST, src: str, path: str, ctx: PassContext) -> List[Finding]:
    if not (ctx.enabled("HL401") or ctx.enabled("HL402")):
        return []
    if not any(m in src for m in ALLOC_METHODS):
        return []
    findings: List[Finding] = []
    for node, qual in qualname_map(tree).items():
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        interp = _Interp(path, qual)
        interp.exec_body(node.body)
        interp.finish()
        findings.extend(f for f in interp.findings if ctx.enabled(f.rule))
    # loops run bodies twice; If-union can duplicate — dedupe
    seen, out = set(), []
    for f in findings:
        k = (f.rule, f.path, f.line, f.col, f.message)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out
