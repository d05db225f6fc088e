"""HL101 — tensor work at module import time.

The reference's HL101 flags ``jnp.*`` work at import, which traces and
may allocate on a device before the program configures its backends.
The port's counterpart: a ``torch.*`` call run when a module is imported
(at module level, in a class body, or in a decorator or default argument
of a ``def``) builds a tensor, or touches a device, before the program
has chosen one; and the tests, which import every module on a machine
with no card, would build it too.  A module keeps such work inside a
function.  Calls that build no tensor (dtypes, devices, ``finfo``, the
grad-mode decorators) are allowed.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.core import Finding, PassContext, dotted_name

RULES = {
    "HL101": "torch tensor built at import time (move it into a function)",
}

ALLOW = {"torch.dtype", "torch.device", "torch.finfo", "torch.iinfo",
         "torch.Size", "torch.get_default_dtype", "torch.promote_types",
         "torch.cuda.is_available", "torch.cuda.device_count",
         # grad-mode decorators
         "torch.no_grad", "torch.enable_grad", "torch.inference_mode",
         "torch.set_grad_enabled"}


def _import_time_nodes(stmts):
    """The AST nodes a module's import evaluates: statements outside
    functions (class bodies included) and each def's decorators and
    defaults."""
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield from stmt.decorator_list
            yield from stmt.args.defaults
            yield from (d for d in stmt.args.kw_defaults if d is not None)
        elif isinstance(stmt, ast.ClassDef):
            yield from stmt.decorator_list
            yield from _import_time_nodes(stmt.body)
        elif isinstance(stmt, (ast.If, ast.Try, ast.With, ast.For,
                               ast.While)):
            for field in ("test", "iter", "items"):
                if getattr(stmt, field, None) is not None:
                    yield getattr(stmt, field)
            for field in ("body", "orelse", "finalbody"):
                yield from _import_time_nodes(getattr(stmt, field, []))
            for h in getattr(stmt, "handlers", []):
                yield from _import_time_nodes(h.body)
        else:
            yield stmt


def run(tree: ast.AST, src: str, path: str,
        ctx: PassContext) -> List[Finding]:
    if not ctx.enabled("HL101"):
        return []
    findings = []
    for top in _import_time_nodes(tree.body):
        if isinstance(top, list):       # a with statement's items
            continue
        for node in ast.walk(top):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                if name.startswith("torch.") and name not in ALLOW:
                    findings.append(Finding(
                        "HL101", path, node.lineno, node.col_offset,
                        f"{name}() at import time builds a tensor before "
                        f"the program has chosen its device"))
    return findings
