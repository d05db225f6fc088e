"""HL5xx — the mesh's contracts: mesh-dim names, logical axis names,
placements and collectives' groups on the port's ``DeviceMesh``.

The bug class is the reference's: ``ShardingCtx.spec``
(``launch/mesh.py``) maps a logical name it does not know to None, and a
``DeviceMesh`` indexed by a name it lacks fails only when that line runs,
so a misspelled axis quietly leaves a tensor unsharded or a path broken
on the meshes a test does not build.  These rules pin the statically
checkable parts:

* HL501 ``placements-arity``: a literal placements tuple or list given to
  ``DTensor.from_local``, ``distribute_tensor`` or ``.redistribute`` must
  have one entry a mesh dim where the mesh is literal (a name bound in
  the file to ``DeviceMesh(..., mesh_dim_names=...)``,
  ``init_device_mesh``, ``make_test_mesh`` or ``make_production_mesh``
  with a literal ``multi_pod``).  The reference's rule checks a
  ``shard_map``'s ``in_specs`` against the wrapped function's signature;
  the port has no ``shard_map`` (every rank runs the whole step), and the
  count that can go wrong is placements against mesh dims.
* HL502 ``mesh-axis-name``: a string-literal mesh-dim name, in
  ``mesh.get_group("...")`` or ``mesh["..."]``, must be in the mesh
  vocabulary: the dim names of ``launch/mesh.py``'s meshes under the lint
  root and of the meshes built in the linted file (fallback ``pod``,
  ``data``, ``model``).  A literal logical name given to ``.spec``,
  ``.placements``, ``.sharding`` or ``.constrain`` must be a key of
  ``sharding_rules`` (``launch/mesh.py``, or one the linted file defines).
* HL503 ``placement-rank``: a literal ``Shard(d)`` in such a placements
  tuple, or a literal ``.placements(...)`` call's entries, must not
  exceed the rank of the tensor they lay out where the file builds it
  with a literal shape (``torch.zeros((2, 3))``, ``torch.randn(2, 3)``).
* HL504 ``collective-group-name``: a collective (``dist.all_reduce``,
  ``all_gather*``, ``reduce_scatter*``, ``broadcast``, ``all_to_all*``,
  the functional ``funcol.*`` ones) given a literal mesh-dim group name
  (``group=mesh.get_group("...")``, ``(mesh, "...")`` or the name
  itself) must name a dim of the vocabulary.  The reference also requires
  a literal-axis collective to sit inside a ``shard_map``-wrapped
  function; a torch collective takes its group at any call site, so that
  half has no counterpart.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set

from repro_torch.analysis.core import (Finding, PassContext, dotted_name,
                                       enclosing_function_ranges,
                                       qualname_at)

RULES = {
    "HL501": "a literal placements tuple must have one entry a mesh dim",
    "HL502": "mesh-dim or logical axis name must exist in the mesh rules",
    "HL503": "placements must not exceed the rank of the tensor",
    "HL504": "collective group name must be a dim of the mesh",
}

_DEFAULT_AXES = {"pod", "data", "model"}
_MESH_CTORS = {"DeviceMesh", "init_device_mesh", "_mesh"}
_LOGICAL = {"spec", "placements", "sharding", "constrain"}
_PLACEMENT_CALLS = {"from_local": (1, 2), "distribute_tensor": (1, 2),
                    "redistribute": (0, 1)}       # (mesh, placements) index
_PLACEMENTS = {"Shard", "Replicate", "Partial"}
_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                "all_gather_tensor", "reduce_scatter",
                "reduce_scatter_tensor", "broadcast", "all_to_all",
                "all_to_all_single", "all_reduce_coalesced"}
_TENSOR_CTORS = {"zeros", "ones", "empty", "full", "rand", "randn",
                 "randint"}

_cache: Dict[str, tuple] = {}


def _strings(node) -> List[str]:
    """The string literals of a tuple/list (all of them, else [])."""
    if isinstance(node, (ast.Tuple, ast.List)) and node.elts and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in node.elts):
        return [e.value for e in node.elts]
    return []


def _assigns(tree) -> Dict[str, ast.AST]:
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node.value
    return out


def _mesh_dims(tree) -> Set[str]:
    """Mesh-dim names of every mesh construction in a module, through one
    name or conditional indirection."""
    consts = _assigns(tree)
    dims: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                dotted_name(node.func).split(".")[-1] in _MESH_CTORS:
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(arg, ast.Name):
                    arg = consts.get(arg.id, arg)
                for sub in ast.walk(arg):
                    dims.update(_strings(sub))
    return dims


def _logical_names(tree) -> Set[str]:
    """The keys of ``sharding_rules``' rules dict in a module: the dict
    literal's string keys and every ``rules["..."] = `` after it."""
    names: Set[str] = set()
    for fn in ast.walk(tree):
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name == "sharding_rules"):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                names.update(k.value for k in node.keys
                             if isinstance(k, ast.Constant)
                             and isinstance(k.value, str))
            elif isinstance(node, ast.Subscript) and isinstance(
                    node.ctx, ast.Store) and isinstance(
                    node.slice, ast.Constant) and isinstance(
                    node.slice.value, str):
                names.add(node.slice.value)
    return names


def _vocabulary(tree, ctx: PassContext):
    """(mesh dims, logical names or None when no rules are known)."""
    mesh_py = Path(ctx.root) / "src" / "repro_torch" / "launch" / "mesh.py"
    key = str(mesh_py)
    if key not in _cache:
        try:
            mt = ast.parse(mesh_py.read_text())
            _cache[key] = (_mesh_dims(mt), _logical_names(mt))
        except (OSError, SyntaxError):
            _cache[key] = (set(), set())
    dims, logical = _cache[key]
    logical = logical | _logical_names(tree)
    return _DEFAULT_AXES | dims | _mesh_dims(tree), logical or None


def _mesh_ndims(tree) -> Dict[str, int]:
    """{name: number of dims} of meshes the file binds with a literal
    shape of dims."""
    out = {}
    for name, value in _assigns(tree).items():
        if not isinstance(value, ast.Call):
            continue
        tail = dotted_name(value.func).split(".")[-1]
        kw = {k.arg: k.value for k in value.keywords}
        if tail in ("DeviceMesh", "init_device_mesh"):
            names = _strings(kw.get("mesh_dim_names"))
            if names:
                out[name] = len(names)
        elif tail == "make_test_mesh":
            out[name] = 2
        elif tail == "make_production_mesh":
            mp = kw.get("multi_pod")
            if mp is None:
                out[name] = 2
            elif isinstance(mp, ast.Constant) and isinstance(mp.value,
                                                             bool):
                out[name] = 3 if mp.value else 2
    return out


def _ranks(tree) -> Dict[str, int]:
    """{name: rank} of tensors the file builds with a literal shape."""
    out = {}
    for name, value in _assigns(tree).items():
        if not isinstance(value, ast.Call):
            continue
        d = dotted_name(value.func)
        if not d.startswith("torch.") or d.split(".")[-1] not in \
                _TENSOR_CTORS:
            continue
        args = value.args[1:] if d.endswith(("full", "randint")) \
            else value.args
        if d.endswith("randint"):
            args = [a for a in args if isinstance(a, (ast.Tuple, ast.List))]
        if len(args) == 1 and isinstance(args[0], (ast.Tuple, ast.List)):
            out[name] = len(args[0].elts)
        elif args and all(isinstance(a, ast.Constant)
                          and isinstance(a.value, int) for a in args):
            out[name] = len(args)
    return out


def _arg(call: ast.Call, index: int, kw: str):
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    return call.args[index] if index < len(call.args) else None


def _group_literal(node) -> Optional[ast.Constant]:
    """The literal mesh-dim name a group argument names, if any."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get_group" and node.args \
            and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0]
    if isinstance(node, ast.Tuple) and len(node.elts) == 2 \
            and isinstance(node.elts[1], ast.Constant) \
            and isinstance(node.elts[1].value, str):
        return node.elts[1]
    return None


def run(tree: ast.AST, src: str, path: str,
        ctx: PassContext) -> List[Finding]:
    dims, logical = _vocabulary(tree, ctx)
    ndims, ranks = _mesh_ndims(tree), _ranks(tree)
    ranges = enclosing_function_ranges(tree)
    findings: List[Finding] = []
    reported: Set[int] = set()          # literals already in an HL504

    def add(rule, node, msg):
        if ctx.enabled(rule):
            findings.append(Finding(rule, path, node.lineno,
                                    node.col_offset, msg,
                                    qualname_at(ranges, node.lineno)))

    def check_dim(rule, lit, where):
        if lit.value not in dims:
            add(rule, lit, f"{where} names mesh dim {lit.value!r}, not in "
                           f"the mesh's dims {sorted(dims)}")

    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    for node in calls:                  # HL504 first: it owns its literals
        tail = dotted_name(node.func).split(".")[-1]
        if tail not in _COLLECTIVES:
            continue
        group = _arg(node, 2 if dotted_name(node.func).startswith(
            ("funcol.", "_functional_collectives.")) else 99, "group")
        lit = _group_literal(group)
        if lit is not None:
            reported.add(id(lit))
            check_dim("HL504", lit, f"{tail}'s group")

    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and isinstance(
                node.slice, ast.Constant) and isinstance(
                node.slice.value, str) and dotted_name(
                node.value).split(".")[-1].endswith("mesh"):
            check_dim("HL502", node.slice, "a mesh index")
    for node in calls:
        if not isinstance(node.func, ast.Attribute):
            continue
        attr = node.func.attr
        if attr == "get_group" and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str) and id(node.args[0]) not in reported:
            check_dim("HL502", node.args[0], "get_group")
        elif attr in _LOGICAL and logical is not None:
            args = node.args[1:] if attr == "constrain" else node.args
            for a in args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                        and a.value not in logical:
                    add("HL502", a, f".{attr}() names logical axis "
                                    f"{a.value!r}, not a key of "
                                    f"sharding_rules (it would map to None: "
                                    f"unsharded)")

    for node in calls:                  # HL501 / HL503
        tail = dotted_name(node.func).split(".")[-1]
        if tail not in _PLACEMENT_CALLS:
            continue
        mi, pi = _PLACEMENT_CALLS[tail]
        mesh = _arg(node, mi, "device_mesh")
        pl = _arg(node, pi, "placements")
        tensor = node.func.value if tail == "redistribute" else (
            node.args[0] if node.args else None)
        rank = ranks.get(tensor.id) if isinstance(tensor, ast.Name) \
            else None
        if isinstance(pl, (ast.Tuple, ast.List)):
            n = ndims.get(mesh.id) if isinstance(mesh, ast.Name) else None
            if n is not None and len(pl.elts) != n:
                add("HL501", pl, f"{tail}: {len(pl.elts)} placements for a "
                                 f"mesh of {n} dims")
            for e in pl.elts:
                if rank is not None and isinstance(e, ast.Call) \
                        and dotted_name(e.func).split(".")[-1] == "Shard" \
                        and e.args and isinstance(e.args[0], ast.Constant) \
                        and isinstance(e.args[0].value, int) \
                        and e.args[0].value >= rank:
                    add("HL503", e, f"{tail}: Shard({e.args[0].value}) of "
                                    f"a tensor of rank {rank}")
        elif isinstance(pl, ast.Call) and isinstance(pl.func, ast.Attribute) \
                and pl.func.attr == "placements" and rank is not None \
                and not any(isinstance(a, ast.Starred) for a in pl.args) \
                and len(pl.args) > rank:
            add("HL503", pl, f"{tail}: placements of {len(pl.args)} axes "
                             f"for a tensor of rank {rank}")
    return findings
