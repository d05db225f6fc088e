"""HL2xx — device-to-host syncs in the port's hot paths.

The reference's pass (``repro/analysis/host_sync.py``) over PyTorch.  A
device tensor pulled to the host blocks the tick loop until the card has
caught up.  The port's engine has the reference's deliberate pulls (the
tick's commit, the draft proposer's), and each carries
``# hornlint: sync-ok``; any other pull is a leak.

Analysis: per-function forward taint.  Sources taint names bound from

* calls through the device-step attributes (``self._step``,
  ``self._page_copy``) and curried steps (``self._step_for(k)(...)``);
* ``torch.*`` calls that make a tensor on a device: a ``device=`` other
  than the literal ``"cpu"``, or any tainted argument (``torch.stack``
  over device tensors); ``torch.cuda.*`` and the metadata helpers below
  are host values;
* methods of a tainted tensor (``x.long()``, ``x.sum()``), and uploads of
  a host one (``x.to(device)``, ``x.cuda()``),

propagated through assignments, tuple unpacking, arithmetic, subscripts and
unresolved calls that receive a tainted argument.  Taint dies on rebinding
from an untainted expression and on metadata reads (shape, dtype, device,
``data_ptr()``, ``size()``: no sync).  Sinks:

* HL201 ``sync-host-pull``: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.to("cpu")``, ``np.asarray``/``np.array``/``float``/
  ``int``/``bool`` over a tainted tensor, ``torch.cuda.synchronize()`` and
  ``.synchronize()``, an ``if``/``while``/conditional expression whose test
  is a tainted tensor (its implicit ``bool``), and a store of a tainted
  value into a subscript of a numpy array made in the function.
* HL202 ``sync-in-loop``: the same sink lexically inside a for/while.

The rule covers device-to-host pulls, as the reference's does; a host to
device copy (``serving/block_table.py::marshal_i32``) is not a sink.

Scope: only functions in the hot-scope list below (the port's tick path)
or marked ``# hornlint: hot-path`` on the ``def`` line are analysed;
set-up, reporting and the CLIs (``launch/``) pull results freely.
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.core import (Finding, PassContext, dotted_name,
                                       qualname_map)

RULES = {
    "HL201": "host pull of a device value in a hot path "
             "(annotate deliberate syncs with '# hornlint: sync-ok')",
    "HL202": "host pull of a device value inside a loop in a hot path",
}

# (path suffix, qualname prefixes): the port's methods on the tick path
HOT_SCOPES = (
    ("serving/engine.py",
     ("Engine.step", "Engine._commit_spec", "Engine._flush_copies",
      "Engine._plan_tick", "Engine._try_plan", "Engine._prepare_entry_write",
      "Engine._sync_block_tables", "Engine._sample_peak")),
    ("serving/speculative.py",
     ("DraftRunner.propose", "DraftRunner.commit", "DraftRunner.drop")),
    ("serving/block_table.py", ("BlockTableMirror.sync",)),
)

DEVICE_CALL_ATTRS = {"_step", "_page_copy", "_draft_step"}
CURRIED_STEP_ATTRS = {"_step_for"}
# torch helpers whose results are host values (or are the sink)
_TORCH_HOST = {"torch.Size", "torch.dtype", "torch.device", "torch.finfo",
               "torch.iinfo", "torch.no_grad", "torch.inference_mode",
               "torch.is_tensor", "torch.is_floating_point",
               "torch.get_default_dtype", "torch.Generator",
               "torch.manual_seed", "torch.from_numpy"}
_SINK_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
               "float", "int", "bool"}
_SINK_METHODS = {"item", "tolist", "cpu", "numpy", "__array__"}
_SYNC_CALLS = {"torch.cuda.synchronize"}
_SYNC_METHODS = {"synchronize"}
_UPLOAD_METHODS = {"cuda"}
_TAINT_KILL_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                     "data_ptr", "numel", "dim", "stride", "is_contiguous",
                     "element_size", "requires_grad", "nbytes"}
_HOST_BUILTINS = {"len", "isinstance", "type", "range", "enumerate", "zip",
                  "min", "max", "sorted", "str", "repr", "id", "hash"}


def _is_hot(path: str, qualname: str) -> bool:
    for suffix, prefixes in HOT_SCOPES:
        if path.endswith(suffix):
            return any(qualname == p or qualname.startswith(p + ".")
                       for p in prefixes)
    return False


def _is_cpu(node: ast.AST) -> bool:
    """A literal CPU device: ``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and dotted_name(node.func) == \
            "torch.device" and node.args:
        return _is_cpu(node.args[0])
    return False


def _to_target(call: ast.Call):
    """The device argument of ``x.to(...)``, or None."""
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    if call.args and not (isinstance(call.args[0], ast.Attribute)
                          and dotted_name(call.args[0]).startswith("torch.")
                          and not _is_cpu(call.args[0])):
        return call.args[0]
    return None


class _Taint(ast.NodeVisitor):
    """Single forward pass over one function body, statement order."""

    def __init__(self, path: str, qualname: str):
        self.path = path
        self.qualname = qualname
        self.tainted: Set[str] = set()
        self.host_arrays: Set[str] = set()
        self.findings: List[Finding] = []
        self.loop_depth = 0

    # ---------------- expression taint ----------------
    def is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _TAINT_KILL_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or self.is_tainted(node.orelse)
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            return self._call_taints(node)
        if isinstance(node, ast.Compare):
            # a comparison of device tensors is a device bool tensor;
            # identity and membership tests are host values
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.is_tainted(node.left) or any(
                self.is_tainted(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tainted(v) for v in node.values)
        return False

    def _call_taints(self, call: ast.Call) -> bool:
        name = dotted_name(call.func)
        # a sink's result lives on the host: the pull is flagged where it
        # happens, downstream use of the result is free
        if name in _SINK_CALLS or name in _SYNC_CALLS:
            return False
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr in DEVICE_CALL_ATTRS:
            return True
        if isinstance(func, ast.Call) and isinstance(func.func,
                                                     ast.Attribute) \
                and func.func.attr in CURRIED_STEP_ATTRS:
            return True
        args = list(call.args) + [k.value for k in call.keywords]
        if name.startswith("torch."):
            if name.startswith("torch.cuda.") or name in _TORCH_HOST:
                return False
            dev = [k.value for k in call.keywords if k.arg == "device"]
            if dev and not _is_cpu(dev[0]):
                return True
            return any(self.is_tainted(a) for a in args)
        if name in _HOST_BUILTINS:
            return False
        if isinstance(func, ast.Attribute):
            if func.attr in _SINK_METHODS or func.attr in _TAINT_KILL_ATTRS:
                return False
            if func.attr == "to":
                target = _to_target(call)
                if target is not None and _is_cpu(target):
                    return False
                if target is not None:
                    return True          # an upload, or a device move
            if func.attr in _UPLOAD_METHODS:
                return True
            # a method of a device tensor stays on the device
            if self.is_tainted(func.value):
                return True
        # unresolved call: conservatively tainted if any argument is
        return any(self.is_tainted(a) for a in args)

    # ---------------- sinks ----------------
    def _emit(self, node: ast.AST, what: str) -> None:
        rule = "HL202" if self.loop_depth else "HL201"
        msg = (f"{what} forces a device->host sync"
               + (" every loop iteration" if self.loop_depth else ""))
        self.findings.append(Finding(rule, self.path, node.lineno,
                                     node.col_offset, msg, self.qualname))

    def _check_sink(self, call: ast.Call) -> None:
        name = dotted_name(call.func)
        func = call.func
        if name in _SINK_CALLS and call.args \
                and self.is_tainted(call.args[0]):
            self._emit(call, f"{name}() on a device value")
        elif name in _SYNC_CALLS:
            self._emit(call, f"{name}()")
        elif isinstance(func, ast.Attribute):
            if func.attr in _SYNC_METHODS and name not in _SYNC_CALLS:
                self._emit(call, f".{func.attr}()")
            elif func.attr in _SINK_METHODS \
                    and self.is_tainted(func.value):
                self._emit(call, f".{func.attr}() on a device value")
            elif func.attr == "to" and self.is_tainted(func.value):
                target = _to_target(call)
                if target is not None and _is_cpu(target):
                    self._emit(call, ".to('cpu') on a device value")

    def _check_test(self, test: ast.AST) -> None:
        if self.is_tainted(test):
            self._emit(test, "the truth value of a device tensor")

    def visit_Call(self, node: ast.Call) -> None:
        self._check_sink(node)
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        self.visit(node.test)
        self._check_test(node.test)
        # each branch from the state before the if; after it a name is
        # tainted if either branch left it so (may-taint)
        before = (set(self.tainted), set(self.host_arrays))
        for stmt in node.body:
            self.visit(stmt)
        after_body = (self.tainted, self.host_arrays)
        self.tainted, self.host_arrays = before
        for stmt in node.orelse:
            self.visit(stmt)
        self.tainted |= after_body[0]
        self.host_arrays |= after_body[1]

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_test(node.test)
        self.generic_visit(node)

    # ---------------- statements / binding ----------------
    def _bind(self, target: ast.AST, tainted: bool,
              value: ast.AST = None) -> None:
        if isinstance(target, ast.Name):
            (self.tainted.add if tainted
             else self.tainted.discard)(target.id)
            host = isinstance(value, ast.Call) and dotted_name(
                value.func).split(".")[0] in ("np", "numpy")
            (self.host_arrays.add if host
             else self.host_arrays.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, tainted)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted)
        elif isinstance(target, ast.Subscript):
            # storing a device value into a numpy array pulls it
            root = target.value
            while isinstance(root, ast.Subscript):
                root = root.value
            if tainted and isinstance(root, ast.Name) \
                    and root.id in self.host_arrays:
                self._emit(target, "store of a device value into a host "
                                   "array slice")

    def visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)
        t = self.is_tainted(node.value)
        for tgt in node.targets:
            if isinstance(tgt, (ast.Tuple, ast.List)) \
                    and isinstance(node.value, (ast.Tuple, ast.List)) \
                    and len(tgt.elts) == len(node.value.elts):
                for e, v in zip(tgt.elts, node.value.elts):
                    self._bind(e, self.is_tainted(v), v)
            else:
                self._bind(tgt, t, node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.visit(node.value)
        if self.is_tainted(node.value):
            self._bind(node.target, True)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
            self._bind(node.target, self.is_tainted(node.value), node.value)

    def visit_For(self, node: ast.For) -> None:
        self.visit(node.iter)
        self._bind(node.target, self.is_tainted(node.iter))
        self.loop_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        self.loop_depth -= 1
        for stmt in node.orelse:
            self.visit(stmt)

    def visit_While(self, node: ast.While) -> None:
        self.visit(node.test)
        self.loop_depth += 1
        self._check_test(node.test)
        for stmt in node.body:
            self.visit(stmt)
        self.loop_depth -= 1
        for stmt in node.orelse:
            self.visit(stmt)

    # nested defs/lambdas get their own scope decision — skip here
    def visit_FunctionDef(self, node): pass
    def visit_AsyncFunctionDef(self, node): pass
    def visit_Lambda(self, node): pass


def run(tree: ast.AST, src: str, path: str, ctx: PassContext) -> List[Finding]:
    if not (ctx.enabled("HL201") or ctx.enabled("HL202")):
        return []
    # benchmarks and the CLIs pull results on purpose (reporting): the
    # rules only apply on the serving tick path, even where a def there
    # carries a hot-path marker
    norm = path.replace("\\", "/")
    if "benchmarks/" in norm or "repro_torch/launch/" in norm:
        return []
    findings: List[Finding] = []
    for node, qual in qualname_map(tree).items():
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        marked = any(ln in ctx.suppressions.hot_path
                     for ln in range(node.lineno,
                                     node.body[0].lineno + 1))
        if not (marked or _is_hot(path, qual)):
            continue
        t = _Taint(path, qual)
        for stmt in node.body:
            t.visit(stmt)
        findings.extend(f for f in t.findings if ctx.enabled(f.rule))
    return findings
