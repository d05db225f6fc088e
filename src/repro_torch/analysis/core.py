"""hornlint core for the port: findings, suppression comments, baselines,
file walking.

A copy of the reference's ``repro/analysis/core.py`` (pure ``ast``; the
port imports nothing of ``repro``), with the pass list cut to the two
families that carry over to a PyTorch package: host sync (HL2xx) and pool
lifetime (HL4xx).  Findings, suppressions, fingerprints and baselines are
the reference's, so a finding fingerprints exactly as the reference's does.

A *pass* is a module exposing ``RULES`` (rule id -> one-line description)
and ``run(tree, src, path, ctx) -> list[Finding]``.  Passes are pure AST
analyses — nothing here imports torch, so the linter runs anywhere.

Suppression comments (matched per physical line):

* ``# hornlint: sync-ok``        — suppresses HL2xx (host-sync) findings
  on that line; the annotation for *deliberate* tick-forcing syncs.
* ``# hornlint: ignore``         — suppresses every rule on that line.
* ``# hornlint: ignore[HLnnn]``  — suppresses the listed rules only.
* ``# hornlint: hot-path``       — on a ``def`` line: opt the function in
  to host-sync analysis (in addition to the built-in hot-scope list).

Baselines: a committed JSON file of finding fingerprints.  The CLI exits
nonzero only for findings whose fingerprint is absent from the baseline,
so pre-existing debt is tracked without blocking CI, and fixed entries
are reported so the baseline can be re-tightened.
"""
from __future__ import annotations

import ast
import hashlib
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

_SUPPRESS_RE = re.compile(
    r"#\s*hornlint:\s*(sync-ok|ignore(?:\[(?P<rules>[^\]]+)\])?|hot-path)")

SYNC_FAMILY_PREFIX = "HL2"


@dataclass(frozen=True)
class Finding:
    rule: str           # e.g. "HL201"
    path: str           # repo-relative posix path
    line: int
    col: int
    message: str
    qualname: str = ""  # enclosing function qualname, "" at module level

    @property
    def fingerprint(self) -> str:
        # Deliberately line-number-free so unrelated edits above a known
        # finding don't churn the baseline; qualname + message pin it.
        raw = "|".join((self.rule, self.path, self.qualname, self.message))
        return hashlib.blake2b(raw.encode(), digest_size=8).hexdigest()

    def render(self) -> str:
        where = f"{self.path}:{self.line}:{self.col}"
        fn = f" [{self.qualname}]" if self.qualname else ""
        return f"{where}: {self.rule}{fn} {self.message}"


class Suppressions:
    """Per-file map of line -> suppression kind parsed from comments."""

    def __init__(self, src: str):
        self.sync_ok: set = set()
        self.ignore_all: set = set()
        self.ignore_rules: Dict[int, set] = {}
        self.hot_path: set = set()
        for i, text in enumerate(src.splitlines(), start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            kind = m.group(1)
            if kind == "sync-ok":
                self.sync_ok.add(i)
            elif kind == "hot-path":
                self.hot_path.add(i)
            elif kind.startswith("ignore"):
                rules = m.group("rules")
                if rules:
                    self.ignore_rules.setdefault(i, set()).update(
                        r.strip() for r in rules.split(","))
                else:
                    self.ignore_all.add(i)

    def suppressed(self, f: Finding) -> bool:
        if f.line in self.ignore_all:
            return True
        if f.rule in self.ignore_rules.get(f.line, ()):
            return True
        if f.line in self.sync_ok and f.rule.startswith(SYNC_FAMILY_PREFIX):
            return True
        return False


@dataclass
class PassContext:
    """Shared per-file state handed to every pass."""
    root: Path                       # path findings are reported relative to
    suppressions: Suppressions = None
    rules: Optional[set] = None      # None = all rules enabled

    def enabled(self, rule: str) -> bool:
        return self.rules is None or rule in self.rules


# --------------------------------------------------------------------------
# shared AST helpers used by several passes
# --------------------------------------------------------------------------
def dotted_name(node: ast.AST) -> str:
    """'jnp.asarray' for Attribute/Name chains, '' for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def qualname_map(tree: ast.AST) -> Dict[ast.AST, str]:
    """Map every FunctionDef/AsyncFunctionDef/Lambda to its qualname."""
    out: Dict[ast.AST, str] = {}

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out[child] = q
                visit(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            else:
                if isinstance(child, ast.Lambda):
                    out[child] = f"{prefix}<lambda>"
                visit(child, prefix)

    visit(tree, "")
    return out


# --------------------------------------------------------------------------
# linting files and sources
# --------------------------------------------------------------------------
def _passes():
    # Imported lazily so `import repro_torch.analysis.core` never cycles.
    from repro_torch.analysis import host_sync, pool_lifetime
    return (host_sync, pool_lifetime)


def all_rules() -> Dict[str, str]:
    out: Dict[str, str] = {}
    for p in _passes():
        out.update(p.RULES)
    return dict(sorted(out.items()))


def lint_source(src: str, path: str = "<string>",
                root: Optional[Path] = None,
                rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint one source string.  The API tests drive; the CLI wraps this."""
    ctx = PassContext(root=root or Path("."),
                      rules=set(rules) if rules is not None else None)
    ctx.suppressions = Suppressions(src)
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("HL000", path, e.lineno or 1, e.offset or 0,
                        f"syntax error: {e.msg}")]
    findings: List[Finding] = []
    for p in _passes():
        findings.extend(p.run(tree, src, path, ctx))
    findings = [f for f in findings if not ctx.suppressions.suppressed(f)]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_py_files(paths: Sequence[Path]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    return files


def lint_paths(paths: Sequence[Path], root: Optional[Path] = None,
               rules: Optional[Iterable[str]] = None) -> List[Finding]:
    root = (root or Path.cwd()).resolve()
    findings: List[Finding] = []
    for f in iter_py_files([Path(p) for p in paths]):
        try:
            rel = f.resolve().relative_to(root).as_posix()
        except ValueError:
            rel = f.as_posix()
        src = f.read_text()
        findings.extend(lint_source(src, rel, root=root, rules=rules))
    # interprocedural passes can surface one defect from several entry
    # files — keep the first sighting only
    seen, out = set(), []
    for f in findings:
        k = (f.rule, f.path, f.line, f.col, f.message)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


# --------------------------------------------------------------------------
# baseline
# --------------------------------------------------------------------------
BASELINE_VERSION = 1


def write_baseline(findings: Sequence[Finding], path: Path) -> None:
    doc = {
        "version": BASELINE_VERSION,
        "findings": [
            {"fingerprint": f.fingerprint, "rule": f.rule, "path": f.path,
             "qualname": f.qualname, "message": f.message}
            for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))
        ],
    }
    path.write_text(json.dumps(doc, indent=2) + "\n")


def load_baseline(path: Path) -> Dict[str, dict]:
    doc = json.loads(path.read_text())
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version: {doc.get('version')}")
    return {e["fingerprint"]: e for e in doc.get("findings", [])}


def diff_baseline(findings: Sequence[Finding], baseline: Dict[str, dict]):
    """-> (new_findings, fixed_baseline_entries)."""
    current = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in baseline]
    fixed = [e for fp, e in baseline.items() if fp not in current]
    return new, fixed
