"""Launch-geometry proofs for the port's CUDA kernels, with counterexamples.

The counterpart of the reference's ``blockspec_verify.py``.  A Pallas
kernel states its geometry as a grid and BlockSpec index maps; a CUDA
kernel states it in the host code of its launch (grid, block, cluster,
dynamic shared memory) and in the index arithmetic of its body.  Each
kernel's ``kernels/<name>/geometry.py`` restates both as a
``LaunchGeometry``: the launch's numbers, and for each block index the
boxes of elements the block reads and writes, after the masks the kernel
applies (ragged row tails, live pages, dropped tiles).

``verify`` enumerates every block of the grid and discharges:

* **LG001 in-bounds** — every box a block touches lies inside its operand;
  a block-table column read is below ``maxp``, a page id below ``P``.
* **LG002 coverage hole / LG003 double-write** — every output element that
  must be written is written exactly once over the whole grid (a decode
  cluster's peers write nothing; the persistent ``dropout_matmul`` grid's
  walk reaches every tile once).
* **LG004 launch limits** — threads a block <= 1024 (and per dim), gridDim
  y and z <= 65,535, dynamic shared memory <= 232,448 B and not above what
  the launcher allows (48 KiB unless it calls ``cudaFuncSetAttribute``),
  clusters of at most 8 blocks whose dims divide the grid's.
* **LG005 block-table contract** — the counterpart of the reference's
  HS005: no block reads a slot's table entry at or past its live page
  count, nor, with a window, before its first visible page; the decode
  kernel's NS splits partition each slot's live page range exactly.
* **LG006 incomplete** — a grid past the enumeration budget is reported,
  never passed.

Every failure names a counterexample block index ``(x, y, z)``.  The
proof is by exhaustive enumeration at concrete shapes and slot contents,
so the shape quantifier is discharged by the cases ``hornshape`` chooses,
as the reference's is.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

MAX_THREADS = 1024                  # threads a block
MAX_BLOCK_DIMS = (1024, 1024, 64)
MAX_GRID_DIMS = (2 ** 31 - 1, 65535, 65535)
MAX_DYNAMIC_SMEM = 232448           # sm_90 opt-in ceiling (227 KiB)
# without cudaFuncSetAttribute: the launchers opt in above it
# (kernels/csrc/hopper.cuh:413, paged_chunk_attention.cu:383,
# paged_attention.cu:569, always in ssd_chunk_scan.cu:349)
DEFAULT_DYNAMIC_SMEM = 48 * 1024
MAX_CLUSTER = 8                     # the portable cluster size
ENUM_BUDGET = 200_000               # blocks ``verify`` will enumerate

RULES = {
    "LG001": "a block touches elements outside an operand",
    "LG002": "the grid leaves an output element unwritten (coverage hole)",
    "LG003": "an output element is written by more than one block",
    "LG004": "the launch exceeds a device limit (threads, grid, shared "
             "memory, cluster)",
    "LG005": "a block reads a block-table entry outside its slot's live "
             "pages, or the decode splits do not partition them",
    "LG006": "the geometry is too large to enumerate (analysis incomplete)",
}

Block = Tuple[int, int, int]


@dataclass(frozen=True)
class Box:
    """Elements ``[lo[d], hi[d])`` of every dim ``d`` of ``operand``."""
    operand: str
    lo: Tuple[int, ...]
    hi: Tuple[int, ...]
    write: bool = False


def box(operand: str, *ranges, write: bool = False) -> Box:
    """``box("out", 3, (0, 16), (0, 128))``: an int is one index, a pair a
    half-open range."""
    lo, hi = [], []
    for r in ranges:
        if isinstance(r, tuple):
            lo.append(int(r[0]))
            hi.append(int(r[1]))
        else:
            lo.append(int(r))
            hi.append(int(r) + 1)
    return Box(operand, tuple(lo), tuple(hi), write)


_CONSTEXPR = re.compile(r"^constexpr int (.*?);", re.M | re.S)
_OPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
        ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a // b}


def cu_constants(source: Path, *names: str) -> Tuple[int, ...]:
    """The values of ``names`` among the namespace-scope ``constexpr int``
    declarations of a kernel source (``constexpr int A = 4, B = A * 32;``,
    at column 0): a geometry model reads its kernel's tiles, threads and
    stages from the source the card runs, never from a copy of them."""
    text = re.sub(r"//[^\n]*", "", Path(source).read_text())
    env: Dict[str, int] = {}

    def value(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name):
            return env[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](value(node.left), value(node.right))
        raise ValueError(f"{source}: cannot evaluate {ast.dump(node)}")

    for decls in _CONSTEXPR.findall(text):
        for decl in decls.split(","):
            name, expr = (t.strip() for t in decl.split("=", 1))
            v = value(ast.parse(expr, mode="eval").body)
            if env.setdefault(name, v) != v:
                raise ValueError(f"{source}: {name} declared twice")
    missing = [n for n in names if n not in env]
    if missing:
        raise KeyError(f"{source} declares no constexpr int {missing}")
    return tuple(env[n] for n in names)


@dataclass
class Operand:
    name: str
    shape: Tuple[int, ...]
    output: bool = False
    # output elements that must be written (default: all of them)
    required: Optional[np.ndarray] = None


@dataclass
class TableContract:
    """The block-table contract of a paged launch.  ``live[b]`` is slot
    ``b``'s (first visible page, live page count): a block may read table
    entries of row ``b`` only in that range.  ``splits``, for the decode
    kernel, maps a slot to its splits' (block, first page, end page)."""
    table: str
    live: Sequence[Tuple[int, int]]
    splits: Optional[Callable[[int], List[Tuple[Block, int, int]]]] = None


@dataclass
class LaunchGeometry:
    name: str                      # e.g. "paged_chunk_attention:wgmma"
    kernel: str                    # the device function's name
    source: str                    # "path.cu:line" of the launch
    grid: Block
    block: Block
    dynamic_smem: int
    operands: List[Operand]
    touches: Callable[[Block], Iterable[Box]]
    # dynamic shared memory the launcher allows: the value it passes to
    # cudaFuncSetAttribute, None where it sets none (48 KiB)
    smem_allowed: Optional[int] = None
    cluster: Block = (1, 1, 1)
    table: Optional[TableContract] = None
    # the kernel's static __shared__ bytes: a profiler's record of the
    # launch shows static + dynamic
    static_smem: int = 0
    # the model function and the keyword arguments this launch was built
    # from ({"model": "paged.chunk", ...}), so a caller can make the same
    # call on the card; the launches of one wrapper call share one dict
    call: Optional[dict] = None

    @property
    def threads(self) -> int:
        return self.block[0] * self.block[1] * self.block[2]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def launch(self) -> dict:
        """What a profiler's record of this launch must show."""
        return {"kernel": self.kernel, "grid": list(self.grid),
                "block": list(self.block),
                "shared_memory": self.dynamic_smem + self.static_smem}


@dataclass
class GeometryFinding:
    rule: str
    geometry: str
    source: str
    message: str
    block: Optional[Block] = None

    def render(self) -> str:
        at = f" at block {self.block}" if self.block is not None else ""
        return f"{self.source}: {self.rule} [{self.geometry}]{at} " \
               f"{self.message}"


@dataclass
class Report:
    geometry: LaunchGeometry
    findings: List[GeometryFinding] = field(default_factory=list)
    blocks_checked: int = 0
    obligations: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def render(self) -> List[str]:
        g = self.geometry
        out = [f"{g.name}: grid={g.grid} block={g.block} "
               f"cluster={g.cluster} smem={g.dynamic_smem}"]
        if self.ok:
            out.append(f"  PROVED: {self.obligations} obligations over "
                       f"{self.blocks_checked} blocks")
        out += ["  " + f.render() for f in self.findings]
        return out


def iter_blocks(grid: Block) -> Iterable[Block]:
    for z in range(grid[2]):
        for y in range(grid[1]):
            for x in range(grid[0]):
                yield (x, y, z)


class _Verifier:
    def __init__(self, geom: LaunchGeometry):
        self.g = geom
        self.rep = Report(geom)
        self.ops = {op.name: op for op in geom.operands}
        self.seen: set = set()       # (rule, key): one finding each

    def finding(self, rule: str, message: str, block=None, key=None):
        k = (rule, key if key is not None else message)
        if k in self.seen:
            return
        self.seen.add(k)
        self.rep.findings.append(GeometryFinding(
            rule, self.g.name, self.g.source, message, block))

    # ---------------- LG004 ----------------
    def check_limits(self) -> None:
        g = self.g
        self.rep.obligations += 5
        if g.threads > MAX_THREADS or g.threads < 1 or any(
                not 1 <= b <= m for b, m in zip(g.block, MAX_BLOCK_DIMS)):
            self.finding("LG004", f"block {g.block}: {g.threads} threads "
                                  f"(1 to {MAX_THREADS}, dims up to "
                                  f"{MAX_BLOCK_DIMS})")
        for d, (e, m) in enumerate(zip(g.grid, MAX_GRID_DIMS)):
            if not 1 <= e <= m:
                self.finding("LG004", f"gridDim.{'xyz'[d]} = {e} outside "
                                      f"[1, {m}]")
        if g.dynamic_smem > MAX_DYNAMIC_SMEM:
            self.finding("LG004", f"{g.dynamic_smem} B of dynamic shared "
                                  f"memory > the card's {MAX_DYNAMIC_SMEM}")
        allowed = DEFAULT_DYNAMIC_SMEM if g.smem_allowed is None \
            else g.smem_allowed
        if g.dynamic_smem > allowed:
            self.finding("LG004", f"{g.dynamic_smem} B of dynamic shared "
                                  f"memory > the {allowed} B the launcher "
                                  f"allows (cudaFuncSetAttribute)")
        n = g.cluster[0] * g.cluster[1] * g.cluster[2]
        if n > MAX_CLUSTER or any(c < 1 or e % c
                                  for c, e in zip(g.cluster, g.grid)):
            self.finding("LG004", f"cluster {g.cluster} must hold at most "
                                  f"{MAX_CLUSTER} blocks and divide grid "
                                  f"{g.grid}")

    # ---------------- enumeration ----------------
    def run(self) -> Report:
        g = self.g
        self.check_limits()
        if g.blocks > ENUM_BUDGET:
            self.finding("LG006", f"{g.blocks} blocks exceed the enumeration "
                                  f"budget of {ENUM_BUDGET}: not proved")
            return self.rep
        counts: Dict[str, np.ndarray] = {}
        first: Dict[str, np.ndarray] = {}
        for op in g.operands:
            if op.output:
                counts[op.name] = np.zeros(op.shape, np.uint16)
                first[op.name] = np.full(op.shape, -1, np.int64)
        live = g.table.live if g.table is not None else None
        for bid, blk in enumerate(iter_blocks(g.grid)):
            self.rep.blocks_checked += 1
            for bx in g.touches(blk):
                op = self.ops.get(bx.operand)
                if op is None:
                    self.finding("LG001", f"touches unknown operand "
                                          f"{bx.operand!r}", blk)
                    continue
                if len(bx.lo) != len(op.shape) or any(
                        lo > hi for lo, hi in zip(bx.lo, bx.hi)):
                    self.finding("LG001", f"{bx.operand}: box {bx.lo}.."
                                          f"{bx.hi} does not fit rank "
                                          f"{len(op.shape)}", blk)
                    continue
                if any(lo == hi for lo, hi in zip(bx.lo, bx.hi)):
                    continue                        # empty
                if any(lo < 0 or hi > s for lo, hi, s in
                       zip(bx.lo, bx.hi, op.shape)):
                    self.finding(
                        "LG001", f"{bx.operand}{list(op.shape)}: "
                                 f"{'writes' if bx.write else 'reads'} "
                                 f"[{bx.lo}, {bx.hi}) out of bounds: "
                                 f"counterexample", blk, key=bx.operand)
                    continue
                if live is not None and bx.operand == g.table.table:
                    self._check_table(bx, blk, live)
                if bx.write:
                    if not op.output:
                        self.finding("LG003", f"writes input operand "
                                              f"{bx.operand}", blk)
                        continue
                    sl = tuple(slice(lo, hi) for lo, hi in zip(bx.lo, bx.hi))
                    c = counts[op.name][sl]
                    if c.any():
                        at = tuple(int(i) for i in np.argwhere(c > 0)[0])
                        elem = tuple(lo + i for lo, i in zip(bx.lo, at))
                        other = int(first[op.name][elem])
                        self.finding(
                            "LG003", f"{op.name}{list(elem)} written again "
                                     f"(first by block "
                                     f"{_unflat(other, g.grid)}): "
                                     f"counterexample", blk, key=op.name)
                    c += 1
                    f = first[op.name][sl]
                    f[f < 0] = bid
        for op in g.operands:
            if not op.output:
                continue
            self.rep.obligations += 2
            need = counts[op.name] == 0
            if op.required is not None:
                need &= op.required
            if need.any():
                elem = tuple(int(i) for i in np.argwhere(need)[0])
                self.finding("LG002", f"{op.name}{list(elem)} is never "
                                      f"written ({int(need.sum())} elements "
                                      f"unwritten): counterexample")
        if g.table is not None:
            self.rep.obligations += 1
            if g.table.splits is not None:
                self._check_splits(live)
        return self.rep

    def _check_table(self, bx: Box, blk: Block, live) -> None:
        slot = bx.lo[0]
        for b in range(bx.lo[0], bx.hi[0]):
            first_page, n_live = live[b]
            if bx.lo[1] < first_page or bx.hi[1] > n_live:
                self.finding(
                    "LG005", f"{bx.operand}[{b}, {bx.lo[1]}:{bx.hi[1]}] read, "
                             f"slot {b}'s visible live pages are "
                             f"[{first_page}, {n_live}): counterexample",
                    blk, key=(bx.operand, slot))

    def _check_splits(self, live) -> None:
        for b, (first_page, n_live) in enumerate(live):
            parts = sorted(self.g.table.splits(b), key=lambda s: s[1])
            at = first_page
            for blk, lo, hi in parts:
                if lo != at or hi < lo:
                    self.finding(
                        "LG005", f"slot {b}: split pages [{lo}, {hi}) do not "
                                 f"continue at page {at} of the live range "
                                 f"[{first_page}, {n_live}): counterexample",
                        blk, key=("splits", b))
                    break
                at = hi
            else:
                if at != max(first_page, n_live) and n_live > first_page:
                    blk = parts[-1][0] if parts else None
                    self.finding(
                        "LG005", f"slot {b}: splits end at page {at}, the "
                                 f"live range [{first_page}, {n_live}): "
                                 f"counterexample", blk, key=("splits", b))


def _unflat(bid: int, grid: Block) -> Block:
    return (bid % grid[0], bid // grid[0] % grid[1],
            bid // (grid[0] * grid[1]))


def verify(geom: LaunchGeometry) -> Report:
    """Discharge LG001-LG006 for one launch by enumerating its grid."""
    return _Verifier(geom).run()
