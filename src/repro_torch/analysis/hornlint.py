"""hornlint CLI for the port.

    python -m repro_torch.analysis.hornlint [paths...] [options]

The reference's CLI (``repro/analysis/hornlint.py``) over the port's two
pass families: host sync (HL2xx) and pool lifetime (HL4xx).  Exit codes:
0 = clean (or only baselined findings), 1 = new findings, 2 = bad
invocation.  The default path is ``src/repro_torch``; the default baseline
is the committed ``src/repro_torch/analysis/baseline.json``, which holds
no findings (``--baseline none`` disables the diff — every finding fails,
the mode the tests use on seeded-violation fixtures).  ``--github`` emits one
``::error file=...`` workflow annotation per new finding so they land
inline on the PR diff.

    # full run against the committed baseline
    python -m repro_torch.analysis.hornlint src/repro_torch

    # accept current findings as the new baseline
    python -m repro_torch.analysis.hornlint --write-baseline

    # single rule family, raw findings
    python -m repro_torch.analysis.hornlint --rules HL201,HL202 --baseline none
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import core

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hornlint",
        description="static analysis for the port's host-sync and "
                    "pool-lifetime contracts")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint "
                         "(default: src/repro_torch)")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline JSON to diff against, or 'none'")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to enable (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    ap.add_argument("--github", action="store_true",
                    help="emit GitHub Actions ::error annotations for "
                         "new findings (combinable with --json)")
    ap.add_argument("--root", default=".",
                    help="path findings are reported relative to")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule, desc in core.all_rules().items():
            print(f"{rule}  {desc}")
        return 0
    rules = None
    if args.rules:
        rules = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = rules - set(core.all_rules())
        if unknown:
            print(f"unknown rules: {sorted(unknown)}", file=sys.stderr)
            return 2
    paths = [Path(p) for p in args.paths]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"no such path: {missing}", file=sys.stderr)
        return 2
    findings = core.lint_paths(paths, root=Path(args.root), rules=rules)

    if args.write_baseline:
        base_path = Path(args.baseline) if args.baseline != "none" \
            else DEFAULT_BASELINE
        core.write_baseline(findings, base_path)
        print(f"wrote {len(findings)} finding(s) to {base_path}")
        return 0

    baseline = {}
    if args.baseline != "none":
        base_path = Path(args.baseline)
        if base_path.exists():
            baseline = core.load_baseline(base_path)
        elif args.baseline != str(DEFAULT_BASELINE):
            print(f"baseline not found: {base_path}", file=sys.stderr)
            return 2
    new, fixed = core.diff_baseline(findings, baseline)

    if args.github:
        for f in new:
            # workflow-command message field: newlines/percents must be
            # URL-encoded or the annotation is truncated
            msg = (f.message.replace("%", "%25").replace("\n", "%0A")
                   .replace("\r", ""))
            print(f"::error file={f.path},line={f.line},"
                  f"col={f.col + 1},title=hornlint {f.rule}::{msg}")

    if args.as_json:
        print(json.dumps({
            "findings": [vars(f) | {"fingerprint": f.fingerprint}
                         for f in findings],
            "new": [f.fingerprint for f in new],
            "fixed": [e["fingerprint"] for e in fixed],
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        n_base = len(findings) - len(new)
        if n_base:
            print(f"hornlint: {n_base} baselined finding(s) not shown")
        if fixed:
            print(f"hornlint: {len(fixed)} baselined finding(s) no longer "
                  f"fire — regenerate with --write-baseline to tighten")
        print(f"hornlint: {len(new)} new finding(s) "
              f"across {len(core.iter_py_files(paths))} file(s)")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
