"""The port's hornlint (``repro_torch.analysis``): its host-sync (HL2xx) and
pool-lifetime (HL4xx) passes held against the JAX package's on the same
fixtures (the reference's own pool fixtures; line-for-line torch twins of
its sync fixtures), its fingerprints and baselines against the
reference's, each rule on its seeded fixture, the suppression scopes, the
CLI's exit codes, and the port linting clean against its committed
baseline.
"""
import json
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import hornlint, lint_paths, lint_source
from repro_torch.analysis import host_sync
from repro_torch.analysis.core import (Finding, all_rules, diff_baseline,
                                       load_baseline, write_baseline)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "torch_hornlint_fixtures"
JAX_FIXTURES = Path(__file__).parent / "hornlint_fixtures"


def keys(findings):
    return sorted((f.rule, f.line, f.qualname) for f in findings)


def lint_fixture(name):
    return lint_paths([FIXTURES / name], root=REPO)


# ---------------------------------------------------------------------------
# held against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["violation_pool.py", "clean_pool.py"])
def test_pool_pass_matches_jax_on_its_fixtures(name):
    from repro.analysis import lint_paths as jax_lint
    want = [f for f in jax_lint([JAX_FIXTURES / name], root=REPO)
            if f.rule.startswith("HL4")]
    got = lint_paths([JAX_FIXTURES / name], root=REPO)
    assert keys(got) == keys(want)
    assert [f.fingerprint for f in sorted(got, key=lambda f: f.line)] == \
        [f.fingerprint for f in sorted(want, key=lambda f: f.line)]


@pytest.mark.parametrize("name", ["violation_sync.py", "clean_sync.py"])
def test_sync_pass_on_torch_twin_matches_jax_on_original(name):
    from repro.analysis import lint_paths as jax_lint
    want = [f for f in jax_lint([JAX_FIXTURES / name], root=REPO)
            if f.rule.startswith("HL2")]
    got = lint_fixture(name)
    assert keys(got) == keys(want)
    # the twins are line for line: same length, same defs on same lines
    a = (FIXTURES / name).read_text().splitlines()
    b = (JAX_FIXTURES / name).read_text().splitlines()
    assert len(a) == len(b)
    assert [i for i, ln in enumerate(a) if "def " in ln] == \
        [i for i, ln in enumerate(b) if "def " in ln]


def test_fingerprints_and_baselines_match_jax(tmp_path):
    from repro.analysis import core as jcore
    found = lint_fixture("violation_sync.py") + lint_fixture(
        "violation_pool.py")
    assert found
    twins = [jcore.Finding(f.rule, f.path, f.line, f.col, f.message,
                           f.qualname) for f in found]
    assert [f.fingerprint for f in found] == [f.fingerprint for f in twins]
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    write_baseline(found, ours)
    jcore.write_baseline(twins, theirs)
    assert ours.read_text() == theirs.read_text()
    assert load_baseline(ours) == jcore.load_baseline(ours)
    new, fixed = diff_baseline(found, jcore.load_baseline(theirs))
    assert new == [] and fixed == []


def test_fingerprint_survives_line_drift_as_jax():
    from repro.analysis.core import Finding as JFinding
    for cls in (Finding, JFinding):
        a = cls("HL201", "e.py", 10, 4, "msg", "Engine.step")
        b = cls("HL201", "e.py", 99, 4, "msg", "Engine.step")
        c = cls("HL201", "e.py", 10, 4, "other", "Engine.step")
        assert a.fingerprint == b.fingerprint != c.fingerprint
    assert Finding("HL402", "p.py", 3, 0, "m", "q").fingerprint == \
        JFinding("HL402", "p.py", 3, 0, "m", "q").fingerprint


# ---------------------------------------------------------------------------
# each rule on its fixture
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,rules", [
    ("violation_sync.py", {"HL201", "HL202"}),
    ("violation_torch_sync.py", {"HL201", "HL202"}),
    ("violation_pool.py", {"HL401", "HL402"}),
])
def test_rules_fire_on_violation_fixture(name, rules):
    assert {f.rule for f in lint_fixture(name)} == rules


@pytest.mark.parametrize("name", ["clean_sync.py", "clean_torch_sync.py",
                                  "clean_pool.py"])
def test_clean_twin_is_quiet(name):
    assert lint_fixture(name) == []


def test_every_marked_line_of_the_torch_sinks_fixture_fires():
    src = (FIXTURES / "violation_torch_sync.py").read_text().splitlines()
    marked = {i for i, ln in enumerate(src, 1) if "# HL20" in ln}
    assert {f.line for f in lint_fixture("violation_torch_sync.py")} \
        == marked


SINKS = {
    "item": "n = out.item()",
    "tolist": "n = out.tolist()",
    "cpu": "n = out.cpu()",
    "numpy": "n = out.numpy()",
    "to_cpu": "n = out.to('cpu')",
    "to_cpu_kw": "n = out.to(device='cpu')",
    "to_cpu_device": "n = out.to(torch.device('cpu'))",
    "np_asarray": "n = np.asarray(out)",
    "np_array": "n = np.array(out)",
    "float": "n = float(out.sum())",
    "int": "n = int(out[0])",
    "bool": "n = bool(out.any())",
    "synchronize": "torch.cuda.synchronize()",
    "stream_sync": "torch.cuda.current_stream().synchronize()",
    "if": "if out.sum() > 0:\n    n = 1",
    "ifexp": "n = 1 if out.any() else 0",
    "while": "while out.any():\n    out = out * 0",
    "store": "n = np.zeros(4)\nn[0] = out[0]",
    "method_chain": "n = out.long().sum().item()",
    "torch_op": "n = torch.where(out > 0, out, 0).cpu()",
    "device_factory": "t = torch.ones(4, device=self.device)\nn = t.item()",
    "upload": "t = torch.from_numpy(h).to(self.device)\nn = t.tolist()",
}


def _hot(body: str) -> str:
    return ("import numpy as np\nimport torch\n\n\nclass Engine:\n"
            "    def step(self, h):  # hornlint: hot-path\n"
            "        out = self._step(self.params)\n"
            + textwrap.indent(body, " " * 8) + "\n")


@pytest.mark.parametrize("what", sorted(SINKS))
def test_each_sink_is_a_pull(what):
    got = lint_source(_hot(SINKS[what]))
    assert [f.rule for f in got] in (["HL201"], ["HL202"]), got


NOT_SINKS = {
    "shape": "n = out.shape[0] + out.size(0) + out.numel() + out.dim()",
    "data_ptr": "n = out.data_ptr()",
    "dtype_cast": "n = out.to(torch.bfloat16)",
    "device_move": "n = out.to(self.device)",
    "identity": "if out is None:\n    n = 0",
    "host_int": "n = int(h[0])",
    "host_array": "n = np.asarray(h)",
    "from_numpy": "n = torch.from_numpy(h).cpu()",
    "cpu_factory": "n = torch.zeros(4, device='cpu').item()",
    "sink_result": "n = out.cpu().numpy()  # hornlint: sync-ok\nm = int(n[0])",
}


@pytest.mark.parametrize("what", sorted(NOT_SINKS))
def test_metadata_uploads_and_host_values_are_free(what):
    assert lint_source(_hot(NOT_SINKS[what])) == []


def test_loop_makes_the_pull_hl202():
    got = lint_source(_hot("for i in range(4):\n    n = out[i].item()"))
    assert [f.rule for f in got] == ["HL202"]
    assert "every loop iteration" in got[0].message


# ---------------------------------------------------------------------------
# suppression scopes and the hot scope
# ---------------------------------------------------------------------------
def test_sync_requires_hot_scope_opt_in():
    src = (FIXTURES / "violation_sync.py").read_text()
    assert lint_source(src.replace("# hornlint: hot-path", "")) == []


def test_sync_ok_suppresses_the_sync_family_only():
    assert lint_source(_hot("n = out.item()  # hornlint: sync-ok")) == []
    src = textwrap.dedent("""\
        class S:
            def admit(self, req):
                t = self.pool.alloc_pages(req.id, 4)  # hornlint: sync-ok
    """)
    assert {f.rule for f in lint_source(src)} == {"HL402"}


@pytest.mark.parametrize("comment,quiet", [
    ("# hornlint: ignore", True), ("# hornlint: ignore[HL201]", True),
    ("# hornlint: ignore[HL202,HL201]", True),
    ("# hornlint: ignore[HL999]", False), ("# hornlint: ignore[HL402]", False),
])
def test_ignore_comment_scopes(comment, quiet):
    got = lint_source(_hot(f"n = out.item()  {comment}"))
    assert (got == []) == quiet


@pytest.mark.parametrize("path", ["src/repro_torch/launch/serve.py",
                                  "benchmarks/bench.py"])
def test_clis_and_benchmarks_pull_freely(path):
    assert lint_source(_hot("n = out.item()"), path) == []


def test_hot_scopes_name_the_ports_own_methods():
    """Every hot-scope qualname is a def of the port's file it names, so a
    rename cannot silently drop a method out of the pass."""
    from repro_torch.analysis.core import qualname_map
    import ast
    for suffix, names in host_sync.HOT_SCOPES:
        src = (REPO / "src" / "repro_torch" / suffix).read_text()
        quals = set(qualname_map(ast.parse(src)).values())
        assert set(names) <= quals, (suffix, set(names) - quals)


def test_the_engines_tags_are_load_bearing():
    """Each ``sync-ok`` on the port's tick path suppresses a real pull: with
    the tags stripped the pass flags exactly those lines."""
    for rel in ("serving/engine.py", "serving/speculative.py"):
        path = REPO / "src" / "repro_torch" / rel
        src = path.read_text()
        tagged = {i for i, ln in enumerate(src.splitlines(), 1)
                  if "hornlint: sync-ok" in ln}
        assert tagged
        got = lint_source(src.replace("# hornlint: sync-ok", ""),
                          f"src/repro_torch/{rel}")
        assert {f.line for f in got} == tagged, rel
        assert {f.rule for f in got} == {"HL201"}


# ---------------------------------------------------------------------------
# baseline, CLI
# ---------------------------------------------------------------------------
def test_baseline_round_trip(tmp_path):
    findings = lint_fixture("violation_torch_sync.py")
    base = tmp_path / "baseline.json"
    write_baseline(findings, base)
    assert set(load_baseline(base)) == {f.fingerprint for f in findings}
    rc = hornlint.main([str(FIXTURES / "violation_torch_sync.py"),
                        "--baseline", str(base), "--root", str(REPO)])
    assert rc == 0


def test_write_baseline_then_clean(tmp_path, capsys):
    base = tmp_path / "b.json"
    assert hornlint.main([str(FIXTURES / "violation_pool.py"),
                          "--write-baseline", "--baseline", str(base)]) == 0
    assert len(json.loads(base.read_text())["findings"]) == 2
    assert hornlint.main([str(FIXTURES / "violation_pool.py"),
                          "--baseline", str(base)]) == 0


def test_committed_baseline_is_empty():
    doc = json.loads(hornlint.DEFAULT_BASELINE.read_text())
    assert doc == {"version": 1, "findings": []}


def test_port_lints_clean_against_committed_baseline():
    rc = hornlint.main([str(REPO / "src" / "repro_torch"),
                        "--baseline", str(hornlint.DEFAULT_BASELINE),
                        "--root", str(REPO)])
    assert rc == 0


@pytest.mark.parametrize("name", ["violation_sync.py",
                                  "violation_torch_sync.py",
                                  "violation_pool.py"])
def test_cli_nonzero_on_violation_fixture(name):
    assert hornlint.main([str(FIXTURES / name), "--baseline", "none"]) == 1


@pytest.mark.parametrize("name", ["clean_sync.py", "clean_torch_sync.py",
                                  "clean_pool.py"])
def test_cli_zero_on_clean_fixture(name):
    assert hornlint.main([str(FIXTURES / name), "--baseline", "none"]) == 0


@pytest.mark.parametrize("argv", [["--rules", "HL999"],
                                  ["--rules", "HL301"],
                                  ["no/such/path.py"],
                                  ["x.py", "--baseline", "no/such.json"]])
def test_cli_bad_invocation(argv, tmp_path):
    if argv[0] == "x.py":
        argv = [str(FIXTURES / "clean_pool.py")] + argv[1:]
    assert hornlint.main(argv) == 2


def test_cli_github_and_json(capsys):
    rc = hornlint.main([str(FIXTURES / "violation_pool.py"),
                        "--baseline", "none", "--github", "--json",
                        "--rules", "HL401"])
    assert rc == 1
    out = capsys.readouterr().out
    ann = [ln for ln in out.splitlines() if ln.startswith("::error ")]
    assert len(ann) == 1 and ",title=hornlint HL401" in ann[0]
    doc = json.loads(out[out.index("{"):])
    assert [f["rule"] for f in doc["findings"]] == ["HL401"]


def test_cli_lists_the_port_rules(capsys):
    assert hornlint.main(["--list-rules"]) == 0
    assert set(all_rules()) == {"HL201", "HL202", "HL401", "HL402"}
    out = capsys.readouterr().out
    assert all(r in out for r in all_rules())
