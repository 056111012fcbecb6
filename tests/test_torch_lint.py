"""The port's sparkdl-lint (``sparkdl_torch.lint``): the framework's
contracts (suppression grammar with a required justification, exit
codes, the JSON report), one bad and one ok fixture per rule, the
self-clean gate over the port's production and test scope, and the
rules copied as they are held to the JAX package's linter on the same
fixtures (both are stdlib ``ast`` only).

The fixtures live in ``tests/lint_fixtures/torch/``: both linters skip
any ``lint_fixtures`` directory in a walk, and pytest does not collect
it. The gate lints the tree once, in a module-scoped fixture.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from sparkdl_tpu.lint import core as ref_core
from sparkdl_tpu.lint import rules as ref_rules
from sparkdl_torch.lint import ALL_RULES
from sparkdl_torch.lint.core import Project, SourceFile, lint_paths
from sparkdl_torch.lint.rules import (
    DROPPED_RULES,
    BlockingInHotLoopRule,
    EnvPinRule,
    FaultCoverageRule,
    LockDisciplineRule,
    MetricDriftRule,
    SleepPollRule,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures", "torch")
RULE_NAMES = ["lock-discipline", "blocking-in-hot-loop", "metric-drift",
              "fault-coverage", "env-pin", "sleep-poll"]


def load(name, rel=None):
    path = os.path.join(FIXTURES, name)
    with open(path, encoding="utf-8") as fh:
        return SourceFile(path, fh.read(), rel=rel or name)


def run_rule(rule, *files, docs=""):
    findings = []
    for f in files:
        if rule.wants(f):
            findings.extend(rule.check(f))
    findings.extend(rule.finalize(Project(list(files), {}, docs)))
    return findings


def run_both(rule_name, sources, docs=""):
    """Run the port's rule and the reference's rule of the same name over
    the same ``(name, rel)`` fixtures; return each side's sorted
    (rule, path, line, message) findings."""
    out = []
    for core, rules in ((ref_core, ref_rules),
                        (sys.modules[SourceFile.__module__],
                         sys.modules[LockDisciplineRule.__module__])):
        files = []
        for name, rel in sources:
            path = os.path.join(FIXTURES, name)
            with open(path, encoding="utf-8") as fh:
                files.append(core.SourceFile(path, fh.read(), rel=rel))
        rule = next(cls() for cls in rules.ALL_RULES
                    if cls.name == rule_name)
        found = []
        for f in files:
            if rule.wants(f):
                found.extend(rule.check(f))
        found.extend(rule.finalize(core.Project(files, {}, docs)))
        out.append(sorted((f.rule, f.path, f.line, f.message)
                          for f in found))
    return out


# ---------------------------------------------------------------------------
# the gate: the port's production and test scope, linted once
# ---------------------------------------------------------------------------


def gate_paths():
    tests = os.path.join(REPO, "tests")
    ported = sorted(
        os.path.join(tests, n) for n in os.listdir(tests)
        if n.endswith(".py")
        and (n.startswith("test_torch_") or n.startswith("torch_")))
    return [os.path.join(REPO, "sparkdl_torch"),
            os.path.join(REPO, "chip_smoke.py"),
            os.path.join(REPO, "tools"), *ported]


@pytest.fixture(scope="module")
def gate():
    return lint_paths(gate_paths(), root=REPO)


def test_port_lints_clean_at_head(gate):
    assert gate.findings == [], "\n".join(
        f.render() for f in gate.findings)
    # the gate saw the real tree, production and tests
    rels = [p for p in gate_paths()]
    assert gate.files_scanned > 200, gate.files_scanned
    assert any(p.endswith("test_torch_lint.py") for p in rels)


def test_every_suppression_at_head_is_justified(gate):
    assert gate.suppressed, "expected the documented suppressions"
    for f in gate.suppressed:
        assert f.justification, f.render()
    # every catalogued fault site is raised and exercised: none is
    # suppressed any more (autoscale.decide landed with autoscale/)
    assert [f for f in gate.suppressed if f.rule == "fault-coverage"] == []


def test_gate_wall_time_stays_cheap(gate):
    assert gate.elapsed_s < 20.0, gate.elapsed_s


# ---------------------------------------------------------------------------
# the rules copied as they are, against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule, sources, docs, fires", [
    ("lock-discipline", [("lock_bad.py", "lock_bad.py")], "", True),
    ("lock-discipline", [("lock_ok.py", "lock_ok.py")], "", False),
    ("lock-discipline", [("lock_cycle.py", "lock_cycle.py")], "", True),
    ("lock-discipline", [("lock_bad.py", "pkg/lock_bad.py"),
                         ("lock_cycle.py", "pkg/lock_cycle.py"),
                         ("lock_ok.py", "pkg/lock_ok.py")], "", True),
    ("sleep-poll", [("sleep_poll_bad.py", "tests/sleep_poll_bad.py")], "",
     True),
    ("sleep-poll", [("sleep_poll_ok.py", "tests/sleep_poll_ok.py")], "",
     False),
    ("metric-drift", [("metric_bad.py", "metric_bad.py")],
     "sparkdl_lintfixture_total is documented", True),
    ("metric-drift", [("metric_ok.py", "metric_ok.py")],
     "`sparkdl_lintfixture_total` counter", False),
    ("metric-drift", [("metric_ok.py", "metric_ok.py")], "", True),
    ("metric-drift", [("metric_bad.py", "pkg/metric_bad.py"),
                      ("metric_ok.py", "tests/metric_ok.py")], "", True),
], ids=["lock-bad", "lock-ok", "lock-cycle", "lock-three-files",
        "sleep-bad", "sleep-ok", "metric-bad", "metric-ok",
        "metric-ok-undocumented", "metric-across-scopes"])
def test_copied_rule_finds_what_the_reference_finds(rule, sources, docs,
                                                    fires):
    ref, port = run_both(rule, sources, docs)
    assert port == ref
    assert bool(port) == fires, port


def test_hot_loop_rule_keeps_the_references_findings():
    """The port's rule replaces ``jax.device_get`` with the torch calls
    that block on the card; every finding the reference makes on the
    same fixture is still made, and the rest are those torch calls."""
    ref, port = run_both("blocking-in-hot-loop",
                         [("hotloop_bad.py", "hotloop_bad.py")])
    assert ref and set(ref) <= set(port)
    extra = [m for *_, m in set(port) - set(ref)]
    assert extra and all(m.startswith((".synchronize()", ".item()"))
                         for m in extra), extra
    assert run_both("blocking-in-hot-loop",
                    [("hotloop_ok.py", "hotloop_ok.py")]) == [[], []]


SUPPRESSION_SNIPPETS = [
    "a = 1  # sparkdl-lint: disable=lock-discipline -- init publication\n",
    "# sparkdl-lint: disable=env-pin -- bootstrap read\nimport os\n",
    "a = 1  # sparkdl-lint: disable=env-pin,metric-drift -- shared reason\n",
    ("# sparkdl-lint: disable=blocking-in-hot-loop -- resolved\n"
     "outs = consume(\n    fut.result())\nnext_line = 2\n"),
    ("# sparkdl-lint: disable=sleep-poll -- loop head only\n"
     "while waiting():\n    time.sleep(1)\n"),
    ('"""Docs: write `# sparkdl-lint: disable=env-pin` plus a\n'
     'justification.\"\"\"\n'
     "msg = 'try # sparkdl-lint: disable=lock-discipline'\n"),
    "x = f()  # sparkdl-lint: disable=env-pin\n",
    "x = f()  # sparkdl-lint: disable=env-pin --   \n",
    "def f(:\n  # sparkdl-lint: disable=env-pin -- unparsable file\n",
]


@pytest.mark.parametrize("text", SUPPRESSION_SNIPPETS,
                         ids=[f"snippet{i}" for i in
                              range(len(SUPPRESSION_SNIPPETS))])
def test_suppression_parsing_matches_the_reference(text):
    ref = ref_core.SourceFile("x.py", text)
    port = SourceFile("x.py", text)
    assert port.suppressions == ref.suppressions
    assert port.bad_suppressions == ref.bad_suppressions
    rules = ["lock-discipline", "env-pin", "metric-drift", "sleep-poll",
             "blocking-in-hot-loop"]
    n = text.count("\n") + 2
    assert [port.suppression_for(r, i) for r in rules
            for i in range(1, n)] == [ref.suppression_for(r, i)
                                      for r in rules for i in range(1, n)]


# ---------------------------------------------------------------------------
# suppression grammar
# ---------------------------------------------------------------------------


class TestSuppressions:
    def test_trailing_with_justification(self):
        src = SourceFile("x.py", "a = 1  # sparkdl-lint: "
                         "disable=lock-discipline -- init publication\n")
        hit, why = src.suppression_for("lock-discipline", 1)
        assert hit and why == "init publication"
        assert not src.suppression_for("env-pin", 1)[0]
        assert src.bad_suppressions == []

    def test_standalone_comment_covers_next_line(self):
        src = SourceFile("x.py", (
            "# sparkdl-lint: disable=env-pin -- bootstrap read\n"
            "import os\n"))
        assert src.suppression_for("env-pin", 2)[0]
        assert not src.suppression_for("env-pin", 3)[0]

    def test_multiple_rules_one_comment(self):
        src = SourceFile("x.py", "a = 1  # sparkdl-lint: "
                         "disable=env-pin,metric-drift -- shared reason\n")
        assert src.suppression_for("env-pin", 1)[0]
        assert src.suppression_for("metric-drift", 1)[0]

    def test_covers_whole_multiline_simple_statement(self):
        src = SourceFile("x.py", (
            "# sparkdl-lint: disable=blocking-in-hot-loop -- resolved\n"
            "outs = consume(\n"
            "    fut.result())\n"))
        assert src.suppression_for("blocking-in-hot-loop", 2)[0]
        assert src.suppression_for("blocking-in-hot-loop", 3)[0]
        assert not src.suppression_for("blocking-in-hot-loop", 4)[0]

    def test_compound_statement_is_not_blanket_covered(self):
        src = SourceFile("x.py", (
            "# sparkdl-lint: disable=sleep-poll -- loop head only\n"
            "while waiting():\n"
            "    time.sleep(1)\n"))
        assert src.suppression_for("sleep-poll", 2)[0]
        assert not src.suppression_for("sleep-poll", 3)[0]

    def test_suppression_text_inside_strings_is_ignored(self):
        src = SourceFile("x.py", (
            '"""Docs: write `# sparkdl-lint: disable=env-pin` plus a\n'
            "justification to silence a finding.\"\"\"\n"
            "msg = 'try # sparkdl-lint: disable=lock-discipline'\n"))
        assert src.suppressions == {}
        assert src.bad_suppressions == []

    @pytest.mark.parametrize("why, code, n_suppressed", [
        ("", 1, 1),                     # suppresses, but the run is red
        (" -- migration shim", 0, 1),
    ])
    def test_justification_decides_the_exit_code(self, tmp_path, why, code,
                                                  n_suppressed):
        bad = tmp_path / "pkg" / "mod.py"
        bad.parent.mkdir()
        bad.write_text(
            "import os\n"
            "x = os.environ.get('SPARKDL_TORCH_NEW_THING')"
            f"  # sparkdl-lint: disable=env-pin{why}\n")
        report = lint_paths([str(tmp_path / "pkg")], root=str(tmp_path))
        assert report.exit_code == code
        assert len(report.suppressed) == n_suppressed
        rules = {f.rule for f in report.findings}
        assert ("suppression-missing-justification" in rules) == bool(code)
        if not code:
            assert report.suppressed[0].justification == "migration shim"


# ---------------------------------------------------------------------------
# the rules, each on its bad and its ok fixture
# ---------------------------------------------------------------------------


class TestLockDiscipline:
    def test_bad_mixed_mutation(self):
        found = run_rule(LockDisciplineRule(), load("lock_bad.py"))
        assert [(f.line, "'self.depth'" in f.message) for f in found] == [
            (16, True)]

    def test_ok_propagation_and_locked_suffix(self):
        assert run_rule(LockDisciplineRule(), load("lock_ok.py")) == []

    def test_bad_acquisition_cycle(self):
        found = run_rule(LockDisciplineRule(), load("lock_cycle.py"))
        assert len(found) == 1
        assert "cycle" in found[0].message
        assert "Pool._route_lock" in found[0].message
        assert "Pool._state_lock" in found[0].message

    def test_lock_graph_nodes_are_file_qualified(self):
        body = ("import threading\n"
                "class Pool:\n"
                "    def __init__(self):\n"
                "        self._lock = threading.Lock()\n"
                "        self._cv = threading.Lock()\n"
                "    def route(self):\n"
                "        with self.{}:\n"
                "            with self.{}:\n"
                "                pass\n")
        a = SourceFile("a.py", body.format("_lock", "_cv"))
        b = SourceFile("b.py", body.format("_cv", "_lock"))
        assert run_rule(LockDisciplineRule(), a, b) == []


class TestBlockingInHotLoop:
    def test_bad_including_transitive_helpers_and_device_syncs(self):
        found = run_rule(BlockingInHotLoopRule(), load("hotloop_bad.py"))
        got = sorted((f.line, f.message.split(" in ")[0]) for f in found)
        assert got == [
            (13, "time.sleep"),
            (17, "un-timed-out .result()"),
            (18, "un-timed-out .join()"),
            (24, ".synchronize()"),
            (28, ".synchronize()"),
            (29, ".synchronize()"),
            (30, ".item()"),
        ], got

    def test_ok_timed_waits_and_cold_methods(self):
        assert run_rule(
            BlockingInHotLoopRule(), load("hotloop_ok.py")) == []


class TestMetricDrift:
    def test_bad_conflicting_shapes_and_missing_doc(self):
        found = run_rule(MetricDriftRule(), load("metric_bad.py"),
                         docs="sparkdl_lintfixture_total is documented")
        conflict = [f for f in found if "conflicting" in f.message]
        undoc = [f for f in found if "not documented" in f.message]
        assert len(conflict) == 2  # one per declaration site
        assert len(undoc) == 1
        assert "sparkdl_lintfixture_undocumented" in undoc[0].message

    def test_ok_one_documented_shape(self):
        assert run_rule(MetricDriftRule(), load("metric_ok.py"),
                        docs="`sparkdl_lintfixture_total` counter") == []
        # the same file with the family left out of the docs
        found = run_rule(MetricDriftRule(), load("metric_ok.py"))
        assert [f.line for f in found] == [8]


class TestFaultCoverage:
    def _run(self, *extra):
        return run_rule(
            FaultCoverageRule(),
            load("fault_bad.py"),
            load("fault_ok.py"),
            load("faults.py", rel="sparkdl_torch/reliability/faults.py"),
            load("fault_plans_testfile.py",
                 rel="tests/fault_plans_testfile.py"),
            load("fault_jax_testfile.py", rel="tests/fault_jax_testfile.py"),
            *extra)

    def test_bad_orphan_ghost_and_catalogue_drift(self):
        found = self._run()
        by_site = {}
        for f in found:
            site = f.message.split("'")[1]
            by_site.setdefault(site, []).append(f)
        assert sorted(by_site) == ["fixture.catalogued_only",
                                   "fixture.ghost", "fixture.jaxonly",
                                   "fixture.orphan"], sorted(by_site)
        assert "no fault plan in the port's tests" in \
            by_site["fixture.orphan"][0].message
        # only the port's tests count: the JAX test's plan covers nothing
        assert "no fault plan" in by_site["fixture.jaxonly"][0].message
        assert "no fault_point" in by_site["fixture.ghost"][0].message
        drift = by_site["fixture.catalogued_only"][0]
        assert "KNOWN_SITES lists" in drift.message
        assert drift.line == 10  # anchored at its own catalogue entry

    def test_ok_literal_parametrized_and_prefix_plans(self):
        found = {f.message.split("'")[1] for f in self._run()}
        assert not found & {"fixture.covered", "fixture.param",
                            "fixture.rank.*", "fixture.jaxghost"}

    def test_linter_skips_its_own_package(self):
        rule = FaultCoverageRule()
        src = SourceFile("x.py", "fault_point('fixture.meta')\n",
                         rel="sparkdl_torch/lint/rules.py")
        assert list(rule.check(src)) == [] and rule._sites == {}


class TestEnvPin:
    def test_bad_direct_reads(self):
        found = run_rule(EnvPinRule(), load("env_bad.py"))
        msgs = sorted(f.message for f in found)
        assert len(found) == 3, msgs
        assert sum("pin-managed" in m for m in msgs) == 2
        assert any("SPARKDL_TORCH_SP" in m for m in msgs)
        assert any("SPARKDL_TORCH_MADE_UP_KNOB" in m for m in msgs)

    def test_ok_resolver_allowlist_and_other_prefixes(self):
        assert run_rule(EnvPinRule(), load("env_ok.py")) == []

    def test_replica_pin_is_read_only_through_resolve_pin(self):
        found = run_rule(EnvPinRule(), load("env_replicas_bad.py"))
        assert [f.line for f in found] == [7]
        assert "SPARKDL_TORCH_REPLICAS" in found[0].message
        assert "pin-managed" in found[0].message
        assert run_rule(EnvPinRule(), load("env_replicas_ok.py")) == []


class TestSleepPoll:
    def test_bad_and_its_suppression_scope(self):
        src = load("sleep_poll_bad.py", rel="tests/sleep_poll_bad.py")
        found = list(SleepPollRule().check(src))
        assert sorted(f.line for f in found) == [9, 15]
        assert src.suppression_for("sleep-poll", 15)[0]
        assert not src.suppression_for("sleep-poll", 9)[0]

    def test_ok_deadlined_loops(self):
        src = load("sleep_poll_ok.py", rel="tests/sleep_poll_ok.py")
        assert list(SleepPollRule().check(src)) == []


def test_every_rule_has_a_bad_and_an_ok_fixture():
    assert [cls.name for cls in ALL_RULES] == RULE_NAMES
    stems = {"lock-discipline": "lock", "blocking-in-hot-loop": "hotloop",
             "metric-drift": "metric", "fault-coverage": "fault",
             "env-pin": "env", "sleep-poll": "sleep_poll"}
    names = set(os.listdir(FIXTURES))
    for rule in RULE_NAMES:
        assert f"{stems[rule]}_bad.py" in names, rule
        assert f"{stems[rule]}_ok.py" in names, rule
    assert list(DROPPED_RULES) == ["donation-safety"]


# ---------------------------------------------------------------------------
# CLI: exit codes + JSON golden
# ---------------------------------------------------------------------------


def _seed_project(tmp_path, *fixture_names):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (tmp_path / "tests").mkdir()
    (tmp_path / "README.md").write_text("# demo\n")
    for name in fixture_names:
        shutil.copy(os.path.join(FIXTURES, name), pkg / name)
    return tmp_path


def _run_cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "sparkdl_torch.lint", *args],
        capture_output=True, text=True, cwd=cwd, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})


class TestCLI:
    def test_clean_then_seeded_violation(self, tmp_path):
        proj = _seed_project(tmp_path, "lock_ok.py", "hotloop_ok.py",
                             "env_ok.py")
        p = _run_cli("pkg", "--root", ".", cwd=proj)
        assert p.returncode == 0, p.stdout + p.stderr
        assert "0 finding(s)" in p.stdout
        shutil.copy(os.path.join(FIXTURES, "lock_bad.py"),
                    proj / "pkg" / "lock_bad.py")
        p = _run_cli("pkg", "--root", ".", cwd=proj)
        assert p.returncode == 1
        line = [ln for ln in p.stdout.splitlines()
                if "lock-discipline" in ln]
        assert line and "pkg/lock_bad.py:16" in line[0]

    def test_unknown_rule_is_usage_error(self, tmp_path):
        p = _run_cli("--rule", "no-such-rule", ".", cwd=tmp_path)
        assert p.returncode == 2
        assert "unknown rule" in p.stderr

    def test_list_rules_names_the_dropped_rule(self, tmp_path):
        p = _run_cli("--list-rules", cwd=tmp_path)
        assert p.returncode == 0
        for rule in RULE_NAMES:
            assert rule in p.stdout
        dropped = [ln for ln in p.stdout.splitlines()
                   if ln.startswith("donation-safety")]
        assert len(dropped) == 1 and "(dropped)" in dropped[0]
        assert "donates no buffers" in dropped[0]

    def test_golden_json_report(self, tmp_path):
        proj = _seed_project(tmp_path, "lock_bad.py")
        (proj / "pkg" / "suppressed.py").write_text(
            "import os\n"
            "x = os.environ.get('SPARKDL_TORCH_GOLDEN')"
            "  # sparkdl-lint: disable=env-pin -- golden fixture\n")
        p = _run_cli("pkg", "--root", ".", "--format", "json",
                     "--output", "report.json", cwd=proj)
        assert p.returncode == 1
        doc = json.loads(p.stdout)
        on_disk = json.loads((proj / "report.json").read_text())
        doc.pop("elapsed_s")
        on_disk.pop("elapsed_s")
        assert doc == on_disk == {
            "version": 1,
            "files_scanned": 2,
            "rules": RULE_NAMES,
            "findings_total": 1,
            "suppressed_total": 1,
            "findings": [{
                "rule": "lock-discipline",
                "path": "pkg/lock_bad.py",
                "line": 16,
                "message": (
                    "Engine.reset assigns 'self.depth' outside 'with "
                    "self._lock' but other code paths assign it under "
                    "that lock — hold the lock, or suppress with the "
                    "reason it is safe here"),
            }],
            "suppressed": [{
                "rule": "env-pin",
                "path": "pkg/suppressed.py",
                "line": 2,
                "message": (
                    "direct read of SPARKDL_TORCH_GOLDEN outside "
                    "resolve_pin and the documented allowlist — give "
                    "the knob a resolve_pin contract, or add it to "
                    "lint.rules.ENV_ALLOWLIST with its reason (README: "
                    "Static analysis (port))"),
                "suppressed": True,
                "justification": "golden fixture",
            }],
        }


# ---------------------------------------------------------------------------
# walker details
# ---------------------------------------------------------------------------


def test_parse_error_is_a_finding(tmp_path):
    bad = tmp_path / "pkg" / "broken.py"
    bad.parent.mkdir()
    bad.write_text("def f(:\n")
    report = lint_paths([str(tmp_path / "pkg")], root=str(tmp_path))
    assert report.exit_code == 1
    assert report.findings[0].rule == "parse-error"


def test_lint_fixtures_dir_is_excluded_from_walks(tmp_path):
    nested = tmp_path / "pkg" / "lint_fixtures" / "torch"
    nested.mkdir(parents=True)
    shutil.copy(os.path.join(FIXTURES, "lock_bad.py"), nested / "lock_bad.py")
    report = lint_paths([str(tmp_path / "pkg")], root=str(tmp_path))
    assert report.files_scanned == 0
    assert report.exit_code == 0


@pytest.mark.parametrize("fixture, rule", [
    ("lock_bad.py", "lock-discipline"),
    ("hotloop_bad.py", "blocking-in-hot-loop"),
    ("env_bad.py", "env-pin"),
])
def test_bad_fixtures_fail_via_api(tmp_path, fixture, rule):
    proj = _seed_project(tmp_path, fixture)
    report = lint_paths([str(proj / "pkg")], root=str(proj))
    assert report.exit_code == 1
    assert rule in {f.rule for f in report.findings}


def test_partial_scans_skip_cross_set_coverage_checks(tmp_path):
    proj = _seed_project(tmp_path, "fault_bad.py", "fault_ok.py")
    shutil.copy(os.path.join(FIXTURES, "fault_plans_testfile.py"),
                proj / "tests" / "fault_plans_testfile.py")
    for scope in ("pkg", "tests"):
        report = lint_paths([str(proj / scope)], root=str(proj))
        assert report.exit_code == 0, [f.render() for f in report.findings]
    both = lint_paths([str(proj / "pkg"), str(proj / "tests")],
                      root=str(proj))
    assert {f.message.split("'")[1] for f in both.findings} == {
        "fixture.orphan", "fixture.jaxonly", "fixture.ghost"}
