"""Framework for the port's sparkdl-lint: file model, rule protocol,
runner, reports.

Design constraints:

* **Zero dependencies.** stdlib ``ast``/``re``/``json`` only — the
  linter runs before anything heavy imports.
* **Line-scoped suppressions with required justification.**
  ``# sparkdl-lint: disable=rule-a,rule-b -- why this is safe`` on the
  flagged line (or alone on the line directly above). A suppression with
  no ``--`` justification is itself a finding
  (``suppression-missing-justification``), so "disabled because it was
  noisy" can never land silently.
* **Two-phase rules.** :meth:`Rule.check` sees one file at a time;
  :meth:`Rule.finalize` sees the whole :class:`Project` — the
  cross-file rules (metric drift, fault-site coverage, lock-order
  cycles) accumulate in ``check`` and report in ``finalize``.
* **Exit-code contract.** 0 clean, 1 active findings, 2 usage/internal
  error.

Scopes: production is everything that is not a test (``sparkdl_torch/``,
``chip_smoke.py``, ``tools/``); a test is a file under ``tests/``. Of
the tests, the port's own are the ones that import ``sparkdl_torch``
(:attr:`SourceFile.is_port_test`): only they count for the port's
fault-site coverage.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import time
from typing import Any, Iterable, Iterator

__all__ = [
    "Finding",
    "LintReport",
    "Project",
    "Rule",
    "SourceFile",
    "dotted_name",
    "lint_paths",
    "str_const",
]

#: Comment grammar. The justification is everything after ``--``.
SUPPRESS_RE = re.compile(
    r"#\s*sparkdl-lint:\s*disable=([A-Za-z0-9_-]+(?:\s*,\s*[A-Za-z0-9_-]+)*)"
    r"(?:\s+--\s*(\S.*?))?\s*$"
)

#: Directory names never scanned (fixture corpora hold deliberate
#: violations for the linter's own tests; __pycache__ holds bytecode).
EXCLUDED_DIRS = ("__pycache__", "lint_fixtures")


# ---------------------------------------------------------------------------
# AST helpers shared by every rule
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> "str | None":
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def str_const(node: ast.AST) -> "str | None":
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# ---------------------------------------------------------------------------
# File model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    justification: "str | None" = None

    def as_dict(self) -> dict:
        out: dict[str, Any] = {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }
        if self.suppressed:
            out["suppressed"] = True
            out["justification"] = self.justification
        return out

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class SourceFile:
    """One parsed Python file plus its suppression map."""

    def __init__(self, path: str, text: str, rel: "str | None" = None):
        self.path = path
        self.rel = rel if rel is not None else path
        self.text = text
        self.lines = text.splitlines()
        self.tree: "ast.AST | None" = None
        self.parse_error: "str | None" = None
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:  # surfaced as a finding by the runner
            self.parse_error = f"{e.msg} (line {e.lineno})"
        #: line -> {rule: justification-or-None}. A suppression comment
        #: alone on a line also covers the NEXT line (the flagged
        #: statement's first line).
        self.suppressions: dict[int, dict[str, "str | None"]] = {}
        #: (line, rules) of suppressions lacking justification text
        self.bad_suppressions: list[tuple[int, str]] = []
        self._scan_suppressions()

    def _comment_lines(self) -> "Iterator[tuple[int, str]]":
        """(line, comment-text) for every REAL comment token — the
        suppression grammar must never match '# sparkdl-lint: ...'
        examples inside docstrings or string literals (a doc example
        without '--' would fail the gate; one inside a log string would
        silently suppress)."""
        import io
        import tokenize

        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    yield tok.start[0], tok.string
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # unparseable file: the runner already reports parse-error;
            # no suppressions is the safe default
            return

    def _scan_suppressions(self) -> None:
        spans = self._simple_stmt_spans()
        for i, comment in self._comment_lines():
            line = self.lines[i - 1]
            m = SUPPRESS_RE.search(comment)
            if m is None:
                continue
            rules = [r.strip() for r in m.group(1).split(",")]
            justification = m.group(2)
            if justification is None:
                self.bad_suppressions.append((i, m.group(1)))
            targets = {i}
            if line.lstrip().startswith("#"):
                targets.add(i + 1)  # standalone comment covers below
            # a target that OPENS a multi-line simple statement covers
            # the whole statement — findings anchor to the line of the
            # offending expression, which black-style wrapping may have
            # pushed onto a continuation line
            for t in list(targets):
                end = spans.get(t)
                if end is not None:
                    targets.update(range(t, end + 1))
            for t in targets:
                slot = self.suppressions.setdefault(t, {})
                for r in rules:
                    slot[r] = justification

    def _simple_stmt_spans(self) -> "dict[int, int]":
        """first line -> last line of every multi-line SIMPLE statement.
        Compound statements (if/for/with/def...) are excluded on
        purpose: a suppression above a loop must not blanket its whole
        body."""
        spans: "dict[int, int]" = {}
        if self.tree is None:
            return spans
        compound = (ast.If, ast.For, ast.AsyncFor, ast.While, ast.With,
                    ast.AsyncWith, ast.Try, ast.FunctionDef,
                    ast.AsyncFunctionDef, ast.ClassDef, ast.Match)
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.stmt) or isinstance(
                    node, compound):
                continue
            end = getattr(node, "end_lineno", None)
            if end is not None and end > node.lineno:
                prev = spans.get(node.lineno)
                spans[node.lineno] = max(prev or 0, end)
        return spans

    def suppression_for(self, rule: str, line: int) -> "tuple[bool, str | None]":
        slot = self.suppressions.get(line)
        if slot and rule in slot:
            return True, slot[rule]
        return False, None

    # -- classification used by rule scopes ---------------------------------
    @property
    def is_port_test(self) -> bool:
        """A test that imports the port (``import sparkdl_torch...`` or
        ``from sparkdl_torch... import``): the JAX package's own tests
        neither cover nor name the port's fault sites."""
        if not self.is_test or self.tree is None:
            return False
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            elif isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            else:
                continue
            if any(m == "sparkdl_torch" or m.startswith("sparkdl_torch.")
                   for m in mods):
                return True
        return False

    @property
    def is_test(self) -> bool:
        parts = self.rel.replace(os.sep, "/").split("/")
        return ("tests" in parts
                or os.path.basename(self.rel).startswith("test_")
                or os.path.basename(self.rel) == "conftest.py")


class Project:
    """Everything one lint run sees: parsed files + auxiliary texts."""

    def __init__(self, files: "list[SourceFile]",
                 aux: "dict[str, tuple[str, str]]",
                 docs_text: str = ""):
        self.files = files
        #: name -> (path, text): non-Python inputs rules regex-scan
        #: (shell scripts' fault plans live here)
        self.aux = aux
        #: concatenated README.md + PERF.md (metric-doc coverage source)
        self.docs_text = docs_text


# ---------------------------------------------------------------------------
# Rule protocol
# ---------------------------------------------------------------------------


class Rule:
    """Base class: subclasses set ``name``/``description`` and override
    :meth:`check` (per-file) and/or :meth:`finalize` (whole-project)."""

    name: str = ""
    description: str = ""
    #: which files check() sees: "production" (sparkdl_torch,
    #: chip_smoke.py, tools — everything that is not a test), "tests",
    #: or "all"
    scope: str = "production"

    def wants(self, f: SourceFile) -> bool:
        if self.scope == "all":
            return True
        return f.is_test == (self.scope == "tests")

    def check(self, f: SourceFile) -> "Iterable[Finding]":
        return ()

    def finalize(self, project: Project) -> "Iterable[Finding]":
        return ()


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LintReport:
    """Outcome of one run: active findings gate, suppressed ones audit."""

    findings: "list[Finding]"
    suppressed: "list[Finding]"
    files_scanned: int
    rules: "list[str]"
    elapsed_s: float

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def as_dict(self) -> dict:
        return {
            "version": 1,
            "files_scanned": self.files_scanned,
            "rules": self.rules,
            "findings_total": len(self.findings),
            "suppressed_total": len(self.suppressed),
            "elapsed_s": round(self.elapsed_s, 3),
            "findings": [f.as_dict() for f in self.findings],
            "suppressed": [f.as_dict() for f in self.suppressed],
        }

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), indent=2, sort_keys=False)

    def render_text(self) -> str:
        lines = [f.render() for f in self.findings]
        lines.append(
            f"sparkdl-lint: {len(self.findings)} finding(s), "
            f"{len(self.suppressed)} suppressed, {self.files_scanned} "
            f"file(s) in {self.elapsed_s:.2f}s"
        )
        return "\n".join(lines)


def _walk_py(path: str) -> "Iterator[str]":
    for root, dirs, names in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in EXCLUDED_DIRS)
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(root, name)


def _load_docs(root: str) -> str:
    chunks = []
    for name in ("README.md", "PERF.md"):
        p = os.path.join(root, name)
        if os.path.isfile(p):
            with open(p, encoding="utf-8") as fh:
                chunks.append(fh.read())
    return "\n".join(chunks)


def collect_project(paths: "Iterable[str]",
                    root: "str | None" = None) -> Project:
    """Build a :class:`Project` from files/dirs. ``.py`` paths parse;
    anything else (and an auto-discovered ``run-tests.sh`` next to
    ``root``, whose plans name the JAX package's variable and so
    exercise none of the port's sites) becomes an aux text. ``root`` (default: cwd) anchors
    README/PERF doc loading and relative display paths."""
    root = os.path.abspath(root if root is not None else os.getcwd())
    files: "list[SourceFile]" = []
    aux: "dict[str, tuple[str, str]]" = {}
    seen: set[str] = set()

    def rel(p: str) -> str:
        ap = os.path.abspath(p)
        if ap.startswith(root + os.sep):
            return os.path.relpath(ap, root)
        return p

    def add_py(p: str) -> None:
        ap = os.path.abspath(p)
        if ap in seen:
            return
        seen.add(ap)
        with open(ap, encoding="utf-8") as fh:
            files.append(SourceFile(ap, fh.read(), rel=rel(p)))

    for path in paths:
        if os.path.isdir(path):
            for p in _walk_py(path):
                add_py(p)
        elif path.endswith(".py"):
            add_py(path)
        else:
            with open(path, encoding="utf-8") as fh:
                aux[os.path.basename(path)] = (rel(path), fh.read())
    rt = os.path.join(root, "run-tests.sh")
    if "run-tests.sh" not in aux and os.path.isfile(rt):
        with open(rt, encoding="utf-8") as fh:
            aux["run-tests.sh"] = (rel(rt), fh.read())
    return Project(files, aux, docs_text=_load_docs(root))


def lint_paths(paths: "Iterable[str]", *,
               rules: "list[Rule] | None" = None,
               root: "str | None" = None) -> LintReport:
    """Run ``rules`` (default: every registered rule) over ``paths``."""
    if rules is None:
        from sparkdl_torch.lint.rules import ALL_RULES

        rules = [cls() for cls in ALL_RULES]
    t0 = time.perf_counter()
    project = collect_project(paths, root=root)
    raw: "list[Finding]" = []
    for f in project.files:
        if f.parse_error is not None:
            raw.append(Finding("parse-error", f.rel, 1,
                               f"cannot parse: {f.parse_error}"))
            continue
        for line, rules_txt in f.bad_suppressions:
            raw.append(Finding(
                "suppression-missing-justification", f.rel, line,
                f"suppression of [{rules_txt}] carries no justification — "
                "append ' -- <why this is safe>'"))
        for rule in rules:
            if rule.wants(f):
                raw.extend(rule.check(f))
    for rule in rules:
        raw.extend(rule.finalize(project))

    by_rel = {f.rel: f for f in project.files}
    active: "list[Finding]" = []
    suppressed: "list[Finding]" = []
    for finding in raw:
        src = by_rel.get(finding.path)
        if src is not None and finding.rule != \
                "suppression-missing-justification":
            hit, justification = src.suppression_for(
                finding.rule, finding.line)
            if hit:
                finding.suppressed = True
                finding.justification = justification
                suppressed.append(finding)
                continue
        active.append(finding)
    key = (lambda f: (f.path, f.line, f.rule, f.message))
    active.sort(key=key)
    suppressed.sort(key=key)
    return LintReport(
        findings=active,
        suppressed=suppressed,
        files_scanned=len(project.files),
        rules=[r.name for r in rules],
        elapsed_s=time.perf_counter() - t0,
    )
