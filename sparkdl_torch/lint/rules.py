"""The rules the port's sparkdl-lint ships.

Each rule encodes one convention the port relies on, carried over from
the JAX package's linter to the port's names:

* ``lock-discipline`` — in classes owning a ``threading.Lock/RLock/
  Condition``, every attribute assigned under the lock must be assigned
  under it everywhere (lock-held-ness propagates through same-class
  helper calls, so ``tick() -> self._admit()`` style decomposition does
  not false-positive); plus a cross-method lock-acquisition graph that
  rejects ordering cycles (ABBA deadlocks).
* ``blocking-in-hot-loop`` — ``time.sleep``, un-timed-out ``.result()``
  / ``.join()`` / ``.wait()``, and the torch calls that block the host
  on the device (``torch.cuda.synchronize()``, a stream's or event's
  ``.synchronize()``, ``.item()``) inside the engine tick/decode loops
  and replica worker loops (hot = the named loop methods plus everything
  they transitively call in-class).
* ``metric-drift`` — every ``sparkdl_*`` metric family must be declared
  with ONE (kind, label-set) across all call sites and appear in
  README.md/PERF.md.
* ``fault-coverage`` — every ``fault_point("x")`` site must be exercised
  by a fault plan in the port's tests, every plan-named site must exist,
  and ``faults.KNOWN_SITES`` must not drift from reality in either
  direction.
* ``env-pin`` — direct ``os.environ``/``getenv`` reads of
  ``SPARKDL_TORCH_*`` happen only inside ``resolve_pin`` or for
  variables on the documented allowlist below; pin-managed knobs NEVER
  read directly.
* ``sleep-poll`` (tests) — a ``while`` loop that ``time.sleep``-polls
  without a deadline in its condition is a flaky-soak trap; use the
  ``wait_until`` helper from conftest.

The JAX package's ``donation-safety`` rule is not carried over
(:data:`DROPPED_RULES`): the port donates no buffers, so it has nothing
to check.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Iterator

from sparkdl_torch.lint.core import (
    Finding,
    Project,
    Rule,
    SourceFile,
    dotted_name,
    str_const,
)

__all__ = ["ALL_RULES", "DROPPED_RULES"]


# ---------------------------------------------------------------------------
# shared AST utilities
# ---------------------------------------------------------------------------

#: does this attribute/name look like a mutex? (terminal segment)
_LOCKISH_RE = re.compile(r"(?:^|_)(?:lock|rlock|cv|cond|condition|mutex)$",
                         re.IGNORECASE)


def _is_lockish(expr: ast.AST) -> "str | None":
    """The dotted path of a with-item that names a lock, else None."""
    d = dotted_name(expr)
    if d is None:
        return None
    if _LOCKISH_RE.search(d.rsplit(".", 1)[-1]):
        return d
    return None


def _lock_items(node: ast.With) -> "list[str]":
    out = []
    for item in node.items:
        d = _is_lockish(item.context_expr)
        if d is not None:
            out.append(d)
    return out


def _target_paths(target: ast.AST) -> "Iterator[str]":
    """Dotted paths assigned by one assignment target (tuples flattened;
    ``x[i] = ...`` and ``x.a[i] = ...`` count as mutating ``x``/``x.a``)."""
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _target_paths(elt)
        return
    if isinstance(target, ast.Starred):
        yield from _target_paths(target.value)
        return
    if isinstance(target, ast.Subscript):
        d = dotted_name(target.value)
        if d is not None:
            yield d
        return
    d = dotted_name(target)
    if d is not None:
        yield d


def _stmt_assigned_paths(stmt: ast.stmt) -> "set[str]":
    out: set[str] = set()
    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            out.update(_target_paths(t))
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        out.update(_target_paths(stmt.target))
    return out


def _methods(cls: ast.ClassDef) -> "list[ast.FunctionDef]":
    return [n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


# ===========================================================================
# Rule 1: lock-discipline
# ===========================================================================


class _MethodScan:
    """Per-method facts for the lock rule."""

    def __init__(self) -> None:
        #: (attr_path, locked_lexically, line, lock_name_or_None)
        self.assignments: "list[tuple[str, bool, int, str | None]]" = []
        #: same-class method names called: (name, locked_lexically,
        #: lock_held_at_callsite_or_None)
        self.calls: "list[tuple[str, bool, str | None]]" = []
        #: lock-acquisition facts: with L1 containing (a) with L2 or
        #: (b) call to same-class method M — edges (L1, L2) / (L1, "call:M")
        self.nested: "list[tuple[str, str, int]]" = []
        #: locks this method acquires lexically anywhere
        self.acquires: "list[str]" = []


class LockDisciplineRule(Rule):
    name = "lock-discipline"
    description = (
        "attributes guarded by a class's lock must be assigned under it "
        "on every mutation path; lock acquisition order must be acyclic"
    )

    def __init__(self) -> None:
        #: canonical lock id -> {canonical lock id -> (path, line)}
        self._edges: "dict[str, dict[str, tuple[str, int]]]" = {}

    # -- per-file ------------------------------------------------------------
    def check(self, f: SourceFile) -> "Iterable[Finding]":
        findings: "list[Finding]" = []
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(f, node))
        return findings

    def _scan_method(self, fn: ast.FunctionDef) -> _MethodScan:
        scan = _MethodScan()

        def walk(node: ast.AST, lock_stack: "tuple[str, ...]") -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue  # nested defs have their own discipline
                stack = lock_stack
                if isinstance(child, ast.With):
                    locks = _lock_items(child)
                    for lk in locks:
                        scan.acquires.append(lk)
                        if stack:
                            scan.nested.append(
                                (stack[-1], lk, child.lineno))
                        stack = stack + (lk,)
                if isinstance(child, (ast.Assign, ast.AugAssign,
                                      ast.AnnAssign)):
                    for path in _stmt_assigned_paths(child):
                        if path.startswith("self."):
                            scan.assignments.append(
                                (path, bool(stack), child.lineno,
                                 stack[-1] if stack else None))
                if isinstance(child, ast.Call):
                    d = dotted_name(child.func)
                    if d is not None and d.startswith("self.") \
                            and d.count(".") == 1:
                        meth = d.split(".", 1)[1]
                        scan.calls.append(
                            (meth, bool(stack),
                             stack[-1] if stack else None))
                        if stack:
                            scan.nested.append(
                                (stack[-1], "call:" + meth, child.lineno))
                walk(child, stack)

        walk(fn, ())
        return scan

    def _check_class(self, f: SourceFile,
                     cls: ast.ClassDef) -> "list[Finding]":
        methods = _methods(cls)
        scans: "dict[str, _MethodScan]" = {}
        for m in methods:
            if m.name in ("__init__", "__del__", "__post_init__"):
                continue
            scans[m.name] = self._scan_method(m)
        if not scans:
            return []

        # -- lock-held propagation: a method whose every same-class call
        # site is lock-held is itself lock-held (tick() -> _admit()),
        # carrying the lock its callers held so its OWN assignments
        # guard their attributes like lexically-locked ones do.
        locks_seen = [lk for s in scans.values() for lk in s.acquires]
        default_lock = locks_seen[0] if locks_seen else "self._lock"
        held: "dict[str, str]" = {
            m: default_lock for m in scans if m.endswith("_locked")}
        changed = True
        while changed:
            changed = False
            for scan_name in scans:
                if scan_name in held:
                    continue
                effective: "list[str | None]" = []
                for other_name, other in scans.items():
                    for meth, locked, lock_at_site in other.calls:
                        if meth != scan_name:
                            continue
                        if locked:
                            effective.append(lock_at_site)
                        elif other_name in held:
                            effective.append(held[other_name])
                        else:
                            effective.append(None)
                if effective and all(e is not None for e in effective):
                    held[scan_name] = effective[0] or default_lock
                    changed = True

        guarded: "dict[str, str]" = {}  # attr -> lock name it is seen under
        for scan_name, scan in scans.items():
            ambient = held.get(scan_name)
            for path, locked, _line, lock in scan.assignments:
                if locked and lock is not None:
                    guarded.setdefault(path, lock)
                elif ambient is not None:
                    guarded.setdefault(path, ambient)

        findings: "list[Finding]" = []
        for scan_name, scan in scans.items():
            if scan_name in held:
                continue
            for path, locked, line, _lock in scan.assignments:
                if not locked and path in guarded:
                    findings.append(Finding(
                        self.name, f.rel, line,
                        f"{cls.name}.{scan_name} assigns '{path}' outside "
                        f"'with {guarded[path]}' but other code paths "
                        "assign it under that lock — hold the lock, or "
                        "suppress with the reason it is safe here",
                    ))

        # -- acquisition-order edges (cycle check runs in finalize) ----------
        def canon(lock: str) -> str:
            # file-qualified: object identity across modules is not
            # statically resolvable, and merging same-named classes
            # (two `Pool._lock`s in different files) would fabricate
            # phantom ABBA cycles — cycles are therefore detected
            # within one module's lock set, the scope the graph can
            # actually reason about
            if lock.startswith("self."):
                return f"{f.rel}:{cls.name}.{lock[5:]}"
            return f"{f.rel}:{lock}"  # global or foreign-object lock

        acquires_of = {name: set(s.acquires) for name, s in scans.items()}
        for scan_name, scan in scans.items():
            for outer, inner, line in scan.nested:
                if inner.startswith("call:"):
                    meth = inner[5:]
                    for lk in acquires_of.get(meth, ()):
                        if lk != outer:
                            self._add_edge(canon(outer), canon(lk),
                                           f.rel, line)
                elif inner != outer:
                    self._add_edge(canon(outer), canon(inner), f.rel, line)
        return findings

    def _add_edge(self, a: str, b: str, path: str, line: int) -> None:
        self._edges.setdefault(a, {}).setdefault(b, (path, line))

    # -- whole-project: cycle detection --------------------------------------
    def finalize(self, project: Project) -> "Iterable[Finding]":
        findings: "list[Finding]" = []
        color: "dict[str, int]" = {}  # 0 unvisited / 1 in-stack / 2 done
        stack: "list[str]" = []

        def visit(node: str) -> None:
            color[node] = 1
            stack.append(node)
            for nxt, (path, line) in sorted(
                    self._edges.get(node, {}).items()):
                c = color.get(nxt, 0)
                if c == 0:
                    visit(nxt)
                elif c == 1:
                    cycle = stack[stack.index(nxt):] + [nxt]
                    findings.append(Finding(
                        self.name, path, line,
                        "lock acquisition cycle: "
                        + " -> ".join(cycle)
                        + " (ABBA deadlock risk; pick one global order)",
                    ))
            stack.pop()
            color[node] = 2

        for node in sorted(self._edges):
            if color.get(node, 0) == 0:
                visit(node)
        return findings


def _iter_same_scope(node: ast.AST) -> "Iterator[ast.AST]":
    """Lexical-order walk that does NOT descend into function/lambda
    bodies — those are their own execution scopes."""
    yield node
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.Lambda)):
        return
    for child in ast.iter_child_nodes(node):
        yield from _iter_same_scope(child)


# ===========================================================================
# Rule 2: blocking-in-hot-loop
# ===========================================================================

#: the loop methods that must never block unboundedly; everything they
#: transitively call in-class inherits hotness
HOT_METHOD_NAMES = ("_loop", "_watchdog_loop", "tick", "_run_loop")


class BlockingInHotLoopRule(Rule):
    name = "blocking-in-hot-loop"
    description = (
        "no time.sleep, un-timed-out .result()/.join()/.wait(), or "
        "host-device sync (torch.cuda.synchronize, .synchronize(), "
        ".item()) inside engine tick/decode/worker loops (transitively "
        "through same-class helpers)"
    )

    def check(self, f: SourceFile) -> "Iterable[Finding]":
        findings: "list[Finding]" = []
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(f, node))
        return findings

    def _check_class(self, f: SourceFile,
                     cls: ast.ClassDef) -> "list[Finding]":
        methods = {m.name: m for m in _methods(cls)}
        hot = {n for n in methods if n in HOT_METHOD_NAMES}
        if not hot:
            return []
        # transitive closure over same-class calls
        changed = True
        while changed:
            changed = False
            for name in list(hot):
                for node in ast.walk(methods[name]):
                    if isinstance(node, ast.Call):
                        d = dotted_name(node.func)
                        if d is not None and d.startswith("self."):
                            callee = d.split(".")[1]
                            if callee in methods and callee not in hot:
                                hot.add(callee)
                                changed = True
        findings: "list[Finding]" = []
        for name in sorted(hot):
            findings.extend(self._check_hot_fn(f, cls, methods[name]))
        return findings

    def _check_hot_fn(self, f: SourceFile, cls: ast.ClassDef,
                      fn: ast.FunctionDef) -> "list[Finding]":
        findings: "list[Finding]" = []
        where = f"{cls.name}.{fn.name} (hot loop)"
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if d is None:
                if not isinstance(node.func, ast.Attribute):
                    continue
                # a method of a computed receiver:
                # ``x[0].item()``, ``current_stream().synchronize()``
                d = "<expr>." + node.func.attr
            leaf = d.rsplit(".", 1)[-1]
            has_timeout = bool(node.args) or any(
                kw.arg in ("timeout", "timeout_s", None)
                for kw in node.keywords)
            if d in ("time.sleep", "sleep"):
                findings.append(Finding(
                    self.name, f.rel, node.lineno,
                    f"time.sleep in {where}: a sleeping engine thread "
                    "stalls every rider — use a timed condition wait or "
                    "move the wait out of the loop"))
            elif leaf in ("result", "join", "wait") and "." in d \
                    and not has_timeout:
                findings.append(Finding(
                    self.name, f.rel, node.lineno,
                    f"un-timed-out .{leaf}() in {where}: if the producer "
                    "dies this wedges the loop forever — pass a timeout "
                    "(or suppress with the invariant that guarantees "
                    "resolution)"))
            elif leaf == "synchronize" and "." in d:
                findings.append(Finding(
                    self.name, f.rel, node.lineno,
                    f".synchronize() in {where}: blocks the loop until "
                    "the card "
                    "drains its queue — wait on the one event that "
                    "guards the data (runtime.completion.start_fetch) "
                    "behind the next dispatch"))
            elif leaf == "item" and "." in d and not node.args \
                    and not node.keywords:
                findings.append(Finding(
                    self.name, f.rel, node.lineno,
                    f".item() in {where}: a synchronous device-to-host "
                    "read that stalls the loop on the card — fetch with "
                    "runtime.completion.start_fetch and collect behind "
                    "the next dispatch, or read a host copy"))
        return findings


# ===========================================================================
# Rule 3: metric-drift
# ===========================================================================


class MetricDriftRule(Rule):
    name = "metric-drift"
    description = (
        "every sparkdl_* metric family keeps one (kind, label-set) "
        "across all declaration sites and is documented in README/PERF"
    )
    scope = "all"  # tests may re-declare families; they must agree too

    def __init__(self) -> None:
        #: name -> list of (kind, labels, path, line, is_test)
        self._decls: "dict[str, list]" = {}

    def check(self, f: SourceFile) -> "Iterable[Finding]":
        consts: "dict[str, str]" = {}
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                v = str_const(node.value)
                if v is not None:
                    consts.setdefault(node.targets[0].id, v)
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            kind = node.func.attr
            if kind not in ("counter", "gauge", "histogram"):
                continue
            if not node.args:
                continue
            name = str_const(node.args[0])
            if name is None and isinstance(node.args[0], ast.Name):
                name = consts.get(node.args[0].id)
            if name is None or not name.startswith("sparkdl_"):
                continue
            labels: "tuple[str, ...] | None" = ()
            for kw in node.keywords:
                if kw.arg == "labels":
                    if isinstance(kw.value, (ast.Tuple, ast.List)):
                        vals = [str_const(e) for e in kw.value.elts]
                        labels = (tuple(v for v in vals if v is not None)
                                  if all(v is not None for v in vals)
                                  else None)
                    else:
                        labels = None  # dynamic: skip consistency check
            self._decls.setdefault(name, []).append(
                (kind, labels, f.rel, node.lineno, f.is_test))
        return ()

    def finalize(self, project: Project) -> "Iterable[Finding]":
        findings: "list[Finding]" = []
        for name, decls in sorted(self._decls.items()):
            shapes = {(kind, labels) for kind, labels, *_ in decls
                      if labels is not None}
            if len(shapes) > 1:
                detail = "; ".join(
                    f"{kind} labels={list(labels)} at {path}:{line}"
                    for kind, labels, path, line, _t in decls
                    if labels is not None)
                for _kind, labels, path, line, _t in decls:
                    if labels is None:
                        continue
                    findings.append(Finding(
                        self.name, path, line,
                        f"metric family '{name}' is declared with "
                        f"conflicting shapes across call sites ({detail})"
                        " — the registry will raise at runtime when both "
                        "paths run; unify the declaration"))
            prod = [d for d in decls if not d[4]]
            if prod and name not in project.docs_text:
                _kind, _labels, path, line, _t = prod[0]
                findings.append(Finding(
                    self.name, path, line,
                    f"metric family '{name}' is not documented — add it "
                    "to the README metrics catalog (or PERF.md)"))
        return findings


# ===========================================================================
# Rule 4: fault-coverage
# ===========================================================================

_PLAN_ENV = "SPARKDL_TORCH_FAULT_PLAN"
#: shell scripts: SPARKDL_TORCH_FAULT_PLAN="..." or ='...'
_SH_PLAN_RE = re.compile(_PLAN_ENV + r"""=["']([^"']+)["']""")


#: a string that reads as a fault plan: ``site[:Exc]@N`` or ``%p``,
#: optionally after a ``seed=N;`` entry
_PLAN_LITERAL_RE = re.compile(
    r"^(?:seed=\d+;)?[A-Za-z_][\w.]*(?::[A-Za-z]\w*)?[@%]")


def _plan_sites(plan: str) -> "Iterator[str]":
    for entry in plan.split(";"):
        entry = entry.strip()
        if not entry or entry.startswith("seed="):
            continue
        site = re.split(r"[:@%]", entry, 1)[0].strip()
        if site:
            yield site


class FaultCoverageRule(Rule):
    name = "fault-coverage"
    description = (
        "every fault_point site is exercised by a fault plan in the "
        "port's tests; every plan-named site exists; faults.KNOWN_SITES "
        "does not drift from the fault_point calls, either way"
    )
    scope = "all"

    def __init__(self) -> None:
        #: site -> (path, line); sites ending '*' are f-string prefixes
        self._sites: "dict[str, tuple[str, int]]" = {}
        #: sites referenced by plans/direct hits in TESTS + aux
        self._exercised: "set[str]" = set()
        #: (site, path, line) from every plan string (existence check)
        self._plan_refs: "list[tuple[str, str, int]]" = []
        #: KNOWN_SITES literal as found in faults.py: site -> its line
        self._known_sites: "tuple[dict[str, int], str, int] | None" = None

    def check(self, f: SourceFile) -> "Iterable[Finding]":
        rel = f.rel.replace("\\", "/")
        if "sparkdl_torch/lint/" in rel or rel.startswith("lint/"):
            return ()  # the linter's own metadata strings are not plans
        if f.is_test and not f.is_port_test:
            # the JAX package's tests exercise and name the JAX
            # package's sites, never the port's
            return ()
        is_faults_mod = rel.endswith("reliability/faults.py")
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Assign) and is_faults_mod:
                for t in node.targets:
                    if dotted_name(t) == "KNOWN_SITES" and isinstance(
                            node.value, (ast.Tuple, ast.List)):
                        vals = {str_const(e): e.lineno
                                for e in node.value.elts}
                        vals.pop(None, None)
                        self._known_sites = (vals, f.rel, node.lineno)
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if d is None:
                continue
            leaf = d.rsplit(".", 1)[-1]
            if leaf == "fault_point" and node.args:
                site = str_const(node.args[0])
                if site is None and isinstance(node.args[0], ast.JoinedStr):
                    site = self._fstring_prefix(node.args[0])
                if site is None:
                    continue
                if f.is_test:
                    self._exercised.add(site.rstrip("*").rstrip("."))
                elif not is_faults_mod:
                    self._sites.setdefault(site, (f.rel, node.lineno))
            elif leaf in ("inject", "arm", "parse") and node.args:
                plan = str_const(node.args[0])
                if plan is not None:
                    self._collect_plan(plan, f, node.lineno,
                                       exercised=f.is_test)
            elif leaf in ("setenv",) and len(node.args) >= 2:
                key = str_const(node.args[0])
                if key is None:
                    # monkeypatch.setenv(faults.ENV_VAR, ...) — the
                    # constant's dotted spelling names the plan var
                    kd = dotted_name(node.args[0])
                    if kd is not None and kd.rsplit(".", 1)[-1] == \
                            "ENV_VAR":
                        key = _PLAN_ENV
                if key == _PLAN_ENV:
                    plan = str_const(node.args[1])
                    if plan is not None:
                        self._collect_plan(plan, f, node.lineno,
                                           exercised=True)
        # env dict literals / subscript assignments naming the plan var;
        # plans handed to a test through pytest.mark.parametrize
        for node in ast.walk(f.tree):
            if f.is_test and isinstance(node, ast.Call) and (
                    dotted_name(node.func) or "").endswith(".parametrize"):
                for sub in ast.walk(node):
                    plan = str_const(sub)
                    if plan is not None and _PLAN_LITERAL_RE.match(plan):
                        self._collect_plan(plan, f, sub.lineno,
                                           exercised=True)
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if k is not None and str_const(k) == _PLAN_ENV:
                        plan = str_const(v)
                        if plan is not None:
                            self._collect_plan(plan, f, node.lineno,
                                               exercised=f.is_test)
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and str_const(
                            t.slice) == _PLAN_ENV:
                        plan = str_const(node.value)
                        if plan is not None:
                            self._collect_plan(plan, f, node.lineno,
                                               exercised=f.is_test)
        return ()

    @staticmethod
    def _fstring_prefix(node: ast.JoinedStr) -> "str | None":
        if node.values and isinstance(node.values[0], ast.Constant):
            return str(node.values[0].value) + "*"
        return None

    def _collect_plan(self, plan: str, f: SourceFile, line: int,
                      exercised: bool) -> None:
        for site in _plan_sites(plan):
            self._plan_refs.append((site, f.rel, line))
            if exercised:
                self._exercised.add(site)

    def finalize(self, project: Project) -> "Iterable[Finding]":
        for name, (path, text) in project.aux.items():
            for m in _SH_PLAN_RE.finditer(text):
                line = text[:m.start()].count("\n") + 1
                for site in _plan_sites(m.group(1)):
                    self._plan_refs.append((site, path, line))
                    self._exercised.add(site)

        findings: "list[Finding]" = []
        # Coverage is a WHOLE-TREE property: a package-only scan has no
        # test plans in scope and a tests-only scan has no production
        # sites, so either direction of the check would report false
        # drift. Both cross-set checks require both sides scanned (the
        # self-clean gate always passes both); the per-file plan parsing
        # above still runs on any scope.
        scanned_tests = any(f.is_test for f in project.files)
        scanned_prod = any(not f.is_test for f in project.files)

        def matches(site: str, ref: str) -> bool:
            if site.endswith("*"):
                return ref.startswith(site[:-1]) or \
                    site[:-1].rstrip(".") == ref
            return site == ref

        if scanned_tests:
            for site, (path, line) in sorted(self._sites.items()):
                hit = any(matches(site, ref) or matches(ref + "*", site)
                          for ref in self._exercised)
                if not hit:
                    findings.append(Finding(
                        self.name, path, line,
                        f"fault site '{site}' is exercised by no fault "
                        "plan in the port's tests — add a chaos/unit "
                        "plan hitting it (an unexercised site is dead "
                        "reliability surface)"))
        if scanned_prod:
            for ref, path, line in sorted(set(self._plan_refs)):
                known = any(matches(site, ref) for site in self._sites)
                if not known:
                    findings.append(Finding(
                        self.name, path, line,
                        f"fault plan names site '{ref}' but no "
                        "fault_point(...) with that name exists in "
                        "production code — the rule would never fire"))
        if self._known_sites is not None:
            known, path, line = self._known_sites
            for site in sorted(self._sites):
                base = site.rstrip("*").rstrip(".")
                if site not in known and base not in known:
                    findings.append(Finding(
                        self.name, path, line,
                        f"faults.KNOWN_SITES is missing site '{base}' — "
                        "the catalog drifted from the fault_point calls "
                        "in production code"))
            if scanned_prod and self._sites:
                # the other way: a catalogued site that no production
                # fault_point raises (anchored at its own entry, so a
                # site whose code lands later is suppressed alone)
                bases = {s.rstrip("*").rstrip(".") for s in self._sites}
                for site, site_line in sorted(known.items()):
                    if site not in self._sites and site not in bases:
                        findings.append(Finding(
                            self.name, path, site_line,
                            f"faults.KNOWN_SITES lists '{site}' but no "
                            "fault_point(...) in production code raises "
                            "it — the catalog drifted from the code"))
        return findings


# ===========================================================================
# Rule 5: env-pin
# ===========================================================================

#: SPARKDL_TORCH_* vars the port resolves through
#: ingest.pipeline.resolve_pin: NEVER read directly.
PIN_MANAGED = {
    "SPARKDL_TORCH_PREFETCH",
    "SPARKDL_TORCH_PREFILL_CHUNK",
    "SPARKDL_TORCH_REPLICAS",
    "SPARKDL_TORCH_SP",
}

#: Documented direct-read allowlist (README "Static analysis (port)"):
#: process bootstrap/infra switches read once at import or inside their
#: own dedicated resolver, not tunable pipeline knobs.
ENV_ALLOWLIST = {
    "SPARKDL_TORCH_FAULT_PLAN": "parsed once at import so subprocess "
                                "ranks inherit the plan",
    "SPARKDL_TORCH_RETRY_BUDGET": "process-wide budget sized once at "
                                  "first use",
    "SPARKDL_TORCH_TRACE": "tracing on/off switch, read at import",
    "SPARKDL_TORCH_METRICS_PORT": "exporter opt-in, read at server start",
    "SPARKDL_TORCH_HOST_ID": "fabric host identity (a k8s pod name), "
                             "read by default_host_id() at engine "
                             "construction — infra identity, not a "
                             "tunable knob",
    "SPARKDL_TORCH_PROFILE": "profiling switch, read by maybe_profile()",
    "SPARKDL_TORCH_PROFILE_DIR": "profiling output dir",
    "SPARKDL_TORCH_PROFILE_HZ": "profiling sample rate",
    "SPARKDL_TORCH_PROFILER_PORT": "per-rank profiler port convention, "
                                   "a preflight knob",
    "SPARKDL_TORCH_SKIP_HEALTH_CHECK": "preflight escape hatch",
    "SPARKDL_TORCH_DISABLE_NATIVE": "native-extension kill switch",
    "SPARKDL_TORCH_AUTOTUNE": "autotuner default, read by "
                              "autotune_enabled()",
    "SPARKDL_TORCH_FLIGHT_DIR": "flight-recorder output dir",
    "SPARKDL_TORCH_FLIGHT_EVENTS": "flight-recorder ring size",
    "SPARKDL_TORCH_FLIGHT_MIN_INTERVAL_S": "flight-recorder rate limit",
    "SPARKDL_TORCH_FETCH_THREADS": "readback fallback pool size, sized "
                                   "once at first use",
    "SPARKDL_TORCH_CHAIN_K": "resolved by default_chain_k(), the chain-K "
                             "pin resolver (pre-dates resolve_pin; "
                             "ScanChainer registers it pinned)",
    "SPARKDL_TORCH_DISPATCH_GAP_MS": "calibration override read by "
                                     "calibrate_dispatch_gap()",
}

#: functions whose body owns the env contract
PIN_RESOLVER_FUNCS = {"resolve_pin"}


class EnvPinRule(Rule):
    name = "env-pin"
    description = (
        "direct os.environ/getenv reads of SPARKDL_TORCH_* are allowed "
        "only inside resolve_pin or for documented-allowlist variables"
    )

    def check(self, f: SourceFile) -> "Iterable[Finding]":
        findings: "list[Finding]" = []
        consts: "dict[str, str]" = {}
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                v = str_const(node.value)
                if isinstance(t, ast.Name) and v is not None:
                    consts.setdefault(t.id, v)

        def resolve(arg: ast.AST) -> "str | None":
            v = str_const(arg)
            if v is not None:
                return v
            d = dotted_name(arg)
            if d is not None:
                return consts.get(d.rsplit(".", 1)[-1])
            return None

        def scan(node: ast.AST, fn_stack: "tuple[str, ...]") -> None:
            for child in ast.iter_child_nodes(node):
                stack = fn_stack
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    stack = fn_stack + (child.name,)
                var, line = self._env_read(child, resolve)
                if var is not None and var.startswith("SPARKDL_TORCH_"):
                    findings.extend(self._judge(f, var, line, stack))
                scan(child, stack)

        scan(f.tree, ())
        return findings

    @staticmethod
    def _env_read(node: ast.AST, resolve) -> "tuple[str | None, int]":
        if isinstance(node, ast.Call):
            d = dotted_name(node.func)
            if d in ("os.environ.get", "environ.get", "os.getenv",
                     "getenv") and node.args:
                return resolve(node.args[0]), node.lineno
        if isinstance(node, ast.Subscript) and isinstance(
                getattr(node, "ctx", None), ast.Load):
            if dotted_name(node.value) in ("os.environ", "environ"):
                return resolve(node.slice), node.lineno
        return None, 0

    def _judge(self, f: SourceFile, var: str, line: int,
               fn_stack: "tuple[str, ...]") -> "Iterator[Finding]":
        if any(fn in PIN_RESOLVER_FUNCS for fn in fn_stack):
            return
        if var in PIN_MANAGED:
            yield Finding(
                self.name, f.rel, line,
                f"direct read of pin-managed {var} — this knob's "
                "explicit-arg/env conflict contract lives in "
                "ingest.pipeline.resolve_pin; route the read through it")
        elif var not in ENV_ALLOWLIST:
            yield Finding(
                self.name, f.rel, line,
                f"direct read of {var} outside resolve_pin and the "
                "documented allowlist — give the knob a resolve_pin "
                "contract, or add it to lint.rules.ENV_ALLOWLIST with "
                "its reason (README: Static analysis (port))")


# ===========================================================================
# Rule 6 (tests): sleep-poll
# ===========================================================================

_DEADLINE_NAME_RE = re.compile(
    r"deadline|timeout|until|expires|t_end|end_t", re.IGNORECASE)


def _while_is_deadlined(node: ast.While) -> bool:
    """True if the loop condition references a deadline/monotonic guard."""
    for n in ast.walk(node.test):
        d = dotted_name(n)
        if d is None:
            continue
        if d in ("time.monotonic", "time.perf_counter", "time.time"):
            return True
        if _DEADLINE_NAME_RE.search(d.rsplit(".", 1)[-1]):
            return True
    return False


def scan_sleep_polls(tree: ast.AST, rel: str) -> "list[Finding]":
    """While-loops that time.sleep-poll without a deadline in their
    condition (shared with conftest's collection-time guard)."""
    findings: "list[Finding]" = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.While) or _while_is_deadlined(node):
            continue
        for sub in _iter_same_scope(node):
            if isinstance(sub, ast.Call) and dotted_name(sub.func) in (
                    "time.sleep", "sleep"):
                findings.append(Finding(
                    "sleep-poll", rel, sub.lineno,
                    "time.sleep polling loop with no deadline in its "
                    "condition — a stuck predicate hangs the suite "
                    "(flaky-soak trap); use the wait_until fixture from "
                    "conftest, or bound the loop on time.monotonic()"))
                break
    return findings


class SleepPollRule(Rule):
    name = "sleep-poll"
    description = (
        "test while-loops that poll with time.sleep must carry a "
        "deadline (use conftest's wait_until)"
    )
    scope = "tests"

    def check(self, f: SourceFile) -> "Iterable[Finding]":
        return scan_sleep_polls(f.tree, f.rel)


ALL_RULES = (
    LockDisciplineRule,
    BlockingInHotLoopRule,
    MetricDriftRule,
    FaultCoverageRule,
    EnvPinRule,
    SleepPollRule,
)

#: The JAX package's rules the port does not ship, each with its reason
#: (printed by ``--list-rules``).
DROPPED_RULES = {
    "donation-safety": (
        "not carried over: it flags reads of a buffer donated to "
        "jax.jit(donate_argnums=...) or chain_carry; the port donates no "
        "buffers (a CUDA graph reads and writes its own static buffers "
        "in place), so there is nothing to check"),
}
