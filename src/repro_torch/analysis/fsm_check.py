"""Scheduler FSM verifier.

AST-extracts every request/slot state write (``<obj>.state = X``), state
comparison (``<obj>.state == X``), finish-reason write and finish-reason
call-site literal from ``serving/{scheduler,engine,pool}.py`` and checks
them against the declared lifecycle (``fsm_spec.FsmSpec``):

* ``fsm-undeclared-site``  — a function writes a state the spec doesn't
  grant it (new writer, or a declared writer emitting a new state).
* ``fsm-stale-spec``       — a declared site/edge no longer exists in the
  source (the spec must shrink with the code).
* ``fsm-undeclared-edge``  — a site's declared edges aren't all in
  ``scheduler.TRANSITIONS``, or a TRANSITIONS edge is drivable by no site.
* ``fsm-graph``            — unreachable state, a non-terminal dead end, a
  terminal with outgoing edges, or an initial-state default that isn't the
  declared initial.
* ``fsm-unknown-state``    — a state comparison/assignment resolves to a
  string that is not a declared state.
* ``fsm-finish-reason``    — a finish-reason literal outside the declared
  set, a reason site assigning ``.finish_reason`` != exactly once, a
  ``finish_reason`` write outside the declared reason sites, or a
  ``sched.retire()`` call outside a reason site (terminal paths must
  assign exactly one reason).

State values are resolved through module-level string constants and
``from ... import`` aliases of the spec's named states; writes whose value
can't be resolved to a string (e.g. ``RecurrentStatePool``'s
``self.state``, a dict of device tensors) are ignored — they are not
lifecycle writes. The rules and their behaviour are those of
``repro.analysis.fsm_check``; the spec is the port's own (``fsm_spec``).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .fsm_spec import FsmSpec, default_spec
from .report import Finding

RULES = frozenset({
    "fsm-undeclared-site", "fsm-stale-spec", "fsm-undeclared-edge",
    "fsm-graph", "fsm-unknown-state", "fsm-finish-reason",
})
FSM_FILES = ("scheduler.py", "engine.py", "pool.py")


class _ModuleFacts(ast.NodeVisitor):
    """Everything the checker needs from one module's AST."""

    def __init__(self, consts: Dict[str, str]):
        self.consts = consts                    # Name -> state string
        self.stack: List[str] = []
        self.class_stack: List[str] = []
        # (qualname, state, line) for ``.state = X`` writes in functions
        self.writes: List[Tuple[str, str, int]] = []
        # (class qualname, state, line) for class-body ``state = X`` defaults
        self.defaults: List[Tuple[str, str, int]] = []
        # (qualname, state-string, line) where resolution succeeded
        self.compares: List[Tuple[str, str, int]] = []
        # (qualname, line) of .finish_reason writes inside functions
        self.reason_writes: List[Tuple[str, int]] = []
        # (qualname, literal, line) of reason literals passed to
        # _retire/_finish_unslotted, plus literals compared to .finish_reason
        self.reason_literals: List[Tuple[str, str, int]] = []
        # (qualname, line) of calls to a scheduler ``.retire(...)``
        self.retire_calls: List[Tuple[str, int]] = []

    # --------------------------------------------------------------- helpers
    def _qual(self) -> str:
        return ".".join(self.stack) or "<module>"

    def _resolve(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return self.consts.get(node.id)
        return None

    # --------------------------------------------------------------- scoping
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.class_stack.append(".".join(self.stack))
        for item in node.body:
            tgt = val = None
            if isinstance(item, ast.AnnAssign) and item.value is not None:
                tgt, val = item.target, item.value
            elif isinstance(item, ast.Assign) and len(item.targets) == 1:
                tgt, val = item.targets[0], item.value
            if isinstance(tgt, ast.Name) and tgt.id == "state":
                state = self._resolve(val)
                if state is not None:
                    self.defaults.append((self._qual(), state, item.lineno))
        self.generic_visit(node)
        self.class_stack.pop()
        self.stack.pop()

    def visit_FunctionDef(self, node) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and node.module.split(".")[-1] == "scheduler":
            for alias in node.names:
                if alias.name in self.consts:
                    self.consts[alias.asname or alias.name] = \
                        self.consts[alias.name]
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        # module-level string constants double as state names for fixtures
        if not self.stack and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            self.consts.setdefault(node.targets[0].id, node.value.value)
        for tgt in node.targets:
            self._check_attr_write(tgt, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_attr_write(node.target, node)
        self.generic_visit(node)

    def _check_attr_write(self, tgt: ast.AST, node: ast.AST) -> None:
        if not (isinstance(tgt, ast.Attribute) and self.stack):
            return
        val = getattr(node, "value", None)
        if tgt.attr == "state":
            state = self._resolve(val)
            if state is not None:
                self.writes.append((self._qual(), state, node.lineno))
        elif tgt.attr == "finish_reason":
            self.reason_writes.append((self._qual(), node.lineno))
            lit = val.value if isinstance(val, ast.Constant) \
                and isinstance(val.value, str) else None
            if lit is not None:
                self.reason_literals.append((self._qual(), lit, node.lineno))

    def visit_Compare(self, node: ast.Compare) -> None:
        sides = [node.left] + list(node.comparators)
        attrs = {s.attr for s in sides if isinstance(s, ast.Attribute)}
        for s in sides:
            if "state" in attrs and not isinstance(s, ast.Attribute):
                state = self._resolve(s)
                if state is not None:
                    self.compares.append((self._qual(), state, node.lineno))
            if "finish_reason" in attrs and isinstance(s, ast.Constant) \
                    and isinstance(s.value, str):
                self.reason_literals.append(
                    (self._qual(), s.value, node.lineno))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr == "retire" and isinstance(fn.value, ast.Attribute) \
                    and "sched" in fn.value.attr:
                self.retire_calls.append((self._qual(), node.lineno))
            if fn.attr in ("_retire", "_finish_unslotted"):
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    if isinstance(arg, ast.Constant) \
                            and isinstance(arg.value, str):
                        self.reason_literals.append(
                            (self._qual(), arg.value, node.lineno))
        self.generic_visit(node)


def _extract(path: Path, spec: FsmSpec) -> _ModuleFacts:
    facts = _ModuleFacts(dict(spec.states_by_name))
    facts.visit(ast.parse(path.read_text(), filename=str(path)))
    return facts


def check(files: Dict[str, Path], spec: Optional[FsmSpec] = None,
          rules: Optional[frozenset] = None) -> List[Finding]:
    """``files`` maps module keys ("scheduler"/"engine"/"pool") to paths."""
    spec = spec or default_spec()
    rules = RULES if rules is None else frozenset(rules)
    out: List[Finding] = []

    def emit(rule: str, path: str, line: int, symbol: str, msg: str) -> None:
        if rule in rules:
            out.append(Finding(rule=rule, path=path, line=line,
                               symbol=symbol, message=msg))

    states = set(spec.states)
    seen_sites: Set[Tuple[str, str]] = set()
    seen_initial: Set[Tuple[str, str]] = set()
    for key, path in files.items():
        facts = _extract(path, spec)
        rel = path.name
        for qual, state, line in facts.writes:
            if state not in states:
                emit("fsm-unknown-state", rel, line, qual,
                     f"state write {state!r} is not a declared state")
                continue
            site = (key, qual)
            seen_sites.add(site)
            allowed = {e[1] for e in spec.assignment_sites.get(site, ())}
            if state not in allowed:
                emit("fsm-undeclared-site", rel, line, qual,
                     f"writes state {state!r} but the spec declares "
                     f"{sorted(allowed) if allowed else 'no writes'} "
                     "for this site")
        for qual, state, line in facts.defaults:
            if state not in states:
                emit("fsm-unknown-state", rel, line, qual,
                     f"state default {state!r} is not a declared state")
            elif (key, qual) in spec.initial_sites:
                seen_initial.add((key, qual))
                if state != spec.initial:
                    emit("fsm-graph", rel, line, qual,
                         f"initial state default {state!r} != declared "
                         f"initial {spec.initial!r}")
            else:
                emit("fsm-undeclared-site", rel, line, qual,
                     f"undeclared state default {state!r} (not an "
                     "initial site)")
        for qual, state, line in facts.compares:
            if state not in states:
                emit("fsm-unknown-state", rel, line, qual,
                     f"comparison against {state!r}, not a declared state")
        for qual, lit, line in facts.reason_literals:
            if lit not in spec.finish_reasons:
                emit("fsm-finish-reason", rel, line, qual,
                     f"finish reason {lit!r} not in "
                     f"{tuple(spec.finish_reasons)}")
        reason_by_fn: Dict[str, int] = {}
        for qual, line in facts.reason_writes:
            reason_by_fn[qual] = reason_by_fn.get(qual, 0) + 1
        for qual, n in reason_by_fn.items():
            site = (key, qual)
            if site in spec.reason_sites:
                if n != 1:
                    emit("fsm-finish-reason", rel, 0, qual,
                         f"reason site assigns finish_reason {n} times "
                         "(must be exactly once)")
            else:
                emit("fsm-finish-reason", rel, 0, qual,
                     "assigns finish_reason outside the declared reason "
                     "sites")
        for qual, line in facts.retire_calls:
            if (key, qual) not in spec.reason_sites:
                emit("fsm-finish-reason", rel, line, qual,
                     "calls scheduler retire() outside a reason site — "
                     "this terminal path assigns no finish reason")

    # ---------------------------------------------------- spec reconciliation
    for site, edges in spec.assignment_sites.items():
        if site[0] in files and site not in seen_sites:
            emit("fsm-stale-spec", f"{site[0]}.py", 0, site[1],
                 "declared assignment site no longer writes any state")
        for e in edges:
            if e not in spec.edges:
                emit("fsm-undeclared-edge", "fsm_spec.py", 0, site[1],
                     f"site edge {e} missing from scheduler.TRANSITIONS")
    for site in spec.initial_sites:
        if site[0] in files and site not in seen_initial:
            emit("fsm-stale-spec", f"{site[0]}.py", 0, site[1],
                 "declared initial site has no state default")
    drivable = {e for edges in spec.assignment_sites.values() for e in edges}
    for e in spec.edges:
        if e not in drivable:
            emit("fsm-undeclared-edge", "fsm_spec.py", 0, "TRANSITIONS",
                 f"edge {e} is drivable by no declared site — dead edge")

    # ------------------------------------------------------- graph properties
    succ: Dict[str, Set[str]] = {s: set() for s in states}
    for a, b in spec.edges:
        for s in (a, b):
            if s not in states:
                emit("fsm-unknown-state", "fsm_spec.py", 0, "TRANSITIONS",
                     f"edge {(a, b)} uses undeclared state {s!r}")
        if a in succ:
            succ[a].add(b)
    reach = {spec.initial}
    frontier = [spec.initial]
    while frontier:
        for nxt in succ.get(frontier.pop(), ()):
            if nxt not in reach:
                reach.add(nxt)
                frontier.append(nxt)
    for s in states:
        if s not in reach:
            emit("fsm-graph", "fsm_spec.py", 0, s,
                 f"state {s!r} unreachable from {spec.initial!r}")
        if s in spec.terminal and succ.get(s):
            emit("fsm-graph", "fsm_spec.py", 0, s,
                 f"terminal state {s!r} has outgoing edges "
                 f"{sorted(succ[s])}")
        if s not in spec.terminal and not succ.get(s) and s in reach:
            emit("fsm-graph", "fsm_spec.py", 0, s,
                 f"non-terminal state {s!r} is a dead end")
    # terminal reachable from every reachable state
    pred: Dict[str, Set[str]] = {s: set() for s in states}
    for a, b in spec.edges:
        if b in pred:
            pred[b].add(a)
    can_finish = set(spec.terminal)
    frontier = list(spec.terminal)
    while frontier:
        for prv in pred.get(frontier.pop(), ()):
            if prv not in can_finish:
                can_finish.add(prv)
                frontier.append(prv)
    for s in reach - can_finish:
        emit("fsm-graph", "fsm_spec.py", 0, s,
             f"no path from {s!r} to a terminal state")
    return out


def run(root: Path, spec: Optional[FsmSpec] = None,
        rules: Optional[frozenset] = None) -> List[Finding]:
    serving = root / "serving"
    files = {name[:-3]: serving / name for name in FSM_FILES
             if (serving / name).is_file()}
    if not files:     # fixture layout: loose modules keyed by stem
        files = {p.stem: p for p in sorted(root.glob("*.py"))}
    return check(files, spec=spec, rules=rules)
