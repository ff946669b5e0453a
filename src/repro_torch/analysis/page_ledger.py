"""Page-ledger ownership pass.

``PagedKVCache._release`` is THE refcount-aware free path: a page returns to
the free list only when its last reference drops, and every release site —
retirement, preemption, speculative rollback, deadline cancellation, prefix
eviction — must route through it. This pass proves that property statically
over ``serving/{cache,engine,pool,prefix}.py``:

* ``ledger-free-escape`` — any mutation of a ``_free`` list (append/extend/
  pop/insert/remove/clear, augmented or plain assignment, ``del``) outside
  the sanctioned owners ``PagedKVCache.{__init__,_take,_release}``. Reads
  (``len(self._free)``, membership tests) are fine; putting pages back or
  taking them out anywhere else bypasses the refcount ledger.
* ``ledger-ref-escape`` — any write to a ``ref[...]`` refcount slot outside
  the same owners, except ``+=`` (acquiring a reference is always safe —
  it can only delay a free; decrementing or overwriting outside
  ``_release`` is how double frees are born).

The two intentional exceptions (``hold_pages`` / ``release_pages``, the
external page-pressure hooks) are recorded in ``analysis.allowlist`` with
their justification, not silently skipped here. The rules and their
behaviour are those of ``repro.analysis.page_ledger``, over the port's
``serving`` package.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional

from .report import Finding

LEDGER_FILES = ("cache.py", "engine.py", "pool.py", "prefix.py")
# the only method names allowed to mutate a free list / write refcounts:
# construction, the allocate choke point, and the release choke point
SANCTIONED = frozenset({"__init__", "_take", "_release"})
_MUTATORS = frozenset({"append", "extend", "pop", "insert", "remove",
                       "clear", "__iadd__"})
RULES = frozenset({"ledger-free-escape", "ledger-ref-escape"})


def _is_free_attr(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "_free"


def _is_ref_subscript(node: ast.AST) -> bool:
    return (isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Attribute)
            and node.value.attr == "ref")


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, rules: frozenset):
        self.path = path
        self.rules = rules
        self.stack: List[str] = []   # class/function name nesting
        self.findings: List[Finding] = []

    # ------------------------------------------------------------- scoping
    def _qualname(self) -> str:
        return ".".join(self.stack) or "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _sanctioned(self) -> bool:
        return any(part in SANCTIONED for part in self.stack)

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        if rule in self.rules and not self._sanctioned():
            self.findings.append(Finding(
                rule=rule, path=self.path, line=node.lineno,
                symbol=self._qualname(), message=msg))

    # ------------------------------------------------------------- free list
    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS \
                and _is_free_attr(fn.value):
            self._emit("ledger-free-escape", node,
                       f"free-list .{fn.attr}() outside the refcount-aware "
                       "_take/_release choke points")
        self.generic_visit(node)

    def _check_target(self, tgt: ast.AST, node: ast.AST, aug: bool) -> None:
        if _is_free_attr(tgt) or (isinstance(tgt, ast.Subscript)
                                  and _is_free_attr(tgt.value)):
            self._emit("ledger-free-escape", node,
                       "free-list assignment outside _take/_release")
        elif _is_ref_subscript(tgt) and not aug:
            self._emit("ledger-ref-escape", node,
                       "refcount overwrite outside _take/_release")

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._check_target(tgt, node, aug=False)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        tgt = node.target
        if _is_free_attr(tgt):
            self._emit("ledger-free-escape", node,
                       "free-list augmented assignment outside "
                       "_take/_release")
        elif _is_ref_subscript(tgt) and not isinstance(node.op, ast.Add):
            # += acquires a reference (safe anywhere: it can only delay a
            # free); -= and friends release and must go through _release
            self._emit("ledger-ref-escape", node,
                       "refcount decrement outside _release")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            if _is_free_attr(tgt) or (isinstance(tgt, ast.Subscript)
                                      and _is_free_attr(tgt.value)):
                self._emit("ledger-free-escape", node,
                           "free-list deletion outside _take/_release")
        self.generic_visit(node)


def check_file(path: Path, rel: str,
               rules: Optional[frozenset] = None) -> List[Finding]:
    tree = ast.parse(path.read_text(), filename=str(path))
    v = _Visitor(rel, RULES if rules is None else frozenset(rules))
    v.visit(tree)
    return v.findings


def run(root: Path, rules: Optional[frozenset] = None) -> List[Finding]:
    """``root`` is the ``src/repro_torch`` tree (or a fixture tree
    mirroring it: any directory containing the serving modules to
    audit)."""
    serving = root / "serving"
    files = [serving / n for n in LEDGER_FILES] if serving.is_dir() \
        else sorted(root.rglob("*.py"))
    out: List[Finding] = []
    for p in files:
        if p.is_file():
            out.extend(check_file(p, p.relative_to(root).as_posix(), rules))
    return out
