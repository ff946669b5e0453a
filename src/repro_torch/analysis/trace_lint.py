"""Hot-path lint over ``src/repro_torch``: host syncs, wall-clock stamps
and mutable defaults.

The serving step must stay device-async: each read of a device value on
the host waits for every kernel queued before it, so a stray sync in the
per-step code turns the host's lead over the card into idle time. Rules:

* ``host-sync``       — inside any function of ``serving/`` or
  ``models/``: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.to("cpu")`` (or ``device="cpu"``) and ``torch.cuda.synchronize()``;
  and ``bool()`` / ``int()`` / ``float()`` or an ``if`` / ``while`` test
  applied directly to a ``torch.*`` call or to a tensor reduction method
  (``.any()``, ``.all()``, ``.sum()``, ``.max()``, ``.min()``). A
  function that reads back by design carries an allowlist entry with its
  reason.
* ``wall-clock``      — ``time.time()`` / ``time.perf_counter()`` /
  ``datetime.now()`` in serving paths (``serving/`` modules and
  ``launch/serve.py``). All serving stamps are ``time.monotonic()`` so
  wall-clock jumps can't corrupt latency/deadline arithmetic.
* ``mutable-default`` — a mutable literal (``[]``/``{}``/``set()``...)
  as a function parameter default or a dataclass field default.

The static analysis of the JAX package (``repro.analysis.trace_lint``)
also has three jit rules (``trace-branch``, ``static-arg-unknown``,
``unhashable-static``). They have no object here: the port compiles
nothing per call (no ``jax.jit``, ``torch.compile`` or ``torch.jit``), so
there is no traced value to branch on and no static compile key. Its
``host-sync`` rule looks only at ``.item()`` and at syncs inside jitted
code; this one knows the ways a PyTorch tensor reaches the host.
``wall-clock`` and ``mutable-default`` behave as the reference's.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional

from .report import Finding

RULES = frozenset({"host-sync", "wall-clock", "mutable-default"})
_WALL_CLOCK = {("time", "time"), ("time", "perf_counter"),
               ("datetime", "now")}
_READBACK = ("item", "tolist", "cpu", "numpy")
_REDUCTIONS = ("any", "all", "sum", "max", "min")
_HOT_DIRS = ("serving/", "models/")


def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _is_torch_call(node: ast.AST) -> bool:
    """A call of ``torch.<anything>``."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    while isinstance(fn, ast.Attribute):
        fn = fn.value
    return isinstance(fn, ast.Name) and fn.id == "torch" \
        and isinstance(node.func, ast.Attribute)


def _is_reduction(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in _REDUCTIONS)


def _device_value(node: ast.AST) -> Optional[str]:
    """What a truth or number conversion of ``node`` would read back, or
    None."""
    if _is_torch_call(node):
        return "a torch.* call"
    if _is_reduction(node):
        return f"a .{node.func.attr}() reduction"
    return None


def _unhashable(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in ("list", "dict", "set"))


class _Lint:
    def __init__(self, rel: str, tree: ast.Module, rules: frozenset):
        self.rel = rel
        self.tree = tree
        self.rules = rules
        self.findings: List[Finding] = []
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.is_serving = "serving/" in rel or rel.endswith("launch/serve.py")
        self.is_hot = any(d in rel for d in _HOT_DIRS)

    def emit(self, rule: str, node: ast.AST, symbol: str, msg: str) -> None:
        if rule in self.rules:
            self.findings.append(Finding(
                rule=rule, path=self.rel,
                line=getattr(node, "lineno", 0), symbol=symbol, message=msg))

    def _qualname(self, node: ast.AST) -> str:
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None and not isinstance(cur, ast.Module):
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            elif isinstance(cur, ast.Lambda):
                parts.append("<lambda>")
            cur = self.parents.get(cur)
        return ".".join(reversed(parts)) or "<module>"

    def _in_function(self, node: ast.AST) -> bool:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return True
            cur = self.parents.get(cur)
        return False

    # ------------------------------------------------------------ host sync
    def _check_host_sync(self, node: ast.AST) -> None:
        if not (self.is_hot and self._in_function(node)):
            return
        what = None
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _READBACK \
                    and not node.args:
                what = f".{fn.attr}()"
            elif isinstance(fn, ast.Attribute) and fn.attr == "to" and (
                    (node.args and _is_cpu(node.args[0]))
                    or any(k.arg == "device" and _is_cpu(k.value)
                           for k in node.keywords)):
                what = '.to("cpu")'
            elif isinstance(fn, ast.Attribute) and fn.attr == "synchronize" \
                    and isinstance(fn.value, ast.Attribute) \
                    and fn.value.attr == "cuda":
                what = "torch.cuda.synchronize()"
            elif isinstance(fn, ast.Name) and fn.id in ("bool", "int",
                                                        "float") \
                    and len(node.args) == 1:
                src = _device_value(node.args[0])
                if src is not None:
                    what = f"{fn.id}() of {src}"
        elif isinstance(node, (ast.If, ast.While)):
            tests = [node.test]
            while tests:
                t = tests.pop()
                if isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not):
                    tests.append(t.operand)
                elif isinstance(t, ast.BoolOp):
                    tests.extend(t.values)
                elif _device_value(t) is not None:
                    kind = "a while" if isinstance(node, ast.While) \
                        else "an if"
                    what = f"{kind} test on {_device_value(t)}"
                    break
        if what is not None:
            self.emit("host-sync", node, self._qualname(node),
                      f"{what} in a hot-path module reads a device value "
                      "back to the host and waits for every kernel queued "
                      "before it; keep read-backs at the step's designated "
                      "sync points")

    # ---------------------------------------------------------- wall clock
    def _check_wall_clock(self, node: ast.Call) -> None:
        if not self.is_serving:
            return
        fn = node.func
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            if (fn.value.id, fn.attr) in _WALL_CLOCK:
                self.emit("wall-clock", node, self._qualname(node),
                          f"{fn.value.id}.{fn.attr}() in a serving path — "
                          "all serving stamps must be time.monotonic() so "
                          "wall-clock jumps can't corrupt latency/deadline "
                          "arithmetic")

    # ------------------------------------------------------------ defaults
    def _check_defaults(self, node) -> None:
        a = node.args
        for d in list(a.defaults) + [d for d in a.kw_defaults if d]:
            if _unhashable(d):
                self.emit("mutable-default", node, self._qualname(node),
                          "mutable default argument — shared across calls; "
                          "use None or a factory")

    def _check_dataclass_fields(self, node: ast.ClassDef) -> None:
        names = set()
        for dec in node.decorator_list:
            for sub in ast.walk(dec):
                if isinstance(sub, ast.Name):
                    names.add(sub.id)
                elif isinstance(sub, ast.Attribute):
                    names.add(sub.attr)
        if "dataclass" not in names:
            return
        for item in node.body:
            if isinstance(item, ast.AnnAssign) and item.value is not None \
                    and _unhashable(item.value):
                self.emit("mutable-default", item,
                          f"{self._qualname(node)}",
                          "mutable dataclass field default — use "
                          "field(default_factory=...)")

    def lint(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                self._check_wall_clock(node)
                self._check_host_sync(node)
            elif isinstance(node, (ast.If, ast.While)):
                self._check_host_sync(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_defaults(node)
            elif isinstance(node, ast.ClassDef):
                self._check_dataclass_fields(node)


def check_file(path: Path, rel: str,
               rules: Optional[frozenset] = None) -> List[Finding]:
    tree = ast.parse(path.read_text(), filename=str(path))
    lint = _Lint(rel, tree, RULES if rules is None else frozenset(rules))
    lint.lint()
    return lint.findings


def run(root: Path, rules: Optional[frozenset] = None) -> List[Finding]:
    out: List[Finding] = []
    for p in sorted(root.rglob("*.py")):
        out.extend(check_file(p, p.relative_to(root).as_posix(), rules))
    return out
