"""CLI runner: ``python -m repro_torch.analysis [--root DIR] [--passes a,b]
[--json out]``.

Exit codes: 0 = clean (allowlisted findings suppressed), 1 = findings,
2 = allowlist protocol violation (entry with no reason, or stale entry
matching no live finding)."""
from __future__ import annotations

import argparse
import importlib
import sys
from pathlib import Path

from . import PASSES
from .allowlist import ALLOWLIST
from .report import apply_allowlist, render_json


_MODULES = {"kernel": "kernel_check", "fsm": "fsm_check",
            "trace": "trace_lint", "ledger": "page_ledger"}


def _pass(name: str):
    if name not in _MODULES:
        raise SystemExit(f"unknown pass {name!r} (choose from {PASSES})")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def _entries_for(root: Path, rules: set):
    """The allowlist entries this run can judge: a rule of a pass that
    ran, on a file the tree holds (an entry about another tree is not
    stale in this one). Every entry still needs its reason."""
    files = [p.relative_to(root).as_posix() for p in root.rglob("*")
             if p.is_file()]
    return [e for e in ALLOWLIST if not e.reason.strip() or (
        e.rule in rules and any(f.endswith(e.path) for f in files))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static-analysis passes over the port: CUDA kernel "
                    "launch audit, scheduler FSM verifier, hot-path lint, "
                    "page-ledger ownership.")
    ap.add_argument("--root", default=None,
                    help="tree to analyse (default: the installed "
                    "src/repro_torch package directory)")
    ap.add_argument("--passes", default=",".join(PASSES),
                    help=f"comma-separated subset of {PASSES}")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write a JSON report ('-' = stdout)")
    args = ap.parse_args(argv)

    root = Path(args.root) if args.root else Path(__file__).parents[1]
    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    findings, rules = [], set()
    for name in passes:
        mod = _pass(name)
        findings.extend(mod.run(root))
        rules |= mod.RULES
    reported, suppressed, problems = apply_allowlist(
        findings, _entries_for(root, rules))

    if args.json:
        payload = render_json(reported, suppressed, problems)
        if args.json == "-":
            print(payload)
        else:
            Path(args.json).write_text(payload + "\n")
    for f in reported:
        print(f.format())
    for msg in problems:
        print(f"ALLOWLIST: {msg}")
    print(f"repro_torch.analysis: {len(reported)} finding(s), "
          f"{len(suppressed)} allowlisted, passes={','.join(passes)}")
    if problems:
        return 2
    return 1 if reported else 0


if __name__ == "__main__":
    sys.exit(main())
