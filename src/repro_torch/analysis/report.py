"""Finding/allowlist plumbing shared by the four analysis passes (a copy
of ``repro.analysis.report``: the port imports nothing of the JAX
package)."""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site.

    ``rule`` is the stable machine id (``kernel-extent``,
    ``ledger-free-escape``, ...); ``symbol`` the qualified name of the
    offending function/class/kernel family (allowlist matching is by
    (rule, path suffix, symbol)); ``line`` is 1-based, 0 for synthetic
    findings with no source anchor.
    """
    rule: str
    path: str
    line: int
    symbol: str
    message: str

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.symbol}: {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    """One recorded exception. ``path`` matches by suffix; ``symbol``
    matches exactly (empty = any symbol at that path). ``reason`` is
    mandatory — an empty reason is itself an analysis failure."""
    rule: str
    path: str
    symbol: str
    reason: str

    def matches(self, f: Finding) -> bool:
        return (f.rule == self.rule and f.path.endswith(self.path)
                and (not self.symbol or f.symbol == self.symbol))


def apply_allowlist(
    findings: Sequence[Finding], entries: Sequence[AllowEntry],
) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split ``findings`` into (reported, suppressed) and collect allowlist
    protocol violations: entries with no written reason, and stale entries
    that no longer match any live finding (both fail the run — the
    allowlist may only name real, justified exceptions)."""
    problems = [f"allowlist entry {e.rule} @ {e.path} ({e.symbol or '*'}): "
                "missing reason — every exception must be justified"
                for e in entries if not e.reason.strip()]
    used = {e: False for e in entries}
    reported: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        hit = None
        for e in entries:
            if e.matches(f):
                hit = e
                break
        if hit is None:
            reported.append(f)
        else:
            used[hit] = True
            suppressed.append(f)
    problems += [f"allowlist entry {e.rule} @ {e.path} ({e.symbol or '*'}): "
                 "stale — matches no current finding, delete it"
                 for e, u in used.items() if not u]
    return reported, suppressed, problems


def render_json(reported: Iterable[Finding], suppressed: Iterable[Finding],
                problems: Sequence[str]) -> str:
    return json.dumps({
        "findings": [f.to_dict() for f in reported],
        "suppressed": [f.to_dict() for f in suppressed],
        "allowlist_problems": list(problems),
    }, indent=2)
