"""Deterministic fault injection for the continuous serving stack (the
port of ``repro.serving.faults``).

Every fault fires at an engine step number, not a timestamp, so a
scenario replays the same way on any machine:

* ``TierStall``         a tier stops stepping for a step range (a wedged
                        device). Its queue holds; every other tier keeps
                        streaming.
* ``PagePressure``      pages leave a tier's pool for a step range
                        (``PagedKVCache.hold_pages``) and come back at the
                        end. The engine must wait, preempt or shed, never
                        crash or leak.
* ``AdmissionBurst``    a batch of prompts lands at one step, optionally
                        high-priority or deadline-carrying: the preemption
                        and load-shedding paths.
* ``EscalationTrigger`` an always-abort ``EscalationMonitor`` installs on a
                        tier at one step (``abort_threshold=0.0``: the
                        score is non-negative, so every DECODING stream
                        escalates at exactly ``min_tokens`` tokens).

``FaultHarness`` replays a schedule against a ``ContinuousPoolEngine`` (or
a bare ``ContinuousEngine``) and ``check_invariants`` audits the result:
every submitted request retired with a valid finish reason, queues empty,
no escalated stream parked, no page held, leaked or unaccounted, no
fragmentation. The module is also the chaos smoke, on the card unless
``--device cpu``::

  PYTHONPATH=src python -m repro_torch.serving.faults --smoke [--device cpu]

It runs the stall, pressure, burst and escalation-storm scenarios on tiny
models and checks the invariants, and that preempted and escalated
streams emit the tokens of uncontended runs. The reference's spec-stall
and prefix-thrash scenarios come with the speculation and prefix-sharing
slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.data import tokenizer as tok
from .engine import ContinuousEngine, EscalationMonitor
from .pool import ContinuousPoolEngine
from .scheduler import FINISH_REASONS, Request

# the bare-engine harness registers its single engine under this tier name
SOLO = "engine"
# steps a schedule may take to drain before the harness calls it stuck
MAX_STEPS = 10_000


@dataclasses.dataclass(frozen=True)
class TierStall:
    """Tier ``tier`` does not step during [start, start + steps). Its
    requests hold their state; deadlines keep ticking."""
    tier: str
    start: int
    steps: int


@dataclasses.dataclass(frozen=True)
class PagePressure:
    """``pages`` free pages (at most what is free) leave tier ``tier``'s
    pool at step ``start`` and return at step ``start + steps``."""
    tier: str
    start: int
    steps: int
    pages: int


@dataclasses.dataclass(frozen=True)
class AdmissionBurst:
    """``prompts`` all submitted at step ``step`` on ``tier`` with shared
    robustness attributes: the overload and priority traffic."""
    step: int
    prompts: tuple
    tier: str = SOLO
    priority: int = 0
    deadline_s: Optional[float] = None
    timeout_s: Optional[float] = None
    max_new_tokens: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class EscalationTrigger:
    """An ``EscalationMonitor`` installs on tier ``tier`` at step ``step``,
    replacing any there. The target must be a pool with a tier above."""
    tier: str
    step: int
    abort_threshold: float = 0.0
    min_tokens: int = 1


Fault = Union[TierStall, PagePressure, AdmissionBurst, EscalationTrigger]


class FaultHarness:
    """Steps a pool (or a bare engine) while injecting a step-indexed fault
    schedule, recording every request it submits and every retirement."""

    def __init__(self, target: Union[ContinuousPoolEngine, ContinuousEngine],
                 faults: Sequence[Fault] = ()):
        if isinstance(target, ContinuousPoolEngine):
            self.pool: Optional[ContinuousPoolEngine] = target
            self.engines: Dict[str, ContinuousEngine] = dict(
                zip(target.names, target.engines))
        else:
            self.pool = None
            self.engines = {SOLO: target}
        self.faults: List[Fault] = list(faults)
        for f in self.faults:
            if f.tier not in self.engines:
                raise ValueError(f"fault {f} names tier {f.tier!r}; harness "
                                 f"serves {tuple(self.engines)}")
        self.requests: List[Request] = []
        self.retired: List[Request] = []
        self._held: Dict[PagePressure, np.ndarray] = {}

    # ------------------------------------------------------------- injection
    def submit(self, tier: str, prompt: np.ndarray,
               max_new_tokens: Optional[int] = None, *, priority: int = 0,
               deadline_s: Optional[float] = None,
               timeout_s: Optional[float] = None) -> Request:
        """Submit one tracked request outside the schedule (base load).
        Tracked requests are what ``check_invariants`` audits."""
        if self.pool is not None:
            req = self.pool.submit_to(tier, prompt, max_new_tokens,
                                      priority=priority, deadline_s=deadline_s,
                                      timeout_s=timeout_s)
        else:
            req = self.engines[tier].submit(prompt, max_new_tokens,
                                            priority=priority,
                                            deadline_s=deadline_s,
                                            timeout_s=timeout_s)
        self.requests.append(req)
        return req

    def _inject(self, step_i: int):
        for f in self.faults:
            if isinstance(f, PagePressure):
                cache = self.engines[f.tier].cache
                if f.start == step_i:
                    self._held[f] = cache.hold_pages(f.pages)
                elif f.start + f.steps == step_i and f in self._held:
                    cache.release_pages(self._held.pop(f))
            elif isinstance(f, AdmissionBurst) and f.step == step_i:
                for p in f.prompts:
                    self.submit(f.tier, p, f.max_new_tokens,
                                priority=f.priority, deadline_s=f.deadline_s,
                                timeout_s=f.timeout_s)
            elif isinstance(f, EscalationTrigger) and f.step == step_i:
                self.engines[f.tier].escalation = EscalationMonitor(
                    abort_threshold=f.abort_threshold,
                    min_tokens=f.min_tokens)

    def _stalled(self, step_i: int) -> List[str]:
        return [f.tier for f in self.faults if isinstance(f, TierStall)
                and f.start <= step_i < f.start + f.steps]

    # --------------------------------------------------------------- driving
    def run(self) -> List[Request]:
        """Step until the schedule is exhausted and every queue drained;
        returns (and records) every retirement. Raises past ``MAX_STEPS``:
        a scenario that never drains is a failed robustness test."""
        horizon = max((f.step if isinstance(f, (AdmissionBurst,
                                                EscalationTrigger))
                       else f.start + f.steps for f in self.faults),
                      default=0)
        step_i = 0
        while True:
            self._inject(step_i)
            stalled = self._stalled(step_i)
            if self.pool is not None:
                self.retired.extend(self.pool.step(stalled=stalled))
            else:
                eng = self.engines[SOLO]
                if SOLO not in stalled and eng.sched.has_work:
                    self.retired.extend(eng.step())
                else:
                    self.retired.extend(eng.drain_shed())
            step_i += 1
            if step_i > MAX_STEPS:
                raise RuntimeError(f"fault scenario did not drain within "
                                   f"{MAX_STEPS} steps")
            if step_i > horizon \
                    and not any(e.sched.has_work or e._shed_buf
                                or e._escalated_buf
                                for e in self.engines.values()):
                self._inject(step_i)   # releases pressure ending exactly here
                break
        return self.retired

    # ---------------------------------------------------------------- audits
    def check_invariants(self) -> List[str]:
        """Post-drain audit; returns human-readable violations (empty =
        healthy)."""
        bad: List[str] = []
        for r in self.requests:
            if not r.done:
                bad.append(f"request {r.rid} never retired (state {r.state})")
            elif r.finish_reason not in FINISH_REASONS:
                bad.append(f"request {r.rid} retired with invalid "
                           f"finish_reason {r.finish_reason!r}")
        for name, eng in self.engines.items():
            c = eng.cache
            if eng.sched.pending or eng.sched.running:
                bad.append(f"{name}: queue not drained "
                           f"({len(eng.sched.pending)} pending, "
                           f"{len(eng.sched.running)} running)")
            if c.stats.pages_in_use != 0:
                bad.append(f"{name}: {c.stats.pages_in_use} pages in use "
                           "after drain: pages leaked")
            if c.free_pages != c.num_pages - 1:
                bad.append(f"{name}: free list holds {c.free_pages} of "
                           f"{c.num_pages - 1} pages")
            if c.held_pages != 0:
                bad.append(f"{name}: {c.held_pages} pages still held")
            if eng._escalated_buf:
                bad.append(f"{name}: {len(eng._escalated_buf)} escalated "
                           "streams never handed off")
            bad.extend(f"{name}: {v}" for v in c.check_pages())
            if c.fragmentation != 0.0:
                bad.append(f"{name}: fragmentation {c.fragmentation:.3f} "
                           "after drain")
        return bad


# ------------------------------------------------------------ chaos smoke
@dataclasses.dataclass
class StaticPolicy:
    """Fixed-tier dispatch for harness scenarios (the routing policy is not
    under test here): every query to tier ``tier``."""
    n_tiers: int
    tier: int = 0

    def decide(self, tokens, mask):
        n = len(tokens)
        return (np.full((n,), self.tier, np.int64),
                np.zeros((n,), np.float64))


# the scenarios' tiny dense paged tier (``ArchConfig`` keywords beside its
# name)
TINY_BASE = dict(family="dense", vocab_size=tok.VOCAB_SIZE,
                 vocab_pad_multiple=16, n_layers=2, d_model=32, n_heads=2,
                 n_kv_heads=2, d_ff=64, head_dim=16, attn_chunk=16,
                 cache_layout="paged", kv_page_size=8)


def _tiny_models(device: str = "cuda"):
    """Two ``TINY_BASE`` models, random weights from seeded generators:
    [(bundle, module)] for tiers "a" and "b"."""
    import torch
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.model import build_model

    out = []
    for name, seed in (("fault-a", 1), ("fault-b", 2)):
        b = build_model(ArchConfig(name=name, **TINY_BASE))
        g = torch.Generator(device=device).manual_seed(seed)
        out.append((b, b.init(g, device)))
    return out


def _tiny_pool(n_slots: int = 2, max_seq: int = 48, max_new: int = 6,
               device: str = "cuda", **engine_kw):
    """Two-tier pool of tiny dense paged models for the scenarios. Returns
    (pool, [(bundle, module)]): the models serve uncontended reference
    runs."""
    bundles = _tiny_models(device)
    engines = [ContinuousEngine(b, p, max_new_tokens=max_new,
                                n_slots=n_slots, max_seq=max_seq,
                                **engine_kw)
               for b, p in bundles]
    pool = ContinuousPoolEngine(StaticPolicy(2), [("a", engines[0]),
                                                  ("b", engines[1])])
    return pool, bundles


def _prompts(rng, n: int, lo: int = 4, hi: int = 16):
    return tuple(rng.integers(4, tok.VOCAB_SIZE,
                              (int(l),)).astype(np.int32)
                 for l in rng.integers(lo, hi, (n,)))


def _uncontended(bundle, params, prompt, max_new: int, **kw) -> list:
    """Tokens of ``prompt`` served alone on a fresh engine."""
    eng = ContinuousEngine(bundle, params, max_new_tokens=max_new, **kw)
    req = eng.submit(prompt)
    eng.run()
    return req.out


def scenario_stall(verbose: bool = True,
                   device: str = "cuda") -> FaultHarness:
    """Tier b wedges for a step range mid-stream; tier a must keep
    retiring, and b's queue must survive the stall and drain after."""
    rng = np.random.default_rng(0)
    pool, _ = _tiny_pool(device=device)
    h = FaultHarness(pool, [
        TierStall("b", start=2, steps=12),
        AdmissionBurst(step=0, prompts=_prompts(rng, 3), tier="a"),
        AdmissionBurst(step=0, prompts=_prompts(rng, 3), tier="b"),
    ])
    h.run()
    bad = h.check_invariants()
    assert not bad, bad
    a_done = max(r.finish_t for r in h.requests[:3])
    b_done = min(r.finish_t for r in h.requests[3:])
    assert a_done <= b_done, "stalled tier b retired before healthy tier a"
    if verbose:
        print(f"stall: {len(h.retired)} retired, tier a drained during "
              f"tier b's stall, no leaks")
    return h


def scenario_pressure(verbose: bool = True,
                      device: str = "cuda") -> FaultHarness:
    """Tier a's whole free pool vanishes before its stream arrives; the
    engine must wait the squeeze out (stall_steps) and drain clean once
    the pages return."""
    rng = np.random.default_rng(1)
    pool, _ = _tiny_pool(n_slots=2, max_seq=32, device=device)
    eng = pool.engine("a")
    squeeze = eng.cache.stats.num_pages   # hold every free page
    h = FaultHarness(pool, [
        # listed first: the hold lands before the same-step burst submits
        PagePressure("a", start=0, steps=8, pages=squeeze),
        AdmissionBurst(step=0, prompts=_prompts(rng, 4, lo=6, hi=12),
                       tier="a"),
    ])
    h.run()
    bad = h.check_invariants()
    assert not bad, bad
    assert eng.stats.stall_steps > 0, \
        "a fully held pool never put the engine in its wait state"
    if verbose:
        print(f"pressure: {len(h.retired)} retired under a "
              f"{squeeze}-page squeeze "
              f"({eng.stats.stall_steps} waited steps, "
              f"{eng.stats.preemptions} preemptions), no leaks")
    return h


def scenario_burst(verbose: bool = True,
                   device: str = "cuda") -> FaultHarness:
    """Overload: a bounded-queue tier takes a low-priority base load, then
    a high-priority burst bigger than the queue, forcing preemptions,
    sheds and (deadline_s=0) deadline misses. Every request must retire
    with a valid reason, and preempted ones emit the tokens of
    uncontended runs."""
    rng = np.random.default_rng(2)
    pool, bundles = _tiny_pool(n_slots=1, max_seq=48, max_pending=3,
                               device=device)
    base = _prompts(rng, 4, lo=5, hi=10)
    burst = _prompts(rng, 5, lo=5, hi=10)
    doomed = _prompts(rng, 2, lo=5, hi=10)
    h = FaultHarness(pool, [
        AdmissionBurst(step=0, prompts=base, tier="a", priority=0),
        AdmissionBurst(step=4, prompts=burst, tier="a", priority=5),
        # outranks the burst, so the bounded queue admits them (displacing
        # burst members) rather than shedding them; their zero deadline
        # then expires them
        AdmissionBurst(step=4, prompts=doomed, tier="a", priority=6,
                       deadline_s=0.0),
    ])
    h.run()
    bad = h.check_invariants()
    assert not bad, bad
    eng = pool.engine("a")
    assert eng.stats.preemptions > 0, "burst never forced a preemption"
    assert eng.stats.sheds > 0, "overload never shed a request"
    assert eng.stats.deadline_misses >= len(doomed), \
        "deadline_s=0 requests did not all miss"
    b, p = bundles[0]
    preempted = [r for r in h.requests if r.preemptions > 0
                 and r.finish_reason in ("eos", "length")]
    assert preempted, "no preempted request survived to compare"
    for r in preempted:
        ref = _uncontended(b, p, r.tokens, r.max_new_tokens, n_slots=1,
                           max_seq=64)
        assert r.out == ref, (r.rid, r.out, ref)
    if verbose:
        print(f"burst: {len(h.retired)} retired "
              f"({eng.stats.preemptions} preemptions, {eng.stats.sheds} "
              f"sheds, {eng.stats.deadline_misses} deadline misses), "
              f"{len(preempted)} preempted requests greedy-exact, no leaks")
    return h


def scenario_escalation_storm(verbose: bool = True,
                              device: str = "cuda") -> FaultHarness:
    """Mass mid-stream escalation under page pressure: an always-abort
    monitor lands on tier a at step 3 while most of tier b's free pool is
    held. Every hand-off must re-admit into the squeeze (waiting it out),
    the token split must sum without loss, the call count stay undiluted,
    and every continuation equal tier b's greedy output from prompt +
    the stream's emitted prefix."""
    rng = np.random.default_rng(5)
    pool, bundles = _tiny_pool(n_slots=2, max_seq=48, max_new=6,
                               device=device)
    eb = pool.engine("b")
    squeeze = eb.cache.stats.num_pages - 8   # leave barely enough to admit
    h = FaultHarness(pool, [
        AdmissionBurst(step=0, prompts=_prompts(rng, 8, lo=4, hi=12),
                       tier="a"),
        PagePressure("b", start=3, steps=16, pages=squeeze),
        EscalationTrigger("a", step=3, abort_threshold=0.0, min_tokens=1),
    ])
    h.run()
    bad = h.check_invariants()
    assert not bad, bad
    m = pool.meter
    assert pool.escalation_log and m.escalations[0] > 0, \
        "the storm never escalated anyone"
    assert pool.engine("a").stats.escalations == len(pool.escalation_log)
    served = [r for r in h.requests if r.finish_reason != "rejected"]
    assert m.tokens.sum() == sum(r.n_generated for r in served), \
        "escalation split lost or double-billed tokens"
    assert m.total_calls == len(served), \
        "an escalated stream diluted the call count"
    b, p = bundles[1]
    escalated = {rid: k for rid, _, _, k in pool.escalation_log}
    checked = 0
    for r in h.requests:
        if r.rid not in escalated or r.finish_reason == "rejected":
            continue
        k = escalated[r.rid]
        ref = _uncontended(b, p, np.concatenate(
            [r.tokens, np.asarray(r.out[:k], np.int32)]), 6, n_slots=2,
            max_seq=64)
        assert r.out[k:] == ref[:len(r.out) - k], (r.rid, r.out[k:], ref)
        checked += 1
    assert checked > 0, "no escalated stream survived to compare"
    if verbose:
        print(f"escalation-storm: {len(h.retired)} retired, "
              f"{len(pool.escalation_log)} escalations into a "
              f"{squeeze}-page squeeze, {checked} continuations "
              "greedy-exact against the upper tier, token split balanced, "
              "no leaks")
    return h


# name -> scenario; --smoke runs them all
SCENARIOS = {"stall": scenario_stall, "pressure": scenario_pressure,
             "burst": scenario_burst,
             "escalation-storm": scenario_escalation_storm}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true", required=True,
                    help="run every scenario and check its invariants")
    ap.add_argument("--device", default="cuda",
                    help="where the models run (default: the card)")
    args = ap.parse_args(argv)
    for fn in SCENARIOS.values():
        fn(device=args.device)
    print(f"chaos smoke OK on {args.device}: {', '.join(SCENARIOS)}")


if __name__ == "__main__":
    main()
