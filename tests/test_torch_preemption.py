"""The port's engine under load against the JAX package's, on bridged
weights: the step-indexed schedules of tests/test_preemption.py
(preemption and its greedy-exact resume, the preemption cap, priority
admission, bounded-queue shedding, deadlines and timeouts, the fault
harness on a bare engine) run through both engines, and tokens, finish
reasons and the robustness counters must agree. The reference's outputs
are computed here, each of its dispatches waited on
(``test_torch_serving.RefEngines``); the greedy-exact contracts are
held inside the port too, against uncontended port runs
(``faults._uncontended``). Two more cases resume an SSM stack and a
sliding-window stack on both engines."""
import dataclasses
from typing import Optional

import numpy as np
import pytest

from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import faults as jax_faults
from repro_torch.serving import faults
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.scheduler import DECODING, PREEMPTED, QUEUED
from conftest import tiny_cfg
from test_torch_serving import (RefEngines, _np_tree, _tier,  # noqa: F401
                                highest_precision)


@dataclasses.dataclass
class Side:
    """One engine family on one set of weights: the port or the reference
    (whose new engines share compiled steps through ``refs``), with its
    own fault module."""
    engine_cls: type
    faults: object
    bundle: object
    params: object
    refs: Optional[RefEngines] = None

    def engine(self, **kw):
        kw = {"max_new_tokens": 6, "n_slots": 1, "page_size": 8,
              "max_seq": 48, **kw}
        if self.engine_cls is JaxEngine:
            return self.refs.get(self.bundle, self.params, **kw)
        return self.engine_cls(self.bundle, self.params, **kw)


@pytest.fixture(scope="module")
def sides():
    m, p, bundle, model = _tier(tiny_cfg("dense"), 0)
    return (Side(ContinuousEngine, faults, bundle, model),
            Side(JaxEngine, jax_faults, m, p, RefEngines()))


def _prompt(rng, n):
    return rng.integers(4, 256, (n,)).astype(np.int32)


STATS = ("preemptions", "sheds", "reprefill_tokens", "stall_steps",
         "deadline_misses", "admitted", "retired", "decode_tokens")


def _record(eng, reqs):
    """What both engines must agree on after a schedule."""
    return {"requests": [(r.out, r.finish_reason, r.preemptions,
                          r.reprefill_tokens, r.done) for r in reqs],
            "stats": {k: getattr(eng.stats, k) for k in STATS}}


def _both(sides, schedule):
    """Run ``schedule(side) -> (engine, requests, notes)`` on the port and
    the reference; their records and notes must be equal. Returns the
    port's (engine, requests, notes)."""
    (pe, preqs, pnotes), (re_, rreqs, rnotes) = [schedule(side)
                                                  for side in sides]
    assert _record(pe, preqs) == _record(re_, rreqs)
    assert pnotes == rnotes
    return pe, preqs, pnotes


def _assert_clean(ce):
    """Every page returned, nothing held, queues drained."""
    assert ce.cache.stats.pages_in_use == 0
    assert ce.cache.held_pages == 0
    assert not ce.sched.has_work and not ce._shed_buf


# ----------------------------------------------------------------- preemption
def test_preempt_resume_is_greedy_exact(sides):
    """Evicted mid-decode, then resumed by one chunked re-prefill of prompt
    + emitted tokens: the same tokens as the reference's engine under the
    same schedule, and as an uncontended port run."""
    rng = np.random.default_rng(0)
    lo_prompt, hi_prompt = _prompt(rng, 12), _prompt(rng, 10)

    def schedule(side):
        ce = side.engine()
        lo = ce.submit(lo_prompt, priority=0)
        for _ in range(3):
            ce.step()
        notes = [lo.state, lo.n_generated]
        hi = ce.submit(hi_prompt, priority=5)
        ce.step()               # strictly higher priority evicts lo
        notes += [lo.state, lo.slot, len(lo.serve_tokens), hi.slot]
        ce.run()
        return ce, [lo, hi], notes

    ce, (lo, hi), notes = _both(sides, schedule)
    g = notes[1]
    assert notes[0] == DECODING and g >= 1
    # after the eviction: queued again, emitted tokens appended, the
    # arrival in the slot
    assert notes[2] in (PREEMPTED, QUEUED) and notes[3] is None
    assert notes[4] == len(lo_prompt) + g and notes[5] is not None
    assert lo.done and lo.finish_reason in ("eos", "length")
    assert lo.preemptions == 1 and ce.stats.preemptions == 1
    assert hi.finish_t <= lo.finish_t          # hi never waited on lo
    assert lo.reprefill_tokens >= len(lo_prompt) + g
    assert ce.stats.reprefill_tokens == lo.reprefill_tokens
    assert lo.out == faults._uncontended(sides[0].bundle, sides[0].params,
                                         lo_prompt, 6, n_slots=1,
                                         page_size=8, max_seq=48)
    _assert_clean(ce)


def test_preemption_backstop_grants_immunity(sides):
    """max_preemptions=0: a higher-priority arrival waits."""
    rng = np.random.default_rng(1)
    p1, p2 = _prompt(rng, 10), _prompt(rng, 8)

    def schedule(side):
        ce = side.engine(max_preemptions=0)
        lo = ce.submit(p1, priority=0)
        for _ in range(2):
            ce.step()
        hi = ce.submit(p2, priority=9)
        ce.step()
        notes = [lo.slot is not None, hi.slot is None]
        ce.run()
        return ce, [lo, hi], notes

    ce, (lo, hi), notes = _both(sides, schedule)
    assert notes == [True, True]              # no eviction
    assert lo.preemptions == 0 and ce.stats.preemptions == 0
    assert hi.finish_reason in ("eos", "length")
    _assert_clean(ce)


def test_priority_orders_admission(sides):
    """A late high-priority arrival overtakes earlier low-priority
    queue entries."""
    rng = np.random.default_rng(2)
    ps = [_prompt(rng, 8) for _ in range(3)]

    def schedule(side):
        ce = side.engine(max_preemptions=0, max_new_tokens=4)
        first = ce.submit(ps[0])
        ce.step()
        low = ce.submit(ps[1], priority=0)
        high = ce.submit(ps[2], priority=3)
        notes = [ce.sched.pending[0] is high]
        ce.run()
        return ce, [first, low, high], notes

    ce, (first, low, high), notes = _both(sides, schedule)
    assert notes == [True]       # priority-then-FIFO queue order
    assert high.start_t <= low.start_t
    assert low.queue_time >= high.queue_time >= 0.0
    _assert_clean(ce)


# ------------------------------------------------------------- load shedding
def test_bounded_queue_sheds_lowest_priority(sides):
    """Overflow sheds the worst (priority, latest) of queue + arrival as
    "rejected", surfacing through the next step() once."""
    rng = np.random.default_rng(3)
    ps = [_prompt(rng, 8) for _ in range(4)]

    def schedule(side):
        ce = side.engine(max_pending=1, max_preemptions=0)
        busy = ce.submit(ps[0])
        ce.step()
        queued = ce.submit(ps[1], priority=0)
        notes = [queued.done]
        vip = ce.submit(ps[2], priority=5)
        notes += [queued.done, queued.finish_reason, vip.done,
                  ce.sched.pending == [vip]]
        walkin = ce.submit(ps[3], priority=0)
        notes += [walkin.done, walkin.finish_reason]
        retired = ce.step()
        notes += [queued in retired, walkin in retired]
        ce.run()
        return ce, [busy, queued, vip, walkin], notes

    ce, (busy, queued, vip, walkin), notes = _both(sides, schedule)
    # displaced by the VIP; an arrival no better than the VIP sheds
    # itself; both surface through the next step
    assert notes == [False, True, "rejected", False, True, True,
                     "rejected", True, True]
    assert queued.finish_reason == walkin.finish_reason == "rejected"
    assert queued.n_generated == 0
    assert ce.stats.sheds == 2
    assert vip.finish_reason in ("eos", "length")
    _assert_clean(ce)


def test_never_fitting_prompt_is_shed(sides):
    """A prompt past the slot's context cap retires "rejected" (the
    reference's shed), where the port used to raise."""
    rng = np.random.default_rng(6)
    long_prompt, ok = _prompt(rng, 48), _prompt(rng, 8)

    def schedule(side):
        ce = side.engine()
        doomed = ce.submit(long_prompt)
        fine = ce.submit(ok)
        notes = [doomed.done, doomed.finish_reason]
        ce.run()
        return ce, [doomed, fine], notes

    ce, (doomed, fine), notes = _both(sides, schedule)
    assert notes == [True, "rejected"]
    assert doomed.finish_reason == "rejected" and ce.stats.sheds == 1
    assert fine.finish_reason in ("eos", "length")
    _assert_clean(ce)


# ------------------------------------------------------------------ deadlines
def test_deadline_and_timeout_cancel(sides):
    """deadline_s counts from submission (expires queued, no tokens);
    timeout_s from first admission (cancels mid-stream, tokens kept).
    Both finish as "deadline"."""
    rng = np.random.default_rng(4)
    ps = [_prompt(rng, 8) for _ in range(3)]

    def schedule(side):
        ce = side.engine(max_preemptions=0)
        busy = ce.submit(ps[0])
        ce.step()
        doomed = ce.submit(ps[1], deadline_s=0.0)
        retired = ce.step()
        notes = [doomed in retired, doomed.finish_reason,
                 bool(np.isnan(doomed.queue_time))]
        ce.run()
        slow = ce.submit(ps[2], timeout_s=0.0)
        ce.step()
        notes += [slow.start_t > 0]
        ce.run()
        return ce, [busy, doomed, slow], notes

    ce, (busy, doomed, slow), notes = _both(sides, schedule)
    assert notes == [True, "deadline", True, True]
    assert doomed.finish_reason == slow.finish_reason == "deadline"
    assert doomed.n_generated == 0
    assert busy.finish_reason in ("eos", "length")
    assert ce.stats.deadline_misses == 2
    _assert_clean(ce)


# -------------------------------------------------------------------- harness
def test_fault_harness_invariants_on_bare_engine(sides):
    """A burst through page pressure on one engine: the same retirements
    on both sides, every request with a valid reason, nothing leaked."""
    rng = np.random.default_rng(5)
    prompts = tuple(_prompt(rng, int(n)) for n in (8, 10, 6, 9, 7))

    def schedule(side):
        f = side.faults
        ce = side.engine(n_slots=2, max_pending=3, max_new_tokens=4)
        h = f.FaultHarness(ce, faults=[
            f.PagePressure(tier=f.SOLO, start=0, steps=4, pages=3),
            f.AdmissionBurst(step=0, prompts=prompts, priority=1),
            f.AdmissionBurst(step=3, prompts=prompts[:2], priority=4),
        ])
        h.run()
        notes = [[r.rid - h.requests[0].rid for r in h.retired],
                 h.check_invariants()]
        return ce, h.requests, notes

    ce, reqs, notes = _both(sides, schedule)
    assert notes[1] == [] and len(notes[0]) == 7
    assert len(reqs) == 7 and all(r.done for r in reqs)
    assert {r.finish_reason for r in reqs} <= {"eos", "length",
                                               "context_cap", "rejected"}
    assert ce.cache.check_pages() == []
    _assert_clean(ce)


def test_fault_harness_rejects_unknown_tier(sides):
    ce = sides[0].engine()
    with pytest.raises(ValueError):
        faults.FaultHarness(ce, faults=[faults.PagePressure(
            tier="nope", start=0, steps=1, pages=1)])


def test_stall_ladder_waits_then_preempts(sides):
    """A zero-progress step waits while pages are held, then, with the
    hold gone but the pool too small for both slots, evicts one."""
    rng = np.random.default_rng(7)
    ps = [_prompt(rng, 15), _prompt(rng, 15)]

    def schedule(side):
        # 5 pages of 8 tokens: two 15-token prompts fit (2 pages each)
        # and decode once in step 0; then both need a third page, and the
        # one left is held for steps 1-4
        ce = side.engine(n_slots=2, num_pages=6, max_new_tokens=12)
        reqs = [ce.submit(p) for p in ps]
        held = None
        for i in range(40):
            if i == 1:
                held = ce.cache.hold_pages(1)
            if i == 5:
                ce.cache.release_pages(held)
            if not ce.sched.has_work:
                break
            ce.step()
        notes = [ce.stats.stall_steps > 0]
        ce.run()
        return ce, reqs, notes

    ce, reqs, _ = _both(sides, schedule)
    assert ce.stats.stall_steps > 0 and ce.stats.preemptions > 0
    for r, p in zip(reqs, ps):
        assert r.out == faults._uncontended(sides[0].bundle, sides[0].params,
                                            p, 12, n_slots=2, page_size=8,
                                            max_seq=48)
    _assert_clean(ce)


# ------------------------------------------------ resumes beyond dense
@pytest.mark.parametrize("kind", ["ssm", "window"])
def test_resume_is_greedy_exact_beyond_dense(kind):
    """An SSM stack re-enters its recurrent state from position 0 on the
    resume's first chunk; a window stack re-prefills with its late walk
    start. Both engines agree under the same schedule, and the port's
    streams emit its uncontended runs' tokens."""
    if kind == "ssm":
        cfg = tiny_cfg("ssm", cache_layout="paged", prefill_chunk=4)
    else:
        cfg = tiny_cfg("dense", name="window-tiny", prefill_chunk=8,
                       n_layers=3, sliding_window=6, local_global_ratio=2,
                       cache_layout="paged")
    m, p, bundle, model = _tier(cfg, 0)
    pair = (Side(ContinuousEngine, faults, bundle, model),
            Side(JaxEngine, jax_faults, m, p, RefEngines()))
    rng = np.random.default_rng(8)
    lo_prompt, hi_prompt = _prompt(rng, 13), _prompt(rng, 9)

    def schedule(side):
        ce = side.engine(max_new_tokens=10, page_size=4)
        lo = ce.submit(lo_prompt)
        while lo.n_generated < 3:
            ce.step()
        hi = ce.submit(hi_prompt, priority=5)
        ce.run()
        return ce, [lo, hi], [lo.preemptions, hi.done]

    ce, (lo, hi), notes = _both(pair, schedule)
    assert notes == [1, True]
    for r, prompt in ((lo, lo_prompt), (hi, hi_prompt)):
        assert r.out == faults._uncontended(bundle, model, prompt, 10,
                                            n_slots=1, page_size=4,
                                            max_seq=48)
    _assert_clean(ce)
