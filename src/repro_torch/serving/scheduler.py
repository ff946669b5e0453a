"""Slot-based continuous-batching scheduler with priority classes.

The engine decodes a fixed number of *slots* every step (jit-stable shapes).
Requests queue by priority class — higher ``priority`` admits first, FIFO
within a class — and whenever a slot frees up (EOS / length-cap retirement,
deadline cancellation, or preemption) the scheduler admits the best pending
request into it, so short requests never wait for stragglers that merely
shared their admission batch. Page-pool admission control lives with the
engine (a request is only admitted when ``PagedKVCache.can_admit`` holds).

Slot states: an occupied slot is either PREFILLING (its prompt is still
streaming into the pool chunk-by-chunk — see ContinuousEngine's chunked
admission) or DECODING (prompt resident, one token emitted per step). The
one-shot prefill path moves a slot straight to DECODING at admission.
A DECODING slot may be PREEMPTED: its pages are reclaimed and the request
re-enters the pending queue at its original (priority, arrival) position,
with its prompt *plus everything it already generated* as the new prefill
source (``serve_tokens``) — resumption is one chunked prefill, not a
restart, and stays greedy-exact. ESCALATED is the cross-tier variant:
same eviction mechanics, but the request leaves for the next tier up
(the pool hands it to that scheduler's ``requeue``) and resumes THERE as
one chunked prefill, greedy-exact with the upper tier's own continuation.

All lifecycle stamps (``submit_t`` / ``start_t`` / ``finish_t`` /
``token_t``) are ``time.monotonic()`` — wall-clock jumps must not corrupt
latency, TTFT, queue-time, or deadline arithmetic. They are only meaningful
relative to other monotonic stamps from the same process.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import math
import time
from typing import List, Optional

import numpy as np

_RID = itertools.count()

# Request / slot lifecycle states.
QUEUED = "queued"            # submitted, waiting for a slot
PREFILLING = "prefilling"    # slot assigned, prompt streaming in chunks
DECODING = "decoding"        # prompt resident, emitting one token per step
# Speculative sub-states of DECODING, transient within one engine step: a
# slot picked for a speculative round is DRAFTING while the cheap sibling
# streams γ candidate tokens into the draft cache, then VERIFYING while the
# target scores the whole chunk in one launch. The engine restores DECODING
# (or retires) before step() returns, so the pool/scheduler never observe a
# slot stuck mid-speculation.
DRAFTING = "drafting"        # draft sibling streaming candidate tokens
VERIFYING = "verifying"      # target scoring the drafted chunk
PREEMPTED = "preempted"      # evicted mid-decode, re-queued for re-prefill
# ESCALATED is preemption ACROSS tiers: a stream whose running quality
# score crossed its boundary's abort threshold is cancelled mid-decode
# (pages freed, prompt + emitted prefix kept as ``serve_tokens``) and
# handed to the pool, which re-queues it on the NEXT tier up. It waits in
# the upper engine's pending queue in this state and re-admits through the
# ordinary admit path as ONE chunked prefill — escalation costs a prefill,
# not a restart — or retires from the queue (deadline / never-fits shed).
ESCALATED = "escalated"      # quality-aborted, awaiting the tier above
DONE = "done"                # retired

# The only values ``Request.finish_reason`` may take once ``done``:
#   eos         — the model emitted tok.EOS
#   length      — the request hit its own max_new_tokens cap
#   context_cap — the slot hit the engine's per-slot context capacity
#   rejected    — load-shed: bounded-queue overflow, or a prompt that could
#                 never fit the pool (reject-at-submit)
#   deadline    — cancelled for missing its deadline/timeout, possibly
#                 mid-stream (tokens already emitted are kept)
FINISH_REASONS = ("eos", "length", "context_cap", "rejected", "deadline")

# Declared lifecycle edges (from_state, to_state) — the machine-checked
# source of truth for the request/slot FSM. ``repro.analysis.fsm_check``
# AST-extracts every ``.state = X`` assignment in scheduler/engine/pool and
# verifies it lands on one of these edges at a site declared in
# ``repro.analysis.fsm_spec``; adding a state or a transition without
# growing this tuple (and the spec) fails the analysis job.
TRANSITIONS = (
    (QUEUED, PREFILLING),       # admit
    (QUEUED, DONE),             # shed / deadline before ever holding a slot
    (PREFILLING, DECODING),     # prompt resident (last chunk or one-shot)
    (PREFILLING, DONE),         # cancelled mid-prompt (deadline/context cap)
    (DECODING, DRAFTING),       # speculative round begins (transient)
    (DRAFTING, VERIFYING),      # draft chunk handed to the target
    (VERIFYING, DECODING),      # verdict applied, slot resumes decoding
    (DECODING, PREEMPTED),      # evicted mid-decode, re-queued
    (PREEMPTED, PREFILLING),    # re-admitted: resume is one chunked prefill
    (PREEMPTED, DONE),          # deadline expiry while re-queued
    (DECODING, DONE),           # eos / length / context_cap / deadline
    (DECODING, ESCALATED),      # quality abort: handed up one tier
    (ESCALATED, PREFILLING),    # re-admitted one tier up: one chunked prefill
    (ESCALATED, DONE),          # deadline / shed while awaiting the upper tier
)


@dataclasses.dataclass(eq=False)
class Request:
    """One serving request's lifecycle record.

    ``priority`` is an arbitrary int, higher = more urgent (default 0); it
    orders admission and selects preemption victims, never changes decoding.
    ``deadline_s`` is a completion deadline in seconds from submission;
    ``timeout_s`` an in-flight cap from (first) admission. Either expiring
    cancels the request with finish reason "deadline".
    """
    tokens: np.ndarray                     # prompt (1-d int32)
    max_new_tokens: int
    rid: int = dataclasses.field(default_factory=lambda: next(_RID))
    priority: int = 0                      # higher admits first
    # per-request sampling temperature; None inherits the engine's global
    # temperature. 0.0 forces greedy for this request even in a sampled pool.
    temperature: Optional[float] = None
    deadline_s: Optional[float] = None     # seconds from submit_t
    timeout_s: Optional[float] = None      # seconds from start_t
    submit_t: float = 0.0                  # monotonic time enqueued
    start_t: float = 0.0                   # monotonic time first admitted
    finish_t: float = 0.0                  # monotonic time retired
    slot: Optional[int] = None
    out: list = dataclasses.field(default_factory=list)  # emitted token ids
    token_t: list = dataclasses.field(default_factory=list)  # emit times
    done: bool = False
    state: str = QUEUED
    prefill_pos: int = 0                   # serve_tokens already prefilled
    finish_reason: str = ""                # see FINISH_REASONS
    preemptions: int = 0                   # times evicted mid-decode
    reprefill_tokens: int = 0              # tokens re-prefilled after evictions
    prefix_hit_tokens: int = 0             # prompt tokens skipped via the
                                           # shared-prefix tree (all resumes)
    # speculative-decoding ledger (cross-tier drafting; engine-maintained):
    # tokens the draft sibling proposed for this request, how many the
    # target accepted verbatim, and how many it rejected (rolled back).
    # Correction/bonus tokens the target emits itself are none of these.
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    rejected_tokens: int = 0
    # mid-stream escalation ledger (engine EscalationMonitor + pool
    # hand-off): times this stream was quality-aborted up a tier, and the
    # highest running uncertainty score it ever reached — observe-only
    # monitor passes read the peak to calibrate the abort threshold
    # (core.thresholds.calibrate_abort_threshold)
    escalations: int = 0
    esc_peak_score: float = 0.0
    # what admission actually prefills: the prompt, extended at every
    # preemption with the tokens generated so far, so resumption is one
    # chunked prefill whose final-chunk logits yield the NEXT token
    serve_tokens: np.ndarray = None

    def __post_init__(self):
        if self.serve_tokens is None:
            self.serve_tokens = self.tokens

    def __lt__(self, other: "Request") -> bool:
        """Priority-then-FIFO queue order: higher priority first, earlier
        arrival (smaller rid) within a class. Preempted requests keep their
        original rid, so re-queueing restores their position."""
        return (-self.priority, self.rid) < (-other.priority, other.rid)

    @property
    def n_generated(self) -> int:
        return len(self.out)

    @property
    def latency(self) -> float:
        """Submission-to-retirement time; NaN while still in flight."""
        return self.finish_t - self.submit_t if self.done else math.nan

    @property
    def ttft(self) -> float:
        """Time to first token from submission; NaN before the first token."""
        return self.token_t[0] - self.submit_t if self.token_t else math.nan

    @property
    def queue_time(self) -> float:
        """Submission-to-first-admission wait; NaN while still queued (or
        shed before ever reaching a slot). Preemptions do not reset it."""
        return self.start_t - self.submit_t if self.start_t else math.nan

    def expired(self, now: float) -> bool:
        """True once the deadline (from submission) or timeout (from first
        admission) has passed — the engine then cancels the request with
        finish reason "deadline", reclaiming its slot mid-stream if needed."""
        if self.deadline_s is not None \
                and now - self.submit_t >= self.deadline_s:
            return True
        return self.timeout_s is not None and bool(self.start_t) \
            and now - self.start_t >= self.timeout_s


class ContinuousScheduler:
    """Tracks the priority-ordered pending queue and the slot -> request
    assignment."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        # kept sorted by Request.__lt__: (priority desc, arrival asc)
        self.pending: List[Request] = []
        self.running: dict[int, Request] = {}
        self._free_slots = list(range(n_slots - 1, -1, -1))  # pop() -> 0,1,..

    def submit(self, req: Request) -> Request:
        """Enqueue ``req`` at its (priority, arrival) position and stamp its
        submission time."""
        req.submit_t = time.monotonic()
        bisect.insort(self.pending, req)
        return req

    @property
    def has_free_slot(self) -> bool:
        return bool(self._free_slots)

    @property
    def has_work(self) -> bool:
        """True while anything is queued or occupying a slot."""
        return bool(self.pending or self.running)

    def peek_pending(self) -> Optional[Request]:
        """Head-of-queue request — highest priority, earliest arrival —
        without dequeuing (admission control inspects its prompt length
        first), or None."""
        return self.pending[0] if self.pending else None

    def admit(self, idx: int = 0) -> Request:
        """Move ``pending[idx]`` into a free slot (caller has already
        secured its cache pages). ``idx > 0`` is the engine's bounded
        head-of-line lookahead: a later request that fits now may overtake
        a head that doesn't."""
        req = self.pending.pop(idx)
        req.slot = self._free_slots.pop()
        if not req.start_t:   # preempted re-admissions keep the first stamp
            req.start_t = time.monotonic()
        req.state = PREFILLING
        self.running[req.slot] = req
        return req

    def retire(self, slot: int) -> Request:
        req = self.running.pop(slot)
        req.done = True
        req.state = DONE
        req.finish_t = time.monotonic()
        req.slot = None
        self._free_slots.append(slot)
        return req

    def preempt(self, slot: int) -> Request:
        """Evict the request occupying ``slot`` back into the pending queue
        (state PREEMPTED) and free the slot. The caller reclaims its cache
        pages and rebuilds ``serve_tokens``; the original rid keeps its
        FIFO position within its priority class."""
        req = self.running.pop(slot)
        req.slot = None
        req.state = PREEMPTED
        self._free_slots.append(slot)
        bisect.insort(self.pending, req)
        return req

    def escalate(self, slot: int) -> Request:
        """Cancel the request occupying ``slot`` for mid-stream quality
        escalation and free the slot. Unlike ``preempt`` the request does
        NOT re-enter THIS scheduler's queue — it leaves the tier: the
        caller (the pool's hand-off) delivers it to the next tier up,
        whose ``requeue`` re-enqueues it for an ordinary re-admission.
        The caller reclaims cache pages and rebuilds ``serve_tokens``."""
        req = self.running.pop(slot)
        req.slot = None
        req.state = ESCALATED
        self._free_slots.append(slot)
        return req

    def requeue(self, req: Request) -> Request:
        """Enqueue a request arriving from ANOTHER tier's scheduler (an
        escalated hand-off) at its (priority, arrival) position. No state
        write and no fresh submit stamp: the request stays ESCALATED until
        ``admit`` flips it to PREFILLING, and its latency/TTFT clocks keep
        running across the tier change."""
        bisect.insort(self.pending, req)
        return req

    def drop_pending(self, req: Request) -> Request:
        """Remove a queued request (deadline expiry / load shedding). The
        caller stamps its finish state."""
        self.pending.remove(req)
        return req

    def prefilling_slots(self) -> List[int]:
        """Slots mid-prompt, in admission order (dict insertion order)."""
        return [s for s, r in self.running.items() if r.state == PREFILLING]

    def decoding_slots(self) -> List[int]:
        return sorted(s for s, r in self.running.items()
                      if r.state == DECODING)
