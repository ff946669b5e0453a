"""Declared slot/request lifecycle of the port's engine: who may write
which state transition.

``repro_torch.serving.scheduler`` owns the state constants and the edge
list (``TRANSITIONS``); this module declares the *sites* — which function
is allowed to perform which edges, where finish reasons are assigned, and
what the initial/terminal states are. ``fsm_check`` extracts the actual
assignments from the source and reconciles the three declarations:
discovered sites vs ``ASSIGNMENT_SITES`` (both directions — an undeclared
writer and a stale declaration are both findings), site edges vs
``TRANSITIONS`` (an edge no site can drive is dead; a site edge missing
from the table is undeclared), and graph properties (every state reachable
from ``INITIAL``, terminal reachable from every state, exactly one
terminal).

The sites are the port's own: its one-shot admission moves a slot to
DECODING in ``ContinuousEngine._prefill_one_shot``, where the reference's
engine does it in ``_admit``.

Module keys are the serving module stems: "scheduler", "engine", "pool".
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.serving import scheduler as sched

Edge = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class FsmSpec:
    """The whole declared FSM, bundled so fixture tests can supply a mini
    spec against a known-bad module."""
    states: Tuple[str, ...]
    initial: str
    terminal: Tuple[str, ...]
    edges: Tuple[Edge, ...]
    # (module key, qualname) -> edges that site may perform
    assignment_sites: Dict[Tuple[str, str], Tuple[Edge, ...]]
    # class qualnames whose ``state`` field default is the initial state
    initial_sites: Tuple[Tuple[str, str], ...]
    # functions that assign ``.finish_reason`` (exactly once each); all
    # other finish_reason writes outside class-body defaults are findings
    reason_sites: Tuple[Tuple[str, str], ...]
    finish_reasons: Tuple[str, ...]
    # name -> state value, for resolving ``from .scheduler import X as Y``
    states_by_name: Dict[str, str]


def default_spec() -> FsmSpec:
    S = sched
    return FsmSpec(
        states=(S.QUEUED, S.PREFILLING, S.DECODING, S.DRAFTING,
                S.VERIFYING, S.PREEMPTED, S.ESCALATED, S.DONE),
        initial=S.QUEUED,
        terminal=(S.DONE,),
        edges=tuple(S.TRANSITIONS),
        assignment_sites={
            ("scheduler", "ContinuousScheduler.admit"):
                ((S.QUEUED, S.PREFILLING), (S.PREEMPTED, S.PREFILLING),
                 (S.ESCALATED, S.PREFILLING)),
            ("scheduler", "ContinuousScheduler.retire"):
                ((S.PREFILLING, S.DONE), (S.DECODING, S.DONE)),
            ("scheduler", "ContinuousScheduler.preempt"):
                ((S.DECODING, S.PREEMPTED),),
            ("scheduler", "ContinuousScheduler.escalate"):
                ((S.DECODING, S.ESCALATED),),
            ("engine", "ContinuousEngine._finish_unslotted"):
                ((S.QUEUED, S.DONE), (S.PREEMPTED, S.DONE),
                 (S.ESCALATED, S.DONE)),
            ("engine", "ContinuousEngine._prefill_one_shot"):
                ((S.PREFILLING, S.DECODING),),
            ("engine", "ContinuousEngine._dispatch_prefill"):
                ((S.PREFILLING, S.DECODING),),
            ("engine", "ContinuousEngine._spec_round"):
                ((S.DECODING, S.DRAFTING), (S.DRAFTING, S.VERIFYING),
                 (S.VERIFYING, S.DECODING)),
        },
        initial_sites=(("scheduler", "Request"),),
        reason_sites=(("engine", "ContinuousEngine._retire"),
                      ("engine", "ContinuousEngine._finish_unslotted")),
        finish_reasons=tuple(S.FINISH_REASONS),
        states_by_name={
            "QUEUED": S.QUEUED, "PREFILLING": S.PREFILLING,
            "DECODING": S.DECODING, "DRAFTING": S.DRAFTING,
            "VERIFYING": S.VERIFYING, "PREEMPTED": S.PREEMPTED,
            "ESCALATED": S.ESCALATED, "DONE": S.DONE,
        },
    )
