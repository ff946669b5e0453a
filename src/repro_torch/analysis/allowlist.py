"""Recorded exceptions to the analysis rules. Every entry names the rule,
the site, and — mandatorily — the reason the invariant is intentionally
bypassed there. The runner fails (exit 2) on an entry with no reason or one
matching no live finding, so this list can only hold real, justified
exceptions.

``host-sync`` entries name the functions of the serving step that read a
device value back by design; matching is by function, so a new read-back
in one of them needs no new entry, and one anywhere else fails the run.
"""
from __future__ import annotations

from .report import AllowEntry

_SYNC = "host-sync"

ALLOWLIST = (
    AllowEntry(
        rule="ledger-free-escape",
        path="cache.py",
        symbol="PagedKVCache.hold_pages",
        reason="External page-pressure hook (fault injection / ops): takes "
               "pages OUT of circulation directly off the free list. Only "
               "refcount-0 pages can sit on the free list (_release "
               "guarantees it), so no reference arithmetic is skipped; "
               "held pages are counted in held_pages and audited by "
               "check_pages (free + held + live pages make the pool)."),
    AllowEntry(
        rule="ledger-free-escape",
        path="cache.py",
        symbol="PagedKVCache.release_pages",
        reason="Inverse of hold_pages: returns externally-held pages whose "
               "refcount stayed 0 for the whole hold (they were never "
               "mapped), so routing through _release would underflow the "
               "count. Guarded by the held_pages count (it raises on "
               "releasing more than are held) and the check_pages audit."),
    AllowEntry(
        rule=_SYNC, path="serving/engine.py",
        symbol="ContinuousEngine.step",
        reason="The continuous step reads the emitted tokens back once a "
               "step (one copy; the escalation monitor's scores ride it) "
               "to decide retirement and the next step's inputs on the "
               "host. Its int() of seq_lens.max()/min() is numpy, the "
               "allocator's host array."),
    AllowEntry(
        rule=_SYNC, path="serving/engine.py",
        symbol="ContinuousEngine._dispatch_prefill",
        reason="Reads back the first tokens of the rows whose prompts "
               "finished in this dispatch (only those rows run the vocab "
               "projection): whether each retires and what it feeds next "
               "is decided on the host. Its int() of start/n_new "
               "reductions is numpy, the dispatch's host arrays."),
    AllowEntry(
        rule=_SYNC, path="serving/engine.py",
        symbol="ContinuousEngine._draft",
        reason="Speculation: each draft micro-step's sampled tokens come "
               "back to the host, where the candidate lists and the next "
               "micro-step's inputs are built. Its int() of "
               "seq_lens.max() is numpy."),
    AllowEntry(
        rule=_SYNC, path="serving/engine.py",
        symbol="ContinuousEngine._spec_round",
        reason="Speculation: the target's argmax over the verify chunk "
               "comes back once a round (greedy acceptance runs on the "
               "host), and a sampled row's target and draft distributions "
               "for _spec_accept_sampled. Its int() of (start + "
               "n_new).max() is numpy."),
    AllowEntry(
        rule=_SYNC, path="serving/engine.py",
        symbol="ContinuousEngine._spec_accept_sampled",
        reason="Speculative sampling's uniforms are drawn on the engine's "
               "generator, on its device, so a seed names one stream, and "
               "read back for the host-side acceptance test; only sampled "
               "speculative rows reach it."),
    AllowEntry(
        rule=_SYNC, path="serving/engine.py", symbol="Engine.serve",
        reason="The dense batch engine reads its tokens and lengths back "
               "once a serve: they are the serve's result. Its int() of "
               "lens.sum() is numpy, after that copy."),
    AllowEntry(
        rule=_SYNC, path="serving/generate.py", symbol="sample_responses",
        reason="Each sampled batch's tokens and lengths are copied into "
               "the host result arrays, once a batch."),
    AllowEntry(
        rule=_SYNC, path="serving/hybrid.py", symbol="HybridEngine.serve",
        reason="The router's scores come back once a serve to partition "
               "the queries between the tiers on the host; the .any() "
               "tests are numpy, on that partition's mask."),
    AllowEntry(
        rule=_SYNC, path="models/moe.py", symbol="moe_forward",
        reason="One read-back a MoE layer: the kept assignments' count per "
               "expert sizes each expert's matmul, so only kept rows are "
               "multiplied (the alternative multiplies every token by "
               "every expert)."),
    AllowEntry(
        rule=_SYNC, path="serving/cache.py",
        symbol="PagedKVCache.fragmentation",
        reason="No device value: seq_lens is the allocator's numpy array, "
               "and int() of its sum is host arithmetic the lint cannot "
               "tell from a tensor reduction."),
)
