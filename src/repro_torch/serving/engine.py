"""Serving engines (the port of ``repro.serving.engine``): the dense-batch
``Engine`` and the core of the continuous paged ``ContinuousEngine``.

* **Dense batch** (``Engine``): one synchronous fixed-shape batch at a
  time. Requests are padded to a power-of-two bucket and a shared prompt
  width; the batch gets a dense KV slab sized ``prompt + max_new`` per
  request and decodes for ``max_new_tokens`` steps regardless of where EOS
  lands (``serving.generate``). Prefill runs the flash-attention kernel,
  each decode step the dense decode-attention kernel.

* **Continuous paged** (``ContinuousEngine``): a step-driven engine over a
  fixed number of serving *slots* and a shared paged KV pool
  (``serving.cache.PagedKVCache`` + ``serving.scheduler.
  ContinuousScheduler``). Each slot moves QUEUED -> PREFILLING -> DECODING
  -> DONE. One ``step()``::

  1. ADMIT    pending requests claim free slots (state PREFILLING) while the
              pool can hold their full prompt minus the pages already
              promised to other mid-prefill slots, with a head-of-line
              lookahead of ``n_slots`` requests. One-shot admission
              (``prefill_chunk=0``) instead prefills the whole prompt on
              the dense path (the flash kernel), scatters its dense KV
              cache into freshly allocated pages and samples the first
              token, so the slot decodes this same step;
  2. PREFILL  a per-step token budget (one chunk width per slot)
              is spent on PREFILLING slots in admission order, at most one
              chunk per slot per step, charged at each chunk's bucketed
              width. The due chunks are page-extended in one batched call,
              then *packed*: slots sharing a bucketed chunk width stack into
              one (B_chunk, width) batch and one paged prefill-attention
              launch per layer, which writes every chunk's K/V straight
              into the pool. Chunk widths are bucketed (full chunks at
              ``prefill_chunk``, the ragged tail padded to a power of two)
              and the packed batch is padded to a power of two. When a
              prompt's last chunk lands, the LM head runs on that row alone,
              the first token is sampled and the slot flips to DECODING.
              ``prefill_pack=0`` restores the per-slot B=1 dispatch loop
              (the packed path's parity baseline);
  3. DECODE   every DECODING slot emits one token (one paged decode-
              attention launch per layer);
  4. RETIRE   EOS / per-request cap / context cap free the slot and record a
              ``finish_reason``.

Live-bounded page walks (``walk_bound="live"``, the default): both kernels'
page walks are bounded by the live maximum context of the dispatch,
rounded up to a power of two of pages; ``walk_bound="static"`` walks the
full table width (the parity baseline). Sliding-window layers also start
their walk late: at the page holding the dispatch's earliest in-window
key, floored to a power of two (``_window_start``; 0 under the static
walk or without window layers). ``decode_compiles`` and
``prefill_compiles`` count the distinct (bound, wstart) and
(batch, width, bound, wstart) launch shapes, the keys the reference jits
on.

SSM stacks keep constant-size per-slot recurrent state
(``serving.cache.RecurrentStatePool``) beside zero-layer page pools:
prefill rows gather and scatter their slot's state row (padding rows the
scratch row 0), and each decode step advances the rows of the active
slots.

Greedy-exactness: at temperature 0 the engine emits, per request, the
tokens of the reference engine on the same weights, whatever the
admission interleaving (tests/test_torch_serving.py,
tests/test_torch_window_serving.py). Each request samples at its own
temperature (``submit(temperature=)``, else the engine's), so greedy and
sampled rows share a step; sampled rows draw from the engine's own
``torch.Generator`` (``set_rng_salt``, ``reseed``).

Under load (tests/test_torch_preemption.py): requests carry a
``priority`` (higher admits first, FIFO within a class), a ``deadline_s``
from submission and a ``timeout_s`` from first admission; an expired
request retires "deadline", mid-stream if need be. When no slot or no
pages are free and a strictly higher-priority request waits, the
lowest-priority, latest DECODING slot is PREEMPTED: its pages are freed and prompt + emitted
tokens re-queue as one chunked prefill, whose last chunk samples the
token decode would have emitted next (greedy-exact across evictions; a
request preempted ``max_preemptions`` times becomes immune). A prompt
that could never fit the pool, and the loser of a full bounded queue
(``max_pending``), retire "rejected" at submit and surface through the
next ``step``. A step where nothing can progress climbs the stall
ladder: it waits while pages are held outside any slot
(``PagedKVCache.hold_pages``), else evicts one running slot
(``_resolve_stall``), else raises.

Escalation (tests/test_torch_escalation.py): with an
``EscalationMonitor`` set, every decode step also scores each slot's
uncertainty from the logits it sampled from, and a stream whose smoothed
score reaches the monitor's threshold is cancelled like a preemption
but lands in the escalated buffer, for the pool to re-admit one tier up.

Not ported yet, each with a later slice: shared-prefix reuse and
speculative decoding.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.data import tokenizer as tok
from repro_torch.models.model import ModelBundle
from .cache import PagedKVCache, RecurrentStatePool
from .generate import _sample_rows, _stream_seed, build_generate_fn
from .scheduler import (DECODING, DONE as SCHED_DONE, ContinuousScheduler,
                        Request)


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def window_start_page(min_first_key: int, page_size: int) -> int:
    """First page of a sliding-window page walk whose earliest in-window
    key is ``min_first_key``: the page holding it, floored to a power of
    two (0 when that page is 0), so the walk covers every row's window
    and the distinct walk starts stay few."""
    page = max(min_first_key, 0) // page_size
    b = 1
    while b * 2 <= page:
        b *= 2
    return b if page else 0


@dataclasses.dataclass
class ServeStats:
    requests: int = 0
    batches: int = 0
    gen_tokens: int = 0
    wall_s: float = 0.0
    compiles: int = 0            # distinct (bucket, prompt-len) batch shapes
                                 # (the reference's jit compiles)
    pad_slots: int = 0           # bucket-padding rows across batches
    slot_count: int = 0          # total rows (incl. padding) across batches
    kv_high_water_bytes: int = 0  # largest dense KV slab held by one batch

    @property
    def padding_waste(self) -> float:
        """Fraction of batch rows that were bucket padding, not requests."""
        return self.pad_slots / self.slot_count if self.slot_count else 0.0


class Engine:
    """Serves one model, dense-batch mode. Queries are padded token arrays
    (N, Lq). ``params`` is the ``Decoder`` module, whose device is where
    every batch runs."""

    def __init__(self, bundle: ModelBundle, params, max_new_tokens: int = 16,
                 temperature: float = 0.0):
        self.bundle = bundle
        self.params = params
        self.device = next(params.parameters()).device
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self._gen = build_generate_fn(bundle, max_new_tokens, temperature)
        self._shapes: set = set()   # (bucket, prompt_len) already run
        self.stats = ServeStats()

    def _run(self, tokens: np.ndarray, seed: int):
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return self._gen(self.params, {"tokens": torch.tensor(
            tokens, device=self.device)}, g)

    def warmup(self, prompt_len: int, max_batch: int):
        """Run every bucket up to ``max_batch`` at ``prompt_len`` once, so
        first-request latency doesn't pay for library handles, kernel
        builds and allocator growth."""
        b = 1
        while b <= _bucket(max_batch):
            self._run(np.full((b, prompt_len), tok.PAD, np.int32), 0)
            if (b, prompt_len) not in self._shapes:
                self._shapes.add((b, prompt_len))
                self.stats.compiles += 1
            b *= 2

    def _kv_slab_bytes(self, batch: int, prompt_len: int) -> int:
        cfg = self.bundle.cfg
        if not cfg.n_kv_heads:
            return 0
        seq = prompt_len + self.max_new_tokens
        itemsize = 4 if cfg.dtype == "float32" else 2
        return (cfg.n_layers * batch * seq * cfg.n_kv_heads
                * cfg.resolved_head_dim * 2 * itemsize)

    def serve(self, query_tokens: np.ndarray, seed: int = 0
              ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (responses (N, T), lengths (N,))."""
        n = len(query_tokens)
        b = _bucket(n)
        Lq = query_tokens.shape[1]
        padded = np.full((b, Lq), tok.PAD, np.int32)
        padded[:n] = query_tokens
        if (b, Lq) not in self._shapes:
            self._shapes.add((b, Lq))
            self.stats.compiles += 1
        t0 = time.monotonic()
        toks, lens = self._run(padded, seed)
        toks, lens = toks.cpu().numpy()[:n], lens.cpu().numpy()[:n]
        self.stats.requests += n
        self.stats.batches += 1
        self.stats.gen_tokens += int(lens.sum())
        self.stats.wall_s += time.monotonic() - t0
        self.stats.pad_slots += b - n
        self.stats.slot_count += b
        self.stats.kv_high_water_bytes = max(
            self.stats.kv_high_water_bytes, self._kv_slab_bytes(b, Lq))
        return toks, lens


def make_engine(bundle: ModelBundle, params, **kw):
    """Engine factory honouring the config's cache-layout flag:
    ``cfg.cache_layout == "paged"`` selects the continuous-batching paged
    engine, anything else the dense-batch engine. Continuous-only kwargs
    (n_slots, max_seq, ...) are dropped for dense."""
    if bundle.cfg.cache_layout == "paged":
        return ContinuousEngine(bundle, params, **kw)
    return Engine(bundle, params, **{k: v for k, v in kw.items()
                                     if k in ("max_new_tokens", "temperature")})


@dataclasses.dataclass
class ContinuousStats:
    steps: int = 0               # steps that did any work (decode, prefill,
                                 # admission, or retirement)
    decode_steps: int = 0        # steps that dispatched a decode
    prefill_steps: int = 0       # steps that advanced at least one chunk
    prefill_only_steps: int = 0  # steps that prefilled but decoded nothing
    admitted: int = 0
    retired: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_chunks: int = 0      # slot-chunks advanced (one slot, one chunk)
    prefill_dispatches: int = 0  # packed prefill dispatches (<= chunks)
    prefill_compiles: int = 0    # distinct (batch, width, bound, wstart)
                                 # prefill shapes launched
    decode_compiles: int = 0     # distinct (bound, wstart) decode walks
    prefill_stalls: int = 0      # chunk extensions deferred for pool space
    occupancy_sum: int = 0       # busy slots summed over steps
    admission_stalls: int = 0    # admissions deferred for page-pool space
    preemptions: int = 0         # DECODING slots evicted (prompt + emitted
                                 # tokens re-queued)
    reprefill_tokens: int = 0    # tokens queued for re-prefill by evictions
    escalations: int = 0         # DECODING slots cancelled up a tier (the
                                 # re-prefill is the upper tier's cost)
    sheds: int = 0               # requests retired "rejected"
    deadline_misses: int = 0     # requests retired "deadline"
    stall_steps: int = 0         # zero-progress steps waited out while
                                 # pages were held (hold_pages)
    wall_s: float = 0.0


# the escalation monitor's smoothing weight on a stream's newest score
ESC_EMA = 0.5


@dataclasses.dataclass
class EscalationMonitor:
    """Mid-stream quality watch over one tier's decode logits.

    Each decode step scores every slot's next-token distribution
    (``uncertainty``: the mean of normalised entropy and 1 - top-2 margin,
    both in [0, 1]); the monitor smooths it per stream with weight
    ``ESC_EMA`` on the newest step and records each stream's peak in
    ``Request.esc_peak_score``. With ``abort_threshold=None`` that is all
    (the observe-only pass whose peaks
    ``core.thresholds.calibrate_abort_threshold`` turns into a
    threshold). With a threshold, a DECODING stream whose smoothed score
    reaches it after ``min_tokens`` emitted tokens is cancelled (pages
    freed, prompt + emitted tokens kept as ``serve_tokens``) into the
    engine's escalated buffer, which the pool re-admits one tier up.
    Monitors belong on a pool's tiers below the priciest.
    """
    abort_threshold: Optional[float] = None   # None = observe-only
    min_tokens: int = 4     # emitted tokens before a stream may abort

    def __post_init__(self):
        if self.min_tokens < 1:
            raise ValueError(f"min_tokens={self.min_tokens}: a stream must "
                             "emit at least one token before escalating "
                             "(its prefix is the hand-off payload)")


def uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """Per-row uncertainty of (B, V) next-token logits: the mean of the
    entropy normalised by log V and 1 - (top-1 - top-2 probability), in
    [0, 1]. V is the padded vocab, as the reference takes it; padded
    columns hold the most negative finite logit, so their probability is
    0 and they add nothing."""
    lg = logits.reshape(logits.shape[0], -1).float()
    p = torch.softmax(lg, dim=-1)
    ent = -(p * torch.log(p + 1e-9)).sum(-1) / math.log(lg.shape[-1])
    top2 = torch.topk(p, 2, dim=-1).values
    return 0.5 * ent + 0.5 * (1.0 - (top2[:, 0] - top2[:, 1]))


class ContinuousEngine:
    """Step-driven continuous-batching engine over a paged KV cache.

    ``bundle`` is a ``ModelBundle``; ``params`` its ``Decoder`` module,
    whose device (``cuda`` unless the caller built it on the CPU) is where
    the pool lives and every step runs. ``submit`` enqueues a request,
    ``step`` advances the world by at most one decode token per occupied
    slot, ``run`` drains the queue and ``serve`` is the batch API.

    Units: prompts/outputs in TOKENS, cache capacity and walk bounds in
    PAGES (``page_size`` tokens each), progress in engine STEPS.
    """

    def __init__(self, bundle: ModelBundle, params, max_new_tokens: int = 16,
                 temperature: float = 0.0, *, n_slots: int = 8,
                 page_size: Optional[int] = None, max_seq: int = 256,
                 num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_pack: Optional[int] = None,
                 walk_bound: str = "live",
                 max_pending: Optional[int] = None,
                 max_preemptions: int = 3,
                 escalation: Optional[EscalationMonitor] = None):
        self.bundle = bundle
        self.params = params
        self.device = next(params.parameters()).device
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        ps = page_size or bundle.cfg.kv_page_size
        mp = _round_up(max_seq, ps) // ps
        if num_pages is None:
            num_pages = 1 + n_slots * mp      # page 0 reserved
        self.cache = PagedKVCache(bundle, n_slots, num_pages, ps, mp,
                                  device=self.device)
        # SSM stacks keep constant-size per-slot recurrent state beside
        # the page pool
        self.rstate = RecurrentStatePool(bundle, n_slots, self.device) \
            if bundle.init_recurrent_state is not None else None
        self.sched = ContinuousScheduler(n_slots)
        self.stats = ContinuousStats()
        self.n_slots = n_slots
        # chunked admission: prefill_chunk tokens per chunk (None -> the
        # config's knob; 0 -> one-shot whole-prompt prefill), one chunk
        # width per slot of prefill per step
        if prefill_chunk is None:
            prefill_chunk = bundle.cfg.prefill_chunk
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk={prefill_chunk}: chunked "
                             "admission needs a non-negative size "
                             "(0 disables chunking)")
        if prefill_chunk == 0 and self.rstate is not None:
            # one-shot admission scatters a dense KV cache into pages;
            # recurrent state has no page-shaped form to scatter, so SSM
            # prompts must stream through chunked prefill
            raise ValueError(f"{bundle.cfg.name}: recurrent-state stacks "
                             "admit through chunked prefill; prefill_chunk "
                             "must be > 0")
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = n_slots * prefill_chunk
        # packed prefill: up to prefill_pack PREFILLING slots stack into one
        # dispatch per bucketed chunk width (0 = per-slot B=1 dispatch, the
        # packed path's parity baseline)
        if prefill_pack is None:
            prefill_pack = n_slots
        if prefill_pack < 0:
            raise ValueError(f"prefill_pack={prefill_pack}: packed prefill "
                             "needs a non-negative pack size (0 disables "
                             "packing)")
        self.prefill_pack = prefill_pack
        if walk_bound not in ("live", "static"):
            raise ValueError(f"walk_bound={walk_bound!r}: expected 'live' "
                             "or 'static'")
        self.walk_bound = walk_bound
        # under load: a bounded pending queue that sheds (None =
        # unbounded) and a per-request preemption cap (a request evicted
        # this often becomes immune, so none starves)
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending={max_pending}: a bounded queue "
                             "needs room for at least one request")
        if max_preemptions < 0:
            raise ValueError(f"max_preemptions={max_preemptions}: the "
                             "preemption cap must be non-negative")
        self.max_pending = max_pending
        self.max_preemptions = max_preemptions
        self._shed_buf: List[Request] = []   # retired outside step(), for
                                             # the next step/run result
        # mid-stream escalation: the monitor (settable any time, None =
        # off), each slot's smoothed score, and the streams cancelled up a
        # tier since the pool last drained them
        self.escalation = escalation
        self._esc_score = np.zeros((n_slots,), np.float32)
        self._escalated_buf: List[Request] = []
        self._chunk_shapes: set = set()   # (batch, width, bound, wstart)
        self._decode_bounds: set = set()  # (bound, wstart)
        self._next_in = np.full((n_slots,), tok.PAD, np.int32)
        # per-slot sampling temperature: a request's own (or the engine
        # default) lands here at admission
        self._temps = np.full((n_slots,), temperature, np.float32)
        self._rng_salt = 0
        self._serve_calls = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(_stream_seed(0, self._rng_salt))

    # ------------------------------------------------------------ sampling
    def set_rng_salt(self, salt: int):
        """Give this engine a distinct sampling stream (sibling engines in a
        pool are typically built with the same default seed)."""
        self._rng_salt = salt
        self._gen.manual_seed(_stream_seed(0, salt))

    def reseed(self, seed: int):
        """Start a fresh deterministic sampling stream for one serve call,
        mixing the caller's seed, this engine's salt and a per-call
        counter, so repeated calls (and sibling engines) never reuse a
        stream."""
        self._gen.manual_seed(_stream_seed(seed, self._rng_salt,
                                           self._serve_calls))
        self._serve_calls += 1

    # -------------------------------------------------------------- requests
    def _req_temp(self, req: Request) -> float:
        """A request's sampling temperature: its own, or the engine's."""
        return self.temperature if req.temperature is None \
            else req.temperature

    def submit(self, tokens: np.ndarray, max_new_tokens: Optional[int] = None,
               *, priority: int = 0, deadline_s: Optional[float] = None,
               timeout_s: Optional[float] = None,
               temperature: Optional[float] = None) -> Request:
        """Enqueue one request. ``tokens``: 1-d int prompt (no padding);
        ``max_new_tokens``: per-request output cap (None = the engine
        default); ``priority``: admission class (higher first);
        ``deadline_s`` / ``timeout_s``: seconds from submission / from
        first admission before the request retires "deadline";
        ``temperature``: this request's sampling temperature (None = the
        engine default, 0 = greedy).

        Malformed requests raise. A prompt that could never complete in
        this pool (past the slot's context cap, or a worst-case footprint
        past the whole pool) and the loser of a full bounded queue are
        shed: they come back done, finish reason "rejected", and surface
        through the next ``step``."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if len(tokens) == 0:
            raise ValueError("empty prompt: a request needs at least one "
                             "token to prefill")
        max_new = self.max_new_tokens if max_new_tokens is None \
            else max_new_tokens
        if max_new < 1:
            raise ValueError(f"max_new_tokens={max_new}: a request must be "
                             "allowed at least one output token")
        if temperature is not None and temperature < 0:
            raise ValueError(f"temperature={temperature}: negative "
                             "temperatures are meaningless (0 = greedy)")
        req = Request(tokens=tokens, max_new_tokens=max_new,
                      priority=priority, deadline_s=deadline_s,
                      timeout_s=timeout_s, temperature=temperature)
        req.submit_t = time.monotonic()
        if not self._could_fit(len(tokens), max_new):
            return self._shed(req)
        if self.max_pending is not None \
                and len(self.sched.pending) >= self.max_pending:
            # full queue: shed the least urgent of (arrival, worst queued),
            # lowest priority and latest arrival first, so a high-priority
            # burst displaces stale low-priority backlog
            victim = min(self.sched.pending,
                         key=lambda r: (r.priority, -r.rid))
            if (victim.priority, -victim.rid) < (req.priority, -req.rid):
                self.sched.drop_pending(victim)
                self._shed(victim)
            else:
                return self._shed(req)
        return self.sched.submit(req)

    def _could_fit(self, n_tokens: int, max_new: int) -> bool:
        """Whether a request of ``n_tokens`` to prefill and ``max_new``
        tokens still to emit could complete alone in this pool: its worst
        case is every token but the last written, bounded by the slot's
        context cap."""
        cap = self.cache.max_pages_per_slot * self.cache.page_size
        peak = self.cache.pages_for(min(n_tokens + max_new - 1, cap))
        return n_tokens + 1 <= cap and peak <= self.cache.stats.num_pages

    def _finish_unslotted(self, req: Request, reason: str,
                          sink: Optional[List[Request]] = None) -> Request:
        """Retire a request that holds no slot (shed at submit, expired in
        the queue) into ``sink`` when mid-step, else into the shed buffer
        for the next step()/run() result."""
        req.done = True
        req.state = SCHED_DONE
        req.finish_reason = reason
        req.finish_t = time.monotonic()
        (self._shed_buf if sink is None else sink).append(req)
        return req

    def _shed(self, req: Request) -> Request:
        self.stats.sheds += 1
        return self._finish_unslotted(req, "rejected")

    def drain_shed(self) -> List[Request]:
        """Requests retired outside a step since the last drain. step()
        and run() fold them into their results; a pool drains them every
        step for its accounting."""
        out, self._shed_buf = self._shed_buf, []
        return out

    def _release_slot(self, slot: int) -> None:
        """Free ``slot``'s pages and per-slot state (retire, preempt and
        escalate alike)."""
        self.cache.free_slot(slot)
        self._next_in[slot] = tok.PAD
        self._temps[slot] = self.temperature
        self._esc_score[slot] = 0.0

    def _retire(self, slot: int, reason: str) -> Request:
        self._release_slot(slot)
        self.stats.retired += 1
        req = self.sched.retire(slot)
        req.finish_reason = reason
        if reason == "deadline":
            self.stats.deadline_misses += 1
        return req

    def _evict(self, slot: int) -> Request:
        """Free a DECODING slot and rebuild its request's prefill source as
        prompt + emitted tokens (preemption and escalation alike). The
        resumed prefill's last chunk samples the token decode would have
        emitted next. It fits: a live slot has at most max_new - 1 emitted
        tokens and seq_lens + 1 <= the context cap, so serve_tokens stays
        inside the bounds submit checked."""
        req = self.sched.running[slot]
        self._release_slot(slot)
        req.serve_tokens = np.concatenate(
            [req.tokens, np.asarray(req.out, np.int32)])
        req.prefill_pos = 0
        return req

    def _preempt(self, slot: int) -> Request:
        """Evict ``slot`` mid-decode back into this engine's queue
        (recompute from pages)."""
        req = self._evict(slot)
        req.preemptions += 1
        req.reprefill_tokens += len(req.serve_tokens)
        self.stats.preemptions += 1
        self.stats.reprefill_tokens += len(req.serve_tokens)
        return self.sched.preempt(slot)

    def _escalate(self, slot: int) -> Request:
        """Cancel ``slot`` mid-decode for the tier above: evicted as by
        ``_preempt``, but the request leaves this tier. Its re-prefill runs
        on (and is billed to) the upper tier, so no reprefill_tokens are
        charged here."""
        req = self._evict(slot)
        req.escalations += 1
        self.stats.escalations += 1
        return self.sched.escalate(slot)

    def _watch_escalation(self, slots: List[int], unc: np.ndarray) -> None:
        """Feed this step's per-slot uncertainty to the monitor: smooth it
        per stream, track each stream's peak, and escalate a DECODING
        stream whose smoothed score reached the threshold. Runs after the
        step's retirements, so a stream that just finished never
        escalates."""
        mon = self.escalation
        for slot in slots:
            req = self.sched.running.get(slot)
            if req is None or req.state != DECODING:
                continue
            s = ESC_EMA * float(unc[slot]) \
                + (1.0 - ESC_EMA) * float(self._esc_score[slot])
            self._esc_score[slot] = s
            req.esc_peak_score = max(req.esc_peak_score, s)
            if mon.abort_threshold is not None \
                    and req.n_generated >= mon.min_tokens \
                    and s >= mon.abort_threshold:
                self._escalated_buf.append(self._escalate(slot))

    def drain_escalated(self) -> List[Request]:
        """Streams cancelled up a tier since the last drain; the pool hands
        each to the next tier's ``resubmit``."""
        out, self._escalated_buf = self._escalated_buf, []
        return out

    def resubmit(self, req: Request) -> Request:
        """Take an escalated stream from the tier below: re-queue it for an
        ordinary admission, its prompt + emitted tokens prefilled as one
        chunk stream. The bounded queue does not apply (the pool already
        admitted it); the capacity shed does."""
        if not self._could_fit(len(req.serve_tokens),
                               req.max_new_tokens - req.n_generated):
            return self._shed(req)
        return self.sched.requeue(req)

    def _preemptible(self, floor_priority: Optional[int] = None) -> List[int]:
        """DECODING slots that may be evicted: under the preemption cap
        and, given ``floor_priority``, of strictly lower priority.
        Mid-prefill slots never are: the pages they would free, their
        re-admission needs again at once."""
        return [slot for slot, req in self.sched.running.items()
                if req.state == DECODING
                and req.preemptions < self.max_preemptions
                and (floor_priority is None
                     or req.priority < floor_priority)]

    def _preempt_lowest(self, victims: List[int]) -> None:
        """Preempt the lowest-priority, latest-arriving of ``victims``."""
        self._preempt(min(victims, key=lambda s: (
            self.sched.running[s].priority, -self.sched.running[s].rid)))

    def _try_preempt(self, incoming: Request) -> bool:
        """Evict a slot for ``incoming`` (of strictly higher priority).
        Returns whether one was freed."""
        victims = self._preemptible(floor_priority=incoming.priority)
        if victims:
            self._preempt_lowest(victims)
        return bool(victims)

    def _resolve_stall(self) -> bool:
        """A zero-progress step's escape: evict one running slot (any
        priority, lowest first) when someone else waits for its pages,
        pending work or a second stuck slot. A lone request that cannot
        step gains nothing by evicting itself."""
        if not self.sched.pending and len(self.sched.running) < 2:
            return False
        victims = self._preemptible()
        if victims:
            self._preempt_lowest(victims)
        return bool(victims)

    def _expire(self, retired: List[Request]) -> None:
        """Retire every request past its deadline or timeout, "deadline":
        queued ones dropped, running ones mid-stream (their emitted tokens
        kept)."""
        now = time.monotonic()
        for req in [r for r in self.sched.pending if r.expired(now)]:
            self.sched.drop_pending(req)
            self.stats.deadline_misses += 1
            self._finish_unslotted(req, "deadline", sink=retired)
        for slot in [s for s, r in self.sched.running.items()
                     if r.expired(now)]:
            retired.append(self._retire(slot, "deadline"))

    def _push_token(self, req: Request, token: int) -> Optional[Request]:
        """Record an emitted token; retire on EOS / request cap."""
        req.out.append(int(token))
        req.token_t.append(time.monotonic())
        if token == tok.EOS:
            return self._retire(req.slot, "eos")
        if req.n_generated >= req.max_new_tokens:
            return self._retire(req.slot, "length")
        self._next_in[req.slot] = token
        return None

    def _reserved_prefill_pages(self) -> int:
        """Pages the mid-prefill slots still need for the rest of their
        prompts (chunked admission allocates incrementally, so these are
        not in use yet and admission must not hand them out)."""
        r = 0
        for slot in self.sched.prefilling_slots():
            req = self.sched.running[slot]
            r += self.cache.pages_for(len(req.serve_tokens)) \
                - self.cache.owned_pages(slot)
        return r

    def _admit(self, retired: List[Request]) -> int:
        """Claim free slots for pending requests, priority then FIFO, with
        a head-of-line lookahead of ``n_slots`` requests: when the head
        doesn't fit the pool right now, the first of the next queued
        requests that does fit overtakes it. When no slot is free, or
        nothing in the window fits, and the head outranks a DECODING slot,
        that slot is preempted for it. Chunked mode just assigns the slot
        (chunks run in ``_prefill_step``); one-shot mode prefills the whole
        prompt now (``_prefill_one_shot``). Returns admissions plus
        preemptions made for the head."""
        admitted = 0
        while self.sched.pending:
            if not self.sched.has_free_slot:
                if self._try_preempt(self.sched.pending[0]):
                    admitted += 1   # a slot was freed for the head
                    continue
                break
            reserve = self._reserved_prefill_pages()
            idx = next(
                (i for i, r in enumerate(
                    self.sched.pending[:self.n_slots])
                 if self.cache.can_admit(len(r.serve_tokens),
                                         reserve=reserve)), None)
            if idx is None:
                self.stats.admission_stalls += 1
                if self._try_preempt(self.sched.pending[0]):
                    continue   # pages freed: scan the window again
                break
            req = self.sched.admit(idx)
            self._temps[req.slot] = self._req_temp(req)
            admitted += 1
            self.stats.admitted += 1
            if not self.prefill_chunk:
                self._prefill_one_shot(req, retired)
        return admitted

    def _prefill_one_shot(self, req: Request,
                          retired: List[Request]) -> None:
        """One-shot admission: the whole prompt through the dense prefill
        (``bundle.prefill``: the flash kernel), its (L, 1, Spad, K, D)
        cache scattered in place into the pages that ``extend_slot``
        gives the empty slot (Spad the prompt rounded up to whole pages,
        so each position lands in the page and row chunked prefill would
        write), then the first token sampled from the prefill logits. The
        slot decodes this same step."""
        n_tok = len(req.serve_tokens)
        ps = self.cache.page_size
        logits, kv = self.bundle.prefill(
            self.params, {"tokens": self._tensor(req.serve_tokens[None])},
            _round_up(n_tok, ps))
        pages = self.cache.extend_slot(req.slot, n_tok)
        idx = self._tensor(pages).long()
        for name, dense in (("k_pages", kv["k"]), ("v_pages", kv["v"])):
            L, _, _, K, D = dense.shape
            self.cache.pool[name].index_copy_(
                1, idx, dense[:, 0].reshape(L, len(pages), ps, K, D))
        del kv     # the transient dense cache
        self.stats.prefill_tokens += n_tok
        req.prefill_pos = n_tok
        req.state = DECODING
        first = _sample_rows(self._gen, logits, [self._req_temp(req)])
        done = self._push_token(req, int(first[0]))
        if done is not None:
            retired.append(done)

    # --------------------------------------------------------------- prefill
    def _pages_bound(self, max_tokens: int) -> int:
        """Page bound for a dispatch whose live contexts reach at most
        ``max_tokens``: the live page count rounded up to a power of two,
        capped at the table width. ``walk_bound="static"`` always returns
        the full width."""
        mp = self.cache.max_pages_per_slot
        if self.walk_bound != "live":
            return mp
        return min(_bucket(self.cache.pages_for(max(max_tokens, 1))), mp)

    def _chunk_width(self, remaining: int) -> int:
        """Bucketed width of the next chunk: full chunks at prefill_chunk,
        ragged tails at a power of two capped by the chunk width."""
        return self.prefill_chunk if remaining >= self.prefill_chunk \
            else min(_bucket(remaining), self.prefill_chunk)

    def _window_start(self, min_first_key: int) -> int:
        """First page of the sliding-window layers' page walk, for a
        dispatch whose earliest in-window key (over the rows dispatched)
        is ``min_first_key`` (``window_start_page``). 0 without window
        layers or under the static walk."""
        if not self.bundle.cfg.has_window_layers \
                or self.walk_bound != "live":
            return 0
        return window_start_page(min_first_key, self.cache.page_size)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never an alias: the host side
        mutates its arrays while the device may still read the step)."""
        return torch.tensor(a, device=self.device)

    def _model_cache(self) -> dict:
        """What the model's paged calls update in place: the page pools,
        and the recurrent state of an SSM stack as ``"rec"``."""
        if self.rstate is None:
            return self.cache.pool
        return {**self.cache.pool, "rec": self.rstate.state}

    def _dispatch_prefill(self, group: List[tuple], width: int,
                          retired: List[Request]) -> None:
        """Launch ONE prefill step over the stacked chunks of ``group``
        ((req, n_new) rows sharing the bucketed chunk ``width``), the batch
        padded to a power of two. Padding rows carry n_new=0, an all-zero
        page-table row and state row 0, so their K/V writes land on the
        reserved scratch page, their attention is fully masked, and their
        recurrent-state writes land on the reserved scratch row. The page
        walk is bounded by the group's live maximum context, and window
        layers start it at the real rows' first live window page."""
        B = _bucket(len(group))
        mp = self.cache.max_pages_per_slot
        chunk = np.full((B, width), tok.PAD, np.int32)
        pt = np.zeros((B, mp), np.int32)
        start = np.zeros((B,), np.int32)
        n_new = np.zeros((B,), np.int32)
        rows = np.zeros((B,), np.int32)          # 0 = scratch state row
        for i, (req, n) in enumerate(group):
            chunk[i, :n] = req.serve_tokens[req.prefill_pos:
                                            req.prefill_pos + n]
            pt[i] = self.cache.page_table[req.slot]
            start[i] = req.prefill_pos
            n_new[i] = n
            if self.rstate is not None:
                rows[i] = self.rstate.rows(req.slot)
        bound = self._pages_bound(int((start + n_new).max()))
        # the earliest key any real row's first chunk query sees under the
        # window: min(start) - (window - 1); padding rows do not count
        w = self.bundle.cfg.sliding_window
        wstart = self._window_start(
            int(start[:len(group)].min()) - max(w - 1, 0))
        if (B, width, bound, wstart) not in self._chunk_shapes:
            self._chunk_shapes.add((B, width, bound, wstart))
            self.stats.prefill_compiles += 1
        x_last = self.bundle.prefill_paged_chunk(
            self.params, self._model_cache(), self._tensor(chunk),
            self._tensor(pt), self._tensor(start), self._tensor(n_new),
            pages_bound=bound, window_start=wstart, state_rows=None if self.rstate is None
            else self._tensor(rows))
        self.stats.prefill_dispatches += 1
        finishing = []
        for i, (req, n) in enumerate(group):
            req.prefill_pos += n
            self.stats.prefill_tokens += n
            self.stats.prefill_chunks += 1
            if req.prefill_pos == len(req.serve_tokens):
                finishing.append((i, req))
        if finishing:
            # the vocab projection runs only on the rows whose prompt just
            # finished: their logits sample each request's first token
            rows = [i for i, _ in finishing]
            logits = self.bundle.lm_head(self.params, x_last[rows])[:, 0]
            first = _sample_rows(self._gen, logits,
                                 [self._req_temp(r) for _, r in finishing])
            for (_, req), token in zip(finishing, first.cpu().numpy()):
                req.state = DECODING
                done = self._push_token(req, int(token))
                if done is not None:
                    retired.append(done)

    def _prefill_step(self, retired: List[Request]) -> List[int]:
        """Advance each PREFILLING slot by AT MOST one chunk, in admission
        order, within the step's token budget (charged at the bucketed
        width; the first chunk always runs, and an over-budget slot is
        skipped rather than ending the scan). The due chunks are
        page-extended in one batched call (a stalled row drops out, its
        budget returns), then dispatched packed. Returns the slots
        advanced."""
        budget = self.prefill_budget
        ready: List[tuple] = []       # (req, n_new, width) advancing
        advanced: List[int] = []
        pending = self.sched.prefilling_slots()
        while pending:
            cand: List[tuple] = []
            cand_slots: List[int] = []
            skipped: List[int] = []
            for slot in pending:
                req = self.sched.running[slot]
                remaining = len(req.serve_tokens) - req.prefill_pos
                width = self._chunk_width(remaining)
                if (ready or cand) and budget < width:
                    skipped.append(slot)
                    continue
                cand.append((req, min(remaining, width), width))
                cand_slots.append(slot)
                budget -= width
            if not cand:
                break
            got = self.cache.extend_slots(cand_slots,
                                          [n for _, n, _ in cand])
            refunded = False
            for slot, (req, n, width), pages in zip(cand_slots, cand, got):
                if pages is None:     # page stall: row drops out, rest run
                    self.stats.prefill_stalls += 1
                    budget += width
                    refunded = True
                else:
                    ready.append((req, n, width))
                    advanced.append(slot)
            pending = skipped if refunded else []
        if self.prefill_pack == 0:    # per-slot dispatch (B=1)
            for req, n, width in ready:
                self._dispatch_prefill([(req, n)], width, retired)
        else:
            by_width: Dict[int, List[tuple]] = {}
            for req, n, width in ready:
                by_width.setdefault(width, []).append((req, n))
            for width, rows in by_width.items():
                for i in range(0, len(rows), self.prefill_pack):
                    self._dispatch_prefill(rows[i:i + self.prefill_pack],
                                           width, retired)
        return advanced

    # ------------------------------------------------------------------ step
    @torch.no_grad()
    def step(self) -> List[Request]:
        """Retire expired requests, admit (preempting where priority
        demands), advance prefill chunks under the step budget, decode one
        token per DECODING slot, retire, and let the escalation monitor
        see the decoded slots. Returns the requests completed during this
        step, those shed since the last step included. Runs without
        autograd, so serving a module fresh from training builds no
        graph."""
        t0 = time.monotonic()
        retired: List[Request] = self.drain_shed()
        self._expire(retired)
        progressed = self._admit(retired)
        prefilled: List[int] = []
        if self.prefill_chunk:
            prefilled = self._prefill_step(retired)
            progressed += len(prefilled)
        cap = self.cache.max_pages_per_slot * self.cache.page_size
        # decode growth must not eat pages promised to mid-prefill slots
        reserve = self._reserved_prefill_pages()
        steppable = []
        for slot in self.sched.decoding_slots():
            pos = int(self.cache.seq_lens[slot])
            if pos + 1 > cap:
                retired.append(self._retire(slot, "context_cap"))
            elif self.cache.ensure_append(slot, reserve=reserve):
                steppable.append(slot)
        if steppable:
            active = np.zeros((self.n_slots,), bool)
            active[steppable] = True
            pt, sl = self.cache.device_tables(self.device)
            # every steppable slot's context, including the token this step
            # writes, fits in ``bound`` pages; inactive slots may exceed it
            # and their output is garbage the step masks
            bound = self._pages_bound(
                int(self.cache.seq_lens[steppable].max()) + 1)
            # window layers start their walk at the steppable slots' first
            # live window page: slot b's earliest in-window key is
            # (seq_lens[b] + 1) - window
            wstart = self._window_start(
                int(self.cache.seq_lens[steppable].min()) + 1
                - self.bundle.cfg.sliding_window)
            if (bound, wstart) not in self._decode_bounds:
                self._decode_bounds.add((bound, wstart))
                self.stats.decode_compiles += 1
            logits = self.bundle.decode_step_paged(
                self.params, self._model_cache(),
                self._tensor(self._next_in[:, None]), pt, sl,
                self._tensor(active), pages_bound=bound, window_start=wstart)
            # each slot at its request's temperature; idle rows take the
            # argmax: no draw is spent on garbage
            temps = np.where(active, self._temps, 0.0)
            nxt = _sample_rows(self._gen, logits, temps)
            if self.escalation is not None:
                # the monitor's scores ride the tokens' one copy to the
                # host, as int32 bits
                both = torch.cat([nxt, uncertainty(logits).view(torch.int32)])
                both = both.cpu().numpy()
                nxt, unc = both[:self.n_slots], \
                    both[self.n_slots:].view(np.float32)
            else:
                nxt = nxt.cpu().numpy()
            self.cache.seq_lens[steppable] += 1
            for slot in steppable:
                self.stats.decode_tokens += 1
                done = self._push_token(self.sched.running[slot],
                                        int(nxt[slot]))
                if done is not None:
                    retired.append(done)
            self.stats.decode_steps += 1
            if self.escalation is not None:
                self._watch_escalation(steppable, unc)
        elif not progressed and not retired \
                and (self.sched.running or self.sched.pending):
            # nothing decoded, no prefill advanced, nothing admitted or
            # retired, yet work remains. The ladder: pages held outside any
            # slot make it back-pressure, so wait; else evict a running
            # slot if that unwedges anyone; else occupied slots all stalled
            # on pages, or a pending request can't admit into an otherwise
            # idle pool, and neither can ever resolve
            if self.cache.held_pages:
                self.stats.stall_steps += 1
            elif self._resolve_stall():
                progressed += 1
            else:
                raise RuntimeError(
                    "page pool deadlock: no slot could step and no request "
                    "could admit or retire; provision more pages")
        if steppable or progressed or retired:
            self.stats.steps += 1
            self.stats.occupancy_sum += len(set(steppable) | set(prefilled))
            if prefilled:
                self.stats.prefill_steps += 1
                if not steppable:
                    self.stats.prefill_only_steps += 1
        self.stats.wall_s += time.monotonic() - t0
        return retired

    def run(self) -> List[Request]:
        """Drain the queue; returns all requests retired during the drain,
        those shed at submit included."""
        done: List[Request] = self.drain_shed()
        while self.sched.has_work:
            done.extend(self.step())
        return done

    def serve(self, query_tokens: np.ndarray, seed: int = 0
              ) -> tuple[np.ndarray, np.ndarray]:
        """Batch API: submit every row of ``query_tokens`` (N, L) int32,
        drain, return (responses (N, T) int32 PAD-tailed, lengths (N,)
        generated-token counts)."""
        self.reseed(seed)
        reqs = [self.submit(row) for row in query_tokens]
        self.run()
        T = self.max_new_tokens
        out = np.full((len(reqs), T), tok.PAD, np.int32)
        lens = np.zeros((len(reqs),), np.int32)
        for i, r in enumerate(reqs):
            lens[i] = r.n_generated
            out[i, :r.n_generated] = r.out[:T]
        return out, lens
