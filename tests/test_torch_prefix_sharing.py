"""Shared-prefix KV reuse in the port against the JAX package
(tests/test_prefix_sharing.py's eleven cases): the radix tree and the
refcounted page pool give the same pages, counts, evictions and audits
for the same operation sequences; on bridged weights the engines emit
the same tokens and the same prefix counters for fan-out over a system
prompt, multi-turn chat, a fork inside a page (copy-on-write) and a
preempted stream resumed through the tree; the same tiers refuse with
the same reasons. Inside the port, ``prefix_cache > 0`` emits the tokens
of ``prefix_cache=0``. The reference's outputs are computed here, each of
its dispatches waited on; its engines share their compiled steps
(``test_torch_serving.RefEngines``)."""
import dataclasses
import types

import numpy as np
import pytest

from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import PagedKVCache as JaxCache
from repro.serving.scheduler import DECODING as JAX_DECODING
from repro_torch.serving import faults
from repro_torch.serving.cache import CacheStats, PagedKVCache
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.scheduler import DECODING
from conftest import tiny_cfg
from test_torch_serving import (RefEngines, _np_tree, _tier,  # noqa: F401
                                highest_precision)


@pytest.fixture(scope="module")
def dense():
    return _tier(tiny_cfg("dense"), 0)


@pytest.fixture(scope="module")
def refs():
    return RefEngines()


ENGINE_KW = dict(max_new_tokens=6, n_slots=2, page_size=8, max_seq=64,
                 prefill_chunk=8)


def _pair(dense, refs, **kw):
    """(port engine, reference engine) on the same weights."""
    m, p, bundle, model = dense
    kw = {**ENGINE_KW, **kw}
    return ContinuousEngine(bundle, model, **kw), refs.get(m, p, **kw)


def _toks(rng, n, vocab=256):
    return rng.integers(4, vocab, (n,)).astype(np.int32)


PREFIX_STATS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
                "prefix_hit_pages", "cow_splits", "prefill_tokens",
                "prefill_chunks", "prefill_dispatches", "admitted",
                "retired", "decode_tokens", "preemptions")


def _assert_same_stats(port, ref):
    assert {k: getattr(port.stats, k) for k in PREFIX_STATS} \
        == {k: getattr(ref.stats, k) for k in PREFIX_STATS}
    tp, tr = port.cache.prefix, ref.cache.prefix
    assert (tp is None) == (tr is None)
    if tp is not None:
        assert dataclasses.asdict(tp.stats) == dataclasses.asdict(tr.stats)
        assert tp.resident == tr.resident


def _assert_clean(ce):
    """Slots drained: only tree residents keep pages, refcounts audit."""
    c = ce.cache
    resident = c.prefix.resident if c.prefix is not None else 0
    assert c.stats.pages_in_use == resident
    assert c.free_pages == c.num_pages - 1 - resident
    assert c.check_refcounts() == [] and c.check_pages() == []


# ---------------------------------------------------------------- tree units
def _stub_caches(num_pages=16, page_size=4, prefix_pages=8):
    """(port cache, reference cache) without device pools: tree and
    refcount units only."""
    bundle = types.SimpleNamespace(
        init_paged_cache=lambda n, ps, device=None: None,
        cfg=types.SimpleNamespace(name="stub"))
    kw = dict(n_slots=2, num_pages=num_pages, page_size=page_size,
              max_pages_per_slot=8, prefix_pages=prefix_pages)
    return PagedKVCache(bundle, device="cpu", **kw), JaxCache(bundle, **kw)


def _alloc(c, slot, n):
    """Pages for ``n`` tokens on an empty slot: the reference's
    ``alloc_slot``, the port's ``extend_slot`` (the same pages and
    counts)."""
    if isinstance(c, JaxCache):
        return c.alloc_slot(slot, n)
    return c.extend_slot(slot, n)


def _state(c):
    """Everything the two allocators must agree on (the reference's
    counters of shared pages, which the port does not keep, follow from
    the refcounts)."""
    tree = c.prefix
    stats = {f.name: getattr(c.stats, f.name)
             for f in dataclasses.fields(CacheStats)}
    return (c.page_table.tolist(), c.seq_lens.tolist(), c.ref.tolist(),
            list(c._free), stats,
            None if tree is None else (sorted(tree.resident_page_ids()),
                                       dataclasses.asdict(tree.stats)))


def _both(fn, **kw):
    """Run ``fn(cache)`` on the port's and the reference's stub caches:
    the same returns and the same state after. Returns the port's
    (cache, result)."""
    port, ref = _stub_caches(**kw)
    got, want = fn(port), fn(ref)
    assert got == want
    assert _state(port) == _state(ref)
    return port, got


def test_tree_publish_match_and_partial_fork():
    """Full-page walk plus at most ONE partial tail page: the tree stores
    only completed pages, so a fork inside a page maps it for COW."""
    a = np.arange(100, 112, dtype=np.int32)          # 3 full pages @ ps=4

    def ops(c):
        tree = c.prefix
        pa = _alloc(c, 0, len(a))
        out = [tree.publish(a, pa), tree.resident, tree.publish(a, pa)]
        q, q2 = a.copy(), a.copy()
        q[9] += 1                                    # fork inside page 3
        q2[8] += 1                                   # fork on a boundary
        for query in (a, a[:10], q, q2):
            pages, matched = tree.match(query)
            out.append(([int(x) for x in pages], matched))
        out += [tree.peek_pages(a), tree.peek_pages(a[:10]),
                [int(x) for x in pa]]
        c.free_slot(0)
        out.append(c.check_refcounts())
        return out

    _, out = _both(ops)
    pa = out[-2]
    assert out[:3] == [3, 3, 0]
    assert out[3] == (pa, 12)
    assert out[4][1] == 10 and len(out[4][0]) == 3
    assert out[5][1] == 9 and len(out[5][0]) == 3
    assert out[6][1] == 8 and len(out[6][0]) == 2
    assert out[7:9] == [3, 2] and out[-1] == []


def test_tree_lru_eviction_and_cap():
    """Unreferenced (tree-only) pages evict LRU leaves first; the cap and
    allocation pressure both reclaim them, and a page a slot maps is
    never evicted."""
    a = np.arange(0, 8, dtype=np.int32)
    b = np.concatenate([a[:4], np.arange(50, 54, dtype=np.int32)])

    def ops(c):
        tree, out = c.prefix, []
        tree.publish(a, _alloc(c, 0, 8))
        c.free_slot(0)
        out.append((tree.resident, c.stats.pages_in_use))
        tree.publish(b, _alloc(c, 0, 8))
        c.free_slot(0)
        out.append(tree.resident)
        pages, matched = tree.match(a)
        c.map_shared(1, pages, matched)
        out.append((tree.evictable(), tree.resident))
        got = _alloc(c, 0, (c.free_pages + 1) * c.page_size)
        out.append((got is not None, tree.stats.evicted_pages,
                    c.check_refcounts()))
        c.free_slot(0)
        c.free_slot(1)
        tree.clear()
        out.append((c.stats.pages_in_use, c.free_pages))
        return out

    port, out = _both(ops, num_pages=10, page_size=4, prefix_pages=4)
    assert out[0] == (2, 2) and out[1] == 3
    assert out[2][0] < out[2][1]
    assert out[3][0] and out[3][1] > 0 and out[3][2] == []
    assert out[4] == (0, port.num_pages - 1)


def test_cow_map_truncate_refcounts():
    """map_shared raises counts, cow_page splits a shared page privately,
    truncate_slot and free_slot only decrement through _release, and a
    double free raises."""
    a = np.arange(0, 12, dtype=np.int32)

    def ops(c):
        out = []
        pa = [int(x) for x in _alloc(c, 0, 12)]
        c.prefix.publish(a, pa)
        out.append([int(c.ref[p]) for p in pa])
        pages, matched = c.prefix.match(a[:10])     # 2 exact + part of 3
        c.map_shared(1, pages, matched)
        out.append([int(c.ref[p]) for p in pa])
        out.append(c.page_is_shared(1, 9))
        src, dst = c.cow_page(1, 9)
        out += [src == pa[2] and dst != src, int(c.ref[src]),
                int(c.ref[dst]), c.page_is_shared(1, 9),
                c.stats.cow_splits]
        c.truncate_slot(1, 8)
        out += [int(c.ref[dst]), dst in c._free, int(c.ref[src]),
                c.check_refcounts()]
        c.free_slot(1)
        c.free_slot(0)
        out.append([int(c.ref[p]) for p in pa])
        with pytest.raises(AssertionError):
            c._release([pa[0], pa[0]])
        return out

    _, out = _both(ops)
    assert out[:3] == [[2, 2, 2], [3, 3, 3], True]
    assert out[3:8] == [True, 2, 1, False, 1]
    assert out[8:12] == [0, True, 2, []]
    assert out[12] == [1, 1, 1]


def test_refcount_audit_catches_corruption():
    """check_refcounts audits: a stray reference and a leaked page are
    both findings, on both allocators."""
    def ops(c):
        pa = _alloc(c, 0, 8)
        out = [c.check_refcounts() == []]
        c.ref[int(pa[0])] += 1                     # stray reference
        out.append(c.check_refcounts() != [])
        c.ref[int(pa[0])] -= 1
        leaked = c._free.pop()                     # off-list page at ref 0
        out.append(c.check_refcounts() != [])
        c._free.append(leaked)
        out.append(c.check_refcounts() == [])
        return out

    port, out = _both(ops)
    assert out == [True] * 4
    assert port.check_pages() == []


# ------------------------------------------------------------- engine parity
def test_fanout_parity_and_prefill_budget(dense, refs):
    """Fan-out over one system prompt: followers map the leader's
    published pages; tokens equal the reference's and the port's own
    prefix_cache=0 run, and the skipped chunks never launch."""
    rng = np.random.default_rng(3)
    sys = _toks(rng, 24)                           # 3 full pages @ ps=8
    prompts = [np.concatenate([sys, _toks(rng, 5)]) for _ in range(4)]
    plain, _ = _pair(dense, refs)
    want = [plain.submit(t) for t in prompts]
    plain.run()
    runs = []
    for ce in _pair(dense, refs, prefix_cache=12):
        lead = ce.submit(prompts[0])
        ce.run()                                   # leader publishes
        reqs = [ce.submit(t) for t in prompts[1:]]
        ce.run()
        runs.append((ce, [lead] + reqs))
    (ce, got), (ref, ref_got) = runs
    assert [r.out for r in got] == [r.out for r in ref_got] \
        == [r.out for r in want]
    assert [r.prefix_hit_tokens for r in got] \
        == [r.prefix_hit_tokens for r in ref_got]
    _assert_same_stats(ce, ref)
    assert ce.stats.prefix_hits == 3
    assert all(r.prefix_hit_tokens >= 24 for r in got[1:])
    assert ce.stats.prefill_dispatches < plain.stats.prefill_dispatches
    assert ce.stats.prefill_tokens <= \
        plain.stats.prefill_tokens - ce.stats.prefix_hit_tokens
    _assert_clean(ce)


def test_multiturn_parity(dense, refs):
    """Turn N+1 resends turn N's history; retirement published prompt +
    generated tokens, so the resent history hits."""
    rng = np.random.default_rng(5)
    sys = _toks(rng, 16)

    def turns(eng):
        rng2 = np.random.default_rng(7)
        hist, outs = list(sys), []
        for _ in range(3):
            prompt = np.asarray(hist + list(_toks(rng2, 6)), np.int32)
            r = eng.submit(prompt)
            eng.run()
            hist = list(prompt) + r.out
            outs.append(list(r.out))
        return outs

    plain, _ = _pair(dense, refs, max_seq=96)
    want = turns(plain)
    ce, ref = _pair(dense, refs, max_seq=96, prefix_cache=16)
    assert turns(ce) == turns(ref) == want
    _assert_same_stats(ce, ref)
    assert ce.stats.prefix_hits >= 2 and ce.stats.prefix_hit_tokens > 0
    _assert_clean(ce)


def test_cow_fork_parity(dense, refs):
    """A system prompt ending inside a page: the follower's first write
    splits the leader's published page copy-on-write, and the tokens stay
    those of a run without sharing."""
    rng = np.random.default_rng(11)
    sys = _toks(rng, 20)                           # fork inside page 3
    pa = np.concatenate([sys, _toks(rng, 8)])
    pb = np.concatenate([sys, _toks(rng, 8)])
    plain, _ = _pair(dense, refs)
    want = [plain.submit(pa), plain.submit(pb)]
    plain.run()
    runs = []
    for ce in _pair(dense, refs, prefix_cache=12):
        ra = ce.submit(pa)
        ce.run()
        rb = ce.submit(pb)
        ce.run()
        runs.append((ce, [ra, rb]))
    (ce, got), (ref, ref_got) = runs
    assert [r.out for r in got] == [r.out for r in ref_got] \
        == [r.out for r in want]
    assert got[1].prefix_hit_tokens == 20          # 2 full pages + 4 tokens
    assert ce.stats.cow_splits >= 1
    _assert_same_stats(ce, ref)
    _assert_clean(ce)


def test_preempt_then_resume_hits_tree(dense, refs):
    """Preemption publishes the victim's resident prefix; its resume walks
    the tree instead of re-prefilling, and the stream still matches its
    uncontended run."""
    rng = np.random.default_rng(0)
    lo_prompt, hi_prompt = _toks(rng, 16), _toks(rng, 10)
    runs = []
    for ce, decoding in zip(_pair(dense, refs, n_slots=1, max_seq=48,
                                  prefix_cache=12),
                            (DECODING, JAX_DECODING)):
        lo = ce.submit(lo_prompt, priority=0)
        for _ in range(4):
            ce.step()
        assert lo.state == decoding and lo.n_generated >= 1
        hi = ce.submit(hi_prompt, priority=5)
        ce.step()
        assert lo.preemptions == 1
        ce.run()
        assert lo.done and hi.done
        runs.append((ce, [lo, hi]))
    (ce, got), (ref, ref_got) = runs
    assert [(r.out, r.prefix_hit_tokens) for r in got] \
        == [(r.out, r.prefix_hit_tokens) for r in ref_got]
    assert got[0].prefix_hit_tokens >= 16          # the resume hit
    _assert_same_stats(ce, ref)
    m, p, bundle, model = dense
    assert got[0].out == faults._uncontended(
        bundle, model, lo_prompt, 6, n_slots=1, page_size=8, max_seq=48,
        prefill_chunk=8)
    _assert_clean(ce)


# ------------------------------------------------------ refusal & exactness
def test_fallback_reasons(dense, refs):
    """Tiers that cannot share refuse with the reference's reason and
    serve unshared; attaching a draft drops the tree with a reason."""
    win = _tier(tiny_cfg("dense", n_layers=3, sliding_window=6,
                         local_global_ratio=2, cache_layout="paged"), 1)
    ssm = _tier(tiny_cfg("ssm", cache_layout="paged"), 2)
    draft = _tier(tiny_cfg("dense"), 7)
    cases = [(win, dict(prefix_cache=8), "window"),
             (ssm, dict(prefix_cache=8), "recurrent"),
             (dense, dict(prefix_cache=8, prefill_chunk=0), "one-shot")]
    for (m, p, bundle, model), kw, word in cases:
        kw = {**ENGINE_KW, **kw}
        ce, ref = ContinuousEngine(bundle, model, **kw), JaxEngine(m, p, **kw)
        assert ce.cache.prefix is None and ref.cache.prefix is None
        assert ce.prefix_reason == ref.prefix_reason
        assert word in ce.prefix_reason
    kw = {**ENGINE_KW, "prefix_cache": 8}
    m, p, bundle, model = dense
    de = ContinuousEngine(bundle, model, **kw)
    dr = JaxEngine(m, p, **kw)
    assert de.cache.prefix is not None
    de.attach_draft(draft[2], draft[3], gamma=2)
    dr.attach_draft(draft[0], draft[1], gamma=2)
    assert de.cache.prefix is None and de.prefix_reason == dr.prefix_reason
    assert "draft" in de.prefix_reason
    assert de.cache.check_refcounts() == []
    with pytest.raises(ValueError, match="non-negative"):
        ContinuousEngine(bundle, model, prefix_cache=-1)


def test_prefix_cache_zero_is_exact_default(dense, refs):
    """prefix_cache=0 is the engine without sharing: no tree, no extra
    pages, no reason, every page at one reference at most."""
    ce, ref = _pair(dense, refs)
    assert ce.cache.prefix is None and ce.prefix_reason is None
    assert ce.cache.num_pages == ref.cache.num_pages \
        == 1 + 2 * ce.cache.max_pages_per_slot
    prompt = _toks(np.random.default_rng(1), 12)
    r, rr = ce.submit(prompt), ref.submit(prompt)
    ce.run()
    ref.run()
    assert r.done and r.out == rr.out and int(ce.cache.ref.max()) <= 1
    assert ce.cache.check_refcounts() == []


def test_chaos_prefix_thrash_invariants():
    """The port's chaos scenario: page pressure thrashing a warm tree mid
    admission emits the tokens of a tier without sharing, with clean
    refcounts (the scenario asserts its own invariants)."""
    h = faults.scenario_prefix_thrash(verbose=False, device="cpu")
    assert h.check_invariants() == []
    eng = h.engines["a"]
    assert eng.cache.prefix.stats.evicted_pages > 0
    assert eng.stats.prefix_hits > 0
