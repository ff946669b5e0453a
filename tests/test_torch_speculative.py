"""Cross-tier speculative decoding in the port against the JAX package
(tests/test_speculative.py's eleven functions, thirteen cases): on
bridged weights the speculative engines emit the reference's tokens and
the same round, draft, verify and ledger counters (a distinct-weights
draft at gamma 1, 2 and 4, under preemption, and self-speculation);
rollback frees both pools; window and SSM tiers refuse with the
reference's reasons; ``StepPlan`` builds the reference's plans. Inside
the port, speculation emits the tokens of plain decoding. Sampled
speculation is held by its ledger and by distribution: the first token
``_spec_accept_sampled`` emits follows the target's softmax."""
import numpy as np
import pytest

from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import ContinuousPoolEngine as JaxPool
from repro.serving import PagedKVCache as JaxCache
from repro.serving import StepPlan as JaxStepPlan
from repro.serving.faults import StaticPolicy as JaxStaticPolicy
from repro_torch.serving.cache import PagedKVCache
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.faults import StaticPolicy
from repro_torch.serving.pool import ContinuousPoolEngine, StepPlan
from conftest import tiny_cfg
from test_torch_serving import (RefEngines, _np_tree, _tier,  # noqa: F401
                                highest_precision)


@pytest.fixture(scope="module")
def dense():
    return _tier(tiny_cfg("dense"), 0)


@pytest.fixture(scope="module")
def draft():
    """A draft with weights of its own (seed 7): low acceptance, much
    rollback."""
    return _tier(tiny_cfg("dense"), 7)


@pytest.fixture(scope="module")
def refs():
    return RefEngines()


ENGINE_KW = dict(max_new_tokens=8, n_slots=2, page_size=8, max_seq=64)


def _pair(dense, refs, draft=None, gamma=0, **kw):
    """(port engine, reference engine) on the same weights, each with
    ``draft`` (a tier, or "self") attached at ``gamma``."""
    m, p, bundle, model = dense
    kw = {**ENGINE_KW, **kw}
    port = ContinuousEngine(bundle, model, **kw)
    if draft is None:
        return port, refs.get(m, p, **kw)
    dm, dp, dbundle, dmodel = dense if draft == "self" else draft
    port.attach_draft(dbundle, dmodel, gamma=gamma)
    return port, refs.get(m, p, draft=(dm, dp), gamma=gamma, **kw)


def _prompts(rng, n, lo=4, hi=14, vocab=256):
    return [rng.integers(4, vocab, (int(l),)).astype(np.int32)
            for l in rng.integers(lo, hi, (n,))]


def _serve(eng, prompts, **kw):
    reqs = [eng.submit(t, **kw) for t in prompts]
    eng.run()
    return reqs


SPEC_STATS = ("spec_rounds", "draft_steps", "verify_steps",
              "drafted_tokens", "accepted_tokens", "rejected_tokens",
              "spec_fallbacks", "decode_steps", "decode_tokens",
              "prefill_dispatches", "preemptions", "retired")


def _assert_same(port, ref, preqs, rreqs):
    """Both engines served their requests alike: tokens, per-request
    ledgers, the speculative counters and the rollback truncations."""
    assert [r.out for r in preqs] == [r.out for r in rreqs]
    assert [(r.drafted_tokens, r.accepted_tokens, r.rejected_tokens)
            for r in preqs] == [(r.drafted_tokens, r.accepted_tokens,
                                 r.rejected_tokens) for r in rreqs]
    assert {k: getattr(port.stats, k) for k in SPEC_STATS} \
        == {k: getattr(ref.stats, k) for k in SPEC_STATS}
    assert port.stats.acceptance_rate == ref.stats.acceptance_rate
    assert port.cache.stats.truncations == ref.cache.stats.truncations


def _assert_clean(ce):
    """Both pools drained: every page back, zero fragmentation, clean
    refcounts."""
    for c in (ce.cache, ce.draft_cache) if ce.draft_cache is not None \
            else (ce.cache,):
        assert c.stats.pages_in_use == 0
        assert c.free_pages == c.num_pages - 1
        assert c.fragmentation == 0.0 and c.check_refcounts() == []


# --------------------------------------------------------------------- parity
@pytest.mark.parametrize("gamma", [1, 2, 4])
def test_spec_parity_greedy_exact(dense, draft, refs, gamma):
    """A distinct-weights draft (near-zero acceptance, maximal rollback):
    every emitted token equals plain decoding's, for any gamma, and the
    port's counters equal the reference's."""
    prompts = _prompts(np.random.default_rng(gamma), 6)
    want = [r.out for r in _serve(_pair(dense, refs)[0], prompts)]
    spec, ref = _pair(dense, refs, draft, gamma)
    reqs, rreqs = _serve(spec, prompts), _serve(ref, prompts)
    assert [r.out for r in reqs] == want
    _assert_same(spec, ref, reqs, rreqs)
    st = spec.stats
    assert st.spec_rounds > 0 and st.drafted_tokens > 0
    assert st.drafted_tokens == st.accepted_tokens + st.rejected_tokens
    for r in reqs:
        assert r.drafted_tokens == r.accepted_tokens + r.rejected_tokens
    _assert_clean(spec)


def test_spec_parity_under_preemption(dense, draft, refs):
    """A stream evicted mid-speculation resumes by a chunked re-prefill
    mirrored into the draft pool, and still emits its uncontended plain
    tokens, as the reference's does."""
    candidates = _prompts(np.random.default_rng(0), 12, lo=8, hi=14)
    probed = _serve(_pair(dense, refs, max_new_tokens=16)[0], candidates)
    long_ones = [(t, r.out) for t, r in zip(candidates, probed)
                 if r.n_generated >= 12]
    assert len(long_ones) >= 2, "the tiny model ended every probe early"
    (lo_prompt, lo_want), (hi_prompt, hi_want) = long_ones[:2]
    runs = []
    for spec in _pair(dense, refs, draft, 2, n_slots=1, max_new_tokens=16):
        lo = spec.submit(lo_prompt, priority=0)
        for _ in range(2):
            spec.step()
        assert lo.n_generated >= 1 and not lo.done
        hi = spec.submit(hi_prompt, priority=5)
        spec.run()
        assert lo.preemptions == 1 and lo.done and hi.done
        runs.append((spec, [lo, hi]))
    (spec, reqs), (ref, rreqs) = runs
    assert [r.out for r in reqs] == [lo_want, hi_want]
    _assert_same(spec, ref, reqs, rreqs)
    _assert_clean(spec)


def test_self_speculation_saves_target_steps(dense, refs):
    """Draft == target (the same module; only a second page pool): high
    acceptance, and fewer target launches than tokens emitted."""
    prompts = _prompts(np.random.default_rng(1), 4)
    spec, ref = _pair(dense, refs, "self", 2)
    assert spec.draft_params is spec.params
    reqs, rreqs = _serve(spec, prompts), _serve(ref, prompts)
    _assert_same(spec, ref, reqs, rreqs)
    st = spec.stats
    assert st.accepted_tokens > 0 and st.acceptance_rate > 0.5
    assert st.decode_tokens > 0
    assert (st.decode_steps + st.verify_steps) / st.decode_tokens < 1.0
    assert all(r.done for r in reqs)
    _assert_clean(spec)


@pytest.mark.parametrize("gamma", [2, 3])
def test_self_speculation_catch_up_after_resume(dense, refs, gamma):
    """Self-speculation with a stream preempted and resumed: every full
    accept leaves the draft one token behind, and the next round feeds
    it the missing tokens first. The port feeds prompt + emitted tokens,
    so after the resume its draft still proposes the target's own
    tokens: no request rejects a token outside its last round (the one
    the output cap cuts), and the tokens are plain decoding's. The
    reference feeds ``serve_tokens + out``, which after a resume repeats
    the tokens emitted before it (ROADMAP.md, Queue 3): the same tokens,
    but its resumed stream rejects more (here; a stream that repeats
    itself with a period dividing the tokens emitted before the
    preemption hides the misplacement, as at gamma 4)."""
    candidates = _prompts(np.random.default_rng(0), 12, lo=8, hi=14)
    probed = _serve(_pair(dense, refs, max_new_tokens=16)[0], candidates)
    long_ones = [(t, r.out) for t, r in zip(candidates, probed)
                 if r.n_generated >= 12]
    assert len(long_ones) >= 2, "the tiny model ended every probe early"
    (lo_prompt, lo_want), (hi_prompt, hi_want) = long_ones[:2]
    runs = []
    for spec in _pair(dense, refs, "self", gamma, n_slots=1,
                      max_new_tokens=16):
        lo = spec.submit(lo_prompt, priority=0)
        while lo.n_generated < 1 + gamma:
            spec.step()
        hi = spec.submit(hi_prompt, priority=5)
        spec.run()
        assert lo.preemptions == 1 and lo.done and hi.done
        runs.append((spec, [lo, hi]))
    (spec, reqs), (ref, rreqs) = runs
    for r in reqs + rreqs:
        assert r.drafted_tokens == r.accepted_tokens + r.rejected_tokens
    assert [r.out for r in reqs] == [r.out for r in rreqs] \
        == [lo_want, hi_want]
    assert all(r.accepted_tokens > 0 and r.rejected_tokens < gamma
               for r in reqs)
    assert rreqs[0].rejected_tokens > reqs[0].rejected_tokens
    _assert_clean(spec)


# ---------------------------------------------------------- rollback accounting
def test_rollback_truncation_page_audit(dense, draft, refs):
    """Rejected suffixes roll back by truncate_slot on both pools; after
    the drain every page is back on both free lists."""
    prompts = _prompts(np.random.default_rng(2), 5)
    spec, ref = _pair(dense, refs, draft, 4, max_new_tokens=10)
    reqs, rreqs = _serve(spec, prompts), _serve(ref, prompts)
    _assert_same(spec, ref, reqs, rreqs)
    assert spec.stats.rejected_tokens > 0
    assert spec.cache.stats.truncations > 0
    assert all(r.done for r in reqs)
    _assert_clean(spec)


def test_truncate_slot_unit(dense):
    m, _, bundle, _ = dense
    caches = (PagedKVCache(bundle, n_slots=1, num_pages=8, page_size=4,
                           max_pages_per_slot=6, device="cpu"),
              JaxCache(m, n_slots=1, num_pages=8, page_size=4,
                       max_pages_per_slot=6))
    for c in caches:
        if isinstance(c, JaxCache):
            c.alloc_slot(0, 10)               # 3 pages
        else:
            c.extend_slot(0, 10)
        assert c.stats.pages_in_use == 3
        with pytest.raises(ValueError):
            c.truncate_slot(0, 11)            # cannot grow
        with pytest.raises(ValueError):
            c.truncate_slot(0, -1)
        freed = c.truncate_slot(0, 5)         # 2 pages keep 5 tokens
        assert len(freed) == 1 and c.stats.pages_in_use == 2
        assert int(c.seq_lens[0]) == 5 and c.stats.truncations == 1
        assert (np.asarray(c.page_table[0][2:]) == 0).all()
        c.truncate_slot(0, 5)                 # no-op at the same length
        assert c.stats.pages_in_use == 2
        c.free_slot(0)
        assert c.stats.pages_in_use == 0
    assert caches[0]._free == caches[1]._free


# ------------------------------------------------------------------- refusals
def _side(tier, i):
    """(bundle, weights) of a ``_tier`` for side ``i``: 0 the port, 1 the
    reference."""
    return tier[2:] if i == 0 else tier[:2]


def _refusing_tiers():
    win = _tier(tiny_cfg("dense", n_layers=3, sliding_window=6,
                         local_global_ratio=2, cache_layout="paged",
                         kv_page_size=4, prefill_chunk=4), 1)
    ssm = _tier(tiny_cfg("ssm", cache_layout="paged", prefill_chunk=4), 2)
    return win, ssm


def test_window_and_ssm_tiers_refuse_speculation(dense):
    """Tiers that cannot roll back a rejected suffix (window, recurrent
    state) are skipped by the step plan with the reference's reasons, and
    the port's pool still serves them without speculation."""
    win, ssm = _refusing_tiers()
    assert win[2].verify_paged_chunk is None
    assert ssm[2].verify_paged_chunk is None
    plans = []
    for i, (Engine, Pool, Policy) in enumerate(
            ((ContinuousEngine, ContinuousPoolEngine, StaticPolicy),
             (JaxEngine, JaxPool, JaxStaticPolicy))):
        engines = [(name, Engine(*_side(t, i), **{
            **ENGINE_KW, **({"page_size": 4} if name == "window" else {})}))
            for name, t in (("dense", dense), ("window", win),
                            ("ssm", ssm))]
        plans.append(Pool(Policy(3), engines, spec_gamma=2))
    pool, ref = plans
    assert (pool.plan.gamma, pool.plan.pairs, pool.plan.skipped) \
        == (ref.plan.gamma, ref.plan.pairs, ref.plan.skipped)
    assert pool.plan.pairs == () and set(dict(pool.plan.skipped)) == {1, 2}
    assert "roll back" in dict(pool.plan.skipped)[1]
    rng = np.random.default_rng(3)
    reqs = [pool.submit_to(t, pr) for t in ("window", "ssm")
            for pr in _prompts(rng, 2, lo=4, hi=10)]
    pool.run()
    assert all(r.done and r.finish_reason in ("eos", "length")
               for r in reqs)
    assert all(r.drafted_tokens == 0 for r in reqs)


def test_attach_draft_rejects_incapable_pairs(dense):
    win, ssm = _refusing_tiers()

    def refusals(i, Engine):
        m, p = _side(dense, i)
        out = []
        for eng, args in (
                (Engine(m, p, **ENGINE_KW), (m, p, 0)),
                (Engine(m, p, **ENGINE_KW), (*_side(win, i), 2)),
                (Engine(m, p, **ENGINE_KW), (*_side(ssm, i), 2)),
                (Engine(*_side(ssm, i), **ENGINE_KW), (m, p, 2)),
                (Engine(m, p, **ENGINE_KW, prefill_chunk=0), (m, p, 2))):
            with pytest.raises(ValueError) as e:
                eng.attach_draft(*args[:2], gamma=args[2])
            out.append(str(e.value))
        return out

    got = refusals(0, ContinuousEngine)
    assert got == refusals(1, JaxEngine)
    for msg, want in zip(got, ("at least one drafted token",
                               "pure global attention",
                               "pure global attention", "no verify path",
                               "prefill_chunk must be > 0")):
        assert want in msg


def test_step_plan_build_validation(dense):
    plans = []
    for i, (Engine, Plan) in enumerate(((ContinuousEngine, StepPlan),
                                        (JaxEngine, JaxStepPlan))):
        m, p = _side(dense, i)
        engines = [Engine(m, p, **ENGINE_KW), Engine(m, p, **ENGINE_KW)]
        with pytest.raises(ValueError, match="cannot be negative"):
            Plan.build(engines, -1)
        assert Plan.build(engines, 0) == Plan()
        plan = Plan.build(engines, 2)
        assert plan.pairs == ((0, 1),) and plan.draft_of == {1: 0}
        # a tier aliasing its own engine cannot draft for itself
        shared = Plan.build([engines[0], engines[0]], 2)
        assert shared.pairs == ()
        plans.append((plan.pairs, shared.skipped))
    assert plans[0] == plans[1]
    assert "share one engine" in plans[0][1][0][1]


# ---------------------------------------------------------------- temperature
def test_per_request_temperature_mixes_greedy_and_sampled(dense, refs):
    """A temperature-0 request inside a sampled engine emits the
    reference's greedy tokens; sampled siblings draw at their own
    temperature beside it."""
    prompts = _prompts(np.random.default_rng(4), 3, lo=6, hi=10)
    _, ref = _pair(dense, refs)
    want = _serve(ref, prompts[:1])[0].out
    mixed = _pair(dense, refs, temperature=0.9, n_slots=3)[0]
    g = mixed.submit(prompts[0], temperature=0.0)
    s1 = mixed.submit(prompts[1])                     # engine default 0.9
    s2 = mixed.submit(prompts[2], temperature=0.5)
    mixed.run()
    assert g.out == want
    assert all(r.done for r in (g, s1, s2))
    with pytest.raises(ValueError):
        mixed.submit(prompts[0], temperature=-0.1)


def test_pool_submit_temperature_array(dense, refs):
    """The pool's submit takes an (N,) array of temperatures; its greedy
    rows emit the reference's greedy tokens."""
    prompts = _prompts(np.random.default_rng(5), 4, lo=6, hi=10)
    W = max(len(t) for t in prompts)
    toks = np.zeros((4, W), np.int32)
    mask = np.zeros((4, W), bool)
    for i, t in enumerate(prompts):
        toks[i, :len(t)] = t
        mask[i, :len(t)] = True
    m, p, bundle, model = dense
    pool = ContinuousPoolEngine(StaticPolicy(2), [
        ("a", ContinuousEngine(bundle, model, **{**ENGINE_KW,
                                                 "temperature": 0.7})),
        ("b", ContinuousEngine(bundle, model, **ENGINE_KW))])
    reqs, _, _ = pool.submit(toks, mask,
                             temperature=np.array([0.0, 0.8, 0.0, 0.3]))
    pool.run()
    want = _serve(refs.get(m, p, **ENGINE_KW), [prompts[0], prompts[2]])
    assert [reqs[0].out, reqs[2].out] == [r.out for r in want]


def test_sampled_speculation_ledger_balances(dense):
    """Sampled speculation (the accept/reject rule) through a pool whose
    tier b drafts on tier a: the ledger balances per request, per engine
    and in the meter's columns, and both pools drain clean."""
    _, _, bundle, model = dense
    pool = ContinuousPoolEngine(StaticPolicy(2, tier=1), [
        ("a", ContinuousEngine(bundle, model, **ENGINE_KW)),
        ("b", ContinuousEngine(bundle, model, **{**ENGINE_KW,
                                                 "temperature": 0.8}))],
        spec_gamma=2)
    assert pool.plan.pairs == ((0, 1),)
    reqs = [pool.submit_to("b", t)
            for t in _prompts(np.random.default_rng(6), 4)]
    pool.run()
    st = pool.engine("b").stats
    assert st.drafted_tokens > 0
    assert st.drafted_tokens == st.accepted_tokens + st.rejected_tokens
    assert all(r.done and r.drafted_tokens == r.accepted_tokens
               + r.rejected_tokens for r in reqs)
    m = pool.meter
    assert m.drafted[0] == st.drafted_tokens and m.drafted[1] == 0
    assert (m.accepted[1], m.rejected[1]) == (st.accepted_tokens,
                                              st.rejected_tokens)
    _assert_clean(pool.engine("b"))


def test_spec_accept_sampled_follows_the_target(dense):
    """Standard speculative sampling: with candidates drawn from the
    draft's distribution, the first emitted token is distributed as the
    target's softmax at the slot's temperature (within 0.012 of each
    probability over 20000 seeded draws; the binomial standard deviation
    is at most 0.0036)."""
    _, _, bundle, model = dense
    eng = ContinuousEngine(bundle, model, **ENGINE_KW)
    eng._gen.manual_seed(11)
    rng = np.random.default_rng(12)
    V, gamma, tau, n = 6, 2, 0.8, 20000
    row = rng.normal(0, 1.5, (gamma + 1, V))
    dlog = rng.normal(0, 1.5, (gamma, V))

    def softmax(z):
        e = np.exp((z - z.max(-1, keepdims=True)) / tau)
        return e / e.sum(-1, keepdims=True)
    p_t, p_d = softmax(row), softmax(dlog)
    first = np.zeros(V)
    accepted = 0
    for _ in range(n):
        cand = [int(rng.choice(V, p=p_d[j])) for j in range(gamma)]
        emit, k = eng._spec_accept_sampled(row, cand, dlog, tau)
        assert 1 <= len(emit) == k + 1 <= gamma + 1
        assert emit[:k] == cand[:k]
        first[emit[0]] += 1
        accepted += k
    np.testing.assert_allclose(first / n, p_t[0], rtol=0, atol=0.012)
    # a draft equal to the target accepts every candidate
    emit, k = eng._spec_accept_sampled(row, [0, 1], row[:gamma], tau)
    assert k == gamma and emit[:2] == [0, 1]
    assert 0 < accepted < n * gamma
    # greedy-limit sanity: a near-zero temperature emits the argmax
    emit, _ = eng._spec_accept_sampled(row, [int(row[0].argmax())] + [0],
                                       dlog, 1e-4)
    assert emit[0] == int(row[0].argmax())
