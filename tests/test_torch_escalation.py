"""Mid-stream escalation and the fault harness in the port, against the
JAX package on bridged weights (tests/test_escalation.py's pools and
schedules): the same streams escalate at the same token with the same
peaks (within 1e-5), the hand-off log, tokens, finish reasons and every
``TierMeter`` column agree, and each decode step's uncertainty score
equals the reference decode's. The reference's outputs are computed here
(its dispatches waited on, ``test_torch_serving._synchronous``), never
assumed: its own observe-only test asserts every peak positive, which a
stream retiring at its first decode step does not meet. The greedy-exact
continuation contract is held inside the port, against the upper tier
decoding uncontended from prompt + emitted prefix, also when the upper
tier re-admits through its prefix tree. The port's six fault scenarios
run here on the CPU, and their schedules through both pools."""
import numpy as np
import pytest

from repro.models.config import ArchConfig as JaxArchConfig
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import ContinuousPoolEngine as JaxPool
from repro.serving import faults as jax_faults
from repro.serving.engine import EscalationMonitor as JaxMonitor
from repro_torch.core.thresholds import calibrate_abort_threshold
from repro_torch.data import tokenizer as tok
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import faults
from repro_torch.serving.engine import ContinuousEngine, EscalationMonitor
from repro_torch.serving.pool import ContinuousPoolEngine
from conftest import tiny_cfg
from test_torch_serving import (RefEngines, _np_tree, _synchronous,  # noqa
                                _tier, highest_precision)


@pytest.fixture(scope="module")
def tiers():
    """tests/test_escalation.py's two tiers (and the reference fault
    module's: the same configs and seeds), each (reference bundle,
    reference params, port bundle, port model)."""
    return [_tier(JaxArchConfig(name=name, **faults.TINY_BASE), seed)
            for name, seed in (("esc-a", 1), ("esc-b", 2))]


@pytest.fixture(scope="module")
def refs():
    return RefEngines()


def _engine_pair(tiers, refs, t, max_new, **kw):
    """Tier ``t``'s (port engine, reference engine), both new; the
    reference's shares its compiled steps through ``refs``."""
    m, p, bundle, model = tiers[t]
    return (ContinuousEngine(bundle, model, max_new_tokens=max_new, **kw),
            refs.get(m, p, max_new_tokens=max_new, **kw))


def _pools(tiers, refs, max_new=8, monitor=(0.0, 3), a_kw=None, b_kw=None):
    """(port pool, reference pool) over the same weights; ``monitor``
    (threshold, min_tokens) on tier a, or None."""
    pairs = [_engine_pair(tiers, refs, t, max_new,
                          **{"n_slots": 2, "max_seq": 64, **(kw or {})})
             for t, kw in enumerate((a_kw, b_kw))]
    out = []
    for i, (Pool, Mon) in enumerate(((ContinuousPoolEngine,
                                      EscalationMonitor),
                                     (JaxPool, JaxMonitor))):
        esc = None if monitor is None else [
            Mon(abort_threshold=monitor[0], min_tokens=monitor[1])]
        out.append(Pool(faults.StaticPolicy(2),
                        [("a", pairs[0][i]), ("b", pairs[1][i])],
                        escalation=esc))
    return out


def _prompts(n, l=14, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, tok.VOCAB_SIZE, (l,)).astype(np.int32)
            for _ in range(n)]


ROBUST = ("preemptions", "reprefill_tokens", "escalations", "sheds",
          "deadline_misses", "stall_steps", "prefix_hits", "prefix_misses",
          "prefix_hit_tokens", "cow_splits", "spec_rounds", "verify_steps",
          "spec_fallbacks", "drafted_tokens", "accepted_tokens")


def _assert_same(port, ref, preqs, rreqs):
    """Both pools served ``*reqs`` (submitted in the same order) alike."""
    assert [(r.out, r.finish_reason, r.escalations, r.preemptions)
            for r in preqs] == [(r.out, r.finish_reason, r.escalations,
                                 r.preemptions) for r in rreqs]
    np.testing.assert_allclose([r.esc_peak_score for r in preqs],
                               [r.esc_peak_score for r in rreqs],
                               rtol=0, atol=1e-5)

    def log(pool, reqs):
        index = {r.rid: i for i, r in enumerate(reqs)}
        return [(index[rid], f, t, k) for rid, f, t, k in
                pool.escalation_log]
    assert log(port, preqs) == log(ref, rreqs)
    assert port.meter.summary() == ref.meter.summary()
    for pe, re_ in zip(port.engines, ref.engines):
        assert {k: getattr(pe.stats, k) for k in ROBUST} \
            == {k: getattr(re_.stats, k) for k in ROBUST}


def _assert_greedy_exact(pool, tiers, prompts, reqs):
    """Each escalated stream's continuation is the port's tier b decoding
    greedily, uncontended, from prompt + emitted prefix."""
    assert pool.escalation_log, "no stream escalated"
    _, _, bundle, model = tiers[1]
    for rid, ft, tt, k in pool.escalation_log:
        assert (ft, tt) == (0, 1)
        i = next(i for i, r in enumerate(reqs) if r.rid == rid)
        got = reqs[i].out[k:]
        want = faults._uncontended(
            bundle, model, np.concatenate(
                [prompts[i], np.asarray(reqs[i].out[:k], np.int32)]),
            max(len(got), 1), n_slots=2, max_seq=64)[:len(got)]
        assert got == want, f"rid {rid}: {got} != upper tier {want}"


def _record_scores(monkeypatch, ref_engine):
    """Lists that fill with every per-slot score the port's engines
    compute and every one ``ref_engine``'s decode returns."""
    got, want = [], []
    score = engine_mod.uncertainty

    def port_score(logits):
        out = score(logits)
        got.append(out.numpy().copy())
        return out
    monkeypatch.setattr(engine_mod, "uncertainty", port_score)
    decode = ref_engine._decode

    def ref_decode(*a):
        out = decode(*a)
        want.append(np.asarray(out[1]))
        return out
    monkeypatch.setattr(ref_engine, "_decode", ref_decode)
    return got, want


# ----------------------------------------------------------------- contract
def test_escalation_continuation_is_greedy_exact(tiers, refs):
    port, ref = _pools(tiers, refs, max_new=8, monitor=(0.0, 3))
    prompts = _prompts(4)
    preqs = [port.submit_to(0, p) for p in prompts]
    rreqs = [ref.submit_to(0, p) for p in prompts]
    done = port.run()
    ref.run()
    _assert_same(port, ref, preqs, rreqs)
    assert len(done) == 4 and all(r.finish_reason in ("eos", "length")
                                  for r in done)
    # threshold 0: every stream escalates once, at min_tokens
    assert len(port.escalation_log) == 4
    assert all(k == 3 for _, _, _, k in port.escalation_log)
    assert all(r.escalations == 1 and r.esc_peak_score > 0 for r in preqs)
    _assert_greedy_exact(port, tiers, prompts, preqs)
    # the call lands once, at the final tier; tokens split honestly
    m = port.meter
    assert m.total_calls == 4 and list(m.calls) == [0, 4]
    assert list(m.escalations) == [4, 0]
    assert m.esc_tokens[0] == 12 == m.tokens[0]
    assert m.tokens.sum() == sum(r.n_generated for r in preqs)
    assert m.cost_advantage == 0.0
    assert port.engines[0].stats.escalations == 4
    assert port.engines[1].stats.escalations == 0


def test_escalation_survives_concurrent_preemption(tiers, refs):
    """A priority burst on the upper tier preempts escalated
    continuations mid-decode; both pools agree and the resumes are
    greedy-exact."""
    port, ref = _pools(tiers, refs, max_new=10, monitor=(0.0, 2),
                       b_kw=dict(n_slots=1))
    prompts = _prompts(3, seed=1)
    runs = []
    for pool in (port, ref):
        reqs = [pool.submit_to(0, p) for p in prompts]
        for _ in range(200):
            pool.step()
            if any(r.state == "decoding" for r in pool.engines[1].sched.
                   running.values()):
                break
        burst = [pool.submit_to(1, p, priority=5)
                 for p in _prompts(2, seed=2)]
        pool.run()
        runs.append(reqs + burst)
    _assert_same(port, ref, *runs)
    assert port.engines[1].stats.preemptions > 0
    assert all(r.done for r in runs[0])
    assert len(port.escalation_log) == 3
    _assert_greedy_exact(port, tiers, prompts, runs[0][:3])


def test_escalated_readmission_hits_prefix_tree(tiers, refs):
    """With ``prefix_cache > 0`` on the upper tier, the escalated
    re-prefill of prompt + emitted prefix walks onto the tree instead of
    recomputing, on both pools alike, and the continuation keeps the
    tokens of the run without sharing."""
    prompts = _prompts(3, seed=3)
    plain, _ = _pools(tiers, refs, max_new=8, monitor=(0.0, 3))
    reqs0 = [plain.submit_to(0, p) for p in prompts]
    plain.run()
    assert len(plain.escalation_log) == 3
    port, ref = _pools(tiers, refs, max_new=8, monitor=(0.0, 3),
                       b_kw=dict(prefix_cache=16, prefill_chunk=8))
    runs = []
    for pool in (port, ref):
        eb = pool.engines[1]
        assert eb.prefix_reason is None and eb.cache.prefix is not None
        # warm tier b's tree with exactly the continuation prompts
        # (prompt + the 3 tokens tier a emits): 17 tokens, two full pages
        # published at retirement
        for p, r0 in zip(prompts, reqs0):
            warm = eb.submit(np.concatenate([p, np.asarray(r0.out[:3],
                                                           np.int32)]))
            eb.run()
            assert warm.done
        hits_before = eb.stats.prefix_hits
        reqs = [pool.submit_to(0, p) for p in prompts]
        pool.run()
        assert len(pool.escalation_log) == 3
        assert eb.stats.prefix_hits > hits_before
        runs.append(reqs)
    _assert_same(port, ref, *runs)
    assert [r.prefix_hit_tokens for r in runs[0]] \
        == [r.prefix_hit_tokens for r in runs[1]]
    assert any(r.prefix_hit_tokens > 0 for r in runs[0])
    _assert_greedy_exact(port, tiers, prompts, runs[0])
    assert [r.out for r in runs[0]] == [r.out for r in reqs0]
    assert port.engines[1].cache.check_refcounts() == []


def test_observe_only_peaks_and_scores_match_reference(tiers, refs,
                                                       monkeypatch):
    """``abort_threshold=None`` records peaks and cancels nobody. Every
    decode step's per-slot score, from the same padded-vocab logits the
    token was sampled from, equals the reference decode's within 1e-5, and
    so do the peaks, the 0.0 of a stream that retired at its first decode
    step included."""
    port, ref = _pools(tiers, refs, max_new=6, monitor=None)
    got, want = _record_scores(monkeypatch, ref.engines[0])
    prompts = _prompts(3, seed=4)
    runs = []
    for pool, Mon in ((port, EscalationMonitor), (ref, JaxMonitor)):
        pool.engines[0].escalation = Mon(abort_threshold=None)
        runs.append([pool.submit_to(0, p) for p in prompts])
        pool.run()
    _assert_same(port, ref, *runs)
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert ((g >= 0) & (g <= 1)).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    assert not port.escalation_log and port.meter.escalations.sum() == 0
    peaks = [r.esc_peak_score for r in runs[0]]
    assert all(0.0 <= p <= 1.0 for p in peaks)
    for r, p in zip(runs[0], peaks):   # a stream never scored peaks at 0
        assert (p == 0.0) == (len(r.out) < 2 or r.out[1] == tok.EOS)
    thr = calibrate_abort_threshold(peaks, 0.0)
    assert thr > max(peaks)
    assert calibrate_abort_threshold(peaks, 1.0) <= min(peaks) + 1e-12


def test_score_normalises_by_the_padded_vocab(monkeypatch):
    """With a vocab that is not a multiple of its padding (250 of 256
    columns), the score still equals the reference decode's: entropy over
    log(padded vocab), the masked columns adding nothing."""
    m, p, bundle, model = _tier(tiny_cfg("dense", vocab_size=250), 3)
    kw = dict(max_new_tokens=4, n_slots=2, max_seq=32)
    port = ContinuousEngine(bundle, model, **kw)
    ref = _synchronous(JaxEngine(m, p, **kw))
    got, want = _record_scores(monkeypatch, ref)
    for eng, Mon in ((port, EscalationMonitor), (ref, JaxMonitor)):
        eng.escalation = Mon(abort_threshold=None)
        for q in _prompts(2, l=9, seed=6):
            eng.submit(q)
        eng.run()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_monitor_validation_and_pool_wiring(tiers):
    with pytest.raises(ValueError):
        EscalationMonitor(min_tokens=0)
    _, _, bundle, model = tiers[0]
    eng = ContinuousEngine(bundle, model, max_new_tokens=4, n_slots=2,
                           max_seq=64)
    with pytest.raises(ValueError):   # K-1 monitors, not K
        ContinuousPoolEngine(
            faults.StaticPolicy(2), [("a", eng), ("b", eng)],
            escalation=[EscalationMonitor(), EscalationMonitor()])
    with pytest.raises(ValueError):   # an aliased engine would watch both
        ContinuousPoolEngine(
            faults.StaticPolicy(2), [("a", eng), ("b", eng)],
            escalation=[EscalationMonitor()])
    with pytest.raises(ValueError):
        ContinuousEngine(bundle, model, max_pending=0)
    with pytest.raises(ValueError):
        ContinuousEngine(bundle, model, max_preemptions=-1)
    m = ContinuousPoolEngine(faults.StaticPolicy(2),
                             [("a", eng), ("b", eng)]).meter
    with pytest.raises(ValueError):   # nothing above the priciest tier
        m.record_escalation(1, 3)
    with pytest.raises(ValueError):
        m.record_shed(2)


# ------------------------------------------------------------------- faults
@pytest.mark.parametrize("name", sorted(faults.SCENARIOS))
def test_fault_scenarios_on_cpu(name):
    """The port's chaos scenarios: invariants empty, and preempted and
    escalated streams greedy-exact against uncontended runs."""
    h = faults.SCENARIOS[name](verbose=False, device="cpu")
    assert h.check_invariants() == []
    assert all(r.done for r in h.requests)


# each scenario's seed and engine geometry, as the reference module builds
# them
SCENARIO = {"stall": (0, dict(n_slots=2, max_seq=48)),
            "pressure": (1, dict(n_slots=2, max_seq=32)),
            "burst": (2, dict(n_slots=1, max_seq=48, max_pending=3)),
            "spec-stall": (3, dict(n_slots=2, max_seq=48)),
            "prefix-thrash": (4, dict(n_slots=2, max_seq=48,
                                      prefix_cache=16)),
            "escalation-storm": (5, dict(n_slots=2, max_seq=48))}


def _schedule(name, f, rng, free):
    """The reference module's scenario ``name`` built from fault module
    ``f``; ``free`` maps a tier to its free pages, which the pressure
    faults take from."""
    P = f._prompts
    if name == "stall":
        a, b = P(rng, 3), P(rng, 3)
        return [f.TierStall("b", start=2, steps=12),
                f.AdmissionBurst(step=0, prompts=a, tier="a"),
                f.AdmissionBurst(step=0, prompts=b, tier="b")]
    if name == "pressure":
        # listed first: the hold lands before the same-step burst submits
        return [f.PagePressure("a", start=0, steps=8, pages=free("a")),
                f.AdmissionBurst(step=0, prompts=P(rng, 4, lo=6, hi=12),
                                 tier="a")]
    if name == "burst":
        base = P(rng, 4, lo=5, hi=10)
        burst = P(rng, 5, lo=5, hi=10)
        doomed = P(rng, 2, lo=5, hi=10)
        return [f.AdmissionBurst(step=0, prompts=base, tier="a", priority=0),
                f.AdmissionBurst(step=4, prompts=burst, tier="a",
                                 priority=5),
                f.AdmissionBurst(step=4, prompts=doomed, tier="a",
                                 priority=6, deadline_s=0.0)]
    if name == "spec-stall":
        b, a = P(rng, 4), P(rng, 2)
        return [f.TierStall("a", start=2, steps=10),
                f.AdmissionBurst(step=0, prompts=b, tier="b"),
                f.AdmissionBurst(step=0, prompts=a, tier="a")]
    if name == "prefix-thrash":
        # the port's draw, inside the vocabulary, for both pools
        shared = rng.integers(4, tok.VOCAB_SIZE, (16,)).astype(np.int32)
        waves = [tuple(np.concatenate([shared, sfx])
                       for sfx in P(rng, 3, lo=4, hi=10)) for _ in range(2)]
        return [f.AdmissionBurst(step=0, prompts=waves[0], tier="a"),
                f.PagePressure("a", start=10, steps=14,
                               pages=free("a") - 6),
                f.AdmissionBurst(step=10, prompts=waves[1], tier="a")]
    # escalation-storm: tier b keeps 8 free pages
    return [f.AdmissionBurst(step=0, prompts=P(rng, 8, lo=4, hi=12),
                             tier="a"),
            f.PagePressure("b", start=3, steps=16, pages=free("b") - 8),
            f.EscalationTrigger("a", step=3, abort_threshold=0.0,
                                min_tokens=1)]


@pytest.mark.parametrize("name", sorted(SCENARIO))
def test_fault_schedule_matches_reference(tiers, refs, name):
    """The reference's four scenarios' schedules through both pools on the
    same weights: the same retirements, counters, hand-offs and meter, and
    empty invariants on both sides."""
    seed, kw = SCENARIO[name]
    spec = 2 if name == "spec-stall" else 0
    max_new = 10 if spec else 6
    pairs = [_engine_pair(tiers, refs, t, max_new, **kw) for t in range(2)]
    runs = []
    for i, (f, Pool) in enumerate(((faults, ContinuousPoolEngine),
                                   (jax_faults, JaxPool))):
        engines = {"a": pairs[0][i], "b": pairs[1][i]}
        pool = Pool(f.StaticPolicy(2), list(engines.items()),
                    spec_gamma=spec)
        if spec and i:
            refs.adopt(engines["b"])   # the draft's and verify steps
        h = f.FaultHarness(pool, _schedule(
            name, f, np.random.default_rng(seed),
            lambda t: engines[t].cache.stats.num_pages))
        h.run()
        assert h.check_invariants() == [], f.__name__
        runs.append((pool, h.requests))
    (port, preqs), (ref, rreqs) = runs
    _assert_same(port, ref, preqs, rreqs)
    st = port.engine("a").stats
    if name == "stall":
        assert max(r.finish_t for r in preqs[:3]) \
            <= min(r.finish_t for r in preqs[3:])
    elif name == "pressure":
        assert st.stall_steps > 0
    elif name == "burst":
        assert st.preemptions > 0 and st.sheds > 0
        assert st.deadline_misses >= 2
    elif name == "spec-stall":
        sb = port.engine("b").stats
        assert sb.spec_fallbacks > 0 and sb.spec_rounds > 0
        assert port.meter.drafted[0] == sb.drafted_tokens > 0
    elif name == "prefix-thrash":
        assert st.prefix_hits > 0
        assert port.engine("a").cache.prefix.stats.evicted_pages > 0
    else:
        assert port.escalation_log
        assert port.meter.tokens.sum() == sum(
            r.n_generated for r in preqs if r.finish_reason != "rejected")
