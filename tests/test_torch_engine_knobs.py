"""The continuous engine's and the pool's knobs against the JAX package on
bridged weights: one-shot admission (``prefill_chunk=0``) against chunked
admission and the reference's one-shot engine, the sampling knobs
(per-request ``temperature``, ``set_rng_salt``, ``reseed``), and the
pool's ``submit`` options and ``submit_to`` against the reference pool's
routing and metering. Sampled tokens are checked by distribution
only: ``torch.Generator`` and ``jax.random`` draw different streams."""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.core.routing import HybridRouter as JaxRouter
from repro.core.routing import ThresholdPolicy as JaxThresholdPolicy
from repro.data.tasks import generate_dataset
from repro.models import RouterConfig as JaxRouterConfig
from repro.models import init_router_encoder as jax_init_router
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import ContinuousPoolEngine as JaxPool
from repro_torch import bridge
from repro_torch.core.routing import HybridRouter, ThresholdPolicy
from repro_torch.models.config import ArchConfig
from repro_torch.models.encoder import RouterConfig
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.pool import ContinuousPoolEngine
from conftest import tiny_cfg
from test_torch_serving import (_np_tree, _synchronous, _tier,  # noqa: F401
                                highest_precision)

ONE_SHOT_LENS = (3, 12, 17, 5, 9, 24, 1)
ONE_SHOT_KW = dict(max_new_tokens=8, n_slots=2, page_size=8, max_seq=64)


@pytest.fixture(scope="module")
def dense():
    return _tier(tiny_cfg("dense"), 0)


@pytest.fixture(scope="module")
def one_shot(dense):
    """The ragged prompts of tests/test_chunked_prefill.py's chunked ==
    one-shot test, served one-shot by the reference and by the port."""
    m, p, bundle, model = dense
    rng = np.random.default_rng(0)
    prompts = [rng.integers(4, bundle.cfg.vocab_size, (n,)).astype(np.int32)
               for n in ONE_SHOT_LENS]
    out = {}
    for name, eng in (
            # the static walk: fewer reference compiles, the same tokens
            ("ref", _synchronous(JaxEngine(m, p, prefill_chunk=0,
                                           walk_bound="static",
                                           **ONE_SHOT_KW))),
            ("port", ContinuousEngine(bundle, model, prefill_chunk=0,
                                      **ONE_SHOT_KW))):
        reqs = [eng.submit(t) for t in prompts]
        eng.run()
        out[name] = ([r.out for r in reqs], eng)
    return prompts, out


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_chunked_matches_oneshot_greedy(dense, one_shot, chunk):
    """Greedy decode after chunked admission reproduces one-shot admission
    inside the port, across chunk widths and ragged prompt lengths, and
    the port's one-shot engine emits the reference's one-shot tokens."""
    _, _, bundle, model = dense
    prompts, out = one_shot
    base, eng0 = out["port"]
    assert base == out["ref"][0]
    for f in ("admitted", "retired", "prefill_tokens", "decode_tokens",
              "decode_steps", "admission_stalls", "steps"):
        assert getattr(eng0.stats, f) == getattr(out["ref"][1].stats, f), f
    assert eng0.stats.prefill_chunks == 0
    ce = ContinuousEngine(bundle, model, prefill_chunk=chunk, **ONE_SHOT_KW)
    reqs = [ce.submit(t) for t in prompts]
    ce.run()
    assert [r.out for r in reqs] == base
    assert ce.stats.prefill_chunks > 0
    assert ce.stats.prefill_tokens == sum(len(t) for t in prompts)
    assert ce.cache.stats.pages_in_use == 0
    with pytest.raises(ValueError):
        ContinuousEngine(bundle, model, n_slots=2, max_seq=32,
                         prefill_chunk=-chunk)


def test_ssm_stack_refuses_one_shot_admission():
    bundle = build_model(ArchConfig(**dataclasses.asdict(tiny_cfg("ssm"))))
    model = bundle.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        ContinuousEngine(bundle, model, prefill_chunk=0)


# ------------------------------------------------------------ sampling
def test_per_request_temperature(dense):
    """A temperature-0 request inside a sampled engine emits the greedy
    tokens (the port's greedy engine's and the reference's); requests at
    their own temperatures draw each at its own: first tokens of one
    prompt, sampled 600 times at 0.5 and 600 times at 2.0 in one engine,
    follow softmax(logits / t) of that temperature."""
    m, p, bundle, model = dense
    rng = np.random.default_rng(4)
    prompts = [rng.integers(4, bundle.cfg.vocab_size, (n,)).astype(np.int32)
               for n in (7, 9, 6)]
    kw = dict(max_new_tokens=8, n_slots=3, page_size=8, max_seq=32)
    ref = _synchronous(JaxEngine(m, p, **kw))
    want = ref.submit(prompts[0])
    ref.run()
    greedy = ContinuousEngine(bundle, model, **kw)
    g0 = greedy.submit(prompts[0])
    greedy.run()
    mixed = ContinuousEngine(bundle, model, temperature=0.9, **kw)
    g = mixed.submit(prompts[0], temperature=0.0)
    s1 = mixed.submit(prompts[1])
    s2 = mixed.submit(prompts[2], temperature=0.5)
    mixed.run()
    assert g.out == g0.out == want.out
    assert all(r.done and r.n_generated >= 1 for r in (s1, s2))

    n, temps = 600, (0.5, 2.0)
    eng = ContinuousEngine(bundle, model, max_new_tokens=1, n_slots=8,
                           page_size=8, max_seq=32)
    reqs = [eng.submit(prompts[1], temperature=temps[i % 2])
            for i in range(2 * n)]
    eng.run()
    logits, _ = bundle.prefill(model, {"tokens": torch.tensor(
        prompts[1][None])})
    logits = logits[0].double()
    for k, t in enumerate(temps):
        first = np.array([r.out[0] for r in reqs[k::2]])
        freq = np.bincount(first, minlength=bundle.cfg.padded_vocab) / n
        prob = torch.softmax(logits / t, -1).numpy()
        prob = np.pad(prob, (0, len(freq) - len(prob)))
        sigma = np.sqrt(prob * (1 - prob) / n)
        assert (np.abs(freq - prob) <= 5 * sigma + 2 / n).all(), t
    assert eng.cache.free_pages == eng.cache.num_pages - 1


def test_seed_and_rng_salt_pick_the_sampling_stream(dense):
    """Engines of one salt draw the same samples and another salt draws
    others; ``reseed`` with one seed restarts the same stream, and with
    another seed starts another."""
    _, _, bundle, model = dense
    q = np.random.default_rng(6).integers(4, bundle.cfg.vocab_size, (4, 6)) \
        .astype(np.int32)

    def draw(salt=0, seed=None):
        eng = ContinuousEngine(bundle, model, max_new_tokens=12,
                               temperature=1.0, n_slots=2, page_size=8,
                               max_seq=32)
        eng.set_rng_salt(salt)
        if seed is not None:
            eng.reseed(seed)
        reqs = [eng.submit(t) for t in q]
        eng.run()
        return [r.out for r in reqs]

    base = draw(salt=1)
    assert draw(salt=1) == base
    assert draw(salt=2) != base
    assert draw(salt=1, seed=3) == draw(salt=1, seed=3) != base
    assert draw(salt=1, seed=4) != draw(salt=1, seed=3)
    assert draw(salt=2, seed=3) != draw(salt=1, seed=3)


# ---------------------------------------------------------------- pool
def test_pool_submit_options_and_submit_to_match_reference(dense):
    """The pool's per-request caps, per-request temperatures (greedy rows in sampled tiers) and ``submit_to`` by name
    and by index route, emit and meter as the reference pool does."""
    small = _tier(tiny_cfg("dense", name="small", n_layers=1, d_model=32,
                           n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64), 1)
    large = dense
    rcfg = JaxRouterConfig(vocab_size=256, n_layers=2, d_model=32, n_heads=4,
                           d_ff=64)
    rp = jax.jit(jax_init_router, static_argnums=1)(jax.random.PRNGKey(5),
                                                    rcfg)
    prcfg = RouterConfig(**dataclasses.asdict(rcfg))
    port_router = bridge.params_from_numpy(_np_tree(rp), prcfg, "cpu")
    ds = generate_dataset(np.random.default_rng(3), 8, q_len=16)
    scores = np.sort(np.asarray(JaxRouter(rp, rcfg, 0.0).scores(
        ds.query, ds.query_mask)))
    threshold = float(scores[3] + scores[4]) / 2   # 4 queries each side
    kw = dict(max_new_tokens=6, temperature=0.7, n_slots=3, max_seq=32,
              prefill_chunk=16, walk_bound="static")
    caps = np.array([1, 6, 3, 2, 5, 4, 6, 1])
    temps = np.zeros(len(caps))

    def drive(pool):
        reqs, tier, scores = pool.submit(ds.query, ds.query_mask,
                                         max_new_tokens=caps,
                                         temperature=temps)
        reqs += pool.submit(ds.query[:2], ds.query_mask[:2],
                            temperature=0.0)[0]
        reqs.append(pool.submit_to("large", ds.query[3, :5],
                                   max_new_tokens=3, temperature=0.0))
        reqs.append(pool.submit_to(0, ds.query[4, :7], temperature=0.0))
        pool.run()
        return [r.out for r in reqs], [len(r.tokens) for r in reqs], tier

    ref = JaxPool(JaxThresholdPolicy(JaxRouter(rp, rcfg, threshold)),
                  [("small", _synchronous(JaxEngine(small[0], small[1],
                                                    **kw))),
                   ("large", _synchronous(JaxEngine(large[0], large[1],
                                                    **kw)))])
    pool = ContinuousPoolEngine(
        ThresholdPolicy(HybridRouter(port_router, prcfg, threshold)),
        [("small", ContinuousEngine(small[2], small[3], **kw)),
         ("large", ContinuousEngine(large[2], large[3], **kw))])
    want_out, want_len, want_tier = drive(ref)
    got_out, got_len, got_tier = drive(pool)
    np.testing.assert_array_equal(got_tier, want_tier)
    assert 0 < got_tier.sum() < len(got_tier)
    assert got_out == want_out and got_len == want_len
    assert got_len[:8] == [int(np.flatnonzero(m)[-1]) + 1
                           for m in ds.query_mask]      # PAD tails trimmed
    assert all(len(o) <= c for o, c in zip(got_out, caps))
    assert pool.meter.summary() == ref.meter.summary()
    assert pool.meter.cost_advantage == ref.meter.cost_advantage
    with pytest.raises(ValueError):
        pool.submit_to(2, ds.query[0])
    for e in pool.engines:
        assert e.cache.free_pages == e.cache.num_pages - 1
