"""The port's serving stack against the JAX package on bridged weights:
the page allocator, the continuous engine (greedy tokens, live and static
walks, packed and per-slot prefill) and the two-tier routed pool (tier
dispatch, tokens and cost summary). Reference outputs are computed here,
not assumed, with each reference dispatch waited on: under CPU async
dispatch the reference engine does not always agree with itself
(ROADMAP.md, Queue 3)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.routing import HybridRouter as JaxRouter
from repro.core.routing import ThresholdPolicy as JaxThresholdPolicy
from repro.data.tasks import generate_dataset
from repro.models import RouterConfig as JaxRouterConfig
from repro.models import build_model as jax_build_model
from repro.models import init_router_encoder as jax_init_router
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import ContinuousPoolEngine as JaxPool
from repro.serving import PagedKVCache as JaxCache
from repro_torch import bridge
from repro_torch.core.routing import HybridRouter, ThresholdPolicy, TierMeter
from repro_torch.models.config import ArchConfig
from repro_torch.models.encoder import RouterConfig
from repro_torch.models.model import build_model
from repro_torch.serving.cache import PagedKVCache
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.generate import _sample_rows
from repro_torch.serving.pool import ContinuousPoolEngine
from conftest import tiny_cfg


@pytest.fixture(autouse=True)
def highest_precision():
    """fp32 matmuls at full precision on both sides (PyTorch's default),
    and one PyTorch thread: these shapes are tiny, and the test workers
    share the machine's cores."""
    assert torch.get_float32_matmul_precision() == "highest"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _synchronous(eng):
    """Make a reference engine wait for each jitted dispatch. Its CPU
    async dispatch races the host arrays it hands over, so repeated
    identical runs can emit different greedy tokens (ROADMAP.md, Queue 3);
    waiting changes no value, only removes the race. One-shot admission's
    dispatches (``_prefill``, ``_scatter``) wait too."""
    for name in ("_prefill_chunk_fn", "_decode", "_lm_head", "_prefill",
                 "_scatter"):
        fn = getattr(eng, name)
        setattr(eng, name,
                lambda *a, fn=fn: jax.block_until_ready(fn(*a)))
    return eng


def _tier(cfg, seed):
    """(reference bundle, reference params, port bundle, port model)."""
    m = jax_build_model(cfg)
    p = jax.jit(m.init)(jax.random.PRNGKey(seed))
    pcfg = ArchConfig(**dataclasses.asdict(cfg))
    return m, p, build_model(pcfg), bridge.params_from_numpy(_np_tree(p),
                                                             pcfg, "cpu")


@pytest.fixture(scope="module")
def dense():
    return _tier(tiny_cfg("dense"), 0)


# ----------------------------------------------------------------- cache
def test_page_allocator_hands_out_the_reference_pages(dense):
    """The same extend / append / free sequence gives the same page table
    and free list on both allocators, OOM refusals included."""
    m, _, bundle, _ = dense
    ref = JaxCache(m, n_slots=3, num_pages=7, page_size=4,
                   max_pages_per_slot=3)
    port = PagedKVCache(bundle, n_slots=3, num_pages=7, page_size=4,
                        max_pages_per_slot=3, device="cpu")
    ops = [("extend", 0, 5), ("extend", 1, 3), ("append", 1), ("extend", 2, 8),
           ("free", 0), ("extend", 2, 2), ("extend", 0, 4), ("append", 0),
           ("append", 1), ("free", 1), ("extend", 1, 12), ("append", 2)]
    for op in ops:
        if op[0] == "extend":
            a, b = ref.extend_slot(*op[1:]), port.extend_slot(*op[1:])
            assert (a is None) == (b is None), op
        elif op[0] == "append":
            assert ref.ensure_append(op[1]) == port.ensure_append(op[1]), op
            for c in (ref, port):          # the decode write lands
                c.seq_lens[op[1]] += 1
        else:
            ref.free_slot(op[1])
            port.free_slot(op[1])
        np.testing.assert_array_equal(port.page_table, ref.page_table)
        np.testing.assert_array_equal(port.seq_lens, ref.seq_lens)
        assert port.free_pages == ref.free_pages, op
    for f in ("pages_in_use", "high_water_pages", "allocs", "appends",
              "oom_denials"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    pt, sl = port.device_tables("cpu")
    port.page_table[:] = 0
    assert pt.any() and pt.dtype == torch.int32, "tables must be copies"
    with pytest.raises(NotImplementedError, match="prefix"):
        PagedKVCache(bundle, 1, 4, 4, 2, prefix_pages=2, device="cpu")


# ---------------------------------------------------------------- engine
LENS = (3, 24, 1, 17, 9, 12, 5, 20)
CAPS = (2, 8, 4, 8, 1, 6, 8, 3)
ENGINE_KW = dict(max_new_tokens=8, n_slots=3, page_size=8, max_seq=64,
                 num_pages=12, prefill_chunk=8)


def _prompts(vocab):
    rng = np.random.default_rng(8)
    return [rng.integers(4, vocab, (n,)).astype(np.int32) for n in LENS]


def _serve(engine_cls, bundle, params, prompts, **kw):
    eng = engine_cls(bundle, params, **ENGINE_KW, **kw)
    if engine_cls is JaxEngine:
        _synchronous(eng)
    reqs = [eng.submit(t, max_new_tokens=c) for t, c in zip(prompts, CAPS)]
    eng.run()
    return [r.out for r in reqs], eng


@pytest.mark.parametrize("walk_bound,prefill_pack", [("live", None),
                                                     ("static", 0)])
def test_engine_greedy_tokens_match_reference(dense, walk_bound,
                                              prefill_pack):
    """Ragged prompts through fewer slots than requests and a tight pool
    (admission stalls, mid-stream retirement, slot reuse): the port emits
    the reference engine's greedy tokens request for request and counts
    the same launch shapes."""
    m, p, bundle, model = dense
    prompts = _prompts(bundle.cfg.vocab_size)
    kw = dict(walk_bound=walk_bound, prefill_pack=prefill_pack)
    want, ref = _serve(JaxEngine, m, p, prompts, **kw)
    got, eng = _serve(ContinuousEngine, bundle, model, prompts, **kw)
    assert got == want
    for f in ("admitted", "retired", "prefill_tokens", "decode_tokens",
              "prefill_chunks", "prefill_dispatches", "prefill_compiles",
              "decode_compiles", "decode_steps", "admission_stalls", "steps"):
        assert getattr(eng.stats, f) == getattr(ref.stats, f), f
    assert eng.cache.free_pages == eng.cache.num_pages - 1


def test_engine_dispatch_variants_agree_within_the_port(dense):
    """Packed == per-slot and live == static inside the port, on the CPU
    (on the card cuBLAS picks algorithms by batch shape, so there the
    contract is a tolerance on logits, not byte identity)."""
    _, _, bundle, model = dense
    prompts = _prompts(bundle.cfg.vocab_size)
    base, _ = _serve(ContinuousEngine, bundle, model, prompts,
                     walk_bound="static", prefill_pack=0)
    for bound, pack in (("live", None), ("live", 0), ("static", None)):
        out, eng = _serve(ContinuousEngine, bundle, model, prompts,
                          walk_bound=bound, prefill_pack=pack)
        assert out == base, (bound, pack)
        assert eng.stats.prefill_dispatches <= eng.stats.prefill_chunks


def test_engine_refuses_what_is_not_ported(dense):
    """A malformed request raises (a negative temperature); a prompt that
    could never complete is refused as the reference refuses it: shed,
    finish reason "rejected", surfacing through the next step."""
    m, p, bundle, model = dense
    eng = ContinuousEngine(bundle, model, max_seq=16, n_slots=1)
    with pytest.raises(ValueError, match="negative"):
        eng.submit(np.arange(4, 8, dtype=np.int32), temperature=-0.1)
    ref = JaxEngine(m, p, max_seq=16, n_slots=1)
    for e in (eng, ref):
        req = e.submit(np.arange(4, 40, dtype=np.int32))
        assert req.done and req.finish_reason == "rejected"
        assert e.step() == [req] and e.stats.sheds == 1


# ------------------------------------------------------------------ pool
def test_two_tier_pool_matches_reference(dense):
    """Router scores once at admission, a ThresholdPolicy splits the
    queries between a small and a large tier, both engines step
    independently: identical tier dispatch, greedy tokens and TierMeter
    summary."""
    small = _tier(tiny_cfg("dense", name="small", n_layers=1, d_model=32,
                           n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64), 1)
    large = dense
    rcfg = JaxRouterConfig(vocab_size=256, n_layers=2, d_model=32, n_heads=4,
                           d_ff=64)
    rp = jax.jit(jax_init_router, static_argnums=1)(jax.random.PRNGKey(5), rcfg)
    prcfg = RouterConfig(**dataclasses.asdict(rcfg))
    port_router = bridge.params_from_numpy(_np_tree(rp), prcfg, "cpu")
    ds = generate_dataset(np.random.default_rng(3), 10, q_len=16)
    scores = np.sort(np.asarray(JaxRouter(rp, rcfg, 0.0).scores(
        ds.query, ds.query_mask)))
    threshold = float(scores[4] + scores[5]) / 2   # 5 queries each side
    kw = dict(max_new_tokens=6, n_slots=4, max_seq=32, prefill_chunk=16)

    ref = JaxPool(JaxThresholdPolicy(JaxRouter(rp, rcfg, threshold)),
                  [("small", _synchronous(JaxEngine(small[0], small[1], **kw))),
                   ("large", _synchronous(JaxEngine(large[0], large[1], **kw)))])
    want = ref.serve(ds.query, ds.query_mask)
    pool = ContinuousPoolEngine(
        ThresholdPolicy(HybridRouter(port_router, prcfg, threshold)),
        [("small", ContinuousEngine(small[2], small[3], **kw)),
         ("large", ContinuousEngine(large[2], large[3], **kw))])
    got = pool.serve(ds.query, ds.query_mask)

    np.testing.assert_array_equal(got.tier_idx, want.tier_idx)
    assert 0 < got.tier_idx.sum() < len(got.tier_idx)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-6)
    np.testing.assert_array_equal(got.responses, want.responses)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert pool.meter.summary() == ref.meter.summary()
    assert pool.meter.cost_advantage == ref.meter.cost_advantage
    assert pool.meter.token_cost_advantage == ref.meter.token_cost_advantage
    for e in pool.engines:
        assert e.cache.free_pages == e.cache.num_pages - 1


def test_tier_meter_accounting():
    m = TierMeter(("s", "l"))
    m.record(np.array([0, 1, 0]), np.array([4, 10, 6]))
    assert m.summary()["s"]["calls"] == 2 and m.summary()["l"]["gen_tokens"] \
        == 10
    assert m.cost_advantage == pytest.approx(2 / 3)
    assert m.token_cost_advantage == pytest.approx(0.5)
    with pytest.raises(ValueError):
        m.record(np.array([2]), 1)
    m.reset()
    assert m.total_calls == 0 and m.total_tokens == 0


def test_sample_rows_greedy_ties_and_sampled_distribution():
    """Greedy rows take the first maximal index (as ``jnp.argmax`` does);
    sampled rows draw from softmax(logits / temperature) through the
    given generator, checked by distribution."""
    logits = np.array([[1.0, 3.0, 3.0, 0.0], [0.0, 1.0, 2.0, 0.5]],
                      np.float32)
    g = torch.Generator().manual_seed(0)
    greedy = _sample_rows(g, torch.tensor(logits), np.zeros(2))
    assert greedy.tolist() == np.asarray(jnp.argmax(logits, -1)).tolist()
    n, t = 20000, 0.7
    draws = _sample_rows(g, torch.tensor(logits[1:]).repeat(n, 1),
                         np.full(n, t)).numpy()
    want = np.exp(logits[1] / t) / np.exp(logits[1] / t).sum()
    np.testing.assert_allclose(np.bincount(draws, minlength=4) / n, want,
                               atol=0.02)
