"""The port's hybrid (Jamba) family on its serving paths, against the JAX
package on bridged weights: tests/test_window_ssm_serving.py's two hybrid
cases mirrored (multi-chunk admission, where the port's continuous engine,
the port's dense ``Engine``, the reference's continuous engine and the
reference's dense ``Engine`` agree; a three-tier pool with a plain, a
window and a hybrid tier) and recurrent rows across sequential serves.
Reference continuous engines wait on each dispatch
(tests/test_torch_serving.py::_synchronous)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.core.routing import CascadePolicy as JaxCascade
from repro.core.routing import HybridRouter as JaxRouter
from repro.models import RouterConfig as JaxRouterConfig
from repro.models import init_router_encoder as jax_init_router
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Engine as JaxDense
from repro_torch import bridge
from repro_torch.core.routing import CascadePolicy, HybridRouter
from repro_torch.models.encoder import RouterConfig
from repro_torch.serving.engine import ContinuousEngine, Engine
from repro_torch.serving.pool import ContinuousPoolEngine
from conftest import tiny_cfg
from test_torch_serving import (_np_tree, _synchronous, _tier,  # noqa: F401
                                highest_precision)

HYBRID = tiny_cfg("hybrid", cache_layout="paged", prefill_chunk=8)


@pytest.fixture(scope="module")
def jamba():
    return _tier(HYBRID, 0)


def test_hybrid_engine_parity_multi_chunk(jamba):
    """tests/test_window_ssm_serving.py's case: multi-chunk admission
    streams both the KV pages and the recurrent state, and interleaved
    decode must not corrupt mid-prefill slots. The reference's dense
    Engine, the port's dense Engine, and both continuous engines emit the
    same greedy tokens, with the same launch shapes and counters; no page
    leaks."""
    m, p, bundle, model = jamba
    q = np.random.default_rng(1).integers(4, 200, (4, 27)).astype(np.int32)
    want, want_len = JaxDense(m, p, max_new_tokens=8).serve(q)
    dense, dense_len = Engine(bundle, model, max_new_tokens=8).serve(q)
    kw = dict(max_new_tokens=8, n_slots=2, max_seq=64, page_size=4)
    ref = _synchronous(JaxEngine(m, p, **kw))
    ref_out, _ = ref.serve(q)
    ce = ContinuousEngine(bundle, model, **kw)
    got, got_len = ce.serve(q)
    for out, lens in ((dense, dense_len), (got, got_len),
                      (ref_out, want_len)):
        np.testing.assert_array_equal(out, np.asarray(want))
        np.testing.assert_array_equal(lens, np.asarray(want_len))
    assert ce._decode_bounds == ref._decode_bounds
    assert ce._chunk_shapes == ref._chunk_shapes
    for f in ("prefill_tokens", "decode_tokens", "prefill_chunks",
              "prefill_dispatches", "decode_steps", "steps"):
        assert getattr(ce.stats, f) == getattr(ref.stats, f), f
    assert ce.stats.prefill_chunks > len(q)     # multi-chunk admission
    assert ce.rstate.state_bytes == ref.rstate.state_bytes
    assert ce.cache.free_pages == ce.cache.num_pages - 1
    # the reference's slab count: every layer as an attention layer
    assert Engine(bundle, model, max_new_tokens=8)._kv_slab_bytes(4, 27) \
        == JaxDense(m, p, max_new_tokens=8)._kv_slab_bytes(4, 27)


def test_three_tier_pool_window_and_hybrid_greedy_exact(jamba):
    """tests/test_window_ssm_serving.py's acceptance case: a plain, a
    window and a hybrid tier behind one router's two-threshold cascade
    serve a mixed stream, routing as the reference's cascade does and
    greedy-exact against each tier's dense engines (the reference's and
    the port's). The router has 256 rows on both sides (ROADMAP.md,
    Queue 3: the reference's test feeds its 48-row router ids up to
    200)."""
    rng = np.random.default_rng(7)
    tiers = [_tier(tiny_cfg("dense", cache_layout="paged"), 0),
             _tier(tiny_cfg("dense", name="window-tiny", n_layers=3,
                            sliding_window=6, local_global_ratio=2,
                            cache_layout="paged", prefill_chunk=8), 1),
             jamba]
    q = rng.integers(4, 200, (9, 15)).astype(np.int32)
    mask = np.ones_like(q, np.float32)
    rcfg = JaxRouterConfig(vocab_size=256, n_layers=1, d_model=32,
                           n_heads=2, d_ff=64)
    rp = jax.jit(jax_init_router, static_argnums=1)(jax.random.PRNGKey(0),
                                                    rcfg)
    ref_router = JaxRouter(rp, rcfg, 0.5)
    scores = np.asarray(ref_router.scores(jnp.asarray(q), jnp.asarray(mask)))
    thresholds = (float(np.quantile(scores, 2 / 3)),
                  float(np.quantile(scores, 1 / 3)))
    want_tier, _ = JaxCascade(ref_router, thresholds).decide(q, mask)
    prcfg = RouterConfig(**dataclasses.asdict(rcfg))
    router = HybridRouter(bridge.params_from_numpy(_np_tree(rp), prcfg,
                                                   "cpu"), prcfg, 0.5)
    engines = [ContinuousEngine(t[2], t[3], max_new_tokens=6, n_slots=2,
                                max_seq=64, page_size=4) for t in tiers]
    pool = ContinuousPoolEngine(CascadePolicy(router, thresholds),
                                list(zip(("plain", "window", "hybrid"),
                                         engines)))
    res = pool.serve(q, mask)
    np.testing.assert_array_equal(res.tier_idx, np.asarray(want_tier))
    assert sorted(np.unique(res.tier_idx)) == [0, 1, 2]    # truly mixed
    for t, (m, p, bundle, model) in enumerate(tiers):
        sel = res.tier_idx == t
        rd, ld = JaxDense(m, p, max_new_tokens=6).serve(q[sel])
        dd, _ = Engine(bundle, model, max_new_tokens=6).serve(q[sel])
        np.testing.assert_array_equal(res.responses[sel], np.asarray(rd))
        np.testing.assert_array_equal(res.lengths[sel], np.asarray(ld))
        np.testing.assert_array_equal(dd, np.asarray(rd))
    assert pool.meter.calls.sum() == len(q)
    assert all(e.cache.free_pages == e.cache.num_pages - 1 for e in engines)


def test_recurrent_rows_survive_sequential_serves(jamba):
    """Two serve() calls through one engine == two fresh engines: stale
    state from the first stream never leaks into the second."""
    _, _, bundle, model = jamba
    rng = np.random.default_rng(3)
    q1 = rng.integers(4, 200, (3, 9)).astype(np.int32)
    q2 = rng.integers(4, 200, (3, 13)).astype(np.int32)
    kw = dict(max_new_tokens=6, n_slots=2, max_seq=32, page_size=4)
    eng = ContinuousEngine(bundle, model, **kw)
    first, second = eng.serve(q1), eng.serve(q2)
    for got, q in ((first, q1), (second, q2)):
        want = ContinuousEngine(bundle, model, **kw).serve(q)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
