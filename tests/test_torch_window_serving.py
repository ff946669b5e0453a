"""Sliding-window stacks on the port's serving paths, against the JAX
package on bridged weights: a gemma3-style local:global stack served by
the continuous engine (chunked admission across page edges with late
window walk starts, one-shot admission, the static walk), by the routed
pool beside a plain tier, and the published gemma3-4b config, reduced,
through the paged engine. Every case is greedy-exact against the
reference's dense ``Engine`` and the port's own (tests/
test_window_ssm_serving.py's window cases). Reference continuous engines
wait on each dispatch (``_synchronous``)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.configs.gemma3_4b import CONFIG as JAX_GEMMA
from repro.core.routing import CascadePolicy as JaxCascade
from repro.core.routing import HybridRouter as JaxRouter
from repro.data import tokenizer as jax_tok
from repro.models import RouterConfig as JaxRouterConfig
from repro.models import init_router_encoder as jax_init_router
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Engine as JaxDense
from repro_torch import bridge
from repro_torch.configs.gemma3_4b import CONFIG as GEMMA
from repro_torch.core.routing import CascadePolicy, HybridRouter
from repro_torch.models.config import ArchConfig
from repro_torch.models.encoder import RouterConfig
from repro_torch.serving.engine import ContinuousEngine, Engine
from repro_torch.serving.pool import ContinuousPoolEngine
from conftest import tiny_cfg
from test_torch_serving import (_np_tree, _synchronous, _tier,  # noqa: F401
                                highest_precision)

WINDOW = dict(n_layers=3, sliding_window=6, local_global_ratio=2,
              cache_layout="paged")


@pytest.fixture(scope="module")
def window():
    return _tier(tiny_cfg("dense", name="window-tiny", prefill_chunk=8,
                          **WINDOW), 0)


def _parity(tier, n=6, prompt_len=19, t_max=10, **engine_kw):
    """One uniform-length greedy stream through the reference's dense
    Engine, the port's dense Engine, and the port's and the reference's
    continuous engines (2 slots, 4-token pages): every output agrees, and
    both continuous engines launch the same (bound, window start) walks.
    Returns the port's continuous engine."""
    m, p, bundle, model = tier
    q = np.random.default_rng(1).integers(4, 200, (n, prompt_len)) \
        .astype(np.int32)
    want, want_len = JaxDense(m, p, max_new_tokens=t_max).serve(q)
    dense, dense_len = Engine(bundle, model, max_new_tokens=t_max).serve(q)
    kw = dict(max_new_tokens=t_max, n_slots=2, max_seq=64, page_size=4,
              **engine_kw)
    ref = _synchronous(JaxEngine(m, p, **kw))
    ref_out, _ = ref.serve(q)
    ce = ContinuousEngine(bundle, model, **kw)
    got, got_len = ce.serve(q)
    np.testing.assert_array_equal(np.asarray(want), dense)
    np.testing.assert_array_equal(np.asarray(want), got)
    np.testing.assert_array_equal(np.asarray(want_len), got_len)
    np.testing.assert_array_equal(np.asarray(want_len), dense_len)
    np.testing.assert_array_equal(ref_out, got)
    assert ce._decode_bounds == ref._decode_bounds
    assert ce._chunk_shapes == ref._chunk_shapes
    for f in ("prefill_tokens", "decode_tokens", "prefill_chunks",
              "prefill_dispatches", "decode_steps", "steps"):
        assert getattr(ce.stats, f) == getattr(ref.stats, f), f
    assert ce.cache.free_pages == ce.cache.num_pages - 1
    return ce


def test_window_engine_parity_across_page_edges(window):
    """Window 6 over 4-token pages: every decode step's window straddles a
    page edge somewhere in the stream, multi-chunk admission crosses
    window boundaries, and some walks start past page 0."""
    ce = _parity(window, prompt_len=23, t_max=12)
    assert any(ws > 0 for _, ws in ce._decode_bounds)
    assert any(ws > 0 for *_, ws in ce._chunk_shapes)


def test_window_engine_parity_one_shot_admission(window):
    ce = _parity(window, prompt_len=15, t_max=8, prefill_chunk=0)
    assert ce.stats.prefill_chunks == 0 and ce.stats.prefill_tokens == 6 * 15
    assert any(ws > 0 for _, ws in ce._decode_bounds)


def test_window_engine_static_walk_baseline(window):
    ce = _parity(window, prompt_len=23, t_max=12, walk_bound="static")
    assert ce._decode_bounds == {(ce.cache.max_pages_per_slot, 0)}


@pytest.mark.parametrize("walk_bound", ["live", "static"])
def test_window_start_matches_reference(window, walk_bound):
    """``_window_start`` gives the reference's first page on a grid of
    (earliest in-window key, page size), and 0 for a stack without window
    layers."""
    m, p, bundle, model = window
    plain = _tier(tiny_cfg("dense", cache_layout="paged"), 1)
    for ps in (1, 4, 8, 16):
        kw = dict(n_slots=1, max_seq=256, page_size=ps,
                  walk_bound=walk_bound)
        pairs = [(JaxEngine(m, p, **kw), ContinuousEngine(bundle, model,
                                                          **kw)),
                 (JaxEngine(plain[0], plain[1], **kw),
                  ContinuousEngine(plain[2], plain[3], **kw))]
        for ref, eng in pairs:
            for key in range(-20, 300, 3):
                assert eng._window_start(key) == ref._window_start(key), \
                    (ps, key)


def test_window_and_plain_tiers_pool_greedy_exact(window):
    """The window-tier half of the reference's three-tier pool test: a
    plain tier and a window tier behind one router, split at the median
    score, serve a mixed stream greedy-exact against each tier's dense
    engines, routing as the reference's cascade does."""
    rng = np.random.default_rng(7)
    plain = _tier(tiny_cfg("dense", cache_layout="paged"), 0)
    tiers = [plain, window]
    q = rng.integers(4, 200, (9, 15)).astype(np.int32)
    mask = np.ones_like(q, np.float32)
    rcfg = JaxRouterConfig(vocab_size=256, n_layers=1, d_model=32,
                           n_heads=2, d_ff=64)
    rp = jax.jit(jax_init_router, static_argnums=1)(jax.random.PRNGKey(0),
                                                    rcfg)
    ref_router = JaxRouter(rp, rcfg, 0.5)
    scores = np.asarray(ref_router.scores(jnp.asarray(q), jnp.asarray(mask)))
    thresholds = (float(np.median(scores)),)
    want_tier, _ = JaxCascade(ref_router, thresholds).decide(q, mask)

    prcfg = RouterConfig(**dataclasses.asdict(rcfg))
    router = HybridRouter(bridge.params_from_numpy(_np_tree(rp), prcfg,
                                                   "cpu"), prcfg, 0.5)
    engines = [ContinuousEngine(t[2], t[3], max_new_tokens=6, n_slots=2,
                                max_seq=64, page_size=4) for t in tiers]
    pool = ContinuousPoolEngine(CascadePolicy(router, thresholds),
                                [("plain", engines[0]),
                                 ("window", engines[1])])
    res = pool.serve(q, mask)
    np.testing.assert_array_equal(res.tier_idx, np.asarray(want_tier))
    assert sorted(np.unique(res.tier_idx)) == [0, 1]    # truly mixed
    for t, (m, p, bundle, model) in enumerate(tiers):
        sel = res.tier_idx == t
        rd, ld = JaxDense(m, p, max_new_tokens=6).serve(q[sel])
        dd, _ = Engine(bundle, model, max_new_tokens=6).serve(q[sel])
        np.testing.assert_array_equal(res.responses[sel], np.asarray(rd))
        np.testing.assert_array_equal(res.lengths[sel], np.asarray(ld))
        np.testing.assert_array_equal(dd, np.asarray(rd))
    assert pool.meter.calls.sum() == len(q)
    assert all(e.cache.free_pages == e.cache.num_pages - 1 for e in engines)


def test_gemma3_4b_config_and_reduced_serving():
    """The published gemma3-4b config is the reference's, with the same
    layer layout (global layers 5, 11, 17, 23, 29), and so is the
    reference's ``reduced()`` of it, copied field by field; that reduced
    variant (the gemma3 row of tests/test_config_serving_matrix.py)
    serves through the port's paged engine greedy-exact against the
    reference's dense engine, and its tied-embedding weights bridge both
    ways."""
    assert ArchConfig(**dataclasses.asdict(JAX_GEMMA)) == GEMMA
    small = JAX_GEMMA.reduced()
    for cfg, ref in ((GEMMA, JAX_GEMMA),
                     (ArchConfig(**dataclasses.asdict(small)), small)):
        assert [cfg.layer_kind(i)["global_attn"]
                for i in range(cfg.n_layers)] == \
            list(ref.is_global_layer_flags())
        assert [cfg.layer_window(i) for i in range(cfg.n_layers)] == \
            [ref.layer_window(i) for i in range(ref.n_layers)]
        assert [cfg.layer_kind(i) for i in range(cfg.n_layers)] == \
            [ref.layer_kind(i) for i in range(ref.n_layers)]
        assert cfg.has_window_layers and cfg.param_count() == \
            ref.param_count()
    assert [i for i in range(GEMMA.n_layers)
            if GEMMA.layer_kind(i)["global_attn"]] == [5, 11, 17, 23, 29]
    assert round(GEMMA.param_count() / 1e9, 2) == 3.88

    cfg = dataclasses.replace(small,
                              vocab_size=jax_tok.VOCAB_SIZE,
                              vocab_pad_multiple=16, cache_layout="paged")
    m, p, bundle, model = _tier(cfg, 0)
    assert cfg.tie_embeddings and not hasattr(model, "head")
    back = bridge.numpy_from_params(model, bundle.cfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, _np_tree(p))
    q = np.random.default_rng(1).integers(4, jax_tok.VOCAB_SIZE, (2, 7)) \
        .astype(np.int32)
    want, want_len = JaxDense(m, p, max_new_tokens=4).serve(q)
    eng = ContinuousEngine(bundle, model, max_new_tokens=4, n_slots=2,
                           max_seq=32)
    out, lens = eng.serve(q)
    np.testing.assert_array_equal(out, np.asarray(want))
    np.testing.assert_array_equal(lens, np.asarray(want_len))
    assert eng.stats.retired == 2 and eng.rstate is None
